"""Observability: TensorBoard scalars and histograms, step timing, ANSI
console colours.

Counterpart of ``viet_tts_tpu/utils/logging.py``, on the port's own event
writer (``utils/tfevents.py``); histograms are taken over a module's
``named_parameters()``.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

from torch import nn

from viet_tts_torch.utils.tfevents import EventWriter


class TextColors:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKCYAN = "\033[96m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


text_colors = TextColors()


class TensorLogger:
    """Scalar logger writing ``<split>/<key>`` per split (files open in
    stock TensorBoard), flushed after each call."""

    def __init__(self, log_dir: str, split: str = "train"):
        try:
            self.writer = EventWriter(log_dir)
        except OSError as e:  # unwritable log dir: keep training alive
            warnings.warn(f"TensorBoard logging disabled: {e}")
            self.writer = None
        self.split = split

    def log(self, losses: Dict[str, float], step: int,
            rates: Optional[Dict[str, float]] = None) -> None:
        """``losses`` as ``<split>/<key>``, each of ``rates`` (learning
        rates) under its own tag, outside the split."""
        if self.writer is None:
            return
        for k, v in losses.items():
            self.writer.add_scalar(f"{self.split}/{k}", float(v), step)
        for tag, rate in (rates or {}).items():
            self.writer.add_scalar(tag, float(rate), step)
        self.writer.flush()

    def log_histograms(self, module: nn.Module, step: int) -> None:
        """A histogram of every parameter, tagged by its dotted name."""
        if self.writer is None:
            return
        for name, p in module.named_parameters():
            self.writer.add_histogram(name, p.detach().float().cpu().numpy().ravel(), step)
        self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()


class StepTimer:
    """Wall-clock per-step timing with an EMA; steps/sec for the log."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.ema = None
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema)
        self._last = now
        return self.ema

    @property
    def steps_per_sec(self) -> Optional[float]:
        return None if not self.ema else 1.0 / self.ema
