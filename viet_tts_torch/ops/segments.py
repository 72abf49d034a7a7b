"""Windowed segment extraction for GAN training.

Counterpart of ``viet_tts_tpu/ops/segments.py`` (``get_segments``,
``get_random_segments``): static output shapes, one gather per call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def get_segments(x: torch.Tensor, start_idxs: torch.Tensor,
                 segment_size: int) -> torch.Tensor:
    """Slice (B, C, T) at per-sample starts -> (B, C, segment_size).

    Starts are clamped to [0, T - segment_size], as ``dynamic_slice`` does."""
    B, C, T = x.shape
    start = torch.clamp(start_idxs.to(device=x.device, dtype=torch.int64),
                        0, max(T - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return torch.gather(x, 2, idx[:, None, :].expand(B, C, segment_size))


def get_random_segments(x: torch.Tensor, lengths: torch.Tensor,
                        segment_size: int,
                        generator: Optional[torch.Generator] = None,
                        start_idxs: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random per-sample windows of (B, C, T): (segments, start_idxs).

    Starts are uniform in [0, max(length - segment_size, 0)], drawn as
    ``floor(u * max_start)`` with u ~ U[0, 1) from ``generator`` (a CPU
    generator, so the draw does not wait on the device). ``start_idxs``
    given instead skips the draw (a test hands the JAX package's starts in
    this way)."""
    if start_idxs is None:
        u = torch.rand(x.shape[0], generator=generator).to(x.device)
        max_start = torch.clamp(lengths.to(x.device) - segment_size, min=0)
        start_idxs = (u * max_start.to(torch.float32)).to(torch.int64)
    start_idxs = start_idxs.to(device=x.device, dtype=torch.int64)
    return get_segments(x, start_idxs, segment_size), start_idxs
