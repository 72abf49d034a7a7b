"""The Matcha-TTS trainer (``--task matcha``) and its train and validation
steps.

Counterpart of ``viet_tts_tpu/train/matcha.py``: the acoustic dataset with
the mels normalised by the dataset's global scalar mean and std
(``MelNormalizedDataset``, ``compute_mel_stats``: computed in float64 on
the first run, written to ``<out>/stats.json`` as ``mel_mean`` /
``mel_std`` and read back on a resume); mel buckets are multiples of 4, as
the UNet needs. The step is forward, ``MatchaTTSLoss``, gradients and one
AdamW update (betas and eps from ``train.matcha.optimizer``, else (0.9,
0.999) and 1e-8 as in the JAX trainer; ``grad_clip_thresh``; the decay
``train.matcha.scheduler.gamma`` an epoch). Validation tracks ``diff`` and
``prior``; its flow times and noise come from one generator seeded with
``train.seed`` at each validation, as the JAX trainer reuses its fixed key,
so a resumed run repeats it. The JAX trainer draws a validation batch at
init to build its parameters; this one needs none.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from viet_tts_torch.data.batching import BucketBatcher
from viet_tts_torch.data.dataset import AcousticDataset, load_stats, save_stats
from viet_tts_torch.models.fastspeech2.loss import total_loss
from viet_tts_torch.models.matcha import MatchaTTSLoss
from viet_tts_torch.train.gan import seed_device_rng
from viet_tts_torch.train.state import TrainState, adamw_with_clip
from viet_tts_torch.train.trainer import BaseTrainer, log, step_generator

# the pitch / energy statistics the Matcha datasets normalise with (unread)
UNIT_STATS = {"pitch": {"mean": 0, "std": 1}, "energy": {"mean": 0, "std": 1}}


class MelNormalizedDataset:
    """An ``AcousticDataset`` whose items' ``feat`` is (feat - mel_mean) /
    mel_std."""

    def __init__(self, base: AcousticDataset, mel_mean: float, mel_std: float):
        self.base = base
        self.mel_mean = mel_mean
        self.mel_std = mel_std
        self.inputs = base.inputs

    def __len__(self):
        return len(self.base)

    def lengths(self, index: int) -> tuple:
        return self.base.lengths(index)

    def __getitem__(self, index: int) -> dict:
        item = self.base[index]
        item["feat"] = (item["feat"] - self.mel_mean) / self.mel_std
        return item


def compute_mel_stats(dataset: AcousticDataset) -> Dict[str, float]:
    """The global scalar mel mean and std over the whole dataset, in
    float64."""
    total, sq, n = 0.0, 0.0, 0
    for i in range(len(dataset)):
        feat = dataset[i]["feat"].astype(np.float64)
        total += feat.sum()
        sq += (feat ** 2).sum()
        n += feat.size
    mean = total / max(n, 1)
    std = float(np.sqrt(max(sq / max(n, 1) - mean * mean, 1e-20)))
    return {"mel_mean": float(mean), "mel_std": std}


def _forward(model: nn.Module, batch: Dict[str, torch.Tensor], step: int, generator, draws):
    return model(batch["text"], batch["text_lengths"], batch["feats"], batch["feats_lengths"],
                 sids=batch["sids"], aids=batch.get("aids"), duration=batch["duration"],
                 step=step, generator=generator, draws=draws)


def make_matcha_train_step(model: nn.Module, criterion: MatchaTTSLoss) -> Callable:
    """``train_step(state, batch, generator, draws=None) -> (state,
    metrics)``. ``state.module`` is ``model`` (a ``MatchaTTS``). ``batch``
    holds, on the model's device: text, text_lengths, feats (normalised),
    feats_lengths, duration (the beta-binomial prior (B, T_mel, T_text)),
    sids, aids. ``generator`` (a CPU ``torch.Generator``) seeds the device
    generator for ``nn.Dropout`` and draws the CVAE's noise and the CFM's t
    and z, unless ``draws`` gives them (``MatchaTTS.forward``).
    ``metrics``: the loss dict and ``total`` (0-d tensors)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, draws=None):
        seed_device_rng(batch["feats"].device, generator)
        model.train()
        state.tx.zero_grad()
        preds = _forward(model, batch, state.step, generator, draws)
        losses = criterion(preds, (batch["feats"], batch["text_lengths"]), step=state.step)
        total = total_loss(losses)
        total.backward()
        state.apply_gradients()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        return state, metrics

    return train_step


def make_matcha_valid_step(model: nn.Module, criterion: MatchaTTSLoss) -> Callable:
    """``valid_step(state, batch, generator) -> losses``: ``diff`` and
    ``prior`` of the eval-mode forward (no gradient), the CFM's t and z
    drawn from ``generator``."""

    @torch.no_grad()
    def valid_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator):
        model.eval()
        preds = _forward(model, batch, state.step, generator, None)
        return criterion(preds, (batch["feats"], batch["text_lengths"]), step=None)

    return valid_step


class MatchaTrainer(BaseTrainer):
    """Acoustic-only training of Matcha-TTS (``models.matcha``)."""

    task = "matcha"

    def __init_dataset__(self):
        t0 = time.perf_counter()
        audio_conf = self.conf["audio"]
        stats_path = os.path.join(self.args.output_folder, "stats.json")
        base_train = AcousticDataset(self.train_set, audio_conf, self.speakers, self.accents,
                                     stats=UNIT_STATS)
        if os.path.exists(stats_path):
            self.stats = load_stats(stats_path)
        else:
            self.stats = compute_mel_stats(base_train)
            os.makedirs(self.args.output_folder, exist_ok=True)
            save_stats(self.stats, stats_path)
        base_valid = AcousticDataset(self.test_set, audio_conf, self.speakers, self.accents,
                                     stats=UNIT_STATS)
        mean, std = self.stats["mel_mean"], self.stats["mel_std"]
        self.train_data = MelNormalizedDataset(base_train, mean, std)
        self.valid_data = MelNormalizedDataset(base_valid, mean, std)
        self.cache_seconds = time.perf_counter() - t0
        log.info(f"feature cache and mel statistics of "
                 f"{len(self.train_set) + len(self.test_set)} utterances: "
                 f"{self.cache_seconds:.1f} s (mel mean {mean:.4f}, std {std:.4f})")
        bs = self.conf["train"]["batch_size"]
        self.train_loader = BucketBatcher(self.train_data, bs, seed=self.seed)
        self.valid_loader = BucketBatcher(self.valid_data, bs, seed=self.seed)

    def __init_model__(self):
        from viet_tts_torch.models import build_acoustic
        from viet_tts_torch.nn.utils import seeded_init_

        model = build_acoustic(
            self.n_symbols, self.conf["audio"]["mel"]["channels"], self.conf, self.task,
            self.stats, n_speakers=len(self.speakers) if self.speakers else 1,
            n_accents=len(self.accents) if self.accents else 2)
        # seeded on the CPU, so one seed gives the same weights on any device
        seeded_init_(model, torch.Generator().manual_seed(self.seed))
        self.model = model.to(self.device)

    def __init_loss__(self):
        from viet_tts_torch.models import build_acoustic_loss

        self.criterion = build_acoustic_loss(self.conf, self.task,
                                             is_finetune=getattr(self.args, "is_finetune", False))

    def __init_optimizer__(self):
        task_conf = self.conf["train"][self.task]
        opt = task_conf["optimizer"]
        self.base_lr = opt["lr"]
        self.gamma = task_conf.get("scheduler", {}).get("gamma", 1.0)
        tx = adamw_with_clip(self.model.parameters(), self.base_lr,
                             betas=tuple(opt.get("betas", (0.9, 0.999))),
                             eps=opt.get("eps", 1e-8),
                             weight_decay=opt.get("weight_decay", 0.0),
                             grad_clip=self.conf["train"]["grad_clip_thresh"])
        self.state = TrainState.create(self.model, tx)
        self.try_resume()
        self.train_step = make_matcha_train_step(self.model, self.criterion)
        self.valid_step = make_matcha_valid_step(self.model, self.criterion)

    def train_batch(self, batch):
        self.state, metrics = self.train_step(
            self.state, batch, step_generator(self.seed, self.state.step))
        return metrics

    def valid_one_epoch(self):
        generator = torch.Generator().manual_seed(self.seed)
        val, n = {"diff": 0.0, "prior": 0.0}, 0
        for batch in self.valid_loader:
            losses = self.valid_step(self.state, self._device_batch(batch), generator)
            val["diff"] += float(losses["diff"])
            val["prior"] += float(losses["prior"])
            n += 1
        val = {k: v / max(n, 1) for k, v in val.items()}
        self.valid_logger.log(val, self.iter)
        self._report_validation(val)
