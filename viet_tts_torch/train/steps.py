"""The FastSpeech2 train and validation steps.

Counterpart of ``viet_tts_tpu/train/steps.py`` (``make_fs2_train_step``,
``make_fs2_valid_step``): forward, loss, gradients, one optimizer update
and the metric dict. The JAX step is one jitted function of (state, batch,
rng); here it runs eagerly, the model's parameters, BatchNorm statistics
and optimizer state update in place, and a CPU ``torch.Generator`` takes
the place of the rng.

- ``mixed_precision=True``: the forward and backward run in bf16 (the
  parameters and the float inputs cast inside the step, through
  ``torch.func.functional_call``), while the master parameters, the
  optimizer state and the BatchNorm running statistics stay fp32 and the
  losses reduce in fp32 against the fp32 targets.
- ``grad_accum=A``: the batch's leading axis splits into A micro-batches,
  each one's gradients accumulate (the BatchNorm statistics chain from one
  micro-batch to the next), and one optimizer update takes their mean.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from viet_tts_torch.models.fastspeech2.loss import FastSpeech2Loss, total_loss
from viet_tts_torch.train.gan import seed_device_rng
from viet_tts_torch.train.state import TrainState


def _to_fp32(tree):
    """Cast every floating tensor of a nested tuple to fp32."""
    if isinstance(tree, tuple):
        return tuple(_to_fp32(x) for x in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.float()
    return tree


def _forward(model: nn.Module, batch: Dict[str, torch.Tensor], step: int,
             generator, mixed_precision: bool, cvae_eps=None):
    """The model's teacher-forced forward on ``batch``: (predictions,
    (ds, ps, es)), fp32."""
    args = dict(text=batch["text"], text_lengths=batch["text_lengths"],
                feats=batch["feats"], feats_lengths=batch["feats_lengths"],
                duration=batch["duration"], pitch=batch["pitch"], energy=batch["energy"],
                sids=batch["sids"], aids=batch.get("aids"), step=step, generator=generator,
                cvae_eps=cvae_eps)
    if not mixed_precision:
        return model(**args)
    half = torch.bfloat16
    params = {n: p.to(half) for n, p in model.named_parameters()}
    args = {k: v.to(half) if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in args.items()}
    if cvae_eps is not None:
        args["cvae_eps"] = tuple(e.to(half) for e in cvae_eps)
    return _to_fp32(torch.func.functional_call(model, params, (), args))


def make_fs2_train_step(model: nn.Module, criterion: FastSpeech2Loss,
                        mixed_precision: bool = False, grad_accum: int = 1) -> Callable:
    """``train_step(state, batch, generator, cvae_eps=None) -> (state,
    metrics)``.

    ``state.module`` is ``model`` (a ``FastSpeech2``). ``batch`` holds, on
    the model's device: text (B, T_text), text_lengths,
    feats (B, T_mel, n_mels), feats_lengths, duration (the beta-binomial
    prior (B, T_mel, T_text) with ``learn_alignment``), pitch and energy
    (B, T_mel), sids, aids, word_ids (B, T_text). ``generator`` (a CPU
    ``torch.Generator``) draws the flash attention's dropout seeds and the
    CVAE's noise and seeds the device generator for ``nn.Dropout``;
    ``cvae_eps`` ((B, z) acc and spk noise) replaces the CVAE's draw.
    ``metrics``: the loss dict and ``total`` (0-d tensors), the mean over
    micro-batches."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def micro_loss(batch, step, generator, cvae_eps):
        y_pred, y_extra = _forward(model, batch, step, generator, mixed_precision, cvae_eps)
        targets = (batch["feats"], batch["word_ids"], batch["word_ids"].shape[1], *y_extra)
        losses = criterion(y_pred, targets, step=step)
        return total_loss(losses), losses

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, cvae_eps=None):
        seed_device_rng(batch["feats"].device, generator)
        model.train()
        state.tx.zero_grad()
        B = batch["text"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} does not split into {grad_accum} micro-batches")
        mb = B // grad_accum
        tot = 0.0
        sums: Dict[str, torch.Tensor] = {}
        for i in range(grad_accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            eps = None if cvae_eps is None else tuple(e[i * mb:(i + 1) * mb] for e in cvae_eps)
            tot_i, losses_i = micro_loss(part, state.step, generator, eps)
            (tot_i / grad_accum).backward()
            tot = tot + tot_i.detach()
            for k, v in losses_i.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        state.apply_gradients()
        metrics = {k: v / grad_accum for k, v in sums.items()}
        metrics["total"] = tot / grad_accum
        return state, metrics

    return train_step


def make_fs2_valid_step(model: nn.Module, criterion: FastSpeech2Loss) -> Callable:
    """``valid_step(state, batch) -> losses``: the held-out feat and
    feat_postnet losses of the eval-mode forward (no gradient)."""

    @torch.no_grad()
    def valid_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.eval()
        y_pred, y_extra = _forward(model, batch, state.step, None, False)
        targets = (batch["feats"], batch["word_ids"], batch["word_ids"].shape[1], *y_extra)
        return criterion(y_pred, targets, step=None)

    return valid_step
