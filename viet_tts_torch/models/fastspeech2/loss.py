"""FastSpeech2 training loss: a dict of named losses.

Counterpart of ``viet_tts_tpu/models/fastspeech2/loss.py``: masked L1 on the
mel (and the postnet's mel), the forward-sum CTC of the aligner and its
warm-up-weighted binarization loss, the log-domain phoneme, word (the
durations summed per word by the batch's ``word_ids``) and sentence
duration MSE, masked pitch / energy MSE, and the CVAE's KL with its linear
build-up. The step-dependent weights are host arithmetic on the step count
(the JAX package traces them as ``jnp.where`` expressions).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from viet_tts_torch.ops.duration import aggregate_by_ids
from viet_tts_torch.ops.forward_sum import bin_loss, forward_sum_loss


def masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``err`` over the True positions of ``mask`` (broadcastable)."""
    mask = torch.broadcast_to(mask, err.shape).to(err.dtype)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """mean_b 0.5 * sum_d (e^logvar + mu^2 - 1 - logvar)."""
    return torch.mean(0.5 * torch.sum(torch.exp(logvar) + mu ** 2 - 1.0 - logvar, dim=1))


def linear_buildup(step: int, start: float, stop: float, n_up: int, n_stop: int) -> float:
    """start -> stop linearly over steps n_up .. n_stop, flat outside."""
    frac = min(max((step - n_up) / max(n_stop - n_up, 1), 0.0), 1.0)
    return start + (stop - start) * frac


class FastSpeech2Loss:
    """The loss bundle. ``config`` is the task's ``train.loss`` section plus
    ``pitch_feature_level`` / ``energy_feature_level``."""

    def __init__(self, config: Dict[str, Any], is_finetune: bool = False):
        self.linbuild = config["linbuild"]
        self.is_finetune = is_finetune
        self.bin_enable = config["binarization_loss_enable_steps"]
        self.bin_warmup = config["binarization_loss_warmup_steps"]
        self.dur_lambda = config["dur_loss_lambda"]
        self.pitch_level = config.get("pitch_feature_level", "phoneme_level")
        self.energy_level = config.get("energy_feature_level", "phoneme_level")

    def _duration_losses(self, log_d_pred, d_target, word_ids, valid_mask):
        nonpad = valid_mask.to(torch.float32)
        d_target = d_target.to(torch.float32) * nonpad
        d_pred = torch.clamp(torch.exp(log_d_pred) - 1.0, min=0.0)
        losses = {"pdur": torch.mean((log_d_pred - torch.log(d_target + 1.0)) ** 2)}
        if self.dur_lambda.get("wdur", 0) > 0 and word_ids is not None:
            n_words = word_ids.shape[1]
            wd_pred = aggregate_by_ids(d_pred, word_ids, n_words)
            wd_target = aggregate_by_ids(d_target, word_ids, n_words)
            err = (torch.log(wd_pred + 1.0) - torch.log(wd_target + 1.0)) ** 2
            losses["wdur"] = masked_mean(err, wd_pred > 0)
        if self.dur_lambda.get("sdur", 0) > 0:
            sp, st = d_pred.sum(-1), d_target.sum(-1)
            losses["sdur"] = torch.mean((torch.log(sp + 1.0) - torch.log(st + 1.0)) ** 2)
        return losses

    def _align_losses(self, attn_outs, src_lens, feats_lens, step: int):
        attn_soft, attn_hard, _, attn_logprob = attn_outs
        w = min(max((step - self.bin_enable) / self.bin_warmup, 0.0), 1.0)
        if step < self.bin_enable:
            w = 0.0
        return {"ctc": forward_sum_loss(attn_logprob, src_lens, feats_lens),
                "bin": bin_loss(attn_hard, attn_soft) * w}

    def _cvae_loss(self, probs, step: int):
        mu_acc, logvar_acc, mu_spk, logvar_spk = probs
        if self.is_finetune:
            weight = 5e-4
        else:
            lb = self.linbuild
            weight = linear_buildup(step, lb["start"], lb["stop"], lb["n_up"], lb["n_stop"])
        return {"cvae": weight * (kl_divergence(mu_acc, logvar_acc)
                                  + kl_divergence(mu_spk, logvar_spk))}

    def __call__(self, predictions: Tuple, targets: Tuple, is_joint: bool = False,
                 step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """``predictions``: the model's 12-tuple; ``targets``: (feats,
        word_ids, n_words, ds, ps, es). With ``step`` None only the mel
        losses (the validation step's)."""
        (feats_pred, postnet_pred, log_d_pred, pitch_pred, energy_pred, src_lens, src_pad,
         feats_lens, feats_pad, accent_probs, attn_outs) = predictions[:-1]
        feats_target, word_ids, _, d_target, pitch_target, energy_target = targets
        src_valid, feats_valid = ~src_pad, ~feats_pad
        feats_target = feats_target[:, : feats_valid.shape[1], :]
        losses: Dict[str, torch.Tensor] = {}
        if is_joint:
            losses["feat"] = torch.mean(torch.abs(feats_pred - feats_target))
            if postnet_pred is not None:
                losses["feat_postnet"] = torch.mean(torch.abs(postnet_pred - feats_target))
        else:
            mel_mask = feats_valid[..., None]
            losses["feat"] = masked_mean(torch.abs(feats_pred - feats_target), mel_mask)
            if postnet_pred is not None:
                losses["feat_postnet"] = masked_mean(torch.abs(postnet_pred - feats_target),
                                                     mel_mask)
        if step is not None:
            if attn_outs is not None:
                losses.update(self._align_losses(attn_outs, src_lens, feats_lens, step))
            if accent_probs is not None:
                losses.update(self._cvae_loss(accent_probs, step))
            losses.update(self._duration_losses(log_d_pred, d_target, word_ids, src_valid))
            mask = src_valid if self.pitch_level == "phoneme_level" else feats_valid
            losses["pitch"] = masked_mean((pitch_pred - pitch_target) ** 2, mask)
            mask = src_valid if self.energy_level == "phoneme_level" else feats_valid
            losses["energy"] = masked_mean((energy_pred - energy_target) ** 2, mask)
        return losses


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain sum of the loss entries."""
    return sum(losses.values())
