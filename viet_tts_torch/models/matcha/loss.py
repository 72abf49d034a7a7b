"""Matcha-TTS training loss: a dict of named losses.

Counterpart of ``viet_tts_tpu/models/matcha/loss.py``: the CFM MSE
(``diff``), the Gaussian prior NLL of the target mel under mu_y
(``prior``), the CVAE's KL with its linear build-up (``cvae``), the
aligner's forward-sum CTC (``ctc``) and warm-up-weighted binarization loss
(``bin``), and the log-domain duration MSE (``dur``, a mean over every
text position, the padding included). ``is_joint``: no mel mask (the
joint trainer's windows). The step-dependent weights are host arithmetic
on the step count.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from viet_tts_torch.models.fastspeech2.loss import kl_divergence, linear_buildup
from viet_tts_torch.ops.forward_sum import bin_loss, forward_sum_loss


class MatchaTTSLoss:
    """``config``: the task's ``train.matcha.loss`` section plus the mel
    width ``n_channels``."""

    def __init__(self, config: Dict[str, Any], is_finetune: bool = False):
        self.n_channels = config["n_channels"]
        self.linbuild = config["linbuild"]
        self.is_finetune = is_finetune
        self.bin_enable = config["binarization_loss_enable_steps"]
        self.bin_warmup = config["binarization_loss_warmup_steps"]

    def __call__(self, predictions: Tuple, targets: Tuple, is_joint: bool = False,
                 step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """``predictions``: the model's 10-tuple; ``targets``: (normalised
        feats, text_lengths). With ``step`` None only ``diff`` and
        ``prior`` (the validation step's)."""
        (dec_outs, u, mu_y, txt_pad, mel_valid, feats_lengths, duration_targets, log_d_pred,
         attn_outs, accent_probs) = predictions
        feats, text_lengths = targets
        if is_joint:
            mask = torch.ones_like(dec_outs[..., :1])
        else:
            mask = mel_valid[..., None].to(dec_outs.dtype)
        n_valid = mask.sum()
        losses: Dict[str, torch.Tensor] = {}
        losses["diff"] = (((dec_outs - u) ** 2) * mask).sum() / (n_valid * u.shape[-1])
        losses["prior"] = ((0.5 * ((feats - mu_y) ** 2 + math.log(2 * math.pi))) * mask).sum() \
            / (n_valid * self.n_channels)
        if step is not None and attn_outs is not None:
            if accent_probs is not None:
                if self.is_finetune:
                    weight = 5e-4
                else:
                    lb = self.linbuild
                    weight = linear_buildup(step, lb["start"], lb["stop"], lb["n_up"],
                                            lb["n_stop"])
                mu_acc, logvar_acc, mu_spk, logvar_spk = accent_probs
                losses["cvae"] = weight * (kl_divergence(mu_acc, logvar_acc)
                                           + kl_divergence(mu_spk, logvar_spk))
            attn_soft, attn_hard, _, attn_logprob = attn_outs
            losses["ctc"] = forward_sum_loss(attn_logprob, text_lengths, feats_lengths)
            w = 0.0 if step < self.bin_enable else min(
                max((step - self.bin_enable) / self.bin_warmup, 0.0), 1.0)
            losses["bin"] = bin_loss(attn_hard, attn_soft) * w
            nonpad = (~txt_pad).to(torch.float32)
            d_target = duration_targets.to(torch.float32) * nonpad
            losses["dur"] = torch.mean((log_d_pred - torch.log(d_target + 1.0)) ** 2)
        return losses
