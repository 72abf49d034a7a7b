"""JETS losses: variance (duration / pitch / energy) and forward-sum.

Counterpart of ``viet_tts_tpu/models/jets/loss.py``: masked-mean MSE over
valid tokens, the duration loss in the log domain with offset 1, and the
forward-sum CTC with the beta-binomial prior added. The adversarial,
feature-match and mel terms are ``models/hifigan/loss.py``'s.
"""

from __future__ import annotations

from typing import Tuple

import torch

from viet_tts_torch.nn.utils import valid_mask_from_lengths
from viet_tts_torch.ops.forward_sum import beta_binomial_log_prior, jets_forward_sum_loss


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.expand_as(err).to(err.dtype)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def variance_loss(d_outs: torch.Tensor, ds: torch.Tensor, p_outs: torch.Tensor,
                  ps: torch.Tensor, e_outs: torch.Tensor, es: torch.Tensor,
                  ilens: torch.Tensor, offset: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(duration, pitch, energy) losses."""
    mask = valid_mask_from_lengths(ilens, ds.shape[1])
    log_ds = torch.log(ds.to(torch.float32) + offset)
    dur = _masked_mean((d_outs - log_ds) ** 2, mask)
    pitch = _masked_mean((p_outs - ps) ** 2, mask[..., None])
    energy = _masked_mean((e_outs - es) ** 2, mask[..., None])
    return dur, pitch, energy


def forward_sum_with_prior(log_p_attn: torch.Tensor, ilens: torch.Tensor,
                           olens: torch.Tensor) -> torch.Tensor:
    """Forward-sum CTC with the beta-binomial prior added."""
    _, T_feats, T_text = log_p_attn.shape
    prior = beta_binomial_log_prior(ilens, olens, T_text, T_feats)
    return jets_forward_sum_loss(log_p_attn, ilens, olens, bb_prior=prior)
