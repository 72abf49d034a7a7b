"""VITS2 losses (counterpart of ``viet_tts_tpu/models/vits2/loss.py``)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r: Sequence, fmap_g: Sequence) -> torch.Tensor:
    """2 x the sum of the L1 means between the (detached) real and the
    fake feature maps."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl))
    return loss * 2.0


def discriminator_loss(disc_real: Sequence[torch.Tensor], disc_gen: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """LSGAN: sum of mean (1 - real)^2 + mean fake^2, and the two lists."""
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean((1.0 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: Sequence[torch.Tensor]):
    """Sum of mean (1 - fake)^2, and the list."""
    loss, gen_losses = 0.0, []
    for dg in disc_outputs:
        term = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """KL(q || p) a valid frame: logs_p - logs_q - 0.5 + 0.5 (z_p - m_p)^2
    exp(-2 logs_p), summed over the mask and divided by its sum."""
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)
