"""Shared helpers for neural blocks: positions, masks and seeded
initialisation."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """The FastSpeech2 sinusoid table (n_position, d_hid), fp32: angle(pos,
    i) = pos / 10000^(2*(i//2)/d_hid), sin on even dims, cos on odd
    (``viet_tts_tpu/nn/utils.py:sinusoid_position_table``; computed in
    float64). Not espnet's table of ``nn/espnet_transformer.py``."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    i = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (i // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _table_np(n: int, d: int) -> np.ndarray:
    return sinusoid_position_table(n, d)


def position_table(max_seq_len: int, d_model: int, T: int,
                   like: torch.Tensor) -> torch.Tensor:
    """The first T rows of the (max(max_seq_len + 1, T), d_model) sinusoid
    table that the FastSpeech2 stacks add to their input, on ``like``'s
    device and dtype."""
    table = _table_np(max(max_seq_len + 1, T), d_model)[:T]
    return torch.from_numpy(table).to(device=like.device, dtype=like.dtype)


def pad_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at PADDING positions (the reference's make_pad_mask convention)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] >= lengths[:, None]


def valid_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at VALID positions."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over dim 1 of a (B, C, T) tensor (espnet ``LayerNorm(dim=1)``),
    so it can sit inside an ``nn.Sequential`` of ``Conv1d``s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * bound)


@torch.no_grad()
def seeded_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter of ``model`` from ``generator``.

    PyTorch's constructors draw from the global RNG; this walks the modules
    and fills them from an explicit generator instead (on the CPU, so one
    seed gives the same weights on any device). Modules of this package with
    their own scheme define ``seeded_init_(generator)``; standard layers get
    PyTorch's default bounds (uniform in +-1/sqrt(fan_in)), norms get ones
    and zeros.
    """
    for m in model.modules():
        own = getattr(type(m), "seeded_init_", None)
        if own is not None:
            own(m, generator)
        elif isinstance(m, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            _uniform_(m.weight, bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, bound, generator)
        elif isinstance(m, nn.GRU):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                _uniform_(p, bound, generator)
    return model
