"""espnet-style pre-norm Transformer encoder (used by JETS).

Counterpart of ``viet_tts_tpu/nn/espnet_transformer.py``: optional
embedding input, (scaled) interleaved-sinusoid positional encoding,
pre-norm residual blocks with conv1d position-wise layers, final LayerNorm.
Module and parameter names follow espnet's torch modules (``embed.0``,
``encoders.{i}.self_attn.linear_q``, ...), the names the JAX package's
``train/torch_import.py:import_jets`` reads. Activations are (B, T, C).

Dropout sits where the flax module has it (positional encoding, attention
weights, the FFN's hidden layer, both residual branches) and acts in
``.train()`` mode. On the flash route the attention-weight dropout runs
inside kernel K1, keyed by a seed drawn per call from the ``generator``
passed down the forward (the flax module draws it from its "dropout"
stream); on the shift route it is a dense ``nn.Dropout``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from viet_tts_torch.ops.flash_attention import MASK_NEG, flash_attention

LN_EPS = 1e-12  # espnet LayerNorm epsilon
PE_MAX_LEN = 5000


@functools.lru_cache(maxsize=8)
def interleaved_sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Standard transformer PE: sin/cos interleaved by even/odd dims,
    computed in float64 and cast to float32."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


class _SinusoidTable(nn.Module):
    """Holds the PE table as a non-persistent buffer (moves with the module,
    is not saved)."""

    def __init__(self, d_model: int, max_len: int = PE_MAX_LEN):
        super().__init__()
        self.d_model = d_model
        self.register_buffer(
            "pe", torch.from_numpy(interleaved_sinusoid_table(max_len, d_model)),
            persistent=False,
        )

    def table(self, T: int) -> torch.Tensor:
        if T <= self.pe.shape[0]:
            return self.pe[:T]
        return torch.from_numpy(
            interleaved_sinusoid_table(T, self.d_model)
        ).to(device=self.pe.device, dtype=self.pe.dtype)


class ScaledPositionalEncoding(_SinusoidTable):
    """x + alpha * PE with learnable scalar alpha (espnet scaled_pos_enc),
    then dropout."""

    def __init__(self, d_model: int, max_len: int = PE_MAX_LEN,
                 dropout: float = 0.0):
        super().__init__(d_model, max_len)
        self.alpha = nn.Parameter(torch.ones(1))
        self.dropout = nn.Dropout(dropout)

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.alpha * self.table(x.shape[1])[None])


class PositionalEncoding(_SinusoidTable):
    """x * sqrt(d_model) + PE (espnet PositionalEncoding, no parameters),
    then dropout."""

    def __init__(self, d_model: int, max_len: int = PE_MAX_LEN,
                 dropout: float = 0.0):
        super().__init__(d_model, max_len)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x * math.sqrt(self.d_model)
                            + self.table(x.shape[1])[None])


class EspnetSelfAttention(nn.Module):
    """Standard MHA with espnet's masking; ``valid_mask`` (B, T) True at
    valid keys.

    ``attn_implementation="flash"`` routes through kernels K1 and K3
    (``ops/flash_attention.py``): padding keys score -1e9 inside the online
    softmax, so a query whose keys are all padding attends uniformly.
    ``"shift"`` is the dense path: softmax, then the weights at padding keys
    are zeroed, so such a query gets zeros (the JAX package's two paths
    differ there in the same way)."""

    def __init__(self, d_model: int, num_heads: int,
                 attn_implementation: str = "shift", dropout: float = 0.0):
        super().__init__()
        if attn_implementation not in ("shift", "flash"):
            raise ValueError(f"attn_implementation must be shift|flash, "
                             f"got {attn_implementation!r}")
        self.num_heads = num_heads
        self.attn_implementation = attn_implementation
        self.dropout_rate = dropout
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, C = x.shape
        H = self.num_heads
        D = C // H
        q = self.linear_q(x).view(B, T, H, D)
        k = self.linear_k(x).view(B, T, H, D)
        v = self.linear_v(x).view(B, T, H, D)
        if self.attn_implementation == "flash":
            drop_p, seed = 0.0, None
            if self.training and self.dropout_rate > 0.0:
                drop_p = self.dropout_rate
                # a per-call seed for the in-kernel mask, drawn on the host
                seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
            pad_mask = None if valid_mask is None else ~valid_mask
            ctx = flash_attention(q, k, v, 1.0 / math.sqrt(D), pad_mask=pad_mask,
                                  dropout_p=drop_p, dropout_seed=seed)
            return self.linear_out(ctx)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
        if valid_mask is not None:
            keep = valid_mask[:, None, None, :]
            scores = scores.masked_fill(~keep, MASK_NEG)
        attn = torch.softmax(scores, dim=-1)
        if valid_mask is not None:
            attn = attn.masked_fill(~keep, 0.0)
        attn = self.dropout(attn)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, C)
        return self.linear_out(ctx)


class MultiLayeredConv1d(nn.Module):
    """Position-wise layer as two kernel-k convs (espnet conv1d type), with
    dropout after the hidden ReLU."""

    def __init__(self, d_model: int, hidden: int, kernel_size: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.w_1 = nn.Conv1d(d_model, hidden, kernel_size, padding=pad)
        self.w_2 = nn.Conv1d(hidden, d_model, kernel_size, padding=pad)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(torch.relu(self.w_1(x.transpose(1, 2))))
        return self.w_2(h).transpose(1, 2)


class EspnetEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, linear_units: int,
                 kernel_size: int = 3, normalize_before: bool = True,
                 attn_implementation: str = "shift", dropout: float = 0.0,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = EspnetSelfAttention(d_model, num_heads,
                                             attn_implementation, attn_dropout)
        self.feed_forward = MultiLayeredConv1d(d_model, linear_units,
                                               kernel_size, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.norm1(x) if self.normalize_before else x
        x = x + self.dropout(self.self_attn(h, valid_mask, generator))
        if not self.normalize_before:
            x = self.norm1(x)
        h = self.norm2(x) if self.normalize_before else x
        x = x + self.dropout(self.feed_forward(h))
        if not self.normalize_before:
            x = self.norm2(x)
        return x


class EspnetTransformerEncoder(nn.Module):
    """Embedding (optional) + scaled PE + pre-norm blocks + final LN.

    ``valid_mask``: (B, T) True at VALID positions (espnet's non-pad mask).
    ``generator`` draws the flash route's per-call dropout seeds in
    training mode.
    """

    def __init__(self, d_model: int, num_heads: int, linear_units: int,
                 num_blocks: int, n_symbols: Optional[int] = None,
                 kernel_size: int = 3, normalize_before: bool = True,
                 use_scaled_pos_enc: bool = True,
                 attn_implementation: str = "shift", dropout: float = 0.0,
                 positional_dropout: float = 0.0, attn_dropout: float = 0.0):
        super().__init__()
        self.has_embedding = n_symbols is not None
        pos = (ScaledPositionalEncoding(d_model, dropout=positional_dropout)
               if use_scaled_pos_enc
               else PositionalEncoding(d_model, dropout=positional_dropout))
        if self.has_embedding:
            self.embed = nn.Sequential(nn.Embedding(n_symbols, d_model), pos)
        else:
            self.embed = nn.Sequential(pos)
        self.encoders = nn.ModuleList(
            EspnetEncoderLayer(d_model, num_heads, linear_units, kernel_size,
                               normalize_before, attn_implementation, dropout,
                               attn_dropout)
            for _ in range(num_blocks)
        )
        self.after_norm = (nn.LayerNorm(d_model, eps=LN_EPS)
                           if normalize_before else None)

    def forward(self, xs: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.has_embedding:
            x = self.embed[0](xs) * (xs != 0)[..., None]  # padding_idx 0
            x = self.embed[1](x)
        else:
            x = self.embed[0](xs)
        for layer in self.encoders:
            x = layer(x, valid_mask, generator)
        if self.after_norm is not None:
            x = self.after_norm(x)
        return x, valid_mask
