"""espnet-style conformer encoder ("latest" and "legacy" rel-pos) for JETS.

Counterpart of ``viet_tts_tpu/nn/espnet_conformer.py``: the espnet conformer
as the reference's JETS builds it (``encoder_type`` / ``decoder_type:
conformer``: rel-pos self-attention, swish, macaron feed-forwards at 0.5,
the CNN module, conv1d position-wise layers, LayerNorm eps 1e-12
throughout). Module and parameter names are espnet's torch names, the ones
``viet_tts_tpu/train/torch_import.py:_espnet_conformer_stack_params`` reads:
``embed.0``, ``encoders.{i}.self_attn.{linear_q, linear_k, linear_v,
linear_out, linear_pos, pos_bias_u, pos_bias_v}``,
``feed_forward[_macaron].w_{1,2}``, ``norm_{ff, ff_macaron, mha, conv,
final}``, ``conv_module.{pointwise_conv1, depthwise_conv, norm,
pointwise_conv2}``, ``after_norm``. Activations are (B, T, C).

``RelPositionMultiHeadedAttention`` has the JAX module's three routes, one
function (``attn_implementation``):
- "shift": the reference's padded-reshape relative shift (``rel_shift``;
  the legacy one is the XL shift, ``ops/xl_attention.py:relative_shift``);
- "dense": the factorised logits (``ops/espnet_attention.py`` for "latest",
  ``ops/xl_attention.py`` for "legacy");
- "flash": "latest" on kernel K7 (``ops/flash_rel_attention.py``), "legacy"
  on kernel K6 (``ops/flash_xl_attention.py:flash_xl_attention``), both
  with their backward kernels and the attention-weight dropout inside the
  kernel in training, keyed by a seed drawn per call on the host from the
  caller's ``generator``. The flash route skips the shift route's
  post-softmax zeroing of invalid keys, a no-op for any row with a valid
  key.

Dropout sits where the flax modules have it. On the shift route the
position table takes the positional dropout too; the factorised routes
need the raw sinusoid table, so there it does not (as in the JAX module).
The conv module's BatchNorm follows flax's training semantics
(``models/fastspeech2/layers.py:FlaxBatchNorm1d``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from viet_tts_torch.models.fastspeech2.layers import FlaxBatchNorm1d
from viet_tts_torch.nn.conformer import swish
from viet_tts_torch.nn.espnet_transformer import MultiLayeredConv1d, interleaved_sinusoid_table
from viet_tts_torch.ops.espnet_attention import (
    espnet_rel_scores_latest,
    neg_rel_table,
    rel_pos_queries_latest,
)
from viet_tts_torch.ops.flash_attention import MASK_NEG
from viet_tts_torch.ops.flash_rel_attention import flash_rel_attention
from viet_tts_torch.ops.flash_xl_attention import flash_xl_attention
from viet_tts_torch.ops.xl_attention import relative_shift as legacy_rel_shift
from viet_tts_torch.ops.xl_attention import xl_attention_scores, xl_pos_queries

LN_EPS = 1e-12  # espnet LayerNorm epsilon


@functools.lru_cache(maxsize=8)
def rel_positional_table(t: int, d_model: int) -> np.ndarray:
    """Symmetric table for positions T-1 .. -(T-1), shape (2T-1, d): sin /
    cos interleaved, computed in float64 and stored in fp32."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((2 * t - 1, d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """espnet 'latest' relative shift: (B, H, T, 2T-1) -> (B, H, T, T)."""
    B, H, T, _ = x.shape
    x = torch.cat([x.new_zeros(B, H, T, 1), x], dim=-1)
    x = x.reshape(B, H, 2 * T, T)
    return x[:, :, 1:].reshape(B, H, T, 2 * T - 1)[..., :T]


class RelPositionMultiHeadedAttention(nn.Module):
    """espnet rel-pos MHA ("latest" symmetric table, or "legacy" XL shift)
    with the learned biases ``pos_bias_u`` / ``pos_bias_v`` (H, D) and scale
    1/sqrt(D). ``valid_mask`` (B, T) True at valid keys."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 legacy: bool = False, attn_implementation: str = "shift"):
        super().__init__()
        if attn_implementation not in ("shift", "dense", "flash"):
            raise ValueError(f"unknown attn_implementation {attn_implementation!r}")
        self.num_heads, self.d_head = num_heads, d_model // num_heads
        self.legacy = legacy
        self.attn_implementation = attn_implementation
        self.dropout_rate = dropout
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.d_head))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.d_head))
        self.dropout = nn.Dropout(dropout)

    def seeded_init_(self, generator: torch.Generator) -> None:
        """flax's xavier_uniform for the two biases."""
        bound = math.sqrt(6.0 / (self.num_heads + self.d_head))
        with torch.no_grad():
            for p in (self.pos_bias_u, self.pos_bias_v):
                p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)

    def _factorised(self, q, k, v, table, valid_mask, generator):
        """The dense and flash routes: the context (B, T, H*D) for the flash
        route, else the logits (B, H, T, T)."""
        D = self.d_head
        scale = 1.0 / math.sqrt(D)
        qc, qv = q + self.pos_bias_u, q + self.pos_bias_v
        pos_kernel = self.linear_pos.weight.t()  # (E, H*D), flax's kernel
        flash = self.attn_implementation == "flash"
        pad_mask = None if valid_mask is None else ~valid_mask
        drop_p, seed = 0.0, None
        if flash and self.training and self.dropout_rate > 0.0:
            drop_p = self.dropout_rate
            # a per-call seed for the in-kernel mask, drawn on the host
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        if self.legacy:
            gA, gB = xl_pos_queries(qv, pos_kernel)
            if not flash:
                return xl_attention_scores(qc, k, gA, gB, table, scale)
            return flash_xl_attention(qc, k, v, gA, gB, table, scale, pad_mask, drop_p, seed)
        g = rel_pos_queries_latest(qv, pos_kernel)
        neg = neg_rel_table(table)
        if not flash:
            return espnet_rel_scores_latest(qc, k, g, neg, scale)
        return flash_rel_attention(qc, k, v, g, neg, scale, pad_mask, drop_p, seed)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, d_model); pos_emb (1, 2T-1, d_model) ("latest") or
        (1, T, d_model) ("legacy"); ``generator`` draws the flash route's
        dropout seeds in training (torch's default generator when None)."""
        B, T, C = x.shape
        H, D = self.num_heads, self.d_head
        q = self.linear_q(x).view(B, T, H, D)
        k = self.linear_k(x).view(B, T, H, D)
        v = self.linear_v(x).view(B, T, H, D)
        if self.attn_implementation != "shift":
            out = self._factorised(q, k, v, pos_emb[0], valid_mask, generator)
            if self.attn_implementation == "flash":
                return self.linear_out(out)
            scores = out
        else:
            p = self.linear_pos(pos_emb).reshape(1, -1, H, D)
            matrix_ac = torch.einsum("bqhd,bkhd->bhqk", q + self.pos_bias_u, k)
            matrix_bd = torch.einsum("bqhd,khd->bhqk", q + self.pos_bias_v, p[0])
            matrix_bd = legacy_rel_shift(matrix_bd) if self.legacy else rel_shift(matrix_bd)
            scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=x.dtype))
            scores = (matrix_ac + matrix_bd) * scale.to(x.device)
        if valid_mask is not None:
            keep = valid_mask[:, None, None, :]
            scores = scores.masked_fill(~keep, MASK_NEG)
        attn = torch.softmax(scores, dim=-1)
        if valid_mask is not None:
            attn = attn.masked_fill(~keep, 0.0)
        attn = self.dropout(attn)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, C)
        return self.linear_out(ctx)


class PositionwiseFeedForward(nn.Module):
    """espnet's linear position-wise layer: Linear -> swish -> dropout ->
    Linear (``positionwise_layer_type: linear``)."""

    def __init__(self, d_model: int, hidden: int, dropout: float = 0.0):
        super().__init__()
        self.w_1 = nn.Linear(d_model, hidden)
        self.w_2 = nn.Linear(hidden, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(swish(self.w_1(x))))


class EspnetConvModule(nn.Module):
    """pointwise (2x) -> GLU -> depthwise k ('SAME') -> BatchNorm -> swish
    -> pointwise, on (B, T, C)."""

    def __init__(self, d_model: int, kernel_size: int = 7):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel_size,
                                        padding=(kernel_size - 1) // 2, groups=d_model)
        self.norm = FlaxBatchNorm1d(d_model)
        self.pointwise_conv2 = nn.Conv1d(d_model, d_model, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.pointwise_conv1(x.transpose(1, 2)).chunk(2, dim=1)
        h = self.norm(self.depthwise_conv(a * torch.sigmoid(b)))
        return self.pointwise_conv2(swish(h)).transpose(1, 2)


class EspnetConformerLayer(nn.Module):
    """Macaron feed-forward at 0.5, rel-pos self-attention, conv module,
    feed-forward, final LayerNorm; pre-norm residual branches."""

    def __init__(self, d_model: int, num_heads: int, linear_units: int,
                 kernel_size: int = 7, dropout: float = 0.1, attn_dropout: float = 0.1,
                 macaron: bool = True, ffn_type: str = "conv1d", ffn_kernel: int = 1,
                 legacy: bool = False, attn_implementation: str = "shift"):
        super().__init__()
        if ffn_type not in ("conv1d", "linear"):
            raise ValueError(f"unknown positionwise_layer_type {ffn_type!r}")

        def ffn():
            if ffn_type == "conv1d":
                return MultiLayeredConv1d(d_model, linear_units, ffn_kernel, dropout)
            return PositionwiseFeedForward(d_model, linear_units, dropout)

        self.self_attn = RelPositionMultiHeadedAttention(d_model, num_heads, attn_dropout,
                                                         legacy, attn_implementation)
        self.feed_forward = ffn()
        self.feed_forward_macaron = ffn() if macaron else None
        self.conv_module = EspnetConvModule(d_model, kernel_size)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_ff_macaron = nn.LayerNorm(d_model, eps=LN_EPS) if macaron else None
        self.norm_conv = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.ff_scale = 0.5 if macaron else 1.0

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.feed_forward_macaron is not None:
            x = x + 0.5 * self.dropout(self.feed_forward_macaron(self.norm_ff_macaron(x)))
        h = self.self_attn(self.norm_mha(x), pos_emb, valid_mask, generator)
        x = x + self.dropout(h)
        x = x + self.dropout(self.conv_module(self.norm_conv(x)))
        x = x + self.ff_scale * self.dropout(self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x)


class EspnetConformerEncoder(nn.Module):
    """Embedding (optional, id 0 zeroed) -> x * sqrt(d) -> positional
    dropout -> conformer layers -> ``after_norm``: the drop-in alternative
    to ``EspnetTransformerEncoder`` for JETS. ``valid_mask`` (B, T) True at
    VALID positions; ``generator`` draws the flash route's per-call dropout
    seeds in training mode."""

    def __init__(self, d_model: int, num_heads: int, linear_units: int, num_blocks: int,
                 n_symbols: Optional[int] = None, kernel_size: int = 7,
                 dropout: float = 0.1, positional_dropout: float = 0.1,
                 attn_dropout: float = 0.1, macaron: bool = True, ffn_type: str = "conv1d",
                 ffn_kernel: int = 1, legacy: bool = False,
                 attn_implementation: str = "shift"):
        super().__init__()
        self.d_model = d_model
        self.legacy = legacy
        self.attn_implementation = attn_implementation
        if n_symbols is not None:
            self.embed = nn.ModuleList([nn.Embedding(n_symbols, d_model)])
        self.encoders = nn.ModuleList(
            EspnetConformerLayer(d_model, num_heads, linear_units, kernel_size, dropout,
                                 attn_dropout, macaron, ffn_type, ffn_kernel, legacy,
                                 attn_implementation)
            for _ in range(num_blocks)
        )
        self.after_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pos_dropout = nn.Dropout(positional_dropout)

    def position_table(self, T: int, like: torch.Tensor) -> torch.Tensor:
        """(1, 2T-1, d) symmetric table ("latest") or (1, T, d) interleaved
        positive table ("legacy"), in ``like``'s dtype and device."""
        table = (interleaved_sinusoid_table(T, self.d_model) if self.legacy
                 else rel_positional_table(T, self.d_model))
        return torch.from_numpy(table).to(device=like.device, dtype=like.dtype)[None]

    def forward(self, xs: torch.Tensor, valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if hasattr(self, "embed"):
            x = self.embed[0](xs) * (xs != 0)[..., None]
        else:
            x = xs
        x = self.pos_dropout(x * math.sqrt(self.d_model))
        pos_emb = self.position_table(x.shape[1], x)
        if self.attn_implementation == "shift":
            pos_emb = self.pos_dropout(pos_emb)
        for layer in self.encoders:
            x = layer(x, pos_emb, valid_mask, generator)
        return self.after_norm(x), valid_mask
