"""Conformer blocks (macaron FFN, Transformer-XL relative MHSA, conv module)
of the FastSpeech2 acoustic model.

Counterpart of ``viet_tts_tpu/nn/conformer.py``. Parameter names follow the
reference torch model (``models/tts/fastspeech2/blocks/conformer.py``), as
``viet_tts_tpu/train/torch_import.py:_conformer_block_params`` reads them:
``layer_stack.{i}.sequential.{0: ff1, 1: mhsa, 2: conv, 3: ff2, 4: final
LayerNorm}``, the linear layers under ``.linear``, the convs under ``.conv``.
The reference's projections have no bias; the flax Dense layers do, so the
port keeps a bias beside each (``*.linear.bias``, which the importer does
not read: it sets those biases to 0). Activations are (B, T, C).

``RelativeMultiHeadAttention`` has the JAX module's three routes, one
function (``attn_implementation``):
- "shift": the reference's padded-reshape relative shift;
- "dense": the factorised logits of ``ops/xl_attention.py``;
- "flash": kernels K4 / K5 / K6 through ``ops/xl_attention.py:xl_attention``,
  routed by padded length as the JAX module routes them: xl3 while the
  128-padded T is at most 512, xl2 while the 32-padded T is at most 1024,
  xl beyond. In training the attention-weight dropout runs inside the
  kernels, keyed by a seed drawn per call from the caller's ``generator``;
  each route has its backward kernels.

``mask_attn_keys=False`` is the reference's behaviour: its ``nn.Sequential``
drops the mask, so self-attention sees the padding keys and only the block
output is zeroed. LayerNorms take flax's epsilon (1e-6); the conv module's
BatchNorm flax's eval semantics (running statistics, eps 1e-5).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from viet_tts_torch.models.fastspeech2.layers import ConvNorm, FlaxBatchNorm1d, LinearNorm
from viet_tts_torch.nn.utils import position_table
from viet_tts_torch.ops.flash_attention import MASK_NEG
from viet_tts_torch.ops.xl_attention import (
    relative_shift,
    xl_attention,
    xl_attention_scores,
    xl_pos_queries,
)

LN_EPS = 1e-6  # flax nn.LayerNorm


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class FeedForwardModule(nn.Module):
    """Pre-norm Linear(expansion x) + swish + Linear, no residual:
    ``sequential.{0: LayerNorm, 1: .linear, 4: .linear}``."""

    def __init__(self, d_model: int, expansion: int = 4, dropout: float = 0.1):
        super().__init__()
        self.sequential = nn.ModuleList([
            nn.LayerNorm(d_model, eps=LN_EPS),
            LinearNorm(d_model, d_model * expansion),
            nn.Identity(),
            nn.Identity(),
            LinearNorm(d_model * expansion, d_model),
        ])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.sequential
        x = self.dropout(swish(seq[1](seq[0](x))))
        return self.dropout(seq[4](x))


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL attention with content (u) and position (v) biases.
    The scale is 1/sqrt(d_model), as in the reference, not 1/sqrt(d_head)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 attn_implementation: str = "shift"):
        super().__init__()
        if attn_implementation not in ("shift", "dense", "flash"):
            raise ValueError(f"unknown attn_implementation {attn_implementation!r}")
        self.d_model, self.num_heads = d_model, num_heads
        self.d_head = d_model // num_heads
        self.attn_implementation = attn_implementation
        self.query_proj = LinearNorm(d_model, d_model)
        self.key_proj = LinearNorm(d_model, d_model)
        self.value_proj = LinearNorm(d_model, d_model)
        self.pos_proj = LinearNorm(d_model, d_model, bias=False)
        self.out_proj = LinearNorm(d_model, d_model)
        self.u_bias = nn.Parameter(torch.zeros(num_heads, self.d_head))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, self.d_head))
        self.dropout = nn.Dropout(dropout)

    def seeded_init_(self, generator: torch.Generator) -> None:
        """flax's xavier_uniform for the two biases."""
        bound = math.sqrt(6.0 / (self.num_heads + self.d_head))
        with torch.no_grad():
            for p in (self.u_bias, self.v_bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)

    def _flash(self, q, k, v, table, pad_mask, generator):
        drop_p = self.dropout.p if self.training else 0.0
        pos_kernel = self.pos_proj.linear.weight.t()  # (E, H*D), flax's kernel
        return xl_attention(q, k, v, self.u_bias, self.v_bias, pos_kernel, table,
                            1.0 / math.sqrt(self.d_model), pad_mask, "flash", drop_p,
                            generator)

    def forward(self, x: torch.Tensor, table: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, d_model), table (T, d_model) the raw sinusoid table,
        pad_mask (B, T) True at padding keys (or None). ``generator`` draws
        the flash route's dropout seeds in training (torch's default
        generator when None)."""
        B, T, _ = x.shape
        H, D = self.num_heads, self.d_head
        q = self.query_proj(x).reshape(B, T, H, D)
        k = self.key_proj(x).reshape(B, T, H, D)
        v = self.value_proj(x).reshape(B, T, H, D)
        impl = self.attn_implementation
        if impl == "flash":
            return self.out_proj(self._flash(q, k, v, table, pad_mask, generator))
        if impl == "dense":
            gA, gB = xl_pos_queries(q + self.v_bias, self.pos_proj.linear.weight.t())
            score = xl_attention_scores(q + self.u_bias, k, gA, gB, table,
                                        1.0 / math.sqrt(self.d_model))
        else:
            p = self.pos_proj(table).reshape(T, H, D)
            content = torch.einsum("bqhd,bkhd->bhqk", q + self.u_bias, k)
            pos = relative_shift(torch.einsum("bqhd,khd->bhqk", q + self.v_bias, p))
            scale = 1.0 / torch.sqrt(torch.tensor(float(self.d_model), dtype=x.dtype))
            score = (content + pos) * scale.to(x.device)
        if pad_mask is not None:
            score = score.masked_fill(pad_mask[:, None, None, :], MASK_NEG)
        attn = self.dropout(torch.softmax(score, dim=-1))
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, self.d_model)
        return self.out_proj(ctx)


class ConformerConvModule(nn.Module):
    """LayerNorm -> pointwise (2x) -> GLU -> depthwise k -> BatchNorm ->
    swish -> pointwise: ``sequential.{0: LayerNorm, 2: .conv, 4: .conv
    (depthwise, no bias), 5: BatchNorm, 7: .conv}``."""

    def __init__(self, d_model: int, kernel_size: int = 31, expansion: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        self.sequential = nn.ModuleList([
            nn.LayerNorm(d_model, eps=LN_EPS),
            nn.Identity(),
            ConvNorm(d_model, d_model * expansion),
            nn.Identity(),
            ConvNorm(d_model, d_model, kernel_size, groups=d_model, bias=False),
            FlaxBatchNorm1d(d_model),
            nn.Identity(),
            ConvNorm(d_model, d_model),
        ])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.sequential
        x = seq[2](seq[0](x).transpose(1, 2))  # (B, 2C, T)
        a, b = x.chunk(2, dim=1)
        x = swish(seq[5](seq[4](a * torch.sigmoid(b))))
        return self.dropout(seq[7](x).transpose(1, 2))


class _Residual(nn.Module):
    """The reference's ``ResidualConnectionModule``: the block under
    ``.module`` (the residual and its factor are applied by the caller)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module


class _MHSAModule(nn.Module):
    """``sequential.1.module``: ``layer_norm`` and ``attention``."""

    def __init__(self, d_model: int, attention: RelativeMultiHeadAttention):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attention = attention


class ConformerBlock(nn.Module):
    """Macaron conformer block; padding rows are zeroed at its output."""

    def __init__(self, d_model: int, num_heads: int = 8, ffn_expansion: int = 4,
                 conv_expansion: int = 2, kernel_size: int = 31,
                 half_step_residual: bool = True, dropout: float = 0.1,
                 mask_attn_keys: bool = False, attn_implementation: str = "shift"):
        super().__init__()
        self.ff_factor = 0.5 if half_step_residual else 1.0
        self.mask_attn_keys = mask_attn_keys
        attn = RelativeMultiHeadAttention(d_model, num_heads, dropout, attn_implementation)
        self.sequential = nn.ModuleList([
            _Residual(FeedForwardModule(d_model, ffn_expansion, dropout)),
            _Residual(_MHSAModule(d_model, attn)),
            _Residual(ConformerConvModule(d_model, kernel_size, conv_expansion, dropout)),
            _Residual(FeedForwardModule(d_model, ffn_expansion, dropout)),
            nn.LayerNorm(d_model, eps=LN_EPS),
        ])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, table: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ff1, mhsa, conv, ff2, final_ln = self.sequential
        x = x + self.ff_factor * ff1.module(x)
        attn_out = mhsa.module.attention(mhsa.module.layer_norm(x), table,
                                         pad_mask if self.mask_attn_keys else None,
                                         generator)
        x = x + self.dropout(attn_out)
        x = x + conv.module(x)
        x = x + self.ff_factor * ff2.module(x)
        x = final_ln(x)
        if pad_mask is not None:
            x = x * (~pad_mask)[..., None].to(x.dtype)
        return x


class _ConformerStack(nn.Module):
    """The sinusoid table added to the input, then the blocks
    (``layer_stack.{i}``)."""

    def __init__(self, n_layers: int, d_model: int, max_seq_len: int, num_heads: int = 8,
                 ffn_expansion: int = 4, conv_expansion: int = 2, kernel_size: int = 31,
                 half_step_residual: bool = True, dropout: float = 0.1,
                 mask_attn_keys: bool = False, attn_implementation: str = "shift"):
        super().__init__()
        self.d_model, self.max_seq_len = d_model, max_seq_len
        self.layer_stack = nn.ModuleList([
            ConformerBlock(d_model, num_heads, ffn_expansion, conv_expansion, kernel_size,
                           half_step_residual, dropout, mask_attn_keys, attn_implementation)
            for _ in range(n_layers)
        ])

    def table(self, T: int, like: torch.Tensor) -> torch.Tensor:
        """The first T rows of the (max(max_seq_len + 1, T), d_model) table."""
        return position_table(self.max_seq_len, self.d_model, T, like)

    def _blocks(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        table = self.table(x.shape[1], x)
        x = x + table[None]
        for block in self.layer_stack:
            x = block(x, table, pad_mask, generator)
        return x


class ConformerEncoder(_ConformerStack):
    """Phoneme embedding (``src_word_emb``, id 0 zeroed) + positions +
    blocks: (ids (B, T), pad_mask) -> (hidden, raw embedding)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, max_seq_len: int,
                 **kwargs):
        super().__init__(n_layers, d_model, max_seq_len, **kwargs)
        self.src_word_emb = nn.Embedding(n_symbols + 1, d_model)

    def forward(self, src_seq: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        emb = self.src_word_emb(src_seq) * (src_seq != 0)[..., None].to(
            self.src_word_emb.weight.dtype)
        return self._blocks(emb, pad_mask, generator), emb


class ConformerDecoder(_ConformerStack):
    """Positions + blocks over frame features: (x, pad_mask) -> (hidden,
    pad_mask)."""

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._blocks(x, pad_mask, generator), pad_mask
