"""FastSpeech2-style FFT (feed-forward Transformer) blocks.

Counterpart of ``viet_tts_tpu/nn/transformer.py``: post-norm multi-head
self-attention and a two-conv position-wise FFN (kernel sizes (9, 1),
"SAME" padding), the fixed sinusoid table added to the input, and the
padding rows zeroed after each sub-block. Parameter names follow the
reference torch model (``models/tts/fastspeech2/blocks/transformer.py``),
as ``viet_tts_tpu/train/torch_import.py:_fft_block_params`` reads them:
``layer_stack.{i}.slf_attn.{w_qs, w_ks, w_vs, fc, layer_norm}`` and
``layer_stack.{i}.pos_ffn.{w_1, w_2, layer_norm}``. Activations are
(B, T, C).

The attention is ``torch.matmul`` and a softmax, as the JAX package
computes it (einsums, no Pallas kernel): padded keys score ``MASK_NEG``
(-1e9, not -inf), so a query row whose keys are all padding is uniform,
not NaN. LayerNorms take flax's epsilon (1e-6). The JAX ``remat`` option
(gradient rematerialisation, a memory setting) is not read, as in the
port's conformer stacks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from viet_tts_torch.nn.utils import position_table
from viet_tts_torch.ops.flash_attention import MASK_NEG

LN_EPS = 1e-6  # flax nn.LayerNorm


def masked_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     attn_pad_mask: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heads (B, H, T, d) -> (context (B, Tq, H * d), weights (B, H, Tq, Tk));
    ``attn_pad_mask`` (B, Tq, Tk) True where a score is masked."""
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    if attn_pad_mask is not None:
        scores = scores.masked_fill(attn_pad_mask[:, None], MASK_NEG)
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.matmul(attn, vh).transpose(1, 2)
    return ctx.reshape(*ctx.shape[:2], -1), attn


def key_pad_mask(pad_mask: Optional[torch.Tensor], T: int) -> Optional[torch.Tensor]:
    """(B, T) True at padding -> (B, T, T), every query masking the padded
    keys."""
    if pad_mask is None:
        return None
    return pad_mask[:, None, :].expand(pad_mask.shape[0], T, T)


def zero_padding(x: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if pad_mask is None else x * (~pad_mask)[..., None].to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Post-norm MHA: LayerNorm(dropout(fc(attention(q, k, v))) + q)."""

    def __init__(self, num_heads: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        d_head = d_model // num_heads
        self.w_qs = nn.Linear(d_model, num_heads * d_head)
        self.w_ks = nn.Linear(d_model, num_heads * d_head)
        self.w_vs = nn.Linear(d_model, num_heads * d_head)
        self.fc = nn.Linear(num_heads * d_head, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def heads(self, x: torch.Tensor, proj: nn.Linear) -> torch.Tensor:
        B, T, _ = x.shape
        return proj(x).view(B, T, self.num_heads, -1).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                attn_pad_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ctx, attn = masked_attention(self.heads(q, self.w_qs), self.heads(k, self.w_ks),
                                     self.heads(v, self.w_vs), attn_pad_mask)
        return self.layer_norm(self.dropout(self.fc(ctx)) + q), attn


class ConvFeedForward(nn.Module):
    """Position-wise FFN as two 1-D convs ("SAME" padding), post-norm."""

    def __init__(self, d_model: int, d_inner: int, kernel_sizes: Sequence[int] = (9, 1),
                 dropout: float = 0.1):
        super().__init__()
        k1, k2 = kernel_sizes
        self.w_1 = nn.Conv1d(d_model, d_inner, k1, padding=(k1 - 1) // 2)
        self.w_2 = nn.Conv1d(d_inner, d_model, k2, padding=(k2 - 1) // 2)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def inner(self, x: torch.Tensor) -> torch.Tensor:
        """dropout(w_2(relu(w_1(x)))), before the residual and the norm."""
        h = torch.relu(self.w_1(x.transpose(1, 2)))
        return self.dropout(self.w_2(h).transpose(1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.inner(x) + x)


class FFTBlock(nn.Module):
    """Self-attention + conv FFN, the padding rows zeroed after each."""

    def __init__(self, d_model: int, num_heads: int, d_inner: int,
                 kernel_sizes: Sequence[int] = (9, 1), dropout: float = 0.1):
        super().__init__()
        self.slf_attn = MultiHeadAttention(num_heads, d_model, dropout)
        self.pos_ffn = ConvFeedForward(d_model, d_inner, kernel_sizes, dropout)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, attn = self.slf_attn(x, x, x, key_pad_mask(pad_mask, x.shape[1]))
        x = zero_padding(x, pad_mask)
        return zero_padding(self.pos_ffn(x), pad_mask), attn


class _FFTStack(nn.Module):
    def __init__(self, n_layers: int, d_model: int, max_seq_len: int, num_heads: int = 2,
                 d_inner: int = 1024, kernel_sizes: Sequence[int] = (9, 1),
                 dropout: float = 0.2):
        super().__init__()
        self.d_model, self.max_seq_len = d_model, max_seq_len
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, num_heads, d_inner, tuple(kernel_sizes), dropout)
            for _ in range(n_layers))

    def _blocks(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = x + position_table(self.max_seq_len, self.d_model, x.shape[1], x)[None]
        for block in self.layer_stack:
            x, _ = block(x, pad_mask)
        return x


class TransformerEncoder(_FFTStack):
    """Phoneme embedding (``src_word_emb``, id 0 zeroed) + positions + FFT
    blocks: (ids (B, T), pad_mask) -> (hidden, raw embedding)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, max_seq_len: int,
                 **kwargs):
        super().__init__(n_layers, d_model, max_seq_len, **kwargs)
        self.src_word_emb = nn.Embedding(n_symbols + 1, d_model)

    def forward(self, src_seq: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` is accepted for the conformer stacks' signature;
        ``nn.Dropout`` draws from torch's generator of the device."""
        emb = self.src_word_emb(src_seq) * (src_seq != 0)[..., None].to(
            self.src_word_emb.weight.dtype)
        return self._blocks(emb, pad_mask), emb


class TransformerDecoder(_FFTStack):
    """Positions + FFT blocks over frame features: (x, pad_mask) ->
    (hidden, pad_mask)."""

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._blocks(x, pad_mask), pad_mask
