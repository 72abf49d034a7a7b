"""AdaSpeech layers: conditional layer norm, the CLN FFT stacks and the
acoustic-condition encoders.

Counterpart of ``viet_tts_tpu/models/adaspeech/layers.py``:
``ConditionalLayerNorm`` (scale and bias projected from the speaker
vector; the projections start at kernel 0 with biases 1 and 0, so a fresh
model starts as a plain LayerNorm, eps 1e-5), the FFT blocks of
``nn/transformer.py`` with their LayerNorms replaced by CLNs
(``CLNMultiHeadAttention``, ``CLNConvFeedForward``, ``CLNFFTBlock``,
``CLNTransformerEncoder`` / ``Decoder``), and the two-conv ``_ConvLNStack``
of ``UtteranceEncoder`` (strided, averaged over time),
``PhonemeLevelEncoder`` and ``PhonemeLevelPredictor`` (4-d latents).
Parameter names follow the reference torch model
(``models/tts/adaspeech/``), as ``viet_tts_tpu/train/torch_import.py``
reads them: each CLN under its block's ``layer_norm`` as ``W_scale`` /
``W_bias``, the conv stacks' ``conv1d_{1,2}`` / ``layer_norm_{1,2}``.
Activations are (B, T, C); the speaker vector is (B, spk_dim).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from viet_tts_torch.nn.transformer import (
    ConvFeedForward,
    MultiHeadAttention,
    key_pad_mask,
    masked_attention,
    zero_padding,
)
from viet_tts_torch.nn.utils import position_table


class _ConstantLinear(nn.Linear):
    """A Linear that starts (and is re-initialised by ``seeded_init_``, with
    no draw) at kernel 0 and a constant bias, as the JAX CLN's projections."""

    def __init__(self, d_in: int, d_out: int, bias_value: float):
        super().__init__(d_in, d_out)
        self.bias_value = bias_value
        self.seeded_init_(None)

    @torch.no_grad()
    def seeded_init_(self, generator: Optional[torch.Generator]) -> None:
        del generator
        self.weight.zero_()
        self.bias.fill_(self.bias_value)


class ConditionalLayerNorm(nn.Module):
    """LayerNorm whose scale and bias come from the speaker vector."""

    def __init__(self, outdims: int, spk_dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.W_scale = _ConstantLinear(spk_dim, outdims, 1.0)
        self.W_bias = _ConstantLinear(spk_dim, outdims, 0.0)

    def forward(self, x: torch.Tensor, spk: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        return y * self.W_scale(spk)[:, None, :] + self.W_bias(spk)[:, None, :]


class CLNMultiHeadAttention(MultiHeadAttention):
    """Post-CLN self-attention: CLN(dropout(fc(attention(x))) + x, spk)."""

    def __init__(self, num_heads: int, d_model: int, spk_dim: int, dropout: float = 0.2):
        super().__init__(num_heads, d_model, dropout)
        self.layer_norm = ConditionalLayerNorm(d_model, spk_dim)

    def forward(self, x: torch.Tensor, spk: torch.Tensor,
                attn_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx, _ = masked_attention(self.heads(x, self.w_qs), self.heads(x, self.w_ks),
                                  self.heads(x, self.w_vs), attn_pad_mask)
        return self.layer_norm(self.dropout(self.fc(ctx)) + x, spk)


class CLNConvFeedForward(ConvFeedForward):
    def __init__(self, d_model: int, d_inner: int, spk_dim: int,
                 kernel_sizes: Sequence[int] = (9, 1), dropout: float = 0.2):
        super().__init__(d_model, d_inner, kernel_sizes, dropout)
        self.layer_norm = ConditionalLayerNorm(d_model, spk_dim)

    def forward(self, x: torch.Tensor, spk: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.inner(x) + x, spk)


class CLNFFTBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_inner: int, spk_dim: int,
                 kernel_sizes: Sequence[int] = (9, 1), dropout: float = 0.2):
        super().__init__()
        self.slf_attn = CLNMultiHeadAttention(num_heads, d_model, spk_dim, dropout)
        self.pos_ffn = CLNConvFeedForward(d_model, d_inner, spk_dim, kernel_sizes, dropout)

    def forward(self, x: torch.Tensor, spk: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = zero_padding(self.slf_attn(x, spk, key_pad_mask(pad_mask, x.shape[1])), pad_mask)
        return zero_padding(self.pos_ffn(x, spk), pad_mask)


class _CLNStack(nn.Module):
    def __init__(self, n_layers: int, d_model: int, max_seq_len: int, spk_dim: int,
                 num_heads: int = 2, d_inner: int = 1024,
                 kernel_sizes: Sequence[int] = (9, 1), dropout: float = 0.2):
        super().__init__()
        self.d_model, self.max_seq_len = d_model, max_seq_len
        self.layer_stack = nn.ModuleList(
            CLNFFTBlock(d_model, num_heads, d_inner, spk_dim, tuple(kernel_sizes), dropout)
            for _ in range(n_layers))

    def _blocks(self, x: torch.Tensor, pad_mask: torch.Tensor,
                spk: torch.Tensor) -> torch.Tensor:
        x = x + position_table(self.max_seq_len, self.d_model, x.shape[1], x)[None]
        for block in self.layer_stack:
            x = block(x, spk, pad_mask)
        return x


class CLNTransformerEncoder(_CLNStack):
    """Embedding (``src_word_emb``, id 0 zeroed) + sinusoid positions + CLN
    FFT blocks: (ids (B, T), pad_mask, spk) -> (hidden, raw embedding)."""

    def __init__(self, n_symbols: int, n_layers: int, d_model: int, max_seq_len: int,
                 spk_dim: int, **kwargs):
        super().__init__(n_layers, d_model, max_seq_len, spk_dim, **kwargs)
        self.src_word_emb = nn.Embedding(n_symbols + 1, d_model)

    def forward(self, src_seq: torch.Tensor, pad_mask: torch.Tensor, spk: torch.Tensor):
        emb = self.src_word_emb(src_seq) * (src_seq != 0)[..., None].to(
            self.src_word_emb.weight.dtype)
        return self._blocks(emb, pad_mask, spk), emb


class CLNTransformerDecoder(_CLNStack):
    """Positions + CLN FFT blocks over frame features: (x, pad_mask, spk) ->
    (hidden, pad_mask)."""

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, spk: torch.Tensor):
        return self._blocks(x, pad_mask, spk), pad_mask


class _ConvLNStack(nn.Module):
    """[strided Conv1d -> ReLU -> LayerNorm(eps 1e-12) -> Dropout] x 2, the
    convs padded (k - 1) // 2 on each side."""

    def __init__(self, idim: int, n_chans: int, kernel_size: int, stride: int,
                 dropout: float):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv1d_1 = nn.Conv1d(idim, n_chans, kernel_size, stride=stride, padding=pad)
        self.layer_norm_1 = nn.LayerNorm(n_chans, eps=1e-12)
        self.conv1d_2 = nn.Conv1d(n_chans, n_chans, kernel_size, stride=stride, padding=pad)
        self.layer_norm_2 = nn.LayerNorm(n_chans, eps=1e-12)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in ((self.conv1d_1, self.layer_norm_1),
                           (self.conv1d_2, self.layer_norm_2)):
            x = torch.relu(conv(x.transpose(1, 2))).transpose(1, 2)
            x = self.dropout(norm(x))
        return x


class UtteranceEncoder(nn.Module):
    """mel (B, T, idim) -> global vector (B, 1, n_chans), the mean over the
    strided stack's frames."""

    def __init__(self, idim: int, n_chans: int = 256, kernel_size: int = 5, stride: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.conv = _ConvLNStack(idim, n_chans, kernel_size, stride, dropout)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.conv(mel).mean(dim=1, keepdim=True)


class PhonemeLevelEncoder(nn.Module):
    """Per-token inputs (B, T_text, idim) -> latents (B, T_text,
    phn_latent_dim); the ``PhonemeLevelPredictor`` is the same layers over
    the encoder states."""

    def __init__(self, idim: int, n_chans: int = 256, kernel_size: int = 3,
                 dropout: float = 0.5, phn_latent_dim: int = 4):
        super().__init__()
        self.conv = _ConvLNStack(idim, n_chans, kernel_size, 1, dropout)
        self.linear = nn.Linear(n_chans, phn_latent_dim)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return self.linear(self.conv(xs))


class PhonemeLevelPredictor(PhonemeLevelEncoder):
    """Encoder states (B, T_text, idim) -> predicted latents (B, T_text, 4)."""
