"""VITS2 attention stacks: windowed relative-position multi-head attention,
the masked conv FFN, the post-norm encoder and the causal FFT stack.

Counterpart of ``viet_tts_tpu/models/vits2/attentions.py``: 1x1-conv
projections, the key / value relative embeddings of a window of 4 shared
by the heads (``emb_rel_k`` / ``emb_rel_v``, (1, 2w + 1, D)), added
through the pad-and-reshape shuffles between relative and absolute
positions; masked scores take -1e4 before the softmax. The attention is
plain PyTorch (two products and a softmax), as the JAX package's is plain
einsums; no kernel of this package runs here. Activations are (B, T, C);
parameter names are the reference's (``attn_layers.{i}.conv_q``,
``norm_layers_1.{i}.gamma``, ``ffn_layers.{i}.conv_1``,
``self_attn_layers.{i}``, ``norm_layers_0.{i}``, ``cond_pre``, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from viet_tts_torch.models.vits2.sublayers import LayerNorm, conv_same, pointwise

MASK_NEG = -1.0e4


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, 2L - 1) relative logits -> (B, H, L, L) absolute."""
    B, H, L, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(B, H, L * 2 * L)
    x = F.pad(x, (0, L - 1))
    return x.reshape(B, H, L + 1, 2 * L - 1)[:, :, :L, L - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, L) absolute weights -> (B, H, L, 2L - 1) relative."""
    B, H, L, _ = x.shape
    x = F.pad(x, (0, L - 1)).reshape(B, H, L * L + L * (L - 1))
    x = F.pad(x, (L, 0))
    return x.reshape(B, H, L, 2 * L)[:, :, :, 1:]


class RelPosMultiHeadAttention(nn.Module):
    """Multi-head attention with relative key / value embeddings within
    ``window_size`` (none when it is None)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int, p_dropout: float = 0.0,
                 window_size: Optional[int] = 4, heads_share: bool = True):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.k_channels = channels // n_heads
        self.p_dropout = p_dropout
        self.window_size = window_size
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        if window_size is not None:
            n_rel = 1 if heads_share else n_heads
            shape = (n_rel, 2 * window_size + 1, self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.zeros(shape))
            self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def seeded_init_(self, generator: torch.Generator) -> None:
        """The relative tables ~ N(0, D^-1/2), as the JAX module's init."""
        if self.window_size is None:
            return
        with torch.no_grad():
            for p in (self.emb_rel_k, self.emb_rel_v):
                p.copy_(torch.randn(p.shape, generator=generator) * self.k_channels ** -0.5)

    def _relative_embeddings(self, emb: torch.Tensor, length: int) -> torch.Tensor:
        """The (n, 2w + 1, D) table padded (T > w + 1) or sliced (T < w + 1)
        to (n, 2T - 1, D)."""
        w = self.window_size
        pad_len = max(length - (w + 1), 0)
        start = max((w + 1) - length, 0)
        if pad_len > 0:
            emb = F.pad(emb, (0, 0, pad_len, pad_len))
        return emb[:, start: start + 2 * length - 1]

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, c (B, T, C); attn_mask (B, Tq, Tk), 1 where a query may attend."""
        H, D = self.n_heads, self.k_channels
        B, T, _ = x.shape
        q = pointwise(self.conv_q, x).reshape(B, -1, H, D).transpose(1, 2)
        k = pointwise(self.conv_k, c).reshape(B, -1, H, D).transpose(1, 2)
        v = pointwise(self.conv_v, c).reshape(B, -1, H, D).transpose(1, 2)
        q = q / (D ** 0.5)
        scores = q @ k.transpose(-1, -2)
        if self.window_size is not None:
            rel_k = self._relative_embeddings(self.emb_rel_k, T)
            scores = scores + _relative_to_absolute(torch.einsum("bhld,nmd->bhlm", q, rel_k))
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[:, None] == 0, MASK_NEG)
        p_attn = F.dropout(torch.softmax(scores, dim=-1), self.p_dropout,
                           training=self.training)
        out = p_attn @ v
        if self.window_size is not None:
            rel_v = self._relative_embeddings(self.emb_rel_v, T)
            out = out + torch.einsum("bhlm,nmd->bhld", _absolute_to_relative(p_attn), rel_v)
        out = out.transpose(1, 2).reshape(B, T, self.channels)
        return pointwise(self.conv_o, out)


class MaskedFFN(nn.Module):
    """Two masked convs with a ReLU between ("SAME" or causal padding)."""

    def __init__(self, in_channels: int, filter_channels: int, out_channels: int,
                 kernel_size: int = 3, p_dropout: float = 0.0, causal: bool = False):
        super().__init__()
        self.p_dropout, self.causal = p_dropout, causal
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        h = torch.relu(conv_same(self.conv_1, x * x_mask, self.causal))
        h = F.dropout(h, self.p_dropout, training=self.training)
        return conv_same(self.conv_2, h * x_mask, self.causal) * x_mask


class VitsEncoder(nn.Module):
    """Post-norm relative-position transformer stack; with ``gin_channels``
    the speaker vector is added (``spk_emb_linear``) before layer
    ``cond_layer_idx``."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 3, p_dropout: float = 0.1,
                 window_size: Optional[int] = 4, gin_channels: int = 0,
                 cond_layer_idx: int = 2):
        super().__init__()
        self.p_dropout = p_dropout
        self.cond_layer_idx = cond_layer_idx
        self.gin_channels = gin_channels
        if gin_channels > 0 and n_layers > cond_layer_idx:
            self.spk_emb_linear = nn.Linear(gin_channels, hidden_channels)
        self.attn_layers = nn.ModuleList(
            RelPosMultiHeadAttention(hidden_channels, hidden_channels, n_heads, p_dropout,
                                     window_size) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            MaskedFFN(hidden_channels, filter_channels, hidden_channels, kernel_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, C), x_mask (B, T, 1), g (B, gin) or None."""
        m = x_mask[..., 0]
        attn_mask = m[:, :, None] * m[:, None, :]
        x = x * x_mask
        for i, (attn, n1, ffn, n2) in enumerate(zip(self.attn_layers, self.norm_layers_1,
                                                    self.ffn_layers, self.norm_layers_2)):
            if i == self.cond_layer_idx and g is not None and self.gin_channels > 0:
                x = (x + self.spk_emb_linear(g)[:, None, :]) * x_mask
            y = F.dropout(attn(x, x, attn_mask), self.p_dropout, training=self.training)
            x = n1(x + y)
            y = F.dropout(ffn(x, x_mask), self.p_dropout, training=self.training)
            x = n2(x + y)
        return x * x_mask


class CausalFFT(nn.Module):
    """Causal self-attention + causal conv FFN stack, the speaker vector
    gating x before every layer (the ``fft`` coupling flow's network). The
    gate's per-layer projection ``cond_layer`` is a 1x1 conv of (out, in, 1)
    (the JAX module's Dense), ``cond_pre`` one 1x1 conv shared by the
    layers."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int = 1, kernel_size: int = 1, p_dropout: float = 0.0,
                 gin_channels: int = 0):
        super().__init__()
        H = self.hidden_channels = hidden_channels
        self.p_dropout = p_dropout
        self.gin_channels = gin_channels
        if gin_channels > 0:
            self.cond_layer = nn.Conv1d(gin_channels, 2 * H * n_layers, 1)
            self.cond_pre = nn.Conv1d(H, 2 * H, 1)
        self.self_attn_layers = nn.ModuleList(
            RelPosMultiHeadAttention(H, H, n_heads, p_dropout, window_size=None)
            for _ in range(n_layers))
        self.norm_layers_0 = nn.ModuleList(LayerNorm(H) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            MaskedFFN(H, filter_channels, H, kernel_size, p_dropout, causal=True)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(H) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        H = self.hidden_channels
        T = x.shape[1]
        m = x_mask[..., 0]
        attn_mask = (torch.tril(torch.ones(T, T, dtype=x.dtype, device=x.device))[None]
                     * m[:, :, None] * m[:, None, :])
        use_cond = g is not None and self.gin_channels > 0
        if use_cond:
            g_all = pointwise(self.cond_layer, g[:, None, :])  # (B, 1, 2HL)
        x = x * x_mask
        for i, (attn, n0, ffn, n1) in enumerate(zip(self.self_attn_layers, self.norm_layers_0,
                                                    self.ffn_layers, self.norm_layers_1)):
            if use_cond:
                acts = pointwise(self.cond_pre, x) + g_all[..., 2 * H * i: 2 * H * (i + 1)]
                x = torch.tanh(acts[..., :H]) * torch.sigmoid(acts[..., H:])
            y = F.dropout(attn(x, x, attn_mask), self.p_dropout, training=self.training)
            x = n0(x + y)
            y = F.dropout(ffn(x, x_mask), self.p_dropout, training=self.training)
            x = n1(x + y)
        return x * x_mask
