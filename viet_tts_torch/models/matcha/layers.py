"""Matcha-TTS text-encoder layers: RoPE attention, conv prenet, encoder.

Counterpart of ``viet_tts_tpu/models/matcha/layers.py``: the channel
LayerNorm (eps 1e-4, parameters ``gamma`` / ``beta``), the residual
``ConvReluNorm`` prenet with its zero-initialised projection, rotary
embeddings on the first half of each head's dims (labml's convention),
post-norm attention plus masked conv FFN, and the text encoder with its
mu projection. Activations are (B, T, C). Parameter names follow the
reference torch model, as ``train/torch_import.py:import_matcha`` reads
them (``prenet.conv_layers.{i}``, ``encoder.attn_layers.{i}.conv_q``,
``encoder.norm_layers_1.{i}.gamma``, ``proj_m``, ...); the 1x1 convs are
``Conv1d``s of kernel 1, applied as linear maps on the channel-last
activations.

The attention is plain PyTorch (a product, a softmax and a product), as
the JAX package's is plain einsums; the padded keys take -1e4 before the
softmax, as in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

MASK_NEG = -1.0e4  # the reference masks attention scores with -1e4


def pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-1 ``Conv1d`` on channel-last x (B, T, C_in) -> (B, T, C_out)."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


def conv_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 'SAME'-padded ``Conv1d`` on channel-last x."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the last (channel) axis with eps 1e-4."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.gamma, self.beta, self.eps)


class ZeroConv1d(nn.Conv1d):
    """A ``Conv1d`` whose seeded initialisation is all zeros (the prenet's
    projection, so that the prenet starts as the identity)."""

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()
            self.bias.zero_()


class ConvReluNorm(nn.Module):
    """[conv -> channel LayerNorm -> ReLU -> dropout] x n, then a
    zero-initialised 1x1 projection added to the input, masked."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 kernel_size: int = 5, n_layers: int = 3, p_dropout: float = 0.5):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(in_channels if i == 0 else hidden_channels, hidden_channels,
                      kernel_size, padding=kernel_size // 2)
            for i in range(n_layers))
        self.norm_layers = nn.ModuleList(ChannelLayerNorm(hidden_channels)
                                         for _ in range(n_layers))
        self.drop = nn.Dropout(p_dropout)
        self.proj = ZeroConv1d(hidden_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C); x_mask: (B, T, 1) float valid mask."""
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = self.drop(torch.relu(norm(conv_same(conv, h * x_mask))))
        return (x + pointwise(self.proj, h)) * x_mask


def rope_rotate(x: torch.Tensor, rot_dims: int) -> torch.Tensor:
    """Rotary embedding on the first ``rot_dims`` dims of each head of x
    (B, H, T, D): theta repeated (not interleaved), the negative half
    first; positions 0 .. T-1 over the padded length."""
    T = x.shape[2]
    x_rope, x_pass = x[..., :rot_dims], x[..., rot_dims:]
    half = rot_dims // 2
    theta = torch.from_numpy(
        (1.0 / (10000.0 ** (np.arange(0, rot_dims, 2) / rot_dims))).astype(np.float32))
    pos = torch.arange(T, dtype=torch.float32)
    idx_theta = pos[:, None] * theta[None, :]
    idx_theta2 = torch.cat([idx_theta, idx_theta], dim=1).to(x.device)
    cos, sin = torch.cos(idx_theta2).to(x.dtype), torch.sin(idx_theta2).to(x.dtype)
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    return torch.cat([x_rope * cos + neg_half * sin, x_pass], dim=-1)


class RoPEMultiHeadAttention(nn.Module):
    """1x1-conv Q / K / V / O attention with rotary positions on half of
    each head's dims."""

    def __init__(self, channels: int, out_channels: int, n_heads: int, p_dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.channels = channels
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, c: (B, T, C); attn_mask (B, 1 | T, T), 1 where valid."""
        B, T, _ = x.shape
        H = self.n_heads
        D = self.channels // H

        def heads(z):
            return z.reshape(B, -1, H, D).transpose(1, 2)  # (B, H, T, D)

        rot = int(D * 0.5)
        q = rope_rotate(heads(pointwise(self.conv_q, x)), rot)
        k = rope_rotate(heads(pointwise(self.conv_k, c)), rot)
        v = heads(pointwise(self.conv_v, c))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[:, None] == 0, MASK_NEG)
        attn = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, self.channels)
        return pointwise(self.conv_o, out)


class MaskedConvFFN(nn.Module):
    """conv -> ReLU -> dropout -> conv, masked."""

    def __init__(self, in_channels: int, filter_channels: int, out_channels: int,
                 kernel_size: int = 3, p_dropout: float = 0.1):
        super().__init__()
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size,
                                padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size,
                                padding=kernel_size // 2)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        h = self.drop(torch.relu(conv_same(self.conv_1, x * x_mask)))
        return conv_same(self.conv_2, h * x_mask) * x_mask


class RoPEEncoder(nn.Module):
    """Post-norm RoPE transformer stack."""

    def __init__(self, hidden_channels: int, filter_channels: int = 768, n_heads: int = 2,
                 n_layers: int = 6, kernel_size: int = 3, p_dropout: float = 0.1):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.attn_layers = nn.ModuleList(
            RoPEMultiHeadAttention(hidden_channels, hidden_channels, n_heads, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(ChannelLayerNorm(hidden_channels)
                                           for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            MaskedConvFFN(hidden_channels, filter_channels, hidden_channels, kernel_size,
                          p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(ChannelLayerNorm(hidden_channels)
                                           for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C); x_mask: (B, T, 1)."""
        m = x_mask[..., 0]
        attn_mask = m[:, :, None] * m[:, None, :]  # (B, T, T) 1 where valid
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = x * x_mask
            x = norm1(x + self.drop(attn(x, x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


class TokenEmbedding(nn.Embedding):
    """The symbol embedding, seeded from N(0, dim^-1/2) as the reference
    initialises it."""

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                              * self.embedding_dim ** -0.5)


class TextEncoder(nn.Module):
    """Embedding (scaled by the square root of the post-concat width) ->
    prenet -> speaker concat (more than one speaker) -> RoPE encoder ->
    ``proj_m``: (mu (B, T, n_feats), the scaled embedding (B, T, hidden),
    valid mask (B, T))."""

    def __init__(self, n_vocab: int, n_feats: int, n_spks: int, spk_emb_dim: int,
                 encoder_params: Dict[str, Any]):
        super().__init__()
        p = encoder_params
        hidden = p["hidden_dim"]
        self.n_spks = n_spks
        self.hidden = hidden
        # the reference scales by the square root of the POST-concat width
        # (its hidden_dim is reassigned before forward reads it)
        self.scale_dim = hidden + (spk_emb_dim if n_spks > 1 else 0)
        self.src_word_emb = TokenEmbedding(n_vocab, hidden)
        self.prenet = None
        if p.get("use_prenet", True):
            pn = p["prenet"]
            self.prenet = ConvReluNorm(hidden, hidden, hidden, pn["kernel_size"],
                                       pn["n_layers"], pn["p_dropout"])
        enc = p["encoder"]
        self.encoder = RoPEEncoder(self.scale_dim, enc["filter_channels"], enc["n_heads"],
                                   enc["n_layers"], enc["kernel_size"], enc["p_dropout"])
        self.proj_m = nn.Conv1d(self.scale_dim, n_feats, 1)

    def forward(self, src_seq: torch.Tensor, src_lengths: torch.Tensor,
                sids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``sids`` is the speaker vector (B, spk_emb_dim)."""
        emb = self.src_word_emb(src_seq) * math.sqrt(self.scale_dim)
        T = src_seq.shape[1]
        valid = torch.arange(T, device=src_seq.device)[None, :] < src_lengths[:, None]
        x_mask = valid[..., None].to(emb.dtype)
        x = emb if self.prenet is None else self.prenet(emb, x_mask)
        if self.n_spks > 1 and sids is not None:
            x = torch.cat([x, sids[:, None, :].expand(-1, T, -1).to(x.dtype)], dim=-1)
        x = self.encoder(x, x_mask)
        return pointwise(self.proj_m, x) * x_mask, emb, valid
