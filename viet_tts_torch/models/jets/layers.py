"""JETS sub-modules: GST style encoder, alignment module, espnet predictors.

Counterpart of ``viet_tts_tpu/models/jets/layers.py``. Parameter names
follow espnet's torch modules, as ``train/torch_import.py:import_jets``
reads them. Activations are (B, T, C) at every public function. Dropout
layers sit where the flax modules have them and act in ``.train()`` mode.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from viet_tts_torch.models.fastspeech2.layers import ReferenceEncoder
from viet_tts_torch.nn.espnet_transformer import LN_EPS
from viet_tts_torch.nn.utils import ChannelLayerNorm


class _GSTAttention(nn.Module):
    """espnet MultiHeadedAttention with distinct q/k/v input widths."""

    def __init__(self, q_dim: int, k_dim: int, n_feat: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.linear_q = nn.Linear(q_dim, n_feat)
        self.linear_k = nn.Linear(k_dim, n_feat)
        self.linear_v = nn.Linear(k_dim, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def forward(self, query: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        B, Tq, _ = query.shape
        Tk = keys.shape[1]
        H = self.n_head
        q = self.linear_q(query).view(B, Tq, H, -1)
        k = self.linear_k(keys).view(B, Tk, H, -1)
        v = self.linear_v(keys).view(B, Tk, H, -1)
        D = q.shape[-1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Tq, H * D)
        return self.linear_out(ctx)


class StyleTokenLayer(nn.Module):
    """Attention over learned style tokens (espnet StyleTokenLayer)."""

    def __init__(self, ref_embed_dim: int = 128, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4):
        super().__init__()
        self.gst_embs = nn.Parameter(
            torch.zeros(gst_tokens, gst_token_dim // gst_heads)
        )
        self.mha = _GSTAttention(ref_embed_dim, gst_token_dim // gst_heads,
                                 gst_token_dim, gst_heads)

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gst_embs.copy_(torch.randn(self.gst_embs.shape,
                                            generator=generator))

    def forward(self, ref_embs: torch.Tensor) -> torch.Tensor:
        """ref_embs (B, ref_embed_dim) -> style embedding (B, gst_token_dim)."""
        B = ref_embs.shape[0]
        keys = torch.tanh(self.gst_embs)[None].expand(B, -1, -1)
        return self.mha(ref_embs[:, None], keys)[:, 0]


class StyleEncoder(nn.Module):
    """ReferenceEncoder(mel) + StyleTokenLayer -> global style vector."""

    def __init__(self, idim: int = 80, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4,
                 conv_layers: int = 6,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_layers: int = 1, gru_units: int = 128):
        super().__init__()
        self.ref_enc = ReferenceEncoder(idim, conv_layers, conv_chans_list,
                                        conv_kernel_size, conv_stride,
                                        gru_layers, gru_units)
        self.stl = StyleTokenLayer(gru_units, gst_tokens, gst_token_dim,
                                   gst_heads)

    def forward(self, speech: torch.Tensor) -> torch.Tensor:
        return self.stl(self.ref_enc(speech))


class AlignmentModule(nn.Module):
    """Learned text/mel alignment scores (JETS ``alignments.py``): log-softmax
    over text of -||feat_t - text_s||2, (B, T_feats, T_text). Only the
    training forward uses it; the inference graph holds its weights."""

    def __init__(self, adim: int, odim: int):
        super().__init__()
        self.t_conv1 = nn.Conv1d(adim, adim, 3, padding=1)
        self.t_conv2 = nn.Conv1d(adim, adim, 1)
        self.f_conv1 = nn.Conv1d(odim, adim, 3, padding=1)
        self.f_conv2 = nn.Conv1d(adim, adim, 3, padding=1)
        self.f_conv3 = nn.Conv1d(adim, adim, 1)

    def forward(self, text: torch.Tensor, feats: torch.Tensor,
                text_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = torch.relu(self.t_conv1(text.transpose(1, 2)))
        t = self.t_conv2(t).transpose(1, 2)  # (B, T_text, adim)
        f = torch.relu(self.f_conv1(feats.transpose(1, 2)))
        f = torch.relu(self.f_conv2(f))
        f = self.f_conv3(f).transpose(1, 2)  # (B, T_feats, adim)
        sq_f = (f ** 2).sum(-1)[:, :, None]
        sq_t = (t ** 2).sum(-1)[:, None, :]
        dist2 = torch.clamp(
            sq_f + sq_t - 2.0 * torch.einsum("bmc,bsc->bms", f, t), min=0.0
        )
        score = -torch.sqrt(dist2 + 1e-12)
        if text_pad_mask is not None:
            score = score.masked_fill(text_pad_mask[:, None, :], -1.0e9)
        return torch.log_softmax(score, dim=-1)


def _conv_relu_norm_stack(idim: int, n_layers: int, n_chans: int,
                          kernel_size: int, dropout: float) -> nn.ModuleList:
    """espnet predictor stack ``conv.{i}`` = (Conv1d, ReLU, LayerNorm,
    Dropout) on (B, C, T)."""
    return nn.ModuleList(
        nn.Sequential(
            nn.Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size,
                      padding=(kernel_size - 1) // 2),
            nn.ReLU(),
            ChannelLayerNorm(n_chans, eps=LN_EPS),
            nn.Dropout(dropout),
        )
        for i in range(n_layers)
    )


class EspnetDurationPredictor(nn.Module):
    """Log-domain duration predictor; masks applied only at the output."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 256,
                 kernel_size: int = 3, dropout: float = 0.1,
                 offset: float = 1.0):
        super().__init__()
        self.offset = offset
        self.conv = _conv_relu_norm_stack(idim, n_layers, n_chans, kernel_size,
                                          dropout)
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                is_inference: bool = False) -> torch.Tensor:
        h = xs.transpose(1, 2)
        for f in self.conv:
            h = f(h)
        out = self.linear(h.transpose(1, 2))[..., 0]
        if is_inference:
            out = torch.clamp(torch.round(torch.exp(out) - self.offset), min=0.0)
        if pad_mask is not None:
            out = out * (~pad_mask)
        return out


class EspnetVariancePredictor(nn.Module):
    """Pitch/energy predictor (espnet fastspeech2 VariancePredictor)."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 256,
                 kernel_size: int = 3, dropout: float = 0.5, odim: int = 1):
        super().__init__()
        self.conv = _conv_relu_norm_stack(idim, n_layers, n_chans, kernel_size,
                                          dropout)
        self.linear = nn.Linear(n_chans, odim)

    def forward(self, xs: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = xs.transpose(1, 2)
        for f in self.conv:
            h = f(h)
        out = self.linear(h.transpose(1, 2))  # (B, T, odim)
        if pad_mask is not None:
            out = out * (~pad_mask)[..., None]
        return out


class VarianceEmbed(nn.Sequential):
    """Continuous-value conv embedding for pitch/energy: ``0`` = Conv1d(1,
    adim, k), ``1`` = dropout."""

    def __init__(self, adim: int, kernel_size: int = 1, dropout: float = 0.0):
        super().__init__(
            nn.Conv1d(1, adim, kernel_size, padding=(kernel_size - 1) // 2),
            nn.Dropout(dropout),
        )

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """v: (B, T, 1) -> (B, T, adim)."""
        return self[1](self[0](v.transpose(1, 2)).transpose(1, 2))
