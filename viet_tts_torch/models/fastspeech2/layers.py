"""FastSpeech2 layers: predictors, postnet, CVAE speaker / accent
conditioning and the GST ``ReferenceEncoder``.

Counterpart of ``viet_tts_tpu/models/fastspeech2/layers.py``
(``ConvReluNormStack``, ``DurationPredictor``, ``VariancePredictor``,
``AlignmentEncoder``, ``Postnet``, ``ReferenceEncoder``, ``CVAENet``,
``AccentEncoderNetwork``). Parameter names
follow the reference torch model (``models/tts/fastspeech2/layers.py``) as
``train/torch_import.py`` reads them: predictor convs ``conv.{i}.1`` with
their LayerNorm at ``conv.{i}.3``, postnet ``convolutions.{i}.0.conv`` and
``.1`` (BatchNorm), CVAE heads ``cvae.linear_model_{acc,spk}.0`` and
``cvae.{mu,logvar}_layer_{acc,spk}.linear``, aligner ``key_proj.{0,2}.conv``,
``query_proj.{0,2,4}.conv`` and ``{key,query}_spk_proj.linear`` (as
``_aligner_params`` reads them); the reference encoder's are
espnet's (``convs.{3i}`` Conv2d, ``convs.{3i+1}`` BatchNorm2d, ``gru``), as
``_gst_params`` / ``_accent_encoder_params`` read them. Activations are
(B, T, C).

The BatchNorms follow flax's ``nn.BatchNorm``: in training mode they
normalise with the batch statistics and update the running ones as 0.99 old
+ 0.01 batch, the variance biased, eps 1e-5; in eval mode they are torch's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from viet_tts_torch.nn.utils import ChannelLayerNorm


class _FlaxBatchNorm:
    """Training-mode forward of flax's ``nn.BatchNorm`` for torch's
    BatchNorm classes (channel axis 1): running = 0.99 * running + 0.01 *
    batch, with the BIASED batch variance in the running variance (torch's
    module keeps the unbiased one and takes momentum 0.1), eps 1e-5. The
    parameter and buffer names are torch's; in eval mode it is torch's
    module."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.dim()))
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """BatchNorm1d on (B, C, T) with flax's training semantics."""


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """BatchNorm2d on (B, C, H, W) with flax's training semantics."""


class LinearNorm(nn.Module):
    """A Linear under ``.linear`` (the reference's ``LinearNorm``)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.linear = nn.Linear(d_in, d_out, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class ConvNorm(nn.Module):
    """A Conv1d on (B, C, T) under ``.conv`` (the reference's
    ``ConvNorm``), 'SAME' padding for odd kernels."""

    def __init__(self, d_in: int, d_out: int, kernel_size: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(d_in, d_out, kernel_size, padding=(kernel_size - 1) // 2,
                              groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def fairseq_sinusoid_table(num_embeddings: int, dim: int, padding_idx: int = 0) -> np.ndarray:
    """fairseq's table: [sin | cos] halves, row ``padding_idx`` zeroed."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(math.log(10000.0) / (half - 1)))
    ang = np.arange(num_embeddings, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((num_embeddings, 1))], axis=1)
    emb[padding_idx] = 0.0
    return emb.astype(np.float32)


def fairseq_positions(ref: torch.Tensor, padding_idx: int = 0) -> torch.Tensor:
    """Position ids from a reference signal: entries that are not
    ``padding_idx`` numbered from padding_idx + 1, the others padding_idx."""
    mask = (ref != padding_idx).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class ConvReluNormStack(nn.ModuleList):
    """[Conv1d -> ReLU -> LayerNorm(eps 1e-12, over channels) -> Dropout] x
    n on (B, T, C), each layer's output zeroed at ``pad_mask``."""

    def __init__(self, in_chans: int, n_chans: int, n_layers: int, kernel_size: int,
                 dropout: float):
        super().__init__(
            nn.Sequential(
                nn.Identity(),
                nn.Conv1d(in_chans if i == 0 else n_chans, n_chans, kernel_size,
                          padding=(kernel_size - 1) // 2),
                nn.ReLU(),
                ChannelLayerNorm(n_chans, eps=1e-12),
                nn.Dropout(dropout),
            )
            for i in range(n_layers)
        )

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.transpose(1, 2)
        keep = None if pad_mask is None else (~pad_mask)[:, None, :].to(x.dtype)
        for layer in self:
            x = layer(x)
            if keep is not None:
                x = x * keep
        return x.transpose(1, 2)


class DurationPredictor(nn.Module):
    """Log-domain duration predictor: (B, T, C) -> (B, T), 0 at padding."""

    def __init__(self, in_chans: int, n_chans: int = 256, n_layers: int = 2,
                 kernel_size: int = 3, dropout: float = 0.5):
        super().__init__()
        self.conv = ConvReluNormStack(in_chans, n_chans, n_layers, kernel_size, dropout)
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.linear(self.conv(xs, pad_mask))[..., 0]
        return out if pad_mask is None else out * (~pad_mask).to(out.dtype)


class VariancePredictor(nn.Module):
    """Pitch / energy predictor: the input plus alpha times fairseq's
    position table at its own positions, then the conv stack (unmasked) and
    a linear head: (B, T, C) -> (B, T)."""

    def __init__(self, in_chans: int, n_chans: int = 256, n_layers: int = 2,
                 kernel_size: int = 5, dropout: float = 0.5):
        super().__init__()
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.register_buffer("table", torch.from_numpy(fairseq_sinusoid_table(4096, in_chans)),
                             persistent=False)
        self.conv = ConvReluNormStack(in_chans, n_chans, n_layers, kernel_size, dropout)
        self.linear = nn.Linear(n_chans, 1)

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_embed_alpha.fill_(1.0)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        table = self.table[fairseq_positions(xs[..., 0])].to(xs.dtype)
        xs = xs + self.pos_embed_alpha * table
        return self.linear(self.conv(xs))[..., 0]


class AlignmentEncoder(nn.Module):
    """One-TTS-Alignment text / mel aligner: key and query conv stacks,
    negative squared L2 distances scaled by ``temperature``, log-softmax
    over text plus the log of the beta-binomial prior.

    (queries (B, T_mel, n_mel), keys (B, T_text, c_text), text pad mask,
    prior (B, T_mel, T_text), speaker vector (B, spk_dim)) -> (soft
    attention (B, 1, T_mel, T_text), its unnormalised log (B, 1, T_mel,
    T_text)); padded text columns are -1e9 before the softmax."""

    def __init__(self, n_mel: int, c_text: int, n_att_channels: int, spk_dim: int,
                 temperature: float = 0.0005):
        super().__init__()
        self.temperature = temperature
        self.key_proj = nn.Sequential(ConvNorm(c_text, 2 * c_text, 3), nn.ReLU(),
                                      ConvNorm(2 * c_text, n_att_channels))
        self.query_proj = nn.Sequential(ConvNorm(n_mel, 2 * n_mel, 3), nn.ReLU(),
                                        ConvNorm(2 * n_mel, n_mel), nn.ReLU(),
                                        ConvNorm(n_mel, n_att_channels))
        self.key_spk_proj = LinearNorm(spk_dim, c_text)
        self.query_spk_proj = LinearNorm(spk_dim, n_mel)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                text_pad_mask: Optional[torch.Tensor], attn_prior: torch.Tensor,
                speaker_embed: Optional[torch.Tensor] = None):
        if speaker_embed is not None:
            keys = keys + self.key_spk_proj(speaker_embed)[:, None]
            queries = queries + self.query_spk_proj(speaker_embed)[:, None]
        k = self.key_proj(keys.transpose(1, 2)).transpose(1, 2)
        q = self.query_proj(queries.transpose(1, 2)).transpose(1, 2)
        sq = (q ** 2).sum(-1)[:, :, None]
        sk = (k ** 2).sum(-1)[:, None, :]
        attn = -self.temperature * (sq + sk - 2.0 * torch.einsum("bmc,btc->bmt", q, k))
        attn = torch.log_softmax(attn, dim=-1) + torch.log(attn_prior + 1e-8)
        attn_logprob = attn
        if text_pad_mask is not None:
            attn = attn.masked_fill(text_pad_mask[:, None, :], -1.0e9)
        return torch.softmax(attn, dim=-1)[:, None], attn_logprob[:, None]


class Postnet(nn.Module):
    """(conv_layers - 1) x [Conv1d + BatchNorm + tanh] + [Conv1d +
    BatchNorm] on (B, T, n_channels); the caller adds the residual."""

    def __init__(self, n_channels: int, embedding_dim: int = 512, conv_layers: int = 5,
                 kernel_size: int = 5):
        super().__init__()
        dims = [n_channels] + [embedding_dim] * (conv_layers - 1) + [n_channels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(dims[i], dims[i + 1], kernel_size),
                          FlaxBatchNorm1d(dims[i + 1]))
            for i in range(conv_layers)
        )
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        last = len(self.convolutions) - 1
        for i, layer in enumerate(self.convolutions):
            x = layer(x)
            x = self.dropout(x if i == last else torch.tanh(x))
        return x.transpose(1, 2)


class ReferenceEncoder(nn.Module):
    """Strided Conv2d + BatchNorm + ReLU stack, then a GRU over time:
    mel (B, T, idim) -> final hidden state (B, gru_units).

    BatchNorm: ``FlaxBatchNorm2d`` (batch statistics in training mode,
    running statistics in eval mode). The conv output
    (B, C, T', F') is flattened per frame in espnet's channel-major
    (C, F') order; the JAX module flattens (F', C) and
    ``torch_import._torch_gru_params`` permutes the GRU's input columns
    between the two. The GRU is torch's (gate order r, z, n), evaluated
    step by step from its own parameters so that it runs in any dtype; it
    equals flax's ``GRUCell`` with torch's hidden r/z biases folded into
    the input biases.
    """

    def __init__(self, idim: int = 80, conv_layers: int = 6,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_layers: int = 1, gru_units: int = 128):
        super().__init__()
        pad = (conv_kernel_size - 1) // 2
        convs = []
        f_dim = idim
        for i in range(conv_layers):
            cin = 1 if i == 0 else conv_chans_list[i - 1]
            convs += [
                nn.Conv2d(cin, conv_chans_list[i], conv_kernel_size,
                          stride=conv_stride, padding=pad, bias=False),
                FlaxBatchNorm2d(conv_chans_list[i]),
                nn.ReLU(),
            ]
            f_dim = (f_dim - conv_kernel_size + 2 * pad) // conv_stride + 1
        self.convs = nn.Sequential(*convs)
        self.gru = nn.GRU(conv_chans_list[-1] * f_dim, gru_units, gru_layers,
                          batch_first=True)

    def _gru(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        for layer in range(self.gru.num_layers):
            w_ih = getattr(self.gru, f"weight_ih_l{layer}")
            w_hh = getattr(self.gru, f"weight_hh_l{layer}")
            b_ih = getattr(self.gru, f"bias_ih_l{layer}")
            b_hh = getattr(self.gru, f"bias_hh_l{layer}")
            # flax's GRUCell has no hidden r/z biases: torch's take no
            # gradient, so training leaves them where the converter put them
            # (0) and out of the clipping norm, as the JAX step does
            H = self.gru.hidden_size
            b_hh = torch.cat([b_hh[: 2 * H].detach(), b_hh[2 * H:]])
            gi = nn.functional.linear(x, w_ih, b_ih)  # (B, T, 3H)
            h = x.new_zeros(B, self.gru.hidden_size)
            outs = []
            for t in range(T):
                gh = nn.functional.linear(h, w_hh, b_hh)
                i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
                h_r, h_z, h_n = gh.chunk(3, dim=-1)
                r = torch.sigmoid(i_r + h_r)
                z = torch.sigmoid(i_z + h_z)
                n = torch.tanh(i_n + r * h_n)
                h = (1.0 - z) * n + z * h
                outs.append(h)
            x = torch.stack(outs, dim=1)
        return x[:, -1]

    def forward(self, speech: torch.Tensor) -> torch.Tensor:
        x = self.convs(speech[:, None])  # (B, C, T', F')
        B, C, Tp, Fp = x.shape
        x = x.transpose(1, 2).reshape(B, Tp, C * Fp)
        return self._gru(x)


class CVAENet(nn.Module):
    """Conditional-VAE accent and speaker heads over the reference
    embedding: (z_acc, y_acc, z_spk, y_spk, (mu_acc, logvar_acc, mu_spk,
    logvar_spk)); z is the mean in eval mode and a reparameterised sample
    z = mu + eps exp(logvar / 2) in training mode, eps = (eps_acc, eps_spk)
    given, or drawn from ``generator`` (a CPU ``torch.Generator``; torch's
    default one when None)."""

    def __init__(self, n_accents: int, n_speakers: int, in_dim: int, y_dim: int = 10,
                 z_dim: int = 192):
        super().__init__()
        for tag, n in (("acc", n_accents), ("spk", n_speakers)):
            setattr(self, f"embedding_layer_{tag}", nn.Embedding(n, y_dim))
            setattr(self, f"linear_model_{tag}",
                    nn.Sequential(nn.Linear(in_dim + y_dim, 256), nn.Tanh()))
            setattr(self, f"mu_layer_{tag}", LinearNorm(256, z_dim))
            setattr(self, f"logvar_layer_{tag}", LinearNorm(256, z_dim))

    def _head(self, x: torch.Tensor, label: torch.Tensor, tag: str, eps, generator):
        y = getattr(self, f"embedding_layer_{tag}")(label)
        h = getattr(self, f"linear_model_{tag}")(torch.cat([x, y], dim=1))
        mu = getattr(self, f"mu_layer_{tag}")(h)
        logvar = getattr(self, f"logvar_layer_{tag}")(h)
        if not self.training:
            return mu, y, mu, logvar
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator)
        z = mu + eps.to(device=mu.device, dtype=mu.dtype) * torch.exp(0.5 * logvar)
        return z, y, mu, logvar

    def forward(self, x: torch.Tensor, label_acc: torch.Tensor, label_spk: torch.Tensor,
                eps=None, generator: Optional[torch.Generator] = None):
        eps_acc, eps_spk = (None, None) if eps is None else eps
        z_acc, y_acc, mu_acc, logvar_acc = self._head(x, label_acc, "acc", eps_acc, generator)
        z_spk, y_spk, mu_spk, logvar_spk = self._head(x, label_spk, "spk", eps_spk, generator)
        return z_acc, y_acc, z_spk, y_spk, (mu_acc, logvar_acc, mu_spk, logvar_spk)


class AccentEncoderNetwork(nn.Module):
    """``ReferenceEncoder`` (mel) -> ``CVAENet`` accent / speaker latents,
    each ``z_dim`` wide."""

    def __init__(self, n_speakers: int, n_accents: int, z_dim: int, idim: int = 80,
                 conv_layers: int = 6,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2, gru_layers: int = 1,
                 gru_units: int = 256):
        super().__init__()
        self.encoder = ReferenceEncoder(idim, conv_layers, conv_chans_list, conv_kernel_size,
                                        conv_stride, gru_layers, gru_units)
        self.cvae = CVAENet(n_accents, n_speakers, gru_units, 10, z_dim)

    def forward(self, speech: torch.Tensor, acc_labels: torch.Tensor,
                spk_labels: torch.Tensor, eps=None,
                generator: Optional[torch.Generator] = None):
        return self.cvae(self.encoder(speech), acc_labels, spk_labels, eps, generator)
