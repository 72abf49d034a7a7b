"""VITS2 components: the text and posterior encoders, the generator, the
duration predictors and the transformer coupling flows.

Counterpart of ``viet_tts_tpu/models/vits2/layers.py``. Activations are
(B, T, C) with (B, T, 1) masks, as in the JAX package (the generator takes
(B, T, C) latents and returns (B, T * 256, 1)). Every random draw comes from
an explicit CPU ``torch.Generator`` and is moved to the activations' device
(so a card and the CPU draw the same numbers), or is given: the posterior's
noise (``eps``), the SDP's posterior noise (``e_q``) and its reverse noise
(``noise``). Parameter names follow the reference torch model as
``train/torch_import.py:import_vits2`` reads them (``emb``, ``encoder``,
``proj``; ``pre``, ``enc``; ``conv_pre``, ``ups.{i}``,
``resblocks.{i * n + j}``, ``conv_post``, ``cond``; ``flows.{i}``,
``post_flows.{i}``, ``post_pre``, ...). The JAX generator's ``packed_tail``
(a TPU lane layout whose output equals the plain convs) has no counterpart.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viet_tts_torch.models.hifigan.generator import WNConvTranspose1d
from viet_tts_torch.models.vits2.attentions import CausalFFT, VitsEncoder
from viet_tts_torch.models.vits2.sublayers import (
    WN,
    ConvFlow,
    DDSConv,
    ElementwiseAffine,
    Flip,
    LayerNorm,
    LogFlow,
    ResBlock1,
    ResBlock2,
    ResidualCouplingLayer,
    ZeroConv1d,
    affine_coupling,
    conv_same,
    pointwise,
)
from viet_tts_torch.nn.utils import valid_mask_from_lengths


def normal_draw(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) of ``shape`` drawn on the CPU from ``generator``, on
    ``like``'s device and dtype."""
    return torch.randn(shape, generator=generator).to(device=like.device, dtype=like.dtype)


def float_mask(lengths: torch.Tensor, T: int, like: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) float valid mask."""
    return valid_mask_from_lengths(lengths.to(like.device), T)[..., None].to(like.dtype)


class TextEncoder(nn.Module):
    """Phoneme embedding (scaled by sqrt(hidden)) -> relative-position
    encoder -> the prior's (m, logs)."""

    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int, kernel_size: int,
                 p_dropout: float, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.gin_channels = gin_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.encoder = VitsEncoder(hidden_channels, filter_channels, n_heads, n_layers,
                                   kernel_size, p_dropout, gin_channels=gin_channels)
        self.proj = nn.Conv1d(hidden_channels, out_channels * 2, 1)

    def seeded_init_(self, generator: torch.Generator) -> None:
        """The embedding ~ N(0, hidden^-1/2), as the JAX module's init."""
        with torch.no_grad():
            self.emb.weight.copy_(torch.randn(self.emb.weight.shape, generator=generator)
                                  * self.hidden_channels ** -0.5)

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None):
        """-> (x (B, T, H), m, logs (B, T, out), x_mask (B, T, 1))."""
        x = self.emb(text) * math.sqrt(self.hidden_channels)
        x_mask = float_mask(text_lengths, text.shape[1], x)
        x = self.encoder(x * x_mask, x_mask, g=g if self.gin_channels > 0 else None)
        m, logs = torch.chunk(pointwise(self.proj, x) * x_mask, 2, dim=-1)
        return x, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """Mel (B, T, in) -> WaveNet -> z = m + eps exp(logs), masked."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0):
        super().__init__()
        self.pre = nn.Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = nn.Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """-> (z, m, logs (B, T, out), x_mask (B, T, 1)); ``eps`` given
        instead of drawn from ``generator``."""
        x_mask = float_mask(x_lengths, x.shape[1], x)
        h = self.enc(pointwise(self.pre, x) * x_mask, x_mask, g)
        m, logs = torch.chunk(pointwise(self.proj, h) * x_mask, 2, dim=-1)
        if eps is None:
            eps = normal_draw(m.shape, m, generator)
        z = (m + eps.to(m) * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask


class VitsGenerator(nn.Module):
    """HiFi-GAN-style latent-to-waveform decoder: conv_pre (k 7) plus the
    speaker's 1x1 ``cond``, then per stage LeakyReLU 0.1, a weight-normalised
    transposed conv and the mean of the residual blocks; LeakyReLU 0.01,
    conv_post (k 7, no bias), tanh."""

    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 gin_channels: int = 0):
        super().__init__()
        self.gin_channels = gin_channels
        self.n_kernels = len(resblock_kernel_sizes)
        self.upsample_factor = math.prod(upsample_rates)
        self.conv_pre = nn.Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        if gin_channels > 0:
            self.cond = nn.Conv1d(gin_channels, upsample_initial_channel, 1)
        res = ResBlock1 if str(resblock) == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(ch * 2, ch, k, stride=u, padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, C) latents -> (B, T * up, 1)."""
        h = self.conv_pre(x.transpose(1, 2))
        if g is not None and self.gin_channels > 0:
            h = h + self.cond(g[:, :, None])
        n = self.n_kernels
        for i, up in enumerate(self.ups):
            h = up(F.leaky_relu(h, 0.1))
            acc = self.resblocks[i * n](h)
            for j in range(1, n):
                acc = acc + self.resblocks[i * n + j](h)
            h = acc / n
        h = self.conv_post(F.leaky_relu(h, 0.01))
        return torch.tanh(h).transpose(1, 2)


class VitsDurationPredictor(nn.Module):
    """Deterministic log-duration predictor (two conv / ReLU / LayerNorm /
    dropout layers, a 1x1 projection) on the detached text encoding."""

    def __init__(self, in_channels: int, filter_channels: int = 256, kernel_size: int = 3,
                 p_dropout: float = 0.5, gin_channels: int = 0):
        super().__init__()
        self.p_dropout = p_dropout
        self.gin_channels = gin_channels
        if gin_channels > 0:
            self.cond = nn.Conv1d(gin_channels, in_channels, 1)
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, x_mask, g=None):
        x = x.detach()
        if g is not None and self.gin_channels > 0:
            x = x + pointwise(self.cond, g.detach()[:, None, :])
        h = self.norm_1(torch.relu(conv_same(self.conv_1, x * x_mask)))
        h = F.dropout(h, self.p_dropout, training=self.training)
        h = self.norm_2(torch.relu(conv_same(self.conv_2, h * x_mask)))
        h = F.dropout(h, self.p_dropout, training=self.training)
        return pointwise(self.proj, h * x_mask) * x_mask


def _sdp_flows(fc: int, kernel_size: int, n_flows: int) -> nn.ModuleList:
    flows = [ElementwiseAffine(2)]
    for _ in range(n_flows):
        flows += [ConvFlow(2, fc, kernel_size, n_layers=3), Flip()]
    return nn.ModuleList(flows)


class StochasticDurationPredictor(nn.Module):
    """Spline-flow duration predictor: ``forward`` gives the per-utterance
    NLL bound (B,) of durations w, ``reverse`` samples log-durations
    (B, T, 1). Its width is ``in_channels`` (the reference overrides
    ``filter_channels``)."""

    def __init__(self, in_channels: int, filter_channels: int = 192, kernel_size: int = 3,
                 p_dropout: float = 0.5, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        fc = in_channels
        self.gin_channels = gin_channels
        self.log_flow = LogFlow()
        self.flows = _sdp_flows(fc, kernel_size, n_flows)
        self.post_pre = nn.Conv1d(1, fc, 1)
        self.post_proj = nn.Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, 3, p_dropout)
        self.post_flows = _sdp_flows(fc, kernel_size, n_flows)
        self.pre = nn.Conv1d(in_channels, fc, 1)
        self.proj = nn.Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, 3, p_dropout)
        if gin_channels > 0:
            self.cond = nn.Conv1d(gin_channels, fc, 1)

    def _condition(self, x, x_mask, g, train: bool):
        x = pointwise(self.pre, x.detach())
        if g is not None and self.gin_channels > 0:
            x = x + pointwise(self.cond, g.detach()[:, None, :])
        x = self.convs(x, torch.ones_like(x[..., :1]), train=train)
        return pointwise(self.proj, x) * x_mask

    def forward(self, x, x_mask, w, g=None, generator: Optional[torch.Generator] = None,
                e_q: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The NLL + log q (B,) of durations w (B, T, 1); the posterior noise
        ``e_q`` (B, T, 2) given instead of drawn from ``generator``."""
        x = self._condition(x, x_mask, g, self.training)
        h_w = self.post_convs(pointwise(self.post_pre, w), x_mask)
        h_w = pointwise(self.post_proj, h_w) * x_mask
        if e_q is None:
            e_q = normal_draw((*w.shape[:2], 2), w, generator)
        e_q = e_q.to(w) * x_mask
        z_q, logdet_tot_q = e_q, 0.0
        for flow in self.post_flows:
            z_q, logdet_q = flow(z_q, x_mask, g=x + h_w)
            logdet_tot_q = logdet_tot_q + logdet_q
        z_u, z1 = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_tot_q = logdet_tot_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        logq = (torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * x_mask, dim=(1, 2))
                - logdet_tot_q)
        z0, logdet_tot = self.log_flow(z0, x_mask)
        z = torch.cat([z0, z1], dim=-1)
        for flow in self.flows:
            z, logdet = flow(z, x_mask, g=x)
            logdet_tot = logdet_tot + logdet
        nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask, dim=(1, 2)) - logdet_tot
        return nll + logq

    def reverse(self, x, x_mask, g=None, noise_scale: float = 1.0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Log-durations (B, T, 1) from noise (B, T, 2) times ``noise_scale``
        (``noise`` given instead of drawn; no draw at scale 0). The
        conditioning runs without dropout whatever the mode, as in the JAX
        module; the first ConvFlow is unused, as in the reference."""
        x = self._condition(x, x_mask, g, False)
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]
        shape = (*x.shape[:2], 2)
        if noise is not None:
            z = noise.to(x) * noise_scale
        elif noise_scale == 0.0:
            z = x.new_zeros(shape)
        else:
            z = normal_draw(shape, x, generator) * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=True)
        return z[..., :1]


class ResidualCouplingTransformersLayer(nn.Module):
    """``pre_conv``: a 2-layer transformer (window none, dropout 0.1) on x0
    added to x0 before the WaveNet coupling."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        half = self.half = channels // 2
        self.mean_only = mean_only
        self.pre_transformer = VitsEncoder(half, half, n_heads=2, n_layers=2, kernel_size=3,
                                           p_dropout=0.1, window_size=None)
        self.pre = nn.Conv1d(half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = ZeroConv1d(hidden_channels, half * (2 - int(mean_only)), 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        x0_ = self.pre_transformer(x0 * x_mask, x_mask) + x0
        h = self.enc(pointwise(self.pre, x0_) * x_mask, x_mask, g)
        stats = pointwise(self.post, h) * x_mask
        return affine_coupling(x0, x1, stats, x_mask, self.mean_only, reverse)


class ResidualCouplingTransformersLayer2(nn.Module):
    """``pre_conv2``: a 1-layer transformer (window 4, dropout 0) residual
    between the pre projection and the WaveNet coupling."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        half = self.half = channels // 2
        self.mean_only = mean_only
        self.pre = nn.Conv1d(half, hidden_channels, 1)
        self.pre_transformer = VitsEncoder(hidden_channels, hidden_channels, n_heads=2,
                                           n_layers=1, kernel_size=kernel_size, p_dropout=0.0)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = ZeroConv1d(hidden_channels, half * (2 - int(mean_only)), 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = pointwise(self.pre, x0) * x_mask
        h = h + self.pre_transformer(h * x_mask, x_mask)
        h = self.enc(h, x_mask, g)
        stats = pointwise(self.post, h) * x_mask
        return affine_coupling(x0, x1, stats, x_mask, self.mean_only, reverse)


class FFTransformerCouplingLayer(nn.Module):
    """``fft``: a causal FFT stack as the coupling network."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, n_layers: int,
                 n_heads: int, filter_channels: int = 768, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        half = self.half = channels // 2
        self.mean_only = mean_only
        self.pre = nn.Conv1d(half, hidden_channels, 1)
        self.enc = CausalFFT(hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                             gin_channels=gin_channels)
        self.post = ZeroConv1d(hidden_channels, half * (2 - int(mean_only)), 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = pointwise(self.pre, x0) * x_mask
        h = self.enc(h, x_mask, g=g) + h
        stats = pointwise(self.post, h) * x_mask
        return affine_coupling(x0, x1, stats, x_mask, self.mean_only, reverse)


class MonoTransformerFlowLayer(nn.Module):
    """``mono_layer_*``: a transformer-only half-coupling, with the VITS2
    residual connection for ``mono_layer_post_residual``. Its reverse
    divides by 1 + exp(-logs) where the exact inverse would use 1 + exp(logs)
    (and feeds x0 unmasked), as the reference computes it."""

    def __init__(self, channels: int, hidden_channels: int, mean_only: bool = True,
                 residual_connection: bool = False):
        super().__init__()
        half = self.half = channels // 2
        self.mean_only = mean_only
        self.residual_connection = residual_connection
        self.pre_transformer = VitsEncoder(half, half, n_heads=2, n_layers=2, kernel_size=3,
                                           p_dropout=0.1, window_size=None)
        self.post = ZeroConv1d(half, half * (2 - int(mean_only)), 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        if self.residual_connection and reverse:
            x0 = x0 / 2.0
        if self.residual_connection:
            h = self.pre_transformer(x0, x_mask)
        else:
            h = self.pre_transformer(x0 * x_mask, x_mask) + x0
        stats = pointwise(self.post, h) * x_mask
        if not self.residual_connection:
            return affine_coupling(x0, x1, stats, x_mask, self.mean_only, reverse)
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = torch.chunk(stats, 2, dim=-1)
        if not reverse:
            x1_ = (m + x1 * torch.exp(logs)) * x_mask
            out = x + torch.cat([x0, x1_], dim=-1)
            logdet = torch.sum(torch.log(torch.exp(logs) + 1.0), dim=(1, 2))
            return out, logdet + math.log(2.0) * (x0.shape[1] * x0.shape[2])
        x1 = (x1 - m) / (1.0 + torch.exp(-logs)) * x_mask
        return torch.cat([x0, x1], dim=-1)


FLOW_TYPES = ("pre_conv", "pre_conv2", "fft", "mono_layer_inter_residual",
              "mono_layer_post_residual")


class ResidualCouplingTransformersBlock(nn.Module):
    """``n_flows`` x (coupling layer, Flip[, mono transformer layer]) of
    ``transformer_flow_type`` ("none" when ``use_transformer_flows`` is
    off: plain WaveNet couplings)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 4, n_flows: int = 4,
                 gin_channels: int = 0, use_transformer_flows: bool = True,
                 transformer_flow_type: str = "pre_conv"):
        super().__init__()
        ftype = transformer_flow_type if use_transformer_flows else "none"
        if use_transformer_flows and ftype not in FLOW_TYPES:
            raise ValueError(f"transformer_flow_type must be one of {FLOW_TYPES}, got {ftype!r}")
        mono = ftype in ("mono_layer_inter_residual", "mono_layer_post_residual")
        args = (channels, hidden_channels, kernel_size, dilation_rate, n_layers)
        flows = []
        for _ in range(n_flows):
            if ftype == "pre_conv":
                flows.append(ResidualCouplingTransformersLayer(*args, gin_channels=gin_channels))
            elif ftype == "pre_conv2":
                flows.append(ResidualCouplingTransformersLayer2(*args, gin_channels=gin_channels))
            elif ftype == "fft":
                # the reference passes dilation_rate / n_layers into the
                # (n_layers, n_heads) slots by position, as the JAX block keeps
                flows.append(FFTransformerCouplingLayer(
                    channels, hidden_channels, kernel_size, n_layers=dilation_rate,
                    n_heads=n_layers, gin_channels=gin_channels))
            else:
                flows.append(ResidualCouplingLayer(*args, gin_channels=gin_channels))
            flows.append(Flip())
            if mono:
                flows.append(MonoTransformerFlowLayer(
                    channels, hidden_channels,
                    residual_connection=ftype == "mono_layer_post_residual"))
        self.flows = nn.ModuleList(flows)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            for flow in self.flows:
                x, _ = flow(x, x_mask, g=g)
            return x
        for flow in reversed(self.flows):
            x = flow(x, x_mask, g=g, reverse=True)
        return x
