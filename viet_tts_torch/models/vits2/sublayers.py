"""VITS2 sublayers: the WaveNet stack, dilated depth-separable convs, the
flows and the generator's residual blocks.

Counterpart of ``viet_tts_tpu/models/vits2/sublayers.py``. Activations are
(B, T, C) with (B, T, 1) float masks, as in the JAX package; convolutions
run on a transposed view. Parameter names follow the reference torch model
(``in_layers.{i}``, ``res_skip_layers.{i}``, ``cond_layer``,
``convs_sep.{i}``, ``convs_1x1.{i}``, ``norms_1.{i}.gamma``, ``pre``,
``enc``, ``post``, ``proj``, ``m`` / ``logs``), as
``train/torch_import.py:import_vits2`` reads them. The WaveNet stack's and
the residual blocks' convs are weight-normalised as the JAX package's
(``WNConv1d``: the norm per output channel, ``weight_v`` / ``weight_g``).
The VITS LayerNorm stores ``gamma`` / ``beta`` and normalises the channel
axis with eps 1e-5, as the JAX module's ``nn.LayerNorm(epsilon=1e-5)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viet_tts_torch.models.hifigan.generator import WNConv1d
from viet_tts_torch.models.vits2.transforms import unconstrained_rational_quadratic_spline

LRELU_SLOPE = 0.1


def pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-1 ``Conv1d`` on channel-last x (B, T, C_in) -> (B, T, C_out)."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


def conv_same(conv: nn.Conv1d, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """A ``Conv1d`` (built with padding 0) on channel-last x, padded as
    flax's "SAME" (low (k - 1) d // 2, the rest high) or, ``causal``, all
    (k - 1) d on the left."""
    total = (conv.kernel_size[0] - 1) * conv.dilation[0]
    low = total if causal else total // 2
    y = F.pad(x.transpose(1, 2), (low, total - low))
    return F.conv1d(y, conv.weight, conv.bias, dilation=conv.dilation,
                    groups=conv.groups).transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis, parameters ``gamma`` /
    ``beta``."""

    def __init__(self, channels: int, eps: float = 1e-5):
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
    """A ``Conv1d`` whose seeded initialisation is all zeros (the flows'
    ``post`` / ``proj``, so that a fresh coupling is the identity)."""

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()
            self.bias.zero_()


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack: per layer a depthwise conv of
    dilation k^i, LayerNorm, GELU, a 1x1 conv, LayerNorm, GELU, dropout,
    residual."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.convs_sep = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, groups=channels,
                      dilation=kernel_size ** i) for i in range(n_layers))
        self.convs_1x1 = nn.ModuleList(nn.Conv1d(channels, channels, 1) for _ in range(n_layers))
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        """``train`` (default: the module's mode) switches the dropout."""
        train = self.training if train is None else train
        if g is not None:
            x = x + g
        for sep, c1, n1, n2 in zip(self.convs_sep, self.convs_1x1, self.norms_1, self.norms_2):
            y = F.gelu(n1(conv_same(sep, x * x_mask)))
            y = F.gelu(n2(pointwise(c1, y)))
            x = x + F.dropout(y, self.p_dropout, training=train)
        return x * x_mask


class WN(nn.Module):
    """WaveNet-style gated residual stack with the speaker vector added to
    every layer's gate input (one weight-normalised 1x1 conv, ``cond_layer``,
    for all layers)."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, p_dropout: float = 0.0):
        super().__init__()
        H = self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        self.gin_channels = gin_channels
        if gin_channels > 0:
            self.cond_layer = WNConv1d(gin_channels, 2 * H * n_layers, 1)
        self.in_layers = nn.ModuleList(
            WNConv1d(H, 2 * H, kernel_size, dilation=dilation_rate ** i) for i in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            WNConv1d(H, 2 * H if i < n_layers - 1 else H, 1) for i in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, H), x_mask (B, T, 1), g (B, gin) or None -> (B, T, H)."""
        H = self.hidden_channels
        x = x.transpose(1, 2)
        mask = x_mask.transpose(1, 2)
        output = torch.zeros_like(x)
        g_all = None
        if g is not None and self.gin_channels > 0:
            g_all = self.cond_layer(g[:, :, None])  # (B, 2HL, 1)
        for i, (conv_in, res_skip) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = conv_in(x)
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * H: (i + 1) * 2 * H]
            acts = torch.tanh(x_in[:, :H]) * torch.sigmoid(x_in[:, H:])
            acts = F.dropout(acts, self.p_dropout, training=self.training)
            rs = res_skip(acts)
            if i < self.n_layers - 1:
                x = (x + rs[:, :H]) * mask
                output = output + rs[:, H:]
            else:
                output = output + rs
        return (output * mask).transpose(1, 2)


class ResBlock1(nn.Module):
    """(dilated conv, conv) residual pairs on (B, C, T), LeakyReLU 0.1
    before each conv."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(WNConv1d(channels, channels, kernel_size, dilation=d)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(WNConv1d(channels, channels, kernel_size)
                                    for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = x + xt
        return x


class ResBlock2(nn.Module):
    """Dilated-conv residuals on (B, C, T), LeakyReLU 0.1 before each."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(WNConv1d(channels, channels, kernel_size, dilation=d)
                                   for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


# ---------------------------------------------------------------------------
# flows: forward(x (B, T, C), x_mask (B, T, 1), g, reverse) -> (y, logdet (B,))
# forward, y reverse
# ---------------------------------------------------------------------------

class LogFlow(nn.Module):
    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class Flip(nn.Module):
    """Reverses the channel order (its own inverse)."""

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x = torch.flip(x, dims=(-1,))
        if not reverse:
            return x, x.new_zeros(x.shape[0])
        return x


class ElementwiseAffine(nn.Module):
    """y = m + exp(logs) x per channel; ``m`` / ``logs`` (C, 1) as in the
    reference, zero at init."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.m.zero_()
            self.logs.zero_()

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        m, logs = self.m[:, 0], self.logs[:, 0]
        if not reverse:
            y = (m + torch.exp(logs) * x) * x_mask
            return y, torch.sum(logs * x_mask, dim=(1, 2))
        return (x - m) * torch.exp(-logs) * x_mask


def affine_coupling(x0, x1, stats, x_mask, mean_only: bool, reverse: bool):
    """The half-coupling shared by the WaveNet and transformer flows: x1
    shifted (and scaled, unless ``mean_only``) by ``stats``; x0 passes."""
    if mean_only:
        m, logs = stats, torch.zeros_like(stats)
    else:
        m, logs = torch.chunk(stats, 2, dim=-1)
    if not reverse:
        x1 = (m + x1 * torch.exp(logs)) * x_mask
        return torch.cat([x0, x1], dim=-1), torch.sum(logs, dim=(1, 2))
    x1 = (x1 - m) * torch.exp(-logs) * x_mask
    return torch.cat([x0, x1], dim=-1)


class ResidualCouplingLayer(nn.Module):
    """WaveNet affine coupling: stats of x1 from the first half x0."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        self.half = channels // 2
        self.mean_only = mean_only
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = ZeroConv1d(hidden_channels, self.half * (2 - int(mean_only)), 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = pointwise(self.pre, x0) * x_mask
        h = self.enc(h, x_mask, g)
        stats = pointwise(self.post, h) * x_mask
        return affine_coupling(x0, x1, stats, x_mask, self.mean_only, reverse)


class ConvFlow(nn.Module):
    """Rational-quadratic spline coupling: the spline's bins for x1 from a
    DDSConv of x0 (and the conditioning g)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = nn.Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = ZeroConv1d(filter_channels, self.half * (num_bins * 3 - 1), 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        nb = self.num_bins
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.convs(pointwise(self.pre, x0), x_mask, g=g)
        h = pointwise(self.proj, h) * x_mask
        B, T, _ = x0.shape
        h = h.reshape(B, T, self.half, 3 * nb - 1)
        scale = self.filter_channels ** 0.5
        y1, logabsdet = unconstrained_rational_quadratic_spline(
            x1, h[..., :nb] / scale, h[..., nb: 2 * nb] / scale, h[..., 2 * nb:],
            inverse=reverse, tail_bound=self.tail_bound)
        y = torch.cat([x0, y1], dim=-1) * x_mask
        if not reverse:
            return y, torch.sum(logabsdet * x_mask, dim=(1, 2))
        return y
