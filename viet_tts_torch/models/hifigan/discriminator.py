"""HiFi-GAN discriminators: multi-scale (MSD) + multi-period (MPD).

Counterpart of ``viet_tts_tpu/models/hifigan/discriminator.py``. Each
discriminator returns its list of per-layer feature maps (final logits
last); ``MultiScaleMultiPeriodDiscriminator`` returns msd + mpd as one list
of lists, the structure the GAN losses take. The input waveform is
(B, T, 1) and the feature maps are feature-last, as in the JAX package:
(B, T', C) for a scale discriminator, (B, T'/P, P, C) for a period one
(its final logits flattened to (B, T'/P * P)).

Parameter names follow the reference's espnet torch modules
(``msd.discriminators.{s}.layers.{l}(.0)``,
``mpd.discriminators.{i}.convs.{l}.0`` and ``.output_conv``), with weight
norm stored as ``weight_v`` / ``weight_g``, so
``train/torch_import.py:import_msmpd_discriminator`` reads the state_dict.
Weight norm is flax's: w = g * v / sqrt(||v||^2 + 1e-12) per output
channel. The scale discriminator's convs pad as flax's ``"SAME"`` does
(asymmetric for the strided layers), as the JAX module does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_INIT_STD = 0.01  # official HiFi-GAN init


def espnet_disc_kw(kw: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """espnet-style discriminator params (the config's
    ``*_discriminator_params`` blocks) -> this module's keyword arguments;
    unsupported non-default options raise."""
    kw = dict(kw or {})
    kw.pop("in_channels", None)  # implied by the input tensor
    act = kw.pop("nonlinear_activation", "LeakyReLU")
    if act != "LeakyReLU":
        raise ValueError(f"unsupported discriminator activation: {act!r}")
    act_params = kw.pop("nonlinear_activation_params", None) or {}
    if "negative_slope" in act_params:
        kw.setdefault("lrelu_slope", act_params["negative_slope"])
    if kw.pop("use_spectral_norm", False):
        raise ValueError("use_spectral_norm=True is not supported (the shipped "
                         "configs use weight norm)")
    if not kw.pop("bias", True):
        raise ValueError("bias=False is not supported")
    return kw


class WNConv(nn.Module):
    """Weight-normalised Conv1d / Conv2d with explicit padding:
    ``weight_v`` (out, in/groups, *k), ``weight_g`` (out, 1, ...), bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, ...], stride: Tuple[int, ...],
                 groups: int = 1, use_weight_norm: bool = True):
        super().__init__()
        self.dims = len(kernel_size)
        self.stride = stride
        self.groups = groups
        self.use_weight_norm = use_weight_norm
        shape = (out_channels, in_channels // groups, *kernel_size)
        if use_weight_norm:
            self.weight_v = nn.Parameter(torch.zeros(shape))
            self.weight_g = nn.Parameter(torch.ones(out_channels, *([1] * (len(shape) - 1))))
        else:
            self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            v = torch.randn(self.effective_weight().shape,
                            generator=generator) * _INIT_STD
            if self.use_weight_norm:
                self.weight_v.copy_(v)
                self.weight_g.copy_(v.flatten(1).norm(dim=1).view_as(self.weight_g))
            else:
                self.weight.copy_(v)
            self.bias.zero_()

    def effective_weight(self) -> torch.Tensor:
        if not self.use_weight_norm:
            return self.weight
        v = self.weight_v
        dims = tuple(range(1, v.dim()))
        return self.weight_g * v * torch.rsqrt((v * v).sum(dim=dims, keepdim=True) + 1e-12)

    def forward(self, x: torch.Tensor, padding: Sequence[int]) -> torch.Tensor:
        """``padding``: F.pad's list (last axis first, low then high)."""
        x = F.pad(x, list(padding))
        conv = F.conv1d if self.dims == 1 else F.conv2d
        return conv(x, self.effective_weight(), self.bias, stride=self.stride,
                    groups=self.groups)


def _same_pad(length: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding (low, high) of one axis."""
    out = -(-length // s)
    total = max((out - 1) * s + k - length, 0)
    return total // 2, total - total // 2


class _ConvAct(nn.Sequential):
    """``Sequential(conv, LeakyReLU)`` so the conv sits at ``.0`` as in the
    reference."""

    def __init__(self, conv: WNConv, slope: float):
        super().__init__(conv, nn.LeakyReLU(slope))


class ScaleDiscriminator(nn.Module):
    """1-D grouped-conv stack: (B, 1, T) -> feature maps (B, C, T')."""

    def __init__(self, out_channels: int = 1,
                 kernel_sizes: Sequence[int] = (15, 41, 5, 3),
                 channels: int = 128, max_downsample_channels: int = 1024,
                 max_groups: int = 16,
                 downsample_scales: Sequence[int] = (2, 2, 4, 4, 1),
                 lrelu_slope: float = 0.1, use_weight_norm: bool = True):
        super().__init__()
        wn = use_weight_norm
        layers = [_ConvAct(WNConv(1, channels, (kernel_sizes[0],), (1,),
                                  use_weight_norm=wn), lrelu_slope)]
        self.geometry = [(kernel_sizes[0], 1)]
        in_ch = out_ch = channels
        groups = 4
        for scale in downsample_scales:
            g = math.gcd(groups, math.gcd(in_ch, out_ch))
            layers.append(_ConvAct(WNConv(in_ch, out_ch, (kernel_sizes[1],),
                                          (scale,), g, wn), lrelu_slope))
            self.geometry.append((kernel_sizes[1], scale))
            in_ch = out_ch
            out_ch = min(in_ch * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_ch = min(in_ch * 2, max_downsample_channels)
        layers.append(_ConvAct(WNConv(in_ch, out_ch, (kernel_sizes[2],), (1,),
                                      use_weight_norm=wn), lrelu_slope))
        self.geometry.append((kernel_sizes[2], 1))
        layers.append(WNConv(out_ch, out_channels, (kernel_sizes[3],), (1,),
                             use_weight_norm=wn))
        self.geometry.append((kernel_sizes[3], 1))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for layer, (k, s) in zip(self.layers, self.geometry):
            pad = _same_pad(x.shape[-1], k, s)
            if isinstance(layer, _ConvAct):
                x = layer[1](layer[0](x, pad))
            else:
                x = layer(x, pad)
            outs.append(x)
        return outs


class PeriodDiscriminator(nn.Module):
    """Waveform folded to (T/P, P), strided 2-D convs over the first axis:
    (B, 1, T) -> feature maps (B, C, T'/P, P), final logits flattened."""

    def __init__(self, period: int = 3, out_channels: int = 1,
                 kernel_sizes: Sequence[int] = (5, 3), channels: int = 32,
                 downsample_scales: Sequence[int] = (3, 3, 3, 3, 1),
                 max_downsample_channels: int = 1024,
                 lrelu_slope: float = 0.1, use_weight_norm: bool = True):
        super().__init__()
        self.period = period
        self.kernel_sizes = tuple(kernel_sizes)
        wn = use_weight_norm
        k = kernel_sizes[0]
        convs, cin, cout = [], 1, channels
        for scale in downsample_scales:
            convs.append(_ConvAct(WNConv(cin, cout, (k, 1), (scale, 1),
                                         use_weight_norm=wn), lrelu_slope))
            cin, cout = cout, min(cout * 4, max_downsample_channels)
        self.convs = nn.ModuleList(convs)
        self.output_conv = WNConv(cin, out_channels, (kernel_sizes[1] - 1, 1),
                                  (1, 1), use_weight_norm=wn)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B, C, T = x.shape
        if T % self.period:
            n_pad = self.period - T % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            T += n_pad
        x = x.view(B, C, T // self.period, self.period)
        outs = []
        p = (self.kernel_sizes[0] - 1) // 2
        for layer in self.convs:
            x = layer[1](layer[0](x, (0, 0, p, p)))
            outs.append(x)
        p = (self.kernel_sizes[1] - 1) // 2
        x = self.output_conv(x, (0, 0, p, p))
        outs.append(x.reshape(B, -1))
        return outs


class _Group(nn.Module):
    def __init__(self, discriminators: Sequence[nn.Module]):
        super().__init__()
        self.discriminators = nn.ModuleList(discriminators)


class MultiScaleMultiPeriodDiscriminator(nn.Module):
    """MSD + MPD. Input waveform (B, T, 1); returns, per discriminator, the
    list of its feature maps, feature-last (see the module docstring)."""

    def __init__(self, scales: int = 1,
                 scale_params: Optional[Dict[str, Any]] = None,
                 periods: Sequence[int] = (2, 3, 5, 7, 11),
                 period_params: Optional[Dict[str, Any]] = None,
                 pool_kernel: int = 4, pool_stride: int = 2,
                 pool_padding: int = 2):
        super().__init__()
        self.pool = (pool_kernel, pool_stride, pool_padding)
        skw, pkw = espnet_disc_kw(scale_params), espnet_disc_kw(period_params)
        self.msd = _Group([ScaleDiscriminator(**skw) for _ in range(scales)])
        self.mpd = _Group([PeriodDiscriminator(period=p, **pkw) for p in periods])

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        x = x.transpose(1, 2)  # (B, 1, T)
        outs = []
        h = x
        n_scales = len(self.msd.discriminators)
        for disc in self.msd.discriminators:
            outs.append([o.transpose(1, 2) for o in disc(h)])
            if n_scales > 1:
                k, s, p = self.pool
                h = F.avg_pool1d(h, k, s, p, count_include_pad=True)
        for disc in self.mpd.discriminators:
            maps = disc(x)
            outs.append([o.permute(0, 2, 3, 1) for o in maps[:-1]] + [maps[-1]])
        return outs
