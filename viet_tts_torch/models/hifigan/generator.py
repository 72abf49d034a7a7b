"""HiFi-GAN V1 generator (weight-normalised convs), with the fused MRF path.

Counterpart of ``viet_tts_tpu/models/hifigan/generator.py``: input conv ->
4x [LeakyReLU(0.1) -> ConvTranspose up x (8, 8, 2, 2) -> mean of 3
multi-kernel / multi-dilation residual blocks] -> LeakyReLU(0.01) -> conv ->
tanh; total upsample x256. Parameter names follow the reference
(``input_conv``, ``upsamples.{i}.1``, ``blocks.{i*n+j}.convs1.{d}.1``,
``output_conv.1``), as ``train/torch_import.py:import_hifigan_generator``
reads them.

Weight norm is flax's ``WeightNorm``: ``w = g * v / sqrt(||v||^2 + 1e-12)``
with the norm taken per OUTPUT channel, for the transposed convs too.
``fused_mrf=True`` routes each stage whose weights fit
(``_fused_stage_fits``: ch <= 64 at the default MRF) to kernel K2
(``ops/fused_mrf.py``); the other stages, the transposed convs and the
input / output convs stay PyTorch ops.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viet_tts_torch.ops.fused_mrf import fused_mrf_stage

_INIT_STD = 0.01  # official HiFi-GAN init


class WNConv1d(nn.Module):
    """Weight-normalised 1-D conv on (B, C, T), 'SAME' padding for odd k:
    ``weight_v`` (out, in, k), ``weight_g`` (out, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, use_weight_norm: bool = True,
                 bias: bool = True):
        super().__init__()
        self.dilation = dilation
        self.padding = (kernel_size - 1) // 2 * dilation
        self.use_weight_norm = use_weight_norm
        shape = (out_channels, in_channels, kernel_size)
        if use_weight_norm:
            self.weight_v = nn.Parameter(torch.zeros(shape))
            self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
        else:
            self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            v = torch.randn(self.effective_weight().shape,
                            generator=generator) * _INIT_STD
            if self.use_weight_norm:
                # flax WeightNorm's scale init: unit norm per output channel
                self.weight_v.copy_(v)
                self.weight_g.fill_(1.0)
            else:
                self.weight.copy_(v)
            if self.bias is not None:
                self.bias.zero_()

    def effective_weight(self) -> torch.Tensor:
        if not self.use_weight_norm:
            return self.weight
        v = self.weight_v
        return self.weight_g * v * torch.rsqrt(
            (v * v).sum(dim=(1, 2), keepdim=True) + 1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.effective_weight(), self.bias,
                        padding=self.padding, dilation=self.dilation)


class WNConvTranspose1d(nn.Module):
    """Weight-normalised transposed conv (torch ConvTranspose1d geometry):
    ``weight_v`` (in, out, k), ``weight_g`` (1, out, 1), norm per output
    channel as in the JAX module."""

    transposed = True  # weight laid out (in, out, k), as torch's _ConvNd says

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int, output_padding: int = 0,
                 use_weight_norm: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.use_weight_norm = use_weight_norm
        shape = (in_channels, out_channels, kernel_size)
        if use_weight_norm:
            self.weight_v = nn.Parameter(torch.zeros(shape))
            self.weight_g = nn.Parameter(torch.ones(1, out_channels, 1))
        else:
            self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            v = torch.randn(self.effective_weight().shape,
                            generator=generator) * _INIT_STD
            if self.use_weight_norm:
                # the JAX module's kernel_g init: g = ||v||, so w = v
                self.weight_v.copy_(v)
                self.weight_g.copy_(v.norm(dim=(0, 2), keepdim=True))
            else:
                self.weight.copy_(v)
            self.bias.zero_()

    def effective_weight(self) -> torch.Tensor:
        if not self.use_weight_norm:
            return self.weight
        v = self.weight_v
        return self.weight_g * v * torch.rsqrt(
            (v * v).sum(dim=(0, 2), keepdim=True) + 1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.effective_weight(), self.bias,
                                  stride=self.stride, padding=self.padding,
                                  output_padding=self.output_padding)


class _Act(nn.Module):
    """LeakyReLU slot so the conv after it sits at index ``.1`` as in the
    reference's ``Sequential(LeakyReLU, Conv)``."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.slope)


class ResidualBlock(nn.Module):
    """Multi-dilation residual pairs on (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5),
                 use_additional_convs: bool = True, lrelu_slope: float = 0.1,
                 use_weight_norm: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.use_additional_convs = use_additional_convs
        self.convs1 = nn.ModuleList(
            nn.Sequential(_Act(lrelu_slope),
                          WNConv1d(channels, channels, kernel_size, d,
                                   use_weight_norm))
            for d in self.dilations
        )
        if use_additional_convs:
            self.convs2 = nn.ModuleList(
                nn.Sequential(_Act(lrelu_slope),
                              WNConv1d(channels, channels, kernel_size, 1,
                                       use_weight_norm))
                for _ in self.dilations
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dilations)):
            xt = self.convs1[i](x)
            if self.use_additional_convs:
                xt = self.convs2[i](xt)
            x = x + xt
        return x


class HiFiGANGenerator(nn.Module):
    """mel (B, T, in_channels) -> waveform (B, T*256, out_channels).

    ``packed_tail`` and ``grouped_mrf`` are the JAX package's TPU lane-fill
    layouts, whose outputs equal the plain path; they are accepted and have
    no effect here."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, global_channels: int = -1,
                 kernel_size: int = 7,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 use_additional_convs: bool = True, lrelu_slope: float = 0.1,
                 use_weight_norm: bool = True, fused_mrf: bool = False,
                 packed_tail: bool = False, grouped_mrf: bool = False):
        super().__init__()
        del packed_tail, grouped_mrf
        self.out_channels = out_channels
        self.upsample_scales = tuple(upsample_scales)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(map(tuple, resblock_dilations))
        self.use_additional_convs = use_additional_convs
        self.lrelu_slope = lrelu_slope
        self.fused_mrf = fused_mrf
        wn = use_weight_norm
        self.input_conv = WNConv1d(in_channels, channels, kernel_size,
                                   use_weight_norm=wn)
        self.global_conv = (WNConv1d(global_channels, channels, 1,
                                     use_weight_norm=wn)
                            if global_channels > 0 else None)
        self.upsamples = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for i, (scale, up_k) in enumerate(zip(upsample_scales,
                                              upsample_kernel_sizes)):
            cin = channels // (2 ** i)
            ch = channels // (2 ** (i + 1))
            self.upsamples.append(nn.Sequential(
                _Act(lrelu_slope),
                WNConvTranspose1d(cin, ch, up_k, scale,
                                  padding=scale // 2 + scale % 2,
                                  output_padding=scale % 2,
                                  use_weight_norm=wn),
            ))
            for rk, rd in zip(self.resblock_kernel_sizes,
                              self.resblock_dilations):
                self.blocks.append(ResidualBlock(ch, rk, rd,
                                                 use_additional_convs,
                                                 lrelu_slope, wn))
        self.output_conv = nn.Sequential(
            _Act(0.01),  # the reference uses the default slope here
            WNConv1d(channels // (2 ** len(upsample_scales)), out_channels,
                     kernel_size, use_weight_norm=wn),
            nn.Tanh(),
        )

    @classmethod
    def from_config(cls, in_channels: int, hifi: dict,
                    fused_mrf: bool = False) -> "HiFiGANGenerator":
        """V1 from a ``models.hifigan`` config section, with the JAX
        ``Text2Wav`` / two-stage API's defaults for what it leaves out and
        no speaker input."""
        return cls(
            in_channels=in_channels,
            channels=hifi.get("upsample_initial_channel", 512),
            upsample_scales=tuple(hifi.get("upsample_rates", (8, 8, 2, 2))),
            upsample_kernel_sizes=tuple(hifi.get("upsample_kernel_sizes", (16, 16, 4, 4))),
            resblock_kernel_sizes=tuple(hifi.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilations=tuple(map(tuple, hifi.get("resblock_dilation_sizes",
                                                         ((1, 3, 5),) * 3))),
            fused_mrf=fused_mrf)

    @property
    def upsample_factor(self) -> int:
        f = self.out_channels
        for s in self.upsample_scales:
            f *= s
        return f

    def _fused_stage_fits(self, ch: int) -> bool:
        """The JAX package's rule for which stages take the fused kernel:
        18 convs x k_avg x ch^2 fp32 weights under 4 MB (ch <= 64 at the
        default MRF)."""
        n_convs = sum((2 if self.use_additional_convs else 1) * len(d)
                      for d in self.resblock_dilations)
        k_avg = sum(self.resblock_kernel_sizes) / len(self.resblock_kernel_sizes)
        return n_convs * k_avg * ch * ch * 4 < 4e6

    def _fused_stage(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Stage i's residual trio through K2, on (B, C, T). K2 has no
        backward (nor has the JAX package's fused stage): raise rather than
        run without gradients when autograd would need one."""
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                "fused_mrf (kernel K2) is inference-only and has no backward: "
                "turn fused_mrf off for training, or run under torch.no_grad()")
        n = len(self.resblock_kernel_sizes)
        w1s, b1s, w2s, b2s = [], [], [], []
        for j in range(n):
            blk = self.blocks[i * n + j]
            # (n_d, k, C_in, C_out): the kernel's flax-style tap layout
            w1s.append(torch.stack([c[1].effective_weight().permute(2, 1, 0)
                                    for c in blk.convs1]))
            b1s.append(torch.stack([c[1].bias for c in blk.convs1]))
            w2s.append(torch.stack([c[1].effective_weight().permute(2, 1, 0)
                                    for c in blk.convs2]))
            b2s.append(torch.stack([c[1].bias for c in blk.convs2]))
        y = fused_mrf_stage(
            x.transpose(1, 2), x.shape[2], tuple(w1s), tuple(b1s), tuple(w2s),
            tuple(b2s), kernel_sizes=self.resblock_kernel_sizes,
            dilations=self.resblock_dilations, lrelu=self.lrelu_slope,
        )
        return y.transpose(1, 2)

    def forward(self, c: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.input_conv(c.transpose(1, 2))  # (B, C, T)
        if g is not None and self.global_conv is not None:
            x = x + self.global_conv(g[:, :, None])
        n = len(self.resblock_kernel_sizes)
        for i, up in enumerate(self.upsamples):
            x = up(x)
            ch = x.shape[1]
            if (self.fused_mrf and self.use_additional_convs
                    and self._fused_stage_fits(ch)):
                x = self._fused_stage(x, i)
            else:
                acc = 0.0
                for j in range(n):
                    acc = acc + self.blocks[i * n + j](x)
                x = acc / n
        return self.output_conv(x).transpose(1, 2)
