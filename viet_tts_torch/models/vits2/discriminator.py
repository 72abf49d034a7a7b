"""VITS2 discriminators: the multi-period discriminator (one scale
discriminator and periods 2, 3, 5, 7, 11) and the duration discriminator.

Counterpart of ``viet_tts_tpu/models/vits2/discriminator.py``. Waveforms
come in as (B, T, 1) and each discriminator returns (feature maps, logits
(B, -1)); ``MultiPeriodDiscriminator`` returns (real logits, fake logits,
real maps, fake maps) per discriminator, running the real and the fake
waveform as one batch. Feature maps are channel-first ((B, C, T') and
(B, C, T'/P, P)); the losses take means, which do not see the layout.
The convs are weight-normalised as flax's ``WeightNorm`` (the norm per
output channel) and pad as the JAX module's: the scale discriminator's by
flax's "SAME" rule (asymmetric for the strided layers), the period
discriminators' (k - 1) / 2 on the time axis. The JAX package has no
importer for these, so the names are the reference's (``convs.{i}``,
``conv_post``, ``discriminators.{i}``; the duration discriminator's
``conv_1`` ... ``output_layer.0``) and ``convert.vits2_mpd_from_jax`` /
``duration_discriminator_from_jax`` map flax's onto them.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viet_tts_torch.models.hifigan.discriminator import WNConv, _same_pad
from viet_tts_torch.models.vits2.sublayers import LayerNorm, conv_same, pointwise

LRELU_SLOPE = 0.1


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform folded to (T / P, P), five (k, 1)
    convs (stride 3 but the last) to 1024 channels, a (3, 1) conv_post."""

    CHANNELS = (32, 128, 512, 1024, 1024)

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        self.pad = (kernel_size - 1) // 2
        chans = (1,) + self.CHANNELS
        self.convs = nn.ModuleList(
            WNConv(chans[i], chans[i + 1], (kernel_size, 1), (stride if i < 4 else 1, 1))
            for i in range(len(self.CHANNELS)))
        self.conv_post = WNConv(chans[-1], 1, (3, 1), (1, 1))

    def forward(self, x: torch.Tensor):
        x = x.transpose(1, 2)  # (B, 1, T)
        B, C, T = x.shape
        if T % self.period != 0:
            n_pad = self.period - (T % self.period)
            x = F.pad(x, (0, n_pad), mode="reflect")
            T += n_pad
        x = x.reshape(B, C, T // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x, (0, 0, self.pad, self.pad)), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, (0, 0, 1, 1))
        fmap.append(x)
        return fmap, x.reshape(B, -1)


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided convs to 1024 channels,
    "SAME"-padded as flax pads them."""

    SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16), (1024, 41, 4, 64),
             (1024, 41, 4, 256), (1024, 5, 1, 1))

    def __init__(self):
        super().__init__()
        convs, in_ch = [], 1
        for ch, k, s, g in self.SPECS:
            convs.append(WNConv(in_ch, ch, (k,), (s,), groups=math.gcd(g, math.gcd(in_ch, ch))))
            in_ch = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv(in_ch, 1, (3,), (1,))

    def forward(self, x: torch.Tensor):
        h = x.transpose(1, 2)  # (B, 1, T)
        fmap = []
        for conv in self.convs:
            k, s = conv.effective_weight().shape[-1], conv.stride[0]
            h = F.leaky_relu(conv(h, _same_pad(h.shape[-1], k, s)), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h, (1, 1))
        fmap.append(h)
        return fmap, h.reshape(h.shape[0], -1)


class MultiPeriodDiscriminator(nn.Module):
    """The scale discriminator and one period discriminator a period."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat (B, T, 1) -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs)."""
        B = y.shape[0]
        both = torch.cat([y, y_hat], dim=0)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            fmap, logits = d(both)
            y_d_rs.append(logits[:B])
            y_d_gs.append(logits[B:])
            fmap_rs.append([f[:B] for f in fmap])
            fmap_gs.append([f[B:] for f in fmap])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class DurationDiscriminator(nn.Module):
    """The duration discriminator: the detached text encoding through two
    convs, then for each of the real and the predicted log-durations a 1x1
    projection concatenated to it, two convs and a sigmoid. ``dur_disc_1``
    leaves the trunk's activations and norms out (the reference comments
    them out); ``dur_disc_2`` applies them (LayerNorm eps 1e-6, flax's
    default)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 3,
                 p_dropout: float = 0.1, variant: str = "dur_disc_1"):
        super().__init__()
        self.v2 = variant == "dur_disc_2"
        fc = filter_channels
        self.conv_1 = nn.Conv1d(in_channels, fc, kernel_size)
        self.conv_2 = nn.Conv1d(fc, fc, kernel_size)
        self.dur_proj = nn.Conv1d(1, fc, 1)
        self.pre_out_conv_1 = nn.Conv1d(2 * fc, fc, kernel_size)
        self.pre_out_conv_2 = nn.Conv1d(fc, fc, kernel_size)
        if self.v2:
            self.norm_1 = LayerNorm(fc, eps=1e-6)
            self.norm_2 = LayerNorm(fc, eps=1e-6)
            self.pre_out_norm_1 = LayerNorm(fc, eps=1e-6)
            self.pre_out_norm_2 = LayerNorm(fc, eps=1e-6)
        self.output_layer = nn.Sequential(nn.Linear(fc, 1), nn.Sigmoid())

    def forward(self, x, x_mask, dur_r, dur_hat) -> List[torch.Tensor]:
        """x (B, T, C) (detached here), x_mask (B, T, 1), dur_* (B, T, 1)
        log-durations -> [prob_real, prob_fake], each (B, T, 1)."""
        h = conv_same(self.conv_1, x.detach() * x_mask)
        if self.v2:
            h = self.norm_1(torch.relu(h))
        h = conv_same(self.conv_2, h * x_mask)
        if self.v2:
            h = self.norm_2(torch.relu(h))
        probs = []
        for dur in (dur_r, dur_hat):
            z = torch.cat([h, pointwise(self.dur_proj, dur)], dim=-1)
            z = conv_same(self.pre_out_conv_1, z * x_mask)
            if self.v2:
                z = self.pre_out_norm_1(torch.relu(z))
            z = conv_same(self.pre_out_conv_2, z * x_mask)
            if self.v2:
                z = self.pre_out_norm_2(torch.relu(z))
            probs.append(self.output_layer(z * x_mask))
        return probs
