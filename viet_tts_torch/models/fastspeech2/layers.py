"""FastSpeech2 layers the JETS slice needs: the GST ``ReferenceEncoder``.

Counterpart of ``viet_tts_tpu/models/fastspeech2/layers.py:ReferenceEncoder``
(espnet ``gst/style_encoder.py``). Parameter names follow espnet
(``convs.{3i}`` Conv2d, ``convs.{3i+1}`` BatchNorm2d, ``gru``), as
``train/torch_import.py:_gst_params`` reads them.

The BatchNorms follow flax's ``nn.BatchNorm`` (``FlaxBatchNorm2d``): in
training mode they normalise with the batch statistics and update the
running ones as 0.99 old + 0.01 batch, the variance biased, eps 1e-5.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax's ``nn.BatchNorm`` defaults
    (``use_running_average=not train``): running = 0.99 * running + 0.01 *
    batch, with the BIASED batch variance in the running variance (torch's
    module keeps the unbiased one and takes momentum 0.1), eps 1e-5. The
    parameter and buffer names are torch's, so the state_dict is unchanged;
    in eval mode it is torch's module."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


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
