"""Fused HiFi-GAN multi-receptive-field (MRF) stage: kernel K2 and its plain
version.

Counterpart of ``viet_tts_tpu/ops/pallas_vocoder.py:fused_mrf_stage`` (TPU
kernel ``_make_kernel`` / ``_conv_tap_packed``), with its signature and its
(B, T, C) layout. One stage: for each block (kernel k) and each dilation d,
``h += conv_{k,1}(leaky(conv_{k,d}(leaky(h))))`` with zeros re-imposed
outside ``[0, seq_len)`` after every conv; the output is the mean of the
blocks' ``h``. Inference only.

- ``fused_mrf_stage_plain``: the layer-by-layer PyTorch version.
- ``fused_mrf_stage``: the hand-written Hopper kernel
  (``csrc/fused_mrf.cu``) for CUDA tensors; the plain version for CPU
  tensors only. There is no fallback from one to the other.

Kernel note (full text in the .cu source): the TPU kernel keeps a
1144-row time tile and all 18 convs' weights (2 MB at C=64) resident in
VMEM; a Hopper block has 227 KB of shared memory, so here each (block,
dilation) pair is one launch: a block stages a halo'd window of
``leaky(input)`` in shared memory, runs conv1 on it as an implicit GEMM on
the tensor cores (``mma.sync`` TF32, 3xTF32 for fp32), keeps conv1's
output tile (with its conv2 halo) in shared memory and runs conv2 on it;
the epilogue fuses bias, the sequence mask, the residual add and the
running block mean. A stage is 9 launches on two ping-pong (B, T, C) fp32
scratches. The weights are split into TF32 hi / lo and packed in the
kernel's fragment order here (``pack_weights``), once a call. The stage
does 252*B*T*C^2 FLOP at the default MRF and is bound by operations.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from viet_tts_torch.runtime import kernels

KERNEL_CHANNELS = (16, 32, 64)  # channel counts csrc/fused_mrf.cu is built for


def tile_rows(C: int) -> int:
    """Rows of a K2 block's conv1 tile (``mrf_tile`` in csrc/fused_mrf.cu):
    eight warps of 16 * (128 / C) rows. A block owns ``tile_rows(C) -
    2 * ((k - 1) // 2)`` output rows of a pair with kernel size k."""
    return 16384 // C


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(..., C_in, C_out) conv taps -> K2's packed hi / lo B fragments.

    Each fp32 weight is split into two TF32 values, w = hi + lo (hi: w
    rounded to nearest, ties away, on the bit pattern; lo: the rest with its
    13 low bits cleared, as ``split_tf32`` in csrc/xl_mma.cuh does), and
    each (C_in, C_out) tap is laid out as (C_in / 8, C_out / 8, 32, 4): for
    k-step ks, n-tile nt and lane (g, t) = (lane // 4, lane % 4) the four
    floats hi, hi, lo, lo of rows 8 ks + 2t, 8 ks + 2t + 1 at column
    8 nt + g, one m16n8k8 B fragment a 16-byte load."""
    *lead, ci, co = w.shape
    w = w.to(torch.float32).contiguous()
    hi = ((w.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((w - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    # [.., ks, t, j, nt, g, hl] -> [.., ks, nt, g, t, hl, j]
    p = torch.stack([x.reshape(*lead, ci // 8, 4, 2, co // 8, 8) for x in (hi, lo)], -1)
    n = len(lead)
    p = p.permute(*range(n), n, n + 3, n + 4, n + 1, n + 5, n + 2)
    return p.reshape(*lead, ci // 8, co // 8, 32, 4).contiguous()


def stage_halo(kernel_sizes: Sequence[int],
               dilations: Sequence[Sequence[int]]) -> int:
    """Max one-sided receptive-field growth across a block's conv chain."""
    halos = []
    for k, dils in zip(kernel_sizes, dilations):
        halos.append(sum((k - 1) // 2 * d + (k - 1) // 2 for d in dils))
    return max(halos)


def stage_flops(B: int, T: int, C: int, kernel_sizes: Sequence[int],
                dilations: Sequence[Sequence[int]]) -> int:
    """Multiply-adds x 2 of one stage: two k-tap C->C convs per (block,
    dilation); 252*B*T*C^2 at the default (3, 7, 11) x (1, 3, 5) MRF."""
    taps = sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))
    return 2 * taps * B * T * C * C


def _torch_weight(w: torch.Tensor) -> torch.Tensor:
    """(k, C_in, C_out) flax layout -> (C_out, C_in, k) torch layout."""
    return w.permute(2, 1, 0)


def fused_mrf_stage_plain(
    x: torch.Tensor,
    seq_len: int,
    w1s: Tuple[torch.Tensor, ...],
    b1s: Tuple[torch.Tensor, ...],
    w2s: Tuple[torch.Tensor, ...],
    b2s: Tuple[torch.Tensor, ...],
    kernel_sizes: Tuple[int, ...] = (3, 7, 11),
    dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3,
    lrelu: float = 0.1,
) -> torch.Tensor:
    """Layer-by-layer stage in fp32 with ``F.conv1d``; same arguments as
    ``fused_mrf_stage``."""
    B, T, C = x.shape
    valid = (torch.arange(T, device=x.device) < int(seq_len))[None, None, :]
    x0 = x.float().transpose(1, 2) * valid  # (B, C, T)
    acc = torch.zeros_like(x0)
    for blk, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        h = x0
        for di, d in enumerate(dils):
            a = F.leaky_relu(h, lrelu)
            y = F.conv1d(a, _torch_weight(w1s[blk][di].float()),
                         b1s[blk][di].float(), padding=(k - 1) // 2 * d,
                         dilation=d) * valid
            a2 = F.leaky_relu(y, lrelu)
            y2 = F.conv1d(a2, _torch_weight(w2s[blk][di].float()),
                          b2s[blk][di].float(), padding=(k - 1) // 2) * valid
            h = h + y2
        acc = acc + h
    return (acc / len(kernel_sizes)).transpose(1, 2).to(x.dtype)


def fused_mrf_stage(
    x: torch.Tensor,
    seq_len: int,
    w1s: Tuple[torch.Tensor, ...],
    b1s: Tuple[torch.Tensor, ...],
    w2s: Tuple[torch.Tensor, ...],
    b2s: Tuple[torch.Tensor, ...],
    kernel_sizes: Tuple[int, ...] = (3, 7, 11),
    dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3,
    lrelu: float = 0.1,
    tile: int = 2048,
) -> torch.Tensor:
    """Fused MRF stage: kernel K2 on CUDA tensors, the plain version on CPU
    tensors.

    Args:
        x: (B, T, C) stage input, fp32 or bf16.
        seq_len: true sequence length (zero-padding boundary; T for a fully
            valid input).
        w1s/b1s/w2s/b2s: per block, stacked effective (weight-normed) conv
            params of shapes (n_d, k, C, C) [tap, in, out] / (n_d, C); w1
            dilated, w2 dilation 1.
        tile: kept for the JAX signature; the Hopper kernel's time tile is
            fixed by C (``tile_rows``: 256 rows at C=64, 512 at C=32).

    Returns (B, T, C) in x's dtype.
    """
    del tile
    if x.device.type == "cpu":
        return fused_mrf_stage_plain(x, seq_len, w1s, b1s, w2s, b2s,
                                     kernel_sizes, dilations, lrelu)
    if x.device.type != "cuda":
        raise ValueError(f"fused MRF runs on cuda or cpu, not {x.device}")
    B, T, C = x.shape
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"fused MRF kernel built for C in {KERNEL_CHANNELS}, got {C}")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError("fused MRF needs odd kernel sizes")
    seq_len = min(int(seq_len), T)
    # the kernel computes in fp32 throughout (as the TPU kernel does); a bf16
    # stage input is widened here and the output narrowed back
    src0 = x.to(torch.float32).contiguous()
    # h ping-pongs between two scratches: a block reads a halo of its pair's
    # input that neighbouring blocks of the same launch write
    hbuf = (torch.empty_like(src0), torch.empty_like(src0))
    out = torch.empty_like(src0)
    lib = kernels.library("fused_mrf")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    n_blocks = len(kernel_sizes)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    for blk, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        n_d = len(dils)
        params = (w1s[blk], w2s[blk], b1s[blk], b2s[blk])
        if (w1s[blk].shape != (n_d, k, C, C) or w2s[blk].shape != (n_d, k, C, C)
                or b1s[blk].shape != (n_d, C) or b2s[blk].shape != (n_d, C)
                or any(t.device != x.device for t in params)):
            raise ValueError(f"block {blk}: conv weights must be ({n_d}, {k}, {C}, {C}) "
                             f"and biases ({n_d}, {C}), on {x.device}")
        # per dilation: conv1's k taps, then conv2's
        wp = pack_weights(torch.cat([w1s[blk], w2s[blk]], dim=1))
        b1 = b1s[blk].to(torch.float32).contiguous()
        b2 = b2s[blk].to(torch.float32).contiguous()
        src = src0
        for di, d in enumerate(dils):
            last = di == n_d - 1
            # h = mask(h + conv_{k,1}(leaky(mask(conv_{k,d}(leaky(h)))))); the
            # block's last h goes straight into the running mean over blocks
            hout = None if last else hbuf[di % 2]
            accout = out if last else None
            accin = out if (last and blk > 0) else None
            acc_div = float(n_blocks) if (last and blk == n_blocks - 1) else 1.0
            err = lib.vt_mrf_pair(
                src.data_ptr(), wp[di].data_ptr(), b1[di].data_ptr(), b2[di].data_ptr(),
                ptr(hout), ptr(accin), ptr(accout), acc_div, B, T, C, seq_len, k, d,
                float(lrelu), stream,
            )
            kernels.check(lib, err, "fused MRF pair kernel")
            fused_mrf_stage.launches += 1
            src = hout
    return out.to(x.dtype)


fused_mrf_stage.launches = 0
