"""Why kernel K2 (the fused MRF stage, ``viet_tts_torch/csrc/fused_mrf.cu``)
multiplies in 3xTF32, and a check of its tiling, both without the card.

- The products: every conv of the stage emulated as unfold @ weight with
  its operands rounded as the kernel rounds them (``tf32`` / ``tf32_trunc``
  from ``test_torch_xl_bwd_precision``), at the two fused widths of
  HiFi-GAN V1 (C = 64 and 32), a small T, a ragged ``seq_len`` and the
  weight scales ``chip_smoke.py`` draws: 3xTF32 in every conv holds the
  port's fp32 limit of 1e-4 against ``fused_mrf_stage_plain``, one TF32
  product misses it.
- The weight packing: ``pack_weights`` puts each tap's TF32 hi / lo split
  where the kernel's B-fragment load reads it.
- The tiling: a PyTorch emulation of the kernel's blocks (a block owns
  ``tile_rows(C) - 2 * pad2`` output rows; it stages a window of
  ``tile_rows(C) + 2 * pad1`` input rows zeroed outside [0, seq_len),
  forms conv1's y on ``tile_rows(C)`` rows with its own mask, reads conv2's
  taps from y and, past y, the stale window rows the kernel leaves there,
  and keeps conv2's first rows) equals the plain stage, with ``seq_len``
  inside a tile, on a tile edge, at 1 and at T, and T not a multiple of
  the tile. The kernel itself cannot run here; this holds its index
  arithmetic. Channels are cut to 8 there: the arithmetic does not depend
  on C, only on the tile's rows, which are C = 64's and C = 32's.

No JAX: the emulations and the plain version are all the port's. One torch
thread.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_xl_bwd_precision import mm_3xtf32, mm_fp32, mm_tf32, tf32, tf32_trunc
from viet_tts_torch.ops import fused_mrf as fm

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
SLOPE = 0.1
TOL = 1e-4  # K2's fp32 limit against its plain version


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _weights(C, seed):
    """Per block (n_d, k, C, C) taps and (n_d, C) biases at chip_smoke.py's
    scales (std 1 / sqrt(k C), biases 0.1)."""
    rng = np.random.RandomState(seed)
    out = ([], [], [], [])
    for k, d in zip(KS, DILS):
        std = 1.0 / np.sqrt(k * C)
        for i, shape in enumerate([(len(d), k, C, C), (len(d), C)] * 2):
            scale = std if len(shape) == 4 else 0.1
            out[i].append(torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)))
    return tuple(tuple(w) for w in out)


def _leaky(x):
    return F.leaky_relu(x, SLOPE)


def _stage_mm(x, seq_len, ws, mm):
    """The stage with each conv as unfold @ weight through ``mm``."""
    B, T, C = x.shape
    w1s, b1s, w2s, b2s = ws
    valid = (torch.arange(T) < seq_len)[None, :, None].float()

    def conv(a, w, b, k, d):
        pad = (k - 1) // 2 * d
        ap = F.pad(a, (0, 0, pad, pad))
        cols = torch.cat([ap[:, j * d:j * d + T] for j in range(k)], -1)
        return mm(cols.reshape(B * T, k * C), w.reshape(k * C, C)).reshape(B, T, C) + b

    x0 = x * valid
    acc = torch.zeros_like(x0)
    for blk, (k, dils) in enumerate(zip(KS, DILS)):
        h = x0
        for di, d in enumerate(dils):
            y = conv(_leaky(h), w1s[blk][di], b1s[blk][di], k, d) * valid
            h = h + conv(_leaky(y), w2s[blk][di], b2s[blk][di], k, 1) * valid
        acc = acc + h
    return acc / len(KS)


@pytest.mark.parametrize("C", [64, 32])
def test_three_tf32_products_hold_the_limit_and_one_does_not(C):
    B, T, seq_len = 2, 512, 475
    x = torch.from_numpy(np.random.RandomState(C + 1).randn(B, T, C).astype(np.float32))
    ws = _weights(C, seed=C)
    want = fm.fused_mrf_stage_plain(x, seq_len, *ws, kernel_sizes=KS, dilations=DILS)
    errs = {name: (_stage_mm(x, seq_len, ws, mm) - want).abs().max().item()
            for name, mm in (("fp32", mm_fp32), ("3xtf32", mm_3xtf32), ("tf32", mm_tf32))}
    assert errs["fp32"] <= 1e-5, errs  # the emulation's own order of sums
    assert errs["3xtf32"] <= TOL, errs
    assert errs["tf32"] > TOL, errs
    assert want.abs().max().item() > 1.0  # the limit is absolute at this scale


@pytest.mark.parametrize("C", [16, 32, 64])
def test_pack_weights_puts_hi_and_lo_where_the_fragment_load_reads(C):
    k = 3
    w = torch.from_numpy(np.random.RandomState(C).randn(2, k, C, C).astype(np.float32))
    p = fm.pack_weights(w)
    assert p.shape == (2, k, C // 8, C // 8, 32, 4) and p.is_contiguous()
    # the kernel: lane (g, t) of n-tile nt at k-step ks loads the float4
    # (hi[8ks+2t][8nt+g], hi[8ks+2t+1][..], lo[8ks+2t][..], lo[8ks+2t+1][..])
    hi, lo = torch.empty_like(w), torch.empty_like(w)
    for ks in range(C // 8):
        for nt in range(C // 8):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for j in range(2):
                    hi[:, :, 8 * ks + 2 * t + j, 8 * nt + g] = p[:, :, ks, nt, lane, j]
                    lo[:, :, 8 * ks + 2 * t + j, 8 * nt + g] = p[:, :, ks, nt, lane, 2 + j]
    assert torch.equal(hi, tf32(w))
    assert torch.equal(lo, tf32_trunc(w - tf32(w)))
    assert (hi + lo - w).abs().max().item() <= 2.0 ** -21 * w.abs().max().item()


def _conv(a, w, b, d):
    """(B, R, C) rows, (k, C, C) taps -> the R - (k - 1) d rows of an
    unpadded dilated conv, by the plain version's own op."""
    return F.conv1d(a.transpose(1, 2), w.permute(2, 1, 0), b, dilation=d).transpose(1, 2)


def _tiled_stage(x, seq_len, ws, TT):
    """The kernel's blocks, emulated: per (block, dilation) pair, tiles of
    S = TT - 2 pad2 output rows, each from its own window and y tile."""
    B, T, C = x.shape
    w1s, b1s, w2s, b2s = ws
    out = None
    for blk, (k, dils) in enumerate(zip(KS, DILS)):
        src = x  # the stage input as given: the window masks it
        p2 = (k - 1) // 2
        S = TT - 2 * p2
        for di, d in enumerate(dils):
            p1 = (k - 1) // 2 * d
            w1, w2 = w1s[blk][di], w2s[blk][di]
            h = torch.empty_like(x)
            for o0 in range(0, T, S):
                # window row w is time o0 - p2 - p1 + w, TT + 2 p1 rows
                tw = torch.arange(o0 - p2 - p1, o0 + TT - p2 + p1)
                inw = (tw >= 0) & (tw < seq_len)
                win = torch.zeros(B, len(tw), C)
                win[:, inw] = src[:, tw[inw]]
                win = _leaky(win)
                # conv1 on TT rows: y row r is time o0 - p2 + r
                y = _conv(win, w1, b1s[blk][di], d)
                ty = torch.arange(o0 - p2, o0 - p2 + TT)
                yv = ((ty >= 0) & (ty < seq_len))[None, :, None]
                y = torch.where(yv, _leaky(y), torch.zeros(()))
                # y overwrites the window's first TT rows; conv2's last rows
                # read the window rows past them
                ybuf = torch.cat([y, win[:, TT:TT + 2 * p2]], 1)
                z = _conv(ybuf, w2, b2s[blk][di], 1)
                # conv2 row r is time o0 + r; the block keeps r < S, t < T
                n = min(S, T - o0)
                t = torch.arange(o0, o0 + n)
                valid = (t < seq_len)[None, :, None]
                h[:, o0:o0 + n] = torch.where(valid, src[:, o0:o0 + n] + z[:, :n],
                                              torch.zeros(()))
            src = h
        out = src if out is None else out + src
    return out / len(KS)


@pytest.mark.parametrize("C_of_tile", [64, 32])
def test_tiling_emulation_equals_the_plain_stage(C_of_tile):
    TT = fm.tile_rows(C_of_tile)
    B, C = 2, 8
    T = 2 * TT + 77  # not a multiple of any pair's tile
    x = torch.from_numpy(np.random.RandomState(TT).randn(B, T, C).astype(np.float32))
    ws = _weights(C, seed=TT)
    edges = [TT - 2 * ((k - 1) // 2) for k in KS]  # each pair's S
    cases = {
        "T": T,
        "1": 1,
        "inside a tile": TT // 2 + 3,
        "k=3 tile edge": edges[0],
        "k=11 tile edge": edges[2],
        "k=7 second tile edge": 2 * edges[1],
        "one past the k=11 edge": edges[2] + 1,
    }
    for name, seq_len in cases.items():
        want = fm.fused_mrf_stage_plain(x, seq_len, *ws, kernel_sizes=KS, dilations=DILS)
        got = _tiled_stage(x, seq_len, ws, TT)
        err = (got - want).abs().max().item()
        assert err <= 1e-6, (name, seq_len, err)
        assert not got[:, seq_len:].any(), name
