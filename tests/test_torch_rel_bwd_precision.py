"""Why K7 bwd-q (K7's instance of the tensor-core K5 / K6 bwd-q kernels in
``viet_tts_torch/csrc/flash_xl_attention_bwd.cu``) multiplies fp32 streams
in 3xTF32 in its position and gradient products.

The kernels form, besides the content products qc k^T and g_out v^T, three
products of K7's: the position logits g t^T (Q1 pos, E = 256 wide), dqc =
ds k (Q1 ds, over the keys, D = 128 wide) and dg = ds t (Q2, over the keys,
E = 256 wide). This test runs the plain K7 bwd-q's dense formulas with every
product emulated as the kernels form it (3xTF32: the rounding and split
helpers of ``tests/test_torch_xl_bwd_precision.py``), at the JETS
conformer's width and a small T, at seeded inputs and with one peaked row,
against the fp32 plain version: 3xTF32 everywhere holds dqc and dg within
the port's fp32 limit (1e-4, scaled by the largest gradient where that
exceeds 1), and one TF32 product in any one of the three misses it, so the
kernels keep 3xTF32 in all three. No JAX here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_rel_fwd_precision import SCALE, T, _inputs, _peaked
from tests.test_torch_xl_bwd_precision import TOL, _scaled_err, mm_3xtf32, mm_fp32, mm_tf32
from viet_tts_torch.ops import flash_rel_attention as fr
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops.flash_attention import backward_inputs, padded_time

PRODUCTS = ("position", "dqc", "dg")


def _k7_bwd_q(qc, k, v, g, table, pad, lse, delta, gout, mm_content, mm_pos, mm_dqc, mm_dg):
    """The plain K7 bwd-q (``rel_bwd_dq_plain``, fp32, no dropout) with its
    products through hooks: the content logits and g_out v^T, the position
    logits g t^T, dqc = ds k and dg = ds t. Returns (dqc (B, T, H, D), dg
    (B, T, H, E))."""
    cd = torch.float32
    tp = padded_time(T)
    padp = F.pad(pad, (0, tp - T), value=1.0)
    qch, gh, goh = (fx._hm(x, cd) for x in (qc, g, gout))
    kh, vh = (fx._hm(fx._pad_rows(x, tp - T), cd) for x in (k, v))
    tab = fx._pad_rows(table.float()[None], tp - T)[0]
    logits = (mm_content(qch, kh.transpose(-1, -2)) + mm_pos(gh, tab.T)) * SCALE
    dpv = mm_content(goh, vh.transpose(-1, -2))
    _, ds = fx._weights_and_ds(logits, padp, lse, dpv, delta, None, tp, SCALE, cd)
    return mm_dqc(ds, kh).permute(0, 2, 1, 3), mm_dg(ds, tab).permute(0, 2, 1, 3)


def _case(qc):
    """(the bwd-q arguments at ``qc``, the plain K7 bwd-q's (dqc, dg)), on
    the plain forward's lse and a seeded cotangent."""
    _, k, v, g, table, pad = _inputs(seed=7)
    ctx, lse = fr.rel_fwd_plain(qc, k, v, g, table, SCALE, pad > 0.5)
    gout = torch.from_numpy(np.random.RandomState(8).randn(*ctx.shape).astype(np.float32))
    delta, gs = backward_inputs(ctx, gout, torch.float32)
    args = (qc, k, v, g, table, pad, lse, delta, gs)
    return args, fr.rel_bwd_dq_plain(*args, SCALE)


@pytest.fixture(scope="module")
def cases():
    qc, k = _inputs(seed=7)[:2]
    return {"seeded": _case(qc), "peaked row": _case(_peaked(qc, k))}


def _worst(cases, mms) -> float:
    return max(_scaled_err(_k7_bwd_q(*args, *mms), plain) for args, plain in cases.values())


def test_emulation_hook_is_the_plain_version(cases):
    """With fp32 products the hooked formulas give the plain K7 bwd-q, at
    the seeded inputs and at the peaked row."""
    assert _worst(cases, (mm_fp32,) * 4) <= 1e-6


def test_3xtf32_in_every_product_holds_the_fp32_limit(cases):
    err = _worst(cases, (mm_3xtf32,) * 4)
    assert err <= TOL, err


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_product_in_any_product_misses_the_limit(cases, product):
    """Each of K7's three products alone in one TF32 product (every other
    product in 3xTF32) misses the limit on dqc or dg at the seeded inputs or
    at the peaked row."""
    mms = [mm_3xtf32] * 4
    mms[1 + PRODUCTS.index(product)] = mm_tf32
    err = _worst(cases, mms)
    assert err > TOL, err
