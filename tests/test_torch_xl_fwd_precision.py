"""Why the tensor-core K5 / K6 forward kernel multiplies fp32 streams in
3xTF32 in every product (``viet_tts_torch/csrc/flash_xl_attention.cu``),
and why bf16 streams need only one TF32 product.

The kernel forms three products a key tile: the content logits qc k^T, the
E-wide position logits gA t^T / gB t^T, and the weighted sum p v (p the
unnormalised softmax weights, divided by the denominator at the end). This
test runs the plain K5 forward's dense formulas with each product emulated
in TF32 (``tf32``, ``tf32_trunc``, ``mm_3xtf32`` of the bwd-q precision
test: the kernels' rounding and split) at the FS2 width E = 384 and a small
T, at seeded inputs and with one peaked row (one key carries most of the
row's weight), against the fp32 plain version: 3xTF32 everywhere holds the
port's fp32 limits (ctx 1e-4, lse relative 1e-5), and one TF32 product in
any one of the three misses one of them. No JAX here: the emulation and the
plain version are both the port's.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_xl_bwd_precision import (
    SCALE,
    TOL,
    T,
    _inputs,
    mm_3xtf32,
    mm_fp32,
    mm_tf32,
    tf32,
)
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops.flash_attention import MASK_NEG, padded_time

LSE_TOL = 1e-5  # the kernels' fp32 limit on the logsumexp, relative
PRODUCTS = ("content", "position", "weighted sum")


def _k5_fwd(qc, k, v, g2, table, pad, mm_content, mm_pos, mm_pv):
    """The plain K5 forward (``xl2_fwd_plain``, fp32, no dropout) with its
    three products through hooks, the weighted sum taken on the unnormalised
    weights as the kernel takes it: (ctx (B, T, H, D), lse (B, H, T))."""
    cd = torch.float32
    tp = padded_time(T)
    padp = F.pad(pad, (0, tp - T), value=1.0)
    qch, kh, vh, gh = (fx._hm(fx._pad_rows(x, tp - T), cd) for x in (qc, k, v, g2))
    tab = fx._pad_rows(table.float()[None], tp - T)[0]
    gA, gB, _ = fx._xl2_streams(gh, T, cd)
    i = torch.arange(tp)[:, None]
    j = torch.arange(tp)[None, :]
    pos = torch.where(j <= i, mm_pos(gA, tab.T),
                      torch.where(j >= i + 2, mm_pos(gB, tab.T), 0.0))
    logits = (mm_content(qch, kh.transpose(-1, -2)) + pos) * SCALE
    logits = torch.where(padp[:, None, None, :] > 0.5, MASK_NEG, logits)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1)
    ctx = mm_pv(p, vh) / l[..., None]
    lse = m[..., 0] + torch.log(l)
    return ctx.permute(0, 2, 1, 3)[:, :T], lse[:, :, :T]


def _errors(case, mms):
    """(max abs ctx error, max lse error relative to max(1, |lse|)) of the
    emulation against the plain version."""
    args, (ctx_ref, lse_ref) = case
    ctx, lse = _k5_fwd(*args, *mms)
    return ((ctx - ctx_ref).abs().max().item(),
            ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item())


@pytest.fixture(scope="module", params=["seeded", "peaked row"])
def case(request):
    qc, k, v, g2, table, pad = _inputs(seed=7)
    if request.param == "peaked row":
        # query 20 of batch row 0 points at key 3: its logit leads the
        # row's others by ~12, so that key carries nearly all the weight
        qc = qc.clone()
        qc[0, 20] = 5.0 * k[0, 3]
    args = (qc, k, v, g2, table, pad)
    return args, fx.xl2_fwd_plain(qc, k, v, g2, table, SCALE, pad > 0.5)


def test_emulation_hook_is_the_plain_version(case):
    """With fp32 products the hooked formulas give the plain K5 forward."""
    err, lse_err = _errors(case, (mm_fp32,) * 3)
    assert err <= 1e-5 and lse_err <= 1e-6, (err, lse_err)


def test_3xtf32_in_every_product_holds_the_fp32_limits(case):
    err, lse_err = _errors(case, (mm_3xtf32,) * 3)
    assert err <= TOL and lse_err <= LSE_TOL, (err, lse_err)


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_product_in_any_product_misses_a_limit(product):
    """Each product alone in one TF32 product (the others in 3xTF32) misses
    the ctx or the lse limit at the seeded inputs or at the peaked row."""
    qc, k, v, g2, table, pad = _inputs(seed=7)
    peaked = qc.clone()
    peaked[0, 20] = 5.0 * k[0, 3]
    mms = [mm_3xtf32] * 3
    mms[PRODUCTS.index(product)] = mm_tf32
    worst = [0.0, 0.0]
    for q in (qc, peaked):
        args = (q, k, v, g2, table, pad)
        case = args, fx.xl2_fwd_plain(q, k, v, g2, table, SCALE, pad > 0.5)
        worst = [max(w, e) for w, e in zip(worst, _errors(case, mms))]
    assert worst[0] > TOL or worst[1] > LSE_TOL, worst


def test_bf16_operands_are_exact_in_one_tf32_product():
    """bf16 keeps 8 mantissa bits of TF32's 10: the bf16 streams and the
    weights p rounded to bf16 (as the JAX ``_mx`` rounds them) pass through
    the TF32 rounding unchanged, so one TF32 product is exact for them."""
    x = torch.randn(4096) * torch.logspace(-8, 8, 4096)
    xb = x.to(torch.bfloat16).float()
    assert torch.equal(tf32(xb), xb)
    p = torch.exp(-torch.rand(4096) * 30).to(torch.bfloat16).float()
    assert torch.equal(tf32(p), p)
