"""Why the tensor-core K5 / K6 bwd-q and bwd-kv kernels multiply fp32
streams in 3xTF32 and not in plain TF32
(``viet_tts_torch/csrc/flash_xl_attention_bwd.cu``).

A TF32 operand keeps 10 of fp32's 23 mantissa bits. The kernels split each
fp32 operand into two TF32 values, x = hi + lo (hi: x rounded to nearest,
ties away from zero, as ``cvt.rna.tf32.f32`` rounds, done on the bit
pattern; lo: the exact rest x - hi with its 13 low bits cleared), and form
a b as hi_a hi_b + hi_a lo_b + lo_a hi_b. This test rounds the same way
(``tf32``, ``tf32_trunc``) and runs the plain K5 bwd-q's dense formulas with
its E-wide products (the position logits gA t^T, gB t^T and the position
gradients dsA t, dsB t) emulated both ways, at the FS2 width E = 384 and a
small T: 3xTF32 stays within the port's fp32 limit of 1e-4 (scaled by the
largest gradient where that exceeds 1) of the fp32 plain version, and one
TF32 product does not. The same holds for bwd-kv's two products, the
T-long contractions over the query rows dk = ds^T qc and dv = (p m /
keep)^T g, each on its own: one TF32 product misses the limit in dk and in
dv, so the kernel runs both in 3xTF32. K4 bwd's band products, the
T-long contractions of ds by offset against the projected table (dqv) and
against qv over the batch and query rows (the table's gradient dp), behave
the same: one TF32 product misses the limit in each, so the K4 ds kernel
runs both in 3xTF32. No JAX here: the emulation and the plain version are
both the port's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from viet_tts_torch.nn.utils import sinusoid_position_table
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops.flash_attention import backward_inputs, padded_time
from viet_tts_torch.ops.xl_attention import xl_pos_query_stream

B, T, H, D = 2, 40, 8, 48
E = H * D  # 384, the FS2 conformer's d_model
SCALE = 1.0 / np.sqrt(E)
TOL = 1e-4  # the kernels' fp32 limit against their plain versions


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (add half an ulp of TF32 to the magnitude's bit
    pattern, then clear the 13 dropped bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 with its 13 low mantissa bits cleared (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_fp32(a, b):
    return a @ b


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _inputs(seed: int):
    rng = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    qc = q + 0.3 * f(H, D)
    qv = q + 0.3 * f(H, D)
    g2 = xl_pos_query_stream(qv, f(E, E) / np.sqrt(E))
    table = torch.from_numpy(sinusoid_position_table(T, E))
    lens = torch.tensor([T, T // 2 + 1])
    pad = (torch.arange(T)[None] >= lens[:, None]).float()
    return qc, k, v, g2, table, pad


def _k5_bwd_q(qc, k, v, g2, table, pad, lse, delta, g, mm):
    """The plain K5 bwd-q (``xl2_bwd_dq_plain``, fp32, no dropout) with its
    E-wide products through ``mm``: (dqc (B, T, H, D), dg2 (B, T, H, E)).
    ``xl2_bwd_dq_plain`` is the source of truth: this copy of its formulas
    shares its private helpers, and ``test_emulation_hook_is_the_plain_version``
    holds the two together."""
    cd = torch.float32
    gA, gB, (ca, sa, cb, sb) = fx._xl2_streams(fx._hm(g2, cd), T, cd)
    tp = padded_time(T)
    padp = F.pad(pad, (0, tp - T), value=1.0)
    qch, gh = fx._hm(qc, cd), fx._hm(g, cd)
    kh, vh = (fx._hm(fx._pad_rows(x, tp - T), cd) for x in (k, v))
    tab = fx._pad_rows(table.float()[None], tp - T)[0]
    i = torch.arange(T)[:, None]
    j = torch.arange(tp)[None, :]
    past, fut = j <= i, j >= i + 2
    pos = torch.where(past, mm(gA, tab.T), torch.where(fut, mm(gB, tab.T), 0.0))
    logits = (qch @ kh.transpose(-1, -2) + pos) * SCALE
    _, ds = fx._weights_and_ds(logits, padp, lse, gh @ vh.transpose(-1, -2), delta, None,
                               tp, SCALE, cd)
    dqc = (ds @ kh).permute(0, 2, 1, 3)
    dgA = mm(torch.where(past, ds, 0.0), tab)
    dgB = fx._rotate(mm(torch.where(fut, ds, 0.0), tab), cb, -sb)
    dg2 = fx._rotate(dgA, ca, -sa) + torch.cat([torch.zeros_like(dgB[:, :, :1]),
                                                 dgB[:, :, :-1]], dim=2)
    return dqc, dg2.permute(0, 2, 1, 3)


def _scaled_err(got, want) -> float:
    return max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(got, want))


@pytest.fixture(scope="module")
def case():
    qc, k, v, g2, table, pad = _inputs(seed=7)
    ctx, lse = fx.xl2_fwd_plain(qc, k, v, g2, table, SCALE, pad > 0.5)
    gout = torch.from_numpy(np.random.RandomState(8).randn(*ctx.shape).astype(np.float32))
    delta, g = backward_inputs(ctx, gout, torch.float32)
    args = (qc, k, v, g2, table, pad, lse, delta, g)
    return args, fx.xl2_bwd_dq_plain(*args, SCALE)


def test_tf32_rounding_is_cvt_rna():
    """Ties round away from zero, both signs; 10 mantissa bits survive."""
    one_tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert torch.equal(tf32(one_tie), torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]))
    x = torch.randn(1000)
    for r in (tf32(x), tf32_trunc(x)):
        assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((tf32(x) - x).abs() <= x.abs() * 2.0 ** -11).all()
    lo = x - tf32(x)  # exact in fp32; the split's rest is 2^-10 of hi or less
    assert ((tf32(x) + tf32_trunc(lo) - x).abs() <= x.abs() * 2.0 ** -20).all()


def test_emulation_hook_is_the_plain_version(case):
    """With fp32 products the hooked formulas give the plain K5 bwd-q."""
    args, plain = case
    assert _scaled_err(_k5_bwd_q(*args, mm_fp32), plain) <= 1e-6


def test_3xtf32_holds_the_fp32_limit_and_one_tf32_product_does_not(case):
    args, plain = case
    err_3x = _scaled_err(_k5_bwd_q(*args, mm_3xtf32), plain)
    err_1x = _scaled_err(_k5_bwd_q(*args, mm_tf32), plain)
    assert err_3x <= TOL, err_3x
    assert err_1x > TOL, err_1x
    assert err_1x > 50 * err_3x, (err_1x, err_3x)


@pytest.fixture(scope="module")
def kv_case(case):
    """The plain K5 bwd-kv (fp32, no dropout) on the ``case`` inputs, and
    the dense terms its two products contract: (dk, dv) each (B, H, T, D),
    and (qc, g, ds, p m / keep) head-major."""
    args, _ = case
    qch, _, gh, _, _, _, _, p_v, ds, _, _ = fx._xl2_bwd_terms(*args, SCALE, 0.0, 0)
    plain = [x.permute(0, 2, 1, 3) for x in fx.xl2_bwd_dkv_plain(*args, SCALE)[:2]]
    return plain, (qch, gh, ds, p_v)


def _kv_products(terms, mm):
    """bwd-kv's two products through ``mm``: (dk = ds^T qc, dv = (p m /
    keep)^T g), each (B, H, T, D)."""
    qch, gh, ds, p_v = terms
    return (mm(ds.transpose(-1, -2), qch)[:, :, :T],
            mm(p_v.transpose(-1, -2), gh)[:, :, :T])


@pytest.mark.parametrize("product", ["dk", "dv"])
def test_kv_products_need_3xtf32(kv_case, product):
    """bwd-kv's product ``product`` in 3xTF32 holds the fp32 limit, in one
    TF32 product it does not; with fp32 products the hook is the plain
    K5 bwd-kv (``xl2_bwd_dkv_plain``, the source of truth)."""
    plain, terms = kv_case
    i = ("dk", "dv").index(product)
    assert _scaled_err([_kv_products(terms, mm_fp32)[i]], [plain[i]]) <= 1e-6
    err_3x = _scaled_err([_kv_products(terms, mm_3xtf32)[i]], [plain[i]])
    err_1x = _scaled_err([_kv_products(terms, mm_tf32)[i]], [plain[i]])
    assert err_3x <= TOL, err_3x
    assert err_1x > TOL, err_1x


@pytest.fixture(scope="module")
def xl3_case():
    """The plain K4 bwd (fp32, no dropout) at the module's sizes: the
    streams of one XL attention in the projected-table form (qv = q +
    v_bias, p = table kernel), a ragged row, and its (dqv, dp)."""
    rng = np.random.RandomState(11)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    qc, qv = q + 0.3 * f(H, D), q + 0.3 * f(H, D)
    table = torch.from_numpy(sinusoid_position_table(T, E))
    p = (table @ (f(E, E) / np.sqrt(E))).reshape(T, H, D)
    lens = torch.tensor([T, T // 2 + 1])
    pad = (torch.arange(T)[None] >= lens[:, None]).float()
    ctx, lse = fx.xl3_fwd_plain(qc, k, v, qv, p, SCALE, pad > 0.5)
    gout = torch.from_numpy(np.random.RandomState(12).randn(*ctx.shape).astype(np.float32))
    delta, g = backward_inputs(ctx, gout, torch.float32)
    args = (qc, k, v, qv, p, pad, lse, delta, g)
    return args, fx.xl3_bwd_plain(*args, SCALE)[3:]


def _k4_band_products(qc, k, v, qv, p, pad, lse, delta, g, mm):
    """The plain K4 bwd's (``xl3_bwd_plain``, fp32, no dropout) dqv and dp
    with their two band products through ``mm``: ds gathered by offset (dx
    past, dx2 future) against the projected table, and against qv (qv one
    row down for the future term) over the batch and query rows."""
    cd = torch.float32
    qch, kh, vh, qvh, gh = (fx._hm(x, cd) for x in (qc, k, v, qv, g))
    ph = p.float().permute(1, 0, 2)  # (H, T, D)
    x = torch.einsum("bhid,hcd->bhic", qvh, ph)
    x2 = torch.cat([x[:, :, 1:], torch.zeros_like(x[:, :, :1])], dim=2)
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    past, fut = j <= i, j >= i + 2
    idx_past = ((T - 1 - i + j) % T).expand(x.shape)
    idx_fut = ((j - i - 2) % T).expand(x.shape)
    pos = torch.where(past, torch.gather(x, -1, idx_past),
                      torch.where(fut, torch.gather(x2, -1, idx_fut), 0.0))
    logits = (qch @ kh.transpose(-1, -2) + pos) * SCALE
    _, ds = fx._weights_and_ds(logits, pad, lse, gh @ vh.transpose(-1, -2), delta, None, T,
                               SCALE, cd)
    dx = torch.zeros_like(ds).scatter_add_(-1, idx_past, torch.where(past, ds, 0.0))
    dx2 = torch.zeros_like(ds).scatter_add_(-1, idx_fut, torch.where(fut, ds, 0.0))
    nxt = mm(dx2, ph[None])
    dqv = mm(dx, ph[None]) + torch.cat([torch.zeros_like(nxt[:, :, :1]), nxt[:, :, :-1]], dim=2)
    qv_next = torch.cat([qvh[:, :, 1:], torch.zeros_like(qvh[:, :, :1])], dim=2)
    by_offset = lambda a: a.permute(1, 3, 0, 2).reshape(H, T, B * T)
    rows = lambda a: a.permute(1, 0, 2, 3).reshape(H, B * T, D)
    dp = mm(by_offset(dx), rows(qvh)) + mm(by_offset(dx2), rows(qv_next))
    return dqv.permute(0, 2, 1, 3), dp.permute(1, 0, 2)


@pytest.mark.parametrize("product", ["dqv", "dp"])
def test_k4_band_products_need_3xtf32(xl3_case, product):
    """K4 bwd's band product ``product`` (dqv: ds by offset times the
    projected table; dp: the table's gradient, ds by offset times qv over
    the batch and query rows) in 3xTF32 holds the fp32 limit, in one TF32
    product it does not; with fp32 products the hook is the plain K4 bwd
    (``xl3_bwd_plain``, the source of truth)."""
    args, plain = xl3_case
    i = ("dqv", "dp").index(product)
    assert _scaled_err([_k4_band_products(*args, mm_fp32)[i]], [plain[i]]) <= 1e-6
    err_3x = _scaled_err([_k4_band_products(*args, mm_3xtf32)[i]], [plain[i]])
    err_1x = _scaled_err([_k4_band_products(*args, mm_tf32)[i]], [plain[i]])
    assert err_3x <= TOL, err_3x
    assert err_1x > TOL, err_1x
