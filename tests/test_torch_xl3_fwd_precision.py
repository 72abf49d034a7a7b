"""The tensor-core K4 forward (``xl3_fwd_band_kernel`` in
``viet_tts_torch/csrc/flash_xl_attention.cu``, its band form in
``csrc/xl3_band.cuh``): why it multiplies fp32 streams in 3xTF32 in every
product, and that its band-and-shear index arithmetic gives the plain
version's position term.

The kernel forms three products a key tile: the content logits qc k^T, the
position logits as a band product (qv against the rows of the projected
table p that the tile's offsets j - i reach) and the weighted sum p v (p
the unnormalised softmax weights). This test runs the plain K4 forward's
dense formulas with each product emulated in TF32 (the rounding and split
helpers of ``tests/test_torch_xl_bwd_precision.py``) at the FS2 width
(H=8, D=48) and a small T, at seeded inputs and with one peaked row,
against the fp32 plain version: 3xTF32 everywhere holds the port's fp32
limits (ctx 1e-4, lse relative 1e-5), and one TF32 product in any one of
the three misses one of them. In fp64, the kernel's band form (band row u
of key tile kt against query tile qt holds p at T - 1 + rel for rel =
64 (kt - qt) + u - 63 <= 0, against qv_i, and at rel - 2 for rel >= 2,
against qv_{i+1}; zero at rel = 1; sheared by key c = u + r - 63) gives the
plain version's dense position term at T = 45 (one tile) and T = 130 (three
key tiles). No JAX here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_xl_bwd_precision import D, TOL, B, H, SCALE, T, mm_3xtf32, mm_fp32, mm_tf32
from viet_tts_torch.nn.utils import sinusoid_position_table
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops.flash_attention import MASK_NEG

LSE_TOL = 1e-5  # the kernels' fp32 limit on the logsumexp, relative
PRODUCTS = ("content", "band", "weighted sum")
TILE = 64  # the kernel's query rows and keys a tile


def _inputs(seed: int, T: int = T, dtype=torch.float32):
    """qc, k, v, qv (B, T, H, D), the projected table p (T, H, D) and a pad
    mask (B, T) (1.0 at padding keys; a full and a ragged row), built as the
    conformer builds them (qv = q + v_bias, p = table kernel)."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape)).to(dtype)
    E = H * D
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    qc, qv = q + 0.3 * f(H, D), q + 0.3 * f(H, D)
    table = torch.from_numpy(sinusoid_position_table(T, E)).to(dtype)
    p = (table @ (f(E, E) / np.sqrt(E))).reshape(T, H, D)
    lens = torch.tensor([T, T // 2 + 1])
    pad = (torch.arange(T)[None] >= lens[:, None]).to(dtype)
    return qc, k, v, qv, p, pad


def _plain_pos(qvh, p, T: int, mm):
    """The position term of ``xl3_fwd_plain`` (B, H, tp, tp) on head-major
    qv (B, H, tp, D), its product X = qv p'^T through ``mm``: p left-padded
    to tp, read at (j-i-1) mod tp (past) and, against qv one row down,
    (j-i-2+d_pad) mod tp (future); 0 at j = i + 1."""
    tp = qvh.shape[2]
    d_pad = tp - T
    ph = F.pad(p.to(qvh.dtype).permute(1, 0, 2), (0, 0, d_pad, 0))  # (H, tp, D)
    x = mm(qvh, ph.transpose(-1, -2)[None])
    x2 = torch.cat([x[:, :, 1:], torch.zeros_like(x[:, :, :1])], dim=2)
    i = torch.arange(tp)[:, None]
    j = torch.arange(tp)[None, :]
    s_past = torch.gather(x, -1, ((j - i - 1) % tp).expand(x.shape))
    s_fut = torch.gather(x2, -1, ((j - i - 2 + d_pad) % tp).expand(x.shape))
    return torch.where(j <= i, s_past, torch.where(j >= i + 2, s_fut, torch.zeros_like(s_fut)))


def _k4_fwd(qc, k, v, qv, p, pad, mm_content, mm_band, mm_pv):
    """The plain K4 forward (``xl3_fwd_plain``, fp32, no dropout) with its
    three products through hooks, the weighted sum taken on the
    unnormalised weights as the kernel takes it: (ctx (B, T, H, D), lse
    (B, H, T))."""
    cd = torch.float32
    tp = fx.xl3_padded_time(T)
    padp = F.pad(pad, (0, tp - T), value=1.0)
    qch, kh, vh, qvh = (fx._hm(fx._pad_rows(x, tp - T), cd) for x in (qc, k, v, qv))
    logits = (mm_content(qch, kh.transpose(-1, -2)) + _plain_pos(qvh, p, T, mm_band)) * SCALE
    logits = torch.where(padp[:, None, None, :] > 0.5, MASK_NEG, logits)
    logits = torch.where(torch.arange(tp) >= T, 2.0 * MASK_NEG, logits)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1)
    ctx = mm_pv(e, vh) / l[..., None]
    lse = m[..., 0] + torch.log(l)
    return ctx.permute(0, 2, 1, 3)[:, :T], lse[:, :, :T]


def _errors(case, mms):
    """(max abs ctx error, max lse error relative to max(1, |lse|)) of the
    emulation against the plain version."""
    args, (ctx_ref, lse_ref) = case
    ctx, lse = _k4_fwd(*args, *mms)
    return ((ctx - ctx_ref).abs().max().item(),
            ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item())


def _peaked(qc, k):
    """qc with query 20 of batch row 0 pointed at key 3: its logit leads the
    row's others, so that key carries nearly all the weight."""
    qc = qc.clone()
    qc[0, 20] = 5.0 * k[0, 3]
    return qc


@pytest.fixture(scope="module")
def cases():
    qc, k, v, qv, p, pad = _inputs(seed=11)
    out = {}
    for name, q in (("seeded", qc), ("peaked row", _peaked(qc, k))):
        args = (q, k, v, qv, p, pad)
        out[name] = args, fx.xl3_fwd_plain(q, k, v, qv, p, SCALE, pad > 0.5)
    return out


def test_emulation_hook_is_the_plain_version(cases):
    """With fp32 products the hooked formulas give the plain K4 forward."""
    for case in cases.values():
        err, lse_err = _errors(case, (mm_fp32,) * 3)
        assert err <= 1e-5 and lse_err <= 1e-6, (err, lse_err)


def test_3xtf32_in_every_product_holds_the_fp32_limits(cases):
    for case in cases.values():
        err, lse_err = _errors(case, (mm_3xtf32,) * 3)
        assert err <= TOL and lse_err <= LSE_TOL, (err, lse_err)


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_product_in_any_product_misses_a_limit(cases, product):
    """Each product alone in one TF32 product (the others in 3xTF32) misses
    the ctx or the lse limit at the seeded inputs or at the peaked row."""
    mms = [mm_3xtf32] * 3
    mms[PRODUCTS.index(product)] = mm_tf32
    worst = [0.0, 0.0]
    for case in cases.values():
        worst = [max(w, e) for w, e in zip(worst, _errors(case, mms))]
    assert worst[0] > TOL or worst[1] > LSE_TOL, worst


def _band_pos(qvh, p, T: int):
    """The position term (B, H, T, T) as the kernel forms it: for each
    (query tile qt, key tile kt), the band of p (``xl3_stage_band``), X = qv
    band^T over the past columns and qv_{+1} band^T over the future ones
    (split at u_split = 64 - 64 (kt - qt), ``xl3_band_logits``), sheared by
    W[r][c] = X[r][c - r + 63]."""
    Bq, Hq, _, Dq = qvh.shape
    nt = -(-T // TILE)
    ph = p.to(qvh.dtype).permute(1, 0, 2)  # (H, T, D)
    qv_rows = F.pad(qvh, (0, 0, 0, nt * TILE + 1 - T))  # zero rows past T
    pos = qvh.new_zeros(Bq, Hq, nt * TILE, nt * TILE)
    u = torch.arange(2 * TILE)
    r = torch.arange(TILE)[:, None]
    c = torch.arange(TILE)[None, :]
    for qt in range(nt):
        i0 = qt * TILE
        for kt in range(nt):
            rel = TILE * (kt - qt) + u - (TILE - 1)
            row = torch.where(rel >= 2, rel - 2, T - 1 + rel)
            live = (u < 2 * TILE - 1) & (rel != 1) & (row >= 0) & (row < T)
            band = torch.where(live[None, :, None], ph[:, row.clamp(0, T - 1)], 0.0)
            x_past = qv_rows[:, :, i0:i0 + TILE] @ band.transpose(-1, -2)[None]
            x_fut = qv_rows[:, :, i0 + 1:i0 + TILE + 1] @ band.transpose(-1, -2)[None]
            x = torch.where(u < TILE - TILE * (kt - qt), x_past, x_fut)  # (B, H, 64, 128)
            w = torch.gather(x, -1, (c - r + TILE - 1).expand(Bq, Hq, TILE, TILE))
            pos[:, :, i0:i0 + TILE, kt * TILE:(kt + 1) * TILE] = w
    return pos[:, :, :T, :T]


@pytest.mark.parametrize("T_band", [45, 130])
def test_band_and_shear_give_the_plain_position_term(T_band):
    """In fp64 the kernel's band form and shear give the dense position term
    of ``xl3_fwd_plain`` at every real pair (i, j), past, zero at j = i + 1
    and future, at one key tile (T = 45) and three (T = 130); the same
    formula in fp32 gives the plain version's ctx and lse."""
    qc, k, v, qv, p, pad = _inputs(seed=T_band, T=T_band, dtype=torch.float64)
    qvh = qv.permute(0, 2, 1, 3)
    tp = fx.xl3_padded_time(T_band)
    want = _plain_pos(fx._pad_rows(qv, tp - T_band).permute(0, 2, 1, 3), p, T_band,
                      torch.matmul)[:, :, :T_band, :T_band]
    got = _band_pos(qvh, p, T_band)
    assert (got - want).abs().max().item() <= 1e-12
    i = torch.arange(T_band)[:, None]
    assert torch.all(got[..., i.squeeze(1)[:-1], i.squeeze(1)[1:]] == 0.0)  # j = i + 1
    # the position term above is the plain version's: with it, fp32
    # logits reproduce xl3_fwd_plain
    f32 = [x.float() for x in (qc, k, v, qv, p, pad)]
    qch, kh, vh = (x.permute(0, 2, 1, 3) for x in f32[:3])
    logits = (qch @ kh.transpose(-1, -2) + _band_pos(f32[3].permute(0, 2, 1, 3), f32[4],
                                                     T_band)) * SCALE
    logits = torch.where(f32[5][:, None, None, :] > 0.5, MASK_NEG, logits)
    ctx = (torch.softmax(logits, dim=-1) @ vh).permute(0, 2, 1, 3)
    ref, ref_lse = fx.xl3_fwd_plain(*f32[:5], SCALE, f32[5] > 0.5)
    assert (ctx - ref).abs().max().item() <= 1e-5
    assert (torch.logsumexp(logits, dim=-1) - ref_lse).abs().max().item() <= 1e-5
