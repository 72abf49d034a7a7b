"""Why K1 (the instance of the tensor-core flash forward template with no
position term, ``xl2_fwd_kernel`` in
``viet_tts_torch/csrc/flash_xl_attention.cu``) multiplies fp32 streams in
3xTF32 in both its products, and why it may stop at a batch row's last
live key.

The kernel forms two products a key tile: the logits q k^T (D = 128 wide)
and the weighted sum p v (p the unnormalised softmax weights). This test
runs the plain K1's dense formulas (``attention_fwd_plain``) with each
product emulated in TF32 (the rounding and split helpers of
``tests/test_torch_xl_bwd_precision.py``) at the JETS width (2 heads of
128) and a small T, at seeded inputs and with one peaked row (one key
leads the row's others by ~11 in the logit), against the fp32 plain
version: 3xTF32 in both holds the port's fp32 limits (ctx 1e-4, lse
relative 1e-5), and one TF32 product in either misses one of them.

The kernel walks each batch row's key tiles only up to the row's last
live key. Emulating its online softmax over 64-key tiles in fp32, the
tiles after that key leave the running max, the denominator and the
context exactly as they were (every weight there is exp(MASK_NEG - m) =
0.0, every rescale exp(m - m) = 1.0), so ctx and lse come out bit for bit
the same with or without them. A row with no live key walks every tile:
its weights are uniform over all Tp keys, its lse is -1e9 + log Tp (which
is -1e9 in fp32), and cutting its tiles changes its context. No JAX here.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_xl_bwd_precision import TOL, mm_3xtf32, mm_fp32, mm_tf32
from viet_tts_torch.ops import flash_attention as fa
from viet_tts_torch.ops.flash_attention import MASK_NEG, padded_time

B, T, H, D = 2, 40, 2, 128  # JETS: adim 256, 2 heads
SCALE = D ** -0.5
LSE_TOL = 1e-5  # the kernels' fp32 limit on the logsumexp, relative
PRODUCTS = ("content", "weighted sum")
TILE = 64  # the kernel's key tile


def _inputs(seed: int, B: int = B, T: int = T, lens=None):
    """q, k, v (B, T, H, D) and a pad mask (B, T) (1.0 at padding keys; row
    lengths ``lens``, by default a full and a ragged row)."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)) for _ in range(3))
    lens = torch.tensor([T, T // 2 + 1] if lens is None else lens)
    pad = (torch.arange(T)[None] >= lens[:, None]).float()
    return q, k, v, pad


def _k1_fwd(q, k, v, pad, mm_content, mm_pv):
    """The plain K1 forward (``attention_fwd_plain``, fp32, no dropout) with
    its two products through hooks, the weighted sum taken on the
    unnormalised weights as the kernel takes it: (ctx (B, T, H, D), lse
    (B, H, T))."""
    n = q.shape[1]
    tp = padded_time(n)
    padp = F.pad(pad, (0, tp - n), value=1.0)
    qh = q.permute(0, 2, 1, 3)
    kh, vh = (F.pad(x, (0, 0, 0, 0, 0, tp - n)).permute(0, 2, 1, 3) for x in (k, v))
    logits = mm_content(qh, kh.transpose(-1, -2)) * SCALE
    logits = torch.where(padp[:, None, None, :] > 0.5, MASK_NEG, logits)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1)
    ctx = mm_pv(p, vh) / l[..., None]
    return ctx.permute(0, 2, 1, 3), m[..., 0] + torch.log(l)


def _peaked(q, k):
    """q with query 20 of batch row 0 pointed at key 3: its logit leads the
    row's others by ~11, so that key carries nearly all the weight."""
    q = q.clone()
    q[0, 20] = k[0, 3]
    return q


def _errors(args, mms):
    """(max abs ctx error, max lse error relative to max(1, |lse|)) of the
    emulation against the plain version."""
    q, k, v, pad = args
    ctx_ref, lse_ref = fa.attention_fwd_plain(q, k, v, SCALE, pad > 0.5)
    ctx, lse = _k1_fwd(*args, *mms)
    return ((ctx - ctx_ref).abs().max().item(),
            ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item())


@pytest.fixture(scope="module", params=["seeded", "peaked row"])
def case(request):
    q, k, v, pad = _inputs(seed=11)
    if request.param == "peaked row":
        q = _peaked(q, k)
    return q, k, v, pad


def test_emulation_hook_is_the_plain_version(case):
    """With fp32 products the hooked formulas give the plain K1 forward."""
    err, lse_err = _errors(case, (mm_fp32,) * 2)
    assert err <= 1e-5 and lse_err <= 1e-6, (err, lse_err)


def test_3xtf32_in_both_products_holds_the_fp32_limits(case):
    err, lse_err = _errors(case, (mm_3xtf32,) * 2)
    assert err <= TOL and lse_err <= LSE_TOL, (err, lse_err)


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_product_in_either_product_misses_a_limit(product):
    """Each product alone in one TF32 product (the other in 3xTF32) misses
    the ctx or the lse limit at the seeded inputs or at the peaked row."""
    args = _inputs(seed=11)
    mms = [mm_3xtf32] * 2
    mms[PRODUCTS.index(product)] = mm_tf32
    worst = [0.0, 0.0]
    for q in (args[0], _peaked(args[0], args[1])):
        worst = [max(w, e) for w, e in zip(worst, _errors((q, *args[1:]), mms))]
    assert worst[0] > TOL or worst[1] > LSE_TOL, worst


def _online(q, k, v, pad, b: int, n_tiles: int):
    """The kernel's online softmax for batch row b in fp32, walking its first
    n_tiles 64-key tiles: the running max and denominator take each tile,
    the context is rescaled and takes p v; keys past T weigh nothing (-inf)
    and the Tp - T tail keys add (Tp - T) exp(MASK_NEG - m) to the
    denominator at the end. (ctx (T, H, D), lse (H, T))."""
    n = q.shape[1]
    qh, kh, vh = (x[b].permute(1, 0, 2) for x in (q, k, v))  # (H, T, D)
    m = torch.full((H, n, 1), -math.inf)
    l = torch.zeros(H, n, 1)
    o = torch.zeros(H, n, D)
    for kt in range(n_tiles):
        j = torch.arange(kt * TILE, (kt + 1) * TILE)
        inside = j < n
        jj = j.clamp(max=n - 1)
        s = (qh @ kh[:, jj].transpose(-1, -2)) * SCALE
        s = torch.where(pad[b, jj] > 0.5, torch.tensor(MASK_NEG), s)
        s = torch.where(inside, s, torch.tensor(-math.inf))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + p @ torch.where(inside[:, None], vh[:, jj], torch.zeros(()))
        m = m_new
    l = l + (padded_time(n) - n) * torch.exp(MASK_NEG - m)
    return (o / l).permute(1, 0, 2), (m + torch.log(l))[..., 0]


def test_tiles_after_the_last_live_key_change_no_bit():
    """Rows of 150 (three 64-key tiles), 70 (two) and 1 (one) live keys with
    holes before the last: in fp32 the online softmax over every tile and
    over the tiles up to the row's last live key give the same ctx and lse
    bit for bit, and they are the plain version's within the fp32 limits."""
    n = 150
    q, k, v, pad = _inputs(seed=9, B=4, T=n, lens=[n, 70, 1, 0])
    pad[0, 10:40:3] = 1.0
    pad[1, 5:60:7] = 1.0
    ctx_ref, lse_ref = fa.attention_fwd_plain(q, k, v, SCALE, pad > 0.5)
    every = -(-n // TILE)
    for b, last in ((0, n), (1, 70), (2, 1)):
        ctx, lse = _online(q, k, v, pad, b, every)
        c, l = _online(q, k, v, pad, b, -(-last // TILE))
        assert torch.equal(c, ctx) and torch.equal(l, lse), b
        assert (ctx - ctx_ref[b]).abs().max().item() <= TOL, b
        assert ((lse - lse_ref[b]).abs() / lse_ref[b].abs()).max().item() <= LSE_TOL, b


def test_a_row_with_no_live_key_averages_every_key():
    """A batch row whose keys are all padding: its weights are uniform over
    the Tp padded keys, so its lse is -1e9 + log Tp (-1e9 in fp32) and its
    context the sum of v over the T real keys over Tp, in the plain version
    and in the kernel's online softmax over every tile; cut to the first
    tile, the context changes (so the kernel walks every tile there)."""
    n = 150
    tp = padded_time(n)
    q, k, v, pad = _inputs(seed=9, B=4, T=n, lens=[n, 70, 1, 0])
    ctx_ref, lse_ref = fa.attention_fwd_plain(q, k, v, SCALE, pad > 0.5)
    want_lse = torch.tensor(MASK_NEG + math.log(tp), dtype=torch.float32)
    want_ctx = (v[3].sum(dim=0) / tp).expand(n, H, D)
    ctx, lse = _online(q, k, v, pad, 3, -(-n // TILE))
    for c, l in ((ctx_ref[3], lse_ref[3]), (ctx, lse)):
        assert torch.equal(l, want_lse.expand(H, n))
        assert (c - want_ctx).abs().max().item() <= 1e-6
    cut, _ = _online(q, k, v, pad, 3, 1)
    assert (cut - ctx).abs().max().item() > 1e-3
