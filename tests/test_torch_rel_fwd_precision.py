"""Why the K7 forward (the K7 instance of the tensor-core flash kernel in
``viet_tts_torch/csrc/flash_xl_attention.cu``) multiplies fp32 streams in
3xTF32 in every product, and why it may stop at a batch row's last live
key.

The kernel forms three products a key tile: the content logits qc k^T
(D = 128 wide), the position logits g t^T (E = 256 wide) and the weighted
sum p v (p the unnormalised softmax weights). This test runs the plain K7
forward's dense formulas with each product emulated in TF32 (the rounding
and split helpers of ``tests/test_torch_xl_bwd_precision.py``) at the JETS
conformer's width and a small T, at seeded inputs and with one peaked row
(one key leads the row's others by ~11 in the logit), against the fp32
plain version: 3xTF32 everywhere holds the port's fp32 limits (ctx 1e-4,
lse relative 1e-5), and one TF32 product in any one of the three misses
one of them. The kernel walks each batch row's key tiles only up to the
row's last live key; on the plain version's formulas, every key after it
weighs exactly 0.0 in fp32 in a row with a live key (a padded key's
exp(MASK_NEG - m) underflows), and cutting those keys leaves ctx and lse
within 1e-7, while a row with no live key, whose weights are uniform over
every key, changes. No JAX here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_xl_bwd_precision import TOL, mm_3xtf32, mm_fp32, mm_tf32
from viet_tts_torch.nn.espnet_conformer import rel_positional_table
from viet_tts_torch.ops import flash_rel_attention as fr
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops.espnet_attention import neg_rel_table, rel_pos_queries_latest
from viet_tts_torch.ops.flash_attention import MASK_NEG, padded_time

B, T, H, D = 2, 40, 2, 128  # the JETS conformer: adim 256, 2 heads
E = H * D
SCALE = D ** -0.5
LSE_TOL = 1e-5  # the kernels' fp32 limit on the logsumexp, relative
PRODUCTS = ("content", "position", "weighted sum")


def _inputs(seed: int, B: int = B, T: int = T, lens=None):
    """qc, k, v (B, T, H, D), the rotated position queries g (B, T, H, E),
    the negative half of the symmetric table (T, E) and a pad mask (B, T)
    (1.0 at padding keys; row lengths ``lens``, by default a full and a
    ragged row), built as the conformer builds them."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    qc = q + 0.3 * f(H, D)
    g = rel_pos_queries_latest(q + 0.3 * f(H, D), f(E, E) / np.sqrt(E))
    table = neg_rel_table(torch.from_numpy(rel_positional_table(T, E))).contiguous()
    lens = torch.tensor([T, T // 2 + 1] if lens is None else lens)
    pad = (torch.arange(T)[None] >= lens[:, None]).float()
    return qc, k, v, g, table, pad


def _k7_fwd(qc, k, v, g, table, pad, mm_content, mm_pos, mm_pv):
    """The plain K7 forward (``rel_fwd_plain``, fp32, no dropout) with its
    three products through hooks, the weighted sum taken on the
    unnormalised weights as the kernel takes it: (ctx (B, T, H, D), lse
    (B, H, T))."""
    cd = torch.float32
    tp = padded_time(T)
    padp = F.pad(pad, (0, tp - T), value=1.0)
    qch, kh, vh, gh = (fx._hm(fx._pad_rows(x, tp - T), cd) for x in (qc, k, v, g))
    tab = fx._pad_rows(table.float()[None], tp - T)[0]
    logits = (mm_content(qch, kh.transpose(-1, -2)) + mm_pos(gh, tab.T)) * SCALE
    logits = torch.where(padp[:, None, None, :] > 0.5, MASK_NEG, logits)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1)
    ctx = mm_pv(p, vh) / l[..., None]
    lse = m[..., 0] + torch.log(l)
    return ctx.permute(0, 2, 1, 3)[:, :T], lse[:, :, :T]


def _peaked(qc, k):
    """qc with query 20 of batch row 0 pointed at key 3: its logit leads
    the row's others by ~11, so that key carries nearly all the weight."""
    qc = qc.clone()
    qc[0, 20] = k[0, 3]
    return qc


def _errors(args, mms):
    """(max abs ctx error, max lse error relative to max(1, |lse|)) of the
    emulation against the plain version."""
    qc, k, v, g, table, pad = args
    ctx_ref, lse_ref = fr.rel_fwd_plain(qc, k, v, g, table, SCALE, pad > 0.5)
    ctx, lse = _k7_fwd(*args, *mms)
    return ((ctx - ctx_ref).abs().max().item(),
            ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item())


@pytest.fixture(scope="module", params=["seeded", "peaked row"])
def case(request):
    qc, k, v, g, table, pad = _inputs(seed=7)
    if request.param == "peaked row":
        qc = _peaked(qc, k)
    return qc, k, v, g, table, pad


def test_emulation_hook_is_the_plain_version(case):
    """With fp32 products the hooked formulas give the plain K7 forward."""
    err, lse_err = _errors(case, (mm_fp32,) * 3)
    assert err <= 1e-5 and lse_err <= 1e-6, (err, lse_err)


def test_3xtf32_in_every_product_holds_the_fp32_limits(case):
    err, lse_err = _errors(case, (mm_3xtf32,) * 3)
    assert err <= TOL and lse_err <= LSE_TOL, (err, lse_err)


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_product_in_any_product_misses_a_limit(product):
    """Each product alone in one TF32 product (the others in 3xTF32) misses
    the ctx or the lse limit at the seeded inputs or at the peaked row."""
    args = _inputs(seed=7)
    mms = [mm_3xtf32] * 3
    mms[PRODUCTS.index(product)] = mm_tf32
    worst = [0.0, 0.0]
    for qc in (args[0], _peaked(args[0], args[1])):
        worst = [max(w, e) for w, e in zip(worst, _errors((qc, *args[1:]), mms))]
    assert worst[0] > TOL or worst[1] > LSE_TOL, worst


def _row(qc, k, v, g, table, pad, b: int, n_keys: int, dtype):
    """Batch row b's softmax weights (H, T, n_keys), ctx (T, H, D) and lse
    (H, T) over its first n_keys keys only, in ``dtype`` (the dense formulas
    of ``rel_fwd_plain``)."""
    qch, gh = (x[b:b + 1].to(dtype).permute(0, 2, 1, 3) for x in (qc, g))
    kh, vh = (x[b:b + 1, :n_keys].to(dtype).permute(0, 2, 1, 3) for x in (k, v))
    logits = fr._logits(qch, kh, gh, table[:n_keys].to(dtype), SCALE)
    logits = torch.where(pad[b, :n_keys] > 0.5, MASK_NEG, logits)
    w = torch.softmax(logits, dim=-1)
    return w[0], torch.einsum("bhqk,bhkd->bqhd", w, vh)[0], torch.logsumexp(logits, dim=-1)[0]


def test_keys_after_the_last_live_key_weigh_nothing():
    """Rows of 150 (three 64-key tiles), 70 (two) and 1 (one) live keys
    with holes before the last: in fp32 every key after a row's last live
    key weighs exactly 0.0, and cutting those keys moves ctx and lse by at
    most 1e-7 (in fp64, where the sums' order is below that; in fp32 it
    moves the lse by a few ulps of reduction order); a row with no live
    key changes when its keys are cut to the first tile (its weights are
    uniform over all of them, so the kernel walks every tile there)."""
    T_long = 150
    qc, k, v, g, table, pad = _inputs(seed=9, B=4, T=T_long, lens=[T_long, 70, 1, 0])
    pad[0, 10:40:3] = 1.0
    pad[1, 5:60:7] = 1.0
    for b, last in ((0, T_long), (1, 70), (2, 1)):
        w, _, _ = _row(qc, k, v, g, table, pad, b, T_long, torch.float32)
        assert torch.all(w[..., last:] == 0.0), b
        _, ctx, lse = _row(qc, k, v, g, table, pad, b, T_long, torch.float64)
        _, c, l = _row(qc, k, v, g, table, pad, b, last, torch.float64)
        assert (c - ctx).abs().max().item() <= 1e-7, b
        assert (l - lse).abs().max().item() <= 1e-7, b
    _, ctx, _ = _row(qc, k, v, g, table, pad, 3, T_long, torch.float32)
    _, c, _ = _row(qc, k, v, g, table, pad, 3, 64, torch.float32)
    assert (c - ctx).abs().max().item() > 1e-3
