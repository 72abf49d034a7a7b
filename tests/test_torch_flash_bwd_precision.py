"""Why K3, the backward of the plain attention (the instance with no
position term of the tensor-core flash backward in
``viet_tts_torch/csrc/flash_xl_attention_bwd.cu``), multiplies fp32 streams
in 3xTF32 in all five of its products.

K3's Q1 forms the logits s = q k^T and dp = g v^T (D = 128 wide), then ds
and dq = ds k (over the keys); bwd-kv forms dk = ds^T q and dv = P^T g
(over the query rows) from Q1's ds and P = p m / keep. This test runs the
plain K3's dense formulas (``attention_bwd_dq_plain`` /
``attention_bwd_dkv_plain``) with each product emulated as the kernels form
it (the TF32 rounding and 3xTF32 split of
``tests/test_torch_xl_bwd_precision.py``), at the JETS width (2 heads of
128) and a small T, with a ragged batch row, at seeded inputs and with one
peaked row (one key leads its row's others by ~11 in the logit), with
attention dropout 0 and 0.2: 3xTF32 in every product holds dq, dk and dv
within the port's fp32 limit of 1e-4 of the fp32 plain version, and one
TF32 product in any one of the five misses it, so the kernels keep 3xTF32
in all five. No JAX here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_xl_bwd_precision import TOL, mm_3xtf32, mm_fp32, mm_tf32
from viet_tts_torch.ops import flash_attention as fa
from viet_tts_torch.ops.flash_attention import MASK_NEG, padded_time

B, T, H, D = 2, 40, 2, 128  # JETS: adim 256, 2 heads
SCALE = D ** -0.5
PRODUCTS = ("s = q k^T", "dp = g v^T", "dq = ds k", "dk = ds^T q", "dv = P^T g")
SEED = 987654321


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _k3_bwd(q, k, v, g, pad, lse, delta, dropout_p, mms):
    """The plain K3 backward (``_bwd_terms`` and the three contractions,
    fp32) with its five products through the hooks ``mms`` (in PRODUCTS'
    order): (dq, dk, dv) (B, T, H, D)."""
    mm_s, mm_dp, mm_dq, mm_dk, mm_dv = mms
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
    dead = pad[:, None, None, :] > 0.5
    s = mm_s(qh, kh.transpose(-1, -2)) * SCALE
    p = torch.exp(torch.where(dead, torch.full_like(s, MASK_NEG), s) - lse[..., None])
    p = torch.where(dead.all(dim=-1, keepdim=True), torch.full_like(p, 1.0 / padded_time(T)), p)
    dp = mm_dp(gh, vh.transpose(-1, -2))
    m = torch.ones_like(p)
    if dropout_p > 0.0:
        m = fa.dropout_keep_mask(SEED, B, H, T, T, dropout_p).float() / (1.0 - dropout_p)
    ds = torch.where(dead, torch.zeros_like(p), p * (dp * m - delta[..., None]) * SCALE)
    return (mm_dq(ds, kh).permute(0, 2, 1, 3),
            mm_dk(ds.transpose(-1, -2), qh).permute(0, 2, 1, 3),
            mm_dv((p * m).transpose(-1, -2), gh).permute(0, 2, 1, 3))


def _case(peaked: bool, dropout_p: float):
    """(the K3 arguments, the plain (dq, dk, dv)) at seeded inputs, a full
    and a ragged batch row, the plain forward's lse and a seeded
    cotangent; ``peaked``: query 20 of row 0 pointed at key 3."""
    rng = np.random.RandomState(7)
    q, k, v, gout = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
                     for _ in range(4))
    if peaked:
        q[0, 20] = k[0, 3]
    pad = (torch.arange(T)[None] >= torch.tensor([T, T // 2 + 1])[:, None]).float()
    ctx, lse = fa.attention_fwd_plain(q, k, v, SCALE, pad > 0.5, dropout_p, SEED)
    delta, g = fa.backward_inputs(ctx, gout, torch.float32)
    args = (q, k, v, g, pad, lse, delta)
    plain = (fa.attention_bwd_dq_plain(*args, SCALE, dropout_p, SEED),
             *fa.attention_bwd_dkv_plain(*args, SCALE, dropout_p, SEED))
    return args, plain


CASES = [(peaked, p) for peaked in (False, True) for p in (0.0, 0.2)]


def _err(case, mms) -> float:
    (args, plain), dropout_p = case
    got = _k3_bwd(*args, dropout_p, mms)
    return max((a - b).abs().max().item() for a, b in zip(got, plain))


@pytest.fixture(scope="module")
def cases():
    return {c: (_case(*c), c[1]) for c in CASES}


def test_emulation_hook_is_the_plain_version(cases):
    """With fp32 products the hooked formulas give the plain K3."""
    for c, case in cases.items():
        assert _err(case, (mm_fp32,) * 5) <= 1e-5, c


def test_3xtf32_in_every_product_holds_the_fp32_limit(cases):
    """dq, dk and dv within 1e-4 of the plain version in every case."""
    for c, case in cases.items():
        assert _err(case, (mm_3xtf32,) * 5) <= TOL, c


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_product_misses_the_limit(cases, product):
    """Each product alone in one TF32 product (the rest in 3xTF32) misses
    the limit in some case (the worst over the seeded and peaked rows,
    dropout 0 and 0.2)."""
    mms = [mm_3xtf32] * 5
    mms[PRODUCTS.index(product)] = mm_tf32
    worst = max(_err(case, mms) for case in cases.values())
    assert worst > TOL, (product, worst)
