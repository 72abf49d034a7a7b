"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on a
machine with only PyTorch:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from viet_tts_torch.nn.espnet_conformer import rel_positional_table
from viet_tts_torch.nn.utils import sinusoid_position_table
from viet_tts_torch.ops import flash_attention as fa
from viet_tts_torch.ops import flash_rel_attention as fr
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops import fused_mrf as fm
from viet_tts_torch.ops.espnet_attention import neg_rel_table, rel_pos_queries_latest
from viet_tts_torch.ops.xl_attention import xl_pos_queries, xl_pos_query_stream

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 1008, 45])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_matches_plain(cuda_device, T, dtype, atol):
    """K1 against the plain version on the same inputs, with a ragged and a
    fully padded row (fp32 within 1e-4, bf16 inputs within 2e-2)."""
    B, H, D = 3, 2, 128
    rng = np.random.RandomState(T)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    pad = torch.arange(T)[None] >= torch.tensor([T, T // 2 + 1, 0])[:, None]
    pad = pad.to(cuda_device)
    before = fa.attention_fwd.launches
    ctx, lse = fa.attention_fwd(q, k, v, D ** -0.5, pad)
    assert fa.attention_fwd.launches == before + 1
    ref_ctx, ref_lse = fa.attention_fwd_plain(q, k, v, D ** -0.5, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(ctx).all()
    assert (ctx - ref_ctx).abs().max().item() <= atol
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item() <= 1e-5


def _attention_case(device, T, dtype, seed):
    B, H, D = 3, 2, 128
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
                  .to(device, dtype) for _ in range(4))
    pad = torch.arange(T)[None] >= torch.tensor([T, T // 2 + 1, 0])[:, None]
    return q, k, v, g, pad.to(device), D ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 512, 45])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
def test_flash_training_kernels_match_plain(cuda_device, T, dtype, atol, dropout_p):
    """K1 with attention-weight dropout, then K3a (dq) and K3b (dk, dv) on
    the kernel's own ctx and lse, against the plain versions under the same
    seed, with a ragged and a fully padded row."""
    q, k, v, g, pad, scale = _attention_case(cuda_device, T, dtype, seed=T + 1)
    seed = 987654321012345
    ctx, lse = fa.attention_fwd(q, k, v, scale, pad, dropout_p, seed)
    ref_ctx, ref_lse = fa.attention_fwd_plain(q, k, v, scale, pad, dropout_p, seed)
    padf = pad.float()
    before = (fa.attention_bwd_dq.launches, fa.attention_bwd_dkv.launches)
    got = fa.attention_bwd(q, k, v, padf, ctx, lse, g, seed, scale, dropout_p)
    assert (fa.attention_bwd_dq.launches, fa.attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = fa.attention_bwd_plain(q, k, v, padf, ctx, lse, g, seed, scale, dropout_p)
    torch.cuda.synchronize()
    assert (ctx - ref_ctx).abs().max().item() <= atol
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item() <= 1e-5
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        assert (a - b).abs().max().item() <= atol, name


@pytest.mark.cuda
def test_flash_autograd_function_launches_the_kernels(cuda_device):
    """The public op on CUDA tensors: one K1 launch forward, one K3a and one
    K3b launch backward, and the gradients of the plain path on the same
    seed."""
    q, k, v, g, pad, scale = _attention_case(cuda_device, 96, torch.float32, seed=5)
    counts = (fa.attention_fwd.launches, fa.attention_bwd_dq.launches,
              fa.attention_bwd_dkv.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, scale, pad_mask=pad, dropout_p=0.2, dropout_seed=7)
    (out * g.reshape(out.shape)).sum().backward()
    assert (fa.attention_fwd.launches, fa.attention_bwd_dq.launches,
            fa.attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref, _ = fa.attention_fwd_plain(*ref_leaves, scale, pad, 0.2, 7)
    (ref.reshape(out.shape) * g.reshape(out.shape)).sum().backward()
    torch.cuda.synchronize()
    assert (out - ref.reshape(out.shape)).abs().max().item() <= 1e-4
    for a, b in zip(leaves, ref_leaves):
        assert (a.grad - b.grad).abs().max().item() <= 1e-4


def _flash_bwd_case(device, B, T, H, D, dtype, dropout_p, seed):
    """K3's arguments (q, k, v, g, pad, lse, delta, scale, dropout_p, seed)
    on K1's own lse and delta: ragged rows, the last fully padded."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    gout = torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(device)
    lens = torch.from_numpy(rng.randint(1, T + 1, B))
    lens[0], lens[-1] = T, 0
    pad = (torch.arange(T)[None] >= lens[:, None]).to(device)
    scale, drop_seed = D ** -0.5, 1000 * T + D
    ctx, lse = fa.attention_fwd(q, k, v, scale, pad, dropout_p, drop_seed)
    delta, g = fa.backward_inputs(ctx, gout, dtype)
    return q, k, v, g, pad.float(), lse, delta, scale, dropout_p, drop_seed


@pytest.mark.cuda
def test_flash_bwd_kernels_on_shared_scratches(cuda_device):
    """K3 as the backward template's instance with no position term, at
    every built head dim (32, 64, 128), fp32 (1e-4) and bf16 (2e-2),
    dropout 0 and 0.2, ragged rows with a fully padded one: the whole
    backward (Q1 with P, then bwd-kv on its scratches; one count each)
    equals the standalone ``attention_bwd_dq`` (Q1 without P) and
    ``attention_bwd_dkv`` bit for bit and holds against the plain versions;
    bwd-kv alone on one Q1's scratches holds against ``xl_bwd_kv_plain``
    there; the scratches hold the plain ds and p m / keep on the T real keys
    (a fully padded row's m / Tp included) and 0 from T to the end of the
    last 64-key tile."""
    B, T, H = 3, 200, 2
    for D in (32, 64, 128):
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            for p in (0.0, 0.2):
                case = f"D={D} {dtype} dropout={p}"
                args = _flash_bwd_case(cuda_device, B, T, H, D, dtype, p, seed=D + int(10 * p))
                q, k, v, g, pad, lse, delta, scale = args[:8]
                ops = fa._bwd_ops(q, k, v, g, pad, lse, delta)
                before = (fa.attention_bwd_dq.launches, fa.attention_bwd_dkv.launches)
                dq, s, pm = fa._bwd_q1(*ops, scale, p, args[9], with_p=True)
                whole = (dq, *fa._bwd_kv(ops[0], ops[3], s, pm))
                alone = (fa.attention_bwd_dq(*args), *fa.attention_bwd_dkv(*args))
                assert (fa.attention_bwd_dq.launches, fa.attention_bwd_dkv.launches) == (
                    before[0] + 1, before[1] + 1), case
                want = (fa.attention_bwd_dq_plain(*args), *fa.attention_bwd_dkv_plain(*args))
                kv_plain = fx.xl_bwd_kv_plain(ops[0], ops[3], s, pm)
                _, _, _, p_v, ds = fa._bwd_terms(q, k, v, g, pad, lse, delta, scale, p, args[9])
                torch.cuda.synchronize()
                for name, a, b, ref in zip(("dq", "dk", "dv"), whole, alone, want):
                    assert torch.isfinite(a).all(), (case, name)
                    assert torch.equal(a, b), (case, name)
                    assert (a - ref).abs().max().item() <= atol, (case, name)
                for name, a, ref in zip(("dk", "dv"), whole[1:], kv_plain):
                    assert (a - ref).abs().max().item() <= atol, (case, "kv alone", name)
                edge = -(-T // 64) * 64
                for name, x, ref in (("ds", s, ds), ("p m / keep", pm, p_v)):
                    assert (x[..., :T] - ref).abs().max().item() <= atol, (case, name)
                    assert not x[..., T:edge].any(), (case, name)


@pytest.mark.cuda
def test_flash_bwd_kernels_past_a_wave(cuda_device):
    """K3 on a grid past one wave of the card (B H = 64 at T = 1008: 1,024
    blocks of Q1 and of bwd-kv), fp32 and bf16, dropout 0.2, against the
    plain versions (a short row's dk and dv reach ~50 there: bwd-kv's chunk
    sums keep its 1008-row contraction within the fp32 limit)."""
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args = _flash_bwd_case(cuda_device, 32, 1008, 2, 128, dtype, 0.2, seed=64)
        got = (fa.attention_bwd_dq(*args), *fa.attention_bwd_dkv(*args))
        want = (fa.attention_bwd_dq_plain(*args), *fa.attention_bwd_dkv_plain(*args))
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a).all(), (dtype, name)
            err = (a - b).abs().max().item()
            assert err <= atol, (dtype, name, err, b.abs().max().item())
        del got, want


def _mrf_weights(C, device, seed):
    rng = np.random.RandomState(seed)
    out = ([], [], [], [])
    for k, d in zip(KS, DILS):
        std = 1.0 / np.sqrt(k * C)
        for i, shape in enumerate([(len(d), k, C, C), (len(d), C)] * 2):
            scale = std if len(shape) == 4 else 0.1
            out[i].append(torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).to(device))
    return tuple(tuple(w) for w in out)


@pytest.mark.cuda
@pytest.mark.parametrize("C,seq_len", [(64, 4096), (32, 3000), (16, 1)])
def test_fused_mrf_kernel_matches_plain(cuda_device, C, seq_len):
    """K2 against the plain version (TF32 off), 9 launches a stage (one a
    (block, dilation) pair), zeros past seq_len: at the item's seq_len, on
    and beside a tile edge of the k = 11 pair (its tile is ``tile_rows(C) -
    10`` rows) and of the k = 3 pair, at B = 1 with T not a multiple of the
    tile, and with a bf16 input (within 2e-2)."""
    TT = fm.tile_rows(C)
    ws = _mrf_weights(C, cuda_device, seed=C)
    # (B, T, seq_len, dtype, limit)
    cases = [(2, 4096, seq_len, torch.float32, 1e-4),
             (2, 4096, TT - 10, torch.float32, 1e-4),
             (2, 4096, TT - 9, torch.float32, 1e-4),
             (2, 4096, 2 * (TT - 2), torch.float32, 1e-4),
             (1, 3 * TT + 77, 2 * TT - 5, torch.float32, 1e-4),
             (1, 3 * TT + 77, 3 * TT + 77, torch.float32, 1e-4),
             (2, 4096, seq_len, torch.bfloat16, 2e-2)]
    for B, T, n, dtype, limit in cases:
        x = torch.from_numpy(np.random.RandomState(C + T).randn(B, T, C).astype(np.float32))
        x = x.to(cuda_device, dtype)
        before = fm.fused_mrf_stage.launches
        got = fm.fused_mrf_stage(x, n, *ws, kernel_sizes=KS, dilations=DILS)
        assert fm.fused_mrf_stage.launches == before + 9
        want = fm.fused_mrf_stage_plain(x, n, *ws, kernel_sizes=KS, dilations=DILS)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert not got[:, n:].any(), (B, T, n, dtype)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= limit, (B, T, n, dtype, err)


def xl_case(device, B, T, H=8, D=48, seed=0, pad_rows=True):
    """The three XL parameterisations of one attention (fp32, on device):
    qc, k, v, qv (B, T, H, D), p (T, H, D), g, gA, gB (B, T, H, E) and the
    table (T, E), E = H * D, with the conformer's scales; pad_mask with a
    full, a ragged and a fully padded row (or None)."""
    E = H * D
    rng = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    u, vb = 0.3 * f(H, D), 0.3 * f(H, D)
    pos_kernel = f(E, E) / np.sqrt(E)
    table = torch.from_numpy(sinusoid_position_table(T, E)).to(device)
    qv = q + vb
    gA, gB = xl_pos_queries(qv, pos_kernel)
    streams = dict(qc=q + u, k=k, v=v, qv=qv, p=(table @ pos_kernel).reshape(T, H, D),
                   g=xl_pos_query_stream(qv, pos_kernel), gA=gA, gB=gB, table=table)
    pad = None
    if pad_rows:
        lens = torch.tensor([T, T // 2 + 1, 0][:B] + [T] * max(B - 3, 0))
        pad = (torch.arange(T)[None] >= lens[:, None]).to(device)
    return streams, pad, 1.0 / np.sqrt(E)


XL_KERNELS = {
    "xl3": (fx.xl3_fwd, fx.xl3_fwd_plain, ("qc", "k", "v", "qv", "p")),
    "xl2": (fx.xl2_fwd, fx.xl2_fwd_plain, ("qc", "k", "v", "g", "table")),
    "xl": (fx.xl_fwd, fx.xl_fwd_plain, ("qc", "k", "v", "gA", "gB", "table")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T", [("xl3", 64), ("xl3", 45), ("xl3", 300), ("xl3", 512),
                                    ("xl2", 540), ("xl2", 1008), ("xl", 1100)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pad_rows", [True, False])
def test_xl_kernels_match_plain(cuda_device, kind, T, dtype, atol, pad_rows):
    """K4 (xl3), K5 (xl2) and K6 (xl) against their plain versions on the
    same inputs: ragged rows and a fully padded one, or no pad mask; fp32
    within 1e-4 (TF32 off), bf16 streams within 2e-2; the logsumexp within
    rel 1e-5 in fp32 and 1e-3 in bf16 (K5 rounds its rotated stream to bf16,
    and a one-ulp difference between the kernel's sincosf and the plain
    version's sin / cos can flip that rounding)."""
    streams, pad, scale = xl_case(cuda_device, 3, T, seed=T, pad_rows=pad_rows)
    fwd, plain, names = XL_KERNELS[kind]
    args = [streams[n].to(dtype) for n in names]
    before = fwd.launches
    ctx, lse = fwd(*args, scale, pad)
    assert fwd.launches == before + 1
    ref, ref_lse = plain(*args, scale, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(ctx).all()
    assert (ctx - ref).abs().max().item() <= atol
    lse_tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item() <= lse_tol


@pytest.mark.cuda
def test_xl_routes_agree_on_the_card(cuda_device):
    """The three kernels compute one function: at T=300 (fp32) K5 and K6
    agree with K4 on the real rows (the fully padded row differs by design:
    xl3 averages over T keys, xl2 / xl over the 32-padded length)."""
    T = 300
    streams, pad, scale = xl_case(cuda_device, 3, T, seed=11)
    s = streams
    c3, _ = fx.xl3_fwd(s["qc"], s["k"], s["v"], s["qv"], s["p"], scale, pad)
    c2, _ = fx.xl2_fwd(s["qc"], s["k"], s["v"], s["g"], s["table"], scale, pad)
    c1, _ = fx.xl_fwd(s["qc"], s["k"], s["v"], s["gA"], s["gB"], s["table"], scale, pad)
    torch.cuda.synchronize()
    assert (c2[:2] - c3[:2]).abs().max().item() <= 1e-4
    assert (c1[:2] - c3[:2]).abs().max().item() <= 1e-4


XL_TRAIN_CASES = [("xl3", 64), ("xl3", 45), ("xl3", 300), ("xl2", 100), ("xl2", 540)]
XL_TRAIN_FNS = {  # kind: (stream names, forward, plain forward, backward pairs)
    "xl3": (("qc", "k", "v", "qv", "p"), fx.xl3_fwd, fx.xl3_fwd_plain,
            [(fx.xl3_bwd, fx.xl3_bwd_plain, {})]),
    "xl2": (("qc", "k", "v", "g", "table"), fx.xl2_fwd, fx.xl2_fwd_plain,
            [(fx.xl2_bwd_dq, fx.xl2_bwd_dq_plain, {}),
             (fx.xl2_bwd_dkv, fx.xl2_bwd_dkv_plain, {"want_dtab": True})]),
}


XL_BWD_FNS = {  # kind: (whole backward, bwd-q, bwd-kv, checked operands, K5's rotation)
    "xl2": (fx.xl2_bwd, fx.xl2_bwd_dq, fx.xl2_bwd_dkv, fx._xl2_ops, True),
    "xl": (fx.xl_bwd, fx.xl_bwd_dq, fx.xl_bwd_dkv, fx._xl_ops, False),
}


def _check_bwd_split(kind, bwd_args, atol):
    """K5 / K6's split backward on the card, for one case: the whole
    backward (``xl2_bwd`` / ``xl_bwd``: one count each on bwd-q and bwd-kv)
    against the separate calls, bit for bit (the same deterministic kernels
    on the same inputs), with the table's gradient and without; the bwd-kv
    and dtab kernels alone against their plain version (``xl_bwd_kv_plain``)
    on Q1's own scratches, each within atol scaled by its largest value
    where that exceeds 1; and the scratches against the plain ds and p m /
    keep on the T real keys (a fully padded row's m / Tp included), and 0
    from T to the end of the last 64-key tile."""
    whole, dq, dkv, ops_of, rotate = XL_BWD_FNS[kind]
    *streams, pad, lse, delta, g, scale, p, seed = bwd_args
    for want_dtab in (True, False):
        before = (dq.launches, dkv.launches)
        got = whole(*bwd_args, want_dtab=want_dtab)
        assert (dq.launches, dkv.launches) == (before[0] + 1, before[1] + 1)
        q_out, kv_out = dq(*bwd_args), dkv(*bwd_args, want_dtab=want_dtab)
        for i, (a, b) in enumerate(zip(got, (q_out[0], *kv_out[:2], *q_out[1:], kv_out[2]))):
            assert (a is None) == (b is None), (kind, i, want_dtab)
            assert a is None or torch.equal(a, b), (kind, i, want_dtab)
        assert (got[-1] is None) == (not want_dtab)
    ops = ops_of(*streams, pad, lse, delta, g)
    _, s, pm, (ga, gb) = fx._bwd_q1(rotate, *ops, scale, p, seed, True)
    got = (*fx._bwd_kv(ops[0], ops[9], s, pm), fx._bwd_dtab(s, ga, gb))
    want = fx.xl_bwd_kv_plain(ops[0], ops[9], s, pm, ga, gb, want_dtab=True)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), (kind, i)
        err = (a - b).abs().max().item()
        assert err <= atol * max(1.0, b.abs().max().item()), (kind, "kv alone", i, err)
    T = ops[0].shape[1]
    if rotate:
        p_v, ds = fx._xl2_bwd_terms(*bwd_args)[7:9]
    else:
        cd = fx._compute_dtype(ops[0])
        p_v, ds = fx._xl_bwd_terms(*streams[:3], *(fx._hm(x, cd) for x in streams[3:5]),
                                   *bwd_args[5:])[4:6]
    edge = -(-T // 64) * 64
    for name, x, ref in (("ds", s, ds), ("p m / keep", pm, p_v)):
        err = (x[..., :T] - ref[..., :T]).abs().max().item()
        assert err <= atol * max(1.0, ref.abs().max().item()), (kind, name, err)
        assert not x[..., T:edge].any(), (kind, name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T", XL_TRAIN_CASES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_xl_training_kernels_match_plain(cuda_device, kind, T, dtype, atol, dropout_p):
    """K4 / K5 forward with attention-weight dropout against the plain
    forward, then K4 bwd (dqc, dk, dv, dqv, dp) or K5 bwd-q (dqc, dg2) and
    bwd-kv (dk, dv, dtab) against their plain versions on the kernel's own
    context and lse (so that a bf16 rounding of the forward cannot move the
    gradients' reference), under one seed, with a ragged and a fully padded
    row; each gradient within atol of the plain one, scaled by its largest
    value where that exceeds 1. K5 also ``_check_bwd_split``, with that pad
    mask and with none."""
    streams, pad, scale = xl_case(cuda_device, 3, T, seed=T + 7)
    names, fwd, plain_fwd, bwds = XL_TRAIN_FNS[kind]
    seed = 123456789012345
    args = [streams[n].to(dtype) for n in names]
    ctx, lse = fwd(*args, scale, pad, dropout_p, seed)
    ref_ctx, _ = plain_fwd(*args, scale, pad, dropout_p, seed)
    gout = torch.from_numpy(np.random.RandomState(3).randn(*ctx.shape).astype(np.float32))
    delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), dtype)
    bwd_args = (*args, pad.float(), lse, delta, g, scale, dropout_p, seed)
    torch.cuda.synchronize()
    assert (ctx - ref_ctx).abs().max().item() <= atol
    for kern, plain, kw in bwds:
        before = kern.launches
        got = kern(*bwd_args, **kw)
        assert kern.launches == before + 1
        want = plain(*bwd_args, **kw)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, (kern.__name__, i)
            assert torch.isfinite(a).all(), (kern.__name__, i)
            err = (a - b).abs().max().item()
            assert err <= atol * max(1.0, b.abs().max().item()), (kern.__name__, i, err)
    if kind == "xl2":
        _check_bwd_split(kind, bwd_args, atol)
        ctx, lse = fwd(*args, scale, None, dropout_p, seed)
        delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), dtype)
        _check_bwd_split(kind, (*args, torch.zeros_like(pad, dtype=torch.float32), lse, delta, g,
                                scale, dropout_p, seed), atol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T", [("xl3", 200), ("xl2", 600)])
def test_xl_autograd_functions_launch_the_kernels(cuda_device, kind, T):
    """The public ops on CUDA tensors that need gradients: one forward and
    one backward launch per kernel (K4 fwd + K4 bwd; K5 fwd + bwd-q +
    bwd-kv), and the gradients of autograd through the plain versions on
    the same seed. The table of xl2 needs no gradient: dtab is skipped."""
    streams, pad, scale = xl_case(cuda_device, 3, T, seed=T)
    names = ("qc", "k", "v", "qv", "p") if kind == "xl3" else ("qc", "k", "v", "g", "table")
    fns = ((fx.xl3_fwd, fx.xl3_bwd) if kind == "xl3"
           else (fx.xl2_fwd, fx.xl2_bwd_dq, fx.xl2_bwd_dkv))
    public = fx.flash_xl3_attention if kind == "xl3" else fx.flash_xl2_attention
    plain = fx.xl3_fwd_plain if kind == "xl3" else fx.xl2_fwd_plain
    n_grad = 5 if kind == "xl3" else 4
    counts = [f.launches for f in fns]
    leaves = [streams[n].clone().requires_grad_(i < n_grad) for i, n in enumerate(names)]
    out = public(*leaves, scale, pad_mask=pad, dropout_p=0.1, dropout_seed=11)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(out.device)
    (out * gout).sum().backward()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    ref_leaves = [streams[n].clone().requires_grad_(i < n_grad) for i, n in enumerate(names)]
    ref, _ = plain(*ref_leaves, scale, pad, 0.1, 11)
    (ref.reshape(out.shape) * gout).sum().backward()
    torch.cuda.synchronize()
    assert (out - ref.reshape(out.shape)).abs().max().item() <= 1e-4
    for name, a, b in zip(names[:n_grad], leaves, ref_leaves):
        err = (a.grad - b.grad).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.grad.abs().max().item()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 300])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pad_rows", [True, False])
def test_xl_kernel_k6_at_the_jets_width(cuda_device, T, dtype, atol, pad_rows):
    """K6 at D = 128, E = 256 (the JETS conformer's legacy rel-pos route,
    2 heads of adim 256) against its plain version."""
    streams, pad, scale = xl_case(cuda_device, 3, T, H=2, D=128, seed=T + 2,
                                  pad_rows=pad_rows)
    fwd, plain, names = XL_KERNELS["xl"]
    args = [streams[n].to(dtype) for n in names]
    before = fwd.launches
    ctx, lse = fwd(*args, scale, pad)
    assert fwd.launches == before + 1
    ref, _ = plain(*args, scale, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(ctx).all()
    assert (ctx - ref).abs().max().item() <= atol


# (B, T, H, D): the JETS legacy rel-pos training shapes (E = 256) and the
# FS2 decoder past the xl2 route (E = 384)
XL_K6_TRAIN_CASES = [(8, 64, 2, 128), (8, 512, 2, 128), (4, 2048, 8, 48)]
XL_NAMES = ("qc", "k", "v", "gA", "gB", "table")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,D", XL_K6_TRAIN_CASES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pad_rows", [True, False])
def test_xl_k6_training_kernels_match_plain(cuda_device, B, T, H, D, dtype, atol, pad_rows):
    """K6 forward with attention-weight dropout 0.2 against the plain
    forward, then K6 bwd-q (dqc, dgA, dgB) and bwd-kv (dk, dv, and dtab with
    ``want_dtab``) against their plain versions on the kernel's own context
    and lse, under one seed, with a ragged and a fully padded row or no pad
    mask; each gradient within atol of the plain one, scaled by its largest
    value where that exceeds 1. Then ``_check_bwd_split`` at dropout 0.2
    and 0."""
    streams, pad, scale = xl_case(cuda_device, B, T, H=H, D=D, seed=T + D, pad_rows=pad_rows)
    p, seed = 0.2, 987654321
    args = [streams[n].to(dtype) for n in XL_NAMES]
    before = fx.xl_fwd.launches
    ctx, lse = fx.xl_fwd(*args, scale, pad, p, seed)
    assert fx.xl_fwd.launches == before + 1
    ref_ctx, _ = fx.xl_fwd_plain(*args, scale, pad, p, seed)
    torch.cuda.synchronize()
    assert torch.isfinite(ctx).all()
    assert (ctx - ref_ctx).abs().max().item() <= atol
    del ref_ctx
    gout = torch.from_numpy(np.random.RandomState(T).randn(*ctx.shape).astype(np.float32))
    delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), dtype)
    padf = pad.float() if pad is not None else torch.zeros(B, T, device=cuda_device)
    bwd_args = (*args, padf, lse, delta, g, scale, p, seed)
    for kern, plain, kw in ((fx.xl_bwd_dq, fx.xl_bwd_dq_plain, {}),
                            (fx.xl_bwd_dkv, fx.xl_bwd_dkv_plain, {"want_dtab": True})):
        before = kern.launches
        got = kern(*bwd_args, **kw)
        assert kern.launches == before + 1
        want = plain(*bwd_args, **kw)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, (kern.__name__, i)
            assert torch.isfinite(a).all(), (kern.__name__, i)
            err = (a - b).abs().max().item()
            assert err <= atol * max(1.0, b.abs().max().item()), (kern.__name__, i, err)
        del got, want
    _check_bwd_split("xl", bwd_args, atol)
    ctx, lse = fx.xl_fwd(*args, scale, pad, 0.0, seed)
    delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), dtype)
    _check_bwd_split("xl", (*args, padf, lse, delta, g, scale, 0.0, seed), atol)


# (kind, H, D): K5 at (D, E) = (48, 384) and (64, 512), K6 at those and
# (128, 256); E = H * D
XL_BWD_Q_WIDTHS = [("xl2", 8, 48), ("xl2", 8, 64), ("xl", 8, 48), ("xl", 8, 64),
                   ("xl", 2, 128)]
XL_BWD_Q_FNS = {  # kind: (stream names, forward, bwd-q, plain bwd-q)
    "xl2": (("qc", "k", "v", "g", "table"), fx.xl2_fwd, fx.xl2_bwd_dq, fx.xl2_bwd_dq_plain),
    "xl": (XL_NAMES, fx.xl_fwd, fx.xl_bwd_dq, fx.xl_bwd_dq_plain),
}


# (dtype, atol, dropout_p, pad_rows): the cases each tensor-core test runs
# at every (width, T), in a loop inside one test, so that a run without a
# card collects (and skips) few items
XL_TC_CASES = [(dtype, atol, p, pad_rows)
               for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
               for p in (0.0, 0.1) for pad_rows in (True, False)]
XL_TC_LENGTHS = [45, 63, 65, 127, 129, 1008, 1040, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H,D", XL_BWD_Q_WIDTHS)
@pytest.mark.parametrize("T", XL_TC_LENGTHS)
def test_xl_bwd_q_tensor_core_kernels_match_plain(cuda_device, kind, H, D, T):
    """K5 / K6 bwd-q (the tensor-core kernels: position logits, ds and dqc,
    then dgA / dgB) against their plain versions on the kernel forward's
    lse, at lengths that are not multiples of the 64-row tiles (K5's row
    shift of dgB crosses every tile boundary), each accepted head width,
    for every case of ``XL_TC_CASES`` (fp32 and bf16, dropout 0 and 0.1, a
    ragged and a fully padded row or no pad mask); each gradient within
    atol of the plain one, scaled by its largest value where that exceeds
    1; one launch count a call. Each case also ``_check_bwd_split`` (the
    bwd-kv and dtab kernels at these lengths and widths)."""
    B = 3
    names, fwd, kern, plain = XL_BWD_Q_FNS[kind]
    seed = 24681357 + T
    inputs = {pr: xl_case(cuda_device, B, T, H=H, D=D, seed=T + D + 1, pad_rows=pr)
              for pr in (True, False)}
    for dtype, atol, dropout_p, pad_rows in XL_TC_CASES:
        case = (str(dtype), dropout_p, pad_rows)
        streams, pad, scale = inputs[pad_rows]
        args = [streams[n].to(dtype) for n in names]
        ctx, lse = fwd(*args, scale, pad, dropout_p, seed)
        gout = torch.from_numpy(np.random.RandomState(T + 5).randn(*ctx.shape)
                                .astype(np.float32))
        delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), dtype)
        padf = pad.float() if pad is not None else torch.zeros(B, T, device=cuda_device)
        bwd_args = (*args, padf, lse, delta, g, scale, dropout_p, seed)
        before = kern.launches
        got = kern(*bwd_args)
        assert kern.launches == before + 1, case
        want = plain(*bwd_args)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, (case, i)
            assert torch.isfinite(a).all(), (case, i)
            err = (a - b).abs().max().item()
            assert err <= atol * max(1.0, b.abs().max().item()), (case, i, err)
        del got, want
        _check_bwd_split(kind, bwd_args, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["xl2", "xl"])
def test_xl_bwd_q_takes_batch_times_heads_past_one_grid_dimension(cuda_device, kind):
    """B * H = 65536, beyond a grid's y and z limit of 65535: the wrappers
    take B and H below 2^16 each, and so do the bwd-q kernels."""
    B, T, H = 8192, 5, 8
    streams, pad, scale = xl_case(cuda_device, B, T, H=H, seed=3, pad_rows=False)
    names, fwd, kern, plain = XL_BWD_Q_FNS[kind]
    args = [streams[n] for n in names]
    ctx, lse = fwd(*args, scale, pad, 0.1, 11)
    gout = torch.from_numpy(np.random.RandomState(4).randn(*ctx.shape).astype(np.float32))
    delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), torch.float32)
    bwd_args = (*args, torch.zeros(B, T, device=cuda_device), lse, delta, g, scale, 0.1, 11)
    got, want = kern(*bwd_args), plain(*bwd_args)
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.abs().max().item()), (i, err)


XL_FWD_FNS = {  # kind: (stream names, forward, plain forward)
    "xl2": (("qc", "k", "v", "g", "table"), fx.xl2_fwd, fx.xl2_fwd_plain),
    "xl": (XL_NAMES, fx.xl_fwd, fx.xl_fwd_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H,D", XL_BWD_Q_WIDTHS)
@pytest.mark.parametrize("T", XL_TC_LENGTHS)
def test_xl_fwd_tensor_core_kernel_matches_plain(cuda_device, kind, H, D, T):
    """K5 / K6 forward (the tensor-core kernel; K5 after its rotation pass)
    against the plain versions under one seed, at lengths that are not
    multiples of the 64-row tiles (the diagonal tile and the last key tile
    are partial), each accepted head width, for every case of
    ``XL_TC_CASES``: ctx within atol, lse within rel 1e-5 in fp32 and 1e-3
    in bf16 (a one-ulp sincosf difference can flip K5's bf16 rounding of
    its rotated stream); one launch count a call."""
    B = 3
    names, fwd, plain = XL_FWD_FNS[kind]
    seed = 13572468 + T
    inputs = {pr: xl_case(cuda_device, B, T, H=H, D=D, seed=T + D + 2, pad_rows=pr)
              for pr in (True, False)}
    for dtype, atol, dropout_p, pad_rows in XL_TC_CASES:
        case = (str(dtype), dropout_p, pad_rows)
        streams, pad, scale = inputs[pad_rows]
        args = [streams[n].to(dtype) for n in names]
        before = fwd.launches
        ctx, lse = fwd(*args, scale, pad, dropout_p, seed)
        assert fwd.launches == before + 1, case
        ref, ref_lse = plain(*args, scale, pad, dropout_p, seed)
        torch.cuda.synchronize()
        assert torch.isfinite(ctx).all() and torch.isfinite(lse).all(), case
        err = (ctx - ref).abs().max().item()
        assert err <= atol, (case, err)
        lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
        assert lse_err <= (1e-5 if dtype == torch.float32 else 1e-3), (case, lse_err)
        del ctx, ref


@pytest.mark.cuda
@pytest.mark.parametrize("D", [48, 64])
def test_xl_k5_dropout_mask_is_the_plain_mask_bit_for_bit(cuda_device, D):
    """With v the identity, K5's context is the dropped weights themselves:
    its zeros are exactly where ``dropout_keep_mask`` drops; with one-hot
    cotangent rows, bwd-kv's dv is the dropped weights transposed, with the
    same zeros. The last batch row's keys are all padding: its weights are
    the uniform m / Tp (bwd-kv's from the scratch Q1 writes)."""
    B, T, H, p, seed = 3, 64, 8, 0.2, 78
    streams, _, scale = xl_case(cuda_device, B, T, H=H, D=D, seed=6, pad_rows=False)
    eye = torch.eye(T, D, device=cuda_device)[None, :, None, :].expand(B, T, H, D).contiguous()
    args = [streams["qc"], streams["k"], eye, streams["g"], streams["table"]]
    pad = torch.zeros(B, T, device=cuda_device)
    pad[-1] = 1.0
    ctx, lse = fx.xl2_fwd(*args, scale, pad > 0.5, p, seed)
    keep = fa.dropout_keep_mask(seed, B, H, T, T, p, cuda_device)  # (B, H, i, j)
    torch.cuda.synchronize()
    n = min(T, D)
    assert torch.equal(ctx[..., :n].permute(0, 2, 1, 3) != 0, keep[..., :n])
    delta, g = fa.backward_inputs(ctx, eye, torch.float32)
    _, dv, _ = fx.xl2_bwd_dkv(*args, pad, lse, delta, g, scale, p, seed)
    torch.cuda.synchronize()
    assert torch.equal(dv[..., :n].permute(0, 2, 3, 1) != 0, keep[:, :, :n])
    uniform = dv[-1][..., :n]
    assert torch.allclose(uniform[uniform != 0],
                          torch.tensor(1.0 / ((1.0 - p) * fa.padded_time(T)), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("H,D", [(8, 48), (2, 128)])
def test_xl_k6_dropout_mask_is_the_plain_mask_bit_for_bit(cuda_device, H, D):
    """With v the identity, K6's context is the dropped weights themselves:
    its zeros are exactly where ``dropout_keep_mask`` drops (the two-stream
    tiles draw the keep bit of the same (b, h, i, j) as the plain version);
    with one-hot cotangent rows, bwd-kv's dv is the dropped weights
    transposed, with the same zeros. The last batch row's keys are all
    padding: its weights are the uniform m / Tp."""
    T, p, seed = 64, 0.2, 77
    streams, _, scale = xl_case(cuda_device, 3, T, H=H, D=D, seed=5, pad_rows=False)
    B = 3
    eye = torch.eye(T, D, device=cuda_device)[None, :, None, :].expand(B, T, H, D).contiguous()
    args = [streams["qc"], streams["k"], eye, streams["gA"], streams["gB"], streams["table"]]
    pad = torch.zeros(B, T, device=cuda_device)
    pad[-1] = 1.0
    ctx, lse = fx.xl_fwd(*args, scale, pad > 0.5, p, seed)
    keep = fa.dropout_keep_mask(seed, B, H, T, T, p, cuda_device)  # (B, H, i, j)
    torch.cuda.synchronize()
    n = min(T, D)
    assert torch.equal(ctx[..., :n].permute(0, 2, 1, 3) != 0, keep[..., :n])
    delta, g = fa.backward_inputs(ctx, eye, torch.float32)
    _, dv, _ = fx.xl_bwd_dkv(*args, pad, lse, delta, g, scale, p, seed)
    torch.cuda.synchronize()
    assert torch.equal(dv[..., :n].permute(0, 2, 3, 1) != 0, keep[:, :, :n])
    uniform = dv[-1][..., :n]
    assert torch.allclose(uniform[uniform != 0],
                          torch.tensor(1.0 / ((1.0 - p) * fa.padded_time(T)), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,D", [(300, 2, 128), (1100, 8, 48)])
def test_xl_k6_autograd_function_launches_the_kernels(cuda_device, T, H, D):
    """The public two-stream op on CUDA tensors that need gradients (the
    table too): one K6 forward, bwd-q and bwd-kv launch each, and the
    gradients of autograd through the plain forward on the same seed."""
    streams, pad, scale = xl_case(cuda_device, 3, T, H=H, D=D, seed=T)
    fns = (fx.xl_fwd, fx.xl_bwd_dq, fx.xl_bwd_dkv)
    counts = [f.launches for f in fns]
    leaves = [streams[n].clone().requires_grad_() for n in XL_NAMES]
    out = fx.flash_xl_attention(*leaves, scale, pad_mask=pad, dropout_p=0.2, dropout_seed=5)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(out.device)
    (out * gout).sum().backward()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    ref_leaves = [streams[n].clone().requires_grad_() for n in XL_NAMES]
    ref, _ = fx.xl_fwd_plain(*ref_leaves, scale, pad, 0.2, 5)
    (ref.reshape(out.shape) * gout).sum().backward()
    torch.cuda.synchronize()
    assert (out - ref.reshape(out.shape)).abs().max().item() <= 1e-4
    for name, a, b in zip(XL_NAMES, leaves, ref_leaves):
        err = (a.grad - b.grad).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.grad.abs().max().item()), (name, err)


def rel_case(device, B, T, H=2, D=128, seed=0, pad_rows=True):
    """One espnet 'latest' rel-pos attention at the JETS width (fp32, on
    device): qc, k, v (B, T, H, D), the rotated position queries g
    (B, T, H, E) and the negative half of the symmetric table (T, E),
    E = H * D; pad_mask with a full, a ragged and a fully padded row (or
    None)."""
    E = H * D
    rng = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    u, w = 0.3 * f(H, D), 0.3 * f(H, D)
    pos_kernel = f(E, E) / np.sqrt(E)
    sym = torch.from_numpy(rel_positional_table(T, E)).to(device)
    streams = dict(qc=q + u, k=k, v=v, g=rel_pos_queries_latest(q + w, pos_kernel),
                   table=neg_rel_table(sym).contiguous())
    pad = None
    if pad_rows:
        lens = torch.tensor([T, T // 2 + 1, 0][:B] + [T] * max(B - 3, 0))
        pad = (torch.arange(T)[None] >= lens[:, None]).to(device)
    return streams, pad, D ** -0.5


REL_NAMES = ("qc", "k", "v", "g", "table")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 45, 300])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pad_rows", [True, False])
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
def test_rel_kernels_match_plain(cuda_device, T, dtype, atol, pad_rows, dropout_p):
    """K7 forward with attention-weight dropout against the plain forward,
    then K7 bwd-q (dqc, dg) and bwd-kv (dk, dv, dtable) against their plain
    versions on the kernel's own context and lse, under one seed, with a
    ragged and a fully padded row or no pad mask; each within atol of the
    plain one, scaled by its largest value where that exceeds 1."""
    streams, pad, scale = rel_case(cuda_device, 3, T, seed=T + 9, pad_rows=pad_rows)
    args = [streams[n].to(dtype) for n in REL_NAMES]
    seed = 246813579024681
    before = [f.launches for f in (fr.rel_fwd, fr.rel_bwd_dq, fr.rel_bwd_dkv)]
    ctx, lse = fr.rel_fwd(*args, scale, pad, dropout_p, seed)
    ref_ctx, ref_lse = fr.rel_fwd_plain(*args, scale, pad, dropout_p, seed)
    gout = torch.from_numpy(np.random.RandomState(4).randn(*ctx.shape).astype(np.float32))
    delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), dtype)
    padf = pad.float() if pad is not None else torch.zeros(3, T, device=cuda_device)
    bwd_args = (*args, padf, lse, delta, g, scale, dropout_p, seed)
    got = [*fr.rel_bwd_dq(*bwd_args), *fr.rel_bwd_dkv(*bwd_args, want_dtab=True)]
    assert [f.launches for f in (fr.rel_fwd, fr.rel_bwd_dq, fr.rel_bwd_dkv)] == [
        c + 1 for c in before]
    want = [*fr.rel_bwd_dq_plain(*bwd_args), *fr.rel_bwd_dkv_plain(*bwd_args, want_dtab=True)]
    torch.cuda.synchronize()
    assert torch.isfinite(ctx).all()
    assert (ctx - ref_ctx).abs().max().item() <= atol
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item() <= 1e-5
    for name, a, b in zip(("dqc", "dg", "dk", "dv", "dtable"), got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= atol * max(1.0, b.abs().max().item()), (name, err)


@pytest.mark.cuda
def test_rel_dropout_mask_is_the_plain_mask_bit_for_bit(cuda_device):
    """With v the identity, K7's context is the dropped weights themselves:
    its zeros are exactly where ``dropout_keep_mask`` drops; with one-hot
    cotangent rows, bwd-kv's dv is the dropped weights transposed, with the
    same zeros."""
    T, p, seed = 64, 0.2, 77
    streams, pad, scale = rel_case(cuda_device, 3, T, seed=5, pad_rows=False)
    B, H, D = 3, 2, 128
    eye = torch.eye(T, D, device=cuda_device)[None, :, None, :].expand(B, T, H, D).contiguous()
    args = [streams["qc"], streams["k"], eye, streams["g"], streams["table"]]
    ctx, lse = fr.rel_fwd(*args, scale, None, p, seed)
    keep = fa.dropout_keep_mask(seed, B, H, T, T, p, cuda_device)  # (B, H, i, j)
    torch.cuda.synchronize()
    assert torch.equal(ctx[..., :T].permute(0, 2, 1, 3) != 0, keep)
    delta, g = fa.backward_inputs(ctx, eye, torch.float32)
    _, dv, _ = fr.rel_bwd_dkv(*args, torch.zeros(B, T, device=cuda_device), lse, delta, g,
                              scale, p, seed)
    torch.cuda.synchronize()
    assert torch.equal(dv[..., :T].permute(0, 2, 3, 1) != 0, keep)


@pytest.mark.cuda
def test_rel_autograd_function_launches_the_kernels(cuda_device):
    """The public op on CUDA tensors that need gradients: one K7 forward,
    bwd-q and bwd-kv launch each, and the gradients of autograd through the
    plain forward on the same seed. The table needs no gradient here."""
    T = 200
    streams, pad, scale = rel_case(cuda_device, 3, T, seed=T)
    fns = (fr.rel_fwd, fr.rel_bwd_dq, fr.rel_bwd_dkv)
    counts = [f.launches for f in fns]
    leaves = [streams[n].clone().requires_grad_(n != "table") for n in REL_NAMES]
    out = fr.flash_rel_attention(*leaves, scale, pad_mask=pad, dropout_p=0.2, dropout_seed=3)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(out.device)
    (out * gout).sum().backward()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    ref_leaves = [streams[n].clone().requires_grad_(n != "table") for n in REL_NAMES]
    ref, _ = fr.rel_fwd_plain(*ref_leaves, scale, pad, 0.2, 3)
    (ref.reshape(out.shape) * gout).sum().backward()
    torch.cuda.synchronize()
    assert (out - ref.reshape(out.shape)).abs().max().item() <= 1e-4
    for name, a, b in zip(REL_NAMES[:4], leaves, ref_leaves):
        err = (a.grad - b.grad).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.grad.abs().max().item()), (name, err)


def ragged_lengths_mask(device, B, T):
    """A (B, T) pad mask whose batch rows hold 0, 1, 63, 64, 65 and T live
    keys (the key tiles' edges), one row with holes before its last live
    key, and ragged rows after those."""
    lens = [0, 1, 63, 64, 65, T, T // 2, T // 3]
    lens = (lens + [max(1, T - 7 * i) for i in range(1, B)])[:B]
    pad = torch.arange(T)[None] >= torch.tensor(lens)[:, None]
    pad[6, : T // 4 : 3] = True  # holes before the row's last live key
    return pad.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(16, 1008), (8, 512)])
def test_rel_fwd_tensor_core_kernel_matches_plain(cuda_device, B, T):
    """K7 forward (the K7 instance of the tensor-core forward template,
    which walks each batch row's key tiles only up to its last live key)
    against ``rel_fwd_plain`` at the serving (16, 1008) and training
    (8, 512) shapes: fp32 within 1e-4 and lse within rel 1e-5, bf16 within
    2e-2 (lse 1e-3), dropout 0 and 0.2, with batch rows of 0, 1, 63, 64, 65
    and T live keys and one with holes, and with no pad mask; one launch
    count a call. K6 at D=128 (the same template and the same skip) on the
    same ragged rows, fp32 and bf16."""
    streams, _, scale = rel_case(cuda_device, B, T, seed=T + B, pad_rows=False)
    ragged = ragged_lengths_mask(cuda_device, B, T)
    seed = 97531 + T
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args = [streams[n].to(dtype) for n in REL_NAMES]
        lse_tol = 1e-5 if dtype == torch.float32 else 1e-3
        for pad in (ragged, None):
            for p in (0.0, 0.2):
                case = (str(dtype), pad is None, p)
                before = fr.rel_fwd.launches
                ctx, lse = fr.rel_fwd(*args, scale, pad, p, seed)
                assert fr.rel_fwd.launches == before + 1, case
                ref, ref_lse = fr.rel_fwd_plain(*args, scale, pad, p, seed)
                torch.cuda.synchronize()
                assert torch.isfinite(ctx).all() and torch.isfinite(lse).all(), case
                err = (ctx - ref).abs().max().item()
                assert err <= atol, (case, err)
                lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                assert lse_err <= lse_tol, (case, lse_err)
                del ctx, ref
        del args
    xl, _, xl_scale = xl_case(cuda_device, B, T, H=2, D=128, seed=T, pad_rows=False)
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        xargs = [xl[n].to(dtype) for n in XL_NAMES]
        ctx, lse = fx.xl_fwd(*xargs, xl_scale, ragged)
        ref, ref_lse = fx.xl_fwd_plain(*xargs, xl_scale, ragged)
        torch.cuda.synchronize()
        assert (ctx - ref).abs().max().item() <= atol, str(dtype)
        lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
        assert lse_err <= (1e-5 if dtype == torch.float32 else 1e-3), (str(dtype), lse_err)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D", [(64, 48), (100, 48), (512, 48), (100, 64)])
def test_xl3_bwd_tensor_core_kernels_match_plain(cuda_device, T, D):
    """K4 bwd (the ds kernel on the tensor cores, bwd-kv on its scratches,
    the reduce pass) against ``xl3_bwd_plain`` on the kernel forward's lse,
    for every case of ``XL_TC_CASES`` (fp32 and bf16, dropout 0 and 0.1, a
    full, a ragged and a fully padded row, whose dv is the dense gradient of
    the uniform weights 1 / T, or no pad mask): dqc, dk, dv, dqv and dp each
    within atol of the plain one, scaled by its largest value where that
    exceeds 1; one launch count a call."""
    B, H = 3, 8
    seed = 8642 + T
    inputs = {pr: xl_case(cuda_device, B, T, H=H, D=D, seed=T + D + 3, pad_rows=pr)
              for pr in (True, False)}
    for dtype, atol, dropout_p, pad_rows in XL_TC_CASES:
        case = (str(dtype), dropout_p, pad_rows)
        streams, pad, scale = inputs[pad_rows]
        args = [streams[n].to(dtype) for n in ("qc", "k", "v", "qv", "p")]
        ctx, lse = fx.xl3_fwd(*args, scale, pad, dropout_p, seed)
        gout = torch.from_numpy(np.random.RandomState(T + 6).randn(*ctx.shape)
                                .astype(np.float32))
        delta, g = fa.backward_inputs(ctx, gout.to(ctx.device), dtype)
        padf = pad.float() if pad is not None else torch.zeros(B, T, device=cuda_device)
        bwd_args = (*args, padf, lse, delta, g, scale, dropout_p, seed)
        before = fx.xl3_bwd.launches
        got = fx.xl3_bwd(*bwd_args)
        assert fx.xl3_bwd.launches == before + 1, case
        want = fx.xl3_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        for name, a, b in zip(("dqc", "dk", "dv", "dqv", "dp"), got, want):
            assert a.shape == b.shape, (case, name)
            assert torch.isfinite(a).all(), (case, name)
            err = (a - b).abs().max().item()
            assert err <= atol * max(1.0, b.abs().max().item()), (case, name, err)
        del got, want


@pytest.mark.cuda
def test_rel_bwd_q_tensor_core_kernels_match_plain(cuda_device):
    """K7 bwd-q (K7's instance of the tensor-core K5 / K6 bwd-q kernels:
    the position logits g t^T, ds and dqc, then dg = ds t) against
    ``rel_bwd_dq_plain`` on the kernel forward's lse, at T in {45, 64, 300,
    512} (partial and whole 64-row tiles, the training decoder's 512), fp32
    (each gradient within 1e-4, scaled by its largest value where that
    exceeds 1) and bf16 (2e-2), dropout 0 and 0.2, with a full, a ragged and
    a fully padded row (its ds, so dqc and dg, are 0) or no pad mask; one
    launch count a call."""
    B = 3
    for T in (45, 64, 300, 512):
        seed = 5318008 + T
        inputs = {pr: rel_case(cuda_device, B, T, seed=T + 13, pad_rows=pr)
                  for pr in (True, False)}
        gout = torch.from_numpy(np.random.RandomState(T + 7).randn(B, T, 2, 128)
                                .astype(np.float32)).to(cuda_device)
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            for dropout_p in (0.0, 0.2):
                for pad_rows in (True, False):
                    case = (T, str(dtype), dropout_p, pad_rows)
                    streams, pad, scale = inputs[pad_rows]
                    args = [streams[n].to(dtype) for n in REL_NAMES]
                    ctx, lse = fr.rel_fwd(*args, scale, pad, dropout_p, seed)
                    delta, g = fa.backward_inputs(ctx, gout, dtype)
                    padf = pad.float() if pad is not None else torch.zeros(B, T,
                                                                           device=cuda_device)
                    bwd_args = (*args, padf, lse, delta, g, scale, dropout_p, seed)
                    before = fr.rel_bwd_dq.launches
                    got = fr.rel_bwd_dq(*bwd_args)
                    assert fr.rel_bwd_dq.launches == before + 1, case
                    want = fr.rel_bwd_dq_plain(*bwd_args)
                    torch.cuda.synchronize()
                    for name, a, b in zip(("dqc", "dg"), got, want):
                        assert a.shape == b.shape, (case, name)
                        assert torch.isfinite(a).all(), (case, name)
                        err = (a - b).abs().max().item()
                        assert err <= atol * max(1.0, b.abs().max().item()), (case, name, err)
                    if pad_rows:  # the fully padded row takes no gradient
                        assert not got[0][2].any() and not got[1][2].any(), case
                    del got, want, ctx, lse


@pytest.mark.cuda
def test_xl3_fwd_tensor_core_kernel_matches_plain(cuda_device):
    """K4 forward (the tensor-core kernel: band-form position logits
    sheared into the (row, key) tile, then the flash back half) against
    ``xl3_fwd_plain`` under one seed, at D in {48, 64} and T in {45, 64,
    300, 512}, for every case of ``XL_TC_CASES`` (fp32 and bf16, dropout 0
    and 0.1, a full, a ragged and a fully padded row, which averages v over
    the T real keys, or no pad mask): ctx within atol, lse within rel 1e-5
    in fp32 and 1e-3 in bf16; one launch count a call. Then, with v the
    identity, the context is the dropped weights themselves: its zeros are
    exactly where ``dropout_keep_mask`` drops, in every row, the fully
    padded one too."""
    B, H = 3, 8
    for D in (48, 64):
        for T in (45, 64, 300, 512):
            seed = 24680 + T + D
            inputs = {pr: xl_case(cuda_device, B, T, H=H, D=D, seed=T + D + 4, pad_rows=pr)
                      for pr in (True, False)}
            for dtype, atol, dropout_p, pad_rows in XL_TC_CASES:
                case = (D, T, str(dtype), dropout_p, pad_rows)
                streams, pad, scale = inputs[pad_rows]
                args = [streams[n].to(dtype) for n in ("qc", "k", "v", "qv", "p")]
                before = fx.xl3_fwd.launches
                ctx, lse = fx.xl3_fwd(*args, scale, pad, dropout_p, seed)
                assert fx.xl3_fwd.launches == before + 1, case
                ref, ref_lse = fx.xl3_fwd_plain(*args, scale, pad, dropout_p, seed)
                torch.cuda.synchronize()
                assert torch.isfinite(ctx).all() and torch.isfinite(lse).all(), case
                err = (ctx - ref).abs().max().item()
                assert err <= atol, (case, err)
                lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                assert lse_err <= (1e-5 if dtype == torch.float32 else 1e-3), (case, lse_err)
                del ctx, ref
    T, D, p, seed = 64, 48, 0.2, 79
    streams, _, scale = xl_case(cuda_device, B, T, H=H, D=D, seed=8, pad_rows=False)
    eye = torch.eye(T, D, device=cuda_device)[None, :, None, :].expand(B, T, H, D).contiguous()
    args = [streams["qc"], streams["k"], eye, streams["qv"], streams["p"]]
    pad = torch.zeros(B, T, device=cuda_device)
    pad[-1] = 1.0
    ctx, _ = fx.xl3_fwd(*args, scale, pad > 0.5, p, seed)
    keep = fa.dropout_keep_mask(seed, B, H, T, T, p, cuda_device)  # (B, H, i, j)
    torch.cuda.synchronize()
    assert torch.equal(ctx.permute(0, 2, 1, 3) != 0, keep[..., :D])
    uniform = ctx[-1]
    assert torch.allclose(uniform[uniform != 0],
                          torch.tensor(1.0 / ((1.0 - p) * T), device=cuda_device))


@pytest.mark.cuda
def test_flash_attention_tensor_core_kernel_matches_plain(cuda_device):
    """K1 (the instance of the tensor-core forward template with no
    position term, which walks each batch row's key tiles only up to its
    last live key) against ``attention_fwd_plain`` under one seed, at D in
    {32, 64, 128} and T in {45, 64, 300, 1008}: fp32 within 1e-4 and bf16
    within 2e-2, lse within rel 1e-5, dropout 0 and 0.2, with a full, a
    ragged, a one-live-key and a fully padded row (which averages v over
    all Tp keys), or no pad mask; one launch count a call. Then, with v the
    identity, the context is the dropped weights themselves: its zeros are
    exactly where ``dropout_keep_mask`` drops."""
    B, H = 4, 2
    for D in (32, 64, 128):
        for T in (45, 64, 300, 1008):
            rng = np.random.RandomState(T + D)
            q, k, v = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
                       .to(cuda_device) for _ in range(3))
            ragged = (torch.arange(T)[None] >= torch.tensor([T, T // 2 + 1, 1, 0])[:, None])
            seed = 31337 + T + D
            for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                args = [x.to(dtype) for x in (q, k, v)]
                for pad in (ragged.to(cuda_device), None):
                    for p in (0.0, 0.2):
                        case = (D, T, str(dtype), pad is None, p)
                        before = fa.attention_fwd.launches
                        ctx, lse = fa.attention_fwd(*args, D ** -0.5, pad, p, seed)
                        assert fa.attention_fwd.launches == before + 1, case
                        ref, ref_lse = fa.attention_fwd_plain(*args, D ** -0.5, pad, p, seed)
                        torch.cuda.synchronize()
                        assert torch.isfinite(ctx).all() and torch.isfinite(lse).all(), case
                        err = (ctx - ref).abs().max().item()
                        assert err <= atol, (case, err)
                        lse_err = ((lse - ref_lse).abs()
                                   / ref_lse.abs().clamp(min=1.0)).max().item()
                        assert lse_err <= 1e-5, (case, lse_err)
                        del ctx, ref
    T, D, p, seed = 64, 128, 0.2, 81
    rng = np.random.RandomState(3)
    q, k = (torch.from_numpy(rng.randn(3, T, H, D).astype(np.float32)).to(cuda_device)
            for _ in range(2))
    eye = torch.eye(T, D, device=cuda_device)[None, :, None, :].expand(3, T, H, D).contiguous()
    ctx, _ = fa.attention_fwd(q, k, eye, D ** -0.5, None, p, seed)
    keep = fa.dropout_keep_mask(seed, 3, H, T, T, p, cuda_device)  # (B, H, i, j)
    torch.cuda.synchronize()
    assert torch.equal(ctx[..., :T].permute(0, 2, 1, 3) != 0, keep)


@pytest.mark.cuda
def test_rel_bwd_whole_on_shared_scratches_matches_plain(cuda_device, monkeypatch):
    """The whole K7 backward on one set of scratches (``rel_bwd``: Q1 with
    P, bwd-kv and dtab on its ds and P scratches, Q2) against
    ``rel_bwd_plain`` and against the standalone ``rel_bwd_dq`` and
    ``rel_bwd_dkv`` on the kernel forward's lse, at T in {45, 64, 300,
    512}, fp32 (each gradient within 1e-4, scaled by its largest value
    where that exceeds 1) and bf16 (2e-2), dropout 0 and 0.2, the table's
    gradient included, with a full, a ragged, a three-live-key, a
    one-live-key and a fully padded row (the dense gradient of the uniform
    weights: dk, dqc and dg 0 there), or no pad mask; one count on each
    backward counter a call. The standalone bwd-kv runs the same kernels
    on the same inputs: its dk, dv and dtable are the whole backward's bit
    for bit. Then ``_RelAttention``'s backward runs Q1 once and counts
    one launch on each of the three counters."""
    B = 5
    for T in (45, 64, 300, 512):
        seed = 2718281 + T
        streams, _, scale = rel_case(cuda_device, B, T, seed=T + 17, pad_rows=False)
        ragged = (torch.arange(T)[None] >= torch.tensor([T, T // 2 + 1, 3, 1, 0])[:, None])
        gout = torch.from_numpy(np.random.RandomState(T + 8).randn(B, T, 2, 128)
                                .astype(np.float32)).to(cuda_device)
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = [streams[n].to(dtype) for n in REL_NAMES]
            for pad in (ragged.to(cuda_device), None):
                for dropout_p in (0.0, 0.2):
                    case = (T, str(dtype), pad is None, dropout_p)
                    ctx, lse = fr.rel_fwd(*args, scale, pad, dropout_p, seed)
                    delta, g = fa.backward_inputs(ctx, gout, dtype)
                    padf = pad.float() if pad is not None else torch.zeros(B, T,
                                                                           device=cuda_device)
                    bwd_args = (*args, padf, lse, delta, g, scale, dropout_p, seed)
                    before = (fr.rel_bwd_dq.launches, fr.rel_bwd_dkv.launches)
                    got = fr.rel_bwd(*bwd_args, want_dtab=True)
                    assert (fr.rel_bwd_dq.launches, fr.rel_bwd_dkv.launches) == (
                        before[0] + 1, before[1] + 1), case
                    want = fr.rel_bwd_plain(*bwd_args, want_dtab=True)
                    dqc, dg = fr.rel_bwd_dq(*bwd_args)
                    dk, dv, dtab = fr.rel_bwd_dkv(*bwd_args, want_dtab=True)
                    torch.cuda.synchronize()
                    names = ("dqc", "dk", "dv", "dg", "dtable")
                    for name, a, b, c in zip(names, got, want, (dqc, dk, dv, dg, dtab)):
                        assert a.shape == b.shape == c.shape, (case, name)
                        assert torch.isfinite(a).all(), (case, name)
                        lim = atol * max(1.0, b.abs().max().item())
                        err = (a - b).abs().max().item()
                        assert err <= lim, (case, name, err)
                        err = (a - c).abs().max().item()
                        assert err <= (0.0 if name in ("dk", "dv", "dtable") else lim), (
                            case, name, "standalone", err)
                    if pad is not None:  # the fully padded row: no ds
                        for name, a in zip(names, got):
                            if name in ("dqc", "dk", "dg"):
                                assert not a[-1].any(), (case, name)
                    del got, want, ctx, lse
            del args
    calls = []
    q1 = fx._bwd_q1
    monkeypatch.setattr(fx, "_bwd_q1", lambda *a, **kw: calls.append(1) or q1(*a, **kw))
    streams, pad, scale = rel_case(cuda_device, 3, 200, seed=5)
    fns = (fr.rel_fwd, fr.rel_bwd_dq, fr.rel_bwd_dkv)
    counts = [f.launches for f in fns]
    leaves = [streams[n].clone().requires_grad_() for n in REL_NAMES]
    out = fr.flash_rel_attention(*leaves, scale, pad_mask=pad, dropout_p=0.2, dropout_seed=9)
    out.sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    assert len(calls) == 1
    assert all(torch.isfinite(x.grad).all() for x in leaves)
