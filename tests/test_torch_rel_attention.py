"""Kernel K7 (espnet "latest" rel-pos flash attention): the plain versions
of the forward, bwd-q and bwd-kv, through the port's public op and its
``torch.autograd.Function``, against the JAX package's
``flash_rel_attention`` and ``jax.vjp`` of its custom VJP on the CPU.

The JAX op runs as its own tests run it on the CPU: through ``_dispatch``'s
dense lowering (``_rel_dense`` and its VJP) and through the Pallas kernels
in interpret mode (dropout 0). Dropout bits cannot match JAX (the TPU draws
them from its on-core PRNG), so dropout is held to its properties beside
the JAX dense dropout, to autograd through the plain forward under the same
mask, and bit for bit to ``dropout_keep_mask``. (The CUDA kernels against
these plain versions, on the card: ``tests/test_torch_cuda.py``.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import viet_tts_tpu.ops.pallas_attention as pa
from viet_tts_tpu.nn.espnet_conformer import rel_positional_table
from viet_tts_tpu.ops.espnet_attention import neg_rel_table, rel_pos_queries_latest
from viet_tts_torch.ops import flash_attention as fa
from viet_tts_torch.ops import flash_rel_attention as fr

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

H, D = 2, 16
E = H * D
SCALE = 1.0 / np.sqrt(D)
ATOL_FWD = 1e-5  # fp32, the same dense formulas in another summation order
ATOL_GRAD = 1e-4


def _case(T, lens, seed, B=3):
    """Numpy inputs of one attention (qc, k, v, g, table), a cotangent of
    its output and the pad mask (None when ``lens`` is)."""
    if lens is not None:
        B = len(lens)
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    u, w = (0.3 * rng.randn(H, D).astype(np.float32) for _ in range(2))
    pk = (rng.randn(E, H * D) / np.sqrt(E)).astype(np.float32)
    g = np.asarray(rel_pos_queries_latest(jnp.asarray(q + w), jnp.asarray(pk)))
    table = np.asarray(neg_rel_table(jnp.asarray(rel_positional_table(T, E))))
    gout = rng.randn(B, T, H * D).astype(np.float32)
    pad = None if lens is None else np.arange(T)[None] >= np.asarray(lens)[:, None]
    return (q + u, k, v, g, table), gout, pad


def _jax_grads(args, gout, pad, interpret=False, dropout_p=0.0, seed=None):
    """(output, gradients of qc, k, v, g, table) of the JAX op."""
    dseed = None if seed is None else jnp.asarray([seed], jnp.int32)

    def run(*a):
        out, vjp = jax.vjp(lambda *x: pa.flash_rel_attention(
            *x, SCALE, pad_mask=pad, dropout_p=dropout_p, dropout_seed=dseed), *a)
        return out, vjp(gout.astype(out.dtype))

    if interpret:
        with pltpu.force_tpu_interpret_mode():
            out, grads = run(*args)
    else:
        out, grads = jax.jit(run)(*args)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return f32(out), [f32(x) for x in grads]


def _port_grads(args, gout, pad, dtype=torch.float32, dropout_p=0.0, seed=None):
    leaves = [torch.from_numpy(np.array(x)).to(dtype).requires_grad_() for x in args]
    out = fr.flash_rel_attention(*leaves, SCALE,
                                 None if pad is None else torch.from_numpy(pad),
                                 dropout_p, seed)
    (out.float() * torch.from_numpy(gout)).sum().backward()
    return out.detach().float().numpy(), [x.grad.float().numpy() for x in leaves]


CASES = {  # name: (T, lens)
    "T64 ragged": (64, [64, 41, 17]),
    "T40 padded to 64, fully padded row": (40, [40, 23, 0]),
    "T64 no pad mask": (64, None),
}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX op's outputs and gradients for each case, dense and
    interpreted (computed once for the module)."""
    out = {}
    for name, (T, lens) in CASES.items():
        args, gout, pad = _case(T, lens, seed=T + len(name))
        out[name] = (args, gout, pad,
                     {interp: _jax_grads(args, gout, pad, interp) for interp in (False, True)})
    return out


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("interpret", [False, True], ids=["dense", "interpreted"])
def test_forward_matches_jax(jax_results, name, interpret):
    """The context (B, T, H*D) of the port's op (the plain K7 forward)
    against the JAX op, dense and through the interpreted Pallas kernel."""
    args, gout, pad, ref = jax_results[name]
    got, _ = _port_grads(args, gout, pad)
    want, _ = ref[interpret]
    assert got.shape == want.shape == (len(args[0]), args[0].shape[1], H * D)
    np.testing.assert_allclose(got, want, atol=ATOL_FWD)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("interpret", [False, True], ids=["dense", "interpreted"])
def test_gradients_match_jax(jax_results, name, interpret):
    """dqc, dk, dv, dg and dtable of the port's autograd function (the plain
    K7 bwd-q and bwd-kv) against ``jax.vjp`` of the JAX op; the rows of a
    fully padded batch row are held by the next test (the interpreted
    kernels differ there)."""
    args, gout, pad, ref = jax_results[name]
    _, got = _port_grads(args, gout, pad)
    _, want = ref[interpret]
    lens = CASES[name][1]
    live = slice(0, -1) if interpret and lens is not None and 0 in lens else slice(None)
    names = ("dqc", "dk", "dv", "dg", "dtable")
    for i, (a, b) in enumerate(zip(got, want)):
        if names[i] != "dtable":
            a, b = a[live], b[live]
        assert np.abs(b).max() > 1e-3, names[i]
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD, err_msg=f"{names[i]} {name}")


def test_fully_padded_row_takes_the_dense_gradient(jax_results):
    """A batch row whose keys are all padding: the port's gradients are the
    dense VJP's (uniform weights 1/Tp: dv = sum_q g / Tp on that row, every
    other gradient 0 there). The reference's interpreted Pallas backward
    differs: its lse, -1e9 + log Tp, rounds to -1e9 in fp32, so exp(l - lse)
    is 1 per key and its dv on that row is Tp times the dense one."""
    args, gout, pad, ref = jax_results["T40 padded to 64, fully padded row"]
    T = args[0].shape[1]
    tp = fa.padded_time(T)
    _, got = _port_grads(args, gout, pad)
    _, dense = ref[False]
    for a, b in zip(got[:4], dense[:4]):
        np.testing.assert_allclose(a[-1], b[-1], atol=ATOL_GRAD)
    dv_row = gout[-1].reshape(T, H, D).sum(axis=0) / tp
    np.testing.assert_allclose(got[2][-1], np.broadcast_to(dv_row, (T, H, D)), atol=1e-6)
    for a in (got[0], got[1], got[3]):
        assert not a[-1].any()
    _, kernel = ref[True]
    np.testing.assert_allclose(kernel[2][-1], tp * got[2][-1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["T64 ragged", "T40 padded to 64, fully padded row"])
def test_bf16_matches_jax(name):
    """bf16 streams: the port's op (the plain version rounds its weights and
    ds to bf16 as the kernels do) against the JAX op's dense lowering in
    bf16, output and gradients within 2e-2 of their largest value."""
    T, lens = CASES[name]
    args, gout, pad = _case(T, lens, seed=T + 5)
    args16 = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in args]
    want_out, want = _jax_grads(args16, gout, pad)
    got_out, got = _port_grads(args, gout, pad, dtype=torch.bfloat16)
    np.testing.assert_allclose(got_out, want_out, atol=2e-2)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 2e-2 * max(1.0, np.abs(b).max())


def test_dropout_backward_is_autograd_of_the_masked_dense_forward():
    """With dropout the autograd function's backward (the plain whole K7
    backward, ``rel_bwd_plain``, mask regenerated from the seed) equals
    autograd through the plain forward under the same seed, the table's
    gradient, a ragged and a fully padded row included; and
    ``rel_bwd_plain``, bwd-kv taken from the scratch layout of ds and
    p m / keep as the kernels take it, equals the dense ``rel_bwd_dq_plain``
    and ``rel_bwd_dkv_plain`` there."""
    p, seed = 0.2, 2024
    args, gout, pad = _case(45, [45, 38, 0], seed=8)
    got_out, got = _port_grads(args, gout, pad, dropout_p=p, seed=seed)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in args]
    ctx, lse = fr.rel_fwd_plain(*leaves, SCALE, torch.from_numpy(pad), p, seed)
    out = ctx.reshape(got_out.shape)
    (out * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_array_equal(got_out, out.detach().numpy())
    for i, (a, x) in enumerate(zip(got, leaves)):
        np.testing.assert_allclose(a, x.grad.numpy(), rtol=5e-5, atol=1e-6, err_msg=str(i))
    streams = [x.detach() for x in leaves]
    delta, gs = fa.backward_inputs(ctx.detach(), torch.from_numpy(gout).reshape(ctx.shape),
                                   torch.float32)
    bwd_args = (*streams, torch.from_numpy(pad).float(), lse.detach(), delta, gs, SCALE, p,
                seed)
    whole = fr.rel_bwd_plain(*bwd_args, want_dtab=True)
    dqc, dg = fr.rel_bwd_dq_plain(*bwd_args)
    dk, dv, dtab = fr.rel_bwd_dkv_plain(*bwd_args, want_dtab=True)
    for name, a, b in zip(("dqc", "dk", "dv", "dg", "dtable"), whole, (dqc, dk, dv, dg, dtab)):
        assert a.shape == b.shape and b.abs().max() > 1e-3, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


def test_dropout_mask_is_the_counter_hash_bit_for_bit():
    """With v the identity the context is the dropped weights themselves:
    its zeros are exactly where ``dropout_keep_mask`` drops, the kept
    weights are the undropped ones over (1 - p)."""
    T, p, seed = 32, 0.2, 99
    (qc, k, _, g, table), _, _ = _case(T, None, seed=2, B=2)
    eye = np.broadcast_to(np.eye(T, D, dtype=np.float32)[None, :, None, :], (2, T, H, D))
    args = [torch.from_numpy(np.array(x)) for x in (qc, k, eye, g, table)]
    dropped, _ = fr.rel_fwd(*args, SCALE, None, p, seed)
    full, _ = fr.rel_fwd(*args, SCALE, None, 0.0, 0)
    keep = fa.dropout_keep_mask(seed, 2, H, T, T, p)[..., :D]  # the keys v shows
    w_dropped = dropped.permute(0, 2, 1, 3)
    assert torch.equal(w_dropped != 0, keep)
    w_full = full.permute(0, 2, 1, 3)
    torch.testing.assert_close(w_dropped[keep], w_full[keep] / (1.0 - p), rtol=1e-6, atol=0)


def test_dropout_properties_beside_jax():
    """The port's dropout and the JAX op's (its dense lowering, the route
    the JAX package takes for dropout off the TPU): deterministic in the
    seed, different across seeds, the kept share of the weights near 1 - p
    in both, and the mean over 40 seeds near the no-dropout output."""
    T, p = 40, 0.2
    (qc, k, _, g, table), _, pad = _case(T, [T, T - 11], seed=21)
    eye = np.broadcast_to(np.eye(T, D, dtype=np.float32)[None, :, None, :], (2, T, H, D))
    tpad = torch.from_numpy(pad)

    def port(seed, rate, v=eye):
        args = [torch.from_numpy(np.array(x)) for x in (qc, k, v, g, table)]
        return fr.flash_rel_attention(*args, SCALE, tpad, rate, seed).numpy().reshape(
            2, T, H, D)

    def jax_op(seed, rate):
        return np.asarray(jax.jit(lambda *a: pa.flash_rel_attention(
            *a, SCALE, pad_mask=pad, dropout_p=rate,
            dropout_seed=jnp.asarray([seed], jnp.int32)))(qc, k, eye, g, table)).reshape(
            2, T, H, D)

    a, b, c = port(3, p), port(3, p), port(4, p)
    assert np.array_equal(a, b) and np.abs(a - c).max() > 1e-4
    ja, jb = jax_op(3, p), jax_op(3, p)
    assert np.array_equal(ja, jb)
    base = port(None, 0.0)
    # with v the identity, the context holds the dropped weights of keys < D
    valid = np.broadcast_to(~pad[:, None, None, :D], a.shape)
    kept = {"port": (a != 0)[valid].mean(), "jax": (ja != 0)[valid].mean()}
    for who, share in kept.items():
        assert abs(share - (1.0 - p)) < 0.03, (who, share)
    nz = a != 0
    np.testing.assert_allclose(a[nz], base[nz] / (1.0 - p), rtol=1e-5)
    jnz = ja != 0
    np.testing.assert_allclose(ja[jnz], base[jnz] / (1.0 - p), rtol=1e-5, atol=1e-6)
    v = np.random.RandomState(0).randn(2, T, H, D).astype(np.float32)
    base_v = port(None, 0.0, v)
    mean = np.mean([port(s, p, v) for s in range(40)], axis=0)
    err = np.abs(mean - base_v).mean() / (np.abs(base_v).mean() + 1e-9)
    assert err < 0.25, err


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors every K7 wrapper is its plain version and counts no
    launch; the forward wrapper and the public op agree."""
    args, gout, pad = _case(40, [40, 20], seed=4)
    before = (fr.rel_fwd.launches, fr.rel_bwd_dq.launches, fr.rel_bwd_dkv.launches)
    out, _ = _port_grads(args, gout, pad)
    targs = [torch.from_numpy(np.array(x)) for x in args]
    ctx, lse = fr.rel_fwd(*targs, SCALE, torch.from_numpy(pad))
    assert (fr.rel_fwd.launches, fr.rel_bwd_dq.launches, fr.rel_bwd_dkv.launches) == before
    assert lse.shape == (2, H, 40)
    np.testing.assert_array_equal(ctx.reshape(out.shape).numpy(), out)


def test_public_op_casts_the_streams_to_the_compute_dtype():
    """A bf16 model hands the op bf16 qc, k, v and an fp32 g (the rotation
    runs in fp32): the op computes in bf16 as the JAX wrapper does, equal to
    the call with every stream in bf16, and returns bf16; fp32 qc with a
    bf16 g computes in fp32."""
    args, _, pad = _case(40, [40, 23], seed=6)
    t32 = [torch.from_numpy(np.array(x)) for x in args]
    t16 = [x.to(torch.bfloat16) for x in t32]
    tpad = torch.from_numpy(pad)
    mixed = fr.flash_rel_attention(*t16[:3], t32[3], t32[4], SCALE, tpad)
    want = fr.flash_rel_attention(*t16, SCALE, tpad)
    assert mixed.dtype == torch.bfloat16
    assert torch.equal(mixed, want)
    wide = fr.flash_rel_attention(*t32[:3], t16[3], t32[4], SCALE, tpad)
    assert wide.dtype == torch.float32
    assert torch.equal(wide, fr.flash_rel_attention(*t32[:3], t16[3].float(), t32[4],
                                                    SCALE, tpad))
