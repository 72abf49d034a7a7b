"""Kernels K1 (with attention-weight dropout) and K3 (the FA2 backward):
the port's plain versions and its ``torch.autograd.Function`` against the
JAX package's ``flash_attention`` and its custom VJP.

The JAX op runs as its own tests run it on the CPU: in TPU interpret mode
(the Pallas kernels, forward and backward) or through its dense path.
Dropout bits cannot match JAX (the TPU draws them from the on-core PRNG,
the JAX CPU path from ``jax.random.bernoulli``), so dropout is held to
properties, and bit for bit to the port's own hash. (The CUDA kernels
against these plain versions, on the card: ``tests/test_torch_cuda.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from viet_tts_tpu.ops import pallas_attention as pa
from viet_tts_torch.ops import flash_attention as fa
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 5e-4, 5e-5  # the JAX package's own (test_pallas_attention.py)
B, H, D = 2, 2, 16


def _case(T, lens, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    g = rng.randn(B, T, H * D).astype(np.float32)
    pad = np.arange(T)[None] >= np.asarray(lens)[:, None]
    return q, k, v, g, pad


def _jax_grads(q, k, v, g, pad, interpret):
    scale = D ** -0.5

    def loss(q, k, v):
        out = pa.flash_attention(q, k, v, scale, pad_mask=jnp.asarray(pad))
        return jnp.sum(out * g), out

    fn = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            (_, out), grads = fn(*args)
    else:
        (_, out), grads = fn(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_grads(q, k, v, g, pad, dropout_p=0.0, seed=None):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, D ** -0.5, pad_mask=torch.from_numpy(pad),
                             dropout_p=dropout_p, dropout_seed=seed)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("T,lens", [(32, [32, 19]), (48, [41, 48])])
def test_backward_matches_jax_interpret_kernels(T, lens):
    """Forward and (dq, dk, dv) of the port's autograd function (plain K1
    and K3 on the CPU) against ``jax.grad`` through the Pallas forward and
    backward kernels in interpret mode; T=48 runs padded to Tp=64."""
    q, k, v, g, pad = _case(T, lens, seed=T)
    want_out, want = _jax_grads(q, k, v, g, pad, interpret=True)
    got_out, got = _port_grads(q, k, v, g, pad)
    np.testing.assert_allclose(got_out, want_out, rtol=RTOL, atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"d{name}")


def test_fully_padded_row_gradient_is_the_dense_one():
    """A batch row whose keys are all padding: the forward is uniform
    attention over all Tp keys, and the port's gradient is the dense path's
    (dv = sum_q g / Tp, dq = dk = 0).

    The reference's Pallas backward differs here: its lse, -1e9 + log(Tp),
    rounds to -1e9 in fp32, so exp(s - lse) is 1 per key instead of 1/Tp and
    the interpret-mode kernel's dv on that row is Tp = 32 times the dense
    one (dq and dk agree). The port keeps the dense gradient."""
    T = 32
    q, k, v, g, pad = _case(T, [T, 0], seed=5)
    want_out, want = _jax_grads(q, k, v, g, pad, interpret=False)
    got_out, got = _port_grads(q, k, v, g, pad)
    np.testing.assert_allclose(got_out, want_out, rtol=RTOL, atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"d{name}")
    dv_row = g[1].reshape(T, H, D).sum(axis=0) / fa.padded_time(T)
    np.testing.assert_allclose(got[2][1], np.broadcast_to(dv_row, (T, H, D)), atol=1e-6)
    assert not got[0][1].any() and not got[1][1].any()


def _np_keep(seed, b, h, i, j, p):
    """The dropout hash of ``csrc/dropout_hash.cuh`` in numpy uint32
    arithmetic (wrapping products, as the CUDA code computes them)."""
    u32 = np.uint32

    def fmix(x):
        x = x ^ (x >> u32(16))
        x = x * u32(0x85EBCA6B)
        x = x ^ (x >> u32(13))
        x = x * u32(0xC2B2AE35)
        return x ^ (x >> u32(16))

    with np.errstate(over="ignore"):
        key = fmix(u32(seed & 0xFFFFFFFF) ^ u32(0x9E3779B9))
        key = fmix(key ^ u32(seed >> 32))
        key = fmix(key ^ u32((b << 16) | h))
        x = fmix(key ^ ((i.astype(u32) << u32(16)) | j.astype(u32)))
        x = fmix(x + key)
    return x < u32(fa.dropout_threshold(p))


def test_dropout_mask_is_the_kernels_hash_and_tile_free():
    seed = (123456789 << 20) + 987  # above 2^32: both seed halves matter
    p = 0.2
    m = fa.dropout_keep_mask(seed, 3, 2, 70, 96, p)
    i, j = np.meshgrid(np.arange(70), np.arange(96), indexing="ij")
    for b in range(3):
        for h in range(2):
            np.testing.assert_array_equal(m[b, h].numpy(), _np_keep(seed, b, h, i, j, p))
    # addressed per element: any other (T, Tp) sees the same bits
    small = fa.dropout_keep_mask(seed, 2, 2, 33, 64, p)
    np.testing.assert_array_equal(small.numpy(), m[:2, :, :33, :64].numpy())
    rate = m.float().mean().item()
    sigma = np.sqrt(0.8 * 0.2 / m.numel())
    assert abs(rate - 0.8) < 4 * sigma, rate
    assert not torch.equal(m, fa.dropout_keep_mask(seed + 1, 3, 2, 70, 96, p))


def test_dropout_forward_properties():
    """Deterministic in the seed, different across seeds, and the mean over
    40 seeds approaches the no-dropout output (the JAX test's bound,
    ``test_pallas_attention.py``), which is also the JAX op's."""
    T = 32
    q, k, v, _, pad = _case(T, [T, 27], seed=11)
    tq, tk, tv, tpad = (torch.from_numpy(x) for x in (q, k, v, pad))

    def run(seed, p):
        return fa.flash_attention(tq, tk, tv, D ** -0.5, pad_mask=tpad,
                                  dropout_p=p, dropout_seed=seed)

    a, b, c = run(3, 0.2), run(3, 0.2), run(4, 0.2)
    assert torch.equal(a, b)
    assert (a - c).abs().max().item() > 1e-4
    base = run(None, 0.0).numpy()
    want = np.asarray(pa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         D ** -0.5, pad_mask=jnp.asarray(pad)))
    np.testing.assert_allclose(base, want, rtol=RTOL, atol=ATOL)
    mean = np.mean([run(s, 0.2).numpy() for s in range(40)], axis=0)
    err = np.abs(mean - base).mean() / (np.abs(base).mean() + 1e-9)
    assert err < 0.25, err


@pytest.mark.parametrize("T,lens", [(32, [32, 0]), (45, [45, 20])])
def test_dropout_backward_is_autograd_of_the_masked_dense_forward(T, lens):
    """The autograd function's backward (K3's plain version, mask
    regenerated from the seed) equals autograd through the dense forward
    under the same explicit mask, a fully padded row included."""
    p, seed = 0.2, 2024
    q, k, v, g, pad = _case(T, lens, seed=T + 1)
    got_out, got = _port_grads(q, k, v, g, pad, dropout_p=p, seed=seed)
    rq, rk, rv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ctx, _ = fa.attention_fwd_plain(rq, rk, rv, D ** -0.5, torch.from_numpy(pad), p, seed)
    out = ctx.reshape(B, T, H * D)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got_out, out.detach().numpy())
    for name, a, x in zip("qkv", got, (rq, rk, rv)):
        np.testing.assert_allclose(a, x.grad.numpy(), rtol=5e-5, atol=1e-6,
                                   err_msg=f"d{name}")


def test_plain_backward_api_matches_the_function():
    """``attention_bwd_plain`` (the plain version of the K3 pair, as
    ``chip_smoke.py`` calls it) gives the autograd function's gradients."""
    T, p, seed = 40, 0.2, 77
    q, k, v, g, pad = _case(T, [40, 13], seed=9)
    _, want = _port_grads(q, k, v, g, pad, dropout_p=p, seed=seed)
    tq, tk, tv, tpad = (torch.from_numpy(x) for x in (q, k, v, pad))
    padf = tpad.float()
    out, lse = fa.attention_fwd_plain(tq, tk, tv, D ** -0.5, padf, p, seed)
    gt = torch.from_numpy(g).reshape(B, T, H, D)
    got = fa.attention_bwd_plain(tq, tk, tv, padf, out, lse, gt, seed, D ** -0.5, p)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
