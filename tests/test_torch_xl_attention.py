"""The port's Transformer-XL attention (``ops/xl_attention.py`` and the plain
versions of kernels K4 / K5 / K6 in ``ops/flash_xl_attention.py``) against
the JAX package on the CPU.

Off the TPU the JAX public functions ``flash_xl3_attention``,
``flash_xl2_attention`` and ``flash_xl_attention`` lower to their dense
oracles (``_xl3_dense``, ``_xl2_dense``, ``_xl_dense``), which makes them
the reference values; at short lengths the port is also held against the
Pallas kernels run in interpret mode, as ``tests/test_pallas_attention.py``
runs them. Inputs come from numpy with a fixed seed.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import viet_tts_tpu.ops.pallas_attention as pa
from viet_tts_tpu.nn.utils import sinusoid_position_table
from viet_tts_tpu.ops import xl_attention as jxl
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops import xl_attention as txl

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

H, D = 2, 16
E = H * D
ATOL = 1e-5  # fp32, the same dense formulas in another summation order


def _case(T, B=3, seed=0, pad_rows=True):
    """Numpy inputs of one attention: q, k, v (B, T, H, D), the biases,
    pos_kernel (E, H*D), the table (T, E), and a pad mask with a full, a
    ragged and a fully padded row (or None)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    u, vb = (0.3 * rng.randn(H, D).astype(np.float32) for _ in range(2))
    pk = (rng.randn(E, H * D) / np.sqrt(E)).astype(np.float32)
    table = sinusoid_position_table(T, E)
    pad = None
    if pad_rows:
        lens = np.array([T, T // 2 + 1, 0][:B])
        pad = np.arange(T)[None] >= lens[:, None]
    return q, k, v, u, vb, pk, table, pad


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _jax_inputs(kind, q, k, v, u, vb, pk, table):
    """The JAX public function's stream arguments for ``kind``."""
    T = q.shape[1]
    if kind == "xl3":
        return (q + u, k, v, q + vb, (table @ pk).reshape(T, H, D))
    if kind == "xl2":
        return (q + u, k, v, np.asarray(jxl.xl_pos_query_stream(q + vb, pk)), table)
    gA, gB = jxl.xl_pos_queries(q + vb, pk)
    return (q + u, k, v, np.asarray(gA), np.asarray(gB), table)


def _port_inputs(kind, q, k, v, u, vb, pk, table):
    """The same arguments built by the port's own oracle functions."""
    q, k, v, u, vb, pk, table = map(_t, (q, k, v, u, vb, pk, table))
    T = q.shape[1]
    if kind == "xl3":
        return (q + u, k, v, q + vb, (table @ pk).reshape(T, H, D))
    if kind == "xl2":
        return (q + u, k, v, txl.xl_pos_query_stream(q + vb, pk), table)
    gA, gB = txl.xl_pos_queries(q + vb, pk)
    return (q + u, k, v, gA, gB, table)


JAX_FN = {"xl3": pa.flash_xl3_attention, "xl2": pa.flash_xl2_attention,
          "xl": pa.flash_xl_attention}


def _jax(kind, args, scale, pad):
    """The JAX public function, jitted (one compile instead of one per op)."""
    fn = JAX_FN[kind]
    if pad is None:
        return np.asarray(jax.jit(lambda *a: fn(*a, scale))(*args))
    return np.asarray(jax.jit(lambda p, *a: fn(*a, scale, pad_mask=p))(pad, *args))


PORT_FN = {"xl3": fx.flash_xl3_attention, "xl2": fx.flash_xl2_attention,
           "xl": fx.flash_xl_attention}


def test_oracle_functions_match_jax():
    """rotate_pairs, the query streams, the factorised and the
    padded-reshape logits."""
    q, k, v, u, vb, pk, table, _ = _case(40, B=2)
    scale = 1.0 / np.sqrt(E)
    delta = np.arange(40, dtype=np.float32) % 7 - 3
    g = np.random.RandomState(1).randn(40, E).astype(np.float32)
    np.testing.assert_allclose(txl.rotate_pairs(_t(g), _t(delta)).numpy(),
                               np.asarray(jxl.rotate_pairs(g, delta)), atol=2e-6)
    gA_j, gB_j = jxl.xl_pos_queries(q + vb, pk)
    gA_t, gB_t = txl.xl_pos_queries(_t(q + vb), _t(pk))
    np.testing.assert_allclose(gA_t.numpy(), np.asarray(gA_j), atol=2e-6)
    np.testing.assert_allclose(gB_t.numpy(), np.asarray(gB_j), atol=2e-6)
    want = np.asarray(jxl.xl_attention_scores(q + u, k, gA_j, gB_j, table, scale))
    got = txl.xl_attention_scores(_t(q + u), _t(k), gA_t, gB_t, _t(table), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    ref = np.asarray(jxl.xl_attention_reference(q + u, k, q + vb, pk, table, scale))
    got_ref = txl.xl_attention_reference(_t(q + u), _t(k), _t(q + vb), _t(pk), _t(table),
                                         scale)
    np.testing.assert_allclose(got_ref.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), got_ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("kind", ["xl3", "xl2", "xl"])
@pytest.mark.parametrize("T,pad_rows", [(48, True), (100, True), (128, False)])
def test_plain_versions_match_jax(kind, T, pad_rows):
    """Padded T (48 and 100 pad to 128 for xl3, to 64 / 128 for xl2 and xl)
    with a ragged and a fully padded row, and an unpadded T without a pad
    mask: the port's plain version equals the JAX public function."""
    q, k, v, u, vb, pk, table, pad = _case(T, seed=T, pad_rows=pad_rows)
    scale = 1.0 / np.sqrt(E)
    want = _jax(kind, _jax_inputs(kind, q, k, v, u, vb, pk, table), scale, pad)
    got = PORT_FN[kind](*_port_inputs(kind, q, k, v, u, vb, pk, table), scale, _t(pad))
    assert got.shape == (3, T, H * D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_fully_padded_rows_follow_the_padding_rule():
    """A row whose keys are all padding: xl3 averages v over the T real
    keys (its tail keys score 2 * MASK_NEG), xl2 and xl over all 32-padded
    keys (the tail's v rows are 0)."""
    T = 40
    q, k, v, u, vb, pk, table, pad = _case(T, seed=5)
    scale = 1.0 / np.sqrt(E)
    mean = v[2].mean(axis=0).reshape(H * D)
    for kind, want in (("xl3", mean), ("xl2", mean * T / 64), ("xl", mean * T / 64)):
        got = PORT_FN[kind](*_port_inputs(kind, q, k, v, u, vb, pk, table), scale, _t(pad))
        np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(want, (T, H * D)),
                                   atol=1e-6, err_msg=kind)


def test_long_lengths_match_jax_and_the_shift_path():
    """xl2 at T = 1008 and xl at T = 1100 (the serving decoder's routes):
    against the JAX functions within 1e-5 (the rotation angles reach ~1100
    rad; the port computes them by the same fp32 formulas), and, on the
    real rows, against the padded-reshape shift path, which has no
    rotations, within 5e-5."""
    scale = 1.0 / np.sqrt(E)
    for kind, T in (("xl2", 1008), ("xl", 1100)):
        q, k, v, u, vb, pk, table, pad = _case(T, B=2, seed=T)
        want = _jax(kind, _jax_inputs(kind, q, k, v, u, vb, pk, table), scale, pad)
        got = PORT_FN[kind](*_port_inputs(kind, q, k, v, u, vb, pk, table), scale,
                            _t(pad)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=kind)
        logits = txl.xl_attention_reference(_t(q + u), _t(k), _t(q + vb), _t(pk),
                                            _t(table), scale)
        logits = logits.masked_fill(_t(pad)[:, None, None, :], fx.MASK_NEG)
        shift = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1),
                             _t(v)).reshape(2, T, H * D)
        np.testing.assert_allclose(got, shift.numpy(), atol=5e-5, err_msg=kind)


@pytest.mark.parametrize("kind,T", [("xl3", 48), ("xl3", 128), ("xl2", 48)])
def test_plain_versions_match_the_interpreted_kernels(kind, T):
    """Against the Pallas kernels in interpret mode: xl3 with a left-padded
    table (T=48, d_pad=80) and without (T=128), xl2 at T=48."""
    q, k, v, u, vb, pk, table, pad = _case(T, B=2, seed=T + 1)
    scale = 1.0 / np.sqrt(E)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JAX_FN[kind](*_jax_inputs(kind, q, k, v, u, vb, pk, table), scale,
                                       pad_mask=pad))
    got = PORT_FN[kind](*_port_inputs(kind, q, k, v, u, vb, pk, table), scale, _t(pad))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_reference_xl2_kernel_is_nan_at_540_where_the_port_is_dense():
    """A fault of the reference, not copied: the interpreted xl2 Pallas
    kernel at T=540 (padded to 544, not a multiple of its k-tile of 128,
    ``pallas_attention.py:_xl2_block_k``) returns NaN on every row, while
    the dense lowering (``_xl2_dense``) and the port's plain version agree."""
    T = 540
    q, k, v, u, vb, pk, table, _ = _case(T, B=1, seed=3, pad_rows=False)
    q, k, v = (x[:, :, :1, :8] for x in (q, k, v))
    u, vb = u[:1, :8], vb[:1, :8]
    e = 16
    pk = pk[:e, :8]
    table = sinusoid_position_table(T, e)
    g = np.asarray(jxl.xl_pos_query_stream(q + vb, pk))
    scale = 1.0 / np.sqrt(e)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(pa.flash_xl2_attention(q + u, k, v, g, table, scale))
    dense = _jax("xl2", (q + u, k, v, g, table), scale, None)
    port = fx.flash_xl2_attention(_t(q + u), _t(k), _t(v), _t(g), _t(table), scale).numpy()
    assert np.isnan(kernel).all()
    assert np.isfinite(dense).all()
    np.testing.assert_allclose(port, dense, atol=ATOL)


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors each wrapper is its plain version and counts no
    launch, with attention-weight dropout too (keyed by the seed); a rate
    outside [0, 1) is refused."""
    q, k, v, u, vb, pk, table, pad = _case(40, B=2)
    args = _port_inputs("xl2", q, k, v, u, vb, pk, table)
    before = (fx.xl3_fwd.launches, fx.xl2_fwd.launches, fx.xl_fwd.launches)
    ctx, lse = fx.xl2_fwd(*args, 0.2, _t(pad))
    ref, ref_lse = fx.xl2_fwd_plain(*args, 0.2, _t(pad))
    assert torch.equal(ctx, ref) and torch.equal(lse, ref_lse)
    assert lse.shape == (2, H, 40) and ctx.dtype == torch.float32
    assert (fx.xl3_fwd.launches, fx.xl2_fwd.launches, fx.xl_fwd.launches) == before
    dropped, _ = fx.xl2_fwd(*args, 0.2, _t(pad), dropout_p=0.1, seed=9)
    assert torch.equal(dropped, fx.xl2_fwd_plain(*args, 0.2, _t(pad), 0.1, 9)[0])
    assert not torch.equal(dropped, ctx)
    assert (fx.xl3_fwd.launches, fx.xl2_fwd.launches, fx.xl_fwd.launches) == before
    with pytest.raises(ValueError, match="dropout_p"):
        fx.xl2_fwd(*args, 0.2, _t(pad), dropout_p=1.0)
