"""The backward of the FS2 conformer's Transformer-XL attention: the plain
versions of kernels K4 bwd (xl3), K5 bwd-q / bwd-kv (xl2) and K6 bwd-q /
bwd-kv (xl), through the port's ``torch.autograd.Function``s, against the
JAX package's custom VJPs on the CPU; the conformer attention in training
on K6's route (T = 1040, past the xl2 route), and ``xl_attention``.

The JAX ops run as their own tests run them on the CPU: through the dense
lowering (``_xl3_bwd_dense`` / ``_xl2_bwd_dense`` / ``_xl_bwd_dense``, the
VJP of the dense oracle) and through the Pallas backward kernels in
interpret mode, at B <= 2, H = 1 and T <= 128. Dropout bits cannot match JAX (the TPU draws them
from its on-core PRNG), so dropout is held to its properties and to
autograd through the dense forward under the same mask. (The CUDA kernels
against these plain versions, on the card: ``tests/test_torch_cuda.py``.)
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import viet_tts_tpu.ops.pallas_attention as pa
from viet_tts_tpu.nn.conformer import RelativeMultiHeadAttention as JaxRelMHA
from viet_tts_tpu.nn.utils import sinusoid_position_table
from viet_tts_tpu.ops import xl_attention as jxl
from viet_tts_torch.nn.conformer import RelativeMultiHeadAttention
from viet_tts_torch.ops import flash_xl_attention as fx
from viet_tts_torch.ops.flash_attention import backward_inputs
from viet_tts_torch.ops import xl_attention as txl

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

H, D = 1, 16
E = H * D
ATOL = 1e-5  # fp32, the same dense formulas in another summation order
SCALE = 1.0 / np.sqrt(E)


def _case(T, lens, seed):
    """Numpy inputs of one attention in the xl3, xl2 and xl
    parameterisations, a cotangent of its output and the pad mask (None when
    ``lens`` is)."""
    B = 1 if lens is None else len(lens)
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    u, vb = (0.3 * rng.randn(H, D).astype(np.float32) for _ in range(2))
    pk = (rng.randn(E, H * D) / np.sqrt(E)).astype(np.float32)
    table = sinusoid_position_table(T, E)
    g = rng.randn(B, T, H * D).astype(np.float32)
    pad = None if lens is None else np.arange(T)[None] >= np.asarray(lens)[:, None]
    streams = {
        "xl3": (q + u, k, v, q + vb, (table @ pk).reshape(T, H, D)),
        "xl2": (q + u, k, v, np.asarray(jxl.xl_pos_query_stream(q + vb, pk)), table),
        "xl": (q + u, k, v, *(np.asarray(x) for x in jxl.xl_pos_queries(q + vb, pk)), table),
    }
    return streams, g, pad


KINDS = ["xl3", "xl2", "xl"]
JAX_FN = {"xl3": pa.flash_xl3_attention, "xl2": pa.flash_xl2_attention,
          "xl": pa.flash_xl_attention}
PORT_FN = {"xl3": fx.flash_xl3_attention, "xl2": fx.flash_xl2_attention,
           "xl": fx.flash_xl_attention}
PLAIN_FWD = {"xl3": fx.xl3_fwd_plain, "xl2": fx.xl2_fwd_plain, "xl": fx.xl_fwd_plain}
FWD = {"xl3": fx.xl3_fwd, "xl2": fx.xl2_fwd, "xl": fx.xl_fwd}


def _jax_grads(kind, args, g, pad, interpret):
    """(output, gradients of the stream arguments) of the JAX op."""
    fn = JAX_FN[kind]

    def run(*a):
        out, vjp = jax.vjp(lambda *x: fn(*x, SCALE, pad_mask=pad), *a)
        return out, vjp(g)

    if interpret:
        with pltpu.force_tpu_interpret_mode():
            out, grads = run(*args)
    else:
        out, grads = jax.jit(run)(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_grads(kind, args, g, pad, dropout_p=0.0, seed=None):
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in args]
    out = PORT_FN[kind](*leaves, SCALE, None if pad is None else torch.from_numpy(pad),
                        dropout_p, seed)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


SPLIT_FNS = {  # kind: (the whole backward, its separate plain bwd-q and bwd-kv)
    "xl2": (fx.xl2_bwd, fx.xl2_bwd_dq_plain, fx.xl2_bwd_dkv_plain),
    "xl": (fx.xl_bwd, fx.xl_bwd_dq_plain, fx.xl_bwd_dkv_plain),
}


def _check_split(kind, args, g, pad, dropout_p=0.0, seed=0):
    """The plain version of the kernels' split (the whole K5 / K6 backward
    on CPU tensors: dk, dv and dtab by ``xl_bwd_kv_plain`` from the scratch
    layout of ds and p m / keep) against the separate plain bwd-q and
    bwd-kv on the forward's own lse, with the table's gradient and without;
    and the scratch layout itself against the dense terms it holds."""
    if kind not in SPLIT_FNS:
        return
    whole, plain_dq, plain_dkv = SPLIT_FNS[kind]
    T = args[0].shape[1]
    t = [torch.from_numpy(np.array(x)) for x in args]
    tpad = None if pad is None else torch.from_numpy(pad)
    ctx, lse = PLAIN_FWD[kind](*t, SCALE, tpad, dropout_p, seed)
    delta, gs = backward_inputs(ctx, torch.from_numpy(g).reshape(ctx.shape), torch.float32)
    padf = torch.zeros(len(t[0]), T) if tpad is None else tpad.float()
    bargs = (*t, padf, lse, delta, gs, SCALE, dropout_p, seed)
    dq = plain_dq(*bargs)
    for want_dtab in (True, False):
        got = whole(*bargs, want_dtab=want_dtab)
        dkv = plain_dkv(*bargs, want_dtab=want_dtab)
        want = (dq[0], *dkv[:2], *dq[1:], dkv[2])
        assert (got[-1] is None) == (not want_dtab)
        for i, (a, b) in enumerate(zip(got, want)):
            if b is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                           err_msg=f"{kind} split {i} dtab={want_dtab}")
    terms = (fx._xl2_bwd_terms(*bargs)[7:9] if kind == "xl2"
             else fx._xl_bwd_terms(*t[:3], *(fx._hm(x, torch.float32) for x in t[3:5]),
                                   *bargs[5:])[4:6])
    for x in terms:
        s = fx.xl_bwd_scratch_plain(x)
        assert s.shape[-1] % 128 == 0 and not s[..., T:].any()
        assert torch.equal(s[..., :T], x[..., :T])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T,lens", [(48, [41]), (128, None)])
def test_backward_matches_jax_dense_and_interpreted_kernels(kind, T, lens):
    """The stream gradients (xl3: qc, k, v, qv, p; xl2: qc, k, v, g, table;
    xl: qc, k, v, gA, gB, table) of the port's autograd function against
    ``jax.vjp`` of the JAX op through its dense lowering and through the
    Pallas backward kernels in interpret mode: T = 48 with a ragged row
    (padded to 128 by xl3, to 64 by xl2 and xl; xl3 left-pads p), T = 128
    with no pad mask. For xl2 and xl (whose autograd backward is the
    kernels' split) also ``_check_split``."""
    streams, g, pad = _case(T, lens, seed=T + len(kind))
    args = streams[kind]
    got_out, got = _port_grads(kind, args, g, pad)
    _check_split(kind, args, g, pad)
    for interpret in (False, True):
        want_out, want = _jax_grads(kind, args, g, pad, interpret)
        np.testing.assert_allclose(got_out, want_out, atol=ATOL)
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.abs(b).max() > 1e-3
            np.testing.assert_allclose(a, b, atol=ATOL,
                                       err_msg=f"{kind} grad {i} interpret={interpret}")


@pytest.mark.parametrize("kind", KINDS)
def test_fully_padded_row_takes_the_dense_gradient(kind):
    """A batch row whose keys are all padding: the port's gradients are the
    dense VJP's (uniform weights 1/n, n = T for xl3, the 32-padded length
    for xl2 and xl: dv = sum_q g / n, every other gradient 0 on that row).

    The reference's interpreted Pallas backward differs there, as its plain
    backward does (``test_torch_flash_train.py``): its lse, -1e9 + log n,
    rounds to -1e9 in fp32, so exp(l - lse) is 1 per key and its dv on that
    row is n times the dense one. For xl2 and xl also ``_check_split``
    (the split's dense dv comes from the scratch's uniform weights)."""
    T = 40
    streams, g, pad = _case(T, [T - 9, 0], seed=3)
    args = streams[kind]
    got_out, got = _port_grads(kind, args, g, pad)
    _check_split(kind, args, g, pad)
    want_out, want = _jax_grads(kind, args, g, pad, interpret=False)
    np.testing.assert_allclose(got_out, want_out, atol=ATOL)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"{kind} grad {i}")
    n = T if kind == "xl3" else fx.padded_time(T)
    dv_row = g[1].reshape(T, H, D).sum(axis=0) / n
    np.testing.assert_allclose(got[2][1], np.broadcast_to(dv_row, (T, H, D)), atol=1e-6)
    _, kernel = _jax_grads(kind, args, g, pad, interpret=True)
    np.testing.assert_allclose(kernel[2][1], n * got[2][1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(kernel[2][0], got[2][0], atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_dropout_backward_is_autograd_of_the_masked_dense_forward(kind):
    """With dropout the autograd function's backward (the plain K4 bwd /
    K5 bwd / K6 bwd, mask regenerated from the seed) equals autograd through
    the plain forward under the same seed, a ragged and a fully padded row
    included; and its table gradient (xl2, xl) too; and (xl2, xl)
    ``_check_split`` under the same seed."""
    T, p, seed = 45, 0.1, 2024
    streams, g, pad = _case(T, [T - 7, 0], seed=8)
    args = streams[kind]
    got_out, got = _port_grads(kind, args, g, pad, dropout_p=p, seed=seed)
    _check_split(kind, args, g, pad, p, seed)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in args]
    ctx, _ = PLAIN_FWD[kind](*leaves, SCALE, torch.from_numpy(pad), p, seed)
    out = ctx.reshape(got_out.shape)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got_out, out.detach().numpy())
    for i, (a, x) in enumerate(zip(got, leaves)):
        np.testing.assert_allclose(a, x.grad.numpy(), rtol=5e-5, atol=1e-6,
                                   err_msg=f"{kind} grad {i}")


@pytest.mark.parametrize("kind", KINDS)
def test_dropout_forward_properties(kind):
    """Deterministic in the seed, different across seeds, the kept share of
    the weights near 1 - p, and the mean over 40 seeds near the
    no-dropout output (the JAX test's bound for K1)."""
    T, p = 40, 0.1
    streams, _, pad = _case(T, [T, T - 11], seed=21)
    args = [torch.from_numpy(np.array(x)) for x in streams[kind]]
    tpad = torch.from_numpy(pad)

    def run(seed, rate):
        return PORT_FN[kind](*args, SCALE, tpad, rate, seed)

    a, b, c = run(3, p), run(3, p), run(4, p)
    assert torch.equal(a, b)
    assert (a - c).abs().max().item() > 1e-4
    base = run(None, 0.0).numpy()
    mean = np.mean([run(s, p).numpy() for s in range(40)], axis=0)
    err = np.abs(mean - base).mean() / (np.abs(base).mean() + 1e-9)
    assert err < 0.25, err
    # with v the identity the context is the dropped weights themselves
    eye = torch.eye(T, D * H).reshape(1, T, H, D).expand(2, T, H, D).contiguous()
    args_eye = list(args)
    args_eye[2] = eye
    fwd = FWD[kind]
    dropped, _ = fwd(*args_eye, SCALE, tpad, p, 5)
    full, _ = fwd(*args_eye, SCALE, tpad, 0.0, 0)
    kept = (dropped[..., : min(T, D)] != 0).float().mean().item()
    assert abs(kept - (1.0 - p)) < 0.05, kept
    nz = dropped != 0
    np.testing.assert_allclose(dropped[nz].numpy(), full[nz].numpy() / (1.0 - p), rtol=1e-5)


def test_cpu_wrappers_count_no_launch_and_k6_refuses_gradients():
    """On CPU tensors the backward wrappers of K4, K5 and K6 are their plain
    versions and count no launch. (Until K6's backward was ported, the
    two-stream op refused gradients here; it now trains, and its gradients
    match autograd through the plain forward.)"""
    T = 40
    streams, g, pad = _case(T, [T, 20], seed=4)
    wrappers = (fx.xl3_bwd, fx.xl2_bwd_dq, fx.xl2_bwd_dkv, fx.xl_bwd_dq, fx.xl_bwd_dkv,
                fx.xl_fwd)
    before = [w.launches for w in wrappers]
    for kind in KINDS:
        _port_grads(kind, streams[kind], g, pad)
    _, got = _port_grads("xl", streams["xl"], g, pad)
    assert [w.launches for w in wrappers] == before
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in streams["xl"]]
    ctx, _ = fx.xl_fwd_plain(*leaves, SCALE, torch.from_numpy(pad))
    (ctx.reshape(g.shape) * torch.from_numpy(g)).sum().backward()
    for i, (a, x) in enumerate(zip(got, leaves)):
        assert np.abs(a).max() > 1e-3
        np.testing.assert_allclose(a, x.grad.numpy(), rtol=5e-5, atol=1e-6, err_msg=f"grad {i}")


def _jax_attention(T, d_model, heads):
    """The JAX conformer attention (flash route, dropout 0) and its
    variables holding a port attention's weights."""
    port = RelativeMultiHeadAttention(d_model, heads, 0.0, "flash")
    gen = torch.Generator().manual_seed(T)
    with torch.no_grad():
        for prm in port.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) / np.sqrt(d_model))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = {name: {"kernel": sd[f"{name}.linear.weight"].T, "bias": sd[f"{name}.linear.bias"]}
              for name in ("query_proj", "key_proj", "value_proj", "out_proj")}
    params["pos_proj"] = {"kernel": sd["pos_proj.linear.weight"].T}
    params["u_bias"], params["v_bias"] = sd["u_bias"], sd["v_bias"]
    jm = JaxRelMHA(d_model, heads, dropout=0.0, attn_implementation="flash")
    return port, jm, {"params": params}


def test_conformer_refuses_training_past_the_xl2_route():
    """In training, a padded length above 1024 routes the conformer attention
    to K6 (T = 1040, padded to 1056). It used to raise there, K6 having no
    backward; now it trains: the output and the gradients of the input and
    of every parameter against ``jax.vjp`` of the JAX module's flash route
    (dropout 0, train=True; the JAX side through its dense lowering), and
    with dropout 0.1 a finite gradient reaches every parameter."""
    T, d_model, heads = 1040, 32, 2
    port, jm, variables = _jax_attention(T, d_model, heads)
    rng = np.random.RandomState(9)
    x = rng.randn(1, T, d_model).astype(np.float32)
    table = sinusoid_position_table(T, d_model)
    gout = rng.randn(1, T, d_model).astype(np.float32)
    pad = np.arange(T)[None] >= T - 13

    @jax.jit
    def run(v, xx):
        out, vjp = jax.vjp(lambda a, b: jm.apply(a, b, table[None], pad_mask=pad, train=True),
                           v, xx)
        return out, vjp(gout)

    want, (want_vars, want_x) = run(variables, x)
    port.train()
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt, torch.from_numpy(table), torch.from_numpy(pad))
    (out * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=ATOL)
    jp = want_vars["params"]
    pairs = {"u_bias": jp["u_bias"], "v_bias": jp["v_bias"],
             "pos_proj.linear.weight": np.asarray(jp["pos_proj"]["kernel"]).T}
    for name in ("query_proj", "key_proj", "value_proj", "out_proj"):
        pairs[f"{name}.linear.weight"] = np.asarray(jp[name]["kernel"]).T
        pairs[f"{name}.linear.bias"] = jp[name]["bias"]
    grads = dict(port.named_parameters())
    for name, ref in pairs.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(grads[name].grad.numpy(), ref,
                                   atol=ATOL * max(1.0, np.abs(ref).max()), err_msg=name)
    drop = RelativeMultiHeadAttention(d_model, heads, 0.1, "flash").train()
    drop.load_state_dict(port.state_dict())
    drop(torch.from_numpy(x), torch.from_numpy(table), None,
         torch.Generator().manual_seed(1)).square().mean().backward()
    for name, prm in drop.named_parameters():
        assert torch.isfinite(prm.grad).all() and prm.grad.abs().max() > 0, name


@pytest.mark.parametrize("implementation,T", [("dense", 40), ("flash", 40), ("flash", 600),
                                              ("flash", 1040)])
def test_xl_attention_matches_jax(implementation, T):
    """``xl_attention`` against the JAX function on the dense route and on
    the flash route at a length of each kernel (xl3, xl2, xl): the output
    and the gradients of q, k and v (``jax.vjp``; the JAX flash route
    through its dense lowering), with a ragged and a fully padded row."""
    rng = np.random.RandomState(T)
    B = 2
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    u, vb = (0.3 * rng.randn(H, D).astype(np.float32) for _ in range(2))
    pk = (rng.randn(E, H * D) / np.sqrt(E)).astype(np.float32)
    table = sinusoid_position_table(T, E)
    pad = np.arange(T)[None] >= np.array([T - 5, 0])[:, None]
    gout = rng.randn(B, T, H * D).astype(np.float32)
    @jax.jit
    def run(*a):
        out, vjp = jax.vjp(lambda *x: jxl.xl_attention(*x, u, vb, pk, table, SCALE, pad,
                                                       implementation), *a)
        return out, vjp(gout)

    want, want_grads = run(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = txl.xl_attention(*leaves, *(torch.from_numpy(x) for x in (u, vb, pk, table)), SCALE,
                           torch.from_numpy(pad), implementation)
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    for name, a, b in zip("qkv", leaves, want_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=ATOL, err_msg=name)
