"""espnet "latest" rel-pos flash attention of the JETS conformer stacks:
kernel K7 (forward, bwd-q, bwd-kv), its plain versions and the autograd
function around them.

Counterpart of the rel flavour of ``viet_tts_tpu/ops/pallas_attention.py``:
the public ``flash_rel_attention`` (custom VJP ``_rel_op``; TPU kernels
``_rel_kernel`` forward, ``_rel_bwd_q_kernel`` and ``_rel_bwd_kv_kernel``).
The function is

    ctx_i = sum_j softmax_j((qc_i . k_j + g_i . t_j) * scale) v_j,

with qc = q + pos_bias_u, k, v (B, T, H, D), the pre-rotated position
queries g (B, T, H, E) of ``ops/espnet_attention.py:rel_pos_queries_latest``
and the negative half t (T, E) of the symmetric sinusoid table, shared by
every (b, h). Padded keys score ``MASK_NEG = -1e9``.

- ``rel_fwd`` / ``rel_fwd_plain``: (ctx (B, T, H, D) fp32, lse (B, H, T)).
- ``rel_bwd_dq`` / ``rel_bwd_dq_plain``: (dqc (B, T, H, D), dg (B, T, H, E))
  = (ds k, ds t).
- ``rel_bwd_dkv`` / ``rel_bwd_dkv_plain``: (dk, dv (B, T, H, D), dtable
  (T, E) or None) = (ds^T qc, (p m / keep)^T g_out, sum_{b,h} ds^T g); the
  table's gradient only with ``want_dtab`` (the conformer's table is a
  constant).
- ``rel_bwd`` / ``rel_bwd_plain``: the whole backward, (dqc, dk, dv, dg,
  dtable or None), bwd-q and bwd-kv on one set of scratches, as
  ``_RelAttention`` runs it.
- ``flash_rel_attention``: the JAX signature and result, (B, T, H*D) in qc's
  dtype, differentiable through ``_RelAttention``.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (the dense formulas of ``_rel_dense`` on the padded inputs, and
that function's VJP) for CPU tensors, never one for the other. The
forward is the K7 instance of the tensor-core flash template
``xl2_fwd_kernel`` in ``csrc/flash_xl_attention.cu``, which K1, K5 and K6
run too. The backward runs K7's instances of the tensor-core K5 / K6
backward kernels in ``csrc/flash_xl_attention_bwd.cu``: bwd-q is Q1 (the
position logits g t^T, then ds and dqc, written into a ds scratch) and Q2
(dg = ds t); bwd-kv is the bwd-kv kernel (dk = ds^T qc, dv = P^T g_out)
on the ds scratch and the P = p m / keep scratch that Q1 writes beside it
when bwd-kv follows, so it forms no logit; dtable is the dtab kernel's K7
instance (ds^T g at every key).

Padding, as the JAX wrapper does it: T is padded to Tp, the next multiple of
32, with zero rows of qc, k, v, g and of the table, and the tail is marked
as padded keys; so a row whose keys are all padding averages v over all Tp
keys. Its gradient is the dense one (uniform weights 1/Tp), not the TPU
kernels' (their lse, -1e9 + log Tp, rounds to -1e9 in fp32, and exp(l -
lse) gives 1 per key: dv there is Tp times too large).

Attention-weight dropout (training): the keep bit of weight (i, j) of batch
row b, head h is ``flash_attention.dropout_keep_mask``'s counter hash, the
one K1, K3, K4 and K5 draw, so the forward, both backward kernels and the
plain versions share the mask. The semantics are the JAX package's: the
softmax denominator takes the undropped weights, the context p * m / keep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from viet_tts_torch.ops.flash_attention import MASK_NEG, _pad_tensor, backward_inputs, padded_time
from viet_tts_torch.ops.flash_xl_attention import (
    POS_REL,
    _bwd_inputs,
    _bwd_q1,
    _bwd_q1_kv,
    _bwd_q2,
    _check,
    _check_rates,
    _compute_dtype,
    _device_of,
    _hm,
    _keep_scale,
    _launch_args,
    _merge,
    _out,
    _pad_rows,
    _seed,
    _softmax_ctx,
    _table,
    _weights_and_ds,
    xl_bwd_kv_plain,
    xl_bwd_scratch_plain,
)
from viet_tts_torch.runtime import kernels

# the width the kernels are built for: the JETS conformer's (adim 256, 2
# heads), head dim D and position width E = adim
REL_D, REL_E = 128, 256


def _logits(qch, kh, gh, tab, scale: float):
    """(qc k^T + g t^T) * scale on head-major fp32 operands (B, H, rows, keys)."""
    content = torch.einsum("bhqd,bhkd->bhqk", qch, kh)
    pos = torch.einsum("bhqe,ke->bhqk", gh, tab)
    return (content + pos) * scale


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def rel_fwd_plain(qc, k, v, g, table, scale: float, pad_mask=None, dropout_p: float = 0.0,
                  seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_rel_attention`` as the JAX package computes it off the TPU
    (``_rel_dense`` on the padded inputs): qc, k, v (B, T, H, D), g
    (B, T, H, E), table (T, E) -> (ctx (B, T, H, D) fp32, lse (B, H, T)
    fp32). Differentiable by autograd."""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    tp = padded_time(T)
    pad = F.pad(_pad_tensor(pad_mask, B, T, qc.device), (0, tp - T), value=1.0)
    qch, kh, vh, gh = (_hm(_pad_rows(x, tp - T), cd) for x in (qc, k, v, g))
    tab = _pad_rows(table.to(cd).float()[None], tp - T)[0]
    logits = _logits(qch, kh, gh, tab, scale)
    logits = torch.where(pad[:, None, None, :] > 0.5, torch.full_like(logits, MASK_NEG),
                         logits)
    m = _keep_scale(seed, B, H, tp, tp, dropout_p, qc.device)
    return _out(*_softmax_ctx(logits, vh, cd, m), T)


def _bwd_terms(qc, k, v, g, table, pad, lse, delta, gout, scale, dropout_p, seed):
    """Dense terms of the backward on the T real query rows and the Tp
    padded keys: (qch, gh, goh, kh, tab, p m / keep, ds). Query rows past T
    carry a zero cotangent, so they add nothing to any gradient."""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    tp = padded_time(T)
    padp = F.pad(pad, (0, tp - T), value=1.0)
    qch, gh, goh = (_hm(x, cd) for x in (qc, g, gout))
    kh, vh = (_hm(_pad_rows(x, tp - T), cd) for x in (k, v))
    tab = _pad_rows(table.to(cd).float()[None], tp - T)[0]
    logits = _logits(qch, kh, gh, tab, scale)
    dpv = torch.einsum("bhqd,bhkd->bhqk", goh, vh)
    m = _keep_scale(seed, B, H, T, tp, dropout_p, qc.device)
    p_v, ds = _weights_and_ds(logits, padp, lse, dpv, delta, m, tp, scale, cd)
    return qch, gh, goh, kh, tab, p_v, ds


def rel_bwd_dq_plain(qc, k, v, g, table, pad, lse, delta, gout, scale: float,
                     dropout_p: float = 0.0, seed: int = 0):
    """(dqc (B, T, H, D), dg (B, T, H, E)) fp32: the plain version of K7
    bwd-q (the VJP of ``_rel_dense``). gout the cotangent of the context in
    the stream dtype; pad (B, T) fp32; lse and delta (B, H, T) fp32."""
    _, _, _, kh, tab, _, ds = _bwd_terms(qc, k, v, g, table, pad, lse, delta, gout, scale,
                                         dropout_p, seed)
    return (torch.einsum("bhqk,bhkd->bqhd", ds, kh),
            torch.einsum("bhqk,ke->bqhe", ds, tab))


def rel_bwd_dkv_plain(qc, k, v, g, table, pad, lse, delta, gout, scale: float,
                      dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dk, dv (B, T, H, D), dtable (T, E) or None) fp32: the plain version
    of K7 bwd-kv."""
    T = qc.shape[1]
    qch, gh, goh, _, _, p_v, ds = _bwd_terms(qc, k, v, g, table, pad, lse, delta, gout,
                                             scale, dropout_p, seed)
    dk = torch.einsum("bhqk,bhqd->bkhd", ds, qch)[:, :T]
    dv = torch.einsum("bhqk,bhqd->bkhd", p_v, goh)[:, :T]
    dtab = torch.einsum("bhqk,bhqe->ke", ds, gh)[:T] if want_dtab else None
    return dk, dv, dtab


def rel_bwd_plain(qc, k, v, g, table, pad, lse, delta, gout, scale: float,
                  dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dqc, dk, dv (B, T, H, D), dg (B, T, H, E), dtable (T, E) or None)
    fp32: the plain version of the whole K7 backward as the kernels split
    it: the dense terms once, bwd-q from ds, bwd-kv (and dtable) by
    ``xl_bwd_kv_plain`` from the scratch layout of ds and p m / keep."""
    _, _, _, kh, tab, p_v, ds = _bwd_terms(qc, k, v, g, table, pad, lse, delta, gout, scale,
                                           dropout_p, seed)
    dqc = torch.einsum("bhqk,bhkd->bqhd", ds, kh)
    dg = torch.einsum("bhqk,ke->bqhe", ds, tab)
    dk, dv, dtab = xl_bwd_kv_plain(qc, gout, xl_bwd_scratch_plain(ds),
                                   xl_bwd_scratch_plain(p_v), g, None, want_dtab)
    return dqc, dk, dv, dg, dtab


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------


def _streams(qc, k, v, g, table) -> torch.Tensor:
    """Check the streams for the kernels and return the table in the stream
    dtype."""
    _check(qc, k, v, g, head_dims=(REL_D,))
    if k.shape != qc.shape or v.shape != qc.shape or g.shape[-1] != REL_E:
        raise ValueError(f"the kernels take qc, k, v (B, T, H, {REL_D}) and g "
                         f"(B, T, H, {REL_E})")
    return _table(table, qc, REL_E)


def rel_fwd(qc, k, v, g, table, scale: float, pad_mask=None, dropout_p: float = 0.0,
            seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T)): kernel K7 on CUDA tensors (the
    tensor-core forward template's K7 instance, which walks each batch row's
    key tiles up to its last live key), the plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return rel_fwd_plain(qc, k, v, g, table, scale, pad_mask, dropout_p, seed)
    table = _streams(qc, k, v, g, table)
    B, T, H, D = qc.shape
    qc, k, v, g = (x.contiguous() for x in (qc, k, v, g))
    pad, out, lse, stream = _launch_args(qc, pad_mask)
    lib = kernels.library("flash_xl_attention")
    err = lib.vt_flash_rel_fwd(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), table.data_ptr(),
        pad.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, padded_time(T), H, D,
        g.shape[-1], int(qc.dtype == torch.bfloat16), float(scale), float(dropout_p),
        _seed(seed), stream)
    kernels.check(lib, err, "rel flash attention kernel")
    rel_fwd.launches += 1
    return out, lse


rel_fwd.launches = 0


def _rel_ops(qc, k, v, g, table, pad, lse, delta, gout):
    """Checked, contiguous operands of the K7 backward in the layout of the
    K5 / K6 stages: (qc, k, v, g, None, table, pad, lse, delta, gout)."""
    table = _streams(qc, k, v, g, table)
    pad, lse, delta, gout, qc, k, v, g = _bwd_inputs(qc, pad, lse, delta, gout, qc, k, v, g,
                                                     head_dims=(REL_D,))
    return qc, k, v, g, None, table, pad, lse, delta, gout


def rel_bwd_dq(qc, k, v, g, table, pad, lse, delta, gout, scale: float,
               dropout_p: float = 0.0, seed: int = 0):
    """(dqc (B, T, H, D), dg (B, T, H, E)) fp32: kernel K7 bwd-q on CUDA
    tensors (K7's instance of the K5 / K6 bwd-q kernels, three launches on
    a ds scratch: Q1's position logits g t^T, Q1's ds and dqc, Q2's dg =
    ds t; one count), the plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return rel_bwd_dq_plain(qc, k, v, g, table, pad, lse, delta, gout, scale,
                                dropout_p, seed)
    ops = _rel_ops(qc, k, v, g, table, pad, lse, delta, gout)
    dqc, s, _, _ = _bwd_q1(POS_REL, *ops, scale, dropout_p, seed, with_p=False)
    dg, _ = _bwd_q2(POS_REL, s, ops[5], ops[0])
    rel_bwd_dq.launches += 1
    return dqc, dg


rel_bwd_dq.launches = 0


def rel_bwd_dkv(qc, k, v, g, table, pad, lse, delta, gout, scale: float,
                dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dk, dv (B, T, H, D), dtable (T, E) or None) fp32: kernel K7 bwd-kv on
    CUDA tensors (the bwd-kv kernel on the ds and P scratches of K7's Q1,
    which it runs first when standalone; dtable, only with ``want_dtab``,
    by the dtab kernel's K7 instance; one count), the plain version on CPU
    tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return rel_bwd_dkv_plain(qc, k, v, g, table, pad, lse, delta, gout, scale,
                                 dropout_p, seed, want_dtab)
    ops = _rel_ops(qc, k, v, g, table, pad, lse, delta, gout)
    _, _, dk, dv, dtab = _bwd_q1_kv(POS_REL, ops, scale, dropout_p, seed, want_dtab)
    rel_bwd_dkv.launches += 1
    return dk, dv, dtab


rel_bwd_dkv.launches = 0


def rel_bwd(qc, k, v, g, table, pad, lse, delta, gout, scale: float,
            dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dqc, dk, dv (B, T, H, D), dg (B, T, H, E), dtable (T, E) or None)
    fp32, the whole K7 backward: on CUDA tensors bwd-q and bwd-kv on one set
    of scratches (Q1 writes ds and P once, then bwd-kv, with ``want_dtab``
    dtab, and Q2 read them; one count each on ``rel_bwd_dq`` and
    ``rel_bwd_dkv``), on CPU tensors the plain version of that split
    (``rel_bwd_plain``)."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return rel_bwd_plain(qc, k, v, g, table, pad, lse, delta, gout, scale, dropout_p, seed,
                             want_dtab)
    ops = _rel_ops(qc, k, v, g, table, pad, lse, delta, gout)
    dqc, s, dk, dv, dtab = _bwd_q1_kv(POS_REL, ops, scale, dropout_p, seed, want_dtab)
    dg, _ = _bwd_q2(POS_REL, s, ops[5], ops[0])
    rel_bwd_dq.launches += 1
    rel_bwd_dkv.launches += 1
    return dqc, dk, dv, dg, dtab


# --------------------------------------------------------------------------
# autograd: the JAX package's custom VJP
# --------------------------------------------------------------------------


class _RelAttention(torch.autograd.Function):
    """``_rel_op`` with its custom VJP: the forward (K7) saves its inputs,
    the context and lse; the backward computes delta = rowsum(g_out * out)
    outside the kernels, as ``_rel_bwd`` does, and runs the whole K7
    backward, bwd-q and bwd-kv on shared scratches (``rel_bwd``; dtable
    only when the table needs a gradient)."""

    @staticmethod
    def forward(ctx, qc, k, v, g, table, pad, scale, dropout_p, seed):
        out, lse = rel_fwd(qc, k, v, g, table, scale, pad, dropout_p, seed)
        ctx.save_for_backward(qc, k, v, g, table, pad, out, lse)
        ctx.scale, ctx.dropout_p, ctx.seed = scale, dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, g_out):
        qc, k, v, g, table, pad, out, lse = ctx.saved_tensors
        delta, gs = backward_inputs(out, g_out, v.dtype)
        args = (qc, k, v, g, table, pad, lse, delta, gs, ctx.scale, ctx.dropout_p, ctx.seed)
        dqc, dk, dv, dg, dtab = rel_bwd(*args, want_dtab=ctx.needs_input_grad[4])
        return (dqc.to(qc.dtype), dk.to(k.dtype), dv.to(v.dtype), dg.to(g.dtype),
                None if dtab is None else dtab.to(table.dtype), None, None, None, None)


def flash_rel_attention(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                        table: torch.Tensor, scale: float,
                        pad_mask: Optional[torch.Tensor] = None, dropout_p: float = 0.0,
                        dropout_seed: Optional[int] = None) -> torch.Tensor:
    """espnet 'latest' rel-pos attention (feature-last API): qc = q +
    pos_bias_u, k, v (B, T, H, D); g (B, T, H, E) the pre-rotated position
    queries; table (T, E) the negative half of the symmetric table; pad_mask
    (B, T) True at padding keys. Returns (B, T, H*D) in qc's dtype.
    Differentiable (K7 bwd-q and bwd-kv); ``dropout_seed`` keys the
    attention-weight dropout mask (0 when None). Every stream is cast to
    the compute dtype (bf16 when qc is bf16, else fp32), as the JAX wrapper
    casts them: the rotated g arrives in fp32 from a bf16 model."""
    B, T = qc.shape[:2]
    pad = _pad_tensor(pad_mask, B, T, qc.device)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    cd = _compute_dtype(qc)
    k, v, g, table = (x.to(cd) for x in (k, v, g, table))
    return _merge(_RelAttention.apply(qc.to(cd), k, v, g, table, pad, float(scale),
                                      float(dropout_p), seed), qc)
