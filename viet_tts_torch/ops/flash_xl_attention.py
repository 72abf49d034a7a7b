"""Transformer-XL flash attention of the FS2 conformer (and of the JETS
conformer's legacy rel-pos flavour): kernels K4 (xl3), K5 (xl2) and K6 (xl)
forward and backward, their plain versions and the autograd functions
around them.

Counterpart of the XL flavours of ``viet_tts_tpu/ops/pallas_attention.py``:
``flash_xl3_attention`` (TPU kernels ``_xl3_kernel`` / ``_xl3_bwd_kernel``,
custom VJP ``_xl3_op``), ``flash_xl2_attention`` (``_xl2_kernel`` /
``_xl2_bwd_q_kernel`` / ``_xl2_bwd_kv_kernel``, ``_xl2_op``) and
``flash_xl_attention`` (``_xl_kernel`` / ``_xl_bwd_q_kernel`` /
``_xl_bwd_kv_kernel``, ``_xl_op``). The three compute one function,
softmax((qc k^T + shift(qv p^T)) * scale) v, from three parameterisations
of the position term (``ops/xl_attention.py``):

- xl3: qc = q + u_bias, k, v, qv = q + v_bias (B, T, H, D) and the
  projected table p = pos_proj(table) (T, H, D); the TPU pads T to a
  multiple of 128 and shears X = qv p'^T in VMEM, so it is routed for
  padded T <= 512;
- xl2: the unrotated stream g = K_h(q + v_bias) (B, T, H, E) and the raw
  table (T, E); the per-row rotations happen on the card (a rotation pass
  into a scratch that K5's kernels read); T padded to a multiple of 32,
  routed for 512 < padded T <= 1024;
- xl: the pre-rotated streams gA, gB (B, T, H, E) and the table; longer T.

Each public function keeps the JAX one's arguments and result: (B, T, H*D)
in qc's dtype; all three are differentiable (``torch.autograd.Function``:
the forward saves its inputs, the context and the logsumexp, the backward
computes delta = rowsum(g * out) outside the kernels, as ``_xl3_bwd`` /
``_xl2_bwd`` / ``_xl_bwd`` do, and launches the backward kernels).
``xl3_fwd`` / ``xl2_fwd`` / ``xl_fwd`` return the context (B, T, H, D) in
fp32 with the per-row logsumexp (B, H, T); ``xl3_bwd``, ``xl2_bwd_dq``,
``xl2_bwd_dkv``, ``xl_bwd_dq`` and ``xl_bwd_dkv`` the gradients in fp32:
the kernel on CUDA tensors, the plain version (``*_plain``: the dense
formulas, the JAX package's dense oracle on the padded inputs and its VJP)
on CPU tensors, never one for the other. ``xl2_bwd`` / ``xl_bwd`` run the
whole K5 / K6 backward, bwd-q and bwd-kv on one set of scratches (bwd-kv
reads the ds and p m / keep that bwd-q's first kernels write; its plain
version ``xl_bwd_kv_plain`` does the same from their scratch layout), as
the autograd functions do. K6 also runs at D = 128 (the JETS conformer's
width).

Padding, as the JAX wrappers do it:
- xl3 appends zero rows up to tp (a multiple of 128), LEFT-pads p by
  d_pad = tp - T and scores the tail keys 2 * MASK_NEG, so that a row whose
  keys are all padding averages over the T real keys;
- xl2 and xl append zero rows up to tp (a multiple of 32) and mark the
  tail as padded keys (MASK_NEG): such a row averages over all tp keys.
xl2 rotates with the real T (``t_sem``), not tp. The backward of a row
whose keys are all padding is the dense gradient (uniform weights), not
the TPU kernels' (see ``csrc/flash_xl_attention_bwd.cu``).

Attention-weight dropout (training): the keep bit of weight (i, j) of
batch row b, head h is ``flash_attention.dropout_keep_mask``'s counter
hash, the one K1 and K3 draw, so the forward, the backward and the plain
versions share the mask. It cannot reproduce the TPU's on-core PRNG bits;
the semantics are the JAX package's (the softmax denominator takes the
undropped weights, the context p * m / keep).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from viet_tts_torch.ops.flash_attention import (
    MASK_NEG,
    _pad_tensor,
    backward_inputs,
    dropout_keep_mask,
    padded_time,
)
from viet_tts_torch.runtime import kernels

XL3_MAX_T = 512  # pallas_attention.py:_XL3_MAX_T (a TPU VMEM limit)
XL2_MAX_T = 1024  # pallas_attention.py:_XL2_MAX_T
_HEAD_DIMS = (48, 64)  # head dims the kernels are built for
_XL_HEAD_DIMS = (48, 64, 128)  # K6 also at the JETS width (legacy rel-pos)
_MAX_E = 640  # the widest table the forwards take (their shared memory is E-free)
# the widest table the backwards take: the widest their card tests hold (no
# backward kernel's shared memory depends on E; ``kMaxEBwd`` in the source)
_MAX_E_BWD = 512
# the position term of the bwd-q kernels (``kPos*`` in ``csrc/xl_mma.cuh``):
# K6's two streams, K5's one stream rotated on the card, K7's g t^T at
# every key
POS_XL, POS_XL_ROT, POS_REL = 0, 1, 2


def xl3_padded_time(t: int) -> int:
    """xl3's padded length: the next multiple of 128."""
    return ((t + 127) // 128) * 128


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Append n zero rows on axis 1 of a (B, T, ...) tensor."""
    if n == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[0], n, *x.shape[2:])], dim=1)


def _hm(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """(B, T, H, X) rounded to the stream dtype, as fp32 (B, H, T, X)."""
    return x.to(cd).float().permute(0, 2, 1, 3)


def _keep_scale(seed: int, B: int, H: int, rows: int, cols: int, dropout_p: float,
                device) -> Optional[torch.Tensor]:
    """(B, H, rows, cols) fp32 m / keep of the dropout mask (None without
    dropout)."""
    if dropout_p == 0.0:
        return None
    keep = dropout_keep_mask(seed, B, H, rows, cols, dropout_p, device)
    return keep.to(torch.float32) * (1.0 / (1.0 - dropout_p))


def _softmax_ctx(logits: torch.Tensor, vh: torch.Tensor, cd: torch.dtype,
                 m: Optional[torch.Tensor] = None):
    """(ctx (B, H, T, D) fp32, lse (B, H, T)) of fp32 logits; dropout (m =
    keep / (1 - p)) after the softmax; the weights are rounded to the stream
    dtype before the product, as in the JAX dense path."""
    attn = torch.softmax(logits, dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    if m is not None:
        attn = attn * m[..., : logits.shape[-2], : logits.shape[-1]]
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(cd).float(), vh), lse


def _xl_dense(qch, kh, vh, gA, gB, table, pad, scale: float, cd, m=None):
    """``pallas_attention.py:_xl_dense`` on head-major fp32 operands: the
    content and both position products, the past / zero / future select,
    padded keys at MASK_NEG."""
    T = qch.shape[2]
    content = torch.einsum("bhqd,bhkd->bhqk", qch, kh)
    pa = torch.einsum("bhqe,ke->bhqk", gA, table)
    pb = torch.einsum("bhqe,ke->bhqk", gB, table)
    i = torch.arange(T, device=qch.device)[:, None]
    j = torch.arange(T, device=qch.device)[None, :]
    pos = torch.where(j <= i, pa, torch.where(j >= i + 2, pb, torch.zeros_like(pb)))
    logits = (content + pos) * scale
    logits = torch.where(pad[:, None, None, :] > 0.5, torch.full_like(logits, MASK_NEG),
                         logits)
    return _softmax_ctx(logits, vh, cd, m)


def _out(ctx: torch.Tensor, lse: torch.Tensor, T: int):
    return ctx.permute(0, 2, 1, 3)[:, :T], lse[:, :, :T]


# --------------------------------------------------------------------------
# plain versions: forward
# --------------------------------------------------------------------------


def xl3_fwd_plain(qc, k, v, qv, p, scale: float, pad_mask=None, dropout_p: float = 0.0,
                  seed: int = 0):
    """``flash_xl3_attention`` as the JAX package computes it off the TPU
    (``_xl3_dense``): qc, k, v, qv (B, T, H, D), p (T, H, D) -> (ctx
    (B, T, H, D) fp32, lse (B, H, T) fp32)."""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    tp = xl3_padded_time(T)
    d_pad = tp - T
    pad = F.pad(_pad_tensor(pad_mask, B, T, qc.device), (0, d_pad), value=1.0)
    qch, kh, vh, qvh = (_hm(_pad_rows(x, d_pad), cd) for x in (qc, k, v, qv))
    ph = F.pad(p.to(cd).float().permute(1, 0, 2), (0, 0, d_pad, 0))  # (H, tp, D)
    x = torch.einsum("bhid,hcd->bhic", qvh, ph)
    x2 = torch.cat([x[:, :, 1:], torch.zeros_like(x[:, :, :1])], dim=2)
    i = torch.arange(tp, device=qc.device)[:, None]
    j = torch.arange(tp, device=qc.device)[None, :]
    shape = x.shape
    s_past = torch.gather(x, -1, ((j - i - 1) % tp).expand(shape))
    s_fut = torch.gather(x2, -1, ((j - i - 2 + d_pad) % tp).expand(shape))
    pos = torch.where(j <= i, s_past, torch.where(j >= i + 2, s_fut, torch.zeros_like(s_fut)))
    logits = (torch.einsum("bhqd,bhkd->bhqk", qch, kh) + pos) * scale
    logits = torch.where(pad[:, None, None, :] > 0.5, torch.full_like(logits, MASK_NEG),
                         logits)
    logits = torch.where(j >= T, torch.full_like(logits, 2.0 * MASK_NEG), logits)
    m = _keep_scale(seed, B, H, tp, tp, dropout_p, qc.device)
    return _out(*_softmax_ctx(logits, vh, cd, m), T)


def xl2_rotations(T: int, tp: int, E: int, device=None):
    """(cos_a, sin_a, cos_b, sin_b), each (tp, E/2) fp32: the kernel's
    per-row angles (``pallas_attention.py:_xl2_cos_sin``): w_m =
    exp(m * (-2 ln 10000 / E)), delta_A = (T - 1) - i, delta_B = -(i + 2),
    with the real T."""
    m = torch.arange(E // 2, dtype=torch.float32, device=device)[None, :]
    coef = torch.tensor(-2.0 * math.log(10000.0) / E, dtype=torch.float32, device=device)
    w = torch.exp(m * coef)
    rows = torch.arange(tp, dtype=torch.float32, device=device)[:, None]
    ang_a = ((float(T) - 1.0) - rows) * w
    ang_b = -(rows + 2.0) * w
    return torch.cos(ang_a), torch.sin(ang_a), torch.cos(ang_b), torch.sin(ang_b)


def _rotate(g: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rotate the (2m, 2m+1) pairs of g (..., tp, E) by per-row angles;
    ``_rotate(g, c, -s)`` is the inverse (the transpose)."""
    ge, go = g[..., 0::2], g[..., 1::2]
    return torch.stack([ge * c - go * s, ge * s + go * c], dim=-1).flatten(-2)


def _xl2_streams(gh: torch.Tensor, T: int, cd: torch.dtype):
    """(gA, gB, rotations) of the head-major unrotated stream gh
    (B, H, rows, E): rotated per row and rounded to the stream dtype, as
    the kernel rounds them."""
    rows, E = gh.shape[2], gh.shape[3]
    ca, sa, cb, sb = xl2_rotations(T, rows, E, gh.device)
    gA = _rotate(gh, ca, sa).to(cd).float()
    g_next = torch.cat([gh[:, :, 1:], torch.zeros_like(gh[:, :, :1])], dim=2)
    gB = _rotate(g_next, cb, sb).to(cd).float()
    return gA, gB, (ca, sa, cb, sb)


def xl2_fwd_plain(qc, k, v, g, table, scale: float, pad_mask=None, dropout_p: float = 0.0,
                  seed: int = 0):
    """``flash_xl2_attention`` as the JAX package computes it off the TPU
    (``_xl2_dense``): qc, k, v (B, T, H, D), the unrotated g (B, T, H, E),
    table (T, E). The rotated streams are rounded to the stream dtype, as
    the kernel rounds them. (The JAX wrapper also de-interleaves the sin/cos
    pairs, a layout for TPU lanes that leaves every dot product as it is.)"""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    tp = padded_time(T)
    pad = F.pad(_pad_tensor(pad_mask, B, T, qc.device), (0, tp - T), value=1.0)
    qch, kh, vh, gh = (_hm(_pad_rows(x, tp - T), cd) for x in (qc, k, v, g))
    tab = _pad_rows(table.to(cd).float()[None], tp - T)[0]
    gA, gB, _ = _xl2_streams(gh, T, cd)
    m = _keep_scale(seed, B, H, tp, tp, dropout_p, qc.device)
    return _out(*_xl_dense(qch, kh, vh, gA, gB, tab, pad, scale, cd, m), T)


def xl_fwd_plain(qc, k, v, gA, gB, table, scale: float, pad_mask=None,
                 dropout_p: float = 0.0, seed: int = 0):
    """``flash_xl_attention`` as the JAX package computes it off the TPU
    (``_xl_dense``): the pre-rotated gA, gB (B, T, H, E) and table (T, E)."""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    tp = padded_time(T)
    pad = F.pad(_pad_tensor(pad_mask, B, T, qc.device), (0, tp - T), value=1.0)
    qch, kh, vh, gAh, gBh = (_hm(_pad_rows(x, tp - T), cd) for x in (qc, k, v, gA, gB))
    tab = _pad_rows(table.to(cd).float()[None], tp - T)[0]
    m = _keep_scale(seed, B, H, tp, tp, dropout_p, qc.device)
    return _out(*_xl_dense(qch, kh, vh, gAh, gBh, tab, pad, scale, cd, m), T)


# --------------------------------------------------------------------------
# plain versions: backward
# --------------------------------------------------------------------------


def _weights_and_ds(logits, pad, lse, dpv, delta, m, n_keys: int, scale: float, cd):
    """The FA2 terms of a dense backward, fp32: (p m / keep, ds), both
    rounded to the stream dtype as the kernels round them. logits, dpv
    (B, H, rows, keys); pad (B, keys) 1.0 at dead keys; lse, delta
    (B, H, rows). A batch row whose keys are all dead has the uniform weight
    1 / n_keys, the dense gradient (exp(l - lse) would give 1 there: lse =
    -1e9 + log n rounds to -1e9 in fp32)."""
    dead = pad[:, None, None, :] > 0.5
    p = torch.exp(torch.where(dead, torch.full_like(logits, MASK_NEG), logits)
                  - lse[..., None])
    p = torch.where(dead.all(dim=-1, keepdim=True), torch.full_like(p, 1.0 / n_keys), p)
    p_v = p
    if m is not None:
        dpv = dpv * m
        p_v = p * m
    ds = torch.where(dead, torch.zeros_like(p), p * (dpv - delta[..., None]) * scale)
    return p_v.to(cd).float(), ds.to(cd).float()


def xl3_bwd_plain(qc, k, v, qv, p, pad, lse, delta, g, scale: float,
                  dropout_p: float = 0.0, seed: int = 0):
    """(dqc, dk, dv, dqv (B, T, H, D), dp (T, H, D)), fp32: the plain
    version of K4 bwd (``_xl3_bwd_dense``, the VJP of ``_xl3_dense``).
    qc, k, v, qv, g (the cotangent, stream dtype) (B, T, H, D); p (T, H, D);
    pad (B, T) fp32; lse, delta (B, H, T) fp32. Tail keys past T weigh
    exactly 0 in the reference, so only the T real keys are formed: the past
    term reads p at T-1-i+j, the future term qv_{i+1} against p at j-i-2."""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    qch, kh, vh, qvh, gh = (_hm(x, cd) for x in (qc, k, v, qv, g))
    ph = p.to(cd).float().permute(1, 0, 2)  # (H, T, D)
    x = torch.einsum("bhid,hcd->bhic", qvh, ph)
    x2 = torch.cat([x[:, :, 1:], torch.zeros_like(x[:, :, :1])], dim=2)
    i = torch.arange(T, device=qc.device)[:, None]
    j = torch.arange(T, device=qc.device)[None, :]
    past, fut = j <= i, j >= i + 2
    idx_past = ((T - 1 - i + j) % T).expand(x.shape)
    idx_fut = ((j - i - 2) % T).expand(x.shape)
    pos = torch.where(past, torch.gather(x, -1, idx_past),
                      torch.where(fut, torch.gather(x2, -1, idx_fut), torch.zeros_like(x)))
    logits = (torch.einsum("bhqd,bhkd->bhqk", qch, kh) + pos) * scale
    dpv = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
    m = _keep_scale(seed, B, H, T, T, dropout_p, qc.device)
    p_v, ds = _weights_and_ds(logits, pad, lse, dpv, delta, m, T, scale, cd)
    dqc = torch.einsum("bhqk,bhkd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bhqd->bkhd", ds, qch)
    dv = torch.einsum("bhqk,bhqd->bkhd", p_v, gh)
    zero = torch.zeros_like(ds)
    # ds by offset c: dx[i, c] for the past term, dx2[i, c] for the future
    # term (the gradient of X = qv p^T and of its row shift)
    dx = torch.zeros_like(ds).scatter_add_(-1, idx_past, torch.where(past, ds, zero))
    dx2 = torch.zeros_like(ds).scatter_add_(-1, idx_fut, torch.where(fut, ds, zero))
    dqv_next = torch.einsum("bhic,hcd->bhid", dx2, ph)
    dqv = torch.einsum("bhic,hcd->bhid", dx, ph) + torch.cat(
        [torch.zeros_like(dqv_next[:, :, :1]), dqv_next[:, :, :-1]], dim=2)
    qv_next = torch.cat([qvh[:, :, 1:], torch.zeros_like(qvh[:, :, :1])], dim=2)
    dp = (torch.einsum("bhic,bhid->chd", dx, qvh)
          + torch.einsum("bhic,bhid->chd", dx2, qv_next))
    return dqc, dk, dv, dqv.permute(0, 2, 1, 3), dp


def _xl_bwd_terms(qc, k, v, gA, gB, table, pad, lse, delta, g, scale, dropout_p, seed):
    """Dense terms of the xl2 / xl backward on the T real query rows and the
    tp padded keys, from the head-major fp32 streams gA, gB (B, H, T, E):
    (qch, kh, gh, tab, p m / keep, ds, past mask, future mask). A padded
    query row would add nothing: its cotangent is 0."""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    tp = padded_time(T)
    padp = F.pad(pad, (0, tp - T), value=1.0)
    qch, gh = (_hm(x, cd) for x in (qc, g))
    kh, vh = (_hm(_pad_rows(x, tp - T), cd) for x in (k, v))
    tab = _pad_rows(table.to(cd).float()[None], tp - T)[0]
    i = torch.arange(T, device=qc.device)[:, None]
    j = torch.arange(tp, device=qc.device)[None, :]
    past, fut = j <= i, j >= i + 2
    pa = torch.einsum("bhqe,ke->bhqk", gA, tab)
    pb = torch.einsum("bhqe,ke->bhqk", gB, tab)
    pos = torch.where(past, pa, torch.where(fut, pb, torch.zeros_like(pb)))
    logits = (torch.einsum("bhqd,bhkd->bhqk", qch, kh) + pos) * scale
    dpv = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
    m = _keep_scale(seed, B, H, T, tp, dropout_p, qc.device)
    p_v, ds = _weights_and_ds(logits, padp, lse, dpv, delta, m, tp, scale, cd)
    return qch, kh, gh, tab, p_v, ds, past, fut


def _xl2_bwd_terms(qc, k, v, g2, table, pad, lse, delta, g, scale, dropout_p, seed):
    """``_xl_bwd_terms`` of xl2's unrotated stream g2: (qch, kh, gh, gA, gB,
    tab, rotations, p m / keep, ds, past mask, future mask)."""
    cd = _compute_dtype(qc)
    gA, gB, rot = _xl2_streams(_hm(g2, cd), qc.shape[1], cd)
    qch, kh, gh, tab, p_v, ds, past, fut = _xl_bwd_terms(
        qc, k, v, gA, gB, table, pad, lse, delta, g, scale, dropout_p, seed)
    return qch, kh, gh, gA, gB, tab, rot, p_v, ds, past, fut


def _bwd_dkv(qch, gh, gA, gB, p_v, ds, past, fut, T: int, want_dtab: bool):
    """(dk, dv (B, T, H, D), dtab (T, E) or None) of the dense terms:
    dtab_j = sum_{b,h,i} dsA_ij gA_i + dsB_ij gB_i."""
    dk = torch.einsum("bhqk,bhqd->bkhd", ds, qch)[:, :T]
    dv = torch.einsum("bhqk,bhqd->bkhd", p_v, gh)[:, :T]
    dtab = None
    if want_dtab:
        zero = torch.zeros_like(ds)
        dtab = (torch.einsum("bhqk,bhqe->ke", torch.where(past, ds, zero), gA)
                + torch.einsum("bhqk,bhqe->ke", torch.where(fut, ds, zero), gB))[:T]
    return dk, dv, dtab


def _xl_dq(kh, tab, ds, past, fut):
    """(dqc (B, T, H, D), dgA, dgB (B, H, T, E)) of the dense terms."""
    zero = torch.zeros_like(ds)
    dqc = torch.einsum("bhqk,bhkd->bqhd", ds, kh)
    dgA = torch.einsum("bhqk,ke->bhqe", torch.where(past, ds, zero), tab)
    dgB = torch.einsum("bhqk,ke->bhqe", torch.where(fut, ds, zero), tab)
    return dqc, dgA, dgB


def _xl2_dg2(dgA, dgB, rot):
    """K5's dg2 (B, T, H, E): dg2_i = rot^-1(dgA_i) + rot^-1(dgB_{i-1}), row
    i-1's gB having consumed g2_i."""
    ca, sa, cb, sb = rot
    dgB = _rotate(dgB, cb, -sb)
    dg2 = _rotate(dgA, ca, -sa) + torch.cat(
        [torch.zeros_like(dgB[:, :, :1]), dgB[:, :, :-1]], dim=2)
    return dg2.permute(0, 2, 1, 3)


def xl2_bwd_dq_plain(qc, k, v, g2, table, pad, lse, delta, g, scale: float,
                     dropout_p: float = 0.0, seed: int = 0):
    """(dqc (B, T, H, D), dg2 (B, T, H, E)), fp32: the plain version of K5
    bwd-q (``_xl2_bwd_dense``). g2 the unrotated position stream, g the
    cotangent; other arguments as ``xl3_bwd_plain``."""
    _, kh, _, _, _, tab, rot, _, ds, past, fut = _xl2_bwd_terms(
        qc, k, v, g2, table, pad, lse, delta, g, scale, dropout_p, seed)
    dqc, dgA, dgB = _xl_dq(kh, tab, ds, past, fut)
    return dqc, _xl2_dg2(dgA, dgB, rot)


def xl2_bwd_dkv_plain(qc, k, v, g2, table, pad, lse, delta, g, scale: float,
                      dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dk, dv (B, T, H, D), dtab (T, E) or None), fp32: the plain version
    of K5 bwd-kv; dtab_j = sum_{b,h,i} dsA_ij gA_i + dsB_ij gB_i."""
    qch, _, gh, gA, gB, _, _, p_v, ds, past, fut = _xl2_bwd_terms(
        qc, k, v, g2, table, pad, lse, delta, g, scale, dropout_p, seed)
    return _bwd_dkv(qch, gh, gA, gB, p_v, ds, past, fut, qc.shape[1], want_dtab)


def xl_bwd_dq_plain(qc, k, v, gA, gB, table, pad, lse, delta, g, scale: float,
                    dropout_p: float = 0.0, seed: int = 0):
    """(dqc (B, T, H, D), dgA, dgB (B, T, H, E)), fp32: the plain version of
    K6 bwd-q (``_xl_bwd_dense``, the VJP of ``_xl_dense``). gA, gB the
    pre-rotated position streams, g the cotangent; other arguments as
    ``xl3_bwd_plain``."""
    gAh, gBh = (_hm(x, _compute_dtype(qc)) for x in (gA, gB))
    _, kh, _, tab, _, ds, past, fut = _xl_bwd_terms(
        qc, k, v, gAh, gBh, table, pad, lse, delta, g, scale, dropout_p, seed)
    dqc, dgA, dgB = _xl_dq(kh, tab, ds, past, fut)
    return dqc, dgA.permute(0, 2, 1, 3), dgB.permute(0, 2, 1, 3)


def xl_bwd_dkv_plain(qc, k, v, gA, gB, table, pad, lse, delta, g, scale: float,
                     dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dk, dv (B, T, H, D), dtab (T, E) or None), fp32: the plain version
    of K6 bwd-kv."""
    gAh, gBh = (_hm(x, _compute_dtype(qc)) for x in (gA, gB))
    qch, _, gh, _, p_v, ds, past, fut = _xl_bwd_terms(
        qc, k, v, gAh, gBh, table, pad, lse, delta, g, scale, dropout_p, seed)
    return _bwd_dkv(qch, gh, gAh, gBh, p_v, ds, past, fut, qc.shape[1], want_dtab)


def xl_bwd_scratch_plain(x: torch.Tensor) -> torch.Tensor:
    """A dense term (B, H, T, keys >= T) of the backward (p m / keep or ds)
    laid out as the kernels' fp32 scratch (B, H, T, Ts): 0 at the keys from
    T on, as Q1 ds writes them up to its last 64-key tile (it leaves the
    columns past that tile unwritten, and nothing reads them)."""
    T = x.shape[2]
    return F.pad(x[..., :T].float(), (0, (T + 127) // 128 * 128 - T))


def xl_bwd_kv_plain(qc, g, s, p, ga=None, gb=None, want_dtab: bool = False):
    """(dk, dv (B, T, H, D), dtab (T, E) or None), fp32: the plain version
    of the bwd-kv kernel and of the dtab kernel, from Q1's scratches (B, H,
    T, Ts) fp32: s = ds, p = p m / keep (both already rounded to the stream
    dtype). qc, g (the cotangent) (B, T, H, D); with ``want_dtab`` the
    rotated streams ga, gb (B, T, H, E) in the stream dtype (K5's gab):
    dv_j = sum_i p_ij g_i, dk_j = sum_i ds_ij qc_i, dtab_j = sum_{b,h,i}
    [j <= i] ds_ij gA_i + [j >= i + 2] ds_ij gB_i; with gb None (K7's form,
    ga its g) dtab_j = sum_{b,h,i} ds_ij g_i at every key. Keys past T write
    no row."""
    T = qc.shape[1]
    cd = _compute_dtype(qc)
    S, P = s[..., :T], p[..., :T]
    qch, gh = _hm(qc, cd), _hm(g, cd)
    dk = torch.einsum("bhqk,bhqd->bkhd", S, qch)
    dv = torch.einsum("bhqk,bhqd->bkhd", P, gh)
    dtab = None
    if want_dtab and gb is None:
        dtab = torch.einsum("bhqk,bhqe->ke", S, _hm(ga, cd))
    elif want_dtab:
        i = torch.arange(T, device=qc.device)[:, None]
        j = torch.arange(T, device=qc.device)[None, :]
        zero = torch.zeros_like(S)
        dtab = (torch.einsum("bhqk,bhqe->ke", torch.where(j <= i, S, zero), _hm(ga, cd))
                + torch.einsum("bhqk,bhqe->ke", torch.where(j >= i + 2, S, zero),
                               _hm(gb, cd)))
    return dk, dv, dtab


def xl2_bwd_plain(qc, k, v, g2, table, pad, lse, delta, g, scale: float,
                  dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dqc, dk, dv (B, T, H, D), dg2 (B, T, H, E), dtab (T, E) or None),
    fp32: the plain version of the whole K5 backward as the kernels split
    it: the dense terms once, bwd-q from ds, bwd-kv (and dtab) by
    ``xl_bwd_kv_plain`` from the scratch layout of ds and p m / keep."""
    _, kh, _, gA, gB, tab, rot, p_v, ds, past, fut = _xl2_bwd_terms(
        qc, k, v, g2, table, pad, lse, delta, g, scale, dropout_p, seed)
    dqc, dgA, dgB = _xl_dq(kh, tab, ds, past, fut)
    ga, gb = (x.permute(0, 2, 1, 3) for x in (gA, gB))
    dk, dv, dtab = xl_bwd_kv_plain(qc, g, xl_bwd_scratch_plain(ds), xl_bwd_scratch_plain(p_v),
                                   ga, gb, want_dtab)
    return dqc, dk, dv, _xl2_dg2(dgA, dgB, rot), dtab


def xl_bwd_plain(qc, k, v, gA, gB, table, pad, lse, delta, g, scale: float,
                 dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dqc, dk, dv (B, T, H, D), dgA, dgB (B, T, H, E), dtab (T, E) or
    None), fp32: the plain version of the whole K6 backward as the kernels
    split it (``xl2_bwd_plain``'s, on the two streams)."""
    gAh, gBh = (_hm(x, _compute_dtype(qc)) for x in (gA, gB))
    _, kh, _, tab, p_v, ds, past, fut = _xl_bwd_terms(
        qc, k, v, gAh, gBh, table, pad, lse, delta, g, scale, dropout_p, seed)
    dqc, dgA, dgB = _xl_dq(kh, tab, ds, past, fut)
    dk, dv, dtab = xl_bwd_kv_plain(qc, g, xl_bwd_scratch_plain(ds), xl_bwd_scratch_plain(p_v),
                                   gA, gB, want_dtab)
    return dqc, dk, dv, dgA.permute(0, 2, 1, 3), dgB.permute(0, 2, 1, 3), dtab


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"XL flash attention runs on cuda or cpu, not {x.device}")
    return x.device.type


def _check(qc: torch.Tensor, *same: torch.Tensor, head_dims=_HEAD_DIMS) -> None:
    if qc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"XL flash attention takes fp32 or bf16, not {qc.dtype}")
    B, T, H, D = qc.shape
    for x in same:
        if x.shape[:3] != qc.shape[:3] or x.dtype != qc.dtype or x.device != qc.device:
            raise ValueError("the streams must share (B, T, H), dtype and device")
    if D not in head_dims:
        raise ValueError(f"head dim {D} not built {head_dims}")
    if max(B, H, T) >= 1 << 16:
        raise ValueError("the kernels take B, H, T < 65536")


def _check_rates(dropout_p: float) -> None:
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


def _table(table: torch.Tensor, qc: torch.Tensor, E: int, max_e: int = _MAX_E) -> torch.Tensor:
    T = qc.shape[1]
    if table.shape != (T, E):
        raise ValueError(f"table must be (T, E) = {(T, E)}, got {tuple(table.shape)}")
    if E % 64 or E > max_e:
        raise ValueError(f"the kernels take E a multiple of 64 up to {max_e}, not {E}")
    return table.to(device=qc.device, dtype=qc.dtype).contiguous()


def _proj_table(p: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    B, T, H, D = qc.shape
    if p.shape != (T, H, D):
        raise ValueError(f"p must be (T, H, D) = {(T, H, D)}, got {tuple(p.shape)}")
    return p.to(device=qc.device, dtype=qc.dtype).contiguous()


def _pad_arg(pad_mask, B: int, T: int, device) -> torch.Tensor:
    pad = _pad_tensor(pad_mask, B, T, device).contiguous()
    if pad.shape != (B, T):
        raise ValueError(f"pad_mask must be (B, T) = {(B, T)}, got {tuple(pad.shape)}")
    return pad


def _launch_args(qc: torch.Tensor, pad_mask):
    B, T, H, D = qc.shape
    pad = _pad_arg(pad_mask, B, T, qc.device)
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=qc.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=qc.device)
    return pad, out, lse, _stream(qc)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _seed(seed: int) -> int:
    return int(seed) & ((1 << 64) - 1)


def xl3_fwd(qc, k, v, qv, p, scale: float, pad_mask=None, dropout_p: float = 0.0,
            seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T)): kernel K4 on CUDA tensors, the
    plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl3_fwd_plain(qc, k, v, qv, p, scale, pad_mask, dropout_p, seed)
    _check(qc, k, v, qv)
    B, T, H, D = qc.shape
    qc, k, v, qv = (x.contiguous() for x in (qc, k, v, qv))
    p = _proj_table(p, qc)
    pad, out, lse, stream = _launch_args(qc, pad_mask)
    lib = kernels.library("flash_xl_attention")
    err = lib.vt_flash_xl3_fwd(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), qv.data_ptr(), p.data_ptr(),
        pad.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, H, D,
        int(qc.dtype == torch.bfloat16), float(scale), float(dropout_p), _seed(seed),
        stream)
    kernels.check(lib, err, "XL3 flash attention kernel")
    xl3_fwd.launches += 1
    return out, lse


xl3_fwd.launches = 0


def xl2_fwd(qc, k, v, g, table, scale: float, pad_mask=None, dropout_p: float = 0.0,
            seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T)): kernel K5 on CUDA tensors (two
    launches: the rotation pass into a scratch of the rotated streams, then
    the flash kernel; one count), the plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl2_fwd_plain(qc, k, v, g, table, scale, pad_mask, dropout_p, seed)
    _check(qc, k, v, g)
    B, T, H, D = qc.shape
    E = g.shape[-1]
    table = _table(table, qc, E)
    qc, k, v, g = (x.contiguous() for x in (qc, k, v, g))
    pad, out, lse, stream = _launch_args(qc, pad_mask)
    gab = torch.empty(2, B, T, H, E, dtype=qc.dtype, device=qc.device)  # gA, gB
    lib = kernels.library("flash_xl_attention")
    err = lib.vt_flash_xl2_fwd(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), table.data_ptr(),
        gab.data_ptr(), pad.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T,
        padded_time(T), H, D, E, int(qc.dtype == torch.bfloat16), float(scale),
        float(dropout_p), _seed(seed), stream)
    kernels.check(lib, err, "XL2 flash attention kernel")
    xl2_fwd.launches += 1
    return out, lse


xl2_fwd.launches = 0


def xl_fwd(qc, k, v, gA, gB, table, scale: float, pad_mask=None, dropout_p: float = 0.0,
           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T)): kernel K6 on CUDA tensors, the
    plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl_fwd_plain(qc, k, v, gA, gB, table, scale, pad_mask, dropout_p, seed)
    _check(qc, k, v, gA, gB, head_dims=_XL_HEAD_DIMS)
    B, T, H, D = qc.shape
    E = gA.shape[-1]
    if gB.shape != gA.shape:
        raise ValueError("gA and gB must have one shape")
    table = _table(table, qc, E)
    qc, k, v, gA, gB = (x.contiguous() for x in (qc, k, v, gA, gB))
    pad, out, lse, stream = _launch_args(qc, pad_mask)
    lib = kernels.library("flash_xl_attention")
    err = lib.vt_flash_xl_fwd(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), gA.data_ptr(), gB.data_ptr(),
        table.data_ptr(), pad.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T,
        padded_time(T), H, D, E, int(qc.dtype == torch.bfloat16), float(scale),
        float(dropout_p), _seed(seed), stream)
    kernels.check(lib, err, "XL flash attention kernel")
    xl_fwd.launches += 1
    return out, lse


xl_fwd.launches = 0


def _bwd_inputs(qc, pad, lse, delta, g, *streams, head_dims=_HEAD_DIMS):
    """Contiguous kernel operands of a backward, checked: (pad, lse, delta,
    g, *streams)."""
    B, T, H, D = qc.shape
    _check(qc, g, *streams, head_dims=head_dims)
    if lse.shape != (B, H, T) or delta.shape != (B, H, T):
        raise ValueError(f"lse and delta must be (B, H, T) = {(B, H, T)}")
    pad = _pad_arg(pad, B, T, qc.device)
    return (pad, lse.float().contiguous(), delta.float().contiguous(), g.contiguous(),
            *(x.contiguous() for x in streams))


def xl3_bwd(qc, k, v, qv, p, pad, lse, delta, g, scale: float, dropout_p: float = 0.0,
            seed: int = 0):
    """(dqc, dk, dv, dqv (B, T, H, D), dp (T, H, D)) fp32 of ``xl3_fwd`` for
    the cotangent g (stream dtype) of its context, with delta = rowsum(g *
    out): kernel K4 bwd on CUDA tensors (three launches: the ds kernel,
    which also writes the ds and p m / keep scratches, bwd-kv on them, the
    reduce pass; one count), the plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl3_bwd_plain(qc, k, v, qv, p, pad, lse, delta, g, scale, dropout_p, seed)
    pad, lse, delta, g, qc, k, v, qv = _bwd_inputs(qc, pad, lse, delta, g, qc, k, v, qv)
    p = _proj_table(p, qc)
    B, T, H, D = qc.shape
    f32 = dict(dtype=torch.float32, device=qc.device)
    dqc, dk, dv, dqv, dqv_b = (torch.empty(B, T, H, D, **f32) for _ in range(5))
    dp = torch.empty(T, H, D, **f32)
    n_tiles = -(-T // 64)
    # each (batch row, query tile, head)'s rows of the table's gradient,
    # 64 a key tile and 64 more (``xl3_part_rows`` in the source)
    part = torch.empty(B, n_tiles, H, 64 * (n_tiles + 1), D, **f32)
    s, pm = _ds_scratch(B, T, H, qc.device), _ds_scratch(B, T, H, qc.device)
    lib = kernels.library("flash_xl_attention_bwd")
    err = lib.vt_flash_xl3_bwd(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), qv.data_ptr(), p.data_ptr(), g.data_ptr(),
        pad.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dqv.data_ptr(), dp.data_ptr(), dqv_b.data_ptr(), part.data_ptr(),
        s.data_ptr(), pm.data_ptr(), B, T, H, D, int(qc.dtype == torch.bfloat16),
        float(scale), float(dropout_p), _seed(seed), _stream(qc))
    kernels.check(lib, err, "XL3 flash attention backward kernel")
    xl3_bwd.launches += 1
    return dqc, dk, dv, dqv, dp


xl3_bwd.launches = 0


def _ds_scratch(B: int, T: int, H: int, device) -> torch.Tensor:
    """One of the K4 / K5 / K6 backward's fp32 scratches (B, H, T, Ts), Ts
    = T rounded up to a multiple of 128, which every key tile of the
    kernels divides (``kTsAlign`` in the source): S holds ds (K5 / K6:
    first the position logits), P holds p m / keep for bwd-kv."""
    return torch.empty(B, H, T, (T + 127) // 128 * 128, dtype=torch.float32, device=device)


def _dtab_split(bh: int, T: int, E: int) -> Tuple[int, int]:
    """(n_split, bh_per): the dtab kernel's (64-key, 64-column) tiles split
    the (b, h) rows into n_split shares of bh_per, enough blocks for about
    four on each of the H100's 132 SMs; one share needs no partial sums."""
    tiles = -(-T // 64) * (E // 64)
    per = -(-bh // max(1, min(bh, -(-4 * 132 // tiles))))
    return -(-bh // per), per


def _bwd_q1(pos: int, qc, k, v, ga, gb, table, pad, lse, delta, g, scale: float,
            dropout_p: float, seed: int, with_p: bool):
    """Q1 of the K5 (``pos`` POS_XL_ROT: ga is the unrotated g2, gb None) /
    K6 (POS_XL) / K7 (POS_REL: ga is g, gb None) backward on checked,
    contiguous CUDA operands: (dqc (B, T, H, D) fp32, S (ds), P (p m /
    keep, or None without ``with_p``), the rotated streams (gA, gB)
    (B, T, H, E) in the stream dtype). A stage of the counted wrappers
    below; it counts nothing itself."""
    B, T, H, D = qc.shape
    E = ga.shape[-1]
    rotate = pos == POS_XL_ROT
    dqc = torch.empty(B, T, H, D, dtype=torch.float32, device=qc.device)
    s = _ds_scratch(B, T, H, qc.device)
    p = _ds_scratch(B, T, H, qc.device) if with_p else None
    gab = torch.empty(2, B, T, H, E, dtype=qc.dtype, device=qc.device) if rotate else None
    lib = kernels.library("flash_xl_attention_bwd")
    err = lib.vt_xl_bwd_q1(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), ga.data_ptr(),
        None if gb is None else gb.data_ptr(), table.data_ptr(), g.data_ptr(),
        pad.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqc.data_ptr(),
        None if gab is None else gab.data_ptr(), s.data_ptr(),
        None if p is None else p.data_ptr(), B, T, padded_time(T), H, D, E,
        int(qc.dtype == torch.bfloat16), int(pos), float(scale), float(dropout_p),
        _seed(seed), _stream(qc))
    kernels.check(lib, err, "XL flash attention backward Q1 kernels")
    return dqc, s, p, ((gab[0], gab[1]) if rotate else (ga, gb))


def _bwd_q2(pos: int, s, table, qc):
    """Q2 (K5: and the inverse rotations) from Q1's S: K5's dg2 (and the
    dgB scratch), K6's (dgA, dgB) or K7's (dg, None), (B, T, H, E) fp32. A
    stage; counts nothing."""
    B, T, H, _ = qc.shape
    E = table.shape[-1]
    dg = torch.empty(B, T, H, E, dtype=torch.float32, device=qc.device)
    dgb = None if pos == POS_REL else torch.empty_like(dg)
    lib = kernels.library("flash_xl_attention_bwd")
    err = lib.vt_xl_bwd_q2(s.data_ptr(), table.data_ptr(), dg.data_ptr(),
                           None if dgb is None else dgb.data_ptr(), B, T, H, E,
                           int(qc.dtype == torch.bfloat16), int(pos), _stream(qc))
    kernels.check(lib, err, "XL flash attention backward Q2 kernel")
    return dg, dgb


def _bwd_kv(qc, g, s, p):
    """The bwd-kv kernel: (dk, dv (B, T, H, D) fp32) from Q1's scratches S
    and P and the streams qc, g. A stage; counts nothing."""
    B, T, H, D = qc.shape
    dk = torch.empty(B, T, H, D, dtype=torch.float32, device=qc.device)
    dv = torch.empty_like(dk)
    lib = kernels.library("flash_xl_attention_bwd")
    err = lib.vt_xl_bwd_kv(qc.data_ptr(), g.data_ptr(), s.data_ptr(), p.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), B, T, H, D,
                           int(qc.dtype == torch.bfloat16), _stream(qc))
    kernels.check(lib, err, "XL flash attention bwd_kv kernel")
    return dk, dv


def _bwd_dtab(s, ga, gb):
    """The dtab kernel: dtab (T, E) fp32 from Q1's S and the rotated streams
    gA, gB (B, T, H, E), or K7's g with gb None (every key, no mask). A
    stage; counts nothing."""
    B, T, H, E = ga.shape
    n_split, per = _dtab_split(B * H, T, E)
    f32 = dict(dtype=torch.float32, device=ga.device)
    dtab = torch.empty(T, E, **f32)
    part = torch.empty(n_split, T, E, **f32) if n_split > 1 else None
    lib = kernels.library("flash_xl_attention_bwd")
    err = lib.vt_xl_bwd_dtab(s.data_ptr(), ga.data_ptr(),
                             None if gb is None else gb.data_ptr(),
                             None if part is None else part.data_ptr(), dtab.data_ptr(),
                             n_split, per, B, T, H, E, int(ga.dtype == torch.bfloat16),
                             _stream(ga))
    kernels.check(lib, err, "XL flash attention dtab kernel")
    return dtab


def _bwd_q1_kv(pos: int, ops, scale, dropout_p, seed, want_dtab: bool):
    """Q1 with P, bwd-kv and (with ``want_dtab``) dtab of K5 (``pos``
    POS_XL_ROT), K6 (POS_XL) or K7 (POS_REL, gb None) on the checked
    operands ``ops`` = (qc, k, v, ga, gb, table, pad, lse, delta, g): (dqc,
    S, dk, dv, dtab or None)."""
    qc, k, v, ga, gb, table, pad, lse, delta, g = ops
    dqc, s, p, (ra, rb) = _bwd_q1(pos, qc, k, v, ga, gb, table, pad, lse, delta, g, scale,
                                  dropout_p, seed, with_p=True)
    dk, dv = _bwd_kv(qc, g, s, p)
    del p
    return dqc, s, dk, dv, (_bwd_dtab(s, ra, rb) if want_dtab else None)


def _xl2_ops(qc, k, v, g2, table, pad, lse, delta, g):
    """Checked, contiguous operands of the K5 backward: (qc, k, v, g2, None,
    table, pad, lse, delta, g)."""
    pad, lse, delta, g, qc, k, v, g2 = _bwd_inputs(qc, pad, lse, delta, g, qc, k, v, g2)
    table = _table(table, qc, g2.shape[-1], _MAX_E_BWD)
    return qc, k, v, g2, None, table, pad, lse, delta, g


def xl2_bwd_dq(qc, k, v, g2, table, pad, lse, delta, g, scale: float,
               dropout_p: float = 0.0, seed: int = 0):
    """(dqc (B, T, H, D), dg2 (B, T, H, E)) fp32: kernel K5 bwd-q on CUDA
    tensors (five launches: the rotations, Q1's position logits and ds, Q2,
    the inverse rotations; one count), the plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl2_bwd_dq_plain(qc, k, v, g2, table, pad, lse, delta, g, scale, dropout_p,
                                seed)
    ops = _xl2_ops(qc, k, v, g2, table, pad, lse, delta, g)
    qc, k, v, g2, _, table, pad, lse, delta, g = ops
    dqc, s, _, _ = _bwd_q1(POS_XL_ROT, qc, k, v, g2, None, table, pad, lse, delta, g, scale,
                           dropout_p, seed, with_p=False)
    dg2, _ = _bwd_q2(POS_XL_ROT, s, table, qc)
    xl2_bwd_dq.launches += 1
    return dqc, dg2


xl2_bwd_dq.launches = 0


def xl2_bwd_dkv(qc, k, v, g2, table, pad, lse, delta, g, scale: float,
                dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dk, dv (B, T, H, D), dtab (T, E) or None) fp32: kernel K5 bwd-kv on
    CUDA tensors (standalone it first runs Q1 to fill the scratches it
    reads: the rotations, the position logits, ds and P; one count), the
    plain version on CPU tensors. dtab only with ``want_dtab`` (the
    conformer's table is a constant)."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl2_bwd_dkv_plain(qc, k, v, g2, table, pad, lse, delta, g, scale, dropout_p,
                                 seed, want_dtab)
    ops = _xl2_ops(qc, k, v, g2, table, pad, lse, delta, g)
    _, _, dk, dv, dtab = _bwd_q1_kv(POS_XL_ROT, ops, scale, dropout_p, seed, want_dtab)
    xl2_bwd_dkv.launches += 1
    return dk, dv, dtab


xl2_bwd_dkv.launches = 0


def xl2_bwd(qc, k, v, g2, table, pad, lse, delta, g, scale: float,
            dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dqc, dk, dv (B, T, H, D), dg2 (B, T, H, E), dtab (T, E) or None)
    fp32, the whole K5 backward: on CUDA tensors bwd-q and bwd-kv on one
    set of scratches (Q1 writes S and P once, then Q2 and the inverse
    rotations, bwd-kv and, with ``want_dtab``, dtab read them; one count
    each on ``xl2_bwd_dq`` and ``xl2_bwd_dkv``), on CPU tensors the plain
    version of that split (``xl2_bwd_plain``)."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl2_bwd_plain(qc, k, v, g2, table, pad, lse, delta, g, scale, dropout_p, seed,
                             want_dtab)
    ops = _xl2_ops(qc, k, v, g2, table, pad, lse, delta, g)
    dqc, s, dk, dv, dtab = _bwd_q1_kv(POS_XL_ROT, ops, scale, dropout_p, seed, want_dtab)
    dg2, _ = _bwd_q2(POS_XL_ROT, s, ops[5], ops[0])
    xl2_bwd_dq.launches += 1
    xl2_bwd_dkv.launches += 1
    return dqc, dk, dv, dg2, dtab


def _xl_ops(qc, k, v, gA, gB, table, pad, lse, delta, g):
    """Checked, contiguous operands of the K6 backward: (qc, k, v, gA, gB,
    table, pad, lse, delta, g)."""
    pad, lse, delta, g, qc, k, v = _bwd_inputs(qc, pad, lse, delta, g, qc, k, v,
                                               head_dims=_XL_HEAD_DIMS)
    _check(qc, gA, gB, head_dims=_XL_HEAD_DIMS)
    if gB.shape != gA.shape:
        raise ValueError("gA and gB must have one shape")
    table = _table(table, qc, gA.shape[-1], _MAX_E_BWD)
    return qc, k, v, gA.contiguous(), gB.contiguous(), table, pad, lse, delta, g


def xl_bwd_dq(qc, k, v, gA, gB, table, pad, lse, delta, g, scale: float,
              dropout_p: float = 0.0, seed: int = 0):
    """(dqc (B, T, H, D), dgA, dgB (B, T, H, E)) fp32: kernel K6 bwd-q on
    CUDA tensors (three launches: Q1's position logits and ds, Q2; one
    count), the plain version on CPU tensors."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl_bwd_dq_plain(qc, k, v, gA, gB, table, pad, lse, delta, g, scale, dropout_p,
                               seed)
    qc, k, v, gA, gB, table, pad, lse, delta, g = _xl_ops(
        qc, k, v, gA, gB, table, pad, lse, delta, g)
    dqc, s, _, _ = _bwd_q1(POS_XL, qc, k, v, gA, gB, table, pad, lse, delta, g, scale,
                           dropout_p, seed, with_p=False)
    dgA, dgB = _bwd_q2(POS_XL, s, table, qc)
    xl_bwd_dq.launches += 1
    return dqc, dgA, dgB


xl_bwd_dq.launches = 0


def xl_bwd_dkv(qc, k, v, gA, gB, table, pad, lse, delta, g, scale: float,
               dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dk, dv (B, T, H, D), dtab (T, E) or None) fp32: kernel K6 bwd-kv on
    CUDA tensors (standalone it first runs Q1 to fill the scratches it
    reads; one count), the plain version on CPU tensors. dtab only with
    ``want_dtab`` (the conformers' table is a constant)."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl_bwd_dkv_plain(qc, k, v, gA, gB, table, pad, lse, delta, g, scale,
                                dropout_p, seed, want_dtab)
    ops = _xl_ops(qc, k, v, gA, gB, table, pad, lse, delta, g)
    _, _, dk, dv, dtab = _bwd_q1_kv(POS_XL, ops, scale, dropout_p, seed, want_dtab)
    xl_bwd_dkv.launches += 1
    return dk, dv, dtab


xl_bwd_dkv.launches = 0


def xl_bwd(qc, k, v, gA, gB, table, pad, lse, delta, g, scale: float,
           dropout_p: float = 0.0, seed: int = 0, want_dtab: bool = False):
    """(dqc, dk, dv (B, T, H, D), dgA, dgB (B, T, H, E), dtab (T, E) or
    None) fp32, the whole K6 backward: on CUDA tensors bwd-q and bwd-kv on
    one set of scratches (one count each on ``xl_bwd_dq`` and
    ``xl_bwd_dkv``), on CPU tensors the plain version of that split
    (``xl_bwd_plain``)."""
    _check_rates(dropout_p)
    if _device_of(qc) == "cpu":
        return xl_bwd_plain(qc, k, v, gA, gB, table, pad, lse, delta, g, scale, dropout_p, seed,
                            want_dtab)
    ops = _xl_ops(qc, k, v, gA, gB, table, pad, lse, delta, g)
    dqc, s, dk, dv, dtab = _bwd_q1_kv(POS_XL, ops, scale, dropout_p, seed, want_dtab)
    dgA, dgB = _bwd_q2(POS_XL, s, ops[5], ops[0])
    xl_bwd_dq.launches += 1
    xl_bwd_dkv.launches += 1
    return dqc, dk, dv, dgA, dgB, dtab


# --------------------------------------------------------------------------
# autograd: the JAX package's custom VJPs
# --------------------------------------------------------------------------


class _XL3Attention(torch.autograd.Function):
    """``_xl3_op`` with its custom VJP: the forward (K4) saves its inputs,
    the context and lse; the backward computes delta and launches K4 bwd."""

    @staticmethod
    def forward(ctx, qc, k, v, qv, p, pad, scale, dropout_p, seed):
        out, lse = xl3_fwd(qc, k, v, qv, p, scale, pad, dropout_p, seed)
        ctx.save_for_backward(qc, k, v, qv, p, pad, out, lse)
        ctx.scale, ctx.dropout_p, ctx.seed = scale, dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, gout):
        qc, k, v, qv, p, pad, out, lse = ctx.saved_tensors
        delta, g = backward_inputs(out, gout, v.dtype)
        grads = xl3_bwd(qc, k, v, qv, p, pad, lse, delta, g, ctx.scale, ctx.dropout_p,
                        ctx.seed)
        return (*(gr.to(x.dtype) for gr, x in zip(grads, (qc, k, v, qv, p))),
                None, None, None, None)


class _XL2Attention(torch.autograd.Function):
    """``_xl2_op`` with its custom VJP: the forward (K5) saves its inputs,
    the context and lse; the backward computes delta and runs the whole K5
    backward, bwd-q and bwd-kv on shared scratches (``xl2_bwd``; dtab only
    when the table needs a gradient)."""

    @staticmethod
    def forward(ctx, qc, k, v, g2, table, pad, scale, dropout_p, seed):
        out, lse = xl2_fwd(qc, k, v, g2, table, scale, pad, dropout_p, seed)
        ctx.save_for_backward(qc, k, v, g2, table, pad, out, lse)
        ctx.scale, ctx.dropout_p, ctx.seed = scale, dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, gout):
        qc, k, v, g2, table, pad, out, lse = ctx.saved_tensors
        delta, g = backward_inputs(out, gout, v.dtype)
        dqc, dk, dv, dg2, dtab = xl2_bwd(qc, k, v, g2, table, pad, lse, delta, g, ctx.scale,
                                         ctx.dropout_p, ctx.seed,
                                         want_dtab=ctx.needs_input_grad[4])
        return (dqc.to(qc.dtype), dk.to(k.dtype), dv.to(v.dtype), dg2.to(g2.dtype),
                None if dtab is None else dtab.to(table.dtype), None, None, None, None)


class _XLAttention(torch.autograd.Function):
    """``_xl_op`` with its custom VJP: the forward (K6) saves its inputs,
    the context and lse; the backward computes delta, casts the cotangent
    to v's dtype and runs the whole K6 backward (``xl_bwd``; dtab only when
    the table needs a gradient)."""

    @staticmethod
    def forward(ctx, qc, k, v, gA, gB, table, pad, scale, dropout_p, seed):
        out, lse = xl_fwd(qc, k, v, gA, gB, table, scale, pad, dropout_p, seed)
        ctx.save_for_backward(qc, k, v, gA, gB, table, pad, out, lse)
        ctx.scale, ctx.dropout_p, ctx.seed = scale, dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, gout):
        qc, k, v, gA, gB, table, pad, out, lse = ctx.saved_tensors
        delta, g = backward_inputs(out, gout, v.dtype)
        dqc, dk, dv, dgA, dgB, dtab = xl_bwd(qc, k, v, gA, gB, table, pad, lse, delta, g,
                                             ctx.scale, ctx.dropout_p, ctx.seed,
                                             want_dtab=ctx.needs_input_grad[5])
        return (dqc.to(qc.dtype), dk.to(k.dtype), dv.to(v.dtype), dgA.to(gA.dtype),
                dgB.to(gB.dtype), None if dtab is None else dtab.to(table.dtype),
                None, None, None, None)


# --------------------------------------------------------------------------
# the JAX package's public entry points
# --------------------------------------------------------------------------


def _merge(ctx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    B, T, H, D = ctx.shape
    return ctx.reshape(B, T, H * D).to(like.dtype)


def flash_xl3_attention(qc, k, v, qv, p, scale: float,
                        pad_mask: Optional[torch.Tensor] = None, dropout_p: float = 0.0,
                        dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Projected-table XL attention: qc = q + u_bias, qv = q + v_bias
    (B, T, H, D), p = pos_proj(table) as (T, H, D) -> (B, T, H*D).
    Differentiable (K4 bwd); ``dropout_seed`` keys the attention-weight
    dropout mask (0 when None)."""
    B, T = qc.shape[:2]
    pad = _pad_tensor(pad_mask, B, T, qc.device)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    return _merge(_XL3Attention.apply(qc, k, v, qv, p, pad, float(scale), float(dropout_p),
                                      seed), qc)


def flash_xl2_attention(qc, k, v, g, table, scale: float,
                        pad_mask: Optional[torch.Tensor] = None, dropout_p: float = 0.0,
                        dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Single-stream XL attention: g = K_h(q + v_bias) (B, T, H, E)
    unrotated, table (T, E) raw sinusoids -> (B, T, H*D). Differentiable
    (K5 bwd-q and bwd-kv); dropout as ``flash_xl3_attention``."""
    B, T = qc.shape[:2]
    pad = _pad_tensor(pad_mask, B, T, qc.device)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    return _merge(_XL2Attention.apply(qc, k, v, g, table, pad, float(scale),
                                      float(dropout_p), seed), qc)


def flash_xl_attention(qc, k, v, gA, gB, table, scale: float,
                       pad_mask: Optional[torch.Tensor] = None, dropout_p: float = 0.0,
                       dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Two-stream XL attention: gA, gB (B, T, H, E) from ``xl_pos_queries``
    -> (B, T, H*D). Differentiable (K6 bwd-q and bwd-kv); dropout as
    ``flash_xl3_attention``. The streams are cast to the compute dtype
    (bf16 when qc is bf16, else fp32), as the JAX wrapper casts them: the
    rotated gA, gB arrive in fp32 from a bf16 model."""
    B, T = qc.shape[:2]
    pad = _pad_tensor(pad_mask, B, T, qc.device)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    cd = _compute_dtype(qc)
    streams = (x.to(cd) for x in (qc, k, v, gA, gB))
    return _merge(_XLAttention.apply(*streams, table, pad, float(scale), float(dropout_p),
                                     seed), qc)
