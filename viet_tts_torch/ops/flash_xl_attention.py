"""Transformer-XL flash attention of the FS2 conformer: kernels K4 (xl3),
K5 (xl2) and K6 (xl), forward, with their plain versions.

Counterpart of the XL flavours of ``viet_tts_tpu/ops/pallas_attention.py``:
``flash_xl3_attention`` (TPU kernel ``_xl3_kernel``), ``flash_xl2_attention``
(``_xl2_kernel``) and ``flash_xl_attention`` (``_xl_kernel``). The three
compute one function, softmax((qc k^T + shift(qv p^T)) * scale) v, from
three parameterisations of the position term (``ops/xl_attention.py``):

- xl3: qc = q + u_bias, k, v, qv = q + v_bias (B, T, H, D) and the
  projected table p = pos_proj(table) (T, H, D); the TPU pads T to a
  multiple of 128 and shears X = qv p'^T in VMEM, so it is routed for
  padded T <= 512;
- xl2: the unrotated stream g = K_h(q + v_bias) (B, T, H, E) and the raw
  table (T, E); the per-row rotations happen in the kernel; T padded to a
  multiple of 32, routed for 512 < padded T <= 1024;
- xl: the pre-rotated streams gA, gB (B, T, H, E) and the table; longer T.

Each public function keeps the JAX one's arguments and result: (B, T, H*D)
in qc's dtype. ``xl3_fwd`` / ``xl2_fwd`` / ``xl_fwd`` return the context
(B, T, H, D) in fp32 with the per-row logsumexp (B, H, T), which a backward
pass needs: the kernel on CUDA tensors, the plain version
(``*_fwd_plain``, the JAX package's dense oracle on the padded inputs) on
CPU tensors, never one for the other.

Padding, as the JAX wrappers do it:
- xl3 appends zero rows up to tp (a multiple of 128), LEFT-pads p by
  d_pad = tp - T and scores the tail keys 2 * MASK_NEG, so that a row whose
  keys are all padding averages over the T real keys;
- xl2 and xl append zero rows up to tp (a multiple of 32) and mark the
  tail as padded keys (MASK_NEG): such a row averages over all tp keys.
xl2 rotates with the real T (``t_sem``), not tp.

Attention-weight dropout belongs to the training slice: the kernels' C
entries take ``dropout_p`` and a seed and refuse any rate but 0, as do the
wrappers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from viet_tts_torch.ops.flash_attention import MASK_NEG, _pad_tensor, padded_time
from viet_tts_torch.runtime import kernels

XL3_MAX_T = 512  # pallas_attention.py:_XL3_MAX_T (a TPU VMEM limit)
XL2_MAX_T = 1024  # pallas_attention.py:_XL2_MAX_T
_HEAD_DIMS = (48, 64)  # head dims the kernels are built for
_MAX_E = 640  # the xl2/xl kernels keep two (32, E) fp32 tiles in shared memory


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


def _softmax_ctx(logits: torch.Tensor, vh: torch.Tensor, cd: torch.dtype):
    """(ctx (B, H, T, D) fp32, lse (B, H, T)) of fp32 logits; the weights
    are rounded to the stream dtype before the product, as in the JAX
    dense path."""
    attn = torch.softmax(logits, dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(cd).float(), vh), lse


def _xl_dense(qch, kh, vh, gA, gB, table, pad, scale: float, cd):
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
    return _softmax_ctx(logits, vh, cd)


def _out(ctx: torch.Tensor, lse: torch.Tensor, T: int):
    return ctx.permute(0, 2, 1, 3)[:, :T], lse[:, :, :T]


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def xl3_fwd_plain(qc, k, v, qv, p, scale: float, pad_mask=None):
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
    return _out(*_softmax_ctx(logits, vh, cd), T)


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
    """Rotate the (2m, 2m+1) pairs of g (..., tp, E) by per-row angles."""
    ge, go = g[..., 0::2], g[..., 1::2]
    return torch.stack([ge * c - go * s, ge * s + go * c], dim=-1).flatten(-2)


def xl2_fwd_plain(qc, k, v, g, table, scale: float, pad_mask=None):
    """``flash_xl2_attention`` as the JAX package computes it off the TPU
    (``_xl2_dense``): qc, k, v (B, T, H, D), the unrotated g (B, T, H, E),
    table (T, E). The rotated streams are rounded to the stream dtype, as
    the kernel rounds them. (The JAX wrapper also de-interleaves the sin/cos
    pairs, a layout for TPU lanes that leaves every dot product as it is.)"""
    B, T, H, D = qc.shape
    E = g.shape[-1]
    cd = _compute_dtype(qc)
    tp = padded_time(T)
    pad = F.pad(_pad_tensor(pad_mask, B, T, qc.device), (0, tp - T), value=1.0)
    qch, kh, vh, gh = (_hm(_pad_rows(x, tp - T), cd) for x in (qc, k, v, g))
    tab = _pad_rows(table.to(cd).float()[None], tp - T)[0]
    ca, sa, cb, sb = xl2_rotations(T, tp, E, qc.device)
    gA = _rotate(gh, ca, sa).to(cd).float()
    g_next = torch.cat([gh[:, :, 1:], torch.zeros_like(gh[:, :, :1])], dim=2)
    gB = _rotate(g_next, cb, sb).to(cd).float()
    return _out(*_xl_dense(qch, kh, vh, gA, gB, tab, pad, scale, cd), T)


def xl_fwd_plain(qc, k, v, gA, gB, table, scale: float, pad_mask=None):
    """``flash_xl_attention`` as the JAX package computes it off the TPU
    (``_xl_dense``): the pre-rotated gA, gB (B, T, H, E) and table (T, E)."""
    B, T, H, D = qc.shape
    cd = _compute_dtype(qc)
    tp = padded_time(T)
    pad = F.pad(_pad_tensor(pad_mask, B, T, qc.device), (0, tp - T), value=1.0)
    qch, kh, vh, gAh, gBh = (_hm(_pad_rows(x, tp - T), cd) for x in (qc, k, v, gA, gB))
    tab = _pad_rows(table.to(cd).float()[None], tp - T)[0]
    return _out(*_xl_dense(qch, kh, vh, gAh, gBh, tab, pad, scale, cd), T)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"XL flash attention runs on cuda or cpu, not {x.device}")
    return x.device.type


def _check_dropout(dropout_p: float) -> None:
    if dropout_p != 0.0:
        raise NotImplementedError(
            "attention-weight dropout in the XL kernels comes with the FS2 "
            "training slice; serving runs them at dropout 0")


def _check(qc: torch.Tensor, *same: torch.Tensor) -> None:
    if qc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"XL flash attention takes fp32 or bf16, not {qc.dtype}")
    B, T, H, D = qc.shape
    for x in same:
        if x.shape[:3] != qc.shape[:3] or x.dtype != qc.dtype or x.device != qc.device:
            raise ValueError("the streams must share (B, T, H), dtype and device")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not built {_HEAD_DIMS}")
    if max(B, H, T) >= 1 << 16:
        raise ValueError("the kernels take B, H, T < 65536")


def _table(table: torch.Tensor, qc: torch.Tensor, E: int) -> torch.Tensor:
    T = qc.shape[1]
    if table.shape != (T, E):
        raise ValueError(f"table must be (T, E) = {(T, E)}, got {tuple(table.shape)}")
    if E % 64 or E > _MAX_E:
        raise ValueError(f"the xl2/xl kernels take E a multiple of 64 up to {_MAX_E}, not {E}")
    return table.to(device=qc.device, dtype=qc.dtype).contiguous()


def _launch_args(qc: torch.Tensor, pad_mask):
    B, T, H, D = qc.shape
    pad = _pad_tensor(pad_mask, B, T, qc.device).contiguous()
    if pad.shape != (B, T):
        raise ValueError(f"pad_mask must be (B, T) = {(B, T)}, got {tuple(pad.shape)}")
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=qc.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=qc.device)
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    return pad, out, lse, stream


def xl3_fwd(qc, k, v, qv, p, scale: float, pad_mask=None, dropout_p: float = 0.0,
            seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T)): kernel K4 on CUDA tensors, the
    plain version on CPU tensors."""
    _check_dropout(dropout_p)
    if _device_of(qc) == "cpu":
        return xl3_fwd_plain(qc, k, v, qv, p, scale, pad_mask)
    _check(qc, k, v, qv)
    B, T, H, D = qc.shape
    if p.shape != (T, H, D):
        raise ValueError(f"p must be (T, H, D) = {(T, H, D)}, got {tuple(p.shape)}")
    qc, k, v, qv = (x.contiguous() for x in (qc, k, v, qv))
    p = p.to(device=qc.device, dtype=qc.dtype).contiguous()
    pad, out, lse, stream = _launch_args(qc, pad_mask)
    lib = kernels.library("flash_xl_attention")
    err = lib.vt_flash_xl3_fwd(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), qv.data_ptr(), p.data_ptr(),
        pad.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, H, D,
        int(qc.dtype == torch.bfloat16), float(scale), float(dropout_p),
        int(seed) & ((1 << 64) - 1), stream)
    kernels.check(lib, err, "XL3 flash attention kernel")
    xl3_fwd.launches += 1
    return out, lse


xl3_fwd.launches = 0


def xl2_fwd(qc, k, v, g, table, scale: float, pad_mask=None, dropout_p: float = 0.0,
            seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T)): kernel K5 on CUDA tensors, the
    plain version on CPU tensors."""
    _check_dropout(dropout_p)
    if _device_of(qc) == "cpu":
        return xl2_fwd_plain(qc, k, v, g, table, scale, pad_mask)
    _check(qc, k, v, g)
    B, T, H, D = qc.shape
    E = g.shape[-1]
    table = _table(table, qc, E)
    qc, k, v, g = (x.contiguous() for x in (qc, k, v, g))
    pad, out, lse, stream = _launch_args(qc, pad_mask)
    lib = kernels.library("flash_xl_attention")
    err = lib.vt_flash_xl2_fwd(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), table.data_ptr(),
        pad.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, padded_time(T), H, D, E,
        int(qc.dtype == torch.bfloat16), float(scale), float(dropout_p),
        int(seed) & ((1 << 64) - 1), stream)
    kernels.check(lib, err, "XL2 flash attention kernel")
    xl2_fwd.launches += 1
    return out, lse


xl2_fwd.launches = 0


def xl_fwd(qc, k, v, gA, gB, table, scale: float, pad_mask=None, dropout_p: float = 0.0,
           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T)): kernel K6 on CUDA tensors, the
    plain version on CPU tensors."""
    _check_dropout(dropout_p)
    if _device_of(qc) == "cpu":
        return xl_fwd_plain(qc, k, v, gA, gB, table, scale, pad_mask)
    _check(qc, k, v, gA, gB)
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
        float(dropout_p), int(seed) & ((1 << 64) - 1), stream)
    kernels.check(lib, err, "XL flash attention kernel")
    xl_fwd.launches += 1
    return out, lse


xl_fwd.launches = 0


# --------------------------------------------------------------------------
# the JAX package's public entry points
# --------------------------------------------------------------------------


def _merge(ctx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    B, T, H, D = ctx.shape
    return ctx.reshape(B, T, H * D).to(like.dtype)


def flash_xl3_attention(qc, k, v, qv, p, scale: float,
                        pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projected-table XL attention: qc = q + u_bias, qv = q + v_bias
    (B, T, H, D), p = pos_proj(table) as (T, H, D) -> (B, T, H*D)."""
    return _merge(xl3_fwd(qc, k, v, qv, p, scale, pad_mask)[0], qc)


def flash_xl2_attention(qc, k, v, g, table, scale: float,
                        pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-stream XL attention: g = K_h(q + v_bias) (B, T, H, E)
    unrotated, table (T, E) raw sinusoids -> (B, T, H*D)."""
    return _merge(xl2_fwd(qc, k, v, g, table, scale, pad_mask)[0], qc)


def flash_xl_attention(qc, k, v, gA, gB, table, scale: float,
                       pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-stream XL attention: gA, gB (B, T, H, E) from ``xl_pos_queries``
    -> (B, T, H*D)."""
    return _merge(xl_fwd(qc, k, v, gA, gB, table, scale, pad_mask)[0], qc)
