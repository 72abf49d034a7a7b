"""Plain scaled-dot MHA flash attention: kernels K1 (forward, with
attention-weight dropout) and K3 (FA2 backward), with their plain versions
and the autograd function around them.

Counterpart of the plain flavour of ``viet_tts_tpu/ops/pallas_attention.py``
(public ``flash_attention``; ``_plain_op`` / ``_plain_fwd`` / ``_plain_bwd``;
TPU kernels ``_plain_kernel``, ``_plain_bwd_q_kernel`` and
``_plain_bwd_kv_kernel``). The JAX package's feature-last API is kept: q/k/v
(B, T, H, D) in, (B, T, H*D) out.

- ``attention_fwd`` / ``attention_fwd_plain``: K1 (the instance of the
  tensor-core flash forward template ``xl2_fwd_kernel`` with no position
  term, ``csrc/flash_xl_attention.cu``, which K5, K6 and K7 run too) and
  the dense PyTorch version (the (B, H, T, Tp) logits exist in memory),
  with the JAX wrapper's padding of T to Tp, the next multiple of 32.
- ``attention_bwd_dq`` / ``attention_bwd_dkv``: K3a and K3b
  (``csrc/flash_attention_bwd.cu``), with ``attention_bwd_dq_plain`` /
  ``attention_bwd_dkv_plain`` beside them; ``attention_bwd`` and
  ``attention_bwd_plain`` compute delta = rowsum(g * out) and run both.
- ``flash_attention``: the public op, a ``torch.autograd.Function`` whose
  forward is K1 and whose backward is K3.

Every wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors only; there is no fallback from one to the other.

Kernel notes (full text in the .cu sources): one block per (64-row tile,
head, batch row) loops over the other axis's 64-row tiles staged in shared
memory, so no (T, T) matrix reaches device memory; K1 keeps an online
softmax, bwd_q accumulates dq over keys, bwd_kv dk and dv over queries. All
three are bound by operations at the JETS shapes. K1 runs both products
on the tensor cores (``mma.sync`` TF32, 3xTF32 for fp32 streams, one TF32
product for bf16; ``tests/test_torch_flash_fwd_precision.py`` says why)
and walks each batch row's key tiles only up to its last live key; K3a /
K3b run on the fp32 CUDA cores. Padded keys score ``MASK_NEG = -1e9`` as
on the TPU, so a row whose keys are all padding becomes the uniform
average over all Tp keys (K1 walks every tile there); its gradient is the
dense path's (p = 1/Tp), not the TPU kernel's (see
``attention_bwd_plain``).

Dropout: the mask is a counter-based hash of (seed, b, h, i, j)
(``csrc/dropout_hash.cuh``; ``dropout_keep_mask`` here computes the same
bits), so the three kernels and the plain versions draw the same mask. It
cannot reproduce the TPU's on-core PRNG bits nor ``jax.random.bernoulli``;
the semantics are the JAX package's: the softmax denominator takes the
undropped weights, the context p * m / keep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from viet_tts_torch.runtime import kernels

MASK_NEG = -1.0e9
_M32 = 0xFFFFFFFF
_MAX_T = 1 << 16  # the hash packs b, h, i and j into 16 bits each


def padded_time(t: int) -> int:
    """Time length the TPU kernel runs at: the next multiple of 32
    (``pallas_attention.py:_padded_time``)."""
    return ((t + 31) // 32) * 32


def _pad_tensor(pad_mask: Optional[torch.Tensor], B: int, T: int,
                device) -> torch.Tensor:
    if pad_mask is None:
        return torch.zeros(B, T, dtype=torch.float32, device=device)
    return pad_mask.to(torch.float32)


# --------------------------------------------------------------------------
# dropout bits (the same hash as csrc/dropout_hash.cuh)
# --------------------------------------------------------------------------


def _mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) (int or int64 tensor): the product
    is split into 16-bit limbs so that no partial product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """murmur3's 32-bit finaliser on ints or int64 tensors in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_threshold(dropout_p: float) -> int:
    """Keep an element when its 32-bit hash is below this (the JAX
    package's ``_tile_dropout_mask`` rule)."""
    return min(int((1.0 - dropout_p) * 4294967296.0), _M32)


def dropout_keep_mask(seed: int, B: int, H: int, T: int, Tp: int,
                      dropout_p: float, device=None) -> torch.Tensor:
    """(B, H, T, Tp) bool: True where attention weight (query i, key j) of
    batch row b, head h is kept. Bit for bit the kernels' mask."""
    if max(B, H, T, Tp) > _MAX_T:
        raise ValueError(f"dropout hash packs B, H, T < {_MAX_T}")
    seed = int(seed) & ((1 << 64) - 1)
    k = _fmix32((seed & _M32) ^ 0x9E3779B9)
    k = _fmix32(k ^ (seed >> 32))
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    h = torch.arange(H, dtype=torch.int64, device=device)[None, :]
    key = _fmix32(k ^ ((b << 16) | h))[:, :, None, None]  # (B, H, 1, 1)
    i = torch.arange(T, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(Tp, dtype=torch.int64, device=device)[None, :]
    x = _fmix32(key ^ ((i << 16) | j))
    x = _fmix32((x + key) & _M32)
    return x < dropout_threshold(dropout_p)


# --------------------------------------------------------------------------
# forward: K1
# --------------------------------------------------------------------------


def attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    pad_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reference: q/k/v (B, T, H, D) -> (ctx (B, T, H, D) fp32,
    lse (B, H, T) fp32), computed as the JAX package's ``flash_attention``
    computes it: T padded to Tp with zero rows and pad = 1, logits in fp32,
    padding keys set to MASK_NEG, softmax, dropout (kept weights / keep),
    probabilities cast to v's dtype. Differentiable by autograd."""
    B, T, H, D = q.shape
    cd = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    pad = _pad_tensor(pad_mask, B, T, q.device)
    tp = padded_time(T)
    if tp != T:
        k, v = (F.pad(x, (0, 0, 0, 0, 0, tp - T)) for x in (k, v))
        pad = F.pad(pad, (0, tp - T), value=1.0)
    qh, kh, vh = (x.to(cd).permute(0, 2, 1, 3) for x in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    logits = torch.where(pad[:, None, None, :] > 0.5,
                         torch.full_like(logits, MASK_NEG), logits)
    attn = torch.softmax(logits, dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, B, H, T, tp, dropout_p, q.device)
        attn = torch.where(keep, attn * (1.0 / (1.0 - dropout_p)),
                           torch.zeros_like(attn))
    ctx = torch.einsum("bhqk,bhkd->bhqd", attn.to(cd).float(), vh.float())
    return ctx.permute(0, 2, 1, 3), lse


def _check_stream(q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes fp32 or bf16, not {q.dtype}")
    for x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError("q, k, v (and g) must share shape, dtype and device")
    B, T, H, D = q.shape
    if D not in (32, 64, 128):
        raise ValueError(f"head dim {D} not built (32, 64 or 128)")
    if max(B, H, T) >= _MAX_T:
        raise ValueError(f"the kernels take B, H, T < {_MAX_T}")


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    pad_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B, T, H, D) fp32, lse (B, H, T) fp32): kernel K1 on CUDA
    tensors (the tensor-core forward template's instance with no position
    term), the plain version on CPU tensors."""
    if _device_of(q) == "cpu":
        return attention_fwd_plain(q, k, v, scale, pad_mask, dropout_p, seed)
    _check_stream(q, k, v)
    B, T, H, D = q.shape
    q, k, v = (x.contiguous() for x in (q, k, v))
    pad = _pad_tensor(pad_mask, B, T, q.device).contiguous()
    if pad.shape != (B, T):
        raise ValueError(f"pad_mask must be (B, T) = {(B, T)}, got {tuple(pad.shape)}")
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    lib = kernels.library("flash_xl_attention")
    err = lib.vt_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, padded_time(T), H, D,
        int(q.dtype == torch.bfloat16), float(scale), float(dropout_p),
        int(seed) & ((1 << 64) - 1), _stream(q),
    )
    kernels.check(lib, err, "flash attention kernel")
    attention_fwd.launches += 1
    return out, lse


attention_fwd.launches = 0


# --------------------------------------------------------------------------
# backward: K3a (dq) and K3b (dk, dv)
# --------------------------------------------------------------------------


def _bwd_terms(q, k, v, g, pad, lse, delta, scale, dropout_p, seed):
    """Dense FA2 terms in fp32, head-major: (qh, kh, gh, p * m / keep, ds),
    the last two (B, H, T, T) and rounded to the stream dtype as the kernels
    round them. Keys in [T, Tp) are dead (ds = 0) and their dk, dv are not
    outputs, so only the T real keys are formed.

    A batch row whose keys are all padding has the uniform softmax
    p = 1/Tp, which is what the dense path differentiates; exp(s - lse)
    would give 1 there, because lse = -1e9 + log(Tp) rounds to -1e9 in fp32
    (the TPU kernel's dv on such a row is Tp times too large)."""
    B, T, H, D = q.shape
    tp = padded_time(T)
    cd = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    qh, kh, vh, gh = (x.to(cd).float().permute(0, 2, 1, 3) for x in (q, k, v, g))
    dead = pad[:, None, None, :] > 0.5  # (B, 1, 1, T)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    p = torch.exp(torch.where(dead, torch.full_like(s, MASK_NEG), s) - lse[..., None])
    p = torch.where(dead.all(dim=-1, keepdim=True), torch.full_like(p, 1.0 / tp), p)
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
    if dropout_p > 0.0:
        m = dropout_keep_mask(seed, B, H, T, T, dropout_p, q.device)
        m = m.to(torch.float32) * (1.0 / (1.0 - dropout_p))
        dp = dp * m
        p_v = p * m
    else:
        p_v = p
    ds = torch.where(dead, torch.zeros_like(p), p * (dp - delta[..., None]) * scale)
    return qh, kh, gh, p_v.to(cd).float(), ds.to(cd).float()


def attention_bwd_dq_plain(q, k, v, g, pad, lse, delta, scale: float,
                           dropout_p: float = 0.0, seed: int = 0) -> torch.Tensor:
    """dq (B, T, H, D) fp32 = ds k: the plain version of K3a. g in the
    stream dtype, pad (B, T) fp32, lse and delta (B, H, T) fp32."""
    _, kh, _, _, ds = _bwd_terms(q, k, v, g, pad, lse, delta, scale, dropout_p, seed)
    return torch.einsum("bhqk,bhkd->bqhd", ds, kh)


def attention_bwd_dkv_plain(q, k, v, g, pad, lse, delta, scale: float,
                            dropout_p: float = 0.0, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (B, T, H, D) fp32 = (ds^T q, (p m / keep)^T g): the plain
    version of K3b."""
    qh, _, gh, p_v, ds = _bwd_terms(q, k, v, g, pad, lse, delta, scale,
                                    dropout_p, seed)
    return (torch.einsum("bhqk,bhqd->bkhd", ds, qh),
            torch.einsum("bhqk,bhqd->bkhd", p_v, gh))


def attention_bwd_dq(q, k, v, g, pad, lse, delta, scale: float,
                     dropout_p: float = 0.0, seed: int = 0) -> torch.Tensor:
    """dq: kernel K3a on CUDA tensors, the plain version on CPU tensors."""
    if _device_of(q) == "cpu":
        return attention_bwd_dq_plain(q, k, v, g, pad, lse, delta, scale,
                                      dropout_p, seed)
    _check_stream(q, k, v, g)
    B, T, H, D = q.shape
    q, k, v, g, pad, lse, delta = (x.contiguous() for x in (q, k, v, g, pad, lse, delta))
    dq = torch.empty(B, T, H, D, dtype=torch.float32, device=q.device)
    lib = kernels.library("flash_attention_bwd")
    err = lib.vt_flash_attn_bwd_q(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), pad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, T, padded_time(T),
        H, D, int(q.dtype == torch.bfloat16), float(scale), float(dropout_p),
        int(seed) & ((1 << 64) - 1), _stream(q),
    )
    kernels.check(lib, err, "flash attention bwd_q kernel")
    attention_bwd_dq.launches += 1
    return dq


attention_bwd_dq.launches = 0


def attention_bwd_dkv(q, k, v, g, pad, lse, delta, scale: float,
                      dropout_p: float = 0.0, seed: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv): kernel K3b on CUDA tensors, the plain version on CPU
    tensors."""
    if _device_of(q) == "cpu":
        return attention_bwd_dkv_plain(q, k, v, g, pad, lse, delta, scale,
                                       dropout_p, seed)
    _check_stream(q, k, v, g)
    B, T, H, D = q.shape
    q, k, v, g, pad, lse, delta = (x.contiguous() for x in (q, k, v, g, pad, lse, delta))
    dk = torch.empty(B, T, H, D, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    lib = kernels.library("flash_attention_bwd")
    err = lib.vt_flash_attn_bwd_kv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), pad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T,
        padded_time(T), H, D, int(q.dtype == torch.bfloat16), float(scale),
        float(dropout_p), int(seed) & ((1 << 64) - 1), _stream(q),
    )
    kernels.check(lib, err, "flash attention bwd_kv kernel")
    attention_bwd_dkv.launches += 1
    return dk, dv


attention_bwd_dkv.launches = 0


def backward_inputs(out: torch.Tensor, g: torch.Tensor, dtype: torch.dtype):
    """(delta, g_stream): delta = rowsum(g * out) (B, H, T) in fp32 from the
    fp32 cotangent g (B, T, H, D) of ctx ``out`` (``pallas_attention.py:
    _plain_bwd``), and g cast to the stream dtype, as K3 takes them."""
    delta = (g.float() * out).sum(-1).permute(0, 2, 1).contiguous()
    return delta, g.to(dtype).contiguous()


def attention_bwd(q, k, v, pad, out, lse, g, seed: int, scale: float,
                  dropout_p: float = 0.0):
    """(dq, dk, dv) fp32 of ``attention_fwd`` for the cotangent g of its
    ctx: K3a and K3b on CUDA tensors, their plain versions on CPU tensors."""
    delta, gs = backward_inputs(out, g, v.dtype)
    dq = attention_bwd_dq(q, k, v, gs, pad, lse, delta, scale, dropout_p, seed)
    dk, dv = attention_bwd_dkv(q, k, v, gs, pad, lse, delta, scale, dropout_p, seed)
    return dq, dk, dv


def attention_bwd_plain(q, k, v, pad, out, lse, g, seed: int, scale: float,
                        dropout_p: float = 0.0):
    """The plain version of ``attention_bwd`` (dense FA2 formulas, fp32),
    on any device."""
    delta, gs = backward_inputs(out, g, v.dtype)
    dq = attention_bwd_dq_plain(q, k, v, gs, pad, lse, delta, scale, dropout_p, seed)
    dk, dv = attention_bwd_dkv_plain(q, k, v, gs, pad, lse, delta, scale,
                                     dropout_p, seed)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``_plain_op`` with its custom VJP: the forward saves q, k, v, pad,
    seed, out and lse; the backward computes delta outside the kernels and
    launches K3."""

    @staticmethod
    def forward(ctx, q, k, v, pad, scale, dropout_p, seed):
        out, lse = attention_fwd(q, k, v, scale, pad, dropout_p, seed)
        ctx.save_for_backward(q, k, v, pad, out, lse)
        ctx.scale, ctx.dropout_p, ctx.seed = scale, dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, pad, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, pad, out, lse, g, ctx.seed,
                                   ctx.scale, ctx.dropout_p)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    pad_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Plain scaled-dot MHA (feature-last API): q/k/v (B, T, H, D), pad_mask
    (B, T) True at padding keys; returns (B, T, H*D) in q's dtype.
    Differentiable: the backward runs K3 (or its plain version on the CPU).
    ``dropout_seed`` keys the attention-weight dropout mask (0 when None)."""
    B, T, H, D = q.shape
    pad = _pad_tensor(pad_mask, B, T, q.device)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    ctx = _FlashAttention.apply(q, k, v, pad, float(scale), float(dropout_p), seed)
    return ctx.reshape(B, T, H * D).to(q.dtype)
