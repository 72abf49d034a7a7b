"""Transformer-XL relative attention without the shift copies: the dense
oracle of the FS2-conformer attention.

Counterpart of ``viet_tts_tpu/ops/xl_attention.py``. The conformer's
position score is ``(q + v_bias) . pos_proj(table)`` followed by the XL
padded-reshape relative shift, whose exact index map is::

    shifted[i, j] = s[i,   T-1-(i-j)]   for j <= i
                  = 0                    for j == i+1
                  = s[i+1, j-i-2]        for j >  i+1

with ``s[i, c] = (q_i + v_bias) . p_c`` and ``p = pos_proj(table)``.
Because the table is the fixed sinusoid table, ``p_{j+delta}`` is a
per-frequency Givens rotation of ``p_j``, so pulling ``pos_proj`` onto the
query side and rotating per row turns the shifted score into two plain dot
products against the raw table::

    shifted[i, j] = where(j <= i,  gA_i . t_j,  where(j == i+1, 0,  gB_i . t_j))

with ``gA_i = rot(K_h (q_i + v), (T-1-i) w)`` and
``gB_i = rot(K_h (q_{i+1} + v), -(i+2) w)``. Layouts are the JAX package's:
streams (B, T, H, D) or (B, T, H, E), ``pos_kernel`` the (E, H*D) kernel
(``pos_proj.weight.t()`` here), ``table`` (T, E). ``xl_attention`` is the
whole attention, on the dense route or on the flash kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from viet_tts_torch.ops.flash_attention import MASK_NEG, padded_time
from viet_tts_torch.ops.flash_xl_attention import (
    XL2_MAX_T,
    XL3_MAX_T,
    flash_xl2_attention,
    flash_xl3_attention,
    flash_xl_attention,
    xl3_padded_time,
)


def _pair_frequencies(d_model: int, device=None) -> torch.Tensor:
    """w_m = 1 / 10000^(2m/d) for sin/cos pair m, in fp32."""
    m = torch.arange(d_model // 2, dtype=torch.float32, device=device)
    base = torch.tensor(10000.0, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, 2.0 * m / d_model)


def rotate_pairs(g: torch.Tensor, delta: torch.Tensor, row_axis: int = -2) -> torch.Tensor:
    """Per-row Givens rotation of the (2m, 2m+1) pairs of g (..., E):
    ``rot(g_i, delta_i) . t_j == g_i . t_{j + delta_i}`` for the sinusoid
    table t. ``delta`` (T,) gives each row's offset; ``row_axis`` is the
    row axis of g (-2 for (T, E), -3 for (B, T, H, E)). Computed in fp32."""
    E = g.shape[-1]
    w = _pair_frequencies(E, g.device)
    ang = delta.to(torch.float32)[:, None] * w[None, :]  # (T, E/2)
    ang = ang.reshape(ang.shape[0], *([1] * (-row_axis - 2)), ang.shape[1])
    c, s = torch.cos(ang), torch.sin(ang)
    ge, go = g[..., 0::2], g[..., 1::2]
    return torch.stack([ge * c - go * s, ge * s + go * c], dim=-1).flatten(-2)


def xl_pos_query_stream(q_v: torch.Tensor, pos_kernel: torch.Tensor) -> torch.Tensor:
    """The unrotated folded position-query stream g = K_h (q + v_bias):
    q_v (B, T, H, D), pos_kernel (E, H*D) -> (B, T, H, E)."""
    B, T, H, D = q_v.shape
    E = pos_kernel.shape[0]
    return torch.einsum("bthd,ehd->bthe", q_v, pos_kernel.reshape(E, H, D))


def xl_pos_queries(q_v: torch.Tensor,
                   pos_kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gA, gB) (B, T, H, E): the pre-rotated query streams. Row T-1 of gB
    holds the rolled row 0 rotation; only keys past T select it."""
    T = q_v.shape[1]
    g = xl_pos_query_stream(q_v, pos_kernel)
    idx = torch.arange(T, dtype=torch.float32, device=q_v.device)
    gA = rotate_pairs(g, (T - 1) - idx, row_axis=-3)
    gB = rotate_pairs(torch.roll(g, -1, dims=1), -(idx + 2.0), row_axis=-3)
    return gA, gB


def xl_shift_masks(T: int, dtype=torch.float32, device=None):
    """(past, future) {0, 1} masks of the XL select; the j == i+1 diagonal
    is 0 in both."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return (j <= i).to(dtype), (j >= i + 2).to(dtype)


def xl_attention_scores(qc: torch.Tensor, k: torch.Tensor, gA: torch.Tensor,
                        gB: torch.Tensor, table: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Dense factorised XL logits (B, H, T, T): qc = q + u_bias and k
    (B, T, H, D), gA and gB (B, T, H, E), table (T, E)."""
    T = qc.shape[1]
    content = torch.einsum("bqhd,bkhd->bhqk", qc, k)
    pos_a = torch.einsum("bqhe,ke->bhqk", gA, table)
    pos_b = torch.einsum("bqhe,ke->bhqk", gB, table)
    past, future = xl_shift_masks(T, pos_a.dtype, qc.device)
    return (content + (pos_a * past + pos_b * future)) * scale


def xl_attention_reference(qc: torch.Tensor, k: torch.Tensor, q_v: torch.Tensor,
                           pos_kernel: torch.Tensor, table: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """The padded-reshape logits (B, H, T, T): the conformer's shift path."""
    B, T, H, D = qc.shape
    p = (table @ pos_kernel).reshape(T, H, D)
    content = torch.einsum("bqhd,bkhd->bhqk", qc, k)
    pos = torch.einsum("bqhd,khd->bhqk", q_v, p)
    return (content + relative_shift(pos)) * scale


def xl_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, u_bias: torch.Tensor,
                 v_bias: torch.Tensor, pos_kernel: torch.Tensor, table: torch.Tensor,
                 scale: float, pad_mask: Optional[torch.Tensor] = None,
                 implementation: str = "dense", dropout_p: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The whole factorised XL attention: q, k, v (B, T, H, D) -> (B, T, H*D).

    u_bias, v_bias (H, D); pos_kernel (E, H*D); table (T, E); pad_mask
    (B, T) True at padding keys (MASK_NEG). ``implementation`` "dense" forms
    the three-matmul logits and a plain softmax (no dropout, as in the JAX
    function); "flash" runs the kernels routed by padded length: xl3 (K4)
    while the 128-padded T is at most 512, xl2 (K5) while the 32-padded T
    is at most 1024, xl (K6) beyond. With ``dropout_p`` > 0 the flash route
    drops attention weights inside the kernel, keyed by a seed drawn per
    call on the host from ``generator`` (torch's default generator when
    None, where the JAX function, given no ``dropout_rng``, keys every call
    with seed 0)."""
    qc = q + u_bias
    if implementation == "flash":
        seed = None
        if dropout_p > 0.0:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        B, T, H, D = q.shape
        if xl3_padded_time(T) <= XL3_MAX_T:
            p = (table @ pos_kernel).reshape(T, H, D)
            return flash_xl3_attention(qc, k, v, q + v_bias, p, scale, pad_mask, dropout_p,
                                       seed)
        if padded_time(T) <= XL2_MAX_T:
            g = xl_pos_query_stream(q + v_bias, pos_kernel)
            return flash_xl2_attention(qc, k, v, g, table, scale, pad_mask, dropout_p, seed)
        gA, gB = xl_pos_queries(q + v_bias, pos_kernel)
        return flash_xl_attention(qc, k, v, gA, gB, table, scale, pad_mask, dropout_p, seed)
    if implementation != "dense":
        raise ValueError(f"unknown implementation {implementation!r}")
    gA, gB = xl_pos_queries(q + v_bias, pos_kernel)
    scores = xl_attention_scores(qc, k, gA, gB, table, scale)
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask[:, None, None, :], MASK_NEG)
    attn = torch.softmax(scores, dim=-1)
    B, T, H, D = q.shape
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, H * D)


def relative_shift(pos: torch.Tensor) -> torch.Tensor:
    """The XL shift of (B, H, T1, T2) scores: prepend a zero column, fold,
    drop the first row."""
    b, h, t1, t2 = pos.shape
    padded = torch.cat([pos.new_zeros(b, h, t1, 1), pos], dim=-1)
    return padded.reshape(b, h, t2 + 1, t1)[:, :, 1:].reshape(b, h, t1, t2)
