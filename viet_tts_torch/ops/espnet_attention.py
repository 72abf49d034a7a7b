"""Factorised espnet "latest" rel-pos attention scores (the JETS conformer
stacks' dense route and the inputs of kernel K7).

Counterpart of ``viet_tts_tpu/ops/espnet_attention.py``. The reference's
"latest" relative shift (``nn/espnet_conformer.py:rel_shift``) reads the
symmetric (2T-1, E) table at relative position i - j. Because the table is
the sinusoid table, pulling ``linear_pos`` onto the query side and rotating
row i by +i (``ops/xl_attention.py:rotate_pairs``) turns the shifted score
into one plain dot product against the table's negative half:

    score_pos[i, j] = rot(K_h (q_i + pos_bias_v), +i) . t_{-j}.

Layouts are the JAX package's: streams (B, T, H, D) or (B, T, H, E),
``pos_kernel`` the (E, H*D) flax kernel (``linear_pos.weight.t()`` here).
"""

from __future__ import annotations

import torch

from viet_tts_torch.ops.xl_attention import rotate_pairs


def rel_pos_queries_latest(q_v: torch.Tensor, pos_kernel: torch.Tensor) -> torch.Tensor:
    """g (B, T, H, E): q_v = q + pos_bias_v (B, T, H, D) folded through
    ``pos_kernel`` (E, H*D) and rotated by +i on row i, so that g_i .
    t_{-j} against ``neg_rel_table`` is the shifted position score."""
    B, T, H, D = q_v.shape
    E = pos_kernel.shape[0]
    g = torch.einsum("bthd,ehd->bthe", q_v, pos_kernel.reshape(E, H, D))
    idx = torch.arange(T, dtype=torch.float32, device=q_v.device)
    return rotate_pairs(g, idx, row_axis=-3)


def neg_rel_table(sym_table: torch.Tensor) -> torch.Tensor:
    """The key-side table (T, E): the rows of positions 0, -1, ..., -(T-1)
    of the symmetric (2T-1, E) table (row c holds position T-1-c)."""
    t = (sym_table.shape[0] + 1) // 2
    return sym_table[t - 1:]


def espnet_rel_scores_latest(qc: torch.Tensor, k: torch.Tensor, g: torch.Tensor,
                             neg_table: torch.Tensor, scale: float) -> torch.Tensor:
    """Dense factorised 'latest' logits (B, H, T, T): qc = q + pos_bias_u and
    k (B, T, H, D); g from ``rel_pos_queries_latest``; neg_table (T, E)."""
    content = torch.einsum("bqhd,bkhd->bhqk", qc, k)
    pos = torch.einsum("bqhe,ke->bhqk", g, neg_table)
    return (content + pos) * scale
