"""Batched monotonic alignment search (MAS) on the device.

Counterpart of ``viet_tts_tpu/ops/mas.py`` (``monotonic_alignment``,
``viterbi_decode``, ``binarize_attention``, ``maximum_path``). The JAX package runs the Viterbi DP as two
``lax.scan``s over mel frames; here they are two Python loops over frames
whose bodies are batched over (batch, text) tensor ops on the device, with
no gradient. At T_mel = 512 that is some ten small launches a frame:
latency-bound, and a candidate for a kernel of its own later.

DP: the path starts at (mel 0, text 0), ends at (mel_len-1, text_len-1),
and the text index advances by 0 or 1 per mel frame. Ties prefer the
advance (``shifted >= lp``, as in the JAX package and the reference).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG = -1.0e30  # large-negative instead of -inf: sums and compares stay finite


@torch.no_grad()
def monotonic_alignment(log_attn: torch.Tensor, text_lens: torch.Tensor,
                        mel_lens: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard monotonic path through a batched log-score matrix.

    log_attn (B, T_mel, T_text); text_lens, mel_lens (B,). Returns
    (path (B, T_mel, T_text) fp32 0/1, zero outside the valid region;
    durations (B, T_text) fp32, the path's column sums)."""
    B, T_mel, T_text = log_attn.shape
    dev = log_attn.device
    text_lens = text_lens.to(device=dev, dtype=torch.int64)
    mel_lens = mel_lens.to(device=dev, dtype=torch.int64)
    col = torch.arange(T_text, device=dev)
    text_mask = col[None, :] < text_lens[:, None]
    scores = torch.where(text_mask[:, None, :], log_attn.float(),
                         torch.full((), NEG, device=dev))

    lp = torch.where(col[None, :] == 0, scores[:, 0, :],
                     torch.full((), NEG, device=dev))  # frame 0 sits on text 0
    neg_col = torch.full((B, 1), NEG, device=dev)
    advances = torch.zeros(T_mel, B, T_text, dtype=torch.bool, device=dev)
    for i in range(1, T_mel):
        shifted = torch.cat([neg_col, lp[:, :-1]], dim=1)
        advance = shifted >= lp  # a tie prefers the advance
        lp = torch.clamp(scores[:, i, :] + torch.where(advance, shifted, lp), min=NEG)
        advances[i] = advance

    frames = torch.arange(T_mel, device=dev)[:, None]
    at_end = frames == (mel_lens - 1)[None, :]  # (T_mel, B)
    valid = frames < mel_lens[None, :]
    js = torch.empty(T_mel, B, dtype=torch.int64, device=dev)
    j = text_lens - 1
    for i in range(T_mel - 1, -1, -1):
        j = torch.where(at_end[i], text_lens - 1, j)
        js[i] = j
        moved = advances[i].gather(1, torch.clamp(j, 0, T_text - 1)[:, None])[:, 0]
        j = torch.where(valid[i], j - moved.to(torch.int64), j)
    path = ((col[None, None, :] == js[..., None]) & valid[..., None]).float()
    path = path.transpose(0, 1).contiguous()
    return path, path.sum(dim=1)


def viterbi_decode(log_p_attn: torch.Tensor, text_lens: torch.Tensor,
                   feats_lens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JETS durations + binarization loss.

    log_p_attn (B, T_feats, T_text). Returns (ds (B, T_text) fp32, no
    gradient; bin_loss, the scalar -mean_b(sum_t log_p_attn[t, path(t)] /
    feats_len), differentiable in log_p_attn)."""
    path, ds = monotonic_alignment(log_p_attn, text_lens, feats_lens)
    per_frame = (path * log_p_attn).sum(dim=(1, 2))
    bin_loss = -(per_frame / torch.clamp(feats_lens.to(per_frame.device), min=1)).mean()
    return ds, bin_loss


def binarize_attention(attn: torch.Tensor, in_lens: torch.Tensor,
                       out_lens: torch.Tensor) -> torch.Tensor:
    """FastSpeech2's hard alignment of soft attention probabilities:
    attn (B, 1, T_mel, T_text) -> (B, 1, T_mel, T_text) 0/1 path of the
    MAS through log(max(attn, 1e-30)), no gradient. in_lens text lengths,
    out_lens mel lengths."""
    log_attn = torch.log(torch.clamp(attn[:, 0].detach().float(), min=1e-30))
    path, _ = monotonic_alignment(log_attn, in_lens, out_lens)
    return path[:, None]


def maximum_path(neg_cent: torch.Tensor, text_lens: torch.Tensor,
                 mel_lens: torch.Tensor) -> torch.Tensor:
    """VITS-layout MAS: scores and path (B, T_text, T_mel), no gradient."""
    path, _ = monotonic_alignment(neg_cent.transpose(1, 2), text_lens, mel_lens)
    return path.transpose(1, 2)
