"""Duration-driven expansion, all static-shape.

Counterpart of ``viet_tts_tpu/ops/duration.py``: ``duration_to_index``,
``length_regulator``, ``gaussian_upsample``, ``average_by_duration`` and
``aggregate_by_ids``.
"""

from __future__ import annotations

from typing import Optional

import torch


def duration_to_index(ds: torch.Tensor, t_frames: int) -> torch.Tensor:
    """Frame -> token index map. ds: (B, N) int durations -> (B, t_frames).

    Frame t belongs to token n iff cumsum[n-1] <= t < cumsum[n]; frames past
    the total duration clamp to the last token (masked by callers).
    """
    cum = torch.cumsum(ds.to(torch.int64), dim=-1)  # (B, N)
    t = torch.arange(t_frames, device=ds.device)
    idx = (t[None, :, None] >= cum[:, None, :]).sum(dim=-1)
    return torch.clamp(idx, 0, ds.shape[-1] - 1)


def length_regulator(hs: torch.Tensor, ds: torch.Tensor, t_frames: int,
                     pad_value: float = 0.0) -> torch.Tensor:
    """Expand token states (B, N, C) to frames (B, t_frames, C) by duration;
    frames beyond sum(ds) get ``pad_value``."""
    idx = duration_to_index(ds, t_frames)  # (B, T)
    out = torch.gather(hs, 1, idx[..., None].expand(-1, -1, hs.shape[-1]))
    total = ds.sum(dim=-1, keepdim=True)
    mask = torch.arange(t_frames, device=hs.device)[None, :] < total
    if pad_value == 0.0:
        return out * mask[..., None]
    return torch.where(mask[..., None], out, torch.full_like(out, pad_value))


def gaussian_upsample(hs: torch.Tensor, ds: torch.Tensor,
                      h_masks: Optional[torch.Tensor] = None,
                      d_masks: Optional[torch.Tensor] = None,
                      delta: float = 0.1,
                      t_frames: Optional[int] = None) -> torch.Tensor:
    """Gaussian upsampling (arXiv:2010.04301), espnet semantics.

    hs: (B, N, C) token states; ds: (B, N) durations (float ok); h_masks:
    (B, T) frame validity; d_masks: (B, N) token validity; t_frames: output
    length when h_masks is None. Returns (B, T, C) in hs's dtype. The
    frame positions and weights are computed in fp32 whatever hs's dtype
    (positions up to ~1000 are not exact in bf16).
    """
    if h_masks is not None:
        T = h_masks.shape[-1]
        t = torch.arange(T, dtype=torch.float32, device=hs.device)[None, :] \
            * h_masks.to(torch.float32)
    else:
        if t_frames is None:
            raise ValueError("need t_frames without h_masks")
        T = t_frames
        t = torch.arange(T, dtype=torch.float32,
                         device=hs.device)[None, :].expand(ds.shape[0], T)
    ds = ds.to(torch.float32)
    c = torch.cumsum(ds, dim=-1) - ds / 2.0  # (B, N) segment centres
    energy = -delta * (t[:, :, None] - c[:, None, :]) ** 2  # (B, T, N)
    if d_masks is not None:
        energy = energy.masked_fill(~d_masks[:, None, :], float("-inf"))
    p_attn = torch.exp(energy - energy.max(dim=2, keepdim=True).values)
    p_attn = p_attn / torch.clamp(p_attn.sum(dim=2, keepdim=True), min=1e-20)
    return (p_attn @ hs.to(torch.float32)).to(hs.dtype)


def average_by_duration(ds: torch.Tensor, xs: torch.Tensor,
                        text_lens: Optional[torch.Tensor] = None,
                        feats_lens: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Mean of frame values per token segment: ds (B, N) durations, xs
    (B, T) frame values -> (B, N); 0 for a token of duration 0."""
    B, N = ds.shape
    T = xs.shape[1]
    ds = ds.to(torch.int64)
    if text_lens is not None:
        ds = ds * (torch.arange(N, device=ds.device)[None, :] < text_lens[:, None])
    cum = torch.cumsum(ds, dim=-1)
    start = cum - ds
    t = torch.arange(T, device=ds.device)
    seg = (t[None, None, :] >= start[:, :, None]) & (t[None, None, :] < cum[:, :, None])
    if feats_lens is not None:
        seg = seg & (t[None, None, :] < feats_lens[:, None, None])
    sums = torch.einsum("bnt,bt->bn", seg.to(xs.dtype), xs)
    counts = seg.sum(dim=-1)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                       torch.zeros_like(sums))


def aggregate_by_ids(x: torch.Tensor, ids: torch.Tensor, num_segments: int,
                     mode: str = "sum") -> torch.Tensor:
    """Segment-aggregate (B, N) values by per-position segment ids (B, N)
    -> (B, num_segments): the sum ("sum") or the mean ("mean", 0 for an
    empty segment) of each segment's values. An id of -1 marks padding and
    is dropped. Used for the word-level duration sums, with the word ids
    the collate builds from the boundary lists."""
    valid = ids >= 0
    onehot = torch.nn.functional.one_hot(torch.where(valid, ids, 0).to(torch.int64),
                                         num_segments).to(x.dtype)
    onehot = onehot * valid[..., None].to(x.dtype)
    sums = torch.einsum("bnw,bn->bw", onehot, x)
    if mode == "sum":
        return sums
    counts = onehot.sum(dim=1)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       torch.zeros_like(sums))
