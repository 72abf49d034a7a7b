"""Batched forward-sum (alignment CTC) losses of JETS and FastSpeech2.

Counterpart of ``viet_tts_tpu/ops/forward_sum.py`` (``ctc_forward_sum``,
``jets_forward_sum_loss``, ``beta_binomial_log_prior``, ``forward_sum_loss``,
``bin_loss``). The CTC targets
are always 1..N (every text token distinct), so the forward algorithm is a
3-band log-domain recursion; the JAX package runs it as a ``lax.scan``
over mel frames, here it is a Python loop over frames with batched tensor
ops, differentiated by autograd.

``F.ctc_loss`` computes the same value, but its gradient assumes that the
input was log-softmaxed (it adds exp(log_probs)); the forward-sum scores
are not normalised after the prior and the blank are added, so the loop is
the one that gives the JAX package's gradient.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG = -1.0e30


def _logaddexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=NEG)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe))
    return torch.clamp(out, min=NEG)


def ctc_forward_sum(log_probs: torch.Tensor, key_lens: torch.Tensor,
                    query_lens: torch.Tensor) -> torch.Tensor:
    """CTC negative log-likelihood for targets 1..key_len per sample.

    log_probs (B, T_mel, T_text+1): column 0 is the blank, column k text
    token k. key_lens (B,) text tokens, query_lens (B,) mel frames. Returns
    (B,) per-sample NLL (not length-normalised)."""
    B, T_mel, n_cols = log_probs.shape
    T_text = n_cols - 1
    S = 2 * T_text + 1  # interleaved blank / token states
    dev = log_probs.device
    key_lens = key_lens.to(device=dev, dtype=torch.int64)
    query_lens = query_lens.to(device=dev, dtype=torch.int64)
    s = torch.arange(S, device=dev)
    is_token = (s % 2) == 1
    emit_col = torch.where(is_token, (s + 1) // 2, torch.zeros_like(s))
    state_valid = s[None, :] <= 2 * key_lens[:, None]  # (B, S)
    neg = torch.full((), NEG, device=dev, dtype=log_probs.dtype)

    lp_states = torch.where(state_valid[:, None, :], log_probs[:, :, emit_col], neg)
    alpha = torch.where((s[None, :] <= 1) & state_valid, lp_states[:, 0, :], neg)
    pad1 = torch.full((B, 1), NEG, device=dev, dtype=log_probs.dtype)
    pad2 = torch.full((B, 2), NEG, device=dev, dtype=log_probs.dtype)
    active = torch.arange(T_mel, device=dev)[:, None] < query_lens[None, :]
    for t in range(1, T_mel):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        # the skip transition (s-2) only into token states (labels distinct)
        prev2 = torch.where(is_token[None, :],
                            torch.cat([pad2, alpha[:, :-2]], dim=1), neg)
        new = lp_states[:, t, :] + _logaddexp3(alpha, prev1, prev2)
        new = torch.where(state_valid, new, neg)
        alpha = torch.where(active[t][:, None], new, alpha)

    batch = torch.arange(B, device=dev)
    end_blank = alpha[batch, 2 * key_lens]
    end_token = alpha[batch, 2 * key_lens - 1]
    return -torch.logaddexp(torch.clamp(end_blank, min=NEG),
                            torch.clamp(end_token, min=NEG))


def jets_forward_sum_loss(log_p_attn: torch.Tensor, ilens: torch.Tensor,
                          olens: torch.Tensor, blank_prob: float = float(np.e ** -1),
                          bb_prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JETS ForwardSumLoss: log_p_attn (B, T_feats, T_text), already
    log-softmaxed over text; ``bb_prior`` an optional (B, T_feats, T_text)
    log prior to add. No re-normalisation after the prior and the blank
    (the reference feeds unnormalised scores to the CTC)."""
    if bb_prior is not None:
        log_p_attn = torch.clamp(log_p_attn + bb_prior, min=NEG)
    B, T_feats, _ = log_p_attn.shape
    blank = torch.full((B, T_feats, 1), float(np.log(blank_prob)),
                       dtype=log_p_attn.dtype, device=log_p_attn.device)
    nll = ctc_forward_sum(torch.cat([blank, log_p_attn], dim=-1), ilens, olens)
    return (nll / torch.clamp(ilens.to(nll.device), min=1)).mean()


@torch.no_grad()
def beta_binomial_log_prior(text_lens: torch.Tensor, feats_lens: torch.Tensor,
                            t_text: int, t_feats: int, w: float = 1.0
                            ) -> torch.Tensor:
    """Batched log beta-binomial alignment prior (B, t_feats, t_text):
    prior[b, t, k] = log BetaBinom(k; N_b, w (t+1), w (T_b - t)) with
    N_b = text_len, T_b = feats_len; NEG outside the valid region.

    Outside that region lgamma is evaluated at non-positive arguments (inf
    or NaN before the mask); the function runs without autograd, so none of
    that can reach a gradient."""
    dev = text_lens.device
    lgamma = torch.lgamma
    t = torch.arange(t_feats, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(t_text, dtype=torch.float32, device=dev)[None, None, :]
    n = text_lens.to(torch.float32)[:, None, None]
    T = feats_lens.to(device=dev, dtype=torch.float32)[:, None, None]

    def betaln(a, b):
        return lgamma(a) + lgamma(b) - lgamma(a + b)

    alpha = w * (t + 1.0)
    beta = w * (T - t)
    log_binom = lgamma(n + 1.0) - lgamma(k + 1.0) - lgamma(n - k + 1.0)
    logp = log_binom + betaln(k + alpha, n - k + beta) - betaln(alpha, beta)
    valid = (t < T) & (k < n)
    return torch.where(valid, logp, torch.full_like(logp, NEG))


def forward_sum_loss(attn_logprob: torch.Tensor, in_lens: torch.Tensor,
                     out_lens: torch.Tensor, blank_logprob: float = -1.0) -> torch.Tensor:
    """FastSpeech2 ForwardSumLoss: attn_logprob (B, 1, T_mel, T_text)
    unnormalised log attention. A blank column at ``blank_logprob`` is
    prepended, the (text_len + 1) valid columns are log-softmaxed, and the
    per-sample CTC NLL is divided by text_len (torch CTCLoss "mean") and
    averaged over the batch."""
    x = attn_logprob[:, 0]
    B, T_mel, T_text = x.shape
    in_lens = in_lens.to(x.device)
    x = torch.cat([torch.full((B, T_mel, 1), blank_logprob, dtype=x.dtype, device=x.device),
                   x], dim=-1)
    col_valid = torch.arange(T_text + 1, device=x.device)[None, :] <= in_lens[:, None]
    neg = torch.full((), NEG, dtype=x.dtype, device=x.device)
    masked = torch.where(col_valid[:, None, :], x, neg)
    logz = torch.logsumexp(masked, dim=-1, keepdim=True)
    log_probs = torch.where(col_valid[:, None, :], masked - logz, neg)
    nll = ctc_forward_sum(log_probs, in_lens, out_lens)
    return (nll / torch.clamp(in_lens, min=1)).mean()


def bin_loss(hard_attention: torch.Tensor, soft_attention: torch.Tensor) -> torch.Tensor:
    """Binarization loss: -sum(log soft where hard = 1) / sum(hard)."""
    log_soft = torch.log(torch.clamp(soft_attention, min=1e-12))
    total = (hard_attention * log_soft).sum()
    return -total / torch.clamp(hard_attention.sum(), min=1.0)
