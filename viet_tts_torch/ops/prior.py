"""Beta-binomial alignment prior of the FastSpeech2 data pipeline.

Counterpart of ``viet_tts_tpu/ops/prior.py:beta_binomial_prior`` (the
reference's ``src/tools/utils.py:51-61``), computed with ``torch.lgamma`` in
float64 instead of ``scipy.stats.betabinom``. With ``learn_alignment`` the
FS2 batch's ``duration`` field carries this (T_mel, T_text) probability
matrix for each utterance, padded with zeros.
"""

from __future__ import annotations

import numpy as np
import torch


def beta_binomial_prior(phoneme_count: int, mel_count: int,
                        scaling_factor: float = 1.0) -> np.ndarray:
    """(mel_count, phoneme_count) float64 matrix; row i (1-based) is the pmf
    of BetaBinom(n = P, a = w i, b = w (M + 1 - i)) at k = 0 .. P - 1."""
    P, M = phoneme_count, mel_count
    k = torch.arange(P, dtype=torch.float64)[None, :]
    i = torch.arange(1, M + 1, dtype=torch.float64)[:, None]
    a = scaling_factor * i
    b = scaling_factor * (M + 1.0 - i)
    n = float(P)
    lg = torch.lgamma

    def betaln(x, y):
        return lg(x) + lg(y) - lg(x + y)

    log_comb = lg(torch.tensor(n + 1.0)) - lg(k + 1.0) - lg(n - k + 1.0)
    return torch.exp(log_comb + betaln(k + a, n - k + b) - betaln(a, b)).numpy()
