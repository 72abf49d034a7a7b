"""Host-side fundamental-frequency (F0) extraction for offline preprocessing.

Copy of ``viet_tts_tpu/dsp/pitch.py``: an autocorrelation (NCCF) tracker
with octave-jump median smoothing, per-frame log-F0 aligned to the mel
frame grid, zeros at unvoiced frames (``pitch_extractor: nccf``; the
default is Dio, ``dsp/dio.py``). numpy only, never on the card.
"""

from __future__ import annotations

import numpy as np


def _frame(x: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    pad = frame_len // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n = 1 + (len(x) - frame_len) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[idx]


def extract_f0(
    audio: np.ndarray,
    sr: int = 22050,
    hop_length: int = 256,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    voicing_threshold: float = 0.45,
    use_log_f0: bool = True,
    target_len: int | None = None,
) -> np.ndarray:
    """Per-frame (log-)F0 of mono float audio; 0 where unvoiced.

    Frames are centered on the same grid as the mel STFT so pitch rows align
    1:1 with mel rows (espnet pads/truncates the same way).
    """
    audio = np.asarray(audio, dtype=np.float64)
    frame_len = int(2 ** np.ceil(np.log2(3.0 * sr / f0_floor)))
    frames = _frame(audio, frame_len, hop_length)
    frames = frames - frames.mean(axis=1, keepdims=True)

    # Autocorrelation via FFT (Wiener–Khinchin).
    nfft = 2 * frame_len
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, n=nfft, axis=1)[:, :frame_len]
    ac0 = np.maximum(ac[:, :1], 1e-12)
    nac = ac / ac0  # normalised autocorrelation in [-1, 1]

    lag_min = max(2, int(np.floor(sr / f0_ceil)))
    lag_max = min(frame_len - 1, int(np.ceil(sr / f0_floor)))
    search = nac[:, lag_min : lag_max + 1]
    best = np.argmax(search, axis=1)
    peak = search[np.arange(len(best)), best]

    # Parabolic interpolation around the peak for sub-sample lag precision.
    lags = (lag_min + best).astype(np.float64)
    inner = (best > 0) & (best < search.shape[1] - 1)
    if inner.any():
        i = np.nonzero(inner)[0]
        l, c, r = (
            search[i, best[i] - 1],
            search[i, best[i]],
            search[i, best[i] + 1],
        )
        denom = l - 2 * c + r
        shift = np.where(np.abs(denom) > 1e-12, 0.5 * (l - r) / denom, 0.0)
        lags[i] += np.clip(shift, -1.0, 1.0)

    f0 = sr / lags
    # Voicing: strong normalised peak and non-negligible energy.
    energy = np.sqrt((frames**2).mean(axis=1))
    voiced = (peak > voicing_threshold) & (energy > 1e-4 * max(energy.max(), 1e-12))
    f0 = np.where(voiced, f0, 0.0)

    # Median smoothing over voiced runs to kill octave errors.
    f0 = _median3(f0)
    f0 = np.where((f0 >= f0_floor) & (f0 <= f0_ceil), f0, 0.0)

    if use_log_f0:
        f0 = np.where(f0 > 0, np.log(np.maximum(f0, 1e-12)), 0.0)

    if target_len is not None:
        if len(f0) >= target_len:
            f0 = f0[:target_len]
        else:
            f0 = np.pad(f0, (0, target_len - len(f0)))
    return f0.astype(np.float32)


def _median3(x: np.ndarray) -> np.ndarray:
    if len(x) < 3:
        return x
    stacked = np.stack([x[:-2], x[1:-1], x[2:]])
    out = x.copy()
    out[1:-1] = np.median(stacked, axis=0)
    return out


def interpolate_unvoiced(f0: np.ndarray) -> np.ndarray:
    """Linearly fill unvoiced (zero) gaps — continuous-pitch variant (JETS)."""
    f0 = np.asarray(f0, dtype=np.float32).copy()
    voiced = f0 != 0
    if not voiced.any():
        return f0
    idx = np.arange(len(f0))
    f0[~voiced] = np.interp(idx[~voiced], idx[voiced], f0[voiced])
    return f0
