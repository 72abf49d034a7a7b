"""DIO + StoneMask F0 extraction (WORLD algorithm family, numpy).

Copy of ``viet_tts_tpu/dsp/dio.py``, the feature cache's default pitch
extractor: espnet's ``Dio`` semantics (pyworld DIO then StoneMask
refinement, f0_floor=80, f0_ceil=400, log-F0 with zeros at unvoiced
frames), reimplemented from the algorithms' published form (Morise et al.,
"DIO: a fast and reliable F0 estimator", and the WORLD vocoder's
StoneMask), since pyworld is not a dependency:

DIO:
  1. band-limit the signal with a bank of windowed-sinc low-pass filters
     whose cutoffs are log-spaced between f0_floor and f0_ceil
     (`channels_in_octave` per octave); a band whose cutoff sits just above
     the true F0 passes a near-sinusoid at the fundamental
  2. in each band, measure four event-interval series — positive/negative
     zero crossings and peaks/dips (zero crossings of the derivative) —
     and interpolate each onto the frame grid
  3. a band's candidate F0 is the mean of the four series; its reliability
     is their standard deviation. Per frame, keep the most reliable
     candidate; frames whose relative deviation exceeds a threshold are
     unvoiced
  4. octave-step and continuity cleanup over the selected contour

StoneMask: per voiced frame, refine F0 with the reassigned (instantaneous)
frequency of the first harmonics of a 3-period windowed DFT, harmonic-
amplitude weighted; two iterations.

Host-side preprocessing code, never on the card.
"""

from __future__ import annotations

import numpy as np


def nuttall(n: int) -> np.ndarray:
    """Nuttall window (the LPF window WORLD uses)."""
    t = np.linspace(0.0, 1.0, n, endpoint=True)
    return (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * t)
        + 0.144232 * np.cos(4 * np.pi * t)
        - 0.012604 * np.cos(6 * np.pi * t)
    )


def _lowpass(x: np.ndarray, fs: float, cutoff: float) -> np.ndarray:
    """Zero-phase windowed-sinc low-pass via FFT convolution."""
    half = int(round(fs / cutoff * 2))  # ~4 fundamental periods total
    n = 2 * half + 1
    t = np.arange(n) - half
    h = np.sinc(2 * cutoff / fs * t) * (2 * cutoff / fs) * nuttall(n)
    h /= max(h.sum(), 1e-12)
    nfft = int(2 ** np.ceil(np.log2(len(x) + n)))
    y = np.fft.irfft(
        np.fft.rfft(x, nfft) * np.fft.rfft(h, nfft), nfft
    )[half : half + len(x)]
    return y


def _crossing_times(y: np.ndarray, fs: float, negative: bool) -> np.ndarray:
    """Sub-sample times of (positive- or negative-going) zero crossings."""
    s = -y if negative else y
    idx = np.nonzero((s[:-1] < 0) & (s[1:] >= 0))[0]
    if idx.size == 0:
        return np.empty(0)
    frac = s[idx] / (s[idx] - s[idx + 1])
    return (idx + frac) / fs


def _event_f0(times: np.ndarray, frame_t: np.ndarray) -> np.ndarray:
    """Interval series -> per-frame F0 (NaN where undefined)."""
    if times.size < 3:
        return np.full(frame_t.shape, np.nan)
    intervals = np.diff(times)
    centers = 0.5 * (times[:-1] + times[1:])
    f0 = 1.0 / np.maximum(intervals, 1e-12)
    out = np.interp(frame_t, centers, f0)
    out[(frame_t < centers[0]) | (frame_t > centers[-1])] = np.nan
    return out


def _candidates_for_band(
    x: np.ndarray, fs: float, cutoff: float, frame_t: np.ndarray
):
    """(candidate F0, deviation) for one low-passed band."""
    y = _lowpass(x, fs, cutoff)
    dy = np.diff(y, prepend=y[:1])
    series = np.stack(
        [
            _event_f0(_crossing_times(y, fs, negative=False), frame_t),
            _event_f0(_crossing_times(y, fs, negative=True), frame_t),
            _event_f0(_crossing_times(dy, fs, negative=False), frame_t),  # peaks
            _event_f0(_crossing_times(dy, fs, negative=True), frame_t),  # dips
        ]
    )
    bad = np.isnan(series).any(axis=0)
    filled = np.where(np.isnan(series), 0.0, series)
    cand = filled.mean(axis=0)
    dev = filled.std(axis=0)
    cand[bad] = 0.0
    dev[bad] = np.inf
    return cand, dev


def _fix_contour(f0: np.ndarray, allowed_range: float = 0.12) -> np.ndarray:
    """WORLD-style step cleanup: kill frames that jump more than
    ``allowed_range`` relative to a voiced neighbour, then drop 1-2 frame
    voiced islands."""
    out = f0.copy()
    for t in range(1, len(out)):
        if out[t] > 0 and out[t - 1] > 0:
            if abs(out[t] - out[t - 1]) / out[t - 1] > allowed_range:
                out[t] = 0.0
    # remove isolated voiced islands (<=2 frames)
    t = 0
    n = len(out)
    while t < n:
        if out[t] > 0:
            start = t
            while t < n and out[t] > 0:
                t += 1
            if t - start <= 2:
                out[start:t] = 0.0
        else:
            t += 1
    return out


def dio(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 80.0,
    f0_ceil: float = 400.0,
    frame_period_ms: float | None = None,
    hop_length: int | None = None,
    channels_in_octave: float = 2.0,
    relative_deviation: float = 0.07,
):
    """DIO F0 track. Returns (f0 Hz per frame, frame times in seconds);
    f0 == 0 at unvoiced frames."""
    x = np.asarray(x, np.float64)
    if hop_length is not None:
        hop_s = hop_length / fs
    else:
        hop_s = (frame_period_ms or 5.0) / 1000.0
    n_frames = int(len(x) / fs / hop_s) + 1
    frame_t = np.arange(n_frames) * hop_s

    # remove DC / very-low drift so zero crossings track the fundamental
    x = x - _lowpass(x, fs, f0_floor * 0.5)

    n_bands = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)) + 1
    cands, devs = [], []
    for i in range(n_bands):
        cutoff = f0_floor * 2.0 ** ((i + 1) / channels_in_octave)
        c, d = _candidates_for_band(x, fs, min(cutoff, f0_ceil * 1.1), frame_t)
        ok = (c >= f0_floor) & (c <= f0_ceil)
        d = np.where(ok, d, np.inf)
        c = np.where(ok, c, 0.0)
        cands.append(c)
        devs.append(d)
    cands = np.stack(cands)  # (n_bands, T)
    devs = np.stack(devs)

    best = np.argmin(devs, axis=0)
    ar = np.arange(len(frame_t))
    f0 = cands[best, ar]
    rel = devs[best, ar] / np.maximum(f0, 1e-12)
    f0 = np.where(rel < relative_deviation, f0, 0.0)
    return _fix_contour(f0), frame_t


def _refine_once(
    x: np.ndarray, fs: float, t0: float, f0: float, n_harmonics: int = 6
) -> float:
    """One StoneMask refinement: harmonic-weighted reassigned frequency of a
    3-period windowed segment around t0."""
    half = int(round(1.5 * fs / f0))
    c = int(round(t0 * fs))
    lo, hi = c - half, c + half + 1
    if lo < 0 or hi > len(x) or half < 4:
        return f0
    seg = x[lo:hi]
    n = len(seg)
    tt = (np.arange(n) - half) / fs
    w = nuttall(n)
    dw = np.gradient(w, 1.0 / fs)

    freqs = f0 * np.arange(1, n_harmonics + 1)
    freqs = freqs[freqs < 0.45 * fs]
    if freqs.size == 0:
        return f0
    # direct DFT at the harmonic frequencies of the window and
    # derivative-window transforms -> reassigned instantaneous frequency
    # (for w symmetric & t centred: IF(f) = f - Im(S_dw conj(S_w))/(2pi|S|^2),
    # exactly f0 at the tone)
    basis = np.exp(-2j * np.pi * freqs[:, None] * tt[None, :])
    S = basis @ (seg * w)
    Sd = basis @ (seg * dw)
    mag2 = np.maximum(np.abs(S) ** 2, 1e-20)
    inst = freqs - np.imag(Sd * np.conj(S)) / mag2 / (2 * np.pi)
    weights = np.abs(S)
    harmonics = np.arange(1, len(freqs) + 1)
    per_h = inst / harmonics
    # a probe bin with no real harmonic gets reassigned to a NEIGHBOURING
    # harmonic (the window main lobe spans ~4/3 f0); keep only estimates
    # consistent with the current f0
    ok = np.abs(per_h - f0) < 0.2 * f0
    if not ok.any():
        return f0
    est = (per_h[ok] * weights[ok]).sum() / max(weights[ok].sum(), 1e-12)
    if not np.isfinite(est) or est <= 0:
        return f0
    return float(est)


def stonemask(
    x: np.ndarray, f0: np.ndarray, frame_t: np.ndarray, fs: int
) -> np.ndarray:
    """Refine a DIO contour; unvoiced frames stay 0."""
    x = np.asarray(x, np.float64)
    out = f0.copy()
    for i in range(len(f0)):
        if out[i] <= 0:
            continue
        r = _refine_once(x, fs, frame_t[i], out[i])
        if abs(r - out[i]) / out[i] < 0.2:
            r = _refine_once(x, fs, frame_t[i], r)
            out[i] = r
    return out


def extract_f0_dio(
    audio: np.ndarray,
    sr: int = 22050,
    hop_length: int = 256,
    f0_floor: float = 80.0,
    f0_ceil: float = 400.0,
    use_log_f0: bool = True,
    target_len: int | None = None,
) -> np.ndarray:
    """espnet `Dio`-equivalent front door: DIO + StoneMask, log-F0 with
    zeros at unvoiced frames, padded/truncated to the mel grid."""
    f0, t = dio(audio, sr, f0_floor, f0_ceil, hop_length=hop_length)
    f0 = stonemask(audio, f0, t, sr)
    f0 = np.where((f0 >= f0_floor * 0.9) & (f0 <= f0_ceil * 1.1), f0, 0.0)
    if use_log_f0:
        f0 = np.where(f0 > 0, np.log(np.maximum(f0, 1e-12)), 0.0)
    if target_len is not None:
        if len(f0) >= target_len:
            f0 = f0[:target_len]
        else:
            f0 = np.pad(f0, (0, target_len - len(f0)))
    return f0.astype(np.float32)
