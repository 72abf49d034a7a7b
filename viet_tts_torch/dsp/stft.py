"""STFT and log-mel features for the training losses.

Counterpart of ``viet_tts_tpu/dsp/stft.py`` (the window, the Slaney mel
filterbank, the centred reflect-padded STFT and ``log_mel_spectrogram``),
with its own numpy copies of the framework-free pieces. Semantics: periodic
Hann window, amplitude sqrt(max(|S|^2, 1e-10)), Slaney-scale and
Slaney-normalised triangles (librosa ``htk=False``), log(max(mel, 1e-10)),
divided by log(base) when ``log_base`` is given. Audio is (..., T) and
features (..., frames, bins), as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1.0e-10


def hann_window(win_length: int, periodic: bool = True,
                dtype=np.float32) -> np.ndarray:
    """Hann window; periodic=True matches torch.hann_window."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1)))
    return w[:win_length].astype(dtype)


@functools.lru_cache(maxsize=8)
def _window_constant(window: str, win_length: int, n_fft: int) -> np.ndarray:
    if window in (None, "none"):
        w = np.ones(win_length, dtype=np.float32)
    elif window == "hann":
        w = hann_window(win_length)
    else:
        raise ValueError(f"unsupported window: {window}")
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    return w


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_freq, n_mels)."""
    if fmax is None:
        fmax = sr / 2.0
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])  # Slaney area norm
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """(..., T) -> overlapping frames (..., n_frames, n_fft), reflect-padded
    by n_fft // 2 on each side when centred."""
    if center:
        pad = n_fft // 2
        shape = x.shape
        x = F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*shape[:-1], x.shape[-1])
    return x.unfold(-1, n_fft, hop_length)


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         win_length: Optional[int] = None, window: str = "hann",
         center: bool = True) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., n_frames, n_fft // 2 + 1)."""
    win_length = win_length or n_fft
    w = torch.from_numpy(_window_constant(window, win_length, n_fft)).to(x.device)
    frames = frame_signal(x, n_fft, hop_length, center=center)
    return torch.fft.rfft(frames * w, n=n_fft, dim=-1)


def spectrogram_amplitude(spec: torch.Tensor) -> torch.Tensor:
    """sqrt(max(|S|^2, 1e-10)), the espnet clamp."""
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.clamp(power, min=EPS))


def log_mel_spectrogram(x: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                        hop_length: int = 256, win_length: Optional[int] = None,
                        window: str = "hann", n_mels: int = 80,
                        fmin: float = 0.0, fmax: Optional[float] = None,
                        log_base: Optional[float] = None) -> torch.Tensor:
    """Log-mel features of (..., T) -> (..., frames, n_mels)."""
    amp = spectrogram_amplitude(stft(x, n_fft=n_fft, hop_length=hop_length,
                                     win_length=win_length, window=window))
    basis = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(x.device)
    y = torch.log(torch.clamp(amp @ basis, min=EPS))
    if log_base is not None:
        y = y / float(np.log(log_base))
    return y
