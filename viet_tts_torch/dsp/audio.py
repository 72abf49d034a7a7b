"""Host-side audio IO and offline preprocessing (numpy, scipy, stdlib).

Copy of ``viet_tts_tpu/dsp/audio.py``: WAV read/write, peak
normalisation, resampling, silence trimming and loudness normalisation.
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile as _wavfile
from scipy.signal import resample_poly


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file to float32 in [-1, 1] (soundfile-compatible scaling)."""
    sr, data = _wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Write float audio in [-1, 1] as 16-bit PCM."""
    audio = np.asarray(audio, dtype=np.float32)
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def to_mono(audio: np.ndarray) -> np.ndarray:
    return audio.mean(axis=1) if audio.ndim > 1 else audio


def peak_normalize(audio: np.ndarray, target: float = 0.95) -> np.ndarray:
    """Scale so max |sample| == target (librosa.util.normalize * target)."""
    peak = np.abs(audio).max()
    return audio * (target / peak) if peak > 0 else audio


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return audio
    g = np.gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


def dbfs(audio: np.ndarray) -> float:
    """Average power of the signal in dB relative to full scale."""
    rms = np.sqrt(np.mean(np.square(audio), dtype=np.float64))
    return float(20.0 * np.log10(max(rms, 1e-12)))


def trim_silence(
    audio: np.ndarray,
    sr: int,
    threshold_db: float = -50.0,
    frame_ms: float = 10.0,
    keep_ms: float = 50.0,
) -> np.ndarray:
    """Trim leading/trailing frames quieter than ``threshold_db`` dBFS."""
    frame = max(1, int(sr * frame_ms / 1000.0))
    n = len(audio) // frame
    if n == 0:
        return audio
    frames = audio[: n * frame].reshape(n, frame)
    level = 20.0 * np.log10(np.maximum(np.sqrt((frames**2).mean(axis=1)), 1e-12))
    loud = np.nonzero(level > threshold_db)[0]
    if len(loud) == 0:
        return audio
    keep = int(sr * keep_ms / 1000.0)
    start = max(0, loud[0] * frame - keep)
    end = min(len(audio), (loud[-1] + 1) * frame + keep)
    return audio[start:end]


def loudness_normalize(audio: np.ndarray, target_dbfs: float = -20.0) -> np.ndarray:
    """Gain so average power hits ``target_dbfs`` (pydub apply_gain role)."""
    gain_db = target_dbfs - dbfs(audio)
    return (audio * (10.0 ** (gain_db / 20.0))).astype(np.float32)


def preprocess_wav(
    path: str,
    target_sr: int = 22050,
    trim_db: float = -50.0,
    target_dbfs: Optional[float] = -20.0,
) -> Tuple[np.ndarray, int]:
    """Mono-ise, resample, trim silence, loudness-normalise one file."""
    audio, sr = read_wav(path)
    audio = to_mono(audio)
    audio = resample(audio, sr, target_sr)
    audio = trim_silence(audio, target_sr, threshold_db=trim_db)
    if target_dbfs is not None:
        audio = loudness_normalize(audio, target_dbfs)
    return audio, target_sr
