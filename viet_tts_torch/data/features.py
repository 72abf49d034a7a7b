"""Offline feature-cache builder (host side, runs once per dataset).

Counterpart of ``viet_tts_tpu/data/features.py``, with the same artifact
layout, so a cache written by either package is read by the other:

    <speaker>/wavs/x.wav
    <speaker>/feats/x.npy       log-mel (T, n_mels)
    <speaker>/pitch/x.npy       log-F0 per frame (T,)
    <speaker>/energy/x.npy      frame energy (T,)
    <speaker>/alignment/x.npy   beta-binomial prior (T, n_phones)
    <speaker>/duration/x.txt    per-phoneme frame counts (supervised mode)
    <speaker>/embedding/x.npy   optional external speaker embedding

The mel and the energy come from the port's torch DSP on the CPU, the
pitch from ``dsp/dio.py`` (default) or ``dsp/pitch.py`` (numpy), the prior
from ``ops/prior.py``. Artifacts are .npy; a torch-saved .pt artifact is
read too.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from viet_tts_torch.dsp.audio import read_wav
from viet_tts_torch.dsp.dio import extract_f0_dio
from viet_tts_torch.dsp.pitch import extract_f0
from viet_tts_torch.dsp.stft import frame_energy, log_mel_from_config
from viet_tts_torch.ops.prior import beta_binomial_prior

ARTIFACTS = ("feat", "pitch", "energy", "alignment", "duration", "embedding")
_DIRS = {
    "feat": "feats",
    "pitch": "pitch",
    "energy": "energy",
    "alignment": "alignment",
    "duration": "duration",
    "embedding": "embedding",
}


def load_array(path: str) -> np.ndarray:
    """Load a .npy artifact, or a .pt tensor."""
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True).numpy()
    return np.load(path)


def _artifact_path(wav_path: str, kind: str) -> str:
    root = os.path.dirname(os.path.dirname(wav_path))
    stem = ".".join(os.path.basename(wav_path).split(".")[:-1])
    ext = ".txt" if kind == "duration" else ".npy"
    return os.path.join(root, _DIRS[kind], stem + ext)


def resolve_artifact(wav_path: str, kind: str) -> Optional[str]:
    """The existing artifact's path (.npy or .pt), or None."""
    p = _artifact_path(wav_path, kind)
    if os.path.exists(p):
        return p
    for alt_ext in (".pt", ".npy"):
        alt = os.path.splitext(p)[0] + alt_ext
        if os.path.exists(alt):
            return alt
    return None


def prepare_inputs(
    list_segments: List[tuple],
    hparams: dict,
) -> Dict[str, Dict[str, str]]:
    """Build or complete the per-utterance feature cache.

    ``list_segments`` rows are (wav_path, speaker, phoneme_string,
    durations_or_boundaries) as parsed from train.txt; ``hparams`` is the
    preprocessing config (``conf["audio"]``). Returns
    {"<speaker>_<wav_basename>": {artifact: path}}.
    """
    sr = hparams["signal"]["sampling_rate"]
    prosody: Dict[str, Dict[str, str]] = {}

    for fid_path, sid, pid, tail in list_segments:
        key = f"{sid}_{os.path.basename(fid_path)}"
        entry = {"wav": fid_path}
        for kind in ARTIFACTS:
            Path(os.path.dirname(_artifact_path(fid_path, kind))).mkdir(
                parents=True, exist_ok=True)
            entry[kind] = _artifact_path(fid_path, kind)
        prosody[key] = entry

        # supervised durations come straight from the filelist tail
        tail_vals = [t for t in tail.split(", ") if t]
        n_phones = len(pid.split())
        if len(tail_vals) == n_phones and not os.path.exists(entry["duration"]):
            with open(entry["duration"], "w", encoding="utf8") as f:
                f.write(tail.strip())

        need = [k for k in ("feat", "pitch", "energy", "alignment")
                if resolve_artifact(fid_path, k) is None]
        if not need:
            for k in ("feat", "pitch", "energy", "alignment", "embedding"):
                found = resolve_artifact(fid_path, k)
                if found:
                    entry[k] = found
            continue

        audio, file_sr = read_wav(fid_path)
        if file_sr != sr:
            raise ValueError(f"{fid_path}: sample rate {file_sr} Hz, the config expects {sr} Hz")
        wave = torch.from_numpy(audio)[None]
        mel = log_mel_from_config(wave, hparams)[0].numpy()
        if "feat" in need:
            np.save(entry["feat"], mel.astype(np.float32))
        if "pitch" in need:
            extract = extract_f0_dio if hparams.get("pitch_extractor", "dio") == "dio" \
                else extract_f0
            np.save(entry["pitch"], extract(audio, sr, hparams["stft"]["hop_length"],
                                            target_len=mel.shape[0]))
        if "energy" in need:
            en = frame_energy(wave, hparams)[0].numpy()
            np.save(entry["energy"], en[: mel.shape[0]].astype(np.float32))
        if "alignment" in need:
            np.save(entry["alignment"],
                    beta_binomial_prior(n_phones, mel.shape[0]).astype(np.float32))

    return prosody
