"""Training datasets + global stats (host side, numpy).

Counterpart of ``viet_tts_tpu/data/dataset.py``: per-utterance items
(pitch and energy normalised by the dataset's statistics, the alignment
prior or the supervised durations, the accent from the file name's
prefix) read from the feature cache of ``data/features.py``, and with
``include_speech`` the waveform (JETS); batching lives in
``data/batching.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from viet_tts_torch.data.features import load_array, prepare_inputs, resolve_artifact
from viet_tts_torch.dsp.audio import read_wav
from viet_tts_torch.text import symbols_to_ids


def flatten_boundaries(raw: str) -> List[int]:
    """Parse the filelist tail 'n, n, [a, b], n' into per-word phoneme counts
    (hyphenated compounds contribute one word per syllable group)."""
    vals: List[int] = []
    depth_buf: List[int] = []
    token = ""
    in_list = False
    for ch in raw:
        if ch == "[":
            in_list = True
            depth_buf = []
        elif ch == "]":
            if token.strip():
                depth_buf.append(int(token.strip()))
            token = ""
            vals.extend(depth_buf)
            in_list = False
        elif ch == ",":
            if token.strip():
                (depth_buf if in_list else vals).append(int(token.strip()))
            token = ""
        else:
            token += ch
    if token.strip():
        vals.append(int(token.strip()))
    return vals


def word_ids_from_boundaries(boundaries: Sequence[int], n_phones: int) -> np.ndarray:
    """Per-phoneme word index, -1 past the boundary coverage."""
    ids = np.full(n_phones, -1, np.int32)
    pos = 0
    for w, count in enumerate(boundaries):
        ids[pos : pos + count] = w
        pos += count
        if pos >= n_phones:
            break
    return ids


class AcousticDataset:
    """Utterance-level dataset for FastSpeech2/AdaSpeech/Matcha/JETS tasks.

    Items are numpy dicts; pitch/energy normalised by dataset stats; the
    ``duration`` slot holds either supervised per-phoneme durations or the
    beta-binomial alignment prior when ``self_learning``
    (the reference's FastSpeech2 loader).
    """

    def __init__(
        self,
        filelist: List[tuple],
        config: dict,
        speakers: Optional[Dict[str, int]],
        accents: Optional[Dict[str, int]],
        stats: Optional[dict] = None,
        frame_level_prosody: bool = False,
        include_speech: bool = False,
        load_duration: bool = True,
    ):
        self.inputs = list(filelist)
        self.config = config
        self.speakers = speakers
        self.accents = accents
        self.self_learning = bool(config.get("self_learning", False))
        self.frame_level_prosody = frame_level_prosody
        self.include_speech = include_speech
        self.load_duration = load_duration
        self.prosody_path = prepare_inputs(self.inputs, config)
        self.stats = stats if stats is not None else self.compute_stats()

    # -- stats ---------------------------------------------------------
    def compute_stats(self) -> dict:
        """Streaming mean/std then min/max of normalised values
        (the reference's FastSpeech2 loader)."""
        acc = {
            k: {"sum": 0.0, "sq": 0.0, "n": 0} for k in ("pitch", "energy")
        }
        keys = [f"{s}_{os.path.basename(p)}" for p, s, *_ in self.inputs]
        for fid in keys:
            for k in acc:
                v = load_array(self.prosody_path[fid][k]).astype(np.float64)
                acc[k]["sum"] += v.sum()
                acc[k]["sq"] += (v**2).sum()
                acc[k]["n"] += len(v)
        stats = {}
        for k, a in acc.items():
            mean = a["sum"] / max(a["n"], 1)
            var = a["sq"] / max(a["n"], 1) - mean * mean
            stats[k] = {"mean": float(mean), "std": float(np.sqrt(max(var, 1e-20)))}
        for k in acc:
            lo, hi = np.inf, -np.inf
            for fid in keys:
                v = load_array(self.prosody_path[fid][k]).astype(np.float64)
                v = (v - stats[k]["mean"]) / stats[k]["std"]
                lo, hi = min(lo, v.min()), max(hi, v.max())
            stats[k].update(min=float(lo), max=float(hi))
        return stats

    # -- item ----------------------------------------------------------
    def __len__(self):
        return len(self.inputs)

    def _accent_id(self, wav_path: str) -> int:
        if self.accents is not None:
            key = os.path.basename(wav_path).split("-")[0]
            return int(self.accents.get(key, 0))
        return 0

    def _feat_path(self, index: int) -> str:
        wav_path, sid = self.inputs[index][:2]
        return (resolve_artifact(wav_path, "feat")
                or self.prosody_path[f"{sid}_{os.path.basename(wav_path)}"]["feat"])

    def lengths(self, index: int) -> tuple:
        """(phonemes, mel frames) of item ``index``, from the filelist and
        the log-mel file's header: the item's ``len(text)`` and
        ``feat.shape[0]`` without loading it."""
        path = self._feat_path(index)
        shape = (np.load(path, mmap_mode="r") if path.endswith(".npy")
                 else load_array(path)).shape
        n_mel = shape[1] if shape[0] == self.config["mel"]["channels"] else shape[0]
        return len(self.inputs[index][2].split()), n_mel

    def __getitem__(self, index: int) -> dict:
        wav_path, sid, pid, tail = self.inputs[index][:4]
        fid = f"{sid}_{os.path.basename(wav_path)}"
        paths = self.prosody_path[fid]

        text = np.asarray(symbols_to_ids(pid), np.int32)
        feat = load_array(self._feat_path(index)).astype(np.float32)
        if feat.shape[0] == self.config["mel"]["channels"]:
            feat = feat.T  # accept (n_mels, T) artifacts

        def prosody(kind):
            v = load_array(resolve_artifact(wav_path, kind) or paths[kind]).astype(
                np.float32
            )
            s = self.stats[kind]
            return (v - s["mean"]) / s["std"]

        if not self.load_duration:
            duration = np.zeros(len(text), np.int32)
        elif self.self_learning:
            duration = load_array(
                resolve_artifact(wav_path, "alignment") or paths["alignment"]
            ).astype(np.float32)
        else:
            with open(paths["duration"], "r", encoding="utf8") as f:
                duration = np.asarray(
                    [int(x) for x in f.read().strip().split(", ")], np.int32
                )

        boundaries = flatten_boundaries(tail)
        item = dict(
            sid=np.int32(self.speakers[sid]) if self.speakers else 0,
            aid=np.int32(self._accent_id(wav_path)),
            text=text,
            word_ids=word_ids_from_boundaries(boundaries, len(text)),
            n_words=np.int32(len(boundaries)),
            feat=feat,
            duration=duration,
            pitch=prosody("pitch")[: feat.shape[0]],
            energy=prosody("energy")[: feat.shape[0]],
            wav_path=wav_path,
        )
        if self.include_speech:
            item["speech"] = read_wav(wav_path)[0]
        return item


def save_stats(stats: dict, path: str) -> None:
    with open(path, "w", encoding="utf8") as f:
        json.dump(stats, f, indent=1)


def load_stats(path: str) -> dict:
    with open(path, "r", encoding="utf8") as f:
        return json.load(f)
