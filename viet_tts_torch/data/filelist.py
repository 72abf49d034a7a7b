"""Filelist builders: metadata.csv -> train.txt / test.txt.

Counterpart of ``viet_tts_tpu/data/filelist.py``, through the port's G2P
(``text/``): each row is ``wav_path|speaker|phonemes|word boundaries``;
sentences with out-of-vocabulary words and utterances outside 64-1000 mel
frames are dropped, and each speaker's rows are shuffled and split 95 / 5.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

from viet_tts_torch.dsp.audio import read_wav
from viet_tts_torch.text import VietnameseG2P

MIN_FRAMES, MAX_FRAMES = 64, 1000


def _passes_length_filter(wav_path: str, hop: int = 256) -> bool:
    audio, _ = read_wav(wav_path)
    frames = int(len(audio) / hop - 1)
    return MIN_FRAMES <= frames <= MAX_FRAMES


def _format_row(path: str, speaker: str, phonemes: List[str], boundaries) -> str:
    return "|".join(
        [path, speaker, " ".join(phonemes), ", ".join(str(b) for b in boundaries)])


def _write_split(out_dir: str, train_list: List[str], test_list: List[str]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, rows in (("train.txt", train_list), ("test.txt", test_list)):
        with open(os.path.join(out_dir, name), "w", encoding="utf8") as f:
            f.write("\n".join(rows))


def _read_metadata(path: str) -> List[List[str]]:
    with open(path, "r", encoding="utf8") as f:
        return [line.split("|") for line in f.read().split("\n") if line]


def create_filelist(
    data_dir: str,
    speakers: Dict[str, int],
    out_dir: str,
    g2p: Optional[VietnameseG2P] = None,
    split: float = 0.95,
    seed: Optional[int] = None,
) -> None:
    """Per-speaker ``<data_dir>/<speaker>/metadata.csv`` (``file|text``) ->
    phonemized ``train.txt`` / ``test.txt`` in ``out_dir``."""
    g2p = g2p or VietnameseG2P()
    rng = random.Random(seed)
    train_list, test_list = [], []
    allowed_extra = {",", "."}

    for spk in speakers:
        file_list = []
        for file_name, text in _read_metadata(os.path.join(data_dir, spk, "metadata.csv")):
            wav = os.path.join(data_dir, spk, "wavs", file_name)
            if not os.path.exists(wav):
                continue
            if any(t not in g2p.vocab_set and t not in allowed_extra for t in text.split()):
                continue
            if not _passes_length_filter(wav):
                continue
            phonemes, boundaries = g2p(text.replace("-", " "))
            file_list.append(_format_row(wav, spk, phonemes, boundaries))

        rng.shuffle(file_list)
        cut = int(split * len(file_list))
        train_list.extend(file_list[:cut])
        test_list.extend(file_list[cut:])
    _write_split(out_dir, train_list, test_list)


def create_unknown_filelist(
    data_dir: str,
    out_dir: str,
    g2p: Optional[VietnameseG2P] = None,
    split: float = 0.95,
    seed: Optional[int] = None,
) -> None:
    """Single-directory variant (``<data_dir>/metadata.csv``, ``wavs/``) for
    datasets without a speaker table; the speaker column holds the wav
    path."""
    g2p = g2p or VietnameseG2P()
    rng = random.Random(seed)
    file_list = []
    for file_name, text in _read_metadata(os.path.join(data_dir, "metadata.csv")):
        wav = os.path.join(data_dir, "wavs", file_name)
        if not os.path.exists(wav) or not _passes_length_filter(wav):
            continue
        phonemes, boundaries = g2p(text)
        file_list.append(_format_row(wav, wav, phonemes, boundaries))

    rng.shuffle(file_list)
    cut = int(split * len(file_list))
    _write_split(out_dir, file_list[:cut], file_list[cut:])


def read_filelist(path: str) -> List[tuple]:
    with open(path, "r", encoding="utf8") as f:
        return [tuple(line.split("|")) for line in f.read().split("\n") if line]
