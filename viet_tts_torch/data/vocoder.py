"""Vocoder (HiFi-GAN) dataset: waveform and log-mel, random aligned segments.

Counterpart of ``viet_tts_tpu/data/vocoder.py``: the peak-normalised
waveform with its cached log-mel (computed with the port's STFT where
there is no cache), random aligned (mel, waveform) segments of a fixed
size, so every batch is static-shape without buckets, and shuffled
fixed-size batches on the prefetch thread of ``data/batching.py``.

Two random streams advance: the batcher's shuffle (one permutation an
epoch) and the collate's segment starts (one draw for each item longer
than a segment). ``VocoderBatcher.skip`` (a port addition) replays both
from the items' lengths, read from the files' headers without the audio,
so a resumed run trains on the segments an uninterrupted one would.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
from scipy.io import wavfile

from viet_tts_torch.data.batching import prefetched
from viet_tts_torch.data.features import load_array, resolve_artifact
from viet_tts_torch.dsp.audio import peak_normalize, read_wav
from viet_tts_torch.dsp.stft import log_mel_from_config, num_frames


class VocoderDataset:
    """Items: the whole waveform (peak-normalised to 0.95) and its log-mel
    (T, n_mels), from the feature cache or computed on the fly."""

    def __init__(self, filelist: List[tuple], config: dict):
        self.inputs = list(filelist)
        self.config = config
        self.sr = config["signal"]["sampling_rate"]

    def __len__(self):
        return len(self.inputs)

    def lengths(self, index: int) -> Tuple[int, int]:
        """(mel frames, samples) of item ``index``, from the headers of its
        cached log-mel and its WAV file."""
        wav_path = self.inputs[index][0]
        n_samples = len(wavfile.read(wav_path, mmap=True)[1])
        cached = resolve_artifact(wav_path, "feat")
        if cached is None:
            return num_frames(n_samples, self.config["stft"]["hop_length"]), n_samples
        shape = (np.load(cached, mmap_mode="r") if cached.endswith(".npy")
                 else load_array(cached)).shape
        n_mel = shape[1] if shape[0] == self.config["mel"]["channels"] else shape[0]
        return n_mel, n_samples

    def __getitem__(self, index: int) -> dict:
        wav_path = self.inputs[index][0]
        audio, sr = read_wav(wav_path)
        if sr != self.sr:
            raise ValueError(f"{wav_path}: sample rate {sr} Hz, the config expects {self.sr} Hz")
        audio = peak_normalize(audio, 0.95)

        cached = resolve_artifact(wav_path, "feat")
        if cached is not None:
            mel = load_array(cached).astype(np.float32)
            if mel.shape[0] == self.config["mel"]["channels"]:
                mel = mel.T
        else:
            mel = log_mel_from_config(torch.from_numpy(audio)[None], self.config)[0].numpy()
        return dict(speech=audio.astype(np.float32), melspec=mel)


class VocoderSegmentCollate:
    """Random aligned (mel, waveform) segments -> mel (B, S, n_mels) and
    speech (B, S * U, 1); an item of at most S frames is taken whole and
    zero-padded. The starts come from a ``RandomState(seed)``."""

    def __init__(self, segment_size: int = 64, upsample_factor: int = 256, seed: int = 0):
        self.segment_size = segment_size
        self.upsample_factor = upsample_factor
        self.rng = np.random.RandomState(seed)

    def _frames(self, n_mel: int, n_samples: int) -> int:
        return min(n_mel, n_samples // self.upsample_factor)

    def _start(self, n_frames: int) -> int:
        """The segment's first frame: a draw only past one segment."""
        if n_frames <= self.segment_size:
            return 0
        return self.rng.randint(0, n_frames - self.segment_size + 1)

    def __call__(self, items: List[dict]) -> Dict[str, np.ndarray]:
        B = len(items)
        S, U = self.segment_size, self.upsample_factor
        mel = np.zeros((B, S, items[0]["melspec"].shape[1]), np.float32)
        wav = np.zeros((B, S * U, 1), np.float32)
        for i, it in enumerate(items):
            m, a = it["melspec"], it["speech"]
            n_frames = self._frames(m.shape[0], len(a))
            start = self._start(n_frames)
            n = min(n_frames, S)
            mel[i, :n] = m[start : start + n]
            seg = a[start * U : (start + n) * U]
            wav[i, : len(seg), 0] = seg
        return {"mel": mel, "speech": wav}

    def skip(self, lengths: Iterable[Tuple[int, int]]) -> None:
        """Advance the segment stream past a batch of items given by their
        (mel frames, samples), as collating them would."""
        for n_mel, n_samples in lengths:
            self._start(self._frames(n_mel, n_samples))


class VocoderBatcher:
    """Shuffled fixed-size batches over the dataset: the order is a
    ``RandomState(seed)`` permutation drawn once an epoch, and the last
    partial batch is filled by repeating its own items."""

    def __init__(self, dataset, batch_size: int, collate, seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self._skip_next = 0

    def __iter__(self):
        return prefetched(self._generate, self.prefetch)

    def _batches(self, order: np.ndarray) -> List[List[int]]:
        """The epoch's batches of dataset indices, the last repeat-filled."""
        batches = [[int(i) for i in order[s : s + self.batch_size]]
                   for s in range(0, len(order), self.batch_size)]
        if batches and len(batches[-1]) < self.batch_size:
            last = batches[-1]
            while len(last) < self.batch_size:
                last.append(last[len(last) % len(last)])
        return batches

    def _skip_batch(self, indices: List[int]) -> None:
        self.collate.skip(self.dataset.lengths(i) for i in indices)

    def _generate(self):
        skip, self._skip_next = self._skip_next, 0
        for n, indices in enumerate(self._batches(self.rng.permutation(len(self.dataset)))):
            if n < skip:
                self._skip_batch(indices)
            else:
                yield self.collate([self.dataset[i] for i in indices])

    def epoch_batches(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def skip(self, n_batches: int) -> None:
        """Start the next iteration ``n_batches`` into the batch stream:
        each whole epoch skipped draws its shuffle and replays its segment
        draws, and the next epoch's first ``n_batches % epoch_batches()``
        batches replay theirs without reading audio."""
        per_epoch = self.epoch_batches()
        if n_batches <= 0 or per_epoch == 0:
            return
        for _ in range(n_batches // per_epoch):
            for indices in self._batches(self.rng.permutation(len(self.dataset))):
                self._skip_batch(indices)
        self._skip_next = n_batches % per_epoch

    def __len__(self):
        return self.epoch_batches()
