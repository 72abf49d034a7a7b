"""Bucketed static-shape batching and a prefetch thread.

Counterpart of ``viet_tts_tpu/data/batching.py:20-232``: every batch is
padded to one of a few fixed (text, mel) bucket shapes and is exactly
``batch_size`` long (a bucket's last partial group is filled by repeating
its own samples, which the lengths mask), so the card sees a handful of
shapes; the serving path uses the text buckets alone. A daemon thread
assembles batch i + 1 while the step for batch i runs.

``BucketBatcher.skip`` (a port addition) moves the batch stream forward by
a number of batches, whole epochs through the shuffle's generator, so that
a resumed run draws the batches an uninterrupted one would.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np

DEFAULT_TEXT_BUCKETS = (32, 64, 96, 128, 160, 192, 256)
DEFAULT_MEL_BUCKETS = (128, 256, 384, 512, 640, 768, 896, 1008)


def bucket_for(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def pad_to(x: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """Zero-pad or cut ``x`` to ``length`` along ``axis``."""
    if x.shape[axis] >= length:
        slicer = [slice(None)] * x.ndim
        slicer[axis] = slice(0, length)
        return x[tuple(slicer)]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - x.shape[axis])
    return np.pad(x, widths)


def collate_acoustic(items: List[dict], t_text: int, t_mel: int) -> Dict[str, np.ndarray]:
    """Stack per-utterance dicts into one static-shape batch: text,
    text_lengths, feats, feats_lengths, pitch, energy, sids, aids, word_ids
    (-1 past the text) and duration (the prior (B, t_mel, t_text) or the
    durations (B, t_text))."""
    B = len(items)
    n_mels = items[0]["feat"].shape[1]

    batch = dict(
        text=np.zeros((B, t_text), np.int32),
        text_lengths=np.zeros(B, np.int32),
        feats=np.zeros((B, t_mel, n_mels), np.float32),
        feats_lengths=np.zeros(B, np.int32),
        pitch=np.zeros((B, t_mel), np.float32),
        energy=np.zeros((B, t_mel), np.float32),
        sids=np.zeros(B, np.int32),
        aids=np.zeros(B, np.int32),
        word_ids=np.full((B, t_text), -1, np.int32),
    )
    prior = items[0]["duration"].ndim == 2
    if prior:
        batch["duration"] = np.zeros((B, t_mel, t_text), np.float32)
    else:
        batch["duration"] = np.zeros((B, t_text), np.int32)

    for i, it in enumerate(items):
        nt = min(len(it["text"]), t_text)
        nm = min(it["feat"].shape[0], t_mel)
        batch["text"][i] = pad_to(it["text"], t_text)
        batch["text_lengths"][i] = nt
        batch["feats"][i] = pad_to(it["feat"], t_mel)
        batch["feats_lengths"][i] = nm
        batch["pitch"][i] = pad_to(it["pitch"], t_mel)
        batch["energy"][i] = pad_to(it["energy"], t_mel)
        batch["sids"][i] = it["sid"]
        batch["aids"][i] = it["aid"]
        batch["word_ids"][i, :nt] = it["word_ids"][:nt]  # pad stays -1
        if prior:
            batch["duration"][i, :nm, :nt] = it["duration"][:t_mel, :t_text]
        else:
            batch["duration"][i] = pad_to(it["duration"], t_text)
    return batch


def make_joint_collate(hop_length: int = 256):
    """The acoustic collate plus ``speech`` (B, t_mel * hop_length): each
    waveform cut or zero-padded to the mel bucket's samples (the Text2Wav
    trainer's ``collate_with_speech``, ``viet_tts_tpu/train/joint.py``)."""

    def collate(items: List[dict], t_text: int, t_mel: int) -> Dict[str, np.ndarray]:
        batch = collate_acoustic(items, t_text, t_mel)
        t_wav = t_mel * hop_length
        speech = np.zeros((len(items), t_wav), np.float32)
        for i, it in enumerate(items):
            a = it["speech"][:t_wav]
            speech[i, : len(a)] = a
        batch["speech"] = speech
        return batch

    return collate


def make_jets_collate(hop_length: int = 256):
    """The joint collate without the ``duration`` slot (JETS learns its
    alignment)."""
    joint = make_joint_collate(hop_length)

    def collate(items: List[dict], t_text: int, t_mel: int) -> Dict[str, np.ndarray]:
        batch = joint(items, t_text, t_mel)
        del batch["duration"]
        return batch

    return collate


class _PrefetchIterator:
    """Background-thread prefetch over a batch generator: the producer
    (disk reads and the numpy collate) fills a bounded queue from a daemon
    thread; its errors reach the consumer; ``close`` (or dropping the
    iterator mid-epoch) stops it."""

    def __init__(self, make_gen: Callable[[], Iterator], depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(make_gen,), daemon=True)
        self._thread.start()

    def _produce(self, make_gen: Callable[[], Iterator]) -> None:
        try:
            for item in make_gen():
                while not self._stop.is_set():
                    try:
                        self._q.put(("item", item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(("done", None))
        except BaseException as exc:  # surface producer errors to the consumer
            if not self._stop.is_set():
                self._q.put(("error", exc))

    def __iter__(self) -> "_PrefetchIterator":
        return self

    def __next__(self):
        kind, payload = self._q.get()
        if kind == "item":
            return payload
        if kind == "error":
            self.close()
            raise payload
        self.close()
        raise StopIteration

    def close(self) -> None:
        self._stop.set()
        # unblock a producer stuck on put()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):  # dropped mid-epoch (e.g. max_iter reached)
        self.close()


def prefetched(make_gen: Callable[[], Iterator], depth: int) -> Iterator:
    """Wrap a generator factory with background prefetch (depth <= 0: inline)."""
    if depth <= 0:
        return make_gen()
    return _PrefetchIterator(make_gen, depth)


class BucketBatcher:
    """Groups dataset indices into fixed-shape batches.

    Epoch order is shuffled by a ``RandomState(seed)`` that advances once an
    epoch; each batch is exactly ``batch_size`` (the last partial group of a
    bucket is filled by repeating its own samples, which are masked by
    lengths downstream).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
        mel_buckets: Sequence[int] = DEFAULT_MEL_BUCKETS,
        seed: int = 0,
        collate_fn=collate_acoustic,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.text_buckets = text_buckets
        self.mel_buckets = mel_buckets
        self.rng = np.random.RandomState(seed)
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self._skip_next = 0

    def _bucket(self, n_text: int, n_mel: int) -> tuple:
        return bucket_for(n_text, self.text_buckets), bucket_for(n_mel, self.mel_buckets)

    def _key(self, item) -> tuple:
        return self._bucket(len(item["text"]), item["feat"].shape[0])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return prefetched(self._generate, self.prefetch)

    def _generate(self) -> Iterator[Dict[str, np.ndarray]]:
        skip, self._skip_next = self._skip_next, 0
        order = self.rng.permutation(len(self.dataset))
        groups: Dict[tuple, List[dict]] = {}
        n = 0
        for idx in order:
            item = self.dataset[int(idx)]
            key = self._key(item)
            groups.setdefault(key, []).append(item)
            if len(groups[key]) == self.batch_size:
                items = groups.pop(key)
                n += 1
                if n > skip:
                    yield self.collate_fn(items, *key)
        for key, items in groups.items():
            while len(items) < self.batch_size:  # repeat-fill to static B
                items.append(items[len(items) % max(len(items), 1)])
            n += 1
            if n > skip:
                yield self.collate_fn(items, *key)

    def epoch_batches(self) -> int:
        """Batches in one epoch (the same for every shuffle): a batch per
        started ``batch_size`` of each bucket. The buckets come from the
        dataset's ``lengths(i)`` (text length, mel frames), which loads no
        item."""
        counts: Dict[tuple, int] = {}
        for i in range(len(self.dataset)):
            key = self._bucket(*self.dataset.lengths(i))
            counts[key] = counts.get(key, 0) + 1
        return sum(-(-c // self.batch_size) for c in counts.values())

    def skip(self, n_batches: int) -> None:
        """Start the next iteration ``n_batches`` into the batch stream: the
        shuffle of each whole epoch skipped is drawn and dropped, and the
        next epoch's first ``n_batches % epoch_batches()`` batches are not
        collated."""
        per_epoch = self.epoch_batches()
        if n_batches <= 0 or per_epoch == 0:
            return
        for _ in range(n_batches // per_epoch):
            self.rng.permutation(len(self.dataset))
        self._skip_next = n_batches % per_epoch

    def __len__(self) -> int:
        # upper bound (exact requires a pass; fine for progress display)
        return math.ceil(len(self.dataset) / self.batch_size)
