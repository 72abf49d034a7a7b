"""The port's acoustic data pipeline against the JAX package's, on the CPU.

The config reader (the port's YAML subset against ``yaml.safe_load``),
``derive_task_config``, the DSP front end (STFT features, audio helpers,
Dio and NCCF pitch), the filelists, the feature cache (each package writes
one copy of ``tests/synth_data.build_dataset``'s 2 speakers x 3 utterances
and reads the other's), ``AcousticDataset`` in prior and
supervised-duration mode, ``BucketBatcher``'s batches under one seed, the
prefetch thread and the TensorBoard event files; the JETS task's items
with the waveform (``include_speech``, read as the JAX package's native
reader reads it) and its collate; the vocoder pipeline (``VocoderDataset``,
``VocoderSegmentCollate``, ``VocoderBatcher`` and its ``skip``). Tolerances: mel features
and energy atol 1e-4 (two FFT libraries in fp32), pitch atol 1e-6 (the
same numpy code), the beta-binomial prior rel 1e-5 (scipy against
``torch.lgamma``), stats rel 1e-6, batches' integers exact and floats
atol 1e-4.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from viet_tts_tpu import config as jax_config
from viet_tts_tpu import dsp as jax_dsp
from viet_tts_tpu.data import batching as jax_batching
from viet_tts_tpu.data import dataset as jax_dataset
from viet_tts_tpu.data import features as jax_features
from viet_tts_tpu.data import filelist as jax_filelist
from viet_tts_tpu.data import vocoder as jax_vocoder
from viet_tts_tpu.dsp import dio as jax_dio
from viet_tts_tpu.dsp.stft import apply_log as jax_apply_log
from viet_tts_tpu.utils import tfevents as jax_tfevents
from viet_tts_torch import config as port_config
from viet_tts_torch.data import batching, dataset, features, filelist, vocoder
from viet_tts_torch.dsp import audio, dio, pitch, stft
from viet_tts_torch.utils import tfevents
from viet_tts_torch.utils.yaml_subset import YamlSubsetError, safe_load

from tests.synth_data import build_dataset
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "config")
FEAT_ATOL = 1e-4
PITCH_ATOL = 1e-6
PRIOR_RTOL = 1e-5
STATS_RTOL = 1e-6


# -- config ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(port_config.CONFIG_FILES.values()))
def test_config_file_reads_as_safe_load(name):
    with open(os.path.join(CONFIG_DIR, name), encoding="utf8") as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("task", ["fastspeech2", "jets", "matcha"])
def test_build_and_derive_config_match_jax(task):
    conf = port_config.build_config(CONFIG_DIR)
    assert conf == jax_config.build_config(CONFIG_DIR)
    derived = port_config.derive_task_config(conf, task)
    assert derived == jax_config.derive_task_config(jax_config.build_config(CONFIG_DIR), task)
    dumped = yaml.safe_dump(derived, sort_keys=False)
    assert safe_load(dumped) == yaml.safe_load(dumped) == derived


SUBSET = [
    "a: [1, [2, 3], {x: y, z: [4]}]\nb: {}\nc: []\n",
    "- - 1\n  - 2\n- - 3\n",
    "- a: 1\n  b: 2\n- c: 3\n",
    "k: 'it''s'\nq: \"a\\tb\\u00e9\"\nn: ~\ne:\nf: 1.5e-3\ng: 1e-3\nh: yes\ni: .inf\nj: -.5\n",
    "x:\n- 1\n- 2\ny: 3\n",
    "s: hello world  # a comment\n# another\nt: 'a # b'\n",
    "a:\n  - 1\n  -\n    b: 2\n",
    "'1': 2\n3: 4\nb: b:c\nc: 1_000\nd: Off\n",
]


@pytest.mark.parametrize("text", SUBSET)
def test_yaml_subset_matches_safe_load(text):
    assert safe_load(text) == yaml.safe_load(text)


UNSUPPORTED = [
    "a: &x 1\nb: *x\n",           # anchor, alias
    "a: !!str 1\n",               # tag
    "a: |\n  text\n",             # block scalar
    "a: 010\n",                   # octal
    "a: 0x1f\n",                  # hexadecimal
    "a: 2001-12-14\n",            # timestamp
    "a: 1:20\n",                  # sexagesimal
    "---\na: 1\n",                # document marker
    "a: b\n  c\n",                # multi-line plain scalar
    "a: [1,\n 2]\n",              # multi-line flow collection
    "? a\n: b\n",                 # complex key
    "a: b: c\n",                  # nested mapping on one line
]


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_yaml_subset_refuses_what_it_does_not_read(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)


# -- DSP ---------------------------------------------------------------------

def _audio(n=22050 + 777, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 22050.0
    x = 0.3 * np.sin(2 * np.pi * 140.0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (x + 0.01 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("name", ["linear_spectrogram", "log_spectrogram",
                                  "log_mel_from_config", "frame_energy"])
def test_stft_features_match_jax(name):
    cfg = port_config.default_audio()
    x = _audio()[None]
    got = getattr(stft, name)(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(getattr(jax_dsp, name)(x, cfg))
    assert got.shape == want.shape
    if name == "log_spectrogram":
        # a bin ~80 dB under the frame's peak turns the two FFTs' fp32
        # rounding into ~6e-4 of log: held as amplitudes, then as logs
        np.testing.assert_allclose(np.exp(got), np.exp(want), atol=FEAT_ATOL, rtol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-3)
    else:
        np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=1e-5)
    assert stft.num_frames(x.shape[-1], 256) == jax_dsp.num_frames(x.shape[-1], 256)
    np.testing.assert_allclose(stft.apply_log(torch.tensor([1e-12, 2.0]), 10.0).numpy(),
                               np.asarray(jax_apply_log(np.array([1e-12, 2.0]), 10.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("extractor", ["dio", "nccf"])
def test_pitch_extractors_match_jax(extractor):
    x = _audio()
    if extractor == "dio":
        got, want = dio.extract_f0_dio(x, 22050, 256), jax_dio.extract_f0_dio(x, 22050, 256)
    else:
        got, want = pitch.extract_f0(x, 22050, 256), jax_dsp.extract_f0(x, 22050, 256)
    assert (got > 0).sum() > len(got) // 2  # voiced
    np.testing.assert_allclose(got, want, atol=PITCH_ATOL)
    np.testing.assert_allclose(pitch.interpolate_unvoiced(got),
                               jax_dsp.interpolate_unvoiced(want), atol=PITCH_ATOL)


def test_audio_helpers_match_jax(tmp_path):
    x = _audio(seed=1)
    quiet = np.concatenate([np.zeros(4000, np.float32), x, np.zeros(3000, np.float32)])
    np.testing.assert_array_equal(audio.peak_normalize(x), jax_dsp.peak_normalize(x))
    np.testing.assert_array_equal(audio.resample(x, 22050, 16000),
                                  jax_dsp.resample(x, 22050, 16000))
    np.testing.assert_array_equal(audio.trim_silence(quiet, 22050),
                                  jax_dsp.trim_silence(quiet, 22050))
    np.testing.assert_array_equal(audio.loudness_normalize(x), jax_dsp.loudness_normalize(x))
    path = str(tmp_path / "x.wav")
    audio.write_wav(path, quiet, 22050)
    got, sr = audio.read_wav(path)
    want, sr_j = jax_dsp.read_wav(path)
    assert sr == sr_j == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio.preprocess_wav(path)[0], jax_dsp.preprocess_wav(path)[0])


# -- filelists -----------------------------------------------------------------

def test_filelists_match_jax(tmp_path):
    data_dir, egs_dir = build_dataset(str(tmp_path), n_utts=3)
    with open(os.path.join(egs_dir, "speakers.json")) as f:
        speakers = json.load(f)
    for split_dir, make in ((tmp_path / "jax", jax_filelist), (tmp_path / "port", filelist)):
        make.create_filelist(data_dir, speakers, str(split_dir), seed=7)
        make.create_unknown_filelist(os.path.join(data_dir, "hn_spk"),
                                     str(split_dir / "unknown"), seed=7)
    for rel in ("train.txt", "test.txt", "unknown/train.txt", "unknown/test.txt"):
        port_text = (tmp_path / "port" / rel).read_text(encoding="utf8")
        assert port_text == (tmp_path / "jax" / rel).read_text(encoding="utf8"), rel
    rows = filelist.read_filelist(str(tmp_path / "port" / "train.txt"))
    assert rows == jax_filelist.read_filelist(str(tmp_path / "port" / "train.txt"))
    assert len(rows) == 4 and all(len(r) == 4 for r in rows)


@pytest.mark.parametrize("tail", ["3, 2, 4", "2, [1, 2], 3", "4", "1, 1, [2, 3, 1]"])
def test_boundaries_match_jax(tail):
    got = dataset.flatten_boundaries(tail)
    assert got == jax_dataset.flatten_boundaries(tail)
    for n in (3, sum(got), sum(got) + 2):
        np.testing.assert_array_equal(dataset.word_ids_from_boundaries(got, n),
                                      jax_dataset.word_ids_from_boundaries(got, n))


# -- feature cache, dataset, batches --------------------------------------------

def _rows(egs_dir):
    return (filelist.read_filelist(os.path.join(egs_dir, "train.txt"))
            + filelist.read_filelist(os.path.join(egs_dir, "test.txt")))


def _moved(rows, src, dst):
    return [(r[0].replace(src, dst, 1),) + tuple(r[1:]) for r in rows]


def _supervised(rows):
    """The rows with a per-phoneme duration tail (the supervised mode's
    filelist), durations summing to each utterance's mel frames."""
    out = []
    for wav, spk, phones, _ in rows:
        n_mel = len(np.load(features._artifact_path(wav, "feat")))
        n = len(phones.split())
        durs = [n_mel // n] * n
        durs[-1] += n_mel - sum(durs)
        out.append((wav, spk, phones, ", ".join(map(str, durs))))
    return out


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        elif np.asarray(a[k]).dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=FEAT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            if g[k].dtype.kind == "f":
                np.testing.assert_allclose(g[k], w[k], atol=FEAT_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_feature_cache_dataset_and_batches_match_jax(tmp_path):
    """One costly setup (the JAX log-mel runs eagerly), every check on it:
    the caches each package writes, each package reading the other's
    cache, dataset stats and items in both modes, and the batches."""
    data_dir, egs_dir = build_dataset(str(tmp_path / "a"), n_utts=3)
    with open(os.path.join(egs_dir, "speakers.json")) as f:
        speakers = json.load(f)
    with open(os.path.join(egs_dir, "accents.json")) as f:
        accents = json.load(f)
    filelist.create_filelist(data_dir, speakers, egs_dir, seed=3)
    for copy in ("b", "c"):
        shutil.copytree(str(tmp_path / "a" / "data"), str(tmp_path / copy / "data"))
    conf = port_config.derive_task_config(port_config.build_config(CONFIG_DIR), "fastspeech2")
    audio_conf = conf["audio"]
    rows_j = _rows(egs_dir)
    rows_p = _moved(rows_j, "/a/data/", "/b/data/")

    paths_j = jax_features.prepare_inputs(rows_j, audio_conf)
    paths_p = features.prepare_inputs(rows_p, audio_conf)
    for (key, pj), (key_p, pp) in zip(paths_j.items(), paths_p.items()):
        assert key == key_p
        for kind, atol in (("feat", FEAT_ATOL), ("energy", FEAT_ATOL), ("pitch", PITCH_ATOL)):
            a, b = np.load(pj[kind]), features.load_array(pp[kind])
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(b, a, atol=atol, err_msg=f"{key} {kind}")
        np.testing.assert_allclose(np.load(pp["alignment"]), np.load(pj["alignment"]),
                                   rtol=PRIOR_RTOL, atol=1e-12)
    # each side reads the other's cache: nothing is recomputed
    assert jax_features.prepare_inputs(rows_p, audio_conf) == paths_p
    assert features.prepare_inputs(rows_j, audio_conf) == paths_j
    # the NCCF extractor writes the same pitch through both packages
    rows_c = _moved(rows_j, "/a/data/", "/c/data/")
    nccf = dict(audio_conf, pitch_extractor="nccf")
    features.prepare_inputs(rows_c, nccf)
    for wav, *_ in rows_c:
        want = jax_dsp.extract_f0(jax_dsp.read_wav(wav)[0], 22050, 256,
                                  target_len=len(np.load(features._artifact_path(wav, "feat"))))
        np.testing.assert_allclose(np.load(features._artifact_path(wav, "pitch")), want,
                                   atol=PITCH_ATOL)

    # prior mode (learn_alignment), each side on the other's cache
    train_j, train_p = rows_j[:4], rows_p[:4]
    ds_j = jax_dataset.AcousticDataset(train_p, audio_conf, speakers, accents)
    ds_p = dataset.AcousticDataset(train_j, audio_conf, speakers, accents)
    for kind in ("pitch", "energy"):
        for stat in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(ds_p.stats[kind][stat], ds_j.stats[kind][stat],
                                       rtol=STATS_RTOL, atol=1e-6, err_msg=f"{kind} {stat}")
    stats = ds_j.stats
    ds_j = jax_dataset.AcousticDataset(train_p, audio_conf, speakers, accents, stats=stats)
    ds_p = dataset.AcousticDataset(train_j, audio_conf, speakers, accents, stats=stats)
    for i in range(len(ds_p)):
        item_p, item_j = ds_p[i], ds_j[i]
        assert item_p["duration"].ndim == 2
        item_j["wav_path"] = item_p["wav_path"]
        _assert_items_equal(item_p, item_j)
        assert ds_p.lengths(i) == (len(item_p["text"]), item_p["feat"].shape[0])
    stats_path = str(tmp_path / "stats.json")
    dataset.save_stats(stats, stats_path)
    assert jax_dataset.load_stats(stats_path) == dataset.load_stats(stats_path) == stats
    # with the waveform and no durations (the JETS task's items and batches)
    kw = dict(stats=stats, include_speech=True, load_duration=False)
    wds_j = jax_dataset.AcousticDataset(train_p, audio_conf, speakers, accents, **kw)
    wds_p = dataset.AcousticDataset(train_j, audio_conf, speakers, accents, **kw)
    for i in range(len(wds_p)):
        item_p, item_j = wds_p[i], wds_j[i]
        np.testing.assert_array_equal(item_p["speech"], item_j["speech"])
        assert item_p["speech"].dtype == np.float32 and not item_p["duration"].any()
        item_j["wav_path"] = item_p["wav_path"]
        _assert_items_equal(item_p, item_j)
    _assert_batches_equal(
        list(batching.BucketBatcher(wds_p, 3, seed=11, prefetch=2,
                                    collate_fn=batching.make_jets_collate(256))),
        list(jax_batching.BucketBatcher(wds_j, 3, seed=11, prefetch=0,
                                        collate_fn=jax_batching.make_jets_collate(256))))

    # supervised-duration mode
    sup_conf = dict(audio_conf, self_learning=False)
    sup_j, sup_p = _supervised(rows_j), _supervised(rows_p)
    sds_j = jax_dataset.AcousticDataset(sup_j, sup_conf, speakers, accents)
    sds_p = dataset.AcousticDataset(sup_p, sup_conf, speakers, accents)
    for kind in ("pitch", "energy"):
        for stat in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(sds_p.stats[kind][stat], sds_j.stats[kind][stat],
                                       rtol=STATS_RTOL, atol=1e-6, err_msg=f"{kind} {stat}")
    for i in range(len(sds_p)):
        item_p, item_j = sds_p[i], sds_j[i]
        assert item_p["duration"].ndim == 1 and item_p["duration"].sum() == len(item_p["feat"])
        item_j["wav_path"] = item_p["wav_path"]
        _assert_items_equal(item_p, item_j)

    # batches under one seed: one full batch of 3 and one repeat-filled
    # (3 epochs, so the shuffle advances), inline and through the thread
    for data_p, data_j, bs in ((ds_p, ds_j, 3), (sds_p, sds_j, 4)):
        for prefetch in (0, 2):
            bb_p = batching.BucketBatcher(data_p, bs, seed=11, prefetch=prefetch)
            bb_j = jax_batching.BucketBatcher(data_j, bs, seed=11, prefetch=0)
            for _ in range(3):
                _assert_batches_equal(list(bb_p), list(bb_j))
            assert len(bb_p) == len(bb_j)
    assert any((b["text_lengths"] == 0).sum() == 0 and len(set(map(tuple, b["text"]))) < 3
               for b in batching.BucketBatcher(ds_p, 3, seed=11, prefetch=0))


class _Items(list):
    """A list of items with the ``lengths`` that ``BucketBatcher.epoch_batches``
    reads."""

    def lengths(self, i):
        return len(self[i]["text"]), self[i]["feat"].shape[0]


def _varied_items(n):
    rng = np.random.RandomState(0)
    return _Items(dict(text=np.arange(1, 4 + (i % 3) * 30, dtype=np.int32),
                       word_ids=np.zeros(4 + (i % 3) * 30, np.int32),
                       feat=rng.randn(70 + 90 * (i % 2), 80).astype(np.float32),
                       duration=np.ones(4 + (i % 3) * 30, np.int32),
                       pitch=np.zeros(70 + 90 * (i % 2), np.float32),
                       energy=np.zeros(70 + 90 * (i % 2), np.float32),
                       sid=np.int32(i % 2), aid=np.int32(0)) for i in range(n))


def test_batcher_skip_repeats_the_uninterrupted_stream():
    """``skip(n)`` then iterating gives the stream from batch n on."""
    data = _varied_items(11)
    full = batching.BucketBatcher(data, 2, seed=5, prefetch=0)
    per_epoch = full.epoch_batches()
    stream = [b for _ in range(3) for b in full]
    assert len(stream) == 3 * per_epoch
    for n in (0, 1, per_epoch, per_epoch + 2, 2 * per_epoch - 1):
        resumed = batching.BucketBatcher(data, 2, seed=5, prefetch=2)
        resumed.skip(n)
        got = [b for _ in range(3 - n // per_epoch) for b in resumed][: len(stream) - n]
        _assert_batches_equal(got, stream[n:])


@pytest.mark.parametrize("batch_size", [1, 2, 3, 4, 11])
def test_epoch_batches_counts_the_batches_of_an_epoch(batch_size):
    """``epoch_batches`` (from lengths alone) equals the batches an epoch
    yields, each exactly ``batch_size`` long."""
    batcher = batching.BucketBatcher(_varied_items(11), batch_size, seed=3, prefetch=0)
    epoch = list(batcher)
    assert batcher.epoch_batches() == len(epoch)
    assert all(len(b["text"]) == batch_size for b in epoch)


def test_jets_collate_matches_jax():
    """The acoustic collate without durations, with each waveform cut or
    zero-padded to the mel bucket's samples: equal to JAX's bit for bit."""
    rng = np.random.RandomState(4)
    items = [dict(text=rng.randint(1, 90, n).astype(np.int32),
                  word_ids=np.arange(n, dtype=np.int32) // 3,
                  feat=rng.randn(m, 80).astype(np.float32),
                  duration=np.zeros(n, np.int32),
                  pitch=rng.randn(m).astype(np.float32), energy=rng.randn(m).astype(np.float32),
                  speech=rng.randn(m * 256 + extra).astype(np.float32),
                  sid=np.int32(i), aid=np.int32(1))
             for i, (n, m, extra) in enumerate(((9, 70, 100), (13, 128, 300), (5, 40, -20)))]
    got = batching.make_jets_collate(256)(items, 32, 128)
    want = jax_batching.make_jets_collate(256)(items, 32, 128)
    assert got.keys() == want.keys() and "duration" not in got
    assert got["speech"].shape == (3, 128 * 256)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_read_wav_matches_the_native_reader(tmp_path):
    """The port's ``read_wav`` against the JAX package's
    ``runtime/native.py:wav_read_f32`` (its ``collate.cpp`` reader, built
    with g++ on first use) on the written 16-bit wavs: equal sample for
    sample."""
    from viet_tts_tpu.runtime import native

    data_dir, _ = build_dataset(str(tmp_path), n_utts=2)
    wavs = [os.path.join(data_dir, spk, "wavs", name) for spk in sorted(os.listdir(data_dir))
            for name in sorted(os.listdir(os.path.join(data_dir, spk, "wavs")))]
    extra = str(tmp_path / "port.wav")
    audio.write_wav(extra, _audio(seed=3), 22050)
    for path in wavs + [extra]:
        got, sr = audio.read_wav(path)
        want, sr_native = native.wav_read_f32(path)
        assert sr == sr_native == 22050 and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_collate_and_pad_match_jax():
    rng = np.random.RandomState(2)
    items = [dict(text=rng.randint(1, 90, n).astype(np.int32),
                  word_ids=np.arange(n, dtype=np.int32) // 3,
                  feat=rng.randn(m, 80).astype(np.float32),
                  duration=rng.rand(m, n).astype(np.float32),
                  pitch=rng.randn(m).astype(np.float32), energy=rng.randn(m).astype(np.float32),
                  sid=np.int32(1), aid=np.int32(0)) for n, m in ((9, 70), (13, 120))]
    _assert_batches_equal([batching.collate_acoustic(items, 32, 128)],
                          [jax_batching.collate_acoustic(items, 32, 128)])
    x = rng.randn(5, 7)
    for length, axis in ((3, 0), (9, 1)):
        np.testing.assert_array_equal(batching.pad_to(x, length, axis),
                                      jax_batching.pad_to(x, length, axis))
    assert batching.DEFAULT_MEL_BUCKETS == jax_batching.DEFAULT_MEL_BUCKETS


def test_prefetch_thread_order_errors_and_close():
    assert list(batching.prefetched(lambda: iter(range(50)), 3)) == list(range(50))

    def bad():
        yield 1
        raise ValueError("producer failed")

    it = batching.prefetched(bad, 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)
    it = batching.prefetched(lambda: iter(range(10 ** 6)), 2)
    next(it)
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


# -- tfevents --------------------------------------------------------------------

# -- the vocoder pipeline ---------------------------------------------------------

VOC_SEGMENT = 96  # the 1.0 s utterances (87 frames) fit whole, the 1.2 s (104) draw


def _vocoder_batches(ds, collate_seed, batcher_seed, module, prefetch, epochs=2):
    batcher = module.VocoderBatcher(
        ds, 4, module.VocoderSegmentCollate(VOC_SEGMENT, 256, seed=collate_seed),
        seed=batcher_seed, prefetch=prefetch)
    return [b for _ in range(epochs) for b in batcher]


def test_vocoder_dataset_and_batches_match_jax(tmp_path):
    """``VocoderDataset`` items against the JAX package's, with the feature
    cache (both read the same file: exact) and without it (the log-mel of
    the peak-normalised waveform, two FFT libraries: atol 1e-4); the
    waveform exact either way. ``VocoderBatcher`` batches of
    ``VocoderSegmentCollate`` segments under one seed over two epochs (6
    items at batch 4: one full batch and one repeat-filled an epoch),
    through the prefetch thread, equal to JAX's inline batches."""
    data_dir, egs_dir = build_dataset(str(tmp_path / "a"), n_utts=3)
    with open(os.path.join(egs_dir, "speakers.json")) as f:
        filelist.create_filelist(data_dir, json.load(f), egs_dir, seed=3)
    shutil.copytree(str(tmp_path / "a" / "data"), str(tmp_path / "b" / "data"))
    audio_conf = port_config.build_config(CONFIG_DIR)["audio"]
    rows = _rows(egs_dir)
    features.prepare_inputs(rows, audio_conf)
    for cached, rows_case in ((True, rows), (False, _moved(rows, "/a/data/", "/b/data/"))):
        ds_p = vocoder.VocoderDataset(rows_case, audio_conf)
        ds_j = jax_vocoder.VocoderDataset(rows_case, audio_conf)
        assert len(ds_p) == len(ds_j) == 6
        for i in range(len(ds_p)):
            item_p, item_j = ds_p[i], ds_j[i]
            assert item_p.keys() == item_j.keys() == {"speech", "melspec"}
            np.testing.assert_array_equal(item_p["speech"], item_j["speech"])
            if cached:
                np.testing.assert_array_equal(item_p["melspec"], item_j["melspec"])
            else:
                assert features.resolve_artifact(rows_case[i][0], "feat") is None
                np.testing.assert_allclose(item_p["melspec"], item_j["melspec"],
                                           atol=FEAT_ATOL)
            assert ds_p.lengths(i) == (len(item_p["melspec"]), len(item_p["speech"]))
    ds_p = vocoder.VocoderDataset(rows, audio_conf)
    ds_j = jax_vocoder.VocoderDataset(rows, audio_conf)
    got = _vocoder_batches(ds_p, 7, 8, vocoder, prefetch=2)
    want = _vocoder_batches(ds_j, 7, 8, jax_vocoder, prefetch=0)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"mel", "speech"}
        assert g["mel"].shape == (4, VOC_SEGMENT, 80) and g["speech"].shape == (
            4, VOC_SEGMENT * 256, 1)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # some segments start past frame 0, some items are shorter than one
    assert any(not (b["speech"][:, -256:] == 0).all() for b in got)
    assert any((b["speech"][:, -256:] == 0).all(axis=(1, 2)).any() for b in got)


class _VocoderItems(list):
    """Waveform / log-mel items of varied lengths with their ``lengths``."""

    def lengths(self, i):
        return len(self[i]["melspec"]), len(self[i]["speech"])


def test_vocoder_batcher_skip_repeats_the_uninterrupted_stream():
    """``skip(n)`` then iterating gives the stream from batch n on, the
    segments included: both the shuffle and the segment starts (drawn only
    for items longer than a segment) are replayed from the lengths."""
    rng = np.random.RandomState(0)
    items = _VocoderItems(
        dict(melspec=rng.randn(n, 80).astype(np.float32),
             speech=rng.randn(n * 256 + extra).astype(np.float32))
        for n, extra in ((50, 0), (140, 17), (97, 300), (230, -256), (96, 5), (180, 0),
                         (61, 255)))

    def batcher():
        return vocoder.VocoderBatcher(
            items, 3, vocoder.VocoderSegmentCollate(VOC_SEGMENT, 256, seed=2), seed=5,
            prefetch=0)

    full = batcher()
    per_epoch = full.epoch_batches()
    stream = [b for _ in range(3) for b in full]
    assert per_epoch == len(full) == 3 and len(stream) == 3 * per_epoch
    for n in (0, 1, per_epoch, per_epoch + 2, 2 * per_epoch - 1):
        resumed = batcher()
        resumed.skip(n)
        got = [b for _ in range(3 - n // per_epoch) for b in resumed][: len(stream) - n]
        assert len(got) == len(stream) - n
        for g, w in zip(got, stream[n:]):
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"skip {n}: {k}")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfevents_read_by_both_packages(tmp_path, writer):
    make = tfevents if writer == "port" else jax_tfevents
    w = make.EventWriter(str(tmp_path))
    w.add_scalar("train/feat", 1.25, 3)
    w.add_histogram("encoder.weight", np.linspace(-1.0, 2.0, 101), 4)
    w.close()
    (name,) = os.listdir(tmp_path)
    path = str(tmp_path / name)
    got, want = tfevents.read_events(path), jax_tfevents.read_events(path)
    assert got == want and len(got) == 3
    assert got[0]["file_version"] == "brain.Event:2"
    assert got[1]["step"] == 3 and got[1]["values"] == {"train/feat": 1.25}
    histo = got[2]["values"]["encoder.weight"]
    assert histo["num"] == 101 and histo["min"] == -1.0 and histo["max"] == 2.0
