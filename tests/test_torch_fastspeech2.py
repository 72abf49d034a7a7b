"""The port's FastSpeech2 two-stage serving slice against the JAX package on
the CPU: the config dicts, ``FastSpeech2.inference`` (conformer block,
CVAE conditioning, flash attention) on each decoder route, the weight
converters, and ``TwoStageTTS`` end to end against JAX ``FastSpeech2.inference``
followed by ``HiFiGANGenerator.apply``.

Weights are drawn in the port and carried to JAX through the reference
torch names (``import_fastspeech2``, ``import_hifigan_generator``); the port
side then runs the weights carried back by ``convert.fastspeech2_from_jax``
and ``convert.hifigan_from_jax``. Inputs come from numpy with a fixed seed.
"""

from __future__ import annotations

import functools
import json
import pathlib
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viet_tts_tpu.infer.api import DEFAULT_STATS as JAX_DEFAULT_STATS
from viet_tts_tpu.nn.utils import pad_mask_from_lengths as jax_pad_mask
from viet_tts_torch import config as port_config
from viet_tts_torch.convert import fastspeech2_from_jax, hifigan_from_jax, reference_state_dict
from viet_tts_torch.models.fastspeech2.model import FastSpeech2
from viet_tts_torch.models.hifigan import HiFiGANGenerator

from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    FS2_STATS,
    N_MELS,
    N_SYMBOLS,
    TINY_HIFI,
    fs2_hparams,
    hifigan_kwargs,
    jax_fs2,
    jax_hifigan,
    one_torch_thread,
    port_fs2,
    port_hifigan,
    t,
)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
B, T_TEXT = 3, 12
MEL_ATOL = 1e-4  # fp32 through the conformer stacks, predictors and postnet
WAV_ATOL = 1e-4


def test_config_dicts_equal_yaml():
    with open(REPO_ROOT / "config" / "model_config.yaml", encoding="utf8") as f:
        models = yaml.safe_load(f)
    assert port_config.fastspeech2_params() == models["fastspeech2"]
    assert port_config.adaspeech_params() == models["adaspeech"]
    assert port_config.matcha_params() == models["matcha"]
    assert port_config.hifigan_params() == models["hifigan"]
    assert port_config.DEFAULT_STATS == JAX_DEFAULT_STATS


@pytest.fixture(scope="module")
def fs2_case():
    """(JAX module, its variables, the port model on the weights carried
    back, numpy inputs): three utterances, one a single token, two
    speakers, two accents, a random reference mel for the CVAE."""
    hp = fs2_hparams("flash")
    seeded = port_fs2(hp)
    jm, variables = jax_fs2(seeded, hp)
    tm = FastSpeech2(N_SYMBOLS, N_MELS, hp, FS2_STATS, n_speakers=2)
    tm.load_state_dict(fastspeech2_from_jax(variables, hp), strict=True)
    tm.eval()
    rng = np.random.RandomState(0)
    inputs = dict(
        text=rng.randint(1, N_SYMBOLS, (B, T_TEXT)).astype(np.int32),
        lens=np.array([T_TEXT, T_TEXT - 3, 1], np.int32),
        feats=(0.5 * rng.randn(B, 64, N_MELS)).astype(np.float32),
        sids=np.array([0, 1, 1], np.int32),
        aids=np.array([1, 0, 1], np.int32),
    )
    return jm, variables, tm, seeded, inputs


def _jax_durations(m, sids, text, lens, max_mel_frames, feats, aids):
    """The JAX model's rounded durations and mel_lens (its variance
    adaptor run as ``inference`` runs it)."""
    text_pad = jax_pad_mask(lens, text.shape[1])
    hs, embs = m.encoder(text, text_pad, train=False)
    z_acc, _, z_spk, _, _ = m.speaker_emb(feats, aids, sids, train=False)
    (_, _, _, _, mel_lens, _, _), (d, _, _) = m.variance_adaptor(
        x=hs, txt_emb=embs, txt_lens=lens, txt_pad_mask=text_pad,
        spk_emb=jnp.concatenate([z_acc, z_spk], axis=1), max_mel_frames=max_mel_frames,
        train=False)
    return d, mel_lens


def test_converters_round_trip(fs2_case):
    """fastspeech2_from_jax(import_fastspeech2(sd)) == sd, and the same for
    the standalone HiFi-GAN (weight norm folded: the importer takes the
    effective weights). flax's GRU has no hidden r / z biases: the importer
    folds torch's into the input biases, so those are compared folded."""
    _, _, tm, seeded, _ = fs2_case
    want = seeded.state_dict()
    got = tm.state_dict()
    assert set(got) == set(want)
    for key in want:
        if ".gru.bias_" in key:
            continue
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0, msg=key)
    gru = "speaker_emb.encoder.gru"
    H = tm.speaker_emb.encoder.gru.hidden_size
    for sd in (got, want):
        sd["folded"] = torch.cat([sd[f"{gru}.bias_ih_l0"][:2 * H] + sd[f"{gru}.bias_hh_l0"][:2 * H],
                                  sd[f"{gru}.bias_ih_l0"][2 * H:], sd[f"{gru}.bias_hh_l0"][2 * H:]])
    torch.testing.assert_close(got["folded"], want["folded"], atol=1e-7, rtol=0)
    voc = port_hifigan()
    _, params = jax_hifigan(voc)
    back = HiFiGANGenerator(**hifigan_kwargs(TINY_HIFI))
    back.load_state_dict(hifigan_from_jax(params, TINY_HIFI), strict=True)
    for key, val in reference_state_dict(back.state_dict()).items():
        torch.testing.assert_close(val, reference_state_dict(voc.state_dict())[key],
                                   atol=1e-6, rtol=1e-5, msg=key)


@pytest.mark.parametrize("max_mel_frames,route", [(48, "xl3"), (600, "xl2"), (1100, "xl")])
def test_inference_matches_jax_on_each_route(fs2_case, max_mel_frames, route):
    """The decoder runs at max_mel_frames, which picks its attention route
    (the encoder's is xl3): mel within 1e-4, mel_lens and the rounded
    durations exact."""
    jm, variables, tm, _, x = fs2_case
    args = tuple(jnp.asarray(x[k]) for k in ("sids", "text", "lens"))
    synth = jax.jit(lambda v, s, ids, n, f, a: jm.apply(
        v, s, ids, n, max_mel_frames, feats=f, aids=a, method=jm.inference))
    mel_j, lens_j, _ = synth(variables, *args, x["feats"], x["aids"])
    d_j, lens_j2 = jax.jit(functools.partial(
        jm.apply, method=_jax_durations), static_argnums=4)(
        variables, *args, max_mel_frames, x["feats"], x["aids"])
    targs = (t(x["sids"], torch.long), t(x["text"], torch.long), t(x["lens"], torch.long))
    kw = dict(feats=t(x["feats"]), aids=t(x["aids"], torch.long))
    mel_t, lens_t, _ = tm.inference(*targs, max_mel_frames, **kw)
    _, lens_t2, _, d_t, _ = tm.adapt(*targs, max_mel_frames, **kw)
    assert mel_t.shape == (B, max_mel_frames, N_MELS)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(lens_t2.numpy(), np.asarray(lens_j2))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert np.asarray(lens_j).min() > 0
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=MEL_ATOL)


def test_two_stage_tts_matches_jax_and_serves(fs2_case, tmp_path):
    """TwoStageTTS from two saved port checkpoints (the weights carried back
    from JAX) against the JAX composition FastSpeech2.inference ->
    HiFiGANGenerator.apply on the same ids, waveform within 1e-4; then the
    HTTP server's three routes, and ``stream_wav`` against the batched
    waveform."""
    from viet_tts_torch.infer.api import TwoStageTTS, default_conf, save_checkpoint
    from viet_tts_torch.infer.server import serve

    jm, variables, tm, _, _ = fs2_case
    hp = fs2_hparams("flash")
    voc = port_hifigan()
    jvoc, voc_params = jax_hifigan(voc)
    port_voc = HiFiGANGenerator(**hifigan_kwargs(TINY_HIFI))
    port_voc.load_state_dict(hifigan_from_jax(voc_params, TINY_HIFI))
    conf = default_conf()
    conf["models"]["fastspeech2"] = hp
    conf["models"]["hifigan"] = dict(conf["models"]["hifigan"], **TINY_HIFI)
    save_checkpoint(str(tmp_path / "ac"), tm, conf, speakers={"a": 0, "b": 1},
                    stats=FS2_STATS)
    save_checkpoint(str(tmp_path / "voc"), port_voc,
                    {"audio": conf["audio"], "models": {"hifigan": conf["models"]["hifigan"]}})
    frames = 48
    tts = TwoStageTTS(str(tmp_path / "ac"), str(tmp_path / "voc"), max_mel_frames=frames,
                      device="cpu")
    texts = ["Hôm nay trời đẹp quá!", "Tôi yêu tiếng Việt."]
    waves = tts(texts, speaker="b", accent=1)

    ids, lens, _ = tts.encode_texts(texts)
    mel, mel_lens, _ = jax.jit(lambda v, ids, n: jm.apply(
        v, jnp.ones(2, jnp.int32), ids, n, frames, feats=jnp.zeros((2, 64, N_MELS)),
        aids=jnp.ones(2, jnp.int32), method=jm.inference))(
        variables, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32))
    wav_j = np.asarray(jax.jit(jvoc.apply)({"params": voc_params}, mel))[..., 0]
    assert len(waves) == 2 and np.abs(wav_j).max() > 1e-2
    for i, w in enumerate(waves):
        n = int(mel_lens[i]) * 256
        assert w.shape == (n,) and n > 0
        np.testing.assert_allclose(w, wav_j[i, :n], atol=WAV_ATOL)

    chunks = list(tts.stream_wav(texts[0], speaker="b", accent=1, chunk_frames=4,
                                 context_frames=32))
    streamed = np.concatenate(chunks)
    assert streamed.shape == waves[0].shape
    # the first window's zero left context is not the full decode's padding
    np.testing.assert_allclose(streamed[10 * 256:], waves[0][10 * 256:], atol=1e-5)

    httpd = serve(tts, port=0, model_name="FASTSPEECH2")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            assert json.load(r) == {"status": "ok", "model": "FASTSPEECH2"}
        for path, ctype in (("/synthesize", "audio/wav"), ("/synthesize_stream", "audio/L16")):
            req = urllib.request.Request(
                f"{base}{path}", data=json.dumps({"text": texts[0], "speaker": "b"}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200 and r.headers["Content-Type"].startswith(ctype)
                body = r.read()
                assert len(body) > 44 and len(body) % 2 == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_two_stage_tts_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="unknown building block"):
        FastSpeech2(N_SYMBOLS, N_MELS, fs2_hparams() | {"building_block": {
            "block_type": "lstm"}}, FS2_STATS, 1)
