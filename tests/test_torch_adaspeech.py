"""The FFT blocks, FastSpeech2 with the transformer block, and AdaSpeech
(modules, model, converters, serving) against the JAX package, on the CPU.

The port's seeded models go to JAX through the JAX package's importers
(``import_fastspeech2``, ``import_adaspeech``; AdaSpeech's conditional
layer norms drawn away from their LayerNorm start, so that the speaker
conditioning shows) and come back through ``convert.fastspeech2_from_jax`` /
``adaspeech_from_jax``. Every dropout rate is 0 (``ada_hparams``; the
tiny FastSpeech2 of ``tests/test_fastspeech2.py`` likewise); everything
here runs in eval mode (the training forward, losses and gradients are in
``test_torch_adaspeech_trainer.py``).

All the JAX work is one jitted function in one test item
(``test_modules_models_and_serving_match_jax``), since ``--dist load``
would set a module fixture up again on each worker. Tolerances: fp32
modules 1e-5; ``aggregate_by_ids`` and ``token_avg_mels`` 1e-6; mels and
waveforms 1e-4; durations and lengths exact.
"""

from __future__ import annotations

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viet_tts_tpu.models.adaspeech import AdaSpeech as JaxAdaSpeech
from viet_tts_tpu.models.adaspeech import layers as jax_ada_layers
from viet_tts_tpu.models.text2wav import Text2Wav as JaxText2Wav
from viet_tts_tpu.nn import transformer as jax_transformer
from viet_tts_tpu.ops import aggregate_by_ids as jax_aggregate_by_ids
from viet_tts_tpu.train.torch_import import import_adaspeech, import_fastspeech2
from viet_tts_torch.config import default_audio
from viet_tts_torch.convert import (
    adaspeech_from_jax,
    fastspeech2_from_jax,
    reference_state_dict,
    text2wav_from_jax,
)
from viet_tts_torch.infer.api import TwoStageTTS, save_checkpoint
from viet_tts_torch.models.adaspeech import AdaSpeech
from viet_tts_torch.models.adaspeech.layers import ConditionalLayerNorm
from viet_tts_torch.models.adaspeech.model import token_avg_mels
from viet_tts_torch.models.fastspeech2.model import FastSpeech2
from viet_tts_torch.models.text2wav import Text2Wav
from viet_tts_torch.nn.utils import seeded_init_
from viet_tts_torch.ops.duration import aggregate_by_ids

from tests.test_fastspeech2 import tiny_hparams
from tests.test_torch_gan_trainer import STEP_HIFI
from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    FS2_STATS,
    N_MELS,
    N_SYMBOLS,
    ada_hparams,
    jax_adaspeech,
    jax_fs2,
    jax_hifigan,
    one_torch_thread,
    port_adaspeech,
    port_fs2,
    port_hifigan,
    t,
)

B, T_TEXT, T_MEL, T_REF = 2, 9, 24, 16
INFER_FRAMES = 40
SERVE_FRAMES = 32
TEXTS = ["Hôm nay trời đẹp quá!", "Chúng ta cùng nhau học tập và làm việc thật tốt."]
SPEAKERS = {"hn_spk": 0, "hcm_spk": 1}
MOD_ATOL = 1e-5
OPS_ATOL = 1e-6
MEL_ATOL = 1e-4


def fs2_transformer_hparams():
    hp = tiny_hparams("transformer")
    block = hp["building_block"]["transformer"]
    block["encoder_dropout"] = block["decoder_dropout"] = 0.0
    hp["variance"]["variance_predictor"]["dropout"] = 0.0
    return hp


def _inputs():
    """Seeded numpy inputs: a batch (the second utterance shorter), a
    reference mel, x and word ids for ``aggregate_by_ids`` (-1 padding),
    and hand-made durations for ``token_avg_mels`` with zero-duration
    tokens early and a span that overruns the mel."""
    rng = np.random.RandomState(0)
    text_lens = np.array([T_TEXT, T_TEXT - 3], np.int32)
    mel_lens = np.array([T_MEL, T_MEL - 6], np.int32)
    text = rng.randint(1, N_SYMBOLS, (B, T_TEXT)) * (np.arange(T_TEXT) < text_lens[:, None])
    return dict(
        text=text.astype(np.int32), text_lengths=text_lens,
        feats=rng.randn(B, T_MEL, N_MELS).astype(np.float32), feats_lengths=mel_lens,
        duration=rng.rand(B, T_MEL, T_TEXT).astype(np.float32),
        pitch=rng.randn(B, T_MEL).astype(np.float32),
        energy=rng.randn(B, T_MEL).astype(np.float32),
        sids=np.array([0, 1], np.int32), aids=np.array([1, 0], np.int32),
        ref=rng.randn(B, T_REF, N_MELS).astype(np.float32),
        x=rng.rand(B, T_TEXT).astype(np.float32) * 5.0,
        word_ids=np.array([[0, 0, 1, 1, 1, 2, 3, 3, 3], [0, 1, 1, 2, 2, 2, -1, -1, -1]],
                          np.int32),
        # row 0: two zero-duration tokens first (the later spans start
        # behind their own index and read rows already overwritten), row 1:
        # token 4's span runs past the mel's 18 frames, token 5's lies beyond
        durs=np.array([[0, 0, 2, 1, 3, 1, 2, 4, 3], [2, 4, 3, 5, 6, 9, 1, 1, 1]], np.float32),
        hidden=rng.randn(B, T_TEXT, 32).astype(np.float32),
        frames=rng.randn(B, T_MEL, 32).astype(np.float32),
        spk=rng.randn(B, 32).astype(np.float32),
    )


def _jax_reference(fs2, ada, t2w, tts_in):
    """One jitted function of (variables, inputs) -> every JAX output this
    file holds the port against: the FFT block (a fully padded utterance
    too), the FFT encoder / decoder, the CLN, the CLN block and stacks,
    the three acoustic-condition encoders, ``aggregate_by_ids`` (both
    modes), ``_token_avg_mels`` (with and without frame lengths), the
    FastSpeech2-transformer eval forward and inference, AdaSpeech's
    inference with and without a reference mel, and ``Text2Wav``'s
    inference on the serving inputs (64 zero reference frames)."""
    fs2_jm, ada_jm, t2w_jm = fs2[0], ada[0], t2w[0]
    fb = fs2_jm.hparams["building_block"]["transformer"]
    fft = dict(d_model=32, num_heads=fb["encoder_head"], d_inner=fb["conv_filter_size"],
               kernel_sizes=tuple(fb["conv_kernel_size"]), dropout=0.0)
    re = ada_jm.hparams["variance"]["reference_encoder"]

    def ref(fs2_vars, ada_vars, t2w_vars, d, tts_ids, tts_lens):
        fp, ap = fs2_vars["params"], ada_vars["params"]
        pad = jnp.arange(T_TEXT)[None] >= d["text_lengths"][:, None]
        all_pad = pad.at[1].set(True)  # the second utterance: no real token
        mel_pad = jnp.arange(T_MEL)[None] >= d["feats_lengths"][:, None]
        out = {}
        block = jax_transformer.FFTBlock(**fft)
        out["fft"] = block.apply({"params": fp["encoder"]["layer_0"]}, d["hidden"], all_pad)
        enc = jax_transformer.TransformerEncoder(n_symbols=N_SYMBOLS, n_layers=1,
                                                 max_seq_len=100, **fft)
        out["encoder"] = enc.apply({"params": fp["encoder"]}, d["text"], pad)
        dec = jax_transformer.TransformerDecoder(n_layers=1, max_seq_len=100, **fft)
        out["decoder"] = dec.apply({"params": fp["decoder"]}, d["frames"], mel_pad)[0]
        out["cln"] = jax_ada_layers.ConditionalLayerNorm(32).apply(
            {"params": ap["cln"]}, d["frames"], d["spk"])
        out["cln_block"] = jax_ada_layers.CLNFFTBlock(**fft).apply(
            {"params": ap["encoder"]["layer_0"]}, d["hidden"], d["spk"], all_pad)
        out["cln_encoder"] = jax_ada_layers.CLNTransformerEncoder(
            n_symbols=N_SYMBOLS, n_layers=1, max_seq_len=100, **fft).apply(
            {"params": ap["encoder"]}, d["text"], pad, d["spk"])
        out["cln_decoder"] = jax_ada_layers.CLNTransformerDecoder(
            n_layers=1, max_seq_len=100, **fft).apply(
            {"params": ap["decoder"]}, d["frames"], mel_pad, d["spk"])[0]
        ue, pe, pp = (re[k] for k in ("utterance_encoder", "phoneme_level_encoder",
                                      "phoneme_level_predictor"))
        out["utterance"] = jax_ada_layers.UtteranceEncoder(
            ue["n_chans"], ue["kernel_size"], ue["stride"], 0.0).apply(
            {"params": ap["utterance_encoder"]}, d["feats"])
        out["phoneme_encoder"] = jax_ada_layers.PhonemeLevelEncoder(
            pe["n_chans"], pe["kernel_size"], 0.0, re["phn_latent_dim"]).apply(
            {"params": ap["phoneme_level_encoder"]}, d["feats"][:, :T_TEXT])
        out["phoneme_predictor"] = jax_ada_layers.PhonemeLevelPredictor(
            pp["n_chans"], pp["kernel_size"], 0.0, re["phn_latent_dim"]).apply(
            {"params": ap["phoneme_level_predictor"]}, d["hidden"])
        out["agg_sum"] = jax_aggregate_by_ids(d["x"], d["word_ids"], 4)
        out["agg_mean"] = jax_aggregate_by_ids(d["x"], d["word_ids"], 4, mode="mean")
        out["avg_mels"] = JaxAdaSpeech._token_avg_mels(d["durs"], d["feats"],
                                                       d["text_lengths"], d["feats_lengths"])
        out["avg_mels_free"] = JaxAdaSpeech._token_avg_mels(d["durs"], d["ref"],
                                                            d["text_lengths"], None)
        model_args = {k: d[k] for k in ("text", "text_lengths", "feats", "feats_lengths",
                                        "duration", "pitch", "energy", "sids", "aids")}
        out["fs2_forward"] = fs2_jm.apply(fs2_vars, **model_args, step=0, train=False,
                                          mutable=["batch_stats"])[0]
        infer = (d["sids"], d["text"], d["text_lengths"], INFER_FRAMES)
        out["fs2_inference"] = fs2_jm.apply(fs2_vars, *infer, feats=d["ref"], aids=d["aids"],
                                            method=fs2_jm.inference)
        out["ada_inference"] = ada_jm.apply(ada_vars, *infer, feats=d["ref"], aids=d["aids"],
                                            method=ada_jm.inference)
        spk = out["ada_inference"][2]
        out["ada_inference_free"] = ada_jm.apply(ada_vars, *infer, spk_embs=spk,
                                                 method=ada_jm.inference)
        n = tts_ids.shape[0]
        out["t2w"] = t2w_jm.apply(
            t2w_vars, jnp.zeros(n, jnp.int32), tts_ids, tts_lens, SERVE_FRAMES,
            feats=jnp.zeros((n, 64, N_MELS)), aids=jnp.zeros(n, jnp.int32),
            method=t2w_jm.inference)
        return out

    out = jax.jit(ref)(fs2[1], ada[1], t2w[1], {k: jnp.asarray(v) for k, v in _inputs().items()},
                       *(jnp.asarray(x) for x in tts_in))
    return jax.tree_util.tree_map(lambda x: None if x is None else np.asarray(x), out,
                                  is_leaf=lambda x: x is None)


def _close(got, want, atol, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.shape(want), name
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol, err_msg=name)


def _t2w_conf():
    return {"audio": default_audio(),
            "models": {"adaspeech": ada_hparams(), "hifigan": dict(STEP_HIFI)}}


def test_modules_models_and_serving_match_jax(tmp_path):
    """Every module of the slice and its entry points on the JAX
    package's outputs: the FFT block (a fully padded utterance's attention
    uniform and finite, its outputs 0), encoder and decoder, the CLN, CLN
    block and CLN stacks, UtteranceEncoder / PhonemeLevelEncoder /
    Predictor (1e-5); ``aggregate_by_ids`` sum and mean, ``token_avg_mels``
    through zero-duration tokens and an overrunning span (1e-6); the
    FastSpeech2-transformer eval forward and inference, AdaSpeech's
    inference with a reference mel and with the predicted latents (mels
    1e-4, durations and lengths exact); ``TwoStageTTS(model_type=
    "ADASPEECH")`` and ``Text2Wav(version="adaspeech")`` on JAX
    ``Text2Wav.inference``'s waveform (1e-4), and the server's routes."""
    fs2_hp, ada_hp = fs2_transformer_hparams(), ada_hparams()
    fs2_port, ada_port = port_fs2(fs2_hp), port_adaspeech(ada_hp)
    fs2_jax, ada_jax = jax_fs2(fs2_port, fs2_hp), jax_adaspeech(ada_port, ada_hp)
    hifi = port_hifigan(STEP_HIFI)
    conf = _t2w_conf()
    t2w_vars = {"params": {"text2mel": ada_jax[1]["params"],
                           "mel2wav": jax_hifigan(hifi, STEP_HIFI)[1]},
                "batch_stats": {"text2mel": ada_jax[1]["batch_stats"]}}
    t2w_jm = JaxText2Wav(n_symbols=N_SYMBOLS, n_channels=N_MELS, conf=conf, stats=FS2_STATS,
                         n_speakers=2, n_accents=2, version="adaspeech")
    ac_dir, voc_dir = str(tmp_path / "acoustic"), str(tmp_path / "vocoder")
    save_checkpoint(ac_dir, ada_port, conf, speakers=SPEAKERS, stats=FS2_STATS)
    save_checkpoint(voc_dir, hifi, {"models": {"hifigan": dict(STEP_HIFI)}})
    tts = TwoStageTTS(ac_dir, voc_dir, model_type="ADASPEECH", max_mel_frames=SERVE_FRAMES,
                      device="cpu")
    tts_ids, tts_lens, _ = tts.encode_texts(TEXTS)
    want = _jax_reference(fs2_jax, ada_jax, (t2w_jm, t2w_vars), (tts_ids, tts_lens))

    d = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in _inputs().items()}
    pad = torch.arange(T_TEXT)[None] >= d["text_lengths"][:, None]
    all_pad = pad.clone()
    all_pad[1] = True
    mel_pad = torch.arange(T_MEL)[None] >= d["feats_lengths"][:, None]
    with torch.no_grad():
        # FFT block, encoder, decoder (the FastSpeech2-transformer's)
        x, attn = fs2_port.encoder.layer_stack[0](d["hidden"], all_pad)
        assert torch.isfinite(attn).all() and torch.isfinite(x).all()
        torch.testing.assert_close(attn[1], torch.full_like(attn[1], 1.0 / T_TEXT))
        assert not x[1].any()
        _close(x, want["fft"][0], MOD_ATOL, "FFT block")
        _close(attn, want["fft"][1], MOD_ATOL, "FFT block attention")
        for got, w, name in zip(fs2_port.encoder(d["text"], pad), want["encoder"],
                                ("encoder", "embedding")):
            _close(got, w, MOD_ATOL, name)
        _close(fs2_port.decoder(d["frames"], mel_pad)[0], want["decoder"], MOD_ATOL, "decoder")
        # AdaSpeech's modules
        va = ada_port.variance_adaptor
        _close(ada_port.cln(d["frames"], d["spk"]), want["cln"], MOD_ATOL, "CLN")
        _close(ada_port.encoder.layer_stack[0](d["hidden"], d["spk"], all_pad),
               want["cln_block"], MOD_ATOL, "CLN block")
        for got, w, name in zip(ada_port.encoder(d["text"], pad, d["spk"]),
                                want["cln_encoder"], ("CLN encoder", "embedding")):
            _close(got, w, MOD_ATOL, name)
        _close(ada_port.decoder(d["frames"], mel_pad, d["spk"])[0], want["cln_decoder"],
               MOD_ATOL, "CLN decoder")
        _close(va.utterance_encoder(d["feats"]), want["utterance"], MOD_ATOL, "utterance")
        _close(va.phoneme_level_encoder(d["feats"][:, :T_TEXT]), want["phoneme_encoder"],
               MOD_ATOL, "phoneme encoder")
        _close(va.phoneme_level_predictor(d["hidden"]), want["phoneme_predictor"], MOD_ATOL,
               "phoneme predictor")
        # the ops
        _close(aggregate_by_ids(d["x"], d["word_ids"], 4), want["agg_sum"], OPS_ATOL, "sum")
        _close(aggregate_by_ids(d["x"], d["word_ids"], 4, mode="mean"), want["agg_mean"],
               OPS_ATOL, "mean")
        _close(token_avg_mels(d["durs"], d["feats"], d["text_lengths"], d["feats_lengths"]),
               want["avg_mels"], OPS_ATOL, "token_avg_mels")
        _close(token_avg_mels(d["durs"], d["ref"], d["text_lengths"], None),
               want["avg_mels_free"], OPS_ATOL, "token_avg_mels, no frame lengths")

        # FastSpeech2 with the transformer block: eval forward, inference
        args = {k: d[k] for k in ("text", "text_lengths", "feats", "feats_lengths",
                                  "duration", "pitch", "energy", "sids", "aids")}
        (outs, post, log_d, p_outs, e_outs, *_rest), extra = fs2_port(**args)
        w_pred, w_extra = want["fs2_forward"]
        for got, w, name in ((outs, w_pred[0], "mel"), (post, w_pred[1], "postnet mel")):
            assert np.abs(w).max() > 1e-2
            _close(got, w, MEL_ATOL, f"FS2-transformer forward {name}")
        for got, w, name in ((log_d, w_pred[2], "log_d"), (p_outs, w_pred[3], "pitch"),
                             (e_outs, w_pred[4], "energy"), (extra[1], w_extra[1], "ps")):
            _close(got, w, MOD_ATOL, f"FS2-transformer forward {name}")
        np.testing.assert_array_equal(extra[0].numpy(), w_extra[0])
        infer = (d["sids"], d["text"], d["text_lengths"], INFER_FRAMES)
        mel, lens, _ = fs2_port.inference(*infer, feats=d["ref"], aids=d["aids"])
        np.testing.assert_array_equal(lens.numpy(), want["fs2_inference"][1])
        _close(mel, want["fs2_inference"][0], MEL_ATOL, "FS2-transformer inference")

        # AdaSpeech inference: the reference mel's latents, the predicted ones
        mel, lens, spk = ada_port.inference(*infer, feats=d["ref"], aids=d["aids"])
        w_mel, w_lens, w_spk = want["ada_inference"]
        assert w_lens.min() > 0 and np.abs(w_mel).max() > 1e-2
        np.testing.assert_array_equal(lens.numpy(), w_lens)
        _close(spk, w_spk, MOD_ATOL, "AdaSpeech speaker vector")
        _close(mel, w_mel, MEL_ATOL, "AdaSpeech inference")
        mel, lens, _ = ada_port.inference(*infer, spk_embs=spk)
        np.testing.assert_array_equal(lens.numpy(), want["ada_inference_free"][1])
        _close(mel, want["ada_inference_free"][0], MEL_ATOL, "AdaSpeech inference, predicted")

    # serving: TwoStageTTS(ADASPEECH) and Text2Wav(adaspeech) on the JAX
    # Text2Wav's waveform (64 zero reference frames, speaker 0, accent 0)
    w_wav, w_lens = want["t2w"]
    assert np.abs(w_wav).max() > 1e-3 and w_lens.min() > 0
    waves = tts(TEXTS)
    for i, wav in enumerate(waves):
        assert wav.shape == (w_lens[i],)
        np.testing.assert_allclose(wav, w_wav[i, : w_lens[i]], atol=MEL_ATOL)
    t2w = Text2Wav(N_SYMBOLS, N_MELS, conf, FS2_STATS, n_speakers=2, version="adaspeech")
    t2w.load_state_dict(text2wav_from_jax(jax.tree_util.tree_map(np.asarray, t2w_vars), conf,
                                          "adaspeech"), strict=True)
    wav, wav_lens = t2w.eval().inference(
        torch.zeros(2, dtype=torch.long), t(tts_ids, torch.long), t(tts_lens, torch.long),
        SERVE_FRAMES, feats=torch.zeros(2, 64, N_MELS), aids=torch.zeros(2, dtype=torch.long))
    np.testing.assert_array_equal(wav_lens.numpy(), w_lens)
    np.testing.assert_allclose(wav.numpy(), w_wav, atol=MEL_ATOL)
    _check_server(tts, waves)


def _check_server(tts, waves):
    from viet_tts_torch.infer.server import serve

    httpd = serve(tts, port=0, model_name="ADASPEECH")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            assert json.load(r) == {"status": "ok", "model": "ADASPEECH"}
        body = json.dumps({"text": TEXTS[0]}).encode()
        with urllib.request.urlopen(f"{base}/synthesize", data=body, timeout=60) as r:
            assert r.status == 200 and r.read(4) == b"RIFF"
        with urllib.request.urlopen(f"{base}/synthesize_stream", data=body, timeout=60) as r:
            assert r.status == 200 and len(r.read()) == 2 * waves[0].size
    finally:
        httpd.shutdown()
        httpd.server_close()


def _reference_token_avg(durs, feats, text_lens, feats_lens):
    """The reference's ``frame2phoneme`` loop in numpy, in place, one
    scalar a token over (frames, channels), an empty slice 0."""
    out = np.zeros(durs.shape, np.float64)
    for b in range(durs.shape[0]):
        n_frames = feats.shape[1] if feats_lens is None else feats_lens[b]
        mel = feats[b, :n_frames].astype(np.float64).copy()
        ds = durs[b].astype(np.int64) * (np.arange(durs.shape[1]) < text_lens[b])
        start = 0
        for i, d in enumerate(ds):
            span = mel[start: start + d]
            out[b, i] = span.mean() if d > 0 and span.size else 0.0
            if i < mel.shape[0]:
                mel[i] = out[b, i]
            start += d
    return out


def test_token_avg_mels_keeps_the_reference_quirks():
    """``token_avg_mels`` against the reference's in-place loop written out
    in numpy (1e-6): after the zero-duration tokens a span reads earlier
    tokens' scalars, and the overrunning span gives 0."""
    d = _inputs()
    durs, feats = d["durs"], d["feats"]
    got = token_avg_mels(t(durs), t(feats), t(d["text_lengths"], torch.long),
                         t(d["feats_lengths"], torch.long))
    want = _reference_token_avg(durs, feats, d["text_lengths"], d["feats_lengths"])
    assert got.shape == (B, T_TEXT, N_MELS)
    assert torch.equal(got, got[..., :1].expand_as(got))  # one scalar a token
    np.testing.assert_allclose(got[..., 0].numpy(), want, atol=OPS_ATOL)
    # in place: token 2 of row 0 spans frames 0-1, which tokens 0 and 1
    # (duration 0) overwrote with 0, and token 4 spans frames 3-5, frame 3
    # overwritten by token 3; the plain means differ
    assert want[0, 2] == 0.0 and abs(feats[0, 0:2].mean()) > 1e-3
    assert abs(want[0, 4] - feats[0, 3:6].mean()) > 1e-3
    # row 1: token 4 spans frames 14-19 of 18 (the valid 4 averaged), token 5
    # frames 20-28: empty, 0
    np.testing.assert_allclose(want[1, 4], feats[1, 14:18].mean(), atol=OPS_ATOL)
    assert want[1, 5] == 0.0 and got[1, 5, 0] == 0.0


def test_cln_starts_as_layernorm_and_seeded_init_keeps_it():
    """A fresh CLN (and one re-initialised by ``seeded_init_``) is a plain
    LayerNorm with eps 1e-5, whatever the speaker vector."""
    cln = seeded_init_(ConditionalLayerNorm(8, 6), torch.Generator().manual_seed(0))
    x, spk = torch.randn(2, 5, 8), torch.randn(2, 6)
    torch.testing.assert_close(cln(x, spk), torch.nn.functional.layer_norm(x, (8,), eps=1e-5))
    model = seeded_init_(AdaSpeech(N_SYMBOLS, N_MELS, ada_hparams(), FS2_STATS, 2),
                         torch.Generator().manual_seed(0))
    cln_params = {n: p for n, p in model.named_parameters() if ".W_" in n}
    assert len(cln_params) == 2 * 2 * (2 + 2) + 4  # 4 CLNs a block, 2 blocks, the final one
    for name, p in cln_params.items():
        assert torch.equal(p, torch.ones_like(p) if name.endswith("W_scale.bias")
                           else torch.zeros_like(p)), name


@pytest.mark.parametrize("family", ["fastspeech2", "adaspeech"])
def test_converter_round_trips(family):
    """port state_dict -> reference names -> the JAX importer -> the
    port's converter gives every tensor back bit for bit (the BatchNorm
    statistics included), and the result loads strictly. The CVAE GRU's
    hidden r / z biases are folded into its input biases first, as the
    importer folds them (flax's GRUCell has none)."""
    if family == "fastspeech2":
        hp = fs2_transformer_hparams()
        model, importer, back = port_fs2(hp), import_fastspeech2, fastspeech2_from_jax
        cls = FastSpeech2
    else:
        hp = ada_hparams()
        model, importer, back = port_adaspeech(hp), import_adaspeech, adaspeech_from_jax
        cls = AdaSpeech
    gru = model.speaker_emb.encoder.gru
    with torch.no_grad():
        H = gru.hidden_size
        gru.bias_ih_l0[: 2 * H] += gru.bias_hh_l0[: 2 * H]
        gru.bias_hh_l0[: 2 * H] = 0.0
    variables = jax.tree_util.tree_map(np.asarray,
                                       importer(reference_state_dict(model.state_dict()), hp))
    sd = back(variables, hp)
    want = model.state_dict()
    assert set(sd) == set(want)
    assert any(".layer_stack.0.slf_attn.w_qs." in k for k in sd)
    for key, val in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(sd[key], val), key
    cls(N_SYMBOLS, N_MELS, hp, FS2_STATS, 2).load_state_dict(sd, strict=True)


def test_two_stage_tts_refuses_an_unknown_family_and_adaspeech_needs_its_block():
    with pytest.raises(NotImplementedError, match="transformer-type"):
        hp = ada_hparams()
        hp["building_block"]["block_type"] = "conformer"
        AdaSpeech(N_SYMBOLS, N_MELS, hp, FS2_STATS, 2)
    with pytest.raises(ValueError, match="unknown two-stage"):
        TwoStageTTS(".", ".", model_type="TACOTRON", device="cpu")


def test_save_checkpoint_conf_builds_adaspeech(tmp_path):
    """A checkpoint saved with ``config.json`` holding ``models.adaspeech``
    builds the AdaSpeech of that section on ``model_type="ADASPEECH"``."""
    hp = ada_hparams()
    save_checkpoint(str(tmp_path / "ac"), port_adaspeech(hp), _t2w_conf(), speakers=SPEAKERS,
                    stats=FS2_STATS)
    save_checkpoint(str(tmp_path / "voc"), port_hifigan(STEP_HIFI),
                    {"models": {"hifigan": STEP_HIFI}})
    tts = TwoStageTTS(str(tmp_path / "ac"), str(tmp_path / "voc"), model_type="adaspeech",
                      max_mel_frames=SERVE_FRAMES, device="cpu")
    assert isinstance(tts.acoustic, AdaSpeech) and not tts.acoustic.training
    assert len(tts.acoustic.encoder.layer_stack) == hp["encoder_layers"]
    (wav,) = tts(TEXTS[:1], reference_mel=np.zeros((20, N_MELS), np.float32))
    assert wav.dtype == np.float32 and np.isfinite(wav).all() and wav.size % 256 == 0
