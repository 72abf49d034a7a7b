"""Matcha-TTS (modules, model, converter, serving) against the JAX package,
on the CPU.

The port's seeded Matcha (``matcha_hparams``: ``tests/test_matcha.py``'s
tiny widths, the UNet narrower, every dropout 0; the constant-initialised
parameters drawn, see ``port_matcha``) goes to JAX through the JAX
package's ``import_matcha`` and comes back through
``convert.matcha_from_jax``. The UNet with conformer stages has no
reference names: its JAX variables are drawn from a seed (shapes from
``jax.eval_shape`` of its init) and come to the port through the
converter. The duration predictor's bias is raised so that the random
model predicts a few frames a token.

All the JAX work is jitted and computed once a session
(``session_cached``), in one test item
(``test_modules_model_and_serving_match_jax``); everything here runs in
eval mode (the training forward, losses and gradients are in
``test_torch_matcha_trainer.py``, whose jitted JAX step computes that
forward). ``TwoStageTTS`` (10 Euler steps) is held against the JAX
model's own ``inference`` with its ``CFM.solve`` intercepted: the
intercepted call hands back the ODE's inputs, and the 10 Euler steps run
as the JAX ``solve`` runs them (zero start noise, x += dt * v(x, i dt)) on
the jitted JAX estimator, then the JAX vocoder. ``inference`` itself,
``solve`` included, is held at 2 steps. Tolerances: fp32 modules 1e-5; mels and
waveforms 1e-4; lengths exact.
"""

from __future__ import annotations

import json
import os
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viet_tts_tpu.models.matcha import decoder as jax_decoder
from viet_tts_tpu.models.matcha import layers as jax_layers
from viet_tts_tpu.models.matcha.model import CFM as JaxCFM
from viet_tts_tpu.train.torch_import import import_matcha
from viet_tts_torch import convert
from viet_tts_torch.config import default_audio
from viet_tts_torch.convert import matcha_from_jax, reference_state_dict, text2wav_from_jax
from viet_tts_torch.infer.api import TwoStageTTS, save_checkpoint
from viet_tts_torch.models.matcha import MatchaTTS, fix_len_compatibility
from viet_tts_torch.models.matcha.decoder import UNetDecoder, sinusoidal_time_embedding
from viet_tts_torch.models.matcha.layers import rope_rotate
from viet_tts_torch.models.text2wav import Text2Wav
from viet_tts_torch.nn.utils import seeded_init_

from tests.test_torch_gan_trainer import STEP_HIFI
from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    MATCHA_STATS,
    N_MELS,
    N_SYMBOLS,
    jax_hifigan,
    jax_matcha,
    matcha_hparams,
    one_torch_thread,
    port_hifigan,
    port_matcha,
    session_cached,
    t,
)

B, T_TEXT, T_MEL, T_REF = 2, 9, 32, 16  # T_MEL: the serving frames too
INFER_FRAMES = 40
SERVE_FRAMES = 32
TEXTS = ["Hôm nay trời đẹp quá!", "Chúng ta cùng nhau học tập và làm việc thật tốt."]
SPEAKERS = {"hn_spk": 0, "hcm_spk": 1}
DUR_BIAS = 1.2  # exp(1.2) - 1: ~2.3 frames a token
MOD_ATOL = 1e-5
MEL_ATOL = 1e-4


def _port_model():
    model = port_matcha(matcha_hparams())
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(DUR_BIAS)
    return model


def _inputs():
    """Seeded numpy inputs: a ragged batch, a reference mel, head-split
    and hidden activations, frame activations, flow times, a speaker
    vector."""
    rng = np.random.RandomState(0)
    text_lens = np.array([T_TEXT, T_TEXT - 3], np.int32)
    mel_lens = np.array([T_MEL, T_MEL - 8], np.int32)
    text = rng.randint(1, N_SYMBOLS, (B, T_TEXT)) * (np.arange(T_TEXT) < text_lens[:, None])
    return dict(
        text=text.astype(np.int32), text_lengths=text_lens,
        feats=rng.randn(B, T_MEL, N_MELS).astype(np.float32), feats_lengths=mel_lens,
        duration=rng.rand(B, T_MEL, T_TEXT).astype(np.float32),
        sids=np.array([0, 1], np.int32), aids=np.array([1, 0], np.int32),
        ref=rng.randn(B, T_REF, N_MELS).astype(np.float32),
        heads=rng.randn(B, 2, T_TEXT, 24).astype(np.float32),
        hidden=rng.randn(B, T_TEXT, 48).astype(np.float32),
        x=rng.randn(B, T_MEL, N_MELS).astype(np.float32),
        mu=rng.randn(B, T_MEL, N_MELS).astype(np.float32),
        frames=rng.randn(B, T_MEL, 16).astype(np.float32),
        time=np.array([0.3, 0.85], np.float32),
        spk=rng.randn(B, 16).astype(np.float32),
    )


def _unet_kwargs(hp):
    d = hp["decoder"]
    return dict(channels=tuple(d["channels"]), dropout=0.0,
                attention_head_dim=d["attention_head_dim"], n_blocks=d["n_blocks"],
                num_mid_blocks=d["num_mid_blocks"], num_heads=d["num_heads"])


def _drawn_params(shapes, seed: int):
    """numpy leaves of ``shapes`` (an eval_shape params tree), drawn by
    leaf name: kernels uniform in +-1/sqrt(fan_in), norm scales near 1,
    biases and offsets near 0, the position table N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name in ("kernel",) or name.startswith("up_kernel"):
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "rel_pos_emb":
            return (0.02 * rng.randn(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _conformer_unet(hp):
    """(JAX conformer UNetDecoder, its drawn params, the port's on them)."""
    jm = jax_decoder.UNetDecoder(out_channels=N_MELS, down_block_type="conformer",
                                 mid_block_type="conformer", up_block_type="conformer",
                                 **_unet_kwargs(hp))
    d = _inputs()
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), d["x"], np.ones((B, T_MEL, 1), np.float32),
                        d["mu"], d["time"], d["spk"]))["params"]
    params = _drawn_params(shapes, seed=3)
    sd = {}
    convert._unet_decoder(sd, "unet", params)
    port = UNetDecoder(2 * N_MELS + 16, N_MELS, down_block_type="conformer",
                       mid_block_type="conformer", up_block_type="conformer",
                       **_unet_kwargs(hp))
    port.load_state_dict({k[len("unet."):]: v for k, v in sd.items()}, strict=True)
    return jm, params, port.eval()


def _capture(next_fun, args, kwargs, context):
    """Hand back ``CFM.solve``'s inputs (mu, mask, speaker vector)
    instead of solving."""
    if isinstance(context.module, JaxCFM) and context.method_name == "solve":
        mu, mask, _, _, spks = args
        context.module.sow("intermediates", "solve_in", (mu, mask, spks))
        return jnp.zeros_like(mu)
    return next_fun(*args, **kwargs)


def _jax_reference(tts_in):
    """Every JAX output this file holds the port against (numpy)."""
    hp = matcha_hparams()
    jm, mv = jax_matcha(_port_model(), hp)
    cj, cparams, _ = _conformer_unet(hp)
    hifi_jm, hifi_params = jax_hifigan(port_hifigan(STEP_HIFI), STEP_HIFI)
    te = hp["text_encoder"]
    tj = jax_decoder.UNetDecoder(out_channels=N_MELS, **_unet_kwargs(hp))

    def modules(mv, cparams, d):
        mp, ep = mv["params"], mv["params"]["decoder"]["estimator"]
        valid = jnp.arange(T_TEXT)[None] < d["text_lengths"][:, None]
        mel_mask = (jnp.arange(T_MEL)[None] < d["feats_lengths"][:, None])[..., None] * 1.0
        out = {"rope": jax_layers.rope_rotate(d["heads"], 12)}
        enc = te["encoder"]
        out["rope_encoder"] = jax_layers.RoPEEncoder(
            48, enc["filter_channels"], enc["n_heads"], enc["n_layers"], enc["kernel_size"],
            0.0).apply({"params": mp["encoder"]["encoder"]}, d["hidden"],
                       valid[..., None] * 1.0)
        out["text_encoder"] = jax_layers.TextEncoder(
            N_SYMBOLS, N_MELS, 2, 16, te).apply({"params": mp["encoder"]}, d["text"],
                                                d["text_lengths"], d["spk"])
        in_ch = 2 * N_MELS + 16
        temb = jax_decoder.sinusoidal_time_embedding(d["time"], in_ch)
        out["time_mlp"] = jax_decoder.TimestepEmbedding(64).apply(
            {"params": ep["time_mlp"]}, temb)
        h = jnp.concatenate([d["x"], d["mu"], jnp.broadcast_to(
            d["spk"][:, None], (B, T_MEL, 16))], axis=-1)
        out["resnet"] = jax_decoder.ResnetBlock1D(16).apply(
            {"params": ep["down_res_0"]}, h, mel_mask, out["time_mlp"])
        out["transformer_block"] = jax_decoder.BasicTransformerBlock(16, 2, 8).apply(
            {"params": ep["down_tf_0_0"]}, d["frames"], mel_mask[..., 0] > 0)
        out["conformer_block"] = jax_decoder.ConformerBlock(16, 2, 8).apply(
            {"params": cparams["down_tf_0_0"]}, d["frames"], mel_mask[..., 0] > 0)
        out["unet_conformer"] = cj.apply({"params": cparams}, d["x"], mel_mask, d["mu"],
                                         d["time"], d["spk"])
        infer = (d["sids"], d["text"], d["text_lengths"], INFER_FRAMES)
        out["inference"] = jm.apply(mv, *infer, feats=d["ref"], aids=d["aids"], n_timesteps=2,
                                    method=jm.inference, rngs={"noise": jax.random.PRNGKey(0)})
        return out

    def serve_prior(mv, ids, lens):
        n = ids.shape[0]
        with fnn.intercept_methods(_capture):
            (_, mel_lens, _), mut = jm.apply(
                mv, jnp.zeros(n, jnp.int32), ids, lens, SERVE_FRAMES,
                feats=jnp.zeros((n, 64, N_MELS)), aids=jnp.zeros(n, jnp.int32),
                method=jm.inference, mutable=["intermediates"])
        return mel_lens, mut["intermediates"]["decoder"]["solve_in"][0]

    def estimator(ep, x, mask, mu, t_, spks):
        return tj.apply({"params": ep}, x, mask, mu, t_, spks)

    d = {k: jnp.asarray(v) for k, v in _inputs().items()}
    out = jax.jit(modules)(mv, cparams, d)
    # the whole UNet (the jitted estimator of the serving loop below, at
    # the same shapes)
    est = jax.jit(estimator)
    ep = mv["params"]["decoder"]["estimator"]
    mel_mask = (jnp.arange(T_MEL)[None] < d["feats_lengths"][:, None])[..., None] * 1.0
    out["unet"] = est(ep, d["x"], mel_mask, d["mu"], d["time"], d["spk"])
    # TwoStageTTS's 10 Euler steps, as CFM.solve runs them
    mel_lens, (mu, mask, spks) = jax.jit(serve_prior)(mv, *(jnp.asarray(a) for a in tts_in))
    x, dt = jnp.zeros_like(mu), 1.0 / 10
    for i in range(10):
        x = x + dt * est(ep, x, mask, mu, jnp.full((mu.shape[0],), i * dt, mu.dtype), spks)
    mel = x * MATCHA_STATS["mel_std"] + MATCHA_STATS["mel_mean"]
    wav = jax.jit(lambda p, m: hifi_jm.apply({"params": p}, m)[..., 0])(hifi_params, mel)
    out["serve"] = (mel, mel_lens, wav)
    out = jax.tree_util.tree_map(lambda x: None if x is None else np.asarray(x), out,
                                 is_leaf=lambda x: x is None)
    return {"out": out, "variables": mv, "hifi": jax.tree_util.tree_map(np.asarray,
                                                                       hifi_params)}


def _close(got, want, atol, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.shape(want), name
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol, err_msg=name)


def _conf():
    return {"audio": default_audio(),
            "models": {"matcha": matcha_hparams(), "hifigan": dict(STEP_HIFI)}}


def test_modules_model_and_serving_match_jax(tmp_path, tmp_path_factory):
    """Every module of the slice and its entry points on the JAX
    package's outputs: ``rope_rotate``, the RoPE encoder on a ragged batch,
    ``TextEncoder``, the time embedding, the ResNet, transformer and
    conformer blocks, the whole UNet with transformer and with conformer
    stages (1e-5); ``inference`` with a reference mel (2 Euler steps; 1e-4,
    lengths exact), and with its speaker vector given back (the same); ``TwoStageTTS(model_type=
    "MATCHA")`` and ``Text2Wav(version="matcha").inference`` against the
    JAX model's 10-step mel and the JAX vocoder's waveform (1e-4), and the
    server's routes."""
    hp, conf = matcha_hparams(), _conf()
    model = _port_model()
    hifi = port_hifigan(STEP_HIFI)
    ac_dir, voc_dir = str(tmp_path / "acoustic"), str(tmp_path / "vocoder")
    save_checkpoint(ac_dir, model, conf, speakers=SPEAKERS, stats=MATCHA_STATS)
    save_checkpoint(voc_dir, hifi, {"models": {"hifigan": dict(STEP_HIFI)}})
    tts = TwoStageTTS(ac_dir, voc_dir, model_type="MATCHA", max_mel_frames=SERVE_FRAMES,
                      device="cpu")
    assert isinstance(tts.acoustic, MatchaTTS) and not tts.acoustic.training
    tts_ids, tts_lens, _ = tts.encode_texts(TEXTS)
    ref = session_cached(tmp_path_factory, "matcha_modules",
                         lambda: _jax_reference((tts_ids, tts_lens)))
    want, variables = ref["out"], ref["variables"]
    # the port model on the weights carried back
    model = MatchaTTS(N_SYMBOLS, N_MELS, hp, MATCHA_STATS, 2)
    model.load_state_dict(matcha_from_jax(variables, hp), strict=True)
    model.eval()
    _, _, conformer = _conformer_unet(hp)

    d = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in _inputs().items()}
    valid = torch.arange(T_TEXT)[None] < d["text_lengths"][:, None]
    mel_mask = (torch.arange(T_MEL)[None] < d["feats_lengths"][:, None])[..., None].float()
    est = model.decoder.estimator
    with torch.no_grad():
        _close(rope_rotate(d["heads"], 12), want["rope"], MOD_ATOL, "rope_rotate")
        _close(model.encoder.encoder(d["hidden"], valid[..., None].float()),
               want["rope_encoder"], MOD_ATOL, "RoPE encoder")
        for got, w, name in zip(model.encoder(d["text"], d["text_lengths"], d["spk"]),
                                want["text_encoder"], ("mu", "embedding", "valid")):
            _close(got, w, MOD_ATOL, f"TextEncoder {name}")
        temb = est.time_mlp(sinusoidal_time_embedding(d["time"], 2 * N_MELS + 16))
        _close(temb, want["time_mlp"], MOD_ATOL, "time embedding")
        h = torch.cat([d["x"], d["mu"], d["spk"][:, None].expand(-1, T_MEL, -1)], dim=-1)
        res = est.down_blocks[0][0](h.transpose(1, 2), mel_mask.transpose(1, 2), temb)
        _close(res.transpose(1, 2), want["resnet"], MOD_ATOL, "ResnetBlock1D")
        for block, key in ((est.down_blocks[0][1][0], "transformer_block"),
                           (conformer.down_blocks[0][1][0], "conformer_block")):
            _close(block(d["frames"], mel_mask[..., 0] > 0), want[key], MOD_ATOL, key)
        args = (d["x"], mel_mask, d["mu"], d["time"], d["spk"])
        _close(est(*args), want["unet"], MOD_ATOL, "UNetDecoder")
        _close(conformer(*args), want["unet_conformer"], MOD_ATOL, "UNetDecoder (conformer)")

    # inference (2 Euler steps) with a reference mel's CVAE; the speaker
    # vector it returns, given back, gives the same mel
    infer = (d["sids"], d["text"], d["text_lengths"], INFER_FRAMES)
    with torch.no_grad():
        mel, lens, spk = model.inference(*infer, feats=d["ref"], aids=d["aids"], n_timesteps=2)
        w_mel, w_lens, w_spk = want["inference"]
        assert w_lens.min() > 0 and np.abs(w_mel).max() > 1e-2
        np.testing.assert_array_equal(lens.numpy(), w_lens)
        _close(spk, w_spk, MOD_ATOL, "inference speaker vector")
        _close(mel, w_mel, MEL_ATOL, "inference")
        again, lens_again, _ = model.inference(*infer, spk_embs=spk, n_timesteps=2)
        assert torch.equal(again, mel) and torch.equal(lens_again, lens)
    assert fix_len_compatibility(INFER_FRAMES - 3) == INFER_FRAMES

    # serving: TwoStageTTS(MATCHA) and Text2Wav(matcha) on the JAX mel and
    # waveform (10 Euler steps, 64 zero reference frames, speaker 0, accent 0)
    w_mel, w_lens, w_wav = want["serve"]
    assert w_lens.min() > 0 and np.abs(w_wav).max() > 1e-3
    mel, lens = tts._mel(TEXTS, 0, 0, None, 1.0, 1.0, 1.0)
    np.testing.assert_array_equal(lens.numpy(), w_lens)
    _close(mel, w_mel, MEL_ATOL, "TwoStageTTS mel")
    waves = tts(TEXTS)
    for i, wav in enumerate(waves):
        assert wav.shape == (w_lens[i] * 256,)
        np.testing.assert_allclose(wav, w_wav[i, : w_lens[i] * 256], atol=MEL_ATOL)
    t2w_vars = {"params": {"text2mel": variables["params"], "mel2wav": ref["hifi"]},
                "batch_stats": {"text2mel": variables["batch_stats"]}}
    t2w = Text2Wav(N_SYMBOLS, N_MELS, conf, MATCHA_STATS, n_speakers=2, version="matcha")
    t2w.load_state_dict(text2wav_from_jax(t2w_vars, conf, "matcha"), strict=True)
    wav, wav_lens = t2w.eval().inference(
        torch.zeros(2, dtype=torch.long), t(tts_ids, torch.long), t(tts_lens, torch.long),
        SERVE_FRAMES, feats=torch.zeros(2, 64, N_MELS), aids=torch.zeros(2, dtype=torch.long))
    np.testing.assert_array_equal(wav_lens.numpy(), w_lens * 256)
    np.testing.assert_allclose(wav.numpy(), w_wav, atol=MEL_ATOL)
    _check_server(tts, waves)


def _check_server(tts, waves):
    from viet_tts_torch.infer.server import serve

    httpd = serve(tts, port=0, model_name="MATCHA")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            assert json.load(r) == {"status": "ok", "model": "MATCHA"}
        body = json.dumps({"text": TEXTS[0]}).encode()
        with urllib.request.urlopen(f"{base}/synthesize", data=body, timeout=60) as r:
            assert r.status == 200 and r.read(4) == b"RIFF"
        with urllib.request.urlopen(f"{base}/synthesize_stream", data=body, timeout=60) as r:
            assert r.status == 200 and len(r.read()) == 2 * waves[0].size
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_converter_round_trips():
    """port state_dict -> reference names -> ``import_matcha`` ->
    ``matcha_from_jax`` gives every tensor back bit for bit (the CVAE's
    BatchNorm statistics included, the ConvTranspose1d kernels through the
    importer's flip and back), and the result loads strictly."""
    hp = matcha_hparams()
    model = port_matcha(hp)
    variables = jax.tree_util.tree_map(np.asarray, import_matcha(
        reference_state_dict(model.state_dict()), hp))
    sd = matcha_from_jax(variables, hp)
    want = model.state_dict()
    assert set(sd) == set(want)
    assert "decoder.estimator.up_blocks.0.2.conv.weight" in sd
    assert "decoder.estimator.down_blocks.0.1.0.ff.net.0.alpha" in sd
    for key, val in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(sd[key], val), key
    MatchaTTS(N_SYMBOLS, N_MELS, hp, MATCHA_STATS, 2).load_state_dict(sd, strict=True)


def test_seeded_init_and_the_stats_refusal(tmp_path):
    """A seeded Matcha starts as the JAX module does where the init is a
    constant (the prenet's projection 0, so the prenet is the identity on
    the valid frames; snakebeta's log-scale alpha and beta 0; the channel
    norms' gamma 1, beta 0); the speaker vector concatenated for more than
    one speaker. A Matcha without the dataset's mel statistics is refused,
    and so is ``TwoStageTTS(model_type="MATCHA")`` on a checkpoint with no
    ``stats.json``: no default is invented."""
    hp = matcha_hparams()
    model = seeded_init_(MatchaTTS(N_SYMBOLS, N_MELS, hp, MATCHA_STATS, 2),
                         torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    assert not params["encoder.prenet.proj.weight"].any()
    assert not any(p.any() for n, p in params.items() if n.endswith((".alpha", ".beta")))
    assert all(torch.equal(p, torch.ones_like(p)) for n, p in params.items()
               if n.endswith(".gamma"))
    x = torch.randn(2, 5, hp["text_encoder"]["hidden_dim"])
    mask = torch.ones(2, 5, 1)
    mask[1, 3:] = 0
    torch.testing.assert_close(model.encoder.prenet(x, mask), x * mask)
    assert model.encoder.proj_m.in_channels == 32 + 16
    one = MatchaTTS(N_SYMBOLS, N_MELS, hp, MATCHA_STATS, 1)
    assert one.encoder.proj_m.in_channels == 32

    with pytest.raises(ValueError, match="mel statistics"):
        MatchaTTS(N_SYMBOLS, N_MELS, hp, {"pitch": {}, "energy": {}}, 2)
    ac, voc = str(tmp_path / "ac"), str(tmp_path / "voc")
    save_checkpoint(ac, model, _conf(), speakers=SPEAKERS)
    save_checkpoint(voc, port_hifigan(STEP_HIFI), {"models": {"hifigan": dict(STEP_HIFI)}})
    assert not os.path.exists(os.path.join(ac, "stats.json"))
    with pytest.raises(ValueError, match="mel_mean"):
        TwoStageTTS(ac, voc, model_type="MATCHA", device="cpu")
