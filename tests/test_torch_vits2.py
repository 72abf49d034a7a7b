"""VITS2 in the port against the JAX package on the CPU: the splines, the
relative-position attention and encoder, the WaveNet and DDSConv stacks,
every transformer flow type, the stochastic duration predictor, the
monotonic alignment and hard path, ``inference`` with ``OneStageTTS``,
``stream_wav`` and the server's ``--model_type VITS2``, the discriminators
and losses, the converters and the config sections.

Module checks build the JAX module with JAX's init (the zero-initialised
flow projections and affine flows drawn anew, so that each flow is more
than the identity) and load its params into the port module through
``convert.py``; the whole model goes the other way, from the port's seeded
weights (``torch_parity.port_vits2``) through ``import_vits2``. The JAX
normal draws (the SDP's posterior and reverse noise) are recorded
(``JaxNormalDraws``) and fed to the port. Tolerances: 1e-5 for the splines,
attention, stacks, flows and the SDP; waveforms 1e-4; alignment paths and
lengths exact. No kernel of the port runs in VITS2.
"""

from __future__ import annotations

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viet_tts_tpu import config as jax_config
from viet_tts_tpu.models.vits2 import attentions as jattn
from viet_tts_tpu.models.vits2 import discriminator as jdisc
from viet_tts_tpu.models.vits2 import layers as jlayers
from viet_tts_tpu.models.vits2 import loss as jloss
from viet_tts_tpu.models.vits2 import model as jmodel
from viet_tts_tpu.models.vits2 import sublayers as jsub
from viet_tts_tpu.models.vits2 import transforms as jtr
from viet_tts_tpu.ops import maximum_path as jax_maximum_path
from viet_tts_tpu.train.torch_import import import_vits2
from viet_tts_torch import config as port_config
from viet_tts_torch import convert
from viet_tts_torch.infer.api import OneStageTTS, save_checkpoint
from viet_tts_torch.models.vits2 import attentions, discriminator, layers, loss, sublayers
from viet_tts_torch.models.vits2 import transforms
from viet_tts_torch.models.vits2.model import VITS2, generate_path
from viet_tts_torch.ops.mas import maximum_path

from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    N_SYMBOLS,
    VITS2_LOGW_SHIFT,
    JaxNormalDraws,
    jax_vits2,
    one_torch_thread,
    port_vits2,
    random_flax_params,
    session_cached,
    t,
    vits2_hparams,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
WAV_ATOL = 1e-4
FLOW_TYPES = ("pre_conv", "pre_conv2", "fft", "mono_layer_inter_residual",
              "mono_layer_post_residual", "none")
TEXTS = ["Hôm nay trời đẹp quá!", "Tôi yêu tiếng Việt."]
SERVE_FRAMES = 96


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=atol, err_msg=what)


def _load(port_module, params):
    """Flax params of a VITS2 submodule -> ``port_module`` (strict)."""
    sd = {}
    convert._vits_module(sd, "m", params)
    port_module.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return port_module.eval()


def _mask(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def test_splines_match_jax():
    """Forward and inverse against the JAX transforms (1e-5) on inputs
    inside the bins, exactly on interior knots, at +-tail_bound and outside
    it (the identity tails, log-determinant 0); round trips to 1e-4 (the
    JAX test's bound); ``rational_quadratic_spline`` on [0, 1] directly."""
    rng = np.random.RandomState(0)
    shape = (2, 6, 3)
    uw = (rng.randn(*shape, 10) * 0.5).astype(np.float32)
    uh = (rng.randn(*shape, 10) * 0.5).astype(np.float32)
    ud = (rng.randn(*shape, 9) * 0.5).astype(np.float32)
    x = (rng.randn(*shape) * 2.5).astype(np.float32)
    x[0, 0] = [5.0, -5.0, 7.5]  # the tail bounds and a tail
    x[1, 0] = [-9.0, 6.0, -5.5]
    # on an interior knot of the forward's bins (the softmax widths' 4th edge)
    w = np.exp(uw[0, 1]) / np.exp(uw[0, 1]).sum(-1, keepdims=True)
    w = 1e-3 + (1 - 1e-3 * 10) * w
    x[0, 1] = (10.0 * np.cumsum(w, -1) - 5.0)[:, 3]  # on the 4th knot of each channel
    args = (uw, uh, ud)
    for inverse in (False, True):
        want_y, want_ld = jtr.unconstrained_rational_quadratic_spline(
            jnp.asarray(x), *map(jnp.asarray, args), inverse=inverse, tail_bound=5.0)
        y, ld = transforms.unconstrained_rational_quadratic_spline(
            t(x), *map(t, args), inverse=inverse, tail_bound=5.0)
        _close(y, want_y, what=f"inverse={inverse} y")
        _close(ld, want_ld, what=f"inverse={inverse} logdet")
        outside = np.abs(x) > 5.0
        assert np.array_equal(y.numpy()[outside], x[outside])
        assert np.all(ld.numpy()[outside] == 0.0)
    y, ld = transforms.unconstrained_rational_quadratic_spline(t(x), *map(t, args),
                                                              tail_bound=5.0)
    back, ld_inv = transforms.unconstrained_rational_quadratic_spline(
        y, *map(t, args), inverse=True, tail_bound=5.0)
    _close(back, x, atol=1e-4, what="round trip")
    _close(ld + ld_inv, np.zeros_like(x), atol=1e-4, what="round-trip logdet")
    u = rng.rand(*shape).astype(np.float32)
    ud11 = (rng.randn(*shape, 11) * 0.5).astype(np.float32)
    for inverse in (False, True):
        want = jtr.rational_quadratic_spline(jnp.asarray(u), jnp.asarray(uw), jnp.asarray(uh),
                                             jnp.asarray(ud11), inverse=inverse)
        got = transforms.rational_quadratic_spline(t(u), t(uw), t(uh), t(ud11), inverse=inverse)
        _close(got[0], want[0], what=f"[0, 1] inverse={inverse}")
        _close(got[1], want[1], what=f"[0, 1] inverse={inverse} logdet")


def test_rel_pos_attention_and_encoder_match_jax():
    """``RelPosMultiHeadAttention`` (window 4: the table sliced at T = 3 < 5,
    whole at T = 5, padded at T = 9 > 5) with a ragged mask and the
    shuffles, then ``VitsEncoder`` (3 layers, the speaker vector at layer 2)
    at T = 9, against the JAX modules (1e-5). The lengths loop inside one
    item (the suite's schedule follows its item count; see ROADMAP.md's
    time budget)."""
    for T in (3, 5, 9):
        _attention_case(T, with_encoder=T == 9)


def _attention_case(T, with_encoder):
    rng = np.random.RandomState(T)
    C, B = 16, 2
    x = rng.randn(B, T, C).astype(np.float32)
    lens = [T, max(T - 2, 1)]
    m = _mask(lens, T)
    amask = m[:, :, 0][:, :, None] * m[:, :, 0][:, None, :]
    rel = rng.randn(B, 2, T, 2 * T - 1).astype(np.float32)
    _close(attentions._relative_to_absolute(t(rel)), jattn._relative_to_absolute(rel))
    ab = rng.randn(B, 2, T, T).astype(np.float32)
    _close(attentions._absolute_to_relative(t(ab)), jattn._absolute_to_relative(ab))

    jmod = jattn.RelPosMultiHeadAttention(C, C, 2, window_size=4)
    p = random_flax_params(jmod, x, x, amask)
    mod = attentions.RelPosMultiHeadAttention(C, C, 2, window_size=4)
    sd = {}
    convert._vits_attention(sd, "a", p)
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    _close(mod.eval()(t(x), t(x), t(amask)), jmod.apply({"params": p}, x, x, amask),
           what=f"attention T={T}")
    if not with_encoder:
        return

    g = rng.randn(B, 4).astype(np.float32)
    jenc = jattn.VitsEncoder(C, 32, 2, 3, gin_channels=4)
    p = random_flax_params(jenc, x * m, m, g=g)
    enc = attentions.VitsEncoder(C, 32, 2, 3, gin_channels=4)
    sd = {}
    convert._vits_encoder(sd, "e", p)
    enc.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    _close(enc.eval()(t(x * m), t(m), t(g)), jenc.apply({"params": p}, x * m, m, g=g),
           what=f"encoder T={T}")


def test_wn_and_ddsconv_match_jax():
    """``WN`` (3 gated layers, dilation 2, the speaker vector through
    ``cond_layer``) and ``DDSConv`` (3 layers, conditioning added) against
    the JAX modules (1e-5), with a ragged mask."""
    rng = np.random.RandomState(1)
    B, T, H = 2, 11, 16
    x = rng.randn(B, T, H).astype(np.float32)
    m = _mask([T, 7], T)
    g = rng.randn(B, 4).astype(np.float32)
    jwn = jsub.WN(H, 5, 2, 3, gin_channels=4)
    p = random_flax_params(jwn, x, m, g)
    wn = sublayers.WN(H, 5, 2, 3, gin_channels=4)
    sd = {}
    convert._wn_stack(sd, "w", p)
    wn.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    _close(wn.eval()(t(x), t(m), t(g)), jwn.apply({"params": p}, x, m, g), what="WN")

    gc = rng.randn(B, T, H).astype(np.float32)
    jdds = jsub.DDSConv(H, 3, 3)
    p = random_flax_params(jdds, x, m, g=gc)
    dds = sublayers.DDSConv(H, 3, 3)
    sd = {}
    convert._dds_conv(sd, "d", p)
    dds.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    _close(dds.eval()(t(x), t(m), t(gc)), jdds.apply({"params": p}, x, m, g=gc),
           what="DDSConv")


def test_flow_blocks_match_jax():
    """The coupling block of each ``transformer_flow_type`` (``pre_conv``,
    ``pre_conv2``, ``fft``, both ``mono_layer`` types, ``none``; 8 channels,
    hidden 16, two WN layers, one flow, speaker conditioning, a ragged
    mask): the coupling layer's output and log-determinant forward, the
    block forward and reverse (1e-5), and the port's round trip (1e-4; none for
    ``mono_layer_post_residual``, whose reference reverse is not the exact
    inverse). The types loop inside one item."""
    for flow_type in FLOW_TYPES:
        _flow_case(flow_type)


def _flow_case(flow_type):
    rng = np.random.RandomState(2)
    B, T = 2, 12
    x = rng.randn(B, T, 8).astype(np.float32)
    m = _mask([T, 9], T)
    x = x * m
    g = rng.randn(B, 4).astype(np.float32)
    kw = dict(channels=8, hidden_channels=16, kernel_size=5, dilation_rate=1, n_layers=2,
              n_flows=1, gin_channels=4, use_transformer_flows=flow_type != "none",
              transformer_flow_type=flow_type if flow_type != "none" else "pre_conv")
    jblock = jlayers.ResidualCouplingTransformersBlock(**kw)
    p = random_flax_params(jblock, x, m, g=g, train=False, seed=2)
    block = _load(layers.ResidualCouplingTransformersBlock(**kw), p)
    z = block(t(x), t(m), t(g))
    want_z = jblock.apply({"params": p}, x, m, g=g, train=False)
    assert np.abs(np.asarray(want_z) - x).max() > 1e-3, flow_type  # more than the identity
    _close(z, want_z, what=f"{flow_type} block forward")
    _close(block(z, t(m), t(g), reverse=True),
           jblock.apply({"params": p}, np.asarray(want_z), m, g=g, reverse=True, train=False),
           what=f"{flow_type} block reverse")
    # the coupling layer alone, with its log-determinant (the Flip after it
    # has no parameters and is covered by the block)
    y, ld = block.flows[0](t(x), t(m), g=t(g))
    wy, wld = jblock.apply({"params": p}, x, m,
                           method=lambda mod, x, m: mod.flows[0](x, m, g=g))
    _close(y, wy, what=f"{flow_type} coupling layer")
    _close(ld, wld, what=f"{flow_type} coupling layer logdet")
    if flow_type != "mono_layer_post_residual":
        _close(block(z, t(m), t(g), reverse=True), x, atol=1e-4,
               what=f"{flow_type} round trip")


def test_sdp_mas_and_path_match_jax():
    """The stochastic duration predictor (2 flows, speaker conditioning, a
    ragged mask): the NLL + log q with JAX's posterior noise and the
    reverse at noise scale 0.8 with JAX's noise (1e-5); the affine flow's
    and ``LogFlow``'s reverse; ``maximum_path`` (the VITS layout) and
    ``generate_path`` exactly."""
    rng = np.random.RandomState(3)
    B, T, H = 2, 7, 16
    x = rng.randn(B, T, H).astype(np.float32)
    m = _mask([T, 5], T)
    w = (rng.randint(1, 6, (B, T, 1)) * m).astype(np.float32)
    g = rng.randn(B, 4).astype(np.float32)
    jsdp = jlayers.StochasticDurationPredictor(H, n_flows=2, gin_channels=4)
    p = random_flax_params(jsdp, x, m, w=w, g=g, train=False, seed=3,
                     rngs={"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)})
    sdp = _load(layers.StochasticDurationPredictor(H, n_flows=2, gin_channels=4), p)
    with JaxNormalDraws() as rec:
        want, e_q = jax.jit(lambda p: (jsdp.apply(
            {"params": p}, x, m, w=w, g=g, train=False, rngs={"noise": jax.random.PRNGKey(5)}),
            rec.draws[0]))(p)
    _close(sdp(t(x), t(m), t(w), g=t(g), e_q=t(e_q)), want, what="SDP NLL")
    with JaxNormalDraws() as rec:
        want, noise = jax.jit(lambda p: (jsdp.apply(
            {"params": p}, x, m, g=g, noise_scale=0.8, method=jsdp.reverse,
            rngs={"noise": jax.random.PRNGKey(6)}), rec.draws[0]))(p)
    _close(sdp.reverse(t(x), t(m), g=t(g), noise_scale=0.8, noise=t(noise)), want,
           what="SDP reverse")

    neg = rng.randn(B, 9, 23).astype(np.float32) * 3.0
    tl, ml = np.array([9, 6]), np.array([23, 15])
    assert np.array_equal(maximum_path(t(neg), t(tl), t(ml)).numpy(),
                          np.asarray(jax_maximum_path(neg, tl, ml)))
    dur = np.ceil(rng.rand(B, T) * 4).astype(np.float32) * m[..., 0]
    ym = _mask([20, 13], 24)
    assert np.array_equal(generate_path(t(dur), t(ym), t(m)).numpy(),
                          np.asarray(jmodel.generate_path(dur, ym, m)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port VITS2 (``TINY_HP``) saved as a checkpoint, ``OneStageTTS``
    on it, and the JAX ``inference`` of the same weights on the serving
    ids."""
    hp = vits2_hparams()
    model = port_vits2(hp)
    root = str(tmp_path_factory.mktemp("vits2_ckpt"))
    conf = {"audio": port_config.default_audio(), "models": {"vits2": hp}}
    save_checkpoint(root, model, conf, speakers={"a": 0, "b": 1})
    tts = OneStageTTS(root, model_type="VITS2", max_mel_frames=SERVE_FRAMES, device="cpu")
    ids, lens, _ = tts.encode_texts(TEXTS)
    sids = np.array([1, 1], np.int32)

    def jax_inference():
        jm, variables = jax_vits2(model, hp)
        synth = jax.jit(lambda v, sids, ids, lens: jm.apply(
            v, sids, ids, lens, SERVE_FRAMES, method=jm.inference,
            rngs={"noise": jax.random.PRNGKey(0)}))
        out = synth(variables, sids, ids.astype(np.int32), lens.astype(np.int32))
        return tuple(np.asarray(x) for x in out)

    # the two items of this fixture may run on two workers: one JAX compile
    wav, wav_lens = session_cached(tmp_path_factory, "vits2_served_inference", jax_inference)
    return dict(root=root, model=model, tts=tts, ids=ids, lens=lens, sids=sids, wav=wav,
                wav_lens=wav_lens)


def test_inference_matches_jax(served):
    """``VITS2.inference`` at 96 frames against the JAX ``inference`` of the
    same weights on the serving ids: waveform 1e-4, ``mel_lens`` exact. The
    durations are chosen away from integers: the SDP's last affine flow
    shifts every log-duration by 1.3 (``port_vits2``), and every valid w
    is held at least 1e-3 from an integer here, so that ``ceil`` cannot
    round differently on either side."""
    model, ids, lens = served["model"], t(served["ids"]).long(), t(served["lens"]).long()
    sids = t(served["sids"]).long()
    with torch.no_grad():
        g = model.emb_g(sids)
        x, _, _, x_mask = model.enc_p(ids, lens, g=g)
        w = (torch.exp(model.dp.reverse(x, x_mask, g=g, noise_scale=0.0)) * x_mask)[..., 0]
    valid = w[x_mask[..., 0] > 0]
    assert VITS2_LOGW_SHIFT < 0 and (valid - torch.round(valid)).abs().min() > 1e-3
    wav, wav_lens = model.inference(sids, ids, lens, SERVE_FRAMES)
    assert np.array_equal(wav_lens.numpy(), served["wav_lens"])
    assert 0 < served["wav_lens"].min() and served["wav_lens"].max() < SERVE_FRAMES * 256
    assert np.abs(served["wav"]).max() > 1e-2
    _close(wav, served["wav"], atol=WAV_ATOL, what="waveform")


def test_one_stage_tts_streaming_and_server(served, tmp_path):
    """``OneStageTTS(model_type="VITS2", device="cpu")``: the checkpoint's
    weights, the plain generator by default (``fused_vocoder=True`` raises
    as in the JAX package; JETS keeps K2's route by default), waveforms
    equal to the JAX inference cut at its lengths (1e-4), ``stream_wav``
    equal to the batched waveform past its first 16 frames, and the
    server's ``--model_type VITS2 -c`` (``build_backend``): ``/health``,
    ``/synthesize``, ``/synthesize_stream``."""
    from viet_tts_torch.config import default_audio
    from viet_tts_torch.infer.server import build_backend, serve

    from tests.torch_parity import SMALL_HP, port_jets

    tts, model = served["tts"], served["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(tts.model.state_dict()[k], v), k
    waves = tts(TEXTS, speaker="b")
    for i, wave in enumerate(waves):
        n = int(served["wav_lens"][i])
        assert wave.shape == (n,)
        _close(wave, served["wav"][i, :n], atol=WAV_ATOL, what=f"OneStageTTS {i}")
    streamed = np.concatenate(list(tts.stream_wav(TEXTS[0], speaker="b", chunk_frames=16)))
    assert streamed.shape == waves[0].shape
    edge = 16 * 256
    np.testing.assert_allclose(streamed[edge:], waves[0][edge:], atol=WAV_ATOL)
    with pytest.raises(ValueError, match="own decode stack"):
        OneStageTTS(served["root"], model_type="VITS2", fused_vocoder=True, device="cpu")
    jets_dir = str(tmp_path / "jets")
    save_checkpoint(jets_dir, port_jets(), {"audio": default_audio(),
                                            "models": {"jets": {"generator_params":
                                                                dict(SMALL_HP)}}})
    assert OneStageTTS(jets_dir, max_mel_frames=32, device="cpu").model.generator.fused_mrf

    backend, args = build_backend(["--model_type", "VITS2", "-c", served["root"], "--device", "cpu",
                                   "--max_mel_frames", str(SERVE_FRAMES)])
    assert isinstance(backend.model, VITS2) and args.model_type == "VITS2"
    httpd = serve(backend, port=0, model_name="VITS2")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            assert json.load(r) == {"status": "ok", "model": "VITS2"}
        body = json.dumps({"text": TEXTS[0], "speaker": "b"}).encode()
        with urllib.request.urlopen(f"{base}/synthesize", data=body, timeout=60) as r:
            assert r.status == 200 and r.read(4) == b"RIFF"
        with urllib.request.urlopen(f"{base}/synthesize_stream", data=body, timeout=60) as r:
            assert r.status == 200 and len(r.read()) == 2 * waves[0].size
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_discriminators_and_losses_match_jax():
    """The multi-period discriminator (scale + period 3, a length the period
    pads by reflection) and both duration discriminator variants
    against the JAX modules through the converters (logits and every
    feature map 1e-5), and the four losses."""
    rng = np.random.RandomState(4)
    B, T = 2, 301
    y = (rng.randn(B, T, 1) * 0.3).astype(np.float32)
    y_hat = (rng.randn(B, T, 1) * 0.3).astype(np.float32)
    jmpd = jdisc.MultiPeriodDiscriminator(periods=(3,))
    p = random_flax_params(jmpd, y, y_hat)
    mpd = discriminator.MultiPeriodDiscriminator(periods=(3,))
    mpd.load_state_dict(convert.vits2_mpd_from_jax(p), strict=True)
    got = mpd(t(y), t(y_hat))
    want = jax.jit(jmpd.apply)({"params": p}, y, y_hat)
    for i in range(2):
        for d, (a, b) in enumerate(zip(got[i], want[i])):
            _close(a, b, what=f"logits {i} {d}")
    for i in (2, 3):
        for d, (fa, fb) in enumerate(zip(got[i], want[i])):
            for layer, (a, b) in enumerate(zip(fa, fb)):
                b = np.asarray(b)
                a = a.detach().numpy()
                a = np.moveaxis(a, 1, -1)  # channel-first -> flax's feature-last
                _close(a, b, what=f"fmap {i} {d} {layer}")
    wants = (jloss.feature_loss(want[2], want[3]), jloss.discriminator_loss(want[0], want[1])[0],
             jloss.generator_loss(want[1])[0])
    gots = (loss.feature_loss(got[2], got[3]), loss.discriminator_loss(got[0], got[1])[0],
            loss.generator_loss(got[1])[0])
    for a, b in zip(gots, wants):
        _close(a, b)
    zp, lq, mp, lp = (rng.randn(B, 12, 6).astype(np.float32) for _ in range(4))
    zm = _mask([12, 8], 12)
    _close(loss.kl_loss(*map(t, (zp, lq, mp, lp, zm))), jloss.kl_loss(zp, lq, mp, lp, zm))

    Tt, C = 9, 16
    x = rng.randn(B, Tt, C).astype(np.float32)
    m = _mask([Tt, 6], Tt)
    d_r, d_h = (rng.randn(B, Tt, 1).astype(np.float32) for _ in range(2))
    for variant in ("dur_disc_1", "dur_disc_2"):
        jdd = jdisc.DurationDiscriminator(C, C, variant=variant)
        p = random_flax_params(jdd, x, m, d_r, d_h)
        dd = discriminator.DurationDiscriminator(C, C, variant=variant)
        dd.load_state_dict(convert.duration_discriminator_from_jax(p), strict=True)
        for a, b in zip(dd(t(x), t(m), t(d_r), t(d_h)), jdd.apply({"params": p}, x, m, d_r, d_h)):
            _close(a, b, what=variant)


def test_converter_round_trip_and_config_sections():
    """Port state_dict -> reference names -> ``import_vits2`` ->
    ``vits2_from_jax`` loads strictly and gives every effective weight back
    (1e-7), for the stochastic and the deterministic duration predictor;
    ``vits2_params`` / ``vits2_train_conf`` equal the YAML sections and
    ``derive_task_config(conf, "vits2")`` the JAX package's."""
    with open(os.path.join(REPO, "config", "model_config.yaml"), encoding="utf8") as f:
        assert port_config.vits2_params() == yaml.safe_load(f)["vits2"]
    with open(os.path.join(REPO, "config", "train_config.yaml"), encoding="utf8") as f:
        assert port_config.vits2_train_conf() == yaml.safe_load(f)["vits2"]
    conf = port_config.build_config(os.path.join(REPO, "config"))
    jconf = jax_config.build_config(os.path.join(REPO, "config"))
    assert (port_config.derive_task_config(conf, "vits2")
            == jax_config.derive_task_config(jconf, "vits2"))
    for use_sdp in (True, False):
        hp = vits2_hparams("pre_conv2") | {"use_sdp": use_sdp}
        model = port_vits2(hp)
        sd = convert.vits2_from_jax(
            import_vits2(convert.reference_state_dict(model.state_dict()), hp), hp)
        VITS2(N_SYMBOLS, hp, n_speakers=2, spec_channels=80).load_state_dict(sd, strict=True)
        a, b = convert.reference_state_dict(model.state_dict()), convert.reference_state_dict(sd)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-7, err_msg=k)
