"""The JETS-conformer slice as a whole: JETS with espnet "latest" rel-pos
conformer encoder and decoder (``encoder_type`` / ``decoder_type:
conformer``, attention on the flash route, so on kernel K7's plain versions
here) against the JAX package's JETS, on the same weights: inference (the
waveform and exact durations), the serving entry points on the CPU, the
converter's round trip, and one ``make_jets_train_step`` (gradients,
metrics, BatchNorm statistics) with every dropout at 0, on the "latest"
stacks and on the "legacy" ones (``conformer_rel_pos_type: legacy``,
attention on kernel K6's plain versions).

Weights go port -> JAX through ``import_jets`` and back through
``convert.jets_from_jax``. The JAX side runs its flash attention through
the dense lowering (its CPU path) and the vocoder layer by layer, as
``tests/test_torch_jets.py`` does; the training reference is
``tests/test_torch_jets_train.py``'s jitted JAX step.
"""

from __future__ import annotations

import copy
import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viet_tts_torch.convert import jets_from_jax, msmpd_from_jax
from viet_tts_torch.models.hifigan import MelSpectrogramLoss
from viet_tts_torch.models.hifigan.discriminator import MultiScaleMultiPeriodDiscriminator
from viet_tts_torch.models.jets import JETS as TorchJETS
from viet_tts_torch.nn.espnet_conformer import EspnetConformerEncoder
from viet_tts_torch.train.gan import METRICS, make_jets_train_step
from viet_tts_torch.train.state import TrainState

from tests.test_torch_jets import _jax_pre_round, _torch_pre_round
from tests.test_torch_jets_train import (
    HOP,
    LAMBDAS,
    T_MEL,
    TRAIN_HP,
    _batch,
    _check_grads,
    _jax_reference,
)
from tests.torch_parity import (
    N_MELS,
    N_SYMBOLS,
    SMALL_HP,
    TINY_DISC,
    flax_msmpd_params,
    jax_jets,
    port_jets,
    port_tiny_disc,
    session_cached,
    t,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

CONFORMER = dict(encoder_type="conformer", decoder_type="conformer",
                 conformer_rel_pos_type="latest", conformer_enc_kernel_size=7,
                 conformer_dec_kernel_size=31)
HP = dict(SMALL_HP, **CONFORMER)  # attn_implementation flash, fused_mrf on
CONF_TRAIN_HP = dict(TRAIN_HP, **CONFORMER)  # every dropout 0, fused_mrf off
B, T_TEXT, MAX_FRAMES = 3, 12, 48
WAV_ATOL = 1e-4  # fp32 through ~20 layers and the vocoder's 4 stages
ROUND_MARGIN = 1e-3  # pre-round durations must sit this far from a .5 tie


@pytest.fixture(scope="module")
def slice_case():
    jm, variables = jax_jets(port_jets(HP), HP)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = TorchJETS(N_SYMBOLS, N_MELS, HP)
    tm.load_state_dict(jets_from_jax(variables, HP), strict=True)
    rng = np.random.RandomState(7)
    text = rng.randint(1, N_SYMBOLS, (B, T_TEXT)).astype(np.int32)
    lens = np.array([T_TEXT, T_TEXT - 4, 5], np.int32)
    return jm, variables, tm.eval(), text, lens


def test_stacks_are_the_conformer_and_durations_match(slice_case):
    """Both stacks are espnet conformers on the flash route; the pre-round
    durations agree with JAX's within 1e-5, none sits within ROUND_MARGIN of
    a .5 tie, so the rounded durations match exactly."""
    jm, variables, tm, text, lens = slice_case
    for stack in (tm.encoder, tm.decoder):
        assert isinstance(stack, EspnetConformerEncoder)
        assert stack.attn_implementation == "flash" and not stack.legacy
    assert tm.decoder.encoders[0].conv_module.depthwise_conv.kernel_size == (31,)
    sids = np.zeros(B, np.int32)
    pre_j = np.asarray(jax.jit(functools.partial(jm.apply, method=_jax_pre_round))(
        variables, jnp.asarray(sids), jnp.asarray(text), jnp.asarray(lens)))
    with torch.no_grad():
        pre_t = _torch_pre_round(tm, t(text, torch.long), t(lens, torch.long)).numpy()
    valid = np.arange(T_TEXT)[None] < lens[:, None]
    np.testing.assert_allclose(pre_t[valid], pre_j[valid], atol=1e-5)
    frac = np.abs((pre_j[valid] % 1.0) - 0.5)
    assert frac.min() > ROUND_MARGIN, frac.min()
    np.testing.assert_array_equal(np.maximum(np.round(pre_t), 0.0) * valid,
                                  np.maximum(np.round(pre_j), 0.0) * valid)


def test_inference_waveform_matches_jax(slice_case):
    jm, variables, tm, text, lens = slice_case
    sids = np.zeros(B, np.int32)
    jm = type(jm)(n_symbols=jm.n_symbols, n_channels=jm.n_channels,
                  hparams=dict(HP, fused_mrf=False))
    synth = jax.jit(lambda v, s, x, n: jm.apply(v, s, x, n, MAX_FRAMES,
                                                method=jm.inference))
    wav_j, wl_j = synth(variables, jnp.asarray(sids), jnp.asarray(text), jnp.asarray(lens))
    wav_t, wl_t = tm.inference(t(sids, torch.long), t(text, torch.long),
                               t(lens, torch.long), MAX_FRAMES)
    wav_j, wl_j = np.asarray(wav_j), np.asarray(wl_j)
    assert wav_t.shape == wav_j.shape == (B, MAX_FRAMES * 256)
    np.testing.assert_array_equal(wl_t.numpy(), wl_j)
    assert np.isfinite(wav_t.numpy()).all()
    assert np.abs(wav_j).max() > 1e-2  # an audible-scale signal, not ~0
    np.testing.assert_allclose(wav_t.numpy(), wav_j, atol=WAV_ATOL)


def test_jets_from_jax_round_trips_the_conformer(slice_case):
    """port state_dict -> reference names -> ``import_jets`` ->
    ``convert.jets_from_jax`` gives every conformer tensor back bit for bit,
    the conv modules' BatchNorm statistics included."""
    model = port_jets(HP)
    _, variables = jax_jets(model, HP)
    back = jets_from_jax(jax.tree_util.tree_map(np.asarray, variables), HP)
    stack_keys = [k for k in model.state_dict() if k.split(".")[0] in ("encoder", "decoder")]
    assert any(k.endswith("conv_module.norm.running_var") for k in stack_keys)
    assert any(k.endswith("self_attn.pos_bias_u") for k in stack_keys)
    for key in stack_keys:
        if key.endswith("num_batches_tracked"):
            continue
        assert torch.equal(back[key], model.state_dict()[key]), key
    assert set(back) == set(model.state_dict())


def test_one_stage_tts_and_server_on_cpu(tmp_path):
    """The serving entry points on a small conformer checkpoint (the
    conformer chosen by its config.json), on the CPU: batched ``__call__``,
    chunked ``stream_wav`` and the HTTP server's three routes."""
    from viet_tts_torch.config import default_audio
    from viet_tts_torch.infer.api import OneStageTTS, save_checkpoint
    from viet_tts_torch.infer.server import serve

    conf = {"audio": default_audio(), "models": {"jets": {"generator_params": dict(HP)}}}
    save_checkpoint(str(tmp_path), port_jets(HP), conf)
    tts = OneStageTTS(str(tmp_path), max_mel_frames=MAX_FRAMES, device="cpu")
    assert isinstance(tts.model.decoder, EspnetConformerEncoder)
    texts = ["Xin chào các bạn.", "Hôm nay trời đẹp quá!"]
    waves = tts(texts)
    assert len(waves) == 2 and all(w.dtype == np.float32 for w in waves)
    assert all(np.isfinite(w).all() and w.size % 256 == 0 for w in waves)
    streamed = np.concatenate(list(tts.stream_wav(texts[0], chunk_frames=16)))
    assert streamed.shape == waves[0].shape
    edge = 16 * 256  # the first window's zero left context (test_torch_jets.py)
    np.testing.assert_allclose(streamed[edge:], waves[0][edge:], atol=1e-4)
    httpd = serve(tts, port=0, model_name="JETS")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            assert r.status == 200 and json.load(r)["status"] == "ok"
        body = json.dumps({"text": texts[1]}).encode()
        with urllib.request.urlopen(f"{base}/synthesize", data=body, timeout=60) as r:
            assert r.status == 200 and r.read(4) == b"RIFF"
        with urllib.request.urlopen(f"{base}/synthesize_stream", data=body,
                                    timeout=60) as r:
            assert r.status == 200 and len(r.read()) == 2 * waves[1].size
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module", params=["latest", "legacy"])
def step_case(request, tmp_path_factory):
    """The port's training forward and one ``make_jets_train_step`` on the
    conformer JETS of each rel-pos flavour, and the JAX reference
    (``test_torch_jets_train.py``): computed once a session for all the
    workers (``session_cached``; the JAX step takes ~45 s on the CPU)."""
    return session_cached(tmp_path_factory, f"jets_conformer_step_{request.param}",
                          lambda: _step_case(request.param))


def _step_case(flavour):
    hp = dict(CONF_TRAIN_HP, conformer_rel_pos_type=flavour)
    jm, variables = jax_jets(port_jets(hp), hp)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = TorchJETS(N_SYMBOLS, N_MELS, hp)
    model.load_state_dict(jets_from_jax(variables, hp), strict=True)
    dparams = flax_msmpd_params(port_tiny_disc().state_dict(), TINY_DISC["periods"])
    disc = MultiScaleMultiPeriodDiscriminator(**TINY_DISC)
    disc.load_state_dict(msmpd_from_jax(dparams), strict=True)
    batch = _batch()
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}

    fwd_model = copy.deepcopy(model).train()
    with torch.no_grad():
        fwd = fwd_model(tb["text"], tb["text_lengths"], tb["feats"], tb["feats_lengths"],
                        tb["pitch"][..., None], tb["energy"][..., None], tb["sids"],
                        generator=torch.Generator().manual_seed(0))

    gen_state = TrainState.create(model, lr=2e-4)
    disc_state = TrainState.create(disc, lr=2e-4)
    step = make_jets_train_step(model, disc, MelSpectrogramLoss(log_base=None), LAMBDAS, HOP)
    gen_state, disc_state, metrics = step(gen_state, disc_state, tb,
                                          torch.Generator().manual_seed(0))
    port = {
        "fwd": [x.numpy() if torch.is_tensor(x) else x for x in fwd],
        "metrics": {k: v.item() for k, v in metrics.items()},
        "gen_grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
        "gen_norm": gen_state.grad_norm.item(),
        "bn": {n: b.numpy().copy() for n, b in model.named_buffers() if "running" in n},
    }
    disc_after = flax_msmpd_params(disc.state_dict(), TINY_DISC["periods"])
    ref = _jax_reference(jm, variables, dparams, disc_after, batch)
    return port, ref, variables, hp


def test_training_forward_matches(step_case):
    """The 10-tuple of ``JETS.forward`` against ``JETS.__call__(train=True)``
    on the conformer stacks: durations exact, the waveform within 1e-4, the
    rest within 1e-5."""
    port, (_, _, outs, _, _), _, _ = step_case
    names = ("wav", "bin_loss", "log_p_attn", "start_idxs", "d_outs", "ds", "p_outs",
             "ps", "e_outs", "es")
    got, want = dict(zip(names, port["fwd"])), dict(zip(names, outs))
    assert got["wav"].shape == want["wav"].shape == (len(_batch()["text"]), 1, T_MEL * HOP)
    np.testing.assert_array_equal(got["ds"], want["ds"])
    np.testing.assert_array_equal(got["start_idxs"], want["start_idxs"])
    assert np.abs(want["wav"]).max() > 1e-3
    np.testing.assert_allclose(got["wav"], want["wav"], atol=1e-4)
    for name in names:
        if name not in ("wav", "ds", "start_idxs"):
            np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-5,
                                       err_msg=name)


def test_step_gradients_match(step_case):
    """Every generator gradient of the step (the conformer stacks' through
    K7's or K6's plain bwd-q / bwd-kv) against the JAX step's, per tensor
    within 1e-4 * max|g| + 1e-7 after clipping."""
    port, (_, _, _, _, g_grads), variables, hp = step_case
    want = jets_from_jax({"params": g_grads, "batch_stats": variables["batch_stats"]}, hp)
    want = {k: v.numpy() for k, v in want.items() if k in port["gen_grads"]}
    assert any(".self_attn.pos_bias_v" in k for k in want)
    _check_grads(port["gen_grads"], want, port["gen_norm"], list(want))


def test_step_metrics_and_batch_stats_match(step_case):
    """The nine metrics of one step at rel 1e-5, and the BatchNorm running
    statistics after it (the conformer conv modules' and the GST's) against
    the JAX step's batch_stats at 1e-6."""
    port, (metrics, stats, _, _, _), _, hp = step_case
    assert set(port["metrics"]) == set(metrics) == set(METRICS)
    for name in METRICS:
        np.testing.assert_allclose(port["metrics"][name], metrics[name], rtol=1e-5,
                                   err_msg=name)
    n_conv = 0
    for part in ("encoder", "decoder"):
        for layer, s in stats[part].items():
            i = int(layer.split("_")[1])
            for stat, jname in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(
                    port["bn"][f"{part}.encoders.{i}.conv_module.norm.{stat}"],
                    s["conv_module"]["norm"][jname], atol=1e-6, err_msg=f"{part} {layer}")
            n_conv += 1
    assert n_conv == hp["elayers"] + hp["dlayers"]
    ref = stats["gst"]["ref_enc"]
    for i in range(len(ref)):
        for stat, jname in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                port["bn"][f"gst.ref_enc.convs.{3 * i + 1}.{stat}"], ref[f"bn_{i}"][jname],
                atol=1e-6, err_msg=f"bn_{i} {stat}")
