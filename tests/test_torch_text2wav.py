"""Text2Wav and joint training as a whole: the port's ``Text2Wav`` (forward,
``inference``), ``convert.text2wav_from_jax`` and ``make_joint_train_step``
against the JAX package's ``Text2Wav`` and ``train/joint.py:
make_joint_train_step`` on the CPU, on the same weights and batch, at a
tiny width: FastSpeech2 of ``fs2_hparams("flash")`` (conformer blocks, CVAE,
Postnet, MAS-learned durations) with, in training, ``STEP_HIFI``'s
HiFi-GAN (16 channels, one resblock) on 8-frame windows and the
``TINY_DISC`` discriminator, and in inference ``TINY_HIFI``'s (64
channels, V1's whole (3, 7, 11) x (1, 3, 5) MRF). The step's vocoder is the
small one because tracing V1's MRF three times (two generator forwards of
the JAX step and their gradients) alone took ~12 s of the file's budget.

As in ``test_torch_fs2_train.py``: every dropout is 0 (the Postnet's fixed
0.5 too, on both sides), the JAX CVAE noise is captured
(``capture_intermediates`` on the JAX step's own first generator forward)
and fed to the port through ``cvae_eps``, and the JAX window starts are
handed in through ``start_idxs``. The training
forward runs at 48 mel frames (the decoder on K4's route) and inference at
520 (the decoder on K5's route, the vocoder's small stages through K2's
plain version), both on the kernels' plain versions. Both steps take plain
SGD at rate 1 (the optimizer is the states', not the step's), whose JAX
side also keeps the gradients it was given: the generator phase then sees
the same updated discriminator on both sides. The JAX reference is one
jitted function, computed once for the module.
"""

import copy
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viet_tts_tpu.models.fastspeech2.layers import CVAENet as JaxCVAENet
from viet_tts_tpu.models.fastspeech2.loss import FastSpeech2Loss as JaxLoss
from viet_tts_tpu.models.hifigan import MelSpectrogramLoss as JaxMelLoss
from viet_tts_tpu.models.hifigan import MultiScaleMultiPeriodDiscriminator as JaxMSMPD
from viet_tts_tpu.models.text2wav import Text2Wav as JaxText2Wav
from viet_tts_tpu.train.joint import make_joint_train_step as jax_make_joint_step
from viet_tts_tpu.train.state import TrainState as JaxTrainState
from viet_tts_torch.config import default_audio
from viet_tts_torch.convert import msmpd_from_jax, reference_state_dict, text2wav_from_jax
from viet_tts_torch.models.fastspeech2.loss import FastSpeech2Loss
from viet_tts_torch.models.hifigan.discriminator import MultiScaleMultiPeriodDiscriminator
from viet_tts_torch.models.text2wav import Text2Wav
from viet_tts_torch.ops.flash_xl_attention import xl3_padded_time
from viet_tts_torch.train.gan import build_mel_loss
from viet_tts_torch.train.joint import make_joint_train_step
from viet_tts_torch.train.state import TrainState

from tests.test_fastspeech2 import LOSS_CONF
from tests.test_torch_fs2_train import _batch, _hp, _model_args, _no_dropout
from tests.test_torch_gan_trainer import STEP_HIFI, _SGD
from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    FS2_STATS,
    N_MELS,
    N_SYMBOLS,
    TINY_DISC,
    TINY_HIFI,
    flax_msmpd_params,
    jax_fs2,
    jax_hifigan,
    one_torch_thread,
    port_fs2,
    port_hifigan,
    port_tiny_disc,
    t,
)

SEG, HOP = 8, 256
T_MEL, STEP = 48, 25  # hard expansion, bin loss on, KL weight mid-build-up
INFER_FRAMES = 520
WAVE_ATOL = 1e-4
LOSS_RTOL = 1e-5


def _conf(hifi=STEP_HIFI):
    return {"audio": default_audio(), "version": "fastspeech2",
            "models": {"fastspeech2": _hp(), "hifigan": dict(hifi, segment_size=SEG)}}


def _recording_sgd():
    """``optax.sgd(1.0)`` that also keeps the last gradients it was given
    in its state."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -g, grads), grads

    return optax.GradientTransformation(init, update)


def _joint_batch():
    batch = _batch(T_MEL)
    rng = np.random.RandomState(7)
    batch["speech"] = (0.1 * rng.randn(2, T_MEL * HOP)).astype(np.float32)
    return batch


class _FirstForwardKept:
    """The JAX ``Text2Wav`` as the JAX step sees it (``.conf``, ``.apply``),
    keeping the outputs and the CVAE's (z, mu, logvar) of the step's first
    generator forward (the discriminator phase's, outside the gradient)."""

    def __init__(self, jm):
        self.jm, self.conf, self.first = jm, jm.conf, None

    def apply(self, variables, **kw):
        if self.first is not None:
            return self.jm.apply(variables, **kw)
        out, mut = self.jm.apply(variables, mutable=[*kw.pop("mutable"), "intermediates"],
                                 capture_intermediates=lambda m, _: isinstance(m, JaxCVAENet),
                                 **kw)
        mut = dict(mut)
        self.first = out, mut.pop("intermediates")
        return out, mut


def _jax_reference(jm, jm_infer, jd, conf):
    """A jitted function (gen variables, disc params, the inference model's
    variables, batch, ref feats) -> the JAX joint step's metrics, generator
    and discriminator gradients and new batch_stats; its training forward's
    waveform and mel windows, (ds, ps, es), window starts and CVAE (z, mu,
    logvar); ``inference``'s (wav, wav_lengths) at ``INFER_FRAMES``."""
    audio = conf["audio"]
    mel_loss = JaxMelLoss(
        fs=audio["signal"]["sampling_rate"], n_fft=audio["stft"]["filter_length"],
        hop_length=HOP, win_length=audio["stft"]["win_length"],
        window=audio["stft"]["window"], n_mels=N_MELS, fmin=audio["mel"]["fmin"],
        fmax=audio["mel"]["fmax"], log_base=audio["mel"]["log_base"])
    kept = _FirstForwardKept(jm)
    train_step = jax_make_joint_step(kept, jd, mel_loss, JaxLoss(LOSS_CONF), "fastspeech2",
                                     HOP)
    rng = jax.random.PRNGKey(0)

    def ref(params, stats, dparams, infer_vars, batch, ref_feats):
        kept.first = None
        gen_state = JaxTrainState.create(apply_fn=jm.apply, params=params, tx=_recording_sgd(),
                                         batch_stats=stats).replace(step=STEP)
        disc_state = JaxTrainState.create(apply_fn=jd.apply, params=dparams,
                                          tx=_recording_sgd())
        new_gen, new_disc, metrics = train_step(gen_state, disc_state, batch, rng)
        (outs, extra, starts), inter = kept.first
        cvae = inter["text2mel"]["speaker_emb"]["cvae"]["__call__"][0]
        wav, wav_lens = jm_infer.apply(
            infer_vars, batch["sids"], batch["text"], batch["text_lengths"], INFER_FRAMES,
            feats=ref_feats, aids=batch["aids"], method=jm_infer.inference,
            rngs={"noise": rng})
        return dict(metrics=metrics, g_grads=new_gen.opt_state, d_grads=new_disc.opt_state,
                    stats=new_gen.batch_stats, wav_seg=outs[0], mel_seg=outs[1], extra=extra,
                    starts=starts, cvae=cvae, wav=wav, wav_lens=wav_lens)

    return jax.jit(ref)


def _weights():
    """The port's seeded FastSpeech2 and the two vocoders, and (the JAX
    ``Text2Wav`` modules, their variables through the JAX importers), by
    "step" and "infer"."""
    hp = _hp()
    fs2 = port_fs2(hp)
    fs2_vars = jax_fs2(fs2, hp)[1]
    models, variables = {"fs2": fs2}, {}
    for name, hifi in (("step", STEP_HIFI), ("infer", TINY_HIFI)):
        models[name] = JaxText2Wav(n_symbols=N_SYMBOLS, n_channels=N_MELS, conf=_conf(hifi),
                                   stats=FS2_STATS, n_speakers=2, n_accents=2,
                                   version="fastspeech2")
        models[f"{name}_hifi"] = port_hifigan(hifi)
        variables[name] = jax.tree_util.tree_map(np.asarray, {
            "params": {"text2mel": fs2_vars["params"],
                       "mel2wav": jax_hifigan(models[f"{name}_hifi"], hifi)[1]},
            "batch_stats": {"text2mel": fs2_vars["batch_stats"]}})
    return models, variables


@pytest.fixture(scope="module")
def case():
    """The port's weights, carried to JAX, the JAX reference on them, and
    the port's forward, step and inference fed JAX's draws."""
    conf, infer_conf = _conf(), _conf(TINY_HIFI)
    models, variables = _weights()
    dparams = jax.tree_util.tree_map(np.asarray, flax_msmpd_params(
        port_tiny_disc().state_dict(), TINY_DISC["periods"]))
    batch = _joint_batch()
    ref_feats = np.random.RandomState(3).randn(2, 64, N_MELS).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    reference = _jax_reference(models["step"], models["infer"], JaxMSMPD(**TINY_DISC), conf)
    with fnn.intercept_methods(_no_dropout):
        ref = jax.tree_util.tree_map(np.asarray, reference(
            variables["step"]["params"], variables["step"]["batch_stats"], dparams,
            variables["infer"], jb, jnp.asarray(ref_feats)))
    z_acc, _, z_spk, _, (mu_acc, logvar_acc, mu_spk, logvar_spk) = ref["cvae"]
    eps = tuple(torch.from_numpy((z - mu) / np.exp(0.5 * lv))
                for z, mu, lv in ((z_acc, mu_acc, logvar_acc), (z_spk, mu_spk, logvar_spk)))
    starts = torch.from_numpy(np.array(ref["starts"])).long()

    model = Text2Wav(N_SYMBOLS, N_MELS, conf, FS2_STATS, n_speakers=2)
    sd = text2wav_from_jax(variables["step"], conf)
    model.load_state_dict(sd, strict=True)
    model.text2mel.postnet.dropout.p = 0.0
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}
    port = {}
    # the training forward alone, on a copy (it updates the BatchNorm stats)
    fwd_model = copy.deepcopy(model).train()
    with torch.no_grad():
        port["fwd"] = fwd_model(**_model_args(tb), step=STEP, start_idxs=starts,
                                cvae_eps=eps)
    # serving's route: the vocoder's ch <= 64 stages through K2 (its plain
    # version here)
    served = Text2Wav(N_SYMBOLS, N_MELS, infer_conf, FS2_STATS, n_speakers=2, fused_mrf=True)
    infer_sd = text2wav_from_jax(variables["infer"], infer_conf)
    served.load_state_dict(infer_sd, strict=True)
    port["wav"], port["wav_lens"] = served.eval().inference(
        tb["sids"], tb["text"], tb["text_lengths"], INFER_FRAMES, feats=t(ref_feats),
        aids=tb["aids"])

    disc = MultiScaleMultiPeriodDiscriminator(**TINY_DISC)
    disc.load_state_dict(msmpd_from_jax(dparams), strict=True)
    gen_state, disc_state = (TrainState(m, _SGD(m.parameters())) for m in (model, disc))
    gen_state.step = STEP
    step = make_joint_train_step(model, disc, build_mel_loss(conf["audio"], log_base=None),
                                 FastSpeech2Loss(LOSS_CONF), HOP)
    _, _, metrics = step(gen_state, disc_state, tb, torch.Generator().manual_seed(0),
                         start_idxs=starts, cvae_eps=eps)
    port["metrics"] = {k: v.item() for k, v in metrics.items()}
    port["g_grads"] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    port["d_grads"] = {n: p.grad.numpy().copy() for n, p in disc.named_parameters()}
    port["bn"] = {n: b.numpy().copy() for n, b in model.named_buffers() if "running" in n}
    return conf, variables["step"], batch, port, ref


def _check_forward(case):
    """The vocoded window (B, 8 * 256, 1) and the mel window (B, 8, 80) of
    the training forward within 1e-4, the durations (ds) exact and summing
    to each mel length, the pitch and energy targets within 1e-5."""
    _, _, batch, port, ref = case
    (wav, mel, post, *_), (ds, ps, es), starts = port["fwd"]
    assert post is None and wav.shape == (2, SEG * HOP, 1) and mel.shape == (2, SEG, N_MELS)
    assert np.abs(ref["wav_seg"]).max() > 1e-2 and np.abs(ref["mel_seg"]).max() > 1e-2
    np.testing.assert_array_equal(starts.numpy(), ref["starts"])
    np.testing.assert_allclose(wav.numpy(), ref["wav_seg"], atol=WAVE_ATOL)
    np.testing.assert_allclose(mel.numpy(), ref["mel_seg"], atol=WAVE_ATOL)
    np.testing.assert_array_equal(ds.numpy(), ref["extra"][0])
    np.testing.assert_array_equal(ds.numpy().sum(1), batch["feats_lengths"])
    for name, a, b in (("ps", ps, ref["extra"][1]), ("es", es, ref["extra"][2])):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5, err_msg=name)
    assert xl3_padded_time(T_MEL) <= 512 < xl3_padded_time(INFER_FRAMES)


def _check_step_metrics(case):
    """The JAX step's metrics, gen, mel, adv, fm, var_<k> for each
    FastSpeech2 loss, disc, disc_real and disc_fake, within rel 1e-5."""
    _, _, _, port, ref = case
    assert set(port["metrics"]) == set(ref["metrics"])
    assert {"var_feat", "var_ctc", "var_bin", "var_cvae", "var_pdur"} <= set(port["metrics"])
    assert "var_feat_postnet" not in port["metrics"]  # the window is the Postnet's mel
    assert port["metrics"]["var_bin"] > 0 and port["metrics"]["disc"] > 0.1
    for name, want in ref["metrics"].items():
        np.testing.assert_allclose(port["metrics"][name], want, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=name)


def _check_step_gradients_and_batch_stats(case):
    """Both models' gradients through the weight bridge
    (``text2wav_from_jax``, ``msmpd_from_jax``), per tensor within
    1e-4 * max|g| + 1e-7 (the generator's taken against the updated
    discriminator on both sides), but for the Postnet convs' biases, whose
    gradient is 0 in exact arithmetic: there both sides are held under
    1e-6 of the conv weight's largest gradient; the BatchNorm running
    statistics after the step within 1e-6."""
    conf, variables, _, port, ref = case
    want_g = text2wav_from_jax({"params": ref["g_grads"],
                                "batch_stats": variables["batch_stats"]}, conf)
    want_g = {k: v.numpy() for k, v in want_g.items() if k in port["g_grads"]}
    want_d = {k: v.numpy() for k, v in msmpd_from_jax(ref["d_grads"]).items()}
    assert set(want_g) == set(port["g_grads"]) and set(want_d) == set(port["d_grads"])
    assert any(k.startswith("mel2wav.") for k in want_g)
    # a Postnet conv's bias feeds a BatchNorm in training mode, which takes
    # out any constant shift of a channel: its gradient is 0 in exact
    # arithmetic, and on both sides only rounding (~1e-7 of the conv
    # weight's), held as that
    zero = {n for n in want_g if re.fullmatch(r"text2mel\.postnet\.convolutions\.\d+\.0\.conv\.bias", n)}
    assert zero
    for name in zero:
        scale = np.abs(want_g[name.replace(".bias", ".weight")]).max()
        assert max(np.abs(port["g_grads"][name]).max(), np.abs(want_g[name]).max()) <= 1e-6 * scale
    for got, want in ((port["g_grads"], want_g), (port["d_grads"], want_d)):
        for name, b in want.items():
            a = got[name]
            assert a.shape == b.shape, name
            if name not in zero:
                assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-7, name
    stats = text2wav_from_jax({"params": variables["params"], "batch_stats": ref["stats"]},
                              conf)
    assert port["bn"] and all(name.startswith("text2mel.") for name in port["bn"])
    for name, got in port["bn"].items():
        np.testing.assert_allclose(got, stats[name].numpy(), atol=1e-6, err_msg=name)


def _check_inference(case):
    """``inference`` at 520 frames (the decoder on K5's route, the fused
    vocoder stages): the waveform within 1e-4 and ``wav_lens`` exact."""
    _, _, _, port, ref = case
    assert port["wav"].shape == ref["wav"].shape == (2, INFER_FRAMES * HOP)
    assert np.abs(ref["wav"]).max() > 1e-2
    np.testing.assert_allclose(port["wav"].numpy(), ref["wav"], atol=WAVE_ATOL)
    np.testing.assert_array_equal(port["wav_lens"].numpy(), ref["wav_lens"])
    assert (port["wav_lens"].numpy() % HOP == 0).all()


def test_forward_step_and_inference_match_jax(case):
    """The four comparisons in one item: under ``--dist load`` each item of
    a module may run on another worker, and each worker would set the
    module's fixture up again (one JAX compile, ~20 s, each)."""
    _check_forward(case)
    _check_step_metrics(case)
    _check_step_gradients_and_batch_stats(case)
    _check_inference(case)


def test_weights_round_trip():
    """The port's weights, through the JAX importers and back through
    ``text2wav_from_jax`` (which ``Text2Wav`` loads with ``strict=True``),
    are the port's, for both vocoders: every key of the ``text2mel.`` and
    ``mel2wav.`` submodules, BatchNorm statistics included, bit for bit,
    but for two layouts flax does not keep: the weight-normed pairs,
    compared folded into their effective weights (1e-6), and the GRU's
    hidden r / z biases, which the importer folds into the input ones
    (compared so, 1e-7)."""
    models, variables = _weights()
    gru = "text2mel.speaker_emb.encoder.gru"
    H = models["fs2"].speaker_emb.encoder.gru.hidden_size
    for name, hifi in (("step", STEP_HIFI), ("infer", TINY_HIFI)):
        conf = _conf(hifi)
        sd = text2wav_from_jax(variables[name], conf)
        Text2Wav(N_SYMBOLS, N_MELS, conf, FS2_STATS, n_speakers=2).load_state_dict(
            sd, strict=True)
        want = reference_state_dict(
            {**{f"text2mel.{k}": v for k, v in models["fs2"].state_dict().items()},
             **{f"mel2wav.{k}": v for k, v in models[f"{name}_hifi"].state_dict().items()}})
        got = reference_state_dict(sd)
        assert set(got) == set(want)
        for d in (got, want):
            ih, hh = d.pop(f"{gru}.bias_ih_l0"), d.pop(f"{gru}.bias_hh_l0")
            d["folded"] = torch.cat([ih[: 2 * H] + hh[: 2 * H], ih[2 * H:], hh[2 * H:]])
        torch.testing.assert_close(got.pop("folded"), want.pop("folded"), atol=1e-7, rtol=0)
        folded = {k[: -len(".weight_v")] + ".weight" for k in sd if k.endswith(".weight_v")}
        assert folded
        for k, v in want.items():
            tol = 1e-6 if k in folded else 0.0
            torch.testing.assert_close(got[k], v, atol=tol, rtol=tol, msg=k)


@pytest.mark.parametrize("version", ["vits"])
def test_unported_versions_raise(version):
    with pytest.raises(NotImplementedError, match=f"Not implemented for {version}"):
        Text2Wav(N_SYMBOLS, N_MELS, _conf(), FS2_STATS, n_speakers=2, version=version)
