"""AdaSpeech training: one ``make_fs2_train_step`` on the port's AdaSpeech
against the JAX package's step, and the trainers on the CPU
(``python -m viet_tts_torch.train --task adaspeech``, ``--task text2wav
--version adaspeech``) with JOINT serving.

The step: the port's seeded AdaSpeech (``ada_hparams``: every dropout 0;
the Postnet's fixed 0.5 zeroed on both sides) goes to JAX through
``import_adaspeech`` and back through ``adaspeech_from_jax``; the JAX
CVAE's noise is captured and fed to the port through ``cvae_eps``; the
loss is ``AdaSpeechLoss`` with the word- and sentence-level duration
losses on. Two steps: 0 (soft expansion, the PhonemeLevelEncoder's latents
feed the decoder, ``avg_mel_phn`` weighted 0) and 6 (hard expansion,
distillation: the encoder's latents detached, ``avg_mel_phn`` on, the bin
loss on), one jitted JAX function for both, in one test item.

The trainers: tiny models on ``tests/synth_data.build_dataset``'s 2
speakers x 3 utterances at batch size 3 (two steps an epoch), every
dropout as configured, the distillation and binarization switches at step
1 so that the two steps run both branches; no JAX model.
"""

from __future__ import annotations

import copy
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viet_tts_tpu.models.adaspeech import AdaSpeechLoss as JaxLoss
from viet_tts_tpu.models.fastspeech2.layers import CVAENet as JaxCVAENet
from viet_tts_tpu.models.fastspeech2.loss import total_loss as jax_total_loss
from viet_tts_torch.config import build_config
from viet_tts_torch.convert import adaspeech_from_jax
from viet_tts_torch.infer.api import OneStageTTS, TwoStageTTS, save_checkpoint
from viet_tts_torch.models.adaspeech import AdaSpeech, AdaSpeechLoss
from viet_tts_torch.train import __main__ as train_main
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.joint import JointTrainer
from viet_tts_torch.train.state import TrainState
from viet_tts_torch.train.steps import make_fs2_train_step, make_fs2_valid_step
from viet_tts_torch.train.trainer import AdaSpeechTrainer, BaseTrainer

from tests.synth_data import build_dataset
from tests.test_fastspeech2 import LOSS_CONF
from tests.test_torch_fs2_train import _batch, _model_args, _no_dropout
from tests.test_torch_gan_trainer import DISC_SECTION, STEP_HIFI, _argv
from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    FS2_STATS,
    N_MELS,
    N_SYMBOLS,
    ada_hparams,
    jax_adaspeech,
    one_torch_thread,
    port_adaspeech,
    port_hifigan,
    t,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
T_MEL = 48
STEPS = (0, 6)  # below and above binarization_start_steps (4) and the distillation (5)
LOSS = dict(LOSS_CONF, dur_loss_lambda={"pdur": 1.0, "wdur": 1.0, "sdur": 1.0},
            binarization_loss_enable_steps=5, phoneme_level_encoder_step=5)
MEL_ATOL = 1e-4
ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # ||port - JAX|| against ||JAX||, each tensor
TEXTS = ["Hôm nay trời đẹp quá!", "Chúng ta cùng nhau học tập và làm việc thật tốt."]


def _step_batch():
    """``test_torch_fs2_train.py``'s batch (the beta-binomial prior) with
    word ids: three words a row, the padding -1."""
    batch = _batch(T_MEL)
    words = np.repeat(np.arange(3), 3)[: batch["text"].shape[1]]
    batch["word_ids"] = np.where(np.arange(batch["text"].shape[1])[None]
                                 < batch["text_lengths"][:, None], words, -1).astype(np.int32)
    return batch


def _jax_reference(jm):
    """A jitted (params, batch_stats, batch, step) -> the JAX step's loss
    dict, gradients and new batch_stats, and its training forward's
    outputs and CVAE (z, mu, logvar): the ``micro_loss`` of
    ``viet_tts_tpu/train/steps.py:make_fs2_train_step`` with the CVAE
    captured."""
    criterion = JaxLoss(LOSS)
    rng = jax.random.PRNGKey(0)

    def loss_fn(params, stats, batch, step):
        drop_rng, rep_rng = jax.random.split(jax.random.fold_in(rng, step))
        (y_pred, y_extra), mut = jm.apply(
            {"params": params, "batch_stats": stats}, **_model_args(batch), step=step,
            train=True, rngs={"dropout": drop_rng, "reparam": rep_rng},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, JaxCVAENet))
        targets = (batch["feats"], batch["word_ids"], batch["word_ids"].shape[1], *y_extra)
        losses = criterion(y_pred, targets, step=step)
        return jax_total_loss(losses), (losses, mut, y_pred, y_extra)

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))

    def run(variables, batch, step):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with fnn.intercept_methods(_no_dropout):
            grads, (losses, mut, y_pred, y_extra) = grad_fn(
                variables["params"], variables["batch_stats"], jb, jnp.asarray(step, jnp.int32))
        cvae = mut["intermediates"]["speaker_emb"]["cvae"]["__call__"][0]
        out = dict(losses=losses, grads=grads, stats=mut["batch_stats"], pred=y_pred,
                   extra=y_extra, cvae=cvae)
        return jax.tree_util.tree_map(lambda x: None if x is None else np.asarray(x), out,
                                      is_leaf=lambda x: x is None)

    return run


def _port_step(variables, hp, batch, step, cvae):
    z_acc, _, z_spk, _, (mu_acc, logvar_acc, mu_spk, logvar_spk) = cvae
    eps = tuple(torch.from_numpy((z - mu) / np.exp(0.5 * lv))
                for z, mu, lv in ((z_acc, mu_acc, logvar_acc), (z_spk, mu_spk, logvar_spk)))
    model = AdaSpeech(N_SYMBOLS, N_MELS, hp, FS2_STATS, n_speakers=2)
    model.load_state_dict(adaspeech_from_jax(variables, hp), strict=True)
    model.postnet.dropout.p = 0.0
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}
    with torch.no_grad():
        fwd = copy.deepcopy(model).train()(**_model_args(tb), step=step, cvae_eps=eps)
    state = TrainState.create(model, lr=2e-4, betas=(0.8, 0.99), eps=1e-9, weight_decay=0.0,
                              grad_clip=1.0)
    state.step = step
    state, metrics = make_fs2_train_step(model, AdaSpeechLoss(LOSS))(
        state, tb, torch.Generator().manual_seed(0), cvae_eps=eps)
    valid = make_fs2_valid_step(model, AdaSpeechLoss(LOSS))(state, tb)
    return dict(fwd=fwd, metrics={k: v.item() for k, v in metrics.items()},
                grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                norm=state.grad_norm.item(), valid={k: v.item() for k, v in valid.items()},
                bn={n: b.numpy().copy() for n, b in model.named_buffers() if "running" in n})


def test_adaspeech_step_matches_jax():
    """At steps 0 and 6, against the JAX step: the training forward's mels
    (1e-4), durations and hard alignment (exact), predictions, targets and
    both latents (1e-5); every loss and the total (rel 1e-5; wdur and sdur
    on, avg_mel_phn 0 at step 0 and on at 6, bin on at 6); each parameter's
    clipped gradient within 1e-4 of its JAX tensor's norm, the
    PhonemeLevelEncoder's exactly 0 at step 6 (distillation) and the
    PhonemeLevelPredictor's exactly 0 at step 0 (its loss weighted 0); the
    BatchNorm statistics after the step (1e-6); the validation step's
    finite feat losses."""
    hp = ada_hparams()
    jm, variables = jax_adaspeech(port_adaspeech(hp), hp)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    reference, batch = _jax_reference(jm), _step_batch()
    for step in STEPS:
        ref = reference(variables, batch, step)
        port = _port_step(variables, hp, batch, step, ref["cvae"])
        tag = f"step {step}"

        (outs, post, log_d, p_outs, e_outs, _, _, _, _, probs, attn, phn_pred), \
            (ds, ps, es, phn_enc) = port["fwd"]
        j = ref["pred"]
        j_ds, j_ps, j_es, j_phn_enc = ref["extra"]
        assert np.abs(j[0]).max() > 1e-2
        np.testing.assert_allclose(outs.numpy(), j[0], atol=MEL_ATOL, err_msg=tag)
        np.testing.assert_allclose(post.numpy(), j[1], atol=MEL_ATOL, err_msg=tag)
        np.testing.assert_array_equal(attn[1].numpy(), j[10][1], err_msg=tag)
        np.testing.assert_array_equal(ds.numpy(), j_ds, err_msg=tag)
        pairs = [("log_d", log_d, j[2]), ("pitch", p_outs, j[3]), ("energy", e_outs, j[4]),
                 ("ps", ps, j_ps), ("es", es, j_es), ("phn_pred", phn_pred, j[11]),
                 ("phn_encode", phn_enc, j_phn_enc),
                 *((f"cvae {i}", a, b) for i, (a, b) in enumerate(zip(probs, j[9])))]
        for name, a, b in pairs:
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL, err_msg=f"{tag} {name}")

        losses = ref["losses"]
        assert {"wdur", "sdur", "avg_mel_phn", "bin"} <= set(losses)
        assert set(port["metrics"]) == set(losses) | {"total"}
        for name, want in losses.items():
            np.testing.assert_allclose(port["metrics"][name], want, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{tag} {name}")
        np.testing.assert_allclose(port["metrics"]["total"], sum(losses.values()), rtol=LOSS_RTOL)
        distill = step >= LOSS["phoneme_level_encoder_step"]
        assert (losses["avg_mel_phn"] > 0) == distill and (losses["bin"] > 0) == distill

        want_norm = float(np.sqrt(sum(np.sum(np.square(g))
                                      for g in jax.tree_util.tree_leaves(ref["grads"]))))
        np.testing.assert_allclose(port["norm"], want_norm, rtol=1e-4)
        factor = min(1.0, 1.0 / want_norm)
        want = adaspeech_from_jax({"params": ref["grads"],
                                   "batch_stats": variables["batch_stats"]}, hp)
        assert set(want) >= set(port["grads"])
        for name, got in port["grads"].items():
            w = want[name].numpy() * factor
            assert np.linalg.norm(got - w) <= GRAD_TOL * np.linalg.norm(w) + 1e-9, \
                f"{tag} {name}"
        for module, zero_at in (("phoneme_level_encoder", True), ("phoneme_level_predictor",
                                                                   False)):
            grads = [g for n, g in port["grads"].items() if f".{module}." in n]
            assert len(grads) == 10  # two convs, two norms, the linear
            assert all(not g.any() for g in grads) == (distill == zero_at), f"{tag} {module}"
        stats = adaspeech_from_jax({"params": variables["params"], "batch_stats": ref["stats"]},
                                   hp)
        for name, got in port["bn"].items():
            np.testing.assert_allclose(got, stats[name].numpy(), atol=1e-6,
                                       err_msg=f"{tag} {name}")
        assert set(port["valid"]) == {"feat", "feat_postnet"}
        assert all(np.isfinite(v) for v in port["valid"].values())


# -- the trainers --------------------------------------------------------------

def _conf():
    """The shipped config, AdaSpeech at ``tests/test_adaspeech.py:tiny_hp``
    widths with its dropouts as there, the distillation and binarization
    from step 1; HiFi-GAN at ``STEP_HIFI`` on 16-frame windows and the tiny
    discriminator; batch size 3."""
    from tests.test_adaspeech import tiny_hp

    conf = build_config(os.path.join(REPO, "config"))
    hp = tiny_hp(phoneme_step=1)
    hp["variance"]["duration_modelling"]["binarization_start_steps"] = 1
    conf["models"]["adaspeech"] = hp
    conf["models"]["hifigan"].update(STEP_HIFI, segment_size=16,
                                     discriminator_params=DISC_SECTION)
    conf["train"].update(batch_size=3, log_step=1)
    return conf


@pytest.fixture
def cli(tmp_path, monkeypatch):
    """(root with the dataset, the tiny config), ``build_config`` patched to
    return it, the epoch ends' parameter histograms left out
    (``test_torch_trainer.py`` holds them)."""
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    conf = _conf()
    monkeypatch.setattr(train_main, "build_config", lambda _: copy.deepcopy(conf))
    monkeypatch.setattr(BaseTrainer, "_log_histograms", lambda self: None)
    return root, conf


def _kept(store):
    """``on_trainer``: keep the weights and the metrics after each step."""

    def hook(trainer):
        step = trainer.train_step

        def wrapped(*args):
            out = step(*args)
            store[out[0].step] = ({k: v.clone() for k, v in out[0].module.state_dict().items()},
                                  {k: float(v) for k, v in out[-1].items()})
            return out

        trainer.train_step = wrapped

    return hook


def test_adaspeech_trainer_resumes_bit_for_bit_and_serves(cli):
    """``--task adaspeech`` for two steps (the distillation switch between
    them), then a run stopped after one step and resumed by scan to two:
    the resumed step's weights and losses equal the uninterrupted run's bit
    for bit; the checkpoint names; ``TwoStageTTS(model_type="ADASPEECH")``
    serves the output."""
    root, conf = cli
    full, part = {}, {}
    trainer = train_main.main(_argv(root, "adaspeech", "full", 2), on_trainer=_kept(full))
    assert isinstance(trainer, AdaSpeechTrainer) and isinstance(trainer.model, AdaSpeech)
    assert isinstance(trainer.criterion, AdaSpeechLoss)
    assert trainer.criterion.phoneme_level_encoder_step == 1
    assert sorted(full) == [1, 2] and trainer.train_loader.epoch_batches() == 2
    assert full[1][1]["avg_mel_phn"] == 0.0 < full[2][1]["avg_mel_phn"]
    assert all(np.isfinite(v) for s in full.values() for v in s[1].values())
    out = trainer.args.output_folder
    assert sorted(f for f in os.listdir(out) if f.endswith(ckpt.SUFFIX)) == [
        ckpt.checkpoint_name("generator", 0, 2)]
    train_main.main(_argv(root, "adaspeech", "part", 1))
    resumed = train_main.main(_argv(root, "adaspeech", "part", 2), on_trainer=_kept(part))
    assert sorted(part) == [2] and resumed.iter == 2
    assert part[2][1] == full[2][1]
    for k, v in full[2][0].items():
        assert torch.equal(part[2][0][k], v), k

    voc = os.path.join(root, "voc")
    # the vocoder of the acoustic checkpoint's config (models.hifigan)
    save_checkpoint(voc, port_hifigan(STEP_HIFI), {"models": {"hifigan": dict(STEP_HIFI)}})
    tts = TwoStageTTS(out, voc, model_type="ADASPEECH", max_mel_frames=32, device="cpu")
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(tts.acoustic.state_dict()[k], v), k
    waves = tts(TEXTS, speaker="hcm_spk", accent="hcm")
    assert len(waves) == 2 and all(np.isfinite(w).all() and w.size % 256 == 0 for w in waves)


def test_text2wav_adaspeech_warm_start_and_joint_serving(cli):
    """``--task text2wav --version adaspeech -a <--task adaspeech output>``:
    Text2Wav's AdaSpeech starts from that output's weights, the joint loss
    is ``AdaSpeechLoss`` (warm: is_finetune) with ``var_avg_mel_phn`` off
    at step 0 and on at step 1, the saved config names the version; then
    ``OneStageTTS(model_type="JOINT")`` serves the output."""
    root, conf = cli
    acoustic = train_main.main(_argv(root, "adaspeech", "ada", 1))
    source = {k: v.clone() for k, v in acoustic.state.module.state_dict().items()}
    steps = {}

    def on_trainer(tr):
        assert all(torch.equal(tr.model.text2mel.state_dict()[k], v) for k, v in source.items())
        _kept(steps)(tr)

    joint = train_main.main(_argv(root, "text2wav", "joint", 2, "--version", "adaspeech",
                                  "-a", acoustic.args.output_folder), on_trainer=on_trainer)
    assert isinstance(joint, JointTrainer) and isinstance(joint.model.text2mel, AdaSpeech)
    assert isinstance(joint.criterion, AdaSpeechLoss) and joint.criterion.is_finetune
    assert steps[1][1]["var_avg_mel_phn"] == 0.0 < steps[2][1]["var_avg_mel_phn"]
    assert all(np.isfinite(v) for s in steps.values() for v in s[1].values())
    tts = OneStageTTS(joint.args.output_folder, model_type="JOINT", max_mel_frames=32,
                      device="cpu")
    assert isinstance(tts.model.text2mel, AdaSpeech)
    waves = tts(TEXTS, speaker="hn_spk", accent="hn")
    assert len(waves) == 2 and all(np.isfinite(w).all() and w.size % 256 == 0 for w in waves)
