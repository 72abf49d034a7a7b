"""Matcha training: one ``make_matcha_train_step`` against the JAX
package's step, and the trainers on the CPU (``python -m
viet_tts_torch.train --task matcha``, ``--task text2wav --version matcha``,
``--is_finetune``) with two-stage and JOINT serving.

The step: the port's seeded Matcha (``matcha_hparams``: every dropout 0)
goes to JAX through ``import_matcha`` and back through
``matcha_from_jax``. The JAX draws are captured and fed to the port:
the CVAE's noise from its outputs, the CFM's flow times from the
estimator's call (an interceptor), its noise z from u = x1 - (1 - sigma) z.
Two steps: 0 (the soft expansion through the aligner's attention; the bin
loss weighted 0) and 6 (past ``binarization_start_steps`` 4: the hard
durations; the bin loss on), one jitted JAX function for both, in one test
item. Held: the training forward's outputs (1e-4 for the vector field, u
and mu_y, 1e-5 for the rest, the hard durations exact), every loss and the
total at rel 1e-5, each parameter's clipped gradient within 1e-4 max|g| +
1e-7 of the JAX tensor, the CVAE's BatchNorm statistics after the step.

The trainers: tiny models (``tests/test_matcha.py:TINY_HP``, dropouts as
there, the hard expansion from step 1, the bin loss's warm-up from step 0,
so it weighs 0 at step 0 and more at step 1) on ``tests/synth_data.build_dataset``'s
2 speakers x 3 utterances at batch size 3 (two steps an epoch); no JAX
model.
"""

from __future__ import annotations

import copy
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viet_tts_tpu.models.fastspeech2.layers import CVAENet as JaxCVAENet
from viet_tts_tpu.models.matcha import MatchaTTSLoss as JaxLoss
from viet_tts_tpu.models.matcha import decoder as jax_decoder
from viet_tts_torch.config import build_config
from viet_tts_torch.convert import matcha_from_jax
from viet_tts_torch.infer.api import OneStageTTS, TwoStageTTS, save_checkpoint
from viet_tts_torch.models.matcha import MatchaTTS, MatchaTTSLoss
from viet_tts_torch.train import __main__ as train_main
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train import matcha as port_matcha_train
from viet_tts_torch.train.joint import JointFinetuner, JointTrainer
from viet_tts_torch.train.matcha import (
    MatchaTrainer,
    make_matcha_train_step,
    make_matcha_valid_step,
)
from viet_tts_torch.train.state import TrainState
from viet_tts_torch.train.trainer import BaseTrainer

from tests.synth_data import build_dataset
from tests.test_torch_gan_trainer import DISC_SECTION, STEP_HIFI, _argv
from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    MATCHA_STATS,
    N_MELS,
    N_SYMBOLS,
    jax_matcha,
    matcha_hparams,
    one_torch_thread,
    port_hifigan,
    port_matcha,
    t,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T_TEXT, T_MEL = 2, 9, 24
STEPS = (0, 6)  # both sides of binarization_start_steps (4)
LOSS = {"n_channels": N_MELS,
        "linbuild": {"start": 0.0001, "stop": 0.0005, "n_up": 10000, "n_stop": 35000},
        "binarization_loss_enable_steps": 5, "binarization_loss_warmup_steps": 10}
MEL_ATOL = 1e-4
ATOL = 1e-5
LOSS_RTOL = 1e-5
TEXTS = ["Hôm nay trời đẹp quá!", "Chúng ta cùng nhau học tập và làm việc thật tốt."]


def _step_batch():
    rng = np.random.RandomState(1)
    text_lens = np.array([T_TEXT, T_TEXT - 3], np.int32)
    text = rng.randint(1, N_SYMBOLS, (B, T_TEXT)) * (np.arange(T_TEXT) < text_lens[:, None])
    return dict(text=text.astype(np.int32), text_lengths=text_lens,
                feats=rng.randn(B, T_MEL, N_MELS).astype(np.float32),
                feats_lengths=np.array([T_MEL, T_MEL - 8], np.int32),
                duration=rng.rand(B, T_MEL, T_TEXT).astype(np.float32),
                sids=np.array([0, 1], np.int32), aids=np.array([1, 0], np.int32))


def _capture_t(next_fun, args, kwargs, context):
    if isinstance(context.module, jax_decoder.UNetDecoder) and context.method_name == "__call__":
        context.module.sow("intermediates", "t", args[3])
    return next_fun(*args, **kwargs)


def _jax_reference(jm):
    """A jitted (params, batch_stats, batch, step) -> the JAX step's loss
    dict, gradients and new batch_stats, its training forward's outputs,
    the CVAE's (z, y, z, y, (mu, logvar) x 2) and the flow times: the
    loss of ``viet_tts_tpu/train/matcha.py:make_matcha_train_step`` with
    the draws captured."""
    criterion = JaxLoss(LOSS)
    rng = jax.random.PRNGKey(0)

    def loss_fn(params, stats, batch, step):
        step_rng = jax.random.fold_in(rng, step)
        with fnn.intercept_methods(_capture_t):
            preds, mut = jm.apply(
                {"params": params, "batch_stats": stats}, **batch, step=step, train=True,
                rngs={"dropout": step_rng, "reparam": jax.random.fold_in(step_rng, 1),
                      "noise": jax.random.fold_in(step_rng, 2)},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda m, _: isinstance(m, JaxCVAENet))
        losses = criterion(preds, (batch["feats"], batch["text_lengths"]), step=step)
        return sum(losses.values()), (losses, mut, preds)

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))

    def run(variables, batch, step):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        grads, (losses, mut, preds) = grad_fn(variables["params"], variables["batch_stats"],
                                              jb, jnp.asarray(step, jnp.int32))
        inter = mut["intermediates"]
        out = dict(losses=losses, grads=grads, stats=mut["batch_stats"], preds=preds,
                   cvae=inter["speaker_emb"]["cvae"]["__call__"][0],
                   t=inter["decoder"]["estimator"]["t"][0])
        return jax.tree_util.tree_map(lambda x: None if x is None else np.asarray(x), out,
                                      is_leaf=lambda x: x is None)

    return run


def _draws(ref, batch, sigma):
    z_acc, _, z_spk, _, (mu_acc, lv_acc, mu_spk, lv_spk) = ref["cvae"]
    return {"cvae_eps": tuple(torch.from_numpy((z - m) / np.exp(0.5 * lv))
                              for z, m, lv in ((z_acc, mu_acc, lv_acc), (z_spk, mu_spk, lv_spk))),
            "t": torch.from_numpy(ref["t"].copy()),
            "z": torch.from_numpy((batch["feats"] - ref["preds"][1]) / (1.0 - sigma))}


def _port_step(variables, hp, batch, step, draws):
    model = MatchaTTS(N_SYMBOLS, N_MELS, hp, MATCHA_STATS, n_speakers=2)
    model.load_state_dict(matcha_from_jax(variables, hp), strict=True)
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}
    args = (tb["text"], tb["text_lengths"], tb["feats"], tb["feats_lengths"], tb["sids"],
            tb["aids"], tb["duration"])
    with torch.no_grad():  # a copy: training mode moves the BatchNorm statistics
        fwd = copy.deepcopy(model).train()(*args, step=step, draws=draws)
    state = TrainState.create(model, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                              grad_clip=1.0)
    state.step = step
    state, metrics = make_matcha_train_step(model, MatchaTTSLoss(LOSS))(
        state, tb, torch.Generator().manual_seed(0), draws=draws)
    valid = make_matcha_valid_step(model, MatchaTTSLoss(LOSS))(
        state, tb, torch.Generator().manual_seed(0))
    return dict(fwd=fwd, metrics={k: v.item() for k, v in metrics.items()},
                grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                norm=state.grad_norm.item(), valid={k: v.item() for k, v in valid.items()},
                bn={n: b.numpy().copy() for n, b in model.named_buffers() if "running" in n})


def test_matcha_step_matches_jax():
    """At steps 0 and 6, against the JAX step: the training forward (the
    vector field, u and mu_y 1e-4; log-durations, the soft attention and
    its log, the CVAE's (mu, logvar) 1e-5; the hard durations and
    alignment exact; mu_y the soft expansion at step 0 and the hard one at
    6); every loss (diff, prior, cvae, ctc, bin, dur) and the total at rel
    1e-5, bin 0 at step 0 and on at 6; the global gradient norm (rel 1e-4)
    and each parameter's clipped gradient within 1e-4 max|g| + 1e-7; the
    CVAE's BatchNorm statistics after the step (1e-6); the validation
    step's finite diff and prior."""
    hp = matcha_hparams()
    jm, variables = jax_matcha(port_matcha(hp), hp)
    reference, batch = _jax_reference(jm), _step_batch()
    sigma = hp["flow_matching"]["sigma_min"]
    mu_y = {}
    for step in STEPS:
        ref = reference(variables, batch, step)
        port = _port_step(variables, hp, batch, step, _draws(ref, batch, sigma))
        tag = f"step {step}"

        j, got = ref["preds"], port["fwd"]
        assert np.abs(j[0]).max() > 1e-2
        for i, name in enumerate(("vector field", "u", "mu_y")):
            np.testing.assert_allclose(got[i].numpy(), j[i], atol=MEL_ATOL, rtol=MEL_ATOL,
                                       err_msg=f"{tag} {name}")
        mu_y[step] = j[2]
        np.testing.assert_array_equal(got[6].numpy(), j[6], err_msg=f"{tag} durations")
        np.testing.assert_array_equal(got[8][1].numpy(), j[8][1], err_msg=f"{tag} hard")
        pairs = [("log_d", got[7], j[7]), ("soft", got[8][0], j[8][0]),
                 ("logprob", got[8][3], j[8][3]),
                 *((f"cvae {i}", a, b) for i, (a, b) in enumerate(zip(got[9], j[9])))]
        for name, a, b in pairs:
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL, err_msg=f"{tag} {name}")

        losses = ref["losses"]
        assert set(losses) == {"diff", "prior", "cvae", "ctc", "bin", "dur"}
        assert set(port["metrics"]) == set(losses) | {"total"}
        for name, want in losses.items():
            np.testing.assert_allclose(port["metrics"][name], want, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{tag} {name}")
        np.testing.assert_allclose(port["metrics"]["total"], sum(losses.values()),
                                   rtol=LOSS_RTOL)
        assert (losses["bin"] > 0) == (step >= LOSS["binarization_loss_enable_steps"])

        want_norm = float(np.sqrt(sum(np.sum(np.square(g))
                                      for g in jax.tree_util.tree_leaves(ref["grads"]))))
        np.testing.assert_allclose(port["norm"], want_norm, rtol=1e-4)
        factor = min(1.0, 1.0 / want_norm)
        want = matcha_from_jax({"params": ref["grads"], "batch_stats": variables["batch_stats"]},
                               hp)
        assert set(want) >= set(port["grads"])
        for name, g in port["grads"].items():
            w = want[name].numpy() * factor
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, f"{tag} {name}"
        stats = matcha_from_jax({"params": variables["params"], "batch_stats": ref["stats"]}, hp)
        for name, got_bn in port["bn"].items():
            np.testing.assert_allclose(got_bn, stats[name].numpy(), atol=1e-6,
                                       err_msg=f"{tag} {name}")
        assert set(port["valid"]) == {"diff", "prior"}
        assert all(np.isfinite(v) for v in port["valid"].values())
    assert np.abs(mu_y[0] - mu_y[6]).max() > 1e-3  # soft, then hard expansion


# -- the trainers --------------------------------------------------------------

def _conf():
    """The shipped config, Matcha at ``tests/test_matcha.py:TINY_HP`` widths
    with its dropouts as there, the hard expansion from step 1, the bin
    loss's warm-up from step 0; HiFi-GAN at ``STEP_HIFI`` on 16-frame windows and the tiny
    discriminator; batch size 3."""
    from tests.test_matcha import TINY_HP

    conf = build_config(os.path.join(REPO, "config"))
    hp = copy.deepcopy(TINY_HP)
    hp["duration_modelling"]["binarization_start_steps"] = 1
    conf["models"]["matcha"] = hp
    conf["train"]["matcha"]["loss"]["binarization_loss_enable_steps"] = 0
    conf["models"]["hifigan"].update(STEP_HIFI, segment_size=16,
                                     discriminator_params=DISC_SECTION)
    conf["train"].update(batch_size=3, log_step=1)
    return conf


@pytest.fixture
def cli(tmp_path, monkeypatch):
    """(root with the dataset, the tiny config), ``build_config`` patched
    to return it, the epoch ends' parameter histograms left out
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


def test_matcha_trainer_stats_resume_and_serving(cli, monkeypatch):
    """``--task matcha`` for two steps: the mel statistics of the training
    utterances (float64 over every frame and channel) written to
    ``stats.json`` and the datasets normalised by them, the optimizer's
    defaults (betas (0.9, 0.999), eps 1e-8), a constant rate (gamma 1),
    the losses (diff, prior, cvae, ctc, bin, dur) finite with bin 0 at
    step 0 and on at step 1; then a run stopped after one step and resumed
    by scan to two, which rereads ``stats.json`` (computing them again is
    refused here): the resumed step's weights and losses equal the
    uninterrupted run's bit for bit; ``TwoStageTTS(model_type="MATCHA")``
    serves the output."""
    root, conf = cli
    full, part = {}, {}
    trainer = train_main.main(_argv(root, "matcha", "full", 2), on_trainer=_kept(full))
    assert isinstance(trainer, MatchaTrainer) and isinstance(trainer.model, MatchaTTS)
    assert isinstance(trainer.criterion, MatchaTTSLoss) and trainer.criterion.n_channels == 80
    group = trainer.state.tx.opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8 and trainer.gamma == 1.0
    out = trainer.args.output_folder
    with open(os.path.join(out, "stats.json")) as f:
        stats = json.load(f)
    feats = np.concatenate([trainer.train_data.base[i]["feat"].astype(np.float64).ravel()
                            for i in range(len(trainer.train_data))])
    np.testing.assert_allclose([stats["mel_mean"], stats["mel_std"]],
                               [feats.mean(), feats.std()], rtol=1e-9)
    raw, item = trainer.train_data.base[0]["feat"], trainer.train_data[0]["feat"]
    np.testing.assert_allclose(item, (raw - stats["mel_mean"]) / stats["mel_std"], rtol=1e-6)
    assert sorted(full) == [1, 2] and trainer.train_loader.epoch_batches() == 2
    assert full[1][1]["bin"] == 0.0 < full[2][1]["bin"]
    assert set(full[1][1]) == {"diff", "prior", "cvae", "ctc", "bin", "dur", "total"}
    assert all(np.isfinite(v) for s in full.values() for v in s[1].values())
    assert trainer.state.lr == conf["train"]["matcha"]["optimizer"]["lr"]
    assert sorted(f for f in os.listdir(out) if f.endswith(ckpt.SUFFIX)) == [
        ckpt.checkpoint_name("generator", 0, 2)]

    train_main.main(_argv(root, "matcha", "part", 1))

    def refused(_):
        raise AssertionError("the resumed run computed the mel statistics again")

    monkeypatch.setattr(port_matcha_train, "compute_mel_stats", refused)
    resumed = train_main.main(_argv(root, "matcha", "part", 2), on_trainer=_kept(part))
    assert sorted(part) == [2] and resumed.iter == 2 and resumed.stats == stats
    assert part[2][1] == full[2][1]
    for k, v in full[2][0].items():
        assert torch.equal(part[2][0][k], v), k

    voc = os.path.join(root, "voc")
    save_checkpoint(voc, port_hifigan(STEP_HIFI), {"models": {"hifigan": dict(STEP_HIFI)}})
    tts = TwoStageTTS(out, voc, model_type="MATCHA", max_mel_frames=32, device="cpu")
    assert (tts.acoustic.mel_mean, tts.acoustic.mel_std) == (stats["mel_mean"],
                                                             stats["mel_std"])
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(tts.acoustic.state_dict()[k], v), k
    waves = tts(TEXTS, speaker="hcm_spk", accent="hcm")
    assert len(waves) == 2 and all(np.isfinite(w).all() and w.size % 256 == 0 for w in waves)


def test_text2wav_matcha_warm_start_finetune_and_joint_serving(cli):
    """``--task text2wav --version matcha -a <--task matcha output>``:
    Text2Wav's Matcha starts from that output's weights and mel statistics,
    the joint loss is ``MatchaTTSLoss`` (warm: is_finetune) with every
    Matcha loss under ``var_``, the datasets normalised; ``--is_finetune``
    from its output on a dataset with a third speaker for one step; then
    ``OneStageTTS(model_type="JOINT")`` serves both outputs."""
    root, conf = cli
    acoustic = train_main.main(_argv(root, "matcha", "matcha", 1))
    source = {k: v.clone() for k, v in acoustic.state.module.state_dict().items()}
    steps = {}

    def on_trainer(tr):
        assert all(torch.equal(tr.model.text2mel.state_dict()[k], v) for k, v in source.items())
        _kept(steps)(tr)

    joint = train_main.main(_argv(root, "text2wav", "joint", 2, "--version", "matcha",
                                  "-a", acoustic.args.output_folder), on_trainer=on_trainer)
    assert isinstance(joint, JointTrainer) and isinstance(joint.model.text2mel, MatchaTTS)
    assert isinstance(joint.criterion, MatchaTTSLoss) and joint.criterion.is_finetune
    assert joint.stats == acoustic.stats and joint.conf["version"] == "matcha"
    item, raw = joint.train_loader.dataset[0], joint.train_loader.dataset.base[0]
    assert "speech" in item
    np.testing.assert_allclose(item["feat"], (raw["feat"] - joint.stats["mel_mean"])
                               / joint.stats["mel_std"], rtol=1e-6)
    assert {f"var_{k}" for k in ("diff", "prior", "cvae", "ctc", "dur", "bin")} <= set(steps[1][1])
    assert all(np.isfinite(v) for s in steps.values() for v in s[1].values())

    ft_root = os.path.join(root, "ft")
    build_dataset(ft_root, n_utts=3, speakers=("hn_spk", "hcm_spk", "hn_new"))
    ft = train_main.main(["--task", "text2wav", "--version", "matcha", "--is_finetune", "-c",
                          joint.args.output_folder, "-i", os.path.join(ft_root, "egs"), "-d",
                          os.path.join(ft_root, "data"), "-o", os.path.join(ft_root, "out"),
                          "--max_iter", "1", "--device", "cpu"])
    assert isinstance(ft, JointFinetuner) and ft.adapter_speakers == ["hn_new"]
    assert ft.stats == joint.stats and ft.iter == 1
    assert ft.model.text2mel.speaker_emb.cvae.embedding_layer_spk.weight.shape[0] == 3

    for trainer, speaker in ((joint, "hn_spk"), (ft, "hn_new")):
        tts = OneStageTTS(trainer.args.output_folder, model_type="JOINT", max_mel_frames=32,
                          device="cpu")
        assert isinstance(tts.model.text2mel, MatchaTTS)
        waves = tts(TEXTS, speaker=speaker, accent="hn")
        assert len(waves) == 2 and all(np.isfinite(w).all() and w.size % 256 == 0
                                       for w in waves)
