"""VITS2 training: one ``make_vits2_train_step`` against the JAX package's
step, and the trainer on the CPU (``python -m viet_tts_torch.train --task
vits2``) with a resume and VITS2 serving of its output.

The step: the port's seeded VITS2 (``TINY_HP``) goes to JAX through
``import_vits2``; the two discriminators' params are drawn for the JAX
modules (``random_flax_params``) and carried to the port by
``vits2_mpd_from_jax`` / ``duration_discriminator_from_jax``. The JAX step
is ``viet_tts_tpu/train/vits2_trainer.py:make_vits2_train_step`` itself,
jitted once, with its ``nn.Dropout``s the identity (the port's rates 0),
its four normal draws recorded (``JaxNormalDraws``), its first generator
forward's outputs and the gradients each state is stepped with captured,
and fed to the port: the posterior's noise, the MAS noise, the SDP's two
noises and the segment starts. The JAX step runs the generator's forward a
second time inside the generator's gradient under the same key; the port
runs it once and keeps its graph, so the gradients held here show that the
two are the same computation. Held: the forward's 8-tuple (the MAS path and
``ids_slice`` exact, tensors 1e-4), the nine metrics at rel 1e-5, each
parameter's clipped gradient of all three models within 1e-4 max|g| + 1e-7
of the JAX tensor, and all three models after the update.

The trainer: ``TINY_HP`` on ``tests/synth_data.build_dataset``'s 2
speakers x 3 utterances at batch size 2; no JAX model.
"""

from __future__ import annotations

import copy
import logging
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from viet_tts_tpu.models.vits2 import DurationDiscriminator as JaxDurDisc
from viet_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from viet_tts_tpu.models.vits2.model import VITS2 as JaxVITS2
from viet_tts_tpu.train.state import TrainState as JaxTrainState
from viet_tts_tpu.train.state import adamw_with_clip as jax_adamw
from viet_tts_tpu.train import vits2_trainer as jax_vits2_trainer
from viet_tts_torch.config import build_config, default_audio
from viet_tts_torch.convert import (
    duration_discriminator_from_jax,
    vits2_from_jax,
    vits2_mpd_from_jax,
)
from viet_tts_torch.infer.api import OneStageTTS
from viet_tts_torch.models.hifigan.discriminator import WNConv
from viet_tts_torch.models.vits2 import VITS2
from viet_tts_torch.train import __main__ as train_main
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.gan import DISCRIMINATOR_FILE
from viet_tts_torch.train.state import TrainState, exponential_lr
from viet_tts_torch.train.trainer import BaseTrainer
from viet_tts_torch.train.vits2_trainer import (
    METRICS,
    VITS2Trainer,
    build_discriminators,
    intersperse_ids,
    make_vits2_train_step,
)

from tests.synth_data import build_dataset
from tests.test_torch_gan_trainer import _argv
from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    N_MELS,
    N_SYMBOLS,
    JaxNormalDraws,
    jax_vits2,
    no_dropout,
    one_torch_thread,
    port_vits2,
    random_flax_params,
    t,
    vits2_hparams,
    zero_dropout_,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T_TEXT, T_SPEC, HOP = 2, 9, 40, 256
LR, BETAS, EPS, CLIP = 2e-4, (0.8, 0.99), 1e-9, 1.0
LAMBDAS = {"c_mel": 45, "c_kl": 1.0}
MEL_KW = dict(sr=22050, n_fft=1024, hop_length=HOP, win_length=1024, window="hann",
              n_mels=N_MELS, fmin=0.0, fmax=None, log_base=None)
LOSS_RTOL = 1e-5
ATOL = 1e-4
TEXTS = ["Hôm nay trời đẹp quá!", "Tôi yêu tiếng Việt."]


def _step_batch():
    rng = np.random.RandomState(1)
    text_lens = np.array([T_TEXT, T_TEXT - 2], np.int32)
    text = rng.randint(1, N_SYMBOLS, (B, T_TEXT)) * (np.arange(T_TEXT) < text_lens[:, None])
    feats_lens = np.array([T_SPEC, T_SPEC - 8], np.int32)
    speech = (rng.randn(B, T_SPEC * HOP) * 0.3).astype(np.float32)
    return dict(text=text.astype(np.int32), text_lengths=text_lens,
                feats=rng.randn(B, T_SPEC, N_MELS).astype(np.float32), feats_lengths=feats_lens,
                sids=np.array([0, 1], np.int32), speech=speech)


def _jax_step(hp, variables, disc_params, dur_params, batch):
    """One jitted JAX ``make_vits2_train_step`` from fresh optimizer states:
    (its three new params, the metrics, the three gradients (generator,
    MPD, duration discriminator), the four normal draws, the first
    generator forward's outputs), numpy."""
    jm = JaxVITS2(n_symbols=N_SYMBOLS, hparams=hp, n_speakers=2, spec_channels=N_MELS)
    jd = JaxMPD(periods=tuple(hp["mpd_periods"]))
    jdd = JaxDurDisc(hp["hidden_channels"], hp["hidden_channels"],
                     variant=hp["duration_discriminator_type"])
    grads, forwards = [], []

    class Recorded(JaxTrainState):
        def apply_gradients(self, **kw):
            grads.append(kw["grads"])
            return super().apply_gradients(**kw)

    def first_forward(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JaxVITS2) and context.method_name == "__call__":
            forwards.append(out)
        return out

    def tx():
        return jax_adamw(LR, betas=BETAS, eps=EPS, weight_decay=0.0, grad_clip=CLIP)

    states = [Recorded.create(apply_fn=mod.apply, params=p, tx=tx())
              for mod, p in ((jm, variables["params"]), (jd, disc_params), (jdd, dur_params))]
    step = jax_vits2_trainer.make_vits2_train_step(jm, jd, jdd, MEL_KW, LAMBDAS, HOP)

    def run(states, batch):
        with JaxNormalDraws() as rec, fnn.intercept_methods(no_dropout), \
                fnn.intercept_methods(first_forward):
            out = step(*states, batch, jax.random.PRNGKey(7))
        # the states step in the order duration discriminator, MPD, generator
        return ([s.params for s in out[:3]], out[3], grads[2::-1], rec.draws[:4], forwards[0])

    out = jax.jit(run)(states, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def _close_rel(got, want, what):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7, err_msg=what)


def test_vits2_step_matches_jax():
    hp = vits2_hparams()
    model = port_vits2(hp)
    _, variables = jax_vits2(model, hp)
    disc_params = random_flax_params(JaxMPD(periods=tuple(hp["mpd_periods"])),
                                     np.zeros((1, 2048, 1), np.float32),
                                     np.zeros((1, 2048, 1), np.float32), seed=3)
    H = hp["hidden_channels"]
    dur_params = random_flax_params(
        JaxDurDisc(H, H, variant=hp["duration_discriminator_type"]),
        np.zeros((1, T_TEXT, H), np.float32), np.ones((1, T_TEXT, 1), np.float32),
        np.zeros((1, T_TEXT, 1), np.float32), np.zeros((1, T_TEXT, 1), np.float32), seed=2)
    batch = _step_batch()
    new_params, metrics, grads, draws, jfwd = _jax_step(hp, variables, disc_params, dur_params,
                                                        batch)

    gen = VITS2(N_SYMBOLS, hp, n_speakers=2, spec_channels=N_MELS)
    gen.load_state_dict(vits2_from_jax(variables, hp), strict=True)
    disc, dur_disc = build_discriminators(hp)
    disc.load_state_dict(vits2_mpd_from_jax(disc_params), strict=True)
    dur_disc.load_state_dict(duration_discriminator_from_jax(dur_params), strict=True)
    for m in (gen, disc, dur_disc):
        zero_dropout_(m)
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}
    fed = {name: torch.from_numpy(np.array(d)) for name, d in
           zip(("posterior_eps", "mas_eps", "sdp_eps", "sdp_reverse_eps"), draws)}
    fed["ids_slice"] = torch.from_numpy(np.array(jfwd[3])).long()

    # the training forward's 8-tuple
    with torch.no_grad():
        fwd = gen.train()(tb["text"], tb["text_lengths"], tb["feats"], tb["feats_lengths"],
                          tb["sids"], step=0, draws=fed)
    assert np.array_equal(fwd[2].numpy(), jfwd[2]), "MAS path"
    assert np.array_equal(fwd[3].numpy(), jfwd[3]), "ids_slice"
    assert fwd[2].sum() == batch["feats_lengths"].sum()
    pairs = [("o", fwd[0], jfwd[0]), ("l_length", fwd[1], jfwd[1]),
             *((f"latent {i}", a, b) for i, (a, b) in enumerate(zip(fwd[6], jfwd[6]))),
             *((f"duration {i}", a, b) for i, (a, b) in enumerate(zip(fwd[7], jfwd[7])))]
    for name, a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL, err_msg=name)

    states = [TrainState.create(m, lr=LR, betas=BETAS, eps=EPS, weight_decay=0.0,
                                grad_clip=CLIP) for m in (gen, disc, dur_disc)]
    step = make_vits2_train_step(gen, disc, dur_disc, default_audio(), LAMBDAS, HOP)
    before = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (gen, disc, dur_disc)]
    # the MPD's LeakyReLU inputs in its update, to hold their distance to 0
    pre_act = []
    hooks = [m.register_forward_hook(lambda mod, args, out: pre_act.append(out.detach()))
             for m in disc.modules() if isinstance(m, WNConv)]
    *_, port_metrics = step(*states, tb, torch.Generator().manual_seed(0), draws=fed)
    for h in hooks:
        h.remove()
    # A LeakyReLU input closer to 0 than the two implementations' rounding
    # (~1e-7 here) can take the other slope (0.1 against 1) on one side and
    # move an element of the MPD's gradient past the bound: the
    # discriminator's drawn weights (seed 3) keep every input of its update
    # at least 5e-7 from 0.
    n_convs = len(hooks)
    assert min(float(a.abs().min()) for a in pre_act[:n_convs]) >= 5e-7
    assert set(port_metrics) == set(metrics) == set(METRICS)
    for name in METRICS:
        _close_rel(port_metrics[name].item(), metrics[name], name)

    converters = (lambda p: vits2_from_jax({"params": p}, hp), vits2_mpd_from_jax,
                  duration_discriminator_from_jax)
    for module, state, g, new, conv, old, label in zip(
            (gen, disc, dur_disc), states, grads, new_params, converters, before,
            ("generator", "MPD", "duration discriminator")):
        assert state.step == 1
        norm = float(np.sqrt(sum(np.sum(np.square(x.astype(np.float64)))
                                 for x in jax.tree_util.tree_leaves(g))))
        np.testing.assert_allclose(state.grad_norm.item(), norm, rtol=1e-4, err_msg=label)
        factor = min(1.0, CLIP / norm)
        want_g, want_p = conv(g), conv(new)
        for name, p in module.named_parameters():
            w = want_g[name].numpy() * factor
            got = p.grad.numpy()
            assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, f"{label} {name}"
            # after AdamW's first step: exact where the gradient is clear of 0
            # (the update there is lr * sign(g)); within 2 lr where it is not
            after, want_after = p.detach().numpy(), want_p[name].numpy()
            clear = np.abs(w) > 1e-3 * np.abs(w).max() + 1e-6
            np.testing.assert_allclose(after[clear], want_after[clear], atol=1e-6,
                                       err_msg=f"{label} {name} after")
            assert np.abs(after - want_after).max() <= 2.0 * LR + 1e-6, f"{label} {name}"
            assert not torch.equal(p.detach(), old[name]) or not clear.any(), name


def _conf():
    """The shipped config with VITS2 at ``TINY_HP`` (dropouts as there),
    batch size 2, a log line a step."""
    conf = build_config(os.path.join(REPO, "config"))
    conf["models"]["vits2"] = vits2_hparams()
    conf["train"].update(batch_size=2, log_step=1)
    return conf


def _kept(store):
    """``on_trainer``: keep the three models' weights and the metrics after
    each step, by the generator's step."""

    def hook(trainer):
        step = trainer.train_step

        def wrapped(*args):
            out = step(*args)
            store[out[0].step] = (
                [{k: v.clone() for k, v in s.module.state_dict().items()} for s in out[:3]],
                {k: float(v) for k, v in out[-1].items()},
                trainer.step_rates())
            return out

        trainer.train_step = wrapped

    return hook


def test_vits2_trainer_resume_and_serving(tmp_path, monkeypatch, caplog):
    """``--task vits2 --device cpu`` for 3 steps: ``intersperse_ids`` as the
    JAX package's, the dataset's interspersed items (word ids -1) and
    lengths,
    the three states' rates (each its epoch's decayed rate), finite metrics,
    the generator checkpoints and the discriminator file (the MPD's and the
    duration discriminator's payloads, the iteration); a run stopped after
    one step and resumed by scan to 3 repeats the uninterrupted one bit for
    bit (all three models, the metrics); a missing discriminator file and
    one from another iteration warn; ``OneStageTTS(model_type="VITS2")``
    serves the output."""
    ids = np.array([5, 7, 9], np.int32)
    assert np.array_equal(intersperse_ids(ids), jax_vits2_trainer.intersperse_ids(ids))
    assert np.array_equal(intersperse_ids(ids), [0, 5, 0, 7, 0, 9, 0])
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    conf = _conf()
    monkeypatch.setattr(train_main, "build_config", lambda _: copy.deepcopy(conf))
    monkeypatch.setattr(BaseTrainer, "_log_histograms", lambda self: None)
    full, part = {}, {}
    n = 3
    trainer = train_main.main(_argv(root, "vits2", "full", n), on_trainer=_kept(full))
    assert isinstance(trainer, VITS2Trainer) and isinstance(trainer.model, VITS2)
    per_epoch = trainer.train_loader.epoch_batches()
    assert per_epoch == 2 and sorted(full) == list(range(1, n + 1))
    item, base = trainer.train_data[0], trainer.train_data.base[0]
    assert np.array_equal(item["text"], intersperse_ids(base["text"])) and "speech" in item
    assert (item["word_ids"] == -1).all()
    assert trainer.train_data.lengths(0) == (len(item["text"]), item["feat"].shape[0])
    task = conf["train"]["vits2"]
    for s, (_, metrics, rates) in full.items():
        epoch = (s - 1) // per_epoch
        want = exponential_lr(task["optimizer"]["lr"], task["scheduler"]["gamma"], epoch)
        assert rates == {"learning_rate": want, "disc_learning_rate": want,
                         "dur_disc_learning_rate": want}, s
        assert set(metrics) == set(METRICS) and all(np.isfinite(v) for v in metrics.values())
    out = trainer.args.output_folder
    names = sorted(f for f in os.listdir(out) if f.startswith("generator"))
    assert names == sorted([ckpt.checkpoint_name("generator", 0, per_epoch),
                            ckpt.checkpoint_name("generator", 1, n)])
    payload = ckpt.load_checkpoint(os.path.join(out, DISCRIMINATOR_FILE))
    assert payload["iteration"] == n and payload["step"] == payload["dur_step"] == n
    assert set(payload["dur_model"]) == set(trainer.duration_discriminator.state_dict())

    train_main.main(_argv(root, "vits2", "part", 1))
    resumed = train_main.main(_argv(root, "vits2", "part", n), on_trainer=_kept(part))
    assert sorted(part) == [2, 3] and resumed.iter == n
    for s in (2, 3):
        assert part[s][1] == full[s][1], s
        for got, want in zip(part[s][0], full[s][0]):
            for k, v in want.items():
                assert torch.equal(got[k], v), (s, k)

    path = os.path.join(resumed.args.output_folder, DISCRIMINATOR_FILE)
    with caplog.at_level(logging.WARNING, logger="viet_tts_torch"):
        payload = ckpt.load_checkpoint(path)
        torch.save(dict(payload, iteration=n + 4), path)
        resumed.try_resume_discriminator()
        os.remove(path)
        assert resumed.try_resume_discriminator() is None
    assert f"from iteration {n + 4}, the generator's from {n}" in caplog.text
    assert "no discriminator checkpoint found" in caplog.text

    tts = OneStageTTS(out, model_type="VITS2", max_mel_frames=64, device="cpu")
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(tts.model.state_dict()[k], v), k
    waves = tts(TEXTS, speaker="hcm_spk")
    assert len(waves) == 2 and all(np.isfinite(w).all() and w.size % 256 == 0 for w in waves)
