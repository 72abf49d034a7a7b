"""The port's FastSpeech2 trainer, checkpoints and CLI on the CPU.

A tiny conformer FastSpeech2 (``tiny_model_config(conf, block="conformer")``,
``attn_implementation: flash``, so the kernels' plain versions run; every
dropout as configured) trains on ``tests/synth_data.build_dataset``'s 2
speakers x 3 utterances (4 train, 2 test) at batch size 3: two steps an
epoch, the second and the validation batch repeat-filled. No JAX model runs here: ``tests/test_torch_fs2_train.py`` holds the
step itself against JAX; this file holds the loop around it (checkpoint
names, keep-3, sidecars, the per-epoch learning rate against JAX's
``exponential_lr``, the best-loss record against JAX's
``_report_validation``, resume bit for bit from an epoch's end and from
inside an epoch, SIGTERM) and serving a
trainer's output through ``TwoStageTTS``.
"""

import argparse
import json
import os
import signal
import types

import numpy as np
import pytest
import torch

from viet_tts_tpu.train.state import exponential_lr as jax_exponential_lr
from viet_tts_tpu.train.trainer import BaseTrainer as JaxBaseTrainer
from viet_tts_torch.config import build_config
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.__main__ import NOT_PORTED, main
from viet_tts_torch.train.trainer import BaseTrainer, FastSpeech2Trainer, step_generator
from viet_tts_torch.utils.tfevents import read_events

from tests.synth_data import build_dataset, tiny_model_config
from tests.torch_parity import TINY_HIFI, one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS_PER_EPOCH = 2  # 4 training utterances in one bucket, batch size 3


def _conf():
    conf = tiny_model_config(build_config(os.path.join(REPO, "config")), block="conformer")
    conf["models"]["fastspeech2"]["attn_implementation"] = "flash"
    conf["models"]["hifigan"].update(TINY_HIFI)
    conf["train"].update(batch_size=3, log_step=1)
    return conf


def _args(root, out, max_iter, **kw):
    args = dict(
        task="fastspeech2", input_folder=os.path.join(root, "egs"),
        data_folder=os.path.join(root, "data"), output_folder=os.path.join(root, out),
        checkpoint=None, acoustic_checkpoint=None, vocoder_checkpoint=None,
        version="fastspeech2", max_iter=max_iter, is_finetune=False, profile=False,
        device="cpu")
    return argparse.Namespace(**dict(args, **kw))


def _recorded(trainer, store):
    """Keep the weights (BatchNorm buffers included) and the metrics after
    every step, keyed by the optimizer step."""
    step = trainer.train_step

    def wrapped(state, batch, generator):
        state, metrics = step(state, batch, generator)
        store[state.step] = ({k: v.clone() for k, v in state.module.state_dict().items()},
                             {k: float(v) for k, v in metrics.items()})
        return state, metrics

    trainer.train_step = wrapped
    return trainer


def _names(out):
    return sorted(f for f in os.listdir(out) if f.endswith(ckpt.SUFFIX))


def _lrs(out, kind):
    """The logged learning rate by iteration, over every run's event file."""
    folder = os.path.join(out, "log", kind)
    return {ev["step"]: ev["values"]["learning_rate"]
            for name in sorted(os.listdir(folder))
            for ev in read_events(os.path.join(folder, name))
            if "learning_rate" in ev.get("values", {})}


def _assert_steps_equal(got, want, steps):
    assert sorted(got) == list(steps)
    for step in steps:
        assert got[step][1] == want[step][1], step
        for k, v in want[step][0].items():
            assert torch.equal(got[step][0][k], v), (step, k)


def test_trainer_checkpoints_learning_rate_and_resume(tmp_path):
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    conf = _conf()
    n = STEPS_PER_EPOCH
    full = {}
    trainer = _recorded(FastSpeech2Trainer(_args(root, "full", 2 * n + 1), conf), full)
    assert trainer.train_loader.epoch_batches() == n
    trainer.run()
    out = trainer.args.output_folder
    # names carry the epoch and the iteration: two epoch ends, then
    # --max_iter inside epoch 2
    assert _names(out) == [ckpt.checkpoint_name("generator", 0, n),
                           ckpt.checkpoint_name("generator", 1, 2 * n),
                           ckpt.checkpoint_name("generator", 2, 2 * n + 1)]
    assert ckpt.scan_checkpoint(out, "generator").endswith(
        ckpt.checkpoint_name("generator", 2, 2 * n + 1))
    for name in ("config.json", "speakers.json", "accents.json", "stats.json"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    assert saved["task"] == "fastspeech2" and saved["audio"]["self_learning"] is True
    assert saved["models"]["fastspeech2"] == conf["models"]["fastspeech2"]
    with open(os.path.join(out, "stats.json")) as f:
        assert json.load(f) == trainer.stats
    assert sorted(full) == list(range(1, 2 * n + 2))
    assert all(np.isfinite(v) for _, m in full.values() for v in m.values())

    # the learning rate decays once an epoch, before validation (also the
    # validation of an epoch that --max_iter cut short), as JAX's
    opt = conf["train"]["fastspeech2"]["optimizer"]
    gamma = conf["train"]["fastspeech2"]["scheduler"]["gamma"]
    lrs = _lrs(out, "train")
    assert sorted(lrs) == list(range(2 * n + 1))
    for it, lr in lrs.items():
        assert lr == np.float32(jax_exponential_lr(opt["lr"], gamma, it // n))
    assert trainer.state.lr == jax_exponential_lr(opt["lr"], gamma, 3)
    (valid_log,) = os.listdir(os.path.join(out, "log", "valid"))
    valid = read_events(os.path.join(out, "log", "valid", valid_log))
    assert [ev["step"] for ev in valid if "valid/feat" in ev["values"]] == [
        n, 2 * n, 2 * n + 1]
    assert any("encoder.layers.0.ff1.linear1.weight" in ev["values"] for ev in valid) or \
        sum(len(ev["values"]) for ev in valid) > 40  # parameter histograms

    # stopped inside epoch 1 by --max_iter: the early validation decays the
    # rate and the checkpoint is named after epoch 1
    part = FastSpeech2Trainer(_args(root, "part", n + 1), conf)
    part.run()
    assert _names(part.args.output_folder) == [
        ckpt.checkpoint_name("generator", 0, n), ckpt.checkpoint_name("generator", 1, n + 1)]

    # resumed from epoch 0's end (-c): epoch 1 at its own rate, its next
    # step the uninterrupted run's bit for bit
    at_end_log = {}
    at_end = _recorded(FastSpeech2Trainer(_args(
        root, "at_end", n + 1, checkpoint=os.path.join(
            part.args.output_folder, ckpt.checkpoint_name("generator", 0, n))), conf),
        at_end_log)
    assert (at_end.epoch, at_end.iter, at_end.state.step) == (1, n, n)
    assert at_end.state.lr == jax_exponential_lr(opt["lr"], gamma, 1)
    at_end.train_one_epoch()  # one step, to --max_iter
    _assert_steps_equal(at_end_log, full, [n + 1])

    # resumed by scan inside epoch 1 and run past its end: every step the
    # uninterrupted run's bit for bit, at the same rates, under the same
    # names; keep-3 drops epoch 0's checkpoint
    inside_log = {}
    inside = _recorded(FastSpeech2Trainer(_args(root, "part", 2 * n + 1), conf), inside_log)
    assert (inside.epoch, inside.iter, inside.state.step) == (1, n + 1, n + 1)
    assert inside.state.lr == jax_exponential_lr(opt["lr"], gamma, 1)
    inside.run()
    _assert_steps_equal(inside_log, full, range(n + 2, 2 * n + 2))
    resumed_lrs = _lrs(inside.args.output_folder, "train")
    for it in range(n + 1, 2 * n + 1):
        assert resumed_lrs[it] == lrs[it], it
    assert _names(inside.args.output_folder) == [
        ckpt.checkpoint_name("generator", 1, n + 1), ckpt.checkpoint_name("generator", 1, 2 * n),
        ckpt.checkpoint_name("generator", 2, 2 * n + 1)]


def test_sigterm_writes_one_checkpoint_and_restores_the_handler(tmp_path):
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    trainer = FastSpeech2Trainer(_args(root, "out", 10 ** 6), _conf())
    step = trainer.train_step

    def step_then_sigterm(state, batch, generator):
        out = step(state, batch, generator)
        os.kill(os.getpid(), signal.SIGTERM)  # lands inside the step
        return out

    trainer.train_step = step_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    trainer.run()  # returns after the preemption checkpoint
    assert signal.getsignal(signal.SIGTERM) is before
    out = trainer.args.output_folder
    assert _names(out) == ["generator_epoch0_iteration1_statedict.pt"]
    assert trainer.iter == trainer.state.step == 1
    again = FastSpeech2Trainer(_args(root, "out", 10 ** 6), _conf())
    assert (again.epoch, again.iter, again.state.step) == (0, 1, 1)
    assert again.state.lr == trainer.base_lr
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(again.state.module.state_dict()[k], v), k


def test_two_stage_tts_serves_a_trainer_output(tmp_path):
    from viet_tts_torch.infer.api import TwoStageTTS, resolve_checkpoint, save_checkpoint
    from tests.torch_parity import port_hifigan

    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    trainer = FastSpeech2Trainer(_args(root, "out", 1), _conf())
    trainer.run()
    out = trainer.args.output_folder
    assert resolve_checkpoint(out).endswith(ckpt.checkpoint_name("generator", 0, 1))
    voc_dir = str(tmp_path / "voc")
    save_checkpoint(voc_dir, port_hifigan(), {"models": {"hifigan": dict(TINY_HIFI)}})
    tts = TwoStageTTS(out, voc_dir, max_mel_frames=48, device="cpu")
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(tts.acoustic.state_dict()[k], v), k
    waves = tts(["Hôm nay trời đẹp quá!", "Tôi yêu tiếng Việt."], speaker="hcm_spk",
                accent="hcm")
    assert len(waves) == 2
    for w in waves:
        assert w.ndim == 1 and w.dtype == np.float32 and np.isfinite(w).all()
        assert len(w) % 256 == 0


@pytest.mark.parametrize("task", sorted(NOT_PORTED))
def test_cli_refuses_unported_tasks(task, tmp_path):
    with pytest.raises(NotImplementedError, match=NOT_PORTED[task].split(",")[0]):
        main(["--task", task, "-i", str(tmp_path), "-d", str(tmp_path), "-o",
              str(tmp_path / "out"), "--config", os.path.join(REPO, "config"),
              "--device", "cpu"])


def test_cli_runs_on_cuda_by_default_and_never_falls_back(tmp_path):
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    argv = ["--task", "fastspeech2", "-i", os.path.join(root, "egs"), "-d",
            os.path.join(root, "data"), "-o", os.path.join(root, "out"), "--config",
            os.path.join(REPO, "config")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_report_validation_keeps_jax_best_loss_record():
    losses = [{"feat": 2.0, "feat_postnet": 2.5}, {"feat": 1.5, "feat_postnet": 2.6},
              {"feat": 1.4, "feat_postnet": 2.4}, {"feat": 1.4, "feat_postnet": 0.0},
              {"feat": 1.6, "feat_postnet": 1.0}, {"feat": 1.2, "feat_postnet": 0.9}]
    port = types.SimpleNamespace(best_val_loss=None, epoch=0)
    jax = types.SimpleNamespace(best_val_loss=None, epoch=0)
    records = []
    for val in losses:
        BaseTrainer._report_validation(port, dict(val))
        JaxBaseTrainer._report_validation(jax, dict(val))
        assert port.best_val_loss == jax.best_val_loss
        records.append(port.best_val_loss)
    assert records[1] == losses[0] and records[-1] == losses[-1]


def test_checkpoint_files_scan_keep3_and_weights(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    from viet_tts_torch.train.state import TrainState

    state = TrainState.create(model, lr=1e-3)
    for epoch, it in ((0, 9), (1, 10), (2, 100), (3, 11)):
        ckpt.save_checkpoint(str(tmp_path), "generator", epoch, it, ckpt.make_payload(state))
    assert _names(str(tmp_path)) == ["generator_epoch1_iteration10_statedict.pt",
                                     "generator_epoch2_iteration100_statedict.pt",
                                     "generator_epoch3_iteration11_statedict.pt"]
    newest = ckpt.scan_checkpoint(str(tmp_path), "generator")
    assert ckpt.parse_checkpoint_name(newest) == (2, 100)
    assert ckpt.scan_checkpoint(str(tmp_path), "discriminator") is None
    with pytest.raises(ValueError):
        ckpt.parse_checkpoint_name("model.pt")
    sd = ckpt.model_state_dict(newest)
    assert sd.keys() == model.state_dict().keys()
    assert "1.running_mean" in sd and "1.num_batches_tracked" in sd
    bigger = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.BatchNorm1d(4))
    merged, skipped = ckpt.apply_weights(bigger.state_dict(), sd)
    assert skipped == ["0.weight", "0.bias"]
    assert torch.equal(merged["1.weight"], sd["1.weight"])
    ckpt.save_information(str(tmp_path / "side"), {"a": 1}, {"s": 0}, None, {"pitch": {}})
    assert sorted(os.listdir(tmp_path / "side")) == ["config.json", "speakers.json",
                                                     "stats.json"]


def test_step_generator_is_a_function_of_seed_and_step():
    def draw(seed, step):
        return torch.rand(4, generator=step_generator(seed, step))

    assert torch.equal(draw(1234, 7), draw(1234, 7))
    assert not torch.equal(draw(1234, 7), draw(1234, 8))
    assert not torch.equal(draw(1234, 7), draw(1235, 7))
