"""The port's Text2Wav trainer and finetuner (``python -m
viet_tts_torch.train --task text2wav [--is_finetune]``) and JOINT serving,
on the CPU, with no JAX model: ``tests/test_torch_text2wav.py`` holds the
step itself against JAX; this file holds the loop, the warm starts and
the surgery around it.

A tiny config: FastSpeech2 of ``tiny_model_config(block="conformer")`` with
``attn_implementation: flash`` (the kernels' plain versions), HiFi-GAN of
``STEP_HIFI`` on 16-frame windows and the ``TINY_DISC`` discriminator, every
dropout as configured, on ``tests/synth_data.build_dataset``'s 2 speakers x
3 utterances (4 train, 2 test; mel bucket 128) at batch size 3: two steps
an epoch. Held: checkpoint and discriminator file names, both rates
against JAX's ``exponential_lr``, a resume by scan from inside an epoch
past the next epoch end that repeats the uninterrupted run bit for bit,
``OneStageTTS(model_type="JOINT")`` and the server on the output (200 on
``/synthesize``, 501 on ``/synthesize_stream``); the warm start from tiny
``--task fastspeech2`` and ``--task hifigan`` outputs; the finetuner's
surgery, its adapter batches and its rate rule; the CLI's refusals and
its default device.
"""

import copy
import json
import logging
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from viet_tts_tpu.train.state import exponential_lr as jax_exponential_lr
from viet_tts_torch.config import build_config
from viet_tts_torch.train import __main__ as train_main
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.joint import JOINT_GAMMA, JointFinetuner, JointTrainer
from viet_tts_torch.train.trainer import BaseTrainer
from viet_tts_torch.utils.tfevents import read_events

from tests.synth_data import build_dataset, tiny_model_config
from tests.test_torch_gan_trainer import (
    DISC_SECTION,
    STEP_HIFI,
    _argv,
    _disc_iteration,
    _names,
    _rates,
    _recorded,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS_PER_EPOCH = 2  # 4 training utterances in one bucket, batch size 3
SPEAKERS = ("hn_spk", "hcm_spk")
TEXTS = ["Hôm nay trời đẹp quá!", "Tôi yêu tiếng Việt."]


def _conf():
    conf = tiny_model_config(build_config(os.path.join(REPO, "config")), block="conformer")
    conf["models"]["fastspeech2"]["attn_implementation"] = "flash"
    conf["models"]["hifigan"].update(STEP_HIFI, segment_size=16,
                                     discriminator_params=DISC_SECTION)
    conf["train"].update(batch_size=3, log_step=1)
    return conf


@pytest.fixture
def cli(tmp_path, monkeypatch):
    """(root with the dataset, the tiny config), ``build_config`` patched
    to return it. The epoch ends' parameter histograms (the byte-loop
    CRC-32C, ~1.3 s an epoch end here, half of this file's time) are left
    out: ``test_torch_trainer.py`` holds them, and nothing here reads
    them."""
    root = str(tmp_path)
    build_dataset(root, n_utts=3, speakers=SPEAKERS)
    conf = _conf()
    monkeypatch.setattr(train_main, "build_config", lambda _: copy.deepcopy(conf))
    monkeypatch.setattr(BaseTrainer, "_log_histograms", lambda self: None)
    return root, conf


def _want_rates(conf, it):
    """(generator, discriminator) rates of iteration ``it``, as JAX's
    ``exponential_lr`` of its epoch: the generator's from
    ``train.fastspeech2``, the discriminator's from ``train.hifigan``, both
    at gamma 0.999875."""
    epoch = it // STEPS_PER_EPOCH
    return tuple(jax_exponential_lr(conf["train"][task]["optimizer"]["lr"], 0.999875, epoch)
                 for task in ("fastspeech2", "hifigan"))


def test_joint_trainer_checkpoints_rates_resume_and_serving(cli):
    root, conf = cli
    n = STEPS_PER_EPOCH
    full = {}
    trainer = train_main.main(_argv(root, "text2wav", "full", 2 * n + 1),
                              on_trainer=_recorded(full))
    assert isinstance(trainer, JointTrainer) and not isinstance(trainer, JointFinetuner)
    assert trainer.gamma == trainer.dis_gamma == JOINT_GAMMA == 0.999875
    assert trainer.train_loader.epoch_batches() == n
    assert not trainer.criterion.is_finetune and trainer.mel_loss is not None
    out = trainer.args.output_folder
    assert _names(out) == [ckpt.checkpoint_name("generator", 0, n),
                           ckpt.checkpoint_name("generator", 1, 2 * n),
                           ckpt.checkpoint_name("generator", 2, 2 * n + 1)]
    assert _disc_iteration(out) == 2 * n + 1
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    assert (saved["task"], saved["version"]) == ("text2wav", "fastspeech2")
    assert sorted(full) == list(range(2 * n + 2))
    metrics = full[1][2]
    assert {"gen", "mel", "adv", "fm", "var_feat", "var_ctc", "var_pdur", "disc",
            "disc_real", "disc_fake"} <= set(metrics)
    assert all(np.isfinite(v) for step in range(1, 2 * n + 2) for v in full[step][2].values())
    for first, last in zip(full[1][:2], full[2 * n + 1][:2]):  # both models train
        assert any(not torch.equal(v, last[k]) for k, v in first.items())

    logged = _rates(out)
    assert sorted(logged) == list(range(2 * n + 1))
    for it, rates in logged.items():
        assert rates == tuple(np.float32(r) for r in _want_rates(conf, it)), it
        assert full[it + 1][3] == _want_rates(conf, it), it

    # stopped inside epoch 1, then resumed by scan past its end: every step
    # the uninterrupted run's bit for bit, under the same names
    train_main.main(_argv(root, "text2wav", "part", n + 1))
    part = os.path.join(root, "part")
    resumed_log = {}
    resumed = train_main.main(_argv(root, "text2wav", "part", 2 * n + 1),
                              on_trainer=_recorded(resumed_log))
    del resumed_log[0]
    assert sorted(resumed_log) == list(range(n + 2, 2 * n + 2))
    for step in resumed_log:
        got, want = resumed_log[step], full[step]
        assert got[2:] == want[2:], step
        for g, w in zip(got[:2], want[:2]):
            for k, v in w.items():
                assert torch.equal(g[k], v), (step, k)
    assert (resumed.iter, resumed.state.step, resumed.disc_state.step) == (2 * n + 1,) * 3
    assert _names(part) == [ckpt.checkpoint_name("generator", 1, n + 1),
                            ckpt.checkpoint_name("generator", 1, 2 * n),
                            ckpt.checkpoint_name("generator", 2, 2 * n + 1)]
    assert _disc_iteration(part) == 2 * n + 1

    _serve(trainer)


def _serve(trainer):
    """``OneStageTTS(model_type="JOINT")`` on the output directory: the
    trained weights, finite waveforms of whole frames; the server answers
    200 on ``/synthesize`` and 501 on ``/synthesize_stream``."""
    from viet_tts_torch.infer.api import OneStageTTS
    from viet_tts_torch.infer.server import serve

    out = trainer.args.output_folder
    tts = OneStageTTS(out, model_type="JOINT", max_mel_frames=48, device="cpu")
    assert tts.model.mel2wav.fused_mrf  # fused_vocoder by default: K2's route
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(tts.model.state_dict()[k], v), k
    waves = tts(TEXTS, speaker="hcm_spk", accent="hcm")
    assert len(waves) == 2
    for w in waves:
        assert w.ndim == 1 and w.dtype == np.float32 and np.isfinite(w).all()
        assert len(w) % 256 == 0
    with pytest.raises(NotImplementedError, match="Text2Wav composer decode"):
        next(tts.stream_wav(TEXTS[0]))
    httpd = serve(tts, port=0, model_name="JOINT")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        body = json.dumps({"text": TEXTS[0], "speaker": "hn_spk"}).encode()
        with urllib.request.urlopen(urllib.request.Request(f"{base}/synthesize", data=body),
                                    timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
            assert len(r.read()) > 44
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(f"{base}/synthesize_stream",
                                                          data=body), timeout=60)
        assert err.value.code == 501
        assert "Text2Wav composer decode" in json.loads(err.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_warm_start_from_fastspeech2_and_hifigan_outputs(cli, caplog):
    """``-a`` a ``--task fastspeech2`` output and ``-v`` a ``--task
    hifigan`` output: before the first step every weight and buffer of
    ``text2mel.`` is the acoustic output's and of ``mel2wav.`` the
    vocoder's (all match by name and shape here), the acoustic output's
    ``stats.json`` is reused, and the criterion is the finetuning one. A
    rerun resumes its own checkpoint instead of starting over."""
    root, _ = cli
    fs2 = train_main.main(_argv(root, "fastspeech2", "fs2", 1))
    hifi = train_main.main(_argv(root, "hifigan", "hifi", 1))
    before = {}
    with caplog.at_level(logging.INFO, logger="viet_tts_torch"):
        joint = train_main.main(
            _argv(root, "text2wav", "joint", 1, "-a", fs2.args.output_folder, "-v",
                  hifi.args.output_folder),
            on_trainer=lambda tr: before.update(
                {k: v.clone() for k, v in tr.model.state_dict().items()}))
    for prefix, source in (("text2mel.", fs2), ("mel2wav.", hifi)):
        want = source.state.module.state_dict()
        got = {k[len(prefix):]: v for k, v in before.items() if k.startswith(prefix)}
        assert got.keys() == want.keys(), prefix
        for k, v in want.items():
            assert torch.equal(got[k], v), prefix + k
    assert "loaded checkpoint for text2mel" in caplog.text and "(0 skipped)" in caplog.text
    assert "loaded checkpoint for mel2wav" in caplog.text
    assert joint.stats == fs2.stats and joint.criterion.is_finetune
    rerun = train_main.main(
        _argv(root, "text2wav", "joint", 2, "-a", fs2.args.output_folder, "-v",
              hifi.args.output_folder))
    assert (rerun.iter, rerun.state.step) == (2, 2)
    assert _names(rerun.args.output_folder)[-1] == ckpt.checkpoint_name("generator", 0, 2)


def test_finetuner_surgery_adapter_batches_and_rates(cli, caplog):
    """``--is_finetune -c`` a joint checkpoint on a dataset with a third
    speaker: the known speakers' embedding rows copied exactly (by name),
    the new speaker's row the first U[0, 1) draw of a generator seeded with
    ``train.seed``, every other weight the base checkpoint's, the epoch-0
    checkpoint written; epoch 0 trains on the new speaker's utterances
    alone and skips validation; below epoch 50 only the generator's rate
    decays (the JAX finetuner's rule, copied); a resume maps an iteration
    to its epoch across the two kinds of epoch."""
    root, conf = cli
    base = train_main.main(_argv(root, "text2wav", "base", 1)).args.output_folder
    base_sd = ckpt.model_state_dict(ckpt.scan_checkpoint(base, "generator"))
    ft_root = os.path.join(root, "ft")
    build_dataset(ft_root, n_utts=3, speakers=SPEAKERS + ("hn_new",))
    argv = ["--task", "text2wav", "--is_finetune", "-c", base, "-i",
            os.path.join(ft_root, "egs"), "-d", os.path.join(ft_root, "data"), "-o",
            os.path.join(ft_root, "out"), "--max_iter", "2", "--device", "cpu"]
    sids = []

    def hook(tr):
        step = tr.train_step

        def wrapped(gen_state, disc_state, batch, *rest):
            sids.append(batch["sids"].tolist())
            return step(gen_state, disc_state, batch, *rest)

        tr.train_step = wrapped
        sids.append({k: v.clone() for k, v in tr.model.state_dict().items()})

    ft = train_main.main(argv, on_trainer=hook)
    after_surgery = sids.pop(0)
    assert isinstance(ft, JointFinetuner) and ft.criterion.is_finetune
    with open(os.path.join(base, "stats.json")) as f:
        assert ft.adapter_speakers == ["hn_new"] and ft.stats == json.load(f)
    key = "text2mel.speaker_emb.cvae.embedding_layer_spk.weight"
    table = after_surgery[key]
    assert table.shape[0] == 3
    for i, name in enumerate(SPEAKERS):
        assert torch.equal(table[ft.speakers[name]], base_sd[key][i]), name
    drawn = torch.rand((3, table.shape[1]), generator=torch.Generator().manual_seed(ft.seed))
    assert torch.equal(table[ft.speakers["hn_new"]], drawn[ft.speakers["hn_new"]])
    for k, v in base_sd.items():
        if k != key:
            assert torch.equal(after_surgery[k], v), k
    out = ft.args.output_folder
    names = _names(out)
    assert names[0] == ckpt.checkpoint_name("generator", 0, 0)
    assert torch.equal(ckpt.model_state_dict(os.path.join(out, names[0]))[key], table)
    # epoch 0's batches: the adapter speaker's utterances only (2 train
    # utterances: one batch an epoch)
    assert ft.adapter_train_loader.epoch_batches() == 1
    assert sids == [[2, 2, 2]] * 2
    valid = os.path.join(out, "log", "valid")
    assert not any("valid/mel" in ev["values"] for name in os.listdir(valid)
                   for ev in read_events(os.path.join(valid, name)))
    # a resume's position: adapter epochs (one batch each) up to the
    # threshold, then epochs of every training utterance (two batches)
    assert ft.all_train_loader.epoch_batches() == 2
    for iteration, epoch in ((7, 7), (50, 50), (53, 51)):
        ft.seek(iteration)
        assert ft.epoch == epoch, iteration
    gen_lr, dis_lr = (conf["train"][t]["optimizer"]["lr"] for t in ("fastspeech2", "hifigan"))
    for epoch in (0, 1, 2, 50, 51, 60):
        ft.set_epoch_rates(epoch)
        assert ft.state.lr == jax_exponential_lr(gen_lr, 0.999875, epoch)
        assert ft.disc_state.lr == (dis_lr if epoch <= 50 else
                                    jax_exponential_lr(dis_lr, 0.999875, epoch))
    # the same speakers, or no checkpoint, refused
    same = ["--task", "text2wav", "--is_finetune", "-c", base, "-i", os.path.join(root, "egs"),
            "-d", os.path.join(root, "data"), "-o", os.path.join(root, "same"), "--device",
            "cpu"]
    with pytest.raises(NotImplementedError, match="Speakers is still same"):
        train_main.main(same)
    with pytest.raises(ValueError, match="pre-trained model checkpoint"):
        train_main.main(same[:3] + same[5:])


def test_is_finetune_refused_but_for_text2wav(tmp_path):
    with pytest.raises(ValueError, match="not supported for `fastspeech2`"):
        train_main.main(["--task", "fastspeech2", "--is_finetune", "-i", str(tmp_path), "-d",
                         str(tmp_path), "-o", str(tmp_path / "out"), "--config",
                         os.path.join(REPO, "config"), "--device", "cpu"])


def test_text2wav_runs_on_cuda_by_default_and_never_falls_back(tmp_path):
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    argv = _argv(root, "text2wav", "out", 1)[:-2]  # no --device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(argv + ["--config", os.path.join(REPO, "config")])
