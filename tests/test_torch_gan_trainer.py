"""The port's GAN trainers (``python -m viet_tts_torch.train --task jets |
hifigan``), their step and init scheme, on the CPU.

- ``apply_init_scheme`` redraws the parameters the JAX package's redraws,
  by name through the weight bridge (``convert.reference_state_dict`` then
  ``train/torch_import.py:import_jets``), zeroes the biases and keeps its
  xavier draws inside +-sqrt(6 / (fan_in + fan_out)).
- One ``make_hifigan_train_step`` on a tiny generator (``STEP_HIFI``) and
  discriminator (``TINY_DISC``) against the JAX step, both states on plain
  SGD at rate 1: the metrics at rel 1e-5, both models' gradients per
  tensor within 1e-4 max|g| + 1e-7.
- Tiny JETS and HiFi-GAN trainers through ``main([..., "--device",
  "cpu"])`` on ``tests/synth_data.build_dataset``'s 2 speakers x 3
  utterances (4 train, 2 test; mel bucket 128) at batch size 3, two steps
  an epoch: checkpoint and discriminator file names, both rates against
  JAX's ``exponential_lr``, a resume by scan from inside an epoch past the
  next epoch end that repeats the uninterrupted run bit for bit (the
  HiFi-GAN case under ``--profile`` on both runs: the profiled epoch counts
  as an epoch), and the port's serving API on the outputs. No JAX model is
  jitted here but the tiny HiFi-GAN step's.
"""

import copy
import logging
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viet_tts_tpu.models.hifigan import MelSpectrogramLoss as JaxMelLoss
from viet_tts_tpu.models.hifigan import MultiScaleMultiPeriodDiscriminator as JaxMSMPD
from viet_tts_tpu.train.gan import make_hifigan_train_step as jax_make_hifigan_step
from viet_tts_tpu.train.state import TrainState as JaxTrainState
from viet_tts_tpu.train.state import apply_init_scheme as jax_apply_init_scheme
from viet_tts_tpu.train.state import exponential_lr as jax_exponential_lr
from viet_tts_torch.config import build_config
from viet_tts_torch.convert import hifigan_from_jax, msmpd_from_jax
from viet_tts_torch.models.hifigan import HiFiGANGenerator, MelSpectrogramLoss
from viet_tts_torch.models.hifigan.discriminator import MultiScaleMultiPeriodDiscriminator
from viet_tts_torch.train import __main__ as train_main
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.gan import (
    DISCRIMINATOR_FILE,
    HIFIGAN_METRICS,
    GANTrainer,
    make_hifigan_train_step,
)
from viet_tts_torch.train.state import TrainState, apply_init_scheme
from viet_tts_torch.utils.tfevents import read_events

from tests.synth_data import build_dataset
from tests.torch_parity import (
    N_MELS,
    SMALL_HP,
    TINY_DISC,
    TINY_HIFI,
    flax_msmpd_params,
    hifigan_kwargs,
    jax_hifigan,
    jax_jets,
    port_hifigan,
    port_jets,
    port_tiny_disc,
    t,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS_PER_EPOCH = 2  # 4 training utterances in one bucket, batch size 3

CONFORMER = dict(encoder_type="conformer", decoder_type="conformer",
                 conformer_rel_pos_type="latest")
# SMALL_HP with one layer a stack and test_torch_jets_train.py's vocoder (16
# channels, one resblock of two dilations): few distinct parameter shapes,
# so few JAX compiles
STEP_HIFI = dict(TINY_HIFI, upsample_initial_channel=16, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1, 3]])
STEP_HP = dict(SMALL_HP, elayers=1, dlayers=1, generator_channels=16,
               generator_resblock_kernel_sizes=[3], generator_resblock_dilations=[[1, 3]])


# -- the init scheme ---------------------------------------------------------

def _flat(variables):
    return {"/".join(k): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(variables["params"]).items()}


@pytest.mark.parametrize("stacks", ["transformer", "conformer"])
def test_init_scheme_redraws_what_jax_redraws(stacks):
    """Through the bridge, the flax leaves the port's scheme changes are
    the ones JAX's ``apply_init_scheme`` redraws (the speaker table among
    them, the encoder's embedding not); every bias is 0 after it; the rest
    keeps its value. On the torch side, every redrawn tensor lies inside
    the xavier bound of its fans and spans most of it."""
    hp = dict(STEP_HP, **(CONFORMER if stacks == "conformer" else {}))
    before = port_jets(hp, n_speakers=2)
    after = apply_init_scheme(copy.deepcopy(before), "xavier_uniform",
                              torch.Generator().manual_seed(5))
    f0 = _flat(jax_jets(before, hp, n_speakers=2)[1])
    f1 = _flat(jax_jets(after, hp, n_speakers=2)[1])
    # JAX's rule reads each leaf's name and ndim alone: run it on ones of
    # each leaf's ndim (few shapes, so few eager compiles); a redrawn leaf
    # leaves 1.0, a zeroed one becomes 0
    ones = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): np.ones((1,) * v.ndim, np.float32) for k, v in f0.items()})
    marks = {"/".join(k): float(np.asarray(v).ravel()[0]) for k, v in
             flax.traverse_util.flatten_dict(jax_apply_init_scheme(
                 ones, "xavier_uniform", jax.random.PRNGKey(0))).items()}
    want = {k for k, m in marks.items() if m not in (0.0, 1.0)}
    changed = {k for k in f0 if not np.allclose(f1[k], f0[k], rtol=1e-5, atol=1e-7)}
    assert "sid_emb/embedding" in want and "encoder/embed/embedding" not in want
    assert {k for k in changed if not k.endswith("/bias")} == want
    assert {k for k, m in marks.items() if m == 0.0} == {k for k in f0 if k.endswith("/bias")}
    for k, v in f1.items():
        if k.endswith("/bias"):
            assert not v.any(), k
    if stacks == "conformer":
        assert "encoder/layer_0/self_attn/pos_bias_u" in want

    ratios = []  # |draw| / its bound, pooled over the redrawn tensors
    params0 = dict(before.named_parameters())
    for name, p in after.named_parameters():
        if torch.equal(p, params0[name]) or name.endswith("bias") or "bias_" in name:
            continue
        shape = tuple(p.shape)
        if name.startswith("gst.ref_enc.gru.weight"):  # a gate's (H, in) block
            shape = (shape[0] // 3,) + shape[1:]
        bound = np.sqrt(6.0 / ((shape[0] + shape[1]) * int(np.prod(shape[2:]))))
        ratios.append(p.detach().abs().flatten().numpy() / bound)
        assert ratios[-1].max() <= 1.0, name
    ratios = np.concatenate(ratios)
    assert len(ratios) > 10 ** 4 and ratios.max() > 0.999  # uniform over the bound
    assert abs(ratios.mean() - 0.5) < 0.01


# jax.nn.initializers: (scale, fan mode, uniform?) of each scheme
SCHEMES = {"xavier_uniform": (1.0, "avg", True), "xavier_normal": (1.0, "avg", False),
           "kaiming_uniform": (2.0, "in", True), "kaiming_normal": (2.0, "in", False)}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_init_scheme_draws_with_flax_fans(scheme):
    """Each scheme's draws have the variance jax.nn.initializers gives the
    flax kernel of each torch layout: a linear (out, in), a conv (out, in,
    k), a transposed conv (in, out, k), each GRU gate's (H, in) block and a
    raw table (in, out); inside the uniform bound or the normal's 2-sigma
    truncation; biases zeroed, an "embed" module's table kept."""
    from viet_tts_torch.models.hifigan.generator import WNConvTranspose1d

    model = torch.nn.Module()
    model.lin = torch.nn.Linear(64, 48)
    model.conv = torch.nn.Conv1d(32, 40, 5)
    model.up = WNConvTranspose1d(48, 24, 16, 8, 4)
    model.gru = torch.nn.GRU(24, 32, batch_first=True)
    model.sid_emb = torch.nn.Embedding(300, 32)
    model.embed = torch.nn.Embedding(30, 8)
    before = copy.deepcopy(model)
    apply_init_scheme(model, scheme, torch.Generator().manual_seed(1))
    scale, mode, uniform = SCHEMES[scheme]
    gates = model.gru.weight_ih_l0.detach().view(3, 32, 24)
    blocks = [(model.lin.weight, 64, 48), (model.conv.weight, 32 * 5, 40 * 5),
              (model.up.weight_v, 48 * 16, 24 * 16), (model.sid_emb.weight, 300, 32),
              *((g, 24, 32) for g in gates)]
    for x, fan_in, fan_out in blocks:
        var = scale / (fan_in if mode == "in" else (fan_in + fan_out) / 2)
        x = x.detach().double()
        assert abs(x.var().item() / var - 1.0) < 0.12, (tuple(x.shape), x.var().item(), var)
        limit = np.sqrt(3 * var) if uniform else 2 * np.sqrt(var) / 0.87962566103423978
        assert x.abs().max().item() <= limit * (1 + 1e-6)
    for name in ("lin.bias", "conv.bias", "up.bias", "gru.bias_ih_l0", "gru.bias_hh_l0"):
        assert not model.get_parameter(name).any(), name
    for name in ("embed.weight", "up.weight_g"):
        assert torch.equal(model.get_parameter(name), before.get_parameter(name)), name


# -- make_hifigan_train_step against JAX ----------------------------------------

B, SEG, HOP = 2, 8, 256


def _vocoder_batch():
    rng = np.random.RandomState(0)
    return {"mel": rng.randn(B, SEG, N_MELS).astype(np.float32),
            "speech": (0.1 * rng.randn(B, SEG * HOP, 1)).astype(np.float32)}


class _SGD:
    """Plain SGD at rate 1 without clipping, the interface of the port's
    ``AdamWWithClip``: a step moves each parameter by minus its gradient,
    as ``optax.sgd(1.0)`` does on the JAX side."""

    lr = 1.0

    def __init__(self, params):
        self.params = list(params)

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p -= p.grad
        return torch.zeros(())

    def zero_grad(self):
        for p in self.params:
            p.grad = None


def test_hifigan_step_matches_jax():
    """One step of each package's ``make_hifigan_train_step`` from the same
    weights and batch. Both take plain SGD at rate 1 (the optimizer is the
    states', not the step's): a gradient is then the parameters' change,
    and the generator phase sees the same updated discriminator on both
    sides, where Adam's first, sign-like step would amplify rounding. The
    seven metrics within rel 1e-5; both models' gradients per tensor within
    1e-4 max|g| + 1e-7."""
    jgen, gparams = jax_hifigan(port_hifigan(STEP_HIFI), STEP_HIFI)
    gparams = jax.tree_util.tree_map(np.asarray, gparams)
    gen = HiFiGANGenerator(**hifigan_kwargs(STEP_HIFI))
    gen.load_state_dict(hifigan_from_jax(gparams, STEP_HIFI), strict=True)
    dparams = flax_msmpd_params(port_tiny_disc().state_dict(), TINY_DISC["periods"])
    disc = MultiScaleMultiPeriodDiscriminator(**TINY_DISC)
    disc.load_state_dict(msmpd_from_jax(dparams), strict=True)
    batch = _vocoder_batch()

    step = make_hifigan_train_step(gen, disc, MelSpectrogramLoss())
    _, _, metrics = step(TrainState(gen, _SGD(gen.parameters())),
                         TrainState(disc, _SGD(disc.parameters())),
                         {k: t(v) for k, v in batch.items()})

    jd = JaxMSMPD(**TINY_DISC)
    jax_step = jax_make_hifigan_step(jgen, jd, JaxMelLoss())

    def run(gparams, dparams, batch):
        gen_state, disc_state, metrics = jax_step(
            JaxTrainState.create(apply_fn=jgen.apply, params=gparams, tx=optax.sgd(1.0)),
            JaxTrainState.create(apply_fn=jd.apply, params=dparams, tx=optax.sgd(1.0)), batch)
        grads = jax.tree_util.tree_map(lambda a, b: a - b, (gparams, dparams),
                                       (gen_state.params, disc_state.params))
        return metrics, grads

    want_metrics, (g_grads, d_grads) = jax.tree_util.tree_map(np.asarray, jax.jit(run)(
        gparams, dparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    assert set(metrics) == set(want_metrics) == set(HIFIGAN_METRICS)
    assert metrics["mel"] > 1.0 and metrics["disc"] > 0.1
    for name in HIFIGAN_METRICS:
        np.testing.assert_allclose(metrics[name].item(), want_metrics[name], rtol=1e-5,
                                   err_msg=name)
    for module, want in ((gen, hifigan_from_jax(g_grads, STEP_HIFI)),
                         (disc, msmpd_from_jax(d_grads))):
        got = {n: p.grad.numpy() for n, p in module.named_parameters()}
        assert got.keys() == want.keys()
        for name, g in got.items():
            w = want[name].numpy()
            assert g.shape == w.shape, name
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, name


# -- the trainers through the CLI ------------------------------------------------

DISC_SECTION = {"scales": TINY_DISC["scales"], "periods": list(TINY_DISC["periods"]),
                "scale_discriminator_params": TINY_DISC["scale_params"],
                "period_discriminator_params": TINY_DISC["period_params"]}


def _conf():
    """The shipped config with tiny models: JETS at ``STEP_HP`` (every
    dropout at its default, the MRF unfused as in training, ``init_type``
    as shipped), HiFi-GAN at ``STEP_HIFI`` on 16-frame segments, the tiny
    discriminator for both."""
    conf = build_config(os.path.join(REPO, "config"))
    conf["train"].update(batch_size=3, log_step=1)
    conf["models"]["hifigan"].update(STEP_HIFI, segment_size=16,
                                     discriminator_params=DISC_SECTION)
    jets = conf["models"]["jets"]
    jets["generator_params"] = dict(STEP_HP, fused_mrf=False,
                                    init_type=jets["generator_params"]["init_type"])
    jets["discriminator_params"] = DISC_SECTION
    return conf


def _argv(root, task, out, max_iter, *extra):
    return ["--task", task, "-i", os.path.join(root, "egs"), "-d", os.path.join(root, "data"),
            "-o", os.path.join(root, out), "--max_iter", str(max_iter), "--device", "cpu",
            *extra]


def _recorded(store):
    """``on_trainer``: keep both models' weights (BatchNorm buffers
    included), the metrics and both rates after every step, keyed by the
    generator's optimizer step; the generator's weights before training
    under the key 0."""

    def hook(trainer):
        step = trainer.train_step
        store[0] = {k: v.clone() for k, v in trainer.model.state_dict().items()}

        def wrapped(gen_state, disc_state, *rest):
            rates = (gen_state.lr, disc_state.lr)
            gen_state, disc_state, metrics = step(gen_state, disc_state, *rest)
            store[gen_state.step] = (
                {k: v.clone() for k, v in gen_state.module.state_dict().items()},
                {k: v.clone() for k, v in disc_state.module.state_dict().items()},
                {k: float(v) for k, v in metrics.items()}, rates)
            return gen_state, disc_state, metrics

        trainer.train_step = wrapped

    return hook


def _names(out):
    return sorted(f for f in os.listdir(out) if f.startswith("generator_"))


def _rates(out):
    """The logged (generator, discriminator) rates by iteration, over every
    run's event file."""
    folder = os.path.join(out, "log", "train")
    tags = {}
    for name in sorted(os.listdir(folder)):
        for ev in read_events(os.path.join(folder, name)):
            for tag in ("learning_rate", "disc_learning_rate"):
                if tag in ev["values"]:
                    tags.setdefault(tag, {})[ev["step"]] = ev["values"][tag]
    gen, disc = tags["learning_rate"], tags["disc_learning_rate"]
    assert gen.keys() == disc.keys()
    return {it: (gen[it], disc[it]) for it in gen}


def _disc_iteration(out):
    return ckpt.load_checkpoint(os.path.join(out, DISCRIMINATOR_FILE))["iteration"]


@pytest.mark.parametrize("task", ["jets", "hifigan"])
def test_gan_trainer_checkpoints_rates_resume_and_serving(task, tmp_path, monkeypatch, caplog):
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    conf = _conf()
    monkeypatch.setattr(train_main, "build_config", lambda _: copy.deepcopy(conf))
    n = STEPS_PER_EPOCH
    extra = ("--profile",) if task == "hifigan" else ()
    full = {}
    trainer = train_main.main(_argv(root, task, "full", 2 * n + 1, *extra),
                              on_trainer=_recorded(full))
    assert isinstance(trainer, GANTrainer) and trainer.task == task
    assert trainer.train_loader.epoch_batches() == n
    out = trainer.args.output_folder
    assert _names(out) == [ckpt.checkpoint_name("generator", 0, n),
                           ckpt.checkpoint_name("generator", 1, 2 * n),
                           ckpt.checkpoint_name("generator", 2, 2 * n + 1)]
    assert _disc_iteration(out) == 2 * n + 1
    if extra:
        assert os.listdir(os.path.join(out, "log", "profile"))
    assert sorted(full) == list(range(2 * n + 2))
    if task == "jets":  # the seeded init, then the configured scheme from one generator
        from viet_tts_torch.models.jets import JETS
        from viet_tts_torch.nn.utils import seeded_init_

        gp = conf["models"]["jets"]["generator_params"]
        assert gp["init_type"] == "xavier_uniform"
        gen = torch.Generator().manual_seed(trainer.seed)
        want = seeded_init_(JETS(trainer.n_symbols, N_MELS, gp, n_speakers=2), gen)
        apply_init_scheme(want, gp["init_type"], gen)
        for k, v in want.state_dict().items():
            assert torch.equal(full[0][k], v), k
    assert all(np.isfinite(v) for step in range(1, 2 * n + 2) for v in full[step][2].values())
    for first, last in zip(full[1][:2], full[2 * n + 1][:2]):  # both models train
        assert any(not torch.equal(v, last[k]) for k, v in first.items())

    # each step at its epoch's rates, for both models, as JAX's
    if task == "jets":
        opt = conf["train"]["jets"]["optimizer"]
        lrs = ((opt["gen_optim_conf"]["lr"], opt["gen_scheduler_conf"]["gamma"]),
               (opt["dis_optim_conf"]["lr"], opt["dis_scheduler_conf"]["gamma"]))
    else:
        task_conf = conf["train"]["hifigan"]
        lrs = ((task_conf["optimizer"]["lr"], task_conf["scheduler"]["gamma"]),) * 2

    def want_rates(it):
        return tuple(jax_exponential_lr(lr, gamma, it // n) for lr, gamma in lrs)

    logged = _rates(out)
    assert sorted(logged) == list(range(2 * n + 1))
    for it, rates in logged.items():
        assert rates == tuple(np.float32(r) for r in want_rates(it)), it
        assert full[it + 1][3] == want_rates(it), it

    # stopped inside epoch 1, then resumed by scan past its end: every step
    # the uninterrupted run's bit for bit, under the same names
    train_main.main(_argv(root, task, "part", n + 1, *extra))
    part = os.path.join(root, "part")
    assert _names(part) == [ckpt.checkpoint_name("generator", 0, n),
                            ckpt.checkpoint_name("generator", 1, n + 1)]
    assert _disc_iteration(part) == n + 1
    resumed_log = {}
    resumed = train_main.main(_argv(root, task, "part", 2 * n + 1, *extra),
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

    # -c an older checkpoint: the discriminator file is from a later
    # iteration, which the resume reports
    args = train_main.build_arguments(_argv(root, task, "part", 2 * n + 1, "-c", os.path.join(
        part, ckpt.checkpoint_name("generator", 1, 2 * n))))
    with caplog.at_level(logging.WARNING, logger="viet_tts_torch"):
        older = train_main.make_trainer(args, copy.deepcopy(conf))
    assert (older.epoch, older.iter) == (2, 2 * n)
    assert older.disc_state.lr == want_rates(2 * n)[1]
    assert f"from iteration {2 * n + 1}, the generator's from {2 * n}" in caplog.text

    _serve(task, trainer, root, conf)


def _serve(task, trainer, root, conf):
    """The output directory through the port's serving API on the CPU."""
    from viet_tts_torch.infer.api import OneStageTTS, TwoStageTTS, default_conf, save_checkpoint
    from tests.torch_parity import FS2_STATS, fs2_hparams, port_fs2

    out = trainer.args.output_folder
    texts = ["Hôm nay trời đẹp quá!", "Tôi yêu tiếng Việt."]
    if task == "jets":
        tts = OneStageTTS(out, max_mel_frames=48, device="cpu")
        served = tts.model
        waves = tts(texts, speaker="hcm_spk")
    else:
        hp = fs2_hparams()
        ac_conf = default_conf()
        ac_conf["models"]["fastspeech2"] = hp
        ac_conf["models"]["hifigan"] = conf["models"]["hifigan"]
        ac_dir = os.path.join(root, "acoustic")
        save_checkpoint(ac_dir, port_fs2(hp), ac_conf, speakers={"a": 0, "b": 1},
                        stats=FS2_STATS)
        tts = TwoStageTTS(ac_dir, out, max_mel_frames=48, device="cpu")
        served = tts.vocoder
        waves = tts(texts, speaker="b", accent=1)
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k
    assert len(waves) == 2
    for w in waves:
        assert w.ndim == 1 and w.dtype == np.float32 and np.isfinite(w).all()
        assert len(w) % HOP == 0


@pytest.mark.parametrize("task", ["jets", "hifigan"])
def test_gan_tasks_run_on_cuda_by_default_and_never_fall_back(task, tmp_path):
    root = str(tmp_path)
    build_dataset(root, n_utts=3)
    argv = _argv(root, task, "out", 1)[:-2]  # no --device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(argv + ["--config", os.path.join(REPO, "config")])
