"""The training slice as a whole: the port's JETS training forward and its
``make_jets_train_step`` against the JAX package's, on the same weights and
batch, with every dropout rate at 0 (dropout bits cannot match across
frameworks).

Weights: the port's seeded JETS goes to JAX through ``import_jets`` and
comes back through ``convert.jets_from_jax``; the tiny discriminator goes
through the JAX importer and back through ``convert.msmpd_from_jax``. So
the port's weight-norm (g, v) are flax's (scale, kernel) and gradients
compare tensor by tensor after the converters' layout maps.

Segments: ``segment_size`` equals T_mel, so every random start is 0 on
both sides (the JAX starts come from its "noise" rng stream, which the
port cannot reproduce).

The JAX side is one jitted function: the JAX step itself, and the
gradients of the losses assembled as ``train/gan.py:125-178`` assembles
them. The generator's gradient is taken against the discriminator that the
PORT's step updated (carried over to JAX), so that Adam's first,
sign-like step on near-zero discriminator gradients cannot blur the
comparison; the JAX step's own metrics after its update are compared at a
looser tolerance for the two terms that see the updated discriminator.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viet_tts_tpu.models.hifigan import (
    MelSpectrogramLoss as JaxMelLoss,
    MultiScaleMultiPeriodDiscriminator as JaxMSMPD,
    discriminator_adversarial_loss as jax_disc_loss,
    feature_match_loss as jax_fm_loss,
    generator_adversarial_loss as jax_gen_adv_loss,
)
from viet_tts_tpu.models.jets.loss import (
    forward_sum_with_prior as jax_fsum,
    variance_loss as jax_var_loss,
)
from viet_tts_tpu.ops import get_segments as jax_get_segments
from viet_tts_tpu.train.gan import make_jets_train_step as jax_make_step
from viet_tts_tpu.train.state import TrainState as JaxTrainState
from viet_tts_tpu.train.state import adamw_with_clip as jax_adamw

from viet_tts_torch.config import JETS_DROPOUT_KEYS
from viet_tts_torch.convert import jets_from_jax, msmpd_from_jax
from viet_tts_torch.models.hifigan import MelSpectrogramLoss
from viet_tts_torch.models.hifigan.discriminator import MultiScaleMultiPeriodDiscriminator
from viet_tts_torch.models.jets import JETS as TorchJETS
from viet_tts_torch.train.gan import METRICS, make_jets_train_step
from viet_tts_torch.train.state import TrainState

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

B, T_TEXT, T_MEL, HOP = 2, 9, 32, 256
LAMBDAS = {"adv": 1.0, "mel": 45.0, "fm": 2.0, "var": 1.0, "align": 2.0}
# SMALL_HP's acoustic half (flash attention) with TINY_HP's vocoder and
# fused_mrf off, as in training
TRAIN_HP = dict(SMALL_HP, generator_channels=16, generator_resblock_kernel_sizes=[3],
                generator_resblock_dilations=[[1, 3]], fused_mrf=False,
                segment_size=T_MEL, **dict.fromkeys(JETS_DROPOUT_KEYS, 0.0))


def _batch():
    rng = np.random.RandomState(0)
    return {
        "text": rng.randint(1, N_SYMBOLS, (B, T_TEXT)).astype(np.int32),
        "text_lengths": np.array([T_TEXT, T_TEXT - 3], np.int32),
        "feats": rng.randn(B, T_MEL, N_MELS).astype(np.float32),
        "feats_lengths": np.array([T_MEL, T_MEL - 7], np.int32),
        "pitch": rng.randn(B, T_MEL).astype(np.float32),
        "energy": rng.randn(B, T_MEL).astype(np.float32),
        "sids": np.zeros(B, np.int32),
        "speech": (rng.randn(B, T_MEL * HOP) * 0.1).astype(np.float32),
    }


def _jax_reference(jm, variables, dparams, dparams_for_gen, batch):
    """(JAX step metrics, its new batch_stats, the training forward's
    10-tuple, disc grads, gen grads against ``dparams_for_gen``)."""
    jd = JaxMSMPD(**TINY_DISC)
    mel_loss = JaxMelLoss(log_base=None)
    step = jax_make_step(jm, jd, mel_loss, LAMBDAS, hop=HOP)
    rng = jax.random.PRNGKey(0)

    def ref(params, stats, dparams, dparams_gen, batch):
        gen_state = JaxTrainState.create(apply_fn=jm.apply, params=params,
                                         tx=jax_adamw(2e-4), batch_stats=stats)
        disc_state = JaxTrainState.create(apply_fn=jd.apply, params=dparams,
                                          tx=jax_adamw(2e-4))
        new_gen, _, metrics = step(gen_state, disc_state, batch, rng)

        r = jax.random.fold_in(rng, 0)  # the step's rng at step 0

        def forward(p):
            return jm.apply(
                {"params": p, "batch_stats": stats}, text=batch["text"],
                text_lengths=batch["text_lengths"], feats=batch["feats"],
                feats_lengths=batch["feats_lengths"], pitch=batch["pitch"][..., None],
                energy=batch["energy"][..., None], sids=batch["sids"], train=True,
                rngs={"noise": r, "dropout": jax.random.fold_in(r, 1)},
                mutable=["batch_stats"])[0]

        outs = forward(params)
        seg = jax_get_segments(batch["speech"][:, None, :], outs[3] * HOP, T_MEL * HOP)
        seg = jnp.swapaxes(seg, 1, 2)
        wav_sg = jax.lax.stop_gradient(jnp.swapaxes(outs[0], 1, 2))

        def disc_loss(dp):
            real, fake = jax_disc_loss(jd.apply({"params": dp}, wav_sg),
                                       jd.apply({"params": dp}, seg))
            return real + fake

        def gen_loss(p):
            wav, bin_loss, log_p_attn, _, d_outs, ds, p_outs, ps, e_outs, es = forward(p)
            wav = jnp.swapaxes(wav, 1, 2)
            p_hat = jd.apply({"params": dparams_gen}, wav)
            p_real = jax.lax.stop_gradient(jd.apply({"params": dparams_gen}, seg))
            dur, pit, ene = jax_var_loss(d_outs, ds, p_outs, ps, e_outs, es,
                                         batch["text_lengths"])
            fsum = jax_fsum(log_p_attn, batch["text_lengths"], batch["feats_lengths"])
            return (mel_loss(wav, seg) * LAMBDAS["mel"]
                    + jax_gen_adv_loss(p_hat) * LAMBDAS["adv"]
                    + jax_fm_loss(p_hat, p_real) * LAMBDAS["fm"]
                    + (dur + pit + ene) * LAMBDAS["var"]
                    + (fsum + bin_loss) * LAMBDAS["align"])

        return (metrics, new_gen.batch_stats, outs, jax.grad(disc_loss)(dparams),
                jax.grad(gen_loss)(params))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax.jit(ref)(variables["params"], variables["batch_stats"], dparams,
                       dparams_for_gen, jb)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """The port's training forward and step and the JAX reference, once a
    session for all the workers (``session_cached``)."""
    return session_cached(tmp_path_factory, "jets_train_step", _step_case)


def _step_case():
    jm, variables = jax_jets(port_jets(TRAIN_HP), TRAIN_HP)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = TorchJETS(N_SYMBOLS, N_MELS, TRAIN_HP)
    model.load_state_dict(jets_from_jax(variables, TRAIN_HP), strict=True)
    dparams = flax_msmpd_params(port_tiny_disc().state_dict(), TINY_DISC["periods"])
    disc = MultiScaleMultiPeriodDiscriminator(**TINY_DISC)
    disc.load_state_dict(msmpd_from_jax(dparams), strict=True)
    batch = _batch()
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}

    # the training forward alone, on a copy (it updates the BatchNorm stats)
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
        "disc_grads": {n: p.grad.numpy().copy() for n, p in disc.named_parameters()},
        "gen_norm": gen_state.grad_norm.item(),
        "disc_norm": disc_state.grad_norm.item(),
        "bn": {n: b.numpy().copy() for n, b in model.named_buffers() if "running" in n},
    }
    disc_after = flax_msmpd_params(disc.state_dict(), TINY_DISC["periods"])
    ref = _jax_reference(jm, variables, dparams, disc_after, batch)
    return port, ref, variables


def test_training_forward_matches(step_case):
    """The 10-tuple of ``JETS.forward`` against ``JETS.__call__(train=True)``:
    durations exact, the waveform within 1e-4 (fp32 through the vocoder's
    4 stages), the rest within 1e-5."""
    port, (_, _, outs, _, _), _ = step_case
    names = ("wav", "bin_loss", "log_p_attn", "start_idxs", "d_outs", "ds", "p_outs",
             "ps", "e_outs", "es")
    got = dict(zip(names, port["fwd"]))
    want = dict(zip(names, outs))
    assert got["wav"].shape == want["wav"].shape == (B, 1, T_MEL * HOP)
    np.testing.assert_array_equal(got["ds"], want["ds"])
    np.testing.assert_array_equal(got["ds"].sum(1), _batch()["feats_lengths"])
    np.testing.assert_array_equal(got["start_idxs"], want["start_idxs"])
    assert np.abs(want["wav"]).max() > 1e-3
    np.testing.assert_allclose(got["wav"], want["wav"], atol=1e-4)
    for name in names[1:]:
        if name not in ("wav", "ds", "start_idxs"):
            np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-5,
                                       err_msg=name)


def _check_grads(got, want, norm_got, names):
    """Port gradients after clipping (optax's rule at 1.0) against the JAX
    gradients clipped by their own global norm, per tensor within
    1e-4 * max|g| + 1e-7 (the form of test_jets.py's remat test)."""
    want_norm = float(optax.global_norm(list(want.values())))
    np.testing.assert_allclose(norm_got, want_norm, rtol=1e-4)
    factor = min(1.0, 1.0 / want_norm)
    assert set(got) == set(names)
    for name in names:
        a, b = got[name], want[name] * factor
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-7, name


def test_step_gradients_match(step_case):
    port, (_, _, _, d_grads, g_grads), variables = step_case
    disc_want = msmpd_from_jax(d_grads)
    _check_grads(port["disc_grads"], {k: v.numpy() for k, v in disc_want.items()},
                 port["disc_norm"], list(disc_want))

    gen_want = jets_from_jax({"params": g_grads, "batch_stats": variables["batch_stats"]},
                             TRAIN_HP)
    gen_want = {k: v.numpy() for k, v in gen_want.items() if k in port["gen_grads"]}
    # flax's GRUCell has no hidden r/z biases: the port's are held out of
    # autograd, so their gradient is 0, as the converter's mapping of them
    H = gen_want["gst.ref_enc.gru.bias_hh_l0"].shape[0] // 3
    assert not port["gen_grads"]["gst.ref_enc.gru.bias_hh_l0"][: 2 * H].any()
    _check_grads(port["gen_grads"], gen_want, port["gen_norm"], list(gen_want))


def test_step_metrics_and_batch_stats_match(step_case):
    """The nine metrics of one step against the JAX step's: the terms
    before the discriminator update (and those that do not see it) at rel
    1e-4; adv, fm and their sum gen, after Adam's first sign-like step on
    the discriminator, at rel 1e-3. The GST BatchNorm running statistics
    after the step against JAX's batch_stats at 1e-6."""
    port, (metrics, stats, _, _, _), _ = step_case
    assert set(port["metrics"]) == set(metrics) == set(METRICS)
    for name in METRICS:
        rtol = 1e-3 if name in ("adv", "fm", "gen") else 1e-4
        np.testing.assert_allclose(port["metrics"][name], metrics[name], rtol=rtol,
                                   err_msg=name)
    ref = stats["gst"]["ref_enc"]
    for i in range(len(ref)):
        for stat, jname in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                port["bn"][f"gst.ref_enc.convs.{3 * i + 1}.{stat}"], ref[f"bn_{i}"][jname],
                atol=1e-6, err_msg=f"bn_{i} {stat}")


def test_fused_vocoder_refuses_autograd():
    """K2 has no backward (nor has the JAX package's fused stage): the
    fused route raises when autograd would need it, and runs under
    ``torch.no_grad()``."""
    gen = port_jets(dict(TRAIN_HP, fused_mrf=True)).generator
    z = torch.randn(1, 4, TRAIN_HP["adim"], generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="no backward"):
        gen(z)
    with torch.no_grad():
        assert gen(z).shape == (1, 4 * HOP, 1)
