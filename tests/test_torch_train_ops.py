"""The training slice's ops, losses, discriminator and optimizer in the
port against their JAX counterparts, on the same numpy inputs (and, for
the discriminator, the same weights carried through the JAX package's
``import_msmpd_discriminator`` and back through
``viet_tts_torch.convert.msmpd_from_jax``).

Tolerance 1e-5 (fp32 on both sides, summed in other orders) unless a test
says why it allows more; durations and segments exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viet_tts_tpu.models.hifigan import loss as jax_loss
from viet_tts_tpu.models.hifigan.discriminator import (
    MultiScaleMultiPeriodDiscriminator as JaxMSMPD,
)
from viet_tts_tpu.models.jets import loss as jax_jets_loss
from viet_tts_tpu.ops import duration as jax_duration
from viet_tts_tpu.ops import forward_sum as jax_fsum
from viet_tts_tpu.ops import mas as jax_mas
from viet_tts_tpu.ops import segments as jax_segments
from viet_tts_tpu.train import state as jax_state

from viet_tts_torch.convert import msmpd_from_jax
from viet_tts_torch.dsp import stft
from viet_tts_torch.models.hifigan import loss
from viet_tts_torch.models.hifigan.discriminator import MultiScaleMultiPeriodDiscriminator
from viet_tts_torch.models.jets import loss as jets_loss
from viet_tts_torch.ops import duration, forward_sum, mas, segments
from viet_tts_torch.train import state

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import TINY_DISC, flax_msmpd_params, port_tiny_disc, t

ATOL = 1e-5

# (viet_tts_tpu.dsp exports a function named stft over the module's name)
jax_stft = importlib.import_module("viet_tts_tpu.dsp.stft")


def _alignment_case(seed=0):
    """log-scores with ties (integer values) and lengths below the maximum."""
    rng = np.random.RandomState(seed)
    B, T_mel, T_text = 3, 24, 9
    scores = rng.randint(-4, 1, (B, T_mel, T_text)).astype(np.float32)
    scores[1] += rng.randn(T_mel, T_text).astype(np.float32)
    text_lens = np.array([9, 6, 3], np.int32)
    mel_lens = np.array([24, 17, 5], np.int32)
    return scores, text_lens, mel_lens


def test_viterbi_decode_exact():
    scores, text_lens, mel_lens = _alignment_case()
    ds_j, bin_j = jax_mas.viterbi_decode(jnp.asarray(scores), jnp.asarray(text_lens),
                                         jnp.asarray(mel_lens))
    path_j, _ = jax_mas.monotonic_alignment(jnp.asarray(scores), jnp.asarray(text_lens),
                                            jnp.asarray(mel_lens))
    ds_t, bin_t = mas.viterbi_decode(t(scores), t(text_lens), t(mel_lens))
    path_t, _ = mas.monotonic_alignment(t(scores), t(text_lens), t(mel_lens))
    np.testing.assert_array_equal(path_t.numpy(), np.asarray(path_j))
    np.testing.assert_array_equal(ds_t.numpy(), np.asarray(ds_j))
    np.testing.assert_array_equal(ds_t.numpy().sum(1), mel_lens)
    np.testing.assert_allclose(bin_t.item(), float(bin_j), rtol=1e-6)


def test_average_by_duration_matches():
    rng = np.random.RandomState(1)
    ds = np.array([[3, 0, 2, 4, 1], [2, 2, 5, 0, 0]], np.int32)
    xs = rng.randn(2, 12).astype(np.float32)
    lens, flens = np.array([5, 3], np.int32), np.array([10, 8], np.int32)
    want = jax_duration.average_by_duration(*(jnp.asarray(a) for a in (ds, xs, lens, flens)))
    got = duration.average_by_duration(t(ds), t(xs), t(lens), t(flens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_segments_match():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 40).astype(np.float32)
    starts = np.array([0, 13, 32], np.int32)
    want = jax_segments.get_segments(jnp.asarray(x), jnp.asarray(starts), 8)
    np.testing.assert_array_equal(segments.get_segments(t(x), t(starts), 8).numpy(),
                                  np.asarray(want))
    lengths = np.array([40, 20, 5], np.int32)
    seg, got_starts = segments.get_random_segments(t(x), t(lengths), 8,
                                                   start_idxs=t(starts))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(want))
    draws = [segments.get_random_segments(t(x), t(lengths), 8,
                                          torch.Generator().manual_seed(s))[1]
             for s in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    for d in draws:
        assert (d >= 0).all() and (d <= torch.clamp(t(lengths) - 8, min=0)).all()


def test_beta_binomial_prior_and_forward_sum_loss():
    """The prior, the forward-sum CTC and its gradient against ``jax.grad``.
    The prior's lgamma values reach ~40 in magnitude, so it is compared at
    a relative 1e-5."""
    rng = np.random.RandomState(3)
    B, T_feats, T_text = 3, 20, 7
    ilens, olens = np.array([7, 5, 2], np.int32), np.array([20, 13, 6], np.int32)
    logits = rng.randn(B, T_feats, T_text).astype(np.float32)
    log_p = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))

    prior_j = np.asarray(jax_fsum.beta_binomial_log_prior(
        jnp.asarray(ilens), jnp.asarray(olens), T_text, T_feats))
    prior_t = forward_sum.beta_binomial_log_prior(t(ilens), t(olens), T_text, T_feats)
    assert not prior_t.requires_grad
    np.testing.assert_allclose(prior_t.numpy(), prior_j, rtol=1e-5, atol=ATOL)

    val_j, grad_j = jax.value_and_grad(
        lambda x: jax_jets_loss.forward_sum_with_prior(x, jnp.asarray(ilens),
                                                       jnp.asarray(olens)))(jnp.asarray(log_p))
    x = t(log_p).requires_grad_()
    val_t = jets_loss.forward_sum_with_prior(x, t(ilens), t(olens))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), atol=ATOL)
    # without the prior too
    val_j = jax_fsum.jets_forward_sum_loss(jnp.asarray(log_p), jnp.asarray(ilens),
                                           jnp.asarray(olens))
    val_t = forward_sum.jets_forward_sum_loss(t(log_p), t(ilens), t(olens))
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)


def test_variance_loss_matches():
    rng = np.random.RandomState(4)
    B, N = 2, 6
    arrs = [rng.randn(B, N).astype(np.float32),
            rng.randint(0, 5, (B, N)).astype(np.float32)]
    arrs += [rng.randn(B, N, 1).astype(np.float32) for _ in range(4)]
    ilens = np.array([6, 4], np.int32)
    want = jax_jets_loss.variance_loss(*(jnp.asarray(a) for a in arrs), jnp.asarray(ilens))
    got = jets_loss.variance_loss(*(t(a) for a in arrs), t(ilens))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


@pytest.mark.parametrize("log_base", [None, 10.0])
def test_log_mel_and_mel_loss_match(log_base):
    """The filterbank and window (own copies), the centred STFT, the
    log-mel, and the L1 mel loss with its gradient. Log-mels of ~-23
    (silence clamps) are compared at a relative 1e-5."""
    rng = np.random.RandomState(5)
    y = (rng.randn(2, 4096) * 0.1).astype(np.float32)
    y_hat = (rng.randn(2, 4096) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(stft.hann_window(1024), jax_stft.hann_window(1024))
    np.testing.assert_array_equal(stft.mel_filterbank(22050, 1024, 80),
                                  jax_stft.mel_filterbank(22050, 1024, 80))
    want = np.asarray(jax_stft.log_mel_spectrogram(jnp.asarray(y), log_base=log_base))
    got = stft.log_mel_spectrogram(t(y), log_base=log_base).numpy()
    assert got.shape == want.shape == (2, 17, 80)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)

    jl = jax_loss.MelSpectrogramLoss(log_base=log_base)
    val_j, grad_j = jax.value_and_grad(lambda a: jl(a, jnp.asarray(y)))(jnp.asarray(y_hat))
    x = t(y_hat).requires_grad_()
    val_t = loss.MelSpectrogramLoss(log_base=log_base)(x, t(y))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    scale = np.abs(np.asarray(grad_j)).max()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), atol=1e-4 * scale)


def test_adversarial_and_feature_match_losses_match():
    rng = np.random.RandomState(6)
    shapes = [[(2, 30, 4), (2, 15, 8), (2, 15)], [(2, 10, 2, 4), (2, 20)]]
    fake = [[rng.randn(*s).astype(np.float32) for s in d] for d in shapes]
    real = [[rng.randn(*s).astype(np.float32) for s in d] for d in shapes]
    jf = [[jnp.asarray(a) for a in d] for d in fake]
    jr = [[jnp.asarray(a) for a in d] for d in real]
    tf = [[t(a) for a in d] for d in fake]
    tr = [[t(a) for a in d] for d in real]
    np.testing.assert_allclose(loss.generator_adversarial_loss(tf).item(),
                               float(jax_loss.generator_adversarial_loss(jf)), rtol=1e-6)
    for g, w in zip(loss.discriminator_adversarial_loss(tf, tr),
                    jax_loss.discriminator_adversarial_loss(jf, jr)):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)
    np.testing.assert_allclose(loss.feature_match_loss(tf, tr).item(),
                               float(jax_loss.feature_match_loss(jf, jr)), rtol=1e-6)


def test_msmpd_forward_matches_with_converted_weights():
    """Every feature map of the tiny MSMPD (grouped scale convs with SAME
    padding, period folding with a reflect pad, since 2050 % 3 != 0), with
    the weights carried port -> JAX importer -> ``msmpd_from_jax`` -> port,
    so that the port's (g, v) are flax's (scale, kernel)."""
    params = flax_msmpd_params(port_tiny_disc().state_dict(), TINY_DISC["periods"])
    disc = MultiScaleMultiPeriodDiscriminator(**TINY_DISC)
    disc.load_state_dict(msmpd_from_jax(params), strict=True)
    x = (np.random.RandomState(7).randn(2, 2050, 1) * 0.3).astype(np.float32)
    jd = JaxMSMPD(**TINY_DISC)
    want = jax.jit(jd.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = disc(t(x))
    assert len(got) == len(want) == 1 + len(TINY_DISC["periods"])
    for gd, wd in zip(got, want):
        assert len(gd) == len(wd)
        for g, w in zip(gd, wd):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_adamw_with_clip_matches_optax():
    """Three steps on the same numpy gradients, the second clipped by the
    global norm, with a learning-rate change between steps
    (``set_learning_rate`` / ``exponential_lr``)."""
    rng = np.random.RandomState(8)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for scale in (0.05, 3.0, 0.1):  # global norms ~0.2, ~12 (clipped), ~0.4
        grads.append({k: (rng.randn(*s) * scale).astype(np.float32)
                      for k, s in shapes.items()})
    lrs = [2e-4, state.exponential_lr(2e-4, 0.999875, 1), state.exponential_lr(2e-4, 0.999875, 2)]
    assert lrs[1] == jax_state.exponential_lr(2e-4, 0.999875, 1)

    tx = jax_state.adamw_with_clip(lrs[0])
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    st = jax_state.TrainState.create(apply_fn=None, params=jparams, tx=tx)

    params = [torch.nn.Parameter(t(init[k])) for k in shapes]
    ts = state.TrainState.create(torch.nn.ParameterList(params), lr=lrs[0])
    for step, (lr, g) in enumerate(zip(lrs, grads)):
        st = jax_state.set_learning_rate(st, lr)
        st = st.apply_gradients(grads={k: jnp.asarray(v) for k, v in g.items()})
        state.set_learning_rate(ts, lr)
        for p, k in zip(params, shapes):
            p.grad = t(g[k])
        norm = ts.apply_gradients()
        want_norm = float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        assert (want_norm > 1.0) == (step == 1)
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(st.params[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=f"step {step} {k}")
    assert ts.step == int(st.step) == 3 and ts.lr == lrs[-1]
