"""The FS2 training slice as a whole: the port's teacher-forced
``FastSpeech2.forward`` and its ``make_fs2_train_step`` against the JAX
package's ``__call__(train=True)`` and ``make_fs2_train_step`` on the CPU,
on the same weights and batch, at a tiny width (``fs2_hparams``: conformer
blocks, ``attn_implementation: flash``, CVAE, Postnet, MAS-learned
durations).

Every dropout rate is 0 (dropout bits cannot match across frameworks): the
configured ones through the config, and the Postnet's fixed 0.5 on both
sides in the test (the port's module attribute; in JAX a flax method
interceptor that skips ``nn.Dropout``). The CVAE's noise cannot match
either: the JAX ``z``, ``mu`` and ``logvar`` are captured from
``CVAENet`` (``capture_intermediates``) and the same ``eps`` goes to the
port through ``cvae_eps``. The alignment prior is the beta-binomial one of
the data pipeline (``ops/prior.py``), for both.

Weights: the port's seeded model goes to JAX through ``import_fastspeech2``
and comes back through ``convert.fastspeech2_from_jax`` (the aligner
included), so gradients compare tensor by tensor through the converter's
layout maps. The cases: step 0 (soft expansion, bin loss off) and step 25
(hard expansion, bin loss on at 0.7, KL weight mid-build-up) with the
decoder on K4's route (48 frames), and step 25 with the decoder on K5's
route (520 frames).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viet_tts_tpu.models.fastspeech2.layers import CVAENet as JaxCVAENet
from viet_tts_tpu.models.fastspeech2.loss import FastSpeech2Loss as JaxLoss
from viet_tts_tpu.ops.prior import beta_binomial_prior as jax_prior
from viet_tts_tpu.train.state import TrainState as JaxTrainState
from viet_tts_tpu.train.state import adamw_with_clip as jax_adamw
from viet_tts_tpu.train.steps import make_fs2_train_step as jax_make_step
from viet_tts_torch.convert import fastspeech2_from_jax
from viet_tts_torch.models.fastspeech2.loss import FastSpeech2Loss
from viet_tts_torch.models.fastspeech2.model import FastSpeech2
from viet_tts_torch.ops.flash_xl_attention import xl3_padded_time
from viet_tts_torch.ops.prior import beta_binomial_prior
from viet_tts_torch.train.state import TrainState
from viet_tts_torch.train.steps import make_fs2_train_step, make_fs2_valid_step

from tests.test_fastspeech2 import LOSS_CONF
from tests.torch_parity import (  # noqa: F401 (one_torch_thread is autouse)
    FS2_STATS,
    N_MELS,
    N_SYMBOLS,
    fs2_hparams,
    jax_fs2,
    one_torch_thread,
    port_fs2,
    session_cached,
    t,
)

B, T_TEXT = 2, 9
MEL_ATOL = 1e-4  # fp32 through the conformer stacks and the postnet
ATOL = 1e-5
LOSS_RTOL = 1e-5
CASES = [(48, 0), (48, 25), (520, 25)]


def _hp():
    hp = fs2_hparams("flash")
    conf = hp["building_block"]["conformer"]
    conf["encoder_dropout"] = conf["decoder_dropout"] = 0.0
    hp["variance"]["variance_predictor"]["dropout"] = 0.0
    return hp


def _batch(T_mel):
    """The data pipeline's padded batch: zero-padded ids and mels, the
    beta-binomial prior in ``duration``, frame-level pitch and energy."""
    rng = np.random.RandomState(T_mel)
    text_lens = np.array([T_TEXT, T_TEXT - 3], np.int32)
    mel_lens = np.array([T_mel, T_mel - 8], np.int32)
    text = rng.randint(1, N_SYMBOLS, (B, T_TEXT)) * (np.arange(T_TEXT) < text_lens[:, None])
    feats = 0.5 * rng.randn(B, T_mel, N_MELS) * (np.arange(T_mel) < mel_lens[:, None])[..., None]
    prior = np.zeros((B, T_mel, T_TEXT), np.float32)
    for b in range(B):
        prior[b, : mel_lens[b], : text_lens[b]] = beta_binomial_prior(text_lens[b], mel_lens[b])
    return {
        "text": text.astype(np.int32), "text_lengths": text_lens,
        "feats": feats.astype(np.float32), "feats_lengths": mel_lens, "duration": prior,
        "pitch": rng.randn(B, T_mel).astype(np.float32),
        "energy": rng.randn(B, T_mel).astype(np.float32),
        "sids": np.array([0, 1], np.int32), "aids": np.array([1, 0], np.int32),
        "word_ids": np.zeros((B, T_TEXT), np.int32),
    }


def _no_dropout(next_fun, args, kwargs, context):
    """flax method interceptor: every ``nn.Dropout`` is the identity."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _model_args(batch):
    return {k: batch[k] for k in ("text", "text_lengths", "feats", "feats_lengths",
                                  "duration", "pitch", "energy", "sids", "aids")}


def _jax_reference(jm):
    """A jitted function (params, batch_stats, batch, step) -> (the JAX
    step's metrics and new batch_stats, the training forward's outputs, the
    CVAE's (z, mu, logvar) pairs, the step's gradients)."""
    train_step = jax_make_step(jm, JaxLoss(LOSS_CONF))
    rng = jax.random.PRNGKey(0)

    def ref(params, stats, batch, step):
        state = JaxTrainState.create(apply_fn=jm.apply, params=params, tx=jax_adamw(2e-4),
                                     batch_stats=stats).replace(step=step)
        new_state, metrics = train_step(state, batch, rng)
        # the step's own rng streams (steps.py:train_step)
        drop_rng, rep_rng = jax.random.split(jax.random.fold_in(rng, step))
        out, inter = jm.apply(
            {"params": params, "batch_stats": stats}, **_model_args(batch), step=step,
            train=True, rngs={"dropout": drop_rng, "reparam": rep_rng},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, JaxCVAENet))
        cvae = inter["intermediates"]["speaker_emb"]["cvae"]["__call__"][0]
        grads, _ = jax.grad(train_step.micro_loss, has_aux=True)(
            params, batch, stats, step, drop_rng, rep_rng)
        return metrics, new_state.batch_stats, out, cvae, grads

    jitted = jax.jit(ref)

    def run(variables, batch, step):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with fnn.intercept_methods(_no_dropout):
            out = jitted(variables["params"], variables["batch_stats"], jb,
                         jnp.asarray(step, jnp.int32))
        return jax.tree_util.tree_map(np.asarray, out)

    return run


@pytest.fixture(scope="module")
def jax_model():
    hp = _hp()
    jm, variables = jax_fs2(port_fs2(hp), hp)
    return hp, _jax_reference(jm), jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module", params=CASES, ids=[f"t{m}-step{s}" for m, s in CASES])
def step_case(request, tmp_path_factory):
    """The port's training forward and step and the JAX step at one case,
    once a session for all the workers (``session_cached``)."""
    T_mel, step = request.param
    return session_cached(tmp_path_factory, f"fs2_train_step_t{T_mel}_{step}",
                          lambda: _step_case(T_mel, step, request.getfixturevalue("jax_model")))


def _step_case(T_mel, step, jax_model):
    hp, reference, variables = jax_model
    batch = _batch(T_mel)
    metrics, stats, (outs, extra), cvae, grads = reference(variables, batch, step)
    z_acc, _, z_spk, _, (mu_acc, logvar_acc, mu_spk, logvar_spk) = cvae
    eps = tuple(torch.from_numpy((z - mu) / np.exp(0.5 * lv))
                for z, mu, lv in ((z_acc, mu_acc, logvar_acc), (z_spk, mu_spk, logvar_spk)))

    model = FastSpeech2(N_SYMBOLS, N_MELS, hp, FS2_STATS, n_speakers=2)
    model.load_state_dict(fastspeech2_from_jax(variables, hp), strict=True)
    model.postnet.dropout.p = 0.0
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}
    # the training forward alone, on a copy (it updates the BatchNorm stats)
    fwd_model = copy.deepcopy(model).train()
    with torch.no_grad():
        fwd = fwd_model(**_model_args(tb), step=step, cvae_eps=eps)
    state = TrainState.create(model, lr=2e-4, betas=(0.8, 0.99), eps=1e-9,
                              weight_decay=0.0, grad_clip=1.0)
    state.step = step
    train_step = make_fs2_train_step(model, FastSpeech2Loss(LOSS_CONF))
    state, port_metrics = train_step(state, tb, torch.Generator().manual_seed(0),
                                     cvae_eps=eps)
    port = {
        "fwd": fwd,
        "metrics": {k: v.item() for k, v in port_metrics.items()},
        "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
        "norm": state.grad_norm.item(),
        "bn": {n: b.numpy().copy() for n, b in model.named_buffers() if "running" in n},
        "model": model,
    }
    ref = dict(metrics=metrics, stats=stats, outs=outs, extra=extra, grads=grads,
               cvae=cvae)
    return T_mel, step, hp, variables, batch, port, ref


def test_training_forward_matches(step_case):
    """The 12-tuple and (ds, ps, es) of the port's teacher-forced forward
    against the JAX ``__call__(train=True)``: the mels within 1e-4, the hard
    alignment and the durations exact (the durations sum to each mel
    length), the rest within 1e-5."""
    T_mel, step, _, _, batch, port, ref = step_case
    (outs, post, log_d, p_outs, e_outs, _, _, _, _, probs, attn, sid), (ds, ps, es) = \
        port["fwd"]
    (j_outs, j_post, j_log_d, j_p, j_e, _, _, _, _, j_probs, j_attn, j_sid) = ref["outs"]
    j_ds, j_ps, j_es = ref["extra"]
    assert outs.shape == (B, T_mel, N_MELS)
    assert np.abs(j_outs).max() > 1e-2
    np.testing.assert_allclose(outs.numpy(), j_outs, atol=MEL_ATOL)
    np.testing.assert_allclose(post.numpy(), j_post, atol=MEL_ATOL)
    np.testing.assert_array_equal(attn[1].numpy(), j_attn[1])
    np.testing.assert_array_equal(ds.numpy(), j_ds)
    np.testing.assert_array_equal(ds.numpy().sum(1), batch["feats_lengths"])
    pairs = [("log_d", log_d, j_log_d), ("pitch", p_outs, j_p), ("energy", e_outs, j_e),
             ("soft attention", attn[0], j_attn[0]), ("ps", ps, j_ps), ("es", es, j_es),
             ("speaker", sid, j_sid), *((f"cvae {i}", a, b) for i, (a, b)
                                        in enumerate(zip(probs, j_probs)))]
    for name, a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL, err_msg=name)
    np.testing.assert_allclose(attn[3].numpy(), j_attn[3], rtol=LOSS_RTOL, atol=1e-4,
                               err_msg="log attention")


def test_step_losses_match(step_case):
    """Every loss of the step and their total against the JAX step's
    metrics within rel 1e-5; bin is 0 before its enable step and on after."""
    _, step, _, _, _, port, ref = step_case
    assert set(port["metrics"]) == set(ref["metrics"])
    for name, want in ref["metrics"].items():
        np.testing.assert_allclose(port["metrics"][name], want, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=name)
    assert (port["metrics"]["bin"] == 0.0) == (step < LOSS_CONF["binarization_loss_enable_steps"])


def test_step_gradients_and_batch_stats_match(step_case):
    """Each parameter's gradient after optax's clipping rule against the
    JAX gradient clipped by its own global norm, per tensor within
    1e-4 * max|g| + 1e-7; the BatchNorm running statistics after the step
    against the JAX step's batch_stats within 1e-6."""
    _, _, hp, variables, _, port, ref = step_case
    want_norm = float(optax.global_norm(jax.tree_util.tree_leaves(ref["grads"])))
    np.testing.assert_allclose(port["norm"], want_norm, rtol=1e-4)
    factor = min(1.0, 1.0 / want_norm)
    want = fastspeech2_from_jax({"params": ref["grads"], "batch_stats": variables["batch_stats"]},
                                hp)
    want = {k: v.numpy() for k, v in want.items() if k in port["grads"]}
    assert set(want) == set(port["grads"])
    # flax's GRUCell has no hidden r / z biases: the port holds its own out
    # of autograd, so their gradient is 0, as the converter maps them
    H = want["speaker_emb.encoder.gru.bias_hh_l0"].shape[0] // 3
    assert not port["grads"]["speaker_emb.encoder.gru.bias_hh_l0"][: 2 * H].any()
    for name, g in want.items():
        a, b = port["grads"][name], g * factor
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-7, name
    stats = fastspeech2_from_jax({"params": variables["params"], "batch_stats": ref["stats"]},
                                 hp)
    for name, got in port["bn"].items():
        np.testing.assert_allclose(got, stats[name].numpy(), atol=1e-6, err_msg=name)


def test_valid_step_and_routes(step_case):
    """The decoder ran on the route of its length (K4's up to 512 padded
    frames, K5's past it), and the validation step gives the feat losses of
    the eval-mode forward, finite."""
    T_mel, _, _, _, batch, port, _ = step_case
    assert (xl3_padded_time(T_mel) <= 512) == (T_mel == 48)
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None) for k, v in batch.items()}
    model = port["model"]
    losses = make_fs2_valid_step(model, FastSpeech2Loss(LOSS_CONF))(
        TrainState.create(model), tb)
    assert set(losses) == {"feat", "feat_postnet"}
    assert all(np.isfinite(v.item()) for v in losses.values())


def test_prior_matches_the_jax_pipeline():
    """The port's beta-binomial prior against the JAX package's (scipy's
    betabinom) at the smoke's shape and a small one, rel 1e-5."""
    for P, M, w in ((64, 1008, 1.0), (7, 30, 0.5)):
        np.testing.assert_allclose(beta_binomial_prior(P, M, w), jax_prior(P, M, w),
                                   rtol=1e-5, atol=1e-12)


def test_mixed_precision_and_grad_accum_steps_run():
    """One bf16 mixed-precision step (fp32 master weights and BatchNorm
    statistics, fp32 losses) and one step of two accumulated micro-batches
    with the configured dropouts on: finite losses, fp32 state."""
    hp = fs2_hparams("flash")
    model = port_fs2(hp)
    tb = {k: t(v, torch.long if v.dtype == np.int32 else None)
          for k, v in _batch(48).items()}
    for kw in (dict(mixed_precision=True), dict(grad_accum=2)):
        state = TrainState.create(model, lr=2e-4)
        step = make_fs2_train_step(model, FastSpeech2Loss(LOSS_CONF), **kw)
        state, metrics = step(state, tb, torch.Generator().manual_seed(1))
        assert all(np.isfinite(v.item()) and v.dtype == torch.float32
                   for v in metrics.values()), kw
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(b.dtype in (torch.float32, torch.int64) for b in model.buffers())
        assert state.step == 1 and np.isfinite(state.grad_norm.item())
