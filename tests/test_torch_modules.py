"""Each module of the JETS slice in the port against its flax counterpart,
on the same weights (port -> ``import_jets``) and the same numpy inputs.

Tolerances: fp32 on both sides, summed in different orders; 1e-5 for the
transformer and predictor blocks, 1e-4 where the HiFi-GAN's 4 stages and
~60 convs accumulate error on audio-scale values.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viet_tts_tpu.nn.espnet_transformer import (
    interleaved_sinusoid_table as jax_sinusoid_table,
)
from viet_tts_tpu.nn.utils import (
    pad_mask_from_lengths as jax_pad_mask,
    valid_mask_from_lengths as jax_valid_mask,
)
from viet_tts_tpu.ops import duration as jax_duration
from viet_tts_tpu.train.torch_import import import_jets
from viet_tts_torch.convert import jets_from_jax, reference_state_dict
from viet_tts_torch.models.jets import JETS as TorchJETS
from viet_tts_torch.nn.espnet_transformer import interleaved_sinusoid_table
from viet_tts_torch.nn.utils import pad_mask_from_lengths, valid_mask_from_lengths
from viet_tts_torch.ops import duration

from tests.torch_parity import N_MELS, N_SYMBOLS, SMALL_HP, jax_jets, port_jets, t
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
VOCODER_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    tm = port_jets()
    jm, variables = jax_jets(tm)
    return tm, jm, variables


def _jax_call(jm, variables, fn, *args):
    """Run ``fn(bound_module, *args)`` on the JAX model, jitted."""
    return np.asarray(jax.jit(functools.partial(jm.apply, method=fn))(
        variables, *[jnp.asarray(a) for a in args]))


def _lengths_case(B=3, T=20, seed=0):
    rng = np.random.RandomState(seed)
    lens = np.array([T, T - 7, 0][:B], np.int32)
    x = rng.randn(B, T, SMALL_HP["adim"]).astype(np.float32)
    return x, lens


def test_masks_and_sinusoid_table():
    lens = np.array([5, 0, 9], np.int32)
    np.testing.assert_array_equal(
        pad_mask_from_lengths(t(lens), 9).numpy(), np.asarray(jax_pad_mask(jnp.asarray(lens), 9)))
    np.testing.assert_array_equal(
        valid_mask_from_lengths(t(lens), 9).numpy(), np.asarray(jax_valid_mask(jnp.asarray(lens), 9)))
    np.testing.assert_array_equal(interleaved_sinusoid_table(77, 32),
                                  jax_sinusoid_table(77, 32))


@pytest.mark.parametrize("attn", ["flash", "shift"])
def test_decoder_stack_matches(models, attn):
    """Decoder stack (no embedding) with a ragged and a fully padded row:
    flash gives that row uniform attention, shift gives it zeros; both
    must match their JAX path."""
    tm, jm, variables = models
    hp = dict(SMALL_HP, attn_implementation=attn)
    jm = type(jm)(n_symbols=N_SYMBOLS, n_channels=N_MELS, hparams=hp)
    tm2 = TorchJETS(N_SYMBOLS, N_MELS, hp)
    tm2.load_state_dict(tm.state_dict())
    tm2.eval()  # a new module is in training mode, where dropout acts
    x, lens = _lengths_case()
    valid = np.arange(x.shape[1])[None] < lens[:, None]
    want = _jax_call(jm, variables,
                     lambda m, x, v: m.decoder(x, v, train=False)[0], x, valid)
    with torch.no_grad():
        got, _ = tm2.decoder(t(x), t(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_encoder_stack_matches(models):
    tm, jm, variables = models
    rng = np.random.RandomState(1)
    ids = rng.randint(1, N_SYMBOLS, (2, 13)).astype(np.int32)
    lens = np.array([13, 9], np.int32)
    ids[1, 9:] = 0
    valid = np.arange(13)[None] < lens[:, None]
    want = _jax_call(jm, variables,
                     lambda m, x, v: m.encoder(x, v, train=False)[0], ids, valid)
    with torch.no_grad():
        got, _ = tm.encoder(t(ids, torch.long), t(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_style_encoder_matches(models):
    """GST: Conv2d + BatchNorm (running stats) stack, the (C, F') flatten,
    the GRU, the style-token attention."""
    tm, jm, variables = models
    feats = np.random.RandomState(2).randn(2, 64, N_MELS).astype(np.float32)
    want = _jax_call(jm, variables, lambda m, f: m.gst(f, train=False), feats)
    with torch.no_grad():
        got = tm.gst(t(feats))
    assert got.shape == (2, SMALL_HP["adim"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_predictors_and_embeds_match(models):
    tm, jm, variables = models
    x, lens = _lengths_case(B=2, T=11, seed=3)
    pad = np.arange(11)[None] >= lens[:, None]

    def jax_fn(m, x, pad):
        return (m.duration_predictor(x, pad, train=False),
                m.pitch_predictor(x, pad, train=False),
                m.energy_predictor(x, pad, train=False),
                m.pitch_embed(x[..., :1], train=False),
                m.energy_embed(x[..., 1:2], train=False))

    outs = jax.jit(functools.partial(jm.apply, method=jax_fn))(
        variables, jnp.asarray(x), jnp.asarray(pad))
    with torch.no_grad():
        got = (tm.duration_predictor(t(x), t(pad)),
               tm.pitch_predictor(t(x), t(pad)),
               tm.energy_predictor(t(x), t(pad)),
               tm.pitch_embed(t(x[..., :1])),
               tm.energy_embed(t(x[..., 1:2])))
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_alignment_module_matches(models):
    tm, jm, variables = models
    rng = np.random.RandomState(4)
    text = rng.randn(2, 7, SMALL_HP["adim"]).astype(np.float32)
    feats = rng.randn(2, 15, N_MELS).astype(np.float32)
    pad = np.arange(7)[None] >= np.array([7, 4])[:, None]
    want = _jax_call(jm, variables, lambda m, a, b, p: m.alignment_module(a, b, p),
                     text, feats, pad)
    with torch.no_grad():
        got = tm.alignment_module(t(text), t(feats), t(pad))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_duration_ops_match():
    rng = np.random.RandomState(5)
    hs = rng.randn(2, 6, 8).astype(np.float32)
    ds = np.array([[2, 0, 3, 1, 4, 0], [1, 1, 0, 0, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        duration.duration_to_index(t(ds), 12).numpy(),
        np.asarray(jax_duration.duration_to_index(jnp.asarray(ds), 12)))
    np.testing.assert_allclose(
        duration.length_regulator(t(hs), t(ds), 12).numpy(),
        np.asarray(jax_duration.length_regulator(jnp.asarray(hs), jnp.asarray(ds), 12)),
        atol=ATOL)
    h_masks = np.arange(12)[None] < np.array([10, 2])[:, None]
    d_masks = np.arange(6)[None] < np.array([6, 2])[:, None]
    dsf = ds.astype(np.float32) + rng.rand(2, 6).astype(np.float32)
    np.testing.assert_allclose(
        duration.gaussian_upsample(t(hs), t(dsf), t(h_masks), t(d_masks)).numpy(),
        np.asarray(jax_duration.gaussian_upsample(
            jnp.asarray(hs), jnp.asarray(dsf), jnp.asarray(h_masks), jnp.asarray(d_masks))),
        atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_generator_matches(models, fused):
    """HiFi-GAN V1 with weight-normed convs and transposed convs: the port's
    layer path, and its fused-MRF route (K2's plain version on the CPU),
    against the JAX layer path."""
    tm, jm, variables = models
    hp = dict(SMALL_HP, fused_mrf=False)
    jm = type(jm)(n_symbols=N_SYMBOLS, n_channels=N_MELS, hparams=hp)
    tm.generator.fused_mrf = fused
    try:
        zs = np.random.RandomState(6).randn(2, 9, SMALL_HP["adim"]).astype(np.float32)
        want = _jax_call(jm, variables, lambda m, z: m.decode_hidden(z), zs)
        got = tm.decode_hidden(t(zs)).numpy()
    finally:
        tm.generator.fused_mrf = True
    assert got.shape == want.shape == (2, 9 * 256)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=VOCODER_ATOL)


def _fold_gru_biases(sd):
    """flax's GRUCell has no hidden r/z biases: the importer folds torch's
    into the input biases, so compare the GRU in that canonical form."""
    sd = dict(sd)
    for key in [k for k in sd if ".bias_hh_l" in k]:
        ih = key.replace(".bias_hh_l", ".bias_ih_l")
        H = sd[key].shape[0] // 3
        b_ih, b_hh = sd[ih].clone(), sd[key].clone()
        b_ih[: 2 * H] += b_hh[: 2 * H]
        b_hh[: 2 * H] = 0.0
        sd[ih], sd[key] = b_ih, b_hh
    return sd


def test_convert_round_trip_keeps_effective_weights(models):
    """port -> import_jets -> jets_from_jax -> port keeps every effective
    weight and every other tensor."""
    tm, _, variables = models
    back = jets_from_jax(variables, SMALL_HP)
    want = _fold_gru_biases(reference_state_dict(tm.state_dict()))
    got = _fold_gru_biases(reference_state_dict(back))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].float().numpy(), want[key].float().numpy(),
                                   atol=1e-6, err_msg=key)
    # and the JAX importer reads the port's own names back to the same tree
    again = import_jets(got, SMALL_HP, n_channels=N_MELS)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6),
        again["params"], variables["params"])
