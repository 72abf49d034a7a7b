"""The JETS espnet conformer stacks, module by module: the port's
``nn/espnet_conformer.py`` and ``ops/espnet_attention.py`` against the JAX
package's flax modules and functions, both rel-pos flavours ("latest",
"legacy") and the three attention routes (shift, dense, flash), at d_model
64, 4 heads, 2 blocks, T = 32, ragged lengths.

Weights are drawn in the port from a seed and carried to flax through the
JAX package's importer (``_espnet_conformer_stack_params``), so the
parameter names are held too. On the CPU the port's flash routes run the
plain versions of K7 (latest) and K6 (legacy), the JAX modules their dense
lowering. Dropout is 0 wherever outputs are compared (the bits cannot match
across frameworks).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viet_tts_tpu.nn import espnet_conformer as jec
from viet_tts_tpu.nn.espnet_transformer import interleaved_sinusoid_table
from viet_tts_tpu.ops import espnet_attention as jea
from viet_tts_tpu.train.torch_import import _espnet_conformer_stack_params
from viet_tts_torch.nn import espnet_conformer as tec
from viet_tts_torch.nn.utils import seeded_init_
from viet_tts_torch.ops import espnet_attention as tea

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

B, T, DM, HEADS, UNITS, BLOCKS = 3, 32, 64, 4, 96, 2
N_SYM = 20
LENS = (T, 23, 9)
ATOL = 1e-4
FLAVOURS = ["latest", "legacy"]
ROUTES = ["shift", "dense", "flash"]


def _valid(lens=LENS):
    return np.arange(T)[None] < np.asarray(lens)[:, None]


def _port_encoder(legacy, route, n_symbols=N_SYM, kernel_size=7, ffn_type="conv1d",
                  seed=0):
    """The port's encoder with seeded weights and BatchNorm statistics."""
    gen = torch.Generator().manual_seed(seed)
    enc = tec.EspnetConformerEncoder(
        DM, HEADS, UNITS, BLOCKS, n_symbols=n_symbols, kernel_size=kernel_size,
        dropout=0.0, positional_dropout=0.0, attn_dropout=0.0, ffn_type=ffn_type,
        ffn_kernel=3 if ffn_type == "conv1d" else 1, legacy=legacy,
        attn_implementation=route)
    seeded_init_(enc, gen)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return enc.eval()


def _flax_encoder(port, legacy, route, n_symbols=N_SYM, kernel_size=7, ffn_type="conv1d"):
    """(flax EspnetConformerEncoder, its variables) holding ``port``'s
    weights, through the JAX package's importer."""
    sd = {f"enc.{k}": v.clone() for k, v in port.state_dict().items()}
    params, stats = _espnet_conformer_stack_params(sd, "enc", BLOCKS, n_symbols is not None,
                                                   ffn_type)
    module = jec.EspnetConformerEncoder(
        DM, HEADS, UNITS, BLOCKS, n_symbols=n_symbols, kernel_size=kernel_size,
        dropout=0.0, positional_dropout=0.0, attn_dropout=0.0, ffn_type=ffn_type,
        ffn_kernel=3 if ffn_type == "conv1d" else 1, legacy=legacy,
        attn_implementation=route)
    return module, {"params": params, "batch_stats": stats}


def _table(legacy):
    return (interleaved_sinusoid_table(T, DM) if legacy
            else jec.rel_positional_table(T, DM))


def test_tables_and_shifts_match_jax():
    """The symmetric table (float64, stored fp32) and both relative shifts,
    bit for bit."""
    np.testing.assert_array_equal(tec.rel_positional_table(T, DM),
                                  jec.rel_positional_table(T, DM))
    x = np.random.RandomState(0).randn(2, 3, T, 2 * T - 1).astype(np.float32)
    np.testing.assert_array_equal(tec.rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jec._rel_shift(jnp.asarray(x))))
    y = x[..., :T].copy()
    np.testing.assert_array_equal(tec.legacy_rel_shift(torch.from_numpy(y)).numpy(),
                                  np.asarray(jec._legacy_rel_shift(jnp.asarray(y))))


def test_factorised_scores_match_jax():
    """``rel_pos_queries_latest`` (rotation along T), ``neg_rel_table`` and
    ``espnet_rel_scores_latest`` against the JAX functions."""
    D = DM // HEADS
    rng = np.random.RandomState(1)
    qc, k, qv = (rng.randn(B, T, HEADS, D).astype(np.float32) for _ in range(3))
    pk = (rng.randn(DM, DM) / np.sqrt(DM)).astype(np.float32)
    sym = jec.rel_positional_table(T, DM)
    g_j = np.asarray(jea.rel_pos_queries_latest(jnp.asarray(qv), jnp.asarray(pk)))
    g_t = tea.rel_pos_queries_latest(torch.from_numpy(qv), torch.from_numpy(pk)).numpy()
    np.testing.assert_allclose(g_t, g_j, atol=1e-5)
    neg = tea.neg_rel_table(torch.from_numpy(sym)).numpy()
    np.testing.assert_array_equal(neg, np.asarray(jea.neg_rel_table(jnp.asarray(sym))))
    s_j = jea.espnet_rel_scores_latest(*map(jnp.asarray, (qc, k, g_j, neg)), 0.25)
    s_t = tea.espnet_rel_scores_latest(*(torch.tensor(x) for x in (qc, k, g_j, neg)), 0.25)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_attention_matches_flax(flavour, route):
    """``RelPositionMultiHeadedAttention`` against the flax module with the
    same weights, ragged lengths and a fully padded row (the flash routes
    average over the padded length there, the others give zeros: each side
    follows its route)."""
    legacy = flavour == "legacy"
    port = _port_encoder(legacy, route)
    _, variables = _flax_encoder(port, legacy, route)
    params = variables["params"]["layer_0"]["self_attn"]
    attn = port.encoders[0].self_attn
    x = np.random.RandomState(2).randn(B, T, DM).astype(np.float32)
    valid = _valid((T, 23, 0))
    pos = _table(legacy)[None]
    jm = jec.RelPositionMultiHeadedAttention(DM, HEADS, 0.0, legacy=legacy,
                                             attn_implementation=route)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(valid)))
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_module_matches_flax(train):
    """``EspnetConvModule`` (GLU, depthwise 'SAME', BatchNorm, swish) against
    the flax module; in training the BatchNorm normalises with the batch
    statistics and its running statistics match flax's batch_stats."""
    port = _port_encoder(False, "shift")
    _, variables = _flax_encoder(port, False, "shift")
    conv = port.encoders[1].conv_module.train(train)
    jm = jec.EspnetConvModule(DM, 7)
    v = {"params": variables["params"]["layer_1"]["conv_module"],
         "batch_stats": variables["batch_stats"]["layer_1"]["conv_module"]}
    x = np.random.RandomState(3).randn(B, T, DM).astype(np.float32)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        for stat, name in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(conv.norm, stat).numpy(),
                                       np.asarray(upd["batch_stats"]["norm"][name]),
                                       atol=1e-6, err_msg=stat)
    else:
        want = jm.apply(v, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_layer_matches_flax(flavour):
    """One ``EspnetConformerLayer`` (macaron at 0.5, conv1d FFN, LayerNorm eps
    1e-12) on the flash route against the flax layer."""
    legacy = flavour == "legacy"
    port = _port_encoder(legacy, "flash")
    _, variables = _flax_encoder(port, legacy, "flash")
    jm = jec.EspnetConformerLayer(DM, HEADS, UNITS, 7, 0.0, 0.0, True, "conv1d", 3, legacy,
                                  "flash")
    v = {"params": variables["params"]["layer_0"],
         "batch_stats": variables["batch_stats"]["layer_0"]}
    x = np.random.RandomState(4).randn(B, T, DM).astype(np.float32)
    valid = _valid()
    pos = _table(legacy)[None]
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(valid)))
    with torch.no_grad():
        got = port.encoders[0](torch.from_numpy(x), torch.from_numpy(pos),
                               torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_encoder_matches_flax(flavour, route):
    """The whole encoder with its embedding (id 0 zeroed), x * sqrt(d), the
    two layers and ``after_norm``, in eval mode."""
    legacy = flavour == "legacy"
    port = _port_encoder(legacy, route)
    jm, variables = _flax_encoder(port, legacy, route)
    ids = np.random.RandomState(5).randint(1, N_SYM, (B, T)).astype(np.int64)
    valid = _valid()
    ids[~valid] = 0
    want, _ = jm.apply(variables, jnp.asarray(ids), jnp.asarray(valid))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(ids), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("flavour,route,ffn_type", [("latest", "flash", "conv1d"),
                                                   ("legacy", "dense", "linear"),
                                                   ("legacy", "flash", "conv1d")])
def test_decoder_training_forward_and_batch_stats(flavour, route, ffn_type):
    """The embedding-free stack (the decoder's, conv kernel 31) in training
    mode with every dropout at 0: outputs and the conv modules' BatchNorm
    running statistics after the forward against flax's batch_stats; the
    linear position-wise layer on the second case."""
    legacy = flavour == "legacy"
    port = _port_encoder(legacy, route, n_symbols=None, kernel_size=31,
                         ffn_type=ffn_type).train()
    jm, variables = _flax_encoder(port, legacy, route, n_symbols=None, kernel_size=31,
                                  ffn_type=ffn_type)
    x = np.random.RandomState(6).randn(B, T, DM).astype(np.float32)
    valid = _valid()
    (want, _), upd = jm.apply(variables, jnp.asarray(x), jnp.asarray(valid), train=True,
                              mutable=["batch_stats"])
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for i in range(BLOCKS):
        norm = port.encoders[i].conv_module.norm
        ref = upd["batch_stats"][f"layer_{i}"]["conv_module"]["norm"]
        np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(ref["mean"]),
                                   atol=1e-6)
        np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(ref["var"]),
                                   atol=1e-6)


def test_flash_routes_in_training():
    """In training both flash routes run their autograd functions (K7's for
    "latest", K6's for "legacy", which raised here until K6's backward was
    ported), with the attention-weight dropout inside the kernel: the loss
    is finite and a gradient reaches every parameter of the stack."""
    x = torch.randn(2, T, DM, generator=torch.Generator().manual_seed(7))
    valid = torch.from_numpy(_valid((T, 20)))
    for legacy in (False, True):
        enc = _port_encoder(legacy, "flash", n_symbols=None)
        for m in enc.modules():
            if isinstance(m, tec.RelPositionMultiHeadedAttention):
                m.dropout_rate = 0.2
        out, _ = enc.train()(x, valid, torch.Generator().manual_seed(0))
        loss = out.square().mean()
        assert torch.isfinite(loss)
        loss.backward()
        for name, p in enc.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), (legacy, name)
            assert p.grad.abs().max() > 0, (legacy, name)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_bf16_flash_encoder_serves(flavour):
    """A bf16 encoder (``OneStageTTS(half=True)``) on the flash route: the
    rotated position queries come out of the fp32 rotation and the op casts
    them back; the output is bf16 and within 5e-2 of the fp32 encoder."""
    legacy = flavour == "legacy"
    port = _port_encoder(legacy, "flash")
    ids = torch.from_numpy(np.random.RandomState(8).randint(1, N_SYM, (B, T)))
    valid = torch.from_numpy(_valid())
    with torch.no_grad():
        want, _ = port(ids, valid)
        got, _ = port.to(torch.bfloat16)(ids, valid)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() < 5e-2 * max(1.0, want.abs().max().item())
