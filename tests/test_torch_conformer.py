"""The port's conformer (``nn/conformer.py``) against the JAX package's on the
CPU: ``ConformerBlock``, ``ConformerEncoder`` and ``ConformerDecoder`` in
each ``attn_implementation`` (shift, dense, flash), with ``mask_attn_keys``
False (the reference's behaviour) and True.

The port's weights are seeded and carried to the JAX modules through the
reference torch names and the JAX package's own importer
(``train/torch_import.py:_conformer_block_params`` /
``_conformer_stack_params``); inputs come from numpy with a fixed seed. On
the CPU the flash route runs the plain versions of kernels K4 / K5 / K6.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from viet_tts_tpu.nn import conformer as jc
from viet_tts_tpu.nn.utils import sinusoid_position_table
from viet_tts_tpu.train.torch_import import _conformer_block_params, _conformer_stack_params
from viet_tts_torch.convert import reference_state_dict
from viet_tts_torch.nn import conformer as tc
from viet_tts_torch.nn.utils import seeded_init_

from tests.torch_parity import N_SYMBOLS, one_torch_thread, t  # noqa: F401 (autouse)

D_MODEL, HEADS, T = 32, 2, 40
BLOCK = dict(num_heads=HEADS, ffn_expansion=2, conv_expansion=2, kernel_size=7,
             half_step_residual=True, dropout=0.1)
ATOL = 1e-5
IMPLS = ["shift", "dense", "flash"]


@torch.no_grad()
def _seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded weights, zero attention-projection biases (the reference has
    none, and the importer sets them to 0), random BatchNorm statistics."""
    gen = torch.Generator().manual_seed(seed)
    seeded_init_(module, gen)
    for name, p in module.named_parameters():
        if ".attention." in name and name.endswith("linear.bias"):
            p.zero_()
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return module.eval()


def _ref_sd(module: torch.nn.Module, prefix: str):
    return {f"{prefix}.{k}": v for k, v in reference_state_dict(module.state_dict()).items()}


def _inputs(B=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D_MODEL).astype(np.float32)
    lens = np.array([T, T - 13, 1])
    return x, np.arange(T)[None] >= lens[:, None]


@pytest.mark.parametrize("impl", IMPLS)
def test_conformer_block_matches_jax(impl):
    """One block, padded rows zeroed at its output, attention keys masked
    (mask_attn_keys=True) or not (False, the reference)."""
    x, pad = _inputs()
    table = sinusoid_position_table(T, D_MODEL)
    pos_emb = np.broadcast_to(table[None], (3, T, D_MODEL))
    for mask_keys in (False, True):
        port = _seeded(tc.ConformerBlock(D_MODEL, mask_attn_keys=mask_keys,
                                         attn_implementation=impl, **BLOCK))
        params, stats = _conformer_block_params(_ref_sd(port, "blk"), "blk")
        jm = jc.ConformerBlock(D_MODEL, mask_attn_keys=mask_keys,
                               attn_implementation=impl, **BLOCK)
        want = jax.jit(lambda v, x, p, m: jm.apply(v, x, p, m, False))(
            {"params": params, "batch_stats": stats}, x, pos_emb, pad)
        with torch.no_grad():
            got = port(t(x), t(table), t(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"mask_attn_keys={mask_keys}")
        assert not got[2, 1:].any()  # the padded rows are zeroed


@pytest.mark.parametrize("impl", IMPLS)
def test_conformer_encoder_and_decoder_match_jax(impl):
    """Two-layer encoder (phoneme ids, id 0 zeroed) and decoder (frame
    features) stacks, each with mask_attn_keys False and True."""
    x, pad = _inputs(seed=1)
    ids = np.random.RandomState(2).randint(1, N_SYMBOLS, (3, T)) * (~pad)
    stack = dict(n_layers=2, d_model=D_MODEL, max_seq_len=100, **BLOCK)
    for mask_keys in (False, True):
        kw = dict(stack, mask_attn_keys=mask_keys, attn_implementation=impl)
        enc = _seeded(tc.ConformerEncoder(N_SYMBOLS, **kw), seed=3)
        dec = _seeded(tc.ConformerDecoder(**kw), seed=4)
        enc_p, enc_s = _conformer_stack_params(_ref_sd(enc, "encoder"), "encoder", 2, True)
        dec_p, dec_s = _conformer_stack_params(_ref_sd(dec, "decoder"), "decoder", 2, False)
        j_enc = jc.ConformerEncoder(n_symbols=N_SYMBOLS, **kw)
        j_dec = jc.ConformerDecoder(**kw)
        h_j, emb_j = jax.jit(lambda v, s, m: j_enc.apply(v, s, m, False))(
            {"params": enc_p, "batch_stats": enc_s}, ids, pad)
        y_j, _ = jax.jit(lambda v, x, m: j_dec.apply(v, x, m, False))(
            {"params": dec_p, "batch_stats": dec_s}, x, pad)
        with torch.no_grad():
            h_t, emb_t = enc(t(ids, torch.long), t(pad))
            y_t, pad_t = dec(t(x), t(pad))
        msg = f"mask_attn_keys={mask_keys}"
        np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, err_msg=msg)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL, err_msg=msg)
        assert torch.equal(pad_t, t(pad))


def test_flash_routes_by_padded_length(monkeypatch):
    """The flash route takes xl3 while the 128-padded T is at most 512, xl2
    while the 32-padded T is at most 1024, xl beyond (the JAX module's
    thresholds), and each gives the shift path's answer."""
    from viet_tts_torch.ops import flash_xl_attention as fx
    from viet_tts_torch.ops import xl_attention as txl

    calls = []
    for name in ("flash_xl3_attention", "flash_xl2_attention", "flash_xl_attention"):
        fn = getattr(txl, name)
        monkeypatch.setattr(txl, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                           _fn(*a, **k))[1])
    flash = _seeded(tc.RelativeMultiHeadAttention(D_MODEL, HEADS, 0.1, "flash"))
    shift = _seeded(tc.RelativeMultiHeadAttention(D_MODEL, HEADS, 0.1, "shift"))
    for T_, want in ((512, "flash_xl3_attention"), (513, "flash_xl2_attention"),
                     (1024, "flash_xl2_attention"), (1025, "flash_xl_attention")):
        x = torch.from_numpy(np.random.RandomState(T_).randn(1, T_, D_MODEL).astype(np.float32))
        table = torch.from_numpy(sinusoid_position_table(T_, D_MODEL))
        with torch.no_grad():
            got = flash(x, table)
            ref = shift(x, table)
        assert calls[-1] == want, (T_, calls)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-5, err_msg=str(T_))
    assert fx.xl3_padded_time(512) == 512 and fx.xl3_padded_time(513) == 640
