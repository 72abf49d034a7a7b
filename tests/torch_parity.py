"""Shared fixtures for the PyTorch port's parity tests (``test_torch_*``).

One small JETS configuration. Its weights are drawn in the port from a
seeded ``torch.Generator`` and carried into the JAX package through the
reference torch key names: ``viet_tts_torch.convert.reference_state_dict``
then the JAX package's ``train/torch_import.py:import_jets``. (Building the
JAX variables this way also skips a ~20 s XLA compile of the JAX init.)
``convert.jets_from_jax`` carries them back. Inputs come from numpy with a
fixed seed and are handed to both sides. The same holds for a tiny
HiFi-GAN discriminator (``TINY_DISC``, ``flax_msmpd_params``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from viet_tts_tpu.models.jets import JETS as JaxJETS
from viet_tts_tpu.train.torch_import import (
    conv1d_params,
    import_jets,
    import_msmpd_discriminator,
)
from viet_tts_torch.convert import reference_state_dict
from viet_tts_torch.models.hifigan.discriminator import MultiScaleMultiPeriodDiscriminator
from viet_tts_torch.models.jets import JETS as TorchJETS
from viet_tts_torch.nn.utils import seeded_init_

N_SYMBOLS = 131
N_MELS = 80

# TINY_HP-like widths (tests/test_jets.py) with HiFi-GAN V1's full
# (3, 7, 11) x (1, 3, 5) MRF and both kernel routes switched on
SMALL_HP = {
    "adim": 32,
    "aheads": 2,
    "elayers": 2,
    "eunits": 64,
    "dlayers": 2,
    "dunits": 64,
    "positionwise_conv_kernel_size": 3,
    "duration_predictor_layers": 2,
    "duration_predictor_chans": 16,
    "duration_predictor_kernel_size": 3,
    "pitch_predictor_layers": 2,
    "pitch_predictor_chans": 16,
    "pitch_predictor_kernel_size": 5,
    "energy_predictor_layers": 2,
    "energy_predictor_chans": 16,
    "energy_predictor_kernel_size": 3,
    "use_gst": True,
    "gst_tokens": 4,
    "gst_heads": 2,
    "generator_channels": 64,
    "generator_upsample_scales": [8, 8, 2, 2],
    "generator_upsample_kernel_sizes": [16, 16, 4, 4],
    "generator_resblock_kernel_sizes": [3, 7, 11],
    "generator_resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "segment_size": 8,
    "attn_implementation": "flash",
    "fused_mrf": True,
}

# tests/test_jets.py's tiny discriminator
TINY_DISC = dict(scales=1, periods=(2, 3),
                 scale_params={"channels": 8, "max_downsample_channels": 16},
                 period_params={"channels": 4, "max_downsample_channels": 8})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse in every module that imports it: the port's CPU tests run
    torch on one intra-op thread. At these small shapes more threads only
    compete with the suite's other workers for the cores (and are slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@torch.no_grad()
def port_jets(hp=SMALL_HP, n_speakers=1, seed=0) -> TorchJETS:
    """The port's JETS on the CPU with seeded weights, in eval mode.

    The init gives the transposed convs g = ||v|| with v ~ N(0, 0.01) (the
    JAX package's init), which shrinks the waveform to ~1e-5 and would make
    any tolerance vacuous; a unit norm per output channel keeps it at audio
    scale. BatchNorm running statistics are drawn too, so the GST path
    checks them."""
    gen = torch.Generator().manual_seed(seed)
    model = seeded_init_(TorchJETS(N_SYMBOLS, N_MELS, hp, n_speakers=n_speakers), gen)
    for up in model.generator.upsamples:
        up[1].weight_g.fill_(1.0)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model.eval()


def jax_jets(model: TorchJETS, hp=SMALL_HP, n_speakers=1):
    """(JAX JETS module, its {params, batch_stats}) holding ``model``'s
    weights, through the reference key names and ``import_jets``."""
    jm = JaxJETS(n_symbols=N_SYMBOLS, n_channels=N_MELS, hparams=hp,
                 n_speakers=n_speakers)
    return jm, import_jets(reference_state_dict(model.state_dict()), hp,
                           n_channels=N_MELS)


def t(x, dtype=None) -> torch.Tensor:
    """numpy -> torch (CPU)."""
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


def flax_msmpd_params(port_sd, periods):
    """The JAX ``MultiScaleMultiPeriodDiscriminator`` params of a port
    discriminator, through the JAX package's importer.

    The weight-normed pairs are folded first (``reference_state_dict``, as
    the JETS tests do): the importer's ``effective_weight`` takes the norm
    over three axes with ``torch.norm``, which recent PyTorch refuses for the
    period discriminators' 4-D weights. Two faults of
    ``import_msmpd_discriminator`` itself are worked around, the importer
    being left as it is: it reads a scale discriminator's layer index from
    the wrong field of the key (``layers`` instead of the number after it)
    and raises on every ``msd.`` key, so the scale discriminators go through
    its per-conv helper ``conv1d_params``; and it names a period
    discriminator by its index (``period_0``) and its last conv
    ``conv_post`` / ``wn_post``, where the flax module has the period
    (``period_2``) and ``output_conv`` / ``wn_out``."""
    sd = reference_state_dict(port_sd)
    msd = {}
    s = 0
    while f"msd.discriminators.{s}.layers.0.0.weight" in sd:
        n = len({k.split(".")[4] for k in sd if k.startswith(f"msd.discriminators.{s}.")})
        names = ["layer_0", *(f"layer_{i}" for i in range(1, n - 2)),
                 "layer_pre_out", "layer_out"]
        msd[f"scale_{s}"] = {
            name: conv1d_params(sd, f"msd.discriminators.{s}.layers.{li}"
                                + ("" if name == "layer_out" else ".0"), weight_norm=True)
            for li, name in enumerate(names)}
        s += 1
    imported = import_msmpd_discriminator({k: v for k, v in sd.items()
                                           if k.startswith("mpd.")})
    mpd = {}
    for i, p in enumerate(periods):
        per = dict(imported["mpd"][f"period_{i}"])
        per["output_conv"] = per.pop("conv_post")
        per["wn_out"] = {"output_conv/kernel/scale":
                         per.pop("wn_post")["conv_post/kernel/scale"]}
        mpd[f"period_{p}"] = per
    return {"msd": msd, "mpd": mpd}


def port_tiny_disc(seed=0) -> MultiScaleMultiPeriodDiscriminator:
    """The port's ``TINY_DISC`` discriminator with seeded weights."""
    disc = MultiScaleMultiPeriodDiscriminator(**TINY_DISC)
    return seeded_init_(disc, torch.Generator().manual_seed(seed))
