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
    (and the conformer stacks' conv modules) check them."""
    gen = torch.Generator().manual_seed(seed)
    model = seeded_init_(TorchJETS(N_SYMBOLS, N_MELS, hp, n_speakers=n_speakers), gen)
    for up in model.generator.upsamples:
        up[1].weight_g.fill_(1.0)
    _randomise_batchnorms(model, gen)
    return model.eval()


def jax_jets(model: TorchJETS, hp=SMALL_HP, n_speakers=1):
    """(JAX JETS module, its {params, batch_stats}) holding ``model``'s
    weights, through the reference key names and ``import_jets``."""
    jm = JaxJETS(n_symbols=N_SYMBOLS, n_channels=N_MELS, hparams=hp,
                 n_speakers=n_speakers)
    return jm, import_jets(reference_state_dict(model.state_dict()), hp,
                           n_channels=N_MELS)


def session_cached(tmp_path_factory, name: str, compute):
    """``compute()``'s value, computed once per test session however many
    xdist workers ask: the first one computes it under a file lock and
    pickles it into the session's temporary root (the workers' common
    parent directory), the others wait on the lock and load it. For
    fixtures whose JAX reference takes tens of seconds to compile, which
    ``--dist load`` would otherwise set up again on each worker that runs
    one of their items. The value must pickle (numpy trees, CPU tensors,
    modules)."""
    import fcntl
    import os
    import pickle

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # <session>/popen-gwN -> <session>
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        tmp = root / f"{name}.pkl.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
        return value


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


# --------------------------------------------------------------------------
# FastSpeech2 (conformer) and a standalone HiFi-GAN
# --------------------------------------------------------------------------

FS2_STATS = {
    "pitch": {"min": -3.0, "max": 8.0, "mean": 0.0, "std": 1.0},
    "energy": {"min": -3.0, "max": 8.0, "mean": 0.0, "std": 1.0},
}

# a HiFi-GAN V1 geometry at 64 channels: the full (3, 7, 11) x (1, 3, 5) MRF
TINY_HIFI = {
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 64,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}


def fs2_hparams(attn_implementation="flash", mask_attn_keys=False):
    """``tests/test_fastspeech2.py:tiny_hparams("conformer")`` with the
    attention route and key masking chosen."""
    from tests.test_fastspeech2 import tiny_hparams

    hp = tiny_hparams("conformer")
    hp["attn_implementation"] = attn_implementation
    hp["building_block"]["conformer"]["mask_attn_keys"] = mask_attn_keys
    return hp


def _randomise_batchnorms(model, gen):
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)


@torch.no_grad()
def port_fs2(hp, n_speakers=2, seed=0):
    """The port's FastSpeech2 on the CPU with seeded weights, in eval mode.
    The biases of the attention projections and of the aligner's speaker
    projections are 0: the reference layers have none, and the importer
    that carries the weights to JAX sets them to 0."""
    from viet_tts_torch.models.fastspeech2.model import FastSpeech2

    gen = torch.Generator().manual_seed(seed)
    model = FastSpeech2(N_SYMBOLS, N_MELS, hp, FS2_STATS, n_speakers)
    # the aligner's weights are drawn last, so that the other modules keep
    # the weights they had before the model held an aligner
    va = model.variance_adaptor
    aligner = va._modules.pop("aligner", None)
    seeded_init_(model, gen)
    _randomise_batchnorms(model, gen)
    if aligner is not None:
        va.aligner = seeded_init_(aligner, gen)
    for name, p in model.named_parameters():
        if ((".attention." in name or "spk_proj" in name)
                and name.endswith("linear.bias")):
            p.zero_()
    return model.eval()


def jax_fs2(model, hp, n_speakers=2):
    """(JAX FastSpeech2 module, its {params, batch_stats}) holding
    ``model``'s weights, through the reference names and
    ``import_fastspeech2``."""
    from viet_tts_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
    from viet_tts_tpu.train.torch_import import import_fastspeech2

    jm = JaxFastSpeech2(n_symbols=N_SYMBOLS, n_channels=N_MELS, hparams=hp,
                        stats=FS2_STATS, n_speakers=n_speakers, n_accents=2)
    return jm, import_fastspeech2(reference_state_dict(model.state_dict()), hp)


def hifigan_kwargs(hifi):
    return dict(
        in_channels=N_MELS, channels=hifi["upsample_initial_channel"],
        upsample_scales=tuple(hifi["upsample_rates"]),
        upsample_kernel_sizes=tuple(hifi["upsample_kernel_sizes"]),
        resblock_kernel_sizes=tuple(hifi["resblock_kernel_sizes"]),
        resblock_dilations=tuple(map(tuple, hifi["resblock_dilation_sizes"])))


@torch.no_grad()
def port_hifigan(hifi=TINY_HIFI, seed=1):
    """The port's standalone HiFi-GAN, seeded, unit-norm transposed convs
    (see ``port_jets``)."""
    from viet_tts_torch.models.hifigan import HiFiGANGenerator

    model = seeded_init_(HiFiGANGenerator(**hifigan_kwargs(hifi)),
                         torch.Generator().manual_seed(seed))
    for up in model.upsamples:
        up[1].weight_g.fill_(1.0)
    return model.eval()


def jax_hifigan(model, hifi=TINY_HIFI):
    """(JAX HiFiGANGenerator, its params) through ``import_hifigan_generator``."""
    from viet_tts_tpu.models.hifigan import HiFiGANGenerator as JaxHiFiGAN
    from viet_tts_tpu.train.torch_import import import_hifigan_generator

    kw = hifigan_kwargs(hifi)
    params = import_hifigan_generator(
        reference_state_dict(model.state_dict()), upsample_scales=kw["upsample_scales"],
        resblock_kernel_sizes=kw["resblock_kernel_sizes"],
        resblock_dilations=kw["resblock_dilations"])
    return JaxHiFiGAN(**kw), params


def ada_hparams(phoneme_level_encoder_step: int = 5):
    """``tests/test_adaspeech.py:tiny_hp`` (width 32, one CLN FFT layer
    each, CVAE, MAS-learned durations with binarization from step 4,
    Postnet) with every dropout rate 0, for parity; the UtteranceEncoder's
    n_chans is the encoder's width, as the model adds them."""
    from tests.test_adaspeech import tiny_hp

    hp = tiny_hp(phoneme_level_encoder_step)
    block = hp["building_block"]["transformer"]
    block["encoder_dropout"] = block["decoder_dropout"] = 0.0
    hp["variance"]["variance_predictor"]["dropout"] = 0.0
    for enc in hp["variance"]["reference_encoder"].values():
        if isinstance(enc, dict):
            enc["dropout_rate"] = 0.0
    return hp


@torch.no_grad()
def port_adaspeech(hp, n_speakers=2, seed=0):
    """The port's AdaSpeech on the CPU with seeded weights, in eval mode.
    The CLNs' projections are drawn too (a fresh model's are kernel 0, so
    the speaker conditioning would not show), the BatchNorm statistics
    drawn, the aligner's speaker projections' biases 0 (the reference has
    none; the importer sets them to 0)."""
    from viet_tts_torch.models.adaspeech import AdaSpeech

    gen = torch.Generator().manual_seed(seed)
    model = seeded_init_(AdaSpeech(N_SYMBOLS, N_MELS, hp, FS2_STATS, n_speakers), gen)
    _randomise_batchnorms(model, gen)
    for name, p in model.named_parameters():
        if ".W_scale." in name or ".W_bias." in name:
            base = 1.0 if name.endswith("W_scale.bias") else 0.0
            p.copy_(base + 0.2 * torch.randn(p.shape, generator=gen))
        elif "spk_proj" in name and name.endswith("linear.bias"):
            p.zero_()
    return model.eval()


def jax_adaspeech(model, hp, n_speakers=2):
    """(JAX AdaSpeech module, its {params, batch_stats}) holding ``model``'s
    weights, through the reference names and ``import_adaspeech``."""
    from viet_tts_tpu.models.adaspeech import AdaSpeech as JaxAdaSpeech
    from viet_tts_tpu.train.torch_import import import_adaspeech

    jm = JaxAdaSpeech(n_symbols=N_SYMBOLS, n_channels=N_MELS, hparams=hp, stats=FS2_STATS,
                      n_speakers=n_speakers, n_accents=2)
    return jm, import_adaspeech(reference_state_dict(model.state_dict()), hp)


MATCHA_STATS = {"mel_mean": -3.0, "mel_std": 2.5}


def matcha_hparams(decoder_block_type: str = "transformer"):
    """``tests/test_matcha.py:TINY_HP`` with every dropout rate 0, for
    parity, and a narrower UNet: channels (16, 16), heads 2 x 8, one mid
    block; ``decoder_block_type`` for every stage."""
    import copy

    from tests.test_matcha import TINY_HP

    hp = copy.deepcopy(TINY_HP)
    te = hp["text_encoder"]
    te["prenet"]["p_dropout"] = te["encoder"]["p_dropout"] = 0.0
    hp["variance_predictor"]["dropout"] = 0.0
    hp["decoder"].update(channels=[16, 16], attention_head_dim=8, num_mid_blocks=1,
                         dropout=0.0)
    for stage in ("down", "mid", "up"):
        hp["decoder"][f"{stage}_block_type"] = decoder_block_type
    return hp


@torch.no_grad()
def port_matcha(hp, n_speakers=2, seed=0):
    """The port's MatchaTTS on the CPU with seeded weights, in eval mode.
    The parameters a fresh model holds at a constant (the prenet's zero
    projection, the channel and flax-style norms' scales and offsets,
    snakebeta's log-scale alpha / beta) are drawn too, so that each
    shows; the BatchNorm statistics drawn; the aligner's speaker
    projections' biases 0 and the CVAE GRU's hidden r / z biases folded
    into its input biases, as the importer carries them (the reference
    aligner and flax's GRUCell have none)."""
    from viet_tts_torch.models.matcha import MatchaTTS

    gen = torch.Generator().manual_seed(seed)
    model = seeded_init_(MatchaTTS(N_SYMBOLS, N_MELS, hp, MATCHA_STATS, n_speakers), gen)
    _randomise_batchnorms(model, gen)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if ".prenet.proj." in name:
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        elif leaf in ("gamma", "alpha", "beta") or (
                p.dim() == 1 and (".norm" in name or ".block.1." in name)):
            base = 1.0 if leaf in ("gamma", "weight") else 0.0
            p.copy_(base + 0.2 * torch.randn(p.shape, generator=gen))
        elif "spk_proj" in name and name.endswith("linear.bias"):
            p.zero_()
    gru = model.speaker_emb.encoder.gru
    H = gru.hidden_size
    gru.bias_ih_l0[: 2 * H] += gru.bias_hh_l0[: 2 * H]
    gru.bias_hh_l0[: 2 * H] = 0.0
    return model.eval()


def jax_matcha(model, hp, n_speakers=2):
    """(JAX MatchaTTS module, its {params, batch_stats}) holding
    ``model``'s weights, through the reference names and
    ``import_matcha`` (numpy leaves)."""
    import jax

    from viet_tts_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
    from viet_tts_tpu.train.torch_import import import_matcha

    jm = JaxMatchaTTS(n_symbols=N_SYMBOLS, n_channels=N_MELS, hparams=hp, stats=MATCHA_STATS,
                      n_speakers=n_speakers, n_accents=2)
    variables = import_matcha(reference_state_dict(model.state_dict()), hp)
    return jm, jax.tree_util.tree_map(np.asarray, variables)


# --------------------------------------------------------------------------
# VITS2
# --------------------------------------------------------------------------

def vits2_hparams(flow_type: str = "pre_conv"):
    """``tests/test_vits2.py:TINY_HP`` with ``transformer_flow_type``
    ("none": ``use_transformer_flows`` off)."""
    import copy

    from tests.test_vits2 import TINY_HP

    hp = copy.deepcopy(TINY_HP)
    hp["use_transformer_flows"] = flow_type != "none"
    hp["transformer_flow_type"] = "pre_conv" if flow_type == "none" else flow_type
    return hp


# the duration predictor's last affine flow's shift: reverse adds -m to the
# log-duration, so durations sit near e^1.3 ~ 3.7 frames, away from integers
VITS2_LOGW_SHIFT = -1.3


@torch.no_grad()
def port_vits2(hp, n_speakers=2, seed=0):
    """The port's VITS2 on the CPU with seeded weights, in eval mode. The
    parameters a fresh model holds at zero (the flows' ``post`` / ``proj``,
    the affine flows' m / logs) are drawn too, so that every flow is more
    than the identity; the transposed convs' g is 1 (see ``port_jets``);
    the SDP's last affine flow shifts the log-durations by
    ``-VITS2_LOGW_SHIFT``."""
    from viet_tts_torch.models.vits2 import VITS2

    gen = torch.Generator().manual_seed(seed)
    model = seeded_init_(VITS2(N_SYMBOLS, hp, n_speakers=n_speakers, spec_channels=N_MELS), gen)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = name.rsplit(".", 2)[-2]
        if owner in ("post", "proj") and ("flow" in name) and leaf in ("weight", "bias"):
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        elif leaf in ("m", "logs"):
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    for up in model.dec.ups:
        up.weight_g.fill_(1.0)
    if model.use_sdp:
        model.dp.flows[0].m[0] = VITS2_LOGW_SHIFT
    return model.eval()


def jax_vits2(model, hp, n_speakers=2):
    """(JAX VITS2 module, its {params} as numpy) holding ``model``'s weights,
    through the reference names and ``import_vits2``."""
    import jax

    from viet_tts_tpu.models.vits2 import VITS2 as JaxVITS2
    from viet_tts_tpu.train.torch_import import import_vits2

    jm = JaxVITS2(n_symbols=N_SYMBOLS, hparams=hp, n_speakers=n_speakers,
                  spec_channels=N_MELS)
    variables = import_vits2(reference_state_dict(model.state_dict()), hp)
    return jm, jax.tree_util.tree_map(np.asarray, variables)


def random_flax_params(module, *args, seed=0, **kw):
    """Params of ``module`` of its init's shapes (``jax.eval_shape``: no
    init is run), drawn from numpy: kernels ~ N(0, 1 / fan_in), norms' scales
    1 + N(0, 0.1^2), biases N(0, 0.1^2), the affine flows' m / logs and the
    relative tables N(0, 0.2^2), so that every flow is more than the
    identity."""
    import jax

    rng = np.random.RandomState(seed)
    rngs = kw.pop("rngs", jax.random.PRNGKey(0))
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, **kw))["params"]

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = leaf.shape
        if name.endswith("scale"):
            x = 1.0 + 0.1 * rng.randn(*shape)
        elif name in ("bias", "m", "logs") or name.startswith("emb_rel"):
            x = (0.1 if name == "bias" else 0.2) * rng.randn(*shape)
        else:  # kernel, kernel_v, kernel_g, embedding
            x = rng.randn(*shape) / np.sqrt(max(int(np.prod(shape[:-1])), 1))
            if name == "kernel_g":
                x = np.abs(x) + 0.5
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def zero_dropout_(model):
    """Every dropout rate of a port VITS2 module tree to 0: the JAX side
    runs its ``nn.Dropout``s as the identity (``no_dropout``)."""
    for m in model.modules():
        if hasattr(m, "p_dropout"):
            m.p_dropout = 0.0
    return model


def no_dropout(next_fun, args, kwargs, context):
    """A flax interceptor that runs every ``nn.Dropout`` as the identity
    (dropout bits cannot be reproduced; the port runs with rate 0)."""
    import flax.linen as fnn

    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


class JaxNormalDraws:
    """Records every ``jax.random.normal`` the JAX VITS2 modules draw, in
    call order (``draws``): within a ``with`` block it stands in for the
    ``jax`` name of ``viet_tts_tpu/models/vits2/layers.py`` and
    ``model.py`` (the posterior's noise, the SDP's noises, the MAS noise,
    the inference noise). Under ``jax.jit`` the records are the trace's
    values and can be returned from the traced function."""

    def __init__(self):
        import jax

        self.draws = []
        outer = self

        class _Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def normal(self, key, shape=(), dtype=np.float32):
                x = jax.random.normal(key, shape, dtype)
                outer.draws.append(x)
                return x

        class _Jax:
            random = _Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        self._shim = _Jax()

    def __enter__(self):
        from viet_tts_tpu.models.vits2 import layers, model

        self._mods = (layers, model)
        self._saved = [m.jax for m in self._mods]
        for m in self._mods:
            m.jax = self._shim
        self.draws.clear()
        return self

    def __exit__(self, *exc):
        for m, saved in zip(self._mods, self._saved):
            m.jax = saved
        return False
