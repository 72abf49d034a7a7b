"""Model hyper-parameters, training and audio settings, carried as Python
dicts.

Copied from ``config/model_config.yaml`` (sections ``jets``: generator and
discriminator params; ``fastspeech2``; ``hifigan``), ``config/train_config.yaml``
(section ``jets`` and ``grad_clip_thresh``) and
``config/preprocessing_config.yaml`` so that the port runs where ``pyyaml``
is not installed; ``DEFAULT_STATS`` is ``viet_tts_tpu/infer/api.py``'s.
``tests/test_torch_text.py`` and ``tests/test_torch_fastspeech2.py`` hold
every dict equal to its source.

``build_config`` and ``derive_task_config`` are the counterparts of
``viet_tts_tpu/config.py``: the trainer reads a config directory's three
files through the port's own YAML-subset reader (``utils/yaml_subset.py``).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict

from viet_tts_torch.utils.yaml_subset import load_file

CONFIG_FILES = {
    "audio": "preprocessing_config.yaml",
    "models": "model_config.yaml",
    "train": "train_config.yaml",
}


def build_config(config_dir: str) -> Dict[str, Any]:
    """Load and merge the three config YAMLs of ``config_dir`` into
    ``{"audio": ..., "models": ..., "train": ...}``."""
    return {key: load_file(os.path.join(config_dir, fname))
            for key, fname in CONFIG_FILES.items()}


def derive_task_config(conf: Dict[str, Any], task: str,
                       version: str | None = None) -> Dict[str, Any]:
    """A deep copy of ``conf`` with the task-derived fields filled in:
    ``audio.self_learning`` (the model's ``learn_alignment``, always on for
    Matcha), ``task`` and ``version``."""
    conf = copy.deepcopy(conf)
    model_key = version if task in ("text2wav", "joint") and version else task
    model_conf = conf["models"].get(model_key, {})
    variance = model_conf.get("variance", model_conf)
    learn_alignment = bool(variance.get("learn_alignment", False)) or model_key == "matcha"
    conf["audio"]["self_learning"] = learn_alignment
    conf["task"] = task
    conf["version"] = version
    return conf

AUDIO: Dict[str, Any] = {
    "signal": {
        "sampling_rate": 22050,
        "max_wav_value": 32768.0,
        "segment_length": 32768,
    },
    "stft": {
        "filter_length": 1024,
        "hop_length": 256,
        "win_length": 1024,
        "window": "hann",
    },
    "mel": {
        "channels": 80,
        "fmin": 0,
        "fmax": None,
        "log_base": None,
    },
}

JETS_GENERATOR_PARAMS: Dict[str, Any] = {
    "adim": 256,
    "aheads": 2,
    "elayers": 4,
    "eunits": 1024,
    "dlayers": 6,
    "dunits": 1024,
    "positionwise_layer_type": "conv1d",
    "positionwise_conv_kernel_size": 3,
    "duration_predictor_layers": 2,
    "duration_predictor_chans": 256,
    "duration_predictor_kernel_size": 3,
    "use_masking": True,
    "encoder_normalize_before": True,
    "decoder_normalize_before": True,
    "encoder_type": "transformer",
    "decoder_type": "transformer",
    "conformer_rel_pos_type": "latest",
    "conformer_pos_enc_layer_type": "rel_pos",
    "conformer_self_attn_layer_type": "rel_selfattn",
    "conformer_activation_type": "swish",
    "use_macaron_style_in_conformer": True,
    "use_cnn_in_conformer": True,
    "conformer_enc_kernel_size": 7,
    "conformer_dec_kernel_size": 31,
    "init_type": "xavier_uniform",
    "transformer_enc_dropout_rate": 0.2,
    "transformer_enc_positional_dropout_rate": 0.2,
    "transformer_enc_attn_dropout_rate": 0.2,
    "transformer_dec_dropout_rate": 0.2,
    "transformer_dec_positional_dropout_rate": 0.2,
    "transformer_dec_attn_dropout_rate": 0.2,
    "pitch_predictor_layers": 5,
    "pitch_predictor_chans": 256,
    "pitch_predictor_kernel_size": 5,
    "pitch_predictor_dropout": 0.5,
    "pitch_embed_kernel_size": 1,
    "pitch_embed_dropout": 0.0,
    "stop_gradient_from_pitch_predictor": True,
    "energy_predictor_layers": 2,
    "energy_predictor_chans": 256,
    "energy_predictor_kernel_size": 3,
    "energy_predictor_dropout": 0.5,
    "energy_embed_kernel_size": 1,
    "energy_embed_dropout": 0.0,
    "stop_gradient_from_energy_predictor": False,
    "use_gst": True,
    "generator_out_channels": 1,
    "generator_channels": 512,
    "generator_global_channels": -1,
    "generator_kernel_size": 7,
    "generator_upsample_scales": [8, 8, 2, 2],
    "generator_upsample_kernel_sizes": [16, 16, 4, 4],
    "generator_resblock_kernel_sizes": [3, 7, 11],
    "generator_resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "generator_use_additional_convs": True,
    "generator_bias": True,
    "generator_nonlinear_activation": "LeakyReLU",
    "generator_nonlinear_activation_params": {"negative_slope": 0.1},
    "generator_use_weight_norm": True,
    "segment_size": 64,
}


JETS_DISCRIMINATOR_PARAMS: Dict[str, Any] = {
    "scales": 1,
    "scale_downsample_pooling": "AvgPool1d",
    "scale_downsample_pooling_params": {"kernel_size": 4, "stride": 2, "padding": 2},
    "scale_discriminator_params": {
        "in_channels": 1,
        "out_channels": 1,
        "kernel_sizes": [15, 41, 5, 3],
        "channels": 128,
        "max_downsample_channels": 1024,
        "max_groups": 16,
        "bias": True,
        "downsample_scales": [2, 2, 4, 4, 1],
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.1},
        "use_weight_norm": True,
        "use_spectral_norm": False,
    },
    "follow_official_norm": False,
    "periods": [2, 3, 5, 7, 11],
    "period_discriminator_params": {
        "in_channels": 1,
        "out_channels": 1,
        "kernel_sizes": [5, 3],
        "channels": 32,
        "downsample_scales": [3, 3, 3, 3, 1],
        "max_downsample_channels": 1024,
        "bias": True,
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.1},
        "use_weight_norm": True,
        "use_spectral_norm": False,
    },
}

JETS_TRAIN: Dict[str, Any] = {
    "loss": {
        "generator_adv_loss_params": {"average_by_discriminators": False,
                                      "loss_type": "mse"},
        "discriminator_adv_loss_params": {"average_by_discriminators": False,
                                          "loss_type": "mse"},
        "feat_match_loss_params": {
            "average_by_discriminators": False,
            "average_by_layers": False,
            "include_final_outputs": True,
        },
        "lambda_adv": 1.0,
        "lambda_mel": 45.0,
        "lambda_feat_match": 2.0,
        "lambda_var": 1.0,
        "lambda_align": 2.0,
    },
    "optimizer": {
        "gen_optim_conf": {"lr": 2.0e-4, "betas": [0.8, 0.99], "eps": 1.0e-9,
                           "weight_decay": 0.0},
        "gen_scheduler_conf": {"gamma": 0.999875},
        "dis_optim_conf": {"lr": 2.0e-4, "betas": [0.8, 0.99], "eps": 1.0e-9,
                           "weight_decay": 0.0},
        "dis_scheduler_conf": {"gamma": 0.999875},
    },
}

FASTSPEECH2: Dict[str, Any] = {
    "max_seq_len": 1000,
    "encoder_layers": 6,
    "encoder_hidden": 384,
    "decoder_layers": 6,
    "decoder_hidden": 384,
    "use_cvae": True,
    "vcae": {
        "conv_layers": 6,
        "conv_chans_list": [32, 32, 64, 64, 128, 128],
        "conv_kernel_size": 3,
        "conv_stride": 2,
        "gru_layers": 1,
        "gru_units": 256,
    },
    "use_postnet": True,
    "building_block": {
        "block_type": "conformer",
        "transformer": {
            "encoder_head": 2,
            "decoder_head": 2,
            "conv_filter_size": 1024,
            "conv_kernel_size": [9, 1],
            "encoder_dropout": 0.2,
            "decoder_dropout": 0.2,
        },
        "conformer": {
            "encoder_head": 8,
            "decoder_head": 8,
            "ffn_expansion_factor": 4,
            "conv_kernel_size": 31,
            "conv_expansion_factor": 2,
            "half_step_residual": True,
            "encoder_dropout": 0.1,
            "decoder_dropout": 0.1,
            "mask_attn_keys": False,
        },
    },
    "variance": {
        "learn_alignment": True,
        "duration_modelling": {
            "use_gaussian": True,
            "aligner_temperature": 0.0005,
            "binarization_start_steps": 6000,
        },
        "variance_predictor": {
            "filter_size": 256,
            "kernel_size": 3,
            "dropout": 0.5,
            "dur_predictor_layers": 2,
            "dur_predictor_kernel": 3,
            "pit_predictor_layers": 2,
            "pit_predictor_kernel": 5,
            "ener_predictor_layers": 2,
            "ener_predictor_kernel": 5,
            "ffn_padding": "SAME",
            "ffn_act": "gelu",
        },
        "variance_embedding": {
            "n_bins": 256,
            "pitch_feature": "phoneme_level",
            "pitch_quantization": "linear",
            "energy_feature": "phoneme_level",
            "energy_quantization": "linear",
        },
    },
    "postnet": {"embedding_dim": 512, "conv_layers": 5, "kernel_size": 5},
}

HIFIGAN: Dict[str, Any] = {
    "use_spk": False,
    "segment_size": 64,
    "resblock": 1,
    "num_freq": 1025,
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}

# viet_tts_tpu/infer/api.py:DEFAULT_STATS: pitch / energy statistics when a
# checkpoint has no stats.json
DEFAULT_STATS: Dict[str, Any] = {
    "pitch": {"min": -3.0, "max": 8.0, "mean": 0.0, "std": 1.0},
    "energy": {"min": -3.0, "max": 8.0, "mean": 0.0, "std": 1.0},
}

GRAD_CLIP_THRESH = 1.0  # train_config.yaml: grad_clip_thresh

# train_config.yaml: fastspeech2
FASTSPEECH2_TRAIN: Dict[str, Any] = {
    "loss": {
        "linbuild": {"start": 0.0001, "stop": 0.0005, "n_up": 10000, "n_stop": 35000},
        "dur_loss_lambda": {"pdur": 1.0, "wdur": 0.0, "sdur": 0.0},
        "binarization_loss_warmup_steps": 10000,
        "binarization_loss_enable_steps": 18000,
    },
    "optimizer": {"lr": 2.0e-4, "betas": [0.8, 0.99], "eps": 1.0e-9, "weight_decay": 0.0},
    "scheduler": {"gamma": 0.999875},
}

# every dropout rate that models/jets/model.py reads from the generator params
JETS_DROPOUT_KEYS = tuple(
    [f"transformer_{kind}_{rate}" for kind in ("enc", "dec")
     for rate in ("dropout_rate", "positional_dropout_rate", "attn_dropout_rate")]
    + ["duration_predictor_dropout_rate", "pitch_predictor_dropout",
       "energy_predictor_dropout", "pitch_embed_dropout", "energy_embed_dropout"])


def jets_discriminator_params() -> Dict[str, Any]:
    return copy.deepcopy(JETS_DISCRIMINATOR_PARAMS)


def jets_train_conf() -> Dict[str, Any]:
    return copy.deepcopy(JETS_TRAIN)


def jets_lambdas(train_conf: Dict[str, Any]) -> Dict[str, float]:
    """The generator loss weights, by the JAX trainer's names and defaults."""
    loss = train_conf["loss"]
    return {
        "adv": loss.get("lambda_adv", 1.0),
        "mel": loss.get("lambda_mel", 45.0),
        "fm": loss.get("lambda_feat_match", 2.0),
        "var": loss.get("lambda_var", 1.0),
        "align": loss.get("lambda_align", 2.0),
    }


def fastspeech2_train_conf() -> Dict[str, Any]:
    return copy.deepcopy(FASTSPEECH2_TRAIN)


def fastspeech2_loss_conf(train_conf: Dict[str, Any],
                          hparams: Dict[str, Any]) -> Dict[str, Any]:
    """``FastSpeech2Loss``'s config: the task's loss section plus the model's
    pitch / energy feature levels (as the JAX trainer builds it)."""
    ve = hparams["variance"]["variance_embedding"]
    return dict(copy.deepcopy(train_conf["loss"]), pitch_feature_level=ve["pitch_feature"],
                energy_feature_level=ve["energy_feature"])


def jets_generator_params() -> Dict[str, Any]:
    """A fresh copy of the JETS generator params (callers may edit it)."""
    return copy.deepcopy(JETS_GENERATOR_PARAMS)


def fastspeech2_params() -> Dict[str, Any]:
    """A fresh copy of the FastSpeech2 section (callers may edit it)."""
    return copy.deepcopy(FASTSPEECH2)


def hifigan_params() -> Dict[str, Any]:
    """A fresh copy of the standalone HiFi-GAN section."""
    return copy.deepcopy(HIFIGAN)


def default_audio() -> Dict[str, Any]:
    return copy.deepcopy(AUDIO)


def upsample_factor(audio: Dict[str, Any]) -> int:
    """Total vocoder upsampling (== STFT hop length)."""
    return int(audio["stft"]["hop_length"])
