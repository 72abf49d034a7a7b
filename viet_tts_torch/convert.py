"""Weights carried across from the JAX package.

``jets_from_jax(variables, hparams)`` turns the JAX ``JETS`` variables
(``{"params", "batch_stats"}`` as numpy arrays) into this package's
``JETS`` state_dict, transformer or conformer stacks (the conformer's
conv-module BatchNorm statistics from ``batch_stats``). It is the inverse
of the JAX package's ``train/torch_import.py:import_jets``, and the port's
parameter names are the reference/espnet torch names that importer reads.

``fastspeech2_from_jax(variables, hparams)``, ``adaspeech_from_jax(variables,
hparams)``, ``matcha_from_jax(variables, hparams)`` and
``hifigan_from_jax(params, hifi_conf)`` do the same for the JAX
``FastSpeech2`` (conformer or transformer block), ``AdaSpeech``,
``MatchaTTS`` and a standalone ``HiFiGANGenerator``, the inverses of
``import_fastspeech2``, ``import_adaspeech``, ``import_matcha`` (which has
no branch for the UNet's conformer blocks: those keep flax's names) and
``import_hifigan_generator``.

``text2wav_from_jax(variables, conf, version)`` is the acoustic one of the
version and the vocoder's under the JAX ``Text2Wav``'s submodule names,
``text2mel.`` and ``mel2wav.``.

``vits2_from_jax(variables, hparams)`` is the inverse of ``import_vits2``
for the JAX ``VITS2`` (every ``transformer_flow_type``, the stochastic or
the deterministic duration predictor). ``import_vits2`` reads no
discriminator, so ``vits2_mpd_from_jax(params)`` and
``duration_discriminator_from_jax(params)`` map the JAX VITS2
``MultiPeriodDiscriminator`` / ``DurationDiscriminator`` params onto the
port's names directly.

``msmpd_from_jax(params)`` does the same for the JAX
``MultiScaleMultiPeriodDiscriminator`` params; the port's names are the
reference's espnet names that ``import_msmpd_discriminator`` reads. Both
keep flax's weight-norm parametrisation: the port's ``weight_g`` is flax's
``scale`` and ``weight_v`` its kernel, so gradients map one to one through
the same layout changes (the GST BatchNorm statistics ride along from
``batch_stats``).

``reference_state_dict(state_dict)`` folds every weight-normed
``(weight_g, weight_v)`` pair into its effective ``weight``: the port's
transposed convs normalise per output channel (as the JAX module does),
which the importer's ``effective_weight`` (torch's per-dim-0 rule) would
misread, while a plain ``weight`` it takes as is.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _linear(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """flax Conv kernel (k, in, out) -> torch Conv1d weight (out, in, k)."""
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _wn_conv1d(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """JAX WNConv1d {conv: {kernel, bias}, wn: {conv/kernel/scale}} ->
    port WNConv1d {weight_v (out, in, k), weight_g (out, 1, 1), bias}."""
    kernel = np.asarray(p["conv"]["kernel"])
    if "wn" in p:
        sd[f"{prefix}.weight_v"] = _t(np.transpose(kernel, (2, 1, 0)))
        scale = np.asarray(p["wn"]["conv/kernel/scale"])
        sd[f"{prefix}.weight_g"] = _t(scale.reshape(-1, 1, 1))
    else:
        sd[f"{prefix}.weight"] = _t(np.transpose(kernel, (2, 1, 0)))
    if "bias" in p["conv"]:
        sd[f"{prefix}.bias"] = _t(p["conv"]["bias"])


def _wn_conv_transpose1d(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """JAX WNConvTranspose1d {kernel_v (k, in, out), kernel_g (out,), bias}
    -> port {weight_v (in, out, k), weight_g (1, out, 1), bias}. The JAX
    module runs the transposed conv as an input-dilated conv, which takes
    the taps in reverse order: flip them back."""
    v = np.asarray(p["kernel_v"])[::-1]
    name = "weight_v" if "kernel_g" in p else "weight"
    sd[f"{prefix}.{name}"] = _t(np.transpose(v, (1, 2, 0)))
    if "kernel_g" in p:
        sd[f"{prefix}.weight_g"] = _t(np.asarray(p["kernel_g"]).reshape(1, -1, 1))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _transformer_stack(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    pos_idx = 0
    if "embed" in p:
        sd[f"{prefix}.embed.0.weight"] = _t(p["embed"]["embedding"])
        pos_idx = 1
    if "pos_enc" in p:
        sd[f"{prefix}.embed.{pos_idx}.alpha"] = _t(np.asarray(p["pos_enc"]["alpha"]).reshape(1))
    i = 0
    while f"layer_{i}" in p:
        lp, tp = p[f"layer_{i}"], f"{prefix}.encoders.{i}"
        _layernorm(sd, f"{tp}.norm1", lp["norm1"])
        _layernorm(sd, f"{tp}.norm2", lp["norm2"])
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            _linear(sd, f"{tp}.self_attn.{name}", lp["self_attn"][name])
        _conv1d(sd, f"{tp}.feed_forward.w_1", lp["feed_forward"]["w_1"])
        _conv1d(sd, f"{tp}.feed_forward.w_2", lp["feed_forward"]["w_2"])
        i += 1
    if "after_norm" in p:
        _layernorm(sd, f"{prefix}.after_norm", p["after_norm"])


def _espnet_conformer_stack(sd: StateDict, prefix: str, p: Dict[str, Any],
                            s: Dict[str, Any], ffn_type: str) -> None:
    """JAX EspnetConformerEncoder (params, batch_stats) -> espnet names
    (``torch_import.py:_espnet_conformer_stack_params``, inverted)."""
    if "embed" in p:
        sd[f"{prefix}.embed.0.weight"] = _t(p["embed"]["embedding"])
    ffn = _conv1d if ffn_type == "conv1d" else _linear
    i = 0
    while f"layer_{i}" in p:
        lp, tp = p[f"layer_{i}"], f"{prefix}.encoders.{i}"
        att = lp["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            _linear(sd, f"{tp}.self_attn.{name}", att[name])
        for name in ("pos_bias_u", "pos_bias_v"):
            sd[f"{tp}.self_attn.{name}"] = _t(att[name])
        for flax_name, torch_name in (("ff", "feed_forward"),
                                      ("ff_macaron", "feed_forward_macaron")):
            if f"{flax_name}_w_1" in lp:
                _layernorm(sd, f"{tp}.norm_{flax_name}", lp[f"norm_{flax_name}"])
                ffn(sd, f"{tp}.{torch_name}.w_1", lp[f"{flax_name}_w_1"])
                ffn(sd, f"{tp}.{torch_name}.w_2", lp[f"{flax_name}_w_2"])
        for name in ("norm_mha", "norm_conv", "norm_final"):
            _layernorm(sd, f"{tp}.{name}", lp[name])
        cm = lp["conv_module"]
        for name in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"):
            _conv1d(sd, f"{tp}.conv_module.{name}", cm[name])
        _batchnorm(sd, f"{tp}.conv_module.norm", cm["norm"],
                   s[f"layer_{i}"]["conv_module"]["norm"])
        i += 1
    _layernorm(sd, f"{prefix}.after_norm", p["after_norm"])


def _predictor(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    i = 0
    while f"conv_{i}" in p:
        _conv1d(sd, f"{prefix}.conv.{i}.0", p[f"conv_{i}"])
        _layernorm(sd, f"{prefix}.conv.{i}.2", p[f"ln_{i}"])
        i += 1
    _linear(sd, f"{prefix}.linear", p["linear"])


def _batchnorm(sd: StateDict, prefix: str, p: Dict[str, Any], s: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _reference_encoder(sd: StateDict, prefix: str, ref: Dict[str, Any],
                       ref_s: Dict[str, Any]) -> None:
    """JAX ``ReferenceEncoder`` {conv_i, bn_i, GRUCell_l} -> espnet names
    (``convs.{3i}``, ``convs.{3i+1}``, ``gru``)."""
    i = 0
    while f"conv_{i}" in ref:
        kernel = np.asarray(ref[f"conv_{i}"]["kernel"])  # (kh, kw, in, out)
        sd[f"{prefix}.convs.{3 * i}.weight"] = _t(np.transpose(kernel, (3, 2, 0, 1)))
        _batchnorm(sd, f"{prefix}.convs.{3 * i + 1}", ref[f"bn_{i}"], ref_s[f"bn_{i}"])
        i += 1
    layer = 0
    while f"GRUCell_{layer}" in ref:
        g = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
             for k, v in ref[f"GRUCell_{layer}"].items()}
        H = g["hr"]["kernel"].shape[0]
        w_ir, w_iz, w_in = g["ir"]["kernel"], g["iz"]["kernel"], g["in"]["kernel"]
        if layer == 0:
            # flax flattens the conv features (F', C); espnet (C, F'):
            # torch column c*F' + f <- flax row f*C + c
            in_dim = w_ir.shape[0]
            C = np.asarray(ref[f"conv_{i - 1}"]["kernel"]).shape[-1]
            f_dim = in_dim // C
            perm = np.arange(in_dim).reshape(f_dim, C).T.reshape(-1)
            w_ir, w_iz, w_in = w_ir[perm], w_iz[perm], w_in[perm]
        gp = f"{prefix}.gru"
        sd[f"{gp}.weight_ih_l{layer}"] = _t(np.concatenate([w_ir, w_iz, w_in], axis=1).T)
        sd[f"{gp}.weight_hh_l{layer}"] = _t(np.concatenate(
            [g["hr"]["kernel"], g["hz"]["kernel"], g["hn"]["kernel"]], axis=1).T)
        # flax's hidden r/z projections have no bias: torch's stay zero
        sd[f"{gp}.bias_ih_l{layer}"] = _t(np.concatenate(
            [g["ir"]["bias"], g["iz"]["bias"], g["in"]["bias"]]))
        sd[f"{gp}.bias_hh_l{layer}"] = _t(np.concatenate(
            [np.zeros(H, np.float32), np.zeros(H, np.float32), g["hn"]["bias"]]))
        layer += 1


def _gst(sd: StateDict, prefix: str, p: Dict[str, Any], s: Dict[str, Any]) -> None:
    _reference_encoder(sd, f"{prefix}.ref_enc", p["ref_enc"], s["ref_enc"])
    sd[f"{prefix}.stl.gst_embs"] = _t(p["stl"]["gst_embs"])
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        _linear(sd, f"{prefix}.stl.mha.{name}", p["stl"][name])


def _hifigan(sd: StateDict, prefix: str, p: Dict[str, Any], n_upsamples: int,
             resblock_dilations) -> None:
    """JAX ``HiFiGANGenerator`` params -> the reference names, under
    ``prefix`` ("" for a standalone generator)."""
    pre = f"{prefix}." if prefix else ""
    _wn_conv1d(sd, f"{pre}input_conv", p["input_conv"])
    if "global_conv" in p:
        _wn_conv1d(sd, f"{pre}global_conv", p["global_conv"])
    n = len(resblock_dilations)
    for i in range(n_upsamples):
        _wn_conv_transpose1d(sd, f"{pre}upsamples.{i}.1", p[f"upsample_{i}"])
        for j in range(n):
            blk = p[f"block_{i}_{j}"]
            for d in range(len(resblock_dilations[j])):
                bp = f"{pre}blocks.{i * n + j}"
                _wn_conv1d(sd, f"{bp}.convs1.{d}.1", blk[f"conv1_{d}"])
                if f"conv2_{d}" in blk:
                    _wn_conv1d(sd, f"{bp}.convs2.{d}.1", blk[f"conv2_{d}"])
    _wn_conv1d(sd, f"{pre}output_conv.1", p["output_conv"])


def jets_from_jax(variables: Dict[str, Any], hparams: Dict[str, Any]) -> StateDict:
    """JAX ``JETS`` variables {params, batch_stats} (numpy leaves) -> the
    port ``JETS`` state_dict (fp32 CPU tensors)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: StateDict = {}
    for part in ("encoder", "decoder"):
        if hparams.get(f"{part}_type", "transformer") == "conformer":
            _espnet_conformer_stack(sd, part, params[part], stats.get(part, {}),
                                    hparams.get("positionwise_layer_type", "conv1d"))
        else:
            _transformer_stack(sd, part, params[part])
    if "gst" in params:
        _gst(sd, "gst", params["gst"], stats["gst"])
    if "sid_emb" in params:
        sd["sid_emb.weight"] = _t(params["sid_emb"]["embedding"])
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _predictor(sd, name, params[name])
    _conv1d(sd, "pitch_embed.0", params["pitch_embed"]["conv"])
    _conv1d(sd, "energy_embed.0", params["energy_embed"]["conv"])
    for name in ("t_conv1", "t_conv2", "f_conv1", "f_conv2", "f_conv3"):
        _conv1d(sd, f"alignment_module.{name}", params["alignment_module"][name])
    _hifigan(sd, "generator", params["generator"],
             len(hparams.get("generator_upsample_scales", (8, 8, 2, 2))),
             hparams.get("generator_resblock_dilations", ((1, 3, 5),) * 3))
    return sd


def hifigan_from_jax(params: Dict[str, Any], hifi_conf: Dict[str, Any]) -> StateDict:
    """JAX standalone ``HiFiGANGenerator`` params (numpy leaves) -> the port
    ``HiFiGANGenerator`` state_dict; ``hifi_conf`` is the ``hifigan``
    section of the model config (``config.hifigan_params()``)."""
    sd: StateDict = {}
    _hifigan(sd, "", params, len(hifi_conf["upsample_rates"]),
             hifi_conf["resblock_dilation_sizes"])
    return sd


def _fs2_predictor(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """JAX Duration/VariancePredictor -> the reference's ``conv.{i}.1``
    (Conv1d) and ``conv.{i}.3`` (LayerNorm), ``linear``."""
    convs = p["conv"]
    i = 0
    while f"conv_{i}" in convs:
        _conv1d(sd, f"{prefix}.conv.{i}.1", convs[f"conv_{i}"])
        _layernorm(sd, f"{prefix}.conv.{i}.3", convs[f"ln_{i}"])
        i += 1
    _linear(sd, f"{prefix}.linear", p["linear"])
    if "pos_embed_alpha" in p:
        sd[f"{prefix}.pos_embed_alpha"] = _t(np.asarray(p["pos_embed_alpha"]).reshape(1))


def _conformer_ffn(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    _layernorm(sd, f"{prefix}.sequential.0", p["LayerNorm_0"])
    _linear(sd, f"{prefix}.sequential.1.linear", p["Dense_0"])
    _linear(sd, f"{prefix}.sequential.4.linear", p["Dense_1"])


def _conformer_stack(sd: StateDict, prefix: str, p: Dict[str, Any],
                     s: Dict[str, Any]) -> None:
    """JAX ConformerEncoder / ConformerDecoder -> ``layer_stack.{i}``
    (``torch_import.py:_conformer_block_params``, inverted)."""
    if "src_word_emb" in p:
        sd[f"{prefix}.src_word_emb.weight"] = _t(p["src_word_emb"]["embedding"])
    i = 0
    while f"layer_{i}" in p:
        lp, block = p[f"layer_{i}"], f"{prefix}.layer_stack.{i}"
        _conformer_ffn(sd, f"{block}.sequential.0.module", lp["ff1"])
        mhsa = f"{block}.sequential.1.module"
        _layernorm(sd, f"{mhsa}.layer_norm", lp["mhsa_ln"])
        att = lp["mhsa"]
        for name in ("query_proj", "key_proj", "value_proj", "out_proj"):
            _linear(sd, f"{mhsa}.attention.{name}.linear", att[name])
        _linear(sd, f"{mhsa}.attention.pos_proj.linear", att["pos_proj"])
        sd[f"{mhsa}.attention.u_bias"] = _t(att["u_bias"])
        sd[f"{mhsa}.attention.v_bias"] = _t(att["v_bias"])
        conv, cp = f"{block}.sequential.2.module.sequential", lp["conv"]
        _layernorm(sd, f"{conv}.0", cp["LayerNorm_0"])
        _conv1d(sd, f"{conv}.2.conv", cp["pw_conv1"])
        _conv1d(sd, f"{conv}.4.conv", cp["dw_conv"])
        _batchnorm(sd, f"{conv}.5", cp["bn"], s[f"layer_{i}"]["conv"]["bn"])
        _conv1d(sd, f"{conv}.7.conv", cp["pw_conv2"])
        _conformer_ffn(sd, f"{block}.sequential.3.module", lp["ff2"])
        _layernorm(sd, f"{block}.sequential.4", lp["final_ln"])
        i += 1


def _fft_stack(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """JAX TransformerEncoder / Decoder (FFT blocks) or their CLN versions ->
    ``layer_stack.{i}`` (``torch_import.py:_fft_block_params`` and
    ``_cln_fft_block_params``, inverted); a CLN sits under the reference's
    ``layer_norm`` name."""
    if "src_word_emb" in p:
        sd[f"{prefix}.src_word_emb.weight"] = _t(p["src_word_emb"]["embedding"])
    i = 0
    while f"layer_{i}" in p:
        lp, block = p[f"layer_{i}"], f"{prefix}.layer_stack.{i}"
        for part, names in (("slf_attn", ("w_qs", "w_ks", "w_vs", "fc")),
                            ("pos_ffn", ("w_1", "w_2"))):
            layer = _linear if part == "slf_attn" else _conv1d
            for name in names:
                layer(sd, f"{block}.{part}.{name}", lp[part][name])
            if "cln" in lp[part]:
                _cln(sd, f"{block}.{part}.layer_norm", lp[part]["cln"])
            else:
                _layernorm(sd, f"{block}.{part}.layer_norm", lp[part]["layer_norm"])
        i += 1


def _cln(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    _linear(sd, f"{prefix}.W_scale", p["W_scale"])
    _linear(sd, f"{prefix}.W_bias", p["W_bias"])


def _speaker_emb(sd: StateDict, spk: Dict[str, Any], spk_stats: Dict[str, Any]) -> None:
    """The CVAE (espnet reference encoder + heads), an external vector's
    projection, or an id embedding, under ``speaker_emb``."""
    if "cvae" in spk:
        _reference_encoder(sd, "speaker_emb.encoder", spk["encoder"], spk_stats["encoder"])
        for tag in ("acc", "spk"):
            sd[f"speaker_emb.cvae.embedding_layer_{tag}.weight"] = _t(
                spk["cvae"][f"embedding_layer_{tag}"]["embedding"])
            _linear(sd, f"speaker_emb.cvae.linear_model_{tag}.0", spk["cvae"][f"linear_{tag}"])
            _linear(sd, f"speaker_emb.cvae.mu_layer_{tag}.linear", spk["cvae"][f"mu_{tag}"])
            _linear(sd, f"speaker_emb.cvae.logvar_layer_{tag}.linear",
                    spk["cvae"][f"logvar_{tag}"])
    elif "kernel" in spk:
        _linear(sd, "speaker_emb", spk)
    else:
        sd["speaker_emb.weight"] = _t(spk["embedding"])


def _aligner(sd: StateDict, prefix: str, al: Dict[str, Any]) -> None:
    """JAX AlignmentEncoder -> the names ``_aligner_params`` reads."""
    for jname, tname in (("key_conv1", "key_proj.0"), ("key_conv2", "key_proj.2"),
                         ("query_conv1", "query_proj.0"), ("query_conv2", "query_proj.2"),
                         ("query_conv3", "query_proj.4")):
        _conv1d(sd, f"{prefix}.{tname}.conv", al[jname])
    for name in ("key_spk_proj", "query_spk_proj"):
        _linear(sd, f"{prefix}.{name}.linear", al[name])


def _postnet(sd: StateDict, p: Dict[str, Any], s: Dict[str, Any]) -> None:
    i = 0
    while f"conv_{i}" in p:
        _conv1d(sd, f"postnet.convolutions.{i}.0.conv", p[f"conv_{i}"])
        _batchnorm(sd, f"postnet.convolutions.{i}.1", p[f"bn_{i}"], s[f"bn_{i}"])
        i += 1


def fastspeech2_from_jax(variables: Dict[str, Any], hparams: Dict[str, Any]) -> StateDict:
    """JAX ``FastSpeech2`` variables {params, batch_stats} (numpy leaves,
    conformer or transformer block) -> the port ``FastSpeech2`` state_dict
    (fp32 CPU tensors), under the reference names that
    ``import_fastspeech2`` reads."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: StateDict = {}
    if hparams["building_block"]["block_type"] == "transformer":
        _fft_stack(sd, "encoder", params["encoder"])
        _fft_stack(sd, "decoder", params["decoder"])
    else:
        _conformer_stack(sd, "encoder", params["encoder"], stats["encoder"])
        _conformer_stack(sd, "decoder", params["decoder"], stats["decoder"])
    _speaker_emb(sd, params["speaker_emb"], stats.get("speaker_emb", {}))
    va = params["variance_adaptor"]
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _fs2_predictor(sd, f"variance_adaptor.{name}", va[name])
    for name in ("pitch_embedding", "energy_embedding"):
        sd[f"variance_adaptor.{name}.weight"] = _t(va[name]["embedding"])
    if "aligner" in va:
        _aligner(sd, "variance_adaptor.aligner", va["aligner"])
    _linear(sd, "feats_linear", params["feats_linear"])
    if "postnet" in params:
        _postnet(sd, params["postnet"], stats["postnet"])
    return sd


def _conv_ln_stack(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """JAX ``_ConvLNStack`` {conv_i, ln_i} -> the reference's named
    ``conv1d_{1,2}`` / ``layer_norm_{1,2}`` (``_conv_ln_stack_params``)."""
    for i in range(2):
        _conv1d(sd, f"{prefix}.conv1d_{i + 1}", p[f"conv_{i}"])
        _layernorm(sd, f"{prefix}.layer_norm_{i + 1}", p[f"ln_{i}"])


def adaspeech_from_jax(variables: Dict[str, Any], hparams: Dict[str, Any]) -> StateDict:
    """JAX ``AdaSpeech`` variables {params, batch_stats} (numpy leaves) ->
    the port ``AdaSpeech`` state_dict (fp32 CPU tensors), under the
    reference names that ``import_adaspeech`` reads: the CLN FFT stacks,
    the speaker conditioning, the variance adaptor's predictors, embeddings,
    aligner and acoustic-condition encoders under ``variance_adaptor.``, the
    final ``cln``, ``feats_linear`` and the Postnet."""
    del hparams  # the layout is read from the variables
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: StateDict = {}
    _fft_stack(sd, "encoder", params["encoder"])
    _fft_stack(sd, "decoder", params["decoder"])
    _speaker_emb(sd, params["speaker_emb"], stats.get("speaker_emb", {}))
    va = "variance_adaptor"
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _fs2_predictor(sd, f"{va}.{name}", params[name])
    for name in ("pitch_embedding", "energy_embedding"):
        sd[f"{va}.{name}.weight"] = _t(params[name]["embedding"])
    if "aligner" in params:
        _aligner(sd, f"{va}.aligner", params["aligner"])
    _conv_ln_stack(sd, f"{va}.utterance_encoder.conv", params["utterance_encoder"]["conv"])
    for name in ("phoneme_level_encoder", "phoneme_level_predictor"):
        _conv_ln_stack(sd, f"{va}.{name}.conv", params[name]["conv"])
        _linear(sd, f"{va}.{name}.linear", params[name]["linear"])
    _linear(sd, f"{va}.phone_level_embed", params["phone_level_embed"])
    _cln(sd, "cln", params["cln"])
    _linear(sd, "feats_linear", params["feats_linear"])
    if "postnet" in params:
        _postnet(sd, params["postnet"], stats["postnet"])
    return sd


def _channel_ln(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    sd[f"{prefix}.gamma"] = _t(p["gamma"])
    sd[f"{prefix}.beta"] = _t(p["beta"])


def _matcha_text_encoder(sd: StateDict, p: Dict[str, Any]) -> None:
    """JAX ``TextEncoder`` -> ``encoder.`` (``_matcha_encoder_params`` and
    ``_matcha_prenet_params``, inverted)."""
    sd["encoder.src_word_emb.weight"] = _t(p["src_word_emb"]["embedding"])
    if "prenet" in p:
        pn = p["prenet"]
        i = 0
        while f"conv_{i}" in pn:
            _conv1d(sd, f"encoder.prenet.conv_layers.{i}", pn[f"conv_{i}"])
            _channel_ln(sd, f"encoder.prenet.norm_layers.{i}", pn[f"norm_{i}"])
            i += 1
        _conv1d(sd, "encoder.prenet.proj", pn["proj"])
    enc = p["encoder"]
    i = 0
    while f"attn_{i}" in enc:
        ep = "encoder.encoder"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv1d(sd, f"{ep}.attn_layers.{i}.{name}", enc[f"attn_{i}"][name])
        _channel_ln(sd, f"{ep}.norm_layers_1.{i}", enc[f"norm1_{i}"])
        for name in ("conv_1", "conv_2"):
            _conv1d(sd, f"{ep}.ffn_layers.{i}.{name}", enc[f"ffn_{i}"][name])
        _channel_ln(sd, f"{ep}.norm_layers_2.{i}", enc[f"norm2_{i}"])
        i += 1
    _conv1d(sd, "encoder.proj_m", p["proj_m"])


def _unet_block1d(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    _conv1d(sd, f"{prefix}.block.0", p["conv"])
    _layernorm(sd, f"{prefix}.block.1", p["norm"])


def _unet_resnet(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    _unet_block1d(sd, f"{prefix}.block1", p["block1"])
    _unet_block1d(sd, f"{prefix}.block2", p["block2"])
    _linear(sd, f"{prefix}.mlp.1", p["mlp"])
    _conv1d(sd, f"{prefix}.res_conv", p["res_conv"])


def _unet_attention_block(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """A transformer block under the reference's diffusers names
    (``_unet_transformer_params``, inverted), or a conformer block under
    flax's names (the reference has none)."""
    if "rel_pos_emb" in p:
        for name, leaf in p.items():
            if name == "rel_pos_emb":
                sd[f"{prefix}.rel_pos_emb"] = _t(leaf)
            elif name == "conv_dw":
                _conv1d(sd, f"{prefix}.conv_dw", leaf)
            elif "scale" in leaf:
                _layernorm(sd, f"{prefix}.{name}", leaf)
            else:
                _linear(sd, f"{prefix}.{name}", leaf)
        return
    _layernorm(sd, f"{prefix}.norm1", p["norm1"])
    for name in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.attn1.{name}", p[name])
    _linear(sd, f"{prefix}.attn1.to_out.0", p["to_out"])
    _layernorm(sd, f"{prefix}.norm3", p["norm3"])
    _linear(sd, f"{prefix}.ff.net.0.proj", p["ff"]["proj_in"])
    sd[f"{prefix}.ff.net.0.alpha"] = _t(p["ff"]["alpha"])
    sd[f"{prefix}.ff.net.0.beta"] = _t(p["ff"]["beta"])
    _linear(sd, f"{prefix}.ff.net.2", p["ff"]["proj_out"])


def _unet_decoder(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """JAX ``UNetDecoder`` -> the reference's names
    (``_unet_decoder_params``, inverted). The transposed convs' kernels are
    stored for an input-dilated conv, which takes the taps in reverse
    order: flipped back for ``ConvTranspose1d``."""
    for name in ("linear_1", "linear_2"):
        _linear(sd, f"{prefix}.time_mlp.{name}", p["time_mlp"][name])
    for stage in ("down", "mid", "up"):
        i = 0
        while f"{stage}_res_{i}" in p:
            sp = f"{prefix}.{stage}_blocks.{i}"
            _unet_resnet(sd, f"{sp}.0", p[f"{stage}_res_{i}"])
            j = 0
            while f"{stage}_tf_{i}_{j}" in p:
                _unet_attention_block(sd, f"{sp}.1.{j}", p[f"{stage}_tf_{i}_{j}"])
                j += 1
            if f"{stage}_kernel_{i}" in p:
                kernel = np.asarray(p[f"{stage}_kernel_{i}"])[::-1]  # (k, in, out)
                sd[f"{sp}.2.conv.weight"] = _t(np.transpose(kernel, (1, 2, 0)))
                sd[f"{sp}.2.conv.bias"] = _t(p[f"{stage}_bias_{i}"])
            elif f"{stage}_conv_{i}" in p:
                is_last = f"{stage}_res_{i + 1}" not in p
                _conv1d(sd, f"{sp}.2" if is_last else f"{sp}.2.conv", p[f"{stage}_conv_{i}"])
            i += 1
    _unet_block1d(sd, f"{prefix}.final_block", p["final_block"])
    _conv1d(sd, f"{prefix}.final_proj", p["final_proj"])


def matcha_from_jax(variables: Dict[str, Any], hparams: Dict[str, Any]) -> StateDict:
    """JAX ``MatchaTTS`` variables {params, batch_stats} (numpy leaves) ->
    the port ``MatchaTTS`` state_dict (fp32 CPU tensors), under the
    reference names that ``import_matcha`` reads: the text encoder, the
    speaker conditioning, the aligner, the duration predictor and the
    UNet under ``decoder.estimator.``."""
    del hparams  # the layout is read from the variables
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: StateDict = {}
    _matcha_text_encoder(sd, params["encoder"])
    _speaker_emb(sd, params["speaker_emb"], stats.get("speaker_emb", {}))
    _aligner(sd, "aligner", params["aligner"])
    _fs2_predictor(sd, "duration_predictor", params["duration_predictor"])
    _unet_decoder(sd, "decoder.estimator", params["decoder"]["estimator"])
    return sd


def text2wav_from_jax(variables: Dict[str, Any], conf: Dict[str, Any],
                      version: str = "fastspeech2") -> StateDict:
    """JAX ``Text2Wav`` variables {params, batch_stats} (numpy leaves) ->
    the port ``Text2Wav`` state_dict: ``fastspeech2_from_jax`` (or
    ``adaspeech_from_jax`` / ``matcha_from_jax``) of the ``text2mel``
    subtree under ``text2mel.`` (its BatchNorm statistics included) and
    ``hifigan_from_jax`` of ``mel2wav`` under ``mel2wav.``; ``conf`` is the merged config
    (``models.<version>``, ``models.hifigan``)."""
    params = variables["params"]
    acoustic = {"adaspeech": adaspeech_from_jax,
                "matcha": matcha_from_jax}.get(version, fastspeech2_from_jax)
    fs2 = acoustic({"params": params["text2mel"],
                    "batch_stats": variables.get("batch_stats", {}).get("text2mel", {})},
                   conf["models"][version])
    voc = hifigan_from_jax(params["mel2wav"], conf["models"]["hifigan"])
    return {**{f"text2mel.{k}": v for k, v in fs2.items()},
            **{f"mel2wav.{k}": v for k, v in voc.items()}}


def _wn_conv2d(sd: StateDict, prefix: str, conv: Dict[str, Any],
               scale: Any) -> None:
    """flax Conv (kh, kw, in, out) + WeightNorm scale -> port WNConv
    {weight_v (out, in, kh, kw), weight_g (out, 1, 1, 1), bias}."""
    kernel = np.asarray(conv["kernel"])
    sd[f"{prefix}.weight_v"] = _t(np.transpose(kernel, (3, 2, 0, 1)))
    sd[f"{prefix}.weight_g"] = _t(np.asarray(scale).reshape(-1, 1, 1, 1))
    sd[f"{prefix}.bias"] = _t(conv["bias"])


def msmpd_from_jax(params: Dict[str, Any]) -> StateDict:
    """JAX ``MultiScaleMultiPeriodDiscriminator`` params (numpy leaves) ->
    the port's state_dict. Period discriminators go in ascending period
    order, the order of the config's ``periods``."""
    sd: StateDict = {}
    msd = params["msd"]
    for s in range(len(msd)):
        scale = msd[f"scale_{s}"]
        names = (["layer_0"] + [f"layer_{i}" for i in range(1, len(scale) - 2)]
                 + ["layer_pre_out", "layer_out"])
        for li, name in enumerate(names):
            prefix = f"msd.discriminators.{s}.layers.{li}"
            if name != "layer_out":
                prefix += ".0"
            _wn_conv1d(sd, prefix, scale[name])
    periods = sorted(params["mpd"], key=lambda k: int(k.split("_")[1]))
    for i, key in enumerate(periods):
        per = params["mpd"][key]
        n = sum(1 for k in per if k.startswith("conv_"))
        for li in range(n):
            _wn_conv2d(sd, f"mpd.discriminators.{i}.convs.{li}.0", per[f"conv_{li}"],
                       per[f"wn_{li}"][f"conv_{li}/kernel/scale"])
        _wn_conv2d(sd, f"mpd.discriminators.{i}.output_conv", per["output_conv"],
                   per["wn_out"]["output_conv/kernel/scale"])
    return sd


def _vits_ln(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """flax LayerNorm {scale, bias} -> the VITS LayerNorm's gamma / beta."""
    sd[f"{prefix}.gamma"] = _t(p["scale"])
    sd[f"{prefix}.beta"] = _t(p["bias"])


def _vits_attention(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
        _conv1d(sd, f"{prefix}.{name}", p[name])
    for name in ("emb_rel_k", "emb_rel_v"):
        if name in p:
            sd[f"{prefix}.{name}"] = _t(p[name])


def _vits_encoder(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """VitsEncoder (attn_i, norm1_i, ffn_i, norm2_i, spk_emb_linear) or
    CausalFFT (attn_i, norm0_i, ffn_i, norm1_i, cond_layer, cond_pre)."""
    causal = "norm0_0" in p
    attn = "self_attn_layers" if causal else "attn_layers"
    norms = (("norm0", "norm_layers_0"), ("norm1", "norm_layers_1")) if causal else (
        ("norm1", "norm_layers_1"), ("norm2", "norm_layers_2"))
    i = 0
    while f"attn_{i}" in p:
        _vits_attention(sd, f"{prefix}.{attn}.{i}", p[f"attn_{i}"])
        for flax_name, name in norms:
            _vits_ln(sd, f"{prefix}.{name}.{i}", p[f"{flax_name}_{i}"])
        for conv in ("conv_1", "conv_2"):
            _conv1d(sd, f"{prefix}.ffn_layers.{i}.{conv}", p[f"ffn_{i}"][conv])
        i += 1
    if "spk_emb_linear" in p:
        _linear(sd, f"{prefix}.spk_emb_linear", p["spk_emb_linear"])
    if "cond_layer" in p:  # CausalFFT's Dense, stored as a 1x1 conv
        sd[f"{prefix}.cond_layer.weight"] = _t(np.asarray(p["cond_layer"]["kernel"]).T[..., None])
        sd[f"{prefix}.cond_layer.bias"] = _t(p["cond_layer"]["bias"])
        _conv1d(sd, f"{prefix}.cond_pre", p["cond_pre"])


def _wn_stack(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    i = 0
    while f"in_{i}" in p:
        _wn_conv1d(sd, f"{prefix}.in_layers.{i}", p[f"in_{i}"])
        _wn_conv1d(sd, f"{prefix}.res_skip_layers.{i}", p[f"res_skip_{i}"])
        i += 1
    if "cond_layer" in p:
        _wn_conv1d(sd, f"{prefix}.cond_layer", p["cond_layer"])


def _dds_conv(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    i = 0
    while f"conv_sep_{i}" in p:
        _conv1d(sd, f"{prefix}.convs_sep.{i}", p[f"conv_sep_{i}"])
        _conv1d(sd, f"{prefix}.convs_1x1.{i}", p[f"conv_1x1_{i}"])
        _vits_ln(sd, f"{prefix}.norms_1.{i}", p[f"norm1_{i}"])
        _vits_ln(sd, f"{prefix}.norms_2.{i}", p[f"norm2_{i}"])
        i += 1


def _vits_module(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    """A VITS2 submodule by its flax children's names: plain convs, the WN
    or CausalFFT ``enc``, a ``pre_transformer`` / ``encoder`` stack, a
    DDSConv ``convs``, flows ``flows_i`` / ``post_flows_i`` (an
    ElementwiseAffine's m / logs as (C, 1))."""
    for name, child in p.items():
        if name in ("m", "logs"):
            sd[f"{prefix}.{name}"] = _t(np.asarray(child).reshape(-1, 1))
        elif name in ("pre", "post", "proj", "post_pre", "post_proj", "cond", "conv_1",
                      "conv_2"):
            _conv1d(sd, f"{prefix}.{name}", child)
        elif name in ("norm_1", "norm_2"):
            _vits_ln(sd, f"{prefix}.{name}", child)
        elif name == "enc":
            (_wn_stack if "in_0" in child else _vits_encoder)(sd, f"{prefix}.enc", child)
        elif name in ("pre_transformer", "encoder"):
            _vits_encoder(sd, f"{prefix}.{name}", child)
        elif name in ("convs", "post_convs"):
            _dds_conv(sd, f"{prefix}.{name}", child)
        elif name.startswith(("flows_", "post_flows_")):
            group, idx = name.rsplit("_", 1)
            _vits_module(sd, f"{prefix}.{group}.{idx}", child)
        else:
            raise KeyError(f"unknown VITS2 parameter group {prefix}.{name}")


def _vits_generator(sd: StateDict, p: Dict[str, Any], hparams: Dict[str, Any]) -> None:
    _conv1d(sd, "dec.conv_pre", p["conv_pre"])
    _conv1d(sd, "dec.conv_post", p["conv_post"])
    if "cond" in p:
        _conv1d(sd, "dec.cond", p["cond"])
    n = len(hparams["resblock_kernel_sizes"])
    for i in range(len(hparams["upsample_rates"])):
        _wn_conv_transpose1d(sd, f"dec.ups.{i}", p[f"up_{i}"])
        for j in range(n):
            for name, conv in p[f"res_{i}_{j}"].items():
                kind, d = name.rsplit("_", 1)  # conv1_d, conv2_d or conv_d
                group = {"conv1": "convs1", "conv2": "convs2", "conv": "convs"}[kind]
                _wn_conv1d(sd, f"dec.resblocks.{i * n + j}.{group}.{d}", conv)


def vits2_from_jax(variables: Dict[str, Any], hparams: Dict[str, Any]) -> StateDict:
    """JAX ``VITS2`` variables {params} (numpy leaves) -> the port ``VITS2``
    state_dict (fp32 CPU tensors) under the reference names that
    ``import_vits2`` reads."""
    params = variables["params"]
    sd: StateDict = {"emb_g.weight": _t(params["emb_g"]["embedding"]),
                     "enc_p.emb.weight": _t(params["enc_p"]["emb"]["embedding"])}
    _vits_encoder(sd, "enc_p.encoder", params["enc_p"]["encoder"])
    _conv1d(sd, "enc_p.proj", params["enc_p"]["proj"])
    _vits_module(sd, "enc_q", params["enc_q"])
    _vits_generator(sd, params["dec"], hparams)
    _vits_module(sd, "flow", params["flow"])
    _vits_module(sd, "dp", params["dp"])
    return sd


def vits2_mpd_from_jax(params: Dict[str, Any]) -> StateDict:
    """JAX VITS2 ``MultiPeriodDiscriminator`` params (numpy leaves) -> the
    port's state_dict: the scale discriminator first, then the period
    ones in ascending period order (the config's ``mpd_periods`` order)."""
    sd: StateDict = {}
    s = params["disc_s"]
    i = 0
    while f"conv_{i}" in s:
        _wn_conv1d(sd, f"discriminators.0.convs.{i}", s[f"conv_{i}"])
        i += 1
    _wn_conv1d(sd, "discriminators.0.conv_post", s["conv_post"])
    periods = sorted((k for k in params if k.startswith("disc_p")), key=lambda k: int(k[6:]))
    for d, key in enumerate(periods, start=1):
        per = params[key]
        i = 0
        while f"conv_{i}" in per:
            _wn_conv2d(sd, f"discriminators.{d}.convs.{i}", per[f"conv_{i}"],
                       per[f"wn_{i}"][f"conv_{i}/kernel/scale"])
            i += 1
        _wn_conv2d(sd, f"discriminators.{d}.conv_post", per["conv_post"],
                   per["wn_post"]["conv_post/kernel/scale"])
    return sd


def duration_discriminator_from_jax(params: Dict[str, Any]) -> StateDict:
    """JAX VITS2 ``DurationDiscriminator`` params (either variant) -> the
    port's state_dict."""
    sd: StateDict = {}
    for name, child in params.items():
        if name == "output_layer":
            _linear(sd, "output_layer.0", child)
        elif "norm" in name:
            _vits_ln(sd, name, child)
        else:
            _conv1d(sd, name, child)
    return sd


@torch.no_grad()
def reference_state_dict(state_dict: StateDict) -> StateDict:
    """A copy of a port state_dict with each (weight_g, weight_v) pair
    replaced by its effective ``weight`` (flax WeightNorm rule: norm per
    output channel, eps 1e-12), on the CPU in fp32."""
    out: StateDict = {}
    for key, val in state_dict.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            prefix = key[: -len(".weight_v")]
            v = val.detach().float().cpu()
            g = state_dict[f"{prefix}.weight_g"].detach().float().cpu()
            # the output-channel axis is where g is not 1-sized
            dims = tuple(d for d in range(v.dim()) if g.shape[d] == 1)
            out[f"{prefix}.weight"] = g * v * torch.rsqrt(
                (v * v).sum(dim=dims, keepdim=True) + 1e-12)
        else:
            out[key] = val.detach().cpu()
    return out
