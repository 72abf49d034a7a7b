"""FastSpeech2 acoustic model (conformer or transformer building block):
inference and the teacher-forced training forward.

Counterpart of ``viet_tts_tpu/models/fastspeech2/model.py``: encoder ->
speaker conditioning (CVAE accent + speaker latents, an external vector, or
an id embedding) -> ``VarianceAdaptor`` (duration, pitch and energy) ->
decoder -> ``feats_linear`` -> Postnet residual. Parameter names follow the
reference torch model, as ``train/torch_import.py:import_fastspeech2``
reads them.

Free-running inference as the JAX module runs it: durations
max(round(exp(d) - 1) * d_control, 0) at real tokens, ``mel_lens`` clipped
to the static ``max_mel_frames``, pitch and energy both predicted from the
same x and bucketised with ``searchsorted(bins, side="left")`` before
either embedding is added, then Gaussian upsampling (or the length
regulator).

The teacher-forced forward (``FastSpeech2.forward``, the JAX ``__call__``)
as the JAX module runs it with ``learn_alignment``: the ``AlignmentEncoder``
aligns the mel with the phoneme embeddings under the beta-binomial prior
(the batch's ``duration`` field), MAS binarises the soft alignment, its
column sums are the durations, the pitch and energy targets are averaged
per phoneme over them, and the text states are expanded both softly
(through the soft alignment) and hard (Gaussian upsampling), the soft one
taken while ``step < binarization_start_steps`` (both computed, as the JAX
``jnp.where`` computes both). Training mode (``model.train()``) turns the
dropouts, the batch statistics of the BatchNorms and the CVAE's sampling
on. ``building_block.block_type`` picks the stacks: ``conformer``
(``nn/conformer.py``, attention on the route ``attn_implementation``
names) or ``transformer`` (the FFT blocks of ``nn/transformer.py``, whose
attention is plain PyTorch, as the JAX package's is plain einsums).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from viet_tts_torch.models.fastspeech2.layers import (
    AccentEncoderNetwork,
    AlignmentEncoder,
    DurationPredictor,
    Postnet,
    VariancePredictor,
)
from viet_tts_torch.nn.conformer import ConformerDecoder, ConformerEncoder
from viet_tts_torch.nn.transformer import TransformerDecoder, TransformerEncoder
from viet_tts_torch.nn.utils import pad_mask_from_lengths
from viet_tts_torch.ops.duration import (
    average_by_duration,
    gaussian_upsample,
    length_regulator,
)
from viet_tts_torch.ops.mas import binarize_attention


class VarianceAdaptor(nn.Module):
    """Duration / pitch / energy modelling between encoder and decoder."""

    def __init__(self, n_channels: int, hidden_dim: int, config: Dict[str, Any],
                 stats: Dict[str, Any]):
        super().__init__()
        vp = config["variance_predictor"]
        dm = config["duration_modelling"]
        self.use_gaussian = bool(dm["use_gaussian"])
        self.learn_alignment = bool(config["learn_alignment"])
        self.binarization_start_steps = int(dm.get("binarization_start_steps", 0))
        if self.learn_alignment:
            # keys: the phoneme embeddings; speaker vector: hidden_dim wide
            self.aligner = AlignmentEncoder(n_channels, hidden_dim, n_channels, hidden_dim,
                                            dm["aligner_temperature"])
        self.duration_predictor = DurationPredictor(
            hidden_dim, n_channels, vp["dur_predictor_layers"], vp["dur_predictor_kernel"],
            vp["dropout"])
        self.pitch_predictor = VariancePredictor(
            hidden_dim, vp["filter_size"], vp["pit_predictor_layers"],
            vp["pit_predictor_kernel"], vp["dropout"])
        self.energy_predictor = VariancePredictor(
            hidden_dim, vp["filter_size"], vp["ener_predictor_layers"],
            vp["ener_predictor_kernel"], vp["dropout"])
        ve = config["variance_embedding"]
        n_bins = ve["n_bins"]
        self.pitch_feature_level = ve["pitch_feature"]
        self.energy_feature_level = ve["energy_feature"]
        self.pitch_embedding = nn.Embedding(n_bins, hidden_dim)
        self.energy_embedding = nn.Embedding(n_bins, hidden_dim)

        def make_bins(stat, quantization):
            lo, hi = float(stat["min"]), float(stat["max"])
            if quantization == "log":
                return np.exp(np.linspace(np.log(lo), np.log(hi), n_bins - 1))
            return np.linspace(lo, hi, n_bins - 1)

        # fp32 whatever the model's dtype (kept off the module's buffers, so
        # that a cast to bf16 does not round the bin edges)
        self._bins = {
            "pitch": make_bins(stats["pitch"], ve["pitch_quantization"]).astype(np.float32),
            "energy": make_bins(stats["energy"], ve["energy_quantization"]).astype(np.float32),
        }

    def _bucket(self, kind: str, value: torch.Tensor) -> torch.Tensor:
        embedding = getattr(self, f"{kind}_embedding")
        bins = torch.from_numpy(self._bins[kind]).to(value.device)
        ids = torch.searchsorted(bins, value.float().contiguous(), side="left")
        return embedding(torch.clamp(ids, 0, bins.shape[0]))

    def _embed(self, kind: str, x: torch.Tensor, control: float) -> torch.Tensor:
        predictor = getattr(self, f"{kind}_predictor")
        return self._bucket(kind, predictor(x) * control)

    def _add_variances(self, x: torch.Tensor, level: str, p_control: float,
                       e_control: float) -> torch.Tensor:
        """Both predictors read the same x; the embeddings are added after."""
        embs = [self._embed(kind, x, control)
                for kind, control in (("pitch", p_control), ("energy", e_control))
                if getattr(self, f"{kind}_feature_level") == level]
        for emb in embs:
            x = x + emb
        return x

    def inference(self, x: torch.Tensor, txt_pad_mask: torch.Tensor,
                  spk_emb: Optional[torch.Tensor], max_mel_frames: int,
                  p_control: float = 1.0, e_control: float = 1.0,
                  d_control: float = 1.0):
        """(frame states (B, max_mel_frames, H), mel_lens (B,), mel_pad_mask,
        rounded durations (B, T_text) fp32)."""
        if spk_emb is not None:
            x = x + spk_emb[:, None, :]
        log_d = self.duration_predictor(x, txt_pad_mask)
        durations = torch.clamp(torch.round(torch.exp(log_d.float()) - 1.0) * d_control,
                                min=0.0) * (~txt_pad_mask)
        mel_lens = torch.clamp(durations.sum(dim=1), max=max_mel_frames).to(torch.int32)
        mel_pad = pad_mask_from_lengths(mel_lens, max_mel_frames)
        x = self._add_variances(x, "phoneme_level", p_control, e_control)
        if self.use_gaussian:
            x = gaussian_upsample(x, durations, h_masks=~mel_pad, d_masks=~txt_pad_mask)
        else:
            x = length_regulator(x, durations.to(torch.int64), max_mel_frames)
        x = self._add_variances(x, "frame_level", p_control, e_control)
        return x, mel_lens, mel_pad, durations

    def forward(self, x: torch.Tensor, txt_emb: torch.Tensor, txt_lens: torch.Tensor,
                txt_pad_mask: torch.Tensor, spk_emb: Optional[torch.Tensor],
                mel: torch.Tensor, mel_lens: torch.Tensor, mel_pad_mask: torch.Tensor,
                pitch_target: torch.Tensor, energy_target: torch.Tensor,
                duration_target: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None, step: int = 0):
        """Teacher-forced: ((frame states, log-duration prediction, pitch and
        energy predictions, mel_lens, mel_pad_mask, (soft, hard, hard
        durations, log attention) or None), (durations, pitch target, energy
        target)), the targets phoneme-level where the features are. With
        ``learn_alignment`` the durations come from MAS on the aligner's
        soft attention (``attn_prior`` the beta-binomial prior), otherwise
        from ``duration_target``."""
        if spk_emb is not None:
            x = x + spk_emb[:, None, :]
        log_d = self.duration_predictor(x, txt_pad_mask)
        attn_out = None
        if self.learn_alignment:
            attn_soft, attn_logprob = self.aligner(mel, txt_emb, txt_pad_mask, attn_prior,
                                                   spk_emb)
            attn_hard = binarize_attention(attn_soft, txt_lens, mel_lens)
            durations = attn_hard[:, 0].sum(dim=1)  # (B, T_text)
            attn_out = (attn_soft, attn_hard, durations, attn_logprob)
        else:
            durations = duration_target.to(torch.float32)
        targets = {"pitch": pitch_target, "energy": energy_target}
        preds = {}

        def add_variances(x, level):
            embs = []
            for kind in ("pitch", "energy"):
                if getattr(self, f"{kind}_feature_level") != level:
                    continue
                preds[kind] = getattr(self, f"{kind}_predictor")(x)
                if level == "phoneme_level":
                    targets[kind] = average_by_duration(durations, targets[kind], txt_lens,
                                                        mel_lens)
                embs.append(self._bucket(kind, targets[kind]))
            for emb in embs:
                x = x + emb
            return x

        x = add_variances(x, "phoneme_level")
        if self.use_gaussian:
            hard = gaussian_upsample(x, durations, h_masks=~mel_pad_mask,
                                     d_masks=~txt_pad_mask)
        else:
            hard = length_regulator(x, durations.to(torch.int64), mel_pad_mask.shape[-1])
        if attn_out is not None:
            soft = torch.einsum("bmt,bth->bmh", attn_out[0][:, 0].to(x.dtype), x)
            x = soft if step < self.binarization_start_steps else hard
        else:
            x = hard
        x = add_variances(x, "frame_level")
        return ((x, log_d, preds.get("pitch"), preds.get("energy"), mel_lens, mel_pad_mask,
                 attn_out), (durations, targets["pitch"], targets["energy"]))


class FastSpeech2(nn.Module):
    """Encoder -> speaker conditioning -> VarianceAdaptor -> decoder -> mel."""

    def __init__(self, n_symbols: int, n_channels: int, hparams: Dict[str, Any],
                 stats: Dict[str, Any], n_speakers: int, n_accents: int = 2):
        super().__init__()
        hp = hparams
        block = hp["building_block"]["block_type"]
        if block not in ("transformer", "conformer"):
            raise NotImplementedError(f"unknown building block {block!r}")
        bconf = hp["building_block"][block]
        d_model = hp["encoder_hidden"]
        if block == "transformer":
            common = dict(d_inner=bconf["conv_filter_size"],
                          kernel_sizes=tuple(bconf["conv_kernel_size"]))
            self.encoder = TransformerEncoder(
                n_symbols, hp["encoder_layers"], d_model, hp["max_seq_len"],
                num_heads=bconf["encoder_head"], dropout=bconf["encoder_dropout"], **common)
            self.decoder = TransformerDecoder(
                hp["decoder_layers"], d_model, hp["max_seq_len"],
                num_heads=bconf["decoder_head"], dropout=bconf["decoder_dropout"], **common)
        else:
            common = dict(
                ffn_expansion=bconf["ffn_expansion_factor"],
                conv_expansion=bconf["conv_expansion_factor"],
                kernel_size=bconf["conv_kernel_size"],
                half_step_residual=bconf["half_step_residual"],
                mask_attn_keys=bool(bconf.get("mask_attn_keys", False)),
                attn_implementation=str(hp.get("attn_implementation", "shift")),
            )
            self.encoder = ConformerEncoder(
                n_symbols, hp["encoder_layers"], d_model, hp["max_seq_len"],
                num_heads=bconf["encoder_head"], dropout=bconf["encoder_dropout"], **common)
            self.decoder = ConformerDecoder(
                hp["decoder_layers"], d_model, hp["max_seq_len"],
                num_heads=bconf["decoder_head"], dropout=bconf["decoder_dropout"], **common)
        self.spk_dims = hp.get("spk_dims", -1)
        self.use_cvae = bool(hp.get("use_cvae", False))
        if self.spk_dims != -1:
            self.speaker_emb = nn.Linear(self.spk_dims, d_model)
        elif self.use_cvae:
            vc = hp["vcae"]
            self.speaker_emb = AccentEncoderNetwork(
                n_speakers, n_accents, d_model // 2, idim=n_channels,
                conv_layers=vc["conv_layers"], conv_chans_list=tuple(vc["conv_chans_list"]),
                conv_kernel_size=vc["conv_kernel_size"], conv_stride=vc["conv_stride"],
                gru_layers=vc["gru_layers"], gru_units=vc["gru_units"])
        else:
            self.speaker_emb = nn.Embedding(n_speakers, d_model)
        self.variance_adaptor = VarianceAdaptor(n_channels, d_model, hp["variance"], stats)
        self.feats_linear = nn.Linear(d_model, n_channels)
        self.postnet = None
        if hp.get("use_postnet"):
            pn = hp["postnet"]
            self.postnet = Postnet(n_channels, pn["embedding_dim"], pn["conv_layers"],
                                   pn["kernel_size"])
        self.learn_alignment = bool(hp["variance"]["learn_alignment"])

    def speaker_vector(self, sids: torch.Tensor, feats: Optional[torch.Tensor] = None,
                       aids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_cvae:
            if feats is None or aids is None:
                raise ValueError("CVAE inference needs reference feats and aids")
            z_acc, _, z_spk, _, _ = self.speaker_emb(feats, aids, sids)
            return torch.cat([z_acc, z_spk], dim=1)
        return self.speaker_emb(sids)

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor, feats: torch.Tensor,
                feats_lengths: torch.Tensor, duration: torch.Tensor, pitch: torch.Tensor,
                energy: torch.Tensor, sids: torch.Tensor, aids: Optional[torch.Tensor] = None,
                step: int = 0, generator: Optional[torch.Generator] = None, cvae_eps=None):
        """Teacher-forced forward (the JAX ``__call__``): ``duration`` is the
        beta-binomial prior (B, T_mel, T_text) with ``learn_alignment``, else
        the durations (B, T_text); pitch and energy (B, T_mel) frame values.
        Returns the reference's 12-tuple (feats, postnet feats, log-duration,
        pitch and energy predictions, text_lengths, text pad mask,
        feats_lengths, feats pad mask, the CVAE's (mu, logvar) pairs, the
        alignment outputs, the speaker vector) and (ds, ps, es).
        ``generator`` (a CPU ``torch.Generator``) draws the flash attention's
        dropout seeds and the CVAE's noise, unless ``cvae_eps`` gives that
        ((B, z) acc and spk); ``nn.Dropout`` draws from torch's generator of
        the device."""
        text_pad = pad_mask_from_lengths(text_lengths, text.shape[1])
        mel_pad = pad_mask_from_lengths(feats_lengths, feats.shape[1])
        hs, text_embs = self.encoder(text, text_pad, generator)
        accent_probs = None
        if self.use_cvae:
            z_acc, _, z_spk, _, accent_probs = self.speaker_emb(feats, aids, sids, cvae_eps,
                                                                generator)
            sid_embs = torch.cat([z_acc, z_spk], dim=1)
        else:
            sid_embs = self.speaker_emb(sids)
        (hs, log_d, p_outs, e_outs, feats_lengths, mel_pad, attn_outs), extra = \
            self.variance_adaptor(
                hs, text_embs, text_lengths, text_pad, sid_embs, feats, feats_lengths,
                mel_pad, pitch, energy,
                duration_target=None if self.learn_alignment else duration,
                attn_prior=duration if self.learn_alignment else None, step=step)
        hs, mel_pad = self.decoder(hs, mel_pad, generator)
        outs = self.feats_linear(hs)
        postnet_outs = self.postnet(outs) + outs if self.postnet is not None else None
        return ((outs, postnet_outs, log_d, p_outs, e_outs, text_lengths, text_pad,
                 feats_lengths, mel_pad, accent_probs, attn_outs, sid_embs), extra)

    @torch.no_grad()
    def adapt(self, sids, text, text_lengths, max_mel_frames: int, feats=None, aids=None,
              spk_embs=None, d_control: float = 1.0, p_control: float = 1.0,
              e_control: float = 1.0):
        """Encoder, speaker vector and variance adaptor: (frame states,
        mel_lens, mel_pad_mask, durations, speaker vector)."""
        text_pad = pad_mask_from_lengths(text_lengths, text.shape[1])
        hs, _ = self.encoder(text, text_pad)
        sid_embs = spk_embs if spk_embs is not None else self.speaker_vector(sids, feats, aids)
        hs, mel_lens, mel_pad, durations = self.variance_adaptor.inference(
            hs, text_pad, sid_embs, max_mel_frames, p_control, e_control, d_control)
        return hs, mel_lens, mel_pad, durations, sid_embs

    @torch.no_grad()
    def inference(self, sids: torch.Tensor, text: torch.Tensor, text_lengths: torch.Tensor,
                  max_mel_frames: int, feats: Optional[torch.Tensor] = None,
                  aids: Optional[torch.Tensor] = None,
                  spk_embs: Optional[torch.Tensor] = None, d_control: float = 1.0,
                  p_control: float = 1.0,
                  e_control: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Free-running synthesis: (mel (B, max_mel_frames, n_mels),
        mel_lens (B,), speaker vector). ``spk_embs`` replaces the speaker
        conditioning with a given vector."""
        hs, mel_lens, mel_pad, _, sid_embs = self.adapt(
            sids, text, text_lengths, max_mel_frames, feats, aids, spk_embs, d_control,
            p_control, e_control)
        hs, _ = self.decoder(hs, mel_pad)
        outs = self.feats_linear(hs)
        if self.postnet is not None:
            outs = self.postnet(outs) + outs
        return outs, mel_lens, sid_embs
