"""AdaSpeech acoustic model: inference and the teacher-forced training
forward.

Counterpart of ``viet_tts_tpu/models/adaspeech/model.py``: FastSpeech2 with
conditional-LayerNorm FFT blocks conditioned on the speaker vector (CVAE
accent + speaker latents, or an id embedding), plus AdaSpeech's acoustic
conditions: the ``UtteranceEncoder``'s global vector of the (reference)
mel, and the ``PhonemeLevelEncoder``'s latents of the mel averaged per
token (``token_avg_mels``), which the ``PhonemeLevelPredictor`` learns to
predict from the encoder states once training passes
``phoneme_level_encoder_step``. Parameter names follow the reference torch
model, as ``train/torch_import.py:import_adaspeech`` reads them: the
predictors, embeddings, aligner and acoustic-condition encoders under
``variance_adaptor.``, the final CLN as ``cln``.

The variance adaptor is not FastSpeech2's: pitch and energy are both
predicted from the same x and both embeddings added after
(``searchsorted(bins, side="left")``, clipped). The JAX module's two
step-gated selects are host ``if``s on the step count: the latent that
feeds the decoder is the encoder's, detached from step
``phoneme_level_encoder_step`` on, and the frame states are the soft
alignment's expansion before ``binarization_start_steps``, the hard one
after (the JAX ``jnp.where`` computes both; the gradients are the same).
Only phoneme-level pitch and energy train, as in the JAX module.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from viet_tts_torch.models.adaspeech.layers import (
    CLNTransformerDecoder,
    CLNTransformerEncoder,
    ConditionalLayerNorm,
    PhonemeLevelEncoder,
    PhonemeLevelPredictor,
    UtteranceEncoder,
)
from viet_tts_torch.models.fastspeech2.layers import AccentEncoderNetwork, Postnet
from viet_tts_torch.models.fastspeech2.model import VarianceAdaptor
from viet_tts_torch.nn.utils import pad_mask_from_lengths
from viet_tts_torch.ops.duration import average_by_duration, gaussian_upsample, length_regulator
from viet_tts_torch.ops.mas import binarize_attention


def token_avg_mels(duration: torch.Tensor, feats: torch.Tensor,
                   text_lengths: Optional[torch.Tensor],
                   feats_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The per-token summary of a mel that the ``PhonemeLevelEncoder`` reads:
    (B, N) durations, (B, T, C) mel -> (B, N, C).

    Two quirks of the reference (``models/tts/fastspeech2/function.py:
    frame2phoneme``) are kept, as the JAX module keeps them (trained
    encoders expect them): a token's span collapses to ONE scalar, the mean
    over its frames and channels, broadcast over the channels; and the
    averaging is in place, token i overwriting frame row i before the later
    tokens read their spans, so after a zero-duration token a later span
    reads earlier tokens' scalars. A span that overruns the mel (or the
    valid frames) reads an empty slice and gives 0. A loop over the tokens
    (the JAX ``lax.scan``), on per-frame channel means (the scalar collapse
    makes full rows redundant)."""
    B, N = duration.shape
    T = feats.shape[1]
    ds = duration.to(torch.int64)
    if text_lengths is not None:
        ds = ds * (torch.arange(N, device=ds.device)[None, :] < text_lengths[:, None])
    starts = torch.cumsum(ds, dim=-1) - ds
    t = torch.arange(T, device=ds.device)
    buf = feats.mean(dim=-1)
    seg = ((t[None, None, :] >= starts[:, :, None])
           & (t[None, None, :] < (starts + ds)[:, :, None])).to(buf.dtype)  # (B, N, T)
    if feats_lengths is not None:
        seg = seg * (t[None, None, :] < feats_lengths[:, None, None]).to(buf.dtype)
    cnt = seg.sum(dim=-1)
    keep = ((ds > 0) & (cnt > 0)).to(buf.dtype)
    den = torch.clamp(cnt, min=1.0)
    row = t[None, :] == torch.arange(min(N, T), device=ds.device)[:, None]  # (N', T)
    scalars = []
    for i in range(N):
        scalar = (buf * seg[:, i]).sum(dim=-1) / den[:, i] * keep[:, i]
        if i < T:
            buf = torch.where(row[i], scalar[:, None], buf)
        scalars.append(scalar)
    scalars = torch.stack(scalars, dim=1)
    return scalars[..., None].expand(B, N, feats.shape[-1])


class AdaSpeechVarianceAdaptor(VarianceAdaptor):
    """FastSpeech2's aligner, predictors, embeddings and bins, plus the
    acoustic-condition encoders and the latents' projection. Its forward is
    the model's (``AdaSpeech.forward``)."""

    def __init__(self, n_channels: int, hidden_dim: int, config: Dict[str, Any],
                 stats: Dict[str, Any]):
        super().__init__(n_channels, hidden_dim, config, stats)
        re = config["reference_encoder"]
        phn_dim = int(re["phn_latent_dim"])
        ue = re["utterance_encoder"]
        self.utterance_encoder = UtteranceEncoder(n_channels, ue["n_chans"], ue["kernel_size"],
                                                  ue["stride"], ue["dropout_rate"])
        pe = re["phoneme_level_encoder"]
        self.phoneme_level_encoder = PhonemeLevelEncoder(
            n_channels, pe["n_chans"], pe["kernel_size"], pe["dropout_rate"], phn_dim)
        pp = re["phoneme_level_predictor"]
        self.phoneme_level_predictor = PhonemeLevelPredictor(
            hidden_dim, pp["n_chans"], pp["kernel_size"], pp["dropout_rate"], phn_dim)
        self.phone_level_embed = nn.Linear(phn_dim, hidden_dim)

    def variances(self, x: torch.Tensor, targets=None, p_control: float = 1.0,
                  e_control: float = 1.0):
        """Pitch and energy predicted from the same x, each bucketised from
        its target (when given) or its prediction times the control; x plus
        both embeddings, and the predictions."""
        preds, embs = [], []
        for i, (kind, control) in enumerate((("pitch", p_control), ("energy", e_control))):
            pred = getattr(self, f"{kind}_predictor")(x)
            preds.append(pred)
            embs.append(self._bucket(kind, pred * control if targets is None else targets[i]))
        for emb in embs:
            x = x + emb
        return x, preds


class AdaSpeech(nn.Module):
    """CLN encoder -> speaker vector -> duration, acoustic conditions,
    pitch and energy -> expansion -> CLN decoder -> CLN -> mel -> Postnet."""

    def __init__(self, n_symbols: int, n_channels: int, hparams: Dict[str, Any],
                 stats: Dict[str, Any], n_speakers: int, n_accents: int = 2):
        super().__init__()
        hp = hparams
        if hp["building_block"]["block_type"] != "transformer":
            raise NotImplementedError("AdaSpeech CLN blocks are transformer-type")
        bconf = hp["building_block"]["transformer"]
        d_model = hp["encoder_hidden"]
        common = dict(d_inner=bconf["conv_filter_size"],
                      kernel_sizes=tuple(bconf["conv_kernel_size"]))
        self.encoder = CLNTransformerEncoder(
            n_symbols, hp["encoder_layers"], d_model, hp["max_seq_len"], d_model,
            num_heads=bconf["encoder_head"], dropout=bconf["encoder_dropout"], **common)
        self.decoder = CLNTransformerDecoder(
            hp["decoder_layers"], hp["decoder_hidden"], hp["max_seq_len"], d_model,
            num_heads=bconf["decoder_head"], dropout=bconf["decoder_dropout"], **common)
        self.use_cvae = bool(hp.get("use_cvae", False))
        if self.use_cvae:
            vc = hp["vcae"]
            self.speaker_emb = AccentEncoderNetwork(
                n_speakers, n_accents, d_model // 2, idim=n_channels,
                conv_layers=vc["conv_layers"], conv_chans_list=tuple(vc["conv_chans_list"]),
                conv_kernel_size=vc["conv_kernel_size"], conv_stride=vc["conv_stride"],
                gru_layers=vc["gru_layers"], gru_units=vc["gru_units"])
        else:
            self.speaker_emb = nn.Embedding(n_speakers, d_model)
        var = hp["variance"]
        self.variance_adaptor = AdaSpeechVarianceAdaptor(n_channels, d_model, var, stats)
        self.learn_alignment = bool(var["learn_alignment"])
        self.phoneme_level_encoder_step = int(
            var["reference_encoder"]["phoneme_level_encoder_step"])
        self.cln = ConditionalLayerNorm(hp["decoder_hidden"], d_model)
        self.feats_linear = nn.Linear(hp["decoder_hidden"], n_channels)
        self.postnet = None
        if hp.get("use_postnet"):
            pn = hp["postnet"]
            self.postnet = Postnet(n_channels, pn["embedding_dim"], pn["conv_layers"],
                                   pn["kernel_size"])

    def speaker_vector(self, sids: torch.Tensor, feats: Optional[torch.Tensor] = None,
                       aids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_cvae:
            if feats is None or aids is None:
                raise ValueError("CVAE inference needs reference feats and aids")
            z_acc, _, z_spk, _, _ = self.speaker_emb(feats, aids, sids)
            return torch.cat([z_acc, z_spk], dim=1)
        return self.speaker_emb(sids)

    def _expand(self, x: torch.Tensor, durations: torch.Tensor, text_pad: torch.Tensor,
                mel_pad: torch.Tensor) -> torch.Tensor:
        if self.variance_adaptor.use_gaussian:
            return gaussian_upsample(x, durations, h_masks=~mel_pad, d_masks=~text_pad)
        return length_regulator(x, durations.to(torch.int64), mel_pad.shape[-1])

    def _decode(self, x: torch.Tensor, mel_pad: torch.Tensor, sid_embs: torch.Tensor):
        hs, mel_pad = self.decoder(x, mel_pad, sid_embs)
        outs = self.feats_linear(self.cln(hs, sid_embs))
        return outs, mel_pad

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor, feats: torch.Tensor,
                feats_lengths: torch.Tensor, duration: torch.Tensor, pitch: torch.Tensor,
                energy: torch.Tensor, sids: torch.Tensor, aids: Optional[torch.Tensor] = None,
                step: int = 0, generator: Optional[torch.Generator] = None, cvae_eps=None):
        """Teacher-forced forward (the JAX ``__call__``), with FastSpeech2's
        arguments: ``duration`` is the beta-binomial prior (B, T_mel, T_text)
        with ``learn_alignment``, else the durations (B, T_text). Returns the
        12-tuple (feats, postnet feats, log-duration, pitch and energy
        predictions, text_lengths, text pad mask, feats_lengths, feats pad
        mask, the CVAE's (mu, logvar) pairs, the alignment outputs, the
        PhonemeLevelPredictor's latents) and (ds, ps, es, the
        PhonemeLevelEncoder's latents). ``generator`` (a CPU
        ``torch.Generator``) draws the CVAE's noise unless ``cvae_eps``
        gives it; ``nn.Dropout`` draws from torch's generator of the
        device."""
        va = self.variance_adaptor
        if (va.pitch_feature_level, va.energy_feature_level) != ("phoneme_level",) * 2:
            raise ValueError("AdaSpeech trains phoneme-level pitch and energy")
        text_pad = pad_mask_from_lengths(text_lengths, text.shape[1])
        mel_pad = pad_mask_from_lengths(feats_lengths, feats.shape[1])
        accent_probs = None
        if self.use_cvae:
            z_acc, _, z_spk, _, accent_probs = self.speaker_emb(feats, aids, sids, cvae_eps,
                                                                generator)
            sid_embs = torch.cat([z_acc, z_spk], dim=1)
        else:
            sid_embs = self.speaker_emb(sids)
        hs, text_embs = self.encoder(text, text_pad, sid_embs)
        x = hs + sid_embs[:, None, :]
        log_d = va.duration_predictor(x, text_pad)
        attn_outs = None
        if self.learn_alignment:
            attn_soft, attn_logprob = va.aligner(feats, text_embs, text_pad, duration,
                                                 sid_embs)
            attn_hard = binarize_attention(attn_soft, text_lengths, feats_lengths)
            durations = attn_hard[:, 0].sum(dim=1)  # (B, T_text)
            attn_outs = (attn_soft, attn_hard, durations, attn_logprob)
        else:
            durations = duration.to(torch.float32)

        x = x + va.utterance_encoder(feats)
        avg_mels = token_avg_mels(durations, feats, text_lengths, feats_lengths)
        phn_encode = va.phoneme_level_encoder(avg_mels)
        phn_pred = va.phoneme_level_predictor(x)
        distill = step >= self.phoneme_level_encoder_step
        x = x + va.phone_level_embed(phn_encode.detach() if distill else phn_encode)

        pitch_target = average_by_duration(durations, pitch, text_lengths, feats_lengths)
        energy_target = average_by_duration(durations, energy, text_lengths, feats_lengths)
        x, (p_outs, e_outs) = va.variances(x, (pitch_target, energy_target))
        if attn_outs is not None and step < va.binarization_start_steps:
            x = torch.einsum("bmt,bth->bmh", attn_outs[0][:, 0].to(x.dtype), x)
        else:
            x = self._expand(x, durations, text_pad, mel_pad)
        outs, mel_pad = self._decode(x, mel_pad, sid_embs)
        postnet_outs = self.postnet(outs) + outs if self.postnet is not None else None
        return ((outs, postnet_outs, log_d, p_outs, e_outs, text_lengths, text_pad,
                 feats_lengths, mel_pad, accent_probs, attn_outs, phn_pred),
                (durations, pitch_target, energy_target, phn_encode))

    @torch.no_grad()
    def inference(self, sids: torch.Tensor, text: torch.Tensor, text_lengths: torch.Tensor,
                  max_mel_frames: int, feats: Optional[torch.Tensor] = None,
                  aids: Optional[torch.Tensor] = None,
                  spk_embs: Optional[torch.Tensor] = None, d_control: float = 1.0,
                  p_control: float = 1.0, e_control: float = 1.0):
        """Free-running synthesis: (mel (B, max_mel_frames, n_mels), mel_lens
        (B,), speaker vector). With a reference mel ``feats`` the acoustic
        conditions come from it (the utterance vector, and the
        PhonemeLevelEncoder on the mel averaged under the PREDICTED
        durations, as the reference runs inference at step 0); without one
        the PhonemeLevelPredictor's latents stand in."""
        va = self.variance_adaptor
        text_pad = pad_mask_from_lengths(text_lengths, text.shape[1])
        sid_embs = spk_embs if spk_embs is not None else self.speaker_vector(sids, feats, aids)
        hs, _ = self.encoder(text, text_pad, sid_embs)
        x = hs + sid_embs[:, None, :]
        log_d = va.duration_predictor(x, text_pad)
        durations = torch.clamp(torch.round(torch.exp(log_d.float()) - 1.0) * d_control,
                                min=0.0) * (~text_pad)
        mel_lens = torch.clamp(durations.sum(dim=1), max=max_mel_frames).to(torch.int32)
        mel_pad = pad_mask_from_lengths(mel_lens, max_mel_frames)
        if feats is not None:
            x = x + va.utterance_encoder(feats)
            latent = va.phoneme_level_encoder(token_avg_mels(durations, feats, text_lengths,
                                                             None))
        else:
            latent = va.phoneme_level_predictor(x)
        x = x + va.phone_level_embed(latent)
        x, _ = va.variances(x, None, p_control, e_control)
        outs, _ = self._decode(self._expand(x, durations, text_pad, mel_pad), mel_pad,
                               sid_embs)
        if self.postnet is not None:
            outs = self.postnet(outs) + outs
        return outs, mel_lens, sid_embs
