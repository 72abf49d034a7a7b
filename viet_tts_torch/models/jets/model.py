"""JETS: FastSpeech2 + HiFi-GAN in one graph.

Counterpart of ``viet_tts_tpu/models/jets/model.py``: ``forward`` is the
training forward (the flax ``__call__`` with ``train=True``: alignment
module, MAS, duration-averaged pitch and energy, Gaussian upsampling, a
random segment into the vocoder) returning the reference's 10-tuple;
``inference``, ``inference_hidden`` and ``decode_hidden`` the one-graph
text-to-waveform inference. The module tree and parameter names follow the
reference's espnet-composed torch ``JETS``, so
``train/torch_import.py:import_jets`` reads this model's state_dict (after
``convert.reference_state_dict``).

The encoder and decoder are espnet transformer stacks, or, with
``encoder_type`` / ``decoder_type: conformer``, espnet rel-pos conformer
stacks (``nn/espnet_conformer.py``). ``hparams["attn_implementation"] =
"flash"`` routes their self-attention to kernels K1 (forward, with in-kernel
dropout in training) and K3 (backward) on the transformer, K7 (forward,
bwd-q, bwd-kv) on the "latest" conformer and K6 (forward, bwd-q, bwd-kv) on
the "legacy" one; ``hparams["fused_mrf"] = True`` routes the HiFi-GAN
stages with ch <= 64 to kernel K2, which has no backward (training keeps it
off, as the JAX package does). Dropout follows ``.train()`` / ``.eval()``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from viet_tts_torch.models.hifigan.generator import HiFiGANGenerator
from viet_tts_torch.models.jets.layers import (
    AlignmentModule,
    EspnetDurationPredictor,
    EspnetVariancePredictor,
    StyleEncoder,
    VarianceEmbed,
)
from viet_tts_torch.nn.espnet_conformer import EspnetConformerEncoder
from viet_tts_torch.nn.espnet_transformer import EspnetTransformerEncoder
from viet_tts_torch.nn.utils import pad_mask_from_lengths
from viet_tts_torch.ops.duration import (
    average_by_duration,
    gaussian_upsample,
    length_regulator,
)
from viet_tts_torch.ops.mas import viterbi_decode
from viet_tts_torch.ops.segments import get_random_segments


class JETS(nn.Module):
    def __init__(self, n_symbols: int, n_channels: int,
                 hparams: Dict[str, Any], n_speakers: int = 1):
        super().__init__()
        hp = hparams
        adim = hp["adim"]
        self.n_channels = n_channels
        self.n_speakers = n_speakers
        self.use_gst = bool(hp.get("use_gst", False))
        self.use_gaussian_upsample = bool(hp.get("use_gaussian_upsample", True))
        self.segment_size = int(hp.get("segment_size", 64))
        self.stop_grad_pitch = bool(hp.get("stop_gradient_from_pitch_predictor", True))
        self.stop_grad_energy = bool(hp.get("stop_gradient_from_energy_predictor", False))
        attn = str(hp.get("attn_implementation", "shift"))

        def make_stack(kind: str, n_sym: Optional[int]):
            part = "encoder" if kind == "enc" else "decoder"
            stack = hp.get(f"{part}_type", "transformer")
            if stack == "conformer":
                return EspnetConformerEncoder(
                    d_model=adim,
                    num_heads=hp["aheads"],
                    linear_units=hp["eunits" if kind == "enc" else "dunits"],
                    num_blocks=hp["elayers" if kind == "enc" else "dlayers"],
                    n_symbols=n_sym,
                    kernel_size=hp.get(f"conformer_{kind}_kernel_size",
                                       7 if kind == "enc" else 31),
                    dropout=hp.get(f"transformer_{kind}_dropout_rate", 0.2),
                    positional_dropout=hp.get(
                        f"transformer_{kind}_positional_dropout_rate", 0.2),
                    attn_dropout=hp.get(f"transformer_{kind}_attn_dropout_rate", 0.2),
                    macaron=hp.get("use_macaron_style_in_conformer", True),
                    ffn_type=hp.get("positionwise_layer_type", "conv1d"),
                    ffn_kernel=hp.get("positionwise_conv_kernel_size", 1),
                    legacy=hp.get("conformer_rel_pos_type", "latest") == "legacy",
                    attn_implementation=attn,
                )
            if stack != "transformer":
                raise ValueError(f"{part}_type must be transformer or conformer, "
                                 f"not {stack!r}")
            return EspnetTransformerEncoder(
                d_model=adim,
                num_heads=hp["aheads"],
                linear_units=hp["eunits" if kind == "enc" else "dunits"],
                num_blocks=hp["elayers" if kind == "enc" else "dlayers"],
                n_symbols=n_sym,
                kernel_size=hp.get("positionwise_conv_kernel_size", 3),
                normalize_before=hp.get(f"{part}_normalize_before", True),
                use_scaled_pos_enc=hp.get("use_scaled_pos_enc", True),
                attn_implementation=attn,
                dropout=hp.get(f"transformer_{kind}_dropout_rate", 0.2),
                positional_dropout=hp.get(
                    f"transformer_{kind}_positional_dropout_rate", 0.2),
                attn_dropout=hp.get(f"transformer_{kind}_attn_dropout_rate", 0.2),
            )

        self.encoder = make_stack("enc", n_symbols + 1)
        self.decoder = make_stack("dec", None)
        if self.use_gst:
            self.gst = StyleEncoder(
                idim=n_channels,
                gst_tokens=hp.get("gst_tokens", 10),
                gst_token_dim=adim,
                gst_heads=hp.get("gst_heads", 4),
            )
        if n_speakers > 1:
            self.sid_emb = nn.Embedding(n_speakers, adim)
        self.duration_predictor = EspnetDurationPredictor(
            adim,
            n_layers=hp.get("duration_predictor_layers", 2),
            n_chans=hp.get("duration_predictor_chans", 256),
            kernel_size=hp.get("duration_predictor_kernel_size", 3),
            dropout=hp.get("duration_predictor_dropout_rate", 0.1),
        )
        self.pitch_predictor = EspnetVariancePredictor(
            adim,
            n_layers=hp.get("pitch_predictor_layers", 5),
            n_chans=hp.get("pitch_predictor_chans", 256),
            kernel_size=hp.get("pitch_predictor_kernel_size", 5),
            dropout=hp.get("pitch_predictor_dropout", 0.5),
        )
        self.pitch_embed = VarianceEmbed(adim, hp.get("pitch_embed_kernel_size", 1),
                                         hp.get("pitch_embed_dropout", 0.0))
        self.energy_predictor = EspnetVariancePredictor(
            adim,
            n_layers=hp.get("energy_predictor_layers", 2),
            n_chans=hp.get("energy_predictor_chans", 256),
            kernel_size=hp.get("energy_predictor_kernel_size", 3),
            dropout=hp.get("energy_predictor_dropout", 0.5),
        )
        self.energy_embed = VarianceEmbed(adim, hp.get("energy_embed_kernel_size", 1),
                                          hp.get("energy_embed_dropout", 0.0))
        self.alignment_module = AlignmentModule(adim, n_channels)
        self.generator = HiFiGANGenerator(
            in_channels=adim,
            out_channels=hp.get("generator_out_channels", 1),
            channels=hp.get("generator_channels", 512),
            global_channels=hp.get("generator_global_channels", -1),
            kernel_size=hp.get("generator_kernel_size", 7),
            upsample_scales=tuple(hp.get("generator_upsample_scales", (8, 8, 2, 2))),
            upsample_kernel_sizes=tuple(
                hp.get("generator_upsample_kernel_sizes", (16, 16, 4, 4))),
            resblock_kernel_sizes=tuple(
                hp.get("generator_resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilations=tuple(map(tuple, hp.get(
                "generator_resblock_dilations", ((1, 3, 5),) * 3))),
            use_additional_convs=hp.get("generator_use_additional_convs", True),
            use_weight_norm=hp.get("generator_use_weight_norm", True),
            fused_mrf=bool(hp.get("fused_mrf", False)),
            packed_tail=bool(hp.get("packed_tail", False)),
            grouped_mrf=bool(hp.get("grouped_mrf", False)),
        )
        self.upsample_factor = self.generator.upsample_factor

    def _condition(self, hs: torch.Tensor, feats: torch.Tensor,
                   sids: Optional[torch.Tensor]) -> torch.Tensor:
        if self.use_gst:
            hs = hs + self.gst(feats)[:, None]
        if self.n_speakers > 1 and sids is not None:
            hs = hs + self.sid_emb(sids.reshape(-1))[:, None]
        return hs

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                feats: torch.Tensor, feats_lengths: torch.Tensor,
                pitch: torch.Tensor, energy: torch.Tensor,
                sids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                start_idxs: Optional[torch.Tensor] = None) -> Tuple:
        """Training forward -> (wav_segments (B, 1, S*up), bin_loss,
        log_p_attn, start_idxs, d_outs, ds, p_outs, ps, e_outs, es).

        text (B, T_text) ids; feats (B, T_feats, n_mels); pitch and energy
        (B, T_feats, 1) frame values. ``generator`` (a CPU
        ``torch.Generator``) draws the flash route's dropout seeds and the
        segment starts; ``start_idxs`` (B,) given instead of drawn takes
        the segments there. The JAX module's "noise" and "dropout" rng
        streams cannot be reproduced; its ``nn.Dropout``s are this
        module's, drawing from torch's generator of the device."""
        T_text = text.shape[1]
        text_pad = pad_mask_from_lengths(text_lengths, T_text)
        mel_valid = ~pad_mask_from_lengths(feats_lengths, feats.shape[1])

        hs, _ = self.encoder(text, ~text_pad, generator)
        hs = self._condition(hs, feats, sids)

        log_p_attn = self.alignment_module(hs, feats, text_pad)
        ds, bin_loss = viterbi_decode(log_p_attn, text_lengths, feats_lengths)
        ps = average_by_duration(ds, pitch[..., 0], text_lengths, feats_lengths)[..., None]
        es = average_by_duration(ds, energy[..., 0], text_lengths, feats_lengths)[..., None]

        p_outs = self.pitch_predictor(hs.detach() if self.stop_grad_pitch else hs,
                                      text_pad)
        e_outs = self.energy_predictor(hs.detach() if self.stop_grad_energy else hs,
                                       text_pad)
        d_outs = self.duration_predictor(hs, text_pad)

        hs = hs + self.pitch_embed(ps) + self.energy_embed(es)
        if self.use_gaussian_upsample:
            hs = gaussian_upsample(hs, ds, h_masks=mel_valid, d_masks=~text_pad)
        else:
            hs = length_regulator(hs, ds.to(torch.int64), feats.shape[1])
        zs, _ = self.decoder(hs, mel_valid, generator)

        z_segments, z_start_idxs = get_random_segments(
            zs.transpose(1, 2), feats_lengths, self.segment_size, generator,
            start_idxs)
        wav = self.generator(z_segments.transpose(1, 2))  # (B, S*up, 1)
        return (wav.transpose(1, 2), bin_loss, log_p_attn, z_start_idxs,
                d_outs, ds, p_outs, ps, e_outs, es)

    @torch.no_grad()
    def inference(self, sids: torch.Tensor, text: torch.Tensor,
                  text_lengths: torch.Tensor, max_mel_frames: int,
                  feats: Optional[torch.Tensor] = None,
                  d_control: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Text -> waveform. Returns (wav (B, max_mel_frames*upsample),
        wav_lengths). GST needs a reference mel; zeros are used when none is
        given."""
        zs, mel_lens = self.inference_hidden(sids, text, text_lengths,
                                             max_mel_frames, feats, d_control)
        wav = self.decode_hidden(zs)
        return wav, mel_lens * self.upsample_factor

    @torch.no_grad()
    def inference_hidden(self, sids: torch.Tensor, text: torch.Tensor,
                         text_lengths: torch.Tensor, max_mel_frames: int,
                         feats: Optional[torch.Tensor] = None,
                         d_control: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``inference`` up to the vocoder boundary: (zs (B, T_mel, adim),
        mel_lens). Durations are computed in fp32 whatever the weights'
        dtype."""
        T_text = text.shape[1]
        text_pad = pad_mask_from_lengths(text_lengths, T_text)
        hs, _ = self.encoder(text, ~text_pad)
        if feats is None:
            feats = torch.zeros(text.shape[0], 64, self.n_channels,
                                dtype=hs.dtype, device=hs.device)
        hs = self._condition(hs, feats, sids)

        p_outs = self.pitch_predictor(hs, text_pad)
        e_outs = self.energy_predictor(hs, text_pad)
        d_outs = self.duration_predictor(hs, text_pad,
                                         is_inference=True).float()
        if d_control != 1.0:
            d_outs = torch.round(d_outs * d_control)

        hs = hs + self.pitch_embed(p_outs) + self.energy_embed(e_outs)

        mel_lens = torch.clamp(d_outs.sum(dim=1), max=max_mel_frames).to(torch.int32)
        mel_valid = ~pad_mask_from_lengths(mel_lens, max_mel_frames)
        if self.use_gaussian_upsample:
            hs = gaussian_upsample(hs, d_outs, h_masks=mel_valid,
                                   d_masks=~text_pad)
        else:
            hs = length_regulator(hs, d_outs.to(torch.int64), max_mel_frames)
        zs, _ = self.decoder(hs, mel_valid)
        return zs, mel_lens

    @torch.no_grad()
    def decode_hidden(self, zs: torch.Tensor) -> torch.Tensor:
        """Vocoder half of the split inference: zs window -> waveform."""
        return self.generator(zs)[..., 0]
