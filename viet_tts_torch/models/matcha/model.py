"""Matcha-TTS: the conditional flow-matching acoustic model.

Counterpart of ``viet_tts_tpu/models/matcha/model.py``: the RoPE text
encoder gives the prior mu_x, FastSpeech2's ``AlignmentEncoder`` and MAS
learn the durations, the frame prior mu_y is mu_x expanded (softly through
the aligner's attention before ``binarization_start_steps``, by the hard
durations after: a host ``if`` on the step, where the JAX module computes
both under a ``jnp.where``), and OT-CFM trains the UNet:
y = (1 - (1 - sigma) t) z + t x1, u = x1 - (1 - sigma) z. Inference is the
fixed-step Euler ODE from noise (zero at the default temperature 0) to a
normalised mel, then the dataset's mel statistics undo the normalisation.
Parameter names follow the reference torch model as
``train/torch_import.py:import_matcha`` reads them.

The random draws of a training forward (the CVAE's noise, the CFM's t and
z) come from an explicit CPU ``torch.Generator``, or are given through
``draws``; ``nn.Dropout`` draws from torch's generator of the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from viet_tts_torch.models.fastspeech2.layers import (
    AccentEncoderNetwork,
    AlignmentEncoder,
    DurationPredictor,
)
from viet_tts_torch.models.matcha.decoder import UNetDecoder
from viet_tts_torch.models.matcha.layers import TextEncoder
from viet_tts_torch.nn.utils import pad_mask_from_lengths
from viet_tts_torch.ops.duration import gaussian_upsample, length_regulator
from viet_tts_torch.ops.mas import binarize_attention


def fix_len_compatibility(length: int, num_downsamplings: int = 2) -> int:
    """Round up to a multiple of 2^num_downsamplings (the UNet's constraint)."""
    f = 2 ** num_downsamplings
    return ((length + f - 1) // f) * f


class CFM(nn.Module):
    """Optimal-transport conditional flow matching around the UNet
    (``estimator``)."""

    def __init__(self, in_channels: int, out_channels: int, decoder_params: Dict[str, Any],
                 sigma_min: float = 1e-4):
        super().__init__()
        p = decoder_params
        self.sigma_min = sigma_min
        self.estimator = UNetDecoder(
            in_channels, out_channels, channels=tuple(p.get("channels", (256, 256))),
            dropout=p.get("dropout", 0.05), attention_head_dim=p.get("attention_head_dim", 64),
            n_blocks=p.get("n_blocks", 1), num_mid_blocks=p.get("num_mid_blocks", 2),
            num_heads=p.get("num_heads", 2),
            down_block_type=p.get("down_block_type", "transformer"),
            mid_block_type=p.get("mid_block_type", "transformer"),
            up_block_type=p.get("up_block_type", "transformer"))

    def forward(self, x1: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor,
                spks: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                t: Optional[torch.Tensor] = None,
                z: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training: (the estimator's vector field, the target u) for the
        CFM MSE. t ~ U(0, 1) per row (B,) and z ~ N(0, 1) like x1 are
        drawn from ``generator`` (a CPU generator) unless given."""
        B = x1.shape[0]
        if t is None:
            t = torch.rand((B,), generator=generator)
        if z is None:
            z = torch.randn(x1.shape, generator=generator)
        t = t.to(device=x1.device, dtype=x1.dtype).reshape(B, 1, 1)
        z = z.to(device=x1.device, dtype=x1.dtype)
        y = (1.0 - (1.0 - self.sigma_min) * t) * z + t * x1
        u = x1 - (1.0 - self.sigma_min) * z
        return self.estimator(y, mask, mu, t[:, 0, 0], spks), u

    def solve(self, mu: torch.Tensor, mask: torch.Tensor, n_timesteps: int,
              temperature: float = 0.0, spks: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Fixed-step Euler from noise to mel: x += dt * v(x, t) at
        t = 0, dt, ..., 1 - dt. The start noise is N(0, 1) times
        ``temperature``, drawn from ``generator``; exactly zero at
        temperature 0 (the JAX module's draw times 0)."""
        if temperature == 0.0:
            x = torch.zeros_like(mu)
        else:
            x = (torch.randn(mu.shape, generator=generator) * temperature).to(mu)
        dt = 1.0 / n_timesteps
        for i in range(n_timesteps):
            t = torch.full((mu.shape[0],), i * dt, dtype=mu.dtype, device=mu.device)
            x = x + dt * self.estimator(x, mask, mu, t, spks)
        return x


class MatchaTTS(nn.Module):
    """Text encoder -> durations -> frame prior -> CFM decoder. ``stats``
    holds the dataset's scalar ``mel_mean`` / ``mel_std`` (the trainer's
    ``stats.json``)."""

    def __init__(self, n_symbols: int, n_channels: int, hparams: Dict[str, Any],
                 stats: Dict[str, Any], n_speakers: int, n_accents: int = 2):
        super().__init__()
        if "mel_mean" not in stats or "mel_std" not in stats:
            raise ValueError(
                "Matcha needs the dataset's mel statistics (mel_mean and mel_std in the "
                "checkpoint's stats.json, written by --task matcha); got keys "
                f"{sorted(stats)}")
        hp = hparams
        self.mel_mean, self.mel_std = float(stats["mel_mean"]), float(stats["mel_std"])
        spk_dim = hp["spk_emb_dim"]
        te = hp["text_encoder"]
        self.encoder = TextEncoder(n_symbols, n_channels, n_speakers, spk_dim, te)
        self.spk_dims = hp.get("spk_dims", -1)
        self.use_cvae = bool(hp.get("use_cvae", False))
        if self.spk_dims is not None and self.spk_dims > 0:
            self.speaker_emb = nn.Linear(self.spk_dims, spk_dim)
        elif self.use_cvae:
            vc = hp["vcae"]
            self.speaker_emb = AccentEncoderNetwork(
                n_speakers, n_accents, spk_dim // 2, idim=n_channels,
                conv_layers=vc["conv_layers"], conv_chans_list=tuple(vc["conv_chans_list"]),
                conv_kernel_size=vc["conv_kernel_size"], conv_stride=vc["conv_stride"],
                gru_layers=vc["gru_layers"], gru_units=vc["gru_units"])
        else:
            self.speaker_emb = nn.Embedding(n_speakers, spk_dim)
        dm = hp["duration_modelling"]
        self.aligner = AlignmentEncoder(n_channels, te["hidden_dim"], n_channels, spk_dim,
                                        dm["aligner_temperature"])
        self.binarization_start_steps = int(dm["binarization_start_steps"])
        vp = hp["variance_predictor"]
        self.duration_predictor = DurationPredictor(
            n_channels, n_channels, vp["dur_predictor_layers"], vp["dur_predictor_kernel"],
            vp["dropout"])
        self.use_gaussian = bool(dm["use_gaussian"])
        self.decoder = CFM(2 * n_channels + spk_dim, n_channels, hp["decoder"],
                           float(hp["flow_matching"].get("sigma_min", 1e-4)))

    def denormalize(self, mel: torch.Tensor) -> torch.Tensor:
        return mel * self.mel_std + self.mel_mean

    def _speaker_vector(self, sids, aids, feats, cvae_eps=None, generator=None):
        """(speaker vector, the CVAE's (mu, logvar) pairs or None)."""
        if self.use_cvae:
            z_acc, _, z_spk, _, accent_probs = self.speaker_emb(feats, aids, sids, cvae_eps,
                                                                generator)
            return torch.cat([z_acc, z_spk], dim=1), accent_probs
        return self.speaker_emb(sids), None

    def _expand(self, x: torch.Tensor, durations: torch.Tensor, txt_valid: torch.Tensor,
                mel_valid: torch.Tensor) -> torch.Tensor:
        if self.use_gaussian:
            return gaussian_upsample(x, durations, h_masks=mel_valid, d_masks=txt_valid)
        return length_regulator(x, durations.to(torch.int64), mel_valid.shape[1])

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor, feats: torch.Tensor,
                feats_lengths: torch.Tensor, sids: Optional[torch.Tensor] = None,
                aids: Optional[torch.Tensor] = None,
                duration: Optional[torch.Tensor] = None, step: int = 0,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Any]] = None) -> Tuple:
        """Training forward (the JAX ``__call__``) on NORMALISED mels
        ``feats``; ``duration`` is the beta-binomial prior (B, T_mel,
        T_text). Returns the reference's 10-tuple (the estimator's output,
        u, mu_y, text pad mask, mel valid mask, feats_lengths, the hard
        durations, the log-duration prediction, the alignment outputs, the
        CVAE's (mu, logvar) pairs). ``draws`` may give the random draws
        (``cvae_eps``: the (acc, spk) noise, ``t``: (B,), ``z``: like
        feats) instead of ``generator``."""
        draws = draws or {}
        sid_embs, accent_probs = self._speaker_vector(sids, aids, feats, draws.get("cvae_eps"),
                                                      generator)
        mu_x, txt_emb, txt_valid = self.encoder(text, text_lengths, sid_embs)
        txt_pad = ~txt_valid
        log_d = self.duration_predictor(mu_x, txt_pad)
        attn_soft, attn_logprob = self.aligner(feats, txt_emb, txt_pad, duration, sid_embs)
        attn_hard = binarize_attention(attn_soft, text_lengths, feats_lengths)
        attn_hard_dur = attn_hard[:, 0].sum(dim=1)
        attn_out = (attn_soft, attn_hard, attn_hard_dur, attn_logprob)

        mel_valid = ~pad_mask_from_lengths(feats_lengths, feats.shape[1])
        if duration is not None and step < self.binarization_start_steps:
            mu_y = torch.einsum("bmt,bth->bmh", attn_soft[:, 0].to(mu_x.dtype), mu_x)
        else:
            mu_y = self._expand(mu_x, attn_hard_dur, txt_valid, mel_valid)
        mask3 = mel_valid[..., None].to(feats.dtype)
        dec_outs, u = self.decoder(feats, mask3, mu_y, sid_embs, generator, draws.get("t"),
                                   draws.get("z"))
        return (dec_outs, u, mu_y, txt_pad, mel_valid, feats_lengths, attn_hard_dur, log_d,
                attn_out, accent_probs)

    @torch.no_grad()
    def inference(self, sids: torch.Tensor, text: torch.Tensor, text_lengths: torch.Tensor,
                  max_mel_frames: int, feats: Optional[torch.Tensor] = None,
                  aids: Optional[torch.Tensor] = None,
                  spk_embs: Optional[torch.Tensor] = None, d_control: float = 1.0,
                  n_timesteps: int = 10, temperature: float = 0.0, p_control: float = 1.0,
                  e_control: float = 1.0, generator: Optional[torch.Generator] = None):
        """Euler-ODE synthesis: (denormalised mel (B, T, n_mels) with T
        ``max_mel_frames`` rounded up to a multiple of 4, mel_lens (B,),
        speaker vector). ``p_control`` / ``e_control`` are accepted for the
        other families' signature and not read."""
        del p_control, e_control
        max_mel_frames = fix_len_compatibility(max_mel_frames)
        if spk_embs is not None:
            sid_embs = spk_embs
        elif self.use_cvae:
            if feats is None or aids is None:
                raise ValueError("CVAE inference needs reference feats and aids")
            sid_embs, _ = self._speaker_vector(sids, aids, feats)
        else:
            sid_embs = self.speaker_emb(sids)
        mu_x, _, txt_valid = self.encoder(text, text_lengths, sid_embs)
        log_d = self.duration_predictor(mu_x, ~txt_valid)
        durations = torch.clamp(torch.round(torch.exp(log_d) - 1.0) * d_control,
                                min=0.0) * txt_valid
        mel_lens = torch.clamp(durations.sum(dim=1), max=max_mel_frames).to(torch.int32)
        mel_valid = ~pad_mask_from_lengths(mel_lens, max_mel_frames)
        mu_y = self._expand(mu_x, durations, txt_valid, mel_valid)
        mask3 = mel_valid[..., None].to(mu_y.dtype)
        dec = self.decoder.solve(mu_y, mask3, n_timesteps, temperature, sid_embs, generator)
        return self.denormalize(dec), mel_lens, sid_embs
