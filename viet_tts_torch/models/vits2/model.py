"""VITS2 end to end.

Counterpart of ``viet_tts_tpu/models/vits2/model.py``: the text encoder's
prior, the mel posterior encoder, the transformer coupling flow, the
noise-scaled monotonic alignment search over the negative cross-entropy
(``ops/mas.py:maximum_path``), the stochastic (or deterministic) duration
predictor and the generator on a random latent segment. Inference: SDP
reverse -> ceil durations -> hard path -> flow reverse -> decode, over a
static frame budget; ``inference_hidden`` / ``decode_hidden`` split it at
the decoder for streaming.

The training forward's random draws (the posterior's noise, the MAS
noise, the SDP's posterior noise and its reverse noise, the segment starts)
come from one CPU ``torch.Generator``, in that order, or from ``draws``:
``{"posterior_eps", "sdp_eps", "mas_eps", "sdp_reverse_eps", "ids_slice"}``
(any subset), so a test can hand over the JAX package's draws. The MAS
noise's std is the population std of the whole padded score tensor, as
``jnp.std``. The JAX package's ``remat`` (a memory option) is not read.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, Optional

import torch
from torch import nn

from viet_tts_torch.models.vits2.layers import (
    PosteriorEncoder,
    ResidualCouplingTransformersBlock,
    StochasticDurationPredictor,
    TextEncoder,
    VitsDurationPredictor,
    VitsGenerator,
    float_mask,
    normal_draw,
)
from viet_tts_torch.ops.mas import maximum_path
from viet_tts_torch.ops.segments import get_random_segments


def generate_path(duration: torch.Tensor, y_mask: torch.Tensor,
                  x_mask: torch.Tensor) -> torch.Tensor:
    """Hard monotonic path from integer durations (B, T_x) -> (B, T_y, T_x)."""
    cum = torch.cumsum(duration, dim=-1)
    t_y = torch.arange(y_mask.shape[1], device=duration.device, dtype=cum.dtype)
    path = ((t_y[None, :, None] < cum[:, None, :])
            & (t_y[None, :, None] >= (cum - duration)[:, None, :]))
    return path.to(y_mask.dtype) * y_mask[..., :1] * x_mask[:, None, :, 0]


def posterior_layers(hp: Dict[str, Any]) -> int:
    """16 (the reference hardcodes it) unless ``posterior_layers`` says
    otherwise; ``n_layers_q`` alone is dead and warns."""
    if "posterior_layers" not in hp and hp.get("n_layers_q", 16) != 16:
        warnings.warn(f"n_layers_q={hp['n_layers_q']} is ignored (the reference hardcodes 16 "
                      "posterior layers; set posterior_layers to change the depth)",
                      stacklevel=2)
    return int(hp.get("posterior_layers", 16))


class VITS2(nn.Module):
    def __init__(self, n_symbols: int, hparams: Dict[str, Any], n_speakers: int = 1,
                 spec_channels: Optional[int] = None, mas_noise_scale_initial: float = 0.01,
                 noise_scale_delta: float = 2e-6):
        super().__init__()
        hp = self.hparams = dict(hparams)
        self.segment_size = int(hp.get("segment_size", 8192))
        inter, hidden = hp["inter_channels"], hp["hidden_channels"]
        gin = self.gin_channels = hp.get("gin_channels", 256)
        spec_ch = spec_channels or (80 if hp.get("use_mel_posterior_encoder", True) else 513)
        self.use_sdp = bool(hp.get("use_sdp", True))
        self.use_noise_scaled_mas = bool(hp.get("use_noise_scaled_mas", True))
        self.mas_noise_scale_initial = mas_noise_scale_initial
        self.noise_scale_delta = noise_scale_delta
        use_spk_enc = bool(hp.get("use_spk_conditioned_encoder", False))

        self.enc_p = TextEncoder(n_symbols, inter, hidden, hp["filter_channels"], hp["n_heads"],
                                 hp["n_layers"], hp["kernel_size"], hp["p_dropout"],
                                 gin_channels=gin if use_spk_enc else 0)
        self.enc_q = PosteriorEncoder(spec_ch, inter, hidden, kernel_size=5, dilation_rate=1,
                                      n_layers=posterior_layers(hp), gin_channels=gin)
        self.emb_g = nn.Embedding(n_speakers, gin)
        if self.use_sdp:
            self.dp = StochasticDurationPredictor(hidden, 192, 3, 0.5,
                                                  n_flows=hp.get("sdp_n_flows", 4),
                                                  gin_channels=gin)
        else:
            self.dp = VitsDurationPredictor(hidden, 256, 3, 0.5, gin_channels=gin)
        self.dec = VitsGenerator(
            inter, resblock=str(hp.get("resblock", "1")),
            resblock_kernel_sizes=tuple(hp["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(map(tuple, hp["resblock_dilation_sizes"])),
            upsample_rates=tuple(hp["upsample_rates"]),
            upsample_initial_channel=hp["upsample_initial_channel"],
            upsample_kernel_sizes=tuple(hp["upsample_kernel_sizes"]), gin_channels=gin)
        self.flow = ResidualCouplingTransformersBlock(
            inter, hidden, kernel_size=5, dilation_rate=1, n_layers=hp.get("flow_wn_layers", 4),
            n_flows=hp.get("n_flows", 4), gin_channels=gin,
            use_transformer_flows=bool(hp.get("use_transformer_flows", True)),
            transformer_flow_type=hp.get("transformer_flow_type", "pre_conv"))
        self.upsample_factor = self.dec.upsample_factor

    def forward(self, text, text_lengths, feats, feats_lengths, sids, step: int = 0,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """Training forward: text (B, T_text), feats (B, T_spec, n_mels) ->
        the reference 8-tuple (o (B, segment, 1), l_length (B,), attn
        (B, T_text, T_spec), ids_slice (B,), x_mask, y_mask, (z, z_p, m_p,
        logs_p, m_q, logs_q) with the prior expanded to frames, (x, logw,
        logw_))."""
        draws = draws or {}
        g = self.emb_g(sids)
        x, m_p, logs_p, x_mask = self.enc_p(text, text_lengths, g=g)
        z, m_q, logs_q, y_mask = self.enc_q(feats, feats_lengths, g=g, generator=generator,
                                            eps=draws.get("posterior_eps"))
        z_p = self.flow(z, y_mask, g=g)

        # the negative cross-entropy for MAS, without gradient
        with torch.no_grad():
            s_p_sq_r = torch.exp(-2.0 * logs_p)  # (B, T_text, D)
            neg1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=-1)[:, None, :]
            neg2 = torch.einsum("byd,btd->byt", -0.5 * z_p ** 2, s_p_sq_r)
            neg3 = torch.einsum("byd,btd->byt", z_p, m_p * s_p_sq_r)
            neg4 = torch.sum(-0.5 * m_p ** 2 * s_p_sq_r, dim=-1)[:, None, :]
            neg_cent = neg1 + neg2 + neg3 + neg4  # (B, T_spec, T_text)
        if self.use_noise_scaled_mas:
            noise_scale = max(self.mas_noise_scale_initial - self.noise_scale_delta * step, 0.0)
            mas_eps = draws.get("mas_eps")
            if mas_eps is None:
                mas_eps = normal_draw(neg_cent.shape, neg_cent, generator)
            neg_cent = neg_cent + torch.std(neg_cent, correction=0) * mas_eps.to(neg_cent) \
                * noise_scale
        attn = maximum_path(neg_cent.transpose(1, 2), text_lengths, feats_lengths)
        w = attn.sum(dim=2)[..., None]  # (B, T_text, 1)

        logw_ = torch.log(w + 1e-6) * x_mask
        if self.use_sdp:
            l_length = self.dp(x, x_mask, w, g=g, generator=generator,
                               e_q=draws.get("sdp_eps")) / torch.sum(x_mask)
            logw = self.dp.reverse(x, x_mask, g=g, noise_scale=1.0, generator=generator,
                                   noise=draws.get("sdp_reverse_eps"))
        else:
            logw = self.dp(x, x_mask, g=g)
            l_length = torch.sum((logw - logw_) ** 2, dim=(1, 2)) / torch.sum(x_mask)

        m_p_y = torch.einsum("bts,btd->bsd", attn, m_p)
        logs_p_y = torch.einsum("bts,btd->bsd", attn, logs_p)
        z_slice, ids_slice = get_random_segments(
            z.transpose(1, 2), feats_lengths, self.segment_size // self.upsample_factor,
            generator=generator, start_idxs=draws.get("ids_slice"))
        o = self.dec(z_slice.transpose(1, 2), g=g)
        return (o, l_length, attn, ids_slice, x_mask, y_mask,
                (z, z_p, m_p_y, logs_p_y, m_q, logs_q), (x, logw, logw_))

    @torch.no_grad()
    def inference_hidden(self, sids, text, text_lengths, max_mel_frames: int,
                         d_control: float = 1.0, noise_scale: float = 0.0,
                         noise_scale_w: float = 0.0,
                         generator: Optional[torch.Generator] = None):
        """``inference`` up to the decoder: (z (B, max_mel_frames, C),
        feats_lengths (B,) int32). Noise is drawn only at a non-zero scale
        (from ``generator``, a seed-0 CPU generator when None)."""
        if generator is None and (noise_scale or noise_scale_w):
            generator = torch.Generator().manual_seed(0)
        g = self.emb_g(sids)
        x, m_p, logs_p, x_mask = self.enc_p(text, text_lengths, g=g)
        if self.use_sdp:
            logw = self.dp.reverse(x, x_mask, g=g, noise_scale=noise_scale_w,
                                   generator=generator)
        else:
            logw = self.dp(x, x_mask, g=g)
        w = torch.exp(logw) * x_mask * d_control
        w_ceil = torch.ceil(w)[..., 0]  # (B, T_text)
        feats_lengths = torch.clamp(w_ceil.sum(dim=-1), 1, max_mel_frames).to(torch.int32)
        y_mask = float_mask(feats_lengths, max_mel_frames, x)
        attn = generate_path(w_ceil, y_mask, x_mask)  # (B, T_y, T_text)
        m_p_y = torch.einsum("byt,btd->byd", attn, m_p)
        logs_p_y = torch.einsum("byt,btd->byd", attn, logs_p)
        z_p = m_p_y
        if noise_scale:
            z_p = z_p + normal_draw(m_p_y.shape, m_p_y, generator) * torch.exp(logs_p_y) \
                * noise_scale
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        return z * y_mask, feats_lengths

    @torch.no_grad()
    def decode_hidden(self, z: torch.Tensor, sids: torch.Tensor) -> torch.Tensor:
        """The decoder half: latents (B, T, C) -> waveform (B, T * up)."""
        return self.dec(z, g=self.emb_g(sids))[..., 0]

    @torch.no_grad()
    def inference(self, sids, text, text_lengths, max_mel_frames: int, d_control: float = 1.0,
                  noise_scale: float = 0.0, noise_scale_w: float = 0.0,
                  generator: Optional[torch.Generator] = None):
        """-> (wav (B, max_mel_frames * up), wav_lengths (B,))."""
        z, feats_lengths = self.inference_hidden(
            sids, text, text_lengths, max_mel_frames, d_control=d_control,
            noise_scale=noise_scale, noise_scale_w=noise_scale_w, generator=generator)
        return self.decode_hidden(z, sids), feats_lengths * self.upsample_factor
