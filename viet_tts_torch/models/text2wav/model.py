"""Text2Wav: the acoustic model and HiFi-GAN composed into one trainable
graph.

Counterpart of ``viet_tts_tpu/models/text2wav/model.py``: ``text2mel`` is
the port's ``FastSpeech2``, ``AdaSpeech`` or ``MatchaTTS`` (``version``,
its ``models.<version>`` section), ``mel2wav`` a ``HiFiGANGenerator``
(``models.hifigan``, no speaker input). The training forward takes a
random ``segment_size`` window of each predicted mel (the Postnet's output
when there is one; Matcha's CFM output, denormalised before the vocoder,
as in the reference) and vocodes only the window; inference chains
``text2mel.inference`` into the vocoder. The submodules carry flax's
names, so the JAX variables map onto them by two prefixes
(``convert.text2wav_from_jax``).

``fused_mrf`` routes the vocoder's ch <= 64 stages to kernel K2, which has
no backward: a serving option, off in training.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from viet_tts_torch.models import ACOUSTIC_FAMILIES, build_acoustic
from viet_tts_torch.models.hifigan import HiFiGANGenerator
from viet_tts_torch.ops.segments import get_random_segments


class Text2Wav(nn.Module):
    def __init__(self, n_symbols: int, n_channels: int, conf: Dict[str, Any],
                 stats: Dict[str, Any], n_speakers: int, n_accents: int = 2,
                 version: str = "fastspeech2", fused_mrf: bool = False):
        super().__init__()
        if version not in ACOUSTIC_FAMILIES:
            raise NotImplementedError(f"Not implemented for {version} yet")
        self.version = version
        self.text2mel = build_acoustic(n_symbols, n_channels, conf, version, stats,
                                       n_speakers=n_speakers, n_accents=n_accents)
        hifi = conf["models"]["hifigan"]
        self.mel2wav = HiFiGANGenerator.from_config(n_channels, hifi, fused_mrf=fused_mrf)
        self.segment_size = int(hifi.get("segment_size", 64))

    @property
    def upsample_factor(self) -> int:
        return self.mel2wav.upsample_factor

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor, feats: torch.Tensor,
                feats_lengths: torch.Tensor, duration: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None, energy: Optional[torch.Tensor] = None,
                sids: Optional[torch.Tensor] = None, aids: Optional[torch.Tensor] = None,
                step: int = 0, generator: Optional[torch.Generator] = None,
                start_idxs: Optional[torch.Tensor] = None, cvae_eps=None) -> Tuple:
        """The teacher-forced acoustic forward, then a vocoded window:
        (outputs, its extra outputs ((ds, ps, es), AdaSpeech's with the
        encoder's latents; None for Matcha), start_idxs). ``outputs[0]`` is
        the waveform of the window (B, segment_size * up, 1), ``outputs[1]``
        the mel window (B, segment_size, n_mels), ``outputs[2]`` None (no
        separate Postnet output), the rest the acoustic model's predictions
        after its two mels, so ``outputs[1:]`` is what ``FastSpeech2Loss``
        (or ``AdaSpeechLoss``) reads. For Matcha ``outputs[1]`` is the
        window of the CFM output (the vocoder reads it denormalised) and
        the rest its predictions after it (u, mu_y, ...), whose u and mu_y
        the loss windows too. ``generator`` (a CPU ``torch.Generator``)
        draws the acoustic model's dropout seeds, CVAE noise (and Matcha's
        flow times and noise), then the windows' starts; given
        ``start_idxs`` (B,) and ``cvae_eps`` replace those draws. Matcha
        reads neither ``pitch`` nor ``energy``."""
        if self.version == "matcha":
            preds = self.text2mel(text, text_lengths, feats, feats_lengths, sids=sids, aids=aids,
                                  duration=duration, step=step, generator=generator,
                                  draws=None if cvae_eps is None else {"cvae_eps": cvae_eps})
            segs, start_idxs = get_random_segments(preds[0].transpose(1, 2), feats_lengths,
                                                   self.segment_size, generator, start_idxs)
            out_segments = segs.transpose(1, 2)
            out_wavs = self.mel2wav(self.text2mel.denormalize(out_segments))
            return (out_wavs, out_segments) + tuple(preds[1:]), None, start_idxs
        y_pred, y_extra = self.text2mel(text, text_lengths, feats, feats_lengths, duration,
                                        pitch, energy, sids, aids, step=step,
                                        generator=generator, cvae_eps=cvae_eps)
        out_feats = y_pred[0] if y_pred[1] is None else y_pred[1]
        segs, start_idxs = get_random_segments(out_feats.transpose(1, 2), feats_lengths,
                                               self.segment_size, generator, start_idxs)
        out_segments = segs.transpose(1, 2)
        out_wavs = self.mel2wav(out_segments)
        return (out_wavs, out_segments, None) + tuple(y_pred[2:]), y_extra, start_idxs

    @torch.no_grad()
    def inference(self, sids: torch.Tensor, text: torch.Tensor, text_lengths: torch.Tensor,
                  max_mel_frames: int, feats: Optional[torch.Tensor] = None,
                  aids: Optional[torch.Tensor] = None, d_control: float = 1.0,
                  p_control: float = 1.0,
                  e_control: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Text -> waveform: (wav (B, max_mel_frames * up), wav_lengths)."""
        mel, mel_lens, _ = self.text2mel.inference(
            sids, text, text_lengths, max_mel_frames, feats=feats, aids=aids,
            d_control=d_control, p_control=p_control, e_control=e_control)
        wav = self.mel2wav(mel)[..., 0]
        return wav, mel_lens * self.upsample_factor
