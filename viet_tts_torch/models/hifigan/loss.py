"""GAN losses: adversarial (mse), feature matching, mel-spectrogram L1.

Counterpart of ``viet_tts_tpu/models/hifigan/loss.py``: functions over
lists of per-discriminator feature-map lists. JETS uses the natural-log mel
(``MelSpectrogramLoss(log_base=None)``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from viet_tts_torch.dsp.stft import log_mel_spectrogram


def _last(outputs):
    return outputs[-1] if isinstance(outputs, (list, tuple)) else outputs


def generator_adversarial_loss(outputs: Sequence,
                               average_by_discriminators: bool = False
                               ) -> torch.Tensor:
    """sum_d mean((D_d(fake) - 1)^2)."""
    total = 0.0
    for o in outputs:
        total = total + torch.mean((_last(o) - 1.0) ** 2)
    if average_by_discriminators:
        total = total / len(outputs)
    return total


def discriminator_adversarial_loss(outputs_hat: Sequence, outputs: Sequence,
                                   average_by_discriminators: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real, fake) = (sum_d mean((D_d(real) - 1)^2), sum_d mean(D_d(fake)^2))."""
    real = fake = 0.0
    for oh, o in zip(outputs_hat, outputs):
        real = real + torch.mean((_last(o) - 1.0) ** 2)
        fake = fake + torch.mean(_last(oh) ** 2)
    if average_by_discriminators:
        real, fake = real / len(outputs), fake / len(outputs)
    return real, fake


def feature_match_loss(feats_hat: Sequence, feats: Sequence,
                       average_by_layers: bool = False,
                       average_by_discriminators: bool = False,
                       include_final_outputs: bool = True) -> torch.Tensor:
    """L1 between fake and real feature maps; the caller passes the real
    maps detached."""
    total = 0.0
    for fh, f in zip(feats_hat, feats):
        if not include_final_outputs:
            fh, f = fh[:-1], f[:-1]
        d_loss = 0.0
        for a, b in zip(fh, f):
            d_loss = d_loss + torch.mean(torch.abs(a - b))
        if average_by_layers:
            d_loss = d_loss / len(fh)
        total = total + d_loss
    if average_by_discriminators:
        total = total / len(feats)
    return total


class MelSpectrogramLoss:
    """L1 between the log-mels of fake and real waveforms."""

    def __init__(self, fs: int = 22050, n_fft: int = 1024, hop_length: int = 256,
                 win_length: Optional[int] = None, window: str = "hann",
                 n_mels: int = 80, fmin: Optional[float] = 0.0,
                 fmax: Optional[float] = None, log_base: Optional[float] = 10.0):
        self.kw = dict(sr=fs, n_fft=n_fft, hop_length=hop_length,
                       win_length=win_length, window=window, n_mels=n_mels,
                       fmin=fmin or 0.0, fmax=fmax, log_base=log_base)

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """y_hat, y: (B, T) or (B, T, 1) waveforms."""
        if y_hat.dim() == 3:
            y_hat, y = y_hat[..., 0], y[..., 0]
        mel_hat = log_mel_spectrogram(y_hat, **self.kw)
        mel = log_mel_spectrogram(y, **self.kw)
        return torch.mean(torch.abs(mel_hat - mel))
