"""AdaSpeech training loss: the FastSpeech2 losses plus the phoneme-latent
distillation MSE.

Counterpart of ``viet_tts_tpu/models/adaspeech/loss.py``: ``avg_mel_phn``
is the masked MSE between the PhonemeLevelPredictor's latents and the
PhonemeLevelEncoder's (detached), weighted 0 before
``phoneme_level_encoder_step`` and 1 from it on (always in the dict while
a step is given).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from viet_tts_torch.models.fastspeech2.loss import FastSpeech2Loss, masked_mean


class AdaSpeechLoss(FastSpeech2Loss):
    def __init__(self, config, is_finetune: bool = False):
        super().__init__(config, is_finetune)
        self.phoneme_level_encoder_step = int(config.get("phoneme_level_encoder_step", 60000))

    def __call__(self, predictions: Tuple, targets: Tuple, is_joint: bool = False,
                 step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """``predictions``: the model's 12-tuple (the last the predicted
        latents); ``targets``: FastSpeech2's six and the encoder's latents."""
        phn_pred, phn_encode = predictions[-1], targets[-1]
        losses = super().__call__(predictions[:-1] + (None,), targets[:-1], is_joint, step)
        if step is not None and phn_pred is not None and phn_encode is not None:
            err = (phn_pred - phn_encode.detach()) ** 2
            weight = 1.0 if step >= self.phoneme_level_encoder_step else 0.0
            losses["avg_mel_phn"] = masked_mean(err, ~predictions[6][..., None]) * weight
        return losses
