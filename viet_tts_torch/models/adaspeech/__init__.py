"""AdaSpeech: FastSpeech2 with conditional layer norms and acoustic-condition
encoders, in PyTorch."""

from viet_tts_torch.models.adaspeech.loss import AdaSpeechLoss
from viet_tts_torch.models.adaspeech.model import AdaSpeech

__all__ = ["AdaSpeech", "AdaSpeechLoss"]
