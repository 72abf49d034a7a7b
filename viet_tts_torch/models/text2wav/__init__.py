"""Text2Wav: FastSpeech2 or AdaSpeech and HiFi-GAN as one model, in PyTorch."""

from viet_tts_torch.models.text2wav.model import Text2Wav

__all__ = ["Text2Wav"]
