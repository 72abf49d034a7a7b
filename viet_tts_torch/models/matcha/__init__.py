"""Matcha-TTS: the RoPE text encoder and the flow-matching UNet decoder, in
PyTorch."""

from viet_tts_torch.models.matcha.decoder import UNetDecoder
from viet_tts_torch.models.matcha.layers import RoPEEncoder, TextEncoder
from viet_tts_torch.models.matcha.loss import MatchaTTSLoss
from viet_tts_torch.models.matcha.model import CFM, MatchaTTS, fix_len_compatibility

__all__ = ["CFM", "MatchaTTS", "fix_len_compatibility", "TextEncoder", "RoPEEncoder",
           "UNetDecoder", "MatchaTTSLoss"]
