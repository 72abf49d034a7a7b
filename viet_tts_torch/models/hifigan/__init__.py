"""HiFi-GAN generator, discriminators and GAN losses in PyTorch."""

from viet_tts_torch.models.hifigan.discriminator import MultiScaleMultiPeriodDiscriminator
from viet_tts_torch.models.hifigan.generator import HiFiGANGenerator
from viet_tts_torch.models.hifigan.loss import (
    MelSpectrogramLoss,
    discriminator_adversarial_loss,
    feature_match_loss,
    generator_adversarial_loss,
)

__all__ = [
    "HiFiGANGenerator",
    "MelSpectrogramLoss",
    "MultiScaleMultiPeriodDiscriminator",
    "discriminator_adversarial_loss",
    "feature_match_loss",
    "generator_adversarial_loss",
]
