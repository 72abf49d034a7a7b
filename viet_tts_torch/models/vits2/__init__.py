"""VITS2 (counterpart of ``viet_tts_tpu/models/vits2``)."""

from viet_tts_torch.models.vits2.discriminator import (
    DurationDiscriminator,
    MultiPeriodDiscriminator,
)
from viet_tts_torch.models.vits2.loss import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
)
from viet_tts_torch.models.vits2.model import VITS2, generate_path
from viet_tts_torch.models.vits2.transforms import (
    rational_quadratic_spline,
    unconstrained_rational_quadratic_spline,
)

__all__ = [
    "VITS2",
    "generate_path",
    "MultiPeriodDiscriminator",
    "DurationDiscriminator",
    "feature_loss",
    "discriminator_loss",
    "generator_loss",
    "kl_loss",
    "rational_quadratic_spline",
    "unconstrained_rational_quadratic_spline",
]
