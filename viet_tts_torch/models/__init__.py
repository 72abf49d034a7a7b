"""Model families of the port."""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

# the two-stage acoustic families (TwoStageTTS's model_type, Text2Wav's version)
ACOUSTIC_FAMILIES = ("fastspeech2", "adaspeech", "matcha")


def build_acoustic(n_symbols: int, n_mels: int, conf: Dict[str, Any], family: str,
                   stats: Dict[str, Any], n_speakers: int, n_accents: int = 2) -> nn.Module:
    """The acoustic model of ``family`` ("fastspeech2", "adaspeech" or
    "matcha") from the config's ``models.<family>`` section (the JAX API's
    ``_build_acoustic``). Matcha's ``stats`` are the dataset's mel
    statistics, the others' the pitch / energy ones."""
    if family == "adaspeech":
        from viet_tts_torch.models.adaspeech import AdaSpeech as cls
    elif family == "matcha":
        from viet_tts_torch.models.matcha import MatchaTTS as cls
    else:
        from viet_tts_torch.models.fastspeech2.model import FastSpeech2 as cls
    return cls(n_symbols, n_mels, conf["models"][family], stats, n_speakers=n_speakers,
               n_accents=n_accents)


def build_acoustic_loss(conf: Dict[str, Any], family: str, is_finetune: bool = False):
    """The loss of ``family``: ``FastSpeech2Loss`` of the task's
    ``train.<family>.loss`` section plus the model's pitch / energy levels,
    ``AdaSpeechLoss`` of the same and the model's
    ``phoneme_level_encoder_step``, or ``MatchaTTSLoss`` of the section
    plus the mel width (as the JAX trainers build them)."""
    if family == "matcha":
        from viet_tts_torch.models.matcha import MatchaTTSLoss

        loss_conf = dict(conf["train"]["matcha"]["loss"])
        loss_conf["n_channels"] = conf["audio"]["mel"]["channels"]
        return MatchaTTSLoss(loss_conf, is_finetune=is_finetune)
    from viet_tts_torch.config import fastspeech2_loss_conf

    loss_conf = fastspeech2_loss_conf(conf["train"][family], conf["models"][family])
    if family == "adaspeech":
        from viet_tts_torch.models.adaspeech import AdaSpeechLoss

        loss_conf["phoneme_level_encoder_step"] = (
            conf["models"][family]["variance"]["reference_encoder"]["phoneme_level_encoder_step"])
        return AdaSpeechLoss(loss_conf, is_finetune=is_finetune)
    from viet_tts_torch.models.fastspeech2.loss import FastSpeech2Loss

    return FastSpeech2Loss(loss_conf, is_finetune=is_finetune)
