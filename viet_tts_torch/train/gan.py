"""The JETS adversarial training step.

Counterpart of ``viet_tts_tpu/train/gan.py:make_jets_train_step``: a
generator forward, a discriminator update on the detached fake segments
against the aligned real ones, then a generator update (mel * 45 + adv +
fm * 2 + var + align * 2, the configured lambdas) against the UPDATED
discriminator. The JAX function is jitted as one graph over the pair of
states; here it runs eagerly and the states update in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from viet_tts_torch.models.hifigan.loss import (
    MelSpectrogramLoss,
    discriminator_adversarial_loss,
    feature_match_loss,
    generator_adversarial_loss,
)
from viet_tts_torch.models.jets.loss import forward_sum_with_prior, variance_loss
from viet_tts_torch.ops.segments import get_segments
from viet_tts_torch.train.state import TrainState

METRICS = ("gen", "mel", "adv", "fm", "var", "align", "disc", "disc_real", "disc_fake")


def seed_device_rng(device: torch.device, generator: torch.Generator) -> None:
    """Seed the device's default generator (which ``nn.Dropout`` draws
    from) with a number drawn from ``generator``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    if device.type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def make_jets_train_step(model: nn.Module, disc: nn.Module,
                         mel_loss: MelSpectrogramLoss,
                         lambdas: Dict[str, float], hop: int):
    """``train_step(gen_state, disc_state, batch, generator, start_idxs=None)
    -> (gen_state, disc_state, metrics)``.

    ``gen_state.module`` is ``model`` (a ``JETS``), ``disc_state.module``
    is ``disc``. ``batch``: text, text_lengths, feats, feats_lengths,
    pitch (B, T_feats), energy (B, T_feats), sids, speech (B, T_feats*hop),
    on the models' device. ``generator`` is a CPU ``torch.Generator``:
    it draws the flash-attention dropout seeds and the segment starts and
    seeds the device generator for ``nn.Dropout``. ``start_idxs`` (B,)
    given instead of drawn takes the segments there. ``metrics`` holds the
    JAX step's nine scalars (0-d tensors on the device)."""
    seg = int(model.segment_size)

    def train_step(gen_state: TrainState, disc_state: TrainState,
                   batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   start_idxs: Optional[torch.Tensor] = None):
        device = batch["speech"].device
        seed_device_rng(device, generator)
        model.train()
        disc.train()
        # One generator forward serves both phases. The JAX step runs it
        # twice with one rng (gan.py:117 and :138); with the same
        # parameters, dropout masks and segments the two are equal, and
        # the BatchNorm statistics are updated once either way.
        (wav, bin_loss, log_p_attn, starts, d_outs, ds, p_outs, ps, e_outs,
         es) = model(batch["text"], batch["text_lengths"], batch["feats"],
                     batch["feats_lengths"], batch["pitch"][..., None],
                     batch["energy"][..., None], batch.get("sids"),
                     generator=generator, start_idxs=start_idxs)
        wav = wav.transpose(1, 2)  # (B, S*hop, 1)
        speech_seg = get_segments(batch["speech"][:, None, :], starts * hop,
                                  seg * hop).transpose(1, 2)

        # ---- discriminator update (fake detached) ----
        disc_state.tx.zero_grad()
        d_real, d_fake = discriminator_adversarial_loss(disc(wav.detach()),
                                                        disc(speech_seg))
        d_all = d_real + d_fake
        d_all.backward()
        disc_state.apply_gradients()

        # ---- generator update against the updated discriminator ----
        # the discriminator's parameters take no gradient in this phase, so
        # nothing of the generator loss reaches the discriminator's optimizer
        disc.requires_grad_(False)
        try:
            p_hat = disc(wav)
            with torch.no_grad():
                p = disc(speech_seg)
            l_mel = mel_loss(wav, speech_seg) * lambdas["mel"]
            l_adv = generator_adversarial_loss(p_hat) * lambdas["adv"]
            l_fm = feature_match_loss(p_hat, p) * lambdas["fm"]
            dur, pit, ene = variance_loss(d_outs, ds, p_outs, ps, e_outs, es,
                                          batch["text_lengths"])
            l_var = (dur + pit + ene) * lambdas["var"]
            fsum = forward_sum_with_prior(log_p_attn, batch["text_lengths"],
                                          batch["feats_lengths"])
            l_align = (fsum + bin_loss) * lambdas["align"]
            total = l_mel + l_adv + l_fm + l_var + l_align
            gen_state.tx.zero_grad()
            total.backward()
        finally:
            disc.requires_grad_(True)
        gen_state.apply_gradients()

        values = (total, l_mel, l_adv, l_fm, l_var, l_align, d_all, d_real, d_fake)
        metrics = {k: v.detach() for k, v in zip(METRICS, values)}
        return gen_state, disc_state, metrics

    return train_step
