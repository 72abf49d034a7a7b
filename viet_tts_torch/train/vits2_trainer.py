"""The VITS2 trainer (``--task vits2``) and its step: three optimizers.

Counterpart of ``viet_tts_tpu/train/vits2_trainer.py``. The dataset is the
acoustic one with the waveform and no durations, the text interspersed
with the blank id 0 (``InterspersedDataset``; the buckets are the
interspersed lengths). One step updates the duration discriminator, then
the multi-period discriminator, then the generator against both updated
discriminators: the loss is adv + fm + mel * c_mel + dur + kl * c_kl +
dur_adv, the mel L1 between log-mels (``dsp/stft.py``, the audio config's
log base) of the sliced real and generated waveforms. The MAS noise scale
anneals with the generator's step.

The JAX step runs the generator's forward twice under one key (once for
the two discriminator updates, once inside the generator's gradient): both
passes see the same draws and dropout masks, so their values are equal.
Here one forward keeps its graph; the discriminators are updated on its
detached outputs, then the generator's loss backpropagates through it
(``tests/test_torch_vits2_trainer.py`` holds the step against the JAX one).

``VITS2Trainer`` keeps three states with one rate each, decayed by
``train.vits2.scheduler.gamma`` an epoch. The discriminators ride in one
``last_discriminator_statedict.pt`` beside the generator's checkpoints
(the MPD's payload, the duration discriminator's under ``dur_``, and the
iteration it was written at), as the JAX trainer nests ``dur_params`` /
``dur_opt_state``. The JAX trainer draws a validation batch at init to
shape its parameters; this one needs none, so its validation order
differs.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from viet_tts_torch.data.batching import BucketBatcher, make_jets_collate
from viet_tts_torch.data.dataset import AcousticDataset, load_stats, save_stats
from viet_tts_torch.dsp.stft import log_mel_from_config
from viet_tts_torch.models.vits2 import (
    VITS2,
    DurationDiscriminator,
    MultiPeriodDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
)
from viet_tts_torch.ops.segments import get_segments
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.gan import DISCRIMINATOR_FILE, GANTrainer, _frozen, seed_device_rng
from viet_tts_torch.train.state import TrainState, exponential_lr, set_learning_rate
from viet_tts_torch.train.trainer import log, step_generator

METRICS = ("gen", "mel", "kl", "fm", "adv", "dur", "dur_adv", "disc", "dur_disc")


def intersperse_ids(ids: np.ndarray, item: int = 0) -> np.ndarray:
    """[a, b] -> [item, a, item, b, item]."""
    out = np.full(len(ids) * 2 + 1, item, ids.dtype)
    out[1::2] = ids
    return out


class InterspersedDataset:
    """An ``AcousticDataset`` whose items' text has the blank id 0 between
    and around the phonemes (word ids all -1)."""

    def __init__(self, base: AcousticDataset):
        self.base = base
        self.inputs = base.inputs

    def __len__(self):
        return len(self.base)

    def lengths(self, index: int) -> tuple:
        n_text, n_mel = self.base.lengths(index)
        return 2 * n_text + 1, n_mel

    def __getitem__(self, index: int) -> dict:
        item = self.base[index]
        item["text"] = intersperse_ids(item["text"])
        item["word_ids"] = np.full(len(item["text"]), -1, np.int32)
        return item


def make_vits2_train_step(model: VITS2, disc: nn.Module, dur_disc: nn.Module,
                          audio: Dict, lambdas: Dict[str, float], hop: int):
    """``train_step(gen_state, disc_state, dur_state, batch, generator,
    draws=None) -> (gen_state, disc_state, dur_state, metrics)``.

    The states' modules are ``model``, ``disc`` (the MPD) and ``dur_disc``.
    ``batch``: text, text_lengths, feats (B, T, n_mels), feats_lengths,
    sids, speech (B, T * hop), on the models' device. ``generator`` (a CPU
    ``torch.Generator``) seeds the device generator for dropout and draws
    the forward's noise and segments, unless ``draws`` gives them
    (``VITS2.forward``). ``audio`` is the config's audio section (the mel
    loss's features); ``lambdas`` holds c_mel and c_kl. ``metrics``: the
    JAX step's nine scalars."""
    seg_wav = int(model.segment_size)

    def train_step(gen_state: TrainState, disc_state: TrainState, dur_state: TrainState,
                   batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        seed_device_rng(batch["speech"].device, generator)
        for m in (model, disc, dur_disc):
            m.train()
        (y_hat, l_length, _, ids_slice, x_mask, y_mask, (_, z_p, m_p, logs_p, _, logs_q),
         (hidden_x, logw, logw_)) = model(
            batch["text"], batch["text_lengths"], batch["feats"], batch["feats_lengths"],
            batch["sids"], step=gen_state.step, generator=generator, draws=draws)
        y = get_segments(batch["speech"][:, None, :], ids_slice * hop, seg_wav)[:, 0, :]
        y3 = y[..., None]

        # the duration discriminator, on detached inputs
        dur_state.tx.zero_grad()
        probs = dur_disc(hidden_x.detach(), x_mask, logw_.detach(), logw.detach())
        dd_loss, _, _ = discriminator_loss([probs[0]], [probs[1]])
        dd_loss.backward()
        dur_state.apply_gradients()

        # the waveform discriminator, on the detached fake
        disc_state.tx.zero_grad()
        y_d_r, y_d_g, _, _ = disc(y3, y_hat.detach())
        d_loss, _, _ = discriminator_loss(y_d_r, y_d_g)
        d_loss.backward()
        disc_state.apply_gradients()

        # the generator, against both updated discriminators
        with _frozen(disc, dur_disc):
            with torch.no_grad():
                y_mel = log_mel_from_config(y, audio)
            y_hat_mel = log_mel_from_config(y_hat[..., 0], audio)
            _, y_d_g, fmap_r, fmap_g = disc(y3, y_hat)
            dur_probs = dur_disc(hidden_x.detach(), x_mask, logw_, logw)
            loss_dur = torch.sum(l_length)
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * lambdas["c_mel"]
            loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * lambdas["c_kl"]
            loss_fm = feature_loss(fmap_r, fmap_g)
            loss_gen, _ = generator_loss(y_d_g)
            loss_dur_gen, _ = generator_loss([dur_probs[1]])
            total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl + loss_dur_gen
            gen_state.tx.zero_grad()
            total.backward()
        gen_state.apply_gradients()
        values = (total, loss_mel, loss_kl, loss_fm, loss_gen, loss_dur, loss_dur_gen, d_loss,
                  dd_loss)
        metrics = {k: v.detach() for k, v in zip(METRICS, values)}
        return gen_state, disc_state, dur_state, metrics

    return train_step


def build_discriminators(hp: Dict):
    """(the MPD of ``mpd_periods``, the duration discriminator of
    ``duration_discriminator_type``) of a ``models.vits2`` section."""
    return (MultiPeriodDiscriminator(tuple(hp.get("mpd_periods", (2, 3, 5, 7, 11)))),
            DurationDiscriminator(hp["hidden_channels"], hp["hidden_channels"],
                                  variant=hp.get("duration_discriminator_type", "dur_disc_1")))


class VITS2Trainer(GANTrainer):
    """End-to-end VITS2 training (``src/trainer/vits2_trainer.py``):
    ``VITS2`` of ``models.vits2`` with the mel posterior encoder, the MPD and
    the duration discriminator, AdamW of ``train.vits2.optimizer`` for all
    three."""

    task = "vits2"

    def __init_dataset__(self):
        t0 = time.perf_counter()
        audio = self.conf["audio"]
        stats_path = os.path.join(self.args.output_folder, "stats.json")
        stats = load_stats(stats_path) if os.path.exists(stats_path) else None
        kw = dict(include_speech=True, load_duration=False)
        base_train = AcousticDataset(self.train_set, audio, self.speakers, self.accents,
                                     stats=stats, **kw)
        self.stats = base_train.stats
        os.makedirs(self.args.output_folder, exist_ok=True)
        if not os.path.exists(stats_path):
            save_stats(self.stats, stats_path)
        base_valid = AcousticDataset(self.test_set, audio, self.speakers, self.accents,
                                     stats=self.stats, **kw)
        self.train_data = InterspersedDataset(base_train)
        self.valid_data = InterspersedDataset(base_valid)
        self.cache_seconds = time.perf_counter() - t0
        log.info(f"feature cache and stats of {len(self.train_set) + len(self.test_set)} "
                 f"utterances: {self.cache_seconds:.1f} s")
        bs = self.conf["train"]["batch_size"]
        # the acoustic collate with the waveform and without durations
        collate = make_jets_collate(audio["stft"]["hop_length"])
        self.train_loader = BucketBatcher(self.train_data, bs, seed=self.seed,
                                          collate_fn=collate)
        self.valid_loader = BucketBatcher(self.valid_data, bs, seed=self.seed,
                                          collate_fn=collate)

    def __init_model__(self):
        from viet_tts_torch.nn.utils import seeded_init_

        hp = self.conf["models"]["vits2"]
        model = VITS2(self.n_symbols, hp, n_speakers=len(self.speakers) if self.speakers else 1,
                      spec_channels=self.conf["audio"]["mel"]["channels"])
        disc, dur_disc = build_discriminators(hp)
        # seeded on the CPU, so one seed gives the same weights on any device
        gen = torch.Generator().manual_seed(self.seed)
        for m in (model, disc, dur_disc):
            seeded_init_(m, gen)
        self.model = model.to(self.device)
        self.discriminator = disc.to(self.device)
        self.duration_discriminator = dur_disc.to(self.device)

    def __init_loss__(self):
        lc = self.conf["train"]["vits2"]["loss"]
        self.lambdas = {"c_mel": lc.get("c_mel", 45), "c_kl": lc.get("c_kl", 1.0)}

    def __init_optimizer__(self):
        task = self.conf["train"]["vits2"]
        opt = task["optimizer"]
        self.base_lr = self.dis_lr = opt["lr"]
        self.gamma = self.dis_gamma = task.get("scheduler", {}).get("gamma", 0.999875)
        self.dur_state = TrainState.create(
            self.duration_discriminator,
            self._adamw(self.duration_discriminator.parameters(), opt))
        self._create_states(opt, opt)
        self.hop = self.conf["audio"]["stft"]["hop_length"]
        self.train_step = make_vits2_train_step(self.model, self.discriminator,
                                                self.duration_discriminator,
                                                self.conf["audio"], self.lambdas, self.hop)

    def set_epoch_rates(self, epoch: int) -> None:
        super().set_epoch_rates(epoch)
        self.dur_state = set_learning_rate(
            self.dur_state, exponential_lr(self.dis_lr, self.dis_gamma, epoch))

    def step_rates(self) -> Dict[str, float]:
        return {**super().step_rates(), "dur_disc_learning_rate": self.dur_state.lr}

    def save_model(self):
        super(GANTrainer, self).save_model()
        payload = dict(ckpt.make_payload(self.disc_state), iteration=self.iter)
        payload.update({f"dur_{k}": v for k, v in ckpt.make_payload(self.dur_state).items()})
        torch.save(payload, os.path.join(self.args.output_folder, DISCRIMINATOR_FILE))

    def try_resume_discriminator(self):
        """The MPD's and the duration discriminator's weights, Adam moments
        and steps from the discriminator file (see ``GANTrainer``)."""
        payload = super().try_resume_discriminator()
        if payload is not None:
            ckpt.restore_payload(self.dur_state, {k[4:]: v for k, v in payload.items()
                                                  if k.startswith("dur_")})
        return payload

    def train_batch(self, batch):
        self.state, self.disc_state, self.dur_state, metrics = self.train_step(
            self.state, self.disc_state, self.dur_state, batch,
            step_generator(self.seed, self.state.step))
        return metrics

    def valid_one_epoch(self):
        # the draws of every validation come from one seeded generator
        generator = torch.Generator().manual_seed(self.seed)
        seg = self.model.segment_size
        audio = self.conf["audio"]

        def mel_l1(b):
            out = self.model(b["text"], b["text_lengths"], b["feats"], b["feats_lengths"],
                             b["sids"], step=0, generator=generator)
            y = get_segments(b["speech"][:, None, :], out[3] * self.hop, seg)[:, 0]
            return torch.mean(torch.abs(log_mel_from_config(y, audio)
                                        - log_mel_from_config(out[0][..., 0], audio)))

        self._valid_mel(mel_l1)
