"""Adversarial training: the HiFi-GAN and JETS steps and trainers.

Counterpart of ``viet_tts_tpu/train/gan.py``. Each step runs the
reference's two phases (``hifigan_trainer.py:140-170``,
``jets_trainer.py:135-200``): a discriminator update on the detached fake
waveform against the real one, then a generator update (mel * 45 + fm * 2
+ adv for HiFi-GAN; mel * 45 + adv + fm * 2 + var + align * 2 for JETS, the
configured lambdas) against the UPDATED discriminator. The JAX functions
are jitted as one graph over the pair of states; here they run eagerly and
the states update in place.

The trainers (``HiFiGANTrainer``, ``JETSTrainer``) run on the loop, resume
and checkpoints of ``train/trainer.py:BaseTrainer``. The discriminator
rides beside the generator's checkpoints in one file,
``last_discriminator_statedict.pt`` (the reference's
``last_dicriminator_statedict.pt``, ``base.py:119-126``), rewritten at
every save with the iteration it was written at; a resume restores its
weights, Adam moments and step, and its epoch's rate.
"""

from __future__ import annotations

import contextlib
import os
import time
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
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.state import (
    TrainState,
    adamw_with_clip,
    exponential_lr,
    set_learning_rate,
)
from viet_tts_torch.train.trainer import BaseTrainer, log, step_generator

METRICS = ("gen", "mel", "adv", "fm", "var", "align", "disc", "disc_real", "disc_fake")
HIFIGAN_METRICS = ("gen", "mel", "fm", "adv", "disc", "disc_real", "disc_fake")
DISCRIMINATOR_FILE = "last_discriminator_statedict.pt"
# The HiFi-GAN generator loss: mel * 45 + fm * 2 + adv (the JAX step's
# defaults, which no trainer overrides).
HIFIGAN_LAMBDA_MEL = 45.0
HIFIGAN_LAMBDA_FM = 2.0


def seed_device_rng(device: torch.device, generator: torch.Generator) -> None:
    """Seed the device's default generator (which ``nn.Dropout`` draws
    from) with a number drawn from ``generator``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    if device.type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def _discriminator_update(disc: nn.Module, disc_state: TrainState,
                          fake: torch.Tensor, real: torch.Tensor):
    """One discriminator step on the detached fake against the real
    waveform; returns (real + fake, real, fake) losses."""
    disc_state.tx.zero_grad()
    d_real, d_fake = discriminator_adversarial_loss(disc(fake.detach()), disc(real))
    d_all = d_real + d_fake
    d_all.backward()
    disc_state.apply_gradients()
    return d_all, d_real, d_fake


@contextlib.contextmanager
def _frozen(*discs: nn.Module):
    """The discriminators' parameters take no gradient inside, so nothing
    of the generator loss reaches the discriminators' optimizers."""
    for disc in discs:
        disc.requires_grad_(False)
    try:
        yield
    finally:
        for disc in discs:
            disc.requires_grad_(True)


def make_hifigan_train_step(gen: nn.Module, disc: nn.Module,
                            mel_loss: MelSpectrogramLoss):
    """``train_step(gen_state, disc_state, batch) -> (gen_state,
    disc_state, metrics)``.

    ``gen_state.module`` is ``gen`` (a ``HiFiGANGenerator``),
    ``disc_state.module`` is ``disc``. ``batch``: mel (B, S, n_mels),
    speech (B, S * hop, 1), optionally g, on the models' device.
    ``metrics`` holds the JAX step's seven scalars (0-d tensors on the
    device)."""

    def train_step(gen_state: TrainState, disc_state: TrainState,
                   batch: Dict[str, torch.Tensor]):
        gen.train()
        disc.train()
        speech = batch["speech"]
        # One generator forward serves both phases (the JAX step runs it
        # again in the generator's loss with the same parameters).
        y_hat = gen(batch["mel"], batch.get("g"))
        d_all, d_real, d_fake = _discriminator_update(disc, disc_state, y_hat, speech)
        with _frozen(disc):
            p_hat = disc(y_hat)
            with torch.no_grad():
                p = disc(speech)
            l_mel = mel_loss(y_hat, speech) * HIFIGAN_LAMBDA_MEL
            l_fm = feature_match_loss(p_hat, p) * HIFIGAN_LAMBDA_FM
            l_adv = generator_adversarial_loss(p_hat)
            total = l_adv + l_fm + l_mel
            gen_state.tx.zero_grad()
            total.backward()
        gen_state.apply_gradients()
        values = (total, l_mel, l_fm, l_adv, d_all, d_real, d_fake)
        metrics = {k: v.detach() for k, v in zip(HIFIGAN_METRICS, values)}
        return gen_state, disc_state, metrics

    return train_step


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

        d_all, d_real, d_fake = _discriminator_update(disc, disc_state, wav, speech_seg)
        with _frozen(disc):
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
        gen_state.apply_gradients()

        values = (total, l_mel, l_adv, l_fm, l_var, l_align, d_all, d_real, d_fake)
        metrics = {k: v.detach() for k, v in zip(METRICS, values)}
        return gen_state, disc_state, metrics

    return train_step


# --------------------------------------------------------------------------
# trainers
# --------------------------------------------------------------------------

def build_discriminator(dp: Dict) -> nn.Module:
    """The MSMPD from a ``discriminator_params`` section (the JAX trainers'
    defaults for what it leaves out)."""
    from viet_tts_torch.models.hifigan import MultiScaleMultiPeriodDiscriminator

    return MultiScaleMultiPeriodDiscriminator(
        scales=dp.get("scales", 1), scale_params=dp.get("scale_discriminator_params"),
        periods=tuple(dp.get("periods", (2, 3, 5, 7, 11))),
        period_params=dp.get("period_discriminator_params"))


def build_mel_loss(audio: Dict, log_base: Optional[float] = 10.0) -> MelSpectrogramLoss:
    return MelSpectrogramLoss(
        fs=audio["signal"]["sampling_rate"], n_fft=audio["stft"]["filter_length"],
        hop_length=audio["stft"]["hop_length"], win_length=audio["stft"]["win_length"],
        window=audio["stft"]["window"], n_mels=audio["mel"]["channels"],
        fmin=audio["mel"]["fmin"], fmax=audio["mel"]["fmax"], log_base=log_base)


class GANTrainer(BaseTrainer):
    """A generator state (``self.state``) and a discriminator state
    (``self.disc_state``), each with its own per-epoch rate; the
    discriminator's file beside the generator's checkpoints."""

    def _adamw(self, params, opt: Dict):
        return adamw_with_clip(params, opt["lr"], betas=tuple(opt.get("betas", (0.8, 0.99))),
                               eps=opt.get("eps", 1e-9),
                               weight_decay=opt.get("weight_decay", 0.0),
                               grad_clip=self.conf["train"]["grad_clip_thresh"])

    def _create_states(self, gen_opt: Dict, dis_opt: Dict):
        self.state = TrainState.create(self.model, self._adamw(self.model.parameters(),
                                                               gen_opt))
        self.disc_state = TrainState.create(
            self.discriminator, self._adamw(self.discriminator.parameters(), dis_opt))
        self.try_resume()
        self.try_resume_discriminator()

    def set_epoch_rates(self, epoch: int) -> None:
        super().set_epoch_rates(epoch)
        self.disc_state = set_learning_rate(
            self.disc_state, exponential_lr(self.dis_lr, self.dis_gamma, epoch))

    def step_rates(self) -> Dict[str, float]:
        return {**super().step_rates(), "disc_learning_rate": self.disc_state.lr}

    def save_model(self):
        super().save_model()
        payload = dict(ckpt.make_payload(self.disc_state), iteration=self.iter)
        torch.save(payload, os.path.join(self.args.output_folder, DISCRIMINATOR_FILE))

    def try_resume_discriminator(self):
        """Load the discriminator's file when the generator resumed: its
        weights, Adam moments and step (the rate follows from the epoch,
        ``set_epoch_rates``). A missing file, or one written at another
        iteration than the generator's checkpoint, logs a warning: the
        resumed run then does not repeat an uninterrupted one. Returns the
        file's payload, or None."""
        if not self.iter:
            return None
        path = os.path.join(self.args.output_folder, DISCRIMINATOR_FILE)
        if not os.path.exists(path):
            log.warning("no discriminator checkpoint found; fresh discriminator "
                        "can make resumed GAN training harder")
            return None
        payload = ckpt.load_checkpoint(path)
        ckpt.restore_payload(self.disc_state, payload)
        if payload.get("iteration") != self.iter:
            log.warning(f"the discriminator checkpoint is from iteration "
                        f"{payload.get('iteration')}, the generator's from {self.iter}")
        log.info(f"resumed the discriminator from {path}")
        return payload

    def _valid_mel(self, mel_l1) -> None:
        """Mean of ``mel_l1(batch)`` over the validation batches, logged and
        reported as ``mel``."""
        self.model.eval()
        total, n = 0.0, 0
        with torch.no_grad():
            for batch in self.valid_loader:
                total += float(mel_l1(self._device_batch(batch)))
                n += 1
        val = {"mel": total / max(n, 1)}
        self.valid_logger.log(val, self.iter)
        self._report_validation(val)


class HiFiGANTrainer(GANTrainer):
    """Vocoder GAN training (``src/trainer/hifigan_trainer.py``): HiFi-GAN
    V1 from ``models.hifigan`` (the plain MRF, as in the JAX trainer), the
    MSMPD of that section's ``discriminator_params`` (defaults otherwise),
    the log10 mel loss, random aligned segments."""

    task = "hifigan"

    def __init_dataset__(self):
        from viet_tts_torch.data.vocoder import (
            VocoderBatcher,
            VocoderDataset,
            VocoderSegmentCollate,
        )

        audio = self.conf["audio"]
        seg = self.conf["models"]["hifigan"]["segment_size"]
        up = audio["stft"]["hop_length"]
        bs = self.conf["train"]["batch_size"]
        self.train_loader = VocoderBatcher(
            VocoderDataset(self.train_set, audio), bs,
            VocoderSegmentCollate(seg, up, seed=self.seed), seed=self.seed)
        self.valid_loader = VocoderBatcher(
            VocoderDataset(self.test_set, audio), bs,
            VocoderSegmentCollate(seg, up, seed=self.seed + 1), seed=self.seed + 1)
        self.stats = None

    def __init_model__(self):
        from viet_tts_torch.models.hifigan import HiFiGANGenerator
        from viet_tts_torch.nn.utils import seeded_init_

        hp = self.conf["models"]["hifigan"]
        model = HiFiGANGenerator(
            in_channels=self.conf["audio"]["mel"]["channels"],
            channels=hp["upsample_initial_channel"],
            global_channels=192 if hp.get("use_spk") else -1,
            upsample_scales=tuple(hp["upsample_rates"]),
            upsample_kernel_sizes=tuple(hp["upsample_kernel_sizes"]),
            resblock_kernel_sizes=tuple(hp["resblock_kernel_sizes"]),
            resblock_dilations=tuple(map(tuple, hp["resblock_dilation_sizes"])))
        disc = build_discriminator(hp.get("discriminator_params", {}))
        # seeded on the CPU, so one seed gives the same weights on any device
        gen = torch.Generator().manual_seed(self.seed)
        seeded_init_(model, gen)
        seeded_init_(disc, gen)
        self.model = model.to(self.device)
        self.discriminator = disc.to(self.device)

    def __init_loss__(self):
        self.mel_loss = build_mel_loss(self.conf["audio"])

    def __init_optimizer__(self):
        task = self.conf["train"]["hifigan"]
        opt = task["optimizer"]
        self.base_lr = self.dis_lr = opt["lr"]
        self.gamma = self.dis_gamma = task.get("scheduler", {}).get("gamma", 0.999875)
        self._create_states(opt, opt)
        self.train_step = make_hifigan_train_step(self.model, self.discriminator,
                                                  self.mel_loss)

    def train_batch(self, batch):
        self.state, self.disc_state, metrics = self.train_step(
            self.state, self.disc_state, batch)
        return metrics

    def valid_one_epoch(self):
        self._valid_mel(lambda b: self.mel_loss(self.model(b["mel"]), b["speech"]))


class JETSTrainer(GANTrainer):
    """End-to-end adversarial training (``src/trainer/jets_trainer.py``):
    ``JETS`` from ``models.jets.generator_params`` with its ``init_type``
    applied after init, the MSMPD of ``discriminator_params``, the
    natural-log mel loss and the configured lambdas, on bucketed batches
    with the waveform (``make_jets_collate``)."""

    task = "jets"

    def __init_dataset__(self):
        from viet_tts_torch.data.batching import BucketBatcher, make_jets_collate
        from viet_tts_torch.data.dataset import AcousticDataset, load_stats, save_stats

        t0 = time.perf_counter()
        audio = self.conf["audio"]
        stats_path = os.path.join(self.args.output_folder, "stats.json")
        stats = load_stats(stats_path) if os.path.exists(stats_path) else None
        kw = dict(include_speech=True, load_duration=False)
        self.train_data = AcousticDataset(self.train_set, audio, self.speakers, self.accents,
                                          stats=stats, **kw)
        self.stats = self.train_data.stats
        os.makedirs(self.args.output_folder, exist_ok=True)
        if not os.path.exists(stats_path):
            save_stats(self.stats, stats_path)
        self.valid_data = AcousticDataset(self.test_set, audio, self.speakers, self.accents,
                                          stats=self.stats, **kw)
        self.cache_seconds = time.perf_counter() - t0
        log.info(f"feature cache and stats of {len(self.train_set) + len(self.test_set)} "
                 f"utterances: {self.cache_seconds:.1f} s")
        bs = self.conf["train"]["batch_size"]
        collate = make_jets_collate(audio["stft"]["hop_length"])
        self.train_loader = BucketBatcher(self.train_data, bs, seed=self.seed,
                                          collate_fn=collate)
        self.valid_loader = BucketBatcher(self.valid_data, bs, seed=self.seed,
                                          collate_fn=collate)

    def __init_model__(self):
        from viet_tts_torch.models.jets import JETS
        from viet_tts_torch.nn.utils import seeded_init_
        from viet_tts_torch.train.state import apply_init_scheme

        hp = self.conf["models"]["jets"]
        gp = hp["generator_params"]
        model = JETS(self.n_symbols, self.conf["audio"]["mel"]["channels"], gp,
                     n_speakers=len(self.speakers) if self.speakers else 1)
        disc = build_discriminator(hp.get("discriminator_params", {}))
        # seeded on the CPU, so one seed gives the same weights on any device
        gen = torch.Generator().manual_seed(self.seed)
        seeded_init_(model, gen)
        apply_init_scheme(model, gp.get("init_type", "pytorch"), gen)
        seeded_init_(disc, gen)
        self.model = model.to(self.device)
        self.discriminator = disc.to(self.device)

    def __init_loss__(self):
        from viet_tts_torch.config import jets_lambdas

        # the JETS mel loss takes the natural log (jets/loss.py:39-48)
        self.mel_loss = build_mel_loss(self.conf["audio"], log_base=None)
        self.lambdas = jets_lambdas(self.conf["train"]["jets"])

    def __init_optimizer__(self):
        opt = self.conf["train"]["jets"]["optimizer"]
        gen_conf = opt.get("gen_optim_conf", {"lr": 2e-4})
        dis_conf = opt.get("dis_optim_conf", gen_conf)
        self.base_lr, self.dis_lr = gen_conf["lr"], dis_conf["lr"]
        self.gamma = opt.get("gen_scheduler_conf", {}).get("gamma", 0.999875)
        self.dis_gamma = opt.get("dis_scheduler_conf", {}).get("gamma", 0.999875)
        self._create_states(gen_conf, dis_conf)
        self.hop = self.conf["audio"]["stft"]["hop_length"]
        self.train_step = make_jets_train_step(self.model, self.discriminator,
                                               self.mel_loss, self.lambdas, self.hop)

    def train_batch(self, batch):
        self.state, self.disc_state, metrics = self.train_step(
            self.state, self.disc_state, batch, step_generator(self.seed, self.state.step))
        return metrics

    def valid_one_epoch(self):
        # the segments of every validation come from one seeded generator
        generator = torch.Generator().manual_seed(self.seed)
        seg = self.model.segment_size * self.hop

        def mel_l1(b):
            wav, _, _, starts, *_ = self.model(
                b["text"], b["text_lengths"], b["feats"], b["feats_lengths"],
                b["pitch"][..., None], b["energy"][..., None], b.get("sids"),
                generator=generator)
            speech = get_segments(b["speech"][:, None, :], starts * self.hop, seg)
            return self.mel_loss(wav[:, 0], speech[:, 0])

        self._valid_mel(mel_l1)
