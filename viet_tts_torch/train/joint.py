"""Joint acoustic + vocoder training (``--task text2wav``) and speaker
finetuning (``--task text2wav --is_finetune``).

Counterpart of ``viet_tts_tpu/train/joint.py`` for the ``fastspeech2``,
``adaspeech`` and ``matcha`` versions of ``Text2Wav``. The step runs the
two phases of the other GAN steps (``train/gan.py``): a discriminator
update on the detached vocoded window against the same window of the
recorded waveform, then a generator update against the UPDATED
discriminator, whose loss is adv + fm * 2 + mel * 45 (the log-mel loss at
``audio.mel.log_base``) plus every acoustic loss of the joint criterion (``FastSpeech2Loss``,
``AdaSpeechLoss`` with its ``phoneme_level_encoder_step``, or
``MatchaTTSLoss``; ``is_joint=True``: the mel losses unmasked over the
window, against the recorded mel's window; Matcha's u and mu_y cut to the
same window). Matcha's dataset normalises the mels by the dataset's scalar
mel statistics (``train/matcha.py``), read from ``-a`` / ``-c`` / the
output folder's ``stats.json`` or computed.

``JointTrainer`` warm-starts from a joint checkpoint (``-c``: weights and
BatchNorm statistics, no optimizer state, iteration 0), or its
``text2mel`` from a ``--task <version>`` output (``-a``) and its
``mel2wav`` from a ``--task hifigan`` output (``-v``), by name and shape;
a checkpoint of its own in the output folder wins over all three (resume
by scan). ``JointFinetuner`` copies a joint checkpoint into a model with
more speakers: the known speakers' (and accents') embedding rows exactly,
new rows drawn U[0, 1); for its first 50 epochs it trains on the new
speakers' utterances alone, skips validation and decays only the
generator's rate.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch
from torch import nn

from viet_tts_torch.models.fastspeech2.loss import FastSpeech2Loss
from viet_tts_torch.models.hifigan.loss import (
    MelSpectrogramLoss,
    feature_match_loss,
    generator_adversarial_loss,
)
from viet_tts_torch.ops.segments import get_segments
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.gan import (
    HIFIGAN_LAMBDA_FM,
    HIFIGAN_LAMBDA_MEL,
    GANTrainer,
    _discriminator_update,
    _frozen,
    build_discriminator,
    build_mel_loss,
    seed_device_rng,
)
from viet_tts_torch.train.state import (
    TrainState,
    exponential_lr,
    set_learning_rate,
)
from viet_tts_torch.train.trainer import log, step_generator

JOINT_GAMMA = 0.999875  # both optimizers' per-epoch decay (joint.py:__init_optimizer__)


def acoustic_losses(model: nn.Module, criterion, y_pred, y_extra, starts: torch.Tensor,
                    batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
    """The joint criterion's acoustic losses over the vocoded window
    (``is_joint``): the recorded mel's window as the target; for Matcha, u
    and mu_y cut to the same window first."""
    seg = int(model.segment_size)

    def window(x):  # (B, T, C) -> the window (B, seg, C)
        return get_segments(x.transpose(1, 2), starts, seg).transpose(1, 2)

    feat_seg = window(batch["feats"])
    if model.version == "matcha":
        preds = (y_pred[1], window(y_pred[2]), window(y_pred[3])) + tuple(y_pred[4:])
        return criterion(preds, (feat_seg, batch["text_lengths"]), is_joint=True, step=step)
    targets = (feat_seg, batch["word_ids"], batch["word_ids"].shape[1], *y_extra)
    return criterion(y_pred[1:], targets, is_joint=True, step=step)


def make_joint_train_step(model: nn.Module, disc: nn.Module, mel_loss: MelSpectrogramLoss,
                          criterion: FastSpeech2Loss, hop: int):
    """``train_step(gen_state, disc_state, batch, generator, start_idxs=None,
    cvae_eps=None) -> (gen_state, disc_state, metrics)``.

    ``gen_state.module`` is ``model`` (a ``Text2Wav``), ``disc_state.module``
    is ``disc``. ``batch``: the acoustic batch (text, text_lengths, feats,
    feats_lengths, duration (the prior), pitch, energy, sids, aids,
    word_ids) and speech (B, T_feats * hop), on the models' device.
    ``generator`` is a CPU ``torch.Generator``: it seeds the device
    generator for ``nn.Dropout`` and draws the model's dropout seeds, CVAE
    noise and window starts, unless ``start_idxs`` / ``cvae_eps`` give
    them. ``metrics``: gen, mel, adv, fm, var_<k> for each acoustic loss,
    disc, disc_real, disc_fake (0-d tensors on the device)."""
    seg = int(model.segment_size)

    def train_step(gen_state: TrainState, disc_state: TrainState,
                   batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   start_idxs: Optional[torch.Tensor] = None, cvae_eps=None):
        seed_device_rng(batch["speech"].device, generator)
        model.train()
        disc.train()
        step = gen_state.step
        # One generator forward serves both phases. The JAX step runs it
        # twice with one rng (joint.py:train_step); with the same
        # parameters, dropout masks, CVAE noise and windows the two are
        # equal, and the BatchNorm statistics are updated once either way.
        y_pred, y_extra, starts = model(
            batch["text"], batch["text_lengths"], batch["feats"], batch["feats_lengths"],
            batch["duration"], batch["pitch"], batch["energy"], batch["sids"],
            batch.get("aids"), step=step, generator=generator, start_idxs=start_idxs,
            cvae_eps=cvae_eps)
        wav = y_pred[0]  # (B, seg * up, 1)
        speech_seg = get_segments(batch["speech"][:, None, :], starts * hop,
                                  seg * hop).transpose(1, 2)

        d_all, d_real, d_fake = _discriminator_update(disc, disc_state, wav, speech_seg)
        with _frozen(disc):
            p_hat = disc(wav)
            with torch.no_grad():
                p = disc(speech_seg)
            l_adv = generator_adversarial_loss(p_hat)
            l_fm = feature_match_loss(p_hat, p) * HIFIGAN_LAMBDA_FM
            l_mel = mel_loss(wav, speech_seg) * HIFIGAN_LAMBDA_MEL
            var_losses = acoustic_losses(model, criterion, y_pred, y_extra, starts, batch, step)
            total = l_adv + l_fm + l_mel + sum(var_losses.values())
            gen_state.tx.zero_grad()
            total.backward()
        gen_state.apply_gradients()
        metrics = {"gen": total, "mel": l_mel, "adv": l_adv, "fm": l_fm,
                   **{f"var_{k}": v for k, v in var_losses.items()},
                   "disc": d_all, "disc_real": d_real, "disc_fake": d_fake}
        return gen_state, disc_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


class JointTrainer(GANTrainer):
    """Text2Wav training (``src/trainer/joint_trainer.py``): ``Text2Wav``
    (FastSpeech2, AdaSpeech or Matcha of ``models.<version>``, HiFi-GAN V1 of
    ``models.hifigan`` with the plain MRF), the MSMPD of
    ``models.hifigan.discriminator_params``, the generator's AdamW from
    ``train.<version>.optimizer`` and the discriminator's from
    ``train.hifigan.optimizer``, bucketed batches with the waveform
    (``make_joint_collate``)."""

    task = "text2wav"

    @property
    def version(self) -> str:
        return getattr(self.args, "version", None) or "fastspeech2"

    def warm_paths(self) -> List[str]:
        """The checkpoints this run starts from, in the order their
        ``stats.json`` is read (the last found wins): ``-a``, ``-c``."""
        return [p for p in (self.args.acoustic_checkpoint, self.args.checkpoint) if p]

    def resume_path(self) -> Optional[str]:
        # -c names a joint checkpoint to warm-start from (warm_start), not a
        # trainer state to resume: only the output folder's own resume
        return ckpt.scan_checkpoint(self.args.output_folder, self.ckpt_prefix)

    def _loader(self, rows):
        from viet_tts_torch.data.batching import BucketBatcher, make_joint_collate
        from viet_tts_torch.data.dataset import AcousticDataset

        if self.version == "matcha":
            from viet_tts_torch.train.matcha import UNIT_STATS, MelNormalizedDataset

            data = MelNormalizedDataset(
                AcousticDataset(rows, self.conf["audio"], self.speakers, self.accents,
                                stats=UNIT_STATS, include_speech=True),
                self.stats["mel_mean"], self.stats["mel_std"])
        else:
            data = AcousticDataset(rows, self.conf["audio"], self.speakers, self.accents,
                                   stats=self.stats, include_speech=True)
        return BucketBatcher(data, self.conf["train"]["batch_size"], seed=self.seed,
                             collate_fn=make_joint_collate(self.hop))

    def __init_dataset__(self):
        from viet_tts_torch.data.dataset import AcousticDataset, load_stats, save_stats
        from viet_tts_torch.infer.api import resolve_checkpoint

        t0 = time.perf_counter()
        self.hop = self.conf["audio"]["stft"]["hop_length"]
        stats = None
        # the statistics a pretrained acoustic model was trained with; the
        # output folder's own win over them
        for src in self.warm_paths():
            path = os.path.join(os.path.dirname(resolve_checkpoint(src)), "stats.json")
            if os.path.exists(path):
                stats = load_stats(path)
        stats_path = os.path.join(self.args.output_folder, "stats.json")
        if os.path.exists(stats_path):
            stats = load_stats(stats_path)
        if stats is None and self.version == "matcha":
            from viet_tts_torch.train.matcha import UNIT_STATS, compute_mel_stats

            stats = compute_mel_stats(AcousticDataset(
                self.train_set, self.conf["audio"], self.speakers, self.accents,
                stats=UNIT_STATS))
        elif stats is None:
            stats = AcousticDataset(self.train_set, self.conf["audio"], self.speakers,
                                    self.accents).stats
        self.stats = stats
        os.makedirs(self.args.output_folder, exist_ok=True)
        if not os.path.exists(stats_path):
            save_stats(self.stats, stats_path)
        self.train_loader = self._loader(self.train_set)
        self.valid_loader = self._loader(self.test_set)
        self.cache_seconds = time.perf_counter() - t0
        log.info(f"feature cache and stats of {len(self.train_set) + len(self.test_set)} "
                 f"utterances: {self.cache_seconds:.1f} s")

    def __init_model__(self):
        from viet_tts_torch.models.text2wav import Text2Wav
        from viet_tts_torch.nn.utils import seeded_init_

        model = Text2Wav(self.n_symbols, self.conf["audio"]["mel"]["channels"], self.conf,
                         self.stats, n_speakers=len(self.speakers) if self.speakers else 1,
                         n_accents=len(self.accents) if self.accents else 2,
                         version=self.version)
        disc = build_discriminator(
            self.conf["models"]["hifigan"].get("discriminator_params", {}))
        # seeded on the CPU, so one seed gives the same weights on any device
        gen = torch.Generator().manual_seed(self.seed)
        seeded_init_(model, gen)
        seeded_init_(disc, gen)
        self.model = model.to(self.device)
        self.discriminator = disc.to(self.device)

    def __init_loss__(self):
        from viet_tts_torch.models import build_acoustic_loss

        audio = self.conf["audio"]
        self.criterion = build_acoustic_loss(self.conf, self.version,
                                             is_finetune=bool(self.warm_paths()))
        # the configured log base (natural with null), not HiFi-GAN's log10
        self.mel_loss = build_mel_loss(audio, log_base=audio["mel"]["log_base"])

    def __init_optimizer__(self):
        gen_opt = self.conf["train"][self.version]["optimizer"]
        dis_opt = self.conf["train"]["hifigan"]["optimizer"]
        self.base_lr, self.dis_lr = gen_opt["lr"], dis_opt["lr"]
        self.gamma = self.dis_gamma = JOINT_GAMMA
        self.state = TrainState.create(self.model, self._adamw(self.model.parameters(),
                                                               gen_opt))
        self.disc_state = TrainState.create(
            self.discriminator, self._adamw(self.discriminator.parameters(), dis_opt))
        if self.try_resume() is None:
            self.warm_start()
        self.try_resume_discriminator()
        self.train_step = make_joint_train_step(self.model, self.discriminator,
                                                self.mel_loss, self.criterion, self.hop)

    def warm_start(self):
        """With no checkpoint of its own: ``-c``'s weights and BatchNorm
        statistics, else ``-a`` into ``text2mel`` and ``-v`` into
        ``mel2wav``."""
        from viet_tts_torch.infer.api import resolve_checkpoint

        if self.args.checkpoint:
            path = resolve_checkpoint(self.args.checkpoint)
            self.model.load_state_dict(ckpt.model_state_dict(path))
            log.info(f"initial training from joint checkpoint {path}")
            return
        if self.args.acoustic_checkpoint:
            self._warm_start_submodule("text2mel", self.args.acoustic_checkpoint)
        if self.args.vocoder_checkpoint:
            self._warm_start_submodule("mel2wav", self.args.vocoder_checkpoint)
        elif self.args.acoustic_checkpoint:
            log.info("training without pretrained vocoder can make the model "
                     "harder/slower to converge")

    def _warm_start_submodule(self, name: str, path: str):
        """Each weight and buffer of a trainer output (or weights file) that
        matches one of submodule ``name``'s by name and shape."""
        from viet_tts_torch.infer.api import resolve_checkpoint

        sub = getattr(self.model, name)
        merged, skipped = ckpt.apply_weights(
            sub.state_dict(), ckpt.model_state_dict(resolve_checkpoint(path)))
        sub.load_state_dict(merged)
        log.info(f"loaded checkpoint for {name} from {path} ({len(skipped)} skipped)")

    def train_batch(self, batch):
        self.state, self.disc_state, metrics = self.train_step(
            self.state, self.disc_state, batch, step_generator(self.seed, self.state.step))
        return metrics

    def valid_one_epoch(self):
        # the windows of every validation come from one seeded generator
        generator = torch.Generator().manual_seed(self.seed)
        seg = self.model.segment_size * self.hop

        def mel_l1(b):
            y_pred, _, starts = self.model(
                b["text"], b["text_lengths"], b["feats"], b["feats_lengths"],
                b["duration"], b["pitch"], b["energy"], b["sids"], b.get("aids"),
                step=self.state.step, generator=generator)
            speech = get_segments(b["speech"][:, None, :], starts * self.hop, seg)
            return self.mel_loss(y_pred[0], speech.transpose(1, 2))

        self._valid_mel(mel_l1)


class JointFinetuner(JointTrainer):
    """Speaker adaptation by embedding surgery
    (``src/trainer/joint_finetuner.py``): ``-c`` names the joint checkpoint
    to adapt, with its ``speakers.json`` (and ``accents.json``) beside it."""

    threshold_epoch = 50

    def __init_parameter__(self):
        from viet_tts_torch.infer.api import resolve_checkpoint

        if self.args.checkpoint is None:
            raise ValueError("Adapter VoiceAI Task must have a pre-trained model checkpoint")
        ckpt_dir = os.path.dirname(resolve_checkpoint(self.args.checkpoint))
        with open(os.path.join(ckpt_dir, "speakers.json"), encoding="utf8") as f:
            self.src_speakers = json.load(f)
        if self.src_speakers == self.speakers:
            raise NotImplementedError("=> Speakers is still same! Training is not effective..")
        self.adapter_speakers = [s for s in self.speakers if s not in self.src_speakers]
        src_acc_path = os.path.join(ckpt_dir, "accents.json")
        self.src_accents = self.accents
        if os.path.exists(src_acc_path):
            with open(src_acc_path, encoding="utf8") as f:
                self.src_accents = json.load(f)
        # the surgery (warm_start) replaces loading -c as a joint checkpoint
        self.base_checkpoint = self.args.checkpoint
        self.args.checkpoint = None

    def warm_paths(self) -> List[str]:
        return super().warm_paths() + [self.base_checkpoint]

    def __init_dataset__(self):
        super().__init_dataset__()
        self.all_train_loader = self.train_loader
        rows = [r for r in self.train_set if r[1] in self.adapter_speakers]
        self.adapter_train_loader = self._loader(rows) if rows else self.train_loader

    def warm_start(self):
        """Every weight and buffer of the base checkpoint that matches by
        name and shape; then the speaker table (and the accent table when
        the accents changed) rebuilt: the known names' rows copied, the new
        ones U[0, 1) draws from a generator seeded with ``train.seed``.
        Written as the epoch-0 checkpoint."""
        from viet_tts_torch.infer.api import resolve_checkpoint

        source = ckpt.model_state_dict(resolve_checkpoint(self.base_checkpoint))
        state, _ = ckpt.apply_weights(self.model.state_dict(), source)
        gen = torch.Generator().manual_seed(self.seed)
        self._surgery(state, source, "spk", self.src_speakers, self.speakers, gen)
        log.info(f"re-initialised speaker embeddings for: {', '.join(self.adapter_speakers)}")
        if self.src_accents != self.accents and self.accents:
            self._surgery(state, source, "acc", self.src_accents, self.accents, gen)
        self.model.load_state_dict(state)
        self.save_model()

    @staticmethod
    def _surgery(state, source, tag: str, src_table: Dict[str, int],
                 tgt_table: Dict[str, int], gen: torch.Generator) -> None:
        key = f"text2mel.speaker_emb.cvae.embedding_layer_{tag}.weight"
        if key not in state or key not in source:
            log.warning(f"could not perform embedding_layer_{tag} surgery (layout mismatch)")
            return
        old = source[key]
        new = torch.rand((len(tgt_table), old.shape[1]), generator=gen)
        for name, idx in src_table.items():
            if name in tgt_table:
                new[tgt_table[name]] = old[idx]
        state[key] = new

    def seek(self, iteration: int) -> None:
        """Epochs below ``threshold_epoch`` take the adapter batches, the
        later ones every training utterance."""
        if self.adapter_train_loader is self.all_train_loader:
            return super().seek(iteration)
        per_adapter = max(self.adapter_train_loader.epoch_batches(), 1)
        adapter_iters = self.threshold_epoch * per_adapter
        if iteration < adapter_iters:
            self.epoch = iteration // per_adapter
            self.adapter_train_loader.skip(iteration)
        else:
            rest = iteration - adapter_iters
            self.epoch = self.threshold_epoch + rest // max(
                self.all_train_loader.epoch_batches(), 1)
            self.all_train_loader.skip(rest)

    def set_epoch_rates(self, epoch: int) -> None:
        # as the JAX finetuner: below the threshold only the generator's
        # rate decays, so the discriminator's holds its base rate until
        # epoch threshold + 1, then follows the whole epoch count
        self.state = set_learning_rate(
            self.state, exponential_lr(self.base_lr, self.gamma, epoch))
        disc_epoch = epoch if epoch > self.threshold_epoch else 0
        self.disc_state = set_learning_rate(
            self.disc_state, exponential_lr(self.dis_lr, self.dis_gamma, disc_epoch))

    def train_one_epoch(self):
        self.train_loader = (self.all_train_loader if self.epoch >= self.threshold_epoch
                             else self.adapter_train_loader)
        super().train_one_epoch()

    def valid_one_epoch(self):
        if self.epoch >= self.threshold_epoch:
            super().valid_one_epoch()
