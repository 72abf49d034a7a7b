"""Host-side training loops: the trainer template and the FastSpeech2 and
AdaSpeech trainers (the GAN trainers are in ``train/gan.py``).

Counterpart of ``viet_tts_tpu/train/trainer.py:79-487``: speakers and
accents loading, filelist creation, dataset -> model -> loss -> optimizer
hooks, the epoch loop until ``max_iter``, per-epoch LR decay and
validation with the coloured delta report, parameter histograms, keep-3
checkpoints with sidecars, resume by scan and one checkpoint on SIGTERM.
``BaseTrainer`` owns the loop: ``train_one_epoch`` feeds each batch to the
subclass's ``train_batch`` (one eager step on one device, the CUDA card
unless ``args.device`` says otherwise) and ``set_epoch_rates`` sets every
optimizer's rate for an epoch, so the three trainers share one loop and
one resume; the host feeds the batches from a prefetch thread. With
``--profile`` the run's first epoch runs under ``torch.profiler`` and
counts as an epoch like any other.

Where the JAX trainer folds the step count into one PRNG key
(``jax.random.fold_in(rng, state.step)``), each step here takes a CPU
``torch.Generator`` seeded from ``(train.seed, state.step)``
(``step_generator``). On resume the epoch and its learning rate follow
from the iteration (``iter // epoch_batches()``), whether the checkpoint
was written at an epoch's end or inside one (``--max_iter``, SIGTERM), and
the batch stream skips the batches already trained
(the batcher's ``skip``), so a resumed run repeats the steps of an
uninterrupted one; it does not repeat the validation an interrupted epoch
left out. ``train.zero1`` / ``train.fsdp`` change
nothing on one device, as in JAX on a one-device mesh; more than one card
is ROADMAP.md item 15.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from viet_tts_torch.config import derive_task_config
from viet_tts_torch.data.batching import BucketBatcher
from viet_tts_torch.data.dataset import AcousticDataset, load_stats, save_stats
from viet_tts_torch.data.filelist import create_filelist, create_unknown_filelist, read_filelist
from viet_tts_torch.device import resolve_device
from viet_tts_torch.text import NUM_SYMBOLS
from viet_tts_torch.train import checkpoint as ckpt
from viet_tts_torch.train.state import (
    TrainState,
    adamw_with_clip,
    exponential_lr,
    set_learning_rate,
)
from viet_tts_torch.utils.logging import StepTimer, TensorLogger, text_colors

log = logging.getLogger("viet_tts_torch")


class Preempted(BaseException):
    """Raised after a SIGTERM (a preemption notice) at the next step
    boundary. A BaseException, so an ``except Exception`` cannot swallow
    it."""


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of optimizer step ``step``: a function of
    ``(seed, step)`` alone."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 31) ^ int(words[1]))


class BaseTrainer:
    """Shared lifecycle; subclasses implement the __init_*__ hooks."""

    task: str = "base"
    ckpt_prefix: str = "generator"

    def __init__(self, args, conf: Dict[str, Any]):
        self.args = args
        self.conf = derive_task_config(conf, self.task, getattr(args, "version", None))
        self.device = resolve_device(getattr(args, "device", None))
        if self.device.type == "cuda":
            # fp32 as configured: cuDNN's convolutions and cuBLAS's products
            # would otherwise be free to run in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.n_symbols = NUM_SYMBOLS

        inp = args.input_folder
        self.speakers = self._load_json(os.path.join(inp, "speakers.json"))
        self.accents = self._load_json(os.path.join(inp, "accents.json"))

        if not os.path.isfile(os.path.join(inp, "train.txt")):
            if self.speakers is None:
                create_unknown_filelist(args.data_folder, inp)
            else:
                create_filelist(args.data_folder, self.speakers, inp)
        self.train_set = read_filelist(os.path.join(inp, "train.txt"))
        self.test_set = read_filelist(os.path.join(inp, "test.txt"))

        self.epoch, self.iter = 0, 0
        self.seed = int(self.conf["train"]["seed"])
        self.last_data_wait = 0.0  # seconds the last training batch kept the loop waiting
        for lever in ("zero1", "fsdp"):
            if self.conf["train"].get(lever, False):
                log.info(f"train.{lever}: one device, nothing to shard")

        self.__init_parameter__()
        self.__init_dataset__()
        self.__init_model__()
        self.__init_loss__()
        self.__init_optimizer__()

        n_params = sum(p.numel() for p in self.state.module.parameters())
        log.info("=" * 70)
        log.info(f" ---> Number of Model Parameters: {n_params}")
        log.info(f" ---> Device: {self.device}")
        log.info(f" ---> Total train samples: {len(self.train_set)}")
        log.info(f" ---> Total valid samples: {len(self.test_set)}")
        log.info(f" ---> Batch size in total: {self.conf['train']['batch_size']}")
        log.info("=" * 70)

        os.makedirs(args.output_folder, exist_ok=True)
        self.train_logger = TensorLogger(os.path.join(args.output_folder, "log/train"), "train")
        self.valid_logger = TensorLogger(os.path.join(args.output_folder, "log/valid"), "valid")
        self.save_information()
        self.best_val_loss: Optional[Dict[str, float]] = None
        self.timer = StepTimer()

    # -- hooks ----------------------------------------------------------
    def __init_parameter__(self):
        pass

    def __init_dataset__(self):
        raise NotImplementedError

    def __init_model__(self):
        raise NotImplementedError

    def __init_loss__(self):
        raise NotImplementedError

    def __init_optimizer__(self):
        raise NotImplementedError

    def train_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device batch; returns its metrics."""
        raise NotImplementedError

    def set_epoch_rates(self, epoch: int) -> None:
        """Every optimizer's learning rate for ``epoch`` (ExponentialLR
        stepped once an epoch)."""
        self.state = set_learning_rate(
            self.state, exponential_lr(self.base_lr, self.gamma, epoch))

    def step_rates(self) -> Dict[str, float]:
        """The learning rates the train log records at a step, by tag."""
        return {"learning_rate": self.state.lr}

    # -- helpers --------------------------------------------------------
    @staticmethod
    def _load_json(path):
        if os.path.exists(path):
            with open(path, "r", encoding="utf8") as f:
                return json.load(f)
        return None

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """numpy batch -> tensors on the device (integer fields as int64)."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def save_information(self):
        ckpt.save_information(self.args.output_folder, self.conf, self.speakers,
                              self.accents, getattr(self, "stats", None))

    def save_model(self):
        path = ckpt.save_checkpoint(self.args.output_folder, self.ckpt_prefix, self.epoch,
                                    self.iter, ckpt.make_payload(self.state))
        log.info(f"saved checkpoint: {path}")

    def resume_path(self) -> Optional[str]:
        """The checkpoint ``try_resume`` loads: ``-c``, else the newest of
        the output folder, else None."""
        return getattr(self.args, "checkpoint", None) or ckpt.scan_checkpoint(
            self.args.output_folder, self.ckpt_prefix)

    def seek(self, iteration: int) -> None:
        """Set the epoch that ``iteration`` falls in and move the training
        batches on to it."""
        self.epoch = iteration // max(self.train_loader.epoch_batches(), 1)
        self.train_loader.skip(iteration)

    def try_resume(self) -> Optional[str]:
        """Load ``resume_path()``, if any: weights, BatchNorm statistics and
        optimizer state; the iteration from its name, ``step = iter``; the
        epoch that iteration falls in (not the name's epoch, which a
        checkpoint at an epoch's end shares with the epoch it closed) and
        that epoch's learning rate; the training batches skip to iteration
        ``iter``. Returns the path loaded, or None."""
        path = self.resume_path()
        if path is None:
            return None
        ckpt.restore_payload(self.state, ckpt.load_checkpoint(path))
        self.iter = self.state.step = ckpt.parse_checkpoint_name(path)[1]
        self.seek(self.iter)
        self.set_epoch_rates(self.epoch)
        log.info(f"resumed from {path} (epoch {self.epoch}, iter {self.iter})")
        return path

    # -- loop -----------------------------------------------------------
    def _install_preemption_handler(self):
        """SIGTERM marks the run preempted; ``_check_preempted`` raises
        ``Preempted`` at the next step or phase boundary (a step updates the
        weights in place, so it is not cut), ``run`` writes one last
        checkpoint and returns, and resume-by-scan picks it up."""
        self._preempted = False

        def _mark(signum, frame):
            self._preempted = True

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _mark)
            self._sigterm_installed = True
        except ValueError:  # not the main thread
            self._prev_sigterm = None
            self._sigterm_installed = False

    def _check_preempted(self):
        if getattr(self, "_preempted", False):
            raise Preempted()

    def _restore_preemption_handler(self):
        """Put the SIGTERM disposition from before ``run`` back."""
        if not getattr(self, "_sigterm_installed", False):
            return
        self._sigterm_installed = False
        try:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
        except (ValueError, TypeError):
            pass

    def _profiled_epoch(self):
        """The first epoch under ``torch.profiler``; the trace goes to
        ``<output>/log/profile``."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out = os.path.join(self.args.output_folder, "log/profile")
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(out)):
            self.train_one_epoch()
        log.info("profiler trace written to log/profile")

    def run(self):
        log.info(f"{self.task}: start training on {self.device}")
        self._install_preemption_handler()
        try:
            try:
                profile = getattr(self.args, "profile", False)
                while self.iter < self.args.max_iter:
                    t0 = time.time()
                    if profile:  # the run's first epoch, counted as any other
                        profile = False
                        self._profiled_epoch()
                    else:
                        self.train_one_epoch()
                    self._check_preempted()
                    # the per-epoch decay comes before validation, as
                    # ExponentialLR.step() in the reference's epoch loop
                    self.set_epoch_rates(self.epoch + 1)
                    self.valid_one_epoch()
                    self._check_preempted()
                    self._log_histograms()
                    self.save_model()
                    log.info(f"Epoch {self.epoch} done in {time.time() - t0:.1f}s "
                             f"(iter {self.iter}/{self.args.max_iter})")
                    self.epoch += 1
            except Preempted:
                log.info(f"SIGTERM at epoch {self.epoch} iter {self.iter}: writing "
                         "preemption checkpoint")
                self.save_model()
                log.info("preemption checkpoint saved; exiting cleanly")
                return
            log.info("training complete")
        finally:
            self._restore_preemption_handler()

    def _log_histograms(self):
        state = getattr(self, "state", None)
        logger = getattr(self, "valid_logger", None)
        if state is None or logger is None:
            return
        if self.device.type == "cuda":
            # a device error of the steps raises here, outside the guard below
            torch.cuda.synchronize(self.device)
        try:
            logger.log_histograms(state.module, self.iter)
        except Exception as exc:  # histograms are best-effort observability
            log.warning(f"histogram logging failed: {exc}")

    def train_one_epoch(self):
        """The training batches of one epoch through ``train_batch``, to
        the epoch's end or ``--max_iter``: the data wait before each step,
        the metrics and rates every ``log_step`` iterations, a preemption
        check after each step."""
        log_step = self.conf["train"]["log_step"]
        batches = iter(self.train_loader)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                batch = self._device_batch(batch)
                self.last_data_wait = time.perf_counter() - t0
                metrics = self.train_batch(batch)
                if self.iter % log_step == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    self.train_logger.log(host, self.iter, rates=self.step_rates())
                    sps = self.timer.steps_per_sec
                    log.info(f"iter {self.iter} | "
                             + " ".join(f"{k}={v:.3f}" for k, v in host.items())
                             + f" | data wait {1e3 * self.last_data_wait:.1f} ms"
                             + (f" | {sps:.2f} it/s" if sps else ""))
                self.timer.tick()
                self.iter += 1
                self._check_preempted()
                if self.iter >= self.args.max_iter:
                    break
        finally:
            close = getattr(batches, "close", None)
            if close is not None:  # stop the prefetch thread
                close()

    def valid_one_epoch(self):
        raise NotImplementedError

    def _report_validation(self, val_loss: Dict[str, float]):
        msgs, improved = [], 0
        for k, v in val_loss.items():
            if v == 0:
                improved += 1
                continue
            if self.best_val_loss and k in self.best_val_loss and self.best_val_loss[k]:
                diff = (v - self.best_val_loss[k]) / self.best_val_loss[k]
            else:
                diff = -1.0
            if diff <= 0:
                improved += 1
                msgs.append(f"{k}-loss {text_colors.OKGREEN}{v:.4f} "
                            f"(↓ {abs(diff)*100:.2f}%){text_colors.ENDC}")
            else:
                msgs.append(f"{k}-loss {text_colors.FAIL}{v:.4f} "
                            f"(↑ {abs(diff)*100:.2f}%){text_colors.ENDC}")
        if improved == len(val_loss):
            self.best_val_loss = dict(val_loss)
        log.info(f"Epoch {self.epoch}: {' - '.join(msgs)}")


class FastSpeech2Trainer(BaseTrainer):
    """Acoustic-only training of the FastSpeech2 model (``models.<task>``,
    conformer or transformer block)."""

    task = "fastspeech2"

    def __init_dataset__(self):
        t0 = time.perf_counter()
        audio_conf = self.conf["audio"]
        stats_path = os.path.join(self.args.output_folder, "stats.json")
        stats = load_stats(stats_path) if os.path.exists(stats_path) else None
        self.train_data = AcousticDataset(self.train_set, audio_conf, self.speakers,
                                          self.accents, stats=stats)
        self.stats = self.train_data.stats
        os.makedirs(self.args.output_folder, exist_ok=True)
        if not os.path.exists(stats_path):
            save_stats(self.stats, stats_path)
        self.valid_data = AcousticDataset(self.test_set, audio_conf, self.speakers,
                                          self.accents, stats=self.stats)
        self.cache_seconds = time.perf_counter() - t0
        log.info(f"feature cache and stats of {len(self.train_set) + len(self.test_set)} "
                 f"utterances: {self.cache_seconds:.1f} s")
        bs = self.conf["train"]["batch_size"]
        self.train_loader = BucketBatcher(self.train_data, bs, seed=self.seed)
        self.valid_loader = BucketBatcher(self.valid_data, bs, seed=self.seed)

    def __init_model__(self):
        from viet_tts_torch.models import build_acoustic
        from viet_tts_torch.nn.utils import seeded_init_

        model = build_acoustic(
            self.n_symbols, self.conf["audio"]["mel"]["channels"], self.conf, self.task,
            self.stats, n_speakers=len(self.speakers) if self.speakers else 1,
            n_accents=len(self.accents) if self.accents else 2)
        # seeded on the CPU, so one seed gives the same weights on any device
        seeded_init_(model, torch.Generator().manual_seed(self.seed))
        self.model = model.to(self.device)

    def __init_loss__(self):
        from viet_tts_torch.models import build_acoustic_loss

        self.criterion = build_acoustic_loss(self.conf, self.task,
                                             is_finetune=getattr(self.args, "is_finetune", False))

    def __init_optimizer__(self):
        from viet_tts_torch.train.steps import make_fs2_train_step, make_fs2_valid_step

        task_conf = self.conf["train"][self.task]
        opt = task_conf["optimizer"]
        self.base_lr = opt["lr"]
        self.gamma = task_conf.get("scheduler", {}).get("gamma", 0.999875)
        tx = adamw_with_clip(self.model.parameters(), self.base_lr,
                             betas=tuple(opt.get("betas", (0.8, 0.99))),
                             eps=opt.get("eps", 1e-9),
                             weight_decay=opt.get("weight_decay", 0.0),
                             grad_clip=self.conf["train"]["grad_clip_thresh"])
        self.state = TrainState.create(self.model, tx)
        self.try_resume()
        self.train_step = make_fs2_train_step(
            self.model, self.criterion,
            mixed_precision=bool(self.conf["train"].get("mixed_precision", False)),
            grad_accum=int(self.conf["train"].get("grad_accum", 1)))
        self.valid_step = make_fs2_valid_step(self.model, self.criterion)

    def train_batch(self, batch):
        self.state, metrics = self.train_step(
            self.state, batch, step_generator(self.seed, self.state.step))
        return metrics

    def valid_one_epoch(self):
        val, n = {"feat": 0.0, "feat_postnet": 0.0}, 0
        for batch in self.valid_loader:
            losses = self.valid_step(self.state, self._device_batch(batch))
            val["feat"] += float(losses["feat"])
            if "feat_postnet" in losses:
                val["feat_postnet"] += float(losses["feat_postnet"])
            n += 1
        val = {k: v / max(n, 1) for k, v in val.items()}
        self.valid_logger.log(val, self.iter)
        self._report_validation(val)


class AdaSpeechTrainer(FastSpeech2Trainer):
    """The same loop with AdaSpeech (``models.adaspeech``) and
    ``AdaSpeechLoss``; the step passes its step count to the forward (the
    distillation and binarization switches) and to the loss."""

    task = "adaspeech"
