"""Training CLI of the port, with the JAX package's ``train.py`` flags.

    python -m viet_tts_torch.train --task fastspeech2 -i egs/dir -d data/dir -o out/dir
    python -m viet_tts_torch.train --task adaspeech ... | --task matcha ...
    python -m viet_tts_torch.train --task jets ... | --task hifigan ... | --task vits2 ...
    python -m viet_tts_torch.train --task text2wav ... [-a fs2_out -v hifigan_out]
    python -m viet_tts_torch.train --task text2wav --version adaspeech ... [-a adaspeech_out]
    python -m viet_tts_torch.train --task text2wav --version matcha ... [-a matcha_out]
    python -m viet_tts_torch.train --task text2wav --is_finetune -c joint_ckpt ...
    python -m viet_tts_torch.train --task fastspeech2 ... --device cpu

Runs on the CUDA card unless ``--device`` names another; it never falls
back to the CPU. ``-i`` holds (or receives) ``train.txt`` / ``test.txt``
and ``speakers.json`` / ``accents.json``; ``-d`` the dataset
(``<speaker>/metadata.csv`` and ``<speaker>/wavs/``); ``-o`` the
checkpoints, sidecars and ``log/``. A rerun with the same ``-o`` resumes
from its newest checkpoint; for ``fastspeech2``, ``adaspeech``,
``matcha``, ``jets``, ``hifigan`` and ``vits2``, ``-c`` names a port
trainer checkpoint to resume from instead. The GAN tasks (``jets``,
``hifigan``, ``vits2``, ``text2wav``) also write and resume
``last_discriminator_statedict.pt`` there (``vits2``: the multi-period and
the duration discriminator together). ``text2wav`` (the default,
``Text2Wav`` of ``--version`` fastspeech2, adaspeech or matcha;
``train/joint.py``) starts, when ``-o``
holds no checkpoint, from a joint checkpoint's weights (``-c``), or from a
``--task <version>`` output (``-a``) and a ``--task hifigan`` output
(``-v``); ``--is_finetune`` adapts the joint checkpoint ``-c`` to the
speakers of ``-i`` (text2wav only). ``matcha`` (``train/matcha.py``)
writes the dataset's mel statistics to ``<out>/stats.json`` on its first
run and reads them back after; ``vits2`` is ``train/vits2_trainer.py``.
"""

from __future__ import annotations

import argparse
import logging
import random
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from viet_tts_torch.config import build_config

TASKS = ["text2wav", "fastspeech2", "adaspeech", "jets", "vits2", "matcha", "hifigan"]


def build_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m viet_tts_torch.train")
    parser.add_argument("--task", default="text2wav", choices=TASKS,
                        help="task trainer, (default: %(default)s)")
    parser.add_argument("-i", "--input_folder", type=str, required=True,
                        help="directory holding filelists + speakers/accents json")
    parser.add_argument("-d", "--data_folder", type=str, required=True,
                        help="directory holding the dataset")
    parser.add_argument("-o", "--output_folder", type=str, required=True,
                        help="directory for checkpoints/logs")
    parser.add_argument("-c", "--checkpoint", type=str, default=None,
                        help="a port trainer checkpoint to resume from (text2wav: a joint "
                             "checkpoint to start from, or to adapt with --is_finetune)")
    parser.add_argument("-a", "--acoustic_checkpoint", type=str, default=None,
                        help="path to an acoustic pretrained checkpoint")
    parser.add_argument("-v", "--vocoder_checkpoint", type=str, default=None,
                        help="path to a vocoder pretrained checkpoint")
    parser.add_argument("--version", type=str, default="fastspeech2",
                        choices=["fastspeech2", "matcha", "adaspeech"],
                        help="acoustic model family for text2wav")
    parser.add_argument("--config", type=str, default="config/",
                        help="config directory (3-yaml layout)")
    parser.add_argument("--max_iter", type=int, default=2000000)
    parser.add_argument("--is_finetune", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of the first epoch to "
                             "<output>/log/profile")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "PyTorch path)")
    return parser.parse_args(argv)


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_trainer(args, conf):
    if args.task == "text2wav":
        from viet_tts_torch.train.joint import JointFinetuner, JointTrainer

        return (JointFinetuner if args.is_finetune else JointTrainer)(args, conf)
    if args.is_finetune:
        raise ValueError(f"Fine-tuning model is not supported for `{args.task}` yet!")
    from viet_tts_torch.train.gan import HiFiGANTrainer, JETSTrainer
    from viet_tts_torch.train.matcha import MatchaTrainer
    from viet_tts_torch.train.trainer import AdaSpeechTrainer, FastSpeech2Trainer
    from viet_tts_torch.train.vits2_trainer import VITS2Trainer

    trainers = {"fastspeech2": FastSpeech2Trainer, "adaspeech": AdaSpeechTrainer,
                "matcha": MatchaTrainer, "jets": JETSTrainer, "hifigan": HiFiGANTrainer,
                "vits2": VITS2Trainer}
    return trainers[args.task](args, conf)


def main(argv: Optional[Sequence[str]] = None,
         on_trainer: Optional[Callable] = None):
    """Parse ``argv``, build the trainer, call ``on_trainer(trainer)`` if
    given (before training starts), train; returns the trainer."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    args = build_arguments(argv)
    conf = build_config(args.config)
    set_seed(conf["train"]["seed"])
    trainer = make_trainer(args, conf)
    if on_trainer is not None:
        on_trainer(trainer)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
