"""Trainer checkpoints with resume-by-scan.

Counterpart of ``viet_tts_tpu/train/checkpoint.py`` in torch's format: one
``torch.save`` file per save, named
``{prefix}_epoch{E}_iteration{I}_statedict.pt``, holding

    {"model": the module's state_dict (BatchNorm buffers included),
     "optimizer": the AdamW state_dict, "step": the optimizer step count}

(``make_payload`` / ``restore_payload``); the newest three are kept; the
newest by iteration is found by ``scan_checkpoint``; ``apply_weights``
carries what matches by name and shape from one state dict into another.
``save_information`` writes the sidecars serving reads: ``config.json``
and the speakers, accents and stats JSON files.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

SUFFIX = "_statedict.pt"


def checkpoint_name(prefix: str, epoch: int, iteration: int) -> str:
    return f"{prefix}_epoch{epoch}_iteration{iteration}{SUFFIX}"


def parse_checkpoint_name(path: str) -> Tuple[int, int]:
    m = re.search(r"epoch(\d+)_iteration(\d+)", os.path.basename(path))
    if not m:
        raise ValueError(f"unparseable checkpoint name: {path}")
    return int(m.group(1)), int(m.group(2))


def _candidates(ckpt_dir: str, prefix: str):
    return glob.glob(os.path.join(glob.escape(ckpt_dir), f"{prefix}*{SUFFIX}"))


def scan_checkpoint(ckpt_dir: str, prefix: str) -> Optional[str]:
    """The newest checkpoint by iteration number, or None."""
    candidates = _candidates(ckpt_dir, prefix)
    if not candidates:
        return None
    return max(candidates, key=lambda p: parse_checkpoint_name(p)[1])


def clear_disk(ckpt_dir: str, prefix: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` checkpoints (by iteration)."""
    candidates = sorted(_candidates(ckpt_dir, prefix),
                        key=lambda p: parse_checkpoint_name(p)[1])
    for path in candidates[:-keep]:
        os.remove(path)


def save_checkpoint(ckpt_dir: str, prefix: str, epoch: int, iteration: int,
                    payload: Dict[str, Any], keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, checkpoint_name(prefix, epoch, iteration))
    torch.save(payload, path)
    clear_disk(ckpt_dir, prefix, keep=keep)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def make_payload(state) -> Dict[str, Any]:
    """A ``TrainState``'s module, optimizer and step, on the host (the
    learning rate follows from the step: ``trainer.BaseTrainer.try_resume``)."""
    return {"model": _cpu(state.module.state_dict()),
            "optimizer": _cpu(state.tx.opt.state_dict()), "step": int(state.step)}


def restore_payload(state, payload: Dict[str, Any]):
    """Load a ``make_payload`` dict into ``state`` in place (tensors go to
    the module's device)."""
    state.module.load_state_dict(payload["model"])
    state.tx.opt.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def model_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model's state dict from a trainer checkpoint or a bare
    ``state_dict`` file."""
    payload = load_checkpoint(path)
    if isinstance(payload, dict) and "model" in payload and "optimizer" in payload:
        return payload["model"]
    return payload


def apply_weights(target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor]):
    """Tolerant weight transfer: take each entry of ``source`` whose name
    exists in ``target`` with the same shape; returns (the merged state
    dict, the names kept from ``target``)."""
    out, skipped = {}, []
    for k, v in target.items():
        if k in source and tuple(source[k].shape) == tuple(v.shape):
            out[k] = source[k]
        else:
            out[k] = v
            skipped.append(k)
    return out, skipped


def save_information(out_dir: str, conf: Dict[str, Any], speakers: Optional[dict] = None,
                     accents: Optional[dict] = None, stats: Optional[dict] = None) -> None:
    """Sidecar metadata needed to reload a model for inference."""
    os.makedirs(out_dir, exist_ok=True)
    for name, obj in (("config.json", conf), ("speakers.json", speakers),
                      ("accents.json", accents), ("stats.json", stats)):
        if obj is not None:
            with open(os.path.join(out_dir, name), "w", encoding="utf8") as f:
                json.dump(obj, f, indent=1, ensure_ascii=False)
