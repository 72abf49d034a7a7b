"""Train state and optimizer: AdamW with global-norm clipping.

Counterpart of ``viet_tts_tpu/train/state.py`` (``TrainState``,
``adamw_with_clip``, ``set_learning_rate``, ``exponential_lr``). Where optax
and torch differ, the port follows optax:

- ``optax.adamw(weight_decay=0.0)`` as configured (torch's ``AdamW``
  defaults to 0.01);
- ``optax.clip_by_global_norm``: g * max / ||g|| when ||g|| > max, else g
  (``clip_grad_norm_`` scales by max / (||g|| + 1e-6)), written out below;
- Adam with optax's bias-corrected update, lr * m_hat / (sqrt(v_hat) + eps).
  torch's ``AdamW`` computes the same update, so it runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
from torch import nn


@dataclasses.dataclass
class AdamWWithClip:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(...))`` behind an
    injectable learning rate."""

    params: List[nn.Parameter]
    lr: float
    betas: tuple = (0.8, 0.99)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def __post_init__(self):
        self.opt = torch.optim.AdamW(self.params, lr=self.lr, betas=tuple(self.betas),
                                     eps=self.eps, weight_decay=self.weight_decay,
                                     foreach=True)

    @torch.no_grad()
    def clip_by_global_norm(self) -> torch.Tensor:
        """Scale every gradient by max / ||g|| when the global norm exceeds
        max (optax's rule); returns the norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                             self.grad_clip / norm)
        torch._foreach_mul_(grads, factor)
        return norm

    def step(self) -> torch.Tensor:
        """Clip the gradients held in ``.grad``, then one AdamW step;
        returns the gradient norm before clipping."""
        norm = self.clip_by_global_norm()
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.step()
        return norm

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)


def adamw_with_clip(params: Iterable[nn.Parameter], lr: float, betas=(0.8, 0.99),
                    eps: float = 1e-9, weight_decay: float = 0.0,
                    grad_clip: float = 1.0) -> AdamWWithClip:
    """AdamW + global-norm clipping, with an injectable learning rate."""
    return AdamWWithClip(list(params), lr, tuple(betas), eps, weight_decay, grad_clip)


@dataclasses.dataclass
class TrainState:
    """A module with its optimizer and step count (the flax TrainState's
    params, opt_state and step; BatchNorm statistics live in the module's
    buffers)."""

    module: nn.Module
    tx: AdamWWithClip
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None  # the last step's, before clipping

    @classmethod
    def create(cls, module: nn.Module, tx: Optional[AdamWWithClip] = None,
               lr: float = 2e-4, **tx_kw) -> "TrainState":
        return cls(module, tx or adamw_with_clip(module.parameters(), lr, **tx_kw))

    @property
    def lr(self) -> float:
        return self.tx.lr

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer step on the gradients in ``.grad``; returns the
        global gradient norm before clipping."""
        self.grad_norm = self.tx.step()
        self.step += 1
        return self.grad_norm


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Update the injected learning rate (host side, between epochs)."""
    state.tx.lr = float(lr)
    return state


def exponential_lr(base_lr: float, gamma: float, epoch: int) -> float:
    return float(base_lr * (gamma ** epoch))
