"""Train state and optimizer: AdamW with global-norm clipping.

Counterpart of ``viet_tts_tpu/train/state.py`` (``TrainState``,
``adamw_with_clip``, ``set_learning_rate``, ``exponential_lr``,
``apply_init_scheme``). Where optax and torch differ, the port follows
optax:

- ``optax.adamw(weight_decay=0.0)`` as configured (torch's ``AdamW``
  defaults to 0.01);
- ``optax.clip_by_global_norm``: g * max / ||g|| when ||g|| > max, else g
  (``clip_grad_norm_`` scales by max / (||g|| + 1e-6)), written out below;
- Adam with optax's bias-corrected update, lr * m_hat / (sqrt(v_hat) + eps).
  torch's ``AdamW`` computes the same update, so it runs it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple

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
        # the squares summed in fp64: fp32 vector_norm drifts by ~1e-4 on the
        # CPU over a million-element gradient (the MPD's convs)
        norm = torch.sqrt(torch.stack(
            [torch.sum(torch.square(g), dtype=torch.float64) for g in grads]).sum()).float()
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                             self.grad_clip / norm)
        torch._foreach_mul_(grads, factor)
        return norm

    def step(self) -> torch.Tensor:
        """Clip the gradients held in ``.grad``, then one AdamW step;
        returns the gradient norm before clipping. A trainable parameter
        that took no gradient this step (``.grad`` None: AdaSpeech's
        PhonemeLevelEncoder once distillation starts) steps on a zero one,
        as optax steps every leaf: its moments decay and move it on, and
        its step count stays the others'."""
        for p in self.params:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
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


# jax.nn.initializers' variance_scaling arguments: (scale, fan mode, distribution)
INIT_SCHEMES = {
    "xavier_uniform": (1.0, "fan_avg", "uniform"),
    "xavier_normal": (1.0, "fan_avg", "truncated_normal"),
    "kaiming_uniform": (2.0, "fan_in", "uniform"),
    "kaiming_normal": (2.0, "fan_in", "truncated_normal"),
}
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def _fans(shape: Tuple[int, ...], out_first: bool) -> Tuple[int, int]:
    """(fan_in, fan_out) as flax counts them (input axis -2, output -1, the
    rest the receptive field) for a torch weight laid out (out, in, *k)
    (``out_first``: linear and conv weights) or (in, out, *k) (transposed
    convs, embedding tables and raw parameter matrices, which keep flax's
    order)."""
    receptive = math.prod(shape[2:])
    n_out, n_in = (shape[0], shape[1]) if out_first else (shape[1], shape[0])
    return n_in * receptive, n_out * receptive


def _draw_(t: torch.Tensor, scheme: str, fans: Tuple[int, int],
           generator: torch.Generator) -> None:
    scale, mode, dist = INIT_SCHEMES[scheme]
    fan_in, fan_out = fans
    variance = scale / (fan_in if mode == "fan_in" else (fan_in + fan_out) / 2)
    if dist == "uniform":
        bound = math.sqrt(3.0 * variance)
        x = (torch.rand(t.shape, generator=generator, dtype=torch.float64) * 2 - 1) * bound
    else:  # inverse CDF of a unit normal truncated at +-2, then scaled
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        u = lo + (1 - 2 * lo) * torch.rand(t.shape, generator=generator, dtype=torch.float64)
        x = math.sqrt(2) * torch.erfinv(2 * u - 1) * math.sqrt(variance) / _TRUNC_STD
    t.copy_(x.to(t.dtype))


@torch.no_grad()
def apply_init_scheme(model: nn.Module, init_type: Optional[str],
                      generator: torch.Generator) -> nn.Module:
    """Re-initialise ``model``'s weight matrices by an espnet-style scheme,
    as the JAX package does after init (the reference's
    ``initialize(self, init_type)``): every parameter that flax holds with
    ndim > 1 is redrawn from the scheme, biases are zeroed, the rest keeps
    its value. As in the JAX rule, an embedding table is kept when its
    module's name holds "embed" (the encoder's; the speaker table is
    redrawn), and so is ``rel_pos_emb``. Where the torch layout differs
    from flax's, flax's parameters decide: a weight-normed conv redraws its
    direction ``weight_v`` and keeps its scale ``weight_g`` (1-D in flax),
    and a GRU redraws each gate's (H, in) block apart (flax's gate
    kernels). Draws come from ``generator`` on the CPU; ``"pytorch"`` or
    None leaves the model as it is."""
    if init_type in ("pytorch", None):
        return model
    if init_type not in INIT_SCHEMES:
        raise ValueError(f"unknown init_type {init_type!r}")
    for mod_name, m in model.named_modules():
        for name, p in m.named_parameters(recurse=False):
            if isinstance(m, nn.GRU):
                if name.startswith("weight_"):
                    for gate in p.view(3, p.shape[0] // 3, p.shape[1]):
                        _draw_(gate, init_type, _fans(gate.shape, True), generator)
                else:
                    p.zero_()
            elif name in ("weight_g", "rel_pos_emb") or (
                    isinstance(m, nn.Embedding) and "embed" in mod_name.lower()):
                continue
            elif p.ndim > 1:
                # torch's conv modules and this package's weight-normed
                # transposed conv say their layout in ``transposed``
                transposed = getattr(m, "transposed", False)
                out_first = not transposed and (
                    isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)) or name == "weight_v")
                _draw_(p, init_type, _fans(tuple(p.shape), out_first), generator)
            elif name == "bias":
                p.zero_()
    return model
