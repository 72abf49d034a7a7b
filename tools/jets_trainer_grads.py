#!/usr/bin/env python3
"""How closely the JETS trainer's first-step gradients agree between the
card and the CPU, per parameter tensor, on one NVIDIA card: the yardstick
for ``chip_smoke.py`` phase 19's gradient check (``GRAD_REL_TOL``).

    python3 tools/jets_trainer_grads.py

It builds the kernels, writes phase 19's card-vs-CPU dataset (3 utterances
of ~2 s, one mel bucket) and config (full-width JETS, every dropout 0,
batch 2) under ``build/jets_trainer_grads/``, and runs one step of
``python -m viet_tts_torch.train --task jets`` three times from the same
seed: on the card with ``attn_implementation: flash`` (K1, K3a, K3b), on the
card with ``shift`` (the plain PyTorch attention, no kernel of the port),
and on the CPU with ``flash`` (the kernels' plain versions). For each pair
it prints, over the self-attention tensors (the key bias left out: its
gradient is 0 in exact arithmetic) and over every other tensor, the median,
90th percentile and largest of ||a - b|| / ||b|| and of max|a - b| /
max|b|. The card's name and power limit come first; the last line is a
JSON object of those figures.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RUNS = (("card flash", "cuda", "flash"), ("card shift", "cuda", "shift"),
        ("cpu flash", "cpu", "flash"))
PAIRS = (("card flash", "cpu flash"), ("card shift", "cpu flash"),
         ("card flash", "card shift"))


def _config(root: str, attn: str) -> str:
    """Phase 19's card-vs-CPU config copy, with ``attn`` for JETS."""
    flash = cs.trainer_config(root, zero_dropout=True, batch_size=2)
    if attn == "flash":
        return flash
    out = os.path.join(root, f"config_{attn}")
    os.makedirs(out, exist_ok=True)
    for name in os.listdir(flash):
        with open(os.path.join(flash, name), encoding="utf8") as f:
            text = f.read()
        if name == "model_config.yaml":  # the JETS generator's line (4 spaces)
            text = text.replace("    attn_implementation: flash\n",
                                f"    attn_implementation: {attn}\n")
        with open(os.path.join(out, name), "w", encoding="utf8") as f:
            f.write(text)
    return out


def _stats(values):
    vals = sorted(values)
    return {"median": vals[len(vals) // 2], "p90": vals[int(0.9 * len(vals))],
            "max": vals[-1], "n": len(vals)}


def main() -> int:
    from viet_tts_torch.runtime import kernels
    from viet_tts_torch.train.__main__ import main as train

    if not torch.cuda.is_available():
        print("jets_trainer_grads: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    root = cs._fresh_dir(os.path.join(ROOT, "build", "jets_trainer_grads"))
    cs.write_trainer_dataset(root, 3, (2.0,), cs.SEED + 1)
    grads = {}
    for label, device, attn in RUNS:
        probe = []
        argv = cs._trainer_argv(root, _config(root, attn), f"out_{label.replace(' ', '_')}",
                                1, "--device", device, task="jets")
        train(argv, on_trainer=lambda tr: probe.append(cs._StepProbe(
            tr, cs._flash_wrappers, sync=device == "cuda", grads_of="")))
        (step,) = probe[0].steps
        grads[label] = step["grads"]
        print(f"{label}: launches {step['launches']}, metrics {step['metrics']}", flush=True)
    figures = {}
    for a, b in PAIRS:
        rel = {}
        for name, g in grads[b].items():
            d, g = (grads[a][name] - g).double(), g.double()
            rel[name] = ((d.norm() / g.norm()).item(),
                         (d.abs().max() / g.abs().max()).item())
        groups = {
            "self_attn": [v for n, v in rel.items()
                          if ".self_attn." in n and not n.endswith("linear_k.bias")],
            "other": [v for n, v in rel.items() if ".self_attn." not in n],
        }
        figures[f"{a} vs {b}"] = {
            group: {"norm_rel": _stats(v[0] for v in vals),
                    "max_rel": _stats(v[1] for v in vals)}
            for group, vals in groups.items()}
        for group, fig in figures[f"{a} vs {b}"].items():
            print(f"{a} vs {b}, {group} ({fig['norm_rel']['n']} tensors): ||a - b|| / ||b|| "
                  f"median {fig['norm_rel']['median']:.3e} p90 {fig['norm_rel']['p90']:.3e} "
                  f"max {fig['norm_rel']['max']:.3e}; max|a - b| / max|b| max "
                  f"{fig['max_rel']['max']:.3e}", flush=True)
    print(json.dumps({"device": smi, "pairs": figures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
