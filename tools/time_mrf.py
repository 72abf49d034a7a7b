#!/usr/bin/env python3
"""Time kernel K2 (``fused_mrf_stage``, the fused HiFi-GAN MRF stage) of
one or more checkouts on one NVIDIA card, in turns, at the two stages a
JETS serving call of 16 sentences at 1008 frames runs on it: C=64 at
T=128*1008 and C=32 at T=256*1008, B=16.

    python3 tools/time_mrf.py                    # this checkout
    python3 tools/time_mrf.py OLD NEW NEW OLD    # checkouts in turns

Each argument is the root of a checkout of this repository. Each runs in a
process of its own, in the order given, and builds its kernels into its own
``build/``. Inputs and weights are seeded (the weight scales of
``chip_smoke.py``). Each shape is first checked against the plain version
(fp32 within 1e-4, TF32 off) at seq_len = T and at a ragged seq_len, with
zeros past it. Times are CUDA-event means over 5 stage calls after 2
warm-ups, fp32 with TF32 off, at seq_len = T. The card's name and power
limit come first, one line per (checkout, shape) follows, and the last line
is a JSON object of the times and of each checkout's launches a stage.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
# (label, B, T, C): the JETS call's two fused stages
SHAPES = (("C=64 (16, 129024)", 16, 128 * 1008, 64),
          ("C=32 (16, 258048)", 16, 256 * 1008, 32))


def worker() -> None:
    """Time this checkout's K2 (the working directory's package)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from viet_tts_torch.ops import fused_mrf as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    times, launches = {}, {}
    for label, B, T, C in SHAPES:
        rng = np.random.RandomState(C)
        x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(dev)
        ws = ([], [], [], [])
        for k, d in zip(KS, DILS):
            std = 1.0 / np.sqrt(k * C)
            for i, shape in enumerate([(len(d), k, C, C), (len(d), C)] * 2):
                scale = std if len(shape) == 4 else 0.1
                ws[i].append(torch.from_numpy(
                    (rng.randn(*shape) * scale).astype(np.float32)).to(dev))
        ws = tuple(tuple(w) for w in ws)
        for seq_len in (T, T - 37 * 256 - 5):
            before = fm.fused_mrf_stage.launches
            got = fm.fused_mrf_stage(x, seq_len, *ws)
            launches[label] = fm.fused_mrf_stage.launches - before
            want = fm.fused_mrf_stage_plain(x, seq_len, *ws)
            err = (got - want).abs().max().item()
            if not (err <= 1e-4 and not got[:, seq_len:].any()):
                raise AssertionError(f"{label} seq_len {seq_len}: max_abs_err {err}")
            del got, want
        call = lambda: fm.fused_mrf_stage(x, T, *ws)  # noqa: E731
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            call()
        stop.record()
        torch.cuda.synchronize()
        times[label] = start.elapsed_time(stop) / 5
        del x, ws
        torch.cuda.empty_cache()
    print(json.dumps({"ms": times, "launches": launches}))


def main() -> int:
    if sys.argv[1:] == ["--worker"]:
        worker()
        return 0
    checkouts = sys.argv[1:] or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in checkouts:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                             cwd=os.path.abspath(root), check=True, capture_output=True,
                             text=True).stdout
        run = json.loads(out.strip().splitlines()[-1])
        for key, ms in run["ms"].items():
            print(f"{root}: K2 {key} {ms:.4f} ms, {run['launches'][key]} launches",
                  flush=True)
        print(f"{root}: K2 a JETS call {sum(run['ms'].values()):.4f} ms", flush=True)
        runs.append({"checkout": root, **run})
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
