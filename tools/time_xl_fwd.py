#!/usr/bin/env python3
"""Time the tensor-core forward kernels (K1 ``attention_fwd``, K4
``flash_xl3_fwd``, K5 ``flash_xl2_fwd``, K6 ``flash_xl_fwd``, K7
``flash_rel_fwd``) of one or more checkouts on one NVIDIA card, in turns,
at the shapes the serving and training paths run them.

    python3 tools/time_xl_fwd.py                    # this checkout
    python3 tools/time_xl_fwd.py OLD NEW NEW OLD    # checkouts in turns

Each argument is the root of a checkout of this repository. Each runs in a
process of its own, in the order given, and builds its kernels into its own
``build/``. Every timed launch is first checked against its plain version
(ctx within 1e-4 in fp32, 2e-2 in bf16). Times are CUDA-event means over
10 launches after 2 warm-ups, fp32 with TF32 off, and bf16. K4 runs at the
FS2 two-stage call's encoder shape with no pad mask and no dropout, and at
the FS2 training shapes (encoder and the 512-frame decoder) with attention
dropout 0.1. K5 and K6 at
D=48 run with no pad mask and no dropout; K7 and K6 at D=128 (the JETS
conformer's two flavours) with the serving path's ragged pad mask (the
lengths ``chip_smoke.py`` draws: seeded, one full row, one fully padded
row), and K7 also at the training shape with no pad mask and attention
dropout 0.2. K1 (JETS, D=128) runs at the serving call's decoder shape
with that ragged mask and with every row full, at its text bucket with
the ragged mask, and at the training decoder with attention dropout 0.2.
The card's name and power limit come first, one line per (checkout, shape,
dtype) follows, and the last line is a JSON object of the times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# (label, kind, B, T, H, D, ragged pad mask, dropout): K4 at the FS2
# two-stage call's encoder shape and the FS2 training step's encoder and
# 512-frame decoder, K5 at the FS2 two-stage call's decoder shape, K6 at the
# FS2 2048-frame decoder and at the JETS conformer's width (legacy flavour),
# K7 at the JETS conformer's serving shapes (text bucket and decoder) and
# training decoder, K1 at the JETS serving and training shapes
SHAPES = (
    ("K1 (16, 1008) ragged", "k1", 16, 1008, 2, 128, True, 0.0),
    ("K1 (16, 1008) full", "k1", 16, 1008, 2, 128, False, 0.0),
    ("K1 (16, 64) ragged", "k1", 16, 64, 2, 128, True, 0.0),
    ("K1 (8, 512) dropout 0.2", "k1", 8, 512, 2, 128, False, 0.2),
    ("K1 (8, 64) dropout 0.2", "k1", 8, 64, 2, 128, False, 0.2),
    ("K4 (16, 64) D=48", "xl3", 16, 64, 8, 48, False, 0.0),
    ("K4 (8, 64) D=48 dropout 0.1", "xl3", 8, 64, 8, 48, False, 0.1),
    ("K4 (8, 512) D=48 dropout 0.1", "xl3", 8, 512, 8, 48, False, 0.1),
    ("K5 (16, 1008) D=48", "xl2", 16, 1008, 8, 48, False, 0.0),
    ("K6 (4, 2048) D=48", "xl", 4, 2048, 8, 48, False, 0.0),
    ("K6 (16, 1008) D=128", "xl", 16, 1008, 2, 128, False, 0.0),
    ("K6 (16, 1008) D=128 ragged", "xl", 16, 1008, 2, 128, True, 0.0),
    ("K7 (16, 1008) ragged", "rel", 16, 1008, 2, 128, True, 0.0),
    ("K7 (16, 64) ragged", "rel", 16, 64, 2, 128, True, 0.0),
    ("K7 (8, 512) dropout 0.2", "rel", 8, 512, 2, 128, False, 0.2),
)


def worker() -> None:
    """Time this checkout's kernels (the working directory's package)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from viet_tts_torch.nn.espnet_conformer import rel_positional_table
    from viet_tts_torch.nn.utils import sinusoid_position_table
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_rel_attention as fr
    from viet_tts_torch.ops import flash_xl_attention as fx
    from viet_tts_torch.ops.espnet_attention import neg_rel_table, rel_pos_queries_latest
    from viet_tts_torch.ops.xl_attention import xl_pos_queries, xl_pos_query_stream

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    times = {}
    for label, kind, B, T, H, D, ragged, p in SHAPES:
        E = H * D
        gen = torch.Generator().manual_seed(T + D)
        f = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
        q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
        qc, qv = q + 0.3 * f(H, D), q + 0.3 * f(H, D)
        pos_kernel = f(E, E) / np.sqrt(E)
        pad = None
        if ragged:
            lens = np.random.RandomState(T + 3).randint(1, T + 1, B)
            lens[0], lens[-1] = T, 0
            pad = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        if kind == "k1":
            streams = (q, k, v)
            fwd, plain = fa.attention_fwd, fa.attention_fwd_plain
        elif kind == "rel":
            table = neg_rel_table(torch.from_numpy(rel_positional_table(T, E)).to(dev))
            streams = (qc, k, v, rel_pos_queries_latest(qv, pos_kernel), table.contiguous())
            fwd, plain = fr.rel_fwd, fr.rel_fwd_plain
        else:
            table = torch.from_numpy(sinusoid_position_table(T, E)).to(dev)
            if kind == "xl3":
                streams = (qc, k, v, qv, (table @ pos_kernel).reshape(T, H, D))
                fwd, plain = fx.xl3_fwd, fx.xl3_fwd_plain
            elif kind == "xl2":
                streams = (qc, k, v, xl_pos_query_stream(qv, pos_kernel), table)
                fwd, plain = fx.xl2_fwd, fx.xl2_fwd_plain
            else:
                streams = (qc, k, v, *xl_pos_queries(qv, pos_kernel), table)
                fwd, plain = fx.xl_fwd, fx.xl_fwd_plain
        scale = D ** -0.5 if D == 128 else 1.0 / np.sqrt(E)  # JETS / FS2
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = [x.to(dtype) for x in streams]
            call = lambda: fwd(*args, scale, pad, p, 11)
            ctx, _ = call()
            ref, _ = plain(*args, scale, pad, p, 11)
            err = (ctx - ref).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{label} {dtype}: max_abs_err {err} (tol {tol})")
            del ctx, ref
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            stop.record()
            torch.cuda.synchronize()
            times[f"{label} {str(dtype)[6:]}"] = start.elapsed_time(stop) / 10
        del streams
        torch.cuda.empty_cache()
    print(json.dumps(times))


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
        times = json.loads(out.strip().splitlines()[-1])
        for key, ms in times.items():
            print(f"{root}: {key} {ms:.4f} ms", flush=True)
        runs.append({"checkout": root, "ms": times})
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
