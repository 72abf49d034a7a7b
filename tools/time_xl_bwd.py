#!/usr/bin/env python3
"""Time the K4 backward, the K5 / K6 backward (bwd-q and bwd-kv together),
K7 bwd-q and the whole K7 backward of one or more checkouts on one NVIDIA
card, in turns, at the shapes the training paths run them, with each
kernel's device time.

    python3 tools/time_xl_bwd.py                    # this checkout
    python3 tools/time_xl_bwd.py OLD NEW NEW OLD    # checkouts in turns

Each argument is the root of a checkout of this repository. Each runs in a
process of its own, in the order given, and builds its kernels into its own
``build/``. The backward is what the autograd function of that checkout
runs: ``xl3_bwd`` for K4; ``xl2_bwd`` / ``xl_bwd`` where the checkout has
them (bwd-q and bwd-kv on shared scratches), else ``xl2_bwd_dq`` then
``xl2_bwd_dkv`` (the same for ``xl_``); ``rel_bwd_dq`` for K7 bwd-q;
``rel_bwd`` for the whole K7 backward where the checkout has it, else
``rel_bwd_dq`` then ``rel_bwd_dkv``. It is
first checked against the plain versions (every
gradient within 1e-4, scaled by its largest value where that exceeds 1).
Times are CUDA-event means over 10 calls after 2 warm-ups, fp32 with TF32
off, no pad mask, the path's attention dropout; then three calls under
``torch.profiler`` give each kernel's device time a call (their mean), by
name.
The card's name and power limit come first, one line per (checkout, shape)
follows, and the last line is a JSON object of the times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# (label, kind, B, T, H, D, dropout): K4 at the FS2 encoder's text bucket
# and the decoder's 512 frames, K5 at the FS2 decoder's 1008 frames, K6 at
# the FS2 2048-frame bucket and at the JETS legacy conformer's decoder, K7
# bwd-q at the JETS conformer's training encoder and decoder
SHAPES = (
    ("K4 (8, 64) D=48", "xl3", 8, 64, 8, 48, 0.1),
    ("K4 (8, 512) D=48", "xl3", 8, 512, 8, 48, 0.1),
    ("K5 (8, 1008) D=48", "xl2", 8, 1008, 8, 48, 0.1),
    ("K6 (4, 2048) D=48", "xl", 4, 2048, 8, 48, 0.1),
    ("K6 (8, 512) D=128", "xl", 8, 512, 2, 128, 0.2),
    ("K7 bwd-q (8, 64)", "rel", 8, 64, 2, 128, 0.2),
    ("K7 bwd-q (8, 512)", "rel", 8, 512, 2, 128, 0.2),
    ("K7 whole (8, 64)", "rel_whole", 8, 64, 2, 128, 0.2),
    ("K7 whole (8, 512)", "rel_whole", 8, 512, 2, 128, 0.2),
)
# kernel-name fragments of the backwards, in launch order (K4's, then K5 /
# K6's; K4's bwd-kv is an instance of K5 / K6's kernel, and K7 runs K5 /
# K6's Q1, Q2 and bwd-kv; rel_bwd_q and rel_bwd_kv are the CUDA-core K7
# kernels of older checkouts)
KERNELS = ("xl3_bwd_ds", "xl3_bwd_q", "xl3_bwd_kv", "xl3_bwd_reduce",
           "xl2_rotate", "xl2_bwd_q1_pos", "xl2_bwd_q1_ds", "xl2_bwd_q2", "xl2_bwd_unrotate",
           "xl2_bwd_kv", "xl2_bwd_dtab", "rel_bwd_q", "rel_bwd_kv")


def worker() -> None:
    """Time this checkout's backward (the working directory's package)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from viet_tts_torch.nn.espnet_conformer import rel_positional_table
    from viet_tts_torch.nn.utils import sinusoid_position_table
    from viet_tts_torch.ops import flash_rel_attention as fr
    from viet_tts_torch.ops import flash_xl_attention as fx
    from viet_tts_torch.ops.espnet_attention import neg_rel_table, rel_pos_queries_latest
    from viet_tts_torch.ops.flash_attention import backward_inputs
    from viet_tts_torch.ops.xl_attention import xl_pos_queries, xl_pos_query_stream

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for label, kind, B, T, H, D, p in SHAPES:
        E = H * D
        gen = torch.Generator().manual_seed(T + D)
        f = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
        q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
        qc, qv = q + 0.3 * f(H, D), q + 0.3 * f(H, D)
        pos_kernel = f(E, E) / np.sqrt(E)
        table = torch.from_numpy(sinusoid_position_table(T, E)).to(dev)
        scale = D ** -0.5 if D == 128 else 1.0 / np.sqrt(E)  # JETS / FS2
        if kind in ("rel", "rel_whole"):
            neg = neg_rel_table(torch.from_numpy(rel_positional_table(T, E)).to(dev))
            args = (qc, k, v, rel_pos_queries_latest(qv, pos_kernel), neg.contiguous())
            fwd, whole = fr.rel_fwd, fr.rel_bwd_dq
            if kind == "rel_whole":
                whole = getattr(fr, "rel_bwd", None)
                dq, dkv, dq_plain, dkv_plain = (fr.rel_bwd_dq, fr.rel_bwd_dkv,
                                                fr.rel_bwd_dq_plain, fr.rel_bwd_dkv_plain)
        elif kind == "xl3":
            args = (qc, k, v, qv, (table @ pos_kernel).reshape(T, H, D))
            fwd, whole = fx.xl3_fwd, fx.xl3_bwd
        elif kind == "xl2":
            args = (qc, k, v, xl_pos_query_stream(qv, pos_kernel), table)
            fwd, dq, dkv, dq_plain, dkv_plain = (fx.xl2_fwd, fx.xl2_bwd_dq, fx.xl2_bwd_dkv,
                                                 fx.xl2_bwd_dq_plain, fx.xl2_bwd_dkv_plain)
            whole = getattr(fx, "xl2_bwd", None)
        else:
            args = (qc, k, v, *xl_pos_queries(qv, pos_kernel), table)
            fwd, dq, dkv, dq_plain, dkv_plain = (fx.xl_fwd, fx.xl_bwd_dq, fx.xl_bwd_dkv,
                                                 fx.xl_bwd_dq_plain, fx.xl_bwd_dkv_plain)
            whole = getattr(fx, "xl_bwd", None)
        seed = 97 * T + D
        ctx, lse = fwd(*args, scale, None, p, seed)
        gout = f(*ctx.shape)
        delta, g = backward_inputs(ctx, gout, torch.float32)
        bargs = (*args, torch.zeros(B, T, device=dev), lse, delta, g, scale, p, seed)
        if whole is not None:
            run = lambda: whole(*bargs)
        else:
            run = lambda: (dq(*bargs), dkv(*bargs))
        run()
        if kind == "rel":
            got, want = fr.rel_bwd_dq(*bargs), fr.rel_bwd_dq_plain(*bargs)
        elif kind == "xl3":
            got, want = fx.xl3_bwd(*bargs), fx.xl3_bwd_plain(*bargs)
        elif kind == "rel_whole" and whole is not None:
            dqc, dk, dv, dg, _ = whole(*bargs)
            got, want = (dqc, dg, dk, dv), (*dq_plain(*bargs), *dkv_plain(*bargs)[:2])
        else:
            got = (*dq(*bargs), *dkv(*bargs)[:2])
            want = (*dq_plain(*bargs), *dkv_plain(*bargs)[:2])
        for i, (a, b) in enumerate(zip(got, want)):
            err = (a - b).abs().max().item()
            if not err <= 1e-4 * max(1.0, b.abs().max().item()):
                raise AssertionError(f"{label} gradient {i}: max_abs_err {err}")
        del got, want
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        kernel_ms = dict.fromkeys(KERNELS, 0.0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                for frag in KERNELS:
                    if frag in e.key:
                        kernel_ms[frag] += e.self_device_time_total / 3e3
                        break
        out[label] = {"ms": ms, "kernel_ms": kernel_ms}
        del args, bargs, ctx, lse, delta, g, gout
        torch.cuda.empty_cache()
    print(json.dumps(out))


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
        for label, t in times.items():
            split = ", ".join(f"{k} {v:.4f}" for k, v in t["kernel_ms"].items() if v)
            print(f"{root}: {label} backward {t['ms']:.4f} ms ({split})", flush=True)
        runs.append({"checkout": root, "times": times})
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
