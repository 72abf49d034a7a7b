#!/usr/bin/env python3
"""Why K3's fp32 kernels (``csrc/flash_xl_attention_bwd.cu``: Q1 ds with no
position term and its bwd-kv instance) sum slices and chunks of their
products in accumulators of their own: the error of each variant against
an fp64 reference, on one NVIDIA card.

    python3 tools/probe_bwd_sums.py

It copies this checkout's ``viet_tts_torch/`` into
``build/probe_bwd_sums/<variant>/`` with the backward source changed, builds
each copy's backward library (nvcc, all at once), and runs each in a process
of its own:

- ``as built``: Q1's 32-wide slice sums of s and dp, bwd-kv's 32-row chunk
  sums;
- ``no kv chunk sums``: bwd-kv sums every row into one accumulator;
- ``no kv chunk sums, lo lo``: the same with a fourth product (lo lo) in
  each 3xTF32 term of bwd-kv;
- ``no Q1 slice sums``: Q1 sums all of D into one accumulator.

Inputs are ``chip_smoke.py`` phase 3's JETS decoder case (B=8, H=2, T=512,
D=128, fp32, attention dropout 0.2, ragged lengths with a full and a fully
padded row) and a grid past one wave (B=32, T=1008); lse and delta come
from the plain forward. For each it prints max |error| of dq, dk, dv
against an fp64 evaluation of the plain formulas and against the fp32
plain version (``attention_bwd_*_plain``, cuBLAS with TF32 off), bwd-kv
alone on the kernel's own scratches against fp64 products of those
scratches, and the CUDA-event ms of Q1 (with P) and of bwd-kv at (8, 512).
The card's name and power limit come first; the last line is a JSON object.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe_bwd_sums")
SOURCE = os.path.join("viet_tts_torch", "csrc", "flash_xl_attention_bwd.cu")

KV_SUMS = "  constexpr bool CHUNK_SUMS = SPLIT && SRC == kKvFromPlain;\n"
KV_MMA = ("        for (int mi = 0; mi < 2; ++mi) mma3<SPLIT>(sum[mi][ni], ah[mi], al[mi], bhi, "
          "blo);\n")
KV_MMA_LOLO = ("        for (int mi = 0; mi < 2; ++mi) {\n"
               "          if (SPLIT) mma_tf32(sum[mi][ni], al[mi], blo);\n"
               "          mma3<SPLIT>(sum[mi][ni], ah[mi], al[mi], bhi, blo);\n"
               "        }\n")
Q1_SLICES = "    q1_products<SPLIT, T, D, SPLIT>(s, dp, QC, GS, KS, VS, r0, lane);\n"
# (variant, [(text in the source, its replacement)])
VARIANTS = (
    ("as built", []),
    ("no kv chunk sums", [(KV_SUMS, KV_SUMS.replace("SPLIT && SRC == kKvFromPlain", "false"))]),
    ("no kv chunk sums, lo lo", [(KV_SUMS, KV_SUMS.replace("SPLIT && SRC == kKvFromPlain",
                                                            "false")),
                                 (KV_MMA, KV_MMA_LOLO)]),
    ("no Q1 slice sums", [(Q1_SLICES, Q1_SLICES.replace("D, SPLIT>", "D, false>"))]),
)
# (label, B, T)
CASES = (("JETS decoder (8, 512)", 8, 512), ("past one wave (32, 1008)", 32, 1008))


def _copy(name: str, edits) -> str:
    """A copy of the package under OUT/<name>, its backward source edited and
    its build limited to that source."""
    root = os.path.join(OUT, name.replace(" ", "_").replace(",", ""))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "viet_tts_torch"), os.path.join(root, "viet_tts_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old.strip()!r} once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def _backward_only() -> None:
    """Build and load only the backward source (the probe launches nothing
    else)."""
    from viet_tts_torch.runtime import kernels

    kernels.SIGNATURES = {"flash_xl_attention_bwd": kernels.SIGNATURES["flash_xl_attention_bwd"]}


def worker() -> None:
    """Errors and times of the working directory's package."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from viet_tts_torch.ops import flash_attention as fa

    _backward_only()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    H, D, p = 2, 128, 0.2
    scale = D ** -0.5
    out = {}
    for label, B, T in CASES:
        rng = np.random.RandomState(T + 7)
        lens = rng.randint(1, T + 1, B)
        lens[0], lens[-1] = T, 0  # a full row and a fully padded row
        pad = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        q, k, v, gout = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(dev)
                         for _ in range(4))
        seed = 1000003 * T + 2
        ctx, lse = fa.attention_fwd_plain(q, k, v, scale, pad, p, seed)
        delta, g = fa.backward_inputs(ctx, gout, torch.float32)
        args = (q, k, v, g, pad.float(), lse, delta, scale, p, seed)
        ops = fa._bwd_ops(*args[:7])
        dq, s, pm = fa._bwd_q1(*ops, scale, p, seed, True)
        dk, dv = fa._bwd_kv(ops[0], ops[3], s, pm)
        got = (dq, dk, dv)
        plain = (fa.attention_bwd_dq_plain(*args), *fa.attention_bwd_dkv_plain(*args))
        # the plain formulas (``_bwd_terms``) in fp64
        hm = lambda x: x.double().permute(0, 2, 1, 3)
        qh, kh, vh, gh = (hm(x) for x in (q, k, v, g))
        dead = pad[:, None, None, :]
        sc = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        pr = torch.exp(torch.where(dead, torch.full_like(sc, fa.MASK_NEG), sc)
                       - lse.double()[..., None])
        pr = torch.where(dead.all(dim=-1, keepdim=True),
                         torch.full_like(pr, 1.0 / fa.padded_time(T)), pr)
        del sc
        m = fa.dropout_keep_mask(seed, B, H, T, T, p, dev).double() / (1.0 - p)
        dpm = torch.einsum("bhqd,bhkd->bhqk", gh, vh) * m
        ds = torch.where(dead, torch.zeros_like(pr),
                         pr * (dpm - delta.double()[..., None]) * scale)
        del dpm
        ref = (torch.einsum("bhqk,bhkd->bqhd", ds, kh), torch.einsum("bhqk,bhqd->bkhd", ds, qh),
               torch.einsum("bhqk,bhqd->bkhd", pr * m, gh))
        del ds, pr, m
        # bwd-kv alone: the kernel against fp64 products of its own scratches
        kv_ref = (torch.einsum("bhqk,bhqd->bkhd", s[..., :T].double(), qh),
                  torch.einsum("bhqk,bhqd->bkhd", pm[..., :T].double(), gh))
        err = lambda a, b: (a.double() - b.double()).abs().max().item()
        rec = {n: {"vs_fp64": err(a, r), "vs_plain": err(a, pl), "plain_vs_fp64": err(pl, r),
                   "max_abs": r.abs().max().item()}
               for n, a, pl, r in zip(("dq", "dk", "dv"), got, plain, ref)}
        for n, a, r in zip(("dk", "dv"), (dk, dv), kv_ref):
            rec[f"{n}, bwd-kv alone"] = {"vs_fp64": err(a, r)}
        if T == 512:
            for name, fn in (("q1_with_p_ms", lambda: fa._bwd_q1(*ops, scale, p, seed, True)),
                             ("bwd_kv_ms", lambda: fa._bwd_kv(ops[0], ops[3], s, pm))):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(50):
                    fn()
                stop.record()
                torch.cuda.synchronize()
                rec[name] = start.elapsed_time(stop) / 50
        out[label] = rec
        del got, plain, ref, kv_ref, s, pm
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main() -> int:
    if sys.argv[1:] == ["--worker"]:
        worker()
        return 0
    if sys.argv[1:] == ["--build"]:
        sys.path.insert(0, os.getcwd())
        _backward_only()
        from viet_tts_torch.runtime import kernels

        kernels.build_all()
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    roots = {name: _copy(name, edits) for name, edits in VARIANTS}
    procs = {name: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build"],
                                    cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, root in roots.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: build failed\n{log}")
    results = {}
    for name, root in roots.items():
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"], cwd=root,
                             check=True, capture_output=True, text=True).stdout
        results[name] = json.loads(res.strip().splitlines()[-1])
        for label, rec in results[name].items():
            errs = ", ".join(f"{n} {r['vs_fp64']:.2e}" for n, r in rec.items()
                             if isinstance(r, dict))
            times = ", ".join(f"{k} {v:.4f}" for k, v in rec.items() if not isinstance(v, dict))
            print(f"{name} | {label}: max |err| vs fp64: {errs}"
                  + ("; vs the fp32 plain: " + ", ".join(
                      f"{n} {rec[n]['vs_plain']:.2e}" for n in ("dq", "dk", "dv")))
                  + (f"; {times}" if times else ""), flush=True)
    print(json.dumps({"device": smi, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
