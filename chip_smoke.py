#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout, on a CUDA machine
    python3 chip_smoke.py --profile  # and where the device time goes

Phases (any failure exits non-zero; no phase is caught):
 1. the card's name and power limit (``nvidia-smi``); the kernels are built
    from ``viet_tts_torch/csrc`` (nvcc, sm_90a);
 2. kernel K1 (flash attention forward) against its plain version at the
    inference shapes (B=16, H=2, D=128; encoder T=64, decoder T=1008, ragged
    lengths and one fully padded row), fp32 and bf16, with times;
 3. K1 with attention-weight dropout and K3 (its backward, the tensor-core
    backward template's instance with no position term: K3a, Q1 forming
    dq and the ds scratch; K3b, bwd-kv forming dk and dv on the ds and P
    scratches of a Q1) against their plain versions under one seed at the
    training shapes (B=8; T=64 and T=512, with times; the JETS trainer's
    other buckets, T=32 and T=256, checked only; ragged lengths, one fully
    padded row), fp32 and bf16, dropout 0 and 0.2: the whole backward, the
    standalone halves and bwd-kv alone on one Q1's scratches, with times
    (Q1 without and with P, bwd-kv alone, the whole backward, which SDPA's
    backward of all three gradients is held against);
 4. kernel K2 (fused MRF stage, tensor cores) against its plain version at
    the two fused HiFi-GAN stages (C=64 at T=128*1008, C=32 at T=256*1008,
    B=16), one case with seq_len < T, with times, its 3xTF32 bound beside
    the fp32 CUDA-core one and the bytes bound of its 9-launch design;
 5. the inference path: full-width JETS (config/model_config.yaml widths)
    with seeded random weights, saved as a port checkpoint, served by
    ``OneStageTTS(ckpt, fused_vocoder=True)``: 16 sentences in one call, once
    more with ``half=True``, then the HTTP server (``/health``, two
    ``/synthesize``, one ``/synthesize_stream``). The kernels' launch counts
    are zeroed before and read after this phase; a small input is checked
    against the same model on the CPU (plain PyTorch path);
 6. the training path: ``make_jets_train_step`` on full-width JETS and the
    full MSMPD discriminator (flash attention, every dropout as
    configured) with the bench.py batch (B=8, T_text=64, T_mel=512): two
    warm-up and five timed steps, launch counts zeroed before and read
    after them (10 of each of K1, K3a, K3b a step), finite metrics, both
    models changed; the MAS and forward-sum loops timed alone; one small
    full-width step on the card against the CPU;
 7. kernels K4 (xl3), K5 (xl2) and K6 (xl), the FS2 conformer's
    Transformer-XL attention, against their plain versions at the serving
    shapes (H=8, D=48, E=384: K4 at the encoder's text bucket and at
    T=512, K5 at (16, 1008), K6 at (4, 2048); ragged lengths with a fully
    padded row, and no pad mask), fp32 and bf16, with times, and
    ``scaled_dot_product_attention`` with the position term as its mask;
    K4 / K5 / K6 (tensor cores; K5's time includes its rotation pass)
    beside their tensor-core bound and the fp32, TF32 and bf16 figures;
 8. the two-stage path: full-width FastSpeech2-conformer (flash attention)
    and HiFi-GAN V1, seeded random weights, saved as two port checkpoints,
    served by ``TwoStageTTS(..., fused_vocoder=True)``: 16 sentences at
    1008 frames in fp32 and with ``half=True``, 4 sentences at
    ``max_mel_frames=2048``, then the HTTP server with ``--model_type
    FASTSPEECH2`` semantics (``/health``, two ``/synthesize``, one
    ``/synthesize_stream``). Launches are zeroed and asserted per call (K4 6
    and K5 6 at 1008 frames, K4 6 and K6 6 at 2048, K2 18); a small input
    on each attention route is checked against the CPU; the host median of
    5 fp32 calls and the acoustic / vocoder split;
 9. kernels K4 and K5 with attention-weight dropout and their backward (K4
    bwd; K5 bwd-q, bwd-kv) against their plain versions under one seed at
    the FS2 training shapes (B=8, H=8, D=48: K4 at T=64 and 512, K5 at
    1008 with E=384), fp32 and bf16, dropout 0 and 0.1, ragged lengths with
    a fully padded row and no pad mask, with times and SDPA's backward with
    the position term as its mask; K4 forward and bwd, K5 forward and bwd-q
    (tensor cores) also beside their TF32 and bf16 bounds, bwd-q beside a
    yardstick of the same function
    (``library_ms_pos_grad``: SDPA's backward with the mask's gradient,
    then the two masked products of that gradient with the table); the
    tensor-core bwd-kv timed alone on the scratches of one Q1 and held
    against its plain version there, beside Q1 without and with its second
    write and the whole backward (bwd-q and bwd-kv on shared scratches), in
    device time;
10. the FS2 training path: ``make_fs2_train_step`` on full-width
    FastSpeech2-conformer (flash attention, every dropout as configured,
    MAS durations, CVAE, Postnet) with the bench.py batch (B=8, T_text=64,
    beta-binomial prior) at T_mel 1008 (decoder on K5) and 512 (on K4): two
    warm-up and three timed steps each, launch counts zeroed before and read
    after them and held exactly (K4 fwd 6, K4 bwd 6, K5 fwd 6, bwd-q 6,
    bwd-kv 6 a step at 1008; K4 fwd 12, K4 bwd 12 at 512), finite losses;
    one bf16 mixed-precision step; one small full-width step on the card
    against the CPU;
11. kernel K7 (the JETS conformer's espnet "latest" rel-pos attention:
    forward, bwd-q, bwd-kv) against its plain versions (H=2, D=128,
    E=256): the forward at the serving shapes (16, text bucket) and
    (16, 1008), all three at the training shapes (8, 64) and (8, 512) with
    dropout 0 and 0.2; fp32 and bf16, ragged lengths with a fully padded
    row and no pad mask; with times and SDPA with the position term as its
    mask (and its backward); the forward (the tensor-core template's K7
    instance) and bwd-q (K7's instance of the K5 / K6 bwd-q kernels) with
    their tensor-core bounds, bwd-q beside the pos-grad yardstick (SDPA's
    backward with the mask's gradient, then its product with the table);
    K6's forward at D=128, E=256 (the legacy rel-pos route) at the serving
    shapes, with its tensor-core bound;
12. JETS-conformer serving: full-width JETS with espnet rel-pos conformer
    encoder and decoder (4 + 6 layers, conv kernels 7 / 31), seeded random
    weights, saved as a port checkpoint, served by ``OneStageTTS(ckpt,
    fused_vocoder=True)``: 16 sentences in fp32 and with ``half=True``,
    then the HTTP server (``/health``, one ``/synthesize``, one
    ``/synthesize_stream``); launches held per call (K7 fwd 10, K2 18); a
    small input against the CPU; the host median of 5 fp32 calls;
13. the JETS-conformer training step: ``make_jets_train_step`` with the
    full MSMPD on the bench.py batch (B=8, T_text=64, T_mel=512), two
    warm-up and three timed steps with the launches held exactly (K7 fwd,
    bwd-q and bwd-kv 10 each a step), finite metrics, both models changed,
    peak memory; one small full-width step on the card against the CPU;
14. kernel K6 with attention-weight dropout and its backward (bwd-q,
    bwd-kv) against their plain versions under one seed at the training
    shapes of the JETS legacy rel-pos conformer (B=8, H=2, D=128, E=256;
    T=64 and 512, dropout 0 and 0.2) and of the FS2 decoder past the xl2
    route (B=4, T=2048, H=8, D=48, E=384; dropout 0 and 0.1), fp32 and
    bf16, ragged lengths with a fully padded row and no pad mask, bwd-kv
    with the table's gradient; with times and SDPA (and its backward) with
    the position term as its mask; K6 forward, bwd-q and bwd-kv as K5's in
    phase 9;
15. JETS-conformer serving in the legacy rel-pos flavour
    (``conformer_rel_pos_type: legacy``, K6 at D=128): as phase 12, with
    the launches held per call (K6 fwd 10, K2 18, no K1 and no K7);
16. the legacy JETS-conformer training step: as phase 13 (every dropout
    as configured, attention 0.2 inside K6), the launches held exactly
    (K6 fwd, bwd-q and bwd-kv 10 each a step; no K1, K3 or K7); one small
    full-width step on the card against the CPU;
17. FS2 training past the xl2 route: ``make_fs2_train_step`` (the model
    of phase 10, every dropout as configured) at B=4, T_text=128,
    T_mel=2048: two warm-up and three timed steps with the launches held
    exactly (encoder on K4: fwd and bwd 6 a step; decoder on K6: fwd,
    bwd-q, bwd-kv 6 each), finite losses, the parameters changed; one
    full-width step at T_mel 1040 (decoder on K6) on the card against the
    CPU;
18. the FS2 trainer: ``python -m viet_tts_torch.train --task fastspeech2``'s
    entry function in-process, on a dataset it writes with the port's
    ``write_wav`` (2 speakers x 12 utterances at ~2 s and ~7.5 s: mel
    buckets 256, decoder on K4, and 768, on K5), full-width FastSpeech2
    (``attn_implementation: flash`` by a text edit of a copy of
    ``config/``, every dropout as configured), batch size 8, to
    ``--max_iter 6``, then resumed by scan to 8: the feature cache, the
    sidecars, keep-3 checkpoint names, the resumed iteration, finite
    losses and each step's K4 / K5 launches against its bucket; the first
    step on the card against the same trainer with ``--device cpu`` (a
    one-bucket dataset, every dropout 0) within rel 1e-3; ``TwoStageTTS``
    serving the trained output directory with phase 8's vocoder; feature
    cache seconds, step host seconds, data wait and peak memory;
19. the JETS trainer: ``--task jets`` the same way, on a dataset of 2
    speakers x 12 utterances at ~2 s and ~5.5 s (mel buckets 256 and 512),
    full-width JETS (``attn_implementation: flash`` by the config copy's
    edit, every dropout as configured, ``init_type: xavier_uniform``) and
    the full MSMPD, batch size 8, to ``--max_iter 6``, then resumed by
    scan to 8: the generator checkpoints' names, the discriminator file's
    iteration, the resumed iteration, each step's two rates against its
    epoch's, finite metrics, both models changed, K1, K3a and K3b 10 each
    a step; the first step on the card against ``--device cpu`` (a
    one-bucket dataset, every dropout 0): its metrics within rel 1e-3 and
    the gradients of every self-attention parameter (K1 and K3's; the key
    bias, whose gradient is 0 but for rounding, left out) within 1e-2 of
    each tensor's norm; the trainer sets TF32 off on the card
    (the phase turns it on before); ``OneStageTTS``
    serving the output directory (K1 10 and K2 18 a call); step host
    seconds by mel bucket, data wait, histogram seconds, peak memory;
20. the HiFi-GAN trainer: ``--task hifigan`` on phase 18's dataset and
    feature cache, full-width HiFi-GAN V1 and the default MSMPD, 64-frame
    segments, batch size 8, to ``--max_iter 6``, then resumed to 8: as
    phase 19's checks, with no K2 launch in a step; the first step on the
    card against the CPU within rel 1e-3; ``TwoStageTTS`` serving phase
    18's FastSpeech2 output with this phase's output as its vocoder (K2 18
    a call);
21. with ``--profile`` only: five timed fp32 calls of 16 sentences, five
    JETS training steps, five two-stage calls, five FS2 training steps at
    T_mel 1008 and five at 512 and five of each JETS-conformer path (both
    flavours), of the FS2 step at T_mel 2048 and of the JETS and HiFi-GAN
    trainers' steps (on one of their batches), one of each under
    ``torch.profiler``, device time by kernel group (bwd-q as its Q1 and
    Q2 kernels, bwd-kv on its own, K5's rotation pass on its own, K7's
    forward and bwd-q instances apart from K6's, K4's bwd-kv instance under
    K4 bwd);
22. one JSON line ``{"kernels": [...]}``, then the card's line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Phases 3, 9, 11 and 14 run after phase 20 (in that order): their
``torch.profiler`` sessions leave every later kernel launch ~25 % dearer on
the host, and the other phases read host seconds of launch-bound calls and
steps. Each phase logs its host seconds (``phase time:``): the script has
a time limit. Times are CUDA-event times over repeated
launches after a warm-up, except on the backward rows (K3a/b, K4 bwd, K5 /
K6 / K7 bwd-q and bwd-kv): there the kernel, SDPA's backward and the
pos-grad yardstick are timed in device time (``device_ms``: the sum of
the kernels' time under ``torch.profiler``; an autograd backward leaves
host gaps between its launches that CUDA events count), with the
CUDA-event figures beside them. bound_ms
is the larger of bytes / 3.35 TB/s and operations / the card's peak for the
work's type (fp32 work at the 67 TFLOP/s CUDA-core rate, bf16 at 989), per
the H100 SXM data sheet. Every attention kernel runs on the tensor cores
(K1, K4 / K5 / K6 / K7 forward, K3, K4 bwd, K5 / K6 / K7 bwd-q and
bwd-kv) and takes the bound of the work it does on the tensor cores,
counted from the function (the pairs of the live keys;
not the band products' padding or the tiles a kernel walks): fp32
streams under 3xTF32 run three TF32 products a term, so 3 * operations /
495 TFLOP/s, bf16 streams one, operations / 495; they also report the
CUDA-core (67), one-TF32-product (495) and bf16 (989) figures beside it.
bwd-kv's own work is bwd-q's two scratches read once and two D-wide
products a pair (bound by those bytes); the bound of the function it
computes from the streams (4D + E a pair; K3b's 4D) stands beside it.
The card's power limit is printed beside them.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
import urllib.request
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
SEED = 1234

HBM_BYTES_PER_MS = 3.35e12 / 1e3
FP32_FLOP_PER_MS = 67e12 / 1e3  # CUDA cores
TF32_FLOP_PER_MS = 495e12 / 1e3  # dense tensor cores
BF16_FLOP_PER_MS = 989e12 / 1e3  # dense tensor cores

SENTENCES = [
    "Hôm nay trời đẹp quá!",
    "Người Việt Nam rất hiếu khách và thân thiện.",
    "Chúng tôi đã đi Hà Nội vào năm hai nghìn không trăm hai mươi ba.",
    "Thành phố Hồ Chí Minh là trung tâm kinh tế lớn nhất cả nước.",
    "Tôi yêu tiếng Việt.",
    "Cô ấy đang đọc báo buổi sáng.",
    "Mẹ nấu cơm rất ngon.",
    "Xin chào các bạn.",
    "Học sinh đến trường từ sáng sớm.",
    "Dòng sông chảy qua làng quê yên bình.",
    "Bố tôi làm việc ở bệnh viện.",
    "Chợ Bến Thành rất đông khách du lịch.",
    "Cánh đồng lúa chín vàng óng ả.",
    "Bạn có khỏe không?",
    "Cà phê sữa đá là thức uống quen thuộc.",
    "Tàu hỏa chạy từ Bắc vào Nam.",
]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int, warmup: int = 2, tries: int = 6):
    """Mean device milliseconds of ``fn()``: the kernels' (and copies')
    device time under ``torch.profiler`` summed over ``iters`` calls, so
    that host gaps between the launches of a call (an autograd backward
    launches many) do not count. A session's records can arrive late and
    land in the next session (on the H100 machine, after dozens of
    sessions in one process, a session has lost records that the next one
    gained, and one came back empty), so a figure counts only when two
    consecutive sessions agree: the same number of kernel records (every
    call launches the same kernels) and device times within 3 %. None when
    no two of ``tries`` sessions agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    prev = None
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n, us = 0, 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                n += e.count
                us += e.self_device_time_total
        ms = us / iters / 1e3
        if prev is not None and n > 0 and n == prev[0] and abs(ms - prev[1]) <= 0.03 * max(
                ms, prev[1]):
            return (ms + prev[1]) / 2
        prev = (n, ms)
    return None


DEVICE_MS_MISSES = []  # the backward rows timed by CUDA events instead


def bwd_ms(fn, iters: int, what: str = "a backward row"):
    """A backward row's time: (device ms, CUDA-event ms) of ``fn()``. Where
    the profiler gives no device time (``device_ms``) the CUDA-event figure
    stands in for both, and the row is listed in DEVICE_MS_MISSES (the
    kernels line says so)."""
    ev = cuda_ms(fn, iters)
    dev = device_ms(fn, iters)
    if dev is None:
        DEVICE_MS_MISSES.append(what)
        log(f"  device_ms: no two torch.profiler sessions agreed on {what}; its CUDA-event "
            f"figure {ev:.4f} ms stands in")
        return ev, ev
    return dev, ev


def _events_note(k_ev, l_ev) -> str:
    """The log's note of a backward row's CUDA-event figures (none for a
    forward row)."""
    if l_ev is None:
        return ""
    return f" (device time; CUDA events: kernel {k_ev:.4f}, library {l_ev:.4f})"


def phase_timed(label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, logging its host seconds: the script has a time
    limit, and this says which phase spends it."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase time: {label} {time.perf_counter() - t0:.1f} s")
    return out


def bound(nbytes: float, flops: float, flop_per_ms: float = FP32_FLOP_PER_MS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, flops / flop_per_ms
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------------------
# phase 2: K1
# --------------------------------------------------------------------------


def check_flash_attention(dev):
    from viet_tts_torch.ops import flash_attention as fa

    B, H, D = 16, 2, 128
    scale = D ** -0.5
    per_call = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                "bound_ms_fp32": 0.0}
    per_shape = {}
    max_err = 0.0
    kinds = set()
    # per OneStageTTS.__call__ of 16 sentences: 4 encoder layers at the
    # T=64 text bucket, 6 decoder layers at T=1008 frames
    for T, n_layers in ((64, 4), (1008, 6)):
        rng = np.random.RandomState(T)
        lens = rng.randint(1, T + 1, B)
        lens[0], lens[-1] = T, 0  # one full row, one fully padded row
        pad = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        base = [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(dev)
                for _ in range(3)]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (x.to(dtype) for x in base)
            ctx, lse = fa.attention_fwd(q, k, v, scale, pad)
            ref, ref_lse = fa.attention_fwd_plain(q, k, v, scale, pad)
            torch.cuda.synchronize()
            err = (ctx - ref).abs().max().item()
            lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
            name = f"K1 flash_attention T={T} {str(dtype)[6:]}"
            if not (torch.isfinite(ctx).all() and err <= tol and lse_err <= 1e-5):
                raise AssertionError(f"{name}: max_abs_err {err} (tol {tol}), "
                                     f"lse rel err {lse_err}")
            iters = 50 if T == 64 else 20
            k_ms = cuda_ms(lambda: fa.attention_fwd(q, k, v, scale, pad), iters)
            p_ms = cuda_ms(lambda: fa.attention_fwd_plain(q, k, v, scale, pad), iters)
            tp = fa.padded_time(T)
            qh, kh, vh = (F.pad(x, (0, 0, 0, 0, 0, tp - T)).permute(0, 2, 1, 3)
                          for x in (q, k, v))
            padp = F.pad(pad.float(), (0, tp - T), value=1.0)
            mask = (padp * fa.MASK_NEG)[:, None, None, :].to(q.dtype)
            l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=scale), iters)
            flops = _attn_flops(2, H, D, T, lens)
            # q, k, v in their dtype; ctx, lse and pad in fp32
            nbytes = (3 * q.element_size() * B * T * H * D
                      + 4.0 * (B * T * H * D + B * H * T + B * T))
            b32, _ = bound(nbytes, flops, FP32_FLOP_PER_MS
                           if dtype == torch.float32 else BF16_FLOP_PER_MS)
            b_ms, kind = _tensor_core_bound(nbytes, flops, dtype)
            log(f"{name}: max_abs_err {err:.3e} (tol {tol}) kernel_ms {k_ms:.4f} "
                f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms {b_ms:.4f} "
                f"({kind}) x{n_layers} per call")
            if dtype != torch.float32:  # the kernel line reports the fp32 call
                continue
            tc = _tensor_core_figures(f"flash_attention_fwd (B={B}, T={T})", k_ms, b_ms,
                                      nbytes, flops)
            per_shape[f"({B}, {T})"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                            bound_ms=b_ms, bound_by=kind, **tc)
            max_err = max(max_err, err)
            kinds.add(kind)
            for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                             ("bound_ms", b_ms), ("bound_ms_fp32", b32)):
                per_call[key] += n_layers * val
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "viet_tts_torch/csrc/flash_xl_attention.cu",
        "replaces": "viet_tts_tpu/ops/pallas_attention.py:1832",
        "max_abs_err": max_err,
        "tol": 1e-4,
        "bound_by": "operations" if "operations" in kinds else "bytes",
        "per": "one OneStageTTS.__call__ of 16 sentences, fp32 (4 calls at "
               "(16, 64) + 6 at (16, 1008), H=2, D=128)",
        "per_shape": per_shape,
        **per_call,
    }


# --------------------------------------------------------------------------
# phase 3: K1 with dropout and K3 at the training shapes
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL = 8, 64, 512  # bench.py:56-60
# the JETS trainer phase's text and mel buckets that the shapes above miss
TRAINER_ONLY_T = (32, 256)
ATTN_DROPOUT = 0.2  # config/model_config.yaml: transformer_*_attn_dropout_rate
# a backward row's CUDA-event figures, kept beside its device-time ms and
# library_ms
EVENT_KEYS = ("ms_cuda_events", "library_ms_cuda_events")
BWD_TIMING = ("ms and library_ms are device time (device_ms: the kernels' time under "
              "torch.profiler); the CUDA-event figures of the same calls beside them")


def _attn_flops(n_matmuls: int, H: int, D: int, T: int, lens) -> float:
    """FLOP of ``n_matmuls`` (T, D) x (D, L) products per head and batch
    row over the row's live keys L: keys at padding need no work (their
    weights are 0 and their gradients are not used), so this is what the
    data needs, not the T x Tp the kernels loop over."""
    return 2.0 * n_matmuls * H * D * T * float(np.sum(lens))


def _library_attention(q, k, v, g, pad, scale, dropout_p):
    """``F.scaled_dot_product_attention`` on the JAX wrapper's padded
    (B, H, Tp, D) layout with the same additive mask: (forward call, its
    backward through autograd on a retained graph). A yardstick only."""
    from viet_tts_torch.ops import flash_attention as fa

    T = q.shape[1]
    tp = fa.padded_time(T)
    qh, kh, vh, gh = (F.pad(x, (0, 0, 0, 0, 0, tp - T)).permute(0, 2, 1, 3).contiguous()
                      for x in (q, k, v, g))
    padp = F.pad(pad.float(), (0, tp - T), value=1.0)
    mask = (padp * fa.MASK_NEG)[:, None, None, :].to(q.dtype)
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                         dropout_p=dropout_p, scale=scale)

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              dropout_p=dropout_p, scale=scale)

    def bwd():
        return torch.autograd.grad(out, leaves, gh, retain_graph=True)

    return fwd, bwd


def _k3_work(B: int, H: int, D: int, T: int, lens, esz: int):
    """(bytes, FLOP) of K3's functions at these inputs: every input read
    once in its dtype (q, k, v, the cotangent g; pad, lse and delta in
    fp32), every output written once in fp32; the D-wide products over the
    live keys of each row only. ``bwd_q``: dq (s, dp, dq: 3 products a
    pair); ``bwd_kv_function``: dk and dv from the streams (s, dp, dk, dv:
    4); ``whole``: all three (5, where the CUDA-core pair did 7);
    ``bwd_kv``: the bwd-kv kernel's own work on Q1's two fp32 scratches (p m
    / keep and ds over the T x T pairs) with q and g (dk, dv: 2)."""
    row, stat = B * T * H * D, B * H * T
    ins = 4 * esz * row + 4.0 * (2 * stat + B * T)
    return {"bwd_q": (ins + 4.0 * row, _attn_flops(3, H, D, T, lens)),
            "bwd_kv_function": (ins + 4.0 * 2 * row, _attn_flops(4, H, D, T, lens)),
            "whole": (ins + 4.0 * 3 * row, _attn_flops(5, H, D, T, lens)),
            "bwd_kv": (2.0 * esz * row + 8.0 * B * H * T * T + 4.0 * 2 * row,
                       _attn_flops(2, H, D, T, lens))}


def check_flash_training(dev):
    """K1 with dropout and K3 (the backward template's instance with no
    position term: K3a, Q1 forming dq and the ds scratch; K3b, bwd-kv on the
    ds and P scratches of a Q1) against their plain versions under one seed,
    at the training shapes (B=8, H=2, D=128; encoder T=64, decoder T=512;
    the JETS trainer's other text and mel buckets, T=32 and T=256, are
    checked and not timed; ragged lengths and a fully padded row), fp32
    and bf16, dropout 0 and
    0.2: the whole backward (``attention_bwd``), the standalone halves and
    bwd-kv alone on one Q1's scratches (against ``xl_bwd_kv_plain``), with
    times. Returns the per-step figures (fp32, dropout 0.2: 4 encoder + 6
    decoder layers a step): K3a, Q1 without P; K3b, bwd-kv alone on the
    scratches, beside Q1 with P and the whole backward, which SDPA's
    backward (all three gradients) is held against."""
    from viet_tts_torch.ops import flash_attention as fa

    B, H, D = TRAIN_B, 2, 128
    scale = D ** -0.5
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_fp32")
    step = {name: dict.fromkeys(keys, 0.0) for name in ("fwd", "bwd_q", "bwd_kv", "whole")}
    step["fwd"]["per_shape"] = {}
    err = {name: 0.0 for name in step}
    kinds = {name: set() for name in step}
    # n_layers 0: a shape the JETS trainer gives K1 and K3, checked only
    for T, n_layers in ((TRAIN_T_TEXT, 4), (TRAIN_T_MEL, 6),
                        *((T, 0) for T in TRAINER_ONLY_T)):
        rng = np.random.RandomState(T + 7)
        lens = rng.randint(1, T + 1, B)
        lens[0], lens[-1] = T, 0  # one full row, one fully padded row
        pad = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        padf = pad.float()
        base = [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(dev)
                for _ in range(4)]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            peak = FP32_FLOP_PER_MS if dtype == torch.float32 else BF16_FLOP_PER_MS
            q, k, v = (x.to(dtype) for x in base[:3])
            g = base[3]  # the cotangent of ctx is fp32, as autograd hands it over
            esz = q.element_size()
            work = _k3_work(B, H, D, T, lens, esz)
            for p in (0.0, ATTN_DROPOUT):
                seed = 1000003 * T + int(p * 10)
                ctx, lse = fa.attention_fwd(q, k, v, scale, pad, p, seed)
                ref, ref_lse = fa.attention_fwd_plain(q, k, v, scale, pad, p, seed)
                delta, gs = fa.backward_inputs(ctx, g, dtype)
                args = (q, k, v, gs, padf, lse, delta, scale, p, seed)
                whole_args = (q, k, v, padf, ctx, lse, g, seed, scale, p)
                got = {"whole": fa.attention_bwd(*whole_args),
                       "halves": (fa.attention_bwd_dq(*args), *fa.attention_bwd_dkv(*args))}
                want = (fa.attention_bwd_dq_plain(*args), *fa.attention_bwd_dkv_plain(*args))
                torch.cuda.synchronize()
                errs = {"ctx": (ctx - ref).abs().max().item()}
                for how, grads in got.items():
                    for gname, a, b in zip(("dq", "dk", "dv"), grads, want):
                        errs[f"{gname} ({how})"] = (a - b).abs().max().item()
                lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                name = f"T={T} {str(dtype)[6:]} dropout={p}"
                finite = all(torch.isfinite(x).all() for x in (ctx, *got["whole"], *got["halves"]))
                if not (finite and max(errs.values()) <= tol and lse_err <= 1e-5):
                    raise AssertionError(f"K1/K3 {name}: max_abs_err {errs} (tol {tol}), "
                                         f"lse rel err {lse_err}")
                del got, want
                # bwd-kv alone on the scratches of one Q1, held against its
                # plain version there (within tol, scaled where it passes 1)
                stages = _bwd_kv_stages("plain", args, tol,
                                        whole=lambda: fa.attention_bwd(*whole_args))
                errs["dk, dv (bwd-kv alone)"] = stages["err"][0]
                if not n_layers:
                    log(f"K1/K3 {name}: max_abs_err "
                        f"{', '.join(f'{n} {e:.3e}' for n, e in errs.items())} (tol {tol}); "
                        f"a JETS trainer bucket, checked only")
                    del stages
                    continue
                iters = 50 if T == TRAIN_T_TEXT else 20
                lib_fwd, lib_bwd = _library_attention(q, k, v, g, pad, scale, p)
                # the backward rows in device time, their library call too
                # (an autograd backward: host gaps between its launches)
                l_bwd = bwd_ms(lib_bwd, iters, f"SDPA backward {name}")
                k_dq = bwd_ms(lambda: fa.attention_bwd_dq(*args), iters, f"K3a {name}")
                k_kv = bwd_ms(stages["kernel"], iters, f"K3b bwd-kv alone {name}")
                k_whole = bwd_ms(stages["whole"], iters, f"K3 whole {name}")
                # K1 runs on the tensor cores: the bound of that work
                fwd_work = (3 * esz * B * T * H * D + 4.0 * (B * T * H * D + B * H * T + B * T),
                            _attn_flops(2, H, D, T, lens))
                times = {
                    "fwd": (cuda_ms(lambda: fa.attention_fwd(q, k, v, scale, pad, p, seed), iters),
                            cuda_ms(lambda: fa.attention_fwd_plain(q, k, v, scale, pad, p, seed),
                                    iters),
                            cuda_ms(lib_fwd, iters), fwd_work, errs["ctx"], None),
                    "bwd_q": (k_dq[0], cuda_ms(lambda: fa.attention_bwd_dq_plain(*args), iters),
                              l_bwd[0], work["bwd_q"],
                              max(errs["dq (whole)"], errs["dq (halves)"]), (k_dq[1], l_bwd[1])),
                    "bwd_kv": (k_kv[0], cuda_ms(stages["plain"], iters), l_bwd[0], work["bwd_kv"],
                               max(e for n, e in errs.items() if n[:2] in ("dk", "dv")),
                               (k_kv[1], l_bwd[1])),
                    "whole": (k_whole[0],
                              cuda_ms(lambda: fa.attention_bwd_plain(*whole_args), iters),
                              l_bwd[0], work["whole"], max(e for n, e in errs.items()
                                                           if n != "ctx"), (k_whole[1], l_bwd[1])),
                }
                log(f"K1/K3 {name}: max_abs_err {', '.join(f'{n} {e:.3e}' for n, e in errs.items())}"
                    f" (tol {tol}); x{n_layers} a step")
                for kern, (k_ms, p_ms, l_ms, (nbytes, flops), e, events) in times.items():
                    ev = "" if events is None else _events_note(*events)
                    b_ms, kind = _tensor_core_bound(nbytes, flops, dtype)
                    b32, _ = bound(nbytes, flops, peak)
                    log(f"  {kern}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                        f"library_ms {l_ms:.4f} bound_ms {b_ms:.4f} ({kind}; CUDA cores "
                        f"{b32:.4f}) max_abs_err {e:.3e}{ev}")
                    if kern == "whole":
                        log(f"  whole K3 backward against SDPA's backward (dq, dk, dv): "
                            f"{k_ms / l_ms:.3f}x its time")
                    if dtype != torch.float32 or p != ATTN_DROPOUT:
                        continue  # the kernel line reports fp32 with dropout
                    err[kern] = max(err[kern], e)
                    kinds[kern].add(kind)
                    for key, val in zip(keys, (k_ms, p_ms, l_ms, b_ms, b32)):
                        step[kern][key] += n_layers * val
                    tc = _tensor_core_figures(f"K3 {kern} (B={B}, T={T}) dropout {p}", k_ms, b_ms,
                                              nbytes, flops)
                    if kern == "fwd":
                        step[kern]["per_shape"][f"({B}, {T}) training"] = dict(
                            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                            bound_by=kind, **tc)
                    if kern == "bwd_kv":
                        fig = _bwd_kv_figures(f"K3 bwd-kv (B={B}, T={T})", stages,
                                              work["bwd_kv_function"], iters)
                        for key in ("q1_ms", "q1_with_p_ms", "q1_ms_cuda_events",
                                    "q1_with_p_ms_cuda_events", "bound_ms_function",
                                    "bound_ms_function_3xtf32"):
                            step[kern][key] = step[kern].get(key, 0.0) + n_layers * fig[key]
                    if events is not None:
                        for key, val in zip(EVENT_KEYS, events):
                            step[kern][key] = step[kern].get(key, 0.0) + n_layers * val
                del stages
    for kern in step:
        step[kern]["max_abs_err"] = err[kern]
        step[kern]["bound_by"] = "operations" if "operations" in kinds[kern] else "bytes"
    log(f"K3 a step (fp32, dropout {ATTN_DROPOUT}): whole backward {step['whole']['ms']:.4f} ms "
        f"(Q1 with P {step['bwd_kv']['q1_with_p_ms']:.4f} + bwd-kv {step['bwd_kv']['ms']:.4f}); "
        f"K3a alone {step['bwd_q']['ms']:.4f}; SDPA's backward {step['whole']['library_ms']:.4f} "
        f"({step['whole']['ms'] / step['whole']['library_ms']:.3f}x); bound "
        f"{step['whole']['bound_ms']:.4f} (3xTF32), {step['whole']['bound_ms_fp32']:.4f} "
        f"(fp32 CUDA cores)")
    return step


def k3_entries(step):
    per = (f"one training step, fp32, attention dropout {ATTN_DROPOUT} (4 calls at "
           f"({TRAIN_B}, {TRAIN_T_TEXT}) + 6 at ({TRAIN_B}, {TRAIN_T_MEL}), H=2, D=128)")
    library = ("F.scaled_dot_product_attention backward (dq, dk and dv together) on "
               "a retained graph")
    source = "viet_tts_torch/csrc/flash_xl_attention_bwd.cu"
    # the whole backward (Q1 with P, then bwd-kv), which SDPA's backward
    # computes too
    whole = {k: v for k, v in step["whole"].items() if k != "bound_by"}
    return [
        {"name": "flash_attention_bwd_q", "route": "cuda", "source": source,
         "instance": "xl2_bwd_q1_ds_kernel<T, D, false, 3> (Q1 without P)",
         "replaces": "viet_tts_tpu/ops/pallas_attention.py:627",
         "tol": 1e-4, "per": per, "library": library, "timing": BWD_TIMING,
         "whole_backward": whole, **step["bwd_q"]},
        {"name": "flash_attention_bwd_kv", "route": "cuda", "source": source,
         "instance": ("xl2_bwd_kv_kernel<T, D, 2> (chunk sums) alone on the scratches of "
                      "xl2_bwd_q1_ds_kernel<T, D, true, 3> (q1_with_p_ms)"),
         "replaces": "viet_tts_tpu/ops/pallas_attention.py:656",
         "tol": 1e-4, "per": per, "library": library, "timing": BWD_TIMING,
         "whole_backward": whole, **step["bwd_kv"]},
    ]


# --------------------------------------------------------------------------
# phase 4: K2
# --------------------------------------------------------------------------

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
# K2 launches a serving call: one a (block, dilation) pair, 9 a fused stage,
# two fused stages (C = 64 and 32) in HiFi-GAN V1
K2_PER_CALL = 2 * sum(len(d) for d in DILS)


def _mrf_library(x, ws):
    """The same stage as one chain of F.conv1d calls (no sequence mask)."""
    w1s, b1s, w2s, b2s = ws
    h0 = x.transpose(1, 2)
    acc = 0.0
    for blk, (k, dils) in enumerate(zip(KS, DILS)):
        h = h0
        for di, d in enumerate(dils):
            y = F.conv1d(F.leaky_relu(h, 0.1), w1s[blk][di].permute(2, 1, 0),
                         b1s[blk][di], padding=(k - 1) // 2 * d, dilation=d)
            h = h + F.conv1d(F.leaky_relu(y, 0.1), w2s[blk][di].permute(2, 1, 0),
                             b2s[blk][di], padding=(k - 1) // 2)
        acc = acc + h
    return (acc / len(KS)).transpose(1, 2)


def fused_stage_shapes():
    """(C, upsampling so far) of each full-width HiFi-GAN stage that takes
    K2, by the generator's own rule (built on the meta device)."""
    from viet_tts_torch.config import jets_generator_params
    from viet_tts_torch.models.hifigan.generator import HiFiGANGenerator

    hp = jets_generator_params()
    scales = hp["generator_upsample_scales"]
    with torch.device("meta"):
        gen = HiFiGANGenerator(
            in_channels=hp["adim"], channels=hp["generator_channels"],
            upsample_scales=scales,
            upsample_kernel_sizes=hp["generator_upsample_kernel_sizes"],
            resblock_kernel_sizes=hp["generator_resblock_kernel_sizes"],
            resblock_dilations=hp["generator_resblock_dilations"])
    shapes, up = [], 1
    for i, s in enumerate(scales):
        up *= s
        ch = hp["generator_channels"] // 2 ** (i + 1)
        if gen._fused_stage_fits(ch):
            shapes.append((ch, up))
    return shapes


def _mrf_fused_bytes(B: int, T: int, C: int) -> float:
    """Device-memory bytes K2's pair launches must move at least: each
    block's window of its pair's input (its S output rows and the halo of
    both convs), one (B, T, C) write a pair and the running mean's reads;
    the residual rows are the ones the block's window just read, and are not
    counted again."""
    from viet_tts_torch.ops import fused_mrf as fm

    total = 0.0
    for blk, (k, dils) in enumerate(zip(KS, DILS)):
        S = fm.tile_rows(C) - 2 * ((k - 1) // 2)
        for di, d in enumerate(dils):
            window = S + 2 * ((k - 1) // 2 * (d + 1))
            total += 4.0 * B * T * C * (window / S + 1)
            if di == len(dils) - 1 and blk > 0:
                total += 4.0 * B * T * C
    return total


def check_fused_mrf(dev, frames: int):
    from viet_tts_torch.ops import fused_mrf as fm

    B = 16
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_fp32", "bound_ms_bytes_fused")
    per_call = dict.fromkeys(keys, 0.0)
    per_shape = {}
    max_err, tol = 0.0, 1e-4
    shapes = fused_stage_shapes()
    for C, up in shapes:
        T = up * frames
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
        cases = [T] + ([T - 37 * up - 5] if C == 32 else [])
        for seq_len in cases:
            got = fm.fused_mrf_stage(x, seq_len, *ws)
            want = fm.fused_mrf_stage_plain(x, seq_len, *ws)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tail = got[:, seq_len:].abs().max().item() if seq_len < T else 0.0
            name = f"K2 fused_mrf C={C} T={T} seq_len={seq_len}"
            if not (torch.isfinite(got).all() and err <= tol and tail == 0.0):
                raise AssertionError(f"{name}: max_abs_err {err} (tol {tol}), "
                                     f"max past seq_len {tail}")
            max_err = max(max_err, err)
            log(f"{name}: max_abs_err {err:.3e} (tol {tol})")
            del got, want
        k_ms = cuda_ms(lambda: fm.fused_mrf_stage(x, T, *ws), 3, warmup=1)
        p_ms = cuda_ms(lambda: fm.fused_mrf_stage_plain(x, T, *ws), 3, warmup=1)
        l_ms = cuda_ms(lambda: _mrf_library(x, ws), 3, warmup=1)
        flops = fm.stage_flops(B, T, C, KS, DILS)
        nbytes = 4.0 * (2 * B * T * C + sum(w.numel() for g in ws for w in g))
        b_ms, kind = _tensor_core_bound(nbytes, flops, torch.float32)
        fused_ms = _mrf_fused_bytes(B, T, C) / HBM_BYTES_PER_MS
        log(f"K2 fused_mrf C={C} T={T}: kernel_ms {k_ms:.3f} plain_ms {p_ms:.3f} "
            f"library_ms {l_ms:.3f} bound_ms {b_ms:.3f} ({kind}, 3xTF32) "
            f"bound_ms_bytes_fused {fused_ms:.3f} {flops / k_ms / 1e9:.2f} TFLOP/s")
        tc = _tensor_core_figures(f"fused_mrf_stage (B={B}, T={T}, C={C})", k_ms, b_ms,
                                  nbytes, flops)
        per_shape[f"C={C} ({B}, {T})"] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=kind,
            bound_ms_bytes_fused=fused_ms, **tc)
        for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                         ("bound_ms", b_ms), ("bound_ms_fp32", tc["bound_ms_fp32"]),
                         ("bound_ms_bytes_fused", fused_ms)):
            per_call[key] += val
        del x, ws
        torch.cuda.empty_cache()
    return {
        "name": "fused_mrf_stage",
        "route": "cuda",
        "source": "viet_tts_torch/csrc/fused_mrf.cu",
        "replaces": "viet_tts_tpu/ops/pallas_vocoder.py:137",
        "max_abs_err": max_err,
        "tol": tol,
        "bound_by": "operations",
        "per": "one OneStageTTS.__call__ of 16 sentences, fp32 (stages "
               + " and ".join(f"C={C} at T={up}*{frames}" for C, up in shapes)
               + f", {K2_PER_CALL // len(shapes)} launches each)",
        "per_shape": per_shape,
        "redesigned": (
            "tensor cores (mma.sync m16n8k8, 3xTF32): one launch a (block, dilation) pair, "
            "conv1 and conv2 as implicit GEMMs on a shared-memory window, conv1's output "
            "tile kept in shared memory, weights split into TF32 hi / lo once and packed in "
            "fragment order, streamed a tap at a time through a two-stage cp.async ring"
            + TC_BOUND_NOTE + "; bound_ms_bytes_fused the device-memory bytes of the "
            "9-launch design (each block's window with its halo, one write a pair, the "
            "running mean's reads) at 3.35 TB/s"),
        **per_call,
    }


# --------------------------------------------------------------------------
# phase 5: the inference path
# --------------------------------------------------------------------------


def build_checkpoint(ckpt_dir: str) -> str:
    from viet_tts_torch.infer.api import default_conf, save_checkpoint
    from viet_tts_torch.models.jets import JETS
    from viet_tts_torch.nn.utils import seeded_init_
    from viet_tts_torch.text import NUM_SYMBOLS

    conf = default_conf()
    conf["models"]["jets"]["generator_params"]["attn_implementation"] = "flash"
    hp = conf["models"]["jets"]["generator_params"]
    model = JETS(NUM_SYMBOLS, conf["audio"]["mel"]["channels"], hp)
    seeded_init_(model, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # unit-norm transposed convs keep the random vocoder's output at
        # audio scale (the JAX init's g = ||v|| shrinks it to ~1e-5)
        for up in model.generator.upsamples:
            up[1].weight_g.fill_(1.0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"JETS full width: {n_params} parameters, hp adim={hp['adim']} "
        f"heads={hp['aheads']} enc={hp['elayers']} dec={hp['dlayers']} "
        f"vocoder={hp['generator_channels']}")
    save_checkpoint(ckpt_dir, model, conf)
    return ckpt_dir


def post(url: str, payload: dict):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def check_main_path(dev, ckpt_dir: str):
    from viet_tts_torch.infer.api import OneStageTTS
    from viet_tts_torch.infer.server import serve
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import fused_mrf as fm

    tts = OneStageTTS(ckpt_dir, fused_vocoder=True)
    tts_half = OneStageTTS(ckpt_dir, fused_vocoder=True, half=True)
    for model in (tts, tts_half):  # warm-up: cuDNN autotune, allocator
        model(SENTENCES[:2])
    torch.cuda.synchronize()

    fa.attention_fwd.launches = 0
    fm.fused_mrf_stage.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    waves = tts(SENTENCES)
    call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    waves_half = tts_half(SENTENCES)
    half_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    httpd = serve(tts, port=0, model_name="JETS")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            codes = [r.status]
            health = json.load(r)
        for text in SENTENCES[2:4]:
            code, body = post(f"{base}/synthesize", {"text": text})
            codes.append(code)
            if body[:4] != b"RIFF":
                raise AssertionError("/synthesize did not return a WAV")
        t0 = time.perf_counter()
        code, stream_body = post(f"{base}/synthesize_stream", {"text": SENTENCES[4]})
        stream_s = time.perf_counter() - t0
        codes.append(code)
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = {"flash_attention_fwd": fa.attention_fwd.launches,
                "fused_mrf_stage": fm.fused_mrf_stage.launches}

    samples = sum(w.size for w in waves)
    for name, ws in (("fp32", waves), ("bf16", waves_half)):
        if len(ws) != len(SENTENCES) or not all(np.isfinite(w).all() for w in ws):
            raise AssertionError(f"{name} waveforms not finite / wrong count")
        if not all(w.size % 256 == 0 for w in ws):
            raise AssertionError(f"{name} waveform lengths not whole frames")
    if codes != [200] * 4 or health.get("status") != "ok":
        raise AssertionError(f"HTTP codes {codes}, health {health}")
    if len(stream_body) % 2 or not stream_body:
        raise AssertionError("/synthesize_stream returned no PCM")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    log(f"main path: __call__(16) fp32 {call_s:.3f} s, bf16 {half_s:.3f} s, "
        f"{samples} samples ({samples / tts.sr:.1f} s of audio) in the fp32 call, "
        f"peak {peak_gb:.2f} GB; /synthesize_stream {stream_s:.3f} s, "
        f"{len(stream_body) // 2} samples; HTTP {codes}; launches {launches}")
    log(f"mel frames per sentence: {[w.size // 256 for w in waves]}")

    # the same model on the CPU (plain PyTorch path) on a small input
    cpu_model = copy.deepcopy(tts.model).to("cpu")
    ids, lens, _ = tts.encode_texts(SENTENCES[:2])
    sids = torch.zeros(2, dtype=torch.int64)
    frames = 64
    wav_gpu, len_gpu = tts.model.inference(sids.to(dev), torch.as_tensor(ids, device=dev),
                                           torch.as_tensor(lens, device=dev), frames)
    wav_cpu, len_cpu = cpu_model.inference(sids, torch.as_tensor(ids),
                                           torch.as_tensor(lens), frames)
    err = (wav_gpu.cpu() - wav_cpu).abs().max().item()
    if not torch.equal(len_gpu.cpu(), len_cpu) or err > 1e-3:
        raise AssertionError(f"card vs CPU: lengths {len_gpu.tolist()} vs "
                             f"{len_cpu.tolist()}, max_abs_err {err}")
    log(f"card (kernels) vs CPU (plain) on 2 sentences x {frames} frames: "
        f"max_abs_err {err:.3e} (tol 1e-3), peak |wav| {wav_cpu.abs().max().item():.3f}")
    return launches, tts


# --------------------------------------------------------------------------
# phase 6: the training path
# --------------------------------------------------------------------------

def build_gan(hp_overrides=None):
    """Full-width JETS (config/model_config.yaml, attn_implementation flash,
    fused_mrf off as in training, two speakers as bench.py has it) and the
    full MSMPD, seeded random weights on the CPU, and the step's pieces
    from the shipped training config."""
    from viet_tts_torch import config
    from viet_tts_torch.models.jets import JETS
    from viet_tts_torch.nn.utils import seeded_init_
    from viet_tts_torch.text import NUM_SYMBOLS
    from viet_tts_torch.train.gan import build_discriminator, build_mel_loss

    hp = dict(config.jets_generator_params(), attn_implementation="flash", fused_mrf=False)
    hp.update(hp_overrides or {})
    audio = config.default_audio()
    gen = torch.Generator().manual_seed(SEED)
    model = seeded_init_(JETS(NUM_SYMBOLS, audio["mel"]["channels"], hp, n_speakers=2), gen)
    with torch.no_grad():
        for up in model.generator.upsamples:  # audio-scale output (see phase 5)
            up[1].weight_g.fill_(1.0)
    disc = seeded_init_(build_discriminator(config.jets_discriminator_params()), gen)
    mel_loss = build_mel_loss(audio, log_base=None)
    return model, disc, mel_loss, config.jets_train_conf(), config.upsample_factor(audio)


def gan_states(model, disc, train_conf):
    from viet_tts_torch.config import GRAD_CLIP_THRESH
    from viet_tts_torch.train.state import TrainState, adamw_with_clip

    opt = train_conf["optimizer"]
    states = []
    for module, key in ((model, "gen_optim_conf"), (disc, "dis_optim_conf")):
        c = opt[key]
        states.append(TrainState.create(module, adamw_with_clip(
            module.parameters(), c["lr"], c["betas"], c["eps"], c["weight_decay"],
            GRAD_CLIP_THRESH)))
    return states


def synthetic_batch(B, T_text, T_mel, hop, dev):
    """bench.py:946-957: full lengths, speech 0.1 * randn, numpy seed 0."""
    from viet_tts_torch.text import NUM_SYMBOLS

    rng = np.random.RandomState(0)
    batch = dict(
        text=rng.randint(1, NUM_SYMBOLS, (B, T_text)).astype(np.int64),
        text_lengths=np.full(B, T_text, np.int64),
        feats=rng.randn(B, T_mel, 80).astype(np.float32),
        feats_lengths=np.full(B, T_mel, np.int64),
        pitch=rng.randn(B, T_mel).astype(np.float32),
        energy=rng.randn(B, T_mel).astype(np.float32),
        sids=np.zeros(B, np.int64),
        speech=(0.1 * rng.randn(B, T_mel * hop)).astype(np.float32),
    )
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _flat_params(module):
    return torch.cat([p.detach().flatten() for p in module.parameters()])


def check_training_path(dev, steps: int = 5, warmup: int = 2):
    """``make_jets_train_step`` at full width on the bench.py batch: warm-up,
    then ``steps`` timed steps with the kernels' launches counted; finite
    metrics, both models changed; the alignment loops timed on their own;
    then one small step on the card against the CPU."""
    from viet_tts_torch.config import jets_lambdas
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops.forward_sum import beta_binomial_log_prior, jets_forward_sum_loss
    from viet_tts_torch.ops.mas import viterbi_decode
    from viet_tts_torch.train.gan import make_jets_train_step

    model, disc, mel_loss, train_conf, hop = build_gan()
    n_gen = sum(p.numel() for p in model.parameters())
    n_disc = sum(p.numel() for p in disc.parameters())
    model.to(dev)
    disc.to(dev)
    gen_state, disc_state = gan_states(model, disc, train_conf)
    step = make_jets_train_step(model, disc, mel_loss, jets_lambdas(train_conf), hop)
    batch = synthetic_batch(TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL, hop, dev)
    rng = torch.Generator().manual_seed(SEED)
    before = (_flat_params(model), _flat_params(disc))
    for _ in range(warmup):
        step(gen_state, disc_state, batch, rng)
    torch.cuda.synchronize()

    fa.attention_fwd.launches = 0
    fa.attention_bwd_dq.launches = 0
    fa.attention_bwd_dkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        gen_state, disc_state, metrics = step(gen_state, disc_state, batch, rng)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"flash_attention_fwd": fa.attention_fwd.launches,
                "flash_attention_bwd_q": fa.attention_bwd_dq.launches,
                "flash_attention_bwd_kv": fa.attention_bwd_dkv.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    values = {k: v.item() for k, v in metrics.items()}
    changed = [(a - b).abs().max().item() for a, b in
               zip(before, (_flat_params(model), _flat_params(disc)))]
    expect = 10 * steps  # 4 encoder + 6 decoder layers a step, each kernel
    if launches != dict.fromkeys(launches, expect):
        raise AssertionError(f"training launches {launches}, expected {expect} each")
    if not all(np.isfinite(v) for v in values.values()) or min(changed) <= 0.0:
        raise AssertionError(f"metrics {values}, max parameter change {changed}")
    median = sorted(times)[len(times) // 2]
    log(f"training path: JETS {n_gen} + MSMPD {n_disc} parameters, batch B={TRAIN_B} "
        f"T_text={TRAIN_T_TEXT} T_mel={TRAIN_T_MEL}, segment {model.segment_size} frames; "
        f"step host seconds {[round(x, 4) for x in times]} (median {median:.4f}); "
        f"peak {peak_gb:.2f} GB; launches over {steps} steps {launches}; "
        f"metrics after {warmup + steps} steps {values}; max parameter change "
        f"gen {changed[0]:.3e} disc {changed[1]:.3e}")

    # the alignment loops alone (MAS and the forward-sum CTC: one small
    # launch sequence per mel frame), on the step's shapes
    log_p = torch.log_softmax(torch.randn(TRAIN_B, TRAIN_T_MEL, TRAIN_T_TEXT, device=dev,
                                          generator=torch.Generator(dev).manual_seed(0)), -1)
    lens_t, lens_m = batch["text_lengths"], batch["feats_lengths"]

    def ctc():
        x = log_p.detach().requires_grad_()
        prior = beta_binomial_log_prior(lens_t, lens_m, TRAIN_T_TEXT, TRAIN_T_MEL)
        jets_forward_sum_loss(x, lens_t, lens_m, bb_prior=prior).backward()

    align = {}
    for name, fn in (("viterbi_decode", lambda: viterbi_decode(log_p, lens_t, lens_m)),
                     ("forward_sum fwd+bwd", ctc)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        align[name] = (time.perf_counter() - t0) / 3
    log(f"alignment loops at ({TRAIN_B}, {TRAIN_T_MEL}, {TRAIN_T_TEXT}): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in align.items()))
    check_training_against_cpu(dev)
    return launches, {"step_s": median, "peak_gb": peak_gb}, (step, gen_state,
                                                              disc_state, batch, rng)


def check_training_against_cpu(dev, hp_overrides=None):
    """One step at full width on a small batch (B=2, T_text=16, T_mel=64,
    segment 32 frames), dropout 0, from the same weights and the same
    given segment starts, on the card (kernels) and on the CPU (plain
    versions): the nine metrics and both models' gradient norms within
    rel 1e-3. ``hp_overrides`` picks the stacks (the conformer's)."""
    from viet_tts_torch.config import JETS_DROPOUT_KEYS, jets_lambdas
    from viet_tts_torch.train.gan import make_jets_train_step

    hp = dict.fromkeys(JETS_DROPOUT_KEYS, 0.0)
    hp["segment_size"] = 32
    hp.update(hp_overrides or {})
    results = []
    for device in (dev, torch.device("cpu")):
        model, disc, mel_loss, train_conf, hop = build_gan(hp)
        model.to(device)
        disc.to(device)
        gen_state, disc_state = gan_states(model, disc, train_conf)
        step = make_jets_train_step(model, disc, mel_loss, jets_lambdas(train_conf), hop)
        batch = synthetic_batch(2, 16, 64, hop, device)
        starts = torch.tensor([5, 17], device=device)
        gen_state, disc_state, metrics = step(gen_state, disc_state, batch,
                                              torch.Generator().manual_seed(0), starts)
        results.append({**{k: v.item() for k, v in metrics.items()},
                        "gen_grad_norm": gen_state.grad_norm.item(),
                        "disc_grad_norm": disc_state.grad_norm.item()})
    card, cpu = results
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    if max(rel.values()) > 1e-3:
        raise AssertionError(f"training step card vs CPU: {card} vs {cpu}, rel {rel}")
    log(f"training step {hp_overrides or ''} card (kernels) vs CPU (plain), B=2 T_mel=64: "
        f"max rel diff "
        f"{max(rel.values()):.3e} (tol 1e-3) over {sorted(rel)}")



# --------------------------------------------------------------------------
# phase 7: K4, K5, K6 (the FS2 conformer's XL attention)
# --------------------------------------------------------------------------

FS2_H, FS2_D = 8, 48  # config/model_config.yaml fastspeech2: 384 wide, 8 heads


def xl_inputs(dev, B: int, T: int, seed: int, H: int = FS2_H, D: int = FS2_D):
    """One XL attention's inputs in its three parameterisations (fp32, on
    the card), built as the conformer builds them: q, k, v, biases and
    pos_proj drawn from a seed; the raw sinusoid table."""
    from viet_tts_torch.nn.utils import sinusoid_position_table
    from viet_tts_torch.ops.xl_attention import xl_pos_queries, xl_pos_query_stream

    E = H * D
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    u, vb = 0.3 * f(H, D), 0.3 * f(H, D)
    pos_kernel = f(E, E) / np.sqrt(E)
    table = torch.from_numpy(sinusoid_position_table(T, E)).to(dev)
    qv = q + vb
    gA, gB = xl_pos_queries(qv, pos_kernel)
    return dict(qc=q + u, k=k, v=v, qv=qv, p=(table @ pos_kernel).reshape(T, H, D),
                g=xl_pos_query_stream(qv, pos_kernel), gA=gA, gB=gB, table=table)


XL_ENTRIES = {
    # kind: (wrapper, plain, stream names, name, replaces)
    "xl3": ("xl3_fwd", "xl3_fwd_plain", ("qc", "k", "v", "qv", "p"), "flash_xl3_fwd",
            "viet_tts_tpu/ops/pallas_attention.py:1512"),
    "xl2": ("xl2_fwd", "xl2_fwd_plain", ("qc", "k", "v", "g", "table"), "flash_xl2_fwd",
            "viet_tts_tpu/ops/pallas_attention.py:1173"),
    "xl": ("xl_fwd", "xl_fwd_plain", ("qc", "k", "v", "gA", "gB", "table"), "flash_xl_fwd",
           "viet_tts_tpu/ops/pallas_attention.py:792"),
}


def _xl_work(kind: str, args, lens, T: int):
    """(bytes, FLOP) the function needs: every input read once in its
    dtype, ctx and lse written once in fp32; the dot products over the live
    keys of each row (content D, position D for xl3 or E for xl2 / xl, and
    the weighted sum D wide; a row with no live key needs none)."""
    B, _, H, D = args[0].shape
    E = D if kind == "xl3" else args[3].shape[-1]
    nbytes = sum(a.numel() * a.element_size() for a in args) + 4.0 * (
        B * T * H * D + B * H * T + B * T)
    flops = 2.0 * H * T * float(np.sum(lens)) * (D + E + D)
    return nbytes, flops


def check_xl_kernels(dev, t_text: int):
    """K4 / K5 / K6 against their plain versions at the serving shapes,
    fp32 (TF32 off) within 1e-4 and bf16 within 2e-2, ragged lengths with a
    fully padded row and no pad mask; times of the kernel, the plain
    version and SDPA with the position term as an additive mask. Returns
    the kernel-line entries (fp32, no pad mask: what the serving path runs)."""
    from viet_tts_torch.ops import flash_xl_attention as fx
    from viet_tts_torch.ops.xl_attention import xl_attention_scores

    cases = [("xl3", 16, t_text), ("xl3", 16, 512), ("xl2", 16, 1008), ("xl", 4, 2048)]
    entries = {}
    for kind, B, T in cases:
        wrapper, plain_name, names, name, replaces = XL_ENTRIES[kind]
        fwd, plain = getattr(fx, wrapper), getattr(fx, plain_name)
        base = xl_inputs(dev, B, T, seed=T + B)
        rng = np.random.RandomState(T)
        lens = rng.randint(1, T + 1, B)
        lens[0], lens[-1] = T, 0  # one full row, one fully padded row
        ragged = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        scale = 1.0 / np.sqrt(FS2_H * FS2_D)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = [base[n].to(dtype) for n in names]
            peak = FP32_FLOP_PER_MS if dtype == torch.float32 else BF16_FLOP_PER_MS
            for pad, pad_name, live in ((ragged, "ragged", lens),
                                        (None, "no pad mask", np.full(B, T))):
                ctx, lse = fwd(*args, scale, pad)
                ref, ref_lse = plain(*args, scale, pad)
                torch.cuda.synchronize()
                err = (ctx - ref).abs().max().item()
                lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                lse_tol = 1e-5 if dtype == torch.float32 else 1e-3
                label = f"{name} (B={B}, T={T}) {str(dtype)[6:]} {pad_name}"
                if not (torch.isfinite(ctx).all() and err <= tol and lse_err <= lse_tol):
                    raise AssertionError(f"{label}: max_abs_err {err} (tol {tol}), "
                                         f"lse rel err {lse_err} (tol {lse_tol})")
                del ref, ref_lse
                iters = 20 if T <= 512 else 5
                k_ms = cuda_ms(lambda: fwd(*args, scale, pad), iters)
                p_ms = cuda_ms(lambda: plain(*args, scale, pad), 3, warmup=1)
                # SDPA's mask: scale * the position term (from the dense
                # oracle, on the two-stream inputs), MASK_NEG at padded keys
                t0 = time.perf_counter()
                zeros = torch.zeros_like(base["qc"])
                mask = xl_attention_scores(zeros, zeros, base["gA"], base["gB"],
                                           base["table"], scale)
                if pad is not None:
                    mask = mask.masked_fill(pad[:, None, None, :], fx.MASK_NEG)
                mask = mask.to(dtype)
                torch.cuda.synchronize()
                build_ms = (time.perf_counter() - t0) * 1e3
                qh, kh, vh = (base[n].to(dtype).permute(0, 2, 1, 3) for n in ("qc", "k", "v"))
                l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=scale), iters)
                del mask, qh, kh, vh, zeros
                nbytes, flops = _xl_work(kind, args, live, T)
                redesigned = name in TC_REDESIGNED
                b_ms, kind_b = (_tensor_core_bound(nbytes, flops, dtype) if redesigned
                                else bound(nbytes, flops, peak))
                log(f"{label}: max_abs_err {err:.3e} (tol {tol}) lse {lse_err:.1e} "
                    f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
                    f"(mask built in {build_ms:.1f} ms) bound_ms {b_ms:.4f} ({kind_b}) "
                    f"{flops / k_ms / 1e9:.2f} TFLOP/s")
                tc = (_tensor_core_figures(name, k_ms, b_ms, nbytes, flops) if redesigned
                      else {})
                entry = entries.setdefault(kind, {
                    "name": name, "route": "cuda",
                    "source": "viet_tts_torch/csrc/flash_xl_attention.cu",
                    "replaces": replaces, "max_abs_err": 0.0, "tol": 1e-4})
                if dtype == torch.float32:
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)
                serving_shape = (kind != "xl3" or T == t_text)
                if dtype == torch.float32 and pad is None and serving_shape:
                    entry.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                                 bound_by=kind_b, library_mask_build_ms=build_ms, **tc,
                                 per=f"one launch at (B={B}, H={FS2_H}, T={T}, D={FS2_D}"
                                     + ("" if kind == "xl3" else f", E={FS2_H * FS2_D}")
                                     + "), fp32, no pad mask (the serving path's)",
                                 library="F.scaled_dot_product_attention with scale * "
                                         "pos as an additive mask")
            del args
        del base
        torch.cuda.empty_cache()
    return entries


# --------------------------------------------------------------------------
# phase 8: the two-stage path (FastSpeech2-conformer + HiFi-GAN)
# --------------------------------------------------------------------------


def build_two_stage(root: str):
    """Full-width FastSpeech2-conformer (attn_implementation flash) and
    HiFi-GAN V1, seeded random weights, saved as two port checkpoints."""
    from viet_tts_torch import config
    from viet_tts_torch.infer.api import default_conf, save_checkpoint
    from viet_tts_torch.models.fastspeech2.model import FastSpeech2
    from viet_tts_torch.models.hifigan import HiFiGANGenerator
    from viet_tts_torch.nn.utils import seeded_init_
    from viet_tts_torch.text import NUM_SYMBOLS

    conf = default_conf()
    hp = conf["models"]["fastspeech2"]
    hp["attn_implementation"] = "flash"
    n_mels = conf["audio"]["mel"]["channels"]
    gen = torch.Generator().manual_seed(SEED)
    acoustic = seeded_init_(FastSpeech2(NUM_SYMBOLS, n_mels, hp, config.DEFAULT_STATS,
                                        n_speakers=1, n_accents=2), gen)
    hifi = conf["models"]["hifigan"]
    vocoder = seeded_init_(HiFiGANGenerator(
        in_channels=n_mels, channels=hifi["upsample_initial_channel"],
        upsample_scales=hifi["upsample_rates"],
        upsample_kernel_sizes=hifi["upsample_kernel_sizes"],
        resblock_kernel_sizes=hifi["resblock_kernel_sizes"],
        resblock_dilations=hifi["resblock_dilation_sizes"]), gen)
    with torch.no_grad():
        for up in vocoder.upsamples:  # audio-scale output (see phase 5)
            up[1].weight_g.fill_(1.0)
    bc = hp["building_block"]["conformer"]
    log(f"FastSpeech2-conformer full width: {sum(p.numel() for p in acoustic.parameters())} "
        f"parameters (d_model {hp['encoder_hidden']}, {bc['encoder_head']} heads, "
        f"{hp['encoder_layers']} + {hp['decoder_layers']} layers, conv k="
        f"{bc['conv_kernel_size']}, CVAE, postnet); HiFi-GAN V1 "
        f"{sum(p.numel() for p in vocoder.parameters())} parameters")
    ac_dir, voc_dir = os.path.join(root, "acoustic"), os.path.join(root, "vocoder")
    save_checkpoint(ac_dir, acoustic, conf, stats=config.DEFAULT_STATS)
    save_checkpoint(voc_dir, vocoder, {"audio": conf["audio"],
                                       "models": {"hifigan": hifi}})
    return ac_dir, voc_dir


def _fs2_counts():
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_xl_attention as fx
    from viet_tts_torch.ops import fused_mrf as fm

    return {"flash_xl3_fwd": fx.xl3_fwd.launches, "flash_xl2_fwd": fx.xl2_fwd.launches,
            "flash_xl_fwd": fx.xl_fwd.launches, "fused_mrf_stage": fm.fused_mrf_stage.launches,
            "flash_attention_fwd": fa.attention_fwd.launches}


def _zero_fs2_counts():
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_xl_attention as fx
    from viet_tts_torch.ops import fused_mrf as fm

    for fn in (fx.xl3_fwd, fx.xl2_fwd, fx.xl_fwd, fm.fused_mrf_stage, fa.attention_fwd):
        fn.launches = 0


def _counted_call(fn, expect: dict, label: str, counts=_fs2_counts):
    """Run ``fn`` once with the launch counts (``counts()``) measured around
    it; assert each count in ``expect``. Returns (result, host seconds)."""
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in counts().items()}
    if any(got[k] != n for k, n in expect.items()):
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    log(f"{label}: {secs:.4f} s, launches {got}")
    return out, secs


def _check_waves(waves, n: int, label: str):
    if len(waves) != n or not all(np.isfinite(w).all() for w in waves):
        raise AssertionError(f"{label}: waveforms not finite / wrong count")
    if not all(w.size % 256 == 0 for w in waves):
        raise AssertionError(f"{label}: waveform lengths not whole frames")


def check_two_stage_path(dev, ac_dir: str, voc_dir: str):
    """TwoStageTTS at 1008 frames (fp32 and half) and at 2048, then the
    server; launches asserted per call; card vs CPU on a small input."""
    from viet_tts_torch.infer.api import TwoStageTTS
    from viet_tts_torch.infer.server import serve

    tts = TwoStageTTS(ac_dir, voc_dir, fused_vocoder=True)
    tts_half = TwoStageTTS(ac_dir, voc_dir, fused_vocoder=True, half=True)
    tts_long = TwoStageTTS(ac_dir, voc_dir, fused_vocoder=True, max_mel_frames=2048)
    for model in (tts, tts_half, tts_long):  # warm-up: cuDNN autotune, allocator
        model(SENTENCES[:2])
    torch.cuda.synchronize()
    per_call = {"flash_xl3_fwd": 6, "fused_mrf_stage": K2_PER_CALL, "flash_attention_fwd": 0}
    _zero_fs2_counts()
    torch.cuda.reset_peak_memory_stats()
    waves, call_s = _counted_call(lambda: tts(SENTENCES),
                                  {**per_call, "flash_xl2_fwd": 6, "flash_xl_fwd": 0},
                                  "two-stage fp32 __call__(16) at 1008 frames")
    waves_half, half_s = _counted_call(lambda: tts_half(SENTENCES),
                                       {**per_call, "flash_xl2_fwd": 6, "flash_xl_fwd": 0},
                                       "two-stage bf16 __call__(16) at 1008 frames")
    waves_long, long_s = _counted_call(lambda: tts_long(SENTENCES[:4]),
                                       {**per_call, "flash_xl2_fwd": 0, "flash_xl_fwd": 6},
                                       "two-stage fp32 __call__(4) at 2048 frames")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    httpd = serve(tts, port=0, model_name="FASTSPEECH2")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            codes = [r.status]
            health = json.load(r)
        for text in SENTENCES[5:7]:
            code, body = post(f"{base}/synthesize", {"text": text})
            codes.append(code)
            if body[:4] != b"RIFF":
                raise AssertionError("/synthesize did not return a WAV")
        # random weights give some sentences no frame at all: stream the
        # one with the most
        longest = SENTENCES[int(np.argmax([w.size for w in waves]))]
        t0 = time.perf_counter()
        code, stream_body = post(f"{base}/synthesize_stream", {"text": longest})
        stream_s = time.perf_counter() - t0
        codes.append(code)
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = _fs2_counts()
    _check_waves(waves, len(SENTENCES), "fp32")
    _check_waves(waves_half, len(SENTENCES), "bf16")
    _check_waves(waves_long, 4, "2048 frames")
    if codes != [200] * 4 or health != {"status": "ok", "model": "FASTSPEECH2"}:
        raise AssertionError(f"HTTP codes {codes}, health {health}")
    if len(stream_body) % 2 or not stream_body:
        raise AssertionError("/synthesize_stream returned no PCM")
    log(f"two-stage path: peak {peak_gb:.2f} GB over the three calls; server HTTP {codes}, "
        f"/synthesize_stream {stream_s:.3f} s, {len(stream_body) // 2} samples; launches "
        f"over the phase {launches}; mel frames per sentence "
        f"{[w.size // 256 for w in waves]}")

    # host time: median of 5 fp32 calls, and the acoustic / vocoder split
    times, ac_times, voc_times = [], [], []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tts(SENTENCES)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            mel, _ = tts._mel(SENTENCES, 0, 0, None, 1.0, 1.0, 1.0)
            torch.cuda.synchronize()
            ac_times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            tts._vocode(mel)
            torch.cuda.synchronize()
            voc_times.append(time.perf_counter() - t0)
    med = lambda xs: sorted(xs)[len(xs) // 2]
    log(f"two-stage fp32 __call__(16) at 1008 frames: host median of 5 {med(times):.4f} s "
        f"({[round(x, 4) for x in times]}); acoustic stage median {med(ac_times):.4f} s, "
        f"vocoder stage median {med(voc_times):.4f} s")

    check_two_stage_against_cpu(dev, tts)
    return launches, tts, {"call_s": med(times), "half_s": half_s, "long_s": long_s,
                           "acoustic_s": med(ac_times), "vocoder_s": med(voc_times)}


def check_two_stage_against_cpu(dev, tts):
    """The acoustic model on the card (kernels) against the same model on
    the CPU (plain versions), 2 sentences, at 64, 600 and 1100 frames (the
    decoder on each of the xl3, xl2 and xl routes), mel within 1e-3 and
    equal mel_lens; then the vocoder on the 64-frame mel."""
    cpu_ac = copy.deepcopy(tts.acoustic).to("cpu")
    cpu_voc = copy.deepcopy(tts.vocoder).to("cpu")
    ids, lens, _ = tts.encode_texts(SENTENCES[:2])
    feats = torch.zeros(2, 64, tts.n_mels)
    args = (torch.zeros(2, dtype=torch.int64), torch.as_tensor(ids), torch.as_tensor(lens))
    aids = torch.zeros(2, dtype=torch.int64)
    for frames in (64, 600, 1100):
        mel_gpu, len_gpu, _ = tts.acoustic.inference(
            *(a.to(dev) for a in args), frames, feats=feats.to(dev), aids=aids.to(dev))
        mel_cpu, len_cpu, _ = cpu_ac.inference(*args, frames, feats=feats, aids=aids)
        err = (mel_gpu.cpu() - mel_cpu).abs().max().item()
        if not torch.equal(len_gpu.cpu(), len_cpu) or err > 1e-3:
            raise AssertionError(f"two-stage card vs CPU at {frames} frames: lengths "
                                 f"{len_gpu.tolist()} vs {len_cpu.tolist()}, max_abs_err {err}")
        log(f"two-stage acoustic card (kernels) vs CPU (plain), 2 sentences x {frames} "
            f"frames: max_abs_err {err:.3e} (tol 1e-3), peak |mel| "
            f"{mel_cpu.abs().max().item():.3f}")
        if frames == 64:
            with torch.no_grad():
                wav_err = (tts._vocode(mel_cpu.to(dev)).cpu()
                           - cpu_voc(mel_cpu)[..., 0]).abs().max().item()
            if wav_err > 1e-3:
                raise AssertionError(f"vocoder card vs CPU: max_abs_err {wav_err}")
            log(f"two-stage vocoder card vs CPU on that mel: max_abs_err {wav_err:.3e}")


# --------------------------------------------------------------------------
# phase 9: K4 / K5 with dropout and their backward at the training shapes
# --------------------------------------------------------------------------

XL_TRAIN_DROPOUT = 0.1  # model_config.yaml fastspeech2: conformer encoder/decoder_dropout
FS2_TRAIN_T_MELS = (1008, 512)  # decoder on K5 (pads to 1024) / on K4
# (kind, T): the encoder's text bucket and the decoder at 512 on K4, the
# decoder at 1008 on K5; B = 8, H = 8, D = 48 (E = 384)
XL_TRAIN_CASES = (("xl3", TRAIN_T_TEXT), ("xl3", TRAIN_T_MEL), ("xl2", 1008))
XL_TRAIN_REPLACES = {
    "flash_xl3_bwd": "viet_tts_tpu/ops/pallas_attention.py:1465",
    "flash_xl2_bwd_q": "viet_tts_tpu/ops/pallas_attention.py:1060",
    "flash_xl2_bwd_kv": "viet_tts_tpu/ops/pallas_attention.py:1108",
}


def _xl_train_work(kind: str, args, lens, T: int):
    """(bytes, FLOP) of each training kernel of ``kind`` at these inputs:
    every input read once in its dtype (the cotangent g in the stream
    dtype, pad, lse and delta in fp32), every output written once in fp32;
    the dot products over the live keys L of each row only (a pair needs
    one of the past / future position terms): forward content D +
    position P + weighted sum D; K4 bwd eight D-wide products (s, pos, g v,
    dqc, dk, dv, dqv, dp); K5 / K6 bwd-q s, pos, g v, dqc and the E-wide
    dgA / dgB (3D + 2E; K5 writes one dg2, K6 dgA and dgB). K5 / K6 bwd-kv:
    the work of the kernel, which reads bwd-q's two fp32 scratches (p m /
    keep and ds over the T x T pairs) with qc and g and forms dk and dv (two
    D-wide products a pair); and, as ``*_bwd_kv_function``, the function's
    own work from the streams (s, pos, g v, dk, dv: 4D + E)."""
    B, _, H, D = args[0].shape
    esz = args[0].element_size()
    row, stat = B * T * H * D, B * H * T
    P = D if kind == "xl3" else args[3].shape[-1]
    ins = sum(a.numel() * a.element_size() for a in args) + 4.0 * B * T
    pairs = 2.0 * H * T * float(np.sum(lens))
    work = {"fwd": (ins + 4.0 * (row + stat), pairs * (2 * D + P))}
    bwd_in = ins + esz * row + 8.0 * stat
    if kind == "xl3":
        work["flash_xl3_bwd"] = (bwd_in + 4.0 * (4 * row + T * H * D), pairs * 8 * D)
    else:
        name, n_pos = ("flash_xl2", 1) if kind == "xl2" else ("flash_xl", 2)
        work[f"{name}_bwd_q"] = (bwd_in + 4.0 * (row + n_pos * B * T * H * P),
                                 pairs * (3 * D + 2 * P))
        work[f"{name}_bwd_kv"] = (2.0 * esz * row + 8.0 * B * H * T * T + 4.0 * 2 * row,
                                  pairs * 2 * D)
        work[f"{name}_bwd_kv_function"] = (bwd_in + 4.0 * 2 * row, pairs * (4 * D + P))
    return work


def _bwd_kv_stages(kind: str, bargs, tol: float = 1e-4, whole=None) -> dict:
    """The K3 (``plain``) / K5 (``xl2``) / K6 (``xl``) / K7 (``rel``)
    backward's stages at one call of the training path, as closures to
    time: Q1 without and with its second write (P), the bwd-kv kernel alone
    on the scratches of one Q1 and its plain version there
    (``xl_bwd_kv_plain``), and the whole backward (``xl2_bwd`` / ``xl_bwd``
    / ``rel_bwd``; K3's ``whole``, the closure of its ``attention_bwd``
    call, whose arguments differ from bargs); with the kernel alone's (max
    abs error, scaled) against that plain version, which must be within
    ``tol`` (scaled by the largest value where that exceeds 1). The stage
    helpers count no launch: these are timings, not the path."""
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_rel_attention as fr
    from viet_tts_torch.ops import flash_xl_attention as fx

    if kind == "plain":  # K3: bargs as attention_bwd_dq takes them
        q, k, v, g, pad, lse, delta, scale, p, seed = bargs
        ops = fa._bwd_ops(q, k, v, g, pad, lse, delta)
        q1 = lambda with_p: fa._bwd_q1(*ops, scale, p, seed, with_p)
        qc, g = ops[0], ops[3]
        kv = fa._bwd_kv  # K3's own bwd-kv instance
    else:
        *streams, pad, lse, delta, g, scale, p, seed = bargs
        ops_fn, pos, whole_fn = {"xl2": (fx._xl2_ops, fx.POS_XL_ROT, fx.xl2_bwd),
                                 "xl": (fx._xl_ops, fx.POS_XL, fx.xl_bwd),
                                 "rel": (fr._rel_ops, fx.POS_REL, fr.rel_bwd)}[kind]
        ops = ops_fn(*streams, pad, lse, delta, g)
        q1 = lambda with_p: fx._bwd_q1(pos, *ops, scale, p, seed, with_p)
        qc, g = ops[0], ops[9]
        whole = lambda: whole_fn(*bargs)
        kv = fx._bwd_kv
    s, pm = q1(True)[1:3]
    stages = {
        "kernel": lambda: kv(qc, g, s, pm),
        "plain": lambda: fx.xl_bwd_kv_plain(qc, g, s, pm),
        "q1": lambda: q1(False),
        "q1_with_p": lambda: q1(True),
        "whole": whole,
    }
    got, want = stages["kernel"](), stages["plain"]()
    torch.cuda.synchronize()
    stages["err"] = _max_err(got, want)
    if not stages["err"][1] <= tol:
        raise AssertionError(f"{kind} bwd-kv kernel alone against its plain version: max abs "
                             f"err (abs, scaled) {stages['err']} (tol {tol})")
    return stages


def _bwd_kv_figures(name: str, stages: dict, function_work, iters: int) -> dict:
    """bwd-kv's figures beside its kernel time, logged: Q1's time without
    and with the second write and the whole backward's, in device time
    (``bwd_ms``, the CUDA-event figures beside them), and the bound of the
    function's own work (``*_bwd_kv_function``) on the fp32 CUDA cores (the
    bound of the CUDA-core kernel this one replaced) and under 3xTF32."""
    nbytes, flops = function_work
    fig = {}
    for k in ("q1", "q1_with_p", "whole"):
        fig[f"{k}_ms"], fig[f"{k}_ms_cuda_events"] = bwd_ms(stages[k], iters, f"{k} of {name}")
    fig["bound_ms_function"], _ = bound(nbytes, flops, FP32_FLOP_PER_MS)
    fig["bound_ms_function_3xtf32"], _ = bound(nbytes, 3 * flops, TF32_FLOP_PER_MS)
    fig["max_abs_err_kernel_alone"] = stages["err"][0]
    log(f"    {name}: Q1 {fig['q1_ms']:.4f} ms, with the P write {fig['q1_with_p_ms']:.4f} "
        f"(+{fig['q1_with_p_ms'] - fig['q1_ms']:.4f}); whole backward {fig['whole_ms']:.4f} ms; "
        f"the function's bound {fig['bound_ms_function']:.4f} ms (fp32 cores), "
        f"{fig['bound_ms_function_3xtf32']:.4f} (3xTF32); kernel alone vs its plain version "
        f"{stages['err'][0]:.3e} (scaled {stages['err'][1]:.3e})")
    return fig


def _xl_pos(base, scale: float):
    """scale * the XL position term (B, H, T, T), from the dense oracle on
    the two-stream inputs."""
    from viet_tts_torch.ops.xl_attention import xl_attention_scores

    zeros = torch.zeros_like(base["qc"])
    return xl_attention_scores(zeros, zeros, base["gA"], base["gB"], base["table"], scale)


def _library_sdpa(pos_fn, base, pad, scale: float, dtype, dropout_p: float, gout):
    """SDPA with ``pos_fn(base, scale)`` (scale * the position term) as an
    additive mask, MASK_NEG at padded keys: (mask build ms, forward call,
    its backward through autograd on a retained graph). A yardstick only:
    no path of the port calls it."""
    from viet_tts_torch.ops.flash_attention import MASK_NEG

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = pos_fn(base, scale)
    if pad is not None:
        mask = mask.masked_fill(pad[:, None, None, :], MASK_NEG)
    mask = mask.to(dtype)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    qh, kh, vh = (base[n].to(dtype).permute(0, 2, 1, 3).contiguous() for n in ("qc", "k", "v"))
    gh = gout.to(dtype).permute(0, 2, 1, 3).contiguous()
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=dropout_p,
                                         scale=scale)

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              dropout_p=dropout_p, scale=scale)

    def bwd():
        return torch.autograd.grad(out, leaves, gh, retain_graph=True)

    return build_ms, fwd, bwd


def _library_pos_grad(base, pad, scale: float, dtype, dropout_p: float, gout,
                      rel: bool = False):
    """The same function as bwd-q, composed from library calls: SDPA's
    backward with scale * the position term as an additive mask that is a
    leaf taking a gradient, then that gradient's products with the table:
    XL (K5 / K6) the two masked ones (dgA = (dpos o past) t, dgB = (dpos o
    future) t), ``rel`` (K7) one at every key (dg = dpos t). Returns the
    closure to time. A yardstick only: no path of the port calls it."""
    from viet_tts_torch.ops.flash_attention import MASK_NEG

    T = base["qc"].shape[1]
    mask = (_rel_pos if rel else _xl_pos)(base, scale)
    if pad is not None:
        mask = mask.masked_fill(pad[:, None, None, :], MASK_NEG)
    mask = mask.to(dtype).detach().requires_grad_()
    leaves = [base[n].to(dtype).permute(0, 2, 1, 3).contiguous().requires_grad_()
              for n in ("qc", "k", "v")]
    gh = gout.to(dtype).permute(0, 2, 1, 3).contiguous()
    table = base["table"].to(dtype)
    i = torch.arange(T, device=table.device)[:, None]
    j = torch.arange(T, device=table.device)[None, :]
    past, fut = j <= i, j >= i + 2
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=dropout_p,
                                         scale=scale)

    def bwd_pos():
        *_, dmask = torch.autograd.grad(out, [*leaves, mask], gh, retain_graph=True)
        dpos = dmask * scale
        if rel:
            return dpos @ table
        zero = torch.zeros((), dtype=dtype, device=table.device)
        return (torch.where(past, dpos, zero) @ table, torch.where(fut, dpos, zero) @ table)

    return bwd_pos


# kernels redesigned for the tensor cores (3xTF32 for fp32 streams): the
# note each carries on the kernels line
TC_REDESIGNED = {
    **dict.fromkeys(("flash_xl2_bwd_q", "flash_xl_bwd_q"), (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams); Q1 (position "
        "logits, then ds and dqc) and Q2 (dgA, dgB) kernels")),
    **dict.fromkeys(("flash_xl2_bwd_kv", "flash_xl_bwd_kv"), (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams); reads bwd-q's "
        "scratches (ds and p m / keep, which Q1 writes) instead of forming the logits "
        "again: ms is the kernel alone, plain_ms its plain version on the same scratches, "
        "bound_ms the bound of its own work (the two scratches' bytes, two D-wide "
        "products a pair); bound_ms_function the function's 4D + E a pair on the fp32 "
        "cores, q1_ms / q1_with_p_ms Q1 without and with the P write, whole_ms the whole "
        "backward (bwd-q and bwd-kv on shared scratches), all three in device time")),
    **dict.fromkeys(("flash_xl2_fwd", "flash_xl_fwd"), (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams, one TF32 product "
        "for bf16); one flash kernel for K5, K6 and K7 (64-query tiles, the E-wide position "
        "product in 32-column chunks of gA / gB and the table, the online softmax and p v "
        "in registers; each batch row's key tiles walked only up to its last live key); "
        "K5 adds its rotation pass before it (timed in its ms)")),
    "flash_rel_fwd": (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams, one TF32 product for "
        "bf16): K7's instance of the K5 / K6 flash kernel, one g t^T pass a key tile added "
        "at every key; each batch row's key tiles walked only up to its last live key"),
    "flash_xl3_bwd": (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams): a ds kernel (s, the "
        "position logits as band products, g v^T, ds, dqc, then ds in band form for dqv and "
        "the table's partials) writing the ds and p m / keep scratches, bwd-kv (K5 / K6's "
        "kernel, K4's instance) on them, and a reduce pass; bound_ms counts the function's "
        "8D a pair, not the band products' padding"),
    "flash_xl3_fwd": (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams, one TF32 product for "
        "bf16): the position logits as band products against the 128-row band of p a tile "
        "reaches (xl3_band.cuh, shared with K4 bwd's ds kernel), sheared into the (row, key) "
        "tile in shared memory, plus qc k^T, then xl2_fwd_kernel's online softmax and p v "
        "in registers; four warps of 16 rows a block; bound_ms counts the function's 3D a "
        "pair, not the band products' padding"),
    "flash_rel_bwd_q": (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams): K7's instance of the "
        "K5 / K6 bwd-q kernels on a ds scratch, Q1 (position logits g t^T, then ds and "
        "dqc) and Q2 (dg = ds t over every key)"),
    "flash_rel_bwd_kv": (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams): K6's bwd-kv kernel at "
        "D = 128 on the ds and P scratches of K7's Q1 (no logits formed again), dtable by "
        "the dtab kernel's K7 instance: ms is the kernel alone, plain_ms its plain version "
        "on the same scratches, bound_ms the bound of its own work (the two scratches' "
        "bytes, two D-wide products a pair); bound_ms_function the function's 4D + E a "
        "pair on the fp32 cores, q1_ms / q1_with_p_ms Q1 without and with the P write, "
        "whole_ms the whole backward (bwd-q and bwd-kv on shared scratches), all three in "
        "device time, beside library_ms (SDPA's backward) and library_ms_pos_grad"),
    "flash_attention_fwd": (
        "tensor cores (mma.sync m16n8k8, 3xTF32 for fp32 streams, one TF32 product for "
        "bf16): the instance of the K5 / K6 / K7 flash kernel with no position term "
        "(xl2_fwd_kernel<T, D, 3, 4>: q k^T, the online softmax and p v in registers, k and "
        "v each in a cp.async group of its own), each batch row's key tiles walked only up "
        "to its last live key"),
}
TC_BOUND_NOTE = ("; bound_ms is the tensor cores' bound of that work, 3 * operations / 495 "
                 "TFLOP/s for fp32 streams; bound_ms_fp32 the fp32 CUDA cores', "
                 "bound_ms_tf32 one TF32 product a term, bound_ms_bf16 the bf16 rate")


def _tensor_core_bound(nbytes: float, flops: float, dtype):
    """A redesigned kernel's bound: the work it does on the tensor cores,
    three TF32 products a term for fp32 streams (3xTF32), one for bf16."""
    return bound(nbytes, 3 * flops if dtype == torch.float32 else flops, TF32_FLOP_PER_MS)


def _tensor_core_figures(name: str, k_ms: float, b_ms: float, nbytes: float, flops: float,
                         pos_grad=None, iters: int = 0) -> dict:
    """A redesigned kernel's other yardsticks beside its bound b_ms, logged:
    the bound of the function's operations on the fp32 CUDA cores, at one
    TF32 product a term and at the bf16 rate, and the share of each bound
    that the kernel reaches; for bwd-q also the time of the pos-grad
    yardstick (``pos_grad``: the closure of ``_library_pos_grad``)."""
    b32, _ = bound(nbytes, flops, FP32_FLOP_PER_MS)
    btf, _ = bound(nbytes, flops, TF32_FLOP_PER_MS)
    bbf, _ = bound(nbytes, flops, BF16_FLOP_PER_MS)
    fig = dict(bound_ms_fp32=b32, bound_ms_tf32=btf, bound_ms_bf16=bbf,
               share_of_bound=b_ms / k_ms, share_of_fp32_bound=b32 / k_ms,
               share_of_tf32_bound=btf / k_ms, share_of_bf16_bound=bbf / k_ms)
    pos = ""
    if pos_grad is not None:
        fig["library_ms_pos_grad"], fig["library_ms_pos_grad_cuda_events"] = bwd_ms(
            pos_grad, iters, f"the pos-grad yardstick of {name}")
        pos = (f"; library_ms_pos_grad {fig['library_ms_pos_grad']:.4f} device time (CUDA "
               f"events {fig['library_ms_pos_grad_cuda_events']:.4f}; SDPA backward with the "
               f"mask's gradient + its products with the table)")
    log(f"    {name}: share of bound_ms (tensor cores) {100 * fig['share_of_bound']:.1f} %; "
        f"fp32 CUDA-core bound {b32:.4f} ms ({100 * fig['share_of_fp32_bound']:.1f} %), "
        f"one TF32 product {btf:.4f} ({100 * fig['share_of_tf32_bound']:.1f} %), bf16 "
        f"{bbf:.4f} ({100 * fig['share_of_bf16_bound']:.1f} %){pos}")
    return fig


def _max_err(got, want):
    """(max abs error, max abs error / max(1, max |plain|)) over outputs."""
    errs = [((a - b).abs().max().item(), max(1.0, b.abs().max().item()))
            for a, b in zip(got, want) if b is not None]
    return max(e for e, _ in errs), max(e / s for e, s in errs)


def check_xl_training(dev):
    """K4 / K5 forward with attention-weight dropout and K4 bwd, K5 bwd-q,
    K5 bwd-kv against their plain versions under one seed at the FS2
    training shapes (B=8, H=8, D=48, E=384; K4 at T=64 and 512, K5 at
    1008), fp32 (TF32 off, each gradient within 1e-4 of the plain one,
    scaled by its largest value where that exceeds 1) and bf16 (2e-2),
    dropout 0 and 0.1, ragged lengths with a fully padded row and no pad
    mask (the path's: ``mask_attn_keys: false``); K5 bwd-kv with the table's
    gradient too. Times per launch at the path's call (fp32, dropout 0.1,
    no pad mask). Returns {kernel name: figures at the decoder's shape}."""
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_xl_attention as fx

    scale = 1.0 / np.sqrt(FS2_H * FS2_D)
    figures = {}
    for kind, T in XL_TRAIN_CASES:
        B = TRAIN_B
        base = xl_inputs(dev, B, T, seed=T + 3)
        rng = np.random.RandomState(T + 1)
        lens = rng.randint(1, T + 1, B)
        lens[0], lens[-1] = T, 0  # one full row, one fully padded row
        ragged = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        gout = torch.randn(B, T, FS2_H, FS2_D, generator=torch.Generator().manual_seed(T)).to(dev)
        names = ("qc", "k", "v", "qv", "p") if kind == "xl3" else ("qc", "k", "v", "g", "table")
        fwd, plain_fwd = ((fx.xl3_fwd, fx.xl3_fwd_plain) if kind == "xl3"
                          else (fx.xl2_fwd, fx.xl2_fwd_plain))
        if kind == "xl3":
            bwds = {"flash_xl3_bwd": (fx.xl3_bwd, fx.xl3_bwd_plain, {})}
        else:
            bwds = {"flash_xl2_bwd_q": (fx.xl2_bwd_dq, fx.xl2_bwd_dq_plain, {}),
                    "flash_xl2_bwd_kv": (fx.xl2_bwd_dkv, fx.xl2_bwd_dkv_plain,
                                         {"want_dtab": True})}
        fwd_name = f"flash_{kind}_fwd"
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = [base[n].to(dtype) for n in names]
            peak = FP32_FLOP_PER_MS if dtype == torch.float32 else BF16_FLOP_PER_MS
            for pad, pad_name, live in ((ragged, "ragged", lens),
                                        (None, "no pad mask", np.full(B, T))):
                padf = pad.float() if pad is not None else torch.zeros(B, T, device=dev)
                for p in (0.0, XL_TRAIN_DROPOUT):
                    seed = 7919 * T + int(p * 10)
                    ctx, lse = fwd(*args, scale, pad, p, seed)
                    ref, _ = plain_fwd(*args, scale, pad, p, seed)
                    delta, g = fa.backward_inputs(ctx, gout, dtype)
                    bargs = (*args, padf, lse, delta, g, scale, p, seed)
                    errs = {fwd_name: ((ctx - ref).abs().max().item(),) * 2}
                    del ref
                    for name, (kern, plain, kw) in bwds.items():
                        got = kern(*bargs, **kw)
                        want = plain(*bargs, **kw)
                        torch.cuda.synchronize()
                        if not all(torch.isfinite(x).all() for x in got if x is not None):
                            raise AssertionError(f"{name} T={T}: gradient not finite")
                        errs[name] = _max_err(got, want)
                        del got, want
                    label = f"T={T} {str(dtype)[6:]} {pad_name} dropout={p}"
                    bad = {n: e for n, e in errs.items() if e[1] > tol}
                    if bad:
                        raise AssertionError(f"XL training {label}: max abs err (abs, scaled) "
                                             f"{bad} (tol {tol})")
                    log(f"XL training {label}: " + ", ".join(
                        f"{n} {e[0]:.3e} (scaled {e[1]:.3e})" for n, e in errs.items())
                        + f" (tol {tol})")
                    path_call = dtype == torch.float32 and pad is None and p == XL_TRAIN_DROPOUT
                    if not path_call:
                        continue
                    iters = 20 if T <= 512 else 5
                    build_ms, lib_fwd, lib_bwd = _library_sdpa(_xl_pos, base, pad, scale, dtype,
                                                              p, gout)
                    l_fwd, l_bwd = cuda_ms(lib_fwd, iters), bwd_ms(
                        lib_bwd, iters, f"SDPA backward {kind} (B={B}, T={T})")
                    work = _xl_train_work(kind, args, live, T)
                    to_time = {fwd_name: (lambda: fwd(*args, scale, pad, p, seed),
                                          lambda: plain_fwd(*args, scale, pad, p, seed),
                                          (l_fwd, None))}
                    stages = _bwd_kv_stages(kind, bargs) if kind == "xl2" else None
                    for name, (kern, plain, _) in bwds.items():
                        to_time[name] = ((stages["kernel"], stages["plain"], l_bwd)
                                         if name.endswith("_bwd_kv") else
                                         (lambda k=kern: k(*bargs), lambda q=plain: q(*bargs),
                                          l_bwd))
                    for name, (k_fn, p_fn, (l_ms, l_ev)) in to_time.items():
                        k_ms, k_ev = (cuda_ms(k_fn, iters), None) if l_ev is None else bwd_ms(
                            k_fn, iters, f"{name} (B={B}, T={T})")
                        p_ms = cuda_ms(p_fn, 3, warmup=1)
                        nbytes, flops = work["fwd" if name == fwd_name else name]
                        b_ms, kind_b = (_tensor_core_bound(nbytes, flops, dtype)
                                        if name in TC_REDESIGNED else bound(nbytes, flops, peak))
                        log(f"  {name} (B={B}, T={T}): kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                            f"library_ms {l_ms:.4f} (mask built in {build_ms:.1f} ms) bound_ms "
                            f"{b_ms:.4f} ({kind_b}) {flops / k_ms / 1e9:.2f} TFLOP/s"
                            + _events_note(k_ev, l_ev))
                        tc = {} if l_ev is None else dict(zip(EVENT_KEYS, (k_ev, l_ev)))
                        if name in TC_REDESIGNED:
                            pos_grad = (_library_pos_grad(base, pad, scale, dtype, p, gout)
                                        if name.endswith("_bwd_q") else None)
                            tc.update(_tensor_core_figures(name, k_ms, b_ms, nbytes, flops,
                                                           pos_grad, iters))
                            del pos_grad
                        if name.endswith("_bwd_kv"):
                            tc.update(_bwd_kv_figures(name, stages, work[f"{name}_function"],
                                                      iters))
                            errs[name] = max(errs[name], stages["err"])
                        entry = figures.setdefault(name, {})
                        entry.setdefault("per_shape", {})[f"T={T}"] = dict(
                            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                            bound_by=kind_b, library_mask_build_ms=build_ms, **tc)
                        if T != TRAIN_T_TEXT:  # the decoder's shape heads the entry
                            entry.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                         bound_ms=b_ms, bound_by=kind_b,
                                         library_mask_build_ms=build_ms, **tc,
                                         per=f"one launch at (B={B}, H={FS2_H}, T={T}, "
                                             f"D={FS2_D}" + ("" if kind == "xl3" else
                                                             f", E={FS2_H * FS2_D}")
                                             + f"), fp32, dropout {p}, no pad mask (the "
                                             "training path's)")
                    del stages
                for name, e in errs.items():
                    if dtype == torch.float32:
                        entry = figures.setdefault(name, {})
                        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), e[0])
            del args
        del base
        torch.cuda.empty_cache()
    return figures


# --------------------------------------------------------------------------
# phase 14: K6 with dropout and its backward at the training shapes
# --------------------------------------------------------------------------

FS2_LONG_B, FS2_LONG_T_TEXT, FS2_LONG_T_MEL = 4, 128, 2048  # a bucket past XL2_MAX_T
# (model, B, T, H, D, the path's dropout, layers a step): the JETS legacy
# rel-pos encoder and decoder on the bench.py batch, the FS2 decoder past the
# xl2 route
K6_TRAIN_CASES = (
    ("JETS", TRAIN_B, TRAIN_T_TEXT, 2, 128, ATTN_DROPOUT, 4),
    ("JETS", TRAIN_B, TRAIN_T_MEL, 2, 128, ATTN_DROPOUT, 6),
    ("FS2", FS2_LONG_B, FS2_LONG_T_MEL, FS2_H, FS2_D, XL_TRAIN_DROPOUT, 6),
)
K6_BWD_REPLACES = {
    "flash_xl_bwd_q": "viet_tts_tpu/ops/pallas_attention.py:449",
    "flash_xl_bwd_kv": "viet_tts_tpu/ops/pallas_attention.py:488",
}


def check_xl_k6_training(dev):
    """K6 forward with attention-weight dropout, K6 bwd-q and bwd-kv against
    their plain versions under one seed at the training shapes (the JETS
    legacy conformer: B=8, H=2, D=128, E=256 at T=64 and 512, scale
    1/sqrt(D); the FS2 decoder: B=4, H=8, D=48, E=384 at T=2048, scale
    1/sqrt(E)), fp32 (TF32 off, each gradient within 1e-4 of the plain one,
    scaled by its largest value where that exceeds 1) and bf16 (2e-2),
    dropout 0 and the path's (0.2 JETS, 0.1 FS2), ragged lengths with a
    fully padded row and no pad mask (the paths' batches have full
    lengths); bwd-kv with the table's gradient too. Times per launch at the
    paths' calls (fp32, the path's dropout, no pad mask). Returns {kernel
    name: figures, headed by the JETS decoder's shape (8, 512)}."""
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_xl_attention as fx

    names = ("qc", "k", "v", "gA", "gB", "table")
    bwds = {"flash_xl_bwd_q": (fx.xl_bwd_dq, fx.xl_bwd_dq_plain, {}),
            "flash_xl_bwd_kv": (fx.xl_bwd_dkv, fx.xl_bwd_dkv_plain, {"want_dtab": True})}
    figures = {}
    for model, B, T, H, D, path_p, n_layers in K6_TRAIN_CASES:
        E = H * D
        scale = D ** -0.5 if model == "JETS" else 1.0 / np.sqrt(E)
        base = xl_inputs(dev, B, T, seed=T + D, H=H, D=D)
        rng = np.random.RandomState(T + D)
        lens = rng.randint(1, T + 1, B)
        lens[0], lens[-1] = T, 0  # one full row, one fully padded row
        ragged = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        gout = torch.randn(B, T, H, D, generator=torch.Generator().manual_seed(T + 1)).to(dev)
        shape = f"{model} (B={B}, T={T}, H={H}, D={D}, E={E})"
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = [base[n].to(dtype) for n in names]
            peak = FP32_FLOP_PER_MS if dtype == torch.float32 else BF16_FLOP_PER_MS
            for pad, pad_name, live in ((ragged, "ragged", lens),
                                        (None, "no pad mask", np.full(B, T))):
                padf = pad.float() if pad is not None else torch.zeros(B, T, device=dev)
                for p in (0.0, path_p):
                    seed = 15485863 * T + int(p * 10)
                    ctx, lse = fx.xl_fwd(*args, scale, pad, p, seed)
                    ref, ref_lse = fx.xl_fwd_plain(*args, scale, pad, p, seed)
                    lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                    errs = {"flash_xl_fwd": ((ctx - ref).abs().max().item(),) * 2}
                    finite = torch.isfinite(ctx).all().item()
                    del ref, ref_lse
                    delta, g = fa.backward_inputs(ctx, gout, dtype)
                    bargs = (*args, padf, lse, delta, g, scale, p, seed)
                    for name, (kern, plain, kw) in bwds.items():
                        got = kern(*bargs, **kw)
                        want = plain(*bargs, **kw)
                        torch.cuda.synchronize()
                        finite = finite and all(torch.isfinite(x).all().item() for x in got)
                        errs[name] = _max_err(got, want)
                        del got, want
                    label = f"K6 training {shape} {str(dtype)[6:]} {pad_name} dropout={p}"
                    lse_tol = 1e-5 if dtype == torch.float32 else 1e-3
                    bad = {n: e for n, e in errs.items() if e[1] > tol}
                    if bad or not finite or lse_err > lse_tol:
                        raise AssertionError(f"{label}: max abs err (abs, scaled) {errs} (tol "
                                             f"{tol}), finite {finite}, lse rel err {lse_err}")
                    log(f"{label}: " + ", ".join(
                        f"{n} {e[0]:.3e} (scaled {e[1]:.3e})" for n, e in errs.items())
                        + f" (tol {tol}); lse {lse_err:.1e}")
                    if dtype == torch.float32:
                        for n, e in errs.items():
                            entry = figures.setdefault(n, {})
                            entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), e[0])
                    if not (dtype == torch.float32 and pad is None and p == path_p):
                        continue
                    iters = 20 if T <= 512 else 5
                    build_ms, lib_fwd, lib_bwd = _library_sdpa(_xl_pos, base, pad, scale, dtype,
                                                              p, gout)
                    l_fwd, l_bwd = (cuda_ms(lib_fwd, iters), None), bwd_ms(
                        lib_bwd, iters, f"SDPA backward {shape}")
                    del lib_fwd, lib_bwd
                    work = _xl_train_work("xl", args, live, T)
                    to_time = {"flash_xl_fwd": (lambda: fx.xl_fwd(*args, scale, pad, p, seed),
                                                lambda: fx.xl_fwd_plain(*args, scale, pad, p,
                                                                        seed),
                                                l_fwd, work["fwd"])}
                    stages = _bwd_kv_stages("xl", bargs)
                    to_time["flash_xl_bwd_q"] = (lambda: fx.xl_bwd_dq(*bargs),
                                                 lambda: fx.xl_bwd_dq_plain(*bargs), l_bwd,
                                                 work["flash_xl_bwd_q"])
                    to_time["flash_xl_bwd_kv"] = (stages["kernel"], stages["plain"], l_bwd,
                                                  work["flash_xl_bwd_kv"])
                    for name, (k_fn, p_fn, (l_ms, l_ev), (nbytes, flops)) in to_time.items():
                        k_ms, k_ev = (cuda_ms(k_fn, iters), None) if l_ev is None else bwd_ms(
                            k_fn, iters, f"{name} {shape}")
                        p_ms = cuda_ms(p_fn, 3, warmup=1)
                        b_ms, kind_b = (_tensor_core_bound(nbytes, flops, dtype)
                                        if name in TC_REDESIGNED else bound(nbytes, flops, peak))
                        log(f"  {name} {shape}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                            f"library_ms {l_ms:.4f} (mask built in {build_ms:.1f} ms) bound_ms "
                            f"{b_ms:.4f} ({kind_b}) {flops / k_ms / 1e9:.2f} TFLOP/s; "
                            f"x{n_layers} a step" + _events_note(k_ev, l_ev))
                        tc = {} if l_ev is None else dict(zip(EVENT_KEYS, (k_ev, l_ev)))
                        if name in TC_REDESIGNED:
                            pos_grad = (_library_pos_grad(base, pad, scale, dtype, p, gout)
                                        if name.endswith("_bwd_q") else None)
                            tc.update(_tensor_core_figures(name, k_ms, b_ms, nbytes, flops,
                                                           pos_grad, iters))
                            del pos_grad
                        if name == "flash_xl_bwd_kv":
                            tc.update(_bwd_kv_figures(name, stages, work[f"{name}_function"],
                                                      iters))
                            entry = figures.setdefault(name, {})
                            entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                                                       stages["err"][0])
                        fig = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                                   bound_by=kind_b, library_mask_build_ms=build_ms, **tc,
                                   per=f"one launch at {shape}, fp32, dropout {p}, no pad mask "
                                       f"(the training path's; {n_layers} a step)")
                        entry = figures.setdefault(name, {})
                        entry.setdefault("per_shape", {})[shape] = fig
                        if model == "JETS" and T == TRAIN_T_MEL:  # the head of the entry
                            entry.update(fig)
                    del stages
            del args
        del base
        torch.cuda.empty_cache()
    return figures


# --------------------------------------------------------------------------
# phase 10: the FS2 training path
# --------------------------------------------------------------------------

XL_COUNTED = ("flash_xl3_fwd", "flash_xl3_bwd", "flash_xl2_fwd", "flash_xl2_bwd_q",
              "flash_xl2_bwd_kv", "flash_xl_fwd", "flash_xl_bwd_q", "flash_xl_bwd_kv",
              "flash_attention_fwd")


def _xl_wrappers():
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_xl_attention as fx

    return dict(zip(XL_COUNTED, (fx.xl3_fwd, fx.xl3_bwd, fx.xl2_fwd, fx.xl2_bwd_dq,
                                 fx.xl2_bwd_dkv, fx.xl_fwd, fx.xl_bwd_dq, fx.xl_bwd_dkv,
                                 fa.attention_fwd)))


def build_fs2_train(zero_dropout: bool = False):
    """Full-width FastSpeech2-conformer (config/model_config.yaml:16-79,
    attn_implementation flash, every dropout as configured unless
    ``zero_dropout``), two speakers and two accents as bench.py has them,
    seeded random weights on the CPU; its loss and the FS2 training config
    (config/train_config.yaml)."""
    from viet_tts_torch import config
    from viet_tts_torch.models.fastspeech2.loss import FastSpeech2Loss
    from viet_tts_torch.models.fastspeech2.model import FastSpeech2
    from viet_tts_torch.nn.utils import seeded_init_
    from viet_tts_torch.text import NUM_SYMBOLS

    hp = config.fastspeech2_params()
    hp["attn_implementation"] = "flash"
    if zero_dropout:
        conf = hp["building_block"]["conformer"]
        conf["encoder_dropout"] = conf["decoder_dropout"] = 0.0
        hp["variance"]["variance_predictor"]["dropout"] = 0.0
    train_conf = config.fastspeech2_train_conf()
    gen = torch.Generator().manual_seed(SEED)
    model = seeded_init_(FastSpeech2(NUM_SYMBOLS, 80, hp, config.DEFAULT_STATS, n_speakers=2,
                                     n_accents=2), gen)
    if zero_dropout:
        model.postnet.dropout.p = 0.0
    crit = FastSpeech2Loss(config.fastspeech2_loss_conf(train_conf, hp))
    return model, crit, train_conf


def fs2_state(model, train_conf):
    """The FS2 optimizer: AdamW (lr, betas, eps, weight decay of the
    training config) behind global-norm clipping at grad_clip_thresh."""
    from viet_tts_torch.config import GRAD_CLIP_THRESH
    from viet_tts_torch.train.state import TrainState, adamw_with_clip

    opt = train_conf["optimizer"]
    return TrainState.create(model, adamw_with_clip(
        model.parameters(), opt["lr"], opt["betas"], opt["eps"], opt["weight_decay"],
        GRAD_CLIP_THRESH))


def fs2_batch(B: int, T_text: int, T_mel: int, dev):
    """bench.py:_fs2_train_setup's batch (full lengths, numpy seed 0, two
    speakers' ids at 0) with the data pipeline's beta-binomial prior in
    ``duration`` in place of its uniform noise."""
    from viet_tts_torch.ops.prior import beta_binomial_prior
    from viet_tts_torch.text import NUM_SYMBOLS

    rng = np.random.RandomState(0)
    prior = beta_binomial_prior(T_text, T_mel).astype(np.float32)
    batch = dict(
        text=rng.randint(1, NUM_SYMBOLS, (B, T_text)).astype(np.int64),
        text_lengths=np.full(B, T_text, np.int64),
        feats=rng.randn(B, T_mel, 80).astype(np.float32),
        feats_lengths=np.full(B, T_mel, np.int64),
        duration=np.broadcast_to(prior, (B, T_mel, T_text)).copy(),
        pitch=rng.randn(B, T_mel).astype(np.float32),
        energy=rng.randn(B, T_mel).astype(np.float32),
        sids=np.zeros(B, np.int64), aids=np.zeros(B, np.int64),
        word_ids=np.zeros((B, T_text), np.int64),
    )
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def fs2_step_launches(T_mel: int):
    """Launches of each XL kernel in one FS2 training step: 6 encoder
    layers on K4 (forward and backward; the text stays within its 512
    frames), 6 decoder layers on K4 up to 512 padded frames, on K5
    (forward, bwd-q, bwd-kv) up to 1024, on K6 (the same three) beyond."""
    from viet_tts_torch.ops.flash_xl_attention import padded_time, xl3_padded_time

    counts = dict.fromkeys(XL_COUNTED, 0)
    counts["flash_xl3_fwd"] = counts["flash_xl3_bwd"] = 6
    if xl3_padded_time(T_mel) <= 512:
        counts["flash_xl3_fwd"] = counts["flash_xl3_bwd"] = 12
    else:
        kind = "xl2" if padded_time(T_mel) <= 1024 else "xl"
        for name in ("fwd", "bwd_q", "bwd_kv"):
            counts[f"flash_{kind}_{name}"] = 6
    return counts


def check_fs2_training_path(dev, steps: int = 3, warmup: int = 2):
    """``make_fs2_train_step`` at full width (every dropout as configured,
    MAS durations, CVAE, Postnet) on the bench.py batch at T_mel 1008
    (decoder on K5) and 512 (on K4): ``warmup`` then ``steps`` timed steps
    each, the XL kernels' launches zeroed before and read after the timed
    steps and held to the exact count per step; finite losses, the
    parameters changed; one bf16 mixed-precision step; then a small step
    on the card against the CPU."""
    from viet_tts_torch.train.steps import make_fs2_train_step

    model, crit, train_conf = build_fs2_train()
    n_params = sum(p.numel() for p in model.parameters())
    model.to(dev)
    state = fs2_state(model, train_conf)
    step = make_fs2_train_step(model, crit)
    rng = torch.Generator().manual_seed(SEED)
    wrappers = _xl_wrappers()
    before = _flat_params(model)
    launches = dict.fromkeys(XL_COUNTED, 0)
    figures = {}
    batches = {}
    for T_mel in FS2_TRAIN_T_MELS:
        batch = batches[T_mel] = fs2_batch(TRAIN_B, TRAIN_T_TEXT, T_mel, dev)
        for _ in range(warmup):
            step(state, batch, rng)
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, rng)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = {name: fn.launches for name, fn in wrappers.items()}
        expect = {k: n * steps for k, n in fs2_step_launches(T_mel).items()}
        if got != expect:
            raise AssertionError(f"FS2 training T_mel={T_mel}: launches {got}, expected {expect}")
        values = {k: v.item() for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"FS2 training T_mel={T_mel}: metrics {values}")
        for name in launches:
            launches[name] += got[name]
        med = sorted(times)[len(times) // 2]
        figures[T_mel] = {"step_s": med, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"FS2 training path T_mel={T_mel}: {n_params} parameters, batch B={TRAIN_B} "
            f"T_text={TRAIN_T_TEXT}; step host seconds {[round(x, 4) for x in times]} "
            f"(median {med:.4f}); peak {figures[T_mel]['peak_gb']:.2f} GB; launches over "
            f"{steps} steps {got}; metrics at step {state.step} {values}")
    changed = (before - _flat_params(model)).abs().max().item()
    if changed <= 0.0:
        raise AssertionError("FS2 training: the parameters did not change")

    mp_step = make_fs2_train_step(model, crit, mixed_precision=True)
    batch = batches[FS2_TRAIN_T_MELS[0]]
    mp_step(state, batch, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = mp_step(state, batch, rng)
    torch.cuda.synchronize()
    mp_s = time.perf_counter() - t0
    values = {k: v.item() for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        raise AssertionError(f"FS2 bf16 mixed-precision step: metrics {values}")
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError("FS2 bf16 mixed-precision step: master weights not fp32")
    figures["mixed_precision_s"] = mp_s
    log(f"FS2 bf16 mixed-precision step at T_mel={FS2_TRAIN_T_MELS[0]}: {mp_s:.4f} s, "
        f"metrics {values}; max parameter change over the phase {changed:.3e}")
    check_fs2_training_against_cpu(dev)
    return launches, figures, (step, state, batch, rng), batches[FS2_TRAIN_T_MELS[1]]


def check_fs2_training_against_cpu(dev, T_mel: int = 600):
    """One step at full width on a small batch (B=2, T_text=16; T_mel=600:
    encoder on K4, decoder on K5; T_mel=1040: decoder on K6), every dropout
    0 and the same CVAE noise, from the same weights, on the card (kernels)
    and on the CPU (plain versions): every loss and the gradient norm
    within rel 1e-3."""
    from viet_tts_torch.train.steps import make_fs2_train_step

    from viet_tts_torch.config import fastspeech2_params

    B, T_text = 2, 16
    z_dim = fastspeech2_params()["encoder_hidden"] // 2  # the CVAE's latent width
    gen = torch.Generator().manual_seed(5)
    eps = tuple(torch.randn(B, z_dim, generator=gen) for _ in range(2))
    results = []
    for device in (dev, torch.device("cpu")):
        model, crit, train_conf = build_fs2_train(zero_dropout=True)
        model.to(device)
        state = fs2_state(model, train_conf)
        step = make_fs2_train_step(model, crit)
        batch = fs2_batch(B, T_text, T_mel, device)
        state, metrics = step(state, batch, torch.Generator().manual_seed(0), cvae_eps=eps)
        results.append({**{k: v.item() for k, v in metrics.items()},
                        "grad_norm": state.grad_norm.item()})
    card, cpu = results
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    if max(rel.values()) > 1e-3:
        raise AssertionError(f"FS2 training step card vs CPU: {card} vs {cpu}, rel {rel}")
    log(f"FS2 training step card (kernels) vs CPU (plain), B={B} T_mel={T_mel}: max rel "
        f"diff {max(rel.values()):.3e} (tol 1e-3) over {sorted(rel)}")


# --------------------------------------------------------------------------
# phase 17: FS2 training past the xl2 route
# --------------------------------------------------------------------------


def check_fs2_long_training(dev, step, state, rng, steps: int = 3, warmup: int = 2):
    """``make_fs2_train_step`` (phase 10's model, optimizer and step, every
    dropout as configured) at B=4, T_text=128, T_mel=2048, a padded length
    above 1024: the decoder runs on K6 (fwd, bwd-q, bwd-kv), the encoder on
    K4. ``warmup`` then ``steps`` timed steps with the XL kernels' launches
    held exactly; finite losses, the parameters changed, peak memory; then
    one full-width step at T_mel 1040 on the card against the CPU."""
    model = state.module
    wrappers = _xl_wrappers()
    before = _flat_params(model)
    batch = fs2_batch(FS2_LONG_B, FS2_LONG_T_TEXT, FS2_LONG_T_MEL, dev)
    for _ in range(warmup):
        state, _ = step(state, batch, rng)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, rng)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = {name: fn.launches for name, fn in wrappers.items()}
    expect = {k: n * steps for k, n in fs2_step_launches(FS2_LONG_T_MEL).items()}
    if got != expect:
        raise AssertionError(f"FS2 training T_mel={FS2_LONG_T_MEL}: launches {got}, "
                             f"expected {expect}")
    values = {k: v.item() for k, v in metrics.items()}
    changed = (before - _flat_params(model)).abs().max().item()
    if not all(np.isfinite(v) for v in values.values()) or changed <= 0.0:
        raise AssertionError(f"FS2 training T_mel={FS2_LONG_T_MEL}: metrics {values}, "
                             f"parameter change {changed}")
    med = sorted(times)[len(times) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"FS2 training path B={FS2_LONG_B} T_text={FS2_LONG_T_TEXT} T_mel={FS2_LONG_T_MEL}: "
        f"step host seconds {[round(x, 4) for x in times]} (median {med:.4f}); peak "
        f"{peak_gb:.2f} GB; launches over {steps} steps {got}; metrics {values}; max "
        f"parameter change {changed:.3e}")
    check_fs2_training_against_cpu(dev, T_mel=1040)
    return got, {"step_s": med, "peak_gb": peak_gb}, (step, state, batch, rng)


# --------------------------------------------------------------------------
# phase 11: K7 (the JETS conformer's rel-pos attention) and K6 at D=128
# --------------------------------------------------------------------------

REL_H, REL_D = 2, 128  # config/model_config.yaml jets: adim 256, aheads 2
REL_E = REL_H * REL_D
SERVE_B, SERVE_T_MEL = 16, 1008  # OneStageTTS: 16 sentences, max_mel_frames
REL_REPLACES = {
    "flash_rel_fwd": "viet_tts_tpu/ops/pallas_attention.py:314",
    "flash_rel_bwd_q": "viet_tts_tpu/ops/pallas_attention.py:542",
    "flash_rel_bwd_kv": "viet_tts_tpu/ops/pallas_attention.py:577",
}


def rel_inputs(dev, B: int, T: int, seed: int):
    """One rel-pos attention's inputs (fp32, on the card), built as the
    conformer builds them: q, k, v, the biases and linear_pos drawn from a
    seed; g the rotated position queries; the negative half of the
    symmetric table."""
    from viet_tts_torch.nn.espnet_conformer import rel_positional_table
    from viet_tts_torch.ops.espnet_attention import neg_rel_table, rel_pos_queries_latest

    H, D, E = REL_H, REL_D, REL_E
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    u, w = 0.3 * f(H, D), 0.3 * f(H, D)
    pos_kernel = f(E, E) / np.sqrt(E)
    sym = torch.from_numpy(rel_positional_table(T, E)).to(dev)
    return dict(qc=q + u, k=k, v=v, g=rel_pos_queries_latest(q + w, pos_kernel),
                table=neg_rel_table(sym).contiguous())


def _rel_work(args, lens, T: int):
    """(bytes, FLOP) of each K7 kernel at these inputs: every input read
    once in its dtype (the cotangent in the stream dtype; pad, lse and
    delta in fp32), every output written once in fp32; the dot products
    over the live keys of each row: forward the [qc|g].[k|t] logits (D + E)
    and the weighted sum (D); bwd-q the logits, g_out . v, dqc and dg
    (3D + 2E). bwd-kv: the work of the kernel, which reads bwd-q's two fp32
    scratches (p m / keep and ds over the T x T pairs) with qc and g_out and
    forms dk and dv (two D-wide products a pair); and, as
    ``flash_rel_bwd_kv_function``, the function's own work from the
    streams (the logits, g_out . v, dk and dv: 4D + E)."""
    B, _, H, D = args[0].shape
    E = args[3].shape[-1]
    esz = args[0].element_size()
    row, stat, erow = B * T * H * D, B * H * T, B * T * H * E
    ins = sum(a.numel() * a.element_size() for a in args) + 4.0 * B * T
    pairs = 2.0 * H * T * float(np.sum(lens))
    bwd_in = ins + esz * row + 8.0 * stat
    return {"flash_rel_fwd": (ins + 4.0 * (row + stat), pairs * (2 * D + E)),
            "flash_rel_bwd_q": (bwd_in + 4.0 * (row + erow), pairs * (3 * D + 2 * E)),
            "flash_rel_bwd_kv": (2.0 * esz * row + 8.0 * B * H * T * T + 4.0 * 2 * row,
                                 pairs * 2 * D),
            "flash_rel_bwd_kv_function": (bwd_in + 8.0 * row, pairs * (4 * D + E))}


def _rel_pos(base, scale: float):
    """scale * the rel-pos position term g . table^T (B, H, T, T)."""
    return torch.einsum("bqhe,ke->bhqk", base["g"], base["table"]) * scale


def check_rel_kernels(dev, t_text: int):
    """K7 fwd, bwd-q and bwd-kv against their plain versions, fp32 (TF32
    off; each gradient within 1e-4, scaled by its largest value where that
    exceeds 1) and bf16 (2e-2), ragged lengths with a fully padded row and
    no pad mask: the forward at the serving shapes (16, text bucket) and
    (16, 1008), the three kernels at the training shapes (8, 64) and
    (8, 512) with dropout 0 and 0.2 (bwd-kv with the table's gradient too);
    K6's forward at D=128, E=256 (the legacy rel-pos route) at the serving
    shapes. Times of the kernel, the plain version and SDPA with the
    position term as its mask. Returns (the K7 kernel-line entries, K6's
    figures at the JETS width)."""
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_rel_attention as fr
    from viet_tts_torch.ops import flash_xl_attention as fx

    scale = REL_D ** -0.5
    names = ("qc", "k", "v", "g", "table")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_fp32")
    serve = dict.fromkeys(keys, 0.0)
    per_shape = {}  # the tensor-core kernels' figures a launch at each shape
    step = {n: dict.fromkeys(keys, 0.0) for n in REL_REPLACES}
    errs = dict.fromkeys(REL_REPLACES, 0.0)
    kinds = {n: set() for n in REL_REPLACES}
    k6 = {}
    # (B, T, layers a call or step, training?)
    cases = [(SERVE_B, t_text, 4, False), (SERVE_B, SERVE_T_MEL, 6, False),
             (TRAIN_B, TRAIN_T_TEXT, 4, True), (TRAIN_B, TRAIN_T_MEL, 6, True)]
    for B, T, n_layers, training in cases:
        base = rel_inputs(dev, B, T, seed=T + B)
        rng = np.random.RandomState(T + 3)
        lens = rng.randint(1, T + 1, B)
        lens[0], lens[-1] = T, 0  # one full row, one fully padded row
        ragged = (torch.arange(T)[None] >= torch.from_numpy(lens)[:, None]).to(dev)
        gout = torch.randn(B, T, REL_H, REL_D, generator=torch.Generator().manual_seed(T)).to(dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = [base[n].to(dtype) for n in names]
            peak = FP32_FLOP_PER_MS if dtype == torch.float32 else BF16_FLOP_PER_MS
            for pad, pad_name, live in ((ragged, "ragged", lens),
                                        (None, "no pad mask", np.full(B, T))):
                padf = pad.float() if pad is not None else torch.zeros(B, T, device=dev)
                for p in ((0.0, ATTN_DROPOUT) if training else (0.0,)):
                    seed = 104729 * T + int(p * 10)
                    ctx, lse = fr.rel_fwd(*args, scale, pad, p, seed)
                    ref, ref_lse = fr.rel_fwd_plain(*args, scale, pad, p, seed)
                    lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                    err = {"flash_rel_fwd": ((ctx - ref).abs().max().item(),) * 2}
                    del ref, ref_lse
                    bargs = None
                    if training:
                        delta, gs = fa.backward_inputs(ctx, gout, dtype)
                        bargs = (*args, padf, lse, delta, gs, scale, p, seed)
                        for name, kern, plain, kw in (
                                ("flash_rel_bwd_q", fr.rel_bwd_dq, fr.rel_bwd_dq_plain, {}),
                                ("flash_rel_bwd_kv", fr.rel_bwd_dkv, fr.rel_bwd_dkv_plain,
                                 {"want_dtab": True})):
                            got, want = kern(*bargs, **kw), plain(*bargs, **kw)
                            torch.cuda.synchronize()
                            if not all(torch.isfinite(x).all() for x in got):
                                raise AssertionError(f"{name} T={T}: gradient not finite")
                            err[name] = _max_err(got, want)
                            del got, want
                    label = f"K7 (B={B}, T={T}) {str(dtype)[6:]} {pad_name} dropout={p}"
                    bad = {n: e for n, e in err.items() if e[1] > tol}
                    if bad or not torch.isfinite(ctx).all() or lse_err > 1e-5:
                        raise AssertionError(f"{label}: max abs err (abs, scaled) {err} "
                                             f"(tol {tol}), lse rel err {lse_err}")
                    log(f"{label}: " + ", ".join(
                        f"{n} {e[0]:.3e} (scaled {e[1]:.3e})" for n, e in err.items())
                        + f" (tol {tol}); lse {lse_err:.1e}")
                    if dtype == torch.float32:
                        for n, e in err.items():
                            errs[n] = max(errs[n], e[0])
                    # the kernel line: fp32; serving with the pad mask (the
                    # path passes one), training with dropout and no pad
                    # mask (the bench.py batch has full lengths)
                    timed_case = dtype == torch.float32 and (
                        (not training and pad is not None)
                        or (training and pad is None and p == ATTN_DROPOUT))
                    if not timed_case:
                        continue
                    iters = 20 if T <= 512 else 5
                    build_ms, lib_fwd, lib_bwd = _library_sdpa(_rel_pos, base, pad, scale, dtype,
                                                              p, gout)
                    to_time = {"flash_rel_fwd": (
                        lambda: fr.rel_fwd(*args, scale, pad, p, seed),
                        lambda: fr.rel_fwd_plain(*args, scale, pad, p, seed), lib_fwd)}
                    stages = None
                    if training:
                        to_time["flash_rel_bwd_q"] = (lambda: fr.rel_bwd_dq(*bargs),
                                                      lambda: fr.rel_bwd_dq_plain(*bargs),
                                                      lib_bwd)
                        # bwd-kv: the kernel alone on the scratches of one Q1
                        stages = _bwd_kv_stages("rel", bargs)
                        to_time["flash_rel_bwd_kv"] = (stages["kernel"], stages["plain"],
                                                       lib_bwd)
                        errs["flash_rel_bwd_kv"] = max(errs["flash_rel_bwd_kv"],
                                                       stages["err"][0])
                    work = _rel_work(args, live, T)
                    l_bwd = (bwd_ms(lib_bwd, iters, f"SDPA backward rel (B={B}, T={T})")
                             if training else None)
                    for name, (k_fn, p_fn, l_fn) in to_time.items():
                        backward = l_fn is lib_bwd
                        k_ms, k_ev = (bwd_ms(k_fn, iters, f"{name} (B={B}, T={T})") if backward
                                      else (cuda_ms(k_fn, iters), None))
                        p_ms = cuda_ms(p_fn, 3, warmup=1)
                        l_ms, l_ev = l_bwd if backward else (cuda_ms(l_fn, iters), None)
                        nbytes, flops = work[name]
                        b32, kind_32 = bound(nbytes, flops, peak)
                        b_ms, kind_b = (_tensor_core_bound(nbytes, flops, dtype)
                                        if name in TC_REDESIGNED else (b32, kind_32))
                        log(f"  {name} (B={B}, T={T}): kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                            f"library_ms {l_ms:.4f} (mask built in {build_ms:.1f} ms) bound_ms "
                            f"{b_ms:.4f} ({kind_b}) {flops / k_ms / 1e9:.2f} TFLOP/s; "
                            f"x{n_layers} a {'step' if training else 'call'}"
                            + _events_note(k_ev, l_ev))
                        acc = step[name] if training else serve
                        if name in TC_REDESIGNED:
                            pos_grad = (_library_pos_grad(base, pad, scale, dtype, p, gout,
                                                          rel=True)
                                        if name.endswith("_bwd_q") else None)
                            tc = _tensor_core_figures(f"{name} (B={B}, T={T})", k_ms, b_ms,
                                                      nbytes, flops, pos_grad, iters)
                            del pos_grad
                            if name == "flash_rel_bwd_kv":
                                tc.update(_bwd_kv_figures(f"{name} (B={B}, T={T})", stages,
                                                          work["flash_rel_bwd_kv_function"],
                                                          iters))
                                # bwd-q's yardstick of the same function, beside whole_ms
                                for key in ("library_ms_pos_grad",
                                            "library_ms_pos_grad_cuda_events"):
                                    tc[key] = per_shape["flash_rel_bwd_q"][
                                        f"({B}, {T}) training"][key]
                                for key in ("q1_ms", "q1_with_p_ms", "whole_ms",
                                            "q1_ms_cuda_events", "q1_with_p_ms_cuda_events",
                                            "whole_ms_cuda_events", "bound_ms_function",
                                            "bound_ms_function_3xtf32"):
                                    acc[key] = acc.get(key, 0.0) + n_layers * tc[key]
                            per_shape.setdefault(name, {})[
                                f"({B}, {T})" + (" training" if training else "")] = dict(
                                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                                bound_by=kind_b, **tc)
                            for key in ("library_ms_pos_grad", "library_ms_pos_grad_cuda_events"):
                                if key in tc:
                                    acc[key] = acc.get(key, 0.0) + n_layers * tc[key]
                        for key, val in zip(keys, (k_ms, p_ms, l_ms, b_ms, b32)):
                            acc[key] += n_layers * val
                        if backward:
                            for key, val in zip(EVENT_KEYS, (k_ev, l_ev)):
                                acc[key] = acc.get(key, 0.0) + n_layers * val
                        kinds[name].add(kind_b)
                    del stages
            del args
        if not training:  # K6 at the JETS width: the legacy rel-pos route
            xl = xl_inputs(dev, B, T, seed=T + 11, H=REL_H, D=REL_D)
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                xargs = [xl[n].to(dtype) for n in ("qc", "k", "v", "gA", "gB", "table")]
                lse_tol = 1e-5 if dtype == torch.float32 else 1e-3
                for pad in (ragged, None):
                    ctx, lse = fx.xl_fwd(*xargs, scale, pad)
                    ref, ref_lse = fx.xl_fwd_plain(*xargs, scale, pad)
                    e = (ctx - ref).abs().max().item()
                    le = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                    if not (torch.isfinite(ctx).all() and e <= tol and le <= lse_tol):
                        raise AssertionError(f"K6 at D=128 (B={B}, T={T}) {dtype}: "
                                             f"max_abs_err {e} (tol {tol}), lse rel err {le} "
                                             f"(tol {lse_tol})")
                    if dtype == torch.float32:
                        k6["max_abs_err"] = max(k6.get("max_abs_err", 0.0), e)
                    del ref, ref_lse
                if dtype == torch.float32 and T == SERVE_T_MEL:
                    k_ms = cuda_ms(lambda: fx.xl_fwd(*xargs, scale, ragged), 5)
                    p_ms = cuda_ms(lambda: fx.xl_fwd_plain(*xargs, scale, ragged), 3, warmup=1)
                    build_ms, lib_fwd, _ = _library_sdpa(_xl_pos, xl, ragged, scale, dtype,
                                                         0.0, gout)
                    l_ms = cuda_ms(lib_fwd, 5)
                    nbytes, flops = _xl_work("xl", xargs, lens, T)
                    b_ms, kind_b = _tensor_core_bound(nbytes, flops, dtype)
                    tc = _tensor_core_figures("flash_xl_fwd at D=128", k_ms, b_ms, nbytes,
                                              flops)
                    k6.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                              bound_by=kind_b, library_mask_build_ms=build_ms, **tc,
                              per=f"one launch at (B={B}, H={REL_H}, T={T}, D={REL_D}, "
                                  f"E={REL_E}), fp32, ragged pad mask")
                    del lib_fwd
                del xargs
            log(f"K6 at D=128, E=256 (B={B}, T={T}): fp32 and bf16, ragged and no pad "
                f"mask, within tolerance; {k6}")
            del xl
        del base
        torch.cuda.empty_cache()
    per_serve = (f"one OneStageTTS.__call__ of {SERVE_B} sentences, fp32 (4 calls at "
                 f"({SERVE_B}, {t_text}) + 6 at ({SERVE_B}, {SERVE_T_MEL}), H={REL_H}, "
                 f"D={REL_D}, E={REL_E}, ragged pad mask)")
    per_step = (f"one training step, fp32, attention dropout {ATTN_DROPOUT} (4 calls at "
                f"({TRAIN_B}, {TRAIN_T_TEXT}) + 6 at ({TRAIN_B}, {TRAIN_T_MEL}), H={REL_H}, "
                f"D={REL_D}, E={REL_E})")
    entries = {}
    for name, replaces in REL_REPLACES.items():
        fig = serve if name == "flash_rel_fwd" else step[name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": {"flash_rel_fwd": "viet_tts_torch/csrc/flash_xl_attention.cu",
                       "flash_rel_bwd_q": "viet_tts_torch/csrc/flash_xl_attention_bwd.cu",
                       "flash_rel_bwd_kv": "viet_tts_torch/csrc/flash_xl_attention_bwd.cu"}[name],
            "replaces": replaces, "max_abs_err": errs[name], "tol": 1e-4,
            "bound_by": "operations" if "operations" in kinds[name] else "bytes",
            "per": per_serve if name == "flash_rel_fwd" else per_step,
            "library": ("F.scaled_dot_product_attention with scale * g.table^T as an "
                        "additive mask" + ("" if name == "flash_rel_fwd" else
                                           ", backward (dq, dk and dv together) on a "
                                           "retained graph")),
            **({} if name == "flash_rel_fwd" else {"timing": BWD_TIMING}),
            **fig}
    entries["flash_rel_fwd"]["train_step"] = {"per": per_step, **step["flash_rel_fwd"]}
    for name, shapes in per_shape.items():
        entries[name]["per_shape"] = shapes
    for entry in entries.values():
        if entry["name"] not in TC_REDESIGNED:
            del entry["bound_ms_fp32"]  # the CUDA-core kernels' bound_ms is that bound
    return entries, k6


# --------------------------------------------------------------------------
# phase 12: JETS-conformer serving
# --------------------------------------------------------------------------

CONFORMER_HP = {"encoder_type": "conformer", "decoder_type": "conformer"}
# the attention kernels of each rel-pos flavour: K7 ("latest"), K6 ("legacy")
JC_KERNELS = {"latest": ("flash_rel_fwd", "flash_rel_bwd_q", "flash_rel_bwd_kv"),
              "legacy": ("flash_xl_fwd", "flash_xl_bwd_q", "flash_xl_bwd_kv")}


def _conformer_hp(flavour: str):
    return dict(CONFORMER_HP, conformer_rel_pos_type=flavour)


def _jc_label(flavour: str) -> str:
    return "JETS-conformer" + ("" if flavour == "latest" else " (legacy rel-pos)")


def _jc_wrappers():
    from viet_tts_torch.ops import flash_attention as fa
    from viet_tts_torch.ops import flash_rel_attention as fr
    from viet_tts_torch.ops import flash_xl_attention as fx
    from viet_tts_torch.ops import fused_mrf as fm

    return {"flash_rel_fwd": fr.rel_fwd, "flash_rel_bwd_q": fr.rel_bwd_dq,
            "flash_rel_bwd_kv": fr.rel_bwd_dkv, "flash_xl_fwd": fx.xl_fwd,
            "flash_xl_bwd_q": fx.xl_bwd_dq, "flash_xl_bwd_kv": fx.xl_bwd_dkv,
            "fused_mrf_stage": fm.fused_mrf_stage, "flash_attention_fwd": fa.attention_fwd,
            "flash_attention_bwd_q": fa.attention_bwd_dq,
            "flash_attention_bwd_kv": fa.attention_bwd_dkv}


def _counts():
    return {name: fn.launches for name, fn in _jc_wrappers().items()}


def build_conformer_checkpoint(ckpt_dir: str, flavour: str = "latest") -> str:
    """Full-width JETS with espnet rel-pos conformer stacks of the given
    flavour (config/model_config.yaml:234-326 with encoder_type /
    decoder_type conformer: adim 256, 2 heads, 4 + 6 layers, conv kernels
    7 / 31, macaron, conv1d FFN, GST, HiFi-GAN V1), flash attention, seeded
    random weights, saved as a port checkpoint."""
    from viet_tts_torch.infer.api import default_conf, save_checkpoint
    from viet_tts_torch.models.jets import JETS
    from viet_tts_torch.nn.utils import seeded_init_
    from viet_tts_torch.text import NUM_SYMBOLS

    conf = default_conf()
    hp = conf["models"]["jets"]["generator_params"]
    hp.update(_conformer_hp(flavour), attn_implementation="flash")
    model = JETS(NUM_SYMBOLS, conf["audio"]["mel"]["channels"], hp)
    seeded_init_(model, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for up in model.generator.upsamples:  # audio-scale output (see phase 5)
            up[1].weight_g.fill_(1.0)
    log(f"{_jc_label(flavour)} full width: {sum(p.numel() for p in model.parameters())} "
        f"parameters, adim {hp['adim']}, {hp['aheads']} heads, {hp['elayers']} + "
        f"{hp['dlayers']} conformer layers ({hp['conformer_rel_pos_type']} rel-pos, conv k="
        f"{hp['conformer_enc_kernel_size']} / {hp['conformer_dec_kernel_size']})")
    save_checkpoint(ckpt_dir, model, conf)
    return ckpt_dir


def check_conformer_serving(dev, ckpt_dir: str, flavour: str = "latest"):
    """OneStageTTS on the conformer checkpoint: 16 sentences in fp32 and in
    bf16, then the HTTP server; every call's launches held (the flavour's
    attention forward, K7 or K6, 10 = 4 encoder + 6 decoder layers, K2 18,
    no other attention kernel and no backward); the host median of 5 fp32
    calls; a small input on the card against the CPU."""
    from viet_tts_torch.infer.api import OneStageTTS
    from viet_tts_torch.infer.server import serve

    name = _jc_label(flavour)
    fwd_name = JC_KERNELS[flavour][0]
    tts = OneStageTTS(ckpt_dir, fused_vocoder=True)
    tts_half = OneStageTTS(ckpt_dir, fused_vocoder=True, half=True)
    for model in (tts, tts_half):  # warm-up: cuDNN autotune, allocator
        model(SENTENCES[:2])
    torch.cuda.synchronize()
    per_call = dict.fromkeys(_jc_wrappers(), 0)
    per_call.update({fwd_name: 10, "fused_mrf_stage": K2_PER_CALL})
    for fn in _jc_wrappers().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n = len(SENTENCES)
    waves, call_s = _counted_call(lambda: tts(SENTENCES), per_call,
                                  f"{name} fp32 __call__({n})", _counts)
    waves_half, half_s = _counted_call(lambda: tts_half(SENTENCES), per_call,
                                       f"{name} bf16 __call__({n})", _counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_waves(waves, len(SENTENCES), f"{name} fp32")
    _check_waves(waves_half, len(SENTENCES), f"{name} bf16")
    before = _counts()
    httpd = serve(tts, port=0, model_name="JETS")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            codes = [r.status]
            health = json.load(r)
        # random weights may give a sentence no frame at all: use the one
        # with the most
        longest = SENTENCES[int(np.argmax([w.size for w in waves]))]
        code, body = post(f"{base}/synthesize", {"text": longest})
        codes.append(code)
        if body[:4] != b"RIFF":
            raise AssertionError(f"{name} /synthesize did not return a WAV")
        t0 = time.perf_counter()
        code, stream_body = post(f"{base}/synthesize_stream", {"text": longest})
        stream_s = time.perf_counter() - t0
        codes.append(code)
    finally:
        httpd.shutdown()
        httpd.server_close()
    server = {k: v - before[k] for k, v in _counts().items()}
    if codes != [200] * 3 or health.get("status") != "ok":
        raise AssertionError(f"{name} HTTP codes {codes}, health {health}")
    if len(stream_body) % 2 or not stream_body:
        raise AssertionError(f"{name} /synthesize_stream returned no PCM")
    # one /synthesize (a batch of one) and one stream (its acoustic half
    # once, then one vocoder window per chunk)
    others = [k for k in server if k not in (fwd_name, "fused_mrf_stage") and server[k]]
    if (server[fwd_name] != 20 or server["fused_mrf_stage"] < 2 * K2_PER_CALL
            or server["fused_mrf_stage"] % K2_PER_CALL or others):
        raise AssertionError(f"{name} server launches {server}")
    launches = _counts()
    log(f"{name} serving: peak {peak_gb:.2f} GB; server HTTP {codes}, "
        f"/synthesize_stream {stream_s:.3f} s, {len(stream_body) // 2} samples, launches "
        f"{server}; over the phase {launches}; mel frames per sentence "
        f"{[w.size // 256 for w in waves]}")

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts(SENTENCES)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    log(f"{name} fp32 __call__({n}): host median of 5 {med:.4f} s "
        f"({[round(x, 4) for x in times]}); bf16 call {half_s:.4f} s")

    cpu_model = copy.deepcopy(tts.model).to("cpu")
    ids, lens, _ = tts.encode_texts(SENTENCES[:2])
    sids = torch.zeros(2, dtype=torch.int64)
    frames = 64
    wav_gpu, len_gpu = tts.model.inference(sids.to(dev), torch.as_tensor(ids, device=dev),
                                           torch.as_tensor(lens, device=dev), frames)
    wav_cpu, len_cpu = cpu_model.inference(sids, torch.as_tensor(ids), torch.as_tensor(lens),
                                           frames)
    err = (wav_gpu.cpu() - wav_cpu).abs().max().item()
    if not torch.equal(len_gpu.cpu(), len_cpu) or err > 1e-3:
        raise AssertionError(f"{name} card vs CPU: lengths {len_gpu.tolist()} vs "
                             f"{len_cpu.tolist()}, max_abs_err {err}")
    log(f"{name} card (kernels) vs CPU (plain) on 2 sentences x {frames} frames: "
        f"max_abs_err {err:.3e} (tol 1e-3), peak |wav| {wav_cpu.abs().max().item():.3f}")
    return launches, tts, {"call_s": med, "half_s": half_s, "peak_gb": peak_gb}


# --------------------------------------------------------------------------
# phase 13: the JETS-conformer training step
# --------------------------------------------------------------------------


def check_conformer_training(dev, flavour: str = "latest", steps: int = 3, warmup: int = 2):
    """``make_jets_train_step`` on the full-width JETS-conformer of the given
    rel-pos flavour and the full MSMPD (every dropout as configured,
    attention 0.2 inside K7 or K6) with the bench.py batch (B=8, T_text=64,
    T_mel=512): ``warmup`` then ``steps`` timed steps with the launches
    held exactly (the flavour's fwd, bwd-q and bwd-kv 10 each a step, no
    other attention kernel), finite metrics, both models changed, peak
    memory; then one small full-width step on the card against the CPU."""
    from viet_tts_torch.config import jets_lambdas
    from viet_tts_torch.train.gan import make_jets_train_step

    name = _jc_label(flavour)
    model, disc, mel_loss, train_conf, hop = build_gan(_conformer_hp(flavour))
    model.to(dev)
    disc.to(dev)
    gen_state, disc_state = gan_states(model, disc, train_conf)
    step = make_jets_train_step(model, disc, mel_loss, jets_lambdas(train_conf), hop)
    batch = synthetic_batch(TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL, hop, dev)
    rng = torch.Generator().manual_seed(SEED)
    before = (_flat_params(model), _flat_params(disc))
    for _ in range(warmup):
        step(gen_state, disc_state, batch, rng)
    torch.cuda.synchronize()
    for fn in _jc_wrappers().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        gen_state, disc_state, metrics = step(gen_state, disc_state, batch, rng)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = dict.fromkeys(launches, 0)
    expect.update(dict.fromkeys(JC_KERNELS[flavour], 10 * steps))
    if launches != expect:
        raise AssertionError(f"{name} training launches {launches}, expected {expect}")
    values = {k: v.item() for k, v in metrics.items()}
    changed = [(a - b).abs().max().item() for a, b in
               zip(before, (_flat_params(model), _flat_params(disc)))]
    if not all(np.isfinite(v) for v in values.values()) or min(changed) <= 0.0:
        raise AssertionError(f"{name} metrics {values}, parameter change {changed}")
    median = sorted(times)[len(times) // 2]
    log(f"{name} training: {sum(p.numel() for p in model.parameters())} parameters, "
        f"batch B={TRAIN_B} T_text={TRAIN_T_TEXT} T_mel={TRAIN_T_MEL}; step host seconds "
        f"{[round(x, 4) for x in times]} (median {median:.4f}); peak {peak_gb:.2f} GB; "
        f"launches over {steps} steps {launches}; metrics {values}; max parameter change "
        f"gen {changed[0]:.3e} disc {changed[1]:.3e}")
    check_training_against_cpu(dev, _conformer_hp(flavour))
    return launches, {"step_s": median, "peak_gb": peak_gb}, (step, gen_state, disc_state,
                                                              batch, rng)


# --------------------------------------------------------------------------
# --profile: where the time of one __call__ and of one training step goes
# --------------------------------------------------------------------------

# kernel-name fragments -> the layer each kernel belongs to (first match wins)
KERNEL_GROUPS = (
    # K1: the forward template's instances with no position term
    # (<dtype, D, 3, warps>), ahead of K6's catch-all below
    ("K1 xl2_fwd_kernel (tensor cores, no position term)",
     tuple(f"xl2_fwd_kernel<{t}, {d}, 3," for t in ("float", "__nv_bfloat16")
           for d in (32, 64, 128))),
    ("K2 mrf_pair_kernel (tensor cores)", ("mrf_pair_kernel",)),
    ("K4 xl3_fwd_band_kernel (tensor cores)", ("xl3_fwd_band_kernel",)),
    # K4 bwd: its ds kernel, its instance of bwd-kv (<dtype, D, true>) and
    # the reduce pass
    ("K4 bwd (xl3_bwd_ds, xl2_bwd_kv<., ., 1>, xl3_bwd_reduce)",
     ("xl3_bwd_", *(f"xl2_bwd_kv_kernel<{t}, {d}, 1>" for t in ("float", "__nv_bfloat16")
                    for d in (48, 64)))),
    # K7 bwd-q's own instances: position kind 2 (Q1 pos, Q2)
    ("K7 bwd-q Q1 pos / Q2 (xl2_bwd_q1_pos<., 2>, q2<., 2>)",
     tuple(f"{k}<{t}, 2>" for t in ("float", "__nv_bfloat16")
           for k in ("xl2_bwd_q1_pos_kernel", "xl2_bwd_q2_kernel"))),
    # K3's instances: Q1 ds with no position term (<dtype, D, P write, 3>)
    # and bwd-kv on its scratches (<dtype, D, 2>), ahead of the D = 128
    # groups below, whose Q1 ds prefix would catch them too
    ("K3a Q1 ds (q1_ds<., ., ., 3>: dq, and the ds and P scratches)",
     tuple(f"xl2_bwd_q1_ds_kernel<{t}, {d}, {w}, 3>" for t in ("float", "__nv_bfloat16")
           for d in (32, 64, 128) for w in ("true", "false"))),
    ("K3b bwd-kv (xl2_bwd_kv<., ., 2>, on K3's scratches)",
     tuple(f"xl2_bwd_kv_kernel<{t}, {d}, 2>" for t in ("float", "__nv_bfloat16")
           for d in (32, 64, 128))),
    # Q1 ds and bwd-kv at D = 128 are one instance each for K7 and K6's
    # legacy flavour (both with the P write): the JETS-conformer step of
    # each flavour runs only its own, and each step is profiled on its own
    ("D=128 bwd-q Q1 ds (q1_ds<., 128, true, 0>: K7 latest, K6 legacy step)",
     tuple(f"xl2_bwd_q1_ds_kernel<{t}, 128," for t in ("float", "__nv_bfloat16"))),
    ("D=128 bwd-kv (xl2_bwd_kv<., 128, 0>: K7 latest, K6 legacy step; K7 dtab)",
     tuple(f"{k}<{t}, {a}>" for t in ("float", "__nv_bfloat16")
           for k, a in (("xl2_bwd_kv_kernel", "128, 0"), ("xl2_bwd_dtab_kernel", "2")))),
    # bwd-q's other kernels are K5's and K6's alike (a step runs one of the
    # two); K5 adds the rotation pass (before its forward and its bwd-q) and
    # the inverse rotation after bwd-q
    ("K5 rotation pass (xl2_rotate: before fwd and bwd-q)", ("xl2_rotate_kernel",)),
    ("K5 / K6 bwd-q Q1 (xl2_bwd_q1_pos + q1_ds)", ("xl2_bwd_q1_",)),
    ("K5 / K6 bwd-q Q2 (xl2_bwd_q2; K5 + unrotate)", ("xl2_bwd_q2_", "xl2_bwd_unrotate")),
    # bwd-kv and dtab are K5's and K6's alike too
    ("K5 / K6 bwd-kv (xl2_bwd_kv, from Q1's scratches; dtab)", ("xl2_bwd_kv_kernel",
                                                                 "xl2_bwd_dtab")),
    # the forward's instances: <dtype, D, the position term (0 K6, 1 K5,
    # 2 K7, 3 K1), warps a block>
    ("K5 xl2_fwd_kernel (tensor cores; after the rotation pass)",
     tuple(f"xl2_fwd_kernel<{t}, {d}, 1," for t in ("float", "__nv_bfloat16")
           for d in (48, 64))),
    ("K7 xl2_fwd_kernel (tensor cores, rel-pos at every key)",
     tuple(f"xl2_fwd_kernel<{t}, 128, 2," for t in ("float", "__nv_bfloat16"))),
    ("K6 xl2_fwd_kernel (tensor cores, two streams)", ("xl2_fwd_kernel",)),
    ("cuBLAS matmul (attention projections, GST, STFT-mel)", ("cublas", "gemv", "sgemm")),
    ("cuDNN (convs: vocoder, discriminators, FFN, predictors)", ("cudnn",)),
)
OTHER = "other kernels (elementwise, norms, copies, reductions, FFT)"


# --------------------------------------------------------------------------
# phase 18: the FS2 trainer (python -m viet_tts_torch.train --task fastspeech2)
# --------------------------------------------------------------------------

TRAINER_WORDS = (
    "xin chào các bạn tôi là một hệ thống tổng hợp tiếng nói hôm nay "
    "trời đẹp quá chúng ta cùng nhau học tập và làm việc thật tốt").split()
TRAINER_SPEAKERS = ("hn_spk", "hcm_spk")
# ~172 and ~646 mel frames: mel buckets 256 (decoder on K4) and 768 (on K5)
TRAINER_SECONDS = (2.0, 7.5)
TRAINER_UTTS = 12  # a speaker: 11 train, 1 test (the filelist's 95 / 5 split)
TRAINER_ITERS = (6, 8)  # the first run, then the resumed run
TRAINER_ROOT = os.path.join(REPO, "build", "chip_smoke_trainer")
# config/model_config.yaml's JETS dropout rates, as written there
JETS_CONFIG_DROPOUT = tuple(
    [(f"transformer_{kind}_{rate}", "0.2") for kind in ("enc", "dec")
     for rate in ("dropout_rate", "positional_dropout_rate", "attn_dropout_rate")]
    + [("pitch_predictor_dropout", "0.5"), ("energy_predictor_dropout", "0.5")])


def _fresh_dir(root: str) -> str:
    if os.path.exists(root):
        import shutil

        shutil.rmtree(root)
    return root


def write_trainer_dataset(root: str, n_utts: int, seconds, seed: int):
    """``<root>/data/<speaker>/{metadata.csv, wavs/}`` and
    ``<root>/egs/{speakers, accents}.json``: five-word sentences over a
    voiced tone with a 3 Hz tremolo and noise, written with the port's
    ``dsp.audio.write_wav``, lengths cycling through ``seconds``; the accent
    is the file name's prefix. Returns (data_dir, egs_dir)."""
    from viet_tts_torch.dsp.audio import write_wav

    rng = np.random.RandomState(seed)
    sr = 22050
    data_dir, egs_dir = os.path.join(root, "data"), os.path.join(root, "egs")
    os.makedirs(egs_dir, exist_ok=True)
    for spk in TRAINER_SPEAKERS:
        wav_dir = os.path.join(data_dir, spk, "wavs")
        os.makedirs(wav_dir, exist_ok=True)
        accent = spk.split("_")[0]
        rows = []
        for i in range(n_utts):
            t = np.arange(int(sr * seconds[i % len(seconds)])) / sr
            f0 = 110 + 80 * rng.rand()
            wav = 0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
            wav += 0.01 * rng.randn(len(t))
            name = f"{accent}-{i:04d}.wav"
            write_wav(os.path.join(wav_dir, name), wav.astype(np.float32), sr)
            rows.append(f"{name}|{' '.join(rng.choice(TRAINER_WORDS, 5))}")
        with open(os.path.join(data_dir, spk, "metadata.csv"), "w", encoding="utf8") as f:
            f.write("\n".join(rows))
    with open(os.path.join(egs_dir, "speakers.json"), "w") as f:
        json.dump({spk: i for i, spk in enumerate(TRAINER_SPEAKERS)}, f)
    with open(os.path.join(egs_dir, "accents.json"), "w") as f:
        json.dump({"hn": 0, "hcm": 1}, f)
    return data_dir, egs_dir


def _edit_section(text: str, section: str, edits) -> str:
    """``edits`` ((old, new) line pairs) applied inside the top-level
    ``section:`` block of a YAML file's text."""
    lines = text.split("\n")
    start = lines.index(f"{section}:")
    end = next((i for i in range(start + 1, len(lines))
                if lines[i] and not lines[i][0].isspace() and not lines[i].startswith("#")),
               len(lines))
    block = "\n".join(lines[start:end])
    for old, new in edits:
        if old not in block:
            raise AssertionError(f"config edit: {old!r} not in section {section}")
        block = block.replace(old, new)
    return "\n".join(lines[:start] + block.split("\n") + lines[end:])


def trainer_config(root: str, zero_dropout: bool = False, batch_size: int = 8) -> str:
    """A copy of ``config/`` whose FastSpeech2 section and JETS generator
    params gain ``attn_implementation: flash`` (the file's own
    recommendation for training), edited as text (the card has no pyyaml);
    ``log_step`` 1; optionally every dropout 0 (JETS's duration predictor's,
    which the file leaves to the model's default, added) and another batch
    size. Read back through the port's reader and checked."""
    from viet_tts_torch.config import JETS_DROPOUT_KEYS, build_config

    out = os.path.join(root, "config")
    os.makedirs(out, exist_ok=True)
    for name in ("preprocessing_config.yaml", "model_config.yaml", "train_config.yaml"):
        with open(os.path.join(REPO, "config", name), encoding="utf8") as f:
            text = f.read()
        if name == "model_config.yaml":
            edits = [("fastspeech2:\n", "fastspeech2:\n  attn_implementation: flash\n")]
            if zero_dropout:
                edits += [("encoder_dropout: 0.1", "encoder_dropout: 0.0"),
                          ("decoder_dropout: 0.1", "decoder_dropout: 0.0"),
                          ("      dropout: 0.5", "      dropout: 0.0")]
            text = _edit_section(text, "fastspeech2", edits)
            jets_edits = [("  generator_params:\n",
                           "  generator_params:\n    attn_implementation: flash\n")]
            if zero_dropout:
                jets_edits += [(f"    {key}: {rate}", f"    {key}: 0.0")
                               for key, rate in JETS_CONFIG_DROPOUT]
                jets_edits += [("    init_type:", "    duration_predictor_dropout_rate: 0.0\n"
                                                 "    init_type:")]
            text = _edit_section(text, "jets", jets_edits)
        elif name == "train_config.yaml":
            text = text.replace("\nlog_step: 100\n", "\nlog_step: 1\n").replace(
                "\nbatch_size: 8\n", f"\nbatch_size: {batch_size}\n")
        with open(os.path.join(out, name), "w", encoding="utf8") as f:
            f.write(text)
    conf = build_config(out)
    hp = conf["models"]["fastspeech2"]
    bc = hp["building_block"]["conformer"]
    drop = 0.0 if zero_dropout else None
    if (hp["attn_implementation"] != "flash" or conf["train"]["log_step"] != 1
            or conf["train"]["batch_size"] != batch_size
            or (drop is not None and (bc["encoder_dropout"], bc["decoder_dropout"],
                                      hp["variance"]["variance_predictor"]["dropout"])
                != (drop, drop, drop))):
        raise AssertionError(f"trainer config copy not as edited: {hp}")
    jets = conf["models"]["jets"]["generator_params"]
    if jets["attn_implementation"] != "flash" or (drop is not None and any(
            jets[key] != drop for key in JETS_DROPOUT_KEYS if key in jets)) or (
            drop is not None and jets["duration_predictor_dropout_rate"] != drop):
        raise AssertionError(f"trainer config copy's JETS params not as edited: {jets}")
    return out


class _StepProbe:
    """Wraps a trainer's ``train_step``: the launch counts of ``wrappers()``
    (name -> kernel wrapper) zeroed before each step and read after it (the
    device synchronised), with the batch's padded lengths, the host seconds
    of the step, the data wait that came before it, each state's learning
    rate and the losses; the weights of each state's module before the
    first step; and the host seconds of each epoch end's parameter
    histograms. The step's arguments are its train states (one, or the
    generator's and the discriminator's), then the batch, then the rest.
    With ``grads_of``, each step also keeps (on the host) the gradient the
    first state's module was stepped with, of each parameter whose name
    holds that string."""

    def __init__(self, trainer, wrappers=None, sync: bool = True,
                 zero_postnet_dropout: bool = False, grads_of: Optional[str] = None):
        self.steps = []
        self.grads_of = grads_of
        self.hist_s = []
        self.before = None
        self.trainer = trainer
        self.wrappers = wrappers or _xl_wrappers
        self.sync = sync
        self._step = trainer.train_step
        trainer.train_step = self
        log_histograms = trainer._log_histograms

        def timed_histograms():
            t0 = time.perf_counter()
            log_histograms()
            self.hist_s.append(time.perf_counter() - t0)

        trainer._log_histograms = timed_histograms
        if zero_postnet_dropout:
            trainer.model.postnet.dropout.p = 0.0

    def __call__(self, *args):
        from viet_tts_torch.train.state import TrainState

        states = [a for a in args if isinstance(a, TrainState)]
        batch = args[len(states)]
        if self.before is None:
            self.before = [_flat_params(s.module) for s in states]
        wrappers = self.wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        if self.sync:
            torch.cuda.synchronize()
        lrs = tuple(s.lr for s in states)
        t0 = time.perf_counter()
        out = self._step(*args)
        if self.sync:
            torch.cuda.synchronize()
        feats = batch.get("feats", batch.get("mel"))
        self.steps.append({
            "iter": self.trainer.iter,
            "t_text": int(batch["text"].shape[1]) if "text" in batch else None,
            "t_mel": int(feats.shape[1]), "step_s": time.perf_counter() - t0,
            "wait_s": self.trainer.last_data_wait, "lr": lrs[0], "lrs": lrs,
            "launches": {name: fn.launches for name, fn in wrappers.items()},
            "metrics": {k: v.item() for k, v in out[-1].items()}})
        if self.grads_of is not None:
            self.steps[-1]["grads"] = {
                n: p.grad.detach().cpu() for n, p in states[0].module.named_parameters()
                if self.grads_of in n and p.grad is not None}
        return out


def _trainer_argv(root: str, config_dir: str, out: str, max_iter: int, *extra,
                  task: str = "fastspeech2"):
    return ["--task", task, "-i", os.path.join(root, "egs"), "-d",
            os.path.join(root, "data"), "-o", os.path.join(root, out), "--config", config_dir,
            "--max_iter", str(max_iter), *extra]


def check_trainer(dev, voc_dir: str):
    """The FS2 trainer through the CLI's entry function, in-process, on the
    card (its default device): a dataset of 2 speakers x 12 utterances at
    ~2 s and ~7.5 s (mel buckets 256 and 768), full-width FastSpeech2 with
    ``attn_implementation: flash`` and every dropout as configured, batch
    size 8, to ``--max_iter 6``, then resumed by scan to 8. Held: the
    feature cache, the sidecars, the checkpoints (keep-3, names), the
    resumed iteration, each step's learning rate against its epoch's,
    finite losses, each step's K4 / K5 launches against
    its mel bucket (``fs2_step_launches``) and a K5 step among them. Then
    the trainer's first step on the card against the same trainer on the
    CPU (a one-bucket dataset, every dropout 0): losses within rel 1e-3.
    Then ``TwoStageTTS`` serves the trained output directory with phase 8's
    vocoder."""
    from viet_tts_torch.data.features import ARTIFACTS, resolve_artifact
    from viet_tts_torch.infer.api import TwoStageTTS, resolve_checkpoint
    from viet_tts_torch.train.__main__ import main
    from viet_tts_torch.train.checkpoint import SUFFIX, checkpoint_name
    from viet_tts_torch.train.state import exponential_lr

    root = _fresh_dir(TRAINER_ROOT)
    data_dir, _ = write_trainer_dataset(root, TRAINER_UTTS, TRAINER_SECONDS, SEED)
    config_dir = trainer_config(root)
    probes = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = main(_trainer_argv(root, config_dir, "out", TRAINER_ITERS[0]),
                 on_trainer=lambda tr: probes.append(_StepProbe(tr)))
    run1_s = time.perf_counter() - t0
    if first.device.type != dev.type or next(first.model.parameters()).device.type != dev.type:
        raise AssertionError(f"trainer ran on {first.device}, not on {dev}")
    out = first.args.output_folder
    wavs = [os.path.join(data_dir, spk, "wavs", n) for spk in TRAINER_SPEAKERS
            for n in sorted(os.listdir(os.path.join(data_dir, spk, "wavs")))]
    rows = first.train_set + first.test_set
    missing = [(w, k) for w, *_ in rows for k in ARTIFACTS[:4] if resolve_artifact(w, k) is None]
    if missing or len(rows) != len(wavs):
        raise AssertionError(f"feature cache: {len(rows)} rows of {len(wavs)} wavs, "
                             f"missing {missing[:4]}")
    for name in ("config.json", "speakers.json", "accents.json", "stats.json",
                 "train.txt"):
        where = out if name != "train.txt" else os.path.join(root, "egs")
        if not os.path.exists(os.path.join(where, name)):
            raise AssertionError(f"trainer: no {name}")
    per_epoch = first.train_loader.epoch_batches()

    resumed = main(_trainer_argv(root, config_dir, "out", TRAINER_ITERS[1]),
                   on_trainer=lambda tr: probes.append(_StepProbe(tr)))
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n0 = TRAINER_ITERS[0]
    names = sorted((f for f in os.listdir(out) if f.endswith(SUFFIX)),
                   key=lambda f: int(f.split("iteration")[1].split("_")[0]))
    want_names = [checkpoint_name("generator", 0, per_epoch),
                  checkpoint_name("generator", n0 // per_epoch, n0),
                  checkpoint_name("generator", n0 // per_epoch, TRAINER_ITERS[1])]
    if per_epoch != 4 or names != want_names:
        raise AssertionError(f"checkpoints {names}, expected {want_names} "
                             f"({per_epoch} batches an epoch)")
    steps = [s for p in probes for s in p.steps]
    if [s["iter"] for s in steps] != list(range(TRAINER_ITERS[1])):
        raise AssertionError(f"trainer iterations {[s['iter'] for s in steps]} (resumed at "
                             f"{probes[1].trainer.iter if probes[1].steps else None})")
    if resumed.iter != TRAINER_ITERS[1] or resumed.state.step != TRAINER_ITERS[1]:
        raise AssertionError(f"resumed trainer at iter {resumed.iter}, step {resumed.state.step}")
    # each step at its epoch's rate, across the resume inside epoch 1
    want_lr = [exponential_lr(first.base_lr, first.gamma, s["iter"] // per_epoch) for s in steps]
    if [s["lr"] for s in steps] != want_lr:
        raise AssertionError(f"trainer learning rates {[s['lr'] for s in steps]}, expected "
                             f"{want_lr}")
    launches = dict.fromkeys(XL_COUNTED, 0)
    for s in steps:
        expect = fs2_step_launches(s["t_mel"])
        if s["launches"] != expect:
            raise AssertionError(f"trainer step {s['iter']} at T_mel {s['t_mel']}: launches "
                                 f"{s['launches']}, expected {expect}")
        if not all(np.isfinite(v) for v in s["metrics"].values()):
            raise AssertionError(f"trainer step {s['iter']}: losses {s['metrics']}")
        for k, n in s["launches"].items():
            launches[k] += n
    buckets = sorted({s["t_mel"] for s in steps})
    if buckets != [256, 768]:
        raise AssertionError(f"trainer mel buckets {buckets}, expected a K4 (256) and a K5 "
                             "(768) bucket")
    by_bucket = {b: sorted(s["step_s"] for s in steps if s["t_mel"] == b) for b in buckets}
    wait_ms = sorted(1e3 * s["wait_s"] for s in steps)
    figures = {
        "cache_s": first.cache_seconds, "run_s": run_s, "first_run_s": run1_s,
        "step_s_by_bucket": by_bucket,
        "step_s_median_by_bucket": {b: float(np.median(v)) for b, v in by_bucket.items()},
        "hist_s": [h for p in probes for h in p.hist_s],
        "wait_ms": wait_ms[len(wait_ms) // 2], "wait_ms_max": wait_ms[-1], "peak_gb": peak_gb}
    log(f"trainer: {len(rows)} utterances ({len(first.train_set)} train), feature cache and "
        f"stats {first.cache_seconds:.1f} s; {len(steps)} steps at (B, T_text, T_mel) "
        f"{[(8, s['t_text'], s['t_mel']) for s in steps]}, resumed at iter {n0}; "
        f"checkpoints {names}; step host seconds "
        f"{[round(s['step_s'], 4) for s in steps]}; data "
        f"wait ms {[round(1e3 * s['wait_s'], 2) for s in steps]}; peak {peak_gb:.2f} GB; "
        f"both runs {run_s:.1f} s; launches {launches}; last losses {steps[-1]['metrics']}")

    # the first step on the card against the CPU, on a one-bucket dataset
    cmp_root = os.path.join(root, "card_vs_cpu")
    write_trainer_dataset(cmp_root, 3, (2.0,), SEED + 1)
    cmp_config = trainer_config(cmp_root, zero_dropout=True, batch_size=2)
    results = []
    for device in ("cuda", "cpu"):
        probe = []
        main(_trainer_argv(cmp_root, cmp_config, f"out_{device}", 1, "--device", device),
             on_trainer=lambda tr: probe.append(_StepProbe(tr, sync=device == "cuda",
                                                           zero_postnet_dropout=True)))
        (step,) = probe[0].steps
        results.append(step)
    card, cpu = (r["metrics"] for r in results)
    if results[0]["t_mel"] > 512 or results[0]["launches"] != fs2_step_launches(
            results[0]["t_mel"]):
        raise AssertionError(f"card vs CPU step: {results[0]}")
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    if max(rel.values()) > 1e-3:
        raise AssertionError(f"trainer first step card vs CPU: {card} vs {cpu}, rel {rel}")
    log(f"trainer first step card (kernels) vs CPU (plain), B=2 T_mel={results[0]['t_mel']}, "
        f"every dropout 0: max rel diff {max(rel.values()):.3e} (tol 1e-3) over {sorted(rel)}")

    tts = TwoStageTTS(out, voc_dir, fused_vocoder=True)
    waves = tts(SENTENCES[:4], speaker=TRAINER_SPEAKERS[1], accent="hcm")
    _check_waves(waves, 4, "TwoStageTTS from the trainer's output")
    log(f"TwoStageTTS serves the trainer's output ({os.path.basename(resolve_checkpoint(out))}"
        f"): 4 sentences, {[len(w) for w in waves]} samples")
    return launches, figures


# --------------------------------------------------------------------------
# phases 19 and 20: the GAN trainers (python -m viet_tts_torch.train --task
# jets | hifigan)
# --------------------------------------------------------------------------

# ~173 and ~474 mel frames: mel buckets 256 and 512 (bench.py's T_mel)
JETS_TRAINER_SECONDS = (2.0, 5.5)
FLASH_COUNTED = ("flash_attention_fwd", "flash_attention_bwd_q", "flash_attention_bwd_kv")
# full-width JETS: 4 encoder + 6 decoder attention layers, K2 9 launches at
# each of the vocoder's two fused stages
JETS_STEP_LAUNCHES = dict.fromkeys(FLASH_COUNTED, 10)
JETS_CALL_LAUNCHES = {"flash_attention_fwd": 10, "flash_attention_bwd_q": 0,
                      "flash_attention_bwd_kv": 0, "fused_mrf_stage": 18}


def _flash_wrappers():
    from viet_tts_torch.ops import flash_attention as fa

    return dict(zip(FLASH_COUNTED, (fa.attention_fwd, fa.attention_bwd_dq,
                                    fa.attention_bwd_dkv)))


def _mrf_wrappers():
    from viet_tts_torch.ops import fused_mrf as fm

    return {"fused_mrf_stage": fm.fused_mrf_stage}


def _generator_names(out: str):
    from viet_tts_torch.train.checkpoint import parse_checkpoint_name

    return sorted((f for f in os.listdir(out) if f.startswith("generator_")),
                  key=lambda f: parse_checkpoint_name(f)[1])


def _run_gan_trainer(task: str, root: str, config_dir: str, wrappers, dev, profile: bool):
    """``main`` with ``--task`` on the card's default device to
    ``TRAINER_ITERS[0]``, then resumed by scan to ``TRAINER_ITERS[1]``.
    Held: the device, the resumed iteration and steps, the generator
    checkpoints' names (keep-3), the discriminator file's iteration, each
    step's two rates against ``exponential_lr`` of its epoch, finite
    metrics, both models changed over the runs, TF32 off after the trainer
    was built (it is turned on before, so the trainer has to set it).
    Returns (the first trainer, the steps, the epoch's batches, (the memory
    earlier phases still hold, the peak) in GB, the two runs' seconds, the
    histogram seconds, the largest parameter changes, and with ``profile``
    (a step and its arguments) on one of the resumed trainer's batches,
    else None)."""
    from viet_tts_torch.train.__main__ import main
    from viet_tts_torch.train.checkpoint import checkpoint_name, load_checkpoint
    from viet_tts_torch.train.gan import DISCRIMINATOR_FILE
    from viet_tts_torch.train.state import exponential_lr
    from viet_tts_torch.train.trainer import step_generator

    probes = []
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
    tf32 = []

    def on_trainer(tr):
        tf32.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        probes.append(_StepProbe(tr, wrappers))

    t0 = time.perf_counter()
    try:
        _set_tf32(True)
        first, resumed = (main(_trainer_argv(root, config_dir, f"out_{task}", n, task=task),
                               on_trainer=on_trainer) for n in TRAINER_ITERS)
    finally:
        _set_tf32(False)
    run_s = time.perf_counter() - t0
    if tf32 != [(False, False)] * 2:
        raise AssertionError(f"{task} trainer left TF32 (cuDNN, matmul) at {tf32}")
    peak_gb = (base_gb, torch.cuda.max_memory_allocated() / 1e9)
    if first.device.type != dev.type or next(first.model.parameters()).device.type != dev.type:
        raise AssertionError(f"{task} trainer ran on {first.device}, not on {dev}")
    out = first.args.output_folder
    per_epoch = first.train_loader.epoch_batches()
    n0, n1 = TRAINER_ITERS
    # saved at each epoch's end and at each run's --max_iter; keep-3
    saved = sorted({*range(per_epoch, n1 + 1, per_epoch), n0, n1})[-3:]
    want_names = [checkpoint_name("generator", (i - 1) // per_epoch, i) for i in saved]
    names = _generator_names(out)
    disc_iter = load_checkpoint(os.path.join(out, DISCRIMINATOR_FILE))["iteration"]
    if names != want_names or disc_iter != n1:
        raise AssertionError(f"{task} checkpoints {names} (expected {want_names}), "
                             f"discriminator file at iteration {disc_iter}")
    steps = [s for p in probes for s in p.steps]
    if [s["iter"] for s in steps] != list(range(n1)) or (
            resumed.iter, resumed.state.step, resumed.disc_state.step) != (n1, n1, n1):
        raise AssertionError(f"{task} trainer iterations {[s['iter'] for s in steps]}, "
                             f"resumed at {resumed.iter}, steps {resumed.state.step} / "
                             f"{resumed.disc_state.step}")
    for s in steps:
        epoch = s["iter"] // per_epoch
        want = (exponential_lr(first.base_lr, first.gamma, epoch),
                exponential_lr(first.dis_lr, first.dis_gamma, epoch))
        if s["lrs"] != want:
            raise AssertionError(f"{task} step {s['iter']}: rates {s['lrs']}, expected {want}")
        if not all(np.isfinite(v) for v in s["metrics"].values()):
            raise AssertionError(f"{task} step {s['iter']}: metrics {s['metrics']}")
    changed = [(a - _flat_params(m)).abs().max().item()
               for a, m in zip(probes[0].before, (resumed.model, resumed.discriminator))]
    if min(changed) <= 0.0:
        raise AssertionError(f"{task}: max parameter change {changed}")
    hist_s = [h for p in probes for h in p.hist_s]
    profile_args = None
    if profile:  # a step of the resumed trainer on one training batch
        batches = iter(resumed.train_loader)
        batch = resumed._device_batch(next(batches))
        batches.close()
        profile_args = (probes[-1]._step, resumed.state, resumed.disc_state, batch,
                        *([step_generator(resumed.seed, 0)] if task == "jets" else []))
    return first, steps, per_epoch, peak_gb, run_s, hist_s, changed, profile_args


def _set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


# The JETS trainer's first-step gradients, card against CPU, per tensor:
# the fp32 step with no kernel of the port in it (attn_implementation
# "shift" on the card) already differs from the CPU by up to ~1e-3 of a
# self-attention tensor's norm (tools/jets_trainer_grads.py; PERF.md), and
# a K3 that wrote zeros would differ by 1.
GRAD_REL_TOL = 1e-2


def _gan_card_vs_cpu(task: str, root: str, config_dir: str, wrappers, expect_launches,
                     grads_of: Optional[str] = None):
    """The trainer's first step on the card and under ``--device cpu`` (the
    same seeded weights and segments): the metrics within rel 1e-3, and the
    card step's launches as expected. With ``grads_of``, the generator's
    gradients of the parameters whose names hold it too (the metrics are
    all taken before the generator's update, so they do not see its
    backward): each tensor's ||card - CPU|| within GRAD_REL_TOL of its CPU
    norm. A key projection's bias is left out: softmax is invariant to the
    shift it adds to a row's logits, so its gradient is 0 in exact
    arithmetic and only rounding remains."""
    from viet_tts_torch.train.__main__ import main

    results = []
    for device in ("cuda", "cpu"):
        probe = []
        main(_trainer_argv(root, config_dir, f"out_{task}_{device}", 1, "--device", device,
                           task=task),
             on_trainer=lambda tr: probe.append(_StepProbe(
                 tr, wrappers, sync=device == "cuda", grads_of=grads_of)))
        (step,) = probe[0].steps
        results.append(step)
    card, cpu = (r["metrics"] for r in results)
    if results[0]["launches"] != expect_launches:
        raise AssertionError(f"{task} card vs CPU step launches {results[0]['launches']}, "
                             f"expected {expect_launches}")
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    if max(rel.values()) > 1e-3:
        raise AssertionError(f"{task} trainer first step card vs CPU: {card} vs {cpu}, "
                             f"rel {rel}")
    note = ""
    if grads_of is not None:
        card_g, cpu_g = (r["grads"] for r in results)
        if not cpu_g or sorted(card_g) != sorted(cpu_g):
            raise AssertionError(f"{task} card vs CPU: gradients of {sorted(card_g)} against "
                                 f"{sorted(cpu_g)}")
        grad_rel = {n: ((card_g[n] - g).double().norm() / g.double().norm()).item()
                    for n, g in cpu_g.items() if not n.endswith("linear_k.bias")}
        bad = {n: e for n, e in grad_rel.items() if not e <= GRAD_REL_TOL}
        if bad:
            raise AssertionError(f"{task} card vs CPU: gradients beyond {GRAD_REL_TOL} of "
                                 f"their norm: {bad}")
        note = (f"; the gradients of {len(grad_rel)} '{grads_of}' tensors: max "
                f"||card - CPU|| / ||CPU|| {max(grad_rel.values()):.3e} (tol {GRAD_REL_TOL})")
    log(f"{task} trainer first step card (kernels) vs CPU (plain), B=2 "
        f"T_mel={results[0]['t_mel']}: max rel diff {max(rel.values()):.3e} (tol 1e-3) over "
        f"{sorted(rel)}{note}")
    return max(rel.values())


def _gan_figures(first, steps, per_epoch, peak_gb, run_s, hist_s):
    by_bucket = {}
    for s in steps:
        by_bucket.setdefault(s["t_mel"], []).append(s["step_s"])
    wait_ms = sorted(1e3 * s["wait_s"] for s in steps)
    return {"step_s_by_bucket": {b: sorted(v) for b, v in sorted(by_bucket.items())},
            "step_s_median_by_bucket": {b: float(np.median(v))
                                        for b, v in sorted(by_bucket.items())},
            "wait_ms": wait_ms[len(wait_ms) // 2], "wait_ms_max": wait_ms[-1],
            "held_gb": peak_gb[0], "peak_gb": peak_gb[1], "run_s": run_s, "hist_s": hist_s,
            "epoch_batches": per_epoch,
            "cache_s": getattr(first, "cache_seconds", None)}


def check_jets_trainer(dev, profile: bool):
    """The JETS trainer through the CLI's entry function, in-process, on the
    card (its default device): a dataset of 2 speakers x 12 utterances at
    ~2 s and ~5.5 s (mel buckets 256 and 512), full-width JETS with
    ``attn_implementation: flash`` and every dropout as configured
    (``init_type: xavier_uniform`` applied), the full MSMPD, batch size 8,
    to ``--max_iter 6``, then resumed by scan to 8 (``_run_gan_trainer``'s
    checks), each step's K1, K3a and K3b launches held at 10 each (4
    encoder + 6 decoder layers). Then the first step on the card against
    the CPU (a one-bucket dataset, every dropout 0 by the config edit): the
    metrics, and the self-attention gradients that K1 and K3 feed. Then
    ``OneStageTTS`` serves the output directory: K1 10 and K2 18
    launches a call."""
    from viet_tts_torch.infer.api import OneStageTTS, resolve_checkpoint

    root = _fresh_dir(os.path.join(REPO, "build", "chip_smoke_jets_trainer"))
    write_trainer_dataset(root, TRAINER_UTTS, JETS_TRAINER_SECONDS, SEED)
    config_dir = trainer_config(root)
    first, steps, per_epoch, peak_gb, run_s, hist_s, changed, profile_args = _run_gan_trainer(
        "jets", root, config_dir, _flash_wrappers, dev, profile)
    launches = dict.fromkeys(FLASH_COUNTED, 0)
    for s in steps:
        if s["launches"] != JETS_STEP_LAUNCHES:
            raise AssertionError(f"JETS trainer step {s['iter']} at T_mel {s['t_mel']}: "
                                 f"launches {s['launches']}, expected {JETS_STEP_LAUNCHES}")
        for k, n in s["launches"].items():
            launches[k] += n
    buckets = sorted({s["t_mel"] for s in steps})
    if per_epoch != 4 or buckets != [256, 512]:
        raise AssertionError(f"JETS trainer: {per_epoch} batches an epoch, mel buckets "
                             f"{buckets}, expected 4 and [256, 512]")
    figures = _gan_figures(first, steps, per_epoch, peak_gb, run_s, hist_s)
    log(f"JETS trainer: {len(first.train_set)} train utterances, {len(steps)} steps at "
        f"(B, T_text, T_mel) {[(8, s['t_text'], s['t_mel']) for s in steps]}, resumed at iter "
        f"{TRAINER_ITERS[0]}; checkpoints {_generator_names(first.args.output_folder)}; step "
        f"host seconds {[round(s['step_s'], 4) for s in steps]}; data wait ms "
        f"{[round(1e3 * s['wait_s'], 2) for s in steps]}; peak {peak_gb[1]:.2f} GB ("
        f"{peak_gb[0]:.2f} held before); both runs {run_s:.1f} s; launches {launches}; max "
        f"parameter change gen {changed[0]:.3e} disc "
        f"{changed[1]:.3e}; last metrics {steps[-1]['metrics']}")

    cmp_root = os.path.join(root, "card_vs_cpu")
    write_trainer_dataset(cmp_root, 3, (2.0,), SEED + 1)
    cmp_config = trainer_config(cmp_root, zero_dropout=True, batch_size=2)
    figures["card_vs_cpu_rel"] = _gan_card_vs_cpu("jets", cmp_root, cmp_config,
                                                  _flash_wrappers, JETS_STEP_LAUNCHES,
                                                  grads_of=".self_attn.")

    out = first.args.output_folder
    tts = OneStageTTS(out, fused_vocoder=True)
    per_call = []
    for texts in (SENTENCES[:4], SENTENCES[4:12]):
        counts = {**_flash_wrappers(), **_mrf_wrappers()}
        for fn in counts.values():
            fn.launches = 0
        waves = tts(texts)
        torch.cuda.synchronize()
        per_call.append({k: fn.launches for k, fn in counts.items()})
        _check_waves(waves, len(texts), "OneStageTTS from the JETS trainer's output")
    if per_call != [JETS_CALL_LAUNCHES] * 2:
        raise AssertionError(f"OneStageTTS launches per call {per_call}, expected "
                             f"{JETS_CALL_LAUNCHES}")
    log(f"OneStageTTS serves the JETS trainer's output "
        f"({os.path.basename(resolve_checkpoint(out))}): launches per call {per_call}")
    return launches, figures, profile_args


def check_hifigan_trainer(dev, profile: bool):
    """The HiFi-GAN trainer through the CLI's entry function on phase 18's
    dataset, feature cache and config copy: full-width HiFi-GAN V1 (plain
    MRF) and the default MSMPD, 64-frame segments, batch size 8, to
    ``--max_iter 6``, then resumed by scan to 8 (``_run_gan_trainer``'s
    checks), no K2 launch in a step. Then the first step on the card
    against the CPU (phase 18's one-bucket dataset). Then ``TwoStageTTS``
    serves phase 18's FastSpeech2 output with this phase's output as its
    vocoder: K2 18 launches a call."""
    from viet_tts_torch.infer.api import TwoStageTTS, resolve_checkpoint

    config_dir = os.path.join(TRAINER_ROOT, "config")
    first, steps, per_epoch, peak_gb, run_s, hist_s, changed, profile_args = _run_gan_trainer(
        "hifigan", TRAINER_ROOT, config_dir, _mrf_wrappers, dev, profile)
    if any(s["launches"]["fused_mrf_stage"] for s in steps):
        raise AssertionError(f"K2 launched in a HiFi-GAN training step: "
                             f"{[s['launches'] for s in steps]}")
    seg = first.conf["models"]["hifigan"]["segment_size"]
    if {s["t_mel"] for s in steps} != {seg} or per_epoch != 3:
        raise AssertionError(f"HiFi-GAN steps at {sorted({s['t_mel'] for s in steps})} "
                             f"frames, {per_epoch} batches an epoch")
    figures = _gan_figures(first, steps, per_epoch, peak_gb, run_s, hist_s)
    log(f"HiFi-GAN trainer: {len(first.train_set)} train utterances, {len(steps)} steps of "
        f"8 x {seg}-frame segments, resumed at iter {TRAINER_ITERS[0]}; checkpoints "
        f"{_generator_names(first.args.output_folder)}; step host seconds "
        f"{[round(s['step_s'], 4) for s in steps]}; data wait ms "
        f"{[round(1e3 * s['wait_s'], 2) for s in steps]}; peak {peak_gb[1]:.2f} GB ("
        f"{peak_gb[0]:.2f} held before); both runs {run_s:.1f} s; max parameter change gen "
        f"{changed[0]:.3e} disc {changed[1]:.3e}; "
        f"last metrics {steps[-1]['metrics']}")

    cmp_root = os.path.join(TRAINER_ROOT, "card_vs_cpu")
    figures["card_vs_cpu_rel"] = _gan_card_vs_cpu(
        "hifigan", cmp_root, os.path.join(cmp_root, "config"), _mrf_wrappers,
        {"fused_mrf_stage": 0})

    out = first.args.output_folder
    tts = TwoStageTTS(os.path.join(TRAINER_ROOT, "out"), out, fused_vocoder=True)
    counts = _mrf_wrappers()
    per_call = []
    for texts in (SENTENCES[:4], SENTENCES[4:8]):
        counts["fused_mrf_stage"].launches = 0
        waves = tts(texts, speaker=TRAINER_SPEAKERS[1], accent="hcm")
        torch.cuda.synchronize()
        per_call.append(counts["fused_mrf_stage"].launches)
        _check_waves(waves, len(texts), "TwoStageTTS with the HiFi-GAN trainer's vocoder")
    want = JETS_CALL_LAUNCHES["fused_mrf_stage"]  # the same V1 vocoder
    if per_call != [want, want]:
        raise AssertionError(f"TwoStageTTS K2 launches per call {per_call}, expected {want}")
    log(f"TwoStageTTS serves phase 18's FastSpeech2 with the HiFi-GAN trainer's output "
        f"({os.path.basename(resolve_checkpoint(out))}) as its vocoder: K2 launches per call "
        f"{per_call}")
    return figures, profile_args


def profile_call(fn, label: str, out_name: str, repeats: int = 5) -> None:
    """Host time of ``repeats`` calls of ``fn``, then one under
    ``torch.profiler``: device time by kernel group and the device's busy
    share of the call (one stream, so kernels do not overlap); the
    per-kernel table goes to ``OUT_DIR/<out_name>``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"profile: {label} host seconds {[round(t, 4) for t in times]} "
        f"(median {sorted(times)[len(times) // 2]:.4f})")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups[OTHER] = 0.0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        rows.append((us, e.count, e.key))
        for name, frags in KERNEL_GROUPS:
            if any(f in e.key.lower() for f in frags):
                groups[name] += us
                break
        else:
            groups[OTHER] += us
    busy = sum(groups.values())
    log(f"profile: one {label} under the profiler: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), "
        f"{sum(r[1] for r in rows)} kernel launches")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {us / 1e3:9.3f} ms  {100 * us / max(busy, 1e-9):5.1f} %  {name}")
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write("device_us\tcount\tkernel\n")
        for us, count, key in sorted(rows, reverse=True):
            f.write(f"{us:.1f}\t{count}\t{key}\n")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the phases, time five fp32 __call__s of 16 "
                         "sentences, five JETS training steps, five two-stage "
                         "calls, five FS2 training steps at T_mel 1008, five at "
                         "512 and five at 2048, five JETS-conformer calls and five "
                         "JETS-conformer steps of each rel-pos flavour, five "
                         "JETS and five HiFi-GAN trainer steps, and "
                         "profile one of each (device time by kernel group, "
                         "busy share; per-kernel tables in the output "
                         "directory, chip_smoke_profile*.txt)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from viet_tts_torch.runtime import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")

    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for name in kernels.SIGNATURES:
            f.write(f"=== {name}\n{kernels.build_log(name)}\n")
    log(f"kernels built in {build_s:.1f} s (ptxas report in "
        f"chiprun_out/chip_smoke_build.log)")

    k1 = phase_timed("2", check_flash_attention, dev)
    k2 = phase_timed("4", check_fused_mrf, dev, frames=1008)
    ckpt = build_checkpoint(os.path.join(REPO, "build", "chip_smoke_ckpt"))
    launches, tts = phase_timed("5", check_main_path, dev, ckpt)
    train_launches, train_figures, (step, *step_args) = phase_timed("6", check_training_path, dev)
    t_text = tts.encode_texts(SENTENCES)[2]
    xl = phase_timed("7", check_xl_kernels, dev, t_text=t_text)
    ac_dir, voc_dir = build_two_stage(os.path.join(REPO, "build", "chip_smoke_fs2"))
    fs2_launches, tts2, fs2_figures = phase_timed("8", check_two_stage_path, dev, ac_dir,
                                                  voc_dir)
    fs2_train_launches, fs2_train_figures, (fs2_step, *fs2_step_args), fs2_batch_512 = \
        phase_timed("10", check_fs2_training_path, dev)
    jc_ckpt = build_conformer_checkpoint(os.path.join(REPO, "build", "chip_smoke_jets_conformer"))
    jc_launches, jc_tts, jc_figures = phase_timed("12", check_conformer_serving, dev, jc_ckpt)
    jc_train_launches, jc_train_figures, (jc_step, *jc_step_args) = \
        phase_timed("13", check_conformer_training, dev)
    jl_ckpt = build_conformer_checkpoint(os.path.join(REPO, "build", "chip_smoke_jets_legacy"),
                                         "legacy")
    jl_launches, jl_tts, jl_figures = phase_timed("15", check_conformer_serving, dev, jl_ckpt,
                                                  "legacy")
    jl_train_launches, jl_train_figures, (jl_step, *jl_step_args) = \
        phase_timed("16", check_conformer_training, dev, "legacy")
    fs2_state_, fs2_rng = fs2_step_args[0], fs2_step_args[2]
    fs2_long_launches, fs2_long_figures, (fs2_long_step, *fs2_long_args) = \
        phase_timed("17", check_fs2_long_training, dev, fs2_step, fs2_state_, fs2_rng)
    trainer_launches, trainer_figures = phase_timed("18", check_trainer, dev, voc_dir)
    jets_trainer_launches, jets_trainer_figures, jt_profile = phase_timed(
        "19", check_jets_trainer, dev, args.profile)
    hifigan_trainer_figures, ht_profile = phase_timed("20", check_hifigan_trainer, dev,
                                                      args.profile)
    # the phases that time backward rows in device time run last: after a
    # torch.profiler session every kernel launch costs the host ~25 % more
    # (CUPTI stays attached; measured on the H100 machine), and the phases
    # above read host seconds of launch-bound calls and steps
    k1_train = phase_timed("3", check_flash_training, dev)
    xl_train = phase_timed("9", check_xl_training, dev)
    rel, k6_jets = phase_timed("11", check_rel_kernels, dev, t_text)
    k6_train = phase_timed("14", check_xl_k6_training, dev)
    if args.profile:
        profile_call(lambda: tts(SENTENCES), "fp32 __call__(16)", "chip_smoke_profile.txt")
        profile_call(lambda: step(*step_args), "training step",
                     "chip_smoke_profile_train.txt")
        profile_call(lambda: tts2(SENTENCES), "two-stage fp32 __call__(16)",
                     "chip_smoke_profile_fs2.txt")
        profile_call(lambda: fs2_step(*fs2_step_args),
                     f"FS2 training step (T_mel {FS2_TRAIN_T_MELS[0]})",
                     "chip_smoke_profile_fs2_train.txt")
        profile_call(lambda: fs2_step(fs2_step_args[0], fs2_batch_512, fs2_step_args[2]),
                     f"FS2 training step (T_mel {FS2_TRAIN_T_MELS[1]})",
                     "chip_smoke_profile_fs2_train_512.txt")
        profile_call(lambda: jc_tts(SENTENCES), "JETS-conformer fp32 __call__(16)",
                     "chip_smoke_profile_jets_conformer.txt")
        profile_call(lambda: jc_step(*jc_step_args), "JETS-conformer training step",
                     "chip_smoke_profile_jets_conformer_train.txt")
        profile_call(lambda: jl_tts(SENTENCES), "JETS-conformer legacy fp32 __call__(16)",
                     "chip_smoke_profile_jets_legacy.txt")
        profile_call(lambda: jl_step(*jl_step_args), "JETS-conformer legacy training step",
                     "chip_smoke_profile_jets_legacy_train.txt")
        profile_call(lambda: fs2_long_step(*fs2_long_args),
                     f"FS2 training step (B={FS2_LONG_B}, T_mel {FS2_LONG_T_MEL})",
                     "chip_smoke_profile_fs2_long_train.txt")
        jt_step, *jt_args = jt_profile
        ht_step, *ht_args = ht_profile
        profile_call(lambda: jt_step(*jt_args),
                     f"JETS trainer step (T_mel {jt_args[2]['feats'].shape[1]})",
                     "chip_smoke_profile_jets_trainer.txt")
        profile_call(lambda: ht_step(*ht_args), "HiFi-GAN trainer step (8 x 64 frames)",
                     "chip_smoke_profile_hifigan_trainer.txt")
    for entry in (k1, k2):
        entry["launches"] = launches[entry["name"]]
    k1["name_detail"] = "forward, with attention-weight dropout in training"
    k1["train_step"] = {
        "per": f"one training step, fp32, dropout {ATTN_DROPOUT} (4 calls at "
               f"({TRAIN_B}, {TRAIN_T_TEXT}) + 6 at ({TRAIN_B}, {TRAIN_T_MEL}))",
        "launches": train_launches["flash_attention_fwd"], **k1_train["fwd"]}
    k3 = k3_entries(k1_train)
    for entry in k3:
        entry["launches"] = train_launches[entry["name"]]
    for entry in (k1, *k3):
        entry["trainer_launches"] = jets_trainer_launches[entry["name"]]
        entry["trainer_launches_per"] = (
            f"the JETS trainer phase's {TRAINER_ITERS[1]} steps (python -m viet_tts_torch.train "
            f"--task jets, mel buckets 256 and 512, to --max_iter {TRAINER_ITERS[0]}, then "
            f"resumed to {TRAINER_ITERS[1]}; 10 a step)")
    k2["two_stage_launches"] = fs2_launches["fused_mrf_stage"]
    xl_entries = [xl[kind] for kind in ("xl3", "xl2", "xl")]
    for entry in xl_entries:
        entry["launches"] = fs2_launches[entry["name"]]
        entry["launches_per"] = ("the two-stage phase: three __call__s, two /synthesize, "
                                 "one /synthesize_stream")
    train_per = (f"the FS2 training phase's timed steps: 3 at T_mel {FS2_TRAIN_T_MELS[0]} "
                 f"and 3 at {FS2_TRAIN_T_MELS[1]}")
    for entry in xl_entries[:2]:
        entry["name_detail"] = "forward, with attention-weight dropout in training"
        entry["train_step"] = {"launches": fs2_train_launches[entry["name"]],
                               "launches_per": train_per, **xl_train[entry["name"]]}
    trainer_per = (f"the trainer phase's {TRAINER_ITERS[1]} steps (python -m "
                   "viet_tts_torch.train, mel buckets 256 and 768, to --max_iter "
                   f"{TRAINER_ITERS[0]}, then resumed to {TRAINER_ITERS[1]})")
    xl_bwd_entries = [
        {"name": name, "route": "cuda", "source": "viet_tts_torch/csrc/flash_xl_attention_bwd.cu",
         "replaces": XL_TRAIN_REPLACES[name], "launches": fs2_train_launches[name],
         "launches_per": train_per, "tol": 1e-4,
         "library": "F.scaled_dot_product_attention backward (dq, dk and dv together) "
                    "with scale * pos as an additive mask, on a retained graph",
         "timing": BWD_TIMING, **xl_train[name]}
        for name in ("flash_xl3_bwd", "flash_xl2_bwd_q", "flash_xl2_bwd_kv")]
    for entry in (*xl_entries[:2], *xl_bwd_entries):
        entry["trainer_launches"] = trainer_launches[entry["name"]]
        entry["trainer_launches_per"] = trainer_per
    xl_entries[2]["jets_width"] = k6_jets
    k6_paths = {"jets_legacy_training": jl_train_launches,
                "fs2_2048_training": fs2_long_launches}
    k6_per = ("the legacy JETS-conformer training phase's 3 timed steps (10 a step) and the "
              f"FS2 T_mel {FS2_LONG_T_MEL} training phase's 3 timed steps (6 a step)")
    xl_entries[2]["name_detail"] = "forward, with attention-weight dropout in training"
    xl_entries[2]["legacy_serving_launches"] = jl_launches["flash_xl_fwd"]
    xl_entries[2]["train_step"] = {
        "launches": sum(c["flash_xl_fwd"] for c in k6_paths.values()), "launches_per": k6_per,
        "launches_by_path": {k: c["flash_xl_fwd"] for k, c in k6_paths.items()},
        **k6_train["flash_xl_fwd"]}
    k6_bwd_entries = [
        {"name": name, "route": "cuda",
         "source": "viet_tts_torch/csrc/flash_xl_attention_bwd.cu",
         "replaces": K6_BWD_REPLACES[name],
         "launches": sum(c[name] for c in k6_paths.values()), "launches_per": k6_per,
         "launches_by_path": {k: c[name] for k, c in k6_paths.items()}, "tol": 1e-4,
         "library": "F.scaled_dot_product_attention backward (dq, dk and dv together) "
                    "with scale * pos as an additive mask, on a retained graph",
         "timing": BWD_TIMING, **k6_train[name]}
        for name in K6_BWD_REPLACES]
    rel_entries = [rel[name] for name in REL_REPLACES]
    for entry in (k1, *xl_entries, *xl_bwd_entries, *k6_bwd_entries, *rel_entries):
        if entry["name"] in TC_REDESIGNED:
            entry["redesigned"] = TC_REDESIGNED[entry["name"]] + TC_BOUND_NOTE
        if entry["name"].endswith("_bwd_q"):
            entry["library_pos_grad"] = (
                "SDPA backward with scale * pos as a mask leaf that takes a gradient, plus "
                "that gradient's products with the table: " + (
                    "dg at every key (K7)" if entry["name"] == "flash_rel_bwd_q" else
                    "the two masked ones (dgA, dgB)") + "; device time")
    rel_entries[0]["launches"] = jc_launches["flash_rel_fwd"]
    rel_entries[0]["launches_per"] = ("the JETS-conformer serving phase: two __call__s of 16 "
                                      "sentences, one /synthesize, one /synthesize_stream")
    rel_entries[0]["name_detail"] = "forward, with attention-weight dropout in training"
    rel_entries[0]["train_step"]["launches"] = jc_train_launches["flash_rel_fwd"]
    train_per_jc = "the JETS-conformer training phase's 3 timed steps"
    rel_entries[0]["train_step"]["launches_per"] = train_per_jc
    for entry in rel_entries[1:]:
        entry["launches"] = jc_train_launches[entry["name"]]
        entry["launches_per"] = train_per_jc
    log(f"training step: host median {train_figures['step_s']:.4f} s, "
        f"peak {train_figures['peak_gb']:.2f} GB")
    log(f"two-stage: fp32 __call__(16) host median {fs2_figures['call_s']:.4f} s "
        f"(acoustic {fs2_figures['acoustic_s']:.4f} s, vocoder {fs2_figures['vocoder_s']:.4f} s), "
        f"bf16 {fs2_figures['half_s']:.4f} s, 2048 frames x 4 {fs2_figures['long_s']:.4f} s")
    for T_mel in FS2_TRAIN_T_MELS:
        log(f"FS2 training step at T_mel {T_mel}: host median "
            f"{fs2_train_figures[T_mel]['step_s']:.4f} s, peak "
            f"{fs2_train_figures[T_mel]['peak_gb']:.2f} GB")
    for label, serve_fig, train_fig in (
            ("JETS-conformer", jc_figures, jc_train_figures),
            ("JETS-conformer legacy", jl_figures, jl_train_figures)):
        log(f"{label}: fp32 __call__(16) host median {serve_fig['call_s']:.4f} s, bf16 "
            f"{serve_fig['half_s']:.4f} s; training step host median "
            f"{train_fig['step_s']:.4f} s, peak {train_fig['peak_gb']:.2f} GB")
    log(f"FS2 training step at B={FS2_LONG_B} T_mel {FS2_LONG_T_MEL}: host median "
        f"{fs2_long_figures['step_s']:.4f} s, peak {fs2_long_figures['peak_gb']:.2f} GB")
    log(f"FS2 trainer: feature cache and stats {trainer_figures['cache_s']:.2f} s; step host "
        f"median by mel bucket "
        f"{ {b: round(v, 4) for b, v in trainer_figures['step_s_median_by_bucket'].items()} } s "
        f"(steps {trainer_figures['step_s_by_bucket']}); data wait median {trainer_figures['wait_ms']:.2f} ms a step (max "
        f"{trainer_figures['wait_ms_max']:.2f}); peak {trainer_figures['peak_gb']:.2f} GB; "
        f"both runs {trainer_figures['run_s']:.1f} s; parameter histograms "
        f"{[round(h, 3) for h in trainer_figures['hist_s']]} s an epoch end")
    for label, fig in (("JETS", jets_trainer_figures), ("HiFi-GAN", hifigan_trainer_figures)):
        log(f"{label} trainer: step host median by mel bucket "
            f"{ {b: round(v, 4) for b, v in fig['step_s_median_by_bucket'].items()} } s "
            f"(steps {fig['step_s_by_bucket']}); data wait median {fig['wait_ms']:.2f} ms a "
            f"step (max {fig['wait_ms_max']:.2f}); peak {fig['peak_gb']:.2f} GB "
            f"({fig['held_gb']:.2f} held by earlier phases at its start); both runs "
            f"{fig['run_s']:.1f} s; parameter histograms "
            f"{[round(h, 3) for h in fig['hist_s']]} s an epoch end; first step card vs CPU "
            f"max rel {fig['card_vs_cpu_rel']:.3e}"
            + (f"; feature cache and stats {fig['cache_s']:.2f} s" if fig["cache_s"] else ""))
    kernels_line = [k1, k2, *k3, *xl_entries, *xl_bwd_entries, *k6_bwd_entries, *rel_entries]
    if DEVICE_MS_MISSES:
        log(f"device_ms: {len(DEVICE_MS_MISSES)} backward figure(s) timed by CUDA events: "
            f"{DEVICE_MS_MISSES}")
        for entry in kernels_line:
            if "timing" in entry:
                entry["device_ms_misses"] = DEVICE_MS_MISSES
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
