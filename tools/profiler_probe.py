#!/usr/bin/env python3
"""What ``torch.profiler`` does to a process on one NVIDIA card: the two
effects that shape ``chip_smoke.py``'s device-time measurement
(``device_ms``) and its phase order.

    python3 tools/profiler_probe.py

1. Host cost of a kernel launch (a 16-element in-place add, 20,000 in a
   row, host clock around them with a synchronise) before any profiler
   session, after one, and after thirteen: sessions leave later launches
   dearer, so phases that read host seconds of launch-bound calls run
   before the profiled ones.
2. Kernel records per session: one call (a 2048^2 fp32 matmul, an add and
   a sum) launches the same kernels every time, so each session of n calls
   should record the same number of kernels and the same device time a
   call. Fifteen sessions of each style (plain; CUDA activity only; a
   50 ms idle before the session ends; ``schedule`` with two warm-up steps),
   then plain again, in one process, n alternating 5 and 20: "records/calls
   device-ms-a-call" per session, beside the CUDA-event time of a call.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def launch_us(x, n: int = 20000) -> float:
    """Host microseconds a launch of a tiny in-place add."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    x = torch.zeros(16, device="cuda")
    print("launch us, before any session:", [round(launch_us(x), 3) for _ in range(3)])
    with profile(activities=ACTIVITIES):
        launch_us(x, 100)
    print("launch us, after one session:", [round(launch_us(x), 3) for _ in range(3)])
    for _ in range(12):
        with profile(activities=ACTIVITIES):
            launch_us(x, 100)
    print("launch us, after 13 sessions:", [round(launch_us(x), 3) for _ in range(3)])

    a = torch.randn(2048, 2048, device="cuda")
    b = torch.randn(2048, 2048, device="cuda")

    def call():
        c = a @ b
        c.add_(1.0)
        return c.sum()

    def events_ms(iters: int = 20) -> float:
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def tally(prof):
        n = us = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                n += e.count
                us += e.self_device_time_total
        return n, us / 1e3

    def plain(iters, activities=ACTIVITIES, idle=0.0):
        with profile(activities=activities) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
            time.sleep(idle)
        return tally(prof)

    def scheduled(iters):
        with profile(activities=ACTIVITIES,
                     schedule=schedule(wait=0, warmup=2, active=iters, repeat=1)) as prof:
            for _ in range(2 + iters):
                call()
                torch.cuda.synchronize()
                prof.step()
        return tally(prof)

    styles = (("plain", plain), ("cuda only", lambda n: plain(n, [ProfilerActivity.CUDA])),
              ("50 ms idle", lambda n: plain(n, idle=0.05)), ("schedule", scheduled),
              ("plain", plain))
    for _ in range(3):
        call()
    print("CUDA-event ms a call:", round(events_ms(), 4))
    for name, session in styles:
        rows = []
        for i in range(15):
            iters = (5, 20)[i % 2]
            n, ms = session(iters)
            rows.append(f"{n}/{iters} {ms / iters:.4f}")
        print(f"{name}: " + " | ".join(rows), flush=True)
    print("CUDA-event ms a call:", round(events_ms(), 4))


if __name__ == "__main__":
    main()
