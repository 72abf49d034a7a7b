#!/usr/bin/env python3
"""How long the whole CPU test suite takes under ``pytest-xdist --dist
load``, by replaying xdist's load scheduler on measured test durations.

    python3 tools/tier1_schedule.py RUN.xml COLLECT.txt [--workers 6] [--scan]

RUN.xml is the junit file of one whole run of the suite that reached its
end (``--junitxml``); COLLECT.txt is ``pytest --collect-only -q`` of the
tree to judge, in the order pytest collects it. An item that RUN.xml lacks
takes the median of its file's items there, else 0 (new card items, which
skip on the CPU).

xdist's ``LoadScheduling`` (3.x) first hands each of n workers a chunk of
``N // n // 4`` consecutive items, N the number collected, then, as a
worker's queue runs short, a further run of consecutive items; it never
moves an item off a worker's queue. So the wall time depends on N itself:
N decides which of the suite's slow neighbouring items share a first chunk.
The script prints the replayed wall time, each worker's busy seconds and
its first item, and with ``--scan`` the wall time at every N from N - 200
to N + 200, adding zero-second items where the card items sit or removing
card items. Durations come from a run under full load, so the replay is an estimate
for the same machine and load.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import statistics
import xml.etree.ElementTree as ET


def replay(durations: list[float], workers: int) -> tuple[float, list[list[int]]]:
    """xdist ``LoadScheduling.schedule`` and ``check_schedule``: the wall
    time and the items each worker ran, in order."""
    pending = list(range(len(durations)))
    queues: list[list[int]] = [[] for _ in range(workers)]
    ran: list[list[int]] = [[] for _ in range(workers)]

    def send(w: int, k: int) -> None:
        queues[w].extend(pending[:k])
        del pending[:k]

    def check(w: int, last: float) -> None:
        if not pending:
            return
        lo = max(2, len(pending) // workers // 4)
        hi = max(2, len(pending) // workers // 2)
        if len(queues[w]) < lo and not (last >= 0.1 and len(queues[w]) >= 2):
            send(w, max(hi - len(queues[w]), 2 - len(queues[w])))

    for w in range(workers):
        send(w, max(len(durations) // workers // 4, 2))
    events = [(durations[q[0]], w) for w, q in enumerate(queues) if q]
    heapq.heapify(events)
    wall = 0.0
    while events:
        now, w = heapq.heappop(events)
        item = queues[w].pop(0)
        ran[w].append(item)
        wall = max(wall, now)
        check(w, durations[item])
        if not queues[w] and pending:
            send(w, max(2, len(pending) // workers // 2))
        if queues[w]:
            heapq.heappush(events, (now + durations[queues[w][0]], w))
    return wall, ran


def load(run_xml: str, collect_txt: str) -> tuple[list[str], list[float]]:
    measured = {}
    for case in ET.parse(run_xml).getroot().iter("testcase"):
        path = case.get("classname").replace(".", "/") + ".py"
        measured[f"{path}::{case.get('name')}"] = float(case.get("time"))
    by_file = collections.defaultdict(list)
    for item, t in measured.items():
        by_file[item.split("::")[0]].append(t)
    ids = [line.strip() for line in open(collect_txt) if "::" in line]
    durations = []
    for item in ids:
        if item in measured:
            durations.append(measured[item])
        else:
            same_file = by_file.get(item.split("::")[0])
            card = "test_torch_cuda.py" in item
            durations.append(0.0 if card or not same_file else statistics.median(same_file))
    return ids, durations


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_xml")
    ap.add_argument("collect_txt")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()
    ids, durations = load(args.run_xml, args.collect_txt)
    wall, ran = replay(durations, args.workers)
    print(f"N {len(ids)}  first chunk {len(ids) // args.workers // 4}  "
          f"replayed wall {wall:.0f} s  (sum / workers {sum(durations) / args.workers:.0f} s)")
    for w, items in enumerate(ran):
        busy = sum(durations[i] for i in items)
        print(f"  worker {w}: {busy:7.0f} s, {len(items)} items from {ids[items[0]]}")
    if args.scan:
        card = [i for i, x in enumerate(ids) if "test_torch_cuda.py" in x]
        at = card[0] if card else len(ids)
        for delta in range(-200, 201, 8):
            if -delta > len(card):
                continue
            if delta < 0:
                drop = set(card[:-delta])
                trial = [t for i, t in enumerate(durations) if i not in drop]
            else:
                trial = durations[:at] + [0.0] * delta + durations[at:]
            print(f"  N {len(trial):4d}  first chunk {len(trial) // args.workers // 4:3d}  "
                  f"wall {replay(trial, args.workers)[0]:6.0f} s")


if __name__ == "__main__":
    main()
