"""Reading a ``torch.profiler`` Chrome trace back: the device's operations
and the host's ranges inside the traced span, their union, and the idle
gaps between them by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "perfbench_span"


@dataclasses.dataclass
class Trace:
    t0: float  # the traced span, in the trace's microseconds
    t1: float
    device: list[tuple[float, float, str]]  # (start, end, name), clipped to the span
    ranges: list[tuple[float, float, str, int]]  # host ranges: (start, end, name, thread)
    counts: dict[str, int]  # every event of the trace by category, for the run's log

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernel_seconds(self, substring: str) -> float:
        return sum(b - a for a, b, n in self.device if substring in n) / 1e6

    def busy_seconds(self) -> float:
        return union([(a, b) for a, b, _ in self.device]) / 1e6

    def idle_gaps(self) -> list[tuple[float, float]]:
        """Intervals of the span in which no device operation ran."""
        out, end = [], self.t0
        for a, b in merged([(a, b) for a, b, _ in self.device]):
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if end < self.t1:
            out.append((end, self.t1))
        return out


def merged(spans):
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union(spans) -> float:
    return sum(b - a for a, b in merged(spans))


def load(path: Path) -> Trace | None:
    """The span the harness marked (``SPAN``) and what lies in it; None
    when the trace has no such span."""
    with open(path, "rb") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    counts: dict[str, int] = {}
    for e in events:
        counts[e.get("cat", "")] = counts.get(e.get("cat", ""), 0) + 1
    span = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not span:
        return None
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    dev, ranges = [], []
    for e in events:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= t0 or a >= t1:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((max(a, t0), min(b, t1), e.get("name", "")))
        elif e.get("cat") == "user_annotation" and e.get("name") != SPAN:
            ranges.append((a, b, e["name"], e.get("tid", 0)))
    return Trace(t0, t1, dev, ranges, counts)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the host range that covered them (the innermost, by its first word;
    "none" where no range did), each as [name, seconds]."""
    ops: dict[str, float] = {}
    for a, b, n in tr.device:
        ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
    idle: dict[str, float] = {}
    for a, b in tr.idle_gaps():
        mid = (a + b) / 2
        cover = [r for r in tr.ranges if r[0] <= mid <= r[1]]
        name = min(cover, key=lambda r: r[1] - r[0])[2].split()[0] if cover else "none"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"device_ops": sorted(([n[:120], s] for n, s in ops.items()), key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:top]}
