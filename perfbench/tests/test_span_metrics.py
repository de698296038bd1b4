"""The readers of the program's spans (``perfbench/spans.py``,
``metrics/<name>.py``) against hand-worked values on hand-built
``Window.spans``, null (never NaN) with no spans; a recorded window of the
tiny cell on the CPU; and, on the card, the recorder's device intervals
against the profiler's record of the same slice."""

import json
import time

import numpy as np
import pytest
import torch

from perfbench import harness, spans
from perfbench.spans import WSpan
from perfbench.tests.test_metrics import req, window
from perfbench.tests.tiny import tiny_bench

NEW = ("codec.queue_ms_mean", "batcher.attach_ms_mean", "llm.device_ms_per_step",
       "codec.device_ms_per_decode", "device.window_idle_share")


def span(name, a, b, rids=(), thread="t", **attrs):
    return WSpan(name, a, b, thread, 0, None, tuple(rids), attrs)


def spanned(items, seconds=10.0):
    w = window({}, [req(0)], seconds=seconds)
    w.spans = items
    return w


def read(name, w):
    return harness.metric_reader(name)(w)


HAND = [
    span("lane_wait", 1.0, 1.001, rids=[7]), span("prefill_queue", 1.001, 1.002, rids=[7]),
    span("attach_wait", 1.03, 1.05, rids=[7]),
    span("lane_wait", 2.0, 2.0, rids=[8]), span("attach_wait", 2.01, 2.07, rids=[8]),
    span("lane_wait", 9.9, 9.9, rids=[9]),  # its attach fell after the window
    span("codec_queue", 3.0, 3.004, rids=[7]), span("codec_queue", 4.0, 4.010, rids=[8]),
    span("chunk_dispatch", 5.0, 5.001, steps=16),
    span("device:chunk_dispatch", 5.0005, 5.0325, steps=16),  # 32 ms over 16 steps
    span("device:chunk_dispatch", 6.0, 6.016, steps=12),  # 16 ms over 12 steps
    span("codec_group", 3.004, 3.02), span("device:codec_group", 3.005, 3.011),
    span("device:codec_group", 4.011, 4.021),
    span("device:prefill_group", 9.5, 10.5),  # clipped to the window's end
]


def test_span_readers_by_hand():
    w = spanned(HAND)
    assert read("codec.queue_ms_mean", w) == pytest.approx((4 + 10) / 2)
    assert read("batcher.attach_ms_mean", w) == pytest.approx((50 + 70) / 2)
    assert read("llm.device_ms_per_step", w) == pytest.approx((32 + 16) / (16 + 12))
    assert read("codec.device_ms_per_decode", w) == pytest.approx((6 + 10) / 2)
    busy = 0.032 + 0.016 + 0.006 + 0.010 + 0.5
    assert read("device.window_idle_share", w) == pytest.approx(100 * (1 - busy / 10.0))


def test_overlapping_device_intervals_count_once():
    w = spanned([span("device:chunk_dispatch", 1.0, 3.0, steps=1),
                 span("device:codec_group", 2.0, 4.0)], seconds=8.0)
    assert read("device.window_idle_share", w) == pytest.approx(100 * (1 - 3.0 / 8.0))


@pytest.mark.parametrize("name", NEW)
def test_no_spans_read_as_null(name):
    assert read(name, window({}, [req(0)])) is None  # a window the recorder did not run over
    assert read(name, spanned([])) is None
    assert read(name, spanned([span("request", 0.0, 1.0, rids=[1])])) is None


def test_idle_put_down_to_host_ranges_by_hand():
    w = spanned([span("chunk_dispatch", 0.0, 1.0), span("device:chunk_dispatch", 1.0, 2.0),
                 span("codec_group", 2.0, 5.0), span("chunk_fetch", 2.5, 3.5),
                 span("device:codec_group", 4.0, 5.0)], seconds=6.0)
    # gaps [0, 1] under chunk_dispatch, [2, 4] under chunk_fetch (the shorter of two
    # covering its middle), [5, 6] under none
    assert spans.idle_by_host(w) == [["chunk_fetch", 2.0], ["chunk_dispatch", 1.0],
                                     ["none", 1.0]]


def test_window_spans_keeps_the_window_in_its_seconds():
    from miotts_tpu_torch.runtime.tracing import Span

    got = spans.window_spans([Span("a", 99_000_000_000, 101_000_000_000, "t", 1, None, (), {}),
                              Span("b", 100_500_000_000, 100_700_000_000, "t", 2, 1, [3], {}),
                              Span("c", 111_000_000_000, 112_000_000_000, "t", 3, None, (), {})],
                             100.0, 10.0)
    assert [(s.name, s.start, s.end, s.rids) for s in got] == [("b", 0.5, pytest.approx(0.7),
                                                                 (3,))]


def test_a_recorded_window_on_the_cpu(tmp_path):
    """The tiny cell's window with the recorder on: the spans of its
    requests inside the window, the host readers non-null, the device
    readers null (the CPU records no device intervals), nothing dropped."""
    from miotts_tpu_torch.device import select_device
    from miotts_tpu_torch.runtime import tracing

    select_device("cpu")
    b = tiny_bench(tmp_path / "root")
    try:
        b.setup(tmp_path / "run", 2**31 + 11, torch.device("cpu"))
        w = spans.recorded_window(b, b.schedule(2**31 + 12, 3.0), 3.0)
    finally:
        b.close()
    assert not tracing.is_recording()
    assert w.attempted == len(w.ok) == 6
    assert w.recorder["dropped"] == 0 and w.recorder["in_window"] > 0
    assert all(0.0 <= s.start <= 3.0 and s.end >= s.start for s in w.spans)
    roots = {s.sid for s in w.spans if s.name == "request"}
    assert len(roots) == w.attempted
    assert read("codec.queue_ms_mean", w) > 0 and read("batcher.attach_ms_mean", w) > 0
    assert all(read(n, w) is None for n in ("llm.device_ms_per_step",
                                            "codec.device_ms_per_decode",
                                            "device.window_idle_share"))


# -- on the card ---------------------------------------------------------------------

MARK = "perfbench_clock_mark"
TOLERANCE_US = 50.0


def graph_kernels(events) -> np.ndarray:
    """[n, 2]: (start, end) in the trace's microseconds of every kernel a
    ``cudaGraphLaunch`` launched, in order."""
    launches = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and e.get("name", "").startswith(
                    "cudaGraphLaunch") and "correlation" in e.get("args", {})}
    return np.array(sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                           if e.get("cat") == "kernel"
                           and e.get("args", {}).get("correlation") in launches)).reshape(-1, 2)


def misses(kernels: np.ndarray, intervals, tol: float) -> np.ndarray:
    """For each kernel outside every interval widened by ``tol`` on each
    side, the least widening that would cover it (the nearest interval on
    either side)."""
    m = np.array(spans.merged(intervals), dtype=float).reshape(-1, 2)
    a, b = kernels[:, 0], kernels[:, 1]
    i = np.clip(np.searchsorted(m[:, 0], a, side="right") - 1, 0, len(m) - 1)
    need = np.maximum(0.0, np.maximum(m[i, 0] - a, b - m[i, 1]))
    nxt = np.minimum(i + 1, len(m) - 1)
    need = np.minimum(need, np.maximum(0.0, np.maximum(m[nxt, 0] - a, b - m[nxt, 1])))
    return need[need > tol]


def causal_lag_us(recorded) -> list[float]:
    """For each device interval, how long after the start of the host span
    that launched it (its ``parent``) it starts, in us: never below zero
    where the card's clock maps onto the host's as it should."""
    host = {s.sid: s for s in recorded if not s.name.startswith("device:")}
    return [(s.start_ns - host[s.parent].start_ns) / 1e3 for s in recorded
            if s.name.startswith("device:") and s.parent in host]


@pytest.mark.card
def test_device_intervals_cover_the_profilers_graph_kernels(card, tmp_path):
    """A traced slice of the cell's traffic with the recorder and the
    profiler both on. No device interval starts before the host span that
    launched it (the recorder's own clock mapping, within 50 us). After the
    offset between the two records of the card's clock (a marker kernel in
    both: the profiler's kernel against the recorder's device interval
    around it), every kernel of a chunk or codec graph replay lies inside a
    ``device:*`` interval within 50 us, and the recorder's union of busy
    time is at least the profiler's over the same span. The offset that
    host ranges in both give (before and after the slice) is reported
    beside it."""
    from miotts_tpu_torch.device import select_device
    from miotts_tpu_torch.runtime import tracing

    select_device("cuda")
    seed = 2**31 + 4321
    cell = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]][0]
    b = harness.Bench(cell)

    def marker():
        stream = torch.cuda.Stream()
        with tracing.trace_phase(MARK), torch.cuda.stream(stream), tracing.on_device():
            torch.cuda._sleep(200_000)  # spin_kernel: ~0.1 ms, launched by nothing else
        stream.synchronize()

    try:
        b.setup(tmp_path, seed, card)
        b._profile_on()
        try:
            with tracing.recording() as rec:
                marker()
                w = b.window(b.schedule(seed + 1, harness.TRACE_SLICE_S), harness.TRACE_SLICE_S)
                marker()
        finally:
            path = tracing.stop_profiler()
    finally:
        b.close()
    assert len(w.ok) == w.attempted
    recorded = rec.collect()
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    # host ranges: recorder us - trace us, before and after the slice
    host_marks = sorted(float(e["ts"]) for e in events
                        if e.get("name") == MARK and e.get("cat") == "user_annotation")
    host_offsets = [r - t for r, t in zip(
        sorted(s.start_ns / 1e3 for s in recorded if s.name == MARK), host_marks)]
    # the card's clock: the marker kernel's end against its device interval's end
    spins = sorted(float(e["ts"]) + float(e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "spin_kernel" in e.get("name", ""))
    ends = sorted(s.end_ns / 1e3 for s in recorded if s.name == "device:" + MARK)
    assert len(spins) == len(ends) == len(host_offsets) == 2
    device_offsets = [r - t for r, t in zip(ends, spins)]
    offset = sum(device_offsets) / 2
    intervals = [(s.start_ns / 1e3 - offset, s.end_ns / 1e3 - offset) for s in recorded
                 if s.name.startswith("device:") and s.name != "device:" + MARK]
    kernels = graph_kernels(events)
    assert len(kernels) and intervals
    missed = misses(kernels, intervals, TOLERANCE_US)
    lags = causal_lag_us([s for s in recorded if s.name != "device:" + MARK])
    lo, hi = kernels[0, 0], kernels[:, 1].max()
    device_ops = [(max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])))
                  for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    ours = spans.union([(max(lo, a), min(hi, c)) for a, c in intervals if c > lo and a < hi])
    theirs = spans.union(device_ops)
    print(json.dumps({"graph_kernels": len(kernels), "intervals": len(intervals),
                      "missed": len(missed), "worst_miss_us": float(missed.max(initial=0.0)),
                      "device_offsets_us": device_offsets, "host_offsets_us": host_offsets,
                      "least_lag_us": min(lags), "anchor_window_ns": rec.anchor_window_ns,
                      "recorder_busy_s": ours / 1e6, "profiler_busy_s": theirs / 1e6,
                      "span_s": (hi - lo) / 1e6, "clock_drift_ns": rec.clock_drift_ns,
                      "dropped": rec.dropped}))
    assert min(lags) >= -TOLERANCE_US
    assert not len(missed), (f"{len(missed)} of {len(kernels)} kernels outside, "
                             f"worst {missed.max()} us")
    assert ours >= theirs
