"""The metrics' arithmetic against hand-worked values: percentiles over a
window, the work counts and their roofline and MFU shares, and
null (never NaN) where a metric has nothing to read."""

import math

import pytest

from perfbench import harness, stats, work
from perfbench.trace import Trace, breakdown
from perfbench.traffic import Request

LLM = {"dim": 8, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1, "ffn": 16, "n_audio": 4,
       "n_filler_vocab": 1}
CODEC = {"model_type": 1, "samples_per_token": 4, "hop_length": 2, "n_mels": 3, "decoder_dim": 4,
         "prenet_dim": 4, "prenet_ff": 8, "prenet_layers": 1, "prenet_window": 3,
         "decoder_layers": 1, "decoder_ff": 8, "decoder_window": 3}
VOC = {"upsample_rates": [2, 3], "num_kernels": 1, "channels": 2, "resblock_kernel": 3,
       "act_filter_len": 12, "mel_postnet_layers": 0, "mel_postnet_kernel": 5}


def window(records, reqs, seconds=10.0, tr=None, tw=None, cfg=None):
    return harness.Window(seconds, reqs, records, ({"replays": 2, "replay_ms": 10.0, "eager": 1,
                                                    "captures": 0},
                                                   {"replays": 6, "replay_ms": 30.0, "eager": 3,
                                                    "captures": 1}),
                          tr, tw, {}, {r.i: 5 for r in reqs},
                          cfg or {"llm": LLM, "codec": CODEC, "vocoder": VOC}, {}, 100, 42.0)


def req(i, stream=False):
    return Request(i, float(i), 10, "x", stream, False, 0)


def rec(i, due, done, stream=False, n=100, first=None, **kw):
    return {"i": i, "stream": stream, "ok": True, "due": due, "sent": due, "done": done,
            "first_audio": done if first is None else first, "audio_events": [[done, n]], **kw}


def read(name, w):
    return harness.metric_reader(name)(w)


def test_percentile_by_hand():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([10, 20, 30, 40, 50], 95) == pytest.approx(48.0)
    assert stats.percentile([], 50) is None
    assert stats.percentile([1, 2, math.inf], 50) == 2
    assert stats.percentile([1, math.inf, math.inf], 50) is None


def test_window_metrics_by_hand():
    reqs = [req(0), req(1), req(2, stream=True), req(3)]
    records = {0: rec(0, 0.0, 1.0, llm_ms=600.0, synth_ms=100.0, n_codes=10),
               1: rec(1, 1.0, 4.0, llm_ms=1000.0, synth_ms=500.0, n_codes=10),
               2: rec(2, 2.0, 12.0, stream=True, first=2.5, tokens=[1] * 10),
               3: {"i": 3, "stream": False, "ok": False, "due": 3.0, "sent": 3.0, "done": 3.5}}
    w = window(records, reqs)
    # latencies 1000, 3000, 10000, inf: the median 6500
    assert read("latency_p50_ms", w) == pytest.approx(6500.0)
    assert read("latency_p95_ms", w) is None  # reaches the failed request
    assert read("ttfa_p95_ms", w) == pytest.approx(500.0)  # one stream, 500 ms to first audio
    assert read("ttfa_p50_ms", w) == pytest.approx(500.0)
    assert read("setup_s", w) == 42.0
    # (1000 - 700 + 3000 - 1500) / 2
    assert read("engine.wait_ms_mean", w) == pytest.approx(900.0)
    assert read("codec.ms_per_decode", w) == pytest.approx(5.0)
    assert read("codec.cold_decodes", w) == 3.0
    for name in ("batcher.live_lanes_per_step", "llm.ms_per_step", "device.idle_share",
                 "K2_roofline", "K6_roofline", "step_mfu"):
        assert read(name, w) is None


def test_nothing_to_read_is_none():
    w = window({}, [req(0)])
    assert read("engine.wait_ms_mean", w) is None
    assert read("step_mfu", w) is None
    assert read("latency_p50_ms", w) is None  # the one request failed
    assert read("ttfa_p50_ms", w) is None  # no stream
    w.codec = ({"replays": 1, "replay_ms": 1.0, "eager": 0, "captures": 0},) * 2
    assert read("codec.ms_per_decode", w) is None


def test_llm_work_by_hand():
    # layer: q 8x8, o 8x8, k and v 8x4 each, MLP 3 x 8x16 -> 64+64+32+32+384 = 576
    assert work.llm_layer_params(LLM) == 576
    assert work.vocab(LLM) == 256 + 3 + 4 + 1
    # prompt 3, n 2: P = 4 positions, keys 1+2+3+4 = 10
    want = 2 * 576 * 4 * 2 + 4 * 8 * 10 * 2 + 2 * 8 * 264 * 2
    assert work.llm_flops(LLM, 3, 2) == want
    # tokens 0 and 1 after a prompt of 3: keys 4 and 5; hd 4, 1 kv head, 2 heads, 2 layers
    nb, fl = work.k2_need(LLM, 3, 0, 2)
    assert fl == 2 * 4 * 2 * 4 * (4 + 5)
    assert nb == 2 * (2 * 2 * 1 * 4 * 9 + 2 * 2 * 2 * 4 * 2)
    assert work.k2_need(LLM, 3, 1, 1) == (0.0, 0.0)


def test_k6_and_codec_work_by_hand():
    # 3 codes -> 6 frames -> stages of 12 and 36 rows
    assert work.vocoder_rows(CODEC, VOC, 3) == [12, 36]
    nb, fl = work.k6_need(VOC, 12)
    assert fl == 2 * (2 * 3 * 2 * 2) * 12 + 2 * 72 * 12 * 2
    assert nb == 4 * (2 * 12 * 2 + 2 * (3 * 2 * 2 + 2) + 4 * 12 + 4 * 2)
    nb2, fl2 = work.k6_request(CODEC, VOC, 3)
    assert fl2 == 3 * (work.k6_need(VOC, 12)[1] + work.k6_need(VOC, 36)[1])
    assert work.least_time(3.35e12, 0, 1.0) == pytest.approx(1.0)
    assert work.least_time(0, 67e12, work.PEAK_FLOPS["float32"]) == pytest.approx(1.0)
    assert work.overlap(0, 10, 5, 20) == 0.5 and work.overlap(3, 3, 0, 5) == 1.0


def test_shares_from_a_trace_by_hand():
    """K2's share: the span [2, 4] s holds a fifth of a 10-token request's
    generation [0, 10] s: tokens 2..4 (fractions, evenly spread)."""
    reqs = [req(0, stream=True)]
    records = {0: rec(0, 0.0, 10.0, stream=True, tokens=[1] * 10)}
    tr = Trace(2e6, 4e6, [(2e6, 2.5e6, "decode_attention_kernel<64>"),
                          (3e6, 3.2e6, "resblock_kernel"), (3.1e6, 3.4e6, "gemm")],
               [(2e6, 2.1e6, "chunk_dispatch steps=4 width=2 live=1", 7),
                (2.1e6, 2.6e6, "chunk_fetch", 7),
                (2.6e6, 2.7e6, "chunk_dispatch steps=12 width=2 live=2", 7),
                (2.8e6, 3.0e6, "chunk_fetch", 7)], {})
    w = window({}, [])
    w.traced = window(records, reqs, tr=tr, tw=(2.0, 4.0))
    nb, fl = work.k2_need(LLM, 5, 2.0, 4.0)
    assert read("K2_roofline", w) == pytest.approx(
        100 * work.least_time(nb, fl, work.PEAK_FLOPS["bfloat16"]) / 0.5)
    nb, fl = work.k6_request(CODEC, VOC, 10)
    assert read("K6_roofline", w) == pytest.approx(
        100 * work.least_time(0.2 * nb, 0.2 * fl, work.PEAK_FLOPS["float32"]) / 0.2)
    # busy: [2, 2.5] and [3, 3.4] of [2, 4]
    assert read("device.idle_share", w) == pytest.approx(100 * (1 - 0.9 / 2.0))
    assert read("batcher.live_lanes_per_step", w) == pytest.approx((4 * 1 + 12 * 2) / 16)
    assert read("llm.ms_per_step", w) == pytest.approx((600 + 400) / 16)
    b = breakdown(tr)
    assert b["device_ops"][0] == ["decode_attention_kernel<64>", 0.5]
    # gaps [2.5, 3] and [3.4, 4]: no host range covers either midpoint
    assert dict(b["idle_gaps"]) == pytest.approx({"none": 1.1})
    tr.ranges.append((2.7e6, 2.9e6, "codec_group B=1", 3))
    assert dict(breakdown(tr)["idle_gaps"]) == pytest.approx({"codec_group": 0.5, "none": 0.6})


def test_mfu_by_hand():
    """A /mio/tts request's LLM ran over [0, 6] s and its codec over [6, 7]:
    the span [2, 6.5] holds two thirds of the one and half of the other;
    the card was busy 1.5 s of it."""
    reqs = [req(0)]
    records = {0: rec(0, 0.0, 7.0, llm_ms=6000.0, synth_ms=1000.0, n_codes=10)}
    tr = Trace(2e6, 6.5e6, [(2e6, 3e6, "gemm"), (2.5e6, 3.5e6, "gemm"), (6e6, 6.5e6, "conv")],
               [], {})
    w = window({}, [])
    w.traced = window(records, reqs, tr=tr, tw=(2.0, 6.5))
    want = (work.llm_flops(LLM, 5, 10) / 989e12 * 2 / 3
            + work.codec_flops({"codec": CODEC, "vocoder": VOC}, 10) / 67e12 / 2) / 2.0 * 100
    assert read("step_mfu", w) == pytest.approx(want)


def test_a_cells_own_name_reads_as_its_quantity():
    assert harness.metric_reader("latency_p50_ms.mel") is not None
    w = window({0: rec(0, 0.0, 1.0, llm_ms=1.0, synth_ms=1.0, n_codes=10)}, [req(0)])
    assert read("latency_p50_ms.mel", w) == read("latency_p50_ms", w)
    assert read("engine.wait_ms_mean.mel", w) == read("engine.wait_ms_mean", w)
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.mel")
