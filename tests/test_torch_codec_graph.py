"""The pipeline's codec graphs (miotts_tpu_torch/models/codec_graph.py,
pipeline.py) on the CPU, with a stand-in graph that runs the decode body on
its own static buffers where a replay would run the captured kernels.

Held here: the key policy (a key's first decode eager, its second a
capture, then replays), which decode inputs make a new key and which do
not, the device pack and host unpack against the single-row fetch they
replace, that first-use caches refuse to fill during capture, that the
iSTFT with the Hann window in its tables is bit-equal to the one that
copied it from the host, and that threads may share a pipeline."""

import sys
import threading

import numpy as np
import pytest
import torch

from miotts_tpu_torch import pipeline as pipeline_mod
from miotts_tpu_torch.models import codec_graph
from miotts_tpu_torch.ops import istft, resample
from miotts_tpu_torch.ops.cuda import activation1d
from miotts_tpu_torch.pipeline import CodecKey, MioTTSPipeline
from miotts_tpu_torch.testing import tiny_codec_config, write_synthetic_miocodec_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")


class _EagerCodecGraph(codec_graph.CodecGraph):
    """A codec graph without CUDA: it keeps the buffers it is made on and
    runs the body on them. Counts the graphs made and each one's replays,
    and keeps the pool and the counters it was given."""
    made = 0

    def __init__(self, body, inputs, stream, pool=None, warm_up=True, check_syncs=True,
                 counters=codec_graph.codec):
        _EagerCodecGraph.made += 1
        self.body, self.inputs, self.warm_up, self.n_replays = body, inputs, warm_up, 0
        self.pool, self.counters = pool, counters

    def replay(self):
        self.n_replays += 1
        self.out = self.body(self.inputs)
        return self.out


@pytest.fixture(scope="module")
def codec_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("codec_graph") / "tiny.gguf")
    write_synthetic_miocodec_gguf(path, tiny_codec_config(), seed=0)
    return path


@pytest.fixture
def pipes(codec_path, monkeypatch):
    """(a pipeline on stand-in graphs, a pipeline that decodes eagerly)."""
    monkeypatch.setattr(codec_graph, "CodecGraph", _EagerCodecGraph)
    graphed = MioTTSPipeline(codec_path, CPU)
    graphed.use_graph = True
    return graphed, MioTTSPipeline(codec_path, CPU)


def _request(seed: int, n: int):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, n), rng.randn(16).astype(np.float32)


def test_first_decode_eager_second_captures_then_replays(pipes):
    """Decodes 1, 2, 3, 4 of one key: eager, then one graph (captured with
    no warm-up of its own: decode 1 was it) serving 2, 3 and 4, each equal
    to the eager pipeline's decode of the same request; a shorter request
    between two longer ones leaves no stale rows in the graph's buffers."""
    graphed, eager = pipes
    made = _EagerCodecGraph.made
    requests = [_request(0, 50), _request(0, 50), _request(1, 37), _request(0, 50)]
    for i, (codes, emb) in enumerate(requests):
        got = graphed.synthesize(codes, emb)
        ref = eager.synthesize(codes, emb)
        np.testing.assert_array_equal(got.audio, ref.audio)
        assert got.n_frames == ref.n_frames and got.audio.size > 0
        assert _EagerCodecGraph.made - made == (0 if i == 0 else 1)
    (key, graph), = graphed.graphs.items()
    assert key == CodecKey(1, 64, True, None, True, None, False)
    assert not graph.warm_up and graph.n_replays == 3
    assert graphed.n_decodes == 4 and not eager.graphs


def test_capture_on_another_thread_warms_up(pipes):
    """A key's eager decode on one thread and its second decode on another
    (a server's callers share one pipeline): the capture runs a warm-up of
    its own, since the capturing thread has no cuBLAS or cuDNN handles of
    its own yet; both decodes equal the eager pipeline's."""
    graphed, eager = pipes
    codes, emb = _request(0, 50)
    got, errors = [], []

    def decode():
        try:
            got.append(graphed.synthesize(codes, emb).audio)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    for _ in range(2):
        th = threading.Thread(target=decode)
        th.start()
        th.join(timeout=120)
    assert not errors and len(got) == 2
    (graph,) = graphed.graphs.values()
    assert graph.warm_up and graph.n_replays == 1
    ref = eager.synthesize(codes, emb).audio
    for audio in got:
        np.testing.assert_array_equal(audio, ref)


# (name, whether it makes a new key): a variation of the base decode
# (50 codes, bucket 64, a cond, no anchor, peak-normalized, no window, f32)
VARIATIONS = [("codes_and_length", False), ("cond_values", False), ("window_start", False),
              ("bucket", True), ("cond_given", True), ("interp_anchor", True),
              ("peak_normalize", True), ("window_length", True), ("pcm16", True),
              ("batch", True)]


def _decode(pipe, name: str):
    codes, emb = _request(0, 50)
    kw = dict(interp_anchor=None, peak_normalize=True, window=None, starts=None, pcm16=False)
    n, width, B, cond = 50, 64, 1, emb
    if name.startswith("window"):
        kw.update(window=512, starts=np.array([100], np.int32))
    if name == "codes_and_length":
        codes, n = _request(3, 41)[0], 41
    elif name == "cond_values":
        cond = _request(4, 1)[1]
    elif name == "bucket":
        width = 96
    elif name == "cond_given":
        cond = None
    elif name == "interp_anchor":
        kw["interp_anchor"] = 1024
    elif name == "peak_normalize":
        kw["peak_normalize"] = False
    elif name == "window_start":
        kw["starts"] = np.array([300], np.int32)
    elif name == "window_length":
        kw["window"] = 256
    elif name == "pcm16":
        kw["pcm16"] = True
    elif name == "batch":
        B = 2
    tokens = np.zeros((B, width), np.int64)
    tokens[:, :n] = codes[:n]
    cond = None if cond is None else np.repeat(cond[None], B, 0)
    if kw["starts"] is not None:
        kw["starts"] = np.repeat(kw["starts"], B)
    return pipe.decode(tokens, np.full(B, n, np.int32), cond, **kw)[:2]


@pytest.mark.parametrize("name,is_key", VARIATIONS, ids=[v[0] for v in VARIATIONS])
def test_key_fields(pipes, name, is_key):
    """B, bucket, cond given, anchor, peak normalization, window length and
    pcm16 make a key; codes, lengths, cond values and the window start are
    inputs of a key's graph. The variation's replay equals its eager decode."""
    graphed, eager = pipes
    for variant in ("window" if name == "window_start" else "base", name):
        for _ in range(2):  # eager, then the capture
            _decode(graphed, variant)
    assert (len(graphed.graphs) == 2) == is_key, sorted(map(str, graphed.graphs))
    got, ref = _decode(graphed, name), _decode(eager, name)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _old_fetch(audio: torch.Tensor, n_samples: torch.Tensor, pcm16: bool):
    """The single-row fetch that _pack and _unpack replace, as it was."""
    if not pcm16:
        packed = torch.cat([audio.float(), n_samples.float()]).cpu().numpy()
        return packed[:-1], int(packed[-1])
    pcm = torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    packed = torch.cat([pcm, n_samples.to(torch.int32).view(torch.int16)]).cpu().numpy()
    return packed[:-2].astype(np.float32) / np.float32(32767.0), int(packed[-2:].view(np.int32)[0])


@pytest.mark.parametrize("pcm16", [False, True])
def test_pack_unpack_is_the_old_fetch(pcm16):
    """Device pack + host unpack of [B, L] rows give each row's old fetch,
    bit for bit, counts up to 2^24 - 1 and samples beyond [-1, 1]."""
    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(3, 777) * 0.7).astype(np.float32))
    audio[0, :5] = torch.tensor([1.5, -1.5, 0.5 / 32767, -0.5 / 32767, 1.5 / 32767])
    counts = torch.tensor([777, 3, 2 ** 24 - 1], dtype=torch.int32)
    got, got_n = pipeline_mod._unpack(pipeline_mod._pack(audio, counts, pcm16).numpy(), pcm16)
    for b in range(3):
        ref, ref_n = _old_fetch(audio[b], counts[b:b + 1], pcm16)
        assert got[b].dtype == ref.dtype and got[b].tobytes() == ref.tobytes()
        assert int(got_n[b]) == ref_n


@pytest.mark.parametrize("cache", ["operands", "lowpass"])
def test_caches_refuse_to_fill_during_capture(cache, monkeypatch):
    """While the current stream is being captured, a miss of K5/K6's
    operand cache or of the julius filter cache raises (its value would be
    a graph-pool tensor that nothing ever wrote); a hit still returns."""
    t = torch.ones(4)
    if cache == "operands":
        hit = activation1d.cached((t,), lambda: t * 2)
        fill = lambda: activation1d.cached((torch.ones(3),), lambda: torch.zeros(3))  # noqa: E731
        again = lambda: activation1d.cached((t,), lambda: t * 3)  # noqa: E731
    else:
        hit = resample._lowpass_filter(0.25, CPU)
        fill = lambda: resample._lowpass_filter(0.3141, CPU)  # noqa: E731
        again = lambda: resample._lowpass_filter(0.25, CPU)  # noqa: E731
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        fill()
    assert again() is hit


def _old_spec_to_audio(spec, frame_lengths, n_fft, hop, tables):
    """spec_to_audio as it was, with the window copied from the host at
    each call."""
    n_freq = n_fft // 2 + 1
    mag = torch.clamp(torch.exp(spec[..., :n_freq].float()), max=1e2)
    phase = spec[..., n_freq:].float()
    frames = torch.matmul(mag * torch.cos(phase), tables[0]) - torch.matmul(
        mag * torch.sin(phase), tables[1])
    B, L, _ = frames.shape
    r, n_pad = -(-n_fft // hop), (n_fft - hop) // 2
    hann = torch.from_numpy(istft.hann_periodic(n_fft))
    maskf = (torch.arange(L, dtype=torch.int32)[None, :] < frame_lengths[:, None]).float()[:, :, None]
    windowed = frames.float() * hann[None, None, :] * maskf
    env_frames = (hann * hann)[None, None, :] * maskf
    H, frame_pad = L + r - 1, r * hop - n_fft

    def ola(x):
        if frame_pad:
            x = torch.nn.functional.pad(x, (0, frame_pad))
        xr = x.reshape(B, L, r, hop)
        acc = torch.zeros((B, H, hop), dtype=torch.float32)
        for s in range(r):
            acc[:, s:s + L, :] += xr[:, :, s, :]
        return acc.reshape(B, H * hop)

    audio_ola, env_ola = ola(windowed), ola(env_frames)
    audio = torch.where(env_ola > 1e-12, audio_ola / torch.clamp(env_ola, min=1e-12), audio_ola)
    return audio[:, n_pad:n_pad + (L - 1) * hop + n_fft - 2 * n_pad]


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (1920, 480), (1920, 441)])
def test_spec_to_audio_hann_in_tables_is_bit_equal(n_fft, hop):
    rng = np.random.RandomState(n_fft + hop)
    spec = torch.from_numpy((rng.randn(2, 9, n_fft + 2) * 0.5).astype(np.float32))
    lengths = torch.tensor([9, 4], dtype=torch.int32)
    tables = tuple(torch.from_numpy(t) for t in istft.dft_tables(n_fft))
    got = istft.spec_to_audio(spec, lengths, n_fft, hop, tables)
    assert torch.equal(got, _old_spec_to_audio(spec, lengths, n_fft, hop, tables))


def test_threads_share_a_pipeline(pipes):
    """Six threads (more than the run's cores) decode through one graphed
    pipeline at once, two keys; each result equals the eager pipeline's."""
    graphed, eager = pipes
    requests = [_request(s, n) for s, n in ((0, 50), (1, 37), (2, 20), (3, 61))]
    refs = [eager.synthesize(c, e).audio for c, e in requests]
    results, errors = {}, []

    def work(t):
        try:
            for i in range(6):
                j = (t + i) % len(requests)
                results[(t, i)] = (j, graphed.synthesize(*requests[j]).audio)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    assert len(results) == 36 and graphed.n_decodes == 36
    for j, audio in results.values():
        np.testing.assert_array_equal(audio, refs[j])
    assert {k.bucket for k in graphed.graphs} == {32, 64}


@pytest.mark.parametrize("B", [1, 2])
def test_capture_ahead_then_replays(pipes, B):
    """``capture`` makes a key's graph ahead of time (with its own warm-up):
    the key's first decode is then a replay, B ragged lanes equal to the
    eager decode of the batch, each lane's count that of its length."""
    graphed, eager = pipes
    graph = graphed.capture(64, B=B)
    assert graph.warm_up and graph.n_replays == 0 and graphed.capture(64, B=B) is graph
    lengths = [50, 37][:B]
    tokens = np.zeros((B, 64), np.int64)
    for b, n in enumerate(lengths):
        tokens[b, :n] = _request(b, n)[0]
    cond = np.stack([_request(b, 1)[1] for b in range(B)])
    audio, counts, _ = graphed.decode(tokens, np.array(lengths, np.int32), cond)
    ref, ref_counts = eager.decode_eager(tokens, np.array(lengths, np.int32), cond)
    assert graph.n_replays == 1 and list(graphed.graphs) == [CodecKey(B, 64, True, None, True,
                                                                      None, False)]
    np.testing.assert_array_equal(audio, ref)
    np.testing.assert_array_equal(counts, ref_counts)
    for b, n in enumerate(lengths):
        alone = eager.synthesize(tokens[b, :n], cond[b])
        assert counts[b] == alone.audio.size and np.all(audio[b, counts[b]:] == 0)
        np.testing.assert_allclose(audio[b, :counts[b]], alone.audio, atol=1e-5, rtol=0)


def test_capture_needs_cuda(codec_path):
    """On the CPU a capture raises: nothing falls back to an eager decode."""
    pipe = MioTTSPipeline(codec_path, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        pipe.capture(32)
    assert not pipe.graphs


def test_capture_counts_only_its_own_thread():
    """While one thread records a capture, another thread's kernel launches
    count in the module as usual and stay out of the graph's per-replay
    counts; a replay adds those counts once."""
    from miotts_tpu_torch.ops.cuda import banded_attention as k1
    from miotts_tpu_torch.ops.cuda import decode_attention as k2
    from miotts_tpu_torch.ops.cuda import graphs

    assert graphs.CAPTURE_MODE == "thread_local"
    base1, base2 = k1.launches, k2.launches
    inside, go = threading.Event(), threading.Event()

    def other():
        inside.wait()
        for _ in range(3):
            graphs.launched(k1.__name__)
        go.set()

    t = threading.Thread(target=other)
    t.start()
    with graphs.record_launches() as per_replay:
        graphs.launched(k2.__name__)
        graphs.launched(k2.__name__)
        inside.set()
        go.wait()
    t.join()
    assert per_replay[k2] == 2 and per_replay[k1] == 0
    assert (k1.launches, k2.launches) == (base1 + 3, base2)
    graphs.count_replay(per_replay)
    assert k2.launches == base2 + 2


def test_sync_check_is_optional(monkeypatch):
    """Without ``check_syncs`` the eager run never touches the process-wide
    sync-debug mode (a server's other threads read the card meanwhile)."""
    def refuse(*a, **k):
        raise AssertionError("sync-debug mode touched")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    assert codec_graph.run_checked(lambda inputs: inputs["x"] + 1, {"x": torch.ones(2)},
                                   check_syncs=False).tolist() == [2.0, 2.0]
    with pytest.raises(AssertionError, match="touched"):
        codec_graph.run_checked(lambda inputs: inputs["x"], {"x": torch.ones(2)})


def test_launch_counter_loses_no_update_under_threads():
    """Sixteen threads counting launches at once with a short switch
    interval: the module's count is exact (the count is a locked
    read-modify-write)."""
    from miotts_tpu_torch.ops.cuda import conv1d as k4
    from miotts_tpu_torch.ops.cuda import graphs

    base, n_threads, per = k4.launches, 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [graphs.launched(k4.__name__)
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert k4.launches == base + n_threads * per
