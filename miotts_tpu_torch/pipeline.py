"""MioTTS synthesis context: codec loading and length-bucketed synthesis
(miotts_tpu/pipeline.py:31-63, 90-292).

Requests are padded into the same ladder of length buckets as the JAX
package, so both packages decode the same padded shapes. A decode's result
reaches the host in one copy: the audio rows and their valid-sample counts
packed together on the device (``_pack``), or, for the streaming
synthesizer, only a window of the audio and the count
(``synthesize(window=...)``).

On CUDA each decode key (``CodecKey``: what the JAX ``jit`` treats as
static or as a shape) gets one CUDA graph (``models/codec_graph.py``): the
first decode of a key runs eagerly on the pipeline's stream, its result
used and the run the graph's warm-up; the second captures the graph and
replays it; every later one replays. So a one-shot decode pays no capture,
and a stream or a server that decodes a bucket again reuses its graph.
``capture`` captures a key ahead of time. All of a pipeline's graphs share
one memory pool; a lock makes copy-in -> replay -> copy-out one step, so
threads may share a pipeline. On the CPU every decode is eager. The
codec's ``MIOTTS_CODEC_MATMUL`` is read once, when the pipeline is built,
since a graph keeps what it was captured with.

Sequence parallelism (``sp_devices``, the CLI's ``--sequence-parallel``;
miotts_tpu/pipeline.py:133-157, 236-250): each decode's time axis splits
over an ("sp",) mesh of those devices (``parallel/sequence.py``), the
codec weights replicated on them (one upload a physical device), the
token bucket rounded up to a multiple of sp. An sp key is its own
``CodecKey``. Where every rank of the mesh is on one card (logical ranks,
``MIOTTS_LOGICAL_DEVICES``) its decodes keep the policy above, each a
graph of every rank's work; where the ranks span cards, every decode runs
eagerly, as a tp group over cards does (``models/llm.py spans_devices``):
a graph of several devices' work is not built here. The reference chain
runs on the mesh's lead device, unsplit, as in the JAX package.

Voice cloning (``reference_to_embedding``, with ``wavlm_path``): a
reference file is decoded, peak-normalized and resampled to 16 kHz on the
host, padded to its WavLM bucket, and the whole chain to the packed
``[embedding | ssl_ok | pre_ok]`` (WavLM, the ssl -> ssl_pre choice over
the valid frames, the global encoder; ``_reference_embedding_fused``)
runs on the device with one host read at its end, as the JAX package
makes one fetch. On CUDA it runs on a stream of its own (so a server's
reference generations do not queue behind codec decodes and LLM chunks),
with the codec graphs' policy: where the JAX package compiles the chain
once a WavLM bucket (miotts_tpu/pipeline.py:166-168), a bucket's first
chain runs eagerly (under ``torch.cuda.set_sync_debug_mode("error")``
where ``check_syncs`` allows it, so a hidden host sync inside the chain
fails), its second captures the bucket's CUDA graph (after a warm-up run
on the capturing thread, which in a server need not be the one that ran
the eager chain) and every later one replays it. The graph's static inputs are the padded waveform and its
length, which ``run`` rewrites whole (so two references of one bucket
share its graph), and the bucket's relative-position table, which never
changes. The reference graphs keep a memory pool of their own, apart from
the codec graphs' (whose replays may run at the same time on the
pipeline's stream), and one lock holds a chain's copy-in, run and host
read together: concurrent chains serialize on the device. Buckets are not
captured ahead of time (the JAX package warms the chain lazily too). The
last rung of the fallback ladder (audio statistics) is computed on the
host and re-runs only the encoder, eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import MIO_CODE_MAX, MIO_CODE_MIN
from .device import to_device, to_host
from .gguf.writer import load_embedding_gguf, save_embedding_gguf
from .models import codec_graph
from .models.miocodec import (
    codec_synthesize, codec_synthesize_sharded, encode_global_embedding, load_miocodec)
from .ops.masking import time_mask
from .ops.precision import codec_matmul_mode
from .parallel import sequence as seq
from .parallel.mesh import make_sp_mesh, same_device, tree_to
from .runtime import tracing
from .runtime.tracing import maybe_start_profiler, trace_phase

DEFAULT_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def _window_slice(audio: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """[B, window]: audio[b, starts[b]:starts[b] + window] per lane, zeros
    beyond each row (miotts_tpu/pipeline.py _window_slice)."""
    T = audio.shape[1]
    idx = starts[:, None].long() + torch.arange(window, device=audio.device)[None, :]
    win = torch.gather(audio, 1, idx.clamp(0, T - 1))
    return torch.where(idx < T, win, torch.zeros((), dtype=win.dtype, device=win.device))


def _pack(audio: torch.Tensor, n_samples: torch.Tensor, pcm16: bool) -> torch.Tensor:
    """Rows of audio [B, L] and their valid-sample counts [B] as one tensor
    for one device -> host copy: [B, L + 1] f32 with the count (exact in f32
    below 2^24) appended, or, with ``pcm16``, [B, L + 2] int16: the audio
    quantized as ``audio_io.encode_pcm16`` does (clip to [-1, 1], x 32767,
    round half to even) and the int32 count bitcast into two more."""
    if not pcm16:
        return torch.cat([audio.float(), n_samples.float()[:, None]], dim=1)
    pcm = torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    return torch.cat([pcm, n_samples.to(torch.int32)[:, None].view(torch.int16)], dim=1)


def _unpack(packed: np.ndarray, pcm16: bool, as_int16: bool = False
            ) -> tuple[np.ndarray, np.ndarray]:
    """``_pack``'s result on the host -> (audio [B, L] f32, counts [B]); the
    pcm16 audio is scaled back to f32, or with ``as_int16`` kept as the
    int16 PCM values."""
    if not pcm16:
        return packed[:, :-1], packed[:, -1].astype(np.int64)
    counts = np.ascontiguousarray(packed[:, -2:]).view(np.int32)[:, 0].astype(np.int64)
    if as_int16:
        return packed[:, :-2], counts
    return packed[:, :-2].astype(np.float32) / np.float32(32767.0), counts


def _reference_embedding_fused(codec_cfg, wavlm_cfg, codec_w: dict, wavlm_w: dict,
                               wav: torch.Tensor, n: torch.Tensor,
                               buckets: torch.Tensor) -> torch.Tensor:
    """wav16k [1, bucket], n [1] int32 -> packed [emb (adanorm_dim) |
    ssl_ok | pre_ok] f32 (miotts_tpu/pipeline.py:66-88): the WavLM forward,
    the finite-fallback choice between ssl and ssl_pre (checked over the
    VALID frames only), the padded frames zeroed, and the global encoder."""
    from .models.wavlm import wavlm_forward

    ssl, ssl_pre, fl = wavlm_forward(wavlm_cfg, wavlm_w, wav, n, buckets)
    valid = time_mask(ssl.shape[1], fl)[:, :, None]
    ssl_ok = (torch.isfinite(ssl) | ~valid).all()
    pre_ok = (torch.isfinite(ssl_pre) | ~valid).all()
    zero = torch.zeros((), device=ssl.device)
    feats = torch.where(ssl_ok, ssl, torch.where(pre_ok, ssl_pre, zero))
    feats = torch.where(valid, feats, zero)  # padded frames stay exactly 0
    emb = encode_global_embedding(codec_cfg, codec_w, feats, fl)
    return torch.cat([emb[0].float(), torch.stack([ssl_ok, pre_ok]).float()])


@dataclasses.dataclass
class ReferenceStats:
    """How one reference became an embedding: host ms of decode, peak
    normalization and resampling; wall ms of the device chain (upload to
    the host read, the audio-stat rung's encoder included); the 16 kHz
    samples, their WavLM bucket and its frames; the fallback rung taken;
    how the chain ran (the CPU's chains are all eager)."""
    decode_ms: float
    device_ms: float
    n_samples: int
    bucket: int
    frames: int
    rung: str  # "ssl", "ssl_pre" or "audio_stat"
    route: str  # "eager", "capture" (and its replay) or "replay"


def pick_bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


@dataclasses.dataclass(frozen=True)
class CodecKey:
    """What one codec graph is captured for: the batch and its bucket, and
    every decode option the JAX ``jit`` treats as static (whether a cond is
    given, the resample anchor, peak normalization, the window length or
    None, a pcm16 transfer, the sp ranks the time axis splits over).
    Lengths, codes, cond values and the window start are inputs."""
    B: int
    bucket: int
    cond: bool
    interp_anchor: int | None
    peak_normalize: bool
    window: int | None
    pcm16: bool
    sp: int = 1


@dataclasses.dataclass
class SynthesisResult:
    audio: np.ndarray  # f32 mono, valid samples only
    sample_rate: int
    decode_ms: float
    n_codes: int
    n_frames: int
    # window fetch (streaming): audio is the slice [window_start,
    # window_start + len(audio)) of the decode, and n_total is the decode's
    # count of valid samples
    window_start: int = 0
    n_total: int | None = None


class MioTTSPipeline:
    """Codec weights on one device (or replicated over an sp mesh), shared
    by every synthesis call."""

    def __init__(self, codec_path: str | Path, device: torch.device,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, check_syncs: bool = True,
                 wavlm_path: str | Path | None = None, sp_devices: list | None = None):
        self.codec_path = str(codec_path)
        # run a key's eager decode and a capture's warm-up with every host
        # sync an error (a process-wide mode: a server, whose other threads
        # read the card meanwhile, turns it off)
        self.check_syncs = check_syncs
        # sequence parallelism: the mesh, its lead the pipeline's device, one
        # weight tree a rank (``sp_weights``; ``weights`` the lead's)
        self.sp_mesh = None
        self.sp_weights = None
        sharding = None
        if sp_devices is not None and len(sp_devices) > 1:
            self.sp_mesh = make_sp_mesh(sp_devices)
            device = self.sp_mesh.lead
            sharding = list(self.sp_mesh.devices)
        self.config, placed = load_miocodec(self.codec_path, device, sharding=sharding)
        if sharding is None:
            self.weights = placed
        else:
            self.sp_weights, self.weights = placed, placed[0]
        # the codec's precision, read once: a captured graph keeps what it
        # was captured with
        self.codec_matmul = codec_matmul_mode(os.environ.get("MIOTTS_CODEC_MATMUL", "float32"))
        self.buckets = buckets
        self._init_decodes(device)
        if self.sp_mesh is not None and not self.sp_mesh.one_device:
            self.use_graph = False  # a mesh over cards: every decode eager
        # the reference chain (voice cloning): its graphs by WavLM bucket,
        # the buckets run so far, its stream and its graphs' own pool
        self.wavlm = None
        self.ref_graphs: dict[int, codec_graph.CodecGraph] = {}
        self.ref_seen: set[int] = set()
        self._ref_stream = None
        self.ref_graph_pool = None
        self._ref_lock = threading.Lock()
        if wavlm_path:
            from .models.wavlm import WavLMExtractor

            self.wavlm = WavLMExtractor(str(wavlm_path), device, sharding=sharding)
            if device.type == "cuda":
                self._ref_stream = torch.cuda.Stream(device)
                self.ref_graph_pool = torch.cuda.graph_pool_handle()

    def _init_decodes(self, device: torch.device) -> None:
        """The decode side's state on ``device``: counters, the codec graphs
        (CUDA's path: by key, every key decoded so far with the thread that
        ran its eager decode, the stream every CUDA decode runs on and the
        graphs' shared pool) and the lock around a decode."""
        self.device = device
        # decodes run and their host time, for callers that count them
        self.n_decodes = 0
        self.decode_ms_total = 0.0
        self.use_graph = device.type == "cuda"
        self.graphs: dict[CodecKey, codec_graph.CodecGraph] = {}
        self.seen: dict[CodecKey, threading.Thread] = {}
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.graph_pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self._lock = threading.Lock()
        self._replicas: dict = {}

    def replica(self, device: torch.device) -> "MioTTSPipeline":
        """This codec's decode side on another device (a dp rank of a
        mesh), its weights copied there: graphs, stream, pool and lock of
        its own; the config, buckets and precision shared. The pipeline
        itself where ``device`` is its own device; one replica a device,
        made at first use."""
        if same_device(device, self.device):
            return self
        key = (device.type, device.index)
        rep = self._replicas.get(key)
        if rep is None:
            rep = object.__new__(type(self))
            rep.__dict__.update(codec_path=self.codec_path, check_syncs=self.check_syncs,
                                config=self.config, weights=tree_to(self.weights, device),
                                codec_matmul=self.codec_matmul, buckets=self.buckets,
                                sp_mesh=None, sp_weights=None, wavlm=None, ref_graphs={},
                                ref_seen=set(), _ref_stream=None, ref_graph_pool=None,
                                _ref_lock=threading.Lock())
            rep._init_decodes(device)
            rep = self._replicas.setdefault(key, rep)
        return rep

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def samples_per_token(self) -> int:
        return self.config.samples_per_token

    @property
    def is_dynamic_global(self) -> bool:
        return self.config.dynamic_global

    @property
    def has_global_encoder(self) -> bool:
        return "global_encoder" in self.weights

    @staticmethod
    def load_embedding(path: str | Path) -> np.ndarray:
        return load_embedding_gguf(path)

    @staticmethod
    def save_embedding(path: str | Path, embedding: np.ndarray) -> None:
        save_embedding_gguf(path, embedding)

    def validate_request(self, codes, embedding) -> tuple[np.ndarray, np.ndarray | None]:
        """mio_tts_synthesize preconditions (mio-tts-lib.cpp:1198-1234).
        Returns normalized (codes, embedding)."""
        codes = np.asarray(codes, dtype=np.int32).reshape(-1)
        if codes.size == 0:
            raise ValueError("codes are empty")
        if codes.min() < MIO_CODE_MIN or codes.max() > MIO_CODE_MAX:
            if codes.max() >= self.config.vocab_size or codes.min() < 0:
                raise ValueError("code id out of range")
        if self.config.dynamic_global and embedding is None:
            raise ValueError("dynamic-global MioCodec requires embedding")
        if not self.config.dynamic_global and embedding is not None:
            raise ValueError("static MioCodec does not accept external embedding")
        if embedding is not None:
            embedding = np.asarray(embedding, dtype=np.float32).reshape(-1)
            if embedding.size != self.config.decoder_adanorm_dim:
                raise ValueError("embedding dimension mismatch")
        return codes, embedding

    def synthesize(self, codes, embedding: np.ndarray | None = None,
                   interp_anchor: int | None = None, peak_normalize: bool = True,
                   window: tuple[int, int] | None = None, pcm16: bool = False
                   ) -> SynthesisResult:
        """codes -> waveform (mio_tts_synthesize, mio-tts-lib.cpp:1182-1323),
        peak-normalized unless ``peak_normalize`` is False; ``interp_anchor``
        pins the resample ratio (streaming prefix re-decodes).

        ``window=(start, length)`` brings back only audio[start:start +
        length] and the decode's total count (``n_total``): a streaming
        feed's emission is a small slice of its prefix decode.

        ``pcm16`` brings the audio back as 16-bit PCM (half the bytes); the
        result's audio is those values scaled back to f32."""
        codes, embedding = self.validate_request(codes, embedding)
        n = int(codes.size)
        bucket = -(-pick_bucket(n, self.buckets) // self.sp) * self.sp  # even token shards
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = codes
        start = 0 if window is None else int(window[0])
        maybe_start_profiler()
        with trace_phase("miocodec_synthesize"):
            audio, counts, decode_ms = self.decode(
                tokens, np.array([n], np.int32), None if embedding is None else embedding[None],
                interp_anchor=interp_anchor, peak_normalize=peak_normalize,
                window=None if window is None else int(window[1]),
                starts=None if window is None else np.array([start], np.int32), pcm16=pcm16)
        n_valid = int(counts[0])
        if window is not None:
            audio_np = audio[0, :max(0, min(int(window[1]), n_valid - start))]
        else:
            audio_np = audio[0, :n_valid]
        return SynthesisResult(audio=audio_np, sample_rate=self.config.sample_rate,
                               decode_ms=decode_ms, n_codes=n,
                               n_frames=n_valid // self.config.hop_length, window_start=start,
                               n_total=None if window is None else n_valid)

    def decode(self, tokens: np.ndarray, lengths: np.ndarray, cond: np.ndarray | None = None, *,
               interp_anchor: int | None = None, peak_normalize: bool = True,
               window: int | None = None, starts: np.ndarray | None = None,
               pcm16: bool = False, as_int16: bool = False
               ) -> tuple[np.ndarray, np.ndarray, float]:
        """One decode of B lanes: tokens [B, bucket] (zeros past each
        length), lengths [B], cond [B, Dc] or None; with ``window``, lane b
        brings back audio[starts[b]:starts[b] + window]. Returns (audio [B,
        L] f32 on the host, or the int16 PCM under ``pcm16`` and
        ``as_int16``, valid-sample counts [B], host ms). On CUDA the key's
        first decode is eager, its second captures its graph (with a
        warm-up of its own unless the same thread ran the first), and the
        rest replay it."""
        key, host = self._prepare(tokens, lengths, cond, interp_anchor=interp_anchor,
                                  peak_normalize=peak_normalize, window=window, starts=starts,
                                  pcm16=pcm16)
        with self._lock, self._on_stream():
            t0 = time.perf_counter()
            if key in self.graphs:
                packed = self.graphs[key].run(host)
            elif self.use_graph and key in self.seen:
                # no warm-up where this thread ran the key's eager decode;
                # another thread's would leave this one without its own
                # cuBLAS and cuDNN handles, made then inside the capture
                warm_up = self.seen[key] is not threading.current_thread()
                packed = self._capture(key, warm_up=warm_up).run(host)
            else:
                packed = self._eager(key, host)
                self.seen[key] = threading.current_thread()
            decode_ms = (time.perf_counter() - t0) * 1e3
            self.n_decodes += 1
            self.decode_ms_total += decode_ms
        audio, counts = _unpack(packed, pcm16, as_int16)
        return audio, counts, decode_ms

    def decode_eager(self, tokens: np.ndarray, lengths: np.ndarray,
                     cond: np.ndarray | None = None, **options) -> tuple[np.ndarray, np.ndarray]:
        """``decode``'s body run eagerly on the same arguments whatever the
        key's state, as a reference for a replay: (audio [B, L], counts
        [B]). On CUDA it counts as an eager decode."""
        key, host = self._prepare(tokens, lengths, cond, **options)
        with self._lock:
            return _unpack(self._eager(key, host), key.pcm16)

    def _prepare(self, tokens: np.ndarray, lengths: np.ndarray, cond: np.ndarray | None, *,
                 interp_anchor: int | None = None, peak_normalize: bool = True,
                 window: int | None = None, starts: np.ndarray | None = None,
                 pcm16: bool = False) -> tuple[CodecKey, dict[str, np.ndarray]]:
        """A decode's key and its host arrays, named as the graph's inputs."""
        B, bucket = tokens.shape
        key = CodecKey(B, bucket, cond is not None, interp_anchor, peak_normalize, window, pcm16,
                       self.sp)
        host = {"tokens": np.ascontiguousarray(tokens, np.int64),
                "lengths": np.ascontiguousarray(lengths, np.int32)}
        if cond is not None:
            host["cond"] = np.ascontiguousarray(cond, np.float32)
        if window is not None:
            host["starts"] = np.ascontiguousarray(starts, np.int32)
        return key, host

    def capture(self, bucket: int, B: int = 1, *, cond: bool | None = None,
                interp_anchor: int | None = None, peak_normalize: bool = True,
                window: int | None = None, pcm16: bool = False) -> codec_graph.CodecGraph:
        """The graph of a key, captured now unless it exists; later decodes
        of the key replay it. ``cond`` defaults to whether the codec takes
        an embedding. The capture runs its own warm-up even for a key
        decoded before: that decode may have run on another thread (a
        server's warm-up tail captures keys its codec thread decoded), and
        a thread's cuBLAS and cuDNN handles are its own."""
        if cond is None:
            cond = self.config.dynamic_global
        key = CodecKey(B, bucket, cond, interp_anchor, peak_normalize, window, pcm16, self.sp)
        with self._lock:
            if key not in self.graphs:
                self._capture(key, warm_up=True)
                self.seen[key] = threading.current_thread()
            return self.graphs[key]

    def _eager(self, key: CodecKey, host: dict[str, np.ndarray]) -> np.ndarray:
        """The decode body run eagerly on ``host``'s arrays: the CPU's path,
        and on CUDA a key's first decode (any host sync inside it an error)
        or a reference asked for by name. Returns the packed rows."""
        with self._on_stream():
            with tracing.on_device():
                inputs = {k: to_device(v, self.device) for k, v in host.items()}
                if self.device.type != "cuda":
                    return self._body(key)(inputs).numpy()
                codec_graph.codec.eager += 1
                out = codec_graph.run_checked(self._body(key), inputs, self.check_syncs)
            return to_host(out)

    @property
    def sp(self) -> int:
        """The ranks a decode's time axis splits over (1: no mesh)."""
        return 1 if self.sp_mesh is None else self.sp_mesh.shape["sp"]

    def _body(self, key: CodecKey):
        cfg, w = self.config, self.weights
        if key.sp > 1:
            return self._sp_body(key)

        def body(inputs: dict[str, torch.Tensor]) -> torch.Tensor:
            audio, n_samples = codec_synthesize(
                cfg, w, inputs["tokens"], inputs["lengths"], inputs.get("cond"),
                interp_anchor_tokens=key.interp_anchor, peak_normalize=key.peak_normalize,
                matmul=self.codec_matmul)
            if key.window is not None:
                audio = _window_slice(audio, inputs["starts"], key.window)
            return _pack(audio, n_samples, key.pcm16)
        return body

    def _sp_body(self, key: CodecKey):
        """``_body`` over the sp mesh: the window read from the split audio
        by global index (``seq.gather_rows``), else the audio joined on the
        lead."""
        def body(inputs: dict[str, torch.Tensor]) -> torch.Tensor:
            audio, n_samples = codec_synthesize_sharded(
                self.config, self.sp_weights, inputs["tokens"], inputs["lengths"],
                inputs.get("cond"), key.interp_anchor, key.peak_normalize, self.sp_mesh,
                matmul=self.codec_matmul)
            if key.window is None:
                return _pack(seq.join(audio), n_samples, key.pcm16)
            idx = inputs["starts"][:, None].long() + torch.arange(
                key.window, device=self.device)[None, :]
            win = seq.gather_rows(audio, [idx.clamp(0, audio.total - 1)])[0]
            win = torch.where(idx < audio.total, win,
                              torch.zeros((), dtype=win.dtype, device=win.device))
            return _pack(win, n_samples, key.pcm16)
        return body

    def _capture(self, key: CodecKey, warm_up: bool) -> codec_graph.CodecGraph:
        """Capture ``key``'s graph on fresh static buffers (full lengths,
        zero tokens, cond and starts) and keep it."""
        dev = self.device
        inputs = {"tokens": torch.zeros((key.B, key.bucket), dtype=torch.int64, device=dev),
                  "lengths": torch.full((key.B,), key.bucket, dtype=torch.int32, device=dev)}
        if key.cond:
            inputs["cond"] = torch.zeros((key.B, self.config.decoder_adanorm_dim), device=dev)
        if key.window is not None:
            inputs["starts"] = torch.zeros((key.B,), dtype=torch.int32, device=dev)
        graph = codec_graph.CodecGraph(self._body(key), inputs, self._stream, self.graph_pool,
                                       warm_up=warm_up, check_syncs=self.check_syncs)
        self.graphs[key] = graph
        return graph

    # -- voice cloning ---------------------------------------------------------

    def reference_to_embedding(self, reference_audio: str | Path,
                               max_reference_seconds: float = 20.0) -> np.ndarray:
        """Reference audio -> speaker embedding [adanorm_dim] f32
        (mio_tts_reference_to_embedding, mio-tts-lib.cpp:1048-1125)."""
        return self.reference_embedding(reference_audio, max_reference_seconds)[0]

    def reference_embedding(self, reference_audio: str | Path,
                            max_reference_seconds: float = 20.0
                            ) -> tuple[np.ndarray, ReferenceStats]:
        """``reference_to_embedding`` and how it went (``ReferenceStats``)."""
        if not self.is_dynamic_global:
            raise ValueError("reference embedding requires dynamic-global MioCodec")
        if not self.has_global_encoder:
            raise ValueError("reference embedding requires global_encoder tensors in MioCodec GGUF")
        if self.wavlm is None:
            raise ValueError("WavLM model is not loaded")
        with trace_phase("reference_chain"):
            return self._reference_embedding(reference_audio, max_reference_seconds)

    def reference_embedding_eager(self, reference_audio: str | Path,
                                  max_reference_seconds: float = 20.0) -> np.ndarray:
        """``reference_to_embedding`` with the device chain run eagerly
        whatever its bucket's graph, as a reference for a replay (the
        ssl/ssl_pre rungs; on CUDA it counts as an eager run)."""
        wav16k, bucket, host = self._reference_input(reference_audio, max_reference_seconds)
        with self._ref_lock, self._on_stream(self._ref_stream):
            packed = self._reference_eager(self.wavlm.config.conv_out_len(bucket), host)
        return np.array(packed[:self.config.decoder_adanorm_dim], dtype=np.float32)

    def _reference_input(self, reference_audio, max_reference_seconds: float
                         ) -> tuple[np.ndarray, int, dict[str, np.ndarray]]:
        """The host side: the 16 kHz waveform, its WavLM bucket and the
        chain's host inputs (the padded waveform, its length)."""
        wav16k = self.wavlm.preprocess_reference(
            reference_audio, source_rate=self.config.sample_rate,
            max_seconds=max_reference_seconds)
        n = int(wav16k.size)
        bucket = self.wavlm.pick_wav_bucket(n)
        padded = np.zeros((1, bucket), np.float32)
        padded[0, :n] = wav16k
        return wav16k, bucket, {"wav": padded, "lengths": np.array([n], np.int32)}

    def _reference_embedding(self, reference_audio, max_reference_seconds: float
                             ) -> tuple[np.ndarray, ReferenceStats]:
        t0 = time.perf_counter()
        wav16k, bucket, host = self._reference_input(reference_audio, max_reference_seconds)
        n = int(wav16k.size)
        t1 = time.perf_counter()
        frames = self.wavlm.config.conv_out_len(bucket)
        with self._ref_lock, self._on_stream(self._ref_stream):
            if bucket in self.ref_graphs:
                route, packed = "replay", self.ref_graphs[bucket].run(host)
            elif self.use_graph and bucket in self.ref_seen:
                route, packed = "capture", self._capture_reference(bucket, frames).run(host)
            else:
                route, packed = "eager", self._reference_eager(frames, host)
                self.ref_seen.add(bucket)
            d = self.config.decoder_adanorm_dim
            emb, ssl_ok, pre_ok = packed[:d], packed[d] > 0, packed[d + 1] > 0
            rung = "ssl" if ssl_ok else "ssl_pre" if pre_ok else "audio_stat"
            if rung == "audio_stat":
                # both SSL feature sets non-finite: the reference's last rung,
                # on the host (rare), through the encoder alone
                from .models.wavlm import _audio_stat_fallback

                fb = _audio_stat_fallback(wav16k, self.wavlm.config.embed_dim)
                emb = to_host(encode_global_embedding(
                    self.config, self.weights, to_device(fb[None], self.device),
                    to_device(np.array([fb.shape[0]], np.int32), self.device))[0])
        t2 = time.perf_counter()
        stats = ReferenceStats(decode_ms=(t1 - t0) * 1e3, device_ms=(t2 - t1) * 1e3,
                               n_samples=n, bucket=bucket, frames=frames, rung=rung, route=route)
        return np.array(emb, dtype=np.float32), stats

    def _reference_chain(self, x: dict[str, torch.Tensor]) -> torch.Tensor:
        return _reference_embedding_fused(self.config, self.wavlm.config, self.weights,
                                          self.wavlm.weights, x["wav"], x["lengths"], x["buckets"])

    def _reference_eager(self, frames: int, host: dict[str, np.ndarray]) -> np.ndarray:
        """The chain run eagerly on ``host``'s padded waveform and length:
        the CPU's path, and on CUDA a bucket's first chain. Returns the
        packed row."""
        inputs = {k: to_device(v, self.device) for k, v in host.items()}
        inputs["buckets"] = self.wavlm.bucket_table(frames)[1]
        if self.device.type != "cuda":
            return self._reference_chain(inputs).numpy()
        codec_graph.reference.eager += 1
        return to_host(codec_graph.run_checked(self._reference_chain, inputs, self.check_syncs))

    def _capture_reference(self, bucket: int, frames: int) -> codec_graph.CodecGraph:
        """Capture the chain of ``bucket`` on fresh static buffers (zeros, a
        full length) and the bucket's table, in the reference graphs' pool,
        and keep it. The capture runs its own warm-up: a server runs each
        generation on its request's thread, so the bucket's eager chain may
        have run on another thread, and cuBLAS and cuDNN handles are a
        thread's own (one created during a capture breaks it)."""
        dev = self.device
        inputs = {"wav": torch.zeros((1, bucket), dtype=torch.float32, device=dev),
                  "lengths": torch.full((1,), bucket, dtype=torch.int32, device=dev),
                  "buckets": self.wavlm.bucket_table(frames)[1]}
        graph = codec_graph.CodecGraph(self._reference_chain, inputs, self._ref_stream,
                                       self.ref_graph_pool, warm_up=True,
                                       check_syncs=self.check_syncs,
                                       counters=codec_graph.reference)
        self.ref_graphs[bucket] = graph
        return graph

    def estimate_reference_workspace_bytes(self, max_reference_seconds: float = 20.0) -> int:
        """Rough device-memory footprint of one reference chain
        (miotts_tpu/pipeline.py:350-358)."""
        if self.wavlm is None:
            raise ValueError("WavLM model is not loaded")
        frames = self.wavlm.estimate_ssl_frames(self.config.sample_rate, max_reference_seconds)
        e = self.wavlm.config.embed_dim
        h = self.wavlm.config.n_heads
        return int(4 * frames * e * 20 + 4 * frames * frames * h * 2)

    def _on_stream(self, stream: torch.cuda.Stream | None = None):
        """CUDA work of a decode runs on the pipeline's own stream, the one
        its graphs are captured on (so the first, eager decode of a key warms
        up that stream's cuBLAS workspace); a reference chain's on
        ``stream``, its own."""
        stream = stream or self._stream
        if stream is None:
            return contextlib.nullcontext()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(stream)
