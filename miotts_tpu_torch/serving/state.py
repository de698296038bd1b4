"""Server state: config, reference cache, request params (the port's copy
of miotts_tpu/serving/state.py, held to it by tests/test_torch_host.py).

Mirrors the reference's server_config / request_params / reference_cache
(tts-mio-server.cpp:608-714, parse_request_json :2036-2151) with identical
JSON field aliases, defaults and clamps.
"""

from __future__ import annotations

import dataclasses
import re
import threading

import numpy as np

_KEY_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,128}$")


def is_valid_reference_key(key: str) -> bool:
    """Charset/length validation (tts-mio-server.cpp:766-780)."""
    return bool(_KEY_RE.match(key))


@dataclasses.dataclass
class ServerConfig:
    model_vocoder: str = ""
    model: str = ""
    wavlm_model: str = ""
    embedding_default_in: str = ""
    host: str = "127.0.0.1"
    port: int = 18089
    output_dir: str = "/tmp"
    reference_added_output_dir: str = ""
    n_parallel: int = 1
    llm_shared_context: bool = True
    n_parallel_reference_generation: int = 0
    n_threads: int = 2
    n_ctx: int = 700
    n_predict: int = 700
    top_k: int = 50
    top_p: float = 1.0
    temp: float = 0.8
    repeat_penalty: float = 1.0
    seed: int = 0
    max_reference_seconds: float = 20.0
    llm_api_url: str = ""
    llm_api_key: str = ""
    llm_api_model: str = ""
    llm_api_headers: str = ""
    llm_api_timeout: int = 120
    llm_api_mode: str = "openai-chat"
    reference_file_json: str = ""
    # --tensor-parallel: shard the LLM megatron-style over this many chips
    # of the --mio-backend-devices mesh (for models too big per chip; the
    # remaining devices form the dp axis). TPU addition — the reference is
    # single-node GGML with no tensor parallelism.
    tensor_parallel: int = 1
    # --llm-quant: LLM weight numerics — "" (env/bf16 default), "output"
    # (quantize only the 152k-vocab logits matmul), "output_int8" (W8A8
    # logits head only: the head is ~60% of the 0.1B step's weight bytes
    # and sits at its bf16 HBM roofline — measured 25% off the decode
    # step), "output_int4" (W4A8 head: jnp.int4 streams 0.5 B/param —
    # measured 36% off the step; the aggressive end, analogous to the
    # reference's Q4_0 mobile exports where EVERY weight is 4-bit),
    # "q8_0" (Q8_0 blocks, Pallas dequant matmul), "int8" (W8A8:
    # per-channel int8 weights + dynamic int8 activations; 2.0x decode at
    # 1.63B and -34% on the 0.1B step, DESIGN.md), "int8_output_int4"
    # (W8A8 layers + W4A8 head — the two wins stack; the fastest measured
    # 0.1B decode config). TPU addition — the reference inherits whatever
    # GGUF quant llama.cpp loads (and llama.cpp's Q8_0 matmuls quantize
    # activations to int8 blocks too, so W8A8 is the closer analog).
    llm_quant: str = ""
    # --mio-backend-devices: dp fan-out over chips ("all", "0,2", or
    # platform:id names); lanes/micro-batches shard over the resulting mesh
    mio_backend_devices: str = ""
    # --codec-devices: place codec synthesis on its OWN device set, disjoint
    # from the LLM mesh — overlap/streaming prefix decodes then run on chips
    # the LLM isn't using instead of serializing behind its chunk steps
    # (measured: on ONE chip overlap loses 2x because the chip runs one
    # kernel at a time; disjoint placement is the win condition)
    codec_devices: str = ""
    warmup: bool = False  # compile serving executables at startup (TPU addition)
    # --overlap-synthesis on: default non-streaming text requests to
    # LLM-interleaved incremental synthesis (see RequestParams.overlap_synthesis)
    overlap_synthesis: bool = False
    slot_timeout: float = 0.0  # >0: shed load with 503 instead of queueing forever
    max_body_bytes: int = 256 * 1024 * 1024  # 413 above this (uploads are ~MBs)

    @property
    def llm_api_enabled(self) -> bool:
        return bool(self.llm_api_url)


@dataclasses.dataclass
class RequestParams:
    text: str = ""
    output_file: str = ""
    codes_in: str = ""
    codes_out: str = ""
    embedding_in: str = ""
    embedding_default_in: str = ""
    embedding_out: str = ""
    reference_key: str = ""
    reference_audio: str = ""
    n_threads: int = 2
    n_ctx: int = 700
    n_predict: int = 700
    top_k: int = 50
    top_p: float = 1.0
    temp: float = 0.8
    repeat_penalty: float = 1.0
    seed: int = 0
    max_reference_seconds: float = 20.0
    codes_only: bool = False
    embedding_only: bool = False
    stream_tokens: bool = False
    # TPU addition (BASELINE config 4): deliver audio incrementally while
    # generation runs — SSE ``audio_chunk`` events (with stream_tokens) or a
    # chunked streaming WAV body (without). The reference always synthesizes
    # fully before sending (tts-mio-server.cpp:3876-3886).
    stream_audio: bool = False
    # TPU addition: for non-streaming text requests, interleave codec prefix
    # re-decodes with LLM generation so the response is ready ~one lookahead
    # window after the last token instead of paying the full decode + PCM
    # fetch serially. Audio is the streaming synthesizer's crossfaded
    # emission (sub-1e-3 boundary drift vs the single-shot decode), so this
    # is opt-in (per-request or --overlap-synthesis on).
    overlap_synthesis: bool = False
    inline_codes: list[int] = dataclasses.field(default_factory=list)


class RequestError(ValueError):
    def __init__(self, message: str, code: int = 400):
        super().__init__(message)
        self.code = code


def _get_str(body: dict, key: str) -> str:
    v = body.get(key)
    return v if isinstance(v, str) else ""


def parse_request_json(body: dict, cfg: ServerConfig) -> RequestParams:
    """parse_request_json parity (tts-mio-server.cpp:2036-2151)."""
    rp = RequestParams(
        n_threads=cfg.n_threads, n_ctx=cfg.n_ctx, n_predict=cfg.n_predict,
        top_k=cfg.top_k, top_p=cfg.top_p, temp=cfg.temp,
        repeat_penalty=cfg.repeat_penalty, seed=cfg.seed,
        max_reference_seconds=cfg.max_reference_seconds,
        overlap_synthesis=cfg.overlap_synthesis,
    )
    rp.text = _get_str(body, "text") or _get_str(body, "prompt") or _get_str(body, "input")
    rp.output_file = _get_str(body, "output_file")
    rp.codes_in = _get_str(body, "codes_in")
    rp.codes_out = _get_str(body, "codes_out")
    rp.embedding_in = _get_str(body, "embedding_in")
    rp.embedding_default_in = (_get_str(body, "default_embedding_in")
                               or _get_str(body, "tts_mio_default_embedding_in"))
    rp.embedding_out = _get_str(body, "embedding_out")
    rp.reference_key = (_get_str(body, "reference_key")
                        or _get_str(body, "tts_reference_key")
                        or _get_str(body, "key"))
    rp.reference_audio = (_get_str(body, "reference_audio")
                          or _get_str(body, "tts_reference_audio"))

    for field, key in [("n_threads", "threads"), ("n_ctx", "n_ctx"),
                       ("n_predict", "n_predict"), ("top_k", "top_k"),
                       ("seed", "seed")]:
        if key in body and body[key] is not None:
            setattr(rp, field, int(body[key]))
    for field, key in [("top_p", "top_p"), ("temp", "temp"),
                       ("repeat_penalty", "repeat_penalty"),
                       ("max_reference_seconds", "max_reference_seconds")]:
        if key in body and body[key] is not None:
            setattr(rp, field, float(body[key]))
    for field in ("codes_only", "embedding_only", "stream_tokens",
                  "stream_audio", "overlap_synthesis"):
        if field in body and body[field] is not None:
            setattr(rp, field, bool(body[field]))

    if rp.stream_tokens and cfg.llm_api_enabled:
        raise RequestError("stream_tokens is not supported when external LLM API mode is enabled")

    codes = body.get("codes")
    if codes is not None:
        if not isinstance(codes, list):
            raise RequestError("codes must be an array")
        from ..runtime.codes_io import parse_code_token
        from .. import MIO_CODE_MAX, MIO_CODE_MIN

        parsed = []
        for c in codes:
            if isinstance(c, (int, float)):
                v = int(c)
            elif isinstance(c, str):
                v = parse_code_token(c)
                if v is None:
                    raise RequestError(f"failed to parse code token: {c}")
            else:
                raise RequestError("codes entries must be numbers or strings")
            if v < MIO_CODE_MIN or v > MIO_CODE_MAX:
                raise RequestError("code id out of range")
            parsed.append(v)
        rp.inline_codes = parsed

    wants_synthesis = not rp.codes_only and not rp.embedding_only
    if wants_synthesis and not rp.reference_key:
        raise RequestError("synthesis requires reference_key")
    if (rp.embedding_only and not rp.reference_key and not rp.reference_audio
            and not rp.embedding_in and not rp.embedding_default_in
            and not cfg.embedding_default_in):
        raise RequestError("embedding_only requires reference_key or reference_audio "
                           "or embedding_in or default_embedding_in")
    if rp.reference_key and not is_valid_reference_key(rp.reference_key):
        raise RequestError("reference_key is invalid")
    if rp.n_ctx < 1:
        raise RequestError("n_ctx must be >= 1")
    if rp.n_ctx > cfg.n_ctx:
        raise RequestError(f"n_ctx exceeds preallocated slot context ({rp.n_ctx} > "
                           f"{cfg.n_ctx}), restart server with larger --ctx-size")
    if rp.n_predict < 1:
        raise RequestError("n_predict must be >= 1")
    rp.n_predict = min(rp.n_predict, cfg.n_predict, cfg.n_ctx)
    return rp


class ReferenceCache:
    """Key -> speaker embedding, guarded like the reference's
    (tts-mio-server.cpp:711-714)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_key: dict[str, np.ndarray] = {}

    def get(self, key: str) -> np.ndarray | None:
        with self._lock:
            v = self._by_key.get(key)
            return None if v is None else v.copy()

    def put(self, key: str, emb: np.ndarray) -> None:
        with self._lock:
            self._by_key[key] = np.asarray(emb, np.float32).reshape(-1)

    def remove(self, key: str) -> bool:
        with self._lock:
            return self._by_key.pop(key, None) is not None

    def items(self) -> list[tuple[str, int]]:
        with self._lock:
            return sorted((k, v.size) for k, v in self._by_key.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_key)
