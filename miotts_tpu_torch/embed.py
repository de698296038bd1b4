"""Embeddable single-context engine (miotts_tpu/embed.py).

The counterpart of the reference's mobile shared engine
(mio-tts-mobile-shared.hpp:44-82, synthesize_text_to_wav :906,
synthesize_codes_to_wav :800, create_reference_from_audio :547,
register_default_references :1060): one object owning every model, with a
named reference map and a lazily loaded LLM, returning finished WAV bytes,
for applications that do not want the HTTP server. ``unload_llm()`` drops
the LLM between syntheses, as the mobile engine's
``llm_unload_after_generation`` does.

The device is the caller's, or ``device.select_device()`` (so
``MIOTTS_PLATFORM``). On a CPU device a Q8_0/Q4_0 GGUF runs the native
int8/int4 CPU engine (``models/llm_cpu.py``), as the JAX engine picks it
(miotts_tpu/embed.py:71-92); anything else, or that engine failing to
load, runs the port's ``LLMEngine``.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np
import torch

from .device import select_device
from .models.sampling import SamplerParams
from .pipeline import MioTTSPipeline
from .runtime.audio_io import encode_wav16


def _key_from_path(path: str) -> str:
    """Default reference key from a file name (fallback_reference_key_from_path,
    mio-tts-mobile-shared.hpp:402-417): basename minus .emb.gguf/.gguf."""
    name = os.path.basename(path)
    for suffix in (".emb.gguf", ".gguf"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return os.path.splitext(name)[0]


class MioTTSEngine:
    """Single-context engine with a reference map. Thread-safe."""

    def __init__(self, vocoder_model: str, llm_model: str = "",
                 wavlm_model: str = "", n_predict: int = 400,
                 temp: float = 0.8, top_k: int = 50, top_p: float = 1.0,
                 repeat_penalty: float = 1.0, seed: int = 0,
                 max_reference_seconds: float = 20.0,
                 llm_unload_after_generation: bool = False,
                 device: torch.device | None = None):
        self.device = device if device is not None else select_device()
        # check_syncs off, as a server's pipeline: the sync-debug mode of a
        # key's first decode is global to the process, and other threads
        # may use the card meanwhile (an unload_llm() and its reload)
        self.pipeline = MioTTSPipeline(vocoder_model, self.device, check_syncs=False,
                                       wavlm_path=wavlm_model or None)
        self.llm_model_path = llm_model
        self.llm_unload_after_generation = llm_unload_after_generation
        self.n_predict = n_predict
        self.sampler = SamplerParams(temp=temp, top_k=top_k, top_p=top_p,
                                     repeat_penalty=repeat_penalty, seed=seed)
        self.max_reference_seconds = max_reference_seconds
        self.references: dict[str, np.ndarray] = {}
        self.default_reference_key: str | None = None
        self._llm = None
        self._lock = threading.RLock()
        self.last_error = ""

    # -- LLM lifecycle (ensure_llm_runtime / unload_llm_runtime parity) ---------

    def _ensure_llm(self):
        with self._lock:
            if self._llm is None:
                if not self.llm_model_path:
                    raise ValueError("LLM model path is not configured")
                self._llm = self._make_llm()
            return self._llm

    def _make_llm(self):
        """Engine selection as the CLI's ``--cpu-native auto``: on a CPU
        device a Q8_0/Q4_0 GGUF runs the native block-quant engine."""
        if self.device.type == "cpu":
            try:
                from .models.llm_cpu import NativeCpuLLMEngine, gguf_llm_cpu_native_ok

                if gguf_llm_cpu_native_ok(self.llm_model_path):
                    return NativeCpuLLMEngine(self.llm_model_path)
            except Exception:
                pass
        from .models.llm import LLMEngine

        return LLMEngine(self.llm_model_path, self.device)

    def unload_llm(self) -> None:
        with self._lock:
            self._llm = None

    # -- references ----------------------------------------------------------------

    def register_reference(self, key: str, embedding_path: str) -> None:
        self.references[key] = self.pipeline.load_embedding(embedding_path)
        if self.default_reference_key is None:
            self.default_reference_key = key

    def register_default_references(self, directory: str) -> list[str]:
        """Load every *.emb.gguf in a directory (register_default_references,
        mio-tts-mobile-shared.hpp:1060). Returns the keys registered."""
        keys = []
        for p in sorted(Path(directory).glob("*.emb.gguf")):
            key = _key_from_path(str(p))
            self.register_reference(key, str(p))
            keys.append(key)
        return keys

    def create_reference_from_audio(self, key: str, audio_path: str) -> np.ndarray:
        """Voice clone: audio -> embedding, registered under ``key``."""
        emb = self.pipeline.reference_to_embedding(audio_path, self.max_reference_seconds)
        self.references[key] = emb
        if self.default_reference_key is None:
            self.default_reference_key = key
        return emb

    def remove_reference(self, key: str) -> bool:
        return self.references.pop(key, None) is not None

    def _resolve_embedding(self, reference_key: str | None) -> np.ndarray | None:
        if not self.pipeline.is_dynamic_global:
            return None
        key = reference_key or self.default_reference_key
        if key is None or key not in self.references:
            raise KeyError(f"reference_key not found: {key}")
        return self.references[key]

    # -- synthesis --------------------------------------------------------------------

    def synthesize_codes_to_wav(self, codes: list[int],
                                reference_key: str | None = None) -> bytes:
        emb = self._resolve_embedding(reference_key)
        result = self.pipeline.synthesize(codes, emb)
        return encode_wav16(result.audio, result.sample_rate)

    def synthesize_text_to_wav(self, text: str, reference_key: str | None = None,
                               n_predict: int | None = None) -> bytes:
        emb = self._resolve_embedding(reference_key)
        llm = self._ensure_llm()
        try:
            tokens = llm.generate_audio_tokens(
                text, n_predict=n_predict or self.n_predict, sampler=self.sampler)
            codes = llm.tokens_to_codes(tokens)
            if not codes:
                raise ValueError("no Mio audio codes were found in token sequence")
        finally:
            if self.llm_unload_after_generation:
                self.unload_llm()
        result = self.pipeline.synthesize(codes, emb)
        return encode_wav16(result.audio, result.sample_rate)
