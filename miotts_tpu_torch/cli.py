"""llama-tts-mio CLI on PyTorch (miotts_tpu/cli.py:141-381).

The flag surface is the reference's: ``build_parser`` is a copy of
``miotts_tpu.cli.build_parser`` (miotts_tpu/cli.py:27-97), the same flags,
defaults and help. This port runs the paths that take codes or text to a
WAV, with either codec mode (wave: iSTFT head; mel: the bundled vocoder):

- input from -p/--prompt, --prompt-file (local LLM, -m, or an external
  one: --llm-api-url in openai-chat or generic mode, with
  MIO_TTS_LLM_API_URL/_KEY/_MODEL/_HEADERS as fallbacks), --tts-mio-codes
  or --tts-mio-codes-in;
- a speaker embedding from -emb or --tts-mio-embedding-in, or cloned
  from a reference recording (--tts-reference-audio with
  --tts-wavlm-model, cut to --tts-max-reference-seconds; WAV, FLAC or mp3),
  saved by --tts-mio-embedding-out, and --tts-mio-embedding-only to stop
  there. The order of precedence is the JAX CLI's: reference audio, then
  --tts-mio-embedding-in, then -emb;
- --tts-mio-codes-out and --tts-mio-codes-only;
- --llm-quant (or MIOTTS_LLM_QUANT), the whole ladder: bf16, output,
  output_int8, output_int4, q8_0, int8, int8_output_int4;
- --tts-stream-output: the WAV is written while the LLM generates (chunked
  generation interleaved with codec prefix re-decodes,
  ``streaming.stream_text_to_audio``), and its header's sizes are patched
  at the end;
- --tts-remove-reference-key with --tts-reference-dir: deletes
  ``<dir>/<key>.emb.gguf``.

Generation runs in chunks of decode steps; on CUDA each chunk is one
replay of a captured CUDA graph (``models/decode_graph.py``), and the
``llm breakdown:`` line gives the capture's host time. On CUDA a codec
decode is eager the first time its key (bucket and options) is seen, then
captured and replayed (``models/codec_graph.py``); the ``synth
breakdown:`` line counts each route (all 0 on the CPU). A cloned
embedding prints ``reference breakdown:``: the host's decode and resample
ms, the device chain's wall ms, the WavLM bucket and frames, and the rung
of the fallback ladder taken (ssl, ssl_pre or audio_stat). The WAV's rate
is the codec's (24 or 44.1 kHz).

On a CPU device (MIOTTS_PLATFORM=cpu) the text and stream paths run the
native int8/int4 CPU engine (``models/llm_cpu.py``) under ``--cpu-native
on``, or under ``auto`` (the default; MIOTTS_CPU_NATIVE=1/0 sets it) for a
GGUF with Q8_0/Q4_0 matmul weights, as the JAX CLI does; on CUDA the flag
is ignored. ``--sequence-parallel N`` splits the codec decode's time axis
over the first N of ``parallel/mesh.py logical_devices()`` (one a card, or
``MIOTTS_LOGICAL_DEVICES`` ranks of one), codec only, as in the JAX CLI;
more than there are exits 1 with the JAX CLI's error.
MIOTTS_PROFILE_DIR leaves a ``torch.profiler`` trace of the codec decode,
MIOTTS_SPAN_DIR the span recorder's spans (``runtime/tracing.py``). ``-fa``
has no effect:
on CUDA the codec attention always runs the banded-attention kernel.

The device comes from MIOTTS_PLATFORM=cuda|cpu (default cuda); asking for
CUDA without a card is an error.

    MIOTTS_PLATFORM=cuda python -m miotts_tpu_torch.cli -mv codec.gguf \\
        -m llm.gguf -p "Hello" -emb voice.emb.gguf -o out.wav
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from pathlib import Path

from .gguf.writer import load_embedding_gguf
from .runtime.audio_io import encode_pcm16, wav16_header, wav16_streaming_header
from .runtime.codes_io import load_codes, parse_codes_text, save_codes


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llama-tts-mio", add_help=False)
    p.add_argument("-mv", "--model-vocoder", dest="model_vocoder", default="")
    p.add_argument("-m", "--model", dest="model", default="")
    p.add_argument("--llm-api-url", default="")
    p.add_argument("--llm-api-key", default="")
    p.add_argument("--llm-api-model", default="")
    p.add_argument("--llm-api-headers", default="")
    p.add_argument("--llm-api-timeout", type=int, default=120)
    p.add_argument("--llm-api-mode", default="openai-chat", choices=["openai-chat", "generic"])
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("--prompt-file", default="")
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("-n", "--n-predict", dest="n_predict", type=int, default=400)
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-p", dest="top_p", type=float, default=1.0)
    p.add_argument("--top-k", dest="top_k", type=int, default=50)
    p.add_argument("--repeat-penalty", dest="repeat_penalty", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--ctx-size", dest="n_ctx", type=int, default=700)
    p.add_argument("-ngl", "--n-gpu-layers", dest="n_gpu_layers", type=int, default=-1)
    p.add_argument("-fa", "--flash-attn", dest="flash_attn", default="auto")
    p.add_argument("--llm-quant", dest="llm_quant", default="",
                   choices=["", "bf16", "output", "output_int8",
                            "output_int4", "q8_0", "int8",
                            "int8_output_int4"],
                   help="LLM weight numerics (default bf16; int8 = W8A8 "
                        "everywhere; output_int8/output_int4 = W8A8/W4A8 "
                        "logits head only — measured 25%%/36%% off the 0.1B "
                        "decode step; int8_output_int4 stacks both; "
                        "int4 is the aggressive end, like the "
                        "reference's Q4_0 mobile exports)")
    # env fallback MIOTTS_CPU_NATIVE=1/0 (the knob llm_cpu.py documents)
    _cpu_native_env = {"1": "on", "on": "on", "0": "off", "off": "off"}.get(
        os.environ.get("MIOTTS_CPU_NATIVE", "").lower(), "auto")
    p.add_argument("--cpu-native", dest="cpu_native",
                   default=_cpu_native_env,
                   choices=["auto", "on", "off"],
                   help="native int8/int4 CPU LLM decode on CPU-only hosts "
                        "(auto: when the GGUF is Q8_0/Q4_0; env fallback "
                        "MIOTTS_CPU_NATIVE=1)")
    # TPU addition (no reference counterpart — the reference is single-
    # process): shard the codec decode's TIME axis over this many devices
    # (parallel/mesh.make_sp_mesh) so one long utterance uses every chip
    p.add_argument("--sequence-parallel", dest="sequence_parallel",
                   type=int, default=1,
                   help="shard the codec decode's time axis over N devices "
                        "(single-utterance latency on multi-chip hosts; "
                        "codec only — LLM decode is unaffected)")
    p.add_argument("--tts-mio-codes", default="")
    p.add_argument("--tts-mio-codes-in", default="")
    p.add_argument("--tts-mio-codes-out", default="")
    p.add_argument("--tts-mio-codes-only", action="store_true")
    p.add_argument("--tts-reference-audio", default="")
    p.add_argument("--tts-wavlm-model", default="")
    p.add_argument("--tts-max-reference-seconds", type=float, default=20.0)
    p.add_argument("--tts-reference-dir", default="")
    p.add_argument("--tts-remove-reference-key", default="")
    p.add_argument("--tts-mio-embedding-in", default="")
    p.add_argument("-emb", "--tts-mio-default-embedding-in",
                   dest="embedding_default_in", default="")
    p.add_argument("--tts-mio-embedding-out", default="")
    p.add_argument("--tts-mio-embedding-only", action="store_true")
    # TPU addition (no reference counterpart): stream the output WAV while
    # the LLM is still generating — chunked codec prefix re-decodes feed the
    # file incrementally (streaming.stream_text_to_audio); the header's
    # sizes are patched on completion so the artifact is a normal WAV
    p.add_argument("--tts-stream-output", action="store_true")
    p.add_argument("-h", "--help", action="store_true", dest="show_help")
    return p


def _err(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 1


def _make_llm_engine(args, device):
    """The LLM engine, chosen as the JAX CLI chooses it
    (miotts_tpu/cli.py:115-139): on a CPU device, ``--cpu-native on`` runs
    the native int8/int4 engine (``models/llm_cpu.py``) and raises when it
    cannot load, ``auto`` runs it for a GGUF whose matmul weights are Q8_0
    or Q4_0 and otherwise, or when it cannot load (one stderr line says
    why), the torch engine; on CUDA the flag is ignored."""
    from .models.llm import LLMEngine

    mode = args.cpu_native
    if mode != "off" and device.type == "cpu":
        from .models.llm_cpu import NativeCpuLLMEngine, gguf_llm_cpu_native_ok

        if mode == "on" or gguf_llm_cpu_native_ok(args.model):
            try:
                return NativeCpuLLMEngine(args.model)
            except Exception as e:
                if mode == "on":
                    raise
                print(f"note: --cpu-native auto: the native CPU engine did not load ({e}); "
                      "running the torch engine", file=sys.stderr)
    # an empty --llm-quant defers to MIOTTS_LLM_QUANT
    return LLMEngine(args.model, device, quantize=args.llm_quant or None)


def _sampler(args):
    from .models.sampling import SamplerParams

    return SamplerParams(temp=args.temp, top_k=args.top_k, top_p=args.top_p,
                         repeat_penalty=args.repeat_penalty, seed=args.seed)


@contextlib.contextmanager
def _llm_breakdown(label: str = "generate"):
    """Time the block and print the ``llm breakdown:`` line: its wall time
    under ``label`` (``stream`` when the block also runs the codec
    re-decodes), the tokens (the block sets ``stats["n_tokens"]``), tok/s,
    and the decode graph's captures, their host time and its replays (all 0
    on the CPU)."""
    from .models import decode_graph as dg

    before = (dg.captures, dg.capture_ms, dg.replays)
    stats = {"n_tokens": 0}
    t0 = time.perf_counter()
    yield stats
    gen_s = time.perf_counter() - t0
    n = stats["n_tokens"]
    print(f"llm breakdown: {label}={gen_s * 1e3:.1f}ms n_tokens={n} "
          f"tok/s={n / max(gen_s, 1e-9):.1f} graph_captures={dg.captures - before[0]} "
          f"capture={dg.capture_ms - before[1]:.1f}ms replays={dg.replays - before[2]}",
          file=sys.stderr)


def _codec_graph_counts() -> tuple:
    from .models.codec_graph import codec as c

    return c.eager, c.captures, c.capture_ms, c.replays, c.replay_ms


def _codec_graph_text(before: tuple) -> str:
    """The codec graph's routes since ``before`` (``_codec_graph_counts``):
    eager decodes, captures and their host time, replays and theirs."""
    e, c, c_ms, r, r_ms = (a - b for a, b in zip(_codec_graph_counts(), before))
    return (f"codec_graph eager={e} captures={c} capture={c_ms:.1f}ms replays={r} "
            f"replay={r_ms:.1f}ms")


def _stream_output(args, prompt: str, device, pipe, embedding) -> int:
    """--tts-stream-output: write the WAV while the LLM generates, then
    patch its sizes (and rescale it when its peak clipped, the full
    decode's peak rule), as miotts_tpu/cli.py:236-314 does."""
    import numpy as np

    from .streaming import stream_text_to_audio

    try:
        engine = _make_llm_engine(args, device)
    except Exception as e:
        return _err(f"failed to load LLM GGUF: {e}")
    stats = {"n_samples": 0, "ttfa": None}
    stream_codes: list[int] = []
    pieces: list = []
    decodes0, decode_ms0, graph0 = pipe.n_decodes, pipe.decode_ms_total, _codec_graph_counts()
    t0 = time.perf_counter()
    try:
        f = open(args.output, "wb")
    except OSError as e:
        return _err(f"failed to open output wav: {e}")
    try:
        with f, _llm_breakdown("stream") as llm_stats:
            f.write(wav16_streaming_header(pipe.sample_rate))

            def on_audio(pcm) -> None:
                if stats["ttfa"] is None:
                    stats["ttfa"] = time.perf_counter() - t0
                buf = encode_pcm16(pcm)
                f.write(buf)
                f.flush()
                stats["n_samples"] += len(buf) // 2
                pieces.append(np.asarray(pcm, np.float32))

            def on_token(tok, i, is_eog) -> bool:
                llm_stats["n_tokens"] = i + 1
                code = engine.token_to_code_or_none(tok)
                if code is not None:
                    stream_codes.append(code)
                return True

            _, n_codes = stream_text_to_audio(
                pipe, engine, prompt, embedding, n_predict=args.n_predict, n_ctx=args.n_ctx,
                sampler=_sampler(args), on_audio=on_audio, on_token=on_token)
            if not n_codes:
                return _err("no Mio audio codes were found in token sequence")
            # final peak normalization (mio_tts_synthesize's rule): the
            # streamed chunks could not know the global peak, so the payload
            # is rewritten if it clipped
            peak = max((float(np.abs(p).max()) for p in pieces if p.size), default=0.0)
            if peak > 0.98:
                f.seek(44)
                gain = np.float32(0.95 / peak)
                for p in pieces:
                    f.write(encode_pcm16(p * gain))
            # patch the placeholder RIFF/data sizes: a normal WAV
            f.seek(0)
            f.write(wav16_header(stats["n_samples"], pipe.sample_rate))
    except Exception as e:
        return _err(f"streaming synthesis failed: {e}")
    if args.tts_mio_codes_out:
        try:
            save_codes(args.tts_mio_codes_out, stream_codes)
            print(f"saved codes: {args.tts_mio_codes_out}", file=sys.stderr)
        except (OSError, ValueError) as e:
            return _err(f"failed to save codes: {e}")
    ttfa_ms = (stats["ttfa"] or 0.0) * 1e3
    print(f"synth breakdown: streaming ttfa={ttfa_ms:.1f}ms n_codes={n_codes} "
          f"n_samples={stats['n_samples']} redecodes={pipe.n_decodes - decodes0} "
          f"redecode_ms={pipe.decode_ms_total - decode_ms0:.1f} {_codec_graph_text(graph0)}",
          file=sys.stderr)
    print(f"wrote {args.output} ({stats['n_samples']} samples @ {pipe.sample_rate} Hz)",
          file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.show_help:
        parser.print_usage(sys.stderr)
        return 0
    args.llm_api_url = args.llm_api_url or os.environ.get("MIO_TTS_LLM_API_URL", "")
    args.llm_api_key = args.llm_api_key or os.environ.get("MIO_TTS_LLM_API_KEY", "")
    args.llm_api_model = args.llm_api_model or os.environ.get("MIO_TTS_LLM_API_MODEL", "")
    args.llm_api_headers = args.llm_api_headers or os.environ.get("MIO_TTS_LLM_API_HEADERS", "")
    if not args.model_vocoder:
        return _err("-mv/--model-vocoder is required")

    prompt = args.prompt
    if args.prompt_file:
        try:
            prompt = Path(args.prompt_file).read_text(encoding="utf-8").strip()
        except OSError as e:
            return _err(f"failed to read prompt file: {e}")

    from .device import select_device
    from .pipeline import MioTTSPipeline

    try:
        device = select_device()
    except (RuntimeError, ValueError) as e:
        return _err(str(e))
    sp_devices = None
    if args.sequence_parallel and args.sequence_parallel > 1:
        from .parallel.mesh import logical_devices

        devs = logical_devices(device.type)
        if args.sequence_parallel > len(devs):
            return _err(f"--sequence-parallel {args.sequence_parallel} > "
                        f"{len(devs)} visible devices")
        sp_devices = devs[:args.sequence_parallel]
    try:
        pipe = MioTTSPipeline(args.model_vocoder, device,
                              wavlm_path=args.tts_wavlm_model or None, sp_devices=sp_devices)
    except NotImplementedError as e:
        return _err(str(e))
    except Exception as e:
        return _err(f"failed to load MioCodec GGUF: {e}")

    if args.tts_remove_reference_key:
        if not args.tts_reference_dir:
            return _err("--tts-reference-dir is required with --tts-remove-reference-key")
        path = Path(args.tts_reference_dir) / f"{args.tts_remove_reference_key}.emb.gguf"
        if path.exists():
            path.unlink()
            print(f"removed reference: {path}", file=sys.stderr)
            return 0
        return _err(f"reference key not found: {args.tts_remove_reference_key}")

    embedding = None
    if args.tts_reference_audio:
        if not args.tts_wavlm_model:
            return _err("--tts-wavlm-model is required with --tts-reference-audio")
        try:
            embedding, ref = pipe.reference_embedding(args.tts_reference_audio,
                                                      args.tts_max_reference_seconds)
        except Exception as e:
            return _err(f"failed to extract reference embedding: {e}")
        print(f"reference breakdown: decode_ms={ref.decode_ms:.1f} device_ms={ref.device_ms:.1f} "
              f"bucket={ref.bucket} frames={ref.frames} rung={ref.rung}", file=sys.stderr)
        if args.tts_mio_embedding_out:
            pipe.save_embedding(args.tts_mio_embedding_out, embedding)
            print(f"saved embedding: {args.tts_mio_embedding_out}", file=sys.stderr)
        if args.tts_mio_embedding_only:
            return 0
    else:
        for path, what in ((args.tts_mio_embedding_in, "embedding"),
                           (args.embedding_default_in, "default embedding")):
            if path:
                try:
                    embedding = load_embedding_gguf(path)
                except Exception as e:
                    return _err(f"failed to load {what} GGUF: {e}")
                break
    if args.tts_mio_embedding_only:
        return _err("--tts-mio-embedding-only requires --tts-reference-audio")

    # --tts-mio-codes-only skips synthesis, so it takes precedence over
    # streaming output
    if args.tts_stream_output and not args.tts_mio_codes_only:
        if not prompt or args.llm_api_url or not args.model:
            return _err("--tts-stream-output requires -p/--prompt with a local LLM (-m)")
        return _stream_output(args, prompt, device, pipe, embedding)

    if args.tts_mio_codes:
        try:
            codes = parse_codes_text(args.tts_mio_codes)
        except ValueError as e:
            return _err(str(e))
    elif args.tts_mio_codes_in:
        try:
            codes = load_codes(args.tts_mio_codes_in)
        except (OSError, ValueError) as e:
            return _err(f"failed to load codes: {e}")
    elif prompt and args.llm_api_url:
        from .runtime.llm_api import generate_audio_codes_external

        try:
            codes = generate_audio_codes_external(args, prompt)
        except Exception as e:
            return _err(f"external LLM API request failed: {e}")
    elif prompt:
        if not args.model:
            return _err("-m/--model is required with --prompt (or set --llm-api-url)")
        try:
            engine = _make_llm_engine(args, device)
        except Exception as e:
            return _err(f"failed to load LLM GGUF: {e}")
        with _llm_breakdown() as stats:
            tokens = engine.generate_audio_tokens(prompt, n_predict=args.n_predict,
                                                  n_ctx=args.n_ctx, sampler=_sampler(args))
            stats["n_tokens"] = len(tokens)
        codes = engine.tokens_to_codes(tokens)
        if not codes:
            return _err("no Mio audio codes were found in token sequence")
    else:
        return _err("no input: provide -p/--prompt, --tts-mio-codes or --tts-mio-codes-in")

    if args.tts_mio_codes_out:
        try:
            save_codes(args.tts_mio_codes_out, codes)
            print(f"saved codes: {args.tts_mio_codes_out}", file=sys.stderr)
        except (OSError, ValueError) as e:
            return _err(f"failed to save codes: {e}")
    if args.tts_mio_codes_only:
        return 0

    graph0 = _codec_graph_counts()
    try:
        result = pipe.synthesize(codes, embedding)
    except Exception as e:
        return _err(f"MioCodec decode failed: {e}")
    print(f"synth breakdown: decode={result.decode_ms:.1f}ms "
          f"n_codes={result.n_codes} n_frames={result.n_frames} {_codec_graph_text(graph0)}",
          file=sys.stderr)

    try:
        Path(args.output).write_bytes(wav16_header(result.audio.size, result.sample_rate)
                                      + encode_pcm16(result.audio))
    except OSError as e:
        return _err(f"failed to write output wav: {e}")
    print(f"wrote {args.output} ({result.audio.size} samples @ {result.sample_rate} Hz)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
