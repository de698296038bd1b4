"""llama-tts-mio CLI on PyTorch (miotts_tpu/cli.py:141-381).

The flag surface is the reference's: the parser is
``miotts_tpu.cli.build_parser`` itself. This port runs the paths that take
codes or text to a WAV:

- input from -p/--prompt, --prompt-file (local LLM, -m), --tts-mio-codes
  or --tts-mio-codes-in;
- a speaker embedding from -emb or --tts-mio-embedding-in;
- --tts-mio-codes-out and --tts-mio-codes-only.

Flags whose path is not ported exit 1 with
``error: ... not yet ported to miotts_tpu_torch``. ``-fa`` has no effect:
on CUDA the codec attention always runs the banded-attention kernel.

The device comes from MIOTTS_PLATFORM=cuda|cpu (default cuda); asking for
CUDA without a card is an error.

    MIOTTS_PLATFORM=cuda python -m miotts_tpu_torch.cli -mv codec.gguf \\
        -m llm.gguf -p "Hello" -emb voice.emb.gguf -o out.wav
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

from miotts_tpu.cli import build_parser
from miotts_tpu.gguf.writer import load_embedding_gguf
from miotts_tpu.runtime.audio_io import encode_pcm16, wav16_header
from miotts_tpu.runtime.codes_io import load_codes, parse_codes_text, save_codes


def _err(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 1


def _unported_flag(args) -> str | None:
    """The first flag given whose path this port does not run yet."""
    checks = (
        (args.tts_reference_audio, "--tts-reference-audio (voice cloning)"),
        (args.tts_wavlm_model, "--tts-wavlm-model (voice cloning)"),
        (args.tts_mio_embedding_only, "--tts-mio-embedding-only (voice cloning)"),
        (args.tts_remove_reference_key, "--tts-remove-reference-key"),
        (args.tts_stream_output, "--tts-stream-output (streaming)"),
        (args.llm_api_url, "--llm-api-url (external LLM API)"),
        (args.sequence_parallel > 1, "--sequence-parallel"),
        (args.llm_quant not in ("", "bf16"), f"--llm-quant {args.llm_quant}"),
        (args.cpu_native == "on", "--cpu-native on"),
    )
    return next((name for given, name in checks if given), None)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.show_help:
        parser.print_usage(sys.stderr)
        return 0
    args.llm_api_url = args.llm_api_url or os.environ.get("MIO_TTS_LLM_API_URL", "")
    if not args.model_vocoder:
        return _err("-mv/--model-vocoder is required")
    flag = _unported_flag(args)
    if flag:
        return _err(f"{flag} not yet ported to miotts_tpu_torch")

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
    try:
        pipe = MioTTSPipeline(args.model_vocoder, device)
    except NotImplementedError as e:
        return _err(str(e))
    except Exception as e:
        return _err(f"failed to load MioCodec GGUF: {e}")

    embedding = None
    for path, what in ((args.tts_mio_embedding_in, "embedding"),
                       (args.embedding_default_in, "default embedding")):
        if path:
            try:
                embedding = load_embedding_gguf(path)
            except Exception as e:
                return _err(f"failed to load {what} GGUF: {e}")
            break

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
    elif prompt:
        if not args.model:
            return _err("-m/--model is required with --prompt (or set --llm-api-url)")
        from .models.llm import LLMEngine
        from .models.sampling import SamplerParams

        try:
            engine = LLMEngine(args.model, device)
        except Exception as e:
            return _err(f"failed to load LLM GGUF: {e}")
        sampler = SamplerParams(temp=args.temp, top_k=args.top_k, top_p=args.top_p,
                                repeat_penalty=args.repeat_penalty, seed=args.seed)
        t0 = time.perf_counter()
        tokens = engine.generate_audio_tokens(prompt, n_predict=args.n_predict,
                                              n_ctx=args.n_ctx, sampler=sampler)
        gen_s = time.perf_counter() - t0
        print(f"llm breakdown: generate={gen_s * 1e3:.1f}ms n_tokens={len(tokens)} "
              f"tok/s={len(tokens) / max(gen_s, 1e-9):.1f}", file=sys.stderr)
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

    try:
        result = pipe.synthesize(codes, embedding)
    except Exception as e:
        return _err(f"MioCodec decode failed: {e}")
    print(f"synth breakdown: decode={result.decode_ms:.1f}ms "
          f"n_codes={result.n_codes} n_frames={result.n_frames}", file=sys.stderr)

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
