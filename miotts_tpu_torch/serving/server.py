"""HTTP server of the port (miotts_tpu/serving/server.py): the same routes,
JSON fields, error strings, status codes and flags, with endpoint-for-
endpoint parity to tts-mio-server (routes: tts-mio-server.cpp:3087-3172,
4007-4020).

Routes:
  GET  /health, /mio/health            — status JSON (:3087-3121)
  GET  /mio/references, /v1/audio/references
  GET  /                               — minimal web UI
  POST /mio/tts, /v1/audio/speech      — JSON result (writes wav to disk)
  POST /mio/tts/stream, /v1/audio/speech/stream
       — SSE (stream_tokens=true: token/generation_complete/audio_meta/
         audio_data events, :3724-3899) or chunked audio/wav with
         X-Slot / X-Sample-Rate / X-Audio-Samples / X-Reference-Key headers
  POST /mio/generate_reference, /v1/audio/generate_reference — voice clone,
       returns the .emb.gguf bytes as attachment (:3177-3398)
  POST /mio/add_reference, /mio/delete_reference (+ /mio/remove_reference,
       /v1/audio/* aliases)

Error shape: {"ok": false, "error": {"message", "code"}} (:2455-2463).

Stdlib-only (ThreadingHTTPServer); the card's work runs in the batchers'
threads (``engine.py``). Each synthesis request gets an id
(``runtime/tracing.py`` ``new_id``) that its flow carries down to the
batchers; while the span recorder runs, the request is a ``request`` span
holding its ``slot_wait`` and each write of its audio (``respond``).
Reference generation needs ``--tts-wavlm-model`` (without it the route
answers as the JAX server does); it takes a JSON body naming a file or a
multipart upload (field ``audio``), at most
``--parallel-reference-generation`` at once. Every flag of the JAX server
is ported.

Run: ``python -m miotts_tpu_torch.serving.server -mv CODEC.gguf -m LLM.gguf
-np 8 ...`` (``MIOTTS_PLATFORM=cpu`` for the CPU).
"""

from __future__ import annotations

import base64
import json
import os
import re
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime import tracing
from ..runtime.audio_io import encode_wav16
from .engine import ServingEngine, check_mesh_flags, now_ms
from .state import RequestError, ServerConfig, is_valid_reference_key, parse_request_json
from .webui import INDEX_HTML as _UI_HTML, UI_CSS as _UI_CSS, UI_JS as _UI_JS


def _error_json(message: str, code: int = 400) -> bytes:
    return json.dumps({"ok": False, "error": {"message": message, "code": code}}).encode()


def _parse_multipart(content_type: str, body: bytes):
    """Minimal multipart/form-data parser -> (fields: dict[str,str],
    files: dict[str, (filename, bytes)])."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("multipart boundary missing")
    boundary = m.group(1).encode()
    fields: dict[str, str] = {}
    files: dict[str, tuple[str, bytes]] = {}
    for part in body.split(b"--" + boundary):
        # remove exactly the framing CRLFs — binary payloads may end in
        # legitimate \r/\n bytes
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, _, data = part.partition(b"\r\n\r\n")
        disp = ""
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition"):
                disp = line.decode("utf-8", errors="replace")
        name_m = re.search(r'name="([^"]*)"', disp)
        if not name_m:
            continue
        name = name_m.group(1)
        file_m = re.search(r'filename="([^"]*)"', disp)
        if file_m:
            files[name] = (file_m.group(1), data)
        else:
            fields[name] = data.decode("utf-8", errors="replace")
    return fields, files


class MioTTSServer:
    def __init__(self, cfg: ServerConfig, device=None):
        self.cfg = cfg
        self.engine = ServingEngine(cfg, device)
        handler = self._make_handler()

        # The stdlib default listen backlog is 5: a 32-wide connect burst
        # (tests/bench_server.py --concurrency 32, or the reference's
        # test_performance.sh top sweep level) overflows the accept queue
        # and the overflow connections are REFUSED before any handler
        # runs. Raise it well above the largest supported burst.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server((cfg.host, cfg.port), handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        import signal

        def _term(signum, frame):
            print("mio: SIGTERM received, shutting down", file=sys.stderr)
            # shutdown() must not run on the serve_forever thread
            threading.Thread(target=self.shutdown, daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _term)
        except ValueError:  # not the main thread (embedded use)
            pass
        print(f"mio: server listening on http://{self.cfg.host}:{self.port}",
              file=sys.stderr)
        self.httpd.serve_forever()
        # drain: handler threads are daemons, so keep the process alive until
        # in-flight requests finish (bounded — a stuck client can't wedge us)
        deadline = time.monotonic() + 30.0
        while ((self.engine.inflight > 0 or self.engine.ref_gen_inflight > 0)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        # inflight drops before the response body finishes streaming; give
        # handler threads a moment to flush their sockets
        time.sleep(1.0)
        print(f"mio: drained (inflight={self.engine.inflight}), exiting",
              file=sys.stderr)

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.shutdown()

    # ------------------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: the streaming paths interleave many small chunked
            # writes (SSE token events) with the latency-critical first
            # audio chunk — Nagle holding the partial trailing segment for a
            # delayed ACK adds tens of ms to the served TTFA
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route to stderr quietly
                pass

            # -- helpers -------------------------------------------------

            def _send_json(self, obj, status=200):
                data = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_error_json(self, message, code=400):
                self._send_json(_error_json(message, code), status=code)

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0") or 0)
                if n > server.cfg.max_body_bytes:
                    raise RequestError(
                        f"request body too large ({n} bytes > "
                        f"{server.cfg.max_body_bytes})", 413)
                return self.rfile.read(n) if n else b""

            def _json_body(self) -> dict:
                raw = self._read_body()
                try:
                    return json.loads(raw.decode("utf-8") or "{}")
                except Exception as e:
                    raise RequestError(f"invalid JSON: {e}")

            # -- GET routes ----------------------------------------------

            def do_GET(self):
                path = self.path.split("?")[0]
                eng = server.engine
                if path in ("/health", "/mio/health"):
                    cfg = server.cfg
                    self._send_json({
                        "status": "ok",
                        "parallel": cfg.n_parallel,
                        "parallel_reference_generation":
                            cfg.n_parallel_reference_generation or cfg.n_parallel,
                        "reference_generation_enabled": bool(cfg.wavlm_model),
                        "reference_generation_initialized": eng.reference_init_done,
                        "inflight": eng.inflight,
                        "reference_generation_inflight": eng.ref_gen_inflight,
                        "reference_cache": len(eng.ref_cache),
                        "external_llm_enabled": cfg.llm_api_enabled,
                        "external_llm_mode": cfg.llm_api_mode,
                        "llm_shared_context": cfg.llm_shared_context,
                        "backend_devices": (eng.mesh.devices.size
                                            if eng.mesh is not None else 1),
                        "tensor_parallel": (eng.mesh.shape.get("tp", 1)
                                            if eng.mesh is not None else 1),
                        "llm_quant": (eng.llm.quantize if eng.llm is not None
                                      else ""),
                        "warmup_complete": eng.warmup_bg_done,
                        # device-stall watchdog (batching.py): work in
                        # flight with no completed chunk for
                        # MIOTTS_DEVICE_STALL_S
                        "device_stalled": (eng.batcher.device_stalled
                                           if eng.batcher is not None
                                           else False),
                        # chunk reads slower than MIOTTS_STALL_EVENT_S
                        "device_stall_events": (eng.batcher.stall_events
                                                if eng.batcher is not None
                                                else 0),
                    })
                elif path == "/metrics":
                    data = eng.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif path in ("/mio/references", "/v1/audio/references"):
                    refs = [{"key": k, "embedding_dim": d}
                            for k, d in eng.ref_cache.items()]
                    self._send_json({"ok": True, "count": len(refs), "references": refs})
                elif path == "/":
                    data = _UI_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Cache-Control", "no-store, no-cache, must-revalidate")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif path in ("/mio-ui.css", "/mio-ui.js", "/favicon.ico"):
                    # UI assets (reference route parity, tts-mio-server.cpp:3160-3172)
                    ctype, data = {
                        "/mio-ui.css": ("text/css; charset=utf-8", _UI_CSS.encode()),
                        "/mio-ui.js": ("application/javascript; charset=utf-8",
                                       _UI_JS.encode()),
                        "/favicon.ico": ("image/x-icon", b""),
                    }[path]
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._send_error_json("not found", 404)

            # -- POST routes -----------------------------------------------

            def do_POST(self):
                path = self.path.split("?")[0]
                try:
                    if path in ("/mio/tts", "/v1/audio/speech"):
                        rid = tracing.new_id()
                        with tracing.request_span(rid, route=path):
                            self._handle_tts(rid)
                    elif path in ("/mio/tts/stream", "/v1/audio/speech/stream"):
                        rid = tracing.new_id()
                        with tracing.request_span(rid, route=path):
                            self._handle_tts_stream(rid)
                    elif path in ("/mio/generate_reference", "/v1/audio/generate_reference"):
                        self._handle_generate_reference()
                    elif path in ("/mio/add_reference", "/v1/audio/add_reference"):
                        self._handle_add_reference()
                    elif path in ("/mio/delete_reference", "/mio/remove_reference",
                                  "/v1/audio/delete_reference", "/v1/audio/remove_reference"):
                        self._handle_delete_reference()
                    else:
                        self._send_error_json("not found", 404)
                except RequestError as e:
                    self._send_error_json(str(e), e.code)
                except BrokenPipeError:
                    pass
                except Exception as e:  # pragma: no cover
                    import traceback

                    traceback.print_exc()
                    self._send_error_json(f"internal error: {e}", 500)

            def do_DELETE(self):
                # README-advertised form the reference never implemented
                # (README.md:188-194 vs tts-mio-server.cpp routes): we
                # register both this and the POST delete_reference surface
                path = self.path.split("?")[0]
                m = re.match(r"^/(?:mio|v1/audio)/references/([^/]+)$", path)
                if not m:
                    self._send_error_json("not found", 404)
                    return
                try:
                    self._delete_reference_by_key(m.group(1))
                except RequestError as e:
                    self._send_error_json(str(e), e.code)

            # -- handlers ------------------------------------------------------

            def _handle_tts(self, rid):
                t_begin = now_ms()
                body = self._json_body()
                rp = parse_request_json(body, server.cfg)
                eng = server.engine
                slot = eng.slots.acquire(timeout=server.cfg.slot_timeout or None)
                eng._count("inflight", 1)
                out: dict = {}
                ok = False
                try:
                    eng.run_tts_request_to_file(rp, out, rid=rid)
                    ok = True
                except RequestError:
                    raise
                finally:
                    eng.slots.release(slot)
                    eng._count("inflight", -1)
                    eng.record_request(out, error=not ok)
                out["slot"] = slot
                total = now_ms() - t_begin
                print(f"generate: path={self.path} slot={slot} ok=true "
                      f"llm_ms={out.get('llm_ms', 0.0):.2f} "
                      f"synth_ms={out.get('synth_ms', 0.0):.2f} total_ms={total:.2f} "
                      f"n_predict={rp.n_predict} n_codes={out.get('codes', 0)} "
                      f"ref={rp.reference_key or '-'} mode={out.get('mode')}",
                      file=sys.stderr)
                self._send_json(out)

            def _handle_tts_stream(self, rid):
                t_begin = now_ms()
                body = self._json_body()
                rp = parse_request_json(body, server.cfg)
                eng = server.engine

                if rp.stream_tokens:
                    if not rp.text:
                        raise RequestError("stream_tokens requires text input")
                    self._sse_stream(rp, t_begin, rid)
                    return
                if rp.stream_audio and not rp.codes_only and not rp.embedding_only:
                    self._binary_audio_stream(rp, t_begin, rid)
                    return

                slot = eng.slots.acquire(timeout=server.cfg.slot_timeout or None)
                eng._count("inflight", 1)
                out: dict = {}
                ok = False
                try:
                    res = eng.run_tts_request(rp, out, rid=rid)
                    ok = True
                finally:
                    eng.slots.release(slot)
                    eng._count("inflight", -1)
                    eng.record_request(out, error=not ok)
                if res is None:
                    self._send_json(out)
                    return
                audio, sr = res
                wav = encode_wav16(audio, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("X-Slot", str(slot))
                self.send_header("X-Sample-Rate", str(sr))
                self.send_header("X-Audio-Samples", str(audio.size))
                if rp.reference_key:
                    self.send_header("X-Reference-Key", rp.reference_key)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                with tracing.trace_phase("respond", profiled=False):
                    for off in range(0, len(wav), 64 * 1024):
                        chunk = wav[off:off + 64 * 1024]
                        self.wfile.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                total = now_ms() - t_begin
                print(f"generate: path={self.path} slot={slot} ok=true "
                      f"llm_ms={out.get('llm_ms', 0.0):.2f} "
                      f"synth_ms={out.get('synth_ms', 0.0):.2f} total_ms={total:.2f} "
                      f"n_predict={rp.n_predict} n_codes={out.get('codes', 0)} "
                      f"ref={rp.reference_key or '-'} mode=binary_stream",
                      file=sys.stderr)

            def _sse_stream(self, rp, t_begin, rid):
                eng = server.engine
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream; charset=utf-8")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Accel-Buffering", "no")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def sse(event: str, data: str) -> bool:
                    try:
                        msg = f"event: {event}\ndata: {data}\n\n".encode()
                        self.wfile.write(f"{len(msg):X}\r\n".encode() + msg + b"\r\n")
                        self.wfile.flush()
                        return True
                    except OSError:
                        return False

                def finish():
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        pass

                t_wait = now_ms()
                slot = eng.slots.acquire(timeout=server.cfg.slot_timeout or None)
                eng._count("inflight", 1)
                out: dict = {}
                ok = False
                try:
                    # same resolution order as run_tts_request
                    # (embedding_in > reference_key > default)
                    try:
                        emb = eng._resolve_embedding(rp)
                    except RequestError as e:
                        sse("error", json.dumps({"error": str(e)}))
                        finish()
                        return

                    if eng.llm is None and not server.cfg.llm_api_enabled:
                        sse("error", json.dumps(
                            {"error": "text generation requested but LLM model is not loaded"}))
                        finish()
                        return

                    t_llm = now_ms()

                    def on_token(tok, index, is_eog):
                        ev = {"id": tok, "i": index}
                        code = eng.llm.token_to_code_or_none(tok)
                        if code is not None:
                            ev["code"] = code
                        if is_eog:
                            ev["eog"] = True
                        return sse("token", json.dumps(ev))

                    try:
                        if rp.stream_audio:
                            # incremental PCM: audio_chunk events interleave
                            # with token events while generation runs
                            chunk_state = {"seq": 0}

                            def on_audio(pcm):
                                from ..runtime.audio_io import encode_pcm16

                                chunk_state["seq"] += 1
                                with tracing.trace_phase("respond", profiled=False):
                                    sse("audio_chunk", json.dumps({
                                        "seq": chunk_state["seq"] - 1,
                                        "n_samples": int(pcm.size),
                                        "sr": eng.pipeline.sample_rate,
                                        "pcm16": base64.b64encode(
                                            encode_pcm16(pcm)).decode()}))

                            def on_codes(codes):
                                sse("generation_complete", json.dumps({
                                    "n_tokens": out.get("n_tokens", len(codes)),
                                    "n_codes": len(codes),
                                    "llm_ms": out.get("llm_ms",
                                                      now_ms() - t_llm)}))

                            audio, sr = eng.run_streaming_request(
                                rp, out, on_token=on_token, on_audio=on_audio,
                                on_codes=on_codes, embedding=emb, rid=rid)
                            total_ms = now_ms() - t_begin
                            sse("audio_meta", json.dumps({
                                "sample_rate": sr,
                                "n_audio": int(audio.size),
                                "n_chunks": chunk_state["seq"],
                                "streamed": True,
                                "synth_ms": out.get("synth_ms", 0.0),
                                "total_ms": total_ms}))
                        else:
                            # single generation path: the continuous batcher
                            # (concurrent SSE streams share chunk steps, vs
                            # the reference's llm_gen_mutex serialization,
                            # tts-mio-server.cpp:3786-3807)
                            codes = eng._generate_codes(rp, out, on_token=on_token,
                                                        rid=rid)
                            sse("generation_complete", json.dumps({
                                "n_tokens": out.get("n_tokens", len(codes)),
                                "n_codes": len(codes),
                                "llm_ms": out["llm_ms"]}))

                            t_synth = now_ms()
                            # pcm16: quantize on device and fetch half the
                            # bytes (same executable + micro-batch group as
                            # the binary path; encode_wav16 passes int16
                            # through untouched)
                            result = eng.codec_batcher.synthesize(
                                codes, emb, pcm16=True, rid=rid)
                            synth_ms = now_ms() - t_synth
                            out["synth_ms"] = synth_ms
                            out["codes"] = len(codes)
                            out["duration_sec"] = (result.audio.size
                                                   / result.sample_rate)
                            wav = encode_wav16(result.audio, result.sample_rate)
                            total_ms = now_ms() - t_begin
                            sse("audio_meta", json.dumps({
                                "sample_rate": result.sample_rate,
                                "n_audio": int(result.audio.size),
                                "synth_ms": synth_ms, "total_ms": total_ms,
                                "wav_size": len(wav)}))
                            with tracing.trace_phase("respond", profiled=False):
                                sse("audio_data", base64.b64encode(wav).decode())
                    except Exception as e:
                        # headers are gone — any failure (including device
                        # errors re-raised through GenerationHandle/codec
                        # futures) must end as an SSE error event + clean
                        # chunked terminator, never a second status line
                        sse("error", json.dumps({"error": str(e)}))
                        finish()
                        if not isinstance(e, (RequestError, ValueError)):
                            import traceback

                            traceback.print_exc()
                        return
                    ok = True
                    print(f"generate: path={self.path} slot={slot} ok=true "
                          f"wait_ms={t_llm - t_wait:.2f} "
                          f"llm_ms={out.get('llm_ms', 0.0):.2f} "
                          f"synth_ms={out.get('synth_ms', 0.0):.2f} "
                          f"total_ms={now_ms() - t_begin:.2f} "
                          f"n_predict={rp.n_predict} n_codes={out.get('codes', 0)} "
                          f"ref={rp.reference_key} mode="
                          f"{'sse_stream_audio' if rp.stream_audio else 'sse_stream'}",
                          file=sys.stderr)
                    finish()
                finally:
                    eng.slots.release(slot)
                    eng._count("inflight", -1)
                    eng.record_request(out, error=not ok)

            def _binary_audio_stream(self, rp, t_begin, rid):
                """stream_audio without stream_tokens: chunked streaming WAV —
                PCM bytes leave the socket while generation is still running
                (the reference sends audio only after full synthesis,
                tts-mio-server.cpp:3876-3886)."""
                eng = server.engine
                if not (rp.text or rp.inline_codes or rp.codes_in):
                    raise RequestError("either text/prompt, codes, or codes_in is required")
                # resolve before headers so failures are still normal JSON
                # errors; pass the result down to avoid a second disk load
                emb = eng._resolve_embedding(rp)
                if rp.text and eng.llm is None and not server.cfg.llm_api_enabled:
                    raise RequestError("text generation requested but LLM model is not loaded")

                slot = eng.slots.acquire(timeout=server.cfg.slot_timeout or None)
                eng._count("inflight", 1)
                out: dict = {}
                ok = False
                try:
                    from ..runtime.audio_io import encode_pcm16, wav16_streaming_header

                    sr = eng.pipeline.sample_rate
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("X-Slot", str(slot))
                    self.send_header("X-Sample-Rate", str(sr))
                    self.send_header("X-Audio-Streaming", "1")
                    if rp.reference_key:
                        self.send_header("X-Reference-Key", rp.reference_key)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def write_chunk(data: bytes):
                        self.wfile.write(f"{len(data):X}\r\n".encode()
                                         + data + b"\r\n")
                        self.wfile.flush()

                    write_chunk(wav16_streaming_header(sr))

                    def on_audio(pcm):
                        with tracing.trace_phase("respond", profiled=False):
                            write_chunk(encode_pcm16(pcm))

                    try:
                        audio, _sr = eng.run_streaming_request(
                            rp, out, on_audio=on_audio, embedding=emb, rid=rid)
                        ok = True
                    except Exception as e:
                        # headers are gone (any failure here, including
                        # device errors surfaced through the batcher/codec):
                        # terminate the chunked body so the client sees a
                        # truncated-but-well-formed stream, never a second
                        # status line
                        print(f"generate: path={self.path} slot={slot} ok=false "
                              f"error={e}", file=sys.stderr)
                        if not isinstance(e, (RequestError, ValueError, OSError)):
                            import traceback

                            traceback.print_exc()
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        pass
                finally:
                    eng.slots.release(slot)
                    eng._count("inflight", -1)
                    eng.record_request(out, error=not ok)
                if ok:
                    print(f"generate: path={self.path} slot={slot} ok=true "
                          f"llm_ms={out.get('llm_ms', 0.0):.2f} "
                          f"synth_ms={out.get('synth_ms', 0.0):.2f} "
                          f"total_ms={now_ms() - t_begin:.2f} "
                          f"n_predict={rp.n_predict} n_codes={out.get('codes', 0)} "
                          f"ref={rp.reference_key or '-'} mode=binary_stream_audio",
                          file=sys.stderr)

            def _handle_generate_reference(self):
                eng = server.engine
                cfg = server.cfg
                if not cfg.wavlm_model:
                    raise RequestError(
                        "server requires --tts-wavlm-model for reference generation")
                ctype = self.headers.get("Content-Type", "")
                reference_key = ""
                reference_audio = ""
                max_ref_sec = cfg.max_reference_seconds
                upload_path = ""
                if ctype.startswith("multipart/form-data"):
                    fields, files = _parse_multipart(ctype, self._read_body())
                    reference_key = fields.get("reference_key", "")
                    reference_audio = fields.get("reference_audio", "")
                    if fields.get("max_reference_seconds"):
                        try:
                            max_ref_sec = float(fields["max_reference_seconds"])
                        except ValueError:
                            raise RequestError("invalid max_reference_seconds")
                    if "audio" in files:
                        filename, data = files["audio"]
                        suffix = os.path.splitext(filename)[1] or ".wav"
                        if len(suffix) > 8:
                            suffix = ".wav"
                        upload_path = os.path.join(cfg.output_dir,
                                                   f"mio-upload-{uuid.uuid4().hex}{suffix}")
                        os.makedirs(cfg.output_dir, exist_ok=True)
                        with open(upload_path, "wb") as f:
                            f.write(data)
                        reference_audio = upload_path
                else:
                    body = self._json_body()
                    reference_key = body.get("reference_key", "") or ""
                    reference_audio = (body.get("reference_audio", "")
                                       or body.get("tts_reference_audio", "") or "")
                    if body.get("max_reference_seconds") is not None:
                        max_ref_sec = float(body["max_reference_seconds"])

                try:
                    if not is_valid_reference_key(reference_key):
                        raise RequestError("reference_key is invalid")
                    if not reference_audio:
                        raise RequestError(
                            "reference_audio or multipart file 'audio' is required")
                    slot = eng.ref_slots.acquire(timeout=server.cfg.slot_timeout or None)
                    eng._count("ref_gen_inflight", 1)
                    try:
                        emb = eng.generate_reference(reference_audio, reference_key, max_ref_sec)
                    except RequestError:
                        raise
                    except Exception as e:
                        raise RequestError(f"mio_tts_reference_to_embedding failed: {e}")
                    finally:
                        eng.ref_slots.release(slot)
                        eng._count("ref_gen_inflight", -1)
                finally:
                    if upload_path:
                        try:
                            os.remove(upload_path)
                        except OSError:
                            pass

                from ..gguf.writer import save_embedding_gguf

                buf_path = os.path.join(cfg.output_dir, f"mio-emb-{uuid.uuid4().hex}.emb.gguf")
                os.makedirs(cfg.output_dir, exist_ok=True)
                save_embedding_gguf(buf_path, emb)
                with open(buf_path, "rb") as f:
                    payload = f.read()
                os.remove(buf_path)

                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Disposition",
                                 f'attachment; filename="{reference_key}.emb.gguf"')
                self.send_header("X-Reference-Key", reference_key)
                self.send_header("X-Embedding-Dim", str(emb.size))
                if cfg.reference_added_output_dir:
                    self.send_header("X-Reference-Saved-Path", os.path.join(
                        cfg.reference_added_output_dir, f"{reference_key}.emb.gguf"))
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _handle_add_reference(self):
                eng = server.engine
                cfg = server.cfg
                ctype = self.headers.get("Content-Type", "")
                reference_key = ""
                embedding_path = ""
                upload_path = ""
                if ctype.startswith("multipart/form-data"):
                    fields, files = _parse_multipart(ctype, self._read_body())
                    reference_key = fields.get("reference_key") or fields.get("key", "")
                    embedding_path = fields.get("path") or fields.get("file", "")
                    file_entry = files.get("file") or files.get("embedding")
                    if file_entry is not None:
                        filename, data = file_entry
                        suffix = os.path.splitext(filename)[1] or ".gguf"
                        if len(suffix) > 16:
                            suffix = ".gguf"
                        upload_path = os.path.join(
                            cfg.output_dir, f"mio-upload-{uuid.uuid4().hex}{suffix}")
                        os.makedirs(cfg.output_dir, exist_ok=True)
                        with open(upload_path, "wb") as f:
                            f.write(data)
                        embedding_path = upload_path
                else:
                    body = self._json_body()
                    reference_key = body.get("reference_key") or body.get("key", "") or ""
                    embedding_path = (body.get("path") or body.get("file")
                                      or body.get("embedding_in", "") or "")

                try:
                    if not is_valid_reference_key(reference_key):
                        raise RequestError("reference_key (or key) is invalid")
                    if not embedding_path:
                        raise RequestError("path (or uploaded file) is required")
                    try:
                        emb = eng.pipeline.load_embedding(embedding_path)
                    except Exception as e:
                        raise RequestError(f"failed to load embedding GGUF: {e}")
                    eng.ref_cache.put(reference_key, emb)
                    saved_path = ""
                    if cfg.reference_added_output_dir:
                        os.makedirs(cfg.reference_added_output_dir, exist_ok=True)
                        saved_path = os.path.join(cfg.reference_added_output_dir,
                                                  f"{reference_key}.emb.gguf")
                        eng.pipeline.save_embedding(saved_path, emb)
                finally:
                    if upload_path:
                        try:
                            os.remove(upload_path)
                        except OSError:
                            pass

                self._send_json({
                    "ok": True,
                    "mode": "add-reference",
                    "reference_key": reference_key,
                    "embedding_dim": int(emb.size),
                    "reference_cache": len(eng.ref_cache),
                    "saved_path": saved_path,
                })

            def _handle_delete_reference(self):
                ctype = self.headers.get("Content-Type", "")
                reference_key = ""
                if ctype.startswith("multipart/form-data"):
                    fields, _ = _parse_multipart(ctype, self._read_body())
                    reference_key = fields.get("reference_key") or fields.get("key", "")
                else:
                    body = self._json_body()
                    reference_key = body.get("reference_key") or body.get("key", "") or ""
                self._delete_reference_by_key(reference_key)

            def _delete_reference_by_key(self, reference_key):
                eng = server.engine
                cfg = server.cfg
                if not is_valid_reference_key(reference_key):
                    raise RequestError("reference_key (or key) is invalid")
                removed = eng.ref_cache.remove(reference_key)
                if not removed:
                    raise RequestError(f"reference_key not found: {reference_key}", 404)
                removed_saved_file = False
                saved_path = ""
                warning = ""
                if cfg.reference_added_output_dir:
                    saved_path = os.path.join(cfg.reference_added_output_dir,
                                              f"{reference_key}.emb.gguf")
                    try:
                        os.remove(saved_path)
                        removed_saved_file = True
                    except FileNotFoundError:
                        pass
                    except OSError as e:
                        warning = f"failed to remove saved embedding: {e}"
                out = {
                    "ok": True,
                    "mode": "delete-reference",
                    "reference_key": reference_key,
                    "removed": True,
                    "removed_saved_file": removed_saved_file,
                    "saved_path": saved_path,
                    "reference_cache": len(eng.ref_cache),
                }
                if warning:
                    out["warning"] = warning
                self._send_json(out)

        return Handler


def build_arg_parser():
    """Server CLI flags (tts-mio-server.cpp print_usage)."""
    import argparse

    p = argparse.ArgumentParser(prog="llama-tts-mio-server", add_help=True)
    p.add_argument("-mv", "--model-vocoder", dest="model_vocoder", required=True)
    p.add_argument("-m", "--model", dest="model", default="")
    p.add_argument("--llm-api-url", default="")
    p.add_argument("--llm-api-key", default="")
    p.add_argument("--llm-api-model", default="")
    p.add_argument("--llm-api-headers", default="")
    p.add_argument("--llm-api-timeout", type=int, default=120)
    p.add_argument("--llm-api-mode", default="openai-chat")
    p.add_argument("--tts-wavlm-model", dest="wavlm_model", default="")
    p.add_argument("-emb", "--tts-mio-default-embedding-in",
                   dest="embedding_default_in", default="")
    p.add_argument("--reference-file-json", "--reference-file",
                   dest="reference_file_json", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=18089)
    p.add_argument("--output-dir", default="/tmp")
    p.add_argument("--reference-added-output-dir", default="")
    p.add_argument("-np", "--parallel", dest="n_parallel", type=int, default=1)
    p.add_argument("--llm-shared-context", default="on")
    p.add_argument("--parallel-reference-generation", type=int, default=0)
    p.add_argument("--mio-backend-devices", default="")
    p.add_argument("--codec-devices", default="",
                   help="run codec synthesis on its own device set, "
                        "disjoint from the LLM mesh (overlap synthesis "
                        "wins only with dedicated codec chips)")
    p.add_argument("--llm-quant", dest="llm_quant", default="",
                   choices=["", "bf16", "output", "output_int8",
                            "output_int4", "q8_0", "int8",
                            "int8_output_int4"],
                   help="LLM weight numerics (default bf16; int8 = W8A8 — "
                        "2x decode at 1B+ scale; output_int8/output_int4 = "
                        "W8A8/W4A8 logits head only, 25%%/36%% off the 0.1B "
                        "step; int8_output_int4 stacks both; see DESIGN.md)")
    p.add_argument("-tp", "--tensor-parallel", dest="tensor_parallel",
                   type=int, default=1)
    # interleave codec prefix re-decodes with LLM generation for
    # non-streaming text requests (see RequestParams.overlap_synthesis)
    p.add_argument("--overlap-synthesis", default="off")
    p.add_argument("-ngl", "--n-gpu-layers", type=int, default=-1)
    p.add_argument("-fa", "--flash-attn", default="auto")
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--ctx-size", dest="n_ctx", type=int, default=700)
    p.add_argument("-n", "--n-predict", dest="n_predict", type=int, default=700)
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-p", dest="top_p", type=float, default=1.0)
    p.add_argument("--top-k", dest="top_k", type=int, default=50)
    p.add_argument("--repeat-penalty", dest="repeat_penalty", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tts-max-reference-seconds", dest="max_reference_seconds",
                   type=float, default=20.0)
    # capture the serving graphs at startup instead of at first use
    p.add_argument("--warmup", default="off", choices=["on", "off"])
    # shed load with 503 after this many seconds waiting for a free slot
    # (0 = queue forever, the reference behavior)
    p.add_argument("--slot-timeout", dest="slot_timeout", type=float, default=0.0)
    return p


def config_from_args(args) -> ServerConfig:
    return ServerConfig(
        model_vocoder=args.model_vocoder, model=args.model,
        wavlm_model=args.wavlm_model,
        embedding_default_in=args.embedding_default_in,
        reference_file_json=args.reference_file_json,
        host=args.host, port=args.port, output_dir=args.output_dir,
        reference_added_output_dir=args.reference_added_output_dir,
        n_parallel=args.n_parallel,
        llm_shared_context=args.llm_shared_context != "off",
        n_parallel_reference_generation=args.parallel_reference_generation,
        n_threads=args.threads, n_ctx=args.n_ctx, n_predict=args.n_predict,
        top_k=args.top_k, top_p=args.top_p, temp=args.temp,
        repeat_penalty=args.repeat_penalty, seed=args.seed,
        max_reference_seconds=args.max_reference_seconds,
        llm_api_url=args.llm_api_url, llm_api_key=args.llm_api_key,
        llm_api_model=args.llm_api_model, llm_api_headers=args.llm_api_headers,
        llm_api_timeout=args.llm_api_timeout, llm_api_mode=args.llm_api_mode,
        mio_backend_devices=args.mio_backend_devices,
        codec_devices=args.codec_devices,
        tensor_parallel=args.tensor_parallel,
        llm_quant=args.llm_quant,  # "" defers to MIOTTS_LLM_QUANT; "bf16" forces dense
        warmup=args.warmup == "on",
        slot_timeout=args.slot_timeout,
        overlap_synthesis=args.overlap_synthesis == "on",
    )


def main(argv=None) -> int:
    from ..device import select_device

    # a restart's speed is a deployment's concern: servers keep the packed
    # weights' deploy artifact by default (runtime/device_dequant.py; one
    # file read and one upload on a warm start); MIOTTS_PACKED_CACHE=0 opts
    # out, =DIR picks the directory
    os.environ.setdefault("MIOTTS_PACKED_CACHE", "1")
    cfg = config_from_args(build_arg_parser().parse_args(argv))
    try:
        check_mesh_flags(cfg)
        device = select_device()
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    MioTTSServer(cfg, device).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
