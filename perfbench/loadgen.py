"""The load generator: sends a run's schedule to the server over HTTP and
records what came back. It runs as a child process with its own
interpreter, so its work never holds the server's interpreter lock.

    python -m perfbench.loadgen SPEC.json

SPEC holds the server's address, the monotonic time the window opens
(``CLOCK_MONOTONIC`` is one clock for every process of the machine), the
requests (offset from the opening, route, JSON body, whether the check
keeps its audio) and the directory to write to. Each request goes out on
its own thread at its due time, whatever earlier ones are doing (an open
loop), and is timed from when it was due. ``/mio/tts`` answers with a WAV
written under the server's ``--output-dir``: it is read, counted and
deleted, unless the check keeps it. A stream's SSE events give its tokens
and its audio chunks. Writes ``records.jsonl`` (one line a request) and
``loadgen.json`` (how late the generator ran) into the directory.
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import threading
import time
from pathlib import Path


def _post(spec: dict, path: str, body: dict) -> http.client.HTTPResponse:
    conn = http.client.HTTPConnection(spec["host"], spec["port"], timeout=spec["timeout_s"])
    conn.request("POST", path, json.dumps(body).encode(), {"Content-Type": "application/json"})
    return conn.getresponse()


def wav_samples(data: bytes) -> int:
    """The sample count of a mono 16-bit PCM WAV, checking its header."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:16] != b"WAVEfmt " or data[36:40] != b"data":
        raise ValueError("not a 16-bit PCM WAV")
    n = int.from_bytes(data[40:44], "little")
    if n != len(data) - 44 or n % 2:
        raise ValueError("WAV sizes do not match its body")
    return n // 2


def run_tts(spec: dict, req: dict, rec: dict, keep: Path) -> None:
    resp = _post(spec, "/mio/tts", req["body"])
    out = json.loads(resp.read())
    if resp.status != 200 or not out.get("ok", False):
        raise RuntimeError(f"HTTP {resp.status}: {str(out)[:200]}")
    path = Path(out["output_file"])
    data = path.read_bytes()
    n = wav_samples(data)
    rec["done"] = time.monotonic()
    rec.update(first_audio=rec["done"], n_samples=n, audio_events=[[rec["done"], n]],
               llm_ms=out.get("llm_ms"), synth_ms=out.get("synth_ms"), n_codes=out.get("codes"))
    if req["keep"]:
        path.replace(keep / f"{req['i']}.wav")
    else:
        path.unlink()
        Path(req["body"]["codes_out"]).unlink(missing_ok=True)


def run_stream(spec: dict, req: dict, rec: dict, keep: Path) -> None:
    resp = _post(spec, "/mio/tts/stream", req["body"])
    if resp.status != 200:
        raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:200]!r}")
    tokens, events, pcm = [], [], []
    event, n, ended = None, 0, False
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            event = line[7:]
            continue
        if not line.startswith("data: "):
            continue
        if event == "token":
            tokens.append(json.loads(line[6:])["id"])
        elif event == "audio_chunk":
            now = time.monotonic()
            d = json.loads(line[6:])
            n += d["n_samples"]
            events.append([now, d["n_samples"]])
            rec.setdefault("first_audio", now)
            if req["keep"]:
                pcm.append(base64.b64decode(d["pcm16"]))
        elif event == "audio_meta":
            ended = True
        elif event == "error":
            raise RuntimeError(f"SSE error: {line[6:200]}")
    if not ended or not n:
        raise RuntimeError(f"stream ended without its audio ({n} samples)")
    rec.update(done=events[-1][0], n_samples=n, audio_events=events, tokens=tokens)
    if req["keep"]:
        (keep / f"{req['i']}.pcm").write_bytes(b"".join(pcm))


def one(spec: dict, req: dict, due: float, keep: Path, records: list, lock) -> None:
    rec = {"i": req["i"], "stream": req["stream"], "due": due, "sent": time.monotonic()}
    try:
        (run_stream if req["stream"] else run_tts)(spec, req, rec, keep)
        rec["ok"] = True
    except Exception as e:  # a failed request is recorded, never fatal
        rec.update(ok=False, error=f"{type(e).__name__}: {e}"[:300], done=time.monotonic())
    with lock:
        records.append(rec)


def main(argv: list[str]) -> int:
    spec = json.loads(Path(argv[0]).read_text())
    out = Path(spec["out_dir"])
    keep = out / "keep"
    keep.mkdir(parents=True, exist_ok=True)
    records: list[dict] = []
    lock = threading.Lock()
    threads = []
    for req in sorted(spec["requests"], key=lambda r: r["due_s"]):
        due = spec["start_at"] + req["due_s"]
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=one, args=(spec, req, due, keep, records, lock), daemon=True)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + spec["timeout_s"] + 5
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    with lock:
        done = list(records)
    late = sorted((r["sent"] - r["due"]) * 1e3 for r in done)
    with open(out / "records.jsonl", "w") as f:
        for r in sorted(done, key=lambda r: r["i"]):
            f.write(json.dumps(r) + "\n")
    (out / "loadgen.json").write_text(json.dumps({
        "requests": len(spec["requests"]), "recorded": len(done),
        "late_ms_mean": sum(late) / len(late) if late else None,
        "late_ms_max": late[-1] if late else None,
        "late_ms_p99": late[min(len(late) - 1, int(0.99 * len(late)))] if late else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
