"""External LLM API client (openai-chat | generic modes): the port's copy
of miotts_tpu/runtime/llm_api.py, stdlib only; tests/test_torch_host.py
holds it to the original.

Mirrors generate_audio_codes_external (tts-mio-cli.cpp:616-723) and the
response parsing ladder: explicit 'codes'/'codes_values'/'audio_codes'
arrays, then text extraction from common completion shapes
('text'/'output_text'/choices[0].text/.message.content) with ``<|s_N|>``
regex scan (:303-311, :561-611). Uses urllib (stdlib, no extra deps).
"""

from __future__ import annotations

import json
import re
import urllib.request

_TOKEN_RE = re.compile(r"<\|s_(-?\d+)\|>")


def extract_codes_from_text(text: str) -> list[int]:
    return [int(m) for m in _TOKEN_RE.findall(text)]


def _append_content(content, parts: list[str]) -> None:
    if isinstance(content, str):
        parts.append(content)
    elif isinstance(content, list):
        for item in content:
            if isinstance(item, str):
                parts.append(item)
            elif isinstance(item, dict) and isinstance(item.get("text"), str):
                parts.append(item["text"])


def extract_text_from_response(rsp: dict) -> str:
    parts: list[str] = []
    if "text" in rsp:
        _append_content(rsp["text"], parts)
    if "output_text" in rsp:
        _append_content(rsp["output_text"], parts)
    choices = rsp.get("choices")
    if isinstance(choices, list) and choices:
        c0 = choices[0]
        if isinstance(c0, dict):
            if "text" in c0:
                _append_content(c0["text"], parts)
            msg = c0.get("message")
            if isinstance(msg, dict) and "content" in msg:
                _append_content(msg["content"], parts)
    return "\n".join(parts)


def parse_codes_from_response(rsp: dict) -> list[int]:
    for key in ("codes", "codes_values", "audio_codes"):
        arr = rsp.get(key)
        if arr is not None:
            if not isinstance(arr, list) or not arr:
                raise ValueError(f"LLM API response contains empty/invalid '{key}'")
            return [int(c) for c in arr]
    text = extract_text_from_response(rsp)
    codes = extract_codes_from_text(text)
    if codes:
        return codes
    raise ValueError("LLM API response did not include codes "
                     "(expected 'codes' / 'codes_values' / text with <|s_...|>)")


def _request(url: str, payload: dict, headers: dict, timeout: int) -> list[int]:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json", **headers}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode("utf-8", errors="replace")
            status = resp.status
    except urllib.error.HTTPError as e:  # urlopen raises on >= 400
        detail = e.read().decode("utf-8", errors="replace")[:240]
        raise ValueError(f"LLM API HTTP {e.code}: {detail}") from e
    except urllib.error.URLError as e:
        raise ValueError(f"LLM API request failed: {e.reason}") from e
    if not (200 <= status < 300):
        raise ValueError(f"LLM API HTTP {status}: {body[:240]}")
    try:
        rsp = json.loads(body or "{}")
    except json.JSONDecodeError:
        codes = extract_codes_from_text(body)
        if codes:
            return codes
        raise ValueError(f"LLM API returned non-JSON response: {body[:240]}")
    return parse_codes_from_response(rsp)


def _build(url, key, model, headers_json, timeout, mode, text,
           n_predict, temp, top_p, top_k, repeat_penalty, seed) -> list[int]:
    if mode == "openai-chat":
        payload = {
            "messages": [{"role": "user", "content": text}],
            "max_tokens": n_predict,
            "temperature": temp,
            "top_p": top_p,
            "stream": False,
        }
        if model:
            payload["model"] = model
    else:
        payload = {
            "text": text, "prompt": text, "n_predict": n_predict,
            "temperature": temp, "top_p": top_p, "top_k": top_k,
            "repeat_penalty": repeat_penalty, "seed": seed,
        }
        if model:
            payload["model"] = model
    headers: dict = {}
    if headers_json:
        headers.update(json.loads(headers_json))
    if key and not any(k.lower() == "authorization" for k in headers):
        headers["Authorization"] = f"Bearer {key}"
    return _request(url, payload, headers, timeout)


def generate_audio_codes_external(args, prompt: str) -> list[int]:
    """CLI adapter (args = argparse namespace)."""
    return _build(args.llm_api_url, args.llm_api_key, args.llm_api_model,
                  args.llm_api_headers, args.llm_api_timeout, args.llm_api_mode,
                  prompt, args.n_predict, args.temp, args.top_p, args.top_k,
                  args.repeat_penalty, args.seed)


def generate_audio_codes_external_cfg(cfg, rp) -> list[int]:
    """Server adapter (cfg = ServerConfig, rp = RequestParams)."""
    return _build(cfg.llm_api_url, cfg.llm_api_key, cfg.llm_api_model,
                  cfg.llm_api_headers, cfg.llm_api_timeout, cfg.llm_api_mode,
                  rp.text, rp.n_predict, rp.temp, rp.top_p, rp.top_k,
                  rp.repeat_penalty, rp.seed)
