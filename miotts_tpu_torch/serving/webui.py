"""Embedded web UI for the MioTTS-TPU server (the port's copy of
miotts_tpu/serving/webui.py, held to it by tests/test_torch_host.py).

Capability parity with BOTH reference front-ends:
- the server's embedded page (tts-mio-server.cpp:36-126 + /mio-ui.{css,js}):
  reference cache management, reference generation from uploaded audio,
  GGUF upload, synthesis with sampler knobs, chunked-WAV download mode and
  SSE token streaming with a live token log;
- the WASM demo app (examples/wasm/index.html, miottscpp.js): microphone
  recording to create a reference, settings persisted in localStorage,
  stop button.

TPU-native redesign note: the WASM app runs the models in-browser; here the
browser is a thin client and inference runs on the TPU server — same user
capability (record voice -> clone -> speak), much faster synthesis. The
recorder encodes PCM16 WAV in JS (AudioContext capture) instead of
MediaRecorder's webm/opus so the upload is decodable by the server's native
WAV parser with no ffmpeg dependency.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>miotts-tpu server</title>
<link rel="stylesheet" href="/mio-ui.css">
</head>
<body>
<main class="page">
  <header>
    <h1>miotts-tpu</h1>
    <span id="health" class="pill">checking&hellip;</span>
  </header>

  <section class="card" id="card-synth">
    <h2>Synthesis</h2>
    <label for="text">Text</label>
    <textarea id="text" rows="3">こんにちわ、今日はいい天気ですね。</textarea>
    <div class="grid2">
      <div>
        <label for="ref-select">Reference</label>
        <select id="ref-select"></select>
      </div>
      <div class="refbtns">
        <button id="btn-refresh" type="button" class="ghost">Refresh</button>
        <button id="btn-del-ref" type="button" class="warn">Delete</button>
        <span id="ref-count" class="muted"></span>
      </div>
    </div>
    <div class="params">
      <label>temperature <input id="p-temp" type="number" step="0.01" value="0.8"></label>
      <label>top_k <input id="p-top-k" type="number" step="1" value="50"></label>
      <label>top_p <input id="p-top-p" type="number" step="0.01" value="1.0"></label>
      <label>repeat_penalty <input id="p-repeat" type="number" step="0.01" value="1.0"></label>
      <label>n_predict <input id="p-n-predict" type="number" step="1" value="700"></label>
      <label>seed <input id="p-seed" type="number" step="1" value="0"></label>
    </div>
    <div class="row">
      <label class="check"><input id="opt-stream" type="checkbox" checked> binary stream</label>
      <label class="check"><input id="opt-sse" type="checkbox"> SSE token stream</label>
      <label class="check"><input id="opt-live" type="checkbox"> live audio</label>
    </div>
    <pre id="token-log" class="hidden"></pre>
    <div class="row">
      <button id="btn-generate" type="button" class="primary">Generate Speech</button>
      <button id="btn-stop" type="button" class="ghost">Stop</button>
      <span id="metrics" class="muted"></span>
    </div>
    <div id="synth-status" class="status"></div>
    <audio id="player" controls></audio>
    <a id="wav-download" class="hidden" download="miotts.wav">Download WAV</a>
  </section>

  <section class="card" id="card-genref">
    <h2>Create Reference From Audio</h2>
    <div class="grid2">
      <div>
        <label for="gen-key">key</label>
        <input id="gen-key" type="text" placeholder="my_voice">
      </div>
      <div>
        <label for="gen-file">audio file (wav)</label>
        <input id="gen-file" type="file" accept="audio/*">
      </div>
    </div>
    <div class="row">
      <button id="btn-rec-start" type="button" class="go">Start Recording</button>
      <button id="btn-rec-stop" type="button" class="warn" disabled>Stop Recording</button>
      <span id="rec-meter" class="muted"></span>
    </div>
    <div class="row">
      <button id="btn-gen-ref" type="button" class="primary">Generate Reference</button>
      <a id="emb-download" class="hidden" download>Download .emb.gguf</a>
    </div>
    <div id="genref-status" class="status"></div>
  </section>

  <section class="card" id="card-addref">
    <h2>Add Reference (.emb.gguf)</h2>
    <div class="grid2">
      <div>
        <label for="add-key">key</label>
        <input id="add-key" type="text" placeholder="my_voice">
      </div>
      <div>
        <label for="add-file">gguf file</label>
        <input id="add-file" type="file" accept=".gguf,application/octet-stream">
      </div>
    </div>
    <div class="row">
      <button id="btn-add-ref" type="button" class="primary">Add Reference</button>
    </div>
    <div id="addref-status" class="status"></div>
  </section>
</main>
<script src="/mio-ui.js"></script>
</body>
</html>
"""

UI_CSS = """:root { color-scheme: dark; }
* { box-sizing: border-box; }
body {
  margin: 0; padding: 24px; background: #0e1117; color: #d7dde8;
  font: 15px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
}
.page { max-width: 880px; margin: 0 auto; display: grid; gap: 16px; }
header { display: flex; align-items: baseline; gap: 12px; }
h1 { margin: 0; font-size: 26px; letter-spacing: .5px; }
h2 { margin: 0 0 12px; font-size: 17px; color: #9fb4d8; }
.pill {
  font-size: 12px; padding: 3px 10px; border-radius: 999px;
  background: #1b2433; border: 1px solid #2c3a52;
}
.pill.ok { color: #57d98e; } .pill.bad { color: #ff7a7a; }
.card {
  background: #151a23; border: 1px solid #232c3d; border-radius: 10px;
  padding: 16px 18px;
}
label { display: block; font-size: 12.5px; color: #8d9cb5; margin: 8px 0 4px; }
textarea, input[type=text], input[type=number], select {
  width: 100%; padding: 8px 10px; border-radius: 7px;
  border: 1px solid #2c3a52; background: #0e1420; color: #e4eaf4;
}
textarea { resize: vertical; }
.grid2 { display: grid; grid-template-columns: 1fr 1fr; gap: 12px; align-items: end; }
.params { display: grid; grid-template-columns: repeat(3, 1fr); gap: 8px 12px; margin-top: 8px; }
.params label { margin: 0; }
.params input { margin-top: 3px; }
.row { display: flex; gap: 10px; align-items: center; margin-top: 12px; flex-wrap: wrap; }
.refbtns { display: flex; gap: 8px; align-items: center; }
button {
  border: 1px solid #2c3a52; border-radius: 7px; padding: 8px 14px;
  background: #1b2433; color: #d7dde8; font-weight: 600; cursor: pointer;
}
button:disabled { opacity: .45; cursor: default; }
button.primary { background: #2457c5; border-color: #2f63d6; color: #fff; }
button.go { background: #1d7a4f; border-color: #259660; color: #fff; }
button.warn { background: #7a4a1d; border-color: #96602a; color: #fff; }
button.ghost { background: transparent; }
.check { display: inline-flex; align-items: center; gap: 6px; margin: 0; font-size: 13px; }
.check input { width: auto; }
.status { min-height: 18px; margin-top: 10px; font-size: 13px; white-space: pre-wrap; }
.status.err { color: #ff8a8a; } .status.ok { color: #6fdb9d; }
.muted { color: #66748c; font-size: 12.5px; }
audio { width: 100%; margin-top: 12px; }
a { color: #6ea3ff; }
.hidden { display: none; }
#token-log {
  max-height: 130px; overflow-y: auto; background: #0a0e14; color: #5ad18a;
  font-size: 11px; padding: 6px 8px; border-radius: 6px; margin: 10px 0 0;
}
@media (max-width: 640px) { .grid2, .params { grid-template-columns: 1fr; } }
"""

UI_JS = r"""'use strict';
const $ = (id) => document.getElementById(id);
const SETTINGS = ['text', 'p-temp', 'p-top-k', 'p-top-p', 'p-repeat',
                  'p-n-predict', 'p-seed', 'gen-key', 'add-key'];
const CHECKS = ['opt-stream', 'opt-sse', 'opt-live'];
let abortCtl = null;

// ---- settings persistence (localStorage, like the wasm demo app) ----------
function loadSettings() {
  let s = {};
  try { s = JSON.parse(localStorage.getItem('miotts-ui') || '{}'); } catch (e) {}
  for (const id of SETTINGS) if (s[id] !== undefined) $(id).value = s[id];
  for (const id of CHECKS) if (s[id] !== undefined) $(id).checked = !!s[id];
  if (s['ref'] !== undefined) $('ref-select').dataset.want = s['ref'];
}
function saveSettings() {
  const s = {};
  for (const id of SETTINGS) s[id] = $(id).value;
  for (const id of CHECKS) s[id] = $(id).checked;
  s['ref'] = $('ref-select').value;
  try { localStorage.setItem('miotts-ui', JSON.stringify(s)); } catch (e) {}
}
document.addEventListener('change', saveSettings);
document.addEventListener('input', saveSettings);

function setStatus(id, msg, cls) {
  const el = $(id);
  el.textContent = msg || '';
  el.className = 'status' + (cls ? ' ' + cls : '');
}
async function errorOf(resp) {
  try {
    const j = await resp.json();
    return (j.error && j.error.message) || JSON.stringify(j);
  } catch (e) { return 'HTTP ' + resp.status; }
}

// ---- health + reference list ----------------------------------------------
async function refreshHealth() {
  try {
    const r = await fetch('/mio/health');
    const j = await r.json();
    $('health').textContent =
      `ok · slots ${j.parallel} · refs ${j.reference_cache}` +
      (j.reference_generation_enabled ? ' · clone on' : '');
    $('health').className = 'pill ok';
  } catch (e) {
    $('health').textContent = 'server unreachable';
    $('health').className = 'pill bad';
  }
}
async function refreshRefs() {
  const sel = $('ref-select');
  const want = sel.dataset.want || sel.value;
  try {
    const r = await fetch('/mio/references');
    const j = await r.json();
    sel.innerHTML = '';
    for (const ref of (j.references || [])) {
      const o = document.createElement('option');
      o.value = ref.key;
      o.textContent = `${ref.key} (dim ${ref.embedding_dim})`;
      sel.appendChild(o);
    }
    if (want) sel.value = want;
    delete sel.dataset.want;
    $('ref-count').textContent = `${j.count || 0} reference(s)`;
  } catch (e) {
    $('ref-count').textContent = 'list failed';
  }
}
$('btn-refresh').onclick = () => { refreshRefs(); refreshHealth(); };
$('btn-del-ref').onclick = async () => {
  const key = $('ref-select').value;
  if (!key) return;
  const r = await fetch('/mio/delete_reference', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({reference_key: key})});
  setStatus('synth-status',
            r.ok ? `deleted "${key}"` : await errorOf(r), r.ok ? 'ok' : 'err');
  refreshRefs();
};

// ---- synthesis --------------------------------------------------------------
function requestBody() {
  return {
    text: $('text').value,
    reference_key: $('ref-select').value,
    temp: parseFloat($('p-temp').value),
    top_k: parseInt($('p-top-k').value, 10),
    top_p: parseFloat($('p-top-p').value),
    repeat_penalty: parseFloat($('p-repeat').value),
    n_predict: parseInt($('p-n-predict').value, 10),
    seed: parseInt($('p-seed').value, 10),
  };
}
function showWav(blob, metaText) {
  const url = URL.createObjectURL(blob);
  $('player').src = url;
  $('player').play().catch(() => {});
  const dl = $('wav-download');
  dl.href = url;
  dl.classList.remove('hidden');
  if (metaText) $('metrics').textContent = metaText;
}
$('btn-stop').onclick = () => { if (abortCtl) abortCtl.abort(); };
$('btn-generate').onclick = async () => {
  const btn = $('btn-generate');
  btn.disabled = true;
  $('metrics').textContent = '';
  setStatus('synth-status', 'generating…');
  abortCtl = new AbortController();
  const t0 = performance.now();
  try {
    if ($('opt-sse').checked) await generateSSE(abortCtl.signal, t0);
    else await generateBinary(abortCtl.signal, t0, $('opt-stream').checked);
  } catch (e) {
    setStatus('synth-status',
              e.name === 'AbortError' ? 'stopped' : String(e), 'err');
  } finally {
    btn.disabled = false;
    abortCtl = null;
  }
};
async function generateBinary(signal, t0, stream) {
  const r = await fetch(stream ? '/mio/tts/stream' : '/mio/tts', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(requestBody()), signal});
  if (!r.ok) { setStatus('synth-status', await errorOf(r), 'err'); return; }
  if (!stream) {
    // /mio/tts writes a WAV file server-side and returns JSON metadata
    const j = await r.json();
    setStatus('synth-status',
              `saved on server: ${j.output_file || '(see server log)'} · ` +
              `${j.codes || 0} codes`, 'ok');
    $('metrics').textContent =
      `llm ${Math.round(j.llm_ms || 0)}ms · synth ${Math.round(j.synth_ms || 0)}ms`;
    return;
  }
  const blob = await r.blob();
  const ms = Math.round(performance.now() - t0);
  const sr = r.headers.get('X-Sample-Rate') || '?';
  const n = r.headers.get('X-Audio-Samples') || '?';
  showWav(blob, `${ms}ms total · ${n} samples @ ${sr}Hz`);
  setStatus('synth-status', 'done', 'ok');
}
async function generateSSE(signal, t0) {
  const log = $('token-log');
  log.classList.remove('hidden');
  log.textContent = '';
  const body = requestBody();
  body.stream = true;
  body.stream_tokens = true;
  body.stream_audio = $('opt-live').checked;  // incremental PCM playback
  const r = await fetch('/mio/tts/stream', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(body), signal});
  if (!r.ok || !r.body) { setStatus('synth-status', await errorOf(r), 'err'); return; }
  const reader = r.body.getReader();
  const dec = new TextDecoder();
  let buf = '', nTok = 0;
  // live playback state: audio_chunk PCM plays the moment it stabilizes,
  // scheduled back-to-back on a WebAudio clock; chunks also accumulate so
  // the player/download still get the full WAV at the end
  let liveCtx = null, livePos = 0, liveSr = 24000;
  const liveChunks = [];
  const playChunk = (c) => {
    const bin = atob(c.pcm16);
    const n = bin.length >> 1;
    const f32 = new Float32Array(n);
    for (let i = 0; i < n; i++) {
      let s = bin.charCodeAt(2 * i) | (bin.charCodeAt(2 * i + 1) << 8);
      if (s >= 32768) s -= 65536;
      f32[i] = s / 32768;
    }
    liveSr = c.sr || liveSr;
    liveChunks.push(f32);
    if (!liveCtx) {
      liveCtx = new (window.AudioContext || window.webkitAudioContext)();
      livePos = liveCtx.currentTime + 0.08;
    }
    const ab = liveCtx.createBuffer(1, n, liveSr);
    ab.copyToChannel(f32, 0);
    const srcNode = liveCtx.createBufferSource();
    srcNode.buffer = ab;
    srcNode.connect(liveCtx.destination);
    livePos = Math.max(livePos, liveCtx.currentTime);
    srcNode.start(livePos);
    livePos += n / liveSr;
  };
  const liveWavBlob = () => {
    let total = 0;
    for (const c of liveChunks) total += c.length;
    const flat = new Float32Array(total);
    let off = 0;
    for (const c of liveChunks) { flat.set(c, off); off += c.length; }
    const i16 = new Int16Array(total);
    for (let i = 0; i < total; i++)
      i16[i] = Math.max(-32768, Math.min(32767, Math.round(flat[i] * 32767)));
    const hdr = new ArrayBuffer(44);
    const v = new DataView(hdr);
    const wstr = (o, s) => { for (let i = 0; i < s.length; i++) v.setUint8(o + i, s.charCodeAt(i)); };
    wstr(0, 'RIFF'); v.setUint32(4, 36 + total * 2, true); wstr(8, 'WAVE');
    wstr(12, 'fmt '); v.setUint32(16, 16, true); v.setUint16(20, 1, true);
    v.setUint16(22, 1, true); v.setUint32(24, liveSr, true);
    v.setUint32(28, liveSr * 2, true); v.setUint16(32, 2, true);
    v.setUint16(34, 16, true); wstr(36, 'data'); v.setUint32(40, total * 2, true);
    return new Blob([hdr, i16.buffer], {type: 'audio/wav'});
  };
  const handle = (event, data) => {
    if (event === 'token') {
      const t = JSON.parse(data);
      nTok++;
      log.textContent += (t.code !== undefined ? `<|s_${t.code}|>` : `[${t.id}]`);
      log.scrollTop = log.scrollHeight;
    } else if (event === 'generation_complete') {
      const m = JSON.parse(data);
      setStatus('synth-status',
                `${m.n_codes} codes in ${Math.round(m.llm_ms)}ms — synthesizing…`);
    } else if (event === 'audio_chunk') {
      playChunk(JSON.parse(data));
      setStatus('synth-status', `streaming… (${liveChunks.length} chunks)`);
    } else if (event === 'audio_meta') {
      const m = JSON.parse(data);
      $('metrics').textContent =
        `llm+synth ${Math.round(m.total_ms)}ms · ${m.n_audio} samples @ ${m.sample_rate}Hz`;
      if (m.streamed) {
        // no audio_data follows: assemble the wav from the live chunks
        showWav(liveWavBlob());
        setStatus('synth-status', `done (${nTok} tokens, streamed)`, 'ok');
      }
    } else if (event === 'audio_data') {
      const bin = atob(data);
      const bytes = new Uint8Array(bin.length);
      for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
      showWav(new Blob([bytes], {type: 'audio/wav'}));
      setStatus('synth-status', `done (${nTok} tokens)`, 'ok');
    } else if (event === 'error') {
      setStatus('synth-status', JSON.parse(data).error || data, 'err');
    }
  };
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    let idx;
    while ((idx = buf.indexOf('\n\n')) >= 0) {
      const frame = buf.slice(0, idx);
      buf = buf.slice(idx + 2);
      let event = 'message', data = '';
      for (const line of frame.split('\n')) {
        if (line.startsWith('event: ')) event = line.slice(7);
        else if (line.startsWith('data: ')) data += line.slice(6);
      }
      if (data) handle(event, data);
    }
  }
}

// ---- microphone recording -> PCM16 WAV (decodable by the native parser) ----
let recCtx = null, recNode = null, recStream = null, recChunks = [], recTimer = null;
function encodeWav16(chunks, sampleRate) {
  let n = 0;
  for (const c of chunks) n += c.length;
  const buf = new ArrayBuffer(44 + n * 2);
  const v = new DataView(buf);
  const wstr = (off, s) => { for (let i = 0; i < s.length; i++) v.setUint8(off + i, s.charCodeAt(i)); };
  wstr(0, 'RIFF'); v.setUint32(4, 36 + n * 2, true); wstr(8, 'WAVE');
  wstr(12, 'fmt '); v.setUint32(16, 16, true); v.setUint16(20, 1, true);
  v.setUint16(22, 1, true); v.setUint32(24, sampleRate, true);
  v.setUint32(28, sampleRate * 2, true); v.setUint16(32, 2, true);
  v.setUint16(34, 16, true); wstr(36, 'data'); v.setUint32(40, n * 2, true);
  let off = 44;
  for (const c of chunks) {
    for (let i = 0; i < c.length; i++, off += 2) {
      const x = Math.max(-1, Math.min(1, c[i]));
      v.setInt16(off, x < 0 ? x * 32768 : x * 32767, true);
    }
  }
  return new Blob([buf], {type: 'audio/wav'});
}
$('btn-rec-start').onclick = async () => {
  try {
    recStream = await navigator.mediaDevices.getUserMedia({audio: true});
  } catch (e) {
    setStatus('genref-status', 'microphone unavailable: ' + e, 'err');
    return;
  }
  recCtx = new (window.AudioContext || window.webkitAudioContext)();
  const src = recCtx.createMediaStreamSource(recStream);
  recNode = recCtx.createScriptProcessor(4096, 1, 1);
  recChunks = [];
  recNode.onaudioprocess = (ev) =>
    recChunks.push(new Float32Array(ev.inputBuffer.getChannelData(0)));
  src.connect(recNode);
  recNode.connect(recCtx.destination);
  $('btn-rec-start').disabled = true;
  $('btn-rec-stop').disabled = false;
  const t0 = performance.now();
  recTimer = setInterval(() => {
    $('rec-meter').textContent =
      `recording ${((performance.now() - t0) / 1000).toFixed(1)}s`;
  }, 200);
};
$('btn-rec-stop').onclick = () => {
  clearInterval(recTimer);
  const sr = recCtx.sampleRate;
  recNode.disconnect(); recCtx.close();
  recStream.getTracks().forEach((t) => t.stop());
  $('btn-rec-start').disabled = false;
  $('btn-rec-stop').disabled = true;
  const wav = encodeWav16(recChunks, sr);
  recChunks = [];
  const f = new File([wav], 'recording.wav', {type: 'audio/wav'});
  const dt = new DataTransfer();
  dt.items.add(f);
  $('gen-file').files = dt.files;
  $('rec-meter').textContent = `captured ${(wav.size / sr / 2).toFixed(1)}s — ready`;
};

// ---- reference generation / upload -----------------------------------------
$('btn-gen-ref').onclick = async () => {
  const key = $('gen-key').value.trim();
  const file = $('gen-file').files[0];
  if (!key || !file) {
    setStatus('genref-status', 'key and an audio file (or recording) are required', 'err');
    return;
  }
  setStatus('genref-status', 'extracting speaker embedding…');
  const fd = new FormData();
  fd.append('reference_key', key);
  fd.append('audio', file, file.name);
  const r = await fetch('/mio/generate_reference', {method: 'POST', body: fd});
  if (!r.ok) { setStatus('genref-status', await errorOf(r), 'err'); return; }
  const blob = await r.blob();
  const dl = $('emb-download');
  dl.href = URL.createObjectURL(blob);
  dl.download = key + '.emb.gguf';
  dl.classList.remove('hidden');
  setStatus('genref-status',
            `reference "${key}" created (dim ${r.headers.get('X-Embedding-Dim')})`, 'ok');
  refreshRefs();
};
$('btn-add-ref').onclick = async () => {
  const key = $('add-key').value.trim();
  const file = $('add-file').files[0];
  if (!key || !file) {
    setStatus('addref-status', 'key and a .emb.gguf file are required', 'err');
    return;
  }
  const fd = new FormData();
  fd.append('reference_key', key);
  fd.append('file', file, file.name);
  const r = await fetch('/mio/add_reference', {method: 'POST', body: fd});
  setStatus('addref-status',
            r.ok ? `added "${key}"` : await errorOf(r), r.ok ? 'ok' : 'err');
  refreshRefs();
};

loadSettings();
refreshHealth();
refreshRefs();
"""
