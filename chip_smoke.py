#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (miotts_tpu_torch) through its paths on one
NVIDIA GPU and check every kernel on them.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

1. device: the card's name and power limit; the port's device is set to
   CUDA (TF32 off).
2. build: the CUDA kernels are compiled from ``miotts_tpu_torch/csrc``, and
   the native host runtime (``runtime/native/miotts_runtime.cpp``, g++) on
   a thread beside them.
3. K1 (banded attention, [B, T, H, D]) against its plain PyTorch version on
   the card, max abs error <= 1e-5 (f32, TF32 off): at the four attention
   shapes of a 400- and a 40-code request (each timed beside its bound and
   SDPA with the band mask), ragged B=4 batches, the run-time width
   instance (D = 30, 96) and a narrow window; a non-contiguous q is refused.
4. K2 (decode attention) against its plain version, bf16 KV cache, max abs
   error <= 2e-2 (one bf16 ulp at |x| in [2, 4) is 1.6e-2), at B = 1 and
   at B = 8 with ragged positions, among them 0, the edges of the split
   ranges and a full cache; timed beside SDPA over the same cache prefix
   at B = 1 and pos 128, 450 and 699.
5. K3 (Q8_0 dequant matmul) against its plain version at every (K, N) of
   the 0.1B LLM's quantized leaves, T in {1, 8, 64}, bf16 and f32 x. Both
   sum the same exact bf16 x bf16 products in f32, only in another order,
   so each output may differ by at most 2 * K * 2^-24 * sum_k |x_k w_k|
   (the worst-case rounding of two K-term f32 sums). Two calls give
   bit-equal results (at T = 64 over K splits summed in a cluster). Timed
   at T = 1 and 64 at every leaf beside its bound and the dense bf16 cuBLAS
   GEMM on the same leaf; each line names the kernel's launch plan.
6. K4 (vocoder conv1d) against its plain version at the mel path's shapes
   (C = 128, T up to 491 520, k in {3, 7}, d in {1, 3, 5}, ragged lengths
   at B = 1 and 2) and the short route's (T = 640, k = 3, d in {1, 3, 5},
   with a residual): two f32 sums of K = k*C terms plus bias and residual,
   so each output within 2 (K + 2) 2^-24 (sum |x w| + |b| + |res|). Timed
   at the last stage's noise conv and at 640 rows, beside F.conv1d.
7. K5 (anti-aliased snake) against its plain version at the same shapes
   and at a 40-code request's 640 and 61 440 rows, each timed beside its
   bound, and at 16/20 and 13/15 taps (its generic template): |err| <= 2e-6
   + 1e-5 |ref| (the JAX package's own bound for this kernel,
   tests/test_vocoder.py:186; no long sums).
8. K6 (fused resblock layer) against its plain version at the same shapes
   and d in {1, 3, 5}: max abs error <= 4e-5 (the JAX package's 2e-5 at
   C = 64, tests/test_resblock_fused.py:58, doubled for C = 128's twice
   longer sums); and the same signal in a bucket 480 rows longer gives
   bit-equal valid rows and zeros beyond; also its small-tile plan (k=11)
   and its generic-tap activation (16/20 taps). Timed at the rows of each
   of the five vocoder stages of a 400-code request, each beside its bound.
   Then K7-K9, the decode step's fused glue (``ops/cuda/llm_fused.py``),
   against their plain versions at the served step's shapes (D 768, 12/2
   heads, HD 64, S 1024, F 2048) at B = 1, 2, 4, 8: K8 (q, k, v and the
   cache row it writes, NEOX and adjacent pairs, with and without bias,
   pos at 0, S - 1 and S) and K9 bit-equal, K7 within one bf16 ulp (its sum
   order); each timed beside its plain version and its bound. Then K11
   (``check_gemv``, ``ops/cuda/llm_gemv.py``), the decode step's GEMVs with
   their glue, at the same shapes and V 151 759: each layer kernel's product
   within one bf16 ulp of cuBLAS's plus the f32 sums' error, 2 K 2^-23
   sum |x w|, and its outputs and cache rows bit-equal
   to the plain epilogue on that product, norm_head's logits within K 2^-23
   sum |x w| of its plain version; each timed beside its plain version,
   cuBLAS's product and its byte bound. A decode step launches K7, K8 and
   K9 25 : 12 : 12 (a step's norms, q/k/v and MLPs) or, a dense bf16 LLM
   on one card, K11 12 : 24 : 12 : 1 (norm_qkv, gemv_residual, norm_gateup,
   norm_head), counted apart from K1-K6: the dense paths on one card K11
   alone, the tp groups and quantized leaves K7-K9. Then K10, the served
   step's sampler (``check_sampler``), against ``sample_step_plain`` at B =
   1, 2, 4, 8 and V = 151 759 over the knob grid: equal but for sampled
   top-p lanes at f32 rounding of top_p (at most 1%), timed beside its
   plain version and its bound; every path with a server launches it once
   a served step (1 : 12 against K8), the CLI's single lane never.
9. assets: synthetic GGUFs from a seed: the 24 kHz MioCodec at full width
   in wave mode and in mel mode (100 mels, the 5x4x4x3x2 vocoder at 128
   channels, bench.py's geometry; its vocoder weights scaled by fixed
   factors so the signal stays in range, testing.tame_vocoder_weights), the
   44.1 kHz wave codec with its upsampler (spt 1764, hop 441, one 2x stage
   of kernel 4; testing.full_codec441_config) and the 0.1B
   LLM (qwen2, dim 768, 12 layers, ~151.8k vocab), once with f32 and once
   with Q8_0 matmul weights.
10. requests: four text -> WAV runs through ``miotts_tpu_torch.cli.main``
    on the dense bf16 path (one at ``--repeat-penalty 1.1``); each WAV parses, has the sample count its codes
    imply, is not silent, and only the K1 and K2 launch counters grew.
11. quantized requests on the Q8_0 GGUF: ``--llm-quant q8_0`` and
    ``output`` (K1, K2 and K3 grew), and ``int8`` (W8A8 on exact int8
    dots: K1 and K2 grew, K3 did not).
12. mel requests on the mel codec: text -> WAV at -n 250, and codes -> WAV
    with 40 and with 400 codes; each WAV has stft_frames(n) * 480 samples
    (the vocoder's count), is not silent and has at most 1% of its samples
    at full scale; K1, K4, K5 and K6 grew (K2
    only in the text request), K4-K6 by exactly the launches the vocoder's
    dispatch rules give for the request's bucket.
13. the codec graph (``models/codec_graph.py``), for the 24 kHz wave,
    44.1 kHz wave and mel codecs at buckets 32 and 512 (mel 64 and 512),
    each key plain and as a stream asks for it (anchor, no peak
    normalization, a 32 768-sample window, pcm16): decode 1 eager, decode
    2 the capture and its replay, decodes 3 and 4 replays of a third and of
    the whole bucket, each equal to the eager decode of its input bit for
    bit (else within 1e-5, one 16-bit step more for pcm16, and mel-L1 <
    1e-2, reported), zeros past each count, K1 14 launches a decode and
    K4-K6 as many in a replay as in the eager decode; one B=2 graph a codec
    captured ahead (``MioTTSPipeline.capture``) and replayed on two ragged
    lanes. Eager, capture and replay wall ms, the profiler's busy ms and
    the reserved memory after all captures are printed.
14. the codec's precision knob, each pipeline built with its own setting:
    MIOTTS_CODEC_MATMUL float32, tensorfloat32 (the f32 path) and bfloat16
    for a 400-code wave decode (mel-L1 against the CPU's f32 decode) and
    for mel decodes (64 codes against the CPU's f32 decode, 400 codes
    against the card's f32 decode): mel-L1 < 1e-2 required of every mode
    but the mel codec's bfloat16, which is reported (this is also the mel
    codec's fidelity check); K4-K6 launches by the dispatch rules. Eager,
    capture and replay ms and a replay's busy ms printed for each.
15. 44.1 kHz requests: text -> WAV (-n 120) and codes -> WAV (400 codes)
    through ``cli.main``; each WAV is 44 100 Hz with the upsampled iSTFT's
    sample count, not silent, one eager decode (K1 14 times).
16. fidelity: the same 250 codes through the wave codec and the same 250
    through the 44.1 kHz codec, each decoded on the card and on the CPU
    (plain versions, f32): mel-L1 < 1e-2. Then the reserved memory of the mel codec's graphs at
    buckets 512 and 2 048, in one shared pool and with a pool each.

The decode loop (``models/decode_graph.py``): every text request above
generates through replays of its engine's CUDA graph of 16 decode steps
(``llm.CHUNK``); each request must run no eager step on the card and
exactly ceil(tokens / 16) replays. Before the requests, a graph phase, at
the full width of the 0.1B LLM for each of bf16, q8_0, output and int8:
120 greedy tokens from a 32-token prompt through one chunk captured on
empty buffers (``llm.chunk``), run eagerly (``Chunk.run_eager``) and as
replays (two runs in a row, each loaded into its buffers), are
bit-equal, the largest difference of the final logits is printed, K2
launched 12 and K3 49 (q8_0) or 1 (output) times a step that ran (warm-up
and replays counted); ms a token, tok/s,
device ms a step (CUDA events around a replay; the profiler's busy time
for both) and the capture's time are printed; and sampled runs (temp 0.8,
top-k 50) for seeds 1, 1, 2 in a row on one graph each equal the eager
run of their seed, and seed 2's differ from seed 1's. After
the 44.1 kHz requests, a stream phase: four ``--tts-stream-output``
requests through ``cli.main`` (wave codec, dense at -n 250 and q8_0 at -n
120; mel codec at -n 120; 44.1 kHz codec at -n 250), each WAV with patched
sizes, the full decode's sample count, not silent (mel: at most 1%
clipped), the launch checks above, and TTFA, codec re-decodes, how many of
them were replays and their wall time printed. Every CLI request's codec
decodes follow the graph's key policy: one eager decode a key, and every
decode of a key after its second a replay.

Then a clone phase (voice cloning: ``models/wavlm.py``, the codec's global
encoder, ``pipeline.reference_embedding``), on a WavLM Base+ GGUF at its
published widths (2 layers, 12 heads of 64, ffn 3072, the 7-conv stack at
512 channels, 320 buckets) and the 24 kHz codec written with its global
encoder (input 768, dim 384, 4 ConvNeXt blocks, output 128): 24 kHz
references of 3, 20 and 25 s (WAV; the 25 s one cut to 20 s by the default
--tts-max-reference-seconds), the 3 s one as a FLAC and as an mp3
(``tests/torch_assets/ref3.mp3``, LAME's Info frame in front; each of their
four host decodes by the native library, required), each four times on
one card pipeline (a WavLM bucket's first chain eager under sync-debug
"error", its second the capture of the bucket's CUDA graph, then replays;
a reference whose bucket has its graph replays all four), every run
bit-equal to the first and to the chain run eagerly by name, and once on
the CPU (the same port module): the rung ssl, embeddings within 1e-3 max
abs and cosine >= 0.9999, and the same bucket table. A 2.5 s reference
(another length in the 3 s one's bucket) replays that graph bit-equal to
its own eager chain; two threads running chains at once (of one bucket,
and of two) each get their eager embedding; the reference graphs keep a
memory pool apart from the codec graphs'. Host decode ms, the device
chain's wall ms of each run and the capture's, the profiler's busy ms of
an eager chain and of a replay, the peak allocated memory and the
reference pool's MiB are printed. Through
``cli.main``: a text request cloned from the 20 s reference (-n 120, K1 and
K2 grow, --tts-mio-embedding-out bit-equal to the in-process card
embedding), --tts-mio-embedding-only (an embedding, no WAV), and 400 codes
with --tts-mio-embedding-in of that embedding, whose decode card vs CPU
has mel-L1 < 1e-2. Then a --tts-wavlm-model server (-np 2 -n 120
--warmup on, --parallel-reference-generation 2): /mio/generate_reference
as JSON and as a multipart upload (each embedding within 1e-3 of the
in-process one; each bucket's eager chain), /mio/tts/stream with both
keys, two generations concurrent with two text /mio/tts requests (the
buckets' captures), two alone and two more beside two text requests
(replays), none failing, each bucket captured once. Then the port's C
client bridge (``miotts_tpu_torch/bindings``, built with g++ beside the
kernels) uploads ``ref3.mp3`` to that server
(``mio_tpu_client_create_reference_from_audio``: decoded natively, its
embedding within 1e-3 of the in-process one) and synthesizes one text
request in that voice (``mio_tpu_client_synthesize_to_wav``: a WAV back,
K1 and K2 launched for it).

Last, a server phase (``miotts_tpu_torch/serving/``): the port's
MioTTSServer in this process (port 0, so the launch counters are readable)
on the dense 0.1B LLM and the 24 kHz wave codec with ``-np 8 -n 250
--ctx-size 512 --warmup on`` and the JAX batcher's defaults (width-sliced
chunks, the fused prefill, the attach hold, depth 1): the time until it
listens (the foreground warm-up) and until the background tail ends, the
max_memory_reserved at each, and every chunk graph (rungs 12/32/64 x
widths 1/2/4/8) and fused first-chunk graph (k = 1/2/4/8) captured;
/mio/health answers; inline codes through /mio/tts/stream equal
``pipeline.synthesize`` of them within one PCM16 step; a sampled
codes_only request (seed 7, temp 0.8, top_k 50) gives the same codes alone
and with 7 neighbours of other seeds sent 0.3 s after it, with slicing off
(its prefill runs alone both times, its decode steps at B = 8), and
whether it still does when all 8 are sent at once (reported: its prefill
may then be coalesced); seed 7 beside one neighbour and then another, each
time one prefill group of two run at width 2 to the end, gives the same
tokens; greedy codes against the B=1 engine and width 1 against the full
width (the common prefixes reported); a request at repeat penalty 1.1;
two rounds each at concurrency 1, 4 and 8 of text /mio/tts/stream
requests (WAVs parse, are not silent, hold all 250 codes, distinct
X-Slot; aggregate audio-s per s, p50/p90 latency, mean llm_ms and
synth_ms, the attach holds and their ms, K1 and K2 launches a request and
chunks by width) and two at concurrency 4 with MIOTTS_CHUNK_DEPTH=2
(reported); with the fused prefill off, a concurrency-4 round whose every
prefill group takes the unfused path (``llm_prefill_kv`` on the prefill
stream, the worker's attach after its event), each request its 250 tokens,
and seed 7 alone == among 7 neighbours again (slicing off); two concurrent SSE stream_audio requests
deliver audio (first token, first chunk token and TTFA printed);
generation ran on chunk-graph replays only (no eager step), and the served
requests alone launched K1 and K2 with chunks at widths 1, 2, 4 and 8 (the
reference runs between them are not counted); a 64-step chunk's device ms
at occupancy 1, 2, 4 and 8 at the width picked; each width's graph (3
live lanes and a pad at width 4) and each fused first-chunk graph
replayed bit-equal to its eager body from the same state; K2 at B = 1, 2,
4 and 8 and S = 512 and the server's cache rows (beside SDPA), K1 at a
served group's B = 8 ragged trunk shapes and K3 at T = 1, 2 and 4 lanes,
each against its plain version. Then a second server with ``--warmup
off``: one round of 8 (4 binary, 4 SSE stream_audio) in which codec keys
get their eager decode and capture and the chunk and fused graphs their
capture while the worker replays and the prefill thread prefills: no
request may fail, and K1 and K2 grow. Then a ``-np 4 --llm-quant q8_0``
server serves 1, 2 and 3 requests at once: chunks at widths 1 and 2, and
K3 grows. Then ``--llm-api-url`` against an in-process stub endpoint, in
openai-chat and generic mode: ``cli.main`` text -> WAV with no -m, and a
server with no LLM serving a text request; each WAV equals
``pipeline.synthesize`` of the stub's codes within one PCM16 step, K1
launches and K2 does not. Last, a CLI request (400 codes) in a child
process with ``MIOTTS_PROFILE_DIR`` set must leave one Chrome trace with
the ``miocodec_synthesize`` range and K1's kernel in it. The graph phase
also holds a repeat penalty of 1.1 (greedy, and sampled with seed 5)
replayed against the eager body, and the dense requests include one at
``--repeat-penalty 1.1``.

Before the paths, a native phase (``runtime/native.py``, host C++ on the
card machine's CPU): the library must be loaded (the card machine has g++,
which nvcc needs); its path, ABI and the host CPU's model are printed;
``ref3.flac`` and a 20 s 44.1 kHz stereo FLAC (LPC, mid/side), and the
committed mp3 fixtures ``ref3.mp3`` (24 kHz mono, LAME's Info frame) and a
20 s 44.1 kHz joint-stereo mp3, are decoded natively and by the numpy
decoders, and the Q8_0 LLM's head (151 759 x 768)
and a BF16 tensor of that shape are dequantized natively and by numpy, each
pair bit-equal, with both times. After the paths, ``[native]`` lines read
back the per-leaf LLM loads (their tensors dequantized natively) and the
clone phase's host decodes of ``ref3.flac`` and ``ref3.mp3``, which must
have been native.

First among the paths, a load phase (M7, ``runtime/device_dequant.py``):
the dense (f32) and Q8_0 0.1B LLM GGUFs (the latter with ``--llm-quant
q8_0``), the 24 kHz codec and WavLM Base+ each loaded three ways on the
card: per leaf (MIOTTS_DEVICE_DEQUANT=0), packed (=1; the LLMs write their
deploy artifact) and again (the LLMs replay the artifact, the others pack
again); every leaf torch.equal across the three, the same bytes allocated
after each, each load on its own route and none falling back; wall
seconds (read, pack, copy, assemble), MB copied, max_memory_allocated and
the tensors the native host runtime dequantized printed. Then CLI requests on those routes (-n 120, greedy): ``--llm-quant
q8_0`` replayed from the artifact (K1, K2, K3) and the dense path on the
raw Q8_0 payload dequantized on the card (K1, K2), each with the codes of
the same request on per-leaf weights; a server (dense on the Q8_0 GGUF,
-np 2 --warmup off) started twice on one artifact directory, cold and
warm, with its time to listen, the replay's stderr line and one request
on the replayed weights; and ``MioTTSEngine.unload_llm()`` with a reload through the packed
route on a thread while this thread captures new codec graph keys (B = 2):
both succeed, a capture overlaps the reload, each new key's replay equals
its eager decode, and the reloaded engine speaks. Last of all, a
cpu_native phase: ``--cpu-native on`` under MIOTTS_PLATFORM=cuda runs the
card's engine (K1 and K2 launch, the CLI builds no native engine), and
under MIOTTS_PLATFORM=cpu the native int8/int4 engine writes 64 tokens
from the Q8_0 GGUF as it is and requantized to Q4_0
(MIOTTS_CPU_QUANT=q4_0), its tokens/s printed with the host CPU's name.

After the server phase, a mesh phase (``parallel/``): the server with
``--mio-backend-devices all -tp 2 -np 8 -n 250 --warmup off`` on four
logical ranks of the card (MIOTTS_LOGICAL_DEVICES=4, dp=2 x tp=2), dense and
q8_0, its graphs captured through the batcher's warm calls, then
concurrency 1/4/8 at 250 tokens (audio-s per s beside the mesh-less
server's rounds of the server phase); required: K2 (and in q8_0 K3)
launched by every logical rank at concurrency 8 (``graphs.rank_launches``)
and /mio/health's backend_devices 4 and tensor_parallel 2; a dp rank's
64-step chunk replay timed (a tp=2 decode step's device ms) with its K2
and K3 launches a step by rank; and a -np 2 int8 server with and without
the mesh (whose tp sums are exact int32 dots) giving equal greedy codes
for a 64-token request (required; the dense mesh's greedy codes against
the server phase's are reported, since a bf16 rank rounds its partial
sums apart). These are a mesh's overheads on one card, not a multi-card
speed-up.

After the mesh phase, an sp phase (``--sequence-parallel``,
``parallel/sequence.py``) on MIOTTS_LOGICAL_DEVICES=4 ranks of the card at
full width: K1 at a rank's halo-extended shapes (timed beside its bound and
SDPA with the band mask); the CLI with ``--sequence-parallel 2`` and ``4``
on 400 codes and on 390, whose end falls inside a rank's halo, each WAV
within 2 int16 steps of the mesh-less CLI's and K1 14 launches on every
rank; and for the 24 kHz, 44.1 kHz and mel codecs four
``pipeline.synthesize`` decodes of 400 codes at sp = 2 and 4 (eager,
capture, two replays), each within 1e-4 of the mesh-less decode (or, where
the codec's mesh-less decode itself moves further with its GroupNorm
statistics summed in f64, four times that move) with mel-L1 < 1e-2, every
replay bit-equal to the eager decode, K1 14 launches a decode on every rank
and K4, K5 and K6 on every rank in mel mode (``graphs.rank_launches``);
eager, capture and replay wall ms beside the mesh-less pipeline's; a
stream's window fetch at sp = 4; and the mel sp decode's mel-L1 against
the CPU's f32 decode.

Before the last line it prints one JSON object with each kernel's launch
count in the request paths (each path driven with every count at 0), its
error, its time, its plain version's time, its bound (the least time the
card could take: bytes over 3.35 TB/s or operations over the peak rate of
their type, whichever is larger, from this run's inputs) and one PyTorch
call's time where one computes the same function; the last line is
``{"ok": true, "device": {...}}``. Needs no network and writes only to a
temporary directory and the kernels' build directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from miotts_tpu_torch import cli
from miotts_tpu_torch import pipeline as pipeline_mod
from miotts_tpu_torch.device import select_device, to_host
from miotts_tpu_torch.models import codec_graph, decode_graph
from miotts_tpu_torch.models.llm import (
    CHUNK, chunk, empty_gen_state, fetch_chunk_result, finish_chunk_fetch, llm_start,
    load_llm_gguf)
from miotts_tpu_torch.models import sampling
from miotts_tpu_torch.models.sampling import SamplerParams, sampler_key
from miotts_tpu_torch.ops.cuda import activation1d as k5
from miotts_tpu_torch.ops.cuda import banded_attention as k1
from miotts_tpu_torch.ops.cuda import build, graphs
from miotts_tpu_torch.ops.cuda import conv1d as k4
from miotts_tpu_torch.ops.cuda import decode_attention as k2
from miotts_tpu_torch.ops.cuda import llm_fused, llm_gemv
from miotts_tpu_torch.ops.cuda import q8_matmul as k3
from miotts_tpu_torch.ops.cuda import resblock as k6
from miotts_tpu_torch.parallel.mesh import logical_devices
from miotts_tpu_torch.pipeline import CodecKey, MioTTSPipeline, pick_bucket
from miotts_tpu_torch.runtime import device_dequant, native
from miotts_tpu_torch.streaming import StreamingSynthesizer
from miotts_tpu_torch.testing import (
    full_codec441_config, full_codec_config, full_mel_codec_config, full_wavlm_kwargs, mel_l1,
    save_embedding_gguf, synthetic_vocab, tame_vocoder_weights, write_synthetic_llm_gguf,
    write_synthetic_mel_vocoder_gguf, write_synthetic_miocodec_gguf, write_synthetic_wavlm_gguf)

MODS = (k1, k2, k3, k4, k5, k6)
FUSED = llm_fused.KERNELS  # K7-K10, counted apart from MODS
# K11 (norm_qkv, gemv_residual, norm_gateup, norm_head): the decode step of a
# dense bf16 LLM on one card; K7-K9 keep every other decode step
GEMV = llm_gemv.KERNELS
# the served decode step's shapes (LLM_WIDTHS, --ctx-size 1024)
FUSED_SHAPE = {"D": 768, "H": 12, "KVH": 2, "HD": 64, "S": 1024, "F": 2048}
# bf16 ulps a fused kernel may lie from its plain version: K7 1, for the
# order of its f32 sum of squares against ATen's reduction; K8 and K9 none
FUSED_ULPS = {"add_rms_norm": 1, "qkv_rope_cache": 0, "silu_mul": 0,
              # K11's layer kernels: their product (``prod``, rounded to bf16)
              # within 1 ulp of cuBLAS's same product plus the two f32 sums'
              # own error, 2 K 2^-23 sum |x w| (each sum taken in its own
              # order, the tensor cores' truncating): where the dot product
              # cancels, a result far below sum |x w|, that error reaches
              # whole bf16 ulps of the result (2-4 read at K 2048), so the
              # ulps are printed and the bound is held. Each output and cache
              # row bit-equal (0 ulps) to the plain epilogue on that product.
              # A product's ulp moves an output of the whole plain chain by
              # more where the bias add, RoPE's rotation or the residual add
              # cancels, so that distance is printed, not held
              "norm_qkv": 1, "gemv_residual": 1, "norm_gateup": 1}
# norm_head's f32 logits are held to K * 2^-23 * sum_i |x_i w_i| of the plain version's at
# depth K (the worst-case rounding of a K-term f32 sum). A K11 kernel is timed over
# distinct copies of its weight, more bytes than the 50 MB L2, as the step reads them
GEMV_COPIES_BYTES = 128 << 20
# K10 (llm_fused.sample_step) at the 0.1B LLM's vocabulary, every lane one
# (temp, top_k, top_p, repeat penalty) of this grid
SAMPLER_V = 151759
SAMPLER_GRID = tuple((t, k, p, r) for t in (0.0, 0.8) for k in (1, 50, 256, 0, 300)
                     for p in (1.0, 0.9) for r in (1.0, 1.3))
SAMPLER_PASSES = 3  # passes over the grid at each B
# a sampled top-p lane may differ from the plain version only where a
# candidate's cum - prob lies within this many f32 ulps of top_p (the sums
# run in another order), and at most this share of such lanes
SAMPLER_ULPS = 4
SAMPLER_EXCUSED_MAX = 0.01
K1_TOL = 1e-5
K1_WINDOW = 65  # the codec transformers' window
# K1 at the codec's attention shapes (D = 64): (name, B, H, T, lengths); a
# 400-code request's prenet and decoder (buckets 512 and 1 024 frames), a
# 40-code one's (64 and 128), and B=1 H=8 T=1024 at length 954
K1_SHAPES = (("400-code prenet", 1, 12, 512, [400]), ("400-code decoder", 1, 8, 1024, [800]),
             ("40-code prenet", 1, 12, 64, [40]), ("40-code decoder", 1, 8, 128, [80]),
             ("long", 1, 8, 1024, [954]))
K2_TOL = 2e-2
K5_ATOL, K5_RTOL = 2e-6, 1e-5
K6_TOL = 4e-5
MEL_L1_MAX = 1e-2
# NVIDIA H100 SXM data sheet: HBM3 rate, f32 outside the tensor cores, dense bf16
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
VOCODER_CH = 128
# (B, T, lengths) of the vocoder kernels' checks: stage 1 of a 400-code
# request (bucket 512: 5 120 rows, 4 000 valid), a ragged pair, and the last
# stage (491 520 rows, 384 000 valid), where each kernel is timed
VOC_SHAPES = ((1, 5120, [4000]), (2, 2560, [2560, 1777]), (1, 491520, [384000]))
# K6 timed at each vocoder stage of a 400-code request: (padded rows, valid rows)
K6_STAGES = ((5120, 4000), (20480, 16000), (81920, 64000), (245760, 192000), (491520, 384000))
MEL_CLIPPED_MAX = 0.01  # share of a mel request's samples at full scale
MEL_REQUESTS = (  # (name, extra flags, kernels that must launch)
    ("text-250", ["-m", "llm.gguf", "-p", "The quick brown fox jumps over the lazy dog, twice.",
                  "-n", "250", "--seed", "1"], (k1, k2, k4, k5, k6)),
    ("codes-40", ["--tts-mio-codes-in", "codes40.txt"], (k1, k4, k5, k6)),
    ("codes-400", ["--tts-mio-codes-in", "codes400.txt"], (k1, k4, k5, k6)),
)
LLM_WIDTHS = dict(n_audio=12800, dim=768, n_layers=12, n_heads=12, n_kv_heads=2, ffn=2048,
                  seed=0, n_filler_vocab=138_700, audio_logit_scale=3.0)
REQUESTS = (  # (prompt, n_predict, extra flags)
    ("Hello there.", 120, ["--temp", "0"]),
    ("The quick brown fox jumps over the lazy dog, twice.", 250, ["--seed", "1"]),
    ("A longer request: it reads a whole paragraph of text aloud, clause by clause, "
     "so that the codec decodes a long bucket of codes.", 400, ["--seed", "2", "--top-p", "0.9"]),
    # a repeat penalty other than 1: its scatter inside the captured graph
    ("Hello there.", 120, ["--temp", "0", "--repeat-penalty", "1.1"]),
)
QUANT_REQUESTS = (  # (prompt, n_predict, extra flags, kernels that must launch)
    ("The quick brown fox jumps over the lazy dog, twice.", 250,
     ["--llm-quant", "q8_0", "--seed", "1"], (k1, k2, k3)),
    ("Hello there.", 120, ["--llm-quant", "output", "--temp", "0"], (k1, k2, k3)),
    ("Hello there.", 120, ["--llm-quant", "int8", "--temp", "0"], (k1, k2)),
)
GRAPH_TOKENS, GRAPH_PROMPT, GRAPH_CACHE = 120, 32, 700  # GRAPH_CACHE: the CLI's cache rows
GRAPH_MODES = (("bf16", "llm.gguf"), ("q8_0", "llm_q8_0.gguf"), ("output", "llm_q8_0.gguf"),
               ("int8", "llm_q8_0.gguf"))  # (--llm-quant, GGUF)
STREAM_PROMPT = "The quick brown fox jumps over the lazy dog, twice."
STREAM_REQUESTS = (  # (name, codec, llm, n_predict, extra flags, kernels that must launch)
    ("wave-bf16", "codec.gguf", "llm.gguf", 250, ["--seed", "1"], (k1, k2)),
    ("wave-q8_0", "codec.gguf", "llm_q8_0.gguf", 120, ["--llm-quant", "q8_0", "--seed", "1"],
     (k1, k2, k3)),
    ("mel-bf16", "mel_codec.gguf", "llm.gguf", 120, ["--seed", "1"], (k1, k2, k4, k5, k6)),
    ("wave441-bf16", "codec441.gguf", "llm.gguf", 250, ["--seed", "1"], (k1, k2)),
)
GRAPH_COUNTERS = ("captures", "replays", "capture_ms", "warmup_steps", "eager_steps")
CODEC_COUNTERS = ("captures", "replays", "capture_ms", "replay_ms", "eager")
WAVE441_REQUESTS = (  # (name, extra flags, kernels that must launch)
    ("text-120", ["-m", "llm.gguf", "-p", "Hello there, in forty-four kilohertz.", "-n", "120",
                  "--seed", "1"], (k1, k2)),
    ("codes-400", ["--tts-mio-codes-in", "codes400.txt"], (k1,)),
)
# the codec graph phase: (codec, GGUF, buckets); a replay must equal the
# eager decode of its input bit for bit, or else within REPLAY_TOL and
# mel-L1 < MEL_L1_MAX (a cuBLAS or cuDNN algorithm picked otherwise under
# capture), and that is reported
CODEC_GRAPH_CASES = (("wave", "codec.gguf", (32, 512)), ("wave441", "codec441.gguf", (32, 512)),
                     ("mel", "mel_codec.gguf", (64, 512)))
REPLAY_TOL = 1e-5
K1_PER_DECODE = 14  # 6 prenet + 8 decoder layers


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs, after a
    warm-up. A sleep kernel holds the stream while the host enqueues the
    runs, so the events time the device, not the Python launch overhead
    (which exceeds a small kernel's run time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def uncounted():
    """Launches inside are a check's or a reference's, not the path's own:
    every kernel's count is put back on exit."""
    saved = {m: m.launches for m in graphs.counters()}
    try:
        yield
    finally:
        for m, n in saved.items():
            m.launches = n


def least_time(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the bytes the function must move
    over the memory rate, or its operations over ``peak``, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def band_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, T] SDPA mask of K1's rule: |k - q| <= 32 and k < length, or k == q."""
    i = torch.arange(T, device=lengths.device)
    band = (i[None, :] - i[:, None]).abs() <= K1_WINDOW // 2
    return ((band[None] & (i[None, None, :] < lengths[:, None, None]))
            | torch.eye(T, dtype=torch.bool, device=lengths.device)[None])[:, None]


def k1_case(dev, gen, B: int, T: int, H: int, D: int, lens: list[int], window: int = K1_WINDOW):
    """K1 against its plain version on random [B, T, H, D] inputs; fails
    past K1_TOL. Returns (max abs error, q, k, v, lengths)."""
    q, k, v = (torch.randn(B, T, H, D, generator=gen).to(dev) for _ in range(3))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = k1.banded_attention(q, k, v, lengths, window)
    torch.cuda.synchronize()
    ref = k1.banded_attention_plain(q, k, v, lengths, window)
    err = (got - ref).abs().max().item()
    if got.shape != q.shape or not got.is_contiguous() or not err <= K1_TOL:
        raise AssertionError(f"K1 B={B} T={T} H={H} D={D} window={window}: error {err} "
                             f"(> {K1_TOL}?), shape {tuple(got.shape)}")
    log(f"[k1] B={B} T={T} H={H} D={D} window={window} lengths={lens} "
        f"launch={tuple(k1.launch_shape(B, T, H, D, window))}: max_abs_err={err:.3e}")
    return err, q, k, v, lengths


def k1_timing(dev, gen, what: str, B: int, H: int, T: int, lens: list[int]
              ) -> tuple[list, float, dict]:
    """K1 at [B, T, H, 64] against its plain version, timed beside its bound
    and one SDPA call with the band mask (on [B, H, T, D] copies): ([kernel,
    plain, SDPA, bound] ms, max abs error, the kernel line's fields)."""
    err, q, k, v, lengths = k1_case(dev, gen, B, T, H, 64, lens)
    mask = band_mask(T, lengths)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_ms(lambda: k1.banded_attention(q, k, v, lengths, K1_WINDOW))
    plain = cuda_ms(lambda: k1.banded_attention_plain(q, k, v, lengths, K1_WINDOW))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    diff = (F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask).transpose(1, 2)
            - k1.banded_attention(q, k, v, lengths, K1_WINDOW)).abs().max().item()
    nbytes = 4 * 4 * B * T * H * 64 + 4 * B  # q, k, v in, out; lengths
    # two FMAs (score and value) a pair and a column
    lb = least_time(nbytes, 4 * 64 * H * int(mask.sum()), F32_FLOP_S)
    log(f"{what} B={B} H={H} T={T} lengths={lens} "
        f"launch={tuple(k1.launch_shape(B, T, H, 64, K1_WINDOW))}: kernel={ms:.4f}ms "
        f"plain={plain:.4f}ms SDPA(band mask)={lib:.4f}ms (max diff {diff:.3e}) "
        f"bound={lb['bound_ms']:.5f}ms ({lb['bound_by']})")
    return ([round(ms, 5), round(plain, 5), round(lib, 5), round(lb["bound_ms"], 5)], err,
            {"ms": ms, "plain_ms": plain, **lb, "library_ms": lib})


def check_k1(dev, gen) -> dict:
    worst, by_shape, at = 0.0, {}, {}
    # the codec's request shapes (B=1), each timed beside its bound and one
    # SDPA call with the band mask (on [B, H, T, D] copies)
    for name, B, H, T, lens in K1_SHAPES:
        by_shape[name], err, row = k1_timing(dev, gen, f"[k1] {name}", B, H, T, lens)
        worst = max(worst, err)
        if (B, H, T, lens) == (1, 8, 1024, [954]):
            at = {**row, "at": "B=1 H=8 T=1024 D=64, length 954; library = SDPA with the "
                               "band mask"}
    # ragged batches, the trunk's other stack widths, the run-time width
    # instance (D not 64, D not a multiple of 4) and a narrow window
    for B, T, H, D, window in ((4, 512, 12, 64, 65), (4, 1024, 8, 64, 65), (4, 256, 12, 64, 65),
                               (4, 70, 2, 30, 65), (2, 300, 3, 96, 65), (3, 97, 2, 64, 9)):
        lens = [T, T - 17, T - 70, T // 3][:B]
        worst = max(worst, k1_case(dev, gen, B, T, H, D, lens, window)[0])
    # a q that is a slice of a wider tensor is refused, not copied
    qkv = torch.randn(1, 64, 3, 12, 64, device=dev)
    lengths = torch.tensor([40], dtype=torch.int32, device=dev)
    try:
        k1.banded_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], lengths, K1_WINDOW)
    except ValueError as e:
        log(f"[k1] a non-contiguous q (a slice of [1, 64, 3, 12, 64]) is refused: {e}")
    else:
        raise AssertionError("K1 took a non-contiguous q")
    # per request shape: [kernel, plain, SDPA with the band mask, bound] ms
    return {"max_abs_err": worst, **at, "by_shape_ms": by_shape}


def check_k2(dev, gen) -> dict:
    worst, at, by_pos = 0.0, {}, {}
    S, KVH, G, HD = 700, 2, 6, 64
    bf = torch.bfloat16
    # one lane at the cache's end; ragged lanes; the empty cache, the edges
    # of the 88-row split ranges and a full cache
    for B, pos_l in ((1, [S - 1]), (8, [0, S - 1, 1, 64, 129, 350, 511, 698]),
                     (8, [0, 1, 87, 88, 89, 176, S - 1, S])):
        q = torch.randn(B, KVH, G, HD, generator=gen).to(dev, bf)
        kc, vc = (torch.randn(B, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
        ck, cv = (torch.randn(B, S, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        args = (q, kc, vc, ck, cv, 1.0 / math.sqrt(HD), pos)
        got = k2.decode_attention(*args)
        torch.cuda.synchronize()
        ref = k2.decode_attention_plain(*args)
        err = (got.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: k2.decode_attention(*args))
        plain = cuda_ms(lambda: k2.decode_attention_plain(*args))
        log(f"[k2] B={B} S={S} KVH={KVH} G={G} HD={HD} bf16 pos={pos_l} "
            f"launch={k2.launch_shape(B, S, KVH)}: max_abs_err={err:.3e} kernel={ms:.4f}ms "
            f"plain={plain:.4f}ms")
        if not err <= K2_TOL:
            raise AssertionError(f"K2 error {err} > {K2_TOL} at B={B} pos={pos_l}")
        worst = max(worst, err)
        if B > 1:
            continue
        # B=1 at the positions a 400-token request crosses: kernel, plain and
        # one SDPA call over the same cache prefix
        for p in (128, 450, S - 1):
            pos = torch.full((1,), p, dtype=torch.int32, device=dev)
            args = (q, kc, vc, ck, cv, 1.0 / math.sqrt(HD), pos)
            ms = cuda_ms(lambda: k2.decode_attention(*args))
            plain = cuda_ms(lambda: k2.decode_attention_plain(*args))
            keys = torch.cat([ck[:, :p], kc[:, None]], 1).transpose(1, 2).contiguous()
            vals = torch.cat([cv[:, :p], vc[:, None]], 1).transpose(1, 2).contiguous()
            qh = q.reshape(B, KVH * G, 1, HD)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, keys, vals, enable_gqa=True))
            nbytes = 2 * (2 * (p + 1) * KVH * HD + KVH * G * HD) + 2 * KVH * G * HD + 4
            ops = 4 * (p + 1) * KVH * G * HD
            bound = least_time(nbytes, ops, BF16_FLOP_S)
            log(f"[k2] B=1 S={S} pos={p} launch={k2.launch_shape(B, S, KVH)}: kernel={ms:.4f}ms "
                f"plain={plain:.4f}ms SDPA(cache prefix, GQA)={lib:.4f}ms "
                f"bound={bound['bound_ms']:.5f}ms ({bound['bound_by']})")
            by_pos[f"pos {p}"] = [round(ms, 5), round(plain, 5), round(lib, 5)]
            at = {"ms": ms, "plain_ms": plain, **bound, "library_ms": lib,
                  "at": f"B=1 S={S} KVH={KVH} G={G} HD={HD}, pos {p}; library = SDPA over "
                  f"the cache prefix, GQA"}
    # per position: [kernel, plain, SDPA] ms
    return {"max_abs_err": worst, **at, "by_pos_ms": by_pos}


def k3_shapes() -> list[tuple[str, int, int]]:
    """(leaf, K, N) of every Q8_0 matmul of the 0.1B LLM at LLM_WIDTHS; the
    head's N is the vocab padded to a multiple of 128, as the loader pads."""
    w = LLM_WIDTHS
    hd = w["dim"] // w["n_heads"]
    vocab = len(synthetic_vocab(w["n_audio"], w["n_filler_vocab"])[0])
    return [("wqkv", w["dim"], (w["n_heads"] + 2 * w["n_kv_heads"]) * hd),
            ("wo", w["n_heads"] * hd, w["dim"]), ("w_gateup", w["dim"], 2 * w["ffn"]),
            ("w_down", w["ffn"], w["dim"]), ("output", w["dim"], -(-vocab // 128) * 128)]


def k3_bound(T: int, K: int, N: int) -> dict:
    """K3's least time: q, s and bf16 x read once, f32 y written once; or
    2 T K N operations at the bf16 peak."""
    nbytes = K * N + K // k3.QBLOCK * N * 4 + 2 * T * K + 4 * T * N
    return least_time(nbytes, 2 * T * K * N, BF16_FLOP_S)


def k3_weights(dev, gen, K: int, N: int):
    """K3's inputs as the loader makes them: int8 in [-127, 127] and
    f16-representable positive scales (quantize_q8_cols); also the dense
    bf16 weight the unquantized path multiplies by (cuBLAS) and its
    absolute values (for the error bound)."""
    q = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).to(dev)
    s = (torch.rand(K // k3.QBLOCK, N, generator=gen) * 0.02 + 1e-3).half().float().to(dev)
    w_bf16 = (q.float() * s.repeat_interleave(k3.QBLOCK, dim=0)).to(torch.bfloat16)
    return q, s, w_bf16, w_bf16.float().abs()


def k3_case(leaf: str, x, q, s, w_abs) -> tuple[float, float, tuple]:
    """K3 against its plain version on x [T, K]: every element within its
    rounding bound, and two calls bit-equal. Returns (max abs error, the
    largest error over its bound, the launch plan)."""
    (T, K), N = x.shape, q.shape[1]
    plan = k3.launch_shape(T, K, N, x.element_size())
    got = k3.q8_matmul(x, q, s)
    torch.cuda.synchronize()
    ref = k3.q8_matmul_plain(x, q, s)
    bound = 2 * K * 2.0 ** -24 * (x.to(torch.bfloat16).float().abs() @ w_abs)
    if got.shape != (T, N) or got.dtype != torch.float32:
        raise AssertionError(f"K3 {leaf} T={T}: {tuple(got.shape)} {got.dtype}")
    err = (got - ref).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"K3 {leaf} K={K} N={N} T={T} x={x.dtype}: error "
                             f"{err.max().item()} exceeds its bound")
    if not torch.equal(k3.q8_matmul(x, q, s), got):
        raise AssertionError(f"K3 {leaf} T={T} x={x.dtype}: two calls differ ({plan.kind} "
                             f"path, {plan.z} K splits)")
    return err.max().item(), (err / bound).max().item(), plan


def check_k3(dev, gen) -> dict:
    worst, rows = 0.0, {}
    for leaf, K, N in k3_shapes():
        q, s, w_bf16, w_abs = k3_weights(dev, gen, K, N)
        for T in (1, 8, 64):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn(T, K, generator=gen).to(dev, dt)
                err, ratio, plan = k3_case(leaf, x, q, s, w_abs)
                worst = max(worst, err)
                if dt == torch.bfloat16 and T in (1, 64):
                    ms = cuda_ms(lambda: k3.q8_matmul(x, q, s))
                    plain = cuda_ms(lambda: k3.q8_matmul_plain(x, q, s))
                    dense = cuda_ms(lambda: x @ w_bf16)
                    lb = k3_bound(T, K, N)
                    rows[(leaf, T)] = (ms, plain, dense, lb["bound_ms"])
                    timing = (f" kernel={ms:.4f}ms plain={plain:.4f}ms dense_bf16={dense:.4f}ms "
                              f"bound={lb['bound_ms']:.5f}ms ({lb['bound_by']})")
                else:
                    timing = ""
                log(f"[k3] {leaf} K={K} N={N} T={T} x={str(dt)[6:]} launch={tuple(plan)}: "
                    f"max_abs_err={err:.3e} err/bound<={ratio:.3e}"
                    f" bit-stable{timing}")
        del q, s, w_bf16, w_abs
    _, K, N = k3_shapes()[-1]
    ms, plain, dense, _ = rows[("output", 1)]
    gbs = (K * N + K // k3.QBLOCK * N * 4) / (ms * 1e-3) / 1e9
    log(f"[k3] head T=1 streams {gbs:.1f} GB/s of int8 + scales")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, **k3_bound(1, K, N),
            "library_ms": dense, "at": f"head T=1 K={K} N={N}; library = dense bf16 cuBLAS GEMV",
            # per leaf: [kernel, plain, dense bf16 cuBLAS, bound] ms
            "by_leaf_ms": {f"{leaf} T={T}": [round(t, 5) for t in r]
                           for (leaf, T), r in rows.items()}}


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance between two bf16 tensors in units in the last
    place (adjacent bf16 values are 1 apart, across zero too)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(got) - ordered(want)).abs().max())


def check_fused(dev, gen) -> dict:
    """K7-K9 (``ops/cuda/llm_fused.py``) against their plain versions at the
    served decode step's shapes (FUSED_SHAPE) and B = 1, 2, 4, 8, within
    FUSED_ULPS: K9 and K8 bit-equal (K8's q, k, v and the cache it leaves),
    K7 within 1 bf16 ulp; each timed at every B beside its plain version and its bound
    (bytes: each input read once, each output written once)."""
    bf = torch.bfloat16
    D, H, KVH, HD, S, Fd = (FUSED_SHAPE[k] for k in ("D", "H", "KVH", "HD", "S", "F"))
    N = (H + 2 * KVH) * HD
    inv = llm_fused.rope_inv_freq(HD, 10000.0, dev)
    rows, worst = {}, {"add_rms_norm": 0, "qkv_rope_cache": 0, "silu_mul": 0}
    for B in (1, 2, 4, 8):
        x = (torch.randn(B, 1, D, generator=gen) * 2).to(dev, bf)
        delta = torch.randn(B, 1, D, generator=gen).to(dev, bf)
        w = (1 + torch.randn(D, generator=gen) * 0.05).to(bf).float().to(dev)
        for d in (delta, None):
            xk, xp = x.clone(), x.clone()
            got = llm_fused.add_rms_norm(xk, d, w, 1e-6)
            want = llm_fused.add_rms_norm_plain(xp, d, w, 1e-6)
            torch.cuda.synchronize()
            if not torch.equal(xk, xp):
                raise AssertionError(f"K7 B={B}: the residual x + delta differs from the plain's")
            worst["add_rms_norm"] = max(worst["add_rms_norm"], bf16_ulps(got, want))
        # the QKV product's rows; lanes at 0, mid, S - 1 and S (no row written)
        qkv = (torch.randn(B, 1, N, generator=gen) * 2).to(dev, bf)
        bias = (torch.randn(N, generator=gen) * 0.05).to(dev, bf)
        pos = torch.tensor([0, 700, S - 1, S, 13, 511, 1000, 64][:B], dtype=torch.int32,
                           device=dev)
        ck, cv = (torch.randn(B, S, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
        for b_ in (bias, None):
            for neox in (True, False):
                kk, kv_, pk, pv = ck.clone(), cv.clone(), ck.clone(), cv.clone()
                got = llm_fused.qkv_rope_cache(qkv, b_, inv, pos, kk, kv_, H, neox)
                want = llm_fused.qkv_rope_cache_plain(qkv, b_, inv, pos, pk, pv, H, neox)
                torch.cuda.synchronize()
                ulps = max([bf16_ulps(a, b) for a, b in zip(got, want)]
                           + [bf16_ulps(kk, pk), bf16_ulps(kv_, pv)])
                worst["qkv_rope_cache"] = max(worst["qkv_rope_cache"], ulps)
        gu = (torch.randn(B, 1, 2 * Fd, generator=gen) * 3).to(dev, bf)
        got = llm_fused.silu_mul(gu, Fd)
        want = llm_fused.silu_mul_plain(gu, Fd)
        torch.cuda.synchronize()
        worst["silu_mul"] = max(worst["silu_mul"], bf16_ulps(got, want))

        kk, kvv = ck.clone(), cv.clone()
        times = {
            "add_rms_norm": (lambda: llm_fused.add_rms_norm(x, delta, w, 1e-6),
                             lambda: llm_fused.add_rms_norm_plain(x, delta, w, 1e-6),
                             2 * 4 * B * D + 4 * D),
            "qkv_rope_cache": (lambda: llm_fused.qkv_rope_cache(qkv, bias, inv, pos, kk, kvv, H,
                                                                True),
                               lambda: llm_fused.qkv_rope_cache_plain(qkv, bias, inv, pos, kk, kvv,
                                                                      H, True),
                               2 * (B * N + N + B * H * HD + 4 * B * KVH * HD) + 4 * (HD // 2 + B)),
            "silu_mul": (lambda: llm_fused.silu_mul(gu, Fd),
                         lambda: llm_fused.silu_mul_plain(gu, Fd), 2 * 3 * B * Fd)}
        for name, (kern, plain, nbytes) in times.items():
            ms, pms = cuda_ms(kern), cuda_ms(plain)
            rows[f"{name} B={B}"] = {"ms": ms, "plain_ms": pms,
                                     **least_time(nbytes, 0, BF16_FLOP_S)}
    for key, r in rows.items():
        log(f"[fused] {key}: kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms "
            f"bound={r['bound_ms']:.6f}ms ({r['bound_by']})")
    for name, n in worst.items():
        log(f"[fused] {name}: largest distance from the plain version {n} bf16 ulp "
            f"(limit {FUSED_ULPS[name]}) at D={D} H={H} KVH={KVH} HD={HD} S={S} F={Fd}, "
            "B = 1, 2, 4, 8")
    for name, n in worst.items():
        if n > FUSED_ULPS[name]:
            raise AssertionError(f"{name}: {n} bf16 ulp from its plain version "
                                 f"(limit {FUSED_ULPS[name]})")
    out = {}
    for name in worst:
        r = rows[f"{name} B=1"]
        out[name] = {"max_bf16_ulps": worst[name], **r, "library_ms": None,
                     "at": f"B=1 D={D} H={H} KVH={KVH} HD={HD} S={S} F={Fd}",
                     "by_B_ms": {k.split(" ")[1]: [round(v["ms"], 5), round(v["plain_ms"], 5)]
                                 for k, v in rows.items() if k.startswith(name)}}
    return out


def gemv_timing(kern, plain, library, leaves: list, nbytes: float) -> dict:
    """A K11 kernel's mean device time over back-to-back launches, each on
    the next of ``leaves`` (distinct copies of its weight, past the L2), beside
    its plain version, the library's same product and the byte bound."""
    it = iter(range(1 << 30))

    def cycle(fn):
        return lambda: fn(leaves[next(it) % len(leaves)])
    return {"ms": cuda_ms(cycle(kern)), "plain_ms": cuda_ms(cycle(plain)),
            "library_ms": cuda_ms(cycle(library)), **least_time(nbytes, 0, BF16_FLOP_S)}


def product_within(got: torch.Tensor, want: torch.Tensor, absum: torch.Tensor, K: int,
                   ulps: int) -> bool:
    """|got - want| <= ``ulps`` bf16 ulps of the larger plus 2 K 2^-23 absum
    (absum = sum_k |x_k w_k| of each output): two f32 sums of K terms taken
    in other orders, each rounded once to bf16."""
    g, w_ = got.float(), want.float()
    mag = torch.maximum(g.abs(), w_.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return bool(((g - w_).abs() <= ulps * ulp + 2 * K * 2.0 ** -23 * absum).all())


def check_gemv(dev, gen) -> dict:
    """K11 (``ops/cuda/llm_gemv.py``) at the served decode step's shapes
    (FUSED_SHAPE, V 151 759) and B = 1, 2, 4, 8. Each layer kernel's product
    (``prod``) within FUSED_ULPS of cuBLAS's same product plus the f32 sums'
    error (``product_within``; the largest ulps printed), and each output
    and cache row bit-equal to the plain epilogue on that product (norm_qkv
    with and without bias, NEOX and adjacent pairs, pos at 0, mid, S - 1 and
    S; gemv_residual at wo's and down's shapes); the distance from the whole
    plain chain is printed. norm_head's logits within K 2^-23 sum |x w| of
    the plain version's. Each timed beside its plain version, cuBLAS's
    product (``library_ms``, never called by the port) and its byte bound."""
    bf = torch.bfloat16
    D, H, KVH, HD, S, Fd = (FUSED_SHAPE[k] for k in ("D", "H", "KVH", "HD", "S", "F"))
    N, V, eps = (H + 2 * KVH) * HD, SAMPLER_V, 1e-6
    inv = llm_fused.rope_inv_freq(HD, 10000.0, dev)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf)

    nw = (1 + torch.randn(D, generator=gen) * 0.05).to(bf).float().to(dev)
    leaves = {"wqkv": rnd(D, N, scale=0.05), "wo": rnd(H * HD, D, scale=0.05),
              "w_gateup": rnd(D, 2 * Fd, scale=0.05), "w_down": rnd(Fd, D, scale=0.05)}
    bias = rnd(N, scale=0.05)
    head = rnd(V, D, scale=0.05)
    worst = {"norm_qkv": 0, "gemv_residual": 0, "norm_gateup": 0}
    chain = dict(worst)
    within = {name: True for name in worst}
    head_err = 0.0
    rows = {}
    for B in (1, 2, 4, 8):
        x = rnd(B, 1, D)
        h = llm_fused.rms_norm(x, nw, eps)
        pos = torch.tensor([0, 700, S - 1, S, 13, 511, 1000, 64][:B], dtype=torch.int32,
                           device=dev)
        ck, cv = rnd(B, S, KVH, HD), rnd(B, S, KVH, HD)
        for b_ in (bias, None):
            for neox in (True, False):
                prod = torch.empty((B, N), dtype=bf, device=dev)
                kk, kv_ = ck.clone(), cv.clone()
                got = llm_gemv.norm_qkv(x, nw, eps, leaves["wqkv"], b_, inv, pos, kk, kv_, H,
                                        neox, prod=prod)
                ok_, ov_ = ck.clone(), cv.clone()
                own = llm_fused.qkv_rope_cache_plain(prod.view(B, 1, N), b_, inv, pos, ok_, ov_,
                                                     H, neox)
                pk, pv = ck.clone(), cv.clone()
                want = llm_gemv.norm_qkv_plain(x, nw, eps, leaves["wqkv"], b_, inv, pos, pk, pv,
                                               H, neox)
                torch.cuda.synchronize()
                if not (all(torch.equal(a, o) for a, o in zip(got, own))
                        and torch.equal(kk, ok_) and torch.equal(kv_, ov_)):
                    raise AssertionError(f"norm_qkv B={B} bias={b_ is not None} neox={neox}: "
                                         "the epilogue differs from the plain one on its product")
                want_prod = (h @ leaves["wqkv"]).view(B, N)
                worst["norm_qkv"] = max(worst["norm_qkv"], bf16_ulps(prod, want_prod))
                within["norm_qkv"] &= product_within(
                    prod, want_prod, (h.abs().float() @ leaves["wqkv"].abs().float()).view(B, N),
                    D, FUSED_ULPS["norm_qkv"])
                chain["norm_qkv"] = max([chain["norm_qkv"], bf16_ulps(kk, pk), bf16_ulps(kv_, pv)]
                                        + [bf16_ulps(a, b) for a, b in zip(got, want)])
        for leaf, K in (("wo", H * HD), ("w_down", Fd)):
            act = rnd(B, 1, K)
            prod = torch.empty((B, D), dtype=bf, device=dev)
            xk = x.clone()
            llm_gemv.gemv_residual(act, leaves[leaf], xk, prod=prod)
            own, want = x.clone(), x.clone()
            own.copy_(own + prod.view(B, 1, D))
            llm_gemv.gemv_residual_plain(act, leaves[leaf], want)
            torch.cuda.synchronize()
            if not torch.equal(xk, own):
                raise AssertionError(f"gemv_residual ({leaf}) B={B}: the residual add differs "
                                     "from the plain one on its product")
            want_prod = (act @ leaves[leaf]).view(B, D)
            worst["gemv_residual"] = max(worst["gemv_residual"], bf16_ulps(prod, want_prod))
            within["gemv_residual"] &= product_within(
                prod, want_prod, (act.abs().float() @ leaves[leaf].abs().float()).view(B, D), K,
                FUSED_ULPS["gemv_residual"])
            chain["gemv_residual"] = max(chain["gemv_residual"], bf16_ulps(xk, want))
        prod = torch.empty((B, 2 * Fd), dtype=bf, device=dev)
        got = llm_gemv.norm_gateup(x, nw, eps, leaves["w_gateup"], Fd, prod=prod)
        own = llm_fused.silu_mul_plain(prod.view(B, 1, 2 * Fd), Fd)
        want = llm_gemv.norm_gateup_plain(x, nw, eps, leaves["w_gateup"], Fd)
        torch.cuda.synchronize()
        if not torch.equal(got, own):
            raise AssertionError(f"norm_gateup B={B}: silu(gate) * up differs from the plain one "
                                 "on its product")
        want_prod = (h @ leaves["w_gateup"]).view(B, 2 * Fd)
        worst["norm_gateup"] = max(worst["norm_gateup"], bf16_ulps(prod, want_prod))
        within["norm_gateup"] &= product_within(
            prod, want_prod,
            (h.abs().float() @ leaves["w_gateup"].abs().float()).view(B, 2 * Fd), D,
            FUSED_ULPS["norm_gateup"])
        chain["norm_gateup"] = max(chain["norm_gateup"], bf16_ulps(got, want))
        got = llm_gemv.norm_head(x, nw, eps, head)
        want = llm_gemv.norm_head_plain(x, nw, eps, head)
        absum = h.view(B, D).float().abs() @ head.float().abs().t()
        torch.cuda.synchronize()
        head_err = max(head_err, float(((got - want).abs() / (D * 2.0 ** -23 * absum)).max()))

        # times: every launch on another copy of the weight, past the L2
        att, act = rnd(B, 1, H * HD), rnd(B, 1, Fd)
        xs = x.clone()

        def copies(t):
            n = max(2, -(-GEMV_COPIES_BYTES // (t.numel() * t.element_size())))
            return [t] + [t.clone() for _ in range(n - 1)]

        kk, kv_ = ck.clone(), cv.clone()
        cases = {
            "norm_qkv": (copies(leaves["wqkv"]),
                         lambda w: llm_gemv.norm_qkv(x, nw, eps, w, bias, inv, pos, kk, kv_, H,
                                                     True),
                         lambda w: llm_gemv.norm_qkv_plain(x, nw, eps, w, bias, inv, pos, kk, kv_,
                                                           H, True),
                         lambda w: h @ w, 2 * (D * N + B * D + N + B * H * HD + 4 * B * KVH * HD)),
            "gemv_residual wo": (copies(leaves["wo"]),
                                 lambda w: llm_gemv.gemv_residual(att, w, xs),
                                 lambda w: llm_gemv.gemv_residual_plain(att, w, xs),
                                 lambda w: att @ w, 2 * (H * HD * D + B * H * HD + 2 * B * D)),
            "gemv_residual down": (copies(leaves["w_down"]),
                                   lambda w: llm_gemv.gemv_residual(act, w, xs),
                                   lambda w: llm_gemv.gemv_residual_plain(act, w, xs),
                                   lambda w: act @ w, 2 * (Fd * D + B * Fd + 2 * B * D)),
            "norm_gateup": (copies(leaves["w_gateup"]),
                            lambda w: llm_gemv.norm_gateup(x, nw, eps, w, Fd),
                            lambda w: llm_gemv.norm_gateup_plain(x, nw, eps, w, Fd),
                            lambda w: h @ w, 2 * (D * 2 * Fd + B * D + B * Fd)),
            "norm_head": ([head],  # 233 MB: past the L2 as it is
                          lambda w: llm_gemv.norm_head(x, nw, eps, w),
                          lambda w: llm_gemv.norm_head_plain(x, nw, eps, w),
                          lambda w: torch.mm(h.view(B, D), w.t(), out_dtype=torch.float32),
                          2 * (V * D + B * D) + 4 * B * V)}
        for name, (ws, kern, plain, library, nbytes) in cases.items():
            rows[f"{name} B={B}"] = gemv_timing(kern, plain, library, ws, nbytes)
            del ws
        torch.cuda.empty_cache()
    for key, r in rows.items():
        log(f"[gemv] {key}: kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms "
            f"library={r['library_ms']:.4f}ms bound={r['bound_ms']:.5f}ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound")
    for name, n in worst.items():
        log(f"[gemv] {name}: product {n} bf16 ulp from cuBLAS's, within {FUSED_ULPS[name]} ulp "
            f"+ 2 K 2^-23 sum |x w|: {within[name]}; epilogue bit-equal to the plain one on it; "
            f"the whole plain chain's outputs {chain[name]} ulp away, B = 1, 2, 4, 8")
    log(f"[gemv] norm_head: largest |kernel - plain| {head_err:.3f} of K 2^-23 sum |x w| "
        f"(limit 1) at V={V} D={D}, B = 1, 2, 4, 8")
    for name, ok in within.items():
        if not ok:
            raise AssertionError(f"{name}: its product ({worst[name]} bf16 ulp) beyond "
                                 f"{FUSED_ULPS[name]} ulp + 2 K 2^-23 sum |x w| of cuBLAS's")
    if head_err > 1:
        raise AssertionError(f"norm_head: {head_err:.3f} of its limit from the plain version")
    out = {}
    for name in ("norm_qkv", "gemv_residual", "norm_gateup", "norm_head"):
        key = "gemv_residual down" if name == "gemv_residual" else name
        r = rows[f"{key} B=1"]
        out[name] = {**({"max_bf16_ulps": worst[name], "chain_bf16_ulps": chain[name]}
                        if name in worst else {"max_err_of_limit": head_err}), **r,
                     "at": f"B=1 D={D} H={H} KVH={KVH} HD={HD} S={S} F={Fd} V={V}",
                     # [kernel, plain, cuBLAS's product, bound] ms
                     "by_B_ms": {k[len(name) + 1:]: [round(v[f], 5) for f in
                                                     ("ms", "plain_ms", "library_ms", "bound_ms")]
                                 for k, v in rows.items() if k.startswith(name)}}
    return out


# the request paths that decode on the card and so must launch K7-K9 or K11
FUSED_PATHS = ("bf16", "quant", "mel", "wave441", "stream", "clone", "server", "mesh")
# the paths whose every decode step is a dense bf16 LLM's on one card: K11
# alone, K7-K9 never (the server path also runs a q8_0 server; its dense
# server's requests are held to K11 alone by ``served_fused``)
GEMV_PATHS = ("bf16", "mel", "wave441", "clone")
# the paths with a server of the LLM, whose batcher's chunks launch K10 once
# a step beside the CLI's single-lane requests, which keep the plain sampler
SERVED_PATHS = ("load", "clone", "server", "mesh")


def check_fused_ratio(what: str, grew: dict, required: bool, served_only: bool = False) -> None:
    """A decode step launches K7, K8 and K9 as 25 : 12 : 12 (LLM_WIDTHS' 12
    layers: two norms a layer and the output norm; one q/k/v and one MLP a
    layer), or, on K11 (a dense bf16 LLM on one card), norm_qkv,
    gemv_residual and norm_gateup as 12 : 24 : 12 and norm_head once (K7
    once instead where the head is quantized); ``required``: at least one
    step. A GEMV_PATHS path runs K11 alone; the mesh path (tp groups, int8)
    K7-K9 alone, mixing tp = 2 groups, whose every rank launches K8 and K9
    (25 : 24 : 24), with mesh-less servers: there K8 and K9 only must match.
    K10 runs once a served step (a tp group's lead alone): 1 : 12 against K8
    and norm_qkv where only the batcher decoded (``served_only``), at most
    that on a path with a server (at least once where ``required``), never
    on a path of CLI requests alone."""
    n7, n8, n9, n10 = (grew[k] for k in FUSED)
    q, res, gu, hd = (grew[k] for k in GEMV)
    layers = LLM_WIDTHS["n_layers"]
    ratio = what == "mesh" or n7 * layers == n8 * (2 * layers + 1) + q - hd * layers
    if (required and n8 + q == 0) or n8 != n9 or not ratio:
        raise AssertionError(f"[{what}] K7/K8/K9 launched {n7}/{n8}/{n9} beside K11's "
                             f"{q}/{res}/{gu}/{hd}: not 25:12:12 a step" +
                             (" or none" if required else ""))
    if gu != q or res != 2 * q or q % layers or hd * layers > q:
        raise AssertionError(f"[{what}] K11 launched {q}/{res}/{gu}/{hd}: not 12:24:12:1 a step")
    if what in GEMV_PATHS and (n7 or n8 or hd * layers != q):
        raise AssertionError(f"[{what}] a dense bf16 path on one card launched K7/K8/K9 "
                             f"{n7}/{n8}/{n9} and K11 {q}/{res}/{gu}/{hd}: not K11 alone")
    if what == "mesh" and q:
        raise AssertionError(f"[mesh] K11 launched {q} times: the tp and int8 routes keep K7-K9")
    if served_only:
        k10 = n10 > 0 and n10 * layers == n8 + q
    elif what in SERVED_PATHS:
        k10 = (n10 > 0 or not required) and n10 * layers <= n8 + q
    else:
        k10 = n10 == 0
    if not k10:
        raise AssertionError(f"[{what}] K10 launched {n10} times beside K8's {n8} and "
                             f"norm_qkv's {q}: not once a served step"
                             + (" alone" if served_only else ""))


def sampler_penalized(logits, ring, pen):
    """``sample_token_batched``'s penalised logits."""
    B, V = logits.shape
    presence = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    presence.scatter_(1, torch.where(ring >= 0, ring, torch.full_like(ring, V)), True)
    penalized = torch.where(logits > 0, logits / pen[:, None], logits * pen[:, None])
    return torch.where(presence[:, :V] & (pen[:, None] != 1.0), penalized, logits)


def sampler_inputs(dev, gen, B: int, V: int, knobs: list, rnd: int, untied: bool = True) -> dict:
    """One step's inputs for K10 and its plain version: logits (randn x 3,
    drawn again until no lane's 257 highest penalised values tie, where
    ``untied``), rings empty, part filled from the lane's top 300 or
    holding duplicates of 5 of its top 10, some lanes already done, keys at
    random draws, counts 0-4 and one lane's budget reached on this step."""
    K = min(sampling.MAX_TOP_K, V)
    temp, top_k, top_p, pen = (torch.tensor([kn[i] for kn in knobs], dtype=dt)
                               for i, dt in enumerate((torch.float32, torch.int32, torch.float32,
                                                       torch.float32)))
    for _ in range(20):
        logits = torch.randn(B, V, generator=gen) * 3
        top = torch.topk(logits, min(300, V), dim=-1).indices
        ring = torch.full((B, sampling.PENALTY_LAST_N), -1, dtype=torch.int64)
        for b in range(B):
            kind = (rnd + b) % 3
            if kind == 1:
                pick = torch.randint(0, top.shape[1], (20,), generator=gen)
                ring[b, :20] = top[b, pick]
                ring[b, 20:40] = torch.randint(0, V, (20,), generator=gen)
            elif kind == 2:
                five = top[b, torch.randperm(min(10, V), generator=gen)[:5]]
                ring[b] = five[torch.randint(0, 5, (sampling.PENALTY_LAST_N,), generator=gen)]
        vals = torch.topk(sampler_penalized(logits, ring, pen), min(K + 1, V), dim=-1).values
        if not untied or bool((vals[:, 1:] != vals[:, :-1]).all()):
            break
    else:
        raise AssertionError("sampler inputs: no untied logits in 20 draws")
    done = torch.tensor([(rnd + b) % 5 == 4 for b in range(B)])
    count = torch.randint(0, 5, (B,), generator=gen, dtype=torch.int32)
    rem = torch.full((B,), 1 << 30, dtype=torch.int32)
    rem[(rnd + 1) % B] = count[(rnd + 1) % B] + 1
    key = torch.stack([torch.randint(0, 2**32, (B,), generator=gen, dtype=torch.int64),
                       torch.randint(0, 10_000, (B,), generator=gen, dtype=torch.int64)], dim=1)
    t = {"logits": logits, "ring": ring, "idx": torch.tensor(rnd * 37 % 1000, dtype=torch.int32),
         "key": key, "done": done, "count": count, "rem": rem}
    t = {k: v.to(dev) for k, v in t.items()}
    t["params"] = sampling.BatchSamplerParams(*(x.to(dev) for x in (temp, top_k, top_p, pen)))
    t["eog"] = torch.tensor([V + 3], dtype=torch.int64, device=dev)
    return t


def sampler_run(fn, t: dict) -> dict:
    """One call of ``fn`` (K10 or the plain version) on copies of ``t``."""
    B = t["logits"].shape[0]
    st = sampling.SamplerState(t["ring"].clone(), t["idx"].clone())
    key, done, count = t["key"].clone(), t["done"].clone(), t["count"].clone()
    out = torch.full((B, 3), -5, dtype=torch.int64, device=t["logits"].device)
    tok, adv = fn(t["logits"], t["params"], st, key, t["eog"], t["rem"], done, count, out[:, 1])
    torch.cuda.synchronize()
    return {"tok": tok, "adv": adv, "ring": st.ring, "key": key, "done": done, "count": count,
            "out": out, "idx": st.idx}


def sampler_excused(t: dict, b: int) -> bool:
    """Whether lane b's top-p mask may differ: one of its kept candidates'
    cum - prob lies within SAMPLER_ULPS f32 ulps of top_p."""
    p = t["params"]
    K = min(sampling.MAX_TOP_K, t["logits"].shape[1])
    vals = torch.topk(sampler_penalized(t["logits"][b:b + 1], t["ring"][b:b + 1],
                                        p.repeat_penalty[b:b + 1]), K, dim=-1).values[0]
    k = int(p.top_k[b]) if int(p.top_k[b]) > 0 else K
    vals[min(k, K):] = float("-inf")
    probs = torch.softmax(vals, dim=-1)
    edge = torch.cumsum(probs, dim=-1) - probs
    tp = float(p.top_p[b])
    ulp = float(np.spacing(np.float32(tp)))
    return bool(((edge - tp).abs() <= SAMPLER_ULPS * ulp).any())


def sampler_compare(t: dict, what: str) -> tuple[int, int]:
    """K10 against the plain version on ``t``: every lane equal, but a
    sampled top-p lane that ``sampler_excused`` excuses. Returns (top-p
    sampled lanes, excused lanes that differed)."""
    got = sampler_run(llm_fused.sample_step, t)
    want = sampler_run(sampling.sample_step_plain, t)
    if not torch.equal(got["idx"], want["idx"]):
        raise AssertionError(f"[sampler] {what}: cursor {int(got['idx'])}, plain "
                             f"{int(want['idx'])}")
    p = t["params"]
    top_p_lanes, excused = 0, 0
    for b in range(t["logits"].shape[0]):
        top_p_on = float(p.temp[b]) > 0 and 0 < float(p.top_p[b]) < 1
        top_p_lanes += top_p_on
        same = all(torch.equal(got[k][b], want[k][b])
                   for k in ("tok", "adv", "ring", "key", "done", "count", "out"))
        if same:
            continue
        if top_p_on and sampler_excused(t, b):
            excused += 1
            continue
        raise AssertionError(
            f"[sampler] {what} lane {b} (temp {float(p.temp[b])}, top_k {int(p.top_k[b])}, "
            f"top_p {float(p.top_p[b])}, penalty {float(p.repeat_penalty[b])}): K10 token "
            f"{int(got['tok'][b])}, plain {int(want['tok'][b])}; "
            + ", ".join(f"{k} {got[k][b].tolist()} vs {want[k][b].tolist()}"
                        for k in ("adv", "key", "done", "count", "out")))
    return top_p_lanes, excused


def check_sampler(dev, gen) -> dict:
    """K10 (``llm_fused.sample_step``) against ``sampling.sample_step_plain``
    at B = 1, 2, 4 and 8 lanes of the 0.1B LLM's vocabulary: SAMPLER_PASSES
    passes over SAMPLER_GRID (temp 0 / 0.8, top_k 1 / 50 / 256 / 0 / 300,
    top_p 1 / 0.9, penalty 1 / 1.3), rings empty, part filled and holding
    duplicates, lanes already done, an EOG (lane 0's token) and a budget
    reached on the step: tokens, output column, pos advance, ring, cursor,
    key, done and count equal, but sampled top-p lanes excused within
    SAMPLER_ULPS of top_p (at most SAMPLER_EXCUSED_MAX of them). Also V =
    100 (a pool of V), V = 200 003 (32 slices) and all-equal logits (ties
    to the lower index). Times K10 at each B beside the plain version and
    its bound (the logits read once)."""
    rows, top_p_lanes, excused, calls = {}, 0, 0, 0
    n = len(SAMPLER_GRID)
    for B in (1, 2, 4, 8):
        rounds = SAMPLER_PASSES * -(-n // B)
        for rnd in range(rounds):
            knobs = [SAMPLER_GRID[(rnd * B + b) % n] for b in range(B)]
            t = sampler_inputs(dev, gen, B, SAMPLER_V, knobs, rnd)
            # lane 0's own token is the EOG: its done flag flips on this step
            t["eog"] = torch.cat([sampler_run(sampling.sample_step_plain, t)["tok"][:1],
                                  t["eog"]])
            a, e = sampler_compare(t, f"B={B} V={SAMPLER_V} round {rnd}")
            top_p_lanes, excused, calls = top_p_lanes + a, excused + e, calls + 1
        # timed on the served cell's knobs (temp 0.8, top_k 50), in place
        t = sampler_inputs(dev, gen, B, SAMPLER_V, [(0.8, 50, 1.0, 1.0)] * B, 0)
        times = {}
        for name, fn in (("ms", llm_fused.sample_step), ("plain_ms", sampling.sample_step_plain)):
            st = sampling.SamplerState(t["ring"].clone(), t["idx"].clone())
            key, done, count = t["key"].clone(), t["done"].clone(), t["count"].clone()
            out = torch.zeros((B, 2), dtype=torch.int64, device=dev)
            with uncounted():
                times[name] = cuda_ms(lambda: fn(t["logits"], t["params"], st, key, t["eog"],
                                                 t["rem"], done, count, out[:, 1]))
        rows[f"B={B}"] = {**times, **least_time(4 * B * SAMPLER_V, 0, F32_FLOP_S)}
    for B, V in ((4, 100), (2, 200_003)):
        for rnd in range(-(-n // B)):
            knobs = [SAMPLER_GRID[(rnd * B + b) % n] for b in range(B)]
            a, e = sampler_compare(sampler_inputs(dev, gen, B, V, knobs, rnd),
                                   f"B={B} V={V} round {rnd}")
            top_p_lanes, excused, calls = top_p_lanes + a, excused + e, calls + 1
    # all-equal logits (a free lane's zeros): greedy takes index 0, a draw
    # one of the first K
    t = sampler_inputs(dev, gen, 2, SAMPLER_V, [(0.0, 50, 1.0, 1.0), (0.8, 0, 0.9, 1.3)], 0,
                       untied=False)
    t["logits"].zero_()
    tied = sampler_run(llm_fused.sample_step, t)
    if int(tied["tok"][0]) != 0 or not 0 <= int(tied["tok"][1]) < sampling.MAX_TOP_K:
        raise AssertionError(f"[sampler] all-equal logits: K10 tokens {tied['tok'].tolist()}")
    share = excused / max(top_p_lanes, 1)
    for key, r in rows.items():
        log(f"[sampler] sample_step {key} V={SAMPLER_V}: kernel={r['ms']:.4f}ms "
            f"plain={r['plain_ms']:.4f}ms bound={r['bound_ms']:.6f}ms ({r['bound_by']})")
    log(f"[sampler] K10 equal to the plain version on {calls} steps (B = 1, 2, 4, 8 at V = "
        f"{SAMPLER_V}, B = 4 at V = 100, B = 2 at V = 200 003): every greedy and top-p-off lane "
        f"bit for bit; {excused} of {top_p_lanes} sampled top-p lanes excused within "
        f"{SAMPLER_ULPS} ulps of top_p (limit {SAMPLER_EXCUSED_MAX:.0%}); all-equal logits: "
        f"tokens {tied['tok'].tolist()}")
    if share > SAMPLER_EXCUSED_MAX:
        raise AssertionError(f"[sampler] {excused} of {top_p_lanes} top-p lanes excused: over "
                             f"{SAMPLER_EXCUSED_MAX:.0%}")
    r = rows["B=1"]
    return {"steps_checked": calls, "top_p_lanes": top_p_lanes, "excused": excused, **r,
            "library_ms": None, "at": f"B=1 V={SAMPLER_V}",
            "by_B_ms": {k: [round(v["ms"], 5), round(v["plain_ms"], 5)] for k, v in rows.items()}}


def voc_inputs(dev, gen, B: int, T: int, lens: list[int]):
    """x [B, T, 128] (scale 0.4) zero at t >= length, and lengths, on the card."""
    L = torch.tensor(lens, dtype=torch.int32)
    x = torch.randn(B, T, VOCODER_CH, generator=gen) * 0.4
    x = x * (torch.arange(T)[None, :, None] < L[:, None, None])
    return x.to(dev), L.to(dev)


def voc_act(dev, gen) -> dict:
    """One activation as the synthetic vocoder writes it: 12-tap Hann
    filters, alpha/beta ~ 0.1 randn."""
    f = torch.hann_window(14, periodic=False, dtype=torch.float64)[1:-1]
    f = (f / f.sum()).float()
    return {"alpha": (torch.randn(VOCODER_CH, generator=gen) * 0.1).to(dev),
            "beta": (torch.randn(VOCODER_CH, generator=gen) * 0.1).to(dev),
            "up_filter": f.to(dev), "down_filter": f.to(dev)}


def k4_case(x, L, lens, w, b, d: int, res) -> tuple[float, float]:
    """K4 against its plain version on one input: (max abs error, error
    over its sum-order bound); fails past the bound."""
    B, T, C = x.shape
    k = w.shape[-1]
    got = k4.conv1d_same(x, L, w, b, d, res)
    torch.cuda.synchronize()
    ref = k4.conv1d_same_plain(x, L, w, b, d, res)
    mag = k4.conv1d_same_plain(x.abs(), L, w.abs(), b.abs(), d, None if res is None else res.abs())
    tol = 2 * (k * C + 2) * 2.0 ** -24 * mag
    err = (got - ref).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"K4 B={B} T={T} k={k} d={d}: error {err.max().item()} "
                             f"exceeds its bound")
    ratio = (err / tol.clamp(min=1e-30)).max().item()
    log(f"[k4] B={B} T={T} C={C} k={k} d={d} lengths={lens} residual={res is not None}: "
        f"max_abs_err={err.max().item():.3e} err/bound<={ratio:.3e}")
    return err.max().item(), ratio


def k4_timing(x, L, lens, w, b, d: int, res) -> dict:
    """Kernel, plain and F.conv1d times of one K4 call, with its bound."""
    B, T, C = x.shape
    k = w.shape[-1]
    ms = cuda_ms(lambda: k4.conv1d_same(x, L, w, b, d, res))
    plain = cuda_ms(lambda: k4.conv1d_same_plain(x, L, w, b, d, res))
    xc = x.transpose(1, 2).contiguous()  # the library's [B, C, T] layout
    lib = cuda_ms(lambda: F.conv1d(xc, w, b, padding=d * (k - 1) // 2, dilation=d))
    n = sum(lens)
    ops = 2 * k * C * C * n
    nbytes = 4 * (n * C + k * C * C + C + B * T * C + (n * C if res is not None else 0))
    row = {"ms": ms, "plain_ms": plain, **least_time(nbytes, ops, F32_FLOP_S), "library_ms": lib}
    log(f"[k4] T={T} k={k} d={d} launch={k4.launch_shape(B, T, C)}: kernel={ms:.4f}ms "
        f"plain={plain:.4f}ms F.conv1d={lib:.4f}ms bound={row['bound_ms']:.4f}ms "
        f"({row['bound_by']}), {ops / (ms * 1e-3) / F32_FLOP_S:.1%} of the f32 peak")
    return row


def check_k4(dev, gen) -> dict:
    C, worst, worst_ratio, at, short = VOCODER_CH, 0.0, 0.0, {}, {}
    # the vocoder's shapes, then the short route's: stage 1 of a 40-code
    # request (640 rows), where every resblock conv is a K4 launch
    cases = [(shape, ((7, 1), (3, 1), (3, 3), (3, 5))) for shape in VOC_SHAPES]
    cases.append(((1, 640, [640]), ((3, 1), (3, 3), (3, 5))))
    for (B, T, lens), kds in cases:
        x, L = voc_inputs(dev, gen, B, T, lens)
        for k, d in kds:
            w = (torch.randn(C, C, k, generator=gen) * 0.05).to(dev)
            b = (torch.randn(C, generator=gen) * 0.02).to(dev)
            res = x if k == 3 else None  # conv2 of a resblock layer; the noise conv has none
            err, ratio = k4_case(x, L, lens, w, b, d, res)
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
            if (T, k, d) == (491520, 7, 1):  # the last stage's noise conv
                at = {**k4_timing(x, L, lens, w, b, d, res),
                      "at": f"B=1 T={T} (length {lens[0]}) C={C} k=7 d=1; "
                      f"library = F.conv1d on [1, {C}, {T}]"}
            elif (T, k, d) == (640, 3, 1):  # a short-route resblock conv
                short = {**k4_timing(x, L, lens, w, b, d, res),
                         "at": f"B=1 T={T} C={C} k=3 d=1 with residual; library = "
                         f"F.conv1d on [1, {C}, {T}], no residual"}
        del x
    return {"max_abs_err": worst, "err_over_bound": worst_ratio, **at, "short_route": short}


def check_k5(dev, gen) -> dict:
    C, worst, at, by_shape = VOCODER_CH, 0.0, {}, {}
    # the vocoder's shapes and the 40-code request's: stage 1 of the short
    # route (640 rows, 400 valid) and the post-activation (61 440 rows)
    for B, T, lens in (*VOC_SHAPES, (1, 640, [400]), (1, 61440, [38400])):
        x, L = voc_inputs(dev, gen, B, T, lens)
        a = voc_act(dev, gen)
        args = (x, L, a["up_filter"], a["alpha"], a["beta"], a["down_filter"])
        got = k5.activation1d(*args)
        torch.cuda.synchronize()
        ref = k5.activation1d_plain(*args)
        err = (got - ref).abs()
        if not bool((err <= K5_ATOL + K5_RTOL * ref.abs()).all()):
            raise AssertionError(f"K5 B={B} T={T}: error {err.max().item()} exceeds "
                                 f"{K5_ATOL} + {K5_RTOL} |ref|")
        worst = max(worst, err.max().item())
        ms = cuda_ms(lambda: k5.activation1d(*args))
        plain = cuda_ms(lambda: k5.activation1d_plain(*args))
        n, k1_, k2_ = sum(lens), a["up_filter"].shape[0], a["down_filter"].shape[0]
        # two 2x samples an output, each a k1/2-tap FMA FIR and a 12-op
        # snake (sin, cos, division one op each), then a k2-tap FMA FIR
        ops = (2 * (k1_ + 12) + 2 * k2_) * n * C
        nbytes = 4 * (n * C + B * T * C + k1_ + k2_ + 2 * C)
        lb = least_time(nbytes, ops, F32_FLOP_S)
        by_shape[f"B={B} T={T} lengths={lens}"] = [round(ms, 5), round(plain, 5),
                                                    round(lb["bound_ms"], 5)]
        log(f"[k5] B={B} T={T} C={C} taps 12/12 lengths={lens} "
            f"launch={tuple(k5.launch_shape(B, T, C))}: max_abs_err={err.max().item():.3e} "
            f"kernel={ms:.4f}ms plain={plain:.4f}ms bound={lb['bound_ms']:.5f}ms "
            f"({lb['bound_by']})")
        if T == 491520:
            at = {"ms": ms, "plain_ms": plain, **lb, "library_ms": None,
                  "at": f"B=1 T={T} (length {lens[0]}) C={C}"}
        del x
    # the generic-tap template (16/20 and 13/15 taps) at a ragged pair
    x, L = voc_inputs(dev, gen, 2, 2560, [2560, 1777])
    for k1_, k2_ in ((16, 20), (13, 15)):
        a = voc_act(dev, gen)
        a["up_filter"] = torch.hann_window(k1_ + 2, periodic=False, device=dev)[1:-1] / (k1_ / 2)
        a["down_filter"] = torch.hann_window(k2_ + 2, periodic=False, device=dev)[1:-1] / (k2_ / 2)
        args = (x, L, a["up_filter"], a["alpha"], a["beta"], a["down_filter"])
        got = k5.activation1d(*args)
        torch.cuda.synchronize()
        ref = k5.activation1d_plain(*args)
        err = (got - ref).abs()
        if not bool((err <= K5_ATOL + K5_RTOL * ref.abs()).all()):
            raise AssertionError(f"K5 taps {k1_}/{k2_}: error {err.max().item()} exceeds "
                                 f"{K5_ATOL} + {K5_RTOL} |ref|")
        worst = max(worst, err.max().item())
        log(f"[k5] B=2 T=2560 taps {k1_}/{k2_}: max_abs_err={err.max().item():.3e}")
    # per shape: [kernel, plain, bound] ms
    return {"max_abs_err": worst, **at, "by_shape_ms": by_shape}


def k6_bound(B: int, T: int, n: int) -> dict:
    """K6's least time over n valid rows of [B, T, 128]: two k=3 C x C convs
    and two activations (counted as in check_k5) at the f32 peak, or x in
    and y out with the weights once."""
    C = VOCODER_CH
    ops = 2 * (2 * 3 * C * C) * n + 2 * (2 * (12 + 12) + 2 * 12) * n * C
    nbytes = 4 * (n * C + B * T * C + 2 * (3 * C * C + C) + 4 * 12 + 4 * C)
    return least_time(nbytes, ops, F32_FLOP_S)


def check_k6(dev, gen) -> dict:
    C, worst, at = VOCODER_CH, 0.0, {}
    actA, actB = voc_act(dev, gen), voc_act(dev, gen)
    w1, w2 = ((torch.randn(C, C, 3, generator=gen) * 0.05).to(dev) for _ in range(2))
    b1, b2 = ((torch.randn(C, generator=gen) * 0.02).to(dev) for _ in range(2))
    for B, T, lens in VOC_SHAPES:
        x, L = voc_inputs(dev, gen, B, T, lens)
        for d in (1, 3, 5):
            args = (x, L, actA, w1, b1, d, actB, w2, b2)
            got = k6.resblock_layer(*args)
            torch.cuda.synchronize()
            err = (got - k6.resblock_layer_plain(*args)).abs().max().item()
            log(f"[k6] B={B} T={T} C={C} d={d} lengths={lens} "
                f"launch={tuple(k6.launch_shape(B, T, C, 3, d, 3))}: max_abs_err={err:.3e}")
            if not err <= K6_TOL:
                raise AssertionError(f"K6 error {err} > {K6_TOL} at B={B} T={T} d={d}")
            worst = max(worst, err)
            if T == 491520 and d == 5:
                ms = cuda_ms(lambda: k6.resblock_layer(*args))
                plain = cuda_ms(lambda: k6.resblock_layer_plain(*args))
                at = {"ms": ms, "plain_ms": plain, **k6_bound(B, T, sum(lens)),
                      "library_ms": None, "at": f"B=1 T={T} (length {lens[0]}) C={C} d=5"}
                log(f"[k6] T={T} d=5: kernel={ms:.4f}ms plain={plain:.4f}ms "
                    f"bound={at['bound_ms']:.4f}ms ({at['bound_by']})")
        if T != 491520:  # the padded-bucket invariant: bit-equal valid rows, zeros beyond
            y1 = k6.resblock_layer(x, L, actA, w1, b1, 3, actB, w2, b2)
            y2 = k6.resblock_layer(F.pad(x, (0, 0, 0, 480)), L, actA, w1, b1, 3, actB, w2, b2)
            if not (torch.equal(y2[:, :T], y1) and bool((y2[:, T:] == 0).all())):
                raise AssertionError(f"K6 B={B} T={T}: a bucket 480 rows longer changed the result")
            log(f"[k6] B={B} T={T} vs T={T + 480}: valid rows bit-equal, padding zero")
        del x
    # the kernel's other plans at a ragged pair: a k=11 conv (BigVGAN's
    # widest resblock kernel; the small tile) and 16/20-tap filters (the
    # generic activation template)
    x, L = voc_inputs(dev, gen, 2, 2560, [2560, 1777])
    wide = [(torch.randn(C, C, 11, generator=gen) * 0.02).to(dev) for _ in range(2)]
    f16 = voc_act(dev, gen)
    f16["up_filter"] = torch.hann_window(18, periodic=False, device=dev)[1:-1] / 8.0
    f16["down_filter"] = torch.hann_window(22, periodic=False, device=dev)[1:-1] / 10.0
    for name, args in (("k=11 d=5", (x, L, actA, wide[0], b1, 5, actB, wide[1], b2)),
                       ("taps 16/20 d=3", (x, L, f16, w1, b1, 3, f16, w2, b2))):
        got = k6.resblock_layer(*args)
        torch.cuda.synchronize()
        err = (got - k6.resblock_layer_plain(*args)).abs().max().item()
        k, taps = args[3].shape[-1], (args[2]["up_filter"].shape[0], args[2]["down_filter"].shape[0])
        log(f"[k6] B=2 T=2560 {name} launch={tuple(k6.launch_shape(2, 2560, C, k, args[5], k, taps, taps))}: "
            f"max_abs_err={err:.3e}")
        if not err <= K6_TOL:
            raise AssertionError(f"K6 error {err} > {K6_TOL} at {name}")
        worst = max(worst, err)
    del x
    # the five vocoder stages of a 400-code request (9 layers each), at d=5
    by_stage, req_ms, req_bound = {}, 0.0, 0.0
    for T, n in K6_STAGES:
        x, L = voc_inputs(dev, gen, 1, T, [n])
        args = (x, L, actA, w1, b1, 5, actB, w2, b2)
        ms = cuda_ms(lambda: k6.resblock_layer(*args), iters=10)
        lb = k6_bound(1, T, n)
        by_stage[f"T={T} length {n}"] = [round(ms, 5), round(lb["bound_ms"], 5)]
        req_ms, req_bound = req_ms + 9 * ms, req_bound + 9 * lb["bound_ms"]
        log(f"[k6] stage T={T} length {n} d=5 launch={tuple(k6.launch_shape(1, T, C, 3, 5, 3))}: "
            f"kernel={ms:.4f}ms bound={lb['bound_ms']:.4f}ms ({lb['bound_by']})")
        del x
    log(f"[k6] a 400-code request's 45 layers at d=5: {req_ms:.2f}ms against a {req_bound:.2f}ms "
        f"bound (loss {req_ms - req_bound:.2f}ms)")
    # per stage: [kernel, bound] ms
    return {"max_abs_err": worst, **at, "by_stage_ms": by_stage,
            "request_ms": req_ms, "request_bound_ms": req_bound}


def parse_wav(path: Path) -> tuple[int, np.ndarray]:
    data = path.read_bytes()
    riff, size, wave, fmt, _, pcm, ch, sr, _, _, bits, tag, n = struct.unpack_from(
        "<4sI4s4sIHHIIHH4sI", data)
    if (riff, wave, fmt, tag, pcm, ch, bits) != (b"RIFF", b"WAVE", b"fmt ", b"data", 1, 1, 16):
        raise AssertionError(f"{path}: not a mono 16-bit PCM WAV")
    if size != 36 + n or len(data) != 44 + n:
        raise AssertionError(f"{path}: RIFF sizes do not match the file")
    return sr, np.frombuffer(data[44:], "<i2")


class TrackedPipeline(MioTTSPipeline):
    """The CLI's pipeline, kept after its request so that its codec graphs
    can be read."""
    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        TrackedPipeline.last = self


def codec_counts() -> dict:
    return {k: getattr(codec_graph.codec, k) for k in CODEC_COUNTERS}


def check_codec_routes(name: str, pipe: MioTTSPipeline, c0: dict) -> dict:
    """The request's codec decodes followed the key policy: one eager decode
    a key (its first), a capture at its second, and every other decode a
    replay. Returns the codec graph counters of the request."""
    c = {k: v - c0[k] for k, v in codec_counts().items()}
    replays = {key: g.n_replays for key, g in pipe.graphs.items()}
    if (c["eager"] != len(pipe.seen) or c["captures"] != len(pipe.graphs)
            or c["replays"] != sum(replays.values()) or min(replays.values(), default=1) < 1
            or c["eager"] + c["replays"] != pipe.n_decodes):
        raise AssertionError(f"{name}: {pipe.n_decodes} codec decodes of {len(pipe.seen)} keys "
                             f"went {c}, replays by key {replays}")
    return c


def drive_cli(name: str, tmp: Path, argv: list[str], kernels) -> tuple[str, int, int, np.ndarray,
                                                                        dict, dict]:
    """One run of ``cli.main(argv)`` that also writes its WAV and its codes
    under ``tmp``. Every module in ``kernels`` must launch its kernel, and no
    other module may; its codec decodes follow the graph's key policy.
    Returns (stderr, n_codes, sample rate, pcm, launches by module, codec
    graph counters)."""
    wav, codes_out = tmp / f"{name}.wav", tmp / f"{name}.codes"
    before = {m: m.launches for m in MODS}
    g0, c0 = graph_counts(), codec_counts()
    err = io.StringIO()
    pipeline_mod.MioTTSPipeline = TrackedPipeline  # cli.main imports it at call time
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main([*argv, "-emb", str(tmp / "voice.emb.gguf"), "--tts-mio-codes-out",
                           str(codes_out), "-o", str(wav)])
    finally:
        pipeline_mod.MioTTSPipeline = MioTTSPipeline
    text = err.getvalue()
    if rc != 0:
        raise AssertionError(f"{name}: cli exited {rc}:\n{text}")
    check_graph_counts(name, text, g0)
    routes = check_codec_routes(name, TrackedPipeline.last, c0)
    sr, pcm = parse_wav(wav)
    if not np.any(pcm != 0):
        raise AssertionError(f"{name}: the WAV is silent")
    grew = {m: m.launches - b for m, b in before.items()}
    for m, g in grew.items():
        if (m in kernels) != (g > 0):
            raise AssertionError(f"{name}: {m.__name__} launches grew by {g}")
    return text, len(codes_out.read_text().split()), sr, pcm, grew, routes


def launch_text(grew: dict) -> str:
    return " ".join(f"{m.__name__.rsplit('.', 1)[-1]}={g}" for m, g in grew.items())


def graph_counts() -> dict:
    return {k: getattr(decode_graph, k) for k in GRAPH_COUNTERS}


def check_graph_counts(name: str, text: str, g0: dict) -> None:
    """A text request's tokens came from graph replays only: no eager step,
    ceil(tokens / CHUNK) replays, at least one capture."""
    tok = re.search(r"llm breakdown: \w+=[0-9.]+ms n_tokens=(\d+)", text)
    if tok:
        g = {k: v - g0[k] for k, v in graph_counts().items()}
        n_tok = int(tok.group(1))
        if g["eager_steps"] or g["replays"] != -(-n_tok // CHUNK) or g["captures"] < 1:
            raise AssertionError(f"{name}: {n_tok} tokens from {g} (no eager step and "
                                 f"ceil(tokens / {CHUNK}) replays expected)")


def graph_text(text: str) -> str:
    """The decode graph's part of a request's ``llm breakdown:`` line."""
    m = re.search(r"graph_captures=(\d+) capture=([0-9.]+)ms replays=(\d+)", text)
    return f"graph captures={m.group(1)} capture_ms={m.group(2)} replays={m.group(3)}"


def wav_samples(cfg, n_codes: int) -> int:
    """Samples of a full decode of ``n_codes`` codes: the iSTFT's count in
    wave mode, (frame_len - 1) * hop + n_fft - 2 n_pad with frame_len after
    the upsampler's stages if it has one; the vocoder's in mel mode."""
    frames = cfg.stft_frames(n_codes)
    if cfg.model_type == 1:
        return frames * math.prod(cfg.vocoder_upsample_rates)
    if cfg.wave_upsampler_factors:
        frames = cfg.decoder_frames(n_codes)
        for f, k in zip(cfg.wave_upsampler_factors, cfg.wave_upsampler_kernel_sizes):
            frames = (frames - 1) * f + k - 2 * max(0, (k - f) // 2)
    n_pad = (cfg.n_fft - cfg.hop_length) // 2
    return (frames - 1) * cfg.hop_length + cfg.n_fft - 2 * n_pad


def busy_ms(fn) -> float | None:
    """Device busy time of ``fn`` under torch.profiler: the union of its
    kernels' intervals (None when the profiler saw no kernel)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3 if spans else None


def chunk_run(cfg, w, prompt, sampler: SamplerParams, seed: int, ch, eager=False) -> dict:
    """GRAPH_TOKENS tokens from a fresh prefill of ``prompt`` into the
    buffers of the chunk ``ch`` (its ``no_eog`` holds no token: every chunk
    runs whole), as replays of its graph or, with ``eager``, as eager runs
    of its body (one chunk's buffers serve run after run, as they serve an
    engine's requests). Returns the tokens, the host wall time of the
    chunks, the final logits, the decode steps that ran (eager and
    replayed) and the K2/K3 launches and graph counters of the run."""
    dev = prompt.device
    lengths = torch.tensor([prompt.shape[1]], dtype=torch.int32, device=dev)
    ch.load(llm_start(cfg, w, prompt, lengths, ch.state.cache_k, ch.state.cache_v,
                      sampler_key(seed, dev)))
    torch.cuda.synchronize()
    g0, l0 = graph_counts(), (k2.launches, k3.launches)
    toks: list[int] = []
    t0 = time.perf_counter()
    while len(toks) < GRAPH_TOKENS:
        out, n_new = ch.run_eager() if eager else ch.run()
        o, n, _ = fetch_chunk_result(out, n_new, ch.state)
        toks.extend(int(t) for t in o[0, :int(n[0])])
    wall = (time.perf_counter() - t0) * 1e3
    g = {k: v - g0[k] for k, v in graph_counts().items()}
    return {"tokens": toks[:GRAPH_TOKENS], "wall_ms": wall, "logits": ch.state.logits.clone(),
            "steps": g["eager_steps"] + CHUNK * g["replays"], "k2": k2.launches - l0[0],
            "k3": k3.launches - l0[1], **g}


def capture(cfg, w, no_eog, sampler: SamplerParams, dev):
    """A chunk made on empty buffers, as an engine makes its own (captured
    on the card), with the launches its warm-up made and its counters."""
    g0, l0 = graph_counts(), (k2.launches, k3.launches)
    ch = chunk(cfg, w, no_eog, CHUNK, sampler, empty_gen_state(cfg, 1, GRAPH_CACHE, dev))
    if not ch.captured:
        raise AssertionError("a chunk on one card was not captured")
    return ch, {"k2": k2.launches - l0[0], "k3": k3.launches - l0[1],
                **{k: v - g0[k] for k, v in graph_counts().items()}}


def check_penalty_graph(cfg, w, prompt, no_eog, dev) -> dict:
    """A repeat penalty of 1.1 on the captured graph: greedy, the replayed
    tokens and final logits equal the eager body's bit for bit; sampled
    (temp 0.8, top-k 50, seed 5), the graph run's tokens equal the eager
    run's."""
    out = {}
    for name, sampler, seed in (("greedy", SamplerParams(temp=0.0, repeat_penalty=1.1), 0),
                                ("sampled", SamplerParams(temp=0.8, top_k=50,
                                                          repeat_penalty=1.1), 5)):
        graph, _ = capture(cfg, w, no_eog, sampler, dev)
        eager = chunk_run(cfg, w, prompt, sampler, seed, graph, eager=True)
        run = chunk_run(cfg, w, prompt, sampler, seed, graph)
        same_logits = bool(torch.equal(eager["logits"], run["logits"]))
        if eager["tokens"] != run["tokens"] or (name == "greedy" and not same_logits):
            n_same = next((i for i, (a, b) in enumerate(zip(eager["tokens"], run["tokens"]))
                           if a != b), GRAPH_TOKENS)
            raise AssertionError(f"graph, repeat penalty 1.1, {name}: the replay differs from "
                                 f"the eager body (tokens equal for {n_same}, final logits "
                                 f"equal: {same_logits})")
        out[name] = {"tokens": GRAPH_TOKENS, "logits_equal": same_logits}
        log(f"[graph bf16] repeat penalty 1.1, {name} (seed {seed}): {GRAPH_TOKENS} tokens of "
            f"the replayed graph equal the eager body's, final logits "
            f"{'bit-equal' if same_logits else 'differ'}")
        del graph
    return out


def check_graph(dev, tmp: Path) -> dict:
    """The chunk graph against the eager chunk body at full width, for each
    --llm-quant mode of GRAPH_MODES; see the module docstring."""
    greedy, sampled = SamplerParams(temp=0.0), SamplerParams(temp=0.8, top_k=50)
    no_eog = torch.tensor([-1], dtype=torch.int64, device=dev)
    rows = {}
    for mode, model in GRAPH_MODES:
        cfg, w, _ = load_llm_gguf(str(tmp / model), dev, torch.bfloat16, quantize=mode)
        prompt = torch.from_numpy(np.random.RandomState(7).randint(
            0, min(1000, cfg.vocab_size), (1, GRAPH_PROMPT))).to(dev)
        # K2 once a layer; K3 on every quantized leaf (four a layer) and the head
        k2_per_step = cfg.n_layers
        k3_per_step = {"q8_0": 4 * cfg.n_layers + 1, "output": 1}.get(mode, 0)
        graph, cap = capture(cfg, w, no_eog, greedy, dev)
        eager = chunk_run(cfg, w, prompt, greedy, 0, graph, eager=True)
        first = chunk_run(cfg, w, prompt, greedy, 0, graph)
        timed = chunk_run(cfg, w, prompt, greedy, 0, graph)  # the buffers' second run
        if not eager["tokens"] == first["tokens"] == timed["tokens"]:
            raise AssertionError(f"graph {mode}: greedy tokens differ from the eager body's")
        logit_diff = (eager["logits"] - first["logits"]).abs().max().item()
        cap["steps"] = cap["warmup_steps"]
        for name, run in (("eager", eager), ("capture", cap), ("graph", first), ("replay", timed)):
            if (run["k2"] != k2_per_step * run["steps"]
                    or run["k3"] != k3_per_step * run["steps"]):
                raise AssertionError(f"graph {mode} {name}: K2 {run['k2']}, K3 {run['k3']} "
                                     f"launches for {run['steps']} steps")
        replays = -(-GRAPH_TOKENS // CHUNK)
        if (eager["replays"] or eager["eager_steps"] != eager["steps"]
                or (cap["captures"], cap["warmup_steps"], cap["replays"]) != (1, CHUNK, 0)
                or any(r["captures"] or r["eager_steps"] or r["warmup_steps"]
                       or r["replays"] != replays for r in (first, timed))):
            raise AssertionError(f"graph {mode}: counters {eager}, {cap}, {first}, {timed}")
        event_ms = cuda_ms(graph.run, iters=5) / CHUNK
        busy_graph, busy_eager = busy_ms(graph.run), busy_ms(graph.run_eager)
        row = {"eager_ms_per_token": eager["wall_ms"] / GRAPH_TOKENS,
               "graph_ms_per_token": timed["wall_ms"] / GRAPH_TOKENS,
               "graph_event_ms_per_step": event_ms,
               "graph_busy_ms_per_step": busy_graph and busy_graph / CHUNK,
               "eager_busy_ms_per_step": busy_eager and busy_eager / CHUNK,
               "capture_ms": cap["capture_ms"], "max_logit_diff": logit_diff,
               "steps": {"eager": eager["steps"], "warm-up": cap["steps"],
                         "graph": first["steps"], "replay": timed["steps"]}}
        log(f"[graph {mode}] {GRAPH_TOKENS} greedy tokens bit-equal (eager, and two runs on one "
            f"graph); final logits max diff {logit_diff:.3e}; K2 {k2_per_step}/step, K3 "
            f"{k3_per_step}/step over {eager['steps']}/{first['steps']}/{timed['steps']} steps "
            f"(warm-up {cap['steps']})")
        fmt = lambda x: "not measured" if x is None else f"{x:.4f}"  # noqa: E731
        log(f"[graph {mode}] eager: {row['eager_ms_per_token']:.3f} ms/token "
            f"({1e3 / row['eager_ms_per_token']:.1f} tok/s), device busy "
            f"{fmt(row['eager_busy_ms_per_step'])} ms/step | graph: "
            f"{row['graph_ms_per_token']:.3f} ms/token ({1e3 / row['graph_ms_per_token']:.1f} "
            f"tok/s), device {event_ms:.4f} ms/step (events around a replay), busy "
            f"{fmt(row['graph_busy_ms_per_step'])} ms/step, capture {cap['capture_ms']:.1f} ms")
        if mode == "bf16":
            del graph
            # a repeat penalty of 1.1: the replay equals the eager body
            row["repeat_penalty_1.1"] = check_penalty_graph(cfg, w, prompt, no_eog, dev)
            # sampled: the draws follow the key, in the graph and eagerly
            graph, _ = capture(cfg, w, no_eog, sampled, dev)
            seeds = (1, 1, 2)  # three runs in a row on one graph's buffers
            runs = [chunk_run(cfg, w, prompt, sampled, s, graph)["tokens"] for s in seeds]
            eagers = [chunk_run(cfg, w, prompt, sampled, s, graph, eager=True)["tokens"]
                      for s in seeds]
            same = sum(a == b for a, b in zip(runs[0], runs[2]))
            if runs != eagers or runs[0] != runs[1] or same == GRAPH_TOKENS:
                raise AssertionError(f"graph: sampled tokens do not follow the seed (graph runs "
                                     f"equal to eager runs: {[a == b for a, b in zip(runs, eagers)]}"
                                     f", seed 1 twice equal: {runs[0] == runs[1]}, seeds 1 and 2 "
                                     f"agree at {same})")
            row["sampled_seed_1_and_2_agree_at"] = same
            log(f"[graph {mode}] sampled (temp 0.8, top-k 50), seeds {seeds} in a row on one "
                f"graph: each run equals its seed's eager run, seed 1 gives the same "
                f"{GRAPH_TOKENS} tokens twice, seed 2 agrees with it at {same} of {GRAPH_TOKENS}")
        rows[mode] = row
        del w, eager, first, timed, graph, prompt
        torch.cuda.empty_cache()
    return rows


def stream_request(name: str, tmp: Path, codec: str, model: str, n_predict: int,
                   extra: list[str], kernels, cfg) -> dict:
    """One --tts-stream-output request through the CLI: the WAV (sizes
    patched) has the full decode's sample count and is not silent (a mel
    WAV at most 1% clipped); TTFA, re-decodes and their time printed."""
    t0 = time.perf_counter()
    text, n_codes, sr, pcm, grew, routes = drive_cli(
        f"stream-{name}", tmp, ["-mv", str(tmp / codec), "-m", str(tmp / model), "-p",
                                STREAM_PROMPT, "-n", str(n_predict), "--tts-stream-output", *extra],
        kernels)
    wall_s = time.perf_counter() - t0
    want = wav_samples(cfg, n_codes)
    if sr != cfg.sample_rate or pcm.size != want:
        raise AssertionError(f"stream {name}: {pcm.size} samples at {sr} Hz, {n_codes} codes "
                             f"imply {want} at {cfg.sample_rate}")
    clipped = float(np.mean(np.abs(pcm.astype(np.int32)) >= 32767))
    if cfg.model_type == 1 and clipped > MEL_CLIPPED_MAX:
        raise AssertionError(f"stream {name}: {clipped:.3f} of the samples clip")
    m = re.search(r"streaming ttfa=([0-9.]+)ms .*redecodes=(\d+) redecode_ms=([0-9.]+)", text)
    ttfa, redecodes, redecode_ms = float(m.group(1)), int(m.group(2)), float(m.group(3))
    n_tok = int(re.search(r"n_tokens=(\d+)", text).group(1))
    if redecodes != routes["eager"] + routes["replays"]:
        raise AssertionError(f"stream {name}: {redecodes} re-decodes, codec graph {routes}")
    log(f"[stream {name}] n_predict={n_predict} {' '.join(extra)}: tokens={n_tok} "
        f"codes={n_codes} ttfa_ms={ttfa} redecodes={redecodes} redecode_ms={redecode_ms} "
        f"of them replays={routes['replays']} replay_ms={routes['replay_ms']:.1f} "
        f"eager={routes['eager']} captures={routes['captures']} "
        f"capture_ms={routes['capture_ms']:.1f} wall_s={wall_s:.3f} audio_s={pcm.size / sr} "
        f"{graph_text(text)} launches: {launch_text(grew)}")
    return {"tokens": n_tok, "codes": n_codes, "ttfa_ms": ttfa, "redecodes": redecodes,
            "redecode_ms": redecode_ms, "codec_graph": routes, "wall_s": wall_s,
            "audio_s": pcm.size / sr}


def run_request(i: str, tmp: Path, prompt: str, n_predict: int, extra: list[str], ccfg,
                model: str = "llm.gguf", kernels=(k1, k2)) -> dict:
    """One text -> WAV run through the CLI on the wave codec; the WAV has the
    sample count its codes imply (the iSTFT's)."""
    text, n_codes, sr, pcm, grew, _ = drive_cli(
        f"req{i}", tmp, ["-mv", str(tmp / "codec.gguf"), "-m", str(tmp / model), "-p", prompt,
                         "-n", str(n_predict), *extra], kernels)
    want = wav_samples(ccfg, n_codes)
    if pcm.size != want:
        raise AssertionError(f"request {i}: {pcm.size} samples, {n_codes} codes imply {want}")
    tok_s = float(re.search(r"tok/s=([0-9.]+)", text).group(1))
    n_tok = int(re.search(r"n_tokens=(\d+)", text).group(1))
    codec_ms = float(re.search(r"synth breakdown: decode=([0-9.]+)ms", text).group(1))
    log(f"[request {i}] {model} prompt_chars={len(prompt)} n_predict={n_predict} "
        f"{' '.join(extra)}: tokens={n_tok} tok/s={tok_s} codes={n_codes} codec_ms={codec_ms} "
        f"audio_s={pcm.size / sr} {graph_text(text)} launches: {launch_text(grew)}")
    return {"tokens": n_tok, "tok_s": tok_s, "codec_ms": codec_ms, "audio_s": pcm.size / sr}


def vocoder_launches(mcfg, bucket: int) -> dict:
    """K4/K5/K6 launches of one mel decode of a ``bucket``-code batch by the
    vocoder's dispatch rules (models/vocoder.py): per stage one K4 (noise
    conv), then each resblock layer is one K6 at >= 1024 padded rows, else
    K5, K4, K5, K4; one K5 after the last stage."""
    n = {k4: 0, k5: 0, k6: 0}
    rows, layers = mcfg.decoder_frames(bucket), 3 * mcfg.vocoder_num_kernels
    for rate in mcfg.vocoder_upsample_rates:
        rows *= rate
        n[k4] += 1
        if rows >= 1024:
            n[k6] += layers
        else:
            n[k5] += 2 * layers
            n[k4] += 2 * layers
    n[k5] += 1
    return n


def mel_request(name: str, tmp: Path, mcfg, extra: list[str], kernels) -> dict:
    """One mel-mode run (codes or text -> WAV) through the CLI on the mel
    codec. The WAV has the vocoder's sample count and is not clipped; K4-K6
    launched exactly as the vocoder's dispatch rules say for the bucket."""
    t0 = time.perf_counter()
    text, n_codes, sr, pcm, grew, _ = drive_cli(
        f"mel-{name}", tmp, ["-mv", str(tmp / "mel_codec.gguf"),
                             *[str(tmp / a) if a.endswith((".gguf", ".txt")) else a
                               for a in extra]], kernels)
    wall_s = time.perf_counter() - t0
    want = wav_samples(mcfg, n_codes)
    if sr != mcfg.sample_rate or pcm.size != want:
        raise AssertionError(f"mel request {name}: {pcm.size} samples at {sr} Hz, "
                             f"{n_codes} codes imply {want} at {mcfg.sample_rate}")
    clipped = float(np.mean(np.abs(pcm.astype(np.int32)) >= 32767))
    if clipped > MEL_CLIPPED_MAX:
        raise AssertionError(f"mel request {name}: {clipped:.3f} of the samples clip")
    expect = vocoder_launches(mcfg, pick_bucket(n_codes))
    if any(grew[m] != n for m, n in expect.items()):
        raise AssertionError(f"mel request {name}: K4/K5/K6 launched {[grew[m] for m in expect]}, "
                             f"dispatch implies {list(expect.values())}")
    codec_ms = float(re.search(r"synth breakdown: decode=([0-9.]+)ms", text).group(1))
    tok = re.search(r"tok/s=([0-9.]+)", text)
    log(f"[mel {name}] codes={n_codes} bucket={pick_bucket(n_codes)} codec_ms={codec_ms} "
        f"wall_s={wall_s:.2f} audio_s={pcm.size / sr} peak={np.abs(pcm).max() / 32767:.3f}"
        + (f" tok/s={tok.group(1)} {graph_text(text)}" if tok else "")
        + f" launches: {launch_text(grew)}")
    return {"codec_ms": codec_ms, "audio_s": pcm.size / sr}


def wave441_request(name: str, tmp: Path, cfg, extra: list[str], kernels) -> dict:
    """One request on the 44.1 kHz codec through the CLI: a 44 100 Hz WAV
    with the upsampled iSTFT's sample count, one eager codec decode (K1 14
    times)."""
    t0 = time.perf_counter()
    text, n_codes, sr, pcm, grew, _ = drive_cli(
        f"wave441-{name}", tmp, ["-mv", str(tmp / "codec441.gguf"),
                                 *[str(tmp / a) if a.endswith((".gguf", ".txt")) else a
                                   for a in extra]], kernels)
    wall_s = time.perf_counter() - t0
    want = wav_samples(cfg, n_codes)
    if sr != 44100 or pcm.size != want or grew[k1] != K1_PER_DECODE:
        raise AssertionError(f"wave441 request {name}: {pcm.size} samples at {sr} Hz, K1 "
                             f"{grew[k1]} launches; {n_codes} codes imply {want} at 44100 Hz "
                             f"and {K1_PER_DECODE}")
    codec_ms = float(re.search(r"synth breakdown: decode=([0-9.]+)ms", text).group(1))
    tok = re.search(r"tok/s=([0-9.]+)", text)
    log(f"[wave441 {name}] codes={n_codes} bucket={pick_bucket(n_codes)} codec_ms={codec_ms} "
        f"wall_s={wall_s:.2f} audio_s={pcm.size / sr} samples={pcm.size} @ {sr} Hz"
        + (f" tok/s={tok.group(1)} {graph_text(text)}" if tok else "")
        + f" launches: {launch_text(grew)}")
    return {"codec_ms": codec_ms, "audio_s": pcm.size / sr}


def codec_host(cfg, emb, bucket: int, lengths: list[int], seed: int):
    """tokens [B, bucket] (random codes, zeros past each length), lengths
    [B] and cond [B, Dc] for ``MioTTSPipeline.decode``."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((len(lengths), bucket), np.int64)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.randint(0, cfg.vocab_size, n)
    return tokens, np.asarray(lengths, np.int32), np.repeat(emb[None], len(lengths), 0)


def same_decode(what: str, got, ref, starts, sample_rate: int, pcm16: bool) -> str:
    """A replay's (audio, counts) against the eager decode of the same
    input: the same counts and zeros past each lane's count, and bit-equal
    rows; else within REPLAY_TOL (plus one 16-bit step for pcm16) and
    mel-L1 < MEL_L1_MAX, the difference printed. Returns "bit-equal" or
    what differed."""
    (a, n), (b, m) = got[:2], ref[:2]
    if not np.array_equal(n, m):
        raise AssertionError(f"{what}: counts {n} differ from the eager decode's {m}")
    for lane, count in enumerate(n):
        valid = max(0, int(count) - (0 if starts is None else int(starts[lane])))
        if np.any(a[lane, valid:] != 0):
            raise AssertionError(f"{what}: lane {lane} is not zero past its {valid} samples")
    if a.tobytes() == b.tobytes():
        return "bit-equal"
    diff = float(np.abs(a - b).max())
    l1 = max(mel_l1(a[lane], b[lane], sample_rate) for lane in range(len(n)))
    tol = REPLAY_TOL + (1.0 / 32767 if pcm16 else 0.0)
    log(f"[codec graph] {what}: NOT bit-equal to the eager decode: max abs diff {diff:.3e}, "
        f"mel-L1 {l1:.3e} (allowed {tol:.2e}, {MEL_L1_MAX})")
    if not (diff <= tol and l1 < MEL_L1_MAX):
        raise AssertionError(f"{what}: replay differs from the eager decode by {diff}, mel-L1 {l1}")
    return f"max abs diff {diff:.3e}, mel-L1 {l1:.3e}"


def graph_key(pipe, cfg, emb, codec: str, bucket: int, windowed: bool) -> dict:
    """Decodes 1-4 of one key on ``pipe``: n = bucket (eager), the same input
    again (the capture, then its replay), n = ceil(bucket / 3) and n =
    bucket again (replays). Each equals the eager decode of its input; K1
    launches 14 times a decode and K4-K6 as often in a replay as in the
    eager decode. The windowed key is the stream's (anchor, no peak
    normalization, a window of StreamingSynthesizer.WINDOW_SAMPLES, pcm16),
    its starts moving."""
    long_, short = bucket, -(-bucket // 3)
    opts = {}
    if windowed:
        opts = dict(interp_anchor=StreamingSynthesizer.INTERP_ANCHOR, peak_normalize=False,
                    window=StreamingSynthesizer.WINDOW_SAMPLES, pcm16=True)
    what = f"{codec} bucket {bucket}" + (" window pcm16" if windowed else "")
    plan = ((long_, 0, 0), (long_, 0, wav_samples(cfg, long_) // 3),
            (short, 1, wav_samples(cfg, short) // 4), (long_, 0, 0))
    routes, walls, grews, checks, first = [], [], [], [], None
    for i, (n, seed, start) in enumerate(plan):
        tokens, lengths, cond = codec_host(cfg, emb, bucket, [n], seed)
        kw = dict(opts, starts=np.array([start], np.int32)) if windowed else {}
        l0, c0 = {m: m.launches for m in MODS}, codec_counts()
        got = pipe.decode(tokens, lengths, cond, **kw)
        c = {k: v - c0[k] for k, v in codec_counts().items()}
        grews.append({m: m.launches - l0[m] for m in MODS})
        routes.append("eager" if c["eager"] else "capture" if c["captures"] else
                      "replay" if c["replays"] else "?")
        walls.append(got[2])
        if i == 0 or windowed or n != long_:
            ref = pipe.decode_eager(tokens, lengths, cond, **kw)
            first = first if first is not None else got
        else:
            ref = first
        checks.append(same_decode(f"{what} decode {i + 1} (n={n})", got, ref,
                                  kw.get("starts"), cfg.sample_rate, windowed))
    if routes != ["eager", "capture", "replay", "replay"]:
        raise AssertionError(f"{what}: decodes went {routes}")
    for i, g in enumerate(grews):
        if g[k1] != K1_PER_DECODE or any(g[m] != grews[0][m] for m in MODS):
            raise AssertionError(f"{what} decode {i + 1}: launches {launch_text(g)}, the eager "
                                 f"decode's {launch_text(grews[0])}")
    key = CodecKey(1, bucket, True, opts.get("interp_anchor"), opts.get("peak_normalize", True),
                   opts.get("window"), opts.get("pcm16", False))
    graph = pipe.graphs[key]
    tokens, lengths, cond = codec_host(cfg, emb, bucket, [long_], 0)
    kw = dict(opts, starts=np.array([0], np.int32)) if windowed else {}
    replay_ms = sorted(pipe.decode(tokens, lengths, cond, **kw)[2] for _ in range(5))
    busy_replay = busy_ms(lambda: pipe.decode(tokens, lengths, cond, **kw))
    busy_eager = busy_ms(lambda: pipe.decode_eager(tokens, lengths, cond, **kw))
    row = {"eager_wall_ms": walls[0], "capture_ms": graph.capture_ms,
           "capture_decode_wall_ms": walls[1], "replay_wall_ms": walls[2:] + replay_ms,
           "replay_busy_ms": busy_replay, "eager_busy_ms": busy_eager,
           "launches_per_decode": launch_text(grews[2]), "vs_eager": checks}
    fmt = lambda x: "not measured" if x is None else f"{x:.3f}"  # noqa: E731
    log(f"[codec graph] {what}: eager {walls[0]:.2f} ms wall (busy {fmt(busy_eager)} ms), "
        f"capture {graph.capture_ms:.1f} ms (that decode {walls[1]:.2f} ms wall), replays "
        f"{', '.join(f'{x:.2f}' for x in row['replay_wall_ms'])} ms wall (busy "
        f"{fmt(busy_replay)} ms); launches a decode: {row['launches_per_decode']}; against "
        f"the eager decodes: {', '.join(checks)}")
    return row


def graph_batch(pipe, cfg, emb, codec: str, bucket: int) -> dict:
    """A B=2 graph captured ahead of time (``capture``, its own warm-up),
    one replay of two ragged lanes: equal to the eager B=2 decode, counts
    those of the lengths, K1 14 launches."""
    lens = [bucket, -(-bucket // 3)]
    c0 = codec_counts()
    graph = pipe.capture(bucket, B=2)
    tokens, lengths, cond = codec_host(cfg, emb, bucket, lens, 2)
    l0 = k1.launches
    got = pipe.decode(tokens, lengths, cond)
    grew = k1.launches - l0
    c = {k: v - c0[k] for k, v in codec_counts().items()}
    ref = pipe.decode_eager(tokens, lengths, cond)
    check = same_decode(f"{codec} bucket {bucket} B=2 lengths {lens}", got, ref, None,
                        cfg.sample_rate, False)
    want = [wav_samples(cfg, n) for n in lens]
    if (list(got[1]) != want or grew != K1_PER_DECODE or c["eager"]
            or (c["captures"], c["replays"]) != (1, 1)):
        raise AssertionError(f"{codec} B=2: counts {list(got[1])} (want {want}), K1 {grew}, {c}")
    log(f"[codec graph] {codec} bucket {bucket} B=2 lengths {lens}: captured ahead "
        f"({graph.capture_ms:.1f} ms, warm-up included), one replay {got[2]:.2f} ms wall, "
        f"{check}")
    return {"capture_ms": graph.capture_ms, "replay_wall_ms": got[2], "vs_eager": check}


def check_codec_graphs(dev, tmp: Path, emb, cfgs: dict) -> dict:
    """The codec graph phase: every key of CODEC_GRAPH_CASES (graph_key,
    plain and windowed), one B=2 graph a codec, and the reserved memory
    after all of them."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows, pipes = {}, []
    for codec, gguf, buckets in CODEC_GRAPH_CASES:
        pipe = MioTTSPipeline(tmp / gguf, dev)
        pipes.append(pipe)
        for bucket in buckets:
            for windowed in (False, True):
                rows[f"{codec} bucket {bucket}{' window pcm16' if windowed else ''}"] = graph_key(
                    pipe, cfgs[codec], emb, codec, bucket, windowed)
        rows[f"{codec} bucket {buckets[0]} B=2"] = graph_batch(pipe, cfgs[codec], emb, codec,
                                                               buckets[0])
    torch.cuda.synchronize()
    mem = {"max_reserved_mib": torch.cuda.max_memory_reserved() / 2 ** 20,
           "reserved_mib": torch.cuda.memory_reserved() / 2 ** 20,
           "graphs": sum(len(p.graphs) for p in pipes)}
    log(f"[codec graph] after all {mem['graphs']} captures (three pipelines, one pool each): "
        f"max_memory_reserved {mem['max_reserved_mib']:.0f} MiB, memory_reserved "
        f"{mem['reserved_mib']:.0f} MiB")
    del pipes
    torch.cuda.empty_cache()
    return {"keys": rows, "memory": mem}


def pool_memory(dev, tmp: Path) -> dict:
    """The memory the mel codec's graphs at buckets 512 and 2048 keep
    reserved (MiB over the loaded pipeline), in the pipeline's shared pool
    and with a pool each."""
    out = {}
    for shared in (True, False):
        torch.cuda.empty_cache()
        pipe = MioTTSPipeline(tmp / "mel_codec.gguf", dev)
        if not shared:
            pipe.graph_pool = None  # CodecGraph then takes a private pool
        torch.cuda.synchronize()
        base = torch.cuda.memory_reserved()
        for bucket in (512, 2048):
            pipe.capture(bucket)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["shared_pool_mib" if shared else "pool_each_mib"] = (
            (torch.cuda.memory_reserved() - base) / 2 ** 20)
        del pipe
    torch.cuda.empty_cache()
    log(f"[codec graph] mel graphs at buckets 512 and 2048 keep {out['shared_pool_mib']:.0f} MiB "
        f"reserved in one shared pool, {out['pool_each_mib']:.0f} MiB with a pool each")
    return out


def fidelity(path: Path, device, codes, emb, sample_rate: int, what: str) -> None:
    """The same codes decoded on the card and on the CPU (plain versions,
    f32): finite, the same length, mel-L1 < MEL_L1_MAX."""
    outs = []
    for d in (device, torch.device("cpu")):
        res = MioTTSPipeline(path, d).synthesize(codes, emb)
        outs.append(res.audio)
        log(f"[fidelity {what}] {d.type}: {res.audio.size} samples in {res.decode_ms:.1f}ms")
    if outs[0].shape != outs[1].shape or not np.all(np.isfinite(outs[0])):
        raise AssertionError(f"{what}: card and CPU decodes differ in shape or are not finite")
    l1 = mel_l1(outs[0], outs[1], sample_rate)
    diff = float(np.abs(outs[0] - outs[1]).max())
    log(f"[fidelity {what}] mel-L1(card, CPU f32) = {l1:.3e}, max abs diff = {diff:.3e}")
    if not l1 < MEL_L1_MAX:
        raise AssertionError(f"{what}: mel-L1 {l1} >= {MEL_L1_MAX}")


# -- the codec knobs ---------------------------------------------------------------------

KNOB_CODES = 400
KNOB_MEL_CPU_CODES = 64  # the mel decode the CPU makes in ~20 s (400 codes: minutes)
MATMUL_MODES = ("float32", "tensorfloat32", "bfloat16")


@contextlib.contextmanager
def environment(**values):
    """Environment variables set (a value of None: unset) inside, put back
    on exit."""
    def put(settings: dict) -> None:
        for k, v in settings.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    saved = {k: os.environ.get(k) for k in values}
    try:
        put(values)
        yield
    finally:
        put(saved)


def knob_pipeline(path: Path, dev, matmul: str) -> MioTTSPipeline:
    """A pipeline built with MIOTTS_CODEC_MATMUL set to ``matmul``; it keeps
    what it read."""
    with environment(MIOTTS_CODEC_MATMUL=matmul):
        pipe = MioTTSPipeline(path, dev)
    if pipe.codec_matmul != matmul:
        raise AssertionError(f"pipeline read {pipe.codec_matmul}, not {matmul}")
    return pipe


def knob_decodes(pipe: MioTTSPipeline, codes, emb) -> tuple[dict, dict]:
    """Three decodes of ``codes`` on one pipeline (the key's eager decode,
    its capture and replay, a replay): a row with the last one's audio,
    whether the three are bit-equal and the profiler's busy ms of a
    replay, and the last one's launches."""
    audio, walls, grews = [], [], []
    for _ in range(3):
        l0 = {m: m.launches for m in MODS}
        res = pipe.synthesize(codes, emb)
        grews.append({m: m.launches - l0[m] for m in MODS})
        audio.append(res.audio)
        walls.append(res.decode_ms)
    return {"audio": audio[-1], "eager_ms": walls[0], "capture_decode_ms": walls[1],
            "replay_ms": walls[2], "replay_busy_ms": busy_ms(lambda: pipe.synthesize(codes, emb)),
            "launches": launch_text(grews[-1]), "repeats_bit_equal": all(
                a.tobytes() == audio[0].tobytes() for a in audio)}, grews[-1]


def knob_text(row: dict) -> str:
    busy = row["replay_busy_ms"]
    return (f"eager {row['eager_ms']:.2f} ms, capture+replay {row['capture_decode_ms']:.1f} "
            f"ms, replay {row['replay_ms']:.2f} ms wall (busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}); the three decodes "
            f"bit-equal: {row['repeats_bit_equal']}; launches a decode: {row['launches']}")


def check_codec_knobs(dev, tmp: Path, emb, cfgs: dict) -> dict:
    """The codec's precision knob, each pipeline built with its own setting:
    MIOTTS_CODEC_MATMUL float32, tensorfloat32 and bfloat16 for a 400-code
    wave decode (mel-L1 against the CPU's f32 decode) and for mel decodes
    (64 codes against the CPU's f32 decode, 400 codes against the card's
    f32 decode); mel-L1 < 1e-2 (the fidelity bar) is required of every
    mode but the mel codec's bfloat16, whose vocoder's conv_post at bf16
    misses it, and that one is reported. K4/K5/K6 launches as the dispatch
    rules give them. Eager, capture and replay ms and a replay's busy ms
    printed."""
    rng = np.random.RandomState(12)
    cpu = torch.device("cpu")
    out: dict = {"wave": {}, "mel": {}}
    wcfg, mcfg = cfgs["wave"], cfgs["mel"]
    codes = rng.randint(0, wcfg.vocab_size, KNOB_CODES)
    t0 = time.perf_counter()
    cpu_wave = MioTTSPipeline(tmp / "codec.gguf", cpu).synthesize(codes, emb).audio
    log(f"[knobs] wave CPU f32 decode of {KNOB_CODES} codes in {time.perf_counter() - t0:.1f}s")
    for mode in MATMUL_MODES:
        row, grew = knob_decodes(knob_pipeline(tmp / "codec.gguf", dev, matmul=mode), codes, emb)
        got = row.pop("audio")
        row["mel_l1_vs_cpu_f32"] = l1 = mel_l1(got, cpu_wave, wcfg.sample_rate)
        row["max_abs_vs_cpu_f32"] = float(np.abs(got - cpu_wave).max())
        out["wave"][mode] = row
        log(f"[knobs] wave {KNOB_CODES} codes, MIOTTS_CODEC_MATMUL={mode}: mel-L1 vs CPU f32 "
            f"{l1:.3e}, max abs {row['max_abs_vs_cpu_f32']:.3e}; {knob_text(row)}")
        if got.shape != cpu_wave.shape or grew[k1] != K1_PER_DECODE or not l1 < MEL_L1_MAX:
            raise AssertionError(f"wave decode at {mode}: {got.shape} vs {cpu_wave.shape}, {row}")

    codes64 = rng.randint(0, mcfg.vocab_size, KNOB_MEL_CPU_CODES)
    codes = rng.randint(0, mcfg.vocab_size, KNOB_CODES)
    t0 = time.perf_counter()
    cpu_mel = MioTTSPipeline(tmp / "mel_codec.gguf", cpu).synthesize(codes64, emb).audio
    CPU_REFS["mel"] = (codes64, cpu_mel)
    log(f"[knobs] mel CPU f32 decode of {KNOB_MEL_CPU_CODES} codes in "
        f"{time.perf_counter() - t0:.1f}s")
    ref400 = None
    for mode in MATMUL_MODES:
        name = f"MIOTTS_CODEC_MATMUL={mode}"
        pipe = knob_pipeline(tmp / "mel_codec.gguf", dev, matmul=mode)
        a64 = pipe.synthesize(codes64, emb).audio
        row, grew = knob_decodes(pipe, codes, emb)
        got = row.pop("audio")
        row["mel_l1_vs_cpu_f32_64"] = l1_64 = mel_l1(a64, cpu_mel, mcfg.sample_rate)
        ref400 = got if ref400 is None else ref400
        row["mel_l1_vs_card_f32_400"] = l1 = mel_l1(got, ref400, mcfg.sample_rate)
        row["max_abs_vs_card_f32_400"] = diff = float(np.abs(got - ref400).max())
        want = vocoder_launches(mcfg, pick_bucket(KNOB_CODES))
        out["mel"][name] = row
        log(f"[knobs] mel, {name}: {KNOB_MEL_CPU_CODES} codes mel-L1 vs CPU f32 {l1_64:.3e}; "
            f"{KNOB_CODES} codes vs the card's default f32 decode: mel-L1 {l1:.3e}, max abs "
            f"{diff:.3e}; {knob_text(row)}")
        if (a64.shape != cpu_mel.shape or got.shape != ref400.shape
                or any(grew[m] != n for m, n in want.items())
                or (mode != "bfloat16" and not (l1_64 < MEL_L1_MAX and l1 < MEL_L1_MAX))):
            raise AssertionError(f"mel decode, {name}: launches {row['launches']} "
                                 f"(dispatch: {launch_text(want)}), {row}")
    return out


# -- the clone phase ---------------------------------------------------------------------

# references: (file, seconds of 24 kHz audio written); the 25 s one is cut
# to the default --tts-max-reference-seconds (20)
# ref3.mp3 (tests/torch_assets, scripts/gen_torch_mp3_fixtures.py) is the
# 3 s clip through LAME: 73 152 samples decoded, LAME's encoder delay and
# padding included (its Info frame skipped)
CLONE_REFS = (("ref3.wav", 3.0), ("ref20.wav", 20.0), ("ref25.wav", 25.0), ("ref3.flac", 3.0),
              ("ref3.mp3", 73152 / 24000))
MP3_ASSETS = Path(__file__).resolve().parent / "tests" / "torch_assets"
# the native decoder each compressed reference must go through
NATIVE_DECODE = {".flac": "mio_flac_decode", ".mp3": "mio_mp3_decode"}
# 40 000 samples at 16 kHz: another length in the 3 s reference's bucket (64 000)
CLONE_SAME_BUCKET = ("ref2_5.wav", 2.5)
CLONE_MAX_SECONDS = 20.0
CLONE_EMB_TOL = 1e-3  # max abs, card vs CPU
CLONE_COS_MIN = 0.9999
CLONE_PROMPT = "A cloned voice reads this sentence aloud."


def clone_clip(sr: int, secs: float) -> np.ndarray:
    """The clone phase's reference clip, ``secs`` seconds at ``sr`` Hz (f32
    mono, seed 21): a voice-like tone with vibrato, a harmonic and noise.
    ``ref3.mp3`` (tests/torch_assets, scripts/gen_torch_mp3_fixtures.py) is
    its first 3 s at 24 kHz."""
    rng = np.random.RandomState(21)
    t = np.arange(int(secs * sr)) / sr
    f0 = 180 + 20 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    return ((0.35 * np.sin(phase) + 0.12 * np.sin(2 * phase) + 0.02 * rng.randn(t.size))
            * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t) ** 2)).astype(np.float32)


def clone_assets(tmp: Path) -> None:
    """The full-width WavLM Base+ GGUF and the reference clips: a voice-like
    tone with vibrato, a harmonic and noise (24 kHz mono), 3, 20 and 25 s as
    16-bit WAVs, the 3 s clip as a FLAC (tests/flac_encoder.py) and as the
    committed mp3 (copied: the card machine may have no libmp3lame)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from flac_encoder import encode_flac

    from miotts_tpu_torch.runtime.audio_io import save_wav16

    write_synthetic_wavlm_gguf(str(tmp / "wavlm.gguf"), seed=5, **full_wavlm_kwargs())
    sr = 24000
    clip = clone_clip(sr, 25.0)
    for name, secs in (*CLONE_REFS, CLONE_SAME_BUCKET):
        x = clip[:int(secs * sr)]
        if name.endswith(".mp3"):
            (tmp / name).write_bytes((MP3_ASSETS / name).read_bytes())
        elif name.endswith(".flac"):
            pcm = np.rint(np.clip(x, -1, 1) * 32767).astype(np.int64)
            (tmp / name).write_bytes(encode_flac(pcm, sr, subframe_kind="lpc2"))
        else:
            save_wav16(tmp / name, x, sr)


def ref_pool_mib(pool) -> float | None:
    """MiB of the segments the caching allocator holds in the graph memory
    pool ``pool`` (None when it holds none)."""
    want = tuple(pool)
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == want]
    return sum(seg["total_size"] for seg in segs) / 2 ** 20 if segs else None


def same_embedding(what: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.tobytes() != want.tobytes():
        raise AssertionError(f"{what}: not bit-equal, max abs {float(np.abs(got - want).max())}")


def check_references(dev, tmp: Path) -> dict:
    """Each reference through ``reference_embedding`` four times on one
    card pipeline (a bucket's first chain eager under sync-debug "error",
    its second the capture of the bucket's CUDA graph, then replays; a
    reference in a bucket already captured replays all four) and once on
    the CPU (the same port module): rung ssl on both, card vs CPU within
    CLONE_EMB_TOL max abs and CLONE_COS_MIN cosine, the card's bucket table
    equal to the CPU's, every card run bit-equal to the first and to the
    chain run eagerly by name. Then a reference of another length in the
    3 s reference's bucket replays that graph bit-equal to its own eager
    chain, two threads running chains at once (on one graph, and on two)
    each get their eager results, and the reference graphs keep a pool of
    their own. Host decode ms, device chain ms of each run, the capture's
    ms, the profiler's busy ms of an eager chain and of a replay, the
    max_memory_allocated and the reference pool's MiB printed."""
    import threading

    from miotts_tpu_torch.models.wavlm import bucket_table

    card = MioTTSPipeline(tmp / "codec.gguf", dev, wavlm_path=tmp / "wavlm.gguf")
    cpu = MioTTSPipeline(tmp / "codec.gguf", torch.device("cpu"), wavlm_path=tmp / "wavlm.gguf")
    if not card.check_syncs:
        raise AssertionError("the card's reference chain must run under the sync check")
    if card.ref_graph_pool is None or card.ref_graph_pool == card.graph_pool:
        raise AssertionError("the reference graphs need a memory pool apart from the codec's")
    ref0 = dataclasses.replace(codec_graph.reference)
    rows, eager_of = {}, {}
    for name, secs in CLONE_REFS:
        path = tmp / name
        want_n = int(min(secs, CLONE_MAX_SECONDS) * 16000)
        new_bucket = card.wavlm.pick_wav_bucket(want_n) not in card.ref_seen
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        entry = NATIVE_DECODE.get(path.suffix)
        n0 = native.calls[entry] if entry else 0
        runs = [card.reference_embedding(path, CLONE_MAX_SECONDS) for _ in range(4)]
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        host_route = ("wav" if entry is None
                      else "native" if native.calls[entry] == n0 + 4 else "numpy")
        if host_route == "numpy":
            raise AssertionError(f"reference {name} was not decoded natively: "
                                 f"{native.calls[entry] - n0} native decodes "
                                 f"of 4 ({native.unavailable_reason()})")
        emb, st = runs[0]
        routes = [r.route for _, r in runs]
        want_routes = ["eager", "capture", "replay", "replay"] if new_bucket else ["replay"] * 4
        if routes != want_routes:
            raise AssertionError(f"reference {name}: chains went {routes}, not {want_routes}")
        eager_of[name] = card.reference_embedding_eager(path, CLONE_MAX_SECONDS)
        for i, (e, _) in enumerate(runs):
            same_embedding(f"reference {name} run {i + 1} ({routes[i]}) vs run 1", e, emb)
        same_embedding(f"reference {name} vs its eager chain", eager_of[name], emb)
        busy = busy_ms(lambda: card.reference_embedding(path, CLONE_MAX_SECONDS))
        busy_eager = busy_ms(lambda: card.reference_embedding_eager(path, CLONE_MAX_SECONDS))
        graph = card.ref_graphs[st.bucket]
        ref, cst = cpu.reference_embedding(path, CLONE_MAX_SECONDS)
        host_t, dev_t = card.wavlm.bucket_table(st.frames)
        table_ok = (np.array_equal(to_host(dev_t), host_t)
                    and np.array_equal(host_t, bucket_table(cpu.wavlm.config, st.frames))
                    and np.array_equal(host_t, cpu.wavlm.bucket_table(cst.frames)[0]))
        err = float(np.abs(emb - ref).max())
        cos = float(np.dot(emb, ref) / (np.linalg.norm(emb) * np.linalg.norm(ref)))
        rows[name] = {"seconds": secs, "n_samples": st.n_samples, "bucket": st.bucket,
                      "frames": st.frames, "rung": st.rung, "max_abs_err": err, "cosine": cos,
                      "routes": routes, "decode_ms": [r.decode_ms for _, r in runs],
                      "decoded": host_route,
                      "device_ms": [r.device_ms for _, r in runs],
                      "capture_ms": graph.capture_ms if new_bucket else None,
                      "replay_busy_ms": busy, "eager_busy_ms": busy_eager,
                      "peak_allocated_mib": peak_mib, "cpu_device_ms": cst.device_ms}
        fmt = lambda x: "not measured" if x is None else f"{x:.2f} ms"  # noqa: E731
        log(f"[clone] {name}: {st.n_samples} samples at 16 kHz, bucket {st.bucket}, "
            f"{st.frames} frames, rung {st.rung} (CPU {cst.rung}); host decode+resample"
            + (f" ({host_route} {path.suffix[1:].upper()} decode)" if entry else "") + " "
            f"{', '.join(f'{r.decode_ms:.1f}' for _, r in runs)} ms; device chain "
            + ", ".join(f"{r.route} {r.device_ms:.2f}" for _, r in runs) + " ms wall"
            + (f" (the capture {graph.capture_ms:.1f} ms of it)" if new_bucket else "")
            + f"; busy: eager {fmt(busy_eager)}, replay {fmt(busy)}; "
            f"max_memory_allocated {peak_mib:.0f} MiB over the loaded weights; card vs CPU "
            f"max abs {err:.3e} cosine {cos:.7f}; CPU chain {cst.device_ms:.0f} ms; bucket "
            f"table card == CPU: {table_ok}; the 4 card runs and the eager chain bit-equal")
        if (st.rung != "ssl" or cst.rung != "ssl" or st.n_samples != want_n
                or not np.isfinite(emb).all() or not err <= CLONE_EMB_TOL
                or not cos >= CLONE_COS_MIN or not table_ok):
            raise AssertionError(f"reference {name}: {rows[name]}, table equal {table_ok}")
        rows[name]["embedding"] = emb

    # another length in the 3 s reference's bucket: its graph, no capture
    name, secs = CLONE_SAME_BUCKET
    emb, st = card.reference_embedding(tmp / name, CLONE_MAX_SECONDS)
    eager_of[name] = card.reference_embedding_eager(tmp / name, CLONE_MAX_SECONDS)
    ref, _ = cpu.reference_embedding(tmp / name, CLONE_MAX_SECONDS)
    err = float(np.abs(emb - ref).max())
    if (st.route != "replay" or st.bucket != rows["ref3.wav"]["bucket"]
            or st.n_samples == rows["ref3.wav"]["n_samples"] or not err <= CLONE_EMB_TOL):
        raise AssertionError(f"{name}: route {st.route}, bucket {st.bucket}, {st.n_samples} "
                             f"samples, card vs CPU {err}")
    same_embedding(f"{name}'s replay vs its eager chain", emb, eager_of[name])
    rows[name] = {"seconds": secs, "n_samples": st.n_samples, "bucket": st.bucket,
                  "route": st.route, "device_ms": st.device_ms, "max_abs_err": err}
    log(f"[clone] {name}: {st.n_samples} samples, bucket {st.bucket} (ref3.wav's, "
        f"{rows['ref3.wav']['n_samples']} samples): a replay of that graph, {st.device_ms:.2f} "
        f"ms wall, bit-equal to its own eager chain; card vs CPU max abs {err:.3e}")

    # two chains at once: a lock holds copy-in, replay and read together
    concurrent = {}
    for pair in (("ref3.wav", CLONE_SAME_BUCKET[0]), ("ref3.wav", "ref20.wav")):
        start, out = threading.Barrier(2, timeout=60), {n: [] for n in pair}

        def worker(n):
            start.wait()
            for _ in range(3):
                out[n].append(card.reference_embedding(tmp / n, CLONE_MAX_SECONDS))

        threads = [threading.Thread(target=worker, args=(n,)) for n in pair]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if any(t.is_alive() for t in threads) or any(len(v) != 3 for v in out.values()):
            raise AssertionError(f"concurrent chains {pair} did not finish")
        for n, res in out.items():
            for e, r in res:
                same_embedding(f"{n} beside {pair}", e, eager_of[n])
                if r.route != "replay":
                    raise AssertionError(f"{n} beside {pair}: route {r.route}")
        concurrent[" + ".join(pair)] = {n: [r.device_ms for _, r in res] for n, res in out.items()}
        log(f"[clone] two threads at once, {' and '.join(pair)}, 3 chains each: every one a "
            f"replay bit-equal to its eager chain; device chain ms " + "; ".join(
                f"{n} " + ", ".join(f"{r.device_ms:.2f}" for _, r in res)
                for n, res in out.items()))
    rows["concurrent"] = concurrent

    c = {k: getattr(codec_graph.reference, k) - getattr(ref0, k) for k in CODEC_COUNTERS}
    torch.cuda.synchronize()
    pool = ref_pool_mib(card.ref_graph_pool)
    if c["captures"] != len(card.ref_graphs) or sorted(card.ref_graphs) != sorted(card.ref_seen):
        raise AssertionError(f"reference graphs {sorted(card.ref_graphs)}, buckets run "
                             f"{sorted(card.ref_seen)}, counters {c}")
    rows["graphs"] = {"buckets": sorted(card.ref_graphs), "counters": c, "pool_mib": pool}
    log(f"[clone] reference graphs: buckets {sorted(card.ref_graphs)}, counters "
        f"eager={c['eager']} captures={c['captures']} capture={c['capture_ms']:.1f}ms "
        f"replays={c['replays']} replay={c['replay_ms']:.1f}ms; their own pool holds "
        + ("not measured" if pool is None else f"{pool:.0f} MiB") + " reserved")
    del card, cpu
    torch.cuda.empty_cache()
    return rows


def clone_cli(tmp: Path, refs: dict, dev, ccfg) -> dict:
    """The CLI's voice-cloning flags: a one-shot text request cloned from
    the 20 s reference (K1 and K2 grow, --tts-mio-embedding-out equals the
    in-process card embedding bit for bit), --tts-mio-embedding-only (an
    embedding, no WAV), and codes with --tts-mio-embedding-in of that
    embedding, whose decode meets the fidelity bar card vs CPU."""
    from miotts_tpu_torch.gguf.writer import load_embedding_gguf

    out = {}
    wavlm = ["--tts-wavlm-model", str(tmp / "wavlm.gguf")]
    text, n_codes, sr, pcm, grew, _ = drive_cli(
        "clone-text", tmp, ["-mv", str(tmp / "codec.gguf"), "-m", str(tmp / "llm.gguf"),
                            "-p", CLONE_PROMPT, "-n", "120", "--seed", "1",
                            "--tts-reference-audio", str(tmp / "ref20.wav"), *wavlm,
                            "--tts-mio-embedding-out", str(tmp / "e.gguf")], (k1, k2))
    m = re.search(r"reference breakdown: decode_ms=([0-9.]+) device_ms=([0-9.]+) bucket=(\d+) "
                  r"frames=(\d+) rung=(\w+)", text)
    e = load_embedding_gguf(tmp / "e.gguf")
    if (not m or m.group(5) != "ssl" or pcm.size != wav_samples(ccfg, n_codes)
            or not np.array_equal(e, refs["ref20.wav"]["embedding"])):
        raise AssertionError(f"clone one-shot: {m and m.groups()}, {pcm.size} samples for "
                             f"{n_codes} codes, e.gguf bit-equal "
                             f"{np.array_equal(e, refs['ref20.wav']['embedding'])}")
    out["one_shot"] = {"decode_ms": float(m.group(1)), "device_ms": float(m.group(2)),
                       "bucket": int(m.group(3)), "frames": int(m.group(4)), "codes": n_codes,
                       "audio_s": pcm.size / sr}
    log(f"[clone] CLI one-shot (ref20.wav, -n 120): reference breakdown decode_ms="
        f"{m.group(1)} device_ms={m.group(2)} bucket={m.group(3)} frames={m.group(4)} "
        f"rung={m.group(5)}; {n_codes} codes, {pcm.size / sr:.2f} s of audio; e.gguf "
        f"bit-equal to the in-process card embedding; {graph_text(text)} launches: "
        f"{launch_text(grew)}")

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["-mv", str(tmp / "codec.gguf"), "--tts-reference-audio",
                       str(tmp / "ref3.flac"), *wavlm, "--tts-mio-embedding-out",
                       str(tmp / "e_only.gguf"), "--tts-mio-embedding-only",
                       "-o", str(tmp / "e_only.wav")])
    e_only = load_embedding_gguf(tmp / "e_only.gguf") if (tmp / "e_only.gguf").exists() else None
    if (rc != 0 or (tmp / "e_only.wav").exists() or e_only is None
            or not np.array_equal(e_only, refs["ref3.flac"]["embedding"])
            or f"saved embedding: {tmp / 'e_only.gguf'}" not in err.getvalue()):
        raise AssertionError(f"--tts-mio-embedding-only: rc {rc}:\n{err.getvalue()}")
    log("[clone] --tts-mio-embedding-only (ref3.flac): an embedding bit-equal to the "
        "in-process card one, no WAV")

    text, n_codes, sr, pcm, grew, _ = drive_cli(
        "clone-codes", tmp, ["-mv", str(tmp / "codec.gguf"), "--tts-mio-codes-in",
                             str(tmp / "codes400.txt"), "--tts-mio-embedding-in",
                             str(tmp / "e.gguf")], (k1,))
    if pcm.size != wav_samples(ccfg, n_codes):
        raise AssertionError(f"clone codes: {pcm.size} samples for {n_codes} codes")
    log(f"[clone] codes (400) with --tts-mio-embedding-in e.gguf: {pcm.size / sr:.2f} s of "
        f"audio; launches: {launch_text(grew)}")
    with uncounted():
        fidelity(tmp / "codec.gguf", dev, np.random.RandomState(8).randint(0, ccfg.vocab_size,
                                                                           250),
                 e, ccfg.sample_rate, "clone")
    return out


def generate_reference(srv, tmp: Path, key: str, ref: str, multipart: bool, want) -> dict:
    """One /mio/generate_reference, JSON naming the file or a multipart
    upload of it: HTTP 200, the embedding attached and cached under
    ``key``, within CLONE_EMB_TOL of ``want`` (the in-process card's)."""
    from miotts_tpu_torch.gguf.writer import load_embedding_gguf

    if multipart:
        boundary = "miottsclonephase"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"reference_key\"\r\n\r\n"
                f"{key}\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"audio\"; "
                f"filename=\"{ref}\"\r\nContent-Type: application/octet-stream\r\n\r\n").encode()
        body += (tmp / ref).read_bytes() + f"\r\n--{boundary}--\r\n".encode()
        ctype = f"multipart/form-data; boundary={boundary}"
    else:
        body = json.dumps({"reference_key": key, "reference_audio": str(tmp / ref)}).encode()
        ctype = "application/json"
    status, headers, data, secs = http_post_raw(srv, "/mio/generate_reference", body, ctype)
    if status != 200:
        raise AssertionError(f"generate_reference {key}: HTTP {status}: {data[:300]!r}")
    p = tmp / f"served_{key}.emb.gguf"
    p.write_bytes(data)
    emb = load_embedding_gguf(p)
    err = float(np.abs(emb - want).max())
    if (headers.get("X-Reference-Key") != key or not err <= CLONE_EMB_TOL
            or not np.array_equal(srv.engine.ref_cache.get(key), emb)):
        raise AssertionError(f"generate_reference {key}: headers {headers}, max abs {err}")
    return {"latency_ms": secs * 1e3, "max_abs_err": err, "multipart": multipart}


def clone_server(dev, tmp: Path, refs: dict) -> dict:
    """A ``--tts-wavlm-model`` server (-np 2, --parallel-reference-generation
    2): /mio/generate_reference as JSON and as a multipart upload (each
    bucket's eager chain), text /mio/tts/stream requests with the generated
    key, then two generations concurrent with two text /mio/tts requests
    (the buckets' captures), two generations alone and two more beside two
    text requests (replays), with no failure, each bucket captured once."""
    import concurrent.futures

    out: dict = {}
    srv = start_server(dev, tmp, "llm.gguf",
                       ["-np", "2", "-n", "120", "--ctx-size", "512", "--warmup", "on",
                        "--tts-wavlm-model", str(tmp / "wavlm.gguf"),
                        "--parallel-reference-generation", "2"])
    try:
        out["json"] = generate_reference(srv, tmp, "clone_json", "ref20.wav", False,
                                         refs["ref20.wav"]["embedding"])
        out["multipart"] = generate_reference(srv, tmp, "clone_upload", "ref3.wav", True,
                                              refs["ref3.wav"]["embedding"])
        log(f"[clone server] generate_reference JSON (ref20.wav) {out['json']['latency_ms']:.1f} "
            f"ms, max abs vs in-process {out['json']['max_abs_err']:.2e}; multipart (ref3.wav) "
            f"{out['multipart']['latency_ms']:.1f} ms, {out['multipart']['max_abs_err']:.2e}")
        streams = []
        for i, key in enumerate(("clone_json", "clone_upload")):
            status, headers, data, secs = http_post(
                srv, "/mio/tts/stream", {"text": CLONE_PROMPT, "reference_key": key,
                                         "seed": 40 + i})
            sr, pcm = parse_wav_bytes(data, f"cloned stream {key}")
            if status != 200 or headers.get("X-Reference-Key") != key or not np.any(pcm != 0):
                raise AssertionError(f"cloned stream {key}: HTTP {status}")
            streams.append({"key": key, "latency_ms": secs * 1e3, "audio_s": pcm.size / sr})
        out["streams"] = streams
        log("[clone server] /mio/tts/stream with the generated keys: " + ", ".join(
            f"{s['key']} {s['latency_ms']:.1f} ms for {s['audio_s']:.2f} s" for s in streams))

        def text_request(i):
            status, _, data, secs = http_post(srv, "/mio/tts", {
                "text": SERVER_TEXTS[i], "reference_key": "clone_json", "seed": 50 + i})
            j = json.loads(data)
            if status != 200 or not j.get("ok"):
                raise AssertionError(f"text request {i} during generations: HTTP {status} {j}")
            return {"latency_ms": secs * 1e3, "llm_ms": j["llm_ms"], "synth_ms": j["synth_ms"]}

        def beside_text(tag: str) -> dict:
            """Two generations (ref20.wav, ref3.flac) concurrent with two text
            requests."""
            with concurrent.futures.ThreadPoolExecutor(4) as ex:
                gens = [ex.submit(generate_reference, srv, tmp, f"clone_{tag}{i}", ref, i == 1,
                                  refs[ref]["embedding"])
                        for i, ref in enumerate(("ref20.wav", "ref3.flac"))]
                texts = [ex.submit(text_request, i) for i in range(2)]
                failed, res = [], {"generations": [], "texts": []}
                for kind, futs in (("generations", gens), ("texts", texts)):
                    for f in futs:
                        try:
                            res[kind].append(f.result())
                        except Exception as e:  # counted, then raised below
                            failed.append(repr(e))
            log(f"[clone server] 2 generations concurrent with 2 text requests ({tag}): "
                f"{len(failed)} failed; generations " + ", ".join(
                    f"{g['latency_ms']:.1f} ms" for g in res["generations"])
                + "; text llm_ms/synth_ms " + ", ".join(
                    f"{t['llm_ms']:.1f}/{t['synth_ms']:.1f}" for t in res["texts"]))
            if failed:
                raise AssertionError(f"concurrent generations and text requests: {failed}")
            return {**res, "failed": len(failed)}

        # both buckets (320 000 and 64 000) ran eagerly above: these two
        # generations capture their graphs, every later one replays
        pipe = srv.engine.pipeline
        c0 = dataclasses.replace(codec_graph.reference)
        out["concurrent"] = beside_text("c")
        out["alone_replays"] = [
            generate_reference(srv, tmp, f"clone_r{i}", ref, False, refs[ref]["embedding"])
            for i, ref in enumerate(("ref20.wav", "ref3.wav"))]
        out["concurrent_replays"] = beside_text("cr")
        c = {k: getattr(codec_graph.reference, k) - getattr(c0, k) for k in CODEC_COUNTERS}
        if (sorted(pipe.ref_graphs) != [64000, 320000] or c["captures"] != 2
                or c["replays"] != 6 or c["eager"]):
            raise AssertionError(f"the server's reference chains: graphs "
                                 f"{sorted(pipe.ref_graphs)}, counters {c}")
        out["reference_graphs"] = {"counters": c, "pool_mib": ref_pool_mib(pipe.ref_graph_pool)}
        log(f"[clone server] generate_reference alone on a replay: " + ", ".join(
            f"{g['latency_ms']:.1f} ms" for g in out["alone_replays"])
            + f" (ref20.wav, ref3.wav); reference graphs: captures={c['captures']} "
            f"capture={c['capture_ms']:.1f}ms replays={c['replays']} eager={c['eager']}, pool "
            + ("not measured" if out["reference_graphs"]["pool_mib"] is None
               else f"{out['reference_graphs']['pool_mib']:.0f} MiB"))
        out["bridge"] = bridge_clone(srv, tmp, refs["ref3.mp3"]["embedding"])
    finally:
        srv.shutdown()
    del srv
    torch.cuda.empty_cache()
    return out


def bridge_clone(srv, tmp: Path, want: np.ndarray) -> dict:
    """The port's C client bridge (``miotts_tpu_torch.bindings``, a ctypes
    wrapper over the g++-built ``mio_tpu_client`` library) against the
    running server: ``ref3.mp3`` uploaded through
    ``mio_tpu_client_create_reference_from_audio`` (the server decodes it
    natively; the returned embedding within CLONE_EMB_TOL of ``want``, the
    in-process card one), then one text request in that voice through
    ``mio_tpu_client_synthesize_to_wav``: a WAV back, K1 and K2 launched."""
    from miotts_tpu_torch.bindings import MioTPUClient
    from miotts_tpu_torch.bindings.client import library_path
    from miotts_tpu_torch.gguf.writer import load_embedding_gguf

    row: dict = {"library": library_path().name}
    with MioTPUClient(f"http://127.0.0.1:{srv.port}") as c:
        m0 = native.calls["mio_mp3_decode"]
        t0 = time.perf_counter()
        c.create_reference_from_audio("bridge_mp3", str(tmp / "ref3.mp3"),
                                      embedding_out_path=str(tmp / "bridge_mp3.emb.gguf"))
        row["upload_ms"] = (time.perf_counter() - t0) * 1e3
        emb = load_embedding_gguf(tmp / "bridge_mp3.emb.gguf")
        row["max_abs_err"] = float(np.abs(emb - want).max())
        row["native_mp3_decodes"] = native.calls["mio_mp3_decode"] - m0
        if row["native_mp3_decodes"] != 1 or not row["max_abs_err"] <= CLONE_EMB_TOL:
            raise AssertionError(f"[clone server] the bridge's mp3 upload: {row}")
        c.set_generation_params(seed=60)
        l0 = {m: m.launches for m in MODS}
        t0 = time.perf_counter()
        c.synthesize_to_wav(CLONE_PROMPT, "bridge_mp3", str(tmp / "bridge_mp3.wav"))
        row["synthesize_ms"] = (time.perf_counter() - t0) * 1e3
    sr, pcm = parse_wav_bytes((tmp / "bridge_mp3.wav").read_bytes(), "the bridge's WAV")
    row["launches"] = {m.__name__.rsplit(".", 1)[-1]: m.launches - l0[m] for m in MODS}
    row["audio_s"] = pcm.size / sr
    if (not np.any(pcm != 0) or not row["launches"]["banded_attention"]
            or not row["launches"]["decode_attention"]):
        raise AssertionError(f"[clone server] the bridge's text request: {row}")
    log(f"[clone server] port's C client bridge ({row['library']}): ref3.mp3 uploaded through "
        f"mio_tpu_client_create_reference_from_audio in {row['upload_ms']:.1f} ms (decoded "
        f"natively, max abs vs in-process {row['max_abs_err']:.2e}); "
        f"mio_tpu_client_synthesize_to_wav in that voice {row['synthesize_ms']:.1f} ms for "
        f"{row['audio_s']:.2f} s of audio; launches: K1 {row['launches']['banded_attention']}, "
        f"K2 {row['launches']['decode_attention']}")
    return row


def check_clone(dev, tmp: Path, ccfg) -> dict:
    """The clone phase: references card vs CPU, the CLI's flags, the server."""
    t0 = time.perf_counter()
    refs = check_references(dev, tmp)
    out = {"references": {k: {kk: vv for kk, vv in v.items() if kk != "embedding"}
                          for k, v in refs.items()}}
    out["cli"] = clone_cli(tmp, refs, dev, ccfg)
    out["server"] = clone_server(dev, tmp, refs)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[clone] {out['wall_s']:.1f}s")
    return out


# -- the server phase --------------------------------------------------------------------

SERVER_TOKENS = 250  # random weights: every request runs its whole budget, 10 s of audio
SERVER_FLAGS = ["-np", "8", "-n", str(SERVER_TOKENS), "--ctx-size", "512"]
SERVER_TEXTS = tuple(f"Request {i}: the quick brown fox jumps over the lazy dog, {w}."
                     for i, w in enumerate(("once", "twice", "thrice", "again", "slowly",
                                            "quickly", "quietly", "loudly")))
SERVER_ROUNDS = (1, 4, 8)  # concurrency of the timed rounds, two rounds each


def parse_wav_bytes(data: bytes, what: str) -> tuple[int, np.ndarray]:
    """(sample rate, int16 samples) of a mono 16-bit WAV held in memory."""
    riff, size, wave, fmt, _, pcm, ch, sr, _, _, bits, tag, n = struct.unpack_from(
        "<4sI4s4sIHHIIHH4sI", data)
    if (riff, wave, fmt, tag, pcm, ch, bits) != (b"RIFF", b"WAVE", b"fmt ", b"data", 1, 1, 16):
        raise AssertionError(f"{what}: not a mono 16-bit PCM WAV")
    if size != 36 + n or len(data) != 44 + n:
        raise AssertionError(f"{what}: RIFF sizes do not match the body")
    return sr, np.frombuffer(data[44:], "<i2")


def start_server(dev, tmp: Path, llm: str | None, flags: list[str]):
    """The port's MioTTSServer in this process on port 0 (so its launch
    counters are readable), built from the server's own flags; ``llm``
    None serves without a local LLM."""
    from miotts_tpu_torch.serving import server as server_mod

    argv = ["-mv", str(tmp / "codec.gguf"), *(["-m", str(tmp / llm)] if llm else []),
            "--port", "0", "--output-dir", str(tmp / "server_out"),
            "--reference-file", json.dumps({"key": "voice", "path": str(tmp / "voice.emb.gguf")}),
            *flags]
    srv = server_mod.MioTTSServer(
        server_mod.config_from_args(server_mod.build_arg_parser().parse_args(argv)), dev)
    srv.start_background()
    return srv


def http_post(srv, path: str, body: dict, timeout: float = 300):
    """POST JSON; returns (status, headers, body bytes, seconds)."""
    return http_post_raw(srv, path, json.dumps(body).encode(), "application/json", timeout)


def http_post_raw(srv, path: str, body: bytes, ctype: str, timeout: float = 300):
    """POST a body of ``ctype``; returns (status, headers, body bytes, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read(), time.perf_counter() - t0


def sse_audio(srv, text: str, seed: int, first_chunk: int = 12) -> dict:
    """One SSE stream_audio request with its token events: the time to its
    first token event (the fused prefill's tokens), to its first token that
    a chunk made (index ``first_chunk``), to its first audio_chunk event
    (TTFA), and the audio it delivered."""
    import urllib.request

    body = {"text": text, "reference_key": "voice", "stream_tokens": True,
            "stream_audio": True, "seed": seed}
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/mio/tts/stream",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttfa = first_tok = chunk_tok = None
    n_samples, events = 0, {}
    with urllib.request.urlopen(req, timeout=300) as r:
        event = None
        for raw in r:
            line = raw.decode().rstrip("\n")
            now = (time.perf_counter() - t0) * 1e3
            if line.startswith("event: "):
                event = line[7:]
                events[event] = events.get(event, 0) + 1
                if event == "audio_chunk" and ttfa is None:
                    ttfa = now
            elif line.startswith("data: ") and event == "audio_chunk":
                n_samples += json.loads(line[6:])["n_samples"]
            elif line.startswith("data: ") and event == "token":
                i = json.loads(line[6:])["i"]
                first_tok = now if first_tok is None else first_tok
                if i >= first_chunk and chunk_tok is None:
                    chunk_tok = now
    if "error" in events or not n_samples or ttfa is None:
        raise AssertionError(f"SSE stream_audio request {seed}: events {events}, "
                             f"{n_samples} samples")
    return {"ttfa_ms": ttfa, "first_token_ms": first_tok, "first_chunk_token_ms": chunk_tok,
            "samples": n_samples, "wall_s": time.perf_counter() - t0, "events": events}


def binary_tts(srv, text: str, seed: int, what: str, extra: dict | None = None) -> dict:
    """One text /mio/tts/stream binary request: a WAV that parses and is not
    silent; its slot, latency and audio seconds."""
    status, headers, data, secs = http_post(
        srv, "/mio/tts/stream", {"text": text, "reference_key": "voice", "seed": seed,
                                 **(extra or {})})
    if status != 200:
        raise AssertionError(f"{what}: HTTP {status}: {data[:300]!r}")
    sr, pcm = parse_wav_bytes(data, what)
    if not np.any(pcm != 0):
        raise AssertionError(f"{what}: the WAV is silent")
    return {"slot": int(headers["X-Slot"]), "latency_s": secs, "audio_s": pcm.size / sr,
            "pcm": pcm}


def concurrent_round(srv, n: int, what: str, offset: int = 0) -> dict:
    """n text binary requests at once: aggregate audio-s per s, latencies,
    distinct slots, the engine's mean llm_ms and synth_ms, the batcher's
    attach holds (count and ms), and the round's K1 and K2 launches and
    chunks by width."""
    import concurrent.futures

    eng = srv.engine
    b = eng.batcher
    llm0, synth0, req0 = eng.llm_ms_total, eng.synth_ms_total, eng.requests_total
    holds0, hold_ms0 = b.attach_holds, b.attach_hold_ms
    k1_0, k2_0, widths0 = k1.launches, k2.launches, dict(b.width_counts)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        res = list(ex.map(lambda i: binary_tts(srv, SERVER_TEXTS[(offset + i) % 8], offset + i,
                                               f"{what} request {i}"), range(n)))
    wall = time.perf_counter() - t0
    slots = [r["slot"] for r in res]
    if len(set(slots)) != n:
        raise AssertionError(f"{what}: slots {slots} are not distinct")
    full = wav_samples(eng.pipeline.config, SERVER_TOKENS) / eng.pipeline.sample_rate
    if min(r["audio_s"] for r in res) < full:
        raise AssertionError(f"{what}: audio of {[r['audio_s'] for r in res]} s, not every "
                             f"request the {full} s of its {SERVER_TOKENS} tokens")
    n_req = eng.requests_total - req0
    return {"wall_s": wall, "audio_s": sum(r["audio_s"] for r in res),
            "latencies_s": [r["latency_s"] for r in res],
            "llm_ms": (eng.llm_ms_total - llm0) / n_req,
            "synth_ms": (eng.synth_ms_total - synth0) / n_req,
            "attach_holds": b.attach_holds - holds0, "attach_hold_ms": b.attach_hold_ms - hold_ms0,
            "k1": k1.launches - k1_0, "k2": k2.launches - k2_0,
            "widths": {wd: c - widths0.get(wd, 0) for wd, c in sorted(b.width_counts.items())
                       if c > widths0.get(wd, 0)}}


def round_stats(rs: list[dict]) -> dict:
    lat = [x for r in rs for x in r["latencies_s"]]
    return {"audio_s_per_s": sum(r["audio_s"] for r in rs) / sum(r["wall_s"] for r in rs),
            "rounds_audio_s_per_s": [r["audio_s"] / r["wall_s"] for r in rs],
            "p50_ms": pct(lat, 50), "p90_ms": pct(lat, 90),
            "llm_ms": float(np.mean([r["llm_ms"] for r in rs])),
            "synth_ms": float(np.mean([r["synth_ms"] for r in rs])),
            "audio_s": sum(r["audio_s"] for r in rs) / len(lat),
            "attach_holds": [r["attach_holds"] for r in rs],
            "attach_hold_ms": [r["attach_hold_ms"] for r in rs],
            "k1_per_request": sum(r["k1"] for r in rs) / len(lat),
            "k2_per_request": sum(r["k2"] for r in rs) / len(lat),
            "widths": [r["widths"] for r in rs]}


def round_text(n: int, r: dict) -> str:
    return (f"audio-s/s {r['audio_s_per_s']:.2f} (rounds "
            f"{', '.join(f'{x:.2f}' for x in r['rounds_audio_s_per_s'])}), latency p50 "
            f"{r['p50_ms']:.1f} ms p90 {r['p90_ms']:.1f} ms, llm_ms {r['llm_ms']:.1f} synth_ms "
            f"{r['synth_ms']:.1f}, {r['audio_s']:.2f} s of audio a request, attach holds "
            f"{r['attach_holds']} ({', '.join(f'{x:.1f}' for x in r['attach_hold_ms'])} ms), "
            f"launches a request K1 {r['k1_per_request']:.1f} K2 {r['k2_per_request']:.1f}, "
            f"chunks by width {r['widths']}")


def width_lanes(b, live: int, width: int) -> np.ndarray:
    """A sliced chunk's lane list: lanes 0..live-1, then distinct pad lanes
    (n_lanes + lane) outside them."""
    return np.array(list(range(live)) + [b.n_lanes + i for i in range(live, width)], np.int64)


def chunk_device_ms(srv, occupancy: int) -> dict:
    """Device ms of one replay of the batcher's chunk_max graph at the width
    it picks for ``occupancy`` live lanes (the server idle), median of 3 by
    CUDA events."""
    b = srv.engine.batcher
    st, rung = b.state, b.chunk_max
    width = b._pick_width(rung, occupancy) or b.n_lanes
    g = b.chunks[(rung, width)]
    times = []
    with b._cv:
        if width < b.n_lanes:
            b._lanes_bufs[width].copy_(torch.from_numpy(width_lanes(b, occupancy, width)))
        for _ in range(3):
            st.done.fill_(True)
            st.done[:occupancy] = False
            st.pos.fill_(300)
            b.rem.fill_(0)
            b.rem[:occupancy] = rung
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            g.run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        st.done.fill_(True)
        b.rem.fill_(0)
    return {"width": width, "ms": sorted(times)[1]}


# (width, live lanes) of the width graphs' replay-vs-eager check: width 4
# holds a pad lane; the full width five live lanes
WIDTH_CASES = ((1, 1), (2, 2), (4, 3), (8, 5))
WIDTH_SAMPLERS = (SamplerParams(temp=0.0), SamplerParams(temp=0.8, top_k=50, repeat_penalty=1.1),
                  SamplerParams(temp=0.0, repeat_penalty=1.1), SamplerParams(temp=0.8, top_k=50),
                  SamplerParams(temp=1.0, top_p=0.9))


def check_width_graphs(srv) -> dict:
    """Each width's graph (the middle rung) replayed from a state with live
    lanes (prompts prefilled and attached; greedy, sampled and penalty-1.1
    lanes) equals the eager width-w body run from the same state, bit for
    bit: tokens, counts and every state tensor. Then, reported: the width-1
    body against the full-width body from the one-lane state (tokens in
    common, the lane's final logits' max abs gap)."""
    from miotts_tpu_torch.models.llm import CHAT_TEMPLATE, attach_lanes, llm_prefill_kv

    b, llm = srv.engine.batcher, srv.engine.llm
    cfg, w, dev, rung = b.cfg, llm.weights, b.device, b.chunk
    out, one_lane = {}, None

    def eager(width):
        return tuple(t.clone() for t in b.chunks[(rung, width)].run_eager())

    def load(values):
        for k, t in vars(b.state).items():
            t.copy_(values[k])

    with b._cv:
        torch.cuda.synchronize()
        for width, live in WIDTH_CASES:
            width = min(width, b.n_lanes)
            ids = [llm.tokenizer.encode(CHAT_TEMPLATE.format(text=SERVER_TEXTS[i]),
                                        parse_special=True) for i in range(live)]
            toks = np.zeros((live, max(map(len, ids))), np.int64)
            for i, x in enumerate(ids):
                toks[i, :len(x)] = x
            lens = np.array([len(x) for x in ids], np.int32)
            logits, kk, vv = llm_prefill_kv(cfg, w, torch.from_numpy(toks).to(dev),
                                            torch.from_numpy(lens).to(dev))
            b.state.done.fill_(True)
            attach_lanes(b.state, np.arange(live), logits, kk, vv, lens, np.arange(live) + 11)
            for i in range(live):
                b.sampler.set_lane(i, WIDTH_SAMPLERS[i])
            b.rem.zero_()
            b.rem[:live] = 200
            if width < b.n_lanes:
                b._lanes_bufs[width].copy_(torch.from_numpy(width_lanes(b, live, width)))
            s0 = {k: t.clone() for k, t in vars(b.state).items()}
            o1, n1 = (t.clone() for t in b.chunks[(rung, width)].run())
            s1 = {k: t.clone() for k, t in vars(b.state).items()}
            load(s0)
            o2, n2 = eager(width)
            torch.cuda.synchronize()
            diff = [k for k, t in vars(b.state).items() if not torch.equal(t, s1[k])]
            if not (torch.equal(o1, o2) and torch.equal(n1, n2)) or diff:
                raise AssertionError(f"width {width} ({live} live): the replay differs from the "
                                     f"eager body (tokens equal: {torch.equal(o1, o2)}, state "
                                     f"tensors that differ: {diff})")
            out[width] = {"live": live, "tokens": int(n1.sum())}
            pads = width - live if width < b.n_lanes else 0
            log(f"[server] width {width} ({live} live lanes, {pads} pad): "
                f"one {rung}-step replay equals the eager width-{width} body bit for bit "
                f"({int(n1.sum())} tokens, every state tensor)")
            if width == 1:
                one_lane = (s0, o2, b.state.logits[0].clone())
        # width 1 against the full width from the one-lane state (reported)
        s0, o_w1, logits_w1 = one_lane
        load(s0)
        o_full, _ = eager(b.n_lanes)
        gap = (b.state.logits[0] - logits_w1).abs().max().item()
        a, c = o_w1[0].tolist(), o_full[0].tolist()
        same = next((i for i, (x, y) in enumerate(zip(a, c)) if x != y), len(a))
        out["width1_vs_full"] = {"tokens_in_common": same, "of": len(a), "logits_max_abs_gap": gap}
        log(f"[server] one lane, width 1 vs the full width ({b.n_lanes}): {same} of {len(a)} "
            f"greedy tokens in common, final logits max abs gap {gap:.3e} (reported)")
        b.state.done.fill_(True)
        b.rem.zero_()
        torch.cuda.synchronize()
    return out


def check_fused_graphs(srv) -> dict:
    """Each fused first-chunk graph (k = 1, 2, 4, 8 lanes), replayed after
    the prefill of k prompts (greedy, sampled and penalty-1.1 lanes),
    equals its eager body from the same prefill into a fresh state of the
    same max_ctx rows, bit for bit: tokens, counts, done, pos, ring, key,
    logits and each lane's cache rows below its pos."""
    from miotts_tpu_torch.models.llm import CHAT_TEMPLATE, NO_BUDGET, fused_state, prefill_into
    from miotts_tpu_torch.models.sampling import BatchSamplerParams

    b, llm = srv.engine.batcher, srv.engine.llm
    cfg, w, eog, dev = b.cfg, llm.weights, llm.eog_ids, b.device
    out = {}
    for k in sorted(b._fused):
        ids = [llm.tokenizer.encode(CHAT_TEMPLATE.format(text=SERVER_TEXTS[i]),
                                    parse_special=True) for i in range(k)]
        toks = np.zeros((k, max(map(len, ids))), np.int64)
        for i, x in enumerate(ids):
            toks[i, :len(x)] = x
        lens = np.array([len(x) for x in ids], np.int32)
        seeds = np.arange(k, dtype=np.int64) + 20
        params = [WIDTH_SAMPLERS[i % len(WIDTH_SAMPLERS)] for i in range(k)]
        fetch, gst, event = b._prefill_fused(toks, lens, seeds, params)
        o1, n1, d1 = finish_chunk_fetch(fetch)
        event.synchronize()
        sampler = BatchSamplerParams.make([p.temp for p in params], [p.top_k for p in params],
                                          [p.top_p for p in params],
                                          [p.repeat_penalty for p in params], dev)
        st = prefill_into(cfg, w, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                          seeds, fused_state(cfg, k, b.max_ctx, dev))
        o2, n2 = chunk(cfg, w, eog, b.first_chunk, sampler, st,
                       rem=torch.full((k,), NO_BUDGET, dtype=torch.int32, device=dev)).run_eager()
        torch.cuda.synchronize()
        # a lane's cache rows below its pos: the rows decode reads (those at
        # or above it hold an earlier group's values in the graph's state,
        # zeros in a fresh one, and are written before they are read)
        pos = st.pos.tolist()
        same = {"tokens": np.array_equal(o1, o2.cpu().numpy()),
                "n_new": np.array_equal(n1, n2.cpu().numpy()),
                "done": np.array_equal(d1, st.done.cpu().numpy()),
                **{f: bool(torch.equal(getattr(gst, f), getattr(st, f)))
                   for f in ("pos", "ring", "key", "logits")},
                "cache": all(torch.equal(g[:, i, :p], e[:, i, :p])
                             for g, e in ((gst.cache_k, st.cache_k), (gst.cache_v, st.cache_v))
                             for i, p in enumerate(pos))}
        if not all(same.values()):
            raise AssertionError(f"fused graph k={k}: the replay differs from the eager body: "
                                 f"{same}")
        out[k] = int(n1.sum())
        log(f"[server] fused first chunk, k={k}: the replay after a prefill of {k} prompts "
            f"equals the eager body bit for bit ({int(n1.sum())} tokens; done, pos, ring, key, "
            f"logits, each lane's cache rows below its pos {pos})")
    return out


def width2_pair(b, text: str, neighbour: str) -> list[int]:
    """Seed 7's tokens beside one neighbour, both prefilled in one group of
    two and run at width 2 from their attach to their end: a one-token
    request is prefilled first while the fused path's lock is held, so
    both queue before the prefill thread drains again."""
    groups = []
    real = b._prefill_group

    def spy(bucket, group):
        groups.append(len(group))
        return real(bucket, group)

    b._prefill_group = spy
    try:
        with b._fused_lock:
            hold = b.submit("hold", SamplerParams(temp=0.0), n_predict=1)
            time.sleep(0.3)
            mine = b.submit(text, SamplerParams(temp=0.8, top_k=50, seed=7), n_predict=250,
                            early_tokens=False)
            other = b.submit(neighbour, SamplerParams(temp=0.8, top_k=50, seed=8),
                             n_predict=250, early_tokens=False)
        hold.collect()
        toks = mine.collect()
        other.collect()
    finally:
        del b._prefill_group
    if groups != [1, 2]:
        raise AssertionError(f"width-2 pair: prefill groups {groups}, not [1, 2]")
    return toks


def k2_at_server_s(dev, gen, S: int, B: int = 8, KVH: int = 2, what: str = "[server]") -> dict:
    """K2 at a server's cache rows and a chunk width B, ragged positions,
    over KVH kv heads of 6 query heads each (2: the 0.1B LLM; 1: a tp=2
    rank's): against its plain version, timed beside its bound and one
    SDPA call over the whole cache and this step's k/v, masked to each
    lane's positions (GQA)."""
    G, HD = 6, 64
    bf = torch.bfloat16
    q = torch.randn(B, KVH, G, HD, generator=gen).to(dev, bf)
    kc, vc = (torch.randn(B, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
    ck, cv = (torch.randn(B, S, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
    pos_l = [int(p) for p in np.linspace(S - 1, 40, B)]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    args = (q, kc, vc, ck, cv, 1.0 / math.sqrt(HD), pos)
    err = (k2.decode_attention(*args).float() - k2.decode_attention_plain(*args).float()
           ).abs().max().item()
    ms = cuda_ms(lambda: k2.decode_attention(*args))
    plain = cuda_ms(lambda: k2.decode_attention_plain(*args))
    keys = torch.cat([ck, kc[:, None]], 1).transpose(1, 2).contiguous()
    vals = torch.cat([cv, vc[:, None]], 1).transpose(1, 2).contiguous()
    j = torch.arange(S + 1, device=dev)
    mask = ((j[None, :] < pos[:, None]) | (j[None, :] == S))[:, None, None, :]
    qh = q.reshape(B, KVH * G, 1, HD)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, keys, vals, attn_mask=mask,
                                                         enable_gqa=True))
    nbytes = sum(2 * (2 * (p + 1) * KVH * HD + KVH * G * HD) + 2 * KVH * G * HD + 4 for p in pos_l)
    ops = sum(4 * (p + 1) * KVH * G * HD for p in pos_l)
    bound = least_time(nbytes, ops, BF16_FLOP_S)
    if not err <= K2_TOL:
        raise AssertionError(f"K2 error {err} > {K2_TOL} at the server's S={S} B={B}")
    log(f"{what} K2 at B={B} S={S} KVH={KVH} pos={pos_l} launch={k2.launch_shape(B, S, KVH)}: "
        f"max_abs_err={err:.3e} kernel={ms:.4f}ms plain={plain:.4f}ms "
        f"SDPA(masked cache, GQA)={lib:.4f}ms bound={bound['bound_ms']:.5f}ms "
        f"({bound['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib, **bound, "S": S,
            "B": B}


def k1_at_server(dev, gen, cfg, bucket: int, B: int = 8) -> dict:
    """K1 at a served codec group's trunk shapes: B lanes of ragged length
    in the prenet (T = the codes bucket) and the decoder (T = twice it),
    each against its plain version; the decoder's timed."""
    out = {}
    for stack, H, T in (("prenet", cfg.prenet_heads, bucket),
                        ("decoder", cfg.decoder_heads, 2 * bucket)):
        lens = [int(n) for n in np.linspace(T, T // 4, B)]
        err, q, k, v, lengths = k1_case(dev, gen, B, T, H, 64, lens)
        out[f"{stack}_max_abs_err"] = err
    mask = band_mask(T, lengths)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_ms(lambda: k1.banded_attention(q, k, v, lengths, K1_WINDOW))
    plain = cuda_ms(lambda: k1.banded_attention_plain(q, k, v, lengths, K1_WINDOW))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    bound = least_time(4 * 4 * B * T * H * 64 + 4 * B, 4 * 64 * H * int(mask.sum()), F32_FLOP_S)
    log(f"[server] K1 at B={B} H={H} T={T} lengths={lens}: prenet max_abs_err="
        f"{out['prenet_max_abs_err']:.3e}, decoder max_abs_err={err:.3e} kernel={ms:.4f}ms "
        f"plain={plain:.4f}ms SDPA(band mask)={lib:.4f}ms bound={bound['bound_ms']:.5f}ms "
        f"({bound['bound_by']})")
    return {**out, "ms": ms, "plain_ms": plain, "library_ms": lib, **bound, "B": B, "T": T}


def k3_at_lanes(dev, gen, T: int) -> dict:
    """K3 at T = the q8_0 server's lanes on every Q8_0 matmul of the 0.1B
    LLM (bf16 x, as the served model gives it), each against its plain
    version and timed: leaf -> [kernel, plain, dense bf16 cuBLAS, bound] ms."""
    worst, rows = 0.0, {}
    for leaf, K, N in k3_shapes():
        q, s, w_bf16, w_abs = k3_weights(dev, gen, K, N)
        x = torch.randn(T, K, generator=gen).to(dev, torch.bfloat16)
        err, ratio, plan = k3_case(leaf, x, q, s, w_abs)
        worst = max(worst, err)
        rows[leaf] = [cuda_ms(lambda: k3.q8_matmul(x, q, s)),
                      cuda_ms(lambda: k3.q8_matmul_plain(x, q, s)),
                      cuda_ms(lambda: x @ w_bf16), k3_bound(T, K, N)["bound_ms"]]
        log(f"[server] K3 {leaf} K={K} N={N} T={T} launch={tuple(plan)}: max_abs_err={err:.3e} "
            f"err/bound<={ratio:.3e} kernel={rows[leaf][0]:.4f}ms plain={rows[leaf][1]:.4f}ms "
            f"dense_bf16={rows[leaf][2]:.4f}ms bound={rows[leaf][3]:.5f}ms")
    return {"max_abs_err": worst, "T": T, "by_leaf_ms": rows}


def unfused_rounds(srv, req: dict, codes_of, common) -> dict:
    """The unfused submit path (MIOTTS_FUSED_PREFILL=0, or a prompt bucket
    with no room for the first chunk): ``llm_prefill_kv`` on the prefill
    stream, then the worker's attach after its event. With fusing off,
    every prefill group must take it: a concurrency-4 round (default
    slicing) whose requests all run their 250 tokens and launch K2, and
    seed 7 alone == among 7 neighbours with slicing off too (both runs at
    B = 8, as in the fused check)."""
    import concurrent.futures

    b = srv.engine.batcher
    calls = {"unfused": 0, "fused": 0}
    plain, fused = b._prefill, b._prefill_fused

    def count_plain(*a):
        calls["unfused"] += 1
        return plain(*a)

    def count_fused(*a):
        calls["fused"] += 1
        return fused(*a)

    out: dict = {}
    b.fused_prefill = False
    b._prefill, b._prefill_fused = count_plain, count_fused
    try:
        out["conc4"] = round_stats([concurrent_round(srv, 4, "unfused round", offset=4)])
        if out["conc4"]["k2_per_request"] <= 0 or calls["unfused"] == 0 or calls["fused"]:
            raise AssertionError(f"unfused round: prefill groups {calls}, K2 "
                                 f"{out['conc4']['k2_per_request']} a request")
        log(f"[server] MIOTTS_FUSED_PREFILL=0, concurrency 4 ({calls['unfused']} unfused prefill "
            f"groups): {round_text(4, out['conc4'])}")
        b.slice_chunks = False
        try:
            alone = codes_of(req)
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                first = ex.submit(codes_of, req)
                time.sleep(0.3)
                others = [ex.submit(codes_of, {**req, "seed": 100 + i,
                                               "text": SERVER_TEXTS[i + 1]}) for i in range(7)]
                among = first.result()
                [f.result() for f in others]
        finally:
            b.slice_chunks = True
        if among != alone or calls["fused"]:
            raise AssertionError(f"lane independence, unfused: seed 7 gave {len(alone)} codes "
                                 f"alone and {len(among)} among neighbours, equal for "
                                 f"{common(alone, among)}; prefill groups {calls}")
    finally:
        b.fused_prefill = True
        b._prefill, b._prefill_fused = plain, fused
    out["lane_independence_codes"] = len(alone)
    out["prefill_groups"] = calls
    log(f"[server] seed 7, unfused, slicing off: {len(alone)} codes alone == among 7 concurrent "
        f"neighbours, bit for bit ({calls['unfused']} unfused prefill groups in all)")
    return out


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def fused_metrics(eng) -> dict:
    """``miotts_llm_fused_launches_total`` by kernel, as /metrics reads it."""
    prefix = 'miotts_llm_fused_launches_total{kernel="'
    return {line[len(prefix):].split('"', 1)[0]: int(float(line.rsplit(" ", 1)[1]))
            for line in eng.metrics_text().splitlines() if line.startswith(prefix)}


def served_fused(eng, grew: dict, scraped0: dict) -> dict:
    """The served requests' K7-K11 launches: K11 12 : 24 : 12 : 1 a step and
    K7-K9 none, as /metrics reads them, and every chunk graph and fused
    first chunk of the batcher counts norm_qkv / gemv_residual / norm_gateup
    / norm_head 12 / 24 / 12 / 1, K7-K9 none and K10 once a step into each
    replay."""
    b = eng.batcher
    check_fused_ratio("server", grew, True, served_only=True)
    scraped = {k: n - scraped0.get(k, 0) for k, n in fused_metrics(eng).items()}
    if scraped != {k.name: n for k, n in grew.items()}:
        raise AssertionError(f"/metrics read K7-K11 {scraped}, the counters {launch_text(grew)}")
    graphs_ = [(f"chunk {key}", g) for key, g in b.chunks.items()]
    graphs_ += [(f"fused first chunk k={k}", g) for k, (g, _) in b._fused.items()]
    layers = LLM_WIDTHS["n_layers"]
    for name, g in graphs_:
        per = [g.launches_per_replay[k] for k in FUSED + GEMV]
        want = [0, 0, 0, g.n_steps] + [n * g.n_steps for n in (layers, 2 * layers, layers, 1)]
        if per != want:
            raise AssertionError(f"{name}: K7/K8/K9/K10 and K11 {per} a replay of {g.n_steps} "
                                 f"steps, not {want}")
    steps = grew[GEMV[0]] / layers
    log(f"[server] the served requests launched {launch_text(grew)} (/metrics the same): "
        f"{steps:.0f} decode steps at K11 12/24/12/1, K7-K9 0, K10 1; each of {len(graphs_)} "
        "chunk and fused graphs the same a step a replay")
    return {"launches": {k.name: n for k, n in grew.items()}, "steps": steps,
            "graphs_checked": len(graphs_)}


def check_server(dev, tmp: Path, emb) -> dict:
    """The port's HTTP server at full width (0.1B dense bf16 LLM, 24 kHz
    wave codec, -np 8 -n 250 --ctx-size 512, the JAX batcher's defaults:
    width-sliced chunks, the fused prefill, the attach hold, depth 1):
    listening after the foreground warm-up, then its background tail;
    health, inline codes against pipeline.synthesize, lane independence
    (slicing off, as both of its runs then keep B = 8), a lane at width 2
    beside two different neighbours, greedy against the B=1 engine and
    width 1 against the full width, timed rounds at concurrency 1/4/8 (the
    attach holds of each burst) and a depth-2 round, the unfused submit
    path (a round and lane independence with fusing off), two SSE stream_audio
    requests (first token, first chunk token, first audio), a served lane
    at repeat penalty 1.1, chunk device ms at occupancy 1, 2, 4 and 8, each
    width's replay against its eager body, and K1, K2 and K3 held against
    their plain versions at the server's shapes; a second server with
    --warmup off, and a -np 4 q8_0 server (K3 at widths 1 and 2). The
    served requests of each server must launch its kernels at the new
    widths; the references and checks run between them are not counted.
    The served requests' K11 launches go 12 : 24 : 12 : 1 a step and K7-K9
    none, and /metrics reads the same; every chunk and fused first-chunk
    graph counts the same a step into each replay (``served_fused``)."""
    import concurrent.futures

    from miotts_tpu_torch.models.llm import CHAT_TEMPLATE
    from miotts_tpu_torch.models.sampling import SamplerParams as SP

    out: dict = {}
    g0, c0 = graph_counts(), codec_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = start_server(dev, tmp, "llm.gguf", [*SERVER_FLAGS, "--warmup", "on"])
    eng = srv.engine
    b = eng.batcher
    out["startup_s"] = time.perf_counter() - t0
    out["warmup_s"] = eng.warmup_s
    out["max_memory_reserved_listen_mib"] = torch.cuda.max_memory_reserved() / 2 ** 20
    out["warm_graphs_listen"] = {"codec": len(eng.pipeline.graphs), "chunk": len(b.chunks),
                                 "fused": len(b._fused)}
    log(f"[server] -np 8 -n 250 --ctx-size 512 --warmup on: listening after "
        f"{out['startup_s']:.2f}s (foreground warm-up {eng.warmup_s:.2f}s, "
        f"{eng.warmup_fg_calls} calls: {out['warm_graphs_listen']} graphs), "
        f"max_memory_reserved {out['max_memory_reserved_listen_mib']:.0f} MiB")
    try:
        import urllib.request

        while not eng.warmup_bg_done:
            if time.perf_counter() - t0 > 600:
                raise AssertionError("the warm-up tail did not end in 600 s")
            time.sleep(0.05)
        out["ready_s"] = time.perf_counter() - t0
        out["warmup_tail_s"] = eng.warmup_bg_s
        out["max_memory_reserved_mib"] = torch.cuda.max_memory_reserved() / 2 ** 20
        out["warm_graphs"] = {"codec": len(eng.pipeline.graphs), "chunk": len(b.chunks),
                              "fused": len(b._fused)}
        want = {(r, wd) for r in b.ladder for wd in b.widths()}
        if (set(b.chunks) != want or set(b._fused) != {1, 2, 4, 8}
                or not all(ch.captured for ch in b.chunks.values())):
            raise AssertionError(f"warm-up: chunk graphs {sorted(b.chunks)}, fused graphs "
                                 f"{sorted(b._fused)}")
        log(f"[server] background tail ({eng.warmup_bg_calls} calls) done in "
            f"{eng.warmup_bg_s:.2f}s, {out['ready_s']:.2f}s after the start: "
            f"{out['warm_graphs']} graphs (chunk graphs: rungs {b.ladder} x widths "
            f"{b.widths()}), max_memory_reserved {out['max_memory_reserved_mib']:.0f} MiB")
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/mio/health", timeout=30) as r:
            health = json.loads(r.read())
        if health["status"] != "ok" or not health["warmup_complete"]:
            raise AssertionError(f"health: {health}")
        served0 = {m: m.launches for m in MODS + FUSED + GEMV}
        scraped0 = fused_metrics(eng)
        widths0 = dict(b.width_counts)

        # inline codes against pipeline.synthesize, within one PCM16 step
        codes = np.random.RandomState(5).randint(0, eng.pipeline.config.vocab_size, 150).tolist()
        status, _, data, _ = http_post(srv, "/mio/tts/stream",
                                       {"codes": codes, "reference_key": "voice"})
        sr, pcm = parse_wav_bytes(data, "inline codes")
        with uncounted():
            ref = eng.pipeline.synthesize(codes, emb).audio
        ref16 = np.rint(np.clip(ref, -1, 1) * 32767).astype(np.int32)
        step = int(np.abs(pcm.astype(np.int32) - ref16).max()) if pcm.size == ref16.size else -1
        if status != 200 or not 0 <= step <= 1:
            raise AssertionError(f"inline codes: HTTP {status}, {pcm.size} vs {ref16.size} "
                                 f"samples, largest difference {step} PCM16 steps")
        log(f"[server] inline codes (150) equal pipeline.synthesize within {step} PCM16 step")

        # lane independence: sampled codes_only, alone and among 7 neighbours
        # that arrive 0.3 s later (so both of its prefills run alone), with
        # slicing off, so that its decode steps run at B = 8 in both runs
        req = {"text": SERVER_TEXTS[0], "reference_key": "voice", "codes_only": True,
               "seed": 7, "temp": 0.8, "top_k": 50}

        def codes_of(body):
            st, _, raw, _ = http_post(srv, "/mio/tts", body)
            if st != 200:
                raise AssertionError(f"codes_only: HTTP {st}: {raw[:300]!r}")
            return json.loads(raw)["codes_values"]

        def common(x, y):
            return next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))

        b.slice_chunks = False
        try:
            alone = codes_of(req)
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                first = ex.submit(codes_of, req)
                time.sleep(0.3)
                others = [ex.submit(codes_of, {**req, "seed": 100 + i,
                                               "text": SERVER_TEXTS[i + 1]}) for i in range(7)]
                among = first.result()
                [f.result() for f in others]
            if among != alone:
                raise AssertionError(f"lane independence: seed 7 gave {len(alone)} codes alone "
                                     f"and {len(among)} among neighbours, equal for "
                                     f"{common(alone, among)}")
            out["lane_independence_codes"] = len(alone)
            log(f"[server] seed 7 (temp 0.8, top_k 50): {len(alone)} codes alone == among 7 "
                f"concurrent neighbours, bit for bit (its prefill alone, slicing off: B = 8)")
            # the same 8 sent at once: seed 7's prefill may then be coalesced
            # with its neighbours' (a padded group, a GEMM at another M),
            # which can round its first logits otherwise (reported)
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                futs = [ex.submit(codes_of, req)]
                futs += [ex.submit(codes_of, {**req, "seed": 100 + i, "text": SERVER_TEXTS[i + 1]})
                         for i in range(7)]
                at_once = futs[0].result()
                [f.result() for f in futs[1:]]
            n_same = common(alone, at_once)
            out["lane_independence_at_once"] = {"equal": at_once == alone, "common_prefix": n_same,
                                                "codes": len(at_once)}
            log(f"[server] seed 7 sent at once with its 7 neighbours (slicing off): "
                f"{'bit-equal to alone' if at_once == alone else 'differs from alone'} "
                f"({n_same} of {len(at_once)} codes in common)")
            greedy_full = codes_of({**req, "temp": 0.0})
        finally:
            b.slice_chunks = True

        # a lane at width 2, beside one neighbour and then another: equal
        def bucket(text):
            n = len(eng.llm.tokenizer.encode(CHAT_TEMPLATE.format(text=text), parse_special=True))
            return next(x for x in (32, 64, 128, 256, 512) if n <= x)

        pals = [t for t in SERVER_TEXTS[1:] if bucket(t) == bucket(SERVER_TEXTS[0])][:2]
        w2 = [width2_pair(b, SERVER_TEXTS[0], pal) for pal in pals]
        if len(pals) < 2 or w2[0] != w2[1]:
            raise AssertionError(f"width 2: seed 7 beside two neighbours gave {len(w2[0])} and "
                                 f"{len(w2[-1])} tokens, equal for {common(w2[0], w2[-1])}")
        out["width2_lane_tokens"] = len(w2[0])
        log(f"[server] seed 7 at width 2 beside two different neighbours (one prefill group of "
            f"two each time): {len(w2[0])} tokens, bit for bit")

        # greedy: against the B=1 engine, and width 1 against the full width
        # (both reported)
        greedy = codes_of({**req, "temp": 0.0})
        with uncounted():
            toks = eng.llm.generate_audio_tokens(SERVER_TEXTS[0], n_predict=250, n_ctx=512,
                                                 sampler=SP(temp=0.0))
        single = eng.llm.tokens_to_codes(toks)
        out["greedy_codes"] = greedy
        out["greedy_common_prefix"] = [common(greedy, single), len(greedy), len(single)]
        out["greedy_width1_vs_full"] = [common(greedy, greedy_full), len(greedy),
                                        len(greedy_full)]
        log(f"[server] greedy alone: {out['greedy_common_prefix'][0]} of {len(greedy)} codes "
            f"equal the B=1 engine's ({len(single)} codes); width 1 vs the full width (slicing "
            f"off): {out['greedy_width1_vs_full'][0]} in common (reported)")

        # a served lane at repeat penalty 1.1
        pen = binary_tts(srv, SERVER_TEXTS[3], 9, "repeat penalty 1.1", {"repeat_penalty": 1.1})
        log(f"[server] a request at repeat penalty 1.1: {pen['audio_s']:.2f} s of audio")

        # timed rounds at concurrency 1, 4 and 8, two rounds each
        rounds = {}
        for n in SERVER_ROUNDS:
            rounds[n] = round_stats([concurrent_round(srv, n, f"conc {n} round {k}",
                                                      offset=k * n) for k in (0, 1)])
            log(f"[server] concurrency {n}: {round_text(n, rounds[n])}")
        out["rounds"] = rounds
        b.depth = 2
        try:
            out["depth2_conc4"] = round_stats([concurrent_round(srv, 4, f"depth 2 round {k}",
                                                                offset=k * 4) for k in (0, 1)])
        finally:
            b.depth = 1
        log(f"[server] MIOTTS_CHUNK_DEPTH=2, concurrency 4: {round_text(4, out['depth2_conc4'])} "
            f"(depth 1: {rounds[4]['audio_s_per_s']:.2f} audio-s/s)")
        out["unfused"] = unfused_rounds(srv, req, codes_of, common)

        # two concurrent SSE stream_audio requests
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            sse = list(ex.map(lambda i: sse_audio(srv, SERVER_TEXTS[i], 200 + i, b.first_chunk),
                              range(2)))
        out["sse"] = sse
        def ms_of(key):
            return ", ".join(f"{x[key]:.1f}" for x in sse)

        log(f"[server] 2 concurrent SSE stream_audio: first token {ms_of('first_token_ms')} ms "
            f"(the fused prefill's), first chunk token {ms_of('first_chunk_token_ms')} ms, "
            f"TTFA {ms_of('ttfa_ms')} ms, samples {[x['samples'] for x in sse]}")

        g = {k: v - g0[k] for k, v in graph_counts().items()}
        if g["eager_steps"] != 0 or g["replays"] <= 0:
            raise AssertionError(f"server generation ran eager chunk steps or no replay: {g}")
        out["decode_graph"] = g
        grew = {m: m.launches - served0[m] for m in MODS}
        widths = {wd: n - widths0.get(wd, 0) for wd, n in b.width_counts.items()
                  if n > widths0.get(wd, 0)}
        out["served_launches"] = {m.__name__.rsplit(".", 1)[1]: n for m, n in grew.items()}
        out["served_widths"] = widths
        log(f"[server] the served requests launched {launch_text(grew)}; chunks by width "
            f"{dict(sorted(widths.items()))}")
        if grew[k1] <= 0 or grew[k2] <= 0 or not {1, 2, 4, b.n_lanes} <= set(widths):
            raise AssertionError(f"the served requests launched no K1 or no K2, or not at every "
                                 f"width: {launch_text(grew)}, widths {widths}")
        out["served_fused"] = served_fused(eng, {k: k.launches - served0[k]
                                                 for k in FUSED + GEMV},
                                           scraped0)

        with uncounted():
            out["chunk_device_ms"] = {occ: chunk_device_ms(srv, occ) for occ in (1, 2, 4, 8)}
            log(f"[server] one {b.chunk_max}-step chunk replay: device " + ", ".join(
                f"{v['ms']:.3f} ms at occupancy {occ} (width {v['width']})"
                for occ, v in out["chunk_device_ms"].items()))
            out["width_graphs"] = check_width_graphs(srv)
            out["fused_graphs"] = check_fused_graphs(srv)
            gen = torch.Generator().manual_seed(3)
            out["k2_at_server_s"] = {f"B={B} S={S}": k2_at_server_s(dev, gen, S, B)
                                     for S in (512, b.max_ctx) for B in (1, 2, 4, 8)}
            out["k1_at_server"] = k1_at_server(dev, gen, eng.pipeline.config,
                                               pick_bucket(len(alone)))
            out["k3_at_lanes"] = {T: k3_at_lanes(dev, gen, T) for T in (1, 2, 4)}
    finally:
        srv.shutdown()
    del srv, eng, b
    torch.cuda.empty_cache()

    # --warmup off: codec keys get their eager decode and their capture, the
    # chunk graphs (each width) and fused graphs their capture, while the
    # worker replays and the prefill thread prefills
    srv = start_server(dev, tmp, "llm.gguf", [*SERVER_FLAGS, "--warmup", "off"])
    try:
        c1, d1, l1 = codec_counts(), graph_counts(), {m: m.launches for m in MODS}
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(binary_tts, srv, SERVER_TEXTS[i], 300 + i, f"warmup-off {i}")
                    for i in range(4)]
            futs += [ex.submit(sse_audio, srv, SERVER_TEXTS[i], 300 + i) for i in range(4, 8)]
            failed = []
            for f in futs:
                try:
                    f.result()
                except Exception as e:  # counted, then raised below
                    failed.append(repr(e))
        c = {k: v - c1[k] for k, v in codec_counts().items()}
        d = {k: v - d1[k] for k, v in graph_counts().items()}
        grew = {m: m.launches - l1[m] for m in MODS}
        out["warmup_off"] = {"failed": len(failed), "codec_graph": c, "decode_graph": d,
                             "launches": {m.__name__.rsplit(".", 1)[1]: n
                                          for m, n in grew.items()},
                             "widths": dict(srv.engine.batcher.width_counts)}
        log(f"[server] --warmup off round of 8 (4 binary, 4 SSE stream_audio): {len(failed)} "
            f"failed; codec eager={c['eager']} captures={c['captures']} "
            f"replays={c['replays']}; chunk captures={d['captures']} replays={d['replays']} "
            f"eager_steps={d['eager_steps']}; chunks by width "
            f"{out['warmup_off']['widths']}; launched {launch_text(grew)}")
        if (failed or c["captures"] == 0 or d["captures"] == 0 or d["eager_steps"]
                or grew[k1] <= 0 or grew[k2] <= 0):
            raise AssertionError(f"--warmup off round: {failed}, {c}, {d}, {launch_text(grew)}")
    finally:
        srv.shutdown()
    del srv
    torch.cuda.empty_cache()

    # a q8_0 server: K3 at T = 1, 2 (width graphs) and 4 (all lanes); its
    # requests run SERVER_TOKENS, so those sent together still overlap at a
    # chunk boundary when a step is fast
    srv = start_server(dev, tmp, "llm_q8_0.gguf",
                       ["-np", "4", "-n", str(SERVER_TOKENS), "--ctx-size", "512",
                        "--llm-quant", "q8_0"])
    try:
        b = srv.engine.batcher
        k3_0 = k3.launches
        out["q8_0_by_concurrency"] = {}
        for n in (1, 2, 3):
            k3_n, widths_n = k3.launches, dict(b.width_counts)
            with concurrent.futures.ThreadPoolExecutor(n) as ex:
                list(ex.map(lambda i: binary_tts(srv, SERVER_TEXTS[i], 400 + i, f"q8_0 {i}"),
                            range(n)))
            out["q8_0_by_concurrency"][n] = {
                "k3_per_request": (k3.launches - k3_n) / n,
                "widths": {wd: c - widths_n.get(wd, 0) for wd, c in sorted(b.width_counts.items())
                           if c > widths_n.get(wd, 0)}}
        out["q8_0_widths"] = dict(b.width_counts)
    finally:
        srv.shutdown()
    del srv, b
    torch.cuda.empty_cache()
    out["q8_0_k3_launches"] = k3.launches - k3_0
    if out["q8_0_k3_launches"] <= 0 or not {1, 2} <= set(out["q8_0_widths"]):
        raise AssertionError(f"the q8_0 server's requests launched K3 {out['q8_0_k3_launches']} "
                             f"times, chunks by width {out['q8_0_widths']}")
    log(f"[server] -np 4 --llm-quant q8_0: 1, 2 and 3 requests at once launched K3 "
        f"{out['q8_0_k3_launches']} times; chunks by width {out['q8_0_widths']}; by concurrency "
        f"{out['q8_0_by_concurrency']}")
    out["codec_graph"] = {k: v - c0[k] for k, v in codec_counts().items()}
    return out


# -- the mesh phase: --mio-backend-devices all -tp 2 on logical ranks ---------------------

MESH_FLAGS = ["--mio-backend-devices", "all", "-tp", "2"]
MESH_GREEDY_TOKENS = 64  # a greedy request's codes, held to the mesh-less server's


def rank_counts(before: dict) -> dict:
    """Launches each logical rank made since ``before`` (a copy of
    ``graphs.rank_launches``): {kernel: {rank id: launches}}."""
    out: dict = {}
    for (mod, rank), n in sorted(graphs.rank_launches.items()):
        if n > before.get((mod, rank), 0):
            out.setdefault(mod.rsplit(".", 1)[1], {})[rank] = n - before.get((mod, rank), 0)
    return out


def mesh_server_run(dev, tmp: Path, llm: str, flags: list[str], mesh: bool,
                    rounds: bool) -> dict:
    """One server at -np 8 -n 250 --warmup off, with the mesh flags under 4
    logical devices or without them: /mio/health, the greedy request, and
    with ``rounds`` a round at each concurrency to capture its graphs, the
    timed rounds (launches by rank in each) and a dp rank's chunk device
    ms with its launches a step by rank."""
    out: dict = {}
    argv = [*SERVER_FLAGS, "--warmup", "off", *flags, *(MESH_FLAGS if mesh else [])]
    t0 = time.perf_counter()
    r0 = dict(device_dequant.routes)
    with environment(MIOTTS_LOGICAL_DEVICES="4" if mesh else None,
                     MIOTTS_PACKED_CACHE=str(tmp / "mesh_packed")):
        srv = start_server(dev, tmp, llm, argv)
    out["startup_s"] = time.perf_counter() - t0
    out["load_routes"] = route_counts(r0)
    try:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/mio/health", timeout=30) as r:
            health = json.loads(r.read())
        out["health"] = {k: health[k] for k in ("backend_devices", "tensor_parallel")}
        tg = time.perf_counter()
        st, _, raw, _ = http_post(srv, "/mio/tts", {
            "text": SERVER_TEXTS[0], "reference_key": "voice", "codes_only": True,
            "temp": 0.0, "n_predict": MESH_GREEDY_TOKENS})
        out["greedy_s"] = time.perf_counter() - tg
        if st != 200:
            raise AssertionError(f"mesh={mesh} greedy request: HTTP {st}: {raw[:300]!r}")
        out["greedy"] = json.loads(raw)["codes_values"]
        if not rounds:
            return out
        # capture every graph the timed rounds replay: each dp rank's fused
        # first chunks (groups of 1, 2 and 4) at the prompts' buckets, its
        # chunk_max rung, and the codec keys of a 250-code synthesis
        from miotts_tpu_torch.models.llm import CHAT_TEMPLATE
        from miotts_tpu_torch.serving.batching import _PROMPT_BUCKETS

        b, eng = srv.engine.batcher, srv.engine
        tw = time.perf_counter()
        lens = {len(eng.llm.tokenizer.encode(CHAT_TEMPLATE.format(text=t), parse_special=True))
                for t in SERVER_TEXTS}
        for bucket in sorted({next(x for x in _PROMPT_BUCKETS if n <= x) for n in lens}):
            for k in (1, 2, 4):
                b.warm_prefill(bucket, k)
        b.warm_chunk(b.chunk_max)  # binary requests run chunk_max chunks only
        eng.codec_batcher.warm(pick_bucket(SERVER_TOKENS, eng.pipeline.buckets), pcm16=True)
        out["warm_s"] = time.perf_counter() - tw
        out["rounds"] = {}
        for n in SERVER_ROUNDS:
            r0 = dict(graphs.rank_launches)
            stats = round_stats([concurrent_round(srv, n, f"mesh={mesh} conc {n}")])
            stats["rank_launches_per_request"] = {
                kern: {rank: c / n for rank, c in by.items()}
                for kern, by in rank_counts(r0).items()}
            out["rounds"][n] = stats
        with uncounted():
            out["chunk_device_ms"] = {occ: chunk_device_ms(srv, occ) for occ in (1, 4)}
        g = b.chunks[(b.chunk_max, out["chunk_device_ms"][4]["width"])]
        out["step_launches_by_rank"] = {
            f"{k[0].rsplit('.', 1)[1]}@{k[1]}": n / g.n_steps
            for k, n in g.launches_per_replay.items() if isinstance(k, tuple)}
    finally:
        srv.shutdown()
        del srv
        torch.cuda.empty_cache()
    return out


def mesh_kernels(dev, gen) -> dict:
    """K2 and K3 at a tp=2 rank's shapes at full width, each against its
    plain version and timed: K2 over one kv head (6 query heads) at B = 1
    and 4 lanes of the server's cache (826 rows), beside the same at the
    single device's 2 kv heads; K3 on each rank leaf (q|k|v 512 columns,
    attention-out 384 rows, gate|up 2048 columns, down 1024 rows, half the
    padded head) at T = 1 and 4, each beside its bound and cuBLAS's bf16
    GEMV on the same leaf."""
    S = 250 + 512 + 64  # the server's -n + --ctx-size + 64 cache rows
    out = {"k2": {f"B={B} KVH={kvh}": k2_at_server_s(dev, gen, S, B, kvh, "[mesh]")
                  for B in (1, 4) for kvh in (1, 2)}, "k3": {}}
    w = LLM_WIDTHS
    hd = w["dim"] // w["n_heads"]
    vocab = len(synthetic_vocab(w["n_audio"], w["n_filler_vocab"])[0])
    shapes = (("wqkv", w["dim"], (w["n_heads"] // 2 + 2) * hd),
              ("wo", w["n_heads"] // 2 * hd, w["dim"]), ("w_gateup", w["dim"], w["ffn"]),
              ("w_down", w["ffn"] // 2, w["dim"]), ("output", w["dim"], -(-vocab // 128) * 64))
    for leaf, K, N in shapes:
        q, s, w_bf16, w_abs = k3_weights(dev, gen, K, N)
        for T in (1, 4):
            x = torch.randn(T, K, generator=gen).to(dev, torch.bfloat16)
            err, ratio, plan = k3_case(leaf, x, q, s, w_abs)
            row = [cuda_ms(lambda: k3.q8_matmul(x, q, s)),
                   cuda_ms(lambda: k3.q8_matmul_plain(x, q, s)),
                   cuda_ms(lambda: x @ w_bf16), k3_bound(T, K, N)["bound_ms"]]
            out["k3"][f"{leaf} T={T}"] = row
            log(f"[mesh] K3 rank leaf {leaf} K={K} N={N} T={T} launch={tuple(plan)}: "
                f"max_abs_err={err:.3e} err/bound<={ratio:.3e} kernel={row[0]:.4f}ms "
                f"plain={row[1]:.4f}ms dense_bf16={row[2]:.4f}ms bound={row[3]:.5f}ms")
    return out


def common_prefix(x: list, y: list) -> int:
    return next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))


def check_mesh(dev, tmp: Path, server_rows: dict | None = None) -> dict:
    """The [mesh] phase: the port's server on a dp=2 x tp=2 mesh of four
    logical ranks on the one card (MIOTTS_LOGICAL_DEVICES=4,
    ``--mio-backend-devices all -tp 2 -np 8 -n 250 --warmup off``) at full
    width, dense and q8_0: concurrency 1/4/8 at 250 tokens (audio-s per s
    beside the mesh-less server's rounds of the server phase, ``server_rows``);
    required: K2, K8 and K9 (and in q8_0 K3) launched by every tp rank in
    the concurrency-8 round and /mio/health's backend_devices 4 and
    tensor_parallel 2. The greedy check: a -np 2 int8 server with and
    without the mesh, whose tp sums are exact (int32 dots), give equal codes
    (required); the dense mesh's greedy codes are held to the server phase's
    (reported: a bf16 tp rank rounds its partial sums apart). A tp=2 decode
    step's device ms (a dp rank's 64-step chunk replay) with K2 and K3
    launches a step for each rank, and K2 and K3 at a tp=2 rank's shapes
    (``mesh_kernels``). These are a mesh's overheads on one card, not a
    multi-card speed-up."""
    t0 = time.perf_counter()
    with uncounted():
        out: dict = {"kernels": mesh_kernels(dev, torch.Generator().manual_seed(14))}
    plain_rounds = (server_rows or {}).get("rounds", {})
    for mode, llm, flags in (("dense", "llm.gguf", []),
                             ("q8_0", "llm_q8_0.gguf", ["--llm-quant", "q8_0"])):
        meshed = mesh_server_run(dev, tmp, llm, flags, mesh=True, rounds=True)
        if meshed["health"] != {"backend_devices": 4, "tensor_parallel": 2}:
            raise AssertionError(f"[mesh] {mode}: health {meshed['health']}")
        by_rank = meshed["rounds"][8]["rank_launches_per_request"]
        for kern in (("decode_attention", "qkv_rope_cache", "silu_mul")
                     + (("q8_matmul",) if mode == "q8_0" else ())):
            if set(by_rank.get(kern, {})) != {0, 1, 2, 3}:
                raise AssertionError(f"[mesh] {mode}: {kern} launched by ranks "
                                     f"{by_rank.get(kern)} at concurrency 8, not all four")
        for n in SERVER_ROUNDS:
            r = meshed["rounds"][n]
            base = (f"{plain_rounds[n]['audio_s_per_s']:.2f} mesh-less (server phase)"
                    if mode == "dense" and n in plain_rounds else "no mesh-less round")
            log(f"[mesh] {mode} concurrency {n}: audio-s/s {r['audio_s_per_s']:.2f} on dp=2 x "
                f"tp=2 logical ranks of one card vs {base}; latency p50 {r['p50_ms']:.1f} ms "
                f"p90 {r['p90_ms']:.1f} ms, llm_ms {r['llm_ms']:.1f}; launches a request by "
                f"rank {r['rank_launches_per_request']}")
        dm = meshed["chunk_device_ms"]
        log(f"[mesh] {mode} tp=2 decode step: device {dm[1]['ms'] / 64:.4f} ms at 1 live lane, "
            f"{dm[4]['ms'] / 64:.4f} ms at 4 (a dp rank's 64-step chunk replay, "
            f"{dm[1]['ms']:.3f} / {dm[4]['ms']:.3f} ms); launches a step by kernel@rank "
            f"{meshed['step_launches_by_rank']}; listening after {meshed['startup_s']:.2f} s, "
            f"graphs captured in {meshed['warm_s']:.2f} s")
        row = {k: v for k, v in meshed.items() if k != "greedy"}
        if mode == "dense" and server_rows and server_rows.get("greedy_codes"):
            ref = server_rows["greedy_codes"][:MESH_GREEDY_TOKENS]
            row["greedy_common_with_server_phase"] = common_prefix(meshed["greedy"], ref)
            log(f"[mesh] dense greedy: {row['greedy_common_with_server_phase']} of "
                f"{len(meshed['greedy'])} codes equal the mesh-less server's (reported: the "
                "bf16 tp sums round apart from one device's)")
        out[mode] = row
    # the exact case: W8A8 tp sums its int32 dots exactly. Both servers keep
    # their LLM's deploy artifact in one directory: the first writes it (its
    # host int8 quantization), the second must replay it
    int8 = ["--llm-quant", "int8", "-np", "2"]
    ti = time.perf_counter()
    plain = mesh_server_run(dev, tmp, "llm.gguf", int8, mesh=False, rounds=False)
    meshed = mesh_server_run(dev, tmp, "llm.gguf", int8, mesh=True, rounds=False)
    out["int8_s"] = time.perf_counter() - ti
    same = common_prefix(plain["greedy"], meshed["greedy"])
    out["int8_greedy"] = {"common": same, "n": len(meshed["greedy"]),
                          "health": meshed["health"]}
    log(f"[mesh] int8 greedy ({MESH_GREEDY_TOKENS} tokens): {same} of {len(meshed['greedy'])} "
        f"codes equal the mesh-less server's (required); mesh health {meshed['health']}; "
        f"two servers in {out['int8_s']:.1f} s (listening after {plain['startup_s']:.2f} / "
        f"{meshed['startup_s']:.2f} s, load routes {plain['load_routes']} / "
        f"{meshed['load_routes']}; the greedy request {plain['greedy_s']:.2f} / "
        f"{meshed['greedy_s']:.2f} s)")
    out["int8_pair"] = {k: [plain[k], meshed[k]] for k in ("startup_s", "greedy_s", "load_routes")}
    if not meshed["load_routes"].get("replay"):
        raise AssertionError(f"[mesh] the int8 mesh server did not replay the artifact its "
                             f"mesh-less twin kept: routes {meshed['load_routes']}")
    if not plain["greedy"] or plain["greedy"] != meshed["greedy"] or meshed["health"] != {
            "backend_devices": 4, "tensor_parallel": 2}:
        raise AssertionError(f"[mesh] int8 greedy: {same} of {len(meshed['greedy'])} codes "
                             f"equal the mesh-less server's {len(plain['greedy'])}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[mesh] {out['wall_s']:.1f}s")
    return out


# -- sequence parallelism ---------------------------------------------------------------

SP_RANKS = (2, 4)  # --sequence-parallel on MIOTTS_LOGICAL_DEVICES=4 ranks of the card
# codes of the sp requests: a whole 400-code one, and 390 codes, whose ends
# fall inside a rank's halo at sp = 4 (bucket 512: the tokens end 6 rows
# past the token shard edge at 384, the decoder's 780 frames 12 past the
# frame shard edge at 768, within K1's 32-row halo of rank 2)
SP_CODES = (400, 390)
SP_TOL = 1e-4  # f32 audio against the mesh-less decode (the JAX package's bar)
# A full-width synthetic codec can turn f32 rounding into audio differences
# above SP_TOL: the 44.1 kHz codec's mesh-less decode moves by more than
# that when only its GroupNorm statistics are summed in f64 (``sp_floor``,
# printed by this phase). So each codec's bar is the larger of SP_TOL and
# SP_FLOOR_FACTOR times that floor, since an sp decode re-orders every
# GroupNorm, matmul, conv and attention sum, not one; and its mel-L1
# against the mesh-less decode must stay under MEL_L1_MAX. The JAX package
# misses SP_TOL on this codec too: decoding these 400 codes on the CPU
# (scripts/check_sp441_drift.py), its own sp = 2 / 4 decodes are 2.28e-04 /
# 2.04e-04 from its mesh-less decode (the port's 3.64e-04 / 3.66e-04, its
# f64 floor 1.79e-04), so the widened bar is the codec's, not the port's.
SP_FLOOR_FACTOR = 4
SP_PCM_STEPS = 2  # through the CLI: int16 steps
# K1 at a rank's halo-extended part of a 400-code decode (bucket 512):
# (name, H, rows); an edge rank of sp = 2 holds 256 tokens / 512 frames
# and one 32-row halo, an inner rank of sp = 4 128 / 256 and two
K1_SP_SHAPES = (("sp=2 prenet", 12, 256 + 32), ("sp=2 decoder", 8, 512 + 32),
                ("sp=4 prenet", 12, 128 + 64), ("sp=4 decoder", 8, 256 + 64))
CPU_REFS: dict = {}  # the knob phase's CPU f32 mel decode, reused by the sp phase


def f64_group_norm(x, lengths, num_groups: int, eps: float = 1e-6):
    """``masked_group_norm`` with its statistics summed in f64."""
    from miotts_tpu_torch.ops import norms

    xf, m = norms.group_view(x, lengths, num_groups)
    count = norms.group_count(lengths, xf.shape[-1]).double()
    x64, m64 = xf.double(), m.double()
    mean = (x64 * m64).sum(dim=(1, 3), keepdim=True) / count
    var = (torch.square(x64 - mean) * m64).sum(dim=(1, 3), keepdim=True) / count
    return norms.group_normalize(x, xf, m, mean.float(), var.float(), eps)


def sp_floor(pipe, codes, emb, ref: np.ndarray, **opts) -> float:
    """Max abs between ``ref`` (the mesh-less decode of ``codes``) and the
    same eager decode with its GroupNorm statistics summed in f64: the
    rounding the codec's output carries from one reduction (0 for a codec
    without GroupNorm)."""
    from miotts_tpu_torch.models import miocodec

    n = len(codes)
    tokens = np.zeros((1, pick_bucket(n, pipe.buckets)), np.int64)
    tokens[0, :n] = codes
    window = opts.pop("window", None)
    kw = dict(opts, window=None if window is None else window[1],
              starts=None if window is None else np.array([window[0]], np.int32))
    saved = miocodec.masked_group_norm
    miocodec.masked_group_norm = f64_group_norm
    try:
        audio, counts = pipe.decode_eager(tokens, np.array([n], np.int32), emb[None], **kw)
    finally:
        miocodec.masked_group_norm = saved
    got = audio[0, :len(ref)]
    return float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")


def sp_decodes(pipe, codes, emb, n: int = 4) -> tuple[list, list, list]:
    """``n`` decodes of one request on ``pipe`` (the key's eager decode, its
    capture and replay, then replays): (results, codec routes, launches by
    kernel and rank of each)."""
    results, routes, ranks = [], [], []
    for _ in range(n):
        c0, r0 = codec_counts(), dict(graphs.rank_launches)
        results.append(pipe.synthesize(codes, emb))
        c = {k: v - c0[k] for k, v in codec_counts().items()}
        routes.append("eager" if c["eager"] else "capture" if c["captures"] else
                      "replay" if c["replays"] else "?")
        ranks.append(rank_counts(r0))
    return results, routes, ranks


def sp_codec(dev, tmp: Path, emb, codec: str, gguf: str, codes) -> dict:
    """One codec's sp decodes: at sp = 2 and 4 on logical ranks of the card,
    each of four decodes (eager, capture + replay, two replays) within
    SP_TOL of the mesh-less decode, the replays bit-equal to the eager
    decode, K1 14 launches a decode on every rank (and in mel mode K4, K5
    and K6 on every rank); eager and replay wall ms beside the mesh-less
    pipeline's."""
    row: dict = {}
    plain = MioTTSPipeline(tmp / gguf, dev)
    res, routes, _ = sp_decodes(plain, codes, emb)
    ref = res[0].audio
    floor = sp_floor(plain, codes, emb, ref)
    tol = max(SP_TOL, SP_FLOOR_FACTOR * floor)
    row["mesh-less"] = {"eager_ms": res[0].decode_ms, "capture_ms": res[1].decode_ms,
                        "replay_ms": [r.decode_ms for r in res[2:]], "floor": floor, "tol": tol}
    log(f"[sp] {codec}: the mesh-less decode moves by {floor:.3e} with its GroupNorm "
        f"statistics in f64, so sp is held to {tol:.3e}")
    del plain
    for sp in SP_RANKS:
        pipe = MioTTSPipeline(tmp / gguf, dev, sp_devices=logical_devices("cuda")[:sp])
        res, routes, ranks = sp_decodes(pipe, codes, emb)
        if routes != ["eager", "capture", "replay", "replay"]:
            raise AssertionError(f"[sp] {codec} sp={sp}: decodes went {routes}")
        diffs = []
        for i, r in enumerate(res):
            if r.audio.shape != ref.shape:
                raise AssertionError(f"[sp] {codec} sp={sp} decode {i + 1}: {r.audio.shape} "
                                     f"samples, mesh-less {ref.shape}")
            diffs.append(float(np.abs(r.audio - ref).max()))
        l1 = mel_l1(res[0].audio, ref, pipe.sample_rate)
        if not (max(diffs) <= tol and l1 < MEL_L1_MAX):
            raise AssertionError(f"[sp] {codec} sp={sp}: max abs vs mesh-less {diffs} (held to "
                                 f"{tol}), mel-L1 {l1}")
        if any(r.audio.tobytes() != res[0].audio.tobytes() for r in res[1:]):
            raise AssertionError(f"[sp] {codec} sp={sp}: a replay is not bit-equal to the eager "
                                 f"decode")
        want = ("banded_attention",) + (("conv1d", "activation1d", "resblock")
                                        if codec == "mel" else ())
        for i, by in enumerate(ranks):
            if by.get("banded_attention") != {r: K1_PER_DECODE for r in range(sp)} or any(
                    set(by.get(k, {})) != set(range(sp)) for k in want):
                raise AssertionError(f"[sp] {codec} sp={sp} decode {i + 1} ({routes[i]}): "
                                     f"launches by rank {by}")
        row[f"sp={sp}"] = {"eager_ms": res[0].decode_ms, "capture_ms": res[1].decode_ms,
                           "replay_ms": [r.decode_ms for r in res[2:]],
                           "max_abs_vs_mesh_less": max(diffs), "mel_l1_vs_mesh_less": l1,
                           "replays_bit_equal": True,
                           "launches_by_rank": ranks[2]}
        log(f"[sp] {codec} {len(codes)} codes sp={sp}: eager {res[0].decode_ms:.2f} ms, "
            f"capture {res[1].decode_ms:.1f} ms, replays "
            f"{', '.join(f'{r.decode_ms:.2f}' for r in res[2:])} ms wall (mesh-less: eager "
            f"{row['mesh-less']['eager_ms']:.2f}, replays "
            f"{', '.join(f'{x:.2f}' for x in row['mesh-less']['replay_ms'])}); max abs vs "
            f"mesh-less {max(diffs):.3e} (held to {tol:.3e}), mel-L1 {l1:.3e}, replays "
            f"bit-equal to the eager decode; a replay's "
            f"launches by rank {ranks[2]}")
        if codec == "mel":
            row[f"sp={sp}"]["mel_l1_vs_cpu_f32"] = sp_mel_fidelity(pipe, tmp, emb)
        elif codec == "wave" and sp == max(SP_RANKS):
            row["stream window"] = sp_window(pipe, tmp, dev, emb, codes)
        del pipe
        torch.cuda.empty_cache()
    return row


def sp_mel_fidelity(pipe, tmp: Path, emb) -> float:
    """The sp mel decode of the knob phase's 64 codes against the CPU's f32
    decode of them (computed here when the knob phase did not run):
    mel-L1 < MEL_L1_MAX."""
    if not CPU_REFS:
        codes64 = np.random.RandomState(12).randint(0, 12800, KNOB_MEL_CPU_CODES)
        CPU_REFS["mel"] = (codes64, MioTTSPipeline(tmp / "mel_codec.gguf", torch.device(
            "cpu")).synthesize(codes64, emb).audio)
    codes64, cpu_mel = CPU_REFS["mel"]
    got = pipe.synthesize(codes64, emb).audio
    l1 = mel_l1(got, cpu_mel, pipe.sample_rate)
    log(f"[sp] mel sp={pipe.sp}: {len(codes64)} codes, mel-L1 vs the CPU's f32 decode {l1:.3e}")
    if got.shape != cpu_mel.shape or not l1 < MEL_L1_MAX:
        raise AssertionError(f"[sp] mel sp={pipe.sp}: mel-L1 {l1} vs CPU f32")
    return l1


def sp_window(pipe, tmp: Path, dev, emb, codes) -> dict:
    """A stream's emission on the sp pipeline: the window fetch (anchor, no
    peak normalization, pcm16) read from the split audio, against the
    mesh-less pipeline's, within one 16-bit step."""
    opts = dict(interp_anchor=StreamingSynthesizer.INTERP_ANCHOR, peak_normalize=False,
                pcm16=True)
    start = wav_samples(full_codec_config(), len(codes)) // 3
    win = (start, StreamingSynthesizer.WINDOW_SAMPLES)
    got = pipe.synthesize(codes, emb, window=win, **opts)
    plain = MioTTSPipeline(tmp / "codec.gguf", dev)
    ref = plain.synthesize(codes, emb, window=win, **opts)
    floor = sp_floor(plain, codes, emb, ref.audio, window=win, **opts)
    tol = max(SP_TOL, SP_FLOOR_FACTOR * floor) + 1.0 / 32767
    diff = float(np.abs(got.audio - ref.audio).max())
    log(f"[sp] wave sp={pipe.sp} stream window [{start}, +{win[1]}): {len(got.audio)} samples "
        f"of {got.n_total}, max abs vs mesh-less {diff:.3e} (held to {tol:.3e}: its floor "
        f"{floor:.3e} and one 16-bit step)")
    if (got.n_total, len(got.audio)) != (ref.n_total, len(ref.audio)) or not diff <= tol:
        raise AssertionError(f"[sp] window: {got.n_total} / {len(got.audio)} samples vs "
                             f"{ref.n_total} / {len(ref.audio)}, max abs {diff}")
    return {"max_abs_vs_mesh_less": diff, "samples": len(got.audio)}


def sp_cli(tmp: Path) -> dict:
    """``--sequence-parallel 2`` and ``4`` through ``cli.main`` (wave codec,
    codes in, SP_CODES): each WAV within SP_PCM_STEPS int16 steps of the
    mesh-less CLI's, K1 14 launches on every rank, one eager decode."""
    out = {}
    codes = (tmp / "codes400.txt").read_text().split()
    for n in SP_CODES:
        path = tmp / f"sp_codes{n}.txt"
        path.write_text("\n".join(codes[:n]))
        argv = ["-mv", str(tmp / "codec.gguf"), "--tts-mio-codes-in", str(path)]
        _, _, sr, ref, _, _ = drive_cli(f"sp-{n}-plain", tmp, argv, (k1,))
        for sp in SP_RANKS:
            r0 = dict(graphs.rank_launches)
            _, _, sr2, pcm, _, routes = drive_cli(
                f"sp-{n}-sp{sp}", tmp, argv + ["--sequence-parallel", str(sp)], (k1,))
            by = rank_counts(r0)
            steps = int(np.abs(pcm.astype(np.int32) - ref.astype(np.int32)).max())
            log(f"[sp] cli {n} codes --sequence-parallel {sp}: {pcm.size} samples @ {sr2} Hz, "
                f"max {steps} int16 steps from the mesh-less CLI's; launches by rank {by}; "
                f"codec decodes {routes}")
            if (sr2, pcm.shape) != (sr, ref.shape) or steps > SP_PCM_STEPS or by.get(
                    "banded_attention") != {r: K1_PER_DECODE for r in range(sp)}:
                raise AssertionError(f"[sp] cli {n} codes sp={sp}: {pcm.shape} vs {ref.shape}, "
                                     f"{steps} steps, launches by rank {by}")
            out[f"{n} codes sp={sp}"] = {"int16_steps": steps, "routes": routes}
    return out


def sp_k1(dev, gen) -> dict:
    """K1 at a rank's halo-extended shapes (K1_SP_SHAPES), each against its
    plain version, timed beside its bound and SDPA with the band mask."""
    return {name: k1_timing(dev, gen, f"[sp] {name}", 1, H, T, [T])[0]
            for name, H, T in K1_SP_SHAPES}


def check_sp(dev, tmp: Path, emb) -> dict:
    """The [sp] phase: ``--sequence-parallel`` on MIOTTS_LOGICAL_DEVICES=4
    ranks of the card at full width: the CLI (``sp_cli``), and
    ``pipeline.synthesize`` of 400 codes in wave 24 kHz, wave 44.1 kHz and
    mel mode (``sp_codec``) with a stream's window fetch and the mel
    fidelity; K1 at a rank's shapes. On one card sp only adds work: each
    rank runs its own copy of the trunk's kernels, plus the exchanges."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(15)
    codes = rng.randint(0, 12800, max(SP_CODES))
    out: dict = {}
    with environment(MIOTTS_LOGICAL_DEVICES=str(max(SP_RANKS))):
        if len(logical_devices("cuda")) != max(SP_RANKS):
            raise AssertionError("[sp] MIOTTS_LOGICAL_DEVICES was not read")
        with uncounted():
            out["k1"] = sp_k1(dev, torch.Generator().manual_seed(15))
        out["cli"] = sp_cli(tmp)
        for codec, gguf in (("wave", "codec.gguf"), ("wave441", "codec441.gguf"),
                            ("mel", "mel_codec.gguf")):
            out[codec] = sp_codec(dev, tmp, emb, codec, gguf, codes)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[sp] {out['wall_s']:.1f}s")
    return out


# -- the external LLM and the profiler ----------------------------------------------------

API_CODES = [int(c) for c in np.random.RandomState(11).randint(0, 12800, 200)]


@contextlib.contextmanager
def llm_api_stub():
    """An external LLM API on a local port: an openai-chat request gets
    API_CODES as ``<|s_N|>`` message text, a generic one as a ``text``
    field. Yields (url, the modes of the requests it answered)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen: list[str] = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            chat = "messages" in body
            seen.append("openai-chat" if chat else "generic")
            text = "".join(f"<|s_{c}|>" for c in API_CODES)
            data = json.dumps({"choices": [{"message": {"content": text}}]} if chat
                              else {"text": text}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions", seen
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


def check_llm_api(dev, tmp: Path, emb) -> dict:
    """--llm-api-url, in both modes: ``cli.main`` text -> WAV with no -m, and
    a server with no LLM serving text /mio/tts/stream requests; each WAV
    equals ``pipeline.synthesize`` of the stub's codes within one PCM16 step;
    K1 launches and K2 does not."""
    with uncounted():
        ref = MioTTSPipeline(str(tmp / "codec.gguf"), dev).synthesize(API_CODES, emb).audio
    ref16 = np.rint(np.clip(ref, -1, 1) * 32767).astype(np.int32)
    out = {}

    def steps(pcm, what):
        step = (int(np.abs(pcm.astype(np.int32) - ref16).max()) if pcm.size == ref16.size
                else -1)
        if not 0 <= step <= 1:
            raise AssertionError(f"{what}: {pcm.size} vs {ref16.size} samples, largest "
                                 f"difference {step} PCM16 steps")
        return step

    with llm_api_stub() as (url, seen):
        for mode in ("openai-chat", "generic"):
            _, n_codes, _, pcm, grew, _ = drive_cli(
                f"api-{mode}", tmp, ["-mv", str(tmp / "codec.gguf"), "--llm-api-url", url,
                                     "--llm-api-mode", mode, "-p", "Hello from an external LLM."],
                (k1,))
            out[f"cli {mode}"] = {"codes": n_codes, "pcm16_steps": steps(pcm, f"cli {mode}"),
                                  "k1": grew[k1]}
            srv = start_server(dev, tmp, None, ["-np", "2", "--llm-api-url", url,
                                                "--llm-api-mode", mode])
            try:
                l0 = {m: m.launches for m in MODS}
                res = binary_tts(srv, "Hello from an external LLM.", 0, f"server {mode}")
                grew = {m: m.launches - l0[m] for m in MODS}
            finally:
                srv.shutdown()
            if grew[k1] <= 0 or grew[k2] != 0:
                raise AssertionError(f"server {mode}: {launch_text(grew)}")
            out[f"server {mode}"] = {"pcm16_steps": steps(res["pcm"], f"server {mode}"),
                                     "k1": grew[k1]}
        if seen != ["openai-chat", "openai-chat", "generic", "generic"]:
            raise AssertionError(f"the stub answered {seen}")
    log(f"[llm api] --llm-api-url in openai-chat and generic mode: the CLI (no -m) and a server "
        f"with no LLM each wrote the WAV of the stub's {len(API_CODES)} codes, within "
        f"{max(v['pcm16_steps'] for v in out.values())} PCM16 step of pipeline.synthesize; K1 "
        f"launched, K2 did not")
    return out


def check_trace(tmp: Path) -> dict:
    """A CLI request (400 codes -> WAV) in a child process with
    MIOTTS_PROFILE_DIR set leaves one Chrome trace, written at its normal
    exit, that holds the miocodec_synthesize range and K1's kernel."""
    import os

    prof = tmp / "profile"
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, MIOTTS_PROFILE_DIR=str(prof), MIOTTS_PLATFORM="cuda",
               PYTHONPATH=str(repo))
    cmd = [sys.executable, "-m", "miotts_tpu_torch.cli", "-mv", str(tmp / "codec.gguf"),
           "--tts-mio-codes-in", str(tmp / "codes400.txt"), "-emb", str(tmp / "voice.emb.gguf"),
           "-o", str(tmp / "traced.wav")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"traced CLI request exited {proc.returncode}: {proc.stderr[-2000:]}")
    traces = list(prof.glob("miotts_*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"MIOTTS_PROFILE_DIR holds {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    phases = [e for e in events if e.get("name") == "miocodec_synthesize"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = [e for e in kernels if "banded_attention_kernel" in e.get("name", "")]
    row = {"wall_s": time.perf_counter() - t0, "bytes": traces[0].stat().st_size,
           "phases": len(phases), "kernels": len(kernels), "k1_kernels": len(k1_events)}
    log(f"[trace] MIOTTS_PROFILE_DIR: {traces[0].name} ({row['bytes']} bytes) with "
        f"{len(phases)} miocodec_synthesize range(s), {len(kernels)} kernels, of them "
        f"{len(k1_events)} banded_attention_kernel, in {row['wall_s']:.1f}s")
    if not phases or not k1_events:
        raise AssertionError(f"the trace lacks the miocodec_synthesize range or K1: {row}")
    return row


# ---------------------------------------------------------------------------
# the native host runtime (runtime/native.py): FLAC decode and GGUF dequant
# ---------------------------------------------------------------------------

NATIVE_FLAC20 = ("ref20_441_stereo.flac", 20.0, 44100)  # (file, seconds, rate)
NATIVE_MP3_20 = "ref20_441_joint.mp3"  # tests/torch_assets: 20 s, 44.1 kHz, mid/side


def native_flac20(tmp: Path) -> Path:
    """A 20 s 44.1 kHz stereo FLAC (tests/flac_encoder.py, LPC subframes,
    mid/side, partition order 4): the voice-like tone of ``clone_assets``,
    its right channel a delayed half of the left plus noise."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from flac_encoder import encode_flac

    name, secs, sr = NATIVE_FLAC20
    rng = np.random.RandomState(16)
    t = np.arange(int(secs * sr)) / sr
    phase = 2 * np.pi * np.cumsum(180 + 20 * np.sin(2 * np.pi * 0.7 * t)) / sr
    clip = ((0.35 * np.sin(phase) + 0.12 * np.sin(2 * phase) + 0.002 * rng.randn(t.size))
            * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t) ** 2))
    left = np.rint(np.clip(clip, -1, 1) * 32767).astype(np.int64)
    right = np.roll(left, 11) // 2 + np.rint(0.002 * 32767 * rng.randn(t.size)).astype(np.int64)
    (tmp / name).write_bytes(encode_flac(np.stack([left, right], 1), sr, subframe_kind="lpc2",
                                         channel_mode="mid_side", partition_order=4))
    return tmp / name


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def same_bits(what: str, got: np.ndarray, want: np.ndarray) -> None:
    want = np.asarray(want, np.float32)
    if got.dtype != np.float32 or got.shape != want.shape or not np.array_equal(
            got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError(f"[native] {what}: the native result is not bit-equal to numpy's")


def check_native(tmp: Path) -> dict:
    """The native host runtime on the card machine's CPU: the library
    loaded (never built around), its path, ABI and the host CPU; ref3.flac
    and a 20 s 44.1 kHz stereo FLAC, and the committed ref3.mp3 and 20 s
    44.1 kHz joint-stereo mp3, decoded natively and by the numpy decoders,
    bit-equal; the Q8_0 LLM's head (Q8_0, 151 759 x 768) and a
    BF16 tensor of the same shape (the f32 LLM's token embedding cut to
    bf16) dequantized natively and by numpy, bit-equal; each time printed."""
    from miotts_tpu_torch.gguf.quants import GGMLType, dequantize_numpy
    from miotts_tpu_torch.gguf.reader import GGUFReader
    from miotts_tpu_torch.runtime.flac import decode_flac
    from miotts_tpu_torch.runtime.mp3 import decode_mp3

    if not native.available():
        raise AssertionError(f"[native] the library is unavailable: "
                             f"{native.unavailable_reason()}")
    lib = native._load()
    cpu = cpu_model_name()
    row: dict = {"library": lib._name, "abi": lib.mio_runtime_abi_version(), "cpu": cpu,
                 "cores": os.cpu_count(), "flac": {}, "mp3": {}, "dequant": {}}
    if row["abi"] != native.ABI:
        raise AssertionError(f"[native] ABI {row['abi']}, want {native.ABI}")
    log(f"[native] library {lib._name}, ABI {row['abi']}; host CPU {cpu} "
        f"({os.cpu_count()} cores seen)")
    path20, encode_ms = timed(lambda: native_flac20(tmp))
    row["flac20_encode_ms"] = encode_ms
    log(f"[native] {path20.name} written in {encode_ms:.0f} ms (tests/flac_encoder.py)")
    for kind, path, decode, numpy_decode in (
            ("flac", tmp / "ref3.flac", native.flac_decode_native, decode_flac),
            ("flac", path20, native.flac_decode_native, decode_flac),
            ("mp3", MP3_ASSETS / "ref3.mp3", native.mp3_decode_native, decode_mp3),
            ("mp3", MP3_ASSETS / NATIVE_MP3_20, native.mp3_decode_native, decode_mp3)):
        data = path.read_bytes()
        (x, rate), nat_ms = timed(lambda: decode(data))
        (y, ref_rate), np_ms = timed(lambda: numpy_decode(data))
        same_bits(path.name, x, y)
        if rate != ref_rate:
            raise AssertionError(f"[native] {path.name}: rate {rate} vs numpy's {ref_rate}")
        row[kind][path.name] = {"samples": int(x.size), "rate": rate, "bytes": len(data),
                                "native_ms": nat_ms, "numpy_ms": np_ms}
        log(f"[native] {path.name} ({len(data)} bytes, {x.size} samples at {rate} Hz): native "
            f"decode {nat_ms:.2f} ms, numpy {np_ms:.1f} ms ({np_ms / nat_ms:.1f}x), bit-equal")
    with GGUFReader(tmp / "llm_q8_0.gguf") as r:
        info = r.tensors["output.weight"]
        head = np.array(r.tensor_raw("output.weight"))
        shape = tuple(info.shape)
    with GGUFReader(tmp / "llm.gguf") as r:
        emb = np.array(r.tensor_raw("token_embd.weight")).view(np.uint32)
    bf16 = (emb >> 16).astype(np.uint16).view(np.uint8)
    del emb
    n = int(np.prod(shape))
    for what, raw, kind in (("Q8_0 head output.weight", head, GGMLType.Q8_0),
                            ("BF16 token_embd", bf16, GGMLType.BF16)):
        got, nat_ms = timed(lambda: native.dequantize_native(raw, int(kind), n))
        want, np_ms = timed(lambda: dequantize_numpy(raw, kind, n))
        same_bits(what, got, want)
        row["dequant"][what] = {"shape": shape, "native_ms": nat_ms, "numpy_ms": np_ms,
                                "threads": min(8, os.cpu_count() or 1)}
        log(f"[native] dequant {what} {shape}: native {nat_ms:.1f} ms "
            f"({row['dequant'][what]['threads']} threads), numpy {np_ms:.1f} ms "
            f"({np_ms / nat_ms:.1f}x), bit-equal")
        del got, want
    return row


# ---------------------------------------------------------------------------
# M7: the packed weight upload, its deploy artifact, the native CPU engine
# ---------------------------------------------------------------------------

LOAD_MODELS = (  # (name, GGUF, loader, --llm-quant)
    ("llm dense", "llm.gguf", "llm", ""), ("llm q8_0", "llm_q8_0.gguf", "llm", "q8_0"),
    ("codec", "codec.gguf", "codec", None), ("wavlm", "wavlm.gguf", "wavlm", None))
LOAD_PROMPT = "The quick brown fox jumps over the lazy dog, twice."
LOAD_REQUESTS = (  # (name, extra flags, kernels that must launch, the LLM's packed route)
    ("q8_0-replay", ["--llm-quant", "q8_0"], (k1, k2, k3), "replay"),
    ("dense-raw-q8_0", [], (k1, k2), "packed"),
)
CPU_NATIVE_TOKENS = 64


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def route_counts(r0: dict) -> dict:
    return {k: v - r0[k] for k, v in device_dequant.routes.items() if v != r0[k]}


def load_once(fn) -> tuple[list, dict]:
    """One load on the card, started from a cache emptied of free blocks:
    its leaves copied to the host (the tree itself is dropped, so every
    load starts from the same allocator state), the routes it took, its
    wall seconds split into read (GGUF reads, host casts and quantization:
    the rest), pack, copy and assemble, the MB copied, the bytes
    allocated after it and at its peak, and how many tensors the native
    host runtime dequantized."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r0 = dict(device_dequant.routes)
    d0 = native.calls["mio_dequant"]
    t0 = time.perf_counter()
    tree = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = device_dequant.last_upload
    row = {"wall_s": wall, "read_s": wall - st.pack_s - st.copy_s - st.assemble_s,
           "pack_s": st.pack_s, "copy_s": st.copy_s, "assemble_s": st.assemble_s,
           "mb_copied": st.nbytes / 1e6, "allocated": torch.cuda.memory_allocated() - base,
           "max_allocated": torch.cuda.max_memory_allocated() - base,
           "routes": route_counts(r0), "native_dequants": native.calls["mio_dequant"] - d0}
    host = [t.cpu() for t in tree_leaves(tree)]
    del tree
    return host, row


def check_load(dev, tmp: Path) -> dict:
    """Each of LOAD_MODELS loaded three ways on the card: per leaf
    (MIOTTS_DEVICE_DEQUANT=0), packed (=1, cold: the LLMs write their deploy
    artifact) and again (the LLMs replay the artifact; the codec and WavLM,
    which have none, pack again). Every leaf torch.equal across the three,
    the same bytes allocated after each, each load on its own route with no
    fallback."""
    from miotts_tpu_torch.models.miocodec import load_miocodec
    from miotts_tpu_torch.models.wavlm import load_wavlm

    cache = tmp / "packed"
    rows: dict = {}
    for name, gguf, kind, quant in LOAD_MODELS:
        path = str(tmp / gguf)
        if kind == "llm":
            fn = lambda: load_llm_gguf(path, dev, quantize=quant)[1]  # noqa: E731
        else:
            fn = lambda: (load_miocodec if kind == "codec" else load_wavlm)(path, dev)[1]  # noqa: E731
        third = "replay" if kind == "llm" else "packed"
        rows[name] = {}
        ref = None
        for label, setting, route in (("per_leaf", "0", "per_leaf"), ("packed", "1", "packed"),
                                      (f"{third} (second)", "1", third)):
            with environment(MIOTTS_DEVICE_DEQUANT=setting,
                             MIOTTS_PACKED_CACHE=str(cache) if kind == "llm" else None):
                host, row = load_once(fn)
            if row["routes"] != {route: 1}:
                raise AssertionError(f"[load] {name} {label}: routes {row['routes']}")
            if ref is None:
                ref = host
            elif len(host) != len(ref) or any(
                    a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)
                    for a, b in zip(host, ref)):
                raise AssertionError(f"[load] {name} {label}: leaves differ from per_leaf's")
            rows[name][label] = row
            log(f"[load] {name} {label}: {row['wall_s']:.3f} s wall (read {row['read_s']:.3f}, "
                f"pack {row['pack_s']:.3f}, copy {row['copy_s']:.3f}, assemble "
                f"{row['assemble_s']:.3f}), {row['mb_copied']:.1f} MB copied, allocated "
                f"{row['allocated'] / 2 ** 20:.2f} MiB, max_memory_allocated "
                f"{row['max_allocated'] / 2 ** 20:.2f} MiB; {len(host)} leaves, "
                f"{row['native_dequants']} tensors dequantized natively"
                + ("" if label == "per_leaf" else ", torch.equal to per_leaf's"))
        allocated = {label: r["allocated"] for label, r in rows[name].items()}
        if len(set(allocated.values())) != 1:
            raise AssertionError(f"[load] {name}: allocated bytes differ by route: {allocated}")
    return rows


def check_load_requests(tmp: Path) -> dict:
    """CLI text -> WAV requests on weights the new routes built: --llm-quant
    q8_0 replayed from the load phase's artifact (K3, K2, K1) and the dense
    path on the raw Q8_0 payload dequantized on the card (K2, K1); each
    request's greedy codes equal the same request's on per-leaf weights."""
    cache = tmp / "packed"
    rows = {}
    for name, extra, kernels, route in LOAD_REQUESTS:
        codes, row = {}, {}
        for setting in ("1", "0"):
            tag = f"load-{name}-{'packed' if setting == '1' else 'per_leaf'}"
            r0 = dict(device_dequant.routes)
            with environment(MIOTTS_DEVICE_DEQUANT=setting,
                             MIOTTS_PACKED_CACHE=str(cache) if route == "replay" else None):
                text, n_codes, _, _, grew, _ = drive_cli(
                    tag, tmp, ["-mv", str(tmp / "codec.gguf"), "-m", str(tmp / "llm_q8_0.gguf"),
                               "-p", LOAD_PROMPT, "-n", "120", "--temp", "0", *extra], kernels)
            routes = route_counts(r0)
            # the codec's weights take the packed route (or per leaf) too
            want = ({"per_leaf": 2} if setting == "0" else
                    {"packed": 2} if route == "packed" else {"packed": 1, "replay": 1})
            if routes != want:
                raise AssertionError(f"{tag}: routes {routes}, want {want}")
            codes[setting] = (tmp / f"{tag}.codes").read_text().split()
            row[tag] = {"routes": routes, "codes": n_codes, "launches": launch_text(grew)}
            log(f"[load request] {tag}: {n_codes} codes, routes {routes}, launches "
                f"{launch_text(grew)}")
        if not codes["1"] or codes["1"] != codes["0"]:
            raise AssertionError(f"load request {name}: greedy codes differ from the per-leaf "
                                 f"weights' ({len(codes['1'])} vs {len(codes['0'])})")
        rows[name] = row
    return rows


def check_restart(dev, tmp: Path) -> dict:
    """A server (dense on the Q8_0 GGUF, --warmup off) started twice on one
    artifact directory: cold (GGUF reads and packing; the artifact written)
    and warm (the artifact replayed, its stderr line kept); time to listen
    each time, and one request served on the replayed weights."""
    rows = {}
    with environment(MIOTTS_PACKED_CACHE=str(tmp / "server_packed")):
        for start in ("cold", "warm"):
            gc.collect()
            torch.cuda.empty_cache()
            r0, err = dict(device_dequant.routes), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                srv = start_server(dev, tmp, "llm_q8_0.gguf",
                                   ["-np", "2", "-n", "64", "--ctx-size", "256", "--warmup", "off"])
            listen_s = time.perf_counter() - t0
            try:
                routes = route_counts(r0)
                line = next((s for s in err.getvalue().splitlines()
                             if "packed artifact replay" in s), None)
                res = None
                if start == "warm":  # the replayed weights serve
                    k2_0 = k2.launches
                    res = binary_tts(srv, SERVER_TEXTS[0], 500, f"restart {start}")
                    if k2.launches == k2_0:
                        raise AssertionError(f"restart {start}: the request launched no K2")
            finally:
                srv.shutdown()
            del srv
            want = {"packed": 2} if start == "cold" else {"packed": 1, "replay": 1}
            if routes != want or (start == "warm") != (line is not None):
                raise AssertionError(f"restart {start}: routes {routes}, artifact line {line!r}")
            rows[start] = {"listen_s": listen_s, "routes": routes, "artifact_line": line,
                           "request_s": res and res["latency_s"]}
            log(f"[restart] {start} start: listening after {listen_s:.3f} s, routes {routes}"
                + (f"; {line}; a request served in {res['latency_s']:.3f} s" if res else ""))
    torch.cuda.empty_cache()
    return rows


def check_load_beside_capture(dev, tmp: Path, emb) -> dict:
    """MioTTSEngine.unload_llm() and a reload through the packed route on a
    thread while this thread captures new codec graph keys (B = 2) on the
    engine's pipeline: both succeed, a capture runs during the reload, each
    new key's replay equals its eager decode, and the reloaded engine
    speaks."""
    import threading

    from miotts_tpu_torch.embed import MioTTSEngine

    eng = MioTTSEngine(str(tmp / "codec.gguf"), llm_model=str(tmp / "llm_q8_0.gguf"),
                       device=dev)
    eng.register_reference("voice", str(tmp / "voice.emb.gguf"))
    eng._ensure_llm()
    pipe, cfg = eng.pipeline, eng.pipeline.config
    errors, span = [], {}
    r0 = dict(device_dequant.routes)

    def reload() -> None:
        span["start"] = time.perf_counter()
        try:
            eng.unload_llm()
            eng._ensure_llm()
        except Exception as e:  # raised below, on the main thread
            errors.append(repr(e))
        span["end"] = time.perf_counter()

    th = threading.Thread(target=reload, name="reload")
    th.start()
    captured = []
    for bucket in (64, 128, 256, 32, 512):
        t0 = time.perf_counter()
        graph = pipe.capture(bucket, B=2)
        captured.append({"bucket": bucket, "start": t0, "end": time.perf_counter(),
                         "capture_ms": graph.capture_ms})
        if not th.is_alive():
            break
    th.join()
    if errors:
        raise AssertionError(f"the reload beside a capture failed: {errors}")
    routes = route_counts(r0)
    overlapped = [c["bucket"] for c in captured if c["start"] < span["end"]]
    if routes != {"packed": 1} or not overlapped:
        raise AssertionError(f"reload beside capture: routes {routes}, captures {captured}, "
                             f"reload {span}")
    checks = {}
    for c in captured:
        bucket = c["bucket"]
        tokens, lengths, cond = codec_host(cfg, emb, bucket, [bucket, -(-bucket // 3)], 7)
        c0 = codec_counts()
        got = pipe.decode(tokens, lengths, cond)
        if codec_counts()["replays"] != c0["replays"] + 1:
            raise AssertionError(f"bucket {bucket} B=2: the decode was not a replay")
        checks[bucket] = same_decode(f"bucket {bucket} B=2 captured beside a reload", got,
                                     pipe.decode_eager(tokens, lengths, cond), None,
                                     cfg.sample_rate, False)
    k2_0 = k2.launches
    wav = eng.synthesize_text_to_wav("Hello there.", n_predict=32)
    if wav[:4] != b"RIFF" or k2.launches == k2_0:
        raise AssertionError("the reloaded engine did not speak on the card")
    row = {"reload_s": span["end"] - span["start"], "captures": [
        {"bucket": c["bucket"], "capture_ms": c["capture_ms"],
         "during_reload": c["start"] < span["end"]} for c in captured], "vs_eager": checks}
    capture_ms = ", ".join(f"{c['capture_ms']:.1f}" for c in captured)
    log(f"[load beside capture] reload {row['reload_s']:.3f} s on a thread, packed; captures "
        f"(B=2) at buckets {[c['bucket'] for c in captured]} ({capture_ms} ms), "
        f"{len(overlapped)} during the reload; replays vs eager: {checks}")
    del eng, pipe
    torch.cuda.empty_cache()
    return row


def cpu_model_name() -> str:
    """The host CPU's model: /proc/cpuinfo's "model name" or lscpu's "Model
    name" where either says more than "unknown", else the vendor, family
    and model numbers /proc/cpuinfo gives."""
    import platform

    info: dict = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        lscpu = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        lscpu = ""
    for name in (info.get("model name", ""), lscpu):
        if name and name.lower() != "unknown":
            return name
    return (f"model name not reported; {info.get('vendor_id', platform.machine())} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}")


def native_reread(load_rows: dict, clone_rows: dict) -> dict:
    """The [native] lines' second half, read back from the load and clone
    phases: the per-leaf LLM loads (their tensor reads go through the
    native dequant) and the host decodes of ref3.flac and ref3.mp3 in the
    clone phase."""
    loads = {name: {"wall_s": load_rows["loads"][name]["per_leaf"]["wall_s"],
                    "read_s": load_rows["loads"][name]["per_leaf"]["read_s"],
                    "native_dequants": load_rows["loads"][name]["per_leaf"]["native_dequants"]}
             for name in ("llm dense", "llm q8_0")}
    row = {"per_leaf_loads": loads}
    for name, r in loads.items():
        log(f"[native] {name} per-leaf load {r['wall_s']:.3f} s (read {r['read_s']:.3f} s), "
            f"{r['native_dequants']} tensors dequantized natively")
    for name in ("ref3.flac", "ref3.mp3"):
        ref = clone_rows["references"][name]
        row[name] = {"decoded": ref["decoded"], "decode_ms": ref["decode_ms"]}
        log(f"[native] clone phase {name}: host decode+resample "
            f"{', '.join(f'{x:.1f}' for x in ref['decode_ms'])} ms, {ref['decoded']} "
            f"{name.rsplit('.', 1)[1].upper()} decode")
    return row


@contextlib.contextmanager
def engines_made():
    """The class names of the LLM engines ``cli._make_llm_engine`` builds
    inside the block, in order."""
    made, make = [], cli._make_llm_engine

    def recording(*args, **kwargs):
        engine = make(*args, **kwargs)
        made.append(type(engine).__name__)
        return engine

    cli._make_llm_engine = recording
    try:
        yield made
    finally:
        cli._make_llm_engine = make


def check_cpu_native(tmp: Path) -> dict:
    """``--cpu-native on`` through the CLI: under MIOTTS_PLATFORM=cuda it is
    ignored (the CLI builds the card's engine, K2 launches); under
    MIOTTS_PLATFORM=cpu the CLI builds the native engine, which generates
    CPU_NATIVE_TOKENS tokens on the host from the Q8_0 GGUF as it is and
    requantized to Q4_0 (MIOTTS_CPU_QUANT=q4_0), its tokens/s printed with
    the host CPU's name."""
    with engines_made() as made:
        drive_cli("cpu-native-on-cuda", tmp, [
            "-mv", str(tmp / "codec.gguf"), "-m", str(tmp / "llm_q8_0.gguf"), "-p", LOAD_PROMPT,
            "-n", "48", "--cpu-native", "on"], (k1, k2))
    if made != ["LLMEngine"]:
        raise AssertionError(f"--cpu-native on under MIOTTS_PLATFORM=cuda built {made}")
    cpu = cpu_model_name()
    rows = {"cpu": cpu, "cuda_request": "card engine (K1, K2), LLMEngine built"}
    for quant in ("auto", "q4_0"):
        codes_out, err = tmp / f"cpu-native-{quant}.codes", io.StringIO()
        l0 = {m: m.launches for m in MODS}
        with environment(MIOTTS_PLATFORM="cpu", MIOTTS_CPU_QUANT=quant), \
                contextlib.redirect_stderr(err), engines_made() as made:
            rc = cli.main(["-mv", str(tmp / "codec.gguf"), "-m", str(tmp / "llm_q8_0.gguf"),
                           "-p", LOAD_PROMPT, "-n", str(CPU_NATIVE_TOKENS), "--seed", "1",
                           "--cpu-native", "on", "--tts-mio-codes-only", "--tts-mio-codes-out",
                           str(codes_out)])
        text = err.getvalue()
        m = re.search(r"llm breakdown: generate=([0-9.]+)ms n_tokens=(\d+) tok/s=([0-9.]+)", text)
        if rc != 0 or m is None or made != ["NativeCpuLLMEngine"]:
            raise AssertionError(f"cpu-native {quant}: exited {rc}, built {made}:\n{text[-2000:]}")
        if any(m_.launches != l0[m_] for m_ in MODS):
            raise AssertionError(f"cpu-native {quant}: a kernel launched on the card")
        n_codes = len(codes_out.read_text().split())
        rows[quant] = {"generate_ms": float(m.group(1)), "tokens": int(m.group(2)),
                       "tok_s": float(m.group(3)), "codes": n_codes, "engine": made[0]}
        if rows[quant]["tokens"] < 1 or n_codes < 1:
            raise AssertionError(f"cpu-native {quant}: {rows[quant]}")
        log(f"[cpu_native] MIOTTS_PLATFORM=cpu --cpu-native on MIOTTS_CPU_QUANT={quant} "
            f"(Q8_0 GGUF): {rows[quant]['tokens']} tokens in {rows[quant]['generate_ms']:.1f} "
            f"ms, {rows[quant]['tok_s']:.1f} tok/s, {n_codes} codes, on {cpu} "
            f"({os.cpu_count()} cores seen)")
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.stdout.strip().splitlines()[0])
    dev = select_device("cuda")

    t0 = time.perf_counter()
    # the native host runtime and the C client bridge (g++) build on threads
    # beside the kernels (nvcc)
    from miotts_tpu_torch.bindings import build_client_lib

    bridge: list = []
    host_libs = [threading.Thread(target=native.available, name="native-build"),
                 threading.Thread(target=lambda: bridge.append(build_client_lib(verbose=True)),
                                  name="bridge-build")]
    for t in host_libs:
        t.start()
    lib = build.build(verbose=True)
    build.load_library()
    for t in host_libs:
        t.join()
    if not bridge or bridge[0] is None:
        raise AssertionError("[build] the C client bridge did not build")
    log(f"[build] {lib.name}, the native host runtime "
        f"({native.unavailable_reason() or 'loaded'}) and the C client bridge "
        f"({bridge[0].name}) in {time.perf_counter() - t0:.2f}s")

    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    results = {k1: check_k1(dev, gen), k2: check_k2(dev, gen), k3: check_k3(dev, gen)}
    log(f"[checks] K1-K3 in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fused_rows = check_fused(dev, gen)
    log(f"[checks] K7-K9 in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fused_rows["sample_step"] = check_sampler(dev, gen)
    results.update({k: fused_rows[k.name] for k in FUSED})
    log(f"[checks] K10 in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    gemv_rows = check_gemv(dev, gen)
    results.update({k: gemv_rows[k.name] for k in GEMV})
    log(f"[checks] K11 in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results.update({k4: check_k4(dev, gen), k5: check_k5(dev, gen), k6: check_k6(dev, gen)})
    log(f"[checks] K4-K6 in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="miotts_chip_smoke_") as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        ccfg = full_codec_config()
        # with the global encoder, appended after every other tensor (whose
        # draws it leaves as they were; tests/test_torch_clone.py)
        write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0)
        write_synthetic_llm_gguf(str(tmp / "llm.gguf"), **LLM_WIDTHS)
        write_synthetic_llm_gguf(str(tmp / "llm_q8_0.gguf"), quant="q8_0", **LLM_WIDTHS)
        mcfg = full_mel_codec_config()
        write_synthetic_mel_vocoder_gguf(str(tmp / "mel_codec.gguf"), mcfg, seed=0, ch=VOCODER_CH)
        tame_vocoder_weights(tmp / "mel_codec.gguf")
        wcfg = full_codec441_config()
        write_synthetic_miocodec_gguf(str(tmp / "codec441.gguf"), wcfg, seed=3,
                                      with_global_encoder=False)
        rng = np.random.RandomState(0)
        emb = rng.randn(ccfg.decoder_adanorm_dim).astype(np.float32)
        save_embedding_gguf(tmp / "voice.emb.gguf", emb)
        for n in (40, 400):
            (tmp / f"codes{n}.txt").write_text(
                "\n".join(map(str, rng.randint(0, mcfg.vocab_size, n))))
        clone_assets(tmp)
        log(f"[assets] wave (24 and 44.1 kHz) and mel codecs + 0.1B llm (f32, Q8_0) + "
            f"embedding + WavLM Base+ and references written in "
            f"{time.perf_counter() - t0:.1f}s")
        cfgs = {"wave": ccfg, "wave441": wcfg, "mel": mcfg}

        t0 = time.perf_counter()
        native_rows = check_native(tmp)
        log(f"[native] {time.perf_counter() - t0:.1f}s")

        t0 = time.perf_counter()
        graph_rows = check_graph(dev, tmp)
        log(f"[graph] {time.perf_counter() - t0:.1f}s")

        # each path is driven with every count at 0 and read right after
        launches, streams, codec_rows, server_rows, clone_rows, api_rows = {}, {}, {}, {}, {}, {}
        knob_rows, load_rows, cpu_rows, mesh_rows, sp_rows = {}, {}, {}, {}, {}
        for path, reqs in (("load", None), ("bf16", [(*r, (k1, k2)) for r in REQUESTS]),
                           ("quant", QUANT_REQUESTS), ("mel", MEL_REQUESTS),
                           ("codec_graph", None), ("codec_knobs", None),
                           ("wave441", WAVE441_REQUESTS),
                           ("stream", STREAM_REQUESTS), ("clone", None), ("server", None),
                           ("mesh", None), ("sp", None), ("llm_api", None),
                           ("cpu_native", None)):
            for m in MODS + FUSED + GEMV:
                m.launches = 0
            t0 = time.perf_counter()
            if path == "load":
                load_rows = {"loads": check_load(dev, tmp), "requests": check_load_requests(tmp),
                             "restart": check_restart(dev, tmp),
                             "beside_capture": check_load_beside_capture(dev, tmp, emb)}
            elif path == "cpu_native":
                cpu_rows = check_cpu_native(tmp)
            elif path == "mel":
                for name, extra, kernels in reqs:
                    mel_request(name, tmp, mcfg, extra, kernels)
            elif path == "codec_graph":
                codec_rows = check_codec_graphs(dev, tmp, emb, cfgs)
            elif path == "codec_knobs":
                knob_rows = check_codec_knobs(dev, tmp, emb, cfgs)
            elif path == "wave441":
                for name, extra, kernels in reqs:
                    wave441_request(name, tmp, wcfg, extra, kernels)
            elif path == "server":
                server_rows = check_server(dev, tmp, emb)
            elif path == "mesh":
                mesh_rows = check_mesh(dev, tmp, server_rows)
            elif path == "sp":
                sp_rows = check_sp(dev, tmp, emb)
            elif path == "llm_api":
                api_rows = check_llm_api(dev, tmp, emb)
            elif path == "clone":
                clone_rows = check_clone(dev, tmp, ccfg)
            elif path == "stream":
                for name, codec, model, n_predict, extra, kernels in reqs:
                    streams[name] = stream_request(
                        name, tmp, codec, model, n_predict, extra, kernels,
                        cfgs["mel" if codec.startswith("mel") else
                             "wave441" if "441" in codec else "wave"])
            else:
                for i, (prompt, n_predict, extra, kernels) in enumerate(reqs):
                    run_request(f"{path}-{i}", tmp, prompt, n_predict, extra, ccfg,
                                "llm.gguf" if path == "bf16" else "llm_q8_0.gguf", kernels)
            launches[path] = {m: m.launches for m in MODS + FUSED + GEMV}
            log(f"[{path} path] {time.perf_counter() - t0:.1f}s, launches: "
                f"{launch_text(launches[path])}")
            check_fused_ratio(path, launches[path], path in FUSED_PATHS)

        native_rows["reread"] = native_reread(load_rows, clone_rows)

        fidelity(tmp / "codec.gguf", dev, rng.randint(0, ccfg.vocab_size, 250), emb,
                 ccfg.sample_rate, "wave")
        fidelity(tmp / "codec441.gguf", dev, rng.randint(0, wcfg.vocab_size, 250), emb,
                 wcfg.sample_rate, "wave441")
        t0 = time.perf_counter()
        codec_rows["pool_memory"] = pool_memory(dev, tmp)
        log(f"[codec graph] pool memory in {time.perf_counter() - t0:.1f}s")
        trace_row = check_trace(tmp)

    if any(m == "jax" or m.startswith(("jax.", "miotts_tpu.")) or m == "miotts_tpu"
           for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    kernels = []
    for name, mod in (("banded_attention", k1), ("decode_attention", k2), ("q8_matmul", k3),
                      ("conv1d_same", k4), ("activation1d", k5), ("resblock_layer", k6)):
        by_path = {path: n[mod] for path, n in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                        "replaces": mod.REPLACES, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **results[mod]})
    for kern in FUSED + GEMV:
        by_path = {path: n[kern] for path, n in launches.items()}
        source = (llm_fused.SAMPLE_SOURCE if kern is llm_fused.SAMPLE_STEP
                  else llm_gemv.SOURCE if kern in GEMV else llm_fused.SOURCE)
        kernels.append({"name": kern.name, "route": "cuda", "source": source,
                        "replaces": llm_fused.REPLACES, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **results[kern]})
    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    log(smi.stdout.strip().splitlines()[0])  # again, for readers of the output's tail
    print(json.dumps({"decode_graph": graph_rows, "codec_graph": codec_rows,
                      "codec_knobs": knob_rows, "streams": streams,
                      "server": server_rows, "clone": clone_rows, "llm_api": api_rows,
                      "trace": trace_row, "load": load_rows, "cpu_native": cpu_rows,
                      "mesh": mesh_rows, "sp": sp_rows, "native": native_rows},
                     default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
