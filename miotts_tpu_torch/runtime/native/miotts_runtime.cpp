// miotts_runtime — the port's native host runtime, a copy of the JAX
// package's miotts_tpu/runtime/native/miotts_runtime.cpp (ABI 6): the
// persistent worker pool, fp16/bf16 conversion, the threaded whole-tensor
// GGUF dequant (mio_dequant), the WAV encoder (mio_encode_wav16), the linear
// resampler (mio_resample_linear[_len]), mio_peak_normalize, the native CPU
// LLM engine's block-quant kernels (per-32-block activation quantization,
// the Q8_0/Q4_0 row dots with AVX2, AVX-512 VNNI on request or scalar, the
// GEMV, batched-prefill GEMM and row-dequant entry points), the FLAC decoder
// (mio_flac_probe, mio_flac_decode) and the mp3 decoder (namespace mp3impl,
// mio_mp3_probe, mio_mp3_decode, its constants in mp3_tables.h, generated by
// scripts/gen_torch_mp3_tables_h.py). The code is copied, not rewritten, so
// every value is bit-equal to the JAX library's on valid streams without a
// VBR tag frame. Three changes, each where a stream from outside reaches the
// code: flac_subframe refuses a predictor order above the frame's block
// size before it writes the warm-up samples (JAX's copy writes past the
// frame's buffer first and refuses the frame after); the mp3 decoder skips a
// stream's leading Xing/Info/VBRI frame (JAX's decodes it as silence); and
// its frame scan is runtime/mp3.py's (bytes that are no frame are skipped
// between frames too, and a frame that runs past the end ends the scan), so
// a corrupt stream decodes as the numpy decoder decodes it.
// Plain C ABI, consumed from Python via ctypes (runtime/native.py).
//
// Build: miotts_tpu_torch/runtime/build_native.py (g++ -O3 -march=native),
// at first use, into build/miotts_tpu_torch/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include "mp3_tables.h"

// ---------------------------------------------------------------------------
// persistent gemv worker pool
//
// The decode step issues ~85 gemv calls per token; spawning and joining
// std::threads per call costs more than the small dim-768 dots themselves
// (llama.cpp keeps a persistent pool for the same reason). Workers park on
// a condition variable between calls; every worker runs the posted body,
// which claims row chunks from a shared atomic counter, so a run with any
// worker count is correct. Lazily grown, joined at process exit.
// ---------------------------------------------------------------------------

namespace {

class GemvPool {
  public:
    static GemvPool& get() {
        static GemvPool pool;
        return pool;
    }

    // run `body` on the caller plus up to `extra` pool workers; returns
    // when every participant has finished. `body` must be re-entrant
    // (claim work via an atomic counter). Concurrent callers (two engine
    // threads) serialize on run_m_ — the pool is one shared resource.
    void run(int extra, const std::function<void()>& body) {
        std::lock_guard<std::mutex> run_lk(run_m_);
        {
            std::unique_lock<std::mutex> lk(m_);
            while ((int)workers_.size() < extra)
                workers_.emplace_back(&GemvPool::worker_main, this);
            body_ = &body;
            busy_ = (int)workers_.size();
            ++gen_;
        }
        cv_.notify_all();
        body();
        std::unique_lock<std::mutex> lk(m_);
        done_cv_.wait(lk, [&] { return busy_ == 0; });
        body_ = nullptr;
    }

    ~GemvPool() {
        {
            std::lock_guard<std::mutex> lk(m_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }

  private:
    void worker_main() {
        uint64_t seen = 0;
        for (;;) {
            const std::function<void()>* body;
            {
                std::unique_lock<std::mutex> lk(m_);
                cv_.wait(lk, [&] { return stop_ || gen_ != seen; });
                if (stop_) return;
                seen = gen_;
                body = body_;
            }
            (*body)();
            {
                std::lock_guard<std::mutex> lk(m_);
                if (--busy_ == 0) done_cv_.notify_one();
            }
        }
    }

    std::mutex run_m_;
    std::mutex m_;
    std::condition_variable cv_, done_cv_;
    std::vector<std::thread> workers_;
    const std::function<void()>* body_ = nullptr;
    uint64_t gen_ = 0;
    int busy_ = 0;
    bool stop_ = false;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// half/bfloat conversion
// ---------------------------------------------------------------------------

#if defined(__F16C__) || defined(__aarch64__)
static inline float fp16_to_fp32(uint16_t h) {
    _Float16 f;
    std::memcpy(&f, &h, 2);
    return (float)f;
}
#else
static inline float fp16_to_fp32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {
            // subnormal: normalize
            int e = -1;
            do {
                mant <<= 1;
                e++;
            } while (!(mant & 0x400));
            mant &= 0x3FF;
            bits = sign | ((uint32_t)(127 - 15 - e) << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp + 112) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}
#endif

// ---------------------------------------------------------------------------
// dequantization (GGML block formats)
// ---------------------------------------------------------------------------

static void dequant_f16(const uint8_t* raw, float* out, int64_t n) {
    const uint16_t* src = (const uint16_t*)raw;
    for (int64_t i = 0; i < n; ++i) out[i] = fp16_to_fp32(src[i]);
}

static void dequant_bf16(const uint8_t* raw, float* out, int64_t n) {
    const uint16_t* src = (const uint16_t*)raw;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits = (uint32_t)src[i] << 16;
        std::memcpy(&out[i], &bits, 4);
    }
}

static void dequant_q8_0(const uint8_t* raw, float* out, int64_t n) {
    const int64_t nb = n / 32;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = raw + b * 34;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const float d = fp16_to_fp32(dh);
        const int8_t* q = (const int8_t*)(blk + 2);
        float* o = out + b * 32;
        for (int i = 0; i < 32; ++i) o[i] = d * (float)q[i];
    }
}

static void dequant_q4_0(const uint8_t* raw, float* out, int64_t n) {
    const int64_t nb = n / 32;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = raw + b * 18;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const float d = fp16_to_fp32(dh);
        const uint8_t* qs = blk + 2;
        float* o = out + b * 32;
        for (int i = 0; i < 16; ++i) {
            o[i] = d * (float)((int)(qs[i] & 0x0F) - 8);
            o[i + 16] = d * (float)((int)(qs[i] >> 4) - 8);
        }
    }
}

static void dequant_q6_k(const uint8_t* raw, float* out, int64_t n) {
    const int64_t nb = n / 256;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = raw + b * 210;
        const uint8_t* ql = blk;
        const uint8_t* qh = blk + 128;
        const int8_t* sc = (const int8_t*)(blk + 192);
        uint16_t dh;
        std::memcpy(&dh, blk + 208, 2);
        const float d = fp16_to_fp32(dh);
        float* y = out + b * 256;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* qlh = ql + half * 64;
            const uint8_t* qhh = qh + half * 32;
            const int8_t* sch = sc + half * 8;
            float* yh = y + half * 128;
            for (int l = 0; l < 32; ++l) {
                const int is = l / 16;
                const int q1 = (int)((qlh[l] & 0xF) | (((qhh[l] >> 0) & 3) << 4)) - 32;
                const int q2 = (int)((qlh[l + 32] & 0xF) | (((qhh[l] >> 2) & 3) << 4)) - 32;
                const int q3 = (int)((qlh[l] >> 4) | (((qhh[l] >> 4) & 3) << 4)) - 32;
                const int q4 = (int)((qlh[l + 32] >> 4) | (((qhh[l] >> 6) & 3) << 4)) - 32;
                yh[l] = d * sch[is] * q1;
                yh[l + 32] = d * sch[is + 2] * q2;
                yh[l + 64] = d * sch[is + 4] * q3;
                yh[l + 96] = d * sch[is + 6] * q4;
            }
        }
    }
}

// type ids match miotts_tpu.gguf.quants.GGMLType
// returns 0 on success, -1 unsupported type, -2 bad size
int mio_dequant(int ggml_type, const uint8_t* raw, float* out, int64_t n,
                int n_threads) {
    int64_t block = 1;
    void (*fn)(const uint8_t*, float*, int64_t) = nullptr;
    int64_t bytes_per_block = 0;
    switch (ggml_type) {
        case 1: fn = dequant_f16; block = 1; bytes_per_block = 2; break;
        case 30: fn = dequant_bf16; block = 1; bytes_per_block = 2; break;
        case 8: fn = dequant_q8_0; block = 32; bytes_per_block = 34; break;
        case 2: fn = dequant_q4_0; block = 32; bytes_per_block = 18; break;
        case 14: fn = dequant_q6_k; block = 256; bytes_per_block = 210; break;
        case 0:  // f32 passthrough
            std::memcpy(out, raw, (size_t)n * 4);
            return 0;
        default: return -1;
    }
    if (n % block != 0) return -2;

    const int64_t n_blocks = n / block;
    n_threads = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads, n_blocks));
    if (n_threads == 1 || n_blocks < 1024) {
        fn(raw, out, n);
        return 0;
    }
    std::vector<std::thread> workers;
    const int64_t per = (n_blocks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b0 = t * per;
        const int64_t b1 = std::min(n_blocks, b0 + per);
        if (b0 >= b1) break;
        workers.emplace_back([=]() {
            fn(raw + b0 * bytes_per_block, out + b0 * block, (b1 - b0) * block);
        });
    }
    for (auto& w : workers) w.join();
    return 0;
}

// ---------------------------------------------------------------------------
// audio: wav16 encode + linear resample
// ---------------------------------------------------------------------------

// out must have 44 + 2*n bytes; matches mio-tts-lib.cpp:758-791
int mio_encode_wav16(const float* audio, int64_t n, int sample_rate,
                     uint8_t* out) {
    const uint32_t data_size = (uint32_t)(n * 2);
    const uint32_t byte_rate = (uint32_t)sample_rate * 2;
    uint8_t* p = out;
    auto w32 = [&](uint32_t v) { std::memcpy(p, &v, 4); p += 4; };
    auto w16 = [&](uint16_t v) { std::memcpy(p, &v, 2); p += 2; };
    std::memcpy(p, "RIFF", 4); p += 4;
    w32(36 + data_size);
    std::memcpy(p, "WAVE", 4); p += 4;
    std::memcpy(p, "fmt ", 4); p += 4;
    w32(16); w16(1); w16(1); w32((uint32_t)sample_rate); w32(byte_rate);
    w16(2); w16(16);
    std::memcpy(p, "data", 4); p += 4;
    w32(data_size);
    int16_t* pcm = (int16_t*)p;
    for (int64_t i = 0; i < n; ++i) {
        float x = audio[i];
        x = std::max(-1.0f, std::min(1.0f, x));
        pcm[i] = (int16_t)std::lrintf(x * 32767.0f);
    }
    return 0;
}

// linear resampler, same mapping as wavlm-extractor.cpp:218-240
int64_t mio_resample_linear_len(int64_t n_in, int sr_in, int sr_out) {
    if (sr_in == sr_out) return n_in;
    const double ratio = (double)sr_out / (double)sr_in;
    int64_t n = (int64_t)std::llround((double)n_in * ratio);
    return n < 1 ? 1 : n;
}

int mio_resample_linear(const float* in, int64_t n_in, int sr_in, int sr_out,
                        float* out, int64_t n_out) {
    if (n_in <= 0 || n_out <= 0) return -1;
    if (sr_in == sr_out) {
        std::memcpy(out, in, (size_t)std::min(n_in, n_out) * 4);
        return 0;
    }
    const double ratio = (double)sr_out / (double)sr_in;
    for (int64_t i = 0; i < n_out; ++i) {
        const double pos = (double)i / ratio;
        int64_t i0 = (int64_t)std::floor(pos);
        const double t = pos - (double)i0;
        if (i0 < 0) i0 = 0;
        const int64_t i1 = std::min(n_in - 1, i0 + 1);
        i0 = std::min(n_in - 1, i0);
        out[i] = (float)((1.0 - t) * (double)in[i0] + t * (double)in[i1]);
    }
    return 0;
}

// peak normalization used before WavLM (wavlm-extractor.cpp:205-216)
void mio_peak_normalize(float* audio, int64_t n) {
    float max_abs = 0.0f;
    for (int64_t i = 0; i < n; ++i) max_abs = std::max(max_abs, std::fabs(audio[i]));
    max_abs += 1e-8f;
    const float inv = 1.0f / max_abs;
    for (int64_t i = 0; i < n; ++i) audio[i] *= inv;
}

// ---------------------------------------------------------------------------
// int8 CPU decode kernels (the local real-time text->speech path)
//
// The reference's core promise is LOCAL inference: llama.cpp's int8 CPU
// gemv decodes the 0.1B in real time on a laptop (mio-tts-lib.cpp:814 via
// the llama.cpp submodule). XLA:CPU runs while_loop-body gemvs strided and
// single-threaded (~2-3 tok/s, DESIGN.md "Local CPU fallback"), so the CPU
// decode path keeps weights as GGUF Q8_0 blocks (32 int8 + f16 scale) and
// runs llama.cpp-style block-int8 dots: activations quantize to the same
// 32-block int8 layout, each block contributes (int32 dot) * d_w * d_x.
// Rows parallelize over threads (memory-bandwidth-bound: ~1 byte/weight).
// ---------------------------------------------------------------------------

// per-32-block activation quantization (llama.cpp quantize_row_q8_0)
void mio_q8_quantize_act(const float* x, int64_t k, int8_t* q, float* s) {
    const int64_t nb = k / 32;
    for (int64_t b = 0; b < nb; ++b) {
        const float* xb = x + b * 32;
        float amax = 0.0f;
        for (int i = 0; i < 32; ++i) amax = std::max(amax, std::fabs(xb[i]));
        const float d = amax / 127.0f;
        const float inv = d > 0.0f ? 1.0f / d : 0.0f;
        s[b] = d;
        int8_t* qb = q + b * 32;
        for (int i = 0; i < 32; ++i)
            qb[i] = (int8_t)std::lrintf(xb[i] * inv);
    }
}

// per-32-block activation sums (for the unsigned-offset dot tricks below:
// sum((w+128)*x) = dot + 128*bsum for Q8_0, sum((q-8)*x) = dot - 8*bsum for
// Q4_0 nibbles). Shared across all rows of a gemv call.
static void act_block_sums(const int8_t* xq, int64_t nb, int32_t* bs) {
    for (int64_t b = 0; b < nb; ++b) {
        const int8_t* xb = xq + b * 32;
        int32_t s = 0;
        for (int i = 0; i < 32; ++i) s += xb[i];
        bs[b] = s;
    }
}

// one Q8_0 row (k/32 blocks of [f16 scale + 32 int8]) dot a quantized
// activation.
// ISA selection: AVX2 is the default even where AVX-512 VNNI exists —
// measured on this class of cloud vCPU the 512-bit dpbusd path is SLOWER
// (throttled/split 512-bit units): q4 large-N gemv 8.6-9.5 ms AVX2 vs
// 11.4-15.7 ms VNNI, q8 within noise. Build with -DMIOTTS_VNNI to opt in
// on hardware with full-rate AVX-512.
#if defined(__AVX512VNNI__) && defined(__AVX512BW__) && defined(MIOTTS_VNNI)
#include <immintrin.h>
static inline float q8_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* bsums,
                               int64_t nb) {
    // VPDPBUSD wants u8*s8: bias the weight to unsigned (w+128 = w^0x80)
    // and correct with -128*sum(x) per block. The 4-product i32 adds
    // cannot overflow (4*255*127 < 2^31); 2 blocks (64 weights) per step,
    // two accumulators to hide FMA latency.
    __m512 accf = _mm512_setzero_ps();
    __m512 accf2 = _mm512_setzero_ps();
    const __m512i bias = _mm512_set1_epi8((char)0x80);
    const __m512i zero = _mm512_setzero_si512();
    float corr = 0.0f;
    int64_t b = 0;
    for (; b + 4 <= nb; b += 4) {
        const uint8_t* blk = row + b * 34;
        _mm_prefetch((const char*)(blk + 1024), _MM_HINT_T0);
        uint16_t dh0, dh1, dh2, dh3;
        std::memcpy(&dh0, blk, 2);
        std::memcpy(&dh1, blk + 34, 2);
        std::memcpy(&dh2, blk + 68, 2);
        std::memcpy(&dh3, blk + 102, 2);
        const __m512i w01 = _mm512_inserti64x4(
            _mm512_castsi256_si512(
                _mm256_loadu_si256((const __m256i*)(blk + 2))),
            _mm256_loadu_si256((const __m256i*)(blk + 36)), 1);
        const __m512i w23 = _mm512_inserti64x4(
            _mm512_castsi256_si512(
                _mm256_loadu_si256((const __m256i*)(blk + 70))),
            _mm256_loadu_si256((const __m256i*)(blk + 104)), 1);
        const __m512i x01 = _mm512_loadu_si512(xq + b * 32);
        const __m512i x23 = _mm512_loadu_si512(xq + b * 32 + 64);
        const __m512i p01 = _mm512_dpbusd_epi32(
            zero, _mm512_xor_si512(w01, bias), x01);
        const __m512i p23 = _mm512_dpbusd_epi32(
            zero, _mm512_xor_si512(w23, bias), x23);
        const float s0 = fp16_to_fp32(dh0) * xs[b];
        const float s1 = fp16_to_fp32(dh1) * xs[b + 1];
        const float s2 = fp16_to_fp32(dh2) * xs[b + 2];
        const float s3 = fp16_to_fp32(dh3) * xs[b + 3];
        const __m512 sc01 = _mm512_insertf32x8(
            _mm512_castps256_ps512(_mm256_set1_ps(s0)),
            _mm256_set1_ps(s1), 1);
        const __m512 sc23 = _mm512_insertf32x8(
            _mm512_castps256_ps512(_mm256_set1_ps(s2)),
            _mm256_set1_ps(s3), 1);
        accf = _mm512_fmadd_ps(_mm512_cvtepi32_ps(p01), sc01, accf);
        accf2 = _mm512_fmadd_ps(_mm512_cvtepi32_ps(p23), sc23, accf2);
        corr += 128.0f * (s0 * (float)bsums[b] + s1 * (float)bsums[b + 1] +
                          s2 * (float)bsums[b + 2] + s3 * (float)bsums[b + 3]);
    }
    float acc = _mm512_reduce_add_ps(_mm512_add_ps(accf, accf2)) - corr;
    for (; b < nb; ++b) {
        const uint8_t* blk = row + b * 34;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const int8_t* wq = (const int8_t*)(blk + 2);
        const int8_t* xb = xq + b * 32;
        int32_t isum = 0;
        for (int i = 0; i < 32; ++i)
            isum += (int32_t)wq[i] * (int32_t)xb[i];
        acc += (float)isum * fp16_to_fp32(dh) * xs[b];
    }
    return acc;
}
#elif defined(__AVXVNNI__)
#include <immintrin.h>
// AVX-VNNI (256-bit dpbusd — Alder-Lake/Sapphire class, and NOT subject to
// the 512-bit throttling that made the AVX-512 path lose above): one
// vpdpbusd replaces the maddubs+madd pair. dpbusd wants u8*s8, so the
// weight biases to unsigned (w^0x80 = w+128) and -128*sum(x) corrects per
// block; the 4-product i32 adds cannot overflow (4*255*127 < 2^31).
static inline float q8_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* bsums,
                               int64_t nb) {
    __m256 accf = _mm256_setzero_ps();
    __m256 accf2 = _mm256_setzero_ps();
    const __m256i bias = _mm256_set1_epi8((char)0x80);
    const __m256i zero = _mm256_setzero_si256();
    float corr = 0.0f;
    int64_t b = 0;
    for (; b + 2 <= nb; b += 2) {
        const uint8_t* blk = row + b * 34;
        _mm_prefetch((const char*)(blk + 1024), _MM_HINT_T0);
        uint16_t dh0, dh1;
        std::memcpy(&dh0, blk, 2);
        std::memcpy(&dh1, blk + 34, 2);
        const __m256i w0 = _mm256_xor_si256(
            _mm256_loadu_si256((const __m256i*)(blk + 2)), bias);
        const __m256i w1 = _mm256_xor_si256(
            _mm256_loadu_si256((const __m256i*)(blk + 36)), bias);
        const __m256i x0 = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i x1 = _mm256_loadu_si256(
            (const __m256i*)(xq + b * 32 + 32));
        const __m256i p0 = _mm256_dpbusd_avx_epi32(zero, w0, x0);
        const __m256i p1 = _mm256_dpbusd_avx_epi32(zero, w1, x1);
        const float s0 = fp16_to_fp32(dh0) * xs[b];
        const float s1 = fp16_to_fp32(dh1) * xs[b + 1];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p0),
                               _mm256_set1_ps(s0), accf);
        accf2 = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p1),
                                _mm256_set1_ps(s1), accf2);
        corr += 128.0f * (s0 * (float)bsums[b] + s1 * (float)bsums[b + 1]);
    }
    for (; b < nb; ++b) {
        const uint8_t* blk = row + b * 34;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const __m256i w = _mm256_xor_si256(
            _mm256_loadu_si256((const __m256i*)(blk + 2)), bias);
        const __m256i x = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i p = _mm256_dpbusd_avx_epi32(zero, w, x);
        const float s = fp16_to_fp32(dh) * xs[b];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p),
                               _mm256_set1_ps(s), accf);
        corr += 128.0f * s * (float)bsums[b];
    }
    accf = _mm256_add_ps(accf, accf2);
    __m128 lo = _mm_add_ps(_mm256_castps256_ps128(accf),
                           _mm256_extractf128_ps(accf, 1));
    lo = _mm_hadd_ps(lo, lo);
    lo = _mm_hadd_ps(lo, lo);
    return _mm_cvtss_f32(lo) - corr;
}
#elif defined(__AVX2__)
#include <immintrin.h>
static inline float q8_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* /*bsums*/,
                               int64_t nb) {
    // llama.cpp-style s8*s8 dot: maddubs wants u8*s8, so fold the weight's
    // sign into the activation (|w| * sign(x, w)); pair sums <= 2*127*127
    // stay under the i16 saturation limit
    __m256 accf = _mm256_setzero_ps();
    __m256 accf2 = _mm256_setzero_ps();
    const __m256i ones16 = _mm256_set1_epi16(1);
    int64_t b = 0;
    for (; b + 2 <= nb; b += 2) {
        const uint8_t* blk = row + b * 34;
        _mm_prefetch((const char*)(blk + 1024), _MM_HINT_T0);
        uint16_t dh0, dh1;
        std::memcpy(&dh0, blk, 2);
        std::memcpy(&dh1, blk + 34, 2);
        const __m256i wq0 = _mm256_loadu_si256((const __m256i*)(blk + 2));
        const __m256i wq1 = _mm256_loadu_si256((const __m256i*)(blk + 36));
        const __m256i xb0 = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i xb1 = _mm256_loadu_si256((const __m256i*)(xq + b * 32 + 32));
        const __m256i p0 = _mm256_madd_epi16(
            _mm256_maddubs_epi16(_mm256_sign_epi8(wq0, wq0),
                                 _mm256_sign_epi8(xb0, wq0)), ones16);
        const __m256i p1 = _mm256_madd_epi16(
            _mm256_maddubs_epi16(_mm256_sign_epi8(wq1, wq1),
                                 _mm256_sign_epi8(xb1, wq1)), ones16);
        accf = _mm256_fmadd_ps(
            _mm256_cvtepi32_ps(p0),
            _mm256_set1_ps(fp16_to_fp32(dh0) * xs[b]), accf);
        accf2 = _mm256_fmadd_ps(
            _mm256_cvtepi32_ps(p1),
            _mm256_set1_ps(fp16_to_fp32(dh1) * xs[b + 1]), accf2);
    }
    for (; b < nb; ++b) {
        const uint8_t* blk = row + b * 34;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const __m256i wq = _mm256_loadu_si256((const __m256i*)(blk + 2));
        const __m256i xb = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i aw = _mm256_sign_epi8(wq, wq);
        const __m256i sx = _mm256_sign_epi8(xb, wq);
        const __m256i p16 = _mm256_maddubs_epi16(aw, sx);
        const __m256i p32 = _mm256_madd_epi16(p16, ones16);
        const float d = fp16_to_fp32(dh) * xs[b];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p32),
                               _mm256_set1_ps(d), accf);
    }
    accf = _mm256_add_ps(accf, accf2);
    __m128 lo = _mm256_castps256_ps128(accf);
    __m128 hi = _mm256_extractf128_ps(accf, 1);
    lo = _mm_add_ps(lo, hi);
    lo = _mm_hadd_ps(lo, lo);
    lo = _mm_hadd_ps(lo, lo);
    return _mm_cvtss_f32(lo);
}
#else
static inline float q8_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* /*bsums*/,
                               int64_t nb) {
    float acc = 0.0f;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = row + b * 34;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const int8_t* wq = (const int8_t*)(blk + 2);
        const int8_t* xb = xq + b * 32;
        int32_t isum = 0;
        for (int i = 0; i < 32; ++i)
            isum += (int32_t)wq[i] * (int32_t)xb[i];
        acc += (float)isum * fp16_to_fp32(dh) * xs[b];
    }
    return acc;
}
#endif

// y[N] = W[N, K] (raw Q8_0, row-major) @ x (pre-quantized); threaded rows
void mio_q8_gemv(const uint8_t* w, const int8_t* xq, const float* xs,
                 int64_t n, int64_t k, float* y, int n_threads) {
    const int64_t nb = k / 32;
    const int64_t row_bytes = nb * 34;
    std::vector<int32_t> bsums((size_t)nb);
    act_block_sums(xq, nb, bsums.data());
    const int32_t* bs = bsums.data();
    // below ~1M weights the condvar wake costs more than it buys
    if (n_threads <= 1 || n * k < (int64_t)1 << 20) {
        for (int64_t r = 0; r < n; ++r)
            y[r] = q8_row_dot(w + r * row_bytes, xq, xs, bs, nb);
        return;
    }
    std::atomic<int64_t> next(0);
    GemvPool::get().run(n_threads - 1, [&]() {
        const int64_t chunk = 64;
        for (;;) {
            const int64_t r0 = next.fetch_add(chunk);
            if (r0 >= n) break;
            const int64_t r1 = std::min(n, r0 + chunk);
            for (int64_t r = r0; r < r1; ++r)
                y[r] = q8_row_dot(w + r * row_bytes, xq, xs, bs, nb);
        }
    });
}

// convenience: quantize activation then gemv (one call per matmul)
void mio_q8_gemv_f32(const uint8_t* w, const float* x, int64_t n, int64_t k,
                     float* y, int8_t* scratch_q, float* scratch_s,
                     int n_threads) {
    mio_q8_quantize_act(x, k, scratch_q, scratch_s);
    mio_q8_gemv(w, scratch_q, scratch_s, n, k, y, n_threads);
}

// dequantize one Q8_0 row (embedding lookup)
void mio_q8_row_dequant(const uint8_t* w, int64_t row, int64_t k, float* out) {
    const int64_t nb = k / 32;
    const uint8_t* r = w + row * nb * 34;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = r + b * 34;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const float d = fp16_to_fp32(dh);
        const int8_t* q = (const int8_t*)(blk + 2);
        for (int i = 0; i < 32; ++i) out[b * 32 + i] = d * (float)q[i];
    }
}

// ---------------------------------------------------------------------------
// Q4_0 decode kernels (W4A8 local path — half the weight traffic of Q8_0)
//
// Q4_0 block = f16 scale + 16 bytes of nibbles: element i in 0..15 is the
// LOW nibble of byte i, element i+16 the HIGH nibble, each biased by +8
// (llama.cpp ggml block_q4_0; same layout gguf/quants.py:_dequant_q4_0
// reads). Activations reuse the per-32-block int8 quantization above, so
// one quantize pass feeds both Q8_0 and Q4_0 matmuls in a mixed model.
// Memory traffic is ~0.56 bytes/weight — on the bandwidth-bound gemv this
// is ~2x Q8_0 tokens/s, which is what clears real time on low-bandwidth
// hosts (DESIGN.md "Local CPU fallback" roofline).
// ---------------------------------------------------------------------------

#if defined(__AVX512VNNI__) && defined(__AVX512BW__) && defined(MIOTTS_VNNI)
static inline float q4_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* bsums,
                               int64_t nb) {
    // nibbles stay UNSIGNED [0,15] — exactly what VPDPBUSD wants on the u8
    // side — and the +8 bias is corrected with -8*sum(x) per block. No
    // sign-folding at all; 2 blocks (64 weights) per dpbusd.
    __m512 accf = _mm512_setzero_ps();
    __m512 accf2 = _mm512_setzero_ps();
    const __m128i m4 = _mm_set1_epi8(0x0F);
    const __m512i zero = _mm512_setzero_si512();
    float corr = 0.0f;
    int64_t b = 0;
    for (; b + 4 <= nb; b += 4) {
        const uint8_t* blk = row + b * 18;
        _mm_prefetch((const char*)(blk + 512), _MM_HINT_T0);
        uint16_t dh0, dh1, dh2, dh3;
        std::memcpy(&dh0, blk, 2);
        std::memcpy(&dh1, blk + 18, 2);
        std::memcpy(&dh2, blk + 36, 2);
        std::memcpy(&dh3, blk + 54, 2);
        const __m128i n0 = _mm_loadu_si128((const __m128i*)(blk + 2));
        const __m128i n1 = _mm_loadu_si128((const __m128i*)(blk + 20));
        const __m128i n2 = _mm_loadu_si128((const __m128i*)(blk + 38));
        const __m128i n3 = _mm_loadu_si128((const __m128i*)(blk + 56));
        const __m512i w01 = _mm512_inserti64x4(
            _mm512_castsi256_si512(_mm256_set_m128i(
                _mm_and_si128(_mm_srli_epi16(n0, 4), m4),
                _mm_and_si128(n0, m4))),
            _mm256_set_m128i(_mm_and_si128(_mm_srli_epi16(n1, 4), m4),
                             _mm_and_si128(n1, m4)), 1);
        const __m512i w23 = _mm512_inserti64x4(
            _mm512_castsi256_si512(_mm256_set_m128i(
                _mm_and_si128(_mm_srli_epi16(n2, 4), m4),
                _mm_and_si128(n2, m4))),
            _mm256_set_m128i(_mm_and_si128(_mm_srli_epi16(n3, 4), m4),
                             _mm_and_si128(n3, m4)), 1);
        const __m512i x01 = _mm512_loadu_si512(xq + b * 32);
        const __m512i x23 = _mm512_loadu_si512(xq + b * 32 + 64);
        const __m512i p01 = _mm512_dpbusd_epi32(zero, w01, x01);
        const __m512i p23 = _mm512_dpbusd_epi32(zero, w23, x23);
        const float s0 = fp16_to_fp32(dh0) * xs[b];
        const float s1 = fp16_to_fp32(dh1) * xs[b + 1];
        const float s2 = fp16_to_fp32(dh2) * xs[b + 2];
        const float s3 = fp16_to_fp32(dh3) * xs[b + 3];
        const __m512 sc01 = _mm512_insertf32x8(
            _mm512_castps256_ps512(_mm256_set1_ps(s0)),
            _mm256_set1_ps(s1), 1);
        const __m512 sc23 = _mm512_insertf32x8(
            _mm512_castps256_ps512(_mm256_set1_ps(s2)),
            _mm256_set1_ps(s3), 1);
        accf = _mm512_fmadd_ps(_mm512_cvtepi32_ps(p01), sc01, accf);
        accf2 = _mm512_fmadd_ps(_mm512_cvtepi32_ps(p23), sc23, accf2);
        corr += 8.0f * (s0 * (float)bsums[b] + s1 * (float)bsums[b + 1] +
                        s2 * (float)bsums[b + 2] + s3 * (float)bsums[b + 3]);
    }
    float acc = _mm512_reduce_add_ps(_mm512_add_ps(accf, accf2)) - corr;
    for (; b < nb; ++b) {
        const uint8_t* blk = row + b * 18;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const uint8_t* qs = blk + 2;
        const int8_t* xb = xq + b * 32;
        int32_t isum = 0;
        for (int i = 0; i < 16; ++i) {
            isum += ((int32_t)(qs[i] & 0x0F) - 8) * (int32_t)xb[i];
            isum += ((int32_t)(qs[i] >> 4) - 8) * (int32_t)xb[i + 16];
        }
        acc += (float)isum * fp16_to_fp32(dh) * xs[b];
    }
    return acc;
}
#elif defined(__AVXVNNI__)
static inline float q4_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* bsums,
                               int64_t nb) {
    // unsigned nibbles feed vpdpbusd directly (u8 side); -8*sum(x)
    // corrects the +8 bias per block. 256-bit VNNI: no 512-bit throttle.
    __m256 accf = _mm256_setzero_ps();
    __m256 accf2 = _mm256_setzero_ps();
    const __m128i m4 = _mm_set1_epi8(0x0F);
    const __m256i zero = _mm256_setzero_si256();
    float corr = 0.0f;
    int64_t b = 0;
    for (; b + 2 <= nb; b += 2) {
        const uint8_t* blk = row + b * 18;
        _mm_prefetch((const char*)(blk + 512), _MM_HINT_T0);
        uint16_t dh0, dh1;
        std::memcpy(&dh0, blk, 2);
        std::memcpy(&dh1, blk + 18, 2);
        const __m128i qs0 = _mm_loadu_si128((const __m128i*)(blk + 2));
        const __m128i qs1 = _mm_loadu_si128((const __m128i*)(blk + 20));
        const __m256i w0 = _mm256_set_m128i(
            _mm_and_si128(_mm_srli_epi16(qs0, 4), m4),
            _mm_and_si128(qs0, m4));
        const __m256i w1 = _mm256_set_m128i(
            _mm_and_si128(_mm_srli_epi16(qs1, 4), m4),
            _mm_and_si128(qs1, m4));
        const __m256i x0 = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i x1 = _mm256_loadu_si256(
            (const __m256i*)(xq + b * 32 + 32));
        const __m256i p0 = _mm256_dpbusd_avx_epi32(zero, w0, x0);
        const __m256i p1 = _mm256_dpbusd_avx_epi32(zero, w1, x1);
        const float s0 = fp16_to_fp32(dh0) * xs[b];
        const float s1 = fp16_to_fp32(dh1) * xs[b + 1];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p0),
                               _mm256_set1_ps(s0), accf);
        accf2 = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p1),
                                _mm256_set1_ps(s1), accf2);
        corr += 8.0f * (s0 * (float)bsums[b] + s1 * (float)bsums[b + 1]);
    }
    for (; b < nb; ++b) {
        const uint8_t* blk = row + b * 18;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const __m128i qs = _mm_loadu_si128((const __m128i*)(blk + 2));
        const __m256i w = _mm256_set_m128i(
            _mm_and_si128(_mm_srli_epi16(qs, 4), m4),
            _mm_and_si128(qs, m4));
        const __m256i x = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i p = _mm256_dpbusd_avx_epi32(zero, w, x);
        const float s = fp16_to_fp32(dh) * xs[b];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p),
                               _mm256_set1_ps(s), accf);
        corr += 8.0f * s * (float)bsums[b];
    }
    accf = _mm256_add_ps(accf, accf2);
    __m128 lo = _mm_add_ps(_mm256_castps256_ps128(accf),
                           _mm256_extractf128_ps(accf, 1));
    lo = _mm_hadd_ps(lo, lo);
    lo = _mm_hadd_ps(lo, lo);
    return _mm_cvtss_f32(lo) - corr;
}
#elif defined(__AVX2__)
static inline float q4_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* bsums,
                               int64_t nb) {
    // nibbles stay UNSIGNED [0,15] so maddubs needs no sign-folding (pair
    // sums <= 2*15*127 = 3810 — no i16 saturation); the +8 bias is
    // corrected with -8*sum(x) per block.
    __m256 accf = _mm256_setzero_ps();
    __m256 accf2 = _mm256_setzero_ps();
    const __m256i ones16 = _mm256_set1_epi16(1);
    const __m128i lo_mask = _mm_set1_epi8(0x0F);
    float corr = 0.0f;
    int64_t b = 0;
    for (; b + 2 <= nb; b += 2) {
        const uint8_t* blk = row + b * 18;
        _mm_prefetch((const char*)(blk + 512), _MM_HINT_T0);
        uint16_t dh0, dh1;
        std::memcpy(&dh0, blk, 2);
        std::memcpy(&dh1, blk + 18, 2);
        const __m128i qs0 = _mm_loadu_si128((const __m128i*)(blk + 2));
        const __m128i qs1 = _mm_loadu_si128((const __m128i*)(blk + 20));
        const __m256i w0 = _mm256_set_m128i(
            _mm_and_si128(_mm_srli_epi16(qs0, 4), lo_mask),
            _mm_and_si128(qs0, lo_mask));
        const __m256i w1 = _mm256_set_m128i(
            _mm_and_si128(_mm_srli_epi16(qs1, 4), lo_mask),
            _mm_and_si128(qs1, lo_mask));
        const __m256i xb0 = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i xb1 = _mm256_loadu_si256((const __m256i*)(xq + b * 32 + 32));
        const __m256i p0 = _mm256_madd_epi16(
            _mm256_maddubs_epi16(w0, xb0), ones16);
        const __m256i p1 = _mm256_madd_epi16(
            _mm256_maddubs_epi16(w1, xb1), ones16);
        const float s0 = fp16_to_fp32(dh0) * xs[b];
        const float s1 = fp16_to_fp32(dh1) * xs[b + 1];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p0),
                               _mm256_set1_ps(s0), accf);
        accf2 = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p1),
                                _mm256_set1_ps(s1), accf2);
        corr += 8.0f * (s0 * (float)bsums[b] + s1 * (float)bsums[b + 1]);
    }
    for (; b < nb; ++b) {
        const uint8_t* blk = row + b * 18;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const __m128i qs = _mm_loadu_si128((const __m128i*)(blk + 2));
        const __m256i w = _mm256_set_m128i(
            _mm_and_si128(_mm_srli_epi16(qs, 4), lo_mask),
            _mm_and_si128(qs, lo_mask));
        const __m256i xb = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i p32 = _mm256_madd_epi16(
            _mm256_maddubs_epi16(w, xb), ones16);
        const float s = fp16_to_fp32(dh) * xs[b];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p32),
                               _mm256_set1_ps(s), accf);
        corr += 8.0f * s * (float)bsums[b];
    }
    accf = _mm256_add_ps(accf, accf2);
    __m128 lo = _mm256_castps256_ps128(accf);
    __m128 hi = _mm256_extractf128_ps(accf, 1);
    lo = _mm_add_ps(lo, hi);
    lo = _mm_hadd_ps(lo, lo);
    lo = _mm_hadd_ps(lo, lo);
    return _mm_cvtss_f32(lo) - corr;
}
#else
static inline float q4_row_dot(const uint8_t* row, const int8_t* xq,
                               const float* xs, const int32_t* /*bsums*/,
                               int64_t nb) {
    float acc = 0.0f;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = row + b * 18;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const uint8_t* qs = blk + 2;
        const int8_t* xb = xq + b * 32;
        int32_t isum = 0;
        for (int i = 0; i < 16; ++i) {
            isum += ((int32_t)(qs[i] & 0x0F) - 8) * (int32_t)xb[i];
            isum += ((int32_t)(qs[i] >> 4) - 8) * (int32_t)xb[i + 16];
        }
        acc += (float)isum * fp16_to_fp32(dh) * xs[b];
    }
    return acc;
}
#endif

// y[N] = W[N, K] (raw Q4_0, row-major) @ x (pre-quantized); threaded rows
void mio_q4_gemv(const uint8_t* w, const int8_t* xq, const float* xs,
                 int64_t n, int64_t k, float* y, int n_threads) {
    const int64_t nb = k / 32;
    const int64_t row_bytes = nb * 18;
    std::vector<int32_t> bsums((size_t)nb);
    act_block_sums(xq, nb, bsums.data());
    const int32_t* bs = bsums.data();
    if (n_threads <= 1 || n * k < (int64_t)1 << 20) {
        for (int64_t r = 0; r < n; ++r)
            y[r] = q4_row_dot(w + r * row_bytes, xq, xs, bs, nb);
        return;
    }
    std::atomic<int64_t> next(0);
    GemvPool::get().run(n_threads - 1, [&]() {
        const int64_t chunk = 64;
        for (;;) {
            const int64_t r0 = next.fetch_add(chunk);
            if (r0 >= n) break;
            const int64_t r1 = std::min(n, r0 + chunk);
            for (int64_t r = r0; r < r1; ++r)
                y[r] = q4_row_dot(w + r * row_bytes, xq, xs, bs, nb);
        }
    });
}

// convenience: quantize activation then gemv (one call per matmul)
void mio_q4_gemv_f32(const uint8_t* w, const float* x, int64_t n, int64_t k,
                     float* y, int8_t* scratch_q, float* scratch_s,
                     int n_threads) {
    mio_q8_quantize_act(x, k, scratch_q, scratch_s);
    mio_q4_gemv(w, scratch_q, scratch_s, n, k, y, n_threads);
}

// ---------------------------------------------------------------------------
// batched gemm: Y[B, N] = X[B, K] @ W[N, K]^T (prompt prefill)
//
// The decode gemv streams every weight byte per token; a prompt processed
// token-by-token therefore pays the full model size per prompt token. Here
// each weight ROW is read once and dotted against all B activation rows
// while it sits in L1 — weight traffic per prompt token drops ~B-fold
// (llama.cpp's batched prompt eval does the same). X is pre-quantized
// per-row to the usual per-32 int8 blocks.
// ---------------------------------------------------------------------------

// unpack one Q4_0 row: nibbles -> contiguous u8[k] (the +8 bias KEPT — the
// unpacked dot corrects with -8*bsum like the packed kernels) + f32 scales
static void q4_unpack_row(const uint8_t* row, int64_t nb, uint8_t* wq,
                          float* ds) {
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = row + b * 18;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        ds[b] = fp16_to_fp32(dh);
        const uint8_t* qs = blk + 2;
        uint8_t* o = wq + b * 32;
        for (int i = 0; i < 16; ++i) {
            o[i] = qs[i] & 0x0F;
            o[i + 16] = qs[i] >> 4;
        }
    }
}

// dot of an UNPACKED u8 row (bias +8) with a quantized activation — the
// per-dot nibble unpack is gone, which matters in the gemm where one row
// is dotted against all B activations
#if defined(__AVXVNNI__)
static inline float q4u_row_dot(const uint8_t* wq, const float* ds,
                                const int8_t* xq, const float* xs,
                                const int32_t* bsums, int64_t nb) {
    __m256 accf = _mm256_setzero_ps();
    __m256 accf2 = _mm256_setzero_ps();
    const __m256i zero = _mm256_setzero_si256();
    float corr = 0.0f;
    int64_t b = 0;
    for (; b + 2 <= nb; b += 2) {
        const __m256i w0 = _mm256_loadu_si256((const __m256i*)(wq + b * 32));
        const __m256i w1 = _mm256_loadu_si256(
            (const __m256i*)(wq + b * 32 + 32));
        const __m256i x0 = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i x1 = _mm256_loadu_si256(
            (const __m256i*)(xq + b * 32 + 32));
        const __m256i p0 = _mm256_dpbusd_avx_epi32(zero, w0, x0);
        const __m256i p1 = _mm256_dpbusd_avx_epi32(zero, w1, x1);
        const float s0 = ds[b] * xs[b];
        const float s1 = ds[b + 1] * xs[b + 1];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p0),
                               _mm256_set1_ps(s0), accf);
        accf2 = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p1),
                                _mm256_set1_ps(s1), accf2);
        corr += 8.0f * (s0 * (float)bsums[b] + s1 * (float)bsums[b + 1]);
    }
    for (; b < nb; ++b) {  // odd nb (e.g. k=96): one vector block
        const __m256i wv = _mm256_loadu_si256((const __m256i*)(wq + b * 32));
        const __m256i xv = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i p = _mm256_dpbusd_avx_epi32(zero, wv, xv);
        const float s = ds[b] * xs[b];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p),
                               _mm256_set1_ps(s), accf);
        corr += 8.0f * s * (float)bsums[b];
    }
    accf = _mm256_add_ps(accf, accf2);
    __m128 lo = _mm_add_ps(_mm256_castps256_ps128(accf),
                           _mm256_extractf128_ps(accf, 1));
    lo = _mm_hadd_ps(lo, lo);
    lo = _mm_hadd_ps(lo, lo);
    return _mm_cvtss_f32(lo) - corr;
}
#define MIO_HAVE_Q4U 1
#elif defined(__AVX2__)
static inline float q4u_row_dot(const uint8_t* wq, const float* ds,
                                const int8_t* xq, const float* xs,
                                const int32_t* bsums, int64_t nb) {
    __m256 accf = _mm256_setzero_ps();
    const __m256i ones16 = _mm256_set1_epi16(1);
    float corr = 0.0f;
    for (int64_t b = 0; b < nb; ++b) {
        const __m256i w = _mm256_loadu_si256((const __m256i*)(wq + b * 32));
        const __m256i x = _mm256_loadu_si256((const __m256i*)(xq + b * 32));
        const __m256i p = _mm256_madd_epi16(_mm256_maddubs_epi16(w, x),
                                            ones16);
        const float s = ds[b] * xs[b];
        accf = _mm256_fmadd_ps(_mm256_cvtepi32_ps(p),
                               _mm256_set1_ps(s), accf);
        corr += 8.0f * s * (float)bsums[b];
    }
    __m128 lo = _mm_add_ps(_mm256_castps256_ps128(accf),
                           _mm256_extractf128_ps(accf, 1));
    lo = _mm_hadd_ps(lo, lo);
    lo = _mm_hadd_ps(lo, lo);
    return _mm_cvtss_f32(lo) - corr;
}
#define MIO_HAVE_Q4U 1
#endif

static void qgemm_rows(bool is_q4, const uint8_t* w, const int8_t* xq,
                       const float* xs, const int32_t* bs, int64_t n,
                       int64_t k, int64_t batch, float* y,
                       int64_t r0, int64_t r1) {
    const int64_t nb = k / 32;
    const int64_t row_bytes = nb * (is_q4 ? 18 : 34);
    const int64_t sb = nb;  // per-row scale/bsum stride
#if defined(MIO_HAVE_Q4U)
    if (is_q4 && batch >= 2) {
        // unpack each weight row ONCE, dot it against all B activations
        std::vector<uint8_t> wbuf((size_t)k);
        std::vector<float> dbuf((size_t)nb);
        for (int64_t r = r0; r < r1; ++r) {
            q4_unpack_row(w + r * row_bytes, nb, wbuf.data(), dbuf.data());
            for (int64_t b = 0; b < batch; ++b)
                y[b * n + r] = q4u_row_dot(wbuf.data(), dbuf.data(),
                                           xq + b * k, xs + b * sb,
                                           bs + b * sb, nb);
        }
        return;
    }
#endif
    for (int64_t r = r0; r < r1; ++r) {
        const uint8_t* row = w + r * row_bytes;
        for (int64_t b = 0; b < batch; ++b) {
            const float v = is_q4
                ? q4_row_dot(row, xq + b * k, xs + b * sb, bs + b * sb, nb)
                : q8_row_dot(row, xq + b * k, xs + b * sb, bs + b * sb, nb);
            y[b * n + r] = v;
        }
    }
}

static void mio_qgemm(bool is_q4, const uint8_t* w, const int8_t* xq,
                      const float* xs, int64_t n, int64_t k, int64_t batch,
                      float* y, int n_threads) {
    const int64_t nb = k / 32;
    std::vector<int32_t> bsums((size_t)(nb * batch));
    for (int64_t b = 0; b < batch; ++b)
        act_block_sums(xq + b * k, nb, bsums.data() + b * nb);
    const int32_t* bs = bsums.data();
    // total work scales with batch — use n*k*batch against the same
    // cutoff as the gemv or the dim-768 attention gemms at B=16 never
    // engage the pool
    if (n_threads <= 1 || n * k * batch < (int64_t)1 << 20) {
        qgemm_rows(is_q4, w, xq, xs, bs, n, k, batch, y, 0, n);
        return;
    }
    std::atomic<int64_t> next(0);
    GemvPool::get().run(n_threads - 1, [&]() {
        const int64_t chunk = 32;
        for (;;) {
            const int64_t r0 = next.fetch_add(chunk);
            if (r0 >= n) break;
            qgemm_rows(is_q4, w, xq, xs, bs, n, k, batch, y,
                       r0, std::min(n, r0 + chunk));
        }
    });
}

// quantize B activation rows then gemm; scratch_q [B*k], scratch_s [B*k/32]
void mio_q8_gemm_f32(const uint8_t* w, const float* x, int64_t n, int64_t k,
                     int64_t batch, float* y, int8_t* scratch_q,
                     float* scratch_s, int n_threads) {
    for (int64_t b = 0; b < batch; ++b)
        mio_q8_quantize_act(x + b * k, k, scratch_q + b * k,
                            scratch_s + b * (k / 32));
    mio_qgemm(false, w, scratch_q, scratch_s, n, k, batch, y, n_threads);
}

void mio_q4_gemm_f32(const uint8_t* w, const float* x, int64_t n, int64_t k,
                     int64_t batch, float* y, int8_t* scratch_q,
                     float* scratch_s, int n_threads) {
    for (int64_t b = 0; b < batch; ++b)
        mio_q8_quantize_act(x + b * k, k, scratch_q + b * k,
                            scratch_s + b * (k / 32));
    mio_qgemm(true, w, scratch_q, scratch_s, n, k, batch, y, n_threads);
}

// dequantize one Q4_0 row (tied-embedding lookup)
void mio_q4_row_dequant(const uint8_t* w, int64_t row, int64_t k, float* out) {
    const int64_t nb = k / 32;
    const uint8_t* r = w + row * nb * 18;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* blk = r + b * 18;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        const float d = fp16_to_fp32(dh);
        const uint8_t* qs = blk + 2;
        float* o = out + b * 32;
        for (int i = 0; i < 16; ++i) {
            o[i] = d * (float)((int)(qs[i] & 0x0F) - 8);
            o[i + 16] = d * (float)((int)(qs[i] >> 4) - 8);
        }
    }
}

// ---------------------------------------------------------------------------
// FLAC stream decoder (RFC 9639) — self-contained reference-audio decode
// (the reference uses miniaudio for wav/mp3/flac uploads,
// wavlm-extractor.cpp:153-203). Cross-checked against the independent
// pure-Python decoder in runtime/flac.py (tests/test_audio_decode.py).
// CRC-8/16 are parsed but not enforced (best-effort upload decode).
// ---------------------------------------------------------------------------

namespace {

struct FlacBits {
    const uint8_t* data;
    int64_t nbits;
    int64_t pos = 0;
    bool err = false;

    inline int peek_bit() const {
        return (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    }
    inline uint64_t read(int n) {
        if (pos + n > nbits) { err = true; return 0; }
        uint64_t v = 0;
        int64_t p = pos;
        pos += n;
        while (n > 0) {
            int off = (int)(p & 7);
            int take = 8 - off;
            if (take > n) take = n;
            uint32_t byte = data[p >> 3];
            v = (v << take) | ((byte >> (8 - off - take)) & ((1u << take) - 1));
            p += take;
            n -= take;
        }
        return v;
    }
    inline int64_t read_signed(int n) {
        uint64_t v = read(n);
        if (n && (v >> (n - 1)))
            return (int64_t)v - ((int64_t)1 << n);
        return (int64_t)v;
    }
    inline uint32_t unary() {
        uint32_t q = 0;
        while (true) {
            if (pos >= nbits) { err = true; return 0; }
            if (peek_bit()) { pos++; return q; }
            pos++;
            q++;
        }
    }
    inline void align() { pos = (pos + 7) & ~(int64_t)7; }
};

struct FlacInfo {
    int sample_rate = 0, channels = 0, bps = 0;
    int64_t total_samples = 0;
    int64_t data_offset = 0;
};

static bool flac_parse_streaminfo(const uint8_t* d, int64_t n, FlacInfo* fi) {
    if (n < 8 || memcmp(d, "fLaC", 4) != 0) return false;
    int64_t pos = 4;
    bool have = false;
    while (pos + 4 <= n) {
        int hdr = d[pos];
        bool last = (hdr & 0x80) != 0;
        int btype = hdr & 0x7F;
        int64_t blen = ((int64_t)d[pos + 1] << 16) | ((int64_t)d[pos + 2] << 8)
                       | d[pos + 3];
        if (btype == 0 && pos + 4 + 18 <= n) {
            const uint8_t* b = d + pos + 4;
            uint64_t raw = 0;
            for (int i = 10; i < 18; ++i) raw = (raw << 8) | b[i];
            fi->sample_rate = (int)(raw >> 44);
            fi->channels = (int)((raw >> 41) & 0x7) + 1;
            fi->bps = (int)((raw >> 36) & 0x1F) + 1;
            fi->total_samples = (int64_t)(raw & (((uint64_t)1 << 36) - 1));
            have = true;
        }
        pos += 4 + blen;
        if (last) break;
    }
    fi->data_offset = pos;
    return have && pos <= n;
}

static bool flac_read_utf8(FlacBits* br, uint64_t* out) {
    uint32_t b0 = (uint32_t)br->read(8);
    if (br->err) return false;
    if (b0 < 0x80) { *out = b0; return true; }
    int n_cont = 0;
    uint32_t mask = 0x40;
    while (b0 & mask) { n_cont++; mask >>= 1; }
    if (n_cont < 1 || n_cont > 6) return false;
    uint64_t v = b0 & (mask - 1);
    for (int i = 0; i < n_cont; ++i) {
        uint32_t c = (uint32_t)br->read(8);
        if (br->err || (c & 0xC0) != 0x80) return false;
        v = (v << 6) | (c & 0x3F);
    }
    *out = v;
    return true;
}

static bool flac_residual(FlacBits* br, int blocksize, int order,
                          int64_t* out /* blocksize-order */) {
    int method = (int)br->read(2);
    if (method > 1) return false;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = (1u << plen) - 1;
    int po = (int)br->read(4);
    int n_part = 1 << po;
    if (blocksize % n_part) return false;
    int part_n = blocksize >> po;
    int64_t w = 0;
    for (int pi = 0; pi < n_part; ++pi) {
        int cnt = part_n - (pi == 0 ? order : 0);
        if (cnt < 0) return false;
        uint32_t param = (uint32_t)br->read(plen);
        if (param == escape) {
            int nb = (int)br->read(5);
            for (int i = 0; i < cnt; ++i) out[w++] = br->read_signed(nb);
        } else {
            for (int i = 0; i < cnt; ++i) {
                uint64_t q = br->unary();
                uint64_t v = (q << param) | br->read((int)param);
                out[w++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
            }
        }
        if (br->err) return false;
    }
    return true;
}

static bool flac_subframe(FlacBits* br, int blocksize, int bps, int64_t* x,
                          std::vector<int64_t>* scratch) {
    if (br->read(1)) return false;
    int ftype = (int)br->read(6);
    int wasted = 0;
    if (br->read(1)) wasted = (int)br->unary() + 1;
    if (br->err) return false;
    int eff = bps - wasted;
    if (eff <= 0) return false;
    if (ftype == 0) {
        int64_t v = br->read_signed(eff);
        for (int i = 0; i < blocksize; ++i) x[i] = v;
    } else if (ftype == 1) {
        for (int i = 0; i < blocksize; ++i) x[i] = br->read_signed(eff);
    } else if (ftype >= 8 && ftype <= 12) {
        int order = ftype - 8;
        // x holds blocksize samples: a frame shorter than its predictor's
        // warm-up is refused before the warm-up is written (JAX's copy writes
        // it first, then refuses the frame in flac_residual)
        if (order > blocksize) return false;
        for (int i = 0; i < order; ++i) x[i] = br->read_signed(eff);
        scratch->resize((size_t)blocksize);
        int64_t* res = scratch->data();
        if (!flac_residual(br, blocksize, order, res)) return false;
        static const int fc[5][4] = {{0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0},
                                     {3, -3, 1, 0}, {4, -6, 4, -1}};
        for (int i = order; i < blocksize; ++i) {
            int64_t acc = res[i - order];
            for (int j = 0; j < order; ++j) acc += fc[order][j] * x[i - 1 - j];
            x[i] = acc;
        }
    } else if (ftype >= 32) {
        int order = (ftype & 31) + 1;
        if (order > blocksize) return false;  // as for FIXED above
        for (int i = 0; i < order; ++i) x[i] = br->read_signed(eff);
        int prec = (int)br->read(4) + 1;
        if (prec == 16) return false;
        int shift = (int)br->read_signed(5);
        if (shift < 0) return false;
        int64_t coefs[32];
        for (int i = 0; i < order; ++i) coefs[i] = br->read_signed(prec);
        scratch->resize((size_t)blocksize);
        int64_t* res = scratch->data();
        if (!flac_residual(br, blocksize, order, res)) return false;
        for (int i = order; i < blocksize; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j) acc += coefs[j] * x[i - 1 - j];
            x[i] = res[i - order] + (acc >> shift);
        }
    } else {
        return false;
    }
    if (br->err) return false;
    if (wasted)
        for (int i = 0; i < blocksize; ++i) x[i] <<= wasted;
    return true;
}

}  // namespace

// info_out: [0]=sample_rate [1]=channels [2]=bps [3]=total_samples(lo32)
// [4]=total_samples(hi32). Returns 0, or -1 on a non-FLAC/corrupt stream.
int mio_flac_probe(const uint8_t* data, int64_t n, int64_t* info_out) {
    FlacInfo fi;
    if (!flac_parse_streaminfo(data, n, &fi)) return -1;
    info_out[0] = fi.sample_rate;
    info_out[1] = fi.channels;
    info_out[2] = fi.bps;
    info_out[3] = fi.total_samples;
    return 0;
}

// Decode to interleaved int32. cap = max frames (per-channel samples) out
// can hold. info_out as mio_flac_probe with [3] = frames actually written.
// Returns 0 ok, -1 parse error before any frame, -2 capacity exhausted
// (out holds the first cap frames; caller retries with a larger buffer).
int mio_flac_decode(const uint8_t* data, int64_t n, int32_t* out,
                    int64_t cap, int64_t* info_out) {
    FlacInfo fi;
    if (!flac_parse_streaminfo(data, n, &fi)) return -1;
    FlacBits br{data, n * 8};
    br.pos = fi.data_offset * 8;
    static const int kBlock[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                   256, 512, 1024, 2048, 4096, 8192, 16384,
                                   32768};
    static const int kRate[16] = {0, 88200, 176400, 192000, 8000, 16000,
                                  22050, 24000, 32000, 44100, 48000, 96000,
                                  -1, -2, -3, -4};
    static const int kBits[8] = {0, 8, 12, -1, 16, 20, 24, 32};
    std::vector<std::vector<int64_t>> ch(fi.channels);
    std::vector<int64_t> scratch;
    int64_t written = 0;
    int rate = fi.sample_rate;
    while (br.pos + 32 <= br.nbits
           && (!fi.total_samples || written < fi.total_samples)) {
        if (br.read(14) != 0x3FFE) break;
        if (br.read(1)) break;
        br.read(1);
        int bs_code = (int)br.read(4);
        int sr_code = (int)br.read(4);
        int ch_code = (int)br.read(4);
        int ss_code = (int)br.read(3);
        if (br.read(1)) break;
        uint64_t coded;
        if (!flac_read_utf8(&br, &coded)) break;
        int blocksize;
        if (bs_code == 0) break;
        else if (bs_code == 6) blocksize = (int)br.read(8) + 1;
        else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
        else blocksize = kBlock[bs_code];
        if (sr_code == 12) rate = (int)br.read(8) * 1000;
        else if (sr_code == 13) rate = (int)br.read(16);
        else if (sr_code == 14) rate = (int)br.read(16) * 10;
        else if (sr_code == 15) break;
        else if (sr_code != 0) rate = kRate[sr_code];
        int bps = ss_code == 0 ? fi.bps : kBits[ss_code];
        if (bps <= 0) break;
        br.read(8);  // header CRC-8
        if (br.err || blocksize <= 0) break;

        int n_ch = ch_code <= 7 ? ch_code + 1 : 2;
        if (n_ch != fi.channels) break;
        for (int c = 0; c < n_ch; ++c)
            ch[c].resize((size_t)blocksize);
        bool ok = true;
        if (ch_code <= 7) {
            for (int c = 0; c < n_ch && ok; ++c)
                ok = flac_subframe(&br, blocksize, bps, ch[c].data(),
                                   &scratch);
        } else if (ch_code <= 10) {
            int side_idx = (ch_code == 9) ? 0 : 1;
            for (int c = 0; c < 2 && ok; ++c)
                ok = flac_subframe(&br, blocksize,
                                   bps + (c == side_idx ? 1 : 0),
                                   ch[c].data(), &scratch);
            if (ok) {
                int64_t* a = ch[0].data();
                int64_t* b = ch[1].data();
                if (ch_code == 8) {  // left/side
                    for (int i = 0; i < blocksize; ++i) b[i] = a[i] - b[i];
                } else if (ch_code == 9) {  // right/side
                    for (int i = 0; i < blocksize; ++i) a[i] = a[i] + b[i];
                } else {  // mid/side
                    for (int i = 0; i < blocksize; ++i) {
                        int64_t mid2 = (a[i] << 1) | (b[i] & 1);
                        int64_t s = b[i];
                        a[i] = (mid2 + s) >> 1;
                        b[i] = (mid2 - s) >> 1;
                    }
                }
            }
        } else {
            break;
        }
        if (!ok || br.err) break;
        br.align();
        br.read(16);  // frame CRC-16
        int take = blocksize;
        if (fi.total_samples && written + take > fi.total_samples)
            take = (int)(fi.total_samples - written);
        if (written + take > cap) {
            take = (int)(cap - written);
            for (int i = 0; i < take; ++i)
                for (int c = 0; c < fi.channels; ++c)
                    out[(written + i) * fi.channels + c] = (int32_t)ch[c][i];
            written += take;
            info_out[0] = rate;
            info_out[1] = fi.channels;
            info_out[2] = fi.bps;
            info_out[3] = written;
            return -2;
        }
        for (int i = 0; i < take; ++i)
            for (int c = 0; c < fi.channels; ++c)
                out[(written + i) * fi.channels + c] = (int32_t)ch[c][i];
        written += take;
    }
    info_out[0] = rate;
    info_out[1] = fi.channels;
    info_out[2] = fi.bps;
    info_out[3] = written;
    return written > 0 || fi.total_samples == 0 ? 0 : -1;
}

// ---------------------------------------------------------------------------
// mp3: self-contained MPEG-1/2/2.5 Layer III decoder (port of the
// oracle-verified numpy implementation in runtime/mp3.py; constants from
// the generated mp3_tables.h — one source of truth for both decoders).
// Cross-checked near-identically against runtime/mp3.py and libmpg123 in
// tests/test_mp3.py. Output: mono float32 in [-1, 1].
// ---------------------------------------------------------------------------

}  // extern "C"

namespace mp3impl {

struct Bits {
    const uint8_t* data;
    int64_t nbits;
    int64_t pos = 0;
    inline uint32_t get(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) {
            int bit = 0;
            if (pos < nbits)
                bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
            v = (v << 1) | bit;
            pos++;
        }
        return v;
    }
    inline uint32_t peek(int n) {
        int64_t p = pos;
        uint32_t v = get(n);
        pos = p;
        return v;
    }
};

struct Gr {
    int part23 = 0, big_values = 0, global_gain = 0, sfc = 0;
    bool ws = false, mixed = false;
    int block_type = 0;
    int tsel[3] = {0, 0, 0};
    int sbg[3] = {0, 0, 0};
    int region0 = 0, region1 = 0;
    int preflag = 0, sf_scale = 0, count1table = 0;
    int sfl[23] = {0};
    int sfs[13][3] = {{0}};
};

struct Frame {
    int version = 0, rate = 0, nch = 1, mode = 3, mode_ext = 0, mdb = 0;
    int ngr = 1;
    int scfsi[2][4] = {{0}};
    Gr gr[2][2];
    const uint8_t* main = nullptr;
    int main_len = 0;
};

// Huffman LUTs: index next maxlen bits -> (x<<9 | y<<5 | hlen), 0 invalid
struct Lut {
    std::vector<uint16_t> t;
    int maxlen = 0;
};
static Lut g_big[16];
static Lut g_c1[2];
static double g_nmat[64][32];
static double g_im36[36][18];
static double g_im12[12][6];
static double g_win[4][36];
static double g_win12[12];
static double g_dwin[512];
static std::once_flag g_init_once;

static void init_tables() {
    int nbooks = (int)(sizeof(kHuffXlen) / sizeof(kHuffXlen[0]));
    for (int b = 0; b < nbooks; ++b) {
        int n = kHuffOff[b + 1] - kHuffOff[b];
        int ylen = kHuffYlen[b];
        int maxlen = 0;
        for (int i = 0; i < n; ++i)
            maxlen = std::max(maxlen, (int)kHuffLens[kHuffOff[b] + i]);
        Lut& L = g_big[b];
        L.maxlen = maxlen;
        L.t.assign((size_t)1 << maxlen, 0);
        for (int i = 0; i < n; ++i) {
            int l = kHuffLens[kHuffOff[b] + i];
            uint32_t c = kHuffCodes[kHuffOff[b] + i];
            int x = i / ylen, y = i % ylen;
            uint32_t base = c << (maxlen - l);
            for (uint32_t j = 0; j < (1u << (maxlen - l)); ++j)
                L.t[base + j] = (uint16_t)((x << 9) | (y << 5) | l);
        }
    }
    for (int tb = 0; tb < 2; ++tb) {
        Lut& L = g_c1[tb];
        int maxlen = 0;
        for (int i = 0; i < 16; ++i) {
            int l = tb ? 4 : kCount1ALen[i];
            maxlen = std::max(maxlen, l);
        }
        L.maxlen = maxlen;
        L.t.assign((size_t)1 << maxlen, 0);
        for (int i = 0; i < 16; ++i) {
            int l = tb ? 4 : kCount1ALen[i];
            uint32_t c = tb ? (uint32_t)(15 - i) : kCount1ACod[i];
            uint32_t base = c << (maxlen - l);
            for (uint32_t j = 0; j < (1u << (maxlen - l)); ++j)
                L.t[base + j] = (uint16_t)((i << 5) | l);
        }
    }
    const double PI = 3.14159265358979323846;
    for (int i = 0; i < 64; ++i)
        for (int k = 0; k < 32; ++k)
            g_nmat[i][k] = std::cos((16 + i) * (2 * k + 1) * PI / 64.0);
    for (int i = 0; i < 36; ++i)
        for (int k = 0; k < 18; ++k)
            g_im36[i][k] = std::cos(PI / 72.0 * (2 * i + 1 + 18) * (2 * k + 1));
    for (int i = 0; i < 12; ++i)
        for (int k = 0; k < 6; ++k)
            g_im12[i][k] = std::cos(PI / 24.0 * (2 * i + 7) * (2 * k + 1));
    for (int t = 0; t < 4; ++t)
        for (int i = 0; i < 36; ++i) g_win[t][i] = 0.0;
    for (int i = 0; i < 36; ++i)
        g_win[0][i] = std::sin(PI / 36.0 * (i + 0.5));
    for (int i = 0; i < 18; ++i)
        g_win[1][i] = std::sin(PI / 36.0 * (i + 0.5));
    for (int i = 18; i < 24; ++i) g_win[1][i] = 1.0;
    for (int i = 24; i < 30; ++i)
        g_win[1][i] = std::sin(PI / 12.0 * (i - 18 + 0.5));
    for (int i = 6; i < 12; ++i)
        g_win[3][i] = std::sin(PI / 12.0 * (i - 6 + 0.5));
    for (int i = 12; i < 18; ++i) g_win[3][i] = 1.0;
    for (int i = 18; i < 36; ++i)
        g_win[3][i] = std::sin(PI / 36.0 * (i + 0.5));
    for (int i = 0; i < 12; ++i)
        g_win12[i] = std::sin(PI / 12.0 * (i + 0.5));
    for (int i = 0; i < 512; ++i) {
        int base = i <= 256 ? kSynthWinBase[i] : kSynthWinBase[512 - i];
        double sgn = ((i / 64) % 2 == 1) ? -1.0 : 1.0;
        g_dwin[i] = sgn * base / 65536.0;
    }
}

static const int kRatesV[4][3] = {{11025, 12000, 8000}, {0, 0, 0},
                                  {22050, 24000, 16000},
                                  {44100, 48000, 32000}};
static const int kBrV1[15] = {0, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                              160, 192, 224, 256, 320};
static const int kBrV2[15] = {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96,
                              112, 128, 144, 160};

static int sfb_rate_idx(int rate) {
    for (int i = 0; i < 9; ++i)
        if (kSfbRates[i] == rate) return i;
    return -1;
}

// returns frame length in bytes, fills fr; -1 if not a valid frame here,
// -2 if a frame header here gives a frame that runs past the stream's end
// (runtime/mp3.py stops there: its callers end the scan)
static int parse_frame(const uint8_t* d, int64_t n, int64_t pos, Frame* fr) {
    if (pos + 4 > n) return -1;
    if (!(d[pos] == 0xFF && (d[pos + 1] & 0xE0) == 0xE0)) return -1;
    int h1 = d[pos + 1], h2 = d[pos + 2], h3 = d[pos + 3];
    int version = (h1 >> 3) & 3;
    int layer = (h1 >> 1) & 3;
    bool crc = !(h1 & 1);
    int br_idx = (h2 >> 4) & 15;
    int sr_idx = (h2 >> 2) & 3;
    int padding = (h2 >> 1) & 1;
    int mode = (h3 >> 6) & 3;
    if (version == 1 || layer != 1 || br_idx == 0 || br_idx == 15 ||
        sr_idx == 3)
        return -1;
    int rate = kRatesV[version][sr_idx];
    bool v1 = version == 3;
    int bitrate = (v1 ? kBrV1[br_idx] : kBrV2[br_idx]) * 1000;
    int flen = (v1 ? 144 : 72) * bitrate / rate + padding;
    if (pos + flen > n) return -2;
    if (flen < 24) return -1;
    int nch = mode == 3 ? 1 : 2;
    int64_t off = pos + 4 + (crc ? 2 : 0);
    int si_len = v1 ? (nch == 1 ? 17 : 32) : (nch == 1 ? 9 : 17);
    if (off + si_len > pos + flen) return -1;
    Bits br{d + off, (int64_t)si_len * 8};
    fr->version = version;
    fr->rate = rate;
    fr->nch = nch;
    fr->mode = mode;
    fr->mode_ext = (h3 >> 4) & 3;
    fr->ngr = v1 ? 2 : 1;
    fr->mdb = br.get(v1 ? 9 : 8);
    br.get(v1 ? (nch == 1 ? 5 : 3) : (nch == 1 ? 1 : 2));
    if (v1)
        for (int c = 0; c < nch; ++c)
            for (int b = 0; b < 4; ++b) fr->scfsi[c][b] = br.get(1);
    for (int g = 0; g < fr->ngr; ++g)
        for (int c = 0; c < nch; ++c) {
            Gr& gr = fr->gr[g][c];
            gr = Gr();
            gr.part23 = br.get(12);
            gr.big_values = br.get(9);
            gr.global_gain = br.get(8);
            gr.sfc = br.get(v1 ? 4 : 9);
            gr.ws = br.get(1) != 0;
            if (gr.ws) {
                gr.block_type = br.get(2);
                gr.mixed = br.get(1) != 0;
                gr.tsel[0] = br.get(5);
                gr.tsel[1] = br.get(5);
                gr.tsel[2] = 0;
                for (int w = 0; w < 3; ++w) gr.sbg[w] = br.get(3);
                gr.region0 = (gr.block_type == 2 && !gr.mixed) ? 8 : 7;
                gr.region1 = 36;
            } else {
                for (int t = 0; t < 3; ++t) gr.tsel[t] = br.get(5);
                gr.region0 = br.get(4);
                gr.region1 = br.get(3);
                gr.block_type = 0;
            }
            if (v1) gr.preflag = br.get(1);
            gr.sf_scale = br.get(1);
            gr.count1table = br.get(1);
        }
    fr->main = d + off + si_len;
    fr->main_len = (int)(pos + flen - (off + si_len));
    return flen;
}

// A stream's VBR/LAME header frame: main data starting with a Xing or Info
// tag, or VBRI 32 bytes after the 4-byte header (runtime/mp3.py
// _parse_frames). It is metadata: the port skips it when it is a stream's
// first frame, where JAX's copy decodes it as a frame of silence.
static bool vbr_tag_frame(const uint8_t* d, int64_t n, int64_t pos,
                          const Frame& fr) {
    if (fr.main_len >= 4 && (std::memcmp(fr.main, "Xing", 4) == 0 ||
                             std::memcmp(fr.main, "Info", 4) == 0))
        return true;
    return pos + 40 <= n && std::memcmp(d + pos + 36, "VBRI", 4) == 0;
}

static void read_scf_v1(Bits& br, Gr& g, int grn, const int* scfsi,
                        const Gr* prev) {
    int s1 = kSlen1[g.sfc], s2 = kSlen2[g.sfc];
    bool short_b = g.ws && g.block_type == 2;
    if (short_b && !g.mixed) {
        for (int sfb = 0; sfb < 6; ++sfb)
            for (int w = 0; w < 3; ++w) g.sfs[sfb][w] = br.get(s1);
        for (int sfb = 6; sfb < 12; ++sfb)
            for (int w = 0; w < 3; ++w) g.sfs[sfb][w] = br.get(s2);
    } else if (short_b) {
        for (int sfb = 0; sfb < 8; ++sfb) g.sfl[sfb] = br.get(s1);
        for (int sfb = 3; sfb < 6; ++sfb)
            for (int w = 0; w < 3; ++w) g.sfs[sfb][w] = br.get(s1);
        for (int sfb = 6; sfb < 12; ++sfb)
            for (int w = 0; w < 3; ++w) g.sfs[sfb][w] = br.get(s2);
    } else {
        static const int grp[4][3] = {{0, 6, 0}, {6, 11, 0},
                                      {11, 16, 1}, {16, 21, 1}};
        for (int gi = 0; gi < 4; ++gi) {
            int a = grp[gi][0], b = grp[gi][1];
            int sl = grp[gi][2] ? s2 : s1;
            if (grn == 1 && scfsi[gi] && prev != nullptr) {
                for (int sfb = a; sfb < b; ++sfb) g.sfl[sfb] = prev->sfl[sfb];
            } else {
                for (int sfb = a; sfb < b; ++sfb) g.sfl[sfb] = br.get(sl);
            }
        }
    }
}

static void read_scf_lsf(Bits& br, Gr& g, bool ist) {
    int sfc = g.sfc;
    int slen[4] = {0, 0, 0, 0};
    int bn;
    g.preflag = 0;
    if (!ist) {
        if (sfc < 400) {
            slen[0] = (sfc >> 4) / 5;
            slen[1] = (sfc >> 4) % 5;
            slen[2] = (sfc % 16) >> 2;
            slen[3] = sfc % 4;
            bn = 0;
        } else if (sfc < 500) {
            int s = sfc - 400;
            slen[0] = (s >> 2) / 5;
            slen[1] = (s >> 2) % 5;
            slen[2] = s % 4;
            bn = 1;
        } else {
            int s = sfc - 500;
            slen[0] = s / 3;
            slen[1] = s % 3;
            bn = 2;
            g.preflag = 1;
        }
    } else {
        int s = sfc >> 1;
        if (s < 180) {
            slen[0] = s / 36;
            slen[1] = (s % 36) / 6;
            slen[2] = s % 6;
            bn = 3;
        } else if (s < 244) {
            s -= 180;
            slen[0] = (s % 64) >> 4;
            slen[1] = (s % 16) >> 2;
            slen[2] = s % 4;
            bn = 4;
        } else {
            s -= 244;
            slen[0] = s / 3;
            slen[1] = s % 3;
            bn = 5;
        }
    }
    bool short_b = g.ws && g.block_type == 2;
    int cls = !short_b ? 0 : (g.mixed ? 2 : 1);
    const uint8_t* counts = &kNrOfSfb[(bn * 3 + cls) * 4];
    int vals[54], nv = 0;
    for (int part = 0; part < 4; ++part)
        for (int i = 0; i < counts[part]; ++i)
            vals[nv++] = slen[part] ? (int)br.get(slen[part]) : 0;
    if (short_b && !g.mixed) {
        for (int i = 0; i < nv && i < 39; ++i) g.sfs[i / 3][i % 3] = vals[i];
    } else if (short_b) {
        for (int i = 0; i < 6; ++i) g.sfl[i] = vals[i];
        for (int i = 6; i < nv && i < 6 + 27; ++i)
            g.sfs[3 + (i - 6) / 3][(i - 6) % 3] = vals[i];
    } else {
        for (int i = 0; i < nv && i < 22; ++i) g.sfl[i] = vals[i];
    }
}

static inline double pow43(int v) {
    static double tab[64] = {0};
    static std::once_flag once;
    std::call_once(once, [] {
        for (int i = 0; i < 64; ++i) tab[i] = std::pow((double)i, 4.0 / 3.0);
    });
    if (v < 64) return tab[v];
    return std::pow((double)v, 4.0 / 3.0);
}

static void huffman(Bits& br, const Gr& g, int ridx, int64_t bits_end,
                    double* x) {
    std::memset(x, 0, 576 * sizeof(double));
    const int16_t* lb = &kSfbLong[ridx * 23];
    const int16_t* sb = &kSfbShort[ridx * 14];
    int region1, region2;
    if (g.ws) {
        region1 = (g.block_type == 2 && !g.mixed) ? 3 * sb[3] : lb[8];
        region2 = 576;
    } else {
        region1 = lb[std::min(g.region0 + 1, 22)];
        region2 = lb[std::min(g.region0 + g.region1 + 2, 22)];
    }
    int nbig = std::min(2 * g.big_values, 576);
    int line = 0;
    while (line < nbig) {
        int tab = line < region1 ? g.tsel[0]
                                 : (line < region2 ? g.tsel[1] : g.tsel[2]);
        int book = kBookOf[tab];
        if (book < 0) {
            line += 2;
            continue;
        }
        const Lut& L = g_big[book];
        uint16_t packed = L.t[br.peek(L.maxlen)];
        int hlen = packed & 31;
        if (hlen == 0) break;
        br.pos += hlen;
        int vx = (packed >> 9) & 15, vy = (packed >> 5) & 15;
        int linbits = kLinbits[tab];
        if (vx == 15 && linbits) vx += br.get(linbits);
        double fx = pow43(vx);
        if (vx && br.get(1)) fx = -fx;
        if (vy == 15 && linbits) vy += br.get(linbits);
        double fy = pow43(vy);
        if (vy && br.get(1)) fy = -fy;
        x[line] = fx;
        x[line + 1] = fy;
        line += 2;
        if (br.pos > bits_end) break;
    }
    const Lut& L = g_c1[g.count1table ? 1 : 0];
    while (line + 4 <= 576 && br.pos < bits_end) {
        uint16_t packed = L.t[br.peek(L.maxlen)];
        int hlen = packed & 31;
        if (hlen == 0) break;
        br.pos += hlen;
        int quad = (packed >> 5) & 15;
        for (int i = 0; i < 4; ++i) {
            int v = (quad >> (3 - i)) & 1;
            if (v) x[line + i] = br.get(1) ? -1.0 : 1.0;
        }
        line += 4;
    }
    if (br.pos > bits_end)
        for (int i = std::max(0, line - 4); i < line; ++i) x[i] = 0.0;
}

static void requantize(double* x, const Gr& g, int ridx) {
    const int16_t* lb = &kSfbLong[ridx * 23];
    const int16_t* sb = &kSfbShort[ridx * 14];
    double mult = g.sf_scale ? 1.0 : 0.5;
    double gain = 0.25 * (g.global_gain - 210);
    bool short_b = g.ws && g.block_type == 2;
    double e[576];
    for (int i = 0; i < 576; ++i) e[i] = 0.0;
    if (!short_b || g.mixed) {
        int nlong = short_b ? 36 : 576;
        for (int sfb = 0; sfb < 22; ++sfb) {
            int a = lb[sfb], b = std::min((int)lb[sfb + 1], nlong);
            if (a >= nlong) break;
            double sf = g.sfl[sfb] + (g.preflag ? kPretab[sfb] : 0);
            double ex = gain - mult * sf;
            for (int i = a; i < b; ++i) e[i] = ex;
        }
    }
    if (short_b) {
        int first = g.mixed ? 3 : 0;
        for (int sfb = first; sfb < 13; ++sfb) {
            int a = sb[sfb], w = sb[sfb + 1] - sb[sfb];
            for (int win = 0; win < 3; ++win) {
                double ex = gain - 2.0 * g.sbg[win]
                            - mult * (sfb < 13 ? g.sfs[sfb][win] : 0);
                int s = 3 * a + win * w;
                for (int i = 0; i < w; ++i) e[s + i] = ex;
            }
        }
    }
    for (int i = 0; i < 576; ++i)
        if (x[i] != 0.0) x[i] *= std::exp2(e[i]);
}

static int intensity_bound(const double* right, const Gr& g, int ridx) {
    const int16_t* lb = &kSfbLong[ridx * 23];
    const int16_t* sb = &kSfbShort[ridx * 14];
    bool short_b = g.ws && g.block_type == 2;
    const int16_t* bands = short_b ? sb : lb;
    int nb = short_b ? 13 : 22;
    int scale = short_b ? 3 : 1;
    int bound = bands[nb] * scale;
    for (int sfb = nb - 1; sfb >= 0; --sfb) {
        int a = bands[sfb] * scale, b = bands[sfb + 1] * scale;
        bool nz = false;
        for (int i = a; i < b; ++i)
            if (right[i] != 0.0) { nz = true; break; }
        if (nz) break;
        bound = a;
    }
    return bound;
}

static void stereo_process(double* L, double* R, const Frame& fr,
                           const Gr& gR, int ridx) {
    bool ms = fr.mode == 1 && (fr.mode_ext & 2);
    bool ist = fr.mode == 1 && (fr.mode_ext & 1);
    int bound = ist ? intensity_bound(R, gR, ridx) : 576;
    if (ist) {
        const int16_t* lb = &kSfbLong[ridx * 23];
        const int16_t* sb = &kSfbShort[ridx * 14];
        bool short_b = gR.ws && gR.block_type == 2;
        const int16_t* bands = short_b ? sb : lb;
        int nb = short_b ? 13 : 22;
        int scale = short_b ? 3 : 1;
        bool v1 = fr.version == 3;
        double lsf_io = std::exp2(-0.25 * ((gR.sfc & 1) + 1));
        for (int sfb = 0; sfb < nb; ++sfb) {
            int a = bands[sfb] * scale;
            if (a < bound) continue;
            int nwin = short_b ? 3 : 1;
            int w = bands[sfb + 1] - bands[sfb];
            for (int win = 0; win < nwin; ++win) {
                int s0, len;
                int is_pos;
                if (short_b) {
                    s0 = bands[sfb] * 3 + win * w;
                    len = w;
                    is_pos = gR.sfs[sfb][win];
                } else {
                    s0 = bands[sfb] * scale;
                    len = bands[sfb + 1] - bands[sfb];
                    is_pos = gR.sfl[sfb];
                }
                double k0, k1;
                if (v1) {
                    if (is_pos == 7) {
                        if (ms) {
                            const double inv = 0.7071067811865476;
                            for (int i = s0; i < s0 + len; ++i) {
                                double m = L[i], s = R[i];
                                L[i] = (m + s) * inv;
                                R[i] = (m - s) * inv;
                            }
                        }
                        continue;
                    }
                    double ratio = std::tan(is_pos * 3.14159265358979323846
                                            / 12.0);
                    k0 = ratio / (1.0 + ratio);
                    k1 = 1.0 / (1.0 + ratio);
                } else {
                    if (is_pos == 0) {
                        k0 = k1 = 1.0;
                    } else if (is_pos & 1) {
                        k0 = std::pow(lsf_io, (is_pos + 1) >> 1);
                        k1 = 1.0;
                    } else {
                        k0 = 1.0;
                        k1 = std::pow(lsf_io, is_pos >> 1);
                    }
                }
                for (int i = s0; i < s0 + len; ++i) {
                    double v = L[i];
                    L[i] = v * k0;
                    R[i] = v * k1;
                }
            }
        }
    }
    if (ms) {
        const double inv = 0.7071067811865476;
        int upto = ist ? bound : 576;
        for (int i = 0; i < upto; ++i) {
            double m = L[i], s = R[i];
            L[i] = (m + s) * inv;
            R[i] = (m - s) * inv;
        }
    }
}

static void reorder_short(double* x, const Gr& g, int ridx) {
    if (!(g.ws && g.block_type == 2)) return;
    const int16_t* sb = &kSfbShort[ridx * 14];
    double tmp[576];
    std::memcpy(tmp, x, sizeof(tmp));
    int first = g.mixed ? 3 : 0;
    for (int sfb = first; sfb < 13; ++sfb) {
        int a = sb[sfb], w = sb[sfb + 1] - sb[sfb];
        int base = 3 * a;
        for (int win = 0; win < 3; ++win)
            for (int i = 0; i < w; ++i)
                x[base + i * 3 + win] = tmp[base + win * w + i];
    }
}

static const double kCi[8] = {-0.6, -0.535, -0.33, -0.185,
                              -0.095, -0.041, -0.0142, -0.0037};

static void alias_reduce(double* x, const Gr& g) {
    if (g.ws && g.block_type == 2 && !g.mixed) return;
    int nb = (g.ws && g.block_type == 2) ? 2 : 32;
    for (int sbnd = 1; sbnd < nb; ++sbnd) {
        int b = 18 * sbnd;
        for (int i = 0; i < 8; ++i) {
            double cs = 1.0 / std::sqrt(1.0 + kCi[i] * kCi[i]);
            double ca = kCi[i] * cs;
            double lo = x[b - 1 - i], hi = x[b + i];
            x[b - 1 - i] = lo * cs - hi * ca;
            x[b + i] = hi * cs + lo * ca;
        }
    }
}

struct ChState {
    double overlap[32][18] = {{0}};
    double v[1024] = {0};
};

static void imdct_granule(const double* x, const Gr& g, ChState& st,
                          double out[32][18]) {
    bool short_b = g.ws && g.block_type == 2;
    for (int sbnd = 0; sbnd < 32; ++sbnd) {
        const double* X = x + sbnd * 18;
        double z[36];
        bool long_here = !short_b || (g.mixed && sbnd < 2);
        if (long_here) {
            int bt = (g.mixed && sbnd < 2) ? 0 : g.block_type;
            for (int i = 0; i < 36; ++i) {
                double s = 0.0;
                for (int k = 0; k < 18; ++k) s += g_im36[i][k] * X[k];
                z[i] = s * g_win[bt][i];
            }
        } else {
            for (int i = 0; i < 36; ++i) z[i] = 0.0;
            for (int w = 0; w < 3; ++w)
                for (int i = 0; i < 12; ++i) {
                    double s = 0.0;
                    for (int k = 0; k < 6; ++k)
                        s += g_im12[i][k] * X[k * 3 + w];
                    z[6 + 6 * w + i] += s * g_win12[i];
                }
        }
        for (int i = 0; i < 18; ++i) {
            out[sbnd][i] = z[i] + st.overlap[sbnd][i];
            st.overlap[sbnd][i] = z[i + 18];
        }
    }
    // frequency inversion: odd subbands, odd samples
    for (int sbnd = 1; sbnd < 32; sbnd += 2)
        for (int i = 1; i < 18; i += 2) out[sbnd][i] = -out[sbnd][i];
}

static void synth_granule(ChState& st, const double sb[32][18],
                          double* pcm576) {
    double* v = st.v;
    for (int t = 0; t < 18; ++t) {
        std::memmove(v + 64, v, (1024 - 64) * sizeof(double));
        for (int i = 0; i < 64; ++i) {
            double s = 0.0;
            for (int k = 0; k < 32; ++k) s += g_nmat[i][k] * sb[k][t];
            v[i] = s;
        }
        double u[512];
        for (int i = 0; i < 8; ++i) {
            std::memcpy(u + 64 * i, v + 128 * i, 32 * sizeof(double));
            std::memcpy(u + 64 * i + 32, v + 128 * i + 96,
                        32 * sizeof(double));
        }
        for (int j = 0; j < 32; ++j) {
            double s = 0.0;
            for (int i = 0; i < 16; ++i)
                s += u[j + 32 * i] * g_dwin[j + 32 * i];
            pcm576[t * 32 + j] = s;
        }
    }
}

}  // namespace mp3impl

extern "C" {

// probe: info_out[0]=sample_rate, [1]=source channels, [2]=decoded mono
// sample estimate (frame count * samples-per-frame). Returns 0, or -1 if
// no Layer III frame is found.
int mio_mp3_probe(const uint8_t* data, int64_t n, int64_t* info_out) {
    using namespace mp3impl;
    int64_t pos = 0;
    if (n >= 10 && data[0] == 'I' && data[1] == 'D' && data[2] == '3') {
        int64_t sz = ((int64_t)(data[6] & 0x7F) << 21) |
                     ((int64_t)(data[7] & 0x7F) << 14) |
                     ((int64_t)(data[8] & 0x7F) << 7) | (data[9] & 0x7F);
        pos = 10 + sz;
    }
    Frame fr;
    int64_t total = 0, frames = 0;
    int rate = 0, nch = 0;
    while (pos + 4 <= n) {
        int flen = parse_frame(data, n, pos, &fr);
        if (flen == -2) break;  // a truncated last frame
        if (flen < 0) {  // no frame here: scan on, as runtime/mp3.py does
            pos++;
            continue;
        }
        if (frames++ == 0 && vbr_tag_frame(data, n, pos, fr)) {
            pos += flen;  // the tag frame holds no samples
            continue;
        }
        if (rate == 0) {
            rate = fr.rate;
            nch = fr.nch;
        } else if (fr.rate != rate) {
            break;
        }
        total += fr.ngr * 576;
        pos += flen;
    }
    if (rate == 0) return -1;
    info_out[0] = rate;
    info_out[1] = nch;
    info_out[2] = total;
    return 0;
}

// Decode to mono float32 in [-1, 1]. cap = max samples `out` holds.
// info_out[0]=rate, [1]=samples written. Returns 0 ok, -1 no frames,
// -2 capacity exhausted (out holds the first cap samples).
int mio_mp3_decode(const uint8_t* data, int64_t n, float* out, int64_t cap,
                   int64_t* info_out) {
    using namespace mp3impl;
    std::call_once(g_init_once, init_tables);
    int64_t pos = 0;
    if (n >= 10 && data[0] == 'I' && data[1] == 'D' && data[2] == '3') {
        int64_t sz = ((int64_t)(data[6] & 0x7F) << 21) |
                     ((int64_t)(data[7] & 0x7F) << 14) |
                     ((int64_t)(data[8] & 0x7F) << 7) | (data[9] & 0x7F);
        pos = 10 + sz;
    }
    std::vector<uint8_t> reservoir;
    reservoir.reserve(4096);
    ChState st[2];
    int rate = 0;
    int64_t written = 0, frames = 0;
    Frame fr;
    while (pos + 4 <= n) {
        int flen = parse_frame(data, n, pos, &fr);
        if (flen == -2) break;  // a truncated last frame
        if (flen < 0) {  // no frame here: scan on, as runtime/mp3.py does
            pos++;
            continue;
        }
        if (frames++ == 0 && vbr_tag_frame(data, n, pos, fr)) {
            pos += flen;  // metadata: no samples, no reservoir bytes
            continue;
        }
        pos += flen;
        if (rate == 0)
            rate = fr.rate;
        else if (fr.rate != rate)
            break;
        bool v1 = fr.version == 3;
        int64_t start_byte = (int64_t)reservoir.size() - fr.mdb;
        reservoir.insert(reservoir.end(), fr.main, fr.main + fr.main_len);
        if (start_byte < 0) continue;  // reservoir not yet primed
        Bits br{reservoir.data(), (int64_t)reservoir.size() * 8};
        br.pos = start_byte * 8;
        int ridx = sfb_rate_idx(rate);
        if (ridx < 0) break;
        for (int grn = 0; grn < fr.ngr; ++grn) {
            double xs[2][576];
            for (int c = 0; c < fr.nch; ++c) {
                Gr& g = fr.gr[grn][c];
                int64_t bits_end = br.pos + g.part23;
                if (g.part23 == 0) {
                    std::memset(xs[c], 0, sizeof(xs[c]));
                    continue;
                }
                if (v1) {
                    const Gr* prev = grn == 1 ? &fr.gr[0][c] : nullptr;
                    read_scf_v1(br, g, grn, fr.scfsi[c], prev);
                } else {
                    bool ist = fr.mode == 1 && (fr.mode_ext & 1) && c == 1;
                    read_scf_lsf(br, g, ist);
                }
                if (br.pos > bits_end) {
                    std::memset(xs[c], 0, sizeof(xs[c]));
                    br.pos = bits_end;
                    continue;
                }
                huffman(br, g, ridx, bits_end, xs[c]);
                br.pos = bits_end;
                requantize(xs[c], g, ridx);
            }
            if (fr.nch == 2)
                stereo_process(xs[0], xs[1], fr, fr.gr[grn][1], ridx);
            double mix[576] = {0};
            for (int c = 0; c < fr.nch; ++c) {
                Gr& g = fr.gr[grn][c];
                reorder_short(xs[c], g, ridx);
                alias_reduce(xs[c], g);
                double sbs[32][18];
                imdct_granule(xs[c], g, st[c], sbs);
                double pcm[576];
                synth_granule(st[c], sbs, pcm);
                for (int i = 0; i < 576; ++i) mix[i] += pcm[i];
            }
            double sc = 1.0 / fr.nch;
            for (int i = 0; i < 576; ++i) {
                if (written >= cap) {
                    info_out[0] = rate;
                    info_out[1] = written;
                    return -2;
                }
                double vv = mix[i] * sc;
                if (vv > 1.0) vv = 1.0;
                if (vv < -1.0) vv = -1.0;
                out[written++] = (float)vv;
            }
        }
        if (reservoir.size() > 4096)
            reservoir.erase(reservoir.begin(),
                            reservoir.end() - 2048);
    }
    if (written == 0 || rate == 0) return -1;
    info_out[0] = rate;
    info_out[1] = written;
    return 0;
}

// 6: the JAX library's version 6 (version 5 and the mp3 decoder)
int mio_runtime_abi_version(void) { return 6; }

}  // extern "C"
