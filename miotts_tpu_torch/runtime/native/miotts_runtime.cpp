// miotts_runtime — the port's native host runtime, a copy of the JAX
// package's miotts_tpu/runtime/native/miotts_runtime.cpp (:11-1407) without
// its mp3 decoder: the persistent worker pool, fp16/bf16 conversion, the
// threaded whole-tensor GGUF dequant (mio_dequant), the WAV encoder
// (mio_encode_wav16), the linear resampler (mio_resample_linear[_len]),
// mio_peak_normalize, the native CPU LLM engine's block-quant kernels
// (per-32-block activation quantization, the Q8_0/Q4_0 row dots with AVX2,
// AVX-512 VNNI on request or scalar, the GEMV, batched-prefill GEMM and
// row-dequant entry points) and the FLAC decoder (mio_flac_probe,
// mio_flac_decode). The code is copied, not rewritten, so every value is
// bit-equal to the JAX library's. One check is added: flac_subframe refuses
// a predictor order above the frame's block size before it writes the
// warm-up samples, where JAX's copy writes past the frame's buffer first and
// refuses the frame after; no valid stream meets it. The mp3 decoder (namespace mp3impl,
// mio_mp3_*, mp3_tables.h) is left out: JAX keeps it opt-in over a
// suspected SIGSEGV, and the port decodes mp3 with runtime/mp3.py.
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


// 5: the JAX library's version 5 (dequant, WAV encode, resample, the
// GEMVs and GEMMs, FLAC); its 6 adds the mp3 decoder, which is not copied
int mio_runtime_abi_version(void) { return 5; }

}  // extern "C"
