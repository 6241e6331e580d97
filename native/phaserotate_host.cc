// Native host-side runtime for phaserotate_tpu.
//
// The device owns the DSP math; this library owns the host runtime pieces the
// reference implements natively: the SIMD peak scan (the role of
// cli/dsp_peak_calc.h), bulk PCM <-> float conversion and channel
// (de)interleaving for the WAV codec hot path, and a lock-free
// single-producer/single-consumer ring buffer for the real-time host's
// staging (the offset/overlap bookkeeping of the plugin run loop).
//
// Fresh implementation, C++17, AVX2/SSE2 chosen at runtime via
// __builtin_cpu_supports, scalar fallback otherwise.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define PRT_X86 1
#elif defined(__aarch64__) || defined(__ARM_NEON)
#include <arm_neon.h>
#define PRT_NEON 1
#endif

extern "C" {

// ---------------------------------------------------------------------------
// peak scan
// ---------------------------------------------------------------------------

static float peak_scalar(const float* buf, size_t n, float current) {
  float pk = current;
  for (size_t i = 0; i < n; ++i) {
    float v = std::fabs(buf[i]);
    if (v > pk) pk = v;
  }
  return pk;
}

#ifdef PRT_X86
__attribute__((target("avx2")))
static float peak_avx2(const float* buf, size_t n, float current) {
  const __m256 sign_mask = _mm256_set1_ps(-0.0f);
  __m256 acc0 = _mm256_setzero_ps();
  __m256 acc1 = _mm256_setzero_ps();
  __m256 acc2 = _mm256_setzero_ps();
  __m256 acc3 = _mm256_setzero_ps();
  size_t i = 0;
  // 32 floats per iteration, four independent accumulator chains
  for (; i + 32 <= n; i += 32) {
    acc0 = _mm256_max_ps(acc0, _mm256_andnot_ps(sign_mask, _mm256_loadu_ps(buf + i)));
    acc1 = _mm256_max_ps(acc1, _mm256_andnot_ps(sign_mask, _mm256_loadu_ps(buf + i + 8)));
    acc2 = _mm256_max_ps(acc2, _mm256_andnot_ps(sign_mask, _mm256_loadu_ps(buf + i + 16)));
    acc3 = _mm256_max_ps(acc3, _mm256_andnot_ps(sign_mask, _mm256_loadu_ps(buf + i + 24)));
  }
  acc0 = _mm256_max_ps(_mm256_max_ps(acc0, acc1), _mm256_max_ps(acc2, acc3));
  // horizontal max
  __m128 lo = _mm256_castps256_ps128(acc0);
  __m128 hi = _mm256_extractf128_ps(acc0, 1);
  __m128 m = _mm_max_ps(lo, hi);
  m = _mm_max_ps(m, _mm_movehl_ps(m, m));
  m = _mm_max_ss(m, _mm_shuffle_ps(m, m, 1));
  float pk = _mm_cvtss_f32(m);
  if (pk < current) pk = current;
  return peak_scalar(buf + i, n - i, pk);
}

static float peak_sse2(const float* buf, size_t n, float current) {
  const __m128 sign_mask = _mm_set1_ps(-0.0f);
  __m128 acc0 = _mm_setzero_ps();
  __m128 acc1 = _mm_setzero_ps();
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    acc0 = _mm_max_ps(acc0, _mm_andnot_ps(sign_mask, _mm_loadu_ps(buf + i)));
    acc1 = _mm_max_ps(acc1, _mm_andnot_ps(sign_mask, _mm_loadu_ps(buf + i + 4)));
  }
  __m128 m = _mm_max_ps(acc0, acc1);
  m = _mm_max_ps(m, _mm_movehl_ps(m, m));
  m = _mm_max_ss(m, _mm_shuffle_ps(m, m, 1));
  float pk = _mm_cvtss_f32(m);
  if (pk < current) pk = current;
  return peak_scalar(buf + i, n - i, pk);
}
#endif

#ifdef PRT_NEON
static float peak_neon(const float* buf, size_t n, float current) {
  float32x4_t acc0 = vdupq_n_f32(0.0f);
  float32x4_t acc1 = vdupq_n_f32(0.0f);
  float32x4_t acc2 = vdupq_n_f32(0.0f);
  float32x4_t acc3 = vdupq_n_f32(0.0f);
  size_t i = 0;
  // 16 floats per iteration, four independent accumulator chains
  for (; i + 16 <= n; i += 16) {
    acc0 = vmaxq_f32(acc0, vabsq_f32(vld1q_f32(buf + i)));
    acc1 = vmaxq_f32(acc1, vabsq_f32(vld1q_f32(buf + i + 4)));
    acc2 = vmaxq_f32(acc2, vabsq_f32(vld1q_f32(buf + i + 8)));
    acc3 = vmaxq_f32(acc3, vabsq_f32(vld1q_f32(buf + i + 12)));
  }
  acc0 = vmaxq_f32(vmaxq_f32(acc0, acc1), vmaxq_f32(acc2, acc3));
  float pk = vmaxvq_f32(acc0);  // horizontal max
  if (pk < current) pk = current;
  return peak_scalar(buf + i, n - i, pk);
}

static float rotated_peak_neon(const float* b0, const float* b1, size_t n,
                               float ca, float sa, float pk) {
  const float32x4_t vca = vdupq_n_f32(ca);
  const float32x4_t vsa = vdupq_n_f32(sa);
  float32x4_t acc = vdupq_n_f32(0.0f);
  size_t i = 0;
  for (; i + 4 <= n; i += 4) {
    float32x4_t v = vmlaq_f32(vmulq_f32(vca, vld1q_f32(b0 + i)), vsa,
                              vld1q_f32(b1 + i));
    acc = vmaxq_f32(acc, vabsq_f32(v));
  }
  float v = vmaxvq_f32(acc);
  if (v > pk) pk = v;
  for (; i < n; ++i) {
    float w = std::fabs(ca * b0[i] + sa * b1[i]);
    if (w > pk) pk = w;
  }
  return pk;
}
#endif

float prt_peak(const float* buf, size_t n, float current) {
#ifdef PRT_X86
  if (__builtin_cpu_supports("avx2")) return peak_avx2(buf, n, current);
  return peak_sse2(buf, n, current);
#elif defined(PRT_NEON)
  return peak_neon(buf, n, current);
#else
  return peak_scalar(buf, n, current);
#endif
}

// rotated peak: max |ca*b0 + sa*b1| folded with current (the host-side
// check kernel mirroring the device sweep tile)

#ifdef PRT_X86
__attribute__((target("avx2")))
static float rotated_peak_avx2(const float* b0, const float* b1, size_t n,
                               float ca, float sa, float pk) {
  const __m256 sign_mask = _mm256_set1_ps(-0.0f);
  const __m256 vca = _mm256_set1_ps(ca);
  const __m256 vsa = _mm256_set1_ps(sa);
  __m256 acc = _mm256_setzero_ps();
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256 x = _mm256_mul_ps(vca, _mm256_loadu_ps(b0 + i));
    __m256 y = _mm256_mul_ps(vsa, _mm256_loadu_ps(b1 + i));
    acc = _mm256_max_ps(acc, _mm256_andnot_ps(sign_mask, _mm256_add_ps(x, y)));
  }
  __m128 lo = _mm256_castps256_ps128(acc);
  __m128 hi = _mm256_extractf128_ps(acc, 1);
  __m128 m = _mm_max_ps(lo, hi);
  m = _mm_max_ps(m, _mm_movehl_ps(m, m));
  m = _mm_max_ss(m, _mm_shuffle_ps(m, m, 1));
  float v = _mm_cvtss_f32(m);
  if (v > pk) pk = v;
  for (; i < n; ++i) {
    float w = std::fabs(ca * b0[i] + sa * b1[i]);
    if (w > pk) pk = w;
  }
  return pk;
}
#endif

float prt_rotated_peak(const float* b0, const float* b1, size_t n,
                       float ca, float sa, float current) {
  float pk = current;
#ifdef PRT_X86
  if (__builtin_cpu_supports("avx2"))
    return rotated_peak_avx2(b0, b1, n, ca, sa, pk);
#elif defined(PRT_NEON)
  return rotated_peak_neon(b0, b1, n, ca, sa, pk);
#endif
  for (size_t i = 0; i < n; ++i) {
    float w = std::fabs(ca * b0[i] + sa * b1[i]);
    if (w > pk) pk = w;
  }
  return pk;
}

// ---------------------------------------------------------------------------
// PCM conversion + (de)interleave (WAV codec hot path)
// ---------------------------------------------------------------------------

void prt_pcm16_to_f32(const int16_t* in, float* out, size_t n) {
  const float k = 1.0f / 32768.0f;
  for (size_t i = 0; i < n; ++i) out[i] = in[i] * k;
}

void prt_f32_to_pcm16(const float* in, int16_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float v = in[i] * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = (int16_t)std::lrintf(v);
  }
}

void prt_pcm24_to_f32(const uint8_t* in, float* out, size_t n) {
  const float k = 1.0f / 8388608.0f;
  for (size_t i = 0; i < n; ++i) {
    int32_t v = (int32_t)(in[3 * i] | (in[3 * i + 1] << 8) |
                          (in[3 * i + 2] << 16));
    if (v & 0x800000) v -= 0x1000000;
    out[i] = v * k;
  }
}

void prt_f32_to_pcm24(const float* in, uint8_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float f = in[i] * 8388608.0f;
    if (f > 8388607.0f) f = 8388607.0f;
    if (f < -8388608.0f) f = -8388608.0f;
    int32_t v = (int32_t)std::lrintf(f);
    out[3 * i] = (uint8_t)(v & 0xff);
    out[3 * i + 1] = (uint8_t)((v >> 8) & 0xff);
    out[3 * i + 2] = (uint8_t)((v >> 16) & 0xff);
  }
}

void prt_deinterleave(const float* in, float* out, size_t frames,
                      size_t channels) {
  // in: frames x channels interleaved; out: channels x frames planar
  for (size_t c = 0; c < channels; ++c) {
    float* dst = out + c * frames;
    const float* src = in + c;
    for (size_t i = 0; i < frames; ++i) dst[i] = src[i * channels];
  }
}

void prt_interleave(const float* in, float* out, size_t frames,
                    size_t channels) {
  for (size_t c = 0; c < channels; ++c) {
    const float* src = in + c * frames;
    float* dst = out + c;
    for (size_t i = 0; i < frames; ++i) dst[i * channels] = src[i];
  }
}

// ---------------------------------------------------------------------------
// lock-free SPSC ring buffer (real-time host staging)
// ---------------------------------------------------------------------------

struct PrtRing {
  float* data;
  size_t capacity;  // power of two
  std::atomic<size_t> head;  // write index
  std::atomic<size_t> tail;  // read index
};

void* prt_ring_new(size_t min_capacity) {
  size_t cap = 1;
  while (cap < min_capacity) cap <<= 1;
  PrtRing* r = new PrtRing();
  r->data = (float*)std::calloc(cap, sizeof(float));
  r->capacity = cap;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void prt_ring_free(void* ring) {
  PrtRing* r = (PrtRing*)ring;
  std::free(r->data);
  delete r;
}

size_t prt_ring_read_space(void* ring) {
  PrtRing* r = (PrtRing*)ring;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_relaxed);
}

size_t prt_ring_write_space(void* ring) {
  PrtRing* r = (PrtRing*)ring;
  return r->capacity - (r->head.load(std::memory_order_relaxed) -
                        r->tail.load(std::memory_order_acquire));
}

size_t prt_ring_write(void* ring, const float* src, size_t n) {
  PrtRing* r = (PrtRing*)ring;
  size_t space = prt_ring_write_space(ring);
  if (n > space) n = space;
  size_t head = r->head.load(std::memory_order_relaxed);
  size_t mask = r->capacity - 1;
  for (size_t i = 0; i < n; ++i) r->data[(head + i) & mask] = src[i];
  r->head.store(head + n, std::memory_order_release);
  return n;
}

size_t prt_ring_read(void* ring, float* dst, size_t n) {
  PrtRing* r = (PrtRing*)ring;
  size_t avail = prt_ring_read_space(ring);
  if (n > avail) n = avail;
  size_t tail = r->tail.load(std::memory_order_relaxed);
  size_t mask = r->capacity - 1;
  for (size_t i = 0; i < n; ++i) dst[i] = r->data[(tail + i) & mask];
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
