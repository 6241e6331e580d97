// Native packer for the lossless residual wire transport.
//
// Exact twin of the numpy reference in phaserotate_tpu/search/packed.py
// (pack_residual): fixed-order residual (iterated first difference,
// orders 0..3, FLAC's fixed-predictor family) + per-4096-sample-block
// minimal signed bit width, packed little-endian into an int32 word
// stream.  The numpy pack costs seconds per 64-file fleet chunk on the
// 1-core bench host — far more than the wire transfer it is meant to
// hide under — so the fleet calls this via ctypes (which releases the
// GIL, letting the pack overlap the previous chunk's transfer).
//
// Layout contract (must match packed.py bit for bit; the device-side
// unpack is a jitted XLA program keyed on it):
//   * streams padded with zeros to nb*BLOCK samples
//   * residual order k chosen per stream by minimal total packed bits,
//     first minimum wins (np.argmin tie-break)
//   * signed width per block: w = floor(log2(max(|hi|, |lo+1|))) + 2,
//     minimum 1 (packed.py _signed_width)
//   * blocks laid out in (stream, block) order, each word-aligned
//     (BLOCK*w bits = 128*w words exactly)
//   * little-endian bit order: sample i occupies bits [i*w, (i+1)*w)
//
// Reference workload: the CLI fleet search streams every file from
// disk (/root/reference/cli/phase-rotate.cc:573-587); this transport
// is the device build's answer to shipping that stream over a slow
// host->device link.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kBlock = 4096;   // must equal packed.py BLOCK
constexpr int kMaxOrder = 3;       // must equal packed.py MAX_ORDER

// Minimal signed bit width holding every value in [mn, mx]
// (packed.py _signed_width).
static inline int32_t signed_width(int64_t mx, int64_t mn) {
  int64_t hi = mx > 0 ? mx : 0;
  int64_t lo = mn < 0 ? -mn - 1 : 0;
  int64_t m = hi > lo ? hi : lo;
  if (m <= 0) return 1;
  return 64 - __builtin_clzll((uint64_t)m) + 1;  // floor(log2 m) + 2
}

}  // namespace

extern "C" {

// Pack (S, n) int16 PCM into the residual wire format.
//
//   x        (S, n) C-contiguous int16
//   words    out, capacity words_cap int32 (worst case: S*nb*2048 — the
//            selected order never costs more than order 0's <= 16
//            bits/sample)
//   widths   out (S, nb) int32, nb = ceil(n / 4096)
//   woffs    out (S, nb) int32
//   order    out (S,) int32
//
// Returns the total words used, or -1 if words_cap is too small.
// Does NOT zero the tail beyond the return value (the Python wrapper
// owns grid padding + slack-word zeroing).
int64_t prt_pack_residual(const int16_t* x, int64_t S, int64_t n,
                          int32_t* words, int64_t words_cap,
                          int32_t* widths, int32_t* woffs,
                          int32_t* order) {
  if (S <= 0 || n <= 0) return 0;
  const int64_t nb = (n + kBlock - 1) / kBlock;
  const int64_t npad = nb * kBlock;

  // per-order residual buffers (reused across streams)
  std::vector<int32_t> rbuf[kMaxOrder + 1];
  for (int k = 0; k <= kMaxOrder; ++k) rbuf[k].assign((size_t)npad, 0);
  std::vector<int32_t> wtab((size_t)(kMaxOrder + 1) * nb);

  int64_t wcursor = 0;
  for (int64_t s = 0; s < S; ++s) {
    const int16_t* src = x + s * n;
    int32_t* r0 = rbuf[0].data();
    for (int64_t i = 0; i < n; ++i) r0[i] = src[i];
    if (npad > n) std::memset(r0 + n, 0, (size_t)(npad - n) * 4);

    // order-k residual chains + per-block widths + total costs
    int64_t best_cost = INT64_MAX;
    int best_k = 0;
    for (int k = 0; k <= kMaxOrder; ++k) {
      if (k) {
        const int32_t* prev = rbuf[k - 1].data();
        int32_t* cur = rbuf[k].data();
        int32_t last = 0;
        for (int64_t i = 0; i < npad; ++i) {
          cur[i] = prev[i] - last;
          last = prev[i];
        }
      }
      const int32_t* r = rbuf[k].data();
      int64_t cost = 0;
      for (int64_t b = 0; b < nb; ++b) {
        int64_t mx = INT64_MIN, mn = INT64_MAX;
        const int32_t* blk = r + b * kBlock;
        for (int64_t i = 0; i < kBlock; ++i) {
          int32_t v = blk[i];
          if (v > mx) mx = v;
          if (v < mn) mn = v;
        }
        int32_t w = signed_width(mx, mn);
        wtab[(size_t)(k * nb + b)] = w;
        cost += w;
      }
      if (cost < best_cost) {  // strict <: first minimum wins
        best_cost = cost;
        best_k = k;
      }
    }
    order[s] = best_k;

    const int32_t* r = rbuf[best_k].data();
    const int32_t* wrow = &wtab[(size_t)(best_k * nb)];
    for (int64_t b = 0; b < nb; ++b) {
      const int32_t w = wrow[b];
      widths[s * nb + b] = w;
      woffs[s * nb + b] = (int32_t)wcursor;
      const int64_t nwords = w * (kBlock / 32);
      if (wcursor + nwords > words_cap) return -1;
      uint32_t* out = (uint32_t*)(words + wcursor);
      const uint32_t mask = (w >= 32) ? 0xffffffffu : ((1u << w) - 1u);
      const int32_t* blk = r + b * kBlock;
      uint64_t acc = 0;
      int nacc = 0;
      for (int64_t i = 0; i < kBlock; ++i) {
        acc |= (uint64_t)((uint32_t)blk[i] & mask) << nacc;
        nacc += w;
        if (nacc >= 32) {
          *out++ = (uint32_t)acc;
          acc >>= 32;
          nacc -= 32;
        }
      }
      wcursor += nwords;
    }
  }
  return wcursor;
}

}  // extern "C"
