// Native Ogg Vorbis decoder for the fleet ingest hot path.
//
// Same posture as flac_decode.cc: the pure-Python decoder
// (phaserotate_tpu/io/vorbis.py) is the reference implementation and
// owns the error-message surface; this decoder exists because a fleet
// pulling lossy files from disk is decode-bound in Python, while
// the reference CLI gets every format at
// native speed through libsndfile (/root/reference/cli/phase-rotate.cc:33).
// Implemented independently from the public Vorbis I specification
// (xiph.org) — not derived from libvorbis; the algorithm mirrors the
// package's own Python decoder so the two stay bit-comparable in tests.
//
// Scope (same as the Python decoder):
//   * Ogg: page walk, CRC-32 verify, packet reassembly, granule trim
//   * Vorbis: headers, codebooks (Huffman + VQ lookup 1/2), floor 1,
//     residues 0/1/2, square polar coupling, IMDCT (via FFT), windows
//   * floor 0 (deprecated LSP) is rejected -> caller falls back
//
// Decode speedups over the reference Python path: table-driven Huffman
// (10-bit fast table + binary search on left-aligned codewords) and an
// O(n log n) IMDCT (N-point complex FFT, pre/post twiddle) replacing
// the cached cos-matrix product.
//
// Any structural problem returns a negative code and the caller uses
// the Python decoder, which reports the precise error.

#include <algorithm>
#include <array>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// error plumbing: exceptions keep the hot loops branch-light; the
// extern "C" boundary converts them to negative return codes.
// ---------------------------------------------------------------------------

struct FormatError {};     // structural problem -> Python fallback
struct Unsupported {};     // legal stream we do not decode (floor 0)
struct Eop {};             // end of packet: NORMAL mid-decode stop

static inline int ilog(uint32_t x) {
  int n = 0;
  while (x > 0) { ++n; x >>= 1; }
  return n;
}

// ---------------------------------------------------------------------------
// LSB-first bit reader (Vorbis bit packing)
// ---------------------------------------------------------------------------

class Bits {
 public:
  Bits(const uint8_t* d, size_t n) : data_(d), size_(n) {}

  uint32_t read(int n) {
    while (nbits_ < n) {
      if (pos_ >= size_) throw Eop{};
      acc_ |= (uint64_t)data_[pos_++] << nbits_;
      nbits_ += 8;
    }
    uint32_t v = (uint32_t)(acc_ & ((n >= 64 ? ~0ull : (1ull << n) - 1)));
    acc_ >>= n;
    nbits_ -= n;
    return v;
  }

  int read_bit() { return (int)read(1); }

  int64_t remaining() const {
    return (int64_t)(size_ - pos_) * 8 + nbits_;
  }

  // peek up to 32 bits (zero-padded past the packet end), LSB-first
  uint32_t peek32() {
    while (nbits_ < 32 && pos_ < size_)
      { acc_ |= (uint64_t)data_[pos_++] << nbits_; nbits_ += 8; }
    return (uint32_t)(acc_ & 0xFFFFFFFFu);
  }

  void skip(int n) {  // caller guarantees n <= buffered bits
    acc_ >>= n;
    nbits_ -= n;
  }

  int buffered() const { return nbits_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

static double float32_unpack(uint32_t x) {
  double mant = (double)(x & 0x1FFFFF);
  if (x & 0x80000000u) mant = -mant;
  int exp = (int)((x & 0x7FE00000u) >> 21);
  return mant * std::pow(2.0, exp - 788);
}

// ---------------------------------------------------------------------------
// codebooks
// ---------------------------------------------------------------------------

static inline uint32_t bit_reverse32(uint32_t v) {
  v = ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
  v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
  v = ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
  v = ((v >> 8) & 0x00FF00FFu) | ((v & 0x00FF00FFu) << 8);
  return (v >> 16) | (v << 16);
}

struct Codebook {
  int dims = 0;
  int entries = 0;
  int lookup = 0;
  int maxlen = 0;
  std::vector<uint8_t> lengths;
  std::vector<float> vectors;  // entries * dims (lookup 1/2)

  // decode tables: 10-bit LSB-first fast path + sorted left-aligned
  // codewords (prefix-free -> largest key <= word is the match)
  static constexpr int kFastBits = 10;
  std::vector<int32_t> fast_entry;   // 1<<kFastBits, -1 = long code
  std::vector<uint8_t> fast_len;
  std::vector<uint32_t> skeys;       // sorted left-aligned codewords
  std::vector<int32_t> sentry;
  std::vector<uint8_t> slen;

  void parse(Bits& b) {
    if (b.read(24) != 0x564342) throw FormatError{};
    dims = (int)b.read(16);
    entries = (int)b.read(24);
    int ordered = b.read_bit();
    // bound hostile headers exactly like the Python decoder
    if (!ordered && entries > b.remaining() + 8) throw FormatError{};
    if (ordered && entries > (1 << 22)) throw FormatError{};
    lengths.assign(entries, 0);
    if (!ordered) {
      int sparse = b.read_bit();
      for (int i = 0; i < entries; ++i) {
        if (sparse) {
          if (b.read_bit()) lengths[i] = (uint8_t)(b.read(5) + 1);
        } else {
          lengths[i] = (uint8_t)(b.read(5) + 1);
        }
      }
    } else {
      int length = (int)b.read(5) + 1;
      int i = 0;
      while (i < entries) {
        int num = (int)b.read(ilog(entries - i));
        if (i + num > entries) throw FormatError{};
        for (int j = i; j < i + num; ++j) lengths[j] = (uint8_t)length;
        i += num;
        ++length;
        if (length > 32) throw FormatError{};
      }
    }
    build_tables();

    lookup = (int)b.read(4);
    if (lookup == 0) return;
    if (lookup != 1 && lookup != 2) throw FormatError{};
    double minimum = float32_unpack(b.read(32));
    double delta = float32_unpack(b.read(32));
    int value_bits = (int)b.read(4) + 1;
    int sequence_p = b.read_bit();
    int64_t mult_count;
    int64_t lv = 0;
    if (lookup == 1) {
      lv = lookup1_values();
      mult_count = lv;
    } else {
      mult_count = (int64_t)entries * dims;
    }
    if ((int64_t)entries * dims > (1 << 22)) throw FormatError{};
    std::vector<double> mults((size_t)mult_count);
    for (int64_t i = 0; i < mult_count; ++i)
      mults[(size_t)i] = (double)b.read(value_bits);
    vectors.assign((size_t)entries * dims, 0.0f);
    for (int e = 0; e < entries; ++e) {
      double last = 0.0;
      if (lookup == 1) {
        int64_t div = 1;
        for (int d = 0; d < dims; ++d) {
          int64_t off = (e / div) % lv;
          double v = mults[(size_t)off] * delta + minimum + last;
          vectors[(size_t)e * dims + d] = (float)v;
          if (sequence_p) last = v;
          div *= lv;
        }
      } else {
        for (int d = 0; d < dims; ++d) {
          double v = mults[(size_t)e * dims + d] * delta + minimum + last;
          vectors[(size_t)e * dims + d] = (float)v;
          if (sequence_p) last = v;
        }
      }
    }
  }

  int64_t lookup1_values() const {
    // largest v with v**dims <= entries
    int64_t v = (int64_t)std::floor(std::pow((double)entries,
                                             1.0 / dims));
    auto powle = [&](int64_t base) {
      int64_t r = 1;
      for (int d = 0; d < dims; ++d) {
        r *= base;
        if (r > entries) return false;
      }
      return r <= entries;
    };
    while (powle(v + 1)) ++v;
    while (v > 0 && !powle(v)) --v;
    return v;
  }

  void build_tables() {
    // canonical Vorbis assignment (spec 3.2.1): entries in stream
    // order each take the lowest available leaf of their length.
    // State: at most one available subtree per depth, keyed by its
    // left-aligned 32-bit code; taking a leaf at depth < len
    // subdivides it, re-exposing the right siblings along the path.
    maxlen = 0;
    uint32_t available[33] = {0};
    bool avail_set[33] = {false};
    bool first = true;
    std::vector<std::pair<uint32_t, int>> codes;  // (left-aligned, entry)
    for (int e = 0; e < entries; ++e) {
      int len = lengths[e];
      if (len == 0) continue;
      if (len > maxlen) maxlen = len;
      uint32_t key;
      if (first) {
        key = 0;
        for (int y = 1; y <= len; ++y) {
          available[y] = 1u << (32 - y);
          avail_set[y] = true;
        }
        // a length-32 first code leaves no sibling at depth 32
        if (len == 32) avail_set[32] = false;
        first = false;
      } else {
        int z = len;
        while (z > 0 && !avail_set[z]) --z;
        if (z == 0) throw FormatError{};  // overpopulated tree
        key = available[z];
        avail_set[z] = false;
        for (int y = z + 1; y <= len; ++y) {
          available[y] = key + (1u << (32 - y));
          avail_set[y] = true;
        }
      }
      codes.emplace_back(key, e);
    }
    // fast table over the first kFastBits LSB-first stream bits
    fast_entry.assign(1 << kFastBits, -1);
    fast_len.assign(1 << kFastBits, 0);
    skeys.clear();
    sentry.clear();
    slen.clear();
    std::map<uint32_t, int> order;  // sort by left-aligned key
    for (auto& ce : codes) order[ce.first] = ce.second;
    for (auto& kv : order) {
      uint32_t key = kv.first;
      int e = kv.second;
      int len = lengths[e];
      skeys.push_back(key);
      sentry.push_back(e);
      slen.push_back((uint8_t)len);
      if (len <= kFastBits) {
        // stream bits arrive LSB-first; the codeword accumulates
        // MSB-first, so the stream word is the bit-reversed codeword
        uint32_t code = key >> (32 - len);
        uint32_t rev = bit_reverse32(code) >> (32 - len);
        for (uint32_t hi = 0; hi < (1u << (kFastBits - len)); ++hi) {
          uint32_t idx = rev | (hi << len);
          fast_entry[idx] = e;
          fast_len[idx] = (uint8_t)len;
        }
      }
    }
  }

  int decode(Bits& b) const {
    uint32_t w = b.peek32();
    int avail = b.buffered();
    uint32_t idx = w & ((1u << kFastBits) - 1);
    int e = fast_entry[idx];
    if (e >= 0) {
      int len = fast_len[idx];
      if (len > avail) throw Eop{};
      b.skip(len);
      return e;
    }
    // long code: binary-search the left-aligned codeword table with
    // the bit-reversed stream word (largest key <= word is the match
    // in a prefix-free code)
    uint32_t key = bit_reverse32(w);
    size_t lo = 0, hi = skeys.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (skeys[mid] <= key) lo = mid + 1; else hi = mid;
    }
    if (lo == 0) throw FormatError{};
    size_t i = lo - 1;
    int len = slen[i];
    if ((key >> (32 - len)) != (skeys[i] >> (32 - len)))
      throw FormatError{};  // invalid Huffman code
    if (len > avail) throw Eop{};
    b.skip(len);
    return sentry[i];
  }

  const float* vec(int entry) const {
    return vectors.data() + (size_t)entry * dims;
  }
};

// ---------------------------------------------------------------------------
// floor type 1
// ---------------------------------------------------------------------------

static const int kFloor1Ranges[4] = {256, 128, 86, 64};

struct Floor1 {
  int partitions = 0;
  std::vector<int> classlist, class_dims, class_subs, class_master;
  std::vector<std::vector<int>> subclass_books;
  int multiplier = 0;
  std::vector<int> x_list, sort_idx, lo_nb, hi_nb;
  int values = 0;

  void parse(Bits& b, const std::vector<Codebook>& books) {
    partitions = (int)b.read(5);
    classlist.resize(partitions);
    int maxclass = -1;
    for (int p = 0; p < partitions; ++p) {
      classlist[p] = (int)b.read(4);
      if (classlist[p] > maxclass) maxclass = classlist[p];
    }
    for (int c = 0; c <= maxclass; ++c) {
      int dim = (int)b.read(3) + 1;
      int sub = (int)b.read(2);
      int master = sub ? (int)b.read(8) : 0;
      if (sub && master >= (int)books.size()) throw FormatError{};
      std::vector<int> row;
      for (int k = 0; k < (1 << sub); ++k) {
        int bk = (int)b.read(8) - 1;
        if (bk >= (int)books.size()) throw FormatError{};
        row.push_back(bk);
      }
      class_dims.push_back(dim);
      class_subs.push_back(sub);
      class_master.push_back(master);
      subclass_books.push_back(row);
    }
    multiplier = (int)b.read(2) + 1;
    int rangebits = (int)b.read(4);
    x_list = {0, 1 << rangebits};
    for (int p = 0; p < partitions; ++p) {
      int c = classlist[p];
      for (int k = 0; k < class_dims[c]; ++k)
        x_list.push_back((int)b.read(rangebits));
    }
    values = (int)x_list.size();
    // uniqueness (spec requirement; Python raises too)
    {
      std::vector<int> s = x_list;
      std::sort(s.begin(), s.end());
      for (size_t i = 1; i < s.size(); ++i)
        if (s[i] == s[i - 1]) throw FormatError{};
    }
    sort_idx.resize(values);
    for (int i = 0; i < values; ++i) sort_idx[i] = i;
    std::sort(sort_idx.begin(), sort_idx.end(),
              [&](int a, int bb) { return x_list[a] < x_list[bb]; });
    lo_nb.assign(values, 0);
    hi_nb.assign(values, 0);
    for (int i = 2; i < values; ++i) {
      int lo = 0, hi = 1;
      for (int j = 0; j < i; ++j) {
        if (x_list[j] < x_list[i] && x_list[j] > x_list[lo]) lo = j;
        if (x_list[j] > x_list[i] && x_list[j] < x_list[hi]) hi = j;
      }
      lo_nb[i] = lo;
      hi_nb[i] = hi;
    }
  }

  // -> true if the floor is used this frame; fills y (values entries)
  bool decode(Bits& b, const std::vector<Codebook>& books,
              std::vector<int>& y) const {
    if (!b.read_bit()) return false;
    int rng = kFloor1Ranges[multiplier - 1];
    int ybits = ilog(rng - 1);
    y.clear();
    y.push_back((int)b.read(ybits));
    y.push_back((int)b.read(ybits));
    for (int p = 0; p < partitions; ++p) {
      int c = classlist[p];
      int cdim = class_dims[c];
      int cbits = class_subs[c];
      int csub = (1 << cbits) - 1;
      int cval = 0;
      if (cbits) cval = books[class_master[c]].decode(b);
      for (int k = 0; k < cdim; ++k) {
        int book = subclass_books[c][cval & csub];
        cval >>= cbits;
        y.push_back(book >= 0 ? books[book].decode(b) : 0);
      }
    }
    return true;
  }

  static int render_point(int x0, int y0, int x1, int y1, int x) {
    int dy = y1 - y0;
    int adx = x1 - x0;
    int ady = dy < 0 ? -dy : dy;
    int err = ady * (x - x0);
    int off = err / adx;
    return dy < 0 ? y0 - off : y0 + off;
  }

  static void render_line(int x0, int y0, int x1, int y1,
                          int* v, int n) {
    int dy = y1 - y0;
    int adx = x1 - x0;
    int ady = dy < 0 ? -dy : dy;
    int base = ady / adx;
    if (dy < 0) base = -base;
    int sy = dy < 0 ? base - 1 : base + 1;
    ady -= (base < 0 ? -base : base) * adx;
    int y = y0;
    int err = 0;
    if (x0 < n) v[x0] = y;
    for (int x = x0 + 1; x < x1; ++x) {
      err += ady;
      if (err >= adx) { err -= adx; y += sy; } else { y += base; }
      if (x < n) v[x] = y;
    }
  }

  // curve synthesis (spec 7.2.4) onto out[0..n2) (inverse-dB domain)
  void synthesize(const std::vector<int>& y, int n2, float* out,
                  const float* inverse_db) const {
    int rng = kFloor1Ranges[multiplier - 1];
    std::vector<int> fin(values, 0);
    std::vector<char> step2(values, 0);
    fin[0] = y[0];
    fin[1] = y[1];
    step2[0] = step2[1] = 1;
    for (int i = 2; i < values; ++i) {
      int lo = lo_nb[i], hi = hi_nb[i];
      int pred = render_point(x_list[lo], fin[lo], x_list[hi],
                              fin[hi], x_list[i]);
      int val = y[i];
      int highroom = rng - pred;
      int lowroom = pred;
      int room = 2 * (highroom < lowroom ? highroom : lowroom);
      if (val) {
        step2[lo] = step2[hi] = step2[i] = 1;
        if (val >= room) {
          fin[i] = highroom > lowroom ? val - lowroom + pred
                                      : pred - val + highroom - 1;
        } else {
          fin[i] = (val & 1) ? pred - ((val + 1) >> 1)
                             : pred + (val >> 1);
        }
      } else {
        step2[i] = 0;
        fin[i] = pred;
      }
    }
    std::vector<int> curve(n2, 0);
    int hx = 0, lx = 0;
    int ly = fin[0] * multiplier;
    int hy = ly;
    for (int si = 1; si < values; ++si) {
      int j = sort_idx[si];
      if (!step2[j]) continue;
      hx = x_list[j];
      hy = fin[j] * multiplier;
      if (lx < n2)
        render_line(lx, ly, hx < n2 ? hx : n2, hy, curve.data(), n2);
      lx = hx;
      ly = hy;
    }
    if (hx < n2) {
      int fill = hx ? hy : ly;
      for (int j = hx; j < n2; ++j) curve[j] = fill;
    }
    for (int j = 0; j < n2; ++j) {
      int v = curve[j];
      if (v < 0) v = 0;
      if (v > 255) v = 255;
      out[j] = inverse_db[v];
    }
  }
};

// ---------------------------------------------------------------------------
// residue
// ---------------------------------------------------------------------------

struct Residue {
  int rtype = 0;
  int begin = 0, end = 0, partition_size = 0, classifications = 0;
  int classbook = 0;
  std::vector<std::array<int, 8>> books;

  void parse(int rt, Bits& b, const std::vector<Codebook>& cbs) {
    rtype = rt;
    begin = (int)b.read(24);
    end = (int)b.read(24);
    partition_size = (int)b.read(24) + 1;
    classifications = (int)b.read(6) + 1;
    classbook = (int)b.read(8);
    if (classbook >= (int)cbs.size()) throw FormatError{};
    std::vector<int> cascades(classifications);
    for (int c = 0; c < classifications; ++c) {
      int low = (int)b.read(3);
      int high = b.read_bit() ? (int)b.read(5) : 0;
      cascades[c] = (high << 3) | low;
    }
    books.resize(classifications);
    for (int c = 0; c < classifications; ++c) {
      for (int p = 0; p < 8; ++p) {
        if (cascades[c] & (1 << p)) {
          int bk = (int)b.read(8);
          if (bk >= (int)cbs.size() || cbs[bk].lookup == 0)
            throw FormatError{};
          books[c][p] = bk;
        } else {
          books[c][p] = -1;
        }
      }
    }
  }

  // decode additively into nvec vectors of length n (formats 0/1), or
  // one interleaved vector (format 2 — call with nvec=1, n = n2*ch)
  void decode(Bits& b, const std::vector<Codebook>& cbs,
              float** vecs, int nvec, const char* dnd, int n) const {
    int limit_begin = begin < n ? begin : n;
    int limit_end = end < n ? end : n;
    int psize = partition_size;
    int to_read = limit_end - limit_begin;
    if (to_read <= 0) return;
    int parts = to_read / psize;
    const Codebook& cls = cbs[classbook];
    int cpc = cls.dims;  // classwords per codeword
    if (cpc <= 0) throw FormatError{};
    std::vector<int> classifs((size_t)nvec * (parts + cpc), 0);
    for (int pas = 0; pas < 8; ++pas) {
      int pcount = 0;
      while (pcount < parts) {
        if (pas == 0) {
          for (int j = 0; j < nvec; ++j) {
            if (dnd[j]) continue;
            int temp = cls.decode(b);
            for (int i = cpc - 1; i >= 0; --i) {
              classifs[(size_t)j * (parts + cpc) + pcount + i] =
                  temp % classifications;
              temp /= classifications;
            }
          }
        }
        for (int ci = 0; ci < cpc && pcount < parts; ++ci, ++pcount) {
          for (int j = 0; j < nvec; ++j) {
            if (dnd[j]) continue;
            int vq = classifs[(size_t)j * (parts + cpc) + pcount];
            int book = books[vq][pas];
            if (book < 0) continue;
            const Codebook& cb = cbs[book];
            int offset = limit_begin + pcount * psize;
            float* v = vecs[j];
            if (rtype == 0) {
              int step = psize / cb.dims;
              for (int k = 0; k < step; ++k) {
                const float* t = cb.vec(cb.decode(b));
                for (int d = 0; d < cb.dims; ++d) {
                  int idx = offset + k + d * step;
                  if (idx < n) v[idx] += t[d];
                }
              }
            } else {  // formats 1 and 2: contiguous
              for (int k = 0; k < psize; k += cb.dims) {
                const float* t = cb.vec(cb.decode(b));
                for (int d = 0; d < cb.dims; ++d) {
                  int idx = offset + k + d;
                  if (idx < n) v[idx] += t[d];
                }
              }
            }
          }
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// mapping / mode / setup
// ---------------------------------------------------------------------------

struct Mapping {
  int submaps = 1;
  std::vector<std::pair<int, int>> coupling;
  std::vector<int> mux, submap_floor, submap_residue;

  void parse(Bits& b, int channels, int nfloors, int nresidues) {
    submaps = b.read_bit() ? (int)b.read(4) + 1 : 1;
    if (b.read_bit()) {
      int steps = (int)b.read(8) + 1;
      int cb = ilog(channels - 1);
      for (int s = 0; s < steps; ++s) {
        int mag = (int)b.read(cb);
        int ang = (int)b.read(cb);
        if (mag == ang || mag >= channels || ang >= channels)
          throw FormatError{};
        coupling.emplace_back(mag, ang);
      }
    }
    if (b.read(2)) throw FormatError{};
    if (submaps > 1) {
      mux.resize(channels);
      for (int c = 0; c < channels; ++c) {
        mux[c] = (int)b.read(4);
        if (mux[c] >= submaps) throw FormatError{};
      }
    } else {
      mux.assign(channels, 0);
    }
    for (int s = 0; s < submaps; ++s) {
      b.read(8);  // unused time configuration
      int f = (int)b.read(8);
      int r = (int)b.read(8);
      if (f >= nfloors || r >= nresidues) throw FormatError{};
      submap_floor.push_back(f);
      submap_residue.push_back(r);
    }
  }
};

struct Setup {
  int channels = 0;
  int64_t rate = 0;
  int bs0 = 0, bs1 = 0;
  std::vector<Codebook> codebooks;
  std::vector<Floor1> floors;
  std::vector<Residue> residues;
  std::vector<Mapping> mappings;
  std::vector<std::pair<int, int>> modes;  // (blockflag, mapping)

  void parse_ident(const uint8_t* p, size_t n) {
    if (n < 30 || p[0] != 1 || memcmp(p + 1, "vorbis", 6))
      throw FormatError{};
    Bits b(p + 7, n - 7);
    if (b.read(32) != 0) throw FormatError{};
    channels = (int)b.read(8);
    rate = b.read(32);
    b.read(32); b.read(32); b.read(32);  // bitrate fields
    bs0 = 1 << b.read(4);
    bs1 = 1 << b.read(4);
    if (bs0 > bs1 || !b.read_bit()) throw FormatError{};
    if (channels < 1 || rate < 1) throw FormatError{};
  }

  void parse_setup(const uint8_t* p, size_t n) {
    if (n < 7 || p[0] != 5 || memcmp(p + 1, "vorbis", 6))
      throw FormatError{};
    Bits b(p + 7, n - 7);
    int nbooks = (int)b.read(8) + 1;
    codebooks.resize(nbooks);
    for (int i = 0; i < nbooks; ++i) codebooks[i].parse(b);
    int ntimes = (int)b.read(6) + 1;
    for (int i = 0; i < ntimes; ++i)
      if (b.read(16) != 0) throw FormatError{};
    int nfloors = (int)b.read(6) + 1;
    floors.resize(nfloors);
    for (int i = 0; i < nfloors; ++i) {
      int ftype = (int)b.read(16);
      if (ftype == 1) floors[i].parse(b, codebooks);
      else if (ftype == 0) throw Unsupported{};  // LSP: Python rejects too
      else throw FormatError{};
    }
    int nres = (int)b.read(6) + 1;
    residues.resize(nres);
    for (int i = 0; i < nres; ++i) {
      int rt = (int)b.read(16);
      if (rt > 2) throw FormatError{};
      residues[i].parse(rt, b, codebooks);
    }
    int nmaps = (int)b.read(6) + 1;
    mappings.resize(nmaps);
    for (int i = 0; i < nmaps; ++i) {
      if (b.read(16) != 0) throw FormatError{};
      mappings[i].parse(b, channels, nfloors, nres);
    }
    int nmodes = (int)b.read(6) + 1;
    for (int i = 0; i < nmodes; ++i) {
      int blockflag = b.read_bit();
      if (b.read(16) || b.read(16)) throw FormatError{};
      int mapping = (int)b.read(8);
      if (mapping >= nmaps) throw FormatError{};
      modes.emplace_back(blockflag, mapping);
    }
    if (!b.read_bit()) throw FormatError{};
  }
};

// ---------------------------------------------------------------------------
// Ogg container
// ---------------------------------------------------------------------------

struct OggCrc {
  uint32_t tbl[256];
  OggCrc() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i << 24;
      for (int k = 0; k < 8; ++k)
        c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : (c << 1);
      tbl[i] = c;
    }
  }
  uint32_t run(const uint8_t* d, size_t n, uint32_t skip_at) const {
    // CRC with the 4 checksum bytes at offset skip_at treated as zero
    uint32_t c = 0;
    for (size_t i = 0; i < n; ++i) {
      uint8_t byte = (i >= skip_at && i < skip_at + 4) ? 0 : d[i];
      c = (c << 8) ^ tbl[((c >> 24) ^ byte) & 0xFF];
    }
    return c;
  }
};

struct Packets {
  std::vector<std::vector<uint8_t>> pkts;
  int64_t granule = 0;
};

static Packets ogg_packets(const uint8_t* data, size_t size) {
  static const OggCrc crc;
  Packets out;
  std::vector<uint8_t> partial;
  size_t pos = 0;
  bool have_serial = false;
  uint32_t serial = 0;
  while (pos < size) {
    if (size - pos < 27 || memcmp(data + pos, "OggS", 4))
      throw FormatError{};
    if (data[pos + 4] != 0) throw FormatError{};
    uint8_t htype = data[pos + 5];
    int64_t page_granule;
    uint32_t page_serial, page_crc;
    memcpy(&page_granule, data + pos + 6, 8);
    memcpy(&page_serial, data + pos + 14, 4);
    memcpy(&page_crc, data + pos + 22, 4);
    int nsegs = data[pos + 26];
    if (size - pos < 27u + nsegs) throw FormatError{};
    const uint8_t* segs = data + pos + 27;
    size_t body_len = 0;
    for (int i = 0; i < nsegs; ++i) body_len += segs[i];
    size_t body_start = pos + 27 + nsegs;
    if (size - body_start < body_len) throw FormatError{};
    if (crc.run(data + pos, 27 + nsegs + body_len, 22) != page_crc)
      throw FormatError{};
    const uint8_t* body = data + body_start;
    size_t next = body_start + body_len;

    if (!have_serial) { serial = page_serial; have_serial = true; }
    if (page_serial == serial) {
      if (page_granule != -1) out.granule = page_granule;
      if (!(htype & 0x01)) partial.clear();
      size_t off = 0;
      for (int i = 0; i < nsegs; ++i) {
        partial.insert(partial.end(), body + off, body + off + segs[i]);
        off += segs[i];
        if (segs[i] < 255) {
          out.pkts.push_back(std::move(partial));
          partial.clear();
        }
      }
    }
    pos = next;
  }
  return out;
}

// ---------------------------------------------------------------------------
// IMDCT via N-point complex FFT:
//   y[j] = Re( e^{i pi (j+0.5+N/4)/N} * S[j] ),
//   S = FFT_N^{+i}( X[k] * e^{i pi k (0.5 + N/4)/ (N/2)} , zero-padded )
// ---------------------------------------------------------------------------

struct FftPlan {
  int n = 0;
  std::vector<int> rev;
  std::vector<std::complex<double>> tw;      // e^{+2 pi i k / n}, k < n/2
  std::vector<std::complex<double>> pre;     // x-twiddle, k < n/2
  std::vector<std::complex<double>> post;    // y-twiddle, j < n
  std::vector<std::complex<double>> buf;

  explicit FftPlan(int N) : n(N), rev(N), tw(N / 2), pre(N / 2),
                            post(N), buf(N) {
    int logn = 0;
    while ((1 << logn) < N) ++logn;
    for (int i = 0; i < N; ++i) {
      int r = 0;
      for (int bit = 0; bit < logn; ++bit)
        if (i & (1 << bit)) r |= 1 << (logn - 1 - bit);
      rev[i] = r;
    }
    const double pi = 3.14159265358979323846;
    for (int k = 0; k < N / 2; ++k) {
      tw[k] = std::polar(1.0, 2.0 * pi * k / N);
      pre[k] = std::polar(1.0, pi * k * (0.5 + N / 4.0) / (N / 2.0));
    }
    for (int j = 0; j < N; ++j)
      post[j] = std::polar(1.0, pi * (j + 0.5 + N / 4.0) / N);
  }

  // spec: n/2 floats -> out: n floats (time domain, pre-window)
  void imdct(const float* spec, float* out) {
    for (int i = 0; i < n; ++i) buf[i] = {0.0, 0.0};
    for (int k = 0; k < n / 2; ++k)
      buf[rev[k]] = pre[k] * (double)spec[k];
    for (int len = 2; len <= n; len <<= 1) {
      int half = len >> 1;
      int step = n / len;
      for (int i = 0; i < n; i += len) {
        for (int j = 0; j < half; ++j) {
          auto u = buf[i + j];
          auto v = buf[i + j + half] * tw[(size_t)j * step];
          buf[i + j] = u + v;
          buf[i + j + half] = u - v;
        }
      }
    }
    for (int j = 0; j < n; ++j)
      out[j] = (float)(post[j].real() * buf[j].real()
                       - post[j].imag() * buf[j].imag());
  }
};

static void vorbis_window(int left_size, float* w) {
  const double pi = 3.14159265358979323846;
  for (int i = 0; i < left_size; ++i) {
    double x = (i + 0.5) / left_size * (pi / 2.0);
    double s = std::sin(x);
    w[i] = (float)std::sin(pi / 2.0 * s * s);
  }
}

}  // namespace

extern "C" {

// Decode a whole in-memory Ogg Vorbis stream to planar float32.
//
//   data/size   the raw .ogg bytes
//   out         (expect_channels, stride) planar float32, caller-owned
//   stride      frames available per channel in `out`
//   expect_channels / expect_rate: from the caller's header probe; a
//               mismatch returns an error (caller falls back to the
//               Python decoder, which owns the error surface)
//
// Returns decoded frames (granule-trimmed) or a negative code:
//   -1 format error   -2 buffer too small   -3 unsupported feature
int64_t prt_vorbis_decode(const uint8_t* data, int64_t size,
                          float* out, int64_t stride,
                          int32_t expect_channels, int32_t expect_rate) {
  try {
    if (size < 4 || memcmp(data, "OggS", 4)) return -1;
    Packets pk = ogg_packets(data, (size_t)size);
    if (pk.pkts.size() < 3) return -1;
    Setup s;
    s.parse_ident(pk.pkts[0].data(), pk.pkts[0].size());
    s.parse_setup(pk.pkts[2].data(), pk.pkts[2].size());
    if (s.channels != expect_channels || s.rate != expect_rate)
      return -1;

    const int ch = s.channels;
    const int bs0 = s.bs0, bs1 = s.bs1;
    if (bs1 > 8192) return -1;
    const int mode_bits = ilog((uint32_t)(s.modes.size() - 1));

    // per-size IMDCT plans + windows + the inverse-dB table
    FftPlan plan0(bs0);
    FftPlan plan1(bs1);
    std::vector<float> win_half0(bs0 / 2), win_half1(bs1 / 2);
    vorbis_window(bs0 / 2, win_half0.data());
    vorbis_window(bs1 / 2, win_half1.data());
    float inverse_db[256];
    for (int i = 0; i < 256; ++i)
      inverse_db[i] =
          (float)std::pow(10.0, -(255 - i) * (7.0 / 256.0));

    std::vector<std::vector<float>> resid(
        ch, std::vector<float>(bs1 / 2));
    std::vector<float> inter((size_t)ch * (bs1 / 2));
    std::vector<float> curve(bs1 / 2);
    std::vector<std::vector<float>> windowed(
        ch, std::vector<float>(bs1));
    std::vector<std::vector<float>> prev(
        ch, std::vector<float>(bs1));
    std::vector<std::vector<int>> posts(ch);
    std::vector<char> has_floor(ch), no_residue(ch);
    int prev_n = 0;
    int64_t cursor = 0;  // frames written

    for (size_t pi = 3; pi < pk.pkts.size(); ++pi) {
      const auto& pkt = pk.pkts[pi];
      if (pkt.empty()) continue;
      Bits b(pkt.data(), pkt.size());
      int n, blockflag, prev_flag = 1, next_flag = 1;
      const Mapping* mapping;
      try {
        if (b.read_bit() != 0) continue;  // non-audio packet
        int mode_idx = mode_bits ? (int)b.read(mode_bits) : 0;
        if (mode_idx >= (int)s.modes.size()) continue;
        blockflag = s.modes[mode_idx].first;
        mapping = &s.mappings[s.modes[mode_idx].second];
        n = blockflag ? bs1 : bs0;
        if (blockflag) {
          prev_flag = b.read_bit();
          next_flag = b.read_bit();
        }
      } catch (const Eop&) {
        continue;  // undecodable window header: drop the packet
      }
      const int n2 = n / 2;

      for (int c = 0; c < ch; ++c) {
        has_floor[c] = 0;
        no_residue[c] = 1;
        std::fill(resid[c].begin(), resid[c].begin() + n2, 0.0f);
      }
      try {
        for (int c = 0; c < ch; ++c) {
          const Floor1& fl =
              s.floors[mapping->submap_floor[mapping->mux[c]]];
          has_floor[c] =
              fl.decode(b, s.codebooks, posts[c]) ? 1 : 0;
          no_residue[c] = !has_floor[c];
        }
        // coupling: a zero-floor channel still carries residue if its
        // partner does (spec 4.3.4 step 4)
        for (auto& cp : mapping->coupling) {
          if (!(no_residue[cp.first] && no_residue[cp.second]))
            no_residue[cp.first] = no_residue[cp.second] = 0;
        }
        for (int sm = 0; sm < mapping->submaps; ++sm) {
          std::vector<int> sub_ch;
          for (int c = 0; c < ch; ++c)
            if (mapping->mux[c] == sm) sub_ch.push_back(c);
          const Residue& res =
              s.residues[mapping->submap_residue[sm]];
          if (res.rtype == 2) {
            char dnd_all = 1;
            for (int c : sub_ch) dnd_all &= no_residue[c];
            int total = n2 * (int)sub_ch.size();
            std::fill(inter.begin(), inter.begin() + total, 0.0f);
            float* one = inter.data();
            res.decode(b, s.codebooks, &one, 1, &dnd_all, total);
            for (size_t k = 0; k < sub_ch.size(); ++k) {
              float* dst = resid[sub_ch[k]].data();
              for (int j = 0; j < n2; ++j)
                dst[j] = inter[(size_t)j * sub_ch.size() + k];
            }
          } else {
            std::vector<float*> vecs;
            std::vector<char> dnd;
            for (int c : sub_ch) {
              vecs.push_back(resid[c].data());
              dnd.push_back(no_residue[c]);
            }
            res.decode(b, s.codebooks, vecs.data(),
                       (int)vecs.size(), dnd.data(), n2);
          }
        }
      } catch (const Eop&) {
        // spec: EOP during floor/residue decode is normal —
        // synthesize from whatever was decoded so far
      }

      // square polar coupling inverse (spec 4.3.5)
      for (auto it = mapping->coupling.rbegin();
           it != mapping->coupling.rend(); ++it) {
        float* m = resid[it->first].data();
        float* a = resid[it->second].data();
        for (int j = 0; j < n2; ++j) {
          float M = m[j], A = a[j];
          if (M > 0) {
            if (A > 0) { a[j] = M - A; }
            else { m[j] = M + A; a[j] = M; }
          } else {
            if (A > 0) { a[j] = M + A; }
            else { m[j] = M - A; a[j] = M; }
          }
        }
      }

      // floor curve x residue -> spectrum -> time -> window
      FftPlan& plan = blockflag ? plan1 : plan0;
      for (int c = 0; c < ch; ++c) {
        if (!has_floor[c]) {
          std::fill(windowed[c].begin(), windowed[c].begin() + n,
                    0.0f);
          continue;
        }
        const Floor1& fl =
            s.floors[mapping->submap_floor[mapping->mux[c]]];
        fl.synthesize(posts[c], n2, curve.data(), inverse_db);
        for (int j = 0; j < n2; ++j) curve[j] *= resid[c][j];
        plan.imdct(curve.data(), windowed[c].data());
      }
      // window shape (long blocks may have short-block transitions)
      int left_start = 0, left_size = n2;
      int right_start = n2, right_size = n2;
      if (blockflag && !prev_flag) {
        left_start = n / 4 - bs0 / 4;
        left_size = bs0 / 2;
      }
      if (blockflag && !next_flag) {
        right_start = (n * 3) / 4 - bs0 / 4;
        right_size = bs0 / 2;
      }
      const float* wl = left_size == bs0 / 2 ? win_half0.data()
                                             : win_half1.data();
      const float* wr = right_size == bs0 / 2 ? win_half0.data()
                                              : win_half1.data();
      for (int c = 0; c < ch; ++c) {
        float* y = windowed[c].data();
        for (int j = 0; j < left_start; ++j) y[j] = 0.0f;
        for (int j = 0; j < left_size; ++j)
          y[left_start + j] *= wl[j];
        for (int j = 0; j < right_size; ++j)
          y[right_start + j] *= wr[right_size - 1 - j];
        for (int j = right_start + right_size; j < n; ++j) y[j] = 0.0f;
      }

      // overlap-add: previous center .. current center
      if (prev_n) {
        int hop = prev_n / 4 + n / 4;
        if (cursor + hop > stride) return -2;
        int seg = prev_n / 2 < hop ? prev_n / 2 : hop;
        int start = hop - n2;  // current block start on this timeline
        for (int c = 0; c < ch; ++c) {
          float* dst = out + (int64_t)c * stride + cursor;
          const float* pv = prev[c].data() + prev_n / 2;
          for (int j = 0; j < hop; ++j) dst[j] = 0.0f;
          for (int j = 0; j < seg; ++j) dst[j] += pv[j];
          const float* cur = windowed[c].data();
          if (start < 0) {
            for (int j = 0; j < hop; ++j) dst[j] += cur[j - start];
          } else {
            for (int j = 0; j < hop - start; ++j)
              dst[start + j] += cur[j];
          }
        }
        cursor += hop;
      }
      for (int c = 0; c < ch; ++c)
        std::swap(prev[c], windowed[c]);
      prev_n = n;
    }

    if (pk.granule >= 0 && cursor > pk.granule) cursor = pk.granule;
    return cursor;
  } catch (const Unsupported&) {
    return -3;
  } catch (const FormatError&) {
    return -1;
  } catch (const Eop&) {
    return -1;  // EOP escaping a header parse = truncated header
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
