// Host-side packed-format codecs (C, exposed via ctypes).
//
// Reference behavior: lib/quantizer/pack_op.py — numba-jit sequential bit
// packers (general_pack*, pack_codes, pack_for_sq_pack_kernel) used during
// quantization and format conversion.  Here the same role is filled by a
// small threaded C++ library operating on the canonical formats of
// qpalette_tpu/ops/packing.py (little-endian bitstreams):
//
//   rowpack:    index i of a row lives at stream bits [i*bits, (i+1)*bits)
//   trellis:    state i is the 16-bit circular window at bit i*KV
//
// Built with `make -C native` (plain g++, no external deps); Python side
// falls back to the JAX implementation when the shared object is absent.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// Pack indices (m x P int32, values < 2^bits) into rowpack words
// (m x (P*bits/32 rounded up + 1) uint32).
void qpt_pack_rows(const int32_t* idx, uint32_t* out, int64_t m, int64_t P,
                   int bits, int64_t words_per_row) {
  int64_t nthreads = std::min<int64_t>(std::thread::hardware_concurrency(),
                                       std::max<int64_t>(m / 64, 1));
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      uint32_t* w = out + r * words_per_row;
      std::memset(w, 0, words_per_row * sizeof(uint32_t));
      const int32_t* row = idx + r * P;
      for (int64_t i = 0; i < P; ++i) {
        uint64_t v = (uint64_t)(uint32_t)row[i] & ((1ull << bits) - 1);
        int64_t bit = i * bits;
        int64_t word = bit >> 5;
        int sh = bit & 31;
        w[word] |= (uint32_t)(v << sh);
        if (sh + bits > 32) w[word + 1] |= (uint32_t)(v >> (32 - sh));
      }
    }
  };
  std::vector<std::thread> ts;
  int64_t chunk = (m + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t a = t * chunk, b = std::min(m, a + chunk);
    if (a >= b) break;
    ts.emplace_back(work, a, b);
  }
  for (auto& t : ts) t.join();
}

// Unpack rowpack words back to indices.
void qpt_unpack_rows(const uint32_t* words, int32_t* out, int64_t m,
                     int64_t P, int bits, int64_t words_per_row) {
  uint32_t mask = (bits == 32) ? 0xffffffffu : ((1u << bits) - 1);
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const uint32_t* w = words + r * words_per_row;
      int32_t* row = out + r * P;
      for (int64_t i = 0; i < P; ++i) {
        int64_t bit = i * bits;
        int64_t word = bit >> 5;
        int sh = bit & 31;
        uint64_t win = w[word] >> sh;
        if (sh + bits > 32) win |= (uint64_t)w[word + 1] << (32 - sh);
        row[i] = (int32_t)(win & mask);
      }
    }
  };
  int64_t nthreads = std::min<int64_t>(std::thread::hardware_concurrency(),
                                       std::max<int64_t>(m / 64, 1));
  std::vector<std::thread> ts;
  int64_t chunk = (m + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t a = t * chunk, b = std::min(m, a + chunk);
    if (a >= b) break;
    ts.emplace_back(work, a, b);
  }
  for (auto& t : ts) t.join();
}

// Pack trellis states (T x 128 int32) into circular bitstreams
// (T x 4*KV uint32): stream bits [0,16) = s_0; then top-KV bits of each
// subsequent state; trailing L-KV bits dropped (tail-biting duplicates).
void qpt_pack_trellis(const int32_t* states, uint32_t* out, int64_t T,
                      int KV) {
  const int S = 128, L = 16;
  int64_t wpt = 4 * KV;
  auto put_bits = [](uint32_t* w, int64_t bit, uint32_t v, int nb,
                     int64_t total_bits) {
    for (int b = 0; b < nb; ++b) {
      int64_t p = bit + b;
      if (p >= total_bits) return;  // dropped tail
      if ((v >> b) & 1) w[p >> 5] |= 1u << (p & 31);
    }
  };
  auto work = [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t) {
      uint32_t* w = out + t * wpt;
      std::memset(w, 0, wpt * sizeof(uint32_t));
      const int32_t* s = states + t * S;
      int64_t total = (int64_t)S * KV;
      put_bits(w, 0, (uint32_t)s[0], L, total);
      for (int i = 1; i < S; ++i)
        put_bits(w, L + (int64_t)(i - 1) * KV,
                 ((uint32_t)s[i]) >> (L - KV), KV, total);
    }
  };
  int64_t nthreads = std::min<int64_t>(std::thread::hardware_concurrency(),
                                       std::max<int64_t>(T / 256, 1));
  std::vector<std::thread> ts;
  int64_t chunk = (T + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t a = t * chunk, b = std::min(T, a + chunk);
    if (a >= b) break;
    ts.emplace_back(work, a, b);
  }
  for (auto& t : ts) t.join();
}

// Unpack trellis bitstreams back to states (circular 16-bit windows).
void qpt_unpack_trellis(const uint32_t* words, int32_t* out, int64_t T,
                        int KV) {
  const int S = 128, L = 16;
  int64_t wpt = 4 * KV;
  int64_t total = (int64_t)S * KV;
  auto work = [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t) {
      const uint32_t* w = words + t * wpt;
      int32_t* s = out + t * S;
      for (int i = 0; i < S; ++i) {
        uint32_t v = 0;
        int64_t bit = (int64_t)i * KV;
        for (int b = 0; b < L; ++b) {
          int64_t p = (bit + b) % total;
          v |= ((w[p >> 5] >> (p & 31)) & 1u) << b;
        }
        s[i] = (int32_t)v;
      }
    }
  };
  int64_t nthreads = std::min<int64_t>(std::thread::hardware_concurrency(),
                                       std::max<int64_t>(T / 256, 1));
  std::vector<std::thread> ts;
  int64_t chunk = (T + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t a = t * chunk, b = std::min(T, a + chunk);
    if (a >= b) break;
    ts.emplace_back(work, a, b);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
