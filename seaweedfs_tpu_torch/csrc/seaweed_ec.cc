// The native CPU codec: the GF(2^8) Reed-Solomon product
// out[i] = XOR_j coeffs[i][j] * data[j] (polynomial 0x11D) on the host,
// the stand-in for the reference's klauspost/reedsolomon SIMD dependency
// (reference go.mod:47, hot loop ec_encoder.go:118-134).
//
// Nibble-split table lookup: for a constant c,
// c*b = LO[c][b & 15] ^ HI[c][b >> 4], so the inner loop is two 16-entry
// shuffles and an XOR, vectorized with AVX2 _mm256_shuffle_epi8 where the
// build host has it (32 bytes an iteration), with a scalar fallback.
//
// Built with the host C++ compiler into seaweedfs_tpu_torch/build/ at
// first use (ops/rs_native.py) and called through ctypes:
//   void sw_ec_matmul(const uint8_t* coeffs, int r, int k,
//                     const uint8_t* data, long long n, uint8_t* out);
//   void sw_ec_matmul_mt(..., int nthreads);  // column slices, one a thread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kPoly = 0x11D;

struct Tables {
  // lo[c][x]  = c * x        (x in 0..15)
  // hi[c][x]  = c * (x<<4)
  alignas(32) uint8_t lo[256][16];
  alignas(32) uint8_t hi[256][16];

  Tables() {
    uint8_t mul[256][256];
    uint8_t exp[512];
    int log[256];
    int x = 1;
    for (int i = 0; i < 255; i++) {
      exp[i] = static_cast<uint8_t>(x);
      log[x] = i;
      x <<= 1;
      if (x & 0x100) x ^= kPoly;
    }
    for (int i = 255; i < 512; i++) exp[i] = exp[i - 255];
    log[0] = 0;
    for (int a = 0; a < 256; a++) {
      for (int b = 0; b < 256; b++) {
        mul[a][b] = (a && b)
                        ? exp[log[a] + log[b]]
                        : 0;
      }
    }
    for (int c = 0; c < 256; c++) {
      for (int xn = 0; xn < 16; xn++) {
        lo[c][xn] = mul[c][xn];
        hi[c][xn] = mul[c][xn << 4];
      }
    }
  }
};

const Tables g_tables;

// out[0..n) ^= c * src[0..n)
void mul_xor_row(uint8_t c, const uint8_t* __restrict src, long long n,
                 uint8_t* __restrict dst) {
  if (c == 0) return;
  if (c == 1) {
    long long t = 0;
#if defined(__AVX2__)
    for (; t + 32 <= n; t += 32) {
      __m256i d = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + t));
      __m256i o = _mm256_loadu_si256(reinterpret_cast<__m256i*>(dst + t));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + t),
                          _mm256_xor_si256(o, d));
    }
#endif
    for (; t < n; t++) dst[t] ^= src[t];
    return;
  }
  const uint8_t* lo = g_tables.lo[c];
  const uint8_t* hi = g_tables.hi[c];
  long long t = 0;
#if defined(__AVX2__)
  const __m256i vlo = _mm256_broadcastsi128_si256(
      _mm_load_si128(reinterpret_cast<const __m128i*>(lo)));
  const __m256i vhi = _mm256_broadcastsi128_si256(
      _mm_load_si128(reinterpret_cast<const __m128i*>(hi)));
  const __m256i mask = _mm256_set1_epi8(0x0F);
  for (; t + 32 <= n; t += 32) {
    __m256i d = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + t));
    __m256i dl = _mm256_and_si256(d, mask);
    __m256i dh = _mm256_and_si256(_mm256_srli_epi64(d, 4), mask);
    __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(vlo, dl),
                                 _mm256_shuffle_epi8(vhi, dh));
    __m256i o = _mm256_loadu_si256(reinterpret_cast<__m256i*>(dst + t));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + t),
                        _mm256_xor_si256(o, p));
  }
#endif
  for (; t < n; t++) {
    uint8_t d = src[t];
    dst[t] ^= static_cast<uint8_t>(lo[d & 0x0F] ^ hi[d >> 4]);
  }
}

}  // namespace

extern "C" {

void sw_ec_matmul(const uint8_t* coeffs, int r, int k, const uint8_t* data,
                  long long n, uint8_t* out) {
  for (int i = 0; i < r; i++) {
    uint8_t* dst = out + static_cast<long long>(i) * n;
    for (int j = 0; j < k; j++) {
      mul_xor_row(coeffs[i * k + j], data + static_cast<long long>(j) * n, n,
                  dst);
    }
  }
}

// Multi-threaded variant: the byte range [0, n) is split into per-thread
// column slices (the reference dependency parallelizes the same way —
// klauspost/reedsolomon splits shards across goroutines). nthreads <= 0
// means hardware concurrency. Each slice is independent, so output is
// bit-identical to the single-threaded path.
void sw_ec_matmul_mt(const uint8_t* coeffs, int r, int k, const uint8_t* data,
                     long long n, uint8_t* out, int nthreads) {
  if (nthreads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    nthreads = hc ? static_cast<int>(hc) : 1;
  }
  constexpr long long kMinSlice = 64 * 1024;
  long long max_by_size = (n + kMinSlice - 1) / kMinSlice;
  if (max_by_size < nthreads) nthreads = static_cast<int>(max_by_size);
  if (nthreads <= 1) {
    sw_ec_matmul(coeffs, r, k, data, n, out);
    return;
  }
  // 64-byte-aligned slice boundaries keep the AVX2 loops off split lines
  long long step = ((n + nthreads - 1) / nthreads + 63) & ~63LL;
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  for (int t = 0; t < nthreads; t++) {
    long long lo = t * step;
    if (lo >= n) break;
    long long hi = lo + step < n ? lo + step : n;
    workers.emplace_back([=] {
      for (int i = 0; i < r; i++) {
        uint8_t* dst = out + static_cast<long long>(i) * n + lo;
        for (int j = 0; j < k; j++) {
          mul_xor_row(coeffs[i * k + j],
                      data + static_cast<long long>(j) * n + lo, hi - lo, dst);
        }
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
