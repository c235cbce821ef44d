// gf_matmul.cu — GF(2^8) matrix product on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/rs_pallas.py::_fused_fn.
// Same function, another form:
//
//   out (r, n) = coeffs (r, k) x data (k, n) over GF(2^8), polynomial 0x11D
//
// The Pallas kernel lifts the coefficients to an (8r, 8k) GF(2) matrix and
// runs an int8 dot on the MXU against the payload's bit-planes. Here each
// product c*d is a nibble-split table lookup,
//
//   c*d = lo[c][d & 15] ^ hi[c][d >> 4]      (32 bytes of table per c),
//
// the form of ops/native/seaweed_ec.cc. Every block builds the tables of its
// coefficient tile in shared memory from the raw (r, k) coefficient bytes,
// so the only device constant is the coefficient matrix itself.
//
// Bound. The work is k*r table products per column against (k + r) bytes
// moved per column, so the card's memory is the limit: (k + r) * n bytes at
// 3.35 TB/s, 35 us for the RS(10,4) encode of an 8 MiB slab. The design
// reads each payload byte from device memory once per tile of 4 output rows
// (once in all on the main path, where r <= 4), as 16-byte vector loads, and
// writes each output byte once, as 16-byte vector stores. Lookups hit shared
// memory: all 32 lanes of a warp read the same 16-byte half-table at once,
// which spans 4 banks, so the lookups never conflict.
//
// Grid. blockIdx.x tiles the columns, 16 consecutive columns per thread;
// blockIdx.y tiles the output rows by 4, so one code path serves every
// geometry from a (1, k) plan to a (128, 640) matrix; k is walked in chunks
// of 128 rows of tables (16 KB of static shared memory). The Pallas grid runs
// in order on one core; CUDA blocks run in any order, and nothing needs an
// order here: output columns are independent, and each block owns its
// columns and rows outright, so there is no reduction across blocks.
//
// Ragged widths. Row j of a (k, n) uint8 tensor starts at j*n, so 16-byte
// accesses are legal only when n % 16 == 0 and both base pointers are
// 16-byte aligned. Otherwise the kernel reads and writes single bytes and
// masks every column >= n; nothing is padded on the host.
//
// C interface (loaded with ctypes by ops/rs_hopper.py):
//   int gf_matmul_launch(const uint8_t* coeffs, const uint8_t* data,
//                        uint8_t* out, int r, int k, long long n,
//                        cudaStream_t stream);
// All pointers are device pointers to contiguous row-major uint8 arrays.
// Returns cudaGetLastError() after the launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 16;      // consecutive columns per thread (one uint4)
constexpr int kRowTile = 4;    // output rows per block
constexpr int kKChunk = 128;   // input rows whose tables are staged at once

// c * d in GF(2^8) mod 0x11D, shift-and-add (only used to build tables)
__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p ^= (0u - (b & 1u)) & a;
    a = (a << 1) ^ ((0u - (a >> 7)) & 0x11Du);
    b >>= 1;
  }
  return p;
}

__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ coeffs,
                 const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, int r, int k, long long n,
                 bool vec) {
  // tab[(i * kKChunk + j) * 32 + x]: x < 16 -> c_ij * x, else c_ij * (x-16)<<4
  __shared__ __align__(16) uint8_t tab[kRowTile * kKChunk * 32];

  const int row0 = blockIdx.y * kRowTile;
  const int rows = min(kRowTile, r - row0);
  const long long col0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const bool active = col0 < n;
  // with vec, n % 16 == 0, so an active thread owns 16 valid columns
  const bool full = vec && active;

  uint32_t acc[kRowTile][4];
#pragma unroll
  for (int i = 0; i < kRowTile; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0;
  }

  for (int j0 = 0; j0 < k; j0 += kKChunk) {
    const int kc = min(kKChunk, k - j0);
    __syncthreads();  // the previous chunk's tables are no longer read
    for (int e = threadIdx.x; e < rows * kc * 32; e += kThreads) {
      const int x = e & 31;
      const int j = (e >> 5) % kc;
      const int i = (e >> 5) / kc;
      const uint32_t c = coeffs[static_cast<size_t>(row0 + i) * k + j0 + j];
      const uint32_t d = x < 16 ? x : (x - 16) << 4;
      tab[(i * kKChunk + j) * 32 + x] = static_cast<uint8_t>(gf_mul(c, d));
    }
    __syncthreads();
    if (!active) continue;  // still joins the barriers of later chunks

    for (int j = 0; j < kc; ++j) {
      const uint8_t* src = data + static_cast<size_t>(j0 + j) * n + col0;
      uint32_t w[4];
      if (full) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = 0;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (col0 + c < n) {
            w[c >> 2] |= static_cast<uint32_t>(__ldg(src + c)) << (8 * (c & 3));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) {
        if (i < rows) {  // uniform across the block
          const uint8_t* lo = tab + (i * kKChunk + j) * 32;
          const uint8_t* hi = lo + 16;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t p = 0;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const uint32_t b = (w[q] >> (8 * t)) & 0xFFu;
              p |= static_cast<uint32_t>(lo[b & 15u] ^ hi[b >> 4]) << (8 * t);
            }
            acc[i][q] ^= p;
          }
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < kRowTile; ++i) {
    if (i < rows) {
      uint8_t* dst = out + static_cast<size_t>(row0 + i) * n + col0;
      if (full) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (col0 + c < n) {
            dst[c] = static_cast<uint8_t>(acc[i][c >> 2] >> (8 * (c & 3)));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int gf_matmul_launch(const uint8_t* coeffs, const uint8_t* data,
                                uint8_t* out, int r, int k, long long n,
                                cudaStream_t stream) {
  if (r <= 0 || k <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = n % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = static_cast<long long>(kThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>((r + kRowTile - 1) / kRowTile));
  gf_matmul_kernel<<<grid, kThreads, 0, stream>>>(coeffs, data, out, r, k, n,
                                                   vec);
  return static_cast<int>(cudaGetLastError());
}
