// gf_matmul.cu — GF(2^8) matrix product on Hopper (sm_90a), from a tile plan.
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/rs_pallas.py::_fused_fn.
// Same function, another form:
//
//   out (r, n) = coeffs (r, k) x data (k, n) over GF(2^8), polynomial 0x11D
//
// The Pallas kernel lifts the coefficients to an (8r, 8k) GF(2) matrix and
// runs an int8 dot on the MXU against the payload's bit-planes. Here each
// product is a nibble-split table lookup, c*b = lo[b & 15] ^ hi[b >> 4], and
// the tables come from a plan built once per matrix on the host
// (ops/gf_plan.make_plan):
//
//   * output rows sorted by their non-zero pattern and cut into tiles of 4;
//     row_map[4t + i] is the output row of slot i of tile t;
//   * per tile, the input rows with any non-zero coefficient in it
//     (pair_rows[tile_ptr[t] .. tile_ptr[t+1]]); the others are skipped;
//   * per (tile, input row) pair, 32 uint32 words: word x < 16 packs
//     c_i * x for the tile's 4 rows (slot i in byte i), word 16 + x packs
//     c_i * (x << 4).
//
// What bounds it. The work is the plan's pairs: per column and pair, one
// payload byte read, two 32-bit shared-memory lookups and about 4 integer
// ops (one __byte_perm per lookup address, the XOR, a share of the nibble
// masks). Per warp and 4 payload bytes that is 8 lookups at 128 B a clock
// for the SM and 16 integer ops at 64 lanes a clock: about 32 clocks of each
// SM quarter, so the integer pipe and shared memory bind together, and the
// bytes that must move, (k + r) * n at 3.35 TB/s, are the third limit.
//   * (4,10): 10 pairs, about 0.023 ms of lookups against 0.035 ms of
//     memory for an 8 MiB slab: memory-bound. The previous kernel looked
//     up one byte per product, about 40 instructions per column and pair,
//     and was bound by issue at 4.3x the memory time.
//   * Piggyback (128, 320): sorting rows by support puts the 4 parities of
//     one sub-stripe, which share 15 input rows, in one tile: 480 pairs per
//     column for the encode matrix (984 for a 4-loss decode plan) instead of
//     a dense walk over all 128 x 320 coefficients, the payload read 1.5
//     (3.1) times over, the repeats from L2. Lookups and integer ops, about
//     0.03 ms at 262,144 columns, weigh as much as the memory does.
// Neither lookup can go: a byte-wide 256-word table would take one lookup
// where nibbles take two, but its random indices conflict in the 32 banks.
//
// Design.
//   * Grid: one block per (column range, tile), the tile the fastest index,
//     so the tiles that share a column range run together and their repeat
//     payload reads hit L2. 256 threads, 16 consecutive columns per thread.
//   * Tables: the block stages its tile's pair tables (128 B each) and input
//     row numbers in shared memory with cp.async, 128 pairs (16 KB) at a
//     time; a denser tile (a (128, 640) matrix lists up to 640) walks its
//     list in chunks.
//   * Inner loop: payload rows are loaded 4 at a time as 16-byte vectors,
//     all 4 issued before their use; per payload byte, two 32-bit lookups in
//     the pair's half-tables and an XOR into one packed 4-row accumulator
//     per column. Each lookup's byte offset is one __byte_perm (see
//     accumulate). A half-table is 16 consecutive words, so it spans 16
//     distinct banks and a warp's lookups into it never conflict.
//   * Epilogue: a 4x4 byte transpose with __byte_perm turns the 16 packed
//     accumulators into 4 rows of 16 bytes, each written with one 16-byte
//     store to out[row_map[4t + i]].
//   * Ragged widths: row j of a (k, n) uint8 tensor starts at j*n, so 16-byte
//     accesses are legal only when n % 16 == 0 and both base pointers are
//     16-byte aligned. Otherwise the kernel reads and writes single bytes and
//     masks every column >= n; nothing is padded on the host.
//   Blocks own their columns and rows outright: no reduction across blocks,
//   and no order among them is needed.
//
// C interface (loaded with ctypes by ops/rs_hopper.py):
//   int gf_matmul_launch(const int32_t* tile_ptr, const int32_t* pair_rows,
//                        const uint32_t* tables, const int32_t* row_map,
//                        int tiles, int r, const uint8_t* data, uint8_t* out,
//                        long long n, cudaStream_t stream);
// All pointers are device pointers to contiguous arrays: the plan's
// (tiles + 1), (pairs), (pairs, 32) and (r) arrays, data (k, n) and out
// (r, n) row-major uint8. tables must be 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 16;      // consecutive columns per thread (one uint4)
constexpr int kRowTile = 4;    // output rows per tile: one packed word
constexpr int kWords = 32;     // table words per pair
constexpr int kChunk = 128;    // pairs staged in shared memory at once
constexpr int kBatch = 4;      // payload rows loaded before their use
static_assert(kBatch == 4, "the batch loop pairs even and odd pairs");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// 16 payload bytes of one row at columns col0 .. col0 + 15, byte c in
// byte c & 3 of word c >> 2; masked at n unless the vector path is legal.
__device__ __forceinline__ uint4 load_cols(const uint8_t* src, bool full,
                                           long long col0, long long n) {
  if (full) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (col0 + c < n) {
      w[c >> 2] |= static_cast<uint32_t>(__ldg(src + c)) << (8 * (c & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* tab,
                                            uint32_t byte_offset) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(tab) + byte_offset);
}

// acc[c] ^= lo[b_c & 15] ^ hi[b_c >> 4] for the 16 payload bytes b_c of
// staged pair q = 2 * (seg >> 8) + kOdd. Pair q's words start at byte 128 q,
// so lo[x] lies at 256 (q >> 1) + 128 (q & 1) + 4x and hi[x] 64 bytes
// above: byte 0 of the offset is 4x plus the two tag bits, bytes 1-2 are
// the segment q >> 1. Masks put each byte's two nibble offsets, tagged, in
// the bytes of two words; one __byte_perm per lookup then splices byte t
// onto the segment, so an address costs one integer op and no add (the
// integer pipe, 64 lanes a clock per SM, is this kernel's scarce unit).
template <int kOdd>
__device__ __forceinline__ void accumulate(uint32_t (&acc)[kCols],
                                           const uint32_t* tab, uint32_t seg,
                                           uint4 v) {
  constexpr uint32_t kLoTag = kOdd ? 0x80808080u : 0u;
  constexpr uint32_t kHiTag = kLoTag | 0x40404040u;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo = ((w[q] << 2) & 0x3C3C3C3Cu) | kLoTag;
    const uint32_t hi = ((w[q] >> 2) & 0x3C3C3C3Cu) | kHiTag;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc[4 * q + t] ^= word_at(tab, __byte_perm(lo, seg, 0x7650 + t)) ^
                        word_at(tab, __byte_perm(hi, seg, 0x7650 + t));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const int32_t* __restrict__ tile_ptr,
                 const int32_t* __restrict__ pair_rows,
                 const uint32_t* __restrict__ tables,
                 const int32_t* __restrict__ row_map, int tiles, int r,
                 const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, long long n, bool vec) {
  __shared__ __align__(16) uint32_t tab[kChunk * kWords];
  __shared__ int32_t rows[kChunk];

  const int tile = static_cast<int>(blockIdx.x % tiles);
  const long long col0 =
      (static_cast<long long>(blockIdx.x / tiles) * kThreads + threadIdx.x) *
      kCols;
  const bool active = col0 < n;
  // with vec, n % 16 == 0, so an active thread owns 16 valid columns
  const bool full = vec && active;
  const int p0 = tile_ptr[tile];
  const int p1 = tile_ptr[tile + 1];

  uint32_t acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0;

  for (int c0 = p0; c0 < p1; c0 += kChunk) {
    const int cn = min(kChunk, p1 - c0);
    __syncthreads();  // the previous chunk's tables are no longer read
    const uint32_t* src = tables + static_cast<size_t>(c0) * kWords;
    for (int e = threadIdx.x; e < cn * (kWords / 4); e += kThreads) {
      cp_async16(tab + 4 * e, src + 4 * e);
    }
    for (int e = threadIdx.x; e < cn; e += kThreads) rows[e] = pair_rows[c0 + e];
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;  // still joins the barriers of later chunks

    for (int b0 = 0; b0 < cn; b0 += kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b0 + b < cn) {  // uniform across the block
          v[b] = load_cols(data + static_cast<size_t>(rows[b0 + b]) * n + col0,
                           full, col0, n);
        }
      }
      // b0 is even: pair b0 + b has parity b, segment b0 / 2 + b / 2
      const uint32_t seg = static_cast<uint32_t>(b0) << 7;
      accumulate<0>(acc, tab, seg, v[0]);
      if (b0 + 1 < cn) accumulate<1>(acc, tab, seg, v[1]);
      if (b0 + 2 < cn) accumulate<0>(acc, tab, seg + 256, v[2]);
      if (b0 + 3 < cn) accumulate<1>(acc, tab, seg + 256, v[3]);
    }
  }

  if (!active) return;
  // 4x4 byte transposes: acc[4g + t] holds column 4g + t of the tile's 4
  // rows (slot i in byte i); o[i][g] holds columns 4g .. 4g + 3 of slot i
  uint32_t o[kRowTile][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t a0 = acc[4 * g], a1 = acc[4 * g + 1];
    const uint32_t a2 = acc[4 * g + 2], a3 = acc[4 * g + 3];
    const uint32_t t01 = __byte_perm(a0, a1, 0x5140);  // a0.0 a1.0 a0.1 a1.1
    const uint32_t t23 = __byte_perm(a2, a3, 0x5140);  // a2.0 a3.0 a2.1 a3.1
    const uint32_t u01 = __byte_perm(a0, a1, 0x7362);  // a0.2 a1.2 a0.3 a1.3
    const uint32_t u23 = __byte_perm(a2, a3, 0x7362);  // a2.2 a3.2 a2.3 a3.3
    o[0][g] = __byte_perm(t01, t23, 0x5410);
    o[1][g] = __byte_perm(t01, t23, 0x7632);
    o[2][g] = __byte_perm(u01, u23, 0x5410);
    o[3][g] = __byte_perm(u01, u23, 0x7632);
  }
  const int slots = min(kRowTile, r - tile * kRowTile);
#pragma unroll
  for (int i = 0; i < kRowTile; ++i) {
    if (i < slots) {  // uniform across the block
      uint8_t* dst =
          out + static_cast<size_t>(row_map[tile * kRowTile + i]) * n + col0;
      if (full) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (col0 + c < n) {
            dst[c] = static_cast<uint8_t>(o[i][c >> 2] >> (8 * (c & 3)));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int gf_matmul_launch(const int32_t* tile_ptr,
                                const int32_t* pair_rows,
                                const uint32_t* tables,
                                const int32_t* row_map, int tiles, int r,
                                const uint8_t* data, uint8_t* out,
                                long long n, cudaStream_t stream) {
  if (tiles <= 0 || r <= kRowTile * (tiles - 1) || r > kRowTile * tiles ||
      n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(tables) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const bool vec = n % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = static_cast<long long>(kThreads) * kCols;
  const long long blocks = (n + per_block - 1) / per_block * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  gf_matmul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      tile_ptr, pair_rows, tables, row_map, tiles, r, data, out, n, vec);
  return static_cast<int>(cudaGetLastError());
}
