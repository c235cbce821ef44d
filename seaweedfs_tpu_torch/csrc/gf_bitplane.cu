// gf_bitplane.cu — GF(2^8) matrix product in bit-plane form on Hopper's
// tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernels of tools/kernel_exp.py:
//   K6a  make_fn          (pallas_call at kernel_exp.py:44)  -> U = 1
//   K6b  make_fn_batched  (pallas_call at kernel_exp.py:97)  -> U = 2, 4
// Both are the bit-plane form of K1 (seaweedfs_tpu/ops/rs_pallas.py):
//
//   out (r, n) = coeffs (r, k) x data (k, n) over GF(2^8), polynomial 0x11D
//
// computed as a GF(2) product: the coefficients lifted to an (8r, 8k) 0/1
// matrix A, the payload unpacked to 8k 0/1 bit-planes B, Y = A B on the
// tensor cores, out bit = Y & 1, 8 bit-rows packed into each output byte.
// K6a switches the operand type; here one templated kernel serves all:
//
//   Op  = OpInt8  s8 x s8 -> s32     wmma m16n16k16
//         OpBf16  bf16 x bf16 -> f32 wmma m16n16k16
//         OpTf32  tf32 x tf32 -> f32 wmma m16n16k8
//   U   = number of column tiles stacked along the contraction (K6b): the
//         (U*8r, U*8k) lift is block-diagonal, tile j's planes sit at rows
//         j*8k of B, and output row block j goes to columns j*kBN.
//
// Exactness. The operands are 0 and 1, exact in every type; a row sum is
// at most U*8k <= 20480 < 2^24, exact in s32 and in f32. So every variant
// is byte-identical to the GF(2^8) product; no tolerance.
//
// Fused as the Pallas body is: a block reads its payload columns from
// device memory, unpacks them into shared memory, multiplies, takes & 1 and
// packs; neither the planes nor the s32/f32 products reach device memory.
//
// Bound. Operations: 2*(U*8r)*(U*8k)*(n/U) = U * 2*64*r*k*n, at the card's
// dense rate for the type (H100 SXM: 1,979 T int8, 989 T bf16, 495 T tf32).
// Bytes: (k + r)*n at 3.35 TB/s. For RS(10,4) at 8 MiB the bytes bind
// (0.035 ms); for the piggyback (128, 320) encode matrix the operations do
// (0.69 ms int8 at U = 1). K6b multiplies its zero blocks, as the MXU did,
// so U multiplies the operations.
//
// What the design does about the card:
// * Shared memory (227 KB) vs the TPU's VMEM. The Pallas kernel keeps the
//   whole lift in VMEM: 1024 x 2560 at (128,320) is 2.6 MB as int8. Here
//   output bit-rows tile over gridDim.y (kBM = 64 per block) and the
//   contraction walks in chunks of kBK = 64 inside the block, the
//   accumulators stay in registers (wmma fragments), and & 1 and the pack
//   run only after the last chunk. Shared memory per block: the A and B
//   chunk tiles, then the same bytes reused for the (kBM, kBN) s32/f32
//   epilogue: 33 KB for int8 and bf16, 48 KB for tf32 (dynamic, with the
//   attribute raised above 48 KB).
// * Row order vs packing. rs_pallas.fuse_bitmat orders rows plane-major
//   (row b*r+i is bit b of output byte i), so a 16-row tile would hold one
//   bit of 16 bytes and could not pack them. The host permutes the lift
//   once, when the device constant is built, to byte-major rows i*8+b and
//   byte-major columns j*8+l (ops/rs_bitplane.bitmat_from_reference): a
//   kBM-row tile then holds all 8 bits of kBM/8 whole output bytes, and the
//   8 bits of one input byte are 8 adjacent contraction rows.
// * Shared-memory layout. A and B are stored fragment-tiled: each 16 x KF
//   fragment tile is contiguous (ldm = KF), so every fragment pointer is a
//   multiple of 256 bytes (wmma wants 32) for every type. B is column-major
//   inside a tile: one column's bits along K lie contiguously, and the 8
//   bits of one payload byte are one 8-, 16- or 32-byte store.
// * Padding. The host pads M to kBM and K to 16 with zeros (8r = 8 for a
//   (1,k) row, 8k = 80 for RS(10,4)); B's rows past U*8k are written as
//   zeros, so zero rows and planes are exact in every type.
// * Ragged n and pointers. Payload bytes are read one at a time (adjacent
//   threads on adjacent columns) and output bytes written one at a time,
//   both masked at n, so any n >= 1 and any base pointer work.
// * Grid order. Columns are independent and each block owns its columns
//   and its rows outright: no reduction across blocks, so the order in
//   which CUDA runs them does not matter (the Pallas grid ran in order).
// * U = 2 turns RS(10,4)'s 8r = 32 into a 64-row tile, the M of one wgmma;
//   wgmma, TMA and warp specialisation are left for a later change.
//
// C interface (loaded with ctypes by ops/rs_bitplane.py):
//   int gf_bitplane_launch(int op, int u, const void* lift,
//                          const uint8_t* data, uint8_t* out, int r, int k,
//                          long long n, int mp, int kp, cudaStream_t stream);
// op: 0 int8, 1 bf16, 2 tf32. lift: (mp, kp) row-major in the operand type
// (int8, bf16 or f32), byte-major, zero-padded, mp % 64 == 0, kp % 16 == 0.
// data: (k, n) uint8 row-major; out: (r, n) uint8 row-major.
// Returns cudaGetLastError() after the launch (0 on success).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kBM = 64;        // output bit-rows per block (8 output bytes)
constexpr int kBN = 128;       // columns per block, per stacked tile
constexpr int kBK = 64;        // contraction rows per chunk (8 payload bytes)
constexpr int kLdc = kBN + 4;  // epilogue row stride, in 32-bit words

struct OpInt8 {
  using T = signed char;
  using Frag = signed char;
  using Acc = int;
  static constexpr int KF = 16;
  // bit l of v -> byte l of a 64-bit word (spread by shifts and masks)
  __device__ static void unpack8(uint32_t v, T* dst) {
    uint64_t x = v;
    x = (x | (x << 28)) & 0x0000000F0000000FULL;
    x = (x | (x << 14)) & 0x0003000300030003ULL;
    x = (x | (x << 7)) & 0x0101010101010101ULL;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(static_cast<uint32_t>(x), static_cast<uint32_t>(x >> 32));
  }
  __device__ static uint32_t bit(Acc v) { return static_cast<uint32_t>(v) & 1u; }
};

struct OpBf16 {
  using T = __nv_bfloat16;
  using Frag = __nv_bfloat16;
  using Acc = float;
  static constexpr int KF = 16;
  __device__ static void unpack8(uint32_t v, T* dst) {
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // 0x3F80 is bf16 1.0
      w[h] = (((v >> (2 * h)) & 1u) ? 0x00003F80u : 0u) |
             (((v >> (2 * h + 1)) & 1u) ? 0x3F800000u : 0u);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static uint32_t bit(Acc v) {
    return static_cast<uint32_t>(__float2int_rn(v)) & 1u;
  }
};

struct OpTf32 {
  using T = float;
  using Frag = wmma::precision::tf32;
  using Acc = float;
  static constexpr int KF = 8;
  __device__ static void unpack8(uint32_t v, T* dst) {
    uint32_t w[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) w[l] = ((v >> l) & 1u) ? 0x3F800000u : 0u;
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  __device__ static uint32_t bit(Acc v) {
    return static_cast<uint32_t>(__float2int_rn(v)) & 1u;
  }
};

// Offset of element (m, kk) of the A chunk: fragment tiles of 16 x KF,
// row-major inside the tile.
template <int KF>
__device__ __forceinline__ int tile_a(int m, int kk) {
  return ((m / 16) * (kBK / KF) + kk / KF) * (16 * KF) + (m % 16) * KF +
         kk % KF;
}

// Offset of element (kk, col) of the B chunk: fragment tiles of KF x 16,
// column-major inside the tile.
template <int KF>
__device__ __forceinline__ int tile_b(int kk, int col) {
  return ((col / 16) * (kBK / KF) + kk / KF) * (16 * KF) + (col % 16) * KF +
         kk % KF;
}

template <class Op>
constexpr size_t smem_bytes() {
  return std::max(static_cast<size_t>(kBM + kBN) * kBK * sizeof(typename Op::T),
                  static_cast<size_t>(kBM) * kLdc * sizeof(typename Op::Acc));
}

template <class Op, int U>
__global__ void __launch_bounds__(kThreads)
gf_bitplane_kernel(const typename Op::T* __restrict__ lift,
                   const uint8_t* __restrict__ data,
                   uint8_t* __restrict__ out, int r, int k, long long n,
                   int kp) {
  using T = typename Op::T;
  using Acc = typename Op::Acc;
  constexpr int KF = Op::KF;
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector

  extern __shared__ __align__(128) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);           // A chunk, kBM x kBK
  T* sb = sa + kBM * kBK;                       // B chunk, kBK x kBN
  Acc* sc = reinterpret_cast<Acc*>(smem);       // epilogue, same bytes

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 32 rows
  const int wn = warp >> 1;  // 32 columns
  const int m0 = blockIdx.y * kBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * (U * kBN);
  const int kbytes = U * k;  // payload bytes per stacked column

  wmma::fragment<wmma::accumulator, 16, 16, KF, Acc> acc[2][2];
#pragma unroll
  for (int fm = 0; fm < 2; ++fm) {
#pragma unroll
    for (int fn = 0; fn < 2; ++fn) wmma::fill_fragment(acc[fm][fn], Acc(0));
  }

  for (int k0 = 0; k0 < kp; k0 += kBK) {
    const int kc = min(kBK, kp - k0);  // a multiple of 16
    __syncthreads();  // the previous chunk is no longer read
    // A chunk: 16-byte vectors from the padded row-major constant
    for (int e = tid; e < kBM * kc / VE; e += kThreads) {
      const int m = (e * VE) / kc;
      const int kk = (e * VE) % kc;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          lift + static_cast<size_t>(m0 + m) * kp + k0 + kk));
      *reinterpret_cast<uint4*>(sa + tile_a<KF>(m, kk)) = v;
    }
    // B chunk: payload byte q of each column -> its 8 bit-plane rows
    for (int e = tid; e < kBN * (kc / 8); e += kThreads) {
      const int c = e % kBN;
      const int q = e / kBN;
      const int g = (k0 >> 3) + q;  // stacked payload byte: j*k + jb
      uint32_t v = 0;
      if (g < kbytes) {
        const int j = g / k;
        const int jb = g - j * k;
        const long long col = col0 + static_cast<long long>(j) * kBN + c;
        if (col < n) v = __ldg(data + static_cast<size_t>(jb) * n + col);
      }
      Op::unpack8(v, sb + tile_b<KF>(q * 8, c));
    }
    __syncthreads();

    for (int kt = 0; kt < kc / KF; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, KF, typename Op::Frag,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, KF, typename Op::Frag,
                     wmma::col_major> b[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::load_matrix_sync(a[f], sa + tile_a<KF>(wm * 32 + f * 16, kt * KF),
                               KF);
        wmma::load_matrix_sync(b[f], sb + tile_b<KF>(kt * KF, wn * 32 + f * 16),
                               KF);
        if constexpr (std::is_same<typename Op::Frag,
                                   wmma::precision::tf32>::value) {
          for (int t = 0; t < a[f].num_elements; ++t)
            a[f].x[t] = wmma::__float_to_tf32(a[f].x[t]);
          for (int t = 0; t < b[f].num_elements; ++t)
            b[f].x[t] = wmma::__float_to_tf32(b[f].x[t]);
        }
      }
#pragma unroll
      for (int fm = 0; fm < 2; ++fm) {
#pragma unroll
        for (int fn = 0; fn < 2; ++fn)
          wmma::mma_sync(acc[fm][fn], a[fm], b[fn], acc[fm][fn]);
      }
    }
  }

  __syncthreads();  // every warp is done with sa/sb before sc reuses them
#pragma unroll
  for (int fm = 0; fm < 2; ++fm) {
#pragma unroll
    for (int fn = 0; fn < 2; ++fn) {
      wmma::store_matrix_sync(sc + (wm * 32 + fm * 16) * kLdc + wn * 32 + fn * 16,
                              acc[fm][fn], kLdc, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // & 1 and pack: bit-rows ib*8 .. ib*8+7 of the tile are output byte ib
  for (int e = tid; e < (kBM / 8) * kBN; e += kThreads) {
    const int c = e % kBN;
    const int ib = e / kBN;
    const int rr = m0 / 8 + ib;  // stacked output byte row: j*r + i
    if (rr >= U * r) continue;
    const int j = rr / r;
    const int i = rr - j * r;
    const long long col = col0 + static_cast<long long>(j) * kBN + c;
    if (col >= n) continue;
    uint32_t byte = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) byte |= Op::bit(sc[(ib * 8 + b) * kLdc + c]) << b;
    out[static_cast<size_t>(i) * n + col] = static_cast<uint8_t>(byte);
  }
}

template <class Op, int U>
int launch(const void* lift, const uint8_t* data, uint8_t* out, int r, int k,
           long long n, int mp, int kp, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Op>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_bitplane_kernel<Op, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per_block = static_cast<long long>(U) * kBN;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>(mp / kBM));
  gf_bitplane_kernel<Op, U><<<grid, kThreads, smem, stream>>>(
      static_cast<const typename Op::T*>(lift), data, out, r, k, n, kp);
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int launch_u(int u, const void* lift, const uint8_t* data, uint8_t* out,
             int r, int k, long long n, int mp, int kp, cudaStream_t stream) {
  switch (u) {
    case 1: return launch<Op, 1>(lift, data, out, r, k, n, mp, kp, stream);
    case 2: return launch<Op, 2>(lift, data, out, r, k, n, mp, kp, stream);
    case 4: return launch<Op, 4>(lift, data, out, r, k, n, mp, kp, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gf_bitplane_launch(int op, int u, const void* lift,
                                  const uint8_t* data, uint8_t* out, int r,
                                  int k, long long n, int mp, int kp,
                                  cudaStream_t stream) {
  if (r <= 0 || k <= 0 || n <= 0 || mp % kBM != 0 || kp % 16 != 0 ||
      mp < 8 * u * r || kp < 8 * u * k || mp / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (op) {
    case 0: return launch_u<OpInt8>(u, lift, data, out, r, k, n, mp, kp, stream);
    case 1: return launch_u<OpBf16>(u, lift, data, out, r, k, n, mp, kp, stream);
    case 2: return launch_u<OpTf32>(u, lift, data, out, r, k, n, mp, kp, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
