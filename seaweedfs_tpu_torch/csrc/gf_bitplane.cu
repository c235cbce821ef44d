// gf_bitplane.cu — GF(2^8) matrix product in bit-plane form on Hopper's
// warpgroup tensor cores (sm_90a: wgmma, TMA, mbarrier).
//
// Replaces the Pallas TPU kernels of tools/kernel_exp.py:
//   K6a  make_fn          (pallas_call at kernel_exp.py:44)  -> u = 1
//   K6b  make_fn_batched  (pallas_call at kernel_exp.py:97)  -> u = 2, 4
// Both are the bit-plane form of K1 (seaweedfs_tpu/ops/rs_pallas.py):
//
//   out (r, n) = coeffs (r, k) x data (k, n) over GF(2^8), polynomial 0x11D
//
// computed as a GF(2) product: the coefficients lifted to an (8r, 8k) 0/1
// matrix, the payload unpacked to 8k 0/1 bit-planes, the product on the
// tensor cores, out bit = sum & 1, 8 bit-rows packed into each output byte.
// K6a picks the operand type, K6b stacks u column tiles along the
// contraction against a block-diagonal (u*8r, u*8k) lift. One templated
// kernel serves them all:
//
//   Op = OpInt8  s8 x s8 -> s32     wgmma m64nNk32
//        OpBf16  bf16 x bf16 -> f32 wgmma m64nNk16
//        OpTf32  tf32 x tf32 -> f32 wgmma m64nNk8
//   NT = the wgmma N, output bit-rows per lift tile: 32 when one block's
//        8r fits (RS(10,4): 8r = 32, no padding), else 256. A tile is
//        32 contraction rows deep under NT = 32 and 64 under NT = 256.
//
// Exactness. The operands are 0 and 1, exact in every type; a sum is at
// most u*8k <= 20480 < 2^24, exact in s32 and in f32, and a lift tile that
// is all zero adds nothing. So every variant is byte-identical to the
// GF(2^8) product; no tolerance.
//
// Bounds (H100 SXM). The function's own: (k + r)*n bytes at 3.35 TB/s
// (0.035 ms for RS(10,4) at 8 MiB and for the piggyback (128, 320)
// encode matrix at 262,144 columns), or one multiply-add per one of the
// lift per column at the type's peak where that takes longer (tf32 only).
// The TPU kernel multiplies the dense lift, u * 2*8r*8k*n (0.69 ms int8
// at (128, 320)); this kernel multiplies the lift tiles that hold a one,
// zeros inside them included, 2*NT*depth*(n/u) per tile kept (the tile
// bound, 0.21 ms int8 there: 30% of the emat's tiles). What binds it on
// the card (tools/bitplane_parts.py, which compiles parts out; PERF.md
// has the numbers): at (4, 10) the 32-wide wgmmas, about 55-75% of the
// time, so the walk spends none on padding (32-deep tiles) and keeps
// three or four blocks per SM; at (128, 320) the walk without its wgmmas
// (the lift tiles streamed again for every 128 columns, unpack, pack,
// barriers) for int8 and tf32, and the wgmmas and the walk about equally
// for bf16.
//
// Design (what each part does about the card):
// * The product is transposed: D^T (columns x bit-rows) = planes^T
//   (columns x 8k) x lift^T (8k x bit-rows). Payload columns are the wgmma
//   M (64 per consumer warpgroup, 128 per block), output bit-rows its N,
//   so 8r = 32 needs no padding to a 64-row tile and the lift, K-contiguous
//   in its rows, is the K-major B operand that s8 and tf32 require.
// * A comes from registers. A 64-deep chunk is 8 payload bytes of each
//   column (32-deep: 4); the block lands them raw in shared memory (1 KB
//   for 128 columns) and each consumer thread builds its A fragments from
//   4 (2) of them with shifts, masks and multiplies (a bit becomes 0x01,
//   0x3F80 or 0x3F800000). The planes are never written to shared or
//   device memory; each payload byte is unpacked once per N tile. The host
//   permutes the lift's contraction order (ops/rs_bitplane.k_order) so that
//   the k slots a thread holds in the fragment are whole nibbles (s8),
//   nibble halves (bf16) or bit pairs (tf32) of the bytes it loaded.
// * Pack without shuffles. The accumulator fragment gives each thread 2
//   adjacent N columns of every 8; the host orders the lift's rows
//   (n_order) so that a thread's 8 values of each 32 N columns are the 8
//   bits of one output byte. & 1 and the pack are shifts and ORs in
//   registers; bytes are staged in shared memory and written as 16-byte
//   vectors, one contiguous run per output row.
// * Only non-zero lift tiles are multiplied. The host (once per lift,
//   cached) sorts output bytes by their non-zero pattern over the
//   contraction chunks, cuts the lift into tiles and keeps the tiles that
//   hold a one, compacted in the order the kernel walks them, with each
//   tile's chunk and each N tile's range of tiles. K6b's off-diagonal
//   blocks are never kept, so u = 2 and u = 4 do the work of u = 1 and the
//   84 MB u=4 bf16 dense lift never exists on the device. (A step inside a
//   kept tile is never skipped: a branch around a wgmma makes ptxas
//   serialize every wgmma of the kernel.)
// * Warp specialisation. One producer warp streams the lift tiles with
//   cp.async.bulk.tensor (TMA, 32B, 64B or 128B swizzle: the layout the
//   wgmma descriptor reads) and the payload boxes (TMA when the base is
//   16-byte aligned and n % 16 == 0; zero-filled past k and n) into a
//   ring of stages guarded by full/empty mbarriers. Two consumer
//   warpgroups share each lift tile, halving its L2 traffic. When every
//   kept tile fits in shared memory (RS(10,4): 3 tiles of 1-4 KB) the
//   tiles are loaded once per block and stay; a stage then holds a whole
//   column tile's payload, one barrier round per column tile. Blocks are
//   persistent: each walks column tiles with a stride of the grid, so the
//   ring runs on across tiles and the next tile's loads overlap the
//   epilogue. With NT = 256 the consumers take 232 registers (setmaxnreg)
//   for the 128 s32/f32 accumulators; with NT = 32 the producer is one
//   warp, and three or four blocks share an SM.
// * Ragged widths and misaligned bases: the producer loads masked bytes
//   when TMA cannot read the payload (same kernel, same ring), and output
//   vectors past n or off 16-byte alignment are written byte by byte.
//
// C interface (loaded with ctypes by ops/rs_bitplane.py):
//   int gf_bitplane_launch(int op, int nt, const void* tiles, int stored,
//                          const int* tile_chunk, const int* ntile_ptr,
//                          const int* row_map, int n_tiles, int r, int k,
//                          int u, const uint8_t* data, uint8_t* out,
//                          long long n, cudaStream_t stream);
// op: 0 int8, 1 bf16, 2 tf32. tiles: (stored * nt, depth) row-major in the
// operand type (int8, bf16 or f32), depth 32 for nt = 32 and 64 for 256:
// the kept tiles (or one zero tile when none is kept), each tile's rows
// in n_order and its columns in k_order; tile_chunk[t]: contraction chunk
// of kept tile t (with c = ceil(8k / depth) chunks per stacked tile: block
// chunk / c, payload rows depth/8 * (chunk % c) onward); ntile_ptr:
// (n_tiles + 1) ranges of kept tiles per N tile; row_map: (n_tiles * nt /
// 8) stacked output byte j*r + i of each N slot, or -1.
// data: (k, n) uint8 row-major; out: (r, n) uint8 row-major.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
//
// GF_BP_SKIP (default 0) compiles parts of the work out, for
// tools/bitplane_parts.py, which times what each part costs; a library
// built with it computes wrong bytes and the port never loads one. Bit 0:
// the wgmmas (the A fragments are still built, the accumulators still
// packed); bit 1: the output stores to device memory; bit 2: the payload
// loads (the lift tiles still arrive by TMA).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>

#ifndef GF_BP_SKIP
#define GF_BP_SKIP 0
#endif

namespace {

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kTile = 64 * kConsumers;             // columns per block step
constexpr bool kSkipMma = GF_BP_SKIP & 1;
constexpr bool kSkipStore = GF_BP_SKIP & 2;
constexpr bool kSkipLoad = GF_BP_SKIP & 4;

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major B tile: start address,
// leading offset 1 (unused when swizzled), stride between 8-row groups,
// swizzle mode (1: 128B, 2: 64B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// One wgmma with A from registers: D (64 x N) += A (64 x K) x B (K x N),
// B from the descriptor. Operands: D, then A's 4 registers, the
// descriptor, and the scale-d flag (1: accumulate into D).
#define WG_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"
#define WG_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"
#define WG_D4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define WG_D16(C, i) \
  WG_D4(C, i), WG_D4(C, i + 4), WG_D4(C, i + 8), WG_D4(C, i + 12)
#define WG_D128(C)                                                   \
  WG_D16(C, 0), WG_D16(C, 16), WG_D16(C, 32), WG_D16(C, 48),         \
      WG_D16(C, 64), WG_D16(C, 80), WG_D16(C, 96), WG_D16(C, 112)
#define WG_MMA16(INSTR, TAIL, C)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" INSTR " "   \
               WG_REGS16 ", {%16, %17, %18, %19}, %20, p" TAIL ";\n}\n" \
               : WG_D16(C, 0)                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), \
                 "r"(1))
#define WG_MMA128(INSTR, TAIL, C)                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" INSTR " "     \
               WG_REGS128 ", {%128, %129, %130, %131}, %132, p" TAIL     \
               ";\n}\n"                                                    \
               : WG_D128(C)                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),    \
                 "r"(1))

// ---- operand types ------------------------------------------------------------
//
// Each op: element bytes, wgmma steps per 64 contraction rows, how a
// step's A fragment is built, and the wgmma itself. A step uses payload
// byte 4*h + tq (h = step / (kSteps/2): the first or second 32 rows) of
// the thread's two columns: x for row g, y for row g + 8; `sub` = step %
// (kSteps/2) picks its bits.

struct OpInt8 {
  using Acc = uint32_t;
  static constexpr int kBytes = 1, kSteps = 2;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // k slots 4tq..4tq+3 (reg 0, 1) hold the low nibble's bits, 16+4tq..
  // (reg 2, 3) the high nibble's: bit e lands in byte e of the register.
  __device__ static uint32_t spread4(uint32_t nib) {
    return (nib * 0x00204081u) & 0x01010101u;
  }
  __device__ static void frag(int, uint32_t x, uint32_t y, uint32_t (&a)[4]) {
    a[0] = spread4(x & 15u);
    a[1] = spread4(y & 15u);
    a[2] = spread4(x >> 4);
    a[3] = spread4(y >> 4);
  }
  template <int NT>
  __device__ static void mma(Acc (&d)[NT / 2], const uint32_t (&a)[4],
                             uint64_t desc) {
    if constexpr (NT == 32) {
      WG_MMA16("wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8", "", "+r");
    } else {
      WG_MMA128("wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8", "",
                "+r");
    }
  }
  __device__ static uint32_t bit(Acc v) { return v & 1u; }
};

struct OpBf16 {
  using Acc = float;
  static constexpr int kBytes = 2, kSteps = 4;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // two bits -> two bf16 (0x3F80 is 1.0), the lower k slot in the low half
  __device__ static uint32_t pair(uint32_t v) {
    return ((v & 1u) | ((v & 2u) << 15)) * 0x3F80u;
  }
  // step sub uses nibble sub: k slots 2tq, 2tq+1 (reg 0, 1) its bits 0-1,
  // 8+2tq, 9+2tq (reg 2, 3) its bits 2-3
  __device__ static void frag(int sub, uint32_t x, uint32_t y,
                              uint32_t (&a)[4]) {
    const int h = 4 * sub;
    a[0] = pair(x >> h);
    a[1] = pair(y >> h);
    a[2] = pair(x >> (h + 2));
    a[3] = pair(y >> (h + 2));
  }
  template <int NT>
  __device__ static void mma(Acc (&d)[NT / 2], const uint32_t (&a)[4],
                             uint64_t desc) {
    if constexpr (NT == 32) {
      WG_MMA16("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16",
               ", 1, 1, 0", "+f");
    } else {
      WG_MMA128("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                ", 1, 1, 0", "+f");
    }
  }
  __device__ static uint32_t bit(Acc v) {
    return static_cast<uint32_t>(__float2int_rz(v)) & 1u;
  }
};

struct OpTf32 {
  using Acc = float;
  static constexpr int kBytes = 4, kSteps = 8;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // step sub uses bits 2sub (k slot tq, reg 0, 1) and 2sub+1 (tq+4, reg 2, 3)
  __device__ static void frag(int sub, uint32_t x, uint32_t y,
                              uint32_t (&a)[4]) {
    const int l = 2 * sub;
    a[0] = ((x >> l) & 1u) * 0x3F800000u;
    a[1] = ((y >> l) & 1u) * 0x3F800000u;
    a[2] = ((x >> (l + 1)) & 1u) * 0x3F800000u;
    a[3] = ((y >> (l + 1)) & 1u) * 0x3F800000u;
  }
  template <int NT>
  __device__ static void mma(Acc (&d)[NT / 2], const uint32_t (&a)[4],
                             uint64_t desc) {
    if constexpr (NT == 32) {
      WG_MMA16("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32",
               ", 1, 1", "+f");
    } else {
      WG_MMA128("wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32",
                ", 1, 1", "+f");
    }
  }
  __device__ static uint32_t bit(Acc v) {
    return static_cast<uint32_t>(__float2int_rz(v)) & 1u;
  }
};

// ---- lift tiles and shared memory ---------------------------------------------

// A lift tile: NT output bit-rows by kKc contraction rows (kKc / 8
// payload bytes), K-contiguous rows of kRowBytes. TMA writes each row
// group swizzled over a span of 32, 64 or 128 bytes (256-byte tf32 rows
// are two 128-byte boxes, one after the other), which is the layout the
// wgmma descriptor names (mode 3, 2 or 1; 8 rows of the span apart).
template <class Op, int NT>
struct Tile {
  static constexpr int kKc = NT == 32 ? 32 : 64;
  static constexpr int kSteps = Op::kSteps * kKc / 64;
  static constexpr int kRowBytes = kKc * Op::kBytes;
  static constexpr int kSpan = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kSpan;
  static constexpr int kBytes = NT * kRowBytes;  // a multiple of 1024
  static constexpr int kPayRows = kKc / 8;       // payload rows per chunk
  static constexpr uint32_t kLayout = kSpan == 128 ? 1 : (kSpan == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : CU_TENSOR_MAP_SWIZZLE_32B);
  // step s reads the 32 bytes of K at 32s of every row
  __device__ static uint64_t desc(uint32_t tile, int s) {
    const int off = 32 * s;
    return gmma_desc(tile + (off / kSpan) * (NT * kSpan) + off % kSpan,
                     8 * kSpan, kLayout);
  }
};

// The block's shared memory, from a 1024-byte aligned base (128B swizzle
// needs it): the lift region, the payload ring, the consumers' output
// staging, then the barriers. Streamed: one lift tile and one chunk's
// payload box (kPayRows rows x 128 columns) per stage. Resident (every
// kept tile fits): every kept tile once, and per stage a whole column
// tile's payload (u boxes of all its chunks' rows). NT = 256 runs one
// block per SM, NT = 32 three or four.
template <class Op, int NT>
struct Smem {
  // the consumers, then the producer: its whole warpgroup under NT = 256
  // (setmaxnreg moves registers between warpgroups), one warp under 32
  static constexpr int kThreads = 128 * kConsumers + (NT == 32 ? 32 : 128);
  // NT = 32: four blocks per SM (56 registers a thread); tf32's steps hold
  // twice the A registers, and at 56 ptxas serializes its wgmmas, so three
  static constexpr int kBlocksPerSm =
      NT == 32 ? (Op::kSteps == 8 ? 3 : 4) : 1;
  static constexpr int kBudget =
      NT == 32 ? 216 * 1024 / kBlocksPerSm : 210 * 1024;
  static constexpr int kOut = kConsumers * (NT / 8) * 64;
  static constexpr int kMaxStages = 16;
};

struct Params {
  const int* tile_chunk;
  const int* ntile_ptr;
  const int* row_map;
  const uint8_t* data;
  uint8_t* out;
  long long n;
  int r, k, u, n_tiles, chunks_per_block, col_tiles;
  int stored;       // tiles in the lift tensor
  int resident;     // every kept tile stays in shared memory
  int stages;       // ring depth
  int pay_stage;    // payload bytes per stage
  int tma_payload;  // payload boxes by TMA (else masked loads)
  int vec_out;      // output rows 16-byte aligned
};

// Masked payload load by one warp: rows row0 .. row0 + rows - 1 (zero past
// k) of columns col0 .. col0 + 127 (zero past n) into dst, 128 bytes a
// row, 32 bytes a lane; then each lane arrives on `bar`.
__device__ __forceinline__ void load_rows(uint8_t* dst, const Params& p,
                                          int row0, int rows, long long col0,
                                          int lane) {
  const int c0 = (lane & 3) * 32;
  for (int q = lane >> 2; q < rows; q += 8) {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0;
    if (row0 + q < p.k) {
      const uint8_t* src = p.data + static_cast<long long>(row0 + q) * p.n;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long col = col0 + c0 + i;
        if (col < p.n) w[i / 4] |= static_cast<uint32_t>(src[col]) << (8 * (i % 4));
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + q * kTile + c0);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// ---- the kernel ---------------------------------------------------------------

template <class Op, int NT>
__global__ void __launch_bounds__(Smem<Op, NT>::kThreads,
                                  Smem<Op, NT>::kBlocksPerSm)
    gf_bitplane_kernel(const __grid_constant__ CUtensorMap lift_map,
                       const __grid_constant__ CUtensorMap data_map,
                       const Params p) {
  using S = Smem<Op, NT>;
  using T = Tile<Op, NT>;
  using Acc = typename Op::Acc;
  constexpr int kSlots = NT / 8;  // output bytes per column per N tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t lift_base = base;
  const uint32_t pay_base =
      lift_base + (p.resident ? p.stored : p.stages) * T::kBytes;
  const uint32_t out_base = pay_base + p.stages * p.pay_stage;
  const uint32_t bars = out_base + S::kOut;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (p.stages + s); };
  const uint32_t lift_bar = bars + 16u * p.stages;
  const int cpb = p.chunks_per_block;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), p.tma_payload ? 1 : 32);
      mbar_init(empty(s), 4 * kConsumers);  // lane 0 of each consumer warp
    }
    mbar_init(lift_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp streams lift tiles and payload boxes --------
    if constexpr (NT > 32) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    }
    if (tid % 128 >= 32) return;
    if (p.resident && lane == 0) {  // every kept tile, once
      mbar_arrive_tx(lift_bar, p.stored * T::kBytes);
      for (int e = 0; e < p.stored; ++e) {
#pragma unroll
        for (int b = 0; b < T::kBoxes; ++b) {
          tma_load(lift_base + e * T::kBytes + b * (NT * T::kSpan), &lift_map,
                   b * T::kSpan / Op::kBytes, e * NT, lift_bar);
        }
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    // one stage: wait for it to be free, fill it, arrive on its barrier
    auto fill = [&](auto&& load_lift, int row0, int rows, int boxes,
                    long long col0) {
      mbar_wait(empty(stage), phase ^ 1u);
      const uint32_t pay = pay_base + stage * p.pay_stage;
      const bool tma_pay = p.tma_payload && !kSkipLoad;
      if (!p.tma_payload) {
        for (int b = 0; b < boxes && !kSkipLoad; ++b) {
          load_rows(gbase + (pay - base) + b * rows * kTile, p, row0, rows,
                    col0 + static_cast<long long>(b) * kTile, lane);
        }
        if (lane != 0) mbar_arrive(full(stage));
      }
      if (lane == 0) {
        const uint32_t tx = (p.resident ? 0 : T::kBytes) +
                            (tma_pay ? boxes * rows * kTile : 0);
        if (tx) {
          mbar_arrive_tx(full(stage), tx);
        } else {
          mbar_arrive(full(stage));
        }
        load_lift(full(stage));
        if (tma_pay) {
          for (int b = 0; b < boxes; ++b) {
            tma_load(pay + b * rows * kTile, &data_map,
                     static_cast<int>(col0 + static_cast<long long>(b) * kTile),
                     row0, full(stage));
          }
        }
      }
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1u;
      }
    };
    for (int ct = blockIdx.x; ct < p.col_tiles; ct += gridDim.x) {
      const long long col_base = static_cast<long long>(ct) * p.u * kTile;
      if (p.resident) {  // the column tile's whole payload, u boxes
        fill([](uint32_t) {}, 0, T::kPayRows * cpb, p.u, col_base);
        continue;
      }
      for (int t = 0; t < p.n_tiles; ++t) {
        const int e1 = __ldg(p.ntile_ptr + t + 1);
        for (int e = __ldg(p.ntile_ptr + t); e < e1; ++e) {
          const int chunk = __ldg(p.tile_chunk + e);
          const int blk = chunk / cpb;
          const uint32_t lift = lift_base + stage * T::kBytes;
          fill(
              [&](uint32_t bar) {
#pragma unroll
                for (int b = 0; b < T::kBoxes; ++b) {
                  tma_load(lift + b * (NT * T::kSpan), &lift_map,
                           b * T::kSpan / Op::kBytes, e * NT, bar);
                }
              },
              (chunk - blk * cpb) * T::kPayRows, T::kPayRows, 1,
              col_base + static_cast<long long>(blk) * kTile);
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups of 64 columns each ------------------------
  if constexpr (NT > 32) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  }
  const int warp = (tid % 128) / 32;
  const int g = lane >> 2, tq = lane & 3;
  const int mcol = wg * 64 + warp * 16 + g;  // this thread's first column
  uint8_t* const out_stage = gbase + (out_base - base) + wg * (kSlots * 64);
  int stage = 0;
  uint32_t phase = 0;
  auto release = [&]() {  // the stage's smem is read; hand it back
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1u;
    }
  };
  if (p.resident) mbar_wait(lift_bar, 0);
  for (int ct = blockIdx.x; ct < p.col_tiles; ct += gridDim.x) {
    const long long col_base = static_cast<long long>(ct) * p.u * kTile;
    if (p.resident) mbar_wait(full(stage), phase);
    for (int t = 0; t < p.n_tiles; ++t) {
      Acc acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = Acc(0);
      const int e1 = __ldg(p.ntile_ptr + t + 1);
      for (int e = __ldg(p.ntile_ptr + t); e < e1; ++e) {
        uint32_t lift;
        const uint8_t* pay;
        if (p.resident) {
          const int chunk = __ldg(p.tile_chunk + e);
          const int blk = chunk / cpb;
          lift = lift_base + e * T::kBytes;
          // box blk, rows kPayRows * (chunk % cpb) onward
          pay = gbase + (pay_base - base) + stage * p.pay_stage +
                (blk * cpb + (chunk - blk * cpb)) * T::kPayRows * kTile;
        } else {
          mbar_wait(full(stage), phase);
          lift = lift_base + stage * T::kBytes;
          pay = gbase + (pay_base - base) + stage * p.pay_stage;
        }
        __syncwarp();  // converged for the .sync.aligned wgmma
        const uint32_t x0 = pay[tq * kTile + mcol];
        const uint32_t y0 = pay[tq * kTile + mcol + 8];
        uint32_t x1 = 0, y1 = 0;
        if constexpr (T::kKc == 64) {
          x1 = pay[(4 + tq) * kTile + mcol];
          y1 = pay[(4 + tq) * kTile + mcol + 8];
        }
        uint32_t a[T::kSteps][4];
#pragma unroll
        for (int s = 0; s < T::kSteps; ++s) {
          constexpr int kHalf = Op::kSteps / 2;
          Op::frag(s % kHalf, s < kHalf ? x0 : x1, s < kHalf ? y0 : y1, a[s]);
        }
        if constexpr (kSkipMma) {
#pragma unroll
          for (int s = 0; s < T::kSteps; ++s) {  // the fragments stay live
            asm volatile("" ::"r"(a[s][0]), "r"(a[s][1]), "r"(a[s][2]),
                         "r"(a[s][3]), "r"(lift));
          }
        } else {
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < T::kSteps; ++s) {
            Op::template mma<NT>(acc, a[s], T::desc(lift, s));
          }
          wgmma_commit();
          wgmma_wait_all();
        }
        if (!p.resident) release();
      }
      if constexpr (kSkipMma) {  // the pack still reads unknown values
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) {
          if constexpr (std::is_same_v<Acc, float>) {
            asm volatile("" : "+f"(acc[i]));
          } else {
            asm volatile("" : "+r"(acc[i]));
          }
        }
      }

      // & 1 and pack: value 4*(4B + a) + 2*v1 + v0 is bit 2a + v0 of slot
      // 4B + tq, at column mcol + 8*v1
#pragma unroll
      for (int b4 = 0; b4 < NT / 32; ++b4) {
#pragma unroll
        for (int v1 = 0; v1 < 2; ++v1) {
          uint32_t byte = 0;
#pragma unroll
          for (int a2 = 0; a2 < 4; ++a2) {
#pragma unroll
            for (int v0 = 0; v0 < 2; ++v0) {
              byte |= Op::bit(acc[4 * (4 * b4 + a2) + 2 * v1 + v0])
                      << (2 * a2 + v0);
            }
          }
          out_stage[(4 * b4 + tq) * 64 + (mcol - wg * 64) + 8 * v1] =
              static_cast<uint8_t>(byte);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      // each slot's 64 bytes go to one output row as 4 vectors of 16
      for (int v = kSkipStore ? kSlots * 4 : tid % 128; v < kSlots * 4;
           v += 128) {
        const int slot = v / 4;
        const int rr = __ldg(p.row_map + t * kSlots + slot);
        if (rr >= 0) {
          const int j = rr / p.r;
          const int i = rr - j * p.r;
          const long long col = col_base + static_cast<long long>(j) * kTile +
                                wg * 64 + (v % 4) * 16;
          const uint8_t* src = out_stage + slot * 64 + (v % 4) * 16;
          uint8_t* dst = p.out + static_cast<long long>(i) * p.n + col;
          if (p.vec_out && col + 16 <= p.n) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          } else {
            for (int c = 0; c < 16 && col + c < p.n; ++c) dst[c] = src[c];
          }
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    if (p.resident) release();
  }
}

// ---- host side ----------------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      ptr = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) != cudaSuccess)
      ptr = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr)
               : nullptr;
  }();
  return fn;
}

bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               uint64_t dim0, uint64_t dim1, uint64_t stride_bytes,
               uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Op, int NT>
int launch(const void* tiles, Params p, cudaStream_t stream) {
  using S = Smem<Op, NT>;
  using T = Tile<Op, NT>;
  auto kernel = gf_bitplane_kernel<Op, NT>;
  constexpr int kMaxBytes = S::kBudget + 2048;  // + alignment and barriers
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  p.chunks_per_block = (8 * p.k + T::kKc - 1) / T::kKc;
  // resident when every kept tile and two stages of whole column tiles
  // fit (and a column tile's rows fit one TMA box); else streamed
  const int room = S::kBudget - S::kOut;
  const int rows = T::kPayRows * p.chunks_per_block;
  const int pay_res = p.u * rows * kTile;
  const long long lift_res = static_cast<long long>(p.stored) * T::kBytes;
  p.resident = rows <= 256 && lift_res + 2ll * pay_res <= room;
  if (p.resident) {
    p.pay_stage = pay_res;
    p.stages = std::min<long long>(S::kMaxStages, (room - lift_res) / pay_res);
  } else {
    p.pay_stage = T::kPayRows * kTile;
    p.stages = std::max(2, std::min(S::kMaxStages,
                                    room / (T::kBytes + p.pay_stage)));
  }
  const int bytes = 1024 + (p.resident ? static_cast<int>(lift_res)
                                       : p.stages * T::kBytes) +
                    p.stages * p.pay_stage + S::kOut + (2 * p.stages + 1) * 8;

  CUtensorMap lift_map, data_map;
  std::memset(&data_map, 0, sizeof(data_map));
  if (!encode_2d(&lift_map, Op::kType, tiles, T::kKc,
                 static_cast<uint64_t>(p.stored) * NT, T::kRowBytes,
                 T::kSpan / Op::kBytes, NT, T::kSwizzle)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.tma_payload &&
      !encode_2d(&data_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.data,
                 static_cast<uint64_t>(p.n), p.k, static_cast<uint64_t>(p.n),
                 kTile, p.resident ? rows : T::kPayRows,
                 CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::kThreads,
                                                bytes);
  const int blocks = static_cast<int>(
      std::min<long long>(p.col_tiles, static_cast<long long>(sms) *
                                           (per_sm > 0 ? per_sm : 1)));
  kernel<<<blocks, S::kThreads, bytes, stream>>>(lift_map, data_map, p);
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int launch_nt(int nt, const void* tiles, const Params& p,
              cudaStream_t stream) {
  switch (nt) {
    case 32: return launch<Op, 32>(tiles, p, stream);
    case 256: return launch<Op, 256>(tiles, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gf_bitplane_launch(int op, int nt, const void* tiles, int stored,
                                  const int* tile_chunk, const int* ntile_ptr,
                                  const int* row_map, int n_tiles, int r,
                                  int k, int u, const uint8_t* data,
                                  uint8_t* out, long long n,
                                  cudaStream_t stream) {
  if (r <= 0 || k <= 0 || n <= 0 || u <= 0 || stored <= 0 || n_tiles <= 0 ||
      static_cast<long long>(n_tiles) * (nt / 8) < static_cast<long long>(u) * r ||
      static_cast<long long>(stored) * nt > (1ll << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.tile_chunk = tile_chunk;
  p.ntile_ptr = ntile_ptr;
  p.row_map = row_map;
  p.data = data;
  p.out = out;
  p.n = n;
  p.r = r;
  p.k = k;
  p.u = u;
  p.n_tiles = n_tiles;
  p.stored = stored;
  const long long per_tile = static_cast<long long>(u) * kTile;
  const long long col_tiles = (n + per_tile - 1) / per_tile;
  if (col_tiles > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  p.col_tiles = static_cast<int>(col_tiles);
  p.tma_payload = reinterpret_cast<uintptr_t>(data) % 16 == 0 && n % 16 == 0 &&
                  n < (1ll << 31);
  p.vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && n % 16 == 0;
  switch (op) {
    case 0: return launch_nt<OpInt8>(nt, tiles, p, stream);
    case 1: return launch_nt<OpBf16>(nt, tiles, p, stream);
    case 2: return launch_nt<OpTf32>(nt, tiles, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
