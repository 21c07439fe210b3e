// Fused dequantize x matmul for packed INT2/INT4/INT8 weights, sm_90a.
//
// Replaces the Pallas TPU kernel `dequant_matmul` in
// src/repro/kernels/dequant_matmul.py (`_kernel`, `_unpack_tile`,
// `_dequant_tile`):  y = x @ ((codes - z) * s), x and the dequantized weight
// upcast to f32, f32 accumulation, output in x's type.
//
// What bounds it on the H100: bytes.  At the serving shapes (M = 4 rows,
// K x N up to 6144 x 2048, 4-bit, group 64) each weight byte feeds 8 FMAs
// (two codes, four rows), below the ~10 FMAs per byte where the f32 CUDA
// cores (67 TFLOP/s) and HBM (3.35 TB/s) balance; the packed codes plus the
// f32 scales and zeros are nearly all of the traffic.  Reaching the HBM
// rate takes about 2 MB of loads in flight across the card, so the design
// is about keeping many loads outstanding, and about spending few
// instructions per code: a code becomes a float by placing it in the
// mantissa of 2^23 (no int-to-float conversion, which issues at a quarter
// of the FMA rate).
//
// Two routes; `dqmm_plan` in kernels/dequant_matmul.py picks one and the
// entry point checks its numbers again.
//
// mma (bf16 x, M <= 8, operands TMA can address; the decode path's route):
//  * One launch.  A block owns 128 output columns and a range of K; the K
//    ranges of a column tile are the `splits` blocks of a thread-block
//    cluster, whose partial sums are added in rank order through
//    distributed shared memory (no second kernel, no scratch tensor, the
//    same bits every run).
//  * A producer warp keeps a ring of STAGES stages in flight with TMA,
//    behind mbarriers: for BK = 256 rows of K, the packed
//    codes (128-byte swizzled rows), x (8 rows, zero past M and K), and
//    the scale and zero rows.  The launch is a programmatic dependent
//    one: a block sets up its barriers while the previous kernel ends.
//  * Eight consumer warps each take 32 of a stage's K rows (inside one
//    group: the group is a multiple of 32) and run mma.sync m16n8k16 with
//    the codes as A, built in registers, and x as B (8 columns: the rows of
//    x).  A is 128 + code at 2 and 4 bits and code at 8 bits: integers
//    bf16 holds exactly, so every product is exact.  One more mma a step,
//    with an all-ones A, gives each row's sum of x over the same K rows;
//    each group's sums then become x @ (codes - z) by one f32 FMA a column,
//    sum - (128 + z) * sum(x) (z * sum(x) at 8 bits), and are scaled by s
//    in f32.  Any f32 zero is taken, whole or not.  The result is as accurate as the reference's
//    f32 weight.  A 2- or 4-bit pair costs two instructions: a byte permute
//    that puts the two codes in the halves of a bf16 pair and an AND/OR
//    that masks them into the mantissa of 128 (8-bit: the code into 2^23's
//    mantissa, an f32 subtract each, one pair conversion).  The CUDA-core
//    route spends about 8 f32 instructions a code at M = 4.  The A
//    fragment's k order is chosen so that a lane reads its codes as
//    16-byte rows 2t and 2t+1 of an 8-row atom (conflict-free under the
//    swizzle) and the two k-adjacent codes of a pair sit in one byte (2, 4
//    bits) or in adjacent rows (8 bits); x's B fragment follows the same
//    order.
//  * The K split gives about 5/8 of the SMs a block (dqmm_plan).  What
//    a call costs on an H100 beyond its bytes: a fixed few microseconds of
//    launch, first loads and the cluster's combine, then the consumers'
//    instructions a stage (PERF.md).
//
// fma (every other shape: f32 x, M > 8, ragged N, groups the mma route
// does not tile):
//  * A block is four warps over the same 32 * CPT output columns; each
//    thread owns CPT adjacent columns (CPT = 4 when N and the pointers allow
//    32-bit loads of `packed` and 16-byte loads of `scales`/`zeros`, else 1),
//    so a warp reads one contiguous run of each packed row.
//  * The K sweep goes in units of 128 rows; warp w takes rows [32w, 32w+32)
//    of each unit.  It first issues all the loads of its slice (up to 32
//    words per thread, independent), then unpacks and accumulates.  A
//    group's scale and zero are fetched at group boundaries only.
//  * The block also covers BM rows of x (BM = 1, 2, 4 or 8, chosen by the
//    wrapper from M) as f32 register accumulators; each 128-row unit of x is
//    staged in shared memory, transposed so the BM values of one k are
//    contiguous, and read as a broadcast.
//  * A weight is (code - zi) * s - (z - zi) * s with zi = rint(z): the
//    first factor exact, one FMA, so any f32 zero is taken.
//  * The four warps' sums are added through shared memory in a fixed order.
//    A decode-sized M and N give too few blocks to fill 132 SMs, so the
//    units are also split over gridDim.z: each split writes an f32 partial,
//    and a second kernel adds the partials in a fixed order (deterministic)
//    and casts to the output type.  With one split the first kernel writes
//    the output directly.
// Every M >= 1, ragged N, bits in {2, 4, 8} (3-bit codes are stored raw and
// arrive as 8) and any group size that divides K are taken.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NWARP = 4;          // warps per block, one K slice each
constexpr int NT = NWARP * 32;    // threads per block
constexpr int KS = 32;            // K rows per warp slice
constexpr int UNIT = NWARP * KS;  // K rows per staged unit

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

constexpr uint32_t MAGIC_BITS = 0x4B000000u;  // float bits of 2^23
constexpr float MAGIC = 8388608.f;             // 2^23

// the BM staged x values of one k: vector loads from shared memory
template <int BM> __device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (BM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BM; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (BM == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// the CPT bytes of one packed row for a thread's columns (byte c = column c)
template <int CPT> __device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  if constexpr (CPT == 4) return *reinterpret_cast<const uint32_t*>(p);
  else return *p;
}

// a group's scale s, zb = 2^23 + rint(z) and nf = -(z - rint(z)) * s: a
// code's weight (2^23 + code - zb) * s + nf is (code - z) * s for any z
__device__ __forceinline__ void split_zero(float s, float z, float& zb, float& nf) {
  const float zi = rintf(z);
  zb = MAGIC + zi;
  nf = -(z - zi) * s;
}
template <int CPT> __device__ __forceinline__ void load_group(
    const float* __restrict__ scales, const float* __restrict__ zeros,
    size_t at, float* s, float* zb, float* nf) {
  if constexpr (CPT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(scales + at);
    const float4 b = *reinterpret_cast<const float4*>(zeros + at);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    const float z[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) split_zero(s[c], z[c], zb[c], nf[c]);
  } else {
    s[0] = scales[at];
    split_zero(s[0], zeros[at], zb[0], nf[0]);
  }
}

template <typename T, int BM, int BITS, int CPT>
__global__ void __launch_bounds__(NT)
dqmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
            const float* __restrict__ scales, const float* __restrict__ zeros,
            T* __restrict__ out, float* __restrict__ partial, int M, int K,
            int N, int group, int units_per_split) {
  constexpr int PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  constexpr uint32_t MASK = BITS == 8 ? 0xFFu : ((1u << BITS) - 1u);
  constexpr int NW = KS / PER;     // packed words per warp slice
  constexpr int COLS = 32 * CPT;   // output columns per block
  __shared__ __align__(16) float xs[UNIT][BM];
  __shared__ float red[NWARP][BM][COLS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * COLS + lane * CPT;
  const int m0 = blockIdx.y * BM;
  const int nunits = (K + UNIT - 1) / UNIT;
  const int u_begin = blockIdx.z * units_per_split;
  const int u_end = min(u_begin + units_per_split, nunits);
  const bool active = n0 < N;  // with CPT = 4, N % 4 == 0: all 4 or none

  float acc[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int u = u_begin; u < u_end; ++u) {
    const int k0 = u * UNIT;
    const int kn = min(UNIT, K - k0);
    __syncthreads();  // every warp is done with the previous unit
    for (int idx = threadIdx.x; idx < BM * UNIT; idx += NT) {
      const int r = idx / UNIT;
      const int kk = idx - r * UNIT;
      const int m = m0 + r;
      xs[kk][r] = (m < M && kk < kn) ? to_f32(x[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int ks0 = warp * KS;
    const int nprow = (min(KS, kn - ks0)) / PER;  // slice rows are whole words
    if (!active || nprow <= 0) continue;
    // every load of the slice first, all independent
    const uint8_t* wp = packed + (size_t)((k0 + ks0) / PER) * N + n0;
    uint32_t words[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i)
      words[i] = i < nprow ? load_word<CPT>(wp + (size_t)i * N) : 0u;
    int gi = (k0 + ks0) / group;
    int next_boundary = (gi + 1) * group;
    float s[CPT], zb[CPT], nf[CPT];  // see split_zero
    load_group<CPT>(scales, zeros, (size_t)gi * N + n0, s, zb, nf);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (i >= nprow) break;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int kk = ks0 + i * PER + j;
        if (k0 + kk == next_boundary) {
          ++gi;
          next_boundary += group;
          load_group<CPT>(scales, zeros, (size_t)gi * N + n0, s, zb, nf);
        }
        float xv[BM];
        load_row<BM>(&xs[kk][0], xv);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const uint32_t code = (words[i] >> (8 * c + BITS * j)) & MASK;
          const float w = fmaf(__uint_as_float(MAGIC_BITS | code) - zb[c], s[c], nf[c]);
#pragma unroll
          for (int r = 0; r < BM; ++r) acc[r][c] = fmaf(xv[r], w, acc[r][c]);
        }
      }
    }
  }

  // add the four warps' slices in a fixed order
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) red[warp][r][lane * CPT + c] = acc[r][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * COLS; idx += NT) {
    const int r = idx / COLS;
    const int col = idx - r * COLS;
    const int m = m0 + r;
    const int n = blockIdx.x * COLS + col;
    if (m >= M || n >= N) continue;
    float sum = red[0][r][col];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) sum += red[w][r][col];
    if (partial == nullptr)
      out[(size_t)m * N + n] = from_f32<T>(sum);
    else
      partial[((size_t)blockIdx.z * M + m) * N + n] = sum;
  }
}

template <typename T>
__global__ void dqmm_reduce(const float* __restrict__ partial, T* __restrict__ out,
                            int splits, size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * mn + i];
  out[i] = from_f32<T>(acc);
}

// --- mma route: bf16 x, M <= 8, one launch -----------------------------------

typedef __nv_bfloat16 bf16;

constexpr int MMA_BN = 128;         // output columns a block (one swizzled row)
constexpr int MMA_WARPS = 8;        // consumer warps
constexpr int MMA_THREADS = (MMA_WARPS + 1) * 32;  // and one producer warp
constexpr int MMA_MAX_SPLITS = 8;   // cluster size (portable)
constexpr int MMA_BK = 256;         // K rows a stage, every width
constexpr int MMA_MAX_M = 8;        // rows of x at most (B's 8 columns)

// A consumer warp takes 32 K rows of a stage (inside one group): one
// 8-row swizzle atom of packed rows at 2 bits (a lane reads rows 2t and
// 2t+1; two mma steps), two at 4 bits (a step each), four at 8 bits (two
// a step).  A stage is 256 K rows over 8 consumer warps, and one producer
// warp keeps the ring full.
template <int BITS> struct MmaLayout {
  static constexpr int PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  static constexpr int WROWS = 32 / PER;                // packed rows a warp
  static constexpr int PROWS = MMA_WARPS * WROWS;       // packed rows a stage
  static constexpr int BK = PROWS * PER;                // K rows a stage
  static constexpr int WK = WROWS * PER;                // K rows a warp
  static constexpr int PBYTES = PROWS * MMA_BN;
  static constexpr int XBYTES = 8 * BK * 2;             // 8 rows of x
  static constexpr int SR = BK / 32;                    // scale rows (group >= 32)
  static constexpr int SBYTES = SR * MMA_BN * 4;
  static constexpr int STAGE = PBYTES + XBYTES + 2 * SBYTES;
  static constexpr int STAGES = BITS == 8 ? 2 : (BITS == 4 ? 3 : 4);
  static constexpr int PART = 8 * MMA_BN * 4;           // the block's sums
  static constexpr int SMEM = 1024 + STAGES * STAGE + PART + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0, "stages keep the 128-byte swizzle's alignment");
  static_assert(MMA_WARPS * 8 * MMA_BN * 4 <= STAGES * STAGE, "warp sums fit the ring");
  static_assert(BK == MMA_BK, "one stage shape for every width");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// spin until the barrier's phase of this parity completes; a wait that
// outlasts any real stage by far traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// the box of `map` at (c0 inner, c1 outer) into shared memory at dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the same with zero sums in: d = a b
__device__ __forceinline__ void mma_bf16_zero(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// byte i of w (a code in its low bits) as the float 2^23 + code
__device__ __forceinline__ float code_f(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, MAGIC_BITS, 0x7440 | i));
}
// two 8-bit codes (as 2^23 + code) as a bf16 pair, first low: integers
// of at most 8 bits, so exact in bf16
__device__ __forceinline__ uint32_t code2(float c0, float c1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(c0 - MAGIC, c1 - MAGIC);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// 2- and 4-bit codes: byte i of `lo` and of `hi` (each code in the low
// bits of its byte, above it garbage that `mask` clears) into the low and
// high halves, OR-ed into the mantissa of the bf16 128: 128 + code, exact
__device__ __forceinline__ uint32_t pair_bf16(uint32_t lo, uint32_t hi, int i,
                                              uint32_t mask) {
  return (__byte_perm(lo, hi, i | ((4 + i) << 8)) & mask) | 0x43004300u;
}
// row r (stage-local) of the swizzled packed tile, this lane's 16 columns
__device__ __forceinline__ void load_row(const unsigned char* p, int r, int g, uint32_t* w) {
  const uint4 v = *reinterpret_cast<const uint4*>(p + r * MMA_BN + ((g ^ (r & 7)) << 4));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
template <int N> __device__ __forceinline__ void shifted(const uint32_t* w, uint32_t* o) {
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = w[q] >> N;
}

// One 16-deep step of x @ A into d and of x's row sums into sx (FIRST:
// afresh).  Tile j's A rows g and g + 8 are this lane's columns 16 g + 2 j
// and + 1; `pairs(j, a)` builds its A fragment: k slots (2t, 2t+1) of both
// columns, then (2t+8, 2t+9).  B is x at the same k; sx[0] and sx[1] are
// the sums of x's rows 2t and 2t+1 (an all-ones A).
template <bool FIRST, typename F>
__device__ __forceinline__ void mma_step(float (&d)[8][4], float (&sx)[4], const uint32_t* b,
                                         F pairs) {
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  if constexpr (FIRST) mma_bf16_zero(sx, ones, b);
  else mma_bf16(sx, ones, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t a[4];
    pairs(j, a);
    if constexpr (FIRST) mma_bf16_zero(d[j], a, b);
    else mma_bf16(d[j], a, b);
  }
}

// grid (splits, column tiles), clusters of `splits` blocks along x; block
// rank r sweeps stages [r * sps, (r + 1) * sps) of K (BK rows each)
template <int BITS>
__global__ void __launch_bounds__(MMA_THREADS)
dqmm_mma_kernel(const __grid_constant__ CUtensorMap tm_p,
                const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_s,
                const __grid_constant__ CUtensorMap tm_z, bf16* __restrict__ out,
                int M, int K, int N, int group, int sps) {
  using L = MmaLayout<BITS>;
  extern __shared__ unsigned char mma_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(mma_raw) + 1023) & ~uintptr_t(1023));
  float* part = reinterpret_cast<float*>(base + L::STAGES * L::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + 8 * MMA_BN);
  uint64_t* empty = full + L::STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)gridDim.x;  // the cluster spans x
  const int n0 = blockIdx.y * MMA_BN;
  const int nst = (K + L::BK - 1) / L::BK;
  const int s_lo = rank * sps;
  const int ns = min(nst, s_lo + sps) - s_lo;
  const int srows = group >= L::BK ? 1 : L::BK / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MMA_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a programmatic dependent launch: the barriers are set up while the
  // previous kernel finishes; x and out belong to earlier kernels, so wait
  // for them, then let the next launch start its own set-up
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int g = lane >> 2, t = lane & 3;

  if (warp == MMA_WARPS) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      const uint32_t bytes = L::PBYTES + L::XBYTES + 2 * srows * MMA_BN * 4;
      for (int i = 0; i < ns; ++i) {
        const int slot = i % L::STAGES;
        if (i >= L::STAGES) mbar_wait(&empty[slot], ((i / L::STAGES) - 1) & 1);
        unsigned char* st = base + slot * L::STAGE;
        const int kst = s_lo + i, k0 = kst * L::BK;
        mbar_expect_tx(&full[slot], bytes);
        tma_load(st, &tm_p, &full[slot], n0, kst * L::PROWS);
        tma_load(st + L::PBYTES, &tm_x, &full[slot], k0, 0);
        tma_load(st + L::PBYTES + L::XBYTES, &tm_s, &full[slot], n0, k0 / group);
        tma_load(st + L::PBYTES + L::XBYTES + L::SBYTES, &tm_z, &full[slot], n0,
                 k0 / group);
      }
    }
  } else {
    const int rb = warp * L::WROWS;  // this warp's packed rows of a stage
    for (int i = 0; i < ns; ++i) {
      const int slot = i % L::STAGES;
      mbar_wait(&full[slot], (i / L::STAGES) & 1);
      const unsigned char* st = base + slot * L::STAGE;
      // this warp's K rows lie in one group (group % 32 == 0)
      const int grow = group >= L::BK ? 0 : (warp * L::WK) / group;
      const float* srow = reinterpret_cast<const float*>(st + L::PBYTES + L::XBYTES) +
                          grow * MMA_BN + 16 * g;
      const float* zrow = srow + L::SBYTES / 4;
      // A holds code + OFF; x @ (codes - z) = x @ A - (OFF + z) sum(x)
      constexpr float OFF = BITS == 8 ? 0.f : 128.f;
      float sc[16], nz[16];  // s, and -(OFF + z)
#pragma unroll
      for (int c = 0; c < 16; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(srow + c);
        const float4 z = *reinterpret_cast<const float4*>(zrow + c);
        sc[c] = a.x; sc[c + 1] = a.y; sc[c + 2] = a.z; sc[c + 3] = a.w;
        nz[c] = -(OFF + z.x); nz[c + 1] = -(OFF + z.y);
        nz[c + 2] = -(OFF + z.z); nz[c + 3] = -(OFF + z.w);
      }
      const uint32_t* xs = reinterpret_cast<const uint32_t*>(st + L::PBYTES) + g * (L::BK / 2);
      float grp[8][4], sx[4];  // x @ A and x's row sums over this warp's K rows
      if constexpr (BITS == 4) {
        // rows 2t, 2t+1 of each of the warp's two atoms hold k 4t .. 4t+3
        // of that atom: a step each
#pragma unroll
        for (int u = 0; u < L::WROWS / 8; ++u) {
          const int ra = rb + 8 * u + 2 * t;
          uint32_t wa[4], wb[4], wa4[4], wb4[4];
          load_row(st, ra, g, wa);
          load_row(st, ra + 1, g, wb);
          shifted<4>(wa, wa4);
          shifted<4>(wb, wb4);
          const uint32_t b[2] = {xs[ra], xs[ra + 1]};  // k 2ra .. 2ra + 3
          auto pairs = [&](int j, uint32_t* a) {
            const int q = j >> 1, i0 = 2 * (j & 1);
            a[0] = pair_bf16(wa[q], wa4[q], i0, 0x000F000Fu);
            a[1] = pair_bf16(wa[q], wa4[q], i0 + 1, 0x000F000Fu);
            a[2] = pair_bf16(wb[q], wb4[q], i0, 0x000F000Fu);
            a[3] = pair_bf16(wb[q], wb4[q], i0 + 1, 0x000F000Fu);
          };
          if (u == 0) mma_step<true>(grp, sx, b, pairs);
          else mma_step<false>(grp, sx, b, pairs);
        }
      } else if constexpr (BITS == 2) {
        // row 2t of the warp's atom holds k 8t .. 8t+3 (one step), row
        // 2t+1 k 8t+4 .. 8t+7 (the next)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rb + 2 * t + h;
          uint32_t w[4], w2[4], w4[4], w6[4];
          load_row(st, r, g, w);
          shifted<2>(w, w2);
          shifted<4>(w, w4);
          shifted<6>(w, w6);
          const uint32_t b[2] = {xs[2 * r], xs[2 * r + 1]};  // k 4r .. 4r + 3
          auto pairs = [&](int j, uint32_t* a) {
            const int q = j >> 1, i0 = 2 * (j & 1);
            a[0] = pair_bf16(w[q], w2[q], i0, 0x00030003u);
            a[1] = pair_bf16(w[q], w2[q], i0 + 1, 0x00030003u);
            a[2] = pair_bf16(w4[q], w6[q], i0, 0x00030003u);
            a[3] = pair_bf16(w4[q], w6[q], i0 + 1, 0x00030003u);
          };
          if (h == 0) mma_step<true>(grp, sx, b, pairs);
          else mma_step<false>(grp, sx, b, pairs);
        }
      } else {
        // rows 2t, 2t+1 of each of the warp's four atoms hold k 2t, 2t+1
        // of that atom: two atoms a step
#pragma unroll
        for (int u = 0; u < L::WROWS / 8; u += 2) {
          const int r0 = rb + 8 * u + 2 * t, r1 = r0 + 8;
          uint32_t a0[4], a1[4], b0[4], b1[4];
          load_row(st, r0, g, a0);
          load_row(st, r0 + 1, g, a1);
          load_row(st, r1, g, b0);
          load_row(st, r1 + 1, g, b1);
          const uint32_t b[2] = {xs[r0 / 2], xs[r1 / 2]};
          auto pairs = [&](int j, uint32_t* a) {
            const int q = j >> 1, i0 = 2 * (j & 1);
            a[0] = code2(code_f(a0[q], i0), code_f(a1[q], i0));
            a[1] = code2(code_f(a0[q], i0 + 1), code_f(a1[q], i0 + 1));
            a[2] = code2(code_f(b0[q], i0), code_f(b1[q], i0));
            a[3] = code2(code_f(b0[q], i0 + 1), code_f(b1[q], i0 + 1));
          };
          if (u == 0) mma_step<true>(grp, sx, b, pairs);
          else mma_step<false>(grp, sx, b, pairs);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      // the group's zero and scale, once a column (d0, d1: column 2j;
      // d2, d3: 2j+1; d0, d2: x's row 2t, d1, d3: 2t+1), the zero's term
      // taken off in one rounding
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] = fmaf(fmaf(nz[2 * j], sx[0], grp[j][0]), sc[2 * j], acc[j][0]);
        acc[j][1] = fmaf(fmaf(nz[2 * j], sx[1], grp[j][1]), sc[2 * j], acc[j][1]);
        acc[j][2] = fmaf(fmaf(nz[2 * j + 1], sx[0], grp[j][2]), sc[2 * j + 1], acc[j][2]);
        acc[j][3] = fmaf(fmaf(nz[2 * j + 1], sx[1], grp[j][3]), sc[2 * j + 1], acc[j][3]);
      }
    }
  }

  // the warps' sums over the ring, added in warp order, then the cluster's
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(base);  // [MMA_WARPS][8 tiles][32 lanes]
  if (warp < MMA_WARPS) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      red[(warp * 8 + j) * 32 + lane] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  if (threadIdx.x < 8 * 32) {  // tile j, lane l: columns 16 g + 2 j (+1), rows 2t (+1)
    float4 v = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) {
      const float4 a = red[w * 8 * 32 + threadIdx.x];
      v.x += a.x; v.y += a.y; v.z += a.z; v.w += a.w;
    }
    const int j = threadIdx.x >> 5, l = threadIdx.x & 31;
    float* p0 = part + 2 * (l & 3) * MMA_BN + 16 * (l >> 2) + 2 * j;
    p0[0] = v.x;
    p0[MMA_BN] = v.y;
    p0[1] = v.z;
    p0[MMA_BN + 1] = v.w;
  }
  cluster.sync();
  const int total = M * MMA_BN;
  const int share = (total + splits - 1) / splits;
  const int hi = min(total, (rank + 1) * share);
  for (int e = rank * share + threadIdx.x; e < hi; e += MMA_THREADS) {
    const int n = n0 + e % MMA_BN;
    if (n >= N) continue;
    float v[MMA_MAX_SPLITS];  // every rank's sum, loads all in flight
#pragma unroll
    for (int s = 0; s < MMA_MAX_SPLITS; ++s)
      v[s] = s < splits ? cluster.map_shared_rank(part, s)[e] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int s = 1; s < MMA_MAX_SPLITS; ++s) sum += v[s];
    out[(size_t)(e / MMA_BN) * N + n] = __float2bfloat16(sum);
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// --- host side of the mma route ---------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D row-major tensor (outer x inner, rows row_bytes apart) read in
// boxes of outer_box x inner_box; out-of-range elements read as zero.
// Returns 0, or ENCODE_FAILED + the encoder's CUresult.
constexpr int ENCODE_FAILED = 10000;
int make_map(CUtensorMap* m, CUtensorMapDataType dt, const void* ptr, uint64_t inner,
             uint64_t outer, uint64_t row_bytes, uint32_t inner_box, uint32_t outer_box,
             CUtensorMapSwizzle sw) {
  const EncodeTiled enc = encoder();
  if (!enc) return ENCODE_FAILED;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {inner_box, outer_box};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = enc(m, dt, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)rc;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the shapes and pointers the mma route takes (dqmm_plan's rule)
bool mma_addressable(const void* x, const void* packed, const void* scales,
                     const void* zeros, int M, int K, int N, int bits, int group) {
  return M <= MMA_MAX_M && K % 8 == 0 && N % 16 == 0 && group % 32 == 0 &&
         (MMA_BK % group == 0 || group % MMA_BK == 0) && aligned16(x) &&
         aligned16(packed) && aligned16(scales) && aligned16(zeros);
}

template <int BITS>
int launch_mma(const void* x, const void* packed, const void* scales, const void* zeros,
               void* out, int M, int K, int N, int group, int splits, int sps,
               cudaStream_t s) {
  using L = MmaLayout<BITS>;
  const int nst = (K + L::BK - 1) / L::BK;
  if (splits < 1 || splits > MMA_MAX_SPLITS || sps < 1 ||
      (long long)(splits - 1) * sps >= nst || (long long)splits * sps < nst)
    return (int)cudaErrorInvalidValue;
  const int srows = group >= L::BK ? 1 : L::BK / group;
  CUtensorMap mp, mx, ms, mz;
  int rc = make_map(&mp, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, N, K / L::PER, N, MMA_BN,
                    L::PROWS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc) rc = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2ull * K, L::BK,
                         8, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!rc) rc = make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, N, K / group,
                         4ull * N, MMA_BN, srows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!rc) rc = make_map(&mz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, zeros, N, K / group,
                         4ull * N, MMA_BN, srows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;
  auto kern = dqmm_mma_kernel<BITS>;
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM);
    if (e != cudaSuccess) return (int)e;
    set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + MMA_BN - 1) / MMA_BN);
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(&cfg, kern, mp, mx, ms, mz, static_cast<bf16*>(out), M, K,
                                 N, group, sps);
}

struct Args {
  const void *x, *packed, *scales, *zeros;
  void *out, *partial;
  int M, K, N, group, splits, units_per_split;
  cudaStream_t stream;
};

template <typename T, int BM, int BITS, int CPT>
void launch(const Args& a) {
  dim3 grid((a.N + 32 * CPT - 1) / (32 * CPT), (a.M + BM - 1) / BM, a.splits);
  dqmm_kernel<T, BM, BITS, CPT><<<grid, NT, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const uint8_t*>(a.packed),
      static_cast<const float*>(a.scales), static_cast<const float*>(a.zeros),
      static_cast<T*>(a.out),
      a.splits > 1 ? static_cast<float*>(a.partial) : nullptr, a.M, a.K, a.N,
      a.group, a.units_per_split);
  if (a.splits > 1) {
    const size_t mn = (size_t)a.M * a.N;
    const unsigned blocks = (unsigned)((mn + 255) / 256);
    dqmm_reduce<T><<<blocks, 256, 0, a.stream>>>(
        static_cast<const float*>(a.partial), static_cast<T*>(a.out), a.splits, mn);
  }
}

template <typename T, int BM, int BITS>
int by_cols(int cpt, const Args& a) {
  if (cpt == 4) launch<T, BM, BITS, 4>(a);
  else if (cpt == 1) launch<T, BM, BITS, 1>(a);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int BM>
int by_bits(int bits, int cpt, const Args& a) {
  switch (bits) {
    case 2: return by_cols<T, BM, 2>(cpt, a);
    case 4: return by_cols<T, BM, 4>(cpt, a);
    case 8: return by_cols<T, BM, 8>(cpt, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_rows(int bm, int bits, int cpt, const Args& a) {
  switch (bm) {
    case 1: return by_bits<T, 1>(bits, cpt, a);
    case 2: return by_bits<T, 2>(bits, cpt, a);
    case 4: return by_bits<T, 4>(bits, cpt, a);
    case 8: return by_bits<T, 8>(bits, cpt, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) f32 or bf16 (x_is_bf16), packed (K*bits/8, N) uint8,
// scales/zeros (K/group, N) f32, out (M, N) in x's type.  All contiguous.
// route 1 (mma): bf16 x that mma_addressable takes; `splits` blocks a
// cluster, `per_split` stages of 256 K rows each; bm, cpt and partial
// unused.  route 0 (fma): bm rows a block, cpt columns a thread (4 needs
// N % 4 == 0, `packed` 4-byte and `scales`/`zeros` 16-byte aligned),
// `splits` K splits of `per_split` 128-row units, partial (splits, M, N)
// f32 scratch (unused when splits == 1).  Returns 0 or a cudaError_t code
// (ENCODE_FAILED + a CUresult when a tensor map is refused).
extern "C" int dqmm_launch(const void* x, const void* packed, const void* scales,
                           const void* zeros, void* out, void* partial, int M,
                           int K, int N, int bits, int group, int route, int bm, int cpt,
                           int splits, int per_split, int x_is_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1 || group < 1 || K % group || splits < 1 ||
      per_split < 1 || (cpt == 4 && N % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (route == 1) {
    if (!x_is_bf16 || !mma_addressable(x, packed, scales, zeros, M, K, N, bits, group))
      return (int)cudaErrorInvalidValue;
    switch (bits) {
      case 2: rc = launch_mma<2>(x, packed, scales, zeros, out, M, K, N, group, splits, per_split, s); break;
      case 4: rc = launch_mma<4>(x, packed, scales, zeros, out, M, K, N, group, splits, per_split, s); break;
      case 8: rc = launch_mma<8>(x, packed, scales, zeros, out, M, K, N, group, splits, per_split, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (route == 0) {
    const Args a{x, packed, scales, zeros, out, partial, M, K, N, group,
                 splits, per_split, s};
    rc = x_is_bf16 ? by_rows<__nv_bfloat16>(bm, bits, cpt, a)
                   : by_rows<float>(bm, bits, cpt, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
