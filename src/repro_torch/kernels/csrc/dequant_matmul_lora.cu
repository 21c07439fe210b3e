// Fused dequantize x matmul plus LoRA for packed INT2/INT4/INT8 weights,
// sm_90a:  y = x @ ((codes - z) * s) + (x @ A) @ B^T.
//
// Replaces the Pallas TPU kernel `dequant_matmul_lora` in
// src/repro/kernels/dequant_matmul.py (`_kernel_lora`): the base product and
// x @ A accumulated in f32 over K, the LoRA term added, output in x's type.
//
// What bounds it on the H100: operations.  In LoRA fine-tuning the forward
// of every quantized linear has M = 1024 tokens (batch 8 x 128), so each
// packed weight byte feeds 2 * 1024 multiply-adds per code; one training
// forward of Qwen3-1.7B is 3.03 TFLOP against 3.3 GB of traffic, 3.06 ms at
// the bf16 tensor-core rate.  Three kernels, chosen by shape (`lora_plan`
// in kernels/dequant_matmul.py is the rule; the entry point re-checks it):
//
// The weight is the reference's f32 (codes - z) * s on every route, never
// rounded to bf16: at K = 14336 a bf16 weight puts outputs where base and
// LoRA terms cancel outside the bf16 tolerance.  The tensor-core routes
// take the codes exactly in bf16 (128 + code at 2 and 4 bits, the code at
// 8 bits), so every product is exact in the f32 sums, and sum each group
// (or stage) apart before it is folded in with its f32 scale and zero
// (mma: acc += s * (part - (z + off) * sum(x over the group)), any f32
// zero; wgmma: the zero split below).
//
//  * wgmma: bf16 x, and every base and row stride TMA can address (K % 8,
//    N % 16, r % 8, 16-byte aligned bases), a group that is a multiple of
//    64 (a stage or more).  The training path.
//    - A prologue (`xa_kernel`, mma.sync, bf16 products exact in f32 sums)
//      splits K over a cluster of up to 8 blocks and writes, for every row
//      of x, each 64-row stage's sum of x as bf16 hi and lo (16 stages a
//      64-column block), and x @ A once per row, not once per column tile:
//      the cluster adds its partial sums in block order through
//      distributed shared memory and writes hi = bf16(xa),
//      lo = bf16(xa - hi).  The main kernel is launched programmatically
//      dependent on it; only its loads of the sums and of [hi | lo] wait.
//    - The tile is computed transposed, y^T = W^T x^T, so that the codes
//      are wgmma's A and come from registers: each consumer thread builds
//      its fragments straight from the TMA-loaded packed bytes (two
//      columns' codes in one 16-bit load; no staged bf16 weight tile in
//      shared memory), and x is B, read by the wgmmas from a ring of TMA
//      tiles (128-byte swizzle).
//    - The zero is split, z = round(z) + zf: the fragments hold code -
//      round(z), exact in bf16, so a stage's sums fold into the tile's
//      with one f32 FMA an element, acc += s * part, and no sum of x is
//      read in the K loop; -s * zf against the stages' sums of x runs on
//      the tensor cores every 16 stages as one more stage of bf16 halves
//      of both: about 16 bits of zf's term, not f32's 24 (small beside
//      the sums where z lies in the codes' range, |zf| <= 1/2; as large
//      as they where z lies past round(z)'s clamp, as at 8 bits, z < 0).
//    - Persistent blocks, one per SM, walking tiles of 128 output columns
//      by BT rows of x (BT = 128, or 64 where 128 would leave SMs idle).
//      Two warpgroups each own 64 columns (the 64 rows of their wgmmas), a
//      thread two adjacent columns, whose scales it keeps in registers, and
//      split the BT rows into two chunks (m64n(BT/2)k16).  A stage: its
//      eight wgmmas (and any correction's) issued at once, the next
//      stage's packed words, scales and zeros loaded, the wait, the folds,
//      the next stage's fragments built.
//    - What holds this route back (PERF.md §6): a wgmma with A in
//      registers holds its SM sub-partition's warps until the tensor cores
//      take it, so the fragments and the fold (CUDA cores) do not overlap
//      the tensor cores; staging the codes in shared memory for SS wgmmas
//      instead cost more in stores and proxy fences.
//    - Not reached: a wgmma_wait<1> ahead of each fold, one stage's
//      wgmmas in flight while the stage before is folded.  Every stage
//      waits with wgmma_wait<0>: a second pair of stage sums (64 f32 a
//      thread at BT 128) does not fit beside the 168 registers a consumer
//      thread holds under REG_MMA's 232, and the fold could not run under
//      the next stage's register-A wgmmas anyway (the sub-partition is
//      held).
//    - Slower at k/v (N 1024) than the staged-code design it replaced
//      (1.033x on an H100 80GB HBM3 at 700 W, PERF.md §6): its 64-row
//      tiles (128 of them, where 128-row tiles fill 64 SMs) convert each
//      stage's codes for 64 rows of x, not 128: twice the conversion a
//      product.
//      Lever: 128-row tiles with K split over two blocks, the halves
//      summed in a fixed order (no atomics).
//    - The LoRA term on the tensor cores: [hi | lo] (M x 2r) against
//      [B^T; B^T] as more stages (A = B's rows, by ldmatrix), added
//      unscaled into the tile's sums; xa keeps about 16 bits.
//    - The sums leave through shared memory in coalesced 16-byte stores.
//  * mma: bf16 x that the wgmma route does not take, group % 8 == 0.
//    64 x 128 tiles of 256 threads, mma.sync m16n8k16 on exact codes (k8
//    halves where the group is not a multiple of 16), the group's sum of x
//    by one more mma against ones, each chunk's operands loaded into
//    registers one 32-row chunk ahead, x @ A in the same sweep, the LoRA
//    term in f32 FMAs.
//  * fma: f32 x, and bf16 x with another group.  f32 FMAs on the CUDA cores
//    (67 TFLOP/s) on the f32 weight, the only way to the reference's f32
//    tolerance (2e-4) with no TF32; 4 x 8 register micro-tiles, the same
//    tiles and sweep as mma.
// No atomics and a fixed summation order on every route: the same bits on
// every run.  Every M >= 1, ragged N and K, bits in {2, 4, 8} (3-bit codes
// are stored raw and arrive as 8), any group size dividing K, and ranks
// 0..128 are taken, by one route or another.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int BM = 64;          // rows of x per block
constexpr int BN = 128;         // output columns per block
constexpr int BK = 32;          // K rows per staged chunk
constexpr int NT = 256;         // threads per block: 16 (ty) x 16 (tx)
constexpr int XS = BM + 4;      // row stride of the transposed x chunk
constexpr int MAX_RPT = 8;      // ranks per thread: r <= 16 * MAX_RPT

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

__device__ __forceinline__ void unpack4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// shared floats: the staging buffers, and the epilogue's buffers after them
__host__ __device__ constexpr int stage_floats(int rpt) {
  return BK * XS + BK * BN + BK * 16 * rpt;
}
__host__ __device__ constexpr int epilogue_floats(int rpt) {
  return 16 * rpt * BM + 16 * rpt * BN;
}
__host__ __device__ constexpr int smem_floats(int rpt) {
  return stage_floats(rpt) > epilogue_floats(rpt) ? stage_floats(rpt)
                                                  : epilogue_floats(rpt);
}

template <typename T, int BITS, int RPT>
__global__ void __launch_bounds__(NT)
dqmm_lora_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales, const float* __restrict__ zeros,
                 const T* __restrict__ lora_a, const T* __restrict__ lora_b,
                 T* __restrict__ out, int M, int K, int N, int group, int r) {
  constexpr int PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  constexpr uint32_t MASK = BITS == 8 ? 0xFFu : ((1u << BITS) - 1u);
  constexpr int R16 = 16 * RPT;            // staged ranks (zero-padded)
  constexpr int ROWS_PER_THREAD = BK * BN / NT;   // weight rows dequantized
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [BK][XS], x chunk transposed
  float* ws = xs + BK * XS;                // [BK][BN], dequantized weights
  float* as = ws + BK * BN;                // [BK][R16], A chunk

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][8];
  float xa[4][RPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < RPT; ++j) xa[i][j] = 0.f;
  }

  // the weight column and rows this thread dequantizes in every chunk
  const int wc = tid % BN;
  const int wr0 = (tid / BN) * ROWS_PER_THREAD;
  const int n_w = n0 + wc;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every thread is done with the previous chunk
    // x chunk: x[m0 + m][k0 + kk] -> xs[kk][m]
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK;
      const int kk = idx % BK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk * XS + m] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    // A chunk: A[k0 + kk][rr] -> as[kk][rr], zero past r
    for (int idx = tid; idx < BK * R16; idx += NT) {
      const int kk = idx / R16;
      const int rr = idx % R16;
      const int gk = k0 + kk;
      as[idx] = (gk < K && rr < r) ? to_f32(lora_a[(size_t)gk * r + rr]) : 0.f;
    }
    // weight chunk: rows wr0 .. wr0 + ROWS_PER_THREAD of column wc
    {
      const int kb = k0 + wr0;  // a multiple of PER: whole packed words
      int gi = kb / group;
      int next_boundary = (gi + 1) * group;
      float s = 0.f, z = 0.f;
      if (n_w < N && kb < K) {
        s = scales[(size_t)gi * N + n_w];
        z = zeros[(size_t)gi * N + n_w];
      }
#pragma unroll
      for (int p = 0; p < ROWS_PER_THREAD / PER; ++p) {
        const int kw = kb + p * PER;
        const bool ok = n_w < N && kw < K;
        const uint32_t word = ok ? packed[(size_t)(kw / PER) * N + n_w] : 0u;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int k = kw + j;
          if (ok && k == next_boundary) {
            ++gi;
            next_boundary += group;
            s = scales[(size_t)gi * N + n_w];
            z = zeros[(size_t)gi * N + n_w];
          }
          const float code = (float)((word >> (BITS * j)) & MASK);
          ws[(wr0 + p * PER + j) * BN + wc] = ok ? (code - z) * s : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], w0[4], w1[4];
      unpack4(xs + kk * XS + ty * 4, xv);
      unpack4(ws + kk * BN + tx * 4, w0);
      unpack4(ws + kk * BN + 64 + tx * 4, w1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(xv[i], w0[j], acc[i][j]);
          acc[i][4 + j] = fmaf(xv[i], w1[j], acc[i][4 + j]);
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float av = as[kk * R16 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i][j] = fmaf(xv[i], av, xa[i][j]);
      }
    }
  }

  // epilogue: xa^T [R16][BM] and B^T [R16][BN] through shared memory
  __syncthreads();
  float* xat = smem;
  float* bt = smem + R16 * BM;
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) xat[(tx + 16 * j) * BM + ty * 4 + i] = xa[i][j];
  for (int idx = tid; idx < R16 * BN; idx += NT) {
    const int rr = idx / BN;
    const int n = idx % BN;
    bt[idx] = (rr < r && n0 + n < N) ? to_f32(lora_b[(size_t)(n0 + n) * r + rr]) : 0.f;
  }
  __syncthreads();
  float lora[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) lora[i][j] = 0.f;
  for (int rr = 0; rr < r; ++rr) {
    float av[4], b0[4], b1[4];
    unpack4(xat + rr * BM + ty * 4, av);
    unpack4(bt + rr * BN + tx * 4, b0);
    unpack4(bt + rr * BN + 64 + tx * 4, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lora[i][j] = fmaf(av[i], b0[j], lora[i][j]);
        lora[i][4 + j] = fmaf(av[i], b1[j], lora[i][4 + j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[(size_t)m * N + n] = from_f32<T>(acc[i][j] + lora[i][j]);
    }
  }
}

template <typename T, int BITS, int RPT>
int launch(const void* x, const void* packed, const void* scales, const void* zeros,
           const void* a, const void* b, void* out, int M, int K, int N,
           int group, int r, cudaStream_t stream) {
  const int bytes = smem_floats(RPT) * (int)sizeof(float);
  auto kern = dqmm_lora_kernel<T, BITS, RPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, K, N, group, r);
  return 0;
}

template <typename T, int BITS>
int by_rank(int rpt, const void* x, const void* packed, const void* scales,
            const void* zeros, const void* a, const void* b, void* out, int M,
            int K, int N, int group, int r, cudaStream_t s) {
  switch (rpt) {
    case 1: return launch<T, BITS, 1>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 2: return launch<T, BITS, 2>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 4: return launch<T, BITS, 4>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 8: return launch<T, BITS, 8>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_bits(int bits, int rpt, const void* x, const void* packed, const void* scales,
            const void* zeros, const void* a, const void* b, void* out, int M,
            int K, int N, int group, int r, cudaStream_t s) {
  switch (bits) {
    case 2: return by_rank<T, 2>(rpt, x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 4: return by_rank<T, 4>(rpt, x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 8: return by_rank<T, 8>(rpt, x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 input: the products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int KS = BK + 8;  // row stride (bf16) of a staged tile: 80 bytes

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16, row-major) @ b (16 x 8), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16 x 8, row-major) @ b (8 x 8): the k8 halves of mma_bf16's
// fragments (a[0], a[1], b[0] the first, a[2], a[3], b[1] the second)
__device__ __forceinline__ void mma_bf16_k8(float* d, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

constexpr uint32_t BF16_ONES = 0x3F803F80u;  // a pair of bf16 1.0
constexpr float CODE_OFF = 128.f;            // 2- and 4-bit codes are staged as 128 + code

// A code as the exact bf16 the tensor cores take: 128 + code at 2 and 4
// bits (the bf16 bits 0x4300 | code: 128's exponent, the code in the
// mantissa), the code itself at 8 bits; a pair in one 32-bit word
template <int BITS> __device__ __forceinline__ uint32_t code_pair(uint32_t c0, uint32_t c1) {
  if constexpr (BITS < 8) {
    return 0x43004300u | c0 | (c1 << 16);
  } else {
    const float f0 = __uint_as_float(0x4B000000u | c0) - 8388608.f;  // exact
    const float f1 = __uint_as_float(0x4B000000u | c1) - 8388608.f;
    return pack_bf16(f0, f1);
  }
}

// the A fragment of the 16 x 16 tile at t (rows of stride KS, k contiguous)
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* t, int g, int c) {
  a[0] = ld32(t + g * KS + 2 * c);
  a[1] = ld32(t + (g + 8) * KS + 2 * c);
  a[2] = ld32(t + g * KS + 2 * c + 8);
  a[3] = ld32(t + (g + 8) * KS + 2 * c + 8);
}

// the B fragment of the 16 x 8 tile at t, stored by column (k contiguous)
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* t, int g, int c) {
  b[0] = ld32(t + g * KS + 2 * c);
  b[1] = ld32(t + g * KS + 2 * c + 8);
}

__host__ __device__ constexpr int mma_stage_bytes(int rt) {
  return (BM + BN + 16 * rt) * KS * 2;
}
constexpr int BTS = BN + 1;  // row stride (f32) of the epilogue's B^T: no bank conflicts

__host__ __device__ constexpr int mma_epilogue_bytes(int rt) {
  return 16 * rt * (BM + BTS) * 4;
}
__host__ __device__ constexpr int mma_smem_bytes(int rt) {
  return mma_stage_bytes(rt) > mma_epilogue_bytes(rt) ? mma_stage_bytes(rt)
                                                      : mma_epilogue_bytes(rt);
}

// RT: rank tiles of 16 staged (r <= 16 * RT, zero-padded)
// two blocks an SM up to rank 32 (at most 128 registers a thread), so one
// block's products run while the other waits on its next chunk
//
// The weight chunk holds exact codes (code_pair), so every product on the
// tensor cores is exact and each group's sums `part` are those of
// x @ (codes + off) in f32.  One more mma a step against ones gives the
// group's sum of x over the same rows (`sx`), and at the group's end each
// sum is folded in with the group's scale and zero in f32:
// acc += s * (part - (z + off) * sx), off = 128 at 2 and 4 bits, 0 at 8.
// A group that is a multiple of 16 folds after a k16 step, one that is a
// multiple of 8 after a k8 half (group % 8 == 0 is this route's rule).
template <int BITS, int RT>
__global__ void __launch_bounds__(NT, RT <= 2 ? 2 : 1)
dqmm_lora_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales, const float* __restrict__ zeros,
                     const bf16* __restrict__ lora_a, const bf16* __restrict__ lora_b,
                     bf16* __restrict__ out, int M, int K, int N, int group, int r) {
  constexpr int PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  constexpr uint32_t MASK = BITS == 8 ? 0xFFu : ((1u << BITS) - 1u);
  constexpr float OFF = BITS < 8 ? CODE_OFF : 0.f;
  constexpr int RP = 16 * RT;
  constexpr int ROWS_PER_THREAD = BK * BN / NT;  // weight rows a thread
  constexpr int WORDS = ROWS_PER_THREAD / PER;    // packed bytes a thread
  constexpr int A_PER_THREAD = BK * RP / NT;     // A values a thread
  constexpr int X_PER_THREAD = BM * BK / 8 / NT; // 16-byte x slots a thread
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [BM][KS]: x chunk
  bf16* ws = xs + BM * KS;                   // [BN][KS]: code chunk, transposed
  bf16* as = ws + BN * KS;                   // [RP][KS]: A chunk, transposed

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = (warp & 1) * 32;   // the warp's 32 x 32 piece of the tile
  const int wn = (warp >> 1) * 32;
  const int lm = (warp & 3) * 16;   // its 16 rows of x @ A ...
  const int lr = warp >> 2;         // ... at 8-rank tiles lr, lr + 2, ...
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[2][4][4], part[2][4][4], sx[2][4];
  float xa[RT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sx[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xa[j][e] = 0.f;

  // group gi's sums into acc: the thread's 8 columns' scales and zeros
  auto fold = [&](int gi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s[2], zb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wn + 8 * j + 2 * c + h;
        s[h] = n < N ? scales[(size_t)gi * N + n] : 0.f;
        zb[h] = n < N ? zeros[(size_t)gi * N + n] + OFF : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = fmaf(s[e & 1], fmaf(-zb[e & 1], sx[i][e], part[i][j][e]),
                              acc[i][j][e]);
          part[i][j][e] = 0.f;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sx[i][e] = 0.f;
  };

  // the weight column and rows this thread stages, the x row and 8-wide k
  // slot it stages (when K % 8 == 0 and x is 16-byte aligned)
  const int wc = tid % BN;
  const int wr0 = (tid / BN) * ROWS_PER_THREAD;
  const int n_w = n0 + wc;
  const bool x_vec = (K & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bf16 zero = __float2bfloat16(0.f);
  const uint32_t ones[2] = {BF16_ONES, BF16_ONES};

  // one chunk's global operands, loaded into registers all at once, one
  // chunk ahead of the products (so one memory latency a chunk, hidden
  // behind the previous chunk's products)
  uint4 xr[X_PER_THREAD];
  bf16 ar[A_PER_THREAD];
  uint32_t wr[WORDS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_PER_THREAD; ++i) {
      const int slot = tid + i * NT;
      const int gm = m0 + slot / (BK / 8), gk = k0 + (slot % (BK / 8)) * 8;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (x_vec && gm < M && gk < K)
        xr[i] = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
    }
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int idx = tid + i * NT;
      const int ka = k0 + idx / RP, rr = idx % RP;
      ar[i] = (ka < K && rr < r) ? lora_a[(size_t)ka * r + rr] : zero;
    }
    const int kb = k0 + wr0;  // a multiple of PER: whole packed words
#pragma unroll
    for (int p = 0; p < WORDS; ++p) {
      const int kw = kb + p * PER;
      wr[p] = (n_w < N && kw < K) ? packed[(size_t)(kw / PER) * N + n_w] : 0u;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every thread is done with the previous chunk
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < X_PER_THREAD; ++i) {
        const int slot = tid + i * NT;
        *reinterpret_cast<uint4*>(xs + (slot / (BK / 8)) * KS + (slot % (BK / 8)) * 8) =
            xr[i];
      }
    } else {
      for (int idx = tid; idx < BM * BK; idx += NT) {
        const int m = idx / BK, kk = idx % BK;
        const int gm = m0 + m, gk = k0 + kk;
        xs[m * KS + kk] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int idx = tid + i * NT;
      as[(idx % RP) * KS + idx / RP] = ar[i];
    }
    // the codes as exact bf16, two 16-byte vectors of ws[wc]; zero past N
    // and K
    {
      const int kb = k0 + wr0;
      uint32_t v[ROWS_PER_THREAD / 2];
#pragma unroll
      for (int q = 0; q < ROWS_PER_THREAD / 2; ++q) {
        const int k = kb + 2 * q;  // rows k, k + 1: one packed word, or two at 8 bits
        const uint32_t w0 = wr[(2 * q) / PER], w1 = wr[(2 * q + 1) / PER];
        const uint32_t c0 = (w0 >> (BITS * ((2 * q) % PER))) & MASK;
        const uint32_t c1 = (w1 >> (BITS * ((2 * q + 1) % PER))) & MASK;
        v[q] = (n_w < N && k < K) ? code_pair<BITS>(c0, c1) : 0u;
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wc * KS + wr0);
#pragma unroll
      for (int q = 0; q < ROWS_PER_THREAD / 8; ++q)
        dst[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2], la[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) frag_a(af[i], xs + (wm + 16 * i) * KS + ks, g, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) frag_b(bfr[j], ws + (wn + 8 * j) * KS + ks, g, c);
      if (group % 16 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], af[i], bfr[j]);
          mma_bf16(sx[i], af[i], ones);
        }
        const int ke = k0 + ks + 16;
        if (ke <= K && ke % group == 0) fold(ke / group - 1);
      } else {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16_k8(part[i][j], af[i][2 * hk], af[i][2 * hk + 1], bfr[j][hk]);
            mma_bf16_k8(sx[i], af[i][2 * hk], af[i][2 * hk + 1], BF16_ONES);
          }
          const int ke = k0 + ks + 8 * (hk + 1);
          if (ke <= K && ke % group == 0) fold(ke / group - 1);
        }
      }
      frag_a(la, xs + lm * KS + ks, g, c);
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        uint32_t lb[2];
        frag_b(lb, as + (16 * j + 8 * lr) * KS + ks, g, c);
        mma_bf16(xa[j], la, lb);
      }
    }
  }

  // epilogue: xa^T [RP][BM] and B^T [RP][BTS] in f32 through shared memory;
  // each thread adds sum_r xa[m][r] * B[n][r] (rank order) to its sums
  __syncthreads();
  float* xat = smem;
  float* bt = smem + RP * BM;
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int rk = 16 * j + 8 * lr + 2 * c;
    xat[rk * BM + lm + g] = xa[j][0];
    xat[(rk + 1) * BM + lm + g] = xa[j][1];
    xat[rk * BM + lm + g + 8] = xa[j][2];
    xat[(rk + 1) * BM + lm + g + 8] = xa[j][3];
  }
  // B read along its rows (coalesced), eight loads in flight a thread
#pragma unroll 1
  for (int it = 0; it < RP * BN / NT; it += 8) {
    float bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + (it + i) * NT;
      const int n = idx / RP, rr = idx % RP;
      bv[i] = (rr < r && n0 + n < N)
          ? __bfloat162float(lora_b[(size_t)(n0 + n) * r + rr]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + (it + i) * NT;
      bt[(idx % RP) * BTS + idx / RP] = bv[i];
    }
  }
  __syncthreads();
  float lora[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lora[i][j][e] = 0.f;
  for (int rr = 0; rr < r; ++rr) {
    float av[2][2], bv[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      av[i][0] = xat[rr * BM + wm + 16 * i + g];
      av[i][1] = xat[rr * BM + wm + 16 * i + g + 8];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j][0] = bt[rr * BTS + wn + 8 * j + 2 * c];
      bv[j][1] = bt[rr * BTS + wn + 8 * j + 2 * c + 1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lora[i][j][e] = fmaf(av[i][e >> 1], bv[j][e & 1], lora[i][j][e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + 16 * i + g + 8 * (e >> 1);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * c + (e & 1);
        if (n < N) out[(size_t)m * N + n] = __float2bfloat16(acc[i][j][e] + lora[i][j][e]);
      }
    }
}

template <int BITS, int RT>
int launch_mma(const void* x, const void* packed, const void* scales, const void* zeros,
               const void* a, const void* b, void* out, int M, int K, int N, int group,
               int r, cudaStream_t stream) {
  const int bytes = mma_smem_bytes(RT);
  auto kern = dqmm_lora_mma_kernel<BITS, RT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(out),
      M, K, N, group, r);
  return 0;
}

template <int BITS>
int mma_by_rank(int rt, const void* x, const void* packed, const void* scales,
                const void* zeros, const void* a, const void* b, void* out, int M,
                int K, int N, int group, int r, cudaStream_t s) {
  switch (rt) {
    case 1: return launch_mma<BITS, 1>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 2: return launch_mma<BITS, 2>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 4: return launch_mma<BITS, 4>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 8: return launch_mma<BITS, 8>(x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mma_by_bits(int bits, int rt, const void* x, const void* packed, const void* scales,
                const void* zeros, const void* a, const void* b, void* out, int M,
                int K, int N, int group, int r, cudaStream_t s) {
  switch (bits) {
    case 2: return mma_by_rank<2>(rt, x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 4: return mma_by_rank<4>(rt, x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    case 8: return mma_by_rank<8>(rt, x, packed, scales, zeros, a, b, out, M, K, N, group, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16 input that TMA can address: x @ A once, then TMA + wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- x @ A prologue ---------------------------------------------------------

constexpr int XA_BM = 64;         // rows of x a block
constexpr int XA_BK = 64;         // K rows a staged chunk
constexpr int XA_THREADS = 128;   // 4 warps, 16 rows each
constexpr int XA_STAGES = 5;      // cp.async ring: a split's chunks all in flight
constexpr int XA_XS = XA_BK + 8;  // row stride (bf16) of a staged x chunk

__host__ __device__ constexpr int xa_a_stride(int rt) { return 16 * rt + 8; }
__host__ __device__ constexpr int xa_stage_elems(int rt) {
  return XA_BM * XA_XS + XA_BK * xa_a_stride(rt);
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// xa and the stages' sums for 64 rows of x: block y of a cluster of
// gridDim.y blocks sums the K rows [y * chunk, + chunk), warp w rows
// 16w..16w+15 at all 16 * RT ranks, and each 64-row stage's sum of every
// row of x (one more mma against ones: exact products, f32 sums), written
// as hi = bf16(sum) and lo = bf16(sum - hi) into gz (M, gzw) bf16: stage s
// of correction block b = s / 16 at columns 64 b + s % 16 + {0, 16, 32, 48}
// as hi, lo, hi, lo (the main kernel's B for the block's correction; the
// last block's columns past the last stage zero).  The
// cluster then adds its partial xa sums through distributed shared memory
// in block order (block y reduces an eighth of the rows) and writes hl
// (2M, r) bf16: rows [0, M) hi = bf16(xa), rows [M, 2M) lo = bf16(xa - hi).
// RT = 0 (rank 0): the group sums alone.
template <int RT>
__global__ void __launch_bounds__(XA_THREADS)
xa_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
          bf16* __restrict__ hl, bf16* __restrict__ gz, int M, int K, int r, int chunk,
          int gzw) {
  constexpr int RP = 16 * RT;
  constexpr int AS = xa_a_stride(RT);
  constexpr int NJ = RT > 0 ? 2 * RT : 1;
  extern __shared__ __align__(16) unsigned char xa_raw[];
  bf16* sm = reinterpret_cast<bf16*>(xa_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int m0 = blockIdx.x * XA_BM;
  const int kbeg = blockIdx.y * chunk;
  const int kend = min(K, kbeg + chunk);
  // the main kernel may start now; it waits for this grid's sums itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int nk = (kend - kbeg + XA_BK - 1) / XA_BK;
  const uint32_t ones[2] = {BF16_ONES, BF16_ONES};

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  auto load = [&](int c) {
    bf16* xs = sm + (c % XA_STAGES) * xa_stage_elems(RT);
    bf16* as = xs + XA_BM * XA_XS;
    const int k0 = kbeg + c * XA_BK;
    for (int i = tid; i < XA_BM * (XA_BK / 8); i += XA_THREADS) {
      const int m = i / (XA_BK / 8), kc = (i % (XA_BK / 8)) * 8;
      const bool ok = m0 + m < M && k0 + kc < kend;
      cp_async16(xs + m * XA_XS + kc, ok ? x + (size_t)(m0 + m) * K + k0 + kc : x, ok);
    }
    for (int i = tid; i < XA_BK * (RP / 8); i += XA_THREADS) {
      const int kk = i / (RP / 8), rc = (i % (RP / 8)) * 8;
      const bool ok = k0 + kk < kend && rc < r;
      cp_async16(as + kk * AS + rc, ok ? a + (size_t)(k0 + kk) * r + rc : a, ok);
    }
  };

#pragma unroll
  for (int c = 0; c < XA_STAGES - 1; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<XA_STAGES - 2>();  // this thread's part of chunk c is in
    __syncthreads();                 // everyone's is, and chunk c-1 is done
    if (c + XA_STAGES - 1 < nk) load(c + XA_STAGES - 1);
    cp_async_commit();
    const bf16* xs = sm + (c % XA_STAGES) * xa_stage_elems(RT);
    const bf16* as = xs + XA_BM * XA_XS;
    float gs[4] = {0.f, 0.f, 0.f, 0.f};  // the stage's sums of rows g, g + 8
#pragma unroll
    for (int kk = 0; kk < XA_BK; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, xs + (16 * warp + (lane & 15)) * XA_XS + kk + (lane >> 4) * 8);
      mma_bf16(gs, af, ones);
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, as + (kk + (lane & 15)) * AS + 16 * j + (lane >> 4) * 8);
        mma_bf16(acc[2 * j], af, bfr);
        mma_bf16(acc[2 * j + 1], af, bfr + 2);
      }
    }
    // chunk c is one stage of the main kernel (chunk and K are multiples of
    // 64); lanes cq = 0, 1 write rows g and g + 8 (and past the last stage,
    // the last block's zeros)
    const int st = (kbeg + c * XA_BK) / XA_BK, kt = K / XA_BK;
    const int m = m0 + 16 * warp + g + 8 * (cq & 1);
    if (cq < 2 && m < M) {
      const float v = gs[2 * (cq & 1)];
      const bf16 h = __float2bfloat16(v), l = __float2bfloat16(v - __bfloat162float(h));
      bf16* row = gz + (size_t)m * gzw + 64 * (st / 16);
      for (int u = st % 16; u < (st + 1 == kt ? 16 : st % 16 + 1); ++u) {
        const bool live = u == st % 16;
        row[u] = row[32 + u] = live ? h : __float2bfloat16(0.f);
        row[16 + u] = row[48 + u] = live ? l : __float2bfloat16(0.f);
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (RT > 0) {
    // this block's partial sums, [64][RP] f32, over its staging buffers
    __syncthreads();
    float* part = reinterpret_cast<float*>(xa_raw);
#pragma unroll
    for (int j = 0; j < 2 * RT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(16 * warp + g + 8 * (e >> 1)) * RP + 8 * j + 2 * cq + (e & 1)] = acc[j][e];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int splits = gridDim.y;
    const int rows = (XA_BM + splits - 1) / splits;
    const int mlo = blockIdx.y * rows;
    for (int e = tid; e < rows * r; e += XA_THREADS) {
      const int m = mlo + e / r, rr = e % r;
      if (m >= XA_BM || m0 + m >= M) continue;
      float v = 0.f;
      for (int s = 0; s < splits; ++s) v += cluster.map_shared_rank(part, s)[m * RP + rr];
      const bf16 h = __float2bfloat16(v);
      hl[(size_t)(m0 + m) * r + rr] = h;
      hl[(size_t)(M + m0 + m) * r + rr] = __float2bfloat16(v - __bfloat162float(h));
    }
    cluster.sync();  // no block leaves while another reads its partial sums
  }
}

// --- TMA, mbarrier and wgmma ------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// arrive where `on` (one lane of a warp): a predicated arrive, no branch
// (ptxas serializes the wgmmas in flight across a divergent branch)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
               "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
               :: "r"(smem_u32(bar)), "r"((int)on) : "memory");
}
// spin until the barrier's phase of this parity completes, the loop inside
// the asm (no branch of the program's own); a wait that outlasts any real
// stage by far traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.eq.u32 p, n, 67108864;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
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
__device__ __forceinline__ void mma_warpgroups_sync() {  // warps 0-7
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator reads across wgmma issue/wait
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// keep a wgmma's A registers alive (unmoved, unreused) until here: after
// the wait that retires the wgmmas reading them
template <int R> __device__ __forceinline__ void fence_frag(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// descriptor of a K-major bf16 tile in shared memory, rows of 64 values
// (128 bytes) under the 128-byte swizzle, 8-row groups 1024 bytes apart;
// the tile starts 1024-byte aligned and +2 steps 16 K columns (32 bytes)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x N, f32) = a (64 x 16) @ b (16 x N) + (scale_d ? d : 0), a in
// registers (the thread's fragment: rows g and g + 8 of its warp's 16, as
// mma.sync's), b K-major in shared memory (128-byte swizzle), bf16 operands
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int CT>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  if constexpr (CT == 64) wgmma_rs_n64(d, a, db, scale_d);
  else wgmma_rs_n32(d, a, db, scale_d);
}
// --- the main kernel --------------------------------------------------------

constexpr int WG_BN = 128;          // output columns a tile: two warpgroups of 64
constexpr int WG_BK = 64;           // K rows a stage: one swizzled 128-byte row of x
constexpr int WG_CB = 16;           // stages a zero-correction block
static_assert(WG_CB == 16, "the prologue (xa_kernel) lays out 16 stages a block");
constexpr int WG_CONSUMERS = 256;   // two warpgroups run the wgmmas,
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // one loads (two of its warps)
constexpr int WG_WS = 6;            // code slots
constexpr int CZ_STRIDE = 80;       // bytes a row of the correction table (padded)
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can have
// registers a thread after setmaxnreg: the loading warpgroup gives its
// registers up, the two consumers (the tile's sums, two chunks' stage
// sums, two stages' A fragments: 168 at BT 128) take them:
// 128 x 40 + 256 x 232 = 64512 of 65536
constexpr int REG_LOAD = 40, REG_MMA = 232;

// The shared memory of one (BITS, BT) instance, from 1024-byte alignment:
// the x ring (XS tiles of BT rows of 64 values, 128-byte swizzle: x's
// stages, each correction block's sums of x, then [hi | lo]'s), the code
// ring (WG_WS slots: a stage's packed codes for the tile's 128 columns,
// 128-byte rows under the 128-byte swizzle, then its group's scale and zero
// rows), the tile's LoRA B (two 64-rank chunks of 128 rows, 128-byte
// swizzle; the epilogue's staging after the LoRA stages), the correction
// table (a block's -s * (z - round(z)) of every column, hi and lo bf16),
// the barriers.  x tiles come back when the wgmmas that read them are
// done, code slots as soon as their fragments are in registers.
template <int BITS, int BT> struct WgLayout {
  static constexpr int PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  static constexpr int X_BYTES = BT * WG_BK * 2;              // x (or [hi | lo]) tile
  static constexpr int CODE_BYTES = WG_BK / PER * WG_BN;
  static constexpr int SC = CODE_BYTES;                       // the scale row in a slot
  static constexpr int ZR = SC + WG_BN * 4;                   // the zero row
  static constexpr int W_BYTES = (ZR + WG_BN * 4 + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = WG_BN * WG_BK * 2;           // a LoRA B chunk
  static constexpr int CZ_BYTES = WG_BN * CZ_STRIDE;          // the correction table
  static constexpr int FIXED = 1024 + 512 + WG_WS * W_BYTES + 2 * B_BYTES + CZ_BYTES;
  static constexpr int XS_FIT = (SMEM_LIMIT - FIXED) / X_BYTES;
  static constexpr int XS = XS_FIT < 8 ? XS_FIT : 8;
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = X_OFF + XS * X_BYTES;
  static constexpr int LB_OFF = W_OFF + WG_WS * W_BYTES;
  static constexpr int CZ_OFF = LB_OFF + 2 * B_BYTES;
  static constexpr int BAR_OFF = CZ_OFF + CZ_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 512;
  static_assert(XS >= 4 && SMEM <= SMEM_LIMIT, "shared memory");
  static_assert(BT * 128 <= B_BYTES, "a warpgroup's output staging fits a LoRA B chunk");
};

// One stage's A fragments (64 K rows: four k16 steps) for this thread's
// columns col and col + 1 (col even) of the 16-column group `chunk` of the
// tile, from a slot of packed codes (row p of 128 bytes holds K rows
// p * PER ..; its 16-byte chunk c lies at chunk c ^ (p % 8): the 128-byte
// swizzle): both columns' bytes in one 16-bit load.  Each code is taken
// exactly in bf16 (code_pair: 128 + code at 2 and 4 bits, the code at 8)
// and zz[h], the column's 128 + round(z) (round(z) at 8 bits), taken off
// in bf16, exactly: the fragments hold code - round(z), an integer of at
// most 255 in size.  a[4 kk + 2 q + h] holds column col + h at K rows
// 16 kk + 8 q + 2 cq and the next: the A fragment of a m64nNk16 whose rows
// g and g + 8 are columns col and col + 1 (K columns 2 cq, 2 cq + 1, then
// + 8).
template <int BITS> struct CodeWords {
  static constexpr uint32_t PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  uint32_t w[PER == 1 ? 16 : 8];
};

// One stage's packed bytes for this thread's columns col and col + 1 (col
// even) of the 16-column group `chunk` of the tile: a slot's row p of 128
// bytes holds K rows p * PER ..; its 16-byte chunk c lies at chunk
// c ^ (p % 8) (the 128-byte swizzle); both columns' bytes in one 16-bit
// load, the rows that hold K rows 16 kk + 8 q + 2 cq and the next.
template <int BITS>
__device__ __forceinline__ void code_words(CodeWords<BITS>& cw, const unsigned char* slot,
                                           uint32_t chunk, uint32_t col, uint32_t cq) {
  constexpr uint32_t PER = CodeWords<BITS>::PER;
  auto word = [&](uint32_t p) {
    return (uint32_t)*reinterpret_cast<const uint16_t*>(
        slot + p * 128 + (((chunk ^ (p & 7)) << 4) | col));
  };
#pragma unroll
  for (uint32_t kq = 0; kq < 8; ++kq) {  // kq = 2 kk + q: K rows 8 kq + 2 cq, + 1
    const uint32_t p = (8 * kq) / PER + (2 * cq) / PER;
    cw.w[PER == 1 ? 2 * kq : kq] = word(p);
    if constexpr (PER == 1) cw.w[2 * kq + 1] = word(p + 1);
  }
}

// The A fragments of those words: each code exact in bf16 (code_pair: 128 +
// code at 2 and 4 bits, the code at 8) and zz[h], the column's 128 +
// round(z) (round(z) at 8 bits), taken off in bf16, exactly: code -
// round(z), an integer of at most 255 in size.  a[4 kk + 2 q + h] holds
// column col + h at K rows 16 kk + 8 q + 2 cq and the next: the A fragment
// of a m64nNk16 whose rows g and g + 8 are columns col and col + 1 (K
// columns 2 cq, 2 cq + 1, then + 8).
template <int BITS>
__device__ __forceinline__ void code_frags(uint32_t (&a)[16], const CodeWords<BITS>& cw,
                                           uint32_t cq, const __nv_bfloat162 (&zz)[2]) {
  constexpr uint32_t PER = CodeWords<BITS>::PER;
  constexpr uint32_t MASK = BITS == 8 ? 0xFFu : ((1u << BITS) - 1u);
  const uint32_t sh = BITS * ((2 * cq) % PER);
#pragma unroll
  for (uint32_t kq = 0; kq < 8; ++kq) {
    const uint32_t w0 = cw.w[PER == 1 ? 2 * kq : kq];
    const uint32_t w1 = PER == 1 ? cw.w[2 * kq + 1] : w0;
#pragma unroll
    for (uint32_t h = 0; h < 2; ++h) {
      uint32_t v = code_pair<BITS>((w0 >> (8 * h + sh)) & MASK,
                                   (w1 >> (8 * h + sh + (PER == 1 ? 0 : BITS))) & MASK);
      const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), zz[h]);
      a[2 * kq + h] = *reinterpret_cast<const uint32_t*>(&d);
    }
  }
}

// Persistent: block b walks tiles b, b + gridDim.x, ... (token tile
// fastest, so the blocks in flight share code tiles in L2).  A tile is
// 128 output columns by BT rows of x, computed transposed: y^T = W^T x^T.
// Warpgroup wg (warps 4 wg .. 4 wg + 3) owns the tile's columns
// 64 wg .. 64 wg + 63 as the 64 rows of its wgmmas (warp w's thread (g, cq)
// the columns 16 w + 2 g and the next as its rows g and g + 8: one 16-bit
// load of packed codes holds both), and splits the BT rows of x into
// two chunks of CT = BT / 2 as the wgmmas' N.  Warps 8 and 9 load (one
// thread each): the x ring, the code ring with each tile's LoRA B.
//
// The zero is split: z = zi + zf, zi = round(z) (clamped so that the codes
// stay exact), zf the rest.  A weight stage (64 K rows) is, for each chunk,
// four wgmmas m64nCTk16 with A from registers (code - zi, exact in bf16,
// built from the slot by code_frags) and B the x tile from shared memory,
// into the chunk's `part`: x @ (codes - zi) in f32 sums of exact products.
// Each chunk is folded into the tile's sums `acc` with the stage's scale,
// one f32 FMA an element: acc += s * part.  What zf leaves out,
// sum over stages of -s * zf * sum(x over the stage), is a product of rank
// K / 64: every WG_CB stages it runs on the tensor cores as one more stage
// of four k16 steps, A = [c_hi | c_hi | c_lo | c_lo] of c = -s * zf (each
// thread's columns, written to the correction table as it loads each
// stage's scale and zero, read back by ldmatrix) against B = [g_hi | g_lo
// | g_hi | g_lo] of the block's sums of x (the prologue's, by TMA through
// the x ring), into acc: bf16 products of 16-bit halves, so the
// correction, small beside the sums (|zf| <= 1/2 where z is in range),
// keeps about 16 bits.  The weight is the reference's f32 (c - z) * s; no
// bf16 weight ever forms.  A stage issues both chunks' wgmmas (and, at a
// correction block's last stage, the correction's) at once, loads the
// next stage's packed words, scales and zeros, waits, folds both chunks and
// builds the next stage's fragments: a wgmma with A in registers holds its
// SM sub-partition's warps until the tensor cores take it, so a fold does
// not overlap the other chunk's wgmmas anyway (PERF.md §6).  The LoRA
// stages (LoRA B's rows as A, by ldmatrix from its TMA tile in the same
// column order; [hi | lo] as B) add unscaled into acc.
// Every wgmma and every read of the accumulators stays out of divergent
// code (ptxas serializes the wgmmas otherwise): arrives are predicated,
// barrier waits spin inside their asm.
template <int BITS, int BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
dqmm_lora_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_p,
                       const __grid_constant__ CUtensorMap tm_s,
                       const __grid_constant__ CUtensorMap tm_z,
                       const __grid_constant__ CUtensorMap tm_gz,
                       const __grid_constant__ CUtensorMap tm_xa,
                       const __grid_constant__ CUtensorMap tm_b,
                       bf16* __restrict__ out, int M, int K, int N, int group, int r) {
  using L = WgLayout<BITS, BT>;
  constexpr int XS = L::XS, WS = WG_WS;
  constexpr int CT = BT / 2;      // rows of x a chunk: the wgmmas' N
  constexpr int NA = CT / 2;      // f32 accumulators a thread a chunk
  constexpr float OFF = BITS < 8 ? CODE_OFF : 0.f;
  // round(z) is clamped so that OFF + zi and code - zi are exact in bf16
  constexpr float ZI_LO = BITS < 8 ? -128.f : 0.f, ZI_HI = BITS < 8 ? 128.f : 255.f;
  constexpr int MMA_WARPS = WG_CONSUMERS / 32;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* base = wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* xempty = xfull + XS;
  uint64_t* wfull = xempty + XS;
  uint64_t* wempty = wfull + WS;
  uint64_t* lbfull = wempty + WS;
  uint64_t* lbempty = lbfull + 1;
  auto x_tile = [&](int i) { return base + L::X_OFF + (i % XS) * L::X_BYTES; };
  auto w_slot = [&](int j) { return base + L::W_OFF + (j % WS) * L::W_BYTES; };
  unsigned char* lb = base + L::LB_OFF;
  unsigned char* cz = base + L::CZ_OFF;

  const int kt = K / WG_BK;
  const int gst = group / WG_BK;  // stages a group
  const int rt = (r + WG_BK - 1) / WG_BK;
  const int tiles_m = (M + BT - 1) / BT;
  const int tiles = tiles_m * ((N + WG_BN - 1) / WG_BN);
  // the warp (uniform across its lanes, as the compiler can see)
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < XS; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], MMA_WARPS);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], MMA_WARPS);
    }
    mbar_init(lbfull, 1);
    mbar_init(lbempty, MMA_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the correction table starts at zero: a tile's last block may hold
  // fewer than WG_CB stages, whose sums of x the prologue wrote as zero
  for (int e = threadIdx.x; e < L::CZ_BYTES / 4; e += WG_THREADS)
    reinterpret_cast<uint32_t*>(cz)[e] = 0u;
  __syncthreads();

  if (warp >= MMA_WARPS) {  // loaders: one thread of warps 8 and 9
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REG_LOAD));
    if (lane != 0 || warp > MMA_WARPS + 1) return;
    int i = 0, j = 0, q = 0;  // x stages, weight stages, tiles issued
    bool waited = false;      // for the prologue's grid
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
      const int m0 = (t % tiles_m) * BT, n0 = (t / tiles_m) * WG_BN;
      if (warp == MMA_WARPS) {
        // x tiles, each correction block's sums of x after its last stage,
        // then [hi | lo]: hi rank chunks, then lo
        auto next = [&]() -> uint64_t* {
          uint64_t* bar = &xfull[i % XS];
          if (i >= XS) mbar_wait(&xempty[i % XS], ((i / XS) - 1) & 1);
          mbar_expect_tx(bar, L::X_BYTES);
          return bar;
        };
        for (int ks = 0; ks < kt; ++ks) {
          uint64_t* bar = next();
          tma_load(x_tile(i++), &tm_x, bar, ks * WG_BK, m0);
          if (ks % WG_CB == WG_CB - 1 || ks + 1 == kt) {
            bar = next();
            if (!waited) asm volatile("griddepcontrol.wait;\n" ::: "memory");
            waited = true;
            tma_load(x_tile(i++), &tm_gz, bar, (ks / WG_CB) * 64, m0);
          }
        }
        for (int l = 0; l < 2 * rt; ++l) {
          uint64_t* bar = next();
          tma_load(x_tile(i++), &tm_xa, bar, (l % rt) * WG_BK, (l / rt) * M + m0);
        }
      } else {  // codes, scales and zeros; the tile's LoRA B
        for (int ks = 0; ks < kt; ++ks, ++j) {
          uint64_t* bar = &wfull[j % WS];
          if (j >= WS) mbar_wait(&wempty[j % WS], ((j / WS) - 1) & 1);
          mbar_expect_tx(bar, L::CODE_BYTES + 2 * WG_BN * 4);
          const int srow = ks / gst;
          tma_load(w_slot(j), &tm_p, bar, n0, ks * WG_BK / L::PER);
          tma_load(w_slot(j) + L::SC, &tm_s, bar, n0, srow);
          tma_load(w_slot(j) + L::ZR, &tm_z, bar, n0, srow);
        }
        if (rt > 0) {
          if (q > 0) mbar_wait(lbempty, (q - 1) & 1);
          mbar_expect_tx(lbfull, rt * L::B_BYTES);
          for (int c = 0; c < rt; ++c)
            tma_load(lb + c * L::B_BYTES, &tm_b, lbfull, c * WG_BK, n0);
        }
      }
    }
    return;
  }

  // the two wgmma warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REG_MMA));
  const int wg = warp >> 2;
  const int g = lane >> 2, cq = lane & 3;
  // the thread's accumulator rows g and g + 8 are the tile's columns na
  // and na + 1
  const int na = 64 * wg + 16 * (warp & 3) + 2 * g;
  // ldmatrix of a 16 x 16 A block in this column order: lane l reads row
  // n(l) of matrix l / 8 (h its bit 0, the K half its bit 1)
  const int ln = 64 * wg + 16 * (warp & 3) + 2 * (lane & 7) + ((lane >> 3) & 1);
  const int lk = lane >> 4;
  float acc[2][NA], part[2][NA];
  uint32_t frag[2][16];   // two stages' A fragments
  uint32_t cfr[8];        // a correction's A fragments: c_hi, c_lo
  float2 sv[2];           // their scales at columns na, na + 1

  // weight stage j (stage ks of its tile) into buffer b, in two steps:
  // fetch (the slot's packed words, scales and zeros into registers; the
  // slot back) before the wait for the stage before's wgmmas, convert (zi
  // and zf of the thread's columns, the fragments of code - zi, -s * zf as
  // hi and lo bf16 into the correction table) after its folds
  CodeWords<BITS> cw;
  float2 z2;
  auto fetch = [&](auto bc, int j) {
    constexpr int b = decltype(bc)::value;
    const unsigned char* slot = w_slot(j);
    mbar_wait(&wfull[j % WS], (j / WS) & 1);
    sv[b] = *reinterpret_cast<const float2*>(slot + L::SC + 4 * na);
    z2 = *reinterpret_cast<const float2*>(slot + L::ZR + 4 * na);
    code_words<BITS>(cw, slot, na >> 4, na & 15, cq);
    __syncwarp();
    mbar_arrive_if(&wempty[j % WS], lane == 0);
  };
  auto convert = [&](auto bc, int ks) {
    constexpr int b = decltype(bc)::value;
    const float zi0 = fminf(fmaxf(rintf(z2.x), ZI_LO), ZI_HI);
    const float zi1 = fminf(fmaxf(rintf(z2.y), ZI_LO), ZI_HI);
    const __nv_bfloat162 zz[2] = {__float2bfloat162_rn(OFF + zi0),
                                  __float2bfloat162_rn(OFF + zi1)};
    code_frags<BITS>(frag[b], cw, cq, zz);
    const float c0 = -sv[b].x * (z2.x - zi0), c1 = -sv[b].y * (z2.y - zi1);
    const bf16 h0 = __float2bfloat16(c0), h1 = __float2bfloat16(c1);
    const int u = ks % WG_CB;
    bf16* row = reinterpret_cast<bf16*>(cz + na * CZ_STRIDE);
    row[u] = h0;
    row[WG_CB + u] = __float2bfloat16(c0 - __bfloat162float(h0));
    row[CZ_STRIDE / 2 + u] = h1;
    row[CZ_STRIDE / 2 + WG_CB + u] = __float2bfloat16(c1 - __bfloat162float(h1));
  };
  // a chunk's stage sums into acc: columns na (e < 2) and na + 1
  auto fold = [&](float (&a)[NA], float (&p)[NA], float2 s) {
#pragma unroll
    for (int e = 0; e < NA; ++e) a[e] = fmaf((e & 3) < 2 ? s.x : s.y, p[e], a[e]);
  };

  int i = 0, j = 0, q = 0;  // x stages, weight stages, tiles
  int rel = 0;              // the first x stage not yet handed back
  // hand back every x stage before `upto` (predicated: no branch)
  auto release = [&](int upto) {
    for (; rel < upto; ++rel) mbar_arrive_if(&xempty[rel % XS], lane == 0);
  };
  // weight stage ks of the tile (x stage i, weight stage j), its fragments
  // in buffer b = ks % 2 (built a stage before): its wgmmas, both chunks
  // into `part` (and, at a correction block's last stage, the correction
  // into acc: A from the table by ldmatrix, k16 steps c_hi, c_hi, c_lo,
  // c_lo against the next x stage, g_hi, g_lo, g_hi, g_lo); the next
  // stage's words; the wait; the folds; the next stage's fragments
  auto stage = [&](auto bc, int ks) {
    constexpr int b = decltype(bc)::value;
    const bool corr = ks % WG_CB == WG_CB - 1 || ks + 1 == kt;
    mbar_wait(&xfull[i % XS], (i / XS) & 1);
    const uint64_t dx = sw128_desc(x_tile(i++));
    uint64_t dg = 0;
    if (corr) {
      mbar_wait(&xfull[i % XS], (i / XS) & 1);
      dg = sw128_desc(x_tile(i++));
      __syncwarp();
      const unsigned char* tab = cz + ln * CZ_STRIDE;
      ldsm_x4(cfr, tab + lk * 16);
      ldsm_x4(cfr + 4, tab + 32 + lk * 16);
    }
    fence_acc(part[0]);
    fence_acc(part[1]);
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {  // a stage's first product overwrites
      wgmma_rs<CT>(part[0], frag[b] + 4 * kk, dx + 2 * kk, kk > 0);
      wgmma_rs<CT>(part[1], frag[b] + 4 * kk, dx + CT * 8 + 2 * kk, kk > 0);
    }
    if (corr) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<CT>(acc[0], cfr + 4 * (kk >> 1), dg + 2 * kk, 1);
        wgmma_rs<CT>(acc[1], cfr + 4 * (kk >> 1), dg + CT * 8 + 2 * kk, 1);
      }
    }
    wgmma_commit();
    if (ks + 1 < kt) fetch(std::integral_constant<int, b ^ 1>{}, j + 1);
    wgmma_wait<0>();
    fence_acc(part[0]);
    fence_acc(part[1]);
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    fence_frag(frag[b]);
    fence_frag(cfr);
    fold(acc[0], part[0], sv[b]);
    fold(acc[1], part[1], sv[b]);
    release(i);
    if (ks + 1 < kt) convert(std::integral_constant<int, b ^ 1>{}, ks + 1);
    ++j;
  };

  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
    const int m0 = (t % tiles_m) * BT, n0 = (t / tiles_m) * WG_BN;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < NA; ++e) acc[c][e] = 0.f;
    fetch(std::integral_constant<int, 0>{}, j);
    convert(std::integral_constant<int, 0>{}, 0);
    for (int ks = 0; ks < kt; ks += 2) {
      stage(std::integral_constant<int, 0>{}, ks);
      if (ks + 1 < kt) stage(std::integral_constant<int, 1>{}, ks + 1);
    }
    if (rt > 0) {  // the LoRA stages, unscaled, into the tile's sums
      auto lora_stage = [&](auto bc, int l) {
        constexpr int b = decltype(bc)::value;
        mbar_wait(&xfull[i % XS], (i / XS) & 1);
        const unsigned char* bt = lb + (l % rt) * L::B_BYTES + ln * 128;
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          ldsm_x4(frag[b] + 4 * kk, bt + (((2 * kk + lk) ^ (ln & 7)) << 4));
        const uint64_t db = sw128_desc(x_tile(i++));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          wgmma_rs<CT>(acc[0], frag[b] + 4 * kk, db + 2 * kk, 1);
          wgmma_rs<CT>(acc[1], frag[b] + 4 * kk, db + CT * 8 + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_frag(frag[b]);
        release(i);
      };
      mbar_wait(lbfull, q & 1);
      for (int l = 0; l < 2 * rt; l += 2) {
        lora_stage(std::integral_constant<int, 0>{}, l);
        lora_stage(std::integral_constant<int, 1>{}, l + 1);
      }
      fence_acc(acc[0]);
      fence_acc(acc[1]);
    }
    // the sums in bf16 through the LoRA B chunks, once both warpgroups'
    // wgmmas are done with them: warpgroup wg's 64 columns as BT rows of
    // 128 bytes, 16-byte chunks XOR-swizzled by row; then out in
    // coalesced 16-byte stores
    mma_warpgroups_sync();
    unsigned char* stage_out = lb + wg * L::B_BYTES;
    const int cl = na - 64 * wg;  // the thread's columns in the warpgroup's 64
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int jj = 0; jj < CT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // row 8 jj + 2 cq + e: columns cl, cl + 1
          const int row = c * CT + 8 * jj + 2 * cq + e;
          *reinterpret_cast<__nv_bfloat162*>(stage_out + row * 128 +
                                             (((cl >> 3) ^ (row & 7)) << 4) + (cl & 7) * 2) =
              __floats2bfloat162_rn(acc[c][4 * jj + e], acc[c][4 * jj + 2 + e]);
        }
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
    for (int c = threadIdx.x & 127; c < BT * 8; c += 128) {
      const int row = c >> 3, ch = c & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(stage_out + row * 128 +
                                                      ((ch ^ (row & 7)) << 4));
      const int col = n0 + 64 * wg + 8 * ch;
      if (m0 + row < M && col < N)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + row) * N + col) = v;
    }
    // the staging is read; the next tile's LoRA B may land there (and the
    // next tile's sums are staged only after its own LoRA stages)
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
    mbar_arrive_if(lbempty, rt > 0 && lane == 0);
  }
}

// --- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
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
// Returns 0, or ENCODE_FAILED + the driver's CUresult.
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

template <int RT>
int launch_xa(const void* x, const void* a, void* hl, void* gz, int M, int K, int r,
              int splits, int chunk, int gzw, cudaStream_t s) {
  const int bytes = XA_STAGES * xa_stage_elems(RT) * 2;
  auto kern = xa_kernel<RT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + XA_BM - 1) / XA_BM, splits);
  cfg.blockDim = dim3(XA_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(x),
                                 static_cast<const bf16*>(a), static_cast<bf16*>(hl),
                                 static_cast<bf16*>(gz), M, K, r, chunk, gzw);
}

template <int BITS, int BT>
int launch_wgmma(const void* x, const void* packed, const void* scales, const void* zeros,
                 const void* b, const void* hl, const void* gz, void* out, int M, int K,
                 int N, int group, int r, int gzw, int grid, cudaStream_t s) {
  constexpr int PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  CUtensorMap mx, mp_, ms, mz, mg, mxa, mb;
  memset(&mxa, 0, sizeof(mxa));
  memset(&mb, 0, sizeof(mb));
  int rc = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2ull * K, WG_BK, BT,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc) rc = make_map(&mp_, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, N, K / PER, N, WG_BN,
                         WG_BK / PER, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc) rc = make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, N, K / group,
                         4ull * N, WG_BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!rc) rc = make_map(&mz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, zeros, N, K / group,
                         4ull * N, WG_BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!rc) rc = make_map(&mg, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, gz, gzw, M, 2ull * gzw,
                         64, BT, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc && r > 0)
    rc = make_map(&mxa, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, hl, r, 2ull * M, 2ull * r,
                  WG_BK, BT, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc && r > 0)
    rc = make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, r, N, 2ull * r, WG_BK, WG_BN,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  auto kern = dqmm_lora_wgmma_kernel<BITS, BT>;
  constexpr int smem = WgLayout<BITS, BT>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // overlap the
  attr[0].val.programmaticStreamSerializationAllowed = 1;            // prologue's tail
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, mx, mp_, ms, mz, mg, mxa, mb,
                                 static_cast<bf16*>(out), M, K, N, group, r);
}

int wgmma_by_bits(int bits, int bt, const void* x, const void* packed, const void* scales,
                  const void* zeros, const void* b, const void* hl, const void* gz,
                  void* out, int M, int K, int N, int group, int r, int gzw, int grid,
                  cudaStream_t s) {
#define DQ_WG(B, T)                                                                   \
  if (bits == B && bt == T)                                                           \
    return launch_wgmma<B, T>(x, packed, scales, zeros, b, hl, gz, out, M, K, N, group, \
                              r, gzw, grid, s);
  DQ_WG(2, 128) DQ_WG(4, 128) DQ_WG(8, 128) DQ_WG(2, 64) DQ_WG(4, 64) DQ_WG(8, 64)
#undef DQ_WG
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the shapes and pointers the wgmma route can address (lora_plan's rule)
bool wgmma_ok(const void* x, const void* packed, const void* scales, const void* zeros,
              const void* a, const void* b, int K, int N, int group, int r) {
  return K % 8 == 0 && N % 16 == 0 && r % 8 == 0 && group % WG_BK == 0 &&
         aligned16(x) && aligned16(packed) &&
         aligned16(scales) && aligned16(zeros) && (r == 0 || (aligned16(a) && aligned16(b)));
}

int xa_by_rank(int rt, const void* x, const void* a, void* hl, void* gz, int M, int K,
               int r, int splits, int chunk, int gzw, cudaStream_t s) {
  switch (rt) {
    case 0: return launch_xa<0>(x, a, hl, gz, M, K, r, splits, chunk, gzw, s);
    case 1: return launch_xa<1>(x, a, hl, gz, M, K, r, splits, chunk, gzw, s);
    case 2: return launch_xa<2>(x, a, hl, gz, M, K, r, splits, chunk, gzw, s);
    case 4: return launch_xa<4>(x, a, hl, gz, M, K, r, splits, chunk, gzw, s);
    case 8: return launch_xa<8>(x, a, hl, gz, M, K, r, splits, chunk, gzw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K), lora_a (K, r), lora_b (N, r) and out (M, N), all f32 or all
// bf16 (is_bf16 != 0); packed (K*bits/8, N) uint8; scales/zeros (K/group, N)
// f32.  All contiguous.  0 <= r <= 128.  Routes, as
// kernels/dequant_matmul.py `lora_plan` picks them:
//   0 fma:   CUDA-core f32 FMAs on the f32 weight, 64 x 128 tiles (f32 x,
//            and bf16 x whose group is not a multiple of 8);
//   1 mma:   bf16, mma.sync on exact codes, 64 x 128 tiles, group % 8 == 0;
//   2 wgmma: bf16, the prologue (K cut into xa_splits <= 8 ranges of
//            xa_chunk rows summed by a cluster): each 64-row stage's sums
//            of x as hi and lo into xa_g (M, 64 ceil(K / 1024)) bf16, and
//            x @ A into xa_hl (2M, r) bf16 when r > 0; then `grid` persistent blocks
//            over tiles of bm rows of x (64 or 128) by 128 output columns.
//            The shapes and pointers must pass wgmma_ok (group % 64 == 0
//            among them).
// Returns 0, a cudaError_t code, or 10000 + the CUresult of a tensor map
// that could not be encoded.
extern "C" int dqmm_lora_launch(const void* x, const void* packed, const void* scales,
                                const void* zeros, const void* lora_a,
                                const void* lora_b, void* out, void* xa_hl, void* xa_g,
                                int M, int K, int N, int bits, int group, int r,
                                int route, int is_bf16, int bm, int grid, int xa_splits,
                                int xa_chunk, void* stream) {
  const int per = bits == 2 ? 4 : (bits == 4 ? 2 : 1);
  if (M < 1 || K < 1 || N < 1 || group < 1 || K % group || K % per || r < 0 ||
      r > 16 * MAX_RPT || (route != 0 && !is_bf16))
    return (int)cudaErrorInvalidValue;
  const int need = r <= 16 ? 1 : (r <= 32 ? 2 : (r <= 64 ? 4 : 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (route == 2) {
    const int gzw = (K / WG_BK + WG_CB - 1) / WG_CB * 4 * WG_CB;  // bf16 a row of xa_g
    if (!wgmma_ok(x, packed, scales, zeros, lora_a, lora_b, K, N, group, r) || grid < 1 ||
        (bm != 64 && bm != 128) || !xa_g || !aligned16(xa_g) || xa_splits < 1 ||
        xa_splits > 8 || xa_chunk < 1 || xa_chunk % XA_BK ||
        (long long)xa_splits * xa_chunk < K || (r > 0 && (!xa_hl || !aligned16(xa_hl))))
      return (int)cudaErrorInvalidValue;
    rc = xa_by_rank(r > 0 ? need : 0, x, lora_a, xa_hl, xa_g, M, K, r, xa_splits, xa_chunk,
                    gzw, s);
    if (!rc)
      rc = wgmma_by_bits(bits, bm, x, packed, scales, zeros, lora_b, xa_hl, xa_g, out, M, K,
                         N, group, r, gzw, grid, s);
  } else if (route == 0 || route == 1) {
    if ((M + BM - 1) / BM > 65535 || (route == 1 && group % 8)) return (int)cudaErrorInvalidValue;
    if (route == 1)
      rc = mma_by_bits(bits, need, x, packed, scales, zeros, lora_a, lora_b, out, M, K, N,
                       group, r, s);
    else if (is_bf16)
      rc = by_bits<bf16>(bits, need, x, packed, scales, zeros, lora_a, lora_b, out, M, K, N,
                         group, r, s);
    else
      rc = by_bits<float>(bits, need, x, packed, scales, zeros, lora_a, lora_b, out, M, K,
                          N, group, r, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
