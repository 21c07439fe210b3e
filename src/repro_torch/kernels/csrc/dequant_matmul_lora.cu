// Fused dequantize x matmul plus LoRA for packed INT2/INT4/INT8 weights,
// sm_90a:  y = x @ ((codes - z) * s) + (x @ A) @ B^T.
//
// Replaces the Pallas TPU kernel `dequant_matmul_lora` in
// src/repro/kernels/dequant_matmul.py (`_kernel_lora`): the base product and
// x @ A accumulated in f32 in one sweep over K, the LoRA term added after
// the sweep, output in x's type.
//
// What bounds it on the H100: operations.  In LoRA fine-tuning the forward
// of every quantized linear has M = 1024 tokens (batch 8 x 128), so each
// packed weight byte feeds 2 * 1024 multiply-adds per code; one training
// forward of Qwen3-1.7B is about 3.0 TFLOP against under 4 GB of traffic.
// What the design does about it: it tiles M as well as N, so every
// dequantized weight value is reused by 64 rows of x from shared memory
// (the decode kernel in dequant_matmul.cu takes at most 8 rows and would
// stream the weight 128 times at this M), and it runs the products where
// the card's operations are:
//  * bf16 x (the training path): mma.sync m16n8k16 on the tensor cores,
//    bf16 operands and f32 sums.  x and A are bf16 already, so x @ A is
//    exact products summed in f32; the weight is dequantized in f32 and
//    rounded to bf16 once, which the reference's bf16 tolerance (2e-2)
//    admits.
//  * f32 x: f32 FMAs on the CUDA cores (67 TFLOP/s), the only way to the
//    reference's f32 tolerance (2e-4) with no TF32; each thread keeps a
//    4 x 8 register micro-tile so two 16-byte shared-memory reads feed 32
//    FMAs.
// Like the TPU kernel, each N tile recomputes its rows' x @ A
// (N/128 * 2*M*K*r extra operations, half the base work at r = 64).
//
// Design, both paths:
//  * One block of 256 threads per 64 x 128 output tile.  The K sweep runs
//    in chunks of 32: the x chunk is staged (transposed for f32), the weight
//    chunk is unpacked and dequantized once into shared memory ((c - z) * s
//    in f32, scale and zero fetched at group boundaries only; stored by
//    column in bf16 for the mma path), and the A chunk is staged beside it.
//  * f32: thread (ty, tx) owns rows 4ty..4ty+3, columns 4tx..4tx+3 and
//    64+4tx..64+4tx+3, and x @ A for its 4 rows at ranks tx, tx+16, ...
//    bf16: warp w owns the 32 x 32 piece (w % 2, w / 2) of the tile
//    (2 x 4 mma tiles), and x @ A for rows 16 (w % 4) .. + 16 at the
//    8-rank tiles w / 4, w / 4 + 2, ...
//  * What holds the bf16 path back is memory latency, not the tensor
//    cores: a chunk's products take a few hundred cycles, its loads far
//    more.  So each thread loads the next chunk's x, A, packed words,
//    scale and zero into registers, all at once, before the current
//    chunk's products, and up to rank 64 two blocks share an SM.  A deeper
//    pipeline (cp.async or TMA stages, wgmma) is the next step.
//  * After the sweep x @ A and the B tile go through shared memory in f32
//    (ranks outermost) and each thread adds sum_r xa[m][r] * B[n][r] to
//    its base sums, in rank order, with f32 FMAs.
//  * No atomics and a fixed summation order: the same bits on every run.
// Every M >= 1, ragged N and K, bits in {2, 4, 8} (3-bit codes are stored
// raw and arrive as 8), any group size dividing K, and ranks 0..128 are
// taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// two blocks an SM up to rank 64 (at most 128 registers a thread), so one
// block's products run while the other waits on its next chunk
template <int BITS, int RT>
__global__ void __launch_bounds__(NT, RT <= 4 ? 2 : 1)
dqmm_lora_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales, const float* __restrict__ zeros,
                     const bf16* __restrict__ lora_a, const bf16* __restrict__ lora_b,
                     bf16* __restrict__ out, int M, int K, int N, int group, int r) {
  constexpr int PER = BITS == 2 ? 4 : (BITS == 4 ? 2 : 1);
  constexpr uint32_t MASK = BITS == 8 ? 0xFFu : ((1u << BITS) - 1u);
  constexpr int RP = 16 * RT;
  constexpr int ROWS_PER_THREAD = BK * BN / NT;  // weight rows a thread
  constexpr int WORDS = ROWS_PER_THREAD / PER;    // packed bytes a thread
  constexpr int A_PER_THREAD = BK * RP / NT;     // A values a thread
  constexpr int X_PER_THREAD = BM * BK / 8 / NT; // 16-byte x slots a thread
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [BM][KS]: x chunk
  bf16* ws = xs + BM * KS;                   // [BN][KS]: weight chunk, transposed
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

  float acc[2][4][4];
  float xa[RT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xa[j][e] = 0.f;

  // the weight column and rows this thread dequantizes, the x row and
  // 8-wide k slot it stages (when K % 8 == 0 and x is 16-byte aligned)
  const int wc = tid % BN;
  const int wr0 = (tid / BN) * ROWS_PER_THREAD;
  const int n_w = n0 + wc;
  const bool x_vec = (K & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bf16 zero = __float2bfloat16(0.f);

  // one chunk's global operands, loaded into registers all at once, one
  // chunk ahead of the products (so one memory latency a chunk, hidden
  // behind the previous chunk's products)
  uint4 xr[X_PER_THREAD];
  bf16 ar[A_PER_THREAD];
  uint32_t wr[WORDS];
  float sr, zr;
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
    sr = zr = 0.f;
    if (n_w < N && kb < K) {
      sr = scales[(size_t)(kb / group) * N + n_w];
      zr = zeros[(size_t)(kb / group) * N + n_w];
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
    // dequantize in f32, round to bf16, store as two 16-byte vectors of
    // ws[wc]; a group boundary inside the 16 rows (groups under 16 or not
    // a multiple of 16) fetches its scale and zero here
    {
      const int kb = k0 + wr0;
      int gi = kb / group;
      int next_boundary = (gi + 1) * group;
      float s = sr, z = zr;
      float v[ROWS_PER_THREAD];
#pragma unroll
      for (int p = 0; p < WORDS; ++p) {
        const int kw = kb + p * PER;
        const bool ok = n_w < N && kw < K;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int k = kw + j;
          if (ok && k == next_boundary) {
            ++gi;
            next_boundary += group;
            s = scales[(size_t)gi * N + n_w];
            z = zeros[(size_t)gi * N + n_w];
          }
          const float code = (float)((wr[p] >> (BITS * j)) & MASK);
          v[p * PER + j] = ok ? (code - z) * s : 0.f;
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wc * KS + wr0);
#pragma unroll
      for (int q = 0; q < ROWS_PER_THREAD / 8; ++q)
        dst[q] = make_uint4(pack_bf16(v[8 * q], v[8 * q + 1]),
                            pack_bf16(v[8 * q + 2], v[8 * q + 3]),
                            pack_bf16(v[8 * q + 4], v[8 * q + 5]),
                            pack_bf16(v[8 * q + 6], v[8 * q + 7]));
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
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
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

}  // namespace

// x (M, K), lora_a (K, r), lora_b (N, r) and out (M, N), all f32 or all
// bf16 (x_is_bf16); packed (K*bits/8, N) uint8; scales/zeros (K/group, N)
// f32.  All contiguous.  0 <= r <= 128.  Returns 0 or a cudaError_t code.
extern "C" int dqmm_lora_launch(const void* x, const void* packed, const void* scales,
                                const void* zeros, const void* lora_a,
                                const void* lora_b, void* out, int M, int K, int N,
                                int bits, int group, int r, int x_is_bf16,
                                void* stream) {
  const int per = bits == 2 ? 4 : (bits == 4 ? 2 : 1);
  if (M < 1 || K < 1 || N < 1 || group < 1 || K % group || K % per || r < 0 ||
      r > 16 * MAX_RPT || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int need = r <= 16 ? 1 : (r <= 32 ? 2 : (r <= 64 ? 4 : 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = x_is_bf16
      ? mma_by_bits(bits, need, x, packed, scales, zeros, lora_a, lora_b, out, M, K, N,
                    group, r, s)
      : by_bits<float>(bits, need, x, packed, scales, zeros, lora_a, lora_b, out, M,
                       K, N, group, r, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
