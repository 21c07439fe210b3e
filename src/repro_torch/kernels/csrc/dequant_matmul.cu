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
// is about keeping many independent loads outstanding, and about spending
// few instructions per code: a code becomes a float by OR-ing it into the
// mantissa of 2^23 (no int-to-float conversion, which issues at a quarter
// of the FMA rate), and the staged x values a code multiplies are read from
// shared memory as one vector.
//
// Design:
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
//  * The four warps' sums are added through shared memory in a fixed order.
//    A decode-sized M and N give too few blocks to fill 132 SMs, so the
//    units are also split over gridDim.z: each split writes an f32 partial,
//    and a second kernel adds the partials in a fixed order (deterministic)
//    and casts to the output type.  With one split the first kernel writes
//    the output directly.
// Every M >= 1, ragged N, bits in {2, 4, 8} (3-bit codes are stored raw and
// arrive as 8) and any group size that divides K are taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int CPT> __device__ __forceinline__ void load_group(
    const float* __restrict__ scales, const float* __restrict__ zeros,
    size_t at, float* s, float* zb) {
  if constexpr (CPT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(scales + at);
    const float4 b = *reinterpret_cast<const float4*>(zeros + at);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    zb[0] = MAGIC + b.x; zb[1] = MAGIC + b.y; zb[2] = MAGIC + b.z; zb[3] = MAGIC + b.w;
  } else {
    s[0] = scales[at];
    zb[0] = MAGIC + zeros[at];
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
    float s[CPT], zb[CPT];  // zb = 2^23 + z, see the header
    load_group<CPT>(scales, zeros, (size_t)gi * N + n0, s, zb);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (i >= nprow) break;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int kk = ks0 + i * PER + j;
        if (k0 + kk == next_boundary) {
          ++gi;
          next_boundary += group;
          load_group<CPT>(scales, zeros, (size_t)gi * N + n0, s, zb);
        }
        float xv[BM];
        load_row<BM>(&xs[kk][0], xv);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const uint32_t code = (words[i] >> (8 * c + BITS * j)) & MASK;
          const float w = (__uint_as_float(MAGIC_BITS | code) - zb[c]) * s[c];
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
// scales/zeros (K/group, N) f32, out (M, N) in x's type, partial
// (splits, M, N) f32 scratch (unused when splits == 1).  All contiguous;
// cpt == 4 needs N % 4 == 0, `packed` 4-byte and `scales`/`zeros` 16-byte
// aligned.  Returns 0 or a cudaError_t code.
extern "C" int dqmm_launch(const void* x, const void* packed, const void* scales,
                           const void* zeros, void* out, void* partial, int M,
                           int K, int N, int bits, int group, int bm, int cpt,
                           int splits, int units_per_split, int x_is_bf16,
                           void* stream) {
  if (M < 1 || K < 1 || N < 1 || group < 1 || K % group || splits < 1 ||
      units_per_split < 1 || (cpt == 4 && N % 4))
    return (int)cudaErrorInvalidValue;
  const Args a{x, packed, scales, zeros, out, partial, M, K, N, group,
               splits, units_per_split, static_cast<cudaStream_t>(stream)};
  const int rc = x_is_bf16 ? by_rows<__nv_bfloat16>(bm, bits, cpt, a)
                           : by_rows<float>(bm, bits, cpt, a);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
