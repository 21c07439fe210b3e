// Online-softmax GQA attention with optional per-sequence key lengths, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (`_kernel`, `_block`): causal or not,
// optional `lengths` (keys at kpos >= lengths[b] dropped, lengths >= 1), GQA
// with query head h reading KV head h / (Hq / Hkv), softmax in f32, output
// in q's type.  The causal mask aligns query 0 with key 0.
//
// What bounds it on the H100: bytes.  In serving decode (Sq = 1) every key
// and value is used by Hq / Hkv query rows only, two FMAs per element, so
// the K and V reads are the whole cost.
//
// Design (simple first):
//  * One block per (batch, KV head, query tile).  It holds the query rows
//    of every query head that reads its KV head (up to 16 rows, one warp
//    each), so each K and V element is read from device memory once per
//    query tile and never repeated per query head.  A block has at least
//    four warps: in decode (one query row per head) the extra warps only
//    help to load.
//  * Keys are staged 32 at a time (8 for d > 128) in shared memory as f32,
//    read 16 bytes per load where strides and pointers allow.  Within a
//    warp (one query row) lane j scores key j of the tile, so the scores of
//    a tile come out in parallel and the online softmax (running max and
//    sum, in f32) is updated once per tile, not once per key; each lane
//    then accumulates its share of the d output elements from the tile's
//    values, the probabilities passed along by shuffles.
//  * The key loop ends at min(Sk, lengths[b]) for the block and, under the
//    causal mask, at each row's own position: masked keys are never
//    loaded, which gives the reference's exact zero weight for them.
//  * Inputs may be strided views (the decode cache is read through a
//    transpose); only the last dimension must be contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;      // query rows (warps) per block at most
constexpr int MIN_WARPS = 4;  // warps per block at least (loaders)

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;
};

// 16 bytes of K or V (4 f32 or 8 bf16 elements) into f32 shared memory
__device__ __forceinline__ void load16(const float* __restrict__ p, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  // a bf16 is the high half of the f32 with the same value
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xFFFF0000u),
      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xFFFF0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      __uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xFFFF0000u),
      __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xFFFF0000u));
}

// DPL: elements of the head dimension per lane (d <= 32 * DPL)
template <typename T, int DPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             T* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, int d,
             Strides sq, Strides sk, Strides sv, int heads_per_block, int bq,
             int causal, float scale, int vec) {
  constexpr int D = DPL * 32;
  constexpr int BKV = DPL <= 4 ? 32 : 8;  // keys per staged tile (<= 32)
  constexpr int LD = D + 4;               // padded row: conflict-free row reads
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  __shared__ __align__(16) float ks[BKV][LD];
  __shared__ __align__(16) float vs[BKV][LD];
  __shared__ __align__(16) float qs[ROWS][D];

  const int rep = Hq / Hkv;
  const int n_hgroups = (rep + heads_per_block - 1) / heads_per_block;
  const int qt = blockIdx.x;
  int y = blockIdx.y;
  const int hg = y % n_hgroups;
  y /= n_hgroups;
  const int kvh = y % Hkv;
  const int b = y / Hkv;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h_local = warp / bq;
  const int h_in_group = hg * heads_per_block + h_local;
  const int qpos = qt * bq + warp % bq;
  const bool row_valid = warp < ROWS && h_local < heads_per_block &&
                         h_in_group < rep && qpos < Sq;
  const int h = kvh * rep + h_in_group;

  // keys this block needs: up to lengths[b], and under the causal mask up
  // to its last query row's position
  int kend = Sk;
  if (lengths != nullptr) kend = min(kend, lengths[b]);
  if (causal) kend = min(kend, min(Sq, (qt + 1) * bq));
  const int row_end = causal ? min(kend, qpos + 1) : kend;

  // zero the staging rows once (the dot products run over the padded
  // width; loads write only [0, d)), and stage this warp's scaled q row
  for (int i = threadIdx.x; i < BKV * LD; i += blockDim.x) {
    (&ks[0][0])[i] = 0.f;
    (&vs[0][0])[i] = 0.f;
  }
  if (row_valid)
    for (int e = lane; e < D; e += 32)
      qs[warp][e] = e < d ? to_f32(q[b * sq.b + h * sq.h + qpos * sq.s + e]) * scale
                          : 0.f;

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const T* kbase = k + b * sk.b + kvh * sk.h;
  const T* vbase = v + b * sv.b + kvh * sv.h;
  for (int t0 = 0; t0 < kend; t0 += BKV) {
    const int tn = min(BKV, kend - t0);
    __syncthreads();  // the previous tile has been read by every warp
    if (vec) {
      const int per_row = d / VEC;
#pragma unroll 4
      for (int idx = threadIdx.x; idx < tn * per_row; idx += blockDim.x) {
        const int j = idx / per_row;
        const int e = (idx - j * per_row) * VEC;
        load16(kbase + (t0 + j) * sk.s + e, &ks[j][e]);
        load16(vbase + (t0 + j) * sv.s + e, &vs[j][e]);
      }
    } else {
      for (int idx = threadIdx.x; idx < tn * d; idx += blockDim.x) {
        const int j = idx / d;
        const int e = idx - j * d;
        ks[j][e] = to_f32(kbase[(t0 + j) * sk.s + e]);
        vs[j][e] = to_f32(vbase[(t0 + j) * sv.s + e]);
      }
    }
    __syncthreads();
    const int jn = min(tn, row_end - t0);  // warp-uniform
    if (!row_valid || jn <= 0) continue;
    // lane j scores key t0 + j: a d-long dot product over shared memory
    float sc = -INFINITY;
    if (lane < jn) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; e += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[lane][e]);
        const float4 qv = *reinterpret_cast<const float4*>(&qs[warp][e]);
        a0 = fmaf(qv.x, kv.x, a0);
        a1 = fmaf(qv.y, kv.y, a1);
        a2 = fmaf(qv.z, kv.z, a2);
        a3 = fmaf(qv.w, kv.w, a3);
      }
      sc = (a0 + a1) + (a2 + a3);
    }
    // one online-softmax update for the whole tile
    float m_tile = sc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_run, m_tile);
    const float p = lane < jn ? expf(sc - m_new) : 0.f;
    float p_sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    for (int j = 0; j < jn; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(pj, vs[j][lane + 32 * i], acc[i]);
    }
    m_run = m_new;
  }
  if (!row_valid) return;
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  T* orow = out + (((size_t)b * Hq + h) * Sq + qpos) * d;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int e = lane + 32 * i;
    if (e < d) orow[e] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int DPL>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, int B, int Hq, int Hkv, int Sq, int Sk, int d,
            Strides sq, Strides sk, Strides sv, int causal, float scale,
            int vec, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int heads_per_block = rep < ROWS ? rep : ROWS;
  int bq = ROWS / heads_per_block;
  if (bq > Sq) bq = Sq;
  const int n_hgroups = (rep + heads_per_block - 1) / heads_per_block;
  dim3 grid((Sq + bq - 1) / bq, B * Hkv * n_hgroups);
  const int warps = heads_per_block * bq;
  const int threads = (warps < MIN_WARPS ? MIN_WARPS : warps) * 32;
  flash_kernel<T, DPL><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), Hq, Hkv, Sq,
      Sk, d, sq, sk, sv, heads_per_block, bq, causal, scale, vec);
}

template <typename T>
int by_width(const void* q, const void* k, const void* v, const int* lengths,
             void* out, int B, int Hq, int Hkv, int Sq, int Sk, int d,
             Strides sq, Strides sk, Strides sv, int causal, float scale,
             int vec, cudaStream_t stream) {
  if (d <= 32) launch<T, 1>(q, k, v, lengths, out, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, stream);
  else if (d <= 64) launch<T, 2>(q, k, v, lengths, out, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, stream);
  else if (d <= 128) launch<T, 4>(q, k, v, lengths, out, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, stream);
  else if (d <= 256) launch<T, 8>(q, k, v, lengths, out, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, stream);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q (B, Hq, Sq, d), k/v (B, Hkv, Sk, d) with element strides for the first
// three dimensions and a contiguous last one; lengths (B,) int32 or null;
// out (B, Hq, Sq, d) contiguous in q's type.  vec != 0 promises that k and
// v are 16-byte aligned and d and their strides are multiples of 16 bytes.
// Returns 0 or a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int Hq, int Hkv, int Sq, int Sk, int d, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, int causal, float scale,
    int vec, int is_bf16, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = is_bf16
      ? by_width<__nv_bfloat16>(q, k, v, lens, out, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, s)
      : by_width<float>(q, k, v, lens, out, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
