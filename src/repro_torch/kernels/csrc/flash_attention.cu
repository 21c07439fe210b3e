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
// the K and V reads are the whole cost.  At a short cache the bytes take
// well under a microsecond, and latency (launch, one load round trip, the
// final combine) is what is left; at a long one (the sequence-sharded
// decode's 2048-key shards) the stream, and a call's ramp and tail.
//
// Three routes; `flash_plan` in kernels/flash_attention.py picks one and
// the entry point checks its numbers again.
//
// bulk and split (Sq = 1, 16-byte loads possible; bulk, the decode path's
// route, for bf16 with d of 64 or 128, split for the rest):
//  * The keys of each (batch, KV head) are split over the `splits` blocks
//    of a thread-block cluster, `chunk` keys each (a multiple of 32), so
//    that about one block runs per SM however few (batch, KV head) pairs
//    there are.  The split comes from Sk and the grid, never from the
//    values in `lengths` (reading them on the host would sync the stream).
//    A block whose range lies past lengths[b] loads nothing and takes part
//    with m = -inf, l = 0.
//  * The partials (m, l, acc) of a block are left in its shared memory and
//    the cluster adds them through distributed shared memory, in rank
//    order (block r finishes a 1/splits share of the output): one launch,
//    no atomics, no scratch, the same bits every run.
//  * bulk: every query row of the KV head (up to 16: the rows of an
//    m16n8k16 tile) is scored and summed on the tensor cores, q K^T and
//    P V as mma.sync (bf16 operands, f32 sums), the online softmax in f32
//    on the S fragments, P rounded to bf16 for P V.  One producer thread
//    streams the block's 32-key tiles with TMA into a ring of `stages` (up
//    to 8), each tile two boxes of 32 keys x 64 dims a 128 d of K and of V
//    from a 4-D tensor map over the cache (B, Hkv, Sk, d as strided), in
//    the 128-byte swizzle (conflict-free ldmatrix), completion counted in
//    bytes on the stage's full mbarrier.  Four consumer warps take the
//    tiles in turn, each with its own running (m, l, o), and release each
//    stage on its empty mbarrier; no block-wide barrier in the key loop.
//    The consumers' partials are combined in shared memory, then the
//    cluster's.  The barriers are set up before griddepcontrol.wait (a
//    programmatic dependent launch; no input is read before it).
//    Sizing by Little's law: 3.35 TB/s over 132 SMs is 25 GB/s an SM; at
//    about 1 us of loaded HBM latency an SM must keep about 25 KB in
//    flight.  The earlier design (three cp.async stages of 32 keys, 16 KB,
//    one warp computing, a __syncthreads a tile) kept at most 32 KB in
//    flight a block, and issued tile c + 2 only once the computing warp had
//    finished tile c - 1.  A ring of 8 tiles of 16 KB (d 128) keeps up to
//    128 KB in flight a block, 4 tiles 64 KB when two blocks share an SM.
//    A bulk copy a 256-byte key row ran at about 37 ns a copy, 7 GB/s an
//    SM (PERF.md, PR 30 run A): hence whole boxes.
//  * split: a warp per query row of the KV head's query heads (hpb of
//    them), times `kw` key groups: warp (h, g) scores keys [32 g, 32 g +
//    32) of every tile of 32 kw keys, lane j key j, on the CUDA cores, and
//    keeps its own running max, sum and output row (lane j owns elements
//    [DPL j, DPL j + DPL)).  K and V tiles move with cp.async into a ring
//    of STAGES stages kept in the input type (rows padded by 16 bytes:
//    conflict-free row reads); one __syncthreads a tile.  Keys past the
//    range are never loaded and never read.
//
// tiled (every other shape: prefill, causal Sq > 1, unaligned views):
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
//
// Partial mode (`lse` not null; the sequence-sharded decode, where a rank
// holds only its own keys): `out` is written in f32, not q's type (the
// ranks' partials are combined in f32 and rounded once, as the unsharded
// kernel rounds its output once), each query row's log-sum-exp
// m + log(l) over its valid keys beside it in f32, in the natural-log
// units of the scaled logits q.k / sqrt(d) (the kernels scale q and take
// expf: no log2 e is folded in), and lengths[b] may be 0.  A row with no
// valid key gets out = 0 and lse = -inf: every partial then has m = -inf,
// so the combine weighs each by 0 instead of exp(-inf - -inf) = NaN.
// Every route writes it (the tiled one from its warp's running max and
// sum, the split and bulk ones from the cluster's combine, on rank 0).
//
// Inputs may be strided views (the decode cache is read through a
// transpose); only the last dimension must be contiguous.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

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

// element i of the output: f32 in the partial mode, else the input type
template <typename T>
__device__ __forceinline__ void store_out(void* out, size_t i, float v, bool f32) {
  if (f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<T*>(out)[i] = from_f32<T>(v);
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
             void* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv,
             int Sq, int Sk, int d,
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
  if (lse != nullptr && lane == 0)
    lse[((size_t)b * Hq + h) * Sq + qpos] = l_run > 0.f ? m_run + logf(l_run) : -INFINITY;
  const size_t orow = (((size_t)b * Hq + h) * Sq + qpos) * d;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int e = lane + 32 * i;
    if (e < d) store_out<T>(out, orow + e, acc[i] * inv, lse != nullptr);
  }
}

// --- split route: Sq = 1, keys split over a cluster --------------------------

constexpr int STAGES = 3;           // cp.async ring depth
constexpr int MAX_SPLITS = 8;       // portable cluster size
constexpr int SPLIT_KEYS = 32;      // keys a warp scores per tile (one a lane)
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use
constexpr int MAX_PARTS = 16;       // partials a query row combines: splits * kw

// shared memory of the split route: the K/V ring, the scaled q rows and
// every warp's partial (m, l, pad, pad, acc[D])
__host__ __device__ constexpr int split_ldr(int es, int D) { return D + 16 / es; }
__host__ __device__ constexpr int split_smem(int es, int D, int hpb, int kw) {
  return STAGES * SPLIT_KEYS * kw * 2 * split_ldr(es, D) * es + hpb * D * 4 +
         kw * hpb * (D + 4) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// N elements at p (N-element aligned) widened to f32
template <int N> __device__ __forceinline__ void load_f32(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      o[i] = t.x; o[i + 1] = t.y; o[i + 2] = t.z; o[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}
__device__ __forceinline__ void widen2(uint32_t w, float* o) {
  // a bf16 is the high half of the f32 with the same value
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xFFFF0000u);
}
template <int N> __device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    widen2(t.x, o); widen2(t.y, o + 2); widen2(t.z, o + 4); widen2(t.w, o + 6);
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    widen2(t.x, o); widen2(t.y, o + 2);
  } else if constexpr (N == 2) {
    widen2(*reinterpret_cast<const uint32_t*>(p), o);
  } else {
    o[0] = __bfloat162float(*p);
  }
}

// Every partial (m, l, acc) of a query row lies in a block's shared memory
// at part[(key group * hpb + row) * ps]: the cluster adds them in rank
// order, then key-group order.  Block `rank` writes a 1/splits share of
// the nrows x d outputs from element `o0` of `out`; the thread that writes
// a row's element 0 also writes its log-sum-exp M + log(L) at `lse` when
// it is not null (the partial mode, whose `out` is f32).  Each thread
// reads a row's m and l with its elements, every load in flight at once:
// one round trip through distributed shared memory.
template <typename T>
__device__ __forceinline__ void combine_partials(cg::cluster_group& cluster, float* part,
                                                 void* out, size_t o0, float* lse, int rank,
                                                 int splits, int kw, int hpb, int nrows, int d,
                                                 int ps) {
  cluster.sync();
  const int nparts = splits * kw;
  const int total = nrows * d;
  const int share = (total + splits - 1) / splits;
  const int hi = min(total, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < hi; i += blockDim.x) {
    const int r = i / d;
    const int e = i - r * d;
    float m[MAX_PARTS], l[MAX_PARTS], a[MAX_PARTS];
#pragma unroll
    for (int j = 0; j < MAX_PARTS; ++j) {
      const float* pp = cluster.map_shared_rank(part, j < nparts ? j / kw : 0) +
                        ((j % kw) * hpb + r) * ps;
      m[j] = j < nparts ? pp[0] : -INFINITY;
      l[j] = j < nparts ? pp[1] : 0.f;
      a[j] = j < nparts ? pp[4 + e] : 0.f;
    }
    float M = m[0];
#pragma unroll
    for (int j = 1; j < MAX_PARTS; ++j) M = fmaxf(M, m[j]);
    float L = 0.f, acc_e = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_PARTS; ++j) {
      // 0 for an empty partial, and for every partial of a row with no
      // valid key (M = -inf)
      const float w = M == -INFINITY ? 0.f : expf(m[j] - M);
      L = fmaf(l[j], w, L);
      acc_e = fmaf(a[j], w, acc_e);
    }
    store_out<T>(out, o0 + (size_t)r * d + e, acc_e * (1.f / fmaxf(L, 1e-30f)),
                 lse != nullptr);
    if (lse != nullptr && e == 0) lse[r] = L > 0.f ? M + logf(L) : -INFINITY;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// grid (splits, B * Hkv * head groups), clusters of `splits` blocks along x;
// block: warp w is query row w % hpb of the block's heads, key group w / hpb
template <typename T, int DPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   void* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv,
                   int Sk, int d,
                   Strides sq, Strides sk, Strides sv, int hpb, int kw, int chunk,
                   int causal, float scale) {
  constexpr int D = DPL * 32;
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int LDR = split_ldr(sizeof(T), D);
  constexpr int PS = D + 4;                 // floats per partial
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TK = SPLIT_KEYS * kw;           // keys a tile
  const int stage = TK * 2 * LDR;           // elements a stage (K then V)
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(ring + STAGES * stage);
  float* part = qs + hpb * D;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)gridDim.x;        // the cluster spans x
  const int rep = Hq / Hkv;
  const int n_hgroups = (rep + hpb - 1) / hpb;
  int y = blockIdx.y;
  const int hg = y % n_hgroups;
  y /= n_hgroups;
  const int kvh = y % Hkv;
  const int b = y / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h_local = warp % hpb;
  const int kg = warp / hpb;
  const int nrows = min(hpb, rep - hg * hpb);  // query heads of this block
  const bool row_valid = h_local < nrows;
  const int h0 = kvh * rep + hg * hpb;

  int kend = Sk;
  if (lengths != nullptr) kend = min(kend, lengths[b]);
  if (causal) kend = min(kend, 1);            // query 0 sees key 0 only
  const int k_lo = rank * chunk;
  const int k_hi = min(kend, k_lo + chunk);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + TK - 1) / TK : 0;

  for (int i = threadIdx.x; i < nrows * d; i += blockDim.x) {
    const int r = i / d;
    const int e = i - r * d;
    qs[r * D + e] = to_f32(q[b * sq.b + (h0 + r) * sq.h + e]) * scale;
  }

  const T* kbase = k + b * sk.b + kvh * sk.h;
  const T* vbase = v + b * sv.b + kvh * sv.h;
  const int per_row = d / VEC;
  auto load = [&](int c) {
    T* ks = ring + (c % STAGES) * stage;
    T* vs = ks + TK * LDR;
    const int t0 = k_lo + c * TK;
    const int tn = min(TK, k_hi - t0);
    for (int i = threadIdx.x; i < tn * per_row; i += blockDim.x) {
      const int j = i / per_row;
      const int e = (i - j * per_row) * VEC;
      cp_async16(ks + j * LDR + e, kbase + (t0 + j) * sk.s + e);
      cp_async16(vs + j * LDR + e, vbase + (t0 + j) * sv.s + e);
    }
  };

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;
  const bool owns = lane * DPL < d;          // this lane's output elements

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < ntiles) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < ntiles; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's part of tile c is in
    __syncthreads();              // everyone's is, and tile c - 1 is done
    if (c + STAGES - 1 < ntiles) load(c + STAGES - 1);
    cp_async_commit();
    const T* ks = ring + (c % STAGES) * stage + kg * SPLIT_KEYS * LDR;
    const T* vs = ks + TK * LDR;
    const int jn = min(SPLIT_KEYS, k_hi - (k_lo + c * TK + kg * SPLIT_KEYS));
    if (!row_valid || jn <= 0) continue;     // warp-uniform
    float sc = -INFINITY;
    if (lane < jn) {
      const T* kr = ks + lane * LDR;
      const float* qr = qs + h_local * D;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int e = 0; e < d; e += VEC) {
        float kv[VEC];
        load_f32<VEC>(kr + e, kv);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e + i);
          a0 = fmaf(qv.x, kv[i], a0);
          a1 = fmaf(qv.y, kv[i + 1], a1);
          a2 = fmaf(qv.z, kv[i + 2], a2);
          a3 = fmaf(qv.w, kv[i + 3], a3);
        }
      }
      sc = (a0 + a1) + (a2 + a3);
    }
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
      if (owns) {
        float vv[DPL];
        load_f32<DPL>(vs + j * LDR + lane * DPL, vv);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, vv[i], acc[i]);
      }
    }
    m_run = m_new;
  }
  cp_async_wait<0>();

  // every warp's partial into shared memory, then the cluster's combine
  if (row_valid) {
    float* pp = part + (kg * hpb + h_local) * PS;
    if (lane == 0) {
      pp[0] = m_run;
      pp[1] = l_run;
    }
    if (owns)
#pragma unroll
      for (int i = 0; i < DPL; ++i) pp[4 + lane * DPL + i] = acc[i];
  }
  combine_partials<T>(cluster, part, out, ((size_t)b * Hq + h0) * d,
                      lse == nullptr ? nullptr : lse + (size_t)b * Hq + h0, rank, splits, kw,
                      hpb, nrows, d, PS);
}

// --- bulk route: bf16, d of 64 or 128, on the tensor cores ----------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

constexpr int CONSUMERS = 4;        // consumer warps a block; one more produces
constexpr int BULK_THREADS = (CONSUMERS + 1) * 32;
constexpr int MAX_STAGES = 8;       // ring stages at most (tiles of SPLIT_KEYS keys)
constexpr int BOX_DIMS = 64;        // head dims a box: 128 bytes, the swizzle's row
constexpr int BOX_BYTES = SPLIT_KEYS * BOX_DIMS * 2;

// the bytes a tile loads: whole boxes of K and V, SPLIT_KEYS rows of d bf16
// each (rows past Sk arrive as zeros and count): what its full barrier
// expects
__host__ __device__ constexpr int tile_tx_bytes(int d) { return 2 * SPLIT_KEYS * d * 2; }
// shared memory of the bulk route: 1024 bytes to align the ring (the
// swizzle's boxes start on 1024 bytes), the ring of `stages` tiles (K
// boxes, then V boxes), the 16-row q tile, every consumer warp's partial,
// the block's partial, then a full and an empty mbarrier a stage
__host__ __device__ constexpr int bulk_smem(int D, int hpb, int stages) {
  return 1024 + stages * tile_tx_bytes(D) + ROWS * split_ldr(2, D) * 2 +
         (CONSUMERS + 1) * hpb * (D + 4) * 4 + stages * 2 * 8;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// spin until the phase of this parity of `bar` completes; a wait that
// outlasts any real tile by far traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
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
// the box of `map` at (dim c0, key c1, KV head c2, batch c3) into shared
// memory at dst, counted on `bar`'s transactions
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// 16 bytes at (row r, 16-byte chunk c of the row's d) of a tile's K or V
// boxes under the 128-byte swizzle: chunk c % 8 of box c / 8 lies at chunk
// (c % 8) ^ (r % 8) of its 128-byte row, so the 8 rows of an ldmatrix
// read 8 distinct bank groups
__device__ __forceinline__ const __nv_bfloat16* swz(const __nv_bfloat16* box0, int r, int c) {
  return box0 + (c >> 3) * (BOX_BYTES / 2) + r * BOX_DIMS + (((c & 7) ^ (r & 7)) << 3);
}

// Keys split over a cluster as on the split route, scored and summed on the
// tensor cores (S = q K^T and O += P V as mma.sync, bf16 operands and f32
// sums, the online softmax in f32 on the S fragments, P rounded to bf16
// for P V as FlashAttention does; every query row of the KV head in one
// 16-row tile), fed by the last warp's first thread: tile c (SPLIT_KEYS
// keys of the block's range) goes to ring stage c % stages as whole TMA
// boxes of K and V (d / 64 of each), reported to the stage's full barrier;
// consumer warp w takes tiles w, w + CONSUMERS, ... with its own running
// (m, l, o) and releases each stage on its empty barrier.  A stage is always used by the
// same consumer warp (stages % CONSUMERS == 0) or once (stages >= the
// block's tiles): a warp never waits on a stage's phase two ahead, which
// the barrier's parity could not tell from the one before.  No block-wide
// barrier inside the key loop.  The consumers' partials are combined in
// shared memory, then the cluster's blocks' through distributed shared
// memory.
template <int D>
__global__ void __launch_bounds__(BULK_THREADS)
flash_bulk_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ q, const int* __restrict__ lengths,
                  void* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv,
                  int Sk, Strides sq, int hpb, int chunk, int stages, int causal,
                  float scale) {
  typedef __nv_bfloat16 bf16;
  constexpr int LDR = split_ldr(2, D);     // the q tile's row stride: + 16 bytes
  constexpr int PS = D + 4;
  constexpr int KS = D / 16;               // k steps of q K^T
  constexpr int NT = D / 8;                // n tiles of P V
  constexpr int TK = SPLIT_KEYS;           // keys a tile
  constexpr int STAGE = tile_tx_bytes(D) / 2;   // elements a stage: K boxes, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));
  bf16* qs = ring + stages * STAGE;        // [ROWS][LDR], rows past nrows zero
  float* wpart = reinterpret_cast<float*>(qs + ROWS * LDR);  // [CONSUMERS][hpb][PS]
  float* part = wpart + CONSUMERS * hpb * PS;                // the block's [hpb][PS]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + hpb * PS);
  uint64_t* empty = full + stages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)gridDim.x;
  const int rep = Hq / Hkv;
  const int n_hgroups = (rep + hpb - 1) / hpb;
  int y = blockIdx.y;
  const int hg = y % n_hgroups;
  y /= n_hgroups;
  const int kvh = y % Hkv;
  const int b = y / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nrows = min(hpb, rep - hg * hpb);
  const int h0 = kvh * rep + hg * hpb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);      // the producer's arrive, plus the tile's bytes
      mbar_init(empty + s, 32);    // every lane of the consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x == CONSUMERS * 32) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&kmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&vmap))
                 : "memory");
  }
  __syncthreads();  // the barriers
  // a programmatic dependent launch: the barriers are set up while the
  // kernel before finishes; q, lengths and the cache belong to earlier
  // kernels, and nothing of them is read before this wait.  Then the next
  // launch may start its own set-up.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  int kend = Sk;
  if (lengths != nullptr) kend = min(kend, lengths[b]);
  if (causal) kend = min(kend, 1);
  const int k_lo = rank * chunk;
  const int k_hi = min(kend, k_lo + chunk);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + TK - 1) / TK : 0;

  if (warp == CONSUMERS) {
    // the producer: stage c % stages takes tile c once the consumer of
    // tile c - stages has released it; the first tiles go out while the
    // consumers stage q
    if (lane == 0)
      for (int c = 0; c < ntiles; ++c) {
        const int s = c % stages;
        if (c >= stages) mbar_wait(empty + s, (c / stages - 1) & 1);
        mbar_expect_tx(full + s, tile_tx_bytes(D));
        bf16* ks = ring + s * STAGE;
#pragma unroll
        for (int h = 0; h < D / BOX_DIMS; ++h) {
          tma_load(ks + h * (BOX_BYTES / 2), &kmap, full + s, h * BOX_DIMS, k_lo + c * TK, kvh,
                   b);
          tma_load(ks + STAGE / 2 + h * (BOX_BYTES / 2), &vmap, full + s, h * BOX_DIMS,
                   k_lo + c * TK, kvh, b);
        }
      }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += CONSUMERS * 32) {
      const int r = i / D, e = i - r * D;
      qs[r * LDR + e] = r < nrows ? q[b * sq.b + (h0 + r) * sq.h + e] : __float2bfloat16(0.f);
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS * 32) : "memory");  // the q tile
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qa[kk], qs + ((lane >> 3) & 1) * 8 * LDR + (lane & 7) * LDR + kk * 16 +
                          (lane >> 4) * 8);
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
    float l_run[2] = {0.f, 0.f};

    for (int c = warp; c < ntiles; c += CONSUMERS) {
      const int s = c % stages;
      mbar_wait(full + s, (c / stages) & 1);
      const bf16* ks = ring + s * STAGE;
      bf16* vs = ring + s * STAGE + STAGE / 2;
      const int jn = min(TK, k_hi - (k_lo + c * TK));
      if (jn < TK) {
        // the ragged last tile (the stage's last use): V rows past the
        // range are zeros, since P is 0 there and 0 * garbage could be
        // NaN (the boxes hold whatever lies in the cache up to Sk).  K
        // rows past it are masked in S.
        for (int i = lane; i < (TK - jn) * (D / 8); i += 32)
          *reinterpret_cast<uint4*>(const_cast<bf16*>(swz(vs, jn + i / (D / 8), i % (D / 8)))) =
              make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();
      }
      // S = q K^T: 4 tiles of 8 keys
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < 4; n += 2)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kb[4];  // B of key tiles n and n + 1, dims 16 kk .. 16 kk + 15
          ldsm_x4(kb, swz(ks, (n + (lane >> 4)) * 8 + (lane & 7), kk * 2 + ((lane >> 3) & 1)));
          mma_bf16(sc[n], qa[kk], kb);
          mma_bf16(sc[n + 1], qa[kk], kb + 2);
        }
      // online softmax over the tile's keys, rows g (e = 0, 1) and g + 8
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + 2 * t + (e & 1);
          sc[n][e] = key < jn ? sc[n][e] * scale : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], sc[n][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m_run[r], mt[r]);
        alpha[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = expf(sc[n][e] - m_run[e >> 1]);
          psum[e >> 1] += sc[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l_run[r] = l_run[r] * alpha[r] + psum[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
      // O += P V: 2 steps of 16 keys; S's fragments of key tiles 2 kk,
      // 2 kk + 1 are P's A fragment
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t vb[4];  // B of dim tiles n and n + 1, keys 16 kk .. 16 kk + 15
          ldsm_x4_t(vb, swz(vs, kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), n + (lane >> 4)));
          mma_bf16(o[n], pa, vb);
          mma_bf16(o[n + 1], pa, vb + 2);
        }
      }
      mbar_arrive(empty + s);  // this lane has read the stage
    }
    // this warp's partial (rows g, g + 8 of the block's query rows); a warp
    // with no tile gives m = -inf, l = 0, o = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= nrows) continue;
      float* pp = wpart + (warp * hpb + row) * PS;
      if (t == 0) {
        pp[0] = m_run[r];
        pp[1] = l_run[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        pp[4 + n * 8 + 2 * t] = o[n][2 * r];
        pp[4 + n * 8 + 2 * t + 1] = o[n][2 * r + 1];
      }
    }
  }
  if (warp < CONSUMERS) {
    // the block's partial: the consumers' in warp order (the producer goes
    // on to the cluster's barrier)
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS * 32) : "memory");
    for (int i = threadIdx.x; i < nrows * D; i += CONSUMERS * 32) {
      const int r = i / D, e = i - r * D;
      float m[CONSUMERS], M = -INFINITY;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
        m[w] = wpart[(w * hpb + r) * PS];
        M = fmaxf(M, m[w]);
      }
      float acc = 0.f, L = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
        const float* pw = wpart + (w * hpb + r) * PS;
        const float x = M == -INFINITY ? 0.f : expf(m[w] - M);
        acc = fmaf(pw[4 + e], x, acc);
        L = fmaf(pw[1], x, L);
      }
      part[r * PS + 4 + e] = acc;
      if (e == 0) {
        part[r * PS] = M;
        part[r * PS + 1] = L;
      }
    }
  }
  combine_partials<bf16>(cluster, part, out, ((size_t)b * Hq + h0) * D,
                         lse == nullptr ? nullptr : lse + (size_t)b * Hq + h0, rank, splits, 1,
                         hpb, nrows, D, PS);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qr) ==
            cudaSuccess && qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the cache (B, Hkv, Sk, d) bf16 at `ptr`, element strides s for its first
// three dimensions, as a 4-D map in boxes of SPLIT_KEYS keys x 64 dims of
// one (batch, KV head) under the 128-byte swizzle; keys past Sk read as
// zeros.  Returns 0, or ENCODE_FAILED + the driver's CUresult.
constexpr int ENCODE_FAILED = 10000;
int cache_map(CUtensorMap* m, const void* ptr, int B, int Hkv, int Sk, int d, Strides s) {
  const EncodeTiled enc = encoder();
  if (!enc) return ENCODE_FAILED;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)Sk, (cuuint64_t)Hkv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.s * 2, (cuuint64_t)s.h * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {BOX_DIMS, SPLIT_KEYS, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)rc;
}

template <int D>
int launch_bulk(const void* q, const void* k, const void* v, const int* lengths, void* out,
                float* lse, int B, int Hq, int Hkv, int Sk, Strides sq, Strides sk, Strides sv,
                int causal, float scale, int splits, int chunk, int stages,
                cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int hpb = rep < ROWS ? rep : ROWS;
  if (splits < 1 || splits > MAX_SPLITS || chunk < 1 || chunk % SPLIT_KEYS ||
      (long long)(splits - 1) * chunk >= Sk || (long long)splits * chunk < Sk ||
      stages < 1 || stages > MAX_STAGES ||
      (stages % CONSUMERS && stages < chunk / SPLIT_KEYS) ||
      bulk_smem(D, hpb, stages) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  int rc = cache_map(&kmap, k, B, Hkv, Sk, D, sk);
  if (!rc) rc = cache_map(&vmap, v, B, Hkv, Sk, D, sv);
  if (rc) return rc;
  auto kern = flash_bulk_kernel<D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * Hkv * ((rep + hpb - 1) / hpb));
  cfg.blockDim = dim3(BULK_THREADS);
  cfg.dynamicSmemBytes = bulk_smem(D, hpb, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(&cfg, kern, kmap, vmap, static_cast<const __nv_bfloat16*>(q),
                                 lengths, out, lse, Hq, Hkv, Sk, sq, hpb, chunk, stages, causal,
                                 scale);
}

template <typename T, int DPL>
int launch_split(const void* q, const void* k, const void* v, const int* lengths,
                 void* out, float* lse, int B, int Hq, int Hkv, int Sk, int d, Strides sq,
                 Strides sk, Strides sv, int causal, float scale, int splits,
                 int chunk, int kw, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int hpb = rep < ROWS ? rep : ROWS;
  const int smem = split_smem(sizeof(T), DPL * 32, hpb, kw);
  if (splits < 1 || splits > MAX_SPLITS || chunk < 1 || chunk % SPLIT_KEYS ||
      (long long)(splits - 1) * chunk >= Sk || (long long)splits * chunk < Sk ||
      !(kw == 1 || kw == 2 || kw == 4) || hpb * kw > ROWS || smem > SMEM_MAX ||
      splits * kw > MAX_PARTS ||
      d % DPL)
    return (int)cudaErrorInvalidValue;
  auto kern = flash_split_kernel<T, DPL>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * Hkv * ((rep + hpb - 1) / hpb));
  cfg.blockDim = dim3(hpb * kw * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                                 static_cast<const T*>(k), static_cast<const T*>(v),
                                 lengths, out, lse, Hq, Hkv, Sk, d, sq, sk,
                                 sv, hpb, kw, chunk, causal, scale);
}

template <typename T, int DPL>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int d,
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
      static_cast<const T*>(v), lengths, out, lse, Hq, Hkv, Sq,
      Sk, d, sq, sk, sv, heads_per_block, bq, causal, scale, vec);
}

template <typename T, int DPL>
int route(const void* q, const void* k, const void* v, const int* lengths, void* out,
          float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int d, Strides sq, Strides sk,
          Strides sv, int causal, float scale, int vec, int splits, int chunk, int kw,
          int bulk, int stages, cudaStream_t stream) {
  if (splits == 0) {
    launch<T, DPL>(q, k, v, lengths, out, lse, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal,
                   scale, vec, stream);
    return 0;
  }
  if (Sq != 1 || !vec) return (int)cudaErrorInvalidValue;
  if (bulk) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value && (DPL == 2 || DPL == 4)) {
      if (d != DPL * 32) return (int)cudaErrorInvalidValue;
      return launch_bulk<DPL * 32>(q, k, v, lengths, out, lse, B, Hq, Hkv, Sk, sq, sk, sv,
                                   causal, scale, splits, chunk, stages, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  return launch_split<T, DPL>(q, k, v, lengths, out, lse, B, Hq, Hkv, Sk, d, sq, sk, sv,
                              causal, scale, splits, chunk, kw, stream);
}

template <typename T>
int by_width(const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int d,
             Strides sq, Strides sk, Strides sv, int causal, float scale,
             int vec, int splits, int chunk, int kw, int bulk, int stages,
             cudaStream_t stream) {
#define FA_ROUTE(DPL)                                                              \
  return route<T, DPL>(q, k, v, lengths, out, lse, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, \
                       causal, scale, vec, splits, chunk, kw, bulk, stages, stream)
  if (d <= 32) FA_ROUTE(1);
  if (d <= 64) FA_ROUTE(2);
  if (d <= 128) FA_ROUTE(4);
  if (d <= 256) FA_ROUTE(8);
#undef FA_ROUTE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, Sq, d), k/v (B, Hkv, Sk, d) with element strides for the first
// three dimensions and a contiguous last one; lengths (B,) int32 or null;
// out (B, Hq, Sq, d) contiguous in q's type; lse (B, Hq, Sq) f32 or null
// (the partial mode, where lengths may hold 0 and out is f32).  vec != 0
// promises that k and v are 16-byte aligned and d and their strides are
// multiples of 16 bytes.  splits == 0 takes the tiled route; splits >= 1 a
// route that splits the keys (Sq = 1, vec): clusters of `splits` blocks,
// `chunk` keys a block, and the split route (`kw` key groups a block) or,
// when bulk != 0, the bulk route (bf16, d of 64 or 128; a ring of `stages`
// tiles) (kernels/flash_attention.py, flash_plan).  Returns 0 or a
// cudaError_t (or ENCODE_FAILED + a CUresult when a tensor map fails).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    void* lse, int B, int Hq, int Hkv, int Sq, int Sk, int d, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, int causal, float scale,
    int vec, int is_bf16, int splits, int chunk, int kw, int bulk, int stages,
    void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs};
  const int* lens = static_cast<const int*>(lengths);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = is_bf16
      ? by_width<__nv_bfloat16>(q, k, v, lens, out, lse_f, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, splits, chunk, kw, bulk, stages, s)
      : by_width<float>(q, k, v, lens, out, lse_f, B, Hq, Hkv, Sq, Sk, d, sq, sk, sv, causal, scale, vec, splits, chunk, kw, bulk, stages, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
