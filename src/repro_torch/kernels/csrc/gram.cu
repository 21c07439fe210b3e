// Gram matrix H = X^T X in f32 for X (T, D) in f32 or bf16, sm_90a.
//
// Replaces the Pallas TPU kernel `gram` in src/repro/kernels/gram.py
// (`_kernel`): X upcast to f32, products accumulated in f32 over the token
// axis, output (D, D) f32.
//
// What bounds it on the H100.  A calibration batch of the 28-layer
// Qwen3-1.7B is 196 calls at T = 1024 tokens with D = 2048 (6 a layer) or
// 6144 (1 a layer): 1.80 TFLOP on the upper triangle (1.82 ms at the bf16
// tensor-core rate) against 8.08 GB moved, 7.5 GB of it the (D, D) f32
// output (2.42 ms at 3.35 TB/s).  So the stores bound it about as much as
// the products, and a tile's stores have to overlap the next tile's
// products.  H is symmetric: only the tiles on and above the diagonal are
// computed (half the work), each stored with its mirror.  Two routes, as
// `gram_plan` in kernels/gram.py picks them (the entry point re-checks):
//
//  * wgmma: bf16 x that TMA can address (D % 8 == 0: a 16-byte row
//    stride; 16-byte aligned x and out).  The calibration path.
//    - bf16 x bf16 products are exact in f32, so the tensor cores with
//      f32 sums differ from the f32 reference only in the order of the
//      sums.
//    - Persistent blocks, one an SM, walk the upper triangle's 128 x 128
//      tiles (bi <= bj), the diagonal ones last, in rounds of one tile a
//      block, every other round in reverse (`walk`).  The kernel is a
//      programmatic dependent of the one before it: a block sets up while
//      that one ends, and the loads wait for it.
//    - Warp 12 keeps a ring of 5 stages full with TMA: the two column
//      panels X[t0:t0+64, i0:i0+128] and X[t0:t0+64, j0:j0+128] of a
//      tile, each two 64 x 64 boxes in the 128-byte swizzle, from one
//      tensor map over x.  A diagonal tile loads its one panel and uses it
//      as both operands.  Rows past T and columns past D read as zero.
//    - Both operands are MN-major: A = X_i^T has M contiguous and B = X_j
//      has N contiguous, so wgmma runs with both transpose bits set; in
//      the descriptors the leading byte offset steps 64 columns (the next
//      box, 8192 bytes) and the stride byte offset 8 tokens (1024 bytes).
//    - Warps 0-7, two warpgroups, run wgmma m64n128k16 (bf16, f32 sums)
//      on rows 0-63 and 64-127 of the tile; one stage's wgmmas run on
//      while the next stage's are issued.  At the tile's end they leave
//      the sums in a staging tile in shared memory (f32, four 32-column
//      boxes, 128-byte swizzle: their stores are free of bank conflicts)
//      and go on to the next tile.
//    - Warps 8-11 store the staged tile while the next tile's products
//      run: one TMA store a box (clipped past D), and the mirror tile
//      (bj, bi) as 4 x 4 blocks transposed in registers and written in
//      16-byte stores.  A diagonal tile has no mirror tile: its upper half
//      is copied over its lower half in the staging first.  So H equals
//      H^T bit for bit, whatever order wgmma sums (a, b) and (b, a) in.
//    - What holds it: the loads, the products and the stores each take
//      about as long alone as the three together should, and they share
//      the SM's shared memory (wgmma operand reads, TMA writes, the
//      staging); they overlap only in part (measurement-only builds on an
//      H100, each leaving one part out).  Larger tiles (pairs of tiles
//      sharing a panel, 128 x 256), tiles paired across a cluster with
//      the shared panel multicast, tokens split over a cluster and finer
//      stages were each slower there.
//  * fma: f32 x (its tolerance, rtol 1e-4, rules out plain TF32) and bf16
//    x that TMA cannot address.  f32 FMAs on the CUDA cores (67 TFLOP/s):
//    - One block of 256 threads per 64 x 64 output tile (bi, bj) with
//      bi <= bj; blocks below the diagonal exit at once.
//    - The token loop runs in chunks of 32 rows: both 32 x 64 column
//      panels of X are staged in shared memory, upcast to f32.  Each thread
//      owns a 4 x 4 register micro-tile and reads its 4 + 4 panel values
//      per row as two 16-byte vectors.
//    - The tile goes through shared memory once more so that both the tile
//      and its transpose are written with coalesced stores.
// No atomics and a fixed summation order on both routes: the same bits on
// every run.  Every T >= 1 and D >= 1 is taken by one route or the other.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // output tile edge
constexpr int BT = 32;     // token rows per staged chunk
constexpr int NT = 256;    // threads per block (16 x 16, 4 x 4 each)
constexpr int MICRO = 4;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ x, float* __restrict__ out, int T_rows, int D) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;  // lower triangle: written as the mirror of (bj, bi)
  // staging: xi[BT][TILE] then xj[BT][TILE]; reused as the output tile
  __shared__ __align__(16) float smem[TILE * (TILE + 1)];
  float* xi = smem;
  float* xj = smem + BT * TILE;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. +4 of the tile (columns of panel i)
  const int tx = tid % 16;  // cols tx*4 .. +4 of the tile (columns of panel j)
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) acc[a][b] = 0.f;

  for (int t0 = 0; t0 < T_rows; t0 += BT) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int idx = tid; idx < BT * TILE; idx += NT) {
      const int r = idx / TILE;
      const int c = idx % TILE;
      const int t = t0 + r;
      const bool row_ok = t < T_rows;
      const size_t base = (size_t)t * D;
      xi[idx] = (row_ok && i0 + c < D) ? to_f32(x[base + i0 + c]) : 0.f;
      xj[idx] = (row_ok && j0 + c < D) ? to_f32(x[base + j0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < BT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(xi + r * TILE + ty * MICRO);
      const float4 b = *reinterpret_cast<const float4*>(xj + r * TILE + tx * MICRO);
      const float av[MICRO] = {a.x, a.y, a.z, a.w};
      const float bv[MICRO] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < MICRO; ++p)
#pragma unroll
        for (int q = 0; q < MICRO; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
  }

  // the tile through shared memory, then the tile and its mirror
  __syncthreads();
  float* tile = smem;  // [TILE][TILE + 1]
#pragma unroll
  for (int p = 0; p < MICRO; ++p)
#pragma unroll
    for (int q = 0; q < MICRO; ++q)
      tile[(ty * MICRO + p) * (TILE + 1) + tx * MICRO + q] = acc[p][q];
  __syncthreads();
  for (int idx = tid; idx < TILE * TILE; idx += NT) {
    const int r = idx / TILE;
    const int c = idx % TILE;
    if (i0 + r < D && j0 + c < D)
      out[(size_t)(i0 + r) * D + j0 + c] = tile[r * (TILE + 1) + c];
    if (bi != bj && j0 + r < D && i0 + c < D)
      out[(size_t)(j0 + r) * D + i0 + c] = tile[c * (TILE + 1) + r];
  }
}

int launch_fma(const void* x, void* out, int T_rows, int D, int x_is_bf16, cudaStream_t s) {
  const int tiles = (D + TILE - 1) / TILE;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, tiles);
  if (x_is_bf16)
    gram_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), T_rows, D);
  else
    gram_kernel<float><<<grid, NT, 0, s>>>(static_cast<const float*>(x),
                                           static_cast<float*>(out), T_rows, D);
  return 0;
}

// ---------------------------------------------------------------------------
// bf16 x that TMA can address: TMA loads, wgmma, TMA stores
// ---------------------------------------------------------------------------

constexpr int WG_TILE = 128;        // output tile edge
constexpr int WG_BK = 64;           // tokens a stage
constexpr int WG_BOX = 64;          // columns of a load box: one swizzled 128-byte row
constexpr int WG_STAGES = 5;        // load ring depth
constexpr int WG_THREADS = 416;     // two wgmma warpgroups, a storing one, a loading warp
constexpr int WG_SMEM_LIMIT = 232448;  // dynamic shared memory a block can have
constexpr int BOX_BYTES = WG_BOX * WG_BK * 2;         // 64 columns x 64 tokens, bf16
constexpr int PANEL_BYTES = 2 * BOX_BYTES;            // 128 columns of a stage
constexpr int STAGE_BYTES = 2 * PANEL_BYTES;          // panels i and j
constexpr int OUT_BOX = 32;         // columns of a store box: 128 bytes of f32
constexpr int STAGING_BYTES = WG_TILE * WG_TILE * 4;  // a tile in f32
constexpr int RING_OFF = 0;
constexpr int S_OFF = RING_OFF + WG_STAGES * STAGE_BYTES;  // the staged tile
constexpr int BAR_OFF = S_OFF + STAGING_BYTES;
constexpr int WG_SMEM = 1024 + BAR_OFF + 128;  // from 1024-byte alignment

static_assert(WG_SMEM <= WG_SMEM_LIMIT, "shared memory");

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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}
// shared memory at src out to the box of `map` at (c0 inner, c1 outer)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barriers: the staging holds a tile (wgmma warps arrive, storing
// warps wait), the staging is free (the other way round), the storing
// warpgroup among itself
constexpr int BAR_S_FULL = 1, BAR_S_FREE = 2, BAR_STORERS = 3;
constexpr int STORERS = 128;           // threads of the storing warpgroup
constexpr int HANDOFF = 256 + STORERS;  // threads at a staging hand-off
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
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

// descriptor of an MN-major bf16 operand in shared memory under the
// 128-byte swizzle: rows of 64 values (128 bytes) along M or N, one row a
// token; 8-token groups 1024 bytes apart (stride byte offset), 64-value
// blocks along M or N 8192 bytes apart (leading byte offset: the next
// load box).  The operand starts 1024-byte aligned; +128 steps 16 tokens.
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(BOX_BYTES >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d = a (64 x 16) @ b (16 x 128) + (scale_d ? d : 0), both MN-major in shared
// memory (128-byte swizzle, transpose bits set), bf16 operands, f32 sums in
// the warpgroup's registers
__device__ __forceinline__ void wgmma_n128_mn(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// byte offset of element (r, c) in a staged 128 x 128 f32 tile: four boxes
// of 32 columns x 128 rows, 16 KB each, rows of 128 bytes whose 16-byte
// chunks are XOR-swizzled by row, as the output tensor map's boxes
__device__ __forceinline__ int staged(int r, int c) {
  return (c >> 5) * (WG_TILE * OUT_BOX * 4) + r * (OUT_BOX * 4) +
         ((((c & (OUT_BOX - 1)) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// tile t of the upper triangle: first the off-diagonal tiles (bi < bj)
// row by row, then the diagonal ones, which load and store half as much,
// so that a last round of fewer tiles than blocks takes the cheap ones
__device__ __forceinline__ void tile_of(int t, int nb, int& bi, int& bj) {
  const int off = nb * (nb - 1) / 2;
  if (t >= off) {
    bi = bj = t - off;
    return;
  }
  int row = 0;
  while (t >= nb - 1 - row) {
    t -= nb - 1 - row;
    ++row;
  }
  bi = row;
  bj = row + 1 + t;
}

// the k-th tile of the block's walk: rounds of gridDim.x tiles, every
// other round in reverse, so that a last round of fewer tiles than blocks
// (diagonal tiles, which load and store half as much) goes to the blocks
// whose tile in the round before was diagonal too
__device__ __forceinline__ int walk(int k) {
  const int g = gridDim.x, b = blockIdx.x;
  return (k & 1) ? (k + 1) * g - 1 - b : k * g + b;
}

// Persistent: block b walks tiles walk(0), walk(1), ... (`tile_of`).
// Warps 0-7 run the wgmmas and leave each tile's sums in the staging;
// warps 8-11 store it (TMA) and its mirror (from the staging, 16-byte
// stores) while the next tile's products run; warp 12 loads.  The stage
// counters run on across tiles, so the ring does too.  Every wgmma and
// every read of the accumulators stays out of divergent code (ptxas
// serializes the wgmmas otherwise).
__global__ void __launch_bounds__(WG_THREADS, 1)
gram_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_out, float* __restrict__ out,
                  int T_rows, int D) {
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* base = wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
  unsigned char* ring = base + RING_OFF;
  unsigned char* S = base + S_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + BAR_OFF);
  uint64_t* empty = full + WG_STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = (D + WG_TILE - 1) / WG_TILE;
  const int tiles = nb * (nb + 1) / 2;
  const int kt = (T_rows + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int k = 0; k < WG_STAGES; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], 8);  // one arrival a wgmma warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the next kernel may set up; it reads nothing of ours before this grid ends
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp == 12) {  // the loader: one thread
    if (lane != 0) return;
    // every global access of the block follows this one's loads: they wait
    // for the kernel before to end
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    int i = 0;
    for (int k = 0, t = walk(0); t < tiles; t = walk(++k)) {
      int bi, bj;
      tile_of(t, nb, bi, bj);
      for (int ks = 0; ks < kt; ++ks, ++i) {
        uint64_t* bar = &full[i % WG_STAGES];
        unsigned char* st = ring + (i % WG_STAGES) * STAGE_BYTES;
        if (i >= WG_STAGES) mbar_wait(&empty[i % WG_STAGES], ((i / WG_STAGES) - 1) & 1);
        const int t0 = ks * WG_BK;  // the stage's first token
        mbar_expect_tx(bar, bi == bj ? PANEL_BYTES : STAGE_BYTES);
        tma_load(st, &tm_x, bar, bi * WG_TILE, t0);
        tma_load(st + BOX_BYTES, &tm_x, bar, bi * WG_TILE + WG_BOX, t0);
        if (bi != bj) {
          tma_load(st + PANEL_BYTES, &tm_x, bar, bj * WG_TILE, t0);
          tma_load(st + PANEL_BYTES + BOX_BYTES, &tm_x, bar, bj * WG_TILE + WG_BOX, t0);
        }
      }
    }
    return;
  }

  if (warp >= 8) {  // the storing warpgroup
    const int et = threadIdx.x - 256;
    // a thread's 4 x 4 blocks: rows R .. R + 3 and columns C .. C + 3 of the
    // tile, R = 16 (g >> 2) + 4 (lane >> 3), C = 32 (g & 3) + 4 (lane & 7)
    // for g = warp - 8, + 4, ..., so each 8 lanes read 8 distinct chunks
    named_arrive(BAR_S_FREE, HANDOFF);
    for (int k = 0, t = walk(0); t < tiles; t = walk(++k)) {
      int bi, bj;
      tile_of(t, nb, bi, bj);
      const int i0 = bi * WG_TILE, j0 = bj * WG_TILE;
      named_sync(BAR_S_FULL, HANDOFF);  // the staging holds tile t
      if (bi == bj) {  // the upper half mirrored over the lower one
        for (int g = warp - 8; g < 32; g += 4) {
          const int R = 16 * (g >> 2) + 4 * (lane >> 3), C = 32 * (g & 3) + 4 * (lane & 7);
          if (R > C) continue;
          float4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = *reinterpret_cast<const float4*>(S + staged(R + k, C));
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float w[4] = {(&v[0].x)[m], (&v[1].x)[m], (&v[2].x)[m], (&v[3].x)[m]};
            if (R < C) {
              *reinterpret_cast<float4*>(S + staged(C + m, R)) = make_float4(w[0], w[1], w[2], w[3]);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (k < m) *reinterpret_cast<float*>(S + staged(C + m, R + k)) = w[k];
            }
          }
        }
        fence_proxy_async();  // the staging's writes, seen by the TMA stores
      }
      named_sync(BAR_STORERS, STORERS);
      if (et == 0) {
#pragma unroll
        for (int b = 0; b < WG_TILE / OUT_BOX; ++b)
          tma_store(&tm_out, S + b * (WG_TILE * OUT_BOX * 4), j0 + b * OUT_BOX, i0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (bi != bj) {  // the mirror tile (bj, bi): rows C + m, columns R .. R + 3
        for (int g = warp - 8; g < 32; g += 4) {
          const int R = 16 * (g >> 2) + 4 * (lane >> 3), C = 32 * (g & 3) + 4 * (lane & 7);
          float4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = *reinterpret_cast<const float4*>(S + staged(R + k, C));
          if (i0 + R >= D) continue;  // D % 8 == 0: all four columns or none
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (j0 + C + m < D)
              *reinterpret_cast<float4*>(out + (size_t)(j0 + C + m) * D + i0 + R) =
                  make_float4((&v[0].x)[m], (&v[1].x)[m], (&v[2].x)[m], (&v[3].x)[m]);
        }
      }
      // the staging is free once the TMA stores have read it
      if (et == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if (walk(k + 1) < tiles) named_arrive(BAR_S_FREE, HANDOFF);
    }
    // the last stores are done before the block's shared memory goes
    if (et == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // wgmma warpgroups: wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = threadIdx.x >> 7;
  const int g = lane >> 2, cq = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;  // rows r0 and r0 + 8 of the tile
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  int i = 0;  // stages
  for (int k = 0, t = walk(0); t < tiles; t = walk(++k)) {
    int bi, bj;
    tile_of(t, nb, bi, bj);
    int px = -1;  // the previous stage, to hand back once its wgmmas are done
    for (int ks = 0; ks < kt; ++ks, ++i) {
      mbar_wait(&full[i % WG_STAGES], (i / WG_STAGES) & 1);
      const unsigned char* st = ring + (i % WG_STAGES) * STAGE_BYTES;
      const uint64_t da = mn_desc(st + wg * BOX_BYTES);
      const uint64_t db = mn_desc(bi == bj ? st : st + PANEL_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)  // a tile's first product overwrites
        wgmma_n128_mn(acc, da + 128 * kk, db + 128 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      fence_acc(acc);
      // stage i's wgmmas run on into stage i+1; stage i-1's are done
      wgmma_wait<1>();
      fence_acc(acc);
      if (lane == 0 && px >= 0) mbar_arrive(&empty[px % WG_STAGES]);
      px = i;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[px % WG_STAGES]);
    // the sums into the staging once the storing warps are done with it:
    // element (r, c) of the tile is acc[4 jn + 2 h + e] at r = r0 + 8 h,
    // c = 8 jn + 2 cq + e
    named_sync(BAR_S_FREE, HANDOFF);
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(S + staged(r0 + 8 * h, 8 * jn + 2 * cq)) =
            make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    fence_proxy_async();  // the staging's writes, seen by the TMA stores
    named_arrive(BAR_S_FULL, HANDOFF);
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

// a 2-D row-major tensor (outer x inner, rows row_bytes apart) in boxes of
// outer_box x inner_box under the 128-byte swizzle; loads read zeros out of
// range, stores are clipped there.  Returns 0, or ENCODE_FAILED + the
// driver's CUresult.
constexpr int ENCODE_FAILED = 10000;
int make_map(CUtensorMap* m, CUtensorMapDataType dt, const void* ptr, uint64_t inner,
             uint64_t outer, uint64_t row_bytes, uint32_t inner_box, uint32_t outer_box) {
  const EncodeTiled enc = encoder();
  if (!enc) return ENCODE_FAILED;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {inner_box, outer_box};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = enc(m, dt, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)rc;
}

int launch_wgmma(const void* x, void* out, int T_rows, int D, int grid, cudaStream_t s) {
  CUtensorMap mx, mo;
  int rc = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, D, T_rows, 2ull * D, WG_BOX,
                    WG_BK);
  if (!rc)
    rc = make_map(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, D, D, 4ull * D, OUT_BOX,
                  WG_TILE);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(gram_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = WG_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gram_wgmma_kernel, mx, mo, static_cast<float*>(out),
                                 T_rows, D);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (T, D) contiguous, f32 or bf16 (x_is_bf16); out (D, D) f32 contiguous.
// Routes, as kernels/gram.py `gram_plan` picks them:
//   0 fma:   any x; one block a 64 x 64 tile of the grid's square.
//   1 wgmma: bf16 x, D % 8 == 0, x and out 16-byte aligned; `grid`
//            persistent blocks, at most one a tile of the upper triangle.
// Returns 0, a cudaError_t code, or 10000 + the CUresult of a tensor map
// that could not be encoded.
extern "C" int gram_launch(const void* x, void* out, int T_rows, int D, int x_is_bf16,
                           int route, int grid, void* stream) {
  if (T_rows < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (route == 0) {
    rc = launch_fma(x, out, T_rows, D, x_is_bf16, s);
  } else if (route == 1) {
    const long long nb = (D + WG_TILE - 1) / WG_TILE;
    if (!x_is_bf16 || D % 8 || !aligned16(x) || !aligned16(out) || grid < 1 ||
        grid > nb * (nb + 1) / 2)
      return (int)cudaErrorInvalidValue;
    rc = launch_wgmma(x, out, T_rows, D, grid, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
