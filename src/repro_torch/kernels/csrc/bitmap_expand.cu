// Frontier expansion over a dense boolean adjacency block:
//   next[r, w] = OR_v frontier[r, v] & adjacency[v, w]
// frontier (R, V) bool, adjacency (V, W) bool, next (R, W) bool, all one
// byte per entry, row-major and contiguous.
//
// Replaces the TPU kernel src/repro/kernels/frontier.py::bitmap_expand
// (_expand_kernel, pallas_call at frontier.py:79).  The TPU casts both
// operands to f32, accumulates an MXU product over a sequential K grid in a
// VMEM scratch tile and thresholds it at > 0.5 on the last K step.
//
// Bound.  The OR-AND product is an exact int8 product with int32
// accumulation (next = count > 0), so its least time is
// max((R*V + V*W + R*W) bytes over 3.35 TB/s, 2*R*V*W ops over the 1,979 T
// int8 tensor-core op/s).  At (64,2048)x(2048,2048) that is 4,456,448
// bytes, 1.33 us, bound by bytes (about 120 ops a byte, under the int8
// ridge of about 590); at the hub block of the hybrid relay,
// (40,128)x(128,128), it is launch latency that bounds a call.
//
// Design: int8 tensor cores through mma.sync.  The product is bound by
// bytes, so mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (inline PTX)
// has far more rate than the call needs; wgmma would add 64-row warpgroup
// tiles and shared-memory descriptors over a K-major B that has to be
// transposed here anyway, for no gain at this intensity.
//  * A block owns a TM x TN = 64 x 32 output tile (4 warps, each a 16 x 32
//    slice of it, four n8 tiles) and a range of V, which it walks in
//    TK = 128-byte steps through a 3-stage cp.async ring: each stage copies
//    a 64 x 128 frontier tile and a 128 x 32 adjacency tile, as they lie in
//    memory, with 16-byte copies (zero-filled out of range).  The loop over
//    K inside the block takes the place of the TPU's sequential K grid.
//    (64 x 64 tiles of 8 warps, which halve the frontier's re-reads from
//    L2, and a 4-stage ring measured slower on one H100.)
//  * Split K over a thread-block cluster.  With one block per output tile,
//    W = 2048 gives 64 blocks of 4 warps on 132 SMs, each walking 16 stages
//    whose latencies (copy, transpose, MMA) nothing hides (19 us on one
//    H100 at 700 W).  So V is split over up to 8 blocks of one cluster
//    (about two blocks per SM), each block keeps a bit per output (count
//    > 0 in its range) in shared memory, and after a cluster barrier each
//    block ORs its share of the tile's rows across the cluster's shared
//    memory (DSMEM) and stores them.  Nothing goes through device memory
//    between blocks, and the result does not depend on the order blocks
//    run in.  A launch whose V is not split (the hub block, V = 128) is a
//    plain launch that stores its outputs directly.
//  * Operand layout.  The s8 MMA wants both operands K-major.  The frontier
//    (R, V) is: its fragments come straight from the stage with
//    ldmatrix.x4.  The adjacency (V, W) is W-major, and ldmatrix has no
//    transposing form for 8-bit types, so each stage's adjacency tile is
//    transposed into a (TN, TK) tile in 4 x 4-byte blocks with __byte_perm
//    before its fragments are read with ldmatrix.x4.  Rows are padded by
//    16 bytes so that the eight 16-byte rows of an ldmatrix hit 32
//    different banks.
//  * Bool bytes that are not 0 or 1 (a 0xFF would be -1 as s8 and cancel
//    counts) are folded to 0/1: the adjacency while it is transposed, the
//    frontier in its fragment registers.  Counts are then at most V.
//  * Ragged shapes are zero-filled on staging and masked on store, never
//    padded in memory; warps whose 16 rows all lie past R skip the MMAs.
//  * When a row pitch or a base address is not a multiple of 16 bytes
//    (the launch's `vec` flag), the stages are filled with byte loads
//    instead: the same ring, slower.
//  * Once every output of the block has a nonzero count the block stops
//    walking K (__syncthreads_and), the block-wide form of stopping early.
// Launches on the caller's stream; returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TM = 64;                    // output rows per block
constexpr int TN = 32;                    // output columns per block
constexpr int TK = 128;                   // K bytes per stage
constexpr int NSTAGE = 3;                 // cp.async ring depth
constexpr int WARPS_M = TM / 16;          // warps down the rows, 16 each
constexpr int WARPS_N = TN / 32;          // warps across the columns, 32 each
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int PITCH = TK + 16;            // padded K-major row, bytes
constexpr int A_STAGE = TM * PITCH;       // frontier tile
constexpr int B_STAGE = TK * TN;          // adjacency tile as it lies
constexpr int SMEM = NSTAGE * (A_STAGE + B_STAGE) + TN * PITCH;
constexpr int VEC = 16;
constexpr int MAX_SPLIT = 8;              // blocks of a cluster (portable)

// each nonzero byte of x -> 0x01, each zero byte -> 0x00: the shifts fold a
// byte's eight bits into its bit 0; bits shifted in from the next byte land
// in bits 4-7 first and never reach bit 0
__device__ __forceinline__ unsigned int bytes_to_bits(unsigned int x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return x & 0x01010101u;
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned int (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned int (&a)[4],
                                       unsigned int b0, unsigned int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one stage of the ring: the frontier tile rows [m0, m0 + TM) x K bytes
// [k0, k0 + TK) into a (TM, PITCH) tile, the adjacency tile K [k0, k0 + TK)
// x columns [n0, n0 + TN) into a (TK, TN) tile, zero outside the arrays
template <bool kVec>
__device__ __forceinline__ void load_stage(
    unsigned char* a_s, unsigned char* b_s, const unsigned char* frontier,
    const unsigned char* adjacency, int R, int V, int W, int m0, int n0,
    int k0, int tid) {
  for (int idx = tid; idx < TM * (TK / VEC); idx += THREADS) {
    const int row = idx / (TK / VEC), kk = (idx % (TK / VEC)) * VEC;
    const int r = m0 + row, k = k0 + kk;
    unsigned char* dst = a_s + row * PITCH + kk;
    const unsigned char* src = frontier + static_cast<size_t>(r) * V + k;
    if constexpr (kVec) {
      // V is a multiple of VEC: a copy is all in range or all out
      const bool ok = r < R && k < V;
      cp_async16(dst, ok ? src : frontier, ok);
    } else {
      for (int j = 0; j < VEC; ++j)
        dst[j] = (r < R && k + j < V) ? src[j] : 0;
    }
  }
  for (int idx = tid; idx < TK * (TN / VEC); idx += THREADS) {
    const int kk = idx / (TN / VEC), cc = (idx % (TN / VEC)) * VEC;
    const int k = k0 + kk, c = n0 + cc;
    unsigned char* dst = b_s + kk * TN + cc;
    const unsigned char* src = adjacency + static_cast<size_t>(k) * W + c;
    if constexpr (kVec) {
      const bool ok = k < V && c < W;
      cp_async16(dst, ok ? src : adjacency, ok);
    } else {
      for (int j = 0; j < VEC; ++j)
        dst[j] = (k < V && c + j < W) ? src[j] : 0;
    }
  }
}

// the (TK, TN) adjacency tile -> the K-major (TN, PITCH) tile, as 0/1 bytes:
// each thread moves 4 x 4-byte blocks, rows k..k+3 x columns n..n+3
__device__ __forceinline__ void transpose_stage(const unsigned char* b_s,
                                                unsigned char* bt_s, int tid) {
  for (int blk = tid; blk < (TK / 4) * (TN / 4); blk += THREADS) {
    const int ng = blk % (TN / 4), kg = blk / (TN / 4);
    const unsigned int* src =
        reinterpret_cast<const unsigned int*>(b_s + (4 * kg) * TN) + ng;
    const unsigned int a = bytes_to_bits(src[0]);
    const unsigned int b = bytes_to_bits(src[TN / 4]);
    const unsigned int c = bytes_to_bits(src[2 * (TN / 4)]);
    const unsigned int d = bytes_to_bits(src[3 * (TN / 4)]);
    const unsigned int ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
    const unsigned int ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
    const unsigned int cd_lo = __byte_perm(c, d, 0x5140);
    const unsigned int cd_hi = __byte_perm(c, d, 0x7362);
    unsigned char* dst = bt_s + (4 * ng) * PITCH + 4 * kg;
    *reinterpret_cast<unsigned int*>(dst) = __byte_perm(ab_lo, cd_lo, 0x5410);
    *reinterpret_cast<unsigned int*>(dst + PITCH) =
        __byte_perm(ab_lo, cd_lo, 0x7632);
    *reinterpret_cast<unsigned int*>(dst + 2 * PITCH) =
        __byte_perm(ab_hi, cd_hi, 0x5410);
    *reinterpret_cast<unsigned int*>(dst + 3 * PITCH) =
        __byte_perm(ab_hi, cd_hi, 0x7632);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS) bitmap_expand_kernel(
    const unsigned char* __restrict__ frontier,
    const unsigned char* __restrict__ adjacency,
    unsigned char* __restrict__ out, int R, int V, int W, int split_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_ring = smem;                         // NSTAGE x A_STAGE
  unsigned char* b_ring = smem + NSTAGE * A_STAGE;      // NSTAGE x B_STAGE
  unsigned char* bt_s = b_ring + NSTAGE * B_STAGE;      // TN x PITCH
  // bit c of hit[row * WARPS_N + h]: output (m0 + row, n0 + 32 h + c) counts
  // > 0 in this block's range of V (read across the cluster)
  __shared__ unsigned int hit[TM * WARPS_N];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;  // 16-row x 32-column slice
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row / column group
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int wrow = m0 + wm * 16;            // this warp's first output row
  const int wcol = n0 + wn * 32;            // ... and first output column
  const bool active = wrow < R && wcol < W;

  int acc[4][4];                            // [n8 tile][c0..c3]
  for (int t = 0; t < 4; ++t)
    for (int c = 0; c < 4; ++c) acc[t][c] = 0;

  // ldmatrix row addresses: A rows 0-15 x K halves; B columns 0-15 of a
  // pair of n8 tiles x K halves
  const int a_row = wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  // this block's TK chunks of V: [k_first, k_first + KT)
  const int k_first = blockIdx.z * split_chunks;
  const int KT = min((V + TK - 1) / TK - k_first, split_chunks);
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < KT)
      load_stage<kVec>(a_ring + s * A_STAGE, b_ring + s * B_STAGE, frontier,
                       adjacency, R, V, W, m0, n0, (k_first + s) * TK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<NSTAGE - 2>();          // stage kt has landed
    __syncthreads();                      // ... for every thread; kt-1 is free
    const int nxt = kt + NSTAGE - 1;
    if (nxt < KT)
      load_stage<kVec>(a_ring + (nxt % NSTAGE) * A_STAGE,
                       b_ring + (nxt % NSTAGE) * B_STAGE, frontier, adjacency,
                       R, V, W, m0, n0, (k_first + nxt) * TK, tid);
    cp_async_commit();
    const unsigned char* a_s = a_ring + (kt % NSTAGE) * A_STAGE;
    transpose_stage(b_ring + (kt % NSTAGE) * B_STAGE, bt_s, tid);
    __syncthreads();

    if (active) {
      for (int kk = 0; kk < TK; kk += 32) {
        unsigned int a[4], b01[4], b23[4];
        ldmatrix_x4(a, a_s + a_row * PITCH + kk + a_col);
        for (int i = 0; i < 4; ++i) a[i] = bytes_to_bits(a[i]);
        ldmatrix_x4(b01, bt_s + b_row * PITCH + kk + b_col);
        ldmatrix_x4(b23, bt_s + (16 + b_row) * PITCH + kk + b_col);
        mma_s8(acc[0], a, b01[0], b01[1]);
        mma_s8(acc[1], a, b01[2], b01[3]);
        mma_s8(acc[2], a, b23[0], b23[1]);
        mma_s8(acc[3], a, b23[2], b23[3]);
      }
    }

    // every output of the block is true: the rest of K cannot change it
    bool done = true;
    for (int t = 0; t < 4; ++t)
      for (int c = 0; c < 4; ++c) {
        const int r = wrow + g + (c >> 1) * 8;
        const int w = wcol + t * 8 + tig * 2 + (c & 1);
        if (r < R && w < W && acc[t][c] == 0) done = false;
      }
    if (__syncthreads_and(done)) break;   // also frees bt_s for the next kt
  }
  asm volatile("cp.async.wait_all;\n" ::);

  if (gridDim.z == 1) {                   // V not split: store directly
    for (int t = 0; t < 4; ++t)
      for (int c = 0; c < 4; ++c) {
        const int r = wrow + g + (c >> 1) * 8;
        const int w = wcol + t * 8 + tig * 2 + (c & 1);
        if (r < R && w < W)
          out[static_cast<size_t>(r) * W + w] = acc[t][c] > 0;
      }
    return;
  }

  // this block's bits: rows g and g + 8 of the warp's slice, the four
  // threads of a row group ORed together
  unsigned int lo = 0u, hi = 0u;
  for (int t = 0; t < 4; ++t)
    for (int c = 0; c < 4; ++c)
      if (acc[t][c] > 0) {
        const unsigned int bit = 1u << (t * 8 + tig * 2 + (c & 1));
        if (c < 2) lo |= bit; else hi |= bit;
      }
  lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
  lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
  hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
  hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
  if (tig == 0) {
    hit[(wm * 16 + g) * WARPS_N + wn] = lo;
    hit[(wm * 16 + g + 8) * WARPS_N + wn] = hi;
  }

  // OR across the cluster: block q stores rows q, q + split, ... of the
  // tile, four columns a thread
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int split = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int my_rows = (TM - q + split - 1) / split;
  for (int idx = tid; idx < my_rows * (TN / 4); idx += THREADS) {
    const int row = q + (idx / (TN / 4)) * split;
    const int c4 = (idx % (TN / 4)) * 4;
    const int r = m0 + row;
    if (r >= R) continue;
    unsigned int word = 0u;
    for (int b = 0; b < split; ++b)
      word |= cluster.map_shared_rank(&hit[0], b)[row * WARPS_N + c4 / 32];
    unsigned char* o = out + static_cast<size_t>(r) * W + n0 + c4;
    for (int j = 0; j < 4; ++j)
      if (n0 + c4 + j < W) o[j] = (word >> (c4 % 32 + j)) & 1u;
  }
  cluster.sync();   // every block's hit[] stays until the cluster has read it
}

template <bool kVec>
int launch(const unsigned char* f, const unsigned char* a, unsigned char* o,
           int r, int v, int w, cudaStream_t s) {
  static int n_sm = 0;            // once per instance
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (SMEM > 48 * 1024 && rc == cudaSuccess)   // above the default: opt in
      rc = cudaFuncSetAttribute(bitmap_expand_kernel<kVec>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM);
    if (rc != cudaSuccess) {
      n_sm = 0;
      return static_cast<int>(rc);
    }
  }
  // split V so that about two blocks run on each SM, at most MAX_SPLIT
  // ways, every block with at least one chunk
  const int gx = (w + TN - 1) / TN, gy = (r + TM - 1) / TM;
  const int chunks = (v + TK - 1) / TK;
  const int want = (2 * n_sm + gx * gy - 1) / (gx * gy);
  int split = min(MAX_SPLIT, min(chunks, max(1, want)));
  const int per_block = (chunks + split - 1) / split;
  split = (chunks + per_block - 1) / per_block;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;       // one block a tile: no cluster
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, bitmap_expand_kernel<kVec>,
                                            f, a, o, r, v, w, per_block);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bitmap_expand_launch(const void* frontier, const void* adjacency,
                                    void* out, int r, int v, int w, int vec,
                                    void* stream) {
  const auto f = static_cast<const unsigned char*>(frontier);
  const auto a = static_cast<const unsigned char*>(adjacency);
  const auto o = static_cast<unsigned char*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(f, a, o, r, v, w, s)
             : launch<false>(f, a, o, r, v, w, s);
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
