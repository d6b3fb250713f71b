// The hybrid relay in one pass over the graph: the sparse tail and the dense
// hub-hub block of core/frontier.py's hybrid backend, fused.
//
//   next[k, w] = OR_{e in tail row w} f[k, tail_col[e]]
//              | (w is hub p) & OR_h f[k, hub_ids[h]] & adj[h, p]
//
// f (K, V) bool, next (K, V) bool.  The tail is CSR rows (tail_ptr (V + 1),
// tail_col (E_tail)) of the edges the G- mask keeps that are not hub-hub
// edges; the self-loop padding stays in it.  adj is the (H, H) hub block as
// 32-bit words, 32 little-endian columns per word (core.packing layout).
//
// Replaces what the reference's hybrid relay runs on a TPU
// (src/repro/core/frontier.py::FrontierEngine._relay_hybrid: the tail's
// segment_max and the Pallas kernel
// src/repro/kernels/frontier.py::bitmap_expand_packed, pallas_call at
// frontier.py:148, on the hub block).  Every labelling, Bi-BFS, reverse-sweep
// and one-sided BFS level under backend="hybrid" runs through it, at K = 1,
// 32 (a query chunk) or 40 (2R labelling rows), V = 1.1 M on the smoke graph.
//
// Pull, not push: the tail's edge set and any baked mask are symmetric, so
// OR over the in-edges of w equals OR over row w's out-edges, and a row is a
// contiguous run of tail_col (the tail is a subsequence of the src-sorted
// edge list).  Each output is written once by one owner: no atomics, no
// (K, E) message temporary.  The hub block is symmetric too, so its row p
// holds column p.
//
// Bound: bytes.  It must read f (K * V bytes), tail_col (4 * E_tail),
// tail_ptr (4 * (V + 1)) and write next (K * V); about 100 MB at K = 32 on
// the smoke graph, ~30 us at 3.35 TB/s.  The work is one OR per tail edge
// and word, far below the byte time.
//
// Design, two launches on the caller's stream:
// 1. pack: f is transposed into fT (V, W) 32-bit words, W = ceil(K / 32),
//    bit k % 32 of word k / 32 = f[k, x].  A thread takes 4 adjacent
//    vertices and reads 4 bytes of each of its word's 32 rows (one 32-bit
//    load each when V % 4 == 0: adjacent threads, adjacent addresses).  At
//    K = 32, fT is 4 bytes a vertex (4.4 MB at V = 1.1 M) and stays in the
//    50 MB L2, where the pull's random gathers hit.
// 2. pull and unpack.  Rows longer than a warp (the H hub rows, which in a
//    scale-free graph are the longest, and any other tail row of more than
//    32 edges) each get a warp: its lanes stride the row and a
//    __reduce_or_sync finishes the OR.  A hub warp also ORs the hub term:
//    lane l takes bit l of each 32-column word of the block's row p, so only
//    the set bits issue a load and all-zero words are skipped whole.  Each
//    column is read by one warp once per relay, so it is read through L1/L2
//    and not staged in shared memory (staging would read the block once per
//    thread block instead of once).  Every other vertex gets a lane of a
//    warp that owns 32 adjacent vertices (warp_bits marks the rows that a
//    row warp owns, so such a lane stays idle).  The result goes straight to
//    the (K, V) bools: for each k the warp's 32 lanes store 32 adjacent
//    bytes, one full 32-byte sector per store, never one bool per sector
//    down a column.  Row warps write their column's K bytes; they are few.
// No floats are involved, so the result is exact.  Returns
// cudaGetLastError() after both launches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PACK_THREADS = 256;
constexpr int WARPS = 8;  // warps per pull block

__device__ __forceinline__ uint32_t nonzero_byte(uint32_t q, int i) {
  return ((q >> (8 * i)) & 0xffu) != 0u;
}

template <bool VEC>
__global__ void pack_kernel(const uint8_t* __restrict__ f,
                            uint32_t* __restrict__ ft, int K, int V, int W) {
  const int x0 = 4 * (blockIdx.x * PACK_THREADS + threadIdx.x);
  const int j = blockIdx.y;
  if (x0 >= V) return;
  const int nb = min(32, K - 32 * j);
  const int nx = min(4, V - x0);
  const uint8_t* base = f + static_cast<size_t>(32 * j) * V + x0;
  uint32_t a[4] = {0u, 0u, 0u, 0u};
  if (VEC) {  // V % 4 == 0 and a 4-byte aligned base: nx == 4
#pragma unroll 8
    for (int b = 0; b < nb; ++b) {
      const uint32_t q = __ldg(reinterpret_cast<const uint32_t*>(
          base + static_cast<size_t>(b) * V));
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] |= nonzero_byte(q, i) << b;
    }
  } else {
#pragma unroll 4
    for (int b = 0; b < nb; ++b) {
      const uint8_t* row = base + static_cast<size_t>(b) * V;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nx) a[i] |= static_cast<uint32_t>(row[i] != 0) << b;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < nx) ft[static_cast<size_t>(x0 + i) * W + j] = a[i];
}

__global__ void pull_kernel(const uint32_t* __restrict__ ft,
                            const int* __restrict__ ptr,
                            const int* __restrict__ col,
                            const int* __restrict__ hub_ids,
                            const uint32_t* __restrict__ adj,
                            const int* __restrict__ warp_rows,
                            const uint32_t* __restrict__ warp_bits,
                            uint8_t* __restrict__ out, int K, int V, int W,
                            int H, int NWH, int n_rows, int row_blocks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    // a warp per long row; rows 0..H-1 are the hubs, in hub order
    const int i = blockIdx.x * WARPS + warp;
    if (i >= n_rows) return;  // uniform across the warp
    const int w = warp_rows[i];
    const int beg = ptr[w], end = ptr[w + 1];
    for (int j = 0; j < W; ++j) {
      uint32_t acc = 0u;
      for (int e = beg + lane; e < end; e += 32)
        acc |= ft[static_cast<size_t>(col[e]) * W + j];
      if (i < H) {
        const uint32_t* hub_row = adj + static_cast<size_t>(i) * NWH;
        for (int t = 0; t < NWH; ++t) {
          const uint32_t word = hub_row[t];
          if (word == 0u) continue;  // uniform: every lane read this word
          const int h = 32 * t + lane;
          if (((word >> lane) & 1u) && h < H)
            acc |= ft[static_cast<size_t>(hub_ids[h]) * W + j];
        }
      }
      acc = __reduce_or_sync(FULL, acc);
      const int k = 32 * j + lane;
      if (k < K) out[static_cast<size_t>(k) * V + w] = (acc >> lane) & 1u;
    }
    return;
  }
  // a warp per 32 adjacent vertices, a lane per vertex
  const int w0 = ((blockIdx.x - row_blocks) * WARPS + warp) * 32;
  if (w0 >= V) return;  // uniform across the warp
  const int w = w0 + lane;
  const bool mine = w < V && !((warp_bits[w0 >> 5] >> lane) & 1u);
  const int beg = mine ? ptr[w] : 0;
  const int end = mine ? ptr[w + 1] : 0;
  for (int j = 0; j < W; ++j) {
    uint32_t acc = 0u;
    int e = beg;
    for (; e + 4 <= end; e += 4) {
      const int c0 = col[e], c1 = col[e + 1], c2 = col[e + 2], c3 = col[e + 3];
      acc |= ft[static_cast<size_t>(c0) * W + j] |
             ft[static_cast<size_t>(c1) * W + j] |
             ft[static_cast<size_t>(c2) * W + j] |
             ft[static_cast<size_t>(c3) * W + j];
    }
    for (; e < end; ++e) acc |= ft[static_cast<size_t>(col[e]) * W + j];
    if (mine) {
      const int nb = min(32, K - 32 * j);
      uint8_t* o = out + static_cast<size_t>(32 * j) * V + w;
#pragma unroll 4
      for (int b = 0; b < nb; ++b)
        o[static_cast<size_t>(b) * V] = (acc >> b) & 1u;
    }
  }
}

}  // namespace

extern "C" int hybrid_relay_launch(const void* f, const void* tail_ptr,
                                   const void* tail_col, const void* hub_ids,
                                   const void* adj_words, const void* warp_rows,
                                   const void* warp_bits, void* ft, void* out,
                                   int k, int v, int h, int nwh, int n_rows,
                                   int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = (k + 31) / 32;
  const dim3 pack_grid((v + 4 * PACK_THREADS - 1) / (4 * PACK_THREADS), w);
  const uint8_t* fb = static_cast<const uint8_t*>(f);
  uint32_t* ftw = static_cast<uint32_t*>(ft);
  if (vec)
    pack_kernel<true><<<pack_grid, PACK_THREADS, 0, s>>>(fb, ftw, k, v, w);
  else
    pack_kernel<false><<<pack_grid, PACK_THREADS, 0, s>>>(fb, ftw, k, v, w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n_rows + WARPS - 1) / WARPS;
  const int vertex_blocks = ((v + 31) / 32 + WARPS - 1) / WARPS;
  pull_kernel<<<row_blocks + vertex_blocks, 32 * WARPS, 0, s>>>(
      ftw, static_cast<const int*>(tail_ptr), static_cast<const int*>(tail_col),
      static_cast<const int*>(hub_ids), static_cast<const uint32_t*>(adj_words),
      static_cast<const int*>(warp_rows),
      static_cast<const uint32_t*>(warp_bits), static_cast<uint8_t*>(out), k,
      v, w, h, nwh, n_rows, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
