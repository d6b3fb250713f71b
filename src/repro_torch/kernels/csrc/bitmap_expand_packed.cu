// Frontier expansion over a bit-packed adjacency block:
//   next[r, c] = OR_v frontier[r, v] & bit(adj_words[v, c / 32], c % 32)
// frontier (K, V) bool, adj_words (V, NW) 32-bit words (32 little-endian
// columns per word), next (K, n_cols) bool.
//
// Replaces the TPU kernel src/repro/kernels/frontier.py::bitmap_expand_packed
// (_expand_packed_kernel, pallas_call at frontier.py:148) at its own
// signature.  The port's hybrid relay runs the same OR-AND on the hub block
// inside csrc/hybrid_relay.cu; this kernel is the public
// kernels.ops.bitmap_expand_packed, which chip_smoke.py runs on the real hub
// block (V = NW * 32 = n_cols = 128 hubs, K = 40 landmark frontier rows) as
// the dense-oracle path's check.
//
// Bound: bytes.  It must read the frontier (K * V bytes) and the words
// (V * NW * 4 bytes) and write K * n_cols bytes; the work is one word OR per
// set frontier bit and word.  At (32, 128) x (128, 4 words) that is under
// 7 KB, so launch latency dominates.
//
// Design: the TPU kernel unpacks word tiles and runs an f32 MXU product;
// Hopper needs no matrix unit for this.  One warp per frontier row, 8 rows
// per block.  The block stages the (V, NW) words in shared memory when they
// fit in 48 KB (2 KB at V = 128), else the warps read them through L2; on an
// H100 staging was 8-10% faster than reading through L1/L2 at V = 128 and
// V = 2048.  The warp's first 128 frontier bytes are loaded before the
// staging barrier, so the two loads overlap.  Lanes go across the frontier
// (lane l reads bytes l, l + 32, ..., coalesced), and a lane whose byte is
// set ORs that vertex's adjacency words into registers, 4 words (128
// columns) at a time: only the set bits issue a load, and the loads of one
// lane are independent, so a row costs about one load latency and not one
// per set bit.  A __reduce_or_sync per word combines the lanes; then lane l
// stores column 32 * i + l of each word i, so the output bytes go out
// coalesced.  Row
// counts and V are unbounded (no frontier staging).  Exact: no floats.
// Launches on the caller's stream; returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 8;   // warps (frontier rows) per block
constexpr int CHUNK = 4;  // frontier bytes a lane holds: 128 vertices a warp

__device__ __forceinline__ void load_chunk(const uint8_t* row, int v0, int lane,
                                           int V, uint8_t (&fb)[CHUNK]) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const int v = v0 + 32 * i + lane;
    fb[i] = v < V ? row[v] : 0;
  }
}

template <bool STAGE>
__global__ void bitmap_expand_packed_kernel(
    const uint8_t* __restrict__ frontier, const uint32_t* __restrict__ words,
    uint8_t* __restrict__ out, int K, int V, int NW, int n_cols) {
  extern __shared__ uint32_t staged[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const uint8_t* row = frontier + static_cast<size_t>(min(r, K - 1)) * V;
  uint8_t fb[CHUNK];
  load_chunk(row, 0, lane, r < K ? V : 0, fb);  // in flight over the stage
  const uint32_t* adj = words;
  if (STAGE) {
    for (int i = threadIdx.x; i < V * NW; i += blockDim.x) staged[i] = words[i];
    __syncthreads();
    adj = staged;
  }
  if (r >= K) return;  // uniform across the warp; no barrier follows
  uint8_t* o = out + static_cast<size_t>(r) * n_cols;
  for (int g = 0; g < NW; g += 4) {  // words g .. g + 3
    const int ng = min(4, NW - g);
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    for (int v0 = 0; v0 < V; v0 += 32 * CHUNK) {
      if (v0 > 0 || g > 0) load_chunk(row, v0, lane, V, fb);
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        if (!fb[i]) continue;
        const uint32_t* wr = adj + static_cast<size_t>(v0 + 32 * i + lane) * NW + g;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < ng) acc[j] |= wr[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t word = __reduce_or_sync(FULL, acc[j]);
      const int c = 32 * (g + j) + lane;
      if (j < ng && c < n_cols) o[c] = (word >> lane) & 1u;
    }
  }
}

}  // namespace

extern "C" int bitmap_expand_packed_launch(const void* frontier,
                                           const void* words, void* out,
                                           int k, int v, int nw, int n_cols,
                                           int smem_bytes, void* stream) {
  const dim3 grid((k + ROWS - 1) / ROWS);
  const dim3 block(32 * ROWS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frontier);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (smem_bytes > 0)
    bitmap_expand_packed_kernel<true><<<grid, block, smem_bytes, s>>>(
        f, w, o, k, v, nw, n_cols);
  else
    bitmap_expand_packed_kernel<false><<<grid, block, 0, s>>>(f, w, o, k, v,
                                                              nw, n_cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
