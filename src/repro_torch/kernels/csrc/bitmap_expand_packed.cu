// Frontier expansion over a bit-packed adjacency block:
//   next[r, c] = OR_v frontier[r, v] & bit(adj_words[v, c / 32], c % 32)
// frontier (K, V) bool, adj_words (V, NW) 32-bit words (32 little-endian
// columns per word), next (K, n_cols) bool.
//
// Replaces the TPU kernel src/repro/kernels/frontier.py::bitmap_expand_packed
// (_expand_packed_kernel, pallas_call at frontier.py:148).  It is the hub-hub
// block of the hybrid relay (core/frontier.py): every labelling, Bi-BFS,
// reverse-sweep and one-sided BFS level runs through it under
// backend="hybrid", at V = NW * 32 = n_cols = n_hubs (128 by default) and
// K = 2R = 40 rows per labelling level or the chunk's rows per search level.
//
// Bound: bytes.  It must read the frontier (K * V bytes) and the words
// (V * NW * 4 bytes) and write K * n_cols bytes; the work is K * V * NW
// word ORs, a few per byte moved.  At the main path's shapes (K <= 40,
// V = 128) that is under 12 KB, so launch latency dominates.
//
// Design: the TPU kernel unpacks word tiles and runs an f32 MXU product;
// Hopper needs no matrix unit for this.  One thread per output word (r, w)
// ORs the words adj_words[v, w] of every v whose frontier bit is set
// (branch-free, with a mask from the bit), then writes the word's 32 bools,
// masking n_cols.  A block is (bx words) x (by rows); it first stages its
// by frontier rows in shared memory, so each frontier byte is read from
// device memory once.  No floats are involved, so the result is exact.
// Launches on the caller's stream; returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

__global__ void bitmap_expand_packed_kernel(
    const unsigned char* __restrict__ frontier,
    const unsigned int* __restrict__ words, unsigned char* __restrict__ out,
    int K, int V, int NW, int n_cols) {
  extern __shared__ unsigned char f_rows[];  // blockDim.y rows of V bytes
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int r0 = blockIdx.x * blockDim.y;
  const int rows = min(static_cast<int>(blockDim.y), K - r0);
  const unsigned char* src = frontier + static_cast<size_t>(r0) * V;
  for (int i = tid; i < rows * V; i += n_threads) f_rows[i] = src[i];
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int w = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= K || w >= NW) return;
  const unsigned char* f = f_rows + threadIdx.y * V;
  unsigned int acc = 0u;
  for (int v = 0; v < V; ++v)
    acc |= words[static_cast<size_t>(v) * NW + w] & (0u - (f[v] != 0));
  const int c0 = w * 32;
  const int nb = min(32, n_cols - c0);
  unsigned char* o = out + static_cast<size_t>(r) * n_cols + c0;
  for (int i = 0; i < nb; ++i) o[i] = (acc >> i) & 1u;
}

}  // namespace

extern "C" int bitmap_expand_packed_launch(const void* frontier,
                                           const void* words, void* out,
                                           int k, int v, int nw, int n_cols,
                                           int bx, int by, void* stream) {
  const size_t smem = static_cast<size_t>(by) * v;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitmap_expand_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(bx, by);
  const dim3 grid((k + by - 1) / by, (nw + bx - 1) / bx);
  bitmap_expand_packed_kernel<<<grid, block, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(frontier),
      static_cast<const unsigned int*>(words),
      static_cast<unsigned char*>(out), k, v, nw, n_cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
