// Min-plus (tropical) product on int32: C[m, n] = min_k A[m, k] + B[k, n].
//
// Replaces the TPU kernel src/repro/kernels/minplus.py::minplus
// (_minplus_kernel, pallas_call at minplus.py:81).  Sketching (Eq. 3) chains
// it as min_r(minplus(lu, meta_dist) + lv) to give d_top for each query of a
// general-lane chunk: (chunk = 32, R = 20) x (20, 20) on the main path.
//
// Bound: int32 operations, 2 * M * N * K of them (one add and one min per
// term); tensor cores have no (min, +) semiring, so this runs on the CUDA
// cores.  At the main path's shapes the work is tiny (25,600 operations,
// under 7 KB moved) and launch latency dominates.
//
// Design: one thread per output element over a 2-D grid of 16 x 16 output
// tiles.  Each block stages its 16 A rows and 16 B columns in shared
// memory in K-chunks of 32 (K reaches 200 in the tests) and keeps the
// running minimum in a register; the inner step is the sm_90 DPX
// instruction __viaddmin_s32(a, b, c) = min(a + b, c).  Ragged edges are
// masked instead of padded: the TPU kernel pads K with 1 << 24, whose terms
// can never beat a real term (inputs are <= INF = 1 << 20), so the masked
// minimum equals the padded one.  Launches on the caller's stream; returns
// cudaGetLastError().
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int KC = 32;

__global__ void minplus_kernel(const int* __restrict__ A,
                               const int* __restrict__ B,
                               int* __restrict__ C, int M, int K, int N) {
  __shared__ int As[TILE][KC];
  __shared__ int Bs[KC][TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  const int row0 = blockIdx.x * TILE, col0 = blockIdx.y * TILE;
  int acc = INT_MAX;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min(KC, K - k0);
    for (int i = tid; i < TILE * KC; i += TILE * TILE) {
      const int r = i / KC, k = i % KC, gr = row0 + r;
      As[r][k] = (gr < M && k < kn) ? A[(size_t)gr * K + k0 + k] : 0;
    }
    for (int i = tid; i < KC * TILE; i += TILE * TILE) {
      const int k = i / TILE, c = i % TILE, gc = col0 + c;
      Bs[k][c] = (gc < N && k < kn) ? B[(size_t)(k0 + k) * N + gc] : 0;
    }
    __syncthreads();
    for (int k = 0; k < kn; ++k) acc = __viaddmin_s32(As[ty][k], Bs[k][tx], acc);
    __syncthreads();
  }
  const int row = row0 + ty, col = col0 + tx;
  if (row < M && col < N) C[(size_t)row * N + col] = acc;
}

}  // namespace

extern "C" int minplus_launch(const void* a, const void* b, void* c, int m,
                              int k, int n, void* stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  minplus_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(c), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
