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
// accumulation, so its least time is max((R*V + V*W + R*W) bytes over
// 3.35 TB/s, 2*R*V*W ops over the 1,979 T int8 tensor-core op/s).  At
// (64,2048)x(2048,2048) that is 4,456,448 bytes, 1.33 us, bound by bytes;
// at the hub block of the hybrid relay, (40,128)x(128,128), it is launch
// latency that bounds a call.
//
// Design.  The result is an OR, so no float and no threshold is needed:
// the kernel is exact by construction.  A block owns a TM x TN output tile
// (16 rows x 64 columns) and walks V in TK = 64 chunks: each chunk stages a
// frontier tile (TM x TK) and an adjacency tile (TK x TN) in shared memory,
// normalised to 0/1 bytes, and every thread ORs them into its outputs.  The
// loop over K inside the block takes the place of the TPU's sequential K
// grid; nothing carries over between blocks.  A thread holds 2 rows x 4
// columns: four adjacent adjacency bytes are read as one 32-bit word and
// ANDed with a 0/~0 mask made from the frontier byte, so one instruction
// ORs four outputs.  When both row pitches and both base pointers are
// multiples of 16 bytes, the tiles are staged with 16-byte loads (the
// launch's `vec` flag picks that instance of the kernel template);
// otherwise with byte loads.  With 4 warps per block
// the stage is latency-bound, so fewer load instructions is what counts.
// Ragged edges are masked on load (out-of-range entries stage as 0) and on
// store, never padded in memory.  Once every output of the block is true
// the block stops walking K (__syncthreads_and), the block-wide form of
// stopping early.  Wgmma, TMA and bit-packed popcount designs are later
// work.
// Launches on the caller's stream; returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int TM = 16;            // output rows per block
constexpr int TN = 64;            // output columns per block
constexpr int TK = 64;            // K chunk staged per step
constexpr int COLS = 4;           // columns per thread (one 32-bit word)
constexpr int TX = TN / COLS;     // 16 threads across the columns
constexpr int TY = 8;             // 8 threads down the rows
constexpr int ROWS = TM / TY;     // 2 rows per thread
constexpr int THREADS = TX * TY;  // 128
constexpr int VEC = 16;           // bytes per vector load

// each nonzero byte of x -> 0x01, each zero byte -> 0x00: the shifts fold a
// byte's eight bits into its bit 0; bits shifted in from the next byte land
// in bits 4-7 first and never reach bit 0
__device__ __forceinline__ unsigned int bytes_to_bits(unsigned int x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return x & 0x01010101u;
}

__device__ __forceinline__ uint4 load_bits16(const unsigned char* p) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  v.x = bytes_to_bits(v.x);
  v.y = bytes_to_bits(v.y);
  v.z = bytes_to_bits(v.z);
  v.w = bytes_to_bits(v.w);
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS) bitmap_expand_kernel(
    const unsigned char* __restrict__ frontier,
    const unsigned char* __restrict__ adjacency,
    unsigned char* __restrict__ out, int R, int V, int W) {
  __shared__ __align__(16) unsigned char f_tile[TM][TK];
  __shared__ __align__(16) unsigned char a_tile[TK][TN];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int r0 = blockIdx.y * TM;
  const int c0 = blockIdx.x * TN;
  const int col = c0 + tx * COLS;

  // bytes of this thread's outputs that exist: 0x01 per valid column
  unsigned int want[ROWS];
  unsigned int valid_cols = 0u;
  for (int j = 0; j < COLS; ++j)
    if (col + j < W) valid_cols |= 1u << (8 * j);
  for (int i = 0; i < ROWS; ++i)
    want[i] = (r0 + ty + i * TY < R) ? valid_cols : 0u;

  unsigned int acc[ROWS];
  for (int i = 0; i < ROWS; ++i) acc[i] = 0u;

  for (int k0 = 0; k0 < V; k0 += TK) {
    if constexpr (kVec) {
      // V and W are multiples of VEC: a vector is all in range or all out
      for (int idx = tid; idx < TM * TK / VEC; idx += THREADS) {
        const int rr = idx / (TK / VEC), kk = (idx % (TK / VEC)) * VEC;
        const int r = r0 + rr, k = k0 + kk;
        *reinterpret_cast<uint4*>(&f_tile[rr][kk]) = (r < R && k < V)
            ? load_bits16(frontier + static_cast<size_t>(r) * V + k)
            : make_uint4(0u, 0u, 0u, 0u);
      }
      for (int idx = tid; idx < TK * TN / VEC; idx += THREADS) {
        const int kk = idx / (TN / VEC), cc = (idx % (TN / VEC)) * VEC;
        const int k = k0 + kk, c = c0 + cc;
        *reinterpret_cast<uint4*>(&a_tile[kk][cc]) = (k < V && c < W)
            ? load_bits16(adjacency + static_cast<size_t>(k) * W + c)
            : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int idx = tid; idx < TM * TK; idx += THREADS) {
        const int rr = idx / TK, kk = idx % TK;
        const int r = r0 + rr, k = k0 + kk;
        f_tile[rr][kk] = (r < R && k < V)
            ? (frontier[static_cast<size_t>(r) * V + k] != 0) : 0;
      }
      for (int idx = tid; idx < TK * TN; idx += THREADS) {
        const int kk = idx / TN, cc = idx % TN;
        const int k = k0 + kk, c = c0 + cc;
        a_tile[kk][cc] = (k < V && c < W)
            ? (adjacency[static_cast<size_t>(k) * W + c] != 0) : 0;
      }
    }
    __syncthreads();

    const int kn = min(TK, V - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const unsigned int a4 =
          *reinterpret_cast<const unsigned int*>(&a_tile[kk][tx * COLS]);
      for (int i = 0; i < ROWS; ++i)
        acc[i] |= a4 & (0u - static_cast<unsigned int>(f_tile[ty + i * TY][kk]));
    }

    bool done = true;
    for (int i = 0; i < ROWS; ++i) done = done && ((acc[i] & want[i]) == want[i]);
    // every output of the block is true: the rest of K cannot change it
    if (__syncthreads_and(done)) break;
  }

  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + ty + i * TY;
    if (r >= R) continue;
    unsigned char* o = out + static_cast<size_t>(r) * W + col;
    for (int j = 0; j < COLS; ++j)
      if (col + j < W) o[j] = (acc[i] >> (8 * j)) & 1u;
  }
}

}  // namespace

extern "C" int bitmap_expand_launch(const void* frontier, const void* adjacency,
                                    void* out, int r, int v, int w, int vec,
                                    void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w + TN - 1) / TN, (r + TM - 1) / TM);
  const auto f = static_cast<const unsigned char*>(frontier);
  const auto a = static_cast<const unsigned char*>(adjacency);
  const auto o = static_cast<unsigned char*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    bitmap_expand_kernel<true><<<grid, block, 0, s>>>(f, a, o, r, v, w);
  else
    bitmap_expand_kernel<false><<<grid, block, 0, s>>>(f, a, o, r, v, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
