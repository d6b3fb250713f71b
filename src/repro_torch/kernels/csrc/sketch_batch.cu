// Sketches for a batch of queries in one launch (Eq. 3 and Definition 4.5):
//   pi[b, r, s]  = min(lu[b, r] + d_M[r, s] + lv[b, s], INF)
//   d_top[b]     = min_{r, s} pi[b, r, s]
//   att[b, r, s] = d_top[b] < INF && pi[b, r, s] == d_top[b]
//   du_land[b, r] = any_s att ? lu[b, r] : INF    (dv_land over r, with lv)
//   meta_edge[b, i, j] = w(i, j) < INF && any attaining (r, s) with
//                        d_M(r, i) + w(i, j) + d_M(s, j) == d_M(r, s)
//   d_star_u[b] = max(max_r (du_land - 1 where du_land < INF, else -1), 0)
// lu, lv (B, R) and meta_w, meta_dist (R, R) come packed (uint8 or uint16,
// the dtype max as the INF sentinel) or as int32; one template instance per
// element type.  Outputs: d_top, du_land, dv_land, d_star_u, d_star_v int32
// and meta_edge (B, R, R) bool bytes, bit for bit the plain version
// (kernels/ref.py::sketch_batch_ref, the reference's compute_sketch_batch).
//
// Replaces the TPU kernel src/repro/kernels/minplus.py::minplus
// (_minplus_kernel, pallas_call at minplus.py:81) on the serving path: the
// reference runs Eq. 3's min-plus contraction on it and the rest of the
// sketch as some 35 small array ops, which on this card cost a launch each.
// Here the contraction and the whole sketch are one launch.  The TPU
// kernel's own counterpart, csrc/minplus.cu, stays for d_top_only.
//
// Bound.  Bytes: B * 2R row elements + 2R^2 table elements read once, and
// B * (2R * 4 + R^2 + 12) output bytes written; about 18 KB at B = 32,
// R = 20 with uint8 tables, 0.006 us at 3.35 TB/s.  Operations: B * R^2 * 3
// for pi and its minimum, plus R^2 * 3 per attaining pair for the meta-edge
// test, on the CUDA cores (there is no (min, +) tensor-core semiring).  At
// the serving shape both are far below a launch, so a call is bound by its
// launch, as minplus.cu was; what this kernel saves is the ~35 launches of
// the PyTorch ops it replaces.
//
// Design.  One block of 256 threads per query.
//  1. The rows, widened to int32 (sentinel -> INF = 1 << 20, as
//     core/packing.widen_dist does), and, while everything fits in the
//     227 KB of dynamic shared memory (R <= 168), the two meta tables are
//     staged in shared memory; beyond that the tables are read through L2
//     and widened on each read, and the attaining-pair bitmap lives in a
//     scratch buffer the wrapper allocates.  No cap on R.
//  2. Threads stride over the R^2 pairs: pi on the DPX instruction
//     __viaddmin_s32(a, b, c) = min(a + b, c), and a block minimum
//     (__reduce_min_sync, then across warps) gives d_top.
//  3. A second pass sets the attaining pairs in an R x ceil(R/32)-word
//     bitmap, and ORs each pair's row and column into two R-bit masks
//     (shared-memory atomicOr): these masks are du_land's and dv_land's
//     "present" bits.
//  4. Threads over (i, j) with w(i, j) < INF walk the set bits of the row
//     mask, then of that row's bitmap word(s) (__ffs), and test the
//     meta-edge equation for each attaining pair, stopping at the first
//     hit.  The R^4 on_path tensor of the plain version (160 KB at R = 20,
//     268 MB at R = 128) is never built.
//  5. Warps 0 and 1 reduce the two budgets (__reduce_max_sync).
// All arithmetic is int32 as in the plain version (sums reach 3 * INF), so
// the kernel is exact.  Launches on the caller's stream; returns
// cudaGetLastError().
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int INF = 1 << 20;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;   // 227 KB, the most a block may opt in to
constexpr int DEFAULT_SMEM = 48 * 1024;

template <typename T>
__device__ __forceinline__ int widen(T x) {
  if constexpr (sizeof(T) == 4) {
    return static_cast<int>(x);
  } else {
    return x == static_cast<T>(~T(0)) ? INF : static_cast<int>(x);
  }
}

// the meta tables: int32 copies in shared memory, or the global tables
// (packed or int32) widened on each read
template <typename T, bool kStaged>
struct Tables {
  const int* md_s;
  const int* mw_s;
  const T* md_g;
  const T* mw_g;
  int R;
  __device__ __forceinline__ int md(int r, int s) const {
    if constexpr (kStaged) return md_s[r * R + s];
    else return widen<T>(__ldg(md_g + static_cast<size_t>(r) * R + s));
  }
  __device__ __forceinline__ int mw(int i, int j) const {
    if constexpr (kStaged) return mw_s[i * R + j];
    else return widen<T>(__ldg(mw_g + static_cast<size_t>(i) * R + j));
  }
};

template <typename T, bool kStaged>
__global__ void __launch_bounds__(THREADS) sketch_batch_kernel(
    const T* __restrict__ lu, const T* __restrict__ lv,
    const T* __restrict__ meta_w, const T* __restrict__ meta_dist,
    int* __restrict__ d_top, int* __restrict__ du_land,
    int* __restrict__ dv_land, unsigned char* __restrict__ meta_edge,
    int* __restrict__ d_star_u, int* __restrict__ d_star_v,
    unsigned int* __restrict__ att_scratch, int R) {
  extern __shared__ __align__(16) int smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NW = (R + 31) / 32;             // words per bitmap row
  const int RR = R * R;

  int* lu_s = smem;                                         // R
  int* lv_s = lu_s + R;                                     // R
  unsigned int* row_bits = reinterpret_cast<unsigned int*>(lv_s + R);  // NW
  unsigned int* col_bits = row_bits + NW;                   // NW
  int* red = reinterpret_cast<int*>(col_bits + NW);         // WARPS
  unsigned int* att = kStaged
      ? reinterpret_cast<unsigned int*>(red + WARPS)        // R * NW
      : att_scratch + static_cast<size_t>(b) * R * NW;
  int* md_s = reinterpret_cast<int*>(att + R * NW);         // R * R (staged)
  int* mw_s = md_s + RR;                                    // R * R (staged)
  const Tables<T, kStaged> tab{md_s, mw_s, meta_dist, meta_w, R};

  // 1. stage the rows (and the tables), clear the bitmaps
  const size_t row0 = static_cast<size_t>(b) * R;
  for (int i = tid; i < R; i += THREADS) {
    lu_s[i] = widen<T>(lu[row0 + i]);
    lv_s[i] = widen<T>(lv[row0 + i]);
  }
  for (int i = tid; i < NW; i += THREADS) row_bits[i] = col_bits[i] = 0u;
  for (int i = tid; i < R * NW; i += THREADS) att[i] = 0u;
  if constexpr (kStaged) {
    for (int i = tid; i < RR; i += THREADS) {
      md_s[i] = widen<T>(meta_dist[i]);
      mw_s[i] = widen<T>(meta_w[i]);
    }
  }
  __syncthreads();

  // 2. d_top = min over the R^2 landmark pairs of pi (clamped to INF)
  int best = INT_MAX;
  for (int p = tid; p < RR; p += THREADS) {
    const int r = p / R, s = p - r * R;
    best = min(best, __viaddmin_s32(lu_s[r] + tab.md(r, s), lv_s[s], INF));
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if (lane == 0) red[warp] = best;
  __syncthreads();
  int dtop = red[0];
  for (int w = 1; w < WARPS; ++w) dtop = min(dtop, red[w]);

  // 3. the attaining pairs, as a bitmap and its row / column masks
  if (dtop < INF) {
    for (int p = tid; p < RR; p += THREADS) {
      const int r = p / R, s = p - r * R;
      if (__viaddmin_s32(lu_s[r] + tab.md(r, s), lv_s[s], INF) == dtop) {
        atomicOr(&att[r * NW + (s >> 5)], 1u << (s & 31));
        atomicOr(&row_bits[r >> 5], 1u << (r & 31));
        atomicOr(&col_bits[s >> 5], 1u << (s & 31));
      }
    }
  }
  __syncthreads();

  if (tid == 0) d_top[b] = dtop;
  for (int r = tid; r < R; r += THREADS) {
    du_land[row0 + r] = (row_bits[r >> 5] >> (r & 31)) & 1u ? lu_s[r] : INF;
    dv_land[row0 + r] = (col_bits[r >> 5] >> (r & 31)) & 1u ? lv_s[r] : INF;
  }

  // 5. the budgets, one warp per side
  if (warp < 2) {
    const int* side = warp == 0 ? lu_s : lv_s;
    const unsigned int* present = warp == 0 ? row_bits : col_bits;
    int m = -1;
    for (int r = lane; r < R; r += 32) {
      const int x = (present[r >> 5] >> (r & 31)) & 1u ? side[r] : INF;
      m = max(m, x < INF ? x - 1 : -1);
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) (warp == 0 ? d_star_u : d_star_v)[b] = max(m, 0);
  }

  // 4. meta edges: (i, j) lies on a shortest meta path of an attaining pair
  unsigned char* me = meta_edge + static_cast<size_t>(b) * RR;
  for (int p = tid; p < RR; p += THREADS) {
    const int i = p / R, j = p - i * R;
    const int w = tab.mw(i, j);
    bool on = false;
    if (w < INF) {
      for (int rw = 0; rw < NW && !on; ++rw) {
        for (unsigned int rows = row_bits[rw]; rows && !on; rows &= rows - 1u) {
          const int r = rw * 32 + __ffs(rows) - 1;
          const int left = tab.md(r, i) + w;
          for (int sw = 0; sw < NW && !on; ++sw) {
            // the scratch bitmap took its bits by L2 atomics: read it there
            unsigned int cols = kStaged ? att[r * NW + sw] : __ldcg(&att[r * NW + sw]);
            for (; cols; cols &= cols - 1u) {
              const int s = sw * 32 + __ffs(cols) - 1;
              if (left + tab.md(s, j) == tab.md(r, s)) {
                on = true;
                break;
              }
            }
          }
        }
      }
    }
    me[p] = on;
  }
}

template <typename T, bool kStaged>
int launch(const void* lu, const void* lv, const void* meta_w,
           const void* meta_dist, void* d_top, void* du_land, void* dv_land,
           void* meta_edge, void* d_star_u, void* d_star_v, void* att_scratch,
           int b, int r, int smem, cudaStream_t stream) {
  auto kernel = sketch_batch_kernel<T, kStaged>;
  if (smem > DEFAULT_SMEM) {
    static bool opted_in = false;    // once per instance
    if (!opted_in) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      opted_in = true;
    }
  }
  kernel<<<b, THREADS, smem, stream>>>(
      static_cast<const T*>(lu), static_cast<const T*>(lv),
      static_cast<const T*>(meta_w), static_cast<const T*>(meta_dist),
      static_cast<int*>(d_top), static_cast<int*>(du_land),
      static_cast<int*>(dv_land), static_cast<unsigned char*>(meta_edge),
      static_cast<int*>(d_star_u), static_cast<int*>(d_star_v),
      static_cast<unsigned int*>(att_scratch), r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(bool staged, const void* lu, const void* lv,
                 const void* meta_w, const void* meta_dist, void* d_top,
                 void* du_land, void* dv_land, void* meta_edge, void* d_star_u,
                 void* d_star_v, void* att_scratch, int b, int r, int smem,
                 cudaStream_t stream) {
  return staged
      ? launch<T, true>(lu, lv, meta_w, meta_dist, d_top, du_land, dv_land,
                        meta_edge, d_star_u, d_star_v, att_scratch, b, r, smem,
                        stream)
      : launch<T, false>(lu, lv, meta_w, meta_dist, d_top, du_land, dv_land,
                         meta_edge, d_star_u, d_star_v, att_scratch, b, r,
                         smem, stream);
}

}  // namespace

// elem_bytes: 1 = uint8, 2 = uint16 (packed, sentinel = dtype max), 4 = int32
extern "C" int sketch_batch_launch(const void* lu, const void* lv,
                                   const void* meta_w, const void* meta_dist,
                                   void* d_top, void* du_land, void* dv_land,
                                   void* meta_edge, void* d_star_u,
                                   void* d_star_v, void* att_scratch, int b,
                                   int r, int elem_bytes, int staged, int smem,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return launch_typed<uint8_t>(staged, lu, lv, meta_w, meta_dist, d_top,
                                   du_land, dv_land, meta_edge, d_star_u,
                                   d_star_v, att_scratch, b, r, smem, s);
    case 2:
      return launch_typed<uint16_t>(staged, lu, lv, meta_w, meta_dist, d_top,
                                    du_land, dv_land, meta_edge, d_star_u,
                                    d_star_v, att_scratch, b, r, smem, s);
    case 4:
      return launch_typed<int32_t>(staged, lu, lv, meta_w, meta_dist, d_top,
                                   du_land, dv_land, meta_edge, d_star_u,
                                   d_star_v, att_scratch, b, r, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
