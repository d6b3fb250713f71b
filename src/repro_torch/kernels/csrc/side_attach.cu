// The recover search's side attach (Alg. 4 lines 18-24, components (i) and
// (ii)) for one side of a query chunk: the pointwise certificate, the
// anchor-chain closure and the edge pass of core/search.py::_side_attach.
//
// It replaces no TPU kernel.  The reference writes the attach as plain jnp
// (src/repro/core/search.py::_side_attach, vmapped over queries); the port's
// plain version (kernels/ref.py::side_attach_ref) loops over the R landmarks
// three times, with an (R, B, V) bool table and per-landmark lists of the
// edges whose label decrements.  On the card that loop was three quarters of
// a general chunk's device time (gathers, scatters and compares of PyTorch's
// own kernels), so it gets a kernel of its own.
//
// State: on (V, W, R) 32-bit words, W = ceil(B / 32).  Bit b of on[x, w, r]
// says query row 32 w + b certifies x on a landmark-free shortest path
// toward landmark r.  A vertex's W * R words are one contiguous row (80 bytes
// at B <= 32, R = 20), so a visit to a vertex reads its words for every
// landmark in a few sectors.  At chunk 32 the table is 4 bytes per (vertex,
// landmark): 88 MB on a 1.1 M-vertex graph, where the bool table was
// 20 * B * V bytes.  Beside it, act (ceil(V / 32) words) has a bit per
// vertex, set for every vertex whose row holds a set bit (and never cleared,
// so it may hold more).  The table is sparse: a few hundred of its 22 M words
// are nonzero at B = 32 on that graph.  The closure and the edge pass test
// act (141 KB, L2-resident) before they touch a vertex's labels or words,
// and every pass writes only set bits into zeroed outputs.
//
// Labels: ld (V, R) packed uint8 or uint16, the dtype max standing for INF.
// A label is tested against the sentinel before it enters any sum, never
// used as a number.  "x -> y decrements toward r" (the plain version's
// dec[r] lists) is computed from the two label rows on the fly: both ends
// off the landmark set (lid < 0), ld[y, r] and ld[x, r] finite and
// ld[y, r] + 1 == ld[x, r].  No per-landmark edge list is read.
//
// Three kernels, each launched by the wrapper (kernels/attach.py), which
// hands them on, act and the result zeroed:
// 1. certificate: a thread per vertex x.  For each word w it reads x's 32
//    depths once (adjacent threads, adjacent addresses), with the word's
//    (32, R) sigma slice in shared memory (-1 where sigma is INF, which no
//    sum reaches), and writes x's nonzero words:
//      bit b = depth[b, x] < INF & ld[x, r] != INF & depth + ld == sigma[b, r];
//    a warp's 32 adjacent vertices set their act bits with one atomicOr.
// 2. closure step, one launch per step; the host reads the flag between
//    steps, as the plain version reads bool(moved).  Jacobi: nxt starts as
//    a copy of old and only bits pulled from old are added, so a step equals
//    the plain step bit for bit and max_chain cuts a chain where it cuts
//    there.  A pull over the graph's CSR rows: the slot list is symmetric,
//    so the edges into y are the reverses of y's own row.  A warp takes one
//    segment of at most SEG = 32 slots of row y (long rows, the top degrees
//    run to tens of thousands, are split), a lane a slot: the lanes whose
//    neighbour x is active and off the landmark set vote, and only those x
//    are visited, lane j then taking one of the row's W * R words
//    (r = j % R).  New bits go into nxt with atomicOr, set y's act bit and
//    the flag.  A bit of act set during the step only adds a visit to a row
//    of old that has none of the new bits, so the step stays Jacobi.
// 3. edge pass: a thread per edge slot (x -> y); a slot with neither end
//    active writes nothing.  Otherwise it ORs the interior term over every
//    r the slot decrements, on[x, w, r] & on[y, w, r], the hop into a
//    landmark dst (ld[x, lid[y]] == 1: on[x, w, lid[y]]) and the hop out of
//    a landmark src (ld[y, lid[x]] == 1: on[y, w, lid[x]]), taken on every
//    slot as the plain version takes them, and stores 1 for each set bit
//    into the (B, E) result (zeroed, or the caller's to OR into).
//
// Bound: bytes.  Each input read once and the result written once: depth
// (4 B V), sigma, the labels, the CSR (indptr, the slots' two ends), lid
// and the B E bools; on the youtube-scale graph at B = 26.5 about 0.35 GB,
// 0.1 ms at 3.35 TB/s.  What the passes move beyond that is the table's
// zeroing and each closure step's copy (2 x 88 MB).  No floats are
// involved; every result is exact.  Each launch function returns
// cudaGetLastError().
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int INF = 1 << 20;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 32;  // slots per closure segment: kernels/attach.py SEG_SLOTS

template <typename T>
__device__ __forceinline__ T sentinel() {
  return static_cast<T>(~static_cast<T>(0));
}

__device__ __forceinline__ bool active(const uint32_t* act, int x) {
  return (act[x >> 5] >> (x & 31)) & 1u;
}

template <typename T>
__global__ void certificate_kernel(const int* __restrict__ depth,
                                   const int* __restrict__ sigma,
                                   const T* __restrict__ ld,
                                   uint32_t* __restrict__ on,
                                   uint32_t* __restrict__ act, int B, int V,
                                   int R) {
  extern __shared__ int s_sigma[];  // (32, R) of the current word's rows
  const T SENT = sentinel<T>();
  const int W = (B + 31) / 32;
  const int x = blockIdx.x * THREADS + threadIdx.x;
  bool any = false;
  for (int w = 0; w < W; ++w) {
    const int nb = min(32, B - 32 * w);
    __syncthreads();  // the previous word's slice is no longer read
    for (int i = threadIdx.x; i < 32 * R; i += THREADS) {
      const int k = i / R;
      int s = -1;
      if (k < nb) {
        const int v = sigma[static_cast<size_t>(32 * w + k) * R + i % R];
        s = v < INF ? v : -1;
      }
      s_sigma[i] = s;
    }
    __syncthreads();
    if (x >= V) continue;  // stays for the next word's barriers
    int d[32];
    bool reached = false;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      d[k] = k < nb ? depth[static_cast<size_t>(32 * w + k) * V + x] : INF;
      reached |= d[k] < INF;
    }
    if (!reached) continue;
    uint32_t* row = on + static_cast<size_t>(x) * W * R + static_cast<size_t>(w) * R;
    const T* lrow = ld + static_cast<size_t>(x) * R;
    for (int r = 0; r < R; ++r) {
      const T l = lrow[r];
      if (l == SENT) continue;
      const int li = static_cast<int>(l);
      uint32_t word = 0u;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        word |= static_cast<uint32_t>(d[k] < INF &&
                                      d[k] + li == s_sigma[k * R + r])
                << k;
      if (word != 0u) {
        row[r] = word;
        any = true;
      }
    }
  }
  // the warp's 32 lanes are 32 adjacent vertices, one word of act
  const unsigned mask = __ballot_sync(FULL, any);
  if ((threadIdx.x & 31) == 0 && mask != 0u) atomicOr(act + (x >> 5), mask);
}

template <typename T>
__global__ void closure_kernel(const uint32_t* __restrict__ old,
                               uint32_t* __restrict__ nxt,
                               const int* __restrict__ indptr,
                               const int* __restrict__ col,
                               const T* __restrict__ ld,
                               const int* __restrict__ lid,
                               uint32_t* act,  // read and set in the step
                               const int* __restrict__ seg_row,
                               const int* __restrict__ seg_beg,
                               int* __restrict__ flag, int n_seg, int R,
                               int WR) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= n_seg) return;  // uniform across the warp
  const int y = seg_row[s];
  if (lid[y] >= 0) return;  // no decrementing slot ends at a landmark
  const int e = seg_beg[s] + lane;
  int x = -1;
  if (e < indptr[y + 1]) {
    x = col[e];
    if (!active(act, x) || lid[x] >= 0) x = -1;
  }
  const unsigned live_x = __ballot_sync(FULL, x >= 0);
  if (live_x == 0u) return;  // uniform
  bool grew = false;
  for (int j0 = 0; j0 < WR; j0 += 32) {
    const int j = j0 + lane;
    const int r = j < WR ? j % R : 0;
    const T lyt = j < WR ? ld[static_cast<size_t>(y) * R + r] : sentinel<T>();
    const bool live = lyt != sentinel<T>();
    const int ly = static_cast<int>(lyt);
    uint32_t acc = 0u;
    for (unsigned m = live_x; m != 0u; m &= m - 1u) {
      const int xs = __shfl_sync(FULL, x, __ffs(m) - 1);
      if (live) {
        const T lx = ld[static_cast<size_t>(xs) * R + r];
        if (lx != sentinel<T>() && ly + 1 == static_cast<int>(lx))
          acc |= old[static_cast<size_t>(xs) * WR + j];
      }
    }
    if (acc != 0u) {
      const size_t at = static_cast<size_t>(y) * WR + j;
      const uint32_t fresh = acc & ~old[at];
      if (fresh != 0u) {
        atomicOr(nxt + at, fresh);
        grew = true;
      }
    }
  }
  if (__any_sync(FULL, grew) && lane == 0) {
    atomicOr(act + (y >> 5), 1u << (y & 31));
    atomicExch(flag, 1);
  }
}

template <typename T>
__global__ void edge_kernel(const uint32_t* __restrict__ on,
                            const int* __restrict__ src,
                            const int* __restrict__ dst,
                            const T* __restrict__ ld,
                            const int* __restrict__ lid,
                            const uint32_t* __restrict__ act,
                            uint8_t* __restrict__ out, int B, int E, int R) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  const int x = src[e], y = dst[e];
  const bool ax = active(act, x), ay = active(act, y);
  if (!ax && !ay) return;
  const T SENT = sentinel<T>();
  const int W = (B + 31) / 32;
  const int rx = lid[x], ry = lid[y];
  const T* lx = ld + static_cast<size_t>(x) * R;
  const T* ly = ld + static_cast<size_t>(y) * R;
  const uint32_t* ox = on + static_cast<size_t>(x) * W * R;
  const uint32_t* oy = on + static_cast<size_t>(y) * W * R;
  const bool interior = ax && ay && rx < 0 && ry < 0;
  const bool hop_in = ax && ry >= 0 && lx[ry] == static_cast<T>(1);
  const bool hop_out = ay && rx >= 0 && ly[rx] == static_cast<T>(1);
  if (!(interior || hop_in || hop_out)) return;
  for (int w = 0; w < W; ++w) {
    uint32_t acc = 0u;
    if (interior) {
      for (int r = 0; r < R; ++r) {
        const T a = lx[r], c = ly[r];
        if (a != SENT && c != SENT &&
            static_cast<int>(c) + 1 == static_cast<int>(a))
          acc |= ox[w * R + r] & oy[w * R + r];
      }
    }
    if (hop_in) acc |= ox[w * R + ry];
    if (hop_out) acc |= oy[w * R + rx];
    uint8_t* o = out + static_cast<size_t>(32 * w) * E + e;
    for (; acc != 0u; acc &= acc - 1u)
      o[static_cast<size_t>(__ffs(acc) - 1) * E] = 1;
  }
}

}  // namespace

extern "C" int side_attach_certificate_launch(const void* depth,
                                              const void* sigma, const void* ld,
                                              void* on, void* act, int b, int v,
                                              int r, int wide, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((v + THREADS - 1) / THREADS);
  const size_t smem = static_cast<size_t>(32) * r * sizeof(int);
  const int* dp = static_cast<const int*>(depth);
  const int* sp = static_cast<const int*>(sigma);
  uint32_t* op = static_cast<uint32_t*>(on);
  uint32_t* ap = static_cast<uint32_t*>(act);
  if (wide)
    certificate_kernel<uint16_t><<<grid, THREADS, smem, s>>>(
        dp, sp, static_cast<const uint16_t*>(ld), op, ap, b, v, r);
  else
    certificate_kernel<uint8_t><<<grid, THREADS, smem, s>>>(
        dp, sp, static_cast<const uint8_t*>(ld), op, ap, b, v, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int side_attach_closure_launch(const void* old, void* nxt,
                                          const void* indptr, const void* col,
                                          const void* ld, const void* lid,
                                          void* act, const void* seg_row,
                                          const void* seg_beg, void* flag,
                                          int n_seg, int v, int r, int w,
                                          int wide, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t words = static_cast<size_t>(v) * w * r;
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(nxt, old, words * sizeof(uint32_t),
                          cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_seg == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_seg + WARPS - 1) / WARPS);
  const uint32_t* op = static_cast<const uint32_t*>(old);
  uint32_t* np_ = static_cast<uint32_t*>(nxt);
  const int* ip = static_cast<const int*>(indptr);
  const int* cp = static_cast<const int*>(col);
  const int* lp = static_cast<const int*>(lid);
  uint32_t* ap = static_cast<uint32_t*>(act);
  const int* rp = static_cast<const int*>(seg_row);
  const int* bp = static_cast<const int*>(seg_beg);
  int* fp = static_cast<int*>(flag);
  if (wide)
    closure_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        op, np_, ip, cp, static_cast<const uint16_t*>(ld), lp, ap, rp, bp, fp,
        n_seg, r, w * r);
  else
    closure_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        op, np_, ip, cp, static_cast<const uint8_t*>(ld), lp, ap, rp, bp, fp,
        n_seg, r, w * r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int side_attach_edges_launch(const void* on, const void* src,
                                        const void* dst, const void* ld,
                                        const void* lid, const void* act,
                                        void* out, int b, int e, int r,
                                        int wide, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((e + THREADS - 1) / THREADS);
  const uint32_t* op = static_cast<const uint32_t*>(on);
  const int* sp = static_cast<const int*>(src);
  const int* dp = static_cast<const int*>(dst);
  const int* lp = static_cast<const int*>(lid);
  const uint32_t* ap = static_cast<const uint32_t*>(act);
  uint8_t* out8 = static_cast<uint8_t*>(out);
  if (wide)
    edge_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        op, sp, dp, static_cast<const uint16_t*>(ld), lp, ap, out8, b, e, r);
  else
    edge_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        op, sp, dp, static_cast<const uint8_t*>(ld), lp, ap, out8, b, e, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
