// The sharded general lane's side attach (phase E1 of
// core/sharded.py::general_lane) on one shard's card: the certificate, the
// anchor-chain closure and the edge pass, for all R landmarks and both sides
// of a chunk (the 2B rows: u sides, then v sides) at once.
//
// It replaces no TPU kernel.  The reference writes this attach as plain jnp
// over the vertex-sharded tables (src/repro/core/scale_serve.py); the port's
// plain version (kernels/ref.py::sharded_attach_ref) loops over the R
// landmarks, builds three edge lists per landmark and shard with nonzero()
// over every slot, and ORs (2B, E_loc) bool blocks, which on the four-card
// orkut cell was two thirds of a chunk's device time.
//
// State per shard: on (vpad, W, R) 32-bit words, W = ceil(2B / 32), vpad =
// 32 ceil(v_loc / 32).  Bit k of on[x, w, r] says row 32 w + k certifies
// local vertex x on a landmark-free shortest path toward landmark r.  A
// vertex's W * R words are one contiguous row.  Beside it, act (vpad / 32
// words) has a bit per local vertex whose row holds a set bit (never
// cleared, so it may hold more).  Between steps the wrapper all-gathers both
// as raw words (core/distributed.py::Halo.words): the table (S vpad, W, R)
// and its act (S vpad / 32 words), a global vertex g of shard h sitting at
// row h * vpad + g - vstart[h].  Every read of another vertex's words goes
// through that gathered snapshot, so a step is Jacobi.
//
// Labels: the shard's int32 block (v_loc, R) for its own vertices and the
// int32 source labels of its slots (E, R), INF (1 << 20) standing for no
// label; a label is tested against INF before it enters any sum.  "x -> y
// decrements toward r" is computed from the two rows: both ends off the
// landmark set (lid < 0), both labels finite and ld[y, r] + 1 == ld[x, r].
// No edge list is built.
//
// Three kernels, each launched by the wrapper (kernels/attach_sharded.py),
// which hands them on, act, the flag and the result zeroed:
// 1. certificate: a thread per local vertex x.  For each word w it reads x's
//    32 depths once, with the word's (32, R) sigma slice in shared memory
//    (-1 where sigma is INF, which no sum reaches), and writes x's nonzero
//    words:  bit k = depth[k, x] < INF & ld[x, r] < INF & depth + ld ==
//    sigma[k, r];  a warp's 32 adjacent vertices set their act bits with one
//    atomicOr.
// 2. closure step, one launch per shard and step; the host reads the psum of
//    the shards' flags between steps, one wait for all landmarks.  A pull
//    over the shard's in-edge CSR (its slots sorted by local destination,
//    pads last): a warp takes one segment of at most SEG = 32 slots of row
//    y, a lane a slot.  The lanes whose source is active in the gathered
//    act and off the landmark set vote; only those sources are visited, lane
//    j then taking word j of the row's W * R (r = j % R) and testing the
//    decrement from the slot's source label and y's own.  New bits (not in
//    the snapshot's row of y) go into the local table with atomicOr and set
//    y's local act bit and the flag.
// 3. edge pass: a thread per slot (x -> y); a pad or a slot with neither end
//    active in the final gathered act writes nothing.  Otherwise it ORs the
//    interior term over every r the slot decrements, on[x, w, r] & on[y, w,
//    r], the hop into a landmark dst (ld[x, lid[y]] == 1: on[x, w, lid[y]])
//    and the hop out of a landmark src (ld[y, lid[x]] == 1: on[y, w,
//    lid[x]]), folds row k and row k + B together and stores 1 into the
//    (B, E) result.
//
// Bound: bytes.  Each input read once and the result written once: the
// depths (8 B v_loc), the labels (4 R v_loc), the slots' two ends and the
// CSR (8 E + 4 v_loc), and the B E bools; at the orkut cell's shard (v_loc
// 774,656, E 58.6 M, B = 32) about 2.6 GB, 0.8 ms at 3.35 TB/s.  The source
// labels (4 R E) are read only at active slots.  What moves beyond that is
// the table's zeroing and its all-gathers.  No floats are involved; every
// result is exact.  Each launch function returns cudaGetLastError().
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int INF = 1 << 20;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ bool bit_at(const uint32_t* words, size_t i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// global vertex g -> its row in the gathered tables (vstart is
// non-decreasing: the last shard whose block starts at or before g)
__device__ __forceinline__ size_t gathered_row(int g, const int* vstart, int S,
                                               int vpad) {
  int h = 0;
  for (int i = 1; i < S; ++i)
    if (g >= vstart[i]) h = i;
  return static_cast<size_t>(h) * vpad + static_cast<size_t>(g - vstart[h]);
}

__global__ void certificate_kernel(const int* __restrict__ sides, int stride,
                                   const int* __restrict__ sigma,
                                   const int* __restrict__ labels,
                                   uint32_t* __restrict__ on,
                                   uint32_t* __restrict__ act, int B2, int V,
                                   int R) {
  extern __shared__ int s_sigma[];  // (32, R) of the current word's rows
  const int W = (B2 + 31) / 32;
  const int x = blockIdx.x * THREADS + threadIdx.x;
  bool any = false;
  for (int w = 0; w < W; ++w) {
    const int nb = min(32, B2 - 32 * w);
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
      d[k] = k < nb ? sides[static_cast<size_t>(32 * w + k) * stride + x] : INF;
      reached |= d[k] < INF;
    }
    if (!reached) continue;
    uint32_t* row = on + static_cast<size_t>(x) * W * R + static_cast<size_t>(w) * R;
    const int* lrow = labels + static_cast<size_t>(x) * R;
    for (int r = 0; r < R; ++r) {
      const int l = lrow[r];
      if (l >= INF) continue;
      uint32_t word = 0u;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        word |= static_cast<uint32_t>(d[k] < INF && d[k] + l == s_sigma[k * R + r])
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

__global__ void closure_kernel(const uint32_t* __restrict__ table,
                               const uint32_t* __restrict__ tact,
                               uint32_t* __restrict__ on,
                               uint32_t* __restrict__ act,
                               const int* __restrict__ indptr,
                               const int* __restrict__ src,
                               const int* __restrict__ label_src,
                               const int* __restrict__ labels,
                               const int* __restrict__ lid,
                               const int* __restrict__ vstart,
                               const int* __restrict__ seg_row,
                               const int* __restrict__ seg_beg,
                               int* __restrict__ flag, int n_seg, int S,
                               int shard, int vpad, int R, int WR) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= n_seg) return;  // uniform across the warp
  const int y = seg_row[s];
  if (lid[vstart[shard] + y] >= 0) return;  // no decrementing slot ends at a landmark
  const int e = seg_beg[s] + lane;
  long long xr = -1;
  if (e < indptr[y + 1]) {  // act first: it is sparse, lid is not
    const int g = src[e];
    const size_t row = gathered_row(g, vstart, S, vpad);
    if (bit_at(tact, row) && lid[g] < 0) xr = static_cast<long long>(row);
  }
  const unsigned live_x = __ballot_sync(FULL, xr >= 0);
  if (live_x == 0u) return;  // uniform
  const size_t own = (static_cast<size_t>(shard) * vpad + y) * WR;
  bool grew = false;
  for (int j0 = 0; j0 < WR; j0 += 32) {
    const int j = j0 + lane;
    const int r = j < WR ? j % R : 0;
    const int ly = j < WR ? labels[static_cast<size_t>(y) * R + r] : INF;
    const bool live = ly < INF;
    uint32_t acc = 0u;
    for (unsigned m = live_x; m != 0u; m &= m - 1u) {
      const int from = __ffs(m) - 1;
      const long long xs = __shfl_sync(FULL, xr, from);
      const int es = __shfl_sync(FULL, e, from);
      if (live) {
        const int lx = label_src[static_cast<size_t>(es) * R + r];
        if (lx < INF && ly + 1 == lx)
          acc |= table[static_cast<size_t>(xs) * WR + j];
      }
    }
    if (acc != 0u) {
      const uint32_t fresh = acc & ~table[own + j];
      if (fresh != 0u) {
        atomicOr(on + static_cast<size_t>(y) * WR + j, fresh);
        grew = true;
      }
    }
  }
  if (__any_sync(FULL, grew) && lane == 0) {
    atomicOr(act + (y >> 5), 1u << (y & 31));
    atomicExch(flag, 1);
  }
}

__global__ void edge_kernel(const uint32_t* __restrict__ table,
                            const uint32_t* __restrict__ tact,
                            const int* __restrict__ src,
                            const int* __restrict__ dst,
                            const int* __restrict__ label_src,
                            const int* __restrict__ labels,
                            const int* __restrict__ lid,
                            const int* __restrict__ vstart,
                            uint8_t* __restrict__ out, int B, int B2,
                            long long E, int S, int shard, int v_loc, int vpad,
                            int R) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= E) return;
  const int y = dst[e];
  if (y >= v_loc) return;  // a pad slot
  const int g = src[e];
  const size_t xr = gathered_row(g, vstart, S, vpad);
  const size_t yr = static_cast<size_t>(shard) * vpad + y;
  const bool ax = bit_at(tact, xr), ay = bit_at(tact, yr);
  if (!ax && !ay) return;
  const int rx = lid[g], ry = lid[vstart[shard] + y];
  const int* lx = label_src + static_cast<size_t>(e) * R;
  const int* ly = labels + static_cast<size_t>(y) * R;
  const bool interior = ax && ay && rx < 0 && ry < 0;
  const bool hop_in = ax && ry >= 0 && lx[ry] == 1;
  const bool hop_out = ay && rx >= 0 && ly[rx] == 1;
  if (!(interior || hop_in || hop_out)) return;
  const int W = (B2 + 31) / 32;
  const uint32_t* ox = table + xr * W * R;
  const uint32_t* oy = table + yr * W * R;
  for (int w = 0; w < W; ++w) {
    uint32_t acc = 0u;
    if (interior) {
      for (int r = 0; r < R; ++r) {
        const int a = lx[r], c = ly[r];
        if (a < INF && c < INF && c + 1 == a) acc |= ox[w * R + r] & oy[w * R + r];
      }
    }
    if (hop_in) acc |= ox[w * R + ry];
    if (hop_out) acc |= oy[w * R + rx];
    for (; acc != 0u; acc &= acc - 1u) {
      int row = 32 * w + __ffs(acc) - 1;
      if (row >= B) row -= B;  // the v side's row b + B folds onto row b
      out[static_cast<size_t>(row) * E + e] = 1;
    }
  }
}

}  // namespace

extern "C" int sharded_attach_certificate_launch(const void* sides, int stride,
                                                 const void* sigma,
                                                 const void* labels, void* on,
                                                 void* act, int b2, int v, int r,
                                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((v + THREADS - 1) / THREADS);
  const size_t smem = static_cast<size_t>(32) * r * sizeof(int);
  certificate_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const int*>(sides), stride, static_cast<const int*>(sigma),
      static_cast<const int*>(labels), static_cast<uint32_t*>(on),
      static_cast<uint32_t*>(act), b2, v, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sharded_attach_closure_launch(
    const void* table, const void* tact, void* on, void* act,
    const void* indptr, const void* src, const void* label_src,
    const void* labels, const void* lid, const void* vstart,
    const void* seg_row, const void* seg_beg, void* flag, int n_seg, int n_shards,
    int shard, int vpad, int r, int wr, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_seg == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_seg + WARPS - 1) / WARPS);
  closure_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(tact),
      static_cast<uint32_t*>(on), static_cast<uint32_t*>(act),
      static_cast<const int*>(indptr), static_cast<const int*>(src),
      static_cast<const int*>(label_src), static_cast<const int*>(labels),
      static_cast<const int*>(lid), static_cast<const int*>(vstart),
      static_cast<const int*>(seg_row), static_cast<const int*>(seg_beg),
      static_cast<int*>(flag), n_seg, n_shards, shard, vpad, r, wr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sharded_attach_edges_launch(
    const void* table, const void* tact, const void* src, const void* dst,
    const void* label_src, const void* labels, const void* lid,
    const void* vstart, void* out, int b, int b2, long long e, int n_shards,
    int shard, int v_loc, int vpad, int r, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((e + THREADS - 1) / THREADS));
  edge_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(tact),
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(label_src), static_cast<const int*>(labels),
      static_cast<const int*>(lid), static_cast<const int*>(vstart),
      static_cast<uint8_t*>(out), b, b2, e, n_shards, shard, v_loc, vpad, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
