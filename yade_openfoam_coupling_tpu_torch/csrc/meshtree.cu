// k-d tree queries on Hopper (sm_90a): nearest neighbour and range query
// over a tree of cell centres built on the host.
//
// No Pallas kernel stands behind these: the JAX package answers the same
// queries on the host, in C++ (`native/meshtree.cpp`, `yofc_tree_nearest`
// and `yofc_tree_range`, :121-189). The port builds the same tree on the
// host (`native/meshtree.cpp` in the port, median layout: the node of span
// [lo, hi) is order[mid], mid = (lo + hi) / 2, split on axes[mid]) and
// uploads it as one 32-byte record a node in tree order
// (`bindings.node_records`): pts[order[m]] (3 x f64), order[m] (i32),
// axes[m] (i8), 3 bytes of padding. These kernels walk it on the card and
// return the host library's answers bit for bit: nearest's idx and d2, a
// range's count, its members in the host's traversal order, and the -1
// padding. dist2 is the host build's sum of rounded products
// (-ffp-contract=off): __dsub_rn, __dmul_rn and __dadd_rn in its order,
// never contracted into an FMA.
//
// What bounds them on this card: the nodes a query visits, each a
// dependent load from a tree that outgrows L2 at 128^3 (67 MB of records),
// and every byte of per-thread state that is not in registers. The design:
// - One aligned 32-byte record a visit, two 16-byte loads from one sector,
//   with no order -> pts dependency (the tree's own arrays were three
//   sectors a visit, the second load waiting on the first).
// - Queries in space-filling order: `keys_kernel` gives each query a
//   15-bit Morton key of its cell in a 32^3 lattice over the tree's
//   bounding box (clamped in f64 before any cast, so a query far outside
//   lands on the box's face), the wrapper sorts the keys (stable; as
//   int16 they sort faster on an H100 than 30-bit int32 keys, and the
//   walk is no slower), and thread i walks query perm[i] and writes row
//   perm[i]. The answers are a query's own, so any order returns the
//   same; with this one the lanes of a warp walk neighbouring leaves
//   whatever order the caller gives.
// - The near child is walked in registers; only a far span goes on the
//   stack, so a stack holds at most one span a level above the deepest
//   (depth = levels - 1 <= 30 for an int32 n). Walking `near` next is
//   what the host's push-far, push-near, pop-near does, so the visit
//   order is the host's. The stack lives in dynamic shared memory,
//   [depth][thread]: in local memory the records streaming through L1
//   evicted it, and it cost nearest a third of its time.
// - nearest prunes at pop: the far span is stored with its plane distance
//   delta^2 and skipped once delta^2 >= best. The answers cannot change:
//   every point p of the far span lies beyond the plane, so
//   |fl(p_a - q_a)| >= |fl(q_a - split)| (rounding to nearest is monotone
//   and symmetric) and, the other terms being >= 0, fl-d2(p) >= delta^2
//   >= best. A point replaces the best only when strictly nearer, so no
//   point of a skipped span would have, best and idx evolve as in the host
//   walk, and the first point in the host's order with the least d2 (the
//   tie the host keeps) is never in a skipped span: were it there, best
//   would already equal its d2, set by an earlier point. delta^2 is kept
//   as a float rounded down (12 bytes an entry, not 16): a lower bound, so
//   a span is skipped only if the exact test would skip it; one kept in
//   vain holds no strictly nearer point either. The host pushes the far
//   span whenever delta^2 < best at the push; by its pop, best has usually
//   shrunk (at 128^3 this walk makes ~1/7 of the host's visits).
// - range has no shrinking bound. "Push left if taken, push right if
//   taken, pop" is "if both, push left and walk right; else walk the one
//   taken" in the same order, with half the stack traffic. For a cap up
//   to 64 the hits go to a per-warp buffer in shared memory, [cap][33]
//   ints (the padding keeps both the lanes' writes and the row reads on
//   distinct banks), and the warp then writes its 32 rows one at a time,
//   32 lanes on consecutive ints, the -1 padding included; a larger cap
//   stores each hit straight into its row and the warp writes the
//   padding.
//
// A stack that would overflow ends its query with idx -2 (range: count
// -2, an all -1 row); the depth covers every walk, so it never happens.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowPitch = 33;     // ints a buffered hit slot spans (32 lanes + 1)
constexpr int kBufferCap = 64;    // the largest cap whose hits go through shared memory
constexpr int kKeyBits = 5;       // Morton cells a side: 1 << kKeyBits
constexpr unsigned kFull = 0xffffffffu;

struct Node {
  double p[3];
  int idx, axis;
};

// record mid: x, y from the first 16 bytes; z, order[mid] (bits 0-31) and
// axes[mid] (bits 32-39) from the second
__device__ __forceinline__ Node load_node(const double2* __restrict__ nodes, int mid) {
  const double2 a = __ldg(nodes + 2 * (long long)mid);
  const double2 b = __ldg(nodes + 2 * (long long)mid + 1);
  const long long tag = __double_as_longlong(b.y);
  return {{a.x, a.y, b.x}, (int)tag, (int)(signed char)(tag >> 32)};
}

// ((0 + dx^2) + dy^2) + dz^2, each difference, product and sum rounded on
// its own, dx = p - q as the host takes it
__device__ __forceinline__ double dist2(const Node& nd, const double q[3]) {
  double d = 0.0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double dd = __dsub_rn(nd.p[a], q[a]);
    d = __dadd_rn(d, __dmul_rn(dd, dd));
  }
  return d;
}

__device__ __forceinline__ double pick(const double v[3], int axis) {
  return axis == 0 ? v[0] : (axis == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ int midpoint(int lo, int hi) {
  return (int)(((long long)lo + hi) / 2);
}

__device__ __forceinline__ void load_query(const double* __restrict__ queries, long long qi,
                                           double q[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) q[a] = __ldg(queries + 3 * qi + a);
}

// up to 10 bits spread to every third bit
__device__ __forceinline__ unsigned spread3(unsigned x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// key = x, y, z bits interleaved (x highest) of the query's cell
// min(max(floor((q - lo) * scale), 0), 2^kKeyBits - 1) on each axis, in f64
__global__ void __launch_bounds__(256)
keys_kernel(const double* __restrict__ queries, int nq, double lo0, double lo1, double lo2,
            double s0, double s1, double s2, short* __restrict__ keys) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= nq) return;
  const double lo[3] = {lo0, lo1, lo2}, s[3] = {s0, s1, s2};
  unsigned key = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double t = floor(__dmul_rn(__dsub_rn(queries[3 * (long long)i + a], lo[a]), s[a]));
    const double c = fmin(fmax(t, 0.0), (double)((1 << kKeyBits) - 1));
    key |= spread3((unsigned)c) << (2 - a);
  }
  keys[i] = (short)key;
}

// shared memory: the far spans [depth][kThreads], then their delta^2
// rounded down to floats [depth][kThreads]
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const double2* __restrict__ nodes, int n, int depth,
               const double* __restrict__ queries, const long long* __restrict__ perm, int nq,
               int* __restrict__ out_idx, double* __restrict__ out_d2) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* spans = reinterpret_cast<int2*>(smem);
  float* planes = reinterpret_cast<float*>(smem + (size_t)depth * kThreads * sizeof(int2));
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  if (i >= nq) return;
  const long long qi = __ldg(perm + i);
  double q[3];
  load_query(queries, qi, q);
  int sp = 0;
  int lo = 0, hi = n;
  int best = -1;
  double bestd = 1e300;
  while (true) {
    if (lo < hi) {
      const int mid = midpoint(lo, hi);
      const Node nd = load_node(nodes, mid);
      const double d = dist2(nd, q);
      if (d < bestd) {
        bestd = d;
        best = nd.idx;
      }
      if (hi - lo > 1) {
        const double delta = __dsub_rn(pick(q, nd.axis), pick(nd.p, nd.axis));
        const double dd = __dmul_rn(delta, delta);
        // near: the left span [lo, mid) unless the query lies right of the plane
        const bool right = delta > 0;
        if (dd < bestd) {         // the host's push condition
          if (sp == depth) {      // ruled out by the depth
            best = -2;
            break;
          }
          spans[sp * kThreads + t] = right ? make_int2(lo, mid) : make_int2(mid + 1, hi);
          planes[sp * kThreads + t] = __double2float_rd(dd);
          ++sp;
        }
        if (right) lo = mid + 1;
        else hi = mid;
        continue;
      }
    }
    // pop the next far span that can still hold a strictly nearer point
    while (sp > 0 && (double)planes[(sp - 1) * kThreads + t] >= bestd) --sp;
    if (sp == 0) break;
    --sp;
    const int2 s = spans[sp * kThreads + t];
    lo = s.x;
    hi = s.y;
  }
  out_idx[qi] = best;
  out_d2[qi] = bestd;
}

// shared memory: the left spans [depth][kThreads], then with kBuffer each
// warp's hits [cap][kRowPitch] (the warp writes whole rows); without, each
// hit is stored into its row and the warp writes the rows' -1 padding
template <bool kBuffer>
__global__ void __launch_bounds__(kThreads)
range_kernel(const double2* __restrict__ nodes, int n, int depth,
             const double* __restrict__ queries, const long long* __restrict__ perm, int nq,
             double r2, int cap, int* __restrict__ out_idx, int* __restrict__ out_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* spans = reinterpret_cast<int2*>(smem);
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  const int lane = t & 31;
  int* buf = reinterpret_cast<int*>(smem + (size_t)depth * kThreads * sizeof(int2)) +
             (t >> 5) * cap * kRowPitch;
  const bool active = i < nq;
  const long long qi = active ? __ldg(perm + i) : 0;
  int* row = out_idx + qi * cap;
  int count = 0;
  if (active) {
    double q[3];
    load_query(queries, qi, q);
    int sp = 0;
    int lo = 0, hi = n;
    while (count < cap) {
      if (lo < hi) {
        const int mid = midpoint(lo, hi);
        const Node nd = load_node(nodes, mid);
        if (dist2(nd, q) <= r2) {
          if (kBuffer) buf[count * kRowPitch + lane] = nd.idx;
          else row[count] = nd.idx;
          ++count;
        }
        if (hi - lo > 1) {
          const double delta = __dsub_rn(pick(q, nd.axis), pick(nd.p, nd.axis));
          const bool straddle = __dmul_rn(delta, delta) <= r2;
          const bool left = delta <= 0 || straddle, right = delta >= 0 || straddle;
          if (left && right) {    // the host pops right first, then left
            if (sp == depth) {    // ruled out by the depth
              count = -2;
              break;
            }
            spans[sp++ * kThreads + t] = make_int2(lo, mid);
          }
          if (right) {
            lo = mid + 1;
            continue;
          }
          if (left) {
            hi = mid;
            continue;
          }
        }
      }
      if (sp == 0) break;
      const int2 s = spans[--sp * kThreads + t];
      lo = s.x;
      hi = s.y;
    }
    out_n[qi] = count;
  }
  // the warp's 32 rows, one at a time, 32 lanes on consecutive ints
  __syncwarp();
  const int i0 = i - lane;
  for (int j = 0; j < 32 && i0 + j < nq; ++j) {
    const long long qj = __shfl_sync(kFull, qi, j);
    const int nj = __shfl_sync(kFull, count, j);
    int* rowj = out_idx + qj * cap;
    if (kBuffer) {
      for (int c = lane; c < cap; c += 32) rowj[c] = c < nj ? buf[c * kRowPitch + j] : -1;
    } else {
      for (int c = (nj < 0 ? 0 : nj) + lane; c < cap; c += 32) rowj[c] = -1;
    }
  }
}

// the most far spans a walk holds: one for each level above the deepest
int stack_depth(int n) {
  int levels = 0;
  for (int s = n; s > 0; s >>= 1) ++levels;
  return levels > 1 ? levels - 1 : 1;
}

int blocks(int count, int threads) { return (count + threads - 1) / threads; }

// allow a block more than the default 48 KB of dynamic shared memory
template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" {

// iparams (host): nq; dparams (host): lo (3), scale (3) of the tree's box.
// queries (nq, 3) f64 and keys (nq,) i16 are contiguous device buffers.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for sizes the kernel does not take.
int yofc_tree_keys(const int* iparams, const double* dparams, const double* queries,
                   short* keys, void* stream) {
  const int nq = iparams[0];
  if (nq < 1) return (int)cudaErrorInvalidValue;
  const double* d = dparams;
  keys_kernel<<<blocks(nq, 256), 256, 0, (cudaStream_t)stream>>>(queries, nq, d[0], d[1], d[2],
                                                                   d[3], d[4], d[5], keys);
  return (int)cudaGetLastError();
}

// iparams (host): n, nq. nodes (n, 32 bytes) (`bindings.node_records`),
// queries (nq, 3) f64, perm (nq,) i64 (the order to walk the queries in),
// out_idx (nq,) i32 and out_d2 (nq,) f64 are contiguous device buffers.
// Returns as yofc_tree_keys.
int yofc_tree_nearest(const int* iparams, const double* nodes, const double* queries,
                      const long long* perm, int* out_idx, double* out_d2, void* stream) {
  const int n = iparams[0], nq = iparams[1];
  if (n < 0 || nq < 1) return (int)cudaErrorInvalidValue;
  const int depth = stack_depth(n);     // <= 30: at most 46,080 bytes
  const size_t shared = (size_t)depth * kThreads * (sizeof(int2) + sizeof(float));
  nearest_kernel<<<blocks(nq, kThreads), kThreads, shared, (cudaStream_t)stream>>>(
      (const double2*)nodes, n, depth, queries, perm, nq, out_idx, out_d2);
  return (int)cudaGetLastError();
}

// iparams (host): n, nq, cap; dparams (host): r. As yofc_tree_nearest,
// with out_idx (nq, cap) i32 and out_n (nq,) i32; r^2 is taken here, as the
// host library takes it. A cap up to kBufferCap buffers the hits in shared
// memory (at most 30,720 bytes of stack and 33,792 of buffer a block).
int yofc_tree_range(const int* iparams, const double* dparams, const double* nodes,
                    const double* queries, const long long* perm, int* out_idx, int* out_n,
                    void* stream) {
  const int n = iparams[0], nq = iparams[1], cap = iparams[2];
  if (n < 0 || nq < 1 || cap < 0) return (int)cudaErrorInvalidValue;
  const double r2 = dparams[0] * dparams[0];
  const int depth = stack_depth(n);
  const size_t stack = (size_t)depth * kThreads * sizeof(int2);
  const int nb = blocks(nq, kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (cap <= kBufferCap) {
    const size_t shared = stack + (size_t)kWarps * cap * kRowPitch * sizeof(int);
    if (int err = allow_shared(range_kernel<true>, shared)) return err;
    range_kernel<true><<<nb, kThreads, shared, st>>>((const double2*)nodes, n, depth, queries,
                                                      perm, nq, r2, cap, out_idx, out_n);
  } else {
    range_kernel<false><<<nb, kThreads, stack, st>>>((const double2*)nodes, n, depth, queries,
                                                      perm, nq, r2, cap, out_idx, out_n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
