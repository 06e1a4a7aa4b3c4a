// k-d tree queries on Hopper (sm_90a): nearest neighbour and range query
// over a tree of cell centres built on the host.
//
// No Pallas kernel stands behind these: the JAX package answers the same
// queries on the host, in C++ (`native/meshtree.cpp`, `yofc_tree_nearest`
// and `yofc_tree_range`, :121-189). The port builds the same tree on the
// host (`native/meshtree.cpp` in the port, median layout: the node of span
// [lo, hi) is order[mid], mid = (lo + hi) / 2, split on axes[mid]) and
// uploads pts (n, 3) f64, order (n,) i32 and axes (n,) i8; these kernels
// walk it on the card.
//
// Each kernel is one thread per query, in f64, with an explicit stack of
// (lo, hi) spans in a fixed local array, and pops and pushes in the host's
// order:
// - nearest pushes `far` (only when delta^2 < best) and then `near`, and
//   keeps a strictly smaller d^2;
// - range pushes left and then right, stops at `cap` hits, and pads the
//   row with -1.
// So ties (cell-centre clouds tie on every face) and the members of a
// capped range query are the host path's. dist2 is the same sum of
// rounded products as the host build's (-ffp-contract=off): __dmul_rn and
// __dadd_rn are never contracted into an FMA, so d2 agrees bit for bit.
//
// The stack never holds more than levels + 1 spans, levels = floor(log2 n)
// + 1 <= 31 for an int32 n: 64 entries cover it. The entry points refuse
// a tree past that bound, and the kernels stop a query whose stack would
// overflow (idx -2), which the entry's check rules out.
//
// What bounds it on this card: the bytes of the nodes a query visits, one
// 32-byte sector each of order, axes and pts, read as a dependent chain.
// Neighbouring queries (particles in lattice order) walk mostly the same
// nodes, which L1 and L2 serve. A simple kernel: no shared-memory top
// levels, no warp-cooperative traversal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;

struct Span {
  int lo, hi;
};

__device__ __forceinline__ double coord(const double* __restrict__ pts, int idx, int axis) {
  return __ldg(pts + 3 * (long long)idx + axis);
}

// ((0 + dx^2) + dy^2) + dz^2, each product and sum rounded on its own
__device__ __forceinline__ double dist2(const double* __restrict__ pts, int idx,
                                        const double q[3]) {
  double d = 0.0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double dd = __dsub_rn(coord(pts, idx, a), q[a]);
    d = __dadd_rn(d, __dmul_rn(dd, dd));
  }
  return d;
}

__device__ __forceinline__ double pick(const double q[3], int axis) {
  return axis == 0 ? q[0] : (axis == 1 ? q[1] : q[2]);
}

__device__ __forceinline__ int midpoint(Span s) {
  return (int)(((long long)s.lo + s.hi) / 2);
}

__global__ void __launch_bounds__(kThreads)
nearest_kernel(const double* __restrict__ pts, const int* __restrict__ order,
               const int8_t* __restrict__ axes, int n, const double* __restrict__ queries,
               int nq, int* __restrict__ out_idx, double* __restrict__ out_d2) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  const double q[3] = {queries[3 * (long long)qi], queries[3 * (long long)qi + 1],
                       queries[3 * (long long)qi + 2]};
  Span stack[kStack];
  int sp = 0;
  stack[sp++] = {0, n};
  int best = -1;
  double bestd = 1e300;
  while (sp > 0) {
    const Span s = stack[--sp];
    if (s.lo >= s.hi) continue;
    const int mid = midpoint(s);
    const int idx = __ldg(order + mid);
    const double d = dist2(pts, idx, q);
    if (d < bestd) {
      bestd = d;
      best = idx;
    }
    if (s.hi - s.lo == 1) continue;
    const int axis = axes[mid];
    const double delta = __dsub_rn(pick(q, axis), coord(pts, idx, axis));
    Span near{s.lo, mid}, far{mid + 1, s.hi};
    if (delta > 0) {
      const Span t = near;
      near = far;
      far = t;
    }
    if (sp + 2 > kStack) {   // ruled out by the entry's depth check
      best = -2;
      break;
    }
    if (__dmul_rn(delta, delta) < bestd) stack[sp++] = far;
    stack[sp++] = near;
  }
  out_idx[qi] = best;
  out_d2[qi] = bestd;
}

__global__ void __launch_bounds__(kThreads)
range_kernel(const double* __restrict__ pts, const int* __restrict__ order,
             const int8_t* __restrict__ axes, int n, const double* __restrict__ queries,
             int nq, double r2, int cap, int* __restrict__ out_idx, int* __restrict__ out_n) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  const double q[3] = {queries[3 * (long long)qi], queries[3 * (long long)qi + 1],
                       queries[3 * (long long)qi + 2]};
  int* row = out_idx + (long long)qi * cap;
  Span stack[kStack];
  int sp = 0;
  stack[sp++] = {0, n};
  int count = 0;
  while (sp > 0 && count < cap) {
    const Span s = stack[--sp];
    if (s.lo >= s.hi) continue;
    const int mid = midpoint(s);
    const int idx = __ldg(order + mid);
    if (dist2(pts, idx, q) <= r2) row[count++] = idx;
    if (s.hi - s.lo == 1) continue;
    const int axis = axes[mid];
    const double delta = __dsub_rn(pick(q, axis), coord(pts, idx, axis));
    const bool straddle = __dmul_rn(delta, delta) <= r2;
    if (sp + 2 > kStack) {   // ruled out by the entry's depth check
      count = -2;
      break;
    }
    if (delta <= 0 || straddle) stack[sp++] = {s.lo, mid};
    if (delta >= 0 || straddle) stack[sp++] = {mid + 1, s.hi};
  }
  out_n[qi] = count;
  for (int c = count < 0 ? 0 : count; c < cap; ++c) row[c] = -1;
}

// refuse what the kernels do not take: negative sizes, or a tree deeper
// than the stack holds (levels + 1 spans at most)
bool bad_sizes(int n, int nq) {
  if (n < 0 || nq < 1) return true;
  int levels = 0;
  for (int s = n; s > 0; s >>= 1) ++levels;
  return levels + 1 > kStack;
}

}  // namespace

extern "C" {

// iparams (host): n, nq. pts (n, 3) f64, order (n,) i32, axes (n,) i8 (the
// host tree's arrays), queries (nq, 3) f64, out_idx (nq,) i32 and out_d2
// (nq,) f64 are contiguous device buffers. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for sizes the kernel does not
// take.
int yofc_tree_nearest(const int* iparams, const double* pts, const int* order,
                      const int8_t* axes, const double* queries, int* out_idx, double* out_d2,
                      void* stream) {
  const int n = iparams[0], nq = iparams[1];
  if (bad_sizes(n, nq)) return (int)cudaErrorInvalidValue;
  nearest_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      pts, order, axes, n, queries, nq, out_idx, out_d2);
  return (int)cudaGetLastError();
}

// iparams (host): n, nq, cap; dparams (host): r. As yofc_tree_nearest,
// with out_idx (nq, cap) i32 and out_n (nq,) i32; r^2 is taken here, as the
// host library takes it.
int yofc_tree_range(const int* iparams, const double* dparams, const double* pts,
                    const int* order, const int8_t* axes, const double* queries, int* out_idx,
                    int* out_n, void* stream) {
  const int n = iparams[0], nq = iparams[1], cap = iparams[2];
  if (bad_sizes(n, nq) || cap < 0) return (int)cudaErrorInvalidValue;
  const double r2 = dparams[0] * dparams[0];
  range_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      pts, order, axes, n, queries, nq, r2, cap, out_idx, out_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
