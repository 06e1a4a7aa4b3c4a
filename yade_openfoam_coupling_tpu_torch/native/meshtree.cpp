// Host runtime of the port: k-d tree point locator + CSR spatial binner
// (the port's own copy of `yade_openfoam_coupling_tpu/native/meshtree.cpp`).
//
// The reference's libMeshTree capability (C2): a 3-D k-d tree over cell
// centres that locates points in ARBITRARY (non-uniform) cell-centre clouds,
// which the uniform-grid `ops/coupling.locate` cannot serve. The tree is
// built here on the host, exactly as the JAX package's copy builds it
// (median layout, `std::nth_element` by the widest axis, the split axis in
// axes[mid]), so both packages lay out the same tree from the same points.
// `native/bindings.py` uploads its arrays (`yofc_tree_export`) and the CUDA
// kernels of `csrc/meshtree.cu` walk the same tree on the card, in the same
// pop/push order, so the two routes return the same ties and the same
// members of a capped range query.
//
// Differences from the JAX copy: `yofc_tree_size`/`yofc_tree_export` hand
// out the tree's arrays, and there is no binner (the port bins with torch
// ops, `bindings.bin_points`).
//
// Build (done by bindings.py at first use, into the package's _build/):
//   g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off meshtree.cpp
// -ffp-contract=off keeps dist2 the same sum of rounded products as the
// CUDA kernels compiled with -fmad=false, so d2 agrees bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct KDTree {
  // flattened, index-based tree: node i spans order[lo..hi) with split
  // stored implicitly by construction (median layout).
  std::vector<double> pts;   // (n, 3)
  std::vector<int32_t> order;
  int32_t n = 0;

  double coord(int32_t idx, int axis) const { return pts[3 * idx + axis]; }
};

struct Span {
  int32_t lo, hi;  // range in order[]
  int depth;
};

int widest_axis(const KDTree& t, int32_t lo, int32_t hi) {
  double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
  for (int32_t i = lo; i < hi; ++i) {
    for (int a = 0; a < 3; ++a) {
      double c = t.coord(t.order[i], a);
      mn[a] = std::min(mn[a], c);
      mx[a] = std::max(mx[a], c);
    }
  }
  int best = 0;
  double spread = -1.0;
  for (int a = 0; a < 3; ++a) {
    if (mx[a] - mn[a] > spread) {
      spread = mx[a] - mn[a];
      best = a;
    }
  }
  return best;
}

// median-layout build: order[] is arranged so that the median of each span
// sits at its midpoint, recursively — queries re-derive the structure from
// (lo, hi) alone. Axis choice is by widest spread, stored in axes[mid].
void build(KDTree& t, std::vector<int8_t>& axes) {
  std::vector<Span> stack{{0, t.n, 0}};
  while (!stack.empty()) {
    Span s = stack.back();
    stack.pop_back();
    if (s.hi - s.lo <= 1) continue;
    int axis = widest_axis(t, s.lo, s.hi);
    int32_t mid = (s.lo + s.hi) / 2;
    std::nth_element(
        t.order.begin() + s.lo, t.order.begin() + mid, t.order.begin() + s.hi,
        [&](int32_t a, int32_t b) { return t.coord(a, axis) < t.coord(b, axis); });
    axes[mid] = static_cast<int8_t>(axis);
    stack.push_back({s.lo, mid, s.depth + 1});
    stack.push_back({static_cast<int32_t>(mid + 1), s.hi, s.depth + 1});
  }
}

double dist2(const KDTree& t, int32_t idx, const double* q) {
  double d = 0.0;
  for (int a = 0; a < 3; ++a) {
    double dd = t.coord(idx, a) - q[a];
    d += dd * dd;
  }
  return d;
}

struct Tree {
  KDTree kd;
  std::vector<int8_t> axes;
};

}  // namespace

extern "C" {

void* yofc_tree_build(const double* points, int32_t n) {
  auto* tr = new Tree();
  tr->kd.n = n;
  tr->kd.pts.assign(points, points + 3 * static_cast<size_t>(n));
  tr->kd.order.resize(n);
  for (int32_t i = 0; i < n; ++i) tr->kd.order[i] = i;
  tr->axes.assign(n, 0);
  build(tr->kd, tr->axes);
  return tr;
}

void yofc_tree_free(void* handle) { delete static_cast<Tree*>(handle); }

int32_t yofc_tree_size(void* handle) { return static_cast<Tree*>(handle)->kd.n; }

// copy the tree's arrays out: pts (n, 3) f64, order (n,) i32, axes (n,) i8.
void yofc_tree_export(void* handle, double* pts, int32_t* order, int8_t* axes) {
  const Tree& tr = *static_cast<Tree*>(handle);
  std::memcpy(pts, tr.kd.pts.data(), tr.kd.pts.size() * sizeof(double));
  std::memcpy(order, tr.kd.order.data(), tr.kd.order.size() * sizeof(int32_t));
  std::memcpy(axes, tr.axes.data(), tr.axes.size() * sizeof(int8_t));
}

// nearest neighbour of each query point; out: (nq,) indices.
void yofc_tree_nearest(void* handle, const double* queries, int32_t nq,
                       int32_t* out_idx, double* out_d2) {
  const Tree& tr = *static_cast<Tree*>(handle);
  const KDTree& t = tr.kd;
  for (int32_t qi = 0; qi < nq; ++qi) {
    const double* q = queries + 3 * static_cast<size_t>(qi);
    int32_t best = -1;
    double bestd = 1e300;
    std::vector<Span> stack{{0, t.n, 0}};
    while (!stack.empty()) {
      Span s = stack.back();
      stack.pop_back();
      if (s.lo >= s.hi) continue;
      int32_t mid = (s.lo + s.hi) / 2;
      int32_t idx = t.order[mid];
      double d = dist2(t, idx, q);
      if (d < bestd) {
        bestd = d;
        best = idx;
      }
      if (s.hi - s.lo == 1) continue;
      int axis = tr.axes[mid];
      double delta = q[axis] - t.coord(idx, axis);
      Span near{s.lo, mid, 0}, far{static_cast<int32_t>(mid + 1), s.hi, 0};
      if (delta > 0) std::swap(near, far);
      // visit near side first; far side only if the splitting plane is
      // closer than the current best
      if (delta * delta < bestd) stack.push_back(far);
      stack.push_back(near);
    }
    out_idx[qi] = best;
    if (out_d2) out_d2[qi] = bestd;
  }
}

// all points within radius r of each query, capped at `cap` per query in
// traversal order (nearest-first NOT guaranteed). out_idx: (nq, cap)
// filled with -1 padding; returns counts in out_n.
void yofc_tree_range(void* handle, const double* queries, int32_t nq,
                     double r, int32_t cap, int32_t* out_idx, int32_t* out_n) {
  const Tree& tr = *static_cast<Tree*>(handle);
  const KDTree& t = tr.kd;
  const double r2 = r * r;
  for (int32_t qi = 0; qi < nq; ++qi) {
    const double* q = queries + 3 * static_cast<size_t>(qi);
    int32_t count = 0;
    int32_t* row = out_idx + static_cast<size_t>(qi) * cap;
    for (int32_t c = 0; c < cap; ++c) row[c] = -1;
    std::vector<Span> stack{{0, t.n, 0}};
    while (!stack.empty() && count < cap) {
      Span s = stack.back();
      stack.pop_back();
      if (s.lo >= s.hi) continue;
      int32_t mid = (s.lo + s.hi) / 2;
      int32_t idx = t.order[mid];
      if (dist2(t, idx, q) <= r2) row[count++] = idx;
      if (s.hi - s.lo == 1) continue;
      int axis = tr.axes[mid];
      double delta = q[axis] - t.coord(idx, axis);
      // descend both sides when the ball straddles the plane
      if (delta <= 0 || delta * delta <= r2)
        stack.push_back({s.lo, mid, 0});
      if (delta >= 0 || delta * delta <= r2)
        stack.push_back({static_cast<int32_t>(mid + 1), s.hi, 0});
    }
    out_n[qi] = count;
  }
}

}  // extern "C"
