// The DEM substep loop of `ops/dem.py::dem_substeps` on Hopper (sm_90a),
// for a frozen Verlet list with the carried contact force of substep mode,
// as two kernels launched by `ops/dem_fused.py`.
//
// Replaces no TPU kernel: the JAX package leaves `dem_substeps`
// (`yade_openfoam_coupling_tpu/ops/dem.py:1061`) to XLA. In plain PyTorch
// one substep is ~270 small ops on (K, N) views of an (11, K, N) gather
// (pair force, wall force, integration) and 3 blocking host copies (the
// walls' lo/hi and one element of their normal), 4 more a call: ~1,090
// launches and 16 host waits a 4-substep call, whatever N.
//
//   * `yofc_dem_pack_drift`, once a call: the first acceleration from the
//     carried contact force, gravity (less buoyancy) and the hydro force,
//     Cundall damping where set, the half-kick, the drift and the periodic
//     wrap, written as one 48-byte record a particle (pos, half-step
//     velocity and angular velocity, radius, active as 1.0 or 0.0, a pad);
//     record N, the list's empty slot, is zero.
//   * `yofc_dem_substep`, once a substep, one thread a particle: its record
//     and its K list ids, the K partners' records, the pair force and
//     torque of `_pair_force_cm` for each, their sum, the walls' force of
//     `wall_contact_forces` added axis by axis, the acceleration and the
//     closing kick; then the next half-kick and drift into a new record
//     buffer (never in place: other threads still read the old one), or on
//     the last substep pos, vel, angvel and the contact force and torque
//     that the next call carries.
//
// The constants come from the host (`dem_fused._params`), each the float32
// that PyTorch applies for the Python number, read by value at launch:
// no device copy and no host wait. dt stays a device scalar, read by
// pointer. The hydro force and torque are read through their row strides
// (the exchange's (N, 3) views of its (N, 4) or (N, 7) result), not
// copied.
//
// Numbers: the plain loop's operations in its order, built with
// -fmad=false so that no product is contracted into an add; r^3 as
// (r * r) * r, 1/m a correctly rounded reciprocal, d / L as d * (1/L)
// with PyTorch's reciprocal, torch.round as rintf, torch.fmod as fmodf.
// A pair that does not touch adds an exact zero, so only touching pairs
// are computed. The sum over a row's K pairs follows PyTorch's CUDA
// reduction over the (K, N) pair arrays, whose K axis is the fastest in
// memory (see `pair_sum`).
//
// What bounds them on this card: bytes. A substep reads a particle's
// record (48 B), its K ids (4K B), its hydro force and torque (24 B) and
// up to K partner records, and writes one record: ~136 B a particle at
// K = 4 plus the partners' records, which at 1M (48 MB of records) mostly
// come from the 50 MB L2. ~0.04 ms a substep at 1M at 3.35 TB/s; the
// operations (~150 a touching pair) are far below the float32 rate.
//
// What the design does about it. One thread a particle, records as three
// 16-byte loads, the integration fused into the force pass so that nothing
// but the next record is written between substeps, and no partner record
// loaded for an empty slot or an inactive particle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRecord = 12;         // floats a record
constexpr int kMaxNeighbors = 32;   // the longest list row
constexpr int kThreads = 256;

struct Params {
  int n, k;
  int periodic[3], wall[3];
  int buoyancy, damping;
  long long force_stride, torque_stride;
  float g[3], lo[3], hi[3], len[3], inv_len[3];
  float c_mass, c_vol, rho_f, kn, two_beta, kt, friction, damp;
};

// torch.clamp(x, min=lo) / (x, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// torch.sign (0 for 0 and NaN)
__device__ __forceinline__ float sign_of(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

__device__ __forceinline__ float cube(float r) { return (r * r) * r; }

// `dem.particle_mass`: the Python factor rho_p * 4/3 * pi, then r^3
__device__ __forceinline__ float mass(const Params& P, float r) { return P.c_mass * cube(r); }

__device__ __forceinline__ void cross(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// `dem.accel`: (damp(fc + f_grav + hydro force, v) * inv_m,
// damp(tc + hydro torque, w) * inv_I), f_grav = m g - rho_f vol g
__device__ __forceinline__ void accel(const Params& P, float r, bool act, const float fc[3],
                                      const float tc[3], const float hf[3], const float ht[3],
                                      const float v[3], const float w[3], float a[3],
                                      float aw[3]) {
  const float m = mass(P, r);
  const float inertia = (0.4f * m) * (r * r);
  const float inv_m = act ? 1.0f / m : 0.0f;
  const float inv_i = act ? 1.0f / inertia : 0.0f;
  const float vol = P.c_vol * cube(r);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float fg = m * P.g[c];
    if (P.buoyancy) fg = fg - (P.rho_f * vol) * P.g[c];
    float f = (fc[c] + fg) + hf[c];
    float t = tc[c] + ht[c];
    if (P.damping) {
      f = f * (1.0f - P.damp * sign_of(f * v[c]));
      t = t * (1.0f - P.damp * sign_of(t * w[c]));
    }
    a[c] = f * inv_m;
    aw[c] = t * inv_i;
  }
}

// `dem.drift` after a kick: vel_h = v + (dt/2) a, ang_h = w + (dt/2) aw,
// pos = p + dt vel_h wrapped into [lo, lo + L) on periodic axes (`_float_mod`)
__device__ __forceinline__ void half_kick_drift(const Params& P, float dt, const float p[3],
                                                const float v[3], const float w[3],
                                                const float a[3], const float aw[3],
                                                float pn[3], float vh[3], float wh[3]) {
  const float h = 0.5f * dt;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    vh[c] = v[c] + h * a[c];
    wh[c] = w[c] + h * aw[c];
    pn[c] = p[c] + dt * vh[c];
    if (P.periodic[c]) {
      const float L = P.len[c];
      float r = fmodf(pn[c] - P.lo[c], L);
      if (((r < 0.0f) != (L < 0.0f)) && r != 0.0f) r = r + L;
      pn[c] = P.lo[c] + r;
    }
  }
}

__device__ __forceinline__ void store_record(float* rec, long long i, const float p[3],
                                             const float vh[3], const float wh[3], float r,
                                             float act) {
  float4* out = reinterpret_cast<float4*>(rec) + (kRecord / 4) * i;
  out[0] = make_float4(p[0], p[1], p[2], vh[0]);
  out[1] = make_float4(vh[1], vh[2], wh[0], wh[1]);
  out[2] = make_float4(wh[2], r, act, 0.0f);
}

__device__ __forceinline__ void load_record(const float* rec, long long i, float p[3],
                                            float v[3], float w[3], float* r, float* act) {
  const float4* in = reinterpret_cast<const float4*>(rec) + (kRecord / 4) * i;
  const float4 a = __ldg(in), b = __ldg(in + 1), c = __ldg(in + 2);
  p[0] = a.x; p[1] = a.y; p[2] = a.z;
  v[0] = a.w; v[1] = b.x; v[2] = b.y;
  w[0] = b.z; w[1] = b.w; w[2] = c.x;
  *r = c.y;
  *act = c.z;
}

// `dem._pair_force_cm` for one pair: force f and torque t on i from j, zero
// where they do not touch. dx = pos_i - pos_j (minimum image), m the masses.
__device__ __forceinline__ void pair_force(const Params& P, const float dx[3], const float vi[3],
                                           const float vj[3], const float wi[3],
                                           const float wj[3], float ri, float rj, float mi,
                                           float mj, bool valid, float f[3], float t[3]) {
  const float dist = sqrtf((dx[0] * dx[0] + dx[1] * dx[1]) + dx[2] * dx[2]);
  const float overlap = (ri + rj) - dist;
  if (!(valid && overlap > 0.0f && dist > 1e-12f)) {
    f[0] = f[1] = f[2] = t[0] = t[1] = t[2] = 0.0f;
    return;
  }
  float n[3], ci[3], cj[3], wxci[3], wxcj[3], v_rel[3], v_t[3], f_t[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    n[c] = dx[c] / dist;        // dist > 1e-12: `dist_safe` is dist
    ci[c] = (-ri) * n[c];
    cj[c] = rj * n[c];
  }
  cross(wi, ci, wxci);
  cross(wj, cj, wxcj);
#pragma unroll
  for (int c = 0; c < 3; ++c) v_rel[c] = (vi[c] + wxci[c]) - (vj[c] + wxcj[c]);
  const float v_n = (v_rel[0] * n[0] + v_rel[1] * n[1]) + v_rel[2] * n[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) v_t[c] = v_rel[c] - v_n * n[c];
  const float m_eff = (mi * mj) / clamp_min(mi + mj, 1e-30f);
  const float cn = P.two_beta * sqrtf(P.kn * m_eff);
  const float f_n_mag = clamp_min(P.kn * overlap - cn * v_n, 0.0f);
  const float ct = sqrtf(P.kt * m_eff);     // 2.0 * 0.5 * sqrt(kt m_eff): a factor of 1
#pragma unroll
  for (int c = 0; c < 3; ++c) f_t[c] = (-ct) * v_t[c];
  const float f_t_mag = sqrtf((f_t[0] * f_t[0] + f_t[1] * f_t[1]) + f_t[2] * f_t[2]);
  const float cap = P.friction * f_n_mag;
  const float scale =
      f_t_mag > 1e-30f ? clamp_max(cap / clamp_min(f_t_mag, 1e-30f), 1.0f) : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f_t[c] = f_t[c] * scale;
    f[c] = f_n_mag * n[c] + f_t[c];
  }
  cross(ci, f_t, t);
}

// `dem.wall_contact_forces` without springs: the force and torque of each
// wall axis (non-periodic, in `wall_axes`) added in axis order, from zero.
__device__ __forceinline__ void wall_force(const Params& P, const float p[3], const float v[3],
                                           const float w[3], float r, bool act, float m,
                                           float f[3], float t[3]) {
  f[0] = f[1] = f[2] = t[0] = t[1] = t[2] = 0.0f;
  const float cn = P.two_beta * sqrtf(P.kn * m);
  const float ct = sqrtf(P.kt * m);
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    if (!P.wall[axis]) continue;
    const float x = p[axis];
    const float gap_lo = x - P.lo[axis];
    const float gap_hi = P.hi[axis] - x;
    const bool at_lo = gap_lo <= gap_hi;
    const float gap = at_lo ? gap_lo : gap_hi;
    const float sgn = at_lo ? 1.0f : -1.0f;
    const float overlap = r - gap;
    const bool touching = act && overlap > 0.0f;
    const float v_n = sgn * v[axis];
    float f_n_mag = clamp_min(P.kn * overlap - cn * v_n, 0.0f);
    f_n_mag = touching ? f_n_mag : 0.0f;
    float n_vec[3], c_vec[3], wxc[3], v_surf[3], v_t[3], f_t[3], tq[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      n_vec[c] = (c == axis ? 1.0f : 0.0f) * sgn;
      c_vec[c] = (-r) * n_vec[c];
    }
    cross(w, c_vec, wxc);
#pragma unroll
    for (int c = 0; c < 3; ++c) v_surf[c] = v[c] + wxc[c];
    // one term is nonzero: any order of this sum gives the same number
    const float s = (v_surf[0] * n_vec[0] + v_surf[1] * n_vec[1]) + v_surf[2] * n_vec[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v_t[c] = v_surf[c] - s * n_vec[c];
      f_t[c] = (-ct) * v_t[c];
    }
    const float cap = P.friction * f_n_mag;
    const float f_t_mag = sqrtf((f_t[0] * f_t[0] + f_t[1] * f_t[1]) + f_t[2] * f_t[2]);
    const float scale =
        f_t_mag > 1e-30f ? clamp_max(cap / clamp_min(f_t_mag, 1e-30f), 1.0f) : 0.0f;
    const float keep = touching ? scale : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f_t[c] = f_t[c] * keep;
      f[c] = f[c] + (f_n_mag * n_vec[c] + f_t[c]);
    }
    cross(c_vec, f_t, tq);
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = t[c] + tq[c];
  }
}

// The sum of x[0..K) in the order of PyTorch's CUDA `torch.sum(x, dim=0)`
// on the (K, N) pair arrays, K the fastest axis in memory: bw, the largest
// power of two <= K, lanes of a block row share a row's K values, lane l
// holding x[l] + x[l + bw] (x[l] alone where l + bw >= K), then halved:
// lane l + bw/2 added into lane l, then l + bw/4, ... (K = 4: (x0 + x2) +
// (x1 + x3); K = 3: (x0 + x2) + x1).
template <int KT>
__device__ __forceinline__ float pair_sum(const float* x, int K) {
  int bw = 1;
  while (2 * bw <= K) bw *= 2;
  float lane[KT];
#pragma unroll
  for (int l = 0; l < KT; ++l) {
    if (l >= bw) break;
    lane[l] = l + bw < K ? x[l] + x[l + bw] : x[l];
  }
#pragma unroll
  for (int off = KT / 2; off > 0; off /= 2) {
    if (off >= bw) continue;
#pragma unroll
    for (int l = 0; l < KT / 2; ++l)
      if (l < off) lane[l] = lane[l] + lane[l + off];
  }
  return lane[0];
}

// pack_drift: one thread a particle, thread N writes the empty record
__global__ void __launch_bounds__(kThreads) pack_drift_kernel(
    Params P, const float* __restrict__ dt_ptr, const float* __restrict__ pos,
    const float* __restrict__ vel, const float* __restrict__ ang,
    const float* __restrict__ radius, const unsigned char* __restrict__ active,
    const float* __restrict__ fc, const float* __restrict__ tc, const float* __restrict__ hf,
    const float* __restrict__ ht, float* __restrict__ rec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > P.n) return;
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  if (i == P.n) {
    store_record(rec, i, zero3, zero3, zero3, 0.0f, 0.0f);
    return;
  }
  const float dt = __ldg(dt_ptr);
  float p[3], v[3], w[3], f[3], t[3], hfi[3], hti[3], a[3], aw[3], pn[3], vh[3], wh[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[c] = __ldg(pos + 3 * i + c);
    v[c] = __ldg(vel + 3 * i + c);
    w[c] = __ldg(ang + 3 * i + c);
    f[c] = __ldg(fc + 3 * i + c);
    t[c] = __ldg(tc + 3 * i + c);
    hfi[c] = __ldg(hf + i * P.force_stride + c);
    hti[c] = __ldg(ht + i * P.torque_stride + c);
  }
  const float r = __ldg(radius + i);
  const bool act = __ldg(active + i) != 0;
  accel(P, r, act, f, t, hfi, hti, v, w, a, aw);
  half_kick_drift(P, dt, p, v, w, a, aw, pn, vh, wh);
  store_record(rec, i, pn, vh, wh, r, act ? 1.0f : 0.0f);
}

// One substep; rout null: the last one, writing pos, vel, angvel, fc, tc.
template <int KT>
__global__ void __launch_bounds__(kThreads) substep_kernel(
    Params P, const float* __restrict__ dt_ptr, const float* __restrict__ rin,
    const int* __restrict__ nbr, const float* __restrict__ hf, const float* __restrict__ ht,
    float* __restrict__ rout, float* __restrict__ pos_out, float* __restrict__ vel_out,
    float* __restrict__ ang_out, float* __restrict__ fc_out, float* __restrict__ tc_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > P.n) return;
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  if (i == P.n) {
    if (rout) store_record(rout, i, zero3, zero3, zero3, 0.0f, 0.0f);
    return;
  }
  const int K = KT == kMaxNeighbors ? P.k : KT;
  float p[3], v[3], w[3], r, act_f;
  load_record(rin, i, p, v, w, &r, &act_f);
  const bool act = act_f > 0.5f;
  const float m = mass(P, r);

  // the pairs, each zero unless it touches
  float pf[3][KT], pt[3][KT];
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    if (s >= K) break;
    const int j = __ldg(nbr + i * K + s);
    float f[3] = {0.0f, 0.0f, 0.0f}, t[3] = {0.0f, 0.0f, 0.0f};
    if (act && j >= 0 && j < P.n) {     // N (or past it): the empty slot
      float pj[3], vj[3], wj[3], rj, act_j;
      load_record(rin, j, pj, vj, wj, &rj, &act_j);
      float dx[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dx[c] = p[c] - pj[c];
        if (P.periodic[c]) dx[c] = dx[c] - P.len[c] * rintf(dx[c] * P.inv_len[c]);
      }
      const float mj = mass(P, clamp_min(rj, 1e-12f));
      pair_force(P, dx, v, vj, w, wj, r, rj, m, mj, act_j > 0.5f, f, t);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pf[c][s] = f[c];
      pt[c][s] = t[c];
    }
  }
  float fc[3], tc[3], fw[3], tw[3];
  wall_force(P, p, v, w, r, act, m, fw, tw);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fc[c] = pair_sum<KT>(pf[c], K) + fw[c];
    tc[c] = pair_sum<KT>(pt[c], K) + tw[c];
  }

  // the kicks
  const float dt = __ldg(dt_ptr);
  float hfi[3], hti[3], a[3], aw[3], vel[3], ang[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    hfi[c] = __ldg(hf + i * P.force_stride + c);
    hti[c] = __ldg(ht + i * P.torque_stride + c);
  }
  accel(P, r, act, fc, tc, hfi, hti, v, w, a, aw);
  const float h = 0.5f * dt;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    vel[c] = v[c] + h * a[c];
    ang[c] = w[c] + h * aw[c];
  }
  if (!rout) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pos_out[3 * i + c] = p[c];
      vel_out[3 * i + c] = vel[c];
      ang_out[3 * i + c] = ang[c];
      fc_out[3 * i + c] = fc[c];
      tc_out[3 * i + c] = tc[c];
    }
    return;
  }
  float pn[3], vh[3], wh[3];
  half_kick_drift(P, dt, p, vel, ang, a, aw, pn, vh, wh);
  store_record(rout, i, pn, vh, wh, r, act_f);
}

// The parameters from the host arrays; false if they are not what the
// kernels take.
bool params_of(const int* ip, const float* fp, Params* P) {
  P->n = ip[0];
  P->k = ip[1];
  if (P->n < 0 || P->n > (1 << 28) || P->k < 1 || P->k > kMaxNeighbors) return false;
  for (int a = 0; a < 3; ++a) {
    P->periodic[a] = ip[2 + a];
    P->wall[a] = ip[5 + a];
    if ((unsigned)P->periodic[a] > 1u || (unsigned)P->wall[a] > 1u) return false;
    P->g[a] = fp[a];
    P->lo[a] = fp[3 + a];
    P->hi[a] = fp[6 + a];
    P->len[a] = fp[9 + a];
    P->inv_len[a] = fp[12 + a];
  }
  P->buoyancy = ip[8];
  P->damping = ip[9];
  P->force_stride = ip[10];
  P->torque_stride = ip[11];
  if ((unsigned)P->buoyancy > 1u || (unsigned)P->damping > 1u || P->force_stride < 0 ||
      P->torque_stride < 0)
    return false;
  P->c_mass = fp[15];
  P->c_vol = fp[16];
  P->rho_f = fp[17];
  P->kn = fp[18];
  P->two_beta = fp[19];
  P->kt = fp[20];
  P->friction = fp[21];
  P->damp = fp[22];
  return true;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

unsigned blocks_for(int n) { return (unsigned)((n + 1 + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// iparams (host): N, K, periodic (3), wall (3), buoyancy, damping, the
// hydro force's and torque's row strides (in floats); fparams (host):
// gravity (3), lo (3), hi (3), L (3), 1/L (3), rho_p 4/3 pi, 4/3 pi,
// rho_f, kn, 2 beta, kt, friction, damping. dt: a device float32 scalar.
// pos, vel, ang, fc, tc, the outputs: contiguous (N, 3) float32; radius
// (N,) float32, active (N,) bool; hf, ht (N, 3) rows of unit stride;
// records (N + 1, 12) float32, 16-byte aligned; nbr (N, K) int32, N =
// empty. Each entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for parameters its kernel does not take.

int yofc_dem_pack_drift(const int* iparams, const float* fparams, const float* dt,
                        const float* pos, const float* vel, const float* ang,
                        const float* radius, const unsigned char* active, const float* fc,
                        const float* tc, const float* hf, const float* ht, float* rec,
                        void* stream) {
  Params P;
  if (!params_of(iparams, fparams, &P) || !aligned16(rec)) return (int)cudaErrorInvalidValue;
  pack_drift_kernel<<<blocks_for(P.n), kThreads, 0, (cudaStream_t)stream>>>(
      P, dt, pos, vel, ang, radius, active, fc, tc, hf, ht, rec);
  return (int)cudaGetLastError();
}

// rec_out null: the last substep, writing pos, vel, ang, fc and tc (all
// given); else none of them.
int yofc_dem_substep(const int* iparams, const float* fparams, const float* dt,
                     const float* rec_in, const int* nbr, const float* hf, const float* ht,
                     float* rec_out, float* pos, float* vel, float* ang, float* fc, float* tc,
                     void* stream) {
  Params P;
  if (!params_of(iparams, fparams, &P) || !aligned16(rec_in)) return (int)cudaErrorInvalidValue;
  const bool last = rec_out == nullptr;
  if (last ? !(pos && vel && ang && fc && tc) : (!aligned16(rec_out) || pos || vel || ang ||
                                                 fc || tc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = blocks_for(P.n);
  if (P.k == 4)
    substep_kernel<4><<<blocks, kThreads, 0, s>>>(P, dt, rec_in, nbr, hf, ht, rec_out, pos, vel,
                                                  ang, fc, tc);
  else
    substep_kernel<kMaxNeighbors><<<blocks, kThreads, 0, s>>>(P, dt, rec_in, nbr, hf, ht,
                                                              rec_out, pos, vel, ang, fc, tc);
  return (int)cudaGetLastError();
}

}  // extern "C"
