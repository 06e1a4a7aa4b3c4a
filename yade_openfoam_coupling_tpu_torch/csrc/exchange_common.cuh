// Device code shared by the Gaussian coupling-exchange kernels on Hopper
// (sm_90a): the window kernel (window_exchange.cu) and the planes kernels
// (planes_exchange.cu).
//
// Both exchanges work on a channel-major slot table D (C_d, cap, ncell):
// slot (k, cell) holds the k-th particle of that cell (position, velocity,
// radius [, angular velocity]); an empty slot has radius 0. The window
// kernel stages D from its per-plane windows with anchor-relative
// positions; the planes exchange bins D with torch ops and absolute
// positions (Params::absolute). What is shared:
//   * the separable Gaussian factors with the wall masks of non-periodic
//     axes (`factor`), in the JAX package's operation order for either
//     kind of position;
//   * `slot_kernel`: one thread per slot interpolates the C_in input
//     channels from the ghost-padded fluid stack Fp (C_in, nx+2, ny+2,
//     nz+2), normalises, runs the force laws of
//     `coupling_planes._physics_planes` (drag, Archimedes, optional added
//     mass and rotational Stokes torque), writes the per-slot results pres
//     (n_pres, cap, ncell) and the pre-normalised deposit values V
//     (8, cap, ncell);
//   * `interp_kernel`: the interpolation half alone (G and the weight norm);
//   * `deposit_kernel`: one thread per (dx stack, cell) gathers w * V over
//     the source slots that deposit into it, with the dy and dz shifts
//     applied, so the scatter needs no atomics and is deterministic.
// Channel counts are template parameters chosen from (torque, added mass);
// the host passes the counts too and the launchers check that they agree.
// Every kernel follows the plain PyTorch version's operation order and is
// built with -fmad=false, so products and sums round as there.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace yofc {

constexpr int kMaxOff = 27;
constexpr int kCout = 8;    // deposit channels
constexpr int kStacks = 3;  // one deposit stack per dx in {-1, 0, 1}
constexpr int kThreads = 256;

// Layout of the host-side parameter arrays, mirrored in
// ops/coupling_planes.py::_IPARAMS / _FPARAMS.
enum IParam {
  I_NX, I_NY, I_NZ, I_CAP, I_NXG, I_XOFF, I_CD, I_CIN, I_NPRES, I_TORQUE,
  I_AM, I_ABS, I_PERX, I_PERY, I_PERZ, I_W, I_CW, I_NOFF, I_OFF0
};
// stencil offsets at I_OFF0 + 3*o + axis
constexpr int I_COUNT = I_OFF0 + 3 * kMaxOff;
// F_DH + 3*axis + (d+1) = float(d * h_axis); F_ORIGIN + axis; F_H + axis
enum FParam {
  F_DH = 0, F_ORIGIN = 9, F_H = 12, F_INV2S2 = 15, F_NU, F_RHO, F_NURHO,
  F_OOVRHO, F_C43PI, F_AMRHO, F_PI, F_COUNT
};

struct Params {
  int nx, ny, nz;          // local planes (a slab of nx planes at x_off)
  int cap, nx_global, x_off;
  int C_d, C_in, n_pres, torque, added_mass, absolute;
  int per[3];
  int W, C_w;              // window rows and channels (window kernel only)
  int n_off;
  int off[kMaxOff][3];
  float dh[3][3];
  float origin[3], h[3];
  float inv2s2, nu, rho_f, nu_rho, oo_vrho, c43pi, am_rho, pi;
  long long ncell;
};

inline Params make_params(const int* ip, const float* fp) {
  Params P;
  P.nx = ip[I_NX]; P.ny = ip[I_NY]; P.nz = ip[I_NZ];
  P.cap = ip[I_CAP]; P.nx_global = ip[I_NXG]; P.x_off = ip[I_XOFF];
  P.C_d = ip[I_CD]; P.C_in = ip[I_CIN]; P.n_pres = ip[I_NPRES];
  P.torque = ip[I_TORQUE]; P.added_mass = ip[I_AM]; P.absolute = ip[I_ABS];
  P.per[0] = ip[I_PERX]; P.per[1] = ip[I_PERY]; P.per[2] = ip[I_PERZ];
  P.W = ip[I_W]; P.C_w = ip[I_CW];
  P.n_off = ip[I_NOFF];
  for (int o = 0; o < kMaxOff; ++o)
    for (int a = 0; a < 3; ++a) P.off[o][a] = ip[I_OFF0 + 3 * o + a];
  for (int a = 0; a < 3; ++a) {
    for (int d = 0; d < 3; ++d) P.dh[a][d] = fp[F_DH + 3 * a + d];
    P.origin[a] = fp[F_ORIGIN + a];
    P.h[a] = fp[F_H + a];
  }
  P.inv2s2 = fp[F_INV2S2]; P.nu = fp[F_NU]; P.rho_f = fp[F_RHO];
  P.nu_rho = fp[F_NURHO]; P.oo_vrho = fp[F_OOVRHO]; P.c43pi = fp[F_C43PI];
  P.am_rho = fp[F_AMRHO]; P.pi = fp[F_PI];
  P.ncell = (long long)P.nx * P.ny * P.nz;
  return P;
}

// The counts the template instance <TORQUE, AM> works with must be the
// ones the host passed, and the stencil must fit.
template <bool TORQUE, bool AM>
inline bool counts_agree(const Params& P) {
  return P.C_d == 7 + 3 * TORQUE && P.C_in == 10 + 3 * TORQUE + 3 * AM
         && P.n_pres == 4 + 3 * TORQUE && P.torque == (int)TORQUE
         && P.added_mass == (int)AM && P.n_off > 0 && P.n_off <= kMaxOff;
}

inline unsigned int blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

// Separable factor of one axis for delta d in {-1, 0, 1} of a particle at
// coordinate p in cell `c` along that axis (global index for x), with the
// wall mask of a non-periodic axis: offsets that leave the domain weigh
// nothing. Relative positions (window) are taken against d*h; absolute
// ones (planes) against the cell centre, grouped as the JAX package's
// `_axis_factors_plane` groups it: ox + (xi + (d + 0.5)) * hx for x and
// oy + (float(iy + d) + 0.5) * hy for y and z.
__device__ __forceinline__ float factor(const Params& P, int axis, float p,
                                        int d, int c, int n) {
  float t;
  if (P.absolute) {
    float ctr = axis == 0
        ? P.origin[0] + ((float)c + ((float)d + 0.5f)) * P.h[0]
        : P.origin[axis] + ((float)(c + d) + 0.5f) * P.h[axis];
    t = p - ctr;
  } else {
    t = p - P.dh[axis][d + 1];
  }
  float e = expf(-(t * t) * P.inv2s2);
  if (!P.per[axis] && d != 0 && (c + d < 0 || c + d >= n)) e = 0.0f;
  return e;
}

__device__ __forceinline__ void factors(const Params& P, float px, float py,
                                        float pz, int gi, int y, int z,
                                        float* fx, float* fy, float* fz) {
  for (int d = -1; d <= 1; ++d) {
    fx[d + 1] = factor(P, 0, px, d, gi, P.nx_global);
    fy[d + 1] = factor(P, 1, py, d, y, P.ny);
    fz[d + 1] = factor(P, 2, pz, d, z, P.nz);
  }
}

__device__ __forceinline__ float weight(const Params& P, const float* fx,
                                        const float* fy, const float* fz, int o) {
  return fx[P.off[o][0] + 1] * fy[P.off[o][1] + 1] * fz[P.off[o][2] + 1];
}

// Slot coordinates (plane i, y, z) of a flat cell index.
__device__ __forceinline__ void cell_coords(const Params& P, long long cell,
                                            int* i, int* y, int* z) {
  *z = (int)(cell % P.nz);
  *y = (int)((cell / P.nz) % P.ny);
  *i = (int)(cell / ((long long)P.ny * P.nz));
}

// Interpolate the CIN input channels at one slot over the stencil: G gets
// the normalised interpolants, the return value is the weight norm.
template <int CIN>
__device__ __forceinline__ float interp_slot(const Params& P,
                                             const float* __restrict__ Fp,
                                             int i, int y, int z, const float* fx,
                                             const float* fy, const float* fz,
                                             float* G, float* inv_norm_out) {
  const long long sy = P.nz + 2, sx = (long long)(P.ny + 2) * sy;
  const long long sc = (long long)(P.nx + 2) * sx;
  float acc[CIN];
  float norm = 0.0f;
#pragma unroll
  for (int c = 0; c < CIN; ++c) acc[c] = 0.0f;
  for (int o = 0; o < P.n_off; ++o) {
    float w = weight(P, fx, fy, fz, o);
    norm = norm + w;
    const float* f = Fp + (i + 1 + P.off[o][0]) * sx + (y + 1 + P.off[o][1]) * sy
                     + (z + 1 + P.off[o][2]);
#pragma unroll
    for (int c = 0; c < CIN; ++c) acc[c] = acc[c] + w * f[c * sc];
  }
  float inv_norm = norm > 0.0f ? 1.0f / norm : 0.0f;
#pragma unroll
  for (int c = 0; c < CIN; ++c) G[c] = acc[c] * inv_norm;
  *inv_norm_out = inv_norm;
  return norm;
}

// Wen-Yu / Ergun blended drag coefficient (coupling.drag_coefficient).
__device__ __forceinline__ float drag_coefficient(const Params& P, float af,
                                                  float ap, float mag_ur, float dia) {
  float Re = 1e-12f + mag_ur * dia / P.nu;
  float cd = Re < 1000.0f ? (24.0f / Re) * (1.0f + 0.15f * powf(Re, 0.687f)) : 0.44f;
  if (af > 0.8f) {
    return 0.75f * cd * af * ap * P.rho_f * mag_ur * powf(af, -2.65f);
  }
  return 150.0f * (ap * ap / fmaxf(af, 1e-6f)) * P.nu_rho / (dia * dia)
         + 1.75f * ap * P.rho_f * mag_ur / dia;
}

// The force laws of coupling_planes._physics_planes at one occupied slot.
// G: u (0:3), grad p (3:6), div tau (6:9), [curl u], [ddt u], alpha (last).
// res: force (3) [, torque (3)], found; Vn: the 8 pre-normalised deposit
// values vol, vol*vel (3), -coeff/rho_f, source part (3).
template <bool TORQUE, bool AM>
__device__ __forceinline__ void slot_physics(const Params& P, const float* G,
                                             float norm, float inv_norm, float rad,
                                             const float* vel, const float* angvel,
                                             float* res, float* Vn) {
  constexpr int kDdt = 9 + 3 * TORQUE;
  constexpr int kAlpha = kDdt + 3 * AM;
  bool found = norm > 0.0f;
  float af = G[kAlpha];
  float dia = 2.0f * rad;
  float vol = P.c43pi * (rad * rad * rad);
  float ap = fminf(fmaxf(1.0f - af, 1e-6f), 1.0f);
  float ur[3] = {G[0] - vel[0], G[1] - vel[1], G[2] - vel[2]};
  float mag_ur = sqrtf(ur[0] * ur[0] + ur[1] * ur[1] + ur[2] * ur[2]);
  float coeff = found ? drag_coefficient(P, af, ap, mag_ur, dia) : 0.0f;
  float drag = vol * coeff / ap;
  Vn[0] = vol * inv_norm;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float f_arch = found ? vol * P.rho_f * (-G[3 + c] + G[6 + c]) : 0.0f;
    float force = drag * ur[c] + f_arch;
    float src = -f_arch;
    if constexpr (AM) {
      float f_am = found ? P.am_rho * vol * G[kDdt + c] : 0.0f;
      force = force + f_am;
      src = -(f_arch + f_am);
    }
    res[c] = found ? force : 0.0f;
    if constexpr (TORQUE) {
      float t = P.pi * (dia * dia * dia) * (0.5f * G[9 + c] - angvel[c]) * P.nu * P.rho_f;
      res[3 + c] = found ? t : 0.0f;
    }
    Vn[1 + c] = (vol * vel[c]) * inv_norm;
    Vn[5 + c] = (src * P.oo_vrho) * inv_norm;
  }
  Vn[4] = (-(coeff / P.rho_f)) * inv_norm;
  res[3 + 3 * TORQUE] = found ? 1.0f : 0.0f;
}

// One thread per slot: interpolation, force laws, per-slot results and the
// pre-normalised deposit values. Empty slots (radius 0) write zero results
// and stop after one load; their V is never read.
template <bool TORQUE, bool AM>
__global__ void slot_kernel(Params P, const float* __restrict__ Fp,
                            const float* __restrict__ D, float* __restrict__ V,
                            float* __restrict__ pres) {
  constexpr int CIN = 10 + 3 * TORQUE + 3 * AM;
  constexpr int NPRES = 4 + 3 * TORQUE;
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n_slot = (long long)P.cap * P.ncell;
  if (s >= n_slot) return;
  float rad = D[6 * n_slot + s];
  if (!(rad > 0.0f)) {
#pragma unroll
    for (int c = 0; c < NPRES; ++c) pres[c * n_slot + s] = 0.0f;
    return;
  }
  int i, y, z;
  cell_coords(P, s % P.ncell, &i, &y, &z);
  float fx[3], fy[3], fz[3];
  factors(P, D[s], D[n_slot + s], D[2 * n_slot + s], i + P.x_off, y, z, fx, fy, fz);
  float G[CIN];
  float inv_norm;
  float norm = interp_slot<CIN>(P, Fp, i, y, z, fx, fy, fz, G, &inv_norm);
  float vel[3] = {D[3 * n_slot + s], D[4 * n_slot + s], D[5 * n_slot + s]};
  float angvel[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (TORQUE) {
#pragma unroll
    for (int c = 0; c < 3; ++c) angvel[c] = D[(7 + c) * n_slot + s];
  }
  float res[NPRES], Vn[kCout];
  slot_physics<TORQUE, AM>(P, G, norm, inv_norm, rad, vel, angvel, res, Vn);
#pragma unroll
  for (int c = 0; c < NPRES; ++c) pres[c * n_slot + s] = res[c];
#pragma unroll
  for (int c = 0; c < kCout; ++c) V[c * n_slot + s] = Vn[c];
}

// One thread per slot: the interpolation half alone, G (CIN, cap, ncell)
// normalised and the weight norm (cap, ncell). Every slot is written; an
// empty one gets zeros, as its gated weights give in the JAX kernel.
template <int CIN>
__global__ void interp_kernel(Params P, const float* __restrict__ Fp,
                              const float* __restrict__ D, float* __restrict__ Gout,
                              float* __restrict__ norm_out) {
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n_slot = (long long)P.cap * P.ncell;
  if (s >= n_slot) return;
  float rad = D[6 * n_slot + s];
  if (!(rad > 0.0f)) {
#pragma unroll
    for (int c = 0; c < CIN; ++c) Gout[c * n_slot + s] = 0.0f;
    norm_out[s] = 0.0f;
    return;
  }
  int i, y, z;
  cell_coords(P, s % P.ncell, &i, &y, &z);
  float fx[3], fy[3], fz[3];
  factors(P, D[s], D[n_slot + s], D[2 * n_slot + s], i + P.x_off, y, z, fx, fy, fz);
  float G[CIN];
  float inv_norm;
  float norm = interp_slot<CIN>(P, Fp, i, y, z, fx, fy, fz, G, &inv_norm);
#pragma unroll
  for (int c = 0; c < CIN; ++c) Gout[c * n_slot + s] = G[c];
  norm_out[s] = norm;
}

// One thread per (dx stack, cell): all 8 channels of
// stks[dx][c, i, y, z] = sum_o sum_k w_o(slot) * V[c, slot] over the
// source slots at (i, y - dy, z - dz) of the offsets o with that dx; the
// weight is recomputed from D (raw Gaussian product, V pre-normalised).
__global__ void deposit_kernel(Params P, const float* __restrict__ D,
                               const float* __restrict__ V, float* __restrict__ stks) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)kStacks * P.ncell) return;
  int ci = (int)(t / P.ncell);      // the stack of dx = ci - 1
  long long cell = t % P.ncell;
  int i, y, z;
  cell_coords(P, cell, &i, &y, &z);
  long long n_slot = (long long)P.cap * P.ncell;
  float acc[kCout];
#pragma unroll
  for (int c = 0; c < kCout; ++c) acc[c] = 0.0f;
  for (int o = 0; o < P.n_off; ++o) {
    int dx = P.off[o][0], dy = P.off[o][1], dz = P.off[o][2];
    if (dx + 1 != ci) continue;
    // the source slot whose deposit lands on (y, z) after the (dy, dz) shift
    int ys = ((y - dy) % P.ny + P.ny) % P.ny;
    int zs = ((z - dz) % P.nz + P.nz) % P.nz;
    long long src = ((long long)i * P.ny + ys) * P.nz + zs;
    float contrib[kCout];
#pragma unroll
    for (int c = 0; c < kCout; ++c) contrib[c] = 0.0f;
    for (int k = 0; k < P.cap; ++k) {
      long long s = (long long)k * P.ncell + src;
      float rad = D[6 * n_slot + s];
      if (!(rad > 0.0f)) continue;
      float w = factor(P, 0, D[s], dx, i + P.x_off, P.nx_global)
                * factor(P, 1, D[n_slot + s], dy, ys, P.ny)
                * factor(P, 2, D[2 * n_slot + s], dz, zs, P.nz);
#pragma unroll
      for (int c = 0; c < kCout; ++c) contrib[c] = contrib[c] + w * V[c * n_slot + s];
    }
#pragma unroll
    for (int c = 0; c < kCout; ++c) acc[c] = acc[c] + contrib[c];
  }
#pragma unroll
  for (int c = 0; c < kCout; ++c) {
    stks[((long long)ci * kCout + c) * P.ncell + cell] = acc[c];
  }
}

// Launch slot_kernel for the (torque, added mass) instance P asks for.
template <bool TORQUE, bool AM>
cudaError_t launch_slots_t(const Params& P, const float* Fp, const float* D,
                           float* V, float* pres, cudaStream_t st) {
  if (!counts_agree<TORQUE, AM>(P)) return cudaErrorInvalidValue;
  slot_kernel<TORQUE, AM><<<blocks((long long)P.cap * P.ncell), kThreads, 0, st>>>(
      P, Fp, D, V, pres);
  return cudaGetLastError();
}

inline cudaError_t launch_slots(const Params& P, const float* Fp, const float* D,
                                float* V, float* pres, cudaStream_t st) {
  if (P.torque) {
    return P.added_mass ? launch_slots_t<true, true>(P, Fp, D, V, pres, st)
                        : launch_slots_t<true, false>(P, Fp, D, V, pres, st);
  }
  return P.added_mass ? launch_slots_t<false, true>(P, Fp, D, V, pres, st)
                      : launch_slots_t<false, false>(P, Fp, D, V, pres, st);
}

inline cudaError_t launch_deposit(const Params& P, const float* D, const float* V,
                                  float* stks, cudaStream_t st) {
  if (P.n_off <= 0 || P.n_off > kMaxOff) return cudaErrorInvalidValue;
  deposit_kernel<<<blocks((long long)kStacks * P.ncell), kThreads, 0, st>>>(P, D, V, stks);
  return cudaGetLastError();
}

}  // namespace yofc

// Sizes of the parameter arrays, so the Python side can check its layout.
extern "C" int yofc_param_counts(int* n_int, int* n_float) {
  *n_int = yofc::I_COUNT;
  *n_float = yofc::F_COUNT;
  return yofc::kMaxOff;
}
