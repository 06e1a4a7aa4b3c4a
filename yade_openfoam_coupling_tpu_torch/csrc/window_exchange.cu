// Window-staged Gaussian coupling exchange on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `ops/coupling_window.py::_window_kernel`
// of the JAX package (with its helpers `_stage_mxu`, `_axis_factors_rel`
// and `coupling_planes._physics_planes`). Same contract as the JAX
// launcher `window_exchange_padded`: from the ghost-padded fluid stack
// Fp (C_in, nx+2, ny+2, nz+2) and the per-x-plane particle windows
// dat_win (nx, C_w, W) it writes one deposit stack per dx with the dy and
// dz shifts applied (`dy_in_kernel`), stks (3, 8, nx, ny, nz), and the
// per-slot results pres (4, cap, nx*ny*nz).
//
// What bounds it on this card: bytes. At 128^3 with 100k particles it
// reads about 88 MB of Fp and writes about 200 MB of stacks and about
// 134 MB of pres; the arithmetic (19 Gaussian weights and a drag law per
// occupied slot) is small, and only ~1% of the cap * ncells slots are
// occupied in the dilute main-path configuration.
//
// What the design does about it. The TPU kernel staged each plane's window
// into slot planes with one-hot bf16 matmuls because the TPU has no
// scatter. Here every kept window row owns a unique (rank, plane, y, z)
// slot, so staging is a conflict-free store of hi + lo (exact in f32).
// Three launches, each one thread per output element:
//   1. stage:   one thread per window row -> slot table D (7, cap, nx, ny, nz)
//               (zeroed by the caller); rows past counts[i], with y < 0 or
//               with rank >= cap do nothing.
//   2. slots:   one thread per slot. Empty slots (radius 0) write zero
//               results and stop after one load. Occupied slots build the
//               separable Gaussian factors with the wall masks, gather the
//               10 input channels at the 19 stencil offsets, normalise, run
//               the drag/Archimedes laws, write pres and the pre-normalised
//               deposit values V (8, cap, ncells) to scratch.
//   3. deposit: one thread per (dx stack, cell) computing all 8 channels as
//               a gather over the source slots that deposit into it
//               (stks[dx][c,i,y,z] = sum_o sum_k w_o * V at (y-dy, z-dz)),
//               so the scatter needs no atomics and is deterministic.
// Every empty slot is rejected after reading its radius, so the traffic
// that remains is the slot-table zeroing, the radius planes and the
// outputs. Shared-memory tiling, fusing the launches and TMA are left to
// later work. Built with -fmad=false so that every product and sum rounds
// as in the plain PyTorch version it is checked against.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxOff = 27;
constexpr int kCd = 7;      // staged channels: rel pos (3), vel (3), radius
constexpr int kCin = 10;    // input channels: u (3), grad p (3), div tau (3), alpha
constexpr int kCout = 8;    // deposit channels
constexpr int kThreads = 256;

// Layout of the host-side integer parameter array (mirrored in
// ops/coupling_window.py::_kernel_params).
enum IParam {
  I_NX, I_NY, I_NZ, I_W, I_CW, I_CIN, I_CAP, I_NXG, I_XOFF,
  I_PERX, I_PERY, I_PERZ, I_NOFF, I_OFF0
};
// stencil offsets at I_OFF0 + 3*o + axis
constexpr int I_COUNT = I_OFF0 + 3 * kMaxOff;
constexpr int kStacks = 3;  // one deposit stack per dx in {-1, 0, 1}
// float parameters: F_DH + 3*axis + (d+1) = float(d * h_axis)
enum FParam { F_DH = 0, F_INV2S2 = 9, F_NU, F_RHO, F_NURHO, F_OOVRHO, F_C43PI, F_COUNT };

struct Params {
  int nx, ny, nz, W, C_w, cap, nx_global, x_off;
  int per[3];
  int n_off;
  int off[kMaxOff][3];
  float dh[3][3];
  float inv2s2, nu, rho_f, nu_rho, oo_vrho, c43pi;
  long long ncell;
};

__device__ __forceinline__ float gauss(float rel, float dh, float inv2s2) {
  float t = rel - dh;
  return expf(-(t * t) * inv2s2);
}

// Separable factor of one axis for delta d in {-1, 0, 1} of a particle in
// cell `c` along that axis (global index for x), with the wall mask of a
// non-periodic axis: offsets that leave the domain weigh nothing.
__device__ __forceinline__ float factor(const Params& P, int axis, float rel,
                                        int d, int c, int n) {
  float e = gauss(rel, P.dh[axis][d + 1], P.inv2s2);
  if (!P.per[axis] && d != 0 && (c + d < 0 || c + d >= n)) e = 0.0f;
  return e;
}

__device__ __forceinline__ float weight(const Params& P, const float* fx,
                                        const float* fy, const float* fz, int o) {
  return fx[P.off[o][0] + 1] * fy[P.off[o][1] + 1] * fz[P.off[o][2] + 1];
}

__device__ __forceinline__ void factors(const Params& P, float relx, float rely,
                                        float relz, int gi, int y, int z,
                                        float* fx, float* fy, float* fz) {
  for (int d = -1; d <= 1; ++d) {
    fx[d + 1] = factor(P, 0, relx, d, gi, P.nx_global);
    fy[d + 1] = factor(P, 1, rely, d, y, P.ny);
    fz[d + 1] = factor(P, 2, relz, d, z, P.nz);
  }
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

__global__ void stage_kernel(Params P, const float* __restrict__ dat_win,
                             const int* __restrict__ counts, float* __restrict__ D) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)P.nx * P.W) return;
  int i = (int)(t / P.W);
  int w = (int)(t % P.W);
  if (counts != nullptr) {
    int c = min(max(counts[i], 0), P.W);
    if (w >= c) return;
  }
  const float* row = dat_win + (long long)i * P.C_w * P.W + w;
  float y = row[(long long)(2 * kCd) * P.W];
  if (!(y >= 0.0f)) return;
  int yi = (int)y;
  int zi = (int)row[(long long)(2 * kCd + 1) * P.W];
  int k = (int)row[(long long)(2 * kCd + 2) * P.W];
  if (k < 0 || k >= P.cap || yi >= P.ny || zi < 0 || zi >= P.nz) return;
  long long cell = ((long long)i * P.ny + yi) * P.nz + zi;
  for (int c = 0; c < kCd; ++c) {
    D[((long long)c * P.cap + k) * P.ncell + cell] =
        row[(long long)c * P.W] + row[(long long)(kCd + c) * P.W];
  }
}

__global__ void slot_kernel(Params P, const float* __restrict__ Fp,
                            const float* __restrict__ D, float* __restrict__ V,
                            float* __restrict__ pres) {
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n_slot = (long long)P.cap * P.ncell;
  if (s >= n_slot) return;
  long long cell = s % P.ncell;
  int z = (int)(cell % P.nz);
  int y = (int)((cell / P.nz) % P.ny);
  int i = (int)(cell / ((long long)P.ny * P.nz));
  float rad = D[6 * n_slot + s];
  if (!(rad > 0.0f)) {
    for (int c = 0; c < 4; ++c) pres[c * n_slot + s] = 0.0f;
    return;
  }
  float relx = D[0 * n_slot + s], rely = D[1 * n_slot + s], relz = D[2 * n_slot + s];
  float vel[3] = {D[3 * n_slot + s], D[4 * n_slot + s], D[5 * n_slot + s]};
  float fx[3], fy[3], fz[3];
  factors(P, relx, rely, relz, i + P.x_off, y, z, fx, fy, fz);

  // interpolate the input channels; normalise at the end
  const long long sy = P.nz + 2, sx = (long long)(P.ny + 2) * sy;
  const long long sc = (long long)(P.nx + 2) * sx;
  float acc[kCin];
  float norm = 0.0f;
  for (int c = 0; c < kCin; ++c) acc[c] = 0.0f;
  for (int o = 0; o < P.n_off; ++o) {
    float w = weight(P, fx, fy, fz, o);
    norm = norm + w;
    const float* f = Fp + (i + 1 + P.off[o][0]) * sx + (y + 1 + P.off[o][1]) * sy
                     + (z + 1 + P.off[o][2]);
    for (int c = 0; c < kCin; ++c) acc[c] = acc[c] + w * f[c * sc];
  }
  float inv_norm = norm > 0.0f ? 1.0f / norm : 0.0f;
  float G[kCin];
  for (int c = 0; c < kCin; ++c) G[c] = acc[c] * inv_norm;
  bool found = norm > 0.0f;

  // force laws (coupling_planes._physics_planes without torque/added mass)
  float af = G[9];
  float dia = 2.0f * rad;
  float vol = P.c43pi * (rad * rad * rad);
  float ap = fminf(fmaxf(1.0f - af, 1e-6f), 1.0f);
  float ur[3] = {G[0] - vel[0], G[1] - vel[1], G[2] - vel[2]};
  float mag_ur = sqrtf(ur[0] * ur[0] + ur[1] * ur[1] + ur[2] * ur[2]);
  float coeff = found ? drag_coefficient(P, af, ap, mag_ur, dia) : 0.0f;
  float drag = vol * coeff / ap;
  float Vn[kCout];
  Vn[0] = vol * inv_norm;
  for (int c = 0; c < 3; ++c) {
    float f_arch = found ? vol * P.rho_f * (-G[3 + c] + G[6 + c]) : 0.0f;
    float force = drag * ur[c] + f_arch;
    pres[c * n_slot + s] = found ? force : 0.0f;
    Vn[1 + c] = (vol * vel[c]) * inv_norm;
    Vn[5 + c] = (-f_arch * P.oo_vrho) * inv_norm;
  }
  Vn[4] = (-(coeff / P.rho_f)) * inv_norm;
  pres[3 * n_slot + s] = found ? 1.0f : 0.0f;
  for (int c = 0; c < kCout; ++c) V[c * n_slot + s] = Vn[c];
}

__global__ void deposit_kernel(Params P, const float* __restrict__ D,
                               const float* __restrict__ V, float* __restrict__ stks) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)kStacks * P.ncell) return;
  int ci = (int)(t / P.ncell);      // the stack of dx = ci - 1
  long long cell = t % P.ncell;
  int z = (int)(cell % P.nz);
  int y = (int)((cell / P.nz) % P.ny);
  int i = (int)(cell / ((long long)P.ny * P.nz));
  long long n_slot = (long long)P.cap * P.ncell;
  float acc[kCout];
  for (int c = 0; c < kCout; ++c) acc[c] = 0.0f;
  for (int o = 0; o < P.n_off; ++o) {
    int dx = P.off[o][0], dy = P.off[o][1], dz = P.off[o][2];
    if (dx + 1 != ci) continue;
    // the source slot whose deposit lands on (y, z) after the (dy, dz) shift
    int ys = ((y - dy) % P.ny + P.ny) % P.ny;
    int zs = ((z - dz) % P.nz + P.nz) % P.nz;
    long long src = ((long long)i * P.ny + ys) * P.nz + zs;
    float contrib[kCout];
    for (int c = 0; c < kCout; ++c) contrib[c] = 0.0f;
    for (int k = 0; k < P.cap; ++k) {
      long long s = (long long)k * P.ncell + src;
      float rad = D[6 * n_slot + s];
      if (!(rad > 0.0f)) continue;
      float w = factor(P, 0, D[s], dx, i + P.x_off, P.nx_global)
                * factor(P, 1, D[n_slot + s], dy, ys, P.ny)
                * factor(P, 2, D[2 * n_slot + s], dz, zs, P.nz);
      for (int c = 0; c < kCout; ++c) contrib[c] = contrib[c] + w * V[c * n_slot + s];
    }
    for (int c = 0; c < kCout; ++c) acc[c] = acc[c] + contrib[c];
  }
  for (int c = 0; c < kCout; ++c) {
    stks[((long long)ci * kCout + c) * P.ncell + cell] = acc[c];
  }
}

Params make_params(const int* ip, const float* fp) {
  Params P;
  P.nx = ip[I_NX]; P.ny = ip[I_NY]; P.nz = ip[I_NZ];
  P.W = ip[I_W]; P.C_w = ip[I_CW]; P.cap = ip[I_CAP];
  P.nx_global = ip[I_NXG]; P.x_off = ip[I_XOFF];
  P.per[0] = ip[I_PERX]; P.per[1] = ip[I_PERY]; P.per[2] = ip[I_PERZ];
  P.n_off = ip[I_NOFF];
  for (int o = 0; o < kMaxOff; ++o)
    for (int a = 0; a < 3; ++a) P.off[o][a] = ip[I_OFF0 + 3 * o + a];
  for (int a = 0; a < 3; ++a)
    for (int d = 0; d < 3; ++d) P.dh[a][d] = fp[F_DH + 3 * a + d];
  P.inv2s2 = fp[F_INV2S2]; P.nu = fp[F_NU]; P.rho_f = fp[F_RHO];
  P.nu_rho = fp[F_NURHO]; P.oo_vrho = fp[F_OOVRHO]; P.c43pi = fp[F_C43PI];
  P.ncell = (long long)P.nx * P.ny * P.nz;
  return P;
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Sizes of the parameter arrays, so the Python side can check its layout.
int yofc_window_param_counts(int* n_int, int* n_float) {
  *n_int = I_COUNT;
  *n_float = F_COUNT;
  return kMaxOff;
}

// All pointers are device pointers except iparams/fparams (host). counts
// may be null (every window row is read). D must be zero on entry. Returns
// the first nonzero cudaGetLastError() after a launch, else 0.
int yofc_window_exchange(const int* iparams, const float* fparams,
                         const float* Fp, const float* dat_win, const int* counts,
                         float* D, float* V, float* stks, float* pres,
                         void* stream) {
  Params P = make_params(iparams, fparams);
  if (iparams[I_CIN] != kCin || P.n_off > kMaxOff || P.n_off <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  stage_kernel<<<blocks((long long)P.nx * P.W), kThreads, 0, st>>>(P, dat_win, counts, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  slot_kernel<<<blocks((long long)P.cap * P.ncell), kThreads, 0, st>>>(P, Fp, D, V, pres);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  deposit_kernel<<<blocks((long long)kStacks * P.ncell), kThreads, 0, st>>>(P, D, V, stks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

}  // extern "C"
