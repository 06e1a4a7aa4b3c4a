// Device code shared by the Gaussian coupling-exchange kernels on Hopper
// (sm_90a): the window kernel (window_exchange.cu) and the planes kernels
// (planes_exchange.cu).
//
// A slot (k, cell) holds the k-th particle of that cell (position,
// velocity, radius [, angular velocity]). The window kernel reads its slots
// from per-plane window rows with anchor-relative positions; the planes
// kernels from a channel-major slot table D (C_d, cap, ncell) binned by
// torch ops, with absolute positions (Params::absolute), where an empty
// slot has radius 0. What is shared:
//   * the separable Gaussian factors with the wall masks of non-periodic
//     axes (`factor`), in the JAX package's operation order for either
//     kind of position;
//   * `interp_slot` (the C_in input channels interpolated from the
//     ghost-padded fluid stack Fp (C_in, nx+2, ny+2, nz+2) over the
//     stencil) and `slot_physics` (the force laws of
//     `coupling_planes._physics_planes`: drag, Archimedes, optional added
//     mass and rotational Stokes torque);
//   * the two passes of the fused exchange, which work only where
//     particles are:
//       - the rows pass (`exchange_slot`, called by each kernel's own rows
//         kernel for an occupied slot): interpolation and force laws into
//         a compact record of kRec floats (the 8 pre-normalised deposit
//         values, the 9 separable factors and the slot's n_pres results),
//         ~10 MB at 100k particles, so it stays in L2. The records of one
//         cell are contiguous, rank 0 first: a per-cell count of records
//         (its ranks 0..cnt-1; an empty slot below an occupied rank gets a
//         zero record) and the record index of its rank 0 say where they
//         are, for any slot capacity;
//       - the cells pass (`cells_kernel`): one block per band of rows of
//         one plane stages the band's and its +-1-row halo's record
//         counts and records in shared memory; then one thread per cell
//         gathers the records of the occupied source slots of its <= 19
//         stencil offsets (weights = products of stored factors, no exp
//         recomputed), writes all 3 dx stacks x 8 channels of its cell
//         and, where asked, its cap pres slots (the record's results, or
//         zeros) once, coalesced, so nothing needs a memset. No atomics on
//         floats: the sums run per offset in stencil order, ranks
//         ascending, as the plain version orders them.
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
// record: deposit values (0:8), fx (8:11), fy (11:14), fz (14:17), the
// per-slot results (17:17+n_pres, n_pres <= 7); 6 x 16 bytes
constexpr int kRec = 24;
constexpr int kRecFx = 8, kRecFy = 11, kRecFz = 14, kRecPres = 17;
constexpr int kRec4 = kRec / 4;
// cells pass: at most kBandRows output rows a block, about kHaloCells
// staged cells, and the records of up to kSmemRecs slots in shared memory
// (a block whose halo holds more reads them from device memory instead)
constexpr int kBandRows = 8;
constexpr int kHaloCells = 2048;
constexpr int kSmemRecs = 256;

// Layout of the host-side parameter arrays, mirrored in
// ops/coupling_planes.py::_IPARAMS / _FPARAMS.
enum IParam {
  I_NX, I_NY, I_NZ, I_CAP, I_NXG, I_XOFF, I_CD, I_CIN, I_NPRES, I_TORQUE,
  I_AM, I_ABS, I_PERX, I_PERY, I_PERZ, I_W, I_CW, I_NREC, I_NOFF, I_OFF0
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
  int n_rec;               // records the scratch holds (fused exchanges)
  int n_off;
  int off[kMaxOff][3];
  // the offsets grouped by dx = g - 1, each group in stencil order (the
  // cells pass): n_grp[g] of them, (dy, dz) at grp[g][j]
  int n_grp[kStacks];
  int grp[kStacks][9][2];
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
  P.W = ip[I_W]; P.C_w = ip[I_CW]; P.n_rec = ip[I_NREC];
  P.n_off = ip[I_NOFF];
  for (int o = 0; o < kMaxOff; ++o)
    for (int a = 0; a < 3; ++a) P.off[o][a] = ip[I_OFF0 + 3 * o + a];
  for (int g = 0; g < kStacks; ++g) P.n_grp[g] = 0;
  for (int o = 0; o < P.n_off && o < kMaxOff; ++o) {
    const int g = P.off[o][0] + 1;
    if (g < 0 || g >= kStacks || P.n_grp[g] >= 9) continue;   // refused by fused_sizes_ok
    P.grp[g][P.n_grp[g]][0] = P.off[o][1];
    P.grp[g][P.n_grp[g]][1] = P.off[o][2];
    ++P.n_grp[g];
  }
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

inline unsigned int blocks(long long n, long long per_block = kThreads) {
  return (unsigned int)((n + per_block - 1) / per_block);
}

// Exclusive prefix sum of one int per thread over a block of kThreads;
// *s_total gets the block's sum. Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int n, int* s_warp, int* s_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int q = 0; q < kThreads / 32; ++q) {
      const int v = s_warp[q];
      s_warp[q] = total;
      total += v;
    }
    *s_total = total;
  }
  __syncthreads();
  return s_warp[warp] + incl - n;
}

// Scratch of the fused exchanges, carved from one buffer of 4-byte words,
// each segment rounded up to 4 words (16 bytes). Mirrored in
// ops/coupling_planes.py::_scratch_layout.
//   cnt:  ncell, the records of each cell (its ranks 0..cnt-1);
//   base: ncell, the record index of each cell's rank 0 (read only where
//         cnt > 0);
//   lst:  1 + n_rec, the number of listed slots, then their slot indices
//         (planes only);
//   rec:  kRec * n_rec floats.
struct Scratch {
  int* cnt;
  int* base;
  int* lst;
  float* rec;
};

inline long long round4(long long n) { return (n + 3) / 4 * 4; }

// Word offsets of the segments cnt, base, lst, rec, and the total words.
inline void scratch_layout(long long ncell, long long n_rec, long long* off) {
  off[0] = 0;
  off[1] = off[0] + round4(ncell);
  off[2] = off[1] + round4(ncell);
  off[3] = off[2] + round4(1 + n_rec);
  off[4] = off[3] + kRec * n_rec;
}

inline Scratch carve(const Params& P, int* words) {
  long long off[5];
  scratch_layout(P.ncell, P.n_rec, off);
  Scratch S;
  S.cnt = words + off[0];
  S.base = words + off[1];
  S.lst = words + off[2];
  S.rec = reinterpret_cast<float*>(words + off[3]);
  return S;
}

// What the fused exchanges take beyond counts_agree: slot and record
// indices that fit an int, and a stencil in {-1, 0, 1}^3 (so every offset
// sits in its dx group). Any slot capacity >= 1.
inline bool fused_sizes_ok(const Params& P) {
  if (P.cap < 1 || P.n_rec < 0 || P.n_off <= 0 || P.n_off > kMaxOff
      || (long long)P.cap * P.ncell >= (1LL << 31))
    return false;
  for (int o = 0; o < P.n_off; ++o)
    for (int a = 0; a < 3; ++a)
      if (P.off[o][a] < -1 || P.off[o][a] > 1) return false;
  return P.n_grp[0] + P.n_grp[1] + P.n_grp[2] == P.n_off;
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

// f[d + 1] by selects, so the factor arrays stay in registers.
__device__ __forceinline__ float pick(const float* f, int d) {
  return d < 0 ? f[0] : (d == 0 ? f[1] : f[2]);
}

__device__ __forceinline__ float weight(const Params& P, const float* fx,
                                        const float* fy, const float* fz, int o) {
  return pick(fx, P.off[o][0]) * pick(fy, P.off[o][1]) * pick(fz, P.off[o][2]);
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
    for (int c = 0; c < CIN; ++c) acc[c] = acc[c] + w * __ldg(f + c * sc);
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

// The rows pass at one occupied slot of plane i, row y, column z, from its
// staged data d (position, velocity, radius [, angular velocity]): its
// record into rec (kRec floats, 16-byte aligned).
template <bool TORQUE, bool AM>
__device__ __forceinline__ void exchange_slot(const Params& P, const float* __restrict__ Fp,
                                              int i, int y, int z, const float* d,
                                              float* __restrict__ rec) {
  constexpr int CIN = 10 + 3 * TORQUE + 3 * AM;
  float fx[3], fy[3], fz[3];
  factors(P, d[0], d[1], d[2], i + P.x_off, y, z, fx, fy, fz);
  float G[CIN];
  float inv_norm;
  float norm = interp_slot<CIN>(P, Fp, i, y, z, fx, fy, fz, G, &inv_norm);
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  float res[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, Vn[kCout];
  slot_physics<TORQUE, AM>(P, G, norm, inv_norm, d[6], d + 3, TORQUE ? d + 7 : zero3,
                           res, Vn);
  float4* r4 = reinterpret_cast<float4*>(rec);
  r4[0] = make_float4(Vn[0], Vn[1], Vn[2], Vn[3]);
  r4[1] = make_float4(Vn[4], Vn[5], Vn[6], Vn[7]);
  r4[2] = make_float4(fx[0], fx[1], fx[2], fy[0]);
  r4[3] = make_float4(fy[1], fy[2], fz[0], fz[1]);
  r4[4] = make_float4(fz[2], res[0], res[1], res[2]);
  r4[5] = make_float4(res[3], res[4], res[5], res[6]);
}

// The record of an empty slot below an occupied rank of its cell: zero
// values, factors and results, so it adds nothing and its pres slot reads
// zeros, as the plain version gives an empty slot.
__device__ __forceinline__ void zero_record(float* __restrict__ rec) {
  float4* r4 = reinterpret_cast<float4*>(rec);
#pragma unroll
  for (int q = 0; q < kRec4; ++q) r4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Rows of the cells pass's bands for a plane of ny x nz cells: about
// kHaloCells staged cells a block, between 1 and kBandRows rows.
__host__ __device__ inline int band_rows(const Params& P) {
  const int r = kHaloCells / P.nz - 2;
  return r < 1 ? 1 : (r > kBandRows ? kBandRows : r);
}

// Dynamic shared memory of the cells pass: each staged cell's record
// count and the position of its first record among the halo's records.
inline size_t cells_smem(const Params& P) {
  return (size_t)(band_rows(P) + 2) * P.nz * 2 * sizeof(int);
}

// The record count of cell c, clamped to what the scratch can hold (no
// branch on the loaded value, so a thread's loads of several cells are in
// flight together).
__device__ __forceinline__ int cell_count(const Params& P, const Scratch& S, long long c) {
  return min(max(__ldg(S.cnt + c), 0), min(P.cap, P.n_rec));
}

// The index of the first of cell c's k records, clamped so that all k lie
// in the scratch whatever a caller's layout says.
__device__ __forceinline__ int cell_base(const Params& P, const Scratch& S, long long c,
                                         int k) {
  return max(0, min(__ldg(S.base + c), P.n_rec - k));
}

// The staged cell h of a cells block: the device-memory cell of row
// y0 - 1 + h / nz (wrapped), column h % nz, of the plane at `plane`.
__device__ __forceinline__ long long staged_cell(const Params& P, long long plane, int y0,
                                                 int h) {
  int ys = y0 - 1 + h / P.nz;
  ys += ys < 0 ? P.ny : 0;
  ys -= ys >= P.ny ? P.ny : 0;
  return plane + (long long)ys * P.nz + h % P.nz;
}

// One cell (row ty of the band, column z) of the cells pass: its 3 x 8
// stack values and, when pres is given, its cap pres slots. Staged cell h
// has s_cnt[h] records, ranks ascending: in shared memory from position
// s_pos[h] (STAGED, s_rec), else in device memory from the cell's base
// index. The offset loops are unrolled over the dx groups, so the stencil
// is read from the kernel's parameters at fixed places.
template <bool STAGED>
__device__ __forceinline__ void cells_one(const Params& P, long long plane, int y0, int ty,
                                          int z, const int* s_cnt, const int* s_pos,
                                          const float4* s_rec, const Scratch& S,
                                          float* __restrict__ stks, float* __restrict__ pres) {
  const int nz = P.nz;
  const long long cell = plane + (long long)(y0 + ty) * nz + z;
  auto first = [&](int h, int n) -> const float* {   // the first record of staged cell h
    if (STAGED) return reinterpret_cast<const float*>(s_rec + s_pos[h] * kRec4);
    return S.rec + (long long)cell_base(P, S, staged_cell(P, plane, y0, h), n) * kRec;
  };
#pragma unroll
  for (int ci = 0; ci < kStacks; ++ci) {   // the stack of dx = ci - 1
    float acc[kCout];
#pragma unroll
    for (int c = 0; c < kCout; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {           // its offsets, in stencil order
      if (j >= P.n_grp[ci]) break;
      const int dy = P.grp[ci][j][0], dz = P.grp[ci][j][1];
      int zs = z - dz;
      zs += zs < 0 ? nz : 0;
      zs -= zs >= nz ? nz : 0;
      const int h = (ty + 1 - dy) * nz + zs;
      const int n = s_cnt[h];
      if (!n) continue;
      float contrib[kCout];
#pragma unroll
      for (int c = 0; c < kCout; ++c) contrib[c] = 0.0f;
      const float* r = first(h, n);
      // the ranks, ascending; rolled: unrolling it in each of the 19
      // unrolled offsets doubles the kernel's code, whose instruction
      // fetches then cost more than the loop (measured on an H100)
#pragma unroll 1
      for (int m = 0; m < n; ++m, r += kRec) {
        const float w = r[kRecFx + ci] * r[kRecFy + dy + 1] * r[kRecFz + dz + 1];
#pragma unroll
        for (int c = 0; c < kCout; ++c) contrib[c] = contrib[c] + w * r[c];
      }
#pragma unroll
      for (int c = 0; c < kCout; ++c) acc[c] = acc[c] + contrib[c];
    }
#pragma unroll
    for (int c = 0; c < kCout; ++c) stks[((long long)ci * kCout + c) * P.ncell + cell] = acc[c];
  }
  if (pres == nullptr) return;
  const int h = (ty + 1) * nz + z;
  const int n = s_cnt[h];
  const float* r = n ? first(h, n) : nullptr;
  const long long n_slot = (long long)P.cap * P.ncell;
  for (int k = 0; k < P.cap; ++k) {
    for (int c = 0; c < P.n_pres; ++c)
      pres[c * n_slot + (long long)k * P.ncell + cell] = k < n ? r[k * kRec + kRecPres + c]
                                                              : 0.0f;
  }
}

// The cells pass. Block b covers plane i = b / bands, output rows y0 ..
// y0 + rows - 1 (a band), all nz columns; it stages the record counts of
// rows y0 - 1 .. y0 + rows (wrapped, the sources of the band's dy shifts)
// and, where they fit, their records, in ascending (cell, rank) order.
// Then one thread per cell (i, y, z):
//   stks[dx][c, i, y, z] = sum over the offsets o with that dx, in stencil
//   order, of the sum over the ranks of the source cell (i, y - dy, z - dz)
//   (wrapped), ascending, of w * V[c], with w the product fx[dx] * fy[dy]
//   * fz[dz] of the source's stored factors;
// and, unless pres is null, pres of the cell's cap slots: the record's
// results, or zeros.
__global__ void cells_kernel(Params P, Scratch S, float* __restrict__ stks,
                             float* __restrict__ pres) {
  extern __shared__ int s_dyn[];
  __shared__ float4 s_rec[kSmemRecs * kRec4];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_total;
  const int nz = P.nz;
  const int band = band_rows(P);
  const int bands = (P.ny + band - 1) / band;
  const int i = blockIdx.x / bands;
  const int y0 = (blockIdx.x % bands) * band;
  const int rows = min(band, P.ny - y0);
  const int n_halo = (rows + 2) * nz;
  const long long plane = (long long)i * P.ny * nz;
  int* s_cnt = s_dyn;
  int* s_pos = s_dyn + (band + 2) * nz;

  // stage: the halo's record counts, coalesced; then each thread a run of
  // consecutive cells, record positions by a scan of the counts (a cell's
  // records are contiguous in device memory)
#pragma unroll 4
  for (int h = threadIdx.x; h < n_halo; h += kThreads)
    s_cnt[h] = cell_count(P, S, staged_cell(P, plane, y0, h));
  __syncthreads();
  const int per = (n_halo + kThreads - 1) / kThreads;
  const int h0 = min((int)threadIdx.x * per, n_halo), h1 = min(h0 + per, n_halo);
  int n = 0;
  for (int h = h0; h < h1; ++h) n += s_cnt[h];
  int p = block_exclusive_scan(n, s_warp, &s_total);
  const bool staged = s_total <= kSmemRecs;
  const float4* rec4 = reinterpret_cast<const float4*>(S.rec);
  for (int h = h0; h < h1; ++h) {
    s_pos[h] = p;
    const int k = s_cnt[h];
    if (staged && k) {
      const float4* g = rec4 + (long long)cell_base(P, S, staged_cell(P, plane, y0, h), k)
                               * kRec4;
#pragma unroll 1
      for (int m = 0; m < k; ++m) {
#pragma unroll
        for (int q = 0; q < kRec4; ++q) s_rec[(p + m) * kRec4 + q] = __ldg(g + m * kRec4 + q);
      }
    }
    p += k;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < rows * nz; t += kThreads) {
    if (staged)
      cells_one<true>(P, plane, y0, t / nz, t % nz, s_cnt, s_pos, s_rec, S, stks, pres);
    else
      cells_one<false>(P, plane, y0, t / nz, t % nz, s_cnt, s_pos, s_rec, S, stks, pres);
  }
}

inline cudaError_t launch_cells(const Params& P, const Scratch& S, float* stks, float* pres,
                                cudaStream_t st) {
  const size_t smem = cells_smem(P);
  if (smem + sizeof(float4) * kSmemRecs * kRec4 > 46 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long n_blocks = (long long)P.nx * ((P.ny + band_rows(P) - 1) / band_rows(P));
  cells_kernel<<<(unsigned int)n_blocks, kThreads, smem, st>>>(P, S, stks, pres);
  return cudaGetLastError();
}

}  // namespace yofc

// The scratch layout of `carve` for ncell = sizes[0] and n_rec = sizes[1]:
// out gets the word offsets of cnt, base, lst, rec and the total words, so
// the Python side can check its own.
extern "C" int yofc_scratch_layout(const long long* sizes, long long* out) {
  yofc::scratch_layout(sizes[0], sizes[1], out);
  return 0;
}

// Sizes of the parameter arrays and of a record, so the Python side can
// check its layout.
extern "C" int yofc_param_counts(int* n_int, int* n_float, int* n_rec_floats) {
  *n_int = yofc::I_COUNT;
  *n_float = yofc::F_COUNT;
  *n_rec_floats = yofc::kRec;
  return yofc::kMaxOff;
}
