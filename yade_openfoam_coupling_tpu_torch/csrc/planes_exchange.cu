// Planes Gaussian coupling exchange on Hopper (sm_90a): three entry points
// over a slot table D (C_d, cap, nxl*ny*nz) binned in device memory by
// torch ops, with absolute particle positions, for a whole grid (x_off 0)
// or an x-slab of nxl planes starting at global plane x_off.
//
// Replaces three TPU Pallas kernels of the JAX package's
// `ops/coupling_planes.py`:
//   * yofc_planes_fused   -> `_fused_kernel` (`fused_exchange_padded`):
//     interpolation + force laws + deposit;
//   * yofc_planes_interp  -> `_interp_kernel` (`interp_planes_padded`):
//     the normalised interpolants G (C_in, cap, ncl) and the weight norm;
//   * yofc_planes_deposit -> `_deposit_kernel` (`deposit_stacks`): the
//     deposit of a pre-normalised V (8, cap, ncl) with the raw weights.
// Every output is one stack per dx with the dy and dz shifts applied,
// stks (3, 8, nxl, ny, nz), whatever `dy_in_kernel` says.
//
// What bounds it on this card: bytes. At 128^3 with 100k particles and
// cap 4 the fused exchange must read the radius plane of D (34 MB), the
// other channels of the ~1% occupied slots and Fp (88 MB), and write pres
// (134 MB) and the stacks (201 MB). The two-kernel path adds G (C_in x
// 34 MB) and V (268 MB) round trips through device memory, which is why
// the fused exchange is the default.
//
// What the fused design does about it: work is done only where particles
// are, in three launches.
//   1. scan: each thread reads the radii of 4 cells (coalesced, the radius
//      plane read once), writes their occupancy bytes, and a block-wide
//      scan of the occupied slot counts hands each occupied slot a place
//      in a compact list (one integer atomicAdd per block on the list's
//      length; the order of blocks in the list does not change any
//      result) and its record index.
//   2. rows: a grid-stride loop over the list, one thread per occupied
//      slot, so whole warps run exchange_common.cuh's rows pass (the
//      slot's record); only the occupied slots' other channels of D are
//      read.
//   3. cells: exchange_common.cuh's cells pass (a gather through shared
//      memory, no atomics), which writes stks and pres once, coalesced.
// The interpolation (yofc_planes_interp) and the deposit
// (yofc_planes_deposit) of the two-kernel path stay one thread per slot
// and one thread per (dx stack, cell).

#include "exchange_common.cuh"

using namespace yofc;

namespace {

constexpr int kScanCells = 4;          // cells per thread in the scan
constexpr unsigned int kMaxRowBlocks = 2048;

__global__ void scan_kernel(Params P, const float* __restrict__ D, Scratch S) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_total, s_base;
  const long long n_slot = (long long)P.cap * P.ncell;
  const float* rad = D + 6 * n_slot;
  const long long c0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kScanCells;
  unsigned int bits[kScanCells];
  int n = 0;
#pragma unroll
  for (int j = 0; j < kScanCells; ++j) {
    const long long c = c0 + j;
    unsigned int b = 0;
    if (c < P.ncell) {
      for (int k = 0; k < P.cap; ++k)
        b |= (__ldg(rad + (long long)k * P.ncell + c) > 0.0f ? 1u : 0u) << k;
    }
    bits[j] = b;
    n += __popc(b);
  }
  int pos = block_exclusive_scan(n, s_warp, &s_total);
  if (threadIdx.x == 0) s_base = s_total ? atomicAdd(S.lst, s_total) : 0;
  __syncthreads();
  pos += s_base;
  unsigned char* occ = reinterpret_cast<unsigned char*>(S.occ);
#pragma unroll
  for (int j = 0; j < kScanCells; ++j) {
    const long long c = c0 + j;
    if (c >= P.ncell) break;
    unsigned int kept = 0;
    for (int k = 0; k < P.cap; ++k) {
      if (!((bits[j] >> k) & 1u)) continue;
      // a list past n_rec (a wrong bound from the caller) drops the slot
      // rather than write past the scratch
      if (pos < P.n_rec) {
        const long long s = (long long)k * P.ncell + c;
        S.lst[1 + pos] = (int)s;
        S.idx[s] = pos;
        kept |= 1u << k;
      }
      ++pos;
    }
    occ[c] = (unsigned char)kept;
  }
}

template <bool TORQUE, bool AM>
__global__ void planes_rows_kernel(Params P, const float* __restrict__ Fp,
                                   const float* __restrict__ D, Scratch S) {
  constexpr int CD = 7 + 3 * TORQUE;
  const long long n_slot = (long long)P.cap * P.ncell;
  const int n = min(*S.lst, P.n_rec);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n; j += gridDim.x * blockDim.x) {
    const long long s = __ldg(S.lst + 1 + j);
    int i, y, z;
    cell_coords(P, s % P.ncell, &i, &y, &z);
    float d[CD];
#pragma unroll
    for (int c = 0; c < CD; ++c) d[c] = __ldg(D + c * n_slot + s);
    exchange_slot<TORQUE, AM>(P, Fp, i, y, z, d, S.rec + (long long)j * kRec);
  }
}

template <bool TORQUE, bool AM>
cudaError_t launch_rows_t(const Params& P, const float* Fp, const float* D, const Scratch& S,
                          cudaStream_t st) {
  if (!counts_agree<TORQUE, AM>(P)) return cudaErrorInvalidValue;
  const unsigned int want = blocks(P.n_rec);
  const unsigned int grid = want < 1 ? 1 : (want > kMaxRowBlocks ? kMaxRowBlocks : want);
  planes_rows_kernel<TORQUE, AM><<<grid, kThreads, 0, st>>>(P, Fp, D, S);
  return cudaGetLastError();
}

cudaError_t launch_rows(const Params& P, const float* Fp, const float* D, const Scratch& S,
                        cudaStream_t st) {
  if (P.torque) {
    return P.added_mass ? launch_rows_t<true, true>(P, Fp, D, S, st)
                        : launch_rows_t<true, false>(P, Fp, D, S, st);
  }
  return P.added_mass ? launch_rows_t<false, true>(P, Fp, D, S, st)
                      : launch_rows_t<false, false>(P, Fp, D, S, st);
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

template <int CIN>
cudaError_t launch_interp_t(const Params& P, const float* Fp, const float* D,
                            float* G, float* norm, cudaStream_t st) {
  interp_kernel<CIN><<<blocks((long long)P.cap * P.ncell), kThreads, 0, st>>>(
      P, Fp, D, G, norm);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// All pointers are device pointers except iparams/fparams (host). Each
// returns the first nonzero cudaGetLastError() after a launch (or
// cudaErrorInvalidValue for parameters the kernels do not take), else 0.

// scratch holds the layout of exchange_common.cuh's `carve` for n_rec
// records, n_rec at least the number of occupied slots of D; nothing in it
// needs to be set on entry.
int yofc_planes_fused(const int* iparams, const float* fparams, const float* Fp,
                      const float* D, int* scratch, float* stks, float* pres,
                      void* stream) {
  Params P = make_params(iparams, fparams);
  if (!P.absolute || !fused_sizes_ok(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch S = carve(P, scratch);
  cudaError_t err;
  if ((err = cudaMemsetAsync(S.lst, 0, sizeof(int), st)) != cudaSuccess) return (int)err;
  scan_kernel<<<blocks(P.ncell, (long long)kThreads * kScanCells), kThreads, 0, st>>>(P, D, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_rows(P, Fp, D, S, st)) != cudaSuccess) return (int)err;
  if ((err = launch_cells(P, S, stks, pres, st)) != cudaSuccess) return (int)err;
  return 0;
}

int yofc_planes_interp(const int* iparams, const float* fparams, const float* Fp,
                       const float* D, float* G, float* norm, void* stream) {
  Params P = make_params(iparams, fparams);
  if (!P.absolute || P.n_off <= 0 || P.n_off > kMaxOff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (P.C_in) {
    case 10: err = launch_interp_t<10>(P, Fp, D, G, norm, st); break;
    case 13: err = launch_interp_t<13>(P, Fp, D, G, norm, st); break;
    case 16: err = launch_interp_t<16>(P, Fp, D, G, norm, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

int yofc_planes_deposit(const int* iparams, const float* fparams, const float* D,
                        const float* V, float* stks, void* stream) {
  Params P = make_params(iparams, fparams);
  if (!P.absolute || P.n_off <= 0 || P.n_off > kMaxOff) return (int)cudaErrorInvalidValue;
  deposit_kernel<<<blocks((long long)kStacks * P.ncell), kThreads, 0, (cudaStream_t)stream>>>(
      P, D, V, stks);
  return (int)cudaGetLastError();
}

}  // extern "C"
