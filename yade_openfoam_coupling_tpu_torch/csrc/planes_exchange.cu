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
//      plane read once) and finds each cell's extent, its highest occupied
//      rank + 1; a block-wide scan of the extents hands each cell a run of
//      places in a compact list of slots, ranks 0..extent-1 in order (one
//      integer atomicAdd per block on the list's length; the order of
//      blocks in the list does not change any result). The cell's count
//      and the place of its rank 0 say where its records are. Binned
//      tables fill ranks from 0, so the list holds the occupied slots; an
//      empty slot below an occupied rank gets a zero record.
//   2. rows: a grid-stride loop over the list, one thread per listed
//      slot, so whole warps run exchange_common.cuh's rows pass (the
//      slot's record); only the listed slots' other channels of D are
//      read.
//   3. cells: exchange_common.cuh's cells pass (a gather through shared
//      memory, no atomics), which writes stks and pres once, coalesced.
// The deposit of the two-kernel path (yofc_planes_deposit) runs the same
// scan, a records pass that stores each listed slot's factors and its 8
// values of V, and the cells pass without pres: the 201 MB of stacks are
// written once and V is read only where slots are occupied. The
// interpolation (yofc_planes_interp) stays one thread per slot.

#include "exchange_common.cuh"

using namespace yofc;

namespace {

constexpr int kScanCells = 4;          // cells per thread in the scan
constexpr unsigned int kMaxRowBlocks = 2048;

// Blocks of a grid-stride loop over the list of slots.
inline unsigned int list_blocks(const Params& P) {
  const unsigned int want = blocks(P.n_rec);
  return want < 1 ? 1 : (want > kMaxRowBlocks ? kMaxRowBlocks : want);
}

__global__ void scan_kernel(Params P, const float* __restrict__ D, Scratch S) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_total, s_base;
  const long long n_slot = (long long)P.cap * P.ncell;
  const float* rad = D + 6 * n_slot;
  const long long c0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kScanCells;
  int ext[kScanCells];
  int n = 0;
#pragma unroll
  for (int j = 0; j < kScanCells; ++j) {
    const long long c = c0 + j;
    int e = 0;
    if (c < P.ncell) {
      for (int k = 0; k < P.cap; ++k)
        if (__ldg(rad + (long long)k * P.ncell + c) > 0.0f) e = k + 1;
    }
    ext[j] = e;
    n += e;
  }
  int pos = block_exclusive_scan(n, s_warp, &s_total);
  if (threadIdx.x == 0) s_base = s_total ? atomicAdd(S.lst, s_total) : 0;
  __syncthreads();
  pos += s_base;
#pragma unroll
  for (int j = 0; j < kScanCells; ++j) {
    const long long c = c0 + j;
    if (c >= P.ncell) break;
    // a list past n_rec (a wrong bound from the caller) keeps the ranks
    // that fit rather than write past the scratch
    const int kept = max(0, min(ext[j], P.n_rec - pos));
    for (int k = 0; k < kept; ++k) S.lst[1 + pos + k] = (int)((long long)k * P.ncell + c);
    S.cnt[c] = kept;
    if (kept) S.base[c] = pos;
    pos += ext[j];
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
    float* rec = S.rec + (long long)j * kRec;
    if (d[6] > 0.0f)
      exchange_slot<TORQUE, AM>(P, Fp, i, y, z, d, rec);
    else
      zero_record(rec);
  }
}

template <bool TORQUE, bool AM>
cudaError_t launch_rows_t(const Params& P, const float* Fp, const float* D, const Scratch& S,
                          cudaStream_t st) {
  if (!counts_agree<TORQUE, AM>(P)) return cudaErrorInvalidValue;
  planes_rows_kernel<TORQUE, AM><<<list_blocks(P), kThreads, 0, st>>>(P, Fp, D, S);
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

// The deposit's records pass: a grid-stride loop over the scan's list, one
// thread per listed slot: the slot's 8 pre-normalised values V[c, slot]
// and its 9 separable factors (the raw Gaussian of its own position, with
// the wall masks) into its record, for the cells pass to gather; an empty
// slot below an occupied rank gets a zero record.
__global__ void deposit_records_kernel(Params P, const float* __restrict__ D,
                                       const float* __restrict__ V, Scratch S) {
  const long long n_slot = (long long)P.cap * P.ncell;
  const int n = min(*S.lst, P.n_rec);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n; j += gridDim.x * blockDim.x) {
    const long long s = __ldg(S.lst + 1 + j);
    float* rec = S.rec + (long long)j * kRec;
    if (!(__ldg(D + 6 * n_slot + s) > 0.0f)) {
      zero_record(rec);
      continue;
    }
    int i, y, z;
    cell_coords(P, s % P.ncell, &i, &y, &z);
    float fx[3], fy[3], fz[3];
    factors(P, __ldg(D + s), __ldg(D + n_slot + s), __ldg(D + 2 * n_slot + s), i + P.x_off, y,
            z, fx, fy, fz);
    float4* r4 = reinterpret_cast<float4*>(rec);
    r4[0] = make_float4(__ldg(V + s), __ldg(V + n_slot + s), __ldg(V + 2 * n_slot + s),
                        __ldg(V + 3 * n_slot + s));
    r4[1] = make_float4(__ldg(V + 4 * n_slot + s), __ldg(V + 5 * n_slot + s),
                        __ldg(V + 6 * n_slot + s), __ldg(V + 7 * n_slot + s));
    r4[2] = make_float4(fx[0], fx[1], fx[2], fy[0]);
    r4[3] = make_float4(fy[1], fy[2], fz[0], fz[1]);
    r4[4] = make_float4(fz[2], 0.0f, 0.0f, 0.0f);
  }
}

// The scan of the fused exchange and the deposit: the list's length set to
// 0, then scan_kernel.
cudaError_t launch_scan(const Params& P, const float* D, const Scratch& S, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(S.lst, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  scan_kernel<<<blocks(P.ncell, (long long)kThreads * kScanCells), kThreads, 0, st>>>(P, D, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers except iparams/fparams (host). Each
// returns the first nonzero cudaGetLastError() after a launch (or
// cudaErrorInvalidValue for parameters the kernels do not take), else 0.

// scratch holds the layout of exchange_common.cuh's `carve` for n_rec
// records, n_rec at least the number of listed slots of D (its occupied
// slots when ranks fill from 0, as binning gives); nothing in it needs to
// be set on entry.
int yofc_planes_fused(const int* iparams, const float* fparams, const float* Fp,
                      const float* D, int* scratch, float* stks, float* pres,
                      void* stream) {
  Params P = make_params(iparams, fparams);
  if (!P.absolute || !fused_sizes_ok(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch S = carve(P, scratch);
  cudaError_t err;
  if ((err = launch_scan(P, D, S, st)) != cudaSuccess) return (int)err;
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

// scratch as for yofc_planes_fused; V is (8, cap, ncell) pre-normalised.
int yofc_planes_deposit(const int* iparams, const float* fparams, const float* D,
                        const float* V, int* scratch, float* stks, void* stream) {
  Params P = make_params(iparams, fparams);
  if (!P.absolute || !fused_sizes_ok(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch S = carve(P, scratch);
  cudaError_t err;
  if ((err = launch_scan(P, D, S, st)) != cudaSuccess) return (int)err;
  deposit_records_kernel<<<list_blocks(P), kThreads, 0, st>>>(P, D, V, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_cells(P, S, stks, nullptr, st);
}

}  // extern "C"
