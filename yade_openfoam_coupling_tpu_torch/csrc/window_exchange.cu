// Window-staged Gaussian coupling exchange on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `ops/coupling_window.py::_window_kernel`
// of the JAX package (with its helpers `_stage_mxu`, `_axis_factors_rel`
// and `coupling_planes._physics_planes`). Same contract as the JAX
// launcher `window_exchange_padded`: from the ghost-padded fluid stack
// Fp (C_in, nx+2, ny+2, nz+2) and the per-x-plane particle windows
// dat_win (nx, C_w, W) it writes one deposit stack per dx with the dy and
// dz shifts applied (`dy_in_kernel`), stks (3, 8, nx, ny, nz), and the
// per-slot results pres (n_pres, cap, nx*ny*nz). C_in is 10, 13 or 16
// (curl u and ddt u ride before the lagged alpha under torque and added
// mass), C_w = 2*C_d + 3 with C_d = 7, or 10 when the angular velocity is
// staged, and n_pres = 4, or 7 with the torque.
//
// What bounds it on this card: bytes. At 128^3 with 100k particles it
// reads about 88 MB of Fp and the live window rows, and writes about
// 200 MB of stacks and about 134 MB of pres; the arithmetic (19 Gaussian
// weights and a drag law per occupied slot) is small, and only ~1% of the
// cap * ncells slots are occupied in the dilute main-path configuration.
//
// What the design does about it. The TPU kernel staged each plane's window
// into slot planes with one-hot bf16 matmuls because the TPU has no
// scatter. Here nothing is staged: work is done only where particles are.
//   0. memset of the per-cell record counts (8 MB at 128^3).
//   1. rows: one thread per window row (i, w). Rows past counts[i] (read
//      on the card, no host copy), with y < 0 or with rank >= cap do
//      nothing; a live row owns slot (rank, i, y, z) and runs
//      exchange_common.cuh's rows pass from hi + lo (exact in f32) into
//      its record at index i * W + w. The window_bins layout puts the rows
//      of one cell next to each other, rank 0 first (rows sorted by cell,
//      ranks counted in sorted order, a plane's count and its window cut
//      only the top ranks of a cell), so the cell's rank-0 record is at
//      i * W + w - rank: the row writes that base and raises the cell's
//      count to rank + 1 (an integer atomicMax, which no order changes). A
//      row of radius 0 (an empty slot) writes a zero record, so a gap
//      below an occupied rank adds nothing. Whole warps run the
//      interpolation: the live rows of a plane come first.
//   2. cells: exchange_common.cuh's cells pass (a gather through shared
//      memory, no atomics), which writes stks and pres once, coalesced.
// So the only dense traffic is the outputs' single write, Fp and the
// counts plane; the records (96 B a live row) stay in L2. Any slot
// capacity works the same way.

#include "exchange_common.cuh"

using namespace yofc;

namespace {

template <bool TORQUE, bool AM>
__global__ void window_rows_kernel(Params P, const float* __restrict__ Fp,
                                   const float* __restrict__ dat_win,
                                   const int* __restrict__ counts, Scratch S) {
  constexpr int CD = 7 + 3 * TORQUE;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)P.nx * P.W) return;
  const int i = (int)(t / P.W);
  const int w = (int)(t % P.W);
  if (counts != nullptr && w >= min(max(__ldg(counts + i), 0), P.W)) return;
  const float* row = dat_win + (long long)i * P.C_w * P.W + w;
  const float y = __ldg(row + (long long)(2 * CD) * P.W);
  if (!(y >= 0.0f)) return;
  const int yi = (int)y;
  const int zi = (int)__ldg(row + (long long)(2 * CD + 1) * P.W);
  const int k = (int)__ldg(row + (long long)(2 * CD + 2) * P.W);
  // w < k: rank 0 would lie outside the plane's window, which the layout
  // never gives
  if (k < 0 || k >= P.cap || k > w || yi >= P.ny || zi < 0 || zi >= P.nz) return;
  float d[CD];
#pragma unroll
  for (int c = 0; c < CD; ++c)
    d[c] = __ldg(row + (long long)c * P.W) + __ldg(row + (long long)(CD + c) * P.W);
  float* rec = S.rec + t * kRec;
  if (!(d[6] > 0.0f)) {   // an empty slot, as in the plain version
    zero_record(rec);
    return;
  }
  const long long cell = ((long long)i * P.ny + yi) * P.nz + zi;
  exchange_slot<TORQUE, AM>(P, Fp, i, yi, zi, d, rec);
  S.base[cell] = (int)(t - k);
  atomicMax(S.cnt + cell, k + 1);
}

template <bool TORQUE, bool AM>
cudaError_t launch_rows_t(const Params& P, const float* Fp, const float* dat_win,
                          const int* counts, const Scratch& S, cudaStream_t st) {
  if (!counts_agree<TORQUE, AM>(P)) return cudaErrorInvalidValue;
  window_rows_kernel<TORQUE, AM><<<blocks((long long)P.nx * P.W), kThreads, 0, st>>>(
      P, Fp, dat_win, counts, S);
  return cudaGetLastError();
}

cudaError_t launch_rows(const Params& P, const float* Fp, const float* dat_win,
                        const int* counts, const Scratch& S, cudaStream_t st) {
  if (P.torque) {
    return P.added_mass ? launch_rows_t<true, true>(P, Fp, dat_win, counts, S, st)
                        : launch_rows_t<true, false>(P, Fp, dat_win, counts, S, st);
  }
  return P.added_mass ? launch_rows_t<false, true>(P, Fp, dat_win, counts, S, st)
                      : launch_rows_t<false, false>(P, Fp, dat_win, counts, S, st);
}

}  // namespace

extern "C" {

// All pointers are device pointers except iparams/fparams (host). counts
// may be null (every window row is read). scratch holds the layout of
// exchange_common.cuh's `carve` with n_rec = nx * W records; nothing in it
// needs to be set on entry. Returns the first nonzero cudaGetLastError()
// after a launch (or cudaErrorInvalidValue for parameters the kernels do
// not take), else 0.
int yofc_window_exchange(const int* iparams, const float* fparams,
                         const float* Fp, const float* dat_win, const int* counts,
                         int* scratch, float* stks, float* pres, void* stream) {
  Params P = make_params(iparams, fparams);
  if (P.absolute || P.C_w != 2 * P.C_d + 3 || !fused_sizes_ok(P)
      || (long long)P.n_rec != (long long)P.nx * P.W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch S = carve(P, scratch);
  cudaError_t err;
  if ((err = cudaMemsetAsync(S.cnt, 0, P.ncell * sizeof(int), st)) != cudaSuccess)
    return (int)err;
  if ((err = launch_rows(P, Fp, dat_win, counts, S, st)) != cudaSuccess) return (int)err;
  if ((err = launch_cells(P, S, stks, pres, st)) != cudaSuccess) return (int)err;
  return 0;
}

}  // extern "C"
