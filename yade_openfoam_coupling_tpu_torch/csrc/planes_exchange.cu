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
// The fused kernel is the window kernel without its staging: launch (a) is
// exchange_common.cuh's slot_kernel (one thread per slot: factors from the
// absolute position, C_in channels gathered at the stencil offsets, force
// laws, pres and the pre-normalised V into scratch) and launch (b) its
// deposit_kernel (one thread per (dx stack, cell), a gather over the
// source slots, no atomics). Interp is launch (a)'s first half, deposit is
// launch (b). Every output is one stack per dx with the dy and dz shifts
// applied, stks (3, 8, nxl, ny, nz), whatever `dy_in_kernel` says.
//
// What bounds it on this card: bytes. At 128^3 with 100k particles and
// cap 4 the slot table is 235 MB, of which the fused path reads the radius
// plane (34 MB) for every slot and the rest only for the ~1% occupied
// ones, and writes pres (134 MB) and the stacks (201 MB). The two-kernel
// path adds G (C_in x 34 MB) and V (268 MB) round trips through device
// memory, which is why the fused kernel is the default.

#include "exchange_common.cuh"

using namespace yofc;

namespace {

template <int CIN>
cudaError_t launch_interp_t(const Params& P, const float* Fp, const float* D,
                            float* G, float* norm, cudaStream_t st) {
  interp_kernel<CIN><<<blocks((long long)P.cap * P.ncell), kThreads, 0, st>>>(
      P, Fp, D, G, norm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers except iparams/fparams (host). Each
// returns the first nonzero cudaGetLastError() after a launch (or
// cudaErrorInvalidValue for parameters the kernels do not take), else 0.

int yofc_planes_fused(const int* iparams, const float* fparams, const float* Fp,
                      const float* D, float* V, float* stks, float* pres,
                      void* stream) {
  Params P = make_params(iparams, fparams);
  if (!P.absolute) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = launch_slots(P, Fp, D, V, pres, st)) != cudaSuccess) return (int)err;
  if ((err = launch_deposit(P, D, V, stks, st)) != cudaSuccess) return (int)err;
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
  if (!P.absolute) return (int)cudaErrorInvalidValue;
  return (int)launch_deposit(P, D, V, stks, (cudaStream_t)stream);
}

}  // extern "C"
