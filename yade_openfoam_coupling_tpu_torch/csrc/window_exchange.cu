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
//   1. stage:   one thread per window row -> slot table D (C_d, cap, nx,
//               ny, nz) (zeroed by the caller); rows past counts[i], with
//               y < 0 or with rank >= cap do nothing.
//   2. slots:   exchange_common.cuh's slot_kernel (interpolation, force
//               laws, pres and the pre-normalised deposit values V).
//   3. deposit: exchange_common.cuh's deposit_kernel (a gather, no atomics).
// Every empty slot is rejected after reading its radius, so the traffic
// that remains is the slot-table zeroing, the radius planes and the
// outputs. Shared-memory tiling, fusing the launches and TMA are left to
// later work.

#include "exchange_common.cuh"

using namespace yofc;

namespace {

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
  const int C_d = P.C_d;
  const float* row = dat_win + (long long)i * P.C_w * P.W + w;
  float y = row[(long long)(2 * C_d) * P.W];
  if (!(y >= 0.0f)) return;
  int yi = (int)y;
  int zi = (int)row[(long long)(2 * C_d + 1) * P.W];
  int k = (int)row[(long long)(2 * C_d + 2) * P.W];
  if (k < 0 || k >= P.cap || yi >= P.ny || zi < 0 || zi >= P.nz) return;
  long long cell = ((long long)i * P.ny + yi) * P.nz + zi;
  for (int c = 0; c < C_d; ++c) {
    D[((long long)c * P.cap + k) * P.ncell + cell] =
        row[(long long)c * P.W] + row[(long long)(C_d + c) * P.W];
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers except iparams/fparams (host). counts
// may be null (every window row is read). D must be zero on entry. Returns
// the first nonzero cudaGetLastError() after a launch (or
// cudaErrorInvalidValue for parameters the kernels do not take), else 0.
int yofc_window_exchange(const int* iparams, const float* fparams,
                         const float* Fp, const float* dat_win, const int* counts,
                         float* D, float* V, float* stks, float* pres,
                         void* stream) {
  Params P = make_params(iparams, fparams);
  if (P.absolute || P.C_w != 2 * P.C_d + 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  stage_kernel<<<blocks((long long)P.nx * P.W), kThreads, 0, st>>>(P, dat_win, counts, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_slots(P, Fp, D, V, pres, st)) != cudaSuccess) return (int)err;
  if ((err = launch_deposit(P, D, V, stks, st)) != cudaSuccess) return (int)err;
  return 0;
}

}  // extern "C"
