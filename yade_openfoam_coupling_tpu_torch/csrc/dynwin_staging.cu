// Per-plane staging loop with a data-dependent trip count, on Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel of the JAX package's prototype
// `scripts/proto_dynwin.py` (`run`, inner `kernel`): for each x-plane i of
// dat (nxl, 2, W), channel 0 the value and channel 1 the y row (-1 matches
// nothing), and a chunk count bound_i,
//
//     out[i, y, z] = sum_{w < bound_i * w_chunk} [int(dat[i,1,w]) == y]
//                    * bf16(dat[i,0,w])            for every z < nz,
//
// summed in f32, with bound_i = nch[i] (dynamic) or W / w_chunk (static).
// It is the prototype of the window kernel's per-plane dynamic trip count.
//
// What bounds it on this card: bytes, and at the window exchange's shape
// (128 planes, W = 2048, 128^2) the launch itself. The live rows are ~1 MB
// and the output 8.4 MB, a few microseconds at 3.35 TB/s; there is one add
// per live row.
//
// What the design does about it. The TPU kernel is a one-hot bf16 matmul
// per 512-row chunk because the TPU has no scatter; here it is a
// histogram. One block per plane reads its own nch[i] from device memory
// (no host copy, no synchronisation: the point of the prototype), stages
// the live rows tile by tile through shared memory (values rounded to bf16
// with round-to-nearest-even, as astype(bfloat16) does), and one thread
// per y sums its matches in row order from 0.f: deterministic, and the
// dynamic and static bounds agree bit for bit wherever the rows past the
// dynamic bound match nothing. The (ny, nz) broadcast is written with z
// fastest, so the stores coalesce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;   // rows staged through shared memory at a time

__global__ void dynwin_kernel(const float* __restrict__ dat, const int* __restrict__ nch,
                              int W, int ny, int nz, int w_chunk, int dynamic,
                              float* __restrict__ out) {
  __shared__ float s_val[kTile];
  __shared__ int s_y[kTile];
  extern __shared__ float s_sum[];   // ny per-y sums
  const int i = blockIdx.x;
  const int n_static = W / w_chunk;
  const int bound = dynamic ? min(max(nch[i], 0), n_static) : n_static;
  const int rows = bound * w_chunk;
  const float* val = dat + (long long)i * 2 * W;
  const float* yrow = val + W;

  for (int y = threadIdx.x; y < ny; y += blockDim.x) s_sum[y] = 0.f;
  for (int t0 = 0; t0 < rows; t0 += kTile) {
    const int n = min(kTile, rows - t0);
    __syncthreads();   // the previous tile is consumed
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      s_val[r] = __bfloat162float(__float2bfloat16_rn(val[t0 + r]));
      s_y[r] = (int)yrow[t0 + r];   // truncation, as astype(int32)
    }
    __syncthreads();
    for (int y = threadIdx.x; y < ny; y += blockDim.x) {
      float acc = s_sum[y];
      for (int r = 0; r < n; ++r)
        if (s_y[r] == y) acc += s_val[r];
      s_sum[y] = acc;
    }
  }
  __syncthreads();
  const int plane = ny * nz;
  float* o = out + (long long)i * plane;
  for (int k = threadIdx.x; k < plane; k += blockDim.x) o[k] = s_sum[k / nz];
}

}  // namespace

extern "C" {

// iparams (host): nxl, W, ny, nz, w_chunk, dynamic. dat (nxl, 2, W) f32,
// nch (nxl,) int32 and out (nxl, ny, nz) f32 are contiguous device
// buffers. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for parameters the kernel does not take.
int yofc_dynwin_staging(const int* iparams, const float* dat, const int* nch, float* out,
                        void* stream) {
  const int nxl = iparams[0], W = iparams[1], ny = iparams[2], nz = iparams[3];
  const int w_chunk = iparams[4], dynamic = iparams[5];
  if (nxl < 1 || W < 1 || ny < 1 || nz < 1 || w_chunk < 1 || W % w_chunk != 0 ||
      ny > 8192)
    return (int)cudaErrorInvalidValue;
  dynwin_kernel<<<nxl, kThreads, ny * sizeof(float), (cudaStream_t)stream>>>(
      dat, nch, W, ny, nz, w_chunk, dynamic, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
