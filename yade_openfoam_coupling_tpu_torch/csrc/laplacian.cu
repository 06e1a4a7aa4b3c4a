// Variable-coefficient 7-point Laplacian on Hopper (sm_90a): the pressure
// solve's matvec A(p) = div(gamma_f grad p).
//
// Replaces the TPU Pallas kernel `ops/pallas_stencil.py::_lap_kernel`
// (`laplacian_facegamma_pallas`) of the JAX package. From the ghost-padded
// p, pp (nx+2, ny+2, nz+2), and the face coefficients gx (nx+1, ny, nz),
// gy (nx, ny+1, nz), gz (nx, ny, nz+1) it writes out (nx, ny, nz):
//
//     out = sum over axes a of ( g_a[hi] * (p[hi] - p) * inv_h_a
//                              - g_a[lo] * (p - p[lo]) * inv_h_a ) * inv_h_a
//
// in the operation order of the port's plain version
// (`stencil.laplacian_facegamma_padded`: per axis diff(gamma * diff(p)/h)/h,
// summed x, y, z; PyTorch divides a CUDA tensor by a Python float as a
// product with its float reciprocal, which inv_h is).
//
// What bounds it on this card: bytes. Each cell reads 7 values of p and 6
// face coefficients and writes one value: counting each input once, about
// 42.5 MB at 128^3, ~12.7 us at 3.35 TB/s; 13 multiplies and 12 adds per
// cell are nothing beside that. On the V-cycle's coarse levels (16^3, 8^3)
// the launch itself is the cost.
//
// What the design does about it. The TPU kernel walked the x-planes in
// order with three 1-plane views of pp and a stacked (nx, 2, ny, nz) copy
// of gx that its blocking needed. Here one thread owns one interior cell,
// z fastest, so a warp reads contiguous runs of every plane it touches;
// the neighbouring reads of p hit L1/L2, and gx is read at i and i+1
// directly. A shared-memory tile of pp, which would make each p byte one
// device-memory read, is left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void laplacian_kernel(int nx, int ny, int nz, float ihx, float ihy, float ihz,
                                 const float* __restrict__ pp, const float* __restrict__ gx,
                                 const float* __restrict__ gy, const float* __restrict__ gz,
                                 float* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ncell = (long long)nx * ny * nz;
  if (t >= ncell) return;
  int k = (int)(t % nz);
  int j = (int)((t / nz) % ny);
  int i = (int)(t / ((long long)ny * nz));
  const long long sy = nz + 2, sx = (long long)(ny + 2) * (nz + 2);
  const long long c = (i + 1) * sx + (j + 1) * sy + (k + 1);
  const float p = pp[c];
  const long long ij = (long long)i * ny + j;
  // x: faces i (lo) and i+1 (hi) of gx (nx+1, ny, nz)
  float glo = (p - pp[c - sx]) * ihx;
  float ghi = (pp[c + sx] - p) * ihx;
  float ax = (gx[((long long)(i + 1) * ny + j) * nz + k] * ghi -
              gx[((long long)i * ny + j) * nz + k] * glo) * ihx;
  // y: faces j and j+1 of gy (nx, ny+1, nz)
  glo = (p - pp[c - sy]) * ihy;
  ghi = (pp[c + sy] - p) * ihy;
  const long long gyb = ((long long)i * (ny + 1) + j) * nz + k;
  float ay = (gy[gyb + nz] * ghi - gy[gyb] * glo) * ihy;
  // z: faces k and k+1 of gz (nx, ny, nz+1)
  glo = (p - pp[c - 1]) * ihz;
  ghi = (pp[c + 1] - p) * ihz;
  const long long gzb = ij * (nz + 1) + k;
  float az = (gz[gzb + 1] * ghi - gz[gzb] * glo) * ihz;
  out[t] = (ax + ay) + az;
}

}  // namespace

extern "C" {

// iparams (host): nx, ny, nz; fparams (host): 1/hx, 1/hy, 1/hz as floats.
// pp, gx, gy, gz, out are contiguous device arrays of the shapes above.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// parameters the kernel does not take.
int yofc_laplacian(const int* iparams, const float* fparams, const float* pp,
                   const float* gx, const float* gy, const float* gz, float* out,
                   void* stream) {
  int nx = iparams[0], ny = iparams[1], nz = iparams[2];
  if (nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  long long n = (long long)nx * ny * nz;
  unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  laplacian_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      nx, ny, nz, fparams[0], fparams[1], fparams[2], pp, gx, gy, gz, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
