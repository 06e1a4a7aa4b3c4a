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
// product with the reciprocal taken in double and rounded to float, which
// inv_h is).
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
//
// The bfloat16 entry (`yofc_laplacian_bf16`) is the same matvec for the
// V-cycle under `MGConfig.bf16`, where the JAX kernel runs on bf16 pp and
// face coefficients and returns bf16 (its out_shape takes pp.dtype). It
// reads and writes bf16 and computes what the plain version computes on
// bf16 tensors, in the same order: PyTorch evaluates each bf16 operation
// in float and rounds its result to bf16 (round to nearest even), so the
// kernel rounds at the same places, and only there:
//   * each face difference (p[hi] - p[lo]);
//   * each face gradient (difference * inv_h);
//   * each face flux (gamma * gradient);
//   * each axis' flux difference, and that times inv_h;
//   * the sum of the x and y terms, and that plus the z term.
// Between those points there is one float operation on values that are
// exactly representable, so kernel and plain version agree bit for bit.
// Half the bytes of the float32 matvec: ~21 MB at 128^3, ~6.4 us at
// 3.35 TB/s.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float ld(const __nv_bfloat16* a, long long i) {
  return __bfloat162float(a[i]);
}

// round a float to bf16 and back: where the plain version rounds
__device__ __forceinline__ float bq(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void laplacian_bf16_kernel(int nx, int ny, int nz, float ihx, float ihy, float ihz,
                                      const __nv_bfloat16* __restrict__ pp,
                                      const __nv_bfloat16* __restrict__ gx,
                                      const __nv_bfloat16* __restrict__ gy,
                                      const __nv_bfloat16* __restrict__ gz,
                                      __nv_bfloat16* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ncell = (long long)nx * ny * nz;
  if (t >= ncell) return;
  int k = (int)(t % nz);
  int j = (int)((t / nz) % ny);
  int i = (int)(t / ((long long)ny * nz));
  const long long sy = nz + 2, sx = (long long)(ny + 2) * (nz + 2);
  const long long c = (i + 1) * sx + (j + 1) * sy + (k + 1);
  const float p = ld(pp, c);
  const long long ij = (long long)i * ny + j;
  // x
  float glo = bq(bq(p - ld(pp, c - sx)) * ihx);
  float ghi = bq(bq(ld(pp, c + sx) - p) * ihx);
  float ax = bq(bq(bq(ld(gx, ((long long)(i + 1) * ny + j) * nz + k) * ghi) -
                   bq(ld(gx, ((long long)i * ny + j) * nz + k) * glo)) * ihx);
  // y
  glo = bq(bq(p - ld(pp, c - sy)) * ihy);
  ghi = bq(bq(ld(pp, c + sy) - p) * ihy);
  const long long gyb = ((long long)i * (ny + 1) + j) * nz + k;
  float ay = bq(bq(bq(ld(gy, gyb + nz) * ghi) - bq(ld(gy, gyb) * glo)) * ihy);
  // z
  glo = bq(bq(p - ld(pp, c - 1)) * ihz);
  ghi = bq(bq(ld(pp, c + 1) - p) * ihz);
  const long long gzb = ij * (nz + 1) + k;
  float az = bq(bq(bq(ld(gz, gzb + 1) * ghi) - bq(ld(gz, gzb) * glo)) * ihz);
  out[t] = __float2bfloat16_rn(bq(ax + ay) + az);
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

// The same for bf16 pp, gx, gy, gz and out.
int yofc_laplacian_bf16(const int* iparams, const float* fparams, const void* pp,
                        const void* gx, const void* gy, const void* gz, void* out,
                        void* stream) {
  int nx = iparams[0], ny = iparams[1], nz = iparams[2];
  if (nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  long long n = (long long)nx * ny * nz;
  unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  laplacian_bf16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      nx, ny, nz, fparams[0], fparams[1], fparams[2], (const __nv_bfloat16*)pp,
      (const __nv_bfloat16*)gx, (const __nv_bfloat16*)gy, (const __nv_bfloat16*)gz,
      (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
