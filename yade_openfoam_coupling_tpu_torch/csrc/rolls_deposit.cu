// Roll distribution of the sparse exchange's anchor deposits on Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel `ops/pallas_rolls.py::_roll_kernel`
// (`distribute_rolls_pallas`) of the JAX package:
//
//     out[c, x, y, z] = sum_o bufT[o, c, (x - dx_o) mod nx, (y - dy_o) mod ny,
//                                  (z - dz_o) mod nz]
//
// i.e. out[c] = sum_o roll(bufT[o, c], offsets[o]) with roll(a, s)[i] =
// a[i - s], every axis wrapped (on wall axes the anchor buffer holds zeros
// where a wrap would land, so the wrap deposits nothing there). bufT is the
// offset-major anchor buffer (S, C, nx, ny, nz): planes of nx*ny*nz
// contiguous floats, plane (o, c) starting at (o*C + c) * plane_stride, so
// the wrapper can pass a view of an (S*C, ncells + 1) scatter buffer whose
// last column is the scrap bin, without a copy.
//
// What bounds it on this card: bytes. It reads the whole buffer once and
// writes C planes: at S = 27, C = 4, 128^3 that is 906 MB read and 34 MB
// written, ~0.28 ms at 3.35 TB/s; there is one add per read.
//
// What the design does about it. The TPU kernel wrote one stack per
// (dx, dy) pair and summed them in an XLA epilogue, because its shifts
// along x and y were cheapest outside the kernel. Here one thread owns one
// output element (z fastest, so neighbouring threads read neighbouring
// addresses of every tap plane) and sums its S taps in offset order from
// 0.f: no atomics, no epilogue, one pass. The sum order is the plain
// version's, so the two agree bit for bit. Tiling the taps through shared
// memory is left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 27;
constexpr int kThreads = 256;

struct Taps {
  int n;
  int d[kMaxTaps][3];
};

__device__ __forceinline__ int wrap(int i, int n) {
  // |offset| < n is checked by the wrapper, so one correction suffices
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__global__ void rolls_kernel(Taps taps, int C, int nx, int ny, int nz,
                             long long plane_stride, const float* __restrict__ buf,
                             float* __restrict__ out) {
  const long long ncell = (long long)nx * ny * nz;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)C * ncell) return;
  int c = (int)(t / ncell);
  long long cell = t - (long long)c * ncell;
  int z = (int)(cell % nz);
  int y = (int)((cell / nz) % ny);
  int x = (int)(cell / ((long long)ny * nz));
  float acc = 0.f;
  for (int o = 0; o < taps.n; ++o) {
    int xs = wrap(x - taps.d[o][0], nx);
    int ys = wrap(y - taps.d[o][1], ny);
    int zs = wrap(z - taps.d[o][2], nz);
    acc += buf[((long long)o * C + c) * plane_stride + ((long long)xs * ny + ys) * nz + zs];
  }
  out[t] = acc;
}

}  // namespace

extern "C" {

// iparams (host): S, C, nx, ny, nz, plane_stride, then S (dx, dy, dz)
// triples. buf and out are device pointers; out is (C, nx, ny, nz)
// contiguous. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for parameters the kernel does not take.
int yofc_rolls_deposit(const int* iparams, const float* buf, float* out, void* stream) {
  Taps taps;
  taps.n = iparams[0];
  int C = iparams[1], nx = iparams[2], ny = iparams[3], nz = iparams[4];
  long long plane_stride = iparams[5];
  if (taps.n < 1 || taps.n > kMaxTaps || C < 1 || nx < 1 || ny < 1 || nz < 1 ||
      plane_stride < (long long)nx * ny * nz)
    return (int)cudaErrorInvalidValue;
  const int dims[3] = {nx, ny, nz};
  for (int o = 0; o < taps.n; ++o) {
    for (int a = 0; a < 3; ++a) {
      int d = iparams[6 + 3 * o + a];
      if (d <= -dims[a] || d >= dims[a]) return (int)cudaErrorInvalidValue;
      taps.d[o][a] = d;
    }
  }
  long long n = (long long)C * nx * ny * nz;
  unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  rolls_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(taps, C, nx, ny, nz,
                                                              plane_stride, buf, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
