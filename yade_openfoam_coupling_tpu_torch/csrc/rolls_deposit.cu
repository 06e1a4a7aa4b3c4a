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
// the wrapper can pass a view of an (S*C, row) scatter buffer whose column
// ncells is the scrap bin, without a copy.
//
// What bounds it on this card: bytes. It reads the whole buffer once and
// writes C planes: at S = 27, C = 4, 128^3 that is 906 MB read and 34 MB
// written, ~0.28 ms at 3.35 TB/s; at the point-force shape S = 8, C = 3,
// 201 MB and 25 MB, ~0.068 ms. There is one add per read.
//
// What the design does about it. The TPU kernel wrote one stack per
// (dx, dy) pair and summed them in an XLA epilogue. Here one thread owns
// kZ = 4 consecutive z outputs of one (c, x, y) row and sums each one's
// taps in offset order from 0.f, as the plain version does, so the two
// agree bit for bit: no atomics, no epilogue, one pass. To keep enough
// bytes in flight to cover the memory's latency:
//   * the tap count is a template parameter, with an instance for every
//     count the wrapper takes (1..27), so the tap loop unrolls and a thread
//     issues every tap's loads before its first add;
//   * z comes from the thread index, y from the block's second index and
//     (c, x) from its third, so no thread divides;
//   * a row is one shuffle segment where it can be: when every row starts
//     on 16 bytes (nz and the plane stride multiples of 4 floats, buffer
//     and output 16-byte aligned: the deposit pads its anchor rows to 32
//     floats) and nz / 4 is a power of 2 up to 32 (128^3: one warp a row),
//     each tap is one float4 load of the 4-block that holds most of the
//     thread's shifted elements and one to three register shuffles from
//     the neighbouring lane, rotating within the segment, which is the z
//     wrap: every byte of a plane is read once, in whole sectors, with no
//     scalar loads at the seams. Measured at 128^3 on an H100, as fast as
//     a kernel that reads the same planes unshifted.
//   * any other layout takes four scalar loads a tap, in the same kernel.
//
// Past 27 taps (the sparse exchange's `stencil_width = 5` cube has 125)
// one more kernel takes up to kMaxLoopTaps: the same thread layout, rows,
// loads and shuffles, with the taps read from a `__grid_constant__`
// parameter (uniform across a warp: one constant-cache broadcast) and
// walked in offset order in batches of kBatch, whose loads are all issued
// before their adds. Each output still sums its taps in offset order from
// 0.f, so it too agrees with the plain version bit for bit. At S = 125,
// C = 4, 128^3: 4.19 GB read, 34 MB written, ~1.26 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 27;            // template instances 1..27
constexpr int kMaxLoopTaps = 640;       // the loop kernel: int16 taps fit 4 KB of parameters
constexpr int kBatch = 8;               // the loop kernel's taps in flight
// threads a block: measured as fast as 256 at (27, 4); smaller blocks
// let an SM hold more of them at the 27-tap instance's register count
constexpr int kBlock = 128;
constexpr int kZ = 4;                    // z outputs a thread
constexpr unsigned int kMaxGridZ = 65535;

struct Taps {
  int d[kMaxTaps][3];
};

struct LongTaps {
  short d[kMaxLoopTaps][3];
};

struct Shape {
  int C, nx, ny, nz;
  int nzq;               // 4-blocks of a row: ceil(nz / kZ)
  long long plane;       // stride between (o, c) planes
};

__device__ __forceinline__ int wrap(int i, int n) {
  // |offset| < n is checked by the wrapper, so one correction suffices
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// One tap of a row segment (ROT): lane `lane` of a segment of W lanes
// (W 4-blocks, the whole row) wants row[(z0 + j - dz) mod nz], j < kZ,
// z0 = 4 * lane. With s = -dz = 4 * bs + r (0 <= r < 4) those are elements
// r.. of 4-block lane + bs, and the first r of block lane + bs + 1. A lane
// loads one float4 (block lane + bs, or lane + bs + 1 when r = 3) and the
// shuffles fetch the rest from its neighbour, rotating within the segment.
__device__ __forceinline__ float4 load_rot(const float* __restrict__ row, int lane, int W,
                                           int dz) {
  const int s = -dz;
  return __ldg(reinterpret_cast<const float4*>(row) + wrap(lane + (s >> 2) + ((s & 3) == 3), W));
}

__device__ __forceinline__ void shift_rot(float4 a, int lane, int W, int dz, float* v) {
  const unsigned int all = 0xffffffffu;
  switch ((-dz) & 3) {
    case 0: v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; break;
    case 1:
      v[0] = a.y; v[1] = a.z; v[2] = a.w;
      v[3] = __shfl_sync(all, a.x, lane + 1, W);
      break;
    case 2:
      v[0] = a.z; v[1] = a.w;
      v[2] = __shfl_sync(all, a.x, lane + 1, W);
      v[3] = __shfl_sync(all, a.y, lane + 1, W);
      break;
    default:
      v[0] = __shfl_sync(all, a.w, lane + W - 1, W);
      v[1] = a.x; v[2] = a.y; v[3] = a.z;
  }
}

// ROT: blockDim.x == nzq, a power of 2 <= 32, every row 16-byte aligned.
// Otherwise four scalar loads a tap (0 past the row's end).
template <int NT, bool ROT>
__global__ void __launch_bounds__(kBlock)
rolls_kernel(Taps taps, Shape sh, const float* __restrict__ buf, float* __restrict__ out) {
  const int lane = threadIdx.x, W = blockDim.x;
  const int zq = blockIdx.x * blockDim.x + lane;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  // the shuffles need every lane of a segment: a row past ny computes row
  // ny - 1 and stores nothing
  if (zq >= sh.nzq || (!ROT && y >= sh.ny)) return;
  const int yl = min(y, sh.ny - 1);
  const int z0 = zq * kZ;
  for (int cx = blockIdx.z; cx < sh.C * sh.nx; cx += gridDim.z) {
    const int c = cx / sh.nx, x = cx - c * sh.nx;
    float4 a[ROT ? NT : 1];
    float v[ROT ? 1 : NT][kZ];
#pragma unroll
    for (int o = 0; o < NT; ++o) {
      const int xs = wrap(x - taps.d[o][0], sh.nx), ys = wrap(yl - taps.d[o][1], sh.ny);
      const float* row = buf + ((long long)o * sh.C + c) * sh.plane
                         + ((long long)xs * sh.ny + ys) * sh.nz;
      const int dz = taps.d[o][2];
      if (ROT) {
        a[ROT ? o : 0] = load_rot(row, lane, W, dz);
      } else {
#pragma unroll
        for (int j = 0; j < kZ; ++j)
          v[ROT ? 0 : o][j] = z0 + j < sh.nz ? __ldg(row + wrap(z0 + j - dz, sh.nz)) : 0.0f;
      }
    }
    float acc[kZ] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int o = 0; o < NT; ++o) {
      float t[kZ];
      if (ROT) {
        shift_rot(a[ROT ? o : 0], lane, W, taps.d[o][2], t);
      } else {
#pragma unroll
        for (int j = 0; j < kZ; ++j) t[j] = v[ROT ? 0 : o][j];
      }
#pragma unroll
      for (int j = 0; j < kZ; ++j) acc[j] = acc[j] + t[j];
    }
    if (y >= sh.ny) continue;
    float* dst = out + ((long long)cx * sh.ny + y) * sh.nz + z0;
    if (ROT) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kZ; ++j)
        if (z0 + j < sh.nz) dst[j] = acc[j];
    }
  }
}

// The same function for 28..kMaxLoopTaps taps: the tap loop runs in
// batches of kBatch (loads of the batch, then its adds in offset order).
template <bool ROT>
__global__ void __launch_bounds__(kBlock)
rolls_loop_kernel(const __grid_constant__ LongTaps taps, int n, Shape sh,
                  const float* __restrict__ buf, float* __restrict__ out) {
  const int lane = threadIdx.x, W = blockDim.x;
  const int zq = blockIdx.x * blockDim.x + lane;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (zq >= sh.nzq || (!ROT && y >= sh.ny)) return;
  const int yl = min(y, sh.ny - 1);
  const int z0 = zq * kZ;
  for (int cx = blockIdx.z; cx < sh.C * sh.nx; cx += gridDim.z) {
    const int c = cx / sh.nx, x = cx - c * sh.nx;
    float acc[kZ] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int o0 = 0; o0 < n; o0 += kBatch) {
      float4 a[ROT ? kBatch : 1];
      float v[ROT ? 1 : kBatch][kZ];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int o = o0 + b;
        if (o >= n) break;
        const int xs = wrap(x - taps.d[o][0], sh.nx), ys = wrap(yl - taps.d[o][1], sh.ny);
        const float* row = buf + ((long long)o * sh.C + c) * sh.plane
                           + ((long long)xs * sh.ny + ys) * sh.nz;
        const int dz = taps.d[o][2];
        if (ROT) {
          a[ROT ? b : 0] = load_rot(row, lane, W, dz);
        } else {
#pragma unroll
          for (int j = 0; j < kZ; ++j)
            v[ROT ? 0 : b][j] = z0 + j < sh.nz ? __ldg(row + wrap(z0 + j - dz, sh.nz)) : 0.0f;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int o = o0 + b;
        if (o >= n) break;
        float t[kZ];
        if (ROT) {
          shift_rot(a[ROT ? b : 0], lane, W, taps.d[o][2], t);
        } else {
#pragma unroll
          for (int j = 0; j < kZ; ++j) t[j] = v[ROT ? 0 : b][j];
        }
#pragma unroll
        for (int j = 0; j < kZ; ++j) acc[j] = acc[j] + t[j];
      }
    }
    if (y >= sh.ny) continue;
    float* dst = out + ((long long)cx * sh.ny + y) * sh.nz + z0;
    if (ROT) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kZ; ++j)
        if (z0 + j < sh.nz) dst[j] = acc[j];
    }
  }
}

// The instance for n taps, found by counting down from NT.
template <int NT>
cudaError_t launch_n(int n, bool rot, const Taps& taps, const Shape& sh, const float* buf,
                     float* out, dim3 grid, dim3 block, cudaStream_t st) {
  if (n == NT) {
    if (rot)
      rolls_kernel<NT, true><<<grid, block, 0, st>>>(taps, sh, buf, out);
    else
      rolls_kernel<NT, false><<<grid, block, 0, st>>>(taps, sh, buf, out);
    return cudaGetLastError();
  }
  if constexpr (NT > 1) {
    return launch_n<NT - 1>(n, rot, taps, sh, buf, out, grid, block, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// iparams (host): S, C, nx, ny, nz, plane_stride, then S (dx, dy, dz)
// triples. buf and out are device pointers; out is (C, nx, ny, nz)
// contiguous. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for parameters the kernel does not take.
int yofc_rolls_deposit(const int* iparams, const float* buf, float* out, void* stream) {
  const int n = iparams[0];
  Shape sh;
  sh.C = iparams[1]; sh.nx = iparams[2]; sh.ny = iparams[3]; sh.nz = iparams[4];
  sh.plane = iparams[5];
  if (n < 1 || n > kMaxLoopTaps || sh.C < 1 || sh.nx < 1 || sh.ny < 1 || sh.nz < 1 ||
      sh.plane < (long long)sh.nx * sh.ny * sh.nz)
    return (int)cudaErrorInvalidValue;
  Taps taps = {};
  LongTaps long_taps = {};
  const int dims[3] = {sh.nx, sh.ny, sh.nz};
  for (int o = 0; o < n; ++o) {
    for (int a = 0; a < 3; ++a) {
      const int d = iparams[6 + 3 * o + a];
      if (d <= -dims[a] || d >= dims[a] || d < -32767 || d > 32767)
        return (int)cudaErrorInvalidValue;
      if (o < kMaxTaps) taps.d[o][a] = d;
      long_taps.d[o][a] = (short)d;
    }
  }
  sh.nzq = (sh.nz + kZ - 1) / kZ;
  unsigned int bz = 1;
  while (bz < 32 && bz < (unsigned int)sh.nzq) bz <<= 1;
  const bool rot = sh.nz % kZ == 0 && sh.plane % kZ == 0 && bz == (unsigned int)sh.nzq
                   && ((uintptr_t)buf % 16) == 0 && ((uintptr_t)out % 16) == 0;
  const dim3 block(bz, kBlock / bz);
  const long long planes = (long long)sh.C * sh.nx;
  const dim3 grid((sh.nzq + bz - 1) / bz, (sh.ny + block.y - 1) / block.y,
                  (unsigned int)(planes < kMaxGridZ ? planes : kMaxGridZ));
  if (grid.y > kMaxGridZ) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= kMaxTaps) return (int)launch_n<kMaxTaps>(n, rot, taps, sh, buf, out, grid, block, st);
  if (rot)
    rolls_loop_kernel<true><<<grid, block, 0, st>>>(long_taps, n, sh, buf, out);
  else
    rolls_loop_kernel<false><<<grid, block, 0, st>>>(long_taps, n, sh, buf, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
