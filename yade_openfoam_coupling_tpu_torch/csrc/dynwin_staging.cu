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
// What bounds it on this card: bytes. At the window exchange's shape (128
// planes, W = 2048, 128^2) the live rows are ~1 MB and the output 8.4 MB,
// 2.8 us at 3.35 TB/s; there is one add per live row. So the design keeps
// every SM busy and the writes wide, and no thread walks a long serial
// chain.
//
// The design. The TPU kernel is a one-hot bf16 matmul per 512-row chunk
// because the TPU has no scatter; here it is a histogram.
// - The grid is (nxl, y_split): block (i, s) owns the y band s of plane i
//   and reads the plane's live rows itself (a plane is <= 16 KB of rows;
//   the other bands' blocks find them in L2). nch[i] is read on the device:
//   no host copy, no synchronisation (the point of the prototype).
// - Warp k of the block owns the rows [k W / 8, (k + 1) W / 8), cut at
//   bound_i * w_chunk, and takes them 32 at a time (kBatch steps' loads
//   issued together). A step whose rows all miss the band is skipped
//   (a ballot). __match_any_sync groups the lanes whose row falls on the
//   same y of the band, and each group sums its values by a butterfly of
//   shuffles over aligned lane blocks of 1, 2, 4, 8 and 16: at each level a
//   lane adds the partial sum of the first lane of its group in the
//   sibling block, so every member ends with the same sum in the same
//   tree order, in 5 levels whatever the group's size. (The window's rows
//   are sorted by cell, so a step is mostly one group: a serial sum by the
//   group's lowest lane made a first version of this kernel scan-bound.)
//   The group's lowest lane adds the sum to the warp's own histogram. No
//   other lane of the warp writes that bin in that step, and no other
//   warp writes that histogram: no atomics. The 8 histograms are then
//   summed in warp order.
// - Determinism: a row's place in the sum order depends only on its index
//   and W, never on the bound, so the dynamic and static bounds agree bit
//   for bit wherever the rows past the dynamic bound match nothing, and
//   two launches are bit-identical.
// - The band's rows of out are one contiguous run of (y1 - y0) * nz floats,
//   written with float4 stores when nz % 4 == 0 (scalar stores otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;        // 32-row steps whose loads are issued together
constexpr int kMaxBand = 1024;   // y bins a block may own (shared memory)
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
dynwin_kernel(const float* __restrict__ dat, const int* __restrict__ nch, int W, int ny,
              int nz, int w_chunk, int dynamic, int band, float* __restrict__ out) {
  extern __shared__ float hist[];                // kWarps x band
  const int i = blockIdx.x;
  const int y0 = blockIdx.y * band;
  const int y1 = min(ny, y0 + band);
  const int nb = y1 - y0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_static = W / w_chunk;
  const int bound = dynamic ? min(max(__ldg(nch + i), 0), n_static) : n_static;
  const long long rows = (long long)bound * w_chunk;
  const float* val = dat + (long long)i * 2 * W;
  const float* yrow = val + W;

  for (int b = threadIdx.x; b < kWarps * band; b += kThreads) hist[b] = 0.f;
  __syncthreads();

  float* h = hist + warp * band;
  const int r0 = (int)(((long long)warp * W) / kWarps);
  const int r1 = (int)min((long long)(warp + 1) * W / kWarps, rows);
  for (int base = r0; base < r1; base += 32 * kBatch) {   // warp-uniform
    int yy[kBatch];
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = base + 32 * u + lane;
      yy[u] = -1;
      v[u] = 0.f;
      if (r < r1) {
        yy[u] = (int)yrow[r];   // truncation, as astype(int32)
        v[u] = __bfloat162float(__float2bfloat16_rn(val[r]));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool mine = yy[u] >= y0 && yy[u] < y1;
      if (__ballot_sync(kFull, mine) == 0u) continue;   // warp-uniform
      const unsigned grp = __match_any_sync(kFull, mine ? yy[u] : -1);
      float s = v[u];
#pragma unroll
      for (int blk = 1; blk < 32; blk <<= 1) {
        const unsigned sib = grp & (((1u << blk) - 1u) << ((lane ^ blk) & ~(blk - 1)));
        const float t = __shfl_sync(kFull, s, sib ? __ffs(sib) - 1 : lane);
        if (sib) s += t;   // a + b == b + a: every member gets the same bits
      }
      if (mine && __ffs(grp) - 1 == lane) h[yy[u] - y0] += s;
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < nb; b += kThreads) {
    float s = hist[b];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += hist[w * band + b];
    hist[b] = s;
  }
  __syncthreads();

  float* o = out + ((long long)i * ny + y0) * nz;
  if ((nz & 3) == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int nz4 = nz >> 2;
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int k = threadIdx.x; k < nb * nz4; k += kThreads) {
      const float s = hist[k / nz4];
      o4[k] = make_float4(s, s, s, s);
    }
  } else {
    for (int k = threadIdx.x; k < nb * nz; k += kThreads) o[k] = hist[k / nz];
  }
}

}  // namespace

extern "C" {

// iparams (host): nxl, W, ny, nz, w_chunk, dynamic, y_split. dat (nxl, 2, W)
// f32, nch (nxl,) int32 and out (nxl, ny, nz) f32 are contiguous device
// buffers. Block (i, s) owns the y rows [s * band, (s + 1) * band), band =
// ceil(ny / y_split) (at most kMaxBand). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for parameters the kernel does not
// take.
int yofc_dynwin_staging(const int* iparams, const float* dat, const int* nch, float* out,
                        void* stream) {
  const int nxl = iparams[0], W = iparams[1], ny = iparams[2], nz = iparams[3];
  const int w_chunk = iparams[4], dynamic = iparams[5], y_split = iparams[6];
  if (nxl < 1 || W < 1 || ny < 1 || nz < 1 || w_chunk < 1 || W % w_chunk != 0 ||
      y_split < 1 || y_split > 65535)
    return (int)cudaErrorInvalidValue;
  const int band = (ny + y_split - 1) / y_split;
  if (band > kMaxBand || (long long)(y_split - 1) * band >= ny)
    return (int)cudaErrorInvalidValue;   // a block past the last band
  const size_t smem = (size_t)kWarps * band * sizeof(float);
  dynwin_kernel<<<dim3(nxl, y_split), kThreads, smem, (cudaStream_t)stream>>>(
      dat, nch, W, ny, nz, w_chunk, dynamic, band, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
