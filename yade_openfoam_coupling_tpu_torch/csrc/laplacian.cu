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
//   * 0 + the x term, that plus the y term, and that plus the z term.
// Between those points there is one float operation on values that are
// exactly representable, so kernel and plain version agree bit for bit.
// (A bf16x2 product gamma * gradient is left out: where the float product
// is subnormal, the float rounding then the bf16 one could differ from
// its single rounding.)
//
// What bounds it: half the bytes of the float32 matvec, ~21.3 MB at 128^3,
// 6.35 us at 3.35 TB/s. In the float32 kernel's one-thread-per-cell form
// it ran at 22% of that (29.4 us on an H100) and was bound by
// instructions: 477 a cell (SASS), of which three calls into a 64-bit
// division routine, 26 roundings in integer code, and 13 separate 2-byte
// loads; removing the divisions, the roundings or both left 24-25 us
// (`scripts/laplacian_diagnose.py`). So here:
//   * a grid of (z pairs, y rows) tiles with a third axis of x slabs (its
//     geometry computed on the host, `fused_stencil.bf16_geometry`): no
//     integer division; each thread owns two z-neighbouring cells of a row
//     and marches along x through its slab;
//   * two cells' values share a 32-bit word throughout: p's differences
//     and the sums are bf16x2 subtractions and additions, which round both
//     cells' results in one instruction and equal the float operation then
//     the rounding (see sub2); a product with 1/h or gamma (1/h is no bf16
//     value) is a float product, and one cvt.rn.bf16x2.f32 rounds both
//     or, with a zero for the low half, rounds one to a float in place;
//   * the x face flux at i+1 is the one at i of the next plane, and the z
//     faces k, k+1, k+2 of a pair come from two subtractions;
//   * where nz is even and every array is 4-byte aligned, 32-bit loads:
//     the row of p around the pair (cells k-1..k+2) in two words, gx, gy
//     and out in one each; gz's rows (nz+1 long) alternate in parity, so
//     its three faces come as one aligned word and one 2-byte load. p's
//     neighbour rows are other threads' centre rows, read again from L1.
//     Odd nz or a misaligned array takes 2-byte loads and stores.

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

// A pair of bf16 values lives in one 32-bit word, the first in the low
// half. bf16 bits -> float:
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// two floats rounded to bf16 (round to nearest even) in one instruction
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// one float rounded to bf16 and back, in one instruction: the rounded
// value in the high half over a zero low half is that value as a float
__device__ __forceinline__ float bq(float v) { return __uint_as_float(pack2(0.0f, v)); }

// a - b and a + b on bf16 pairs, each rounded once to nearest even. For
// two bf16 operands this is what the float operation then the rounding
// gives: the exact result fits in float's 24 bits when their exponents
// differ by 16 or less, and otherwise differs from the larger operand by
// less than 2^-16 of it, far from the nearest bf16 rounding midpoint (2^-9
// of it away), so both round to that operand.
__device__ __forceinline__ unsigned sub2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// (high half of a, low half of b): the pair that straddles two words
__device__ __forceinline__ unsigned mid2(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5432);
}
// (low half of a, low half of b)
__device__ __forceinline__ unsigned lows2(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5410);
}

__device__ __forceinline__ unsigned ld16(const unsigned short* a, int i) {
  return __ldg(a + i);
}
__device__ __forceinline__ unsigned ld32(const unsigned short* a, int i) {
  return __ldg(reinterpret_cast<const unsigned*>(a + i));
}

// elements i and i+1 of an array as a pair (i even where kVec; element i
// twice where `two` is false: cell k+1 lies past the row)
template <bool kVec>
__device__ __forceinline__ unsigned ld_pair(const unsigned short* a, int i, bool two) {
  if (kVec) return ld32(a, i);
  return lows2(ld16(a, i), ld16(a, i + (two ? 1 : 0)));
}

// p at cells k, k+1 of the row whose window (cells k-1..k+2) starts at
// element q (both in the row: cell nz is the row's last ghost)
template <bool kVec>
__device__ __forceinline__ unsigned ld_p_mid(const unsigned short* pp, int q) {
  if (kVec) return mid2(ld32(pp, q), ld32(pp, q + 2));
  return lows2(ld16(pp, q + 1), ld16(pp, q + 2));
}

// x * s for both halves of a bf16 pair x, rounded: the plain version's
// product of a bf16 tensor with the float 1/h
__device__ __forceinline__ unsigned scale2(unsigned x, float s) {
  return pack2(bf_lo(x) * s, bf_hi(x) * s);
}

// gamma * (d * inv_h) for a face pair: the gradient rounded, then the flux
__device__ __forceinline__ unsigned flux2(unsigned d, float inv_h, float g_lo, float g_hi) {
  return pack2(g_lo * bq(bf_lo(d) * inv_h), g_hi * bq(bf_hi(d) * inv_h));
}

// One thread per pair of z-neighbouring cells (k, k+1) of row j, for the
// planes i0 <= i < i0 + slab: a 2D grid of (z, y) tiles, blockIdx.z the x
// slab. p stays in bf16 pairs (its differences are bf16x2 subtractions);
// a product with 1/h or gamma is a float product rounded by one packed
// conversion. The march is unrolled twice, so two planes' loads are in
// flight together, within the 40 registers that let 6 blocks share an SM.
// kVec: nz even and every array 4-byte aligned (32-bit loads and stores);
// otherwise 2-byte ones, and cell k+1 may lie past the row (then its loads
// are clamped into the row and it is not stored).
template <bool kVec>
__global__ void __launch_bounds__(256, 6) laplacian_bf16_kernel(
    int nx, int ny, int nz, int slab, float ihx, float ihy, float ihz,
    const unsigned short* __restrict__ pp, const unsigned short* __restrict__ gx,
    const unsigned short* __restrict__ gy, const unsigned short* __restrict__ gz,
    unsigned short* __restrict__ out) {
  const int k = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i0 = blockIdx.z * slab;
  if (k >= nz || j >= ny || i0 >= nx) return;
  const int i1 = min(nx, i0 + slab);
  const bool two = kVec || k + 1 < nz;
  // element strides of a row and a plane of pp, and of a plane of each face
  // array and of out (the host keeps every array below 2^31 elements)
  const int sy = nz + 2, sx = (ny + 2) * sy;
  const int gxs = ny * nz, gys = (ny + 1) * nz, gzs = ny * (nz + 1);
  int q = (i0 + 1) * sx + (j + 1) * sy + k;  // pp: cell (i, j, k-1)
  int o = i0 * gxs + j * nz + k;             // out (i, j, k); gx face i
  int oy = i0 * gys + j * nz + k;            // gy face (i, j, k)
  int oz = (i0 * ny + j) * (nz + 1) + k;     // gz face (i, j, k)

  // p of plane i, row j: cells (k-1, k) and (k+1, k+2)
  unsigned c0 = ld_pair<kVec>(pp, q, true);
  unsigned c1 = ld_pair<kVec>(pp, q + 2, two);
  // the x flux through face i
  unsigned fl;
  {
    const unsigned g = ld_pair<kVec>(gx, o, two);
    fl = flux2(sub2(mid2(c0, c1), ld_p_mid<kVec>(pp, q - sx)), ihx, bf_lo(g), bf_hi(g));
  }
  const unsigned zero = 0u;
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const unsigned n0 = ld_pair<kVec>(pp, q + sx, true);
    const unsigned n1 = ld_pair<kVec>(pp, q + sx + 2, two);
    const unsigned yl = ld_p_mid<kVec>(pp, q - sy), yh = ld_p_mid<kVec>(pp, q + sy);
    const unsigned wx = ld_pair<kVec>(gx, o + gxs, two);
    const unsigned wyl = ld_pair<kVec>(gy, oy, two), wyh = ld_pair<kVec>(gy, oy + nz, two);
    unsigned wz01;
    float gz2;
    if (kVec) {
      // gz rows are nz+1 long: faces k..k+2 from one aligned word and one
      // 2-byte load, whichever the row's parity
      const bool odd = oz & 1;
      const unsigned w = ld32(gz, (oz + 1) & ~1);
      const unsigned e = ld16(gz, odd ? oz : oz + 2);
      wz01 = odd ? lows2(e, w) : w;
      gz2 = odd ? bf_hi(w) : bf_lo(e);
    } else {
      wz01 = lows2(ld16(gz, oz), ld16(gz, oz + 1));
      gz2 = bf_lo(ld16(gz, oz + (two ? 2 : 1)));
    }
    const unsigned cm = mid2(c0, c1);  // cells k, k+1
    // x: the flux through face i+1, less the one through face i
    const unsigned fh = flux2(sub2(mid2(n0, n1), cm), ihx, bf_lo(wx), bf_hi(wx));
    const unsigned ax = scale2(sub2(fh, fl), ihx);
    fl = fh;
    // y: faces j+1 (hi) and j (lo)
    const unsigned fyh = flux2(sub2(yh, cm), ihy, bf_lo(wyh), bf_hi(wyh));
    const unsigned fyl = flux2(sub2(cm, yl), ihy, bf_lo(wyl), bf_hi(wyl));
    const unsigned ay = scale2(sub2(fyh, fyl), ihy);
    // z: faces k, k+1 (shared by the pair) and k+2
    const unsigned d01 = sub2(cm, c0);  // faces k, k+1
    const unsigned d12 = sub2(c1, cm);  // faces k+1, k+2
    const float fz0 = bf_lo(wz01) * bq(bf_lo(d01) * ihz);
    const float fz1 = bf_hi(wz01) * bq(bf_hi(d01) * ihz);
    const float fz2 = gz2 * bq(bf_hi(d12) * ihz);
    const unsigned az = scale2(sub2(pack2(fz1, fz2), pack2(fz0, fz1)), ihz);
    // ((0 + x) + y) + z, as the plain version sums (0 + x is exact but for
    // the sign of a zero)
    const unsigned r = add2(add2(add2(zero, ax), ay), az);
    if (kVec) {
      *reinterpret_cast<unsigned*>(out + o) = r;
    } else {
      out[o] = (unsigned short)(r & 0xffffu);
      if (two) out[o + 1] = (unsigned short)(r >> 16);
    }
    c0 = n0;
    c1 = n1;
    q += sx;
    o += gxs;
    oy += gys;
    oz += gzs;
  }
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

// The same for bf16 pp, gx, gy, gz and out, with the launch geometry in
// iparams[3..8] (`fused_stencil._bf16_params`): threads a block along z
// (each two cells) and along y, blocks along z and y, the number of x slabs
// and the planes a slab.
int yofc_laplacian_bf16(const int* iparams, const float* fparams, const void* pp,
                        const void* gx, const void* gy, const void* gz, void* out,
                        void* stream) {
  const int nx = iparams[0], ny = iparams[1], nz = iparams[2];
  const int tz = iparams[3], ty = iparams[4], bz = iparams[5], by = iparams[6];
  const int n_slab = iparams[7], slab = iparams[8];
  if (nx < 1 || ny < 1 || nz < 1 || tz < 1 || ty < 1 || tz * ty > 256 || bz < 1 || by < 1 ||
      n_slab < 1 || slab < 1 || by > 65535 || n_slab > 65535 || 2LL * tz * bz < nz ||
      (long long)ty * by < ny ||
      (long long)slab * n_slab < nx || (long long)(nx + 2) * (ny + 2) * (nz + 2) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool vec = nz % 2 == 0 &&
      (((unsigned long long)pp | (unsigned long long)gx | (unsigned long long)gy |
        (unsigned long long)gz | (unsigned long long)out) & 3) == 0;
  const dim3 grid(bz, by, n_slab), block(tz, ty);
  if (vec)
    laplacian_bf16_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        nx, ny, nz, slab, fparams[0], fparams[1], fparams[2], (const unsigned short*)pp,
        (const unsigned short*)gx, (const unsigned short*)gy, (const unsigned short*)gz,
        (unsigned short*)out);
  else
    laplacian_bf16_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        nx, ny, nz, slab, fparams[0], fparams[1], fparams[2], (const unsigned short*)pp,
        (const unsigned short*)gx, (const unsigned short*)gy, (const unsigned short*)gz,
        (unsigned short*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
