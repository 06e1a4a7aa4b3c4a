// The float32 damped-Jacobi V-cycle of the pressure solve's multigrid
// preconditioner (`ops/pressure.py::make_mg_preconditioner`) on Hopper
// (sm_90a), as three kernels launched by `ops/mg_fused.py`.
//
// Replaces no TPU kernel: the JAX package runs its V-cycle as XLA ops (B2,
// `ops/pallas_stencil.py::_lap_kernel`, for each matvec under
// use_pallas). In plain PyTorch one sweep is a ghost padding (three
// torch.cat copies), a matvec of ~15 elementwise ops on strided views and
// the update's 2-3 ops: ~20-25 launches, each reading or writing a whole
// level. These kernels do a sweep in one launch that reads each input once.
//
//   * `yofc_mg_jacobi`: x_out = x' + omega * D^-1 * (b - A x'), x' = x +
//     prolong(ec), out of place. x null is zero; ec null is no correction.
//     With neither (the first pre-smoothing sweep) b - A 0 = b exactly under
//     homogeneous BCs, so the sweep reads neither x nor a neighbour. ec is
//     the coarse level's correction, read piecewise constant at each cell
//     and each neighbour: the first post-smoothing sweep adds the
//     prolongation on the fly, and x + prolong(ec) is never stored.
//   * `yofc_mg_residual_restrict`: r_c = restrict(b - A x), the mean of each
//     2x2x2 block of the fine residual; only the 1/8-size r_c is written.
//   * `yofc_mg_coarse`: the coarsest level's `sweeps` sweeps from zero (the
//     pre-smoothing and coarse_iters ones) in one launch of one block, x in
//     shared memory (at most kMaxCoarseCells cells: 4^3 = 64 at 256^3).
//
// Ghosts are read by index from the level's BC kinds, as `grid.pad_axis`
// fills them under homogeneous BCs: periodic wraps to the far edge,
// zero-gradient (and a scalar's slip) repeats the cell, Dirichlet gives
// 0 - cell (2 * 0 - cell). D^-1 is formed in registers from the six face
// coefficients, as `pressure.poisson_diag` builds it (a boundary face's
// coefficient times 0 where zero-gradient, 2 where Dirichlet, 1 otherwise)
// with its |d| < 1e-30 -> -1 guard. The arithmetic follows the plain
// version's order: per axis (g_hi * ((p_hi - p) * inv_h) - g_lo * ((p -
// p_lo) * inv_h)) * inv_h, summed ((0 + x) + y) + z; PyTorch divides a
// CUDA tensor by a Python float as a product with the reciprocal taken in
// double and rounded to float, which inv_h and inv_h2 are
// (`mg_fused._params`). Built with -fmad=false, so no product is
// contracted into an add: a sweep equals its plain version on the card bit
// for bit, and the restriction to the rounding of its 8-cell sum's order.
//
// What bounds them on this card: bytes. At 256^3 (16.8M cells, 67.1 MB a
// float32 field, the face arrays a plane more):
//   * a sweep reads x, b and the three face arrays once and writes x_out:
//     6 fields, 403 MB, 0.120 ms at 3.35 TB/s (with ec: +8.4 MB, 0.123 ms;
//     the first, reading neither x nor ec: 5 fields, 336 MB, 0.100 ms);
//   * residual-restrict reads x, b and the face arrays and writes r_c:
//     5 fields + 1/8, 344 MB, 0.103 ms;
//   * the coarse level (64 cells) is a launch and a few microseconds of one
//     block's sweeps.
// A V-cycle with 4 + 4 sweeps is ~9 such passes at 256^3 plus 1/7 for the
// coarser levels: ~1.2 ms. The operations (~40 a cell a sweep, one
// division) are far below the float32 rate.
//
// What the design does about it. One thread per cell, z fastest, in
// (z, y) tiles of one x plane (blockIdx.z): a warp reads contiguous runs of
// each array, the z and y neighbours of x come from L1, the x neighbours
// from L2 (the planes i-1 and i+1 are read by blocks in flight at the same
// time), and no integer division is left in the index arithmetic. The
// diagonal costs no bytes: it is recomputed from the face coefficients a
// sweep has loaded anyway. Restriction is fused into the residual, and
// prolongation into the next sweep, so neither the fine residual nor the
// corrected x is written and read back.

#include <cuda_runtime.h>

namespace {

constexpr int kPeriodic = 0, kMirror = 1, kNegate = 2;
constexpr int kMaxCoarseCells = 4096;  // the coarse kernel's largest level
constexpr int kCoarseThreads = 1024;

// A level's shape, the ghost rule and poisson_diag factor of each boundary
// face (x lo, x hi, y lo, y hi, z lo, z hi), 1/h and 1/h^2 per axis, omega.
struct Level {
  int nx, ny, nz;
  int kind[6];
  float ih[3], ih2[3], fac[6], omega;
};

// x' = x + prolong(ec) at an interior cell, from device memory (x absent:
// 0 + prolong(ec), as the plain version adds the correction to zeros)
template <bool kX, bool kEc>
struct GlobalX {
  const float* x;
  const float* ec;
  int ny, nz, cny, cnz;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    float v = kX ? __ldg(x + (i * ny + j) * nz + k) : 0.0f;
    if (kEc) v = v + __ldg(ec + ((i >> 1) * cny + (j >> 1)) * cnz + (k >> 1));
    return v;
  }
};

// x at an interior cell, from shared memory
struct SharedX {
  const float* s;
  int ny, nz;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    return s[(i * ny + j) * nz + k];
  }
};

__device__ __forceinline__ float ghost(int kind, float c, float wrapped) {
  return kind == kPeriodic ? wrapped : kind == kMirror ? c : 0.0f - c;
}

// The cell and its six neighbours (x lo, x hi, y lo, y hi, z lo, z hi),
// a neighbour past the box being the face's ghost. The wrapped value is
// read only where the face is periodic.
template <class X>
__device__ __forceinline__ void stencil(const Level& L, const X& xv, int i, int j, int k,
                                        float v[7]) {
  const float c = xv(i, j, k);
  v[0] = c;
  const int* kd = L.kind;
  v[1] = i > 0 ? xv(i - 1, j, k)
               : ghost(kd[0], c, kd[0] == kPeriodic ? xv(L.nx - 1, j, k) : c);
  v[2] = i < L.nx - 1 ? xv(i + 1, j, k)
                      : ghost(kd[1], c, kd[1] == kPeriodic ? xv(0, j, k) : c);
  v[3] = j > 0 ? xv(i, j - 1, k)
               : ghost(kd[2], c, kd[2] == kPeriodic ? xv(i, L.ny - 1, k) : c);
  v[4] = j < L.ny - 1 ? xv(i, j + 1, k)
                      : ghost(kd[3], c, kd[3] == kPeriodic ? xv(i, 0, k) : c);
  v[5] = k > 0 ? xv(i, j, k - 1)
               : ghost(kd[4], c, kd[4] == kPeriodic ? xv(i, j, L.nz - 1) : c);
  v[6] = k < L.nz - 1 ? xv(i, j, k + 1)
                      : ghost(kd[5], c, kd[5] == kPeriodic ? xv(i, j, 0) : c);
}

// The six face coefficients of cell (i, j, k): gx (nx+1, ny, nz) faces i
// and i+1, gy (nx, ny+1, nz) faces j and j+1, gz (nx, ny, nz+1) faces k and
// k+1.
__device__ __forceinline__ void faces(const Level& L, const float* __restrict__ gx,
                                      const float* __restrict__ gy,
                                      const float* __restrict__ gz, int i, int j, int k,
                                      float g[6]) {
  const int ox = (i * L.ny + j) * L.nz + k;
  const int oy = (i * (L.ny + 1) + j) * L.nz + k;
  const int oz = (i * L.ny + j) * (L.nz + 1) + k;
  g[0] = __ldg(gx + ox);
  g[1] = __ldg(gx + ox + L.ny * L.nz);
  g[2] = __ldg(gy + oy);
  g[3] = __ldg(gy + oy + L.nz);
  g[4] = __ldg(gz + oz);
  g[5] = __ldg(gz + oz + 1);
}

// A x' at the cell: `laplacian_facegamma_padded`'s operations in its order
__device__ __forceinline__ float apply_cell(const Level& L, const float v[7], const float g[6]) {
  const float ax = (g[1] * ((v[2] - v[0]) * L.ih[0]) - g[0] * ((v[0] - v[1]) * L.ih[0])) * L.ih[0];
  const float ay = (g[3] * ((v[4] - v[0]) * L.ih[1]) - g[2] * ((v[0] - v[3]) * L.ih[1])) * L.ih[1];
  const float az = (g[5] * ((v[6] - v[0]) * L.ih[2]) - g[4] * ((v[0] - v[5]) * L.ih[2])) * L.ih[2];
  return ((0.0f + ax) + ay) + az;
}

// omega / diag(A) at the cell: `poisson_diag`'s operations in its order,
// then the V-cycle's 1 / where(|d| < 1e-30, -1, d) and omega * that
__device__ __forceinline__ float omega_inv_diag(const Level& L, int i, int j, int k,
                                                const float g[6]) {
  const float fxl = i == 0 ? L.fac[0] : 1.0f, fxh = i == L.nx - 1 ? L.fac[1] : 1.0f;
  const float fyl = j == 0 ? L.fac[2] : 1.0f, fyh = j == L.ny - 1 ? L.fac[3] : 1.0f;
  const float fzl = k == 0 ? L.fac[4] : 1.0f, fzh = k == L.nz - 1 ? L.fac[5] : 1.0f;
  float d = 0.0f - (fxl * g[0] + fxh * g[1]) * L.ih2[0];
  d = d - (fyl * g[2] + fyh * g[3]) * L.ih2[1];
  d = d - (fzl * g[4] + fzh * g[5]) * L.ih2[2];
  return L.omega * (1.0f / (fabsf(d) < 1e-30f ? -1.0f : d));
}

// One sweep at cell (i, j, k) of the plane tile; kX false and kEc false is
// the sweep from zero: 0 + omega D^-1 b.
template <bool kX, bool kEc>
__global__ void __launch_bounds__(256) jacobi_kernel(Level L, const float* __restrict__ x,
                                                     const float* __restrict__ ec,
                                                     const float* __restrict__ b,
                                                     const float* __restrict__ gx,
                                                     const float* __restrict__ gy,
                                                     const float* __restrict__ gz,
                                                     float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  if (k >= L.nz || j >= L.ny) return;
  const int c = (i * L.ny + j) * L.nz + k;
  float g[6];
  faces(L, gx, gy, gz, i, j, k, g);
  const float w = omega_inv_diag(L, i, j, k, g);
  if (!kX && !kEc) {
    out[c] = 0.0f + w * __ldg(b + c);
    return;
  }
  const GlobalX<kX, kEc> xv{x, ec, L.ny, L.nz, L.ny >> 1, L.nz >> 1};
  float v[7];
  stencil(L, xv, i, j, k, v);
  out[c] = v[0] + w * (__ldg(b + c) - apply_cell(L, v, g));
}

// One thread per coarse cell (I, J, K): the mean of the fine residual
// b - A x over cells 2I..2I+1, 2J..2J+1, 2K..2K+1, summed in that order
// (x absent: b - A 0 = b).
template <bool kX>
__global__ void __launch_bounds__(256) residual_restrict_kernel(
    Level L, const float* __restrict__ x, const float* __restrict__ b,
    const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
    float* __restrict__ out) {
  const int cnz = L.nz >> 1, cny = L.ny >> 1;
  const int K = blockIdx.x * blockDim.x + threadIdx.x;
  const int J = blockIdx.y * blockDim.y + threadIdx.y;
  const int I = blockIdx.z;
  if (K >= cnz || J >= cny) return;
  const GlobalX<true, false> xv{x, nullptr, L.ny, L.nz, 0, 0};
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int i = 2 * I + (d >> 2), j = 2 * J + ((d >> 1) & 1), k = 2 * K + (d & 1);
    const int c = (i * L.ny + j) * L.nz + k;
    float r = __ldg(b + c);
    if (kX) {
      float g[6], v[7];
      faces(L, gx, gy, gz, i, j, k, g);
      stencil(L, xv, i, j, k, v);
      r = r - apply_cell(L, v, g);
    }
    s = s + r;
  }
  out[(I * cny + J) * cnz + K] = s * 0.125f;
}

// `sweeps` sweeps from zero on the whole level in one block: x ping-pongs
// between two halves of shared memory, b and the face arrays come through
// L1. The first sweep is the one from zero.
__global__ void __launch_bounds__(kCoarseThreads) coarse_kernel(
    Level L, int sweeps, const float* __restrict__ b, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ gz, float* __restrict__ out) {
  extern __shared__ float sx[];
  const int n = L.nx * L.ny * L.nz;
  float* cur = sx;
  float* nxt = sx + n;
  for (int s = 0; s < sweeps; ++s) {
    const SharedX xv{cur, L.ny, L.nz};
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int k = c % L.nz, j = (c / L.nz) % L.ny, i = c / (L.nz * L.ny);
      float g[6];
      faces(L, gx, gy, gz, i, j, k, g);
      const float w = omega_inv_diag(L, i, j, k, g);
      if (s == 0) {
        nxt[c] = 0.0f + w * __ldg(b + c);
      } else {
        float v[7];
        stencil(L, xv, i, j, k, v);
        nxt[c] = v[0] + w * (__ldg(b + c) - apply_cell(L, v, g));
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) out[c] = cur[c];
}

// The level from the host parameters; false if they are not what the
// kernels take (every index below 2^31, BC kinds known).
bool level_of(const int* ip, const float* fp, Level* L) {
  L->nx = ip[0];
  L->ny = ip[1];
  L->nz = ip[2];
  if (L->nx < 1 || L->ny < 1 || L->nz < 1 || L->nx > 65535 ||
      (long long)(L->nx + 1) * (L->ny + 1) * (L->nz + 1) >= (1LL << 31))
    return false;
  for (int f = 0; f < 6; ++f) {
    L->kind[f] = ip[3 + f];
    if (L->kind[f] < kPeriodic || L->kind[f] > kNegate) return false;
    L->fac[f] = fp[6 + f];
  }
  for (int a = 0; a < 3; ++a) {
    L->ih[a] = fp[a];
    L->ih2[a] = fp[3 + a];
  }
  L->omega = fp[12];
  return true;
}

// (z, y) tiles of 256 threads over an (ny, nz) plane, one plane a grid
// layer: tz a power of two up to 32 covering nz where it can, ty the rest
void plane_tiles(int nx, int ny, int nz, dim3* grid, dim3* block) {
  int tz = 1, ty = 1;
  while (tz < nz && tz < 32) tz <<= 1;
  while (ty < ny && tz * ty < 256) ty <<= 1;
  *block = dim3(tz, ty);
  *grid = dim3((nz + tz - 1) / tz, (ny + ty - 1) / ty, nx);
}

}  // namespace

extern "C" {

// iparams (host): nx, ny, nz of the level, the six faces' ghost rules (0
// periodic, 1 mirror, 2 negate), sweeps (the coarse entry's); fparams
// (host): 1/h (3), 1/h^2 (3), the six faces' poisson_diag factors, omega.
// Device arrays are contiguous float32: x, b, out (nx, ny, nz), ec (nx/2,
// ny/2, nz/2), the face arrays as above. Each entry returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// parameters its kernel does not take.

// x or ec may be null (zero x; no correction). With ec, nx, ny and nz are
// even.
int yofc_mg_jacobi(const int* iparams, const float* fparams, const float* x, const float* ec,
                   const float* b, const float* gx, const float* gy, const float* gz, float* out,
                   void* stream) {
  Level L;
  if (!level_of(iparams, fparams, &L)) return (int)cudaErrorInvalidValue;
  if (ec && (L.nx % 2 || L.ny % 2 || L.nz % 2)) return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  plane_tiles(L.nx, L.ny, L.nz, &grid, &block);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x && ec)
    jacobi_kernel<true, true><<<grid, block, 0, s>>>(L, x, ec, b, gx, gy, gz, out);
  else if (x)
    jacobi_kernel<true, false><<<grid, block, 0, s>>>(L, x, ec, b, gx, gy, gz, out);
  else if (ec)
    jacobi_kernel<false, true><<<grid, block, 0, s>>>(L, x, ec, b, gx, gy, gz, out);
  else
    jacobi_kernel<false, false><<<grid, block, 0, s>>>(L, x, ec, b, gx, gy, gz, out);
  return (int)cudaGetLastError();
}

// out (nx/2, ny/2, nz/2); nx, ny, nz even; x may be null (zero).
int yofc_mg_residual_restrict(const int* iparams, const float* fparams, const float* x,
                              const float* b, const float* gx, const float* gy, const float* gz,
                              float* out, void* stream) {
  Level L;
  if (!level_of(iparams, fparams, &L) || L.nx % 2 || L.ny % 2 || L.nz % 2)
    return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  plane_tiles(L.nx / 2, L.ny / 2, L.nz / 2, &grid, &block);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x)
    residual_restrict_kernel<true><<<grid, block, 0, s>>>(L, x, b, gx, gy, gz, out);
  else
    residual_restrict_kernel<false><<<grid, block, 0, s>>>(L, x, b, gx, gy, gz, out);
  return (int)cudaGetLastError();
}

// iparams[9] sweeps >= 1 from zero; nx * ny * nz <= 4096.
int yofc_mg_coarse(const int* iparams, const float* fparams, const float* b, const float* gx,
                   const float* gy, const float* gz, float* out, void* stream) {
  Level L;
  const int sweeps = iparams[9];
  if (!level_of(iparams, fparams, &L) || sweeps < 1) return (int)cudaErrorInvalidValue;
  const int n = L.nx * L.ny * L.nz;
  if (n > kMaxCoarseCells) return (int)cudaErrorInvalidValue;
  const int threads = n < kCoarseThreads ? (n + 31) / 32 * 32 : kCoarseThreads;
  coarse_kernel<<<1, threads, 2 * n * sizeof(float), (cudaStream_t)stream>>>(L, sweeps, b, gx,
                                                                            gy, gz, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
