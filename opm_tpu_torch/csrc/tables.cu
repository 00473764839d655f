// K1: piecewise-linear and bilinear table lookup with slopes, for Hopper.
//
// Replaces the JAX package's utils/tables.py lookups (interp :97-123 with
// its segment-sum form _interp_segsum :88-94 and _segments :48-74,
// interp_multi :126, interp2 :237-294, interp2_multi :217-234), which XLA
// fused on the TPU as per-segment mask sums.
//
// What bounds it on the card: memory traffic. Per query it reads x (and y,
// and a region index where there are several regions) and writes one value
// and one or two slopes per column, 8 bytes each; the tables are a few
// hundred doubles. Design: one thread per query; each block stages the
// tables in shared memory once, then each thread does a binary search on the
// staged abscissae (the active segment is the one with xs[k] <= x < xs[k+1];
// queries below/above the table take the first/last segment, as the
// reference's index clip does) and writes value AND derivative in the same
// pass, so the Jacobian costs no second lookup. Loads and stores are
// coalesced (query-contiguous, column-major outputs).
//
// Semantics reproduced exactly (see the plain version in
// opm_tpu_torch/utils/tables.py); the segment search and interpolation
// live in tables.cuh, which K2 (cells.cu) shares. Build with --fmad=false
// so every product and sum rounds as the plain PyTorch version's separate
// elementwise operations do.

#include <cuda_runtime.h>
#include <math.h>

#include "tables.cuh"

namespace {

using opm_tables::Coord1;
using opm_tables::coord1;

constexpr int kThreads = 256;

// xs: (nreg, n); ys: (nreg, ncol, n); x, reg: (nq); val, slope: (ncol, nq)
__global__ void interp1_kernel(const double* __restrict__ xs,
                               const double* __restrict__ ys,
                               int nreg, int n, int ncol,
                               const double* __restrict__ x,
                               const int* __restrict__ reg, long long nq,
                               int clamp, double* __restrict__ val,
                               double* __restrict__ slope) {
    extern __shared__ double smem[];
    double* sx = smem;                       // nreg * n
    double* sy = smem + nreg * n;            // nreg * ncol * n
    for (int j = threadIdx.x; j < nreg * n; j += blockDim.x) sx[j] = xs[j];
    for (int j = threadIdx.x; j < nreg * ncol * n; j += blockDim.x)
        sy[j] = ys[j];
    __syncthreads();
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         q < nq; q += stride) {
        int r = reg ? reg[q] : 0;
        const double* ry = sy + (long long)r * ncol * n;
        Coord1 c = coord1(sx + r * n, n, x[q], clamp);
        for (int k = 0; k < ncol; ++k)
            opm_tables::interp1(c, ry + k * n, &val[k * nq + q],
                                &slope[k * nq + q]);
    }
}

// xs: (nreg, n); ys: (nreg, m); z: (nreg, ngrid, n, m); x, y, reg: (nq);
// val, dvdx, dvdy: (ngrid, nq). One segment search per axis serves all grids.
__global__ void interp2_kernel(const double* __restrict__ xs,
                               const double* __restrict__ ys,
                               const double* __restrict__ z,
                               int nreg, int n, int m, int ngrid,
                               const double* __restrict__ x,
                               const double* __restrict__ y,
                               const int* __restrict__ reg, long long nq,
                               int clamp_x, int clamp_y,
                               double* __restrict__ val,
                               double* __restrict__ dvdx,
                               double* __restrict__ dvdy) {
    extern __shared__ double smem[];
    double* sx = smem;                       // nreg * n
    double* sy = sx + nreg * n;              // nreg * m
    double* sz = sy + nreg * m;              // nreg * ngrid * n * m
    for (int j = threadIdx.x; j < nreg * n; j += blockDim.x) sx[j] = xs[j];
    for (int j = threadIdx.x; j < nreg * m; j += blockDim.x) sy[j] = ys[j];
    for (int j = threadIdx.x; j < nreg * ngrid * n * m; j += blockDim.x)
        sz[j] = z[j];
    __syncthreads();
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         q < nq; q += stride) {
        int r = reg ? reg[q] : 0;
        const double* rz = sz + (long long)r * ngrid * n * m;
        Coord1 cx = coord1(sx + r * n, n, x[q], clamp_x);
        Coord1 cy = coord1(sy + r * m, m, y[q], clamp_y);
        for (int g = 0; g < ngrid; ++g)
            opm_tables::interp2(cx, cy, rz + (long long)g * n * m, m,
                                &val[g * nq + q], &dvdx[g * nq + q],
                                &dvdy[g * nq + q]);
    }
}

int blocks_for(long long nq) {
    long long b = (nq + kThreads - 1) / kThreads;
    if (b < 1) b = 1;
    if (b > 65535LL * 8) b = 65535LL * 8;
    return (int)b;
}

}  // namespace

extern "C" int opm_interp1(const double* xs, const double* ys, int nreg,
                           int n, int ncol, const double* x, const int* reg,
                           long long nq, int clamp, double* val,
                           double* slope, void* stream) {
    size_t smem = sizeof(double) * (size_t)nreg * n * (1 + ncol);
    interp1_kernel<<<blocks_for(nq), kThreads, smem,
                     (cudaStream_t)stream>>>(xs, ys, nreg, n, ncol, x, reg,
                                             nq, clamp, val, slope);
    return (int)cudaGetLastError();
}

extern "C" int opm_interp2(const double* xs, const double* ys,
                           const double* z, int nreg, int n, int m,
                           int ngrid, const double* x, const double* y,
                           const int* reg, long long nq, int clamp_x,
                           int clamp_y, double* val, double* dvdx,
                           double* dvdy, void* stream) {
    size_t smem = sizeof(double) * (size_t)nreg * (n + m + (size_t)ngrid * n * m);
    interp2_kernel<<<blocks_for(nq), kThreads, smem,
                     (cudaStream_t)stream>>>(xs, ys, z, nreg, n, m, ngrid, x,
                                             y, reg, nq, clamp_x, clamp_y,
                                             val, dvdx, dvdy);
    return (int)cudaGetLastError();
}
