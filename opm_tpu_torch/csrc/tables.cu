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
// opm_tpu_torch/utils/tables.py):
//   t = (x - lo) / (hi == lo ? 1 : hi - lo);  v = (1 - t) y0 + t y1;
//   'clamp' clips t to [0, 1]; the slope factor is then 0 outside,
//   1/2 at t == 0 or t == 1 (jax.jacfwd of jnp.clip at a tie), 1 inside;
//   the result is v + 0 * x, so NaN queries stay NaN (slope 0).
// Build with --fmad=false so every product and sum rounds as the plain
// PyTorch version's separate elementwise operations do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// index i of the active segment [xs[i], xs[i+1]), clipped to [0, n-2]:
// i = #{xs <= x} - 1 (binary search; xs non-decreasing)
__device__ __forceinline__ int segment_of(const double* xs, int n, double x) {
    int lo = 0, hi = n;             // count of xs[j] <= x lies in [lo, hi]
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (xs[mid] <= x) lo = mid + 1; else hi = mid;
    }
    int i = lo - 1;
    if (i < 0) i = 0;
    if (i > n - 2) i = n - 2;
    return i;
}

// local coordinate and its slope factor (d t_clipped / d t)
__device__ __forceinline__ void local_coord(const double* xs, int i, double x,
                                            int clamp, double* t_out,
                                            double* dt_out) {
    double lo = xs[i];
    double w = xs[i + 1] - lo;
    double ws = (w == 0.0) ? 1.0 : w;
    double t = (x - lo) / ws;
    double f = 1.0;
    if (clamp) {
        if (t < 0.0) { t = 0.0; f = 0.0; }
        else if (t > 1.0) { t = 1.0; f = 0.0; }
        else if (t == 0.0 || t == 1.0) { f = 0.5; }
    }
    *t_out = t;
    *dt_out = f * (1.0 / ws);
}

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
        double xq = x[q];
        int r = reg ? reg[q] : 0;
        const double* rx = sx + r * n;
        const double* ry = sy + (long long)r * ncol * n;
        if (isnan(xq)) {
            for (int c = 0; c < ncol; ++c) {
                val[c * nq + q] = xq;
                slope[c * nq + q] = 0.0;
            }
            continue;
        }
        int i = segment_of(rx, n, xq);
        double t, dt;
        local_coord(rx, i, xq, clamp, &t, &dt);
        double zx = 0.0 * xq;
        for (int c = 0; c < ncol; ++c) {
            double y0 = ry[c * n + i];
            double y1 = ry[c * n + i + 1];
            double v = (1.0 - t) * y0 + t * y1;
            val[c * nq + q] = v + zx;
            slope[c * nq + q] = (-dt) * y0 + dt * y1;
        }
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
        double xq = x[q];
        double yq = y[q];
        int r = reg ? reg[q] : 0;
        const double* rx = sx + r * n;
        const double* ry = sy + r * m;
        const double* rz = sz + (long long)r * ngrid * n * m;
        if (isnan(xq) || isnan(yq)) {
            double nanv = xq + yq;
            for (int g = 0; g < ngrid; ++g) {
                val[g * nq + q] = nanv;
                dvdx[g * nq + q] = 0.0;
                dvdy[g * nq + q] = 0.0;
            }
            continue;
        }
        int i = segment_of(rx, n, xq);
        int j = segment_of(ry, m, yq);
        double tx, dtx, ty, dty;
        local_coord(rx, i, xq, clamp_x, &tx, &dtx);
        local_coord(ry, j, yq, clamp_y, &ty, &dty);
        double zx = 0.0 * xq;
        double zy = 0.0 * yq;
        for (int g = 0; g < ngrid; ++g) {
            const double* zg = rz + (long long)g * n * m;
            double z00 = zg[i * m + j], z01 = zg[i * m + j + 1];
            double z10 = zg[(i + 1) * m + j], z11 = zg[(i + 1) * m + j + 1];
            // y-contraction per x-node first, then x (the reference's
            // node-basis order)
            double v0 = (1.0 - ty) * z00 + ty * z01;
            double v1 = (1.0 - ty) * z10 + ty * z11;
            double v = (1.0 - tx) * v0 + tx * v1;
            val[g * nq + q] = (v + zx) + zy;
            dvdx[g * nq + q] = (-dtx) * v0 + dtx * v1;
            double d0 = (-dty) * z00 + dty * z01;
            double d1 = (-dty) * z10 + dty * z11;
            dvdy[g * nq + q] = (1.0 - tx) * d0 + tx * d1;
        }
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
