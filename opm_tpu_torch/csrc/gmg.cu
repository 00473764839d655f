// K7: the level work of the structured-GMG V-cycle, for Hopper.
//
// Replaces the JAX package's linalg/gmg.py StructuredGmg._matvec (:171),
// _smooth (:200), the residual + _pairsum restriction and the _repeat2
// prolongation + post-smoothing of _vcycle3 (:295-312), which XLA fused on
// the TPU into shifted-slice passes.
//
// A level is a scalar 7-point stencil on (nz, ny, nx): diagonal d and per
// axis the couplings aL (to the next cell along the axis) and aR (to the
// previous one), each face array one shorter than the level along its
// axis. Three entries, one thread per output cell each:
//   smooth:          x' = x + 0.8 (b - A x) / d   (d = 1 where |d| <= 1e-300;
//                    x may be null: a zero first iterate);
//   restrict:        coarse b = pair sum along the coarsened axis of the
//                    fine residual b - A x, written into the next level's
//                    (ghost-padded) shape with the ghost slab zero;
//   prolong_smooth:  x + the coarse correction replicated along the axis,
//                    then one sweep on that iterate (the replicated value is
//                    formed for the cell and each neighbour on the fly).
// Every row sums in the reference's order (diagonal, then per axis z, y, x
// the next cell's aL term and the previous cell's aR term), so results are
// bitwise those of the plain version; no atomics.
//
// What bounds it on the card: memory traffic at the fine levels (per cell
// 7 coefficients, 7 neighbours mostly from L2, b and the output), launch
// latency at the coarse ones (each level is three launches, whatever its
// size). Build with --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr double kOmega = 0.8;

struct Level {
    int nz, ny, nx;
    const double* d;
    const double* aL[3];   // z, y, x
    const double* aR[3];
};

struct ZeroX {
    __device__ __forceinline__ double operator()(int, int, int) const {
        return 0.0;
    }
};

struct PlainX {
    const double* x;
    int ny, nx;
    __device__ __forceinline__ double operator()(int k, int j, int i) const {
        return x[((long long)k * ny + j) * nx + i];
    }
};

// x + the coarse correction e (dims ez, ey, ex) at the parent cell
struct ProlongX {
    const double* x;
    const double* e;
    int ny, nx, axis, ey, ex;
    __device__ __forceinline__ double operator()(int k, int j, int i) const {
        int pk = axis == 0 ? k >> 1 : k;
        int pj = axis == 1 ? j >> 1 : j;
        int pi = axis == 2 ? i >> 1 : i;
        return x[((long long)k * ny + j) * nx + i]
               + e[((long long)pk * ey + pj) * ex + pi];
    }
};

template <class X>
__device__ __forceinline__ double stencil(const Level& L, const X& xv, int k,
                                          int j, int i) {
    const long long ny = L.ny, nx = L.nx;
    double y = L.d[((long long)k * ny + j) * nx + i] * xv(k, j, i);
    if (k < L.nz - 1)
        y = y + L.aL[0][((long long)k * ny + j) * nx + i] * xv(k + 1, j, i);
    if (k > 0)
        y = y + L.aR[0][((long long)(k - 1) * ny + j) * nx + i]
                * xv(k - 1, j, i);
    if (j < L.ny - 1)
        y = y + L.aL[1][((long long)k * (ny - 1) + j) * nx + i]
                * xv(k, j + 1, i);
    if (j > 0)
        y = y + L.aR[1][((long long)k * (ny - 1) + j - 1) * nx + i]
                * xv(k, j - 1, i);
    if (i < L.nx - 1)
        y = y + L.aL[2][((long long)k * ny + j) * (nx - 1) + i]
                * xv(k, j, i + 1);
    if (i > 0)
        y = y + L.aR[2][((long long)k * ny + j) * (nx - 1) + i - 1]
                * xv(k, j, i - 1);
    return y;
}

template <class X>
__device__ __forceinline__ double sweep(const Level& L, const X& xv,
                                        const double* b, int k, int j,
                                        int i) {
    long long c = ((long long)k * L.ny + j) * L.nx + i;
    double d = L.d[c];
    double safe = fabs(d) > 1e-300 ? d : 1.0;
    double y = stencil(L, xv, k, j, i);
    return xv(k, j, i) + kOmega * (b[c] - y) / safe;
}

template <class X>
__global__ void smooth_kernel(Level L, X xv, const double* __restrict__ b,
                              double* __restrict__ out) {
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long n = (long long)L.nz * L.ny * L.nx;
    if (c >= n) return;
    int i = (int)(c % L.nx);
    int j = (int)((c / L.nx) % L.ny);
    int k = (int)(c / ((long long)L.nx * L.ny));
    out[c] = sweep(L, xv, b, k, j, i);
}

__global__ void restrict_kernel(Level L, PlainX xv,
                                const double* __restrict__ b, int axis,
                                int cz, int cy, int cx,
                                double* __restrict__ out) {
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long n = (long long)cz * cy * cx;
    if (c >= n) return;
    int I = (int)(c % cx);
    int J = (int)((c / cx) % cy);
    int K = (int)(c / ((long long)cx * cy));
    // the real coarse cells: the level halved along the axis
    int rz = axis == 0 ? L.nz / 2 : L.nz;
    int ry = axis == 1 ? L.ny / 2 : L.ny;
    int rx = axis == 2 ? L.nx / 2 : L.nx;
    if (K >= rz || J >= ry || I >= rx) {
        out[c] = 0.0;                      // the next level's ghost slab
        return;
    }
    int k0 = axis == 0 ? 2 * K : K, k1 = axis == 0 ? 2 * K + 1 : K;
    int j0 = axis == 1 ? 2 * J : J, j1 = axis == 1 ? 2 * J + 1 : J;
    int i0 = axis == 2 ? 2 * I : I, i1 = axis == 2 ? 2 * I + 1 : I;
    long long f0 = ((long long)k0 * L.ny + j0) * L.nx + i0;
    long long f1 = ((long long)k1 * L.ny + j1) * L.nx + i1;
    double r0 = b[f0] - stencil(L, xv, k0, j0, i0);
    double r1 = b[f1] - stencil(L, xv, k1, j1, i1);
    out[c] = r0 + r1;
}

Level make_level(int nz, int ny, int nx, const double* d, const double* aLz,
                 const double* aRz, const double* aLy, const double* aRy,
                 const double* aLx, const double* aRx) {
    Level L;
    L.nz = nz;
    L.ny = ny;
    L.nx = nx;
    L.d = d;
    L.aL[0] = aLz;
    L.aR[0] = aRz;
    L.aL[1] = aLy;
    L.aR[1] = aRy;
    L.aL[2] = aLx;
    L.aR[2] = aRx;
    return L;
}

int blocks_for(long long n) {
    return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int opm_gmg_smooth(int nz, int ny, int nx, const double* d,
                   const double* aLz, const double* aRz, const double* aLy,
                   const double* aRy, const double* aLx, const double* aRx,
                   const double* x, const double* b, double* out,
                   cudaStream_t stream) {
    Level L = make_level(nz, ny, nx, d, aLz, aRz, aLy, aRy, aLx, aRx);
    long long n = (long long)nz * ny * nx;
    if (n == 0) return 0;
    if (x == nullptr) {
        smooth_kernel<<<blocks_for(n), kThreads, 0, stream>>>(L, ZeroX{}, b,
                                                              out);
    } else {
        PlainX xv{x, ny, nx};
        smooth_kernel<<<blocks_for(n), kThreads, 0, stream>>>(L, xv, b, out);
    }
    return (int)cudaGetLastError();
}

int opm_gmg_restrict(int nz, int ny, int nx, const double* d,
                     const double* aLz, const double* aRz, const double* aLy,
                     const double* aRy, const double* aLx, const double* aRx,
                     const double* x, const double* b, double* out, int axis,
                     int cz, int cy, int cx, cudaStream_t stream) {
    Level L = make_level(nz, ny, nx, d, aLz, aRz, aLy, aRy, aLx, aRx);
    long long n = (long long)cz * cy * cx;
    if (n == 0) return 0;
    PlainX xv{x, ny, nx};
    restrict_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        L, xv, b, axis, cz, cy, cx, out);
    return (int)cudaGetLastError();
}

int opm_gmg_prolong_smooth(int nz, int ny, int nx, const double* d,
                           const double* aLz, const double* aRz,
                           const double* aLy, const double* aRy,
                           const double* aLx, const double* aRx,
                           const double* x, const double* e, int axis,
                           int ez, int ey, int ex, const double* b,
                           double* out, cudaStream_t stream) {
    (void)ez;
    Level L = make_level(nz, ny, nx, d, aLz, aRz, aLy, aRy, aLx, aRx);
    long long n = (long long)nz * ny * nx;
    if (n == 0) return 0;
    ProlongX xv{x, e, ny, nx, axis, ey, ex};
    smooth_kernel<<<blocks_for(n), kThreads, 0, stream>>>(L, xv, b, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
