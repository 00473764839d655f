// K10: the aggregation-AMG level work of the CPR pressure stage on grids
// with a face list, for Hopper: the V-cycle as two cooperative launches
// (damped-Jacobi sweeps over ELL matrices, the residual restricted by
// aggregate, the prolongation by gather), and the per-Newton Galerkin value
// coarsening and ELL packing.
//
// Replaces the JAX package's linalg/amg.py ell_spmv (:27) and jacobi_sweep
// (:37) (the repository's only Pallas kernels ever written, deleted after
// they measured within noise of XLA's fusion of the same jnp forms), the
// V-cycle's transfers segment_sum(r, agg) (:278) and e_c[agg] (:280), and
// DeviceAmg.coarsen_values (:206-230).
//
// Layout: a level of n cells has diag (n,) and ELL values (K, n) with
// column ids cols (K, n) int32; K is the level's widest row (9 to 26 on the
// Norne-class gather grid), padding slots are self-loops whose values are 0
// and are multiplied like any other (so the sum equals the plain
// version's). A kernel reads the neighbour values x[cols] itself.
//
// The V-cycle (one pre- and one post-smoothing sweep, omega = 0.8):
//
//   down  for each level k = 0 .. nL-1 two phases, one thread per cell:
//         the level's right-hand side (at level 0 the input, or in the
//         right-hand side entry the CPR apply's weighted pressure residual
//         (w0 r0 + w1 r1) + w2 r2 of the cell, K6's pressure_rhs
//         expression, written to the workspace for the second phase and
//         the up leg: the sweep reads b at its own cell only, so it needs
//         no barrier of its own; the previous level's residuals
//         summed over the cell's children, by fine index) and the
//         zero-start sweep x = 0 + 0.8 (b - A 0) / diag (diag = 1 where
//         |diag| <= 1e-300) into the workspace; then the residual b - A x
//         into a scratch vector; after the last level the coarsest
//         right-hand side, rounded to float32 when the coarsest is solved
//         by its dense inverse, else the leg goes on with the coarsest's
//         1 + 10 sweeps, a barrier before each;
//   (between the two: the float32 product with the coarsest inverse, one
//         library call, as the reference leaves it to XLA);
//   up    for each level k = nL-1 .. 0, one thread per cell: one sweep on
//         x + e_c[agg] (x read back from the down leg); level 0 writes the
//         V-cycle's output.
//
// x is stored, where K7 evaluates its pre-smoothed iterate on the fly: a
// row's K neighbours (9 to 26 here) each need their own K + 2 values for
// it, K^2 loads a row; evaluated on the fly, one V-cycle on the
// Norne-class gather grid took 2.35 ms against 0.69 ms for the former
// three launches per level (NVIDIA H100 80GB HBM3, chip_smoke.py).
//
// Each leg is one cooperative launch with a grid barrier between levels,
// a level's work a grid-stride loop; the levels' arrays, sizes and
// workspace pointers are a table on the device (one record of eight-byte
// fields per level, uploaded once per Newton by linalg/amg.py, which packs
// the same order). Every sum runs in the plain version's order (ELL slots
// ascending, then the diagonal term; children by fine index), one thread
// per output: no atomics, and the grid's size changes no bit.
//
// What bounds it on the card: at the Norne-class sizes (level 0: 75,566
// cells, about 10 MB of values, in L2) the barriers (two per level in the
// down leg, one in the up leg) and each phase's chain of dependent loads
// (a row's gathers x[cols[k]]), not device memory; the value coarsening
// and the pack are a thread per output over CSRs built once on the host.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr double kOmega = 0.8;
constexpr int kCoarseSweeps = 10;   // after the first, where not inverted

// one level as the table holds it: its matrix, its aggregates into the
// next level with their children (CSR by aggregate, null at the coarsest),
// its right-hand side b and correction e in the workspace (null at level
// 0, whose b is the input and whose e is the output), its pre-smoothed
// iterate x (the zero-start sweep; null at the coarsest), at the coarsest
// a second sweep buffer s (the sweeps' branch), and its n and K
struct LevelRec {
    const double* diag;
    const double* vals;
    const int* cols;
    const int* agg;
    const int* cptr;
    const int* cidx;
    double* b;
    double* e;
    double* x;
    double* s;
    long long n, K;
};

struct Ell {
    int n, K;
    const double* diag;
    const double* vals;
    const int* cols;
};

__device__ __forceinline__ Ell ell_of(const LevelRec& R) {
    return Ell{(int)R.n, (int)R.K, R.diag, R.vals, R.cols};
}

struct ZeroX {
    __device__ __forceinline__ double operator()(int) const { return 0.0; }
};

struct PlainX {
    const double* x;
    __device__ __forceinline__ double operator()(int j) const {
        return x[j];
    }
};

// the pre-smoothed iterate plus the coarse correction of its aggregate
// (float32 where it comes from the dense coarsest)
template <class E>
struct PostX {
    const double* x;
    const E* e;
    const int* agg;
    __device__ __forceinline__ double operator()(int j) const {
        return x[j] + (double)e[agg[j]];
    }
};

// (A x)_i = diag_i x_i + sum_k vals[k][i] x[cols[k][i]], k ascending; xi
// the iterate at i
template <class X>
__device__ __forceinline__ double spmv_row(const Ell& A, int i, const X& xv,
                                           double xi) {
    double acc = A.vals[i] * xv(A.cols[i]);
    // unrolled so that the slots' gathers are in flight together (the sum
    // still runs k = 1, 2, ... in order)
#pragma unroll 8
    for (int k = 1; k < A.K; ++k) {
        long long s = (long long)k * A.n + i;
        acc = acc + A.vals[s] * xv(A.cols[s]);
    }
    return A.diag[i] * xi + acc;
}

// one damped-Jacobi sweep of the iterate xv at i
template <class X>
__device__ __forceinline__ double sweep_row(const Ell& A, int i,
                                            const X& xv, double bi) {
    double xi = xv(i);
    double y = spmv_row(A, i, xv, xi);
    double d = A.diag[i];
    double safe = fabs(d) > 1e-300 ? d : 1.0;
    double t = kOmega * (bi - y);
    return xi + t / safe;
}

__device__ __forceinline__ long long first_index() {
    return (long long)blockIdx.x * kThreads + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
    return (long long)gridDim.x * kThreads;
}

// the sum over aggregate c's children (by fine index) of the fine level's
// residuals r
__device__ __forceinline__ double aggregate_sum(const LevelRec& F,
                                                const double* r, int c) {
    double acc = 0.0;
    for (int e = F.cptr[c]; e < F.cptr[c + 1]; ++e) acc = acc + r[F.cidx[e]];
    return acc;
}

// the CPR apply's weighted pressure residual at cell c of n0
__device__ __forceinline__ double weighted_rhs(const double* w,
                                              const double* rc, long long n0,
                                              long long c) {
    return (w[c] * rc[c] + w[n0 + c] * rc[n0 + c])
           + w[2 * n0 + c] * rc[2 * n0 + c];
}

// down leg, level k, first phase: the level's right-hand side (level 0:
// the input, or with w the weighted residual written into the input; the
// first level of a partial leg: the workspace's; else the previous level's
// residuals summed by aggregate, written to the workspace), then the
// zero-start sweep into the level's x
__device__ void presmooth_level(const LevelRec* T, int k, int first,
                                double* in, const double* w,
                                const double* rc, const double* r) {
    const LevelRec& F = T[k];
    Ell A = ell_of(F);
    for (long long i = first_index(); i < A.n; i += grid_stride()) {
        const int c = (int)i;
        double bc;
        if (k == 0 && w) {
            bc = weighted_rhs(w, rc, A.n, c);
            in[c] = bc;
        } else if (k == 0) {
            bc = in[c];
        } else if (k == first) {
            bc = F.b[c];
        } else {
            bc = aggregate_sum(T[k - 1], r, c);
            F.b[c] = bc;
        }
        F.x[c] = sweep_row(A, c, ZeroX{}, bc);
    }
}

// down leg, level k, second phase: the residual b - A x of each cell into r
__device__ void residual_level(const LevelRec& F, const double* b,
                               double* r) {
    Ell A = ell_of(F);
    PlainX x{F.x};
    for (long long i = first_index(); i < A.n; i += grid_stride()) {
        const int c = (int)i;
        r[c] = b[c] - spmv_row(A, c, x, x(c));
    }
}

// down leg, after level k = hi - 1: level hi's right-hand side from the
// residuals (float32 into bc when hi is the coarsest and it is inverted)
__device__ void restrict_last(const LevelRec* T, int hi, int nL, int dense,
                              const double* r, float* bc) {
    const LevelRec& C = T[hi];
    for (long long i = first_index(); i < C.n; i += grid_stride()) {
        const int c = (int)i;
        double acc = aggregate_sum(T[hi - 1], r, c);
        if (hi < nL || !dense)
            C.b[c] = acc;
        else
            bc[c] = __double2float_rn(acc);
    }
}

// the coarsest's sweep t = 1 .. 1 + kCoarseSweeps on its right-hand side
// b (the first from zero), from buffer to buffer, the last into e
__device__ void coarse_sweep(const LevelRec& C, const double* b, int t) {
    Ell A = ell_of(C);
    double* dst = ((kCoarseSweeps + 1 - t) & 1) ? C.s : C.e;
    const double* src = ((kCoarseSweeps - t) & 1) ? C.s : C.e;
    for (long long i = first_index(); i < A.n; i += grid_stride()) {
        const int r = (int)i;
        dst[r] = t == 1 ? sweep_row(A, r, ZeroX{}, b[r])
                        : sweep_row(A, r, PlainX{src}, b[r]);
    }
}

// up leg, level k: the post-smoothing sweep of x + en[agg], into the
// level's e (level 0: the output)
template <class E>
__device__ void prolong_level(const LevelRec& F, int k, const double* in,
                              const E* en, double* out) {
    const double* b = k == 0 ? in : F.b;
    Ell A = ell_of(F);
    PostX<E> x{F.x, en, F.agg};
    double* dst = k == 0 ? out : F.e;
    for (long long i = first_index(); i < A.n; i += grid_stride()) {
        const int r = (int)i;
        dst[r] = sweep_row(A, r, x, b[r]);
    }
}

// levels lo .. hi-1 of the down leg (the whole leg: 0 .. nL), two phases
// each (r: the residuals' scratch, n0 values), level hi's right-hand side,
// then, when hi == nL and the coarsest is not inverted (dense == 0), its
// sweeps; with w the whole leg from the weighted residual (w, rc (3, n0)),
// level 0's b formed into in (the workspace's) on the way
__global__ void __launch_bounds__(kThreads, 2)
amg_down(const LevelRec* T, int nL, int dense, int lo, int hi,
         double* in, const double* w, const double* rc, double* r,
         float* bc) {
    cg::grid_group grid = cg::this_grid();
    if (w && nL == 0) {                // level 0 is the coarsest
        for (long long c = first_index(); c < T[0].n; c += grid_stride())
            in[c] = weighted_rhs(w, rc, T[0].n, c);
        grid.sync();
    }
    if (nL == 0 && dense) {            // the coarsest level alone
        for (long long c = first_index(); c < T[0].n; c += grid_stride())
            bc[c] = __double2float_rn(in[c]);
        return;
    }
    for (int k = lo; k < hi; ++k) {
        if (k > lo) grid.sync();
        presmooth_level(T, k, lo, in, w, rc, r);
        grid.sync();
        residual_level(T[k], k == 0 ? in : T[k].b, r);
    }
    if (hi > lo) {
        grid.sync();
        restrict_last(T, hi, nL, dense, r, bc);
    }
    if (hi == nL && !dense) {
        for (int t = 1; t <= 1 + kCoarseSweeps; ++t) {
            if (t > 1 || hi > lo) grid.sync();
            coarse_sweep(T[nL], nL == 0 ? in : T[nL].b, t);
        }
    }
}

// levels hi-1 .. lo of the up leg (the levels' x from the down leg); ec
// the float32 coarsest correction when it is inverted (else the coarsest
// record's e)
__global__ void __launch_bounds__(kThreads, 2)
amg_up(const LevelRec* T, int nL, int dense, int lo, int hi,
       const double* in, const float* ec, double* out) {
    cg::grid_group grid = cg::this_grid();
    if (nL == 0) {
        for (long long c = first_index(); c < T[0].n; c += grid_stride())
            out[c] = dense ? (double)ec[c] : T[0].e[c];
        return;
    }
    for (int k = hi - 1; k >= lo; --k) {
        if (k < hi - 1) grid.sync();
        if (k + 1 == nL && dense)
            prolong_level<float>(T[k], k, in, ec, out);
        else
            prolong_level<double>(T[k], k, in, T[k + 1].e, out);
    }
}

__global__ void coarsen_kernel(int n_c, const int* __restrict__ cptr,
                               const int* __restrict__ cidx,
                               const double* __restrict__ diag,
                               const int* __restrict__ fptr,
                               const int* __restrict__ fidx,
                               const double* __restrict__ off,
                               double* __restrict__ diag_c, int nnz_c,
                               const int* __restrict__ eptr,
                               const int* __restrict__ eidx,
                               double* __restrict__ off_c) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n_c) {
        // segment_sum(diag, agg) + segment_sum(folded entries, row)
        double s1 = 0.0, s2 = 0.0;
        for (int e = cptr[t]; e < cptr[t + 1]; ++e) s1 = s1 + diag[cidx[e]];
        for (int e = fptr[t]; e < fptr[t + 1]; ++e) s2 = s2 + off[fidx[e]];
        diag_c[t] = s1 + s2;
    }
    if (t < nnz_c) {
        double s = 0.0;
        for (int e = eptr[t]; e < eptr[t + 1]; ++e) s = s + off[eidx[e]];
        off_c[t] = s;
    }
}

__global__ void ell_pack_kernel(long long m, const long long* __restrict__ src,
                                const double* __restrict__ off,
                                double* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= m) return;
    long long s = src[t];
    out[t] = s >= 0 ? off[s] : 0.0;
}

inline int blocks_for(long long n) {
    return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// the grids of the two legs on the current device for legs whose largest
// level has work_down and work_up threads' worth: out[0], out[1] the grids
// (at most the co-resident blocks, at most what the work needs); out[2]
// the SM count; out[3], out[4] co-resident blocks per SM of down and up;
// out[5], out[6] their registers per thread
int opm_amg_grid(long long work_down, long long work_up, int* out) {
    int dev = 0, nsm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
    const void* ks[2] = {(const void*)amg_down, (const void*)amg_up};
    const long long work[2] = {work_down, work_up};
    for (int i = 0; i < 2; ++i) {
        int nb = 0;
        cudaFuncAttributes fa;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, ks[i],
                                                            kThreads, 0);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, ks[i]);
        if (err != cudaSuccess) return (int)err;
        if (nb < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        long long g = (long long)nb * nsm;
        long long need = blocks_for(work[i]);
        if (need < g) g = need;
        out[i] = (int)(g < 1 ? 1 : g);
        out[3 + i] = nb;
        out[5 + i] = fa.numRegs;
    }
    out[2] = nsm;
    return 0;
}

// table: the nL + 1 level records; dense: the coarsest is solved by its
// float32 inverse between the legs; levels lo .. hi-1; in: level 0's
// right-hand side; r: n0 values of scratch; bc: the coarsest right-hand
// side, float32
int opm_amg_down(const void* table, int nL, int dense, int lo, int hi,
                 double* in, double* r, float* bc, int grid,
                 cudaStream_t stream) {
    const LevelRec* T = static_cast<const LevelRec*>(table);
    const double* w = nullptr;
    const double* rc = nullptr;
    void* args[] = {&T, &nL, &dense, &lo, &hi, &in, &w, &rc, &r, &bc};
    return (int)cudaLaunchCooperativeKernel((const void*)amg_down,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

// the whole down leg from the CPR apply's weighted pressure residual: w,
// rc (3, n0) the weights and the cell residual, b0 (n0) level 0's
// right-hand side, written on the way (the up leg reads it)
int opm_amg_down_rhs(const void* table, int nL, int dense, const double* w,
                     const double* rc, double* b0, double* r, float* bc,
                     int grid, cudaStream_t stream) {
    const LevelRec* T = static_cast<const LevelRec*>(table);
    int lo = 0, hi = nL;
    double* in = b0;
    void* args[] = {&T, &nL, &dense, &lo, &hi, &in, &w, &rc, &r, &bc};
    return (int)cudaLaunchCooperativeKernel((const void*)amg_down,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

// ec: the coarsest correction, float32 (dense); out: the V-cycle's result
int opm_amg_up(const void* table, int nL, int dense, int lo, int hi,
               const double* in, const float* ec, double* out, int grid,
               cudaStream_t stream) {
    const LevelRec* T = static_cast<const LevelRec*>(table);
    void* args[] = {&T, &nL, &dense, &lo, &hi, &in, &ec, &out};
    return (int)cudaLaunchCooperativeKernel((const void*)amg_up, dim3(grid),
                                            dim3(kThreads), args, 0, stream);
}

int opm_amg_coarsen(int n_c, const int* cptr, const int* cidx,
                    const double* diag, const int* fptr, const int* fidx,
                    const double* off, double* diag_c, int nnz_c,
                    const int* eptr, const int* eidx, double* off_c,
                    cudaStream_t stream) {
    int m = n_c > nnz_c ? n_c : nnz_c;
    if (m == 0) return 0;
    coarsen_kernel<<<blocks_for(m), kThreads, 0, stream>>>(
        n_c, cptr, cidx, diag, fptr, fidx, off, diag_c, nnz_c, eptr, eidx,
        off_c);
    return (int)cudaGetLastError();
}

int opm_amg_ell_pack(long long m, const long long* src, const double* off,
                     double* out, cudaStream_t stream) {
    if (m == 0) return 0;
    ell_pack_kernel<<<blocks_for(m), kThreads, 0, stream>>>(m, src, off,
                                                            out);
    return (int)cudaGetLastError();
}

}  // extern "C"
