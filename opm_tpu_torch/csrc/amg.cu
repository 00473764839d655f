// K10: the aggregation-AMG level work of the CPR pressure stage on grids
// with a face list, for Hopper: the V-cycle as two cooperative launches
// (damped-Jacobi sweeps over ELL matrices, the residual restricted by
// aggregate, the prolongation by gather), and the per-Newton value refresh
// (every level's Galerkin values in ELL layout and the float32 dense
// coarsest matrix) as one cooperative launch.
//
// Replaces the JAX package's linalg/amg.py ell_spmv (:27) and jacobi_sweep
// (:37) (the repository's only Pallas kernels ever written, deleted after
// they measured within noise of XLA's fusion of the same jnp forms), the
// V-cycle's transfers segment_sum(r, agg) (:278) and e_c[agg] (:280), and
// DeviceAmg.coarsen_values (:206-243) up to its float32 inverse.
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
// fields per level, uploaded once per set of level values, for the
// refresh's once per hierarchy, by linalg/amg.py, which packs the same
// order). Every sum runs in the plain version's order (ELL
// slots ascending, then the diagonal term; children by fine index), one
// thread per output: no atomics, and the grid's size changes no bit.
//
// The refresh writes into buffers the hierarchy owns (linalg/amg.py
// Refresh), so its table too is uploaded once. Phase k (k = 0 .. nL-1) is
// the coarsening step k -> k+1, one thread per output: at k = 0 also level
// 0's diag copy and each ELL slot gathered from the face-order entries;
// each coarse diagonal row (its children's diag, then the entries folded
// into it) and each coarse entry, written straight into its slot of level
// k+1's ELL array. Step k reads level k's ELL array at the entries' slots
// (the host composed the merge maps with the ELL slot maps), so no
// entry-order intermediate and no separate pack exist; the sums run
// children by fine index and entries by entry index, the per-level
// composition's order. A last phase writes the float32 dense coarsest
// matrix; its inverse is one library call (torch.linalg.inv_ex), as the
// reference leaves jnp.linalg.inv to XLA. Every phase runs over the whole
// grid: finishing the small coarse phases in one block with block barriers
// was slower on the Norne-class gather grid than the grid barriers it
// saves (PERF.md).
//
// The refresh's entry with K6 (amg_refresh_setup): the CPR setup on the
// face list as its first phases over the grid (cpr_cell.cuh, as csrc/
// cpr.cu's pair: a thread per cell forms its D^-1, weights and pressure
// diagonal, a grid barrier, a thread per face its two couplings from the
// weights of its cells; into buffers the hierarchy owns), a grid barrier,
// then the refresh's phases from that pressure system. A Newton's pressure
// setup on a gather grid is then one launch and the inverse, where it was
// three launches (K6's cell part, K6-faces, the refresh) and the inverse.
// The setup walked a thread per cell over the list's incidence CSR in one
// phase measured slower here (PERF.md).
//
// What bounds it on the card: at the Norne-class sizes (level 0: 75,566
// cells, about 10 MB of values, in L2) the barriers (two per level in the
// down leg, one in the up leg, one per phase of the refresh) and each
// phase's chain of dependent loads (a row's gathers x[cols[k]], a CSR's
// pointer, index and value), not device memory.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop.cuh"
#include "cpr_cell.cuh"

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

// ---------------------------------------------------------------------------
// the per-Newton value refresh: one cooperative launch, a phase per
// coarsening step and a grid barrier between two phases

// the refresh's first record: level 0's diag copy and ELL values with the
// entry of each slot (src0, -1 at a padding slot, whose value stays 0), and
// the coarsest level's values and column ids with its float32 dense matrix
// (null when the coarsest is not inverted)
struct RefreshHead {
    const int* src0;
    double* diag0;
    double* vals0;
    const double* diag_c;
    const double* vals_c;
    const int* cols_c;
    float* dense;
    long long n0, m0, n_c, K_c;
};

constexpr int kHeadFields = 11;
static_assert(sizeof(RefreshHead) == kHeadFields * 8, "RefreshHead layout");

// one coarsening step k -> k+1: level k's diag and ELL values (null at
// k = 0, where they are the refresh's inputs diag0 and off0), the children
// of each aggregate (CSR by aggregate, fine index ascending), the level-k
// entries folded into each coarse diagonal row and those merged into each
// coarse entry (CSRs by output, entry index ascending; each entry as its
// position in level k's values: off0's face order at k = 0, its ELL slot
// below), each coarse entry's ELL slot, and level k+1's diag and ELL values
struct StepRec {
    const double* diag;
    const double* vals;
    const int* cptr;
    const int* cidx;
    const int* fptr;
    const int* fpos;
    const int* eptr;
    const int* epos;
    const int* edst;
    double* diag_c;
    double* vals_c;
    long long n_c, nnz_c;
};

static_assert(sizeof(StepRec) == 13 * 8, "StepRec layout");

// sum over e = ptr[t] .. ptr[t+1]-1 of v[idx[e]], in that order
__device__ __forceinline__ double csr_sum(const int* ptr, const int* idx,
                                          const double* v, int t) {
    double acc = 0.0;
    for (int e = ptr[t]; e < ptr[t + 1]; ++e) acc = acc + v[idx[e]];
    return acc;
}

// phase k, outputs first, first + stride, ...: at k = 0 level 0's diag
// copy (n0) and ELL slots (m0); then, where there is a step k, its coarse
// diagonal rows (segment sums of the children's diag plus those of the
// folded entries) and its coarse entries, each into its ELL slot
__device__ void refresh_phase(const RefreshHead& H, const StepRec* S, int k,
                              int nL, const double* diag0,
                              const double* off0, long long first,
                              long long stride) {
    const long long lead = k == 0 ? H.n0 + H.m0 : 0;
    StepRec R{};
    if (k < nL) R = S[k];
    const double* dv = k == 0 ? diag0 : R.diag;
    const double* ov = k == 0 ? off0 : R.vals;
    const long long m = lead + R.n_c + R.nnz_c;
    for (long long u = first; u < m; u += stride) {
        if (u < lead) {
            if (u < H.n0) {
                H.diag0[u] = diag0[u];
            } else {
                const long long j = u - H.n0;
                const int s = H.src0[j];
                if (s >= 0) H.vals0[j] = off0[s];
            }
        } else if (u < lead + R.n_c) {
            const int t = (int)(u - lead);
            const double s1 = csr_sum(R.cptr, R.cidx, dv, t);
            const double s2 = csr_sum(R.fptr, R.fpos, ov, t);
            R.diag_c[t] = s1 + s2;
        } else {
            const int t = (int)(u - lead - R.n_c);
            R.vals_c[R.edst[t]] = csr_sum(R.eptr, R.epos, ov, t);
        }
    }
}

// the float32 dense coarsest matrix, one thread per entry (r, c): the
// diagonal value at (r, r), then each ELL slot k = 0, 1, ... of row r whose
// column is c added in float64 (the padding self-loops add 0.0 at (r, r)),
// rounded once
__device__ void dense_phase(const RefreshHead& H, long long first,
                            long long stride) {
    const long long n = H.n_c;
    for (long long u = first; u < n * n; u += stride) {
        const int r = (int)(u / n);
        const int c = (int)(u - r * n);
        double acc = r == c ? H.diag_c[r] : 0.0;
        for (int k = 0; k < H.K_c; ++k) {
            const long long s = (long long)k * n + r;
            if (H.cols_c[s] == c) acc = acc + H.vals_c[s];
        }
        H.dense[u] = __double2float_rn(acc);
    }
}

// the phases over the grid, a grid barrier between two, then, when the
// coarsest is inverted, the dense matrix
__device__ __forceinline__ void refresh_phases(cg::grid_group& grid,
                                               const long long* T, int nL,
                                               const double* diag0,
                                               const double* off0) {
    const RefreshHead H = *reinterpret_cast<const RefreshHead*>(T);
    const StepRec* S = reinterpret_cast<const StepRec*>(T + kHeadFields);
    const int phases = nL > 0 ? nL : 1;
    for (int k = 0; k < phases; ++k) {
        if (k) grid.sync();
        refresh_phase(H, S, k, nL, diag0, off0, first_index(),
                      grid_stride());
    }
    if (H.dense) {
        grid.sync();
        dense_phase(H, first_index(), grid_stride());
    }
}

__global__ void __launch_bounds__(kThreads, 2)
amg_refresh(const long long* T, int nL, const double* diag0,
            const double* off0) {
    cg::grid_group grid = cg::this_grid();
    refresh_phases(grid, T, nL, diag0, off0);
}

// K6's setup on the face list (csrc/cpr.cu's setup_cells and faces_kernel)
// as the refresh's first phases: its arguments, the level-0 matrix diag_p
// and off (face order) the outputs that the refresh then reads
struct FaceSetup {
    const int* c1;
    const int* c2;
    const double* diag;
    const double* fL;
    const double* fR;
    double* dinv;
    double* w;
    double* diag_p;
    double* off;
    long long nc, n, f0, nfs;
};

// the setup's cell part (a thread per cell), a grid barrier, its face part
// (a thread per face, from the weights of its two cells), a grid barrier,
// then the refresh's phases from its diag_p and off
__global__ void __launch_bounds__(kThreads, 2)
amg_refresh_setup(const long long* T, int nL, FaceSetup P) {
    cg::grid_group grid = cg::this_grid();
    for (long long c = first_index(); c < P.nc; c += grid_stride()) {
        double wc[3];
        opm_cpr::setup_cell(P.nc, c, P.diag, P.dinv, P.w, P.diag_p, wc);
    }
    grid.sync();
    for (long long t = first_index(); t < P.n; t += grid_stride())
        opm_cpr::face_couplings(t, P.n, P.f0, P.nfs, P.nc, P.c1, P.c2, P.w,
                                P.fL, P.fR, P.off);
    grid.sync();
    refresh_phases(grid, T, nL, P.diag_p, P.off);
}

}  // namespace

extern "C" {

// the grids of the two legs on the current device for legs whose largest
// level has work_down and work_up threads' worth: out[0], out[1] the grids;
// out[2] the SM count; out[3], out[4] co-resident blocks per SM of down and
// up; out[5], out[6] their registers per thread
int opm_amg_grid(long long work_down, long long work_up, int* out) {
    int nsm = 0;
    cudaError_t err = opm_coop::coop_sms(&nsm);
    if (err == cudaSuccess)
        err = opm_coop::coop_grid((const void*)amg_down, kThreads, work_down,
                                  nsm, &out[0], &out[3], &out[5]);
    if (err == cudaSuccess)
        err = opm_coop::coop_grid((const void*)amg_up, kThreads, work_up,
                                  nsm, &out[1], &out[4], &out[6]);
    out[2] = nsm;
    return (int)err;
}

// the refresh's grid for a largest phase of work outputs: out[0] the grid,
// out[1] the SM count, out[2] co-resident blocks per SM, out[3] registers
// per thread; setup: of the refresh with K6's setup as its first phase
int opm_amg_refresh_grid(long long work, int setup, int* out) {
    int nsm = 0;
    cudaError_t err = opm_coop::coop_sms(&nsm);
    if (err == cudaSuccess)
        err = opm_coop::coop_grid(
            setup ? (const void*)amg_refresh_setup : (const void*)amg_refresh,
            kThreads, work, nsm, &out[0], &out[2], &out[3]);
    out[1] = nsm;
    return (int)err;
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

// the refresh: table its head record, then one record per coarsening step
// (linalg/amg.py packs the same order); diag0 (n0) and off0 (the level-0
// entries in face order) the pressure system's values
int opm_amg_refresh(const void* table, int nL, const double* diag0,
                    const double* off0, int grid, cudaStream_t stream) {
    const long long* T = static_cast<const long long*>(table);
    void* args[] = {&T, &nL, &diag0, &off0};
    return (int)cudaLaunchCooperativeKernel((const void*)amg_refresh,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

// the refresh with K6's setup on the face list as its first phases: the
// setup's arguments (the face list's cells c1, c2 (n) of faces f0 .. f0 + n
// of the face arrays, row stride nfs), then the refresh's from diag_p and
// off
int opm_amg_refresh_setup(const void* table, int nL, long long nc,
                          long long n, long long f0, long long nfs,
                          const int* c1, const int* c2, const double* diag,
                          const double* fL, const double* fR, double* dinv,
                          double* w, double* diag_p, double* off, int grid,
                          cudaStream_t stream) {
    const long long* T = static_cast<const long long*>(table);
    FaceSetup P{c1, c2, diag, fL, fR, dinv, w, diag_p, off, nc, n, f0, nfs};
    void* args[] = {&T, &nL, &P};
    return (int)cudaLaunchCooperativeKernel((const void*)amg_refresh_setup,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

}  // extern "C"
