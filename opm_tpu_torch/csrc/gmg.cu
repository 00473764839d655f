// K7: the structured-GMG V-cycle for Hopper, as two cooperative launches,
// and its per-Newton value refresh, as one.
//
// Replaces the JAX package's linalg/gmg.py StructuredGmg._matvec (:171),
// _smooth (:200) and the level work of _vcycle3 (:295-312): the damped
// Jacobi sweeps, the residual with its _pairsum restriction and the
// _repeat2 prolongation, which XLA fused on the TPU into shifted-slice
// passes, one level after another.
//
// A level is a scalar 7-point stencil on (nz, ny, nx): diagonal d and per
// axis the couplings aL (to the next cell along the axis) and aR (to the
// previous one), each face array one shorter than the level along its
// axis; an odd axis carries one ghost slab (diagonal 0, couplings 0). The
// V-cycle (one pre- and one post-smoothing sweep, omega = 0.8) runs as
//
//   down  (the right-hand side entry) first level 0's b, the CPR apply's
//         weighted pressure residual (w0 r0 + w1 r1) + w2 r2 per cell (K6's
//         pressure_rhs, linalg/precond.py:299-301, the same expression)
//         into the workspace, then a grid barrier, since the zero-start
//         sweep below reads b at neighbouring cells; then
//         for each level l = 0 .. L-1, over the next level's cells: the
//         pair sum along the level's axis of the residual b - A x of the
//         zero-start sweep x = 0 + 0.8 (b - A 0) / d (d = 1 where |d| <=
//         1e-300), the next level's ghost slab 0; x is evaluated where it
//         is needed, from b, and never stored; the last level writes the
//         coarsest right-hand side rounded to float32;
//   (between the two: the float32 product with the coarsest inverse, one
//         library call, as the reference leaves it to XLA);
//   up    for each level l = L-1 .. 0, over the level's cells: one sweep
//         on x + the coarse correction replicated along the axis, with x
//         again the zero-start sweep evaluated from b; level 0 writes its
//         real cells (its ghost slab dropped) into the V-cycle's output.
//
// Each leg is one cooperative launch with a grid barrier between levels;
// a level's cells are a grid-stride loop. The levels' arrays, sizes and
// workspace pointers are a table on the device (one record of eight-byte
// fields per level, uploaded once per set of level values by
// linalg/gmg.py, which packs the same order). Every row sums in the
// reference's order (diagonal, then per axis z, y, x the next cell's aL
// term and the previous cell's aR term), so each level's right-hand side
// and correction are bitwise those of the plain per-level version; no
// atomics, and the grid's size changes no bit.
//
// What bounds it on the card: memory traffic at level 0 (per cell seven
// coefficients and b, plus the output; the neighbours' coefficients that
// the recomputed x needs come from L1/L2), barriers on the coarse levels
// (L - 1 per leg instead of three launches per level). Measured at
// 1.122M cells (NVIDIA H100 80GB HBM3, chip_smoke.py): level 0 runs at
// 27-31% of its byte bound (each x costs 8 loads and a division at 7
// cells a row; 124 registers, 2 blocks per SM) and a coarse level ~7 us.
//
// The per-Newton value refresh (replaces StructuredGmg._coarsen_level
// :209, _pad_level :232, coarsen_values :244-274 and _dense_coarsest
// :276-293, jnp code that XLA fused on the TPU) is one cooperative launch
// more, writing into buffers the hierarchy owns (linalg/gmg.py Refresh,
// made once with the V-cycle workspace over them and this launch's table
// of phase records): phase 0 copies the pressure system's diag0 and face
// couplings (grid face order: x-faces, y-faces, z-faces, a_LR then a_RL)
// into level 0's arrays, phase l forms level l from level l-1 along
// level l-1's axis, and the last phase forms the coarsest level straight
// into the float32 dense coarsest matrix (its diagonal, plus 1.0 where
// |d| <= 1e-300, and aL at (lo, hi), aR at (hi, lo)); a grid barrier
// between two phases. One thread per output, a real cell's diagonal or a
// real face's pair (aL, aR), never a ghost slab: the buffers are zeroed
// once and the ghost slabs stay 0. The sums are the plain version's: the
// pair sums as torch's sum reduces them (from +0.0), then + aL + aR of the
// even fine face on the diagonal. What bounds it: the bytes of level 0
// (its copy and the first coarsening read and write every coupling) and
// the barriers of the coarse levels.
//
// Build with --fmad=false (products and sums round as the plain
// version's).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr double kOmega = 0.8;

// one level as the table holds it: its values, its right-hand side b and
// correction e in the workspace (null at level 0, whose b is the input and
// whose e is the output), its (ghost-padded) dims, the axis coarsened to
// the next level, and the dims (rz, ry, rx) of its b and e arrays (level
// 0: the real cells; every other level: its padded dims). The record after
// the last level holds the coarsest dims only.
struct LevelRec {
    const double* d;
    const double* aL[3];   // z, y, x
    const double* aR[3];
    double* b;
    double* e;
    long long nz, ny, nx;
    long long axis;
    long long rz, ry, rx;
};

struct Level {
    int nz, ny, nx;
    const double* d;
    const double* aL[3];
    const double* aR[3];
};

__device__ __forceinline__ Level level_of(const LevelRec& R) {
    Level L;
    L.nz = (int)R.nz;
    L.ny = (int)R.ny;
    L.nx = (int)R.nx;
    L.d = R.d;
    for (int a = 0; a < 3; ++a) {
        L.aL[a] = R.aL[a];
        L.aR[a] = R.aR[a];
    }
    return L;
}

// a level's right-hand side; cells outside the array (level 0's ghost
// slab) read 0, as the reference's zero padding
struct Rhs {
    const double* b;
    int rz, ry, rx;
    __device__ __forceinline__ double operator()(int k, int j, int i) const {
        return (k < rz && j < ry && i < rx)
                   ? b[((long long)k * ry + j) * rx + i]
                   : 0.0;
    }
};

struct ZeroX {
    __device__ __forceinline__ double operator()(int, int, int) const {
        return 0.0;
    }
};

// y = (A x) at (k, j, i), xc the iterate there
template <class X>
__device__ __forceinline__ double stencil(const Level& L, const X& xv,
                                          double xc, int k, int j, int i) {
    const long long ny = L.ny, nx = L.nx;
    double y = L.d[((long long)k * ny + j) * nx + i] * xc;
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

// one damped-Jacobi sweep of the iterate xv at (k, j, i)
template <class X>
__device__ __forceinline__ double sweep(const Level& L, const X& xv,
                                        const Rhs& b, int k, int j, int i) {
    double d = L.d[((long long)k * L.ny + j) * L.nx + i];
    double safe = fabs(d) > 1e-300 ? d : 1.0;
    double xc = xv(k, j, i);
    double y = stencil(L, xv, xc, k, j, i);
    return xc + kOmega * (b(k, j, i) - y) / safe;
}

// the pre-smoothed iterate: the sweep from zero, evaluated from b
struct PreX {
    Level L;
    Rhs b;
    __device__ __forceinline__ double operator()(int k, int j, int i) const {
        return sweep(L, ZeroX{}, b, k, j, i);
    }
};

// the pre-smoothed iterate plus the coarse correction e (dims *, ey, ex;
// float32 at the coarsest) of the parent cell
template <class E>
struct PostX {
    PreX pre;
    const E* e;
    int axis, ey, ex;
    __device__ __forceinline__ double operator()(int k, int j, int i) const {
        int pk = axis == 0 ? k >> 1 : k;
        int pj = axis == 1 ? j >> 1 : j;
        int pi = axis == 2 ? i >> 1 : i;
        return pre(k, j, i)
               + (double)e[((long long)pk * ey + pj) * ex + pi];
    }
};

__device__ __forceinline__ long long first_index() {
    return (long long)blockIdx.x * kThreads + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
    return (long long)gridDim.x * kThreads;
}

// down leg, level l: the next level's right-hand side (float32 after the
// last level)
__device__ void restrict_level(const LevelRec* T, int l, int L,
                               const double* in, float* bc) {
    const LevelRec& F = T[l];
    const LevelRec& C = T[l + 1];
    Level lev = level_of(F);
    Rhs b{l == 0 ? in : F.b, (int)F.rz, (int)F.ry, (int)F.rx};
    PreX x{lev, b};
    const int axis = (int)F.axis;
    const int cy = (int)C.ny, cx = (int)C.nx;
    // the real coarse cells: the level halved along the axis
    const int rz = axis == 0 ? lev.nz / 2 : lev.nz;
    const int ry = axis == 1 ? lev.ny / 2 : lev.ny;
    const int rx = axis == 2 ? lev.nx / 2 : lev.nx;
    const long long n = C.nz * C.ny * C.nx;
    for (long long c = first_index(); c < n; c += grid_stride()) {
        int I = (int)(c % cx);
        int J = (int)((c / cx) % cy);
        int K = (int)(c / ((long long)cx * cy));
        double v = 0.0;                    // the next level's ghost slab
        if (K < rz && J < ry && I < rx) {
            int k0 = axis == 0 ? 2 * K : K, k1 = axis == 0 ? 2 * K + 1 : K;
            int j0 = axis == 1 ? 2 * J : J, j1 = axis == 1 ? 2 * J + 1 : J;
            int i0 = axis == 2 ? 2 * I : I, i1 = axis == 2 ? 2 * I + 1 : I;
            double r0 = b(k0, j0, i0)
                        - stencil(lev, x, x(k0, j0, i0), k0, j0, i0);
            double r1 = b(k1, j1, i1)
                        - stencil(lev, x, x(k1, j1, i1), k1, j1, i1);
            v = r0 + r1;
        }
        if (l + 1 < L)
            C.b[c] = v;
        else
            bc[c] = __double2float_rn(v);
    }
}

// up leg, level l: the post-smoothing sweep of x + the prolonged
// correction en of level l + 1, into the level's e (level 0: the output)
template <class E>
__device__ void prolong_level(const LevelRec* T, int l, const double* in,
                              const E* en, double* out) {
    const LevelRec& F = T[l];
    const LevelRec& C = T[l + 1];
    Level lev = level_of(F);
    Rhs b{l == 0 ? in : F.b, (int)F.rz, (int)F.ry, (int)F.rx};
    PostX<E> x{PreX{lev, b}, en, (int)F.axis, (int)C.ny, (int)C.nx};
    double* dst = l == 0 ? out : F.e;
    const int ry = (int)F.ry, rx = (int)F.rx;
    const long long n = F.rz * F.ry * F.rx;
    for (long long c = first_index(); c < n; c += grid_stride()) {
        int i = (int)(c % rx);
        int j = (int)((c / rx) % ry);
        int k = (int)(c / ((long long)rx * ry));
        dst[c] = sweep(lev, x, b, k, j, i);
    }
}

// levels lo .. hi-1 of the down leg (the whole leg: 0 .. L); with w, the
// whole leg from the weighted residual (w, rc (3, n0)), level 0's b formed
// into in (the workspace's, n0 real cells) first
__global__ void __launch_bounds__(kThreads, 2)
gmg_down(const LevelRec* T, int L, int lo, int hi, double* in,
         const double* w, const double* rc, long long n0, float* bc) {
    if (w) {
        for (long long c = first_index(); c < n0; c += grid_stride())
            in[c] = (w[c] * rc[c] + w[n0 + c] * rc[n0 + c])
                    + w[2 * n0 + c] * rc[2 * n0 + c];
        cg::this_grid().sync();
    }
    if (L == 0) {                      // the coarsest level alone
        const long long n = T[0].nz * T[0].ny * T[0].nx;
        for (long long c = first_index(); c < n; c += grid_stride())
            bc[c] = __double2float_rn(in[c]);
        return;
    }
    cg::grid_group grid = cg::this_grid();
    for (int l = lo; l < hi; ++l) {
        if (l > lo) grid.sync();
        restrict_level(T, l, L, in, bc);
    }
}

// levels hi-1 .. lo of the up leg, ec the coarsest correction
__global__ void __launch_bounds__(kThreads, 2)
gmg_up(const LevelRec* T, int L, int lo, int hi, const double* in,
       const float* ec, double* out) {
    if (L == 0) {
        const long long n = T[0].nz * T[0].ny * T[0].nx;
        for (long long c = first_index(); c < n; c += grid_stride())
            out[c] = (double)ec[c];
        return;
    }
    cg::grid_group grid = cg::this_grid();
    for (int l = hi - 1; l >= lo; --l) {
        if (l < hi - 1) grid.sync();
        if (l + 1 == L)
            prolong_level<float>(T, l, in, ec, out);
        else
            prolong_level<double>(T, l, in, T[l + 1].e, out);
    }
}

// ---------------------------------------------------------------------------
// the per-Newton value refresh

// one phase of the refresh: its source level (null at phase 0, whose
// source is the inputs diag0 and off0), its destination level (null at
// the last phase, whose destination is the dense coarsest matrix), the
// source's (ghost-padded) dims, the axis coarsened (-1 at phase 0: a
// copy), the destination's (ghost-padded) dims and the dims of the real
// outputs
struct PhaseRec {
    const double* sd;
    const double* saL[3];   // z, y, x
    const double* saR[3];
    double* dd;
    double* daL[3];
    double* daR[3];
    long long sz, sy, sx;
    long long axis;
    long long qz, qy, qx;
    long long rz, ry, rx;
};

static_assert(sizeof(PhaseRec) == 24 * 8, "PhaseRec layout");

// flat index of (k, j, i) in an array of dims (*, ny, nx)
__device__ __forceinline__ long long at(int k, int j, int i, int ny,
                                        int nx) {
    return ((long long)k * ny + j) * nx + i;
}

// the flat index of (k, j, i) in the face array of axis b of a level of
// dims (nz, ny, nx): that array has one entry fewer along b
__device__ __forceinline__ long long face_at(int b, int k, int j, int i,
                                             int ny, int nx) {
    return at(k, j, i, b == 1 ? ny - 1 : ny, b == 2 ? nx - 1 : nx);
}

// a pair sum as torch's sum over a dim of two reduces it
__device__ __forceinline__ double pair(double x0, double x1) {
    return (0.0 + x0) + x1;
}

// a level's three face arrays (or three counts), z, y, x, picked by a
// runtime axis with selects: an indexed array would live in local memory
template <class T>
struct Axes {
    T z, y, x;
    __device__ __forceinline__ T operator()(int b) const {
        return b == 0 ? z : b == 1 ? y : x;
    }
};

// phase p's outputs first, first + stride, ...: the real cells' diagonal,
// then per axis z, y, x the real faces' (aL, aR)
__device__ void refresh_phase(const PhaseRec& P, bool first,
                              const double* diag0, const double* off0,
                              float* dense, long long first_out,
                              long long stride) {
    const int rz = (int)P.rz, ry = (int)P.ry, rx = (int)P.rx;
    const long long ncell = (long long)rz * ry * rx;
    const Axes<long long> nface{(long long)(rz - 1) * ry * rx,
                                (long long)rz * (ry - 1) * rx,
                                (long long)rz * ry * (rx - 1)};
    const double* sd = P.sd;
    Axes<const double*> sL{P.saL[0], P.saL[1], P.saL[2]};
    Axes<const double*> sR{P.saR[0], P.saR[1], P.saR[2]};
    if (first) {       // the inputs, in grid face order: x, y, z faces
        const long long nf = nface.z + nface.y + nface.x;
        sd = diag0;
        sL = Axes<const double*>{off0 + nface.x + nface.y, off0 + nface.x,
                                 off0};
        sR = Axes<const double*>{sL.z + nf, sL.y + nf, sL.x + nf};
    }
    double* const dd = P.dd;
    const Axes<double*> dL{P.daL[0], P.daL[1], P.daL[2]};
    const Axes<double*> dR{P.daR[0], P.daR[1], P.daR[2]};
    const int a = (int)P.axis;
    const int sy = (int)P.sy, sx = (int)P.sx;
    const int qy = (int)P.qy, qx = (int)P.qx;
    const long long n = ncell + nface.z + nface.y + nface.x;
    const long long n_c = ncell;              // the dense matrix's order
    for (long long u = first_out; u < n; u += stride) {
        int b = -1;                           // -1: a diagonal entry
        long long v = u - ncell;
        if (v < 0) {
            v = u;
        } else if (v < nface.z) {
            b = 0;
        } else if ((v -= nface.z) < nface.y) {
            b = 1;
        } else {
            v -= nface.y;
            b = 2;
        }
        // a level's arrays hold fewer than 2^31 entries
        const int ey = b == 1 ? ry - 1 : ry, ex = b == 2 ? rx - 1 : rx;
        const int vi = (int)v;
        const int i = vi % ex;
        const int j = (vi / ex) % ey;
        const int k = vi / (ex * ey);
        // the two fine cells (or faces) of a coarse one along a
        int k0 = k, j0 = j, i0 = i, k1 = k, j1 = j, i1 = i;
        if (a == 0) { k0 = 2 * k; k1 = k0 + 1; }
        if (a == 1) { j0 = 2 * j; j1 = j0 + 1; }
        if (a == 2) { i0 = 2 * i; i1 = i0 + 1; }
        if (b < 0) {
            double d;
            if (a < 0) {
                d = sd[at(k, j, i, sy, sx)];
            } else {
                const long long f = face_at(a, k0, j0, i0, sy, sx);
                d = pair(sd[at(k0, j0, i0, sy, sx)],
                         sd[at(k1, j1, i1, sy, sx)]);
                d = d + sL(a)[f];
                d = d + sR(a)[f];
            }
            if (dd) {
                dd[at(k, j, i, qy, qx)] = d;
            } else {
                const long long r = at(k, j, i, ry, rx);
                dense[r * n_c + r] = __double2float_rn(
                    d + (fabs(d) > 1e-300 ? 0.0 : 1.0));
            }
            continue;
        }
        const double* const fL = sL(b);
        const double* const fR = sR(b);
        double vL, vR;
        if (a < 0) {
            const long long f = face_at(b, k, j, i, sy, sx);
            vL = fL[f];
            vR = fR[f];
        } else if (b == a) {       // the odd fine face between two pairs
            const long long f = face_at(b, k1, j1, i1, sy, sx);
            vL = fL[f];
            vR = fR[f];
        } else {
            const long long f0 = face_at(b, k0, j0, i0, sy, sx);
            const long long f1 = face_at(b, k1, j1, i1, sy, sx);
            vL = pair(fL[f0], fL[f1]);
            vR = pair(fR[f0], fR[f1]);
        }
        if (dd) {
            const long long f = face_at(b, k, j, i, qy, qx);
            dL(b)[f] = vL;
            dR(b)[f] = vR;
        } else {
            // the coarse cell lo and its next cell hi along b; the plain
            // version accumulates onto 0.0 and adds the 0.0 off the
            // regularised diagonal
            const long long lo = at(k, j, i, ry, rx);
            const long long hi = lo + (b == 0 ? (long long)ry * rx
                                       : b == 1 ? rx : 1);
            dense[lo * n_c + hi] = __double2float_rn(vL + 0.0);
            dense[hi * n_c + lo] = __double2float_rn(vR + 0.0);
        }
    }
}

// phases 0 .. L over the grid, a grid barrier between two
__global__ void __launch_bounds__(kThreads)
gmg_refresh(const PhaseRec* T, int L, const double* diag0,
            const double* off0, float* dense) {
    cg::grid_group grid = cg::this_grid();
    for (int p = 0; p <= L; ++p) {
        if (p) grid.sync();
        refresh_phase(T[p], p == 0, diag0, off0, dense, first_index(),
                      grid_stride());
    }
}

}  // namespace

extern "C" {

// the grids of the two legs on the current device for legs whose largest
// level has work_down and work_up cells: out[0], out[1] the grids (at most
// the co-resident blocks, at most what the work needs); out[2] the SM
// count; out[3], out[4] co-resident blocks per SM of down and up; out[5],
// out[6] their registers per thread
int opm_gmg_grid(long long work_down, long long work_up, int* out) {
    int nsm = 0;
    cudaError_t err = opm_coop::coop_sms(&nsm);
    if (err == cudaSuccess)
        err = opm_coop::coop_grid((const void*)gmg_down, kThreads, work_down,
                                  nsm, &out[0], &out[3], &out[5]);
    if (err == cudaSuccess)
        err = opm_coop::coop_grid((const void*)gmg_up, kThreads, work_up,
                                  nsm, &out[1], &out[4], &out[6]);
    out[2] = nsm;
    return (int)err;
}

// table: the L + 1 level records; levels lo .. hi-1; in: level 0's right-hand
// side (the real cells); bc: the coarsest right-hand side, float32
int opm_gmg_down(const void* table, int L, int lo, int hi, double* in,
                 float* bc, int grid, cudaStream_t stream) {
    const LevelRec* T = static_cast<const LevelRec*>(table);
    const double* w = nullptr;
    const double* rc = nullptr;
    long long n0 = 0;
    void* args[] = {&T, &L, &lo, &hi, &in, &w, &rc, &n0, &bc};
    return (int)cudaLaunchCooperativeKernel((const void*)gmg_down,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

// the whole down leg from the CPR apply's weighted pressure residual: w,
// rc (3, n0) the weights and the cell residual, b0 (n0) level 0's
// right-hand side, written first (the up leg reads it)
int opm_gmg_down_rhs(const void* table, int L, const double* w,
                     const double* rc, double* b0, long long n0, float* bc,
                     int grid, cudaStream_t stream) {
    const LevelRec* T = static_cast<const LevelRec*>(table);
    int lo = 0, hi = L;
    double* in = b0;
    void* args[] = {&T, &L, &lo, &hi, &in, &w, &rc, &n0, &bc};
    return (int)cudaLaunchCooperativeKernel((const void*)gmg_down,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

// the refresh's grid for a largest phase of work outputs: out[0] the grid
// (at most the co-resident blocks, at most what the work needs), out[1]
// the SM count, out[2] co-resident blocks per SM, out[3] registers per
// thread
int opm_gmg_refresh_grid(long long work, int* out) {
    int nsm = 0;
    cudaError_t err = opm_coop::coop_sms(&nsm);
    if (err == cudaSuccess)
        err = opm_coop::coop_grid((const void*)gmg_refresh, kThreads, work,
                                  nsm, &out[0], &out[2], &out[3]);
    out[1] = nsm;
    return (int)err;
}

// the refresh: table the L + 1 phase records (linalg/gmg.py packs the
// same order); diag0 (nc) and off0 (2 nf, grid face order) the pressure
// system's values; dense the float32 (n_c, n_c) coarsest matrix, whose
// entries off the stencil stay as they are (zero)
int opm_gmg_refresh(const void* table, int L, const double* diag0,
                    const double* off0, float* dense, int grid,
                    cudaStream_t stream) {
    const PhaseRec* T = static_cast<const PhaseRec*>(table);
    void* args[] = {&T, &L, &diag0, &off0, &dense};
    return (int)cudaLaunchCooperativeKernel((const void*)gmg_refresh,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

// ec: the coarsest correction, float32; out: the V-cycle's result (level
// 0's real cells)
int opm_gmg_up(const void* table, int L, int lo, int hi, const double* in,
               const float* ec, double* out, int grid, cudaStream_t stream) {
    const LevelRec* T = static_cast<const LevelRec*>(table);
    void* args[] = {&T, &L, &lo, &hi, &in, &ec, &out};
    return (int)cudaLaunchCooperativeKernel((const void*)gmg_up, dim3(grid),
                                            dim3(kThreads), args, 0, stream);
}

}  // extern "C"
