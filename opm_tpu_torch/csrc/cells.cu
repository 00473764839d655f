// K2: the black-oil cell quantities and the accumulation with their three
// tangent columns (in p, sw, x), one thread per cell, for Hopper.
//
// Replaces the JAX package's models/blackoil.py compute_cell_quantities
// (:95-147, with the wet-gas PVTG branch and rv_sat under VAPOIL of
// props/blackoil.py :47-131) and accumulation_from_q (:165), and the
// tangent columns that
// linearize.assemble seeds by jax.linearize with all-ones per primary
// (models/linearize.py:141-161, 175-187); on the TPU XLA fused them into
// the assembly's elementwise passes.
//
// Two entry points:
//   opm_cells_eval: the CellQuantities rows (18 per cell: pw, po, pg, b,
//     mob, rho, rs, rv, sat, pv_mult) for the residual, the accumulation
//     and the perforation cells; with qcols also their three tangent
//     columns (3, 18, n), which the forward-mode rule of
//     models/blackoil.py contracts with the input tangents;
//   opm_cells_assemble: the face inputs (11 rows: p3, rho, b mob, rs, rv)
//     and their three tangent columns (3, 11, n), r_cell = pv/dt (acc -
//     acc0) and the nine diag rows pv/dt d acc_i / d u_j, with the
//     degenerate-x weight times pv/dt added to row 8
//     (models/linearize.py degenerate_x_mask).
//
// What bounds it on the card: memory traffic. Per cell it reads p, sw, x,
// the hydrocarbon state and two region indices, and writes 18 (values),
// 54 (columns) or 56 (assembly) float64 rows; the tables are a few hundred
// doubles read through the cache. Design: one thread per cell evaluates
// the plain formula once, templated on its number type: plain double for
// the values entry (no tangent is computed, about a quarter of the
// arithmetic and registers), Dual3 (dual3.cuh) for the columns and the
// assembly entries, so values and tangents come from one pass with no
// table lookup repeated. Each quantity goes to the entry's sink as soon
// as it is final (few are live at once), and each kernel carries
// __launch_bounds__ from a measured sweep (block size and blocks per SM:
// OPM_K2_* below, opm_tpu_torch/tools/assembly_ab.py --sweep). The
// lookups share K1's device code (tables.cuh), so the segment and the
// one-sided slope at a node are K1's. The branch conventions are the
// plain version's: torch.where zeroes the tangent of the branch not taken,
// maximum(a, 0) splits a tie 1/2, clamp extrapolation has slope 0 outside,
// and divisions are divisions (mu = ib / ibm, then kr / mu), so values
// equal the plain version bit for bit with --fmad=false (the double run's
// values are the Dual3 run's value parts, the same expressions) and
// tangents agree to the last bits (torch's jvp orders some sums
// differently).
//
// The tables arrive as one float64 buffer and a host array of offsets
// (Layout in pack.cuh; built once per case by props/blackoil.py
// CellPack).

#include <cuda_runtime.h>
#include <math.h>

#include "dual3.cuh"
#include "pack.cuh"
#include "tables.cuh"

namespace {

using opm_dual::chain1;
using opm_dual::chain2;
using opm_dual::constant;
using opm_dual::Dual3;
using opm_dual::maximum0;
using opm_dual::primary;
using opm_dual::select;
using opm_dual::value;
using opm_pack::kMeta;
using opm_pack::Layout;
using opm_pack::layout_of;
using opm_pack::row_of;
using opm_tables::Coord1;
using opm_tables::coord1;

// threads per block and the __launch_bounds__ minimum of resident blocks
// per SM: the values entry (double) and the two Dual3 entries. From the
// sweep at SPE10-2's size (tools/assembly_ab.py --sweep, H100): the values
// entry takes 64 registers and runs 8 blocks of 128 per SM at every
// setting; the Dual3 entries take 126-130 registers, and a minimum of 4
// blocks of 128 (at most 128 registers, no spills) runs the assembly
// entry in 0.30 ms against 0.35 at 3 blocks
#ifndef OPM_K2_VAL_THREADS
#define OPM_K2_VAL_THREADS 128
#endif
#ifndef OPM_K2_VAL_MINB
#define OPM_K2_VAL_MINB 4
#endif
#ifndef OPM_K2_DUAL_THREADS
#define OPM_K2_DUAL_THREADS 128
#endif
#ifndef OPM_K2_DUAL_MINB
#define OPM_K2_DUAL_MINB 4
#endif
constexpr int kValThreads = OPM_K2_VAL_THREADS;
constexpr int kDualThreads = OPM_K2_DUAL_THREADS;

// the CellQuantities rows (models/blackoil.py q_rows)
enum Row {
    R_PW = 0, R_PO = 1, R_PG = 2, R_B = 3, R_MOB = 6, R_RHO = 9, R_RS = 12,
    R_RV = 13, R_SAT = 14, R_PVM = 17, N_ROWS = 18
};

// a 1-D table column at the query q (value and chained tangent)
template <class T>
__device__ __forceinline__ T col1(const Coord1& c, const double* y,
                                  const T& q) {
    double v, s;
    opm_tables::interp1(c, y, &v, &s);
    return chain1(v, s, q);
}

// compute_cell_quantities and accumulation_from_q of one cell in the
// number type T; each quantity goes to the sink as soon as it is final:
// out.row(r, q) for CellQuantities row r, out.acc(i, a) for the
// accumulation of phase i
template <class T, class Sink>
__device__ __forceinline__ void eval_cell(const Layout& L,
                                          const double* __restrict__ tab,
                                          double p_, double sw_, double x_,
                                          int hc, long long rp,
                                          long long rsat, Sink& out) {
    const T P = primary<T>(p_, 0), SW = primary<T>(sw_, 1),
            X = primary<T>(x_, 2);
    const T zero = constant<T>(0.0);
    const bool is_sg = hc == 0, is_rs = hc == 1, is_rv = hc == 2;
    const T SG = select(is_sg, X, select(is_rv, 1.0 - SW, zero));
    const T SO = (1.0 - SW) - SG;
    out.row(R_PO, P);
    out.row(R_SAT, SW);
    out.row(R_SAT + 1, SO);
    out.row(R_SAT + 2, SG);
    T PVM = constant<T>(1.0);
    if (L.rock) {
        const int rr = row_of(L.r_nreg, rp);
        const T XR = (P - tab[L.r_pref + rr]) * tab[L.r_comp + rr];
        PVM = (1.0 + XR) + (0.5 * XR) * XR;
    }
    out.row(R_PVM, PVM);

    // dissolved gas: rs = x (undersaturated) or the saturated curve
    T RS = zero;
    const int ro = L.live ? row_of(L.ol_nreg, rp) : 0;
    const double* rs_tab = tab + L.ol_rs + ro * L.ol_nrec;
    const double* pb_tab = tab + L.ol_pbub + ro * L.ol_nrec;
    if (is_rs) {
        RS = X;
    } else if (L.disgas) {
        RS = col1(coord1(pb_tab, L.ol_nrec, value(P), 0), rs_tab, P);
    }
    // vaporized oil: rv = x (undersaturated gas) or, under VAPOIL, PVTG's
    // saturated curve at the oil pressure
    T RV = zero;
    const int rgw = L.wet ? row_of(L.gw_nreg, rp) : 0;
    const double* pg_tab = tab + L.gw_pg + rgw * L.gw_nrec;
    const double* rvs_tab = tab + L.gw_rv + rgw * L.gw_nrec;
    if (is_rv) {
        RV = X;
    } else if (L.vapoil) {
        RV = col1(coord1(pg_tab, L.gw_nrec, value(P), 0), rvs_tab, P);
    }
    out.row(R_RS, RS);
    out.row(R_RV, RV);

    // saturation functions (SWOF/SGOF family 1, clamped) and the ECLIPSE
    // default three-phase oil relperm
    const int rsf = row_of(L.s_nreg, rsat);
    const Coord1 cw = coord1(tab + L.s_sw + rsf * L.s_nw, L.s_nw, value(SW),
                             1);
    const double* wc = tab + L.s_wc + rsf * 3 * L.s_nw;
    T KRW = col1(cw, wc, SW);
    const T KROW = col1(cw, wc + L.s_nw, SW);
    const T PCOW = col1(cw, wc + 2 * L.s_nw, SW);
    const Coord1 cg = coord1(tab + L.s_sg + rsf * L.s_ng, L.s_ng, value(SG),
                             1);
    const double* gc = tab + L.s_gc + rsf * 3 * L.s_ng;
    T KRG = col1(cg, gc, SG);
    const T KROG = col1(cg, gc + L.s_ng, SG);
    const T PCGO = col1(cg, gc + 2 * L.s_ng, SG);
    const T SSW = maximum0(SW - tab[L.s_swco + rsf]);
    const T DEN = SSW + SG;
    T KRO = value(DEN) > 1e-12 ? (SSW * KROW + SG * KROG) / DEN : KROW;
    KRO = select(value(SO) > 0.0, KRO, zero);
    KRG = select(value(SG) > 0.0, KRG, zero);
    KRW = select(value(SW) > 0.0, KRW, zero);
    const T PW = P - PCOW;
    const T PG = P + PCGO;
    out.row(R_PW, PW);
    out.row(R_PG, PG);

    const int rd = row_of(L.d_nreg, rp);
    const double sdw = tab[L.d_sd + 3 * rd];
    const double sdo = tab[L.d_sd + 3 * rd + 1];
    const double sdg = tab[L.d_sd + 3 * rd + 2];

    // water (PVTW)
    const int rw = row_of(L.w_nreg, rp);
    const double w_pref = tab[L.w_pref + rw];
    const T XW = (PW - w_pref) * tab[L.w_comp + rw];
    const T BW = ((1.0 + XW) + (0.5 * XW) * XW) / tab[L.w_bref + rw];
    const T YW = (PW - w_pref) * tab[L.w_visc + rw];
    const T MUW = tab[L.w_muref + rw] / ((1.0 + YW) + (0.5 * YW) * YW);
    out.row(R_B, BW);
    out.row(R_MOB, KRW / MUW);
    out.row(R_RHO, sdw * BW);
    out.acc(0, PVM * (BW * SW));

    // oil: PVTO over (rs, p - p_bub(rs)), or PVDO over p
    T BO, MUO;
    if (L.live) {
        const T PB = col1(coord1(rs_tab, L.ol_nrec, value(RS), 0), pb_tab,
                          RS);
        const T DP = maximum0(P - PB);
        const Coord1 cx = coord1(rs_tab, L.ol_nrec, value(RS), 0);
        const Coord1 cy = coord1(tab + L.ol_dp + ro * L.ol_ndp, L.ol_ndp,
                                 value(DP), 0);
        const int nn = L.ol_nrec * L.ol_ndp;
        const double* grid = tab + L.ol_grid + ro * 2 * nn;
        double v, dx, dy;
        opm_tables::interp2(cx, cy, grid, L.ol_ndp, &v, &dx, &dy);
        const T IB = chain2(v, dx, dy, RS, DP);
        opm_tables::interp2(cx, cy, grid + nn, L.ol_ndp, &v, &dx, &dy);
        const T IBM = chain2(v, dx, dy, RS, DP);
        BO = IB;
        MUO = IB / IBM;
    } else {
        const int r = row_of(L.od_nreg, rp);
        const Coord1 c = coord1(tab + L.od_x + r * L.od_n, L.od_n, value(P),
                                0);
        const double* y = tab + L.od_y + r * 2 * L.od_n;
        const T IB = col1(c, y, P);
        BO = IB;
        MUO = IB / col1(c, y + L.od_n, P);
    }
    out.row(R_B + 1, BO);
    out.row(R_MOB + 1, KRO / MUO);
    out.row(R_RHO + 1, (sdo + RS * sdg) * BO);

    // gas: PVTG over (pg, drv = max(rv_sat(pg) - rv, 0)) with rv_sat at
    // the gas pressure, or PVDG over pg (or the inert placeholder of a
    // two-phase deck)
    T BG, MUG;
    if (L.wet) {
        const Coord1 cx = coord1(pg_tab, L.gw_nrec, value(PG), 0);
        const T DRV = maximum0(col1(cx, rvs_tab, PG) - RV);
        const Coord1 cy = coord1(tab + L.gw_drv + rgw * L.gw_nd, L.gw_nd,
                                 value(DRV), 0);
        const int nn = L.gw_nrec * L.gw_nd;
        const double* grid = tab + L.gw_grid + rgw * 2 * nn;
        double v, dx, dy;
        opm_tables::interp2(cx, cy, grid, L.gw_nd, &v, &dx, &dy);
        const T IB = chain2(v, dx, dy, PG, DRV);
        opm_tables::interp2(cx, cy, grid + nn, L.gw_nd, &v, &dx, &dy);
        const T IBM = chain2(v, dx, dy, PG, DRV);
        BG = IB;
        MUG = IB / IBM;
    } else {
        const int rg = row_of(L.g_nreg, rp);
        const Coord1 cgp = coord1(tab + L.g_x + rg * L.g_n, L.g_n, value(PG),
                                  0);
        const double* gy = tab + L.g_y + rg * 2 * L.g_n;
        BG = col1(cgp, gy, PG);
        MUG = BG / col1(cgp, gy + L.g_n, PG);
    }
    out.row(R_B + 2, BG);
    out.row(R_MOB + 2, KRG / MUG);
    out.row(R_RHO + 2, (sdg + RV * sdo) * BG);
    out.acc(1, PVM * (BO * SO + (RV * BG) * SG));
    out.acc(2, PVM * (BG * SG + (RS * BO) * SO));
}

struct Inputs {
    long long n;
    const double* p;
    const double* sw;
    const double* x;
    const int* hc;
    const long long* pvt;
    const long long* sat;
};

template <class T, class Sink>
__device__ __forceinline__ void load_eval(const Layout& L, const double* tab,
                                          const Inputs& in, long long c,
                                          Sink& out) {
    eval_cell<T>(L, tab, in.p[c], in.sw[c], in.x[c], in.hc[c],
                 in.pvt ? in.pvt[c] : 0, in.sat ? in.sat[c] : 0, out);
}

// the values entry: the CellQuantities rows (18, n); the accumulation is
// not wanted
struct ValuesSink {
    double* out;
    long long n, c;
    __device__ void row(int r, double v) { out[r * n + c] = v; }
    __device__ void acc(int, double) {}
};

// the columns entry: the rows' tangent columns (3, 18, n), and their
// values (18, n) when out is set
struct ColumnsSink {
    double* out;
    double* cols;
    long long n, c;
    __device__ void row(int r, const Dual3& d) {
        if (out) out[r * n + c] = d.v;
        for (int k = 0; k < 3; ++k) cols[(k * N_ROWS + r) * n + c] = d.t[k];
    }
    __device__ void acc(int, const Dual3&) {}
};

// the assembly entry: the face inputs (11 rows: p3, rho, b mob, rs, rv)
// and their tangent columns (3, 11, n), r_cell = pv/dt (acc - acc0) and
// the nine diag rows pv/dt d acc_i / d u_j
struct AssembleSink {
    double* fv;
    double* fc;
    double* r_cell;
    double* diag;
    const double* acc0;
    long long n, c;
    double pvdt;
    int hc;
    double so, sg;
    Dual3 b[3];

    __device__ void face(int r, const Dual3& d) {
        fv[r * n + c] = d.v;
        for (int k = 0; k < 3; ++k) fc[(k * 11 + r) * n + c] = d.t[k];
    }
    __device__ void row(int r, const Dual3& d) {
        if (r <= R_PG) {
            face(r, d);
        } else if (r < R_MOB) {
            b[r - R_B] = d;
        } else if (r < R_RHO) {
            face(r, b[r - R_MOB] * d);
        } else if (r < R_RS) {
            face(r - R_RHO + 3, d);
        } else if (r == R_RS || r == R_RV) {
            face(r - R_RS + 9, d);
        } else if (r == R_SAT + 1) {
            so = d.v;
        } else if (r == R_SAT + 2) {
            sg = d.v;
        }
    }
    __device__ void acc(int i, const Dual3& a) {
        r_cell[i * n + c] = pvdt * (a.v - acc0[i * n + c]);
        for (int j = 0; j < 2 + (i < 2); ++j)
            diag[(3 * i + j) * n + c] = pvdt * a.t[j];
        if (i < 2) return;
        // the degenerate-x regularisation: an rs cell's gas-equation x
        // column scales with so, an rv cell's with sg; weight
        // clip(1 - s / 1e-5, 0, 1)
        const double s = hc == 1 ? so : (hc == 2 ? sg : 1.0);
        double m = 1.0 - s / 1e-5;
        m = m < 0.0 ? 0.0 : (m > 1.0 ? 1.0 : m);
        diag[8 * n + c] = pvdt * a.t[2] + m * pvdt;
    }
};

__global__ void __launch_bounds__(OPM_K2_VAL_THREADS, OPM_K2_VAL_MINB)
    cells_values_kernel(Layout L, const double* __restrict__ tab, Inputs in,
                        double* __restrict__ out) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= in.n) return;
    ValuesSink s{out, in.n, c};
    load_eval<double>(L, tab, in, c, s);
}

__global__ void __launch_bounds__(OPM_K2_DUAL_THREADS, OPM_K2_DUAL_MINB)
    cells_columns_kernel(Layout L, const double* __restrict__ tab, Inputs in,
                         double* __restrict__ out,
                         double* __restrict__ qcols) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= in.n) return;
    ColumnsSink s{out, qcols, in.n, c};
    load_eval<Dual3>(L, tab, in, c, s);
}

__global__ void __launch_bounds__(OPM_K2_DUAL_THREADS, OPM_K2_DUAL_MINB)
    cells_assemble_kernel(Layout L, const double* __restrict__ tab,
                          Inputs in, const double* __restrict__ acc0,
                          const double* __restrict__ pv, double dt,
                          double* __restrict__ fv, double* __restrict__ fc,
                          double* __restrict__ r_cell,
                          double* __restrict__ diag) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= in.n) return;
    AssembleSink s{fv, fc, r_cell, diag, acc0, in.n, c, pv[c] / dt,
                   in.hc[c], 0.0, 0.0, {}};
    load_eval<Dual3>(L, tab, in, c, s);
}

inline int blocks_for(long long n, int threads) {
    return (int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int opm_cells_meta_len() { return kMeta; }

// p, sw, x (n) float64; hc (n) int32; pvt, sat (n) int64 or null (one
// region). Without qcols: the values (18, n) into out, in double. With
// qcols: the tangent columns (3, 18, n), and the values into out unless
// out is null, in Dual3.
int opm_cells_eval(const double* tab, const int* meta, long long n,
                   const double* p, const double* sw, const double* x,
                   const int* hc, const long long* pvt, const long long* sat,
                   double* out, double* qcols, cudaStream_t stream) {
    if (n == 0) return 0;
    Inputs in{n, p, sw, x, hc, pvt, sat};
    if (qcols)
        cells_columns_kernel<<<blocks_for(n, kDualThreads), kDualThreads, 0,
                               stream>>>(layout_of(meta), tab, in, out,
                                         qcols);
    else
        cells_values_kernel<<<blocks_for(n, kValThreads), kValThreads, 0,
                              stream>>>(layout_of(meta), tab, in, out);
    return (int)cudaGetLastError();
}

// acc0 (3, n), pv (n); fv (11, n), fc (3, 11, n), r_cell (3, n),
// diag (9, n)
int opm_cells_assemble(const double* tab, const int* meta, long long n,
                       const double* p, const double* sw, const double* x,
                       const int* hc, const long long* pvt,
                       const long long* sat, const double* acc0,
                       const double* pv, double dt, double* fv, double* fc,
                       double* r_cell, double* diag, cudaStream_t stream) {
    if (n == 0) return 0;
    Inputs in{n, p, sw, x, hc, pvt, sat};
    cells_assemble_kernel<<<blocks_for(n, kDualThreads), kDualThreads, 0,
                            stream>>>(layout_of(meta), tab, in, acc0, pv, dt,
                                      fv, fc, r_cell, diag);
    return (int)cudaGetLastError();
}

// per entry (values, columns, assembly): threads per block, resident
// blocks per SM, registers per thread and local memory per thread (bytes:
// spills) on the current device; out (12)
int opm_cells_occupancy(int* out) {
    const void* fns[3] = {(const void*)cells_values_kernel,
                          (const void*)cells_columns_kernel,
                          (const void*)cells_assemble_kernel};
    const int threads[3] = {kValThreads, kDualThreads, kDualThreads};
    for (int k = 0; k < 3; ++k) {
        cudaFuncAttributes a;
        int err = (int)cudaFuncGetAttributes(&a, fns[k]);
        if (err) return err;
        int blocks = 0;
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fns[k], threads[k], 0);
        if (err) return err;
        out[4 * k] = threads[k];
        out[4 * k + 1] = blocks;
        out[4 * k + 2] = a.numRegs;
        out[4 * k + 3] = (int)a.localSizeBytes;
    }
    return 0;
}

}  // extern "C"
