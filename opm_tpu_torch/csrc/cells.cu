// K2: the black-oil cell quantities and the accumulation with their three
// tangent columns (in p, sw, x), one thread per cell, for Hopper.
//
// Replaces the JAX package's models/blackoil.py compute_cell_quantities
// (:95-147) and accumulation_from_q (:165), and the tangent columns that
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
// the hydrocarbon state and two region indices, and writes 18 (values) to
// 56 (assembly) float64 rows; the tables are a few hundred doubles read
// through the cache. Design: one thread per cell evaluates the plain
// formula once in Dual3 arithmetic (dual3.cuh), so values and tangents
// come from one pass with no table lookup repeated; the lookups share K1's
// device code (tables.cuh), so the segment and the one-sided slope at a
// node are K1's. The branch conventions are the plain version's:
// torch.where zeroes the tangent of the branch not taken, maximum(a, 0)
// splits a tie 1/2, clamp extrapolation has slope 0 outside, and
// divisions are divisions (mu = ib / ibm, then kr / mu), so values equal
// the plain version bit for bit with --fmad=false and tangents agree to
// the last bits (torch's jvp orders some sums differently).
//
// The tables arrive as one float64 buffer and a host array of offsets
// (Layout; built once per case by props/blackoil.py CellPack).

#include <cuda_runtime.h>
#include <math.h>

#include "dual3.cuh"
#include "tables.cuh"

namespace {

using opm_dual::Dual3;
using opm_dual::chain1;
using opm_dual::chain2;
using opm_dual::constant;
using opm_dual::maximum0;
using opm_dual::primary;
using opm_dual::select;
using opm_tables::Coord1;
using opm_tables::coord1;

constexpr int kThreads = 128;

// Offsets (in doubles) into the table buffer; the order of the host array
// (props/blackoil.py CellPack.META).
struct Layout {
    int live, disgas, rock;
    int w_nreg, w_pref, w_bref, w_comp, w_muref, w_visc;
    int od_nreg, od_n, od_x, od_y;
    int ol_nreg, ol_nrec, ol_ndp, ol_rs, ol_pbub, ol_dp, ol_grid;
    int g_nreg, g_n, g_x, g_y;
    int s_nreg, s_nw, s_sw, s_wc, s_ng, s_sg, s_gc, s_swco;
    int r_nreg, r_pref, r_comp;
    int d_nreg, d_sd;
};
constexpr int kMeta = sizeof(Layout) / sizeof(int);

struct Quantities {
    Dual3 pw, po, pg, b[3], mob[3], rho[3], rs, rv, sat[3], pvm, acc[3];
};

__device__ __forceinline__ int row_of(int nreg, long long r) {
    return nreg == 1 ? 0 : (int)r;
}

// a 1-D table column at the query q (value and chained tangent)
__device__ __forceinline__ Dual3 col1(const Coord1& c, const double* y,
                                      const Dual3& q) {
    double v, s;
    opm_tables::interp1(c, y, &v, &s);
    return chain1(v, s, q);
}

// compute_cell_quantities and accumulation_from_q of one cell
__device__ void eval_cell(const Layout& L, const double* __restrict__ tab,
                          double p_, double sw_, double x_, int hc,
                          long long rp, long long rsat, Quantities& q) {
    const Dual3 P = primary(p_, 0), SW = primary(sw_, 1), X = primary(x_, 2);
    const Dual3 zero = constant(0.0);
    const bool is_sg = hc == 0, is_rs = hc == 1, is_rv = hc == 2;
    const Dual3 SG = select(is_sg, X, select(is_rv, 1.0 - SW, zero));
    const Dual3 SO = (1.0 - SW) - SG;

    // dissolved gas: rs = x (undersaturated) or the saturated curve
    Dual3 RS = zero;
    const int ro = L.live ? row_of(L.ol_nreg, rp) : 0;
    const double* rs_tab = tab + L.ol_rs + ro * L.ol_nrec;
    const double* pb_tab = tab + L.ol_pbub + ro * L.ol_nrec;
    if (is_rs) {
        RS = X;
    } else if (L.disgas) {
        RS = col1(coord1(pb_tab, L.ol_nrec, P.v, 0), rs_tab, P);
    }
    const Dual3 RV = select(is_rv, X, zero);

    // saturation functions (SWOF/SGOF family 1, clamped) and the ECLIPSE
    // default three-phase oil relperm
    const int rsf = row_of(L.s_nreg, rsat);
    const Coord1 cw = coord1(tab + L.s_sw + rsf * L.s_nw, L.s_nw, SW.v, 1);
    const double* wc = tab + L.s_wc + rsf * 3 * L.s_nw;
    Dual3 KRW = col1(cw, wc, SW);
    const Dual3 KROW = col1(cw, wc + L.s_nw, SW);
    const Dual3 PCOW = col1(cw, wc + 2 * L.s_nw, SW);
    const Coord1 cg = coord1(tab + L.s_sg + rsf * L.s_ng, L.s_ng, SG.v, 1);
    const double* gc = tab + L.s_gc + rsf * 3 * L.s_ng;
    Dual3 KRG = col1(cg, gc, SG);
    const Dual3 KROG = col1(cg, gc + L.s_ng, SG);
    const Dual3 PCGO = col1(cg, gc + 2 * L.s_ng, SG);
    const Dual3 SSW = maximum0(SW - tab[L.s_swco + rsf]);
    const Dual3 DEN = SSW + SG;
    Dual3 KRO = DEN.v > 1e-12 ? (SSW * KROW + SG * KROG) / DEN : KROW;
    KRO = select(SO.v > 0.0, KRO, zero);
    KRG = select(SG.v > 0.0, KRG, zero);
    KRW = select(SW.v > 0.0, KRW, zero);
    const Dual3 PW = P - PCOW;
    const Dual3 PG = P + PCGO;

    // water (PVTW)
    const int rw = row_of(L.w_nreg, rp);
    const double w_pref = tab[L.w_pref + rw];
    const Dual3 XW = (PW - w_pref) * tab[L.w_comp + rw];
    const Dual3 BW = ((1.0 + XW) + (0.5 * XW) * XW) / tab[L.w_bref + rw];
    const Dual3 YW = (PW - w_pref) * tab[L.w_visc + rw];
    const Dual3 MUW = tab[L.w_muref + rw] / ((1.0 + YW) + (0.5 * YW) * YW);

    // oil: PVTO over (rs, p - p_bub(rs)), or PVDO over p
    Dual3 BO, MUO;
    if (L.live) {
        const Dual3 PB = col1(coord1(rs_tab, L.ol_nrec, RS.v, 0), pb_tab, RS);
        const Dual3 DP = maximum0(P - PB);
        const Coord1 cx = coord1(rs_tab, L.ol_nrec, RS.v, 0);
        const Coord1 cy = coord1(tab + L.ol_dp + ro * L.ol_ndp, L.ol_ndp,
                                 DP.v, 0);
        const int nn = L.ol_nrec * L.ol_ndp;
        const double* grid = tab + L.ol_grid + ro * 2 * nn;
        double v, dx, dy;
        opm_tables::interp2(cx, cy, grid, L.ol_ndp, &v, &dx, &dy);
        const Dual3 IB = chain2(v, dx, dy, RS, DP);
        opm_tables::interp2(cx, cy, grid + nn, L.ol_ndp, &v, &dx, &dy);
        const Dual3 IBM = chain2(v, dx, dy, RS, DP);
        BO = IB;
        MUO = IB / IBM;
    } else {
        const int r = row_of(L.od_nreg, rp);
        const Coord1 c = coord1(tab + L.od_x + r * L.od_n, L.od_n, P.v, 0);
        const double* y = tab + L.od_y + r * 2 * L.od_n;
        const Dual3 IB = col1(c, y, P);
        BO = IB;
        MUO = IB / col1(c, y + L.od_n, P);
    }
    // gas (PVDG, or the inert placeholder of a two-phase deck)
    const int rg = row_of(L.g_nreg, rp);
    const Coord1 cgp = coord1(tab + L.g_x + rg * L.g_n, L.g_n, PG.v, 0);
    const double* gy = tab + L.g_y + rg * 2 * L.g_n;
    const Dual3 BG = col1(cgp, gy, PG);
    const Dual3 MUG = BG / col1(cgp, gy + L.g_n, PG);

    const int rd = row_of(L.d_nreg, rp);
    const double sdw = tab[L.d_sd + 3 * rd];
    const double sdo = tab[L.d_sd + 3 * rd + 1];
    const double sdg = tab[L.d_sd + 3 * rd + 2];

    q.pw = PW;
    q.po = P;
    q.pg = PG;
    q.b[0] = BW;
    q.b[1] = BO;
    q.b[2] = BG;
    q.mob[0] = KRW / MUW;
    q.mob[1] = KRO / MUO;
    q.mob[2] = KRG / MUG;
    q.rho[0] = sdw * BW;
    q.rho[1] = (sdo + RS * sdg) * BO;
    q.rho[2] = (sdg + RV * sdo) * BG;
    q.rs = RS;
    q.rv = RV;
    q.sat[0] = SW;
    q.sat[1] = SO;
    q.sat[2] = SG;
    if (L.rock) {
        const int rr = row_of(L.r_nreg, rp);
        const Dual3 XR = (P - tab[L.r_pref + rr]) * tab[L.r_comp + rr];
        q.pvm = (1.0 + XR) + (0.5 * XR) * XR;
    } else {
        q.pvm = constant(1.0);
    }
    q.acc[0] = q.pvm * (BW * SW);
    q.acc[1] = q.pvm * (BO * SO + (RV * BG) * SG);
    q.acc[2] = q.pvm * (BG * SG + (RS * BO) * SO);
}

__device__ __forceinline__ void put(double* rows, long long n, int row,
                                    long long c, double v) {
    rows[row * n + c] = v;
}

// tangent column k of a (nrows, n) block: (3, nrows, n)
__device__ __forceinline__ void put_cols(double* cols, long long n, int nrows,
                                         int row, long long c,
                                         const Dual3& d) {
    for (int k = 0; k < 3; ++k) cols[(k * nrows + row) * n + c] = d.t[k];
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

__device__ __forceinline__ void load_eval(const Layout& L, const double* tab,
                                          const Inputs& in, long long c,
                                          Quantities& q) {
    eval_cell(L, tab, in.p[c], in.sw[c], in.x[c], in.hc[c],
              in.pvt ? in.pvt[c] : 0, in.sat ? in.sat[c] : 0, q);
}

// the CellQuantities rows (18, n) and, when qcols, their tangent columns
// (3, 18, n)
__global__ void cells_eval_kernel(Layout L, const double* __restrict__ tab,
                                  Inputs in, double* __restrict__ out,
                                  double* __restrict__ qcols) {
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= in.n) return;
    Quantities q;
    load_eval(L, tab, in, c, q);
    auto emit = [&](int r, const Dual3& d) {
        put(out, in.n, r, c, d.v);
        if (qcols) put_cols(qcols, in.n, 18, r, c, d);
    };
    emit(0, q.pw);
    emit(1, q.po);
    emit(2, q.pg);
    for (int k = 0; k < 3; ++k) {
        emit(3 + k, q.b[k]);
        emit(6 + k, q.mob[k]);
        emit(9 + k, q.rho[k]);
        emit(14 + k, q.sat[k]);
    }
    emit(12, q.rs);
    emit(13, q.rv);
    emit(17, q.pvm);
}

// the assembly's cell part: face inputs and their tangent columns,
// r_cell and diag
__global__ void cells_assemble_kernel(Layout L, const double* __restrict__ tab,
                                      Inputs in,
                                      const double* __restrict__ acc0,
                                      const double* __restrict__ pv, double dt,
                                      double* __restrict__ fv,
                                      double* __restrict__ fc,
                                      double* __restrict__ r_cell,
                                      double* __restrict__ diag) {
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= in.n) return;
    const long long n = in.n;
    Quantities q;
    load_eval(L, tab, in, c, q);
    auto emit = [&](int r, const Dual3& d) {
        put(fv, n, r, c, d.v);
        put_cols(fc, n, 11, r, c, d);
    };
    emit(0, q.pw);
    emit(1, q.po);
    emit(2, q.pg);
    for (int k = 0; k < 3; ++k) {
        emit(3 + k, q.rho[k]);
        emit(6 + k, q.b[k] * q.mob[k]);
    }
    emit(9, q.rs);
    emit(10, q.rv);
    const double pvdt = pv[c] / dt;
    for (int i = 0; i < 3; ++i) {
        put(r_cell, n, i, c, pvdt * (q.acc[i].v - acc0[i * n + c]));
        for (int j = 0; j < 3; ++j)
            put(diag, n, 3 * i + j, c, pvdt * q.acc[i].t[j]);
    }
    // the degenerate-x regularisation: an rs cell's gas-equation x column
    // scales with so, an rv cell's with sg; weight clip(1 - s / 1e-5, 0, 1)
    const int hc = in.hc[c];
    const double s = hc == 1 ? q.sat[1].v : (hc == 2 ? q.sat[2].v : 1.0);
    double m = 1.0 - s / 1e-5;
    m = m < 0.0 ? 0.0 : (m > 1.0 ? 1.0 : m);
    diag[8 * n + c] = pvdt * q.acc[2].t[2] + m * pvdt;
}

Layout layout_of(const int* meta) {
    Layout L;
    int* dst = reinterpret_cast<int*>(&L);
    for (int k = 0; k < kMeta; ++k) dst[k] = meta[k];
    return L;
}

inline int blocks_for(long long n) {
    return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int opm_cells_meta_len() { return kMeta; }

// p, sw, x (n) float64; hc (n) int32; pvt, sat (n) int64 or null (one
// region); out (18, n); qcols (3, 18, n) or null
int opm_cells_eval(const double* tab, const int* meta, long long n,
                   const double* p, const double* sw, const double* x,
                   const int* hc, const long long* pvt, const long long* sat,
                   double* out, double* qcols, cudaStream_t stream) {
    if (n == 0) return 0;
    Inputs in{n, p, sw, x, hc, pvt, sat};
    cells_eval_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        layout_of(meta), tab, in, out, qcols);
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
    cells_assemble_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        layout_of(meta), tab, in, acc0, pv, dt, fv, fc, r_cell, diag);
    return (int)cudaGetLastError();
}

}  // extern "C"
