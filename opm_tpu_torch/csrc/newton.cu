// K9: the Newton update and the convergence check for Hopper, one launch
// each.
//
// Replaces the JAX package's solver/update.py update_state (:19-149: the
// Appleyard chops, the saturation scaling and renormalisation, the rs/rv
// chops and the hydrocarbon-state switch, with the rs_sat/rv_sat lookups
// of props/blackoil.py) and models/blackoil.py BlackoilModel.convergence
// (:447-465: the CNV max and MB sum norms, masked on embedded grids, the
// well norms and the two flags), which XLA fused on the TPU.
//
// update   one thread per cell: reads p, sw, x, hcstate and the three
//          cell increments (a (3, nc) array: the CPR route's du_c, or the
//          first 3 nc values of the dense route's flat du), applies omega
//          to each increment (one product, as omega * du), chops the
//          pressure, looks up rs_sat (PVTO's curve, under DISGAS) and
//          rv_sat (PVTG's curve, under VAPOIL) at the old and the new
//          pressure on the cell's PVT region row (tables.cuh's
//          coord1/interp1: K1's device code, which K2 shares; a ratio
//          without its table is 0), scales and renormalises the
//          saturations, chops rs/rv,
//          switches the state and writes p, sw, x and hcstate. One extra
//          block does the well rows: the bhp chop and qs. Every product,
//          sum and IEEE division in the plain version's order (build with
//          --fmad=false), so every output equals the twins' composition
//          (update_pressure_plain, K1's rs_sat and rv_sat,
//          update_cells_plain) bit for bit.
// converge each block reduces a grid-stride share of the cells to 11
//          partials (per phase the NaN-propagating max of |R| B / pv, the
//          sums of R and of B = 1 / max(b, 1e-300); the sums of pv and of
//          the 0/1 padding mask, which multiplies every cell term on an
//          embedded grid); the block that takes the last ticket (one
//          acquire-release atomic per workspace, wells.cuh's last_block,
//          reset by that block) sums the partials in block order, forms
//          cnv, mb and b_avg with the reference's final products, the
//          well-flux and well-control norms (nw = 0: both 0) and the
//          finite and converged flags, and writes the Newton loop's history
//          row [mb(3), cnv(3), well_flux, well_ctrl, finite, converged].
//          The grid is the co-resident blocks (the occupancy query, at
//          most what nc needs: no second wave), each thread a grid-stride
//          share (a grid of four blocks per SM, a second wave at 80
//          registers, ran 1.5x slower; several cells' loads in flight per
//          thread and other launch bounds gained nothing measurable,
//          PERF.md). Sums
//          run in a fixed order (a thread's cells in grid-stride order, a
//          shuffle tree per block, the blocks in index order): the same
//          bits run after run, and within 1e-12 relative of torch's sums.
//
// What bounds them on the card: memory traffic. The update moves 80 bytes
// a cell (p, sw, x, the three increments and hcstate read, p, sw, x and
// hcstate written; the tables stay in L1), the norms 56 (R and b, 3
// phases, and pv; 64 with the mask); neither reuses data. The design
// removes the launches and the passes around them: the update's 12
// launches (the cat and scaling of the increment, the pressure chop, two
// K1 lookups, two zero fills, the cell pass, four well ops) become one,
// and the check's two Triton launches and ~25 small torch ops one.

#include <cuda_runtime.h>
#include <math.h>

#include "tables.cuh"
#include "wells.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = 11;       // partials per block
constexpr double kEpsSw = 1.4901161193847656e-08;   // sqrt(double epsilon)
constexpr int kCtrlBhp = 0;      // wells/wells.py CTRL_BHP

// NaN-propagating maximum and minimum (torch.maximum, torch.clamp)
__device__ __forceinline__ double max_n(double a, double b) {
    return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ double min_n(double a, double b) {
    return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ double clamp_n(double v, double lo, double hi) {
    return min_n(max_n(v, lo), hi);
}

// ---------------------------------------------------------------------------
// update

struct Update {
    long long nc;
    int nw, cell_blocks;
    const double *p, *sw, *x;
    const int* hc;
    const double* du;            // (3, nc)
    const double* dbhp;          // stride sb
    const double* dqs;           // rows of stride sq, 3 values each
    long long sb, sq;
    const double *bhp, *qs;      // (nw), (nw, 3)
    const double *xs, *ys;       // rs_sat table (nreg, n), or null
    int n;
    const long long* reg;        // (nc) PVT regions, or null (one region)
    const double *vxs, *vys;     // rv_sat table (nreg, nv), or null
    int nv;
    const long long* vreg;       // (nc) PVT regions, or null (one region)
    double omega, dp_max_rel, ds_max, dr_max_rel;
    int disgas, vapoil;
    double *p_out, *sw_out, *x_out;
    int* hc_out;
    double *bhp_out, *qs_out;
};

// a saturated ratio's table row (xs, ys of n nodes) at p; 0 without one
__device__ __forceinline__ double sat_at(const double* xs, const double* ys,
                                         int n, long long r, double p) {
    if (!xs) return 0.0;
    opm_tables::Coord1 c = opm_tables::coord1(xs + r * n, n, p, 0);
    double v, s;
    opm_tables::interp1(c, ys + r * n, &v, &s);
    return v;
}

__device__ __forceinline__ void update_cell(const Update& a, long long c) {
    const long long nc = a.nc;
    const double p0 = a.p[c], sw0 = a.sw[c], x = a.x[c];
    const int hc = a.hc[c];
    const double dp = a.omega * a.du[c];
    const double dsw = a.omega * a.du[nc + c];
    const double dx = a.omega * a.du[2 * nc + c];
    // the pressure chop
    const double lim = a.dp_max_rel * fabs(p0);
    const double pn = p0 - clamp_n(dp, -lim, lim);
    const long long r = a.reg ? a.reg[c] : 0;
    const double rssat0 = sat_at(a.xs, a.ys, a.n, r, p0);
    const double rssat = sat_at(a.xs, a.ys, a.n, r, pn);
    const long long rv = a.vreg ? a.vreg[c] : 0;
    const double rvsat0 = sat_at(a.vxs, a.vys, a.nv, rv, p0);
    const double rvsat = sat_at(a.vxs, a.vys, a.nv, rv, pn);
    // update_cells_plain, operation for operation
    const bool is_sg = hc == 0, is_rs = hc == 1, is_rv = hc == 2;
    const double sg_old = is_sg ? x : (is_rv ? 1.0 - sw0 : 0.0);
    const double so_old = (1.0 - sw0) - sg_old;
    const double dsg = (is_sg ? dx : 0.0) - (is_rv ? dsw : 0.0);
    const double dso = -(dsw + dsg);
    const double max_ds = max_n(max_n(fabs(dsw), fabs(dsg)), fabs(dso));
    const double scale = a.ds_max / max_n(max_ds, a.ds_max);
    double sw = sw0 - scale * dsw;
    double sg_new = sg_old - scale * dsg;
    double so_upd = so_old - scale * dso;
    const double neg_g = min_n(sg_new, 0.0);
    sw = sw / (1.0 - neg_g);
    so_upd = so_upd / (1.0 - neg_g);
    sg_new = max_n(sg_new, 0.0);
    const double neg_o = min_n(so_upd, 0.0);
    sw = sw / (1.0 - neg_o);
    sg_new = sg_new / (1.0 - neg_o);
    so_upd = max_n(so_upd, 0.0);
    const double neg_w = min_n(sw, 0.0);
    so_upd = so_upd / (1.0 - neg_w);
    sg_new = sg_new / (1.0 - neg_w);
    sw = max_n(sw, 0.0);
    const double rs_old = is_rs ? x : 0.0;
    const double drs = is_rs ? dx : 0.0;
    const double lim_rs = max_n(fabs(rs_old) * a.dr_max_rel, 1.0);
    double rs_new = rs_old - clamp_n(drs, -lim_rs, lim_rs);
    const double rv_old = is_rv ? x : 0.0;
    const double drv = is_rv ? dx : 0.0;
    const double lim_rv = max_n(fabs(rv_old) * a.dr_max_rel, 1e-3);
    double rv_new = rv_old - clamp_n(drv, -lim_rv, lim_rv);
    const bool wat_only = sw > (1.0 - kEpsSw);
    int hc_new = 0;
    if (a.disgas) {
        const bool has_gas = (sg_new > 0.0) && !is_rs;
        const bool gas_vap = is_rs && (rs_new > rssat * (1.0 + kEpsSw))
                             && (rs_old > rssat0 * (1.0 - kEpsSw));
        if (!(wat_only || has_gas || gas_vap)) hc_new = 1;
    }
    if (a.vapoil) {
        const bool has_oil = (so_upd > 0.0) && !is_rv;
        const bool oil_cond = is_rv && (rv_new > rvsat * (1.0 + kEpsSw))
                              && (rv_old > rvsat0 * (1.0 - kEpsSw));
        if (!(wat_only || has_oil || oil_cond)) hc_new = 2;
    }
    double x_new = hc_new == 0
                       ? (wat_only ? 0.0 : clamp_n(sg_new, 0.0, 1.0))
                       : 0.0;
    rs_new = max_n(rs_new, -0.05 * rssat);
    rv_new = max_n(rv_new, -0.05 * rvsat);
    if (hc_new == 1) x_new = is_rs ? rs_new : rssat;
    if (hc_new == 2) x_new = is_rv ? rv_new : rvsat;
    a.p_out[c] = pn;
    a.sw_out[c] = clamp_n(sw, 0.0, 1.0);
    a.x_out[c] = x_new;
    a.hc_out[c] = hc_new;
}

__global__ void __launch_bounds__(kThreads) k9_update(Update a) {
    if ((int)blockIdx.x < a.cell_blocks) {
        const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
        if (c < a.nc) update_cell(a, c);
        return;
    }
    // the well rows (StandardWells_impl.hpp:613-703)
    for (int w = threadIdx.x; w < a.nw; w += kThreads) {
        const double b0 = a.bhp[w];
        const double lim = a.dp_max_rel * fabs(b0);
        a.bhp_out[w] = b0 - clamp_n(a.omega * a.dbhp[w * a.sb], -lim, lim);
        for (int i = 0; i < 3; ++i)
            a.qs_out[3 * w + i] = a.qs[3 * w + i]
                                  - a.omega * a.dqs[w * a.sq + i];
    }
}

// ---------------------------------------------------------------------------
// convergence

// NM maxima and NS sums of each thread, reduced over the block in a fixed
// order (a shuffle tree per warp, then over the warps); valid in thread 0.
// sh: kWarps * (NM + NS) doubles.
template <int NM, int NS>
__device__ __forceinline__ void block_reduce(double (&mx)[NM],
                                             double (&sm)[NS], double* sh) {
    for (int o = 16; o > 0; o >>= 1) {
        for (int i = 0; i < NM; ++i)
            mx[i] = max_n(mx[i], __shfl_down_sync(0xffffffffu, mx[i], o));
        for (int i = 0; i < NS; ++i)
            sm[i] += __shfl_down_sync(0xffffffffu, sm[i], o);
    }
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (lane == 0) {
        for (int i = 0; i < NM; ++i) sh[w * (NM + NS) + i] = mx[i];
        for (int i = 0; i < NS; ++i) sh[w * (NM + NS) + NM + i] = sm[i];
    }
    __syncthreads();
    if (w == 0) {
        for (int i = 0; i < NM; ++i)
            mx[i] = lane < kWarps ? sh[lane * (NM + NS) + i] : -INFINITY;
        for (int i = 0; i < NS; ++i)
            sm[i] = lane < kWarps ? sh[lane * (NM + NS) + NM + i] : 0.0;
        for (int o = kWarps / 2; o > 0; o >>= 1) {
            for (int i = 0; i < NM; ++i)
                mx[i] = max_n(mx[i],
                              __shfl_down_sync(0xffffffffu, mx[i], o));
            for (int i = 0; i < NS; ++i)
                sm[i] += __shfl_down_sync(0xffffffffu, sm[i], o);
        }
    }
    __syncthreads();
}

struct Converge {
    long long nc;
    const double *R, *b, *pv, *mask;   // (3, nc), (3, nc), (nc), (nc) or null
    double dt;
    int nw;
    const double* wf;                  // (nw, 3)
    const double* wc;                  // (nw)
    const int* control;                // (nw)
    const double* target;              // (nw)
    double tol_mb, tol_cnv, tol_wells, max_res;
    double* part;                      // (gridDim.x, kParts)
    unsigned int* ticket;
    double* row;                       // (10)
};

// one cell's terms into the thread's maxima and sums (the plain version's
// products and quotients; the mask multiplies every term)
__device__ __forceinline__ void add_cell(const Converge& a, const double* r,
                                         const double* bb, double v,
                                         double mk, double (&mx)[3],
                                         double (&sm)[8]) {
    for (int ph = 0; ph < 3; ++ph) {
        double rr = r[ph];
        double B = 1.0 / max_n(bb[ph], 1e-300);
        double cv = fabs(rr) * B / v;
        if (a.mask) {
            cv = cv * mk;
            rr = rr * mk;
            B = B * mk;
        }
        mx[ph] = max_n(mx[ph], cv);
        sm[ph] += rr;
        sm[3 + ph] += B;
    }
    if (a.mask) v = v * mk;
    sm[6] += v;
    sm[7] += mk;
}

__global__ void __launch_bounds__(kThreads) k9_converge(Converge a) {
    __shared__ double sh[kWarps * kParts];
    const long long nc = a.nc;
    // per phase: max |R| B / pv; then per phase sum R, sum B, sum pv, and
    // the mask's sum (the cell count of the masked 1/b average)
    double mx[3] = {-INFINITY, -INFINITY, -INFINITY};
    double sm[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    const long long T = (long long)gridDim.x * kThreads;
    for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
         c < nc; c += T) {
        double r[3], bb[3];
        for (int ph = 0; ph < 3; ++ph) {
            r[ph] = a.R[ph * nc + c];
            bb[ph] = a.b[ph * nc + c];
        }
        add_cell(a, r, bb, a.pv[c], a.mask ? a.mask[c] : 1.0, mx, sm);
    }
    block_reduce(mx, sm, sh);
    if (threadIdx.x == 0) {
        double* p = a.part + (long long)blockIdx.x * kParts;
        for (int i = 0; i < 3; ++i) p[i] = mx[i];
        for (int i = 0; i < 8; ++i) p[3 + i] = sm[i];
    }
    if (!opm_wells::last_block(a.ticket)) return;

    // the last block: the partials in block order, then the well norms
    for (int i = 0; i < 3; ++i) mx[i] = -INFINITY;
    for (int i = 0; i < 8; ++i) sm[i] = 0.0;
    for (int g = threadIdx.x; g < (int)gridDim.x; g += kThreads) {
        const double* p = a.part + (long long)g * kParts;
        for (int i = 0; i < 3; ++i) mx[i] = max_n(mx[i], __ldcg(p + i));
        for (int i = 0; i < 8; ++i) sm[i] += __ldcg(p + 3 + i);
    }
    block_reduce(mx, sm, sh);
    // per phase max_w |well_flux|, then the bhp wells' max |ctrl| and the
    // rate wells' max |ctrl| / max(|target|, 1e-8) (maxima: exact in any
    // order)
    double wm[5] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
    double none[1] = {0.0};
    for (int w = threadIdx.x; w < a.nw; w += kThreads) {
        for (int i = 0; i < 3; ++i)
            wm[i] = max_n(wm[i], fabs(a.wf[3 * w + i]));
        const double e = fabs(a.wc[w]);
        const bool bhp = a.control[w] == kCtrlBhp;
        wm[3] = max_n(wm[3], bhp ? e : 0.0);
        wm[4] = max_n(wm[4],
                      bhp ? 0.0 : e / max_n(fabs(a.target[w]), 1e-8));
    }
    block_reduce(wm, none, sh);
    if (threadIdx.x != 0) return;
    double mb[3], cnv[3], b_avg[3];
    for (int ph = 0; ph < 3; ++ph) {
        cnv[ph] = a.dt * mx[ph];
        b_avg[ph] = a.mask ? sm[3 + ph] / sm[7] : sm[3 + ph] / (double)nc;
        mb[ph] = a.dt * fabs(sm[ph]) * b_avg[ph] / sm[6];
    }
    double wflux = 0.0, wctrl = 0.0;
    if (a.nw > 0) {
        wflux = max_n(max_n(b_avg[0] * wm[0], b_avg[1] * wm[1]),
                      b_avg[2] * wm[2]);
        wctrl = wm[3] / 1e5 + wm[4];
    }
    bool conv = wflux < a.tol_wells && wctrl < 1e-3;
    bool fin = isfinite(wflux);
    for (int ph = 0; ph < 3; ++ph) {
        conv = conv && mb[ph] < a.tol_mb && cnv[ph] < a.tol_cnv;
        fin = fin && isfinite(mb[ph]) && isfinite(cnv[ph])
              && mb[ph] < a.max_res && cnv[ph] < a.max_res;
    }
    for (int ph = 0; ph < 3; ++ph) {
        a.row[ph] = mb[ph];
        a.row[3 + ph] = cnv[ph];
    }
    a.row[6] = wflux;
    a.row[7] = wctrl;
    a.row[8] = fin ? 1.0 : 0.0;
    a.row[9] = conv ? 1.0 : 0.0;
}

}  // namespace

extern "C" {

// the convergence check's grid on the current device: out[0] the SM count,
// out[1] k9_converge's co-resident blocks per SM, out[2] its registers
int opm_k9_grid(int* out) {
    int dev = 0, nsm = 0, nb = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &nb, (const void*)k9_converge, kThreads, 0);
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&fa, (const void*)k9_converge);
    if (err != cudaSuccess) return (int)err;
    out[0] = nsm;
    out[1] = nb;
    out[2] = fa.numRegs;
    return 0;
}

// the Newton update: p, sw, x (nc) float64, hc (nc) int32; du the cell
// increments (3, nc); dbhp (stride sb) and dqs (rows of stride sq) the
// well increments; bhp (nw), qs (nw, 3); xs, ys the rs_sat table (nreg, n)
// (null: rs_sat = 0), reg the PVT region of each cell (null: one region);
// vxs, vys, nv, vreg the same of the rv_sat table; the outputs p_out,
// sw_out, x_out, hc_out, bhp_out, qs_out
int opm_k9_update(long long nc, int nw, const double* p, const double* sw,
                  const double* x, const int* hc, const double* du,
                  const double* dbhp, long long sb, const double* dqs,
                  long long sq, const double* bhp, const double* qs,
                  const double* xs, const double* ys, int n,
                  const long long* reg, const double* vxs, const double* vys,
                  int nv, const long long* vreg, double omega,
                  double dp_max_rel,
                  double ds_max, double dr_max_rel, int disgas, int vapoil,
                  double* p_out, double* sw_out, double* x_out, int* hc_out,
                  double* bhp_out, double* qs_out, cudaStream_t stream) {
    Update a;
    a.nc = nc;
    a.nw = nw;
    a.cell_blocks = (int)((nc + kThreads - 1) / kThreads);
    a.p = p;
    a.sw = sw;
    a.x = x;
    a.hc = hc;
    a.du = du;
    a.dbhp = dbhp;
    a.dqs = dqs;
    a.sb = sb;
    a.sq = sq;
    a.bhp = bhp;
    a.qs = qs;
    a.xs = xs;
    a.ys = ys;
    a.n = n;
    a.reg = reg;
    a.vxs = vxs;
    a.vys = vys;
    a.nv = nv;
    a.vreg = vreg;
    a.omega = omega;
    a.dp_max_rel = dp_max_rel;
    a.ds_max = ds_max;
    a.dr_max_rel = dr_max_rel;
    a.disgas = disgas;
    a.vapoil = vapoil;
    a.p_out = p_out;
    a.sw_out = sw_out;
    a.x_out = x_out;
    a.hc_out = hc_out;
    a.bhp_out = bhp_out;
    a.qs_out = qs_out;
    const int blocks = a.cell_blocks + (nw > 0 ? 1 : 0);
    if (blocks == 0) return 0;
    k9_update<<<blocks, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

// the convergence check on G blocks (at most the co-resident ones, a grid
// stride each): R, b (3, nc), pv (nc), mask (nc) or
// null; the well residuals wf (nw, 3), wc (nw), control (nw) int32, target
// (nw); part (G * 11) and ticket (0 between launches) the workspace; row
// (10) the history row
int opm_k9_convergence(long long nc, int G, const double* R, const double* b,
                       const double* pv, const double* mask, double dt,
                       int nw, const double* wf, const double* wc,
                       const int* control, const double* target,
                       double tol_mb, double tol_cnv, double tol_wells,
                       double max_res, double* part, unsigned int* ticket,
                       double* row, cudaStream_t stream) {
    Converge a;
    a.nc = nc;
    a.R = R;
    a.b = b;
    a.pv = pv;
    a.mask = mask;
    a.dt = dt;
    a.nw = nw;
    a.wf = wf;
    a.wc = wc;
    a.control = control;
    a.target = target;
    a.tol_mb = tol_mb;
    a.tol_cnv = tol_cnv;
    a.tol_wells = tol_wells;
    a.max_res = max_res;
    a.part = part;
    a.ticket = ticket;
    a.row = row;
    k9_converge<<<G, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
