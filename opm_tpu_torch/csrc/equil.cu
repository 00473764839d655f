// K1 in EQUIL's column march: the three hydrostatic phase-pressure
// columns of one equilibration region in one launch, for Hopper.
//
// Replaces the JAX package's sim/init.py _integrate_column (:46-76: two
// masked lax.scans from the anchor) with the densities rho_o, rho_w and
// rho_g (:108-124; rho_g with rv = rv_sat(p) under VAPOIL, the wet gas b
// of PVTG at drv = 0) and the anchors of the water and gas columns
// (:126-131), whose PVT lookups are K1's (utils/tables.py interp :97,
// interp2 :237). Run as separate one-query K1 launches, one column costs
// 3999 density evaluations, each four lookups (RSVD or PBVD, rs_sat,
// p_bub, the PVTO pair) and about ten more tiny operations: some 20,000
// launches and 100,000 small operations per region, and host reads.
//
// What bounds it on the card: latency. A column is a chain of dependent
// midpoint steps, each two density evaluations (binary searches in tiny
// tables, float64 divisions); its bytes (the columns written once, 48 KB
// at 2000 points) are nothing. Design: one block per region; the region's
// PVT rows (pvt0's row of each table in props/blackoil.py CellPack's
// buffer), the RSVD or PBVD column and the depth grid are staged in
// shared memory; K1's lookups are tables.cuh's device functions, so the
// segment and the interpolation are K1's. The down and up legs of a
// column depend only on its anchor, so they run at once, each on lane 0
// of a warp of its own (four warps: no divergence inside a warp): first
// the oil column's two legs; then one thread forms the water and gas
// anchors from the oil column at the WOC and the GOC; then water down and
// up and gas down and up on four warps. Nothing is read back by the host.
//
// Arithmetic is the plain version's (sim/init.py equil_columns_plain) in
// its order: p + (rho(p, z) * 0.5) * dz, lookups as v + 0 * x, divisions
// as divisions, built with --fmad=false, so the columns equal it bit for
// bit. Only the steps the reference's masked scans take are evaluated.
//
// The cell pass (equil_cells_kernel) replaces the rest of the reference's
// equilibrate_region (:133-187): the columns' lookups onto the cells
// (interp :134-136), sw from pcow (:146) and sg from pcgo (:149-157) by
// K1's clamped lookups, rs_sat at each cell's PVT region and the RSVD /
// PBVD column (:159-172), and under VAPOIL rv from the RVVD column capped
// by rv_sat(pg), from PDVD as rv_sat(min(pd, pg)), or rv_sat(pg)
// (:174-190). Run as torch operations, that was 4-6 K1
// launches a region, two host reads (whether each capillary curve is
// flat), about a dozen elementwise passes and five scatters into the
// state. What bounds it: memory traffic, a cell's depth and two region
// numbers read (16 B, gathered through the region's cell list) and five
// values written (40 B, scattered); the lookups are a few binary searches
// in tables that stay in L1. Design: a grid-strided thread per cell of
// the region; each block stages the depth grid and the three columns
// (4 nz doubles, 64 KB at 2000 points), the RSVD/PBVD and the RVVD/PDVD
// columns in shared memory once; the per-region saturation and PVT tables
// are read through
// the cache. The values go straight into the state's (nc,) rows. Every
// formula is the plain version's (sim/init.py equil_cells_plain) in its
// order, so the outputs equal it bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "pack.cuh"
#include "tables.cuh"

namespace {

using opm_pack::kMeta;
using opm_pack::Layout;
using opm_pack::layout_of;
using opm_pack::row_of;
using opm_tables::Coord1;
using opm_tables::coord1;

constexpr int kLegs = 4;              // warps; lane 0 of each marches a leg
constexpr int kThreads = 32 * kLegs;

// the dissolved-gas column of the region: none (saturated), RSVD, PBVD;
// the vaporized-oil column: none (saturated), RVVD, PDVD
enum Mode { VD_NONE = 0, VD_RSVD = 1, VD_PBVD = 2 };
enum VapMode { VV_NONE = 0, VV_RVVD = 1, VV_PDVD = 2 };
enum Phase { OIL = 0, WATER = 1, GAS = 2 };

// the region's record and its scalar PVT (EQUIL, PVTW and DENSITY rows)
struct Region {
    double g;
    double datum_z, datum_p, woc_z, woc_pc, goc_z, goc_pc;
    int pvt0, disgas, mode;
};

// pvt0's table rows in shared memory, the region's scalars in registers
struct Tables {
    const double* z;                  // depth grid (nz)
    const double *vz, *vv;            // RSVD/PBVD depths and values (nv)
    const double *rs, *pbub, *dp;     // PVTO: rs (nrec), p_bub, dp (ndp)
    const double* ib;                 // PVTO inv_b grid (nrec, ndp)
    const double *ox, *oy;            // PVDO p and inv_b (on)
    const double *gx, *gy;            // PVDG p and inv_b (gn)
    const double *gpg, *grv, *gdrv;   // PVTG: pg, rv_sat (gnrec), drv (gnd)
    const double* gib;                // PVTG inv_b grid (gnrec, gnd)
    int nz, nv, nrec, ndp, on, gn, live;
    int wet, vapoil, gnrec, gnd;
    double sdw, sdo, sdg, w_pref, w_comp, w_bref;
};

// value of a 1-D table column at x (K1's lookup; the slope is not used)
__device__ __forceinline__ double look1(const double* xs, const double* ys,
                                        int n, double x, int clamp) {
    Coord1 c = coord1(xs, n, x, clamp);
    double v, s;
    opm_tables::interp1(c, ys, &v, &s);
    return v;
}

// torch.minimum and torch.maximum(d, 0) on values
__device__ __forceinline__ double minimum(double a, double b) {
    return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ double maximum0(double d) {
    return (isnan(d) || d > 0.0) ? d : 0.0;
}

// saturated rs at p (props.rs_sat with DISGAS: PVTO's curve, else 0)
__device__ __forceinline__ double rs_sat(const Tables& T, double p) {
    return T.live ? look1(T.pbub, T.rs, T.nrec, p, 0) : 0.0;
}

// inverse oil FVF at (p, rs): PVTO over (rs, p - p_bub(rs)), or PVDO
__device__ __forceinline__ double oil_b(const Tables& T, double p,
                                        double rs) {
    if (!T.live) return look1(T.ox, T.oy, T.on, p, 0);
    const double dp = maximum0(p - look1(T.rs, T.pbub, T.nrec, rs, 0));
    const Coord1 cx = coord1(T.rs, T.nrec, rs, 0);
    const Coord1 cy = coord1(T.dp, T.ndp, dp, 0);
    double v, dx, dy;
    opm_tables::interp2(cx, cy, T.ib, T.ndp, &v, &dx, &dy);
    return v;
}

// inverse gas FVF at (p, rv): PVTG over (p, max(rv_sat(p) - rv, 0))
__device__ __forceinline__ double wet_gas_b(const Tables& T, double p,
                                            double rv) {
    const double drv = maximum0(look1(T.gpg, T.grv, T.gnrec, p, 0) - rv);
    const Coord1 cx = coord1(T.gpg, T.gnrec, p, 0);
    const Coord1 cy = coord1(T.gdrv, T.gnd, drv, 0);
    double v, dx, dy;
    opm_tables::interp2(cx, cy, T.gib, T.gnd, &v, &dx, &dy);
    return v;
}

// dp/dz = rho * g of a phase at (p, depth zz): the plain version's rho_o,
// rho_w, rho_g
__device__ double dpdz(const Tables& T, const Region& R, int phase,
                       double p, double zz) {
    if (phase == WATER) {
        const double x = T.w_comp * (p - T.w_pref);
        const double b = ((1.0 + x) + (0.5 * x) * x) / T.w_bref;
        return (T.sdw * b) * R.g;
    }
    if (phase == GAS) {
        if (!T.wet)
            return ((T.sdg + 0.0 * T.sdo) * look1(T.gx, T.gy, T.gn, p, 0)) *
                   R.g;
        const double rv =
            T.vapoil ? look1(T.gpg, T.grv, T.gnrec, p, 0) : 0.0;
        return ((T.sdg + rv * T.sdo) * wet_gas_b(T, p, rv)) * R.g;
    }
    double rs = 0.0;
    if (R.disgas) {
        if (R.mode == VD_RSVD)
            rs = minimum(look1(T.vz, T.vv, T.nv, zz, 1), rs_sat(T, p));
        else if (R.mode == VD_PBVD)
            rs = rs_sat(T, minimum(look1(T.vz, T.vv, T.nv, zz, 1), p));
        else
            rs = rs_sat(T, p);
    }
    return ((T.sdo + rs * T.sdg) * oil_b(T, p, rs)) * R.g;
}

// One leg of a column from its anchor (z0, p0): down (dir > 0, i > i0)
// or up (i < i0); the down leg also writes the anchor point. i0 is
// numpy.searchsorted(z, z0) (left side) clipped to [0, nz - 1].
__device__ void march(const Tables& T, const Region& R, int phase,
                      double z0, double p0, int dir,
                      double* __restrict__ out) {
    const double* z = T.z;
    const int n = T.nz;
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (z[mid] < z0) lo = mid + 1; else hi = mid;
    }
    const int i0 = lo < n - 1 ? lo : n - 1;
    const double p_at = p0 + dpdz(T, R, phase, p0, z0) * (z[i0] - z0);
    double p = p_at;
    if (dir > 0) {
        out[i0] = p_at;
        for (int i = i0 + 1; i < n; ++i) {
            const double dz = z[i] - z[i - 1];
            const double p_mid =
                p + (dpdz(T, R, phase, p, z[i - 1]) * 0.5) * dz;
            p = p + dpdz(T, R, phase, p_mid, z[i - 1] + 0.5 * dz) * dz;
            out[i] = p;
        }
    } else {
        for (int i = i0 - 1; i >= 0; --i) {
            const double dz = z[i + 1] - z[i];
            const double p_mid =
                p - (dpdz(T, R, phase, p, z[i + 1]) * 0.5) * dz;
            p = p - dpdz(T, R, phase, p_mid, z[i + 1] - 0.5 * dz) * dz;
            out[i] = p;
        }
    }
}

__device__ __forceinline__ void stage(double* dst, const double* src,
                                      int n) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
}

// tab: CellPack's buffer; z (nz); vz, vv (nv) or null; out (3, nz): the
// oil, water and gas pressure columns
__global__ void __launch_bounds__(kThreads)
    equil_march_kernel(Layout L, const double* __restrict__ tab,
                       const double* __restrict__ z, int nz,
                       const double* __restrict__ vz,
                       const double* __restrict__ vv, int nv, Region R,
                       double* __restrict__ out) {
    extern __shared__ double smem[];
    __shared__ double anchor[2];
    const long long r = R.pvt0;
    Tables T = {};
    T.nz = nz;
    T.nv = nv;
    T.live = L.live;
    double* s = smem;
    T.z = s;
    stage(s, z, nz);
    s += nz;
    T.vz = s;
    stage(s, vz, R.mode != VD_NONE ? nv : 0);
    s += nv;
    T.vv = s;
    stage(s, vv, R.mode != VD_NONE ? nv : 0);
    s += nv;
    if (L.live) {
        const int ro = row_of(L.ol_nreg, r);
        T.nrec = L.ol_nrec;
        T.ndp = L.ol_ndp;
        T.rs = s;
        stage(s, tab + L.ol_rs + ro * L.ol_nrec, L.ol_nrec);
        s += L.ol_nrec;
        T.pbub = s;
        stage(s, tab + L.ol_pbub + ro * L.ol_nrec, L.ol_nrec);
        s += L.ol_nrec;
        T.dp = s;
        stage(s, tab + L.ol_dp + ro * L.ol_ndp, L.ol_ndp);
        s += L.ol_ndp;
        // grid 0 (inv_b) of the (nreg, 2, nrec, ndp) pair
        T.ib = s;
        stage(s, tab + L.ol_grid + (long long)ro * 2 * L.ol_nrec * L.ol_ndp,
              L.ol_nrec * L.ol_ndp);
        s += L.ol_nrec * L.ol_ndp;
    } else {
        const int rd = row_of(L.od_nreg, r);
        T.on = L.od_n;
        T.ox = s;
        stage(s, tab + L.od_x + rd * L.od_n, L.od_n);
        s += L.od_n;
        T.oy = s;
        stage(s, tab + L.od_y + rd * 2 * L.od_n, L.od_n);
        s += L.od_n;
    }
    T.wet = L.wet;
    T.vapoil = L.vapoil;
    if (L.wet) {
        const int rg = row_of(L.gw_nreg, r);
        T.gnrec = L.gw_nrec;
        T.gnd = L.gw_nd;
        T.gpg = s;
        stage(s, tab + L.gw_pg + rg * L.gw_nrec, L.gw_nrec);
        s += L.gw_nrec;
        T.grv = s;
        stage(s, tab + L.gw_rv + rg * L.gw_nrec, L.gw_nrec);
        s += L.gw_nrec;
        T.gdrv = s;
        stage(s, tab + L.gw_drv + rg * L.gw_nd, L.gw_nd);
        s += L.gw_nd;
        // grid 0 (inv_b) of the (nreg, 2, nrec, nd) pair
        T.gib = s;
        stage(s, tab + L.gw_grid + (long long)rg * 2 * L.gw_nrec * L.gw_nd,
              L.gw_nrec * L.gw_nd);
    } else {
        const int rg = row_of(L.g_nreg, r);
        T.gn = L.g_n;
        T.gx = s;
        stage(s, tab + L.g_x + rg * L.g_n, L.g_n);
        s += L.g_n;
        T.gy = s;
        stage(s, tab + L.g_y + rg * 2 * L.g_n, L.g_n);
    }
    const int rw = row_of(L.w_nreg, r);
    T.w_pref = tab[L.w_pref + rw];
    T.w_comp = tab[L.w_comp + rw];
    T.w_bref = tab[L.w_bref + rw];
    const int rden = row_of(L.d_nreg, r);
    T.sdw = tab[L.d_sd + 3 * rden];
    T.sdo = tab[L.d_sd + 3 * rden + 1];
    T.sdg = tab[L.d_sd + 3 * rden + 2];
    __syncthreads();

    const int leg = threadIdx.x >> 5;
    const bool lead = (threadIdx.x & 31) == 0;
    // the oil column's two legs from the datum
    if (lead && leg < 2)
        march(T, R, OIL, R.datum_z, R.datum_p, leg == 0 ? 1 : -1, out);
    __syncthreads();
    // the water column's anchor: po at the WOC less the WOC's capillary
    // pressure; the gas column's: po at the GOC plus the GOC's (K1's
    // lookup over the grid, linear extrapolation)
    if (threadIdx.x == 0) {
        anchor[0] = look1(T.z, out, nz, R.woc_z, 0) - R.woc_pc;
        anchor[1] = look1(T.z, out, nz, R.goc_z, 0) + R.goc_pc;
    }
    __syncthreads();
    if (lead) {
        const int phase = leg < 2 ? WATER : GAS;
        march(T, R, phase, phase == WATER ? R.woc_z : R.goc_z,
              anchor[phase == WATER ? 0 : 1], (leg & 1) ? -1 : 1,
              out + (long long)phase * nz);
    }
}

// numpy.interp's formula at x (the plain version's np_interp): the
// segment j with xp[j] <= x < xp[j+1] clipped to [0, n-2], slope (fp[j+1]
// - fp[j]) / (xp[j+1] - xp[j]) times (x - xp[j]) plus fp[j], the end values
// at and beyond the ends
__device__ __forceinline__ double np_interp(const double* xp,
                                            const double* fp, int n,
                                            double x) {
    if (n == 1) return fp[0];
    const int j = opm_tables::segment_of(xp, n, x);
    const double slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j]);
    double out = slope * (x - xp[j]) + fp[j];
    if (x >= xp[n - 1]) out = fp[n - 1];
    if (x < xp[0]) out = fp[0];
    return out;
}

// the cell pass's region: its contacts and switches, and the per-region
// tables ((nreg, n) rows; a table with one region serves every region)
struct CellRegion {
    double woc_z, goc_z;
    int mode, disgas, inv_w, inv_g;    // sw from pcow, sg from pcgo
    const double *pcow_neg, *sw, *pcgo, *sg, *swco;
    int s_nreg, nw, ng;
    const double *pbub, *rs;           // null: rs_sat is 0
    int o_nreg, nrec;
    int vmode, vapoil;                 // the RVVD/PDVD column; rv_sat != 0
    const double *gpg, *grv;           // PVTG: pg, rv_sat (g_nreg, g_nrec)
    int g_nreg, g_nrec;
};

constexpr int kCellThreads = 256;

// The region's n cells cells[k]: p, sw, sg, rs, rv at cell c written to
// out[q nc + c], q = 0..4. z (nz), cols (3, nz): the march's depth grid
// and columns; vz, vv (nv): the RSVD/PBVD column; wz, wv (nvw): the
// RVVD/PDVD column.
__global__ void __launch_bounds__(kCellThreads)
    equil_cells_kernel(const double* __restrict__ z, int nz,
                       const double* __restrict__ cols,
                       const double* __restrict__ vz,
                       const double* __restrict__ vv, int nv,
                       const double* __restrict__ wz,
                       const double* __restrict__ wv, int nvw, CellRegion R,
                       const int* __restrict__ cells, long long n,
                       const double* __restrict__ depth,
                       const int* __restrict__ pvtnum,
                       const int* __restrict__ satnum, long long nc,
                       double* __restrict__ out) {
    extern __shared__ double smem[];
    double* Z = smem;
    double* C = Z + nz;
    double* VZ = C + 3 * nz;
    double* VV = VZ + nv;
    double* WZ = VV + nv;
    double* WV = WZ + nvw;
    stage(Z, z, nz);
    stage(C, cols, 3 * nz);
    stage(VZ, vz, R.mode != VD_NONE ? nv : 0);
    stage(VV, vv, R.mode != VD_NONE ? nv : 0);
    stage(WZ, wz, R.vmode != VV_NONE ? nvw : 0);
    stage(WV, wv, R.vmode != VV_NONE ? nvw : 0);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < n; k += stride) {
        const long long c = cells[k];
        const double zc = depth[c];
        // the three columns at the cell's depth (K1's linear lookup)
        const Coord1 cz = coord1(Z, nz, zc, 0);
        double po, pw, pg, s;
        opm_tables::interp1(cz, C, &po, &s);
        opm_tables::interp1(cz, C + nz, &pw, &s);
        opm_tables::interp1(cz, C + 2 * nz, &pg, &s);
        const int rsat = row_of(R.s_nreg, satnum[c]);
        const double swco = R.swco[rsat];
        double sw, sg;
        if (R.inv_w)
            sw = look1(R.pcow_neg + (long long)rsat * R.nw,
                       R.sw + (long long)rsat * R.nw, R.nw, -(po - pw), 1);
        else
            sw = zc > R.woc_z ? 1.0 : swco;
        if (R.inv_g) {
            sg = look1(R.pcgo + (long long)rsat * R.ng,
                       R.sg + (long long)rsat * R.ng, R.ng, pg - po, 1);
            sg = zc < R.goc_z ? sg : 0.0;
        } else {
            sg = zc < R.goc_z ? 1.0 - swco : 0.0;
        }
        // torch.clamp(sg, min=0), then torch.minimum with 1 - sw
        if (!isnan(sg) && sg < 0.0) sg = 0.0;
        sg = minimum(sg, 1.0 - sw);
        double rs = 0.0;
        if (R.disgas) {
            const double* pb_x = nullptr;
            const double* rs_y = nullptr;
            if (R.pbub) {
                const long long ro = row_of(R.o_nreg, pvtnum[c]);
                pb_x = R.pbub + ro * R.nrec;
                rs_y = R.rs + ro * R.nrec;
            }
            const double rssat =
                R.pbub ? look1(pb_x, rs_y, R.nrec, po, 0) : 0.0;
            if (R.mode == VD_RSVD) {
                rs = minimum(np_interp(VZ, VV, nv, zc), rssat);
            } else if (R.mode == VD_PBVD) {
                const double pb = minimum(np_interp(VZ, VV, nv, zc), po);
                rs = R.pbub ? look1(pb_x, rs_y, R.nrec, pb, 0) : 0.0;
            } else {
                rs = rssat;
            }
        }
        double rv = 0.0;
        if (R.vapoil) {
            const long long rg = row_of(R.g_nreg, pvtnum[c]);
            const double* pg_x = R.gpg + rg * R.g_nrec;
            const double* rv_y = R.grv + rg * R.g_nrec;
            const double rvsat = look1(pg_x, rv_y, R.g_nrec, pg, 0);
            if (R.vmode == VV_RVVD) {
                rv = minimum(np_interp(WZ, WV, nvw, zc), rvsat);
            } else if (R.vmode == VV_PDVD) {
                const double pd = minimum(np_interp(WZ, WV, nvw, zc), pg);
                rv = look1(pg_x, rv_y, R.g_nrec, pd, 0);
            } else {
                rv = rvsat;
            }
        }
        out[c] = po;
        out[nc + c] = sw;
        out[2 * nc + c] = sg;
        out[3 * nc + c] = rs;
        out[4 * nc + c] = rv;
    }
}

}  // namespace

extern "C" {

int opm_equil_meta_len() { return kMeta; }

// The shared-memory bytes one launch stages: the depth grid, the
// RSVD/PBVD column and pvt0's PVT rows.
long long opm_equil_smem_bytes(const int* meta, int nz, int nv) {
    const Layout L = layout_of(meta);
    long long n = nz + 2LL * nv;
    n += L.wet ? 2LL * L.gw_nrec + L.gw_nd + (long long)L.gw_nrec * L.gw_nd
               : 2LL * L.g_n;
    n += L.live ? 2LL * L.ol_nrec + L.ol_ndp + (long long)L.ol_nrec * L.ol_ndp
                : 2LL * L.od_n;
    return n * (long long)sizeof(double);
}

// tab, meta: CellPack's buffer and offsets; z (nz) float64, ascending;
// vz, vv (nv) float64, or null with mode 0; out (3, nz) float64
int opm_equil_march(const double* tab, const int* meta, const double* z,
                    int nz, const double* vz, const double* vv, int nv,
                    int mode, int disgas, int pvt0, double g,
                    double datum_z, double datum_p, double woc_z,
                    double woc_pc, double goc_z, double goc_pc, double* out,
                    cudaStream_t stream) {
    const Layout L = layout_of(meta);
    const Region R{g, datum_z, datum_p, woc_z, woc_pc, goc_z, goc_pc, pvt0,
                   disgas, mode};
    const size_t smem = (size_t)opm_equil_smem_bytes(meta, nz, nv);
    if (smem > 48 * 1024) {
        int err = (int)cudaFuncSetAttribute(
            equil_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err) return err;
    }
    equil_march_kernel<<<1, kThreads, smem, stream>>>(L, tab, z, nz, vz, vv,
                                                      nv, R, out);
    return (int)cudaGetLastError();
}

// The cell pass of one region: z (nz) and cols (3, nz) the march's grid
// and columns; vz, vv (nv) or null with mode 0; pcow, pcgo: 1 where the
// deck's curve is not flat; the saturation tables pcow_neg, sw (nreg, nw),
// pcgo, sg (nreg, ng) and swco (nreg); PVTO's pbub and rs
// (o_nreg, nrec), or null (rs_sat 0); wz, wv (nvw) the RVVD/PDVD column,
// or null with vmode 0; vapoil: rv from PVTG's pg and rv_sat (g_nreg,
// g_nrec), else rv 0; cells (n) int32, the region's cells;
// depth (nc) float64, pvtnum and satnum (nc) int32; out (5, nc) float64:
// p, sw, sg, rs, rv written at the region's cells. One launch: a grid
// strided over the cells, as many blocks as fit on the card at once.
int opm_equil_cells(const double* z, int nz, const double* cols,
                    const double* vz, const double* vv, int nv, int mode,
                    int disgas, int pcow, int pcgo, double woc_z,
                    double goc_z, const double* pcow_neg, const double* sw,
                    const double* pcgo_x, const double* sg,
                    const double* swco, int s_nreg, int nw, int ng,
                    const double* pbub, const double* rs, int o_nreg,
                    int nrec, const double* wz, const double* wv, int nvw,
                    int vmode, int vapoil, const double* gpg,
                    const double* grv, int g_nreg, int g_nrec,
                    const int* cells, long long n,
                    const double* depth, const int* pvtnum,
                    const int* satnum, long long nc, double* out,
                    cudaStream_t stream) {
    if (n == 0) return 0;
    const CellRegion R{woc_z, goc_z, mode, disgas, pcow, pcgo, pcow_neg,
                       sw, pcgo_x, sg, swco, s_nreg, nw, ng, pbub, rs,
                       o_nreg, nrec, vmode, vapoil, gpg, grv, g_nreg,
                       g_nrec};
    const size_t smem =
        (size_t)(4LL * nz + 2LL * nv + 2LL * nvw) * sizeof(double);
    int err = (int)cudaFuncSetAttribute(
        equil_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    int dev = 0, sms = 0, per_sm = 0;
    err = (int)cudaGetDevice(&dev);
    if (!err)
        err = (int)cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err)
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, equil_cells_kernel, kCellThreads, smem);
    if (err) return err;
    const long long need = (n + kCellThreads - 1) / kCellThreads;
    const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const int blocks = (int)(need < fit ? need : fit);
    equil_cells_kernel<<<blocks, kCellThreads, smem, stream>>>(
        z, nz, cols, vz, vv, nv, wz, wv, nvw, R, cells, n, depth, pvtnum,
        satnum, nc, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
