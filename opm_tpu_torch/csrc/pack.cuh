// The layout of the ported PVT, saturation and rock tables in one float64
// buffer (props/blackoil.py CellPack, built once per case): the offsets
// and sizes of each table, in doubles, in the order of CellPack.META.
// Read by K2 (cells.cu) and by K1's EQUIL column march (equil.cu).
// Per-region tables keep their (nreg, ...) layout: a table with one region
// serves every region (row_of), as reg_pick and the lookups do.

#pragma once

#include <cuda_runtime.h>

namespace opm_pack {

struct Layout {
    int live, disgas, rock;
    int w_nreg, w_pref, w_bref, w_comp, w_muref, w_visc;
    int od_nreg, od_n, od_x, od_y;
    int ol_nreg, ol_nrec, ol_ndp, ol_rs, ol_pbub, ol_dp, ol_grid;
    int g_nreg, g_n, g_x, g_y;
    int s_nreg, s_nw, s_sw, s_wc, s_ng, s_sg, s_gc, s_swco;
    int r_nreg, r_pref, r_comp;
    int d_nreg, d_sd;
    // PVTG (wet gas): wet when the deck has it (the gas b and mu come from
    // it, over (pg, drv)), vapoil when rv_sat is its saturated curve
    int wet, vapoil;
    int gw_nreg, gw_nrec, gw_nd, gw_pg, gw_rv, gw_drv, gw_grid;
};
constexpr int kMeta = sizeof(Layout) / sizeof(int);

__host__ __device__ __forceinline__ int row_of(int nreg, long long r) {
    return nreg == 1 ? 0 : (int)r;
}

// the Layout of the host array CellPack.c_meta
inline Layout layout_of(const int* meta) {
    Layout L;
    int* dst = reinterpret_cast<int*>(&L);
    for (int k = 0; k < kMeta; ++k) dst[k] = meta[k];
    return L;
}

}  // namespace opm_pack
