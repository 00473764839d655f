// The table-lookup device code of K1 (tables.cu), shared with K2
// (cells.cu), so that both choose the same segment and the same one-sided
// slope at every node and at every clamp end.
//
// Semantics (the plain version in opm_tpu_torch/utils/tables.py): the
// active segment is the one with xs[i] <= x < xs[i+1]; queries below/above
// the table take the first/last segment; t = (x - lo) / (hi == lo ? 1 :
// hi - lo); v = (1 - t) y0 + t y1; 'clamp' clips t to [0, 1] with the
// slope factor 0 outside, 1/2 at t == 0 or t == 1 (jax.jacfwd of jnp.clip
// at a tie), 1 inside; the result is v + 0 * x, so NaN queries stay NaN
// with slope 0. Products and sums in the plain version's order (build
// with --fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace opm_tables {

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

// local coordinate and its slope factor (d t_clipped / d t) / width
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

// One query's place in a 1-D table row: the segment, the local coordinate
// and its slope factor. Every value column sharing the abscissa reuses it.
struct Coord1 {
    int i;
    double t, dt, x;
};

__device__ __forceinline__ Coord1 coord1(const double* xs, int n, double x,
                                         int clamp) {
    Coord1 c;
    c.x = x;
    c.i = 0;
    c.t = 0.0;
    c.dt = 0.0;
    if (isnan(x)) return c;
    c.i = segment_of(xs, n, x);
    local_coord(xs, c.i, x, clamp, &c.t, &c.dt);
    return c;
}

// value and slope of the column y (n nodes) at c
__device__ __forceinline__ void interp1(const Coord1& c, const double* y,
                                        double* v, double* s) {
    if (isnan(c.x)) {
        *v = c.x;
        *s = 0.0;
        return;
    }
    double y0 = y[c.i];
    double y1 = y[c.i + 1];
    *v = ((1.0 - c.t) * y0 + c.t * y1) + 0.0 * c.x;
    *s = (-c.dt) * y0 + c.dt * y1;
}

// value and the slopes d/dx, d/dy of the grid z (n x m, row-major over x)
// at (cx, cy); cx over the n x-nodes, cy over the m y-nodes
__device__ __forceinline__ void interp2(const Coord1& cx, const Coord1& cy,
                                        const double* z, int m, double* v,
                                        double* dvdx, double* dvdy) {
    if (isnan(cx.x) || isnan(cy.x)) {
        *v = cx.x + cy.x;
        *dvdx = 0.0;
        *dvdy = 0.0;
        return;
    }
    const int i = cx.i, j = cy.i;
    double z00 = z[i * m + j], z01 = z[i * m + j + 1];
    double z10 = z[(i + 1) * m + j], z11 = z[(i + 1) * m + j + 1];
    // y-contraction per x-node first, then x (the reference's node-basis
    // order)
    double v0 = (1.0 - cy.t) * z00 + cy.t * z01;
    double v1 = (1.0 - cy.t) * z10 + cy.t * z11;
    double vv = (1.0 - cx.t) * v0 + cx.t * v1;
    *v = (vv + 0.0 * cx.x) + 0.0 * cy.x;
    *dvdx = (-cx.dt) * v0 + cx.dt * v1;
    double d0 = (-cy.dt) * z00 + cy.dt * z01;
    double d1 = (-cy.dt) * z10 + cy.dt * z11;
    *dvdy = (1.0 - cx.t) * d0 + cx.t * d1;
}

}  // namespace opm_tables
