// K3: TPFA phase fluxes and their divergence on the structured grid, with a
// batched tangent entry for the Jacobian, for Hopper.
//
// Replaces the JAX package's models/blackoil.py face_flux_from_q
// (:176-212), the structured BlackoilModel.face_fluxes (:298-331) and the
// structured BlackoilModel.divergence (:341-364), which XLA fused on the
// TPU into shifted-slice face passes and pad+add scatters.
//
// What bounds it on the card: memory traffic. Per cell the forward reads
// 3 phase pressures, 3 densities, 3 b*mobilities, rs, rv and depth of the
// cell and its <= 6 neighbours (mostly from L2: neighbours are adjacent
// cells or one row/plane away) and the <= 6 face transmissibilities, and
// writes 3 values. Design: gather form, one thread per cell (per cell and
// tangent set for the tangent entry): the thread visits its faces in the
// reference's order (+x as left, -x as right, then y, then z) and sums
// their fluxes in registers. No atomics, a fixed summation order equal to
// the reference's slice-add order, and each face flux is computed by both
// of its cells with identical arithmetic. The tangent entry takes B
// tangent sets of the per-cell inputs and returns B tangent divergences
// with the upwind direction fixed by the primal, which is what
// jax.jacfwd through jnp.where computes; B is the batch the Jacobian's
// vmap folds in.
//
// Face order is grid.build_grid's direction-blocked C order: x faces
// (nz, ny, nx-1), then y faces (nz, ny-1, nx), then z faces (nz-1, ny, nx).
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "tpfa_face.cuh"

namespace {

using opm_tpfa::Cells;
using opm_tpfa::Face;
using opm_tpfa::face_primal;
using opm_tpfa::face_tangent;

constexpr int kThreads = 256;

// The six faces of cell c in the reference's accumulation order; calls
// visit(L, R, face_index, sign) for each existing face.
template <typename Visit>
__device__ __forceinline__ void for_faces(int nx, int ny, int nz,
                                          long long c, Visit visit) {
    long long i = c % nx;
    long long j = (c / nx) % ny;
    long long k = c / ((long long)nx * ny);
    long long nfx = (long long)(nx - 1) * ny * nz;
    long long nfy = (long long)nx * (ny - 1) * nz;
    long long plane = (long long)nx * ny;
    if (i < nx - 1) visit(c, c + 1, (k * ny + j) * (nx - 1) + i, 1.0);
    if (i > 0) visit(c - 1, c, (k * ny + j) * (nx - 1) + i - 1, -1.0);
    if (j < ny - 1)
        visit(c, c + nx, nfx + (k * (ny - 1) + j) * nx + i, 1.0);
    if (j > 0)
        visit(c - nx, c, nfx + (k * (ny - 1) + j - 1) * nx + i, -1.0);
    if (k < nz - 1)
        visit(c, c + plane, nfx + nfy + (k * ny + j) * nx + i, 1.0);
    if (k > 0)
        visit(c - plane, c, nfx + nfy + ((k - 1) * ny + j) * nx + i, -1.0);
}

__global__ void tpfa_div_kernel(int nx, int ny, int nz, Cells q,
                                const double* __restrict__ depth,
                                const double* __restrict__ trans, double g,
                                double* __restrict__ div) {
    long long nc = (long long)nx * ny * nz;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         c < nc; c += stride) {
        double acc[3] = {0.0, 0.0, 0.0};
        for_faces(nx, ny, nz, c,
                  [&](long long L, long long R, long long fi, double sgn) {
            Face f;
            double flux[3];
            face_primal(q, nc, L, R, trans[fi], g, depth[L] - depth[R], &f,
                        flux);
            for (int e = 0; e < 3; ++e)
                acc[e] = acc[e] + (sgn > 0.0 ? flux[e] : -flux[e]);
        });
        for (int e = 0; e < 3; ++e) div[e * nc + c] = acc[e];
    }
}

// tangents: dp, drho, dbmob (B, 3, nc); drs, drv (B, nc); ddiv (B, 3, nc)
__global__ void tpfa_div_tangent_kernel(int nx, int ny, int nz, int B,
                                        Cells q, Cells dq,
                                        const double* __restrict__ depth,
                                        const double* __restrict__ trans,
                                        double g,
                                        double* __restrict__ ddiv) {
    long long nc = (long long)nx * ny * nz;
    long long total = nc * B;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        long long b = idx / nc;
        long long c = idx - b * nc;
        Cells t;
        t.p = dq.p + b * 3 * nc;
        t.rho = dq.rho + b * 3 * nc;
        t.bmob = dq.bmob + b * 3 * nc;
        t.rs = dq.rs + b * nc;
        t.rv = dq.rv + b * nc;
        double acc[3] = {0.0, 0.0, 0.0};
        for_faces(nx, ny, nz, c,
                  [&](long long L, long long R, long long fi, double sgn) {
            Face f;
            double flux[3], flux_t[3];
            double dz = depth[L] - depth[R];
            face_primal(q, nc, L, R, trans[fi], g, dz, &f, flux);
            face_tangent(t, nc, L, R, trans[fi], g, dz, f, flux_t);
            for (int e = 0; e < 3; ++e)
                acc[e] = acc[e] + (sgn > 0.0 ? flux_t[e] : -flux_t[e]);
        });
        for (int e = 0; e < 3; ++e) ddiv[b * 3 * nc + e * nc + c] = acc[e];
    }
}

int blocks_for(long long n) {
    long long b = (n + kThreads - 1) / kThreads;
    if (b < 1) b = 1;
    if (b > 65535LL * 32) b = 65535LL * 32;
    return (int)b;
}

}  // namespace

extern "C" int opm_tpfa_div(int nx, int ny, int nz, const double* p,
                            const double* rho, const double* bmob,
                            const double* rs, const double* rv,
                            const double* depth, const double* trans,
                            double g, double* div, void* stream) {
    Cells q{p, rho, bmob, rs, rv};
    long long nc = (long long)nx * ny * nz;
    tpfa_div_kernel<<<blocks_for(nc), kThreads, 0, (cudaStream_t)stream>>>(
        nx, ny, nz, q, depth, trans, g, div);
    return (int)cudaGetLastError();
}

extern "C" int opm_tpfa_div_tangent(int nx, int ny, int nz, int B,
                                    const double* p, const double* rho,
                                    const double* bmob, const double* rs,
                                    const double* rv, const double* dp,
                                    const double* drho, const double* dbmob,
                                    const double* drs, const double* drv,
                                    const double* depth, const double* trans,
                                    double g, double* ddiv, void* stream) {
    Cells q{p, rho, bmob, rs, rv};
    Cells dq{dp, drho, dbmob, drs, drv};
    long long n = (long long)nx * ny * nz * B;
    tpfa_div_tangent_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        nx, ny, nz, B, q, dq, depth, trans, g, ddiv);
    return (int)cudaGetLastError();
}
