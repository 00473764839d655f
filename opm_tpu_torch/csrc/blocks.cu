// K3 face blocks, stencil form: the face fluxes of the structured grid
// with their Jacobian blocks face_L / face_R, folded into r_cell and the
// block diagonal, for Hopper.
//
// Replaces the structured branch of the JAX package's
// models/linearize.py assemble (:172-240: per direction, jax.linearize of
// face_flux_from_q through a zero THPRES threshold, chained with the
// per-cell tangent columns, pad-added into r_cell and diag), which XLA
// fused on the TPU into shifted-slice passes.
//
// Inputs: the face inputs fv (11, nc: p3, rho, b mob, rs, rv) and their
// tangent columns fc (3, 11, nc) from K2's assembly entry (cells.cu), the
// depths, the stencil faces' transmissibilities and THPRES thresholds (thr,
// null without THPRES: the zero threshold's tangent); r_cell (3, nc) and diag
// (9, nc) from K2, updated in place; face_L / face_R (9, nf) written at
// the stencil faces (nf is their row stride: an embedded grid's extra
// faces follow and are left to faces.cu).
//
// What bounds it on the card: memory traffic. Per cell it reads the 44
// input rows of itself and its <= 6 neighbours (neighbours mostly from L2)
// and the 12 rows of r_cell and diag, and writes those 12 rows and the 18
// block rows of its <= 3 faces where it is the left cell. Design: one
// launch, one thread per cell, gather form: the thread visits its faces in
// the plain version's order (+x as left, -x as right, then y, then z) and
// recomputes each face's flux; as the left cell it computes both blocks,
// writes them and adds face_L to its diagonal, as the right cell it
// computes face_R only and subtracts it. Each face is thus evaluated by
// both of its cells rather than once and re-read (a face pass then a cell
// pass would write and read the flux and both blocks again: about 0.6 GB
// more traffic at SPE10-2 than the second evaluation's arithmetic costs);
// no atomics, and every cell sums in the plain version's order, so r_cell
// and diag equal the plain version's bit for bit.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "tpfa_face.cuh"

namespace {

using opm_tpfa::Cells;
using opm_tpfa::face_blocks;

constexpr int kThreads = 128;

template <bool kThr>
__global__ void face_blocks_kernel(int nx, int ny, int nz, long long nf,
                                   const double* __restrict__ fv,
                                   const double* __restrict__ fc,
                                   const double* __restrict__ depth,
                                   const double* __restrict__ trans,
                                   const double* __restrict__ thr,
                                   double g, double* __restrict__ r_cell,
                                   double* __restrict__ diag,
                                   double* __restrict__ fL,
                                   double* __restrict__ fR) {
    const long long nc = (long long)nx * ny * nz;
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nc) return;
    const Cells q{fv, fv + 3 * nc, fv + 6 * nc, fv + 9 * nc, fv + 10 * nc};
    double r[3], d[9];
    for (int e = 0; e < 3; ++e) r[e] = r_cell[e * nc + c];
    for (int k = 0; k < 9; ++k) d[k] = diag[k * nc + c];
    const long long i = c % nx;
    const long long j = (c / nx) % ny;
    const long long k = c / ((long long)nx * ny);
    const long long nfx = (long long)(nx - 1) * ny * nz;
    const long long nfy = (long long)nx * (ny - 1) * nz;
    const long long plane = (long long)nx * ny;
    // the cell as the left cell of face fi to R: both blocks, written
    auto as_left = [&](long long R, long long fi) {
        double flux[3], bl[9], br[9];
        face_blocks(q, fc, nc, c, R, trans[fi], g, depth[c] - depth[R], flux,
                    bl, br, opm_tpfa::thr_at<kThr>(thr, fi));
        for (int e = 0; e < 3; ++e) r[e] = r[e] + flux[e];
        for (int b = 0; b < 9; ++b) {
            fL[b * nf + fi] = bl[b];
            fR[b * nf + fi] = br[b];
            d[b] = d[b] + bl[b];
        }
    };
    // the cell as the right cell of face fi from L: face_R only
    auto as_right = [&](long long L, long long fi) {
        double flux[3], br[9];
        face_blocks(q, fc, nc, L, c, trans[fi], g, depth[L] - depth[c], flux,
                    nullptr, br, opm_tpfa::thr_at<kThr>(thr, fi));
        for (int e = 0; e < 3; ++e) r[e] = r[e] + (-flux[e]);
        for (int b = 0; b < 9; ++b) d[b] = d[b] + (-br[b]);
    };
    if (i < nx - 1) as_left(c + 1, (k * ny + j) * (nx - 1) + i);
    if (i > 0) as_right(c - 1, (k * ny + j) * (nx - 1) + i - 1);
    if (j < ny - 1) as_left(c + nx, nfx + (k * (ny - 1) + j) * nx + i);
    if (j > 0) as_right(c - nx, nfx + (k * (ny - 1) + j - 1) * nx + i);
    if (k < nz - 1) as_left(c + plane, nfx + nfy + (k * ny + j) * nx + i);
    if (k > 0) as_right(c - plane, nfx + nfy + ((k - 1) * ny + j) * nx + i);
    for (int e = 0; e < 3; ++e) r_cell[e * nc + c] = r[e];
    for (int b = 0; b < 9; ++b) diag[b * nc + c] = d[b];
}

}  // namespace

extern "C" int opm_face_blocks(int nx, int ny, int nz, long long nf,
                               const double* fv, const double* fc,
                               const double* depth, const double* trans,
                               const double* thr, double g, double* r_cell,
                               double* diag,
                               double* fL, double* fR, cudaStream_t stream) {
    long long nc = (long long)nx * ny * nz;
    if (nc == 0) return 0;
    int blocks = (int)((nc + kThreads - 1) / kThreads);
    if (thr)
        face_blocks_kernel<true><<<blocks, kThreads, 0, stream>>>(
            nx, ny, nz, nf, fv, fc, depth, trans, thr, g, r_cell, diag, fL,
            fR);
    else
        face_blocks_kernel<false><<<blocks, kThreads, 0, stream>>>(
            nx, ny, nz, nf, fv, fc, depth, trans, thr, g, r_cell, diag, fL,
            fR);
    return (int)cudaGetLastError();
}
