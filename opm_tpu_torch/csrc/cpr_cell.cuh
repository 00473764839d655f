// K6's device code, shared by cpr.cu (the stand-alone setup launches) and
// amg.cu (the setup as the first phases of K10's value refresh).
//
// setup_cell: a cell's dinv (closed form through 1/det), its quasi-IMPES
// weights w (row 0 of D^-1: first-row cofactors over det, true divisions)
// and diag_p = (w0 D00 + w1 D10) + w2 D20, as linalg/precond.py's
// inv3x3_rows, quasi_impes_weights and cpr_pressure_system round them.
//
// face_couplings: the pressure couplings of face t of a face list from the
// weights (w, written beforehand) of its two cells, a thread per face:
//   a_LR[t] =  (w0[L] fR[0][f] + w1[L] fR[3][f]) + w2[L] fR[6][f],
//   a_RL[t] = -((w0[R] fL[0][f] + w1[R] fL[3][f]) + w2[R] fL[6][f]),
// f = f0 + t, written at off[t] and off[n + t]. The faces come in grid face
// order, so the cells of neighbouring faces are near each other and the
// weights' gathers mostly share sectors, and the face arrays are read
// coalesced.
//
// Build with --fmad=false (products and sums round as the plain version's).

#pragma once

#include <cuda_runtime.h>

namespace opm_cpr {

// dinv, w and diag_p of cell c; returns its weights in wc
__device__ __forceinline__ void setup_cell(long long nc, long long c,
                                           const double* __restrict__ diag,
                                           double* __restrict__ dinv,
                                           double* __restrict__ w,
                                           double* __restrict__ diag_p,
                                           double wc[3]) {
    double a = diag[0 * nc + c], b = diag[1 * nc + c], cc = diag[2 * nc + c];
    double d = diag[3 * nc + c], e = diag[4 * nc + c], f = diag[5 * nc + c];
    double g = diag[6 * nc + c], h = diag[7 * nc + c], i = diag[8 * nc + c];
    double A = e * i - f * h;
    double B = -(d * i - f * g);
    double C = d * h - e * g;
    double det = a * A + b * B + cc * C;
    det = fabs(det) > 1e-300 ? det : 1.0;
    double inv_det = 1.0 / det;
    dinv[0 * nc + c] = A * inv_det;
    dinv[1 * nc + c] = -(b * i - cc * h) * inv_det;
    dinv[2 * nc + c] = (b * f - cc * e) * inv_det;
    dinv[3 * nc + c] = B * inv_det;
    dinv[4 * nc + c] = (a * i - cc * g) * inv_det;
    dinv[5 * nc + c] = -(a * f - cc * d) * inv_det;
    dinv[6 * nc + c] = C * inv_det;
    dinv[7 * nc + c] = -(a * h - b * g) * inv_det;
    dinv[8 * nc + c] = (a * e - b * d) * inv_det;
    double w0 = A / det;
    double w1 = -(b * i - cc * h) / det;
    double w2 = (b * f - cc * e) / det;
    w[c] = w0;
    w[nc + c] = w1;
    w[2 * nc + c] = w2;
    diag_p[c] = (w0 * a + w1 * d) + w2 * g;
    wc[0] = w0;
    wc[1] = w1;
    wc[2] = w2;
}

// off[t] and off[n + t] of face t from the weights w (3, nc) of its cells
// c1[t] and c2[t]; the face arrays have row stride nfs, the list holds faces
// f0 .. f0 + n of them (w is not __restrict__: the refresh's entry writes it
// in the same launch, before a grid barrier)
__device__ __forceinline__ void face_couplings(long long t, long long n,
                                               long long f0, long long nfs,
                                               long long nc,
                                               const int* __restrict__ c1,
                                               const int* __restrict__ c2,
                                               const double* w,
                                               const double* __restrict__ fL,
                                               const double* __restrict__ fR,
                                               double* __restrict__ off) {
    const long long f = f0 + t;
    const long long L = c1[t], R = c2[t];
    double s = w[L] * fR[0 * nfs + f];
    s = s + w[nc + L] * fR[3 * nfs + f];
    s = s + w[2 * nc + L] * fR[6 * nfs + f];
    off[t] = s;
    double u = w[R] * fL[0 * nfs + f];
    u = u + w[nc + R] * fL[3 * nfs + f];
    u = u + w[2 * nc + R] * fL[6 * nfs + f];
    off[n + t] = -u;
}

}  // namespace opm_cpr
