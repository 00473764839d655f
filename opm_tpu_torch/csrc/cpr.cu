// K6: the per-Newton CPR setup in one pass over the cells, for Hopper;
// with K6-faces, the pressure couplings over a face list.
//
// Replaces the JAX package's linalg/precond.py inv3x3_rows (:113-137),
// quasi_impes_weights (:174-184) and cpr_pressure_system (:207-263, the
// structured branch and the face-list one, :245-262), which XLA fused on
// the TPU. The restriction rp = sum_i w_i r_i of make_cpr_cells (:391) is
// formed in the V-cycle's down leg (the right-hand side entries of gmg.cu
// and amg.cu).
//
// Setup, per cell c with 3x3 diagonal block D_c (diag, (9, nc) row-major):
//   dinv_c = D_c^-1 (closed form through 1/det),
//   w_c    = row 0 of D_c^-1 (first-row cofactors / det, a true division),
//   diag_p = w0 D00 + w1 D10 + w2 D20,
// and for each face f of the grid (face_L/face_R (9, nf), grid face order)
//   a_LR[f] =  sum_i w_i[L] face_R[3 i][f],   a_RL[f] = -sum_i w_i[R] face_L[3 i][f],
// written as off = [a_LR | a_RL] (2 nf). Each face value needs the weights
// of one of its cells only, so a cell's thread writes a_LR of the <= 3
// faces where it is the left cell and a_RL of the <= 3 where it is the
// right cell: every output is written once, no thread reads another's
// weights, no atomics, one launch. The face arrays' row stride may exceed
// the stencil's face count (an embedded grid's extra faces follow; the
// structured GMG drops them from the pressure system, precond.py
// _pressure_off_for), and off then holds the stencil faces only.
//
// On a grid with a face list the main path runs K6 inside K10's value
// refresh (amg.cu amg_refresh_setup: the cell part, a grid barrier, a
// thread per face, a grid barrier, the refresh), one launch a Newton. Here
// are its stand-alone forms: the cell part (setup_cells) then K6-faces, a
// thread per face gathering the weights of its two cells (faces_kernel,
// cpr_cell.cuh face_couplings). A one-launch walk of a thread per cell over
// the list's incidence CSR (the stencil form's pattern: each cell writes
// the couplings of its own faces from its weights in registers) was
// slower on the Norne-class gather grid (17.3 against the pair's 9.2 us
// of device time, PERF.md) and was not kept: the faces come in grid face
// order, so the pair's loads are mostly coalesced, while at each step of
// the walk the threads of a warp load faces of different directions.
//
// What bounds it on the card: memory traffic. Per cell it reads 9 diagonal
// entries and 3 entries of each of its face blocks' pressure columns (<= 6
// on a stencil), and writes 9 + 3 + 1 values and one value per face.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "cpr_cell.cuh"

namespace {

constexpr int kThreads = 256;

using opm_cpr::setup_cell;

__global__ void setup_kernel(int nx, int ny, int nz, long long nc,
                             long long nf, long long nfs, long long ofs_y,
                             long long ofs_z,
                             const double* __restrict__ diag,
                             const double* __restrict__ fL,
                             const double* __restrict__ fR,
                             double* __restrict__ dinv,
                             double* __restrict__ w,
                             double* __restrict__ diag_p,
                             double* __restrict__ off) {
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nc) return;
    double wc[3];
    setup_cell(nc, c, diag, dinv, w, diag_p, wc);
    const double w0 = wc[0], w1 = wc[1], w2 = wc[2];

    const int ix = (int)(c % nx);
    const int jy = (int)((c / nx) % ny);
    const int kz = (int)(c / ((long long)nx * ny));
    // faces where this cell is left (a_LR) and right (a_RL)
    long long left[3], right[3];
    left[0] = ix < nx - 1 ? ((long long)kz * ny + jy) * (nx - 1) + ix : -1;
    right[0] = ix > 0 ? ((long long)kz * ny + jy) * (nx - 1) + ix - 1 : -1;
    left[1] = jy < ny - 1
        ? ofs_y + ((long long)kz * (ny - 1) + jy) * nx + ix : -1;
    right[1] = jy > 0
        ? ofs_y + ((long long)kz * (ny - 1) + jy - 1) * nx + ix : -1;
    left[2] = kz < nz - 1 ? ofs_z + ((long long)kz * ny + jy) * nx + ix : -1;
    right[2] = kz > 0
        ? ofs_z + ((long long)(kz - 1) * ny + jy) * nx + ix : -1;
    for (int dir = 0; dir < 3; ++dir) {
        long long fl = left[dir];
        if (fl >= 0) {
            double s = w0 * fR[0 * nfs + fl];
            s = s + w1 * fR[3 * nfs + fl];
            s = s + w2 * fR[6 * nfs + fl];
            off[fl] = s;
        }
        long long fr = right[dir];
        if (fr >= 0) {
            double s = w0 * fL[0 * nfs + fr];
            s = s + w1 * fL[3 * nfs + fr];
            s = s + w2 * fL[6 * nfs + fr];
            off[nf + fr] = -s;
        }
    }
}

__global__ void setup_cells_kernel(long long nc,
                                   const double* __restrict__ diag,
                                   double* __restrict__ dinv,
                                   double* __restrict__ w,
                                   double* __restrict__ diag_p) {
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nc) return;
    double wc[3];
    setup_cell(nc, c, diag, dinv, w, diag_p, wc);
}

// K6-faces: off = [a_LR | a_RL] over faces f0 .. f0 + n of the face arrays
// (row stride nfs), written at off[f - f0] and off[n + f - f0]
__global__ void faces_kernel(long long n, long long f0, long long nfs,
                             long long nc, const int* __restrict__ c1,
                             const int* __restrict__ c2,
                             const double* __restrict__ w,
                             const double* __restrict__ fL,
                             const double* __restrict__ fR,
                             double* __restrict__ off) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    opm_cpr::face_couplings(t, n, f0, nfs, nc, c1, c2, w, fL, fR, off);
}

}  // namespace

extern "C" {

int opm_cpr_setup(int nx, int ny, int nz, long long nfs, const double* diag,
                  const double* fL, const double* fR, double* dinv,
                  double* w, double* diag_p, double* off,
                  cudaStream_t stream) {
    long long nc = (long long)nx * ny * nz;
    long long nfx = (long long)(nx - 1) * ny * nz;
    long long nfy = (long long)nx * (ny - 1) * nz;
    long long nf = nfx + nfy + (long long)nx * ny * (nz - 1);
    if (nc == 0) return 0;
    int blocks = (int)((nc + kThreads - 1) / kThreads);
    setup_kernel<<<blocks, kThreads, 0, stream>>>(
        nx, ny, nz, nc, nf, nfs, nfx, nfx + nfy, diag, fL, fR, dinv, w,
        diag_p, off);
    return (int)cudaGetLastError();
}

int opm_cpr_setup_cells(long long nc, const double* diag, double* dinv,
                        double* w, double* diag_p, cudaStream_t stream) {
    if (nc == 0) return 0;
    int blocks = (int)((nc + kThreads - 1) / kThreads);
    setup_cells_kernel<<<blocks, kThreads, 0, stream>>>(nc, diag, dinv, w,
                                                        diag_p);
    return (int)cudaGetLastError();
}

int opm_cpr_faces(long long n, long long f0, long long nfs, long long nc,
                  const int* c1, const int* c2, const double* w,
                  const double* fL, const double* fR, double* off,
                  cudaStream_t stream) {
    if (n == 0) return 0;
    int blocks = (int)((n + kThreads - 1) / kThreads);
    faces_kernel<<<blocks, kThreads, 0, stream>>>(n, f0, nfs, nc, c1, c2, w,
                                                  fL, fR, off);
    return (int)cudaGetLastError();
}

}  // extern "C"
