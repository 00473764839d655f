// K4: the block-3x3 7-point operator y = A x of the structured Jacobian,
// and the K6 block-Jacobi smoothing step x + D^-1 (r - A x) fused with it,
// for Hopper.
//
// Replaces the JAX package's models/linearize.py _matvec_cells_structured
// (:559-593, with bapply_rows :446 and _bapply9 :497) and the stage-2
// smoothing of linalg/precond.py make_cpr_cells (:401-403), which XLA
// fused on the TPU into shifted-slice passes and pad+add scatters.
//
// Blocks are (9, n) row-major over (equation, variable): diag (9, nc),
// face_L/face_R (9, nf) in grid.build_grid's face order (x faces
// (nz, ny, nx-1), then y faces (nz, ny-1, nx), then z faces
// (nz-1, ny, nx)), then an embedded grid's extra faces, which these kernels
// skip (faces.cu adds them; nf is the face arrays' row stride); vectors are
// (3, nc), or (nc,) for a pressure-only iterate (rows 1 and 2 zero).
//
// What bounds it on the card: memory traffic. Per cell the matvec reads
// its 9 diagonal entries, 18 entries of each of its <= 6 faces (each face
// block is read by both of its cells; the second read mostly hits L2) and
// 3 values of itself and each neighbour, and writes 3 values: about 9 +
// 2 * 18 * 3 + 3 + 3 doubles per cell from memory. Design: gather form,
// one thread per cell, the cell's row of A in registers, summed in the
// reference's order (the diagonal product, then per direction x, y, z the
// right neighbour's +face_R term and the left neighbour's -face_L term),
// so the result is bitwise that of the plain version; no atomics. The
// smoothing entry adds the 9 inverse-block entries and the residual and
// writes the new iterate (a pressure-only iterate has rows 1 and 2 zero).
// The matvec optionally carries the reduced operator's well term (K5,
// wells.cuh): an extra block 0 forms D^-1 (B x) while the others compute
// their rows, and the block that finishes last subtracts C D^-1 (B x) at
// the perforated cells, so the Schur-reduced operator is one launch.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "wells.cuh"

namespace {

constexpr int kThreads = 256;

struct Op {
    int nx, ny, nz;
    long long nc, nf;
    long long ofs_y, ofs_z;          // face offsets of the y and z blocks
    const double* diag;
    const double* fL;
    const double* fR;
};

// x component c of cell idx (a pressure-only iterate has rows 1, 2 zero)
__device__ __forceinline__ double xval(const double* x, bool p_only,
                                       long long nc, int c, long long idx) {
    if (p_only) return c == 0 ? x[idx] : 0.0;
    return x[c * nc + idx];
}

// rows9 (stride n, entry f) applied to the vector at cell idx
__device__ __forceinline__ void bapply(const double* rows, long long n,
                                       long long f, const double* x,
                                       bool p_only, long long nc,
                                       long long idx, double out[3]) {
    double v0 = xval(x, p_only, nc, 0, idx);
    double v1 = xval(x, p_only, nc, 1, idx);
    double v2 = xval(x, p_only, nc, 2, idx);
    for (int i = 0; i < 3; ++i) {
        double acc = rows[(3 * i) * n + f] * v0;
        acc = acc + rows[(3 * i + 1) * n + f] * v1;
        acc = acc + rows[(3 * i + 2) * n + f] * v2;
        out[i] = acc;
    }
}

// (A x) at cell c = (i, j, k)
__device__ __forceinline__ void row_apply(const Op& A, const double* x,
                                          bool p_only, int i, int j, int k,
                                          double y[3]) {
    const long long nx = A.nx, ny = A.ny, nz = A.nz, nc = A.nc;
    const long long c = (k * ny + j) * nx + i;
    double t[3];
    bapply(A.diag, nc, c, x, p_only, nc, c, y);
    // x direction: face (k, j, i) joins i and i + 1
    if (i < nx - 1) {
        bapply(A.fR, A.nf, (k * ny + j) * (nx - 1) + i, x, p_only, nc, c + 1,
               t);
        for (int e = 0; e < 3; ++e) y[e] = y[e] + t[e];
    }
    if (i > 0) {
        bapply(A.fL, A.nf, (k * ny + j) * (nx - 1) + i - 1, x, p_only, nc,
               c - 1, t);
        for (int e = 0; e < 3; ++e) y[e] = y[e] - t[e];
    }
    // y direction: face (k, j, i) joins j and j + 1
    if (j < ny - 1) {
        bapply(A.fR, A.nf, A.ofs_y + (k * (ny - 1) + j) * nx + i, x, p_only,
               nc, c + nx, t);
        for (int e = 0; e < 3; ++e) y[e] = y[e] + t[e];
    }
    if (j > 0) {
        bapply(A.fL, A.nf, A.ofs_y + (k * (ny - 1) + j - 1) * nx + i, x,
               p_only, nc, c - nx, t);
        for (int e = 0; e < 3; ++e) y[e] = y[e] - t[e];
    }
    // z direction: face (k, j, i) joins k and k + 1
    if (k < nz - 1) {
        bapply(A.fR, A.nf, A.ofs_z + (k * ny + j) * nx + i, x, p_only, nc,
               c + nx * ny, t);
        for (int e = 0; e < 3; ++e) y[e] = y[e] + t[e];
    }
    if (k > 0) {
        bapply(A.fL, A.nf, A.ofs_z + ((k - 1) * ny + j) * nx + i, x, p_only,
               nc, c - nx * ny, t);
        for (int e = 0; e < 3; ++e) y[e] = y[e] - t[e];
    }
}

// out = A x, then (W.nw > 0) out -= C D^-1 (B x): the well vector by the
// extra block 0, the subtraction by the last block
__global__ void matvec_kernel(Op A, const double* __restrict__ x,
                              int p_only, double* out, opm_wells::Wells W) {
    opm_wells::matvec_prologue(W, A.nc, x);
    const int b = (int)blockIdx.x - opm_wells::prologue_blocks(W);
    const long long c = (long long)b * blockDim.x + threadIdx.x;
    if (c >= 0 && c < A.nc) {
        int i = (int)(c % A.nx);
        int j = (int)((c / A.nx) % A.ny);
        int k = (int)(c / ((long long)A.nx * A.ny));
        double y[3];
        row_apply(A, x, p_only != 0, i, j, k, y);
        for (int e = 0; e < 3; ++e) out[e * A.nc + c] = y[e];
    }
    opm_wells::matvec_epilogue(W, A.nc, out);
}

__global__ void smooth_kernel(Op A, const double* __restrict__ dinv,
                              const double* __restrict__ x, int p_only,
                              const double* __restrict__ r,
                              double* __restrict__ out) {
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= A.nc) return;
    int i = (int)(c % A.nx);
    int j = (int)((c / A.nx) % A.ny);
    int k = (int)(c / ((long long)A.nx * A.ny));
    const bool po = p_only != 0;
    double y[3];
    row_apply(A, x, po, i, j, k, y);
    double e0 = r[c] - y[0];
    double e1 = r[A.nc + c] - y[1];
    double e2 = r[2 * A.nc + c] - y[2];
    for (int q = 0; q < 3; ++q) {
        double acc = dinv[(3 * q) * A.nc + c] * e0;
        acc = acc + dinv[(3 * q + 1) * A.nc + c] * e1;
        acc = acc + dinv[(3 * q + 2) * A.nc + c] * e2;
        out[q * A.nc + c] = xval(x, po, A.nc, q, c) + acc;
    }
}

Op make_op(int nx, int ny, int nz, long long nf, const double* diag,
           const double* fL, const double* fR) {
    Op A;
    A.nx = nx;
    A.ny = ny;
    A.nz = nz;
    A.nc = (long long)nx * ny * nz;
    long long nfx = (long long)(nx - 1) * ny * nz;
    long long nfy = (long long)nx * (ny - 1) * nz;
    A.nf = nf;
    A.ofs_y = nfx;
    A.ofs_z = nfx + nfy;
    A.diag = diag;
    A.fL = fL;
    A.fR = fR;
    return A;
}

}  // namespace

extern "C" {

// wells: null, or a host pointer to opm_wells::Wells (x (3, nc)): the
// reduced operator's well term in the same launch, its phases (wells.cuh
// kPrologue | kEpilogue) given by well_phases
int opm_block7_matvec(int nx, int ny, int nz, long long nf, int p_only,
                      const double* diag, const double* fL, const double* fR,
                      const double* x, double* out, const void* wells,
                      int well_phases, cudaStream_t stream) {
    Op A = make_op(nx, ny, nz, nf, diag, fL, fR);
    if (A.nc == 0) return 0;
    const opm_wells::Wells W = opm_wells::from_host(wells, well_phases);
    int blocks = (int)((A.nc + kThreads - 1) / kThreads)
        + opm_wells::prologue_blocks(W);
    matvec_kernel<<<blocks, kThreads, 0, stream>>>(A, x, p_only, out, W);
    return (int)cudaGetLastError();
}

int opm_block7_smooth(int nx, int ny, int nz, long long nf, int p_only,
                      const double* diag, const double* fL, const double* fR,
                      const double* dinv, const double* x, const double* r,
                      double* out, cudaStream_t stream) {
    Op A = make_op(nx, ny, nz, nf, diag, fL, fR);
    if (A.nc == 0) return 0;
    int blocks = (int)((A.nc + kThreads - 1) / kThreads);
    smooth_kernel<<<blocks, kThreads, 0, stream>>>(A, dinv, x, p_only, r,
                                                   out);
    return (int)cudaGetLastError();
}

}  // extern "C"
