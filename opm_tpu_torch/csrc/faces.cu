// K3-faces and K4-faces: the TPFA flux divergence, the Jacobian's face
// blocks and the block-3x3 operator over an arbitrary face list, for
// Hopper.
//
// Replaces the JAX package's models/blackoil.py face_fluxes / divergence
// gather branches (:319-338, :359-371: all faces of a gather grid, or the
// "extra" faces of an embedded grid after the structured stencil), and
// models/linearize.py matvec's gather branch (:474-482) and the extra-face
// correction of _matvec_cells_structured (:585-592), with the stage-2
// smoothing step x + D^-1 (r - A x) of linalg/precond.py make_cpr_cells
// (:402-403) fused in; and the face-list branches of linearize.assemble
// (:240-270, an embedded grid's extra faces; :272-320, a gather grid's
// faces): each face's flux and its blocks face_L / face_R chained through
// K2's per-cell tangent columns, folded into r_cell and diag. XLA lowered
// these to gathers and scatter-adds.
//
// Layout: per output row t (cell rows[t], or t when rows is null) its
// incident faces ent[ptr[t] .. ptr[t+1]) with the neighbour cell nbr[];
// ent >= 0 is a face where the row's cell is the left cell c1, ent = -f-1
// one where it is the right cell c2. The host builds this CSR once per grid
// in the order of the plain version's scatter-adds: the row's c1 faces in
// face order, then its c2 faces in face order.
//
// What bounds it on the card: memory traffic. The divergence reads per
// face the 11 quantities of both cells, its transmissibility and the two
// depths; the operator per face its 18 block entries (face_R for the left
// row, face_L for the right row) and the neighbour's 3 values. Design:
// gather form, one thread per row, each face's flux or block product
// computed by the row's thread with the plain version's arithmetic and
// summed in registers in the CSR order, so the result equals the plain
// version on the CPU bit for bit; no atomics. A row may start from a base
// (the structured kernel's result on an embedded grid, updated in place).
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "tpfa_face.cuh"

namespace {

using opm_tpfa::Cells;
using opm_tpfa::Face;
using opm_tpfa::face_blocks;
using opm_tpfa::face_primal;

constexpr int kThreads = 256;

struct Csr {
    int n_rows;
    const int* rows;    // null: row t is cell t
    const int* ptr;
    const int* ent;
    const int* nbr;
};

__global__ void faces_div_kernel(Csr g, long long nc, Cells q,
                                 const double* __restrict__ depth,
                                 const double* __restrict__ trans, double gr,
                                 int accumulate, double* div) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= g.n_rows) return;
    long long c = g.rows ? g.rows[t] : t;
    double acc[3];
    for (int e = 0; e < 3; ++e) acc[e] = accumulate ? div[e * nc + c] : 0.0;
    for (int k = g.ptr[t]; k < g.ptr[t + 1]; ++k) {
        int s = g.ent[k];
        long long o = g.nbr[k];
        bool left = s >= 0;
        long long f = left ? s : -(long long)s - 1;
        long long L = left ? c : o;
        long long R = left ? o : c;
        Face fa;
        double flux[3];
        face_primal(q, nc, L, R, trans[f], gr, depth[L] - depth[R], &fa,
                    flux);
        for (int e = 0; e < 3; ++e)
            acc[e] = left ? acc[e] + flux[e] : acc[e] - flux[e];
    }
    for (int e = 0; e < 3; ++e) div[e * nc + c] = acc[e];
}

// r_cell (3, nc) and diag (9, nc) updated in place over the CSR's rows;
// face_L / face_R (9, nf) written at the list's faces (global indices)
__global__ void faces_blocks_kernel(Csr g, long long nc, long long nf,
                                    const double* __restrict__ fv,
                                    const double* __restrict__ fc,
                                    const double* __restrict__ depth,
                                    const double* __restrict__ trans,
                                    double gr, double* __restrict__ r_cell,
                                    double* __restrict__ diag,
                                    double* __restrict__ fL,
                                    double* __restrict__ fR) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= g.n_rows) return;
    long long c = g.rows ? g.rows[t] : t;
    const Cells q{fv, fv + 3 * nc, fv + 6 * nc, fv + 9 * nc, fv + 10 * nc};
    double r[3], d[9], flux[3], bl[9], br[9];
    for (int e = 0; e < 3; ++e) r[e] = r_cell[e * nc + c];
    for (int b = 0; b < 9; ++b) d[b] = diag[b * nc + c];
    for (int k = g.ptr[t]; k < g.ptr[t + 1]; ++k) {
        int s = g.ent[k];
        long long o = g.nbr[k];
        if (s >= 0) {
            face_blocks(q, fc, nc, c, o, trans[s], gr, depth[c] - depth[o],
                        flux, bl, br);
            for (int e = 0; e < 3; ++e) r[e] = r[e] + flux[e];
            for (int b = 0; b < 9; ++b) {
                fL[b * nf + s] = bl[b];
                fR[b * nf + s] = br[b];
                d[b] = d[b] + bl[b];
            }
        } else {
            long long f = -(long long)s - 1;
            face_blocks(q, fc, nc, o, c, trans[f], gr, depth[o] - depth[c],
                        flux, nullptr, br);
            for (int e = 0; e < 3; ++e) r[e] = r[e] + (-flux[e]);
            for (int b = 0; b < 9; ++b) d[b] = d[b] + (-br[b]);
        }
    }
    for (int e = 0; e < 3; ++e) r_cell[e * nc + c] = r[e];
    for (int b = 0; b < 9; ++b) diag[b * nc + c] = d[b];
}

__device__ __forceinline__ double xv(const double* x, bool p_only,
                                     long long nc, int comp, long long c) {
    if (p_only) return comp == 0 ? x[c] : 0.0;
    return x[comp * nc + c];
}

// rows9 (stride n, entry f) applied to the vector at cell c
__device__ __forceinline__ void bapply(const double* __restrict__ rows,
                                       long long n, long long f,
                                       const double* x, bool p_only,
                                       long long nc, long long c,
                                       double out[3]) {
    double v0 = xv(x, p_only, nc, 0, c);
    double v1 = xv(x, p_only, nc, 1, c);
    double v2 = xv(x, p_only, nc, 2, c);
    for (int i = 0; i < 3; ++i) {
        double acc = rows[(3 * i) * n + f] * v0;
        acc = acc + rows[(3 * i + 1) * n + f] * v1;
        acc = acc + rows[(3 * i + 2) * n + f] * v2;
        out[i] = acc;
    }
}

// y = diag x (or base) + sum over the row's faces; with dinv,
// out = x + D^-1 (r - y), else out = y. base may alias out.
__global__ void faces_apply_kernel(Csr g, long long nc, long long nf,
                                   const double* __restrict__ diag,
                                   const double* base,
                                   const double* __restrict__ fL,
                                   const double* __restrict__ fR,
                                   const double* __restrict__ x, int p_only,
                                   const double* __restrict__ dinv,
                                   const double* __restrict__ r,
                                   double* out) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= g.n_rows) return;
    long long c = g.rows ? g.rows[t] : t;
    const bool po = p_only != 0;
    double y[3], tt[3];
    if (diag) {
        bapply(diag, nc, c, x, po, nc, c, y);
    } else {
        for (int e = 0; e < 3; ++e) y[e] = base[e * nc + c];
    }
    for (int k = g.ptr[t]; k < g.ptr[t + 1]; ++k) {
        int s = g.ent[k];
        long long o = g.nbr[k];
        if (s >= 0) {
            bapply(fR, nf, s, x, po, nc, o, tt);
            for (int e = 0; e < 3; ++e) y[e] = y[e] + tt[e];
        } else {
            bapply(fL, nf, -(long long)s - 1, x, po, nc, o, tt);
            for (int e = 0; e < 3; ++e) y[e] = y[e] - tt[e];
        }
    }
    if (!dinv) {
        for (int e = 0; e < 3; ++e) out[e * nc + c] = y[e];
        return;
    }
    double e0 = r[c] - y[0];
    double e1 = r[nc + c] - y[1];
    double e2 = r[2 * nc + c] - y[2];
    for (int q = 0; q < 3; ++q) {
        double acc = dinv[(3 * q) * nc + c] * e0;
        acc = acc + dinv[(3 * q + 1) * nc + c] * e1;
        acc = acc + dinv[(3 * q + 2) * nc + c] * e2;
        out[q * nc + c] = xv(x, po, nc, q, c) + acc;
    }
}

inline int blocks_for(long long n) {
    return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// div (3, nc) over the CSR's rows: the face fluxes' signed sum, added to
// div's values when accumulate != 0
int opm_faces_div(int n_rows, const int* rows, const int* ptr,
                  const int* ent, const int* nbr, long long nc,
                  const double* p, const double* rho, const double* bmob,
                  const double* rs, const double* rv, const double* depth,
                  const double* trans, double g, int accumulate, double* div,
                  cudaStream_t stream) {
    if (n_rows == 0) return 0;
    Csr csr{n_rows, rows, ptr, ent, nbr};
    Cells q{p, rho, bmob, rs, rv};
    faces_div_kernel<<<blocks_for(n_rows), kThreads, 0, stream>>>(
        csr, nc, q, depth, trans, g, accumulate, div);
    return (int)cudaGetLastError();
}

// the face blocks of the CSR's faces from the face inputs fv (11, nc) and
// their tangent columns fc (3, 11, nc): r_cell and diag updated in place,
// face_L / face_R (9, nf) written at the faces
int opm_faces_blocks(int n_rows, const int* rows, const int* ptr,
                     const int* ent, const int* nbr, long long nc,
                     long long nf, const double* fv, const double* fc,
                     const double* depth, const double* trans, double g,
                     double* r_cell, double* diag, double* fL, double* fR,
                     cudaStream_t stream) {
    if (n_rows == 0) return 0;
    Csr csr{n_rows, rows, ptr, ent, nbr};
    faces_blocks_kernel<<<blocks_for(n_rows), kThreads, 0, stream>>>(
        csr, nc, nf, fv, fc, depth, trans, g, r_cell, diag, fL, fR);
    return (int)cudaGetLastError();
}

// blocks (9, nc) diag and dinv, (9, nf) face_L/face_R; vectors (3, nc), x
// (nc,) when p_only; diag null: start each row from base (3, nc); dinv
// null: the plain product
int opm_faces_apply(int n_rows, const int* rows, const int* ptr,
                    const int* ent, const int* nbr, long long nc,
                    long long nf, const double* diag, const double* base,
                    const double* fL, const double* fR, const double* x,
                    int p_only, const double* dinv, const double* r,
                    double* out, cudaStream_t stream) {
    if (n_rows == 0) return 0;
    Csr csr{n_rows, rows, ptr, ent, nbr};
    faces_apply_kernel<<<blocks_for(n_rows), kThreads, 0, stream>>>(
        csr, nc, nf, diag, base, fL, fR, x, p_only, dinv, r, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
