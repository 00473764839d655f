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
// depths; the face blocks also the 33 tangent columns of both cells, and
// write 18 block entries; the operator per face its 18 block entries
// (face_R for the left row, face_L for the right row) and the neighbour's
// 3 values. Design of the divergence and the operator: gather form, one
// thread per row, each face's flux or block product computed by the row's
// thread with the plain version's arithmetic and summed in registers in
// the CSR order, so the result equals the plain version on the CPU bit
// for bit; no atomics. A row may start from a base (the structured
// kernel's result on an embedded grid, updated in place). The divergence
// keeps this form, each face's flux evaluated by both of its rows. As a
// face phase (each flux once into a (3, n) scratch) and a row phase, as
// the face blocks below, it took 4.8-5.3 us of device time on an H100 on
// E's epilogue against 7.3-7.4 (its 7,578 rows underfill the card) but
// 7.9-19.2 on G against 11.1 (the scratch's write and gathered re-read
// cost more than a second evaluation of a flux, about 30 operations),
// and one call, host-bound, was no faster on either grid; one cooperative
// launch was no better (opm_tpu_torch/tools/assembly_ab.py, PERF.md §6).
// The operator (K4-faces, with the smoothing step) reads its blocks from a
// sliced-ELL copy written once per Newton system by the face blocks' row
// phase: read in
// face order, a warp's neighbouring cells found their right-side faces far
// apart, a 32-byte sector per lane; in the packed copy lane i of slot j
// reads address base + 32 b + i.
// The face blocks run a face phase, then a row phase (two launches): a
// thread per face evaluates its flux and both blocks once (six tangent
// evaluations) and writes them in face order; then a thread per row and
// sum adds what the row's faces wrote, in the CSR order, and a block
// entry's thread also writes the other block of each face it visits,
// signed, into the operator's sliced-ELL copy (the layout's rows are
// this CSR's, so the pack is no launch of its own). The blocks
// face_L / face_R are outputs anyway, so the row phase re-reads a value a
// visit from face arrays (the flux from a (3, n) scratch) instead of
// gathering the neighbour's 44 input rows and evaluating the face again.
// The stencil form (blocks.cu) makes the other trade: at SPE10-2's 3.3M
// faces the blocks and flux re-read would be 560 MB from device memory;
// on G they are 36 MB, near the 50 MB L2. Measured on an H100 on G: one
// cooperative launch with a grid barrier between the phases was no
// faster than two launches; three threads a face (one a primary column)
// were no faster than one; a thread a row instead of a thread a sum was
// slower, and so were face records of 21 values read whole by the row.
// The plain product optionally carries the reduced operator's well term
// (K5, wells.cuh): the well vector by an extra block 0, the subtraction at
// the perforated cells by the block that finishes last.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "tpfa_face.cuh"
#include "wells.cuh"

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

template <bool kThr>
__global__ void faces_div_kernel(Csr g, long long nc, Cells q,
                                 const double* __restrict__ depth,
                                 const double* __restrict__ trans,
                                 const double* __restrict__ thr, double gr,
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
                    flux, opm_tpfa::thr_at<kThr>(thr, f));
        for (int e = 0; e < 3; ++e)
            acc[e] = left ? acc[e] + flux[e] : acc[e] - flux[e];
    }
    for (int e = 0; e < 3; ++e) div[e * nc + c] = acc[e];
}

// The face blocks in two phases. The face phase, a thread per face i of
// the list (global index first + i, cells c1[i], c2[i]): the face's flux
// and both blocks once, written at the face to face_L / face_R (9, nf)
// and the flux to a scratch (3, n), all in face order. The row phase, a
// thread per CSR row and one of its 12 sums (3 of r_cell, 9 of diag): the
// row's faces in the CSR order, r += flux, d += face_L as the left cell
// and r += (-flux), d += (-face_R) as the right cell. Each sum has the
// operations and order of the one-pass design, so the same bits.
struct ListFaces {
    long long first, n, nf;
    const int* c1;
    const int* c2;
};

template <bool kThr>
__global__ void faces_blocks_face_kernel(ListFaces lf, long long nc,
                                         const double* __restrict__ fv,
                                         const double* __restrict__ fc,
                                         const double* __restrict__ depth,
                                         const double* __restrict__ trans,
                                         const double* __restrict__ thr,
                                         double gr,
                                         double* __restrict__ flux,
                                         double* __restrict__ fL,
                                         double* __restrict__ fR) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= lf.n) return;
    const Cells q{fv, fv + 3 * nc, fv + 6 * nc, fv + 9 * nc, fv + 10 * nc};
    const long long f = lf.first + i;
    const long long L = lf.c1[i], R = lf.c2[i];
    double fl[3], bl[9], br[9];
    face_blocks(q, fc, nc, L, R, trans[f], gr, depth[L] - depth[R], fl, bl,
                br, opm_tpfa::thr_at<kThr>(thr, f));
    for (int e = 0; e < 3; ++e) flux[e * lf.n + i] = fl[e];
    for (int b = 0; b < 9; ++b) {
        fL[b * lf.nf + f] = bl[b];
        fR[b * lf.nf + f] = br[b];
    }
}

// The operator's sliced-ELL layout (built once per grid on the host from
// the cell CSR of the rows the faces touch, filled once per Newton system):
// the rows in slices of 32, one warp; slice s holds chunk0[s+1] -
// chunk0[s] slots, its longest row. Slot j of row t (lane i = t % 32 of
// slice s) is entry e = 32 ch + i, ch = chunk0[s] + j, with the neighbour
// cell col[e] and the signed block entry b (row 3 eq + var) at blk[288 ch
// + 32 b + i] (sell_first, sell_blk: the only addressing of the layout on
// the card): +face_R for a face where the row's cell is the left cell,
// -face_L where it is the right cell, in the CSR's order. Lane i of a
// warp reads base + 32 b + i: coalesced. Pads (slots past a row's length,
// and every slot of a lane that holds no row) are 0 in blk and read by no
// thread. On a gather grid row t is cell t (rows and row_of null); on an
// embedded grid the rows are the cells the extra faces touch, rows[t] the
// cell of row t and row_of[c] the row of cell c (-1: none).

// entry e of slot 0 of row t; slot j is entry e + 32 j
__device__ __forceinline__ long long sell_first(const int* chunk0, int t) {
    return 32LL * chunk0[t >> 5] + (t & 31);
}

// block entry b of entry e in blk
__device__ __forceinline__ long long sell_blk(long long e, int b) {
    return 288 * (e >> 5) + 32 * b + (e & 31);
}

// idx = v n32 + t (n32: n_rows rounded up to a slice of 32): sum v of
// row t (v < 3: r_cell row v; else diag row v - 3), updated in place.
// Thread (v >= 3, t) also writes block entry b = v - 3 of row t's slots
// in the sliced-ELL copy blk (the layout above): the CSR's k-th entry of
// the row is slot k - ptr[t], +face_R[b][f] for ent = f >= 0 and
// -face_L[b][f] for ent = -f-1, and the slots past the row's length up
// to its slice's width get 0, also on the lanes of the last slice that
// hold no row; lanes of a warp are consecutive rows of one slice, so each
// slot's writes are coalesced.
__global__ void faces_blocks_row_kernel(Csr g, ListFaces lf, long long nc,
                                        int n32,
                                        const double* __restrict__ flux,
                                        const double* __restrict__ fL,
                                        const double* __restrict__ fR,
                                        double* __restrict__ r_cell,
                                        double* __restrict__ diag,
                                        const int* __restrict__ chunk0,
                                        double* __restrict__ blk) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= 12LL * n32) return;
    const int v = (int)(idx / n32);
    const int t = (int)(idx - (long long)v * n32);
    const bool is_r = v < 3;
    if (is_r && t >= g.n_rows) return;
    const int b = v - 3;
    const long long slot0 = is_r ? 0 : sell_first(chunk0, t);
    const int width = is_r ? 0 : chunk0[(t >> 5) + 1] - chunk0[t >> 5];
    int len = 0;
    if (t < g.n_rows) {
        const long long c = g.rows ? g.rows[t] : t;
        double* out = is_r ? r_cell + v * nc : diag + b * nc;
        // the left and right values of this sum: flux row v (by list
        // index f - first), or face_L / face_R row b (by face index f)
        const double* lv = is_r ? flux + v * lf.n : fL + b * lf.nf;
        const double* rv = is_r ? lv : fR + b * lf.nf;
        const long long off = is_r ? lf.first : 0;
        const int k0 = g.ptr[t];
        len = g.ptr[t + 1] - k0;
        double acc = out[c];
        for (int j = 0; j < len; ++j) {
            const int s = g.ent[k0 + j];
            if (s >= 0) {
                acc = acc + lv[s - off];
                if (!is_r) blk[sell_blk(slot0 + 32LL * j, b)] = rv[s];
            } else {
                const long long f = -(long long)s - 1;
                acc = acc + (-rv[f - off]);
                if (!is_r) blk[sell_blk(slot0 + 32LL * j, b)] = -lv[f];
            }
        }
        out[c] = acc;
    }
    for (int j = len; j < width; ++j)
        blk[sell_blk(slot0 + 32LL * j, b)] = 0.0;
}

__device__ __forceinline__ double xv(const double* x, bool p_only,
                                     long long nc, int comp, long long c) {
    if (p_only) return comp == 0 ? x[c] : 0.0;
    return x[comp * nc + c];
}

struct Sell {
    const int* rows;
    const int* row_of;
    const int* chunk0;
    const int* ptr;    // the CSR's: row t has ptr[t+1] - ptr[t] slots
    const int* col;
    const double* blk;
};

// y = diag x (or base) + the row's signed face blocks times the neighbour
// values, slot by slot; with dinv, out = x + D^-1 (r - y), else out = y.
// One thread per row (row_of null: thread t is row t, its cell rows[t]) or
// per cell (thread c, its row row_of[c] if any). base may alias out where
// the threads are the rows (an in-place update of the touched cells).
// Folding the sign into the blocks is exact: (-a) u + (-b) w == -(a u + b
// w) and y + (-t) == y - t, so the sums are the plain version's.
__device__ __forceinline__ void sell_row(const Sell& g, int t, long long nc,
                                         const double* __restrict__ diag,
                                         const double* base,
                                         const double* __restrict__ x,
                                         int p_only,
                                         const double* __restrict__ dinv,
                                         const double* __restrict__ r,
                                         double* out) {
    int row = t;
    long long c = t;
    if (g.row_of) {
        row = g.row_of[t];
    } else if (g.rows) {
        c = g.rows[t];
    }
    const bool po = p_only != 0;
    double y[3];
    if (diag) {
        const double v0 = xv(x, po, nc, 0, c), v1 = xv(x, po, nc, 1, c),
                     v2 = xv(x, po, nc, 2, c);
        for (int i = 0; i < 3; ++i) {
            double acc = diag[(3 * i) * nc + c] * v0;
            acc = acc + diag[(3 * i + 1) * nc + c] * v1;
            acc = acc + diag[(3 * i + 2) * nc + c] * v2;
            y[i] = acc;
        }
    } else {
        for (int e = 0; e < 3; ++e) y[e] = base[e * nc + c];
    }
    const int len = row >= 0 ? g.ptr[row + 1] - g.ptr[row] : 0;
    const long long slot0 = row >= 0 ? sell_first(g.chunk0, row) : 0;
    for (int j = 0; j < len; ++j) {
        const long long e = slot0 + 32LL * j;
        const long long o = g.col[e];
        const double* b = g.blk + sell_blk(e, 0);
        const double v0 = xv(x, po, nc, 0, o), v1 = xv(x, po, nc, 1, o),
                     v2 = xv(x, po, nc, 2, o);
        for (int i = 0; i < 3; ++i) {
            double acc = b[32 * (3 * i)] * v0;
            acc = acc + b[32 * (3 * i + 1)] * v1;
            acc = acc + b[32 * (3 * i + 2)] * v2;
            y[i] = y[i] + acc;
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

// sell_row for each of the n_threads threads; with W.nw > 0 (the plain
// product) out -= C D^-1 (B x): the well vector by the extra block 0, the
// subtraction by the last block
__global__ void sell_apply_kernel(Sell g, int n_threads, long long nc,
                                  const double* __restrict__ diag,
                                  const double* base,
                                  const double* __restrict__ x, int p_only,
                                  const double* __restrict__ dinv,
                                  const double* __restrict__ r, double* out,
                                  opm_wells::Wells W) {
    opm_wells::matvec_prologue(W, nc, x);
    const int b = (int)blockIdx.x - opm_wells::prologue_blocks(W);
    const int t = b * (int)blockDim.x + (int)threadIdx.x;
    if (t >= 0 && t < n_threads)
        sell_row(g, t, nc, diag, base, x, p_only, dinv, r, out);
    opm_wells::matvec_epilogue(W, nc, out);
}

inline int blocks_for(long long n) {
    return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// div (3, nc) over the CSR's rows: the face fluxes' signed sum, added to
// div's values when accumulate != 0; thr: the faces' THPRES thresholds
// (global face index), or null
int opm_faces_div(int n_rows, const int* rows, const int* ptr,
                  const int* ent, const int* nbr, long long nc,
                  const double* p, const double* rho, const double* bmob,
                  const double* rs, const double* rv, const double* depth,
                  const double* trans, const double* thr, double g,
                  int accumulate, double* div, cudaStream_t stream) {
    if (n_rows == 0) return 0;
    Csr csr{n_rows, rows, ptr, ent, nbr};
    Cells q{p, rho, bmob, rs, rv};
    if (thr)
        faces_div_kernel<true><<<blocks_for(n_rows), kThreads, 0, stream>>>(
            csr, nc, q, depth, trans, thr, g, accumulate, div);
    else
        faces_div_kernel<false><<<blocks_for(n_rows), kThreads, 0,
                                  stream>>>(csr, nc, q, depth, trans, thr, g,
                                            accumulate, div);
    return (int)cudaGetLastError();
}

// the face blocks of the list's n faces (global indices first.., cells c1,
// c2) from the face inputs fv (11, nc) and their tangent columns fc (3,
// 11, nc): face_L / face_R (9, nf) written at the faces and flux (3, n) a
// scratch (the face phase), then r_cell and diag updated in place over
// the CSR's rows and the signed off-diagonal blocks written into blk
// (288 n_chunks,), the sliced-ELL layout of the same CSR with slices
// chunk0 (the row phase): two launches; thr: the faces' THPRES thresholds
// (global face index), or null (the zero threshold's tangent)
int opm_faces_blocks(int n_rows, const int* rows, const int* ptr,
                     const int* ent, const int* nbr, long long first,
                     long long n, const int* c1, const int* c2, long long nc,
                     long long nf, const double* fv, const double* fc,
                     const double* depth, const double* trans,
                     const double* thr, double g,
                     double* flux, double* r_cell, double* diag, double* fL,
                     double* fR, const int* chunk0, double* blk,
                     cudaStream_t stream) {
    if (n == 0) return 0;
    Csr csr{n_rows, rows, ptr, ent, nbr};
    ListFaces lf{first, n, nf, c1, c2};
    const int n32 = (n_rows + 31) / 32 * 32;
    if (thr)
        faces_blocks_face_kernel<true><<<blocks_for(n), kThreads, 0,
                                         stream>>>(lf, nc, fv, fc, depth,
                                                   trans, thr, g, flux, fL,
                                                   fR);
    else
        faces_blocks_face_kernel<false><<<blocks_for(n), kThreads, 0,
                                          stream>>>(lf, nc, fv, fc, depth,
                                                    trans, thr, g, flux, fL,
                                                    fR);
    faces_blocks_row_kernel<<<blocks_for(12LL * n32), kThreads, 0,
                              stream>>>(csr, lf, nc, n32, flux, fL, fR,
                                        r_cell, diag, chunk0, blk);
    return (int)cudaGetLastError();
}

// K4-faces over the sliced-ELL layout of a face list's cell CSR:
// n_threads rows (row_of null) or cells (row_of set); blocks (9, nc) diag
// and dinv; vectors (3, nc), x (nc,) when p_only; diag null: start each
// row from base (3, nc), which may be out when the threads are the rows;
// dinv null: the plain product, which with wells (a host pointer to
// opm_wells::Wells, or null; x (3, nc)) carries the phases well_phases of
// the reduced operator's well term (wells.cuh)
int opm_faces_sell_apply(int n_threads, const int* rows, const int* row_of,
                         const int* chunk0, const int* ptr, const int* col,
                         const double* blk, long long nc, const double* diag,
                         const double* base, const double* x, int p_only,
                         const double* dinv, const double* r, double* out,
                         const void* wells, int well_phases,
                         cudaStream_t stream) {
    const opm_wells::Wells W =
        opm_wells::from_host(dinv ? nullptr : wells, well_phases);
    if (n_threads == 0 && W.nw == 0) return 0;
    Sell g{rows, row_of, chunk0, ptr, col, blk};
    const int blocks = (n_threads ? blocks_for(n_threads) : 1)
        + opm_wells::prologue_blocks(W);
    sell_apply_kernel<<<blocks, kThreads, 0, stream>>>(
        g, n_threads, nc, diag, base, x, p_only, dinv, r, out, W);
    return (int)cudaGetLastError();
}

}  // extern "C"
