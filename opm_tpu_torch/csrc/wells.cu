// K5: the Schur complement of the well unknowns, for Hopper: the reduced
// operator's well term out -= C D^-1 (B v), the reduced right-hand side
// r_cell - C D^-1 r_well and the well recovery D^-1 (r_well - B x).
//
// Replaces the JAX package's models/linearize.py well_apply_B (:596),
// well_apply_C (:607) and the closures of schur_eliminate_wells
// (:617-662), which XLA fused on the TPU into small gathers, einsums and
// a scatter-add, and the per-well regularised 4x4 inverses D^-1
// (linalg/precond.py inv4x4 :42), which the right-hand side's launch forms
// once per Newton system (wells.cuh inv4x4, one thread per well of its
// block 0) before its own use; the recovery and the reduced operator read
// them from the workspace.
//
// What bounds it on the card: launch latency. The well arrays are a few
// hundred perforations (a few tens of KB); the work is O(npf) against the
// O(nc) cell operator it follows. Design (the device code in wells.cuh):
// on the main path the reduced operator's well term is no launch of its
// own but part of the cell operator's launches (block7.cu, faces.cu): an
// extra block 0 of the first forms the well vector and C w per perforated
// cell, the block of the last that finishes last subtracts it;
// opm_schur_matvec is the same term as one block, the stand-alone entry
// that chip_smoke.py holds against its plain version. The right-hand side
// is one pass: an extra block 0 forms D^-1 r_well and C D^-1 r_well per
// perforated cell once while the others copy r_cell, and the last block
// rewrites the perforated cells. The recovery (once per Newton) is one
// block. Scratch and the ticket come from the workspace (wells.cuh Wells),
// so no entry reserves shared memory and no perforation count is capped.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "wells.cuh"

namespace {

using opm_wells::Wells;

constexpr int kThreads = 256;
// the right-hand side's copy: one block per this many cells, all three
// rows (three loads in flight per step)
constexpr int kCellsPerBlock = 2048;

// out (3, nc) -= C D^-1 B v; one block
__global__ void __launch_bounds__(kThreads)
    schur_matvec_kernel(Wells W, long long nc, const double* __restrict__ v,
                        double* out) {
    opm_wells::matvec_term(W, nc, v, out);
}

// xw (nw, 4) = D^-1 (r_well - B x); one block
__global__ void __launch_bounds__(kThreads)
    schur_recover_kernel(Wells W, long long nc, const double* __restrict__ x,
                         const double* __restrict__ r_well,
                         double* __restrict__ xw) {
    opm_wells::apply_B(W, nc, x, W.wf);
    __syncthreads();
    for (int w = threadIdx.x; w < W.nw; w += blockDim.x) {
        double b[4];
        opm_wells::well_sums(W, w, W.wf, b);
        for (int i = 0; i < 4; ++i) b[i] = r_well[4 * w + i] - b[i];
        opm_wells::dinv_apply(W, w, b, xw + 4 * w);
    }
}

// out (3, nc) = r_cell - C D^-1 r_well: with wells an extra block 0 forms
// D^-1 r_well and C w per perforated cell (first, with wd, D^-1 itself
// into W.dinv, which dinv points to: one thread per well, which then reads
// back only its own well's block), the other blocks copy kCellsPerBlock
// cells each, the last one rewrites the perforated cells
__global__ void __launch_bounds__(kThreads)
    schur_rhs_kernel(Wells W, long long nc,
                     const double* __restrict__ r_cell,
                     const double* __restrict__ r_well,
                     const double* __restrict__ wd, double* dinv,
                     double* out) {
    const int shift = W.nw != 0 ? 1 : 0;
    if (shift && blockIdx.x == 0) {
        for (int w = threadIdx.x; w < W.nw; w += blockDim.x) {
            if (wd) opm_wells::inv4x4(wd + 16 * w, dinv + 16 * w);
            opm_wells::dinv_apply(W, w, r_well + 4 * w, W.w4 + 4 * w);
        }
        __syncthreads();
        opm_wells::cell_terms(W);
    }
    const int b = (int)blockIdx.x - shift;
    const long long lo = (long long)b * kCellsPerBlock;
    const long long hi = lo + kCellsPerBlock < nc ? lo + kCellsPerBlock : nc;
    for (long long c = lo + threadIdx.x; b >= 0 && c < hi; c += blockDim.x)
        for (int i = 0; i < 3; ++i) out[i * nc + c] = r_cell[i * nc + c];
    if (W.nw == 0 || !opm_wells::last_block(W.ticket)) return;
    opm_wells::subtract_C(W, nc, r_cell, out);
}

}  // namespace

extern "C" {

// wells: a host pointer to opm_wells::Wells (nw > 0; the workspace's wf,
// w4 and ticket included)
int opm_schur_matvec(const void* wells, long long nc, const double* v,
                     double* out, cudaStream_t stream) {
    const Wells W = opm_wells::from_host(wells, opm_wells::kPrologue |
                                                    opm_wells::kEpilogue);
    if (W.nw == 0) return 0;
    schur_matvec_kernel<<<1, kThreads, 0, stream>>>(W, nc, v, out);
    return (int)cudaGetLastError();
}

int opm_schur_recover(const void* wells, long long nc, const double* x,
                      const double* r_well, double* xw,
                      cudaStream_t stream) {
    const Wells W = opm_wells::from_host(wells);
    if (W.nw == 0) return 0;
    schur_recover_kernel<<<1, kThreads, 0, stream>>>(W, nc, x, r_well, xw);
    return (int)cudaGetLastError();
}

// wells may be null (no wells: out = r_cell); wd (nw, 4, 4) the well
// blocks, or null where the workspace's D^-1 is formed already: with wd the
// launch forms D^-1 into the workspace's dinv (the same address) first
int opm_schur_rhs(const void* wells, long long nc, const double* r_cell,
                  const double* r_well, const double* wd, double* dinv,
                  double* out, cudaStream_t stream) {
    if (nc == 0) return 0;
    const Wells W = opm_wells::from_host(wells);
    const long long blocks = (nc + kCellsPerBlock - 1) / kCellsPerBlock
        + (W.nw != 0 ? 1 : 0);
    schur_rhs_kernel<<<(int)blocks, kThreads, 0, stream>>>(
        W, nc, r_cell, r_well, wd, dinv, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
