// K5: the Schur complement of the well unknowns, for Hopper: the reduced
// operator's well term out -= C D^-1 (B v), the reduced right-hand side
// r_cell - C D^-1 r_well and the well recovery D^-1 (r_well - B x).
//
// Replaces the JAX package's models/linearize.py well_apply_B (:596),
// well_apply_C (:607) and the closures of schur_eliminate_wells
// (:617-662), which XLA fused on the TPU into small gathers, einsums and
// a scatter-add. D^-1 (the per-well regularised 4x4 inverses,
// linalg/precond.py inv4x4 :42) is formed once per Newton by the plain
// version and read here.
//
// Layout: perforation p = w * mp + m of well w; wc (npf, 3, 3) the well
// flux rows x cell variables, cw (npf, 3, 4) the cell rows x well
// variables, perf_cell (npf) int64, dinv (nw, 4, 4), and order (npf)
// int64, the perforations stably sorted by cell (one argsort per
// assembly). A cell's C w is the sum over its perforations in ascending
// order (the plain version's scatter order): the run of ``order`` that
// holds the cell, summed by the thread at the run's first position.
//
// What bounds it on the card: launch latency. The well arrays are a few
// hundred perforations (a few tens of KB); the work is O(npf) against the
// O(nc) cell operator it follows. Design: the matvec and the recovery are
// one block each: B v per perforation into shared memory, the per-well
// sums in perforation order, D^-1 per well, then C w per perforated cell
// by the thread at the start of the cell's run, subtracted in place (no
// atomics). It runs as its own
// launch right after K4/K4-faces: fusing it into their epilogue needs a
// grid-wide barrier between the cell operator and the well sums. The
// right-hand side must also copy r_cell, so it runs one block per 2048
// cells: each block forms D^-1 r_well itself (nw x 16 products), copies
// its cells and then rewrites the perforated ones among them.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerBlock = 2048;

struct Wells {
    int nw, mp;
    const long long* perf_cell;   // (npf)
    const double* wc;             // (npf, 3, 3)
    const double* cw;             // (npf, 3, 4)
    const double* dinv;           // (nw, 4, 4)
    const long long* order;       // (npf) perforations stably sorted by cell
};

// perf_cell into shared memory (sc), the caller synchronises
__device__ __forceinline__ void stage_cells(const Wells& W, long long* sc) {
    for (int p = threadIdx.x; p < W.nw * W.mp; p += blockDim.x)
        sc[p] = W.perf_cell[p];
}

// wf[p] = wc[p] v[:, sc[p]] for every perforation (shared memory)
__device__ void apply_B_perfs(const Wells& W, const long long* sc,
                              long long nc, const double* __restrict__ v,
                              double* wf) {
    const int npf = W.nw * W.mp;
    for (int p = threadIdx.x; p < npf; p += blockDim.x) {
        const long long c = sc[p];
        const double v0 = v[c], v1 = v[nc + c], v2 = v[2 * nc + c];
        for (int i = 0; i < 3; ++i) {
            const double* a = W.wc + (p * 3 + i) * 3;
            wf[3 * p + i] = (a[0] * v0 + a[1] * v1) + a[2] * v2;
        }
    }
}

// y = dinv[w] b (4-vectors)
__device__ __forceinline__ void dinv_apply(const Wells& W, int w,
                                           const double b[4], double* y) {
    const double* D = W.dinv + w * 16;
    for (int i = 0; i < 4; ++i) {
        double acc = D[4 * i] * b[0];
        for (int k = 1; k < 4; ++k) acc = acc + D[4 * i + k] * b[k];
        y[i] = acc;
    }
}

// the run of ``order`` that starts at position i (-1 if i does not start
// one): its cell, and the sum over its perforations q, in ascending
// order, of cw[q] w[well(q)]
__device__ __forceinline__ long long apply_C_run(const Wells& W,
                                                 const long long* sc, int i,
                                                 const double* w,
                                                 double s[3]) {
    const int npf = W.nw * W.mp;
    const long long c = sc[W.order[i]];
    if (i > 0 && sc[W.order[i - 1]] == c) return -1;
    for (int k = 0; k < 3; ++k) s[k] = 0.0;
    for (int j = i; j < npf; ++j) {
        const long long q = W.order[j];
        if (sc[q] != c) break;
        const double* wv = w + 4 * (q / W.mp);
        for (int k = 0; k < 3; ++k) {
            const double* a = W.cw + (q * 3 + k) * 4;
            double acc = a[0] * wv[0];
            for (int m = 1; m < 4; ++m) acc = acc + a[m] * wv[m];
            s[k] = s[k] + acc;
        }
    }
    return c;
}

// the per-well sums of B v (control row 0), shared wf -> b (nw, 4)
__device__ __forceinline__ void well_sums(const Wells& W, int w,
                                          const double* wf, double b[4]) {
    for (int i = 0; i < 3; ++i) {
        double acc = 0.0;
        for (int m = 0; m < W.mp; ++m) acc = acc + wf[3 * (w * W.mp + m) + i];
        b[i] = acc;
    }
    b[3] = 0.0;
}

// shared memory of the single-block entries: wf (npf x 3), w4 (nw x 4),
// the staged perf_cell (npf)
__device__ __forceinline__ void carve(const Wells& W, double* sm, double** wf,
                                      double** w4, long long** sc) {
    *wf = sm;
    *w4 = sm + 3 * W.nw * W.mp;
    *sc = reinterpret_cast<long long*>(*w4 + 4 * W.nw);
}

// out (3, nc) -= C D^-1 B v; one block
__global__ void schur_matvec_kernel(Wells W, long long nc,
                                    const double* __restrict__ v,
                                    double* __restrict__ out) {
    extern __shared__ double sm[];
    double *wf, *w4;
    long long* sc;
    carve(W, sm, &wf, &w4, &sc);
    stage_cells(W, sc);
    __syncthreads();
    apply_B_perfs(W, sc, nc, v, wf);
    __syncthreads();
    for (int w = threadIdx.x; w < W.nw; w += blockDim.x) {
        double b[4];
        well_sums(W, w, wf, b);
        dinv_apply(W, w, b, w4 + 4 * w);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < W.nw * W.mp; i += blockDim.x) {
        double s[3];
        const long long c = apply_C_run(W, sc, i, w4, s);
        if (c < 0) continue;
        for (int k = 0; k < 3; ++k) out[k * nc + c] = out[k * nc + c] - s[k];
    }
}

// xw (nw, 4) = D^-1 (r_well - B x); one block
__global__ void schur_recover_kernel(Wells W, long long nc,
                                     const double* __restrict__ x,
                                     const double* __restrict__ r_well,
                                     double* __restrict__ xw) {
    extern __shared__ double sm[];
    double *wf, *w4;
    long long* sc;
    carve(W, sm, &wf, &w4, &sc);
    stage_cells(W, sc);
    __syncthreads();
    apply_B_perfs(W, sc, nc, x, wf);
    __syncthreads();
    for (int w = threadIdx.x; w < W.nw; w += blockDim.x) {
        double b[4];
        well_sums(W, w, wf, b);
        for (int i = 0; i < 4; ++i) b[i] = r_well[4 * w + i] - b[i];
        dinv_apply(W, w, b, xw + 4 * w);
    }
}

// out (3, nc) = r_cell - C D^-1 r_well; block b owns cells
// [b * kCellsPerBlock, (b + 1) * kCellsPerBlock)
__global__ void schur_rhs_kernel(Wells W, long long nc,
                                 const double* __restrict__ r_cell,
                                 const double* __restrict__ r_well,
                                 double* __restrict__ out) {
    extern __shared__ double sm[];
    double* w4 = sm;                                        // nw * 4
    long long* sc = reinterpret_cast<long long*>(sm + 4 * W.nw);
    const long long lo = (long long)blockIdx.x * kCellsPerBlock;
    const long long hi = lo + kCellsPerBlock < nc ? lo + kCellsPerBlock : nc;
    stage_cells(W, sc);
    for (int w = threadIdx.x; w < W.nw; w += blockDim.x)
        dinv_apply(W, w, r_well + 4 * w, w4 + 4 * w);
    for (long long c = lo + threadIdx.x; c < hi; c += blockDim.x)
        for (int i = 0; i < 3; ++i) out[i * nc + c] = r_cell[i * nc + c];
    __syncthreads();
    for (int i = threadIdx.x; i < W.nw * W.mp; i += blockDim.x) {
        const long long c0 = sc[W.order[i]];
        if (c0 < lo || c0 >= hi) continue;
        double s[3];
        const long long c = apply_C_run(W, sc, i, w4, s);
        if (c < 0) continue;
        for (int k = 0; k < 3; ++k) out[k * nc + c] = r_cell[k * nc + c] - s[k];
    }
}

}  // namespace

extern "C" {

#define OPM_WELLS_ARGS                                              \
    int nw, int mp, const long long *perf_cell, const double *wc,   \
        const double *cw, const double *dinv, const long long *order
#define OPM_WELLS {nw, mp, perf_cell, wc, cw, dinv, order}

int opm_schur_matvec(OPM_WELLS_ARGS, long long nc, const double* v,
                     double* out, cudaStream_t stream) {
    if (nw == 0) return 0;
    Wells W OPM_WELLS;
    size_t smem = sizeof(double) * (4 * (size_t)nw * mp + 4 * (size_t)nw);
    schur_matvec_kernel<<<1, kThreads, smem, stream>>>(W, nc, v, out);
    return (int)cudaGetLastError();
}

int opm_schur_recover(OPM_WELLS_ARGS, long long nc, const double* x,
                      const double* r_well, double* xw,
                      cudaStream_t stream) {
    if (nw == 0) return 0;
    Wells W OPM_WELLS;
    size_t smem = sizeof(double) * (4 * (size_t)nw * mp + 4 * (size_t)nw);
    schur_recover_kernel<<<1, kThreads, smem, stream>>>(W, nc, x, r_well,
                                                         xw);
    return (int)cudaGetLastError();
}

int opm_schur_rhs(OPM_WELLS_ARGS, long long nc, const double* r_cell,
                  const double* r_well, double* out, cudaStream_t stream) {
    if (nc == 0) return 0;
    Wells W OPM_WELLS;
    size_t smem = sizeof(double) * (4 * (size_t)nw + (size_t)nw * mp + 1);
    int blocks = (int)((nc + kCellsPerBlock - 1) / kCellsPerBlock);
    schur_rhs_kernel<<<blocks, kThreads, smem, stream>>>(W, nc, r_cell,
                                                         r_well, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
