// K5's device code: the Schur complement of the well unknowns. Shared by
// wells.cu (the right-hand side, the recovery and the stand-alone
// reduced-operator entry) and by the cell operators' launches (block7.cu's
// K4 matvec, faces.cu's K4-faces apply), which carry the reduced
// operator's well term out -= C D^-1 (B v): a prologue in block 0 and an
// epilogue in the block that finishes last.
//
// Layout: perforation p = w * mp + m of well w; wc (npf, 3, 3) the well
// flux rows x cell variables, cw (npf, 3, 4) the cell rows x well
// variables, perf_cell (npf) int64, dinv (nw, 4, 4), and order (npf)
// int64, the perforations stably sorted by cell (one argsort per
// assembly). A cell's C w is the sum over its perforations in ascending
// order (the plain version's scatter order): the run of ``order`` that
// holds the cell (run_len at its first position: padded perforations all
// share cell 0, so a run can hold most of them), each position's term
// formed by a thread of its own and the run summed in order by the thread
// at its first position, into ct at that position.
//
// The well term needs no grid barrier: B v reads the operator's input v,
// not A v, so only the final subtraction at the perforated cells must come
// after the cell operator. An extra block 0, which has no rows, forms the
// well vector w = D^-1 (B v) (B v per perforation, the per-well sums in
// perforation order, D^-1) and C w per perforated cell while the other
// blocks compute their rows; each block, after its writes, takes a ticket
// (one thread, after a barrier, with an acquire-release atomic: the
// block's writes are released, the others' acquired), so C w is in place
// before any block can take the last one. The block that takes the last
// ticket sees every other block's rows, subtracts C w at the perforated
// cells and resets the ticket for the next launch: the only work left
// after the cell operator is that subtraction.
// The scratch (wf, w4, ct), the perforated cells in the order of
// ``order``, the runs' lengths and the ticket live in a workspace made
// once per Newton system
// (models/linearize.py WellTerm), not in shared memory, which every block
// of the cell operator would otherwise reserve.
// Build with --fmad=false (products and sums round as the plain version's).

#pragma once

#include <cuda_runtime.h>

namespace opm_wells {

// The well arrays of one Newton system and the well term's workspace,
// field for field the ctypes structure of models/linearize.py; nw == 0: no
// well term (a launch without one passes a zeroed struct). phases: which
// parts of the well term a cell operator's launch runs (kPrologue,
// kEpilogue; set per launch).
constexpr int kPrologue = 1, kEpilogue = 2;
struct Wells {
    int nw, mp, phases;
    const long long* perf_cell;   // (npf)
    const double* wc;             // (npf, 3, 3)
    const double* cw;             // (npf, 3, 4)
    const double* dinv;           // (nw, 4, 4)
    const long long* order;       // (npf) perforations stably sorted by cell
    const long long* sorted_cell; // (npf) perf_cell[order]
    const int* run_len;           // (npf) a run's length at its start, else 0
    double* wf;                   // (npf, 3) scratch: B v per perforation
    double* ct;                   // (npf, 3) scratch: C w per position
    double* w4;                   // (nw, 4) scratch: the well vector
    unsigned int* ticket;         // blocks of the launch done; 0 between
};

// A host pointer to a Wells (or null) as the kernels take it, running the
// given phases.
inline Wells from_host(const void* p, int phases = 0) {
    Wells W{};
    if (p) W = *static_cast<const Wells*>(p);
    W.phases = phases;
    return W;
}

// ticket + 1 at device scope with acquire-release order; the old value
__device__ __forceinline__ unsigned int take_ticket(unsigned int* ticket) {
#if defined(__CUDA_ARCH__)
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(ticket) : "memory");
    return old;
#else
    return atomicAdd(ticket, 1u);
#endif
}

// Called by every thread of every block after its writes: true in the
// block that finishes last, which then sees every other block's writes
// (the barrier orders the block's writes before its thread 0's release;
// read other blocks' data through L2: __ldcg). That block resets the
// ticket.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x == 0) {
        last = take_ticket(ticket) == gridDim.x - 1;
        if (last) *ticket = 0u;
    }
    __syncthreads();
    return last;
}

// wf[p] = wc[p] v[:, perf_cell[p]] for every perforation (the block's
// threads; the caller synchronises)
__device__ __forceinline__ void apply_B(const Wells& W, long long nc,
                                        const double* v, double* wf) {
    const int npf = W.nw * W.mp;
    for (int p = threadIdx.x; p < npf; p += blockDim.x) {
        const long long c = W.perf_cell[p];
        const double v0 = v[c], v1 = v[nc + c], v2 = v[2 * nc + c];
        for (int i = 0; i < 3; ++i) {
            const double* a = W.wc + (p * 3 + i) * 3;
            wf[3 * p + i] = (a[0] * v0 + a[1] * v1) + a[2] * v2;
        }
    }
}

// the per-well sums of B v (control row 0) in perforation order, wf -> b
// (4); the three rows in one pass, so that more loads are in flight
__device__ __forceinline__ void well_sums(const Wells& W, int w,
                                          const double* wf, double b[4]) {
    const double* f = wf + 3 * w * W.mp;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0;
#pragma unroll 4
    for (int m = 0; m < W.mp; ++m) {
        a0 = a0 + f[3 * m];
        a1 = a1 + f[3 * m + 1];
        a2 = a2 + f[3 * m + 2];
    }
    b[0] = a0;
    b[1] = a1;
    b[2] = a2;
    b[3] = 0.0;
}

// ---------------------------------------------------------------------------
// D^-1 of one well's 4x4 block: linalg/precond.py inv4x4's operations in
// their order (the reference's linalg/precond.py:42-110): max-abs row then
// column equilibration, the 1e-10 shift in the equilibrated metric, 2x2
// block elimination with relative determinant floors, the unscaling.

constexpr double kTiny = 1e-300;

// torch.maximum and torch.amax: NaN wins
__device__ __forceinline__ double max_nan(double a, double b) {
    return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// torch.clamp(x, min=kTiny): NaN stays
__device__ __forceinline__ double clamp_tiny(double x) {
    return x < kTiny ? kTiny : x;
}

// x0 y0 + x1 y1 as the card's batched 2x2 product (torch.matmul, a
// cuBLAS GEMM) rounds it: each product fused onto a sum that starts from
// +0.0
__device__ __forceinline__ double dot2(double x0, double y0, double x1,
                                       double y1) {
    return __fma_rn(x1, y1, __fma_rn(x0, y0, 0.0));
}

struct M2 {
    double a, b, c, d;     // [[a, b], [c, d]]
};

__device__ __forceinline__ M2 mul2(const M2& x, const M2& y) {
    return M2{dot2(x.a, y.a, x.b, y.c), dot2(x.a, y.b, x.b, y.d),
              dot2(x.c, y.a, x.d, y.c), dot2(x.c, y.b, x.d, y.d)};
}

__device__ __forceinline__ M2 neg2(const M2& x) {
    return M2{-x.a, -x.b, -x.c, -x.d};
}

// the 2x2 inverse with its determinant floored at 1e-10 of the larger
// product (at least kTiny), keeping its sign
__device__ __forceinline__ M2 inv2(const M2& x) {
    const double ad = x.a * x.d, bc = x.b * x.c;
    double det = ad - bc;
    const double floor = clamp_tiny(1e-10 * max_nan(fabs(ad), fabs(bc)));
    if (!(fabs(det) >= floor)) det = det < 0 ? -floor : floor;
    return M2{x.d / det, -x.b / det, -x.c / det, x.a / det};
}

// out (4x4, row-major) = D^-1 of m (4x4, row-major)
__device__ __forceinline__ void inv4x4(const double* m, double* out) {
    double e[4][4], r[4], c[4];
    for (int i = 0; i < 4; ++i) {
        double mx = fabs(m[4 * i]);
        for (int j = 1; j < 4; ++j) mx = max_nan(mx, fabs(m[4 * i + j]));
        r[i] = clamp_tiny(mx);
        for (int j = 0; j < 4; ++j) e[i][j] = m[4 * i + j] / r[i];
    }
    for (int j = 0; j < 4; ++j) {
        double mx = fabs(e[0][j]);
        for (int i = 1; i < 4; ++i) mx = max_nan(mx, fabs(e[i][j]));
        c[j] = clamp_tiny(mx);
    }
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
            e[i][j] = e[i][j] / c[j] + (i == j ? 1e-10 : 0.0);
    const M2 A{e[0][0], e[0][1], e[1][0], e[1][1]};
    const M2 B{e[0][2], e[0][3], e[1][2], e[1][3]};
    const M2 C{e[2][0], e[2][1], e[3][0], e[3][1]};
    const M2 D{e[2][2], e[2][3], e[3][2], e[3][3]};
    const M2 Ai = inv2(A);
    const M2 CAB = mul2(mul2(C, Ai), B);
    const M2 Si = inv2(M2{D.a - CAB.a, D.b - CAB.b, D.c - CAB.c, D.d - CAB.d});
    const M2 T = mul2(mul2(mul2(mul2(Ai, B), Si), C), Ai);
    const M2 TL{Ai.a + T.a, Ai.b + T.b, Ai.c + T.c, Ai.d + T.d};
    const M2 TR = mul2(mul2(neg2(Ai), B), Si);
    const M2 BL = mul2(mul2(neg2(Si), C), Ai);
    const M2 blk[2][2] = {{TL, TR}, {BL, Si}};
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
            const M2& q = blk[i / 2][j / 2];
            const double v = (i & 1) ? ((j & 1) ? q.d : q.c)
                                     : ((j & 1) ? q.b : q.a);
            out[4 * i + j] = v / c[i] / r[j];
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

// C w per perforated cell by the block (all its threads; w4 in place,
// ends synchronised): position j of ``order`` (perforation q) gets its
// term cw[q] w[well(q)] from a thread of its own, then the thread at the
// start of a cell's run sums the run's terms in ascending order into ct at
// that position.
__device__ __forceinline__ void cell_terms(const Wells& W) {
    const int npf = W.nw * W.mp;
    for (int j = threadIdx.x; j < npf; j += blockDim.x) {
        const int q = (int)W.order[j];
        const double* wv = W.w4 + 4 * (q / W.mp);
        for (int k = 0; k < 3; ++k) {
            const double* a = W.cw + (q * 3 + k) * 4;
            double acc = a[0] * wv[0];
            for (int m = 1; m < 4; ++m) acc = acc + a[m] * wv[m];
            W.ct[3 * j + k] = acc;
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < npf; i += blockDim.x) {
        const int len = W.run_len[i];
        if (len == 0) continue;
        double* t = W.ct + 3 * i;
        double s0 = 0.0, s1 = 0.0, s2 = 0.0;
#pragma unroll 4
        for (int j = 0; j < len; ++j) {
            s0 = s0 + t[3 * j];
            s1 = s1 + t[3 * j + 1];
            s2 = s2 + t[3 * j + 2];
        }
        t[0] = s0;
        t[1] = s1;
        t[2] = s2;
    }
    __syncthreads();
}

// out (3, nc) = base - C w at the perforated cells (the block's threads,
// one run each), from cell_terms' sums. base and the sums may have been
// written by other blocks (read through L2).
__device__ __forceinline__ void subtract_C(const Wells& W, long long nc,
                                           const double* base, double* out) {
    const int npf = W.nw * W.mp;
    for (int i = threadIdx.x; i < npf; i += blockDim.x) {
        if (W.run_len[i] == 0) continue;
        const long long c = W.sorted_cell[i];
        for (int k = 0; k < 3; ++k)
            out[k * nc + c] = __ldcg(base + k * nc + c)
                - __ldcg(W.ct + 3 * i + k);
    }
}

// the well vector w4 = D^-1 (B v) and C w per perforated cell by one block
// (all its threads; ends synchronised)
__device__ __forceinline__ void well_vector(const Wells& W, long long nc,
                                            const double* v) {
    apply_B(W, nc, v, W.wf);
    __syncthreads();
    for (int w = threadIdx.x; w < W.nw; w += blockDim.x) {
        double b[4];
        well_sums(W, w, W.wf, b);
        dinv_apply(W, w, b, W.w4 + 4 * w);
    }
    __syncthreads();
    cell_terms(W);
}

// the reduced operator's well term by one block: out -= C D^-1 (B v)
__device__ __forceinline__ void matvec_term(const Wells& W, long long nc,
                                            const double* v, double* out) {
    well_vector(W, nc, v);
    subtract_C(W, nc, out, out);
}

// The extra leading block of a launch that forms the well vector (1 or 0):
// block b >= shift computes the rows of block b - shift.
__device__ __host__ __forceinline__ int prologue_blocks(const Wells& W) {
    return (W.nw != 0 && (W.phases & kPrologue)) ? 1 : 0;
}

// The prologue of a cell operator's launch (every thread of every block,
// before its rows): the extra block 0 forms the well vector and C w.
__device__ __forceinline__ void matvec_prologue(const Wells& W, long long nc,
                                                const double* v) {
    if (prologue_blocks(W) && blockIdx.x == 0) well_vector(W, nc, v);
}

// The epilogue (every thread of every block, after its rows of out are
// written): the last block subtracts C w at the perforated cells. A launch
// may run it without the prologue when an earlier launch on the stream
// formed the well vector (an embedded grid: K4, then K4-faces).
__device__ __forceinline__ void matvec_epilogue(const Wells& W, long long nc,
                                                double* out) {
    if (W.nw == 0 || !(W.phases & kEpilogue) || !last_block(W.ticket))
        return;
    subtract_C(W, nc, out, out);
}

}  // namespace opm_wells
