// K10: the aggregation-AMG level work of the CPR pressure stage on grids
// with a face list, for Hopper: the damped-Jacobi sweep over an ELL matrix,
// the residual fused with the restriction by aggregate, the prolongation by
// gather fused with the post-smoothing sweep, and the per-Newton Galerkin
// value coarsening and ELL packing.
//
// Replaces the JAX package's linalg/amg.py ell_spmv (:27) and jacobi_sweep
// (:37) (the repository's only Pallas kernels ever written, deleted after
// they measured within noise of XLA's fusion of the same jnp forms), the
// V-cycle's transfers segment_sum(r, agg) (:278) and e_c[agg] (:280), and
// DeviceAmg.coarsen_values (:206-230).
//
// Layout: a level of n cells has diag (n,) and ELL values (K, n) with
// column ids cols (K, n) int32; K is the level's widest row (9 to 26 on the
// Norne-class gather grid), padding slots are self-loops whose values are 0
// and are multiplied like any other (so the sum equals the plain
// version's). A kernel reads the neighbour values x[cols] itself.
//
// What bounds it on the card: memory traffic. A sweep reads per cell its
// diagonal, K values, K column ids, K neighbour values (mostly from L2) and
// b, and writes one value: about (3 + 2.5 K) * 8 bytes per cell. Design:
// gather form, one thread per output (fine cell for the sweeps, aggregate
// for the restriction, coarse entry for the coarsening), each sum taken
// over a CSR built once on the host in the order of the plain version's
// sequential segment sum, so results are those of the plain version on the
// CPU bit for bit; no atomics.
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// value of the iterate at cell j: 0 for the zero iterate, x[j], or the
// prolonged x[j] + e_c[agg[j]]
__device__ __forceinline__ double xval(const double* __restrict__ x,
                                       const double* __restrict__ ec,
                                       const int* __restrict__ agg, int j) {
    double v = x ? x[j] : 0.0;
    if (ec) v = v + ec[agg[j]];
    return v;
}

// (A x)_i = diag_i x_i + sum_k vals[k][i] x[cols[k][i]], k ascending
__device__ __forceinline__ double spmv_row(
    int n, int K, int i, const double* __restrict__ diag,
    const double* __restrict__ vals, const int* __restrict__ cols,
    const double* __restrict__ x, const double* __restrict__ ec,
    const int* __restrict__ agg) {
    double acc = vals[i] * xval(x, ec, agg, cols[i]);
    for (int k = 1; k < K; ++k) {
        long long s = (long long)k * n + i;
        acc = acc + vals[s] * xval(x, ec, agg, cols[s]);
    }
    return diag[i] * xval(x, ec, agg, i) + acc;
}

__global__ void sweep_kernel(int n, int K, const double* __restrict__ diag,
                             const double* __restrict__ vals,
                             const int* __restrict__ cols,
                             const double* __restrict__ x,
                             const double* __restrict__ ec,
                             const int* __restrict__ agg,
                             const double* __restrict__ b, double omega,
                             double* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    double y = spmv_row(n, K, i, diag, vals, cols, x, ec, agg);
    double d = diag[i];
    double safe = fabs(d) > 1e-300 ? d : 1.0;
    double t = omega * (b[i] - y);
    out[i] = xval(x, ec, agg, i) + t / safe;
}

__global__ void restrict_kernel(int n_c, const int* __restrict__ cptr,
                                const int* __restrict__ cidx, int n, int K,
                                const double* __restrict__ diag,
                                const double* __restrict__ vals,
                                const int* __restrict__ cols,
                                const double* __restrict__ x,
                                const double* __restrict__ b,
                                double* __restrict__ rc) {
    int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n_c) return;
    double acc = 0.0;
    for (int e = cptr[c]; e < cptr[c + 1]; ++e) {
        int i = cidx[e];
        double y = spmv_row(n, K, i, diag, vals, cols, x, nullptr, nullptr);
        acc = acc + (b[i] - y);
    }
    rc[c] = acc;
}

__global__ void coarsen_kernel(int n_c, const int* __restrict__ cptr,
                               const int* __restrict__ cidx,
                               const double* __restrict__ diag,
                               const int* __restrict__ fptr,
                               const int* __restrict__ fidx,
                               const double* __restrict__ off,
                               double* __restrict__ diag_c, int nnz_c,
                               const int* __restrict__ eptr,
                               const int* __restrict__ eidx,
                               double* __restrict__ off_c) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n_c) {
        // segment_sum(diag, agg) + segment_sum(folded entries, row)
        double s1 = 0.0, s2 = 0.0;
        for (int e = cptr[t]; e < cptr[t + 1]; ++e) s1 = s1 + diag[cidx[e]];
        for (int e = fptr[t]; e < fptr[t + 1]; ++e) s2 = s2 + off[fidx[e]];
        diag_c[t] = s1 + s2;
    }
    if (t < nnz_c) {
        double s = 0.0;
        for (int e = eptr[t]; e < eptr[t + 1]; ++e) s = s + off[eidx[e]];
        off_c[t] = s;
    }
}

__global__ void ell_pack_kernel(long long m, const long long* __restrict__ src,
                                const double* __restrict__ off,
                                double* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= m) return;
    long long s = src[t];
    out[t] = s >= 0 ? off[s] : 0.0;
}

inline int blocks_for(long long n) {
    return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// out = xv + omega (b - A xv) / diag, xv = x (or 0 when x is null) plus
// e_c[agg] when e_c is not null
int opm_amg_sweep(int n, int K, const double* diag, const double* vals,
                  const int* cols, const double* x, const double* ec,
                  const int* agg, const double* b, double omega, double* out,
                  cudaStream_t stream) {
    if (n == 0) return 0;
    sweep_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        n, K, diag, vals, cols, x, ec, agg, b, omega, out);
    return (int)cudaGetLastError();
}

// rc[c] = sum over the children i of aggregate c of (b - A x)_i
int opm_amg_restrict(int n_c, const int* cptr, const int* cidx, int n,
                     int K, const double* diag, const double* vals,
                     const int* cols, const double* x, const double* b,
                     double* rc, cudaStream_t stream) {
    if (n_c == 0) return 0;
    restrict_kernel<<<blocks_for(n_c), kThreads, 0, stream>>>(
        n_c, cptr, cidx, n, K, diag, vals, cols, x, b, rc);
    return (int)cudaGetLastError();
}

int opm_amg_coarsen(int n_c, const int* cptr, const int* cidx,
                    const double* diag, const int* fptr, const int* fidx,
                    const double* off, double* diag_c, int nnz_c,
                    const int* eptr, const int* eidx, double* off_c,
                    cudaStream_t stream) {
    int m = n_c > nnz_c ? n_c : nnz_c;
    if (m == 0) return 0;
    coarsen_kernel<<<blocks_for(m), kThreads, 0, stream>>>(
        n_c, cptr, cidx, diag, fptr, fidx, off, diag_c, nnz_c, eptr, eidx,
        off_c);
    return (int)cudaGetLastError();
}

int opm_amg_ell_pack(long long m, const long long* src, const double* off,
                     double* out, cudaStream_t stream) {
    if (m == 0) return 0;
    ell_pack_kernel<<<blocks_for(m), kThreads, 0, stream>>>(m, src, off,
                                                            out);
    return (int)cudaGetLastError();
}

}  // extern "C"
