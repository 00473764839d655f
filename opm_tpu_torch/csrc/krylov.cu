// K8: the BiCGStab vector steps for Hopper, one launch per step and two
// steps per iteration, with deterministic one-pass reductions.
//
// Replaces the vector work of the JAX package's linalg/krylov.py bicgstab
// (:59-93): the axpys and the jnp.vdot reductions that XLA fused around the
// matvec and the preconditioner on the TPU. The iteration is regrouped into
// steps that each end where the next needs a matvec or a preconditioner
// apply:
//
//   init        <b, b> and the initial scalars (rho1 = rr = bb, rho = alpha
//               = omega = 1, beta = rho1);
//   p_update    p = r + beta (p - omega v) (the first iteration's);
//   alpha_s     <rhat, v> -> alpha with its breakdown guard, then
//               s = r - alpha v;
//   omega_xr_p  <t, t> and <t, s> -> omega; x += alpha phat + omega shat;
//               r = s - omega t; <r, r> and <rhat, r> -> rr, rho1 and beta;
//               then the next iteration's p = r + beta (p - omega v).
//
// The scalars stay on the device in sc (float64 slots RHO1 .. EPS, the
// same as linalg/kernels_k8.py), with the breakdown guards (1e-300, in
// sc[EPS]) and the order of every product and sum of the plain twins.
//
// What bounds it on the card: memory traffic (8 bytes per unknown per
// vector read or written; at SPE10-2 a vector is 26.9 MB): alpha_s moves 4
// vectors, omega_xr_p 11. Design: a fixed grid of G blocks of 256 threads,
// G = min(co-resident blocks of the cooperative kernels, what n needs),
// sized once per device and length (opm_k8_grid). Each thread walks a
// fixed grid-stride share of 16-byte double2 pairs (the odd tail element,
// if any, last, by thread 0), sums in a fixed order, and each block sums
// its threads with a warp-shuffle and shared-memory tree into one partial.
// Where only scalar algebra follows (init) the last block to arrive (a
// ticket counter it resets itself) sums the partials in block order. Where
// an elementwise phase needs the sum (alpha_s, both barriers of
// omega_xr_p) the kernel is launched cooperatively and, after
// cooperative_groups' grid barrier, every block sums all partials in the
// same fixed order, so every block holds the same scalar; block 0 writes
// it to sc. No float atomics: a fixed grid and order give the same result
// run after run. A refused cooperative launch returns its cudaError_t.
// Build with --fmad=false (products and sums round as the twins' separate
// operations).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

enum Slot { RHO1 = 0, RHO, ALPHA, OMEGA, BETA, RR, BB, EPS };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kShared = 2 * kWarps + 2;

__device__ __forceinline__ long long gtid() {
    return (long long)blockIdx.x * kThreads + threadIdx.x;
}

// the block's sums of a and b over its threads, in a fixed order (a
// shuffle tree in each warp, then over the warps' sums); valid in thread 0
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           double* sh) {
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, o);
        b += __shfl_down_sync(0xffffffffu, b, o);
    }
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (lane == 0) {
        sh[w] = a;
        sh[kWarps + w] = b;
    }
    __syncthreads();
    if (w == 0) {
        a = lane < kWarps ? sh[lane] : 0.0;
        b = lane < kWarps ? sh[kWarps + lane] : 0.0;
        for (int o = kWarps / 2; o > 0; o >>= 1) {
            a += __shfl_down_sync(0xffffffffu, a, o);
            b += __shfl_down_sync(0xffffffffu, b, o);
        }
    }
    __syncthreads();
}

// the sums of the G partial pairs part[2 i], part[2 i + 1] in a fixed
// order, the same in every block; every thread gets them
__device__ __forceinline__ void grid_sum2(const double* part, int G,
                                          double* sh, double& a,
                                          double& b) {
    a = 0.0;
    b = 0.0;
    for (int i = threadIdx.x; i < G; i += kThreads) {
        a += __ldcg(part + 2 * i);
        b += __ldcg(part + 2 * i + 1);
    }
    block_sum2(a, b, sh);
    if (threadIdx.x == 0) {
        sh[2 * kWarps] = a;
        sh[2 * kWarps + 1] = b;
    }
    __syncthreads();
    a = sh[2 * kWarps];
    b = sh[2 * kWarps + 1];
    __syncthreads();
}

__device__ __forceinline__ void put_partial(double* part, double a,
                                            double b) {
    if (threadIdx.x == 0) {
        part[2 * blockIdx.x] = a;
        part[2 * blockIdx.x + 1] = b;
    }
}

__device__ __forceinline__ double2 ld2(const double* p, long long k) {
    return reinterpret_cast<const double2*>(p)[k];
}

__device__ __forceinline__ void st2(double* p, long long k, double2 v) {
    reinterpret_cast<double2*>(p)[k] = v;
}

// p = r + beta (p + (-omega) v), the twin's order
__device__ __forceinline__ double pnext(double r, double p, double v,
                                        double beta, double omega) {
    return r + beta * (p + (-omega) * v);
}

__device__ __forceinline__ void p_phase(double* p, const double* r,
                                        const double* v, double beta,
                                        double omega, long long n) {
    const long long n2 = n >> 1, T = (long long)gridDim.x * kThreads;
    for (long long k = gtid(); k < n2; k += T) {
        double2 rk = ld2(r, k), pk = ld2(p, k), vk = ld2(v, k);
        pk.x = pnext(rk.x, pk.x, vk.x, beta, omega);
        pk.y = pnext(rk.y, pk.y, vk.y, beta, omega);
        st2(p, k, pk);
    }
    if ((n & 1) && gtid() == 0)
        p[n - 1] = pnext(r[n - 1], p[n - 1], v[n - 1], beta, omega);
}

// <b, b> and the initial scalars; the last block to arrive finishes
__global__ void __launch_bounds__(kThreads)
    k8_init(const double* __restrict__ b, long long n, double* sc,
            double* part, unsigned int* ticket) {
    __shared__ double sh[kShared];
    __shared__ bool last;
    const long long n2 = n >> 1, T = (long long)gridDim.x * kThreads;
    double a = 0.0, z = 0.0;
    for (long long k = gtid(); k < n2; k += T) {
        double2 u = ld2(b, k);
        a += u.x * u.x;
        a += u.y * u.y;
    }
    if ((n & 1) && gtid() == 0) a += b[n - 1] * b[n - 1];
    block_sum2(a, z, sh);
    if (threadIdx.x == 0) {
        put_partial(part, a, 0.0);
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    double bb;
    grid_sum2(part, gridDim.x, sh, bb, z);
    if (threadIdx.x == 0) {
        // rho = alpha = omega = 1 pass the breakdown guard: beta is the
        // twin's (rho1 / rho) * (alpha / omega)
        const double one = 1.0;
        sc[RHO1] = bb;
        sc[RHO] = one;
        sc[ALPHA] = one;
        sc[OMEGA] = one;
        sc[BETA] = (bb / one) * (one / one);
        sc[RR] = bb;
        sc[BB] = bb;
        *ticket = 0u;
    }
}

__global__ void __launch_bounds__(kThreads)
    k8_p_update(double* __restrict__ p, const double* __restrict__ r,
                const double* __restrict__ v, const double* sc,
                long long n) {
    p_phase(p, r, v, sc[BETA], sc[OMEGA], n);
}

// alpha = rho1 / <rhat, v> (0 where |<rhat, v>| <= eps); s = (-alpha) v + r
__global__ void __launch_bounds__(kThreads)
    k8_alpha_s(const double* __restrict__ rhat,
               const double* __restrict__ v, const double* __restrict__ r,
               double* __restrict__ s, double* sc, double* part,
               long long n) {
    __shared__ double sh[kShared];
    const double rho1 = sc[RHO1], eps = sc[EPS];
    const long long n2 = n >> 1, T = (long long)gridDim.x * kThreads;
    double a = 0.0, z = 0.0;
    for (long long k = gtid(); k < n2; k += T) {
        double2 h = ld2(rhat, k), w = ld2(v, k);
        a += h.x * w.x;
        a += h.y * w.y;
    }
    if ((n & 1) && gtid() == 0) a += rhat[n - 1] * v[n - 1];
    block_sum2(a, z, sh);
    put_partial(part, a, 0.0);
    cg::this_grid().sync();
    double denom;
    grid_sum2(part, gridDim.x, sh, denom, z);
    const double alpha = fabs(denom) > eps ? rho1 / denom : 0.0;
    if (blockIdx.x == 0 && threadIdx.x == 0) sc[ALPHA] = alpha;
    for (long long k = gtid(); k < n2; k += T) {
        double2 w = ld2(v, k), rk = ld2(r, k);
        st2(s, k, make_double2((-alpha) * w.x + rk.x,
                               (-alpha) * w.y + rk.y));
    }
    if ((n & 1) && gtid() == 0) s[n - 1] = (-alpha) * v[n - 1] + r[n - 1];
}

// omega = <t, s> / <t, t> (0 where <t, t> <= eps); x = (x + alpha phat) +
// omega shat; r = (-omega) t + s; rr = <r, r>, rho1' = <rhat, r>, beta =
// (rho1' / rho1) (alpha / omega) (0 where |rho1| or |omega| <= eps); then
// p = r + beta (p + (-omega) v). part holds 2 G pairs: one per barrier.
// phat and shat may alias p and s (an identity preconditioner), so none
// of the four is declared __restrict__.
__global__ void __launch_bounds__(kThreads)
    k8_omega_xr_p(const double* __restrict__ t, const double* s,
                  double* __restrict__ x, double* __restrict__ r,
                  const double* phat, const double* shat,
                  const double* __restrict__ rhat, double* p,
                  const double* __restrict__ v, double* sc, double* part,
                  long long n) {
    __shared__ double sh[kShared];
    const double alpha = sc[ALPHA], rho = sc[RHO1], eps = sc[EPS];
    const long long n2 = n >> 1, T = (long long)gridDim.x * kThreads;
    const int G = gridDim.x;
    cg::grid_group grid = cg::this_grid();

    double tt = 0.0, ts = 0.0;
    for (long long k = gtid(); k < n2; k += T) {
        double2 a = ld2(t, k), b = ld2(s, k);
        tt += a.x * a.x;
        tt += a.y * a.y;
        ts += a.x * b.x;
        ts += a.y * b.y;
    }
    if ((n & 1) && gtid() == 0) {
        tt += t[n - 1] * t[n - 1];
        ts += t[n - 1] * s[n - 1];
    }
    block_sum2(tt, ts, sh);
    put_partial(part, tt, ts);
    grid.sync();
    grid_sum2(part, G, sh, tt, ts);
    const double omega = tt > eps ? ts / tt : 0.0;

    double* part2 = part + 2 * G;
    double rr = 0.0, rh = 0.0;
    for (long long k = gtid(); k < n2; k += T) {
        double2 xk = ld2(x, k), ph = ld2(phat, k), sh_ = ld2(shat, k);
        double2 tk = ld2(t, k), sk = ld2(s, k), hk = ld2(rhat, k);
        xk.x = (xk.x + alpha * ph.x) + omega * sh_.x;
        xk.y = (xk.y + alpha * ph.y) + omega * sh_.y;
        double2 rn = make_double2((-omega) * tk.x + sk.x,
                                  (-omega) * tk.y + sk.y);
        st2(x, k, xk);
        st2(r, k, rn);
        rr += rn.x * rn.x;
        rr += rn.y * rn.y;
        rh += hk.x * rn.x;
        rh += hk.y * rn.y;
    }
    if ((n & 1) && gtid() == 0) {
        const long long e = n - 1;
        x[e] = (x[e] + alpha * phat[e]) + omega * shat[e];
        const double rn = (-omega) * t[e] + s[e];
        r[e] = rn;
        rr += rn * rn;
        rh += rhat[e] * rn;
    }
    block_sum2(rr, rh, sh);
    put_partial(part2, rr, rh);
    grid.sync();
    grid_sum2(part2, G, sh, rr, rh);
    const bool ok = fabs(rho) > eps && fabs(omega) > eps;
    const double beta = ok ? (rh / rho) * (alpha / omega) : 0.0;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        sc[OMEGA] = omega;
        sc[RHO] = rho;
        sc[RHO1] = rh;
        sc[BETA] = beta;
        sc[RR] = rr;
    }
    // each thread reads back the r it wrote above (the same share)
    p_phase(p, r, v, beta, omega, n);
}

}  // namespace

extern "C" {

// out[0]: the grid G for vectors of n values on the current device;
// out[1]: its SM count; out[2..5]: co-resident blocks per SM of init,
// p_update, alpha_s and omega_xr_p; out[6..9]: their registers per thread
int opm_k8_grid(long long n, int* out) {
    int dev = 0, nsm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
    const void* ks[4] = {(const void*)k8_init, (const void*)k8_p_update,
                         (const void*)k8_alpha_s,
                         (const void*)k8_omega_xr_p};
    int co = 1 << 30;
    for (int i = 0; i < 4; ++i) {
        int nb = 0;
        cudaFuncAttributes fa;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, ks[i],
                                                            kThreads, 0);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, ks[i]);
        if (err != cudaSuccess) return (int)err;
        out[2 + i] = nb;
        out[6 + i] = fa.numRegs;
        if (i >= 2 && nb < co) co = nb;
    }
    long long need = ((n >> 1) + kThreads - 1) / kThreads;
    long long g = (long long)co * nsm;
    if (need < g) g = need;
    out[0] = (int)(g < 1 ? 1 : g);
    out[1] = nsm;
    return 0;
}

// sc (8,), part (4 G,) float64 and ticket (one unsigned, 0 between
// launches) are the solve's workspace; vectors are n float64 values,
// 16-byte aligned

int opm_k8_init(const double* b, long long n, int grid, double* sc,
                double* part, unsigned int* ticket, cudaStream_t stream) {
    k8_init<<<grid, kThreads, 0, stream>>>(b, n, sc, part, ticket);
    return (int)cudaGetLastError();
}

int opm_k8_p_update(double* p, const double* r, const double* v,
                    const double* sc, long long n, int grid,
                    cudaStream_t stream) {
    k8_p_update<<<grid, kThreads, 0, stream>>>(p, r, v, sc, n);
    return (int)cudaGetLastError();
}

int opm_k8_alpha_s(const double* rhat, const double* v, const double* r,
                   double* s, double* sc, double* part, long long n,
                   int grid, cudaStream_t stream) {
    void* args[] = {&rhat, &v, &r, &s, &sc, &part, &n};
    return (int)cudaLaunchCooperativeKernel((const void*)k8_alpha_s,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

int opm_k8_omega_xr_p(const double* t, const double* s, double* x,
                      double* r, const double* phat, const double* shat,
                      const double* rhat, double* p, const double* v,
                      double* sc, double* part, long long n, int grid,
                      cudaStream_t stream) {
    void* args[] = {&t, &s, &x, &r, &phat, &shat, &rhat, &p, &v, &sc,
                    &part, &n};
    return (int)cudaLaunchCooperativeKernel((const void*)k8_omega_xr_p,
                                            dim3(grid), dim3(kThreads),
                                            args, 0, stream);
}

}  // extern "C"
