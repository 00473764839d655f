// K3: TPFA phase fluxes and their divergence on the structured grid, with a
// batched tangent entry for the Jacobian, for Hopper.
//
// Replaces the JAX package's models/blackoil.py face_flux_from_q
// (:176-212), the structured BlackoilModel.face_fluxes (:298-331) and the
// structured BlackoilModel.divergence (:341-364), which XLA fused on the
// TPU into shifted-slice face passes and pad+add scatters.
//
// What bounds it on the card: memory traffic. Per cell the forward reads
// 3 phase pressures, 3 densities, 3 b*mobilities, rs, rv and depth (12
// values), its <= 3 faces' transmissibilities, and writes 3 values.
//
// The forward entry is a 2.5-D tile march. A block of 32 x 8 threads
// (a warp along i) covers 32 x 8 cells of an (i, j) tile whose first and
// last columns and rows are halo: the tile's outputs are the inner 30 x 6
// cells, and tiles step by 30 in i and 6 in j. The block marches over a
// run of z planes with two plane buffers in shared memory: while a
// plane's faces are evaluated, each thread copies its cell's 12 values of
// the next plane into the other buffer (cp.async, no registers). Every
// thread evaluates the +x face of its cell in the output rows and the +y
// face in the output columns once into shared memory, and each output
// cell its +z face, against the next plane's buffer: that is the next
// plane's -z face, kept in registers, so a run evaluates each of its z
// faces once (a run's first plane evaluates its -z face in a prologue).
// Each output cell then sums its six faces in the gather order of the
// tangent entry below (+x as left, -x as right, then y, then z, from
// 0.0), with the same flux arithmetic (face_flux): the plain version's
// operations and order, so its bits. A face is
// evaluated once by the block that owns its left cell, and once more
// only where the neighbouring block's halo holds its left cell (the halo
// column's +x, the halo row's +y and a run's first -z faces: 7.7% of the
// faces at 60 x 220 x 85). 32-bit indices from the block and thread
// index, no division a cell. The host picks the runs (models/blackoil.py
// div_tiles): as many as fill the card's resident blocks once. On an
// H100 the march's speed follows the blocks an SM holds, so the kernel is
// held to three blocks (80 registers; 61,440 bytes of shared memory
// each): with two, or with halo cells loaded before each plane's barrier,
// it was slower.
//
// The tangent entry is one thread per cell and tangent set, in gather
// form: the thread visits its faces in the reference's order and sums
// their tangent fluxes in registers, each face computed by both of its
// cells with identical arithmetic. It takes B tangent sets of the
// per-cell inputs and returns B tangent divergences with the upwind
// direction fixed by the primal, which is what jax.jacfwd through
// jnp.where computes; B is the batch the Jacobian's vmap folds in. No
// atomics in either entry.
//
// Face order is grid.build_grid's direction-blocked C order: x faces
// (nz, ny, nx-1), then y faces (nz, ny-1, nx), then z faces (nz-1, ny, nx).
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "tpfa_face.cuh"

namespace {

using opm_tpfa::Cells;
using opm_tpfa::Face;
using opm_tpfa::face_flux;
using opm_tpfa::face_primal;
using opm_tpfa::face_tangent;

constexpr int kThreads = 256;

// The six faces of cell c in the reference's accumulation order; calls
// visit(L, R, face_index, sign) for each existing face.
template <typename Visit>
__device__ __forceinline__ void for_faces(int nx, int ny, int nz,
                                          long long c, Visit visit) {
    long long i = c % nx;
    long long j = (c / nx) % ny;
    long long k = c / ((long long)nx * ny);
    long long nfx = (long long)(nx - 1) * ny * nz;
    long long nfy = (long long)nx * (ny - 1) * nz;
    long long plane = (long long)nx * ny;
    if (i < nx - 1) visit(c, c + 1, (k * ny + j) * (nx - 1) + i, 1.0);
    if (i > 0) visit(c - 1, c, (k * ny + j) * (nx - 1) + i - 1, -1.0);
    if (j < ny - 1)
        visit(c, c + nx, nfx + (k * (ny - 1) + j) * nx + i, 1.0);
    if (j > 0)
        visit(c - nx, c, nfx + (k * (ny - 1) + j - 1) * nx + i, -1.0);
    if (k < nz - 1)
        visit(c, c + plane, nfx + nfy + (k * ny + j) * nx + i, 1.0);
    if (k > 0)
        visit(c - plane, c, nfx + nfy + ((k - 1) * ny + j) * nx + i, -1.0);
}

// the 12 values of one cell a face reads: p3, rho3, bmob3, rs, rv, depth
constexpr int kVals = 12;

struct Vals {
    double v[kVals];
    __device__ double p(int ph) const { return v[ph]; }
    __device__ double rho(int ph) const { return v[3 + ph]; }
    __device__ double bmob(int ph) const { return v[6 + ph]; }
    __device__ double rs() const { return v[9]; }
    __device__ double rv() const { return v[10]; }
    __device__ double depth() const { return v[11]; }
};

// a cell's values staged in shared memory: value v at s[v * stride]
struct Staged {
    const double* s;
    int stride;
    __device__ double p(int ph) const { return s[ph * stride]; }
    __device__ double rho(int ph) const { return s[(3 + ph) * stride]; }
    __device__ double bmob(int ph) const { return s[(6 + ph) * stride]; }
    __device__ double rs() const { return s[9 * stride]; }
    __device__ double rv() const { return s[10 * stride]; }
    __device__ double depth() const { return s[11 * stride]; }
};

__device__ __forceinline__ void load_vals(Vals& o, const Cells& q,
                                          const double* __restrict__ depth,
                                          int nc, int c) {
    for (int ph = 0; ph < 3; ++ph) {
        o.v[ph] = q.p[ph * nc + c];
        o.v[3 + ph] = q.rho[ph * nc + c];
        o.v[6 + ph] = q.bmob[ph * nc + c];
    }
    o.v[9] = q.rs[c];
    o.v[10] = q.rv[c];
    o.v[11] = depth[c];
}

// one cell's values copied to a plane slot without passing through
// registers (cp.async); copy_wait waits for this thread's copies
__device__ __forceinline__ void copy_vals(double* plane, int slots, int slot,
                                          const Cells& q,
                                          const double* __restrict__ depth,
                                          int nc, int c) {
    const double* src[kVals] = {q.p + c, q.p + nc + c, q.p + 2 * nc + c,
                                q.rho + c, q.rho + nc + c,
                                q.rho + 2 * nc + c, q.bmob + c,
                                q.bmob + nc + c, q.bmob + 2 * nc + c,
                                q.rs + c, q.rv + c, depth + c};
    for (int v = 0; v < kVals; ++v) {
#ifdef __CUDA_ARCH__
        const unsigned d = (unsigned)__cvta_generic_to_shared(
            plane + v * slots + slot);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                     "l"(src[v]));
#else
        plane[v * slots + slot] = *src[v];
#endif
    }
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// blockDim (32, ty); block (blockIdx.x % tiles_x, blockIdx.x / tiles_x)
// of the (i, j) tiles, blockIdx.y the run of zrun planes; dynamic shared
// memory: two planes of kVals x 32 ty values, then the x and y faces' 3 x
// 32 ty fluxes each (div_tiles' smem)
__global__ void __launch_bounds__(256, 3)
tpfa_div_kernel(int nx, int ny, int nz, int tiles_x, int zrun, Cells q,
                const double* __restrict__ depth,
                const double* __restrict__ trans, double g,
                double* __restrict__ div) {
    extern __shared__ double sm[];
    const int tx = blockDim.x, ty = blockDim.y;
    const int ti = threadIdx.x, tj = threadIdx.y;
    const int nt = tx * ty;
    const int t = tj * tx + ti;
    double* fx = sm + 2 * kVals * nt;
    double* fy = fx + 3 * nt;
    const int bx = blockIdx.x % tiles_x, by = blockIdx.x / tiles_x;
    const int i = bx * (tx - 2) - 1 + ti;
    const int j = by * (ty - 2) - 1 + tj;
    const bool in = i >= 0 && i < nx && j >= 0 && j < ny;
    const bool mid_i = ti > 0 && ti < tx - 1, mid_j = tj > 0 && tj < ty - 1;
    const bool out = in && mid_i && mid_j;
    const int k0 = blockIdx.y * zrun;
    const int k1 = min(nz, k0 + zrun);
    const int area = nx * ny;
    const int nc = area * nz;
    const int nfx = (nx - 1) * ny * nz;
    const int nfz0 = nfx + nx * (ny - 1) * nz;
    const int col = j * nx + i;
    Face f;
    double fz_dn[3] = {0.0, 0.0, 0.0};
    if (in) {
        copy_vals(sm, nt, t, q, depth, nc, k0 * area + col);
        copy_wait();
        // a run after the first: its first plane's -z face
        if (out && k0 > 0) {
            Vals prv;
            load_vals(prv, q, depth, nc, (k0 - 1) * area + col);
            const Staged r{sm + t, nt};
            face_flux(prv, r, trans[nfz0 + (k0 - 1) * area + col], g,
                      prv.depth() - r.depth(), &f, fz_dn);
        }
    }
    for (int k = k0; k < k1; ++k) {
        const bool odd = (k - k0) & 1;
        const double* cur = odd ? sm + kVals * nt : sm;
        double* ahead = odd ? sm : sm + kVals * nt;
        const int base = k * area;
        const bool up = k + 1 < nz;
        __syncthreads();
        // the next plane to the other buffer, while this one's faces are
        // evaluated
        if (in && k + 1 < k1)
            copy_vals(ahead, nt, t, q, depth, nc, base + area + col);
        const Staged own{cur + t, nt};
        double fl[3];
        // x faces of the rows, y faces of the columns that have outputs
        if (in && mid_j && ti < tx - 1 && i + 1 < nx) {
            face_flux(own, Staged{cur + t + 1, nt},
                      trans[(k * ny + j) * (nx - 1) + i], g,
                      own.depth() - cur[11 * nt + t + 1], &f, fl);
            for (int e = 0; e < 3; ++e) fx[e * nt + t] = fl[e];
        }
        if (in && mid_i && tj < ty - 1 && j + 1 < ny) {
            face_flux(own, Staged{cur + t + tx, nt},
                      trans[nfx + (k * (ny - 1) + j) * nx + i], g,
                      own.depth() - cur[11 * nt + t + tx], &f, fl);
            for (int e = 0; e < 3; ++e) fy[e * nt + t] = fl[e];
        }
        copy_wait();
        __syncthreads();
        if (!out) continue;
        double fz_up[3] = {0.0, 0.0, 0.0};
        if (up) {
            if (k + 1 < k1) {
                face_flux(own, Staged{ahead + t, nt},
                          trans[nfz0 + base + col], g,
                          own.depth() - ahead[11 * nt + t], &f, fz_up);
            } else {
                Vals r;
                load_vals(r, q, depth, nc, base + area + col);
                face_flux(own, r, trans[nfz0 + base + col], g,
                          own.depth() - r.depth(), &f, fz_up);
            }
        }
        for (int e = 0; e < 3; ++e) {
            double acc = 0.0;
            if (i + 1 < nx) acc = acc + fx[e * nt + t];
            if (i > 0) acc = acc + (-fx[e * nt + t - 1]);
            if (j + 1 < ny) acc = acc + fy[e * nt + t];
            if (j > 0) acc = acc + (-fy[e * nt + t - tx]);
            if (up) acc = acc + fz_up[e];
            if (k > 0) acc = acc + (-fz_dn[e]);
            div[e * nc + base + col] = acc;
            fz_dn[e] = fz_up[e];
        }
    }
}

// tangents: dp, drho, dbmob (B, 3, nc); drs, drv (B, nc); ddiv (B, 3, nc)
__global__ void tpfa_div_tangent_kernel(int nx, int ny, int nz, int B,
                                        Cells q, Cells dq,
                                        const double* __restrict__ depth,
                                        const double* __restrict__ trans,
                                        double g,
                                        double* __restrict__ ddiv) {
    long long nc = (long long)nx * ny * nz;
    long long total = nc * B;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        long long b = idx / nc;
        long long c = idx - b * nc;
        Cells t;
        t.p = dq.p + b * 3 * nc;
        t.rho = dq.rho + b * 3 * nc;
        t.bmob = dq.bmob + b * 3 * nc;
        t.rs = dq.rs + b * nc;
        t.rv = dq.rv + b * nc;
        double acc[3] = {0.0, 0.0, 0.0};
        for_faces(nx, ny, nz, c,
                  [&](long long L, long long R, long long fi, double sgn) {
            Face f;
            double flux[3], flux_t[3];
            double dz = depth[L] - depth[R];
            face_primal(q, nc, L, R, trans[fi], g, dz, &f, flux);
            face_tangent(t, nc, L, R, trans[fi], g, dz, f, flux_t);
            for (int e = 0; e < 3; ++e)
                acc[e] = acc[e] + (sgn > 0.0 ? flux_t[e] : -flux_t[e]);
        });
        for (int e = 0; e < 3; ++e) ddiv[b * 3 * nc + e * nc + c] = acc[e];
    }
}

int blocks_for(long long n) {
    long long b = (n + kThreads - 1) / kThreads;
    if (b < 1) b = 1;
    if (b > 65535LL * 32) b = 65535LL * 32;
    return (int)b;
}

}  // namespace

// the forward entry over div_tiles' geometry: blocks (32, ty), grid
// (tiles_x tiles_y, runs), smem bytes of dynamic shared memory
extern "C" int opm_tpfa_div(int nx, int ny, int nz, int ty, int tiles_x,
                            int tiles_y, int zrun, int runs, int smem,
                            const double* p, const double* rho,
                            const double* bmob, const double* rs,
                            const double* rv, const double* depth,
                            const double* trans, double g, double* div,
                            void* stream) {
    Cells q{p, rho, bmob, rs, rv};
    cudaError_t err = cudaFuncSetAttribute(
        tpfa_div_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    tpfa_div_kernel<<<dim3(tiles_x * tiles_y, runs), dim3(32, ty), smem,
                      (cudaStream_t)stream>>>(nx, ny, nz, tiles_x, zrun, q,
                                              depth, trans, g, div);
    return (int)cudaGetLastError();
}

// the forward kernel's resident blocks per SM at (32, ty) threads and
// smem bytes, and the device's SM count: out[0], out[1]
extern "C" int opm_tpfa_div_occupancy(int ty, int smem, int* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            tpfa_div_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[1], tpfa_div_kernel, 32 * ty, smem);
    return (int)err;
}

extern "C" int opm_tpfa_div_tangent(int nx, int ny, int nz, int B,
                                    const double* p, const double* rho,
                                    const double* bmob, const double* rs,
                                    const double* rv, const double* dp,
                                    const double* drho, const double* dbmob,
                                    const double* drs, const double* drv,
                                    const double* depth, const double* trans,
                                    double g, double* ddiv, void* stream) {
    Cells q{p, rho, bmob, rs, rv};
    Cells dq{dp, drho, dbmob, drs, drv};
    long long n = (long long)nx * ny * nz * B;
    tpfa_div_tangent_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        nx, ny, nz, B, q, dq, depth, trans, g, ddiv);
    return (int)cudaGetLastError();
}
