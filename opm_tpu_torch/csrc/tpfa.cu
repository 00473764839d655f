// K3: TPFA phase fluxes and their divergence on the structured grid, with a
// batched tangent entry for the Jacobian, for Hopper.
//
// Replaces the JAX package's models/blackoil.py face_flux_from_q
// (:176-212), the structured BlackoilModel.face_fluxes (:298-331) and the
// structured BlackoilModel.divergence (:341-364), which XLA fused on the
// TPU into shifted-slice face passes and pad+add scatters. Both entries
// take the faces' THPRES thresholds thr (nf,) in the grid's face order, or
// null (no clip): tpfa_face.cuh's clip and its tangent, in kernels
// instantiated with a threshold; without one the entries launch the
// instantiation that compiles to the code without THPRES (the occupancy
// queries are that one's).
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
// The tangent entry takes B tangent sets of the per-cell inputs and
// returns B tangent divergences with the upwind direction fixed by the
// primal, which is what jax.jacfwd through jnp.where computes; B is the
// batch the Jacobian's vmap folds in (3 nc + 4 nw on the dense route, 908
// at SPE1). A face's primal record (upwind flags, T dphi, the upwind b
// mobilities and rs/rv) is the same for every tangent set, so each block
// evaluates it once and applies it to a run of tangent sets. Two
// geometries, picked on the host from (dims, B) (models/blackoil.py
// tangent_geometry):
// - whole grid (3 nc <= 1024 threads, 3 nz <= 64; the dense route's SPE1):
//   one block is the grid, thread (i, j, z) is cell c with k = z mod nz
//   and role r = z div nz: the cell's face in direction r (+x, +y, +z) as
//   the left cell, and output component r. A block takes `dirs` tangent
//   sets: it stages the primal values once and evaluates its faces'
//   records once into registers; then per tangent set the set's 11 rows
//   are in shared memory (cp.async into the second of two buffers while
//   the first one's faces are evaluated), each face's tangent flux is
//   evaluated once into shared memory, and each (cell, component) sums its
//   six faces and writes one value: loads and stores coalesced, 32-bit
//   indices, no division an element. The grid's blocks take
//   ceil(B / resident) sets each, resident the card's SMs times the
//   blocks an SM holds (one: 31 nc doubles of shared memory and 1024
//   threads' registers).
// - otherwise the forward's tile march with the tangent set as the third
//   grid axis: the plane buffers carry the set's 11 tangent rows beside
//   the 12 primal values, and each face's primal and tangent are
//   evaluated once per set (again only by the halo, as the forward's);
//   its runs fill the card's resident blocks about four times.
// Each output sums its six faces in the gather order of the parent kernel
// (a thread per cell and set: +x as left, -x as right, then y, then z,
// from 0.0) with the same tangent arithmetic (face_tangent_of), so the
// parent's bits. No atomics in any entry.

// Face order is grid.build_grid's direction-blocked C order: x faces
// (nz, ny, nx-1), then y faces (nz, ny-1, nx), then z faces (nz-1, ny, nx).
// Build with --fmad=false (products and sums round as the plain version's).

#include <cuda_runtime.h>

#include "tpfa_face.cuh"

namespace {

using opm_tpfa::Cells;
using opm_tpfa::Face;
using opm_tpfa::face_flux;
using opm_tpfa::face_tangent_of;
using opm_tpfa::Tan;
using opm_tpfa::tan_at;
using opm_tpfa::thr_at;

// the 12 values of one cell a face reads: p3, rho3, bmob3, rs, rv, depth
constexpr int kVals = 12;
// the 11 rows of a tangent set a face reads: dp3, drho3, dbmob3, drs, drv
constexpr int kTans = 11;

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

// an 8-byte cp.async from global to shared memory (a plain copy off the
// card), and the commit of this thread's copies; copy_wait waits for them
__device__ __forceinline__ void cp8(double* dst, const double* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::);
#endif
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
    for (int v = 0; v < kVals; ++v) cp8(plane + v * slots + slot, src[v]);
    cp_commit();
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
template <bool kThr>
__global__ void __launch_bounds__(256, 3)
tpfa_div_kernel(int nx, int ny, int nz, int tiles_x, int zrun, Cells q,
                const double* __restrict__ depth,
                const double* __restrict__ trans,
                const double* __restrict__ thr, double g,
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
            const int fz = nfz0 + (k0 - 1) * area + col;
            face_flux(prv, r, trans[fz], g, prv.depth() - r.depth(), &f,
                      fz_dn, thr_at<kThr>(thr, fz));
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
            const int fi = (k * ny + j) * (nx - 1) + i;
            face_flux(own, Staged{cur + t + 1, nt}, trans[fi], g,
                      own.depth() - cur[11 * nt + t + 1], &f, fl,
                      thr_at<kThr>(thr, fi));
            for (int e = 0; e < 3; ++e) fx[e * nt + t] = fl[e];
        }
        if (in && mid_i && tj < ty - 1 && j + 1 < ny) {
            const int fi = nfx + (k * (ny - 1) + j) * nx + i;
            face_flux(own, Staged{cur + t + tx, nt}, trans[fi], g,
                      own.depth() - cur[11 * nt + t + tx], &f, fl,
                      thr_at<kThr>(thr, fi));
            for (int e = 0; e < 3; ++e) fy[e * nt + t] = fl[e];
        }
        copy_wait();
        __syncthreads();
        if (!out) continue;
        double fz_up[3] = {0.0, 0.0, 0.0};
        if (up) {
            const int fz = nfz0 + base + col;
            if (k + 1 < k1) {
                face_flux(own, Staged{ahead + t, nt}, trans[fz], g,
                          own.depth() - ahead[11 * nt + t], &f, fz_up,
                          thr_at<kThr>(thr, fz));
            } else {
                Vals r;
                load_vals(r, q, depth, nc, base + area + col);
                face_flux(own, r, trans[fz], g, own.depth() - r.depth(), &f,
                          fz_up, thr_at<kThr>(thr, fz));
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

// a tangent set's 11 rows staged in shared memory: row v at s[v * stride]
__device__ __forceinline__ Tan tan_staged(const double* s, int stride) {
    Tan t;
    for (int ph = 0; ph < 3; ++ph) {
        t.p[ph] = s[ph * stride];
        t.rho[ph] = s[(3 + ph) * stride];
        t.bmob[ph] = s[(6 + ph) * stride];
    }
    t.rs = s[9 * stride];
    t.rv = s[10 * stride];
    return t;
}

// tangent set b of the (B, 3, nc) / (B, nc) tangent arrays
__device__ __forceinline__ Cells tan_set(const Cells& dq, int nc, int b) {
    const int o3 = b * 3 * nc, o1 = b * nc;
    return Cells{dq.p + o3, dq.rho + o3, dq.bmob + o3, dq.rs + o1,
                 dq.rv + o1};
}

// The whole-grid geometry: blockDim (nx, ny, 3 nz), blockIdx.x the sets
// [x dirs, min(B, (x + 1) dirs)); dynamic shared memory 31 nc doubles: two
// buffers of a set's 11 rows (value v of cell c at v nc + c), then the
// face tangent fluxes (component e of cell c's face in direction r at
// (3 r + e) nc + c). The primal values (12 rows) are staged once over the
// second buffer and the first face rows, before any set reaches them.
// tangents: dp, drho, dbmob (B, 3, nc); drs, drv (B, nc); ddiv (B, 3, nc)
template <bool kThr>
__global__ void __launch_bounds__(1024, 1)
tpfa_tangent_whole_kernel(int B, int dirs, Cells q, Cells dq,
                          const double* __restrict__ depth,
                          const double* __restrict__ trans,
                          const double* __restrict__ thr, double g,
                          double* __restrict__ ddiv) {
    extern __shared__ double sm[];
    const int nx = blockDim.x, ny = blockDim.y, nz = blockDim.z / 3;
    const int i = threadIdx.x, j = threadIdx.y;
    const int z = threadIdx.z;
    const int r = z >= 2 * nz ? 2 : (z >= nz ? 1 : 0);
    const int k = z - r * nz;
    const int area = nx * ny, nc = area * nz;
    const int c = k * area + j * nx + i;
    const int tid = r * nc + c;         // the thread's linear index
    double* buf0 = sm;
    double* buf1 = sm + kTans * nc;
    double* ft = sm + 2 * kTans * nc;
    double* pv = buf1;
    const int b0 = blockIdx.x * dirs;
    const int b1 = min(B, b0 + dirs);
    // the primal rows (p, rho, bmob by (r, c); rs, rv, depth by r), and the
    // first set's rows to the first buffer
    pv[tid] = q.p[tid];
    pv[3 * nc + tid] = q.rho[tid];
    pv[6 * nc + tid] = q.bmob[tid];
    pv[(9 + r) * nc + c] = r == 0 ? q.rs[c] : (r == 1 ? q.rv[c] : depth[c]);
    const auto stage = [&](double* dst, int b) {
        const Cells t = tan_set(dq, nc, b);
        cp8(dst + tid, t.p + tid);
        cp8(dst + 3 * nc + tid, t.rho + tid);
        cp8(dst + 6 * nc + tid, t.bmob + tid);
        if (r < 2) cp8(dst + (9 + r) * nc + c, (r == 0 ? t.rs : t.rv) + c);
        cp_commit();
    };
    stage(buf0, b0);
    __syncthreads();
    // this thread's face: direction r of cell c as the left cell
    const int off = r == 0 ? 1 : (r == 1 ? nx : area);
    const bool has = r == 0 ? i + 1 < nx : (r == 1 ? j + 1 < ny : k + 1 < nz);
    const int nfx = (nx - 1) * ny * nz, nfy = nx * (ny - 1) * nz;
    const int fi = r == 0 ? (k * ny + j) * (nx - 1) + i
                 : (r == 1 ? nfx + (k * (ny - 1) + j) * nx + i
                           : nfx + nfy + c);
    Face f;
    double T = 0.0, dz = 0.0;
    if (has) {
        double fl[3];
        T = trans[fi];
        dz = pv[11 * nc + c] - pv[11 * nc + c + off];
        face_flux(Staged{pv + c, nc}, Staged{pv + c + off, nc}, T, g, dz, &f,
                  fl, thr_at<kThr>(thr, fi));
    }
    for (int b = b0; b < b1; ++b) {
        const bool odd = (b - b0) & 1;
        const double* cur = odd ? buf1 : buf0;
        double* next = odd ? buf0 : buf1;
        copy_wait();
        __syncthreads();
        // the next set's rows while this one's faces are evaluated
        if (b + 1 < b1) stage(next, b + 1);
        if (has) {
            double t3[3];
            face_tangent_of(f, T, g, dz, tan_staged(cur + c, nc),
                            tan_staged(cur + c + off, nc), false, t3);
            for (int e = 0; e < 3; ++e) ft[(3 * r + e) * nc + c] = t3[e];
        }
        __syncthreads();
        double acc = 0.0;
        if (i + 1 < nx) acc = acc + ft[r * nc + c];
        if (i > 0) acc = acc + (-ft[r * nc + c - 1]);
        if (j + 1 < ny) acc = acc + ft[(3 + r) * nc + c];
        if (j > 0) acc = acc + (-ft[(3 + r) * nc + c - nx]);
        if (k + 1 < nz) acc = acc + ft[(6 + r) * nc + c];
        if (k > 0) acc = acc + (-ft[(6 + r) * nc + c - area]);
        ddiv[b * 3 * nc + tid] = acc;
    }
}

// one cell's 12 primal values and its 11 rows of tangent set t to a plane
// slot (cp.async): the march's plane buffers of kPlane values a cell
constexpr int kPlane = kVals + kTans;

__device__ __forceinline__ void copy_plane(double* plane, int slots, int slot,
                                           const Cells& q, const Cells& t,
                                           const double* __restrict__ depth,
                                           int nc, int c) {
    for (int ph = 0; ph < 3; ++ph) {
        cp8(plane + ph * slots + slot, q.p + ph * nc + c);
        cp8(plane + (3 + ph) * slots + slot, q.rho + ph * nc + c);
        cp8(plane + (6 + ph) * slots + slot, q.bmob + ph * nc + c);
        cp8(plane + (kVals + ph) * slots + slot, t.p + ph * nc + c);
        cp8(plane + (kVals + 3 + ph) * slots + slot, t.rho + ph * nc + c);
        cp8(plane + (kVals + 6 + ph) * slots + slot, t.bmob + ph * nc + c);
    }
    cp8(plane + 9 * slots + slot, q.rs + c);
    cp8(plane + 10 * slots + slot, q.rv + c);
    cp8(plane + 11 * slots + slot, depth + c);
    cp8(plane + (kVals + 9) * slots + slot, t.rs + c);
    cp8(plane + (kVals + 10) * slots + slot, t.rv + c);
    cp_commit();
}

// The tile march over tangent set blockIdx.z: the forward kernel's thread
// map, tiles and runs (blockIdx.x the tile, blockIdx.y the run); dynamic
// shared memory: two planes of kPlane x 32 ty values, then the x and y
// faces' 3 x 32 ty tangent fluxes each
template <bool kThr>
__global__ void __launch_bounds__(256, 2)
tpfa_tangent_march_kernel(int nx, int ny, int nz, int tiles_x, int zrun,
                          Cells q, Cells dq,
                          const double* __restrict__ depth,
                          const double* __restrict__ trans,
                          const double* __restrict__ thr, double g,
                          double* __restrict__ ddiv) {
    extern __shared__ double sm[];
    const int tx = blockDim.x, ty = blockDim.y;
    const int ti = threadIdx.x, tj = threadIdx.y;
    const int nt = tx * ty;
    const int t = tj * tx + ti;
    double* fx = sm + 2 * kPlane * nt;
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
    const Cells ts = tan_set(dq, nc, blockIdx.z);
    double* dd = ddiv + blockIdx.z * 3 * nc;
    Face f;
    double fl[3], ft[3];
    double fz_dn[3] = {0.0, 0.0, 0.0};
    if (in) {
        copy_plane(sm, nt, t, q, ts, depth, nc, k0 * area + col);
        copy_wait();
        // a run after the first: its first plane's -z face
        if (out && k0 > 0) {
            const int c = (k0 - 1) * area + col;
            Vals prv;
            load_vals(prv, q, depth, nc, c);
            const Staged r{sm + t, nt};
            const double T = trans[nfz0 + c];
            const double dz = prv.depth() - r.depth();
            face_flux(prv, r, T, g, dz, &f, fl, thr_at<kThr>(thr, nfz0 + c));
            face_tangent_of(f, T, g, dz, tan_at(ts, nc, c),
                            tan_staged(sm + kVals * nt + t, nt), false,
                            fz_dn);
        }
    }
    for (int k = k0; k < k1; ++k) {
        const bool odd = (k - k0) & 1;
        const double* cur = odd ? sm + kPlane * nt : sm;
        double* ahead = odd ? sm : sm + kPlane * nt;
        const int base = k * area;
        const bool up = k + 1 < nz;
        __syncthreads();
        // the next plane to the other buffer, while this one's faces are
        // evaluated
        if (in && k + 1 < k1)
            copy_plane(ahead, nt, t, q, ts, depth, nc, base + area + col);
        const Staged own{cur + t, nt};
        const double* town = cur + kVals * nt + t;
        // x faces of the rows, y faces of the columns that have outputs
        if (in && mid_j && ti < tx - 1 && i + 1 < nx) {
            const int fi = (k * ny + j) * (nx - 1) + i;
            const double T = trans[fi];
            const double dz = own.depth() - cur[11 * nt + t + 1];
            face_flux(own, Staged{cur + t + 1, nt}, T, g, dz, &f, fl,
                      thr_at<kThr>(thr, fi));
            face_tangent_of(f, T, g, dz, tan_staged(town, nt),
                            tan_staged(town + 1, nt), false, ft);
            for (int e = 0; e < 3; ++e) fx[e * nt + t] = ft[e];
        }
        if (in && mid_i && tj < ty - 1 && j + 1 < ny) {
            const int fi = nfx + (k * (ny - 1) + j) * nx + i;
            const double T = trans[fi];
            const double dz = own.depth() - cur[11 * nt + t + tx];
            face_flux(own, Staged{cur + t + tx, nt}, T, g, dz, &f, fl,
                      thr_at<kThr>(thr, fi));
            face_tangent_of(f, T, g, dz, tan_staged(town, nt),
                            tan_staged(town + tx, nt), false, ft);
            for (int e = 0; e < 3; ++e) fy[e * nt + t] = ft[e];
        }
        copy_wait();
        __syncthreads();
        if (!out) continue;
        double fz_up[3] = {0.0, 0.0, 0.0};
        if (up) {
            const double T = trans[nfz0 + base + col];
            const double th = thr_at<kThr>(thr, nfz0 + base + col);
            if (k + 1 < k1) {
                const double dz = own.depth() - ahead[11 * nt + t];
                face_flux(own, Staged{ahead + t, nt}, T, g, dz, &f, fl, th);
                face_tangent_of(f, T, g, dz, tan_staged(town, nt),
                                tan_staged(ahead + kVals * nt + t, nt),
                                false, fz_up);
            } else {
                const int c = base + area + col;
                Vals r;
                load_vals(r, q, depth, nc, c);
                const double dz = own.depth() - r.depth();
                face_flux(own, r, T, g, dz, &f, fl, th);
                face_tangent_of(f, T, g, dz, tan_staged(town, nt),
                                tan_at(ts, nc, c), false, fz_up);
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
            dd[e * nc + base + col] = acc;
            fz_dn[e] = fz_up[e];
        }
    }
}

}  // namespace

// the forward entry over div_tiles' geometry: blocks (32, ty), grid
// (tiles_x tiles_y, runs), smem bytes of dynamic shared memory
extern "C" int opm_tpfa_div(int nx, int ny, int nz, int ty, int tiles_x,
                            int tiles_y, int zrun, int runs, int smem,
                            const double* p, const double* rho,
                            const double* bmob, const double* rs,
                            const double* rv, const double* depth,
                            const double* trans, const double* thr, double g,
                            double* div, void* stream) {
    Cells q{p, rho, bmob, rs, rv};
    const dim3 grid(tiles_x * tiles_y, runs), block(32, ty);
    cudaError_t err = cudaFuncSetAttribute(
        thr ? (const void*)tpfa_div_kernel<true>
            : (const void*)tpfa_div_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (thr)
        tpfa_div_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
            nx, ny, nz, tiles_x, zrun, q, depth, trans, thr, g, div);
    else
        tpfa_div_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
            nx, ny, nz, tiles_x, zrun, q, depth, trans, thr, g, div);
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
            tpfa_div_kernel<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[1], tpfa_div_kernel<false>, 32 * ty, smem);
    return (int)err;
}

// the tangent entry over tangent_geometry's launch: whole != 0, blocks
// (bx, by, bz) = (nx, ny, 3 nz) and a grid of gx blocks of dirs sets;
// otherwise blocks (32, by) and a grid (gx = tiles, gy = runs, B) of the
// march over runs of zrun planes; smem bytes of dynamic shared memory
extern "C" int opm_tpfa_div_tangent(int nx, int ny, int nz, int B, int whole,
                                    int by, int gx, int gy, int dirs,
                                    int tiles_x, int zrun, int smem,
                                    const double* p, const double* rho,
                                    const double* bmob, const double* rs,
                                    const double* rv, const double* dp,
                                    const double* drho, const double* dbmob,
                                    const double* drs, const double* drv,
                                    const double* depth, const double* trans,
                                    const double* thr, double g, double* ddiv,
                                    void* stream) {
    Cells q{p, rho, bmob, rs, rv};
    Cells dq{dp, drho, dbmob, drs, drv};
    const void* k =
        whole ? (thr ? (const void*)tpfa_tangent_whole_kernel<true>
                     : (const void*)tpfa_tangent_whole_kernel<false>)
              : (thr ? (const void*)tpfa_tangent_march_kernel<true>
                     : (const void*)tpfa_tangent_march_kernel<false>);
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 wb(nx, ny, 3 * nz), mg(gx, gy, B), mb(32, by);
    if (whole && thr)
        tpfa_tangent_whole_kernel<true><<<gx, wb, smem, st>>>(
            B, dirs, q, dq, depth, trans, thr, g, ddiv);
    else if (whole)
        tpfa_tangent_whole_kernel<false><<<gx, wb, smem, st>>>(
            B, dirs, q, dq, depth, trans, thr, g, ddiv);
    else if (thr)
        tpfa_tangent_march_kernel<true><<<mg, mb, smem, st>>>(
            nx, ny, nz, tiles_x, zrun, q, dq, depth, trans, thr, g, ddiv);
    else
        tpfa_tangent_march_kernel<false><<<mg, mb, smem, st>>>(
            nx, ny, nz, tiles_x, zrun, q, dq, depth, trans, thr, g, ddiv);
    return (int)cudaGetLastError();
}

// the tangent kernel's (whole != 0: the whole-grid one; else the march)
// resident blocks per SM at threads a block and smem bytes, and the
// device's SM count: out[0], out[1]
extern "C" int opm_tpfa_tangent_occupancy(int whole, int threads, int smem,
                                          int* out) {
    const void* k = whole ? (const void*)tpfa_tangent_whole_kernel<false>
                          : (const void*)tpfa_tangent_march_kernel<false>;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], k,
                                                            threads, smem);
    return (int)err;
}
