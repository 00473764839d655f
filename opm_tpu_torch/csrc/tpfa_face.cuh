// The TPFA face flux of K3 and its tangent, shared by the structured
// kernels (tpfa.cu) and the face-list kernels (faces.cu): the JAX package's
// models/blackoil.py face_flux_from_q (:176-212) for one face with left
// cell L and right cell R, and its tangent with the upwind direction fixed
// by the primal. Products and sums in the plain version's order (build with
// --fmad=false).
//
// THPRES (:194-198): a face's threshold th >= 0 clips each phase's
// potential, dphi' = sign(dphi) max(|dphi| - th, 0), and the upwinding and
// T dphi use dphi' (inside the threshold the left cell is upstream). Its
// tangent is jax.jacfwd's through jnp.sign and jnp.maximum: dphi_t times 0
// where dphi == 0 or |dphi| < th, 1/2 where |dphi| == th, 1 beyond. A
// negative th (the kernels' null threshold pointer) is no clip at all: the
// arithmetic of the entries without THPRES.

#pragma once

#include <cuda_runtime.h>

namespace opm_tpfa {

struct Cells {
    const double* p;      // (3, nc) phase pressures w, o, g
    const double* rho;    // (3, nc)
    const double* bmob;   // (3, nc) b * mobility
    const double* rs;     // (nc)
    const double* rv;     // (nc)
};

struct Face {
    double dphi[3];       // potential difference L - R per phase
    double up[3];         // upwind flag (1 = left cell) per phase
    double vf[3];         // trans * dphi
    double bm[3];         // upwind b * mobility
    double tw[3];         // the clip's factor on the dphi tangent (1: none)
    double rs_up, rv_up;
};

// a face's threshold: thr[f] in a kernel instantiated with a threshold
// (kThr), else the constant -1 (no clip), so an instantiation without one
// compiles to the arithmetic of the entries without THPRES
template <bool kThr>
__device__ __forceinline__ double thr_at(const double* thr, long long f) {
    return kThr ? thr[f] : -1.0;
}

// One cell's face inputs read from the (3, nc) / (nc,) arrays where they
// are used (as loads of device memory, in the arithmetic's order).
struct CellAt {
    Cells q;
    long long nc, c;
    __device__ double p(int ph) const { return q.p[ph * nc + c]; }
    __device__ double rho(int ph) const { return q.rho[ph * nc + c]; }
    __device__ double bmob(int ph) const { return q.bmob[ph * nc + c]; }
    __device__ double rs() const { return q.rs[c]; }
    __device__ double rv() const { return q.rv[c]; }
};

// The face flux from its left (l) and right (r) cells' inputs, any types
// with CellAt's accessors: the one copy of the flux's arithmetic, which
// every K3 kernel evaluates.
template <typename SideL, typename SideR>
__device__ __forceinline__ void face_flux(const SideL& l, const SideR& r,
                                          double T, double g, double dz,
                                          Face* f, double flux[3],
                                          double th = -1.0) {
    double F[3];
    for (int ph = 0; ph < 3; ++ph) {
        double rho_face = 0.5 * (l.rho(ph) + r.rho(ph));
        double dphi = (l.p(ph) - r.p(ph)) - rho_face * g * dz;
        f->tw[ph] = 1.0;
        if (th >= 0.0) {
            const double a = fabs(dphi);
            const double s = dphi > 0.0 ? 1.0 : (dphi < 0.0 ? -1.0 : 0.0);
            f->tw[ph] = dphi == 0.0 ? 0.0
                      : (a > th ? 1.0 : (a == th ? 0.5 : 0.0));
            dphi = s * fmax(a - th, 0.0);
        }
        bool up = dphi >= 0.0;
        f->dphi[ph] = dphi;
        f->up[ph] = up ? 1.0 : 0.0;
        f->bm[ph] = up ? l.bmob(ph) : r.bmob(ph);
        f->vf[ph] = T * dphi;
        F[ph] = f->bm[ph] * f->vf[ph];
    }
    f->rs_up = f->up[1] != 0.0 ? l.rs() : r.rs();
    f->rv_up = f->up[2] != 0.0 ? l.rv() : r.rv();
    flux[0] = F[0];
    flux[1] = F[1] + f->rv_up * f->bm[2] * f->vf[2];
    flux[2] = F[2] + f->rs_up * f->bm[1] * f->vf[1];
}

__device__ __forceinline__ void face_primal(const Cells& q, long long nc,
                                            long long L, long long R,
                                            double T, double g, double dz,
                                            Face* f, double flux[3],
                                            double th = -1.0) {
    face_flux(CellAt{q, nc, L}, CellAt{q, nc, R}, T, g, dz, f, flux, th);
}

// One side's tangents of the face inputs.
struct Tan {
    double p[3], rho[3], bmob[3], rs, rv;
};

__device__ __forceinline__ Tan tan_zero() {
    Tan t;
    for (int ph = 0; ph < 3; ++ph) t.p[ph] = t.rho[ph] = t.bmob[ph] = 0.0;
    t.rs = t.rv = 0.0;
    return t;
}

// column j (rows p3, rho, bmob, rs, rv of a (3, 11, nc) tangent block) at
// cell c
__device__ __forceinline__ Tan tan_col(const double* cols, long long nc,
                                       int j, long long c) {
    const double* b = cols + (long long)j * 11 * nc + c;
    Tan t;
    for (int ph = 0; ph < 3; ++ph) {
        t.p[ph] = b[ph * nc];
        t.rho[ph] = b[(3 + ph) * nc];
        t.bmob[ph] = b[(6 + ph) * nc];
    }
    t.rs = b[9 * nc];
    t.rv = b[10 * nc];
    return t;
}

// the flux tangent from the left and right cells' input tangents; with
// zero_threshold the dphi tangent is 0 where dphi == 0 exactly (the
// derivative of a THPRES clip with threshold 0, which the block assembly
// goes through); a clipped face's dphi tangent takes the clip's factor
__device__ __forceinline__ void face_tangent_of(const Face& f, double T,
                                                double g, double dz,
                                                const Tan& a, const Tan& b,
                                                bool zero_threshold,
                                                double flux_t[3]) {
    double F_t[3], bm_t[3], vf_t[3];
    for (int ph = 0; ph < 3; ++ph) {
        double rho_face_t = 0.5 * (a.rho[ph] + b.rho[ph]);
        double dphi_t = (a.p[ph] - b.p[ph]) - rho_face_t * g * dz;
        if (f.tw[ph] != 1.0)
            dphi_t = f.tw[ph] == 0.0 ? 0.0 : 0.5 * dphi_t;
        else if (zero_threshold && f.dphi[ph] == 0.0)
            dphi_t = 0.0;
        bool up = f.up[ph] != 0.0;
        bm_t[ph] = up ? a.bmob[ph] : b.bmob[ph];
        vf_t[ph] = T * dphi_t;
        F_t[ph] = bm_t[ph] * f.vf[ph] + f.bm[ph] * vf_t[ph];
    }
    double rs_up_t = f.up[1] != 0.0 ? a.rs : b.rs;
    double rv_up_t = f.up[2] != 0.0 ? a.rv : b.rv;
    flux_t[0] = F_t[0];
    flux_t[1] = F_t[1] + ((rv_up_t * f.bm[2] + f.rv_up * bm_t[2]) * f.vf[2]
                          + (f.rv_up * f.bm[2]) * vf_t[2]);
    flux_t[2] = F_t[2] + ((rs_up_t * f.bm[1] + f.rs_up * bm_t[1]) * f.vf[1]
                          + (f.rs_up * f.bm[1]) * vf_t[1]);
}

__device__ __forceinline__ Tan tan_at(const Cells& dq, long long nc,
                                      long long c) {
    Tan t;
    for (int ph = 0; ph < 3; ++ph) {
        t.p[ph] = dq.p[ph * nc + c];
        t.rho[ph] = dq.rho[ph * nc + c];
        t.bmob[ph] = dq.bmob[ph * nc + c];
    }
    t.rs = dq.rs[c];
    t.rv = dq.rv[c];
    return t;
}

__device__ __forceinline__ void face_tangent(const Cells& dq, long long nc,
                                             long long L, long long R,
                                             double T, double g, double dz,
                                             const Face& f,
                                             double flux_t[3]) {
    face_tangent_of(f, T, g, dz, tan_at(dq, nc, L), tan_at(dq, nc, R), false,
                    flux_t);
}

// The face's contribution to the Jacobian: its flux and, for each
// primary j of the left (fL) or right (fR) cell, the flux tangent
// (rows 3 * eq + j); cols is the (3, 11, nc) tangent block of the face
// inputs. Either block pointer may be null (not wanted). Without a
// threshold (th < 0) the tangent goes through a zero one, as the
// reference's assembly does.
__device__ __forceinline__ void face_blocks(const Cells& q,
                                            const double* cols, long long nc,
                                            long long L, long long R,
                                            double T, double g, double dz,
                                            double flux[3], double* fL,
                                            double* fR, double th = -1.0) {
    Face f;
    face_primal(q, nc, L, R, T, g, dz, &f, flux, th);
    const Tan z = tan_zero();
    double ft[3];
    for (int j = 0; j < 3; ++j) {
        if (fL) {
            face_tangent_of(f, T, g, dz, tan_col(cols, nc, j, L), z, true,
                            ft);
            for (int e = 0; e < 3; ++e) fL[3 * e + j] = ft[e];
        }
        if (fR) {
            face_tangent_of(f, T, g, dz, z, tan_col(cols, nc, j, R), true,
                            ft);
            for (int e = 0; e < 3; ++e) fR[3 * e + j] = ft[e];
        }
    }
}

}  // namespace opm_tpfa
