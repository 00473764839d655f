// The TPFA face flux of K3 and its tangent, shared by the structured
// kernels (tpfa.cu) and the face-list kernels (faces.cu): the JAX package's
// models/blackoil.py face_flux_from_q (:176-212) for one face with left
// cell L and right cell R, and its tangent with the upwind direction fixed
// by the primal. Products and sums in the plain version's order (build with
// --fmad=false).

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
    double up[3];         // upwind flag (1 = left cell) per phase
    double vf[3];         // trans * dphi
    double bm[3];         // upwind b * mobility
    double rs_up, rv_up;
};

__device__ __forceinline__ void face_primal(const Cells& q, long long nc,
                                            long long L, long long R,
                                            double T, double g, double dz,
                                            Face* f, double flux[3]) {
    double F[3];
    for (int ph = 0; ph < 3; ++ph) {
        double rho_face = 0.5 * (q.rho[ph * nc + L] + q.rho[ph * nc + R]);
        double dphi = (q.p[ph * nc + L] - q.p[ph * nc + R])
                      - rho_face * g * dz;
        bool up = dphi >= 0.0;
        f->up[ph] = up ? 1.0 : 0.0;
        f->bm[ph] = up ? q.bmob[ph * nc + L] : q.bmob[ph * nc + R];
        f->vf[ph] = T * dphi;
        F[ph] = f->bm[ph] * f->vf[ph];
    }
    f->rs_up = f->up[1] != 0.0 ? q.rs[L] : q.rs[R];
    f->rv_up = f->up[2] != 0.0 ? q.rv[L] : q.rv[R];
    flux[0] = F[0];
    flux[1] = F[1] + f->rv_up * f->bm[2] * f->vf[2];
    flux[2] = F[2] + f->rs_up * f->bm[1] * f->vf[1];
}

__device__ __forceinline__ void face_tangent(const Cells& dq, long long nc,
                                             long long L, long long R,
                                             double T, double g, double dz,
                                             const Face& f,
                                             double flux_t[3]) {
    double F_t[3], bm_t[3], vf_t[3];
    for (int ph = 0; ph < 3; ++ph) {
        double rho_face_t =
            0.5 * (dq.rho[ph * nc + L] + dq.rho[ph * nc + R]);
        double dphi_t = (dq.p[ph * nc + L] - dq.p[ph * nc + R])
                        - rho_face_t * g * dz;
        bool up = f.up[ph] != 0.0;
        bm_t[ph] = up ? dq.bmob[ph * nc + L] : dq.bmob[ph * nc + R];
        vf_t[ph] = T * dphi_t;
        F_t[ph] = bm_t[ph] * f.vf[ph] + f.bm[ph] * vf_t[ph];
    }
    double rs_up_t = f.up[1] != 0.0 ? dq.rs[L] : dq.rs[R];
    double rv_up_t = f.up[2] != 0.0 ? dq.rv[L] : dq.rv[R];
    flux_t[0] = F_t[0];
    flux_t[1] = F_t[1] + ((rv_up_t * f.bm[2] + f.rv_up * bm_t[2]) * f.vf[2]
                          + (f.rv_up * f.bm[2]) * vf_t[2]);
    flux_t[2] = F_t[2] + ((rs_up_t * f.bm[1] + f.rs_up * bm_t[1]) * f.vf[1]
                          + (f.rs_up * f.bm[1]) * vf_t[1]);
}

}  // namespace opm_tpfa
