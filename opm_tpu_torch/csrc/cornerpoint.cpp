// Native corner-point connection builder (host C++).
//
// The role of opm-grid's processEclipseGrid/cpgrid face construction, a
// copy of the JAX package's native/cornerpoint.cpp: vertical faces are
// conforming by construction; lateral faces pair cells across each pillar
// interface by z-interval overlap (stair-step faults), with the clipped
// quad's area vector and centroid computed from the left cell's face
// edges. grid/cornerpoint.py's Python loops are its plain twin (the tests
// hold the two to the same connection set); at the Norne-class size
// (46x112x22) the loops take tens of seconds where this takes under one.
//
// Built by utils/cuda_lib.py with the host C++ compiler into
// build/opm_tpu_torch/libcornerpoint.so at first use (no fallback: a
// failed build raises).
//
// C ABI (ctypes): all arrays preallocated by the caller.
//   corners: (nz, ny, nx, 2, 2, 2, 3) doubles, index [k][j][i][kc][jc][ic]
//   outputs: g1/g2 (int64), area (n,3), fc (n,3), dir (int64)
//   returns the number of connections written, or -1 if cap is too small.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

struct V3 {
    double x, y, z;
};

inline V3 sub(const V3& a, const V3& b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}

inline V3 cross(const V3& a, const V3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

// area vector (diagonal cross product / 2) + centroid of the quad
// p00, p01, p10, p11 in (edge, top/bot) orientation — identical to the
// Python _quad_geometry
inline void quad_geometry(const V3& p00, const V3& p01, const V3& p10,
                          const V3& p11, double* area, double* fc) {
    V3 d1 = sub(p11, p00);
    V3 d2 = sub(p01, p10);
    V3 a = cross(d1, d2);
    area[0] = 0.5 * a.x;
    area[1] = 0.5 * a.y;
    area[2] = 0.5 * a.z;
    fc[0] = 0.25 * (p00.x + p01.x + p10.x + p11.x);
    fc[1] = 0.25 * (p00.y + p01.y + p10.y + p11.y);
    fc[2] = 0.25 * (p00.z + p01.z + p10.z + p11.z);
}

}  // namespace

extern "C" {

int64_t cp_connections(int64_t nx, int64_t ny, int64_t nz,
                       const double* corners, int64_t cap,
                       int64_t* g1, int64_t* g2, double* area, double* fc,
                       int64_t* dir) {
    // corners index helper: [k][j][i][kc][jc][ic][xyz]
    const int64_t s_ic = 3, s_jc = 2 * 3, s_kc = 2 * 2 * 3;
    const int64_t s_i = 2 * 2 * 2 * 3;
    const int64_t s_j = nx * s_i;
    const int64_t s_k = ny * s_j;
    auto C = [&](int64_t k, int64_t j, int64_t i, int64_t kc, int64_t jc,
                 int64_t ic) -> V3 {
        const double* p = corners + k * s_k + j * s_j + i * s_i +
                          kc * s_kc + jc * s_jc + ic * s_ic;
        return {p[0], p[1], p[2]};
    };
    auto gid = [&](int64_t i, int64_t j, int64_t k) {
        return (k * ny + j) * nx + i;
    };

    int64_t n = 0;
    // ---- vertical (k) faces: conforming by construction ----------------
    for (int64_t k = 0; k + 1 < nz; ++k)
        for (int64_t j = 0; j < ny; ++j)
            for (int64_t i = 0; i < nx; ++i) {
                if (n >= cap) return -1;
                // bottom corners of cell (i,j,k): kc = 1
                quad_geometry(C(k, j, i, 1, 0, 0), C(k, j, i, 1, 0, 1),
                              C(k, j, i, 1, 1, 0), C(k, j, i, 1, 1, 1),
                              area + 3 * n, fc + 3 * n);
                g1[n] = gid(i, j, k);
                g2[n] = gid(i, j, k + 1);
                dir[n] = 2;
                ++n;
            }

    // ---- lateral faces: z-interval overlap across the pillar pair ------
    // axis 0: +x neighbor (left face ic=1, right face ic=0, edges vary jc)
    // axis 1: +y neighbor (left face jc=1, right face jc=0, edges vary ic)
    for (int axis = 0; axis < 2; ++axis) {
        const int64_t di = axis == 0 ? 1 : 0;
        const int64_t dj = axis == 0 ? 0 : 1;
        for (int64_t j = 0; j + dj < ny; ++j)
            for (int64_t i = 0; i + di < nx; ++i) {
                int64_t kR0 = 0;
                for (int64_t kL = 0; kL < nz; ++kL) {
                    // left cell's + side face corners: (edge e, top/bot)
                    V3 cl[2][2];  // [e][tb]
                    for (int e = 0; e < 2; ++e)
                        for (int tb = 0; tb < 2; ++tb)
                            cl[e][tb] =
                                axis == 0 ? C(kL, j, i, tb, e, 1)
                                          : C(kL, j, i, tb, 1, e);
                    const double zL_top[2] = {cl[0][0].z, cl[1][0].z};
                    const double zL_bot[2] = {cl[0][1].z, cl[1][1].z};
                    const double zL_lo = std::min(zL_top[0], zL_top[1]);
                    const double zL_hi = std::max(zL_bot[0], zL_bot[1]);
                    // advance the start pointer past cells fully above
                    while (kR0 < nz) {
                        double rb0 = std::max(
                            (axis == 0 ? C(kR0, j + dj, i + di, 1, 0, 0)
                                       : C(kR0, j + dj, i + di, 1, 0, 0))
                                .z,
                            (axis == 0 ? C(kR0, j + dj, i + di, 1, 1, 0)
                                       : C(kR0, j + dj, i + di, 1, 0, 1))
                                .z);
                        if (rb0 > zL_lo + 1e-12) break;
                        ++kR0;
                    }
                    for (int64_t kR = kR0; kR < nz; ++kR) {
                        V3 cr_t[2], cr_b[2];
                        for (int e = 0; e < 2; ++e) {
                            cr_t[e] = axis == 0
                                          ? C(kR, j + dj, i + di, 0, e, 0)
                                          : C(kR, j + dj, i + di, 0, 0, e);
                            cr_b[e] = axis == 0
                                          ? C(kR, j + dj, i + di, 1, e, 0)
                                          : C(kR, j + dj, i + di, 1, 0, e);
                        }
                        const double zR_top[2] = {cr_t[0].z, cr_t[1].z};
                        const double zR_bot[2] = {cr_b[0].z, cr_b[1].z};
                        const double zR_lo = std::min(zR_top[0], zR_top[1]);
                        if (zR_lo >= zL_hi - 1e-12) break;  // monotone cols
                        double zt[2], zb[2];
                        bool any = false;
                        for (int e = 0; e < 2; ++e) {
                            zt[e] = std::max(zL_top[e], zR_top[e]);
                            zb[e] = std::min(zL_bot[e], zR_bot[e]);
                            if (zb[e] - zt[e] > 1e-12) any = true;
                        }
                        if (!any) continue;
                        if (n >= cap) return -1;
                        // clipped quad from the left face edges
                        V3 p[2][2];  // [e][tb]
                        for (int e = 0; e < 2; ++e) {
                            const double zt_c = std::min(zt[e], zb[e]);
                            const double span =
                                std::max(zL_bot[e] - zL_top[e], 1e-12);
                            const double zvals[2] = {zt_c, zb[e]};
                            for (int tb = 0; tb < 2; ++tb) {
                                double t = (zvals[tb] - zL_top[e]) / span;
                                t = std::min(std::max(t, 0.0), 1.0);
                                p[e][tb] = {
                                    cl[e][0].x +
                                        t * (cl[e][1].x - cl[e][0].x),
                                    cl[e][0].y +
                                        t * (cl[e][1].y - cl[e][0].y),
                                    zvals[tb]};
                            }
                        }
                        quad_geometry(p[0][0], p[0][1], p[1][0], p[1][1],
                                      area + 3 * n, fc + 3 * n);
                        g1[n] = gid(i, j, kL);
                        g2[n] = gid(i + di, j + dj, kR);
                        dir[n] = axis;
                        ++n;
                    }
                }
            }
    }
    return n;
}

}  // extern "C"
