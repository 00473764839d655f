// Dual3: a float64 value with its tangents in three directions (the
// primaries p, sw, x of a cell), so that each line of a plain formula is
// written once and yields the value and the three Jacobian columns. The
// scalar forms at the end let a formula templated on its number type run
// in plain double where no tangent is wanted.
//
// The rules are PyTorch's forward-mode formulas (derivatives.yaml), so the
// tangents round as torch.func.jvp's do wherever the operation order is
// the same: a * b -> a' b + a b'; a / b -> (a' - b' (a / b)) / b;
// maximum(a, 0) -> f a' with f = 1/2 at a tie, 1 above, 0 below. A double
// operand is a constant (no tangent); the terms that torch drops for an
// input without a tangent are dropped here too. Build with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace opm_dual {

struct Dual3 {
    double v;
    double t[3];
};

// a constant of the number type T (double, or Dual3 with no tangent)
template <class T>
__device__ __forceinline__ T constant(double v) {
    return v;
}

template <>
__device__ __forceinline__ Dual3 constant<Dual3>(double v) {
    return Dual3{v, {0.0, 0.0, 0.0}};
}

// the primary variable of direction k (tangent 1 there, 0 elsewhere)
template <class T>
__device__ __forceinline__ T primary(double v, int) {
    return v;
}

template <>
__device__ __forceinline__ Dual3 primary<Dual3>(double v, int k) {
    Dual3 r{v, {0.0, 0.0, 0.0}};
    r.t[k] = 1.0;
    return r;
}

__device__ __forceinline__ Dual3 operator+(const Dual3& a, const Dual3& b) {
    Dual3 r;
    r.v = a.v + b.v;
    for (int k = 0; k < 3; ++k) r.t[k] = a.t[k] + b.t[k];
    return r;
}

__device__ __forceinline__ Dual3 operator+(double a, const Dual3& b) {
    Dual3 r = b;
    r.v = a + b.v;
    return r;
}

__device__ __forceinline__ Dual3 operator+(const Dual3& a, double b) {
    return b + a;
}

__device__ __forceinline__ Dual3 operator-(const Dual3& a, const Dual3& b) {
    Dual3 r;
    r.v = a.v - b.v;
    for (int k = 0; k < 3; ++k) r.t[k] = a.t[k] - b.t[k];
    return r;
}

__device__ __forceinline__ Dual3 operator-(const Dual3& a, double b) {
    Dual3 r = a;
    r.v = a.v - b;
    return r;
}

__device__ __forceinline__ Dual3 operator-(double a, const Dual3& b) {
    Dual3 r;
    r.v = a - b.v;
    for (int k = 0; k < 3; ++k) r.t[k] = -b.t[k];
    return r;
}

__device__ __forceinline__ Dual3 operator*(const Dual3& a, const Dual3& b) {
    Dual3 r;
    r.v = a.v * b.v;
    for (int k = 0; k < 3; ++k) r.t[k] = a.t[k] * b.v + a.v * b.t[k];
    return r;
}

__device__ __forceinline__ Dual3 operator*(double a, const Dual3& b) {
    Dual3 r;
    r.v = a * b.v;
    for (int k = 0; k < 3; ++k) r.t[k] = b.t[k] * a;
    return r;
}

__device__ __forceinline__ Dual3 operator*(const Dual3& a, double b) {
    return b * a;
}

__device__ __forceinline__ Dual3 operator/(const Dual3& a, const Dual3& b) {
    Dual3 r;
    r.v = a.v / b.v;
    for (int k = 0; k < 3; ++k) r.t[k] = (a.t[k] - b.t[k] * r.v) / b.v;
    return r;
}

__device__ __forceinline__ Dual3 operator/(const Dual3& a, double b) {
    Dual3 r;
    r.v = a.v / b;
    for (int k = 0; k < 3; ++k) r.t[k] = a.t[k] / b;
    return r;
}

__device__ __forceinline__ Dual3 operator/(double a, const Dual3& b) {
    Dual3 r;
    r.v = a / b.v;
    for (int k = 0; k < 3; ++k) r.t[k] = (-(b.t[k] * r.v)) / b.v;
    return r;
}

// torch.where(c, a, b)
__device__ __forceinline__ Dual3 select(bool c, const Dual3& a,
                                        const Dual3& b) {
    return c ? a : b;
}

// torch.maximum(a, zeros): NaN propagates; the tangent weight is 1/2 at a
// tie (torch's forward rule for maximum)
__device__ __forceinline__ Dual3 maximum0(const Dual3& a) {
    double f = (a.v == 0.0) ? 0.5 : (a.v > 0.0 ? 1.0 : 0.0);
    Dual3 r;
    r.v = (isnan(a.v) || a.v > 0.0) ? a.v : 0.0;
    for (int k = 0; k < 3; ++k) r.t[k] = f * a.t[k];
    return r;
}

// a table value v with slope s at the query q (K1's jvp: slope * q')
__device__ __forceinline__ Dual3 chain1(double v, double s, const Dual3& q) {
    Dual3 r;
    r.v = v;
    for (int k = 0; k < 3; ++k) r.t[k] = s * q.t[k];
    return r;
}

// a bilinear table value with slopes (dx, dy) at (qx, qy): dx qx' + dy qy'
__device__ __forceinline__ Dual3 chain2(double v, double dx, double dy,
                                        const Dual3& qx, const Dual3& qy) {
    Dual3 r;
    r.v = v;
    for (int k = 0; k < 3; ++k) r.t[k] = dx * qx.t[k] + dy * qy.t[k];
    return r;
}

// ---- the scalar forms: each is the value part of its Dual3 form above,
// the same double expression, so a formula run in double gives the values
// of its Dual3 run bit for bit (--fmad=false)

__device__ __forceinline__ double value(double a) { return a; }

__device__ __forceinline__ double value(const Dual3& a) { return a.v; }

__device__ __forceinline__ double select(bool c, double a, double b) {
    return c ? a : b;
}

__device__ __forceinline__ double maximum0(double a) {
    return (isnan(a) || a > 0.0) ? a : 0.0;
}

__device__ __forceinline__ double chain1(double v, double, double) {
    return v;
}

__device__ __forceinline__ double chain2(double v, double, double, double,
                                         double) {
    return v;
}

}  // namespace opm_dual
