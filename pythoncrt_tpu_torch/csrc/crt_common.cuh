// Device helpers shared by fused.cu and the bloom kernels (bloom3.cu,
// bloom2.cu): the clip, the bloom knee, the oracle's lerp order
// and bloom3.cu's tile windows of the fast bloom core. The files build with
// -fmad=false, so every multiply and add here is separately rounded, as in
// the reference's f32 chain.

#pragma once

#include <stdint.h>

namespace crt {

__device__ __forceinline__ float clip01(float v) {
    return fminf(fmaxf(v, 0.0f), 1.0f);
}

// The bloom threshold knee, multiplied by the rounded reciprocal as the
// JAX kernels do (identity when off).
__device__ __forceinline__ float knee(int on, float thr, float rden, float v) {
    return on ? clip01((v - thr) * rden) : v;
}

__device__ __forceinline__ float lerp_taps(float lo, float hi, float f) {
    return lo * (1.0f - f) + hi * f;   // the oracle's resize_bilinear order
}

// The block's source and half-res windows for the fast bloom core, from
// the oracle's bilinear_taps tables: source rows [s0, s0 + n) and half
// rows [i0, i0 + nh) for the tile [t0, t1]; the same on x.
struct FastWindow {
    int s0, n, i0, nh;
};

__device__ __forceinline__ FastWindow fast_window(
        const int32_t* up_lo, const int32_t* dn_lo, int t0, int t1, int full, int half) {
    FastWindow f;
    f.i0 = up_lo[t0];
    const int i1 = min(up_lo[t1] + 1, half - 1);
    f.nh = i1 - f.i0 + 1;
    f.s0 = min(dn_lo[f.i0], t0);           // the tile itself is read for the composite
    const int s1 = max(min(dn_lo[i1] + 1, full - 1), t1);
    f.n = s1 - f.s0 + 1;
    return f;
}

}  // namespace crt
