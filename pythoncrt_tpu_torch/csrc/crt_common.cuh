// Device helpers shared by fused.cu and the blooms' row walk
// (bloom_walk.cu): the clip, the bloom knee and the oracle's lerp order.
// The files build with -fmad=false, so every multiply and add here is
// separately rounded, as in the reference's f32 chain.

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

}  // namespace crt
