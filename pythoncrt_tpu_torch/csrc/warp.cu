// Barrel-warp bilinear resample for Hopper (sm_90a): stage 12.
//
// Replaces: pythoncrt_tpu/kernels/warp.py, warp_planar / _warp_kernel (the
// Pallas TPU kernel, which expresses the gather as one-hot MXU matmuls).
//
// What bounds it on the card: bytes. Per 1080p frame it reads the 24.9 MB
// f32 feed (each source pixel is read about once; the four taps of
// neighbouring outputs overlap in L1/L2), 16.6 MB of static tables, and
// writes 6.2 MB of uint8.
//
// Design: one thread per output pixel, all three planes. The thread loads
// its integer floor coordinates and fractions once (the oracle's split_map
// tables) and does a direct 4-tap gather per plane; out-of-frame taps read
// as 0 (BORDER_CONSTANT). Weights and the sum follow
// oracle.ops.remap_bilinear_const0 op for op (compiled with -fmad=false),
// so the f32 result is the oracle's. Warp is the last stage of the slice,
// so the uint8 cast clip(rint(v * 255)) is fused into the store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct WarpArgs {
    const float* img;   // (B, 3, H, W) in [0, 1]
    void* out;          // (B, 3, H, W) float or uint8
    const int32_t* y0;  // (H, W) floor of the source row
    const int32_t* x0;  // (H, W) floor of the source column
    const float* fy;    // (H, W) row fraction
    const float* fx;    // (H, W) column fraction
    int32_t b, h, w;
    int32_t emit_u8;
};

namespace {

__global__ void __launch_bounds__(NT)
warp_kernel(const WarpArgs a) {
    const int n = a.h * a.w;
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i >= n) return;
    const int bi = blockIdx.y;
    const int yi = a.y0[i], xi = a.x0[i];
    const float fy = a.fy[i], fx = a.fx[i];
    const float w00 = (1.0f - fy) * (1.0f - fx);
    const float w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx);
    const float w11 = fy * fx;
    const bool yok0 = yi >= 0 && yi < a.h, yok1 = yi + 1 >= 0 && yi + 1 < a.h;
    const bool xok0 = xi >= 0 && xi < a.w, xok1 = xi + 1 >= 0 && xi + 1 < a.w;
    const size_t plane = (size_t)n;
    for (int p = 0; p < 3; ++p) {
        const float* src = a.img + ((size_t)bi * 3 + p) * plane;
        const float t00 = (yok0 && xok0) ? src[(size_t)yi * a.w + xi] : 0.0f;
        const float t01 = (yok0 && xok1) ? src[(size_t)yi * a.w + xi + 1] : 0.0f;
        const float t10 = (yok1 && xok0) ? src[(size_t)(yi + 1) * a.w + xi] : 0.0f;
        const float t11 = (yok1 && xok1) ? src[(size_t)(yi + 1) * a.w + xi + 1] : 0.0f;
        const float v = w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11;
        const size_t o = ((size_t)bi * 3 + p) * plane + i;
        if (a.emit_u8)
            static_cast<uint8_t*>(a.out)[o] =
                (uint8_t)fminf(fmaxf(rintf(v * 255.0f), 0.0f), 255.0f);
        else
            static_cast<float*>(a.out)[o] = v;
    }
}

}  // namespace

extern "C" int crt_warp_launch(const WarpArgs* a, void* stream) {
    const int n = a->h * a->w;
    dim3 grid((n + NT - 1) / NT, a->b);
    warp_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_warp_args_bytes() { return (int)sizeof(WarpArgs); }
