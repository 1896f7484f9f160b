// Barrel-warp bilinear resample for Hopper (sm_90a): stage 12.
//
// Replaces: pythoncrt_tpu/kernels/warp.py, warp_planar / _warp_kernel (the
// Pallas TPU kernel, which expresses the gather as one-hot MXU matmuls).
//
// What bounds it on the card: bytes. Per 1080p batch of 8 it must read the
// f32 feed (199 MB) and the four (H, W) tables of the static map once
// (4 x 4 B x 2,073,600 = 33.2 MB) and write the output (50 MB of uint8, or
// 199 MB of f32): 282 MB, 0.084 ms at 3.35 TB/s for the uint8 emit.
//
// Design: the kernel reads the tables once per batch, not once per frame.
// One thread owns four adjacent outputs of the flattened frame: it loads
// their tables once (16-byte loads where W % 4 == 0) and keeps each
// pixel's tap offset, in-frame taps and fractions in registers, then loops
// over the batch's B x 3 planes, gathering the four taps of each output
// from device memory (the taps of neighbouring threads overlap, and L1 and
// L2 serve the repeats) and storing four outputs at a time (uchar4 or
// float4 where W % 4 == 0). A tap outside the frame is not read. A tiled
// form that copied each 32 x 128 tile's source footprint into shared
// memory per plane (cp.async, double-buffered) was slower at every tile
// height on an H100 (PERF.md).
//
// Weights and the sum follow oracle.ops.remap_bilinear_const0 op for op
// (compiled with -fmad=false; out-of-frame taps are 0), so the f32 result
// is the oracle's; the uint8 cast clip(rint(v * 255)) is fused into the
// store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

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
    int32_t vec;        // W % 4 == 0, every pointer 16-byte aligned
};

namespace {

// Four outputs' tables from flat index i (pixels i..i+3 with v < nv):
// per pixel its tap (y0, x0)'s offset in the plane, its in-frame taps
// (bits 0-3: (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1); bit
// 4: the pixel is stored; 5 bits a pixel) and its fractions.
__device__ __forceinline__ unsigned load_pixels(const WarpArgs& a, size_t i, int nv, int off[4],
                                                float fy[4], float fx[4]) {
    int yi[4] = {0, 0, 0, 0}, xi[4] = {0, 0, 0, 0};
    if (a.vec && nv == 4) {
        const int4 y4 = __ldg(reinterpret_cast<const int4*>(a.y0 + i));
        const int4 x4 = __ldg(reinterpret_cast<const int4*>(a.x0 + i));
        const float4 fy4 = __ldg(reinterpret_cast<const float4*>(a.fy + i));
        const float4 fx4 = __ldg(reinterpret_cast<const float4*>(a.fx + i));
        yi[0] = y4.x; yi[1] = y4.y; yi[2] = y4.z; yi[3] = y4.w;
        xi[0] = x4.x; xi[1] = x4.y; xi[2] = x4.z; xi[3] = x4.w;
        fy[0] = fy4.x; fy[1] = fy4.y; fy[2] = fy4.z; fy[3] = fy4.w;
        fx[0] = fx4.x; fx[1] = fx4.y; fx[2] = fx4.z; fx[3] = fx4.w;
    } else {
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
            fy[v] = fx[v] = 0.0f;
            if (v < nv) {
                yi[v] = __ldg(a.y0 + i + v);
                xi[v] = __ldg(a.x0 + i + v);
                fy[v] = __ldg(a.fy + i + v);
                fx[v] = __ldg(a.fx + i + v);
            }
        }
    }
    unsigned ok = 0;
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
        off[v] = 0;
        if (v < nv) {
            const bool y0k = yi[v] >= 0 && yi[v] < a.h, y1k = yi[v] + 1 >= 0 && yi[v] + 1 < a.h;
            const bool x0k = xi[v] >= 0 && xi[v] < a.w, x1k = xi[v] + 1 >= 0 && xi[v] + 1 < a.w;
            const unsigned bits = (y0k && x0k) | (y0k && x1k) << 1 | (y1k && x0k) << 2
                                  | (y1k && x1k) << 3 | 16u;
            ok |= bits << (5 * v);
            off[v] = yi[v] * a.w + xi[v];
        }
    }
    return ok;
}

// The four outputs of one plane, in remap_bilinear_const0's order, stored
// at out[o..o+3] (those with bit 4).
template <bool U8>
__device__ __forceinline__ void gather_store(const WarpArgs& a, const float* plane,
                                             const int off[4], unsigned ok, const float fy[4],
                                             const float fx[4], size_t o) {
    const int pitch = a.w;
    float r[4];
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
        const unsigned m = ok >> (5 * v);
        const int q = off[v];
        const float t00 = (m & 1u) ? plane[q] : 0.0f;
        const float t01 = (m & 2u) ? plane[q + 1] : 0.0f;
        const float t10 = (m & 4u) ? plane[q + pitch] : 0.0f;
        const float t11 = (m & 8u) ? plane[q + pitch + 1] : 0.0f;
        const float w00 = (1.0f - fy[v]) * (1.0f - fx[v]);
        const float w01 = (1.0f - fy[v]) * fx[v];
        const float w10 = fy[v] * (1.0f - fx[v]);
        const float w11 = fy[v] * fx[v];
        r[v] = w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11;
    }
    const bool all4 = ((ok >> 19) & 1u) != 0;  // pixel 3 stored: all four are
    if constexpr (U8) {
        uint8_t u[4];
        #pragma unroll
        for (int v = 0; v < 4; ++v)
            u[v] = (uint8_t)fminf(fmaxf(rintf(r[v] * 255.0f), 0.0f), 255.0f);
        uint8_t* d = static_cast<uint8_t*>(a.out) + o;
        if (a.vec && all4) {
            *reinterpret_cast<uchar4*>(d) = make_uchar4(u[0], u[1], u[2], u[3]);
        } else {
            #pragma unroll
            for (int v = 0; v < 4; ++v) if ((ok >> (5 * v + 4)) & 1u) d[v] = u[v];
        }
    } else {
        float* d = static_cast<float*>(a.out) + o;
        if (a.vec && all4) {
            *reinterpret_cast<float4*>(d) = make_float4(r[0], r[1], r[2], r[3]);
        } else {
            #pragma unroll
            for (int v = 0; v < 4; ++v) if ((ok >> (5 * v + 4)) & 1u) d[v] = r[v];
        }
    }
}

// One thread per four outputs of the flattened frame.
template <bool U8>
__global__ void __launch_bounds__(NT)
warp_kernel(const __grid_constant__ WarpArgs a) {
    const size_t n = (size_t)a.h * a.w;
    const size_t i = ((size_t)blockIdx.x * NT + threadIdx.x) * 4;
    if (i >= n) return;
    int off[4];
    float fy[4], fx[4];
    const unsigned ok = load_pixels(a, i, (int)(n - i < 4 ? n - i : 4), off, fy, fx);
    const int nplanes = a.b * 3;
    for (int p = 0; p < nplanes; ++p)
        gather_store<U8>(a, a.img + (size_t)p * n, off, ok, fy, fx, (size_t)p * n + i);
}

}  // namespace

extern "C" int crt_warp_launch(const WarpArgs* a, void* stream) {
    if (a->b < 1 || a->h < 1 || a->w < 1) return (int)cudaErrorInvalidValue;
    const size_t groups = ((size_t)a->h * a->w + 3) / 4;
    const unsigned blocks = (unsigned)((groups + NT - 1) / NT);
    const auto s = static_cast<cudaStream_t>(stream);
    if (a->emit_u8)
        warp_kernel<true><<<blocks, NT, 0, s>>>(*a);
    else
        warp_kernel<false><<<blocks, NT, 0, s>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_warp_args_bytes() { return (int)sizeof(WarpArgs); }
