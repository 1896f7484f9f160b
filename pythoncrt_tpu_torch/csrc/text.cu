// Text after the effects for Hopper (sm_90a): stage 13, the overlay
// composited in place on the step's (B, 3, H, W) f32 batch,
//
//   out = clip(v * (1 - a) + rgb * a, 0, 1)
//
// in ops/color.composite_text's op order (__fsub_rn, __fmul_rn twice,
// __fadd_rn, the clip; the file builds with -fmad=false besides), so the
// result is composite_text's bit for bit.
//
// Replaces: the torch ops of composite_text over the whole batch (the
// JAX engine composites by XLA ops; no TPU kernel). Those made three
// whole-frame f32 passes: 9.6 GB for a 16-frame 4K batch.
//
// What bounds it on the card: bytes. The box grid reads and writes each
// value of the caption's box once (a 270 x 1280 box of 16 4K frames:
// 133 MB); the alpha and colour crops, (bh, bw) and (3, bh, bw), are read
// by every frame and stay in L2.
//
// Two grids, chosen by the engine from the route that feeds stage 13:
//
// - The box grid (whole = 0): rows [y0, y1) of each frame and plane, the
//   columns [x0, x1). (y0, y1, x0, x1) bounds the overlay's non-zero
//   alpha, so outside the box a = 0 and the composite is clip(v * 1 + rgb
//   * 0) = clip(v): the identity on values in [0, 1]. The batch reaches
//   stage 13 in [0, 1] where it comes from the fused kernel's f32 emit:
//   every stage of its epilogue ends in clip01 (fused.cu:394-428), and so
//   do the grade (:339-353) and the bloom's combine (:1119-1150, :1224,
//   :1273), with the uint8 input scaled by 1/255 before them. The staged
//   step's epilogue (kernels/fused.py epilogue_ref) clamps at each stage
//   too, and its stand-alone blooms end in clip01 (bloom_walk.cu:463-466,
//   :535). So this grid leaves the values outside the box as they are,
//   and launches nothing for a clear overlay.
// - The whole-frame grid (whole = 1): every row of each frame and plane,
//   the composite inside the box and the clip outside it, one read and
//   one write per value. The warp's f32 emit takes it: its bilinear sums
//   are not clamped, so a value may leave [0, 1] by an ulp.
//
// Design: a block owns one row of one plane of one frame (grid: rows x
// 3 planes x frames), blockDim.x threads along the row, each taking four
// columns at a time. Where W % 4 == 0 and the batch is 16-byte aligned
// (the wrapper checks, kernels/text.py text_plan), the columns from the
// first multiple of 4 in the walk to the last go by 16-byte loads and
// stores, and the walk's unaligned ends (at most three columns each) by
// scalar ones; else every column is scalar. The crops go by 16-byte loads
// too where x0 and the box's width are multiples of 4 and the crops are
// aligned; else four scalar loads per four columns. No value is touched
// by two threads, so the kernel runs in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crt_common.cuh"

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct TextArgs {
    float* img;             // (B, 3, H, W) f32, composited in place
    const float* alpha;     // (y1 - y0, x1 - x0): the overlay's alpha over the box
    const float* rgb;       // (3, y1 - y0, x1 - x0): its colour over the box, in plane order
    int32_t b, h, w;        // frames, rows, columns
    int32_t y0, y1, x0, x1; // the box: rows [y0, y1), columns [x0, x1)
    int32_t whole;          // 1: every row, clipped outside the box; 0: the box alone
    int32_t tx;             // threads along a row
    int32_t vec;            // 1: 16-byte loads and stores of the batch's rows
    int32_t cvec;           // 1: 16-byte loads of the crops' rows
};

namespace {

using crt::clip01;

// composite_text's expression for one value: img * (1 - alpha) + rgb * alpha, clipped
__device__ __forceinline__ float over(float v, float al, float c) {
    return clip01(__fadd_rn(__fmul_rn(v, __fsub_rn(1.0f, al)), __fmul_rn(c, al)));
}

// One value of a box row at column x: the composite inside the box, the
// clip outside it on the whole-frame grid (the box grid walks the box alone).
__device__ __forceinline__ float one(const TextArgs& a, float v, int x, const float* ar,
                                     const float* cr) {
    if (x >= a.x0 && x < a.x1) return over(v, __ldg(ar + (x - a.x0)), __ldg(cr + (x - a.x0)));
    return clip01(v);
}

__global__ void __launch_bounds__(1024)
text_after_kernel(const TextArgs a) {
    const int t = threadIdx.x, nt = blockDim.x, p = blockIdx.y;
    const int y = a.whole ? (int)blockIdx.x : a.y0 + (int)blockIdx.x;
    float* row = a.img + (((size_t)blockIdx.z * 3 + p) * a.h + y) * (size_t)a.w;
    if (y < a.y0 || y >= a.y1) {  // the whole-frame grid's rows outside the box: the clip
        if (a.vec) {
            float4* r4 = reinterpret_cast<float4*>(row);
            for (int q = t; q < (a.w >> 2); q += nt) {
                float4 v = r4[q];
                v.x = clip01(v.x);
                v.y = clip01(v.y);
                v.z = clip01(v.z);
                v.w = clip01(v.w);
                r4[q] = v;
            }
        } else {
            for (int x = t; x < a.w; x += nt) row[x] = clip01(row[x]);
        }
        return;
    }
    const int bh = a.y1 - a.y0, bw = a.x1 - a.x0;
    const float* ar = a.alpha + (size_t)(y - a.y0) * bw;
    const float* cr = a.rgb + ((size_t)p * bh + (y - a.y0)) * bw;
    const int xs = a.whole ? 0 : a.x0, xe = a.whole ? a.w : a.x1;  // the walk's columns
    // the 16-byte body [va, vb): from the first multiple of 4 to the last
    const int va = a.vec ? min((xs + 3) & ~3, xe) : xs;
    const int vb = a.vec ? max(va, xe & ~3) : xs;
    for (int x = xs + t; x < va; x += nt) row[x] = one(a, row[x], x, ar, cr);
    for (int x = vb + t; x < xe; x += nt) row[x] = one(a, row[x], x, ar, cr);
    for (int q = t; q < ((vb - va) >> 2); q += nt) {
        const int x = va + (q << 2);
        float4* p4 = reinterpret_cast<float4*>(row + x);
        float4 v = *p4;
        if (a.cvec && x >= a.x0 && x + 4 <= a.x1) {
            const float4 al = __ldg(reinterpret_cast<const float4*>(ar + (x - a.x0)));
            const float4 c = __ldg(reinterpret_cast<const float4*>(cr + (x - a.x0)));
            v.x = over(v.x, al.x, c.x);
            v.y = over(v.y, al.y, c.y);
            v.z = over(v.z, al.z, c.z);
            v.w = over(v.w, al.w, c.w);
        } else {
            v.x = one(a, v.x, x, ar, cr);
            v.y = one(a, v.y, x + 1, ar, cr);
            v.z = one(a, v.z, x + 2, ar, cr);
            v.w = one(a, v.w, x + 3, ar, cr);
        }
        *p4 = v;
    }
}

}  // namespace

extern "C" int crt_text_launch(const TextArgs* a, void* stream) {
    const bool box = a->y0 < a->y1 && a->x0 < a->x1;
    if (a->b < 1 || a->b > 65535 || a->h < 1 || a->w < 1 || a->tx < 1 || a->tx > 1024
            || (a->vec && a->w % 4 != 0) || (a->cvec && (a->x0 % 4 != 0 || (a->x1 - a->x0) % 4))
            || (box && (a->y0 < 0 || a->y1 > a->h || a->x0 < 0 || a->x1 > a->w))
            || (!box && !a->whole))
        return (int)cudaErrorInvalidValue;
    const int rows = a->whole ? a->h : a->y1 - a->y0;
    text_after_kernel<<<dim3(rows, 3, a->b), a->tx, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_text_args_bytes() { return (int)sizeof(TextArgs); }
