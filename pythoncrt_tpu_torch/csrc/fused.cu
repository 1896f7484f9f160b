// Fused CRT pass for Hopper (sm_90a): stages 1-11 of the effect chain in
// one kernel over planar uint8 frames (or stages 6-11 over an f32 image).
//
// Replaces: pythoncrt_tpu/kernels/fused.py, fused_pipeline / _fused_kernel
// (the Pallas TPU row-stripe kernel), with its three bloom cores: the
// exact gaussian, the fast half-res down+up (the `fast` variant,
// fused.py:453-477, op for op with bloom3._bloom3_fast_kernel) and
// bloom off; and its two inputs: the uint8 frame (`pre`, stages 1-4 in
// the kernel) or the engine's pre-processed f32 image (`pre=False`,
// fused.py:325-326: text composited before the bloom), read as it is.
//
// What bounds it on the card: bytes, on paper. A 1080p frame is 6.2 MB of
// uint8 in (24.9 MB of f32 in the f32-input mode), plus the 8.3 MB f32
// grain field when the noise stage is on;
// the pass writes either 6.2 MB of uint8 (nothing downstream) or 24.9 MB
// of f32 (the warp, glitch or persistence kernel's feed). The arithmetic
// per pixel (grade pow, bloom taps, two triad table reads) is small beside
// that on an H100; measured, the gaussian taps and the FP64 grade pow set
// the time (PERF.md).
//
// Design: one block owns a 32x32 output tile of one frame, all three
// planes (the saturation and triad luma need the three planes of a pixel
// together). The block gathers its tile plus a halo through the composed
// per-plane pixelate/aberration index maps (any pixel size, any frame
// shape), applies /255 and the grade into shared memory (the f32-input
// mode loads the halo with clamped coordinates instead), runs the bloom
// core out of shared memory and finishes the epilogue in registers. Only
// the uint8 input, the grain field, the small per-row/per-column tables
// and the output cross device memory.
// - Gaussian core: an r-pixel halo, reads clamped to the frame (the
//   replicate border); horizontal then vertical taps.
// - Fast core: the oracle's resize_bilinear down to (H/2, W/2) and back,
//   each pass rows first then columns, lo*(1-f) + hi*f, from the oracle's
//   bilinear_taps tables. The halo is the tables' extent for the tile
//   (2 full-res pixels at a 2x ratio), read per block from the tables, so
//   any H and W work, odd ones included.
//
// Exactness: the triad quantizes to a 1024-bin grid, so every f32 op
// upstream of it keeps the reference's order. The file is compiled with
// -fmad=false (no multiply-add contraction); divisions are IEEE (nvcc's
// default -prec-div=true); the grade pow is computed in double and rounded
// once to float; the triad's two pow sites read 1025-entry tables the host
// builds with the same rounding. Gaussian border taps follow the fold the
// JAX paths use: out-of-frame taps add nothing in tap order, then the
// clipped taps' summed coefficient times the edge sample is added (left,
// then right).

#include <cuda_runtime.h>
#include <stdint.h>

#include "crt_common.cuh"

namespace {

constexpr int TX = 32;       // output tile width (kernels/fused.py TILE)
constexpr int TY = 32;       // output tile height
constexpr int NT = 256;      // threads per block
constexpr int MAXK = 63;     // taps (radius <= 31)

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct FusedArgs {
    const uint8_t* img;      // (B, 3, H, W) uint8 frames (pre_on), or null
    const float* imgf;       // (B, 3, H, W) f32 pre-processed image (!pre_on), or null
    void* out;               // (B, 3, H, W) float or uint8
    const int32_t* ymap;     // (H,)    source row of each output row
    const int32_t* xmap;     // (3, W)  source column per plane
    const float* grain;      // (B, H, W) unscaled noise field, or null
    const float* sl;         // (B, H) scanline multiplier, or null
    const float* vy2;        // (H,) vignette ny^2
    const float* vx2;        // (W,) vignette nx^2
    const float* tri;        // (3, W) triad mask rows per plane
    const float* flicker;    // (B,)
    const float* lut_fwd;    // (1025,) pow(i/1024, g)
    const float* lut_fin;    // (1025,) exp2(log2(i/1024) / g)
    // fast bloom core: the oracle's bilinear_taps (lo, frac) per axis
    const int32_t* fd_ylo; const float* fd_yf;   // (H2,) down, rows
    const int32_t* fd_xlo; const float* fd_xf;   // (W2,) down, columns
    const int32_t* fu_ylo; const float* fu_yf;   // (H,)  up, rows
    const int32_t* fu_xlo; const float* fu_xf;   // (W,)  up, columns
    int32_t b, h, w;
    int32_t emit_u8;
    int32_t pre_on;          // 1: stages 1-4 from img; 0: read imgf as it is
    // prologue (stage 1 + 4)
    float inv255;
    int32_t sat_on; float sat;
    int32_t temp_on; float gain[3];          // per plane
    int32_t bc_on; float brightness, contrast;
    int32_t gamma_on; float inv_gamma;
    int32_t ir, ig, ib;                      // plane holding R, G, B
    // bloom (stage 6)
    int32_t bloom_on, r;
    int32_t knee_on; float thr, rden;
    float strength;
    float taps[MAXK];
    float edge_l[MAXK];  // edge_l[d]: summed taps clipped off the left/top at distance d
    float edge_r[MAXK];  // edge_r[d]: same for the right/bottom edge
    int32_t fast_on, h2, w2;
    // largest per-tile extents of the fast core's tables (shared memory
    // sizing): full-res rows/columns, half-res rows/columns
    int32_t fs_rows, fs_cols, fh_rows, fh_cols;
    // epilogue (stages 7-11)
    int32_t triad_mode;  // 0 off, 1 multiply only, 2 LUT-exact
    int32_t luma_on;
    int32_t sl_on, vig_on; float vig_strength;
    int32_t flicker_on;
    int32_t noise_on; float noise_scale;
};

namespace {

using crt::clip01;
using crt::lerp_taps;

__device__ __forceinline__ float knee(const FusedArgs& a, float v) {
    return crt::knee(a.knee_on, a.thr, a.rden, v);
}

__device__ __forceinline__ int quantize(float v) {
    int i = (int)(clip01(v) * 1024.0f);   // truncation toward zero
    return min(max(i, 0), 1024);
}

__device__ __forceinline__ float luma(float r, float g, float b) {
    return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// Stages 1-4 for one pixel: gather through the index maps, /255, grade.
// In the f32-input mode, the pixel of the pre-processed image (gy, gx are
// already clamped to the frame).
__device__ void prologue(const FusedArgs& a, int bi, int gy, int gx, float x[3]) {
    const size_t plane = (size_t)a.h * a.w;
    if (!a.pre_on) {
        const float* src = a.imgf + (size_t)bi * 3 * plane + (size_t)gy * a.w + gx;
        #pragma unroll
        for (int p = 0; p < 3; ++p) x[p] = src[p * plane];
        return;
    }
    const uint8_t* base = a.img + (size_t)bi * 3 * plane;
    const int sy = a.ymap[gy];
    #pragma unroll
    for (int p = 0; p < 3; ++p) {
        const int sx = a.xmap[p * a.w + gx];
        x[p] = (float)base[p * plane + (size_t)sy * a.w + sx] * a.inv255;
    }
    if (a.sat_on) {
        const float l = luma(x[a.ir], x[a.ig], x[a.ib]);
        #pragma unroll
        for (int p = 0; p < 3; ++p) x[p] = clip01(l + (x[p] - l) * a.sat);
    }
    if (a.temp_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p) x[p] = clip01(x[p] * a.gain[p]);
    }
    if (a.bc_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            x[p] = clip01((x[p] - 0.5f) * a.contrast + 0.5f + a.brightness);
    }
    if (a.gamma_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            x[p] = clip01((float)pow((double)x[p], (double)a.inv_gamma));
    }
}

// Stages 7-11 for one composited pixel, then the store.
__device__ void epilogue(const FusedArgs& a, int bi, int gy, int gx, float m[3]) {
    const int h = a.h, w = a.w;
    if (a.triad_mode == 1) {
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * a.tri[p * w + gx]);
    } else if (a.triad_mode == 2) {
        float lin[3], ol[3];
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            lin[p] = a.lut_fwd[quantize(m[p])];
            ol[p] = lin[p] * a.tri[p * w + gx];
        }
        if (a.luma_on) {
            const float yb = luma(lin[a.ir], lin[a.ig], lin[a.ib]);
            const float ya = luma(ol[a.ir], ol[a.ig], ol[a.ib]);
            const float ratio = fminf(fmaxf(yb / fmaxf(ya, 1e-6f), 0.5f), 2.0f);
            #pragma unroll
            for (int p = 0; p < 3; ++p) ol[p] = ol[p] * ratio;
        }
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(a.lut_fin[quantize(ol[p])]);
    }
    if (a.sl_on) {
        const float s = a.sl[(size_t)bi * h + gy];
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * s);
    }
    if (a.vig_on) {
        const float v = 1.0f - a.vig_strength * clip01(a.vy2[gy] + a.vx2[gx]);
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * v);
    }
    if (a.flicker_on) {
        const float f = a.flicker[bi];
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * f);
    }
    if (a.noise_on) {
        const float n = a.grain[((size_t)bi * h + gy) * w + gx] * a.noise_scale;
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] + n);
    }
    const size_t plane = (size_t)h * w;
    const size_t o = (size_t)bi * 3 * plane + (size_t)gy * w + gx;
    if (a.emit_u8) {
        uint8_t* out = static_cast<uint8_t*>(a.out);
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            out[o + p * plane] = (uint8_t)fminf(fmaxf(rintf(m[p] * 255.0f), 0.0f), 255.0f);
    } else {
        float* out = static_cast<float*>(a.out);
        #pragma unroll
        for (int p = 0; p < 3; ++p) out[o + p * plane] = m[p];
    }
}

// Gaussian and bloom-off cores.
__global__ void __launch_bounds__(NT)
fused_kernel(const FusedArgs a) {
    extern __shared__ float smem[];
    const int r = a.bloom_on ? a.r : 0;
    const int k = 2 * r + 1;
    const int rh = TY + 2 * r;          // rows held (tile + halo)
    const int rw = TX + 2 * r;          // columns held
    const int sp = rw + 1;              // padded pitch
    float* S = smem;                    // [3][rh][sp] prologue output (pre-knee)
    float* Hs = smem + 3 * rh * sp;     // [3][rh][TX] horizontal pass

    const int x0 = blockIdx.x * TX;
    const int y0 = blockIdx.y * TY;
    const int bi = blockIdx.z;
    const int tid = threadIdx.x;
    const int h = a.h, w = a.w;

    // ---- prologue into shared memory, halo clamped to the frame ----
    for (int i = tid; i < rh * rw; i += NT) {
        const int ly = i / rw, lx = i - (i / rw) * rw;
        const int gy = min(max(y0 - r + ly, 0), h - 1);
        const int gx = min(max(x0 - r + lx, 0), w - 1);
        float x[3];
        prologue(a, bi, gy, gx, x);
        #pragma unroll
        for (int p = 0; p < 3; ++p) S[(p * rh + ly) * sp + lx] = x[p];
    }
    __syncthreads();

    // ---- horizontal taps on the knee'd source ----
    if (r > 0) {
        for (int i = tid; i < rh * TX; i += NT) {
            const int ly = i / TX, lx = i - (i / TX) * TX;
            const int gx = x0 + lx;
            if (gx >= w) continue;
            const int dl = gx, dr = w - 1 - gx;
            #pragma unroll
            for (int p = 0; p < 3; ++p) {
                const float* row = S + (p * rh + ly) * sp;
                float acc = 0.0f;
                for (int t = 0; t < k; ++t) {
                    const int sx = gx + t - r;
                    if (sx >= 0 && sx < w) acc = acc + a.taps[t] * knee(a, row[lx + t]);
                }
                if (dl < r) acc = acc + a.edge_l[dl] * knee(a, row[r - x0]);
                if (dr < r) acc = acc + a.edge_r[dr] * knee(a, row[(w - 1) - x0 + r]);
                Hs[(p * rh + ly) * TX + lx] = acc;
            }
        }
        __syncthreads();
    }

    // ---- vertical taps, composite, epilogue ----
    for (int i = tid; i < TY * TX; i += NT) {
        const int ly = i / TX, lx = i - (i / TX) * TX;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        float m[3];
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            const float xv = S[(p * rh + ly + r) * sp + lx + r];
            if (!a.bloom_on) { m[p] = xv; continue; }
            // a one-tap gaussian is the identity (the reference skips it)
            float acc = knee(a, xv);
            if (r > 0) {
                const float* col = Hs + p * rh * TX + lx;
                acc = 0.0f;
                for (int t = 0; t < k; ++t) {
                    const int sy = gy + t - r;
                    if (sy >= 0 && sy < h) acc = acc + a.taps[t] * col[(ly + t) * TX];
                }
                const int dt = gy, db = h - 1 - gy;
                if (dt < r) acc = acc + a.edge_l[dt] * col[(r - y0) * TX];
                if (db < r) acc = acc + a.edge_r[db] * col[((h - 1) - y0 + r) * TX];
            }
            m[p] = clip01(xv + a.strength * acc);
        }
        epilogue(a, bi, gy, gx, m);
    }
}

// Fast core: resize_bilinear(resize_bilinear(knee(x), H/2, W/2), H, W).
__global__ void __launch_bounds__(NT)
fused_fast_kernel(const FusedArgs a) {
    extern __shared__ float smem[];
    const int h = a.h, w = a.w;
    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, bi = blockIdx.z;
    const int tid = threadIdx.x;
    const int ty1 = min(y0 + TY, h) - 1, tx1 = min(x0 + TX, w) - 1;
    const crt::FastWindow fy = crt::fast_window(a.fu_ylo, a.fd_ylo, y0, ty1, h, a.h2);
    const crt::FastWindow fx = crt::fast_window(a.fu_xlo, a.fd_xlo, x0, tx1, w, a.w2);
    const int SR = a.fs_rows, SC = a.fs_cols, HR = a.fh_rows, HC = a.fh_cols;
    float* S = smem;                  // [3][SR][SC] prologue output (pre-knee)
    float* D1 = S + 3 * SR * SC;      // [3][HR][SC] down, rows
    float* D2 = D1 + 3 * HR * SC;     // [3][HR][HC] down, columns: the half-res image
    float* U1 = D2 + 3 * HR * HC;     // [3][TY][HC] up, rows

    for (int i = tid; i < fy.n * fx.n; i += NT) {
        const int ly = i / fx.n, lx = i - ly * fx.n;
        float x[3];
        prologue(a, bi, fy.s0 + ly, fx.s0 + lx, x);
        #pragma unroll
        for (int p = 0; p < 3; ++p) S[(p * SR + ly) * SC + lx] = x[p];
    }
    __syncthreads();
    for (int i = tid; i < fy.nh * fx.n; i += NT) {
        const int li = i / fx.n, lx = i - li * fx.n;
        const int lo = a.fd_ylo[fy.i0 + li];
        const int hi = min(lo + 1, h - 1);
        const float f = a.fd_yf[fy.i0 + li];
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            D1[(p * HR + li) * SC + lx] = lerp_taps(
                knee(a, S[(p * SR + lo - fy.s0) * SC + lx]),
                knee(a, S[(p * SR + hi - fy.s0) * SC + lx]), f);
    }
    __syncthreads();
    for (int i = tid; i < fy.nh * fx.nh; i += NT) {
        const int li = i / fx.nh, lj = i - li * fx.nh;
        const int lo = a.fd_xlo[fx.i0 + lj];
        const int hi = min(lo + 1, w - 1);
        const float f = a.fd_xf[fx.i0 + lj];
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            const float* row = D1 + (p * HR + li) * SC - fx.s0;
            D2[(p * HR + li) * HC + lj] = lerp_taps(row[lo], row[hi], f);
        }
    }
    __syncthreads();
    const int nty = ty1 - y0 + 1;
    for (int i = tid; i < nty * fx.nh; i += NT) {
        const int ly = i / fx.nh, lj = i - ly * fx.nh;
        const int lo = a.fu_ylo[y0 + ly];
        const int hi = min(lo + 1, a.h2 - 1);
        const float f = a.fu_yf[y0 + ly];
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            U1[(p * TY + ly) * HC + lj] = lerp_taps(
                D2[(p * HR + lo - fy.i0) * HC + lj], D2[(p * HR + hi - fy.i0) * HC + lj], f);
    }
    __syncthreads();
    for (int i = tid; i < TY * TX; i += NT) {
        const int ly = i / TX, lx = i - ly * TX;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        const int lo = a.fu_xlo[gx];
        const int hi = min(lo + 1, a.w2 - 1);
        const float f = a.fu_xf[gx];
        float m[3];
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            const float* row = U1 + (p * TY + ly) * HC - fx.i0;
            const float blur = lerp_taps(row[lo], row[hi], f);
            const float xv = S[(p * SR + gy - fy.s0) * SC + gx - fx.s0];
            m[p] = clip01(xv + a.strength * blur);
        }
        epilogue(a, bi, gy, gx, m);
    }
}

}  // namespace

static int fused_smem_bytes(const FusedArgs* a) {
    if (a->bloom_on && a->fast_on) {
        const int SR = a->fs_rows, SC = a->fs_cols, HR = a->fh_rows, HC = a->fh_cols;
        return (int)sizeof(float) * 3 * (SR * SC + HR * SC + HR * HC + TY * HC);
    }
    const int r = a->bloom_on ? a->r : 0;
    const int rh = TY + 2 * r, sp = TX + 2 * r + 1;
    return (int)sizeof(float) * (3 * rh * sp + (r > 0 ? 3 * rh * TX : 0));
}

extern "C" int crt_fused_launch(const FusedArgs* a, void* stream) {
    if (a->r < 0 || 2 * a->r + 1 > MAXK) return (int)cudaErrorInvalidValue;
    const bool fast = a->bloom_on && a->fast_on;
    void (*kern)(const FusedArgs) = fast ? fused_fast_kernel : fused_kernel;
    const int smem = fused_smem_bytes(a);
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + TX - 1) / TX, (a->h + TY - 1) / TY, a->b);
    kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_fused_args_bytes() { return (int)sizeof(FusedArgs); }
