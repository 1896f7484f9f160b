// Fused CRT stripe pass for Hopper (sm_90a): stages 1-11 of the effect
// chain in one kernel over planar uint8 frames.
//
// Replaces: pythoncrt_tpu/kernels/fused.py, fused_pipeline / _fused_kernel
// (the Pallas TPU row-stripe kernel).
//
// What bounds it on the card: bytes. A 1080p frame is 6.2 MB of uint8 in,
// and the pass writes either 6.2 MB of uint8 (warp off) or 24.9 MB of f32
// (the warp kernel's feed). The arithmetic per pixel (grade pow, gaussian
// taps, two triad table reads) is small beside that on an H100.
//
// Design: one block owns a 32x32 output tile of one frame, all three
// planes (the saturation and triad luma need the three planes of a pixel
// together). The block gathers its tile plus an r-pixel halo through the
// composed per-plane pixelate/aberration index maps (any pixel size, any
// frame shape: halo reads are clamped to the frame, which is exactly the
// replicate border), applies /255 and the grade into shared memory, runs
// the horizontal then the vertical gaussian taps out of shared memory and
// finishes the epilogue in registers. Only the uint8 input, the small
// per-row/per-column tables and the output cross device memory.
//
// Exactness: the triad quantizes to a 1024-bin grid, so every f32 op
// upstream of it keeps the reference's order. The file is compiled with
// -fmad=false (no multiply-add contraction); divisions are IEEE (nvcc's
// default -prec-div=true); the grade pow is computed in double and rounded
// once to float; the triad's two pow sites read 1025-entry tables the host
// builds with the same rounding. Border taps follow the fold the JAX paths
// use: out-of-frame taps add nothing in tap order, then the clipped taps'
// summed coefficient times the edge sample is added (left, then right).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;       // output tile width
constexpr int TY = 32;       // output tile height
constexpr int NT = 256;      // threads per block
constexpr int MAXK = 63;     // taps (radius <= 31)

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct FusedArgs {
    const uint8_t* img;      // (B, 3, H, W)
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
    int32_t b, h, w;
    int32_t emit_u8;
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
    // epilogue (stages 7-11)
    int32_t triad_mode;  // 0 off, 1 multiply only, 2 LUT-exact
    int32_t luma_on;
    int32_t sl_on, vig_on; float vig_strength;
    int32_t flicker_on;
    int32_t noise_on; float noise_scale;
};

namespace {

__device__ __forceinline__ float clip01(float v) {
    return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float knee(const FusedArgs& a, float v) {
    return a.knee_on ? clip01((v - a.thr) * a.rden) : v;
}

__device__ __forceinline__ int quantize(float v) {
    int i = (int)(clip01(v) * 1024.0f);   // truncation toward zero
    return min(max(i, 0), 1024);
}

__device__ __forceinline__ float luma(float r, float g, float b) {
    return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// Stages 1-4 for one pixel: gather through the index maps, /255, grade.
__device__ void prologue(const FusedArgs& a, int bi, int gy, int gx, float x[3]) {
    const size_t plane = (size_t)a.h * a.w;
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
    const size_t plane = (size_t)h * w;
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
}

}  // namespace

static int fused_smem_bytes(int r) {
    const int rh = TY + 2 * r, sp = TX + 2 * r + 1;
    return (int)sizeof(float) * (3 * rh * sp + (r > 0 ? 3 * rh * TX : 0));
}

extern "C" int crt_fused_launch(const FusedArgs* a, void* stream) {
    if (a->r < 0 || 2 * a->r + 1 > MAXK) return (int)cudaErrorInvalidValue;
    const int r = a->bloom_on ? a->r : 0;
    const int smem = fused_smem_bytes(r);
    cudaError_t e = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + TX - 1) / TX, (a->h + TY - 1) / TY, a->b);
    fused_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_fused_args_bytes() { return (int)sizeof(FusedArgs); }
