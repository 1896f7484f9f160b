// Stand-alone bloom for Hopper (sm_90a): stage 6 on an f32 image,
// clip(x + strength * blur(knee(x))), plane by plane.
//
// Replaces: pythoncrt_tpu/kernels/bloom3.py, the Pallas TPU row-stripe
// kernels bloom3_planar / _bloom3_kernel (the exact gaussian) and
// bloom3_fast_cmajor / _bloom3_fast_kernel (the half-res bilinear down and
// up). The engine runs them where its fused kernel cannot take the whole
// chain: 2-D scanlines, whose per-pixel mask runs after the bloom in
// plain torch ops.
//
// What bounds it on the card: bytes. A 1080p frame is 24.9 MB of f32 read
// and 24.9 MB written; the taps (at most 2 x 63 multiply-adds per value,
// 19 at sigma 1.2) and the four 2-tap resize passes are small beside that.
//
// Design: the blur is per colour plane, so the (B, 3, H, W) batch is read
// as B*3 planes and one block owns a 32x32 output tile of one plane (the
// fused kernel's blocks hold three planes because its saturation and luma
// mix them). The block loads its tile plus a halo into shared memory with
// the knee applied, runs both passes out of shared memory, and composites
// with the pre-knee value read from device memory. The TPU kernels' stripe
// heights, DMA ring, sublane rolls and parity masks have no counterpart.
// - Gaussian: an r-pixel halo read with clamped coordinates (any H, W and
//   radius up to 31). Horizontal taps in tap order, out-of-frame taps
//   adding nothing, then edge_l, then edge_r times the edge sample; then
//   the vertical pass the same way (ops/blur.py, fused.cu's core).
// - Fast: the oracle's resize_bilinear down to (H/2, W/2) and back, rows
//   then columns in each pass, lo*(1-f) + hi*f, from its bilinear_taps
//   tables; each block reads its source and half-res extents from the
//   tables (crt::fast_window), so odd H and W work too.
// Built with -fmad=false: every multiply and add rounds separately, in the
// order of the plain PyTorch twin (kernels/bloom3.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "crt_common.cuh"

namespace {

constexpr int TX = 32;       // output tile width (kernels/fused.py TILE: the fast
                             // tables' per-tile extents are computed for it)
constexpr int TY = 32;       // output tile height
constexpr int NT = 256;      // threads per block
constexpr int MAXK = 63;     // taps (radius <= 31)

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct Bloom3Args {
    const float* img;        // (N, H, W) planes in [0, 1]
    float* out;              // (N, H, W)
    // fast variant: the oracle's bilinear_taps (lo, frac) per axis
    const int32_t* fd_ylo; const float* fd_yf;   // (H2,) down, rows
    const int32_t* fd_xlo; const float* fd_xf;   // (W2,) down, columns
    const int32_t* fu_ylo; const float* fu_yf;   // (H,)  up, rows
    const int32_t* fu_xlo; const float* fu_xf;   // (W,)  up, columns
    int32_t n, h, w;
    int32_t fast_on, r;
    int32_t knee_on; float thr, rden;
    float strength;
    float taps[MAXK];
    float edge_l[MAXK];      // edge_l[d]: summed taps clipped off the left/top at distance d
    float edge_r[MAXK];      // edge_r[d]: same for the right/bottom edge
    int32_t h2, w2;
    // largest per-tile extents of the fast tables (shared memory sizing):
    // full-res rows/columns, half-res rows/columns
    int32_t fs_rows, fs_cols, fh_rows, fh_cols;
};

namespace {

__device__ __forceinline__ float knee(const Bloom3Args& a, float v) {
    return crt::knee(a.knee_on, a.thr, a.rden, v);
}

__global__ void __launch_bounds__(NT)
bloom3_gauss_kernel(const Bloom3Args a) {
    extern __shared__ float smem[];
    const int r = a.r;
    const int k = 2 * r + 1;
    const int rh = TY + 2 * r;          // rows held (tile + halo)
    const int rw = TX + 2 * r;          // columns held
    const int sp = rw + 1;              // padded pitch
    float* S = smem;                    // [rh][sp] knee'd source
    float* Hs = smem + rh * sp;         // [rh][TX] horizontal pass

    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
    const int tid = threadIdx.x;
    const int h = a.h, w = a.w;
    const size_t plane = (size_t)h * w;
    const float* src = a.img + blockIdx.z * plane;
    float* dst = a.out + blockIdx.z * plane;

    for (int i = tid; i < rh * rw; i += NT) {
        const int ly = i / rw, lx = i - ly * rw;
        const int gy = min(max(y0 - r + ly, 0), h - 1);
        const int gx = min(max(x0 - r + lx, 0), w - 1);
        S[ly * sp + lx] = knee(a, src[(size_t)gy * w + gx]);
    }
    __syncthreads();

    if (r > 0) {
        for (int i = tid; i < rh * TX; i += NT) {
            const int ly = i / TX, lx = i - ly * TX;
            const int gx = x0 + lx;
            if (gx >= w) continue;
            const float* row = S + ly * sp;
            float acc = 0.0f;
            for (int t = 0; t < k; ++t) {
                const int sx = gx + t - r;
                if (sx >= 0 && sx < w) acc = acc + a.taps[t] * row[lx + t];
            }
            const int dl = gx, dr = w - 1 - gx;
            if (dl < r) acc = acc + a.edge_l[dl] * row[r - x0];
            if (dr < r) acc = acc + a.edge_r[dr] * row[(w - 1) - x0 + r];
            Hs[ly * TX + lx] = acc;
        }
        __syncthreads();
    }

    for (int i = tid; i < TY * TX; i += NT) {
        const int ly = i / TX, lx = i - ly * TX;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        // a one-tap gaussian is the identity (the reference skips it)
        float acc = S[(ly + r) * sp + lx + r];
        if (r > 0) {
            const float* col = Hs + lx;
            acc = 0.0f;
            for (int t = 0; t < k; ++t) {
                const int sy = gy + t - r;
                if (sy >= 0 && sy < h) acc = acc + a.taps[t] * col[(ly + t) * TX];
            }
            const int dt = gy, db = h - 1 - gy;
            if (dt < r) acc = acc + a.edge_l[dt] * col[(r - y0) * TX];
            if (db < r) acc = acc + a.edge_r[db] * col[((h - 1) - y0 + r) * TX];
        }
        const size_t o = (size_t)gy * w + gx;
        dst[o] = crt::clip01(src[o] + a.strength * acc);
    }
}

// resize_bilinear(resize_bilinear(knee(x), H/2, W/2), H, W), composited.
__global__ void __launch_bounds__(NT)
bloom3_fast_kernel(const Bloom3Args a) {
    extern __shared__ float smem[];
    const int h = a.h, w = a.w;
    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
    const int tid = threadIdx.x;
    const size_t plane = (size_t)h * w;
    const float* src = a.img + blockIdx.z * plane;
    float* dst = a.out + blockIdx.z * plane;
    const int ty1 = min(y0 + TY, h) - 1, tx1 = min(x0 + TX, w) - 1;
    const crt::FastWindow fy = crt::fast_window(a.fu_ylo, a.fd_ylo, y0, ty1, h, a.h2);
    const crt::FastWindow fx = crt::fast_window(a.fu_xlo, a.fd_xlo, x0, tx1, w, a.w2);
    const int SC = a.fs_cols, HR = a.fh_rows, HC = a.fh_cols;
    float* S = smem;                      // [SR][SC] knee'd source
    float* D1 = S + a.fs_rows * SC;       // [HR][SC] down, rows
    float* D2 = D1 + HR * SC;             // [HR][HC] down, columns: the half-res image
    float* U1 = D2 + HR * HC;             // [TY][HC] up, rows

    for (int i = tid; i < fy.n * fx.n; i += NT) {
        const int ly = i / fx.n, lx = i - ly * fx.n;
        S[ly * SC + lx] = knee(a, src[(size_t)(fy.s0 + ly) * w + fx.s0 + lx]);
    }
    __syncthreads();
    for (int i = tid; i < fy.nh * fx.n; i += NT) {
        const int li = i / fx.n, lx = i - li * fx.n;
        const int lo = a.fd_ylo[fy.i0 + li];
        const int hi = min(lo + 1, h - 1);
        D1[li * SC + lx] = crt::lerp_taps(S[(lo - fy.s0) * SC + lx],
                                          S[(hi - fy.s0) * SC + lx], a.fd_yf[fy.i0 + li]);
    }
    __syncthreads();
    for (int i = tid; i < fy.nh * fx.nh; i += NT) {
        const int li = i / fx.nh, lj = i - li * fx.nh;
        const int lo = a.fd_xlo[fx.i0 + lj];
        const int hi = min(lo + 1, w - 1);
        const float* row = D1 + li * SC - fx.s0;
        D2[li * HC + lj] = crt::lerp_taps(row[lo], row[hi], a.fd_xf[fx.i0 + lj]);
    }
    __syncthreads();
    const int nty = ty1 - y0 + 1;
    for (int i = tid; i < nty * fx.nh; i += NT) {
        const int ly = i / fx.nh, lj = i - ly * fx.nh;
        const int lo = a.fu_ylo[y0 + ly];
        const int hi = min(lo + 1, a.h2 - 1);
        U1[ly * HC + lj] = crt::lerp_taps(D2[(lo - fy.i0) * HC + lj],
                                          D2[(hi - fy.i0) * HC + lj], a.fu_yf[y0 + ly]);
    }
    __syncthreads();
    for (int i = tid; i < TY * TX; i += NT) {
        const int ly = i / TX, lx = i - ly * TX;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        const int lo = a.fu_xlo[gx];
        const int hi = min(lo + 1, a.w2 - 1);
        const float* row = U1 + ly * HC - fx.i0;
        const float blur = crt::lerp_taps(row[lo], row[hi], a.fu_xf[gx]);
        const size_t o = (size_t)gy * w + gx;
        dst[o] = crt::clip01(src[o] + a.strength * blur);
    }
}

}  // namespace

extern "C" int crt_bloom3_launch(const Bloom3Args* a, void* stream) {
    if (a->n < 1 || a->n > 65535) return (int)cudaErrorInvalidValue;
    const bool fast = a->fast_on != 0;
    if (!fast && (a->r < 0 || 2 * a->r + 1 > MAXK)) return (int)cudaErrorInvalidValue;
    void (*kern)(const Bloom3Args) = fast ? bloom3_fast_kernel : bloom3_gauss_kernel;
    int smem;
    if (fast) {
        const int SR = a->fs_rows, SC = a->fs_cols, HR = a->fh_rows, HC = a->fh_cols;
        smem = (int)sizeof(float) * (SR * SC + HR * SC + HR * HC + TY * HC);
    } else {
        const int rh = TY + 2 * a->r, sp = TX + 2 * a->r + 1;
        smem = (int)sizeof(float) * (rh * sp + rh * TX);
    }
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + TX - 1) / TX, (a->h + TY - 1) / TY, a->n);
    kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_bloom3_args_bytes() { return (int)sizeof(Bloom3Args); }
