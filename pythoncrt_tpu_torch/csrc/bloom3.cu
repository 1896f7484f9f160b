// Stand-alone fast bloom for Hopper (sm_90a): stage 6 on an f32 image,
// clip(x + strength * up(down(knee(x)))), plane by plane.
//
// Replaces: pythoncrt_tpu/kernels/bloom3.py, the Pallas TPU row-stripe
// kernel bloom3_fast_cmajor / _bloom3_fast_kernel (the half-res bilinear
// down and up). The engine runs it where its fused kernel cannot take the
// whole chain: 2-D scanlines, whose per-pixel mask runs after the bloom in
// plain torch ops. (bloom3's exact gaussian, _bloom3_kernel, is the FOLD
// instance of csrc/bloom_walk.cu.)
//
// What bounds it on the card: bytes. A 1080p frame is 24.9 MB of f32 read
// and 24.9 MB written; the four 2-tap resize passes are small beside that.
//
// Design: the blur is per colour plane, so the (B, 3, H, W) batch is read
// as B*3 planes and one block owns a 32x32 output tile of one plane. The
// block loads its source extent into shared memory with the knee applied,
// runs the oracle's resize_bilinear down to (H/2, W/2) and back, rows then
// columns in each pass, lo*(1-f) + hi*f, from its bilinear_taps tables, and
// composites with the pre-knee value read from device memory. Each block
// reads its source and half-res extents from the tables
// (crt::fast_window), so odd H and W work too. The TPU kernel's stripe
// heights, DMA ring, sublane rolls and parity masks have no counterpart.
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
    int32_t knee_on; float thr, rden;
    float strength;
    int32_t h2, w2;
    // largest per-tile extents of the fast tables (shared memory sizing):
    // full-res rows/columns, half-res rows/columns
    int32_t fs_rows, fs_cols, fh_rows, fh_cols;
};

namespace {

__device__ __forceinline__ float knee(const Bloom3Args& a, float v) {
    return crt::knee(a.knee_on, a.thr, a.rden, v);
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
    const int SR = a->fs_rows, SC = a->fs_cols, HR = a->fh_rows, HC = a->fh_cols;
    const int smem = (int)sizeof(float) * (SR * SC + HR * SC + HR * HC + TY * HC);
    cudaError_t e = cudaFuncSetAttribute(
        bloom3_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + TX - 1) / TX, (a->h + TY - 1) / TY, a->n);
    bloom3_fast_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_bloom3_args_bytes() { return (int)sizeof(Bloom3Args); }
