// Separable tile blooms for Hopper (sm_90a): stage 6 on an f32 image,
// clip(x + strength * V(H(knee(x)))), plane by plane, where H and V are
// per-axis bands of weights. One tile kernel serves two TPU kernels; only
// where a tap's weight comes from differs:
//
// - per-position tables (the banded separable bloom). Replaces
//   pythoncrt_tpu/kernels/bloom2.py, bloom2_nhwc / _bloom2_kernel
//   (manual-DMA windows) and bloom2_nhwc_pipelined / _bloom2_pipe_kernel
//   (the same function from pipelined pieces, with a `limbs` setting). The
//   JAX engine runs them when PCRT_BLOOM2_GAUSS=1 (gaussian bloom) or
//   PCRT_BLOOM2_FAST=1 (fast bloom) selects them. Each axis's map is a band
//   of per-position weights: the replicate-border gaussian (border taps
//   summed in f64 and rounded once), or the half-res bilinear down and up
//   composed in f64 (the fast variant). The host builds both tables
//   (kernels/bloom2.py) the way bloom2 builds them.
// - one list of constant taps on both axes (the stripe gaussian bloom).
//   Replaces pythoncrt_tpu/kernels/bloom.py, bloom_nhwc / _bloom_kernel,
//   which the JAX engine runs when PCRT_PALLAS_BLOOM=1 selects it. Its
//   function is the oracle's (oracle/ops.py _conv1d_replicate, x pass
//   first, then y): every tap reads a replicate-clamped sample, in tap
//   order. That is what the tile computes with the clamped index below, so
//   the stripe is the tile with band -r..r; it is not bloom3's border fold
//   (the two agree only to an ulp at the borders).
//
// Per plane:  h[y, x] = sum_{d=d0..d1} wh(d, x) * knee(x[y, clamp(x + d)])
//             v[y, x] = sum_{d=d0..d1} wv(d, y) * h[clamp(y + d), x]
//             out     = clip(x + strength * v)
// each sum in d order, the first term its start. A table tap whose index
// leaves the frame carries weight 0; the kernel and its twin clamp the
// index and keep the (zero) product.
//
// The TPU's matmul form (bf16 hi/lo limbs on the MXU, lane pre-pads, lane
// masks, DMA ring) and the stripe kernel's edge-padded row stripes exist
// to reach the MXU and VMEM. Here a band is 9 taps (sigma 1.2) or about 6
// (fast), so f32 multiply-adds on the CUDA cores are the simple right
// kernel. `limbs` keeps the pipelined entry's settings, each one rounding:
// 3 the f32 product; 2 the value rounded to bf16 against the hi + lo
// weight; 1 value and weight both bf16 (the host rounds the weights; the
// kernel rounds the value).
//
// What bounds it on the card: bytes. A 1080p frame is 24.9 MB of f32 read
// and 24.9 MB written; the tables are a few hundred KB, read through the
// caches, and the constant taps travel in the kernel's parameters.
//
// Design: bloom3's tile scheme. One block owns a 32x32 output tile of one
// plane; it loads the knee'd source over the tile plus the band's reach on
// both axes into shared memory (clamped coordinates), runs the horizontal
// pass over the tile's rows plus the vertical reach, then the vertical
// pass, and composites with the pre-knee value from device memory. The
// weight source is a template parameter, so the constant-tap instance
// reads no table and carries neither the bf16 rounding nor the column
// guard the tables need (with them it ran about 10% slower on an H100
// at 1080p, B=8; PERF.md). Any H and W; band offsets within [-31, 31]. Built with
// -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "crt_common.cuh"

namespace {

constexpr int TX = 32;       // output tile width
constexpr int TY = 32;       // output tile height
constexpr int NT = 256;      // threads per block
constexpr int MAXR = 31;     // largest |band offset|
constexpr int MAXK = 2 * MAXR + 1;

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct Bloom2Args {
    const float* img;        // (N, H, W) planes in [0, 1]
    float* out;              // (N, H, W)
    const float* hw;         // (ndh, W) horizontal weights, hw[d - hd0, x]; null: taps
    const float* vw;         // (ndv, H) vertical weights, vw[d - vd0, y]
    int32_t n, h, w;
    int32_t hd0, hd1, vd0, vd1;
    int32_t knee_on; float thr, rden;
    float strength;
    int32_t limbs;           // 3: f32 value; 1, 2: the value rounded to bf16 (tables only)
    float taps[MAXK];        // constant weights of both axes, taps[d - d0] (hw null)
};

namespace {

template <bool kTable>
__global__ void __launch_bounds__(NT)
bloom_tile_kernel(const Bloom2Args a) {
    extern __shared__ float smem[];
    const int ndh = a.hd1 - a.hd0 + 1, ndv = a.vd1 - a.vd0 + 1;
    const int rs = TY + ndv - 1;        // rows held: the tile plus the vertical reach
    const int cs = TX + ndh - 1;        // columns held
    const int sp = cs + 1;              // padded pitch
    float* S = smem;                    // [rs][sp] knee'd source
    float* Hs = smem + rs * sp;         // [rs][TX] horizontal pass

    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
    const int tid = threadIdx.x;
    const int h = a.h, w = a.w;
    const size_t plane = (size_t)h * w;
    const float* src = a.img + blockIdx.z * plane;
    float* dst = a.out + blockIdx.z * plane;

    for (int i = tid; i < rs * cs; i += NT) {
        const int ly = i / cs, lx = i - ly * cs;
        const int gy = min(max(y0 + a.vd0 + ly, 0), h - 1);
        const int gx = min(max(x0 + a.hd0 + lx, 0), w - 1);
        float v = crt::knee(a.knee_on, a.thr, a.rden, src[(size_t)gy * w + gx]);
        if (kTable && a.limbs < 3) v = __bfloat162float(__float2bfloat16_rn(v));
        S[ly * sp + lx] = v;
    }
    __syncthreads();

    // row ly of Hs is image row clamp(y0 + vd0 + ly): a row outside the
    // frame repeats the edge row's horizontal result (what the oracle's
    // second pass reads through its replicate padding) or meets a zero
    // table weight. Columns past the frame read only shared memory and
    // feed no output; only the tables' reads need them skipped.
    for (int i = tid; i < rs * TX; i += NT) {
        const int ly = i / TX, lx = i - ly * TX;
        const int gx = x0 + lx;
        if (kTable && gx >= w) continue;
        const float* row = S + ly * sp + lx;
        float acc;
        if constexpr (kTable) {
            const float* wt = a.hw + gx;
            acc = wt[0] * row[0];
            for (int t = 1; t < ndh; ++t) acc = acc + wt[(size_t)t * w] * row[t];
        } else {
            acc = a.taps[0] * row[0];
            for (int t = 1; t < ndh; ++t) acc = acc + a.taps[t] * row[t];
        }
        Hs[ly * TX + lx] = acc;
    }
    __syncthreads();

    for (int i = tid; i < TY * TX; i += NT) {
        const int ly = i / TX, lx = i - ly * TX;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        const float* col = Hs + ly * TX + lx;
        float acc;
        if constexpr (kTable) {
            const float* wt = a.vw + gy;
            acc = wt[0] * col[0];
            for (int t = 1; t < ndv; ++t) acc = acc + wt[(size_t)t * h] * col[t * TX];
        } else {
            acc = a.taps[0] * col[0];
            for (int t = 1; t < ndv; ++t) acc = acc + a.taps[t] * col[t * TX];
        }
        const size_t o = (size_t)gy * w + gx;
        dst[o] = crt::clip01(src[o] + a.strength * acc);
    }
}

template <bool kTable>
int launch(const Bloom2Args* a, int smem, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        bloom_tile_kernel<kTable>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + TX - 1) / TX, (a->h + TY - 1) / TY, a->n);
    bloom_tile_kernel<kTable><<<grid, NT, smem, stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crt_bloom2_launch(const Bloom2Args* a, void* stream) {
    if (a->n < 1 || a->n > 65535 || a->h < 1 || a->w < 1) return (int)cudaErrorInvalidValue;
    if (a->hd0 > a->hd1 || a->vd0 > a->vd1 || a->hd0 < -MAXR || a->hd1 > MAXR
            || a->vd0 < -MAXR || a->vd1 > MAXR || a->limbs < 1 || a->limbs > 3)
        return (int)cudaErrorInvalidValue;
    const bool table = a->hw != nullptr;
    if (table != (a->vw != nullptr)) return (int)cudaErrorInvalidValue;
    if (!table && (a->hd0 != a->vd0 || a->hd1 != a->vd1)) return (int)cudaErrorInvalidValue;
    const int rs = TY + a->vd1 - a->vd0, sp = TX + a->hd1 - a->hd0 + 1;
    const int smem = (int)sizeof(float) * (rs * sp + rs * TX);
    const auto s = static_cast<cudaStream_t>(stream);
    return table ? launch<true>(a, smem, s) : launch<false>(a, smem, s);
}

extern "C" int crt_bloom2_args_bytes() { return (int)sizeof(Bloom2Args); }
