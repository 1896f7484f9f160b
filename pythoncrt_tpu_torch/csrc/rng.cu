// Counter-based draws of the native rng (rng="native") for Hopper
// (sm_90a): the grain's standard-normal field and the glitch's offsets,
// one launch per batch and stream.
//
// Replaces no TPU kernel: the JAX package draws with jax.random inside
// its jitted step (threefry keyed by fold_in(seed, frame) and the stream
// tags 11 and 14, pythoncrt_tpu/engine.py _grain_field and
// _glitch_seg_offsets, ops/glitch.py native_export_fields and
// native_preview_offsets), XLA ops and not a Pallas kernel. It was added
// so that the port draws on the card as that package does, in place of a
// host-seeded generator and several launches per frame.
//
// Generator: Philox4x32-10 (Salmon et al., SC'11; Random123's constants).
// Key: the seed mod 2^64 as two 32-bit words. Counter: (element group,
// stream tag, frame index low word, frame index high word). Every value
// is a pure function of (seed, frame, stream, element), so the draws do
// not depend on how frames are split into batches, shards or segments.
// The frame indices are a (B,) int64 tensor on the device.
//
// Transforms: normals by Box-Muller in FP64 from two 32-bit words, rounded
// once to f32 (u1 = (a + 1) 2^-32 in (0, 1], u2 = b 2^-32), so that this
// kernel and its plain twin (kernels/rng.py, torch's FP64 log, sqrt, cos
// and sin on the card) give the same bits; uniforms (x >> 8) 2^-24, exact
// in f32. The file builds with -fmad=false like the others: every f32
// multiply and add of the glitch offsets is rounded on its own, as the
// twin's torch ops are.
//
// Entries (RngArgs.mode):
// 0 grain_normals: (B, gh, gw) f32 N(0, 1); element e of a frame is word
//   e % 4 of group e / 4 (one Philox call makes four normals).
// 1 glitch_export_offsets: (B, rows, NSEG) int32, the export glitch of the
//   reference's distribution (crt_filter.py:846-850): per-segment normals
//   times 0.7 amp (group e / 4 for element e = row * NSEG + segment), a
//   random-walk base (groups 2^31 + row / 4) summed down the rows in f32
//   in order, times 0.1, clipped to +-0.4 amp; then rint(base + seg),
//   half to even.
// 2 glitch_preview_offsets: (B, rows, 1) int32, the preview glitch's
//   (crt_filter.py:670-679): group row, words 0-1 a normal (the cosine
//   branch), word 2 the jump's uniform, word 3 the sign's.
//
// Work: per Philox call, ten rounds of two 32x32-bit multiplies (high and
// low words) and two three-input XORs, the key schedule the same for every
// thread (chip_smoke.py counts the call's integer instructions from its
// SASS); per pair of normals, an FP64 log, sqrt, cos and sin. The grain
// writes 4 bytes per normal. Design: one thread per group of four elements, the stores 16
// bytes where the row allows; the export entry tiles the band's rows, and
// each block draws the walk's normals of the rows above its tile and sums
// them in one thread (at most a few hundred rows), so that no launch waits
// for another.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by a ctypes.Structure in kernels/rng.py.
struct RngArgs {
    void* out;              // mode 0: (B, n0, n1) f32; 1: (B, n0, n1) int32; 2: (B, n0) int32
    const int64_t* frames;  // (B,) absolute frame indices
    const float* amp;       // (n0,) glitch amplitude per band row (modes 1, 2)
    int32_t mode;
    int32_t b, n0, n1;      // mode 0: gh, gw; 1: rows, NSEG; 2: rows, 1
    uint32_t key0, key1;    // the seed mod 2^64: low, high word
    uint32_t stream;        // the stream tag
    int32_t tile;           // mode 1: band rows per block
};

namespace {

constexpr int NT = 256;
constexpr uint32_t WALK_PART = 0x80000000u;  // export: the walk's groups
constexpr double TWO_PI = 6.283185307179586;  // the double nearest 2 pi
constexpr double TWO_M32 = 2.3283064365386963e-10;  // 2^-32

struct Words {
    uint32_t x, y, z, w;
};

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                        uint32_t k0, uint32_t k1) {
    #pragma unroll
    for (int i = 0; i < 10; ++i) {
        if (i > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
    }
    return Words{c0, c1, c2, c3};
}

__device__ __forceinline__ Words draw(const RngArgs& a, uint32_t group, int bi) {
    const uint64_t f = (uint64_t)__ldg(a.frames + bi);
    return philox(group, a.stream, (uint32_t)f, (uint32_t)(f >> 32), a.key0, a.key1);
}

// Two normals from two words: Box-Muller in FP64, each rounded once to f32.
__device__ __forceinline__ void box_muller(uint32_t u, uint32_t v, float& z0, float& z1) {
    const double u1 = ((double)u + 1.0) * TWO_M32;
    const double u2 = (double)v * TWO_M32;
    const double r = sqrt(-2.0 * log(u1));
    const double th = TWO_PI * u2;
    z0 = (float)(r * cos(th));
    z1 = (float)(r * sin(th));
}

__device__ __forceinline__ void normals4(const Words& r, float z[4]) {
    box_muller(r.x, r.y, z[0], z[1]);
    box_muller(r.z, r.w, z[2], z[3]);
}

__device__ __forceinline__ float uniform24(uint32_t x) {
    return (float)(x >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

__global__ void __launch_bounds__(NT) grain_kernel(const __grid_constant__ RngArgs a) {
    const int bi = blockIdx.y;
    const long long n = (long long)a.n0 * a.n1;
    const long long g = (long long)blockIdx.x * NT + threadIdx.x;
    if (4 * g >= n) return;
    float z[4];
    normals4(draw(a, (uint32_t)g, bi), z);
    float* o = static_cast<float*>(a.out) + bi * n + 4 * g;
    if (n % 4 == 0) {
        *reinterpret_cast<float4*>(o) = make_float4(z[0], z[1], z[2], z[3]);
    } else {
        #pragma unroll
        for (int v = 0; v < 4; ++v)
            if (4 * g + v < n) o[v] = z[v];
    }
}

// Rows [y0, ye) of one frame's export offsets. Dynamic shared memory: the
// walk's normals of rows [0, ye), then the base of the tile's rows.
__global__ void __launch_bounds__(NT) export_kernel(const __grid_constant__ RngArgs a) {
    extern __shared__ float sm[];
    const int bi = blockIdx.y, rows = a.n0, nseg = a.n1;
    const int y0 = blockIdx.x * a.tile, ye = min(y0 + a.tile, rows);
    float* walk = sm;
    float* base = sm + rows;
    for (int q = threadIdx.x; 4 * q < ye; q += NT) {
        float z[4];
        normals4(draw(a, WALK_PART | (uint32_t)q, bi), z);
        #pragma unroll
        for (int v = 0; v < 4; ++v)
            if (4 * q + v < ye) walk[4 * q + v] = z[v];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = 0.0f;
        for (int r = 0; r < ye; ++r) {
            s = s + walk[r];
            if (r >= y0) {
                const float lim = __ldg(a.amp + r) * 0.4f;
                base[r - y0] = fminf(fmaxf(s * 0.1f, -lim), lim);
            }
        }
    }
    __syncthreads();
    const long long e0 = (long long)y0 * nseg, e1 = (long long)ye * nseg;
    int32_t* out = static_cast<int32_t*>(a.out) + (long long)bi * rows * nseg;
    for (long long g = e0 / 4 + threadIdx.x; 4 * g < e1; g += NT) {
        float z[4];
        normals4(draw(a, (uint32_t)g, bi), z);
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
            const long long e = 4 * g + v;
            if (e < e0 || e >= e1) continue;
            const int r = (int)(e / nseg);
            const float seg = z[v] * (__ldg(a.amp + r) * 0.7f);
            out[e] = __float2int_rn(base[r - y0] + seg);
        }
    }
}

__global__ void __launch_bounds__(NT) preview_kernel(const __grid_constant__ RngArgs a) {
    const int bi = blockIdx.y, r = blockIdx.x * NT + threadIdx.x;
    if (r >= a.n0) return;
    const Words w = draw(a, (uint32_t)r, bi);
    float z, unused;
    box_muller(w.x, w.y, z, unused);
    const float amp = __ldg(a.amp + r);
    const float base = fminf(fmaxf(z * 0.5f, -1.0f), 1.0f);
    const float jump = uniform24(w.z) < 0.03f ? 1.0f : 0.0f;
    const float sign = uniform24(w.w) < 0.5f ? 1.0f : -1.0f;
    const float v = fminf(fmaxf((base + jump * sign) * amp, -amp), amp);
    static_cast<int32_t*>(a.out)[(long long)bi * a.n0 + r] = __float2int_rn(v);
}

}  // namespace

extern "C" int crt_rng_launch(const RngArgs* a, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a->b <= 0 || a->n0 <= 0 || a->n1 <= 0 || a->b > 65535) return (int)cudaErrorInvalidValue;
    if (a->mode == 0) {
        const long long groups = ((long long)a->n0 * a->n1 + 3) / 4;
        grain_kernel<<<dim3((unsigned)((groups + NT - 1) / NT), a->b), NT, 0, s>>>(*a);
    } else if (a->mode == 1) {
        if (a->tile <= 0) return (int)cudaErrorInvalidValue;
        const int smem = (a->n0 + a->tile) * 4;
        cudaError_t e = cudaFuncSetAttribute(export_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        export_kernel<<<dim3((a->n0 + a->tile - 1) / a->tile, a->b), NT, smem, s>>>(*a);
    } else if (a->mode == 2) {
        preview_kernel<<<dim3((a->n0 + NT - 1) / NT, a->b), NT, 0, s>>>(*a);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int crt_rng_args_bytes() { return (int)sizeof(RngArgs); }
