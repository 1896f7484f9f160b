// The native draws' Box-Muller fast path (box_muller.cuh) swept on the
// card against the FP64 expression it stands for: a check, not a step of
// any path. kernels/rng.py wraps it (sweep); chip_smoke.py [3] sweeps all
// 2^32 u and all 2^32 v with it, tests/test_torch_cuda.py edge words.
//
// Modes (RngSweepArgs.mode), over the words start + i, i < n (mod 2^32):
// 0 radius: the fast radius of u against sqrt(-2 log((u + 1) 2^-32)); the
//   largest relative deviation, and the words where it reaches RAD_REL
//   (u = 2^32 - 1, which the fast path leaves to the fallback, is counted
//   apart).
// 1 angle: the fast cos and sin of v against cos and sin of TWO_PI (v
//   2^-32); the largest absolute deviation of each, and the words where
//   either reaches ANG_ABS.
// 2 pairs: the Philox words of groups start + i (stream, key and frame 0
//   from the arguments; two pairs a group, as the grain draws them): the
//   pairs the rounding test leaves to the fallback, and the accepted
//   pairs whose f32 differ from the FP64 expression's.
// A word over its bound means the rounding test's premise fails there.
// Counts are reduced per warp, then one atomic per warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_muller.cuh"

// Mirrored field for field by a ctypes.Structure in kernels/rng.py.
struct RngSweepArgs {
    unsigned long long* counts;  // over bound, fallbacks, first over, max dev 0 and 1 (double bits)
    long long n;
    uint32_t start;
    int32_t mode;                // 0 radius, 1 angle, 2 pairs
    uint32_t key0, key1, stream;
};

namespace {

constexpr int NT = 256;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// Philox4x32-10 as csrc/rng.cu's draw makes it (frame 0).
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
    uint32_t c2 = 0, c3 = 0;
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
    return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ unsigned long long dbits(double d) {
    return (unsigned long long)__double_as_longlong(d);  // ordered as d for d >= 0
}

__device__ __forceinline__ void pair(const bm::Tabs& t, uint32_t u, uint32_t v,
                                     unsigned long long& over, unsigned long long& fb) {
    float f0, f1;
    const bool ok = bm::fast_pair(t.ang, t.lg, u, v, f0, f1);
    const float2 e = bm::box_muller_fp64(u, v);
    if (!ok) {
        ++fb;
    } else if (__float_as_uint(f0) != __float_as_uint(e.x) ||
               __float_as_uint(f1) != __float_as_uint(e.y)) {
        ++over;
    }
}

__global__ void __launch_bounds__(NT) rng_sweep_kernel(const __grid_constant__ RngSweepArgs a) {
    __shared__ bm::Tabs tabs;
    bm::load_tabs(tabs);
    __syncthreads();
    unsigned long long over = 0, fb = 0, first = ~0ull, m0 = 0, m1 = 0;
    const long long stride = (long long)gridDim.x * NT;
    for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < a.n; i += stride) {
        const uint32_t w = a.start + (uint32_t)i;
        bool bad = false;
        if (a.mode == 0) {
            if (w == 0xFFFFFFFFu) {
                ++fb;
                continue;
            }
            const double rf = bm::radius_fast(tabs.lg, w);
            const double rp = sqrt(-2.0 * log(((double)w + 1.0) * bm::TWO_M32));
            const double d = fabs(rf - rp);
            bad = !(d < bm::RAD_REL * rp);  // exact: RN(|rf - rp|) < RAD_REL rp => |rf - rp| < it
            m0 = max(m0, dbits(d / rp));
        } else if (a.mode == 1) {
            const bm::CosSin cs = bm::angle_fast(tabs.ang, w);
            const double th = bm::TWO_PI * ((double)w * bm::TWO_M32);
            const double dc = fabs(cs.c - cos(th)), ds = fabs(cs.s - sin(th));
            bad = !(dc < bm::ANG_ABS && ds < bm::ANG_ABS);
            m0 = max(m0, dbits(dc));
            m1 = max(m1, dbits(ds));
        } else {
            const uint4 r = philox(w, a.stream, a.key0, a.key1);
            unsigned long long o = 0;
            pair(tabs, r.x, r.y, o, fb);
            pair(tabs, r.z, r.w, o, fb);
            over += o;
            bad = o != 0;
            if (bad) first = min(first, (unsigned long long)i);
            continue;
        }
        if (bad) {
            ++over;
            first = min(first, (unsigned long long)i);
        }
    }
    over = warp_sum(over);
    fb = warp_sum(fb);
    first = warp_min(first);
    m0 = warp_max(m0);
    m1 = warp_max(m1);
    if ((threadIdx.x & 31) == 0) {
        if (over) atomicAdd(a.counts, over);
        if (fb) atomicAdd(a.counts + 1, fb);
        if (first != ~0ull) atomicMin(a.counts + 2, first);
        if (m0) atomicMax(a.counts + 3, m0);
        if (m1) atomicMax(a.counts + 4, m1);
    }
}

}  // namespace

extern "C" int crt_rng_sweep_launch(const RngSweepArgs* a, void* stream) {
    if (a->n < 1 || a->n > (1ll << 32) || a->mode < 0 || a->mode > 2 || !a->counts)
        return (int)cudaErrorInvalidValue;
    const long long want = (a->n + NT - 1) / NT;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    rng_sweep_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_rng_sweep_args_bytes() { return (int)sizeof(RngSweepArgs); }
