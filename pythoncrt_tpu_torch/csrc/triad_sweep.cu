// The direct-pow triad's pow sites (triad_pow.cuh) swept over many inputs
// on the card, each against the FP64 expression it replaces: a check, not
// a step of any path. kernels/triad.py wraps it; chip_smoke.py [3] sweeps
// every f32 input of each site's domain with it, tests/test_torch_cuda.py
// seeded and crafted inputs.
//
// Per input x (the f32 with bits start + i, or xs[i]): the site's value as
// the fused kernel computes it (fast path, else the out-of-line FP64
// fallback), compared bit for bit with f32 of the FP64 expression; whether
// the fallback ran; whether the input had an exact answer (x = 0,
// underflow); where the rounding test decided, the relative distance from
// the fast value (c + cl) 2^e2 to the FP64 expression's double. Counts are
// reduced per warp, then one atomic per warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "triad_pow.cuh"

namespace {

constexpr int NT = 256;

}  // namespace

// Mirrored field for field by a ctypes.Structure in kernels/triad.py.
struct TriadSweepArgs {
    const float* xs;              // inputs, or null: the f32 with bits start + i
    float* out;                   // per input: the site's value, or null
    uint8_t* fell;                // per input: 1 where the FP64 fallback ran, or null
    unsigned long long* counts;   // mismatches, fallbacks, first mismatch, max distance
                                  // (double bits), exact answers
    long long n;
    uint32_t start;
    int32_t site;                 // 0 forward, 1 final log2, 2 final exp2
    float g;                      // the forward site's f32(triad_gamma)
};

namespace {

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

__global__ void __launch_bounds__(NT) triad_sweep_kernel(const __grid_constant__ TriadSweepArgs a) {
    __shared__ float tab[triad::TAB];
    for (int i = threadIdx.x; i < triad::TAB; i += NT) tab[i] = triad::kTab[i];
    __syncthreads();
    unsigned long long mism = 0, fb = 0, ex = 0, first = ~0ull, maxd = 0;
    const long long stride = (long long)gridDim.x * NT;
    for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < a.n; i += stride) {
        const float x = a.xs ? a.xs[i] : __uint_as_float(a.start + (uint32_t)i);
        triad::Fast f;
        double ref;
        if (a.site == 0) {
            f = triad::fwd_fast(tab, x, a.g);
            ref = exp2((double)a.g * log2((double)x));
        } else if (a.site == 1) {
            f = triad::log2_fast(tab, x);
            ref = log2((double)x);
        } else {
            f = triad::exp2_fast(tab, x);
            ref = exp2((double)x);
        }
        float v = f.v;
        if (!f.ok) {
            v = a.site == 0 ? triad::fwd_ref(x, a.g)
                            : (a.site == 1 ? triad::log2_ref(x) : triad::exp2_ref(x));
            ++fb;
        }
        ex += f.exact;
        if (__float_as_uint(v) != __float_as_uint((float)ref)) {
            ++mism;
            first = min(first, (unsigned long long)i);
        }
        if (f.ok && !f.exact) {
            const double fv = ldexp((double)f.c + (double)f.cl, f.e2);
            const double d = fv == ref ? 0.0 : fabs(fv - ref) / fabs(ref);
            maxd = max(maxd, (unsigned long long)__double_as_longlong(d));
        }
        if (a.out) a.out[i] = v;
        if (a.fell) a.fell[i] = f.ok ? 0 : 1;
    }
    mism = warp_sum(mism);
    fb = warp_sum(fb);
    ex = warp_sum(ex);
    first = warp_min(first);
    maxd = warp_max(maxd);
    if ((threadIdx.x & 31) == 0) {
        if (mism) atomicAdd(a.counts, mism);
        if (fb) atomicAdd(a.counts + 1, fb);
        if (first != ~0ull) atomicMin(a.counts + 2, first);
        if (maxd) atomicMax(a.counts + 3, maxd);
        if (ex) atomicAdd(a.counts + 4, ex);
    }
}

}  // namespace

extern "C" int crt_triad_sweep_launch(const TriadSweepArgs* a, void* stream) {
    if (a->n < 1 || a->site < 0 || a->site > 2 || !a->counts) return (int)cudaErrorInvalidValue;
    const long long want = (a->n + NT - 1) / NT;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    triad_sweep_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_triad_sweep_args_bytes() { return (int)sizeof(TriadSweepArgs); }
