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
// Transforms: normals by Box-Muller from two 32-bit words, defined in FP64
// and rounded once to f32 (u1 = (a + 1) 2^-32 in (0, 1], u2 = b 2^-32;
// r = sqrt(-2 log u1), z0 = r cos(2 pi u2), z1 = r sin(2 pi u2)), so that
// this kernel and its plain twin (kernels/rng.py, torch's FP64 log, sqrt,
// cos and sin) give the same bits; uniforms (x >> 8) 2^-24, exact in f32.
// The kernel computes the normals by csrc/box_muller.cuh: a table-driven
// fast path (the radius from a 128-entry log table and a degree-7
// polynomial, the angle reduced exactly in integers to a 128-entry
// sin/cos table and short polynomials), a rounding test against the
// fast factors' measured deviation bounds, and the FP64 expression itself
// for the pairs the test cannot decide (about 4.5e-6 of them), so that
// every value is the FP64 expression's. The file builds with -fmad=false
// like the others: every f32 multiply and add of the glitch offsets is
// rounded on its own, as the twin's torch ops are; the fast path's FMAs
// are explicit.
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
// Work and bound: per Philox call, ten rounds of two 32x32-bit multiplies
// (high and low words) and two three-input XORs with the round keys read
// from the launch arguments; per pair of normals, the fast path's FP64
// instructions (about 35, against about 77 for libdevice's log, sqrt, cos
// and sin, each with its own range reduction) and 64-bit conversions.
// chip_smoke.py counts both from the SASS of probes built with these
// flags. The grain writes 4 bytes per normal, but the counted instructions
// bind it: its FP64 and conversion work and Philox's integer work do not
// overlap much (PERF.md).
//
// Design. Grain: each thread draws GRAIN_GROUPS groups of its frame with a
// grid stride, the stores 16 bytes where the row allows; the transform's
// tables (20 KB) are read through L1 (measured as fast as copying them
// into shared memory per block, without the copy). Export: one thread
// block cluster of EXPORT_CL blocks per frame. Block 0 draws the walk's
// normals once for the frame (all its threads) and its first thread sums
// them down the rows, strictly in order, WALK_RUN rows at a time with the
// next run's loads in flight, writing the base over the normals in its
// shared memory; meanwhile every other thread draws its first EXPORT_HELD
// groups of the frame's segments into registers. After the cluster
// barrier the blocks read the base from block 0's shared memory, store
// those groups and draw the rest; a last barrier keeps block 0's shared
// memory alive until all have read it. Row and segment follow each thread
// in 32-bit counters (no division per element). Preview: one thread per
// row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "box_muller.cuh"

namespace cg = cooperative_groups;

// Mirrored field for field by a ctypes.Structure in kernels/rng.py.
struct RngArgs {
    void* out;              // mode 0: (B, n0, n1) f32; 1: (B, n0, n1) int32; 2: (B, n0) int32
    const int64_t* frames;  // (B,) absolute frame indices
    const float* amp;       // (n0,) glitch amplitude per band row (modes 1, 2)
    int32_t mode;
    int32_t b, n0, n1;      // mode 0: gh, gw; 1: rows, NSEG; 2: rows, 1
    uint32_t stream;        // the stream tag
    uint32_t keys[10][2];   // Philox's round keys: the seed mod 2^64 (low, high word), bumped
};

namespace {

constexpr int NT = 256;
constexpr int GRAIN_GROUPS = 4;  // grain: groups per thread (the grid stride's steps)
constexpr int EXPORT_CL = 8;     // export: blocks per frame, one cluster
constexpr int EXPORT_HELD = 2;   // export: groups a thread draws before the base is ready
constexpr int WALK_RUN = 8;      // export: rows of the walk's serial sum loaded at a time (two float4)
constexpr int SMEM_MAX = 232448;             // bytes of shared memory a block may use
constexpr int LIM_ROWS = SMEM_MAX / 8;       // export: padded bands whose clip limits fit beside the walk
constexpr uint32_t WALK_PART = 0x80000000u;  // export: the walk's groups
constexpr int SMEM_DEFAULT = 48 * 1024;      // dynamic shared memory without the attribute

struct Words {
    uint32_t x, y, z, w;
};

// Philox4x32-10 with the round keys from the launch arguments (read by
// the XORs from the parameter bank: no key schedule per call).
__device__ __forceinline__ Words draw(const RngArgs& a, uint32_t group, uint64_t f) {
    uint32_t c0 = group, c1 = a.stream, c2 = (uint32_t)f, c3 = (uint32_t)(f >> 32);
    #pragma unroll
    for (int i = 0; i < 10; ++i) {
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ a.keys[i][0];
        c1 = lo1;
        c2 = hi0 ^ c3 ^ a.keys[i][1];
        c3 = lo0;
    }
    return Words{c0, c1, c2, c3};
}

__device__ __forceinline__ void normals4(const double2* ang, const double2* lg, const Words& r,
                                         float z[4]) {
    bm::box_muller(ang, lg, r.x, r.y, z[0], z[1]);
    bm::box_muller(ang, lg, r.z, r.w, z[2], z[3]);
}

__device__ __forceinline__ float uniform24(uint32_t x) {
    return (float)(x >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

__global__ void __launch_bounds__(NT) grain_kernel(const __grid_constant__ RngArgs a) {
    const int bi = blockIdx.y;
    const uint64_t f = (uint64_t)__ldg(a.frames + bi);
    const uint64_t n = (uint64_t)a.n0 * a.n1;
    const uint32_t groups = (uint32_t)((n + 3) / 4);  // below 2^32 (the wrapper checks)
    float* out = static_cast<float*>(a.out) + bi * n;
    for (uint32_t g = blockIdx.x * NT + threadIdx.x; g < groups; g += gridDim.x * NT) {
        float z[4];
        normals4(bm::kAngle, bm::kLog, draw(a, g, f), z);
        float* o = out + 4 * (uint64_t)g;
        if (n % 4 == 0) {
            *reinterpret_cast<float4*>(o) = make_float4(z[0], z[1], z[2], z[3]);
        } else {
            #pragma unroll
            for (int v = 0; v < 4; ++v)
                if (4 * (uint64_t)g + v < n) o[v] = z[v];
        }
    }
}

// The four elements of group g: (row, segment) of its first element in
// r, c; stores rint(base + seg) of each element inside the band.
__device__ __forceinline__ void emit(const RngArgs& a, int32_t* out, const float* base, uint64_t e,
                                     int r, int c, const float z[4]) {
    const int rows = a.n0, nseg = a.n1;
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
        if (r < rows) {
            const float seg = z[v] * (__ldg(a.amp + r) * 0.7f);
            out[e + v] = __float2int_rn(base[r] + seg);
        }
        if (++c == nseg) {
            c = 0;
            ++r;
        }
    }
}

// One frame per cluster of EXPORT_CL blocks. Dynamic shared memory: the
// walk's normals of the frame's rows, then their base (block 0's is
// used), then each row's clip limit 0.4 amp where the band, padded to
// whole runs, has at most LIM_ROWS rows (taller bands read the amplitudes
// as they go).
__global__ void __cluster_dims__(EXPORT_CL, 1, 1) __launch_bounds__(NT)
export_kernel(const __grid_constant__ RngArgs a) {
    extern __shared__ float walk[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
    const int bi = blockIdx.y, rows = a.n0, nseg = a.n1;
    const uint64_t f = (uint64_t)__ldg(a.frames + bi);
    if (rank == 0) {
        // rows padded to whole runs: zero normals and limits past the band
        const int padded = (rows + WALK_RUN - 1) / WALK_RUN * WALK_RUN;
        const bool lim_smem = padded <= LIM_ROWS;
        float* lim = walk + padded;
        for (int r = tid; r < padded; r += NT) {
            if (lim_smem) lim[r] = r < rows ? __ldg(a.amp + r) * 0.4f : 0.0f;
            if (r >= rows) walk[r] = 0.0f;
        }
        for (int q = tid; 4 * q < rows; q += NT) {
            float z[4];
            normals4(bm::kAngle, bm::kLog, draw(a, WALK_PART | (uint32_t)q, f), z);
            #pragma unroll
            for (int v = 0; v < 4; ++v)
                if (4 * q + v < rows) walk[4 * q + v] = z[v];
        }
        __syncthreads();
        if (tid == 0 && lim_smem) {
            // the serial sum, row by row in order, WALK_RUN rows at a time:
            // the next run's normals and limits are loaded while this run's
            // adds wait on one another
            float s = 0.0f;
            float4 w0 = *reinterpret_cast<const float4*>(walk);
            float4 w1 = *reinterpret_cast<const float4*>(walk + 4);
            float4 l0 = *reinterpret_cast<const float4*>(lim);
            float4 l1 = *reinterpret_cast<const float4*>(lim + 4);
            for (int r0 = 0; r0 < padded; r0 += WALK_RUN) {
                float w[WALK_RUN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
                const float l[WALK_RUN] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
                if (r0 + WALK_RUN < padded) {
                    w0 = *reinterpret_cast<const float4*>(walk + r0 + WALK_RUN);
                    w1 = *reinterpret_cast<const float4*>(walk + r0 + WALK_RUN + 4);
                    l0 = *reinterpret_cast<const float4*>(lim + r0 + WALK_RUN);
                    l1 = *reinterpret_cast<const float4*>(lim + r0 + WALK_RUN + 4);
                }
                #pragma unroll
                for (int k = 0; k < WALK_RUN; ++k) {
                    s = s + w[k];
                    w[k] = fminf(fmaxf(s * 0.1f, -l[k]), l[k]);
                }
                *reinterpret_cast<float4*>(walk + r0) = make_float4(w[0], w[1], w[2], w[3]);
                *reinterpret_cast<float4*>(walk + r0 + 4) = make_float4(w[4], w[5], w[6], w[7]);
            }
        } else if (tid == 0) {  // a band too tall for its limits in shared memory
            float s = 0.0f;
            for (int r = 0; r < rows; ++r) {
                s = s + walk[r];
                const float l = __ldg(a.amp + r) * 0.4f;
                walk[r] = fminf(fmaxf(s * 0.1f, -l), l);
            }
        }
    }
    // the frame's segment groups, split evenly over the cluster's blocks;
    // each thread follows its group's (row, segment) in 32-bit counters
    const uint64_t n = (uint64_t)rows * nseg;
    const uint32_t groups = (uint32_t)((n + 3) / 4);
    const uint32_t g0 = (uint32_t)((uint64_t)groups * rank / EXPORT_CL);
    const uint32_t g1 = (uint32_t)((uint64_t)groups * (rank + 1) / EXPORT_CL);
    const uint64_t e0 = 4 * (uint64_t)(g0 + tid);
    int r = (int)(e0 / nseg), c = (int)(e0 % nseg);
    const int dr = 4 * NT / nseg, dc = 4 * NT % nseg;  // one stride of NT groups
    int32_t* out = static_cast<int32_t*>(a.out) + (uint64_t)bi * n;
    const bool held = !(rank == 0 && tid < 32);  // warp 0 of block 0 sums the walk
    float z[EXPORT_HELD][4];
    #pragma unroll
    for (int h = 0; h < EXPORT_HELD; ++h) {
        const uint32_t g = g0 + tid + h * NT;
        if (held && g < g1) normals4(bm::kAngle, bm::kLog, draw(a, g, f), z[h]);
    }
    cluster.sync();
    const float* base = cluster.map_shared_rank(walk, 0);
    #pragma unroll
    for (int h = 0; h < EXPORT_HELD; ++h) {
        const uint32_t g = g0 + tid + h * NT;
        if (g < g1) {
            if (!held) normals4(bm::kAngle, bm::kLog, draw(a, g, f), z[h]);
            emit(a, out, base, 4 * (uint64_t)g, r, c, z[h]);
        }
        r += dr;
        c += dc;
        if (c >= nseg) {
            c -= nseg;
            ++r;
        }
    }
    for (uint32_t g = g0 + tid + EXPORT_HELD * NT; g < g1; g += NT) {
        float zz[4];
        normals4(bm::kAngle, bm::kLog, draw(a, g, f), zz);
        emit(a, out, base, 4 * (uint64_t)g, r, c, zz);
        r += dr;
        c += dc;
        if (c >= nseg) {
            c -= nseg;
            ++r;
        }
    }
    cluster.sync();  // block 0's shared memory outlives the other blocks' reads
}

__global__ void __launch_bounds__(NT) preview_kernel(const __grid_constant__ RngArgs a) {
    const int bi = blockIdx.y, r = blockIdx.x * NT + threadIdx.x;
    if (r >= a.n0) return;
    const Words w = draw(a, (uint32_t)r, (uint64_t)__ldg(a.frames + bi));
    float z, unused;
    bm::box_muller(bm::kAngle, bm::kLog, w.x, w.y, z, unused);
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
        const long long per = (long long)NT * GRAIN_GROUPS;
        grain_kernel<<<dim3((unsigned)((groups + per - 1) / per), a->b), NT, 0, s>>>(*a);
    } else if (a->mode == 1) {
        // the attribute once per size above the default, per device
        static int granted[64] = {0};
        const int padded = (a->n0 + WALK_RUN - 1) / WALK_RUN * WALK_RUN;
        const int smem = padded * (padded <= LIM_ROWS ? 8 : 4);  // the walk, the clip limits
        if (smem > SMEM_DEFAULT) {
            int dev = 0;
            cudaError_t e = cudaGetDevice(&dev);
            if (e != cudaSuccess) return (int)e;
            if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
            if (smem > granted[dev]) {
                e = cudaFuncSetAttribute(export_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
                if (e != cudaSuccess) return (int)e;
                granted[dev] = smem;
            }
        }
        export_kernel<<<dim3(EXPORT_CL, a->b), NT, smem, s>>>(*a);
    } else if (a->mode == 2) {
        preview_kernel<<<dim3((a->n0 + NT - 1) / NT, a->b), NT, 0, s>>>(*a);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int crt_rng_args_bytes() { return (int)sizeof(RngArgs); }
