// Persistence IIR for Hopper (sm_90a): stage 15, the temporal blend of a
// batch with the uint8 cast fused into the store.
//
// Replaces: pythoncrt_tpu/kernels/persist.py, persistence_scan /
// _persist_kernel (and persistence_scan_nhwc, which wraps it): the Pallas
// TPU kernel in which one program owns an (8, 128) tile and walks all B
// frames with the carry in registers; and its multi-clip mode
// _persist_kernel_mc (clip_states), chosen inside the same pallas_call,
// which resets the carry at each clip boundary of a flat batch.
//
// What bounds it on the card: bytes. Per 1080p frame it reads 24.9 MB of
// f32 and writes 6.2 MB of uint8; each carried state (24.9 MB) is read and
// written once per batch. Three flops per value.
//
// Design: each thread owns four contiguous values (16-byte loads and a
// 4-byte store when the operands are aligned, scalar accesses otherwise)
// and walks all B frames, the carry in registers: the carry never touches
// device memory between frames and the whole batch is one launch. Frame t
// is s_t = clip(p * s_{t-1} + (1 - p) * x_t, 0, 1); the first frame of a
// stream passes through unblended (crt_filter.py:1094-1095). The batch is
// C clips of cl = B / C frames, laid out flat and clip-major (C = 1: one
// stream): at t % cl == 0 the carry restarts from states[t / cl] (or from
// the frame itself when `first`) and the finished clip's carry goes to
// new_states[t / cl - 1]. The per-step expression and operand order are
// _persist_kernel's, and the file builds with -fmad=false, so the result
// is bitwise the sequential per-clip scan's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct PersistArgs {
    const float* imgs;   // (B, N) f32 in [0, 1], C clips of cl frames, clip-major
    const float* state;  // (C, N) carried state of each clip
    void* out;           // (B, N) uint8 or f32
    float* new_state;    // (C, N)
    int64_t n;
    int32_t b;
    int32_t first;       // 1: each clip's frame 0 passes through unblended
    float pp, om;        // p and 1 - p, rounded to f32 on the host
    int32_t emit_u8;
    int32_t vec;         // every operand 16-byte aligned (4-byte for a uint8 out), n % 4 == 0
    int32_t cl;          // frames per clip: B for one stream
};

namespace {

__device__ __forceinline__ float blend(float pp, float om, float s, float x) {
    return fminf(fmaxf(pp * s + om * x, 0.0f), 1.0f);
}

__device__ __forceinline__ uint8_t to_u8(float s) {
    return (uint8_t)fminf(fmaxf(rintf(s * 255.0f), 0.0f), 255.0f);
}

template <bool VEC>
__device__ __forceinline__ void store_state(float* dst, const float* s, int cnt) {
    if (VEC) {
        *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
    } else {
        for (int j = 0; j < cnt; ++j) dst[j] = s[j];
    }
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
persist_kernel(const PersistArgs a) {
    const int64_t i0 = ((int64_t)blockIdx.x * NT + threadIdx.x) * 4;
    if (i0 >= a.n) return;
    const int cnt = (int)min((int64_t)4, a.n - i0);
    float s[4], x[4];
    for (int t = 0; t < a.b; ++t) {
        const float* src = a.imgs + (size_t)t * a.n + i0;
        if (VEC) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
        } else {
            for (int j = 0; j < cnt; ++j) x[j] = src[j];
        }
        if (t % a.cl == 0) {  // a clip starts: restart the carry from its state
            const int c = t / a.cl;
            if (c > 0) store_state<VEC>(a.new_state + (size_t)(c - 1) * a.n + i0, s, cnt);
            const float* st = a.state + (size_t)c * a.n + i0;
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j >= cnt) break;
                s[j] = a.first ? x[j] : blend(a.pp, a.om, st[j], x[j]);
            }
        } else {
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j >= cnt) break;
                s[j] = blend(a.pp, a.om, s[j], x[j]);
            }
        }
        const size_t o = (size_t)t * a.n + i0;
        if (a.emit_u8) {
            uint8_t* out = static_cast<uint8_t*>(a.out) + o;
            if (VEC) {
                *reinterpret_cast<uchar4*>(out) =
                    make_uchar4(to_u8(s[0]), to_u8(s[1]), to_u8(s[2]), to_u8(s[3]));
            } else {
                for (int j = 0; j < cnt; ++j) out[j] = to_u8(s[j]);
            }
        } else {
            float* out = static_cast<float*>(a.out) + o;
            if (VEC) {
                *reinterpret_cast<float4*>(out) = make_float4(s[0], s[1], s[2], s[3]);
            } else {
                for (int j = 0; j < cnt; ++j) out[j] = s[j];
            }
        }
    }
    store_state<VEC>(a.new_state + (size_t)(a.b / a.cl - 1) * a.n + i0, s, cnt);
}

}  // namespace

extern "C" int crt_persist_launch(const PersistArgs* a, void* stream) {
    if (a->b < 1 || a->n < 1 || a->cl < 1 || a->b % a->cl != 0)
        return (int)cudaErrorInvalidValue;
    const int64_t threads = (a->n + 3) / 4;
    const unsigned grid = (unsigned)((threads + NT - 1) / NT);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a->vec)
        persist_kernel<true><<<grid, NT, 0, s>>>(*a);
    else
        persist_kernel<false><<<grid, NT, 0, s>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_persist_args_bytes() { return (int)sizeof(PersistArgs); }
