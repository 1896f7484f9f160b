// Glitch row shear for Hopper (sm_90a): stage 14, a modulo-wrapped
// horizontal shift of each row of the bottom band by a per-(row, segment)
// integer offset.
//
// Replaces: pythoncrt_tpu/kernels/glitch.py, shear_planar and
// shear_planar_inplace (_glitch_kernel, _glitch_kernel_window,
// _glitch_kernel_dual), the Pallas TPU kernels that express the gather as
// one-hot bf16 hi/lo MXU matmuls (about 2^-17 off). Their bounded window,
// dual branch and clamp ladder exist for the MXU and have no counterpart.
//
// What bounds it on the card: bytes. At 1080p with the bottom 30% sheared
// it reads and writes the 324-row band once, 7.5 MB each way per frame,
// plus the small offset table.
//
//   out[b, c, y0 + r, x] = in[b, c, y0 + r, (x + off[b, r, seg[x]]) mod W]
//
// seg is the static segment index of each column (x / seg_len for the
// export glitch, 0 for the preview glitch's one offset per row).
//
// Design: a block owns one (band row, plane) pair of one frame (grid:
// band rows x 3 planes x frames), blockDim.x threads along the row. It
// reads the row whole into shared memory, waits for the whole block, then
// writes it; no other block touches that row, so the same kernel runs in
// place on full frames (the engine's entry) and out of place on a band.
// Beside the row the block reduces the row's offsets into [0, W) once per
// segment, so an output column is x + o[seg[x]] less W at most once: no
// division per value. Where W % 4 == 0 and the buffers and seg are 16-byte
// aligned (the wrapper checks, kernels/glitch.py glitch_plan), a thread
// moves four columns at a time: a 16-byte cp.async into shared memory
// (every turn's copies issued before the one wait; it measured 2-4% faster
// than ld.global.v4 at 1080p), then four shared reads gathered into one
// 16-byte store; other rows take the scalar loops. The launch plan
// (threads along the row, 16-byte or scalar, shared memory) is chosen on
// the host. A pure copy: the result is the oracle's apply_glitch_gather
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct GlitchArgs {
    const float* src;    // (B, 3, HS, W)
    float* dst;          // (B, 3, HS, W); == src for the in-place entry
    const int32_t* off;  // (B, rows, nseg) integer offsets, rint per segment
    const int32_t* seg;  // (W,) segment of each column, in [0, nseg)
    int32_t b, hs, w;    // frames, rows of the buffers, width
    int32_t y0, rows;    // the band: rows [y0, y0 + rows) of the buffers
    int32_t nseg;
    int32_t tx;          // threads along the row
    int32_t vec;         // 1: 16-byte copies (cp.async in, one store per four columns)
    int32_t smem;        // dynamic shared memory per block, bytes
    int32_t raise_smem;  // 1: lift the kernel's shared memory limit first (past 48 KB)
};

namespace {

__device__ __forceinline__ int wrap(int sx, int w) { return sx >= w ? sx - w : sx; }

__global__ void __launch_bounds__(1024)
glitch_kernel(const GlitchArgs a) {
    extern __shared__ float4 smem4[];
    const int w = a.w, nseg = a.nseg, t = threadIdx.x, nt = blockDim.x;
    const int r = blockIdx.x;  // band row
    float* row = reinterpret_cast<float*>(smem4);
    int* o = reinterpret_cast<int*>(smem4) + ((w + 3) & ~3);
    const size_t base = (((size_t)blockIdx.z * 3 + blockIdx.y) * a.hs + a.y0 + r) * (size_t)w;
    const int32_t* off = a.off + ((size_t)blockIdx.z * a.rows + r) * nseg;
    for (int s = t; s < nseg; s += nt) {  // once per segment
        const int m = off[s] % w;
        o[s] = m < 0 ? m + w : m;
    }
    if (a.vec) {  // every turn's copy in flight at once, through no register
        const float* src = a.src + base;
        for (int q = t; q < (w >> 2); q += nt) {
            const unsigned dst = (unsigned)__cvta_generic_to_shared(row + (q << 2));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(dst), "l"(src + (q << 2)) : "memory");
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
        for (int x = t; x < w; x += nt) row[x] = a.src[base + x];
    }
    __syncthreads();
    if (a.vec) {
        const int4* seg4 = reinterpret_cast<const int4*>(a.seg);
        float4* dst = reinterpret_cast<float4*>(a.dst + base);
        for (int q = t; q < (w >> 2); q += nt) {
            const int4 g = __ldg(seg4 + q);
            const int x = q << 2;
            float4 v;
            v.x = row[wrap(x + o[g.x], w)];
            v.y = row[wrap(x + 1 + o[g.y], w)];
            v.z = row[wrap(x + 2 + o[g.z], w)];
            v.w = row[wrap(x + 3 + o[g.w], w)];
            dst[q] = v;
        }
    } else {
        for (int x = t; x < w; x += nt)
            a.dst[base + x] = row[wrap(x + o[__ldg(a.seg + x)], w)];
    }
}

}  // namespace

extern "C" int crt_glitch_launch(const GlitchArgs* a, void* stream) {
    if (a->rows < 1 || a->b < 1 || a->b > 65535 || a->nseg < 1 || a->w < 1 || a->y0 < 0
            || a->y0 + a->rows > a->hs || a->tx < 1 || a->tx > 1024 || (a->vec && a->w % 4 != 0))
        return (int)cudaErrorInvalidValue;
    if (a->raise_smem) {  // once per device, from the wrapper's first launch past 48 KB
        int dev = 0, most = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(glitch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     most);
        if (e != cudaSuccess) return (int)e;
    }
    glitch_kernel<<<dim3(a->rows, 3, a->b), a->tx, a->smem,
                     static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_glitch_args_bytes() { return (int)sizeof(GlitchArgs); }
