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
// Design: one block per (band row, frame). The block loads the row's three
// planes into shared memory (3 x 1920 x 4 B = 23 KB at 1080p), waits for
// the whole block, then writes the row. A block reads its row whole before
// it writes it, and no other block touches that row, so the same kernel
// runs in place on full frames (the engine's entry) and out of place on a
// band. A pure copy: the result is the oracle's apply_glitch_gather bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct GlitchArgs {
    const float* src;    // (B, 3, HS, W)
    float* dst;          // (B, 3, HS, W); == src for the in-place entry
    const int32_t* off;  // (B, rows, nseg) integer offsets, rint per segment
    const int32_t* seg;  // (W,) segment of each column, in [0, nseg)
    int32_t b, hs, w;    // frames, rows of the buffers, width
    int32_t y0, rows;    // the band: rows [y0, y0 + rows) of the buffers
    int32_t nseg;
};

namespace {

__global__ void __launch_bounds__(NT)
glitch_kernel(const GlitchArgs a) {
    extern __shared__ float row[];   // [3][W]
    const int r = blockIdx.x, bi = blockIdx.y;
    const int w = a.w;
    const size_t plane = (size_t)a.hs * w;
    const size_t base = (size_t)bi * 3 * plane + (size_t)(a.y0 + r) * w;
    for (int i = threadIdx.x; i < 3 * w; i += NT) {
        const int p = i / w, x = i - p * w;
        row[i] = a.src[base + p * plane + x];
    }
    __syncthreads();
    const int32_t* off = a.off + ((size_t)bi * a.rows + r) * a.nseg;
    for (int x = threadIdx.x; x < w; x += NT) {
        int sx = (x + off[a.seg[x]]) % w;
        if (sx < 0) sx += w;
        #pragma unroll
        for (int p = 0; p < 3; ++p) a.dst[base + p * plane + x] = row[p * w + sx];
    }
}

}  // namespace

extern "C" int crt_glitch_launch(const GlitchArgs* a, void* stream) {
    if (a->rows < 1 || a->b < 1 || a->nseg < 1 || a->y0 < 0 || a->y0 + a->rows > a->hs)
        return (int)cudaErrorInvalidValue;
    const int smem = (int)sizeof(float) * 3 * a->w;
    cudaError_t e = cudaFuncSetAttribute(
        glitch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a->rows, a->b);
    glitch_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_glitch_args_bytes() { return (int)sizeof(GlitchArgs); }
