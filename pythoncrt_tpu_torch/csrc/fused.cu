// Fused CRT pass for Hopper (sm_90a): stages 1-11 of the effect chain in
// one kernel over planar uint8 frames (or stages 6-11 over an f32 image).
//
// Replaces: pythoncrt_tpu/kernels/fused.py, fused_pipeline / _fused_kernel
// (the Pallas TPU row-stripe kernel), with its three bloom cores: the
// exact gaussian, the fast half-res down+up (the `fast` variant,
// fused.py:453-477, op for op with bloom3._bloom3_fast_kernel) and
// bloom off; and its two inputs: the uint8 frame (`pre`, stages 1-4 in
// the kernel) or the engine's pre-processed f32 image (`pre=False`,
// fused.py:325-326: text composited before the bloom), read as it is;
// and its two triads: the LUT-exact one and the direct-pow one of
// `lut_exact=False` (fused.py:601-631, `--precision fast`; triad_mode 3);
// and its two grain operands: the full-size field, or the raw (gh, gw)
// field upsampled in the kernel (GRAW: the grain branch, fused.py:640-667,
// for grain sizes above 1; see stage_grain and grain_staged); and, with
// the uint8 input, the text overlay composited before the bloom (TEXT,
// stage 5) in the prologue, over the box its alpha covers (see
// composite_run), in place of the f32 input of stages 1-5 done by torch
// ops: the box's alpha and colour are read from device memory, a crop of
// a few hundred KB to a few MB that stays in L2 across frames.
// The direct-pow triad's three pow sites per value are f32 double-float
// fast paths with a rounding test and an out-of-line FP64 fallback
// (triad_pow.cuh), bit for bit the FP64 expressions. Where the LUT-exact
// triad reads two tables, they issue about 190 instructions per value,
// which bound the direct-pow instantiations by operations (PERF.md).
//
// What bounds it on the card: on paper, bytes. A 1080p frame is 6.2 MB of
// uint8 in (24.9 MB of f32 in the f32-input mode), plus the 8.3 MB f32
// grain field when the noise stage is on (2.07 MB raw at grain size 2,
// with 24 KB of taps); the pass writes either 6.2 MB
// of uint8 (nothing downstream) or 24.9 MB of f32 (the warp, glitch or
// persistence kernel's feed). Measured on an H100 (PERF.md), it runs at
// 20-30% of that bound and a uint8 emit is no faster than an f32 one: the
// time goes to latency, the barriers between a chunk's phases and the
// chains of dependent shared-memory reads in the prologue and the
// epilogue's triad tables, with three (gaussian) or four (fast) blocks
// of 256 threads per SM. Per distinct source pixel the grade costs three
// FP64 pows (about a hundred FP64 instructions each).
//
// Design: one block owns a strip of SW output columns of one run of rows
// of one frame, all three planes (the saturation and triad luma need the
// three planes of a pixel together), and walks down the run. The host
// plans the walk (kernels/fused.py fused_plan): the strip width, the
// chunk and run sizes, the ring depths, each strip's staged column
// ranges, each run's schedule (which half-res and output rows each chunk
// completes) and each row's ring offsets; plan_chunks replays the walk
// (tests/test_torch_fused_plan.py). Per chunk of STEP distinct source
// rows:
// 1. The raw rows of the next chunk are staged into shared memory with
//    cp.async (16-byte copies where the row pitch and pointer allow it,
//    double-buffered, commit_group / wait_group) while this chunk
//    computes: the uint8 source rows named by the row map, per plane
//    the column window the strip's index maps read, as at most two
//    ranges (the aberration roll wraps at the frame's edges); or f32
//    rows in the f32-input mode. The window's offsets into the staged
//    row are computed once per block: the maps do not change down the
//    strip. The grain of each thread's first output of the next chunk is
//    loaded a chunk ahead. GRAW: the raw grain rows the next chunk's
//    output rows read, over the strip's raw column window, and their row
//    taps are staged a chunk ahead in a double buffer of their own; the
//    strip's column taps are staged once per block; the epilogue
//    upsamples from shared memory alone.
// 2. The prologue (/255, grade) runs once per distinct source pixel: a
//    row whose map entry equals the row above's is the same row (one
//    ring slot per distinct row), and a column whose three plane maps
//    equal the column to its left's reuses its values (the block's
//    leader list). Pixelate at size 2 thus pays a quarter of the FP64
//    pows. The knee runs once per value.
// 3. Gaussian core: the knee'd window rows are filtered horizontally,
//    once per distinct row, into a ring of rows; each output row is the
//    vertical tap sum over the ring, then the composite with the
//    pre-knee value and the epilogue. The radius of the CLI default
//    sigma 1.2 (r = 4) is a template with unrolled taps; other radii up
//    to 31 take a loop over the taps in the launch arguments. Strips
//    (rows) away from the frame's edges run the taps without bounds
//    tests. Larger radii (BIG) read the taps and border coefficients
//    from a device table, staged in shared memory once per block (the
//    plan narrows the strip as the rings grow; kernels/fused.py), and
//    block their tap loops in registers, since at 65 taps and more the
//    loads per tap, not the arithmetic, bound the one-tap-at-a-time
//    loops: an interior strip's horizontal taps slide a window of eight
//    knee'd columns through registers (one 16-byte load of the row and
//    one of four taps per four taps), and each thread sums BR inner
//    output rows of one plane at once, reading each ring row of their
//    union window once (vtaps_block); their composites wait in the
//    spent knee'd-row buffer for the epilogue, which needs a pixel's
//    three planes. Without multiply-add contraction each tap costs an
//    FMUL and an FADD: twice the issue slots the FMA rate counts.
//    Fast core: a ring of knee'd source rows and a ring of half-res rows;
//    each half-res row (down rows, then down columns) is computed once
//    per block as soon as its two source rows are in the ring; each
//    output row is up rows then up columns from the half-res ring, then
//    the composite and the epilogue. The oracle's bilinear_taps tables
//    drive it, so any H and W work.
// 4. The epilogue reads the triad tables and the strip's triad and
//    vignette rows from shared memory, and stores four values per thread
//    (float4 / uchar4) where W % 4 == 0.
// The vertical halo is paid once per run, the horizontal one per strip.
// Only the input, the grain field, the small per-row/per-column tables
// and the output cross device memory.
//
// Exactness: the triad quantizes to a 1024-bin grid, so every f32 op
// upstream of it keeps the reference's order. The file is compiled with
// -fmad=false (no multiply-add contraction); divisions are IEEE (nvcc's
// default -prec-div=true); the grade pow is computed in double and rounded
// once to float; the triad's two pow sites read 1025-entry tables the host
// builds with the same rounding, or (triad_mode 3) give the FP64
// expressions rounded once to float, as the twin computes them. The tap
// sums are sequential f32 multiply-adds in tap order, on purpose not on
// the tensor cores: a TF32 or bf16 product, or a reordered sum, moves
// values across the triad's quantize steps. Gaussian border taps follow
// the fold the JAX paths use: out-of-frame taps add nothing in tap order,
// then the clipped taps' summed coefficient times the edge sample is
// added (left, then right).

#include <cuda_runtime.h>
#include <stdint.h>

#include "crt_common.cuh"
#include "triad_pow.cuh"

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXK = 63;     // taps carried in the launch arguments (radius <= MAXR)
constexpr int MAXR = MAXK / 2;
constexpr int GAUSS = 0, FAST = 1;
constexpr int BIG = -2;      // gaussian radius above MAXR: taps from shared memory
constexpr int BR = 4;        // BIG: output rows a thread sums at once in the vertical pass
constexpr int LUTP = 1028;   // pitch of the two 1025-entry triad tables in shared memory

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct FusedArgs {
    const uint8_t* img;      // (B, 3, H, W) uint8 frames (pre_on), or null
    const float* imgf;       // (B, 3, H, W) f32 pre-processed image (!pre_on), or null
    void* out;               // (B, 3, H, W) float or uint8
    const int32_t* xmap;     // (3, W)  source column per plane
    const float* grain;      // (B, H, W) unscaled noise field, or null
    const float* sl;         // (B, H) scanline multiplier, or null
    const float* vy2;        // (H,) vignette ny^2
    const float* vx2;        // (W,) vignette nx^2
    const float* tri;        // (3, W) triad mask rows per plane
    const float* flicker;    // (B,)
    const float* lut_fwd;    // (1025,) pow(i/1024, g)
    const float* lut_fin;    // (1025,) exp2(log2(i/1024) / g)
    // fast bloom core: the oracle's bilinear_taps (lo, frac) per axis
    const int32_t* fd_ylo; const float* fd_yf;   // (H2,) down, rows
    const int32_t* fd_xlo; const float* fd_xf;   // (W2,) down, columns
    const int32_t* fu_ylo; const float* fu_yf;   // (H,)  up, rows
    const int32_t* fu_xlo; const float* fu_xf;   // (W,)  up, columns
    // the walk (kernels/fused.py fused_plan)
    const int32_t* ysrc;     // (ND,) source row of each distinct row
    const int32_t* segs;     // (strips, 3, 4) staged column ranges (a0, n0, a1, n1)
    const int32_t* runtab;   // (runs, run_stride): d_lo, d_hi, first half-res row,
                             // then (he, ye) per chunk: the walk's schedule
    const int32_t* rowtab;   // (H, 4 or 2r + 2) ring offsets of each output row's operands
    const int32_t* halftab;  // (H2, 4) fast core: ring offsets of each half-res row's rows
    const float* tapdev;     // radius above MAXR: (4r + 1,) taps, edge_l, edge_r; else null
    int32_t b, h, w;
    int32_t emit_u8;
    int32_t pre_on;          // 1: stages 1-4 from img; 0: read imgf as it is
    // prologue (stage 1 + 4)
    float inv255;
    int32_t sat_on; float sat;
    int32_t temp_on; float gain[3];          // per plane
    int32_t bc_on; float brightness, contrast;
    int32_t gamma_on; float inv_gamma;
    int32_t ir, ig, ib;                      // plane holding R, G, B
    // bloom (stage 6)
    int32_t bloom_on, r;
    int32_t knee_on; float thr, rden;
    float strength;
    float taps[MAXK];
    float edge_l[MAXK];  // edge_l[d]: summed taps clipped off the left/top at distance d
    float edge_r[MAXK];  // edge_r[d]: same for the right/bottom edge
    int32_t fast_on, h2, w2;
    // strip width, distinct rows per chunk, rows per run; ring depths;
    // window pitches; staged row pitch (elements); copy size (16, 4 or 1
    // bytes); 16-byte epilogue loads and stores; shared memory bytes
    int32_t sw, step, run;
    int32_t depth, hdepth;
    int32_t win, hwin;
    int32_t seg_pitch, copy_bytes;
    int32_t run_stride;
    int32_t vec_ok, smem;
    // epilogue (stages 7-11)
    int32_t triad_mode;  // 0 off, 1 multiply only, 2 LUT-exact, 3 direct pow (precision fast)
    int32_t luma_on;
    int32_t sl_on, vig_on; float vig_strength;
    int32_t flicker_on;
    int32_t noise_on; float noise_scale;
    // last, so that the other fields keep their offsets
    float tri_g, tri_e;  // triad_mode 3: f32(gamma), f32(1 / gamma)
    // GRAW: the raw grain's upsample, the oracle's bilinear_taps (lo,
    // frac) for the rows (H,) and the columns (W,) of a (B, gh, gw) field
    const int32_t* gylo; const float* gyf;
    const int32_t* gxlo; const float* gxf;
    int32_t grain_raw, gh, gw;
    // GRAW: the raw stage's size (kernels/fused.py fused_plan): raw rows a
    // chunk's outputs read at most, the staged row pitch (floats), output
    // rows a chunk completes at most; per run and chunk (first raw row, raw
    // rows, output rows), gstride ints a run
    int32_t gdepth, gpitch, grows;
    const int32_t* grawtab;
    int32_t gstride;
    // TEXT: the text overlay's box, columns [tx0, tx0 + tw) of the box rows
    // trow names: per distinct row its row of the box, or -1 outside it
    // (each output row of the box is a distinct row of the walk); the box's
    // alpha (th, tw) and colour (3, th, tw, plane order), u8 / 255 in f32
    const int32_t* trow;
    const float* talpha;
    const float* trgb;
    int32_t text_on, tx0, th, tw;
};

namespace {

using crt::clip01;
using crt::lerp_taps;

// The block's shared memory, carved in this order (kernels/fused.py
// plan_smem computes the same total).
struct Smem {
    unsigned char* stage;  // [2][step][3][seg_pitch] staged rows (uint8 or f32)
    float* kw;             // gaussian: [step][3][win] knee'd window rows of the chunk
    float* ring;           // gaussian: [depth][3][sw] filtered rows; fast: [depth][3][win] knee'd rows
    float* half;           // fast: [hdepth][3][hwin] half-res rows
    int* hx_lo; float* hx_f;  // fast: the down-column taps of the half-res window
    int* ux_lo; float* ux_f;  // fast: the up-column taps of the strip
    float* xr;             // [depth][3][sw] pre-knee strip (the composite's operand); the
                           // fast core without a knee reads it from the knee'd ring
    short* offs;           // [3][win] staged offset of each window column
    short* lead;           // [win + 1] first column of each run of equal map columns
    short* loffs;          // [3][win] the staged offset of each leader column
    float* lut;            // [2][LUTP] the triad's tables (triad_mode 2); DIRECT: the
                           // pow sites' [triad::TAB] (triad_pow.cuh)
    float* tri;            // [3][sw] the strip's triad rows
    float* vx;             // [sw] the strip's vignette nx^2
    int* misc;             // [12] this strip's staged ranges, [12] the leader count; GRAW:
                           // [13] the strip's first raw column, [14] its raw columns
    float* taps;           // radius above MAXR: [4r + 1] taps, edge_l, edge_r
    int* gx_lo; float* gx_f;  // GRAW: [sw] the strip's column taps, lo less the raw window's first
    float* graw;           // GRAW: [2][gdepth * gpitch + 2 * grows] a chunk's raw rows, then its
                           // rows' taps (gylo as int, gyf)
    int* gq;               // GRAW: [gstride] the run's (first raw row, raw rows, output rows)
                           // per chunk (grawtab)
    int total;
};

__host__ __device__ __forceinline__ int a16h(int n) { return (n + 15) & ~15; }

// GRAW: floats of one buffer of the raw stage.
__host__ __device__ __forceinline__ int graw_floats(const FusedArgs& a) {
    return a.gdepth * a.gpitch + 2 * a.grows;
}

// DIRECT: the direct-pow triad's layout, which holds the pow sites' table in
// place of the two LUTs; a template argument, so that the LUT-exact
// instantiations test nothing at run time.
template <bool DIRECT, bool GRAW>
__host__ __device__ inline Smem smem_layout(const FusedArgs& a, unsigned char* base) {
    Smem s;
    const bool fast = a.bloom_on && a.fast_on;
    const int r = (a.bloom_on && !a.fast_on) ? a.r : 0;
    int o = 0;
    s.stage = base + o; o += a16h(2 * a.step * 3 * a.seg_pitch * (a.pre_on ? 1 : 4));
    s.kw = s.ring = s.half = s.hx_f = s.ux_f = nullptr;
    s.hx_lo = s.ux_lo = nullptr;
    if (fast) {
        s.ring = (float*)(base + o); o += a16h(a.depth * 3 * a.win * 4);
        s.half = (float*)(base + o); o += a16h(a.hdepth * 3 * a.hwin * 4);
        s.hx_lo = (int*)(base + o);
        s.hx_f = (float*)(base + o + a.hwin * 4);
        s.ux_lo = (int*)(base + o + a.hwin * 8);
        s.ux_f = (float*)(base + o + a.hwin * 8 + a.sw * 4);
        o += a16h((a.hwin + a.sw) * 8);
    } else if (r > 0) {
        s.kw = (float*)(base + o); o += a16h(a.step * 3 * a.win * 4);
        s.ring = (float*)(base + o); o += a16h(a.depth * 3 * a.sw * 4);
    }
    s.xr = (float*)(base + o);
    if (!fast || a.knee_on) o += a16h(a.depth * 3 * a.sw * 4);
    s.offs = (short*)(base + o); o += a16h(3 * a.win * 2);
    s.lead = (short*)(base + o); o += a16h((a.win + 1) * 2);
    s.loffs = (short*)(base + o); o += a16h(3 * a.win * 2);
    const int luts = DIRECT ? triad::TAB : 2 * LUTP;
    s.lut = (float*)(base + o);
    s.tri = s.lut + luts;
    s.vx = s.tri + 3 * a.sw;
    o += a16h((luts + 4 * a.sw) * 4);
    s.misc = (int*)(base + o); o += 64;
    s.taps = nullptr;
    s.gx_lo = s.gq = nullptr; s.gx_f = s.graw = nullptr;
    if (!fast && r > MAXR) {
        s.taps = (float*)(base + o); o += a16h((4 * r + 1) * 4);
    }
    if constexpr (GRAW) {
        s.gx_lo = (int*)(base + o);
        s.gx_f = (float*)(base + o + a.sw * 4);
        o += a16h(a.sw * 8);
        s.graw = (float*)(base + o); o += a16h(2 * graw_floats(a) * 4);
        s.gq = (int*)(base + o); o += a16h(a.gstride * 4);
    }
    s.total = o;
    return s;
}

__device__ __forceinline__ float knee(const FusedArgs& a, float v) {
    return crt::knee(a.knee_on, a.thr, a.rden, v);
}

__device__ __forceinline__ int quantize(float v) {
    int i = (int)(clip01(v) * 1024.0f);   // truncation toward zero
    return min(max(i, 0), 1024);
}

__device__ __forceinline__ float luma(float r, float g, float b) {
    return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// x[i] for a plane index known only at run time, by selects: an indexed
// read of a register array would put the array in local memory.
__device__ __forceinline__ float pick(const float x[3], int i) {
    return i == 0 ? x[0] : (i == 1 ? x[1] : x[2]);
}

__device__ __forceinline__ float luma3(const FusedArgs& a, const float x[3]) {
    return luma(pick(x, a.ir), pick(x, a.ig), pick(x, a.ib));
}

// Stages 2-4 on one gathered pixel (x already * 1/255).
__device__ __forceinline__ void grade(const FusedArgs& a, float x[3]) {
    if (a.sat_on) {
        const float l = luma3(a, x);
        #pragma unroll
        for (int p = 0; p < 3; ++p) x[p] = clip01(l + (x[p] - l) * a.sat);
    }
    if (a.temp_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p) x[p] = clip01(x[p] * a.gain[p]);
    }
    if (a.bc_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            x[p] = clip01((x[p] - 0.5f) * a.contrast + 0.5f + a.brightness);
    }
    if (a.gamma_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            x[p] = clip01((float)pow((double)x[p], (double)a.inv_gamma));
    }
}

// The direct-pow triad (triad_mode 3) on one pixel: the JAX kernel's
// lut_exact=False branch (fused.py:601-631), the two pow sites on the
// clipped values, no quantize: the forward site f32(exp2(g * log2(x))) and
// the final f32(exp2(f32(log2(x)) * e)), each FP64 expression's rounding
// given by triad_pow.cuh (tab: its table in shared memory).
__device__ __forceinline__ void triad_direct(const FusedArgs& a, const float* tab, float m[3],
                                             const float tri[3]) {
    float x[3], lin[3], ol[3];
    #pragma unroll
    for (int p = 0; p < 3; ++p) x[p] = clip01(m[p]);
    triad::pow_fwd3(tab, x, a.tri_g, lin);
    #pragma unroll
    for (int p = 0; p < 3; ++p) ol[p] = lin[p] * tri[p];
    if (a.luma_on) {
        const float yb = luma3(a, lin);
        const float ya = luma3(a, ol);
        const float ratio = fminf(fmaxf(yb / fmaxf(ya, 1e-6f), 0.5f), 2.0f);
        #pragma unroll
        for (int p = 0; p < 3; ++p) ol[p] = ol[p] * ratio;
    }
    #pragma unroll
    for (int p = 0; p < 3; ++p) x[p] = clip01(ol[p]);
    triad::pow_final3(tab, x, a.tri_e, m);
    #pragma unroll
    for (int p = 0; p < 3; ++p) m[p] = clip01(m[p]);
}

// Stages 7-11 for one composited pixel, given its per-column operands.
// DIRECT: the instantiations of triad_mode 3, which hold no other triad.
template <bool DIRECT>
__device__ __forceinline__ void finish(const FusedArgs& a, const float* lut, float m[3],
                                       const float tri[3], float s, float vy2, float vx2, float f,
                                       float n) {
    if constexpr (DIRECT) {
        triad_direct(a, lut, m, tri);
    } else if (a.triad_mode == 1) {
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * tri[p]);
    } else if (a.triad_mode == 2) {
        float lin[3], ol[3];
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            lin[p] = lut[quantize(m[p])];
            ol[p] = lin[p] * tri[p];
        }
        if (a.luma_on) {
            const float yb = luma3(a, lin);
            const float ya = luma3(a, ol);
            const float ratio = fminf(fmaxf(yb / fmaxf(ya, 1e-6f), 0.5f), 2.0f);
            #pragma unroll
            for (int p = 0; p < 3; ++p) ol[p] = ol[p] * ratio;
        }
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(lut[LUTP + quantize(ol[p])]);
    }
    if (a.sl_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * s);
    }
    if (a.vig_on) {
        const float v = 1.0f - a.vig_strength * clip01(vy2 + vx2);
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * v);
    }
    if (a.flicker_on) {
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] * f);
    }
    if (a.noise_on) {
        const float nn = n * a.noise_scale;
        #pragma unroll
        for (int p = 0; p < 3; ++p) m[p] = clip01(m[p] + nn);
    }
}

// The grain of nv (1-4) adjacent pixels of row gy from gx: one 16-byte
// load when the epilogue is vectorized (0 when the noise stage is off).
__device__ __forceinline__ void load_grain(const FusedArgs& a, int bi, int gy, int gx, int nv,
                                           float gr[4]) {
    #pragma unroll
    for (int v = 0; v < 4; ++v) gr[v] = 0.0f;
    if (!a.noise_on) return;
    const float* g = a.grain + ((size_t)bi * a.h + gy) * a.w + gx;
    if (a.vec_ok && nv == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(g));
        gr[0] = t.x; gr[1] = t.y; gr[2] = t.z; gr[3] = t.w;
    } else {
        #pragma unroll
        for (int v = 0; v < 4; ++v) if (v < nv) gr[v] = __ldg(g + v);
    }
}

// GRAW: the grain of nv (1-4) adjacent pixels of the chunk's output row yy
// (its index among the chunk's rows) from strip column lx, upsampled from
// the raw stage gb, which holds raw rows g0 .. and the chunk's row taps
// (stage_grain): the oracle's bilinear upsample (ops/resize.py
// resize_bilinear: the two rows' lerp at each of the two columns, then the
// columns' lerp, each lo * (1 - f) + hi * f in f32, no contraction). The
// stage holds each tap's lo + 1 row and column, clamped to the field as
// the oracle clamps them, so that hi is lo + 1 there: one address per row
// and output. Shared memory only: the column taps are the strip's
// (S.gx_lo, S.gx_f, one 16-byte load each), the row's tap the chunk's.
__device__ __forceinline__ void grain_staged(const FusedArgs& a, const Smem& S, const float* gb,
                                             int g0, int yy, int lx, int nv, float gr[4]) {
    const float* gt = gb + a.gdepth * a.gpitch;
    const int ylo = reinterpret_cast<const int*>(gt)[yy];
    const float fy = gt[a.grows + yy];
    const float* r0 = gb + (ylo - g0) * a.gpitch;
    const float* r1 = r0 + a.gpitch;
    const int4 xl4 = *reinterpret_cast<const int4*>(S.gx_lo + lx);
    const float4 xf4 = *reinterpret_cast<const float4*>(S.gx_f + lx);
    const int xl[4] = {xl4.x, xl4.y, xl4.z, xl4.w};
    const float xf[4] = {xf4.x, xf4.y, xf4.z, xf4.w};
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
        gr[v] = 0.0f;
        if (v < nv) {  // the strip's columns past the frame hold no taps
            const float lo = lerp_taps(r0[xl[v]], r1[xl[v]], fy);
            const float hi = lerp_taps(r0[xl[v] + 1], r1[xl[v] + 1], fy);
            gr[v] = lerp_taps(lo, hi, xf[v]);
        }
    }
}

// The epilogue and the store of nv (1-4) adjacent pixels of row gy from
// gx (column lx of the strip), given their grain: one store per plane
// when vec. The triad tables and the strip's triad and vignette rows are
// read from shared memory, a column at a time.
template <bool DIRECT>
__device__ __forceinline__ void epilogue4(const FusedArgs& a, const Smem& S, int bi, int gy,
                                          int gx, int lx, int nv, float m[3][4],
                                          const float gr[4]) {
    const int h = a.h, w = a.w;
    const bool vec = a.vec_ok && nv == 4;
    const float s = a.sl_on ? __ldg(a.sl + (size_t)bi * h + gy) : 0.0f;
    const float vy = a.vig_on ? __ldg(a.vy2 + gy) : 0.0f;
    const float f = a.flicker_on ? __ldg(a.flicker + bi) : 0.0f;
    if constexpr (DIRECT) {
        // one pixel an iteration, the loop kept: the pow sites' code (some
        // five hundred instructions a pixel) appears once, not four times,
        // which measured faster on every configuration timed (PERF.md).
        // The pixels rotate through registers: each takes m[.][0] and
        // leaves its result at m[.][3], so that after four turns m[.][v] is
        // pixel v's.
        float g4[4] = {gr[0], gr[1], gr[2], gr[3]};
        #pragma unroll 1
        for (int v = 0; v < 4; ++v) {
            const int c = lx + min(v, nv - 1);  // columns past the frame are not stored
            float t3[3], px[3];
            #pragma unroll
            for (int p = 0; p < 3; ++p) {
                t3[p] = S.tri[p * a.sw + c];
                px[p] = m[p][0];
            }
            finish<DIRECT>(a, S.lut, px, t3, s, vy, S.vx[c], f, g4[0]);
            #pragma unroll
            for (int p = 0; p < 3; ++p) {
                m[p][0] = m[p][1];
                m[p][1] = m[p][2];
                m[p][2] = m[p][3];
                m[p][3] = px[p];
            }
            g4[0] = g4[1];
            g4[1] = g4[2];
            g4[2] = g4[3];
        }
    } else {
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int c = lx + min(v, nv - 1);  // columns past the frame are not stored
            float t3[3], px[3];
            #pragma unroll
            for (int p = 0; p < 3; ++p) {
                t3[p] = S.tri[p * a.sw + c];
                px[p] = m[p][v];
            }
            finish<DIRECT>(a, S.lut, px, t3, s, vy, S.vx[c], f, gr[v]);
            #pragma unroll
            for (int p = 0; p < 3; ++p) m[p][v] = px[p];
        }
    }
    const size_t plane = (size_t)h * w;
    const size_t o = (size_t)bi * 3 * plane + (size_t)gy * w + gx;
    #pragma unroll
    for (int p = 0; p < 3; ++p) {
        if (a.emit_u8) {
            uint8_t q[4];
            #pragma unroll
            for (int v = 0; v < 4; ++v)
                q[v] = (uint8_t)fminf(fmaxf(rintf(m[p][v] * 255.0f), 0.0f), 255.0f);
            uint8_t* dst = static_cast<uint8_t*>(a.out) + o + p * plane;
            if (vec) {
                *reinterpret_cast<uchar4*>(dst) = make_uchar4(q[0], q[1], q[2], q[3]);
            } else {
                #pragma unroll
                for (int v = 0; v < 4; ++v) if (v < nv) dst[v] = q[v];
            }
        } else {
            float* dst = static_cast<float*>(a.out) + o + p * plane;
            if (vec) {
                *reinterpret_cast<float4*>(dst) = make_float4(m[p][0], m[p][1], m[p][2], m[p][3]);
            } else {
                #pragma unroll
                for (int v = 0; v < 4; ++v) if (v < nv) dst[v] = m[p][v];
            }
        }
    }
}

// TEXT: the prologue's stores for the window columns [c, ce) of a leader
// run of distinct row k (ring slot `slot`), a row of the text box (its row
// ty of the box), whose graded value is x and knee'd value kx: per column,
// inside the box (columns tx0 .. tx0 + tw - 1), the composite
// clip(x * (1 - a) + rgb * a) of ops/color.composite_text, each step
// rounded as torch rounds it, then the knee; outside the box the composite
// is the identity (a = 0), and the run's values are stored as they are.
template <int CORE>
__device__ __forceinline__ void composite_run(const FusedArgs& a, const Smem& S, int k, int slot,
                                              int c, int ce, int ty, int win0, int cofs, int ksh,
                                              int r, bool xsep, int ncen, const float x[3],
                                              const float kx[3]) {
    const int sw = a.sw;
    for (int cc = c; cc < ce; ++cc) {
        float xc[3], kc[3];
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            xc[p] = x[p];
            kc[p] = kx[p];
        }
        const int tx = win0 + cc - a.tx0;
        if (tx >= 0 && tx < a.tw) {
            const size_t o = (size_t)ty * a.tw + tx;
            const float al = __ldg(a.talpha + o);
            const float om = __fsub_rn(1.0f, al);
            #pragma unroll
            for (int p = 0; p < 3; ++p) {
                const float rgb = __ldg(a.trgb + (size_t)p * a.th * a.tw + o);
                xc[p] = clip01(__fadd_rn(__fmul_rn(x[p], om), __fmul_rn(rgb, al)));
                kc[p] = knee(a, xc[p]);
            }
        }
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            if constexpr (CORE == GAUSS) {
                if (r > 0) S.kw[(k * 3 + p) * a.win + cc] = kc[p];
            } else {
                S.ring[(slot * 3 + p) * a.win + cc + ksh] = kc[p];
            }
            const int lc = cc - cofs;
            if (xsep && lc >= 0 && lc < ncen) S.xr[(slot * 3 + p) * sw + lc] = xc[p];
        }
    }
}

// n / d for 0 <= n, d < 2^16 by a 64-bit multiply-high, exact there: the
// phases' flat item indices split without a runtime division.
struct FastDiv {
    unsigned long long m;
    __device__ explicit FastDiv(int d) : m((0xffffffffull / (unsigned)d) + 1ull) {}
    __device__ int operator()(int n) const {
        return (int)(((unsigned long long)(unsigned)n * m) >> 32);
    }
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" :: "r"(d), "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Stage the raw rows of distinct rows [d, d + dn) of frame bi into buf:
// per row and plane the strip's one or two column ranges, back to back.
template <bool F32IN>
__device__ void stage_rows(const FusedArgs& a, unsigned char* buf, const int* seg, int bi,
                           int d, int dn) {
    constexpr int ES = F32IN ? 4 : 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cb = a.copy_bytes;
    const unsigned char* src0 = F32IN ? reinterpret_cast<const unsigned char*>(a.imgf) : a.img;
    for (int rp = warp; rp < dn * 3; rp += NWARP) {
        const int k = rp / 3, p = rp - 3 * k;
        const int sy = F32IN ? d + k : __ldg(a.ysrc + d + k);
        const unsigned char* row = src0 + (((size_t)bi * 3 + p) * a.h + sy) * (size_t)a.w * ES;
        unsigned char* dst = buf + (size_t)(k * 3 + p) * a.seg_pitch * ES;
        #pragma unroll
        for (int s = 0; s < 2; ++s) {
            const unsigned char* src = row + (size_t)seg[p * 4 + 2 * s] * ES;
            const int n = seg[p * 4 + 2 * s + 1] * ES;
            if (cb == 16) {
                for (int g = lane * 16; g < n; g += 32 * 16) cp_async<16>(dst + g, src + g);
            } else if (cb == 4) {
                for (int g = lane * 4; g < n; g += 32 * 4) cp_async<4>(dst + g, src + g);
            } else {
                for (int g = lane; g < n; g += 32) dst[g] = src[g];
            }
            dst += n;
        }
    }
}

// GRAW: stage into gb what chunk c's output rows (ny from ya) of frame bi
// read of the raw grain field: its gn rows from g0 (gylo[ya] .. gylo[ya +
// ny - 1] + 1: the row taps rise with the row; the run's grawtab in S.gq),
// each over the strip's raw columns [jr0, jr0 + nraw) (S.misc), then the
// rows' taps (gylo, gyf). A row or column past the field's last is that
// last one (the oracle's hi tap, min(lo + 1, n - 1), where n is 1).
// 4-byte copies: a raw window need not start on a 16-byte word. The
// schedule is read from shared memory: no global load stalls the block.
__device__ void stage_grain(const FusedArgs& a, const Smem& S, float* gb, int bi, int ya, int c) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g0 = S.gq[3 * c], gn = S.gq[3 * c + 1], ny = S.gq[3 * c + 2];
    const int jr0 = S.misc[13], nraw = S.misc[14];
    const float* field = a.grain + (size_t)bi * a.gh * a.gw;
    for (int k = warp; k < gn; k += NWARP) {
        const float* src = field + (size_t)min(g0 + k, a.gh - 1) * a.gw;
        for (int c = lane; c < nraw; c += 32)
            cp_async<4>(gb + k * a.gpitch + c, src + min(jr0 + c, a.gw - 1));
    }
    float* gt = gb + a.gdepth * a.gpitch;
    for (int i = threadIdx.x; i < ny; i += NT) {
        cp_async<4>(gt + i, a.gylo + ya + i);
        cp_async<4>(gt + a.grows + i, a.gyf + ya + i);
    }
}

// acc[v] += c * row[v] for four adjacent columns of a ring row (16-byte load).
__device__ __forceinline__ void add4(float acc[4], float c, const float* row) {
    const float4 t = *reinterpret_cast<const float4*>(row);
    acc[0] = acc[0] + c * t.x;
    acc[1] = acc[1] + c * t.y;
    acc[2] = acc[2] + c * t.z;
    acc[3] = acc[3] + c * t.w;
}

// The gaussian's tap t and border coefficients at distance d: the launch
// arguments, or for BIG the block's copy of the device table.
template <int RT>
__device__ __forceinline__ float tapw(const FusedArgs& a, const Smem& S, int t) {
    if constexpr (RT == BIG) return S.taps[t]; else return a.taps[t];
}

template <int RT>
__device__ __forceinline__ float edgel(const FusedArgs& a, const Smem& S, int d) {
    if constexpr (RT == BIG) return S.taps[2 * a.r + 1 + d]; else return a.edge_l[d];
}

template <int RT>
__device__ __forceinline__ float edger(const FusedArgs& a, const Smem& S, int d) {
    if constexpr (RT == BIG) return S.taps[3 * a.r + 1 + d]; else return a.edge_r[d];
}

// Horizontal taps of four adjacent outputs from a knee'd window row.
// `row` points at the window column of frame column gx - r.
template <int RT>
__device__ __forceinline__ void htaps_interior(const FusedArgs& a, const Smem& S,
                                               const float* row, int r, float acc[4]) {
    #pragma unroll
    for (int v = 0; v < 4; ++v) acc[v] = 0.0f;
    if constexpr (RT > 0) {
        static_assert(RT % 2 == 0, "the window loads are 16 bytes: 2 * RT a multiple of 4");
        constexpr int NV = 4 + 2 * RT;   // a multiple of 4: 16-byte loads
        float val[NV];
        #pragma unroll
        for (int i = 0; i < NV; i += 4) {
            const float4 t = *reinterpret_cast<const float4*>(row + i);
            val[i] = t.x; val[i + 1] = t.y; val[i + 2] = t.z; val[i + 3] = t.w;
        }
        #pragma unroll
        for (int t = 0; t < 2 * RT + 1; ++t) {
            #pragma unroll
            for (int v = 0; v < 4; ++v) acc[v] = acc[v] + a.taps[t] * val[v + t];
        }
    } else if constexpr (RT == BIG) {
        // a window of eight columns slides through registers: one 16-byte
        // load of the row and one of the taps (the same address across the
        // warp) per four taps; each output still adds its taps in order
        const int kt = 2 * r + 1;
        float4 lo = *reinterpret_cast<const float4*>(row);
        int t = 0;
        for (; t + 4 <= kt; t += 4) {
            const float4 hi = *reinterpret_cast<const float4*>(row + t + 4);
            const float4 tp = *reinterpret_cast<const float4*>(S.taps + t);
            const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
            const float c[4] = {tp.x, tp.y, tp.z, tp.w};
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                #pragma unroll
                for (int v = 0; v < 4; ++v) acc[v] = acc[v] + c[j] * x[v + j];
            }
            lo = hi;
        }
        if (t < kt) {  // the last 1-3 taps (columns past the window are read, not used)
            const float4 hi = *reinterpret_cast<const float4*>(row + t + 4);
            const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
            #pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (t + j < kt) {
                    const float c = S.taps[t + j];
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) acc[v] = acc[v] + c * x[v + j];
                }
            }
        }
    } else {
        for (int t = 0; t < 2 * r + 1; ++t) {
            const float tp = tapw<RT>(a, S, t);
            #pragma unroll
            for (int v = 0; v < 4; ++v) acc[v] = acc[v] + tp * row[v + t];
        }
    }
}

// acc[i][v] += c * v4[v] for the BR outputs i in [i0, i1).
__device__ __forceinline__ void add4_rows(float acc[BR][4], const float c[BR], float4 v4, int i0,
                                          int i1) {
    #pragma unroll
    for (int i = 0; i < BR; ++i) {
        if (i >= i0 && i < i1) {
            acc[i][0] = acc[i][0] + c[i] * v4.x;
            acc[i][1] = acc[i][1] + c[i] * v4.y;
            acc[i][2] = acc[i][2] + c[i] * v4.z;
            acc[i][3] = acc[i][3] + c[i] * v4.w;
        }
    }
}

// BIG: vertical taps of the BR inner output rows y .. y + BR - 1 (four
// columns of one plane, `col` their first column in the filtered ring).
// The union window j = 0 .. 2r + BR - 1 (frame row y - r + j) is walked
// once: one ring offset (rowtab's first column of that row: an inner
// row's tap k reads the filtered row that row y + k - r's composite slot
// names, kernels/fused.py _ring_tables) and one 16-byte ring load per j,
// shared by the BR outputs. Output i adds tap k = j - i at step j, so each
// sums its taps in ascending k, the order of the loop it replaces; the
// taps slide through registers, one new tap per j.
__device__ __forceinline__ void vtaps_block(const FusedArgs& a, const Smem& S, const float* col,
                                            int y, int r, float acc[BR][4]) {
    const int rw = 2 * r + 2;
    const int* ro = a.rowtab + (size_t)(y - r) * rw;
    float c[BR];
    #pragma unroll
    for (int i = 0; i < BR; ++i) {
        c[i] = 0.0f;
        #pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][v] = 0.0f;
    }
    #pragma unroll
    for (int j = 0; j < BR - 1; ++j) {  // outputs 0 .. j have begun
        #pragma unroll
        for (int i = BR - 1; i > 0; --i) c[i] = c[i - 1];
        c[0] = S.taps[j];
        add4_rows(acc, c, *reinterpret_cast<const float4*>(col + __ldg(ro + j * rw)), 0, j + 1);
    }
    #pragma unroll 4
    for (int j = BR - 1; j <= 2 * r; ++j) {  // every output
        #pragma unroll
        for (int i = BR - 1; i > 0; --i) c[i] = c[i - 1];
        c[0] = S.taps[j];
        add4_rows(acc, c, *reinterpret_cast<const float4*>(col + __ldg(ro + j * rw)), 0, BR);
    }
    #pragma unroll
    for (int s = 1; s < BR; ++s) {  // outputs s .. BR - 1 have taps left
        const int j = 2 * r + s;
        #pragma unroll
        for (int i = BR - 1; i > 0; --i) c[i] = c[i - 1];
        add4_rows(acc, c, *reinterpret_cast<const float4*>(col + __ldg(ro + j * rw)), s, BR);
    }
}

// Blocks per SM the registers must allow: the gaussian instantiations
// take 80 registers a thread (3 blocks), the fast ones 64 (4 blocks),
// which measured faster for each on an H100 (PERF.md). The direct-pow
// triad (DIRECT, triad_mode 3) is its own instantiation of each, with the
// same caps (its fast paths are f32 and its FP64 fallback is a call),
// except the fast core's uint8-input one: at 64 registers it kept a word
// in local memory, so it takes the gaussian's 80 (3 blocks). GRAW (the raw
// grain upsampled here) is its own instantiation of each, so that the
// full-size grain's instantiations are the code they were; its direct-pow
// fast core with the f32 input kept a word in local memory at 64 registers
// too, and takes 80. TEXT (the text composited in the prologue; uint8 input
// only) is its own instantiation of each uint8 one, with its caps, so that
// the others are the code they were.
template <int CORE, int RT, bool F32IN, bool DIRECT, bool GRAW, bool TEXT>
__global__ void __launch_bounds__(NT, CORE == FAST && !(DIRECT && (!F32IN || GRAW)) ? 4 : 3)
fused_strip_kernel(const __grid_constant__ FusedArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem S = smem_layout<DIRECT, GRAW>(a, smem);
    const int tid = threadIdx.x;
    const int h = a.h, w = a.w, bi = blockIdx.z;
    const int sw = a.sw, step = a.step, depth = a.depth;
    const int x0 = blockIdx.x * sw, xe = min(x0 + sw, w), ncen = xe - x0;
    const int y0 = blockIdx.y * a.run, y1 = min(y0 + a.run, h);
    const int r = CORE == FAST ? 0 : (RT >= 0 ? RT : (a.bloom_on ? a.r : 0));
    if constexpr (RT == BIG) {
        for (int i = tid; i < 4 * r + 1; i += NT) S.taps[i] = __ldg(a.tapdev + i);
    }

    // ---- the strip's windows: full-res [win0, win1), half-res [j0, j1] ----
    int win0, win1, j0 = 0, j1 = -1;
    if constexpr (CORE == GAUSS) {
        win0 = max(0, x0 - r);
        win1 = min(w, xe + r);
    } else {
        j0 = __ldg(a.fu_xlo + x0);
        j1 = min(__ldg(a.fu_xlo + xe - 1) + 1, a.w2 - 1);
        win0 = min(__ldg(a.fd_xlo + j0), x0);
        win1 = max(min(__ldg(a.fd_xlo + j1) + 1, w - 1), xe - 1) + 1;
    }
    const int nwin = win1 - win0, cofs = x0 - win0, nhw = j1 - j0 + 1;
    // the fast core's knee'd ring holds window column c at c - win0 + ksh:
    // the strip's first column then starts a 16-byte word, for the
    // composite's loads when the ring also serves as the pre-knee strip
    const int ksh = CORE == FAST ? (4 - (cofs & 3)) & 3 : 0;
    const bool xsep = CORE == GAUSS || a.knee_on;  // a separate pre-knee strip ring
    int* seg = S.misc;
    if (tid < 12) seg[tid] = __ldg(a.segs + blockIdx.x * 12 + tid);
    if (a.triad_mode == 2) {
        for (int i = tid; i < 1025; i += NT) {
            S.lut[i] = __ldg(a.lut_fwd + i);
            S.lut[LUTP + i] = __ldg(a.lut_fin + i);
        }
    }
    if constexpr (DIRECT) {
        for (int i = tid; i < triad::TAB; i += NT) S.lut[i] = __ldg(triad::kTab + i);
    }
    for (int x = tid; x < ncen; x += NT) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            S.tri[p * sw + x] = a.triad_mode ? __ldg(a.tri + p * w + x0 + x) : 0.0f;
        S.vx[x] = a.vig_on ? __ldg(a.vx2 + x0 + x) : 0.0f;
    }
    if constexpr (CORE == FAST) {
        for (int j = tid; j < nhw; j += NT) {
            S.hx_lo[j] = __ldg(a.fd_xlo + j0 + j);
            S.hx_f[j] = __ldg(a.fd_xf + j0 + j);
        }
        for (int x = tid; x < ncen; x += NT) {
            S.ux_lo[x] = __ldg(a.fu_xlo + x0 + x);
            S.ux_f[x] = __ldg(a.fu_xf + x0 + x);
        }
    }
    // GRAW, once per block: the strip's raw columns [jr0, jr0 + nraw), each
    // lo tap and lo + 1 (the oracle's column taps rise with the column), its
    // column taps, and the run's raw schedule
    if constexpr (GRAW) {
        const int jr0 = __ldg(a.gxlo + x0);
        for (int x = tid; x < ncen; x += NT) {
            S.gx_lo[x] = __ldg(a.gxlo + x0 + x) - jr0;
            S.gx_f[x] = __ldg(a.gxf + x0 + x);
        }
        if (tid == 0) {
            S.misc[13] = jr0;
            S.misc[14] = __ldg(a.gxlo + xe - 1) + 2 - jr0;
        }
        for (int i = tid; i < a.gstride; i += NT)
            S.gq[i] = __ldg(a.grawtab + blockIdx.y * a.gstride + i);
    }
    __syncthreads();

    // ---- staged offsets and the leader flags of the window's columns ----
    for (int c = tid; c < nwin; c += NT) {
        const int gc = win0 + c;
        bool leader = F32IN || c == 0;
        #pragma unroll
        for (int p = 0; p < 3; ++p) {
            const int sx = F32IN ? gc : __ldg(a.xmap + p * w + gc);
            const int a0 = seg[p * 4], n0 = seg[p * 4 + 1], a1 = seg[p * 4 + 2];
            S.offs[p * a.win + c] = (short)((sx >= a0 && sx < a0 + n0) ? sx - a0 : n0 + sx - a1);
            if (!F32IN && c > 0) leader = leader || sx != __ldg(a.xmap + p * w + gc - 1);
        }
        S.lead[c] = leader ? 1 : 0;
    }
    __syncthreads();
    if (tid < 32) {  // compact the flags into the list of leader columns
        int count = 0;
        for (int base = 0; base < nwin; base += 32) {
            const bool f = base + tid < nwin && S.lead[base + tid];
            const unsigned m = __ballot_sync(0xffffffffu, f);
            __syncwarp();
            if (f) {
                const int li = count + __popc(m & ((1u << tid) - 1u));
                S.lead[li] = (short)(base + tid);
                #pragma unroll
                for (int p = 0; p < 3; ++p) S.loffs[p * a.win + li] = S.offs[p * a.win + base + tid];
            }
            count += __popc(m);
            __syncwarp();
        }
        if (tid == 0) {
            S.lead[count] = (short)nwin;
            S.misc[12] = count;
        }
    }

    // ---- the walk's schedule for this run (kernels/fused.py plan_chunks) ----
    const int* sched = a.runtab + blockIdx.y * a.run_stride;
    const int d_lo = __ldg(sched), d_hi = __ldg(sched + 1);
    int nh = __ldg(sched + 2);
    const size_t stage_buf = (size_t)step * 3 * a.seg_pitch * (F32IN ? 4 : 1);
    stage_rows<F32IN>(a, S.stage, seg, bi, d_lo, min(step, d_hi - d_lo));
    // GRAW: the raw grain of a chunk's output rows is staged in its own
    // buffer of two, a chunk ahead: chunk 0's with its source rows, chunk
    // ci + 1's after chunk ci's first barrier (the last reader of that
    // buffer, chunk ci - 1's epilogue, has passed it), in a commit group of
    // its own that the next chunk's wait_group 1 completes.
    if constexpr (GRAW) stage_grain(a, S, S.graw, bi, y0, 0);
    cp_commit();
    __syncthreads();
    const int nl = S.misc[12];
    const int nq = (ncen + 3) >> 2;   // groups of four output columns
    const FastDiv div_nl(nl), div_nq(nq), div_nhw(max(nhw, 1));
    const int kt = 2 * r + 1;
    const int rw = CORE == FAST ? 4 : kt + 1;  // ints per row of rowtab
    int nxt = y0;
    int he_next = __ldg(sched + 3), ye_next = __ldg(sched + 4);
    // the grain of this thread's first output of a chunk is loaded a chunk
    // ahead, so that its latency hides behind a whole chunk
    float gr_next[4];
    if (!GRAW && tid < (ye_next - y0) * nq) {
        const int yy = div_nq(tid), q = tid - yy * nq;
        load_grain(a, bi, y0 + yy, x0 + 4 * q, min(4, ncen - 4 * q), gr_next);
    }

    for (int d = d_lo, ci = 0; d < d_hi; d += step, ++ci) {
        const int dn = min(step, d_hi - d), e = d + dn;
        if (e < d_hi)
            stage_rows<F32IN>(a, S.stage + ((ci + 1) & 1) * stage_buf, seg, bi, e,
                              min(step, d_hi - e));
        cp_commit();
        cp_wait_prior();
        __syncthreads();

        // ---- the rows this chunk completes; the next chunk's rows and grain ----
        const int he = CORE == FAST ? he_next : nh, ye = ye_next;
        float gr0[4];
        #pragma unroll
        for (int v = 0; v < 4; ++v) gr0[v] = gr_next[v];
        const float* gb = GRAW ? S.graw + (ci & 1) * graw_floats(a) : nullptr;
        if (e < d_hi) {
            he_next = __ldg(sched + 5 + 2 * ci);
            ye_next = __ldg(sched + 6 + 2 * ci);
            if constexpr (GRAW) {
                stage_grain(a, S, S.graw + ((ci + 1) & 1) * graw_floats(a), bi, ye, ci + 1);
                cp_commit();
            } else if (tid < (ye_next - ye) * nq) {
                const int yy = div_nq(tid), q = tid - yy * nq;
                load_grain(a, bi, ye + yy, x0 + 4 * q, min(4, ncen - 4 * q), gr_next);
            }
        }

        // ---- 1. prologue, once per distinct source pixel ----
        const unsigned char* st = S.stage + (ci & 1) * stage_buf;
        const int rb = d % depth;  // ring slot of distinct row d
        for (int it = tid; it < dn * nl; it += NT) {
            const int k = div_nl(it), li = it - k * nl;
            const int c = S.lead[li], ce = S.lead[li + 1];
            float x[3];
            #pragma unroll
            for (int p = 0; p < 3; ++p) {
                const int o = (k * 3 + p) * a.seg_pitch + S.loffs[p * a.win + li];
                x[p] = F32IN ? reinterpret_cast<const float*>(st)[o] : (float)st[o] * a.inv255;
            }
            if (!F32IN) grade(a, x);
            const int slot = rb + k < depth ? rb + k : rb + k - depth;
            float kx[3];
            #pragma unroll
            for (int p = 0; p < 3; ++p) kx[p] = knee(a, x[p]);
            if constexpr (TEXT) {  // rows outside the box: the identity, stored below
                const int ty = __ldg(a.trow + d + k);
                if (ty >= 0) {
                    composite_run<CORE>(a, S, k, slot, c, ce, ty, win0, cofs, ksh, r, xsep, ncen,
                                        x, kx);
                    continue;
                }
            }
            for (int cc = c; cc < ce; ++cc) {
                #pragma unroll
                for (int p = 0; p < 3; ++p) {
                    if constexpr (CORE == GAUSS) {
                        if (r > 0) S.kw[(k * 3 + p) * a.win + cc] = kx[p];
                    } else {
                        S.ring[(slot * 3 + p) * a.win + cc + ksh] = kx[p];
                    }
                    const int lc = cc - cofs;
                    if (xsep && lc >= 0 && lc < ncen) S.xr[(slot * 3 + p) * sw + lc] = x[p];
                }
            }
        }
        __syncthreads();

        if constexpr (CORE == GAUSS) {
            // ---- 2. horizontal taps, once per distinct row ----
            if (r > 0) {
                const bool interior = x0 >= r && x0 + sw + r <= w;
                for (int it = tid; it < dn * 3 * nq; it += NT) {
                    const int kp = div_nq(it), q = it - kp * nq;
                    const int k = kp / 3, p = kp - 3 * k;
                    const float* row = S.kw + (k * 3 + p) * a.win;
                    const int gx = x0 + 4 * q;
                    float acc[4];
                    if (interior) {
                        htaps_interior<RT>(a, S, row + (gx - r - win0), r, acc);
                    } else {
                        #pragma unroll
                        for (int v = 0; v < 4; ++v) {
                            const int x = gx + v;
                            float s = 0.0f;
                            if (x < w) {
                                for (int t = 0; t < kt; ++t) {
                                    const int sx = x + t - r;
                                    if (sx >= 0 && sx < w)
                                        s = s + tapw<RT>(a, S, t) * row[sx - win0];
                                }
                                if (x < r) s = s + edgel<RT>(a, S, x) * row[0 - win0];
                                if (w - 1 - x < r)
                                    s = s + edger<RT>(a, S, w - 1 - x) * row[w - 1 - win0];
                            }
                            acc[v] = s;
                        }
                    }
                    const int slot = rb + k < depth ? rb + k : rb + k - depth;
                    *reinterpret_cast<float4*>(S.ring + (slot * 3 + p) * sw + 4 * q) =
                        make_float4(acc[0], acc[1], acc[2], acc[3]);
                }
                __syncthreads();
            }

            // ---- 3. vertical taps, composite, epilogue ----
            if constexpr (RT == BIG) {
                // In passes of up to `vcap` output rows: each thread sums BR
                // rows x 4 columns of one plane and stores their composites
                // in S.kw (the chunk's knee'd rows are spent), a row of the
                // strip's 4 * nq columns per plane; then the epilogue takes a
                // row's three planes from there. The window holds the strip,
                // so win >= 4 * nq and a pass holds at least `step` rows.
                const int mp = 4 * nq;
                const int vcap = step * a.win / mp;
                for (int ya = nxt; ya < ye; ya += vcap) {
                    const int yb = min(ya + vcap, ye);
                    if (ya > nxt) __syncthreads();  // the last pass's epilogue has read S.kw
                    const int ng = (yb - ya + BR - 1) / BR;
                    for (int it = tid; it < ng * 3 * nq; it += NT) {
                        const int gp = div_nq(it), q = it - gp * nq;
                        const int g = gp / 3, p = gp - 3 * g;
                        const int y = ya + BR * g, n = min(BR, yb - y);
                        const float* col = S.ring + p * sw + 4 * q;
                        float* mo = S.kw + (size_t)((y - ya) * 3 + p) * mp + 4 * q;
                        if (n == BR && y - r >= 0 && y + BR - 1 + r < h) {
                            float acc[BR][4];
                            vtaps_block(a, S, col, y, r, acc);
                            #pragma unroll
                            for (int i = 0; i < BR; ++i) {
                                const float4 xv = *reinterpret_cast<const float4*>(
                                    S.xr + __ldg(a.rowtab + (size_t)(y + i) * rw) + p * sw + 4 * q);
                                *reinterpret_cast<float4*>(mo + i * 3 * mp) = make_float4(
                                    clip01(xv.x + a.strength * acc[i][0]),
                                    clip01(xv.y + a.strength * acc[i][1]),
                                    clip01(xv.z + a.strength * acc[i][2]),
                                    clip01(xv.w + a.strength * acc[i][3]));
                            }
                            continue;
                        }
                        for (int i = 0; i < n; ++i) {  // one row at a time (the frame's edges)
                            const int yi = y + i;
                            const int* t = a.rowtab + (size_t)yi * rw;
                            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                            if (yi - r >= 0 && yi + r < h) {
                                for (int k = 0; k < kt; ++k)
                                    add4(acc, tapw<RT>(a, S, k), col + t[1 + k]);
                            } else {
                                for (int k = 0; k < kt; ++k) {
                                    const int sy = yi + k - r;
                                    if (sy >= 0 && sy < h)
                                        add4(acc, tapw<RT>(a, S, k), col + t[1 + k]);
                                }
                                if (yi < r) add4(acc, edgel<RT>(a, S, yi), col + t[1 + r - yi]);
                                if (h - 1 - yi < r)
                                    add4(acc, edger<RT>(a, S, h - 1 - yi),
                                         col + t[1 + (h - 1 - yi) + r]);
                            }
                            const float4 xv =
                                *reinterpret_cast<const float4*>(S.xr + t[0] + p * sw + 4 * q);
                            *reinterpret_cast<float4*>(mo + i * 3 * mp) = make_float4(
                                clip01(xv.x + a.strength * acc[0]),
                                clip01(xv.y + a.strength * acc[1]),
                                clip01(xv.z + a.strength * acc[2]),
                                clip01(xv.w + a.strength * acc[3]));
                        }
                    }
                    __syncthreads();
                    for (int it = tid; it < (yb - ya) * nq; it += NT) {
                        const int yy = div_nq(it), q = it - yy * nq;
                        const int y = ya + yy, gx = x0 + 4 * q;
                        float m[3][4];
                        #pragma unroll
                        for (int p = 0; p < 3; ++p) {
                            const float4 v4 = *reinterpret_cast<const float4*>(
                                S.kw + (size_t)(yy * 3 + p) * mp + 4 * q);
                            m[p][0] = v4.x; m[p][1] = v4.y; m[p][2] = v4.z; m[p][3] = v4.w;
                        }
                        float gr[4];
                        if constexpr (GRAW) {
                            grain_staged(a, S, gb, S.gq[3 * ci], y - nxt, 4 * q, min(4, xe - gx), gr);
                        } else if (ya == nxt && it == tid) {
                            #pragma unroll
                            for (int v = 0; v < 4; ++v) gr[v] = gr0[v];
                        } else {
                            load_grain(a, bi, y, gx, min(4, xe - gx), gr);
                        }
                        epilogue4<DIRECT>(a, S, bi, y, gx, 4 * q, min(4, xe - gx), m, gr);
                    }
                }
            } else {
                for (int it = tid; it < (ye - nxt) * nq; it += NT) {
                    const int yy = div_nq(it), q = it - yy * nq;
                    const int y = nxt + yy, gx = x0 + 4 * q;
                    const int* t = a.rowtab + (size_t)y * rw;
                    const bool inner = y - r >= 0 && y + r < h;
                    float m[3][4];
                    #pragma unroll
                    for (int p = 0; p < 3; ++p) {
                        const float4 xv4 =
                            *reinterpret_cast<const float4*>(S.xr + t[0] + p * sw + 4 * q);
                        const float xv[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
                        float acc[4];
                        if (!a.bloom_on) {
                            #pragma unroll
                            for (int v = 0; v < 4; ++v) m[p][v] = xv[v];
                            continue;
                        }
                        if (r == 0) {  // one tap: the identity (the reference skips it)
                            #pragma unroll
                            for (int v = 0; v < 4; ++v) acc[v] = knee(a, xv[v]);
                        } else {
                            const float* col = S.ring + p * sw + 4 * q;
                            #pragma unroll
                            for (int v = 0; v < 4; ++v) acc[v] = 0.0f;
                            if (inner) {
                                if constexpr (RT > 0) {
                                    #pragma unroll
                                    for (int k = 0; k < 2 * RT + 1; ++k)
                                        add4(acc, a.taps[k], col + t[1 + k]);
                                } else {
                                    for (int k = 0; k < kt; ++k)
                                        add4(acc, tapw<RT>(a, S, k), col + t[1 + k]);
                                }
                            } else {
                                for (int k = 0; k < kt; ++k) {
                                    const int sy = y + k - r;
                                    if (sy >= 0 && sy < h)
                                        add4(acc, tapw<RT>(a, S, k), col + t[1 + k]);
                                }
                                // the tap rows clamp to the frame: rows 0 and H - 1
                                if (y < r) add4(acc, edgel<RT>(a, S, y), col + t[1 + r - y]);
                                if (h - 1 - y < r)
                                    add4(acc, edger<RT>(a, S, h - 1 - y),
                                         col + t[1 + (h - 1 - y) + r]);
                            }
                        }
                        #pragma unroll
                        for (int v = 0; v < 4; ++v) m[p][v] = clip01(xv[v] + a.strength * acc[v]);
                    }
                    float gr[4];
                    if constexpr (GRAW) {
                        grain_staged(a, S, gb, S.gq[3 * ci], yy, 4 * q, min(4, xe - gx), gr);
                    } else if (it == tid) {
                        #pragma unroll
                        for (int v = 0; v < 4; ++v) gr[v] = gr0[v];
                    } else {
                        load_grain(a, bi, y, gx, min(4, xe - gx), gr);
                    }
                    epilogue4<DIRECT>(a, S, bi, y, gx, 4 * q, min(4, xe - gx), m, gr);
                }
            }
        } else {
            // ---- 2. half-res rows: down rows, then down columns ----
            for (int it = tid; it < (he - nh) * 3 * nhw; it += NT) {
                const int ip = div_nhw(it), jj = it - ip * nhw;
                const int ii = ip / 3, p = ip - 3 * ii;
                const int4 t = __ldg(reinterpret_cast<const int4*>(a.halftab) + nh + ii);
                const float* rl = S.ring + t.x + p * a.win - win0 + ksh;
                const float* rh = S.ring + t.y + p * a.win - win0 + ksh;
                const float fy = __int_as_float(t.w);
                const int xl = S.hx_lo[jj], xh = min(xl + 1, w - 1);
                const float dl = lerp_taps(rl[xl], rh[xl], fy);
                const float dh = lerp_taps(rl[xh], rh[xh], fy);
                S.half[t.z + p * a.hwin + jj] = lerp_taps(dl, dh, S.hx_f[jj]);
            }
            __syncthreads();

            // ---- 3. up rows, up columns, composite, epilogue ----
            for (int it = tid; it < (ye - nxt) * nq; it += NT) {
                const int yy = div_nq(it), q = it - yy * nq;
                const int y = nxt + yy, gx = x0 + 4 * q;
                const int4 t = __ldg(reinterpret_cast<const int4*>(a.rowtab) + y);
                const float uf = __int_as_float(t.w);
                float m[3][4];
                #pragma unroll
                for (int p = 0; p < 3; ++p) {
                    const float* hl = S.half + t.y + p * a.hwin - j0;
                    const float* hh = S.half + t.z + p * a.hwin - j0;
                    const float* xr = xsep ? S.xr + t.x + p * sw + 4 * q
                                           : S.ring + t.x + p * a.win + cofs + ksh + 4 * q;
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) {
                        const int lx = min(4 * q + v, ncen - 1);  // past the frame: not stored
                        const int ul = S.ux_lo[lx], uh = min(ul + 1, a.w2 - 1);
                        const float bl = lerp_taps(lerp_taps(hl[ul], hh[ul], uf),
                                                   lerp_taps(hl[uh], hh[uh], uf), S.ux_f[lx]);
                        m[p][v] = clip01(xr[v] + a.strength * bl);
                    }
                }
                float gr[4];
                if constexpr (GRAW) {
                    grain_staged(a, S, gb, S.gq[3 * ci], yy, 4 * q, min(4, xe - gx), gr);
                } else if (it == tid) {
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) gr[v] = gr0[v];
                } else {
                    load_grain(a, bi, y, gx, min(4, xe - gx), gr);
                }
                epilogue4<DIRECT>(a, S, bi, y, gx, 4 * q, min(4, xe - gx), m, gr);
            }
            nh = he;
        }
        nxt = ye;
    }
}

using KernelFn = void (*)(const FusedArgs);

// The instantiation of a core and radius for the input: the f32 or the
// uint8 one, or with TEXT the uint8 one that composites the text.
template <int CORE, int RT, bool DIRECT, bool GRAW, bool TEXT>
KernelFn input_kernel(bool f32) {
    if constexpr (TEXT)
        return fused_strip_kernel<CORE, RT, false, DIRECT, GRAW, true>;
    else
        return f32 ? fused_strip_kernel<CORE, RT, true, DIRECT, GRAW, false>
                   : fused_strip_kernel<CORE, RT, false, DIRECT, GRAW, false>;
}

// The instantiation for a launch: core, radius, input, triad, grain operand, text.
template <bool DIRECT, bool GRAW, bool TEXT>
KernelFn pick_kernel(const FusedArgs& a) {
    const bool f32 = !a.pre_on;
    if (a.bloom_on && a.fast_on) return input_kernel<FAST, 0, DIRECT, GRAW, TEXT>(f32);
    if (a.bloom_on && a.r == 4) return input_kernel<GAUSS, 4, DIRECT, GRAW, TEXT>(f32);
    if (a.bloom_on && a.r > MAXR) return input_kernel<GAUSS, BIG, DIRECT, GRAW, TEXT>(f32);
    return input_kernel<GAUSS, -1, DIRECT, GRAW, TEXT>(f32);
}

template <bool DIRECT, bool GRAW>
KernelFn pick_text(const FusedArgs& a) {
    return a.text_on ? pick_kernel<DIRECT, GRAW, true>(a) : pick_kernel<DIRECT, GRAW, false>(a);
}

}  // namespace

extern "C" int crt_fused_launch(const FusedArgs* a, void* stream) {
    if (a->r < 0 || (a->bloom_on && !a->fast_on && a->r > MAXR && !a->tapdev))
        return (int)cudaErrorInvalidValue;
    const bool graw = a->noise_on && a->grain_raw;
    if (graw && (!a->gylo || !a->gyf || !a->gxlo || !a->gxf || a->gh < 1 || a->gw < 1
                 || a->gdepth < 1 || a->gpitch < 1 || a->grows < 1 || !a->grawtab
                 || a->gstride < 3))
        return (int)cudaErrorInvalidValue;
    if (a->text_on && (!a->pre_on || !a->trow || !a->talpha || !a->trgb || a->th < 1
                       || a->tw < 1 || a->tx0 < 0 || a->tx0 + a->tw > a->w))
        return (int)cudaErrorInvalidValue;
    const bool direct = a->triad_mode == 3;
    const int total = direct ? (graw ? smem_layout<true, true>(*a, nullptr).total
                                     : smem_layout<true, false>(*a, nullptr).total)
                             : (graw ? smem_layout<false, true>(*a, nullptr).total
                                     : smem_layout<false, false>(*a, nullptr).total);
    if (total != a->smem) return (int)cudaErrorInvalidValue;
    KernelFn kern = direct ? (graw ? pick_text<true, true>(*a) : pick_text<true, false>(*a))
                           : (graw ? pick_text<false, true>(*a) : pick_text<false, false>(*a));
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + a->sw - 1) / a->sw, (a->h + a->run - 1) / a->run, a->b);
    kern<<<grid, NT, a->smem, static_cast<cudaStream_t>(stream)>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int crt_fused_args_bytes() { return (int)sizeof(FusedArgs); }
