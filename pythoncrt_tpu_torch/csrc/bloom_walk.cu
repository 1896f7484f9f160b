// Stand-alone blooms for Hopper (sm_90a): stage 6 on an f32 image,
// clip(x + strength * blur(knee(x))), plane by plane. One row walk serves
// four TPU kernels. For the separable blooms blur = V(H(.)), 1-D passes
// over a band of offsets d0..d1, and only where a tap's weight comes from
// differs (the template parameter SRC):
//
// - FOLD: constant gaussian taps, out-of-frame taps adding nothing, then
//   the summed left (top) and right (bottom) border coefficients times the
//   edge sample (ops/blur.py, the fused kernel's core). Replaces
//   pythoncrt_tpu/kernels/bloom3.py, bloom3_planar / _bloom3_kernel.
// - CLAMP: constant taps, every tap reading the replicate-clamped sample,
//   in tap order (oracle/ops.py _conv1d_replicate). Replaces
//   pythoncrt_tpu/kernels/bloom.py, bloom_nhwc / _bloom_kernel.
// - TABLE: per-position weights hw[d - hd0, x] and vw[d - vd0, y] over
//   clamped samples (a tap leaving the frame carries weight 0). Replaces
//   pythoncrt_tpu/kernels/bloom2.py, bloom2_nhwc / _bloom2_kernel and
//   bloom2_nhwc_pipelined / _bloom2_pipe_kernel: `limbs` 1 and 2 round the
//   knee'd value to bf16 (the host rounds the weights), 3 keeps f32.
// The fourth source, FAST, is bloom3's fast bloom, blur = up(down(.)):
// the oracle's resize_bilinear to (H/2, W/2) and back, rows then columns
// in each pass, lo * (1 - f) + hi * f from its bilinear_taps tables.
// Replaces pythoncrt_tpu/kernels/bloom3.py, bloom3_fast_cmajor /
// _bloom3_fast_kernel (bloom_fast_walk_kernel below).
// Each sum runs in offset order, the first term its start (FOLD: 0 plus
// the first in-frame term), so the outputs are the plain twins' bits
// (kernels/bloom3.py, bloom.py, bloom2.py). The TPU forms (bf16 MXU limbs,
// lane pre-pads and masks, row stripes with a DMA ring) have no
// counterpart: at a 9-tap band f32 multiply-adds on the CUDA cores are the
// right tool.
//
// What bounds it on the card: bytes. A 1080p frame is 24.9 MB of f32 read
// and 24.9 MB written (0.0149 ms at 3.35 TB/s); the taps are 2 x 9
// multiply-adds per value at sigma 1.2, the fast source's four resize
// passes about 16 operations per value.
//
// Design: a block owns a strip of SW output columns of one plane (the blur
// is per plane) and walks down a run of rows; the host plans the walk
// (kernels/bloom_walk.py walk_plan, replayed by walk_chunks). Per chunk of
// STEP source rows:
// 1. The next chunk's raw rows are staged with cp.async (16 bytes a copy
//    where W % 4 == 0) while this one is filtered: the strip plus the
//    horizontal reach, clamped to the frame (one range).
// 2. Where a knee (or the bf16 rounding) is on, it is applied once per
//    staged value, in place; the strip's pre-knee values go to a ring of
//    XDEPTH rows first (the composite's operand: no second device read).
// 3. The horizontal pass runs once per (row, column) into a ring of DEPTH
//    filtered rows, four adjacent outputs per thread.
// 4. Every output row whose band the ring now holds gets the vertical
//    sum over the ring (16-byte shared-memory reads), the composite, and
//    a float4 store where W % 4 == 0.
// Item indices split by shifts (SW / 4 is a power of two), and ring slots
// advance by a compare: no runtime division in the loops. The sigma 1.2
// band (-4..4) has instances with unrolled taps read from the launch
// arguments; other bands loop, with the taps (or the strip's columns of
// hw) staged in shared memory once per block, from a device table when
// more than MAXK. The vertical table weights are read once per output row.
// A band whose block exceeds the card's shared memory at the narrowest
// strip (kernels/bloom_walk.py) takes the scratch route: a horizontal pass
// into a device buffer, then a vertical pass from it, both plain loops
// over global memory in the same order. The FAST source walks the same
// strips and runs with rings of its own (bloom_fast_walk_kernel;
// kernels/bloom_walk.py fast_plan, replayed by fast_chunks). Built with
// -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "crt_common.cuh"

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXK = 63;     // taps carried in the launch arguments
constexpr int FOLD = 0, CLAMP = 1, TABLE = 2, FAST = 3;
constexpr int RUNTIME = -1;  // the band's reach known only at run time

}  // namespace

// Mirrored field for field by a ctypes.Structure in the Python wrapper.
struct WalkArgs {
    const float* img;        // (N, H, W) planes
    float* out;              // (N, H, W)
    const float* hw;         // TABLE: (ndh, W) horizontal weights hw[d - hd0, x]
    const float* vw;         // TABLE: (ndv, H) vertical weights
    const float* tapdev;     // FOLD, CLAMP: (k [+ 2r]) taps [, edge_l, edge_r] on the
                             // device, when k > MAXK or on the scratch route; else null
    float* scratch;          // scratch route: (N, H, W) horizontal pass
    int32_t n, h, w;
    int32_t src;             // FOLD, CLAMP, TABLE or FAST
    int32_t hd0, hd1, vd0, vd1;
    int32_t knee_on; float thr, rden;
    float strength;
    int32_t limbs;           // TABLE: 3 f32 value; 1, 2 the value rounded to bf16
    // the walk (kernels/bloom_walk.py walk_plan): strip width and log2 of
    // its groups of four columns, rows per chunk and per run, ring depths,
    // staged row pitch (floats), shared memory bytes; 16-byte copies;
    // float4 stores
    int32_t sw, lg_nq, step, run, depth, xdepth, win, smem;
    int32_t copy16, vec_ok;
    int32_t scratch_on;
    // FAST (kernels/bloom_walk.py fast_plan): the oracle's bilinear_taps of
    // the down columns (W2,) and up columns (W,); per strip the staged
    // columns and half-res columns (a0, n, j0, nh); per run the schedule;
    // per output row and half-res row the ring offsets and fractions
    const int32_t* fd_xlo; const float* fd_xf;
    const int32_t* fu_xlo; const float* fu_xf;
    const int32_t* fwin;
    const int32_t* fsched;
    const int4* frow;        // (H,) pre-knee offset, half-res lo / hi offsets, up fraction bits
    const int4* fhalf;       // (H2,) source lo / hi offsets, own offset, down fraction bits
    int32_t w2, hdepth, hwin, sched_stride;
    float taps[MAXK];        // FOLD, CLAMP: taps[d + r], when k <= MAXK
    float edge_l[MAXK];      // FOLD: summed taps clipped off the left/top at distance d
    float edge_r[MAXK];      // FOLD: same for the right/bottom edge
};

namespace {

using crt::clip01;

struct WalkSmem {
    float* stage;  // [2][step][win] staged rows (knee'd in place when a knee is on)
    float* ring;   // [depth][sw] filtered rows
    float* xr;     // [xdepth][sw] the strip's pre-knee rows
    float* tab;    // TABLE: [ndh][sw] the strip's hw; else the taps [, edge_l, edge_r]
    int total;
};

__host__ __device__ __forceinline__ int a16(int n) { return (n + 15) & ~15; }

// The number of floats of the weight table (kernels/bloom_walk.py walk_smem).
__host__ __device__ __forceinline__ int tab_floats(const WalkArgs& a) {
    const int nd = a.hd1 - a.hd0 + 1;
    return a.src == TABLE ? nd * a.sw : nd + (a.src == FOLD ? 2 * a.hd1 : 0);
}

__host__ __device__ inline WalkSmem walk_layout(const WalkArgs& a, unsigned char* base) {
    WalkSmem s;
    int o = 0;
    s.stage = (float*)(base + o); o += a16(2 * a.step * a.win * 4);
    s.ring = (float*)(base + o); o += a16(a.depth * a.sw * 4);
    s.xr = (float*)(base + o); o += a16(a.xdepth * a.sw * 4);
    s.tab = (float*)(base + o); o += a16(tab_floats(a) * 4);
    s.total = o;
    return s;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The stored value of a staged sample: knee'd, and for TABLE at limbs < 3
// rounded to bf16.
template <int SRC>
__device__ __forceinline__ float feed(const WalkArgs& a, float v) {
    float k = crt::knee(a.knee_on, a.thr, a.rden, v);
    if (SRC == TABLE && a.limbs < 3) k = __bfloat162float(__float2bfloat16_rn(k));
    return k;
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Stage source rows [d, d + dn) of the plane, columns [a0, a0 + nst): one
// warp per row.
__device__ __forceinline__ void stage_rows(const WalkArgs& a, float* buf, const float* src,
                                           int d, int dn, int a0, int nst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int k = warp; k < dn; k += NWARP) {
        const float* row = src + (size_t)(d + k) * a.w + a0;
        float* dst = buf + k * a.win;
        if (a.copy16) {
            for (int g = lane * 4; g < nst; g += 32 * 4) cp_async<16>(dst + g, row + g);
        } else {
            for (int g = lane; g < nst; g += 32) cp_async<4>(dst + g, row + g);
        }
    }
}

// The weight of tap t: the launch arguments for the unrolled instances,
// shared memory for the runtime-band ones.
template <int RT>
__device__ __forceinline__ float tap(const WalkArgs& a, const float* tab, int t) {
    if constexpr (RT >= 0) return a.taps[t]; else return tab[t];
}

template <int RT>
__device__ __forceinline__ float edge_l(const WalkArgs& a, const float* tab, int k, int d) {
    if constexpr (RT >= 0) return a.edge_l[d]; else return tab[k + d];
}

template <int RT>
__device__ __forceinline__ float edge_r(const WalkArgs& a, const float* tab, int k, int r,
                                        int d) {
    if constexpr (RT >= 0) return a.edge_r[d]; else return tab[k + r + d];
}

// acc[v] (+)= c * val[v] for four columns: FIRST starts the sums (CLAMP,
// TABLE), else adds (FOLD starts from 0).
__device__ __forceinline__ void term4(float acc[4], const float c[4], const float val[4],
                                      bool first) {
    #pragma unroll
    for (int v = 0; v < 4; ++v) acc[v] = first ? c[v] * val[v] : acc[v] + c[v] * val[v];
}

// The horizontal pass of four adjacent outputs gx..gx+3 (strip column lx)
// from staged row `row` (frame column c at row[c - a0]).
template <int SRC, int RT>
__device__ __forceinline__ void hpass4(const WalkArgs& a, const float* tab, const float* row,
                                       int a0, int gx, int lx, int hd0, int nd, float acc[4]) {
    const int w = a.w;
    const int r = -hd0;  // FOLD, CLAMP: the band is -r..r
    #pragma unroll
    for (int v = 0; v < 4; ++v) acc[v] = 0.0f;
    if (gx + hd0 >= 0 && gx + 3 + hd0 + nd - 1 <= w - 1) {
        // every tap of the four outputs in the frame: FOLD and CLAMP agree
        const float* p = row + (gx + hd0 - a0);
        if constexpr (RT >= 0) {
            constexpr int NV = 4 + 2 * RT;
            float val[NV];
            if constexpr (RT % 4 == 0) {   // p is 16-byte aligned (kernels/bloom_walk.py)
                #pragma unroll
                for (int i = 0; i < NV; i += 4) {
                    const float4 t = *reinterpret_cast<const float4*>(p + i);
                    val[i] = t.x; val[i + 1] = t.y; val[i + 2] = t.z; val[i + 3] = t.w;
                }
            } else if constexpr (RT % 2 == 0) {  // 8-byte aligned
                #pragma unroll
                for (int i = 0; i < NV; i += 2) {
                    const float2 t = *reinterpret_cast<const float2*>(p + i);
                    val[i] = t.x; val[i + 1] = t.y;
                }
            } else {
                #pragma unroll
                for (int i = 0; i < NV; ++i) val[i] = p[i];
            }
            #pragma unroll
            for (int t = 0; t < 2 * RT + 1; ++t) {
                float c[4];
                if constexpr (SRC == TABLE) {
                    const float4 c4 = *reinterpret_cast<const float4*>(tab + t * a.sw + lx);
                    c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
                } else {
                    c[0] = c[1] = c[2] = c[3] = a.taps[t];
                }
                term4(acc, c, val + t, SRC != FOLD && t == 0);
            }
        } else {
            float v0 = p[0], v1 = p[1], v2 = p[2];
            for (int t = 0; t < nd; ++t) {
                const float v3 = p[t + 3];
                float c[4];
                if constexpr (SRC == TABLE) {
                    const float4 c4 = *reinterpret_cast<const float4*>(tab + t * a.sw + lx);
                    c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
                } else {
                    c[0] = c[1] = c[2] = c[3] = tab[t];
                }
                const float val[4] = {v0, v1, v2, v3};
                term4(acc, c, val, SRC != FOLD && t == 0);
                v0 = v1; v1 = v2; v2 = v3;
            }
        }
        return;
    }
    // near the frame's left or right edge (or past it: not stored)
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
        const int x = gx + v;
        float s = 0.0f;
        if (x < w) {
            if constexpr (SRC == FOLD) {
                for (int t = 0; t < nd; ++t) {
                    const int sx = x + t - r;
                    if (sx >= 0 && sx < w) s = s + tap<RT>(a, tab, t) * row[sx - a0];
                }
                if (x < r) s = s + edge_l<RT>(a, tab, nd, x) * row[0 - a0];
                if (w - 1 - x < r) s = s + edge_r<RT>(a, tab, nd, r, w - 1 - x) * row[w - 1 - a0];
            } else {
                for (int t = 0; t < nd; ++t) {
                    const float c = SRC == TABLE ? tab[t * a.sw + lx + v] : tap<RT>(a, tab, t);
                    const float term = c * row[clampi(x + hd0 + t, 0, w - 1) - a0];
                    s = t == 0 ? term : s + term;
                }
            }
        }
        acc[v] = s;
    }
}

// acc (+)= c * ring row (four columns, one 16-byte read).
__device__ __forceinline__ void vterm4(float acc[4], float c, const float* p, bool first) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    const float cc[4] = {c, c, c, c};
    const float val[4] = {t.x, t.y, t.z, t.w};
    term4(acc, cc, val, first);
}

template <int SRC, int RT>
__global__ void __launch_bounds__(NT)
bloom_walk_kernel(const __grid_constant__ WalkArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const WalkSmem S = walk_layout(a, smem);
    const int tid = threadIdx.x;
    const int h = a.h, w = a.w, sw = a.sw, step = a.step;
    const int depth = a.depth, xdepth = a.xdepth;
    const int hd0 = RT >= 0 ? -RT : a.hd0, vd0 = RT >= 0 ? -RT : a.vd0;
    const int ndh = RT >= 0 ? 2 * RT + 1 : a.hd1 - a.hd0 + 1;
    const int ndv = RT >= 0 ? 2 * RT + 1 : a.vd1 - a.vd0 + 1;
    const int vd1 = vd0 + ndv - 1;
    const int r = -hd0;  // FOLD, CLAMP
    const int lg = a.lg_nq, nq = 1 << lg;
    const int x0 = blockIdx.x * sw, xe = min(x0 + sw, w), ncen = xe - x0;
    const int ncq = (ncen + 3) >> 2;  // groups of four columns holding a frame column
    const int y0 = blockIdx.y * a.run, y1 = min(y0 + a.run, h);
    const size_t plane = (size_t)h * w;
    const float* src = a.img + blockIdx.z * plane;
    float* dst = a.out + blockIdx.z * plane;

    // the staged window (kernels/bloom_walk.py strip_window)
    const int c0 = clampi(x0 + min(hd0, 0), 0, w - 1);
    const int c1 = clampi(xe - 1 + max(hd0 + ndh - 1, 0), 0, w - 1) + 1;
    const int a0 = a.copy16 ? (c0 & ~3) : c0;
    const int nst = a.copy16 ? ((c1 - a0 + 3) & ~3) : c1 - a0;

    // the block's weights
    if constexpr (SRC == TABLE) {
        for (int t = tid >> 5; t < ndh; t += NWARP)
            for (int lx = tid & 31; lx < sw; lx += 32)
                S.tab[t * sw + lx] = lx < ncen ? __ldg(a.hw + (size_t)t * w + x0 + lx) : 0.0f;
    } else if constexpr (RT < 0) {
        const int ne = SRC == FOLD ? r : 0;
        for (int i = tid; i < ndh + 2 * ne; i += NT) {
            float v;
            if (a.tapdev) v = __ldg(a.tapdev + i);
            else v = i < ndh ? a.taps[i] : (i < ndh + ne ? a.edge_l[i - ndh] : a.edge_r[i - ndh - ne]);
            S.tab[i] = v;
        }
    }

    const int pa = clampi(y0 + vd0, 0, h - 1), pb = clampi(y1 - 1 + vd1, 0, h - 1);
    const int stage_buf = step * a.win;
    stage_rows(a, S.stage, src, pa, min(step, pb + 1 - pa), a0, nst);
    cp_commit();
    const bool cpass = a.knee_on || (SRC == TABLE && a.limbs < 3);
    const bool xvec = ((x0 - a0) & 3) == 0;  // the strip starts a 16-byte word of the row
    int nxt = y0;

    for (int d = pa, ci = 0; d <= pb; d += step, ++ci) {
        const int dn = min(step, pb + 1 - d), e = d + dn;
        if (e <= pb)
            stage_rows(a, S.stage + ((ci + 1) & 1) * stage_buf, src, e, min(step, pb + 1 - e),
                       a0, nst);
        cp_commit();
        cp_wait_prior();
        __syncthreads();
        float* st = S.stage + (ci & 1) * stage_buf;
        const int rb = d % depth, xb = d % xdepth;  // ring slots of source row d

        // ---- the pre-knee strip, and the knee in place ----
        if (cpass) {
            for (int k = threadIdx.x >> 5; k < dn; k += NWARP) {
                float* row = st + k * a.win;
                const int xs = xb + k < xdepth ? xb + k : xb + k - xdepth;
                float* xrow = S.xr + xs * sw;
                for (int c = threadIdx.x & 31; c < nst; c += 32) {
                    const float v = row[c];
                    const int lc = c + a0 - x0;
                    if (lc >= 0 && lc < ncen) xrow[lc] = v;
                    row[c] = feed<SRC>(a, v);
                }
            }
            __syncthreads();
        }

        // ---- the horizontal pass, once per source row ----
        for (int it = tid; it < (dn << lg); it += NT) {
            const int k = it >> lg, q = it & (nq - 1);
            if (q >= ncq) continue;
            const float* row = st + k * a.win;
            const int lx = 4 * q;
            if (!cpass) {  // the pre-knee strip straight from the staged row
                const int xs = xb + k < xdepth ? xb + k : xb + k - xdepth;
                float* xp = S.xr + xs * sw + lx;
                const float* rp = row + (x0 - a0) + lx;
                if (xvec) {
                    *reinterpret_cast<float4*>(xp) = *reinterpret_cast<const float4*>(rp);
                } else {
                    #pragma unroll
                    for (int v = 0; v < 4; ++v) if (lx + v < ncen) xp[v] = rp[v];
                }
            }
            float acc[4];
            hpass4<SRC, RT>(a, S.tab, row, a0, x0 + lx, lx, hd0, ndh, acc);
            const int rs = rb + k < depth ? rb + k : rb + k - depth;
            *reinterpret_cast<float4*>(S.ring + rs * sw + lx) =
                make_float4(acc[0], acc[1], acc[2], acc[3]);
        }
        __syncthreads();

        // ---- the output rows whose band is in the ring ----
        const int ye = e >= h ? y1 : max(nxt, min(y1, e - vd1));
        for (int it = tid; it < ((ye - nxt) << lg); it += NT) {
            const int yy = it >> lg, q = it & (nq - 1);
            if (q >= ncq) continue;
            const int y = nxt + yy, lx = 4 * q;
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            const float* col = S.ring + lx;
            // the ring slot of source row s (alive <= s < e): one wrap either way
            auto slot = [&](int s) {
                int t = rb + s - d;
                return t < 0 ? t + depth : (t >= depth ? t - depth : t);
            };
            if (y + vd0 >= 0 && y + vd1 <= h - 1) {
                int sl = slot(y + vd0);
                if constexpr (RT >= 0) {
                    #pragma unroll
                    for (int t = 0; t < 2 * RT + 1; ++t) {
                        const float c = SRC == TABLE ? __ldg(a.vw + (size_t)t * h + y) : a.taps[t];
                        vterm4(acc, c, col + sl * sw, SRC != FOLD && t == 0);
                        sl = sl + 1 == depth ? 0 : sl + 1;
                    }
                } else {
                    for (int t = 0; t < ndv; ++t) {
                        const float c = SRC == TABLE ? __ldg(a.vw + (size_t)t * h + y) : S.tab[t];
                        vterm4(acc, c, col + sl * sw, SRC != FOLD && t == 0);
                        sl = sl + 1 == depth ? 0 : sl + 1;
                    }
                }
            } else if constexpr (SRC == FOLD) {
                for (int t = 0; t < ndv; ++t) {
                    const int sy = y + t - r;
                    if (sy >= 0 && sy < h) vterm4(acc, tap<RT>(a, S.tab, t), col + slot(sy) * sw,
                                                  false);
                }
                if (y < r) vterm4(acc, edge_l<RT>(a, S.tab, ndv, y), col + slot(0) * sw, false);
                if (h - 1 - y < r)
                    vterm4(acc, edge_r<RT>(a, S.tab, ndv, r, h - 1 - y), col + slot(h - 1) * sw,
                           false);
            } else {
                for (int t = 0; t < ndv; ++t) {
                    const float c = SRC == TABLE ? __ldg(a.vw + (size_t)t * h + y)
                                                 : tap<RT>(a, S.tab, t);
                    vterm4(acc, c, col + slot(clampi(y + vd0 + t, 0, h - 1)) * sw, t == 0);
                }
            }
            // the composite with the pre-knee value, and the store
            int xs = xb + y - d;
            xs = xs < 0 ? xs + xdepth : (xs >= xdepth ? xs - xdepth : xs);
            const float4 xv = *reinterpret_cast<const float4*>(S.xr + xs * sw + lx);
            const float o[4] = {clip01(xv.x + a.strength * acc[0]),
                                clip01(xv.y + a.strength * acc[1]),
                                clip01(xv.z + a.strength * acc[2]),
                                clip01(xv.w + a.strength * acc[3])};
            float* op = dst + (size_t)y * w + x0 + lx;
            if (a.vec_ok && lx + 4 <= ncen) {
                *reinterpret_cast<float4*>(op) = make_float4(o[0], o[1], o[2], o[3]);
            } else {
                #pragma unroll
                for (int v = 0; v < 4; ++v) if (lx + v < ncen) op[v] = o[v];
            }
        }
        nxt = ye;
    }
}

// ---- the scratch route: bands too wide for a block ----

// The horizontal pass of every value into a.scratch, reading the plane
// from device memory (the knee applied per read: the same bits).
template <int SRC>
__global__ void __launch_bounds__(NT) bloom_hpass_kernel(const WalkArgs a) {
    const int w = a.w, hd0 = a.hd0, nd = a.hd1 - a.hd0 + 1, r = -hd0;
    const size_t total = (size_t)a.n * a.h * w;
    for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < total;
         i += (size_t)gridDim.x * NT) {
        const int x = (int)(i % w);
        const float* row = a.img + (i - x);
        float s = 0.0f;
        if constexpr (SRC == FOLD) {
            for (int t = 0; t < nd; ++t) {
                const int sx = x + t - r;
                if (sx >= 0 && sx < w) s = s + __ldg(a.tapdev + t) * feed<SRC>(a, row[sx]);
            }
            if (x < r) s = s + __ldg(a.tapdev + nd + x) * feed<SRC>(a, row[0]);
            if (w - 1 - x < r) s = s + __ldg(a.tapdev + nd + r + (w - 1 - x)) * feed<SRC>(a, row[w - 1]);
        } else {
            for (int t = 0; t < nd; ++t) {
                const float c = SRC == TABLE ? __ldg(a.hw + (size_t)t * w + x) : __ldg(a.tapdev + t);
                const float term = c * feed<SRC>(a, row[clampi(x + hd0 + t, 0, w - 1)]);
                s = t == 0 ? term : s + term;
            }
        }
        a.scratch[i] = s;
    }
}

// The vertical pass from a.scratch and the composite.
template <int SRC>
__global__ void __launch_bounds__(NT) bloom_vpass_kernel(const WalkArgs a) {
    const int h = a.h, w = a.w, vd0 = a.vd0, nd = a.vd1 - a.vd0 + 1, r = -vd0;
    const size_t total = (size_t)a.n * h * w;
    for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < total;
         i += (size_t)gridDim.x * NT) {
        const size_t row = i / w;
        const int x = (int)(i - row * w), y = (int)(row % h);
        const float* col = a.scratch + (row - y) * w + x;  // the plane's column x
        float s = 0.0f;
        if constexpr (SRC == FOLD) {
            for (int t = 0; t < nd; ++t) {
                const int sy = y + t - r;
                if (sy >= 0 && sy < h) s = s + __ldg(a.tapdev + t) * col[(size_t)sy * w];
            }
            if (y < r) s = s + __ldg(a.tapdev + nd + y) * col[0];
            if (h - 1 - y < r) s = s + __ldg(a.tapdev + nd + r + (h - 1 - y)) * col[(size_t)(h - 1) * w];
        } else {
            for (int t = 0; t < nd; ++t) {
                const float c = SRC == TABLE ? __ldg(a.vw + (size_t)t * h + y) : __ldg(a.tapdev + t);
                const float term = c * col[(size_t)clampi(y + vd0 + t, 0, h - 1) * w];
                s = t == 0 ? term : s + term;
            }
        }
        a.out[i] = clip01(a.img[i] + a.strength * s);
    }
}

// ---- the fast source: up(down(knee(x))), the oracle's bilinear resizes ----

struct FastSmem {
    float* ring;   // [depth][win] staged source rows (knee'd in place)
    float* xr;     // [xdepth][sw] the strip's pre-knee rows (a knee on; else none)
    float* half;   // [hdepth][hwin] half-res rows
    int* hx_lo; float* hx_f;  // [hwin] the down-column taps of the strip's half-res columns
    int total;
};

// kernels/bloom_walk.py fast_smem computes the same total.
__host__ __device__ inline FastSmem fast_layout(const WalkArgs& a, unsigned char* base) {
    FastSmem s;
    int o = 0;
    s.ring = (float*)(base + o); o += a16(a.depth * a.win * 4);
    s.xr = (float*)(base + o); o += a16(a.xdepth * a.sw * 4);
    s.half = (float*)(base + o); o += a16(a.hdepth * a.hwin * 4);
    s.hx_lo = (int*)(base + o); o += a16(a.hwin * 4);
    s.hx_f = (float*)(base + o); o += a16(a.hwin * 4);
    s.total = o;
    return s;
}

// Stage source rows [d, d + dn) of the plane, columns [a0, a0 + nst),
// into the ring slots from `slot` on (one wrap at most): one warp per row.
__device__ __forceinline__ void stage_ring(const WalkArgs& a, float* ring, int slot,
                                           const float* src, int d, int dn, int a0, int nst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int k = warp; k < dn; k += NWARP) {
        const int sl = slot + k < a.depth ? slot + k : slot + k - a.depth;
        const float* row = src + (size_t)(d + k) * a.w + a0;
        float* dst = ring + sl * a.win;
        if (a.copy16) {
            for (int g = lane * 4; g < nst; g += 32 * 4) cp_async<16>(dst + g, row + g);
        } else {
            for (int g = lane; g < nst; g += 32) cp_async<4>(dst + g, row + g);
        }
    }
}

// A block owns a strip of sw output columns of one plane and walks down a
// run of output rows in chunks of step source rows (the schedule and the
// rings' offsets: kernels/bloom_walk.py fast_plan). Per chunk:
// 1. once every thread is done with the last chunk, the next chunk's raw
//    rows are copied (cp.async) straight into their ring slots, which the
//    plan keeps free, while this chunk is read;
// 2. where a knee is on, the strip's pre-knee values go to their ring,
//    then the knee is applied in place, once per staged value (without a
//    knee the composite reads the staged ring, which the plan then sizes
//    to keep each row until its output row is written);
// 3. each half-res row whose two source rows are now staged: down rows,
//    then down columns (lo * (1 - f) + hi * f), into the half-res ring;
// 4. each output row whose two half-res rows are in that ring: up rows,
//    then up columns, the composite with its pre-knee value, a float4
//    store where W % 4 == 0.
// The order of every lerp is the oracle's resize_bilinear, rows then
// columns, so the output is the plain twin's, bit for bit. Four blocks
// per SM: 64 registers a thread, with no spill (left to itself ptxas
// also took 64 registers, but spilled).
__global__ void __launch_bounds__(NT, 4)
bloom_fast_walk_kernel(const __grid_constant__ WalkArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const FastSmem S = fast_layout(a, smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = a.h, w = a.w, sw = a.sw, step = a.step;
    const int depth = a.depth, xdepth = a.xdepth;
    const int lg = a.lg_nq, nq = 1 << lg;
    const int x0 = blockIdx.x * sw, xe = min(x0 + sw, w), ncen = xe - x0;
    const int ncq = (ncen + 3) >> 2;
    const int y0 = blockIdx.y * a.run;
    const size_t plane = (size_t)h * w;
    const float* src = a.img + blockIdx.z * plane;
    float* dst = a.out + blockIdx.z * plane;
    const int4 win = __ldg(reinterpret_cast<const int4*>(a.fwin) + blockIdx.x);
    const int a0 = win.x, nst = win.y, j0 = win.z, nhw = win.w;
    for (int j = tid; j < nhw; j += NT) {
        S.hx_lo[j] = __ldg(a.fd_xlo + j0 + j);
        S.hx_f[j] = __ldg(a.fd_xf + j0 + j);
    }
    // NT is a multiple of nq: a thread's four output columns are the same
    // in every row, and so are their up-column taps
    const int q = tid & (nq - 1), lx = 4 * q;
    int ul[4];
    float uf[4];
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
        const int c = x0 + min(lx + v, ncen - 1);  // past the frame: not stored
        ul[v] = __ldg(a.fu_xlo + c);
        uf[v] = __ldg(a.fu_xf + c);
    }
    // the pre-knee strip: its own ring with a knee, else the staged ring
    const bool xsep = a.knee_on;
    const float* xbase = xsep ? S.xr + lx : S.ring + (x0 - a0) + lx;
    const int* sched = a.fsched + blockIdx.y * a.sched_stride;
    const int pa = __ldg(sched), pe = __ldg(sched + 1);  // the run's source rows [pa, pe)
    int nh = __ldg(sched + 2);
    int rs = pa % depth, xs = xsep ? pa % xdepth : 0;  // the ring slots of source row d
    stage_ring(a, S.ring, rs, src, pa, min(step, pe - pa), a0, nst);
    cp_commit();
    const bool vec = (w & 3) == 0;  // the window and the strip start 16-byte words
    int nxt = y0;

    for (int d = pa, ci = 0; d < pe; d += step, ++ci) {
        const int dn = min(step, pe - d), e = d + dn;
        const int re = rs + dn < depth ? rs + dn : rs + dn - depth;  // slot of row e
        // this chunk's rows are staged and every thread is done with the
        // last chunk, whose output rows may read the staged ring: only now
        // may the next chunk's copies overwrite the slots the plan frees
        cp_wait_all();
        __syncthreads();
        if (e < pe) {
            stage_ring(a, S.ring, re, src, e, min(step, pe - e), a0, nst);
            cp_commit();
        }

        // ---- the pre-knee strip, and the knee in place ----
        for (int k = warp; xsep && k < dn; k += NWARP) {
            float* row = S.ring + (rs + k < depth ? rs + k : rs + k - depth) * a.win;
            float* xrow = S.xr + (xs + k < xdepth ? xs + k : xs + k - xdepth) * sw;
            if (vec) {
                for (int c = lane * 4; c < nst; c += 32 * 4) {
                    float4 v = *reinterpret_cast<float4*>(row + c);
                    const int lc = c + a0 - x0;
                    if (lc >= 0 && lc < ncen) *reinterpret_cast<float4*>(xrow + lc) = v;
                    v.x = crt::knee(1, a.thr, a.rden, v.x);
                    v.y = crt::knee(1, a.thr, a.rden, v.y);
                    v.z = crt::knee(1, a.thr, a.rden, v.z);
                    v.w = crt::knee(1, a.thr, a.rden, v.w);
                    *reinterpret_cast<float4*>(row + c) = v;
                }
            } else {
                for (int c = lane; c < nst; c += 32) {
                    const float v = row[c];
                    const int lc = c + a0 - x0;
                    if (lc >= 0 && lc < ncen) xrow[lc] = v;
                    row[c] = crt::knee(1, a.thr, a.rden, v);
                }
            }
        }
        if (xsep) __syncthreads();

        // ---- the half-res rows whose two source rows are staged ----
        const int he = __ldg(sched + 3 + 2 * ci), ye = __ldg(sched + 4 + 2 * ci);
        for (int ii = nh + warp; ii < he; ii += NWARP) {
            const int4 t = __ldg(a.fhalf + ii);
            const float* rl = S.ring + t.x - a0;
            const float* rh = S.ring + t.y - a0;
            const float fy = __int_as_float(t.w);
            float* hrow = S.half + t.z;
            for (int j = lane; j < nhw; j += 32) {
                const int xl = S.hx_lo[j], xh = min(xl + 1, w - 1);
                const float dl = crt::lerp_taps(rl[xl], rh[xl], fy);
                const float dh = crt::lerp_taps(rl[xh], rh[xh], fy);
                hrow[j] = crt::lerp_taps(dl, dh, S.hx_f[j]);
            }
        }
        __syncthreads();

        // ---- the output rows whose two half-res rows are in the ring ----
        for (int yy = tid >> lg; q < ncq && yy < ye - nxt; yy += NT >> lg) {
            const int y = nxt + yy;
            const int4 t = __ldg(a.frow + y);
            const float* hl = S.half + t.y - j0;
            const float* hh = S.half + t.z - j0;
            const float fy = __int_as_float(t.w);
            float xa[4];
            if (xsep || vec) {  // 16-byte aligned (kernels/bloom_walk.py fast_windows)
                const float4 xv = *reinterpret_cast<const float4*>(xbase + t.x);
                xa[0] = xv.x; xa[1] = xv.y; xa[2] = xv.z; xa[3] = xv.w;
            } else {
                #pragma unroll
                for (int v = 0; v < 4; ++v) xa[v] = xbase[t.x + min(v, ncen - 1 - lx)];
            }
            float o[4];
            #pragma unroll
            for (int v = 0; v < 4; ++v) {
                const int uh = min(ul[v] + 1, a.w2 - 1);
                const float bl = crt::lerp_taps(crt::lerp_taps(hl[ul[v]], hh[ul[v]], fy),
                                                crt::lerp_taps(hl[uh], hh[uh], fy), uf[v]);
                o[v] = clip01(xa[v] + a.strength * bl);
            }
            float* op = dst + (size_t)y * w + x0 + lx;
            if (a.vec_ok && lx + 4 <= ncen) {
                *reinterpret_cast<float4*>(op) = make_float4(o[0], o[1], o[2], o[3]);
            } else {
                #pragma unroll
                for (int v = 0; v < 4; ++v) if (lx + v < ncen) op[v] = o[v];
            }
        }
        nh = he;
        nxt = ye;
        rs = re;
        if (xsep) xs = xs + dn < xdepth ? xs + dn : xs + dn - xdepth;
    }
}

int launch_fast(const WalkArgs* a, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        bloom_fast_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + a->sw - 1) / a->sw, (a->h + a->run - 1) / a->run, a->n);
    bloom_fast_walk_kernel<<<grid, NT, a->smem, stream>>>(*a);
    return (int)cudaGetLastError();
}

template <int SRC, int RT>
int launch_walk(const WalkArgs* a, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        bloom_walk_kernel<SRC, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a->w + a->sw - 1) / a->sw, (a->h + a->run - 1) / a->run, a->n);
    bloom_walk_kernel<SRC, RT><<<grid, NT, a->smem, stream>>>(*a);
    return (int)cudaGetLastError();
}

// The instance of the band: unrolled at reach 4 (sigma 1.2; and reach 2,
// bloom2's fast band at 1080p and 4K), else the runtime loop.
template <int SRC>
int launch_band(const WalkArgs* a, cudaStream_t stream) {
    const bool sym = a->hd0 == -a->hd1 && a->vd0 == a->hd0 && a->vd1 == a->hd1;
    if (sym && a->hd1 == 4) return launch_walk<SRC, 4>(a, stream);
    if constexpr (SRC == TABLE) {
        if (sym && a->hd1 == 2) return launch_walk<SRC, 2>(a, stream);
    }
    return launch_walk<SRC, RUNTIME>(a, stream);
}

template <int SRC>
int launch_scratch(const WalkArgs* a, cudaStream_t stream) {
    const size_t total = (size_t)a->n * a->h * a->w;
    size_t blocks = (total + NT - 1) / NT;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride loops beyond that
    bloom_hpass_kernel<SRC><<<(unsigned)blocks, NT, 0, stream>>>(*a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bloom_vpass_kernel<SRC><<<(unsigned)blocks, NT, 0, stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crt_walk_launch(const WalkArgs* a, void* stream) {
    if (a->n < 1 || a->n > 65535 || a->h < 1 || a->w < 1 || a->src < FOLD || a->src > FAST)
        return (int)cudaErrorInvalidValue;
    if (a->src == FAST) {
        if (!a->fd_xlo || !a->fd_xf || !a->fu_xlo || !a->fu_xf || !a->fwin || !a->fsched
                || !a->frow || !a->fhalf || a->sw < 4 || a->sw != 4 << a->lg_nq || a->step < 1
                || a->run < 1 || a->depth < 1 || (a->knee_on && a->xdepth < 1) || a->hdepth < 1
                || a->win % 4 || a->hwin < 1 || a->w2 != (a->w / 2 > 1 ? a->w / 2 : 1)
                || fast_layout(*a, nullptr).total != a->smem)
            return (int)cudaErrorInvalidValue;
        return launch_fast(a, static_cast<cudaStream_t>(stream));
    }
    if (a->hd0 > 0 || a->hd1 < 0 || a->vd0 > 0 || a->vd1 < 0 || a->limbs < 1 || a->limbs > 3)
        return (int)cudaErrorInvalidValue;
    if (a->src == TABLE) {
        if (!a->hw || !a->vw) return (int)cudaErrorInvalidValue;
    } else {
        // constant taps: one band -r..r on both axes
        if (a->hd0 != -a->hd1 || a->vd0 != a->hd0 || a->vd1 != a->hd1)
            return (int)cudaErrorInvalidValue;
        if ((2 * a->hd1 + 1 > MAXK || a->scratch_on) && !a->tapdev)
            return (int)cudaErrorInvalidValue;
    }
    const auto s = static_cast<cudaStream_t>(stream);
    if (a->scratch_on) {
        if (!a->scratch) return (int)cudaErrorInvalidValue;
        return a->src == FOLD ? launch_scratch<FOLD>(a, s)
             : a->src == CLAMP ? launch_scratch<CLAMP>(a, s) : launch_scratch<TABLE>(a, s);
    }
    if (a->sw < 4 || a->sw != 4 << a->lg_nq || a->step < 1 || a->run < 1 || a->depth < 1
            || a->xdepth < 1 || a->win % 4 || walk_layout(*a, nullptr).total != a->smem)
        return (int)cudaErrorInvalidValue;
    return a->src == FOLD ? launch_band<FOLD>(a, s)
         : a->src == CLAMP ? launch_band<CLAMP>(a, s) : launch_band<TABLE>(a, s);
}

extern "C" int crt_walk_args_bytes() { return (int)sizeof(WalkArgs); }
