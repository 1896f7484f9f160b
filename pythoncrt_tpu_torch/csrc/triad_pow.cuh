// The direct-pow triad's three pow sites (csrc/fused.cu, triad_mode 3,
// `--precision fast`) for Hopper, bit for bit the FP64 expressions they
// replace:
//   forward:     f32(exp2(double(g) * log2(double(x))))    x = clip01(m)
//   final log2:  t = f32(log2(double(x)))                  x = clip01(ol)
//   final exp2:  f32(exp2(double(t * e)))                  t * e an f32 product
// with g = f32(triad_gamma) >= 0.1 and e = f32(1 / triad_gamma) <= 10
// (ops/color.py powf_rn and pow_final compute the same in PyTorch).
// Replaces: the per-value FP64 log2 and exp2 chains of PR 8's triad_direct
// (pythoncrt_tpu/kernels/fused.py:601-631, the lut_exact=False branch).
//
// What bounds it: those chains cost 149 FP64 operations per value and
// 115-128 registers an instance, and the card's FP64 rate is half its f32
// rate. Here each site is:
// 1. An f32 fast path, accurate to about 2^-37 relative (double-float:
//    hi + lo pairs of floats, explicit __fmaf_rn for the exact products;
//    -fmad=false only stops contraction):
//    - log2 x = k + lc_i + log2(1 + r): x = 2^k z, z in [0.703125,
//      1.40625), 64 bins of z; r = z invc_i - 1 = (ph - 1) + e exactly
//      (ph = f32(z invc_i), e its error). lc_i = -log2(invc_i) = lh_i + ll_i
//      with lh_i a multiple of 2^-16, so that k + lh_i is exact, and invc_i
//      searched near 1 / (bin centre) so that |ll_i| < 2^-28 (Gal's
//      accurate tables). The two bins around 1 have invc = 1 and lc = 0,
//      so log2 keeps its relative accuracy as x -> 1. ln(1 + r) to degree
//      6 (|r| <= 2^-6.9; 2^-6 only where k <= -1), its first two terms
//      exact, then times 1/ln 2 as a hi + lo pair.
//    - exp2 y = 2^floor(N/64) 2^(j/64) 2^(u/64), N = round(64 y), j = N mod
//      64, |u| <= 1/2: 2^(j/64) from the table as hi + lo, 2^(u/64) - 1 to
//      degree 4 with its linear term exact; the power of two is added to
//      the exponent field.
//    - forward: y = g log2 x carried as hi + lo into exp2.
// 2. A rounding test (Ziv's): the fast value as a normalized pair c + cl;
//    c is the answer when f32(c + cl * ZIV) == c. Sound when the relative
//    distance from c + cl to the FP64 expression's double is below
//    2^-25 (ZIV - 1) / ZIV: the half gap to the next rounding boundary is
//    at least 2^-25 |c|. ZIV = 1 + 2^-11 allows 2^-36; the fast paths'
//    error is about 2^-37.5 at worst (the cubic term's f32 roundings at
//    |r| = 2^-7 near x = 1) and the FP64 expressions' below 2^-44 (log2
//    and exp2 within one double ulp, |y| <= 124). chip_smoke.py [3]
//    sweeps every f32 input of each site's domain against the FP64
//    expression on the card and prints the largest distance it found.
// 3. The FP64 expression itself, out of line (__noinline__: its doubles
//    take no registers of the hot path), for every value the test cannot
//    decide and for subnormal inputs, outputs below 2^-124 and the
//    underflow band. Two inputs are answered exactly without it, since
//    their FP64 value is exact: x = 0 (forward 0, final log2 -inf) and a
//    final exp2 argument <= -151 or a forward one below -151.5 (2^y <
//    2^-151 rounds to 0).
// The tables (TAB floats) live in the block's shared memory in the fused
// kernel (smem_layout<true>): each of the five arrays is 64 floats, two
// per bank, so a warp's read takes at most two wavefronts.

#pragma once

namespace triad {

constexpr int NB = 64;                // log2 bins
constexpr int NE = 64;                // exp2 table: 2^(j/64)
constexpr int TAB = 3 * NB + 2 * NE;  // invc[NB], lh[NB], ll[NB], eh[NE], el[NE]
constexpr int LG_OFF = 0x3f340000;    // bits of 0.703125: bin 38 starts at 1.0

// invc_i; lh_i + ll_i = -log2(invc_i); eh_j + el_j = 2^(j/64) (each f32
// rounded to nearest; tests/test_torch_triad.py recomputes them).
static __device__ const float kTab[TAB] = {
    // invc
    0x1.6a13b4p+0f, 0x1.66111cp+0f, 0x1.624ea2p+0f, 0x1.5e7bbp+0f,
    0x1.5abcb2p+0f, 0x1.571a88p+0f, 0x1.538efcp+0f, 0x1.5017bcp+0f,
    0x1.4caef2p+0f, 0x1.49545cp+0f, 0x1.461b26p+0f, 0x1.42cfcap+0f,
    0x1.3facf8p+0f, 0x1.3c92cep+0f, 0x1.399e1p+0f, 0x1.36965p+0f,
    0x1.33af0cp+0f, 0x1.30c67ap+0f, 0x1.2e0a8ep+0f, 0x1.2b3c9ap+0f,
    0x1.287fcp+0f, 0x1.25e062p+0f, 0x1.2347bep+0f, 0x1.20ac6p+0f,
    0x1.1e2be6p+0f, 0x1.1baad4p+0f, 0x1.1947bcp+0f, 0x1.16e17ap+0f,
    0x1.1496ecp+0f, 0x1.123732p+0f, 0x1.0fe7bap+0f, 0x1.0db6ccp+0f,
    0x1.0b7cap+0f, 0x1.094fc8p+0f, 0x1.0728e4p+0f, 0x1.05127cp+0f,
    0x1.02fc1cp+0f, 0x1p+0f, 0x1p+0f, 0x1.f446e8p-1f,
    0x1.ecb9ccp-1f, 0x1.e5753cp-1f, 0x1.de567ap-1f, 0x1.d781aep-1f,
    0x1.d0c9a2p-1f, 0x1.ca5586p-1f, 0x1.c3f23cp-1f, 0x1.bde6eap-1f,
    0x1.b7d152p-1f, 0x1.b2038p-1f, 0x1.ac5734p-1f, 0x1.a6c70cp-1f,
    0x1.a17c3ep-1f, 0x1.9c28bap-1f, 0x1.9709dep-1f, 0x1.921682p-1f,
    0x1.8d329p-1f, 0x1.886ed8p-1f, 0x1.83c00ep-1f, 0x1.7f44ecp-1f,
    0x1.7ad3f8p-1f, 0x1.767646p-1f, 0x1.724086p-1f, 0x1.6e1ed2p-1f,
    // lh
    -0x1.0014p-1f, -0x1.efb4p-2f, -0x1.e01cp-2f, -0x1.d014p-2f,
    -0x1.c034p-2f, -0x1.b0a4p-2f, -0x1.a14cp-2f, -0x1.9224p-2f,
    -0x1.8314p-2f, -0x1.741cp-2f, -0x1.6594p-2f, -0x1.5694p-2f,
    -0x1.4828p-2f, -0x1.39cp-2f, -0x1.2be4p-2f, -0x1.1d8cp-2f,
    -0x1.0facp-2f, -0x1.01a4p-2f, -0x1.e8a8p-3f, -0x1.cd18p-3f,
    -0x1.b1fp-3f, -0x1.97bp-3f, -0x1.7d78p-3f, -0x1.62e8p-3f,
    -0x1.493p-3f, -0x1.2f38p-3f, -0x1.164p-3f, -0x1.f9ep-4f,
    -0x1.c92p-4f, -0x1.963p-4f, -0x1.643p-4f, -0x1.346p-4f,
    -0x1.036p-4f, -0x1.a64p-5f, -0x1.46p-5f, -0x1.cfcp-6f,
    -0x1.12p-6f, 0x0p+0f, 0x0p+0f, 0x1.11cp-5f,
    0x1.c58p-5f, 0x1.3a9p-4f, 0x1.91ep-4f, 0x1.e6ep-4f,
    0x1.1dd8p-3f, 0x1.4728p-3f, 0x1.70ap-3f, 0x1.9868p-3f,
    0x1.c1p-3f, 0x1.e84p-3f, 0x1.079p-2f, 0x1.1aep-2f,
    0x1.2d7cp-2f, 0x1.4074p-2f, 0x1.52ecp-2f, 0x1.65p-2f,
    0x1.7714p-2f, 0x1.88e8p-2f, 0x1.9aa4p-2f, 0x1.abdp-2f,
    0x1.bd08p-2f, 0x1.ce28p-2f, 0x1.dedcp-2f, 0x1.ef7p-2f,
    // ll
    -0x1.93c538p-36f, 0x1.38cbbcp-32f, 0x1.fd8aa8p-29f, 0x1.44b9f2p-32f,
    0x1.223332p-29f, -0x1.6a2476p-30f, 0x1.f91f88p-29f, 0x1.fff2acp-29f,
    -0x1.edde68p-29f, -0x1.943e76p-29f, -0x1.47b5e8p-29f, -0x1.2c4f56p-30f,
    -0x1.539238p-33f, 0x1.e8c82p-30f, -0x1.b1259cp-30f, 0x1.201fe6p-32f,
    -0x1.9c42fap-30f, 0x1.78b12ep-31f, 0x1.09f618p-30f, -0x1.95019ep-29f,
    0x1.1fb0e4p-29f, -0x1.61934ep-29f, -0x1.9e2d18p-31f, 0x1.69dc0cp-29f,
    0x1.d8dd9ep-29f, 0x1.c96406p-30f, 0x1.9fc4ecp-29f, 0x1.34e2d8p-29f,
    0x1.88996ap-29f, -0x1.607246p-29f, 0x1.a0c588p-29f, -0x1.81b966p-29f,
    -0x1.5474bep-29f, -0x1.565136p-29f, -0x1.8cbc46p-34f, -0x1.d14342p-29f,
    0x1.90b548p-29f, 0x0p+0f, 0x0p+0f, 0x1.628436p-32f,
    -0x1.acd6bcp-30f, -0x1.8f8d16p-30f, -0x1.e24266p-29f, -0x1.e48ab4p-29f,
    -0x1.431da8p-31f, -0x1.77dccap-29f, 0x1.aebdbp-30f, -0x1.717d2cp-31f,
    0x1.d0252p-29f, 0x1.57f15p-33f, 0x1.405abap-29f, 0x1.22dc22p-29f,
    0x1.5c6c74p-29f, -0x1.7ea784p-30f, 0x1.63a83p-29f, -0x1.190d6ep-36f,
    0x1.e2fc0ep-31f, -0x1.5b8894p-29f, -0x1.4cedc2p-30f, 0x1.abcae8p-30f,
    0x1.a1c842p-30f, 0x1.76a86cp-29f, -0x1.cdc7ap-31f, -0x1.b5c2bap-29f,
    // eh
    0x1p+0f, 0x1.02c9a4p+0f, 0x1.059b0ep+0f, 0x1.087452p+0f,
    0x1.0b5586p+0f, 0x1.0e3ec4p+0f, 0x1.11301ep+0f, 0x1.1429aap+0f,
    0x1.172b84p+0f, 0x1.1a35bep+0f, 0x1.1d4874p+0f, 0x1.2063b8p+0f,
    0x1.2387a6p+0f, 0x1.26b456p+0f, 0x1.29e9ep+0f, 0x1.2d285ap+0f,
    0x1.306fep+0f, 0x1.33c08cp+0f, 0x1.371a74p+0f, 0x1.3a7db4p+0f,
    0x1.3dea64p+0f, 0x1.4160a2p+0f, 0x1.44e086p+0f, 0x1.486a2cp+0f,
    0x1.4bfdaep+0f, 0x1.4f9b28p+0f, 0x1.5342b6p+0f, 0x1.56f474p+0f,
    0x1.5ab07ep+0f, 0x1.5e76f2p+0f, 0x1.6247ecp+0f, 0x1.662388p+0f,
    0x1.6a09e6p+0f, 0x1.6dfb24p+0f, 0x1.71f75ep+0f, 0x1.75feb6p+0f,
    0x1.7a1148p+0f, 0x1.7e2f34p+0f, 0x1.82589ap+0f, 0x1.868d9ap+0f,
    0x1.8ace54p+0f, 0x1.8f1aeap+0f, 0x1.93737cp+0f, 0x1.97d82ap+0f,
    0x1.9c4918p+0f, 0x1.a0c668p+0f, 0x1.a5503cp+0f, 0x1.a9e6b6p+0f,
    0x1.ae89fap+0f, 0x1.b33a2cp+0f, 0x1.b7f77p+0f, 0x1.bcc1eap+0f,
    0x1.c199bep+0f, 0x1.c67f12p+0f, 0x1.cb720ep+0f, 0x1.d072d4p+0f,
    0x1.d5818ep+0f, 0x1.da9e6p+0f, 0x1.dfc974p+0f, 0x1.e502eep+0f,
    0x1.ea4afap+0f, 0x1.efa1bep+0f, 0x1.f50766p+0f, 0x1.fa7c18p+0f,
    // el
    0x0p+0f, -0x1.887fap-28f, -0x1.9d4f52p-25f, -0x1.e2990ep-26f,
    0x1.9f3122p-25f, -0x1.a585ccp-25f, -0x1.fdb496p-25f, 0x1.d525bcp-25f,
    -0x1.c15742p-27f, 0x1.6df96ep-25f, -0x1.d2e8cap-25f, 0x1.0c519ap-25f,
    0x1.ceac48p-25f, 0x1.789f38p-26f, -0x1.5c0424p-25f, 0x1.b900c2p-26f,
    0x1.4636e2p-25f, -0x1.b37d2p-25f, -0x1.18aac6p-25f, -0x1.634c02p-25f,
    0x1.824684p-25f, 0x1.f72e2ap-28f, 0x1.8624b4p-30f, -0x1.47d866p-25f,
    -0x1.593abcp-25f, -0x1.2c5a6cp-25f, -0x1.2c561p-25f, -0x1.295b04p-25f,
    -0x1.5bd5ecp-27f, -0x1.4a5bd6p-25f, -0x1.f8b55p-25f, 0x1.2a9112p-27f,
    0x1.9fcef4p-26f, -0x1.cd72e8p-27f, 0x1.1d8beep-25f, -0x1.37b306p-25f,
    -0x1.829fdp-25f, -0x1.261634p-25f, -0x1.accc7cp-26f, -0x1.2edb44p-26f,
    0x1.15506ep-27f, -0x1.baa232p-26f, -0x1.e64744p-25f, -0x1.0d8d84p-31f,
    0x1.51f848p-27f, -0x1.2886a6p-26f, -0x1.b83b54p-25f, -0x1.50c048p-25f,
    -0x1.a94b14p-26f, -0x1.ec3a82p-26f, -0x1.a09438p-25f, -0x1.f687c6p-25f,
    -0x1.3d56b2p-27f, 0x1.cafa2ap-25f, -0x1.8837ccp-27f, 0x1.40f13p-25f,
    -0x1.822dbcp-27f, 0x1.ed9942p-27f, -0x1.908c94p-25f, 0x1.e2cffep-26f,
    0x1.52486cp-27f, 0x1.cc2b44p-25f, -0x1.246ebp-26f, 0x1.9e90d8p-28f,
};

constexpr float KH = 0x1.715476p+0f, KL = 0x1.4ae0cp-26f;     // 1 / ln 2
constexpr float A1H = 0x1.62e43p-7f, A1L = -0x1.05c61p-35f;  // ln 2 / 64
// (ln 2 / 64)^n / n!, n = 2, 3, 4
constexpr float A2 = 0x1.ebfbep-15f, A3 = 0x1.c6b08ep-23f, A4 = 0x1.3b2ab6p-31f;
// ln(1 + r) = r - r^2/2 + r^3 (C3 + C4 r + C5 r^2 + C6 r^3) + O(r^7)
constexpr float C3 = 0x1.555556p-2f, C4 = -0.25f, C5 = 0x1.99999ap-3f, C6 = -0x1.555556p-3f;
constexpr float ZIV = 0x1.002p+0f;   // 1 + 2^-11
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23: adding it rounds to an integer

// A site's fast path: v is the answer when ok; (c + cl) * 2^e2 the value
// the test ran on; exact: v is the FP64 expression's exact value.
struct Fast {
    float v, c, cl;
    int e2;
    bool ok, exact;
};

// The FP64 expressions, as PR 8's triad_direct wrote them: the fallback.
static __device__ __noinline__ float fwd_ref(float x, float g) {
    return (float)exp2((double)g * log2((double)x));
}

static __device__ __noinline__ float log2_ref(float x) { return (float)log2((double)x); }

static __device__ __noinline__ float exp2_ref(float y) { return (float)exp2((double)y); }

// log2 x as hi + lo (not normalized) for a normal x in (0, 1]; any other
// x gives finite garbage.
__device__ __forceinline__ void log2_df(const float* T, float x, float& hi, float& lo) {
    const int ix = __float_as_int(x);
    const int tmp = ix - LG_OFF;
    const int i = (tmp >> 17) & (NB - 1);
    const int k = tmp >> 23;
    const float z = __int_as_float(ix - (tmp & (int)0xff800000));
    const float invc = T[i], lh = T[NB + i], ll = T[2 * NB + i];
    const float ph = __fmul_rn(z, invc);
    const float e = __fmaf_rn(z, invc, -ph);
    const float r = __fadd_rn(ph, -1.0f);   // exact: ph in [1/2, 2]
    // ln(1 + r + e) = (a + ae) - se/2 + e (1 - r + r^2) + r^3 Q(r) + ...,
    // a + ae = r - s/2 and s + se = r^2 exactly
    const float s = __fmul_rn(r, r);
    const float se = __fmaf_rn(r, r, -s);
    const float a = __fmaf_rn(-0.5f, s, r);
    const float ae = __fmaf_rn(-0.5f, s, __fadd_rn(r, -a));
    const float q = __fmaf_rn(__fmaf_rn(__fmaf_rn(C6, r, C5), r, C4), r, C3);
    const float r3 = __fmaf_rn(s, r, __fmul_rn(se, r));
    float l = __fmaf_rn(-0.5f, se, ae);
    l = __fmaf_rn(e, __fadd_rn(s, -r), __fadd_rn(l, e));
    l = __fmaf_rn(r3, q, l);
    // w = (a + l) / ln 2
    const float wh = __fmul_rn(a, KH);
    float wl = __fmaf_rn(a, KH, -wh);
    wl = __fmaf_rn(a, KL, wl);
    wl = __fmaf_rn(l, KH, wl);
    // k + lh exactly, then + w: |k + lh| >= |wh| or k + lh == 0 (fast two-sum)
    const float sh = __fadd_rn(__fadd_rn(__int_as_float(0x4b400000 + k), -MAGIC), lh);
    hi = __fadd_rn(sh, wh);
    lo = __fadd_rn(__fadd_rn(__fadd_rn(wh, -__fadd_rn(hi, -sh)), wl), ll);
}

// 2^(yh + yl) = (hi + lo) * 2^(sc >> 23) for yh in [-124, 0]; DFIN: yl is
// carried (else 0).
template <bool DFIN>
__device__ __forceinline__ void exp2_df(const float* T, float yh, float yl, float& hi, float& lo,
                                        int& sc) {
    const float t = __fmaf_rn(yh, 64.0f, MAGIC);
    const float n = __fadd_rn(t, -MAGIC);
    const float u = __fmaf_rn(yh, 64.0f, -n);   // exact, |u| <= 1/2
    const int nb = __float_as_int(t);           // MAGIC's bits + N
    const int j = nb & (NE - 1);
    sc = (nb << 17) & (int)0xff800000;          // floor(N / 64) in the exponent field
    float uf = u, ul = 0.0f;
    if constexpr (DFIN) {
        ul = __fmul_rn(yl, 64.0f);
        uf = __fadd_rn(u, ul);
    }
    // 2^(u/64) - 1 = ph + pl
    const float q = __fmul_rn(__fmaf_rn(__fmaf_rn(uf, A4, A3), uf, A2), uf);
    const float ph = __fmul_rn(A1H, u);
    float pl = __fmaf_rn(A1H, u, -ph);
    if constexpr (DFIN) pl = __fmaf_rn(A1H, ul, pl);
    pl = __fmaf_rn(uf, __fadd_rn(q, A1L), pl);
    // (eh + el)(1 + ph + pl)
    const float eh = T[3 * NB + j], el = T[3 * NB + NE + j];
    hi = __fmaf_rn(eh, ph, eh);
    float l = __fmaf_rn(eh, ph, __fadd_rn(eh, -hi));
    l = __fmaf_rn(eh, pl, l);
    lo = __fmaf_rn(el, ph, __fadd_rn(l, el));
}

// hi + lo normalized to c + cl and Ziv's test on it.
__device__ __forceinline__ bool decided(float hi, float lo, float& c, float& cl) {
    c = __fadd_rn(hi, lo);
    cl = __fadd_rn(lo, -__fadd_rn(c, -hi));
    return __fmaf_rn(cl, ZIV, c) == c;
}

__device__ __forceinline__ Fast fwd_fast(const float* T, float x, float g) {
    float lh, ll, hi, lo;
    int sc;
    log2_df(T, x, lh, ll);
    const float yh = __fmul_rn(g, lh);
    const float yl = __fmaf_rn(g, ll, __fmaf_rn(g, lh, -yh));
    exp2_df<true>(T, yh, yl, hi, lo, sc);
    Fast f;
    const bool ziv = decided(hi, lo, f.c, f.cl);
    f.e2 = sc >> 23;
    const bool normal = x >= 0x1p-126f;   // else yh is not g log2 x
    f.exact = x == 0.0f || (normal && yh < -151.5f);
    f.ok = f.exact || (normal && yh >= -124.0f && ziv);
    f.v = f.exact ? 0.0f : __int_as_float(__float_as_int(f.c) + sc);
    return f;
}

__device__ __forceinline__ Fast log2_fast(const float* T, float x) {
    float hi, lo;
    log2_df(T, x, hi, lo);
    Fast f;
    const bool ziv = decided(hi, lo, f.c, f.cl);
    f.e2 = 0;
    f.exact = x == 0.0f;
    f.ok = f.exact || (x >= 0x1p-126f && ziv);
    f.v = f.exact ? __int_as_float(0xff800000) : f.c;
    return f;
}

__device__ __forceinline__ Fast exp2_fast(const float* T, float y) {
    float hi, lo;
    int sc;
    exp2_df<false>(T, y, 0.0f, hi, lo, sc);
    Fast f;
    const bool ziv = decided(hi, lo, f.c, f.cl);
    f.e2 = sc >> 23;
    f.exact = y <= -151.0f;
    f.ok = f.exact || (y >= -124.0f && ziv);
    f.v = f.exact ? 0.0f : __int_as_float(__float_as_int(f.c) + sc);
    return f;
}

// The sites as the fused kernel calls them, on a pixel's three planes, x in
// [0, 1]: the fast paths first, then one branch for the three planes'
// fallbacks, taken when any of them needs one.
__device__ __forceinline__ void pow_fwd3(const float* T, const float x[3], float g, float v[3]) {
    Fast f[3];
    #pragma unroll
    for (int p = 0; p < 3; ++p) {
        f[p] = fwd_fast(T, x[p], g);
        v[p] = f[p].v;
    }
    if (!(f[0].ok && f[1].ok && f[2].ok)) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            if (!f[p].ok) v[p] = fwd_ref(x[p], g);
    }
}

// f32(exp2(f32(log2(x)) * e)): the final log2 site, the f32 product, the
// final exp2 site.
__device__ __forceinline__ void pow_final3(const float* T, const float x[3], float e, float v[3]) {
    Fast f[3];
    float t[3], y[3];
    #pragma unroll
    for (int p = 0; p < 3; ++p) {
        f[p] = log2_fast(T, x[p]);
        t[p] = f[p].v;
    }
    if (!(f[0].ok && f[1].ok && f[2].ok)) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            if (!f[p].ok) t[p] = log2_ref(x[p]);
    }
    #pragma unroll
    for (int p = 0; p < 3; ++p) {
        y[p] = __fmul_rn(t[p], e);
        f[p] = exp2_fast(T, y[p]);
        v[p] = f[p].v;
    }
    if (!(f[0].ok && f[1].ok && f[2].ok)) {
        #pragma unroll
        for (int p = 0; p < 3; ++p)
            if (!f[p].ok) v[p] = exp2_ref(y[p]);
    }
}

}  // namespace triad
