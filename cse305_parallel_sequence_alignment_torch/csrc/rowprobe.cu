// Row-step attribution probes for the H100 (sm_90a), plain C interface
// (wrappers in ops/rowprobe.py).
//
// Five TPU probe kernels timed variants of the K3' row step
// (_rowscan_kernel, cse305_parallel_sequence_alignment_tpu/ops/
// pallas_fill.py:750) to find where a row's time goes. Here they are two
// templates:
//
// replica_kernel<KNOCK, LANE0, LAYOUT, S, U>: the K3' row step in the
// order _rowscan_kernel computes it, start type -1, every la = m,
//   T1 = fb + shift(max(max(P1, P2), P3))
//   T3 = max(max(P1, P2) - gh, P3 - g)
//   T2 = prefixmax(omega) - g*j,  omega = (g*j + shift(max(T1, T3))) - gh
// with column 0's selects (T1 = T2 = -inf, T3 = -h - g*i) and -inf as the
// shifts' fill; it writes the last row's max(max(T1, T2), T3), (B, W), or
// the finals (T1, T2, T3) at (m, lb), (B, 3). It replaces
//   P-perm    perm_kernel of scripts/probes/attrib3_r5.py:108 (LAYOUT, U);
//   P-stripes _kernel of scripts/kern_stripes.py:33 (LANE0 A, S, U);
//   P-knock   _kernel of scripts/kern_attrib.py:37 (KNOCK charcol, bcast,
//             shift1, prefix, prefix7; U);
//   P-ablate  variant_kernel of scripts/probes/attrib_r5.py:65, its
//             row_step modes (KNOCK nochar, shift1, nofb, prefix, not3,
//             noboundary);
//   P-lane0   _kernel of scripts/kern_scalar.py:37 (LANE0 A to E, U).
//   P-sweep   _kernel of scripts/kern_sweep.py:32 (through run_case :70):
//             the charcol step with every column live, C columns a thread
//             (C = 4, 8, 16) against the script's block_b x lane width;
//   P-attrib2 variant_kernel of scripts/probes/attrib2_r5.py:100 (through
//             run_variant :190), its row_step modes:
//               full          the full step, KNOCK 0;
//               pm_unaligned  the strides under 128 alone, a 128-column
//                             window max: prefix7 (_lane_prefix_max(omega,
//                             128) is the same function);
//               pm_aligned    the strides 128 to 2,048 alone: T2 from the
//                             max over columns j, j - 128, j - 256, ...
//                             (KNOCK aligned; at C = 4 column j - 128 is the
//                             same lane of the previous warp, so this is a
//                             per-lane scan across warps, here through a
//                             shared-memory row and one barrier);
//               pm_roll       the full step, the prefix scan wholly through
//                             shared memory (KNOCK smemscan: the warp scan
//                             and its fan-out without shuffles);
//               shift_roll    the full step, the halo wholly through shared
//                             memory (KNOCK smemhalo);
//               full_b32      the full step under __launch_bounds__(544, 2),
//                             two CTAs an SM (KNOCK twocta): the TPU halved
//                             the pairs a program, the H100's lever is the
//                             work an SM holds.
//             pm_roll and shift_roll are pltpu.roll lowerings of the full
//             step on the TPU: the same function, so both give K3''s
//             finals, as does full_b32.
// floor_kernel<MODE, K, L> replaces the raw floors: of variant_kernel
// (attrib_r5.py:118-137) K dependent x = max(x + 0.5, P2) a row (chain),
// or K/4 rounds of four independent + 0.5 and their max (indep); of
// attrib2_r5.py's variant_kernel (:131-166) K dependent x = max(x + 0.5,
// arrs[(k + 1) % L]) over L live arrays (live: P1, P2, P3, then arrs[k %
// 3] + 0.125 k), and K dependent x = max(x + 1, y) in int32 or int16 on
// P1 and P2 converted with saturation (-inf to the type's least value),
// int16 adds wrapping, x back to float32 each row (chain_i32, chain_i16);
// finals at (m, lb).
//
// KNOCK (bits, ops/rowprobe.py KNOCK): charcol and bcast fix A's
// character at 65; nochar takes 65 + (i & 3); shift1 drops both shifts
// (T1 = fb + max3 at j, omega from max(T1, T3) at j); prefix drops the
// prefix max (T2 = omega - g*j); prefix7 takes it over a window of the
// column and the 127 to its left (_lane_prefix_max(omega, 128)); nofb
// sets fb = 1 + 0 * P1(i-1, 0), which is NaN from row 2 on, and every
// max of that instantiation propagates NaN as XLA's does (fmaxf returns
// the other operand); not3 takes T3 = P3 - g; noboundary drops column 0's
// three selects. LANE0: K3P is the above; A to E are kern_scalar's
// forms, none of which selects T1 or T2 at column 0 (the -inf fill does
// that work) and all of which fix A's character at 65 but E, which reads
// it from b's column i-1: A T3(i, 0) = -h - g*i; B -5; C a carried
// column, -h less g each row; D no select. At g = 1, h = 2 (the probes'
// parameters) A, C and D give K3''s rows bit for bit.
//
// Design. One CTA carries S pairs (blockIdx.x * S + s); every pass of the
// row loop steps each pair in turn, so the S dependent chains interleave
// and share every barrier; U unrolls the row loop (the TPU's unroll).
// Each thread keeps C columns of (T1, T2, T3) and their codes in
// registers (C = 4 but for P-sweep's 8 and 16; a CTA takes up to 4,096 / C
// threads at C > 4, so the register cap stays above the need).
// CONTIGUOUS (the layout of csrc/rowcb.cu and csrc/rowscan2.cu): thread t
// owns columns [Ct, Ct + C). A row is three passes:
//   1. T1, T3 and max(T1, T3) of the thread's columns; column Ct - 1's are
//      recomputed from the left neighbour's previous row at Ct - 1 (P1,
//      P2, P3) and its max3 at Ct - 2, a halo the neighbour sent at the
//      end of the previous row (a warp shuffle, or shared memory from the
//      previous warp's lane 31, after a barrier);
//   2. the chunk maximum of omega, a warp scan by shuffles, the warp
//      totals through shared memory after a barrier;
//   3. T2 from the exclusive prefix, recomputing omega.
// So a row has two barriers, as K3' has: the halo's (gone with shift1)
// and the scan's (gone with prefix; prefix7 takes 8, for its sweeps over
// a shared-memory row). Shared exchanges alternate by row parity, so no
// barrier is needed only to protect a buffer. STRIDED (the TPU's plain
// layout, P-perm only): column j on thread j mod T; both shifts go through
// a shared-memory row with a barrier, and the prefix max is log2(W)
// shift-max sweeps over shared-memory rows, a barrier each, as
// _lane_prefix_max (pallas_fill.py:411) does: 15 barriers a row at 2 kb.
//
// Bounds. Inputs are a byte a pair-column and a pair-row, outputs 12 bytes
// a pair or 4 a pair-column: the probes are bound by the row chain, not by
// memory. The full row step is 18 float operations and compares a cell
// (pass 1: two maxima, the base compare, T1's add, T3's two subtractions
// and max, max(T1, T3); pass 2: omega's multiply, add and subtraction,
// the running max; pass 3: those four again, T2's subtraction).
//
// Numerics. float32 with true -inf, built with -fmad=false, gh = g + h
// rounded to float32, omega in K3''s order; at the probes' g = 1, h = 2
// every value is an integer or +-inf (the floors' halves and quarters are
// exact too), so every order gives the same bits.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPadB = 255;   // column 0's code when b starts at column 1
// KNOCK bits (ops/rowprobe.py KNOCK)
constexpr int kCharcol = 1, kBcast = 2, kShift1 = 4, kPrefix = 8,
              kPrefix7 = 16, kNochar = 32, kNofb = 64, kNot3 = 128,
              kNoBoundary = 256, kAligned = 512, kSmemScan = 1024,
              kSmemHalo = 2048, kTwoCta = 4096;
// LANE0 forms (ops/rowprobe.py LANE0)
constexpr int kK3p = 0, kLaneA = 1, kLaneB = 2, kLaneC = 3, kLaneD = 4,
              kLaneE = 5;
constexpr int kContig = 0, kStrided = 1;
// floor_kernel's MODEs (ops/rowprobe.py FLOOR_MODES)
constexpr int kIndep = 0, kChain = 1, kLive = 2, kChainI32 = 3,
              kChainI16 = 4;
constexpr int kFloorC = 4;  // floor_kernel's columns a thread

// the most threads a CTA of replica_kernel takes (ops/rowprobe.py
// threads_for)
__host__ __device__ constexpr int max_threads(int knock, int S, int C) {
    return C != 4 ? 4096 / C
                  : (S > 2 || (knock & kTwoCta) != 0) ? 544 : 1024;
}

// max that propagates NaN (NANP), as XLA's maximum does
template <bool NANP>
__device__ __forceinline__ float vmax(float x, float y) {
    if (NANP) return x != x ? x : (y != y ? y : fmaxf(x, y));
    return fmaxf(x, y);
}

template <bool NANP>
__device__ __forceinline__ float warp_incl_max(float v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v = vmax<NANP>(v, o);
    }
    return v;
}

// the same scan with every exchange through the warp's row of shared
// memory ws (32 floats); on return ws holds the inclusive maxima
__device__ __forceinline__ float warp_incl_max_smem(float v, float* ws) {
    const int lane = threadIdx.x & 31;
    ws[lane] = v;
    __syncwarp();
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const float o = lane >= s ? ws[lane - s] : -CUDART_INF_F;
        __syncwarp();
        v = fmaxf(v, o);
        ws[lane] = v;
        __syncwarp();
    }
    return v;
}

// row 0 at column j, start type -1
__device__ __forceinline__ void row0(int j, float g, float h, float& r1,
                                     float& r2, float& r3) {
    const float NEG = -CUDART_INF_F;
    r1 = j == 0 ? 0.0f : NEG;
    r2 = j == 0 ? NEG : -h - g * (float)j;
    r3 = NEG;
}

// shared-memory rows of T * C floats a replica_kernel instantiation takes
constexpr int smem_rows(int knock, int layout) {
    return layout == kStrided ? 3
           : (knock & (kPrefix7 | kAligned | kSmemHalo)) != 0 ? 2
           : (knock & kSmemScan) != 0 ? 1
                                      : 0;
}

// the row step's body; replica_kernel and replica_kernel_2cta launch it
template <int KNOCK, int LANE0, int LAYOUT, int S, int U, int C>
__device__ __forceinline__ void replica_body(
    const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
    const int32_t* __restrict__ lb, float* __restrict__ out, int B, int m,
    int W, int ext, int out_row, float g, float h, float match,
    float mismatch) {
    constexpr bool NANP = (KNOCK & kNofb) != 0;
    constexpr bool SHIFT = (KNOCK & kShift1) == 0;
    constexpr bool WINDOW = (KNOCK & kPrefix7) != 0;
    constexpr bool ALIGNED = (KNOCK & kAligned) != 0;
    constexpr bool SCAN = (KNOCK & (kPrefix | kPrefix7 | kAligned)) == 0;
    constexpr bool SMSCAN = (KNOCK & kSmemScan) != 0;
    constexpr bool SMHALO = (KNOCK & kSmemHalo) != 0;
    constexpr bool NOT3 = (KNOCK & kNot3) != 0;
    constexpr bool SEL12 = LANE0 == kK3p && (KNOCK & kNoBoundary) == 0;
    constexpr bool COL0 = LANE0 != kLaneD && (KNOCK & kNoBoundary) == 0;
    constexpr bool FIXED_A = LANE0 != kK3p && LANE0 != kLaneE;
    constexpr bool CONST_A = FIXED_A || (KNOCK & (kCharcol | kBcast)) != 0;
    constexpr bool STRIDED = LAYOUT == kStrided;
    static_assert(!STRIDED || (KNOCK == 0 && S == 1 && C == 4),
                  "the strided layout is P-perm's: the full step, one pair");
    static_assert(!(WINDOW || ALIGNED || SMSCAN || SMHALO) ||
                      (S == 1 && C == 4 && !NANP),
                  "the prefix and exchange variants step one pair, C = 4");
    static_assert(!SMSCAN || SCAN, "smemscan varies the scan");
    static_assert(!SMHALO || SHIFT, "smemhalo varies the halo");

    extern __shared__ float rows[];       // smem_rows(KNOCK, LAYOUT) rows
    __shared__ float xh[2][S][32][4];     // halo of each warp's lane 31
    __shared__ float xs[2][S][32];        // each warp's omega maximum
    __shared__ float xfb[2][S];           // nofb: T1 of column 0
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int TC = T * C;
    const int c0 = tid * C;  // CONTIGUOUS: the first column of the thread
    auto col = [&](int c) { return STRIDED ? tid + c * T : c0 + c; };

    int pair[S];
    bool live[S];
    float p1[S][C], p2[S][C], p3[S][C];
    int bc[S][C];
    int bh[S];                           // code at column c0 - 1
    float hp1[S], hp2[S], hp3[S], hm2[S];  // row i-1 at c0-1; max3 at c0-2
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int p = blockIdx.x * S + s;
        live[s] = p < B;
        pair[s] = live[s] ? p : blockIdx.x * S;
        const uint8_t* brow = b + (size_t)pair[s] * (ext ? W : W - 1);
        auto code = [&](int j) {
            if (j >= W) return kPadB;
            if (ext) return (int)brow[j];
            return j == 0 ? kPadB : (int)brow[j - 1];
        };
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = col(c);
            bc[s][c] = code(j);
            row0(j, g, h, p1[s][c], p2[s][c], p3[s][c]);
        }
        bh[s] = c0 > 0 ? code(c0 - 1) : kPadB;
        hp1[s] = hp2[s] = hp3[s] = hm2[s] = NEG;
        if (!STRIDED && c0 > 0) {
            row0(c0 - 1, g, h, hp1[s], hp2[s], hp3[s]);
            float r1, r2, r3;
            row0(c0 - 2, g, h, r1, r2, r3);
            hm2[s] = vmax<NANP>(vmax<NANP>(r1, r2), r3);
        }
        if (tid == 0) xfb[0][s] = 0.0f;  // row 0's T1 at column 0
    }
    float* Mrow = rows;           // STRIDED: max3 of the previous row
    float* Xrow = rows + TC;      // STRIDED: max(T1, T3); sweep rows
    float* Yrow = rows + 2 * TC;
    if (STRIDED) {
#pragma unroll
        for (int c = 0; c < C; ++c)
            Mrow[col(c)] = vmax<NANP>(vmax<NANP>(p1[0][c], p2[0][c]),
                                      p3[0][c]);
    }
    __syncthreads();
    float colc = -h;  // LANE0 C: the carried column

#pragma unroll U
    for (int i = 1; i <= m; ++i) {
        const int par = i & 1;
        const float fi = (float)i;
        if (LANE0 == kLaneC) colc = colc - g;
        const float col0 = LANE0 == kLaneB   ? -5.0f
                           : LANE0 == kLaneC ? colc
                                             : -h - g * fi;
        float m13h[S];  // max(T1, T3) of this row at c0 - 1
        // pass 1: T1, T3, max(T1, T3) (held in p2 until pass 3)
#pragma unroll
        for (int s = 0; s < S; ++s) {
            int ac;
            if (LANE0 == kLaneE)
                ac = b[(size_t)pair[s] * W + (i - 1)];
            else if (CONST_A)
                ac = 65;
            else if (KNOCK & kNochar)
                ac = 65 + (i & 3);
            else
                ac = a[(size_t)pair[s] * m + (i - 1)];
            float fbn = 0.0f;
            if (NANP) fbn = 1.0f + 0.0f * xfb[par ^ 1][s];
            auto fbof = [&](int code) {
                return NANP ? fbn : (code == ac ? match : mismatch);
            };
            float lm3 = NEG;  // max3 of the previous row at j - 1
            m13h[s] = NEG;
            if (SHIFT && !STRIDED && c0 > 0) {
                const float q12 = vmax<NANP>(hp1[s], hp2[s]);
                lm3 = vmax<NANP>(q12, hp3[s]);
                const float t1 = fbof(bh[s]) + hm2[s];  // c0 - 1 > 0
                const float t3 = NOT3 ? hp3[s] - g
                                      : vmax<NANP>(q12 - gh, hp3[s] - g);
                m13h[s] = vmax<NANP>(t1, t3);
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = col(c);
                const float mp12 = vmax<NANP>(p1[s][c], p2[s][c]);
                const float mx = vmax<NANP>(mp12, p3[s][c]);
                if (STRIDED) lm3 = j > 0 ? Mrow[j - 1] : NEG;
                float t1 = fbof(bc[s][c]) + (SHIFT ? lm3 : mx);
                float t3 = NOT3 ? p3[s][c] - g
                                : vmax<NANP>(mp12 - gh, p3[s][c] - g);
                if (SEL12 && j == 0) t1 = NEG;
                if (COL0 && j == 0) t3 = col0;
                lm3 = mx;
                p1[s][c] = t1;
                p3[s][c] = t3;
                p2[s][c] = vmax<NANP>(t1, t3);
                if (STRIDED) Xrow[j] = p2[s][c];
            }
            if (NANP && c0 == 0) xfb[par][s] = p1[s][0];
        }
        if (STRIDED) __syncthreads();

        // omega = (g*j + shift(max(T1, T3))) - gh at the thread's column c
        auto omega = [&](int s, int c, float& mprev) {
            const int j = col(c);
            const float jg = g * (float)j;
            float mleft = SHIFT ? mprev : p2[s][c];
            if (STRIDED) mleft = j > 0 ? Xrow[j - 1] : NEG;
            mprev = p2[s][c];
            return (jg + mleft) - gh;
        };
        // pass 3's end: T2 = pm - g*j from the prefix max pm at column c
        auto finish = [&](int s, int c, float pm) {
            const int j = col(c);
            float t2 = pm - g * (float)j;
            if (SEL12 && j == 0) t2 = NEG;
            p2[s][c] = t2;
            if (STRIDED)
                Mrow[j] = vmax<NANP>(vmax<NANP>(p1[s][c], t2), p3[s][c]);
        };
        if (STRIDED || WINDOW) {
            // sweeps over shared-memory rows, a barrier each
            float* src = STRIDED ? Yrow : rows;
            float* dst = STRIDED ? Xrow : rows + TC;
            float mprev = m13h[0];
#pragma unroll
            for (int c = 0; c < C; ++c) src[col(c)] = omega(0, c, mprev);
            __syncthreads();
            const int reach = WINDOW ? 128 : W;
            for (int sh = 1; sh < reach; sh <<= 1) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int j = col(c);
                    dst[j] = j >= sh ? vmax<NANP>(src[j], src[j - sh])
                                     : src[j];
                }
                __syncthreads();
                float* t = src;
                src = dst;
                dst = t;
            }
#pragma unroll
            for (int c = 0; c < C; ++c) finish(0, c, src[col(c)]);
        } else if (ALIGNED) {
            // the aligned strides alone: the max over j, j - 128, ... from
            // a shared-memory row of omega (alternating by row parity)
            float* om = rows + par * TC;
            float mprev = m13h[0], own[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                own[c] = omega(0, c, mprev);
                om[c0 + c] = own[c];
            }
            __syncthreads();
#pragma unroll
            for (int c = 0; c < C; ++c) {
                float pm = own[c];
                for (int j = c0 + c - 128; j >= 0; j -= 128)
                    pm = fmaxf(pm, om[j]);
                finish(0, c, pm);
            }
        } else if (SCAN) {
            // pass 2: the chunk maximum of omega, the warp scan
            float inwarp[S];
#pragma unroll
            for (int s = 0; s < S; ++s) {
                float mprev = m13h[s], run = NEG;
#pragma unroll
                for (int c = 0; c < C; ++c)
                    run = vmax<NANP>(run, omega(s, c, mprev));
                if (SMSCAN) {
                    float* ws = rows + warp * 32;
                    const float incl = warp_incl_max_smem(run, ws);
                    if (lane == 31) xs[par][s][warp] = incl;
                    inwarp[s] = lane > 0 ? ws[lane - 1] : NEG;
                } else {
                    const float incl = warp_incl_max<NANP>(run);
                    if (lane == 31) xs[par][s][warp] = incl;
                    inwarp[s] = __shfl_up_sync(0xffffffffu, incl, 1);
                    if (lane == 0) inwarp[s] = NEG;
                }
            }
            __syncthreads();
            // pass 3: the exclusive prefix, then the running max and T2
#pragma unroll
            for (int s = 0; s < S; ++s) {
                float wpre = NEG;
                if (SMSCAN) {
                    for (int w = 0; w < warp; ++w)
                        wpre = fmaxf(wpre, xs[par][s][w]);
                } else {
                    wpre = lane < warp ? xs[par][s][lane] : NEG;
#pragma unroll
                    for (int sh = 16; sh > 0; sh >>= 1)
                        wpre = vmax<NANP>(
                            wpre, __shfl_xor_sync(0xffffffffu, wpre, sh));
                }
                float run = vmax<NANP>(wpre, inwarp[s]);
                float mprev = m13h[s];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    run = vmax<NANP>(run, omega(s, c, mprev));
                    finish(s, c, run);
                }
            }
        } else {
            // prefix knocked out: pm = omega
#pragma unroll
            for (int s = 0; s < S; ++s) {
                float mprev = m13h[s];
#pragma unroll
                for (int c = 0; c < C; ++c)
                    finish(s, c, omega(s, c, mprev));
            }
        }
        if (STRIDED) {
            __syncthreads();
        } else if (SMHALO && i < m) {
            // the halo through a shared-memory row: 4 floats a thread
            float* hb = rows + par * TC;
            hb[4 * tid] = p1[0][C - 1];
            hb[4 * tid + 1] = p2[0][C - 1];
            hb[4 * tid + 2] = p3[0][C - 1];
            hb[4 * tid + 3] = fmaxf(fmaxf(p1[0][C - 2], p2[0][C - 2]),
                                    p3[0][C - 2]);
            __syncthreads();
            if (tid > 0) {
                hp1[0] = hb[4 * tid - 4];
                hp2[0] = hb[4 * tid - 3];
                hp3[0] = hb[4 * tid - 2];
                hm2[0] = hb[4 * tid - 1];
            }
        } else if (SHIFT && i < m) {
            // the halo of the next row: P1, P2, P3 at the last column and
            // max3 at the one before, from the left neighbour
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const float v[4] = {
                    p1[s][C - 1], p2[s][C - 1], p3[s][C - 1],
                    vmax<NANP>(vmax<NANP>(p1[s][C - 2], p2[s][C - 2]),
                               p3[s][C - 2])};
                hp1[s] = __shfl_up_sync(0xffffffffu, v[0], 1);
                hp2[s] = __shfl_up_sync(0xffffffffu, v[1], 1);
                hp3[s] = __shfl_up_sync(0xffffffffu, v[2], 1);
                hm2[s] = __shfl_up_sync(0xffffffffu, v[3], 1);
                if (lane == 31) {
#pragma unroll
                    for (int k = 0; k < 4; ++k) xh[par][s][warp][k] = v[k];
                }
            }
            __syncthreads();
            if (lane == 0 && warp > 0) {
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    hp1[s] = xh[par][s][warp - 1][0];
                    hp2[s] = xh[par][s][warp - 1][1];
                    hp3[s] = xh[par][s][warp - 1][2];
                    hm2[s] = xh[par][s][warp - 1][3];
                }
            }
        }
    }

#pragma unroll
    for (int s = 0; s < S; ++s) {
        if (!live[s]) continue;
        const int lB = out_row ? -1 : lb[pair[s]];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = col(c);
            if (out_row && j < W) {
                out[(size_t)pair[s] * W + j] = vmax<NANP>(
                    vmax<NANP>(p1[s][c], p2[s][c]), p3[s][c]);
            } else if (!out_row && j == lB) {
                float* fin = out + (size_t)pair[s] * 3;
                fin[0] = p1[s][c];
                fin[1] = p2[s][c];
                fin[2] = p3[s][c];
            }
        }
    }
}

template <int KNOCK, int LANE0, int LAYOUT, int S, int U, int C>
__global__ void __launch_bounds__(max_threads(KNOCK, S, C))
replica_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               const int32_t* __restrict__ lb, float* __restrict__ out,
               int B, int m, int W, int ext, int out_row, float g, float h,
               float match, float mismatch) {
    replica_body<KNOCK, LANE0, LAYOUT, S, U, C>(
        a, b, lb, out, B, m, W, ext, out_row, g, h, match, mismatch);
}

// twocta (full_b32): the register budget cut for two 544-thread CTAs an SM
template <int KNOCK, int LANE0, int LAYOUT, int S, int U, int C>
__global__ void __launch_bounds__(544, 2)
replica_kernel_2cta(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ b,
                    const int32_t* __restrict__ lb, float* __restrict__ out,
                    int B, int m, int W, int ext, int out_row, float g,
                    float h, float match, float mismatch) {
    replica_body<KNOCK, LANE0, LAYOUT, S, U, C>(
        a, b, lb, out, B, m, W, ext, out_row, g, h, match, mismatch);
}

// float32 to int32 or int16 as XLA converts: saturating, -inf to the
// type's least value (the values here are integers or -inf)
template <int MODE>
__device__ __forceinline__ int to_int(float f) {
    if (MODE == kChainI16)
        return f <= -32768.0f ? -32768 : f >= 32767.0f ? 32767 : (int)f;
    return f <= -2147483648.0f  ? INT_MIN
           : f >= 2147483648.0f ? INT_MAX
                                : (int)f;
}

// x + 1 in the mode's integer type, wrapping as XLA's adds do
template <int MODE>
__device__ __forceinline__ int inc(int x) {
    if (MODE == kChainI16) return (int)(int16_t)(uint16_t)(x + 1);
    return (int)((unsigned)x + 1u);
}

template <int MODE, int K, int L>
__global__ void __launch_bounds__(1024)
floor_kernel(const int32_t* __restrict__ lb, float* __restrict__ out, int m,
             float g, float h) {
    const int pair = blockIdx.x;
    const int c0 = threadIdx.x * kFloorC;
    float p1[kFloorC], p2[kFloorC], p3[kFloorC];
#pragma unroll
    for (int c = 0; c < kFloorC; ++c)
        row0(c0 + c, g, h, p1[c], p2[c], p3[c]);
#pragma unroll 1
    for (int i = 0; i < m; ++i) {
#pragma unroll
        for (int c = 0; c < kFloorC; ++c) {
            // P2 and P3 stay as they are, but the TPU carried them through
            // the loop: keep their work inside it
            float q2 = p2[c], q3 = p3[c];
            asm volatile("" : "+f"(q2), "+f"(q3));
            if (MODE == kChain) {
                float x = p1[c];
#pragma unroll
                for (int k = 0; k < K; ++k) x = fmaxf(x + 0.5f, q2);
                p1[c] = x;
            } else if (MODE == kIndep) {
                float y0 = p1[c], y1 = q2, y2 = q3, y3 = p1[c] + 0.25f;
#pragma unroll
                for (int k = 0; k < K / 4; ++k) {
                    y0 = y0 + 0.5f;
                    y1 = y1 + 0.5f;
                    y2 = y2 + 0.5f;
                    y3 = y3 + 0.5f;
                }
                p1[c] = fmaxf(fmaxf(y0, y1), fmaxf(y2, y3));
            } else if (MODE == kLive) {
                // L live arrays: P1, P2, P3 (or the first L of them), then
                // arrs[k % 3] + 0.125 k
                constexpr int NL = L > 0 ? L : 1;
                float arr[NL];
                arr[0] = p1[c];
                if (NL > 1) arr[1] = q2;
                if (NL > 2) arr[2] = q3;
#pragma unroll
                for (int k = 3; k < NL; ++k)
                    arr[k] = arr[k % 3] + (float)(0.125 * k);
                float x = arr[0];
#pragma unroll
                for (int k = 0; k < K; ++k)
                    x = fmaxf(x + 0.5f, arr[(k + 1) % NL]);
                p1[c] = x;
            } else {
                int x = to_int<MODE>(p1[c]);
                const int y = to_int<MODE>(q2);
#pragma unroll
                for (int k = 0; k < K; ++k) x = max(inc<MODE>(x), y);
                p1[c] = (float)x;
            }
            p2[c] = q2;
            p3[c] = q3;
        }
    }
    const int lB = lb[pair];
#pragma unroll
    for (int c = 0; c < kFloorC; ++c) {
        if (c0 + c == lB) {
            float* fin = out + (size_t)pair * 3;
            fin[0] = p1[c];
            fin[1] = p2[c];
            fin[2] = p3[c];
        }
    }
}

// a replica_kernel call: a launch, or with `blocks` the CTAs an SM holds
struct ReplicaCall {
    const uint8_t* a;
    const uint8_t* b;
    const int32_t* lb;
    float* out;
    int B, m, W, ext, out_row, threads;
    float g, h, match, mismatch;
    cudaStream_t stream;
    int* blocks;
};

template <typename Kernel>
int run_kernel(Kernel kern, size_t smem, int grid, const ReplicaCall& r) {
    if (smem > 0) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (r.blocks)
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            r.blocks, kern, r.threads, smem);
    kern<<<grid, r.threads, smem, r.stream>>>(
        r.a, r.b, r.lb, r.out, r.B, r.m, r.W, r.ext, r.out_row, r.g, r.h,
        r.match, r.mismatch);
    return (int)cudaGetLastError();
}

template <int KNOCK, int LANE0, int LAYOUT, int S, int U, int C>
int run_replica(const ReplicaCall& r) {
    const size_t smem =
        (size_t)smem_rows(KNOCK, LAYOUT) * r.threads * C * sizeof(float);
    const int grid = (r.B + S - 1) / S;
    if constexpr ((KNOCK & kTwoCta) != 0)
        return run_kernel(replica_kernel_2cta<KNOCK, LANE0, LAYOUT, S, U, C>,
                          smem, grid, r);
    else
        return run_kernel(replica_kernel<KNOCK, LANE0, LAYOUT, S, U, C>,
                          smem, grid, r);
}

template <int MODE, int K, int L>
int launch_floor(const int32_t* lb, float* out, int B, int m, int threads,
                 float g, float h, cudaStream_t stream) {
    floor_kernel<MODE, K, L><<<B, threads, 0, stream>>>(lb, out, m, g, h);
    return (int)cudaGetLastError();
}

// the instantiations: (knock, lane0, layout, S, U, C)
int dispatch(const ReplicaCall& r, int knock, int lane0, int layout, int S,
             int U, int C) {
#define RP(KN, L0, LY, SS, UU, CC)                                          \
    if (knock == (KN) && lane0 == (L0) && layout == (LY) && S == (SS) &&   \
        U == (UU) && C == (CC))                                             \
        return run_replica<(KN), (L0), (LY), (SS), (UU), (CC)>(r);
    // P-perm (and the full step of P-knock, P-ablate and P-attrib2 at U = 4)
    RP(0, kK3p, kContig, 1, 4, 4)
    RP(0, kK3p, kContig, 1, 8, 4)
    RP(0, kK3p, kStrided, 1, 4, 4)
    RP(0, kK3p, kStrided, 1, 8, 4)
    // P-stripes (and P-lane0 A at S = 1)
    RP(0, kLaneA, kContig, 1, 4, 4)
    RP(0, kLaneA, kContig, 2, 4, 4)
    RP(0, kLaneA, kContig, 4, 4, 4)
    RP(0, kLaneA, kContig, 8, 4, 4)
    RP(0, kLaneA, kContig, 4, 2, 4)
    RP(0, kLaneA, kContig, 4, 8, 4)
    // P-knock (shift1 and prefix are also P-ablate's noshift and nopm,
    // charcol P-sweep's C = 4, U = 4, prefix7 P-attrib2's pm_unaligned)
    RP(0, kK3p, kContig, 1, 16, 4)
    RP(kCharcol, kK3p, kContig, 1, 4, 4)
    RP(kCharcol | kBcast, kK3p, kContig, 1, 4, 4)
    RP(kPrefix, kK3p, kContig, 1, 4, 4)
    RP(kPrefix7, kK3p, kContig, 1, 4, 4)
    RP(kShift1, kK3p, kContig, 1, 4, 4)
    RP(kPrefix | kShift1, kK3p, kContig, 1, 4, 4)
    RP(kCharcol | kBcast | kPrefix | kShift1, kK3p, kContig, 1, 4, 4)
    // P-ablate
    RP(kNochar, kK3p, kContig, 1, 4, 4)
    RP(kNochar | kShift1, kK3p, kContig, 1, 4, 4)
    RP(kNofb, kK3p, kContig, 1, 4, 4)
    RP(kNot3, kK3p, kContig, 1, 4, 4)
    RP(kNoBoundary, kK3p, kContig, 1, 4, 4)
    // P-lane0
    RP(0, kLaneB, kContig, 1, 4, 4)
    RP(0, kLaneC, kContig, 1, 4, 4)
    RP(0, kLaneD, kContig, 1, 4, 4)
    RP(0, kLaneE, kContig, 1, 4, 4)
    RP(0, kLaneB, kContig, 1, 8, 4)
    RP(0, kLaneC, kContig, 1, 8, 4)
    // P-sweep: charcol at U = 1, 4, 16 and C = 4, 8, 16
    RP(kCharcol, kK3p, kContig, 1, 1, 4)
    RP(kCharcol, kK3p, kContig, 1, 16, 4)
    RP(kCharcol, kK3p, kContig, 1, 1, 8)
    RP(kCharcol, kK3p, kContig, 1, 4, 8)
    RP(kCharcol, kK3p, kContig, 1, 16, 8)
    RP(kCharcol, kK3p, kContig, 1, 1, 16)
    RP(kCharcol, kK3p, kContig, 1, 4, 16)
    RP(kCharcol, kK3p, kContig, 1, 16, 16)
    // P-attrib2
    RP(kAligned, kK3p, kContig, 1, 4, 4)
    RP(kSmemScan, kK3p, kContig, 1, 4, 4)
    RP(kSmemHalo, kK3p, kContig, 1, 4, 4)
    RP(kTwoCta, kK3p, kContig, 1, 4, 4)
#undef RP
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a: (B, m) u8 or null (A's character comes from elsewhere); b: (B, W) u8
// with ext = 1 (b holds every column, 0 included), or (B, W - 1) with
// ext = 0 (column 0 is PAD_B, column j >= 1 is b[j - 1]); lb: (B,) i32,
// lb < W (read when out_row = 0); out: (B, W) f32 (out_row = 1) or (B, 3)
// f32. knock, lane0, layout, S, U, C: one of dispatch's instantiations;
// W at most C x max_threads(knock, S, C) columns. Returns a cudaError_t
// code.
int rowprobe_replica(const uint8_t* a, const uint8_t* b, const int32_t* lb,
                     float* out, int B, int m, int W, int ext, int out_row,
                     int knock, int lane0, int layout, int S, int U, int C,
                     float g, float h, float match, float mismatch,
                     void* stream) {
    if (B == 0) return 0;
    if (C < 2) return (int)cudaErrorInvalidValue;
    const int threads = ((W + C - 1) / C + 31) / 32 * 32;
    if (W < 2 || m < 0 || threads > max_threads(knock, S, C))
        return (int)cudaErrorInvalidValue;
    const ReplicaCall r{a, b, lb, out, B, m, W, ext, out_row, threads,
                        g, h, match, mismatch, (cudaStream_t)stream,
                        nullptr};
    return dispatch(r, knock, lane0, layout, S, U, C);
}

// *blocks = the CTAs of that instantiation an SM holds at a row of W
// columns (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a
// cudaError_t code.
int rowprobe_occupancy(int W, int knock, int lane0, int layout, int S,
                       int U, int C, int* blocks) {
    if (C < 2) return (int)cudaErrorInvalidValue;
    const int threads = ((W + C - 1) / C + 31) / 32 * 32;
    if (W < 2 || threads > max_threads(knock, S, C))
        return (int)cudaErrorInvalidValue;
    const ReplicaCall r{nullptr, nullptr, nullptr, nullptr, 0, 0, W, 0, 0,
                        threads, 0.0f, 0.0f, 0.0f, 0.0f, nullptr, blocks};
    return dispatch(r, knock, lane0, layout, S, U, C);
}

// lb: (B,) i32, lb < W; out: (B, 3) f32 finals after m rows of the floor
// MODE (indep, chain, live, chain_i32, chain_i16) at K operations a row
// over L live arrays (live; 0 for the others); W at most 4 x 1024.
int rowprobe_floor(const int32_t* lb, float* out, int B, int m, int W,
                   int mode, int K, int L, float g, float h, void* stream) {
    if (B == 0) return 0;
    const int threads = ((W + kFloorC - 1) / kFloorC + 31) / 32 * 32;
    if (W < 2 || m < 0 || threads > 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define FL(MD, KK, LL)                                                      \
    if (mode == (MD) && K == (KK) && L == (LL))                             \
        return launch_floor<(MD), (KK), (LL)>(lb, out, B, m, threads, g, h, \
                                              st);
    FL(kChain, 4, 0)
    FL(kChain, 8, 0)
    FL(kChain, 16, 0)
    FL(kChain, 34, 0)
    FL(kIndep, 8, 0)
    FL(kIndep, 16, 0)
    FL(kIndep, 32, 0)
    // P-attrib2's floors
    FL(kLive, 16, 2)
    FL(kLive, 16, 4)
    FL(kLive, 16, 6)
    FL(kLive, 16, 8)
    FL(kChainI32, 16, 0)
    FL(kChainI16, 16, 0)
#undef FL
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
