// Two-carry Gotoh row-sweep score fill for the H100 (sm_90a), plain C
// interface (wrappers in ops/rowscan2.py).
//
// K3'' rowscan2_fill replaces the TPU kernel _rowscan2_kernel
// (cse305_parallel_sequence_alignment_tpu/ops/pallas_fill.py:896, through
// _pallas_rowscan2 :1010 and pallas_rowscan2_score_batch :1040): the global
// score fill whose row carry is (H, T3), H = max(T1, T2, T3), in place of
// the three tables, since the next row reads the previous one only through
// H (T1's diagonal, T3's open) and T3 (T3's extend). Finals (T1, T2, T3)
// at (la, lb) per pair, per-pair start types (the JAX kernel takes one
// static start type a call, and its uniform-la branch, every la = m, gives
// the same finals as its ragged one; this kernel captures at row la in
// both cases).
//
// P-dual (pairs = 2) replaces dual_kernel of the TPU probe
// scripts/probes/dual_halostair_r4.py:68 (through dual :136): two
// independent pairs in one kernel, each a uniform-la K3'' with start type
// -1, interleaved to hide the dependent chain of a row. Here one CTA
// carries two pairs: every thread steps both pairs' columns in each pass,
// and the two share every block barrier. The wrapper passes la = m and
// start type -1; finals come out in input pair order, and an odd B leaves
// the last CTA one live pair (the second stream recomputes the first and
// stores nothing).
//
// Design. One CTA per pair (or two); the row loop runs inside the block.
// Thread t owns the C columns [t*C, t*C + C) and keeps their H and T3, and
// its C characters of B, in registers across the whole sweep: no row
// buffer in shared or global memory. A row takes three passes over the
// thread's columns:
//   1. T1 = f(A[i], B[j]) + H(i-1, j-1), T3 = max(H(i-1, j) - gh,
//      T3(i-1, j) - g) (column 0: the start type's boundary), m13 =
//      max(T1, T3) kept in place of H;
//   2. the chunk maximum of omega = (g*j - gh) + m13(j-1), after the left
//      neighbour's last m13 arrives (a warp shuffle, or shared memory from
//      the previous warp's lane 31 after a block barrier); a warp scan and
//      the warp totals through shared memory after a second barrier give
//      each thread the maximum of omega over every column left of its
//      chunk (exclusive);
//   3. T2 = prefixmax(omega) - g*j from that exclusive maximum, recomputing
//      omega, and H = max(m13, T2).
// H(i, c0 - 1), which the next row's T1 needs from the left neighbour, is
// max(m13(c0 - 1), excl - g*(c0 - 1)): the neighbour's T2 there is the
// exclusive prefix maximum less its jg, so no third exchange is needed.
// Two block barriers a row, as in K3' (csrc/rowcb.cu), but no shared-
// memory traffic for the row itself.
//
// Bounds. No dirs: inputs (two bytes a pair-column and a pair-row) and 12
// bytes of finals a pair, so the fill is bound by the dependent chain of a
// row (three passes of C columns and two barriers), not by memory; 16
// float operations and compares a cell against the fp32 peak (pass 1: the
// base compare, T1's add, T3's two subtractions and max, m13's max; pass
// 2: omega's multiply, subtraction and add, the running max; pass 3: the
// same four, T2's subtraction, H's max).
//
// Numerics. float32 with true -inf, built with -fmad=false, gh = g + h
// rounded to float32. What XLA:CPU (without FMA contraction) runs for
// _rowscan2_kernel, in both its uniform-la and its ragged branch, folds
// both of the kernel's x - g - h into x - gh: T3 = max(H - gh, T3 - g),
// omega = (g*j - gh) + m13(j-1), the free modes' order of K1'. At integral
// (or dyadic) g, h the finals equal K3''s three-table twin K3' bit for
// bit; at g = 0.3, h = 1.7 omega's order rounds some apart (tests pin the
// count). Column 0's T1 and T2 come out -inf from the -inf shift fill
// (-inf + finite), as in the JAX kernel, without a select.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPadB = 255;

__device__ __forceinline__ float warp_incl_max(float v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v = fmaxf(v, o);
    }
    return v;
}

// Row 0 at column j for start type st (quirk kept: +2 acts as -1 on row 0).
__device__ __forceinline__ void row0(int st, int j, float g, float h,
                                     float& r1, float& r2, float& r3) {
    const float NEG = -CUDART_INF_F;
    r1 = r2 = r3 = NEG;
    if (j == 0) {
        r1 = (st == 1 || st == -1) ? 0.0f : NEG;
        r2 = (st == -2) ? 0.0f : NEG;
        r3 = (st == -3) ? 0.0f : NEG;
    } else {
        const float jg = g * (float)j;
        r2 = (st == -2) ? -jg : ((st == 1 || st == 3) ? NEG : -h - jg);
    }
}

// Threads above 512 only for the narrowest chunks, whose registers fit.
template <int C, int NP>
__global__ void __launch_bounds__(C <= 4 ? 1024 : 512)
rowscan2_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                const int32_t* __restrict__ la,
                const int32_t* __restrict__ lb,
                const int32_t* __restrict__ st, float* __restrict__ out,
                int B, int m, int n, float g, float h, float match,
                float mismatch) {
    __shared__ float xm[NP][32];  // each warp's last m13 of the row
    __shared__ float xs[NP][32];  // each warp's omega maximum
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int c0 = tid * C;

    int pair[NP], sta[NP], lA[NP], lB[NP];
    bool live[NP];
    float Hc[NP][C], T3c[NP][C];
    int bc[NP][C];
    float hl[NP];  // H of the previous row at column c0 - 1
    int acn[NP];   // A's character of the next row
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        const int p = blockIdx.x * NP + k;
        live[k] = p < B;
        pair[k] = live[k] ? p : blockIdx.x * NP;
        sta[k] = st[pair[k]];
        lA[k] = la[pair[k]];
        lB[k] = lb[pair[k]];
        const uint8_t* brow = b + (size_t)pair[k] * n;
        float* fin = out + (size_t)pair[k] * 3;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = c0 + c;
            bc[k][c] = (j >= 1 && j <= n) ? (int)brow[j - 1] : kPadB;
            float r1, r2, r3;
            row0(sta[k], j, g, h, r1, r2, r3);
            Hc[k][c] = fmaxf(fmaxf(r1, r2), r3);
            T3c[k][c] = r3;
            if (live[k] && lA[k] == 0 && j == lB[k]) {
                fin[0] = r1;
                fin[1] = r2;
                fin[2] = r3;
            }
        }
        hl[k] = NEG;
        if (c0 > 0) {
            float r1, r2, r3;
            row0(sta[k], c0 - 1, g, h, r1, r2, r3);
            hl[k] = fmaxf(fmaxf(r1, r2), r3);
        }
        acn[k] = m > 0 ? (int)a[(size_t)pair[k] * m] : 0;
    }

    for (int i = 1; i <= m; ++i) {
        const float fi = (float)i;
        float mlast[NP], ml[NP];
        // pass 1: T1, T3, m13
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int ac = acn[k];
            if (i < m) acn[k] = a[(size_t)pair[k] * m + i];  // prefetch
            const int s = sta[k];
            const float col0 = (s == -3) ? -g * fi
                             : ((s == 1 || s == 2) ? NEG : -h - g * fi);
            const bool cap = live[k] && i == lA[k];
            float* fin = out + (size_t)pair[k] * 3;
            float hleft = hl[k];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = c0 + c;
                const float hp = Hc[k][c];
                const float fb = bc[k][c] == ac ? match : mismatch;
                const float t1 = fb + hleft;
                const float t3 = j == 0 ? col0
                                        : fmaxf(hp - gh, T3c[k][c] - g);
                hleft = hp;
                Hc[k][c] = fmaxf(t1, t3);
                T3c[k][c] = t3;
                if (cap && j == lB[k]) {
                    fin[0] = t1;
                    fin[2] = t3;
                }
            }
            mlast[k] = Hc[k][C - 1];
        }
        // the left neighbour's last m13 (column c0 - 1)
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            ml[k] = __shfl_up_sync(0xffffffffu, mlast[k], 1);
            if (lane == 31) xm[k][warp] = mlast[k];
        }
        __syncthreads();
        // pass 2: the chunk maximum of omega, and the warp scan
        float inwarp[NP];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            if (lane == 0) ml[k] = warp > 0 ? xm[k][warp - 1] : NEG;
            float mprev = ml[k], run = NEG;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float jg = g * (float)(c0 + c);
                run = fmaxf(run, (jg - gh) + mprev);
                mprev = Hc[k][c];
            }
            const float incl = warp_incl_max(run);
            if (lane == 31) xs[k][warp] = incl;
            inwarp[k] = __shfl_up_sync(0xffffffffu, incl, 1);
            if (lane == 0) inwarp[k] = NEG;
        }
        __syncthreads();
        // pass 3: T2 from the exclusive prefix, then H
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            float wpre = lane < warp ? xs[k][lane] : NEG;
#pragma unroll
            for (int s = 16; s > 0; s >>= 1)
                wpre = fmaxf(wpre, __shfl_xor_sync(0xffffffffu, wpre, s));
            const float excl = fmaxf(wpre, inwarp[k]);
            const bool cap = live[k] && i == lA[k];
            float* fin = out + (size_t)pair[k] * 3;
            float mprev = ml[k], run = excl;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = c0 + c;
                const float jg = g * (float)j;
                run = fmaxf(run, (jg - gh) + mprev);
                const float t2 = run - jg;
                mprev = Hc[k][c];
                Hc[k][c] = fmaxf(mprev, t2);
                if (cap && j == lB[k]) fin[1] = t2;
            }
            hl[k] = c0 > 0 ? fmaxf(ml[k], excl - g * (float)(c0 - 1)) : NEG;
        }
    }
}

template <int C, int NP>
int launch(const uint8_t* a, const uint8_t* b, const int32_t* la,
           const int32_t* lb, const int32_t* st, float* out, int B, int m,
           int n, int threads, float g, float h, float match,
           float mismatch, cudaStream_t stream) {
    const int blocks = (B + NP - 1) / NP;
    rowscan2_kernel<C, NP><<<blocks, threads, 0, stream>>>(
        a, b, la, lb, st, out, B, m, n, g, h, match, mismatch);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (B, m) u8; b: (B, n) u8; la/lb/st: (B,) i32, la <= m, lb <= n; out:
// (B, 3) f32 finals (T1, T2, T3) at (la, lb), set to -inf by the caller
// (a pair whose la exceeds m keeps it). C columns per thread, one of 4, 8,
// 16, 32; threads a multiple of 32 with threads * C >= n + 1, at most 1024
// for C = 4 and 512 otherwise; pairs per CTA 1 (K3'') or 2 (P-dual).
// Returns a cudaError_t code.
int rowscan2_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
                  const int32_t* lb, const int32_t* st, float* out, int B,
                  int m, int n, int C, int threads, int pairs, float g,
                  float h, float match, float mismatch, void* stream) {
    if (B == 0) return 0;
    const int cap = C <= 4 ? 1024 : 512;
    if (threads < 32 || threads > cap || threads % 32 != 0 ||
        (long long)threads * C < n + 1 || (pairs != 1 && pairs != 2))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define RS2_LAUNCH(CC)                                                      \
    if (C == CC)                                                            \
        return pairs == 1                                                   \
                   ? launch<CC, 1>(a, b, la, lb, st, out, B, m, n, threads, \
                                   g, h, match, mismatch, s)                \
                   : launch<CC, 2>(a, b, la, lb, st, out, B, m, n, threads, \
                                   g, h, match, mismatch, s)
    RS2_LAUNCH(4);
    RS2_LAUNCH(8);
    RS2_LAUNCH(16);
    RS2_LAUNCH(32);
#undef RS2_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
