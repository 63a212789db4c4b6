// Banded Gotoh fills for the H100 (sm_90a), plain C interface.
//
// Two kernels (wrappers in ops/banded.py):
//   band_rows_kernel<C>, K12d band_dirs (rows in registers, for the
//     H100): replaces _banded_dirs_kernel
//     (cse305_parallel_sequence_alignment_tpu/ops/pallas_banded.py:161,
//     with_runs=True), the band-layout uint16 dirs16+runs cell of every
//     (i, j) at dirs[i, pair, j - i + w_lo] and the finals (T1, T2, T3) at
//     each pair's (la, lb), for bands of up to 4,096 lanes;
//   band_kernel<DIRS>, rows in shared memory: DIRS = false is K12s
//     band_score (replaces _banded_kernel, same file, :42, the finals
//     alone); DIRS = true is K12d for bands wider than 4,096 lanes (global
//     scratch), and the "before" of K12d's comparison on the card.
//
// Band geometry (ops/banded.py of the JAX package): lane l in [0, W),
// W = w_lo + w_hi + 1, of row i holds column j = i - w_lo + l; the window
// slides one column right per row, so the diagonal predecessor (i-1, j-1)
// is the same lane of the previous row, the upper one (i-1, j) lane l+1 of
// the previous row, and the left one (i, j-1) lane l-1 of the same row.
// Lanes with j outside [1, n] (n the bucket width) are -inf, apart from
// T3's column-0 boundary; row 0 holds the start-type boundary on its lanes
// with 0 <= j <= n. B's character at lane l of row i is b[j - 1], read
// directly; the TPU kernel's sliding character window and its '-' slot
// are Mosaic workarounds with no counterpart here.
//
// Design of band_kernel. One CTA per pair, the row loop inside
// the block; each thread owns a contiguous chunk of C lanes. The previous
// and the current band row (T1/T2/T3) are double-buffered by row parity in
// shared memory, or in global scratch that the wrapper allocates when W is
// too wide, so the upper read of lane l+1 (another thread's lane) goes to
// the other buffer. A thread recomputes its left neighbour's max(T1, T3)
// from the previous row (lanes c0-1 and c0) instead of waiting for it.
// T2's in-window prefix max is a block-wide scan, as in csrc/rowcb.cu:
// each thread's running max over its chunk, a warp shuffle scan, the warp
// totals through shared memory. The run state of a lane (run length,
// after-run code) stays in that lane from row to row, since a diagonal run
// keeps its band lane; it lives in one buffer that only the lane's owner
// touches. Bytes and run state are masked to each pair's rectangle (j <=
// lb, i <= la). Two barriers a row and a scalar 2-byte store a lane.
//
// Design of band_rows_kernel, after csrc/rowfill.cu:
// 1. Rows in registers. Thread t owns lanes [C t, C t + C) (C = 4, 8 or
//    16) and keeps their T1, T2, T3 and previous-row words (two to a
//    register) in registers from row to row. A diagonal run keeps its
//    lane, so the run state is the owner's previous word: no buffer.
//    B's codes of the thread's lanes slide one lane a row, four to a
//    register (a funnel shift and one prefetched byte a row).
// 2. One barrier a row, the scan's. The left lane c0 - 1 (omega at c0
//    and d2 there) is recomputed each row from the previous row's max3 at
//    c0 - 1 and the thread's own lane c0, and its T2 is the thread's own
//    exclusive prefix minus g*j; so the next row's max3 at c0 - 1 is the
//    thread's own too, and nothing comes from the left. The upper
//    neighbour of the last lane (lane c0 + C of the previous row) comes
//    from the next thread by __shfl_down_sync; at a warp edge lane 0 of
//    the next warp puts its T1 and T3 into shared memory before the
//    barrier, and lane 31 rebuilds that lane's T2 after it from its own
//    last max(T1, T3) (that lane's omega) and the prefix of the warps up to
//    its own (the warp totals, and its inclusive total).
// 3. Stores. A thread's C words of a row are one vector store (two at C =
//    16) into dirs rows pitched to a multiple of 8 lanes (W = 1,329 is
//    odd); the wrapper returns the view of the first W lanes, and K2 in
//    band layout reads the pitch (ops/device_walk.py row_pitch).
// 4. Geometry (C, threads) comes from ops/banded.py band_geometry, a pure
//    function of (B, W) built on this card's timings; bands wider than
//    4,096 lanes stay on band_kernel<true> with global scratch.
//
// Bounds. Per cell 16 float operations and compares (K12s) or 31 (K12d,
// with three argmax3 and the h terms of the codes) and, in K12d, one
// 2-byte store: 256 pairs x 2 kb at W = 129 is ~67 M cells, ~34 MB of
// dirs, about 0.04 ms of HBM bandwidth, so the fill is bound by each
// row's serial chain and its barriers, as csrc/rowcb.cu is. A single
// long pair is one CTA on one SM: its time is m rows x (a row's latency),
// not the card's rate; many pairs fill the card.
//
// Numerics. float32 with true -inf, built with -fmad=false, in the Pallas
// kernel's operation order, gh = g + h rounded to float32 (XLA folds the
// JAX kernels' x - g - h):
//   T1 = fb + max(max(T1, T2), T3)(prev, same lane)
//   T3 = max(max(T1, T2)(prev, l+1) - gh, T3(prev, l+1) - g)
//   omega = (g*j + max(T1, T3)(l-1)) - gh,  T2 = prefixmax(omega) - g*j
// Direction codes use the tie order T1 >= T2 >= T3 (quirk B3): d1 =
// argmax3 of the previous row at the same lane, d3 = argmax3(up T1, up
// T2, up T3 + h), d2 = argmax3(T1 - h, T2, T3 - h) of lane l-1 (0 at
// lane 0).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRunCap = 255;
constexpr int kHeadBytes = 512;  // warp totals of the block scan

__device__ __forceinline__ int argmax3(float c1, float c2, float c3) {
    return (c1 >= c2 && c1 >= c3) ? 0 : (c2 >= c3 ? 1 : 2);
}

__device__ __forceinline__ float warp_incl_max(float v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        float o = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v = fmaxf(v, o);
    }
    return v;
}

template <bool DIRS>
__global__ void __launch_bounds__(kMaxThreads)
band_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
            const int32_t* __restrict__ st, uint16_t* __restrict__ dirs,
            float* __restrict__ out, char* __restrict__ scratch, int B,
            int m, int n, int w_lo, int W, int C, float g, float h,
            float match, float mismatch) {
    extern __shared__ __align__(16) char smem[];
    const int pair = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h

    // shared layout: warp totals (32 f32) in the 512-byte head | row
    // buffers T[buf][table][lane] (24 W bytes) and, for DIRS, the run
    // state (2 W bytes), when they fit (else in global scratch)
    float* wsum = reinterpret_cast<float*>(smem);
    const size_t row_bytes = (size_t)W * (DIRS ? 26 : 24);
    const size_t row_stride_bytes = (row_bytes + 15) & ~(size_t)15;
    char* rowmem = scratch ? scratch + (size_t)pair * row_stride_bytes
                           : smem + kHeadBytes;
    float* T = reinterpret_cast<float*>(rowmem);
    uint16_t* S = reinterpret_cast<uint16_t*>(rowmem + (size_t)W * 24);
    auto row = [&](int buf, int k) { return T + ((size_t)buf * 3 + k) * W; };

    const int sta = st[pair];
    const int lA = la[pair], lB = lb[pair];
    const uint8_t* arow = a + (size_t)pair * m;
    const uint8_t* brow = b + (size_t)pair * n;
    const int c0 = tid * C;
    const int c1 = min(c0 + C, W);
    const size_t row_stride = (size_t)B * W;  // dirs (m+1, B, W)
    uint16_t* drow = DIRS ? dirs + (size_t)pair * W : nullptr;
    float* fin = out + (size_t)pair * 3;

    // row 0: lanes with column j = l - w_lo in [0, n] hold the reference
    // boundary with the pair's start type (quirk: +2 acts as -1 on row 0)
    for (int l = c0; l < c1; ++l) {
        const int j = l - w_lo;
        float r1 = NEG, r2 = NEG, r3 = NEG;
        if (j == 0) {
            r1 = (sta == 1 || sta == -1) ? 0.0f : NEG;
            r2 = (sta == -2) ? 0.0f : NEG;
            r3 = (sta == -3) ? 0.0f : NEG;
        } else if (j > 0 && j <= n) {
            const float jg = g * (float)j;
            r2 = (sta == -2) ? -jg : ((sta == 1 || sta == 3) ? NEG : -h - jg);
        }
        row(0, 0)[l] = r1;
        row(0, 1)[l] = r2;
        row(0, 2)[l] = r3;
        if (DIRS) {
            S[l] = 0;
            drow[l] = 0;
        }
        if (lA == 0 && j == lB) {
            fin[0] = r1;
            fin[1] = r2;
            fin[2] = r3;
        }
    }
    __syncthreads();

    for (int i = 1; i <= m; ++i) {
        const int cur = i & 1, prv = cur ^ 1;
        const float* P1 = row(prv, 0);
        const float* P2 = row(prv, 1);
        const float* P3 = row(prv, 2);
        float* Q1 = row(cur, 0);
        float* Q2 = row(cur, 1);
        float* Q3 = row(cur, 2);
        const int ac = arow[i - 1];
        const int j0 = i - w_lo;  // the column of lane 0
        const float fi = (float)i;
        // column 0 of T3 (quirk: start +3 acts as -1 on column 0)
        const float col0_3 = (sta == -3) ? -g * fi
                           : ((sta == 1 || sta == 2) ? NEG : -h - g * fi);

        // pass 1: T1, T3 and the chunk-local prefix max of omega
        float run_max = NEG;
        if (c0 < c1) {
            float m13l = NEG;  // max(T1, T3) of this row at lane c0-1
            if (c0 > 0) {
                const int l = c0 - 1, j = j0 + l;
                float t1 = NEG, t3 = NEG;
                if (j >= 1 && j <= n) {
                    const float fb = brow[j - 1] == ac ? match : mismatch;
                    t1 = fb + fmaxf(fmaxf(P1[l], P2[l]), P3[l]);
                    t3 = fmaxf(fmaxf(P1[l + 1], P2[l + 1]) - gh,
                               P3[l + 1] - g);
                } else if (j == 0) {
                    t3 = col0_3;
                }
                m13l = fmaxf(t1, t3);
            }
            for (int l = c0; l < c1; ++l) {
                const int j = j0 + l;
                float t1 = NEG, t3 = NEG, omega = NEG;
                if (j >= 1 && j <= n) {
                    const float u1 = l + 1 < W ? P1[l + 1] : NEG;
                    const float u2 = l + 1 < W ? P2[l + 1] : NEG;
                    const float u3 = l + 1 < W ? P3[l + 1] : NEG;
                    const float fb = brow[j - 1] == ac ? match : mismatch;
                    t1 = fb + fmaxf(fmaxf(P1[l], P2[l]), P3[l]);
                    t3 = fmaxf(fmaxf(u1, u2) - gh, u3 - g);
                    omega = (g * (float)j + m13l) - gh;
                } else if (j == 0) {
                    t3 = col0_3;
                }
                run_max = fmaxf(run_max, omega);
                Q1[l] = t1;
                Q3[l] = t3;
                Q2[l] = run_max;  // chunk-local prefix; fixed in pass 2
                m13l = fmaxf(t1, t3);
            }
        }

        // block scan: exclusive prefix max of the chunk maxima
        const float incl = warp_incl_max(run_max);
        if (lane == 31) wsum[warp] = incl;
        __syncthreads();
        float wpre = (lane < warp) ? wsum[lane] : NEG;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            wpre = fmaxf(wpre, __shfl_xor_sync(0xffffffffu, wpre, s));
        float inwarp = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) inwarp = NEG;
        const float excl = fmaxf(wpre, inwarp);

        // pass 2: T2, directions, run state, finals
        if (c0 < c1) {
            int d2l = 0;  // lane 0 shifts in a zero code
            if (DIRS && c0 > 0) {
                const int l = c0 - 1, j = j0 + l;
                const float t2l = (j >= 1 && j <= n) ? excl - g * (float)j
                                                     : NEG;
                d2l = argmax3(Q1[l] - h, t2l, Q3[l] - h);
            }
            uint16_t* dout = DIRS ? drow + (size_t)i * row_stride : nullptr;
            for (int l = c0; l < c1; ++l) {
                const int j = j0 + l;
                const bool inband = j >= 1 && j <= n;
                const float t2 = inband ? fmaxf(Q2[l], excl) - g * (float)j
                                        : NEG;
                Q2[l] = t2;
                const float t1 = Q1[l], t3 = Q3[l];
                if (DIRS) {
                    const float p1 = P1[l], p2 = P2[l], p3 = P3[l];
                    const float u1 = l + 1 < W ? P1[l + 1] : NEG;
                    const float u2 = l + 1 < W ? P2[l + 1] : NEG;
                    const float u3 = l + 1 < W ? P3[l + 1] : NEG;
                    const int d1 = argmax3(p1, p2, p3);
                    const int d3 = argmax3(u1, u2, u3 + h);
                    const int d2 = d2l;
                    uint16_t word = 0;
                    if (inband && j <= lB && i <= lA) {
                        const int pw = S[l];
                        const int r_prev = pw >> 8;
                        const int ca_prev = (pw >> 6) & 3;
                        int r_cur = 0, ca_cur = d1;
                        if (d1 == 0) {
                            r_cur = min(r_prev + 1, kRunCap);
                            ca_cur = r_prev >= kRunCap ? 0 : ca_prev;
                        }
                        word = (uint16_t)(d1 | (d2 << 2) | (d3 << 4) |
                                          (ca_cur << 6) | (r_cur << 8));
                    }
                    S[l] = word;
                    dout[l] = word;
                    d2l = argmax3(t1 - h, t2, t3 - h);
                }
                if (i == lA && j == lB) {
                    fin[0] = t1;
                    fin[1] = t2;
                    fin[2] = t3;
                }
            }
        }
        __syncthreads();
    }
}

template <bool DIRS>
int launch(const uint8_t* a, const uint8_t* b, const int32_t* la,
           const int32_t* lb, const int32_t* st, uint16_t* dirs, float* out,
           char* scratch, int B, int m, int n, int w_lo, int W, int C,
           int threads, size_t smem, float g, float h, float match,
           float mismatch, cudaStream_t stream) {
    auto kern = band_kernel<DIRS>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, threads, smem, stream>>>(a, b, la, lb, st, dirs, out, scratch,
                                       B, m, n, w_lo, W, C, g, h, match,
                                       mismatch);
    return (int)cudaGetLastError();
}

// ---- K12d on the H100: band_rows_kernel<C> ----

constexpr int kRowsMaxWarps = 32;
constexpr int kPadB = 255;  // the code of a lane off the band
constexpr unsigned kFull = 0xffffffffu;

// the threads a CTA of C lanes a thread takes (the register cap is 65,536
// / threads, at most 255: 64 at C = 4, 128 at C = 8, 255 at C = 16)
__host__ __device__ constexpr int rows_threads(int C) {
    return C == 4 ? 1024 : (C == 8 ? 512 : 256);
}

// row 0 at lane l (column j = l - w_lo) of a band of W lanes, start type
// st (quirk kept: +2 acts as -1 on row 0)
__device__ __forceinline__ void band_row0(int st, int l, int W, int w_lo,
                                          int n, float g, float h,
                                          float& r1, float& r2, float& r3) {
    const float NEG = -CUDART_INF_F;
    const int j = l - w_lo;
    r1 = r2 = r3 = NEG;
    if (l >= W) return;
    if (j == 0) {
        r1 = (st == 1 || st == -1) ? 0.0f : NEG;
        r2 = (st == -2) ? 0.0f : NEG;
        r3 = (st == -3) ? 0.0f : NEG;
    } else if (j > 0 && j <= n) {
        const float jg = g * (float)j;
        r2 = (st == -2) ? -jg : ((st == 1 || st == 3) ? NEG : -h - jg);
    }
}

// The thread's C words of one band row, one vector store (two at C = 16)
// into a row of `pitch` lanes; a store whose first lane lies at or past
// the pitch is dropped.
template <int C>
__device__ __forceinline__ void store_band_words(uint16_t* drow, int c0,
                                                 int pitch,
                                                 const uint32_t (&w2)[C / 2]) {
    uint16_t* d = drow + c0;
    if (C == 4) {
        if (c0 < pitch)
            *reinterpret_cast<uint2*>(d) = make_uint2(w2[0], w2[1]);
    } else {
#pragma unroll
        for (int q = 0; q < C / 8; ++q)
            if (c0 + 8 * q < pitch)
                reinterpret_cast<uint4*>(d)[q] = make_uint4(
                    w2[4 * q], w2[4 * q + 1], w2[4 * q + 2], w2[4 * q + 3]);
    }
}

template <int C>
__global__ void __launch_bounds__(rows_threads(C), 1)
band_rows_kernel(const uint8_t* __restrict__ a,
                 const uint8_t* __restrict__ b,
                 const int32_t* __restrict__ la,
                 const int32_t* __restrict__ lb,
                 const int32_t* __restrict__ st, uint16_t* __restrict__ dirs,
                 float* __restrict__ out, int B, int m, int n, int w_lo,
                 int W, int pitch, float g, float h, float match,
                 float mismatch) {
    static_assert(C == 4 || C == 8 || C == 16, "C is 4, 8 or 16");
    // per row parity: each warp's omega total, and T1, T3 of warp w's
    // first lane for lane 31 of warp w - 1 (its upper neighbour next row)
    __shared__ float wt[2][kRowsMaxWarps];
    __shared__ float2 xu[2][kRowsMaxWarps];
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h
    const int pair = blockIdx.x;
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, NW = T >> 5;
    const int c0 = tid * C;
    const int sta = st[pair], lA = la[pair], lB = lb[pair];
    const uint8_t* arow = a + (size_t)pair * m;
    const uint8_t* brow = b + (size_t)pair * n;
    auto code_at = [&](int j) {  // B's code at column j, 1 <= j <= n
        return (j >= 1 && j <= n) ? (uint32_t)brow[j - 1] : (uint32_t)kPadB;
    };
    auto finals = [&](float t1, float t2, float t3) {
        float* fin = out + (size_t)pair * 3;
        fin[0] = t1;
        fin[1] = t2;
        fin[2] = t3;
    };
    auto dirs_row = [&](int i) {  // dirs (m+1, B, pitch)
        return dirs + ((size_t)i * B + pair) * pitch;
    };

    // row 0: the boundary; its words are 0
    float p1[C], p2[C], p3[C];
    uint32_t w2[C / 2];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        band_row0(sta, c0 + c, W, w_lo, n, g, h, p1[c], p2[c], p3[c]);
        if (lA == 0 && c0 + c < W && c0 + c - w_lo == lB)
            finals(p1[c], p2[c], p3[c]);
    }
#pragma unroll
    for (int q = 0; q < C / 2; ++q) w2[q] = 0;
    store_band_words<C>(dirs_row(0), c0, pitch, w2);
    // row 0's halos depend on the lane alone: max3 at lane c0 - 1 (the
    // left neighbour, for this thread's recomputed T1 there) and the
    // three tables at lane c0 + C (the upper neighbour of the last lane)
    float hm3 = NEG, ux1, ux2, ux3;
    if (c0 > 0) {
        float r1, r2, r3;
        band_row0(sta, c0 - 1, W, w_lo, n, g, h, r1, r2, r3);
        hm3 = fmaxf(fmaxf(r1, r2), r3);
    }
    band_row0(sta, c0 + C, W, w_lo, n, g, h, ux1, ux2, ux3);
    // B's codes of row 1's lanes, four to a register, and of lane c0 - 1
    uint32_t bc[C / 4];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
        bc[q] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            bc[q] |= code_at(1 - w_lo + c0 + 4 * q + k) << (8 * k);
    }
    uint32_t bl = code_at(-w_lo + c0);
    int acn = m > 0 ? (int)arow[0] : 0;

    for (int i = 1; i <= m; ++i) {
        const int par = i & 1;
        const int ac = acn;
        if (i < m) acn = arow[i];  // prefetch
        // the code entering lane c0 + C - 1 next row, prefetched
        const uint32_t bnext = code_at(i + 1 - w_lo + c0 + C - 1);
        const int j0 = i - w_lo + c0;  // the column of lane c0
        const float fi = (float)i;
        // column 0 of T3 (quirk: start +3 acts as -1 on column 0)
        const float col0_3 = (sta == -3) ? -g * fi
                           : ((sta == 1 || sta == 2) ? NEG : -h - g * fi);
        const bool rect = i <= lA;  // the row lies in the pair's rectangle

        // this row's T1 and T3 at lane c0 - 1, recomputed from the
        // previous row (max3 there, and this thread's lane c0)
        float t1l = NEG, t3l = NEG;
        if (c0 > 0 && c0 - 1 < W) {
            const int jl = j0 - 1;
            if (jl >= 1 && jl <= n) {
                t1l = ((int)bl == ac ? match : mismatch) + hm3;
                t3l = fmaxf(fmaxf(p1[0], p2[0]) - gh, p3[0] - g);
            } else if (jl == 0) {
                t3l = col0_3;
            }
        }

        // pass 1: T1, T3, d1, d3, the run part of the words, the running
        // max of omega (in p2 until pass 2)
        float m13l = fmaxf(t1l, t3l);
        float run = NEG;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int l = c0 + c, j = j0 + c;
            const float q1 = p1[c], q2 = p2[c], q3 = p3[c];
            const int cu = (c + 1) % C;  // the upper lane, inside the thread
            const float u1 = c + 1 < C ? p1[cu] : ux1;
            const float u2 = c + 1 < C ? p2[cu] : ux2;
            const float u3 = c + 1 < C ? p3[cu] : ux3;
            const bool inb = l < W && j >= 1 && j <= n;
            float t1 = NEG, t3 = NEG, omega = NEG;
            if (inb) {
                const int code = (int)((bc[c >> 2] >> ((c & 3) * 8)) & 255u);
                t1 = (code == ac ? match : mismatch) +
                     fmaxf(fmaxf(q1, q2), q3);
                t3 = fmaxf(fmaxf(u1, u2) - gh, u3 - g);
                omega = (g * (float)j + m13l) - gh;
            } else if (l < W && j == 0) {
                t3 = col0_3;
            }
            uint32_t wv = 0;
            if (inb && j <= lB && rect) {
                const int d1 = argmax3(q1, q2, q3);
                const int d3 = argmax3(u1, u2, u3 + h);
                // bits 6-15, run << 2 | after-run code: a run grows by
                // one up to the cap 255 (its code cleared there); any
                // other d1 starts none and records itself
                const int x = (int)((w2[c >> 1] >> ((c & 1) * 16)) & 0xFFFFu)
                              >> 6;
                const int xn = d1 != 0 ? d1
                             : (x >= (kRunCap << 2) ? kRunCap << 2 : x + 4);
                wv = (uint32_t)(d1 | (d3 << 4) | (xn << 6));
            }
            const int sh = (c & 1) * 16;
            w2[c >> 1] = (w2[c >> 1] & ~(0xFFFFu << sh)) | (wv << sh);
            run = fmaxf(run, omega);
            p1[c] = t1;
            p2[c] = run;
            p3[c] = t3;
            m13l = fmaxf(t1, t3);
        }
        if (lane == 0 && warp > 0)
            xu[par][warp - 1] = make_float2(p1[0], p3[0]);

        // the scan: the exclusive prefix max of the threads' maxima
        const float incl = warp_incl_max(run);
        if (lane == 31) wt[par][warp] = incl;
        __syncthreads();
        float wpre = lane < warp ? wt[par][lane] : NEG;
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
            wpre = fmaxf(wpre, __shfl_xor_sync(kFull, wpre, k));
        float inwarp = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) inwarp = NEG;
        const float excl = fmaxf(wpre, inwarp);

        // pass 2: T2, d2 (from the lane to the left), the finals
        float t2l = NEG;
        if (c0 > 0 && c0 - 1 < W && j0 - 1 >= 1 && j0 - 1 <= n)
            t2l = excl - g * (float)(j0 - 1);
        int d2 = c0 > 0 ? argmax3(t1l - h, t2l, t3l - h) : 0;
        const bool capi = i == lA;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int l = c0 + c, j = j0 + c;
            const bool inb = l < W && j >= 1 && j <= n;
            const float t2 = inb ? fmaxf(p2[c], excl) - g * (float)j : NEG;
            p2[c] = t2;
            if (inb && j <= lB && rect)
                w2[c >> 1] |= (uint32_t)(d2 << 2) << ((c & 1) * 16);
            d2 = argmax3(p1[c] - h, t2, p3[c] - h);
            if (capi && l < W && j == lB) finals(p1[c], t2, p3[c]);
        }
        store_band_words<C>(dirs_row(i), c0, pitch, w2);
        if (i == m) break;

        // the next row's halos: max3 at lane c0 - 1 from the recomputed
        // tables; the upper neighbour of the last lane from the next
        // thread, or at a warp's edge from the next warp's first T1 and
        // T3 and its T2, which this lane rebuilds from its last omega and
        // the prefix up to its warp
        hm3 = fmaxf(fmaxf(t1l, t2l), t3l);
        const float v1 = __shfl_down_sync(kFull, p1[0], 1);
        const float v2 = __shfl_down_sync(kFull, p2[0], 1);
        const float v3 = __shfl_down_sync(kFull, p3[0], 1);
        if (lane < 31) {
            ux1 = v1;
            ux2 = v2;
            ux3 = v3;
        } else if (warp + 1 < NW) {
            const float2 x = xu[par][warp];
            const int l = c0 + C, j = j0 + C;
            const bool inb = l < W && j >= 1 && j <= n;
            const float om = (g * (float)j + m13l) - gh;
            ux1 = x.x;
            ux2 = inb ? fmaxf(om, fmaxf(wpre, incl)) - g * (float)j : NEG;
            ux3 = x.y;
        } else {
            ux1 = ux2 = ux3 = NEG;
        }
        // B's codes slide one lane left
        bl = bc[0] & 255u;
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
            bc[q] = __funnelshift_r(
                bc[q], q + 1 < C / 4 ? bc[(q + 1) % (C / 4)] : bnext, 8);
    }
}

template <int C>
int rows_launch(const uint8_t* a, const uint8_t* b, const int32_t* la,
                const int32_t* lb, const int32_t* st, uint16_t* dirs,
                float* out, int B, int m, int n, int w_lo, int W, int pitch,
                int threads, float g, float h, float match, float mismatch,
                cudaStream_t stream) {
    band_rows_kernel<C><<<B, threads, 0, stream>>>(
        a, b, la, lb, st, dirs, out, B, m, n, w_lo, W, pitch, g, h, match,
        mismatch);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// band_kernel: K12d's shared-memory body when dirs is not null (bands
// past 4,096 lanes, and the comparison on the card), else K12s. dirs:
// (m+1, B, W) uint16; out:
// (B, 3) f32 finals, filled with -inf by the caller; a: (B, m) u8; b:
// (B, n) u8; la/lb/st: (B,) i32, every pair's (0, 0) and (la, lb) inside
// the band (the wrapper checks); W = w_lo + w_hi + 1; C lanes per thread,
// threads a multiple of 32 with threads * C >= W; smem: 512 bytes, plus
// the row buffers unless scratch holds B of them, W * 26 bytes each (24
// without dirs) rounded up to 16. Returns a cudaError_t code.
int band_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
              const int32_t* lb, const int32_t* st, uint16_t* dirs,
              float* out, char* scratch, int B, int m, int n, int w_lo,
              int W, int C, int threads, long long smem, float g, float h,
              float match, float mismatch, void* stream) {
    if (B == 0) return 0;
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        (long long)threads * C < W || w_lo < 0 || W <= w_lo)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dirs)
        return launch<true>(a, b, la, lb, st, dirs, out, scratch, B, m, n,
                            w_lo, W, C, threads, (size_t)smem, g, h, match,
                            mismatch, s);
    return launch<false>(a, b, la, lb, st, dirs, out, scratch, B, m, n, w_lo,
                         W, C, threads, (size_t)smem, g, h, match, mismatch,
                         s);
}

// K12d on the H100 (band_rows_kernel). dirs: (m+1, B, pitch) uint16, pitch
// a multiple of 8 and at least W (lanes W .. pitch-1 hold zeros); out:
// (B, 3) f32 finals, filled with -inf by the caller; a, b, la, lb, st as
// for band_fill; C lanes a thread (4, 8 or 16), threads a multiple of 32
// up to 1,024, 512 and 256 at C = 4, 8, 16, with threads * C >= W.
// Returns a cudaError_t code.
int band_rows_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
                   const int32_t* lb, const int32_t* st, uint16_t* dirs,
                   float* out, int B, int m, int n, int w_lo, int W,
                   int pitch, int C, int threads, float g, float h,
                   float match, float mismatch, void* stream) {
    if (B == 0) return 0;
    if ((C != 4 && C != 8 && C != 16) || threads < 32 ||
        threads > rows_threads(C) || threads % 32 != 0 ||
        (long long)threads * C < W || w_lo < 0 || W <= w_lo || pitch < W ||
        pitch % 8 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define BAND_ROWS(CC)                                                      \
    return rows_launch<CC>(a, b, la, lb, st, dirs, out, B, m, n, w_lo, W,  \
                           pitch, threads, g, h, match, mismatch, s)
    if (C == 4) BAND_ROWS(4);
    if (C == 8) BAND_ROWS(8);
    BAND_ROWS(16);
#undef BAND_ROWS
}

}  // extern "C"
