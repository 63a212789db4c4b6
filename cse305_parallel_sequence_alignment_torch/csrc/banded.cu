// Banded Gotoh fills for the H100 (sm_90a), plain C interface.
//
// One template, two instantiations (wrappers in ops/banded.py):
//   DIRS = false, K12s band_score: replaces _banded_kernel
//     (cse305_parallel_sequence_alignment_tpu/ops/pallas_banded.py:42), the
//     finals (T1, T2, T3) at each pair's (la, lb);
//   DIRS = true, K12d band_dirs: replaces _banded_dirs_kernel (same file,
//     :161, with_runs=True), which also writes the band-layout uint16
//     dirs16+runs cell of every (i, j) at dirs[i, pair, j - i + w_lo].
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
// Design. One CTA per pair, the row loop inside the block; each thread
// owns a contiguous chunk of C lanes. The previous and the current band
// row (T1/T2/T3) are double-buffered by row parity in shared memory, or in
// global scratch that the wrapper allocates when W is too wide, so the
// upper read of lane l+1 (another thread's lane) goes to the other buffer.
// A thread recomputes its left neighbour's max(T1, T3) from the previous
// row (lanes c0-1 and c0) instead of waiting for it. T2's in-window prefix
// max is a block-wide scan, as in csrc/rowcb.cu: each thread's running
// max over its chunk, a warp shuffle scan, the warp totals through shared
// memory. The run state of a lane (run length, after-run code) stays in
// that lane from row to row, since a diagonal run keeps its band lane; it
// lives in one buffer that only the lane's owner touches. Bytes and run
// state are masked to each pair's rectangle (j <= lb, i <= la).
//
// Bounds. Per cell 16 float operations and compares (K12s) or 31 (K12d,
// with three argmax3 and the h terms of the codes) and, in K12d, one
// 2-byte store: 256 pairs x 2 kb at W = 129 is ~67 M cells, ~34 MB of
// dirs, about 0.04 ms of HBM bandwidth, so the fill is bound by each
// row's serial chain and two block barriers, as csrc/rowcb.cu is. A single
// long pair is one CTA on one SM: its time is m rows x (two barriers + C
// serial cells), not the card's rate; many pairs fill the card.
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

}  // namespace

extern "C" {

// K12d when dirs is not null, else K12s. dirs: (m+1, B, W) uint16; out:
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

}  // extern "C"
