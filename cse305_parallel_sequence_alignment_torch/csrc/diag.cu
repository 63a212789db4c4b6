// Anti-diagonal score fills for the H100 (sm_90a), plain C interface.
//
// One template, three modes (wrapper ops/diag.py):
//   mode 0, K3: replaces the TPU kernel _score_kernel
//     (cse305_parallel_sequence_alignment_tpu/ops/pallas_fill.py:216), the
//     global score fill with per-pair start types; finals (T1, T2, T3) at
//     (la, lb).
//   mode 1, K10s: replaces _sg_score_kernel (ops/pallas_semiglobal.py:100),
//     the semi-global score fill; best over the last query row.
//   mode 2, K11s: replaces the XLA wavefront overlap_score_batch
//     (ops/overlap.py:124), which the JAX overlap aligner's score path runs
//     on every backend; best over the last row or the last column.
//   mode 0 with DIRS, K5 skew_dirs: replaces _dirs_kernel
//     (ops/pallas_fill.py:310), the same global sweep storing one uint8 code
//     d1 | d2 << 2 | d3 << 4 a cell in the skew layout dirs[i + j, pair, j],
//     0 outside the interior (row 0, column 0, i outside 1..m), and the
//     finals. Its codes compare the rounded candidates as _diag_step does:
//     d1 the (i-1, j-1) triple, d2 T1 - gh, T2 - g, T3 - gh at (i, j-1), d3
//     T1 - gh, T2 - gh, T3 - g at (i-1, j), tie order T1 >= T2 >= T3. The
//     values are K3's: max(a, c) - gh = max(a - gh, c - gh) exactly.
//
// Design. One CTA per pair sweeps the anti-diagonals d = 1..m+n; thread t
// owns the columns j = t, t + blockDim, ... of every diagonal. Three
// diagonal buffers (d, d-1, d-2) of T1/T2/T3 rotate in shared memory, or
// in global scratch that the wrapper allocates when the row is too wide;
// one block barrier per diagonal orders the writes of d before the reads
// of d+1, and the reads of d-2 before its slot is rewritten at d+1. The
// scheme is csrc/local.cu's K9s without the clamp at 0. T2 is computed
// directly from the left neighbour, as the JAX kernels do, with no prefix
// max. Each thread keeps its own best candidate; a warp shuffle and a
// shared-memory pass reduce them by the mode's tie key.
//
// Bounds. Per interior cell ~16 float operations and no device-memory
// traffic but the two sequences and 12-16 bytes a pair out: 16,384 pairs of
// 250 x 1,024 are 4.2 G cells, ~2 ms at the fp32 peak. What binds is the
// per-diagonal barrier and the dependent chain d-2 -> d-1 -> d inside each
// CTA; several CTAs share an SM to hide it. K5 also stores the skew bytes,
// (m+n+1)(n+1) a pair: 2.15 GB at 256 x 2 kb, 0.64 ms of HBM, so it is bound
// by bytes. Every mode sweeps only the cells of a diagonal with 0 <= i <= m,
// contiguous columns, so K5's stores coalesce; its wrapper zeroes the array
// first at the card's full memset rate, which saves a partition segment
// (3.3 k x 27 k, one CTA) ~8 of 9 byte stores.
//
// Numerics. float32 with true -inf and the JAX order of operations (built
// with -fmad=false, so no multiply-add is contracted):
//   T1 = f + max(max(T1, T2), T3)(i-1, j-1)
//   T2 = max(max(T1, T3)(i, j-1) - gh, T2(i, j-1) - g)
//   T3 = max(max(T1, T2)(i-1, j) - gh, T3(i-1, j) - g)
// with gh = g + h rounded to float32: XLA folds the JAX source's x - g - h
// into one subtraction. The boundaries -h - g*i are a product and a
// subtraction.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kNegInf = -INFINITY;  // usable in host and device code
constexpr int kReduceBytes = 1024;  // per-warp best (value, d, table, j)

__device__ __forceinline__ int argmax3(float c1, float c2, float c3) {
    return (c1 >= c2 && c1 >= c3) ? 0 : (c2 >= c3 ? 1 : 2);
}

// (v1, d1, t1, j1) ranks before (v2, d2, t2, j2): larger value, then the
// smaller d, then the smaller table, then the smaller column. Mode 1 passes
// d = j, so its key is (value, column, table).
__device__ __forceinline__ bool ranks_before(float v1, int d1, int t1, int j1,
                                             float v2, int d2, int t2,
                                             int j2) {
    if (v1 != v2) return v1 > v2;
    if (d1 != d2) return d1 < d2;
    if (t1 != t2) return t1 < t2;
    return j1 < j2;
}

struct Best {
    float v = kNegInf;
    int d = 0, t = 1, j = 0;
    // candidates of value -inf never count (the JAX updates are strict)
    __device__ void offer(float cv, int cd, int ct, int cj) {
        if (cv > kNegInf && ranks_before(cv, cd, ct, cj, v, d, t, j)) {
            v = cv;
            d = cd;
            t = ct;
            j = cj;
        }
    }
    __device__ void take_down(int s) {
        const float ov = __shfl_down_sync(0xffffffffu, v, s);
        const int od = __shfl_down_sync(0xffffffffu, d, s);
        const int ot = __shfl_down_sync(0xffffffffu, t, s);
        const int oj = __shfl_down_sync(0xffffffffu, j, s);
        offer(ov, od, ot, oj);
    }
};

template <int MODE, bool DIRS>
__global__ void __launch_bounds__(kMaxThreads)
diag_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
            const int32_t* __restrict__ st, float* __restrict__ out,
            uint8_t* __restrict__ dirs, char* __restrict__ scratch, int B,
            int m, int n, float g, float h, float match, float mismatch) {
    extern __shared__ __align__(16) char smem[];
    const int pair = blockIdx.x;
    const int ncol = n + 1;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h

    // shared layout: per-warp best (4 x 32 words, 1 KB reserved) |
    // diagonal buffers buf[slot][table][col] when they fit (else scratch)
    float* wv = reinterpret_cast<float*>(smem);
    int* wd = reinterpret_cast<int*>(smem + 128);
    int* wt = reinterpret_cast<int*>(smem + 256);
    int* wj = reinterpret_cast<int*>(smem + 384);
    float* buf = scratch
        ? reinterpret_cast<float*>(scratch) + (size_t)pair * 9 * ncol
        : reinterpret_cast<float*>(smem + kReduceBytes);
    auto T = [&](int slot, int k) { return buf + (size_t)(slot * 3 + k) * ncol; };

    const int sta = MODE == 0 ? st[pair] : 0;
    const int lA = la[pair], lB = lb[pair];
    const uint8_t* arow = a + (size_t)pair * m;
    const uint8_t* brow = b + (size_t)pair * n;
    float* fin = out + (size_t)pair * (MODE == 0 ? 3 : 4);

    // diagonal 0 (the corner) in slot 0, diagonal -1 in slot 2
    for (int j = tid; j < ncol; j += nthr) {
        float c1 = NEG, c2 = NEG, c3 = NEG;
        if (j == 0) {
            if (MODE == 0) {
                c1 = (sta == 1 || sta == -1) ? 0.0f : NEG;
                c2 = sta == -2 ? 0.0f : NEG;
                c3 = sta == -3 ? 0.0f : NEG;
                if (lA == 0 && lB == 0) {
                    fin[0] = c1;
                    fin[1] = c2;
                    fin[2] = c3;
                }
            } else {
                c1 = 0.0f;
            }
        }
        T(0, 0)[j] = c1;
        T(0, 1)[j] = c2;
        T(0, 2)[j] = c3;
        T(2, 0)[j] = NEG;
        T(2, 1)[j] = NEG;
        T(2, 2)[j] = NEG;
    }
    __syncthreads();

    Best best;
    for (int d = 1; d <= m + n; ++d) {
        const int cur = d % 3, prv = (d + 2) % 3, pp = (d + 1) % 3;
        const float* P1 = T(prv, 0);
        const float* P2 = T(prv, 1);
        const float* P3 = T(prv, 2);
        const float* Q1 = T(pp, 0);
        const float* Q2 = T(pp, 1);
        const float* Q3 = T(pp, 2);
        float* C1 = T(cur, 0);
        float* C2 = T(cur, 1);
        float* C3 = T(cur, 2);
        uint8_t* drow = DIRS ? dirs + ((size_t)d * B + pair) * ncol : nullptr;
        // the cells with 0 <= i <= m alone: no cell of the sweep reads
        // another, so their buffer slots keep stale values
        for (int j = max(0, d - m) + tid; j < ncol && j <= d; j += nthr) {
            const int i = d - j;
            float t1 = NEG, t2 = NEG, t3 = NEG;
            int packed = 0;
            if (i > 0 && j > 0) {
                const float f =
                    __ldg(arow + i - 1) == __ldg(brow + j - 1) ? match : mismatch;
                if (DIRS) {
                    const float s1 = Q1[j - 1], s2 = Q2[j - 1], s3 = Q3[j - 1];
                    const float c2a = P1[j - 1] - gh, c2b = P2[j - 1] - g,
                                c2c = P3[j - 1] - gh;
                    const float c3a = P1[j] - gh, c3b = P2[j] - gh,
                                c3c = P3[j] - g;
                    t1 = f + fmaxf(fmaxf(s1, s2), s3);
                    t2 = fmaxf(fmaxf(c2a, c2b), c2c);
                    t3 = fmaxf(fmaxf(c3a, c3b), c3c);
                    packed = argmax3(s1, s2, s3) |
                             (argmax3(c2a, c2b, c2c) << 2) |
                             (argmax3(c3a, c3b, c3c) << 4);
                } else {
                    t1 = f + fmaxf(fmaxf(Q1[j - 1], Q2[j - 1]), Q3[j - 1]);
                    t2 = fmaxf(fmaxf(P1[j - 1], P3[j - 1]) - gh, P2[j - 1] - g);
                    t3 = fmaxf(fmaxf(P1[j], P2[j]) - gh, P3[j] - g);
                }
            } else if (MODE == 0) {
                if (i == 0) {  // row 0 (quirk: start +2 acts as -1 here)
                    const float jg = g * (float)j;
                    t2 = sta == -2 ? -jg
                       : ((sta == 1 || sta == 3) ? NEG : -h - jg);
                } else {       // column 0 (quirk: +3 acts as -1 here)
                    t3 = sta == -3 ? -g * (float)i
                       : ((sta == 1 || sta == 2) ? NEG : -h - g * (float)i);
                }
            } else if (MODE == 1) {
                if (i == 0) t1 = 0.0f;
                else t3 = -h - g * (float)i;
            } else {
                t1 = 0.0f;  // both edges are free
            }
            C1[j] = t1;
            C2[j] = t2;
            C3[j] = t3;
            if (DIRS) drow[j] = (uint8_t)packed;
            if (MODE == 0) {
                if (i == lA && j == lB) {
                    fin[0] = t1;
                    fin[1] = t2;
                    fin[2] = t3;
                }
            } else if (MODE == 1) {
                if (i == lA && j >= 1 && j <= lB) {
                    best.offer(t1, j, 1, j);
                    best.offer(t2, j, 2, j);
                    best.offer(t3, j, 3, j);
                }
            } else {
                if ((i == lA && j >= 1 && j <= lB) ||
                    (j == lB && i >= 1 && i <= lA)) {
                    best.offer(t1, d, 1, j);
                    best.offer(t2, d, 2, j);
                    best.offer(t3, d, 3, j);
                }
            }
        }
        __syncthreads();
    }
    if (MODE == 0) return;

    // block reduction of the per-thread bests
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) best.take_down(s);
    if (lane == 0) {
        wv[warp] = best.v;
        wd[warp] = best.d;
        wt[warp] = best.t;
        wj[warp] = best.j;
    }
    __syncthreads();
    if (warp != 0) return;
    Best w;
    if (lane < (nthr >> 5)) {
        w.v = wv[lane];
        w.d = wd[lane];
        w.t = wt[lane];
        w.j = wj[lane];
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) w.take_down(s);
    if (lane == 0) {
        const bool found = w.v > NEG;
        fin[0] = w.v;
        fin[1] = found ? (float)w.t : 1.0f;
        if (MODE == 1) {
            fin[2] = (float)lA;
            fin[3] = found ? (float)w.j : 0.0f;
        } else {
            fin[2] = found ? (float)(w.d - w.j) : 0.0f;
            fin[3] = found ? (float)w.j : 0.0f;
        }
    }
}

template <int MODE, bool DIRS>
int launch(const uint8_t* a, const uint8_t* b, const int32_t* la,
           const int32_t* lb, const int32_t* st, float* out, uint8_t* dirs,
           char* scratch, int B, int m, int n, int threads, size_t smem,
           float g, float h, float match, float mismatch,
           cudaStream_t stream) {
    if (B == 0) return 0;
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        smem < (size_t)kReduceBytes)
        return (int)cudaErrorInvalidValue;
    auto kern = diag_kernel<MODE, DIRS>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, threads, smem, stream>>>(a, b, la, lb, st, out, dirs, scratch,
                                       B, m, n, g, h, match, mismatch);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (B, m) u8; b: (B, n) u8; la/lb/st: (B,) i32 (st read in mode 0 only);
// out: (B, 3) f32 finals in mode 0, (B, 4) f32 [score, end_table, end_i,
// end_j] in modes 1 and 2; threads a multiple of 32 up to 1024; smem: 1 KB,
// plus 9 (n+1) floats of diagonal buffers unless scratch holds B such
// buffers. Returns a cudaError_t code.
int diag_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
              const int32_t* lb, const int32_t* st, float* out,
              char* scratch, int mode, int B, int m, int n, int threads,
              long long smem, float g, float h, float match, float mismatch,
              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t sm = (size_t)smem;
    if (mode == 0)
        return launch<0, false>(a, b, la, lb, st, out, nullptr, scratch, B, m,
                                n, threads, sm, g, h, match, mismatch, s);
    if (mode == 1)
        return launch<1, false>(a, b, la, lb, st, out, nullptr, scratch, B, m,
                                n, threads, sm, g, h, match, mismatch, s);
    if (mode == 2)
        return launch<2, false>(a, b, la, lb, st, out, nullptr, scratch, B, m,
                                n, threads, sm, g, h, match, mismatch, s);
    return (int)cudaErrorInvalidValue;
}

// K5: diag_fill's global mode storing the skew dirs. dirs: (m+n+1, B, n+1)
// u8, zeroed by the caller (the kernel writes the cells with 0 <= i <= m);
// the other arguments as diag_fill's in mode 0.
// Returns a cudaError_t code.
int skew_dirs(const uint8_t* a, const uint8_t* b, const int32_t* la,
              const int32_t* lb, const int32_t* st, float* out,
              uint8_t* dirs, char* scratch, int B, int m, int n, int threads,
              long long smem, float g, float h, float match, float mismatch,
              void* stream) {
    return launch<0, true>(a, b, la, lb, st, out, dirs, scratch, B, m, n,
                           threads, (size_t)smem, g, h, match, mismatch,
                           (cudaStream_t)stream);
}

}  // extern "C"
