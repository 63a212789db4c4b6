// Gotoh row-sweep dirs fills for the H100 (sm_90a), plain C interface.
//
// One template, three modes, a substitution-table flag, what it stores a
// cell (nothing, dirs16+runs or uint8 codes) and the omega order (wrappers
// in ops/rowcb.py):
//   mode 0, K1 rowcb_fill: replaces the TPU kernel _rowcb_kernel
//     (cse305_parallel_sequence_alignment_tpu/ops/pallas_rowcb.py:126) with
//     want_dirs=True, with_runs=True, k1=0: the uint16 "dirs16+runs" cell of
//     every (i, j) and the finals (T1, T2, T3) at (la, lb), with per-pair
//     start types.
//   mode 1, K10d: replaces _sg_rowdirs_kernel (ops/pallas_semiglobal.py:195,
//     with_runs=True, perm=False): T1 = 0 on row 0, T3 = -h - g*i on column
//     0, the best over the last query row.
//   mode 2, K11d: replaces _ov_rowdirs_kernel (ops/pallas_overlap.py:54,
//     with_runs=True, perm=False): T1 = 0 on row 0 and column 0, the best
//     over the last row and the last column.
//   TABLE (mode 0 only), K4d: the k1 > 0 branch of _rowcb_kernel
//     (ops/pallas_rowcb.py:244), K1 with f(A[i], B[j]) = table[A[i]][B[j]]
//     from a (k1, k1) float32 substitution table (pad code k1 - 1) in
//     place of match/mismatch. The TPU kernel resolves f with k1 - 1 lane
//     selects over a host-gathered query profile; here the table sits in
//     shared memory (2.5 KB for BLOSUM62) and each cell does one gather.
//   TABLE without DIRS, K4s: replaces _submat_kernel
//     (ops/pallas_fill.py:1110), the same sweep storing no dirs and no run
//     state, so its finals are K4d's finals bit for bit.
//   no TABLE, no DIRS (mode 0), K3' rowscan_score_fill: replaces
//     _rowscan_kernel (ops/pallas_fill.py:750), the global row-sweep score
//     fill; its finals are K1's finals bit for bit.
//   DIRS8 with the free modes' omega order (mode 0), K1' rowdirs_fill:
//     replaces _rowdirs_kernel (ops/pallas_fill.py:508) with with_runs=False,
//     one uint8 code d1 | d2 << 2 | d3 << 4 a cell; DIRS16 in that order is
//     the same kernel's with_runs=True form (K1's cell encoding).
//   UNIFORM (mode 0, no TABLE, no DIRS, FREE), P-trim rowcb_trim_fill:
//     replaces _trim_kernel of the TPU probe scripts/kern_rowscan2.py:42
//     (through trim_rowscan :96): K3' with every la = m and start type -1
//     fixed, la and st not read, no capture inside the row loop (the
//     finals are read from the row buffers after row m), lb per pair, and
//     omega in the free modes' order, which is what XLA runs for the
//     probe's jgc = g*j - g - h; its finals equal those of K3''
//     (csrc/rowscan2.cu).
//     The probe's other trims (the lane-0 selects of T1 and T2 dropped,
//     -inf + finite = -inf doing their work) are TPU vector savings; this
//     sweep never had them.
// K1, K10d and K11d are the instantiations with TABLE = false, DIRS16. The
// score-only K3 is the anti-diagonal kernel of csrc/diag.cu.
//
// Design. One CTA per pair; the row loop runs inside the block (it takes
// the place of the TPU's sequential row-block grid axis). Each thread owns
// a contiguous chunk of C columns. T2's prefix max over the row is a
// block-wide inclusive scan: each thread's running max over its chunk,
// a warp shuffle scan, then the warp totals through shared memory.
// The previous and the current DP row (T1/T2/T3 and the previous row's
// packed cell, which carries its run length and after-run code) are
// double-buffered by row parity, in shared memory, or in global scratch
// that the wrapper allocates when the row is too wide. A thread reads its
// left neighbour's previous-row cell (column c0-1) from the other buffer,
// so no row is updated in place across a j-1 read. In modes 1 and 2 each
// thread keeps its best end candidate (the mode's tie key); a warp shuffle
// and a shared-memory pass reduce them after the last row.
//
// Bounds. Per cell ~40 float/int operations and one 2-byte store to device
// memory: 256 pairs x 2 kb is ~1.1 G cells and ~2.1 GB of dirs, well under
// a millisecond of HBM bandwidth, so the fill is bound by the serial chain
// of each row (two passes over a thread's chunk) and two block barriers per
// row, not by memory. More pairs per SM hide the latency; the chunk width C
// trades barrier count against chain length. K1' stores one byte a cell
// (~1.1 GB at 256 x 2 kb, 0.32 ms of HBM) and K3' nothing, so both are
// bound the same way.
//
// Numerics. float32 with true -inf and the operation order that XLA runs
// for the JAX kernels (built with -fmad=false, so no multiply-add is
// contracted), gh = g + h rounded to float32:
//   T1 = fb + max3(prev row, j-1)
//   T3 = max(max(T1,T2)(prev, j) - gh, T3(prev, j) - g)
//   T2 = prefixmax(omega) - g*j with
//   omega = (g*j + max(T1,T3)(j-1)) - gh           (mode 0: K1, K3', K4)
//   omega = (g*j - gh) + max(T1,T3)(j-1)           (modes 1, 2 and K1')
// (_rowdirs_kernel computes jgc = g*j - g - h before adding, as the free
// modes' kernels do; at non-dyadic g, h the two orders round T2 apart.)
// Direction codes use the tie order T1 >= T2 >= T3 (quirk B3).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kNegInf = -INFINITY;  // usable in host and device code
constexpr int kRunCap = 255;
constexpr int kHeadBytes = 512;  // warp totals, then the best reduction
// what a sweep stores for each cell: nothing, the uint16 dirs16+runs word,
// or the uint8 codes alone
constexpr int kNoDirs = 0, kDirs16 = 1, kDirs8 = 2;

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

// End candidate: (value, d, table, j) ranks before another with the larger
// value, then the smaller d, table and column. Mode 1 passes d = j (its key
// is value, column, table), mode 2 the anti-diagonal i + j. Candidates of
// value -inf never count, as the JAX updates are strict.
struct Best {
    float v = kNegInf;
    int d = 0, t = 1, j = 0;
    __device__ void offer(float cv, int cd, int ct, int cj) {
        if (!(cv > kNegInf)) return;
        if (cv > v || (cv == v && (cd < d || (cd == d && (ct < t ||
                                                         (ct == t && cj < j)))))) {
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

// Row buffers of one pair: T[buf][table][col] and the packed cell of the
// previous row P[buf][col].
struct Rows {
    float* t;
    uint16_t* p;
    int ncol;
    __device__ float* T(int buf, int k) const {
        return t + ((size_t)buf * 3 + k) * ncol;
    }
    __device__ uint16_t* P(int buf) const { return p + (size_t)buf * ncol; }
};

// FREE: omega in the free modes' order (K1'); modes 1 and 2 always use it.
// UNIFORM: every la = m and start type -1, finals read after row m.
template <int MODE, bool TABLE, int DIRS, bool FREE, bool UNIFORM = false>
__global__ void __launch_bounds__(kMaxThreads)
sweep_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
             const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
             const int32_t* __restrict__ st, void* __restrict__ dirs,
             float* __restrict__ out, char* __restrict__ scratch, int B,
             int m, int n, int C, float g, float h, float match,
             float mismatch, const float* __restrict__ table, int k1) {
    constexpr bool RUNS = DIRS == kDirs16;  // the packed word carries runs
    constexpr bool FREE_ORDER = MODE != 0 || FREE;
    extern __shared__ __align__(16) char smem[];
    const int pair = blockIdx.x;
    const int ncol = n + 1;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h

    // shared layout: warp totals (32 f32) and, after the rows, the best
    // reduction (4 x 32 words) in the 512-byte head | b_ext (ncol u8,
    // 16-aligned) | the substitution table (TABLE: k1 * k1 f32, 16-aligned)
    // | row buffers when they fit (else in global scratch)
    float* wsum = reinterpret_cast<float*>(smem);
    uint8_t* bext = reinterpret_cast<uint8_t*>(smem + kHeadBytes);
    const size_t bext_bytes = ((size_t)ncol + 15) & ~(size_t)15;
    float* tab = reinterpret_cast<float*>(smem + kHeadBytes + bext_bytes);
    const size_t tab_bytes =
        TABLE ? (((size_t)k1 * k1 * 4 + 15) & ~(size_t)15) : 0;
    const size_t row_bytes = (size_t)ncol * (RUNS ? 28 : 24);
    char* rowmem = scratch ? scratch + (size_t)pair * ((row_bytes + 15) & ~(size_t)15)
                           : smem + kHeadBytes + bext_bytes + tab_bytes;
    Rows R{reinterpret_cast<float*>(rowmem),
           reinterpret_cast<uint16_t*>(rowmem + (size_t)ncol * 24), ncol};

    const int sta = MODE == 0 ? (UNIFORM ? -1 : st[pair]) : 0;
    const int lA = UNIFORM ? m : la[pair], lB = lb[pair];
    const uint8_t* arow = a + (size_t)pair * m;
    const uint8_t* brow = b + (size_t)pair * n;
    // column 0's sentinel 255 never indexes the table: f is read at j >= 1
    for (int j = tid; j < ncol; j += blockDim.x)
        bext[j] = j == 0 ? (uint8_t)255 : brow[j - 1];
    if (TABLE)
        for (int k = tid; k < k1 * k1; k += blockDim.x) tab[k] = table[k];

    const int c0 = tid * C;
    const int c1 = min(c0 + C, ncol);
    const size_t row_stride = (size_t)B * ncol;  // dirs (m+1, B, ncol)
    uint16_t* drow = static_cast<uint16_t*>(dirs) + (size_t)pair * ncol;
    uint8_t* drow8 = static_cast<uint8_t*>(dirs) + (size_t)pair * ncol;
    float* fin = out + (size_t)pair * (MODE == 0 ? 3 : 4);
    Best best;

    // row 0: the reference boundary with per-pair start types (quirks kept:
    // +2 acts as -1 on row 0), or a free T1 row in modes 1 and 2
    for (int j = c0; j < c1; ++j) {
        const float jg = g * (float)j;
        float r1 = NEG, r2 = NEG, r3 = NEG;
        if (MODE != 0) {
            r1 = 0.0f;
        } else if (j == 0) {
            r1 = (sta == 1 || sta == -1) ? 0.0f : NEG;
            r2 = (sta == -2) ? 0.0f : NEG;
            r3 = (sta == -3) ? 0.0f : NEG;
        } else {
            r2 = (sta == -2) ? -jg : ((sta == 1 || sta == 3) ? NEG : -h - jg);
        }
        R.T(0, 0)[j] = r1;
        R.T(0, 1)[j] = r2;
        R.T(0, 2)[j] = r3;
        if (RUNS) {
            R.P(0)[j] = 0;
            drow[j] = 0;
        } else if (DIRS == kDirs8) {
            drow8[j] = 0;
        }
        if (!UNIFORM && lA == 0) {
            if (MODE == 0 && j == lB) {
                fin[0] = r1;
                fin[1] = r2;
                fin[2] = r3;
            }
            if (MODE != 0 && j >= 1 && j <= lB) {  // on row 0, d = j
                best.offer(r1, j, 1, j);
                best.offer(r2, j, 2, j);
                best.offer(r3, j, 3, j);
            }
        }
    }
    __syncthreads();

    for (int i = 1; i <= m; ++i) {
        const int cur = i & 1, prv = cur ^ 1;
        const float* P1 = R.T(prv, 0);
        const float* P2 = R.T(prv, 1);
        const float* P3 = R.T(prv, 2);
        float* Q1 = R.T(cur, 0);
        float* Q2 = R.T(cur, 1);
        float* Q3 = R.T(cur, 2);
        const int ac = arow[i - 1];
        const float* frow = tab + (TABLE ? ac * k1 : 0);  // f(A[i], .)
        const float fi = (float)i;
        // column 0 (quirk: start +3 acts as -1 on column 0)
        float col0_1 = NEG, col0_3 = NEG;
        if (MODE == 0)
            col0_3 = (sta == -3) ? -g * fi
                   : ((sta == 1 || sta == 2) ? NEG : -h - g * fi);
        else if (MODE == 1)
            col0_3 = -h - g * fi;
        else
            col0_1 = 0.0f;

        // pass 1: T1, T3 and the chunk-local prefix max of omega
        float run_max = NEG;
        if (c0 < c1) {
            float lm3 = NEG;   // max3 of the previous row at j-1
            float m13l = NEG;  // max(T1, T3) of this row at j-1
            if (c0 > 0) {
                const int jl = c0 - 1;
                const float q12 = fmaxf(P1[jl], P2[jl]);
                const float q3v = P3[jl];
                float t1l = col0_1, t3l = col0_3;
                if (jl > 0) {
                    const float mp3ll = fmaxf(fmaxf(P1[jl - 1], P2[jl - 1]),
                                              P3[jl - 1]);
                    const float fbl =
                        TABLE ? frow[bext[jl]]
                              : (bext[jl] == ac ? match : mismatch);
                    t1l = fbl + mp3ll;
                    t3l = fmaxf(q12 - gh, q3v - g);
                }
                lm3 = fmaxf(q12, q3v);
                m13l = fmaxf(t1l, t3l);
            }
            for (int j = c0; j < c1; ++j) {
                const float p1 = P1[j], p2 = P2[j], p3 = P3[j];
                const float mp12 = fmaxf(p1, p2);
                const float mp3 = fmaxf(mp12, p3);
                float t1 = col0_1, t3 = col0_3, omega = NEG;
                if (j > 0) {
                    const float fb = TABLE ? frow[bext[j]]
                                           : (bext[j] == ac ? match : mismatch);
                    const float jg = g * (float)j;
                    t1 = fb + lm3;
                    t3 = fmaxf(mp12 - gh, p3 - g);
                    omega = FREE_ORDER ? (jg - gh) + m13l : (jg + m13l) - gh;
                }
                run_max = fmaxf(run_max, omega);
                Q1[j] = t1;
                Q3[j] = t3;
                Q2[j] = run_max;  // chunk-local prefix; fixed in pass 2
                lm3 = mp3;
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

        // pass 2: T2, directions, run lengths, finals and end candidates
        if (c0 < c1) {
            int am3l = 0, d2l = 0, pwl = 0;  // column 0 sees zeros
            if (DIRS != kNoDirs && c0 > 0) {
                const int jl = c0 - 1;
                am3l = argmax3(P1[jl], P2[jl], P3[jl]);
                if (RUNS) pwl = R.P(prv)[jl];
                const float t2l = jl == 0 ? NEG : excl - g * (float)jl;
                d2l = argmax3(Q1[jl] - h, t2l, Q3[jl] - h);
            }
            const uint16_t* PW = R.P(prv);
            uint16_t* QW = R.P(cur);
            uint16_t* dout = drow + (size_t)i * row_stride;
            uint8_t* dout8 = drow8 + (size_t)i * row_stride;
            for (int j = c0; j < c1; ++j) {
                const float pm = fmaxf(Q2[j], excl);
                const float t2 = j == 0 ? NEG : pm - g * (float)j;
                Q2[j] = t2;
                const float t1 = Q1[j], t3 = Q3[j];
                if (DIRS != kNoDirs) {
                    const float p1 = P1[j], p2 = P2[j], p3 = P3[j];
                    const int d1 = am3l;
                    const int d2 = d2l;
                    const int d3 = argmax3(p1, p2, p3 + h);
                    const int codes = d1 | (d2 << 2) | (d3 << 4);
                    if (RUNS) {
                        const int r_prev = pwl >> 8;
                        const int ca_prev = (pwl >> 6) & 3;
                        int r_cur = 0, ca_cur = d1;
                        if (d1 == 0) {
                            r_cur = min(r_prev + 1, kRunCap);
                            ca_cur = r_prev >= kRunCap ? 0 : ca_prev;
                        }
                        const uint16_t word = (uint16_t)(
                            codes | (ca_cur << 6) | (r_cur << 8));
                        QW[j] = word;
                        dout[j] = word;
                    } else {
                        dout8[j] = (uint8_t)codes;
                    }
                    am3l = argmax3(p1, p2, p3);
                    d2l = argmax3(t1 - h, t2, t3 - h);
                    if (RUNS) pwl = PW[j];
                }
                if (MODE == 0) {
                    if (!UNIFORM && i == lA && j == lB) {
                        fin[0] = t1;
                        fin[1] = t2;
                        fin[2] = t3;
                    }
                } else if (j >= 1 && j <= lB &&
                           (i == lA || (MODE == 2 && j == lB && i < lA))) {
                    // mode 1: row la; mode 2: row la and column lb
                    const int key = MODE == 1 ? j : i + j;
                    best.offer(t1, key, 1, j);
                    best.offer(t2, key, 2, j);
                    best.offer(t3, key, 3, j);
                }
            }
        }
        __syncthreads();
    }
    if (MODE == 0) {
        // the thread that wrote column lb of row m reads it back
        if (UNIFORM && lB >= c0 && lB < c1) {
            fin[0] = R.T(m & 1, 0)[lB];
            fin[1] = R.T(m & 1, 1)[lB];
            fin[2] = R.T(m & 1, 2)[lB];
        }
        return;
    }

    // block reduction of the per-thread end candidates (the head is free:
    // the last row's barrier has passed)
    float* wv = reinterpret_cast<float*>(smem);
    int* wd = reinterpret_cast<int*>(smem + 128);
    int* wt = reinterpret_cast<int*>(smem + 256);
    int* wj = reinterpret_cast<int*>(smem + 384);
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
    if (lane < (int)(blockDim.x >> 5)) {
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
        fin[2] = MODE == 1 ? (float)lA : (found ? (float)(w.d - w.j) : 0.0f);
        fin[3] = found ? (float)w.j : 0.0f;
    }
}

template <int MODE, bool TABLE, int DIRS, bool FREE, bool UNIFORM = false>
int launch(const uint8_t* a, const uint8_t* b, const int32_t* la,
           const int32_t* lb, const int32_t* st, void* dirs, float* out,
           char* scratch, int B, int m, int n, int C, int threads,
           size_t smem, float g, float h, float match, float mismatch,
           const float* table, int k1, cudaStream_t stream) {
    auto kern = sweep_kernel<MODE, TABLE, DIRS, FREE, UNIFORM>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, threads, smem, stream>>>(a, b, la, lb, st, dirs, out, scratch,
                                       B, m, n, C, g, h, match, mismatch,
                                       table, k1);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0 (K1), 1 (K10d) or 2 (K11d). dirs_kind 1 stores the uint16
// dirs16+runs word, 2 the uint8 codes alone (mode 0, free order only: K1'),
// 0 nothing (mode 0: K3', or K4s with a table; dirs unused, may be null).
// free_order (mode 0, no table) takes omega in the free modes' order (K1').
// A table (mode 0, dirs_kind 0 or 1, K1's order) gives K4s or K4d.
// dirs: (m+1, B, n+1) uint16 or uint8; out: (B, 3) f32 finals in mode 0,
// (B, 4) f32 [score, end_table, end_i, end_j] in modes 1 and 2; a: (B, m)
// u8; b: (B, n) u8 (codes below k1 with a table); la/lb/st: (B,) i32 (st
// read in mode 0 only); table: (k1, k1) f32 row-major, 2 <= k1 <= 255, or
// null; C columns per thread, threads a multiple of 32 with threads * C >=
// n + 1; smem: 512 + (n+1 rounded up to 16) bytes, plus k1 * k1 * 4 rounded
// up to 16 with a table, plus the row buffers unless scratch holds B of
// them, (n+1) * 28 bytes each with dirs_kind 1 (24 otherwise) rounded up to
// 16. Returns a cudaError_t code.
int rowcb_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
               const int32_t* lb, const int32_t* st, void* dirs,
               float* out, char* scratch, int mode, int B, int m, int n,
               int C, int threads, long long smem, float g, float h,
               float match, float mismatch, const float* table, int k1,
               int dirs_kind, int free_order, void* stream) {
    if (B == 0) return 0;
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        (long long)threads * C < n + 1 || mode < 0 || mode > 2 ||
        dirs_kind < kNoDirs || dirs_kind > kDirs8 ||
        (mode != 0 && (dirs_kind != kDirs16 || table)) ||
        (table && (k1 < 2 || k1 > 255 || dirs_kind == kDirs8 ||
                   free_order)) ||
        (dirs_kind == kDirs8 && !free_order) ||
        (dirs_kind == kNoDirs && free_order))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t sm = (size_t)smem;
#define ROWCB_LAUNCH(MODE, TABLE, DIRS, FREE)                                 \
    return launch<MODE, TABLE, DIRS, FREE>(a, b, la, lb, st, dirs, out,     \
                                           scratch, B, m, n, C, threads, sm, \
                                           g, h, match, mismatch, table, k1, \
                                           s)
    if (table && dirs_kind == kDirs16) ROWCB_LAUNCH(0, true, kDirs16, false);
    if (table) ROWCB_LAUNCH(0, true, kNoDirs, false);
    if (mode == 1) ROWCB_LAUNCH(1, false, kDirs16, true);
    if (mode == 2) ROWCB_LAUNCH(2, false, kDirs16, true);
    if (dirs_kind == kNoDirs) ROWCB_LAUNCH(0, false, kNoDirs, false);
    if (dirs_kind == kDirs8) ROWCB_LAUNCH(0, false, kDirs8, true);
    if (free_order) ROWCB_LAUNCH(0, false, kDirs16, true);
    ROWCB_LAUNCH(0, false, kDirs16, false);
#undef ROWCB_LAUNCH
}

// P-trim: the UNIFORM sweep (start type -1, every la = m) with omega in
// the free modes' order and no dirs; arguments as rowcb_fill's (no la, st
// or dirs). Returns a cudaError_t code.
int rowcb_trim_fill(const uint8_t* a, const uint8_t* b, const int32_t* lb,
                    float* out, char* scratch, int B, int m, int n, int C,
                    int threads, long long smem, float g, float h,
                    float match, float mismatch, void* stream) {
    if (B == 0) return 0;
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        (long long)threads * C < n + 1)
        return (int)cudaErrorInvalidValue;
    return launch<0, false, kNoDirs, true, true>(
        a, b, nullptr, lb, nullptr, nullptr, out, scratch, B, m, n, C,
        threads, (size_t)smem, g, h, match, mismatch, nullptr, 0,
        (cudaStream_t)stream);
}

}  // extern "C"
