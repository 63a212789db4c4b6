// Smith-Waterman (local, affine-gap) fills and walk for the H100 (sm_90a),
// plain C interface.
//
// K9d sw_dirs replaces the TPU kernel _sw_dirs_kernel
// (cse305_parallel_sequence_alignment_tpu/ops/pallas_local.py:209): the
// anti-diagonal fill emitting one direction byte per cell in the skew
// layout dirs[i + j, pair, j] and the best T1 cell (value, i, j).
// K9s sw_score replaces _sw_score_kernel (same file, :118): the same sweep
// without dirs. Both are one template.
// K9w local_walk replaces the single-step walk _walk_core
// (ops/device_walk.py:35, XLA on the TPU) as walk_local_batch_device
// (:442) uses it, with that function's stop rule moved onto the card.
//
// Fill design. One CTA per pair sweeps the anti-diagonals d = 1..m+n;
// thread t owns the columns j = t, t + blockDim, ... of every diagonal,
// so a diagonal's byte stores are contiguous and coalesce. Three diagonal
// buffers (d, d-1, d-2) of T1/T2/T3 rotate in shared memory, or in global
// scratch that the wrapper allocates when the row is too wide; one block
// barrier per diagonal orders the write of d before the reads of d+1 and
// the reads of d-2 before its slot is rewritten at d+1. T2 chains along
// the row exactly as the JAX fill does (T2(i, j-1) - g), so any float
// parameters give the JAX bits. Each thread keeps its own running best
// (strict >, visited in (d, j) order); a warp-shuffle and a shared-memory
// reduction then take the largest value, the smallest d, the smallest j:
// the key of the JAX kernels' per-diagonal update.
//
// Bounds. Per interior cell ~24 float operations and compares, and for
// K9d one byte stored: the (m+n+1)(n+1) bytes of a pair's dirs are ~8.4
// MB at 2 kb, so 4096 pairs write ~34 GB, ~10 ms of HBM bandwidth, while
// the float work is ~7 ms at the fp32 peak. What binds is the per-diagonal
// barrier and the dependent chain d-2 -> d-1 -> d inside each CTA; two
// CTAs of up to 1024 threads share an SM to hide it.
//
// Walk design. One thread per pair, from (end_i, end_j) in T1: each step
// records the current table (1-3) and moves by it (T1 diagonal, T2 left,
// T3 up) into the table named by the current cell's code. It stops before
// a predecessor on row 0 or column 0, or a predecessor T1 cell whose own
// code is 3 (a start), with one dependent byte load per step; the peek's
// load is the next step's read. A walk is a chain of dependent loads
// (latency, not bandwidth, binds it); the pairs run side by side and a
// step's stores, contiguous across pairs, coalesce.
//
// Numerics. float32 with true -inf and the JAX order of operations (built
// with -fmad=false, so no multiply-add is contracted):
//   T1 = max(f + max(max(T1, T2), T3)(i-1, j-1), 0)
//   T2 = max(max(T1 - gh, T2 - g), T3 - gh) at (i, j-1)
//   T3 = max(max(T1 - gh, T2 - gh), T3 - g) at (i-1, j)
// with gh = g + h rounded to float32: the JAX source writes x - g - h and
// XLA folds its two constants into one subtraction, so this is the JAX
// package's arithmetic at any parameters, dyadic or not.
// Direction codes use the tie order T1 >= T2 >= T3; T1's code is 3 when
// f + max3 > 0 is false.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kReduceBytes = 512;  // per-warp best (value, d, j)

__device__ __forceinline__ int argmax3(float c1, float c2, float c3) {
    return (c1 >= c2 && c1 >= c3) ? 0 : (c2 >= c3 ? 1 : 2);
}

// (v1, d1, j1) ranks before (v2, d2, j2): larger value, then the earlier
// diagonal, then the smaller column
__device__ __forceinline__ bool ranks_before(float v1, int d1, int j1,
                                             float v2, int d2, int j2) {
    return v1 > v2 || (v1 == v2 && (d1 < d2 || (d1 == d2 && j1 < j2)));
}

template <bool DIRS>
__global__ void __launch_bounds__(kMaxThreads)
sw_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
          const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
          uint8_t* __restrict__ dirs, float* __restrict__ best,
          char* __restrict__ scratch, int B, int m, int n, float g, float h,
          float match, float mismatch) {
    extern __shared__ __align__(16) char smem[];
    const int pair = blockIdx.x;
    const int ncol = n + 1;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds the JAX fill's x - g - h

    // shared layout: per-warp best (3 x 32 words) | diagonal buffers
    // buf[slot][table][col] when they fit (else in global scratch)
    float* wv = reinterpret_cast<float*>(smem);
    int* wd = reinterpret_cast<int*>(smem + 128);
    int* wj = reinterpret_cast<int*>(smem + 256);
    float* buf = scratch
        ? reinterpret_cast<float*>(scratch) + (size_t)pair * 9 * ncol
        : reinterpret_cast<float*>(smem + kReduceBytes);
    auto T = [&](int slot, int k) { return buf + (size_t)(slot * 3 + k) * ncol; };

    const int lA = la[pair], lB = lb[pair];
    const uint8_t* arow = a + (size_t)pair * m;
    const uint8_t* brow = b + (size_t)pair * n;
    const size_t diag_stride = (size_t)B * ncol;  // dirs (m+n+1, B, ncol)

    // diagonal 0 in slot 0 (T1 = 0 at the corner), diagonal -1 in slot 2
    for (int j = tid; j < ncol; j += nthr) {
        T(0, 0)[j] = j == 0 ? 0.0f : NEG;
        T(0, 1)[j] = NEG;
        T(0, 2)[j] = NEG;
        T(2, 0)[j] = NEG;
        T(2, 1)[j] = NEG;
        T(2, 2)[j] = NEG;
        if (DIRS) dirs[(size_t)pair * ncol + j] = 0;
    }
    __syncthreads();

    float bv = 0.0f;
    int bd = 0, bj = 0;
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
        uint8_t* drow = DIRS ? dirs + (size_t)d * diag_stride +
                                   (size_t)pair * ncol
                             : nullptr;
        for (int j = tid; j < ncol; j += nthr) {
            const int i = d - j;
            uint8_t packed = 0;
            if (i >= 0 && i <= m) {
                float t1 = 0.0f, t2 = NEG, t3 = NEG;  // row 0 / column 0
                if (i > 0 && j > 0) {
                    const float s1 = Q1[j - 1], s2 = Q2[j - 1],
                                s3 = Q3[j - 1];
                    const float l1 = P1[j - 1], l2 = P2[j - 1],
                                l3 = P3[j - 1];
                    const float u1 = P1[j], u2 = P2[j], u3 = P3[j];
                    const float f =
                        __ldg(arow + i - 1) == __ldg(brow + j - 1) ? match
                                                                   : mismatch;
                    const float open = f + fmaxf(fmaxf(s1, s2), s3);
                    t1 = fmaxf(open, 0.0f);
                    const float c2a = l1 - gh, c2b = l2 - g, c2c = l3 - gh;
                    t2 = fmaxf(fmaxf(c2a, c2b), c2c);
                    const float c3a = u1 - gh, c3b = u2 - gh, c3c = u3 - g;
                    t3 = fmaxf(fmaxf(c3a, c3b), c3c);
                    if (DIRS) {
                        const int d1 = open > 0.0f ? argmax3(s1, s2, s3) : 3;
                        packed = (uint8_t)(d1 | (argmax3(c2a, c2b, c2c) << 2) |
                                           (argmax3(c3a, c3b, c3c) << 4));
                    }
                    if (i <= lA && j <= lB && t1 > bv) {
                        bv = t1;
                        bd = d;
                        bj = j;
                    }
                }
                C1[j] = t1;
                C2[j] = t2;
                C3[j] = t3;
            }
            if (DIRS) drow[j] = packed;
        }
        __syncthreads();
    }

    // block reduction of the per-thread bests
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, s);
        const int od = __shfl_down_sync(0xffffffffu, bd, s);
        const int oj = __shfl_down_sync(0xffffffffu, bj, s);
        if (ranks_before(ov, od, oj, bv, bd, bj)) {
            bv = ov;
            bd = od;
            bj = oj;
        }
    }
    if (lane == 0) {
        wv[warp] = bv;
        wd[warp] = bd;
        wj[warp] = bj;
    }
    __syncthreads();
    if (warp == 0) {
        const int nwarps = nthr >> 5;
        bv = lane < nwarps ? wv[lane] : 0.0f;
        bd = lane < nwarps ? wd[lane] : 0;
        bj = lane < nwarps ? wj[lane] : 0;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, bv, s);
            const int od = __shfl_down_sync(0xffffffffu, bd, s);
            const int oj = __shfl_down_sync(0xffffffffu, bj, s);
            if (ranks_before(ov, od, oj, bv, bd, bj)) {
                bv = ov;
                bd = od;
                bj = oj;
            }
        }
        if (lane == 0) {
            const bool pos = bv > 0.0f;  // no positive cell: (0, 0, 0)
            best[pair * 3 + 0] = pos ? bv : 0.0f;
            best[pair * 3 + 1] = pos ? (float)(bd - bj) : 0.0f;
            best[pair * 3 + 2] = pos ? (float)bj : 0.0f;
        }
    }
}

template <bool DIRS>
int launch_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
                const int32_t* lb, uint8_t* dirs, float* best, char* scratch,
                int B, int m, int n, int threads, size_t smem, float g,
                float h, float match, float mismatch, cudaStream_t stream) {
    if (B == 0) return 0;
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        smem < (size_t)kReduceBytes)
        return (int)cudaErrorInvalidValue;
    auto kern = sw_kernel<DIRS>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, threads, smem, stream>>>(a, b, la, lb, dirs, best, scratch, B,
                                       m, n, g, h, match, mismatch);
    return (int)cudaGetLastError();
}

__global__ void local_walk_kernel(const uint8_t* __restrict__ dirs,
                                  const int32_t* __restrict__ ei,
                                  const int32_t* __restrict__ ej,
                                  uint8_t* __restrict__ ops,
                                  int32_t* __restrict__ used, int B,
                                  int nrows, int ncols, int max_steps) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int i = ei[b], j = ej[b], t = 1, k = 0;
    if (i > 0 && j > 0 && j < ncols && i + j < nrows) {
        int byte = dirs[((size_t)(i + j) * B + b) * ncols + j];
        while (k < max_steps) {
            const int code = (byte >> (2 * (t - 1))) & 3;
            if (t == 1 && code == 3) break;  // a start cell is not aligned
            ops[(size_t)k * B + b] = (uint8_t)t;
            ++k;
            const int pi = i - (t != 2), pj = j - (t != 3);
            if (pi == 0 || pj == 0) break;  // the predecessor is an edge
            byte = dirs[((size_t)(pi + pj) * B + b) * ncols + pj];
            const int pt = code + 1;
            if (pt == 1 && (byte & 3) == 3) break;  // ... or a start cell
            i = pi;
            j = pj;
            t = pt;
        }
    }
    atomicMax(used, k);
}

}  // namespace

extern "C" {

// a: (B, m) u8; b: (B, n) u8; la/lb: (B,) i32; dirs: (m+n+1, B, n+1) u8;
// best: (B, 3) f32 [value, end_i, end_j]; threads a multiple of 32 up to
// 1024; smem: 512 bytes, plus 9 (n+1) floats of diagonal buffers unless
// scratch holds B such buffers. Returns a cudaError_t code.
int sw_dirs(const uint8_t* a, const uint8_t* b, const int32_t* la,
            const int32_t* lb, uint8_t* dirs, float* best, char* scratch,
            int B, int m, int n, int threads, long long smem, float g,
            float h, float match, float mismatch, void* stream) {
    return launch_fill<true>(a, b, la, lb, dirs, best, scratch, B, m, n,
                             threads, (size_t)smem, g, h, match, mismatch,
                             (cudaStream_t)stream);
}

int sw_score(const uint8_t* a, const uint8_t* b, const int32_t* la,
             const int32_t* lb, float* best, char* scratch, int B, int m,
             int n, int threads, long long smem, float g, float h,
             float match, float mismatch, void* stream) {
    return launch_fill<false>(a, b, la, lb, nullptr, best, scratch, B, m, n,
                              threads, (size_t)smem, g, h, match, mismatch,
                              (cudaStream_t)stream);
}

// dirs: (nrows, B, ncols) u8 from sw_dirs; ei/ej: (B,) i32 end cells;
// ops: (max_steps, B) u8 zeroed by the caller, ops[k, b] = the table (1-3)
// of pair b's k-th chain point from the end; used: one i32 zeroed by the
// caller, the largest chain length. Returns a cudaError_t code.
int local_walk(const uint8_t* dirs, const int32_t* ei, const int32_t* ej,
               uint8_t* ops, int32_t* used, int B, int nrows, int ncols,
               int max_steps, void* stream) {
    if (B == 0) return 0;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    local_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dirs, ei, ej, ops, used, B, nrows, ncols, max_steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
