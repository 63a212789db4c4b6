// Op-cost micro-probes for the H100 (sm_90a), plain C interface (wrappers
// in ops/micro.py).
//
// Two TPU probe kernels timed one class of vector operation inside a loop,
// by the difference of two step counts:
//   P-micro   the kernel _mk builds in scripts/kern_probe.py:31 (launched
//             at :45): `steps` passes of `ops` applications of one op on x
//             (R, W) f32 with y, then x = x * 0.5; it stored x[:8, :128];
//   P-micro2  the kernel _mk builds in scripts/kern_probe2.py:26 (launched
//             at :40): the same loop ending x = max(x * 0.5, -1e30); it
//             stored max(x) over every element.
// Here one template, micro_kernel<OP, AXIS, OPS, END>, runs that loop for
// each op class of kern_probe.py:153-170 and kern_probe2.py:128-156:
//   kAdd       x + y                      kMul     x * y
//   kMaxBlend  max(x + y, x * 0.99)       kWhere   x > y ? x + y : y
//   kChain     max(x * 0.99, y + x)
//   kShift     shift(x, s) + y, the vacated s lines' end filled with -3e38
//              (concatenate; as f32, not -inf)
//   kRoll      roll(x, s) + y, cyclic (pltpu.roll: out[j] = x[(j - s) mod L])
//   kRollMask  (j >= s ? roll(x, s) : -3e38) + y
//   kPrefix    log2(L) sweeps x = max(x, shift(x, s)), s = 1, 2, 4, ..., then
//              + y (the filled prefix max: op_prefix_logshift, op_prefix_lane,
//              op_prefix_sub)
//   kPrefixHybrid  the sweeps under 128 cyclic (roll), the rest filled
//              (op_prefix_hybrid): not a prefix max, since columns j with
//              j mod 128 < 127 take values from the end of the line
//   kPrefixRollMask  every sweep a masked roll (op_prefix_rollmask: the
//              filled prefix's values)
//   kPack      the _pack3 round trip over thirds a, b, c of the row (width
//              3 nl): a += y_a, b = max(b, a), c += b (op_packunpack)
// along AXIS 1 (the row: a CTA a row, kern_probe2's lane ops) or AXIS 0 (a
// CTA a column, its sublane ops). END 0 is P-micro's x * 0.5 (the kernel
// stores the whole x; the wrapper's caller reads the window), END 1 is
// P-micro2's max(x * 0.5, -1e30), and the kernel stores each CTA's max,
// which a second pass (max_kernel) reduces to one value: max is exact in
// any order.
//
// Design. A CTA owns one line of L elements; thread t holds elements
// [4t, 4t + 4) in registers (kPack: column 4t + c of each third, so it
// needs no exchange), so L / 4 <= 1,024 threads: W = 2,176 takes 544, the
// pack's 6,528 = 3 x 2,176 544 too. The elementwise classes stay in
// registers. Every shift, roll and sweep exchanges the line through a
// shared-memory row: each thread writes its elements, one barrier, each
// reads the element s before; the row alternates between two buffers, so
// one barrier an exchange is enough. The OPS applications of a step are
// unrolled (the TPU's Python loop); the steps are a loop.
//
// Bounds. Bytes are x and y read and the output written once, a few MB;
// the work is steps x ops x R x W operations, so every case is bound by
// operations (and by its dependent chain: each op of a step needs the one
// before).
//
// Numerics. float32, -fmad=false, every operation as the source writes
// it; the constants 0.99, 0.5, -3e38 and -1e30 are float32, so the plain
// twin (ops/micro.py) gives the same bits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kC = 4;  // elements a thread (of each third for kPack)
// op classes (ops/micro.py OPS)
constexpr int kAdd = 0, kMul = 1, kMaxBlend = 2, kWhere = 3, kChain = 4,
              kShift = 5, kRoll = 6, kRollMask = 7, kPrefix = 8,
              kPrefixHybrid = 9, kPrefixRollMask = 10, kPack = 11;
constexpr float kNegF = -3.0e38f;  // the probes' fill

template <int OP, int AXIS, int OPS, int END>
__global__ void __launch_bounds__(1024)
micro_kernel(const float* __restrict__ x, const float* __restrict__ y,
             float* __restrict__ out, float* __restrict__ cta_max, int R,
             int W, int steps, int s) {
    constexpr bool PACK = OP == kPack;
    constexpr int NV = PACK ? 3 * kC : kC;  // values a thread
    extern __shared__ float buf[];          // two rows of L floats
    __shared__ float wmax[32];
    const int line = blockIdx.x;
    const int L = PACK ? W / 3 : (AXIS == 1 ? W : R);  // exchanged length
    const int tid = threadIdx.x, c0 = tid * kC;
    // the thread's value v: its position along the line, and its address
    auto pos = [&](int v) { return c0 + v % kC; };
    auto addr = [&](int v) -> size_t {
        if (PACK) return (size_t)line * W + (v / kC) * L + pos(v);
        if (AXIS == 1) return (size_t)line * W + pos(v);
        return (size_t)pos(v) * W + line;
    };
    float xv[NV], yv[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        const bool in = pos(v) < L;
        xv[v] = in ? x[addr(v)] : 0.0f;
        yv[v] = in ? y[addr(v)] : 0.0f;
    }
    int par = 0;
    // the line's elements through shared memory: returns the row to read
    auto exchange = [&]() {
        float* row = buf + par * L;
#pragma unroll
        for (int v = 0; v < kC; ++v)
            if (pos(v) < L) row[pos(v)] = xv[v];
        __syncthreads();
        par ^= 1;
        return row;
    };
    // max(x, x at j - sh) for every element: filled (j < sh: -3e38) or,
    // with CYCLIC, from (j - sh) mod L
    auto sweep = [&](int sh, bool cyclic) {
        const float* row = exchange();
#pragma unroll
        for (int v = 0; v < kC; ++v) {
            const int j = pos(v);
            if (j >= L) continue;
            int t = (j - sh) % L;
            if (t < 0) t += L;
            const float o = (cyclic || j >= sh) ? row[t] : kNegF;
            xv[v] = fmaxf(xv[v], o);
        }
    };

#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
#pragma unroll
        for (int k = 0; k < OPS; ++k) {
            if (OP == kShift || OP == kRoll || OP == kRollMask) {
                const float* row = exchange();
#pragma unroll
                for (int v = 0; v < kC; ++v) {
                    const int j = pos(v);
                    if (j >= L) continue;
                    int t = j - s;
                    if (t < 0) t += L;
                    const float r = (OP == kRoll || j >= s) ? row[t] : kNegF;
                    xv[v] = r + yv[v];
                }
            } else if (OP == kPrefix || OP == kPrefixHybrid ||
                       OP == kPrefixRollMask) {
                int sh = 1;
                if (OP == kPrefixHybrid)
                    for (; sh < 128; sh <<= 1) sweep(sh, true);
                for (; sh < L; sh <<= 1) sweep(sh, false);
#pragma unroll
                for (int v = 0; v < kC; ++v) xv[v] = xv[v] + yv[v];
            } else if (PACK) {
#pragma unroll
                for (int c = 0; c < kC; ++c) {
                    const float a = xv[c] + yv[c];
                    const float b = fmaxf(xv[kC + c], a);
                    xv[c] = a;
                    xv[kC + c] = b;
                    xv[2 * kC + c] = xv[2 * kC + c] + b;
                }
            } else {
#pragma unroll
                for (int v = 0; v < NV; ++v) {
                    const float a = xv[v], b = yv[v];
                    if (OP == kAdd) xv[v] = a + b;
                    if (OP == kMul) xv[v] = a * b;
                    if (OP == kMaxBlend) xv[v] = fmaxf(a + b, a * 0.99f);
                    if (OP == kWhere) xv[v] = a > b ? a + b : b;
                    if (OP == kChain) xv[v] = fmaxf(a * 0.99f, b + a);
                }
            }
        }
#pragma unroll
        for (int v = 0; v < NV; ++v)
            xv[v] = END == 0 ? xv[v] * 0.5f : fmaxf(xv[v] * 0.5f, -1e30f);
    }

    if (END == 0) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
            if (pos(v) < L) out[addr(v)] = xv[v];
        return;
    }
    float m = -CUDART_INF_F;
#pragma unroll
    for (int v = 0; v < NV; ++v)
        if (pos(v) < L) m = fmaxf(m, xv[v]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, sh));
    if ((tid & 31) == 0) wmax[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
            m = fmaxf(m, wmax[w]);
        cta_max[line] = m;
    }
}

// the second pass of END 1: out[0] = the max of n CTA maxima
__global__ void __launch_bounds__(1024)
max_kernel(const float* __restrict__ cta_max, int n, float* __restrict__ out) {
    __shared__ float wmax[32];
    float m = -CUDART_INF_F;
    for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, cta_max[i]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, sh));
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
            m = fmaxf(m, wmax[w]);
        out[0] = m;
    }
}

template <int OP, int AXIS, int OPS, int END>
int launch_micro(const float* x, const float* y, float* out, float* cta,
                 int R, int W, int steps, int s, cudaStream_t stream) {
    const int L = OP == kPack ? W / 3 : (AXIS == 1 ? W : R);
    const int lines = AXIS == 1 || OP == kPack ? R : W;
    const int threads = ((L + kC - 1) / kC + 31) / 32 * 32;
    const size_t smem = 2 * (size_t)L * sizeof(float);
    micro_kernel<OP, AXIS, OPS, END><<<lines, threads, smem, stream>>>(
        x, y, out, cta, R, W, steps, s);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || END == 0) return (int)e;
    max_kernel<<<1, 1024, 0, stream>>>(cta, lines, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (R, W) f32; END 0: out (R, W) f32, cta unused; END 1: out (1,)
// f32, cta (lines,) f32 scratch (lines = R, or W at AXIS 0). The line
// (W, R at AXIS 0, W / 3 for kPack) is 2 to 4,096 long, 0 < s < it for the
// shifts and rolls. op, axis, ops, end: one of the instantiations below.
// Returns a cudaError_t code.
int micro_run(const float* x, const float* y, float* out, float* cta, int R,
              int W, int steps, int s, int op, int axis, int ops, int end,
              void* stream) {
    if (R < 1 || W < 1 || steps < 0) return (int)cudaErrorInvalidValue;
    const int L = op == kPack ? W / 3 : (axis == 1 ? W : R);
    if (L < 2 || L > 4 * 1024 || (op == kPack && W % 3 != 0))
        return (int)cudaErrorInvalidValue;
    if ((op == kShift || op == kRoll || op == kRollMask) && (s < 1 || s >= L))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define MI(OP, AX, OPS, END)                                                \
    if (op == (OP) && axis == (AX) && ops == (OPS) && end == (END))         \
        return launch_micro<(OP), (AX), (OPS), (END)>(x, y, out, cta, R, W, \
                                                      steps, s, st);
    // P-micro (kern_probe.py:153-170)
    MI(kAdd, 1, 12, 0)
    MI(kMul, 1, 12, 0)
    MI(kMaxBlend, 1, 12, 0)
    MI(kWhere, 1, 12, 0)
    MI(kShift, 1, 12, 0)
    MI(kRoll, 1, 12, 0)
    MI(kRollMask, 1, 12, 0)
    MI(kPrefix, 1, 1, 0)
    MI(kPrefixHybrid, 1, 1, 0)
    MI(kPrefixRollMask, 1, 1, 0)
    // P-micro2 (kern_probe2.py:128-156)
    MI(kChain, 1, 16, 1)
    MI(kShift, 1, 12, 1)
    MI(kShift, 0, 12, 1)
    MI(kRoll, 0, 12, 1)
    MI(kPrefix, 1, 1, 1)
    MI(kPrefix, 0, 1, 1)
    MI(kPack, 1, 4, 1)
#undef MI
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
