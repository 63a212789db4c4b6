// One step of the column-sharded long-pair pipeline for the H100 (sm_90a),
// plain C interface.
//
// K8 (wrapper ops/halostair.py halostair_step) replaces the TPU kernel
// _halostair_kernel (cse305_parallel_sequence_alignment_tpu/ops/
// pallas_halostair.py:93, launched by halostair_step :243): one pipeline
// macro-step of one mesh entry of parallel/longseq.py, which advances the
// rows base+1 .. base+rows of the entry's column block [cs, cs + nc).
//
// What it computes. The 2-carry form of Gotoh's recurrence, with the row
// carry (H, T3) of row base loaded from `state` at the start of the call
// and stored back at its end:
//   T1 = f(A[i], B[j]) + H(i-1, j-1)
//   T3 = max((H(i-1, j) - g) - h, T3(i-1, j) - g)   column 0: closed form
//   omega = (g*j - gh) + max(T1, T3)(i, j-1)
//   T2 = max(prefix max of omega, the left record's prefix max) - g*j
//   H = max(max(T1, T3), T2)
// float32 with true -inf, built with -fmad=false, in the operation order
// that XLA runs for the JAX kernel: it folds omega's constant g*j - g - h
// into g*j - gh with gh = g + h rounded to float32, and leaves T3's
// H - g - h as two subtractions. So every cell is bit-equal to the plain
// version
// (ops/halostair.py halostair_step_plain). The records of the block's left
// ghost column cs-1 come in as `halo_in`, one float4 a row,
//   [max(T1, T3), prefix max of omega, H, -inf],
// whose row 0 (row base) carries the diagonal H(base, cs-1); the same
// records of the block's last column go out as `halo_out`, which the
// next mesh entry reads at the next pipeline step. T1, T2 and T3 of row
// la are written to `fin` when la falls into the call (`cap`).
//
// Design. The strip staircase of csrc/longrow.cu: the block is cut into
// column strips of W = threads * C columns, one CTA a strip running the
// in-CTA row scan (a pass over each thread's C columns, a warp-shuffle
// scan of the chunk maxima, a second pass). Strip s reads its left edge
// from strip s-1's records, which that strip writes per row to global
// memory and publishes with a release store of its count every kPublish
// rows; thread 0 of strip s waits on the count with acquire loads. Strip 0
// reads `halo_in`, and the last strip writes its records straight into
// `halo_out`. Record 0 of a strip is H of row base at its last column, so
// no strip reads another's carries, which that strip overwrites at the end
// of the call. A CTA takes its strip from an atomic ticket in the order
// CTAs start, so the strip it waits on is resident (no deadlock).
//
// The TPU kernel's layout workarounds are not carried over: no S x nl_c
// super-window of sub-chunks, no 128-lane broadcast records, no pre-skewed
// A plane; rows of A are read as codes.
//
// Bounds. Per cell ~15 float operations and compares (pass 1: the base
// compare, T1's add, T3's three subtractions and max, max(T1, T3), omega's
// multiply, subtraction and add, the running max; pass 2: the max with
// the block prefix, T2's multiply and subtraction, H's max) and no device
// memory traffic but the carries (20 bytes a column in and out), the two
// sequences and 16 bytes of record a row and strip. What binds is the
// serial chain of a row inside a CTA and its two barriers, and the
// staircase start-up of one publication interval per strip, paid again
// by every call.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPublish = 4;  // rows between two releases of a strip's count

__device__ __forceinline__ float warp_incl_max(float v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        float o = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v = fmaxf(v, o);
    }
    return v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
halostair_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 const float4* __restrict__ halo_in, float4* halo_out,
                 float* __restrict__ state, float* __restrict__ fin,
                 float4* rec, int* cnt, int* ticket, int nc, int R, int rows,
                 int cap, int cs, int base, int sta, int C, int nstrips,
                 float g, float h, float match, float mismatch) {
    extern __shared__ __align__(16) char smem[];
    __shared__ int s_cta;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds g*j - g - h
    if (tid == 0) s_cta = atomicAdd(ticket, 1);
    __syncthreads();
    const int s = s_cta;
    const int W = blockDim.x * C;  // strip width
    const int g0 = s * W;          // block column of local column 0
    const int wcols = min(W, nc - g0);

    // shared: warp totals (32 f32) | b (W u8, 16-aligned) | H and T3 of
    // two row parities, [W + 1] each, local column -1 = the left edge's H
    // | max(T1, T3) of the current row [W]
    float* wsum = reinterpret_cast<float*>(smem);
    uint8_t* bl = reinterpret_cast<uint8_t*>(smem + 128);
    float* bufs = reinterpret_cast<float*>(smem + 128 + ((W + 15) & ~15));
    const int stride = W + 1;
#define HBUF(p) (bufs + (2 * (p)) * stride + 1)
#define TBUF(p) (bufs + (2 * (p) + 1) * stride + 1)
    float* m13b = bufs + 4 * stride;

    for (int j = tid; j < wcols; j += blockDim.x) bl[j] = b[g0 + j];
    const int c0 = tid * C;
    const int c1 = min(c0 + C, wcols);
    const bool last = s + 1 == nstrips;
    float4* out_rec = last ? halo_out : rec + (size_t)s * (R + 1);
    const float4* in_rec = s == 0 ? halo_in : rec + (size_t)(s - 1) * (R + 1);
    const int* in_cnt = cnt + (s > 0 ? s - 1 : 0);  // read when s > 0
    // the thread of the strip's last column writes its records
    const bool owner = c0 < c1 && c1 == wcols;

    // row base: the carries, and record 0 (H at the strip's last column)
    for (int j = c0; j < c1; ++j) {
        HBUF(0)[j] = state[g0 + j];
        TBUF(0)[j] = state[nc + g0 + j];
    }
    if (owner) {
        out_rec[0] = make_float4(NEG, NEG, HBUF(0)[c1 - 1], NEG);
        if (!last) st_release(cnt + s, 1);
    }
    int avail = 0;  // records of strip s-1 seen published (thread 0)
    if (tid == 0) {
        if (s > 0) {
            while ((avail = ld_acquire(in_cnt)) < 1) __nanosleep(64);
        }
        HBUF(0)[-1] = __ldcg(in_rec).z;  // H(base, g0 - 1)
    }
    __syncthreads();

    for (int r = 1; r <= rows; ++r) {
        const int cur = r & 1, prv = cur ^ 1;
        const float* HP = HBUF(prv);
        const float* TP = TBUF(prv);
        float* HQ = HBUF(cur);
        float* TQ = TBUF(cur);
        const int ac = a[r - 1];
        const float fi = (float)(base + r);
        // column 0 of T3 (quirk: +3 acts as -1 on column 0)
        const float col0_3 = (sta == -3) ? -g * fi
                           : ((sta == 1 || sta == 2) ? NEG : -h - g * fi);

        // pass 1: T1, T3, max(T1, T3) and the chunk-local prefix max of
        // omega; HQ holds the prefix until pass 2
        float run_max = NEG;
        float m13l = NEG;  // max(T1, T3) of this row at column j-1
        if (tid == 0) {
            // left edge: record r of column g0-1
            if (s > 0 && avail < r + 1) {
                while ((avail = ld_acquire(in_cnt)) < r + 1) __nanosleep(64);
            }
            const float4 e = __ldcg(in_rec + r);
            m13l = e.x;
            run_max = e.y;
            HQ[-1] = e.z;  // H(i, g0 - 1), the diagonal of row i+1
        } else if (c0 < c1) {
            // left neighbour column, recomputed from the previous row
            const int jl = c0 - 1;
            const float t1l = (bl[jl] == ac ? match : mismatch) + HP[jl - 1];
            float t3l = fmaxf((HP[jl] - g) - h, TP[jl] - g);
            if (cs + g0 + jl == 0) t3l = col0_3;
            m13l = fmaxf(t1l, t3l);
        }
        for (int j = c0; j < c1; ++j) {
            const int gj = cs + g0 + j;
            const float t1 = (bl[j] == ac ? match : mismatch) + HP[j - 1];
            float t3 = fmaxf((HP[j] - g) - h, TP[j] - g);
            if (gj == 0) t3 = col0_3;
            const float m13 = fmaxf(t1, t3);
            const float omega = (g * (float)gj - gh) + m13l;
            run_max = fmaxf(run_max, omega);
            TQ[j] = t3;
            m13b[j] = m13;
            HQ[j] = run_max;
            m13l = m13;
        }

        // block scan: exclusive prefix max of the chunk maxima
        const float incl = warp_incl_max(run_max);
        if (lane == 31) wsum[warp] = incl;
        __syncthreads();
        float wpre = (lane < warp) ? wsum[lane] : NEG;
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
            wpre = fmaxf(wpre, __shfl_xor_sync(0xffffffffu, wpre, k));
        float inwarp = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) inwarp = NEG;
        const float excl = fmaxf(wpre, inwarp);

        // pass 2: T2 and H, the capture of row la, the strip's record
        for (int j = c0; j < c1; ++j) {
            const int gj = cs + g0 + j;
            const float pm = fmaxf(HQ[j], excl);
            const float t2 = pm - g * (float)gj;
            const float hn = fmaxf(m13b[j], t2);
            HQ[j] = hn;
            if (r == cap) {
                fin[g0 + j] = (bl[j] == ac ? match : mismatch) + HP[j - 1];
                fin[nc + g0 + j] = t2;
                fin[2 * nc + g0 + j] = TQ[j];
            }
            if (owner && j == c1 - 1) {
                __stcg(out_rec + r, make_float4(m13b[j], pm, hn, NEG));
                if (!last && (r % kPublish == 0 || r == rows))
                    st_release(cnt + s, r + 1);
            }
        }
        __syncthreads();
    }

    // row base + rows: the carries
    const int fp = rows & 1;
    for (int j = c0; j < c1; ++j) {
        state[g0 + j] = HBUF(fp)[j];
        state[nc + g0 + j] = TBUF(fp)[j];
    }
#undef HBUF
#undef TBUF
}

}  // namespace

extern "C" {

// a: (R,) u8; b: (nc,) u8; halo_in, halo_out: (R + 1) float4; state:
// (2, nc) f32 and fin: (3, nc) f32, both updated in place; rec: (nstrips -
// 1) * (R + 1) float4 of scratch; cnt: nstrips + 1 i32 zeros (the strips'
// counts, then the ticket). rows in 1..R; cap in 1..rows or 0; threads a
// multiple of 32, C columns per thread, nstrips * threads * C >= nc; smem
// bytes = 128 + (threads*C rounded up to 16) + 4 * (5 * threads*C + 4).
// Returns a cudaError_t code.
int halostair_step(const uint8_t* a, const uint8_t* b, const void* halo_in,
                   void* halo_out, float* state, float* fin, void* rec,
                   int* cnt, int nc, int R, int rows, int cap, int cs,
                   int base, int sta, int C, int threads, int nstrips,
                   long long smem, float g, float h, float match,
                   float mismatch, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        halostair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    halostair_kernel<<<nstrips, threads, (size_t)smem,
                       (cudaStream_t)stream>>>(
        a, b, static_cast<const float4*>(halo_in),
        static_cast<float4*>(halo_out), state, fin,
        static_cast<float4*>(rec), cnt, cnt + nstrips, nc, R, rows, cap, cs,
        base, sta, C, nstrips, g, h, match, mismatch);
    return (int)cudaGetLastError();
}

}  // extern "C"
