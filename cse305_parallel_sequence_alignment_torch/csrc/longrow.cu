// Column-strip staircase long fill for the H100 (sm_90a), plain C interface.
//
// K6 (wrapper ops/longrow.py long_fill) replaces the TPU kernel
// _longrow_kernel (cse305_parallel_sequence_alignment_tpu/ops/
// pallas_longrow.py:79, launched by _pallas_longrow :219): the Gotoh score
// sweep of a batch of jobs of any width, each with its own start type,
// capturing either the finals (T1, T2, T3) at (la, lb) or the whole row la,
// (3, n+1). K7 (wrapper ops/longstair.py stair_lastrow_device) replaces
// _stair_kernel (ops/pallas_longstair.py:81, launched by _pallas_stair
// :278), one job's last row at full utilisation: the same kernel launched
// for one job, whose strips alone cover the card.
//
// Design. Each job is cut into column strips of W = threads * C columns,
// and one CTA sweeps all rows 1..la of one strip with the in-CTA row scan
// of csrc/rowcb.cu: each thread owns C columns; T2's prefix max is a pass
// over the thread's columns, a warp-shuffle scan and the warp totals in
// shared memory. At every row the strip's left edge needs three values at
// the last column of strip s-1, which that strip writes to global memory
// as a record per row
//     [max3(T1,T2,T3) of row i, max(T1,T3) of row i,
//      prefix max of omega up to the column]
// and publishes with a row counter (release store, every kPublish rows);
// thread 0 of strip s waits on it with acquire loads. The max3 of row i
// goes into a halo column (index -1 of the row buffers), where it feeds
// T1's diagonal on row i+1; max(T1,T3) feeds omega of the strip's first
// column, and the prefix max seeds thread 0's running max, so the block
// scan carries it to the whole strip. All three are max and add of the
// very values the whole-row sweep uses, so every cell is bit-equal to the
// plain version (ops/rowcb.py _sweep_plain) and to the TPU kernels, which
// exchange the same records between column chunks.
//
// Deadlock. A CTA that waits needs its producer resident. Each CTA takes
// its (job, strip) from an atomic ticket in the order CTAs start, strip
// before strip within a job, so the strip it waits on started earlier
// and is running or done.
//
// Bounds. Per cell ~17 float operations and no device-memory traffic but
// the two sequences, 16 bytes of record per row and strip, and the output
// (12 bytes a cell of the last row, or 12 bytes a job): a 48 k x 97 k job
// is ~80 G operations, ~1.2 ms at the fp32 peak, and ~0.3 GB of records.
// What binds is the serial chain of a row inside a CTA (two passes over a
// thread's columns) and its two block barriers. The wrapper picks the
// strip width so that about two CTAs per SM are in flight, whose rows
// overlap; the staircase costs a start-up of one publication interval per
// strip.
//
// Numerics. float32 with true -inf, built with -fmad=false, the operation
// order that XLA runs for the JAX kernels, gh = g + h rounded to float32
// (XLA folds the JAX source's x - g - h into one subtraction):
//   T1 = fb + max3(prev row, j-1)
//   T3 = max(max(T1,T2)(prev, j) - gh, T3(prev, j) - g)
//   omega = (g*j + max(T1,T3)(j-1)) - gh,  T2 = prefixmax(omega) - g*j

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPublish = 4;  // rows between two releases of a strip's counter

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

// Row 0 at global column gj (reference boundary; quirk: +2 acts as -1).
__device__ __forceinline__ void row0(int gj, int sta, float g, float h,
                                     float& r1, float& r2, float& r3) {
    const float NEG = -CUDART_INF_F;
    r1 = NEG;
    r3 = NEG;
    if (gj == 0) {
        r1 = (sta == 1 || sta == -1) ? 0.0f : NEG;
        r2 = (sta == -2) ? 0.0f : NEG;
        r3 = (sta == -3) ? 0.0f : NEG;
    } else {
        const float jg = g * (float)gj;
        r2 = (sta == -2) ? -jg : ((sta == 1 || sta == 3) ? NEG : -h - jg);
    }
}

__global__ void __launch_bounds__(kMaxThreads)
strip_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
             const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
             const int32_t* __restrict__ st, float* __restrict__ out,
             float4* rec, int* cnt, int* ticket, int m, int n, int C,
             int nstrips, int want_row, float g, float h, float match,
             float mismatch) {
    extern __shared__ __align__(16) char smem[];
    __shared__ int s_cta;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h
    if (tid == 0) s_cta = atomicAdd(ticket, 1);
    __syncthreads();
    const int job = s_cta / nstrips, s = s_cta % nstrips;
    const int W = blockDim.x * C;  // strip width
    const int ncol = n + 1;
    const int g0 = s * W;          // global column of local column 0
    const int wcols = min(W, ncol - g0);

    // shared: warp totals (32 f32) | b_ext (W u8, 16-aligned) | row
    // buffers [2 parities][T1, T2, T3][W + 1], local column -1 = halo
    float* wsum = reinterpret_cast<float*>(smem);
    uint8_t* bext = reinterpret_cast<uint8_t*>(smem + 128);
    float* rows = reinterpret_cast<float*>(smem + 128 + ((W + 15) & ~15));
    const int stride = W + 1;
#define TBUF(buf, k) (rows + ((buf) * 3 + (k)) * stride + 1)

    const int sta = st[job], lA = la[job], lB = lb[job];
    const uint8_t* arow = a + (size_t)job * m;
    const uint8_t* brow = b + (size_t)job * n;
    for (int j = tid; j < wcols; j += blockDim.x) {
        const int gj = g0 + j;
        bext[j] = gj == 0 ? (uint8_t)255 : brow[gj - 1];
    }
    const int c0 = tid * C;
    const int c1 = min(c0 + C, wcols);
    float* fin = out + (size_t)job * 3;          // finals mode: (B, 3)
    float* orow = out + (size_t)job * 3 * ncol;  // row mode: (B, 3, ncol)
    const size_t strip_id = (size_t)job * nstrips + s;
    // the strip's last column produces records, unless it is the last strip
    const bool producer = s + 1 < nstrips && c0 < c1 && c1 == W;

    // row 0, and the halo: row 0 at column g0-1
    for (int j = c0; j < c1; ++j) {
        float r1, r2, r3;
        row0(g0 + j, sta, g, h, r1, r2, r3);
        TBUF(0, 0)[j] = r1;
        TBUF(0, 1)[j] = r2;
        TBUF(0, 2)[j] = r3;
        if (lA == 0) {
            if (want_row) {
                orow[g0 + j] = r1;
                orow[ncol + g0 + j] = r2;
                orow[2 * ncol + g0 + j] = r3;
            } else if (g0 + j == lB) {
                fin[0] = r1;
                fin[1] = r2;
                fin[2] = r3;
            }
        }
    }
    if (tid == 0) {
        float r1 = NEG, r2 = NEG, r3 = NEG;
        if (s > 0) row0(g0 - 1, sta, g, h, r1, r2, r3);
        TBUF(0, 0)[-1] = r1;
        TBUF(0, 1)[-1] = r2;
        TBUF(0, 2)[-1] = r3;
    }
    __syncthreads();

    int avail = 0;  // rows of strip s-1 seen published (thread 0)
    for (int i = 1; i <= lA; ++i) {
        const int cur = i & 1, prv = cur ^ 1;
        const float* P1 = TBUF(prv, 0);
        const float* P2 = TBUF(prv, 1);
        const float* P3 = TBUF(prv, 2);
        float* Q1 = TBUF(cur, 0);
        float* Q2 = TBUF(cur, 1);
        float* Q3 = TBUF(cur, 2);
        const int ac = arow[i - 1];
        const float fi = (float)i;
        // column 0 of T3 (quirk: +3 acts as -1 on column 0)
        const float col0_3 = (sta == -3) ? -g * fi
                           : ((sta == 1 || sta == 2) ? NEG : -h - g * fi);

        // pass 1: T1, T3 and the chunk-local prefix max of omega
        float run_max = NEG;
        float lm3 = NEG;   // max3 of the previous row at j-1
        float m13l = NEG;  // max(T1, T3) of this row at j-1
        if (tid == 0 && s > 0) {
            // left edge: strip s-1's record of row i
            const int* flag = cnt + strip_id - 1;
            if (avail < i) {
                while ((avail = ld_acquire(flag)) < i) __nanosleep(64);
            }
            const float4 r = __ldcg(rec + (strip_id - 1) * m + (i - 1));
            lm3 = fmaxf(fmaxf(P1[-1], P2[-1]), P3[-1]);
            m13l = r.y;
            run_max = r.z;
            Q1[-1] = r.x;  // halo of row i, read on row i+1
            Q2[-1] = NEG;
            Q3[-1] = NEG;
        } else if (c0 > 0 && c0 < c1) {
            // left neighbour column, recomputed from the previous row
            const int jl = c0 - 1;
            const float q12 = fmaxf(P1[jl], P2[jl]);
            const float q3v = P3[jl];
            float t1l = NEG, t3l = col0_3;
            if (g0 + jl > 0) {
                const float mp3ll = fmaxf(fmaxf(P1[jl - 1], P2[jl - 1]),
                                          P3[jl - 1]);
                const float fbl = bext[jl] == ac ? match : mismatch;
                t1l = fbl + mp3ll;
                t3l = fmaxf(q12 - gh, q3v - g);
            }
            lm3 = fmaxf(q12, q3v);
            m13l = fmaxf(t1l, t3l);
        }
        for (int j = c0; j < c1; ++j) {
            const int gj = g0 + j;
            const float p1 = P1[j], p2 = P2[j], p3 = P3[j];
            const float mp12 = fmaxf(p1, p2);
            const float mp3 = fmaxf(mp12, p3);
            float t1 = NEG, t3 = col0_3, omega = NEG;
            if (gj > 0) {
                const float fb = bext[j] == ac ? match : mismatch;
                t1 = fb + lm3;
                t3 = fmaxf(mp12 - gh, p3 - g);
                omega = (g * (float)gj + m13l) - gh;
            }
            run_max = fmaxf(run_max, omega);
            Q1[j] = t1;
            Q3[j] = t3;
            Q2[j] = run_max;  // chunk-local prefix; fixed in pass 2
            lm3 = mp3;
            m13l = fmaxf(t1, t3);
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

        // pass 2: T2, the capture of row la, the record of the last column
        for (int j = c0; j < c1; ++j) {
            const int gj = g0 + j;
            const float pm = fmaxf(Q2[j], excl);
            const float t2 = gj == 0 ? NEG : pm - g * (float)gj;
            Q2[j] = t2;
            if (i == lA) {
                if (want_row) {
                    orow[gj] = Q1[j];
                    orow[ncol + gj] = t2;
                    orow[2 * ncol + gj] = Q3[j];
                } else if (gj == lB) {
                    fin[0] = Q1[j];
                    fin[1] = t2;
                    fin[2] = Q3[j];
                }
            }
            if (producer && j == W - 1) {
                const float t1 = Q1[j], t3 = Q3[j];
                __stcg(rec + strip_id * m + (i - 1),
                       make_float4(fmaxf(fmaxf(t1, t2), t3), fmaxf(t1, t3),
                                   pm, 0.0f));
                if (i % kPublish == 0 || i == lA) st_release(cnt + strip_id, i);
            }
        }
        __syncthreads();
    }
#undef TBUF
}

}  // namespace

extern "C" {

// a: (B, m) u8; b: (B, n) u8; la/lb/st: (B,) i32; out: finals (B, 3) f32
// or, with want_row, rows (B, 3, n+1) f32; rec: B * nstrips * m records
// of 4 f32; cnt: B * nstrips i32 zeros; ticket: one i32 zero. threads a
// multiple of 32, C columns per thread, nstrips * threads * C >= n + 1;
// smem bytes = 128 + (threads*C rounded up to 16) + 24 * (threads*C + 1).
// Returns a cudaError_t code.
int long_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
              const int32_t* lb, const int32_t* st, float* out, void* rec,
              int* cnt, int* ticket, int B, int m, int n, int C, int threads,
              int nstrips, int want_row, long long smem, float g, float h,
              float match, float mismatch, void* stream) {
    if (B == 0) return 0;
    cudaError_t e = cudaFuncSetAttribute(
        strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    strip_kernel<<<B * nstrips, threads, (size_t)smem,
                   (cudaStream_t)stream>>>(
        a, b, la, lb, st, out, static_cast<float4*>(rec), cnt, ticket, m, n,
        C, nstrips, want_row, g, h, match, mismatch);
    return (int)cudaGetLastError();
}

}  // extern "C"
