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
// version (ops/halostair.py halostair_step_plain). The records of the
// block's left ghost column cs-1 come in as `halo_in`, one float4 a row,
//   [max(T1, T3), prefix max of omega, H, -inf],
// whose row 0 (row base) carries the diagonal H(base, cs-1); the same
// records of the block's last column go out as `halo_out`, which the
// next mesh entry reads at the next pipeline step. T1, T2 and T3 of row
// la are written to `fin` when la falls into the call (`cap`).
//
// Bounds. Per cell ~15 float operations and compares and no device memory
// traffic but the carries (20 bytes a column in and out), the two
// sequences and a record a row: 256 rows x 24,503 columns is ~94 M
// operations, 1.4 us of the card's float32 rate. What binds is the serial
// chain of a row (T2's prefix max over the strip) and, across strips, the
// hand-off of each row's edge record.
//
// Design (rows_kernel<C>, redesigned for the H100 after csrc/rowfill.cu):
// 1. Rows in registers. Thread t of a strip owns the C contiguous columns
//    [C t, C t + C) (C = 4, 8 or 16) for the whole call and keeps their H
//    and T3, and B's codes, in registers from row to row; the carries are
//    read from `state` once and stored once.
// 2. One pass and one barrier a row. A thread's running max covers the
//    omegas of its columns shifted by one, c0+1 .. c0+C, each computed
//    from max(T1, T3) of the column to its left, which it owns; omega at
//    c0 belongs to the thread on its left. So no thread needs its left
//    neighbour's current row before the scan. What it needs of the
//    previous row is the diagonal H(i-1, c0-1): a warp shuffle of the
//    left lane's last H. Lane 0 of warp w > 0 cannot have it before the
//    barrier, so lane 31 of warp w-1, which owns H(i-1, c0-1), computes
//    lane 0's first T1 and its share of omega at c0+1, Y = (g*j - gh) +
//    T1 (max distributes over a rounded sum: (x + max(p, q)) = max(x + p,
//    x + q) bit for bit), and puts both into shared memory beside its warp
//    total; lane 0 carries max(T1, T3) without T1 into the scan and folds
//    T1 and Y in after the barrier. The one barrier is the scan's: a warp
//    shuffle scan, the warp totals and Y's through shared memory (double
//    buffered by row parity, so no second barrier guards them).
// 3. Strips, a record a row. A strip is threads x C columns, up to
//    2,048 at C = 4 and 4,096 at C = 8, 16; the block is cut into S
//    strips (24 to 55 at the pipeline's widths), one CTA each, taken in start
//    order from an atomic ticket (strip s waits only on strip s-1, which
//    started before it, so none waits on a CTA that is not resident). The
//    thread of a strip's last column hands strip s+1, every row, the
//    prefix max at its first column, max(pm(last), omega(last+1)), and
//    H(i, last) (its next diagonal), as one 16-byte store of two 8-byte
//    (value, flag) words, the flag being the row's number; thread 0 of
//    strip s+1 loads that line at the start of its row, and after its
//    pass reads it again until both flags show the row (8-byte accesses
//    are single-copy atomic, so no fence is needed), then folds the
//    prefix into its running max. Strip 0 loads halo_in a row ahead. A
//    load's latency (~0.4 us) on the row's critical path cost as much as
//    half a row step. A call's critical path is rows + S - 1 row steps
//    plus S - 1 hand-offs.
// 4. Geometry (C, threads, S) comes from ops/halostair.py
//    halostair_geometry, a pure function of (nc, R) built on this card's
//    measured row times. __launch_bounds__ caps the registers at 128 (C
//    = 4 and 8, 512 threads) and 255 (C = 16, 256 threads): C = 4 spilled
//    at 1,024 threads (64 registers), C = 16 at 512 (128); a strip of
//    1,024 threads at C = 4 was the slowest row step measured anyway.
//
// staircase_kernel, the first design, stays for comparison only (wrapper
// ops/halostair.py halostair_staircase_step; no path launches it): strips
// of 256 threads, H and T3 in shared memory, two barriers a row, records
// published through a release count every 4 rows.

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

constexpr int kRowsMaxWarps = 32;

// the threads a strip of C columns a thread takes (the register cap is
// 65,536 / threads, at most 255)
__host__ __device__ constexpr int rows_threads(int C) {
    return C == 16 ? 256 : 512;
}

// One line of the strip-to-strip link: two 8-byte (value, flag) words.
__device__ __forceinline__ void st_link(uint4* p, float x, float z,
                                        unsigned flag) {
    asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(__float_as_uint(x)), "r"(flag),
                    "r"(__float_as_uint(z)), "r"(flag)
                 : "memory");
}

__device__ __forceinline__ uint4 ld_line(const uint4* p) {
    uint4 v;
    asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p)
                 : "memory");
    return v;
}

// The line's two values once both flags show `flag`; `v` is the line as
// loaded before (a prefetch), read again until it does.
__device__ __forceinline__ void ld_link(const uint4* p, unsigned flag,
                                        uint4 v, float& x, float& z) {
    while (v.y != flag || v.w != flag) v = ld_line(p);
    x = __uint_as_float(v.x);
    z = __uint_as_float(v.z);
}

template <int C>
__global__ void __launch_bounds__(rows_threads(C), 1)
rows_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            const float4* __restrict__ halo_in, float4* __restrict__ halo_out,
            float* __restrict__ state, float* __restrict__ fin, uint4* link,
            int* ticket, int nc, int R, int rows, int cap, int cs, int base,
            int sta, float g, float h, float match, float mismatch) {
    static_assert(C == 4 || C == 8 || C == 16, "C is 4, 8 or 16");
    // per row parity: each warp's omega total, and for warp w > 0 the T1
    // of its lane 0's first column and that column's share Y of the next
    // omega, written by lane 31 of warp w - 1 (Y of warp 0 stays -inf)
    __shared__ float wt[2][kRowsMaxWarps];
    __shared__ float yx[2][kRowsMaxWarps];
    __shared__ float tx[2][kRowsMaxWarps];
    __shared__ int s_strip;
    constexpr unsigned kFull = 0xffffffffu;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds g*j - g - h
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, NW = T >> 5;
    if (tid == 0) s_strip = atomicAdd(ticket, 1);
    if (tid < 2) yx[tid][0] = NEG;
    __syncthreads();
    const int s = s_strip, S = (int)gridDim.x;
    const bool last = s + 1 == S;
    const int c0 = (s * T + tid) * C;  // block column of column 0 here
    const float fc0 = (float)(cs + c0);  // its global column, exact
    const bool edge = lane == 0 && warp > 0;  // T1 at c0 after the barrier
    // the block column whose record goes out: the strip's last, or nc - 1
    const int lastcol = last ? nc - 1 : (s + 1) * T * C - 1;
    const bool owner = c0 <= lastcol && lastcol < c0 + C;
    const uint4* lin = link + (size_t)(s > 0 ? s - 1 : 0) * (R + 1);
    uint4* lout = link + (size_t)s * (R + 1);  // written when !last

    float H[C], T3[C], P[C];
    uint32_t bc[C / 4];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) bc[q] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = c0 + c;
        H[c] = j < nc ? state[j] : NEG;
        T3[c] = j < nc ? state[nc + j] : NEG;
        bc[c >> 2] |= (uint32_t)(j < nc ? b[j] : 255) << ((c & 3) * 8);
    }
    const int bn = c0 + C < nc ? b[c0 + C] : 255;  // lane 31: next column

    // row base: H at the record's column goes out (record 0)
#pragma unroll
    for (int c = 0; c < C; ++c) {
        if (owner && c0 + c == lastcol) {
            if (last)
                halo_out[0] = make_float4(NEG, NEG, H[c], NEG);
            else
                st_link(lout, NEG, H[c], 1u);
        }
    }
    // thread 0: H(base, c0 - 1), the diagonal of its first column
    float hrec = NEG, dummy;
    // thread 0's record of the next row from the left, loaded a row ahead
    // (halo_in) or at the row's start (the link; read again if early)
    float4 hin = make_float4(NEG, NEG, NEG, NEG);
    uint4 lnk = make_uint4(0u, 0u, 0u, 0u);
    if (tid == 0) {
        if (s == 0) {
            hrec = __ldg(&halo_in[0].z);
            hin = __ldg(&halo_in[1]);
        } else {
            ld_link(lin, 1u, ld_line(lin), dummy, hrec);
        }
    }
    float hd = __shfl_up_sync(kFull, H[C - 1], 1);  // H(base, c0 - 1)
    if (lane == 0) hd = tid == 0 ? hrec : NEG;

    int acn = rows > 0 ? (int)a[0] : 0;
    for (int r = 1; r <= rows; ++r) {
        const int par = r & 1;
        const int ac = acn;
        if (r < rows) acn = a[r];  // prefetch
        const float fi = (float)(base + r);
        // column 0 of T3 (quirk: +3 acts as -1 on column 0)
        const float col0_3 = (sta == -3) ? -g * fi
                           : ((sta == 1 || sta == 2) ? NEG : -h - g * fi);
        const bool capr = r == cap;
        const float hlast = H[C - 1];  // H(r-1) at the thread's last column
        if (tid == 0 && s > 0) lnk = ld_line(lin + r);  // in flight

        // the pass: T1, T3, max(T1, T3) (kept in H until the scan) and
        // the running max of omega at c0+1 .. c0+C; P[c] the part of it
        // at c0+1 .. c0+c, the thread's prefix at column c0+c
        float run = NEG, onext = NEG;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int code = (int)((bc[c >> 2] >> ((c & 3) * 8)) & 255u);
            const float t1 = (code == ac ? match : mismatch) + hd;
            float t3 = fmaxf((H[c] - g) - h, T3[c] - g);
            if (c == 0 && cs + c0 == 0) t3 = col0_3;
            hd = H[c];
            const float m13 = fmaxf(t1, t3);
            if (capr && c0 + c < nc) {
                if (c > 0 || !edge) fin[c0 + c] = t1;
                fin[2 * nc + c0 + c] = t3;
            }
            T3[c] = t3;
            H[c] = m13;
            P[c] = run;
            onext = (g * (fc0 + (float)(c + 1)) - gh) + m13;
            run = fmaxf(run, onext);
        }
        // lane 31: the first T1 of the next warp's lane 0, and its Y
        if (lane == 31 && warp + 1 < NW) {
            const float t1n = (bn == ac ? match : mismatch) + hlast;
            tx[par][warp + 1] = t1n;
            yx[par][warp + 1] = (g * (fc0 + (float)(C + 1)) - gh) + t1n;
        }
        // thread 0: the prefix max at the strip's first column, from the
        // left (halo_in, or strip s-1's link line of row r)
        float E = NEG;
        if (tid == 0) {
            if (s == 0) {
                E = fmaxf(hin.y, (g * fc0 - gh) + hin.x);
                hrec = hin.z;
                if (r < rows) hin = __ldg(&halo_in[r + 1]);
            } else {
                ld_link(lin + r, (unsigned)(r + 1), lnk, E, hrec);
            }
            run = fmaxf(run, E);
        }

        // the scan: the exclusive prefix max of the threads' maxima
        const float incl = warp_incl_max(run);
        if (lane == 31) wt[par][warp] = incl;
        __syncthreads();
        float wpre = lane < warp ? fmaxf(wt[par][lane], yx[par][lane]) : NEG;
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
            wpre = fmaxf(wpre, __shfl_xor_sync(kFull, wpre, k));
        float inwarp = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) inwarp = NEG;
        const float yw = yx[par][warp];
        float excl = fmaxf(wpre, inwarp);
        if (lane > 0) excl = fmaxf(excl, yw);
        if (tid == 0) excl = E;
        if (edge) {  // T1 of the first column and Y, from lane 31
            const float t1 = tx[par][warp];
            H[0] = fmaxf(t1, H[0]);
#pragma unroll
            for (int c = 1; c < C; ++c) P[c] = fmaxf(P[c], yw);
            if (capr && c0 < nc) fin[c0] = t1;
        }

        // T2 and H, the capture of row la, the record
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float pm = fmaxf(excl, P[c]);
            const float t2 = pm - g * (fc0 + (float)c);
            const float m13 = H[c];
            const float hn = fmaxf(m13, t2);
            H[c] = hn;
            if (capr && c0 + c < nc) fin[nc + c0 + c] = t2;
            if (owner && c0 + c == lastcol) {
                if (last)
                    __stcg(&halo_out[r], make_float4(m13, pm, hn, NEG));
                else
                    st_link(lout + r, fmaxf(pm, onext), hn,
                            (unsigned)(r + 1));
            }
        }
        const float hup = __shfl_up_sync(kFull, H[C - 1], 1);
        hd = lane > 0 ? hup : (tid == 0 ? hrec : NEG);
    }

    // row base + rows: the carries
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = c0 + c;
        if (j < nc) {
            state[j] = H[c];
            state[nc + j] = T3[c];
        }
    }
}

// The first design: strips of 256 threads, rows in shared memory.
__global__ void __launch_bounds__(kMaxThreads)
staircase_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
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

template <int C>
int rows_launch(const uint8_t* a, const uint8_t* b, const void* halo_in,
                void* halo_out, float* state, float* fin, void* link,
                int* ticket, int nc, int R, int rows, int cap, int cs,
                int base, int sta, int threads, int nstrips, float g,
                float h, float match, float mismatch, cudaStream_t stream) {
    rows_kernel<C><<<nstrips, threads, 0, stream>>>(
        a, b, static_cast<const float4*>(halo_in),
        static_cast<float4*>(halo_out), state, fin,
        static_cast<uint4*>(link), ticket, nc, R, rows, cap, cs, base, sta,
        g, h, match, mismatch);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8. a: (R,) u8; b: (nc,) u8; halo_in, halo_out: (R + 1) float4
// (halo_out -inf past row `rows`, as the caller sets it); state: (2, nc)
// f32 and fin: (3, nc) f32, both updated in place; link: max(nstrips - 1,
// 1) * (R + 1) 16-byte lines of zeros; ticket: one i32 zero. rows in
// 1..R; cap in 1..rows or 0; C columns a thread (4, 8 or 16), threads a
// multiple of 32 up to 512 at C = 4, 8 and 256 at C = 16; nstrips strips
// of threads * C columns, the last one holding column nc - 1. Returns a
// cudaError_t code.
int halostair_step(const uint8_t* a, const uint8_t* b, const void* halo_in,
                   void* halo_out, float* state, float* fin, void* link,
                   int* ticket, int nc, int R, int rows, int cap, int cs,
                   int base, int sta, int C, int threads, int nstrips,
                   float g, float h, float match, float mismatch,
                   void* stream) {
    const long long W = (long long)threads * C;
    if ((C != 4 && C != 8 && C != 16) || threads < 32 ||
        threads > rows_threads(C) || threads % 32 != 0 || nstrips < 1 ||
        nc < 1 || nstrips * W < nc || (nstrips - 1) * W >= nc || rows < 1 ||
        rows > R || cap < 0 || cap > rows)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define ROWS_LAUNCH(CC)                                                     \
    return rows_launch<CC>(a, b, halo_in, halo_out, state, fin, link,      \
                           ticket, nc, R, rows, cap, cs, base, sta, threads, \
                           nstrips, g, h, match, mismatch, st)
    if (C == 4) ROWS_LAUNCH(4);
    if (C == 8) ROWS_LAUNCH(8);
    ROWS_LAUNCH(16);
#undef ROWS_LAUNCH
}

// The shared-memory staircase, for comparison only. a: (R,) u8; b: (nc,) u8;
// halo_in, halo_out: (R + 1) float4; state: (2, nc) f32 and fin: (3,
// nc) f32, both updated in place; rec: (nstrips - 1) * (R + 1) float4 of
// scratch; cnt: nstrips + 1 i32 zeros (the strips'
// counts, then the ticket). rows in 1..R; cap in 1..rows or 0; threads a
// multiple of 32, C columns per thread, nstrips * threads * C >= nc; smem
// bytes = 128 + (threads*C rounded up to 16) + 4 * (5 * threads*C + 4).
// Returns a cudaError_t code.
int halostair_staircase_step(const uint8_t* a, const uint8_t* b,
                             const void* halo_in, void* halo_out,
                             float* state, float* fin, void* rec, int* cnt,
                             int nc, int R, int rows, int cap, int cs,
                             int base, int sta, int C, int threads,
                             int nstrips, long long smem, float g, float h,
                             float match, float mismatch, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        staircase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    staircase_kernel<<<nstrips, threads, (size_t)smem,
                       (cudaStream_t)stream>>>(
        a, b, static_cast<const float4*>(halo_in),
        static_cast<float4*>(halo_out), state, fin,
        static_cast<float4*>(rec), cnt, cnt + nstrips, nc, R, rows, cap, cs,
        base, sta, C, nstrips, g, h, match, mismatch);
    return (int)cudaGetLastError();
}

}  // extern "C"
