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

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float warp_incl_max(float v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        float o = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v = fmaxf(v, o);
    }
    return v;
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

}  // extern "C"
