// Skewed wavefront long fill for the H100 (sm_90a), plain C interface.
//
// K6 (wrapper ops/longrow.py long_fill) replaces the TPU kernel
// _longrow_kernel (cse305_parallel_sequence_alignment_tpu/ops/
// pallas_longrow.py:79, launched by _pallas_longrow :219): the Gotoh score
// sweep of a batch of jobs of any width, each with its own start type,
// capturing either the finals (T1, T2, T3) at (la, lb) or the whole row la,
// (3, n+1). K7 (wrapper ops/longstair.py stair_lastrow_device) replaces
// _stair_kernel (ops/pallas_longstair.py:81, launched by _pallas_stair
// :278), one job's last row at full utilisation: the same kernel launched
// for a batch of one. The crossing search launches it once a bisection
// level, the level's jobs as its batch.
//
// Design (strip_kernel<C>, redesigned for the H100 after csrc/rowfill.cu
// and csrc/halostair.cu rows_kernel):
// 1. Rows in registers. Each lane owns C contiguous columns (C = 4, 8,
//    16, 24 or 32) of one job for the whole sweep, and keeps their
//    max(T1, T2) and T3 of the previous row, g*j and B's codes (four to a
//    register) in registers. Nothing of a row goes through shared memory;
//    A's codes do, staged a block of rows ahead.
// 2. A skewed wavefront. A lane is a strip of C columns, and lane L of a
//    warp works on row t - L + 1 at its step t: it needs of its left
//    neighbour only the record of the same row at the column left of its
//    own,
//        x = max3(T1, T2, T3), and E = prefix max of omega up to and
//        including its own first column,
//    which that lane computed at step t - 1 and hands on by one
//    __shfl_up_sync of two floats. So a warp holds 32 rows in flight, no
//    lane waits on a barrier or a scan inside a row, and the only chain
//    from one step to the next is the record: E's two maxes and x's three.
//    Everything else of a row (T1, T3, omega and the running max over the
//    lane's own columns) depends on the previous row alone and runs while
//    the shuffle is in flight. The step has no branch but a lane's own
//    start and end: column 0 of the job and lane 0's record are selects,
//    since a divergent lane makes its warp run both paths, and the warp
//    of a job's column 0 paces the whole wavefront.
// 3. Warps and CTAs. Lane 31's records go to the next warp of the CTA
//    through a ring in shared memory, and the CTA's last warp hands them to
//    the next CTA (the next strip of W = warps x 32 x C columns) through
//    global memory, as K8 does: one 16-byte line a row of two 8-byte
//    (value, flag) words, the flag the row's number, single-copy atomic, so
//    no fence and no counter. Warp 0 of strip s loads the lines of a block
//    of kStep rows one block ahead and reads them again until the flags
//    show the rows. The CTA steps in supersteps of kStep steps with one
//    barrier each; warp w runs kLag supersteps behind warp w - 1, so that
//    a record is written a superstep before it is read.
// 4. Batches. One launch holds B jobs padded to the widest (m, n), a grid
//    of B x S CTAs taken from an atomic ticket in start order, strip-major,
//    so every job's strip s starts before any strip s + 1 and no CTA waits
//    on one that is not resident. Each job stops at its own la, and strips
//    and warps wholly past its own lb do no work; with want_row their
//    columns read -inf, as every column past lb does.
// 5. Geometry (C, warps, S) comes from ops/longrow.py strip_plan, a pure
//    function of (B, m, n, want_row, SMs) fitted to this card's measured
//    times. A wavefront runs at the pace of its slowest strip, so the
//    plan keeps the busiest scheduler to one warp where it can: a step
//    took ~0.30 us at C = 16 with one warp a scheduler and ~0.50 us where
//    some SMs held a second. Hence the wide instances: three 97 kb jobs
//    at C = 24 fill the card's 528 schedulers once.
//
// Bounds. Per cell ~17 float operations and no device-memory traffic but
// the two sequences, 16 bytes of record a row and strip, and the output
// (12 bytes a cell of the last row, or 12 bytes a job). What binds is a
// step's latency while a level's lanes leave the schedulers one warp or
// fewer (~0.17 us at C = 4 to ~0.44 us at C = 32 for a lone warp: a long
// dependent chain for its instruction count), the SMs' issue rate past
// that, and the wavefront's start-up, ~1.8 steps a lane of the row.
//
// Numerics. float32 with true -inf, built with -fmad=false, the operation
// order that XLA runs for the JAX kernels, gh = g + h rounded to float32
// (XLA folds the JAX source's x - g - h into one subtraction):
//   T1 = fb + max3(prev row, j-1)
//   T3 = max(max(T1,T2)(prev, j) - gh, T3(prev, j) - g)
//   omega = (g*j + max(T1,T3)(j-1)) - gh,  T2 = prefixmax(omega) - g*j
// The prefix max is carried from lane to lane instead of scanned; max is
// exact, so every cell is bit-equal to the plain version (ops/rowcb.py
// _sweep_plain) and to the TPU kernels.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStep = 16;              // steps a superstep
constexpr int kLag = 2 + 30 / kStep;   // supersteps warp w trails warp w - 1
constexpr int kRing = 4 * kStep;       // records a warp's ring holds
constexpr int kMaxWarps = 8;           // warps a CTA (strip_plan's cap)
constexpr int kCodes = 1024;           // A's codes the CTA's ring holds

// CTAs an SM each instance is built for (the register cap is 65,536 /
// (256 x this), at most 255)
__host__ __device__ constexpr int min_blocks(int C) {
    return C == 4 ? 3 : (C == 8 ? 2 : 1);
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

// The captured row's columns [c0, c0 + C): -inf past lb, nothing past n.
template <int C>
__device__ __forceinline__ void put_row(float* orow, int ncol, int c0,
                                        int lB, const float* t1,
                                        const float* t2, const float* t3) {
    const float NEG = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = c0 + c;
        if (j < ncol) {
            const bool in = j <= lB;
            orow[j] = in ? t1[c] : NEG;
            orow[ncol + j] = in ? t2[c] : NEG;
            orow[2 * ncol + j] = in ? t3[c] : NEG;
        }
    }
}

template <int C>
__global__ void __launch_bounds__(32 * kMaxWarps, min_blocks(C))
strip_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
             const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
             const int32_t* __restrict__ st, float* __restrict__ out,
             uint4* link, int* ticket, int B, int m, int n, int nstrips,
             int want_row, float g, float h, float match, float mismatch) {
    static_assert(C % 4 == 0 && C >= 4 && C <= 32, "C is 4 to 32, by 4");
    // ring[w] holds the records warp w reads: ring[0] the strip's inbound,
    // ring[w + 1] what warp w's lane 31 writes
    __shared__ float2 ring[kMaxWarps + 1][kRing];
    // A's code of row r at [r % kCodes], two supersteps ahead of warp 0
    __shared__ uint8_t acodes[kCodes];
    __shared__ int s_cta;
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, NW = blockDim.x >> 5;
    if (tid == 0) s_cta = atomicAdd(ticket, 1);
    __syncthreads();
    const int s = s_cta / B, job = s_cta % B;  // strip-major tickets
    const int W = NW * 32 * C;
    const int ncol = n + 1;
    const int g0 = s * W;  // global column of the strip's first
    const int sta = st[job], lA = la[job], lB = lb[job];
    const int c0 = g0 + (warp * 32 + lane) * C;  // this lane's first column
    float* fin = out + (size_t)job * 3;          // finals mode: (B, 3)
    float* orow = out + (size_t)job * 3 * ncol;  // row mode: (B, 3, ncol)
    const bool live = g0 + warp * 32 * C <= lB;  // the warp has work
    if (!live && want_row) {
        float neg[C];
#pragma unroll
        for (int c = 0; c < C; ++c) neg[c] = NEG;
        put_row<C>(orow, ncol, c0, lB, neg, neg, neg);
    }
    if (g0 > lB) return;  // the whole strip lies past the job's width
    const int nlive = min(NW, (lB - g0) / (32 * C) + 1);

    // the lane's columns: B's codes (column 0 and past n: 255), g*j, and
    // row 0 as max(T1, T2) and T3
    const uint8_t* arow = a + (size_t)job * m;
    const uint8_t* brow = b + (size_t)job * n;
    uint32_t bc[C / 4];
    float M12[C], T3[C], gj[C + 1];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) bc[q] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = c0 + c;
        const uint32_t code = (j > 0 && j <= n) ? brow[j - 1] : 255u;
        bc[c >> 2] |= code << ((c & 3) * 8);
        gj[c] = g * (float)j;
        float r1, r2, r3;
        row0(j, sta, g, h, r1, r2, r3);
        M12[c] = fmaxf(r1, r2);
        T3[c] = r3;
        if (lA == 0 && live) {
            if (want_row) {
                if (j < ncol) {
                    orow[j] = j <= lB ? r1 : NEG;
                    orow[ncol + j] = j <= lB ? r2 : NEG;
                    orow[2 * ncol + j] = j <= lB ? r3 : NEG;
                }
            } else if (j == lB) {
                fin[0] = r1;
                fin[1] = r2;
                fin[2] = r3;
            }
        }
    }
    gj[C] = g * (float)(c0 + C);
    const bool first = c0 == 0;  // the lane of the job's column 0
    const bool sta3 = sta == -3, sta12 = sta == 1 || sta == 2;
    const float nh = -h;
    // max3 of the previous row at column c0 - 1, T1's diagonal
    float dprev = NEG;
    if (c0 > 0) {
        float r1, r2, r3;
        row0(c0 - 1, sta, g, h, r1, r2, r3);
        dprev = fmaxf(fmaxf(r1, r2), r3);
    }

    // strip 0 has nothing on its left: prefix max -inf at column 0
    if (s == 0)
        for (int k = tid; k < kRing; k += blockDim.x)
            ring[0][k] = make_float2(NEG, NEG);
    const uint4* lin = link + ((size_t)(s > 0 ? s - 1 : 0) * B + job) * (m + 1);
    uint4* lout = link + ((size_t)s * B + job) * (m + 1);
    // the next strip reads this one's records only if it has work
    const bool feed = s + 1 < nstrips && (s + 1) * W <= lB;
    // warp 0 of strip s > 0: the link lines of the next block of rows
    uint4 pre = make_uint4(0u, 0u, 0u, 0u);
    if (warp == 0 && s > 0 && lane < kStep && lane + 1 <= lA)
        pre = ld_line(lin + lane + 1);
    // rows 1 .. 2 kStep of A now, and the next kStep in a register
    for (int r = tid + 1; r <= 2 * kStep; r += blockDim.x)
        acodes[r & (kCodes - 1)] = r <= lA ? arow[r - 1] : 0;
    uint32_t apre = 0;
    if (tid < kStep && 2 * kStep + tid < lA) apre = arow[2 * kStep + tid];
    int acn = lA > 0 ? (int)arow[0] : 0;  // A's code of the lane's next row
    float ox = NEG, oE = NEG;  // the lane's record of its latest row
    __syncthreads();

    const int steps = lA + 31;  // a warp's steps: row 1 at lane 0 to la at 31
    const int nsup = lA > 0 ? (steps + kStep - 1) / kStep + (nlive - 1) * kLag
                            : 0;
    for (int k = 0; k < nsup; ++k) {
        // A's rows (k + 2) kStep + 1 .. + kStep, read from superstep k + 1 on
        if (tid < kStep) {
            const int r = (k + 2) * kStep + tid + 1;
            acodes[r & (kCodes - 1)] = (uint8_t)apre;
            if (r + kStep <= lA) apre = arow[r + kStep - 1];
        }
        if (warp == 0 && s > 0) {
            // the inbound rows k * kStep + 1 .. + kStep, then the next block
            const int r = k * kStep + lane + 1;
            bool ok = lane >= kStep || r > lA ||
                      (pre.y == (unsigned)r && pre.w == (unsigned)r);
            while (!__all_sync(kFull, ok)) {
                if (!ok) {
                    pre = ld_line(lin + r);
                    ok = pre.y == (unsigned)r && pre.w == (unsigned)r;
                }
            }
            if (lane < kStep && r <= lA)
                ring[0][r & (kRing - 1)] =
                    make_float2(__uint_as_float(pre.x), __uint_as_float(pre.z));
            if (lane < kStep && r + kStep <= lA) pre = ld_line(lin + r + kStep);
            __syncwarp();
        }
        const int t0 = (k - warp * kLag) * kStep;
        if (live && t0 >= 0 && t0 < steps) {
            const float2* rin = ring[warp];
            float2* rout = ring[warp + 1];
#pragma unroll 2
            for (int u = 0; u < kStep; ++u) {
                const int t = t0 + u;
                const int i = t - lane + 1;  // this lane's row
                // the left neighbour's record of row i: lane 0's from the
                // ring (every lane reads the one slot, a broadcast), the
                // others' by shuffle, with no branch
                const float2 v = rin[(t + 1) & (kRing - 1)];
                float rx = __shfl_up_sync(kFull, ox, 1);
                float rE = __shfl_up_sync(kFull, oE, 1);
                rx = lane == 0 ? v.x : rx;
                rE = lane == 0 ? v.y : rE;
                if (i < 1 || i > lA) continue;
                const int ac = acn;
                acn = acodes[(i + 1) & (kCodes - 1)];  // the next row's code
                float lm3 = dprev;  // max3(i-1, c0-1)
                dprev = rx;         // max3(i, c0-1), for row i+1
                // column 0's T3 (quirk: +3 acts as -1 on column 0), taken
                // by the job's first lane through selects: a branch there
                // would run pass 1 twice in the warp that paces the job
                const float gf = g * (float)i;
                const float col0 = sta3 ? -gf : (sta12 ? NEG : nh - gf);
                // pass 1: T1, T3 and the running max of omega over the
                // columns c0+1 .. c0+c (P[c]), from the previous row alone
                float P[C];
                float run = NEG, om = NEG;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int code = (int)((bc[c >> 2] >> ((c & 3) * 8)) & 255u);
                    const float p12 = M12[c], p3 = T3[c];
                    float t1 = (code == ac ? match : mismatch) + lm3;
                    float t3 = fmaxf(p12 - gh, p3 - g);
                    if (c == 0) {
                        t1 = first ? NEG : t1;
                        t3 = first ? col0 : t3;
                    }
                    lm3 = fmaxf(p12, p3);
                    M12[c] = t1;  // T1 until pass 2
                    T3[c] = t3;
                    P[c] = run;
                    om = (gj[c + 1] + fmaxf(t1, t3)) - gh;
                    run = fmaxf(run, om);
                }
                // pass 2: T2 from the record's prefix, the capture of row
                // la, the record of the lane's last column
                float pm = NEG;
                float t2s[C];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    pm = fmaxf(rE, P[c]);
                    t2s[c] = pm - gj[c];
                    if (c == 0) t2s[c] = first ? NEG : t2s[c];
                }
                if (i == lA) {
                    if (want_row) {
                        put_row<C>(orow, ncol, c0, lB, M12, t2s, T3);
                    } else if (c0 <= lB && lB < c0 + C) {
#pragma unroll
                        for (int c = 0; c < C; ++c) {
                            if (c0 + c == lB) {
                                fin[0] = M12[c];
                                fin[1] = t2s[c];
                                fin[2] = T3[c];
                            }
                        }
                    }
                }
#pragma unroll
                for (int c = 0; c < C; ++c) M12[c] = fmaxf(M12[c], t2s[c]);
                ox = fmaxf(M12[C - 1], T3[C - 1]);
                oE = fmaxf(pm, om);
                if (lane == 31) {
                    if (warp + 1 < NW)
                        rout[i & (kRing - 1)] = make_float2(ox, oE);
                    else if (feed)
                        st_link(lout + i, ox, oE, (unsigned)i);
                }
            }
        }
        __syncthreads();
    }
}

template <int C>
int strip_launch(const uint8_t* a, const uint8_t* b, const int32_t* la,
                 const int32_t* lb, const int32_t* st, float* out, void* link,
                 int* ticket, int B, int m, int n, int warps, int nstrips,
                 int want_row, float g, float h, float match, float mismatch,
                 cudaStream_t stream) {
    strip_kernel<C><<<B * nstrips, 32 * warps, 0, stream>>>(
        a, b, la, lb, st, out, static_cast<uint4*>(link), ticket, B, m, n,
        nstrips, want_row, g, h, match, mismatch);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (B, m) u8; b: (B, n) u8; la/lb/st: (B,) i32 with la <= m, lb <= n;
// out: finals (B, 3) f32 of -inf or, with want_row, rows (B, 3, n+1) f32;
// link: B * nstrips * (m + 1) 16-byte lines of zeros; ticket: one i32
// zero. C columns a lane (4, 8 or 16), warps 1..8 a CTA, nstrips strips of
// warps * 32 * C columns, the last one holding column n. Returns a
// cudaError_t code.
int long_fill(const uint8_t* a, const uint8_t* b, const int32_t* la,
              const int32_t* lb, const int32_t* st, float* out, void* link,
              int* ticket, int B, int m, int n, int C, int warps, int nstrips,
              int want_row, float g, float h, float match, float mismatch,
              void* stream) {
    if (B == 0) return 0;
    const long long W = 32LL * warps * C;
    if ((C != 4 && C != 8 && C != 16 && C != 24 && C != 32) || warps < 1 ||
        warps > kMaxWarps ||
        nstrips < 1 || m < 0 || n < 0 || nstrips * W < n + 1 ||
        (nstrips - 1) * W >= n + 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define STRIP_LAUNCH(CC)                                                    \
    return strip_launch<CC>(a, b, la, lb, st, out, link, ticket, B, m, n,   \
                            warps, nstrips, want_row, g, h, match, mismatch, \
                            s)
    if (C == 4) STRIP_LAUNCH(4);
    if (C == 8) STRIP_LAUNCH(8);
    if (C == 16) STRIP_LAUNCH(16);
    if (C == 24) STRIP_LAUNCH(24);
    STRIP_LAUNCH(32);
#undef STRIP_LAUNCH
}

}  // extern "C"
