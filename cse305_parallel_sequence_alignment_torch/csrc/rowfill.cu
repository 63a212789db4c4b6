// K1 and K4d, the global dirs16+runs fill, redesigned for the H100
// (sm_90a), plain C interface (wrapper: ops/rowcb.py rowcb_fill).
//
// Replaces the TPU kernel _rowcb_kernel
// (cse305_parallel_sequence_alignment_tpu/ops/pallas_rowcb.py:126) with
// want_dirs=True, with_runs=True: K1 at k1 = 0 (match/mismatch), K4d with
// a (k1, k1) float32 substitution table (its k1 > 0 branch, :244). It
// computes what csrc/rowcb.cu's sweep_kernel<0, TABLE, DIRS16, false>
// computes, bit for bit: the uint16 "dirs16+runs" word of every cell
// (i, j), 0 <= i <= m, 0 <= j <= n, of every pair, and the finals (T1,
// T2, T3) at (la, lb), with per-pair start types. That kernel stays for
// rows wider than a cluster holds (ops/rowcb.py's width rule) and for
// K3', K1', K4s, K10d, K11d and P-trim.
//
// Bounds. A cell is ~29 float operations and compares and one 2-byte
// store: 256 pairs x 2 kb is ~1.1 G cells and ~2.15 GB of dirs, 0.64 ms
// of HBM at 3.35 TB/s. The row is a dependent chain (T2's prefix max
// over the whole row, two barriers), so the fill is bound by each row's
// latency while the pairs leave SMs idle and by the SMs' instruction
// rate once they do not, not by memory.
//
// Design, against what held sweep_kernel back:
// 1. Rows in registers. Thread t of a pair's row owns the C contiguous
//    columns [C t, C t + C) (C = 4, 8 or 16, a template parameter) for the
//    whole sweep, and keeps their T1, T2 and T3, their previous-row words
//    (two to a 32-bit register) and B's codes (four to a register) in
//    registers. sweep_kernel kept the rows in shared memory or, past
//    ~7,000 columns, in global scratch, a dozen strided accesses a cell.
//    A row is three passes:
//      pass 1: T1, T3, the codes d1 and d3 and the run part of the word,
//              and the running max of omega over the thread's columns;
//      scan:   the exclusive prefix of those maxima over the row, a warp
//              shuffle scan and the warp totals through shared memory
//              (one barrier);
//      pass 3: T2 from the prefix, d2, the finals at (la, lb); the left
//              neighbour's halo for the next row goes out (one barrier),
//              and the row's words are stored.
//    The only exchange is the halo of the left neighbour's last columns:
//    its previous-row T1, T2, T3 and word at column c0 - 1 (max3, d1 and
//    the diagonal run of column c0) and max3 at c0 - 2, from which the
//    thread recomputes the current row's T1 and T3 at c0 - 1 (omega at
//    c0 and d2) with the same float32 expressions. The halo goes by
//    shuffle inside a warp, through one shared slot at warp boundaries,
//    and through distributed shared memory at CTA boundaries. This is
//    csrc/rowprobe.cu replica_kernel's step with the dirs added.
// 2. Coalesced dirs stores. A thread's C words of a row are one vector
//    store: 8 bytes at C = 4, 16 at C = 8, two of 16 at C = 16 (the
//    words were packed in pass 1). The dirs have a row pitch P =
//    round_up(n + 1, 8) columns, so every row starts 16-byte aligned; the
//    wrapper returns the view of the first n + 1 columns. A store whose
//    first column lies at or past P is dropped, so none crosses a row.
//    Chosen over staging a warp's words through shared memory: a
//    thread's C words are already contiguous and aligned, and a warp's
//    stores cover one contiguous span of the row, so staging would only
//    add a shared-memory round trip and a barrier.
// 3. A thread-block cluster for each wide pair. Past 4,096 columns (what
//    512 threads at C = 8 hold) a pair's row is split over a cluster of k
//    <= 8 CTAs at C = 16 (grid B k, cluster (k, 1, 1)). Each row, every
//    warp writes its omega total into the shared memory of its own and
//    every later CTA of the cluster (one lane a CTA), and the last warp
//    of a CTA writes the next CTA's incoming halo; a cluster barrier
//    (arrive.release / wait.acquire) takes the place of each CTA barrier,
//    the halo's split so that the row's stores run between its arrive
//    and its wait. The wrapper checks cudaOccupancyMaxActiveClusters
//    before the launch and raises if the cluster cannot be co-scheduled.
// 4. Rows wider than 8 CTAs hold (65,536 columns) stay on sweep_kernel
//    with global scratch: an explicit width rule in ops/rowcb.py.
// 5. Geometry (C, threads, k) comes from ops/rowcb.py fill_geometry, a
//    pure function of (B, n, k1): for rows up to 4,096 columns one CTA a
//    pair and the smallest C with the fewest waves; for wider rows the
//    card's SMs shared out over the pairs (k = 132 / B within [the fewest
//    CTAs that hold the row, 8]): a row step is a chain of latencies,
//    and a wide pair's row runs faster in 8 short pieces than in 2 long
//    ones (PERF.md). __launch_bounds__ caps the registers at 64 (C = 4:
//    1,024 threads; C = 8: 512 threads, two CTAs an SM) and 128 (C =
//    16); ptxas's registers and spills of each instance are in PERF.md.
// TABLE keeps the (k1, k1) table in shared memory (2.5 KB for BLOSUM62);
// each cell gathers table[A[i]][B[j]] from the row table[A[i]]. Columns
// past n take code 0 under a table (a valid index) and 255 otherwise;
// nothing left of them depends on them, and their words are never stored
// inside [0, n] of any row.
//
// Numerics: the float32 expressions of sweep_kernel in the same order
// (built with -fmad=false, gh = g + h rounded to float32):
//   T1 = fb + max3(prev row, j-1)
//   T3 = max(max(T1,T2)(prev, j) - gh, T3(prev, j) - g)
//   T2 = prefixmax(omega) - g*j,  omega = (g*j + max(T1,T3)(j-1)) - gh
// with the tie order T1 >= T2 >= T3 for the codes and the JAX with_runs
// encoding [d1 | d2 << 2 | d3 << 4 | after-run code << 6 | run << 8],
// the run capped at 255. Max is exact, so the scan's order changes no
// bit.

#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;  // C = 4; 512 at C = 8 and 16
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kCodeBytes = 8192;  // B's codes of one CTA: threads x C
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kRunCap = 255;
constexpr int kPadB = 255;  // column 0's code, and past n without a table
constexpr unsigned kFull = 0xffffffffu;
// a cluster that cannot be co-scheduled (ops/rowcb.py raises on it)
constexpr int kNoCluster = -1;

__device__ __forceinline__ int argmax3(float c1, float c2, float c3) {
    return (c1 >= c2 && c1 >= c3) ? 0 : (c2 >= c3 ? 1 : 2);
}

__device__ __forceinline__ float warp_incl_max(float v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const float o = __shfl_up_sync(kFull, v, s);
        if (lane >= s) v = fmaxf(v, o);
    }
    return v;
}

// row 0 at column j for start type st (quirk kept: +2 acts as -1 on row 0)
__device__ __forceinline__ void row0(int st, int j, float g, float h,
                                     float& r1, float& r2, float& r3) {
    const float NEG = -CUDART_INF_F;
    r1 = r2 = r3 = NEG;
    if (j == 0) {
        r1 = (st == 1 || st == -1) ? 0.0f : NEG;
        r2 = (st == -2) ? 0.0f : NEG;
        r3 = (st == -3) ? 0.0f : NEG;
    } else {
        const float jg = g * (float)j;
        r2 = (st == -2) ? -jg : ((st == 1 || st == 3) ? NEG : -h - jg);
    }
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the threads a CTA of C columns a thread takes, and the CTAs an SM its
// __launch_bounds__ promise: the registers are capped at 65,536 /
// (threads x CTAs), 64 at C = 4 and 8, 128 at C = 16
__host__ __device__ constexpr int max_threads(int C) {
    return C == 4 ? 1024 : 512;
}
__host__ __device__ constexpr int min_ctas(int C) { return C == 8 ? 2 : 1; }

// The thread's C codes of B, four to a register, from shared memory. The
// load is volatile so that it stays inside the row loop: the codes take
// no register across rows.
template <int C>
__device__ __forceinline__ void load_codes(const uint8_t* src,
                                           uint32_t (&bc)[C / 4]) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(src);
    if constexpr (C == 16)
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(bc[0]), "=r"(bc[1]), "=r"(bc[2]), "=r"(bc[3])
                     : "r"(addr));
    else if constexpr (C == 8)
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                     : "=r"(bc[0]), "=r"(bc[1])
                     : "r"(addr));
    else
        asm volatile("ld.shared.u32 %0, [%1];" : "=r"(bc[0]) : "r"(addr));
}

// The word of column c0 + c, two to a register (the even column low).
template <int C>
__device__ __forceinline__ int word_at(const uint32_t (&w2)[C / 2], int c) {
    return (int)((w2[c >> 1] >> ((c & 1) * 16)) & 0xFFFFu);
}

// The thread's C words of one row, one vector store (two at C = 16); a
// store whose first column lies at or past the pitch is dropped.
template <int C>
__device__ __forceinline__ void store_words(uint16_t* drow, int c0,
                                            int pitch,
                                            const uint32_t (&w2)[C / 2]) {
    uint16_t* d = drow + c0;
    if (C == 4) {
        if (c0 < pitch)
            *reinterpret_cast<uint2*>(d) = make_uint2(w2[0], w2[1]);
    } else {
#pragma unroll
        for (int q = 0; q < C / 8; ++q)
            if (c0 + 8 * q < pitch)
                reinterpret_cast<uint4*>(d)[q] = make_uint4(
                    w2[4 * q], w2[4 * q + 1], w2[4 * q + 2], w2[4 * q + 3]);
    }
}

template <int C, bool TABLE, bool CLUSTER>
__global__ void __launch_bounds__(max_threads(C), min_ctas(C))
fill_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            const int32_t* __restrict__ la, const int32_t* __restrict__ lb,
            const int32_t* __restrict__ st, uint16_t* __restrict__ dirs,
            float* __restrict__ out, int B, int m, int n, int pitch, int k,
            float g, float h, float match, float mismatch,
            const float* __restrict__ table, int k1) {
    static_assert(C == 4 || C == 8 || C == 16, "C is 4, 8 or 16");
    static_assert(!CLUSTER || C == 16, "a cluster runs at C = 16");
    extern __shared__ float tab[];  // TABLE: the (k1, k1) table
    // each warp's omega total, by its index in the pair's row (up to 8
    // CTAs of 16 warps at C = 16, one CTA of 32 at C = 4)
    __shared__ float wt[2][kMaxCluster * 16];
    // B's codes of the CTA's columns, thread t's C at [C t, C t + C)
    __shared__ __align__(16) uint8_t bcs[kCodeBytes];
    // the halo coming into each warp's lane 0: previous-row T1, T2, T3 at
    // c0 - 1 and max3 at c0 - 2, and the word at c0 - 1
    __shared__ float4 xh[2][kMaxWarps];
    __shared__ int xw[2][kMaxWarps];
    const float NEG = -CUDART_INF_F;
    const float gh = g + h;  // float32, as XLA folds x - g - h
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, NW = T >> 5;
    const int rank = CLUSTER ? (int)(blockIdx.x % k) : 0;
    const int pair = CLUSTER ? (int)(blockIdx.x / k) : (int)blockIdx.x;
    const int gw = rank * NW + warp;  // the warp's index in the row
    const int c0 = (rank * T + tid) * C;
    const int sta = st[pair], lA = la[pair];
    const int lB = lb[pair] <= n ? lb[pair] : -1;  // no column past n
    const uint8_t* brow = b + (size_t)pair * n;
    // the finals' and the dirs rows' addresses are formed where they are
    // used, from the kernel's arguments: no register holds them across
    // the row loop
    auto finals = [&](float t1, float t2, float t3) {
        float* fin = out + (size_t)pair * 3;
        fin[0] = t1;
        fin[1] = t2;
        fin[2] = t3;
    };
    auto dirs_row = [&](int i) {  // dirs (m+1, B, pitch)
        return dirs + ((size_t)i * B + pair) * pitch;
    };

    if (TABLE)
        for (int q = tid; q < k1 * k1; q += T) tab[q] = table[q];
    auto code_at = [&](int j) {
        if (j >= 1 && j <= n) return (int)brow[j - 1];
        return (TABLE && j > n) ? 0 : kPadB;
    };
    for (int q = tid; q < T * C; q += T)
        bcs[q] = (uint8_t)code_at(rank * T * C + q);
    const int bh = code_at(c0 - 1);  // only read when c0 > 0
    const float fc0 = (float)c0;  // j = c0 + c exactly: no conversion a cell

    // row 0: the reference boundary; its words are 0
    float p1[C], p2[C], p3[C];
    uint32_t w2[C / 2];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = c0 + c;
        row0(sta, j, g, h, p1[c], p2[c], p3[c]);
        if (lA == 0 && j == lB) finals(p1[c], p2[c], p3[c]);
    }
#pragma unroll
    for (int q = 0; q < C / 2; ++q) w2[q] = 0;
    store_words<C>(dirs_row(0), c0, pitch, w2);
    // the halo of row 0 depends on the column alone: computed here
    float hp1 = NEG, hp2 = NEG, hp3 = NEG, hm2 = NEG;
    int hw = 0;
    if (c0 > 0) {
        row0(sta, c0 - 1, g, h, hp1, hp2, hp3);
        float r1, r2, r3;
        row0(sta, c0 - 2, g, h, r1, r2, r3);
        hm2 = fmaxf(fmaxf(r1, r2), r3);
    }
    // A's code of the next row
    int acn = m > 0 ? (int)a[(size_t)pair * m] : 0;
    cg::cluster_group cluster = cg::this_cluster();
    if (CLUSTER)
        cluster.sync();  // every CTA of the cluster runs before DSMEM use
    else
        __syncthreads();  // the table

    for (int i = 1; i <= m; ++i) {
        const int par = i & 1;
        const int ac = acn;
        if (i < m) acn = a[(size_t)pair * m + i];  // prefetch
        const float fi = (float)i;
        // column 0 (quirk: start +3 acts as -1 on column 0)
        const float col0_3 = (sta == -3) ? -g * fi
                           : ((sta == 1 || sta == 2) ? NEG : -h - g * fi);
        const float* frow = tab + (TABLE ? ac * k1 : 0);  // f(A[i], .)
        auto fb_of = [&](int code) {
            return TABLE ? frow[code] : (code == ac ? match : mismatch);
        };

        // pass 1: T1, T3, d1, d3, the run part of the words, and the
        // running max of omega (kept in p2 until pass 3)
        float lm3 = fmaxf(fmaxf(hp1, hp2), hp3);  // max3 of prev at j-1
        int am3 = argmax3(hp1, hp2, hp3);         // d1 of column c0
        int pwl = hw;                             // prev word at j-1
        float t1l = NEG, t3l = NEG;  // this row's T1, T3 at c0 - 1
        if (c0 > 0) {
            t1l = fb_of(bh) + hm2;
            t3l = fmaxf(fmaxf(hp1, hp2) - gh, hp3 - g);
        }
        float m13l = fmaxf(t1l, t3l);
        float run = NEG;
        uint32_t bc[C / 4];
        load_codes<C>(bcs + tid * C, bc);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float q1 = p1[c], q2 = p2[c], q3 = p3[c];
            const float mp12 = fmaxf(q1, q2);
            const float mp3 = fmaxf(mp12, q3);
            const int d1 = am3;
            const int d3 = argmax3(q1, q2, q3 + h);
            // bits 6-15 of the word, run << 2 | after-run code: a run
            // grows by one up to the cap 255 (its code cleared there);
            // any other d1 starts none and records itself
            const int x = pwl >> 6;
            const int xn = d1 != 0 ? d1
                         : (x >= (kRunCap << 2) ? kRunCap << 2 : x + 4);
            pwl = word_at<C>(w2, c);
            const uint32_t wv = (uint32_t)(d1 | (d3 << 4) | (xn << 6));
            const int sh = (c & 1) * 16;
            w2[c >> 1] = (w2[c >> 1] & ~(0xFFFFu << sh)) | (wv << sh);
            am3 = argmax3(q1, q2, q3);
            float t1, t3, omega;
            if (c == 0 && c0 == 0) {
                t1 = NEG;
                t3 = col0_3;
                omega = NEG;
            } else {
                const int code = (int)((bc[c >> 2] >> ((c & 3) * 8)) & 255u);
                const float jg = g * (fc0 + (float)c);
                t1 = fb_of(code) + lm3;
                t3 = fmaxf(mp12 - gh, q3 - g);
                omega = (jg + m13l) - gh;
            }
            run = fmaxf(run, omega);
            p1[c] = t1;
            p2[c] = run;  // the thread-local prefix; fixed in pass 3
            p3[c] = t3;
            lm3 = mp3;
            m13l = fmaxf(t1, t3);
        }

        // scan: the exclusive prefix max of the threads' maxima
        const float incl = warp_incl_max(run);
        float inwarp = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) inwarp = NEG;
        if (CLUSTER) {
            // lane q hands the warp's total to CTA q (this one and later)
            const float tot = __shfl_sync(kFull, incl, 31);
            if (lane >= rank && lane < k)
                *cluster.map_shared_rank(&wt[par][gw], lane) = tot;
            __syncwarp();
            cluster_arrive();
            cluster_wait();
        } else {
            if (lane == 31) wt[par][warp] = incl;
            __syncthreads();
        }
        float wpre = NEG;
        for (int s = lane; s < gw; s += 32) wpre = fmaxf(wpre, wt[par][s]);
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            wpre = fmaxf(wpre, __shfl_xor_sync(kFull, wpre, s));
        const float excl = fmaxf(wpre, inwarp);

        // pass 3: T2, d2 and the finals
        const float t2l = c0 == 0 ? NEG : excl - g * (fc0 - 1.0f);
        int d2 = argmax3(t1l - h, t2l, t3l - h);
        const bool cap = i == lA;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = c0 + c;
            const float pm = fmaxf(p2[c], excl);
            const float t2 = (c == 0 && c0 == 0) ? NEG
                                                 : pm - g * (fc0 + (float)c);
            p2[c] = t2;
            w2[c >> 1] |= (uint32_t)(d2 << 2) << ((c & 1) * 16);
            d2 = argmax3(p1[c] - h, t2, p3[c] - h);
            if (cap && j == lB) finals(p1[c], t2, p3[c]);
        }
        if (i == m) {
            store_words<C>(dirs_row(i), c0, pitch, w2);
            break;
        }

        // the halo of the next row: this row at the last column, max3 at
        // the one before
        const float4 hv = make_float4(
            p1[C - 1], p2[C - 1], p3[C - 1],
            fmaxf(fmaxf(p1[C - 2], p2[C - 2]), p3[C - 2]));
        const int hwv = word_at<C>(w2, C - 1);
        hp1 = __shfl_up_sync(kFull, hv.x, 1);
        hp2 = __shfl_up_sync(kFull, hv.y, 1);
        hp3 = __shfl_up_sync(kFull, hv.z, 1);
        hm2 = __shfl_up_sync(kFull, hv.w, 1);
        hw = __shfl_up_sync(kFull, hwv, 1);
        if (lane == 31) {
            if (warp + 1 < NW) {
                xh[par][warp + 1] = hv;
                xw[par][warp + 1] = hwv;
            } else if (CLUSTER && rank + 1 < k) {
                *cluster.map_shared_rank(&xh[par][0], rank + 1) = hv;
                *cluster.map_shared_rank(&xw[par][0], rank + 1) = hwv;
            }
        }
        if (CLUSTER) {
            __syncwarp();
            cluster_arrive();
            store_words<C>(dirs_row(i), c0, pitch, w2);
            __syncwarp();
            cluster_wait();
        } else {
            __syncthreads();
            store_words<C>(dirs_row(i), c0, pitch, w2);
        }
        if (c0 == 0) {  // column 0 sees a -inf row and a zero word
            hp1 = hp2 = hp3 = NEG;
            hw = 0;
        } else if (lane == 0) {
            const float4 x = xh[par][warp];
            hp1 = x.x;
            hp2 = x.y;
            hp3 = x.z;
            hm2 = x.w;
            hw = xw[par][warp];
        }
    }
}

template <int C, bool TABLE, bool CLUSTER>
int launch(const uint8_t* a, const uint8_t* b, const int32_t* la,
           const int32_t* lb, const int32_t* st, uint16_t* dirs, float* out,
           int B, int m, int n, int pitch, int threads, int k, float g,
           float h, float match, float mismatch, const float* table, int k1,
           cudaStream_t stream) {
    auto kern = fill_kernel<C, TABLE, CLUSTER>;
    const size_t smem = TABLE ? (size_t)k1 * k1 * sizeof(float) : 0;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * (unsigned)k);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    if (CLUSTER) {
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = (unsigned)k;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
        if (e != cudaSuccess) return (int)e;
        if (clusters < 1) return kNoCluster;
    }
    e = cudaLaunchKernelEx(&cfg, kern, a, b, la, lb, st, dirs, out, B, m, n,
                           pitch, k, g, h, match, mismatch, table, k1);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <int C, bool TABLE, bool CLUSTER>
int occupancy(int threads, int k, int k1, int* per_sm, int* clusters) {
    auto kern = fill_kernel<C, TABLE, CLUSTER>;
    const size_t smem = TABLE ? (size_t)k1 * k1 * sizeof(float) : 0;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    *clusters = 0;
    if (!CLUSTER) return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)k);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

bool bad_geometry(int n, int pitch, int C, int threads, int k,
                  bool table, int k1) {
    return threads < 32 || threads > max_threads(C) || threads % 32 != 0 ||
           (C != 4 && C != 8 && C != 16) || k < 1 || k > kMaxCluster ||
           (k > 1 && C != 16) || (long long)k * threads * C < n + 1 ||
           pitch < n + 1 || pitch % 8 != 0 ||
           (table && (k1 < 2 || k1 > 255));
}

}  // namespace

extern "C" {

// a: (B, m) u8; b: (B, n) u8 (codes below k1 with a table); la/lb/st:
// (B,) i32; dirs: (m+1, B, pitch) uint16, pitch a multiple of 8 and at
// least n + 1 (columns past n hold no defined word); out: (B, 3) f32
// finals (T1, T2, T3) at (la, lb), set to -inf by the caller (a pair
// whose la exceeds m or lb exceeds n keeps it); table: (k1, k1) f32
// row-major, 2 <= k1 <= 255, or null (K1). C columns a thread (4, 8 or
// 16), threads a multiple of 32 up to 512, k CTAs a pair (1 to 8, C = 16
// when k > 1) with k * threads * C >= n + 1. Returns a cudaError_t code,
// or -1 when a cluster of k such CTAs cannot be co-scheduled.
int rowfill(const uint8_t* a, const uint8_t* b, const int32_t* la,
            const int32_t* lb, const int32_t* st, uint16_t* dirs,
            float* out, int B, int m, int n, int pitch, int C, int threads,
            int k, float g, float h, float match, float mismatch,
            const float* table, int k1, void* stream) {
    if (B == 0) return 0;
    if (bad_geometry(n, pitch, C, threads, k, table != nullptr, k1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define ROWFILL_LAUNCH(CC, TAB, CL)                                          \
    return launch<CC, TAB, CL>(a, b, la, lb, st, dirs, out, B, m, n, pitch,  \
                               threads, k, g, h, match, mismatch, table, k1, \
                               s)
    if (k > 1) {
        if (table) ROWFILL_LAUNCH(16, true, true);
        ROWFILL_LAUNCH(16, false, true);
    }
    if (table) {
        if (C == 4) ROWFILL_LAUNCH(4, true, false);
        if (C == 8) ROWFILL_LAUNCH(8, true, false);
        ROWFILL_LAUNCH(16, true, false);
    }
    if (C == 4) ROWFILL_LAUNCH(4, false, false);
    if (C == 8) ROWFILL_LAUNCH(8, false, false);
    ROWFILL_LAUNCH(16, false, false);
#undef ROWFILL_LAUNCH
}

// CUDA's resident CTAs an SM of the instance a geometry launches, and,
// for k > 1, the clusters of k that the card holds at once (0 when k =
// 1); table != 0 picks the TABLE instance at k1 codes. Returns a
// cudaError_t code.
int rowfill_occupancy(int C, int threads, int k, int table, int k1,
                      int* per_sm, int* clusters) {
    if (bad_geometry(0, 8, C, threads, k, table != 0, k1))
        return (int)cudaErrorInvalidValue;
#define ROWFILL_OCC(CC, TAB, CL) \
    return occupancy<CC, TAB, CL>(threads, k, k1, per_sm, clusters)
    if (k > 1) {
        if (table) ROWFILL_OCC(16, true, true);
        ROWFILL_OCC(16, false, true);
    }
    if (table) {
        if (C == 4) ROWFILL_OCC(4, true, false);
        if (C == 8) ROWFILL_OCC(8, true, false);
        ROWFILL_OCC(16, true, false);
    }
    if (C == 4) ROWFILL_OCC(4, false, false);
    if (C == 8) ROWFILL_OCC(8, false, false);
    ROWFILL_OCC(16, false, false);
#undef ROWFILL_OCC
}

}  // extern "C"
