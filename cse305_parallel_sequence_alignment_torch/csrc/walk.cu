// Traceback walks for the H100 (sm_90a), plain C interface: the
// run-length walk K2, its grouped form K2' and the single-step walk K2s.
//
// K2 rle_walk replaces _walk_core_rle with layout "row"
// (cse305_parallel_sequence_alignment_tpu/ops/device_walk.py:124), which
// is XLA on the TPU; with band_lo >= 0,
// the walk of layout ("band", band_lo) (device_walk.py:163-164) over the
// K12d band dirs (csrc/banded.cu), cell (i, j) at column j - i + band_lo.
//
// Per pair, from (la, lb, end table t): each round does one dependent read
// of the dirs16 cell at (i, j), clamped into the array (in band layout the
// column j - i + band_lo is clamped, as the JAX walk clamps it; a diagonal
// run keeps its band column, so rounds are the same). In T1 it takes the
// cell's whole diagonal run (R cells of code 0, then the after-run code):
// R+1 diagonal moves. In T2/T3 it takes one step by the cell's code for
// that table. It writes entries[round, pair] = (op+1) | R << 2 and stops
// once i <= 0 or j <= 0; positions may overshoot the DP edge and the host
// replay cuts there. rounds_used is the exact maximum of the per-pair
// round counts (atomicMax), not rounded up as the TPU walk's unroll is.
//
// K2s step_walk replaces the XLA single-step walk _walk_core
// (device_walk.py:35) with layout "row" or "skew", as _device_walk runs it
// (:266-275) over the uint8 dirs of K1' (csrc/rowcb.cu, cell (i, j) at
// dirs[i, pair, j]) or K5 (csrc/diag.cu, at dirs[i + j, pair, j]), with
// plain column order (no lane permutation). From (la, lb, end table t),
// while i > 0 and j > 0, each step reads the cell's code for table t, writes
// ops[step, pair] = code + 1, moves by t (T1 diagonal, T2 left, T3 up) and
// continues in table code + 1 (1 after a code of 3); a pair that starts on
// row 0 or column 0 writes nothing. So does one whose start cell lies
// outside dirs or whose table is not 1..3: it reads nothing, and the host
// replay refuses its empty walk. used is the largest step count.
//
// K2' group_walk replaces the Pallas walk _walk_group_kernel
// (ops/pallas_walk.py:41, through pallas_walk_rle :146): the same entry
// stream as K2, laid out per pair, entries[pair, round] int32 of an
// (B, R_pad) array, with used[pair] the pair's own round count. A walk
// also stops once it has taken R_pad rounds, and a 0 terminator is then
// written at entries[pair, min(used, R_pad - 1)] (with used == R_pad it
// overwrites the last round, as the TPU kernel does). A pair that starts on
// row 0 or column 0 takes no round. Table decoding follows that kernel
// (any table but 2 or 3 reads d1's bits outside a run; only 1 takes runs).
// The TPU kernel walks G pairs a grid step, interleaved so that G tile
// DMAs are in flight at once; here one thread walks G pairs (G = 1, 2, 4
// or 8, a template parameter) interleaved the same way: each round first
// issues the G pairs' dependent reads, then decodes them, so G loads are
// in flight per thread. G = 1 is K2's one pair a thread. A thread's pairs
// are consecutive; the last thread masks the pairs past B, so B need not
// divide by G (the TPU wrapper halves G until it does). The dirs are read
// as uint16 cells of the port's (row, pair, column) layout; the pair
// stride may exceed the number of walked pairs (a padded fill).
//
// Design and bounds. One thread per pair: the walk is a chain of
// dependent loads (~a few hundred ns each from HBM, the cells of a pair's
// path are scattered over ~8 MB at 2 kb), so it is latency-bound and the
// pairs' chains run side by side; entries of one round are contiguous
// across pairs, so each round's stores coalesce. K2s takes one step a
// load where K2 takes a whole diagonal run, ~(m+n)/2 loads a pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rle_walk_kernel(const uint16_t* __restrict__ dirs,
                                const int32_t* __restrict__ la,
                                const int32_t* __restrict__ lb,
                                const int32_t* __restrict__ t0,
                                uint16_t* __restrict__ entries,
                                int32_t* __restrict__ used, int B, int nrows,
                                int ncols, int pitch, int max_rounds,
                                int band_lo) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int i = la[b], j = lb[b], t = t0[b];
    int r = 0;
    bool done = (i == 0) || (j == 0);
    while (!done && r < max_rounds) {
        const int ri = min(max(i, 0), nrows - 1);
        const int cj = min(max(band_lo < 0 ? j : j - i + band_lo, 0),
                           ncols - 1);
        const int word = dirs[((size_t)ri * B + b) * pitch + cj];
        int k = 0, op, di, dj;
        if (t == 1) {
            k = (word >> 8) & 255;
            op = (word >> 6) & 3;
            di = dj = k + 1;
        } else {
            op = (word >> (t == 2 ? 2 : 4)) & 3;
            di = t == 3 ? 1 : 0;
            dj = t == 2 ? 1 : 0;
        }
        entries[(size_t)r * B + b] = (uint16_t)((op + 1) | (k << 2));
        t = op + 1;
        i -= di;
        j -= dj;
        ++r;
        done = (i <= 0) || (j <= 0);
    }
    atomicMax(used, r);
}

__global__ void step_walk_kernel(const uint8_t* __restrict__ dirs,
                                 const int32_t* __restrict__ la,
                                 const int32_t* __restrict__ lb,
                                 const int32_t* __restrict__ t0,
                                 uint8_t* __restrict__ ops,
                                 int32_t* __restrict__ used, int B,
                                 int nrows, int ncols, int max_steps,
                                 int skew) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int i = la[b], j = lb[b], t = t0[b];
    // a start outside the dirs, or in no table, takes no step
    if (i < 0 || j < 0 || j >= ncols || (skew ? i + j : i) >= nrows ||
        t < 1 || t > 3)
        return;
    int k = 0;
    while (i > 0 && j > 0 && k < max_steps) {
        const int r = skew ? i + j : i;
        const int byte = dirs[((size_t)r * B + b) * ncols + j];
        const int code = (byte >> (2 * (t - 1))) & 3;
        ops[(size_t)k * B + b] = (uint8_t)(code + 1);
        ++k;
        i -= (t == 1 || t == 3);
        j -= (t == 1 || t == 2);
        t = code >= 3 ? 1 : code + 1;
    }
    atomicMax(used, k);
}

template <int G>
__global__ void group_walk_kernel(const uint16_t* __restrict__ dirs,
                                  const int32_t* __restrict__ la,
                                  const int32_t* __restrict__ lb,
                                  const int32_t* __restrict__ t0,
                                  int32_t* __restrict__ entries,
                                  int32_t* __restrict__ used, int B,
                                  int pair_stride, int nrows, int ncols,
                                  int pitch, int R_pad) {
    const int g0 = (blockIdx.x * blockDim.x + threadIdx.x) * G;
    if (g0 >= B) return;
    int iv[G], jv[G], tv[G], rd[G];
    bool alive[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
        const int b = g0 + u < B ? g0 + u : g0;
        iv[u] = la[b];
        jv[u] = lb[b];
        tv[u] = t0[b];
        rd[u] = 0;
        alive[u] = g0 + u < B && iv[u] > 0 && jv[u] > 0;
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < G; ++u) any |= alive[u];
    while (any) {
        int word[G];
        // the G dependent reads first, so they are in flight together
#pragma unroll
        for (int u = 0; u < G; ++u) {
            word[u] = 0;
            if (alive[u]) {
                const int r = min(max(iv[u], 0), nrows - 1);
                const int c = min(max(jv[u], 0), ncols - 1);
                word[u] = dirs[((size_t)r * pair_stride + g0 + u) * pitch + c];
            }
        }
        any = false;
#pragma unroll
        for (int u = 0; u < G; ++u) {
            if (!alive[u]) continue;
            const int w = word[u], t = tv[u];
            const int shift = t == 2 ? 2 : (t == 3 ? 4 : 0);
            const bool run = t == 1;
            const int k = run ? (w >> 8) & 255 : 0;
            const int op = run ? (w >> 6) & 3 : (w >> shift) & 3;
            const int di = run ? k + 1 : (t == 3 ? 1 : 0);
            const int dj = run ? k + 1 : (t == 2 ? 1 : 0);
            entries[(size_t)(g0 + u) * R_pad + rd[u]] = (op + 1) | (k << 2);
            iv[u] -= di;
            jv[u] -= dj;
            tv[u] = op + 1;
            ++rd[u];
            alive[u] = iv[u] > 0 && jv[u] > 0 && rd[u] < R_pad;
            any |= alive[u];
        }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
        if (g0 + u >= B) continue;
        used[g0 + u] = rd[u];
        // the terminator of the host replay (op == 0 ends the stream)
        entries[(size_t)(g0 + u) * R_pad + min(rd[u], R_pad - 1)] = 0;
    }
}

template <int G>
int launch_group(const uint16_t* dirs, const int32_t* la, const int32_t* lb,
                 const int32_t* t0, int32_t* entries, int32_t* used, int B,
                 int pair_stride, int nrows, int ncols, int pitch, int R_pad,
                 cudaStream_t stream) {
    const int threads = 128;
    const int walkers = (B + G - 1) / G;
    const int blocks = (walkers + threads - 1) / threads;
    group_walk_kernel<G><<<blocks, threads, 0, stream>>>(
        dirs, la, lb, t0, entries, used, B, pair_stride, nrows, ncols, pitch,
        R_pad);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dirs: (nrows, B, ncols) uint16 with a row pitch of pitch >= ncols
// elements (cell (r, b, c) at (r * B + b) * pitch + c: K1's pitched dirs;
// pitch = ncols for a contiguous array), row layout when band_lo < 0, else
// band layout with lower width band_lo; la/lb/t0: (B,) i32; entries:
// (max_rounds, B) uint16, zeroed by the caller; used: one i32, zeroed by
// the caller. Returns a cudaError_t code.
int rle_walk(const uint16_t* dirs, const int32_t* la, const int32_t* lb,
             const int32_t* t0, uint16_t* entries, int32_t* used, int B,
             int nrows, int ncols, int pitch, int max_rounds, int band_lo,
             void* stream) {
    if (B == 0) return 0;
    if (pitch < ncols) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    rle_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dirs, la, lb, t0, entries, used, B, nrows, ncols, pitch, max_rounds,
        band_lo);
    return (int)cudaGetLastError();
}

// dirs: (nrows, B, ncols) uint8, row layout (cell (i, j) at row i) or with
// skew != 0 skew layout (at row i + j); la/lb/t0: (B,) i32, a pair whose
// start cell lies outside dirs or whose t0 is not 1..3 takes no step; ops:
// (max_steps, B) uint8, zeroed by the caller; used: one i32, zeroed by the
// caller. Returns a cudaError_t code.
int step_walk(const uint8_t* dirs, const int32_t* la, const int32_t* lb,
              const int32_t* t0, uint8_t* ops, int32_t* used, int B,
              int nrows, int ncols, int max_steps, int skew, void* stream) {
    if (B == 0) return 0;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    step_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dirs, la, lb, t0, ops, used, B, nrows, ncols, max_steps, skew);
    return (int)cudaGetLastError();
}

// dirs: (nrows, pair_stride, ncols) uint16 dirs16+runs, row layout, with
// pair_stride >= B and a row pitch of pitch >= ncols elements, as
// rle_walk's; la/lb/t0: (B,) i32; entries: (B, R_pad) i32, zeroed by the
// caller; used: (B,) i32; G pairs a thread, 1, 2, 4 or 8; R_pad >= 1.
// Returns a cudaError_t code.
int group_walk(const uint16_t* dirs, const int32_t* la, const int32_t* lb,
               const int32_t* t0, int32_t* entries, int32_t* used, int B,
               int pair_stride, int nrows, int ncols, int pitch, int R_pad,
               int G, void* stream) {
    if (B == 0) return 0;
    if (pair_stride < B || R_pad < 1 || nrows < 1 || ncols < 1 ||
        pitch < ncols)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (G) {
        case 1: return launch_group<1>(dirs, la, lb, t0, entries, used, B,
                                       pair_stride, nrows, ncols, pitch, R_pad,
                                       s);
        case 2: return launch_group<2>(dirs, la, lb, t0, entries, used, B,
                                       pair_stride, nrows, ncols, pitch, R_pad,
                                       s);
        case 4: return launch_group<4>(dirs, la, lb, t0, entries, used, B,
                                       pair_stride, nrows, ncols, pitch, R_pad,
                                       s);
        case 8: return launch_group<8>(dirs, la, lb, t0, entries, used, B,
                                       pair_stride, nrows, ncols, pitch, R_pad,
                                       s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
