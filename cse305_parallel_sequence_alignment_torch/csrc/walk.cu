// Traceback walks for the H100 (sm_90a), plain C interface: the
// run-length walk K2 and the single-step walk K2s.
//
// K2 rle_walk replaces _walk_core_rle with layout "row"
// (cse305_parallel_sequence_alignment_tpu/ops/device_walk.py:124), which
// is XLA on the TPU, and the experimental Pallas walk _walk_group_kernel
// (ops/pallas_walk.py:41) that emits the same stream; with band_lo >= 0,
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
                                int ncols, int max_rounds, int band_lo) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int i = la[b], j = lb[b], t = t0[b];
    int r = 0;
    bool done = (i == 0) || (j == 0);
    while (!done && r < max_rounds) {
        const int ri = min(max(i, 0), nrows - 1);
        const int cj = min(max(band_lo < 0 ? j : j - i + band_lo, 0),
                           ncols - 1);
        const int word = dirs[((size_t)ri * B + b) * ncols + cj];
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

}  // namespace

extern "C" {

// dirs: (nrows, B, ncols) uint16, row layout when band_lo < 0, else band
// layout with lower width band_lo; la/lb/t0: (B,) i32; entries:
// (max_rounds, B) uint16, zeroed by the caller; used: one i32, zeroed by
// the caller. Returns a cudaError_t code.
int rle_walk(const uint16_t* dirs, const int32_t* la, const int32_t* lb,
             const int32_t* t0, uint16_t* entries, int32_t* used, int B,
             int nrows, int ncols, int max_rounds, int band_lo,
             void* stream) {
    if (B == 0) return 0;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    rle_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dirs, la, lb, t0, entries, used, B, nrows, ncols, max_rounds,
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

}  // extern "C"
