// Native host runtime: the port's own copy of the JAX package's
// native/tsalib.cpp (the port builds this file, ops/_build.py
// host_library, and reads nothing of the other package). The port calls
// tsa_replay_rle_batch, tsa_render and its own tsa_local_build and
// tsa_free_end_build (native/walker.py).
//
// The device does the O(m*n) fill; these routines cover the
// inherently sequential / IO-bound host side, mirroring the roles the
// reference implements in C++ (traceback: subproblem_alignment.cpp:105-172;
// FASTA ingestion: test_functions/pull_data.cpp:18-71) but operating on the
// packed direction matrices our kernels emit.
//
// Exposed with a plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Walk a packed direction matrix back from (m, n).
//
//   dirs:     base pointer of the uint8 direction array
//   stride_d: byte stride between rows (rect: row i; skew: diagonal d)
//   stride_j: byte stride between columns
//   layout:   0 = rect (cell (i,j) at dirs[i][j]),
//             1 = skew (cell (i,j) at dirs[i+j][j])
//   t0:       end table in {1,2,3}
//
// Writes the predecessor steps in walk order (end -> start) as parallel
// arrays out_t / out_pi / out_pj and returns the number of steps.
// Buffers must hold at least m + n entries.
//
// Direction byte: 2 bits per table, value 0/1/2 = predecessor T1/T2/T3,
// fields at bit 0 (T1), 2 (T2), 4 (T3) — core.py packing.
int64_t tsa_walk(const uint8_t* dirs, int64_t stride_d, int64_t stride_j,
                 int64_t m, int64_t n, int t0, int layout,
                 int32_t* out_t, int64_t* out_pi, int64_t* out_pj) {
    int64_t i = m, j = n;
    int t = t0;
    int64_t k = 0;
    while (i > 0 && j > 0) {
        int64_t row = (layout == 1) ? (i + j) : i;
        uint8_t byte = dirs[row * stride_d + j * stride_j];
        int shift = (t == 1) ? 0 : (t == 2) ? 2 : 4;
        int tn = ((byte >> shift) & 0x3) + 1;
        int64_t pi, pj;
        if (t == 1) {
            pi = i - 1; pj = j - 1; i--; j--;
        } else if (t == 2) {
            pi = i; pj = j - 1; j--;
        } else {
            pi = i - 1; pj = j; i--;
        }
        out_t[k] = tn;
        out_pi[k] = pi;
        out_pj[k] = pj;
        k++;
        t = tn;
    }
    return k;
}

// Render the two aligned text rows directly from a walked chain
// (the reference's print_seq, main_alignment.cpp:32-55).
//
//   a, b:   0-indexed sequences (lengths m, n)
//   tt/ii/jj: chain arrays in start -> end order (1-indexed points)
//   len:    chain length
// Writes len bytes into row_a and row_b.
void tsa_render(const uint8_t* a, const uint8_t* b,
                const int32_t* tt, const int64_t* ii, const int64_t* jj,
                int64_t len, uint8_t* row_a, uint8_t* row_b) {
    for (int64_t k = 0; k < len; k++) {
        int t = tt[k];
        row_a[k] = (t == 1 || t == 3) ? a[ii[k] - 1] : '-';
        row_b[k] = (t == 1 || t == 2) ? b[jj[k] - 1] : '-';
    }
}

// First pass over a FASTA buffer: count records and total sequence bytes.
// Returns 0 on success.
int tsa_fasta_scan(const uint8_t* buf, int64_t size,
                   int64_t* num_records, int64_t* total_seq_bytes) {
    int64_t nrec = 0, nbytes = 0;
    int64_t pos = 0;
    while (pos < size) {
        int64_t eol = pos;
        while (eol < size && buf[eol] != '\n') eol++;
        if (eol > pos) {
            if (buf[pos] == '>') {
                nrec++;
            } else {
                int64_t len = eol - pos;
                if (buf[eol - 1] == '\r') len--;
                nbytes += len;
            }
        }
        pos = eol + 1;
    }
    *num_records = nrec;
    *total_seq_bytes = nbytes;
    return 0;
}

// Second pass: concatenate sequence bytes and record per-record offsets.
// seq_out must hold total_seq_bytes; offsets must hold num_records + 1
// (offsets[k]..offsets[k+1] is record k); name_spans holds 2 entries per
// record (byte offset and length of the header line, '>' included).
int tsa_fasta_parse(const uint8_t* buf, int64_t size,
                    uint8_t* seq_out, int64_t* offsets,
                    int64_t* name_spans) {
    int64_t rec = -1, out = 0, pos = 0;
    while (pos < size) {
        int64_t eol = pos;
        while (eol < size && buf[eol] != '\n') eol++;
        if (eol > pos) {
            int64_t len = eol - pos;
            if (buf[eol - 1] == '\r') len--;
            if (buf[pos] == '>') {
                rec++;
                offsets[rec] = out;
                name_spans[2 * rec] = pos;
                name_spans[2 * rec + 1] = len;
            } else if (rec >= 0) {
                std::memcpy(seq_out + out, buf + pos, len);
                out += len;
            }
        }
        pos = eol + 1;
    }
    offsets[rec + 1] = out;
    return 0;
}

// Batched traceback: walk every pair of a bucket concurrently and emit
// finished chains (start -> end order, reference point semantics:
// t==1 stores (i, j); t==2 stores (0, j); t==3 stores (i, 0) — quirk B2).
//
//   dirs:      shared direction array for the bucket; cell (pair r,
//              diag/row d, column j) lives at
//              dirs[r*stride_r + d*stride_d + j*stride_j]
//              (covers both the (B, m+n+1, n+1) wavefront layout and the
//              (m+n+1, B, n+1) Pallas layout via strides)
//   ms/ns/t0s: per-pair end cell and end table
//   layout:    0 = rect, 1 = skew
//   mode:      0 = parity (stop at the matrix edge, drop the first
//              point — reference B1); 1 = full (emit forced edge runs
//              to (0,0), drop the (0,0) sentinel)
//   cap:       per-pair output slot capacity (>= m + n + 2)
//
// Chain k of pair r is written at out_*[r*cap + k]; out_len[r] holds the
// chain length. Walks are independent -> striped across hardware threads.
static void walk_one_pair(
        const uint8_t* dirs, int64_t stride_r, int64_t stride_d,
        int64_t stride_j, int64_t m, int64_t n, int t0, int layout,
        int mode, int64_t cap, int32_t* out_t, int64_t* out_i,
        int64_t* out_j, int64_t* out_len, int64_t r) {
    const uint8_t* base = dirs + r * stride_r;
    // rev buffers hold end -> start; emit reversed with first dropped
    std::vector<int32_t> rt;
    std::vector<int64_t> ri, rj;
    rt.reserve(cap); ri.reserve(cap); rj.reserve(cap);
    auto push = [&](int64_t i, int64_t j, int t) {
        rt.push_back(t);
        ri.push_back(t == 2 ? 0 : i);
        rj.push_back(t == 3 ? 0 : j);
    };
    int64_t i = m, j = n;
    int t = t0;
    push(i, j, t);
    while (i > 0 && j > 0) {
        int64_t row = (layout == 1) ? (i + j) : i;
        uint8_t byte = base[row * stride_d + j * stride_j];
        int shift = (t == 1) ? 0 : (t == 2) ? 2 : 4;
        int tn = ((byte >> shift) & 0x3) + 1;
        int64_t pi, pj;
        if (t == 1)      { pi = i - 1; pj = j - 1; i--; j--; }
        else if (t == 2) { pi = i;     pj = j - 1; j--; }
        else             { pi = i - 1; pj = j;     i--; }
        push(pi, pj, tn);
        t = tn;
    }
    if (mode == 1) {
        if (i == 0) {
            while (j > 0) { push(0, j - 1, 2); j--; }
        } else {
            while (i > 0) { push(i - 1, 0, 3); i--; }
        }
    }
    // reversed(rev)[1:]: drop the deepest point (rev's last entry, B1 /
    // the (0,0) sentinel) and emit the rest start -> end
    int64_t len = (int64_t)rt.size() - 1;
    if (len < 0) len = 0;
    for (int64_t k = 0; k < len; k++) {
        int64_t src = len - 1 - k;  // rev[len-1] .. rev[0]
        out_t[r * cap + k] = rt[src];
        out_i[r * cap + k] = ri[src];
        out_j[r * cap + k] = rj[src];
    }
    out_len[r] = len;
}

// Replay the run-length walk entries the fused device path emits
// (ops/device_walk.py _walk_core_rle: uint16 entry = op | runlen << 2;
// a round is runlen rec-1 steps then one rec-op step; op == 0 ends the
// stream). Reproduces ops/device_walk.py replay_ops exactly: quirk-B2
// zeros, global offsets, parity (B1: stop at the edge, drop the
// deepest point) or full mode (forced edge runs to the corner).
// Returns -1 in out_len[r] if pair r's stream ends before an edge
// (corrupt entries) — the Python wrapper raises.
static void replay_one(const uint16_t* ent, int64_t Rn, int64_t la,
                       int64_t lb, int t0, int64_t id_a, int64_t id_b,
                       int mode, int64_t cap, int32_t* out_t,
                       int64_t* out_i, int64_t* out_j, int64_t* out_len,
                       int64_t r) {
    std::vector<int32_t> rt;
    std::vector<int64_t> ri, rj;
    rt.reserve(cap); ri.reserve(cap); rj.reserve(cap);
    auto push = [&](int64_t i, int64_t j, int t) {
        rt.push_back(t);
        ri.push_back(t == 2 ? 0 : i + id_a);
        rj.push_back(t == 3 ? 0 : j + id_b);
    };
    int64_t i = la, j = lb;
    int t = t0;
    int64_t e = 0;       // entry cursor
    int64_t run = 0;     // remaining rec-1 steps of the current entry
    int pend = 0;        // the entry's final op (valid when run >= 0)
    bool have = false;
    while (i > 0 && j > 0) {
        push(i, j, t);
        if (!have) {
            if (e >= Rn) { out_len[r] = -1; return; }
            uint16_t b = ent[e++];
            pend = b & 3;
            run = b >> 2;
            if (pend == 0) { out_len[r] = -1; return; }
            have = true;
        }
        int tn;
        if (run > 0) { tn = 1; run--; }
        else         { tn = pend; have = false; }
        // move by the CURRENT table, continue in tn
        if (t == 1)      { i--; j--; }
        else if (t == 2) { j--; }
        else             { i--; }
        t = tn;
    }
    push(i, j, t);  // the edge-entry point (dropped below / kept by runs)
    if (mode == 1) {
        if (i == 0) {
            while (j > 0) { push(0, j - 1, 2); j--; }
        } else {
            while (i > 0) { push(i - 1, 0, 3); i--; }
        }
    }
    int64_t len = (int64_t)rt.size() - 1;
    if (len < 0) len = 0;
    for (int64_t k = 0; k < len; k++) {
        int64_t src = len - 1 - k;
        out_t[r * cap + k] = rt[src];
        out_i[r * cap + k] = ri[src];
        out_j[r * cap + k] = rj[src];
    }
    out_len[r] = len;
}

int tsa_replay_rle_batch(const uint16_t* entries, int64_t Rn,
                         const int64_t* la, const int64_t* lb,
                         const int32_t* t0s, const int64_t* id_a,
                         const int64_t* id_b, int64_t B, int mode,
                         int64_t cap, int32_t* out_t, int64_t* out_i,
                         int64_t* out_j, int64_t* out_len) {
    int64_t nthreads = std::min<int64_t>(
        B, std::max(1u, std::thread::hardware_concurrency()));
    auto worker = [&](int64_t w) {
        for (int64_t r = w; r < B; r += nthreads) {
            replay_one(entries + r * Rn, Rn, la[r], lb[r], t0s[r],
                       id_a ? id_a[r] : 0, id_b ? id_b[r] : 0, mode,
                       cap, out_t, out_i, out_j, out_len, r);
        }
    };
    if (nthreads <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t w = 0; w < nthreads; w++) pool.emplace_back(worker, w);
        for (auto& th : pool) th.join();
    }
    return 0;
}

int tsa_walk_batch(const uint8_t* dirs, int64_t stride_r, int64_t stride_d,
                   int64_t stride_j, const int64_t* ms, const int64_t* ns,
                   const int32_t* t0s, int64_t B, int layout, int mode,
                   int64_t cap, int32_t* out_t, int64_t* out_i,
                   int64_t* out_j, int64_t* out_len) {
    int64_t nthreads = std::min<int64_t>(
        B, std::max(1u, std::thread::hardware_concurrency()));
    auto worker = [&](int64_t w) {
        for (int64_t r = w; r < B; r += nthreads) {
            walk_one_pair(dirs, stride_r, stride_d, stride_j, ms[r],
                          ns[r], t0s[r], layout, mode, cap, out_t, out_i,
                          out_j, out_len, r);
        }
    };
    if (nthreads <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t w = 0; w < nthreads; w++) pool.emplace_back(worker, w);
        for (auto& th : pool) th.join();
    }
    return 0;
}

// Append "<len><op>" to out; returns the bytes written (at most 2 * len).
static int64_t put_run(char* out, int64_t len, char op) {
    char digits[24];
    int nd = 0;
    do { digits[nd++] = (char)('0' + len % 10); len /= 10; } while (len);
    for (int k = 0; k < nd; k++) out[k] = digits[nd - 1 - k];
    out[nd] = op;
    return nd + 1;
}

// Run-length strings of one chain (start -> end, tables in t, B2 zeros):
// the CIGAR (M/D/I) and the extended CIGAR (=/X/D/I), as ops/cigar.py's
// chain_to_cigar and chain_to_cigar_extended build them; each run of r
// points takes at most 2r bytes.
static void chain_cigars(const int32_t* t, const int64_t* ii,
                         const int64_t* jj, int64_t K, const uint8_t* a,
                         const uint8_t* b, char* cig, int64_t* cig_len,
                         char* ext, int64_t* ext_len) {
    static const char kOp[4] = {'?', 'M', 'D', 'I'};
    int64_t nc = 0, ne = 0, rc = 0, re = 0;
    char pc = 0, pe = 0;
    for (int64_t q = 0; q < K; q++) {
        const char c = kOp[t[q]];
        const char e = t[q] != 1 ? c
                                 : (a[ii[q] - 1] == b[jj[q] - 1] ? '=' : 'X');
        if (c == pc) { rc++; } else {
            if (rc) nc += put_run(cig + nc, rc, pc);
            pc = c; rc = 1;
        }
        if (e == pe) { re++; } else {
            if (re) ne += put_run(ext + ne, re, pe);
            pe = e; re = 1;
        }
    }
    if (rc) nc += put_run(cig + nc, rc, pc);
    if (re) ne += put_run(ext + ne, re, pe);
    *cig_len = nc;
    *ext_len = ne;
}

// One pair of tsa_local_build.
static void local_one(const uint8_t* op, int64_t L, int64_t ei, int64_t ej,
                      const uint8_t* a, const uint8_t* b, int64_t cap,
                      int32_t* out_t, int64_t* out_i, int64_t* out_j,
                      int64_t* len_out, int64_t* sa, int64_t* sb,
                      char* cig, int64_t* cig_len, char* ext,
                      int64_t* ext_len) {
    int64_t K = 0;
    while (K < L && op[K]) K++;
    // point k from the end sits at (i, j); it moves by its own table
    int64_t i = ei, j = ej;
    for (int64_t k = 0; k < K; k++) {
        const int t = op[k];
        const int64_t q = K - 1 - k;  // chain order: start -> end
        out_t[q] = t;
        out_i[q] = t == 2 ? 0 : i;
        out_j[q] = t == 3 ? 0 : j;
        if (t != 2) i--;
        if (t != 3) j--;
    }
    *len_out = K;
    *sa = *sb = 0;
    for (int64_t q = 0; q < K; q++)
        if (out_t[q] != 2) { *sa = out_i[q]; break; }
    for (int64_t q = 0; q < K; q++)
        if (out_t[q] != 3) { *sb = out_j[q]; break; }
    chain_cigars(out_t, out_i, out_j, K, a, b, cig, cig_len, ext, ext_len);
}

// Local-mode chains, spans and CIGARs from the local walk's table streams
// (ops/device_walk.py local_walk, rows transposed: ops[r * L + k] = the
// table, 1-3, of pair r's k-th chain point counted from its end cell
// (ei[r], ej[r]), 0 past the chain). Writes pair r's chain in start->end
// order to out_t/out_i/out_j[r * cap ...] (gap points store 0 for the
// gapped side, as walk_local_batch_device builds them), its length to
// out_len[r], the first A and B positions it consumes to out_sa/out_sb,
// and its CIGAR (M/I/D) and extended CIGAR (=/X/I/D) to
// cig/ext[r * scap ...], lengths in cig_len/ext_len: the strings of
// ops/cigar.py chain_to_cigar(_extended). a/b: the bucket's (B, m) /
// (B, n) codes. cap >= L and scap >= 2 L.
int tsa_local_build(const uint8_t* ops, int64_t L, const int64_t* ei,
                    const int64_t* ej, const uint8_t* a, int64_t m,
                    const uint8_t* b, int64_t n, int64_t B, int64_t cap,
                    int32_t* out_t, int64_t* out_i, int64_t* out_j,
                    int64_t* out_len, int64_t* out_sa, int64_t* out_sb,
                    int64_t scap, char* cig, int64_t* cig_len, char* ext,
                    int64_t* ext_len) {
    int64_t nthreads = std::min<int64_t>(
        B, std::max(1u, std::thread::hardware_concurrency()));
    auto worker = [&](int64_t w) {
        for (int64_t r = w; r < B; r += nthreads) {
            local_one(ops + r * L, L, ei[r], ej[r], a + r * m, b + r * n,
                      cap, out_t + r * cap, out_i + r * cap,
                      out_j + r * cap, out_len + r, out_sa + r, out_sb + r,
                      cig + r * scap, cig_len + r, ext + r * scap,
                      ext_len + r);
        }
    };
    if (nthreads <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t w = 0; w < nthreads; w++) pool.emplace_back(worker, w);
        for (auto& th : pool) th.join();
    }
    return 0;
}

// One pair of tsa_free_end_build; returns false if the entry stream ended
// before the walk reached row 0 or column 0.
static bool free_end_one(const uint16_t* ent, int64_t Rn, int64_t ei,
                         int64_t ej, int et, const uint8_t* a,
                         const uint8_t* b, int mode, int32_t* out_t,
                         int64_t* out_i, int64_t* out_j, int64_t* len_out,
                         int64_t* span, char* cig, int64_t* cig_len,
                         char* ext, int64_t* ext_len) {
    // the chain is written end -> start first, then reversed in place
    int64_t K = 0;
    auto push = [&](int64_t i, int64_t j, int t) {
        out_t[K] = t;
        out_i[K] = t == 2 ? 0 : i;
        out_j[K] = t == 3 ? 0 : j;
        K++;
    };
    int64_t i = ei, j = ej, e = 0, run = 0;
    int t = et, pend = 0;
    bool have = false;
    while (i > 0 && j > 0) {
        push(i, j, t);  // the end point is kept (no B1 drop)
        if (!have) {
            if (e >= Rn) return false;
            const uint16_t w = ent[e++];
            pend = w & 3;
            run = w >> 2;
            if (pend == 0) return false;
            have = true;
        }
        int tn;
        if (run > 0) { tn = 1; run--; }
        else         { tn = pend; have = false; }
        // move by the current table, continue in tn
        if (t == 1)      { i--; j--; }
        else if (t == 2) { j--; }
        else             { i--; }
        t = tn;
    }
    if (mode == 1)  // semi-global: the forced leading gap-in-B run
        while (i > 0) { push(i, 0, 3); i--; }
    std::reverse(out_t, out_t + K);
    std::reverse(out_i, out_i + K);
    std::reverse(out_j, out_j + K);
    *len_out = K;
    // spans: first and last A row (tables 1, 3) and B column (1, 2)
    span[0] = span[1] = span[2] = span[3] = 0;
    for (int64_t q = 0; q < K; q++)
        if (out_t[q] != 2) { span[0] = out_i[q]; break; }
    for (int64_t q = K - 1; q >= 0; q--)
        if (out_t[q] != 2) { span[1] = out_i[q]; break; }
    for (int64_t q = 0; q < K; q++)
        if (out_t[q] != 3) { span[2] = out_j[q]; break; }
    for (int64_t q = K - 1; q >= 0; q--)
        if (out_t[q] != 3) { span[3] = out_j[q]; break; }
    chain_cigars(out_t, out_i, out_j, K, a, b, cig, cig_len, ext, ext_len);
    return true;
}

// Semi-global (mode 1) and overlap (mode 2) chains, spans and CIGARs from
// the run-length walk's entries (ops/device_walk.py rle_walk started at
// each pair's end cell; rows transposed: ent[r * Rn + k] = entry k of
// pair r, (op+1) | run << 2, 0 past its stream). Pair r's walk starts at
// (ei[r], ej[r]) in table et[r] and stops at row 0 or column 0; the chain,
// start -> end with the end point included and gap points storing 0 for
// the gapped side, goes to out_t/out_i/out_j[r * cap ...] and its length
// to out_len[r] (-1 if the stream ended early: corrupt entries). In mode 1
// a walk that stops on column 0 with i > 0 adds the forced run (i, 0, 3)
// down to row 1, as walk_semiglobal_batch_device does. span[r * 4 ...]
// gets the first and last A row and B column the chain consumes (0 for
// none); cig/ext[r * scap ...] the CIGAR and extended CIGAR, lengths in
// cig_len/ext_len. a/b: the bucket's (B, m) / (B, n) codes. cap >= the
// longest chain (ei + ej), scap >= 2 cap.
int tsa_free_end_build(const uint16_t* ent, int64_t Rn, const int64_t* ei,
                       const int64_t* ej, const int32_t* et,
                       const uint8_t* a, int64_t m, const uint8_t* b,
                       int64_t n, int64_t B, int mode, int64_t cap,
                       int32_t* out_t, int64_t* out_i, int64_t* out_j,
                       int64_t* out_len, int64_t* span, int64_t scap,
                       char* cig, int64_t* cig_len, char* ext,
                       int64_t* ext_len) {
    int64_t nthreads = std::min<int64_t>(
        B, std::max(1u, std::thread::hardware_concurrency()));
    auto worker = [&](int64_t w) {
        for (int64_t r = w; r < B; r += nthreads) {
            if (!free_end_one(ent + r * Rn, Rn, ei[r], ej[r], et[r],
                              a + r * m, b + r * n, mode, out_t + r * cap,
                              out_i + r * cap, out_j + r * cap, out_len + r,
                              span + r * 4, cig + r * scap, cig_len + r,
                              ext + r * scap, ext_len + r))
                out_len[r] = -1;
        }
    };
    if (nthreads <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t w = 0; w < nthreads; w++) pool.emplace_back(worker, w);
        for (auto& th : pool) th.join();
    }
    return 0;
}

}  // extern "C"
