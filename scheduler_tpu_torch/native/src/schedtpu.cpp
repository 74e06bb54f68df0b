// Native host-runtime kernels for scheduler_tpu_torch.
//
// The card owns the placement solve (CUDA, ops/fused.py); these C++ kernels
// own the host side of the cycle — the commit-path reductions that turn a
// device placement result into cluster-state deltas.  They replace the
// reference's Go hot loops (resource-vector accounting in
// pkg/scheduler/api/resource_info.go:130-276 and the per-task bookkeeping in
// session.Allocate, session.go:242-297) with flat-array passes over the
// snapshot tensors.
//
// Contract notes:
// - All matrices are C-contiguous float64 [T, R] (raw units, same rows as
//   TaskInfo.resreq.array), ids are int32, T/R/S are int64.
// - Negative segment ids mean "drop this row" everywhere.
// - Kernels are single-threaded on purpose: at the 100k-row scale a pass is
//   memory-bound and takes well under a millisecond; thread fan-out would
//   cost more in coordination than it saves.

#include <cstdint>
#include <cstring>

extern "C" {

// out[seg[i]] += rows[i] for every row with seg[i] >= 0.
// rows: [t, r] f64; seg: [t] i32; out: [s, r] f64 (caller-zeroed).
void segment_sum_f64(const double* rows, const int32_t* seg,
                     int64_t t, int64_t r, int64_t s, double* out) {
    for (int64_t i = 0; i < t; ++i) {
        int32_t k = seg[i];
        if (k < 0 || k >= s) continue;
        const double* src = rows + i * r;
        double* dst = out + (int64_t)k * r;
        for (int64_t j = 0; j < r; ++j) dst[j] += src[j];
    }
}

// Gather + segment-sum fused: out[seg[i]] += matrix[idx[i]] (skips negatives).
// matrix: [t_total, r]; idx/seg: [n] i32; out: [s, r] f64 (caller-zeroed).
void segment_sum_indexed_f64(const double* matrix, const int32_t* idx,
                             const int32_t* seg, int64_t n, int64_t t_total,
                             int64_t r, int64_t s, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t row = idx[i];
        int32_t k = seg[i];
        if (row < 0 || row >= t_total || k < 0 || k >= s) continue;
        const double* src = matrix + (int64_t)row * r;
        double* dst = out + (int64_t)k * r;
        for (int64_t j = 0; j < r; ++j) dst[j] += src[j];
    }
}

// counts[seg[i]] += 1 for every row with 0 <= seg[i] < s.
void segment_count_i32(const int32_t* seg, int64_t n, int64_t s,
                       int32_t* counts) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t k = seg[i];
        if (k < 0 || k >= s) continue;
        counts[k] += 1;
    }
}

// Decode fused-allocate result codes (ops/fused.py encoding) into parallel
// node-id / pipelined / failed arrays:
//   code >= 0  -> allocated on node `code`
//   code == -1 -> unplaced (node_id -1, neither pipelined nor failed)
//   code == -2 -> fit-failed (failed=1)
//   code <= -3 -> pipelined on node `-3 - code`
// Returns the number of placed rows (allocated + pipelined).
int64_t decode_placement_codes(const int32_t* codes, int64_t t,
                               int32_t* node_id, uint8_t* pipelined,
                               uint8_t* failed) {
    int64_t placed = 0;
    for (int64_t i = 0; i < t; ++i) {
        int32_t c = codes[i];
        if (c >= 0) {
            node_id[i] = c;
            pipelined[i] = 0;
            failed[i] = 0;
            ++placed;
        } else if (c <= -3) {
            node_id[i] = -3 - c;
            pipelined[i] = 1;
            failed[i] = 0;
            ++placed;
        } else {
            node_id[i] = -1;
            pipelined[i] = 0;
            failed[i] = (c == -2) ? 1 : 0;
        }
    }
    return placed;
}

// Run lengths of consecutive identical request rows within one job:
// run[i] = number of rows j >= i with the same (resreq, init_resreq) rows and
// the same job, stopping at job boundaries (ops/fused.py run batching).
// resreq/init_resreq: [t, r] f64; job_idx: [t] i32; run: [t] i32 out.
void run_lengths_i32(const double* resreq, const double* init_resreq,
                     const int32_t* job_idx, int64_t t, int64_t r,
                     int32_t* run) {
    if (t == 0) return;
    run[t - 1] = 1;
    for (int64_t i = t - 2; i >= 0; --i) {
        bool same = job_idx[i] == job_idx[i + 1] &&
                    std::memcmp(resreq + i * r, resreq + (i + 1) * r,
                                sizeof(double) * r) == 0 &&
                    std::memcmp(init_resreq + i * r, init_resreq + (i + 1) * r,
                                sizeof(double) * r) == 0;
        run[i] = same ? run[i + 1] + 1 : 1;
    }
}

// Batched status scatter over MANY job stores: for group k, the rows
// rows[offs[k]..offs[k+1]) of the int16 status column at addrs[k] are set to
// to_vals[k].  With check != 0 a row whose PRIOR value differs from
// from_vals[k] flags its group; the first flagged group index returns
// (-1 = clean) so the caller can raise under PANIC_ON_ERROR.  This is the
// apply phase's ~2000 per-job bulk_update_status_rows calls collapsed into
// one flat pass (the reference's per-task session bookkeeping slot,
// session.go:242-297).
int64_t batch_status_scatter(int64_t n_groups, const uint64_t* addrs,
                             const int64_t* rows, const int64_t* offs,
                             const int16_t* from_vals, const int16_t* to_vals,
                             int32_t check) {
    int64_t bad = -1;
    for (int64_t k = 0; k < n_groups; ++k) {
        int16_t* st = reinterpret_cast<int16_t*>(static_cast<uintptr_t>(addrs[k]));
        const int16_t to = to_vals[k];
        const int16_t from = from_vals[k];
        for (int64_t i = offs[k]; i < offs[k + 1]; ++i) {
            const int64_t r = rows[i];
            if (check && bad < 0 && st[r] != from) bad = k;
            st[r] = to;
        }
    }
    return bad;
}

}  // extern "C"
