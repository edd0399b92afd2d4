// Native host-side point-cloud ops for the deflow_tpu_torch data path.
//
// The per-sample hot loop of the host prep — ground filter, crop and pad to
// the static point budget, SE(3) transform, pillar binning, the stable
// counting sort by pillar id, the sorted 9-lane PFN record, row permutes and
// the SSL chamfer cell sort — as plain serial C++.  Loaded with ctypes
// (deflow_tpu_torch/utils/native.py), which builds it at first use; the
// caller runs the samples of a batch in parallel, a thread each (the ctypes
// calls release the GIL), so nothing here starts threads of its own.  Every
// entry matches its numpy version (data/host_prep.py) bit for bit, so it
// must be built with -ffp-contract=off: a fused multiply-add rounds once
// where numpy rounds twice.
//
// `host_prep_sample` is the batch's hot path: one call does a sample's
// whole prep and writes every output row into the batch's arrays.  The
// single-step entries above it compute the same pieces one at a time.
//
// ABI: plain C, float32/bool/int32 buffers, caller-allocated outputs.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// Pillar id conventions (must match data/host_prep.py encode_ids):
// s2d (even grids): id = ((cy>>1)*(W/2) + (cx>>1))*4 + (cy&1)*2 + (cx&1) —
// the flat pillar table then bitcasts to the phase-folded pseudoimage.
// row-major otherwise: id = cy*W + cx.
inline int32_t encode_id(int32_t cx, int32_t cy, const int32_t* grid,
                         int32_t s2d) {
    if (s2d)
        return (((cy >> 1) * (grid[0] >> 1) + (cx >> 1)) << 2)
               + ((cy & 1) << 1) + (cx & 1);
    return cy * grid[0] + cx;
}

inline void decode_id(int32_t id, const int32_t* grid, int32_t s2d,
                      int32_t* cx, int32_t* cy) {
    if (s2d) {
        const int32_t ph = id & 3;
        const int32_t cell = id >> 2;
        *cy = (cell / (grid[0] >> 1)) * 2 + (ph >> 1);
        *cx = (cell % (grid[0] >> 1)) * 2 + (ph & 1);
    } else {
        *cy = id / grid[0];
        *cx = id % grid[0];
    }
}

// `p @ R^T + t` in f64, rounded once to f32; src rows of `stride` floats.
inline void se3_rows(const float* src, int64_t stride, const double* pose,
                     int64_t n, float* dst) {
    const double r00 = pose[0], r01 = pose[1], r02 = pose[2], tx = pose[3];
    const double r10 = pose[4], r11 = pose[5], r12 = pose[6], ty = pose[7];
    const double r20 = pose[8], r21 = pose[9], r22 = pose[10], tz = pose[11];
    for (int64_t i = 0; i < n; ++i) {
        const float* p = src + i * stride;
        const double x = p[0], y = p[1], z = p[2];
        dst[i * 3 + 0] = (float)(r00 * x + r01 * y + r02 * z + tx);
        dst[i * 3 + 1] = (float)(r10 * x + r11 * y + r12 * z + ty);
        dst[i * 3 + 2] = (float)(r20 * x + r21 * y + r22 * z + tz);
    }
}

// Pillar id of one point (f32 floor of (p - vmin) / vsize); a masked point
// or one outside the grid takes the trash id W·H.
inline int32_t bin_id(const float* p, uint8_t ok, const float* vmin,
                      const float* vsize, const int32_t* grid, int32_t s2d,
                      int32_t trash) {
    if (!ok) return trash;
    int32_t c[3];
    for (int a = 0; a < 3; ++a) {
        const float v = std::floor((p[a] - vmin[a]) / vsize[a]);
        // range-check BEFORE the int cast (huge/NaN floats -> UB cast)
        if (!(v >= 0.0f) || !(v < (float)grid[a])) return trash;
        c[a] = (int32_t)v;
    }
    return encode_id(c[0], c[1], grid, s2d);
}

// Stable counting sort of ids in [0, buckets] over `counts[buckets + 2]`,
// zeroed by the caller; emits the ascending-id permutation `order`, its
// inverse `iperm` and the sorted ids in one pass.
template <typename C>
inline void counting_sort(const int32_t* ids, int64_t n, int64_t buckets,
                          C* counts, int32_t* order, int32_t* iperm,
                          int32_t* sorted_ids) {
    for (int64_t i = 0; i < n; ++i) counts[ids[i] + 1]++;
    for (int64_t b = 1; b < buckets + 2; ++b) counts[b] += counts[b - 1];
    for (int64_t i = 0; i < n; ++i) {
        const int64_t pos = counts[ids[i]]++;
        order[pos] = (int32_t)i;
        iperm[i] = (int32_t)pos;
        sorted_ids[pos] = ids[i];
    }
}

// dst[i] = src[order[i]] for rows of RB bytes (a constant-size copy).
template <int64_t RB>
inline void gather_fixed(const char* s, const int32_t* order, int64_t n,
                         char* d) {
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(d + i * RB, s + (int64_t)order[i] * RB, RB);
}

inline void gather(const void* src, const int32_t* order, int64_t n,
                   int64_t row_bytes, void* dst) {
    const char* s = (const char*)src;
    char* d = (char*)dst;
    switch (row_bytes) {
        case 1: return gather_fixed<1>(s, order, n, d);
        case 2: return gather_fixed<2>(s, order, n, d);
        case 4: return gather_fixed<4>(s, order, n, d);
        case 8: return gather_fixed<8>(s, order, n, d);
        case 12: return gather_fixed<12>(s, order, n, d);
        case 16: return gather_fixed<16>(s, order, n, d);
    }
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(d + i * row_bytes, s + (int64_t)order[i] * row_bytes,
                    row_bytes);
}

// Sorted 9-lane per-point record: [xyz | cluster (p - pillar centroid) |
// center-offset (p - pillar center)] in ascending-id order, invalid rows
// zeroed; `at(k)` is the k-th point in sorted order.  Two linear passes
// over the sorted runs.
template <typename At>
inline void record_runs(At at, int64_t n, const float* vmin,
                        const float* vsize, const int32_t* grid, int32_t s2d,
                        const int32_t* sorted_ids, float* rec /* [n, 9] */) {
    const int32_t trash = grid[0] * grid[1];
    int64_t i = 0;
    while (i < n) {
        const int32_t sid = sorted_ids[i];
        if (sid >= trash) {  // trash/padding tail: zero rows
            std::memset(rec + i * 9, 0, sizeof(float) * 9 * (n - i));
            break;
        }
        int64_t j = i;
        double sx = 0.0, sy = 0.0, sz = 0.0;
        while (j < n && sorted_ids[j] == sid) {
            const float* p = at(j);
            sx += p[0]; sy += p[1]; sz += p[2];
            ++j;
        }
        // divided, not multiplied by a reciprocal: as numpy's centroid
        const double cnt = (double)(j - i);
        const float cx = (float)(sx / cnt), cy = (float)(sy / cnt),
                    cz = (float)(sz / cnt);
        int32_t gx, gy;
        decode_id(sid, grid, s2d, &gx, &gy);
        const float ctr_x = ((float)gx + 0.5f) * vsize[0] + vmin[0];
        const float ctr_y = ((float)gy + 0.5f) * vsize[1] + vmin[1];
        for (int64_t k = i; k < j; ++k) {
            const float* p = at(k);
            float zb = std::floor((p[2] - vmin[2]) / vsize[2]);
            if (zb < 0.0f) zb = 0.0f;
            if (zb > (float)(grid[2] - 1)) zb = (float)(grid[2] - 1);
            // the z centre and its offset in f64, rounded once, as the numpy
            // version computes them (x and y stay in f32, as numpy's do)
            const double ctr_z = ((double)zb + 0.5) * (double)vsize[2]
                                 + (double)vmin[2];
            float* r = rec + k * 9;
            r[0] = p[0]; r[1] = p[1]; r[2] = p[2];
            r[3] = p[0] - cx; r[4] = p[1] - cy; r[5] = p[2] - cz;
            r[6] = p[0] - ctr_x; r[7] = p[1] - ctr_y;
            r[8] = (float)((double)p[2] - ctr_z);
        }
        i = j;
    }
}

// The chamfer cell sort of one cloud (see chamfer_cell_prep below); `at(i)`
// is row i's point, `ok(i)` its mask and `flag(i)` its flag; `local[n]` and
// `cnt[kgap + 2]` (zeroed) are the caller's scratch.
template <typename At, typename Ok, typename Flag, typename C>
inline void cell_sort(At at, Ok ok, Flag flag, int64_t n, float cell,
                      const float* lo, int32_t gx, int32_t gy,
                      int32_t* local, C* cnt, float* lanes /* [5, n] */,
                      int32_t* sid, int32_t* start /* [kgap + 1] */) {
    const int32_t kgap = (gy + 1) * gx;
    for (int64_t i = 0; i < n; ++i) {
        int32_t id = kgap;
        if (ok(i)) {
            const float* p = at(i);
            float rx = std::floor((p[0] - lo[0]) / cell);
            float ry = std::floor((p[1] - lo[1]) / cell);
            int32_t cx = rx < 0.0f ? 0 : (rx > (float)(gx - 1) ? gx - 1
                                                               : (int32_t)rx);
            int32_t cy = ry < 0.0f ? 0 : (ry > (float)(gy - 1) ? gy - 1
                                                               : (int32_t)ry);
            id = cy * gx + cx;
        }
        local[i] = id;
        cnt[id + 1]++;
    }
    for (int64_t b = 1; b < (int64_t)kgap + 2; ++b) cnt[b] += cnt[b - 1];
    for (int32_t c = 0; c <= kgap; ++c) start[c] = (int32_t)cnt[c];
    for (int64_t i = 0; i < n; ++i) {
        const int32_t id = local[i];
        const int64_t pos = cnt[id]++;
        const bool m = ok(i);
        const float* p = at(i);
        lanes[0 * n + pos] = m ? p[0] : 0.0f;
        lanes[1 * n + pos] = m ? p[1] : 0.0f;
        lanes[2 * n + pos] = m ? p[2] : 0.0f;
        lanes[3 * n + pos] = flag(i) ? 1.0f : 0.0f;
        lanes[4 * n + pos] = (float)i;
        sid[pos] = id;
    }
}

// A sample's scratch, reused by every call on its thread and grown to the
// largest cloud and grid seen: unsorted pillar ids (then the cell sort's
// ids), the sort's order and buckets, pc0 transformed in its original
// order, the cell sort's buckets.
struct Scratch {
    std::vector<int32_t> pid, order, counts, cell_counts;
    std::vector<float> tpc0;
};

template <typename T>
inline T* sized(std::vector<T>& v, int64_t n) {
    if ((int64_t)v.size() < n) v.resize(n);
    return v.data();
}

}  // namespace

extern "C" {

// Fused select+pad: keep points where !ground (if ground given), write the
// first `max_points` kept points into out_pts [max_points,3] (zero-padded),
// out_mask [max_points].  Optional per-point payloads (flow [n,3], labels
// [n]) are gathered with the same selection into out_flow/out_labels.
// Returns the number of kept (pre-crop) points.
int64_t select_pad(const float* pts, const uint8_t* ground, int64_t n,
                   int64_t max_points,
                   const float* flow, const int32_t* labels,
                   const uint8_t* valid,
                   float* out_pts, uint8_t* out_mask,
                   float* out_flow, int32_t* out_labels,
                   uint8_t* out_valid) {
    std::memset(out_pts, 0, sizeof(float) * max_points * 3);
    std::memset(out_mask, 0, max_points);
    if (out_flow) std::memset(out_flow, 0, sizeof(float) * max_points * 3);
    if (out_labels) std::memset(out_labels, 0, sizeof(int32_t) * max_points);
    if (out_valid) std::memset(out_valid, 0, max_points);

    int64_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (ground && ground[i]) continue;
        if (k < max_points) {
            out_pts[k * 3 + 0] = pts[i * 3 + 0];
            out_pts[k * 3 + 1] = pts[i * 3 + 1];
            out_pts[k * 3 + 2] = pts[i * 3 + 2];
            out_mask[k] = 1;
            if (out_flow && flow) {
                out_flow[k * 3 + 0] = flow[i * 3 + 0];
                out_flow[k * 3 + 1] = flow[i * 3 + 1];
                out_flow[k * 3 + 2] = flow[i * 3 + 2];
            }
            if (out_labels && labels) out_labels[k] = labels[i];
            if (out_valid && valid) out_valid[k] = valid[i];
        }
        ++k;
    }
    return k;
}

// Apply a 4x4 row-major SE(3) to n points in place-safe fashion (dst may
// equal src).
void se3_transform(const float* src, const double* pose, int64_t n,
                   float* dst) {
    se3_rows(src, 3, pose, n, dst);
}

// Batched collate: gather B sample buffers (pointers) into one contiguous
// [B, max_points, 3] batch + masks.
void collate_points(const float* const* sample_pts,
                    const uint8_t* const* sample_masks,
                    int64_t b, int64_t max_points,
                    float* out_pts, uint8_t* out_masks) {
    for (int64_t s = 0; s < b; ++s) {
        std::memcpy(out_pts + s * max_points * 3, sample_pts[s],
                    sizeof(float) * max_points * 3);
        std::memcpy(out_masks + s * max_points, sample_masks[s], max_points);
    }
}

// Pillar-coordinate binning on the host (preprocessing and statistics).
// Matches ops/voxel.py semantics: floor in f32, valid iff inside the grid on
// all axes.
void bin_points(const float* pts, int64_t n,
                const float* vmin, const float* vsize,
                const int32_t* grid, int32_t* out_coords, uint8_t* out_valid) {
    for (int64_t i = 0; i < n; ++i) {
        uint8_t ok = 1;
        for (int a = 0; a < 3; ++a) {
            const float c = std::floor((pts[i * 3 + a] - vmin[a]) / vsize[a]);
            const int32_t ci = (int32_t)c;
            out_coords[i * 3 + a] = ci;
            if (c < 0.0f || ci >= grid[a]) ok = 0;
        }
        out_valid[i] = ok;
    }
}

// Stable counting sort of pillar ids (ids in [0, num_buckets]); emits the
// ascending-id permutation `order` AND its inverse `iperm` in one pass, so
// the device runs no sort.
void sort_by_id(const int32_t* ids, int64_t n, int64_t num_buckets,
                int32_t* order, int32_t* iperm, int32_t* sorted_ids) {
    std::vector<int64_t> counts(num_buckets + 2, 0);
    counting_sort(ids, n, num_buckets, counts.data(), order, iperm,
                  sorted_ids);
}

// Fused host-side pillar prep for one padded cloud: bin (f32, matching the
// device semantics bit-for-bit is NOT required — these ids ARE the source of
// truth, the device consumes them), route invalid/padding to the trash id,
// then stable-sort.  pts [n,3] (padded slots arbitrary), mask [n].
void pillar_prep(const float* pts, const uint8_t* mask, int64_t n,
                 const float* vmin, const float* vsize, const int32_t* grid,
                 int32_t s2d,
                 int32_t* pillar_id, int32_t* order, int32_t* iperm,
                 int32_t* sorted_ids) {
    const int32_t trash = grid[0] * grid[1];
    for (int64_t i = 0; i < n; ++i)
        pillar_id[i] = bin_id(pts + i * 3, mask[i], vmin, vsize, grid, s2d,
                              trash);
    sort_by_id(pillar_id, n, trash, order, iperm, sorted_ids);
}

// Row gather: dst[i] = src[order[i]] for [n, k] elem-size-`esize` rows.
// numpy fancy indexing holds the GIL, this releases it (ctypes).
void gather_rows(const void* src, const int32_t* order, int64_t n,
                 int64_t row_bytes, void* dst) {
    gather(src, order, n, row_bytes, dst);
}

// Sorted 9-lane per-point record from the unsorted points and the sort's
// order and ascending ids.  The centroid is a pure function of the points
// (no gradient), so computing it here removes the device's centroid
// scatter+gather pass entirely.
void sorted_record(const float* pts, int64_t n,
                   const float* vmin, const float* vsize, const int32_t* grid,
                   int32_t s2d,
                   const int32_t* order, const int32_t* sorted_ids,
                   float* rec /* [n, 9] */) {
    record_runs([&](int64_t k) { return pts + (int64_t)order[k] * 3; },
                n, vmin, vsize, grid, s2d, sorted_ids, rec);
}

// SSL chamfer cell prep (host pc1 pre-sort for the cell-sweep kernel;
// matches data/host_prep.py chamfer_cell_prep): bin XY into
// cell-meter cells (clipped f32 floor-divide, matching chamfer._bin2d),
// stable counting sort by local cell id (masked rows -> the per-sample
// sentinel kgap = (gy+1)*gx), and emit the slab lanes [5, n] (sorted x, y,
// z, flag, original-row; masked coords zeroed), sorted local ids [n], and
// the per-cell start table [kgap+1] — all in two linear passes.
void chamfer_cell_prep(const float* pts, const uint8_t* mask,
                       const uint8_t* flag, int64_t n,
                       float cell, const float* lo,
                       int32_t gx, int32_t gy,
                       float* lanes /* [5, n] */, int32_t* sid,
                       int32_t* start /* [(gy+1)*gx + 1] */) {
    std::vector<int32_t> local(n);
    std::vector<int64_t> cnt((gy + 1) * gx + 2, 0);
    cell_sort([&](int64_t i) { return pts + i * 3; },
              [&](int64_t i) { return mask[i] != 0; },
              [&](int64_t i) { return flag[i] != 0; },
              n, cell, lo, gx, gy, local.data(), cnt.data(), lanes, sid,
              start);
}

// One batch of the fused host prep: every array is C-ordered with the
// samples on its first axis and `n` slots a cloud.  Cloud c's aligned keys
// (the per-point arrays that ride its point order) are copied from
// key_src[c][j] into key_dst[c][j], rows of key_row_bytes[c][j] bytes; key
// 0 of cloud 1 is pc1 itself (rows of pc_cols[1] floats), whose sorted rows
// feed pc1's record and the cell sort.  cell_lanes null: no cell sort.
struct PrepBatch {
    int64_t n;
    const float* pc[2];            // [B, n, pc_cols] f32
    int64_t pc_cols[2];
    const uint8_t* mask[2];        // [B, n] 0/1
    const double* ego;             // [B, 4, 4] pc0 -> pc1's frame
    float vmin[3];
    float vsize[3];
    int32_t grid[3];
    int32_t s2d;
    float* transformed;            // [B, n, 3] pc0_transformed
    int32_t* ids[2];               // [B, n] pc{0,1}_ids
    int32_t* sorted[2];            // [B, n] pc{0,1}_sorted
    int32_t* unsort[2];            // [B, n] pc{0,1}_unsort
    float* rec[2];                 // [B, n, 9] pc{0,1}_sorted_rec
    int32_t n_keys[2];
    const char* const* key_src[2];
    char* const* key_dst[2];
    const int64_t* key_row_bytes[2];
    const uint8_t* cell_flag;      // [B, n] pc1's chamfer flag, 0/1
    float cell;
    float cell_lo[2];
    int32_t cell_gx, cell_gy;
    float* cell_lanes;             // [B, 5, n]
    int32_t* cell_sid;             // [B, n]
    int32_t* cell_start;           // [B, kgap + 1]
};

// Sample i of the batch: ego-compensate pc0, then for each cloud bin, sort
// stably by pillar id, copy each aligned key's rows in that order into its
// output, and write the record from the sorted points; for SSL batches the
// cell sort of pc1's sorted rows.  The same bytes as pillar_prep,
// sort_by_id, gather_rows, sorted_record and chamfer_cell_prep called in
// turn.
void host_prep_sample(const PrepBatch* b, int64_t i) {
    thread_local Scratch s;
    const int64_t n = b->n;
    const int32_t trash = b->grid[0] * b->grid[1];
    int32_t* pid = sized(s.pid, n);
    int32_t* order = sized(s.order, n);
    int32_t* counts = sized(s.counts, (int64_t)trash + 2);
    float* tpc0 = sized(s.tpc0, 3 * n);
    float* transformed = b->transformed + i * n * 3;
    se3_rows(b->pc[0] + i * n * b->pc_cols[0], b->pc_cols[0], b->ego + i * 16,
             n, tpc0);
    for (int c = 0; c < 2; ++c) {
        const float* pts = c ? b->pc[1] + i * n * b->pc_cols[1] : tpc0;
        const int64_t stride = c ? b->pc_cols[1] : 3;
        const uint8_t* mask = b->mask[c] + i * n;
        for (int64_t k = 0; k < n; ++k)
            pid[k] = bin_id(pts + k * stride, mask[k], b->vmin, b->vsize,
                            b->grid, b->s2d, trash);
        std::fill(counts, counts + (int64_t)trash + 2, 0);
        int32_t* sorted = b->sorted[c] + i * n;
        counting_sort(pid, n, trash, counts, order, b->unsort[c] + i * n,
                      sorted);
        std::memcpy(b->ids[c] + i * n, sorted, sizeof(int32_t) * n);
        for (int32_t j = 0; j < b->n_keys[c]; ++j) {
            const int64_t rb = b->key_row_bytes[c][j];
            gather(b->key_src[c][j] + i * n * rb, order, n, rb,
                   b->key_dst[c][j] + i * n * rb);
        }
        const float* sp;
        if (c == 0) {
            gather(tpc0, order, n, 3 * sizeof(float), transformed);
            sp = transformed;
        } else {
            sp = (const float*)b->key_dst[1][0] + i * n * stride;
        }
        record_runs([&](int64_t k) { return sp + k * stride; }, n, b->vmin,
                    b->vsize, b->grid, b->s2d, sorted, b->rec[c] + i * n * 9);
        if (c == 1 && b->cell_lanes) {
            const int32_t kgap = (b->cell_gy + 1) * b->cell_gx;
            int32_t* cc = sized(s.cell_counts, (int64_t)kgap + 2);
            std::fill(cc, cc + (int64_t)kgap + 2, 0);
            const uint8_t* flag = b->cell_flag + i * n;
            cell_sort([&](int64_t k) { return sp + k * stride; },
                      [&](int64_t k) { return mask[order[k]] != 0; },
                      [&](int64_t k) { return flag[order[k]] != 0; },
                      n, b->cell, b->cell_lo, b->cell_gx, b->cell_gy,
                      pid, cc, b->cell_lanes + i * 5 * n,
                      b->cell_sid + i * n, b->cell_start + i * (kgap + 1));
        }
    }
}

}  // extern "C"
