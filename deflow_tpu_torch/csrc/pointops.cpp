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
// ABI: plain C, float32/bool/int32 buffers, caller-allocated outputs.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

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
    const double r00 = pose[0], r01 = pose[1], r02 = pose[2], tx = pose[3];
    const double r10 = pose[4], r11 = pose[5], r12 = pose[6], ty = pose[7];
    const double r20 = pose[8], r21 = pose[9], r22 = pose[10], tz = pose[11];
    for (int64_t i = 0; i < n; ++i) {
        const double x = src[i * 3 + 0], y = src[i * 3 + 1], z = src[i * 3 + 2];
        dst[i * 3 + 0] = (float)(r00 * x + r01 * y + r02 * z + tx);
        dst[i * 3 + 1] = (float)(r10 * x + r11 * y + r12 * z + ty);
        dst[i * 3 + 2] = (float)(r20 * x + r21 * y + r22 * z + tz);
    }
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
    for (int64_t i = 0; i < n; ++i) counts[ids[i] + 1]++;
    for (int64_t b = 1; b < (int64_t)counts.size(); ++b)
        counts[b] += counts[b - 1];
    for (int64_t i = 0; i < n; ++i) {
        const int64_t pos = counts[ids[i]]++;
        order[pos] = (int32_t)i;
        iperm[i] = (int32_t)pos;
        sorted_ids[pos] = ids[i];
    }
}

// Pillar id conventions (must match data/host_prep.py encode_ids):
// s2d (even grids): id = ((cy>>1)*(W/2) + (cx>>1))*4 + (cy&1)*2 + (cx&1) —
// the flat pillar table then bitcasts to the phase-folded pseudoimage.
// row-major otherwise: id = cy*W + cx.
static inline int32_t encode_id(int32_t cx, int32_t cy, const int32_t* grid,
                                int32_t s2d) {
    if (s2d)
        return (((cy >> 1) * (grid[0] >> 1) + (cx >> 1)) << 2)
               + ((cy & 1) << 1) + (cx & 1);
    return cy * grid[0] + cx;
}

static inline void decode_id(int32_t id, const int32_t* grid, int32_t s2d,
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

// Fused host-side pillar prep for one padded cloud: bin (f32, matching the
// device semantics bit-for-bit is NOT required — these ids ARE the source of
// truth, the device consumes them), route invalid/padding to the trash id,
// then stable-sort.  pts [n,3] (padded slots arbitrary), mask [n].
void pillar_prep(const float* pts, const uint8_t* mask, int64_t n,
                 const float* vmin, const float* vsize, const int32_t* grid,
                 int32_t s2d,
                 int32_t* pillar_id, int32_t* order, int32_t* iperm,
                 int32_t* sorted_ids) {
    const int64_t trash = (int64_t)grid[0] * grid[1];
    for (int64_t i = 0; i < n; ++i) {
        int32_t c[3] = {0, 0, 0};
        uint8_t ok = mask[i];
        for (int a = 0; a < 3; ++a) {
            const float v = std::floor((pts[i * 3 + a] - vmin[a]) / vsize[a]);
            // range-check BEFORE the int cast (huge/NaN floats -> UB cast)
            if (!(v >= 0.0f) || !(v < (float)grid[a])) { ok = 0; break; }
            c[a] = (int32_t)v;
        }
        pillar_id[i] = ok ? encode_id(c[0], c[1], grid, s2d) : (int32_t)trash;
    }
    sort_by_id(pillar_id, n, trash, order, iperm, sorted_ids);
}

// Row gather: dst[i] = src[order[i]] for [n, k] elem-size-`esize` rows.
// The sorted data pipeline permutes ~10 arrays per sample; numpy fancy
// indexing holds the GIL, this releases it (ctypes).
void gather_rows(const void* src, const int32_t* order, int64_t n,
                 int64_t row_bytes, void* dst) {
    const char* s = (const char*)src;
    char* d = (char*)dst;
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(d + i * row_bytes, s + (int64_t)order[i] * row_bytes,
                    row_bytes);
}

// Sorted 9-lane per-point record: [xyz | cluster (p - pillar centroid) |
// center-offset (p - pillar center)] in ascending-id order, invalid rows
// zeroed.  The centroid is a pure function of the points (no gradient), so
// computing it here removes the device's centroid scatter+gather pass
// entirely.  Two linear passes over the sorted runs.
void sorted_record(const float* pts, int64_t n,
                   const float* vmin, const float* vsize, const int32_t* grid,
                   int32_t s2d,
                   const int32_t* order, const int32_t* sorted_ids,
                   float* rec /* [n, 9] */) {
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
            const float* p = pts + (int64_t)order[j] * 3;
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
            const float* p = pts + (int64_t)order[k] * 3;
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
    const int32_t kgap = (gy + 1) * gx;
    std::vector<int32_t> local(n);
    std::vector<int64_t> cnt(kgap + 2, 0);
    for (int64_t i = 0; i < n; ++i) {
        int32_t id = kgap;
        if (mask[i]) {
            float rx = std::floor((pts[i * 3 + 0] - lo[0]) / cell);
            float ry = std::floor((pts[i * 3 + 1] - lo[1]) / cell);
            int32_t cx = rx < 0.0f ? 0 : (rx > (float)(gx - 1) ? gx - 1
                                                               : (int32_t)rx);
            int32_t cy = ry < 0.0f ? 0 : (ry > (float)(gy - 1) ? gy - 1
                                                               : (int32_t)ry);
            id = cy * gx + cx;
        }
        local[i] = id;
        cnt[id + 1]++;
    }
    for (int64_t b = 1; b < (int64_t)cnt.size(); ++b) cnt[b] += cnt[b - 1];
    for (int32_t c = 0; c <= kgap; ++c) start[c] = (int32_t)cnt[c];
    for (int64_t i = 0; i < n; ++i) {
        const int32_t id = local[i];
        const int64_t pos = cnt[id]++;
        const uint8_t ok = mask[i];
        lanes[0 * n + pos] = ok ? pts[i * 3 + 0] : 0.0f;
        lanes[1 * n + pos] = ok ? pts[i * 3 + 1] : 0.0f;
        lanes[2 * n + pos] = ok ? pts[i * 3 + 2] : 0.0f;
        lanes[3 * n + pos] = flag[i] ? 1.0f : 0.0f;
        lanes[4 * n + pos] = (float)i;
        sid[pos] = id;
    }
}

}  // extern "C"
