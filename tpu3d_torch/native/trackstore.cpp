// Native host loops of the track store (tpu3d/native/trackstore.cpp).
//
// The matching stage's track bookkeeping (tpu3d_torch/matching/tracks.py)
// is sequential union-find over a few hundred thousand match events, and
// the engine's observation table takes first-wins inserts: host work that
// cannot batch onto the device. Here the same semantics run as C loops over
// the caller's numpy buffers (zero-copy through ctypes). The Python
// versions stay as the fallback where no compiler exists; the tests hold
// the two equal.
//
// Build: python -m tpu3d_torch.native.build  (g++ -O3 -shared -fPIC)

#include <cstdint>

extern "C" {

// Path-compressing find. parent is the union-find array (capacity,).
static int64_t uf_find(int64_t* parent, int64_t t) {
    int64_t root = t;
    while (parent[root] != root) root = parent[root];
    while (parent[t] != root) {
        int64_t next = parent[t];
        parent[t] = root;
        t = next;
    }
    return root;
}

// Canonicalize ids in place (-1 passes through).
void ts_resolve(int64_t* parent, int64_t* ids, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        if (ids[i] >= 0) ids[i] = uf_find(parent, ids[i]);
    }
}

// union_pair semantics of tpu3d_torch/matching/tracks.py::TrackStore.union_pair:
//   t0/t1 = resolved per-keypoint track ids of the two images;
//   both new  -> fresh sequential ids,
//   one known -> propagate,
//   both known-> union (smaller id wins, keeps its 3D estimate).
// Writes the canonical id per match into out, updates kp_track rows and
// parent, returns the new next_track (or -1 if capacity exceeded).
int64_t ts_union_pair(
    int64_t* parent, int64_t capacity,
    int64_t* kp_track, int64_t kpts_per_image,
    int64_t img0, int64_t img1,
    const int64_t* idx0, const int64_t* idx1, int64_t m,
    int64_t next_track, int64_t* out) {
    int64_t* row0 = kp_track + img0 * kpts_per_image;
    int64_t* row1 = kp_track + img1 * kpts_per_image;
    for (int64_t i = 0; i < m; ++i) {
        int64_t t0 = row0[idx0[i]];
        int64_t t1 = row1[idx1[i]];
        if (t0 >= 0) t0 = uf_find(parent, t0);
        if (t1 >= 0) t1 = uf_find(parent, t1);
        int64_t t;
        if (t0 < 0 && t1 < 0) {
            if (next_track >= capacity) return -1;
            t = next_track++;
        } else if (t1 < 0) {
            t = t0;
        } else if (t0 < 0) {
            t = t1;
        } else if (t0 == t1) {
            t = t0;
        } else {
            int64_t lo = t0 < t1 ? t0 : t1;
            int64_t hi = t0 < t1 ? t1 : t0;
            parent[hi] = lo;
            t = lo;
        }
        out[i] = t;
        row0[idx0[i]] = t;
        row1[idx1[i]] = t;
    }
    return next_track;
}

// First-wins observation insert into the dense (n_images*K) table:
// slot = img*K + kpt. valid: uint8 mask; track: int64; uv: float32 (2,).
// Returns number of newly inserted observations.
int64_t ts_record_obs(
    uint8_t* valid, int64_t* track, float* uv,
    int64_t kpts_per_image, int64_t img,
    const int64_t* idx, const int64_t* tr, const float* uv_in, int64_t m) {
    int64_t inserted = 0;
    int64_t base = img * kpts_per_image;
    for (int64_t i = 0; i < m; ++i) {
        int64_t slot = base + idx[i];
        if (!valid[slot]) {
            valid[slot] = 1;
            track[slot] = tr[i];
            uv[2 * slot] = uv_in[2 * i];
            uv[2 * slot + 1] = uv_in[2 * i + 1];
            ++inserted;
        }
    }
    return inserted;
}

}  // extern "C"
