// Native binned-SAH BVH builder with skip-link flattening (host C++).
//
// The port's own copy of mitsuba_tpu/native/bvh_builder.cpp, unchanged
// below this comment: the BVH order fixes every triangle's prim id, so the
// port's tree must equal the JAX package's. Built at first use by
// mitsuba_tpu_torch/ops/build.py with the same flags as the JAX package's
// (c++ -O3 -march=native -shared -fPIC, then without -march=native) and
// called through ctypes from mitsuba_tpu_torch/render/bvh.py.
//
// Output layout matches render/bvh.py's BVH: nodes in DFS preorder,
// inner nodes continue at i+1 on hit, everything resumes at skip[i] on
// miss/leaf-done; leaves reference a contiguous range of the permuted
// triangle order.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BuildNode {
    float bmin[3], bmax[3];
    int32_t left = -1, right = -1;     // children (build indices)
    int64_t start = 0, count = 0;      // leaf range into tri index buffer
};

struct Builder {
    const float* verts;
    const int32_t* faces;
    int64_t n_tris;
    int max_leaf;
    std::vector<float> tmin, tmax, cent;   // per-tri bounds/centroids (3*T)
    std::vector<int64_t> tri_idx;          // permutation being sorted
    std::vector<BuildNode> nodes;

    static constexpr int N_BINS = 16;

    void tri_bounds() {
        tmin.resize(3 * n_tris);
        tmax.resize(3 * n_tris);
        cent.resize(3 * n_tris);
        for (int64_t t = 0; t < n_tris; ++t) {
            for (int a = 0; a < 3; ++a) {
                float lo = FLT_MAX, hi = -FLT_MAX;
                for (int k = 0; k < 3; ++k) {
                    float v = verts[3 * (int64_t)faces[3 * t + k] + a];
                    lo = std::min(lo, v);
                    hi = std::max(hi, v);
                }
                tmin[3 * t + a] = lo;
                tmax[3 * t + a] = hi;
                cent[3 * t + a] = 0.5f * (lo + hi);
            }
        }
    }

    static float area(const float lo[3], const float hi[3]) {
        float d0 = std::max(hi[0] - lo[0], 0.f);
        float d1 = std::max(hi[1] - lo[1], 0.f);
        float d2 = std::max(hi[2] - lo[2], 0.f);
        return d0 * d1 + d1 * d2 + d0 * d2;
    }

    int32_t build_range(int64_t start, int64_t end) {
        int32_t me = (int32_t)nodes.size();
        nodes.emplace_back();
        {
            BuildNode& nd = nodes[me];
            for (int a = 0; a < 3; ++a) { nd.bmin[a] = FLT_MAX; nd.bmax[a] = -FLT_MAX; }
            for (int64_t i = start; i < end; ++i) {
                int64_t t = tri_idx[i];
                for (int a = 0; a < 3; ++a) {
                    nd.bmin[a] = std::min(nd.bmin[a], tmin[3 * t + a]);
                    nd.bmax[a] = std::max(nd.bmax[a], tmax[3 * t + a]);
                }
            }
        }
        int64_t n = end - start;
        if (n <= max_leaf) {
            nodes[me].start = start;
            nodes[me].count = n;
            return me;
        }
        // centroid bounds
        float cmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
        float cmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int64_t i = start; i < end; ++i) {
            int64_t t = tri_idx[i];
            for (int a = 0; a < 3; ++a) {
                cmin[a] = std::min(cmin[a], cent[3 * t + a]);
                cmax[a] = std::max(cmax[a], cent[3 * t + a]);
            }
        }
        float best_cost = FLT_MAX;
        int best_axis = -1, best_split = -1;
        float bin_lo[3], bin_scale[3];
        for (int axis = 0; axis < 3; ++axis) {
            float ext = cmax[axis] - cmin[axis];
            if (ext <= 1e-12f) continue;
            bin_lo[axis] = cmin[axis];
            bin_scale[axis] = N_BINS / ext;
            int64_t counts[N_BINS] = {0};
            float bb_min[N_BINS][3], bb_max[N_BINS][3];
            for (int b = 0; b < N_BINS; ++b)
                for (int a = 0; a < 3; ++a) { bb_min[b][a] = FLT_MAX; bb_max[b][a] = -FLT_MAX; }
            for (int64_t i = start; i < end; ++i) {
                int64_t t = tri_idx[i];
                int b = std::min((int)((cent[3 * t + axis] - cmin[axis]) * bin_scale[axis]), N_BINS - 1);
                counts[b]++;
                for (int a = 0; a < 3; ++a) {
                    bb_min[b][a] = std::min(bb_min[b][a], tmin[3 * t + a]);
                    bb_max[b][a] = std::max(bb_max[b][a], tmax[3 * t + a]);
                }
            }
            // sweep
            float lmin[N_BINS][3], lmax[N_BINS][3];
            int64_t lcnt[N_BINS];
            float cur_min[3] = {FLT_MAX, FLT_MAX, FLT_MAX}, cur_max[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
            int64_t cur = 0;
            for (int b = 0; b < N_BINS; ++b) {
                for (int a = 0; a < 3; ++a) {
                    cur_min[a] = std::min(cur_min[a], bb_min[b][a]);
                    cur_max[a] = std::max(cur_max[a], bb_max[b][a]);
                }
                cur += counts[b];
                std::memcpy(lmin[b], cur_min, sizeof cur_min);
                std::memcpy(lmax[b], cur_max, sizeof cur_max);
                lcnt[b] = cur;
            }
            float rmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX}, rmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
            int64_t rcnt = 0;
            for (int b = N_BINS - 1; b >= 1; --b) {
                for (int a = 0; a < 3; ++a) {
                    rmin[a] = std::min(rmin[a], bb_min[b][a]);
                    rmax[a] = std::max(rmax[a], bb_max[b][a]);
                }
                rcnt += counts[b];
                int64_t nl = lcnt[b - 1];
                if (nl == 0 || rcnt == 0) continue;
                float cost = area(lmin[b - 1], lmax[b - 1]) * nl + area(rmin, rmax) * rcnt;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_split = b;
                }
            }
        }
        int64_t mid;
        if (best_axis < 0) {
            // degenerate: median split on the largest extent
            int axis = 0;
            float best_ext = -1;
            for (int a = 0; a < 3; ++a) {
                float ext = nodes[me].bmax[a] - nodes[me].bmin[a];
                if (ext > best_ext) { best_ext = ext; axis = a; }
            }
            mid = start + n / 2;
            std::nth_element(
                tri_idx.begin() + start, tri_idx.begin() + mid, tri_idx.begin() + end,
                [&](int64_t x, int64_t y) { return cent[3 * x + axis] < cent[3 * y + axis]; });
        } else {
            float lo = cmin[best_axis];
            float scale = N_BINS / (cmax[best_axis] - cmin[best_axis]);
            auto it = std::partition(
                tri_idx.begin() + start, tri_idx.begin() + end, [&](int64_t t) {
                    int b = std::min((int)((cent[3 * t + best_axis] - lo) * scale), N_BINS - 1);
                    return b < best_split;
                });
            mid = it - tri_idx.begin();
            if (mid == start || mid == end) mid = start + n / 2;
        }
        int32_t l = build_range(start, mid);
        int32_t r = build_range(mid, end);
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

}  // namespace

extern "C" int64_t mts_build_bvh(
    const float* vertices, int64_t n_verts, const int32_t* faces, int64_t n_tris,
    int32_t max_leaf,
    float* out_bmin, float* out_bmax, int32_t* out_first, int32_t* out_count,
    int32_t* out_skip, int64_t* out_perm) {
    (void)n_verts;
    if (n_tris <= 0) return 0;
    Builder b;
    b.verts = vertices;
    b.faces = faces;
    b.n_tris = n_tris;
    b.max_leaf = max_leaf;
    b.tri_bounds();
    b.tri_idx.resize(n_tris);
    for (int64_t i = 0; i < n_tris; ++i) b.tri_idx[i] = i;
    b.nodes.reserve(2 * n_tris);
    b.build_range(0, n_tris);

    // flatten DFS preorder with skip links (iterative, matches bvh.py)
    int64_t m = (int64_t)b.nodes.size();
    std::vector<int32_t> order(m), skip_of(m);
    int64_t out_i = 0;
    struct Item { int32_t node; int32_t skip_to; };
    std::vector<Item> stack;
    stack.push_back({0, (int32_t)m});
    std::vector<int32_t> out_index(m);
    // first pass: DFS order + out index
    {
        std::vector<int32_t> st{0};
        while (!st.empty()) {
            int32_t nid = st.back();
            st.pop_back();
            out_index[nid] = (int32_t)out_i;
            order[out_i++] = nid;
            const BuildNode& nd = b.nodes[nid];
            if (nd.left >= 0) {
                st.push_back(nd.right);
                st.push_back(nd.left);
            }
        }
    }
    // second pass: skip targets
    while (!stack.empty()) {
        Item it = stack.back();
        stack.pop_back();
        skip_of[it.node] = it.skip_to;
        const BuildNode& nd = b.nodes[it.node];
        if (nd.left >= 0) {
            stack.push_back({nd.right, it.skip_to});
            stack.push_back({nd.left, out_index[nd.right]});
        }
    }
    // emit
    int64_t perm_pos = 0;
    for (int64_t oi = 0; oi < m; ++oi) {
        const BuildNode& nd = b.nodes[order[oi]];
        for (int a = 0; a < 3; ++a) {
            out_bmin[3 * oi + a] = nd.bmin[a];
            out_bmax[3 * oi + a] = nd.bmax[a];
        }
        out_skip[oi] = skip_of[order[oi]] >= 0 ? skip_of[order[oi]] : (int32_t)m;
        if (nd.left < 0) {
            out_first[oi] = (int32_t)perm_pos;
            out_count[oi] = (int32_t)nd.count;
            for (int64_t i = 0; i < nd.count; ++i)
                out_perm[perm_pos++] = b.tri_idx[nd.start + i];
        } else {
            out_first[oi] = 0;
            out_count[oi] = 0;
        }
    }
    return m;
}
