// Native kd-tree builder for simd_raytracer.
//
// Same topology as the reference build (see
// reference: include/raytracer/render/accel/kd_tree_simd.hpp:146-185
// for the behavior being reproduced — this is a fresh implementation):
// midpoint split cycling axis = depth % 3 with degenerate-axis skip,
// triangles overlapping both half-boxes duplicated into both children,
// leaf when depth == max_depth or count <= max_leaf.
//
// Output layout is the flattened-array form consumed by the JAX wavefront
// traversal (simd_raytracer/accel/traverse.py) and is bit-identical to
// the NumPy builder in accel/build.py (preorder node ids, same float32
// arithmetic, leaf rows padded with -1 to a multiple-of-8 cap).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Node {
    float bmin[3];
    float bmax[3];
    int32_t child0 = -1;
    int32_t child1 = -1;
    int32_t leaf_id = -1;
};

struct Tree {
    std::vector<Node> nodes;
    std::vector<std::vector<int32_t>> leaves;
    int32_t cap = 8;
};

struct Builder {
    const float* tri_min;  // (T, 3)
    const float* tri_max;  // (T, 3)
    int max_depth;
    int max_leaf;
    Tree* tree;

    int32_t add_node(const float bmin[3], const float bmax[3]) {
        Node n;
        std::memcpy(n.bmin, bmin, sizeof n.bmin);
        std::memcpy(n.bmax, bmax, sizeof n.bmax);
        tree->nodes.push_back(n);
        return static_cast<int32_t>(tree->nodes.size()) - 1;
    }

    // Midpoint split with degenerate-axis skip (matching
    // accel/build.py::_split_box).  Returns the axis used or -1.
    static int pick_axis(const float bmin[3], const float bmax[3],
                         int axis, float* mid) {
        for (int k = 0; k < 3; ++k) {
            int ax = (axis + k) % 3;
            if (bmax[ax] - bmin[ax] > 0.0f) {
                *mid = 0.5f * (bmin[ax] + bmax[ax]);
                return ax;
            }
        }
        return -1;
    }

    int32_t rec(std::vector<int32_t>& ids, const float bmin[3],
                const float bmax[3], int depth) {
        int32_t me = add_node(bmin, bmax);
        float mid = 0.0f;
        int ax = -1;
        if (depth < max_depth &&
            ids.size() > static_cast<size_t>(max_leaf)) {
            ax = pick_axis(bmin, bmax, depth % 3, &mid);
        }
        if (ax < 0) {
            tree->nodes[me].leaf_id =
                static_cast<int32_t>(tree->leaves.size());
            tree->leaves.push_back(std::move(ids));
            return me;
        }
        std::vector<int32_t> ids0, ids1;
        ids0.reserve(ids.size());
        ids1.reserve(ids.size());
        for (int32_t t : ids) {
            // Inclusive overlap: a triangle touching the split plane goes
            // to both children (duplication).
            if (tri_min[3 * t + ax] <= mid) ids0.push_back(t);
            if (tri_max[3 * t + ax] >= mid) ids1.push_back(t);
        }
        ids.clear();
        ids.shrink_to_fit();
        float b0_max[3], b1_min[3];
        std::memcpy(b0_max, bmax, sizeof b0_max);
        std::memcpy(b1_min, bmin, sizeof b1_min);
        b0_max[ax] = mid;
        b1_min[ax] = mid;
        int32_t c0 = rec(ids0, bmin, b0_max, depth + 1);
        int32_t c1 = rec(ids1, b1_min, bmax, depth + 1);
        tree->nodes[me].child0 = c0;
        tree->nodes[me].child1 = c1;
        return me;
    }
};

}  // namespace

extern "C" {

void* srt_kdtree_build(const float* tri_min, const float* tri_max,
                       const int32_t* ids, int32_t n_ids,
                       int32_t max_depth, int32_t max_leaf) {
    auto* tree = new Tree();
    float root_min[3] = {0, 0, 0};
    float root_max[3] = {0, 0, 0};
    if (n_ids > 0) {
        for (int a = 0; a < 3; ++a) {
            root_min[a] = tri_min[3 * ids[0] + a];
            root_max[a] = tri_max[3 * ids[0] + a];
        }
        for (int32_t i = 1; i < n_ids; ++i) {
            for (int a = 0; a < 3; ++a) {
                root_min[a] = std::min(root_min[a], tri_min[3 * ids[i] + a]);
                root_max[a] = std::max(root_max[a], tri_max[3 * ids[i] + a]);
            }
        }
    }
    std::vector<int32_t> all(ids, ids + n_ids);
    Builder b{tri_min, tri_max, max_depth, max_leaf, tree};
    b.rec(all, root_min, root_max, 0);

    size_t max_len = 1;
    for (const auto& l : tree->leaves) max_len = std::max(max_len, l.size());
    tree->cap = static_cast<int32_t>(
        std::max<size_t>(8, (max_len + 7) / 8 * 8));
    return tree;
}

void srt_kdtree_counts(void* handle, int32_t* n_nodes, int32_t* n_leaves,
                       int32_t* cap) {
    auto* tree = static_cast<Tree*>(handle);
    *n_nodes = static_cast<int32_t>(tree->nodes.size());
    *n_leaves = static_cast<int32_t>(tree->leaves.size());
    *cap = tree->cap;
}

void srt_kdtree_export(void* handle, float* node_min, float* node_max,
                       int32_t* child0, int32_t* child1, int32_t* leaf_id,
                       int32_t* leaf_tris) {
    auto* tree = static_cast<Tree*>(handle);
    const size_t nn = tree->nodes.size();
    for (size_t i = 0; i < nn; ++i) {
        const Node& n = tree->nodes[i];
        std::memcpy(node_min + 3 * i, n.bmin, sizeof n.bmin);
        std::memcpy(node_max + 3 * i, n.bmax, sizeof n.bmax);
        child0[i] = n.child0;
        child1[i] = n.child1;
        leaf_id[i] = n.leaf_id;
    }
    const size_t nl = std::max<size_t>(1, tree->leaves.size());
    const size_t cap = static_cast<size_t>(tree->cap);
    std::fill(leaf_tris, leaf_tris + nl * cap, -1);
    for (size_t i = 0; i < tree->leaves.size(); ++i) {
        const auto& l = tree->leaves[i];
        std::copy(l.begin(), l.end(), leaf_tris + i * cap);
    }
}

void srt_kdtree_free(void* handle) { delete static_cast<Tree*>(handle); }

}  // extern "C"
