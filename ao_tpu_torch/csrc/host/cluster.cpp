// Instance clustering for PointGroup-style proposal generation, on the
// host (a copy of the JAX package's native/cluster.cpp; the reference's
// pointgroup_ops pairs a CUDA ball query with a CPU BFS over same-label
// neighbours). One fused pass: a uniform spatial grid (cell = radius) gives
// the neighbour candidates, and a BFS over same-label points within the
// radius emits connected components. Plain C ABI, loaded through ctypes.
//
// Build (ao_tpu_torch/ops/cluster.py does it at first use, into
// ao_tpu_torch/_build/): g++ -O3 -std=c++17 -fPIC -shared -o libaocluster.so cluster.cpp
#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
    int64_t v;
    bool operator==(const CellKey& o) const { return v == o.v; }
};

struct CellHash {
    size_t operator()(const CellKey& k) const {
        return std::hash<int64_t>()(k.v * 0x9E3779B97F4A7C15ll);
    }
};

inline int64_t cell_of(float x, float y, float z, float inv_cell) {
    // 21 bits per axis with +2^20 offset keeps keys unique for any scene
    // smaller than ~2^20 cells per axis.
    int64_t cx = (int64_t)std::floor(x * inv_cell) + (1 << 20);
    int64_t cy = (int64_t)std::floor(y * inv_cell) + (1 << 20);
    int64_t cz = (int64_t)std::floor(z * inv_cell) + (1 << 20);
    return (cx << 42) | (cy << 21) | cz;
}

}  // namespace

extern "C" {

// Connected components over the radius graph restricted to equal semantic
// labels. Points with label < 0 are never clustered.
//
// coords        (n * 3) float32
// semantic      (n)     int32
// batch         (n)     int32   points cluster only within their batch id
// radius        neighbour radius (the reference's cluster_thresh)
// min_points    drop components smaller than this (cluster_min_points)
// out_labels    (n)     int32   component id per point, -1 = unclustered
// returns       number of components emitted
int32_t ao_bfs_cluster(int32_t n, const float* coords, const int32_t* semantic,
                       const int32_t* batch, float radius, int32_t min_points,
                       int32_t* out_labels) {
    const float inv_cell = 1.0f / radius;
    const float r2 = radius * radius;

    std::unordered_map<CellKey, std::vector<int32_t>, CellHash> grid;
    grid.reserve((size_t)n * 2);
    for (int32_t i = 0; i < n; ++i) {
        if (semantic[i] < 0) continue;
        grid[{cell_of(coords[i * 3], coords[i * 3 + 1], coords[i * 3 + 2],
                      inv_cell)}]
            .push_back(i);
    }

    std::vector<uint8_t> visited(n, 0);
    std::vector<int32_t> component;
    component.reserve(1024);
    for (int32_t i = 0; i < n; ++i) out_labels[i] = -1;

    int32_t n_clusters = 0;
    std::queue<int32_t> q;
    for (int32_t seed = 0; seed < n; ++seed) {
        if (visited[seed] || semantic[seed] < 0) continue;
        component.clear();
        visited[seed] = 1;
        component.push_back(seed);
        q.push(seed);
        const int32_t label = semantic[seed];
        const int32_t b = batch[seed];
        while (!q.empty()) {
            int32_t cur = q.front();
            q.pop();
            const float cx = coords[cur * 3];
            const float cy = coords[cur * 3 + 1];
            const float cz = coords[cur * 3 + 2];
            const int64_t ccx = (int64_t)std::floor(cx * inv_cell);
            const int64_t ccy = (int64_t)std::floor(cy * inv_cell);
            const int64_t ccz = (int64_t)std::floor(cz * inv_cell);
            for (int dx = -1; dx <= 1; ++dx)
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dz = -1; dz <= 1; ++dz) {
                        CellKey key{(((ccx + dx) + (1 << 20)) << 42) |
                                    (((ccy + dy) + (1 << 20)) << 21) |
                                    ((ccz + dz) + (1 << 20))};
                        auto it = grid.find(key);
                        if (it == grid.end()) continue;
                        for (int32_t j : it->second) {
                            if (visited[j] || semantic[j] != label ||
                                batch[j] != b)
                                continue;
                            const float ddx = coords[j * 3] - cx;
                            const float ddy = coords[j * 3 + 1] - cy;
                            const float ddz = coords[j * 3 + 2] - cz;
                            if (ddx * ddx + ddy * ddy + ddz * ddz > r2)
                                continue;
                            visited[j] = 1;
                            component.push_back(j);
                            q.push(j);
                        }
                    }
        }
        if ((int32_t)component.size() >= min_points) {
            for (int32_t idx : component) out_labels[idx] = n_clusters;
            ++n_clusters;
        }
    }
    return n_clusters;
}

}  // extern "C"
