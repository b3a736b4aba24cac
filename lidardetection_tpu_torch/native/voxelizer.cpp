// Host-side hard voxelizer of lidardetection_tpu_torch (ops/voxelize.py).
//
// A copy of the voxelize_f32 part of lidardetection_tpu/native/voxelizer.cpp
// (the rotated BEV IoU of that file is rotated_iou.cpp here):
//
//   voxelize_f32     — hard voxelization with first-come voxel/point order,
//                      semantics identical to ops/voxelize.py::voxelize_np
//                      (itself mirroring spconv's VoxelGenerator as called
//                      from pcdet/datasets/processor/data_processor.py:48-81).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (native/__init__.py does it).
// Python binding: ctypes (see native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// Open-addressing hash map: int64 voxel key -> int32 slot.
struct KeySlotMap {
    std::vector<int64_t> keys;
    std::vector<int32_t> slots;
    uint64_t mask;

    explicit KeySlotMap(int64_t expect) {
        uint64_t cap = 64;
        while (cap < static_cast<uint64_t>(expect) * 4) cap <<= 1;
        keys.assign(cap, -1);
        slots.assign(cap, -1);
        mask = cap - 1;
    }

    // Returns slot if present, else -1; `pos` receives the probe position
    // for a subsequent insert.
    int32_t find(int64_t key, uint64_t* pos) const {
        uint64_t h = static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull;
        uint64_t i = h & mask;
        while (true) {
            if (keys[i] == key) { *pos = i; return slots[i]; }
            if (keys[i] == -1) { *pos = i; return -1; }
            i = (i + 1) & mask;
        }
    }

    void insert_at(uint64_t pos, int64_t key, int32_t slot) {
        keys[pos] = key;
        slots[pos] = slot;
    }
};

}  // namespace

extern "C" {

// points: (n, c) row-major float32, c >= 3 (x, y, z, ...).
// pc_range: 6 floats (x0 y0 z0 x1 y1 z1); voxel_size: 3 floats.
// Outputs (caller-allocated):
//   voxels     (max_voxels, max_points, c) — fully zero-filled here
//   coords     (max_voxels, 3) int32, (z, y, x), padded -1
//   num_points (max_voxels,) int32
// Returns number of voxels produced.
//
// `sort_rows != 0` permutes the voxel rows into ascending linear-key order
// ((z*gy + y)*gx + x) before returning — the framework-wide "sorted voxel
// table" contract that lets device scatter kernels use contiguous tile
// ranges (searchsorted starts). Voxel membership and per-voxel point order
// (first-come) are unaffected; only row order changes.
int32_t voxelize_f32(const float* points, int64_t n, int32_t c,
                     const float* pc_range, const float* voxel_size,
                     int32_t max_points, int32_t max_voxels,
                     int32_t sort_rows,
                     float* voxels, int32_t* coords, int32_t* num_points) {
    // grid = round((hi - lo) / vs) in float64, matching
    // voxelize.grid_size_from_range / data_processor.py:62-64.
    int64_t grid[3];
    for (int k = 0; k < 3; ++k) {
        double g = (static_cast<double>(pc_range[3 + k]) - pc_range[k]) /
                   static_cast<double>(voxel_size[k]);
        grid[k] = static_cast<int64_t>(std::llround(g));
    }
    const int64_t gx = grid[0], gy = grid[1];

    std::memset(voxels, 0,
                sizeof(float) * static_cast<size_t>(max_voxels) * max_points * c);
    std::memset(num_points, 0, sizeof(int32_t) * max_voxels);
    for (int64_t i = 0; i < static_cast<int64_t>(max_voxels) * 3; ++i)
        coords[i] = -1;

    KeySlotMap map(max_voxels);
    int32_t n_vox = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * c;
        int64_t cx[3];
        bool in_range = true;
        for (int k = 0; k < 3; ++k) {
            // float32 intermediate to match numpy float32 arithmetic exactly
            float f = (p[k] - pc_range[k]) / voxel_size[k];
            cx[k] = static_cast<int64_t>(std::floor(f));
            if (cx[k] < 0 || cx[k] >= grid[k]) { in_range = false; break; }
        }
        if (!in_range) continue;
        int64_t key = (cx[2] * gy + cx[1]) * gx + cx[0];
        uint64_t pos;
        int32_t slot = map.find(key, &pos);
        if (slot < 0) {
            if (n_vox >= max_voxels) continue;
            slot = n_vox++;
            map.insert_at(pos, key, slot);
            coords[slot * 3 + 0] = static_cast<int32_t>(cx[2]);
            coords[slot * 3 + 1] = static_cast<int32_t>(cx[1]);
            coords[slot * 3 + 2] = static_cast<int32_t>(cx[0]);
        }
        int32_t cnt = num_points[slot];
        if (cnt < max_points) {
            std::memcpy(voxels + (static_cast<int64_t>(slot) * max_points + cnt) * c,
                        p, sizeof(float) * c);
            num_points[slot] = cnt + 1;
        }
    }

    if (sort_rows && n_vox > 1) {
        std::vector<std::pair<int64_t, int32_t>> order(n_vox);
        for (int32_t s = 0; s < n_vox; ++s) {
            const int64_t key = (static_cast<int64_t>(coords[s * 3 + 0]) * gy
                                 + coords[s * 3 + 1]) * gx + coords[s * 3 + 2];
            order[s] = {key, s};
        }
        std::sort(order.begin(), order.end());
        const int64_t row_f = static_cast<int64_t>(max_points) * c;
        std::vector<float> vox_tmp(static_cast<size_t>(n_vox) * row_f);
        std::vector<int32_t> crd_tmp(static_cast<size_t>(n_vox) * 3);
        std::vector<int32_t> cnt_tmp(n_vox);
        for (int32_t d = 0; d < n_vox; ++d) {
            const int32_t s = order[d].second;
            std::memcpy(&vox_tmp[static_cast<size_t>(d) * row_f],
                        voxels + static_cast<int64_t>(s) * row_f,
                        sizeof(float) * row_f);
            std::memcpy(&crd_tmp[static_cast<size_t>(d) * 3], coords + s * 3,
                        sizeof(int32_t) * 3);
            cnt_tmp[d] = num_points[s];
        }
        std::memcpy(voxels, vox_tmp.data(), sizeof(float) * vox_tmp.size());
        std::memcpy(coords, crd_tmp.data(), sizeof(int32_t) * crd_tmp.size());
        std::memcpy(num_points, cnt_tmp.data(), sizeof(int32_t) * n_vox);
    }
    return n_vox;
}

}  // extern "C"
