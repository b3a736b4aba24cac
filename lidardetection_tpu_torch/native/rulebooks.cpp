// Host-side sparse-conv rulebook builder of lidardetection_tpu_torch
// (ops/sparse_plan.py): a copy of lidardetection_tpu/native/rulebooks.cpp.
//
// The card runs sparse 3D convs as gather-GEMMs over rulebooks (kernel K3,
// csrc/sparse_conv.cu): integer tables mapping each (output voxel, kernel
// offset) to an input voxel row. The tables depend only on voxel
// coordinates and the static backbone topology, so they are built on the
// host per scan and shipped with the batch (the reference builds them
// on-GPU inside spconv, pcdet/models/backbones_3d/spconv_backbone.py:84-106,
// via indice_key caching).
//
// Semantics mirror ops/sparse.py exactly:
//   * tables are fixed-capacity, rows sorted ascending by linear key
//     ((z*H + y)*W + x), -1-padded at the tail;
//   * a rulebook is (cap_out, K) int32; miss/padding = cap_in (the input
//     table capacity), so every column is monotone among hits;
//   * strided output coords enumerate candidate parents per input voxel
//     and sort+unique to the stage capacity
//     (ops/sparse.py::build_strided_out_coords);
//   * inverse convs reuse the coords saved before the paired downsample
//     with the rulebook roles swapped: the transposed rulebook of a strided
//     conv, whose offset index k is the forward's.
//
// Plan encoding (one int32[16] record per op, see ops/sparse_plan.py):
//   [0] type: 0 = subm, 1 = down (strided), 2 = inverse, 3 = rewind
//   [1..3] kernel (kz, ky, kx)
//   [4..6] stride (sz, sy, sx)
//   [7..9] padding (pz, py, px)
//   [10] out capacity (down: table capacity; subm/inv: ignored)
//   [11] match index (inv: index of the down op whose INPUT table is the
//        output set; rewind: down op whose OUTPUT table becomes the
//        current stage, emitting nothing; -1 otherwise)
//   [12..15] reserved
//
// Output buffer layout (caller-allocated, per scan):
//   rulebooks: concatenated int32 blocks, one per op, cap_out(op) * K(op)
//   coords:    concatenated int32 blocks, one per DOWN op, cap_out * 3
//   nums:      int32, one per DOWN op

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct HashMap {
    std::vector<int64_t> keys;
    std::vector<int32_t> rows;
    uint64_t mask;

    explicit HashMap(int64_t expect) {
        uint64_t cap = 64;
        while (cap < static_cast<uint64_t>(expect) * 4) cap <<= 1;
        keys.assign(cap, -1);
        rows.assign(cap, -1);
        mask = cap - 1;
    }

    void insert(int64_t key, int32_t row) {
        uint64_t i = (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull) & mask;
        while (keys[i] != -1 && keys[i] != key) i = (i + 1) & mask;
        keys[i] = key;
        rows[i] = row;
    }

    int32_t find(int64_t key) const {
        uint64_t i = (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull) & mask;
        while (true) {
            if (keys[i] == key) return rows[i];
            if (keys[i] == -1) return -1;
            i = (i + 1) & mask;
        }
    }
};

struct Table {
    // coords: (capacity, 3) int32 zyx, sorted by linear key, -1 pad
    std::vector<int32_t> coords;
    int32_t n;         // valid rows
    int32_t capacity;
    int64_t shape[3];  // (D, H, W)
    HashMap map;

    Table(int32_t cap, const int64_t* shp)
        : coords(static_cast<size_t>(cap) * 3, -1), n(0), capacity(cap),
          map(cap) {
        shape[0] = shp[0]; shape[1] = shp[1]; shape[2] = shp[2];
    }

    int64_t key_of(int32_t row) const {
        const int32_t* c = &coords[static_cast<size_t>(row) * 3];
        return (static_cast<int64_t>(c[0]) * shape[1] + c[1]) * shape[2] + c[2];
    }

    void build_map() {
        for (int32_t r = 0; r < n; ++r) map.insert(key_of(r), r);
    }
};

struct Op {
    int32_t type;
    int32_t k[3], s[3], p[3];
    int32_t out_cap;
    int32_t match;
};

// Python-style floor division (oshape formulas can go negative on
// degenerate grids; C++ / truncates toward zero and would disagree)
inline int64_t floordiv(int64_t a, int64_t b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// kernel offsets in row-major zyx order (matches ops/sparse._kernel_offsets)
inline void offsets_of(const int32_t* k, std::vector<int32_t>& off) {
    off.clear();
    for (int32_t z = 0; z < k[0]; ++z)
        for (int32_t y = 0; y < k[1]; ++y)
            for (int32_t x = 0; x < k[2]; ++x) {
                off.push_back(z); off.push_back(y); off.push_back(x);
            }
}

}  // namespace

extern "C" {

// coords: (cap_in, 3) int32 zyx sorted by linear key, -1 pad; n_vox valid.
// spatial: (D, H, W) int64 of the input table.
// plan: (n_ops, 16) int32 records (see header comment).
// Outputs: rulebooks / out_coords / out_nums as described above.
// Returns 0 on success, -1 on plan error.
int32_t build_rulebooks(const int32_t* coords, int32_t n_vox, int32_t cap_in,
                        const int64_t* spatial, const int32_t* plan,
                        int32_t n_ops, int32_t* rulebooks, int32_t* out_coords,
                        int32_t* out_nums) {
    std::vector<Op> ops(n_ops);
    for (int32_t i = 0; i < n_ops; ++i) {
        const int32_t* r = plan + i * 16;
        ops[i].type = r[0];
        for (int d = 0; d < 3; ++d) {
            ops[i].k[d] = r[1 + d];
            ops[i].s[d] = r[4 + d];
            ops[i].p[d] = r[7 + d];
        }
        ops[i].out_cap = r[10];
        ops[i].match = r[11];
    }

    std::vector<Table> tables;  // one per stage; tables[0] = input
    tables.reserve(n_ops + 1);
    tables.emplace_back(cap_in, spatial);
    Table& t0 = tables.back();
    t0.n = n_vox;
    std::memcpy(t0.coords.data(), coords,
                sizeof(int32_t) * static_cast<size_t>(cap_in) * 3);
    t0.build_map();

    // stage index of each op's INPUT/OUTPUT table (for inv/rewind matching)
    std::vector<int32_t> op_in_stage(n_ops), op_out_stage(n_ops);
    int32_t cur = 0;  // current stage (index into tables)

    int32_t* rb = rulebooks;
    int32_t* oc = out_coords;
    int32_t* on = out_nums;
    std::vector<int32_t> off;

    for (int32_t i = 0; i < n_ops; ++i) {
        const Op& op = ops[i];
        op_in_stage[i] = cur;
        if (op.type == 3) {  // rewind
            if (op.match < 0 || op.match >= i || ops[op.match].type != 1)
                return -1;
            cur = op_out_stage[op.match];
            op_out_stage[i] = cur;
            continue;
        }
        Table& tin = tables[cur];
        const int64_t D = tin.shape[0], H = tin.shape[1], W = tin.shape[2];
        offsets_of(op.k, off);
        const int32_t K = static_cast<int32_t>(off.size() / 3);
        const int32_t miss = tin.capacity;

        if (op.type == 0) {  // submanifold: outputs = inputs, centered kernel
            const int32_t cz = (op.k[0] - 1) / 2, cy = (op.k[1] - 1) / 2,
                          cx = (op.k[2] - 1) / 2;
            for (int32_t o = 0; o < tin.capacity; ++o) {
                const int32_t* c = &tin.coords[static_cast<size_t>(o) * 3];
                for (int32_t kk = 0; kk < K; ++kk) {
                    int32_t out = miss;
                    if (o < tin.n) {
                        const int64_t z = c[0] + off[kk * 3 + 0] - cz;
                        const int64_t y = c[1] + off[kk * 3 + 1] - cy;
                        const int64_t x = c[2] + off[kk * 3 + 2] - cx;
                        if (z >= 0 && z < D && y >= 0 && y < H && x >= 0 &&
                            x < W) {
                            const int32_t r =
                                tin.map.find((z * H + y) * W + x);
                            if (r >= 0) out = r;
                        }
                    }
                    rb[static_cast<int64_t>(o) * K + kk] = out;
                }
            }
            rb += static_cast<int64_t>(tin.capacity) * K;
            op_out_stage[i] = cur;
            continue;
        }

        if (op.type == 1) {  // strided downsample
            int64_t oshape[3];
            for (int d = 0; d < 3; ++d)
                oshape[d] = floordiv(
                    tin.shape[d] + 2 * op.p[d] - (op.k[d] - 1) - 1,
                    op.s[d]) + 1;
            const int64_t OH = oshape[1], OW = oshape[2];
            // candidate parents per input voxel: o = (i + p - k)/s where
            // divisible and in range (ops/sparse.py:199-226)
            std::vector<int64_t> cand;
            cand.reserve(static_cast<size_t>(tin.n) * 8);
            for (int32_t v = 0; v < tin.n; ++v) {
                const int32_t* c = &tin.coords[static_cast<size_t>(v) * 3];
                int64_t os[3][4];
                int32_t no[3];
                for (int d = 0; d < 3; ++d) {
                    no[d] = 0;
                    // k0 = smallest k >= 0 with (i + p - k) divisible by s;
                    // i + p >= 0 always (coords and padding non-negative),
                    // so the numerator below is >= 0 and / is floor-exact
                    const int32_t k0 = (c[d] + op.p[d]) % op.s[d];
                    for (int32_t kk = k0; kk < op.k[d]; kk += op.s[d]) {
                        const int64_t num =
                            static_cast<int64_t>(c[d]) + op.p[d] - kk;
                        if (num < 0) continue;
                        const int64_t o = num / op.s[d];
                        if (o < oshape[d]) os[d][no[d]++] = o;
                    }
                }
                for (int32_t a = 0; a < no[0]; ++a)
                    for (int32_t b = 0; b < no[1]; ++b)
                        for (int32_t e = 0; e < no[2]; ++e)
                            cand.push_back(
                                (os[0][a] * OH + os[1][b]) * OW + os[2][e]);
            }
            std::sort(cand.begin(), cand.end());
            cand.erase(std::unique(cand.begin(), cand.end()), cand.end());
            const int32_t n_out = static_cast<int32_t>(
                std::min<size_t>(cand.size(), op.out_cap));

            tables.emplace_back(op.out_cap, oshape);
            // NOTE: emplace may reallocate `tables`; re-bind tin
            Table& tref = tables[cur];
            Table& tout = tables.back();
            tout.n = n_out;
            for (int32_t o = 0; o < n_out; ++o) {
                const int64_t key = cand[o];
                int32_t* c = &tout.coords[static_cast<size_t>(o) * 3];
                c[0] = static_cast<int32_t>(key / (OH * OW));
                c[1] = static_cast<int32_t>((key / OW) % OH);
                c[2] = static_cast<int32_t>(key % OW);
            }
            tout.build_map();

            // rulebook: input row feeding (output o, offset k):
            // in = o*s - p + k  (ops/sparse.py:257)
            for (int32_t o = 0; o < tout.capacity; ++o) {
                const int32_t* c = &tout.coords[static_cast<size_t>(o) * 3];
                for (int32_t kk = 0; kk < K; ++kk) {
                    int32_t out = miss;
                    if (o < tout.n) {
                        const int64_t z =
                            static_cast<int64_t>(c[0]) * op.s[0] - op.p[0] +
                            off[kk * 3 + 0];
                        const int64_t y =
                            static_cast<int64_t>(c[1]) * op.s[1] - op.p[1] +
                            off[kk * 3 + 1];
                        const int64_t x =
                            static_cast<int64_t>(c[2]) * op.s[2] - op.p[2] +
                            off[kk * 3 + 2];
                        if (z >= 0 && z < D && y >= 0 && y < H && x >= 0 &&
                            x < W) {
                            const int32_t r =
                                tref.map.find((z * H + y) * W + x);
                            if (r >= 0) out = r;
                        }
                    }
                    rb[static_cast<int64_t>(o) * K + kk] = out;
                }
            }
            rb += static_cast<int64_t>(tout.capacity) * K;
            std::memcpy(oc, tout.coords.data(),
                        sizeof(int32_t) * static_cast<size_t>(tout.capacity) *
                            3);
            oc += static_cast<int64_t>(tout.capacity) * 3;
            *on++ = tout.n;
            cur = static_cast<int32_t>(tables.size()) - 1;
            op_out_stage[i] = cur;
            continue;
        }

        if (op.type == 2) {  // inverse: output set = match op's input table
            if (op.match < 0 || op.match >= i) return -1;
            const int32_t up_stage = op_in_stage[op.match];
            Table& tup = tables[up_stage];
            // up voxel u receives current voxel o at offset k iff
            // o*s - p + k == u  ->  o = (u + p - k)/s (ops/sparse.py:282)
            const Op& mop = ops[op.match];
            offsets_of(mop.k, off);
            const int32_t Ki = static_cast<int32_t>(off.size() / 3);
            for (int32_t u = 0; u < tup.capacity; ++u) {
                const int32_t* c = &tup.coords[static_cast<size_t>(u) * 3];
                for (int32_t kk = 0; kk < Ki; ++kk) {
                    int32_t out = miss;
                    if (u < tup.n) {
                        bool ok = true;
                        int64_t o[3];
                        for (int d = 0; d < 3; ++d) {
                            const int64_t num = static_cast<int64_t>(c[d]) +
                                                mop.p[d] - off[kk * 3 + d];
                            if (num % mop.s[d] != 0) { ok = false; break; }
                            o[d] = num / mop.s[d];
                            if (o[d] < 0 || o[d] >= tin.shape[d]) {
                                ok = false;
                                break;
                            }
                        }
                        if (ok) {
                            const int32_t r = tin.map.find(
                                (o[0] * H + o[1]) * W + o[2]);
                            if (r >= 0) out = r;
                        }
                    }
                    rb[static_cast<int64_t>(u) * Ki + kk] = out;
                }
            }
            rb += static_cast<int64_t>(tup.capacity) * Ki;
            cur = up_stage;
            op_out_stage[i] = cur;
            continue;
        }

        return -1;
    }
    return 0;
}

}  // extern "C"
