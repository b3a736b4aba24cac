// Rotated BEV IoU of box pairs on the host, for the KITTI-protocol eval of
// lidardetection_tpu_torch (datasets/kitti/kitti_object_eval/eval.py) and
// core/np_geometry.py::boxes_bev_iou_cpu.
//
// A copy of the rotated_iou_bev part of lidardetection_tpu/native/
// voxelizer.cpp (box_corners, clip_edge, polygon_area, rect_intersection,
// rotated_iou_bev); the voxelizer is not part of it.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (native/__init__.py does it).
// Python binding: ctypes (see native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Rotated BEV IoU (Sutherland–Hodgman polygon clipping), float64.
// Boxes are (cx, cy, dx, dy, heading) — centre form, heading in radians,
// matching core/np_geometry.py::boxes_bev_iou_cpu.
// criterion: -1 = IoU, 0 = inter/area_a, 1 = inter/area_b (the KITTI eval's
// image/bev criteria, rotate_iou.py:292-330).
// ---------------------------------------------------------------------------

namespace {

struct Pt { double x, y; };

inline void box_corners(const float* b, Pt* c4) {
    const double cx = b[0], cy = b[1], dx = b[2] * 0.5, dy = b[3] * 0.5;
    const double ca = std::cos(static_cast<double>(b[4]));
    const double sa = std::sin(static_cast<double>(b[4]));
    const double ox[4] = {dx, dx, -dx, -dx};
    const double oy[4] = {-dy, dy, dy, -dy};
    for (int i = 0; i < 4; ++i) {
        c4[i].x = cx + ox[i] * ca - oy[i] * sa;
        c4[i].y = cy + ox[i] * sa + oy[i] * ca;
    }
}

// Clip polygon `in` (n vertices) against the half-plane left of a->b.
inline int clip_edge(const Pt* in, int n, Pt a, Pt b, Pt* out) {
    int m = 0;
    const double ex = b.x - a.x, ey = b.y - a.y;
    for (int i = 0; i < n; ++i) {
        const Pt& p = in[i];
        const Pt& q = in[(i + 1) % n];
        // corners are CCW, so the rectangle interior is left of a->b
        // (cross >= 0); keep that side.
        const double dp = ex * (p.y - a.y) - ey * (p.x - a.x);
        const double dq = ex * (q.y - a.y) - ey * (q.x - a.x);
        if (dp >= 0) out[m++] = p;
        if ((dp < 0 && dq > 0) || (dp > 0 && dq < 0)) {
            const double t = dp / (dp - dq);
            out[m].x = p.x + t * (q.x - p.x);
            out[m].y = p.y + t * (q.y - p.y);
            ++m;
        }
    }
    return m;
}

inline double polygon_area(const Pt* p, int n) {
    double a = 0;
    for (int i = 0; i < n; ++i) {
        const Pt& u = p[i];
        const Pt& v = p[(i + 1) % n];
        a += u.x * v.y - u.y * v.x;
    }
    return std::fabs(a) * 0.5;
}

inline double rect_intersection(const Pt* ca, const Pt* cb) {
    Pt buf0[16], buf1[16];
    std::memcpy(buf0, ca, sizeof(Pt) * 4);
    int n = 4;
    Pt* cur = buf0;
    Pt* nxt = buf1;
    for (int e = 0; e < 4 && n > 2; ++e) {
        n = clip_edge(cur, n, cb[e], cb[(e + 1) % 4], nxt);
        Pt* t = cur; cur = nxt; nxt = t;
    }
    return n > 2 ? polygon_area(cur, n) : 0.0;
}

}  // namespace

// boxes_a (na, 5), boxes_b (nb, 5) float32 -> out (na, nb) float32.
void rotated_iou_bev(const float* boxes_a, int64_t na,
                     const float* boxes_b, int64_t nb,
                     int32_t criterion, float* out) {
    std::vector<Pt> corners_b(static_cast<size_t>(nb) * 4);
    std::vector<double> area_b(nb);
    for (int64_t j = 0; j < nb; ++j) {
        box_corners(boxes_b + j * 5, &corners_b[j * 4]);
        area_b[j] = static_cast<double>(boxes_b[j * 5 + 2]) * boxes_b[j * 5 + 3];
    }
    for (int64_t i = 0; i < na; ++i) {
        Pt ca[4];
        box_corners(boxes_a + i * 5, ca);
        const double aa =
            static_cast<double>(boxes_a[i * 5 + 2]) * boxes_a[i * 5 + 3];
        for (int64_t j = 0; j < nb; ++j) {
            const double inter = rect_intersection(ca, &corners_b[j * 4]);
            double denom;
            if (criterion == 0) denom = aa;
            else if (criterion == 1) denom = area_b[j];
            else denom = aa + area_b[j] - inter;
            out[i * nb + j] =
                denom > 0 ? static_cast<float>(inter / denom) : 0.0f;
        }
    }
}

}  // extern "C"
