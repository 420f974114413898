// Per-ray BVH walk over child-pair rows.
//
// One call walks one ray: near-first descent with a private stack, leaves
// intersected as they are reached (while-while order). The arithmetic and the
// visit order are those of the XLA walk in tpu_raytracing/ops/traverse.py
// (_walk_xla), which is this walk's reference:
//   - slab test with NaN-propagating min/max, like XLA's min/max;
//   - Moller-Trumbore with the seam-inclusive bound BARY_EPS of
//     tpu_raytracing/ops/intersect.py;
//   - within a leaf the first nearest triangle wins; a later leaf replaces
//     the winner on an equal t (the XLA walk tests t <= t_best).
//
// Tables (DeviceScene):
//   rows: (M, 16) f32 = [L.min3, L.max3, R.min3, R.max3, bits(metaL),
//         bits(metaR), pad, pad]; a child meta is (first<<3)|count for a
//         leaf and row<<3 for an internal node.
//   tris: (T, 9) f32 = [p0, p1, p2].
//
// The header is plain C++ under RT_HD, so the same code compiles for the
// device (bvh_walk.cu) and for a host check.
#pragma once

#include <cmath>

#ifndef RT_HD
#define RT_HD
#endif

#ifndef RT_MAX_STACK
#define RT_MAX_STACK 64
#endif

#if defined(__CUDA_ARCH__)
#define RT_LD(p) __ldg(p)
#else
#define RT_LD(p) (*(p))
#endif

namespace rt {

constexpr int kDone = -1;
constexpr float kBaryLo = -1e-5f;     // -BARY_EPS
constexpr float kBaryHi = 1.00001f;   // 1 + BARY_EPS, rounded like XLA's f32

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;  // 1 / direction
  float t_min;
};

RT_HD inline float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

RT_HD inline float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Slab test of one box; hit iff t0 <= t1 (range may be negative).
RT_HD inline void slab(const Ray& r, float x0, float y0, float z0, float x1,
                       float y1, float z1, float& t0, float& t1) {
  const float ax = (x0 - r.ox) * r.ix, bx = (x1 - r.ox) * r.ix;
  const float ay = (y0 - r.oy) * r.iy, by = (y1 - r.oy) * r.iy;
  const float az = (z0 - r.oz) * r.iz, bz = (z1 - r.oz) * r.iz;
  t0 = nan_max(nan_max(nan_min(ax, bx), nan_min(ay, by)), nan_min(az, bz));
  t1 = nan_min(nan_min(nan_max(ax, bx), nan_max(ay, by)), nan_max(az, bz));
}

// Moller-Trumbore; returns t, or +inf when the ray misses within
// [t_min, t_max].
RT_HD inline float triangle_t(const Ray& r, const float* p, float t_max) {
  const float p0x = RT_LD(p + 0), p0y = RT_LD(p + 1), p0z = RT_LD(p + 2);
  const float e1x = RT_LD(p + 3) - p0x, e1y = RT_LD(p + 4) - p0y,
              e1z = RT_LD(p + 5) - p0z;
  const float e2x = RT_LD(p + 6) - p0x, e2y = RT_LD(p + 7) - p0y,
              e2z = RT_LD(p + 8) - p0z;
  // pvec = cross(d, e2)
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float denom = pvx * e1x + pvy * e1y + pvz * e1z;
  const float safe = denom == 0.0f ? 1.0f : denom;
  const float tvx = r.ox - p0x, tvy = r.oy - p0y, tvz = r.oz - p0z;
  const float u = (pvx * tvx + pvy * tvy + pvz * tvz) / safe;
  // qvec = cross(tvec, e1)
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (qx * r.dx + qy * r.dy + qz * r.dz) / safe;
  const float t = (qx * e2x + qy * e2y + qz * e2z) / safe;
  const bool valid = denom != 0.0f && u >= kBaryLo && u <= kBaryHi &&
                     v >= kBaryLo && u + v <= kBaryHi && t >= r.t_min &&
                     t <= t_max;
  return valid ? t : INFINITY;
}

// Walks one ray from `root`, tightening (t_best, best). With kAnyHit the
// walk stops at the first leaf that leaves a winner.
template <bool kAnyHit>
RT_HD inline void walk(const float* rows, const float* tris, int root,
                       const Ray& r, float& t_best, int& best) {
  int stack[RT_MAX_STACK];
  int sp = 0;
  int cur = root;
  while (cur != kDone) {
    while (cur != kDone && (cur & 7) == 0) {
      const float* row = rows + static_cast<long long>(cur >> 3) * 16;
      float tl0, tl1, tr0, tr1;
      slab(r, RT_LD(row + 0), RT_LD(row + 1), RT_LD(row + 2), RT_LD(row + 3),
           RT_LD(row + 4), RT_LD(row + 5), tl0, tl1);
      slab(r, RT_LD(row + 6), RT_LD(row + 7), RT_LD(row + 8), RT_LD(row + 9),
           RT_LD(row + 10), RT_LD(row + 11), tr0, tr1);
      const int* metas = reinterpret_cast<const int*>(row + 12);
      const int meta_l = RT_LD(metas + 0), meta_r = RT_LD(metas + 1);
      const bool hit_l = tl0 <= tl1 && tl1 >= r.t_min && tl0 <= t_best;
      const bool hit_r = tr0 <= tr1 && tr1 >= r.t_min && tr0 <= t_best;
      if (hit_l && hit_r) {
        const bool l_near = tl0 <= tr0;
        stack[sp++] = l_near ? meta_r : meta_l;
        cur = l_near ? meta_l : meta_r;
      } else if (hit_l) {
        cur = meta_l;
      } else if (hit_r) {
        cur = meta_r;
      } else {
        cur = sp > 0 ? stack[--sp] : kDone;
      }
    }
    if (cur == kDone) break;
    const int first = cur >> 3, count = cur & 7;
    float t_leaf = INFINITY;
    int k_leaf = -1;
    for (int k = 0; k < count; ++k) {
      const float t = triangle_t(
          r, tris + static_cast<long long>(first + k) * 9, t_best);
      if (t < t_leaf) {
        t_leaf = t;
        k_leaf = k;
      }
    }
    if (k_leaf >= 0) {
      t_best = t_leaf;
      best = first + k_leaf;
      if (kAnyHit) break;
    }
    cur = sp > 0 ? stack[--sp] : kDone;
  }
}

RT_HD inline Ray make_ray(const float* origin, const float* direction,
                          float t_min) {
  Ray r;
  r.ox = origin[0];
  r.oy = origin[1];
  r.oz = origin[2];
  r.dx = direction[0];
  r.dy = direction[1];
  r.dz = direction[2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  r.t_min = t_min;
  return r;
}

}  // namespace rt
