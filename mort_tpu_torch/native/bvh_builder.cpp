// Native BVH builder.
//
// Same construction as the reference's host-side build (objects.cuh:529-611):
// iterative worklist; per node, AABB union over its span; split axis =
// largest extent (aabb.cuh:61-67); stable sort of the span by AABB min along
// that axis (the reference's bubble sort, objects.cuh:631-661, is stable);
// midpoint split at start + ceil(span/2); leaves hold 1-2 primitives.
// Unlike the reference, the sort permutes an index array — primitive rows
// stay stable (SURVEY.md section 3.3 caveat).
//
// Exposed via a C ABI for ctypes; built with g++ at first use
// (mort_tpu_torch/native/__init__.py).  Verified bit-for-bit against the
// NumPy builder in tests/test_torch_bvh_builder.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline float axis_val(const Vec3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

}  // namespace

extern "C" {

// leaf_min/leaf_max: [n,3] row-major leaf AABBs.
// Outputs (caller-allocated, capacity cap >= 2n):
//   node_min/node_max: [cap,3]; left/right: child node id (internal) or
//   leaf slot into the input arrays (leaf); is_leaf: [cap] (0/1).
// Returns the number of nodes written, or -1 if cap is too small.
int mort_build_bvh(const float *leaf_min, const float *leaf_max, int n,
                   int cap, float *node_min, float *node_max, int32_t *left,
                   int32_t *right, uint8_t *is_leaf) {
  if (n < 1) return 0;
  const Vec3 *lmin = reinterpret_cast<const Vec3 *>(leaf_min);
  const Vec3 *lmax = reinterpret_cast<const Vec3 *>(leaf_max);

  std::vector<int32_t> perm(n);
  for (int i = 0; i < n; ++i) perm[i] = i;

  std::vector<std::pair<int, int>> spans;
  spans.reserve(2 * n);
  spans.emplace_back(0, n);

  for (size_t node_id = 0; node_id < spans.size(); ++node_id) {
    if (static_cast<int>(spans.size()) > cap) return -1;
    const int start = spans[node_id].first;
    const int end = spans[node_id].second;

    Vec3 bb_min = lmin[perm[start]];
    Vec3 bb_max = lmax[perm[start]];
    for (int i = start + 1; i < end; ++i) {
      const Vec3 &a = lmin[perm[i]];
      const Vec3 &b = lmax[perm[i]];
      bb_min.x = std::min(bb_min.x, a.x);
      bb_min.y = std::min(bb_min.y, a.y);
      bb_min.z = std::min(bb_min.z, a.z);
      bb_max.x = std::max(bb_max.x, b.x);
      bb_max.y = std::max(bb_max.y, b.y);
      bb_max.z = std::max(bb_max.z, b.z);
    }
    node_min[3 * node_id + 0] = bb_min.x;
    node_min[3 * node_id + 1] = bb_min.y;
    node_min[3 * node_id + 2] = bb_min.z;
    node_max[3 * node_id + 0] = bb_max.x;
    node_max[3 * node_id + 1] = bb_max.y;
    node_max[3 * node_id + 2] = bb_max.z;

    // largest_axis with the reference's tie-breaking (aabb.cuh:61-67)
    const float ex = bb_max.x - bb_min.x;
    const float ey = bb_max.y - bb_min.y;
    const float ez = bb_max.z - bb_min.z;
    const int axis = (ex > ey) ? (ex > ez ? 0 : 2) : (ey > ez ? 1 : 2);

    const int span = end - start;
    if (span == 1) {
      left[node_id] = perm[start];
      right[node_id] = perm[start];
      is_leaf[node_id] = 1;
    } else if (span == 2) {
      int a = perm[start], b = perm[start + 1];
      // compare_by_axis orders by AABB min (objects.cuh:982-1000)
      if (axis_val(lmin[a], axis) > axis_val(lmin[b], axis)) std::swap(a, b);
      left[node_id] = a;
      right[node_id] = b;
      is_leaf[node_id] = 1;
    } else {
      std::stable_sort(perm.begin() + start, perm.begin() + end,
                       [&](int32_t a, int32_t b) {
                         return axis_val(lmin[a], axis) <
                                axis_val(lmin[b], axis);
                       });
      const int mid = start + span / 2 + (span % 2);
      left[node_id] = static_cast<int32_t>(spans.size());
      spans.emplace_back(start, mid);
      right[node_id] = static_cast<int32_t>(spans.size());
      spans.emplace_back(mid, end);
      is_leaf[node_id] = 0;
    }
  }
  return static_cast<int>(spans.size());
}

}  // extern "C"
