// Closest sphere/quad hit + joined shading row, one thread per ray.
//
// Replaces the JAX package's Pallas TPU kernel
// mort_tpu/render/pallas_intersect.py::_closest_hit (kernel body
// _make_kernel) in its three accel modes:
//
//   "none"  the sphere scan _sphere_chunk_best, the plain quad loop
//           _quad_chunk_best, the merge and the row emit _emit_row;
//   "cull"  the same tests, one CL-sized sub-cluster at a time, each behind
//           an AABB slab test (cluster_boxes);
//   "bvh"   traversal of the implicit heap over those sub-clusters
//           (cluster_tree), with a per-ray stack of kStack nodes;
//
// and the gradient of the closest hit, closest_hit_bwd_kernel (the
// _closest_hit_vjp bwd; its notes are at the kernel, below).
//
// The TPU version folded every per-(ray, primitive) product into
// limb-packed bf16 MXU dots, gathered the winner's row with a one-hot
// matmul, and traversed with one scalar stack per 1024-ray tile; all three
// existed only to serve the TPU.  Here they are plain float32 arithmetic,
// one indexed load, and a stack per ray that visits children near-first
// along the ray's own direction.
//
// What bounds it on an H100: float32 issue in "none".  Each (ray, sphere)
// pair costs about 25 flops (two 3-term dots for half_b, two for c_term,
// the discriminant, a square root and the root pick), so scene 1 (485
// spheres) at a pool of 2^18 rays is ~3.2 Gflop per bounce.  The sphere and
// quad records are staged through shared memory in tiles of 256 and read by
// every thread of the block at the same address (a broadcast, no bank
// conflicts), so device memory traffic is the rays in, the [32, R] rows out
// and one 108-byte row load per ray.  "cull" and "bvh" read each visited
// sub-cluster's records from global memory (__ldg, L1/L2-resident for
// scenes of a few thousand primitives): their work is the tests a ray's
// pruning leaves it, and divergence between the rays of a warp.
//
// Arithmetic: every add, subtract, multiply, divide and square root of a
// primitive test is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn,
// __fsqrt_rn, ...), so nvcc contracts nothing into an FMA and the results
// equal, bit for bit, the plain PyTorch version closest_hit_reference in
// mort_tpu_torch/render/closest_hit.py, which performs the same ops in the
// same order.  All three modes run the very same __device__ tests
// (sphere_test, quad_test) and the same emit; a mode only chooses which
// primitives a ray tests.  The formulas (and the a-scaled root pick) are
// documented in closest_hit.py.
//
// Tie rules: spheres and quads keep separate bests (the spheres' in a-scaled
// t) and each keeps the lexicographic minimum over (t, registry row), which
// is the linear scan's earlier-row-wins rule whatever order the rows are
// visited in; a sphere beats a quad on an exact tie in the one final merge.
// Pruning enters a box when its slab interval [lo, hi] has lo <= bound and
// hi > t_min, where bound = min(sphere best unscaled exactly as the merge
// will unscale it, quad best) can never be below the final best, so a
// primitive that ties the winner is still tested.  Inverted (padding) boxes
// are never entered.  Rows whose surface flag is 0 (skip rows, padding)
// never win.  A miss writes t = +inf, kind 0, idx 0 and the joined row 0,
// as the JAX kernel's gather does.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;   // rays per block, and primitives per tile
constexpr int kSphCols = 10;    // cx cy cz vx vy vz c.c-r^2 2c.cv |cv|^2 surf
constexpr int kQuadCols = 13;   // n(3) D vxw(3) qa wxu(3) qb surf
constexpr int kRowK = 32;       // rows of the [32, R] output
constexpr int kRowT = 27;
constexpr int kRowKind = 28;
constexpr int kRowIdx = 29;
constexpr int kSphere = 1;
constexpr int kQuad = 2;
constexpr int kCL = 128;        // primitives per sub-cluster (closest_hit.CL)
constexpr int kStack = 32;      // bvh stack depth (closest_hit.STACK)
constexpr int kBoxCols = 8;     // cull boxes: lo xyz, hi xyz, 0, 0
constexpr int kNodeCols = 6;    // bvh nodes: lo xyz, hi xyz
constexpr float kTiny = 1e-30f; // slab substitute for a zero direction
constexpr int kModeNone = 0, kModeCull = 1, kModeBvh = 2;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// A ray and its per-ray terms (hoisted out of every primitive test).
struct Ray {
  float ox, oy, oz, dx, dy, dz, tm;
  float a, ro_rd, ro_sq, tdx, tdy, tdz, tox, toy, toz, tt, tmin_a, t_min;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int R, int i, float t_min) {
  Ray r;
  r.ox = rays[i]; r.oy = rays[R + i]; r.oz = rays[2 * R + i];
  r.dx = rays[3 * R + i]; r.dy = rays[4 * R + i]; r.dz = rays[5 * R + i];
  r.tm = rays[6 * R + i];
  r.a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  r.ro_rd = dot3(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  r.ro_sq = dot3(r.ox, r.oy, r.oz, r.ox, r.oy, r.oz);
  r.tdx = mul(r.tm, r.dx); r.tdy = mul(r.tm, r.dy); r.tdz = mul(r.tm, r.dz);
  r.tox = mul(r.tm, r.ox); r.toy = mul(r.tm, r.oy); r.toz = mul(r.tm, r.oz);
  r.tt = mul(r.tm, r.tm);
  r.tmin_a = mul(r.a, t_min);
  r.t_min = t_min;
  return r;
}

// Column c of a primitive record: in a shared-memory tile (column-major,
// kThreads per column), or a row of the table in global memory.
struct TileRec {
  const float* p;
  __device__ __forceinline__ float operator()(int c) const {
    return p[c * kThreads];
  }
};
struct RowRec {
  const float* __restrict__ p;
  __device__ __forceinline__ float operator()(int c) const {
    return __ldg(p + c);
  }
};

// The a-scaled quadratic of one sphere record against the ray (half_b and
// c_term of closest_hit.py's docstring).  Shared by the forward test and the
// backward, so the backward sees the forward's exact rounding.
template <class Rec>
__device__ __forceinline__ void sphere_terms(const Ray& r, Rec rec,
                                             float& half_b, float& c_term) {
  const float cx = rec(0), cy = rec(1), cz = rec(2);
  const float vx = rec(3), vy = rec(4), vz = rec(5);
  half_b = sub(sub(r.ro_rd, dot3(r.dx, r.dy, r.dz, cx, cy, cz)),
               dot3(r.tdx, r.tdy, r.tdz, vx, vy, vz));
  c_term = add(
      add(add(sub(sub(r.ro_sq, mul(2.0f, dot3(r.ox, r.oy, r.oz, cx, cy, cz))),
                  mul(2.0f, dot3(r.tox, r.toy, r.toz, vx, vy, vz))),
              rec(6)),
          mul(r.tm, rec(7))),
      mul(r.tt, rec(8)));
}

// One sphere record against the ray: keeps the lexicographic minimum of
// (a-scaled root, row) in (best, best_i).  Returns false for a skip or
// padding row (not a test).
template <class Rec>
__device__ __forceinline__ bool sphere_test(const Ray& r, Rec rec, int row,
                                            float& best, int& best_i) {
  if (rec(9) == 0.0f) return false;   // skip / padding row
  float half_b, c_term;
  sphere_terms(r, rec, half_b, c_term);
  const float disc = sub(mul(half_b, half_b), mul(r.a, c_term));
  if (!(disc >= 0.0f)) return true;
  const float sq = __fsqrt_rn(disc);
  const float root1 = sub(-half_b, sq);
  const float root = root1 > r.tmin_a ? root1 : add(root1, mul(2.0f, sq));
  if (root > r.tmin_a && (root < best || (root == best && row < best_i))) {
    best = root;
    best_i = row;
  }
  return true;
}

// One quad record against the ray: the general plane/window test, keeping
// the lexicographic minimum of (t, row) in (qt, qi).  Returns false for a
// skip or padding row (not a test).
template <class Rec>
__device__ __forceinline__ bool quad_test(const Ray& r, Rec rec, int row,
                                          float& qt, int& qi) {
  if (rec(12) == 0.0f) return false;
  const float nx = rec(0), ny = rec(1), nz = rec(2);
  const float den = dot3(nx, ny, nz, r.dx, r.dy, r.dz);
  if (!(fabsf(den) >= 1e-8f)) return true;
  const float num = sub(rec(3), dot3(nx, ny, nz, r.ox, r.oy, r.oz));
  const float t = __fdiv_rn(num, den);
  if (!(t > r.t_min)) return true;
  const float ax = rec(4), ay = rec(5), az = rec(6);
  const float alpha = add(sub(dot3(ax, ay, az, r.ox, r.oy, r.oz), rec(7)),
                          mul(t, dot3(ax, ay, az, r.dx, r.dy, r.dz)));
  const float bx = rec(8), by = rec(9), bz = rec(10);
  const float beta = add(sub(dot3(bx, by, bz, r.ox, r.oy, r.oz), rec(11)),
                         mul(t, dot3(bx, by, bz, r.dx, r.dy, r.dz)));
  if (alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f &&
      (t < qt || (t == qt && row < qi))) {
    qt = t;
    qi = row;
  }
  return true;
}

// Adds one thread's sphere and quad test counts to n_tests[0..1].
__device__ __forceinline__ void add_counts(unsigned long long* n_tests,
                                           int n_s, int n_q) {
  if (n_s) atomicAdd(n_tests, (unsigned long long)n_s);
  if (n_q) atomicAdd(n_tests + 1, (unsigned long long)n_q);
}

// Merge (sphere wins ties) and write the winner's joined row, t, kind, idx.
__device__ __forceinline__ void emit(const Ray& r, float best, int best_i,
                                     float qt, int qi,
                                     const float* __restrict__ joined,
                                     int k_join, int quad_base, int R, int i,
                                     float* __restrict__ row_out) {
  const float st = mul(best, __frcp_rn(r.a));
  const bool q_better = qt < st;
  const float t = q_better ? qt : st;
  const bool hit = t < CUDART_INF_F;
  const int kind = hit ? (q_better ? kQuad : kSphere) : 0;
  const int idx = q_better ? qi : best_i;
  const int g = q_better ? quad_base + qi : best_i;
  const float* src = joined + (size_t)g * k_join;
  for (int k = 0; k < kRowT; ++k)
    row_out[(size_t)k * R + i] = k < k_join ? src[k] : 0.0f;
  row_out[(size_t)kRowT * R + i] = t;
  row_out[(size_t)kRowKind * R + i] = (float)kind;
  row_out[(size_t)kRowIdx * R + i] = (float)idx;
  for (int k = kRowIdx + 1; k < kRowK; ++k) row_out[(size_t)k * R + i] = 0.0f;
}

// kCount: also count the tests into n_tests (a separate instantiation, so
// the uncounted kernels carry no counting code).
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ rays, int R,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ quad, int n_quad,
                   const float* __restrict__ joined, int k_join,
                   int quad_base, float t_min, float* __restrict__ row_out,
                   unsigned long long* __restrict__ n_tests) {
  __shared__ float s_sph[kSphCols][kThreads];
  __shared__ float s_quad[kQuadCols][kThreads];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < R;
  // ragged tail: compute on a real ray, so every thread reaches the barriers
  const Ray r = load_ray(rays, R, live ? i : R - 1, t_min);

  // ---- spheres: roots scaled by a ----
  float best = CUDART_INF_F;
  int best_i = 0, n_s = 0, n_q = 0;
  for (int base = 0; base < n_sph; base += kThreads) {
    const int n = min(kThreads, n_sph - base);
    __syncthreads();
    if (threadIdx.x < n) {
      const float* rec = sph + (size_t)(base + threadIdx.x) * kSphCols;
#pragma unroll
      for (int c = 0; c < kSphCols; ++c) s_sph[c][threadIdx.x] = rec[c];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const bool tested =
          sphere_test(r, TileRec{&s_sph[0][j]}, base + j, best, best_i);
      if constexpr (kCount) n_s += tested;
    }
  }

  // ---- quads ----
  float qt = CUDART_INF_F;
  int qi = 0;
  for (int base = 0; base < n_quad; base += kThreads) {
    const int n = min(kThreads, n_quad - base);
    __syncthreads();
    if (threadIdx.x < n) {
      const float* rec = quad + (size_t)(base + threadIdx.x) * kQuadCols;
#pragma unroll
      for (int c = 0; c < kQuadCols; ++c) s_quad[c][threadIdx.x] = rec[c];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const bool tested =
          quad_test(r, TileRec{&s_quad[0][j]}, base + j, qt, qi);
      if constexpr (kCount) n_q += tested;
    }
  }

  if (!live) return;
  if constexpr (kCount) add_counts(n_tests, n_s, n_q);
  emit(r, best, best_i, qt, qi, joined, k_join, quad_base, R, i, row_out);
}

// Reciprocal direction for the slab tests; |d| < kTiny becomes +-kTiny.
__device__ __forceinline__ float slab_inv(float d) {
  return 1.0f / (fabsf(d) < kTiny ? (d >= 0.0f ? kTiny : -kTiny) : d);
}

// Slab test of the box at `b` (lo xyz, hi xyz): the ray enters it in
// (t_min, bound].  An inverted box (padding) is never entered.
__device__ __forceinline__ bool box_reachable(const Ray& r, float irx,
                                              float iry, float irz,
                                              const float* __restrict__ b,
                                              float bound) {
  const float lx = __ldg(b), ly = __ldg(b + 1), lz = __ldg(b + 2);
  const float hx = __ldg(b + 3), hy = __ldg(b + 4), hz = __ldg(b + 5);
  if (!(lx <= hx)) return false;
  const float x0 = (lx - r.ox) * irx, x1 = (hx - r.ox) * irx;
  const float y0 = (ly - r.oy) * iry, y1 = (hy - r.oy) * iry;
  const float z0 = (lz - r.oz) * irz, z1 = (hz - r.oz) * irz;
  const float lo = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float hi = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return lo <= hi && hi > r.t_min && lo <= bound;
}

// Every primitive of sub-cluster s: sphere rows for s < n_sph_sub, then
// quad rows.  With kCount, adds the tests to n_s / n_q.
template <bool kCount>
__device__ __forceinline__ void test_leaf(
    const Ray& r, int s, const float* __restrict__ sph, int n_sph,
    const float* __restrict__ quad, int n_quad, int n_sph_sub, float& best,
    int& best_i, float& qt, int& qi, int& n_s, int& n_q) {
  if (s < n_sph_sub) {
    const int end = min((s + 1) * kCL, n_sph);
    for (int j = s * kCL; j < end; ++j) {
      const bool tested =
          sphere_test(r, RowRec{sph + (size_t)j * kSphCols}, j, best, best_i);
      if constexpr (kCount) n_s += tested;
    }
  } else {
    const int q = s - n_sph_sub;
    const int end = min((q + 1) * kCL, n_quad);
    for (int j = q * kCL; j < end; ++j) {
      const bool tested =
          quad_test(r, RowRec{quad + (size_t)j * kQuadCols}, j, qt, qi);
      if constexpr (kCount) n_q += tested;
    }
  }
}

// "cull": every sub-cluster in order (spheres first), each behind its box.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
closest_hit_cull_kernel(const float* __restrict__ rays, int R,
                        const float* __restrict__ sph, int n_sph,
                        const float* __restrict__ quad, int n_quad,
                        const float* __restrict__ joined, int k_join,
                        int quad_base, float t_min,
                        const float* __restrict__ boxes, int n_sph_sub,
                        int n_sub, float* __restrict__ row_out,
                        unsigned long long* __restrict__ n_tests) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i, t_min);
  const float irx = slab_inv(r.dx), iry = slab_inv(r.dy), irz = slab_inv(r.dz);
  const float rcp_a = __frcp_rn(r.a);
  float best = CUDART_INF_F, qt = CUDART_INF_F;
  int best_i = 0, qi = 0, n_s = 0, n_q = 0;
  for (int s = 0; s < n_sub; ++s) {
    // spheres prune against their own best; quads (after every sphere)
    // against min(quad best, sphere best)
    const float bound = fminf(mul(best, rcp_a), qt);
    if (box_reachable(r, irx, iry, irz, boxes + (size_t)s * kBoxCols, bound))
      test_leaf<kCount>(r, s, sph, n_sph, quad, n_quad, n_sph_sub, best,
                        best_i, qt, qi, n_s, n_q);
  }
  if constexpr (kCount) add_counts(n_tests, n_s, n_q);
  emit(r, best, best_i, qt, qi, joined, k_join, quad_base, R, i, row_out);
}

// Distance key of node k's box centre along the ray (near-first order).
__device__ __forceinline__ float node_key(const Ray& r,
                                          const float* __restrict__ b) {
  const float cx = 0.5f * (__ldg(b) + __ldg(b + 3));
  const float cy = 0.5f * (__ldg(b + 1) + __ldg(b + 4));
  const float cz = 0.5f * (__ldg(b + 2) + __ldg(b + 5));
  return (cx - r.ox) * r.dx + (cy - r.oy) * r.dy + (cz - r.oz) * r.dz;
}

// "bvh": the implicit heap (node 1 the root, children 2k and 2k+1, leaf
// sub-cluster s at node L + s), one stack per ray.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
closest_hit_bvh_kernel(const float* __restrict__ rays, int R,
                       const float* __restrict__ sph, int n_sph,
                       const float* __restrict__ quad, int n_quad,
                       const float* __restrict__ joined, int k_join,
                       int quad_base, float t_min,
                       const float* __restrict__ tree, int n_sph_sub, int L,
                       float* __restrict__ row_out,
                       unsigned long long* __restrict__ n_tests) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i, t_min);
  const float irx = slab_inv(r.dx), iry = slab_inv(r.dy), irz = slab_inv(r.dz);
  const float rcp_a = __frcp_rn(r.a);
  float best = CUDART_INF_F, qt = CUDART_INF_F;
  int best_i = 0, qi = 0, n_s = 0, n_q = 0;
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 1;
  while (sp > 0) {
    const int node = stack[--sp];
    const float bound = fminf(mul(best, rcp_a), qt);
    if (!box_reachable(r, irx, iry, irz, tree + (size_t)node * kNodeCols,
                       bound))
      continue;
    if (node >= L) {
      test_leaf<kCount>(r, node - L, sph, n_sph, quad, n_quad, n_sph_sub,
                        best, best_i, qt, qi, n_s, n_q);
    } else {
      const int c0 = 2 * node, c1 = c0 + 1;
      const bool c0_first =
          node_key(r, tree + (size_t)c0 * kNodeCols) <=
          node_key(r, tree + (size_t)c1 * kNodeCols);
      stack[sp++] = c0_first ? c1 : c0;   // far
      stack[sp++] = c0_first ? c0 : c1;   // near, popped first
    }
  }
  if constexpr (kCount) add_counts(n_tests, n_s, n_q);
  emit(r, best, best_i, qt, qi, joined, k_join, quad_base, R, i, row_out);
}

// ---- backward ----
//
// Replaces the JAX package's _closest_hit_vjp bwd (pallas_intersect.py,
// with _t_winner): there a chunked one-hot MXU gather of the winners'
// coefficient rows and a transposed one-hot segment sum, because TPU
// scatters serialise.  Here one thread per ray reads its winner's record
// (10 or 13 floats through __ldg), recomputes half_b, c_term and the root
// choice with the forward's own rounded ops (sphere_terms), forms the
// analytic partials of t, writes d_rays and adds the record and joined-row
// partials into d_sph / d_quad / d_joined with float atomicAdd.  Miss lanes
// write d_rays = 0 and add nothing.
//
// Every per-lane value is the plain version's (closest_hit_bwd_reference)
// ops in its order, each an explicitly rounded intrinsic, so d_rays and
// every term added are bit-equal to it; only the order of the adds differs,
// and it changes from run to run, so the sums match the plain version
// within a float tolerance relative to the sum of |terms|, not bit for bit.
//
// What bounds it on an H100: the bytes are few (rays, kind, idx, dt and 28
// rows of drow in, d_rays out, one record per hit ray: under 300 bytes a
// ray), so the limit is the atomics: every ray that hits the same primitive
// adds into the same 36 addresses (9 record and 27 joined columns), which
// serialise in L2, and in scene 1 a large share of rays hit the ground
// sphere.  So the lanes of a warp that share a winner first sum their terms
// (__match_any_sync on the winner's joined row, then a shuffle tree over
// those peers) and one lane adds the sum: at most 32x fewer atomics on a
// shared winner, 12x faster on scene 1's train-step rays on an H100 (PERF.md,
// chip_smoke.py phase 9).  A column whose terms are all zero in a warp is
// skipped (lanes whose path has ended carry zero cotangents).
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// The sum of x over the lanes of `peers` (this lane's group: the lanes with
// its key), complete in the group's lowest lane.  Every lane of the warp
// calls it together.
__device__ __forceinline__ float sum_peers(unsigned peers, float x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));   // peers below this lane
  unsigned rest = peers & (0xfffffffeu << lane);    // peers above it
  while (__any_sync(0xffffffffu, rest != 0u)) {
    const int next = __ffs(rest);
    const float y = __shfl_sync(0xffffffffu, x, (next - 1) & 31);
    if (next) x = add(x, y);
    rest &= __ballot_sync(0xffffffffu, !(rank & 1));
    rank >>= 1;
  }
  return x;
}

// Adds the sum of v over each group of peers into its lead lane's dst; a
// column that is zero in every lane of the warp costs one vote.
__device__ __forceinline__ void warp_add(unsigned peers, bool lead, float v,
                                         float* dst) {
  if (!__any_sync(0xffffffffu, v != 0.0f)) return;
  v = sum_peers(peers, v);
  if (lead && v != 0.0f) atomicAdd(dst, v);
}

__global__ void __launch_bounds__(kThreads)
closest_hit_bwd_kernel(const float* __restrict__ rays, int R,
                       const int* __restrict__ kind,
                       const int* __restrict__ idx,
                       const float* __restrict__ dt,
                       const float* __restrict__ drow,
                       const float* __restrict__ sph,
                       const float* __restrict__ quad, int k_join,
                       int quad_base, float t_min,
                       float* __restrict__ d_rays, float* __restrict__ d_sph,
                       float* __restrict__ d_quad,
                       float* __restrict__ d_joined) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // out-of-range lanes of the last warp take part in the warp sums as misses
  const int k = i < R ? kind[i] : 0;
  const bool hit = k == kSphere || k == kQuad;
  const int j = hit ? idx[i] : 0;
  float g[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float part[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (hit) {
    const float dte = add(dt[i], drow[(size_t)kRowT * R + i]);
    const Ray r = load_ray(rays, R, i, t_min);
    if (k == kSphere) {
      const RowRec rec{sph + (size_t)j * kSphCols};
      float half_b, c_term;
      sphere_terms(r, rec, half_b, c_term);
      // the forward's root choice, bit for bit (sphere_test)
      const float disc = sub(mul(half_b, half_b), mul(r.a, c_term));
      const float sq = __fsqrt_rn(fmaxf(disc, 0.0f));
      const float root1 = sub(-half_b, sq);
      const bool far = !(root1 > r.tmin_a);
      const float root = far ? add(root1, mul(2.0f, sq)) : root1;
      // t = root / a, root = -half_b + sgn sqrt(disc); _t_winner's guards
      const float sgn = far ? 1.0f : -1.0f;
      const bool live = disc > 1e-30f;
      const float sq_g = __fsqrt_rn(fmaxf(disc, 1e-30f));
      const float two_sq = mul(2.0f, sq_g);
      const bool a_ok = r.a > 0.0f;
      const float a_g = a_ok ? r.a : 1.0f;
      const float G = div(dte, a_g);
      const float g_hb =
          mul(G, sub(live ? div(mul(sgn, half_b), sq_g) : 0.0f, 1.0f));
      const float g_ct = mul(G, live ? div(mul(-sgn, a_g), two_sq) : 0.0f);
      const float g_a =
          a_ok ? sub(mul(G, live ? div(mul(-sgn, c_term), two_sq) : 0.0f),
                     div(mul(G, root), a_g))
               : 0.0f;
      // half_b = o.d - c.d - tm cv.d;  c_term = |o|^2 - 2 c.o - 2 tm cv.o
      //   + (c.c - r^2) + tm (2c.cv) + tm^2 |cv|^2
      const float cx = rec(0), cy = rec(1), cz = rec(2);
      const float vx = rec(3), vy = rec(4), vz = rec(5);
      const float tm = r.tm;
      const float two_gct = mul(2.0f, g_ct), two_ga = mul(2.0f, g_a);
      part[0] = sub(mul(-g_hb, r.dx), mul(two_gct, r.ox));
      part[1] = sub(mul(-g_hb, r.dy), mul(two_gct, r.oy));
      part[2] = sub(mul(-g_hb, r.dz), mul(two_gct, r.oz));
      part[3] = mul(tm, part[0]);
      part[4] = mul(tm, part[1]);
      part[5] = mul(tm, part[2]);
      part[6] = g_ct;
      part[7] = mul(g_ct, tm);
      part[8] = mul(mul(g_ct, tm), tm);
      const float ex = sub(sub(r.ox, cx), mul(tm, vx));
      const float ey = sub(sub(r.oy, cy), mul(tm, vy));
      const float ez = sub(sub(r.oz, cz), mul(tm, vz));
      g[0] = add(mul(g_hb, r.dx), mul(two_gct, ex));
      g[1] = add(mul(g_hb, r.dy), mul(two_gct, ey));
      g[2] = add(mul(g_hb, r.dz), mul(two_gct, ez));
      g[3] = add(mul(g_hb, ex), mul(two_ga, r.dx));
      g[4] = add(mul(g_hb, ey), mul(two_ga, r.dy));
      g[5] = add(mul(g_hb, ez), mul(two_ga, r.dz));
      g[6] = add(mul(-g_hb, dot3(vx, vy, vz, r.dx, r.dy, r.dz)),
                 mul(g_ct, sub(add(rec(7), mul(mul(2.0f, tm), rec(8))),
                               mul(2.0f, dot3(vx, vy, vz, r.ox, r.oy,
                                              r.oz)))));
    } else {
      // t = (D - n.o) / (n.d): dD = 1/den, dn = -(o + t d)/den,
      // do = -n/den, dd = -t n/den
      const RowRec rec{quad + (size_t)j * kQuadCols};
      const float nx = rec(0), ny = rec(1), nz = rec(2), D = rec(3);
      const float den = dot3(nx, ny, nz, r.dx, r.dy, r.dz);
      const float den_g = fabsf(den) >= 1e-8f ? den : 1.0f;
      const float t = div(sub(D, dot3(nx, ny, nz, r.ox, r.oy, r.oz)), den_g);
      const float G = div(dte, den_g);
      part[0] = mul(-G, add(r.ox, mul(t, r.dx)));
      part[1] = mul(-G, add(r.oy, mul(t, r.dy)));
      part[2] = mul(-G, add(r.oz, mul(t, r.dz)));
      part[3] = G;
      const float gt = mul(-G, t);
      g[0] = mul(-G, nx); g[1] = mul(-G, ny); g[2] = mul(-G, nz);
      g[3] = mul(gt, nx); g[4] = mul(gt, ny); g[5] = mul(gt, nz);
    }
  }
  if (i < R) {
#pragma unroll
    for (int c = 0; c < 7; ++c) d_rays[(size_t)c * R + i] = g[c];
    d_rays[(size_t)7 * R + i] = 0.0f;
  }

  // the record partials (a quad's past its fourth are 0), then the row's
  // cotangent (the row is a gather of the joined table, so its transpose is
  // an add into the winner's row)
  const int gj = k == kQuad ? quad_base + j : j;
  float* rec_dst = k == kQuad ? d_quad + (size_t)j * kQuadCols
                              : d_sph + (size_t)j * kSphCols;
  float* row_dst = d_joined + (size_t)gj * k_join;
  const unsigned peers = __match_any_sync(0xffffffffu, hit ? gj : -1);
  const bool lead = hit && (int)(threadIdx.x & 31) == __ffs(peers) - 1;
#pragma unroll
  for (int c = 0; c < 9; ++c) warp_add(peers, lead, part[c], rec_dst + c);
  for (int c = 0; c < k_join; ++c)
    warp_add(peers, lead, hit ? drow[(size_t)c * R + i] : 0.0f, row_dst + c);
}

// Launches the forward kernel of `mode`, counting its tests when kCount.
template <bool kCount>
void launch(int mode, dim3 grid, cudaStream_t s, const float* rays, int R,
            const float* sph, int n_sph, const float* quad, int n_quad,
            const float* joined, int k_join, int quad_base, float t_min,
            const float* accel, int n_sph_sub, int n_accel, float* row_out,
            unsigned long long* n_tests) {
  if (mode == kModeNone)
    closest_hit_kernel<kCount><<<grid, kThreads, 0, s>>>(
        rays, R, sph, n_sph, quad, n_quad, joined, k_join, quad_base, t_min,
        row_out, n_tests);
  else if (mode == kModeCull)
    closest_hit_cull_kernel<kCount><<<grid, kThreads, 0, s>>>(
        rays, R, sph, n_sph, quad, n_quad, joined, k_join, quad_base, t_min,
        accel, n_sph_sub, n_accel, row_out, n_tests);
  else
    closest_hit_bvh_kernel<kCount><<<grid, kThreads, 0, s>>>(
        rays, R, sph, n_sph, quad, n_quad, joined, k_join, quad_base, t_min,
        accel, n_sph_sub, n_accel, row_out, n_tests);
}

}  // namespace

extern "C" {

// Launches the kernel of `mode` (0 "none", 1 "cull", 2 "bvh") on `stream`
// and returns cudaGetLastError() (0 on success).  `accel` is the cull boxes
// [n_accel, 8] (mode 1) or the heap [2 * n_accel, 6] with n_accel = L
// (mode 2); unused in mode 0.  Allocates nothing; `row_out` is a [32, R]
// float32 buffer.  `n_tests`: null, or two counters to which the launch
// adds the sphere and quad tests it performs (the results do not change).
int mort_closest_hit(const float* rays, int R, const float* sph, int n_sph,
                     const float* quad, int n_quad, const float* joined,
                     int k_join, int quad_base, float t_min, int mode,
                     const float* accel, int n_sph_sub, int n_accel,
                     float* row_out, unsigned long long* n_tests,
                     void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((R + kThreads - 1) / kThreads));
  if (mode < kModeNone || mode > kModeBvh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tests == nullptr) {
    launch<false>(mode, grid, s, rays, R, sph, n_sph, quad, n_quad, joined,
                  k_join, quad_base, t_min, accel, n_sph_sub, n_accel,
                  row_out, n_tests);
  } else {
    launch<true>(mode, grid, s, rays, R, sph, n_sph, quad, n_quad, joined,
                 k_join, quad_base, t_min, accel, n_sph_sub, n_accel, row_out,
                 n_tests);
  }
  return (int)cudaGetLastError();
}

// Launches the backward kernel on `stream` and returns cudaGetLastError().
// `kind`/`idx` are the forward's winner (int32 [R]), `dt` [R] and `drow`
// [32, R] the cotangents; `d_rays` [8, R] is written, and `d_sph` [Ns, 10],
// `d_quad` [Nq, 13] and `d_joined` [*, k_join] are added into: the caller
// zeroes them.  Allocates nothing.
int mort_closest_hit_bwd(const float* rays, int R, const int* kind,
                         const int* idx, const float* dt, const float* drow,
                         const float* sph, const float* quad, int k_join,
                         int quad_base, float t_min, float* d_rays,
                         float* d_sph, float* d_quad, float* d_joined,
                         void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((R + kThreads - 1) / kThreads));
  closest_hit_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      rays, R, kind, idx, dt, drow, sph, quad, k_join, quad_base, t_min,
      d_rays, d_sph, d_quad, d_joined);
  return (int)cudaGetLastError();
}

const char* mort_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
