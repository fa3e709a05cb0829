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
//           (cluster_tree), with a per-ray stack of kStack nodes.
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

// One sphere record against the ray: keeps the lexicographic minimum of
// (a-scaled root, row) in (best, best_i).
template <class Rec>
__device__ __forceinline__ void sphere_test(const Ray& r, Rec rec, int row,
                                            float& best, int& best_i) {
  if (rec(9) == 0.0f) return;   // skip / padding row
  const float cx = rec(0), cy = rec(1), cz = rec(2);
  const float vx = rec(3), vy = rec(4), vz = rec(5);
  const float half_b = sub(sub(r.ro_rd, dot3(r.dx, r.dy, r.dz, cx, cy, cz)),
                           dot3(r.tdx, r.tdy, r.tdz, vx, vy, vz));
  const float c_term = add(
      add(add(sub(sub(r.ro_sq, mul(2.0f, dot3(r.ox, r.oy, r.oz, cx, cy, cz))),
                  mul(2.0f, dot3(r.tox, r.toy, r.toz, vx, vy, vz))),
              rec(6)),
          mul(r.tm, rec(7))),
      mul(r.tt, rec(8)));
  const float disc = sub(mul(half_b, half_b), mul(r.a, c_term));
  if (!(disc >= 0.0f)) return;
  const float sq = __fsqrt_rn(disc);
  const float root1 = sub(-half_b, sq);
  const float root = root1 > r.tmin_a ? root1 : add(root1, mul(2.0f, sq));
  if (root > r.tmin_a && (root < best || (root == best && row < best_i))) {
    best = root;
    best_i = row;
  }
}

// One quad record against the ray: the general plane/window test, keeping
// the lexicographic minimum of (t, row) in (qt, qi).
template <class Rec>
__device__ __forceinline__ void quad_test(const Ray& r, Rec rec, int row,
                                          float& qt, int& qi) {
  if (rec(12) == 0.0f) return;
  const float nx = rec(0), ny = rec(1), nz = rec(2);
  const float den = dot3(nx, ny, nz, r.dx, r.dy, r.dz);
  if (!(fabsf(den) >= 1e-8f)) return;
  const float num = sub(rec(3), dot3(nx, ny, nz, r.ox, r.oy, r.oz));
  const float t = __fdiv_rn(num, den);
  if (!(t > r.t_min)) return;
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

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ rays, int R,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ quad, int n_quad,
                   const float* __restrict__ joined, int k_join,
                   int quad_base, float t_min, float* __restrict__ row_out) {
  __shared__ float s_sph[kSphCols][kThreads];
  __shared__ float s_quad[kQuadCols][kThreads];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < R;
  // ragged tail: compute on a real ray, so every thread reaches the barriers
  const Ray r = load_ray(rays, R, live ? i : R - 1, t_min);

  // ---- spheres: roots scaled by a ----
  float best = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < n_sph; base += kThreads) {
    const int n = min(kThreads, n_sph - base);
    __syncthreads();
    if (threadIdx.x < n) {
      const float* rec = sph + (size_t)(base + threadIdx.x) * kSphCols;
#pragma unroll
      for (int c = 0; c < kSphCols; ++c) s_sph[c][threadIdx.x] = rec[c];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j)
      sphere_test(r, TileRec{&s_sph[0][j]}, base + j, best, best_i);
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
    for (int j = 0; j < n; ++j)
      quad_test(r, TileRec{&s_quad[0][j]}, base + j, qt, qi);
  }

  if (!live) return;
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
// quad rows.
__device__ __forceinline__ void test_leaf(
    const Ray& r, int s, const float* __restrict__ sph, int n_sph,
    const float* __restrict__ quad, int n_quad, int n_sph_sub, float& best,
    int& best_i, float& qt, int& qi) {
  if (s < n_sph_sub) {
    const int end = min((s + 1) * kCL, n_sph);
    for (int j = s * kCL; j < end; ++j)
      sphere_test(r, RowRec{sph + (size_t)j * kSphCols}, j, best, best_i);
  } else {
    const int q = s - n_sph_sub;
    const int end = min((q + 1) * kCL, n_quad);
    for (int j = q * kCL; j < end; ++j)
      quad_test(r, RowRec{quad + (size_t)j * kQuadCols}, j, qt, qi);
  }
}

// "cull": every sub-cluster in order (spheres first), each behind its box.
__global__ void __launch_bounds__(kThreads)
closest_hit_cull_kernel(const float* __restrict__ rays, int R,
                        const float* __restrict__ sph, int n_sph,
                        const float* __restrict__ quad, int n_quad,
                        const float* __restrict__ joined, int k_join,
                        int quad_base, float t_min,
                        const float* __restrict__ boxes, int n_sph_sub,
                        int n_sub, float* __restrict__ row_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i, t_min);
  const float irx = slab_inv(r.dx), iry = slab_inv(r.dy), irz = slab_inv(r.dz);
  const float rcp_a = __frcp_rn(r.a);
  float best = CUDART_INF_F, qt = CUDART_INF_F;
  int best_i = 0, qi = 0;
  for (int s = 0; s < n_sub; ++s) {
    // spheres prune against their own best; quads (after every sphere)
    // against min(quad best, sphere best)
    const float bound = fminf(mul(best, rcp_a), qt);
    if (box_reachable(r, irx, iry, irz, boxes + (size_t)s * kBoxCols, bound))
      test_leaf(r, s, sph, n_sph, quad, n_quad, n_sph_sub, best, best_i, qt,
                qi);
  }
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
__global__ void __launch_bounds__(kThreads)
closest_hit_bvh_kernel(const float* __restrict__ rays, int R,
                       const float* __restrict__ sph, int n_sph,
                       const float* __restrict__ quad, int n_quad,
                       const float* __restrict__ joined, int k_join,
                       int quad_base, float t_min,
                       const float* __restrict__ tree, int n_sph_sub, int L,
                       float* __restrict__ row_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i, t_min);
  const float irx = slab_inv(r.dx), iry = slab_inv(r.dy), irz = slab_inv(r.dz);
  const float rcp_a = __frcp_rn(r.a);
  float best = CUDART_INF_F, qt = CUDART_INF_F;
  int best_i = 0, qi = 0;
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
      test_leaf(r, node - L, sph, n_sph, quad, n_quad, n_sph_sub, best,
                best_i, qt, qi);
    } else {
      const int c0 = 2 * node, c1 = c0 + 1;
      const bool c0_first =
          node_key(r, tree + (size_t)c0 * kNodeCols) <=
          node_key(r, tree + (size_t)c1 * kNodeCols);
      stack[sp++] = c0_first ? c1 : c0;   // far
      stack[sp++] = c0_first ? c0 : c1;   // near, popped first
    }
  }
  emit(r, best, best_i, qt, qi, joined, k_join, quad_base, R, i, row_out);
}

}  // namespace

extern "C" {

// Launches the kernel of `mode` (0 "none", 1 "cull", 2 "bvh") on `stream`
// and returns cudaGetLastError() (0 on success).  `accel` is the cull boxes
// [n_accel, 8] (mode 1) or the heap [2 * n_accel, 6] with n_accel = L
// (mode 2); unused in mode 0.  Allocates nothing; `row_out` is a [32, R]
// float32 buffer.
int mort_closest_hit(const float* rays, int R, const float* sph, int n_sph,
                     const float* quad, int n_quad, const float* joined,
                     int k_join, int quad_base, float t_min, int mode,
                     const float* accel, int n_sph_sub, int n_accel,
                     float* row_out, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((R + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kModeNone:
      closest_hit_kernel<<<grid, kThreads, 0, s>>>(
          rays, R, sph, n_sph, quad, n_quad, joined, k_join, quad_base,
          t_min, row_out);
      break;
    case kModeCull:
      closest_hit_cull_kernel<<<grid, kThreads, 0, s>>>(
          rays, R, sph, n_sph, quad, n_quad, joined, k_join, quad_base,
          t_min, accel, n_sph_sub, n_accel, row_out);
      break;
    case kModeBvh:
      closest_hit_bvh_kernel<<<grid, kThreads, 0, s>>>(
          rays, R, sph, n_sph, quad, n_quad, joined, k_join, quad_base,
          t_min, accel, n_sph_sub, n_accel, row_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mort_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
