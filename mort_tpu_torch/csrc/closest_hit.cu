// Closest sphere/quad hit + joined shading row.
//
// Replaces the JAX package's Pallas TPU kernel
// mort_tpu/render/pallas_intersect.py::_closest_hit (kernel body
// _make_kernel) in its three accel modes:
//
//   "none"  the sphere scan _sphere_chunk_best, the general-quad scan
//           _quad_gen_best, the axis-aligned-quad path _aaq_group_best (a
//           test specialised to each orientation group's axes), the
//           closed-box path _aab_best (as a slab cull in front of the
//           general face test), the merge and the row emit _emit_row (its
//           notes are at the kernel, below);
//   "cull"  the same tests over the CL-sized sub-clusters whose AABB
//           (cluster_boxes, widened: box_enters) a ray enters, laid out
//           sub-cluster-major in bins of those rays (notes at the kernels,
//           below);
//   "bvh"   traversal of an implicit heap whose leaves are single rows (the
//           JAX package's heap cluster_tree had 128-row leaves; notes at
//           the kernel, below);
//
// and the gradient of the closest hit, the closest_hit_bwd_* kernels (the
// _closest_hit_vjp bwd; their notes are at the kernels, below).
//
// The TPU version folded every per-(ray, primitive) product into
// limb-packed bf16 MXU dots, gathered the winner's row with a one-hot
// matmul, and traversed with one scalar stack per 1024-ray tile; all three
// existed only to serve the TPU.  Here they are plain float32 arithmetic,
// one indexed load, and a traversal per ray that visits children near-first
// by their slab entry.
//
// What bounds "none" and "cull" on an H100 is float32 issue (their notes,
// below).  "bvh" (one thread per ray) reads each visited node's or leaf's
// records from global memory (__ldg, L1/L2-resident for scenes of a few
// thousand primitives): its work is the tests a ray's pruning leaves it,
// and divergence between the rays of a warp.
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

#include <algorithm>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kSphCols = 10;    // cx cy cz vx vy vz c.c-r^2 2c.cv |cv|^2 surf
constexpr int kQuadCols = 13;   // n(3) D vxw(3) qa wxu(3) qb surf
constexpr int kRowK = 32;       // rows of the [32, R] output
constexpr int kRowT = 27;
constexpr int kRowKind = 28;
constexpr int kRowIdx = 29;
constexpr int kSphere = 1;
constexpr int kQuad = 2;
constexpr int kCL = 128;        // primitives per sub-cluster (closest_hit.CL)
constexpr int kBoxCols = 8;     // cull boxes: lo xyz, hi xyz, 0, 0; closed
                                // boxes: lo xyz, hi xyz, max |corner|, 0
constexpr float kTiny = 1e-30f; // slab substitute for a zero direction
constexpr int kModeNone = 0, kModeBvh = 2;   // "cull" (1): its own entry
constexpr int kAaqCols = 8;     // aaq_tab: n_k D a_i qa b_j qb row live
constexpr int kGroupCols = 5;   // aaq_groups: start n k i j

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

// Column c of a primitive record in a row of the table in global memory
// (the records staged in shared memory are Rec12 and Rec16, below).
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

// Component C (0, 1 or 2) of (x, y, z).
template <int C>
__device__ __forceinline__ float axis(float x, float y, float z) {
  if constexpr (C == 0) return x;
  else if constexpr (C == 1) return y;
  else return z;
}

// The test of one axis-aligned quad row of aaq_tab (closest_hit.aaq_tables:
// a = (n_k, D, a_i, qa), b = (b_j, qb, row, flag)) against the ray's
// components along its group's axes k, i, j: quad_test with the frame's
// exact zeros left out.  For a finite ray each dot3 of quad_test is exactly
// its one nonzero product (adding a zero product changes at most the sign of
// a zero, which no comparison sees), so den, num, t, alpha and beta are
// quad_test's bit for bit.  Keeps the lexicographic minimum of (t, row).
__device__ __forceinline__ void aaq_test(float ok, float dk, float oi,
                                         float di, float oj, float dj,
                                         float4 a, float4 b, float t_min,
                                         float& qt, int& qi) {
  const float den = mul(a.x, dk);
  if (!(fabsf(den) >= 1e-8f)) return;
  const float t = __fdiv_rn(sub(a.y, mul(a.x, ok)), den);
  if (!(t > t_min)) return;
  const float alpha = add(sub(mul(a.z, oi), a.w), mul(t, mul(a.z, di)));
  const float beta = add(sub(mul(b.x, oj), b.y), mul(t, mul(b.x, dj)));
  const int row = (int)b.z;
  if (alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f &&
      (t < qt || (t == qt && row < qi))) {
    qt = t;
    qi = row;
  }
}

// The rows [lo, hi) of one orientation group (normal along K, u along I, v
// along J; a = (n_k, D, a_i, qa), b = (b_j, qb, row, live)) against a
// finite ray; a skip row (live 0) is no test.  The axes are template
// parameters, so the ray's components are read from its own registers, not
// copied into six more.
template <bool kCount, int K, int I, int J>
__device__ __forceinline__ void aaq_rows(const Ray& r, const float4* rows,
                                         int lo, int hi, float& qt, int& qi,
                                         int& n_a) {
  for (int e = lo; e < hi; ++e) {
    const float4 b = __ldg(rows + 2 * e + 1);
    if (b.w == 0.0f) continue;
    aaq_test(axis<K>(r.ox, r.oy, r.oz), axis<K>(r.dx, r.dy, r.dz),
             axis<I>(r.ox, r.oy, r.oz), axis<I>(r.dx, r.dy, r.dz),
             axis<J>(r.ox, r.oy, r.oz), axis<J>(r.dx, r.dy, r.dz),
             __ldg(rows + 2 * e), b, r.t_min, qt, qi);
    if constexpr (kCount) ++n_a;
  }
}

// Every row of aaq_tab (`rows`, n of them) against the ray, group by group
// (`groups`, n_groups descriptors): aaq_rows on a finite ray; quad_test on
// each live row's record for a ray with a non-finite component, where
// quad_test's 0 * inf is NaN and aaq_test has no such product.  The rows
// and descriptors are read through __ldg (L1-resident, the same addresses
// for every thread): staging them in shared memory, in a pipelined phase
// of their own, and passing the descriptors by value were timed slower
// (PERF.md).
template <bool kCount>
__device__ __forceinline__ void aaq_scan(
    const Ray& r, const float4* __restrict__ rows, int n,
    const int* __restrict__ groups, int n_groups,
    const float* __restrict__ quad, float& qt, int& qi, int& n_a, int& n_q) {
  const bool finite = isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) &&
                      isfinite(r.dx) && isfinite(r.dy) && isfinite(r.dz);
  if (!finite) {
    for (int e = 0; e < n; ++e) {
      const float4 b = __ldg(rows + 2 * e + 1);
      if (b.w == 0.0f) continue;
      const int row = (int)b.z;
      quad_test(r, RowRec{quad + (size_t)row * kQuadCols}, row, qt, qi);
      if constexpr (kCount) ++n_q;
    }
    return;
  }
  for (int g = 0; g < n_groups; ++g) {
    const int* d = groups + g * kGroupCols;
    const int lo = __ldg(d), hi = lo + __ldg(d + 1);
    // the class u_axis * 3 + v_axis; the normal is the third axis
    switch (__ldg(d + 3) * 3 + __ldg(d + 4)) {
      case 1: aaq_rows<kCount, 2, 0, 1>(r, rows, lo, hi, qt, qi, n_a); break;
      case 2: aaq_rows<kCount, 1, 0, 2>(r, rows, lo, hi, qt, qi, n_a); break;
      case 3: aaq_rows<kCount, 2, 1, 0>(r, rows, lo, hi, qt, qi, n_a); break;
      case 5: aaq_rows<kCount, 0, 1, 2>(r, rows, lo, hi, qt, qi, n_a); break;
      case 6: aaq_rows<kCount, 1, 2, 0>(r, rows, lo, hi, qt, qi, n_a); break;
      case 7: aaq_rows<kCount, 0, 2, 1>(r, rows, lo, hi, qt, qi, n_a); break;
    }
  }
}

// Adds one thread's sphere, quad, box slab and axis-aligned quad test counts
// and its "cull" pairs (ray, entered sub-cluster) to n_tests[0..4].
__device__ __forceinline__ void add_counts(unsigned long long* n_tests,
                                           int n_s, int n_q, int n_b = 0,
                                           int n_a = 0, int n_p = 0) {
  if (n_s) atomicAdd(n_tests, (unsigned long long)n_s);
  if (n_q) atomicAdd(n_tests + 1, (unsigned long long)n_q);
  if (n_b) atomicAdd(n_tests + 2, (unsigned long long)n_b);
  if (n_a) atomicAdd(n_tests + 3, (unsigned long long)n_a);
  if (n_p) atomicAdd(n_tests + 4, (unsigned long long)n_p);
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
  for (int k = 0; k < kRowK; ++k) {
    float v = k < k_join ? src[k] : 0.0f;   // k_join <= kRowT
    if (k == kRowT) v = t;
    if (k == kRowKind) v = (float)kind;
    if (k == kRowIdx) v = (float)idx;
    row_out[(size_t)k * R + i] = v;
  }
}

// Reciprocal direction for the slab tests; |d| < kTiny becomes +-kTiny.
__device__ __forceinline__ float slab_inv(float d) {
  return 1.0f / (fabsf(d) < kTiny ? (d >= 0.0f ? kTiny : -kTiny) : d);
}

// Slab test of the box [lx, hx] x [ly, hy] x [lz, hz]: the ray enters it
// in (t_min, bound].  An inverted box (padding) is never entered.
__device__ __forceinline__ bool slab_enters(const Ray& r, float irx,
                                            float iry, float irz, float lx,
                                            float ly, float lz, float hx,
                                            float hy, float hz, float bound) {
  if (!(lx <= hx)) return false;
  const float x0 = (lx - r.ox) * irx, x1 = (hx - r.ox) * irx;
  const float y0 = (ly - r.oy) * iry, y1 = (hy - r.oy) * iry;
  const float z0 = (lz - r.oz) * irz, z1 = (hz - r.oz) * irz;
  const float lo = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float hi = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return lo <= hi && hi > r.t_min && lo <= bound;
}

// The slab test of "cull" and "bvh" (closest_hit.py: AAB_SLACK, SPHERE_ERR,
// sphere_pad).  Their boxes are widened so that every hit the sphere and
// quad tests report lies inside the boxes on its path: the expanded sphere
// quadratic cancels near silhouettes and, from far origins, reports hits
// several radii off a small sphere, far outside its box; a quad's +-1e-4
// pad is thinner than the rounding of its window test near coordinate
// 1000.  The pad of a box is kAabSlack (max |o| + its largest |coordinate|)
// plus, for a box of spheres, sphere_pad of that sum and their smallest
// radius; being concave in the sum it splits into a part per box, built
// into the table, and a part per ray, added here (from the scene's smallest
// sphere radius, which the table carries).
constexpr float kAabSlack = 1.52587890625e-05f;      // 2^-16, AAB_SLACK
constexpr float kSphereErr2 = 7.62939453125e-06f;    // 2 * 2^-18, SPHERE_ERR

// The per-ray terms of the slab tests: the reciprocal direction and the t
// offsets of the planes widened by the ray's part of the pad m,
// lo * ir - (o + m) * ir and hi * ir - (o - m) * ir.
struct Slab {
  float irx, iry, irz, lox, loy, loz, hix, hiy, hiz;
};

__device__ __forceinline__ Slab make_slab(const Ray& r, float r_min) {
  const float s = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  const float x = kSphereErr2 * s * s;
  // closest_hit.sphere_pad; 0 where r_min is BIG (no sphere)
  const float m = s * kAabSlack + x / (sqrtf(r_min * r_min + x) + r_min);
  Slab b;
  b.irx = slab_inv(r.dx); b.iry = slab_inv(r.dy); b.irz = slab_inv(r.dz);
  b.lox = (r.ox + m) * b.irx; b.hix = (r.ox - m) * b.irx;
  b.loy = (r.oy + m) * b.iry; b.hiy = (r.oy - m) * b.iry;
  b.loz = (r.oz + m) * b.irz; b.hiz = (r.oz - m) * b.irz;
  return b;
}

// Whether the ray enters the box [lx, hx] x [ly, hy] x [lz, hz], widened by
// the ray's part of the pad, in (t_min, bound]; `t_in` is its slab entry.
// An inverted box never.
__device__ __forceinline__ bool box_enters(const Slab& b, float lx, float hx,
                                           float ly, float hy, float lz,
                                           float hz, float t_min, float bound,
                                           float& t_in) {
  const float x0 = fmaf(lx, b.irx, -b.lox), x1 = fmaf(hx, b.irx, -b.hix);
  const float y0 = fmaf(ly, b.iry, -b.loy), y1 = fmaf(hy, b.iry, -b.hiy);
  const float z0 = fmaf(lz, b.irz, -b.loz), z1 = fmaf(hz, b.irz, -b.hiz);
  t_in = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float t_out =
      fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return lx <= hx && t_in <= t_out && t_out > t_min && t_in <= bound;
}

// ---- "none" ----
//
// Replaces _make_kernel's "none" branch: the sphere scan _sphere_chunk_best,
// the general-quad scan _quad_gen_best over the compacted table of
// pack_quads_general, the axis-aligned-quad path _aaq_group_best over
// pack_aaq's orientation groups, the closed-box path _aab_best, the merge
// and _emit_row.
//
// Each ray scans (1) every sphere, (2) every quad that is neither
// axis-aligned nor a face of a closed axis-aligned box (gen_rows, with their
// registry rows as ids), (3) every axis-aligned quad (aaq_tab), group by
// group with aaq_test on the ray's components along the group's axes
// (aaq_rows, one instantiation for each of the six orientations), and (4)
// every box of SceneMeta.aab behind a slab test, running quad_test on a
// box's six faces (read through __ldg by registry row) only where the ray
// enters it.  _aaq_group_best's own t, (Q_k - ro_k) * (1 / rd_k), is an ulp
// away from the general test's and is not taken: aaq_test is the general
// test's arithmetic (above).  A ray with a non-finite component (where quad_test's 0 * inf is NaN and
// aaq_test has no such product) and a row whose frame is no longer
// axis-aligned (flag 2) take quad_test on the row instead, so every ray gets
// the plain scan's result.
//
// The lexicographic (t, row) minimum does not depend on the order of the
// visits, and a box is entered whenever it could hold a face hit at
// t <= bound, ties included, so the result is the plain scan's bit for bit.  _aab_best's own arithmetic (t read off the slab, the face from
// the axis that attains it) is not taken: that t is an ulp away from the
// general (D - n.o)/(n.d), and the slab here only decides which faces are
// tested.  The box is widened by kAabSlack (max |o| + max |corner|) before
// its slab test (box_admits): the 1e-4 pad alone is thinner than the
// rounding of the window test at coordinates near 1000 (PERF.md).
//
// What bounds it on an H100: instruction issue.  A sphere test is 34
// rounded float ops (none may fuse into an FMA) and ~45 instructions on
// its common path; a quad test is 12 counted ops but as many instructions
// (13 loads, an IEEE division); a box slab test 36 ops.  So scene 9 (1,007
// spheres, one axis-aligned quad and 400 boxes, of whose faces a ray tests
// a few) issues ~60 k instructions a ray where testing all 2,401 quads issued
// ~150 k.  What the design does about it:
// - records are staged in shared memory padded to 16-byte multiples (a
//   sphere in 12 floats, a quad in 16 with its registry row, a box in 8),
//   so a test reads its record in 3-4 float4 broadcasts, not 10-13 scalar
//   loads;
// - tiles are copied with cp.async into a two-stage buffer, the next
//   tile's copy in flight while the block tests the current one; one 32 KB
//   buffer serves the three staged phases;
// - an axis-aligned quad test is 4 rounded ops up to its t test (the
//   general test's 12) and reads its record in two float4 loads.  On
//   scene 7's six it still costs more than the general test did inside the
//   general quads' tile (a group a switch, few rows a group; PERF.md).
// One thread a ray.  Threads sharing a ray (2 or 4, each testing every
// S-th record, merged by shuffles) and two rays a thread (a record loaded
// once serving two tests) were built and timed: neither was faster on the
// rays of scene 1 (R = 2^18) or scene 9 (R = 2^16) (PERF.md).

constexpr int kStage = 4096;       // floats in one stage of the tile buffer
constexpr int kSphF = 12;          // staged sphere: kSphCols, 2 pad
constexpr int kQuadF = 16;         // staged quad: kQuadCols, row id, 2 pad
constexpr int kTile = 256;         // spheres or quads per tile
constexpr int kBoxTile = kStage / kBoxCols;   // 512 boxes per tile

struct Rec12 {
  float v[12];
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};
struct Rec16 {
  float v[16];
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};

__device__ __forceinline__ Rec12 lds_sph(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1], c = q[2];
  return Rec12{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w}};
}

__device__ __forceinline__ Rec16 lds_quad(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1], c = q[2], d = q[3];
  return Rec16{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w,
                d.x, d.y, d.z, d.w}};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Runs body(tile, base, n) over [0, n_total) in tiles of `tile` records,
// stage(dst, base, n) copying each tile into one half of `buf` while the
// block works on the other.  Every thread of the block calls it together.
template <class Stage, class Body>
__device__ __forceinline__ void pipelined(int n_total, int tile, float* buf,
                                          Stage stage, Body body) {
  if (n_total <= 0) return;
  stage(buf, 0, min(tile, n_total));
  cp_async_commit();
  int half = 0;
  for (int base = 0; base < n_total; base += tile, half ^= 1) {
    const int next = base + tile;
    if (next < n_total) {
      stage(buf + (half ^ 1) * kStage, next, min(tile, n_total - next));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(buf + half * kStage, base, min(tile, n_total - base));
    __syncthreads();
  }
}

// Whether the ray may hit a face of the staged box (lo = a.xyz, hi = (a.w,
// b.x, b.y), b.z = max |corner|) at t in (t_min, bound]: slab_enters on the
// box widened by kAabSlack (s_ray + b.z), s_ray = max |o|.  A face hit that
// quad_test reports lies within ~8 ulps of s_ray + b.z of the box (the
// rounding of its t and window terms); the widening is 2^4 times that.
// Without it, rays aimed at box edges from far origins lose winning faces
// (tests/test_torch_box_cull.py).
__device__ __forceinline__ bool box_admits(const Ray& r, float irx, float iry,
                                           float irz, float s_ray, float4 a,
                                           float4 b, float bound) {
  const float m = (s_ray + b.z) * kAabSlack;
  return slab_enters(r, irx, iry, irz, a.x - m, a.y - m, a.z - m, a.w + m,
                     b.x + m, b.y + m, bound);
}

// kCount: also count the tests into n_tests (a separate instantiation, so
// the uncounted kernels carry no counting code).  Six blocks an SM (40
// registers) ran faster than five (48) and eight (32, spilling).
template <bool kCount>
__global__ void __launch_bounds__(kThreads, 6)
closest_hit_none_kernel(const float* __restrict__ rays, int R,
                        const float* __restrict__ sph, int n_sph,
                        const float* __restrict__ quad,
                        const int* __restrict__ gen_rows, int n_gen,
                        const float* __restrict__ boxes,
                        const int* __restrict__ faces, int n_box,
                        const float* __restrict__ aaq,
                        const int* __restrict__ groups, int n_aaq,
                        int n_groups,
                        const float* __restrict__ joined, int k_join,
                        int quad_base, float t_min,
                        float* __restrict__ row_out,
                        unsigned long long* __restrict__ n_tests) {
  __shared__ __align__(16) float s_buf[2 * kStage];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool live = i < R;
  // ragged tail: compute on a real ray, so every thread reaches the barriers
  const Ray r = load_ray(rays, R, live ? i : R - 1, t_min);
  float best = CUDART_INF_F, qt = CUDART_INF_F;
  int best_i = 0, qi = 0, n_s = 0, n_q = 0, n_b = 0, n_a = 0;

  // ---- 1. spheres: roots scaled by a ----
  pipelined(
      n_sph, kTile, s_buf,
      [&](float* dst, int base, int n) {
        const float* src = sph + (size_t)base * kSphCols;
        for (int e = tid; e < n * kSphCols; e += kThreads) {
          const int j = e / kSphCols;
          cp_async4(dst + j * kSphF + (e - j * kSphCols), src + e);
        }
      },
      [&](const float* tile, int base, int n) {
        for (int j = 0; j < n; ++j) {
          const bool tested = sphere_test(r, lds_sph(tile + j * kSphF),
                                          base + j, best, best_i);
          if constexpr (kCount) n_s += tested;
        }
      });

  // ---- 2. the quads that are no box's face, by registry row ----
  pipelined(
      n_gen, kTile, s_buf,
      [&](float* dst, int base, int n) {
        for (int e = tid; e < n * kQuadCols; e += kThreads) {
          const int j = e / kQuadCols, c = e - j * kQuadCols;
          const int row = __ldg(gen_rows + base + j);
          cp_async4(dst + j * kQuadF + c, quad + (size_t)row * kQuadCols + c);
        }
        if (tid < n)
          dst[tid * kQuadF + kQuadCols] = __int_as_float(
              __ldg(gen_rows + base + tid));
      },
      [&](const float* tile, int base, int n) {
        for (int j = 0; j < n; ++j) {
          const Rec16 rec = lds_quad(tile + j * kQuadF);
          const bool tested =
              quad_test(r, rec, __float_as_int(rec.v[kQuadCols]), qt, qi);
          if constexpr (kCount) n_q += tested;
        }
      });

  // ---- 3. the axis-aligned quads, group by group ----
  if (n_aaq > 0)
    aaq_scan<kCount>(r, reinterpret_cast<const float4*>(aaq), n_aaq, groups,
                     n_groups, quad, qt, qi, n_a, n_q);

  // ---- 4. closed boxes: a slab test, then the faces of an entered box ----
  if (n_box > 0) {
    const float irx = slab_inv(r.dx), iry = slab_inv(r.dy);
    const float irz = slab_inv(r.dz);
    const float s_ray = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
    const float rcp_a = __frcp_rn(r.a);
    pipelined(
        n_box, kBoxTile, s_buf,
        [&](float* dst, int base, int n) {
          const float* src = boxes + (size_t)base * kBoxCols;
          for (int e = tid; e < n * (kBoxCols / 4); e += kThreads)
            cp_async16(dst + 4 * e, src + 4 * e);
        },
        [&](const float* tile, int base, int n) {
          const float4* t4 = reinterpret_cast<const float4*>(tile);
          for (int j = 0; j < n; ++j) {
            if constexpr (kCount) ++n_b;
            const float bound = fminf(mul(best, rcp_a), qt);
            if (!box_admits(r, irx, iry, irz, s_ray, t4[2 * j], t4[2 * j + 1],
                            bound))
              continue;
            const int* f = faces + (size_t)(base + j) * 6;
            for (int q = 0; q < 6; ++q) {
              const int row = __ldg(f + q);
              const bool tested = quad_test(
                  r, RowRec{quad + (size_t)row * kQuadCols}, row, qt, qi);
              if constexpr (kCount) n_q += tested;
            }
          }
        });
  }

  if (!live) return;
  if constexpr (kCount) add_counts(n_tests, n_s, n_q, n_b, n_a);
  emit(r, best, best_i, qt, qi, joined, k_join, quad_base, R, i, row_out);
}

// ---- "bvh" ----
//
// Replaces _make_kernel's "bvh" branch (the walk over cluster_tree's heap of
// 128-row sub-clusters).  On the TPU a 128-lane leaf was one vector step;
// here one thread runs one ray, and a warp pays a leaf's tests whenever one
// of its lanes enters it, so a leaf is one row (closest_hit.bvh_tree): the
// implicit heap over the rows, sphere rows first (leaf s < n_sph is sphere
// row s), then quad rows, each kind in the scene builder's Morton order.
// Leaves of 1, 2 and 4 rows were timed; 1 was the fastest on every ray set
// (PERF.md).
//
// Node k (a row of 12 floats, 16-byte aligned) holds the widened boxes of
// both children, axis by axis, so a visit is three float4 loads through the
// read-only path and two slab tests.  The ray goes on into the entered
// child with the smaller slab entry; if both were entered it marks the
// node's depth in `trail`, a 32-bit stack of one bit a level.  At a leaf or
// a dead end it resumes at the sibling of the node it took at the deepest
// marked depth (the heap's indices give it: node >> (depth - level - 1),
// xor 1), so the traversal state is four registers, with nothing in local
// memory.  A resumed child is not slab-tested again: its own two children
// are, against the bound of that moment.  Node row 0 carries the scene's
// smallest sphere radius for the per-ray part of the pad.
//
// Its work on camera and bounce rays: ~6.5 visits and ~0.4 sphere tests a
// ray on spread16k, ~37 visits and ~2 row tests on scene 9 (PERF.md); its
// time on spread16k is ~7x the bytes bound, and how node-load latency and
// divergence share that is not measured.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
closest_hit_bvh_kernel(const float* __restrict__ rays, int R,
                       const float* __restrict__ sph, int n_sph,
                       const float* __restrict__ quad, int n_quad,
                       const float* __restrict__ joined, int k_join,
                       int quad_base, float t_min,
                       const float4* __restrict__ nodes, int L,
                       float* __restrict__ row_out,
                       unsigned long long* __restrict__ n_tests) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i, t_min);
  const Slab b = make_slab(r, __ldg(&nodes[0].x));
  const float rcp_a = __frcp_rn(r.a);
  float best = CUDART_INF_F, qt = CUDART_INF_F;
  int best_i = 0, qi = 0, n_s = 0, n_q = 0, n_b = 0;
  unsigned trail = 0u;   // bit d: the other child at depth d is owed
  int node = 1, depth = 0;
  for (;;) {
    if (node < L) {
      const float4* p = nodes + 3 * node;
      const float4 x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
      const float bound = fminf(mul(best, rcp_a), qt);
      float t0, t1;
      const bool e0 =
          box_enters(b, x.x, x.y, y.x, y.y, z.x, z.y, t_min, bound, t0);
      const bool e1 =
          box_enters(b, x.z, x.w, y.z, y.w, z.z, z.w, t_min, bound, t1);
      if constexpr (kCount) n_b += 2;
      if (e0 || e1) {
        if (e0 && e1) trail |= 1u << depth;
        node = 2 * node + (e0 && e1 ? (t1 < t0) : e1);
        ++depth;
        continue;
      }
    } else {
      // an entered leaf is a real row (padding leaves are inverted)
      const int j = node - L;
      if (j < n_sph) {
        const bool tested = sphere_test(r, RowRec{sph + (size_t)j * kSphCols},
                                        j, best, best_i);
        if constexpr (kCount) n_s += tested;
      } else {
        const int q = j - n_sph;
        const bool tested =
            quad_test(r, RowRec{quad + (size_t)q * kQuadCols}, q, qt, qi);
        if constexpr (kCount) n_q += tested;
      }
    }
    if (trail == 0u) break;
    const int level = 31 - __clz(trail);   // the deepest owed child
    trail ^= 1u << level;
    node = (node >> (depth - level - 1)) ^ 1;
    depth = level + 1;
  }
  if constexpr (kCount) add_counts(n_tests, n_s, n_q, n_b);
  emit(r, best, best_i, qt, qi, joined, k_join, quad_base, R, i, row_out);
}

// ---- backward ----
//
// Replaces the JAX package's _closest_hit_vjp bwd (pallas_intersect.py,
// with _t_winner): there a chunked one-hot MXU gather of the winners'
// coefficient rows and a transposed one-hot segment sum per chunk, whose
// chunks a lax.scan adds in order.  Here six kernels on one stream:
//
//   closest_hit_bwd_tile_kernel    one thread per ray reads its winner's
//       record (10 or 13 floats through __ldg), recomputes half_b, c_term
//       and the root choice with the forward's own rounded ops
//       (sphere_terms), forms the analytic partials of t and writes d_rays;
//       a block is a tile of kThreads consecutive lanes, which sums the
//       terms of its lanes (9 record partials and k_join joined-row
//       cotangents) by winner key gj (idx for a sphere, quad_base + idx for
//       a quad) into runs, one per key the tile holds, sorted by key, and
//       marks each key's tile in a presence bitmap;
//   closest_hit_bwd_count_kernel, _offsets_kernel and _place_kernel   a
//       stable counting sort of the runs by key: each key's tiles before
//       every 32-tile word of the bitmap, each key's first slot (an
//       exclusive scan of the counts), and each run's slot, in tile order;
//   closest_hit_bwd_chunk_kernel  one warp sums each aligned 32-run chunk
//       of a key's runs;
//   closest_hit_bwd_key_kernel  one warp a key sums its chunks and writes
//       the key's rows of d_sph, d_quad and d_joined.
//
// The order of the adds.  Every sum is a pairwise tree (adjacent pairs at
// each level, the last of an odd count carried up): level 1a over the lanes
// of a warp that share a key, in lane order; level 1b over the warps of the
// tile that hold the key, in warp order; level 2 over the tiles that hold
// the key, in tile order (as the trees of its aligned 32-run chunks, which
// are the whole tree's subtrees, summed by the same tree over the chunks).
// The tree depends only on R, the lane order and the keys, never on
// scheduling, so two launches give the same bits, and
// closest_hit_bwd_ordered in closest_hit.py, the plain mirror of this
// order, gives them too.  No float atomic: atomicOr sets presence bits,
// whose result does not depend on the order of the ORs.
//
// Every per-lane value is the plain version's (closest_hit_bwd_reference)
// ops in its order, each an explicitly rounded intrinsic, so d_rays and
// every term are bit-equal to it; the sums differ from its index_add_ only
// in their order.
//
// What bounds it on an H100: bytes (rays, kind, idx, dt and 28 rows of drow
// in, d_rays out, one record per hit ray: under 300 bytes a ray).  The runs
// add 4 (k_join + 10) bytes each, written and read back once (L2-resident at
// the train step's R); coherent rays give a few runs a tile.  An earlier
// kernel added every warp's sums into the tables with float atomics: on
// scene 1's rays, which mostly hit the ground sphere, they serialised in L2,
// 0.103 of its 0.143 ms on an H100 (PERF.md).
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;          // warps of a tile
constexpr int kRecTerms = 9;                   // record partials of a lane
constexpr int kMaxCols = kRecTerms + kRowT;    // + at most 27 joined columns
constexpr int kPitch = kMaxCols + 1;           // shared rows without bank
                                               // conflicts
constexpr int kChunk = 32;                     // runs of a level-2 chunk
constexpr int kLevels = 9;                     // level-2 counter depth over
                                               // groups of 32 chunks: a key
                                               // has at most 2^18 runs (R <
                                               // 2^26), 256 groups
constexpr int kScanThreads = 1024;             // the offsets kernel's block

// Lane i's d_rays (g) and record partials (part[0..8]; a quad writes its
// first four, the rest stay 0) for its winner: kind k, row j.
__device__ __forceinline__ void lane_terms(
    const float* __restrict__ rays, int R, int i, int k, int j,
    const float* __restrict__ dt, const float* __restrict__ drow,
    const float* __restrict__ sph, const float* __restrict__ quad,
    float t_min, float g[7], float (&part)[kMaxCols]) {
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
                             mul(2.0f, dot3(vx, vy, vz, r.ox, r.oy, r.oz)))));
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

// Level 1a's schedule, the same for every column: at step s (while any
// lane of the warp has a peer left) a lane adds the partial of src[s], its
// next surviving peer above, where bit s of adds is set; a peer survives
// step s when its rank among the peers is a multiple of 2^(s+1).  That is
// the pairwise tree over the ranks, complete in the group's lowest lane.
struct PeerTree {
  int src[5];
  unsigned adds;
  int steps;

  __device__ __forceinline__ explicit PeerTree(unsigned peers) {
    const int lane = threadIdx.x & 31;
    int rank = __popc(peers & ((1u << lane) - 1u));   // peers below
    unsigned rest = peers & (0xfffffffeu << lane);    // peers above
    adds = 0u;
    steps = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      src[s] = lane;
      if (!__any_sync(kFull, rest != 0u)) break;
      const int next = __ffs(rest);
      if (next) {
        src[s] = next - 1;
        adds |= 1u << s;
      }
      rest &= __ballot_sync(kFull, !(rank & 1));
      rank >>= 1;
      steps = s + 1;
    }
  }

  // The sums of each x[c] over this lane's peers, all columns a step at a
  // time (their shuffles in flight together); every lane of the warp calls
  // it.
  __device__ __forceinline__ void sum(float (&x)[kMaxCols]) const {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (s >= steps) break;
      const bool take = adds >> s & 1u;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const float y = __shfl_sync(kFull, x[c], src[s]);
        if (take) x[c] = add(x[c], y);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads, 4)
closest_hit_bwd_tile_kernel(const float* __restrict__ rays, int R,
                            const int* __restrict__ kind,
                            const int* __restrict__ idx,
                            const float* __restrict__ dt,
                            const float* __restrict__ drow,
                            const float* __restrict__ sph,
                            const float* __restrict__ quad, int k_join,
                            int quad_base, float t_min,
                            float* __restrict__ d_rays,
                            int* __restrict__ run_key,
                            float* __restrict__ run_val,
                            int* __restrict__ tile_runs,
                            unsigned* __restrict__ present, int n_words) {
  __shared__ float s_val[kThreads][kPitch];   // entry rows: warp sums
  __shared__ int s_key[kThreads];             // entry keys, warp by warp
  __shared__ int s_order[kThreads];           // entries sorted by key, warp
  __shared__ int s_start[kThreads + 1];       // first sorted entry of a run
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int tile = blockIdx.x;
  const int i = tile * kThreads + threadIdx.x;
  // out-of-range lanes of the last tile take part as misses
  const int k = i < R ? kind[i] : 0;
  const bool hit = k == kSphere || k == kQuad;
  const int j = hit ? idx[i] : 0;
  // the lane's terms: its record partials, then the joined-row cotangents
  // (all loads in flight at once; one column at a time, each load's
  // latency would stand alone before its tree)
  float x[kMaxCols];
#pragma unroll
  for (int c = 0; c < kRowT; ++c)
    x[kRecTerms + c] = hit && c < k_join ? drow[(size_t)c * R + i] : 0.0f;
  float g[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < kRecTerms; ++c) x[c] = 0.0f;
  if (hit) lane_terms(rays, R, i, k, j, dt, drow, sph, quad, t_min, g, x);
  if (i < R) {
#pragma unroll
    for (int c = 0; c < 7; ++c) d_rays[(size_t)c * R + i] = g[c];
    d_rays[(size_t)7 * R + i] = 0.0f;
  }

  // level 1a: the lanes of the warp that share a key (a miss, keyed apart,
  // is alone and adds nothing); each group's lowest lane holds its sums
  const int key = !hit ? -1 - lane : k == kQuad ? quad_base + j : j;
  const unsigned peers = __match_any_sync(kFull, key);
  const bool lead = hit && (peers & below) == 0u;
  const PeerTree tree(peers);
  const unsigned leads = __ballot_sync(kFull, lead);
  if (lane == 0) s_warp[warp] = __popc(leads);
  __syncthreads();
  int row = 0, n_ent = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    row += w < warp ? s_warp[w] : 0;
    n_ent += s_warp[w];
  }
  row += __popc(leads & below);
  tree.sum(x);
  if (lead) {
    s_key[row] = key;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) s_val[row][c] = x[c];
  }
  __syncthreads();
  if (n_ent == 0) {
    if (threadIdx.x == 0) tile_runs[tile] = 0;
    return;
  }

  // level 1b: the entries sorted by (key, warp): an entry's slot is the
  // count of entries before it in that order
  if (threadIdx.x < n_ent) {
    const int e = threadIdx.x, ke = s_key[e];
    int pos = 0;
    for (int f = 0; f < n_ent; ++f) {
      const int kf = s_key[f];
      pos += kf < ke || (kf == ke && f < e);
    }
    s_order[pos] = e;
  }
  __syncthreads();
  const int p = threadIdx.x;
  const bool first = p < n_ent && (p == 0 || s_key[s_order[p - 1]] !=
                                                 s_key[s_order[p]]);
  const unsigned firsts = __ballot_sync(kFull, first);
  if (lane == 0) s_warp[warp] = __popc(firsts);
  __syncthreads();
  int run = 0, n_runs = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    run += w < warp ? s_warp[w] : 0;
    n_runs += s_warp[w];
  }
  run += __popc(firsts & below);
  if (first) s_start[run] = p;
  if (threadIdx.x == 0) s_start[n_runs] = n_ent;
  __syncthreads();

  // each run's columns: the pairwise tree over its (at most kWarps)
  // entries, in warp order
  const int nc = kRecTerms + k_join;
  float* out = run_val + (size_t)tile * kThreads * nc;
  for (int w = threadIdx.x; w < n_runs * nc; w += kThreads) {
    const int r = w / nc, c = w - r * nc;
    const int p0 = s_start[r], n = s_start[r + 1] - p0;
    float v[kWarps];
#pragma unroll
    for (int q = 0; q < kWarps; ++q)
      v[q] = q < n ? s_val[s_order[p0 + q]][c] : 0.0f;
#pragma unroll
    for (int s = 1; s < kWarps; s *= 2) {
#pragma unroll
      for (int q = 0; q + s < kWarps; q += 2 * s)
        if (q + s < n) v[q] = add(v[q], v[q + s]);
    }
    out[w] = v[0];
  }
  if (threadIdx.x < n_runs) {
    const int kk = s_key[s_order[s_start[threadIdx.x]]];
    run_key[(size_t)tile * kThreads + threadIdx.x] = kk;
    atomicOr(present + (size_t)kk * n_words + (tile >> 5),
             1u << (tile & 31));
  }
  if (threadIdx.x == 0) tile_runs[tile] = n_runs;
}

// For each key (one warp each): prefix[key][w], the tiles below word w of
// its presence bitmap that hold it, and count[key], all of them.
__global__ void __launch_bounds__(kThreads)
closest_hit_bwd_count_kernel(const unsigned* __restrict__ present,
                             int n_keys, int n_words,
                             int* __restrict__ prefix,
                             int* __restrict__ count) {
  const int key = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (key >= n_keys) return;
  int carry = 0;
  for (int w0 = 0; w0 < n_words; w0 += 32) {
    const int w = w0 + lane;
    const size_t at = (size_t)key * n_words + w;
    const int n = w < n_words ? __popc(present[at]) : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (w < n_words) prefix[at] = carry + incl - n;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) count[key] = carry;
}

// The exclusive scan of v over a block of kScanThreads threads (each
// thread's v its share of the keys); s is kScanThreads / 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();   // s is free (an earlier scan's readers are done)
  if (lane == 31) s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = s[lane];
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    s[lane] = inc - x;
  }
  __syncthreads();
  return s[warp] + incl - v;
}

// offset[key]: the exclusive scan of count, and chunk_off[key] that of its
// level-2 chunks, ceil(count / kChunk); offset[n_keys] and
// chunk_off[n_keys], the runs and the chunks in all.  One block: each
// thread scans a contiguous share of the keys.
__global__ void __launch_bounds__(kScanThreads)
closest_hit_bwd_offsets_kernel(const int* __restrict__ count, int n_keys,
                               int* __restrict__ offset,
                               int* __restrict__ chunk_off) {
  __shared__ int s_sum[kScanThreads / 32];
  const int per = (n_keys + kScanThreads - 1) / kScanThreads;
  const int k0 = min((int)threadIdx.x * per, n_keys);
  const int k1 = min(k0 + per, n_keys);
  int runs = 0, chunks = 0;
  for (int k = k0; k < k1; ++k) {
    runs += count[k];
    chunks += (count[k] + kChunk - 1) / kChunk;
  }
  int at = block_exclusive_scan(runs, s_sum);
  int ch = block_exclusive_scan(chunks, s_sum);
  for (int k = k0; k < k1; ++k) {
    offset[k] = at;
    chunk_off[k] = ch;
    at += count[k];
    ch += (count[k] + kChunk - 1) / kChunk;
  }
  if (threadIdx.x == kScanThreads - 1) {
    offset[n_keys] = at;
    chunk_off[n_keys] = ch;
  }
}

// order[slot]: the runs of each key in tile order, from integer counts
// alone: a run's slot is its key's offset plus its rank, the key's tiles
// below its tile.  The run of rank 32 g starts the key's chunk g.
__global__ void __launch_bounds__(kThreads)
closest_hit_bwd_place_kernel(const int* __restrict__ run_key,
                             const int* __restrict__ tile_runs,
                             const unsigned* __restrict__ present,
                             const int* __restrict__ prefix,
                             const int* __restrict__ offset,
                             const int* __restrict__ chunk_off, int n_words,
                             int* __restrict__ order,
                             int* __restrict__ chunk_first,
                             int* __restrict__ chunk_key) {
  const int tile = blockIdx.x;
  if ((int)threadIdx.x >= tile_runs[tile]) return;
  const int run = tile * kThreads + threadIdx.x;
  const int key = run_key[run];
  const size_t w = (size_t)key * n_words + (tile >> 5);
  const int rank =
      prefix[w] + __popc(present[w] & ((1u << (tile & 31)) - 1u));
  const int slot = offset[key] + rank;
  order[slot] = run;
  if (rank % kChunk == 0) {
    const int g = chunk_off[key] + rank / kChunk;
    chunk_first[g] = slot;
    chunk_key[g] = key;
  }
}

// The pairwise tree, over the lanes below n, of each lane's x[c], complete
// in lane 0 (every column: their shuffles in flight together).
__device__ __forceinline__ void lane_tree(float (&x)[kMaxCols], int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s < 32; s *= 2) {
    const bool take = (lane & (2 * s - 1)) == 0 && lane + s < n;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const float y = __shfl_down_sync(kFull, x[c], s);
      if (take) x[c] = add(x[c], y);
    }
  }
}

// Level 2a, one warp a chunk: the pairwise tree over its (at most kChunk)
// runs in tile order, all columns at once.
__global__ void __launch_bounds__(kThreads)
closest_hit_bwd_chunk_kernel(const float* __restrict__ run_val, int k_join,
                             const int* __restrict__ order,
                             const int* __restrict__ offset,
                             const int* __restrict__ chunk_off, int n_keys,
                             const int* __restrict__ chunk_first,
                             const int* __restrict__ chunk_key,
                             float* __restrict__ chunk_val) {
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= chunk_off[n_keys]) return;
  const int nc = kRecTerms + k_join;
  const int first = chunk_first[g];
  const int n = min(kChunk, offset[chunk_key[g] + 1] - first);
  float x[kMaxCols];
  const float* src =
      run_val + (size_t)(lane < n ? order[first + lane] : 0) * nc;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    x[c] = lane < n && c < nc ? src[c] : 0.0f;
  lane_tree(x, n);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < nc) chunk_val[(size_t)g * nc + c] = x[c];
  }
}

// Level 2b, one warp a key: the pairwise tree over its chunks, as the
// trees of its aligned groups of 32 (the whole tree's subtrees) summed by
// a binary counter (a pairwise tree too); then the key's rows of the tables
// (zeros for a key no lane hit).
__global__ void __launch_bounds__(kThreads)
closest_hit_bwd_key_kernel(const float* __restrict__ chunk_val, int k_join,
                           const int* __restrict__ chunk_off, int n_keys,
                           int quad_base, int n_sph, int n_quad,
                           float* __restrict__ d_sph,
                           float* __restrict__ d_quad,
                           float* __restrict__ d_joined) {
  __shared__ float s_stack[kWarps][kLevels][kMaxCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = blockIdx.x * kWarps + warp;
  if (key >= n_keys) return;
  const int nc = kRecTerms + k_join;
  const int g0 = chunk_off[key], n = chunk_off[key + 1] - g0;
  const int groups = (n + 31) / 32;
  float x[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) x[c] = 0.0f;
  for (int j = 0; j < groups; ++j) {
    const int len = min(32, n - 32 * j);
    const float* src = chunk_val + (size_t)(g0 + 32 * j + lane) * nc;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      x[c] = lane < len && c < nc ? src[c] : 0.0f;
    lane_tree(x, len);
    if (lane == 0 && groups > 1) {
      // push group j onto the counter: merge while j's low bits are ones
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < nc) {
          float v = x[c];
          int b = 0;
          for (unsigned u = (unsigned)j; u & 1u; u >>= 1, ++b)
            v = add(s_stack[warp][b][c], v);
          s_stack[warp][b][c] = v;
        }
      }
    }
  }
  if (lane != 0) return;
  if (groups > 1) {
    // the counter's partial sums, the last (smallest) first
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < nc) {
        bool any = false;
        for (int b = 0; b < kLevels; ++b) {
          if (groups >> b & 1) {
            x[c] = any ? add(s_stack[warp][b][c], x[c]) : s_stack[warp][b][c];
            any = true;
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= nc) continue;
    if (c >= kRecTerms)
      d_joined[(size_t)key * k_join + c - kRecTerms] = x[c];
    else if (key < quad_base && key < n_sph)
      d_sph[(size_t)key * kSphCols + c] = x[c];
    else if (key >= quad_base && key - quad_base < n_quad && c < 4)
      d_quad[(size_t)(key - quad_base) * kQuadCols + c] = x[c];
  }
  // the columns no lane adds into: a sphere's surface flag, a quad's past
  // its fourth
  if (key < quad_base && key < n_sph)
    d_sph[(size_t)key * kSphCols + kRecTerms] = 0.0f;
  if (key >= quad_base && key - quad_base < n_quad) {
    for (int c = 4; c < kQuadCols; ++c)
      d_quad[(size_t)(key - quad_base) * kQuadCols + c] = 0.0f;
  }
}

// ---- "cull" ----
//
// Replaces _make_kernel's "cull" branch (the JAX package's walk over the
// 128-row sub-clusters of cluster_boxes, each behind its box, with
// cluster_reachable's packet-wide test).  On the TPU a sub-cluster was a
// vector step for a whole packet of rays.  A thread walking the
// sub-clusters for its own ray would pay, in a warp, for every sub-cluster
// any of its 32 rays enters, and a call would end with the rays that enter
// the most: on scene 9's camera and bounce rays a ray enters ~3.5 of the
// 28 sub-clusters and a warp ~17.5 (PERF.md, "cull"'s step 0).
//
// So the work is laid out sub-cluster-major, by the pairs (ray, sub-cluster
// the ray enters), in six kernels on one stream:
//
//   closest_hit_cull_mask_kernel   one thread a ray slab-tests every box of
//       cull_boxes (staged in shared memory; box_enters with the bound
//       +inf) and writes one bit a sub-cluster, n_words 32-bit words a ray;
//       a block is a tile of kThreads rays, which counts, for each
//       sub-cluster, its rays that enter it (a ballot for each bit some
//       lane of a warp has); it also resets the ray's two keys;
//   closest_hit_cull_scan_kernel   one block a sub-cluster: the exclusive
//       scan of its tiles' counts, each tile's first slot in its bin;
//   closest_hit_cull_bins_kernel   one block: each bin's first slot and
//       first chunk of kCullThreads slots (scans of the bins' lengths);
//   closest_hit_cull_place_kernel   each ray writes its index into the bin
//       of every sub-cluster it enters, at its tile's first slot plus its
//       rank among the tile's rays that enter it: the bins hold the rays in
//       ray order, from integer counts alone;
//   closest_hit_cull_test_kernel   a fixed grid (no host read of the pair
//       count): each block takes chunks of kCullThreads listed rays from a
//       counter until none is left (faster than a fixed contiguous run of
//       chunks a block: PERF.md), stages a chunk's sub-cluster rows in
//       shared memory with cp.async (pipelined, read back by lds_sph and
//       lds_quad), and each thread tests its listed ray against every row,
//       so every lane of a warp works; the ray's lexicographic (t, row)
//       minimum over those rows is folded into its sphere or quad key by
//       an integer atomicMin;
//   closest_hit_cull_emit_kernel   one thread a ray reads its two keys and
//       runs emit (the merge, a sphere winning an exact tie, and the row).
//
// A key is (t bits << 32) | row: t is a positive float32 (a root above
// t_min a > 0 or a quad t above t_min), whose bits order as the float, and
// +inf orders after every finite t; a miss is (+inf, 0), emit's state for a
// ray that tested nothing.  The minimum of the keys is the lexicographic
// (t, row) minimum over every row the ray tested, whatever the order of the
// atomics, so two launches give the same bits; no float atomic.  The bound
// of the slab test is +inf: a ray tests every sub-cluster whose widened box
// it enters, a superset of what a running bound would let it test, and an
// extra test cannot change the minimum (the boxes hold every hit the tests
// report: box_enters, _widen).  The sphere and quad tests are the other
// modes' own, so the result is the plain scan's bit for bit.
//
// Scratch (CullScratch below, its sizes exported by
// mort_closest_hit_cull_scratch): the masks, the tiles' counts and slots,
// the bins' lengths, first slots and first chunks, the chunk counter, R x
// n_sub slots of bins (every ray may enter every box; the wrapper splits
// the rays so that each launch's R n_sub stays within
// closest_hit.CULL_MAX_PAIRS) and two keys a ray.
//
// What bounds it on an H100: float32 issue in the test kernel (~3.5 x 128
// row tests a ray on scene 9), then the mask kernel's n_sub slab tests a
// ray and the emit's 32 rows out.
constexpr int kCullThreads = 128;   // listed rays of a chunk: the test
                                    // kernel's block
constexpr int kCullBlocks = 8;      // test blocks an SM (the grid's share)
constexpr unsigned long long kMissKey = 0x7f80000000000000ull;   // (+inf, 0)

__device__ __forceinline__ unsigned long long hit_key(float t, int row) {
  return (unsigned long long)__float_as_uint(t) << 32 | (unsigned)row;
}

// In lane b, the rays of the warp whose word has bit b set; only the bits
// some lane has are balloted.
__device__ __forceinline__ int bit_count(unsigned word) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (unsigned any = __reduce_or_sync(kFull, word); any; any &= any - 1) {
    const int b = __ffs(any) - 1;
    const unsigned bal = __ballot_sync(kFull, (word >> b) & 1u);
    if (lane == b) n = __popc(bal);
  }
  return n;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
closest_hit_cull_mask_kernel(const float* __restrict__ rays, int R,
                             float t_min, const float* __restrict__ boxes,
                             int n_sub, unsigned* __restrict__ mask,
                             int* __restrict__ slot, int n_tiles,
                             unsigned long long* __restrict__ keys,
                             unsigned long long* __restrict__ n_tests) {
  __shared__ __align__(16) float s_buf[2 * kStage];
  __shared__ int s_cnt[kWarps][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int i = tile * kThreads + tid;
  const bool live = i < R;
  // ragged tail: compute on a real ray, so every thread reaches the barriers
  const Ray r = load_ray(rays, R, live ? i : R - 1, t_min);
  const Slab b = make_slab(r, __ldg(boxes + 6));
  if (live) {
    keys[i] = kMissKey;
    keys[R + i] = kMissKey;
  }
  int pairs = 0;
  pipelined(
      n_sub, kBoxTile, s_buf,
      [&](float* dst, int base, int n) {
        const float* src = boxes + (size_t)base * kBoxCols;
        for (int e = tid; e < n * (kBoxCols / 4); e += kThreads)
          cp_async16(dst + 4 * e, src + 4 * e);
      },
      [&](const float* tile_buf, int base, int n) {
        // lo xyz, hi x | hi yz, r_min, 0; a tile is whole words of boxes
        const float4* t4 = reinterpret_cast<const float4*>(tile_buf);
        for (int w0 = 0; w0 < n; w0 += 32) {
          const int m = min(32, n - w0);
          unsigned word = 0u;
          for (int j = 0; j < m; ++j) {
            const float4 p = t4[2 * (w0 + j)], q = t4[2 * (w0 + j) + 1];
            float t_in;
            if (box_enters(b, p.x, p.w, p.y, q.x, p.z, q.y, t_min,
                           CUDART_INF_F, t_in))
              word |= 1u << j;
          }
          if (live) mask[(size_t)((base + w0) >> 5) * R + i] = word;
          if constexpr (kCount) pairs += __popc(word);
        }
      });
  // each sub-cluster's rays of the tile, a mask word at a time
  const int n_words = (n_sub + 31) / 32;
  for (int w = 0; w < n_words; ++w) {
    s_cnt[warp][lane] = bit_count(live ? mask[(size_t)w * R + i] : 0u);
    __syncthreads();
    const int s = w * 32 + tid;
    if (tid < 32 && s < n_sub) {
      int c = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) c += s_cnt[v][tid];
      slot[(size_t)s * n_tiles + tile] = c;
    }
    __syncthreads();
  }
  if constexpr (kCount) {
    if (live) add_counts(n_tests, 0, 0, n_sub, 0, pairs);
  }
}

// One block a sub-cluster s: slot[s n_tiles + t], s's rays of tile t in,
// the exclusive scan over the tiles out (the first slot of them in s's
// bin); total[s], the bin's length.
__global__ void __launch_bounds__(kScanThreads)
closest_hit_cull_scan_kernel(int* __restrict__ slot, int n_tiles,
                             int* __restrict__ total) {
  __shared__ int s_sum[kScanThreads / 32];
  __shared__ int s_round;
  int* row = slot + (size_t)blockIdx.x * n_tiles;
  int carry = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    const int c = t < n_tiles ? row[t] : 0;
    const int ex = block_exclusive_scan(c, s_sum);
    if (t < n_tiles) row[t] = carry + ex;
    if (threadIdx.x == kScanThreads - 1) s_round = ex + c;
    __syncthreads();
    carry += s_round;
  }
  if (threadIdx.x == 0) total[blockIdx.x] = carry;
}

// One block: bin_off[s], the first slot of s's bin (the exclusive scan of
// the totals), and chunk_off[s], its first chunk of kCullThreads slots;
// bin_off[n_sub] and chunk_off[n_sub], the pairs and the chunks in all;
// the test kernel's chunk counter reset.  Each thread scans a contiguous
// share of the sub-clusters.
__global__ void __launch_bounds__(kScanThreads)
closest_hit_cull_bins_kernel(const int* __restrict__ total, int n_sub,
                             int* __restrict__ bin_off,
                             int* __restrict__ chunk_off,
                             int* __restrict__ next) {
  __shared__ int s_sum[kScanThreads / 32];
  if (threadIdx.x == 0) *next = 0;
  const int per = (n_sub + kScanThreads - 1) / kScanThreads;
  const int s0 = min((int)threadIdx.x * per, n_sub);
  const int s1 = min(s0 + per, n_sub);
  auto chunks = [&](int s) {
    return (total[s] + kCullThreads - 1) / kCullThreads;
  };
  int pairs = 0, c = 0;
  for (int s = s0; s < s1; ++s) {
    pairs += total[s];
    c += chunks(s);
  }
  int at = block_exclusive_scan(pairs, s_sum);
  int c_at = block_exclusive_scan(c, s_sum);
  for (int s = s0; s < s1; ++s) {
    bin_off[s] = at;
    chunk_off[s] = c_at;
    at += total[s];
    c_at += chunks(s);
  }
  if (threadIdx.x == kScanThreads - 1) {
    bin_off[n_sub] = at;
    chunk_off[n_sub] = c_at;
  }
}

// bins[slot]: each ray in the bin of every sub-cluster it enters, at its
// tile's first slot there plus the rays of the tile before it that enter
// it (the warps before its warp, then the lanes before its lane).  A mask
// word at a time, the first slot of each warp's rays of each of the word's
// sub-clusters is laid out in shared memory.
__global__ void __launch_bounds__(kThreads)
closest_hit_cull_place_kernel(const unsigned* __restrict__ mask, int R,
                              int n_sub, const int* __restrict__ slot,
                              int n_tiles, const int* __restrict__ bin_off,
                              int* __restrict__ bins) {
  __shared__ int s_cnt[kWarps][32];
  __shared__ int s_at[kWarps][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int i = tile * kThreads + tid;
  const bool live = i < R;
  const unsigned below = (1u << lane) - 1u;
  const int n_words = (n_sub + 31) / 32;
  for (int w = 0; w < n_words; ++w) {
    const unsigned my = live ? mask[(size_t)w * R + i] : 0u;
    s_cnt[warp][lane] = bit_count(my);
    __syncthreads();
    const int s = w * 32 + tid;
    if (tid < 32 && s < n_sub) {
      int at = bin_off[s] + slot[(size_t)s * n_tiles + tile];
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        s_at[v][tid] = at;
        at += s_cnt[v][tid];
      }
    }
    __syncthreads();
    for (unsigned any = __reduce_or_sync(kFull, my); any; any &= any - 1) {
      const int b = __ffs(any) - 1;
      const unsigned bal = __ballot_sync(kFull, (my >> b) & 1u);
      if ((my >> b) & 1u) bins[s_at[warp][b] + __popc(bal & below)] = i;
    }
    __syncthreads();
  }
}

// Each block takes the next chunk from a counter (next, zeroed by the bins
// kernel) until none is left; chunk g is slots [first, first + n) of the
// bin of sub-cluster s (the last s with chunk_off[s] <= g).  The rows of s
// are staged when s changes; each listed ray tests every row and folds its
// minimum into its key.  The order in which blocks take chunks changes no
// result: a key's minimum does not depend on it.
template <bool kCount>
__global__ void __launch_bounds__(kCullThreads, kCullBlocks)
closest_hit_cull_test_kernel(const float* __restrict__ rays, int R,
                             const float* __restrict__ sph, int n_sph,
                             const float* __restrict__ quad, int n_quad,
                             float t_min, int n_sph_sub, int n_sub,
                             const int* __restrict__ bin_off,
                             const int* __restrict__ chunk_off,
                             const int* __restrict__ bins,
                             int* __restrict__ next,
                             unsigned long long* __restrict__ keys,
                             unsigned long long* __restrict__ n_tests) {
  __shared__ __align__(16) float s_rows[kCL * kQuadF];
  __shared__ int s_g;
  const int tid = threadIdx.x;
  const int n_chunks = chunk_off[n_sub];
  int n_s = 0, n_q = 0, staged = -1;
  for (;;) {
    if (tid == 0) s_g = atomicAdd(next, 1);
    __syncthreads();
    const int g = s_g;
    __syncthreads();   // every thread has read s_g before it is rewritten
    if (g >= n_chunks) break;
    int lo = 0, hi = n_sub - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (chunk_off[mid] <= g) lo = mid; else hi = mid - 1;
    }
    const int s = lo;
    const int first = bin_off[s] + (g - chunk_off[s]) * kCullThreads;
    const int n = min(kCullThreads, bin_off[s + 1] - first);
    const bool sphere = s < n_sph_sub;
    const int r0 = (sphere ? s : s - n_sph_sub) * kCL;
    const int rows = min(kCL, (sphere ? n_sph : n_quad) - r0);
    auto test = [&](const float* tile, int, int n_rows) {
      if (tid >= n) return;
      const int i = bins[first + tid];
      const Ray r = load_ray(rays, R, i, t_min);
      float t = CUDART_INF_F;
      int row = 0;
      if (sphere) {
        for (int j = 0; j < n_rows; ++j) {
          const bool tested =
              sphere_test(r, lds_sph(tile + j * kSphF), r0 + j, t, row);
          if constexpr (kCount) n_s += tested;
        }
      } else {
        for (int j = 0; j < n_rows; ++j) {
          const bool tested =
              quad_test(r, lds_quad(tile + j * kQuadF), r0 + j, t, row);
          if constexpr (kCount) n_q += tested;
        }
      }
      if (t < CUDART_INF_F)
        atomicMin(keys + (sphere ? 0 : R) + i, hit_key(t, row));
    };
    if (s == staged) {
      test(s_rows, 0, rows);
      continue;
    }
    // the barriers above: the previous chunk's readers are done; a
    // sub-cluster is one tile, so only the buffer's first half is used
    staged = s;
    pipelined(
        rows, kCL, s_rows,
        [&](float* dst, int, int m) {
          const int cols = sphere ? kSphCols : kQuadCols;
          const int pitch = sphere ? kSphF : kQuadF;
          const float* src = (sphere ? sph : quad) + (size_t)r0 * cols;
          for (int e = tid; e < m * cols; e += kCullThreads) {
            const int j = e / cols;
            cp_async4(dst + j * pitch + (e - j * cols), src + e);
          }
        },
        test);
  }
  if constexpr (kCount) add_counts(n_tests, n_s, n_q);
}

__global__ void __launch_bounds__(kThreads)
closest_hit_cull_emit_kernel(const float* __restrict__ rays, int R,
                             float t_min,
                             const unsigned long long* __restrict__ keys,
                             const float* __restrict__ joined, int k_join,
                             int quad_base, float* __restrict__ row_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i, t_min);
  const unsigned long long ks = keys[i], kq = keys[R + i];
  emit(r, __uint_as_float((unsigned)(ks >> 32)), (int)(unsigned)ks,
       __uint_as_float((unsigned)(kq >> 32)), (int)(unsigned)kq, joined,
       k_join, quad_base, R, i, row_out);
}

// The scratch of a "cull" launch: R rays in n_tiles tiles, n_sub
// sub-clusters in n_words mask words.  Its sizes are exported
// (mort_closest_hit_cull_scratch), so the caller allocates what this layout
// needs; with null scratch only the sizes are set.
struct CullScratch {
  int n_tiles, n_words;
  long long n_int, n_key;
  unsigned* mask = nullptr;            // [n_words, R]
  int *slot = nullptr, *total = nullptr;       // [n_sub, n_tiles], [n_sub]
  int *bin_off = nullptr, *chunk_off = nullptr;  // [n_sub + 1] each
  int* next = nullptr;                 // the test kernel's chunk counter
  int* bins = nullptr;                 // [R n_sub]
  unsigned long long* keys = nullptr;  // [2, R]: sphere, quad

  CullScratch(int R, int n_sub, int* si, unsigned long long* sk) {
    n_tiles = (R + kThreads - 1) / kThreads;
    n_words = (n_sub + 31) / 32;
    n_int = (long long)n_words * R + (long long)n_sub * n_tiles + 3LL * n_sub +
            3 + (long long)R * n_sub;
    n_key = 2LL * R;
    if (si == nullptr || sk == nullptr) return;
    mask = reinterpret_cast<unsigned*>(si);
    slot = si + (long long)n_words * R;
    total = slot + (long long)n_sub * n_tiles;
    bin_off = total + n_sub;
    chunk_off = bin_off + n_sub + 1;
    next = chunk_off + n_sub + 1;
    bins = next + 1;
    keys = sk;
  }
};

// The scratch of a backward launch (closest_hit.bwd_scratch_sizes): R lanes
// in n_tiles tiles, n_join keys, n_words 32-tile words a key, at most
// max_chunks level-2 chunks (a key's runs / kChunk, rounded up, summed:
// under 8 n_tiles + n_join).
struct BwdScratch {
  int n_tiles, n_words, max_chunks;
  long long n_int, n_float;
  int *run_key, *order, *tile_runs, *count, *offset, *chunk_off,
      *chunk_first, *chunk_key, *prefix;
  unsigned* present;
  float *run_val, *chunk_val;

  BwdScratch(int R, int n_join, int k_join, int* si, float* sf) {
    n_tiles = (R + kThreads - 1) / kThreads;
    n_words = (n_tiles + 31) / 32;
    max_chunks = n_tiles * (kThreads / kChunk) + n_join;
    const long long slots = (long long)n_tiles * kThreads;
    const long long words = (long long)n_join * n_words;
    run_key = si;
    order = run_key + slots;
    tile_runs = order + slots;
    count = tile_runs + n_tiles;
    offset = count + n_join;
    chunk_off = offset + n_join + 1;
    chunk_first = chunk_off + n_join + 1;
    chunk_key = chunk_first + max_chunks;
    prefix = chunk_key + max_chunks;
    present = reinterpret_cast<unsigned*>(prefix + words);
    n_int = 2 * slots + n_tiles + 3LL * n_join + 2 + 2LL * max_chunks +
            2 * words;
    run_val = sf;
    chunk_val = run_val + slots * (kRecTerms + k_join);
    n_float = (slots + max_chunks) * (kRecTerms + k_join);
  }
};

// The operands of a forward launch.
struct FwdArgs {
  const float* rays;
  int R;
  const float* sph;
  int n_sph;
  const float* quad;
  int n_quad;
  const float* joined;
  int k_join, quad_base;
  float t_min;
  const float* accel;
  int n_accel;
  const float* aab_tab;
  const int* aab_faces;
  const int* gen_rows;
  int n_box, n_gen;
  const float* aaq_tab;
  const int* aaq_groups;
  int n_aaq, n_groups;
  float* row_out;
  unsigned long long* n_tests;
};

// Launches the forward kernel of `mode`, counting its tests when kCount.
template <bool kCount>
void launch(int mode, const FwdArgs& a, cudaStream_t s) {
  const dim3 grid((unsigned)((a.R + kThreads - 1) / kThreads));
  if (mode == kModeNone) {
    closest_hit_none_kernel<kCount><<<grid, kThreads, 0, s>>>(
        a.rays, a.R, a.sph, a.n_sph, a.quad, a.gen_rows, a.n_gen, a.aab_tab,
        a.aab_faces, a.n_box, a.aaq_tab, a.aaq_groups, a.n_aaq, a.n_groups,
        a.joined, a.k_join, a.quad_base, a.t_min, a.row_out, a.n_tests);
  } else {
    closest_hit_bvh_kernel<kCount><<<grid, kThreads, 0, s>>>(
        a.rays, a.R, a.sph, a.n_sph, a.quad, a.n_quad, a.joined, a.k_join,
        a.quad_base, a.t_min, reinterpret_cast<const float4*>(a.accel),
        a.n_accel, a.row_out, a.n_tests);
  }
}

}  // namespace

extern "C" {

// Launches the kernel of `mode` (0 "none", 2 "bvh"; "cull" is
// mort_closest_hit_cull) on `stream` and returns cudaGetLastError() (0 on
// success).  `accel` is the bvh nodes [n_accel, 12] with n_accel = L, a
// power of two up to 2^30, 16-byte aligned (mode 2); unused in mode 0.
// Mode 0 reads `aab_tab`
// [n_box, 8] (16-byte aligned), `aab_faces` [n_box, 6], `gen_rows` [n_gen],
// `aaq_tab` [n_aaq, 8] (16-byte aligned) and its `aaq_groups` [n_groups, 5]
// instead of scanning the n_quad quad rows in order.  Allocates nothing;
// `row_out` is a [32, R] float32 buffer.  `n_tests`: null, or five counters
// to which the launch adds the sphere, quad, box (mode 0) or node (mode 2)
// slab and axis-aligned quad (mode 0) tests it performs (the results do not
// change).
int mort_closest_hit(const float* rays, int R, const float* sph, int n_sph,
                     const float* quad, int n_quad, const float* joined,
                     int k_join, int quad_base, float t_min, int mode,
                     const float* accel, int n_accel,
                     const float* aab_tab, const int* aab_faces,
                     const int* gen_rows, int n_box, int n_gen,
                     const float* aaq_tab, const int* aaq_groups, int n_aaq,
                     int n_groups, float* row_out,
                     unsigned long long* n_tests, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (mode != kModeNone && mode != kModeBvh)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{rays,     R,        sph,        n_sph,     quad,
                  n_quad,   joined,   k_join,     quad_base, t_min,
                  accel,    n_accel,  aab_tab,    aab_faces, gen_rows,
                  n_box,    n_gen,    aaq_tab,    aaq_groups, n_aaq,
                  n_groups, row_out,  n_tests};
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tests == nullptr)
    launch<false>(mode, a, s);
  else
    launch<true>(mode, a, s);
  return (int)cudaGetLastError();
}

// The int32 and uint64 element counts of the scratch of a "cull" launch of
// R rays against n_sub sub-clusters (CullScratch).
void mort_closest_hit_cull_scratch(int R, int n_sub, long long* n_int,
                                   long long* n_key) {
  const CullScratch c(R, n_sub, nullptr, nullptr);
  *n_int = c.n_int;
  *n_key = c.n_key;
}

// Launches the "cull" kernels (mask, scan, bins, place, test, emit) on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue, launching
// nothing, when the scratch is short).  `boxes` [n_sub, 8] (16-byte
// aligned) are closest_hit.cull_boxes, whose first `n_sph_sub` hold sphere
// rows; the test kernel's grid is at most n_sm * kCullBlocks blocks.
// `scratch_i` (int32, n_int) and `scratch_k` (uint64, n_key) are the
// caller's, sized by mort_closest_hit_cull_scratch (R n_sub < 2^31: the
// caller splits larger ray sets); the kernels write all of it before
// reading it.  Allocates nothing;
// `row_out` is a [32, R] float32 buffer.  `n_tests`: null, or five counters
// to which the launch adds the sphere, quad and box slab tests it performs
// and the pairs (ray, entered sub-cluster) of its bins (the results do not
// change).
int mort_closest_hit_cull(const float* rays, int R, const float* sph,
                          int n_sph, const float* quad, int n_quad,
                          const float* joined, int k_join, int quad_base,
                          float t_min, const float* boxes, int n_sph_sub,
                          int n_sub, int n_sm, float* row_out,
                          unsigned long long* n_tests, int* scratch_i,
                          long long n_int, unsigned long long* scratch_k,
                          long long n_key, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (n_sub < 0 || n_sph_sub < 0 || n_sph_sub > n_sub || n_sm < 1 ||
      (long long)R * n_sub >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const CullScratch c(R, n_sub, scratch_i, scratch_k);
  if (n_int < c.n_int || n_key < c.n_key) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // at most a chunk of each bin's pairs / kCullThreads, rounded up
  const int n_test_blocks = (int)std::min(
      (long long)n_sm * kCullBlocks,
      std::max(1LL, (long long)R * n_sub / kCullThreads + n_sub));
  if (n_tests == nullptr)
    closest_hit_cull_mask_kernel<false><<<c.n_tiles, kThreads, 0, s>>>(
        rays, R, t_min, boxes, n_sub, c.mask, c.slot, c.n_tiles, c.keys,
        n_tests);
  else
    closest_hit_cull_mask_kernel<true><<<c.n_tiles, kThreads, 0, s>>>(
        rays, R, t_min, boxes, n_sub, c.mask, c.slot, c.n_tiles, c.keys,
        n_tests);
  if (n_sub > 0)
    closest_hit_cull_scan_kernel<<<n_sub, kScanThreads, 0, s>>>(
        c.slot, c.n_tiles, c.total);
  closest_hit_cull_bins_kernel<<<1, kScanThreads, 0, s>>>(
      c.total, n_sub, c.bin_off, c.chunk_off, c.next);
  closest_hit_cull_place_kernel<<<c.n_tiles, kThreads, 0, s>>>(
      c.mask, R, n_sub, c.slot, c.n_tiles, c.bin_off, c.bins);
  if (n_tests == nullptr)
    closest_hit_cull_test_kernel<false><<<n_test_blocks, kCullThreads, 0,
                                          s>>>(
        rays, R, sph, n_sph, quad, n_quad, t_min, n_sph_sub, n_sub,
        c.bin_off, c.chunk_off, c.bins, c.next, c.keys, n_tests);
  else
    closest_hit_cull_test_kernel<true><<<n_test_blocks, kCullThreads, 0,
                                         s>>>(
        rays, R, sph, n_sph, quad, n_quad, t_min, n_sph_sub, n_sub,
        c.bin_off, c.chunk_off, c.bins, c.next, c.keys, n_tests);
  closest_hit_cull_emit_kernel<<<c.n_tiles, kThreads, 0, s>>>(
      rays, R, t_min, c.keys, joined, k_join, quad_base, row_out);
  return (int)cudaGetLastError();
}

// Launches the backward kernels on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue, launching nothing, when the scratch is short).
// `kind`/`idx` are the forward's winner (int32 [R]), `dt` [R] and `drow`
// [32, R] the cotangents, `sph` [n_sph, 10] and `quad` [n_quad, 13] the
// records (n_sph <= quad_base, quad_base + n_quad <= n_join); writes
// `d_rays` [8, R] and every entry of `d_sph`, `d_quad` and `d_joined`
// [n_join, k_join].  `scratch_i` (int32, n_int) and `scratch_f` (float32,
// n_float) are the caller's, sized by closest_hit.bwd_scratch_sizes; the
// presence bitmap in scratch_i is zeroed here (cudaMemsetAsync).  Allocates
// nothing.
int mort_closest_hit_bwd(const float* rays, int R, const int* kind,
                         const int* idx, const float* dt, const float* drow,
                         const float* sph, int n_sph, const float* quad,
                         int n_quad, int n_join, int k_join, int quad_base,
                         float t_min, float* d_rays, float* d_sph,
                         float* d_quad, float* d_joined, int* scratch_i,
                         long long n_int, float* scratch_f,
                         long long n_float, void* stream) {
  if (R < 0 || n_join < 1 || k_join < 0 || k_join > kRowT ||
      n_sph > quad_base || quad_base + n_quad > n_join)
    return (int)cudaErrorInvalidValue;
  const BwdScratch b(R, n_join, k_join, scratch_i, scratch_f);
  if (n_int < b.n_int || n_float < b.n_float)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long words = (long long)n_join * b.n_words;
  cudaMemsetAsync(b.present, 0, (size_t)words * sizeof(unsigned), s);
  if (R > 0) {
    closest_hit_bwd_tile_kernel<<<b.n_tiles, kThreads, 0, s>>>(
        rays, R, kind, idx, dt, drow, sph, quad, k_join, quad_base, t_min,
        d_rays, b.run_key, b.run_val, b.tile_runs, b.present, b.n_words);
  }
  closest_hit_bwd_count_kernel<<<(n_join + kWarps - 1) / kWarps, kThreads,
                                 0, s>>>(b.present, n_join, b.n_words,
                                         b.prefix, b.count);
  closest_hit_bwd_offsets_kernel<<<1, kScanThreads, 0, s>>>(
      b.count, n_join, b.offset, b.chunk_off);
  if (R > 0) {
    closest_hit_bwd_place_kernel<<<b.n_tiles, kThreads, 0, s>>>(
        b.run_key, b.tile_runs, b.present, b.prefix, b.offset, b.chunk_off,
        b.n_words, b.order, b.chunk_first, b.chunk_key);
    closest_hit_bwd_chunk_kernel<<<(b.max_chunks + kWarps - 1) / kWarps,
                                   kThreads, 0, s>>>(
        b.run_val, k_join, b.order, b.offset, b.chunk_off, n_join,
        b.chunk_first, b.chunk_key, b.chunk_val);
  }
  closest_hit_bwd_key_kernel<<<(n_join + kWarps - 1) / kWarps, kThreads, 0,
                               s>>>(b.chunk_val, k_join, b.chunk_off, n_join,
                                    quad_base, n_sph, n_quad, d_sph, d_quad,
                                    d_joined);
  return (int)cudaGetLastError();
}

const char* mort_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
