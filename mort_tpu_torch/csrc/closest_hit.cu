// Closest sphere/quad hit + joined shading row, one thread per ray.
//
// Replaces the JAX package's Pallas TPU kernel
// mort_tpu/render/pallas_intersect.py::_closest_hit (kernel body
// _make_kernel, accel mode "none": the sphere scan _sphere_chunk_best, the
// plain quad loop _quad_chunk_best, the merge and the row emit _emit_row).
// The TPU version folded every per-(ray, primitive) product into limb-packed
// bf16 MXU dots and gathered the winner's row with a one-hot matmul; both
// existed only to serve the MXU.  Here they are plain float32 arithmetic and
// one indexed load.
//
// What bounds it on an H100: float32 issue.  Each (ray, sphere) pair costs
// about 25 flops (two 3-term dots for half_b, two for c_term, the
// discriminant, a square root and the root pick), so scene 1 (485 spheres)
// at a pool of 2^18 rays is ~3.2 Gflop per bounce.  The sphere records are
// staged through shared memory in tiles of 256 and read by every thread of
// the block at the same address (a broadcast, no bank conflicts), so device
// memory traffic is the rays in, the [32, R] rows out and one 108-byte row
// load per ray.
//
// Arithmetic: every add, subtract, multiply and square root is an
// explicitly rounded intrinsic (__fadd_rn, __fmul_rn, __fsqrt_rn, ...), so
// nvcc contracts nothing into an FMA and the results equal, bit for bit,
// the plain PyTorch version closest_hit_reference in
// mort_tpu_torch/render/closest_hit.py, which performs the same ops in the
// same order.  The formulas (and the a-scaled root pick) are documented
// there.
//
// Tie rules: within a kind the earlier row wins (strict <); a sphere beats a
// quad on an exact tie.  Rows whose surface flag is 0 (skip rows, padding)
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

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
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
  const int li = live ? i : R - 1;   // ragged tail: compute on a real ray

  const float ox = rays[li], oy = rays[R + li], oz = rays[2 * R + li];
  const float dx = rays[3 * R + li], dy = rays[4 * R + li];
  const float dz = rays[5 * R + li], tm = rays[6 * R + li];

  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float ro_rd = dot3(ox, oy, oz, dx, dy, dz);
  const float ro_sq = dot3(ox, oy, oz, ox, oy, oz);
  const float tdx = mul(tm, dx), tdy = mul(tm, dy), tdz = mul(tm, dz);
  const float tox = mul(tm, ox), toy = mul(tm, oy), toz = mul(tm, oz);
  const float tt = mul(tm, tm);
  const float tmin_a = mul(a, t_min);

  // ---- spheres: roots scaled by a, strict < keeps the earlier row ----
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
    for (int j = 0; j < n; ++j) {
      if (s_sph[9][j] == 0.0f) continue;   // skip / padding row
      const float cx = s_sph[0][j], cy = s_sph[1][j], cz = s_sph[2][j];
      const float vx = s_sph[3][j], vy = s_sph[4][j], vz = s_sph[5][j];
      const float half_b = sub(sub(ro_rd, dot3(dx, dy, dz, cx, cy, cz)),
                               dot3(tdx, tdy, tdz, vx, vy, vz));
      const float c_term = add(
          add(add(sub(sub(ro_sq, mul(2.0f, dot3(ox, oy, oz, cx, cy, cz))),
                      mul(2.0f, dot3(tox, toy, toz, vx, vy, vz))),
                  s_sph[6][j]),
              mul(tm, s_sph[7][j])),
          mul(tt, s_sph[8][j]));
      const float disc = sub(mul(half_b, half_b), mul(a, c_term));
      if (disc >= 0.0f) {
        const float sq = __fsqrt_rn(disc);
        const float root1 = sub(-half_b, sq);
        const float root = root1 > tmin_a ? root1 : add(root1, mul(2.0f, sq));
        if (root > tmin_a && root < best) {
          best = root;
          best_i = base + j;
        }
      }
    }
  }
  const float st = mul(best, __frcp_rn(a));

  // ---- quads: general plane/window test, strict < ----
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
      if (s_quad[12][j] == 0.0f) continue;
      const float nx = s_quad[0][j], ny = s_quad[1][j], nz = s_quad[2][j];
      const float den = dot3(nx, ny, nz, dx, dy, dz);
      if (!(fabsf(den) >= 1e-8f)) continue;
      const float num = sub(s_quad[3][j], dot3(nx, ny, nz, ox, oy, oz));
      const float t = __fdiv_rn(num, den);
      if (!(t > t_min)) continue;
      const float ax = s_quad[4][j], ay = s_quad[5][j], az = s_quad[6][j];
      const float alpha = add(sub(dot3(ax, ay, az, ox, oy, oz), s_quad[7][j]),
                              mul(t, dot3(ax, ay, az, dx, dy, dz)));
      const float bx = s_quad[8][j], by = s_quad[9][j], bz = s_quad[10][j];
      const float beta = add(sub(dot3(bx, by, bz, ox, oy, oz), s_quad[11][j]),
                             mul(t, dot3(bx, by, bz, dx, dy, dz)));
      if (alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f &&
          t < qt) {
        qt = t;
        qi = base + j;
      }
    }
  }

  if (!live) return;

  // ---- merge (sphere wins ties) and emit the winner's joined row ----
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

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Allocates nothing; `row_out` is a [32, R] float32 buffer.
int mort_closest_hit(const float* rays, int R, const float* sph, int n_sph,
                     const float* quad, int n_quad, const float* joined,
                     int k_join, int quad_base, float t_min, float* row_out,
                     void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((R + kThreads - 1) / kThreads));
  closest_hit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      rays, R, sph, n_sph, quad, n_quad, joined, k_join, quad_base, t_min,
      row_out);
  return (int)cudaGetLastError();
}

const char* mort_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
