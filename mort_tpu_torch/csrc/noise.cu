// The marble noise texture: textures._base_value's noise branch on the card.
//
// Replaces no TPU kernel: the JAX package's turbulence
// (mort_tpu/render/textures.py) was plain XLA, which fused it.  The port's
// plain version (textures.marble_plain, bit-exact with it on the lattice
// hashes) keeps each u32 hash word in an int64 tensor, builds the products
// from 16-bit limbs and evaluates 7 octaves x 8 corners one PyTorch kernel
// an operation: ~3,230 kernels a bounce step over every lane of the pool,
// whatever the lane's texture.  This kernel evaluates every noise texture
// of the scene in one launch, in registers, one thread a lane, and only on
// the lanes whose row is a noise texture (each with its own noise id's salt
// and scale); every other lane keeps its input colour.
//
// Bit-equality with the plain version on the card: the lattice hash is
// native u32 arithmetic (mul.lo wraps as the limbs do mod 2^32); every
// float operation is the plain version's, in its order, each rounded once
// (__fmul_rn/__fadd_rn/__fsub_rn: no FMA contraction); floorf and the
// truncating, saturating float->int32 conversion are torch's; sinf is the
// CUDA math library's, built without --use_fast_math as torch's sin is.
//
// Bound: operations.  A noise lane runs 7 octaves of 8 corners, ~2,000
// integer and float operations; a lane reads its row (8 bytes), two table
// entries, its point and colour (24 bytes) and writes its colour (12
// bytes).  Design: one thread a lane, loads through __ldg, nothing
// allocated, nothing synchronised.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Lattice-hash constants, textures._HX/_HY/_HZ/_HM.
constexpr uint32_t kHX = 0x8DA6B343u;
constexpr uint32_t kHY = 0xD8163841u;
constexpr uint32_t kHZ = 0xCB1AB31Fu;
constexpr uint32_t kHM = 0x9E3779B1u;
// textures.noise_salt: noise texture `id`'s salt is (id + 1) * kSalt
constexpr uint32_t kSalt = 0x51ED270Bu;
constexpr int kOctaves = 7;
constexpr int kThreads = 256;
// float32 of textures._INV_SQRT2 (0.7071067811865476), as torch rounds a
// Python scalar for a float32 tensor
constexpr float kInvSqrt2 = 0.70710677f;

__device__ __forceinline__ uint32_t avalanche(uint32_t h, uint32_t salt) {
  h += salt;
  h ^= h >> 13;
  h *= kHM;
  return h ^ (h >> 16);
}

// t * t * (3 - 2 t), in the plain version's association
__device__ __forceinline__ float smooth(float t) {
  return __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.0f, __fmul_rn(2.0f, t)));
}

// textures._grad_dot: the 12 edge gradients, scaled to unit length
__device__ __forceinline__ float grad_dot(uint32_t h, float wx, float wy,
                                          float wz) {
  const uint32_t hh = h & 15u;
  float u = hh < 8u ? wx : wy;
  float v = hh < 4u ? wy : (hh == 12u || hh == 14u) ? wx : wz;
  if (h & 1u) u = -u;
  if (h & 2u) v = -v;
  return __fmul_rn(__fadd_rn(u, v), kInvSqrt2);
}

// one of a corner's three lattice weights: di * uu + (1 - di) * (1 - uu)
__device__ __forceinline__ float corner_weight(int d, float uu) {
  return __fadd_rn(__fmul_rn(static_cast<float>(d), uu),
                   __fmul_rn(static_cast<float>(1 - d),
                             __fsub_rn(1.0f, uu)));
}

// textures._perlin_noise at one point
__device__ float perlin(float px, float py, float pz, uint32_t salt) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float wx = smooth(__fsub_rn(px, fx));
  const float wy = smooth(__fsub_rn(py, fy));
  const float wz = smooth(__fsub_rn(pz, fz));
  const float ux = smooth(wx), uy = smooth(wy), uz = smooth(wz);
  // the corners share their lattice products: (i+1)*H = i*H + H mod 2^32
  const uint32_t hx0 = static_cast<uint32_t>(static_cast<int>(fx)) * kHX;
  const uint32_t hy0 = static_cast<uint32_t>(static_cast<int>(fy)) * kHY;
  const uint32_t hz0 = static_cast<uint32_t>(static_cast<int>(fz)) * kHZ;
  const uint32_t hx[2] = {hx0, hx0 + kHX};
  const uint32_t hy[2] = {hy0, hy0 + kHY};
  const uint32_t hz[2] = {hz0, hz0 + kHZ};
  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const uint32_t h = avalanche(hx[di] ^ hy[dj] ^ hz[dk], salt);
        const float coeff = __fmul_rn(
            __fmul_rn(corner_weight(di, ux), corner_weight(dj, uy)),
            corner_weight(dk, uz));
        const float gd = grad_dot(h, __fsub_rn(wx, static_cast<float>(di)),
                                  __fsub_rn(wy, static_cast<float>(dj)),
                                  __fsub_rn(wz, static_cast<float>(dk)));
        accum = __fadd_rn(accum, __fmul_rn(coeff, gd));
      }
    }
  }
  return accum;
}

__global__ void __launch_bounds__(kThreads)
    noise_marble_kernel(const float* __restrict__ p,
                        const long long* __restrict__ tid,
                        const int* __restrict__ tex_kind,
                        const int* __restrict__ tex_noise_id,
                        const float* __restrict__ tex_scale, int n_tex,
                        int kind_noise, const float* __restrict__ in,
                        float* __restrict__ out,
                        long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long t = __ldg(tid + i);
  float r = __ldg(in + 3 * i), g = __ldg(in + 3 * i + 1),
        b = __ldg(in + 3 * i + 2);
  if (t >= 0 && t < n_tex && __ldg(tex_kind + t) == kind_noise) {
    // marble: 0.5 * (1 + sin(s.z + 10 * turb(s))), s = scale * p
    const uint32_t salt =
        (static_cast<uint32_t>(__ldg(tex_noise_id + t)) + 1u) * kSalt;
    const float scale = __ldg(tex_scale + t);
    float sx = __fmul_rn(scale, __ldg(p + 3 * i));
    float sy = __fmul_rn(scale, __ldg(p + 3 * i + 1));
    float sz = __fmul_rn(scale, __ldg(p + 3 * i + 2));
    const float z = sz;
    float turb = 0.0f, weight = 1.0f;
#pragma unroll 1
    for (int o = 0; o < kOctaves; ++o) {
      turb = __fadd_rn(turb, __fmul_rn(weight, perlin(sx, sy, sz, salt)));
      weight = __fmul_rn(weight, 0.5f);
      sx = __fmul_rn(sx, 2.0f);
      sy = __fmul_rn(sy, 2.0f);
      sz = __fmul_rn(sz, 2.0f);
    }
    const float arg = __fadd_rn(z, __fmul_rn(10.0f, fabsf(turb)));
    r = g = b = __fmul_rn(0.5f, __fadd_rn(1.0f, sinf(arg)));
  }
  out[3 * i] = r;
  out[3 * i + 1] = g;
  out[3 * i + 2] = b;
}

}  // namespace

extern "C" {

// Launches the kernel over `n` lanes on `stream` and returns
// cudaGetLastError() (0 on success).  `p`, `in` and `out` are [n, 3]
// float32, `tid` [n] int64 texture rows; `tex_kind`, `tex_noise_id` [n_tex]
// int32 and `tex_scale` [n_tex] float32 are the scene's texture table.  A
// lane whose row has kind `kind_noise` gets the marble value of its row's
// noise id (that id's salt, the row's scale) in all three channels; every
// other lane (a row outside the table included) copies `in`.
int mort_noise_marble(const float* p, const long long* tid,
                      const int* tex_kind, const int* tex_noise_id,
                      const float* tex_scale, int n_tex, int kind_noise,
                      const float* in, float* out, long long n,
                      void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    noise_marble_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        p, tid, tex_kind, tex_noise_id, tex_scale, n_tex, kind_noise, in,
        out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
