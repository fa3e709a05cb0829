// Philox4x32-10 and its 24-bit unit floats: rng.uniform4 on the card.
//
// Replaces no TPU kernel: the JAX package's Philox (mort_tpu/rng.py) was
// plain XLA, which fused it.  The port's plain version (rng.philox4x32,
// bit-exact with it) keeps each u32 word in an int64 tensor and builds the
// 32x32 -> 64-bit products from 16-bit limbs, one PyTorch kernel a limb
// step: 228-238 kernels a draw over int64 lanes, two thirds of the
// kernels of a scene-1 bounce step.  This kernel computes the same block
// in registers, with __umulhi for the high words, and writes the four
// floats (w >> 8) * 2^-24, exact in float32: the same bits as the plain
// version.
//
// Bound: bytes.  Each lane reads its lane words (8 bytes each as int64;
// 24 bytes when pixel, sample and bounce are lane tensors) and writes four
// floats (16 bytes): 40 bytes a lane, 10.5 MB for a pool of 2^18 lanes
// (3.1 us at 3.35 TB/s).  Ten rounds of two 32-bit multiplies and their
// high words are far below the card's integer rate.  Design: one thread a
// lane, every word in registers, loads and stores coalesced; nothing is
// allocated, nothing synchronises.
//
// Each counter word (and the seed) is either a value or an int64 pointer
// read with a lane stride of 1 (a lane tensor) or 0 (one element that
// every lane reads, such as a one-element seed or bounce tensor on the
// device: a captured CUDA graph reads it at each replay).  The kernel takes
// an int64 word's low 32 bits, the u32 wrap-around of rng._word.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kRounds = 10;
constexpr int kThreads = 256;

// One counter or key word: `ptr` null reads `value` at every lane.
struct Word {
  const long long* ptr;
  uint32_t value;
  int stride;
};

__device__ __forceinline__ uint32_t load_word(const Word& w, long long i) {
  return w.ptr ? static_cast<uint32_t>(__ldg(w.ptr + i * w.stride))
               : w.value;
}

__global__ void __launch_bounds__(kThreads)
    philox_uniform4_kernel(Word c0, Word c1, Word c2, Word c3, Word k0,
                           uint32_t k1, long long n, float* __restrict__ o0,
                           float* __restrict__ o1, float* __restrict__ o2,
                           float* __restrict__ o3) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = load_word(c0, i), x1 = load_word(c1, i);
  uint32_t x2 = load_word(c2, i), x3 = load_word(c3, i);
  uint32_t key0 = load_word(k0, 0), key1 = k1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t hi0 = __umulhi(kM0, x0), lo0 = kM0 * x0;
    const uint32_t hi1 = __umulhi(kM1, x2), lo1 = kM1 * x2;
    x0 = hi1 ^ x1 ^ key0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ key1;
    x3 = lo0;
    key0 += kW0;
    key1 += kW1;
  }
  // a 24-bit integer is exact in float32, and so is its product by 2^-24
  constexpr float kUnit = 1.0f / 16777216.0f;
  o0[i] = static_cast<float>(x0 >> 8) * kUnit;
  o1[i] = static_cast<float>(x1 >> 8) * kUnit;
  o2[i] = static_cast<float>(x2 >> 8) * kUnit;
  o3[i] = static_cast<float>(x3 >> 8) * kUnit;
}

}  // namespace

extern "C" {

// Launches the kernel over `n` lanes on `stream` and returns
// cudaGetLastError() (0 on success).  Counter word j is (cj_ptr, cj_value,
// cj_stride): an int64 pointer read at lane * stride, or, when the pointer
// is null, the value; the seed likewise with stride 0.  `k1` is the second
// key word.  The outputs are four float32 arrays of `n`.
int mort_philox_uniform4(const long long* c0_ptr, unsigned c0_value,
                         int c0_stride, const long long* c1_ptr,
                         unsigned c1_value, int c1_stride,
                         const long long* c2_ptr, unsigned c2_value,
                         int c2_stride, const long long* c3_ptr,
                         unsigned c3_value, int c3_stride,
                         const long long* seed_ptr, unsigned seed_value,
                         unsigned k1, long long n, float* o0, float* o1,
                         float* o2, float* o3, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    philox_uniform4_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        Word{c0_ptr, c0_value, c0_stride}, Word{c1_ptr, c1_value, c1_stride},
        Word{c2_ptr, c2_value, c2_stride}, Word{c3_ptr, c3_value, c3_stride},
        Word{seed_ptr, seed_value, 0}, k1, n, o0, o1, o2, o3);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
