// Dropout by a counter-based hash: out[i] = keep(i) ? x[i] * scale : 0,
// keep(i) = (hash(seed, site, i) >> 8) >= threshold.
//
// No TPU kernel of the JAX package does this: its models call flax's
// nn.Dropout, whose mask comes from jax.random inside XLA's program. The
// port draws its masks from a seed tensor on the device (a captured CUDA
// graph reads it at every replay) and from the element's row-major index,
// so the same (seed, site) redraws the same mask in the backward, under
// remat, and in an eager step and a replayed one. The function is
// `horovod_tpu_torch.ops.dropout.dropout_reference` (int64 tensor ops); this
// kernel computes it in one pass: the seed's two 32-bit words are folded
// with the site and mixed once per thread, then each element costs three
// rounds of MurmurHash3's 32-bit finalizer. The backward is the same
// kernel on the incoming gradient (d out / d x is the same mask and
// scale).
//
// Bound: bytes — x read once and out written once (2 x itemsize a
// element), against ~25 integer operations a element that the card's
// integer units issue faster than HBM delivers 4-8 bytes.
//
// Layout: x and out contiguous, n elements, f32, bf16 or fp16. The seed is
// read from *seed_ptr when it is not null (a 0-d int64 tensor), else it is
// `seed`.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  h ^= h >> 13;
  h *= 0x2C1B3C6Du;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                   const long long* __restrict__ seed_ptr, long long seed,
                   long long site, uint32_t threshold, float scale) {
  const uint64_t s = (uint64_t)(seed_ptr ? *seed_ptr : seed);
  // The site's seed (`fold_seed`), then the two words of the mask's hash.
  const uint32_t kk = mix32((uint32_t)site ^ 0x3C6EF372u);
  const uint32_t lo = mix32((uint32_t)s ^ kk);
  const uint32_t hi =
      mix32(((uint32_t)(s >> 32) & 0x7FFFFFFFu) ^ lo ^ 0x1B873593u) &
      0x7FFFFFFFu;
  const uint32_t a = mix32(lo ^ 0x243F6A88u);
  const uint32_t b = mix32(hi ^ a);
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const uint32_t h = mix32(mix32((uint32_t)i ^ a) ^ b);
    const bool keep = (h >> 8) >= threshold;
    out[i] = keep ? from_f32<T>(to_f32(x[i]) * scale) : from_f32<T>(0.0f);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long n,
                   const long long* seed_ptr, long long seed, long long site,
                   uint32_t threshold, float scale, cudaStream_t stream) {
  // Enough blocks to fill 132 SMs many times over; each thread loops.
  long long blocks = (n + NT - 1) / NT;
  if (blocks > 132 * 16) blocks = 132 * 16;
  dropout_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, seed_ptr, seed, site,
      threshold, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after the launch (0 = launched). The caller passes contiguous x and out
// of n > 0 elements and threshold = round(rate * 2^24).
extern "C" int hvt_dropout(const void* x, void* out, long long n, int dtype,
                           const void* seed_ptr, long long seed,
                           long long site, unsigned int threshold,
                           float scale, void* stream) {
  const long long* sp = static_cast<const long long*>(seed_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, out, n, sp, seed, site, threshold, scale, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, out, n, sp, seed, site, threshold, scale,
                                st);
  else if (dtype == 2)
    err = launch<__half>(x, out, n, sp, seed, site, threshold, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
