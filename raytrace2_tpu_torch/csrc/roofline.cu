// Ceiling microkernels of raytrace2_tpu_torch/tools/roofline.py --mode
// ceilings (port of tools/roofline.py's ceilings(): an FMA chain and a
// streaming copy, measured on the card the kernels run on), built only by
// that tool and the split phase of chip_smoke.py. Each thread runs kChains
// independent dependent chains, so the issue rate and not the latency
// bounds the loop:
//   0 fma     x = fma(x, y, c): 2 f32 operations per instruction, the rate
//             the 67 TFLOP/s data-sheet figure counts;
//   1 mul_add x = (x * y) + c as two instructions, a multiply and an add
//             rounded apart, as every kernel of the port computes
//             (-fmad=false): the f32 ceiling of that code;
//   2 mix     h = mix(h ^ k), the murmur fmix32 of path_common.cuh (the RNG's
//             hashing, which the bounds leave out): 9 integer operations;
// and a streaming float4 copy (bytes read + written per second). y, c and k
// are launch arguments, so nothing folds; x stays near 1 (no denormals).
//
// Build: as the kernels (ops/kernels/build.py: -fmad=false; the fma chain
// uses __fmaf_rn, the mul_add chain __fmul_rn and __fadd_rn, so the flag
// changes neither).

#include "path_common.cuh"

namespace {

constexpr int kChains = 8;

template <int kWhich>
__global__ void chain(float* __restrict__ out, int iters, float y, float c, uint32_t k) {
  float x[kChains];
  uint32_t h[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    x[i] = 1.0f + 1e-3f * (float)((threadIdx.x + i) & 7);
    h[i] = (blockIdx.x * blockDim.x + threadIdx.x) * kChains + i;
  }
#pragma unroll 16
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if constexpr (kWhich == 0) x[i] = __fmaf_rn(x[i], y, c);
      if constexpr (kWhich == 1) x[i] = __fadd_rn(__fmul_rn(x[i], y), c);
      if constexpr (kWhich == 2) h[i] = mix(h[i] ^ k);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) acc += kWhich == 2 ? (float)(h[i] & 0xffu) : x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void copy(const float4* __restrict__ src, float4* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += stride)
    dst[i] = src[i];
}

}  // namespace

extern "C" {

int roofline_chains() { return kChains; }

// Chain `which` (0 fma, 1 mul_add, 2 mix) over blocks x threads threads,
// `iters` steps of kChains chains each; out [blocks * threads] f32.
int roofline_chain_launch(int which, int device, float* out, int blocks, int threads, int iters,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float y = 0.9999f, c = 1e-4f;
  const uint32_t k = 0x9E3779B9u;
  cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0: chain<0><<<blocks, threads, 0, s>>>(out, iters, y, c, k); break;
    case 1: chain<1><<<blocks, threads, 0, s>>>(out, iters, y, c, k); break;
    case 2: chain<2><<<blocks, threads, 0, s>>>(out, iters, y, c, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Copy n_float4 float4s from src to dst with `blocks` blocks of 256.
int roofline_copy_launch(int device, const void* src, void* dst, long long n_float4, int blocks,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  copy<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float4*)src, (float4*)dst, n_float4);
  return (int)cudaGetLastError();
}

const char* roofline_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
