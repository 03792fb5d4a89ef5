// The wavefront driver's per-pass keys for Hopper (sm_90a): every slot's
// int32 coherence key and the count of runnable slots, in one pass over the
// [17, n] slot state (ops/kernels/wavefront.py STATE_KEYS), one thread a slot.
//
// Replaces raytrace2_tpu/ops/pallas/wavefront_sorted.py sort_keys (an XLA
// function, not a pallas_call) with the driver's runnable count. The JAX
// package fuses both into its device loop; written as eager PyTorch they cost
// 98 op dispatches (the keys) and 9 more (the count) on the host each pass.
// ops/kernels/wavefront.py holds the wrapper (count_and_keys), which runs the
// plain versions (sort_keys, runnable) on a CPU state.
//
// The key, bit for bit that of sort_keys:
//   * a live slot (al > 0): Morton-7 of the origin in the scene box, then the
//     direction octant (the JAX package's "pos"). Each axis is quantised as
//     clamp((o - lo) * (127 / clamp(hi - lo, 1e-20)), 0, 127), truncated: a
//     true division, with NaN carried through the clamps as torch's clamp
//     carries it, and the float-to-integer conversion torch makes;
//   * a dead slot with samples left (s_lane < regen_below, pid >= 0):
//     2^28 + pid;
//   * a finished or padding slot: 2^30.
// Runnable is alive or samples left; each block counts its slots with
// __syncthreads_count and adds them to `count` with one atomicAdd.
//
// What bounds it on this card: bytes. It reads 9 of the 17 columns (36 B a
// slot) and writes 4 B: at book 2's 360,064 slots 14.4 MB, 4.3 us at
// 3.35 TB/s. Its f32 work (three divisions a slot, the quantisation) is small
// beside that.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (ops/kernels/build.py); bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Columns of the slot state (ops/kernels/wavefront.py STATE_KEYS).
constexpr int kSLane = 0, kPid = 1, kAl = 3, kOx = 4, kDx = 7;
constexpr int kThreads = 256;
constexpr uint64_t kRegenKey = 1ull << 28;
constexpr int kDoneKey = 1 << 30;

// torch.clamp's min and max: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Spread the low 10 bits 3 apart (wavefront.interleave3).
__device__ __forceinline__ uint64_t interleave3(uint64_t x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

__device__ __forceinline__ int live_key(const float* __restrict__ col, size_t n,
                                        const float* __restrict__ bb_lo,
                                        const float* __restrict__ bb_hi) {
  const float top = 127.0f;
  uint64_t morton = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(bb_lo + a);
    const float extent = clamp_min(__ldg(bb_hi + a) - lo, 1e-20f);
    const float inv = top / extent;
    const float q = clamp((__ldg(col + (kOx + a) * n) - lo) * inv, 0.0f, top);
    morton |= interleave3((uint64_t)(long long)q) << a;
  }
  const uint64_t octant = (__ldg(col + kDx * n) < 0.0f ? 4u : 0u) |
                          (__ldg(col + (kDx + 1) * n) < 0.0f ? 2u : 0u) |
                          (__ldg(col + (kDx + 2) * n) < 0.0f ? 1u : 0u);
  return (int)(uint32_t)((morton << 3) | octant);
}

__global__ void __launch_bounds__(kThreads)
    wavefront_keys_kernel(const float* __restrict__ state, int n,
                          const float* __restrict__ bb_lo, const float* __restrict__ bb_hi,
                          float regen_below, int* __restrict__ keys,
                          int* __restrict__ count) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool run = false;
  if (i < n) {
    const size_t stride = (size_t)n;
    const float* col = state + i;
    const float pid = __ldg(col + kPid * stride);
    const bool alive = __ldg(col + kAl * stride) > 0.0f;
    const bool regen = (__ldg(col + kSLane * stride) < regen_below) & (pid >= 0.0f);
    run = alive | regen;
    int key = kDoneKey;
    if (alive)
      key = live_key(col, stride, bb_lo, bb_hi);
    else if (regen)
      key = (int)(uint32_t)(kRegenKey + (uint64_t)(long long)(int)pid);
    keys[i] = key;
  }
  const int runnable = __syncthreads_count(run);
  if (threadIdx.x == 0 && runnable) atomicAdd(count, runnable);
}

}  // namespace

extern "C" {

// Launch on `stream` over the n slots of `state` [17, n]: keys [n] written,
// `count` (one int) zeroed on the stream, then the runnable slots added.
// `regen_below` is n_samples - 1. Returns the cudaError_t of the launch.
int wavefront_keys_launch(int device, const float* state, int n, const float* bb_lo,
                          const float* bb_hi, float regen_below, int* keys,
                          int* count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  wavefront_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      state, n, bb_lo, bb_hi, regen_below, keys, count);
  return (int)cudaGetLastError();
}

const char* wavefront_keys_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
