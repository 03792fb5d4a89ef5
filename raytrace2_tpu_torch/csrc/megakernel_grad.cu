// Indexed-replay gradient kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel raytrace2_tpu/ops/pallas/megakernel_grad.py ::
// _grad_kernel (launched by _grad_call): the backward of the v4 render. For
// each pixel slot and each of the batch's samples it re-traces the path
// (the counter-hash RNG makes it a pure function of seed, pixel and sample,
// so nothing is kept from the forward), records every bounce's winner and
// entry carry, and walks the bounces back with the hand-derived adjoint of
// grad_adjoint.cuh. Outputs (zeroed by the caller, accumulated here): the
// cotangents of camv[0:19], of the background, and of the packed tables
// (the GRAD_*_KEYS rows; every other entry stays 0).
//
// Design. One thread per pixel slot, 128 threads per block, as the forward
// kernels; the packed tables are staged in shared memory (stage_tables) and
// the pre-pass calls the forward's own camera_ray and bounce, so the
// replayed primal is the forward's f32 sequence. A thread keeps its path's
// per-bounce entry carries and winners (at most 64 x 40 B) in local memory.
// Table cotangents go to a shared-memory copy of the packed layout with one
// shared atomic per lane and entry (a warp-aggregated form, peers summing by
// shuffles first, measured 10 % slower on Cornell: PERF.md), flushed with
// one global atomicAdd per nonzero entry per block; a scene whose two
// copies would not fit in shared memory adds to device memory directly.
// Camera and background cotangents stay in registers, are reduced by warp
// shuffles, and take one atomic per warp and per block. An optional counter
// takes the number of replayed bounces (one atomic per warp), from which a
// caller computes the kernel's bound. Float atomics make the summation order
// vary from run to run, so results agree with the plain version to
// rounding, not bitwise.
//
// What bounds it on this card: f32 ALU and special-function work — the
// forward's sweep in the pre-pass plus, per bounce, a resolve, a shade and
// its adjoint (for noise textures, 8 octaves x 8 lattice corners of hashing
// with their gradients). Device memory traffic is the cotangent input
// (12 B per pixel), the tables and the outputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (ops/kernels/build.py). Bound through ctypes.

#include "grad_adjoint.cuh"

namespace {

// Block sums of the camv and background cotangents (19 + 3, padded).
constexpr int kRedFloats = 24;

__host__ __device__ inline int grad_smem_bytes(const Counts& c, bool shared_cot) {
  return block_smem_bytes(c) + (kRedFloats + (shared_cot ? table_floats(c) : 0)) *
                                   (int)sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
megakernel_grad(const float* __restrict__ camv_g, int seed, const float* __restrict__ bg_g,
                const float* __restrict__ tables_g, Counts c, int n_pix, int max_depth,
                int checker_depth, int has_noise, const float* __restrict__ g_g,
                float* __restrict__ d_camv_g, float* __restrict__ d_bg_g,
                float* __restrict__ d_tables_g, int shared_cot,
                unsigned long long* __restrict__ bounces_g) {
  extern __shared__ float smem[];
  const int n_tab = table_floats(c);
  float* red = smem + n_tab + kCamvLen + 4;
  float* dtab = shared_cot ? red + kRedFloats : d_tables_g;
  for (int i = threadIdx.x; i < kRedFloats; i += blockDim.x) red[i] = 0.0f;
  if (shared_cot) {
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) dtab[i] = 0.0f;
  }
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, c);  // synchronises
  const float* bg = cv + kCamvLen;
  const Tables T = make_tables(smem, c);
  const Cot D = make_cot(dtab, c);

  float dcam[kNCamvDiff], dbg[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kNCamvDiff; ++i) dcam[i] = 0.0f;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long replayed = 0;
  if (lane < n_pix) {
    const float g[3] = {g_g[3 * lane], g_g[3 * lane + 1], g_g[3 * lane + 2]};
    replayed = grad_slot(T, c, cv, bg, seed, lane, max_depth, checker_depth, has_noise != 0, g,
                         D, dcam, dbg);
  }
  if (bounces_g) {
    for (int off = 16; off > 0; off >>= 1) {
      replayed += __shfl_down_sync(0xffffffffu, replayed, off);
    }
    if ((threadIdx.x & 31) == 0 && replayed) atomicAdd(bounces_g, replayed);
  }

  // Camera and background: warp sums, then one shared atomic per warp.
#pragma unroll
  for (int i = 0; i < kNCamvDiff + 3; ++i) {
    float v = i < kNCamvDiff ? dcam[i] : dbg[i - kNCamvDiff];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0 && v != 0.0f) atomicAdd(&red[i], v);
  }
  __syncthreads();
  if (threadIdx.x < kNCamvDiff + 3 && red[threadIdx.x] != 0.0f) {
    float* dst = threadIdx.x < kNCamvDiff ? &d_camv_g[threadIdx.x]
                                          : &d_bg_g[threadIdx.x - kNCamvDiff];
    atomicAdd(dst, red[threadIdx.x]);
  }
  if (shared_cot) {
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) {
      if (dtab[i] != 0.0f) atomicAdd(&d_tables_g[i], dtab[i]);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs, with the table
// cotangents in shared memory (shared_cot = 1) or in device memory.
int megakernel_grad_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med,
                               int n_box, int shared_cot) {
  return grad_smem_bytes(Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box}, shared_cot != 0);
}

// Launch on `stream`; returns the cudaError_t of the launch. `g` is the
// radiance cotangent [n_pix, 3]; d_camv [28], d_bg [3] and d_tables must be
// zeroed by the caller. `bounces` (optional) gets the number of bounces the
// kernel replayed added to it. A depth above kGradMaxDepth, the size of a
// thread's carry store, is refused.
int megakernel_grad_launch(int device, const float* camv, int seed, const float* bg,
                           const float* tables, int n_sph, int n_quad, int n_mat, int n_tex,
                           int n_med, int n_box, int n_pix, int max_depth, int checker_depth,
                           int has_noise, const float* g, float* d_camv, float* d_bg,
                           float* d_tables, int shared_cot, unsigned long long* bounces,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_pix <= 0) return (int)cudaSuccess;
  if (max_depth > kGradMaxDepth) return (int)cudaErrorInvalidValue;
  Counts c{n_sph, n_quad, n_mat, n_tex, n_med, n_box};
  int smem = grad_smem_bytes(c, shared_cot != 0);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(megakernel_grad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (n_pix + kThreads - 1) / kThreads;
  megakernel_grad<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      camv, seed, bg, tables, c, n_pix, max_depth, checker_depth, has_noise, g, d_camv, d_bg,
      d_tables, shared_cot, bounces);
  return (int)cudaGetLastError();
}

const char* megakernel_grad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
