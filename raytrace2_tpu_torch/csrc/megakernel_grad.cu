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
// kernels; the packed tables (with the cluster tables) and the ntab operand
// are staged in shared memory (stage_tables) and the pre-pass calls the
// forward's own camera_ray and bounce — the winner search is the forward's
// sweep, cluster skip included — so the replayed primal is the forward's
// f32 sequence. The backward replays only the winner's record test. A
// thread keeps its path's per-bounce entry carries and winners (at most
// 64 x 44 B) in local memory: shared memory for its first bounces measured
// no faster (the tape stays in L1).
// Table cotangents go to a shared-memory copy of the packed layout with one
// shared atomic per lane and entry (a warp-aggregated form, peers summing by
// shuffles first, measured 10 % slower on Cornell: PERF.md), flushed with
// one global atomicAdd per nonzero entry per block; a scene whose two
// copies would not fit in shared memory adds to device memory directly.
// These atomics are most of a Cornell launch (tools/profile_grad.py: 48 of
// 120 ms without them), but not by contention: 32 shared copies, one per
// lane of a warp, or device memory take the same time (PERF.md).
// Camera and background cotangents stay in registers, are reduced by warp
// shuffles, and take one atomic per warp and per block. An optional counter
// takes the number of replayed bounces (one atomic per warp), from which a
// caller computes the kernel's bound. Float atomics make the summation order
// vary from run to run, so results agree with the plain version to
// rounding, not bitwise.
//
// What bounds it on this card: f32 ALU and special-function work — the
// forward's sweep in the pre-pass plus, per bounce, a resolve, a shade and
// its adjoint (for noise textures, 7 octaves x 8 lattice corners of hashing
// or table gathers with their gradients). Device memory traffic is the cotangent input
// (12 B per pixel), the tables and the outputs.
//
// Scene-specialised instances, as the JAX kernel is traced per scene with
// its family sizes, has_checker and has_noise static: the library is built
// per feature mask (-DGRAD_FEATURES=<mask>, path_common.cuh kF*), so
// Cornell's instance holds only the quad test, its materials and the
// background, and no sphere, box, medium, checker or noise code.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -DGRAD_FEATURES=<mask> (ops/kernels/build.py,
//        one library per mask, built at first use). Bound through ctypes.

#include "grad_adjoint.cuh"

#ifndef GRAD_FEATURES
#define GRAD_FEATURES 511
#endif

namespace {

constexpr uint32_t kGradFeat = GRAD_FEATURES;

// Block sums of the camv and background cotangents (19 + 3, padded).
constexpr int kRedFloats = 24;
// A block's shared memory on Hopper (with the opt-in).
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int grad_smem_bytes(const Counts& c, bool shared_cot) {
  return block_smem_bytes(c) + (kRedFloats + (shared_cot ? table_floats(c) : 0)) *
                                   (int)sizeof(float);
}

template <uint32_t F, bool kPrepass>
__global__ void __launch_bounds__(kThreads)
megakernel_grad(const float* __restrict__ camv_g, int seed, const float* __restrict__ bg_g,
                const float* __restrict__ tables_g, const float* __restrict__ ntab_g,
                Counts c, int n_pix, int max_depth,
                int checker_depth, int has_noise, const float* __restrict__ g_g,
                float* __restrict__ d_camv_g, float* __restrict__ d_bg_g,
                float* __restrict__ d_tables_g, int shared_cot,
                unsigned long long* __restrict__ bounces_g) {
  extern __shared__ float smem[];
  const int n_tab = table_floats(c);
  float* red = smem + stage_floats(c);
  float* dtab = shared_cot ? red + kRedFloats : d_tables_g;
  for (int i = threadIdx.x; i < kRedFloats; i += blockDim.x) red[i] = 0.0f;
  if (shared_cot) {
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) dtab[i] = 0.0f;
  }
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, ntab_g, c);  // synchronises
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
    replayed = grad_slot<F, kPrepass>(T, c, cv, bg, seed, lane, max_depth, checker_depth,
                                      has_noise != 0, g, D, dcam, dbg);
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

// Launch instance <F, kPrepass> on `stream`; returns the cudaError_t of the
// launch.
template <uint32_t F, bool kPrepass>
int launch_grad(int device, const float* camv, int seed, const float* bg, const float* tables,
                const Counts& c, const float* ntab, int n_pix, int max_depth, int checker_depth,
                int has_noise, const float* g, float* d_camv, float* d_bg, float* d_tables,
                int shared_cot, unsigned long long* bounces, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_pix <= 0) return (int)cudaSuccess;
  if (max_depth > kGradMaxDepth) return (int)cudaErrorInvalidValue;
  int smem = grad_smem_bytes(c, shared_cot != 0);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(megakernel_grad<F, kPrepass>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (n_pix + kThreads - 1) / kThreads;
  megakernel_grad<F, kPrepass><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      camv, seed, bg, tables, ntab, c, n_pix, max_depth, checker_depth, has_noise, g, d_camv,
      d_bg, d_tables, shared_cot, bounces);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs, with the table
// cotangents in shared memory (shared_cot = 1) or in device memory.
int megakernel_grad_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med,
                               int n_box, int hier_sph, int hier_box, int n_noise,
                               int shared_cot) {
  return grad_smem_bytes(
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise},
      shared_cot != 0);
}

// Launch on `stream`; returns the cudaError_t of the launch. `g` is the
// radiance cotangent [n_pix, 3]; d_camv [28], d_bg [3] and d_tables must be
// zeroed by the caller. `bounces` (optional) gets the number of bounces the
// kernel replayed added to it. `ntab` holds n_noise Perlin tables (null for
// hash noise); it takes no cotangent. A depth above kGradMaxDepth, the size
// of a thread's carry store, is refused.
int megakernel_grad_launch(int device, const float* camv, int seed, const float* bg,
                           const float* tables, int n_sph, int n_quad, int n_mat, int n_tex,
                           int n_med, int n_box, int hier_sph, int hier_box, const float* ntab,
                           int n_noise, int n_pix, int max_depth, int checker_depth,
                           int has_noise, const float* g, float* d_camv, float* d_bg,
                           float* d_tables, int shared_cot, unsigned long long* bounces,
                           void* stream) {
  return launch_grad<kGradFeat, false>(
      device, camv, seed, bg, tables,
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise}, ntab,
      n_pix, max_depth, checker_depth, has_noise, g, d_camv, d_bg, d_tables, shared_cot,
      bounces, stream);
}

// The feature mask this library was built for.
int megakernel_grad_features() { return (int)kGradFeat; }

// Resident threads per SM of this library's kernel at `smem` bytes of shared
// memory per block (the occupancy calculator), or -1 on an error.
int megakernel_grad_threads_per_sm(int smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(megakernel_grad<kGradFeat, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, megakernel_grad<kGradFeat, false>,
                                                    kThreads, smem) != cudaSuccess)
    return -1;
  return blocks * kThreads;
}

const char* megakernel_grad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
