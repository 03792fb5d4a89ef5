// Sorted-wavefront K-bounce step for Hopper (sm_90a).
//
// Replaces the TPU kernel raytrace2_tpu/ops/pallas/wavefront_sorted.py ::
// _bounce_step_kernel (built by build_step, launched by
// trace_wavefront_batch). The path state of every pixel slot lives in device
// memory between launches as 17 f32 columns, [17, n_slots] (the STATE_KEYS
// order of ops/kernels/wavefront.py); between launches the host sorts the
// slots by a coherence key and gathers the columns. One launch advances every
// slot by up to K steps of "regenerate if dead and samples remain, then one
// bounce", exactly v4's per-lane semantics.
//
// Why per-slot stepping gives the TPU tile's answer: the Pallas tile runs up
// to K steps while any lane of the tile is runnable, but on a lane that is
// not runnable a step changes nothing (no regeneration is needed and a
// bounce of a dead path is a no-op). So each thread loads its slot's 17
// floats (coalesced: one column at a time across the warp), runs up to K
// steps while its own slot is runnable, and stores them back; no state is
// shared between threads. A slot that could not run is not written.
//
// What bounds it on this card: the closest-hit sweep's operations, as in
// megakernel_v4.cu (whose device code it shares through path_common.cuh —
// the cluster skip and table noise included — so a path computes the same
// f32 sequence in both kernels and the images are bitwise equal). The sort
// between launches gives neighbouring threads nearby origins and the same
// direction octant, so they tend to take the same visit order and enter the
// same clusters. The state traffic is 136 B per slot per launch, read and
// written: about 49 MB at 600x600, some 15 us at 3.35 TB/s, small beside the
// sweep. The scene tables, cluster tables, camv and ntab are staged in
// dynamic shared memory per block as v4 does (book 2: about 60 KB, inside
// the 227 KB opt-in).
//
// Build: as megakernel_v4.cu (ops/kernels/build.py, -fmad=false), bound
//        through ctypes.

#include "path_common.cuh"

namespace {

// Row of each state column in the [17, n_slots] state (wavefront.STATE_KEYS).
enum StateCol { S_LANE, PID, BN, AL, OX, OY, OZ, DX, DY, DZ, TM, TPR, TPG, TPB,
                RR, RG, RB, N_STATE_COLS };

__global__ void __launch_bounds__(kThreads)
wavefront_step(const float* __restrict__ camv_g, int seed, const float* __restrict__ bg_g,
               const float* __restrict__ tables_g, const float* __restrict__ ntab_g, Counts c,
               float* __restrict__ state, int n_slots, int k_bounces, int max_depth,
               int checker_depth, int has_noise) {
  extern __shared__ float smem[];
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, ntab_g, c);
  const float* bg = cv + kCamvLen;

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_slots) return;
  const Tables T = make_tables(smem, c);
  float* col = state + lane;
  const size_t n = (size_t)n_slots;

  float s_lane = col[S_LANE * n];
  const float pid = col[PID * n];
  Path s{col[BN * n],  col[AL * n],  col[OX * n],  col[OY * n],  col[OZ * n],
         col[DX * n],  col[DY * n],  col[DZ * n],  col[TPR * n], col[TPG * n],
         col[TPB * n], col[RR * n],  col[RG * n],  col[RB * n]};
  float tm = col[TM * n];

  const float width = cv[19];
  const float s0 = cv[21], n_samples = cv[22], sqrt_spp = cv[23];
  // Pixel ids are < 2^24, exact in f32; padding slots carry pid = -1.
  const bool in_grid = pid >= 0.0f;
  const float yy = floorf(pid / width);
  const float xx = pid - yy * width;
  const uint32_t pid_u = (uint32_t)(int32_t)pid;
  uint32_t key = sample_key(seed, pid_u, (int)(s0 + s_lane));

  int steps = 0;
  while (steps < k_bounces && (s.alive > 0.0f || (s_lane < n_samples - 1.0f && in_grid))) {
    if (s.alive <= 0.0f) {
      s_lane += 1.0f;
      const float sg = s0 + s_lane;
      key = sample_key(seed, pid_u, (int)sg);
      camera_ray(s, tm, cv, key, xx, yy, sg, sqrt_spp);
    }
    bounce(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0);
    ++steps;
  }
  if (steps == 0) return;
  col[S_LANE * n] = s_lane;
  col[BN * n] = s.bn;
  col[AL * n] = s.alive;
  col[OX * n] = s.ox;
  col[OY * n] = s.oy;
  col[OZ * n] = s.oz;
  col[DX * n] = s.dx;
  col[DY * n] = s.dy;
  col[DZ * n] = s.dz;
  col[TM * n] = tm;
  col[TPR * n] = s.tpr;
  col[TPG * n] = s.tpg;
  col[TPB * n] = s.tpb;
  col[RR * n] = s.rr;
  col[RG * n] = s.rg;
  col[RB * n] = s.rb;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
int wavefront_step_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med,
                              int n_box, int hier_sph, int hier_box, int n_noise) {
  return block_smem_bytes(
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise});
}

int wavefront_step_state_cols() { return N_STATE_COLS; }

// Advance `state` [17, n_slots] in place on `stream`; returns the cudaError_t
// of the launch. `ntab` holds n_noise Perlin tables (null for hash noise).
int wavefront_step_launch(int device, const float* camv, int seed, const float* bg,
                          const float* tables, int n_sph, int n_quad, int n_mat, int n_tex,
                          int n_med, int n_box, int hier_sph, int hier_box, const float* ntab,
                          int n_noise, float* state, int n_slots, int k_bounces, int max_depth,
                          int checker_depth, int has_noise, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_slots <= 0 || k_bounces <= 0) return (int)cudaSuccess;
  Counts c{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise};
  int smem = block_smem_bytes(c);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(wavefront_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (n_slots + kThreads - 1) / kThreads;
  wavefront_step<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      camv, seed, bg, tables, ntab, c, state, n_slots, k_bounces, max_depth, checker_depth,
      has_noise);
  return (int)cudaGetLastError();
}

const char* wavefront_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
