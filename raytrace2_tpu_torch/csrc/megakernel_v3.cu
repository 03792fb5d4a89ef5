// v3 state-passing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel raytrace2_tpu/ops/pallas/megakernel.py ::
// _render_kernel (v3), launched by megakernel_pass and driven by
// trace_megakernel, which the non-kernel path's trace_rays reaches when it
// gets a mega_seed and use_megakernel is set. One launch is one pass over a
// buffer of rays in device memory: each tile keeps bouncing its rays while
// its live count exceeds min_alive, then stops; the host gathers the
// survivors of every tile into a smaller buffer and launches again
// (ops/kernels/megakernel_v3.py::trace_megakernel).
//
// A tile here is one block of kThreads rays (the TPU kernel's is 4,096
// lanes). The image does not depend on where a pass stops, since each ray's
// RNG stream is keyed by its id and bounce count; the driver sizes the next
// buffer from the bound each tile leaves with (<= kThreads / ratio live
// rays), so no live ray is dropped.
//
// Each thread owns one ray: it loads the ray's state (coalesced, one column
// at a time across the warp), derives its stream key
// mix(rid * 0x9E3779B9 ^ mix(seed_lane)) (megakernel.py:1440-1441, the
// construction of v4's sample_key), and runs the shared `bounce` of
// path_common.cuh while the block's live count, taken with
// __syncthreads_count each bounce, exceeds min_alive (every thread takes part
// in the count, dead or past the end). A dead thread waits. The ray id is an
// int32 column, not an f32 bit pattern.
//
// What bounds it on this card: the closest-hit sweep's operations (with the
// cluster skip of path_common.cuh for clustered families), as in
// megakernel_v4.cu; the state traffic is 48 B read and 60 B written per ray
// and pass. The scene and cluster tables and the background are staged in
// dynamic shared memory per block (stage_tables). Noise is always hash
// noise, as in the JAX v3 kernel.
//
// Build: as megakernel_v4.cu (ops/kernels/build.py, -fmad=false), bound
//        through ctypes.

#include "path_common.cuh"

namespace {

// Row of each column of the [12, n] state (megakernel_v3.STATE_KEYS).
enum V3Col { V_OX, V_OY, V_OZ, V_DX, V_DY, V_DZ, V_TM, V_BN, V_AL, V_TPR, V_TPG, V_TPB,
             N_V3_COLS };

// At least 6 resident blocks: 80 registers a thread without a spill (96
// uncapped, with the cluster walk), 3 % faster a Cornell pass
// (tools/ab_kernels.py --what wf; the wavefront step, at 123, ran 30 %
// slower capped so).
__global__ void __launch_bounds__(kThreads, 6)
megakernel_v3(const float* __restrict__ bg_g, const float* __restrict__ tables_g, Counts c,
              float* __restrict__ state, const int* __restrict__ rid, int n, int seed_lane,
              int min_alive, int max_depth, int checker_depth, int has_noise,
              float* __restrict__ radiance) {
  extern __shared__ float smem[];
  const float* bg = stage_tables(smem, nullptr, bg_g, tables_g, nullptr, c) + kCamvLen;
  const Tables T = make_tables(smem, c);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n;
  float* col = state + lane;
  const size_t pitch = (size_t)n;
  Path s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float tm = 0.0f;
  uint32_t key = 0u;
  if (live) {
    s = Path{col[V_BN * pitch], col[V_AL * pitch], col[V_OX * pitch], col[V_OY * pitch],
             col[V_OZ * pitch], col[V_DX * pitch], col[V_DY * pitch], col[V_DZ * pitch],
             col[V_TPR * pitch], col[V_TPG * pitch], col[V_TPB * pitch], 0.f, 0.f, 0.f};
    tm = col[V_TM * pitch];
    key = mix((uint32_t)rid[lane] * 0x9E3779B9u ^ mix((uint32_t)seed_lane));
  }
  while (__syncthreads_count(s.alive > 0.0f) > min_alive) {
    if (s.alive > 0.0f) bounce(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0);
  }
  if (!live) return;
  col[V_OX * pitch] = s.ox;
  col[V_OY * pitch] = s.oy;
  col[V_OZ * pitch] = s.oz;
  col[V_DX * pitch] = s.dx;
  col[V_DY * pitch] = s.dy;
  col[V_DZ * pitch] = s.dz;
  col[V_BN * pitch] = s.bn;
  col[V_AL * pitch] = s.alive;
  col[V_TPR * pitch] = s.tpr;
  col[V_TPG * pitch] = s.tpg;
  col[V_TPB * pitch] = s.tpb;
  radiance[3 * lane + 0] = s.rr;
  radiance[3 * lane + 1] = s.rg;
  radiance[3 * lane + 2] = s.rb;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
int megakernel_v3_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med,
                             int n_box, int hier_sph, int hier_box) {
  return block_smem_bytes(Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, 0});
}

int megakernel_v3_state_cols() { return N_V3_COLS; }

int megakernel_v3_tile() { return kThreads; }

// One pass over `state` [12, n] (updated in place) and `rid` [n], writing
// this pass's radiance [n, 3], on `stream`; returns the cudaError_t of the
// launch.
int megakernel_v3_launch(int device, const float* bg, const float* tables, int n_sph,
                         int n_quad, int n_mat, int n_tex, int n_med, int n_box, int hier_sph,
                         int hier_box, float* state,
                         const int* rid, int n, int seed_lane, int min_alive, int max_depth,
                         int checker_depth, int has_noise, float* radiance, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  Counts c{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, 0};
  int smem = block_smem_bytes(c);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(megakernel_v3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (n + kThreads - 1) / kThreads;
  megakernel_v3<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      bg, tables, c, state, rid, n, seed_lane, min_alive, max_depth, checker_depth, has_noise,
      radiance);
  return (int)cudaGetLastError();
}

const char* megakernel_v3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
