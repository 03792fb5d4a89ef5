// v4 path-regeneration megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel raytrace2_tpu/ops/pallas/megakernel.py ::
// _render_kernel_v4 (launched by trace_megakernel_batch), in its linear-slot,
// instant-regeneration form. Each thread owns one pixel slot and runs its own
// loop: while its path is alive it bounces; when the path ends and samples
// remain, it regenerates the camera ray of its next sample. It returns the
// radiance summed over the batch's samples, [n_pix, 3] f32.
//
// Why a per-thread loop computes the TPU kernel's result: the TPU loop runs a
// whole 32x128 tile while any lane is runnable, but every update of a bounce
// is masked by the lane's own `alive`, and at wave_frac = 1 regeneration
// depends only on the lane's own state. So each lane's sequence of bounces is
// the same, and the tile-wide iterations are no-ops on lanes that are done.
//
// What bounds it on this card: ALU and special-function work in the
// closest-hit sweep and the shading (sqrt, sin/cos, log, the murmur hashes
// and, for noise textures, 8 octaves x 8 lattice corners of hashing). Device
// memory traffic is the 12-byte output per pixel plus one staging copy of the
// scene tables per block. The design keeps the whole path state in registers
// for all bounces, and stages the packed tables (a few KB for Cornell-class
// scenes) in shared memory: in the flat sweep every thread of a warp reads
// the same record at once, which is a shared-memory broadcast. The material
// and texture resolve is a direct per-thread index into the same tables.
//
// The device code it shares with wavefront_step.cu (tables, RNG, noise, the
// sweep, one bounce, the camera ray) is in path_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (no --use_fast_math; ops/kernels/build.py).
//        Bound through ctypes.

#include "path_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
megakernel_v4(const float* __restrict__ camv_g, int seed, const float* __restrict__ bg_g,
              const float* __restrict__ tables_g, Counts c, int n_pix, int max_depth,
              int checker_depth, int has_noise, float* __restrict__ out) {
  extern __shared__ float smem[];
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, c);
  const float* bg = cv + kCamvLen;

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_pix) return;
  const Tables T = make_tables(smem, c);

  // Linear slots: slot == pixel id (+ slot0); every value < 2^24, exact in f32.
  const float slot_f = (float)(lane + (int)cv[25]);
  const float width = cv[19];
  const float yy = floorf(slot_f / width);
  const float xx = slot_f - yy * width;
  const bool in_grid = slot_f < cv[20];
  const uint32_t pid = (uint32_t)(int32_t)(yy * width + xx);
  const float s0 = cv[21], n_samples = cv[22], sqrt_spp = cv[23];

  Path s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float s_lane = -1.0f, tm = 0.0f;
  uint32_t key = 0u;
  while (s.alive > 0.0f || (s_lane < n_samples - 1.0f && in_grid)) {
    if (s.alive <= 0.0f) {
      // Regenerate: camera ray of the next sample.
      s_lane += 1.0f;
      const float sg = s0 + s_lane;
      key = sample_key(seed, pid, (int)sg);
      camera_ray(s, tm, cv, key, xx, yy, sg, sqrt_spp);
    }
    bounce(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0);
  }
  out[3 * lane + 0] = s.rr;
  out[3 * lane + 1] = s.rg;
  out[3 * lane + 2] = s.rb;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
int megakernel_v4_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med,
                             int n_box) {
  return block_smem_bytes(Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box});
}

// Launch on `stream`; returns the cudaError_t of the launch.
int megakernel_v4_launch(int device, const float* camv, int seed, const float* bg,
                         const float* tables, int n_sph, int n_quad, int n_mat, int n_tex,
                         int n_med, int n_box, int n_pix, int max_depth,
                         int checker_depth, int has_noise, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_pix <= 0) return (int)cudaSuccess;
  Counts c{n_sph, n_quad, n_mat, n_tex, n_med, n_box};
  int smem = megakernel_v4_smem_bytes(n_sph, n_quad, n_mat, n_tex, n_med, n_box);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(megakernel_v4, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (n_pix + kThreads - 1) / kThreads;
  megakernel_v4<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      camv, seed, bg, tables, c, n_pix, max_depth, checker_depth, has_noise, out);
  return (int)cudaGetLastError();
}

const char* megakernel_v4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
