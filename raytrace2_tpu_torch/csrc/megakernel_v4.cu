// v4 path-regeneration megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel raytrace2_tpu/ops/pallas/megakernel.py ::
// _render_kernel_v4 (launched by trace_megakernel_batch). Each thread owns
// one pixel slot and runs its own loop: while its path is alive it bounces;
// when the path ends and samples remain, it regenerates the camera ray of
// its next sample. It returns the radiance summed over the batch's samples,
// [n_slots, 3] f32.
//
// Lane layouts (slot_to_pixel, :1729-1747): linear, slot == pixel id; or
// block-tiled, each tile of kBlockTile = 256 slots one 16x16 pixel block
// (row-major blocks, row-major pixels inside; lanes past the image's edge
// idle). The JAX kernel's tile is 8x128 lanes, a 32x32 block; the port's
// tile is its CUDA block where it matters (wave regeneration), and 256 is
// the square block size v4's registers allow (1,024 threads would cap a
// thread at 64 registers). Keys come from the pixel id, so the image does
// not depend on the layout.
//
// Regeneration. With wave_frac >= 1 it is instant and per thread. Why a
// per-thread loop computes the TPU kernel's result: the TPU loop runs a
// whole tile while any lane is runnable, but every update of a bounce is
// masked by the lane's own `alive`, and regeneration then depends only on
// the lane's own state. So each lane's sequence of bounces is the same, and
// the tile-wide iterations are no-ops on lanes that are done. With
// wave_frac < 1 (:1838-1847) a tile refills its dead lanes only when its
// live count has fallen to wave_frac of its in-image lanes, so fresh camera
// rays enter together, bounce-aligned, and the cluster skip sees coherent
// rays. The tile is the block: its threads step in lockstep, counting live
// lanes with __syncthreads_count each step, as the TPU tile does. The image
// is the same for every wave_frac.
//
// What bounds it on this card: ALU and special-function work in the
// closest-hit sweep and the shading (sqrt, sin/cos, log, the murmur hashes
// and, for noise textures, 7 octaves x 8 lattice corners of hashing or
// table gathers). The cluster skip cuts the sweep of a clustered family to
// the clusters whose boxes the ray's interval meets. Device memory traffic
// is the 12-byte output per slot plus one staging copy of the scene tables
// per block. The design keeps the whole path state in registers for all
// bounces, and stages the packed tables, the cluster tables and the ntab
// operand in shared memory: where the lanes of a warp visit the same
// record, the read is a shared-memory broadcast.
//
// The device code it shares with wavefront_step.cu (tables, RNG, noise, the
// sweep, one bounce, the camera ray) is in path_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (no --use_fast_math; ops/kernels/build.py).
//        Bound through ctypes.

#include "path_common.cuh"

namespace {

constexpr int kBlockTile = 256;  // lanes of a block-tiled tile (megakernel.BLOCK_TILE)
constexpr int kBlockSide = 16;   // its pixel block's side (megakernel.BLOCK)

// kWave: wave regeneration, the block's threads in lockstep (a block is a
// tile: kBlockTile threads on the block layout, kThreads on the linear one);
// else instant per-thread regeneration in blocks of kThreads on either
// layout (the slot -> pixel map does not depend on the block). The minimum
// of 6 (3) resident blocks holds either at 80 registers a thread without a
// spill; left free, ptxas took ~120 for the cluster walk, and the Cornell
// launch ran 13 % slower at 4 blocks per SM (tools/ab_kernels.py --what v4).
template <bool kWave>
__global__ void __launch_bounds__(kWave ? kBlockTile : kThreads, kWave ? 3 : 6)
megakernel_v4(const float* __restrict__ camv_g, int seed, const float* __restrict__ bg_g,
              const float* __restrict__ tables_g, const float* __restrict__ ntab_g, Counts c,
              int n_slots, int block_layout, float wave_frac, int max_depth, int checker_depth,
              int has_noise, float* __restrict__ out) {
  extern __shared__ float smem[];
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, ntab_g, c);
  const float* bg = cv + kCamvLen;
  const Tables T = make_tables(smem, c);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  // Outside the lockstep loop a thread past the end has nothing to do.
  if (!kWave && lane >= n_slots) return;

  // Slot -> pixel; every value < 2^24, exact in f32.
  const float slot_f = (float)(lane + (int)cv[25]);
  const float width = cv[19];
  float xx, yy;
  bool in_grid;
  if (block_layout) {
    const float tile_f = floorf(slot_f * (1.0f / kBlockTile));
    const float within = slot_f - tile_f * kBlockTile;
    const float by = floorf(tile_f / cv[26]);
    const float bx = tile_f - by * cv[26];
    const float ly = floorf(within * (1.0f / kBlockSide));
    const float lx = within - ly * kBlockSide;
    xx = bx * kBlockSide + lx;
    yy = by * kBlockSide + ly;
    in_grid = xx < width && yy < cv[27];
  } else {
    yy = floorf(slot_f / width);
    xx = slot_f - yy * width;
    in_grid = slot_f < cv[20];
  }
  const uint32_t pid = (uint32_t)(int32_t)(yy * width + xx);
  const float s0 = cv[21], n_samples = cv[22], sqrt_spp = cv[23];

  Path s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float s_lane = -1.0f, tm = 0.0f;
  uint32_t key = 0u;
  auto regen = [&]() {
    s_lane += 1.0f;
    const float sg = s0 + s_lane;
    key = sample_key(seed, pid, (int)sg);
    camera_ray(s, tm, cv, key, xx, yy, sg, sqrt_spp);
  };
  if constexpr (!kWave) {
    while (s.alive > 0.0f || (s_lane < n_samples - 1.0f && in_grid)) {
      if (s.alive <= 0.0f) regen();
      bounce(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0);
    }
  } else {
    // Lockstep over the block: every thread takes part in every count.
    const float n_img = (float)__syncthreads_count(in_grid);
    while (true) {
      const bool runnable = s.alive > 0.0f || (s_lane < n_samples - 1.0f && in_grid);
      const float live = (float)__syncthreads_count(s.alive > 0.0f);
      if (!__syncthreads_or(runnable)) break;
      if (s.alive <= 0.0f && s_lane < n_samples - 1.0f && in_grid && live <= wave_frac * n_img)
        regen();
      if (s.alive > 0.0f) bounce(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0);
    }
    if (lane >= n_slots) return;
  }
  out[3 * lane + 0] = s.rr;
  out[3 * lane + 1] = s.rg;
  out[3 * lane + 2] = s.rb;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
int megakernel_v4_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med, int n_box,
                             int hier_sph, int hier_box, int n_noise) {
  return block_smem_bytes(
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise});
}

// Launch on `stream`; returns the cudaError_t of the launch. `ntab` holds
// n_noise Perlin tables ([6, n_noise * 256]; null for hash noise);
// `block_layout` selects the block-tiled layout (n_slots a multiple of 256),
// `wave_frac` < 1 wave regeneration.
int megakernel_v4_launch(int device, const float* camv, int seed, const float* bg,
                         const float* tables, int n_sph, int n_quad, int n_mat, int n_tex,
                         int n_med, int n_box, int hier_sph, int hier_box, const float* ntab,
                         int n_noise, int n_slots, int block_layout, float wave_frac,
                         int max_depth, int checker_depth, int has_noise, float* out,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_slots <= 0) return (int)cudaSuccess;
  if (block_layout && n_slots % kBlockTile) return (int)cudaErrorInvalidValue;
  Counts c{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise};
  const bool wave = wave_frac < 1.0f;
  auto kernel = wave ? megakernel_v4<true> : megakernel_v4<false>;
  int smem = block_smem_bytes(c);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = wave && block_layout ? kBlockTile : kThreads;
  int blocks = (n_slots + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      camv, seed, bg, tables, ntab, c, n_slots, block_layout, wave_frac, max_depth,
      checker_depth, has_noise, out);
  return (int)cudaGetLastError();
}

const char* megakernel_v4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
