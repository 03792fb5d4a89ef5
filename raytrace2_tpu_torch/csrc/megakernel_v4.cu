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
// the lane's own state. So each pixel's sequence of bounces is the same, and
// the tile-wide iterations are no-ops on lanes that are done. With
// wave_frac < 1 (:1838-1847) a tile refills its dead lanes only when its
// live count has fallen to wave_frac of its in-image lanes, so fresh camera
// rays enter together, bounce-aligned, and the cluster skip sees coherent
// rays. The tile is the block: its threads step in lockstep, counting live
// lanes with __syncthreads_count each step, as the TPU tile does. The image
// is the same for every wave_frac.
//
// What bounds it on this card: f32 ALU and special-function work in the
// closest-hit sweep and the shading (sqrt, sin/cos, log, the murmur hashes
// and, for noise textures, 7 octaves x 8 lattice corners of hashing or
// table gathers), issued as separate multiplies and adds (-fmad=false).
// The cluster skip cuts the sweep of a clustered family to the clusters
// whose boxes the ray's interval meets. Device memory traffic is the
// 12-byte output per slot plus one staging copy of the scene tables per
// block. The whole path state stays in registers for all bounces, and the
// packed tables, the cluster tables and the ntab operand are staged in
// shared memory: where the lanes of a warp visit the same record, the read
// is a shared-memory broadcast.
//
// Design for Hopper (tools/roofline.py --mode split measured the earlier
// one-pixel-per-thread kernel: on Cornell 43 % of lane-cycles idle while
// warp-mates finished longer pixels, and a 3.55-wave grid; each choice
// below won in turns against the alternatives, PERF.md):
//   * Persistent blocks with per-lane pixel fetch (instant regeneration, on
//     either layout): the grid is the resident block count
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, at most
//     kPersistentBlocksPerSM) x the SMs. A thread starts on
//     slot blockIdx.x * blockDim.x + threadIdx.x; when all samples of its
//     pixel are done it stores the pixel's sum and takes the next slot from
//     a device counter (grid threads + a warp-aggregated atomicAdd of the
//     lanes fetching together). A pixel's samples still run in order on one
//     thread and are summed in the same order, so the image is bitwise the
//     one-pixel-per-thread kernel's; only which thread runs which pixel
//     changes. The counter is scratch of the caller's, zeroed on the
//     launch's stream by the launch itself.
//   * One instance per scene feature mask (-DV4_FEATURES=<mask>, built at
//     first use; path_common.cuh kF*): Cornell's holds the quad test,
//     Lambertian and light only.
//   * The kernel with wave regeneration keeps its per-tile lockstep, the
//     per-lane cluster walk (the wavefront step's warp walk measured no
//     faster there) and every feature: book 2's mask instance of it
//     spilled and ran 1-10 % slower than the parent's in turns.
//
// Counter. Given a non-null `tally` (two uint64), a launch adds its path
// segments (closest-hit queries: one a bounce of a lane) to tally[0] and
// its medium scatters (segments whose closest hit was a medium) to
// tally[1]. In the persistent kernel each lane sums its own in registers
// across the launch and adds them at its exit, where the pointer is
// non-null: a warp's sums, one atomic a warp. It adds a path's segments
// once, as its bounce count when the lane takes its next path, and counts
// medium scatters only in an instance that holds media, so a launch
// without a counter pays one add a path. The renderer passes it only while a
// profiler records (megakernel.SEGMENTS, megakernel.MEDIUM_SCATTERS). The
// image is the same either way.
//
// The device code it shares with wavefront_step.cu (tables, RNG, noise, the
// sweep, one bounce, the camera ray) is in path_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -DV4_FEATURES=<mask> (no --use_fast_math;
//        ops/kernels/build.py, one library per mask). Bound through ctypes.

#include <cooperative_groups.h>

#include "path_common.cuh"

#ifndef V4_FEATURES
#define V4_FEATURES 511
#endif

namespace {

namespace cg = cooperative_groups;

constexpr uint32_t kV4Feat = V4_FEATURES;
constexpr int kBlockTile = 256;  // lanes of a block-tiled tile (megakernel.BLOCK_TILE)
constexpr int kBlockSide = 16;   // its pixel block's side (megakernel.BLOCK)

// The persistent kernel's register budget and grid. __launch_bounds__ asks
// for 6 resident 128-thread blocks (80 registers): an instance that holds
// the cluster walk uses all 80 without a spill (ptxas took ~120 left free,
// 13 % slower); Cornell's takes 64 under any cap from 80 to 128 and ran 6 %
// slower held to 56 (8 blocks). The grid keeps at most 6 blocks an SM
// resident: Cornell's instance, which fits 8, ran 8 % faster at 6 (fewer
// threads, each taking more pixels, shorten the tail after the last fetch).
constexpr int kPersistentMinBlocks = 6;
constexpr int kPersistentBlocksPerSM = 6;

// Slot -> pixel (JAX slot_to_pixel, :1729-1747); every value < 2^24, exact
// in f32. Linear: slot == pixel id; block-tiled: each kBlockTile slots one
// kBlockSide^2 pixel block, lanes past the image's edge out of the grid.
struct Pixel {
  float xx, yy;
  bool in_grid;
  uint32_t pid;
};

__device__ __forceinline__ Pixel slot_pixel(int slot, const float* cv, int block_layout) {
  const float slot_f = (float)(slot + (int)cv[25]);
  const float width = cv[19];
  Pixel px;
  if (block_layout) {
    const float tile_f = floorf(slot_f * (1.0f / kBlockTile));
    const float within = slot_f - tile_f * kBlockTile;
    const float by = floorf(tile_f / cv[26]);
    const float bx = tile_f - by * cv[26];
    const float ly = floorf(within * (1.0f / kBlockSide));
    const float lx = within - ly * kBlockSide;
    px.xx = bx * kBlockSide + lx;
    px.yy = by * kBlockSide + ly;
    px.in_grid = px.xx < width && px.yy < cv[27];
  } else {
    px.yy = floorf(slot_f / width);
    px.xx = slot_f - px.yy * width;
    px.in_grid = slot_f < cv[20];
  }
  px.pid = (uint32_t)(int32_t)(px.yy * width + px.xx);
  return px;
}

// Add a lane's segments and medium scatters to tally[0] and tally[1]: a
// warp's sums, one atomic each a warp. Every lane of the warp calls it.
__device__ __forceinline__ void add_tally(unsigned long long* tally, unsigned segs,
                                          unsigned meds) {
  const unsigned warp_segs = __reduce_add_sync(0xffffffffu, segs);
  const unsigned warp_meds = __reduce_add_sync(0xffffffffu, meds);
  if ((threadIdx.x & 31) == 0) {
    if (warp_segs) atomicAdd(tally, (unsigned long long)warp_segs);
    if (warp_meds) atomicAdd(tally + 1, (unsigned long long)warp_meds);
  }
}

// The next slot for each lane that calls it together: one atomicAdd per
// group of coalesced lanes, each taking the group's base plus its rank.
__device__ __forceinline__ int fetch_slot(int* counter) {
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, (int)g.size());
  return g.shfl(base, 0) + (int)g.thread_rank();
}

// Instant regeneration on persistent blocks of kThreads. `next_slot` is the
// zeroed fetch counter; `tally` (or null) gets the counts added. Clock:
// the profiling build's phase clock (megakernel_profile.cu), whose sums go
// to `prof`; NoClock here.
template <uint32_t F, class Clock>
__global__ void __launch_bounds__(kThreads, kPersistentMinBlocks)
megakernel_v4(const float* __restrict__ camv_g, int seed, const float* __restrict__ bg_g,
              const float* __restrict__ tables_g, const float* __restrict__ ntab_g, Counts c,
              int n_slots, int block_layout, int max_depth, int checker_depth, int has_noise,
              int* __restrict__ next_slot, float* __restrict__ out,
              unsigned long long* __restrict__ tally, unsigned long long* __restrict__ prof) {
  using K = Cfg<false, Sweep::kLane, F, Clock>;
  Clock clk;
  const long long t_all = tick<Clock>();
  extern __shared__ float smem[];
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, ntab_g, c);
  const float* bg = cv + kCamvLen;
  const Tables T = make_tables(smem, c);
  tock(&clk, kPhStage, t_all);

  const int grid_threads = gridDim.x * blockDim.x;
  int slot = blockIdx.x * blockDim.x + threadIdx.x;
  Pixel px = slot_pixel(slot, cv, block_layout);
  const float s0 = cv[21], n_samples = cv[22], sqrt_spp = cv[23];

  Path s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float s_lane = -1.0f, tm = 0.0f;
  uint32_t key = 0u;
  unsigned segs = 0u;
  [[maybe_unused]] unsigned meds = 0u;
  if constexpr (Clock::kOn) clk.begin();
  while (slot < n_slots) {
    if (s.alive <= 0.0f) {
      if (!(s_lane < n_samples - 1.0f && px.in_grid)) {
        // Every sample of this pixel is done: store its sum, take the next.
        const long long t0 = tick<Clock>();
        out[3 * slot + 0] = s.rr;
        out[3 * slot + 1] = s.rg;
        out[3 * slot + 2] = s.rb;
        slot = grid_threads + fetch_slot(next_slot);
        px = slot_pixel(slot, cv, block_layout);
        s_lane = -1.0f;
        s.rr = s.rg = s.rb = 0.0f;
        tock(&clk, kPhStore, t0);
        continue;
      }
      const long long t0 = tick<Clock>();
      segs += (unsigned)s.bn;  // the lane's last path (0 before its first)
      s_lane += 1.0f;
      const float sg = s0 + s_lane;
      key = sample_key(seed, px.pid, (int)sg);
      camera_ray(s, tm, cv, key, px.xx, px.yy, sg, sqrt_spp);
      tock(&clk, kPhCamera, t0);
    }
    [[maybe_unused]] const bool med =
        bounce<K>(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0, nullptr, &clk);
    if constexpr ((F & kFMed) != 0) meds += med ? 1u : 0u;
    if constexpr (Clock::kOn) clk.mark();
  }
  // Every thread of the block gets here, its last path not yet counted.
  if (tally) add_tally(tally, segs + (unsigned)s.bn, meds);
  if constexpr (Clock::kOn) {
    clk.lanes_done();
    tock(&clk, kPhTotal, t_all);
    clk.flush(prof);
  }
}

// Wave regeneration (wave_frac < 1): the block's threads in lockstep (a
// block is a tile: kBlockTile threads on the block layout, kThreads on the
// linear one), every feature held. The minimum of 3 resident blocks holds
// it at 80 registers a thread without a spill. `tally` as above, summed for
// the block in shared memory only where it is non-null, so that counting
// holds no register across the loop (sums in registers spilled 8 B more).
template <class Clock>
__global__ void __launch_bounds__(kBlockTile, 3)
megakernel_v4_wave(const float* __restrict__ camv_g, int seed, const float* __restrict__ bg_g,
                   const float* __restrict__ tables_g, const float* __restrict__ ntab_g,
                   Counts c, int n_slots, int block_layout, float wave_frac, int max_depth,
                   int checker_depth, int has_noise, float* __restrict__ out,
                   unsigned long long* __restrict__ tally,
                   unsigned long long* __restrict__ prof) {
  using K = Cfg<false, Sweep::kLane, kFAll, Clock>;
  Clock clk;
  const long long t_all = tick<Clock>();
  extern __shared__ float smem[];
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, ntab_g, c);
  const float* bg = cv + kCamvLen;
  const Tables T = make_tables(smem, c);
  tock(&clk, kPhStage, t_all);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const Pixel px = slot_pixel(lane, cv, block_layout);
  const float s0 = cv[21], n_samples = cv[22], sqrt_spp = cv[23];

  Path s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float s_lane = -1.0f, tm = 0.0f;
  uint32_t key = 0u;
  __shared__ unsigned block_segs, block_meds;
  if (tally && threadIdx.x == 0) block_segs = block_meds = 0u;
  if constexpr (Clock::kOn) clk.begin();
  // Every thread takes part in every count.
  const float n_img = (float)__syncthreads_count(px.in_grid);
  while (true) {
    const bool runnable = s.alive > 0.0f || (s_lane < n_samples - 1.0f && px.in_grid);
    long long t0 = tick<Clock>();
    const float live = (float)__syncthreads_count(s.alive > 0.0f);
    const bool any = __syncthreads_or(runnable);
    tock(&clk, kPhWait, t0);
    if (!any) break;
    if (s.alive <= 0.0f && s_lane < n_samples - 1.0f && px.in_grid &&
        live <= wave_frac * n_img) {
      t0 = tick<Clock>();
      if (tally) atomicAdd(&block_segs, (unsigned)s.bn);  // the lane's last path
      s_lane += 1.0f;
      const float sg = s0 + s_lane;
      key = sample_key(seed, px.pid, (int)sg);
      camera_ray(s, tm, cv, key, px.xx, px.yy, sg, sqrt_spp);
      tock(&clk, kPhCamera, t0);
    }
    if (s.alive > 0.0f) {
      const bool med = bounce<K>(s, T, c, bg, key, tm, max_depth, checker_depth,
                                 has_noise != 0, nullptr, &clk);
      if (tally && med) atomicAdd(&block_meds, 1u);
      if constexpr (Clock::kOn) clk.mark();
    }
  }
  if (tally) {  // every thread of the block, its last path not yet counted
    atomicAdd(&block_segs, (unsigned)s.bn);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(tally, (unsigned long long)block_segs);
      atomicAdd(tally + 1, (unsigned long long)block_meds);
    }
  }
  const long long t0 = tick<Clock>();
  if (lane < n_slots) {
    out[3 * lane + 0] = s.rr;
    out[3 * lane + 1] = s.rg;
    out[3 * lane + 2] = s.rb;
  }
  tock(&clk, kPhStore, t0);
  if constexpr (Clock::kOn) {
    clk.lanes_done();
    tock(&clk, kPhTotal, t_all);
    clk.flush(prof);
  }
}

// Resident blocks of the persistent kernel per SM at `smem` bytes of shared
// memory a block (the occupancy calculator), or 0 on an error.
template <uint32_t F, class Clock>
int persistent_blocks_per_sm(int smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(megakernel_v4<F, Clock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, megakernel_v4<F, Clock>, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launch instance <F, Clock> on `stream`; returns the cudaError_t of the
// launch. `next_slot` (one int of the caller's) is the persistent kernel's
// fetch counter, zeroed here on the stream; `tally` (or null) gets the
// launch's segments and medium scatters added.
template <uint32_t F, class Clock>
int launch_v4(int device, const float* camv, int seed, const float* bg, const float* tables,
              const Counts& c, const float* ntab, int n_slots, int block_layout,
              float wave_frac, int max_depth, int checker_depth, int has_noise,
              int* next_slot, float* out, unsigned long long* tally,
              unsigned long long* prof, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_slots <= 0) return (int)cudaSuccess;
  if (block_layout && n_slots % kBlockTile) return (int)cudaErrorInvalidValue;
  const int smem = block_smem_bytes(c);
  cudaStream_t s = (cudaStream_t)stream;
  if (wave_frac < 1.0f) {
    // Always: its static counts take from the 48 KB that need no opt-in.
    err = cudaFuncSetAttribute(megakernel_v4_wave<Clock>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = block_layout ? kBlockTile : kThreads;
    megakernel_v4_wave<Clock><<<(n_slots + threads - 1) / threads, threads, smem, s>>>(
        camv, seed, bg, tables, ntab, c, n_slots, block_layout, wave_frac, max_depth,
        checker_depth, has_noise, out, tally, prof);
    return (int)cudaGetLastError();
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int per_sm = persistent_blocks_per_sm<F, Clock>(smem);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks =
      min(min(per_sm, kPersistentBlocksPerSM) * sms, (n_slots + kThreads - 1) / kThreads);
  err = cudaMemsetAsync(next_slot, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  megakernel_v4<F, Clock><<<blocks, kThreads, smem, s>>>(
      camv, seed, bg, tables, ntab, c, n_slots, block_layout, max_depth, checker_depth,
      has_noise, next_slot, out, tally, prof);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
int megakernel_v4_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med, int n_box,
                             int hier_sph, int hier_box, int n_noise) {
  return block_smem_bytes(
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise});
}

// The feature mask this library was built for.
int megakernel_v4_features() { return (int)kV4Feat; }

// Resident threads per SM of the persistent kernel's grid at `smem` bytes
// of shared memory per block (the occupancy calculator, at most
// kPersistentBlocksPerSM blocks), or -1 on an error.
int megakernel_v4_threads_per_sm(int smem) {
  const int blocks = persistent_blocks_per_sm<kV4Feat, NoClock>(smem);
  return blocks > 0 ? min(blocks, kPersistentBlocksPerSM) * kThreads : -1;
}

// Launch on `stream`; returns the cudaError_t of the launch. `ntab` holds
// n_noise Perlin tables ([6, n_noise * 256]; null for hash noise);
// `block_layout` selects the block-tiled layout (n_slots a multiple of 256),
// `wave_frac` < 1 wave regeneration; `next_slot` is one int of scratch;
// `tally` (null for none) gets the launch's segments and medium scatters
// added, two uint64.
int megakernel_v4_launch(int device, const float* camv, int seed, const float* bg,
                         const float* tables, int n_sph, int n_quad, int n_mat, int n_tex,
                         int n_med, int n_box, int hier_sph, int hier_box, const float* ntab,
                         int n_noise, int n_slots, int block_layout, float wave_frac,
                         int max_depth, int checker_depth, int has_noise, int* next_slot,
                         float* out, unsigned long long* tally, void* stream) {
  return launch_v4<kV4Feat, NoClock>(
      device, camv, seed, bg, tables,
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise}, ntab,
      n_slots, block_layout, wave_frac, max_depth, checker_depth, has_noise, next_slot, out,
      tally, nullptr, stream);
}

const char* megakernel_v4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
