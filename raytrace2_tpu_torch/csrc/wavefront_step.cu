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
// f32 sequence in both kernels and the images are bitwise equal). The state
// traffic is 136 B per slot per launch, read and written: about 49 MB at
// 600x600, some 15 us at 3.35 TB/s, small beside the sweep.
//
// Design. The sort between launches gives neighbouring threads nearby
// origins and the same direction octant, but lanes of one warp may still
// take up to six visit orders of the cluster skip, and each order is its own
// stream of cluster boxes and records. So the step walks the clusters in one
// order per warp (Sweep::kWarp: the order most of its converged lanes
// take), each lane keeping its own running best and slab tests, and breaks
// exact ties by the record's rank in the lane's own order: the winner is
// the per-lane walk's, bit for bit (path_common.cuh hier_sweep). The scene
// tables, cluster tables, camv, ntab and the inverse visit orders (which
// only this kernel stages) are staged in dynamic shared memory once per
// block of 256 threads (book 2: about 63 KB). In turns on book 2, the
// per-lane walk at these blocks was 8 % (K=2) and 12 % (K=16) slower
// (PERF.md).
//
// Seed. The launch reads the batch's seed from a one-int device buffer and
// not from a by-value argument, so that a CUDA graph holding the launch
// (ops/kernels/wavefront.py, one replay a pass) takes each batch's seed
// from that buffer without being captured again.
//
// Counter. Given a non-null `segments`, a launch adds the rays it cast (one
// closest-hit query per step of a slot) to that int64: a warp's sum, one
// atomic a warp. The driver passes it only while a profiler records
// (wavefront.SEGMENTS); a null pointer skips the sum, and the state is the
// same either way.
//
// Build: as megakernel_v4.cu (ops/kernels/build.py, -fmad=false), bound
//        through ctypes.

#include "path_common.cuh"

namespace {

// Row of each state column in the [17, n_slots] state (wavefront.STATE_KEYS).
enum StateCol { S_LANE, PID, BN, AL, OX, OY, OZ, DX, DY, DZ, TM, TPR, TPG, TPB,
                RR, RG, RB, N_STATE_COLS };

// The production step: one visit order per warp (hier_sweep), 256 threads
// per block over one staged copy of the tables.
using StepCfg = Cfg<false, Sweep::kWarp>;
constexpr int kStepThreads = 256;

// Dynamic shared memory of one block: block_smem_bytes and the inverse
// visit orders.
__host__ __device__ inline int step_smem_bytes(const Counts& c) {
  return block_smem_bytes(c) + inverse_floats(c) * (int)sizeof(float);
}

// Up to k_bounces steps of slot `lane`; returns the steps taken, each one
// closest-hit query.
template <class K>
__device__ __forceinline__ int step_slot(const Tables& T, const Counts& c, const float* cv,
                                          const float* bg, int seed, float* state, int lane,
                                          int n_slots, int k_bounces, int max_depth,
                                          int checker_depth, int has_noise,
                                          typename K::Clock* clk) {
  using Clock = typename K::Clock;
  float* col = state + lane;
  const size_t n = (size_t)n_slots;

  long long t0 = tick<Clock>();
  float s_lane = col[S_LANE * n];
  const float pid = col[PID * n];
  Path s{col[BN * n],  col[AL * n],  col[OX * n],  col[OY * n],  col[OZ * n],
         col[DX * n],  col[DY * n],  col[DZ * n],  col[TPR * n], col[TPG * n],
         col[TPB * n], col[RR * n],  col[RG * n],  col[RB * n]};
  float tm = col[TM * n];
  if constexpr (Clock::kOn) {
    // Wait for every load before reading the clock.
    const float sink = s_lane + pid + s.bn + s.alive + s.ox + s.oy + s.oz + s.dx + s.dy + s.dz +
                       s.tpr + s.tpg + s.tpb + s.rr + s.rg + s.rb + tm;
    asm volatile("" ::"f"(sink));
  }
  tock(clk, kPhLoad, t0);

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
      t0 = tick<Clock>();
      s_lane += 1.0f;
      const float sg = s0 + s_lane;
      key = sample_key(seed, pid_u, (int)sg);
      camera_ray(s, tm, cv, key, xx, yy, sg, sqrt_spp);
      tock(clk, kPhCamera, t0);
    }
    bounce<K>(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0, nullptr, clk);
    ++steps;
  }
  if (steps == 0) return 0;
  t0 = tick<Clock>();
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
  tock(clk, kPhStore, t0);
  return steps;
}

// `segments` (optional) gets the launch's closest-hit queries added. `prof`
// takes the phase clock's sums in an instrumented instance (the profiling
// build's PhaseClock); production instances get null.
template <class K>
__global__ void __launch_bounds__(kStepThreads)
wavefront_step(const float* __restrict__ camv_g, const int* __restrict__ seed_g,
               const float* __restrict__ bg_g,
               const float* __restrict__ tables_g, const float* __restrict__ ntab_g, Counts c,
               float* __restrict__ state, int n_slots, int k_bounces, int max_depth,
               int checker_depth, int has_noise, unsigned long long* __restrict__ segments,
               unsigned long long* __restrict__ prof) {
  using Clock = typename K::Clock;
  Clock clk;
  const long long t_all = tick<Clock>();
  extern __shared__ float smem[];
  const float* cv = stage_tables(smem, camv_g, bg_g, tables_g, ntab_g, c, true);
  tock(&clk, kPhStage, t_all);
  const float* bg = cv + kCamvLen;

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int seed = *seed_g;
  int steps = 0;
  if (lane < n_slots) {
    Tables T = make_tables(smem, c);
    set_inverse_orders(T, smem + stage_floats(c));
    steps = step_slot<K>(T, c, cv, bg, seed, state, lane, n_slots, k_bounces, max_depth,
                         checker_depth, has_noise, &clk);
  }
  if (segments) {
    // Every thread of the block gets here: a warp's sum, one atomic a warp.
    const unsigned warp_steps = __reduce_add_sync(0xffffffffu, (unsigned)steps);
    if ((threadIdx.x & 31) == 0 && warp_steps) {
      atomicAdd(segments, (unsigned long long)warp_steps);
    }
  }
  if constexpr (Clock::kOn) {
    tock(&clk, kPhTotal, t_all);
    clk.flush(prof);
  }
}

// Launch instance K on `stream`; returns the cudaError_t of the launch.
template <class K>
int launch_step(int device, const float* camv, const int* seed, const float* bg,
                const float* tables,
                const Counts& c, const float* ntab, float* state, int n_slots, int k_bounces,
                int max_depth, int checker_depth, int has_noise, unsigned long long* segments,
                unsigned long long* prof, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_slots <= 0 || k_bounces <= 0) return (int)cudaSuccess;
  int smem = step_smem_bytes(c);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(wavefront_step<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (n_slots + kStepThreads - 1) / kStepThreads;
  wavefront_step<K><<<blocks, kStepThreads, smem, (cudaStream_t)stream>>>(
      camv, seed, bg, tables, ntab, c, state, n_slots, k_bounces, max_depth, checker_depth,
      has_noise, segments, prof);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
int wavefront_step_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med,
                              int n_box, int hier_sph, int hier_box, int n_noise) {
  return step_smem_bytes(
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise});
}

int wavefront_step_state_cols() { return N_STATE_COLS; }

// Resident threads per SM of the production step at `smem` bytes of shared
// memory per block (the occupancy calculator), or -1 on an error.
int wavefront_step_threads_per_sm(int smem) {
  int blocks = 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(wavefront_step<StepCfg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wavefront_step<StepCfg>,
                                                    kStepThreads, smem) != cudaSuccess)
    return -1;
  return blocks * kStepThreads;
}

// Advance `state` [17, n_slots] in place on `stream`; returns the cudaError_t
// of the launch. `seed` points at the seed, one int on the device; `ntab`
// holds n_noise Perlin tables (null for hash noise); `segments` (null for
// none) gets the launch's closest-hit queries added.
int wavefront_step_launch(int device, const float* camv, const int* seed, const float* bg,
                          const float* tables, int n_sph, int n_quad, int n_mat, int n_tex,
                          int n_med, int n_box, int hier_sph, int hier_box, const float* ntab,
                          int n_noise, float* state, int n_slots, int k_bounces, int max_depth,
                          int checker_depth, int has_noise, unsigned long long* segments,
                          void* stream) {
  return launch_step<StepCfg>(
      device, camv, seed, bg, tables,
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise}, ntab,
      state, n_slots, k_bounces, max_depth, checker_depth, has_noise, segments, nullptr,
      stream);
}

const char* wavefront_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
