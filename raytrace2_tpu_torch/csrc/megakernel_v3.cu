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
// Design for Hopper (tools/roofline.py --mode split measured the earlier
// kernel: 56 % of a Cornell pass's lane-cycles idle while warp-mates still
// bounced, 13 % in the block count): compaction inside the block, on scenes
// whose families all sweep flat (compacts). When the block's live rays fit
// in fewer warps than hold them, each thread with a dead ray stores it (a
// dead ray changes no more in this pass) and the live rays move, with their
// stream keys and source columns, through shared memory to threads
// 0..live-1 (their order kept); the warps left without a ray only take part
// in the counts. So fewer warps issue each bounce, at fuller lanes. Each
// ray's arithmetic, the stop and every stored value are the
// one-ray-per-thread kernel's, bit for bit.
//   * One instance per scene feature mask (-DV3_FEATURES=<mask>, hash
//     noise for a noise scene), as v4's, where the pass compacts; a scene
//     with a clustered family takes the all-features library
//     (megakernel_v3.instance_features: its mask instance ran 4-7 % slower)
//     and runs the one-ray-per-thread pass.
//   * A per-warp stop in place of the block count measured slower in
//     turns, on Cornell and on book 2, and was removed (PERF.md).
//
// Build: as megakernel_v4.cu (ops/kernels/build.py, -fmad=false,
//        -DV3_FEATURES=<mask>), bound through ctypes.

#include "path_common.cuh"

#ifndef V3_FEATURES
#define V3_FEATURES 511
#endif

namespace {

constexpr uint32_t kV3Feat = V3_FEATURES;

// Row of each column of the [12, n] state (megakernel_v3.STATE_KEYS).
enum V3Col { V_OX, V_OY, V_OZ, V_DX, V_DY, V_DZ, V_TM, V_BN, V_AL, V_TPR, V_TPG, V_TPB,
             N_V3_COLS };

// Words of a ray that the compaction moves through shared memory: the
// Path (14), tm, the stream key and the column the ray came from.
constexpr int kRayWords = 17;

// The compaction's exchange area [kRayWords][kThreads] and per-warp counts.
constexpr int kExchangeBytes = (kRayWords * kThreads + kThreads / 32) * (int)sizeof(float);
// A block's shared memory on Hopper (with the opt-in).
constexpr int kMaxSmem = 232448;

// Whether a pass compacts: where no family goes through the cluster walk
// (packing rays of several warps into one diverges the per-lane walk, each
// lane's own visit order and clusters: book 2's pass ran 8 % slower
// compacted, Cornell's 28 % faster; PERF.md), and the exchange area fits
// beside the tables, so that no scene the pass took before is refused.
__host__ __device__ inline bool compacts(const Counts& c) {
  return !c.hier_sph && !c.hier_box && block_smem_bytes(c) + kExchangeBytes <= kMaxSmem;
}

// Dynamic shared memory of one block: the staged tables and, where the pass
// compacts, the exchange area.
__host__ __device__ inline int v3_smem_bytes(const Counts& c) {
  return block_smem_bytes(c) + (compacts(c) ? kExchangeBytes : 0);
}

// Write a ray's state to its column `ci` of the [12, n] state (pitch n) and
// this pass's radiance to row `ci` of `radiance`.
__device__ __forceinline__ void store_ray(float* state, float* radiance, size_t pitch, int ci,
                                          const Path& s) {
  float* col = state + ci;
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
  radiance[3 * ci + 0] = s.rr;
  radiance[3 * ci + 1] = s.rg;
  radiance[3 * ci + 2] = s.rb;
}

// At least 6 resident blocks: 80 registers a thread without a spill (96
// uncapped, with the cluster walk). Clock: the profiling build's phase
// clock (megakernel_profile.cu), whose sums go to `prof`; NoClock here.
template <uint32_t F, class Clock>
__global__ void __launch_bounds__(kThreads, 6)
megakernel_v3(const float* __restrict__ bg_g, const float* __restrict__ tables_g, Counts c,
              float* __restrict__ state, const int* __restrict__ rid, int n, int seed_lane,
              int min_alive, int max_depth, int checker_depth, int has_noise,
              float* __restrict__ radiance, unsigned long long* __restrict__ prof) {
  using K = Cfg<false, Sweep::kLane, F, Clock>;
  Clock clk;
  const long long t_all = tick<Clock>();
  extern __shared__ float smem[];
  const float* bg = stage_tables(smem, nullptr, bg_g, tables_g, nullptr, c) + kCamvLen;
  const Tables T = make_tables(smem, c);
  float* xch = smem + stage_floats(c);
  int* warp_live = (int*)(xch + kRayWords * kThreads);
  tock(&clk, kPhStage, t_all);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pitch = (size_t)n;
  // The column of the ray this thread holds, or -1 when it holds none.
  int src = lane < n ? lane : -1;
  Path s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float tm = 0.0f;
  uint32_t key = 0u;
  long long t0 = tick<Clock>();
  if (src >= 0) {
    const float* col = state + src;
    s = Path{col[V_BN * pitch], col[V_AL * pitch], col[V_OX * pitch], col[V_OY * pitch],
             col[V_OZ * pitch], col[V_DX * pitch], col[V_DY * pitch], col[V_DZ * pitch],
             col[V_TPR * pitch], col[V_TPG * pitch], col[V_TPB * pitch], 0.f, 0.f, 0.f};
    tm = col[V_TM * pitch];
    key = mix((uint32_t)rid[src] * 0x9E3779B9u ^ mix((uint32_t)seed_lane));
  }
  if constexpr (Clock::kOn) {
    // Wait for every load before reading the clock.
    const float sink = s.bn + s.alive + s.ox + s.oy + s.oz + s.dx + s.dy + s.dz + s.tpr +
                       s.tpg + s.tpb + tm;
    asm volatile("" ::"f"(sink));
    clk.begin();
  }
  tock(&clk, kPhLoad, t0);
  const bool compact = compacts(c);
  int warps_held = kThreads / 32;  // warps whose threads may hold a live ray
  while (true) {
    t0 = tick<Clock>();
    const int count = __syncthreads_count(s.alive > 0.0f);
    tock(&clk, kPhWait, t0);
    if (count <= min_alive) break;
    if (compact && (count + 31) / 32 < warps_held) {
      // Compaction (count is the block's, so every thread takes this
      // branch): dead rays are stored now (they change no more), live ones
      // move to threads 0..count-1 in their order.
      t0 = tick<Clock>();
      if (src >= 0 && s.alive <= 0.0f) {
        store_ray(state, radiance, pitch, src, s);
        src = -1;
      }
      const bool keep = s.alive > 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      const int warp = threadIdx.x >> 5, lane_bit = threadIdx.x & 31;
      if (lane_bit == 0) warp_live[warp] = __popc(ballot);
      __syncthreads();
      int rank = __popc(ballot & ((1u << lane_bit) - 1u));
      for (int w = 0; w < warp; ++w) rank += warp_live[w];
      if (keep) {
        const float v[kRayWords] = {s.bn,  s.alive, s.ox, s.oy,  s.oz,  s.dx,
                                    s.dy,  s.dz,    s.tpr, s.tpg, s.tpb, s.rr,
                                    s.rg,  s.rb,    tm,    __uint_as_float(key),
                                    __int_as_float(src)};
#pragma unroll
        for (int k = 0; k < kRayWords; ++k) xch[k * kThreads + rank] = v[k];
      }
      __syncthreads();
      const int t = threadIdx.x;
      if (t < count) {
        s = Path{xch[t],                xch[kThreads + t],      xch[2 * kThreads + t],
                 xch[3 * kThreads + t], xch[4 * kThreads + t],  xch[5 * kThreads + t],
                 xch[6 * kThreads + t], xch[7 * kThreads + t],  xch[8 * kThreads + t],
                 xch[9 * kThreads + t], xch[10 * kThreads + t], xch[11 * kThreads + t],
                 xch[12 * kThreads + t], xch[13 * kThreads + t]};
        tm = xch[14 * kThreads + t];
        key = __float_as_uint(xch[15 * kThreads + t]);
        src = __float_as_int(xch[16 * kThreads + t]);
      } else {
        src = -1;
        s.alive = 0.0f;
      }
      // The next writes to xch come after the loop's next count, a barrier.
      warps_held = (count + 31) / 32;
      tock(&clk, kPhLoad, t0);
    }
    if (s.alive > 0.0f) {
      bounce<K>(s, T, c, bg, key, tm, max_depth, checker_depth, has_noise != 0, nullptr, &clk);
      if constexpr (Clock::kOn) clk.mark();
    }
  }
  t0 = tick<Clock>();
  if (src >= 0) store_ray(state, radiance, pitch, src, s);
  tock(&clk, kPhStore, t0);
  if constexpr (Clock::kOn) {
    clk.lanes_done();
    tock(&clk, kPhTotal, t_all);
    clk.flush(prof);
  }
}

// Launch instance <F, Clock> on `stream`; returns the cudaError_t of the
// launch.
template <uint32_t F, class Clock>
int launch_v3(int device, const float* bg, const float* tables, const Counts& c, float* state,
              const int* rid, int n, int seed_lane, int min_alive, int max_depth,
              int checker_depth, int has_noise, float* radiance, unsigned long long* prof,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  const int smem = v3_smem_bytes(c);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(megakernel_v3<F, Clock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  megakernel_v3<F, Clock><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      bg, tables, c, state, rid, n, seed_lane, min_alive, max_depth, checker_depth, has_noise,
      radiance, prof);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
int megakernel_v3_smem_bytes(int n_sph, int n_quad, int n_mat, int n_tex, int n_med,
                             int n_box, int hier_sph, int hier_box) {
  return v3_smem_bytes(Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, 0});
}

int megakernel_v3_state_cols() { return N_V3_COLS; }

int megakernel_v3_tile() { return kThreads; }

// The feature mask this library was built for.
int megakernel_v3_features() { return (int)kV3Feat; }

// Resident threads per SM at `smem` bytes of shared memory per block (the
// occupancy calculator), or -1 on an error.
int megakernel_v3_threads_per_sm(int smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(megakernel_v3<kV3Feat, NoClock>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, megakernel_v3<kV3Feat, NoClock>,
                                                    kThreads, smem) != cudaSuccess)
    return -1;
  return blocks * kThreads;
}

// One pass over `state` [12, n] (updated in place) and `rid` [n], writing
// this pass's radiance [n, 3], on `stream`; returns the cudaError_t of the
// launch.
int megakernel_v3_launch(int device, const float* bg, const float* tables, int n_sph,
                         int n_quad, int n_mat, int n_tex, int n_med, int n_box, int hier_sph,
                         int hier_box, float* state,
                         const int* rid, int n, int seed_lane, int min_alive, int max_depth,
                         int checker_depth, int has_noise, float* radiance, void* stream) {
  return launch_v3<kV3Feat, NoClock>(device, bg, tables,
                          Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, 0},
                          state, rid, n, seed_lane, min_alive, max_depth, checker_depth,
                          has_noise, radiance, nullptr, stream);
}

const char* megakernel_v3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
