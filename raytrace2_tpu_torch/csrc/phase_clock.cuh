// The per-thread phase clock of the profiling builds (wavefront_profile.cu,
// megakernel_profile.cu), never of a production instance: a kernel
// instantiated with Cfg<..., PhaseClock> sums clock64() cycles per phase of
// path_common.cuh's Phase enum, and adds per-warp counters:
//   * at each closest hit over a clustered family, whether the warp's
//     converged lanes take more than one visit order, and how many;
//   * the idle-lane cycles of a per-thread loop: per lane, the warp's last
//     useful cycle minus the lane's own (lanes that finished their work wait
//     for the warp's slowest lane), and the warp's span per lane;
//   * the cycles spent waiting in a block-wide lockstep count (kPhWait).
// The clock reads cost time, so its phases are shares and a profiled
// kernel's time is not the production time; it computes the production
// instance's results bit for bit.

#pragma once

#include "path_common.cuh"

namespace {

// Slots of the profile counters after the kNPhases cycle sums.
enum ProfSlot { kWarpSteps = kNPhases, kMixedSteps, kDistinctOrders, kWarpLanes, kIdleCycles,
                kSpanCycles, kNProf };

struct PhaseClock {
  static constexpr bool kOn = true;
  long long cyc[kNPhases] = {};
  unsigned long long steps = 0, mixed = 0, distinct = 0, lanes = 0, idle = 0, span = 0;
  long long start = 0, last = 0;

  // One warp-step of the closest hit: the converged lanes' visit orders.
  __device__ void dirs(int dir) {
    const unsigned act = __activemask();
    const unsigned same = __match_any_sync(act, dir);
    const int lane = threadIdx.x & 31;
    const unsigned leaders = __ballot_sync(act, lane == __ffs(same) - 1);
    if (lane == __ffs(act) - 1) {
      steps += 1;
      mixed += same != act;
      distinct += __popc(leaders);
      lanes += __popc(act);
    }
  }

  // The start of the thread's work, and the end of each useful step.
  __device__ void begin() { start = last = clock64(); }
  __device__ void mark() { last = clock64(); }

  // Every lane of the warp calls it, converged, once its work is done: each
  // lane adds the warp's last useful cycle minus its own to `idle`, and the
  // warp's span (from lane 0's start) to `span`.
  __device__ void lanes_done() {
    const long long w0 = __shfl_sync(0xffffffffu, start, 0);
    const unsigned own = (unsigned)(last > w0 ? last - w0 : 0);
    const unsigned warp_last = __reduce_max_sync(0xffffffffu, own);
    idle += warp_last - own;
    span += warp_last;
  }

  // Warp sums, one atomic per warp and counter. Every thread of the block
  // calls it.
  __device__ void flush(unsigned long long* out) {
    __syncwarp();
    unsigned long long v[kNProf];
    for (int i = 0; i < kNPhases; ++i) v[i] = (unsigned long long)cyc[i];
    v[kWarpSteps] = steps;
    v[kMixedSteps] = mixed;
    v[kDistinctOrders] = distinct;
    v[kWarpLanes] = lanes;
    v[kIdleCycles] = idle;
    v[kSpanCycles] = span;
    for (int i = 0; i < kNProf; ++i) {
      unsigned long long x = v[i];
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if ((threadIdx.x & 31) == 0 && x) atomicAdd(&out[i], x);
    }
  }
};

}  // namespace
