// Profiling instances of the sorted-wavefront step (wavefront_step.cu),
// built only by raytrace2_tpu_torch/tools/profile_wavefront.py (and the
// split phase of chip_smoke.py), never by the renderer. Port of the
// variants of tools/profile_wavefront.py (JAX): the same step with
//   0 "nosweep"  — the sphere and AA-box sweeps compiled out;
//   1 "linear"   — the clusters compiled out (both families swept flat);
//   2 "profiled" — the production sweep with a per-thread phase clock:
//     clock64() sums of block staging, state load, camera rays, slab tests,
//     record tests, shading (noise included), noise and state store, and,
//     at each closest hit over a clustered family, whether the warp's
//     converged lanes take more than one visit order and how many.
// The clock is phase_clock.cuh's PhaseClock: the profiled instance computes
// the production instance's state bit for bit.

#include "wavefront_step.cu"
#include "phase_clock.cuh"

extern "C" {

int wavefront_profile_counters() { return kNProf; }

// Launch profiling variant `variant` (0 nosweep, 1 linear, 2 profiled; the
// others refused) with the production launch's arguments; `prof` takes
// the profiled variant's kNProf counters (added to, zeroed by the caller).
int wavefront_profile_launch(int variant, int device, const float* camv, const int* seed,
                             const float* bg, const float* tables, int n_sph, int n_quad,
                             int n_mat, int n_tex, int n_med, int n_box, int hier_sph,
                             int hier_box, const float* ntab, int n_noise, float* state,
                             int n_slots, int k_bounces, int max_depth, int checker_depth,
                             int has_noise, unsigned long long* prof, void* stream) {
  const Counts c{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise};
  switch (variant) {
    case 0:
      return launch_step<Cfg<false, Sweep::kNone>>(device, camv, seed, bg, tables, c, ntab,
                                                   state, n_slots, k_bounces, max_depth,
                                                   checker_depth, has_noise, nullptr, nullptr,
                                                   stream);
    case 1:
      return launch_step<Cfg<false, Sweep::kFlat>>(device, camv, seed, bg, tables, c, ntab,
                                                   state, n_slots, k_bounces, max_depth,
                                                   checker_depth, has_noise, nullptr, nullptr,
                                                   stream);
    case 2:
      return launch_step<Cfg<false, StepCfg::kSweep, kFAll, PhaseClock>>(
          device, camv, seed, bg, tables, c, ntab, state, n_slots, k_bounces, max_depth,
          checker_depth, has_noise, nullptr, prof, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
