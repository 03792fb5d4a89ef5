// Profiling instances of the v4 render (megakernel_v4.cu) and the v3 pass
// (megakernel_v3.cu), built only by raytrace2_tpu_torch/tools/roofline.py
// (--mode split, and the split phase of chip_smoke.py), never by the
// renderer: each production instance with phase_clock.cuh's PhaseClock —
// clock64() sums of block staging, state load (v3), camera rays, slab
// tests, record tests, shading, noise, the store and the time in the
// block-wide lockstep counts (v3; v4 with wave regeneration), and per lane the cycles it idles while its warp-mates
// still run. Each computes its
// production instance's results bit for bit. Built per feature mask, as the
// production libraries are (-DV4_FEATURES, -DV3_FEATURES).

#include "megakernel_v4.cu"
#include "megakernel_v3.cu"
#include "phase_clock.cuh"

extern "C" {

int megakernel_profile_counters() { return kNProf; }

// megakernel_v4_launch's arguments; `prof` takes the kNProf counters
// (added to, zeroed by the caller).
int megakernel_v4_profile_launch(int device, const float* camv, int seed, const float* bg,
                                 const float* tables, int n_sph, int n_quad, int n_mat,
                                 int n_tex, int n_med, int n_box, int hier_sph, int hier_box,
                                 const float* ntab, int n_noise, int n_slots, int block_layout,
                                 float wave_frac, int max_depth, int checker_depth,
                                 int has_noise, int* next_slot, float* out,
                                 unsigned long long* prof, void* stream) {
  return launch_v4<kV4Feat, PhaseClock>(
      device, camv, seed, bg, tables,
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise}, ntab,
      n_slots, block_layout, wave_frac, max_depth, checker_depth, has_noise, next_slot, out,
      nullptr, prof, stream);
}

// megakernel_v3_launch's arguments; `prof` as above.
int megakernel_v3_profile_launch(int device, const float* bg, const float* tables, int n_sph,
                                 int n_quad, int n_mat, int n_tex, int n_med, int n_box,
                                 int hier_sph, int hier_box, float* state, const int* rid,
                                 int n, int seed_lane, int min_alive, int max_depth,
                                 int checker_depth, int has_noise, float* radiance,
                                 unsigned long long* prof, void* stream) {
  return launch_v3<kV3Feat, PhaseClock>(
      device, bg, tables, Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, 0},
      state, rid, n, seed_lane, min_alive, max_depth, checker_depth, has_noise, radiance, prof,
      stream);
}

}  // extern "C"
