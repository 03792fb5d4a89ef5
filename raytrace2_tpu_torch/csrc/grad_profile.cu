// Profiling instances of the gradient kernel (megakernel_grad.cu), built
// only by raytrace2_tpu_torch/tools/profile_grad.py (and the split phase of
// chip_smoke.py), never by the renderer: the pre-pass alone (camera rays,
// winner search and forward carries, with its results kept observable), as
// JAX's _grad_kernel(phase="prepass") for tools/profile_grad.py — the
// production launch minus this one is the reverse pass; and the whole
// kernel without its table-cotangent atomics (their values kept alive),
// which shows what they cost. Built per feature mask, as the production
// library is.

#include "megakernel_grad.cu"

extern "C" {

// The production launch's arguments; d_camv takes the kept results.
int megakernel_grad_prepass_launch(int device, const float* camv, int seed, const float* bg,
                                   const float* tables, int n_sph, int n_quad, int n_mat,
                                   int n_tex, int n_med, int n_box, int hier_sph, int hier_box,
                                   const float* ntab, int n_noise, int n_pix, int max_depth,
                                   int checker_depth, int has_noise, const float* g,
                                   float* d_camv, float* d_bg, float* d_tables, int shared_cot,
                                   unsigned long long* bounces, void* stream) {
  return launch_grad<kGradFeat, true>(
      device, camv, seed, bg, tables,
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise}, ntab,
      n_pix, max_depth, checker_depth, has_noise, g, d_camv, d_bg, d_tables, shared_cot,
      bounces, stream);
}

// The production launch's arguments; the table-cotangent atomics compiled
// out.
int megakernel_grad_no_atomics_launch(int device, const float* camv, int seed, const float* bg,
                                      const float* tables, int n_sph, int n_quad, int n_mat,
                                      int n_tex, int n_med, int n_box, int hier_sph,
                                      int hier_box, const float* ntab, int n_noise, int n_pix,
                                      int max_depth, int checker_depth, int has_noise,
                                      const float* g, float* d_camv, float* d_bg,
                                      float* d_tables, int shared_cot,
                                      unsigned long long* bounces, void* stream) {
  return launch_grad<kGradFeat | kFProfNoCot, false>(
      device, camv, seed, bg, tables,
      Counts{n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise}, ntab,
      n_pix, max_depth, checker_depth, has_noise, g, d_camv, d_bg, d_tables, shared_cot,
      bounces, stream);
}

}  // extern "C"
