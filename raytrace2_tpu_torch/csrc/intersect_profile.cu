// Profiling instance of the fused closest hit B5 (intersect_kernel.cu),
// built only by raytrace2_tpu_torch/tools/roofline.py (--mode split, and the
// split phase of chip_smoke.py), never by the renderer: the production
// kernel with phase_clock.cuh's PhaseClock, whose clock64() sums land in
// its slots as
//   staging with its barriers -> kPhStage, the ray load -> kPhLoad,
//   sphere tests -> kPhSlab, quad tests -> kPhRecord,
//   the lane group's reduction -> kPhWait, the store -> kPhStore,
// with per lane the cycles it idles while its warp-mates still test
// records (a lane of a group whose share of the records is shorter, or a
// group past N). It computes the production instance's results bit for bit.

#include "intersect_kernel.cu"
#include "phase_clock.cuh"

namespace {

struct B5Clock : PhaseClock {
  // B5's phase -> its PhaseClock slot.
  __device__ void add(int phase, long long cycles) {
    constexpr int kSlot[b5::kB5Total + 1] = {kPhStage, kPhLoad, kPhSlab, kPhRecord,
                                         kPhWait,  kPhStore, kPhTotal};
    cyc[kSlot[phase]] += cycles;
  }
};

}  // namespace

extern "C" {

int intersect_profile_counters() { return kNProf; }

// intersect_kernel_launch's arguments; `prof` takes the kNProf counters
// (added to, zeroed by the caller).
int intersect_profile_launch(int device, const float* o, const float* d, const float* time,
                             const float* t_min, const float* t_max, const float* sph, int ps,
                             int ns, const float* qd, int pq, int nq, int n, int group,
                             int threads, int cap_s, int cap_q, int smem, float* out_t,
                             int* out_code, unsigned long long* prof, void* stream) {
  return b5::launch_b5<B5Clock>(device, o, d, time, t_min, t_max, sph, ps, ns, qd, pq, nq, n,
                                group, threads, cap_s, cap_q, smem, out_t, out_code, prof,
                                stream);
}

}  // extern "C"
