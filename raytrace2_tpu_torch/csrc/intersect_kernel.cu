// Fused sphere + quad closest hit for Hopper (sm_90a).
//
// Replaces the TPU kernel raytrace2_tpu/ops/pallas/intersect_kernel.py ::
// _kernel (launched by closest_hit_pallas), which serves the non-kernel
// path's --backend pallas: once per bounce it finds, for every ray, the
// nearest sphere or quad hit inside (t_min, t_max) and returns best_t [N]
// (3e38 on a miss) and code [N] = family << 24 | index (family 0 spheres,
// 1 quads; -1 on a miss).
//
// What bounds it on this card: f32 operations, per ray 48 for each live
// quad and, for each live sphere, 24 up to the compare of its discriminant
// and 11 more where it has a real root (the tests below, selects not
// counted; the plain version's record_test_ops counts them on a launch's
// data), against 36 B read and 8 B written per ray. Tensor cores (wgmma)
// have no place here: each test is a short chain of scalar f32 operations
// on one ray and one record, with compares and selects, and no product of
// two matrices. The code is built with -fmad=false, so a multiply and an
// add issue apart and the ceiling is the card's rate for such code; the
// record loads, compares and selects share the issue slots with the f32
// operations. A launch of few rays (the route's compacted ones) is bound by
// one lane's chain of ceil(records / 32) dependent tests instead.
//
// Design:
//   * Live extents. The kernel sweeps spheres [0, ns) and quads [0, nq),
//     one past each family's last active record, which the caller reads from
//     the host scene; the rows stay padded to 128 (pack_scene), and records
//     past the extents, inactive, would never hit (act > 0). A family with
//     extent 0 is not swept.
//   * One ray's sweep split over a group of G lanes of a warp (G = 1, 2, 4,
//     8, 16 or 32; ops/kernels/intersect_kernel.py::launch_config picks the
//     smallest G that gives the grid 16 warps an SM, as long as a lane still
//     tests 2 records, and smaller blocks for a grid of fewer blocks than
//     SMs, as the route's compacted launches are). Lane r of the group tests
//     records r, r + G, r + 2G, ... in ascending order, spheres before
//     quads, and keeps a hit only if strictly closer. The group then
//     reduces with __shfl_xor_sync to the lexicographic minimum of (t,
//     code): codes follow the sweep order and no accepted t is NaN, so this
//     is the sequential sweep's result, the first record among equal t (the
//     Pallas kernel's tile-wise argmin with a strict `<` across tiles).
//   * Records staged as float4 planes in dynamic shared memory: a sphere is
//     two float4 (c0x c0y c0z dpx | dpy dpz r2 act), a quad three (nx ny nz d
//     | aax aay aaz abx | aby abz qaa qab) and its act apart, read only when
//     the other conditions hold. Lane r of every group reads record j at the
//     same step, so a warp's load is G consecutive float4, each a broadcast
//     to the 32 / G rays, free of bank conflicts. The whole live table is
//     staged once per block where it fits (book 2: 157 KB, one 1,024-thread
//     block an SM), else the families pass through in tiles (48 KB, several
//     blocks an SM, whose staging overlaps the others' sweeps).
//   * A sphere without a real root (disc < 0, never accepted) is left
//     before the square root, so a warp whose lanes all miss skips the rest
//     of the test; the sweeps are unrolled twice.
//
// The arithmetic is the Pallas kernel's, operation by operation (inv_a =
// 1/a and (h -+ sq) * inv_a; sq = sqrt(has ? disc : 0); the quad's
// t = (d - n.o) / (not_par ? n.d : 1); closed intervals for quads, strict for
// spheres; act > 0), and -fmad=false keeps every product rounded on its own,
// as the plain PyTorch version rounds it on the card: the two are bitwise
// equal at every G.
//
// Clock: the profiling build's phase clock (intersect_profile.cu), whose
// sums go to `prof`; B5NoClock here, compiled to nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (ops/kernels/build.py); bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

// Named, so that a build that also includes path_common.cuh (the profiling
// one) keeps both sets of constants.
namespace b5 {

constexpr float kBig = 3.0e38f;
constexpr float kQuadEps = 1e-8f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxGroup = 32;
constexpr int kCodeQuad = 1 << 24;
// Dynamic shared memory a block may take without the opt-in attribute.
constexpr int kDefaultSmem = 48 * 1024;

// B5's phases of a per-thread clock: staging (with its barriers), the ray
// load, sphere tests, quad tests, the lane group's reduction, the store.
enum B5Phase { kB5Stage, kB5Load, kB5Sphere, kB5Quad, kB5Reduce, kB5Store, kB5Total };

// The clock of a production instance: compiled to nothing.
struct B5NoClock {
  static constexpr bool kOn = false;
};

template <class Clock>
__device__ __forceinline__ long long b5_tick() {
  if constexpr (Clock::kOn) return clock64();
  return 0;
}

template <class Clock>
__device__ __forceinline__ void b5_tock(Clock& k, int phase, long long t0) {
  if constexpr (Clock::kOn) k.add(phase, clock64() - t0);
}

// The end of the planes (below) for tiles of cap_s spheres and cap_q quads:
// the least dynamic shared memory a launch may pass (the host sizes it,
// ops/kernels/intersect_kernel.py::smem_bytes).
__host__ __device__ constexpr int planes_end(int cap_s, int cap_q) {
  return cap_s * 2 * 16 + cap_q * (3 * 16 + 4);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, t0, t1, a, inv_a;
};

// The shared-memory planes: spheres S0, S1 [cap_s], quads Q0, Q1, Q2, QA
// [cap_q] (ops/kernels/intersect_kernel.py SPH_KEYS, QUAD_KEYS).
struct Planes {
  float4 *s0, *s1, *q0, *q1, *q2;
  float* qa;
};

__device__ __forceinline__ Planes planes(float4* smem, int cap_s, int cap_q) {
  float4* q = smem + 2 * cap_s;
  return Planes{smem, smem + cap_s, q, q + cap_q, q + 2 * cap_q, (float*)(q + 3 * cap_q)};
}

// Stage spheres [sb, sb + sc) and quads [qb, qb + qc) of the row tables,
// each thread one record at a time (the rows' reads coalesce across threads).
__device__ __forceinline__ void stage(const Planes& p, const float* __restrict__ sph, int ps,
                                      int sb, int sc, const float* __restrict__ qd, int pq,
                                      int qb, int qc) {
  for (int j = threadIdx.x; j < sc; j += blockDim.x) {
    const float* r = sph + sb + j;
    p.s0[j] = make_float4(r[0], r[ps], r[2 * ps], r[3 * ps]);
    p.s1[j] = make_float4(r[4 * ps], r[5 * ps], r[6 * ps], r[7 * ps]);
  }
  for (int j = threadIdx.x; j < qc; j += blockDim.x) {
    const float* r = qd + qb + j;
    p.q0[j] = make_float4(r[0], r[pq], r[2 * pq], r[3 * pq]);
    p.q1[j] = make_float4(r[4 * pq], r[5 * pq], r[6 * pq], r[7 * pq]);
    p.q2[j] = make_float4(r[8 * pq], r[9 * pq], r[10 * pq], r[11 * pq]);
    p.qa[j] = r[12 * pq];
  }
}

// Sphere records r, r + g, ... of the staged [0, cnt), codes base + j.
__device__ __forceinline__ void sweep_spheres(const Ray& y, const Planes& p, int r, int g,
                                              int cnt, int base, float& best_t, int& code) {
#pragma unroll 2
  for (int j = r; j < cnt; j += g) {
    const float4 u = p.s0[j], v = p.s1[j];
    float cx = u.x + y.tm * u.w;
    float cy = u.y + y.tm * v.x;
    float cz = u.z + y.tm * v.y;
    float ocx = cx - y.ox, ocy = cy - y.oy, ocz = cz - y.oz;
    float h = y.dx * ocx + y.dy * ocy + y.dz * ocz;
    float cc = ocx * ocx + ocy * ocy + ocz * ocz - v.z;
    float disc = h * h - y.a * cc;
    // has = disc >= 0; a record without it is never accepted, so the lane
    // goes on (and sqrt(has ? disc : 0) is sqrt(disc) below).
    if (!(disc >= 0.0f)) continue;
    float sq = sqrtf(disc);
    float r0 = (h - sq) * y.inv_a;
    float r1 = (h + sq) * y.inv_a;
    bool ok0 = (r0 > y.t0) && (r0 < y.t1);
    bool ok1 = (r1 > y.t0) && (r1 < y.t1);
    float root = ok0 ? r0 : r1;
    if ((ok0 || ok1) && v.w > 0.0f && root < best_t) {
      best_t = root;
      code = base + j;
    }
  }
}

// Quad records r, r + g, ... of the staged [0, cnt), codes kCodeQuad + base + j.
__device__ __forceinline__ void sweep_quads(const Ray& y, const Planes& p, int r, int g,
                                            int cnt, int base, float& best_t, int& code) {
#pragma unroll 2
  for (int j = r; j < cnt; j += g) {
    const float4 u = p.q0[j], v = p.q1[j], w = p.q2[j];
    float nd = y.dx * u.x + y.dy * u.y + y.dz * u.z;
    float no = y.ox * u.x + y.oy * u.y + y.oz * u.z;
    bool not_par = fabsf(nd) >= kQuadEps;
    float t = (u.w - no) / (not_par ? nd : 1.0f);
    float o_aa = y.ox * v.x + y.oy * v.y + y.oz * v.z;
    float d_aa = y.dx * v.x + y.dy * v.y + y.dz * v.z;
    float o_ab = y.ox * v.w + y.oy * w.x + y.oz * w.y;
    float d_ab = y.dx * v.w + y.dy * w.x + y.dz * w.y;
    float alpha = o_aa + t * d_aa - w.z;
    float beta = o_ab + t * d_ab - w.w;
    if (not_par && t >= y.t0 && t <= y.t1 && alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f &&
        beta <= 1.0f && t < best_t && p.qa[j] > 0.0f) {
      best_t = t;
      code = kCodeQuad + base + j;
    }
  }
}

// One ray per group of `group` lanes; tiles of cap_s spheres and cap_q quads
// (the whole live table where cap_s >= ns and cap_q >= nq).
template <class Clock>
__global__ void __launch_bounds__(kMaxThreads)
intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ time, const float* __restrict__ t_min,
                 const float* __restrict__ t_max, const float* __restrict__ sph, int ps, int ns,
                 const float* __restrict__ qd, int pq, int nq, int n, int group, int cap_s,
                 int cap_q, float* __restrict__ out_t, int* __restrict__ out_code,
                 unsigned long long* __restrict__ prof) {
  extern __shared__ float4 smem[];
  Clock clk;
  const long long t_all = b5_tick<Clock>();
  const Planes p = planes(smem, cap_s, cap_q);
  const int g = group;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / g;
  const int r = threadIdx.x & (g - 1);
  const bool live = i < n;
  Ray y{0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f, 1.f, 0.f, 0.f, 0.f};
  if (live) {
    y.ox = o[3 * i];
    y.oy = o[3 * i + 1];
    y.oz = o[3 * i + 2];
    y.dx = d[3 * i];
    y.dy = d[3 * i + 1];
    y.dz = d[3 * i + 2];
    y.tm = time[i];
    y.t0 = t_min[i];
    y.t1 = t_max[i];
  }
  y.a = y.dx * y.dx + y.dy * y.dy + y.dz * y.dz;
  y.inv_a = 1.0f / y.a;
  if constexpr (Clock::kOn) {
    // Wait for every load before reading the clock.
    asm volatile("" ::"f"(y.ox + y.oy + y.oz + y.inv_a + y.tm + y.t0 + y.t1));
    clk.begin();
  }
  b5_tock(clk, kB5Load, t_all);
  float best_t = kBig;
  int code = -1;

  // Passes over the tiles: sphere tiles first; the quads join the pass that
  // stages the last spheres. Each lane's records stay in ascending order.
  int sb = 0, qb = 0;
  for (bool first = true; sb < ns || qb < nq; first = false) {
    const int sc = min(cap_s, ns - sb);
    const int qc = sb + sc >= ns ? min(cap_q, nq - qb) : 0;
    long long c0 = b5_tick<Clock>();
    if (!first) __syncthreads();  // the previous tiles are no longer read
    stage(p, sph, ps, sb, sc, qd, pq, qb, qc);
    __syncthreads();
    b5_tock(clk, kB5Stage, c0);
    if (live) {
      c0 = b5_tick<Clock>();
      sweep_spheres(y, p, r, g, sc, sb, best_t, code);
      b5_tock(clk, kB5Sphere, c0);
      c0 = b5_tick<Clock>();
      sweep_quads(y, p, r, g, qc, qb, best_t, code);
      b5_tock(clk, kB5Quad, c0);
      if constexpr (Clock::kOn) clk.mark();
    }
    sb += sc;
    qb += qc;
  }

  long long c0 = b5_tick<Clock>();
  // The group's lexicographic minimum of (t, code); every lane of the warp
  // takes part (a group is all live or all past N).
  for (int off = g >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    const int oc = __shfl_xor_sync(0xffffffffu, code, off);
    if (ot < best_t || (ot == best_t && oc < code)) {
      best_t = ot;
      code = oc;
    }
  }
  b5_tock(clk, kB5Reduce, c0);
  c0 = b5_tick<Clock>();
  if (live && r == 0) {
    out_t[i] = best_t;
    out_code[i] = code;
  }
  b5_tock(clk, kB5Store, c0);
  if constexpr (Clock::kOn) {
    clk.lanes_done();
    b5_tock(clk, kB5Total, t_all);
    clk.flush(prof);
  }
}

// Launch instance <Clock> on `stream` with `smem` bytes of dynamic shared
// memory; returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// group, a block, tiles or a shared-memory size the kernel does not take).
template <class Clock>
int launch_b5(int device, const float* o, const float* d, const float* time,
              const float* t_min, const float* t_max, const float* sph, int ps, int ns,
              const float* qd, int pq, int nq, int n, int group, int threads, int cap_s,
              int cap_q, int smem, float* out_t, int* out_code, unsigned long long* prof,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (group < 1 || group > kMaxGroup || (group & (group - 1)) || threads < 32 ||
      threads > kMaxThreads || threads % 32 || ns < 0 || ns > ps || nq < 0 || nq > pq ||
      cap_s < 0 || cap_q < 0 || (ns > 0 && cap_s < 1) || (nq > 0 && cap_q < 1) ||
      smem < planes_end(cap_s, cap_q))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(intersect_kernel<Clock>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rays_per_block = threads / group;
  const int blocks = (n + rays_per_block - 1) / rays_per_block;
  intersect_kernel<Clock><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      o, d, time, t_min, t_max, sph, ps, ns, qd, pq, nq, n, group, cap_s, cap_q, out_t,
      out_code, prof);
  return (int)cudaGetLastError();
}

}  // namespace b5

extern "C" {

// Launch on `stream` with `group` lanes a ray, `threads` a block, tiles of
// cap_s spheres and cap_q quads and `smem` bytes of shared memory; returns
// the cudaError_t of the launch.
int intersect_kernel_launch(int device, const float* o, const float* d, const float* time,
                            const float* t_min, const float* t_max, const float* sph, int ps,
                            int ns, const float* qd, int pq, int nq, int n, int group,
                            int threads, int cap_s, int cap_q, int smem, float* out_t,
                            int* out_code, void* stream) {
  return b5::launch_b5<b5::B5NoClock>(device, o, d, time, t_min, t_max, sph, ps, ns, qd, pq, nq,
                                      n, group, threads, cap_s, cap_q, smem, out_t, out_code,
                                      nullptr, stream);
}

const char* intersect_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
