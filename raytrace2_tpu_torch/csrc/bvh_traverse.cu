// The sphere BVH walk for Hopper (sm_90a): the closest sphere hit of each ray
// through the flattened BVH (scene/bvh.py), one thread a ray.
//
// Replaces raytrace2_tpu/ops/bvh_traverse.py:38 (traverse_one, an XLA
// while_loop under vmap, not a pallas_call), with the leaf of
// raytrace2_tpu/ops/intersect.py::_sphere_best_bvh (:397-411). The JAX
// package runs that walk as a device loop with no host in it; written as
// eager PyTorch it would cost some 25 launches a visited node, so on the card
// it is this kernel. ops/bvh_traverse.py holds its plain PyTorch version
// (traverse, the batched walk) and the wrapper (closest_sphere).
//
// The walk: pop a node, test its box against (t_min, best_t); at a hit leaf
// test its sphere, kept only when strictly closer (the first leaf visited
// wins a tie); at a hit internal node push the right child, then the left,
// so the left pops first. best_t starts at t_max; a miss returns t_max and
// prim -1.
//
// What bounds it on this card: f32 operations, 25 for each visited node's
// slab test (6 subtractions, 6 products, 3 min, 3 max, the two reductions
// and the interval, one compare) and 35 for each tested leaf (the moving
// centre, oc, h, oc.oc - r^2, the discriminant, the root and its interval,
// the compare with best_t), against 36 B read per ray, 8 B written, and the
// tree and spheres read once (36 B a node, 28 B a sphere). The visit counts
// depend on the data; chip_smoke.py counts them with the plain walk. The
// threads of a warp walk different paths, so the issue slots idle where
// lanes diverge; a simple kernel that is right comes first.
//
// NaN: 1/d is +-inf where a direction component is 0, and (mn - o) * inf is
// NaN where the ray lies in the slab's plane. jnp.minimum/maximum and the
// plain version's torch.minimum/maximum propagate that NaN and the box is a
// miss; fminf/fmaxf would drop it, so the test checks for NaN itself.
//
// Arithmetic in the plain version's order: a = (dx*dx + dy*dy) + dz*dz
// (once a ray), h and oc.oc likewise, sqrt(has ? disc : 0), (h -+ sq) / a,
// strict intervals; built with -fmad=false, IEEE division and square root,
// so the kernel and the plain version on the card are bitwise equal.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (ops/kernels/build.py); bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
// The stack: max_depth + 2 entries must fit (the wrapper checks against
// ops/bvh_traverse.py MAX_STACK, the same 64; a deeper walk traps).
constexpr int kMaxStack = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ bool box_hit(const float* __restrict__ lo,
                                        const float* __restrict__ hi, int node, float ox,
                                        float oy, float oz, float ix, float iy, float iz,
                                        float t0, float t1) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  bool nan = false;
  float lo_max = 0.0f, hi_min = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ta = (__ldg(lo + 3 * node + k) - o[k]) * inv[k];
    const float tb = (__ldg(hi + 3 * node + k) - o[k]) * inv[k];
    nan |= (ta != ta) | (tb != tb);
    const float a = ta < tb ? ta : tb;
    const float b = ta < tb ? tb : ta;
    lo_max = k == 0 ? a : (a > lo_max ? a : lo_max);
    hi_min = k == 0 ? b : (b < hi_min ? b : hi_min);
  }
  t0 = lo_max > t0 ? lo_max : t0;
  t1 = hi_min < t1 ? hi_min : t1;
  return !nan && t1 > t0;
}

__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ time, const float* __restrict__ t_min,
                    const float* __restrict__ t_max, const float* __restrict__ box_lo,
                    const float* __restrict__ box_hi, const int* __restrict__ left,
                    const int* __restrict__ right, const int* __restrict__ prim,
                    const float* __restrict__ c0, const float* __restrict__ disp,
                    const float* __restrict__ rad, int n, float* __restrict__ out_t,
                    int* __restrict__ out_p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float tm = time[i], lo = t_min[i];
  const float a = dx * dx + dy * dy + dz * dz;
  float best_t = t_max[i];
  int best_p = -1;
  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    if (!box_hit(box_lo, box_hi, node, ox, oy, oz, ix, iy, iz, lo, best_t)) continue;
    const int p = __ldg(prim + node);
    if (p < 0) {
      if (sp + 2 > kMaxStack) __trap();
      stack[sp++] = __ldg(right + node);
      stack[sp++] = __ldg(left + node);
      continue;
    }
    const float cx = __ldg(c0 + 3 * p) + tm * __ldg(disp + 3 * p);
    const float cy = __ldg(c0 + 3 * p + 1) + tm * __ldg(disp + 3 * p + 1);
    const float cz = __ldg(c0 + 3 * p + 2) + tm * __ldg(disp + 3 * p + 2);
    const float ocx = cx - ox, ocy = cy - oy, ocz = cz - oz;
    const float r = __ldg(rad + p);
    const float h = dx * ocx + dy * ocy + dz * ocz;
    const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r;
    const float disc = h * h - a * cc;
    const bool has = disc >= 0.0f;
    const float sq = sqrtf(has ? disc : 0.0f);
    const float r0 = (h - sq) / a;
    const float r1 = (h + sq) / a;
    const bool ok0 = (r0 > lo) & (r0 < best_t);
    const bool ok1 = (r1 > lo) & (r1 < best_t);
    const float t_leaf = has && (ok0 || ok1) ? (ok0 ? r0 : r1) : kBig;
    if (t_leaf < best_t) {
      best_t = t_leaf;
      best_p = p;
    }
  }
  out_t[i] = best_t;
  out_p[i] = best_p;
}

}  // namespace

extern "C" {

// Launch on `stream` over n rays; returns the cudaError_t of the launch.
int bvh_traverse_launch(int device, const float* o, const float* d, const float* time,
                        const float* t_min, const float* t_max, const float* box_lo,
                        const float* box_hi, const int* left, const int* right,
                        const int* prim, const float* c0, const float* disp, const float* rad,
                        int n, float* out_t, int* out_p, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh_traverse_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, d, time, t_min, t_max, box_lo, box_hi, left, right, prim, c0, disp, rad, n, out_t,
      out_p);
  return (int)cudaGetLastError();
}

const char* bvh_traverse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
