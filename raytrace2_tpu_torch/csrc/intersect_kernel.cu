// Fused sphere + quad closest hit for Hopper (sm_90a).
//
// Replaces the TPU kernel raytrace2_tpu/ops/pallas/intersect_kernel.py ::
// _kernel (launched by closest_hit_pallas), which serves the non-kernel
// path's --backend pallas: once per bounce it finds, for every ray, the
// nearest sphere or quad hit inside (t_min, t_max) and returns best_t [N]
// (3e38 on a miss) and code [N] = family << 24 | index (family 0 spheres,
// 1 quads; -1 on a miss).
//
// Design: one thread per ray, the ray's nine floats in registers. The block
// walks the packed record rows (ops/kernels/intersect_kernel.py::pack_scene:
// sphere rows [8, Ps], then quad rows [13, Pq]) one tile of kTileP records
// at a time: the block's threads copy the tile into shared memory together,
// synchronise, and each thread sweeps the tile in index order, so a warp
// reads one record at a time as a shared-memory broadcast. A hit replaces the
// best only when strictly closer: that is the Pallas kernel's tile-wise
// argmin followed by its strict `<` across tiles, so the first index wins a
// tie. There is no multiple-of-1,024 rule: threads past N take part in the
// staging and write nothing.
//
// The arithmetic is the Pallas kernel's, operation by operation (inv_a =
// 1/a and (h -+ sq) * inv_a; sq = sqrt(has ? disc : 0); the quad's
// t = (d - n.o) / (not_par ? n.d : 1); closed intervals for quads, strict for
// spheres; act > 0), and -fmad=false keeps every product rounded on its own,
// as the plain PyTorch version rounds it on the card: the two are bitwise
// equal.
//
// What bounds it on this card: f32 operations, N x (S x 35 + Q x 48)
// (the sphere and quad tests below, selects not counted), against 36 B read
// and 8 B written per ray; the record rows are read once per block from L2.
// A thread sweeps every record of its ray, so a launch of N rays runs N / 32
// warps: the 16,384-ray chunks of book 2 give about one warp per scheduler,
// too few to hide latency (splitting a ray's sweep over threads is the next
// step).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (ops/kernels/build.py); bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kQuadEps = 1e-8f;
// 128 rays a block: a 16,384-ray chunk (the book-2 launch) then spreads over
// 128 blocks, about one per SM, where 256 would leave half the SMs idle.
constexpr int kThreads = 128;
constexpr int kTileP = 128;
constexpr int kSphRows = 8, kQuadRows = 13;
constexpr int kCodeQuad = 1 << 24;

// Sphere rows: c0x c0y c0z dpx dpy dpz r2 act. Quad rows: nx ny nz d aax aay
// aaz abx aby abz qaa qab act (intersect_kernel.py SPH_KEYS / QUAD_KEYS).

// Copy records [base, base + cnt) of `rows` x `pitch` into tile[rows][kTileP].
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ src, int rows,
                                      int pitch, int base, int cnt) {
  __syncthreads();  // the previous tile is no longer read
  for (int k = threadIdx.x; k < rows * kTileP; k += blockDim.x) {
    int r = k / kTileP, j = k - r * kTileP;
    tile[k] = j < cnt ? src[(size_t)r * pitch + base + j] : 0.0f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ time, const float* __restrict__ t_min,
                 const float* __restrict__ t_max, const float* __restrict__ sph, int ps,
                 const float* __restrict__ qd, int pq, int n, float* __restrict__ out_t,
                 int* __restrict__ out_code) {
  __shared__ float tile[kQuadRows * kTileP];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f, tm = 0.f, t0 = 1.f,
        t1 = 0.f;
  if (live) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    tm = time[i];
    t0 = t_min[i];
    t1 = t_max[i];
  }
  float best_t = kBig;
  int code = -1;

  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  for (int base = 0; base < ps; base += kTileP) {
    const int cnt = min(kTileP, ps - base);
    stage(tile, sph, kSphRows, ps, base, cnt);
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* s = tile + j;
      float cx = s[0 * kTileP] + tm * s[3 * kTileP];
      float cy = s[1 * kTileP] + tm * s[4 * kTileP];
      float cz = s[2 * kTileP] + tm * s[5 * kTileP];
      float ocx = cx - ox, ocy = cy - oy, ocz = cz - oz;
      float h = dx * ocx + dy * ocy + dz * ocz;
      float cc = ocx * ocx + ocy * ocy + ocz * ocz - s[6 * kTileP];
      float disc = h * h - a * cc;
      bool has = disc >= 0.0f;
      float sq = sqrtf(has ? disc : 0.0f);
      float r0 = (h - sq) * inv_a;
      float r1 = (h + sq) * inv_a;
      bool ok0 = (r0 > t0) && (r0 < t1);
      bool ok1 = (r1 > t0) && (r1 < t1);
      float root = ok0 ? r0 : r1;
      if (has && (ok0 || ok1) && s[7 * kTileP] > 0.0f && root < best_t) {
        best_t = root;
        code = base + j;
      }
    }
  }
  for (int base = 0; base < pq; base += kTileP) {
    const int cnt = min(kTileP, pq - base);
    stage(tile, qd, kQuadRows, pq, base, cnt);
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* q = tile + j;
      float nx = q[0 * kTileP], ny = q[1 * kTileP], nz = q[2 * kTileP];
      float nd = dx * nx + dy * ny + dz * nz;
      float no = ox * nx + oy * ny + oz * nz;
      bool not_par = fabsf(nd) >= kQuadEps;
      float t = (q[3 * kTileP] - no) / (not_par ? nd : 1.0f);
      float aax = q[4 * kTileP], aay = q[5 * kTileP], aaz = q[6 * kTileP];
      float abx = q[7 * kTileP], aby = q[8 * kTileP], abz = q[9 * kTileP];
      float o_aa = ox * aax + oy * aay + oz * aaz;
      float d_aa = dx * aax + dy * aay + dz * aaz;
      float o_ab = ox * abx + oy * aby + oz * abz;
      float d_ab = dx * abx + dy * aby + dz * abz;
      float alpha = o_aa + t * d_aa - q[10 * kTileP];
      float beta = o_ab + t * d_ab - q[11 * kTileP];
      if (not_par && t >= t0 && t <= t1 && alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f &&
          beta <= 1.0f && q[12 * kTileP] > 0.0f && t < best_t) {
        best_t = t;
        code = kCodeQuad + base + j;
      }
    }
  }
  if (live) {
    out_t[i] = best_t;
    out_code[i] = code;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch.
int intersect_kernel_launch(int device, const float* o, const float* d, const float* time,
                            const float* t_min, const float* t_max, const float* sph, int ps,
                            const float* qd, int pq, int n, float* out_t, int* out_code,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  int blocks = (n + kThreads - 1) / kThreads;
  intersect_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, d, time, t_min, t_max, sph, ps, qd, pq, n, out_t, out_code);
  return (int)cudaGetLastError();
}

const char* intersect_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
