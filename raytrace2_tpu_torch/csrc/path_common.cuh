// Device code shared by the port's path-tracing kernels (megakernel_v4.cu,
// wavefront_step.cu, megakernel_v3.cu, and the gradient kernel
// megakernel_grad.cu): the packed-table views, the murmur RNG, hash-gradient
// and table Perlin noise, the closest-hit sweep (flat, or the two-level
// cluster skip), one bounce of a live path, and the camera ray of a
// regenerated sample. Every kernel includes it, so a path computes the same
// f32 sequence in each of them.
//
// The cluster skip (JAX _hier_sweep, megakernel.py:438-497) finds each
// lane's winner as if the lane walked its own front-to-back visit order
// (from its own direction), skipping a supercluster or cluster whose AABB
// its interval misses. The JAX kernel decides per tile (the summed
// direction, any lane); a per-lane order keeps the winner on exact-t ties
// independent of which other lanes are live, which the divergent replay of
// the gradient kernel needs and the plain version reproduces. v4, B3 and B4
// walk that order (Sweep::kLane); the wavefront step walks one order per
// warp (Sweep::kWarp, hier_sweep) and breaks exact ties by the record's
// rank in the lane's own order, which gives the same winner.
//
// With RT2_SWEEP_BVH defined (the bvh instances, build.SWEEP_DEFINE; JAX
// RT2_SWEEP_MODE=bvh) the clustered families walk JAX's threaded BVH over
// their clusters instead (Sweep::kBvh, bvh_sweep): per lane, from its own
// direction's threading, for the same reason. Its tables follow each
// family's cluster tables; the default instances compile none of it.
//
// What a kernel compiles is chosen by a Cfg (below): the sweep, a mask of
// the scene features whose code it holds (the gradient kernel is built per
// scene from it; the forward kernels hold everything), winner tracking,
// and an optional per-thread phase clock that only the profiling builds
// instantiate (csrc/*_profile.cu).
//
// Semantics kept exactly as the JAX kernel has them: family order spheres ->
// quads -> AA boxes -> media; comparisons sphere `root < best_t`, quad
// `t <= best_t`, box `t < best_t`, medium `hit_dist <= e1 - e0`; draw counters
// bounce*(3+n_med) + {0,1,2} for scatter and +3+m for medium m; camera draws
// at 0x40000000 + k; uniforms from the top 24 bits; int32 lattice coordinates
// wrap to uint32; the checker nesting depth is a runtime loop count; noise is
// evaluated at the hit point only on lanes that hit a noise texture. Selects,
// not arithmetic masks: a miss carries best_t = 3e38, so o + t*d overflows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kTMin = 1e-3f;
constexpr float kQuadEps = 1e-8f;
constexpr float kNearZero = 1e-8f;
constexpr float kMediumEps = 1e-4f;
constexpr float kTwoPi = 6.28318530717958f;
constexpr int kThreads = 128;
constexpr int kCamvLen = 28;
constexpr int kCluster = 16;   // records per cluster (megakernel.py CLUSTER)
constexpr int kSuper = 128;    // records per supercluster (SUPER)
constexpr int kNoiseN = 256;   // entries per Perlin table (NOISE_TABLE_N)

// Scene features whose code a kernel instance holds (megakernel_grad.py
// feature_mask computes a scene's mask in Python): the record families, the
// checker, hash or table noise, metal and dielectric materials (Lambertian,
// textured, light and isotropic are always held).
constexpr uint32_t kFSph = 1u, kFQuad = 2u, kFBox = 4u, kFMed = 8u, kFChecker = 16u,
                   kFHashNoise = 32u, kFTableNoise = 64u, kFMetal = 128u, kFDiel = 256u,
                   kFAll = 511u;

// How the closest hit walks the clustered families: each lane in its own
// order, one order per warp, or (profiling builds only) the sphere and box
// families compiled out or swept flat in record order. kBvh, each lane's
// threaded-BVH walk, is what kLane and kWarp become in a bvh instance.
enum class Sweep { kLane, kWarp, kNone, kFlat, kBvh };

// Phases of a per-thread clock (the profiling builds' PhaseClock,
// phase_clock.cuh); kPhWait is time in a block-wide lockstep count.
enum Phase { kPhStage, kPhLoad, kPhCamera, kPhSlab, kPhRecord, kPhShade, kPhNoise, kPhStore,
             kPhWait, kPhTotal, kNPhases };

// The clock of a production instance: compiled to nothing.
struct NoClock {
  static constexpr bool kOn = false;
};

template <bool Track = false, Sweep S = Sweep::kLane, uint32_t F = kFAll, class Clk = NoClock>
struct Cfg {
  static constexpr bool kTrack = Track;
  static constexpr Sweep kSweep = S;
  static constexpr uint32_t kFeat = F;
  using Clock = Clk;
};

template <class Clock>
__device__ __forceinline__ long long tick() {
  if constexpr (Clock::kOn) return clock64();
  return 0;
}

template <class Clock>
__device__ __forceinline__ void tock(Clock* k, int phase, long long t0) {
  if constexpr (Clock::kOn) k->cyc[phase] += clock64() - t0;
}

// Column ids of the packed tables (ops/kernels/megakernel.py *_KEYS).
enum SphCol { C0X, C0Y, C0Z, DPX, DPY, DPZ, RAD, SMAT, SACT, N_SPH_COLS };
enum QuadCol { NX, NY, NZ, QD, AAX, AAY, AAZ, ABX, ABY, ABZ, QAA, QAB, QMAT, N_QUAD_COLS };
enum BoxCol { BX0, BY0, BZ0, BX1, BY1, BZ1, BMAT, BACT, N_BOX_COLS };
enum MedCol { BTYPE, P0X, P0Y, P0Z, P1X, P1Y, P1Z, DSPX, DSPY, DSPZ,
              I00, I01, I02, I03, I10, I11, I12, I13, I20, I21, I22, I23,
              NID, MMAT, N_MED_COLS };
enum MatCol { MTYPE, MALR, MALG, MALB, MPARAM, MTEX, N_MAT_COLS };
enum TexCol { TTYPE, TALR, TALG, TALB, TINV, TEVEN, TODD, TSCALE, TNTYPE, TNSLOT,
              N_TEX_COLS };

constexpr float kMatLambertian = 0.f, kMatMetal = 1.f, kMatDielectric = 2.f,
                kMatTexture = 3.f, kMatLight = 4.f, kMatIsotropic = 5.f;
constexpr float kTexChecker = 1.f, kTexNoise = 2.f, kNoiseMarble = 1.f;
constexpr float kMediumBox = 1.f;

// The six family sizes; whether spheres and AA boxes sweep through their
// clusters (megakernel.hier_flags); noise textures in the ntab operand (0:
// hash noise). megakernel.counts in Python builds it.
struct Counts {
  int n_sph, n_quad, n_mat, n_tex, n_med, n_box, hier_sph, hier_box, n_noise;
};

// Cluster tables of one family (megakernel.CLUSTER_FAMILIES): AABBs
// [6, n_cl] and [6, n_l2] (x0, y0, z0, x1, y1, z1), the supercluster visit
// orders [6 * n_l2] and the cluster orders inside them [6 * n_cl], as f32
// ids; n_cl = 0 for a family swept flat. A bvh instance's tables go on
// after `lord` (bvh_sweep reads them from there): the m = 2 n_cl - 1 node
// AABBs [6, m], leaf cluster ids [m], hit and miss links [6 * m] each, 19 m
// floats in all (megakernel.threaded_bvh). Only the wavefront step stages
// their inverses (iord: a supercluster's place in each order; ilord: a
// cluster's place inside its supercluster), packed after all the tables
// (set_inverse_orders); elsewhere they are null.
struct Clusters {
  const float* cb; const float* sb; const float* ord; const float* lord;
  const float* iord; const float* ilord;
  int n_cl, n_l2;
};

__host__ __device__ inline int n_super(int n, int on) {
  return on ? (n + kSuper - 1) / kSuper : 0;
}

// Column-major views into the shared-memory copy of the packed buffer:
// column k of a family starts at base + k * rows, rows = max(n, 1) for the
// record families and n for materials/textures, then the cluster tables
// (table_layout in Python). `nt` is the staged ntab, [6, nld] (perm rows
// 0-2, gradient rows 3-5), or null for hash noise.
struct Tables {
  const float* sph; int ls;
  const float* quad; int lq;
  const float* box; int lb;
  const float* med; int lm;
  const float* mat; int lmat;
  const float* tex; int ltex;
  Clusters scl, bcl;
  const float* nt; int nld;
  __device__ float s(int k, int i) const { return sph[k * ls + i]; }
  __device__ float q(int k, int i) const { return quad[k * lq + i]; }
  __device__ float b(int k, int i) const { return box[k * lb + i]; }
  __device__ float m(int k, int i) const { return med[k * lm + i]; }
  __device__ float mt(int k, int i) const { return mat[k * lmat + i]; }
  __device__ float tx(int k, int i) const { return tex[k * ltex + i]; }
};

__host__ __device__ inline int at_least_one(int n) { return n > 0 ? n : 1; }

// Nodes of a clustered family's threaded BVH (0 for a family swept flat).
__host__ __device__ inline int bvh_nodes(int n_cl) { return n_cl ? 2 * n_cl - 1 : 0; }

// Floats of a family's cluster tables: the two-level tables and, in a bvh
// instance, the threaded BVH's 19 floats a node. (The bvh parts stand in
// preprocessor branches, so that the default instances compile from the
// same code as before them: a changed inlining order alone had moved the
// wavefront step's registers.)
__host__ __device__ inline int cluster_floats(int n, int on) {
  const int n_l2 = n_super(n, on);
#ifdef RT2_SWEEP_BVH
  const int n_cl = n_l2 * (kSuper / kCluster);
  return 12 * (n_cl + n_l2) + 19 * bvh_nodes(n_cl);
#else
  return 12 * (n_l2 * (kSuper / kCluster) + n_l2);
#endif
}

// Floats of both families' inverse visit orders, packed after the tables
// (half of the two-level cluster tables).
__host__ __device__ inline int inverse_floats(const Counts& c) {
#ifdef RT2_SWEEP_BVH
  const int n_l2 = n_super(c.n_sph, c.hier_sph) + n_super(c.n_box, c.hier_box);
  return 6 * (n_l2 * (kSuper / kCluster) + n_l2);
#else
  return (cluster_floats(c.n_sph, c.hier_sph) + cluster_floats(c.n_box, c.hier_box)) / 2;
#endif
}

__host__ __device__ inline int table_floats(const Counts& c) {
  return N_SPH_COLS * at_least_one(c.n_sph) + N_QUAD_COLS * at_least_one(c.n_quad) +
         N_BOX_COLS * at_least_one(c.n_box) + N_MED_COLS * at_least_one(c.n_med) +
         N_MAT_COLS * c.n_mat + N_TEX_COLS * c.n_tex + cluster_floats(c.n_sph, c.hier_sph) +
         cluster_floats(c.n_box, c.hier_box);
}

__host__ __device__ inline int ntab_floats(const Counts& c) { return 6 * kNoiseN * c.n_noise; }

// Floats staged in one block's shared memory: the tables, camv, the
// background (padded to 4) and the ntab operand.
__host__ __device__ inline int stage_floats(const Counts& c) {
  return table_floats(c) + kCamvLen + 4 + ntab_floats(c);
}

__device__ inline Clusters make_clusters(const float*& p, int n, int on) {
  Clusters k;
  k.n_l2 = n_super(n, on);
  k.n_cl = k.n_l2 * (kSuper / kCluster);
  k.cb = p;
  k.sb = k.cb + 6 * k.n_cl;
  k.ord = k.sb + 6 * k.n_l2;
  k.lord = k.ord + 6 * k.n_l2;
  k.iord = k.ilord = nullptr;
  p = k.lord + 6 * k.n_cl;
#ifdef RT2_SWEEP_BVH
  p += 19 * bvh_nodes(k.n_cl);  // the threaded BVH's tables (bvh_sweep)
#endif
  return k;
}

// Views of the tables at `base`; where the base is a staging area
// (stage_tables), `nt` points at its ntab.
__device__ inline Tables make_tables(const float* base, const Counts& c) {
  Tables t;
  t.ls = at_least_one(c.n_sph);
  t.lq = at_least_one(c.n_quad);
  t.lb = at_least_one(c.n_box);
  t.lm = at_least_one(c.n_med);
  t.lmat = c.n_mat;
  t.ltex = c.n_tex;
  t.sph = base;
  t.quad = t.sph + N_SPH_COLS * t.ls;
  t.box = t.quad + N_QUAD_COLS * t.lq;
  t.med = t.box + N_BOX_COLS * t.lb;
  t.mat = t.med + N_MED_COLS * t.lm;
  t.tex = t.mat + N_MAT_COLS * t.lmat;
  const float* p = t.tex + N_TEX_COLS * t.ltex;
  t.scl = make_clusters(p, c.n_sph, c.hier_sph);
  t.bcl = make_clusters(p, c.n_box, c.hier_box);
  t.nld = kNoiseN * c.n_noise;
  t.nt = c.n_noise ? base + table_floats(c) + kCamvLen + 4 : nullptr;
  return t;
}

// Point the clustered families' iord/ilord at `inv`, the inverse visit
// orders as packed (spheres' iord and ilord, then the boxes').
__device__ inline void set_inverse_orders(Tables& t, const float* inv) {
  t.scl.iord = inv;
  t.scl.ilord = inv + 6 * t.scl.n_l2;
  t.bcl.iord = t.scl.ilord + 6 * t.scl.n_cl;
  t.bcl.ilord = t.bcl.iord + 6 * t.bcl.n_l2;
}

// ---- RNG (murmur3 fmix32 counter hash; ops/rng.py) -----------------------

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return (float)(int32_t)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float draw(uint32_t key, uint32_t ctr) {
  return uniform_from_bits(mix(key ^ mix(ctr * 0x9E3779B9u + 1u)));
}

__device__ __forceinline__ uint32_t sample_key(int seed, uint32_t slot, int sample) {
  uint32_t mega = (uint32_t)seed * 1000003u + (uint32_t)sample;
  return mix((slot * 0x9E3779B9u) ^ mix(mega));
}

__device__ __forceinline__ float safe_inv(float c) {
  return 1.0f / (fabsf(c) < 1e-12f ? (c < 0.0f ? -1e-12f : 1e-12f) : c);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// ---- hash-gradient noise (megakernel.py:1356-1419) ------------------------

__device__ void hash_gradient(uint32_t ix, uint32_t iy, uint32_t iz, uint32_t seed_u,
                              float& gx, float& gy, float& gz) {
  uint32_t h = ix * 0x8DA6B343u;
  h ^= iy * 0xD8163841u;
  h ^= iz * 0xCB1AB31Fu;
  uint32_t h1 = mix(h ^ seed_u);
  uint32_t h2 = mix(h1 ^ 0x68E31DA4u);
  float z = 1.0f - 2.0f * uniform_from_bits(h1);
  float phi = kTwoPi * uniform_from_bits(h2);
  float r = sqrtf(fmaxf(1.0f - z * z, 1e-12f));
  gx = r * cosf(phi);
  gy = r * sinf(phi);
  gz = z;
}

// The lattice's gradient at an integer corner: the hash above, or the
// reference's 256-entry tables (JAX _table_perlin, megakernel.py:583-621;
// PerlinNoiseGen.cpp:66-88) gathered from the staged ntab at this texture's
// block `base` (nslot * 256), coordinates masked & 255 as uint32.
struct HashLattice {
  uint32_t seed;
  __device__ __forceinline__ void at(uint32_t ix, uint32_t iy, uint32_t iz, float& gx,
                                     float& gy, float& gz) const {
    hash_gradient(ix, iy, iz, seed, gx, gy, gz);
  }
};

struct TableLattice {
  const float* nt;
  int ld, base;
  __device__ __forceinline__ void at(uint32_t ix, uint32_t iy, uint32_t iz, float& gx,
                                     float& gy, float& gz) const {
    const int px = (int)nt[base + (int)(ix & 255u)];
    const int py = (int)nt[ld + base + (int)(iy & 255u)];
    const int pz = (int)nt[2 * ld + base + (int)(iz & 255u)];
    const int gi = base + (px ^ py ^ pz);
    gx = nt[3 * ld + gi];
    gy = nt[4 * ld + gi];
    gz = nt[5 * ld + gi];
  }
};

template <class Lattice>
__device__ float perlin_noise(float px, float py, float pz, const Lattice& lat) {
  float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  uint32_t ix = (uint32_t)(int32_t)fx, iy = (uint32_t)(int32_t)fy, iz = (uint32_t)(int32_t)fz;
  float u = px - fx, v = py - fy, w = pz - fz;
  float uu = u * u * (3.0f - 2.0f * u);
  float vv = v * v * (3.0f - 2.0f * v);
  float ww = w * w * (3.0f - 2.0f * w);
  float accum = 0.0f;
  for (int di = 0; di < 2; ++di) {
    float wi = di ? uu : (1.0f - uu);
    for (int dj = 0; dj < 2; ++dj) {
      float wj = dj ? vv : (1.0f - vv);
      for (int dk = 0; dk < 2; ++dk) {
        float wk = dk ? ww : (1.0f - ww);
        float gx, gy, gz;
        lat.at(ix + di, iy + dj, iz + dk, gx, gy, gz);
        float dot = gx * (u - (float)di) + gy * (v - (float)dj) + gz * (w - (float)dk);
        accum = accum + wi * wj * wk * dot;
      }
    }
  }
  return accum;
}

template <class Lattice>
__device__ float turbulence(float px, float py, float pz, const Lattice& lat) {
  float accum = 0.0f, weight = 1.0f;
  for (int i = 0; i < 7; ++i) {
    accum = accum + weight * perlin_noise(px, py, pz, lat);
    weight *= 0.5f;
    px *= 2.0f;
    py *= 2.0f;
    pz *= 2.0f;
  }
  return fabsf(accum);
}

// Marble or Perlin factor of a noise texture at p (Texture.cpp:13-22).
template <class Lattice>
__device__ float noise_factor(float px, float py, float pz, float t_scale, float t_ntype,
                              const Lattice& lat) {
  if (t_ntype == kNoiseMarble) {
    return 0.5f * (1.0f + sinf(t_scale * pz + 10.0f * turbulence(px, py, pz, lat)));
  }
  return 0.5f * (1.0f + perlin_noise(t_scale * px, t_scale * py, t_scale * pz, lat));
}

// ---- closest hit (make_family_bodies + _closest_hit, :635-882) -------------

struct Rec {
  float t, fam, mat, p0, p1, p2, aux;
};

// The sweep's winner, as the gradient replay pins it (JAX track_index): the
// family id (0 sphere, 1 quad, 2 AA box, 3 medium; -1 on a miss; the
// record's `fam` cannot tell a quad from a box) and the record index.
struct Winner {
  int fam, idx;
};

// One record test per family: true, with the record in `out`, when record
// `p` is hit closer than `best_t`. The sweep and the gradient replay (which
// resolves a pinned winner with best_t = kBig) run the same f32 sequence.
__device__ __forceinline__ bool sphere_test(const Tables& T, int p, float tm, float ox,
                                            float oy, float oz, float dx, float dy, float dz,
                                            float a, float inv_a, float best_t, Rec& out) {
  float cx = T.s(C0X, p) + tm * T.s(DPX, p);
  float cy = T.s(C0Y, p) + tm * T.s(DPY, p);
  float cz = T.s(C0Z, p) + tm * T.s(DPZ, p);
  float ocx = cx - ox, ocy = cy - oy, ocz = cz - oz;
  float h = dx * ocx + dy * ocy + dz * ocz;
  float rad = T.s(RAD, p);
  float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  float disc = h * h - a * cc;
  bool has = disc >= 0.0f;
  float sq = has ? sqrtf(disc) : 0.0f;
  float root0 = (h - sq) * inv_a;
  float root1 = (h + sq) * inv_a;
  bool ok0 = (root0 > kTMin) && (root0 < best_t);
  bool ok1 = (root1 > kTMin) && (root1 < best_t);
  float root = ok0 ? root0 : root1;
  if (has && (ok0 || ok1) && T.s(SACT, p) > 0.0f) {
    out = Rec{root, 0.0f, T.s(SMAT, p), cx, cy, cz, rad};
    return true;
  }
  return false;
}

__device__ __forceinline__ bool quad_test(const Tables& T, int p, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float best_t,
                                          float aux, Rec& out) {
  float nx = T.q(NX, p), ny = T.q(NY, p), nz = T.q(NZ, p);
  float nd = dx * nx + dy * ny + dz * nz;
  float no = ox * nx + oy * ny + oz * nz;
  bool not_par = fabsf(nd) >= kQuadEps;
  float t = (T.q(QD, p) - no) / (not_par ? nd : 1.0f);
  float o_aa = ox * T.q(AAX, p) + oy * T.q(AAY, p) + oz * T.q(AAZ, p);
  float d_aa = dx * T.q(AAX, p) + dy * T.q(AAY, p) + dz * T.q(AAZ, p);
  float o_ab = ox * T.q(ABX, p) + oy * T.q(ABY, p) + oz * T.q(ABZ, p);
  float d_ab = dx * T.q(ABX, p) + dy * T.q(ABY, p) + dz * T.q(ABZ, p);
  float alpha = o_aa + t * d_aa - T.q(QAA, p);
  float beta = o_ab + t * d_ab - T.q(QAB, p);
  if (not_par && t >= kTMin && t <= best_t && alpha >= 0.0f && alpha <= 1.0f &&
      beta >= 0.0f && beta <= 1.0f) {
    out = Rec{t, 1.0f, T.q(QMAT, p), nx, ny, nz, aux};
    return true;
  }
  return false;
}

// inv_d*: safe_inv of the ray direction, computed once per sweep.
__device__ __forceinline__ bool box_test(const Tables& T, int bi, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float inv_dx,
                                         float inv_dy, float inv_dz, float best_t, float aux,
                                         Rec& out) {
  float tax = (T.b(BX0, bi) - ox) * inv_dx;
  float tbx = (T.b(BX1, bi) - ox) * inv_dx;
  float tay = (T.b(BY0, bi) - oy) * inv_dy;
  float tby = (T.b(BY1, bi) - oy) * inv_dy;
  float taz = (T.b(BZ0, bi) - oz) * inv_dz;
  float tbz = (T.b(BZ1, bi) - oz) * inv_dz;
  float lox = fminf(tax, tbx), hix = fmaxf(tax, tbx);
  float loy = fminf(tay, tby), hiy = fmaxf(tay, tby);
  float loz = fminf(taz, tbz), hiz = fmaxf(taz, tbz);
  float t0 = fmaxf(lox, fmaxf(loy, loz));
  float t1 = fminf(hix, fminf(hiy, hiz));
  bool enter = t0 >= kTMin;
  float t = enter ? t0 : t1;
  bool closer = (t1 > t0) && (t > kTMin) && (t < best_t) && (t1 > kTMin) &&
                T.b(BACT, bi) > 0.0f;
  if (closer) {
    bool ax_x = enter ? (t0 == lox) : (t1 == hix);
    bool ax_y = !ax_x && (enter ? (t0 == loy) : (t1 == hiy));
    bool ax_z = !ax_x && !ax_y;
    float sgn = enter ? -1.0f : 1.0f;
    out = Rec{t, 1.0f, T.b(BMAT, bi), ax_x ? sgn * sign_of(dx) : 0.0f,
              ax_y ? sgn * sign_of(dy) : 0.0f, ax_z ? sgn * sign_of(dz) : 0.0f, aux};
  }
  return closer;
}

// d_len = |d|; the free path draws counter bctr + 3 + m.
__device__ __forceinline__ bool medium_test(const Tables& T, int m, uint32_t key, uint32_t bctr,
                                            float tm, float ox, float oy, float oz, float dx,
                                            float dy, float dz, float d_len, float best_t,
                                            float aux, Rec& out) {
  float omx = T.m(I00, m) * ox + T.m(I01, m) * oy + T.m(I02, m) * oz + T.m(I03, m);
  float omy = T.m(I10, m) * ox + T.m(I11, m) * oy + T.m(I12, m) * oz + T.m(I13, m);
  float omz = T.m(I20, m) * ox + T.m(I21, m) * oy + T.m(I22, m) * oz + T.m(I23, m);
  float dmx_r = T.m(I00, m) * dx + T.m(I01, m) * dy + T.m(I02, m) * dz;
  float dmy_r = T.m(I10, m) * dx + T.m(I11, m) * dy + T.m(I12, m) * dz;
  float dmz_r = T.m(I20, m) * dx + T.m(I21, m) * dy + T.m(I22, m) * dz;
  float dm_len = sqrtf(fmaxf(dmx_r * dmx_r + dmy_r * dmy_r + dmz_r * dmz_r, 1e-24f));
  float dmx = dmx_r / dm_len, dmy = dmy_r / dm_len, dmz = dmz_r / dm_len;
  float t0_, t1_;
  bool v;
  if (T.m(BTYPE, m) == kMediumBox) {
    float ix = safe_inv(dmx), iy = safe_inv(dmy), iz = safe_inv(dmz);
    float ax = (T.m(P0X, m) - omx) * ix, bx = (T.m(P1X, m) - omx) * ix;
    float ay = (T.m(P0Y, m) - omy) * iy, by = (T.m(P1Y, m) - omy) * iy;
    float az = (T.m(P0Z, m) - omz) * iz, bz = (T.m(P1Z, m) - omz) * iz;
    t0_ = fmaxf(fminf(ax, bx), fmaxf(fminf(ay, by), fminf(az, bz)));
    t1_ = fminf(fmaxf(ax, bx), fminf(fmaxf(ay, by), fmaxf(az, bz)));
    v = t0_ < t1_;
  } else {
    float ocx = (T.m(P0X, m) + tm * T.m(DSPX, m)) - omx;
    float ocy = (T.m(P0Y, m) + tm * T.m(DSPY, m)) - omy;
    float ocz = (T.m(P0Z, m) + tm * T.m(DSPZ, m)) - omz;
    float h = dmx * ocx + dmy * ocy + dmz * ocz;
    float rr = T.m(P1X, m);
    float cc = ocx * ocx + ocy * ocy + ocz * ocz - rr * rr;
    float disc = h * h - cc;
    v = disc > 0.0f;
    float sq = v ? sqrtf(disc) : 0.0f;
    t0_ = h - sq;
    t1_ = h + sq;
  }
  v = v && (t1_ > t0_ + kMediumEps);
  float scale = dm_len / d_len;
  float e0 = fmaxf(fmaxf(t0_, kTMin * scale), 0.0f);
  float e1 = fminf(t1_, best_t * scale);
  v = v && (e0 < e1);
  float u_m = draw(key, bctr + 3u + (uint32_t)m);
  float hit_dist = T.m(NID, m) * logf(fmaxf(u_m, 1e-12f));
  v = v && (hit_dist <= (e1 - e0));
  if (v) out = Rec{(e0 + hit_dist) / scale, 2.0f, T.m(MMAT, m), 1.0f, 0.0f, 0.0f, aux};
  return v;
}

// Slab test of AABB `c` of a [6, n] table against the ray's interval
// (JAX _hier_sweep.could_hit): t1 > max(t0, t_min) and t0 < best; with kLe,
// t0 <= best (the warp walk must not skip a cluster that could hold a tie).
template <bool kLe = false>
__device__ __forceinline__ bool could_hit(const float* bb, int n, int c, float ox, float oy,
                                          float oz, float ix, float iy, float iz, float best) {
  float tax = (bb[c] - ox) * ix;
  float tbx = (bb[3 * n + c] - ox) * ix;
  float tay = (bb[n + c] - oy) * iy;
  float tby = (bb[4 * n + c] - oy) * iy;
  float taz = (bb[2 * n + c] - oz) * iz;
  float tbz = (bb[5 * n + c] - oz) * iz;
  float t0 = fmaxf(fminf(tax, tbx), fmaxf(fminf(tay, tby), fminf(taz, tbz)));
  float t1 = fminf(fmaxf(tax, tbx), fminf(fmaxf(tay, tby), fmaxf(taz, tbz)));
  return t1 > fmaxf(t0, kTMin) && (kLe ? t0 <= best : t0 < best);
}

// Visit order of a ray (0..5: +x, -x, +y, -y, +z, -z) by the dominant axis
// of its direction (JAX _closest_hit's rule, :843-856, for one lane).
__device__ __forceinline__ int sweep_dir(float dx, float dy, float dz) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const bool is_x = ax >= ay && ax >= az;
  const bool is_y = !is_x && ay >= az;
  return is_x ? (dx >= 0.0f ? 0 : 1) : is_y ? (dy >= 0.0f ? 2 : 3) : (dz >= 0.0f ? 4 : 5);
}

// The order most of the converged lanes `act` would take (ties to the lower
// index): the warp analogue of JAX's per-tile summed direction.
__device__ __forceinline__ int warp_dir(unsigned act, int dir) {
  int best = dir, best_n = 0;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const int n = __popc(__ballot_sync(act, dir == d));
    if (n > best_n) {
      best_n = n;
      best = d;
    }
  }
  return best;
}

// Rank of record p in the visit order `dir` of a two-level family.
__device__ __forceinline__ int visit_rank(const Clusters& C, int dir, int p) {
  constexpr int kRatio = kSuper / kCluster;
  const int c1 = p / kCluster, c2 = c1 / kRatio;
  return ((int)C.iord[dir * C.n_l2 + c2] * kRatio + (int)C.ilord[dir * C.n_cl + c1]) * kCluster +
         p % kCluster;
}

// The two-level cluster-skip walk over the n records of a clustered family
// (JAX _hier_sweep): superclusters in order, then the clusters inside each
// in order, each entered only when its AABB passes could_hit with the
// running best t. `test(p, best_t, out)` is the family's record test; a
// hit updates r (and, with tracking, *win = {fam, p}). A family of one
// supercluster walks its clusters in index order, as JAX does.
//
// kLane: the lane's own order `dir`, each record taken when strictly
// closer. kWarp: the order of most of the warp's converged lanes, so the
// warp reads one stream of cluster boxes and records; each lane keeps its
// own running best and slab tests (a lane whose slab misses idles). It
// takes the lane's own-order winner: a record's t does not depend on the
// running best, so the winner is the least t, ties to the earliest in the
// lane's order; the walk tests t0 <= best, so no cluster that could hold a
// tie is skipped, and breaks an exact tie with an earlier record of this
// family by the records' ranks in the lane's order (visit_rank).
template <class K, class Test>
__device__ __forceinline__ void hier_sweep(const Clusters& C, int n, int dir, float ox,
                                           float oy, float oz, float ix, float iy, float iz,
                                           Rec& r, int fam, Winner* win,
                                           typename K::Clock* clk, Test test) {
  using Clock = typename K::Clock;
  constexpr int kRatio = kSuper / kCluster;
  constexpr bool kWarp = K::kSweep == Sweep::kWarp;
  const int wdir = kWarp && C.n_l2 >= 2 ? warp_dir(__activemask(), dir) : dir;
  int best_p = -1;  // kWarp: this family's record holding r.t, or -1
  auto cluster = [&](int c1) {
    long long t0 = tick<Clock>();
    const bool enter = could_hit<kWarp>(C.cb, C.n_cl, c1, ox, oy, oz, ix, iy, iz, r.t);
    tock(clk, kPhSlab, t0);
    if (!enter) return;
    t0 = tick<Clock>();
    const int p1 = min(c1 * kCluster + kCluster, n);
    for (int p = c1 * kCluster; p < p1; ++p) {
      if constexpr (kWarp) {
        Rec cand;
        if (test(p, kBig, cand) &&
            (cand.t < r.t || (cand.t == r.t && best_p >= 0 && C.n_l2 >= 2 &&
                              visit_rank(C, dir, p) < visit_rank(C, dir, best_p)))) {
          r = cand;
          best_p = p;
          if constexpr (K::kTrack) *win = Winner{fam, p};
        }
      } else if (test(p, r.t, r)) {
        if constexpr (K::kTrack) *win = Winner{fam, p};
      }
    }
    tock(clk, kPhRecord, t0);
  };
  if (C.n_l2 < 2) {
    for (int c1 = 0; c1 < C.n_cl; ++c1) cluster(c1);
    return;
  }
  for (int i = 0; i < C.n_l2; ++i) {
    const int c2 = (int)C.ord[wdir * C.n_l2 + i];
    const long long t0 = tick<Clock>();
    const bool enter = could_hit<kWarp>(C.sb, C.n_l2, c2, ox, oy, oz, ix, iy, iz, r.t);
    tock(clk, kPhSlab, t0);
    if (!enter) continue;
    for (int j = 0; j < kRatio; ++j) cluster((int)C.lord[wdir * C.n_cl + c2 * kRatio + j]);
  }
}

// The threaded-BVH walk over the clusters of a clustered family (JAX
// _bvh_sweep, megakernel.py:500-552; bvh instances only), per lane: a
// stackless cursor from node 0 along the threading of the lane's own
// direction `dir`; a node whose AABB passes could_hit with the running
// best t is entered (a leaf's 16 records tested, each taken when strictly
// closer), and the cursor follows the node's hit link, else its miss
// link, until it falls below 0. The lane's winner does not depend on
// which other lanes are live, as B3's divergent replay needs.
template <class K, class Test>
__device__ __forceinline__ void bvh_sweep(const Clusters& C, int n, int dir, float ox,
                                          float oy, float oz, float ix, float iy, float iz,
                                          Rec& r, int fam, Winner* win,
                                          typename K::Clock* clk, Test test) {
  using Clock = typename K::Clock;
  const int m = bvh_nodes(C.n_cl);
  const float* bv = C.lord + 6 * C.n_cl;
  const float* bleaf = bv + 6 * m;
  const float* bhit = bleaf + m + dir * m;
  const float* bmiss = bleaf + 7 * m + dir * m;
  int node = 0;
  while (node >= 0) {
    long long t0 = tick<Clock>();
    const bool enter = could_hit(bv, m, node, ox, oy, oz, ix, iy, iz, r.t);
    tock(clk, kPhSlab, t0);
    const int leaf = (int)bleaf[node];
    if (enter && leaf >= 0) {
      t0 = tick<Clock>();
      const int p1 = min(leaf * kCluster + kCluster, n);
      for (int p = leaf * kCluster; p < p1; ++p) {
        if (test(p, r.t, r)) {
          if constexpr (K::kTrack) *win = Winner{fam, p};
        }
      }
      tock(clk, kPhRecord, t0);
    }
    node = (int)(enter ? bhit[node] : bmiss[node]);
  }
}

// A family swept in record order.
template <class K, class Test>
__device__ __forceinline__ void flat_sweep(int n, Rec& r, int fam, Winner* win,
                                           typename K::Clock* clk, Test test) {
  const long long t0 = tick<typename K::Clock>();
  for (int p = 0; p < n; ++p) {
    if (test(p, r.t, r)) {
      if constexpr (K::kTrack) *win = Winner{fam, p};
    }
  }
  tock(clk, kPhRecord, t0);
}

// The closest-hit sweep: quads and media flat in record order, spheres and
// AA boxes flat or, where they are clustered, through hier_sweep (through
// bvh_sweep in a bvh instance), each family only where K's feature mask
// holds it. With K::kTrack it also writes the winner to *win (the forward
// kernels instantiate it without).
template <class K = Cfg<>>
__device__ Rec closest_hit(const Tables& T, const Counts& c, uint32_t key, float bn,
                           float tm, float ox, float oy, float oz, float dx, float dy,
                           float dz, float a, float inv_a, Winner* win = nullptr,
                           typename K::Clock* clk = nullptr) {
  constexpr uint32_t F = K::kFeat;
#ifdef RT2_SWEEP_BVH
  constexpr Sweep S =
      K::kSweep == Sweep::kLane || K::kSweep == Sweep::kWarp ? Sweep::kBvh : K::kSweep;
#else
  constexpr Sweep S = K::kSweep;
#endif
  constexpr bool kClusters = S == Sweep::kLane || S == Sweep::kWarp || S == Sweep::kBvh;
  Rec r{kBig, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  const bool hs = kClusters && (F & kFSph) && T.scl.n_cl > 0;
  const bool hb = kClusters && (F & kFBox) && T.bcl.n_cl > 0;
  float inv_dx = 0.0f, inv_dy = 0.0f, inv_dz = 0.0f;
  int dir = 0;
  if (hs || ((F & kFBox) && c.n_box)) {
    inv_dx = safe_inv(dx);
    inv_dy = safe_inv(dy);
    inv_dz = safe_inv(dz);
  }
  if (hs || hb) {
    dir = sweep_dir(dx, dy, dz);
    if constexpr (K::Clock::kOn) clk->dirs(dir);
  }

  if constexpr ((F & kFSph) && S != Sweep::kNone) {
    auto sph = [&](int p, float best, Rec& out) {
      return sphere_test(T, p, tm, ox, oy, oz, dx, dy, dz, a, inv_a, best, out);
    };
    if (hs) {
      if constexpr (S == Sweep::kBvh) {
        bvh_sweep<K>(T.scl, c.n_sph, dir, ox, oy, oz, inv_dx, inv_dy, inv_dz, r, 0, win, clk,
                     sph);
      } else {
        hier_sweep<K>(T.scl, c.n_sph, dir, ox, oy, oz, inv_dx, inv_dy, inv_dz, r, 0, win, clk,
                      sph);
      }
    } else {
      flat_sweep<K>(c.n_sph, r, 0, win, clk, sph);
    }
  }

  if constexpr (F & kFQuad) {
    flat_sweep<K>(c.n_quad, r, 1, win, clk, [&](int p, float best, Rec& out) {
      return quad_test(T, p, ox, oy, oz, dx, dy, dz, best, out.aux, out);
    });
  }

  if constexpr ((F & kFBox) && S != Sweep::kNone) {
    auto box = [&](int bi, float best, Rec& out) {
      return box_test(T, bi, ox, oy, oz, dx, dy, dz, inv_dx, inv_dy, inv_dz, best, r.aux, out);
    };
    if (hb) {
      if constexpr (S == Sweep::kBvh) {
        bvh_sweep<K>(T.bcl, c.n_box, dir, ox, oy, oz, inv_dx, inv_dy, inv_dz, r, 2, win, clk,
                     box);
      } else {
        hier_sweep<K>(T.bcl, c.n_box, dir, ox, oy, oz, inv_dx, inv_dy, inv_dz, r, 2, win, clk,
                      box);
      }
    } else {
      flat_sweep<K>(c.n_box, r, 2, win, clk, box);
    }
  }

  if constexpr (F & kFMed) {
    if (c.n_med) {
      float d_len = sqrtf(fmaxf(a, 1e-24f));
      uint32_t bctr = (uint32_t)((int)bn * (3 + c.n_med));
      flat_sweep<K>(c.n_med, r, 3, win, clk, [&](int m, float best, Rec& out) {
        return medium_test(T, m, key, bctr, tm, ox, oy, oz, dx, dy, dz, d_len, best, r.aux,
                           out);
      });
    }
  }
  return r;
}

// ---- path state and one bounce (_shade_advance, :1047-1265) --------------

struct Path {
  float bn, alive, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb;
};

// The noise factor of texture `ti` (leaf id `leaf`) at p: table Perlin
// where the tables are staged, else hash Perlin, as far as the mask F holds
// either.
template <uint32_t F>
__device__ __forceinline__ float texture_noise(const Tables& T, int ti, float leaf, float px,
                                               float py, float pz) {
  const float t_scale = T.tx(TSCALE, ti), t_ntype = T.tx(TNTYPE, ti);
  if ((F & kFTableNoise) && (!(F & kFHashNoise) || T.nt)) {
    return noise_factor(px, py, pz, t_scale, t_ntype,
                        TableLattice{T.nt, T.nld, (int)T.tx(TNSLOT, ti) * kNoiseN});
  }
  return noise_factor(px, py, pz, t_scale, t_ntype,
                      HashLattice{mix((uint32_t)(int32_t)leaf ^ 0x5EEDBA5Eu)});
}

// One bounce of a live path (the kernel only calls it with alive > 0). With
// K::kTrack the sweep's winner is written to *win. Returns whether the
// closest hit was a medium (a medium scatter), which v4's counter sums.
template <class K = Cfg<>>
__device__ bool bounce(Path& s, const Tables& T, const Counts& c, const float* bg,
                       uint32_t key, float tm, int max_depth, int checker_depth,
                       bool has_noise, Winner* win = nullptr,
                       typename K::Clock* clk = nullptr) {
  using Clock = typename K::Clock;
  constexpr uint32_t F = K::kFeat;
  float a = s.dx * s.dx + s.dy * s.dy + s.dz * s.dz;
  Rec r = closest_hit<K>(T, c, key, s.bn, tm, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, a, 1.0f / a,
                         win, clk);
  const long long t_shade = tick<Clock>();
  bool valid = r.fam >= 0.0f;
  bool is_sph = r.fam == 0.0f;
  bool is_med = r.fam == 2.0f;

  int mi = (int)r.mat;
  float mtype = T.mt(MTYPE, mi), alr = T.mt(MALR, mi), alg = T.mt(MALG, mi),
        alb = T.mt(MALB, mi), mparam = T.mt(MPARAM, mi), mtex = T.mt(MTEX, mi);

  float px = s.ox + r.t * s.dx;
  float py = s.oy + r.t * s.dy;
  float pz = s.oz + r.t * s.dz;
  float rad_safe = r.aux != 0.0f ? r.aux : 1.0f;
  float onx = is_sph ? (px - r.p0) / rad_safe : r.p0;
  float ony = is_sph ? (py - r.p1) / rad_safe : r.p1;
  float onz = is_sph ? (pz - r.p2) / rad_safe : r.p2;
  bool front_geom = (s.dx * onx + s.dy * ony + s.dz * onz) < 0.0f;
  bool front = front_geom || is_med;
  float sgn = is_med ? 1.0f : (front_geom ? 1.0f : -1.0f);
  float nx = sgn * onx, ny = sgn * ony, nz = sgn * onz;

  // Texture resolve: direct index, one checker level per nesting level.
  float leaf = mtex;
  int ti = (int)leaf;
  if constexpr (F & kFChecker) {
    for (int lvl = 0; lvl < checker_depth; ++lvl) {
      float t_inv = T.tx(TINV, ti);
      float fx = floorf(t_inv * px), fy = floorf(t_inv * py), fz = floorf(t_inv * pz);
      float parity = fx + fy + fz - 2.0f * floorf((fx + fy + fz) * 0.5f);
      float child = parity == 0.0f ? T.tx(TEVEN, ti) : T.tx(TODD, ti);
      if (T.tx(TTYPE, ti) == kTexChecker) leaf = child;
      ti = (int)leaf;
    }
  }
  float t_alr = T.tx(TALR, ti), t_alg = T.tx(TALG, ti), t_alb = T.tx(TALB, ti);
  if constexpr (F & (kFHashNoise | kFTableNoise)) {
    if (has_noise && valid && T.tx(TTYPE, ti) == kTexNoise) {
      const long long t_noise = tick<Clock>();
      const float nfac = texture_noise<F>(T, ti, leaf, px, py, pz);
      tock(clk, kPhNoise, t_noise);
      t_alr = t_alr * nfac;
      t_alg = t_alg * nfac;
      t_alb = t_alb * nfac;
    }
  }

  uint32_t bctr = (uint32_t)((int)s.bn * (3 + c.n_med));
  float u1 = draw(key, bctr), u2 = draw(key, bctr + 1u), u3 = draw(key, bctr + 2u);
  float z = 1.0f - 2.0f * u1;
  float phi = kTwoPi * u2;
  float rxy = sqrtf(fmaxf(1.0f - z * z, 1e-12f));
  float uvx = rxy * cosf(phi), uvy = rxy * sinf(phi), uvz = z;

  bool is_lamb = mtype == kMatLambertian || mtype == kMatTexture;
  bool is_metal = (F & kFMetal) && mtype == kMatMetal;
  bool is_diel = (F & kFDiel) && mtype == kMatDielectric;
  bool is_iso = mtype == kMatIsotropic;
  bool is_light = mtype == kMatLight;
  bool uses_tex = mtype == kMatTexture || is_iso;

  float ndx, ndy, ndz;
  if (is_lamb) {
    ndx = nx + uvx;
    ndy = ny + uvy;
    ndz = nz + uvz;
    if (fabsf(ndx) < kNearZero && fabsf(ndy) < kNearZero && fabsf(ndz) < kNearZero) {
      ndx = nx;
      ndy = ny;
      ndz = nz;
    }
  } else if (is_metal) {
    float dn = s.dx * nx + s.dy * ny + s.dz * nz;
    float rfx = s.dx - 2.0f * dn * nx;
    float rfy = s.dy - 2.0f * dn * ny;
    float rfz = s.dz - 2.0f * dn * nz;
    float rlen = sqrtf(fmaxf(rfx * rfx + rfy * rfy + rfz * rfz, 1e-24f));
    ndx = rfx / rlen + mparam * uvx;
    ndy = rfy / rlen + mparam * uvy;
    ndz = rfz / rlen + mparam * uvz;
  } else if (is_diel) {
    float param_safe = mparam > 0.0f ? mparam : 1.0f;
    float ri = front ? 1.0f / param_safe : param_safe;
    float dlen = sqrtf(fmaxf(a, 1e-24f));
    float udx = s.dx / dlen, udy = s.dy / dlen, udz = s.dz / dlen;
    float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
    float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
    bool cannot = ri * sin_t > 1.0f;
    float r0s = (1.0f - ri) / (1.0f + ri);
    r0s = r0s * r0s;
    float om = 1.0f - cos_t;
    float om2 = om * om;
    float schl = r0s + (1.0f - r0s) * (om * (om2 * om2));
    if (cannot || schl > u3) {
      float udn = udx * nx + udy * ny + udz * nz;
      ndx = udx - 2.0f * udn * nx;
      ndy = udy - 2.0f * udn * ny;
      ndz = udz - 2.0f * udn * nz;
    } else {
      float rpx = ri * (udx + cos_t * nx);
      float rpy = ri * (udy + cos_t * ny);
      float rpz = ri * (udz + cos_t * nz);
      float k = 1.0f - (rpx * rpx + rpy * rpy + rpz * rpz);
      float spar = -sqrtf(fmaxf(fabsf(k), 1e-20f));
      ndx = rpx + spar * nx;
      ndy = rpy + spar * ny;
      ndz = rpz + spar * nz;
    }
  } else {
    ndx = uvx;
    ndy = uvy;
    ndz = uvz;
  }

  if (!valid) {
    s.rr = s.rr + s.tpr * bg[0];
    s.rg = s.rg + s.tpg * bg[1];
    s.rb = s.rb + s.tpb * bg[2];
  } else if (is_light) {
    s.rr = s.rr + s.tpr * t_alr;
    s.rg = s.rg + s.tpg * t_alg;
    s.rb = s.rb + s.tpb * t_alb;
  } else {
    float atr = is_diel ? 1.0f : (uses_tex ? t_alr : alr);
    float atg = is_diel ? 1.0f : (uses_tex ? t_alg : alg);
    float atb = is_diel ? 1.0f : (uses_tex ? t_alb : alb);
    s.tpr = s.tpr * atr;
    s.tpg = s.tpg * atg;
    s.tpb = s.tpb * atb;
    s.ox = px;
    s.oy = py;
    s.oz = pz;
    s.dx = ndx;
    s.dy = ndy;
    s.dz = ndz;
  }
  bool scatter_live = valid && !is_light;
  s.bn = s.bn + 1.0f;
  s.alive = (scatter_live && s.bn < (float)max_depth) ? 1.0f : 0.0f;
  tock(clk, kPhShade, t_shade);
  return is_med;
}

// Camera ray of sample `sg` through pixel (xx, yy) (camera_ray,
// megakernel.py:1694-1726): stratified jitter, defocus disk, shutter time.
// Resets the path to a fresh live ray and returns its time in `tm`.
__device__ __forceinline__ void camera_ray(Path& s, float& tm, const float* cv, uint32_t key,
                                           float xx, float yy, float sg, float sqrt_spp) {
  float u0 = draw(key, 0x40000000u), u1 = draw(key, 0x40000001u),
        u2 = draw(key, 0x40000002u), u3 = draw(key, 0x40000003u),
        u4 = draw(key, 0x40000004u);
  float k1 = floorf(sg / sqrt_spp);
  float s_i = sg - k1 * sqrt_spp;
  float s_j = k1 - floorf(k1 / sqrt_spp) * sqrt_spp;
  float recip = 1.0f / sqrt_spp;
  float pxj = (s_i + u0) * recip - 0.5f;
  float pyj = (s_j + u1) * recip - 0.5f;
  float pcx = cv[0] + (xx + pxj) * cv[3] + (yy + pyj) * cv[6];
  float pcy = cv[1] + (xx + pxj) * cv[4] + (yy + pyj) * cv[7];
  float pcz = cv[2] + (xx + pxj) * cv[5] + (yy + pyj) * cv[8];
  float ox = cv[9], oy = cv[10], oz = cv[11];
  if (cv[18] > 0.0f) {
    float rr = sqrtf(u2);
    float th = kTwoPi * u3;
    float dkx = rr * cosf(th), dky = rr * sinf(th);
    ox = cv[9] + dkx * cv[12] + dky * cv[15];
    oy = cv[10] + dkx * cv[13] + dky * cv[16];
    oz = cv[11] + dkx * cv[14] + dky * cv[17];
  }
  float ddx = pcx - ox, ddy = pcy - oy, ddz = pcz - oz;
  float inv_len = 1.0f / sqrtf(fmaxf(ddx * ddx + ddy * ddy + ddz * ddz, 1e-24f));
  s.ox = ox;
  s.oy = oy;
  s.oz = oz;
  s.dx = ddx * inv_len;
  s.dy = ddy * inv_len;
  s.dz = ddz * inv_len;
  tm = u4;
  s.bn = 0.0f;
  s.alive = 1.0f;
  s.tpr = s.tpg = s.tpb = 1.0f;
}

// Dynamic shared memory of one block: the packed tables, camv, background
// and ntab.
__host__ __device__ inline int block_smem_bytes(const Counts& c) {
  return stage_floats(c) * (int)sizeof(float);
}

// Stage the packed tables, camv, background and ntab (c.n_noise tables of
// `ntab_g`) in shared memory, and with `inverse` the inverse visit orders
// after them (at smem + stage_floats(c)); returns the staged camv (zeros
// where `camv_g` is null: a kernel without a camera). Every thread of the
// block must call it.
__device__ __forceinline__ const float* stage_tables(float* smem, const float* camv_g,
                                                     const float* bg_g, const float* tables_g,
                                                     const float* ntab_g, const Counts& c,
                                                     bool inverse = false) {
  const int n_tab = table_floats(c);
  float* cv = smem + n_tab;
  float* bg = cv + kCamvLen;
  float* nt = bg + 4;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) smem[i] = tables_g[i];
  for (int i = threadIdx.x; i < kCamvLen; i += blockDim.x) cv[i] = camv_g ? camv_g[i] : 0.0f;
  if (threadIdx.x < 3) bg[threadIdx.x] = bg_g[threadIdx.x];
  for (int i = threadIdx.x; i < ntab_floats(c); i += blockDim.x) nt[i] = ntab_g[i];
  if (inverse) {
    float* inv = nt + ntab_floats(c);
    for (int i = threadIdx.x; i < inverse_floats(c); i += blockDim.x) inv[i] = tables_g[n_tab + i];
  }
  __syncthreads();
  return cv;
}

}  // namespace
