// Device code shared by the port's path-tracing kernels (megakernel_v4.cu,
// wavefront_step.cu, and the gradient kernel megakernel_grad.cu): the
// packed-table views, the murmur RNG, hash-gradient noise, the flat
// closest-hit sweep, one bounce of a live path, and the camera ray of a
// regenerated sample. Every kernel includes it, so a path computes the same
// f32 sequence in each of them.
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

struct Counts {
  int n_sph, n_quad, n_mat, n_tex, n_med, n_box;
};

// Column-major views into the shared-memory copy of the packed buffer:
// column k of a family starts at base + k * rows, rows = max(n, 1) for the
// record families and n for materials/textures (table_layout in Python).
struct Tables {
  const float* sph; int ls;
  const float* quad; int lq;
  const float* box; int lb;
  const float* med; int lm;
  const float* mat; int lmat;
  const float* tex; int ltex;
  __device__ float s(int k, int i) const { return sph[k * ls + i]; }
  __device__ float q(int k, int i) const { return quad[k * lq + i]; }
  __device__ float b(int k, int i) const { return box[k * lb + i]; }
  __device__ float m(int k, int i) const { return med[k * lm + i]; }
  __device__ float mt(int k, int i) const { return mat[k * lmat + i]; }
  __device__ float tx(int k, int i) const { return tex[k * ltex + i]; }
};

__host__ __device__ inline int at_least_one(int n) { return n > 0 ? n : 1; }

__host__ __device__ inline int table_floats(const Counts& c) {
  return N_SPH_COLS * at_least_one(c.n_sph) + N_QUAD_COLS * at_least_one(c.n_quad) +
         N_BOX_COLS * at_least_one(c.n_box) + N_MED_COLS * at_least_one(c.n_med) +
         N_MAT_COLS * c.n_mat + N_TEX_COLS * c.n_tex;
}

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
  return t;
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

__device__ float perlin_noise(float px, float py, float pz, uint32_t seed_u) {
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
        hash_gradient(ix + di, iy + dj, iz + dk, seed_u, gx, gy, gz);
        float dot = gx * (u - (float)di) + gy * (v - (float)dj) + gz * (w - (float)dk);
        accum = accum + wi * wj * wk * dot;
      }
    }
  }
  return accum;
}

__device__ float turbulence(float px, float py, float pz, uint32_t seed_u) {
  float accum = 0.0f, weight = 1.0f;
  for (int i = 0; i < 7; ++i) {
    accum = accum + weight * perlin_noise(px, py, pz, seed_u);
    weight *= 0.5f;
    px *= 2.0f;
    py *= 2.0f;
    pz *= 2.0f;
  }
  return fabsf(accum);
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

// The flat sweep. With kTrack it also writes the winner to *win (the
// forward kernels instantiate it without).
template <bool kTrack = false>
__device__ Rec closest_hit(const Tables& T, const Counts& c, uint32_t key, float bn,
                           float tm, float ox, float oy, float oz, float dx, float dy,
                           float dz, float a, float inv_a, Winner* win = nullptr) {
  Rec r{kBig, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};

  for (int p = 0; p < c.n_sph; ++p) {
    if (sphere_test(T, p, tm, ox, oy, oz, dx, dy, dz, a, inv_a, r.t, r)) {
      if constexpr (kTrack) *win = Winner{0, p};
    }
  }

  for (int p = 0; p < c.n_quad; ++p) {
    if (quad_test(T, p, ox, oy, oz, dx, dy, dz, r.t, r.aux, r)) {
      if constexpr (kTrack) *win = Winner{1, p};
    }
  }

  if (c.n_box) {
    float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);
    for (int bi = 0; bi < c.n_box; ++bi) {
      if (box_test(T, bi, ox, oy, oz, dx, dy, dz, inv_dx, inv_dy, inv_dz, r.t, r.aux, r)) {
        if constexpr (kTrack) *win = Winner{2, bi};
      }
    }
  }

  if (c.n_med) {
    float d_len = sqrtf(fmaxf(a, 1e-24f));
    uint32_t bctr = (uint32_t)((int)bn * (3 + c.n_med));
    for (int m = 0; m < c.n_med; ++m) {
      if (medium_test(T, m, key, bctr, tm, ox, oy, oz, dx, dy, dz, d_len, r.t, r.aux, r)) {
        if constexpr (kTrack) *win = Winner{3, m};
      }
    }
  }
  return r;
}

// ---- path state and one bounce (_shade_advance, :1047-1265) --------------

struct Path {
  float bn, alive, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb;
};

// One bounce of a live path (the kernel only calls it with alive > 0). With
// kTrack the sweep's winner is written to *win.
template <bool kTrack = false>
__device__ void bounce(Path& s, const Tables& T, const Counts& c, const float* bg,
                       uint32_t key, float tm, int max_depth, int checker_depth,
                       bool has_noise, Winner* win = nullptr) {
  float a = s.dx * s.dx + s.dy * s.dy + s.dz * s.dz;
  Rec r = closest_hit<kTrack>(T, c, key, s.bn, tm, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, a,
                              1.0f / a, win);
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
  for (int lvl = 0; lvl < checker_depth; ++lvl) {
    float t_inv = T.tx(TINV, ti);
    float fx = floorf(t_inv * px), fy = floorf(t_inv * py), fz = floorf(t_inv * pz);
    float parity = fx + fy + fz - 2.0f * floorf((fx + fy + fz) * 0.5f);
    float child = parity == 0.0f ? T.tx(TEVEN, ti) : T.tx(TODD, ti);
    if (T.tx(TTYPE, ti) == kTexChecker) leaf = child;
    ti = (int)leaf;
  }
  float t_alr = T.tx(TALR, ti), t_alg = T.tx(TALG, ti), t_alb = T.tx(TALB, ti);
  if (has_noise && valid && T.tx(TTYPE, ti) == kTexNoise) {
    float t_scale = T.tx(TSCALE, ti);
    uint32_t nseed = mix((uint32_t)(int32_t)leaf ^ 0x5EEDBA5Eu);
    float nfac;
    if (T.tx(TNTYPE, ti) == kNoiseMarble) {
      nfac = 0.5f * (1.0f + sinf(t_scale * pz + 10.0f * turbulence(px, py, pz, nseed)));
    } else {
      nfac = 0.5f * (1.0f + perlin_noise(t_scale * px, t_scale * py, t_scale * pz, nseed));
    }
    t_alr = t_alr * nfac;
    t_alg = t_alg * nfac;
    t_alb = t_alb * nfac;
  }

  uint32_t bctr = (uint32_t)((int)s.bn * (3 + c.n_med));
  float u1 = draw(key, bctr), u2 = draw(key, bctr + 1u), u3 = draw(key, bctr + 2u);
  float z = 1.0f - 2.0f * u1;
  float phi = kTwoPi * u2;
  float rxy = sqrtf(fmaxf(1.0f - z * z, 1e-12f));
  float uvx = rxy * cosf(phi), uvy = rxy * sinf(phi), uvz = z;

  bool is_lamb = mtype == kMatLambertian || mtype == kMatTexture;
  bool is_metal = mtype == kMatMetal;
  bool is_diel = mtype == kMatDielectric;
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

// Dynamic shared memory of one block: the packed tables, camv, background.
__host__ __device__ inline int block_smem_bytes(const Counts& c) {
  return (table_floats(c) + kCamvLen + 4) * (int)sizeof(float);
}

// Stage the packed tables, camv and background in shared memory; returns the
// staged camv. Every thread of the block must call it.
__device__ __forceinline__ const float* stage_tables(float* smem, const float* camv_g,
                                                     const float* bg_g, const float* tables_g,
                                                     const Counts& c) {
  const int n_tab = table_floats(c);
  float* cv = smem + n_tab;
  float* bg = cv + kCamvLen;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) smem[i] = tables_g[i];
  for (int i = threadIdx.x; i < kCamvLen; i += blockDim.x) cv[i] = camv_g[i];
  if (threadIdx.x < 3) bg[threadIdx.x] = bg_g[threadIdx.x];
  __syncthreads();
  return cv;
}

}  // namespace
