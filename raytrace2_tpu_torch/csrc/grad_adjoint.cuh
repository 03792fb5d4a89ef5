// Per-thread work of the gradient kernel (megakernel_grad.cu): the
// hand-derived adjoint of one replayed bounce and of the camera ray, and the
// loop over one pixel slot's samples that drives them.
//
// The replay follows raytrace2_tpu/ops/pallas/megakernel_grad.py: a
// pre-pass runs the forward path (path_common.cuh's camera_ray and bounce,
// with winner tracking) and stores each bounce's entry carry and winner;
// the reverse pass then walks the bounces from last to first, recomputes
// each one's resolve and shade from its stored carry, and applies the
// adjoint of that computation, chaining the cotangent of the ray
// (origin, direction) and throughput backwards. The radiance cotangent is
// the pixel's cotangent at every bounce (radiance only accumulates).
//
// Estimator: discrete choices carry no gradient (which record wins, root
// choice, front/back, the box's face axis, reflect/refract, the checker
// cell, the noise lattice cell, medium acceptance, alive). max/min split a
// tie evenly, as JAX's JVP does. Reported table cotangents are the
// GRAD_*_KEYS columns (ops/kernels/megakernel_grad.py); the medium's
// boundary geometry takes part in the chain through the ray but reports
// nothing, as in the JAX kernel.

#pragma once

#include "path_common.cuh"

namespace {

constexpr int kGradMaxDepth = 64;
// A profiling-only feature bit (csrc/grad_profile.cu): no cotangent atomics.
constexpr uint32_t kFProfNoCot = 1u << 16;
constexpr int kNCamvDiff = 19;

// Table cotangents in the packed layout (shared or device memory).
struct Cot {
  float* sph; int ls;
  float* quad; int lq;
  float* box; int lb;
  float* med; int lm;
  float* mat; int lmat;
  float* tex; int ltex;
};

__device__ inline Cot make_cot(float* base, const Counts& c) {
  Tables t = make_tables(base, c);
  return Cot{const_cast<float*>(t.sph), t.ls,   const_cast<float*>(t.quad), t.lq,
             const_cast<float*>(t.box), t.lb,   const_cast<float*>(t.med), t.lm,
             const_cast<float*>(t.mat), t.lmat, const_cast<float*>(t.tex), t.ltex};
}

// Adds a table cotangent (one shared or global atomic). In the profiling
// build's kFProfNoCot instance the atomic is compiled out, its value kept.
template <uint32_t F>
__device__ __forceinline__ void cot_add(float* p, float v) {
  if constexpr ((F & kFProfNoCot) != 0) {
    asm volatile("" ::"f"(v));
  } else if (v != 0.0f) {
    atomicAdd(p, v);
  }
}

// JAX's max/min adjoint: the larger (smaller) operand takes the cotangent,
// a tie splits it.
__device__ __forceinline__ void max_adj(float a, float b, float g, float& ga, float& gb) {
  if (a > b) {
    ga += g;
  } else if (b > a) {
    gb += g;
  } else {
    ga += 0.5f * g;
    gb += 0.5f * g;
  }
}

__device__ __forceinline__ void min_adj(float a, float b, float g, float& ga, float& gb) {
  if (a < b) {
    ga += g;
  } else if (b < a) {
    gb += g;
  } else {
    ga += 0.5f * g;
    gb += 0.5f * g;
  }
}

// Cotangent of c through safe_inv(c) = 1/c (zero where the clamp holds).
__device__ __forceinline__ float safe_inv_adj(float c, float inv, float g) {
  return fabsf(c) < 1e-12f ? 0.0f : -g * inv * inv;
}

// Cotangent of v through v / |v| (|v|^2 = n2, inv_len = 1/|v|, u = v/|v|),
// with |v| held constant below the 1e-24 clamp.
__device__ __forceinline__ void normalize_adj(float n2, float inv_len, float ux, float uy,
                                              float uz, float& gx, float& gy, float& gz) {
  if (n2 > 1e-24f) {
    float pr = ux * gx + uy * gy + uz * gz;
    gx -= ux * pr;
    gy -= uy * pr;
    gz -= uz * pr;
  }
  gx *= inv_len;
  gy *= inv_len;
  gz *= inv_len;
}

// ---- noise with its gradient (megakernel.py _noise_factor_remat,
// _nfrt_fwd/_nfrt_bwd) ----------------------------------------------------

// One octave of Perlin noise (hash or table lattice, path_common.cuh) and
// its gradient in p; the lattice cell is detached (floor has derivative 0,
// the tables are constants).
template <class Lattice>
__device__ float perlin_noise_grad(float px, float py, float pz, const Lattice& lat, float& dpx,
                                   float& dpy, float& dpz) {
  float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  uint32_t ix = (uint32_t)(int32_t)fx, iy = (uint32_t)(int32_t)fy, iz = (uint32_t)(int32_t)fz;
  float u = px - fx, v = py - fy, w = pz - fz;
  float uu = u * u * (3.0f - 2.0f * u), duu = 6.0f * u * (1.0f - u);
  float vv = v * v * (3.0f - 2.0f * v), dvv = 6.0f * v * (1.0f - v);
  float ww = w * w * (3.0f - 2.0f * w), dww = 6.0f * w * (1.0f - w);
  float accum = 0.0f;
  dpx = dpy = dpz = 0.0f;
  for (int di = 0; di < 2; ++di) {
    float wi = di ? uu : (1.0f - uu), dwi = di ? duu : -duu;
    for (int dj = 0; dj < 2; ++dj) {
      float wj = dj ? vv : (1.0f - vv), dwj = dj ? dvv : -dvv;
      for (int dk = 0; dk < 2; ++dk) {
        float wk = dk ? ww : (1.0f - ww), dwk = dk ? dww : -dww;
        float gx, gy, gz;
        lat.at(ix + di, iy + dj, iz + dk, gx, gy, gz);
        float ex = u - (float)di, ey = v - (float)dj, ez = w - (float)dk;
        float dot = gx * ex + gy * ey + gz * ez;
        float w3 = wi * wj * wk;
        accum = accum + w3 * dot;
        dpx += dwi * wj * wk * dot + w3 * gx;
        dpy += wi * dwj * wk * dot + w3 * gy;
        dpz += wi * wj * dwk * dot + w3 * gz;
      }
    }
  }
  return accum;
}

// Marble or Perlin factor at p (Texture.cpp:13-22) and its derivatives in p
// and in the texture's scale.
template <class Lattice>
__device__ float noise_factor_grad(float px, float py, float pz, float t_scale, float t_ntype,
                                   const Lattice& lat, float* dp, float& dscale) {
  if (t_ntype == kNoiseMarble) {
    float acc = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f, weight = 1.0f, mul = 1.0f;
    float sx = px, sy = py, sz = pz;
    for (int i = 0; i < 7; ++i) {
      float gx, gy, gz;
      acc = acc + weight * perlin_noise_grad(sx, sy, sz, lat, gx, gy, gz);
      // d(noise(2^i p))/dp = 2^i grad: weight * 2^i == 1.
      ax += weight * mul * gx;
      ay += weight * mul * gy;
      az += weight * mul * gz;
      weight *= 0.5f;
      mul *= 2.0f;
      sx *= 2.0f;
      sy *= 2.0f;
      sz *= 2.0f;
    }
    float sgn = sign_of(acc);  // |acc|' (0 at 0, as in JAX)
    float arg = t_scale * pz + 10.0f * fabsf(acc);
    float c = 0.5f * cosf(arg);
    dp[0] = c * 10.0f * sgn * ax;
    dp[1] = c * 10.0f * sgn * ay;
    dp[2] = c * (t_scale + 10.0f * sgn * az);
    dscale = c * pz;
    return 0.5f * (1.0f + sinf(arg));
  }
  float gx, gy, gz;
  float n = perlin_noise_grad(t_scale * px, t_scale * py, t_scale * pz, lat, gx, gy, gz);
  dp[0] = 0.5f * t_scale * gx;
  dp[1] = 0.5f * t_scale * gy;
  dp[2] = 0.5f * t_scale * gz;
  dscale = 0.5f * (gx * px + gy * py + gz * pz);
  return 0.5f * (1.0f + n);
}

// ---- one bounce -----------------------------------------------------------

// Entry carry of a stored bounce (bn is the bounce index, alive is 1).
struct Entry {
  float ox, oy, oz, dx, dy, dz, tpr, tpg, tpb;
};

// Cotangents of a bounce's output ray and throughput; on return, of its
// input.
struct Adj {
  float ox, oy, oz, dx, dy, dz, tpr, tpg, tpb;
};

// The pinned winner's record, recomputed with best_t = kBig (the winner's
// root choice and a medium's free path do not depend on the running best).
// F: the scene features the instance holds (a winner is of a family F holds).
template <uint32_t F>
__device__ Rec resolve(const Tables& T, const Counts& c, uint32_t key, float bn, float tm,
                       Winner w, float ox, float oy, float oz, float dx, float dy, float dz,
                       float a, float inv_a) {
  Rec r{kBig, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  if ((F & kFSph) && w.fam == 0) {
    sphere_test(T, w.idx, tm, ox, oy, oz, dx, dy, dz, a, inv_a, kBig, r);
  } else if ((F & kFQuad) && w.fam == 1) {
    quad_test(T, w.idx, ox, oy, oz, dx, dy, dz, kBig, 1.0f, r);
  } else if ((F & kFBox) && w.fam == 2) {
    box_test(T, w.idx, ox, oy, oz, dx, dy, dz, safe_inv(dx), safe_inv(dy), safe_inv(dz), kBig,
             1.0f, r);
  } else if ((F & kFMed) && w.fam == 3) {
    uint32_t bctr = (uint32_t)((int)bn * (3 + c.n_med));
    medium_test(T, w.idx, key, bctr, tm, ox, oy, oz, dx, dy, dz, sqrtf(fmaxf(a, 1e-24f)), kBig,
                1.0f, r);
  }
  return r;
}

// Adjoint of the resolve: the cotangent of the hit distance gt, of a
// sphere's center (gc) and radius (grad), and of a quad's normal (gn) go to
// the ray (go, gd) and the winner's table rows.
template <uint32_t F>
__device__ void resolve_adjoint(const Tables& T, const Counts& c, const Cot& D, uint32_t key,
                                float bn, float tm, Winner w, float ox, float oy, float oz,
                                float dx, float dy, float dz, float a, float inv_a, float gt,
                                const float* gc, float grad, const float* gn, float* go,
                                float* gd) {
  const int p = w.idx;
  if ((F & kFSph) && w.fam == 0) {
    float cx = T.s(C0X, p) + tm * T.s(DPX, p);
    float cy = T.s(C0Y, p) + tm * T.s(DPY, p);
    float cz = T.s(C0Z, p) + tm * T.s(DPZ, p);
    float ocx = cx - ox, ocy = cy - oy, ocz = cz - oz;
    float h = dx * ocx + dy * ocy + dz * ocz;
    float rad = T.s(RAD, p);
    float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    float disc = h * h - a * cc;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float root0 = (h - sq) * inv_a;
    float s = (root0 > kTMin && root0 < kBig) ? -1.0f : 1.0f;
    // t = (h + s*sq) * inv_a
    float gh = gt * inv_a, gsq = s * gt * inv_a, ginv_a = gt * (h + s * sq);
    float gdisc = sq > 0.0f ? gsq / (2.0f * sq) : 0.0f;
    gh += 2.0f * h * gdisc;
    float ga = -cc * gdisc - ginv_a * inv_a * inv_a;
    float gcc = -a * gdisc;
    float gocx = 2.0f * ocx * gcc + gh * dx;
    float gocy = 2.0f * ocy * gcc + gh * dy;
    float gocz = 2.0f * ocz * gcc + gh * dz;
    gd[0] += gh * ocx + 2.0f * ga * dx;
    gd[1] += gh * ocy + 2.0f * ga * dy;
    gd[2] += gh * ocz + 2.0f * ga * dz;
    go[0] -= gocx;
    go[1] -= gocy;
    go[2] -= gocz;
    float gcx = gc[0] + gocx, gcy = gc[1] + gocy, gcz = gc[2] + gocz;
    cot_add<F>(&D.sph[C0X * D.ls + p], gcx);
    cot_add<F>(&D.sph[C0Y * D.ls + p], gcy);
    cot_add<F>(&D.sph[C0Z * D.ls + p], gcz);
    cot_add<F>(&D.sph[DPX * D.ls + p], tm * gcx);
    cot_add<F>(&D.sph[DPY * D.ls + p], tm * gcy);
    cot_add<F>(&D.sph[DPZ * D.ls + p], tm * gcz);
    cot_add<F>(&D.sph[RAD * D.ls + p], grad - 2.0f * rad * gcc);
  } else if ((F & kFQuad) && w.fam == 1) {
    float nx = T.q(NX, p), ny = T.q(NY, p), nz = T.q(NZ, p);
    float nd = dx * nx + dy * ny + dz * nz;
    float no = ox * nx + oy * ny + oz * nz;
    float num = T.q(QD, p) - no;
    // t = num / nd
    float gnum = gt / nd, gnd = -gt * num / (nd * nd);
    float gno = -gnum;
    go[0] += gno * nx;
    go[1] += gno * ny;
    go[2] += gno * nz;
    gd[0] += gnd * nx;
    gd[1] += gnd * ny;
    gd[2] += gnd * nz;
    cot_add<F>(&D.quad[NX * D.lq + p], gn[0] + gno * ox + gnd * dx);
    cot_add<F>(&D.quad[NY * D.lq + p], gn[1] + gno * oy + gnd * dy);
    cot_add<F>(&D.quad[NZ * D.lq + p], gn[2] + gno * oz + gnd * dz);
    cot_add<F>(&D.quad[QD * D.lq + p], gnum);
  } else if ((F & kFBox) && w.fam == 2) {
    const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
    float inv[3], ta[3], tb[3], lo[3], hi[3];
    for (int k = 0; k < 3; ++k) {
      inv[k] = safe_inv(d[k]);
      ta[k] = (T.b(BX0 + k, p) - o[k]) * inv[k];
      tb[k] = (T.b(BX1 + k, p) - o[k]) * inv[k];
      lo[k] = fminf(ta[k], tb[k]);
      hi[k] = fmaxf(ta[k], tb[k]);
    }
    float t0 = fmaxf(lo[0], fmaxf(lo[1], lo[2]));
    float t1 = fminf(hi[0], fminf(hi[1], hi[2]));
    bool enter = t0 >= kTMin;
    float glo[3] = {0.0f, 0.0f, 0.0f}, ghi[3] = {0.0f, 0.0f, 0.0f}, gm = 0.0f;
    if (enter) {
      max_adj(lo[0], fmaxf(lo[1], lo[2]), gt, glo[0], gm);
      max_adj(lo[1], lo[2], gm, glo[1], glo[2]);
    } else {
      min_adj(hi[0], fminf(hi[1], hi[2]), gt, ghi[0], gm);
      min_adj(hi[1], hi[2], gm, ghi[1], ghi[2]);
    }
    for (int k = 0; k < 3; ++k) {
      float gta = 0.0f, gtb = 0.0f;
      min_adj(ta[k], tb[k], glo[k], gta, gtb);
      max_adj(ta[k], tb[k], ghi[k], gta, gtb);
      cot_add<F>(&D.box[(BX0 + k) * D.lb + p], gta * inv[k]);
      cot_add<F>(&D.box[(BX1 + k) * D.lb + p], gtb * inv[k]);
      go[k] -= (gta + gtb) * inv[k];
      float ginv = gta * (T.b(BX0 + k, p) - o[k]) + gtb * (T.b(BX1 + k, p) - o[k]);
      gd[k] += safe_inv_adj(d[k], inv[k], ginv);
    }
  } else if ((F & kFMed) && w.fam == 3) {
    const int m = p;
    const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
    float M[3][4], om[3], dmr[3];
    for (int r = 0; r < 3; ++r) {
      for (int k = 0; k < 4; ++k) M[r][k] = T.m(I00 + 4 * r + k, m);
      om[r] = M[r][0] * ox + M[r][1] * oy + M[r][2] * oz + M[r][3];
      dmr[r] = M[r][0] * dx + M[r][1] * dy + M[r][2] * dz;
    }
    float dml2 = dmr[0] * dmr[0] + dmr[1] * dmr[1] + dmr[2] * dmr[2];
    float dm_len = sqrtf(fmaxf(dml2, 1e-24f));
    float dm[3] = {dmr[0] / dm_len, dmr[1] / dm_len, dmr[2] / dm_len};
    const bool is_box = T.m(BTYPE, m) == kMediumBox;
    float t0_;
    float ix[3], ab[3][2], oc[3], h = 0.0f, sq = 0.0f;
    if (is_box) {
      float mn[3];
      for (int k = 0; k < 3; ++k) {
        ix[k] = safe_inv(dm[k]);
        ab[k][0] = (T.m(P0X + k, m) - om[k]) * ix[k];
        ab[k][1] = (T.m(P1X + k, m) - om[k]) * ix[k];
        mn[k] = fminf(ab[k][0], ab[k][1]);
      }
      t0_ = fmaxf(mn[0], fmaxf(mn[1], mn[2]));
    } else {
      for (int k = 0; k < 3; ++k) {
        oc[k] = (T.m(P0X + k, m) + tm * T.m(DSPX + k, m)) - om[k];
        h += dm[k] * oc[k];
      }
      float rr = T.m(P1X, m);
      float cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rr * rr;
      sq = sqrtf(fmaxf(h * h - cc, 0.0f));
      t0_ = h - sq;
    }
    float d_len = sqrtf(fmaxf(a, 1e-24f));
    float scale = dm_len / d_len;
    float m1 = fmaxf(t0_, kTMin * scale);
    float e0 = fmaxf(m1, 0.0f);
    uint32_t bctr = (uint32_t)((int)bn * (3 + c.n_med));
    float lu = logf(fmaxf(draw(key, bctr + 3u + (uint32_t)m), 1e-12f));
    float hd = T.m(NID, m) * lu;
    float tw = (e0 + hd) / scale;
    // t_world = (e0 + hd) / scale
    float ge0 = gt / scale, ghd = gt / scale, gscale = -gt * tw / scale;
    cot_add<F>(&D.med[NID * D.lm + m], ghd * lu);
    float gm1 = 0.0f, gz = 0.0f, gt0 = 0.0f, gts = 0.0f;
    max_adj(m1, 0.0f, ge0, gm1, gz);
    max_adj(t0_, kTMin * scale, gm1, gt0, gts);
    gscale += kTMin * gts;
    // scale = dm_len / d_len
    float gdm_len = gscale / d_len, gd_len = -gscale * scale / d_len;
    if (a > 1e-24f) {
      for (int k = 0; k < 3; ++k) gd[k] += gd_len * d[k] / d_len;
    }
    float gdm[3] = {0.0f, 0.0f, 0.0f}, gom[3] = {0.0f, 0.0f, 0.0f};
    if (is_box) {
      float mn[3], gmn[3] = {0.0f, 0.0f, 0.0f}, gyz = 0.0f;
      for (int k = 0; k < 3; ++k) mn[k] = fminf(ab[k][0], ab[k][1]);
      max_adj(mn[0], fmaxf(mn[1], mn[2]), gt0, gmn[0], gyz);
      max_adj(mn[1], mn[2], gyz, gmn[1], gmn[2]);
      for (int k = 0; k < 3; ++k) {
        float ga = 0.0f, gb = 0.0f;
        min_adj(ab[k][0], ab[k][1], gmn[k], ga, gb);
        gom[k] -= (ga + gb) * ix[k];
        float gix = ga * (T.m(P0X + k, m) - om[k]) + gb * (T.m(P1X + k, m) - om[k]);
        gdm[k] += safe_inv_adj(dm[k], ix[k], gix);
      }
    } else {
      // t0_ = h - sqrt(h^2 - cc), cc = |oc|^2 - r^2, h = dm . oc
      float gh = gt0, gsq = -gt0;
      float gdisc = sq > 0.0f ? gsq / (2.0f * sq) : 0.0f;
      gh += 2.0f * h * gdisc;
      float gcc = -gdisc;
      for (int k = 0; k < 3; ++k) {
        float goc = 2.0f * oc[k] * gcc + gh * dm[k];
        gdm[k] += gh * oc[k];
        gom[k] -= goc;
      }
    }
    // dm = dmr / dm_len, dm_len = |dmr| (clamped)
    float pr = gdm[0] * dmr[0] + gdm[1] * dmr[1] + gdm[2] * dmr[2];
    gdm_len -= pr / (dm_len * dm_len);
    float gdmr[3];
    for (int k = 0; k < 3; ++k) {
      gdmr[k] = gdm[k] / dm_len + (dml2 > 1e-24f ? gdm_len * dmr[k] / dm_len : 0.0f);
    }
    // om = M[:, :3] o + M[:, 3], dmr = M[:, :3] d
    for (int k = 0; k < 3; ++k) {
      for (int r = 0; r < 3; ++r) {
        go[k] += M[r][k] * gom[r];
        gd[k] += M[r][k] * gdmr[r];
      }
    }
  }
}

// Reverse step of stored bounce `bn`: recomputes its resolve and shade from
// the entry carry `e` and winner `w`, then maps the exit cotangents `A`
// (ray, throughput) and the radiance cotangent `gr` to the entry's
// cotangents (in `A`), the background (`dbg`) and the table rows (`D`).
template <uint32_t F>
__device__ void bounce_adjoint(const Tables& T, const Counts& c, const float* bg,
                               uint32_t key, float tm, float bn, Winner w, const Entry& e,
                               const float* gr, Adj& A, const Cot& D, float* dbg,
                               int checker_depth, bool has_noise) {
  const float ox = e.ox, oy = e.oy, oz = e.oz, dx = e.dx, dy = e.dy, dz = e.dz;
  const float tp[3] = {e.tpr, e.tpg, e.tpb};
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const Rec r = resolve<F>(T, c, key, bn, tm, w, ox, oy, oz, dx, dy, dz, a, inv_a);

  if (!(r.fam >= 0.0f)) {
    // Miss: radiance += tp * bg; the ray and throughput pass through.
    for (int k = 0; k < 3; ++k) dbg[k] += gr[k] * tp[k];
    A.tpr += gr[0] * bg[0];
    A.tpg += gr[1] * bg[1];
    A.tpb += gr[2] * bg[2];
    return;
  }

  // ---- forward: shade (as path_common.cuh's bounce) ----
  const bool is_sph = (F & kFSph) && r.fam == 0.0f;
  const bool is_med = (F & kFMed) && r.fam == 2.0f;
  const int mi = (int)r.mat;
  const float mtype = T.mt(MTYPE, mi), mparam = T.mt(MPARAM, mi), mtex = T.mt(MTEX, mi);
  const float p[3] = {ox + r.t * dx, oy + r.t * dy, oz + r.t * dz};
  const float rad_safe = r.aux != 0.0f ? r.aux : 1.0f;
  const float rp[3] = {r.p0, r.p1, r.p2};
  float on[3];
  for (int k = 0; k < 3; ++k) on[k] = is_sph ? (p[k] - rp[k]) / rad_safe : rp[k];
  const bool front_geom = (dx * on[0] + dy * on[1] + dz * on[2]) < 0.0f;
  const bool front = front_geom || is_med;
  const float sgn = is_med ? 1.0f : (front_geom ? 1.0f : -1.0f);
  const float n[3] = {sgn * on[0], sgn * on[1], sgn * on[2]};

  float leaf = mtex;
  int ti = (int)leaf;
  if constexpr (F & kFChecker) {
    for (int lvl = 0; lvl < checker_depth; ++lvl) {
      float t_inv = T.tx(TINV, ti);
      float fx = floorf(t_inv * p[0]), fy = floorf(t_inv * p[1]), fz = floorf(t_inv * p[2]);
      float parity = fx + fy + fz - 2.0f * floorf((fx + fy + fz) * 0.5f);
      float child = parity == 0.0f ? T.tx(TEVEN, ti) : T.tx(TODD, ti);
      if (T.tx(TTYPE, ti) == kTexChecker) leaf = child;
      ti = (int)leaf;
    }
  }
  const float t_raw[3] = {T.tx(TALR, ti), T.tx(TALG, ti), T.tx(TALB, ti)};
  constexpr bool kNoise = (F & (kFHashNoise | kFTableNoise)) != 0;
  const bool noisy = kNoise && has_noise && T.tx(TTYPE, ti) == kTexNoise;
  float nfac = 1.0f, ndp[3] = {0.0f, 0.0f, 0.0f}, ndscale = 0.0f;
  if (noisy) {
    const float t_scale = T.tx(TSCALE, ti), t_ntype = T.tx(TNTYPE, ti);
    if ((F & kFTableNoise) && (!(F & kFHashNoise) || T.nt)) {
      nfac = noise_factor_grad(p[0], p[1], p[2], t_scale, t_ntype,
                               TableLattice{T.nt, T.nld, (int)T.tx(TNSLOT, ti) * kNoiseN}, ndp,
                               ndscale);
    } else {
      nfac = noise_factor_grad(p[0], p[1], p[2], t_scale, t_ntype,
                               HashLattice{mix((uint32_t)(int32_t)leaf ^ 0x5EEDBA5Eu)}, ndp,
                               ndscale);
    }
  }
  float t_al[3];
  for (int k = 0; k < 3; ++k) t_al[k] = noisy ? t_raw[k] * nfac : t_raw[k];

  const uint32_t bctr = (uint32_t)((int)bn * (3 + c.n_med));
  const float u1 = draw(key, bctr), u2 = draw(key, bctr + 1u), u3 = draw(key, bctr + 2u);
  const float z = 1.0f - 2.0f * u1;
  const float phi = kTwoPi * u2;
  const float rxy = sqrtf(fmaxf(1.0f - z * z, 1e-12f));
  const float uv[3] = {rxy * cosf(phi), rxy * sinf(phi), z};

  const bool is_lamb = mtype == kMatLambertian || mtype == kMatTexture;
  const bool is_metal = (F & kFMetal) && mtype == kMatMetal;
  const bool is_diel = (F & kFDiel) && mtype == kMatDielectric;
  const bool is_light = mtype == kMatLight;
  const bool uses_tex = mtype == kMatTexture || mtype == kMatIsotropic;

  // ---- adjoint ----
  const float d[3] = {dx, dy, dz};
  float gp[3] = {0.0f, 0.0f, 0.0f};   // hit point
  float gn[3] = {0.0f, 0.0f, 0.0f};   // shading normal
  float go[3], gd[3];                 // entry ray
  float gtal[3] = {0.0f, 0.0f, 0.0f}; // textured albedo (after noise)
  float gparam = 0.0f;
  float gtp[3];
  if (is_light) {
    // radiance += tp * t_al; the ray and throughput pass through.
    for (int k = 0; k < 3; ++k) gtal[k] = gr[k] * tp[k];
    gtp[0] = A.tpr + gr[0] * t_al[0];
    gtp[1] = A.tpg + gr[1] * t_al[1];
    gtp[2] = A.tpb + gr[2] * t_al[2];
    go[0] = A.ox; go[1] = A.oy; go[2] = A.oz;
    gd[0] = A.dx; gd[1] = A.dy; gd[2] = A.dz;
  } else {
    // tp' = tp * at, o' = p, d' = scatter direction.
    const float gtp_out[3] = {A.tpr, A.tpg, A.tpb};
    for (int k = 0; k < 3; ++k) {
      float gat = gtp_out[k] * tp[k];
      if (is_diel) {
        gtp[k] = gtp_out[k];
      } else if (uses_tex) {
        gtp[k] = gtp_out[k] * t_al[k];
        gtal[k] += gat;
      } else {
        gtp[k] = gtp_out[k] * T.mt(MALR + k, mi);
        cot_add<F>(&D.mat[(MALR + k) * D.lmat + mi], gat);
      }
    }
    gp[0] = A.ox; gp[1] = A.oy; gp[2] = A.oz;
    go[0] = go[1] = go[2] = 0.0f;
    gd[0] = gd[1] = gd[2] = 0.0f;
    const float gnd[3] = {A.dx, A.dy, A.dz};
    if (is_lamb) {
      // n + uv, or n where that is degenerate: d/dn is the identity either way.
      for (int k = 0; k < 3; ++k) gn[k] += gnd[k];
    } else if (is_metal) {
      float dn = dx * n[0] + dy * n[1] + dz * n[2];
      float rf[3], r2 = 0.0f;
      for (int k = 0; k < 3; ++k) {
        rf[k] = d[k] - 2.0f * dn * n[k];
        r2 += rf[k] * rf[k];
      }
      float rlen = sqrtf(fmaxf(r2, 1e-24f));
      gparam += gnd[0] * uv[0] + gnd[1] * uv[1] + gnd[2] * uv[2];
      float grf[3] = {gnd[0], gnd[1], gnd[2]};
      normalize_adj(r2, 1.0f / rlen, rf[0] / rlen, rf[1] / rlen, rf[2] / rlen, grf[0], grf[1],
                    grf[2]);
      float gdn = -2.0f * (grf[0] * n[0] + grf[1] * n[1] + grf[2] * n[2]);
      for (int k = 0; k < 3; ++k) {
        gd[k] += grf[k] + gdn * n[k];
        gn[k] += -2.0f * dn * grf[k] + gdn * d[k];
      }
    } else if (is_diel) {
      float ps = mparam > 0.0f ? mparam : 1.0f;
      float ri = front ? 1.0f / ps : ps;
      float dlen = sqrtf(fmaxf(a, 1e-24f));
      float ud[3] = {dx / dlen, dy / dlen, dz / dlen};
      float cos_raw = -(ud[0] * n[0] + ud[1] * n[1] + ud[2] * n[2]);
      float cos_t = fminf(cos_raw, 1.0f);
      float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
      bool cannot = ri * sin_t > 1.0f;
      float r0s = (1.0f - ri) / (1.0f + ri);
      r0s = r0s * r0s;
      float om = 1.0f - cos_t;
      float om2 = om * om;
      float schl = r0s + (1.0f - r0s) * (om * (om2 * om2));
      float gud[3] = {0.0f, 0.0f, 0.0f};
      if (cannot || schl > u3) {
        // ud - 2 (ud.n) n
        float udn = ud[0] * n[0] + ud[1] * n[1] + ud[2] * n[2];
        float gudn = -2.0f * (gnd[0] * n[0] + gnd[1] * n[1] + gnd[2] * n[2]);
        for (int k = 0; k < 3; ++k) {
          gud[k] += gnd[k] + gudn * n[k];
          gn[k] += -2.0f * udn * gnd[k] + gudn * ud[k];
        }
      } else {
        // rp = ri (ud + cos_t n); k = 1 - |rp|^2; rp - sqrt(max(|k|, 1e-20)) n
        float rpv[3], kk = 1.0f;
        for (int j = 0; j < 3; ++j) rpv[j] = ri * (ud[j] + cos_t * n[j]);
        kk = 1.0f - (rpv[0] * rpv[0] + rpv[1] * rpv[1] + rpv[2] * rpv[2]);
        float q = sqrtf(fmaxf(fabsf(kk), 1e-20f));
        float gspar = gnd[0] * n[0] + gnd[1] * n[1] + gnd[2] * n[2];
        float gk = fabsf(kk) > 1e-20f ? gspar * (-0.5f / q) * sign_of(kk) : 0.0f;
        float grp[3], gri = 0.0f, gcos = 0.0f;
        for (int j = 0; j < 3; ++j) {
          gn[j] += -q * gnd[j];
          grp[j] = gnd[j] - 2.0f * gk * rpv[j];
          gri += grp[j] * (ud[j] + cos_t * n[j]);
          gud[j] += ri * grp[j];
          gcos += ri * grp[j] * n[j];
          gn[j] += ri * cos_t * grp[j];
        }
        // cos_t = min(-(ud.n), 1)
        float gc = 0.0f, gone = 0.0f;
        min_adj(cos_raw, 1.0f, gcos, gc, gone);
        for (int j = 0; j < 3; ++j) {
          gud[j] -= gc * n[j];
          gn[j] -= gc * ud[j];
        }
        // ri = front ? 1/ps : ps, ps = param where param > 0
        float gps = front ? -gri / (ps * ps) : gri;
        if (mparam > 0.0f) gparam += gps;
      }
      normalize_adj(a, 1.0f / dlen, ud[0], ud[1], ud[2], gud[0], gud[1], gud[2]);
      for (int k = 0; k < 3; ++k) gd[k] += gud[k];
    }
    // The isotropic phase function's direction has no gradient.
  }
  cot_add<F>(&D.mat[MPARAM * D.lmat + mi], gparam);

  // Textured albedo -> texture rows (through the noise factor).
  if (gtal[0] != 0.0f || gtal[1] != 0.0f || gtal[2] != 0.0f) {
    float gnf = 0.0f;
    for (int k = 0; k < 3; ++k) {
      cot_add<F>(&D.tex[(TALR + k) * D.ltex + ti], noisy ? gtal[k] * nfac : gtal[k]);
      gnf += gtal[k] * t_raw[k];
    }
    if (noisy) {
      for (int k = 0; k < 3; ++k) gp[k] += gnf * ndp[k];
      cot_add<F>(&D.tex[TSCALE * D.ltex + ti], gnf * ndscale);
    }
  }

  // Shading normal -> geometric normal -> hit point / center / radius, or
  // the quad's table normal.
  float gc[3] = {0.0f, 0.0f, 0.0f}, grad = 0.0f, gqn[3] = {0.0f, 0.0f, 0.0f};
  if (is_sph) {
    float pr = 0.0f;
    for (int k = 0; k < 3; ++k) {
      float gon = sgn * gn[k];
      gp[k] += gon / rad_safe;
      gc[k] -= gon / rad_safe;
      pr += gon * (p[k] - rp[k]);
    }
    if (r.aux != 0.0f) grad -= pr / (rad_safe * rad_safe);
  } else if ((F & kFQuad) && w.fam == 1) {
    for (int k = 0; k < 3; ++k) gqn[k] = sgn * gn[k];
  }

  // p = o + t d
  float gt = 0.0f;
  for (int k = 0; k < 3; ++k) {
    go[k] += gp[k];
    gd[k] += r.t * gp[k];
    gt += gp[k] * d[k];
  }
  resolve_adjoint<F>(T, c, D, key, bn, tm, w, ox, oy, oz, dx, dy, dz, a, inv_a, gt, gc, grad, gqn,
                  go, gd);
  A = Adj{go[0], go[1], go[2], gd[0], gd[1], gd[2], gtp[0], gtp[1], gtp[2]};
}

// Adjoint of camera_ray (path_common.cuh) for the cotangents of its ray:
// adds to dcam[0..17] (pixel00, pixel deltas, center, defocus disk).
__device__ void camera_adjoint(const float* cv, uint32_t key, float xx, float yy, float sg,
                               float sqrt_spp, const Adj& A, float* dcam) {
  float u0 = draw(key, 0x40000000u), u1 = draw(key, 0x40000001u),
        u2 = draw(key, 0x40000002u), u3 = draw(key, 0x40000003u);
  float k1 = floorf(sg / sqrt_spp);
  float s_i = sg - k1 * sqrt_spp;
  float s_j = k1 - floorf(k1 / sqrt_spp) * sqrt_spp;
  float recip = 1.0f / sqrt_spp;
  float ax = xx + ((s_i + u0) * recip - 0.5f);
  float ay = yy + ((s_j + u1) * recip - 0.5f);
  float pc[3], o[3] = {cv[9], cv[10], cv[11]}, dkx = 0.0f, dky = 0.0f;
  const bool disk = cv[18] > 0.0f;
  if (disk) {
    float rr = sqrtf(u2);
    float th = kTwoPi * u3;
    dkx = rr * cosf(th);
    dky = rr * sinf(th);
  }
  float dd[3], n2 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    pc[k] = cv[k] + ax * cv[3 + k] + ay * cv[6 + k];
    if (disk) o[k] = cv[9 + k] + dkx * cv[12 + k] + dky * cv[15 + k];
    dd[k] = pc[k] - o[k];
    n2 += dd[k] * dd[k];
  }
  float inv_len = 1.0f / sqrtf(fmaxf(n2, 1e-24f));
  float g[3] = {A.dx, A.dy, A.dz};
  normalize_adj(n2, inv_len, dd[0] * inv_len, dd[1] * inv_len, dd[2] * inv_len, g[0], g[1],
                g[2]);
  const float go[3] = {A.ox - g[0], A.oy - g[1], A.oz - g[2]};
  for (int k = 0; k < 3; ++k) {
    dcam[k] += g[k];
    dcam[3 + k] += ax * g[k];
    dcam[6 + k] += ay * g[k];
    dcam[9 + k] += go[k];
    if (disk) {
      dcam[12 + k] += dkx * go[k];
      dcam[15 + k] += dky * go[k];
    }
  }
}

// The backward of one pixel slot (the v4 kernel's linear slot `lane`): for
// each of the batch's samples, the pre-pass and the reverse pass. Adds the
// slot's cotangents to dcam[0..18], dbg[0..2] and the table rows D; returns
// the number of bounces it replayed. F: the scene features the instance
// holds. kPrepass (profiling builds only, as JAX's phase="prepass"): the
// pre-pass alone, its last carry and winner folded into dcam so that no
// store of it is dropped.
template <uint32_t F, bool kPrepass = false>
__device__ int grad_slot(const Tables& T, const Counts& c, const float* cv, const float* bg,
                          int seed, int lane, int max_depth, int checker_depth, bool has_noise,
                          const float* g, const Cot& D, float* dcam, float* dbg) {
  const float slot_f = (float)(lane + (int)cv[25]);
  const float width = cv[19];
  const float yy = floorf(slot_f / width);
  const float xx = slot_f - yy * width;
  if (!(slot_f < cv[20])) return 0;  // outside the image: alive 0, no gradient
  const uint32_t pid = (uint32_t)(int32_t)(yy * width + xx);
  const float s0 = cv[21], n_samples = cv[22], sqrt_spp = cv[23];

  Entry st[kGradMaxDepth];
  Winner ws[kGradMaxDepth];
  int replayed = 0;
  for (int si = 0; (float)si < n_samples; ++si) {
    const float sg = s0 + (float)si;
    const uint32_t key = sample_key(seed, pid, (int)sg);
    Path s;
    float tm;
    camera_ray(s, tm, cv, key, xx, yy, sg, sqrt_spp);
    s.rr = s.rg = s.rb = 0.0f;
    int nb = 0;
    while (s.alive > 0.0f) {  // bounce() ends every path by max_depth <= kGradMaxDepth
      st[nb] = Entry{s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.tpr, s.tpg, s.tpb};
      Winner w{-1, 0};
      bounce<Cfg<true, Sweep::kLane, F>>(s, T, c, bg, key, tm, max_depth, checker_depth,
                                         has_noise, &w);
      ws[nb++] = w;
    }
    if constexpr (kPrepass) {
      // Read the whole tape back, as the reverse pass does, so that no store
      // of it is dropped.
      for (int b = 0; b < nb; ++b) {
        const Entry& e = st[b];
        dcam[0] += e.ox + e.oy + e.oz + e.dx + e.dy + e.dz + e.tpr + e.tpg + e.tpb;
        dcam[1] += (float)(ws[b].fam * kGradMaxDepth + ws[b].idx);
      }
      replayed += nb;
      continue;
    }
    Adj A{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int b = nb - 1; b >= 0; --b) {
      bounce_adjoint<F>(T, c, bg, key, tm, (float)b, ws[b], st[b], g, A, D, dbg, checker_depth,
                        has_noise);
    }
    camera_adjoint(cv, key, xx, yy, sg, sqrt_spp, A, dcam);
    replayed += nb;
  }
  return replayed;
}

}  // namespace
