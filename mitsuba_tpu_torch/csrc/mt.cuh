// Moeller-Trumbore ray-triangle test, shared by the port's kernels.
//
// f holds one triangle's nine floats v0 | e1 | e2. Every kernel and every
// plain PyTorch version (ops/stream.py `mt`) evaluates it in this order:
// p = d x e2, det = e1 . p, s = o - v0, q = s x e1, then u = s . p,
// v = d . q and t = e2 . q, each times one IEEE reciprocal of det (the
// sources build with --fmad=false). A triangle with |det| <= det_eps never
// hits, and its t, u and v are then meaningless. det_eps is the one of the
// TPU kernel each kernel replaces: 1e-9 for the brute and BVH kernels,
// 1e-12 for the cluster kernels; it is a constant at every call, so the
// compiler folds it. `mt_test4` takes the nine floats as the leading
// fields of three float4s (three 16-byte shared-memory loads) and runs
// the same operations; `mt_rec` loads them so from a 16-byte aligned
// record. `mt_cluster` runs one cluster's triangles in the tie order of
// the TPU's cluster kernels (the stream and work-list walks).

#pragma once

__device__ __forceinline__ bool mt_test(const float* f, const float o[3],
                                        const float d[3], float mn, float cap,
                                        float det_eps, float& t, float& u,
                                        float& v) {
  const float px = d[1] * f[8] - d[2] * f[7];
  const float py = d[2] * f[6] - d[0] * f[8];
  const float pz = d[0] * f[7] - d[1] * f[6];
  const float det = f[3] * px + f[4] * py + f[5] * pz;
  const float sx = o[0] - f[0];
  const float sy = o[1] - f[1];
  const float sz = o[2] - f[2];
  const float qx = sy * f[5] - sz * f[4];
  const float qy = sz * f[3] - sx * f[5];
  const float qz = sx * f[4] - sy * f[3];
  const bool det_ok = fabsf(det) > det_eps;
  const float inv = 1.0f / (det_ok ? det : 1.0f);
  u = (sx * px + sy * py + sz * pz) * inv;
  v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv;
  t = (f[6] * qx + f[7] * qy + f[8] * qz) * inv;
  return det_ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > mn) && (t < cap);
}

__device__ __forceinline__ bool mt_test4(float4 a, float4 b, float4 c,
                                         const float o[3], const float d[3],
                                         float mn, float cap, float det_eps,
                                         float& t, float& u, float& v) {
  const float f[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
  return mt_test(f, o, d, mn, cap, det_eps, t, u, v);
}

__device__ __forceinline__ bool mt_rec(const float* f, const float o[3],
                                       const float d[3], float mn, float cap,
                                       float det_eps, float& t, float& u,
                                       float& v) {
  const float4* q = reinterpret_cast<const float4*>(f);
  return mt_test4(q[0], q[1], q[2], o, d, mn, cap, det_eps, t, u, v);
}

// the running minimum of one chunk parity of a sublane (strict <)
struct MtRun {
  float t, u, v;
  int j;
};

__device__ __forceinline__ void mt_run_take(bool ok, float t, float u,
                                            float v, int j, MtRun& r) {
  if (ok && t < r.t) r = {t, u, v, j};
}

// Moeller-Trumbore of one cluster of K triangles (K a multiple of 8;
// triangle k at cl + k * stride floats) under cap, in the tie order of
// the TPU's cluster kernels (stream_pallas.py:137-148,
// worklist_pallas.py:273-314): triangle k is chunk j = k / 8 of sublane
// s = k % 8; per sublane the even and odd chunks keep separate running
// minima (strict <), the odd one winning only when strictly nearer;
// across sublanes the lowest candidate j * 8 + s wins among equal t.
// Returns (t, u, v, candidate); t = 3e38 and candidate 0 where nothing
// passed. Two tests run at a time, an even and an odd chunk.
__device__ __forceinline__ void mt_cluster(const float* cl, int stride,
                                           int K, const float o[3],
                                           const float d[3], float mn,
                                           float cap, float det_eps,
                                           float& bt, float& bu, float& bv,
                                           int& bp) {
  const float big = 3e38f;
  bt = big;
  bu = bv = 0.0f;
  bp = 1 << 30;
  const int nj = K / 8;
  for (int s = 0; s < 8; ++s) {
    MtRun r0 = {big, 0.0f, 0.0f, 0}, r1 = {big, 0.0f, 0.0f, 0};
    for (int j = 0; j < nj; j += 2) {
      float t0, u0, v0, t1 = big, u1, v1;
      const bool ok0 = mt_rec(cl + (j * 8 + s) * stride, o, d, mn, cap,
                              det_eps, t0, u0, v0);
      const bool ok1 = j + 1 < nj &&
          mt_rec(cl + ((j + 1) * 8 + s) * stride, o, d, mn, cap, det_eps,
                 t1, u1, v1);
      mt_run_take(ok0, t0, u0, v0, j, r0);
      mt_run_take(ok1, t1, u1, v1, j + 1, r1);
    }
    if (r1.t < r0.t) r0 = r1;
    const int pc = r0.j * 8 + s;
    if (r0.t < bt || (r0.t == bt && pc < bp)) {
      bt = r0.t;
      bp = pc;
      bu = r0.u;
      bv = r0.v;
    }
  }
}
