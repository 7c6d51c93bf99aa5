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
// the same operations.

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
