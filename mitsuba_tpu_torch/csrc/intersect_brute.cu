// Brute-force fused intersector for Hopper (sm_90a): closest hit with its
// interpolated shading record for the bounce rays, and any-hit occlusion
// for the shadow rays, in one pass over the triangle table.
//
// Replaces the TPU kernel mitsuba_tpu/ops/intersect_pallas.py:337
// (_shaded_any_kernel, launched by closest_hit_shaded_and_any :432). It
// computes what that kernel computes, not how: one thread per lane takes
// that lane's bounce ray and its shadow ray, so each triangle row is read
// once for two rays, as on the TPU. The (T, 29) table (layout in
// mitsuba_tpu_torch/ops/intersect.py) is staged into shared memory in
// chunks of kChunk rows; every thread of a block reads the same row at
// the same time, a broadcast without bank conflicts. Rays are read as the
// (N, 3) and (N,) tensors they are; the ragged end is bounds-checked.
//
// Semantics kept from the reference, lane for lane:
//   |det| > 1e-9, t > mint, t < maxt, and the strict t < t_best, so the
//   lowest index wins a tie; on a miss prim = -1, ids = -1 and both
//   normals (0, 0, 1); the normals are renormalised once at the end with
//   the 1e-20 floor; a lane with maxt = -1 never hits.
// The shading record is interpolated once, from the winning row, instead
// of for every candidate: the same formula on the same inputs, so the
// same value. Built with --fmad=false and IEEE division and square root,
// it rounds as the plain PyTorch version in ops/intersect.py does.
//
// What bounds it: at T = 32 and 1M lanes each lane moves about 33 floats
// (16 in, 17 out), ~140 MB per bounce, against ~2 x 32 x ~50 flops, ~3.4
// GFLOP: close to the card's balance point, so neither the 3.35 TB/s nor
// the fp32 rate is saturated by this simple layout. A warp-cooperative
// layout and the table in registers or constant memory are later work.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kCols = 29;        // table row: v0|e1|e2|n0|n1|n2|uv0|uv1|uv2|mid|eid|sid|pad2
constexpr int kThreads = 256;
constexpr int kChunk = 128;      // rows staged per pass: 128 * 29 * 4 B = 14.8 KB
constexpr float kDetEps = 1e-9f;

struct Outputs {
  float* t; float* u; float* v; int* prim; int* hit;
  float* gx; float* gy; float* gz;
  float* sx; float* sy; float* sz;
  float* uvx; float* uvy;
  int* mid; int* eid; int* sid; int* occ;
};

__global__ void __launch_bounds__(kThreads)
shaded_any_kernel(const float* __restrict__ table, int n_tris,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ mint,
                  const float* __restrict__ maxt,
                  const float* __restrict__ so, const float* __restrict__ sd,
                  const float* __restrict__ smint,
                  const float* __restrict__ smaxt, int n, Outputs out) {
  __shared__ float tab[kChunk * kCols];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float mn = 0.f, mx = -1.f;
  float sox = 0.f, soy = 0.f, soz = 0.f, sdx = 0.f, sdy = 0.f, sdz = 1.f;
  float smn = 0.f, smx = -1.f;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    mn = mint[i]; mx = maxt[i];
    sox = so[3 * i]; soy = so[3 * i + 1]; soz = so[3 * i + 2];
    sdx = sd[3 * i]; sdy = sd[3 * i + 1]; sdz = sd[3 * i + 2];
    smn = smint[i]; smx = smaxt[i];
  }

  const float ro[3] = {ox, oy, oz}, rd[3] = {dx, dy, dz};
  const float sro[3] = {sox, soy, soz}, srd[3] = {sdx, sdy, sdz};

  float t_b = __int_as_float(0x7f800000);  // +inf
  float u_b = 0.f, v_b = 0.f;
  int p_b = -1;
  bool occ = false;
  for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
    const int rows = min(kChunk, n_tris - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < rows * kCols; k += blockDim.x)
      tab[k] = table[c0 * kCols + k];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      const float* r = tab + j * kCols;
      float t, u, v;
      if (mt_test(r, ro, rd, mn, mx, kDetEps, t, u, v) && t < t_b) {
        t_b = t; u_b = u; v_b = v; p_b = c0 + j;
      }
      if (!occ) occ = mt_test(r, sro, srd, smn, smx, kDetEps, t, u, v);
    }
  }
  if (!live) return;

  float gx = 0.f, gy = 0.f, gz = 1.f, sx = 0.f, sy = 0.f, sz = 1.f;
  float tu = 0.f, tv = 0.f;
  int mid = -1, eid = -1, sid = -1;
  if (p_b >= 0) {
    const float* r = table + static_cast<size_t>(p_b) * kCols;
    const float e1x = r[3], e1y = r[4], e1z = r[5];
    const float e2x = r[6], e2y = r[7], e2z = r[8];
    gx = e1y * e2z - e1z * e2y;
    gy = e1z * e2x - e1x * e2z;
    gz = e1x * e2y - e1y * e2x;
    const float w = 1.0f - u_b - v_b;
    sx = w * r[9] + u_b * r[12] + v_b * r[15];
    sy = w * r[10] + u_b * r[13] + v_b * r[16];
    sz = w * r[11] + u_b * r[14] + v_b * r[17];
    tu = w * r[18] + u_b * r[20] + v_b * r[22];
    tv = w * r[19] + u_b * r[21] + v_b * r[23];
    mid = static_cast<int>(r[24]);
    eid = static_cast<int>(r[25]);
    sid = static_cast<int>(r[26]);
  }
  const float g_inv = 1.0f / sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-20f));
  const float s_inv = 1.0f / sqrtf(fmaxf(sx * sx + sy * sy + sz * sz, 1e-20f));

  out.t[i] = t_b; out.u[i] = u_b; out.v[i] = v_b;
  out.prim[i] = p_b; out.hit[i] = p_b >= 0 ? 1 : 0;
  out.gx[i] = gx * g_inv; out.gy[i] = gy * g_inv; out.gz[i] = gz * g_inv;
  out.sx[i] = sx * s_inv; out.sy[i] = sy * s_inv; out.sz[i] = sz * s_inv;
  out.uvx[i] = tu; out.uvy[i] = tv;
  out.mid[i] = mid; out.eid[i] = eid; out.sid[i] = sid;
  out.occ[i] = occ ? 1 : 0;
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and
// returns cudaGetLastError(), so a refused launch is reported.
extern "C" int mts_shaded_any(
    const float* table, int n_tris, const float* o, const float* d,
    const float* mint, const float* maxt, const float* so, const float* sd,
    const float* smint, const float* smaxt, int n, float* t, float* u,
    float* v, int* prim, int* hit, float* gx, float* gy, float* gz,
    float* sx, float* sy, float* sz, float* uvx, float* uvy, int* mid,
    int* eid, int* sid, int* occ, void* stream) {
  if (n > 0) {
    const Outputs out{t, u, v, prim, hit, gx, gy, gz, sx, sy, sz,
                      uvx, uvy, mid, eid, sid, occ};
    const int blocks = (n + kThreads - 1) / kThreads;
    shaded_any_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, o, d, mint, maxt, so, sd, smint, smaxt, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
