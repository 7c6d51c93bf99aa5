// The v1 streaming cluster intersector for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of mitsuba_tpu/ops/cluster_pallas.py:
//   cluster_kernel<closest>  <- :169 `_closest_kernel`
//   cluster_kernel<any>      <- :227 `_any_kernel`   (entry `_common_call`
//                               :284, pallas_call :305)
// Wrapped by mitsuba_tpu_torch/ops/cluster.py, whose `cluster_rows_ref` is
// the plain PyTorch version this kernel must agree with lane for lane.
//
// Layout: rays are (R, 8, 128) planes o.xyz | d.xyz | mint | maxt, in tiles
// of 8 rows; ids (R/8, C_s) and counts (R/8,) are each tile's front-to-back
// supercluster list; G (C_s, 8 * 512, 16) holds per cluster 4 x 128
// Pluecker rows A | B | C | D of 10 coefficients against the ray's
// [o | d | o x d | 1]; aabb (C_s, 8, 8) the cluster boxes; tri_start
// (C_s * 8,) the first triangle of each cluster.
//
// The TPU kernel ran a grid step per (tile, list slot) and tested each of
// the tile's 8 rows against the supercluster's 8 clusters: a slab
// pre-test of the row's lanes, then, if any lane passes, a (512, 10) x
// (10, 128) product on the matrix unit. Rows are independent once their
// tile's list is built, so here one 128-thread block walks one row, a
// thread per lane: per cluster the slab test (closest: capped at the
// lane's best t; any: at maxt) and a block-wide vote (__syncthreads_or);
// if any lane passes, the cluster's 512 rows (20 KB) are staged in shared
// memory and every lane computes its 512 dot products itself, each an
// ordered 10-term sum (the plain version sums in the same order), reading
// the rows as broadcasts. A product of rank 10 would leave a tensor core
// nearly idle, so the kernel stays on the float32 pipes. An any-hit row
// stops once all its lanes are occluded. Tie rules as the TPU kernel's:
// within a cluster the lowest k among equal t, across clusters strict <.
// Bound: the Pluecker work, ~90 flops per (triangle, lane) of a visited
// cluster.
//
// Rounding: compiled with --fmad=false and IEEE division; every
// expression keeps the plain version's operation order.

#include <cuda_runtime.h>

#define LANES 128
#define BM 8
#define SC_GROUP 8
#define CLUSTER_K 128
#define RPC (4 * CLUSTER_K)     // Pluecker rows per cluster
#define G_COLS 16
#define N_COEF 10
#define BIG 3e38f
#define DET_EPS 1e-12f
#define NO_K (1 << 30)

// the ordered 10-term sum g . m
__device__ __forceinline__ float dot10(const float* g, const float m[N_COEF]) {
  float s = g[0] * m[0];
#pragma unroll
  for (int j = 1; j < N_COEF; ++j) s = s + g[j] * m[j];
  return s;
}

// the Pluecker test of triangle k of the staged cluster: t, 1/det signed,
// P1, P2; returns eligibility (cluster_pallas.py:153-166)
__device__ __forceinline__ bool plucker(const float* sg, int k,
                                        const float m[N_COEF], float& t,
                                        float& rcps, float& p1, float& p2) {
  const float p0 = dot10(sg + (0 * CLUSTER_K + k) * N_COEF, m);
  p1 = dot10(sg + (1 * CLUSTER_K + k) * N_COEF, m);
  p2 = dot10(sg + (2 * CLUSTER_K + k) * N_COEF, m);
  const float qn = dot10(sg + (3 * CLUSTER_K + k) * N_COEF, m);
  const float det = p0 + p1 + p2;
  const float smin = fminf(fminf(p0, p1), p2);
  const float smax = fmaxf(fmaxf(p0, p1), p2);
  const bool pos = smin >= 0.0f;
  const float sgn = pos ? 1.0f : -1.0f;
  const float absdet = det * sgn;
  const bool elig = (pos || smax <= 0.0f) && absdet > DET_EPS;
  const float rcp = 1.0f / (elig ? absdet : 1.0f);
  t = qn * sgn * rcp;
  rcps = sgn * rcp;
  return elig;
}

__global__ void __launch_bounds__(LANES)
cluster_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
               const int* __restrict__ counts, const float* __restrict__ G,
               const float* __restrict__ aabb,
               const int* __restrict__ tri_start, int C_s, int any_hit,
               float* __restrict__ out_t, float* __restrict__ out_u,
               float* __restrict__ out_v, int* __restrict__ out_p,
               int* __restrict__ out_occ) {
  __shared__ float sg[RPC * N_COEF];        // 20,480 bytes
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int tile = r / BM;
  const float* p = rays + (size_t)r * 8 * LANES + l;
  float o[3], d[3], inv[3];
  for (int j = 0; j < 3; ++j) {
    o[j] = p[j * LANES];
    d[j] = p[(3 + j) * LANES];
    inv[j] = (d[j] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d[j]), 1e-12f);
  }
  const float mn = p[6 * LANES];
  const float mx = p[7 * LANES];
  const float m[N_COEF] = {o[0], o[1], o[2], d[0], d[1], d[2],
                           o[1] * d[2] - o[2] * d[1],
                           o[2] * d[0] - o[0] * d[2],
                           o[0] * d[1] - o[1] * d[0], 1.0f};
  float tb = mx, ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  const int cnt = counts[tile];
  for (int li = 0; li < cnt; ++li) {
    if (any_hit && !__syncthreads_or(!occ)) break;   // the row is done
    const int sc = ids[(size_t)tile * C_s + li];
    for (int c = 0; c < SC_GROUP; ++c) {
      const float* bx = aabb + ((size_t)sc * SC_GROUP + c) * 8;
      float tn = mn, tf = any_hit ? mx : tb;
      for (int j = 0; j < 3; ++j) {
        const float t0 = (bx[j] - o[j]) * inv[j];
        const float t1 = (bx[3 + j] - o[j]) * inv[j];
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
      }
      if (!__syncthreads_or(tn <= tf)) continue;
      const float* src = G + ((size_t)sc * SC_GROUP + c) * RPC * G_COLS;
      for (int i = l; i < RPC * N_COEF; i += LANES)
        sg[i] = src[(i / N_COEF) * G_COLS + i % N_COEF];
      __syncthreads();
      if (any_hit) {
        for (int k = 0; k < CLUSTER_K && !occ; ++k) {
          float t, rcps, p1, p2;
          occ = plucker(sg, k, m, t, rcps, p1, p2) && t > mn && t < mx;
        }
      } else {
        float bt = BIG, bu = 0.0f, bv = 0.0f;
        int bk = NO_K;
        for (int k = 0; k < CLUSTER_K; ++k) {
          float t, rcps, p1, p2;
          if (plucker(sg, k, m, t, rcps, p1, p2) && t > mn && t < tb &&
              t < bt) {
            bt = t;
            bk = k;
            bu = p1 * rcps;
            bv = p2 * rcps;
          }
        }
        if (bt < tb) {
          tb = bt;
          ub = bu;
          vb = bv;
          pb = tri_start[sc * SC_GROUP + c] + bk;
        }
      }
      __syncthreads();                       // before the next staging
    }
  }
  const size_t at = (size_t)r * LANES + l;
  if (any_hit) {
    out_occ[at] = occ ? 1 : 0;
  } else {
    out_t[at] = tb;
    out_u[at] = ub;
    out_v[at] = vb;
    out_p[at] = pb;
  }
}

extern "C" int mts_cluster(const float* rays, const int* ids,
                           const int* counts, const float* G,
                           const float* aabb, const int* tri_start, int R,
                           int C_s, int any_hit, float* out_t, float* out_u,
                           float* out_v, int* out_p, int* out_occ,
                           void* stream) {
  if (R <= 0) return 0;
  if (R % BM) return (int)cudaErrorInvalidValue;
  cluster_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(
      rays, ids, counts, G, aabb, tri_start, C_s, any_hit, out_t, out_u,
      out_v, out_p, out_occ);
  return (int)cudaGetLastError();
}
