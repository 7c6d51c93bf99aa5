// Exact-cull intersector (work-list v5) for NVIDIA Hopper (sm_90a):
// the three kernels of its path.
//
// Replaces the TPU kernels of mitsuba_tpu/ops/exact_pallas.py:
//   refine_kernel        <- :114 `_refine_kernel`   (entry :163, call :187)
//   child_refine_kernel  <- :209 `_child_refine_kernel` (:246, call :269)
//   items_kernel         <- :531 `_make_item_kernel`    (:628, call :652)
// Wrapped by mitsuba_tpu_torch/ops/exact.py, whose `refine_ref`,
// `child_refine_ref` and `items_ref` are the plain PyTorch versions these
// kernels must agree with lane for lane.
//
// Layout: rays are (R, 8, 128) planes o.xyz | d.xyz | mint | maxt; one
// thread block of 128 threads per ray row.
//
// refine / child_refine compute, for each listed box of a row, the
// smallest slab entry distance over the row's 128 lanes (BIG where no lane
// hits). The TPU kernel vectorised over lanes and reduced across them;
// here each thread owns whole entries and loops over the row's 128 lanes,
// read from shared memory as broadcasts, so the row-wide minimum needs no
// reduction at all (a minimum is exact in any order). Only the live
// prefix of each row's list is computed; the rest reads BIG and the
// wrapper masks it. What bounds them: ~15 flops per (entry, lane) pair,
// no FMA; up to 3,072 entries x 128 lanes per row at the S3 stage.
//
// items walks each row's front-to-back list of 8-triangle clusters in
// blocks of 16 (BI): a block whose key exceeds every lane's best t (a
// block-wide max) is skipped; otherwise its 16 x 8 triangles are staged in
// shared memory (one per thread) and every lane runs Moeller-Trumbore on
// all of them. Tie order is the TPU kernel's (exact_pallas.py:600-619): a
// running winner per sublane across the block's items (strict <), then
// the lowest sublane among equal t, then across blocks strict <. The
// any-hit mode collapses a lane's bound to mint - 1 once it is occluded,
// so the block skip prunes occluded rows (:561-587). Bound: the staged
// loads and one block reduction per block of 16 clusters; the MT work is
// ~40 flops per (triangle, lane).
//
// Rounding: compiled with --fmad=false and IEEE division; every
// expression keeps the plain version's operation order.

#include <cuda_runtime.h>

#include "mt.cuh"

#define LANES 128
#define BI 16
#define BIG 3e38f
#define DET_EPS 1e-12f

struct Row {
  float o[3], d[3], inv[3], mn, mx;
};

__device__ __forceinline__ void load_row(const float* rays, Row& ry) {
  const float* p = rays + (size_t)blockIdx.x * 8 * LANES + threadIdx.x;
  for (int j = 0; j < 3; ++j) {
    ry.o[j] = p[j * LANES];
    ry.d[j] = p[(3 + j) * LANES];
    ry.inv[j] = fabsf(ry.d[j]) > 1e-12f ? 1.0f / ry.d[j] : BIG;
  }
  ry.mn = p[6 * LANES];
  ry.mx = p[7 * LANES];
}

// the row's rays in shared memory, planes o.xyz | inv.xyz | mint | maxt
__device__ __forceinline__ void stage_row(const Row& ry, float* s) {
  const int l = threadIdx.x;
  for (int j = 0; j < 3; ++j) {
    s[j * LANES + l] = ry.o[j];
    s[(3 + j) * LANES + l] = ry.inv[j];
  }
  s[6 * LANES + l] = ry.mn;
  s[7 * LANES + l] = ry.mx;
}

// min over the row's lanes of the slab entry distance of box lo/hi
__device__ __forceinline__ float box_key(const float* s, const float lo[3],
                                         const float hi[3]) {
  float key = BIG;
  for (int l = 0; l < LANES; ++l) {
    float tn = s[6 * LANES + l];
    float tf = s[7 * LANES + l];
    for (int j = 0; j < 3; ++j) {
      const float o = s[j * LANES + l];
      const float inv = s[(3 + j) * LANES + l];
      float t0 = (lo[j] - o) * inv;
      float t1 = (hi[j] - o) * inv;
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    key = fminf(key, tn <= tf ? tn : BIG);
  }
  return key;
}

__global__ void __launch_bounds__(LANES)
refine_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
              const int* __restrict__ live, const float* __restrict__ blo,
              const float* __restrict__ bhi, int E, float* __restrict__ out) {
  __shared__ float s[8 * LANES];
  Row ry;
  load_row(rays, ry);
  stage_row(ry, s);
  __syncthreads();
  const int r = blockIdx.x;
  const int n = live[r];
  for (int e = threadIdx.x; e < E; e += LANES) {
    float key = BIG;
    if (e < n) {
      const int b = ids[(size_t)r * E + e];
      const float lo[3] = {blo[3 * b], blo[3 * b + 1], blo[3 * b + 2]};
      const float hi[3] = {bhi[3 * b], bhi[3 * b + 1], bhi[3 * b + 2]};
      key = box_key(s, lo, hi);
    }
    out[(size_t)r * E + e] = key;
  }
}

__global__ void __launch_bounds__(LANES)
child_refine_kernel(const float* __restrict__ rays,
                    const int* __restrict__ pids,
                    const int* __restrict__ live_p,
                    const float* __restrict__ tab, int Ep,
                    float* __restrict__ out) {
  __shared__ float s[8 * LANES];
  Row ry;
  load_row(rays, ry);
  stage_row(ry, s);
  __syncthreads();
  const int r = blockIdx.x;
  const int n = live_p[r] * 8;
  for (int e = threadIdx.x; e < Ep * 8; e += LANES) {
    float key = BIG;
    if (e < n) {
      const int p = pids[(size_t)r * Ep + e / 8];
      const float* b = tab + ((size_t)p * 8 + e % 8) * LANES;
      const float lo[3] = {b[0], b[1], b[2]};
      const float hi[3] = {b[3], b[4], b[5]};
      key = box_key(s, lo, hi);
    }
    out[(size_t)r * Ep * 8 + e] = key;
  }
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  return m;
}

// one staged triangle: v0 | e1 | e2 | prim
struct Tri {
  float f[9];
  int prim;
};

__global__ void __launch_bounds__(LANES)
items_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
             const float* __restrict__ blk_tn,
             const float* __restrict__ tri, int E3, int any_hit,
             float* __restrict__ out_t, float* __restrict__ out_u,
             float* __restrict__ out_v, int* __restrict__ out_p,
             int* __restrict__ out_occ) {
  __shared__ Tri st[BI * 8];
  __shared__ float red[LANES / 32];
  Row ry;
  load_row(rays, ry);
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int nb = E3 / BI;
  float tb = ry.mx, ub = 0.0f, vb = 0.0f;    // closest: best hit
  int pb = -1;
  bool occ = false;
  float t_bound = ry.mx;                    // any-hit: the skip bound
  for (int b = 0; b < nb; ++b) {
    const float blk_t = blk_tn[(size_t)r * nb + b];
    if (!(blk_t <= block_max(any_hit ? t_bound : tb, red))) continue;
    {   // stage the block's 16 clusters x 8 triangles, one per thread
      const int item = l / 8, sub = l % 8;
      const int cid = ids[(size_t)r * E3 + b * BI + item];
      const float* src = tri + ((size_t)cid * 8 + sub) * LANES;
      for (int k = 0; k < 9; ++k) st[l].f[k] = src[k];
      st[l].prim = __float_as_int(src[15]);
    }
    __syncthreads();
    if (any_hit) {
      const float cap = occ ? ry.mn : ry.mx;
      bool hit = false;
      for (int k = 0; k < BI * 8; ++k) {
        float t, u, v;
        hit = mt_test(st[k].f, ry.o, ry.d, ry.mn, cap, DET_EPS, t, u, v) ||
              hit;
      }
      occ = occ || hit;
      t_bound = occ ? ry.mn - 1.0f : ry.mx;
    } else {
      // lexicographic (t, sublane, item) minimum == per-sublane running
      // winner over the items, then the lowest sublane among equal t
      float bt = BIG, bu = 0.0f, bv = 0.0f;
      int bs = 8, bp = 0;
      for (int item = 0; item < BI; ++item) {
        for (int sub = 0; sub < 8; ++sub) {
          float t, u, v;
          const Tri& tr = st[item * 8 + sub];
          if (mt_test(tr.f, ry.o, ry.d, ry.mn, tb, DET_EPS, t, u, v) &&
              (t < bt || (t == bt && sub < bs))) {
            bt = t;
            bs = sub;
            bu = u;
            bv = v;
            bp = tr.prim;
          }
        }
      }
      if (bt < tb) {
        tb = bt;
        ub = bu;
        vb = bv;
        pb = bp;
      }
    }
    __syncthreads();                         // before the next staging
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

extern "C" int mts_refine(const float* rays, const int* ids, const int* live,
                          const float* blo, const float* bhi, int R, int E,
                          float* out, void* stream) {
  if (R <= 0 || E <= 0) return 0;
  refine_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(rays, ids, live, blo,
                                                       bhi, E, out);
  return (int)cudaGetLastError();
}

extern "C" int mts_child_refine(const float* rays, const int* pids,
                                const int* live_p, const float* tab, int R,
                                int Ep, float* out, void* stream) {
  if (R <= 0 || Ep <= 0) return 0;
  child_refine_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(
      rays, pids, live_p, tab, Ep, out);
  return (int)cudaGetLastError();
}

extern "C" int mts_items(const float* rays, const int* ids,
                         const float* blk_tn, const float* tri, int R,
                         int E3, int any_hit, float* out_t, float* out_u,
                         float* out_v, int* out_p, int* out_occ,
                         void* stream) {
  if (R <= 0) return 0;
  items_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(
      rays, ids, blk_tn, tri, E3, any_hit, out_t, out_u, out_v, out_p,
      out_occ);
  return (int)cudaGetLastError();
}
