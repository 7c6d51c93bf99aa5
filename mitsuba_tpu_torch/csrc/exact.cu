// Exact-cull intersector for NVIDIA Hopper (sm_90a): the five kernels of
// its cull and of its three item walks (v5, v6, v6b).
//
// Replaces the TPU kernels of mitsuba_tpu/ops/exact_pallas.py:
//   refine_kernel        <- :114 `_refine_kernel`   (entry :163, call :187)
//   child_refine_kernel  <- :209 `_child_refine_kernel` (:246, call :269)
//   items_kernel         <- :531 `_make_item_kernel`    (:628, call :652)
//   l1_items_kernel      <- :666 `_make_l1_kernel`      (:776, call :803)
//   l1_masked_kernel     <- :814 `_make_l1_masked_kernel` (:910, call :940)
// Wrapped by mitsuba_tpu_torch/ops/exact.py, whose `refine_ref`,
// `child_refine_ref`, `items_ref`, `l1_items_ref` and `l1_masked_ref` are
// the plain PyTorch versions these kernels must agree with lane for lane.
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
// l1_items (v6) and l1_masked (v6b) walk each row's front-to-back list of
// E2 L1 blocks (64 triangles: 8 consecutive K8 clusters of `tri`) without
// the S3 stage. A "max over lanes >= key" skip is __syncthreads_or(key <=
// my bound). v6 visits the L1s one by one: it stages the L1's 64
// triangles, slab-tests its 8 K8 children (the `ct0` table) per lane
// against [mint, maxt], and runs Moeller-Trumbore on all 128 lanes for
// each child some lane admits (a second __syncthreads_or), merging child
// by child (lowest sublane among the child's nearest hits, then strict <
// against the lane's best; any-hit caps each child at mint once
// occluded). v6b takes steps of blm L1s with one skip on the step's
// first key and tests all blm * 64 triangles of the step, dead slots
// (L1 id 0) included, in chunks of 128 staged in shared memory, capped by
// the bound of the step's start; it keeps #7's running winner per sublane
// across the whole step, then the lowest sublane, then strict < against
// the lane's best (exact_pallas.py:877-901). Bound: the MT work, ~40
// flops per (triangle, lane), of v6b's L1-granular tests; v6 trades a box
// test per child and lane and a block-wide vote for skipping children.
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

// the best-hit accumulator of the closest walks: (t, u, v, prim)
struct Best {
  float t, u, v;
  int p;
};

__device__ __forceinline__ void store_hit(const Best& b, bool occ, int any_hit,
                                          float* out_t, float* out_u,
                                          float* out_v, int* out_p,
                                          int* out_occ) {
  const size_t at = (size_t)blockIdx.x * LANES + threadIdx.x;
  if (any_hit) {
    out_occ[at] = occ ? 1 : 0;
  } else {
    out_t[at] = b.t;
    out_u[at] = b.u;
    out_v[at] = b.v;
    out_p[at] = b.p;
  }
}

__device__ __forceinline__ void stage_tri(const float* src, Tri& dst) {
  for (int k = 0; k < 9; ++k) dst.f[k] = src[k];
  dst.prim = __float_as_int(src[15]);
}

__global__ void __launch_bounds__(LANES)
l1_items_kernel(const float* __restrict__ rays, const int* __restrict__ l1_ids,
                const float* __restrict__ l1_keys,
                const float* __restrict__ tri, const float* __restrict__ ct0,
                int E2, int any_hit, float* __restrict__ out_t,
                float* __restrict__ out_u, float* __restrict__ out_v,
                int* __restrict__ out_p, int* __restrict__ out_occ) {
  __shared__ Tri st[64];
  Row ry;
  load_row(rays, ry);
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  Best best = {ry.mx, 0.0f, 0.0f, -1};
  bool occ = false;
  float t_bound = ry.mx;                    // any-hit: the skip bound
  for (int s = 0; s < E2; ++s) {
    const float key = l1_keys[(size_t)r * E2 + s];
    if (!__syncthreads_or(key <= (any_hit ? t_bound : best.t))) continue;
    const int id = l1_ids[(size_t)r * E2 + s];
    if (l < 64) stage_tri(tri + ((size_t)id * 64 + l) * LANES, st[l]);
    __syncthreads();
    for (int c = 0; c < 8; ++c) {
      // this lane's slab test of child c against [mint, maxt]
      const float* b = ct0 + ((size_t)id * 8 + c) * LANES;
      float tn = ry.mn, tf = ry.mx;
      for (int j = 0; j < 3; ++j) {
        const float t0 = (b[j] - ry.o[j]) * ry.inv[j];
        const float t1 = (b[3 + j] - ry.o[j]) * ry.inv[j];
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
      }
      if (!__syncthreads_or(tn <= tf)) continue;
      const Tri* ct = st + c * 8;
      if (any_hit) {
        const float cap = occ ? ry.mn : ry.mx;
        bool hit = false;
        for (int k = 0; k < 8; ++k) {
          float t, u, v;
          hit = mt_test(ct[k].f, ry.o, ry.d, ry.mn, cap, DET_EPS, t, u, v) ||
                hit;
        }
        occ = occ || hit;
        t_bound = occ ? ry.mn - 1.0f : ry.mx;
      } else {
        Best h = {BIG, 0.0f, 0.0f, 0};
        for (int k = 0; k < 8; ++k) {
          float t, u, v;
          if (mt_test(ct[k].f, ry.o, ry.d, ry.mn, best.t, DET_EPS, t, u, v) &&
              t < h.t)
            h = {t, u, v, ct[k].prim};
        }
        if (h.t < best.t) best = h;
      }
    }
    __syncthreads();                         // before the next staging
  }
  store_hit(best, occ, any_hit, out_t, out_u, out_v, out_p, out_occ);
}

__global__ void __launch_bounds__(LANES)
l1_masked_kernel(const float* __restrict__ rays,
                 const int* __restrict__ l1_ids,
                 const float* __restrict__ l1_keys,
                 const float* __restrict__ tri, int E2, int blm, int any_hit,
                 float* __restrict__ out_t, float* __restrict__ out_u,
                 float* __restrict__ out_v, int* __restrict__ out_p,
                 int* __restrict__ out_occ) {
  __shared__ Tri st[LANES];
  Row ry;
  load_row(rays, ry);
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int n_tri = blm * 64;               // triangles per step
  Best best = {ry.mx, 0.0f, 0.0f, -1};
  bool occ = false;
  float t_bound = ry.mx;                    // any-hit: the skip bound
  for (int s = 0; s < E2; s += blm) {
    const int* ids = l1_ids + (size_t)r * E2 + s;
    const float key = l1_keys[(size_t)r * E2 + s];
    if (!__syncthreads_or(key <= (any_hit ? t_bound : best.t))) continue;
    // the step's cap and running winner: lexicographic (t, sublane,
    // cluster) minimum == per-sublane running winner over the clusters
    // (strict <), then the lowest sublane among equal t
    const float cap = any_hit ? (occ ? ry.mn : ry.mx) : best.t;
    Best h = {BIG, 0.0f, 0.0f, 0};
    int hs = 8;
    bool hit = false;
    for (int c0 = 0; c0 < n_tri; c0 += LANES) {
      const int m = c0 + l;                  // (L1, cluster, sublane)
      if (m < n_tri)
        stage_tri(tri + ((size_t)ids[m / 64] * 64 + m % 64) * LANES, st[l]);
      __syncthreads();
      const int nk = min(LANES, n_tri - c0);
      for (int k = 0; k < nk; ++k) {
        float t, u, v;
        if (any_hit) {
          hit = hit ||
                mt_test(st[k].f, ry.o, ry.d, ry.mn, cap, DET_EPS, t, u, v);
        } else if (mt_test(st[k].f, ry.o, ry.d, ry.mn, cap, DET_EPS, t, u,
                           v) &&
                   (t < h.t || (t == h.t && (k % 8) < hs))) {
          h = {t, u, v, st[k].prim};
          hs = k % 8;
        }
      }
      __syncthreads();                       // before the next staging
    }
    if (any_hit) {
      occ = occ || hit;
      t_bound = occ ? ry.mn - 1.0f : ry.mx;
    } else if (h.t < best.t) {
      best = h;
    }
  }
  store_hit(best, occ, any_hit, out_t, out_u, out_v, out_p, out_occ);
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

extern "C" int mts_l1_items(const float* rays, const int* l1_ids,
                            const float* l1_keys, const float* tri,
                            const float* ct0, int R, int E2, int any_hit,
                            float* out_t, float* out_u, float* out_v,
                            int* out_p, int* out_occ, void* stream) {
  if (R <= 0) return 0;
  l1_items_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(
      rays, l1_ids, l1_keys, tri, ct0, E2, any_hit, out_t, out_u, out_v,
      out_p, out_occ);
  return (int)cudaGetLastError();
}

extern "C" int mts_l1_masked(const float* rays, const int* l1_ids,
                             const float* l1_keys, const float* tri, int R,
                             int E2, int blm, int any_hit, float* out_t,
                             float* out_u, float* out_v, int* out_p,
                             int* out_occ, void* stream) {
  if (R <= 0) return 0;
  if (blm <= 0 || E2 % blm) return (int)cudaErrorInvalidValue;
  l1_masked_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(
      rays, l1_ids, l1_keys, tri, E2, blm, any_hit, out_t, out_u, out_v,
      out_p, out_occ);
  return (int)cudaGetLastError();
}
