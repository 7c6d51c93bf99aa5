// Work-list cluster intersector, closest and any hit, flat and instanced,
// and its fixed-cost probe, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels mitsuba_tpu/ops/worklist_pallas.py:364
// `_make_closest_kernel`, :458 `_make_any_kernel` and :424
// `_make_probe_kernel` (entry `_call_chunk` :548, pallas_call at :570, via
// `wl_closest` :594, `wl_any` :619 and `wl_probe` :448). Wrapped by
// mitsuba_tpu_torch/ops/worklist.py, whose `wl_rows_ref` and
// `wl_probe_ref` are the plain PyTorch versions these kernels must agree
// with lane for lane.
//
// One thread block of 128 threads per 128-lane ray row, one thread per
// lane. The TPU kernel runs one grid step per work item and keeps the
// row's output block resident while consecutive items share it; here the
// block walks its row's contiguous run of items (seg[r]..seg[r + 1]) in
// list order, front to back, and keeps the running best in registers.
// Per valid item it stages the item's (K, 16) cluster block (2 KB at
// K = 32) in shared memory; in instanced mode the block is the shared
// object-space block block_id[cid] and each lane's ray is first moved
// into object space by the item's world->object 3x4 map (t carries over
// unchanged). Closest hit: a per-lane slab test of the block's AABB (row
// 0, columns 9:15) against the lane's best t decides, by a block-wide OR,
// whether the item is tested at all; then Moeller-Trumbore over the K
// triangles. Any hit tests every valid item until every lane of the row
// is occluded.
//
// Every row's outputs are initialised (t = maxt, prim = -1; not
// occluded), also a row the list never reached because its items did not
// fit: such a row is flagged as overflowing and its caller re-resolves it.
//
// What bounds it: the item walk is sequential within a row, so the
// latency of each staged block load and of the block-wide votes; the
// 2 KB block is read by all 128 threads from shared memory (broadcast
// reads). Rows are independent; a 1,048,576-lane wavefront gives 8,192
// blocks.
//
// Rounding: compiled with --fmad=false and IEEE division; every
// expression has the plain version's operation order. Tie order is the
// TPU kernel's (worklist_pallas.py:273-314, 403-409): within a sublane
// the even and odd chunks keep separate running minima (strict <) and
// the odd one wins only when strictly nearer; across sublanes the lowest
// k_run * 8 + sublane wins among equal t; across items a strict
// t < best t. |det| > 1e-12.

#include <cuda_runtime.h>

#include "mt.cuh"

#define LANES 128
#define FIELDS 16
#define BIG 3e38f
#define DET_EPS 1e-12f
#define PSEL_NONE (1 << 30)
#define CID_BITS 14
#define FIRST_BIT (1 << CID_BITS)
#define VALID_BIT (1 << (CID_BITS + 1))
#define MAX_K 128

__global__ void __launch_bounds__(LANES)
worklist_kernel(const int* __restrict__ items, const int* __restrict__ seg,
                const float* __restrict__ tri,
                const int* __restrict__ tri_start,
                const int* __restrict__ block_id,
                const float* __restrict__ xform,
                const float* __restrict__ rays, int K, int any_hit,
                float* __restrict__ out_t, float* __restrict__ out_u,
                float* __restrict__ out_v, int* __restrict__ out_p,
                int* __restrict__ out_occ) {
  __shared__ float blk[MAX_K * FIELDS];
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const float* ry = rays + (size_t)r * 8 * LANES;
  float ow[3], dw[3];
  for (int j = 0; j < 3; ++j) {
    ow[j] = ry[j * LANES + l];
    dw[j] = ry[(3 + j) * LANES + l];
  }
  const float mnb = ry[6 * LANES + l];
  const float mx = ry[7 * LANES + l];

  float tb = mx, ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  const int w_end = seg[r + 1];
  for (int w = seg[r]; w < w_end; ++w) {
    const int item = items[w];
    if (!(item & VALID_BIT)) continue;          // uniform across the block
    if (any_hit && __syncthreads_and(occ)) break;
    const int cid = item & (FIRST_BIT - 1);
    const int b = block_id ? block_id[cid] : cid;
    const float* src = tri + (size_t)b * K * FIELDS;
    for (int i = l; i < K * FIELDS; i += LANES) blk[i] = src[i];
    float o[3], d[3];
    if (xform) {
      const float* m = xform + (size_t)cid * 16;
      for (int j = 0; j < 3; ++j) {
        o[j] = m[4 * j] * ow[0] + m[4 * j + 1] * ow[1] +
               m[4 * j + 2] * ow[2] + m[4 * j + 3];
        d[j] = m[4 * j] * dw[0] + m[4 * j + 1] * dw[1] +
               m[4 * j + 2] * dw[2];
      }
    } else {
      for (int j = 0; j < 3; ++j) {
        o[j] = ow[j];
        d[j] = dw[j];
      }
    }
    __syncthreads();
    if (any_hit) {
      bool hit = false;
      for (int k = 0; k < K && !hit; ++k) {
        float t, u, v;
        hit = mt_test(blk + k * FIELDS, o, d, mnb, mx, DET_EPS, t, u, v);
      }
      occ = occ || hit;
    } else {
      float tn = mnb, tf = tb;
      for (int j = 0; j < 3; ++j) {
        const float inv =
            (d[j] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d[j]), 1e-12f);
        const float t0 = (blk[9 + j] - o[j]) * inv;
        const float t1 = (blk[12 + j] - o[j]) * inv;
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
      }
      if (__syncthreads_or(tn <= tf)) {
        float bt = BIG, bu = 0.0f, bv = 0.0f;
        int bp = PSEL_NONE;
        for (int s = 0; s < 8; ++s) {
          float tg[2] = {BIG, BIG}, ug[2] = {0.0f, 0.0f};
          float vg[2] = {0.0f, 0.0f};
          int jg[2] = {0, 0};
          for (int j = 0; j < K / 8; ++j) {
            float t, u, v;
            const bool ok = mt_test(blk + (j * 8 + s) * FIELDS, o, d, mnb, tb,
                                    DET_EPS, t, u, v);
            const int g = j & 1;
            if (ok && t < tg[g]) {
              tg[g] = t;
              jg[g] = j;
              ug[g] = u;
              vg[g] = v;
            }
          }
          const int sel = tg[1] < tg[0] ? 1 : 0;
          const float ts = tg[sel];
          const int pc = jg[sel] * 8 + s;
          if (ts < bt || (ts == bt && pc < bp)) {
            bt = ts;
            bp = pc;
            bu = ug[sel];
            bv = vg[sel];
          }
        }
        if (bt < tb) {
          tb = bt;
          ub = bu;
          vb = bv;
          pb = tri_start[cid] + bp;
        }
      }
    }
    __syncthreads();                            // before the next staging
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

// The probe: the closest kernel's walk without Moeller-Trumbore, the
// fixed cost of a work item. Per valid item it stages the item's (K, 16)
// block in shared memory as worklist_kernel does (that fetch is what the
// probe costs, so it is not elided: every lane reads the block's first
// float), then the per-lane slab test of the block's AABB against
// [mint, maxt] (maxt, not a best t); acc = (acc + pass) + tri[cid, 0, 0].
// A row the list never reaches reads 0.
__global__ void __launch_bounds__(LANES)
worklist_probe_kernel(const int* __restrict__ items,
                      const int* __restrict__ seg,
                      const float* __restrict__ tri,
                      const float* __restrict__ rays, int K,
                      float* __restrict__ out) {
  __shared__ float blk[MAX_K * FIELDS];
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const float* ry = rays + (size_t)r * 8 * LANES;
  float o[3], d[3];
  for (int j = 0; j < 3; ++j) {
    o[j] = ry[j * LANES + l];
    d[j] = ry[(3 + j) * LANES + l];
  }
  const float mnb = ry[6 * LANES + l];
  const float mx = ry[7 * LANES + l];
  float acc = 0.0f;
  const int w_end = seg[r + 1];
  for (int w = seg[r]; w < w_end; ++w) {
    const int item = items[w];
    if (!(item & VALID_BIT)) continue;          // uniform across the block
    const float* src = tri + (size_t)(item & (FIRST_BIT - 1)) * K * FIELDS;
    for (int i = l; i < K * FIELDS; i += LANES) blk[i] = src[i];
    __syncthreads();
    float tn = mnb, tf = mx;
    for (int j = 0; j < 3; ++j) {
      const float inv =
          (d[j] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d[j]), 1e-12f);
      const float t0 = (blk[9 + j] - o[j]) * inv;
      const float t1 = (blk[12 + j] - o[j]) * inv;
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    acc = (acc + (tn <= tf ? 1.0f : 0.0f)) + blk[0];
    __syncthreads();                            // before the next staging
  }
  out[(size_t)r * LANES + l] = acc;
}

extern "C" int mts_worklist_probe(const int* items, const int* seg,
                                  const float* tri, const float* rays, int R,
                                  int K, float* out, void* stream) {
  if (R <= 0) return 0;
  if (K <= 0 || K > MAX_K || K % 8) return (int)cudaErrorInvalidValue;
  worklist_probe_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(
      items, seg, tri, rays, K, out);
  return (int)cudaGetLastError();
}

extern "C" int mts_worklist(const int* items, const int* seg,
                            const float* tri, const int* tri_start,
                            const int* block_id, const float* xform,
                            const float* rays, int R, int K, int any_hit,
                            float* out_t, float* out_u, float* out_v,
                            int* out_p, int* out_occ, void* stream) {
  if (R <= 0) return 0;
  if (K <= 0 || K > MAX_K || K % 8) return (int)cudaErrorInvalidValue;
  worklist_kernel<<<R, LANES, 0, (cudaStream_t)stream>>>(
      items, seg, tri, tri_start, block_id, xform, rays, K, any_hit, out_t,
      out_u, out_v, out_p, out_occ);
  return (int)cudaGetLastError();
}
