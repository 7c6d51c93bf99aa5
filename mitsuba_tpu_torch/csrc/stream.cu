// Per-row ordered streaming intersector for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba_tpu/ops/stream_pallas.py:176
// `_make_stream_kernel` (entry `_call_stream`, pallas_call at :317).
// Wrapped by mitsuba_tpu_torch/ops/stream.py, whose `stream_rows_ref` is
// the plain PyTorch version this kernel must agree with lane for lane.
//
// One thread block of 128 threads per 128-lane ray row, one thread per
// lane. The block walks the row's front-to-back supercluster list: it
// stages the supercluster's (K, 128) triangle block (16 KB at K = 32) in
// shared memory, then for each of its 8 clusters a per-lane slab test
// against the lane's best t decides, by a block-wide OR, whether the
// cluster is tested at all; Moeller-Trumbore runs per lane over the
// cluster's K triangles. The walk stops when the next entry's
// conservative entry distance exceeds every lane's best t (closest, a
// block-wide max) or when every live lane is occluded (any-hit).
//
// What bounds it: the list walk is sequential within a row, so latency of
// the staged loads and of the per-cluster block reductions; each staged
// block is read by all 128 threads from shared memory (broadcast reads).
// Rows are independent, so 8,192 rows fill the 132 SMs many times over.
//
// Rounding: compiled with --fmad=false and IEEE division; every
// expression has the plain version's operation order, and the tie order
// is the TPU kernel's (stream_pallas.py:137-148, 254-266): within a
// sublane the even and odd chunks keep separate running minima (strict
// <) and the odd one wins only when strictly nearer; across sublanes the
// lowest candidate index k_run * 8 + sublane wins among equal t.

#include <cuda_runtime.h>

#include "mt.cuh"

#define LANES 128
#define SC_GROUP 8
#define FIELDS 16
#define BIG 3e38f
#define DET_EPS 1e-12f
#define PSEL_NONE (1 << 30)

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(LANES)
stream_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
              const float* __restrict__ tns,
              const float* __restrict__ sc_tri, int L, int K, int any_hit,
              float* __restrict__ out_t, float* __restrict__ out_u,
              float* __restrict__ out_v, int* __restrict__ out_p,
              int* __restrict__ out_occ) {
  extern __shared__ float blk[];            // (K, 128) staged supercluster
  __shared__ float red[LANES / 32];
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const float* ry = rays + (size_t)r * 8 * LANES;
  float o[3], d[3], sinv[3];
  for (int j = 0; j < 3; ++j) {
    o[j] = ry[j * LANES + l];
    d[j] = ry[(3 + j) * LANES + l];
    sinv[j] = (d[j] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d[j]), 1e-12f);
  }
  const float mnb = ry[6 * LANES + l];
  const float mx = ry[7 * LANES + l];
  const int* rid = ids + (size_t)r * L;
  const float* rtn = tns + (size_t)r * L;

  float tb = mx, ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  const bool live0 = mnb <= mx;
  bool cont = rtn[0] < BIG;
  int i = 0;
  while (cont) {
    const int sc = rid[i];
    const float nxt = rtn[i + 1];
    const bool has_next = nxt < BIG;
    const float* src = sc_tri + (size_t)sc * K * LANES;
    for (int row = 0; row < K; ++row)
      blk[row * LANES + l] = src[row * LANES + l];
    __syncthreads();
    if (any_hit) {
      for (int k = 0; k < SC_GROUP; ++k) {
        const float cap = occ ? mnb : mx;
        bool hit = false;
        for (int row = 0; row < K; ++row) {
          float t, u, v;
          const bool ok = mt_test(blk + row * LANES + k * FIELDS, o, d, mnb,
                                  cap, DET_EPS, t, u, v);
          hit = hit || ok;
        }
        occ = occ || hit;
      }
      const int done = __syncthreads_and(occ || !live0);
      cont = has_next && !done;
    } else {
      for (int k = 0; k < SC_GROUP; ++k) {
        const float* box = blk + k * FIELDS + 9;    // sublane 0
        float tn = mnb, tf = tb;
        for (int j = 0; j < 3; ++j) {
          float t0 = (box[j] - o[j]) * sinv[j];
          float t1 = (box[3 + j] - o[j]) * sinv[j];
          tn = fmaxf(tn, fminf(t0, t1));
          tf = fminf(tf, fmaxf(t0, t1));
        }
        if (!__syncthreads_or(tn <= tf)) continue;
        float bt = BIG, bu = 0.0f, bv = 0.0f;
        int bp = PSEL_NONE;
        for (int s = 0; s < 8; ++s) {
          float tg[2] = {BIG, BIG}, ug[2] = {0.0f, 0.0f};
          float vg[2] = {0.0f, 0.0f};
          int jg[2] = {0, 0};
          for (int j = 0; j < K / 8; ++j) {
            float t, u, v;
            const bool ok = mt_test(blk + (j * 8 + s) * LANES + k * FIELDS,
                                    o, d, mnb, tb, DET_EPS, t, u, v);
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
          pb = (sc * SC_GROUP + k) * K + bp;
        }
      }
      cont = has_next && (nxt <= block_max(tb, red));
    }
    __syncthreads();                         // before the next staging
    ++i;
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

extern "C" int mts_stream(const float* rays, const int* ids,
                          const float* tns, const float* sc_tri, int R,
                          int L, int K, int any_hit, float* out_t,
                          float* out_u, float* out_v, int* out_p,
                          int* out_occ, void* stream) {
  if (R <= 0) return 0;
  stream_kernel<<<R, LANES, (size_t)K * LANES * sizeof(float),
                  (cudaStream_t)stream>>>(rays, ids, tns, sc_tri, L, K,
                                          any_hit, out_t, out_u, out_v,
                                          out_p, out_occ);
  return (int)cudaGetLastError();
}
