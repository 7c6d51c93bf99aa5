// Skip-link BVH walk, closest and any hit, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels mitsuba_tpu/ops/bvh_pallas.py:169
// `_closest_kernel` and :196 `_any_kernel` (entries `bvh_closest` :230,
// pallas_call :250, and `bvh_any` :263, pallas_call :278). Wrapped by
// mitsuba_tpu_torch/ops/bvh.py, whose `walk_ref` is the plain PyTorch
// version this kernel must agree with lane for lane.
//
// One thread per ray walks the flattened tree: nodes (M, 9) bmin | bmax |
// first | count | skip and triangles (T, 9) v0 | e1 | e2, float32, read
// through the read-only cache. The TPU kernel walks a 1,024-ray packet
// with one node pointer (its tables live in VMEM, packed 14 records to a
// 128-lane row, and it has no per-lane gathers); per lane that gives the
// lane's own walk, since a lane that misses a box misses every box inside
// it, so here each ray walks alone and the tables stay unpacked.
//
// What bounds it: dependent node and triangle loads along each walk, and
// the divergence of walks within a warp. At 101,762 triangles the tables
// are 3.7 MB of triangles and 2.2 MB of nodes: beyond shared memory, well
// within the 50 MB L2, which serves every repeated load.
//
// Rounding: compiled with --fmad=false and IEEE division; every expression
// has the plain version's (and the TPU kernel's) operation order:
// reciprocal sign(d) / max(|d|, rcp_eps) (the TPU kernel's 1e-12, or the
// 1e-20 of the reference's exact XLA walk, which the instance walks of
// render/intersect.py run through this kernel), slab test against mint and
// min(best t, maxt), leaves of at most 4 triangles testing
// min(first + k, T - 1), |det| > 1e-9, strict t < min(best t, maxt), the
// final hit = prim >= 0 && t < maxt. Any hit caps by maxt and stops at
// the first occluder.

#include <cuda_runtime.h>

#include "mt.cuh"

#define MAX_LEAF 4
#define DET_EPS 1e-9f

__global__ void __launch_bounds__(128)
bvh_kernel(const float* __restrict__ nodes, const float* __restrict__ tris,
           const float* __restrict__ o_in, const float* __restrict__ d_in,
           const float* __restrict__ mint, const float* __restrict__ maxt,
           int n, int n_nodes, int n_tris, int any_hit, float rcp_eps,
           float* __restrict__ out_t, float* __restrict__ out_u,
           float* __restrict__ out_v, int* __restrict__ out_p,
           int* __restrict__ out_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], inv[3];
  for (int j = 0; j < 3; ++j) {
    o[j] = o_in[3 * i + j];
    d[j] = d_in[3 * i + j];
    inv[j] = (d[j] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d[j]), rcp_eps);
  }
  const float mn = mint[i];
  const float mx = maxt[i];
  float tb = __int_as_float(0x7f800000);     // +inf
  float ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  int nd = 0;
  while (nd < n_nodes && !occ) {
    const float* nr = nodes + (size_t)nd * 9;
    const int first = (int)__ldg(nr + 6);
    const int count = (int)__ldg(nr + 7);
    const int skip = (int)__ldg(nr + 8);
    const float t_cap = any_hit ? mx : fminf(tb, mx);
    float lo[3], hi[3];
    for (int j = 0; j < 3; ++j) {
      const float t0 = (__ldg(nr + j) - o[j]) * inv[j];
      const float t1 = (__ldg(nr + 3 + j) - o[j]) * inv[j];
      lo[j] = fminf(t0, t1);
      hi[j] = fmaxf(t0, t1);
    }
    const float tnear = fmaxf(fmaxf(lo[0], lo[1]), fmaxf(lo[2], mn));
    const float tfar = fminf(fminf(hi[0], hi[1]), fminf(hi[2], t_cap));
    const bool box = tnear <= tfar;
    if (box && count > 0) {
      for (int k = 0; k < MAX_LEAF && k < count; ++k) {
        const float* src = tris + (size_t)min(first + k, n_tris - 1) * 9;
        float f[9];
        for (int j = 0; j < 9; ++j) f[j] = __ldg(src + j);
        const float cap = any_hit ? mx : fminf(tb, mx);
        float t, u, v;
        if (mt_test(f, o, d, mn, cap, DET_EPS, t, u, v)) {
          if (any_hit) {
            occ = true;
          } else {
            tb = t;
            ub = u;
            vb = v;
            pb = first + k;
          }
        }
      }
    }
    nd = (box && count == 0) ? nd + 1 : skip;
  }
  if (any_hit) {
    out_hit[i] = occ ? 1 : 0;
    return;
  }
  const bool ok = pb >= 0 && tb < mx;
  out_t[i] = tb;
  out_u[i] = ub;
  out_v[i] = vb;
  out_p[i] = ok ? pb : -1;
  out_hit[i] = ok ? 1 : 0;
}

extern "C" int mts_bvh(const float* nodes, const float* tris, const float* o,
                       const float* d, const float* mint, const float* maxt,
                       int n, int n_nodes, int n_tris, int any_hit,
                       float rcp_eps, float* out_t, float* out_u,
                       float* out_v, int* out_p, int* out_hit,
                       void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  bvh_kernel<<<(n + threads - 1) / threads, threads, 0,
               (cudaStream_t)stream>>>(nodes, tris, o, d, mint, maxt, n,
                                       n_nodes, n_tris, any_hit, rcp_eps,
                                       out_t, out_u, out_v, out_p, out_hit);
  return (int)cudaGetLastError();
}
