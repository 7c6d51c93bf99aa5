// Skip-link BVH walk, closest and any hit, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels mitsuba_tpu/ops/bvh_pallas.py:169
// `_closest_kernel` and :196 `_any_kernel` (entries `bvh_closest` :230,
// pallas_call :250, and `bvh_any` :263, pallas_call :278). Wrapped by
// mitsuba_tpu_torch/ops/bvh.py, whose `walk_ref` is the plain PyTorch
// version this kernel must agree with lane for lane.
//
// The walk: every ray walks the flattened tree alone, from node 0; a hit
// on an inner node's box goes to the next node, a miss or a leaf to its
// skip link; a leaf's (at most 4) triangles are tested in order. The TPU
// kernel walks a 1,024-ray packet with one node pointer (its tables live
// in VMEM and it has no per-lane gathers); per lane that is the lane's
// own walk, since a lane that misses a box misses every box inside it.
//
// What bounds it on this card: each walk is a chain of dependent loads
// (node, box test, next node; a leaf's triangles), so a launch is bound
// by load latency, hidden only by the warps resident on each SM, and by
// the divergence of the walks within a warp. At 101,762 triangles the
// tables fit the 50 MB L2 (2.0 MB of nodes, 4.9 MB of triangles here).
// Each load instruction a step issues, and each register a walk holds
// (fewer walks resident to hide the latency), costs time.
//
// The design: one thread per ray, 128-thread blocks (55 registers: 9
// blocks per SM). The tables are read as 16-byte records, built once per
// geometry beside the (M, 9) and (T, 9) ones (ops/bvh.py
// `align_tables`): a node in two loads, bmin | skip and bmax | first * 8
// + count (ints as int32 bits), a triangle in three, v0 | e1 | e2 each
// padded to 16 bytes. The kernel uses no shared memory and asks for the largest L1 that keeps
// its blocks resident, so L1 holds the upper nodes every walk reads. A
// dead lane (mint > maxt) writes its miss without a walk. Measured
// slower on the card, and so not used (PERF.md): loading a leaf's four
// triangles before testing them (80-88 registers, 5-6 blocks per SM),
// and persistent warps that take new rays from an atomic counter (Aila
// and Laine, "Understanding the Efficiency of Ray Traversal on GPUs",
// 2009).
//
// Why it is exact: each ray's walk is the plain version's, step for
// step: the skip-link depth-first order, the slab test against mint and
// min(best t, maxt) at every node, each leaf's triangles
// min(first + k, T - 1) tested in order under min(best t, maxt) with the
// strict t < cap (any hit: maxt, stopping at the first occluder). A dead
// lane's walk tests no triangle: every box test fails there (tnear >=
// mint > maxt >= tfar; a NaN bound is not dead), so its record is a
// miss. Rounding: compiled with --fmad=false and IEEE division; every
// expression has the plain version's (and the TPU kernel's) operation
// order: reciprocal sign(d) / max(|d|, rcp_eps) (the TPU kernel's 1e-12,
// or the 1e-20 of the reference's exact XLA walk, which the instance
// walks of render/intersect.py run through this kernel), |det| > 1e-9,
// the final hit = prim >= 0 && t < maxt.

#include <cuda_runtime.h>

#include "mt.cuh"

#define MAX_LEAF 4
#define DET_EPS 1e-9f
#define THREADS 128

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
bvh_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
           const float* __restrict__ o_in, const float* __restrict__ d_in,
           const float* __restrict__ mint, const float* __restrict__ maxt,
           int n, int n_nodes, int n_tris, float rcp_eps,
           float* __restrict__ out_t, float* __restrict__ out_u,
           float* __restrict__ out_v, int* __restrict__ out_p,
           int* __restrict__ out_hit) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float mn = mint[i];
  const float mx = maxt[i];
  float tb = __int_as_float(0x7f800000);     // +inf
  float ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  if (!(mn > mx)) {                          // a dead lane hits nothing
    float o[3], d[3], inv[3];
    for (int j = 0; j < 3; ++j) {
      o[j] = o_in[3 * i + j];
      d[j] = d_in[3 * i + j];
      inv[j] = (d[j] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d[j]), rcp_eps);
    }
    int nd = 0;
    while (nd < n_nodes && !occ) {
      const float4 a = __ldg(nodes + 2 * nd);
      const float4 b = __ldg(nodes + 2 * nd + 1);
      const int skip = __float_as_int(a.w);
      const int first = __float_as_int(b.w) >> 3;
      const int count = __float_as_int(b.w) & 7;
      const float t_cap = ANY ? mx : fminf(tb, mx);
      const float t0x = (a.x - o[0]) * inv[0], t1x = (b.x - o[0]) * inv[0];
      const float t0y = (a.y - o[1]) * inv[1], t1y = (b.y - o[1]) * inv[1];
      const float t0z = (a.z - o[2]) * inv[2], t1z = (b.z - o[2]) * inv[2];
      const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fmaxf(fminf(t0z, t1z), mn));
      const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fminf(fmaxf(t0z, t1z), t_cap));
      const bool box = tnear <= tfar;
      if (box && count > 0) {
        for (int k = 0; k < MAX_LEAF && k < count && !occ; ++k) {
          const float4* src = tris + 3 * (size_t)min(first + k, n_tris - 1);
          const float4 p = __ldg(src), q = __ldg(src + 1), r = __ldg(src + 2);
          const float f[9] = {p.x, p.y, p.z, q.x, q.y, q.z, r.x, r.y, r.z};
          const float cap = ANY ? mx : fminf(tb, mx);
          float t, u, v;
          if (mt_test(f, o, d, mn, cap, DET_EPS, t, u, v)) {
            if (ANY) {
              occ = true;                    // the rest of the walk is moot
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
  }
  if (ANY) {
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

// the L1 carveout, asked for once per device and body: 7% of the SM's
// 228 KB of shared memory, its 16 KB configuration, holds the 1 KB that
// each resident block reserves for up to 16 blocks; the rest, 240 KB, is
// L1 (with all of it to L1, the 8 KB configuration, 8 blocks fit)
template <bool ANY>
static cudaError_t bvh_prepare() {
  constexpr int DEVICES = 64;
  static bool carveout[DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !carveout[dev]) {
    e = cudaFuncSetAttribute(bvh_kernel<ANY>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             7);
    carveout[dev] = e == cudaSuccess;
  }
  return e;
}

extern "C" int mts_bvh(const float* nodes, const float* tris, const float* o,
                       const float* d, const float* mint, const float* maxt,
                       int n, int n_nodes, int n_tris, int any_hit,
                       float rcp_eps, float* out_t, float* out_u,
                       float* out_v, int* out_p, int* out_hit,
                       void* stream) {
  if (n <= 0) return 0;
  if (((size_t)nodes | (size_t)tris) % 16) return (int)cudaErrorInvalidValue;
  const cudaError_t e = any_hit ? bvh_prepare<true>() : bvh_prepare<false>();
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + THREADS - 1) / THREADS;
  const float4* nd4 = reinterpret_cast<const float4*>(nodes);
  const float4* tr4 = reinterpret_cast<const float4*>(tris);
  if (any_hit)
    bvh_kernel<true><<<blocks, THREADS, 0, s>>>(
        nd4, tr4, o, d, mint, maxt, n, n_nodes, n_tris, rcp_eps, out_t,
        out_u, out_v, out_p, out_hit);
  else
    bvh_kernel<false><<<blocks, THREADS, 0, s>>>(
        nd4, tr4, o, d, mint, maxt, n, n_nodes, n_tris, rcp_eps, out_t,
        out_u, out_v, out_p, out_hit);
  return (int)cudaGetLastError();
}

// the kernel's resources: out[0] resident blocks (of 128 threads) per SM,
// out[1] registers per thread, out[2] local (spill) bytes per thread
extern "C" int mts_bvh_info(int any_hit, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = any_hit ? bvh_prepare<true>() : bvh_prepare<false>();
  if (e == cudaSuccess)
    e = any_hit ? cudaFuncGetAttributes(&attr, bvh_kernel<true>)
                : cudaFuncGetAttributes(&attr, bvh_kernel<false>);
  if (e == cudaSuccess)
    e = any_hit ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &out[0], bvh_kernel<true>, THREADS, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &out[0], bvh_kernel<false>, THREADS, 0);
  out[1] = e == cudaSuccess ? attr.numRegs : 0;
  out[2] = e == cudaSuccess ? (int)attr.localSizeBytes : 0;
  return (int)e;
}
