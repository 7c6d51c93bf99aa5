// Work-list cluster intersector, closest and any hit, flat and instanced,
// and its fixed-cost probe, for NVIDIA Hopper (sm_90a): one walk,
// `worklist_kernel<ANY, INST, PROBE>`.
//
// Replaces the TPU kernels mitsuba_tpu/ops/worklist_pallas.py:364
// `_make_closest_kernel`, :458 `_make_any_kernel` and :424
// `_make_probe_kernel` (entry `_call_chunk` :548, pallas_call at :570, via
// `wl_closest` :594, `wl_any` :619 and `wl_probe` :448). Wrapped by
// mitsuba_tpu_torch/ops/worklist.py, whose `wl_rows_ref` and
// `wl_probe_ref` are the plain PyTorch versions these kernels must agree
// with lane for lane.
//
// The walk: one 128-thread block per 128-lane ray row, one thread per
// lane, walks the row's run of list slots (seg[r]..seg[r + 1]) in list
// order and keeps the lanes' best hit in registers. Per valid item, in
// instanced mode, each lane's ray is first moved into object space by the
// item's world->object 3x4 map (t carries over). Closest: a per-lane slab
// test of the item's cluster box (row 0, columns 9:15 of its (K, 16)
// block) against the lane's best t decides, by a block-wide OR, whether
// the item is tested; then Moeller-Trumbore over its K triangles under
// the lane's best t at the item's start. Any hit tests every valid item
// under maxt until the row's lanes are all occluded. Every row's outputs
// are initialised (t = maxt, prim = -1; not occluded), also a row the
// list never reached.
//
// What bounds it on this card: the walk is sequential within a row, so a
// row costs the latency of each item (fetch of its block, the vote, the
// tests one warp runs in sequence); a wavefront's launch is a few waves
// of rows, and it waits for its longest row. A voted item runs K tests
// on every lane of the row, so a busy SM is bound by Moeller-Trumbore
// issue. A list's unused slots past its `total`, which the build gives
// to its last row, would be walked slot by slot after every other row
// had finished: ops/worklist.py ends the segments at the list's last
// used slot. The render's later wavefront chunks hold whole rows with no
// live lane.
//
// The design: the row's slots are read a window of 512 at a time, one
// coalesced load a thread per 128 slots, and the valid ones compacted in
// list order (warp ballots) into shared memory with each item's block id
// and prim base, so the walk meets no invalid slot and no dependent
// global load. Three staging buffers of K x 16 floats plus the item's
// map, sized by K: the item two ahead is copied by cp.async while the
// current one is tested, and each item takes one barrier, the vote itself
// (closest: the OR of the slab tests; any hit: the AND of "occluded or
// unable to hit"), before which each thread waits for its own copies of
// the next item, so the barrier also makes that item visible. A triangle
// is three 16-byte shared loads (a broadcast); the closest tests run two
// chunks of a sublane at a time. A warp none of whose lanes can change
// its record skips the item's tests but joins every barrier and vote.
//
// The probe (#13, `worklist_kernel<false, false, true>`) is this walk
// without Moeller-Trumbore, the fixed cost of a work item as #12 pays it:
// the same window compaction, the same three-deep staging of each item's
// K x 16 block (that fetch is what the probe costs, so every lane reads
// the block's first float), and one barrier per item, with no vote and no
// stop. Per valid item in list order each lane adds its slab test of the
// block's box against [mint, maxt] (maxt, not a best t), then the block's
// first float: acc = (acc + pass) + tri[cid, 0, 0]; a row with no valid
// item reads 0 (worklist_pallas.py:424-444).
//
// Why it is exact: the vote, the caps and the tie order are the plain
// version's. Closest: per sublane the even and odd chunks keep separate
// running minima (strict <) and the odd one wins only when strictly nearer;
// across sublanes the lowest k_run * 8 + sublane wins among equal t; across
// items a strict t < best t (worklist_pallas.py:273-314, 403-409). A lane
// whose own slab test fails still runs the item's tests when the row votes for
// it. A warp skips only when no lane can pass a test (mint < best t is false)
// nor take the miss sentinel (best t above it, as with maxt = inf); any hit,
// when every lane is occluded or has mint >= maxt, so that no test can pass;
// the row stops once that holds for all its lanes, and a row none of whose
// lanes can change (every lane dead: mint >= maxt) walks nothing; the render's
// wavefronts hold whole chunks of such rows. Any hit is an OR per lane, so the
// order of its tests does not matter. Compiled with --fmad=false and IEEE
// division; every expression has the plain version's operation order; |det| >
// 1e-12.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "mt.cuh"

#define LANES 128
#define WARPS (LANES / 32)
#define FIELDS 16
#define BIG 3e38f
#define DET_EPS 1e-12f
#define CID_BITS 14
#define FIRST_BIT (1 << CID_BITS)
#define VALID_BIT (1 << (CID_BITS + 1))
#define MAX_K 128
#define CHUNKS 4                      // 128-slot chunks of a window
#define WIN (CHUNKS * LANES)          // slots compacted at once
#define STAGES 3                      // staging buffers
#define ROWS_PER_SM 8                 // the register budget: 64 a thread
#define FULL 0xffffffffu

// the compacted valid items of a window, in list order, after the
// staging buffers (STAGES x (K x 16 + 16) floats) in dynamic shared memory
struct WlScratch {
  int cid[WIN];                 // cluster id (the map's row)
  int blk[WIN];                 // its block: block_id[cid], or cid
  int start[WIN];               // tri_start[cid]
  int cnt[CHUNKS * WARPS];      // valid slots per chunk and warp
};

__host__ __device__ __forceinline__ int wl_stage_floats(int K) {
  return K * FIELDS + FIELDS;   // the block, then the item's map
}

__host__ __device__ __forceinline__ size_t wl_smem(int K) {
  return (size_t)STAGES * wl_stage_floats(K) * sizeof(float) +
         sizeof(WlScratch);
}

// this thread's share of the copy of item i's block (and map) into dst
template <bool INST>
__device__ __forceinline__ void stage_item(const WlScratch& sh, int i,
                                           const float* tri,
                                           const float* xform, int K,
                                           float* dst) {
  const float* src = tri + (size_t)sh.blk[i] * K * FIELDS;
  for (int c = threadIdx.x; c < K * FIELDS / 4; c += LANES)
    cp_async16(dst + 4 * c, src + 4 * c);
  if (INST && threadIdx.x < FIELDS / 4)
    cp_async16(dst + K * FIELDS + 4 * threadIdx.x,
               xform + (size_t)sh.cid[i] * FIELDS + 4 * threadIdx.x);
  cp_async_commit();
}

__device__ __forceinline__ float slab_rcp(float d) {
  return (d >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d), 1e-12f);
}

template <bool ANY, bool INST, bool PROBE = false>
__global__ void __launch_bounds__(LANES, ROWS_PER_SM)
worklist_kernel(const int* __restrict__ items, const int* __restrict__ seg,
                const float* __restrict__ tri,
                const int* __restrict__ tri_start,
                const int* __restrict__ block_id,
                const float* __restrict__ xform,
                const float* __restrict__ rays, int K,
                float* __restrict__ out_t, float* __restrict__ out_u,
                float* __restrict__ out_v, int* __restrict__ out_p,
                int* __restrict__ out_occ) {
  extern __shared__ __align__(16) float smem[];
  const int sf = wl_stage_floats(K);
  WlScratch& sh = *reinterpret_cast<WlScratch*>(smem + STAGES * sf);
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int warp = l / 32;
  const unsigned below = (1u << (l % 32)) - 1u;
  const float* ry = rays + (size_t)r * 8 * LANES;
  float ow[3], dw[3], o[3], d[3], inv[3];
  for (int j = 0; j < 3; ++j) {
    ow[j] = ry[j * LANES + l];
    dw[j] = ry[(3 + j) * LANES + l];
    o[j] = ow[j];
    d[j] = dw[j];
    inv[j] = slab_rcp(d[j]);
  }
  const float mnb = ry[6 * LANES + l];
  const float mx = ry[7 * LANES + l];

  float tb = mx, ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  float acc = 0.0f;                   // the probe's sum
  const int w_end = seg[r + 1];
  // a row none of whose lanes can change its record walks nothing: no
  // test can pass where mint < maxt fails, and closest, no miss sentinel
  // where maxt < BIG; the probe walks every row
  bool done = !PROBE && !__syncthreads_or(ANY ? mnb < mx
                                              : (mnb < mx || BIG < mx));
  for (int base = seg[r]; base < w_end && !done; base += WIN) {
    // compact the window's valid items, in list order
    int it[CHUNKS];
    unsigned m[CHUNKS];
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      const int w = base + q * LANES + l;
      it[q] = w < w_end ? items[w] : 0;
      m[q] = __ballot_sync(FULL, (it[q] & VALID_BIT) != 0);
      if (l % 32 == 0) sh.cnt[q * WARPS + warp] = __popc(m[q]);
    }
    __syncthreads();          // counts set; the last window's walk done
    int n = 0;
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      for (int wq = 0; wq < WARPS; ++wq) {
        if (wq == warp && (it[q] & VALID_BIT)) {
          const int pos = n + __popc(m[q] & below);
          const int cid = it[q] & (FIRST_BIT - 1);
          sh.cid[pos] = cid;
          sh.blk[pos] = INST ? block_id[cid] : cid;
          if (!PROBE) sh.start[pos] = tri_start[cid];
        }
        n += sh.cnt[q * WARPS + wq];
      }
    }
    if (n > 0) {
      __syncthreads();        // the window's items listed
      stage_item<INST>(sh, 0, tri, xform, K, smem);
      if (n > 1) stage_item<INST>(sh, 1, tri, xform, K, smem + sf);
      cp_async_wait_all();
    }
    __syncthreads();          // items 0 and 1 staged; counts read
    for (int i = 0; i < n; ++i) {
      const float* cur = smem + (i % STAGES) * sf;
      if (INST) {
        const float* mp = cur + K * FIELDS;
        for (int j = 0; j < 3; ++j) {
          o[j] = mp[4 * j] * ow[0] + mp[4 * j + 1] * ow[1] +
                 mp[4 * j + 2] * ow[2] + mp[4 * j + 3];
          d[j] = mp[4 * j] * dw[0] + mp[4 * j + 1] * dw[1] +
                 mp[4 * j + 2] * dw[2];
        }
      }
      bool go;
      cp_async_wait_all();    // this thread's copies of item i + 1
      if (PROBE) {
        __syncthreads();      // item i + 1 staged
        go = true;
      } else if (ANY) {
        // the row stops once no lane can change: each is occluded or
        // has mint >= maxt
        if (__syncthreads_and(occ || !(mnb < mx))) {
          done = true;
          break;
        }
        go = true;
      } else {
        float tn = mnb, tf = tb;
        for (int j = 0; j < 3; ++j) {
          const float rc = INST ? slab_rcp(d[j]) : inv[j];
          const float t0 = (cur[9 + j] - o[j]) * rc;
          const float t1 = (cur[12 + j] - o[j]) * rc;
          tn = fmaxf(tn, fminf(t0, t1));
          tf = fminf(tf, fmaxf(t0, t1));
        }
        go = __syncthreads_or(tn <= tf);
      }
      // every thread is past item i - 1: its buffer takes item i + 2
      if (i + 2 < n)
        stage_item<INST>(sh, i + 2, tri, xform, K,
                         smem + ((i + 2) % STAGES) * sf);
      if (PROBE) {
        float tn = mnb, tf = mx;
        for (int j = 0; j < 3; ++j) {
          const float t0 = (cur[9 + j] - o[j]) * inv[j];
          const float t1 = (cur[12 + j] - o[j]) * inv[j];
          tn = fmaxf(tn, fminf(t0, t1));
          tf = fminf(tf, fmaxf(t0, t1));
        }
        acc = (acc + (tn <= tf ? 1.0f : 0.0f)) + cur[0];
        continue;
      }
      if (!go) continue;
      if (ANY) {
        const bool can = !occ && mnb < mx;
        if (!__any_sync(FULL, can)) continue;
        bool hit = false;
        for (int k = 0; k < K; k += 8) {
          if (__all_sync(FULL, hit || !can)) break;
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            float t, u, v;
            const bool ok0 = mt_rec(cur + (k + j) * FIELDS, o, d, mnb, mx,
                                    DET_EPS, t, u, v);
            const bool ok1 = mt_rec(cur + (k + j + 1) * FIELDS, o, d, mnb, mx,
                                    DET_EPS, t, u, v);
            hit = hit || ok0 || ok1;
          }
        }
        occ = occ || hit;
      } else {
        // a lane changes its record only by a passing test (mint < tb)
        // or by the miss sentinel BIG below tb
        if (!__any_sync(FULL, mnb < tb || BIG < tb)) continue;
        float bt, bu, bv;
        int bp;
        mt_cluster(cur, FIELDS, K, o, d, mnb, tb, DET_EPS, bt, bu, bv, bp);
        if (bt < tb) {
          tb = bt;
          ub = bu;
          vb = bv;
          pb = sh.start[i] + bp;
        }
      }
    }
  }
  const size_t at = (size_t)r * LANES + l;
  if (PROBE) {
    out_t[at] = acc;
  } else if (ANY) {
    out_occ[at] = occ ? 1 : 0;
  } else {
    out_t[at] = tb;
    out_u[at] = ub;
    out_v[at] = vb;
    out_p[at] = pb;
  }
}

template <bool ANY, bool INST, bool PROBE = false>
static cudaError_t wl_prepare() {
  constexpr int DEVICES = 64;
  static bool carveout[DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !carveout[dev]) {
    e = cudaFuncSetAttribute(worklist_kernel<ANY, INST, PROBE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    carveout[dev] = e == cudaSuccess;
  }
  return e;
}

template <bool ANY, bool INST, bool PROBE = false>
static int wl_launch(const int* items, const int* seg, const float* tri,
                     const int* tri_start, const int* block_id,
                     const float* xform, const float* rays, int R, int K,
                     float* out_t, float* out_u, float* out_v, int* out_p,
                     int* out_occ, cudaStream_t stream) {
  const cudaError_t e = wl_prepare<ANY, INST, PROBE>();
  if (e != cudaSuccess) return (int)e;
  worklist_kernel<ANY, INST, PROBE><<<R, LANES, wl_smem(K), stream>>>(
      items, seg, tri, tri_start, block_id, xform, rays, K, out_t, out_u,
      out_v, out_p, out_occ);
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
  // cp.async copies 16-byte pieces of the blocks and maps
  if (((size_t)tri | (size_t)xform) % 16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool inst = xform != nullptr;
  if (any_hit)
    return inst ? wl_launch<true, true>(items, seg, tri, tri_start, block_id,
                                        xform, rays, R, K, out_t, out_u,
                                        out_v, out_p, out_occ, s)
                : wl_launch<true, false>(items, seg, tri, tri_start,
                                         block_id, xform, rays, R, K, out_t,
                                         out_u, out_v, out_p, out_occ, s);
  return inst ? wl_launch<false, true>(items, seg, tri, tri_start, block_id,
                                       xform, rays, R, K, out_t, out_u,
                                       out_v, out_p, out_occ, s)
              : wl_launch<false, false>(items, seg, tri, tri_start, block_id,
                                        xform, rays, R, K, out_t, out_u,
                                        out_v, out_p, out_occ, s);
}

// the probe: per lane its sum over the row's valid items (out, R x 128)
extern "C" int mts_worklist_probe(const int* items, const int* seg,
                                  const float* tri, const float* rays, int R,
                                  int K, float* out, void* stream) {
  if (R <= 0) return 0;
  if (K <= 0 || K > MAX_K || K % 8) return (int)cudaErrorInvalidValue;
  if ((size_t)tri % 16) return (int)cudaErrorMisalignedAddress;
  return wl_launch<false, false, true>(items, seg, tri, nullptr, nullptr,
                                       nullptr, rays, R, K, out, nullptr,
                                       nullptr, nullptr, nullptr,
                                       (cudaStream_t)stream);
}

template <bool ANY, bool INST, bool PROBE = false>
static cudaError_t wl_info(int K, int* out) {
  cudaError_t e = wl_prepare<ANY, INST, PROBE>();
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, worklist_kernel<ANY, INST, PROBE>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], worklist_kernel<ANY, INST, PROBE>, LANES, wl_smem(K));
  out[1] = e == cudaSuccess ? attr.numRegs : 0;
  out[2] = (int)wl_smem(K);
  out[3] = e == cudaSuccess ? (int)attr.localSizeBytes : 0;
  return e;
}

// the kernel's resources at cluster size K: out[0] resident rows per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] shared memory bytes per row, out[3] local memory bytes
// per thread (spills)
extern "C" int mts_worklist_info(int K, int any_hit, int inst, int* out) {
  if (K <= 0 || K > MAX_K || K % 8) return (int)cudaErrorInvalidValue;
  return (int)(any_hit ? (inst ? wl_info<true, true>(K, out)
                               : wl_info<true, false>(K, out))
                       : (inst ? wl_info<false, true>(K, out)
                               : wl_info<false, false>(K, out)));
}

// the probe's resources at cluster size K, as mts_worklist_info's
extern "C" int mts_worklist_probe_info(int K, int* out) {
  if (K <= 0 || K > MAX_K || K % 8) return (int)cudaErrorInvalidValue;
  return (int)wl_info<false, false, true>(K, out);
}
