// Per-row ordered streaming intersector for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba_tpu/ops/stream_pallas.py:176
// `_make_stream_kernel` (entry `_call_stream`, pallas_call at :317).
// Wrapped by mitsuba_tpu_torch/ops/stream.py, whose `stream_rows_ref` is
// the plain PyTorch version this kernel must agree with lane for lane.
//
// The walk: each 128-lane ray row follows its front-to-back supercluster
// list (8 clusters of K triangles, a (K, 128) block of 16 KB at K = 32).
// Closest: for each cluster in order, a per-lane slab test against the
// lane's best t decides, OR-ed over the row, whether Moeller-Trumbore
// runs over the cluster's K triangles for every lane; the row stops when
// the next entry's conservative entry distance exceeds every lane's best
// t. Any hit: every cluster is tested, capped at mint once a lane is
// occluded; the row stops when every live lane is occluded.
//
// What bounds it on this card: the walk is sequential within a row, and
// the cluster path launches it on a few hundred rows (1/16 of the
// wavefront, 512 at 2^20 lanes) whose lanes are mostly dead (only the
// lanes that overflowed the exact cull's XL caps are live: 60-92% of the
// warps of config 3's launches have none). So the latency of each list
// step bounds a row: the staging of the next block, the barriers of the
// votes and the exit, and the tests one warp runs in sequence. An
// any-hit row with a lane that stays unoccluded walks its whole list,
// hundreds of superclusters of 256 triangles, and such rows bound an
// any-hit launch, where the kernel spends most of its time.
// Compacting the live lanes and giving each warp one cluster did not
// shorten them, and lengthened the closest launches (PERF.md).
//
// The design: 256 threads per row, two groups of four warps, one thread
// per lane in each (64 registers, 55.5 KB of shared memory: 4 rows per
// SM, a 512-row launch in one wave). Under that register cap the closest
// kernel spills (ptxas: 24 bytes of stack, 20 bytes of spill stores, 36
// of loads); at 3 rows per SM it takes 76 registers without a spill and
// times the same on an H100 (its closest launches 4% less a config-3
// render, 6% more on 1,024 bounce rows; PERF.md), so 4 rows stay, and
// with them one wave. The next supercluster is copied by
// cp.async while the current one is tested. Closest, per step: (1) each
// group computes for its four clusters the lanes' slab thresholds and a
// vote under tb0, the lanes' best t at the step's start; (2) each group
// runs Moeller-Trumbore on those of its clusters that the vote admits,
// under cap tb0, and writes each lane's cluster winner to shared memory;
// (3) one warp, four lanes a thread, replays the clusters in list order:
// the vote with the lanes' true bound, then the strict < merge against
// it. Three barriers a step (two whole-block, one per group). A warp
// none of whose lanes has mint < tb0 skips its tests. Any hit: each
// group tests its four clusters under maxt for the lanes not yet
// occluded; a warp stops once each lane has hit or cannot; one thread
// merges the groups' hit masks and decides the exit.
//
// Why it is exact: a lane's winner of a cluster is the lexicographic
// minimum of its passing tests, so under the looser cap tb0 >= tb it is
// the same triangle whenever its t is below tb, and is dropped at the
// merge (t < tb fails) exactly when the walk's cluster had no passing
// test; a slab test passing under tb also passes under tb0 (the
// threshold is the same, the bound larger), so no cluster the walk
// votes for is left untested; the votes and merges themselves run in
// the walk's order with its bound. Any hit is an OR per lane: the order
// of the tests within a step does not matter.
//
// Rounding: compiled with --fmad=false and IEEE division; every
// expression has the plain version's operation order, and the tie order
// is the TPU kernel's (stream_pallas.py:137-148, 254-266): within a
// sublane the even and odd chunks keep separate running minima (strict
// <) and the odd one wins only when strictly nearer; across sublanes the
// lowest candidate index k_run * 8 + sublane wins among equal t.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "mt.cuh"

#define LANES 128
#define SC_GROUP 8
#define FIELDS 16
#define BIG 3e38f
#define DET_EPS 1e-12f
#define GROUPS 2                          // 128-thread groups per row
#define THREADS (GROUPS * LANES)
#define CL_PER_GROUP (SC_GROUP / GROUPS)  // clusters each group tests
#define ROWS_PER_SM 4                     // the register budget: 64 a thread
#define FULL 0xffffffffu

// the row's state and scratch in dynamic shared memory, after the two
// staged superclusters (2 x K x 128 floats)
struct Scratch {
  float thr[SC_GROUP][LANES];    // closest: slab threshold per cluster, lane
  float rt[SC_GROUP][LANES];     // closest: each cluster's visit, per lane
  float ru[SC_GROUP][LANES];
  float rv[SC_GROUP][LANES];
  int rp[SC_GROUP][LANES];
  float bt[LANES], bu[LANES], bv[LANES];  // closest: the lanes' best hit
  int bp[LANES];
  unsigned vote[SC_GROUP][LANES / 32];  // closest: loose votes, per warp
  unsigned hit[GROUPS][LANES / 32];     // any hit: hits, per group and warp
  unsigned occ[LANES / 32];             // any hit: occluded lanes
  unsigned live[LANES / 32];            // any hit: lanes with mint <= maxt
  int cont;                             // walk on to the next entry
};

__host__ __device__ __forceinline__ size_t stream_smem(int K) {
  return (size_t)2 * K * LANES * sizeof(float) + sizeof(Scratch);
}

// this thread's share of the copy of supercluster block src (K x 128
// floats) into dst
__device__ __forceinline__ void stage_sc(const float* src, float* dst,
                                         int K) {
  for (int c = threadIdx.x; c < K * LANES / 4; c += THREADS)
    cp_async16(dst + 4 * c, src + 4 * c);
  cp_async_commit();
}

template <bool ANY>
__global__ void __launch_bounds__(THREADS, ROWS_PER_SM)
stream_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
              const float* __restrict__ tns,
              const float* __restrict__ sc_tri, int L, int K,
              float* __restrict__ out_t, float* __restrict__ out_u,
              float* __restrict__ out_v, int* __restrict__ out_p,
              int* __restrict__ out_occ) {
  extern __shared__ __align__(16) float blk[];    // [2][K * 128]
  const size_t blk_floats = (size_t)K * LANES;
  Scratch& sh = *reinterpret_cast<Scratch*>(blk + 2 * blk_floats);
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / LANES;               // group: clusters g*4 .. g*4+3
  const int l = tid % LANES;               // lane
  const int w = l / 32;                    // the lane's warp in its group
  const int bit = l % 32;
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

  // the list runs ahead by one entry: sc is staged, nxt / nid come next
  int sc = rid[0];
  const bool first = rtn[0] < BIG;
  if (first) stage_sc(sc_tri + (size_t)sc * blk_floats, blk, K);
  float nxt = L > 1 ? rtn[1] : BIG;
  int nid = L > 1 ? rid[1] : 0;
  if (g == 0) {
    if (ANY) {
      const unsigned lv = __ballot_sync(FULL, mnb <= mx);
      if (bit == 0) {
        sh.live[w] = lv;
        sh.occ[w] = 0u;
      }
    } else {
      sh.bt[l] = mx;
      sh.bu[l] = 0.0f;
      sh.bv[l] = 0.0f;
      sh.bp[l] = -1;
    }
  }
  if (tid == 0) sh.cont = first;
  for (int i = 0;; ++i) {
    cp_async_wait_all();
    __syncthreads();        // entry i staged; the state of entry i - 1 set
    if (!sh.cont) break;
    const float* cur = blk + (i & 1) * blk_floats;
    const bool has_next = nxt < BIG;
    float nxt2 = BIG;
    int nid2 = 0;
    if (has_next) {         // prefetch entry i + 1 while testing entry i
      stage_sc(sc_tri + (size_t)nid * blk_floats,
               blk + ((i + 1) & 1) * blk_floats, K);
      if (i + 2 < L) {
        nxt2 = rtn[i + 2];
        nid2 = rid[i + 2];
      }
    }
    if (ANY) {
      // every cluster under maxt: a lane occluded before this entry, or
      // with mint >= maxt, cannot change; a warp stops once each of its
      // lanes has hit or cannot
      const bool live = !((sh.occ[w] >> bit) & 1u) && mnb < mx;
      bool hit = false;
      if (__any_sync(FULL, live)) {
        for (int k = g * CL_PER_GROUP; k < (g + 1) * CL_PER_GROUP; ++k) {
          const float* cl = cur + k * FIELDS;
          for (int row = 0; row < K; row += 8) {
            if (__all_sync(FULL, hit || !live)) break;
#pragma unroll
            for (int j = 0; j < 8; j += 2) {
              float t, u, v;
              const bool ok0 = mt_rec(cl + (row + j) * LANES, o, d, mnb, mx,
                                      DET_EPS, t, u, v);
              const bool ok1 = mt_rec(cl + (row + j + 1) * LANES, o, d, mnb,
                                      mx, DET_EPS, t, u, v);
              hit = hit || ok0 || ok1;
            }
          }
        }
      }
      const unsigned hb = __ballot_sync(FULL, hit);
      if (bit == 0) sh.hit[g][w] = hb;
      __syncthreads();
      if (tid == 0) {       // merge the groups' hits; exit once all done
        bool done = true;
        for (int q = 0; q < LANES / 32; ++q) {
          unsigned oc = sh.occ[q];
          for (int gg = 0; gg < GROUPS; ++gg) oc |= sh.hit[gg][q];
          sh.occ[q] = oc;
          done = done && (oc | ~sh.live[q]) == FULL;
        }
        sh.cont = has_next && !done;
      }
    } else {
      // 1. each group's clusters against the lanes' best t at the start
      // of the entry (tb0, looser than the walk's bound): the slab
      // threshold (the entry distance where the box is hit within
      // [mint, tb] for every tb >= it, NaN where never) and a vote
      const float tb0 = sh.bt[l];
      for (int k = g * CL_PER_GROUP; k < (g + 1) * CL_PER_GROUP; ++k) {
        const float* box = cur + k * FIELDS + 9;   // sublane 0, row 0
        float tn = mnb, tf = __int_as_float(0x7f800000);   // +inf
        for (int j = 0; j < 3; ++j) {
          const float t0 = (box[j] - o[j]) * sinv[j];
          const float t1 = (box[3 + j] - o[j]) * sinv[j];
          tn = fmaxf(tn, fminf(t0, t1));
          tf = fminf(tf, fmaxf(t0, t1));
        }
        const float thr = tn <= tf ? tn : __int_as_float(0x7fffffff);
        sh.thr[k][l] = thr;
        const unsigned vb = __ballot_sync(FULL, thr <= tb0);
        if (bit == 0) sh.vote[k][w] = vb;
      }
      named_barrier(1 + g, LANES);
      // 2. Moeller-Trumbore of each cluster some lane may enter, under
      // tb0; a warp none of whose lanes has mint < tb0 passes nothing
      const bool warp_live = __any_sync(FULL, mnb < tb0);
      for (int k = g * CL_PER_GROUP; k < (g + 1) * CL_PER_GROUP; ++k) {
        if (!(sh.vote[k][0] | sh.vote[k][1] | sh.vote[k][2] |
              sh.vote[k][3]))
          continue;
        float t = BIG, u = 0.0f, v = 0.0f;
        int p = 0;
        if (warp_live)
          mt_cluster(cur + k * FIELDS, LANES, K, o, d, mnb, tb0, DET_EPS, t,
                     u, v, p);
        sh.rt[k][l] = t;
        sh.ru[k][l] = u;
        sh.rv[k][l] = v;
        sh.rp[k][l] = p;
      }
      __syncthreads();
      // 3. one warp, four lanes a thread, replays the walk's cluster
      // order: the vote with the lanes' true bound, then strict <
      // against it; a hit under tb0 that is not below the true bound is
      // dropped, so the record is the walk's
      if (tid < 32) {
        float tb[LANES / 32];
        for (int q = 0; q < LANES / 32; ++q) tb[q] = sh.bt[tid + 32 * q];
        for (int k = 0; k < SC_GROUP; ++k) {
          if (!(sh.vote[k][0] | sh.vote[k][1] | sh.vote[k][2] |
                sh.vote[k][3]))
            continue;
          bool pass = false;
          for (int q = 0; q < LANES / 32; ++q)
            pass = pass || sh.thr[k][tid + 32 * q] <= tb[q];
          if (!__any_sync(FULL, pass)) continue;
          for (int q = 0; q < LANES / 32; ++q) {
            const int lq = tid + 32 * q;
            const float t = sh.rt[k][lq];
            if (t < tb[q]) {
              tb[q] = t;
              sh.bu[lq] = sh.ru[k][lq];
              sh.bv[lq] = sh.rv[k][lq];
              sh.bp[lq] = (sc * SC_GROUP + k) * K + sh.rp[k][lq];
            }
          }
        }
        float m = tb[0];
        for (int q = 0; q < LANES / 32; ++q) {
          sh.bt[tid + 32 * q] = tb[q];
          m = fmaxf(m, tb[q]);
        }
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
        if (tid == 0) sh.cont = has_next && nxt <= m;
      }
    }
    sc = nid;
    nxt = nxt2;
    nid = nid2;
  }
  if (g == 0) {
    const size_t at = (size_t)r * LANES + l;
    if (ANY) {
      out_occ[at] = (int)((sh.occ[w] >> bit) & 1u);
    } else {
      out_t[at] = sh.bt[l];
      out_u[at] = sh.bu[l];
      out_v[at] = sh.bv[l];
      out_p[at] = sh.bp[l];
    }
  }
}

// the kernel's attributes on the current device, set once each: the
// carveout on its first launch there, the dynamic shared memory limit
// when a cluster size first needs more than the limit already set
template <bool ANY>
static cudaError_t prepare(int K, size_t& smem) {
  constexpr int DEVICES = 64;
  static bool carveout[DEVICES];
  static size_t smem_limit[DEVICES];
  smem = stream_smem(K);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !carveout[dev]) {
    e = cudaFuncSetAttribute(
        stream_kernel<ANY>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    carveout[dev] = e == cudaSuccess;
  }
  if (e == cudaSuccess && smem > 48 * 1024 && smem > smem_limit[dev]) {
    e = cudaFuncSetAttribute(stream_kernel<ANY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) smem_limit[dev] = smem;
  }
  return e;
}

extern "C" int mts_stream(const float* rays, const int* ids,
                          const float* tns, const float* sc_tri, int R,
                          int L, int K, int any_hit, float* out_t,
                          float* out_u, float* out_v, int* out_p,
                          int* out_occ, void* stream) {
  if (R <= 0) return 0;
  if (K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  size_t smem;
  const cudaError_t e = any_hit ? prepare<true>(K, smem)
                                : prepare<false>(K, smem);
  if (e != cudaSuccess) return (int)e;
  if (any_hit)
    stream_kernel<true><<<R, THREADS, smem, (cudaStream_t)stream>>>(
        rays, ids, tns, sc_tri, L, K, out_t, out_u, out_v, out_p, out_occ);
  else
    stream_kernel<false><<<R, THREADS, smem, (cudaStream_t)stream>>>(
        rays, ids, tns, sc_tri, L, K, out_t, out_u, out_v, out_p, out_occ);
  return (int)cudaGetLastError();
}

// the kernel's resources at cluster size K: out[0] resident rows per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] shared memory bytes per row, out[3] threads per row
extern "C" int mts_stream_info(int K, int any_hit, int* out) {
  size_t smem;
  cudaError_t e = any_hit ? prepare<true>(K, smem) : prepare<false>(K, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = any_hit ? cudaFuncGetAttributes(&attr, stream_kernel<true>)
                : cudaFuncGetAttributes(&attr, stream_kernel<false>);
  if (e == cudaSuccess)
    e = any_hit ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &out[0], stream_kernel<true>, THREADS, smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &out[0], stream_kernel<false>, THREADS, smem);
  out[1] = e == cudaSuccess ? attr.numRegs : 0;
  out[2] = (int)smem;
  out[3] = THREADS;
  return (int)e;
}
