// The v1 streaming cluster intersector for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of mitsuba_tpu/ops/cluster_pallas.py:
//   cluster_kernel<false, ...>  <- :169 `_closest_kernel`
//   cluster_kernel<true, ...>   <- :227 `_any_kernel`   (entry `_common_call`
//                                  :284, pallas_call :305)
// Wrapped by mitsuba_tpu_torch/ops/cluster.py, whose `cluster_rows_ref` is
// the plain PyTorch version this kernel must agree with lane for lane.
//
// Layout: rays are (R, 8, 128) planes o.xyz | d.xyz | mint | maxt, in tiles
// of 8 rows; ids (R/8, C_s) and counts (R/8,) are each tile's front-to-back
// supercluster list; aabb (C_s, 8, 8) the cluster boxes; tri_start
// (C_s * 8,) the first triangle of each cluster. The Pluecker rows come as
// `rec` (C_s * 8, 128, 24), built once per table from G (C_s, 8 * 512, 16)
// by ops/cluster.py `plucker_records`: per triangle the columns of its
// four rows A | B | C | D (10 coefficients against the ray's [o | d | o x
// d | 1]) that are not the table's fixed zeros, 96 contiguous bytes, so a
// triangle is six 16-byte shared loads (five before the eligibility
// vote).
//
// The TPU kernel ran a grid step per (tile, list slot) and tested each of
// the tile's 8 rows against the supercluster's 8 clusters: a slab
// pre-test of the row's lanes, then, if any lane passes, a (512, 10) x
// (10, 128) product on the matrix unit. Here a block of 128 threads walks
// one row's tile list, a thread per lane, and every lane of a row that
// votes for a cluster computes its 128 tests itself, each an ordered
// 10-term sum per row (the plain version sums in the same order). A
// product of rank 10 would leave a tensor core nearly idle, so the kernel
// stays on the float32 pipes.
//
// What bounds it on this card: the tests. A row votes for a cluster when
// one of its lanes' slab tests passes, and then all its live lanes test
// all 128 triangles (the plain version's rule), so a launch issues the
// row-wide tests, 1.6-18x the tests that lanes' own slabs admit on config
// 3's rows. A test needs 52 float32 operations, and 13 more where its
// triangle is eligible (the fourth product, the division, t and its
// compares): the four sums' terms with the table's fixed zeros do not
// depend on the triangle (chip_smoke.py PLUCKER_OPS; its bound counts
// the eligible tests of this run's data). At --fmad=false each operation
// issues alone, so the float32 pipe's instruction rate caps a launch at
// half that bound. This kernel issues about those operations a test (the
// eligible part for both triangles of a step where a lane of the warp is
// eligible for one); its time above the cap goes to the rest of a test,
// the five 16-byte shared loads of its triangle, the votes, the barriers
// and the loop, not timed apart (PERF.md section 6 gives the shares).
// The first form added a synchronous staging per row with a divide and a
// modulo per float, two barriers per cluster, 40 scalar shared loads per
// test, and any-hit warps that ran until their last lane stopped, dead
// lanes included.
//
// The design:
// * Fewer loads and operations a test: the record holds only the columns
//   that are not fixed zeros; the products of those zeros with the ray do
//   not depend on the triangle, so a lane takes them once (`Zeros`) and
//   each sum adds them where the plain version's order has them. A test
//   step takes two triangles (PAIR), their first three products
//   interleaved, and reads the fourth product and the division only where
//   a lane of the warp is eligible for one of them (its three edge signs
//   agree): no test passes without that, so skipping them changes no
//   output, and one vote serves both triangles.
// * The list is walked in windows of 8 superclusters. A window's boxes
//   are staged in shared memory, and each lane slab-tests all of them at
//   its maxt: a warp-wide OR gives each warp a 64-bit mask, and one
//   barrier publishes them. A cluster that no lane of the block passes
//   there can take no vote (the vote caps at best t <= maxt, or at maxt),
//   so the walk skips it without a barrier.
// * The row's candidates run in list order, one barrier each: the
//   barrier publishes each warp's vote flag (closest: a lane's slab
//   against its best t; any hit: a lane that can still be occluded) and
//   makes the candidate's records visible, copied by cp.async into one of
//   two buffers while the last candidate was tested. That copy is
//   speculative (the vote may yet say no) and never decides which
//   clusters a row tests.
// * One row a block, not a tile: the rows of a tile vote for different
//   clusters, and a block of a tile's 8 rows, which copies each cluster
//   once, waits at every barrier for rows that do not test (2-3x slower
//   on config 3's rows, PERF.md).
// * Closest: a warp none of whose lanes can change its record (no lane
//   with mint < best t, or best t above the miss sentinel) skips the
//   tests. Any hit: a warp whose lanes are all occluded or unable (mint
//   >= maxt) skips them, and a warp leaves a cluster, between groups of 8
//   triangles, once each lane has hit or cannot; the block ends once no
//   lane of it can still be occluded (any-hit output is an OR per lane, so
//   the order and the skipped tests change nothing).
//
// Exact: the vote and its caps, the ordered sums and the tie rules are
// the plain version's: within a cluster the lowest k among equal t,
// across clusters strict <; occluded lanes still vote, padding lanes
// (maxt = -1) never do. One corner differs in both this and the first
// form: with maxt above 3e38 (no entry point passes one: launch_args
// clamps to 1e30) a test at exactly t = 3e38 is not taken.
//
// Rounding: compiled with --fmad=false and IEEE division; every
// expression keeps the plain version's operation order.

#include <cuda_runtime.h>

#include "async_copy.cuh"

#define LANES 128
#define WARPS (LANES / 32)            // warps of a row
#define BM 8
#define SC_GROUP 8
#define CLUSTER_K 128
#define N_COEF 10
#define REC 24                        // floats of a triangle record
#define STAGE (CLUSTER_K * REC)       // floats of a cluster's records
#define BOX 8                         // floats of an aabb row
#define WIN_SC 8                      // superclusters of a window
#define WIN (WIN_SC * SC_GROUP)       // clusters of a window
#define NW (WIN / 32)                 // mask words of a window
#define BIG 3e38f
#define DET_EPS 1e-12f
#define NO_K (1 << 30)
#define FULL 0xffffffffu
#define PAIR 2                        // triangles a test step, one vote

// a block's shared memory (dynamic: 26,752 bytes)
struct V1Smem {
  float stage[2][STAGE];              // a candidate's records, and the next
  float box[WIN * BOX];               // the window's cluster boxes
  int sc[WIN_SC];                     // the window's superclusters
  unsigned mask[2][NW][WARPS];        // per warp: clusters its slabs pass
  int flag[2][WARPS];                 // per warp: its vote on a candidate
};

__device__ __forceinline__ bool slab(const float* bx, const float o[3],
                                     const float inv[3], float tn, float tf) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float t0 = (bx[j] - o[j]) * inv[j];
    const float t1 = (bx[3 + j] - o[j]) * inv[j];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  return tn <= tf;
}

// A triangle's four Pluecker rows A | B | C | D against the ray's m = [o |
// d | o x d | 1] (render/clusters.py build_cluster_tables): A, B and C
// hold +0.0 in columns 0-2 and 9, D in columns 3-8. The plain version
// sums all 10 terms in order; those products with a stored +0.0 do not
// depend on the triangle, so the lane computes them once (`Zeros`) and
// each test sums the rest in between, in the same order: the same
// operations on the same values. The record keeps the other columns: A,
// B, C columns 3-8, then D columns 0-2 and 9, and two zeros (24 floats,
// six 16-byte loads; ops/cluster.py `plucker_records`).
struct Zeros {
  float abc;   // ((+0 m0 + +0 m1) + +0 m2), the head of rows A, B, C
  float tail;  // +0 m9, their last term
  float d;     // (((((+0 m3 + +0 m4) + +0 m5) + +0 m6) + +0 m7) + +0 m8)
};

__device__ __forceinline__ Zeros lane_zeros(const float m[N_COEF]) {
  Zeros z;
  z.abc = (0.0f * m[0] + 0.0f * m[1]) + 0.0f * m[2];
  z.tail = 0.0f * m[9];
  float s = 0.0f * m[3];
#pragma unroll
  for (int j = 4; j < 9; ++j) s = s + 0.0f * m[j];
  z.d = s;
  return z;
}

// row A, B or C: the 10-term sum in order, g = its columns 3-8
__device__ __forceinline__ float row_abc(const float* g, const float m[N_COEF],
                                         const Zeros& z) {
  float s = z.abc;
#pragma unroll
  for (int j = 0; j < 6; ++j) s = s + g[j] * m[3 + j];
  return s + z.tail;
}

// Pluecker tests of PAIR consecutive staged triangles at g (REC floats each)
// under the rules of cluster_pallas.py:140-166: eligibility, and (where
// some lane of the warp is eligible for one of them) t, 1/det signed, P1,
// P2. A lane that is not eligible takes no hit whatever the rest says.
struct Plucker {
  float t, rcps, p1, p2;
  bool elig;
};

__device__ __forceinline__ void plucker(const float* g,
                                        const float m[N_COEF],
                                        const Zeros& z, Plucker (&r)[PAIR]) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float c[PAIR][20], sgn[PAIR], absdet[PAIR];
  bool any = false;
#pragma unroll
  for (int q = 0; q < PAIR; ++q) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float4 x = g4[q * REC / 4 + i];
      c[q][4 * i] = x.x;
      c[q][4 * i + 1] = x.y;
      c[q][4 * i + 2] = x.z;
      c[q][4 * i + 3] = x.w;
    }
  }
#pragma unroll
  for (int q = 0; q < PAIR; ++q) {
    const float p0 = row_abc(c[q], m, z);
    r[q].p1 = row_abc(c[q] + 6, m, z);
    r[q].p2 = row_abc(c[q] + 12, m, z);
    const float det = p0 + r[q].p1 + r[q].p2;
    const float smin = fminf(fminf(p0, r[q].p1), r[q].p2);
    const float smax = fmaxf(fmaxf(p0, r[q].p1), r[q].p2);
    const bool pos = smin >= 0.0f;
    sgn[q] = pos ? 1.0f : -1.0f;
    absdet[q] = det * sgn[q];
    r[q].elig = (pos || smax <= 0.0f) && absdet[q] > DET_EPS;
    r[q].t = 0.0f;
    r[q].rcps = 0.0f;
    any = any || r[q].elig;
  }
  if (__any_sync(FULL, any)) {
#pragma unroll
    for (int q = 0; q < PAIR; ++q) {
      const float4 x = g4[q * REC / 4 + 5];
      // row D: ((D0 m0 + D1 m1) + D2 m2), its six zeros, D9 m9
      const float qn = (((c[q][18] * m[0] + c[q][19] * m[1]) + x.x * m[2]) +
                        z.d) + x.y * m[9];
      const float rcp = 1.0f / (r[q].elig ? absdet[q] : 1.0f);
      r[q].t = qn * sgn[q] * rcp;
      r[q].rcps = sgn[q] * rcp;
    }
  }
}

// the first set bit at index >= from of a window's mask, or -1
__device__ __forceinline__ int next_bit(const unsigned bm[NW], int from) {
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const int lo = from - 32 * q;
    const unsigned x =
        bm[q] & (lo <= 0 ? FULL : lo >= 32 ? 0u : (FULL << lo));
    if (x) return 32 * q + __ffs(x) - 1;
  }
  return -1;
}

__device__ __forceinline__ void stage_records(float* dst, const float* src) {
  for (int i = threadIdx.x; i < STAGE / 4; i += LANES)
    cp_async16_ca(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

// the records of window cluster j
__device__ __forceinline__ const float* records(const float* rec,
                                                const int* sc, int j) {
  return rec + ((size_t)sc[j / SC_GROUP] * SC_GROUP + j % SC_GROUP) * STAGE;
}

// One block of 128 threads walks one row, a thread per lane; 80 registers
// a thread keep 6 rows an SM.
template <bool ANY>
__global__ void __launch_bounds__(LANES, 6)
cluster_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
               const int* __restrict__ counts, const float* __restrict__ rec,
               const float* __restrict__ aabb,
               const int* __restrict__ tri_start, int C_s,
               float* __restrict__ out_t, float* __restrict__ out_u,
               float* __restrict__ out_v, int* __restrict__ out_p,
               int* __restrict__ out_occ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V1Smem& sh = *reinterpret_cast<V1Smem*>(smem_raw);
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int warp = l / 32;
  const int tile = r / BM;
  const float* p = rays + (size_t)r * 8 * LANES + l;
  float o[3], d[3], inv[3];
#pragma unroll
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
  const Zeros z = lane_zeros(m);
  float tb = mx, ub = 0.0f, vb = 0.0f;
  int pb = -1;
  bool occ = false;
  const int* list = ids + (size_t)tile * C_s;
  const int n_sc = counts[tile];
  int s = 0;                     // the buffer of the current candidate
  int fp = 0;                    // the parity of the vote flags
  bool done = false;
  for (int w0 = 0; w0 < n_sc && !done; w0 += WIN_SC) {
    const int wsc = min(WIN_SC, n_sc - w0);
    const int wp = (w0 / WIN_SC) & 1;
    // every thread is past the last window's reads of box and sc: the
    // last candidate's vote read them before its barrier
    if (l < wsc) sh.sc[l] = list[w0 + l];
    for (int i = l; i < wsc * SC_GROUP * BOX / 4; i += LANES)
      cp_async16_ca(sh.box + 4 * i,
                    aabb + (size_t)list[w0 + i / (SC_GROUP * BOX / 4)] *
                               SC_GROUP * BOX +
                        4 * (i % (SC_GROUP * BOX / 4)));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();             // the window's boxes and ids staged
    const int nc = wsc * SC_GROUP;
    unsigned bm[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      unsigned b = 0;
      for (int j = 32 * q; j < min(nc, 32 * q + 32); ++j)
        if (slab(sh.box + j * BOX, o, inv, mn, mx)) b |= 1u << (j - 32 * q);
      b = __reduce_or_sync(FULL, b);
      if (l % 32 == 0) sh.mask[wp][q][warp] = b;
    }
    __syncthreads();             // the window's masks
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      bm[q] = 0;
      for (int w = 0; w < WARPS; ++w) bm[q] |= sh.mask[wp][q][w];
    }
    int j = next_bit(bm, 0);
    if (j >= 0) stage_records(sh.stage[s], records(rec, sh.sc, j));
    while (j >= 0) {
      const int cl = sh.sc[j / SC_GROUP] * SC_GROUP + j % SC_GROUP;
      const bool vote = ANY ? !occ && mn < mx
                            : slab(sh.box + j * BOX, o, inv, mn, tb);
      const bool flag = __any_sync(FULL, vote);
      if (l % 32 == 0) sh.flag[fp][warp] = flag;
      cp_async_wait_all();       // this thread's copies of candidate j
      __syncthreads();           // flags set, records visible, the last
                                 // candidate's tests done
      // the row's vote; any hit: a lane that can still be occluded, on a
      // cluster the window's masks (the slabs at maxt) admit
      bool rv = false;
      for (int w = 0; w < WARPS; ++w) rv |= sh.flag[fp][w];
      if (ANY && !rv) {          // no lane of the row can change
        done = true;
        break;
      }
      const int jn = next_bit(bm, j + 1);
      if (jn >= 0) stage_records(sh.stage[s ^ 1], records(rec, sh.sc, jn));
      const float* cur = sh.stage[s];
      if (ANY) {                 // every candidate is a vote of the row
        const bool can = !occ && mn < mx;
        if (__any_sync(FULL, can)) {
          bool hit = false;
          for (int k0 = 0; k0 < CLUSTER_K; k0 += 8) {
            if (__all_sync(FULL, hit || !can)) break;
#pragma unroll 1
            for (int k = k0; k < k0 + 8; k += PAIR) {
              Plucker h[PAIR];
              plucker(cur + k * REC, m, z, h);
#pragma unroll
              for (int q = 0; q < PAIR; ++q)
                hit = hit || (h[q].elig && h[q].t > mn && h[q].t < mx);
            }
          }
          occ = occ || hit;
        }
      } else if (rv) {
        // a lane changes its record only by a passing test (mint < tb)
        // or by the miss sentinel BIG below tb
        if (__any_sync(FULL, mn < tb || BIG < tb)) {
          float bt = BIG, bu = 0.0f, bvv = 0.0f;
          int bk = NO_K;
#pragma unroll 1
          for (int k = 0; k < CLUSTER_K; k += PAIR) {
            Plucker h[PAIR];
            plucker(cur + k * REC, m, z, h);
#pragma unroll
            for (int q = 0; q < PAIR; ++q) {
              if (h[q].elig && h[q].t > mn && h[q].t < tb && h[q].t < bt) {
                bt = h[q].t;
                bk = k + q;
                bu = h[q].p1 * h[q].rcps;
                bvv = h[q].p2 * h[q].rcps;
              }
            }
          }
          if (bt < tb) {
            tb = bt;
            ub = bu;
            vb = bvv;
            pb = tri_start[cl] + bk;
          }
        }
      }
      s ^= 1;
      fp ^= 1;
      j = jn;
    }
  }
  cp_async_wait_all();
  const size_t at = (size_t)r * LANES + l;
  if (ANY) {
    out_occ[at] = occ ? 1 : 0;
  } else {
    out_t[at] = tb;
    out_u[at] = ub;
    out_v[at] = vb;
    out_p[at] = pb;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <bool ANY>
static cudaError_t v1_prepare() {
  constexpr int DEVICES = 64;
  static bool ready[DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !ready[dev]) {
    e = cudaFuncSetAttribute(cluster_kernel<ANY>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    ready[dev] = e == cudaSuccess;
  }
  return e;
}

template <bool ANY>
static int v1_launch(const float* rays, const int* ids, const int* counts,
                     const float* rec, const float* aabb,
                     const int* tri_start, int R, int C_s, float* out_t,
                     float* out_u, float* out_v, int* out_p, int* out_occ,
                     cudaStream_t stream) {
  const cudaError_t e = v1_prepare<ANY>();
  if (e != cudaSuccess) return (int)e;
  cluster_kernel<ANY><<<R, LANES, sizeof(V1Smem), stream>>>(
      rays, ids, counts, rec, aabb, tri_start, C_s, out_t, out_u, out_v,
      out_p, out_occ);
  return (int)cudaGetLastError();
}

extern "C" int mts_cluster(const float* rays, const int* ids,
                           const int* counts, const float* rec,
                           const float* aabb, const int* tri_start, int R,
                           int C_s, int any_hit, float* out_t, float* out_u,
                           float* out_v, int* out_p, int* out_occ,
                           void* stream) {
  if (R <= 0) return 0;
  if (R % BM) return (int)cudaErrorInvalidValue;
  // cp.async copies 16-byte pieces of the records and boxes
  if (((size_t)rec | (size_t)aabb) % 16) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  return any_hit ? v1_launch<true>(rays, ids, counts, rec, aabb, tri_start,
                                   R, C_s, out_t, out_u, out_v, out_p,
                                   out_occ, s)
                 : v1_launch<false>(rays, ids, counts, rec, aabb, tri_start,
                                    R, C_s, out_t, out_u, out_v, out_p,
                                    out_occ, s);
}

template <bool ANY>
static int v1_info(int* out) {
  cudaError_t e = v1_prepare<ANY>();
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, cluster_kernel<ANY>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], cluster_kernel<ANY>, LANES, sizeof(V1Smem));
  out[1] = e == cudaSuccess ? attr.numRegs : 0;
  out[2] = (int)sizeof(V1Smem);
  out[3] = e == cudaSuccess ? (int)attr.localSizeBytes : 0;
  return (int)e;
}

// the kernel's resources: out[0] rows (blocks) resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] shared memory bytes per row, out[3] local memory bytes
// per thread (spills)
extern "C" int mts_cluster_info(int any_hit, int* out) {
  return any_hit ? v1_info<true>(out) : v1_info<false>(out);
}
