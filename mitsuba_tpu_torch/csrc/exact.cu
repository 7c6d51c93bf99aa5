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
// refine / child_refine compute, for each listed box of a row, the smallest
// slab entry distance over the row's 128 lanes (BIG where no lane hits);
// only the live prefix of each row's list is tested, the rest reads BIG
// without a load. What bounds them on this card: issuing the slab tests,
// 27 instructions a test with the bits fixed (12 adds and products, 12 min
// / max, the compare and select, the lane's min), none a fused
// multiply-add, so the bound's 67 TFLOP/s (two operations a lane and
// clock) is out of their reach; loads from shared memory must not add to
// them. The design: one 128-thread block per row, 6 rows per SM (80
// registers); the row's live lanes (maxt < mint is dead) compacted, each
// thread holding up to 4 of them in registers, so a box read once (two
// broadcast 16-byte loads) serves 128 tests; the list's live entries
// staged 128 at a time by cp.async into two buffers, the next tile loading
// while this one is tested, one barrier a tile (#6: a child as two
// 16-byte copies from its 512-byte table row; #5: six 4-byte copies from
// blo and bhi); warp w tests entries w, w + 4, ..., two at a time, and
// reduces each entry by one redux.sync.min.
// Exact: every lane's key is the plain version's, operation for operation.
// A dead lane's key is BIG for every box (tn >= mint > maxt >= tf), so
// leaving it out changes no minimum; no NaN reaches the minimum (a NaN tn
// fails tn <= tf and reads BIG in both versions). The minimum is taken over
// integer codes, in any order: a key's bits where every lane has mint > 0
// (every key is then positive), else a code in the keys' order that ties
// -0.0 with +0.0 and breaks the tie by the lane's rank (`tie_rank`), so
// that a tie of zeros keeps the zero torch.amin keeps on the card (held on
// planted ties by tests/torch_refine_cases.py).
//
// The item walks. #7 (v5) walks each row's front-to-back list of E3 K8
// clusters (8 triangles) in steps of 16 (BI), keyed by blk_tn; #9 (v6b)
// its list of E2 L1 blocks (64 triangles: 8 consecutive K8 clusters of
// `tri`) in steps of blm, keyed by each step's first L1. Both test all of
// a tested step's triangles, dead slots (id 0) included, under the bound
// of the step's start, and keep a running winner per sublane across the
// step (strict <), then the lowest sublane among equal t, then strict <
// against the lane's best (exact_pallas.py:600-619, 877-901): one walk,
// `step_walk`, over groups of 8 or 64 records. #8 (v6) visits the L1
// blocks one at a time, slab-tests each lane's 8 K8 children (the `ct0`
// table) against [mint, maxt], and runs Moeller-Trumbore on all 128 lanes
// for each child some lane of the row admits, merging child by child (the
// lowest sublane among the child's nearest hits, then strict < against
// the lane's best). Every walk skips a step whose key exceeds every lane's
// bound: its best t (closest), or maxt, and mint - 1 once occluded (any
// hit, so that an occluded row skips; :561-587).
//
// What bounds them on this card: the Moeller-Trumbore work, 53 float32
// operations and an IEEE division per (triangle, lane), and for #8 also
// the box tests, 25 a child and lane. #8 tests about one child (8
// triangles) a tested L1 block, on all 128 lanes of the row, some thirty
// times what the lanes' own slabs admit; its steps are short, so what a
// step costs beyond its tests weighs too. The first versions of #7
// and #8 spent it on two to eleven block barriers a step (a block max,
// staging, a vote a child), ten scalar loads to stage a triangle and nine
// to read it, one chain of tests a thread, and tests of lanes that could
// no longer change a record. The design: one 128-thread block per row, 8
// rows resident per SM; the row's ids and step keys staged once into
// shared memory; a step's 64-byte records staged by cp.async into two
// buffers, the next chunk loading while this one is tested: the step's
// next, or the next step's first (#8: the next L1 block's records, and
// its child boxes into each warp's own copy), which is the step tested
// next unless the bound skips it; #7's and #9's records are also kept in
// L1, where neighbouring camera rows of an SM find them; one barrier a
// chunk, the last one of a step also carrying each warp's largest bound
// (#8: and each warp's OR of its lanes' 8-bit admission masks of the next
// L1 block, computed from its copy once this one is tested, with no
// barrier of its own), from which every warp finds the next step to
// test with ballots over 32 keys at a time, so a step the bound skips
// costs no barrier; a test reads its record as three 16-byte loads, and
// a thread runs two tests at a time and merges them in order. A warp none
// of whose lanes has mint < its cap skips the tests (#8: child by child,
// its caps only shrinking), and an any-hit warp stops at a cluster's (#8: a
// child's) start once each of its lanes has hit or cannot: no test of
// such a lane can pass its cap, so no record changes. Exact: every other
// lane meets the step's triangles in the plain version's order under the
// same cap (#8: its current cap, which only refuses hits that the strict
// merge would refuse), each step is tested on the plain version's vote
// `key <= max over lanes of bound` (fmaxf leaves out a NaN bound, as the
// vote does), and #8 tests the children the row admits, not those of the
// warp's own lanes: a lane outside a child's slab still meets its hits.
//
// Rounding: compiled with --fmad=false and IEEE division; every
// expression keeps the plain version's operation order.

#include <cuda_runtime.h>

#include "async_copy.cuh"
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

// ---------------------------------------------------------------------------
// refine (#5) and child_refine (#6): a row a block, 4 lanes a thread
// ---------------------------------------------------------------------------

#define RF_TILE 128            // entries a tile: one staged per thread
#define RF_ILP 2               // entries a warp tests at once
#define RF_ROWS_PER_SM 6       // resident rows the register budget allows
#define ZERO_BAND 256          // key codes of the zeros: [-255, 0]
#define FULL_MASK 0xffffffffu

// one staged box: a = lo.xyz | hi.x, b = hi.yz | two floats unused (the
// child tables' lanes 0:8, or #5's lo and hi)
struct __align__(16) Box {
  float4 a, b;
};

// the row's live lanes, compacted: planes o.xyz | inv.xyz | mint | maxt
// and each lane's index in the row
struct Compact {
  float ray[8][LANES];
  int lane[LANES];
};

// the rank of a lane among those whose keys tie at a zero: the plain
// version's torch.amin keeps the zero of the lane of highest rank. Its
// reduction over 128 lanes (ATen/native/cuda/Reduce.cuh): thread t of a
// warp folds lanes 4t..4t+3 in order, then a shuffle-down tree with
// offsets 16, 8, 4, 2, 1 combines the threads, and each combine keeps its
// second operand on a tie (`a < b ? a : b`): the thread's bit 0 weighs
// most, then bits 1-4, then the lane's place in the thread's four.
__device__ __forceinline__ int tie_rank(int lane) {
  return (int)(__brev((unsigned)lane >> 2) >> 27) << 2 | (lane & 3);
}

// a key's code: an integer in the keys' order, -0.0 and +0.0 tied and
// broken by zr = the lane's rank << 1: positive keys above ZERO_BAND,
// negative ones below -ZERO_BAND, zeros in between, the highest rank
// lowest
__device__ __forceinline__ int key_code(float key, int zr) {
  const int b = __float_as_int(key);
  if ((b << 1) == 0) return -(zr | (int)((unsigned)b >> 31));
  return b >= 0 ? b + ZERO_BAND : (b ^ 0x7fffffff) - ZERO_BAND;
}

__device__ __forceinline__ float code_key(int c) {
  if (c > ZERO_BAND) return __int_as_float(c - ZERO_BAND);
  if (c < -ZERO_BAND) return __int_as_float((c + ZERO_BAND) ^ 0x7fffffff);
  return __int_as_float((int)((unsigned)(-c & 1) << 31));
}

// the row's compacted live lanes l, l + 32, ..., l + 32 (K - 1) that
// lane l of every warp holds; past the live ones, dead lanes (mint 1 >
// maxt -1)
template <int K>
struct Lanes {
  float o[K][3], inv[K][3], mn[K], mx[K];
  int zr[K];                   // tie_rank << 1
};

// this lane's slab entry distance of a box, BIG where its interval is
// empty (the plain version's operation order)
__device__ __forceinline__ float slab_key(const Box& bx, const float o[3],
                                          const float inv[3], float mn,
                                          float mx) {
  const float lo[3] = {bx.a.x, bx.a.y, bx.a.z};
  const float hi[3] = {bx.a.w, bx.b.x, bx.b.y};
  float tn = mn, tf = mx;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float t0 = (lo[j] - o[j]) * inv[j];
    const float t1 = (hi[j] - o[j]) * inv[j];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  return tn <= tf ? tn : BIG;
}

// this thread's entry of the tile starting at t0: #6's child (e & 7) of
// parent ids[e >> 3], lanes 0:8 of its 512-byte table row by two 16-byte
// copies; #5's box ids[e], six 4-byte copies from blo and bhi
template <bool CHILD>
__device__ __forceinline__ void stage_tile(const int* ids, const float* blo,
                                           const float* bhi, const float* tab,
                                           int t0, int n, Box* buf) {
  const int e = t0 + threadIdx.x;
  if (e < n) {
    Box& dst = buf[threadIdx.x];
    if (CHILD) {
      const float* src = tab + ((size_t)ids[e >> 3] * 8 + (e & 7)) * LANES;
      cp_async16(&dst.a, src);
      cp_async16(&dst.b, src + 4);
    } else {
      const size_t b = 3 * (size_t)ids[e];
      float* d = reinterpret_cast<float*>(&dst);
      for (int j = 0; j < 3; ++j) {
        cp_async4(d + j, blo + b + j);
        cp_async4(d + 3 + j, bhi + b + j);
      }
    }
  }
  cp_async_commit();
}

// the keys of a tile's nt entries: warp w takes entries w, w + 4, ...,
// RF_ILP at a time (past nt it tests stale boxes of the tile's buffer and
// drops their codes); an entry's code is the least over the thread's K
// lanes, then over the warp's by one redux (the least of integers, in any
// order), and lane j keeps that of the warp's j-th entry. FAST: every
// lane has mint > 0, so every key is positive and its bits order it.
template <int K, bool FAST>
__device__ __forceinline__ void test_tile(const Box* bx, int nt,
                                          const Lanes<K>& ln, float* out) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  constexpr int WARPS = LANES / 32;
  int res = 0, j = 0;
  for (int e = w; e < nt; e += WARPS * RF_ILP, j += RF_ILP) {
    int c[RF_ILP];
#pragma unroll
    for (int q = 0; q < RF_ILP; ++q) {
      const Box b = bx[min(e + WARPS * q, RF_TILE - 1)];
      c[q] = 0x7fffffff;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float key = slab_key(b, ln.o[k], ln.inv[k], ln.mn[k], ln.mx[k]);
        c[q] = min(c[q], FAST ? __float_as_int(key) : key_code(key, ln.zr[k]));
      }
    }
#pragma unroll
    for (int q = 0; q < RF_ILP; ++q) {
      const int m = __reduce_min_sync(FULL_MASK, c[q]);
      if (l == j + q) res = FAST ? m + ZERO_BAND : m;
    }
  }
  const int mine = w + WARPS * l;            // this lane's entry
  if (mine < nt) out[mine] = code_key(res);
}

// the tiles of a row whose live lanes (total of them) fill K slots of
// every thread's; ids is the row's list, n its live prefix
template <bool CHILD, int K>
__device__ __forceinline__ void refine_tiles(const Compact& cmp, int total,
                                             const int* ids, int n,
                                             const float* blo,
                                             const float* bhi,
                                             const float* tab,
                                             Box (*buf)[RF_TILE],
                                             float* out) {
  Lanes<K> ln;
  bool pos = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (threadIdx.x & 31) + 32 * k;
    const bool live = c < total;
    for (int j = 0; j < 3; ++j) {
      ln.o[k][j] = live ? cmp.ray[j][c] : 0.0f;
      ln.inv[k][j] = live ? cmp.ray[3 + j][c] : 0.0f;
    }
    ln.mn[k] = live ? cmp.ray[6][c] : 1.0f;
    ln.mx[k] = live ? cmp.ray[7][c] : -1.0f;
    ln.zr[k] = live ? tie_rank(cmp.lane[c]) << 1 : 0;
    pos = pos && ln.mn[k] > 0.0f;
  }
  // every warp holds the same lanes: the choice is the block's
  const bool fast = __all_sync(FULL_MASK, pos);
  int i = 0;
  for (int t0 = 0; t0 < n; t0 += RF_TILE, ++i) {
    cp_async_wait_all();
    __syncthreads();         // tile i staged; tile i - 1's boxes free
    if (t0 + RF_TILE < n)
      stage_tile<CHILD>(ids, blo, bhi, tab, t0 + RF_TILE, n,
                        buf[(i + 1) & 1]);
    const int nt = min(RF_TILE, n - t0);
    if (fast)
      test_tile<K, true>(buf[i & 1], nt, ln, out + t0);
    else
      test_tile<K, false>(buf[i & 1], nt, ln, out + t0);
  }
}

// one row: the keys out[0:n_out] of its list, n the live prefix; ids is
// the row's list (#5: box ids, #6: parent ids)
template <bool CHILD>
__device__ __forceinline__ void refine_row(const float* rays, const int* ids,
                                           int n, const float* blo,
                                           const float* bhi, const float* tab,
                                           int n_out, float* out) {
  __shared__ Box buf[2][RF_TILE];
  __shared__ Compact cmp;
  __shared__ int warp_count[LANES / 32];
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  n = max(0, min(n, n_out));
  for (int e = n + t; e < n_out; e += LANES) out[e] = BIG;
  if (n == 0) return;
  // compact the live lanes: a lane with maxt < mint has tn >= mint > maxt
  // >= tf for every box, so its key is BIG and it is left out
  Row ry;
  load_row(rays, ry);
  const bool alive = !(ry.mx < ry.mn);
  const unsigned ball = __ballot_sync(FULL_MASK, alive);
  if (l == 0) warp_count[w] = __popc(ball);
  __syncthreads();
  int pos = __popc(ball & ((1u << l) - 1)), total = 0;
  for (int i = 0; i < LANES / 32; ++i) {
    pos += i < w ? warp_count[i] : 0;
    total += warp_count[i];
  }
  if (total == 0) {                          // no live lane: every key BIG
    for (int e = t; e < n; e += LANES) out[e] = BIG;
    return;
  }
  if (alive) {
    for (int j = 0; j < 3; ++j) {
      cmp.ray[j][pos] = ry.o[j];
      cmp.ray[3 + j][pos] = ry.inv[j];
    }
    cmp.ray[6][pos] = ry.mn;
    cmp.ray[7][pos] = ry.mx;
    cmp.lane[pos] = t;
  }
  stage_tile<CHILD>(ids, blo, bhi, tab, 0, n, buf[0]);
  __syncthreads();
  switch ((total + 31) >> 5) {              // live lanes a thread holds
    case 1:
      refine_tiles<CHILD, 1>(cmp, total, ids, n, blo, bhi, tab, buf, out);
      break;
    case 2:
      refine_tiles<CHILD, 2>(cmp, total, ids, n, blo, bhi, tab, buf, out);
      break;
    case 3:
      refine_tiles<CHILD, 3>(cmp, total, ids, n, blo, bhi, tab, buf, out);
      break;
    default:
      refine_tiles<CHILD, 4>(cmp, total, ids, n, blo, bhi, tab, buf, out);
  }
}

__global__ void __launch_bounds__(LANES, RF_ROWS_PER_SM)
refine_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
              const int* __restrict__ live, const float* __restrict__ blo,
              const float* __restrict__ bhi, int E, float* __restrict__ out) {
  const size_t r = blockIdx.x;
  refine_row<false>(rays, ids + r * E, live[r], blo, bhi, nullptr, E,
                    out + r * E);
}

__global__ void __launch_bounds__(LANES, RF_ROWS_PER_SM)
child_refine_kernel(const float* __restrict__ rays,
                    const int* __restrict__ pids,
                    const int* __restrict__ live_p,
                    const float* __restrict__ tab, int Ep,
                    float* __restrict__ out) {
  const size_t r = blockIdx.x;
  const int np = max(0, min(live_p[r], Ep));
  refine_row<true>(rays, pids + r * Ep, np * 8, nullptr, nullptr, tab,
                   Ep * 8, out + r * Ep * 8);
}

// ---------------------------------------------------------------------------
// The item walks: #7 (v5) and #9 (v6b), steps of whole groups of records
// in chunks of WALK_CHUNK; #8 (v6), an L1 block a step, its children
// admitted row-wide
// ---------------------------------------------------------------------------

#define WALK_CHUNK 128            // records a chunk: one staged per thread
#define WALK_ROWS_PER_SM 8        // resident rows the register budget allows
#define L1_RECS 64                // records of an L1 block

// one staged triangle: its 16-float record of `tri` (v0 | e1 | e2 in
// fields 0-8, the prim's bits in field 15), read as float4s
struct __align__(16) Rec {
  float4 q[4];
};

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

// this thread's share of chunk c of a step whose groups are ids[0:]:
// triangle m is record m % G of group ids[m / G], G consecutive records
// of `tri` (G = 8: a K8 cluster; 64: an L1 block), one 64-byte record by
// four 16-byte copies, kept in L1 for the SM's other rows (neighbouring
// camera rows read the same clusters)
template <int G>
__device__ __forceinline__ void stage_chunk(const float* tri, const int* ids,
                                            int c, int n_tri, Rec* dst) {
  const int m = c * WALK_CHUNK + threadIdx.x;
  if (m < n_tri) {
    const float* src = tri + ((size_t)ids[m / G] * G + m % G) * LANES;
    for (int i = 0; i < 4; ++i)
      cp_async16_ca(&dst[threadIdx.x].q[i], src + 4 * i);
  }
  cp_async_commit();
}

__device__ __forceinline__ bool mt_rec(const Rec& r, const Row& ry,
                                       float cap, float& t, float& u,
                                       float& v) {
  return mt_test4(r.q[0], r.q[1], r.q[2], ry.o, ry.d, ry.mn, cap, DET_EPS, t,
                  u, v);
}

// closest: take hit (t, u, v) of sublane s at the next position of the
// step if it is the lexicographic (t, sublane, position) minimum so far
__device__ __forceinline__ void take(bool ok, float t, float u, float v,
                                     int s, const Rec& r, Best& h, int& hs) {
  if (ok && (t < h.t || (t == h.t && s < hs))) {
    h = {t, u, v, __float_as_int(r.q[3].w)};
    hs = s;
  }
}

// the largest bound of this warp's lanes, kept by its first lane in
// red[warp] (fmaxf leaves a NaN bound out, as the vote `key <= bound`
// does)
__device__ __forceinline__ void warp_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
}

// the row's largest bound, once a barrier follows every warp's warp_max
__device__ __forceinline__ float row_max(const float* red) {
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

// the first step s of [from, n) whose key is within bmax, else n: the
// block-wide vote "key <= some lane's bound" of each step from `from` on
// while the bounds stay as they are; a warp scans 32 keys at once, and
// every warp reads the same keys and bmax, so all find the same step
__device__ __forceinline__ int next_step(const float* skey, int from, int n,
                                         float bmax) {
  const int l = threadIdx.x & 31;
  for (int b = from; b < n; b += 32) {
    const unsigned ok =
        __ballot_sync(FULL_MASK, b + l < n && skey[b + l] <= bmax);
    if (ok) return b + __ffs(ok) - 1;
  }
  return n;
}

// dynamic shared memory of #7 and #9: two chunk buffers, the row's list
// of E group ids and its n_steps step keys
__host__ __device__ __forceinline__ size_t walk_smem(int E, int n_steps) {
  return 2 * WALK_CHUNK * sizeof(Rec) + (size_t)E * sizeof(int) +
         (size_t)n_steps * sizeof(float);
}

// #7 and #9: a row walks its list ids[r * E:] of groups of G records in
// steps of blm groups; step s's key is keys[r * key_row + s * key_step]
template <int G, bool ANY>
__device__ __forceinline__ void step_walk(const float* rays, const int* ids,
                                          int E, const float* keys,
                                          int key_row, int key_step,
                                          const float* tri, int blm,
                                          float* out_t, float* out_u,
                                          float* out_v, int* out_p,
                                          int* out_occ) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][LANES / 32];
  Rec* buf = reinterpret_cast<Rec*>(smem);                 // [2][WALK_CHUNK]
  int* sid = reinterpret_cast<int*>(buf + 2 * WALK_CHUNK);  // [E]
  const int n_steps = E / blm;
  float* skey = reinterpret_cast<float*>(sid + E);         // [n_steps]
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int n_tri = blm * G;                // records a step
  const int n_chunks = (n_tri + WALK_CHUNK - 1) / WALK_CHUNK;
  for (int i = l; i < E; i += LANES) sid[i] = ids[(size_t)r * E + i];
  for (int i = l; i < n_steps; i += LANES)
    skey[i] = keys[(size_t)r * key_row + (size_t)i * key_step];
  Row ry;
  load_row(rays, ry);
  Best best = {ry.mx, 0.0f, 0.0f, -1};
  bool occ = false;
  // the first step tested: the ordered skip on each step's key against
  // the row's bound (maxt at the start)
  warp_max(ry.mx, red[0]);
  __syncthreads();
  int s = next_step(skey, 0, n_steps, row_max(red[0]));
  int p = 1;                    // red[p]: the next bound's maxima
  int cur = 0;                  // the buffer of the next chunk tested
  bool ready = false;           // chunk 0 of step s staged and visible
  if (s < n_steps) stage_chunk<G>(tri, sid + s * blm, 0, n_tri, buf);
  while (s < n_steps) {
    const int* gids = sid + s * blm;
    // the step's cap; no test of a lane with mint >= cap can pass it
    const float cap = ANY ? (occ ? ry.mn : ry.mx) : best.t;
    const bool live = ry.mn < cap;
    const bool warp_live = __any_sync(FULL_MASK, live);
    Best h = {BIG, 0.0f, 0.0f, 0};
    int hs = 8;
    bool hit = false;
    for (int c = 0; c < n_chunks; ++c) {
      if (c > 0 || !ready) {
        cp_async_wait_all();
        __syncthreads();     // chunk c staged; the other buffer free
      }
      // the next chunk loads while this one is tested: this step's, or
      // the next step's first (the step it tests unless the bound skips
      // it)
      Rec* nxt = buf + (cur ^ 1) * WALK_CHUNK;
      if (c + 1 < n_chunks)
        stage_chunk<G>(tri, gids, c + 1, n_tri, nxt);
      else if (s + 1 < n_steps)
        stage_chunk<G>(tri, gids + blm, 0, n_tri, nxt);
      const Rec* st = buf + cur * WALK_CHUNK;
      cur ^= 1;
      if (!warp_live) continue;
      const int nk = min(WALK_CHUNK, n_tri - c * WALK_CHUNK);
      for (int k0 = 0; k0 < nk; k0 += 8) {  // a K8 cluster, sublanes 0-7
        if (ANY && __all_sync(FULL_MASK, hit || !live)) break;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {    // two tests, then in order
          float t0, u0, v0, t1, u1, v1;
          const bool ok0 = mt_rec(st[k0 + j], ry, cap, t0, u0, v0);
          const bool ok1 = mt_rec(st[k0 + j + 1], ry, cap, t1, u1, v1);
          if (ANY) {
            hit = hit || ok0 || ok1;
          } else {
            take(ok0, t0, u0, v0, j, st[k0 + j], h, hs);
            take(ok1, t1, u1, v1, j + 1, st[k0 + j + 1], h, hs);
          }
        }
      }
    }
    if (ANY)
      occ = occ || hit;
    else if (h.t < best.t)
      best = h;
    // the next step tested, behind one barrier, after which the next
    // step's first chunk is visible too (any hit: the bound is mint - 1
    // once occluded, so an occluded row skips)
    warp_max(ANY ? (occ ? ry.mn - 1.0f : ry.mx) : best.t, red[p]);
    cp_async_wait_all();
    __syncthreads();
    const int ns = next_step(skey, s + 1, n_steps, row_max(red[p]));
    p ^= 1;
    ready = ns == s + 1;
    if (!ready && ns < n_steps)  // a skip: stage the step tested instead
      stage_chunk<G>(tri, sid + ns * blm, 0, n_tri, buf + cur * WALK_CHUNK);
    s = ns;
  }
  store_hit(best, occ, ANY, out_t, out_u, out_v, out_p, out_occ);
}

template <bool ANY>
__global__ void __launch_bounds__(LANES, WALK_ROWS_PER_SM)
items_kernel(const float* __restrict__ rays, const int* __restrict__ ids,
             const float* __restrict__ blk_tn,
             const float* __restrict__ tri, int E3, float* __restrict__ out_t,
             float* __restrict__ out_u, float* __restrict__ out_v,
             int* __restrict__ out_p, int* __restrict__ out_occ) {
  step_walk<8, ANY>(rays, ids, E3, blk_tn, E3 / BI, 1, tri, BI, out_t, out_u,
                    out_v, out_p, out_occ);
}

template <bool ANY>
__global__ void __launch_bounds__(LANES, WALK_ROWS_PER_SM)
l1_masked_kernel(const float* __restrict__ rays,
                 const int* __restrict__ l1_ids,
                 const float* __restrict__ l1_keys,
                 const float* __restrict__ tri, int E2, int blm,
                 float* __restrict__ out_t, float* __restrict__ out_u,
                 float* __restrict__ out_v, int* __restrict__ out_p,
                 int* __restrict__ out_occ) {
  step_walk<64, ANY>(rays, l1_ids, E2, l1_keys, E2, blm, tri, blm, out_t,
                     out_u, out_v, out_p, out_occ);
}

// #8: a warp's copy of an L1 block's 8 child boxes (ct0 lanes 0:8 of each
// child's row, two float4s)
struct __align__(16) Boxes {
  float4 q[16];
};

// #8: stage L1 block id: lanes 0-15 of each warp copy its 8 child boxes
// into the warp's own copy, one group; then threads 0-63 its 64 records,
// one each by four 16-byte copies, another group
__device__ __forceinline__ void stage_l1(const float* tri, const float* ct0,
                                         int id, Rec* dst, Boxes* box) {
  const int l = threadIdx.x, k = l & 31;
  if (k < 16)
    cp_async16(&box[l >> 5].q[k],
               ct0 + ((size_t)id * 8 + (k >> 1)) * LANES + 4 * (k & 1));
  cp_async_commit();
  if (l < L1_RECS) {
    const float* src = tri + ((size_t)id * L1_RECS + l) * LANES;
    for (int i = 0; i < 4; ++i) cp_async16(&dst[l].q[i], src + 4 * i);
  }
  cp_async_commit();
}

// #8: this lane's slab admission of the 8 children of its warp's staged
// boxes (lo.xyz | hi.x, hi.yz | -) against [mint, maxt], as bits 0-7, in
// the plain version's operation order; OR-ed over the warp into
// adm[warp]. The boxes' group must be complete in each lane of the warp
// (cp_async_wait): the warp's barrier makes its copies visible.
__device__ __forceinline__ void child_mask(const Boxes& bx, const Row& ry,
                                           unsigned* adm) {
  __syncwarp();
  unsigned m = 0;
#pragma unroll 2
  for (int c = 0; c < 8; ++c) {
    const float4 a = bx.q[2 * c], e = bx.q[2 * c + 1];
    const float lo[3] = {a.x, a.y, a.z};
    const float hi[3] = {a.w, e.x, e.y};
    float tn = ry.mn, tf = ry.mx;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float t0 = (lo[j] - ry.o[j]) * ry.inv[j];
      const float t1 = (hi[j] - ry.o[j]) * ry.inv[j];
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    m |= (unsigned)(tn <= tf) << c;
  }
  m = __reduce_or_sync(FULL_MASK, m);
  if ((threadIdx.x & 31) == 0) adm[threadIdx.x >> 5] = m;
}

// dynamic shared memory of #8: two L1 buffers, the row's L1 ids and keys
__host__ __device__ __forceinline__ size_t l1_smem(int E2) {
  return 2 * L1_RECS * sizeof(Rec) + (size_t)E2 * (sizeof(int) + sizeof(float));
}

template <bool ANY>
__global__ void __launch_bounds__(LANES, WALK_ROWS_PER_SM)
l1_items_kernel(const float* __restrict__ rays, const int* __restrict__ l1_ids,
                const float* __restrict__ l1_keys,
                const float* __restrict__ tri, const float* __restrict__ ct0,
                int E2, float* __restrict__ out_t, float* __restrict__ out_u,
                float* __restrict__ out_v, int* __restrict__ out_p,
                int* __restrict__ out_occ) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][LANES / 32];
  __shared__ unsigned adm[2][LANES / 32];    // per buffer: warps' masks
  __shared__ Boxes box[2][LANES / 32];       // per buffer: warps' copies
  Rec* buf = reinterpret_cast<Rec*>(smem);                // [2][L1_RECS]
  int* sid = reinterpret_cast<int*>(buf + 2 * L1_RECS);   // [E2]
  float* skey = reinterpret_cast<float*>(sid + E2);       // [E2]
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  for (int i = l; i < E2; i += LANES) {
    sid[i] = l1_ids[(size_t)r * E2 + i];
    skey[i] = l1_keys[(size_t)r * E2 + i];
  }
  Row ry;
  load_row(rays, ry);
  Best best = {ry.mx, 0.0f, 0.0f, -1};
  bool occ = false;
  const bool can = ry.mn < ry.mx;           // any hit: a test can pass maxt
  warp_max(ry.mx, red[0]);
  __syncthreads();
  int s = next_step(skey, 0, E2, row_max(red[0]));
  int p = 1;                    // red[p]: the next bound's maxima
  int cur = 0;                  // buf[cur], adm[cur]: L1 s
  const int w = l >> 5;
  if (s < E2) {
    stage_l1(tri, ct0, sid[s], buf, box[0]);
    cp_async_wait_all();
    child_mask(box[0][w], ry, adm[0]);
    __syncthreads();
  }
  while (s < E2) {
    // the children some lane of the row admits; every lane tests each
    const unsigned mask = adm[cur][0] | adm[cur][1] | adm[cur][2] |
                          adm[cur][3];
    const bool more = s + 1 < E2;
    // L1 s + 1 loads while L1 s is tested (the L1 tested next unless the
    // bound skips it)
    if (more)
      stage_l1(tri, ct0, sid[s + 1], buf + (cur ^ 1) * L1_RECS, box[cur ^ 1]);
    const Rec* st = buf + cur * L1_RECS;
    for (unsigned m = mask; m; m &= m - 1) {
      const Rec* ct = st + (__ffs(m) - 1) * 8;
      if (ANY) {
        // a lane that is occluded, or cannot hit, changes nothing more
        if (__all_sync(FULL_MASK, occ || !can)) break;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          float t0, u0, v0, t1, u1, v1;
          const bool ok0 = mt_rec(ct[j], ry, ry.mx, t0, u0, v0);
          const bool ok1 = mt_rec(ct[j + 1], ry, ry.mx, t1, u1, v1);
          hit = hit || ok0 || ok1;
        }
        occ = occ || hit;
      } else {
        // the caps only shrink: a warp with no lane below its cap is done
        if (!__any_sync(FULL_MASK, ry.mn < best.t)) break;
        Best h = {BIG, 0.0f, 0.0f, 0};     // the child's nearest, lowest
#pragma unroll                             // sublane first
        for (int j = 0; j < 8; j += 2) {
          float t0, u0, v0, t1, u1, v1;
          const bool ok0 = mt_rec(ct[j], ry, best.t, t0, u0, v0);
          const bool ok1 = mt_rec(ct[j + 1], ry, best.t, t1, u1, v1);
          if (ok0 && t0 < h.t) h = {t0, u0, v0, __float_as_int(ct[j].q[3].w)};
          if (ok1 && t1 < h.t)
            h = {t1, u1, v1, __float_as_int(ct[j + 1].q[3].w)};
        }
        if (h.t < best.t) best = h;
      }
    }
    // the next L1 tested and its children, behind one barrier, after
    // which its records are visible too
    if (more) {
      cp_async_wait<1>();                    // its boxes, not its records
      child_mask(box[cur ^ 1][w], ry, adm[cur ^ 1]);
    }
    warp_max(ANY ? (occ ? ry.mn - 1.0f : ry.mx) : best.t, red[p]);
    cp_async_wait_all();
    __syncthreads();
    const int ns = next_step(skey, s + 1, E2, row_max(red[p]));
    p ^= 1;
    cur ^= 1;
    if (ns != s + 1 && ns < E2) {   // a skip: stage and admit L1 ns instead
      stage_l1(tri, ct0, sid[ns], buf + cur * L1_RECS, box[cur]);
      cp_async_wait_all();
      child_mask(box[cur][w], ry, adm[cur]);
      __syncthreads();
    }
    s = ns;
  }
  store_hit(best, occ, ANY, out_t, out_u, out_v, out_p, out_occ);
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

// a kernel's resources: out[0] resident rows per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] shared memory bytes per row (static and dynamic)
static int kernel_info(const void* kern, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, LANES,
                                                      smem);
  out[1] = attr.numRegs;
  out[2] = (int)(attr.sharedSizeBytes + smem);
  return (int)e;
}

// the refine kernels' resources (kernel_info); child: #6, else #5
extern "C" int mts_refine_info(int child, int* out) {
  return kernel_info(child ? (const void*)child_refine_kernel
                           : (const void*)refine_kernel, 0, out);
}

// raise a walk's dynamic shared memory limit on the current device where
// a launch first needs more than the default allows (the static shared
// memory counts against the same 48 KB), once per kernel, device and size
template <auto KERN>
static cudaError_t smem_prepare(size_t smem) {
  constexpr int DEVICES = 64;
  static size_t smem_limit[DEVICES];
  if (smem <= 40 * 1024) return cudaSuccess;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && smem > smem_limit[dev]) {
    e = cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) smem_limit[dev] = smem;
  }
  return e;
}

template <auto KERN, typename... Args>
static int launch_walk(int R, size_t smem, void* stream, Args... args) {
  const cudaError_t e = smem_prepare<KERN>(smem);
  if (e != cudaSuccess) return (int)e;
  KERN<<<R, LANES, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <auto KERN>
static int walk_info(size_t smem, int* out) {
  const cudaError_t e = smem_prepare<KERN>(smem);
  if (e != cudaSuccess) return (int)e;
  return kernel_info((const void*)KERN, smem, out);
}

extern "C" int mts_items(const float* rays, const int* ids,
                         const float* blk_tn, const float* tri, int R,
                         int E3, int any_hit, float* out_t, float* out_u,
                         float* out_v, int* out_p, int* out_occ,
                         void* stream) {
  if (R <= 0) return 0;
  if (E3 % BI) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(E3, E3 / BI);
  if (any_hit)
    return launch_walk<items_kernel<true>>(R, smem, stream, rays, ids, blk_tn,
                                           tri, E3, out_t, out_u, out_v,
                                           out_p, out_occ);
  return launch_walk<items_kernel<false>>(R, smem, stream, rays, ids, blk_tn,
                                          tri, E3, out_t, out_u, out_v, out_p,
                                          out_occ);
}

extern "C" int mts_l1_items(const float* rays, const int* l1_ids,
                            const float* l1_keys, const float* tri,
                            const float* ct0, int R, int E2, int any_hit,
                            float* out_t, float* out_u, float* out_v,
                            int* out_p, int* out_occ, void* stream) {
  if (R <= 0) return 0;
  const size_t smem = l1_smem(E2);
  if (any_hit)
    return launch_walk<l1_items_kernel<true>>(R, smem, stream, rays, l1_ids,
                                              l1_keys, tri, ct0, E2, out_t,
                                              out_u, out_v, out_p, out_occ);
  return launch_walk<l1_items_kernel<false>>(R, smem, stream, rays, l1_ids,
                                             l1_keys, tri, ct0, E2, out_t,
                                             out_u, out_v, out_p, out_occ);
}

extern "C" int mts_l1_masked(const float* rays, const int* l1_ids,
                             const float* l1_keys, const float* tri, int R,
                             int E2, int blm, int any_hit, float* out_t,
                             float* out_u, float* out_v, int* out_p,
                             int* out_occ, void* stream) {
  if (R <= 0) return 0;
  if (blm <= 0 || E2 % blm) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(E2, E2 / blm);
  if (any_hit)
    return launch_walk<l1_masked_kernel<true>>(R, smem, stream, rays, l1_ids,
                                               l1_keys, tri, E2, blm, out_t,
                                               out_u, out_v, out_p, out_occ);
  return launch_walk<l1_masked_kernel<false>>(R, smem, stream, rays, l1_ids,
                                              l1_keys, tri, E2, blm, out_t,
                                              out_u, out_v, out_p, out_occ);
}

// the walks' resources (kernel_info) at list width E3 (#7) or E2 (#8,
// and #9 at step width blm)
extern "C" int mts_items_info(int E3, int any_hit, int* out) {
  if (E3 % BI) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(E3, E3 / BI);
  return any_hit ? walk_info<items_kernel<true>>(smem, out)
                 : walk_info<items_kernel<false>>(smem, out);
}

extern "C" int mts_l1_items_info(int E2, int any_hit, int* out) {
  const size_t smem = l1_smem(E2);
  return any_hit ? walk_info<l1_items_kernel<true>>(smem, out)
                 : walk_info<l1_items_kernel<false>>(smem, out);
}

extern "C" int mts_l1_masked_info(int E2, int blm, int any_hit, int* out) {
  if (blm <= 0 || E2 % blm) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(E2, E2 / blm);
  return any_hit ? walk_info<l1_masked_kernel<true>>(smem, out)
                 : walk_info<l1_masked_kernel<false>>(smem, out);
}
