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
// occluded). v6 trades a box test per child and lane and a block-wide
// vote for skipping children.
//
// v6b takes steps of blm L1s with one skip on the step's first key and
// tests all blm * 64 triangles of the step, dead slots (L1 id 0)
// included, capped by the bound of the step's start; it keeps #7's
// running winner per sublane across the whole step, then the lowest
// sublane, then strict < against the lane's best (exact_pallas.py:
// 877-901). What bounds it on this card: the Moeller-Trumbore work, 53
// float32 operations and an IEEE division per (triangle, lane); a row
// per 4-warp block with two barriers and ten scalar shared loads per
// test reached a third of `mt_test`'s measured card ceiling. The design:
// one 128-thread block per row, 48-51 registers and 16-20 KB of shared
// memory, so 9-10 rows stay resident per SM; the row's L1 ids and step
// keys are staged once; a step's triangles come in chunks of 128 by
// cp.async into two buffers, the next chunk loading while this one is
// tested, behind one barrier a chunk; a triangle is its 64-byte record,
// read as three 16-byte loads; a thread runs two tests at a time and
// merges them in order. A warp none of whose lanes has mint < the step's
// cap skips the step's tests, and an any-hit warp stops, at a cluster's
// start, once each of its lanes has hit or cannot: no test of such a lane
// can pass its cap, so no record changes. Exact: every other lane meets
// the step's triangles in the plain version's order under the same cap,
// and each step is skipped or tested on the same block-wide vote.
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

// ---------------------------------------------------------------------------
// v6b (#9): steps of blm L1 blocks, staged in chunks of V6B_CHUNK triangles
// ---------------------------------------------------------------------------

#define V6B_CHUNK 128
#define V6B_ROWS_PER_SM 8         // resident rows the register budget allows

// one staged triangle: its 16-float record of `tri` (v0 | e1 | e2 in
// fields 0-8, the prim's bits in field 15), read as float4s
struct __align__(16) Rec {
  float4 q[4];
};

// this thread's share of chunk c of a step: triangle m = (L1 m / 64,
// cluster and sublane m % 64), one 64-byte record by four 16-byte copies
__device__ __forceinline__ void stage_chunk(const float* tri, const int* ids,
                                            int c, int n_tri, Rec* dst) {
  const int m = c * V6B_CHUNK + threadIdx.x;
  if (m < n_tri) {
    const float* src = tri + ((size_t)ids[m >> 6] * 64 + (m & 63)) * LANES;
    for (int i = 0; i < 4; ++i) cp_async16(&dst[threadIdx.x].q[i], src + 4 * i);
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

// dynamic shared memory of the v6b walk: two chunk buffers, the row's L1
// ids and its step keys
__host__ __device__ __forceinline__ size_t v6b_smem(int E2, int blm) {
  return 2 * V6B_CHUNK * sizeof(Rec) + (size_t)E2 * sizeof(int) +
         (size_t)(E2 / blm) * sizeof(float);
}

template <bool ANY>
__global__ void __launch_bounds__(LANES, V6B_ROWS_PER_SM)
l1_masked_kernel(const float* __restrict__ rays,
                 const int* __restrict__ l1_ids,
                 const float* __restrict__ l1_keys,
                 const float* __restrict__ tri, int E2, int blm,
                 float* __restrict__ out_t, float* __restrict__ out_u,
                 float* __restrict__ out_v, int* __restrict__ out_p,
                 int* __restrict__ out_occ) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rec* buf = reinterpret_cast<Rec*>(smem);               // [2][V6B_CHUNK]
  int* sid = reinterpret_cast<int*>(buf + 2 * V6B_CHUNK);  // [E2]
  float* skey = reinterpret_cast<float*>(sid + E2);      // [E2 / blm]
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int n_steps = E2 / blm;
  const int n_tri = blm * 64;               // triangles per step
  const int n_chunks = (n_tri + V6B_CHUNK - 1) / V6B_CHUNK;
  for (int i = l; i < E2; i += LANES) sid[i] = l1_ids[(size_t)r * E2 + i];
  for (int i = l; i < n_steps; i += LANES)
    skey[i] = l1_keys[(size_t)r * E2 + (size_t)i * blm];
  Row ry;
  load_row(rays, ry);
  Best best = {ry.mx, 0.0f, 0.0f, -1};
  bool occ = false;
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    // the ordered skip on the step's first key (any hit: mint - 1 once
    // occluded, so an occluded row skips); a barrier too, after which
    // every thread is done with the last chunk staged
    const float bound = ANY ? (occ ? ry.mn - 1.0f : ry.mx) : best.t;
    if (!__syncthreads_or(skey[s] <= bound)) continue;
    const int* ids = sid + s * blm;
    stage_chunk(tri, ids, 0, n_tri, buf);
    // the step's cap; no test of a lane with mint >= cap can pass it
    const float cap = ANY ? (occ ? ry.mn : ry.mx) : best.t;
    const bool live = ry.mn < cap;
    const bool warp_live = __any_sync(0xffffffffu, live);
    Best h = {BIG, 0.0f, 0.0f, 0};
    int hs = 8;
    bool hit = false;
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait_all();
      __syncthreads();       // chunk c staged; chunk c - 1's buffer free
      if (c + 1 < n_chunks)
        stage_chunk(tri, ids, c + 1, n_tri, buf + ((c + 1) & 1) * V6B_CHUNK);
      if (!warp_live) continue;
      const Rec* st = buf + (c & 1) * V6B_CHUNK;
      const int nk = min(V6B_CHUNK, n_tri - c * V6B_CHUNK);
      for (int k0 = 0; k0 < nk; k0 += 8) {  // a K8 cluster, sublanes 0-7
        if (ANY && __all_sync(0xffffffffu, hit || !live)) break;
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

// the refine kernels' resources: out[0] resident rows per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] shared memory bytes per row; child: #6, else #5
extern "C" int mts_refine_info(int child, int* out) {
  const void* kern = child ? (const void*)child_refine_kernel
                           : (const void*)refine_kernel;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, LANES,
                                                      0);
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes;
  return (int)e;
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

// raise the v6b walk's dynamic shared memory limit on the current device
// where a launch first needs more than 48 KB (the XL caps), once per
// instantiation, device and size
template <bool ANY>
static cudaError_t v6b_prepare(size_t smem) {
  constexpr int DEVICES = 64;
  static size_t smem_limit[DEVICES];
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && smem > smem_limit[dev]) {
    e = cudaFuncSetAttribute(l1_masked_kernel<ANY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) smem_limit[dev] = smem;
  }
  return e;
}

extern "C" int mts_l1_masked(const float* rays, const int* l1_ids,
                             const float* l1_keys, const float* tri, int R,
                             int E2, int blm, int any_hit, float* out_t,
                             float* out_u, float* out_v, int* out_p,
                             int* out_occ, void* stream) {
  if (R <= 0) return 0;
  if (blm <= 0 || E2 % blm) return (int)cudaErrorInvalidValue;
  auto kern = any_hit ? l1_masked_kernel<true> : l1_masked_kernel<false>;
  const size_t smem = v6b_smem(E2, blm);
  const cudaError_t e = any_hit ? v6b_prepare<true>(smem)
                                : v6b_prepare<false>(smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<R, LANES, smem, (cudaStream_t)stream>>>(
      rays, l1_ids, l1_keys, tri, E2, blm, out_t, out_u, out_v, out_p,
      out_occ);
  return (int)cudaGetLastError();
}

// the v6b walk's resources at list width E2 and step width blm: out[0]
// resident rows per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[1] registers per thread, out[2] shared memory bytes per row
extern "C" int mts_l1_masked_info(int E2, int blm, int any_hit, int* out) {
  if (blm <= 0 || E2 % blm) return (int)cudaErrorInvalidValue;
  auto kern = any_hit ? l1_masked_kernel<true> : l1_masked_kernel<false>;
  const size_t smem = v6b_smem(E2, blm);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = any_hit ? v6b_prepare<true>(smem) : v6b_prepare<false>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, LANES,
                                                      smem);
  out[1] = attr.numRegs;
  out[2] = (int)smem;
  return (int)e;
}
