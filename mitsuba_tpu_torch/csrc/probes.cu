// Cost probes of the H100, in the forms the port's kernels take, for
// NVIDIA Hopper (sm_90a).
//
// Replace the TPU cost probes of scripts/ (each a pallas_call):
//   count_kernel       <- the launch floor behind every grid step
//   gate_kernel        <- exp_kernel_cost.py:228 `run_empty`, the items 16
//                         a pass, 64 in flight, folded in item order
//   ring_kernel<RotateSums<W>> <- exp_kernel_cost.py:270 `run_dma_rotate`
//   ring_kernel<GridRow0>      <- exp_r3_kernel.py:70 `bench_grid_floor`
//                         with fetch; both instances of one TMA bulk-copy
//                         ring that stages each item's block (grid: 32
//                         items under one wait)
//   grid_loop_kernel   <- the same without fetch
//   fma_kernel         <- exp_kernel_cost.py:111 `run_vpu_fma`
//   mt_kernel          <- exp_kernel_cost.py:188 `run_vpu_mt`
//   v0, v1, packed_kernel <- exp_r3_mt.py:63 `run_variant` (V0-V4; v1 also
//                         exp_r3_kernel.py:112 `bench_mt_ceiling`)
//   mm_cuda_kernel     <- exp_kernel_cost.py:71 `run_mm`, CUDA cores, one
//                         product tiled over the card
//   mm_tc_kernel<Tf32> <- the same on the tensor cores (wgmma, TF32), tiled
//   mm_tc_kernel<Bf16>    too; bf16 the same kernel's other instance
//   gather_*_kernel    <- exp_r5_megakernel.py:72 `pallas_gather`
// Wrapped by mitsuba_tpu_torch/ops/probes.py, whose `*_ref` functions are
// the plain PyTorch versions each kernel is held against.
//
// The TPU ran each probe as a sequential grid on one core. Here a probe
// is one 128-thread block (the form of the port's item walks #7, #9, #12
// and #14: a thread per lane, a loop over items or steps) launched as one
// block or as many (8,192, the blocks of a 1,048,576-lane wavefront) that
// all do the same work, each writing its own copy of the result; but
// the products mm_cuda, mm_tf32 and mm_bf16 spread each copy's product
// over several blocks (their section says how). What
// each probe costs is what it measures: a floor (launch, item loop,
// staging), an issue rate (FMA, Moeller-Trumbore, products) or a memory
// path (gather). The floors keep the card's own means in flight: the
// staging floors (rotate, grid) a ring of bulk copies, the gated loop
// (gate) 64 items' row loads at once, each with its sums in the plain
// version's order.
//
// A step whose inputs do not change from step to step reads its operands
// at an offset `step & zero`, where `zero` is 0 at every call: the
// compiler cannot see that, so it cannot hoist the step's work out of the
// loop. The results do not change.
//
// Rounding: --fmad=false and IEEE division, so every expression has its
// plain version's operation order; a fused multiply-add is written as
// __fmaf_rn, an approximate reciprocal as rcp.approx.ftz.f32. The
// tensor-core products sum in the hardware's order: their plain versions
// agree within a tolerance (ops/probes.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mt.cuh"

#define LANES 128
#define ROWS 8
#define ROW_COLS 16
#define BIG 3e38f
#define DET_EPS 1e-12f
#define MAX_K 128
#define MAX_STAGE 8192        // floats of a staged block: 32 KB
#define GRID_FLOATS (4 * LANES)
#define N_COEF 10
#define PACKED_NONE 0x7F800000
#define QNAN_BITS 0x7FC00000

static int launched(void) { return (int)cudaGetLastError(); }

// ---------------------------------------------------------------------------
// Floors
// ---------------------------------------------------------------------------

// the launch floor: a kernel that only counts its launches
__global__ void count_kernel(int* count) {
  if (blockIdx.x == 0 && threadIdx.x == 0) count[0] += 1;
}

// the block's copy of the result: row r of out is thread r's acc
__device__ __forceinline__ void write_rows(float acc, float* out) {
  __shared__ float sums[ROWS];
  const int l = threadIdx.x;
  if (l < ROWS) sums[l] = acc;
  __syncthreads();
  float* o = out + (size_t)blockIdx.x * ROWS * LANES;
  for (int r = 0; r < ROWS; ++r) o[r * LANES + l] = sums[r];
}

// a row of 16 floats, read as four float4, summed in order: the ordered
// 16-term row sum of run_empty and run_dma_rotate
__device__ __forceinline__ float sum16(const float4 a, const float4 b,
                                       const float4 c, const float4 d) {
  const float v[ROW_COLS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                             c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
  float s = v[0];
#pragma unroll
  for (int k = 1; k < ROW_COLS; ++k) s = s + v[k];
  return s;
}

__device__ __forceinline__ float row_sum4(const float4* row) {
  return sum16(row[0], row[1], row[2], row[3]);
}

// run_empty: an item loop gated per item by flags[i]; an open gate adds the
// 8 row sums of block ids[i] of g (B, rows, 16), read in place from device
// memory, in item order (the TPU kernel skipped a closed item's work, not
// its grid step; rotate is the staged form).
//
// The block loads the list a chunk of GATE_CHUNK items at a time (the
// whole of a 512-item list) into shared memory, with coalesced loads of
// all 128 threads: an item's id, or -1 where its gate is closed. It takes
// a chunk GATE_BATCH (64) items at a time, in passes of 16: in a pass
// thread t reads row t % 8 of item t / 8 (an open one) as four 16-byte
// loads and forms its ordered 16-term sum, written to one of two shared
// arrays used in turn. The next batch's loads are issued before the
// barrier that publishes this batch's sums, so they are in flight while
// threads 0-7 fold the batch: each adds its row's sums of the batch's open
// items to acc one after another, in item order, the plain version's
// order (the only serial part: a tree across items would round
// otherwise), the loop unrolled over the batch so that its reads of the
// list (16 bytes at a time) and of the sums are issued ahead of the adds.
// So the result is gate_ref's, bit for bit. g starts on 16
// bytes and a row of 16 floats is 64 bytes, so every row read is aligned.
//
// What bounds it on this card (H100 80GB HBM3, 700 W): a batch's round
// trip to L2 and the serial fold of its open items on 8 threads. A call
// at 512 items (~256 open) takes ~8 us of device time, kernel_cost's
// per-block slope ~15 ns an open item and 5-8 ns a closed one. Trial
// forms measured slower: a fold that read the list item by item (a load
// and a branch an item), and eight passes a batch over 8,192 copies.

#define GATE_PASS (LANES / ROWS)      // items a pass: 16
#define GATE_PASSES 4                 // passes a batch, loads in flight
#define GATE_BATCH (GATE_PASS * GATE_PASSES)
#define GATE_CHUNK 512                // items of the list in shared memory

// the rows of this thread's items of the batch at b0 (item b0 + p * 16 +
// t / 8, row t % 8), zero where the item is past the chunk or closed
__device__ __forceinline__ void gate_loads(float4 (&v)[GATE_PASSES][4],
                                           const float* __restrict__ g,
                                           int rows, const int* list,
                                           int b0, int cn) {
  const int t = threadIdx.x;
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p) {
    const int k = b0 + p * GATE_PASS + t / ROWS;
    const int id = k < cn ? list[k] : -1;
    if (id >= 0) {
      const float4* row = reinterpret_cast<const float4*>(
          g + ((size_t)id * rows + t % ROWS) * ROW_COLS);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[p][q] = __ldg(row + q);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[p][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__global__ void __launch_bounds__(LANES)
gate_kernel(const float* __restrict__ g, int rows,
            const int* __restrict__ ids, const int* __restrict__ flags,
            int n, float* __restrict__ out) {
  __shared__ __align__(16) int list[GATE_CHUNK];
  __shared__ float sums[2][GATE_BATCH * ROWS];
  const int t = threadIdx.x;
  float acc = 0.0f;
  int buf = 0;
  for (int c0 = 0; c0 < n; c0 += GATE_CHUNK) {
    const int cn = min(GATE_CHUNK, n - c0);
    __syncthreads();                          // the last chunk folded
    for (int k = t; k < cn; k += LANES)
      list[k] = flags[c0 + k] > 0 ? ids[c0 + k] : -1;
    __syncthreads();
    float4 v[GATE_PASSES][4];
    gate_loads(v, g, rows, list, 0, cn);
    for (int b0 = 0; b0 < cn; b0 += GATE_BATCH) {
      // sums[buf] was last folded two batches ago, before the barrier
      // that the batch between passed
      float* s = sums[buf];
#pragma unroll
      for (int p = 0; p < GATE_PASSES; ++p)
        s[p * LANES + t] = sum16(v[p][0], v[p][1], v[p][2], v[p][3]);
      if (b0 + GATE_BATCH < cn)               // the next batch, in flight
        gate_loads(v, g, rows, list, b0 + GATE_BATCH, cn);
      __syncthreads();                        // the batch's sums written
      if (t < ROWS) {                         // in item order
        const int m = min(GATE_BATCH, cn - b0);
        const int4* gates = reinterpret_cast<const int4*>(list + b0);
#pragma unroll
        for (int k = 0; k < GATE_BATCH; k += 4) {
          const int4 id = gates[k / 4];
          const int open[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k + j < m && open[j] >= 0)
              acc = acc + s[(k + j) * ROWS + t];
        }
      }
      buf ^= 1;
    }
  }
  write_rows(acc, out);
}

// ---------------------------------------------------------------------------
// The staging ring: run_dma_rotate (rotate) and bench_grid_floor's fetch
// (grid), one kernel template over what its consumer does with an item
// ---------------------------------------------------------------------------

// Each item's block ids[i] of `src` (item_floats floats a block) is staged
// in shared memory. The TPU kernels fetched the next block by DMA while
// they used the current one (Pallas's double-buffered BlockSpec pipeline);
// here a ring of `stages` stages in dynamic shared memory, `group` items a
// stage (group q of the items, items q * group .. q * group + group - 1,
// in stage q % stages), is filled by TMA bulk copies (async_copy.cuh: one
// instruction an item, its bytes counted on the stage's "full" mbarrier).
//
// Producers: warps 1-3, group q by warp 1 + q % 3. Before it refills a
// stage, a producer waits on the stage's "empty" mbarrier for the phase
// in which the consumer read the group before (those reads ordered before
// the copies' writes by the barrier's release and acquire and a proxy
// fence), arrives on the "full" barrier expecting the group's bytes
// (group x block, or the last, partial group's; a copy that lands first
// takes the barrier's byte count below zero, and the phase waits for the
// arrival all the same) and issues the copies, the ids loaded a group
// ahead (the load's latency hidden by the wait). Which lanes do it
// follows the group (H100 80GB HBM3, 700 W): with one item a stage
// (rotate) lane 0 alone, as one thread: every lane waiting cost 8 KB
// items ~26% and left 32 KB as it was, where this form runs ~2% behind
// the parent's separate kernel with the same producer. With several (grid) every lane
// waits, lane j copies item j and lane 0 also arrives; a warp barrier
// between the arrival and the copies, or one lane waiting for the warp,
// measured slower. Consumer: warp 0, which waits for a stage's phase,
// uses its items in item order, and releases it (one arrival on
// "empty").
//
// rotate (RotateSums<W>): a group is one block (up to 32 KB), W stages a
// batch (W groups of 8 lanes; W = 4 where the ring has 8 stages or more,
// else 2 or 1): group j waits for item W b + j's phase and sums its first
// 8 rows (16 terms in order, read as float4), lanes 0-7 add the W row sums
// in item order through shuffles. ops/probes.py `ring_stages` fills
// RING_BYTES (192 KB: 6 stages of 32 KB, 24 of 8 KB; one block a SM), at
// most RING_MAX_STAGES. What bounds it on this card (H100 80GB HBM3,
// 700 W): the latency of a wait on an mbarrier, not the copy engine or
// the L2. A ring that one thread issues and waits on item by item ran at
// one rate an item from 2 to 32 KB and at any depth; only more waits in
// flight (more issuers, more items a wait) go faster. kernel_cost's
// per-block slopes give ~70 ns an item at 8 KB and ~160 ns at 32 KB
// (~118 and ~205 GB/s into one SM). The 64 blocks a run rotates (2 MB at
// 32 KB) stay in L2.
//
// grid (GridRow0): a block is bench_grid_floor's (4, 128), 2 KB, a quarter
// of rotate's smallest; at one item a wait it would run at a wait's pace,
// so a stage holds `group` items under one wait (ops/probes.py
// `grid_plan`: GRID_GROUP items a stage, as many stages as RING_BYTES
// holds). Lane l of warp 0 reads floats 4l .. 4l + 3 of row 0 of each
// staged item (a float4) and adds them to its four running sums in item
// order: each of the 128 sums is grid_ref's sequential sum, bit for bit.
// GRID_GROUP is 32 (64 KB a wait, 3 stages): with 16 the fastest of 1,
// 2, 4, 8, 16 and 32 items a stage, timed once as a call at 512 items on
// one block and on 8,192 copies (H100 80GB HBM3, 700 W; the two tie on one
// block and each led over the card in one of two runs); 8 items a stage
// ran ~1.2x and 1.2-1.35x as long, one item a stage ~5x and ~2x (PERF.md
// has the figures). What bounds it: the copies' rate into one SM, ~125
// GB/s (r3_kernel's per-block slope, ~16 ns an item), below rotate's 32
// KB rate (~200 GB/s): a 2 KB copy costs the copy engine more than its
// bytes.

#define RING_MAX_STAGES 32
#define RING_BAR_BYTES (2 * RING_MAX_STAGES * 8)
#define RING_PRODUCERS 3
#define RING_MAX_GROUP 32             // items a stage: a producer lane each
#define SMEM_MAX 232448       // bytes of shared memory a block may have

struct Ring {
  unsigned long long* full;   // a stage's copies have landed
  unsigned long long* empty;  // a stage's items have been read
  float* data;
  int item_floats, group, stages;
  __device__ float* stage(int s) const {
    return data + (size_t)s * group * item_floats;
  }
};

static int ring_smem(int item_floats, int group, int stages) {
  return RING_BAR_BYTES + stages * group * item_floats * (int)sizeof(float);
}

// rotate's items a batch: 4 where the ring leaves 4 stages or more to the
// producers, else 2 (or 1 in a ring of fewer than 4)
static int ring_width(int stages) {
  return stages >= 8 ? 4 : stages >= 4 ? 2 : 1;
}

// one item a stage (rotate): lane 0 of the warp waits and issues alone,
// item i's id loaded an item ahead; the other lanes have nothing to copy
__device__ __forceinline__ void ring_produce_one(const Ring& r,
                                                 const float* __restrict__ src,
                                                 const int* __restrict__ ids,
                                                 int n) {
  if ((threadIdx.x & 31) != 0) return;
  const unsigned item_bytes = (unsigned)r.item_floats * sizeof(float);
  int i = (threadIdx.x >> 5) - 1;
  int id = i < n ? ids[i] : 0;
  for (; i < n; i += RING_PRODUCERS) {
    const int next = i + RING_PRODUCERS < n ? ids[i + RING_PRODUCERS] : 0;
    const int st = i % r.stages, use = i / r.stages;
    if (use > 0) mbar_wait(r.empty + st, (unsigned)(use - 1) & 1);
    fence_proxy_async();
    mbar_arrive_expect_tx(r.full + st, item_bytes);
    bulk_copy(r.stage(st), src + (size_t)id * r.item_floats, item_bytes,
              r.full + st);
    id = next;
  }
}

__device__ __forceinline__ void ring_produce(const Ring& r,
                                             const float* __restrict__ src,
                                             const int* __restrict__ ids,
                                             int n) {
  if (r.group == 1) {
    ring_produce_one(r, src, ids, n);
    return;
  }
  const int lane = threadIdx.x & 31;
  const unsigned item_bytes = (unsigned)r.item_floats * sizeof(float);
  const int groups = (n + r.group - 1) / r.group;
  // the id of this lane's item of group q (0 where it has none)
  auto id_of = [&](int q) {
    const int i = q * r.group + lane;
    return q < groups && lane < r.group && i < n ? ids[i] : 0;
  };
  int q = (threadIdx.x >> 5) - 1;
  int id = id_of(q);
  for (; q < groups; q += RING_PRODUCERS) {
    const int first = q * r.group, m = min(r.group, n - first);
    const int st = q % r.stages, use = q / r.stages;
    const int next = id_of(q + RING_PRODUCERS);   // the warp's next group
    if (use > 0) mbar_wait(r.empty + st, (unsigned)(use - 1) & 1);
    if (lane < m) {
      fence_proxy_async();
      if (lane == 0)
        mbar_arrive_expect_tx(r.full + st, (unsigned)m * item_bytes);
      bulk_copy(r.stage(st) + (size_t)lane * r.item_floats,
                src + (size_t)id * r.item_floats, item_bytes, r.full + st);
    }
    id = next;
  }
}

template <int W>
struct RotateSums {
  float acc = 0.0f;

  __device__ void consume(const Ring& ring, int n) {
    const int l = threadIdx.x, grp = l / ROWS, r = l % ROWS;
    int s0 = 0;                                    // item i0's stage
    unsigned p0 = 0;                               // and its phase's parity
    for (int i0 = 0; i0 < n; i0 += W) {
      const bool mine = grp < W && i0 + grp < n;
      const bool wrap = s0 + grp >= ring.stages;
      const int st = wrap ? s0 + grp - ring.stages : s0 + grp;
      float rs = 0.0f;
      if (mine) {
        mbar_wait(ring.full + st, p0 ^ (unsigned)wrap);
        rs = row_sum4(reinterpret_cast<const float4*>(ring.stage(st) +
                                                      r * ROW_COLS));
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {                // in item order
        const float v = __shfl_sync(0xffffffffu, rs, j * ROWS + r);
        if (l < ROWS && i0 + j < n) acc = acc + v;
      }
      __syncwarp();                                // the batch's rows read
      if (mine && r == 0) mbar_arrive(ring.empty + st);
      s0 += W;
      if (s0 >= ring.stages) {
        s0 -= ring.stages;
        p0 ^= 1;
      }
    }
  }

  __device__ void write(float* out) { write_rows(acc, out); }
};

struct GridRow0 {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  __device__ void consume(const Ring& ring, int n) {
    const int l = threadIdx.x;
    int st = 0;
    unsigned parity = 0;
    for (int first = 0; first < n; first += ring.group) {
      const int m = min(ring.group, n - first);
      mbar_wait(ring.full + st, parity);
      const float4* row = reinterpret_cast<const float4*>(ring.stage(st)) + l;
      const int stride = ring.item_floats / 4;
#pragma unroll 8
      for (int j = 0; j < m; ++j) {                // in item order
        const float4 v = row[j * stride];
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
      }
      __syncwarp();                                // the group's rows read
      if (l == 0) mbar_arrive(ring.empty + st);
      if (++st == ring.stages) {
        st = 0;
        parity ^= 1;
      }
    }
  }

  __device__ void write(float* out) {
    const int l = threadIdx.x;
    float* o = out + (size_t)blockIdx.x * ROWS * LANES;
    if (l < 32) reinterpret_cast<float4*>(o)[l] = acc;
    for (int r = 1; r < ROWS; ++r) o[r * LANES + l] = 0.0f;
  }
};

template <class CONSUMER>
__global__ void __launch_bounds__(LANES)
ring_kernel(const float* __restrict__ src, int item_floats,
            const int* __restrict__ ids, int n, int group, int stages,
            float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring_raw[];
  Ring ring;
  ring.full = reinterpret_cast<unsigned long long*>(ring_raw);
  ring.empty = ring.full + RING_MAX_STAGES;
  ring.data = reinterpret_cast<float*>(ring_raw + RING_BAR_BYTES);
  ring.item_floats = item_floats;
  ring.group = group;
  ring.stages = stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  CONSUMER c;
  if (threadIdx.x >= 32)
    ring_produce(ring, src, ids, n);
  else
    c.consume(ring, n);
  c.write(out);
}

// bench_grid_floor without fetch: per item lane l adds row 0 of block 0,
// read in place once: n dependent adds, the item loop's floor
__global__ void __launch_bounds__(LANES)
grid_loop_kernel(const float* __restrict__ tri, int n,
                 float* __restrict__ out) {
  const int l = threadIdx.x;
  const float v = tri[l];
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) acc = acc + v;
  float* o = out + (size_t)blockIdx.x * ROWS * LANES;
  o[l] = acc;
  for (int r = 1; r < ROWS; ++r) o[r * LANES + l] = 0.0f;
}

// ---------------------------------------------------------------------------
// FMA rate
// ---------------------------------------------------------------------------

// run_vpu_fma: per step n_ops dependent x = fma(x, 0.999999, b) on an
// (8, 128) block; thread l runs the 8 chains of lane l
__global__ void __launch_bounds__(LANES)
fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
           int n_ops, int steps, float* __restrict__ out) {
  const int l = threadIdx.x;
  float x[ROWS], bb[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    x[r] = a[r * LANES + l];
    bb[r] = b[r * LANES + l];
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll 4
    for (int k = 0; k < n_ops; ++k) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) x[r] = __fmaf_rn(x[r], 0.999999f, bb[r]);
    }
  }
  float* o = out + (size_t)blockIdx.x * ROWS * LANES;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) o[r * LANES + l] = x[r];
}

// ---------------------------------------------------------------------------
// Moeller-Trumbore
// ---------------------------------------------------------------------------

__device__ __forceinline__ void stage(float* blk, const float* src, int n) {
  for (int k = threadIdx.x; k < n; k += LANES) blk[k] = src[k];
  __syncthreads();
}

// run_vpu_mt: mt.cuh's test of a resident K-triangle cluster (sublane s
// holds triangles j * 8 + s) against lane l's ray, per step the running
// nearest t of each sublane (from 1e9, t > 1e-4) and its chunk; then the
// minimum t over sublanes and over steps, and the maximum chunk
__global__ void __launch_bounds__(LANES)
mt_kernel(const float* __restrict__ tri, int K, const float* __restrict__ rays,
          int steps, int zero, float* __restrict__ out_t,
          int* __restrict__ out_p) {
  __shared__ float blk[MAX_K * ROW_COLS];
  const int l = threadIdx.x;
  stage(blk, tri, K * ROW_COLS);
  float o[3], d[3];
  for (int j = 0; j < 3; ++j) {
    o[j] = rays[j * LANES + l];
    d[j] = rays[(3 + j) * LANES + l];
  }
  float to = 1e9f;
  int po = -1;
  for (int step = 0; step < steps; ++step) {
    const float* bs = blk + (step & zero);
    float tm = 0.0f;
    int km = -1;
    for (int s = 0; s < ROWS; ++s) {
      float tr = 1e9f;
      int kr = -1;
      for (int j = 0; j < K / ROWS; ++j) {
        float t, u, v;
        if (mt_test(bs + (j * ROWS + s) * ROW_COLS, o, d, 1e-4f, tr, DET_EPS,
                    t, u, v)) {
          tr = t;
          kr = j;
        }
      }
      tm = s ? fminf(tm, tr) : tr;
      km = max(km, kr);
    }
    to = fminf(to, tm);
    po = max(po, km);
  }
  out_t[(size_t)blockIdx.x * LANES + l] = to;
  out_p[(size_t)blockIdx.x * LANES + l] = po;
}

// The variants of exp_r3_mt.py. Each iteration moves lane l's ray by
// acc * 1e-30 (rows 0-5 of the (8, 128) accumulator: the chain from one
// iteration to the next) and adds its result to acc; `hits` counts the
// triangles each (sublane, lane) accepted over all iterations.

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void load_lane(const float* rays, float r8[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) r8[r] = rays[r * LANES + threadIdx.x];
}

__device__ __forceinline__ void moved_ray(const float r8[ROWS],
                                          const float acc[ROWS], float o[3],
                                          float d[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o[j] = r8[j] + acc[j] * 1e-30f;
    d[j] = r8[3 + j] + acc[3 + j] * 1e-30f;
  }
}

__device__ __forceinline__ void write_acc(const float acc[ROWS],
                                          const int hits[ROWS],
                                          float* out, int* out_hits) {
  const size_t base = (size_t)blockIdx.x * ROWS * LANES + threadIdx.x;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    out[base + r * LANES] = acc[r];
    if (out_hits) out_hits[base + r * LANES] = hits[r];
  }
}

// V0, the FMA ceiling: 8 chains acc + k, each 4 times a = fma(a, b, b),
// summed in order, times 1e-6
__global__ void __launch_bounds__(LANES)
v0_kernel(const float* __restrict__ rays, int reps, float* __restrict__ out) {
  float b[ROWS], acc[ROWS];
  load_lane(rays, b);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int it = 0; it < reps; ++it) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = acc[r] + (float)k;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = __fmaf_rn(a[k], b[r], b[r]);
      }
      float s = a[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) s = s + a[k];
      acc[r] = s * 1e-6f;
    }
  }
  write_acc(acc, nullptr, out, nullptr);
}

// V1, mt.cuh's test in the TPU's _mt_chunks form (worklist_pallas.py:261,
// mnb 0, cap 3e38): per sublane the even and odd chunks keep running
// nearest hits, the odd one taken when strictly nearer; acc += t_run
// (+ u_run)
__device__ __forceinline__ void v1_take(const float* f, const float o[3],
                                        const float d[3], float& tg,
                                        float& ug, int& hits) {
  float t, u, v;
  const bool ok = mt_test(f, o, d, 0.0f, BIG, DET_EPS, t, u, v);
  hits += ok;
  if (ok && t < tg) {
    tg = t;
    ug = u;
  }
}

__global__ void __launch_bounds__(LANES)
v1_kernel(const float* __restrict__ tri, int K, const float* __restrict__ rays,
          int reps, int add_u, float* __restrict__ out,
          int* __restrict__ out_hits) {
  __shared__ float blk[MAX_K * ROW_COLS];
  stage(blk, tri, K * ROW_COLS);
  float r8[ROWS], acc[ROWS];
  int hits[ROWS];
  load_lane(rays, r8);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    acc[r] = 0.0f;
    hits[r] = 0;
  }
  for (int it = 0; it < reps; ++it) {
    float o[3], d[3];
    moved_ray(r8, acc, o, d);
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      float t0 = BIG, t1 = BIG, u0 = 0.0f, u1 = 0.0f;
      for (int j = 0; j < K / ROWS; j += 2) {
        v1_take(blk + (j * ROWS + s) * ROW_COLS, o, d, t0, u0, hits[s]);
        v1_take(blk + ((j + 1) * ROWS + s) * ROW_COLS, o, d, t1, u1,
                hits[s]);
      }
      const bool odd = t1 < t0;
      acc[s] = acc[s] + (odd ? t1 : t0);
      if (add_u) acc[s] = acc[s] + (odd ? u1 : u0);
    }
  }
  write_acc(acc, hits, out, out_hits);
}

// the packed candidate (t_bits << 2) | chunk of an accepted triangle
__device__ __forceinline__ int packed(bool ok, float t, int j) {
  return ok ? (int)(((uint32_t)__float_as_int(t) << 2) | (uint32_t)j)
            : PACKED_NONE;
}

// V2 (and V3, the same on this card): the approximate reciprocal of det,
// no det test
__device__ __forceinline__ int v2_cand(const float* f, const float o[3],
                                       const float d[3], int j, int& hits) {
  const float px = d[1] * f[8] - d[2] * f[7];
  const float py = d[2] * f[6] - d[0] * f[8];
  const float pz = d[0] * f[7] - d[1] * f[6];
  const float det = f[3] * px + f[4] * py + f[5] * pz;
  const float sx = o[0] - f[0];
  const float sy = o[1] - f[1];
  const float sz = o[2] - f[2];
  const float qx = sy * f[5] - sz * f[4];
  const float qy = sz * f[3] - sx * f[5];
  const float qz = sx * f[4] - sy * f[3];
  const float inv = rcp_approx(det);
  const float u = (sx * px + sy * py + sz * pz) * inv;
  const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv;
  const float t = (f[6] * qx + f[7] * qy + f[8] * qz) * inv;
  const bool ok = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                  (t > 0.0f) && (t < BIG);
  hits += ok;
  return packed(ok, t, j);
}

// V4: the division-free accept (everything times the sign of det, the
// bounds against |det|), the approximate reciprocal only to form t
__device__ __forceinline__ int v4_cand(const float* f, const float o[3],
                                       const float d[3], int j, int& hits) {
  const float px = d[1] * f[8] - d[2] * f[7];
  const float py = d[2] * f[6] - d[0] * f[8];
  const float pz = d[0] * f[7] - d[1] * f[6];
  const float det = f[3] * px + f[4] * py + f[5] * pz;
  const float sx = o[0] - f[0];
  const float sy = o[1] - f[1];
  const float sz = o[2] - f[2];
  const float qx = sy * f[5] - sz * f[4];
  const float qy = sz * f[3] - sx * f[5];
  const float qz = sx * f[4] - sy * f[3];
  const float sd = det >= 0.0f ? 1.0f : -1.0f;
  const float ad = det * sd;
  const float us = (sx * px + sy * py + sz * pz) * sd;
  const float vs = (d[0] * qx + d[1] * qy + d[2] * qz) * sd;
  const float ts = (f[6] * qx + f[7] * qy + f[8] * qz) * sd;
  const float t = ts * rcp_approx(ad);
  const bool ok = (us >= 0.0f) && (vs >= 0.0f) && (us + vs <= ad) &&
                  (t > 0.0f) && (t < BIG);
  hits += ok;
  return packed(ok, t, j);
}

// V2 and V4: per sublane the packed minimum of the even and of the odd
// chunks, then of the two; acc += float(packed) * 1e-9
template <bool DIVFREE>
__global__ void __launch_bounds__(LANES)
packed_kernel(const float* __restrict__ tri, int K,
              const float* __restrict__ rays, int reps,
              float* __restrict__ out, int* __restrict__ out_hits) {
  __shared__ float blk[MAX_K * ROW_COLS];
  stage(blk, tri, K * ROW_COLS);
  float r8[ROWS], acc[ROWS];
  int hits[ROWS];
  load_lane(rays, r8);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    acc[r] = 0.0f;
    hits[r] = 0;
  }
  for (int it = 0; it < reps; ++it) {
    float o[3], d[3];
    moved_ray(r8, acc, o, d);
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      int p0 = PACKED_NONE, p1 = PACKED_NONE;
      for (int j = 0; j < K / ROWS; j += 2) {
        const float* f0 = blk + (j * ROWS + s) * ROW_COLS;
        const float* f1 = f0 + ROWS * ROW_COLS;
        p0 = min(p0, DIVFREE ? v4_cand(f0, o, d, j, hits[s])
                             : v2_cand(f0, o, d, j, hits[s]));
        p1 = min(p1, DIVFREE ? v4_cand(f1, o, d, j + 1, hits[s])
                             : v2_cand(f1, o, d, j + 1, hits[s]));
      }
      acc[s] = acc[s] + (float)min(p0, p1) * 1e-9f;
    }
  }
  write_acc(acc, hits, out, out_hits);
}

// ---------------------------------------------------------------------------
// Pluecker products: sum over steps of (G @ M)[0:8], G (m, K), M (K, 128)
// ---------------------------------------------------------------------------

// the ordered 10-term sum g . m of csrc/cluster.cu
__device__ __forceinline__ float dot10(const float* g, const float m[N_COEF]) {
  float s = g[0] * m[0];
#pragma unroll
  for (int j = 1; j < N_COEF; ++j) s = s + g[j] * m[j];
  return s;
}

// Spread over the card (mm_cuda, mm_tf32, mm_bf16). A copy's product is
// cut into tiles of G's rows (MM_ROWS for mm_cuda; TC_ROWS for the
// tensor-core products, whose blocks also split M's 128 columns into
// TC_HALVES halves). A block takes
// a chunk of `per` consecutive tiles; the grid is copies x halves x chunks
// blocks, block b of copy b / (halves * chunks), then its half, then its
// chunk. ops/probes.py `mm_plan` picks the chunks: a tile a block where
// that gives at most SPREAD_BLOCKS blocks, fewer blocks of more tiles
// where many copies fill the card anyway. A block stages its tiles in
// shared memory (cp.async) and runs the steps on each tile in turn: rows
// 0-7 belong to tile 0 alone, so their step sums add in the plain
// version's order whatever the other tiles do. The maximum of the other
// rows (the padded rows of a ragged last tile left out) is the block's
// partial. With one chunk a copy the block writes it in place; else it
// writes it to `part` (copies, chunks, 128), takes a ticket of its copy,
// and the copy's last block to arrive folds every chunk's partial (fmaxf,
// as before) and sets the ticket back to 0: the wrapper's ticket buffer
// is zero between launches, and a call is one launch. Where the wrapper
// passes a counter (`ran`, ops/probes.py `blocks_ran`), each block adds
// one to it as it ends: the blocks a launch ran, measured.

#define MM_ROWS 32            // rows of G in an mm_cuda tile
#define TC_ROWS 64            // rows of G in a tensor-core tile: wgmma's M
#define TC_COLS 64            // columns of M such a block takes: its N
#define TC_HALVES (LANES / TC_COLS)
#define FOLD_LOADS 8          // float4 partials a thread reads at once

// a block's place in the grid: its copy, half and chunk, and its tiles
// [t0, t1)
struct Spread {
  int copy, half, chunk, t0, t1;
};

__device__ __forceinline__ Spread spread(int m, int tile_rows, int halves,
                                         int chunks, int per) {
  Spread s;
  const int b = blockIdx.x;
  s.copy = b / (halves * chunks);
  s.half = (b / chunks) % halves;
  s.chunk = b % chunks;
  s.t0 = s.chunk * per;
  s.t1 = min((m + tile_rows - 1) / tile_rows, s.t0 + per);
  return s;
}

// n floats from src into shared memory at dst (16-byte aligned), as
// asynchronous copies committed as one group: 16-byte pieces where src is
// 16-byte aligned (every tile of a G that PyTorch allocated), else 4-byte
// ones
__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n) {
  const int n4 = ((uintptr_t)src & 15) ? 0 : n / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + i, src + i);
  cp_async_commit();
}

// the block's partial maximum v of column col (threads l < ncol) into
// out_max, in place or through `part` and the copy's ticket, of which
// `arrivals` (the copy's blocks) are drawn a launch
__device__ void fold_max(float v, int col, int ncol, const Spread& s,
                         int chunks, int arrivals, float* out_max,
                         float* part, int* tickets) {
  __shared__ int last;
  const int l = threadIdx.x;
  if (chunks == 1) {
    if (l < ncol) out_max[(size_t)s.copy * LANES + col] = v;
    return;
  }
  if (l < ncol)
    part[((size_t)s.copy * chunks + s.chunk) * LANES + col] = v;
  __threadfence();
  __syncthreads();
  if (l == 0) last = atomicAdd(tickets + s.copy, 1) == arrivals - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread l reads columns 4 (l % 32) .. 4 (l % 32) + 3 of the chunks
  // l / 32, + 4, + 8, ... as float4, FOLD_LOADS loads in flight; the four
  // chunk classes then meet in shared memory (the maximum does not depend
  // on the order)
  __shared__ float4 cls[4][LANES / 4];
  const int cg = l % (LANES / 4), cl = l / (LANES / 4);
  const float4* p = reinterpret_cast<const float4*>(
                        part + (size_t)s.copy * chunks * LANES) + cg;
  float4 m4 = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  for (int c = cl; c < chunks; c += 4 * FOLD_LOADS) {
    float4 v[FOLD_LOADS];
#pragma unroll
    for (int u = 0; u < FOLD_LOADS; ++u)
      v[u] = c + 4 * u < chunks ? __ldcg(p + (size_t)(c + 4 * u) * (LANES / 4))
                                : m4;
#pragma unroll
    for (int u = 0; u < FOLD_LOADS; ++u)
      m4 = make_float4(fmaxf(m4.x, v[u].x), fmaxf(m4.y, v[u].y),
                       fmaxf(m4.z, v[u].z), fmaxf(m4.w, v[u].w));
  }
  cls[cl][cg] = m4;
  __syncthreads();
  const float* r = reinterpret_cast<const float*>(cls);
  const float mx = fmaxf(fmaxf(r[l], r[LANES + l]),
                         fmaxf(r[2 * LANES + l], r[3 * LANES + l]));
  out_max[(size_t)s.copy * LANES + l] = mx;
  if (l == 0) tickets[s.copy] = 0;
}

// On the float32 pipes, as #14 computes them: lane l holds column l of M
// in registers and reads G's rows from shared memory as broadcasts, two
// rows (80 bytes) as five float4 loads. Rows 0-7 add into the sum; the
// other rows' products feed a running maximum (out_max), so that every
// product is computed and checked. Bound on this card by the float32
// instructions (19 a product at --fmad=false), 10.5 M a step at m = 4,096:
// a launch's floor, so the design is one launch that spreads the rows
// over the SMs.

// products of rows 2p and 2p + 1 of a staged tile
__device__ __forceinline__ void row_pair(const float4* t, int p,
                                         const float mk[N_COEF], float& a,
                                         float& b) {
  const float4* x = t + 5 * p;
  const float4 x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3], x4 = x[4];
  const float r0[N_COEF] = {x0.x, x0.y, x0.z, x0.w, x1.x,
                            x1.y, x1.z, x1.w, x2.x, x2.y};
  const float r1[N_COEF] = {x2.z, x2.w, x3.x, x3.y, x3.z,
                            x3.w, x4.x, x4.y, x4.z, x4.w};
  a = dot10(r0, mk);
  b = dot10(r1, mk);
}

// the steps on a staged tile of `rows` rows (an odd count followed by a
// zero row): tile 0's rows 0-7 into acc, every other row into mx
__device__ __forceinline__ void cuda_tile(const float* sg, int rows,
                                          bool first, int steps, int zero,
                                          const float mk[N_COEF],
                                          float acc[ROWS], float& mx) {
  for (int step = 0; step < steps; ++step) {
    const float4* t = reinterpret_cast<const float4*>(sg) + (step & zero);
    int p = 0;
    if (first) {
#pragma unroll
      for (int r = 0; r < ROWS; r += 2) {
        float a, b;
        row_pair(t, r / 2, mk, a, b);
        acc[r] = acc[r] + a;
        acc[r + 1] = acc[r + 1] + b;
      }
      p = ROWS / 2;
    }
    for (; p < rows / 2; ++p) {
      float a, b;
      row_pair(t, p, mk, a, b);
      mx = fmaxf(mx, a);
      mx = fmaxf(mx, b);
    }
    if (rows & 1) {
      float a, b;
      row_pair(t, rows / 2, mk, a, b);
      mx = fmaxf(mx, a);
    }
  }
}

__device__ __forceinline__ void stage_cuda_tile(float* sg, const float* G,
                                                int m, int t) {
  const int rows = min(MM_ROWS, m - t * MM_ROWS);
  stage_span(sg, G + (size_t)t * MM_ROWS * N_COEF, rows * N_COEF);
  if (rows & 1)
    for (int i = threadIdx.x; i < N_COEF; i += blockDim.x)
      sg[rows * N_COEF + i] = 0.0f;
}

__global__ void __launch_bounds__(LANES)
mm_cuda_kernel(const float* __restrict__ G, int m,
               const float* __restrict__ M, int steps, int zero, int chunks,
               int per, float* __restrict__ out_sum,
               float* __restrict__ out_max, float* __restrict__ part,
               int* __restrict__ tickets, int* __restrict__ ran) {
  __shared__ __align__(16) float sg[2][MM_ROWS * N_COEF];
  const int l = threadIdx.x;
  const Spread s = spread(m, MM_ROWS, 1, chunks, per);
  float mk[N_COEF];
#pragma unroll
  for (int k = 0; k < N_COEF; ++k) mk[k] = M[k * LANES + l];
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  float mx = -INFINITY;
  stage_cuda_tile(sg[0], G, m, s.t0);
  for (int t = s.t0; t < s.t1; ++t) {
    const int b = (t - s.t0) & 1;
    if (t + 1 < s.t1) {                   // the next tile while this one runs
      stage_cuda_tile(sg[b ^ 1], G, m, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();                      // tile t staged
    cuda_tile(sg[b], min(MM_ROWS, m - t * MM_ROWS), t == 0, steps, zero, mk,
              acc, mx);
    __syncthreads();                      // read before tile t + 2 lands
  }
  if (s.t0 == 0) {
    float* o = out_sum + (size_t)s.copy * ROWS * LANES;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) o[r * LANES + l] = acc[r];
  }
  fold_max(mx, l, LANES, s, chunks, chunks, out_max, part, tickets);
  if (ran != nullptr && l == 0) atomicAdd(ran, 1);
}

// On the tensor cores with wgmma (sm_90a), one kernel template over the
// kind of the inputs: mm_tc_kernel<Tf32, KP> (mm_tf32) and
// mm_tc_kernel<Bf16, KP> (mm_bf16). A block is one warpgroup; a tile's D
// (64 x 64) = A (64 x KP) B (KP x 64) is KP / 8 instructions m64n64k8
// .tf32 or KP / 16 m64n64k16 .bf16, A and B in shared memory, D in
// registers. The block takes G and M as float32, as the caller holds them
// (K <= 16, or 128), and prepares them itself: its half of M once, each
// tile of G staged as one flat span (a tile's rows are contiguous; TMA
// would need 16-byte row strides, and a row is 4K bytes) and re-laid.
// Both operands K zero-padded to KP, each value rounded as the kind
// rounds (TF32: cvt.rna, to nearest, ties away from zero, ops/probes.py
// round_tf32; bf16: cvt.rn.bf16x2.f32, to nearest even, as
// torch.Tensor.to(torch.bfloat16), round_bf16), in the K-major layout
// without swizzle: [KP / V][rows][V] values, V = 4 TF32 or 8 bf16 a
// 16-byte row of an 8-row core matrix, those adjacent in K rows * 16
// bytes apart (the descriptor's leading byte offset), those adjacent in M
// or N 128 bytes apart (its stride byte offset); an instruction takes two
// core matrices of K (32 bytes) whichever the kind. The accumulator
// fragment of m64nN (PTX ISA, wgmma register fragments): thread (warp w,
// lane 4g + q) holds d[4j + c] of row 16w + g and d[4j + 2 + c] of row
// 16w + g + 8, column 8j + 2q + c. Bound by a launch's floor at these
// sizes (1.3 M products a step at m = 4,096 against 495 TFLOP/s TF32,
// 989 bf16); over many copies by the per-step wait and fold at K 10 (one
// bf16 instruction a step where TF32 issues two), by the tensor cores'
// rate at K 128.

// the two kinds: the value as wgmma reads it (T), V of them a 16-byte
// core-matrix row; put2 lays two values adjacent in K, rounded; mma is
// D = A B (accumulate 0) or D += A B on one 64 x 64 tile, 32 bytes of K
#define WGMMA_64x64(types, tail)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64" types " "                       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1" tail ";\n}\n"                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(da), "l"(db), "r"(accumulate))

struct Tf32 {
  typedef float T;
  static constexpr int V = 4;
  static __device__ __forceinline__ void put2(T* p, float x0, float x1) {
    uint32_t r0, r1;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r0) : "f"(x0));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r1) : "f"(x1));
    p[0] = __uint_as_float(r0);
    p[1] = __uint_as_float(r1);
  }
  static __device__ __forceinline__ void mma(float d[TC_COLS / 2],
                                             uint64_t da, uint64_t db,
                                             int accumulate) {
    WGMMA_64x64("k8.f32.tf32.tf32", "");
  }
};

struct Bf16 {
  typedef uint16_t T;
  static constexpr int V = 8;
  // cvt.rn.bf16x2.f32 puts its first source in the upper half
  static __device__ __forceinline__ void put2(T* p, float x0, float x1) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x1), "f"(x0));
    *reinterpret_cast<uint32_t*>(p) = r;
  }
  // the two immediates after the scales: A and B not transposed (K-major)
  static __device__ __forceinline__ void mma(float d[TC_COLS / 2],
                                             uint64_t da, uint64_t db,
                                             int accumulate) {
    WGMMA_64x64("k16.f32.bf16.bf16", ", 0, 0");
  }
};

template <class KIND, int KP>
struct TcSmem {
  typedef typename KIND::T T;
  T a[KP / KIND::V][TC_ROWS][KIND::V];  // the tile of G as wgmma reads it
  T b[KP / KIND::V][TC_COLS][KIND::V];  // the block's half of M, likewise
  float raw[TC_ROWS * KP];        // the tile of G as staged, K floats a row
  float red[4][TC_COLS];          // each warp's column maxima
};

// a shared-memory matrix descriptor without swizzle: the start address,
// the leading and the stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// keeps the compiler from moving an accumulator's reads or writes across
// the asynchronous product
__device__ __forceinline__ void fence_acc(float d[TC_COLS / 2]) {
#pragma unroll
  for (int i = 0; i < TC_COLS / 2; ++i)
    asm volatile("" : "+f"(d[i])::"memory");
}

template <class KIND, int KP>
__global__ void __launch_bounds__(LANES)
mm_tc_kernel(const float* __restrict__ G, int m, int k,
             const float* __restrict__ M, int steps, int zero, int chunks,
             int per, float* __restrict__ out_sum,
             float* __restrict__ out_max, float* __restrict__ part,
             int* __restrict__ tickets, int* __restrict__ ran) {
  constexpr int V = KIND::V;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  TcSmem<KIND, KP>& sh = *reinterpret_cast<TcSmem<KIND, KP>*>(smem_raw);
  const int l = threadIdx.x, warp = l >> 5, g = (l & 31) >> 2, q = l & 3;
  const Spread s = spread(m, TC_ROWS, TC_HALVES, chunks, per);
  const int col0 = s.half * TC_COLS;
  for (int i = l; i < KP / 2 * TC_COLS; i += LANES) {
    const int kk = 2 * (i / TC_COLS), n = i % TC_COLS;
    const float* x = M + kk * LANES + col0 + n;
    KIND::put2(&sh.b[kk / V][n][kk % V], kk < k ? x[0] : 0.0f,
               kk + 1 < k ? x[LANES] : 0.0f);
  }
  float acc[TC_COLS / 8][2], mx[TC_COLS / 8][2], d[TC_COLS / 2];
#pragma unroll
  for (int j = 0; j < TC_COLS / 8; ++j) {
    acc[j][0] = acc[j][1] = 0.0f;
    mx[j][0] = mx[j][1] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < TC_COLS / 2; ++i) d[i] = 0.0f;
  const int r0 = 16 * warp + g;           // this thread's rows r0, r0 + 8
  stage_span(sh.raw, G + (size_t)s.t0 * TC_ROWS * k,
             min(TC_ROWS, m - s.t0 * TC_ROWS) * k);
  for (int t = s.t0; t < s.t1; ++t) {
    const int rows = min(TC_ROWS, m - t * TC_ROWS);
    cp_async_wait_all();
    __syncthreads();                      // tile t staged, tile t - 1 read
    for (int i = l; i < TC_ROWS * KP / 2; i += LANES) {
      const int r = i / (KP / 2), kk = 2 * (i % (KP / 2));
      const float* x = sh.raw + r * k + kk;
      KIND::put2(&sh.a[kk / V][r][kk % V], r < rows && kk < k ? x[0] : 0.0f,
                 r < rows && kk + 1 < k ? x[1] : 0.0f);
    }
    // the generic proxy's writes of A (and B) seen by wgmma's async proxy
    fence_proxy_async();
    __syncthreads();                      // A laid out, the staged tile read
    if (t + 1 < s.t1)                     // the next tile while this one runs
      stage_span(sh.raw, G + (size_t)(t + 1) * TC_ROWS * k,
                 min(TC_ROWS, m - (t + 1) * TC_ROWS) * k);
    // which of this thread's rows add into the sum (tile 0's rows 0-7,
    // warp 0's r0) and which feed the maximum (the tile's real rows): the
    // fold below selects, so that it compiles without branches
    const bool sums = t == 0 && warp == 0;
    const bool max0 = !sums && r0 < rows, max1 = r0 + 8 < rows;
    for (int step = 0; step < steps; ++step) {
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < KP / (2 * V); ++ks)
        KIND::mma(d,
                  wgmma_desc(&sh.a[2 * ks][0][0], TC_ROWS * 16, 128) +
                      (step & zero),
                  wgmma_desc(&sh.b[2 * ks][0][0], TC_COLS * 16, 128),
                  ks > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
#pragma unroll
      for (int j = 0; j < TC_COLS / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float lo = d[4 * j + c], hi = d[4 * j + 2 + c];
          const float sum = acc[j][c] + lo;
          acc[j][c] = sums ? sum : acc[j][c];
          mx[j][c] = fmaxf(mx[j][c], max0 ? lo : -INFINITY);
          mx[j][c] = fmaxf(mx[j][c], max1 ? hi : -INFINITY);
        }
      }
    }
  }
  // the column maxima over a warp's 8 row groups (lanes q, q + 4, ...),
  // then over the 4 warps
#pragma unroll
  for (int j = 0; j < TC_COLS / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = mx[j][c];
      for (int o = 4; o < 32; o <<= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (g == 0) sh.red[warp][8 * j + 2 * q + c] = v;
    }
  }
  if (s.t0 == 0 && warp == 0) {
    float* o = out_sum + (size_t)s.copy * ROWS * LANES + col0;
#pragma unroll
    for (int j = 0; j < TC_COLS / 8; ++j) {
      o[g * LANES + 8 * j + 2 * q] = acc[j][0];
      o[g * LANES + 8 * j + 2 * q + 1] = acc[j][1];
    }
  }
  __syncthreads();
  float v = -INFINITY;
  if (l < TC_COLS)
    v = fmaxf(fmaxf(sh.red[0][l], sh.red[1][l]),
              fmaxf(sh.red[2][l], sh.red[3][l]));
  fold_max(v, col0 + l, TC_COLS, s, chunks, chunks * TC_HALVES, out_max,
           part, tickets);
  if (ran != nullptr && l == 0) atomicAdd(ran, 1);
}

// ---------------------------------------------------------------------------
// Gathers: out[i] = table[idx[i]] (NaN for an index outside [0, K))
// ---------------------------------------------------------------------------

// the table staged once per block in shared memory (up to 227 KB), then a
// grid-stride gather from it
__global__ void gather_smem_kernel(const float* __restrict__ table, int K,
                                   const int* __restrict__ idx, int n,
                                   float* __restrict__ out) {
  extern __shared__ float tab[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int j = idx[i];
    out[i] = (unsigned)j < (unsigned)K ? tab[j] : __int_as_float(QNAN_BITS);
  }
}

// a thread per index, reading the table from device memory (cached)
__global__ void gather_global_kernel(const float* __restrict__ table, int K,
                                     const int* __restrict__ idx, int n,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = idx[i];
  out[i] = (unsigned)j < (unsigned)K ? __ldg(table + j)
                                     : __int_as_float(QNAN_BITS);
}

// ---------------------------------------------------------------------------
// C entry points: each launches its kernel on `stream` and returns the CUDA
// error code of the launch (0 when accepted)
// ---------------------------------------------------------------------------

#define STREAM (cudaStream_t)stream

extern "C" int mts_probe_count(int* count, int n_launches, int blocks,
                               void* stream) {
  for (int i = 0; i < n_launches; ++i) {
    count_kernel<<<blocks, LANES, 0, STREAM>>>(count);
    const int err = launched();
    if (err) return err;
  }
  return 0;
}

// g 16-byte aligned (its rows are read as float4), rows >= 8; n may be 0
extern "C" int mts_probe_gate(const float* g, int rows, const int* ids,
                              const int* flags, int n, int blocks, float* out,
                              void* stream) {
  if (rows < ROWS || ((uintptr_t)g & 15) || n < 0)
    return (int)cudaErrorInvalidValue;
  gate_kernel<<<blocks, LANES, 0, STREAM>>>(g, rows, ids, flags, n, out);
  return launched();
}

// the instance of ring_kernel: grid's, or rotate's for a ring of `stages`
static const void* ring_instance(int grid, int stages) {
  if (grid) return (const void*)ring_kernel<GridRow0>;
  const int w = ring_width(stages);
  return w == 4   ? (const void*)ring_kernel<RotateSums<4>>
         : w == 2 ? (const void*)ring_kernel<RotateSums<2>>
                  : (const void*)ring_kernel<RotateSums<1>>;
}

// the ring's rules: blocks of a multiple of 4 floats and a source on 16
// bytes (the bulk copy's), up to RING_MAX_GROUP items a stage, up to
// RING_MAX_STAGES stages, all in a block's shared memory
static bool bad_ring(int item_floats, int group, int stages) {
  return item_floats <= 0 || item_floats % 4 || group < 1 ||
         group > RING_MAX_GROUP || stages < 1 || stages > RING_MAX_STAGES ||
         ring_smem(item_floats, group, stages) > SMEM_MAX;
}

static int ring_launch(int grid, const float* src, int item_floats,
                       const int* ids, int n, int group, int stages,
                       int blocks, float* out, void* stream) {
  if (bad_ring(item_floats, group, stages) || ((uintptr_t)src & 15) || n < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = ring_smem(item_floats, group, stages);
  const void* fn = ring_instance(grid, stages);
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&src, &item_floats, &ids, &n, &group, &stages, &out};
  const cudaError_t l = cudaLaunchKernel(fn, blocks, LANES, args,
                                         (size_t)smem, STREAM);
  return l != cudaSuccess ? (int)l : launched();
}

// a ring of `stages` blocks of block_floats (ops/probes.py ring_stages), an
// item a stage; n may be 0 (the sums are then 0)
extern "C" int mts_probe_rotate(const float* g, int block_floats,
                                const int* ids, int n, int stages,
                                int blocks, float* out, void* stream) {
  if (block_floats < ROWS * ROW_COLS || block_floats > MAX_STAGE)
    return (int)cudaErrorInvalidValue;
  return ring_launch(0, g, block_floats, ids, n, 1, stages, blocks, out,
                     stream);
}

// fetch: the ring, `group` items a stage and `stages` stages
// (ops/probes.py grid_plan); else the plain loop. n may be 0
extern "C" int mts_probe_grid(const float* tri, const int* ids, int n,
                              int fetch, int group, int stages, int blocks,
                              float* out, void* stream) {
  if (fetch)
    return ring_launch(1, tri, GRID_FLOATS, ids, n, group, stages, blocks,
                       out, stream);
  if (n < 0) return (int)cudaErrorInvalidValue;
  grid_loop_kernel<<<blocks, LANES, 0, STREAM>>>(tri, n, out);
  return launched();
}

// a ring instance's resources on the current card (grid's, or rotate's)
// at `group` items of item_floats a stage and `stages` stages: blocks
// resident per SM, registers per thread, shared memory bytes a block
// (static and dynamic), local (spill) bytes per thread, and the items a
// wait covers (rotate's W, grid's group)
extern "C" int mts_probe_ring_info(int grid, int item_floats, int group,
                                   int stages, int* out) {
  if (bad_ring(item_floats, group, stages)) return (int)cudaErrorInvalidValue;
  const int dyn = ring_smem(item_floats, group, stages);
  const void* fn = ring_instance(grid, stages);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return (int)e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, LANES,
                                                         dyn)) != cudaSuccess)
    return (int)e;
  out[0] = per_sm;
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes + dyn;
  out[3] = (int)attr.localSizeBytes;
  out[4] = grid ? group : ring_width(stages);
  return 0;
}

extern "C" int mts_probe_fma(const float* a, const float* b, int n_ops,
                             int steps, int blocks, float* out, void* stream) {
  fma_kernel<<<blocks, LANES, 0, STREAM>>>(a, b, n_ops, steps, out);
  return launched();
}

static bool bad_k(int K) { return K <= 0 || K > MAX_K || K % ROWS; }

// the variants take chunks in even / odd pairs; the packed forms keep the
// chunk in 2 bits
static bool bad_pair_k(int K) { return K <= 0 || K > 4 * ROWS || K % 16; }

extern "C" int mts_probe_mt(const float* tri, int K, const float* rays,
                            int steps, int zero, int blocks, float* out_t,
                            int* out_p, void* stream) {
  if (bad_k(K)) return (int)cudaErrorInvalidValue;
  mt_kernel<<<blocks, LANES, 0, STREAM>>>(tri, K, rays, steps, zero, out_t,
                                          out_p);
  return launched();
}

extern "C" int mts_probe_v0(const float* rays, int reps, int blocks,
                            float* out, void* stream) {
  v0_kernel<<<blocks, LANES, 0, STREAM>>>(rays, reps, out);
  return launched();
}

extern "C" int mts_probe_v1(const float* tri, int K, const float* rays,
                            int reps, int add_u, int blocks, float* out,
                            int* out_hits, void* stream) {
  if (bad_pair_k(K)) return (int)cudaErrorInvalidValue;
  v1_kernel<<<blocks, LANES, 0, STREAM>>>(tri, K, rays, reps, add_u, out,
                                          out_hits);
  return launched();
}

extern "C" int mts_probe_v2(const float* tri, int K, const float* rays,
                            int reps, int blocks, float* out, int* out_hits,
                            void* stream) {
  if (bad_pair_k(K)) return (int)cudaErrorInvalidValue;
  packed_kernel<false><<<blocks, LANES, 0, STREAM>>>(tri, K, rays, reps, out,
                                                     out_hits);
  return launched();
}

extern "C" int mts_probe_v4(const float* tri, int K, const float* rays,
                            int reps, int blocks, float* out, int* out_hits,
                            void* stream) {
  if (bad_pair_k(K)) return (int)cudaErrorInvalidValue;
  packed_kernel<true><<<blocks, LANES, 0, STREAM>>>(tri, K, rays, reps, out,
                                                    out_hits);
  return launched();
}

// a launch's tile plan (ops/probes.py mm_plan): chunks of `per` tiles,
// every tile in exactly one
static bool bad_plan(int m, int tile_rows, int chunks, int per) {
  const int tiles = (m + tile_rows - 1) / tile_rows;
  return chunks < 1 || per < 1 || (chunks - 1) * per >= tiles ||
         chunks * per < tiles;
}

// part (copies, chunks, 128) floats and tickets (copies) ints, zero
// between launches: read only where chunks > 1; ran, where not null, an
// int to which every block of the launch adds one as it ends
extern "C" int mts_probe_mm_cuda(const float* G, int m, const float* M,
                                 int steps, int zero, int copies, int chunks,
                                 int per, float* out_sum, float* out_max,
                                 float* part, int* tickets, int* ran,
                                 void* stream) {
  if (m < ROWS || copies < 1 || bad_plan(m, MM_ROWS, chunks, per))
    return (int)cudaErrorInvalidValue;
  mm_cuda_kernel<<<copies * chunks, LANES, 0, STREAM>>>(
      G, m, M, steps, zero, chunks, per, out_sum, out_max, part, tickets,
      ran);
  return launched();
}

template <class KIND, int KP>
static int launch_tc(const float* G, int m, int k, const float* M, int steps,
                     int zero, int copies, int chunks, int per,
                     float* out_sum, float* out_max, float* part,
                     int* tickets, int* ran, cudaStream_t stream) {
  const int smem = (int)sizeof(TcSmem<KIND, KP>);
  const cudaError_t e = cudaFuncSetAttribute(
      mm_tc_kernel<KIND, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  mm_tc_kernel<KIND, KP><<<copies * TC_HALVES * chunks, LANES, smem,
                           stream>>>(G, m, k, M, steps, zero, chunks, per,
                                     out_sum, out_max, part, tickets, ran);
  return launched();
}

// G (m, k) and M (k, 128) float32 as the caller holds them, k <= 16 or
// k = 128
template <class KIND>
static int launch_tc_depth(const float* G, int m, int k, const float* M,
                           int steps, int zero, int copies, int chunks,
                           int per, float* out_sum, float* out_max,
                           float* part, int* tickets, int* ran,
                           void* stream) {
  if (m < ROWS || copies < 1 || bad_plan(m, TC_ROWS, chunks, per))
    return (int)cudaErrorInvalidValue;
  if (k >= 1 && k <= 16)
    return launch_tc<KIND, 16>(G, m, k, M, steps, zero, copies, chunks, per,
                               out_sum, out_max, part, tickets, ran, STREAM);
  if (k == 128)
    return launch_tc<KIND, 128>(G, m, k, M, steps, zero, copies, chunks, per,
                                out_sum, out_max, part, tickets, ran, STREAM);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mts_probe_mm_tf32(const float* G, int m, int k, const float* M,
                                 int steps, int zero, int copies, int chunks,
                                 int per, float* out_sum, float* out_max,
                                 float* part, int* tickets, int* ran,
                                 void* stream) {
  return launch_tc_depth<Tf32>(G, m, k, M, steps, zero, copies, chunks, per,
                               out_sum, out_max, part, tickets, ran, stream);
}

extern "C" int mts_probe_mm_bf16(const float* G, int m, int k, const float* M,
                                 int steps, int zero, int copies, int chunks,
                                 int per, float* out_sum, float* out_max,
                                 float* part, int* tickets, int* ran,
                                 void* stream) {
  return launch_tc_depth<Bf16>(G, m, k, M, steps, zero, copies, chunks, per,
                               out_sum, out_max, part, tickets, ran, stream);
}

// the resources of a product kernel on the current card (which: 0
// mm_cuda, 1 mm_tf32 at K <= 16, 2 at K = 128, 3 and 4 mm_bf16 likewise):
// blocks resident per SM, registers per thread, shared memory bytes a
// block (static and dynamic), local (spill) bytes per thread, rows of G a
// tile and halves of M's columns (ops/probes.py TILE_ROWS, HALVES)
extern "C" int mts_probe_mm_info(int which, int* out) {
  const void* fns[] = {(const void*)mm_cuda_kernel,
                       (const void*)mm_tc_kernel<Tf32, 16>,
                       (const void*)mm_tc_kernel<Tf32, 128>,
                       (const void*)mm_tc_kernel<Bf16, 16>,
                       (const void*)mm_tc_kernel<Bf16, 128>};
  const int dyns[] = {0, (int)sizeof(TcSmem<Tf32, 16>),
                      (int)sizeof(TcSmem<Tf32, 128>),
                      (int)sizeof(TcSmem<Bf16, 16>),
                      (int)sizeof(TcSmem<Bf16, 128>)};
  if (which < 0 || which > 4) return (int)cudaErrorInvalidValue;
  const void* fn = fns[which];
  const int dyn = dyns[which];
  cudaError_t e;
  if (dyn && (e = cudaFuncSetAttribute(
                  fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn)) !=
                 cudaSuccess)
    return (int)e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return (int)e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, LANES,
                                                         dyn)) != cudaSuccess)
    return (int)e;
  out[0] = per_sm;
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes + dyn;
  out[3] = (int)attr.localSizeBytes;
  out[4] = which == 0 ? MM_ROWS : TC_ROWS;
  out[5] = which == 0 ? 1 : TC_HALVES;
  return 0;
}

#define GATHER_THREADS 1024

extern "C" int mts_probe_gather_smem(const float* table, int K, const int* idx,
                                     int n, float* out, void* stream) {
  const int smem = K * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gather_smem_kernel, GATHER_THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int need = (n + GATHER_THREADS - 1) / GATHER_THREADS;
  const int blocks = need < sms * per_sm ? need : sms * per_sm;
  if (blocks < 1) return 0;
  gather_smem_kernel<<<blocks, GATHER_THREADS, smem, STREAM>>>(table, K, idx,
                                                               n, out);
  return launched();
}

extern "C" int mts_probe_gather_global(const float* table, int K,
                                       const int* idx, int n, float* out,
                                       void* stream) {
  if (n <= 0) return 0;
  gather_global_kernel<<<(n + 255) / 256, 256, 0, STREAM>>>(table, K, idx, n,
                                                            out);
  return launched();
}
