// Brute-force intersectors for Hopper (sm_90a): every ray of a wavefront
// against every triangle of a small scene.
//
// Replaces the TPU kernels of mitsuba_tpu/ops/intersect_pallas.py with
// four instances of one kernel, brute_kernel<kClosest, kShade, kAny,
// kStride, kStill>:
//   #1 <true, true, true, 29, false>    _shaded_any_kernel :337 (closest_hit_shaded_and_any :432)
//   #2 <true, true, false, 29, false>   _shaded_kernel     :202 (closest_hit_shaded :281)
//   #3 <false, false, true, 9, true>    _any_kernel        :97  (any_hit :165)
//   #4 <true, false, false, 9, false>   _closest_kernel    :59  (closest_hit :139)
// kClosest and kAny: the halves an instance runs, the closest hit of one
// ray set and the any-hit occlusion of another; kShade: whether the
// closest half writes the shading record or only t, u, v, prim and
// valid; kStride: the table's row stride, 29 for the (T, 29) shading
// table, 9 for the (T, 9) v0 | e1 | e2 table; kStill: whether the
// compaction also drops a lane whose direction is zero (below). They
// compute what those kernels compute, not how. Wrapped by
// mitsuba_tpu_torch/ops/intersect.py, whose `*_ref` functions are the
// plain PyTorch versions they agree with lane for lane.
//
// Semantics kept from the reference, lane for lane:
//   |det| > 1e-9, t > mint, t < maxt, and the strict t < t_best, so the
//   lowest index wins a tie; on a miss t = inf, u = v = 0, prim = -1,
//   ids = -1 and both normals (0, 0, 1); the normals are renormalised once
//   at the end with the 1e-20 floor; a lane with maxt <= mint (dead or
//   padded) or a zero direction never hits; occlusion is the OR over all
//   triangles.
// The shading record is interpolated once, from the winning row, instead
// of for every candidate: the same formula on the same inputs, so the
// same value. Built with --fmad=false and IEEE division and square root,
// each instance rounds as its plain PyTorch version.
//
// What bounds them on this card is the instruction rate of the
// Moeller-Trumbore tests: at T = 32 a lane moves ~126 bytes (its rays in,
// its record out) against 32 tests of ~60 instructions for each of its
// rays, so at the card's instruction rate the bytes take a fifth of the
// tests' time. The design runs fewer tests and nothing else around them:
//   * each block of kThreads lanes compacts the live lanes of each ray
//     set in lane order (a ballot a warp, a prefix over the warps'
//     counts): thread t tests the t-th live lane, so warps past the
//     block's live count run no test, and a dead lane, which can never
//     hit, gets the miss record (not occluded) without one. A lane is
//     live where mint < maxt and, with kStill, its direction is not
//     zero: a zero direction makes det 0 for every row, whose reciprocal
//     takes the IEEE division's slow path (the compiler divides before
//     it selects). The fog path traces its ended paths' NEE rays so
//     (#3's caller, 15-30% of a later bounce's lanes); where no lane has
//     a zero direction, the direction loads before the compaction's
//     barrier cost #1 and #2 1.5-2.6% (PERF.md), so they go without;
//   * the table's test columns (v0 | e1 | e2) are staged once per block,
//     kRows rows a pass, as three 16-byte records a row (`mt_test4`):
//     three broadcast loads a test, where a thread reading the row's
//     floats would issue 9. A table of more rows is staged in passes, in
//     row order, so the strict t < t_best keeps the lowest index across
//     passes;
//   * a warp's any-hit half stops once each of its live lanes is occluded
//     (a vote every kGroup rows); the OR is the same;
//   * the outputs are written in their final layout (t, u, v, prim; geo_n
//     and sh_n (N, 3), uv (N, 2) and the ids where shaded; valid and
//     occluded as bool bytes), so a wrapper launches nothing around its
//     instance.
// Each half runs over all rows in turn. Tried and dropped (PERF.md): both
// tests of a row in one loop, 2 and 4 lanes a thread, each warp
// compacting its own lanes, a persistent grid.

#include <cuda_runtime.h>

#include "mt.cuh"

constexpr int kCols = 29;        // table row: v0|e1|e2|n0|n1|n2|uv0|uv1|uv2|mid|eid|sid|pad2
constexpr int kTriCols = 9;      // v0|e1|e2
constexpr int kThreads = 256;
constexpr float kDetEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;    // blocks of kThreads resident on an SM
constexpr int kRows = 256;       // test rows staged per pass: 12 KB
constexpr int kGroup = 8;        // rows between the any-hit half's votes

// One lane's ray, or a dead ray (maxt = -1 < mint) past the end.
struct LaneRay {
  float o[3], d[3], mn, mx;
};

__device__ __forceinline__ LaneRay load_ray(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ mint, const float* __restrict__ maxt, int i,
    bool live) {
  LaneRay r{{0.f, 0.f, 0.f}, {0.f, 0.f, 1.f}, 0.f, -1.f};
  if (live) {
    r.o[0] = o[3 * i]; r.o[1] = o[3 * i + 1]; r.o[2] = o[3 * i + 2];
    r.d[0] = d[3 * i]; r.d[1] = d[3 * i + 1]; r.d[2] = d[3 * i + 2];
    r.mn = mint[i]; r.mx = maxt[i];
  }
  return r;
}

// N rays: o, d (N, 3), mint, maxt (N,)
struct Rays {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ mint;
  const float* __restrict__ maxt;
};

// the outputs in their final layout; valid and occ are bool bytes. An
// instance writes t, u, v, prim and valid if it has a closest half, the
// rest of the shading record if kShade, occ if it has an any-hit half
struct Record {
  float* t; float* u; float* v; int* prim; unsigned char* valid;
  float* geo_n; float* sh_n; float* uv;
  int* mid; int* eid; int* sid; unsigned char* occ;
};

// Rows [c0, c0 + rows) of a (T, cols) table's test columns v0 | e1 | e2
// into shared memory, three float4s a row (the last three floats unused).
template <int cols>
__device__ __forceinline__ void stage_tests(float4* tab,
                                            const float* __restrict__ table,
                                            int c0, int rows) {
  float* f = reinterpret_cast<float*>(tab);
  for (int k = threadIdx.x; k < rows * kTriCols; k += blockDim.x) {
    const int r = k / kTriCols;
    const int c = k - r * kTriCols;
    f[r * 12 + c] = table[static_cast<size_t>(c0 + r) * cols + c];
  }
}

// Compact the block's live lanes (below n, mint < maxt and, with kStill,
// a direction other than zero) of one ray set in lane order: slots[s] is
// the s-th live lane of the block's kThreads lanes from `first`.
// `counts` holds a count a warp. Returns the block's count; `live` is
// whether this thread's own lane is live. Two barriers.
template <bool kStill>
__device__ __forceinline__ int compact(const Rays& r, int first, int n,
                                       int* counts, int* slots, bool& live) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = first + threadIdx.x;
  live = i < n && r.mint[i] < r.maxt[i];
  if constexpr (kStill)
    live = live && (r.d[3 * i] != 0.f || r.d[3 * i + 1] != 0.f ||
                    r.d[3 * i + 2] != 0.f);
  const unsigned m = __ballot_sync(kFull, live);
  if (lane == 0) counts[warp] = __popc(m);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? counts[w] : 0;
    total += counts[w];
  }
  if (live) slots[off + __popc(m & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return total;
}

// Lane i's t, u, v, prim and valid from its winning row p (p < 0: a
// miss), as the plain version's `closest_hit_ref` returns them.
__device__ __forceinline__ void write_hit(const Record& out, int i, float t_b,
                                          float u_b, float v_b, int p_b) {
  out.t[i] = t_b; out.u[i] = u_b; out.v[i] = v_b;
  out.prim[i] = p_b; out.valid[i] = p_b >= 0 ? 1 : 0;
}

// Lane i's record from its winning row p (p < 0: the miss record), as the
// plain version's `_shading_record` computes it.
__device__ __forceinline__ void write_record(const Record& out,
                                             const float* __restrict__ table,
                                             int i, float t_b, float u_b,
                                             float v_b, int p_b) {
  float gx = 0.f, gy = 0.f, gz = 1.f, sx = 0.f, sy = 0.f, sz = 1.f;
  float tu = 0.f, tv = 0.f;
  int mid = -1, eid = -1, sid = -1;
  if (p_b >= 0) {
    const float* row = table + static_cast<size_t>(p_b) * kCols;
    const float e1x = row[3], e1y = row[4], e1z = row[5];
    const float e2x = row[6], e2y = row[7], e2z = row[8];
    gx = e1y * e2z - e1z * e2y;
    gy = e1z * e2x - e1x * e2z;
    gz = e1x * e2y - e1y * e2x;
    const float w = 1.0f - u_b - v_b;
    sx = w * row[9] + u_b * row[12] + v_b * row[15];
    sy = w * row[10] + u_b * row[13] + v_b * row[16];
    sz = w * row[11] + u_b * row[14] + v_b * row[17];
    tu = w * row[18] + u_b * row[20] + v_b * row[22];
    tv = w * row[19] + u_b * row[21] + v_b * row[23];
    mid = static_cast<int>(row[24]);
    eid = static_cast<int>(row[25]);
    sid = static_cast<int>(row[26]);
  }
  const float g_inv = 1.0f / sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-20f));
  const float s_inv = 1.0f / sqrtf(fmaxf(sx * sx + sy * sy + sz * sz, 1e-20f));
  write_hit(out, i, t_b, u_b, v_b, p_b);
  out.geo_n[3 * i] = gx * g_inv;
  out.geo_n[3 * i + 1] = gy * g_inv;
  out.geo_n[3 * i + 2] = gz * g_inv;
  out.sh_n[3 * i] = sx * s_inv;
  out.sh_n[3 * i + 1] = sy * s_inv;
  out.sh_n[3 * i + 2] = sz * s_inv;
  out.uv[2 * i] = tu; out.uv[2 * i + 1] = tv;
  out.mid[i] = mid; out.eid[i] = eid; out.sid[i] = sid;
}

// a closest hit so far: the first row of least t (strict <)
struct Best {
  float t, u, v;
  int p;
};

// A closest slot's hit over rows [0, rows) of the staged pass from
// table row c0.
__device__ __forceinline__ void closest_rows(const float4* tab, int rows,
                                             int c0, const LaneRay& r,
                                             Best& best) {
  for (int j = 0; j < rows; ++j) {
    float t, u, v;
    const bool h = mt_test4(tab[3 * j], tab[3 * j + 1], tab[3 * j + 2], r.o,
                            r.d, r.mn, r.mx, kDetEps, t, u, v);
    if (h && t < best.t) best = {t, u, v, c0 + j};
  }
}

// An any-hit slot's occlusion over rows [0, rows) of the staged pass:
// before each group of kGroup rows the warp votes, and stops once each
// of its live slots is occluded (slots from ns on are not live).
__device__ __forceinline__ void any_rows(const float4* tab, int rows,
                                         const LaneRay& r, int q, int ns,
                                         bool& oc) {
  for (int j0 = 0; j0 < rows; j0 += kGroup) {
    if (__all_sync(kFull, oc || q >= ns)) return;
    const int j1 = min(j0 + kGroup, rows);
    for (int j = j0; j < j1; ++j) {
      float t, u, v;
      const bool h = mt_test4(tab[3 * j], tab[3 * j + 1], tab[3 * j + 2],
                              r.o, r.d, r.mn, r.mx, kDetEps, t, u, v);
      oc = oc || h;
    }
  }
}

template <bool kShade>
__device__ __forceinline__ void write_closest(const Record& out,
                                              const float* __restrict__ table,
                                              int i, const Best& b) {
  if constexpr (kShade)
    write_record(out, table, i, b.t, b.u, b.v, b.p);
  else
    write_hit(out, i, b.t, b.u, b.v, b.p);
}

template <bool kClosest, bool kShade, bool kAny, int kStride, bool kStill>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
brute_kernel(const float* __restrict__ table, int n_tris, Rays br, Rays sr,
             int n, Record out) {
  static_assert(kClosest || kAny, "an instance runs at least one half");
  static_assert(!kShade || (kClosest && kStride == kCols),
                "the shading record needs the (T, 29) table");
  constexpr int kSets = (kClosest ? 1 : 0) + (kAny ? 1 : 0);
  constexpr int kA = kClosest ? 1 : 0;   // the any-hit set's index
  __shared__ float4 tab[kRows * 3];
  __shared__ int slots[kSets][kThreads];
  __shared__ int counts[kSets][kWarps];
  const int first = blockIdx.x * kThreads;
  const int q = threadIdx.x;          // this thread's slot
  const int q_warp = q & ~31;         // its warp's first slot
  const float inf = __int_as_float(0x7f800000);
  const Best miss{inf, 0.f, 0.f, -1};

  // each ray set's live lanes, compacted over the block; a dead lane gets
  // the miss record (not occluded) without a test
  bool b_own = false, s_own = false;
  int nb = 0, ns = 0;
  if constexpr (kClosest)
    nb = compact<kStill>(br, first, n, counts[0], slots[0], b_own);
  if constexpr (kAny)
    ns = compact<kStill>(sr, first, n, counts[kA], slots[kA], s_own);
  const int i = first + threadIdx.x;
  if constexpr (kClosest) {
    if (i < n && !b_own) write_closest<kShade>(out, table, i, miss);
  }
  if constexpr (kAny) {
    if (i < n && !s_own) out.occ[i] = 0;
  }

  LaneRay b{}, s{};
  if constexpr (kClosest)
    b = load_ray(br.o, br.d, br.mint, br.maxt, q < nb ? slots[0][q] : 0,
                 q < nb);
  if constexpr (kAny)
    s = load_ray(sr.o, sr.d, sr.mint, sr.maxt, q < ns ? slots[kA][q] : 0,
                 q < ns);
  Best best = miss;
  bool oc = false;

  const int n_chunks = (n_tris + kRows - 1) / kRows;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kRows;
    const int rows = min(kRows, n_tris - c0);
    __syncthreads();                    // the previous pass is read
    stage_tests<kStride>(tab, table, c0, rows);
    __syncthreads();
    // warp-uniform: a warp with no live slot runs no test
    if constexpr (kClosest) {
      if (q_warp < nb) closest_rows(tab, rows, c0, b, best);
    }
    if constexpr (kAny) {
      if (q_warp < ns) any_rows(tab, rows, s, q, ns, oc);
    }
  }

  if constexpr (kClosest) {
    if (q < nb) write_closest<kShade>(out, table, slots[0][q], best);
  }
  if constexpr (kAny) {
    if (q < ns) out.occ[slots[kA][q]] = oc ? 1 : 0;
  }
}

static int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <bool kClosest, bool kShade, bool kAny, int kStride, bool kStill>
static int launch(const float* table, int n_tris, Rays br, Rays sr, int n,
                  Record out, void* stream) {
  if (n > 0)
    brute_kernel<kClosest, kShade, kAny, kStride, kStill>
        <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            table, n_tris, br, sr, n, out);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError(), so a refused launch is reported.
extern "C" int mts_shaded_any(
    const float* table, int n_tris, const float* o, const float* d,
    const float* mint, const float* maxt, const float* so, const float* sd,
    const float* smint, const float* smaxt, int n, float* t, float* u,
    float* v, int* prim, unsigned char* valid, float* geo_n, float* sh_n,
    float* uv, int* mid, int* eid, int* sid, unsigned char* occ,
    void* stream) {
  const Record out{t, u, v, prim, valid, geo_n, sh_n, uv, mid, eid, sid, occ};
  return launch<true, true, true, kCols, false>(
      table, n_tris, Rays{o, d, mint, maxt}, Rays{so, sd, smint, smaxt}, n,
      out, stream);
}

extern "C" int mts_shaded(
    const float* table, int n_tris, const float* o, const float* d,
    const float* mint, const float* maxt, int n, float* t, float* u,
    float* v, int* prim, unsigned char* valid, float* geo_n, float* sh_n,
    float* uv, int* mid, int* eid, int* sid, void* stream) {
  const Record out{t, u, v, prim, valid, geo_n, sh_n, uv, mid, eid, sid,
                   nullptr};
  const Rays r{o, d, mint, maxt};
  return launch<true, true, false, kCols, false>(table, n_tris, r, r, n,
                                                 out, stream);
}

extern "C" int mts_any(const float* table, int n_tris, const float* o,
                       const float* d, const float* mint, const float* maxt,
                       int n, unsigned char* occ, void* stream) {
  Record out{};
  out.occ = occ;
  const Rays r{o, d, mint, maxt};
  return launch<false, false, true, kTriCols, true>(table, n_tris, r, r,
                                                    n, out, stream);
}

extern "C" int mts_closest(const float* table, int n_tris, const float* o,
                           const float* d, const float* mint,
                           const float* maxt, int n, float* t, float* u,
                           float* v, int* prim, unsigned char* hit,
                           void* stream) {
  Record out{};
  out.t = t; out.u = u; out.v = v; out.prim = prim; out.valid = hit;
  const Rays r{o, d, mint, maxt};
  return launch<true, false, false, kTriCols, false>(table, n_tris, r, r,
                                                     n, out, stream);
}

static int info_of(const void* kern, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern,
                                                      kThreads, 0);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

// The resources of kernel `kind` (0 #2, 1 #1, 2 #3, 3 #4): out[0]
// resident blocks of kThreads per SM, out[1] registers per thread, out[2]
// static shared memory bytes per block, out[3] local memory bytes per
// thread (spills)
extern "C" int mts_brute_info(int kind, int* out) {
  const void* kerns[] = {
      (const void*)brute_kernel<true, true, false, kCols, false>,
      (const void*)brute_kernel<true, true, true, kCols, false>,
      (const void*)brute_kernel<false, false, true, kTriCols, true>,
      (const void*)brute_kernel<true, false, false, kTriCols, false>};
  if (kind < 0 || kind > 3) return static_cast<int>(cudaErrorInvalidValue);
  return info_of(kerns[kind], out);
}
