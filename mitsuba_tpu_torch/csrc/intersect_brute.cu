// Brute-force intersectors for Hopper (sm_90a): every ray of a wavefront
// against every triangle of a small scene.
//
// Replaces the TPU kernels of mitsuba_tpu/ops/intersect_pallas.py:
//   #1 shaded_any_kernel<true>   _shaded_any_kernel :337 (closest_hit_shaded_and_any :432)
//   #2 shaded_any_kernel<false>  _shaded_kernel     :202 (closest_hit_shaded :281)
//   #3 any_kernel                _any_kernel        :97  (any_hit :165)
//   #4 closest_kernel            _closest_kernel    :59  (closest_hit :139)
// They compute what those kernels compute, not how: one thread per lane.
// The table ((T, 29) for #1 and #2, layout in
// mitsuba_tpu_torch/ops/intersect.py; (T, 9) v0|e1|e2 for #3 and #4) is
// staged into shared memory in chunks of kChunk rows; every thread of a
// block reads the same row at the same time, a broadcast without bank
// conflicts. Rays are read as the (N, 3) and (N,) tensors they are; the
// ragged end is bounds-checked. #1 takes each lane's bounce ray and its
// shadow ray through one loop, so each row is read once for two rays, as
// on the TPU; #2 is the same body without the shadow half.
//
// Semantics kept from the reference, lane for lane:
//   |det| > 1e-9, t > mint, t < maxt, and the strict t < t_best, so the
//   lowest index wins a tie; on a miss t = inf, u = v = 0, prim = -1,
//   ids = -1 and both normals (0, 0, 1); the normals are renormalised once
//   at the end with the 1e-20 floor; a lane with maxt < mint (dead or
//   padded) never hits; occlusion is the OR over all triangles.
// The shading record is interpolated once, from the winning row, instead
// of for every candidate: the same formula on the same inputs, so the
// same value. An any-hit lane stops testing once it is occluded, and a
// block stops staging chunks once none of its lanes needs them; the OR is
// the same. Built with --fmad=false and IEEE division and square root,
// each kernel rounds as its plain PyTorch version in ops/intersect.py.
//
// What bounds them: at T = 32 and 1M lanes a lane of #2 moves 24 words
// (8 in, 16 out with the ids), ~100 MB per launch, against 32 x 53 flops,
// ~1.8 GFLOP: near the card's balance point, so neither the 3.35 TB/s nor
// the fp32 rate is saturated by this simple layout. #3 and #4 read the
// same 8 words per lane and write 1 and 5. A warp-cooperative layout and
// the table in registers or constant memory are later work.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kCols = 29;        // table row: v0|e1|e2|n0|n1|n2|uv0|uv1|uv2|mid|eid|sid|pad2
constexpr int kTriCols = 9;      // v0|e1|e2
constexpr int kThreads = 256;
constexpr int kChunk = 128;      // rows staged per pass: 14.8 KB (29 cols), 4.6 KB (9)
constexpr float kDetEps = 1e-9f;

struct Outputs {
  float* t; float* u; float* v; int* prim; int* hit;
  float* gx; float* gy; float* gz;
  float* sx; float* sy; float* sz;
  float* uvx; float* uvy;
  int* mid; int* eid; int* sid; int* occ;
};

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

// Copy rows [c0, c0 + rows) of a (T, cols) table into shared memory.
__device__ __forceinline__ void stage(float* tab,
                                      const float* __restrict__ table,
                                      int c0, int rows, int cols) {
  for (int k = threadIdx.x; k < rows * cols; k += blockDim.x)
    tab[k] = table[c0 * cols + k];
}

template <bool kShadow>
__global__ void __launch_bounds__(kThreads)
shaded_any_kernel(const float* __restrict__ table, int n_tris,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ mint,
                  const float* __restrict__ maxt,
                  const float* __restrict__ so, const float* __restrict__ sd,
                  const float* __restrict__ smint,
                  const float* __restrict__ smaxt, int n, Outputs out) {
  __shared__ float tab[kChunk * kCols];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const LaneRay r = load_ray(o, d, mint, maxt, i, live);
  LaneRay s{};
  if constexpr (kShadow) s = load_ray(so, sd, smint, smaxt, i, live);

  float t_b = __int_as_float(0x7f800000);  // +inf
  float u_b = 0.f, v_b = 0.f;
  int p_b = -1;
  bool occ = false;
  for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
    const int rows = min(kChunk, n_tris - c0);
    __syncthreads();  // the previous chunk is no longer read
    stage(tab, table, c0, rows, kCols);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      const float* row = tab + j * kCols;
      float t, u, v;
      if (mt_test(row, r.o, r.d, r.mn, r.mx, kDetEps, t, u, v) && t < t_b) {
        t_b = t; u_b = u; v_b = v; p_b = c0 + j;
      }
      if constexpr (kShadow) {
        if (!occ) occ = mt_test(row, s.o, s.d, s.mn, s.mx, kDetEps, t, u, v);
      }
    }
  }
  if (!live) return;

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

  out.t[i] = t_b; out.u[i] = u_b; out.v[i] = v_b;
  out.prim[i] = p_b; out.hit[i] = p_b >= 0 ? 1 : 0;
  out.gx[i] = gx * g_inv; out.gy[i] = gy * g_inv; out.gz[i] = gz * g_inv;
  out.sx[i] = sx * s_inv; out.sy[i] = sy * s_inv; out.sz[i] = sz * s_inv;
  out.uvx[i] = tu; out.uvy[i] = tv;
  out.mid[i] = mid; out.eid[i] = eid; out.sid[i] = sid;
  if constexpr (kShadow) out.occ[i] = occ ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ table, int n_tris,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ mint, const float* __restrict__ maxt,
           int n, int* __restrict__ occ_out) {
  __shared__ float tab[kChunk * kTriCols];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const LaneRay r = load_ray(o, d, mint, maxt, i, live);
  bool occ = false;
  for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
    // a barrier like __syncthreads (the previous chunk is no longer
    // read), and the block stops once no lane needs another chunk
    if (!__syncthreads_or(live && !occ && r.mx >= r.mn)) break;
    const int rows = min(kChunk, n_tris - c0);
    stage(tab, table, c0, rows, kTriCols);
    __syncthreads();
    for (int j = 0; j < rows && !occ; ++j) {
      float t, u, v;
      occ = mt_test(tab + j * kTriCols, r.o, r.d, r.mn, r.mx, kDetEps, t, u,
                    v);
    }
  }
  if (live) occ_out[i] = occ ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ table, int n_tris,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ mint,
               const float* __restrict__ maxt, int n, float* __restrict__ t_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               int* __restrict__ prim_out, int* __restrict__ hit_out) {
  __shared__ float tab[kChunk * kTriCols];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const LaneRay r = load_ray(o, d, mint, maxt, i, live);
  float t_b = __int_as_float(0x7f800000);  // +inf
  float u_b = 0.f, v_b = 0.f;
  int p_b = -1;
  for (int c0 = 0; c0 < n_tris; c0 += kChunk) {
    const int rows = min(kChunk, n_tris - c0);
    __syncthreads();  // the previous chunk is no longer read
    stage(tab, table, c0, rows, kTriCols);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      float t, u, v;
      if (mt_test(tab + j * kTriCols, r.o, r.d, r.mn, r.mx, kDetEps, t, u,
                  v) && t < t_b) {
        t_b = t; u_b = u; v_b = v; p_b = c0 + j;
      }
    }
  }
  if (!live) return;
  t_out[i] = t_b; u_out[i] = u_b; v_out[i] = v_b;
  prim_out[i] = p_b; hit_out[i] = p_b >= 0 ? 1 : 0;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError(), so a refused launch is reported.
extern "C" int mts_shaded_any(
    const float* table, int n_tris, const float* o, const float* d,
    const float* mint, const float* maxt, const float* so, const float* sd,
    const float* smint, const float* smaxt, int n, float* t, float* u,
    float* v, int* prim, int* hit, float* gx, float* gy, float* gz,
    float* sx, float* sy, float* sz, float* uvx, float* uvy, int* mid,
    int* eid, int* sid, int* occ, void* stream) {
  if (n > 0) {
    const Outputs out{t, u, v, prim, hit, gx, gy, gz, sx, sy, sz,
                      uvx, uvy, mid, eid, sid, occ};
    shaded_any_kernel<true><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, o, d, mint, maxt, so, sd, smint, smaxt, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mts_shaded(
    const float* table, int n_tris, const float* o, const float* d,
    const float* mint, const float* maxt, int n, float* t, float* u,
    float* v, int* prim, int* hit, float* gx, float* gy, float* gz,
    float* sx, float* sy, float* sz, float* uvx, float* uvy, int* mid,
    int* eid, int* sid, void* stream) {
  if (n > 0) {
    const Outputs out{t, u, v, prim, hit, gx, gy, gz, sx, sy, sz,
                      uvx, uvy, mid, eid, sid, nullptr};
    shaded_any_kernel<false><<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, o, d, mint, maxt, nullptr, nullptr, nullptr, nullptr,
        n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mts_any(const float* table, int n_tris, const float* o,
                       const float* d, const float* mint, const float* maxt,
                       int n, int* occ, void* stream) {
  if (n > 0) {
    any_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, o, d, mint, maxt, n, occ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mts_closest(const float* table, int n_tris, const float* o,
                           const float* d, const float* mint,
                           const float* maxt, int n, float* t, float* u,
                           float* v, int* prim, int* hit, void* stream) {
  if (n > 0) {
    closest_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, o, d, mint, maxt, n, t, u, v, prim, hit);
  }
  return static_cast<int>(cudaGetLastError());
}
