// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), shared by the walks that stage their next block of
// triangles while they test the current one (exact.cu's v6b walk,
// stream.cu) and by the refine kernels, which stage their next tile of
// boxes (exact.cu).
//
// A thread issues its 16-byte copies, commits them as one group, and
// waits for all of its groups before a barrier makes the staged block
// visible to the whole thread block. Source and destination are 16-byte
// aligned; the staged tables' rows are 128 floats and every record read
// starts at a multiple of 4 floats. cp_async16_ca keeps the copied line in
// L1 as well; cp_async4 copies one float, for records packed at a 12-byte
// stride.

#pragma once

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// the same, cached in L1 too (`.ca`): for records that the neighbouring
// rows of an SM read again
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait for all of this thread's groups but the N most recent
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier of the `count` threads (a multiple of 32) that use the named
// barrier `id` (1-15; 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
