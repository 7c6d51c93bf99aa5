// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), shared by the walks that stage their next block of
// triangles while they test the current one (exact.cu's v6b walk,
// stream.cu) and by the refine kernels, which stage their next tile of
// boxes (exact.cu); and, at the end, Hopper's bulk copies with the
// mbarriers that count them (probes.cu's staging ring).
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

// ---------------------------------------------------------------------------
// TMA bulk copies and mbarriers (sm_90). One thread copies a whole span of
// device memory into shared memory with one instruction; the copy counts
// its bytes against an mbarrier in shared memory, whose phase completes
// when the arrivals it was initialised with have come and every byte it
// was told to expect has landed. Source, destination and size are
// multiples of 16 bytes. A thread waits for a phase by its parity (the
// first use of a barrier is parity 0). Where shared memory that generic
// loads have read is refilled by a copy, the reads are ordered before the
// copy's writes by a barrier (the readers arrive on an mbarrier, the
// thread that issues the copy waits on it) and a proxy fence in that
// thread.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// a barrier expecting `count` arrivals a phase (one thread)
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation seen by the other threads (and by the
// async proxy) once a barrier of the block has passed
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's (and, through a barrier, its block's) generic
// accesses of shared memory before the async proxy's, and back
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival on `bar` that also tells it to expect `bytes` more, which
// the bulk copies counted on it bring
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the bulk copy of `bytes` from src to dst, which counts them on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one arrival on `bar` (its release orders this thread's accesses before
// the phase's completion)
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of `bar` of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}
