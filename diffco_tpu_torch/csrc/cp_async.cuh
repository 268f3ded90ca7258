// cp.async copies from global to shared memory for the blocks that stage
// supports in a double buffer (multi_score_block.cuh, tc_score_block.cuh,
// wide_score_block.cuh).
// Off the device (the CPU replay tests) a copy is a plain store and the
// group operations do nothing.
#pragma once

#ifndef DIFFCO_HD
#define DIFFCO_HD __host__ __device__ __forceinline__
#endif

namespace diffco {

// One float from global to shared memory, asynchronously (cp.async, 4
// bytes: the rows of s [S, F] and W [S, C] have no 16-byte alignment);
// zeros when !valid.
DIFFCO_HD void cp_async_f32(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
#else
  *dst = valid ? *src : 0.f;
#endif
}

// 16 bytes from global to shared memory, asynchronously, through L2 only
// (cp.async.cg); both addresses 16-byte aligned.
DIFFCO_HD void cp_async_16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  __builtin_memcpy(dst, src, 16);
#endif
}

DIFFCO_HD void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

DIFFCO_HD void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

}  // namespace diffco
