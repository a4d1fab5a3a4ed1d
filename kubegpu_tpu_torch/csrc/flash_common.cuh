// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the causal/window mask at global positions, bf16
// tensor-core products (mma.sync m16n8k16), ldmatrix fragment loads and
// cp.async staging. Header-only; each .cu compiles on its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kgt {

constexpr float kNegInf = -1e30f;  // the running max's start, as flash.py
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// False iff the causal/window mask hides every (q, k) pair of the tile
// whose global q rows are [q_lo, q_hi] and keys [k_lo, k_hi]. A window
// implies the causal bound, with or without the causal flag. P is any
// parameter struct with ``causal`` and ``window``.
template <class P>
__device__ __forceinline__ bool tile_visible(const P& p, int q_lo, int q_hi,
                                             int k_lo, int k_hi) {
  if (!p.causal && !p.window) return true;
  bool vis = q_hi >= k_lo;
  if (p.window) vis = vis && (k_hi > q_lo - p.window);
  return vis;
}

// True iff the mask hides no (q, k) pair of the tile: its per-element test
// can be left out.
template <class P>
__device__ __forceinline__ bool tile_full(const P& p, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  if (!p.causal && !p.window) return true;
  bool full = q_lo >= k_hi;
  if (p.window) full = full && (k_lo > q_hi - p.window);
  return full;
}

template <class P>
__device__ __forceinline__ bool visible(const P& p, int qp, int kp) {
  if (!p.causal && !p.window) return true;
  bool vis = qp >= kp;
  if (p.window) vis = vis && (kp > qp - p.window);
  return vis;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Lane t receives row t / 4, columns 2 (t % 4)
// and 2 (t % 4) + 1 of each (the .trans form: column t / 4, rows 2 (t % 4)
// and 2 (t % 4) + 1), i.e. an mma A fragment quarter or B fragment half.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two floats to a bf16 pair; the first lands in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without passing through registers; with
// full == false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace kgt
