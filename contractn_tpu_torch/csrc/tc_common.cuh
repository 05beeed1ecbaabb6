// Tensor-core and async-copy building blocks shared by the Hopper kernels
// (mps_chain_tc.cu, mpo_env.cu).
//
// Arithmetic:
//   * fp32 operands run as 3xTF32 on mma.sync.m16n8k8: a = hi + lo with
//     hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi); each product is
//     hi*hi + hi*lo + lo*hi (lo*lo, ~2^-22 relative, is dropped), fp32
//     accumulation.  ops/tensor_core.py emulates this split on the CPU.
//   * bf16 operands run on mma.sync.m16n8k16 with fp32 accumulation.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16), with
// g = lane / 4 and t = lane % 4:
//   tf32 A (16x8):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   tf32 B (8x8):   b0 (t, g)  b1 (t+4, g)
//   bf16 A (16x16): a0 (g, 2t:2t+2)  a1 (g+8, 2t:2t+2)  a2 (g, 2t+8:2t+10)
//                   a3 (g+8, 2t+8:2t+10)
//   bf16 B (16x8):  b0 (2t:2t+2, g)  b1 (2t+8:2t+10, g)
//   C (16x8, fp32): c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// Operands are read from shared memory by element, so any row-major or
// transposed layout serves.  Bank conflicts: an operand read as (row g,
// column t) -- the tf32 A pattern -- is conflict-free with rows padded to a
// stride of 4 words mod 32; one read as (row t or 2t, column g) -- B, and A
// read transposed -- is conflict-free in an unpadded tile whose columns are
// XOR-swizzled by the row (swz below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cn {

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// ------------------------------------------------------------ conversions

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The value a GEMM with operands of type T sees for fp32 value v.
template <typename T>
__device__ __forceinline__ float as_operand(float v) {
  return v;
}
template <>
__device__ __forceinline__ float as_operand<__nv_bfloat16>(float v) {
  return round_bf16(v);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (to ~2^-22 relative), both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_elem, __nv_bfloat16 hi_elem) {
  __nv_bfloat162 v;
  v.x = lo_elem;
  v.y = hi_elem;
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ mma.sync

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operand traits: K of one mma step, and the A / B fragment loaders.
// A(m, k) and B(k, n) are functors returning the element (as float for the
// fp32 path, as the stored type for bf16) at a tile-local position.
template <typename T>
struct Tc;

// fp32 operands, 3xTF32.  A fragment: 4 hi + 4 lo; B fragment: 2 hi + 2 lo.
template <>
struct Tc<float> {
  static constexpr int kK = 8;
  struct AFrag { uint32_t hi[4], lo[4]; };
  struct BFrag { uint32_t hi[2], lo[2]; };

  template <typename FA>
  __device__ __forceinline__ static void load_a(AFrag& f, FA a, int g, int t) {
    split_tf32(a(g, t), f.hi[0], f.lo[0]);
    split_tf32(a(g + 8, t), f.hi[1], f.lo[1]);
    split_tf32(a(g, t + 4), f.hi[2], f.lo[2]);
    split_tf32(a(g + 8, t + 4), f.hi[3], f.lo[3]);
  }
  template <typename FB>
  __device__ __forceinline__ static void load_b(BFrag& f, FB b, int g, int t) {
    split_tf32(b(t, g), f.hi[0], f.lo[0]);
    split_tf32(b(t + 4, g), f.hi[1], f.lo[1]);
  }
  // big += hi*hi; small += hi*lo + lo*hi.  Kept apart, mps_chain_tc.cu ran
  // 8% faster and nearer fp32 than with one accumulator (NVIDIA H100 80GB
  // HBM3, 700 W; PERF.md)
  __device__ __forceinline__ static void mma(float* big, float* small, const AFrag& a,
                                             const BFrag& b) {
    mma_tf32(small, a.lo, b.hi);
    mma_tf32(small, a.hi, b.lo);
    mma_tf32(big, a.hi, b.hi);
  }
  // c += lo*hi + hi*lo + hi*hi, one accumulator
  __device__ __forceinline__ static void mma(float* c, const AFrag& a, const BFrag& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

// bf16 operands: one bf16 mma per step; `small` is unused.
template <>
struct Tc<__nv_bfloat16> {
  static constexpr int kK = 16;
  struct AFrag { uint32_t r[4]; };
  struct BFrag { uint32_t r[2]; };

  template <typename FA>
  __device__ __forceinline__ static void load_a(AFrag& f, FA a, int g, int t) {
    f.r[0] = pack_bf16(a(g, 2 * t), a(g, 2 * t + 1));
    f.r[1] = pack_bf16(a(g + 8, 2 * t), a(g + 8, 2 * t + 1));
    f.r[2] = pack_bf16(a(g, 2 * t + 8), a(g, 2 * t + 9));
    f.r[3] = pack_bf16(a(g + 8, 2 * t + 8), a(g + 8, 2 * t + 9));
  }
  template <typename FB>
  __device__ __forceinline__ static void load_b(BFrag& f, FB b, int g, int t) {
    f.r[0] = pack_bf16(b(2 * t, g), b(2 * t + 1, g));
    f.r[1] = pack_bf16(b(2 * t + 8, g), b(2 * t + 9, g));
  }
  __device__ __forceinline__ static void mma(float* big, float*, const AFrag& a, const BFrag& b) {
    mma_bf16(big, a.r, b.r);
  }
  __device__ __forceinline__ static void mma(float* c, const AFrag& a, const BFrag& b) {
    mma_bf16(c, a.r, b.r);
  }
};

// Offset of element (row, col) in an unpadded row-major tile of row length
// ld (a multiple of 32) whose columns are XOR-swizzled in groups of 8 by the
// row, for operands of an mma on type T.  A fragment read at (row k + t,
// column n + g) (tf32) or (row k + 2t + {0,1}, column n + g) (bf16) then
// touches 32 distinct banks.  Groups of 8 columns stay whole, so 16-byte
// cp.async chunks land intact.
template <typename T>
__device__ __forceinline__ int swz(int row, int col, int ld) {
  const int sel = sizeof(T) == 4 ? row : row >> 1;
  return row * ld + (col ^ ((sel & 3) << 3));
}

// ------------------------------------------------------------ tile GEMM

// The tile GEMM of the streamed paths (mpo_env.cu streamed_gemm_kernel,
// mps_chain_tc.cu mps_streamed_site_kernel): one CTA computes a 64 x 64
// tile of C = A B on mma.sync with fp32 accumulation.  K runs in steps of
// 32, staged through registers into shared rows padded for the fragment
// patterns (A's 4 words mod 32 serve the tf32 A pattern, B's 8 mod 32 the B
// pattern), the next step's global loads in flight while this step's MMAs
// run.  kWarpsM x 2 warps, each (16 kMI) x 32 of the tile.  What A and B
// are, and how A is scaled and cast, is the caller's: its functors fetch
// each element at load time and make A's staged value at stage time.
template <typename T, int kWarpsM>
struct TileGemm {
  using Op = Tc<T>;
  static constexpr int kM = 64, kN = 64, kK = 32;
  static constexpr int kThreads = 2 * kWarpsM * 32;
  static constexpr int kMI = kM / (16 * kWarpsM);    // m16 tiles a warp
  static constexpr int kLoads = kM * kK / kThreads;  // = kK * kN / kThreads
  static constexpr int kLda = kK + (sizeof(T) == 4 ? 4 : 8), kLdb = kN + 8;
  static constexpr int kSmemBytes = (kM * kLda + kK * kLdb) * (int)sizeof(T);

  struct Smem {
    __align__(16) T a[kM * kLda];
    __align__(16) T b[kK * kLdb];
  };
  using Acc = float[kMI][4][4];

  // Tile-local row and column of this thread's C element [mi][ni][c]
  __device__ __forceinline__ static int row(int mi, int c) {
    return (threadIdx.x >> 6) * 16 * kMI + mi * 16 + (lane_id() >> 2) + 8 * (c >> 1);
  }
  __device__ __forceinline__ static int col(int ni, int c) {
    return ((threadIdx.x >> 5) & 1) * 32 + ni * 8 + 2 * (lane_id() & 3) + (c & 1);
  }

  // `steps` K steps.  fetch_a(s, m, k) returns A's element at tile-local
  // (m, k) of step s as an RA (zero outside A), put_a(v, m) the T staged for
  // it; fetch_b(s, k, n) returns B's (zero outside B).  kAT: neighbouring
  // threads load along m (A read transposed), else along k; B's along n.
  // kTwoAcc: hi*hi into big and the cross terms into small (Tc<float>::mma),
  // else every product into big.  after(s) runs once step s's MMAs are done
  // and every thread has passed the barrier behind them.
  template <bool kAT, bool kTwoAcc, typename RA, class FA, class PA, class FB, class After>
  __device__ __forceinline__ static void run(Smem& sm, int steps, FA fetch_a, PA put_a,
                                             FB fetch_b, Acc& big, Acc& small, After after) {
    constexpr int KS = Op::kK;
    const int lane = lane_id(), gq = lane >> 2, tq = lane & 3;
    const int wm = (threadIdx.x >> 6) * 16 * kMI, wn = ((threadIdx.x >> 5) & 1) * 32;
    RA ra[kLoads];
    T rb[kLoads];
    auto load = [&](int s) {
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int e = threadIdx.x + r * kThreads;
        ra[r] = fetch_a(s, kAT ? e % kM : e / kK, kAT ? e / kM : e % kK);
        rb[r] = fetch_b(s, e / kN, e % kN);
      }
    };
    auto stage = [&]() {
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int e = threadIdx.x + r * kThreads;
        const int m = kAT ? e % kM : e / kK, k = kAT ? e / kM : e % kK;
        sm.a[m * kLda + k] = put_a(ra[r], m);
        sm.b[(e / kN) * kLdb + e % kN] = rb[r];
      }
    };
    load(0);
    for (int s = 0; s < steps; ++s) {
      stage();
      __syncthreads();
      if (s + 1 < steps) load(s + 1);
#pragma unroll
      for (int ks = 0; ks < kK; ks += KS) {
        typename Op::AFrag af[kMI];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          Op::load_a(af[mi], [&](int r, int c) { return sm.a[(wm + mi * 16 + r) * kLda + ks + c]; },
                     gq, tq);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          typename Op::BFrag bf;
          Op::load_b(bf, [&](int r, int c) { return sm.b[(ks + r) * kLdb + wn + ni * 8 + c]; }, gq,
                     tq);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) {
            if constexpr (kTwoAcc)
              Op::mma(big[mi][ni], small[mi][ni], af[mi], bf);
            else
              Op::mma(big[mi][ni], af[mi], bf);
          }
        }
      }
      __syncthreads();
      after(s);
    }
  }
};

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 or 1) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ TMA bulk copies

// Shared-memory row length for a staged core of row length dp: 8 elements of
// padding make the row stride 8 words mod 32 for fp32 (36 words, 4 mod 32,
// for bf16), so the B pattern (row t or 2t, column g) touches 32 banks, and
// keep every row 16-byte aligned for cp.async.bulk.
__host__ __device__ constexpr int core_ld(int dp) { return dp + 8; }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's generic shared-memory writes before later async-proxy
// (TMA) writes to the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Stage a core (phys, bond, bond) of T from global memory into shared rows
// of length ld (block k at row k * dp), one cp.async.bulk per row, the rows
// spread over the block's threads (a thread starts its copies one after
// another, so one warp alone would serialize them); completion arrives on
// `bar`, armed by thread 0 for the whole core.  Copies that land before the
// arming only drive the transaction count negative: the phase cannot
// complete while thread 0's arrival is pending.  bond * sizeof(T) must be a
// multiple of 16 and the source 16-byte aligned (the wrappers see to it).
// Call from every thread of the block.
template <typename T>
__device__ __forceinline__ void stage_core(T* dst, const T* src, int phys, int bond, int dp, int ld,
                                           uint64_t* bar) {
  const uint32_t row_bytes = bond * sizeof(T);
  if (threadIdx.x == 0) mbar_expect_tx(bar, row_bytes * phys * bond);
  for (int r = threadIdx.x; r < phys * bond; r += blockDim.x) {
    const int k = r / bond, i = r - k * bond;
    bulk_copy(dst + (k * dp + i) * ld, src + (size_t)r * bond, row_bytes, bar);
  }
}

__device__ __forceinline__ void zero_shared(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

}  // namespace cn
