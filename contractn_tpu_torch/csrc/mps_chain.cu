// Batched split-format MPS chain returning the carry:
// v = l^T prod_n (sum_k x[b,n,k] A_n[k]), with a per-site L1 rescale.
//
// Replaces the Pallas TPU kernel contractn_tpu/ops/pallas_epilogue.py:128
// (_kernel, launched by mps_evaluate_epilogue).  Entry: cn_mps_epilogue.
// (Kernel #1, pallas_mps._mps_kernel, is mps_chain_tc.cu.)
//
// Bound (H100, fp32 cores): 2*B*N*d*D^2 FLOPs against B*N*d*4 + N*d*D*D*4
// bytes, far above the ridge point.  This version runs on the fp32 FMA
// units (67 TFLOP/s); fp32-accurate work on the tensor cores (3xTF32) would
// be bounded at 3 * FLOPs / 495 TFLOP/s.
//
// Design (a simple, correct first version: fp32 FMA, no tensor cores, no
// async copies):
//   * The TPU ran the site axis as a sequential grid with a scratch carry.
//     Here one CTA owns kRows batch rows and loops over all N sites itself;
//     nothing carries between CTAs.  kRows = 32 gives 128 CTAs at B = 4096.
//   * Per site the CTA stages the core A_n (d, D, D) in shared memory as
//     fp32 (read in place from the (N, d, D, D) tensor: no relayout copy;
//     every CTA reads the same core, so it comes from L2), then computes
//     u_k = v A_n[k] and v' = sum_k x[b,n,k] u_k in registers.
//   * The carry lives in registers with a shared-memory copy in the form the
//     GEMM reads (rounded to the core type, as the Pallas kernel casts the
//     carry before each dot).
//   * Threads form a 16 x 16 grid: ty picks rows {ty, ty+16}, tx picks
//     columns {tx + 16c}; the 16 threads of a row sit in one half-warp, so
//     the per-row L1 sum is four shuffles.
//
// Modes (the kernel's semantics, as pallas_epilogue._kernel):
//   1  acc_dtype fp32: guard mean > MIN_NORM; outputs the carry (B, D) fp32
//      and log; the close runs outside.
//   2  acc_dtype bf16: as 1 with a bf16 carry, every elementwise step rounded
//      to bf16 as the plain torch version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kTX = 16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

template <typename T, int MODE, int CJ>
__global__ void __launch_bounds__(kThreads)
mps_chain_kernel(const T* __restrict__ cores, const float* __restrict__ x,
                 const float* __restrict__ left, void* __restrict__ out_v,
                 float* __restrict__ out_log, int n_sites, int phys, int bond,
                 int batch, float step_thr) {
  extern __shared__ float smem[];
  const int core_elems = phys * bond * bond;
  const int vstride = bond + 1;  // padded: the two rows a warp reads differ in bank
  float* a_s = smem;                          // (phys, bond, bond)
  float* v_s = a_s + core_elems;              // (kRows, bond + 1)
  float* x_s = v_s + kRows * vstride;         // (kRows, phys)

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int row0 = blockIdx.x * kRows;

  float v[2][CJ];
#pragma unroll
  for (int c = 0; c < CJ; ++c) {
    const int j = tx + kTX * c;
    const float l = j < bond ? left[j] : 0.f;
    v[0][c] = l;
    v[1][c] = l;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int j = tx + kTX * c;
      if (j < bond) v_s[(ty + 16 * r) * vstride + j] = as_operand<T>(v[r][c]);
    }
  float log_acc[2] = {0.f, 0.f};

  for (int n = 0; n < n_sites; ++n) {
    const T* core = cores + (size_t)n * core_elems;
    for (int e = threadIdx.x; e < core_elems; e += kThreads) a_s[e] = load_f32(core + e);
    for (int e = threadIdx.x; e < kRows * phys; e += kThreads) {
      const int b = row0 + e / phys;
      x_s[e] = b < batch ? x[((size_t)b * n_sites + n) * phys + e % phys] : 0.f;
    }
    __syncthreads();

    float vn[2][CJ];
    for (int k = 0; k < phys; ++k) {
      float acc[2][CJ];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[r][c] = 0.f;
      const float* ak = a_s + k * bond * bond;
      for (int i = 0; i < bond; ++i) {
        const float v0 = v_s[ty * vstride + i];
        const float v1 = v_s[(ty + 16) * vstride + i];
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const int j = tx + kTX * c;
          const float a = j < bond ? ak[i * bond + j] : 0.f;
          acc[0][c] = fmaf(v0, a, acc[0][c]);
          acc[1][c] = fmaf(v1, a, acc[1][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float xk = x_s[(ty + 16 * r) * phys + k];
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          float p;
          if (MODE == 2) {
            p = round_bf16(__fmul_rn(round_bf16(acc[r][c]), round_bf16(xk)));
            vn[r][c] = k == 0 ? p : round_bf16(__fadd_rn(vn[r][c], p));
          } else {
            p = __fmul_rn(acc[r][c], xk);
            vn[r][c] = k == 0 ? p : __fadd_rn(vn[r][c], p);
          }
        }
      }
    }

    // per-row L1 mean, guard, rescale, log register
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        if (tx + kTX * c < bond) s += fabsf(vn[r][c]);
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off, kTX);
      float mean = MODE == 2 ? round_bf16(__fdiv_rn(round_bf16(s), (float)bond))
                             : __fdiv_rn(s, (float)bond);
      const float safe = mean > step_thr ? mean : 1.f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float q = __fdiv_rn(vn[r][c], safe);
        v[r][c] = MODE == 2 ? round_bf16(q) : q;
      }
      log_acc[r] += logf(safe);
    }
    __syncthreads();  // every thread is done reading v_s and a_s
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int j = tx + kTX * c;
        if (j < bond) v_s[(ty + 16 * r) * vstride + j] = as_operand<T>(v[r][c]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = row0 + ty + 16 * r;
    if (b < batch) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int j = tx + kTX * c;
        if (j >= bond) continue;
        if (MODE == 2)
          static_cast<__nv_bfloat16*>(out_v)[(size_t)b * bond + j] = __float2bfloat16_rn(v[r][c]);
        else
          static_cast<float*>(out_v)[(size_t)b * bond + j] = v[r][c];
      }
      if (tx == 0) out_log[b] = log_acc[r];
    }
  }
}

size_t smem_bytes(int phys, int bond) {
  return sizeof(float) * ((size_t)phys * bond * bond + (size_t)kRows * (bond + 1) + (size_t)kRows * phys);
}

template <typename T, int MODE, int CJ>
int launch(const void* cores, const float* x, const float* left, void* v_out, float* log_out,
           int n_sites, int phys, int bond, int batch, float step_thr, cudaStream_t stream) {
  auto kernel = mps_chain_kernel<T, MODE, CJ>;
  const size_t smem = smem_bytes(phys, bond);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + kRows - 1) / kRows;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(cores), x, left, v_out, log_out,
                                           n_sites, phys, bond, batch, step_thr);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int dispatch_bond(const void* cores, const float* x, const float* left, void* v_out,
                  float* log_out, int n_sites, int phys, int bond, int batch, float step_thr,
                  cudaStream_t stream) {
#define CN_LAUNCH(CJ) \
  return launch<T, MODE, CJ>(cores, x, left, v_out, log_out, n_sites, phys, bond, batch, step_thr, stream)
  if (bond <= 16) CN_LAUNCH(1);
  if (bond <= 32) CN_LAUNCH(2);
  if (bond <= 64) CN_LAUNCH(4);
  if (bond <= 128) CN_LAUNCH(8);
#undef CN_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel #2 (pallas_epilogue._kernel).  cores (N, d, D, D) fp32 or bf16,
// x (B, N, d) fp32, left (D,) fp32; writes the carry v_out (B, D) in fp32
// (carry_bf16 = 0) or bf16 (carry_bf16 = 1) and log (B,) fp32.
int cn_mps_epilogue(const void* cores, int cores_bf16, const float* x, const float* left,
                    void* v_out, int carry_bf16, float* log_out, int n_sites, int phys, int bond,
                    int batch, float step_thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cores_bf16) {
    if (carry_bf16)
      return dispatch_bond<__nv_bfloat16, 2>(cores, x, left, v_out, log_out, n_sites, phys, bond,
                                             batch, step_thr, s);
    return dispatch_bond<__nv_bfloat16, 1>(cores, x, left, v_out, log_out, n_sites, phys, bond,
                                           batch, step_thr, s);
  }
  if (carry_bf16)
    return dispatch_bond<float, 2>(cores, x, left, v_out, log_out, n_sites, phys, bond, batch,
                                   step_thr, s);
  return dispatch_bond<float, 1>(cores, x, left, v_out, log_out, n_sites, phys, bond, batch,
                                 step_thr, s);
}

}  // extern "C"
