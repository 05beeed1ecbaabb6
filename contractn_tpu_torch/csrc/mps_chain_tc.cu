// Batched split-format MPS chains on Hopper's tensor cores:
// v_b = l^T prod_n (sum_k x[b,n,k] A_n[k]) with a per-site L1 rescale, then
// either closed, psi(x_b) = v_b . r returned as (amp, log), or returned as
// the carry v_b and its log.
//
// Replaces two Pallas TPU kernels, as two output modes of one template:
//   * contractn_tpu/ops/pallas_mps.py:152 (_mps_kernel, launched by
//     pallas_mps_evaluate): mode kClose, entry cn_mps_evaluate;
//   * contractn_tpu/ops/pallas_epilogue.py:128 (_kernel, launched by
//     mps_evaluate_epilogue): modes kCarryF32 and kCarryBf16 (its acc_dtype),
//     entry cn_mps_epilogue.
// The carry modes differ from kClose only where the Pallas kernels differ:
// the rescale guard (the caller's step_thr: MIN_NORM / D for kClose,
// MIN_NORM for the carry, bf16-rounded under a bf16 carry), the initial
// carry (the wrapper passes left already cast to the core type and the
// carry type), the bf16 rounding of every elementwise step under kCarryBf16
// (u after the GEMM, x, each product, each running add, the row's L1 sum
// once all its partials are added, the mean and the quotient; the log stays
// fp32), and the end: the carry (B, D) in its type and the log, no close.
//
// Bound (H100 SXM): per site a (B x D) x (D x d*D) GEMM, 2*B*N*d*D^2 FLOPs
// (6.7e10 at N = 1000, d = 2, D = 64, B = 4096), on cores of a few MB that
// stay in L2.  fp32-accurate products run as 3xTF32 (three TF32 passes at
// 495 TFLOP/s), so the least time is 3 * FLOPs / 495e12 = 0.41 ms; bf16
// cores take one pass at 989 TFLOP/s.
//
// Design:
//   * One CTA owns kRows = 32 batch rows and walks all N sites; the fp32
//     carry v (rows x D) never leaves the chip.  128 CTAs at B = 4096 (one
//     per SM; 4 of 132 SMs idle), 8 warps each (16 measured slower).
//   * Per site the GEMM u = v A_n runs on mma.sync (3xTF32 m16n8k8 for fp32
//     cores, m16n8k16 for bf16; see tc_common.cuh).  Each of the two m16 row
//     tiles has 4 warps; warp w owns the D/4 columns starting at
//     (w % 4) * D/4 for every physical index k, so each thread holds u_k at
//     the same (row, column) for all k and forms v' = sum_k x[b,n,k] u_k in
//     registers (fp32, the same multiply-then-add order as the plain
//     version).  The carry enters the MMA as the A fragment, read from
//     shared memory once per site and kept in registers across the k loop
//     (D <= 64); two accumulator sets per tile (hi*hi and the two cross
//     terms), two K halves and a k loop unrolled by 2 shorten the dependent
//     MMA chains.  The K loop always runs the padded width (32, 64 or 128)
//     at compile time: rows and columns past D are zero.
//   * Row reduction across warps: each row's D columns sit in the 4 warps of
//     one row tile.  A thread sums |v'| over its columns, the 4 lanes of
//     a quad add theirs by shuffles, and lane 0 of each quad writes one
//     partial per (row, warp) to shared memory; after a barrier every thread
//     adds the 4 partials of its rows in a fixed order.  Then the guard
//     mean > step_thr, the division by safe, the log register, and the
//     carry is written back as the next site's A operand (rounded to the core
//     type, as the Pallas kernel casts it before each dot; under a bf16
//     carry the registers hold the bf16 value and the operand copy that
//     value in the core type).  Two barriers a site.
//   * Async core pipeline: the cores stream through a ring of up to
//     kMaxBlocks blocks -- a block is one physical index of one site,
//     (DP, DP + 8) -- fetched by the TMA (cp.async.bulk, started by one
//     thread, completion on the slot's mbarrier).  Where the ring holds
//     whole sites, a slot is a site (one copy, one wait before the k loop);
//     the slots a site frees are refilled right after its reduction barrier,
//     so at d = 2 the ring runs 3 sites ahead.  A ring shorter than one site
//     (large d, or d = 3 at D > 64 in fp32) takes one block a slot and
//     refills each slot inside the site, behind one more barrier.  No
//     thread spends instruction slots or registers on the core that every CTA
//     reads from L2 at every site (per-row copies, or 16-byte cp.async by
//     every thread, measured slower).  For that single copy the wrapper lays
//     the cores out as (N, d, DP, DP + 8), zero-padded: DP = 32, 64 or 128
//     rows (cn_mps_core_rows) of DP + 8 elements (cn_mps_core_ld), a stride
//     of 8 words mod 32 that keeps the B fragment reads free of bank
//     conflicts.  The carry's rows are padded to DP + 4 floats for the A
//     reads.
//   * x is staged nx <= 16 sites at a time: each row's x[b, n0:n0+nx, :] is
//     contiguous, fetched by 4-byte cp.async (one commit group a block of
//     sites) and double-buffered.  nx shrinks for large d so that the ring
//     keeps two slots; past that (d in the hundreds) x is read in place.
//   * Shared memory at fp32, d = 2, D = 64: 8 ring slots 147,456 B + carry
//     8,704 B + x 8,192 B + partials 512 B + barriers 64 B = 164,928 B.  The
//     same in every mode.
//
// The wrappers (ops/cuda_mps.py, ops/cuda_epilogue.py) make that layout
// through one helper (cuda_mps.chain_launch); nothing else needs D to be
// aligned.
//
// Streamed path (launch_streamed, exported as cn_mps_chain_streamed), for
// every shape the tensor-core kernel has no plan for: D > 128.  It exists
// because the Pallas kernels size only their VMEM tiles and take such bonds
// (DMRG ground states at bond 256 are served through #1), and because the
// one-CTA layout cannot hold them: at D 256 one fp32 block of a site is
// 256 KB, more than the 232 KB of shared memory a CTA may have.  So the
// carry goes to device memory between sites.
//
// Bound (H100 SXM, fp32 cores, N = 1000, d = 2, D = 256, B = 4096): per site
// a (B x D) x (D x d*D) GEMM, 2*B*N*d*D^2 = 1.07e12 FLOPs, as 3xTF32 at
// 495 TFLOP/s: 6.51 ms, above the 0.56 GB of cores and x (0.17 ms).  The
// carry's own traffic (2 * B * D * 4 bytes a site each way, 8 GB a call) is
// not in the bound, since an on-chip design need not move it: it costs
// 2.4 ms at HBM rate, behind the GEMMs.
//
// Design: per site one launch of mps_streamed_site_kernel over 64-row batch
// tiles x 64-column tiles of the D output columns, on the tile GEMM that
// mpo_env.cu's streamed path also runs (TileGemm, tc_common.cuh; here 256
// threads, 8 warps of 16 x 32 on mma.sync: 3xTF32 for fp32 cores, one bf16
// pass for bf16, fp32 accumulation, K in steps of 32 staged through
// registers, the next step's global loads in flight while this one's MMAs
// run):
//   * prologue: the previous site's rescale of the tile's 64 rows, each row's
//     column-tile sums added in tile order (no atomics, so every CTA of the
//     rows gets the same value whatever the timing), the mean rounded as
//     the tensor-core kernel rounds it, guard against step_thr; the first
//     column tile adds logf(safe) to the running log in log_out;
//   * for k = 0..d-1, u_k = A . A_n[k][:, cols], the A operand the previous
//     carry divided by its row's safe (in_carry, then rounded to the core
//     type, as the tensor-core kernel's v_s), at site 0 left; a step's A
//     values are all loaded before any is divided, as they are staged (a
//     division waiting on its own load holds the next loads back); the
//     cores are read in place (N, d, D, D), no padded copy;
//   * v' = sum_k x[b, n, k] u_k in registers in the tensor-core kernel's
//     multiply-then-add order and bf16 rounding (kCarryBf16);
//   * v' is written unscaled to one of two carry buffers (the other column
//     tiles of the same rows still read the previous one), and the tile's
//     per-row sum |v'| (quad shuffles, then its two warps in order) to a
//     fixed slot of one of two slot sets.
// After the last site, mps_streamed_finish_kernel (one warp a row) applies
// the last rescale, then closes (kClose: fmaf against right, a shuffle
// tree, the |amp| guard) or writes the carry in its type, and the log.
// Ragged B and D are masked (zero loads, no stores).  The wrapper allocates
// the workspace (cn_mps_streamed_workspace bytes: two carries, two slot
// sets); the kernels allocate nothing.  The A operand is re-read from L2
// for every k, and nothing uses the TMA, wgmma or a persistent CTA yet:
// PERF.md (section 6, rows #1 and #2) has its times.
//
// One C function (path_for, exported as cn_mps_path) picks the path before
// the launch: the tensor-core path wherever one of its plans fits (every
// 1 <= D <= 128), the streamed path for every other shape with d, D >= 1.
// A failed launch is never retried on the other path.

#include "tc_common.cuh"

namespace {

using namespace cn;

constexpr int kRows = 32;
constexpr int kMaxXSites = 16;
constexpr int kMaxBlocks = 8;
constexpr int kSmemLimit = 232448;

constexpr int kWPM = 4;                  // warps per m16 row tile
constexpr int kThreads = 2 * kWPM * 32;  // two row tiles

// What the chain ends with: the closed amplitude (#1), or the carry in
// fp32 or bf16 (#2's acc_dtype)
constexpr int kClose = 0, kCarryF32 = 1, kCarryBf16 = 2;

// An elementwise result in the carry's type: bf16-rounded under kCarryBf16
template <int kOut>
__device__ __forceinline__ float in_carry(float v) {
  if constexpr (kOut == kCarryBf16) return round_bf16(v);
  return v;
}

// A ring slot holds one block (DP, core_ld(DP)) of a core: one physical
// index of one site.  x is staged nx sites at a time, double-buffered, or
// read from global memory where even one site's rows do not fit (nx = 0).
struct Layout {
  int v_ld, x_ld, block_elems;
  int core, v, x, red, bar, total;  // byte offsets, total bytes
};

template <typename T>
__host__ __device__ Layout make_layout(int phys, int dp, int blocks, int nx) {
  Layout L;
  L.v_ld = dp + 4;
  L.x_ld = nx * phys;
  L.block_elems = dp * core_ld(dp);
  L.core = 0;
  L.v = blocks * L.block_elems * (int)sizeof(T);
  L.x = L.v + kRows * L.v_ld * 4;
  L.red = L.x + ((2 * kRows * L.x_ld * 4 + 15) / 16) * 16;
  L.bar = L.red + kRows * kWPM * 4;
  L.total = L.bar + kMaxBlocks * 8;
  return L;
}

struct Plan {
  int blocks, nx;
  bool whole;  // whole sites in the ring and x staged: the kernel's fast path
};

// The deepest ring (at most kMaxBlocks) that fits beside the widest x
// staging that still leaves two slots; one slot with x read in place as the
// last resort.  A ring that holds a site is cut to whole sites.  blocks = 0
// when nothing fits.
template <typename T>
Plan plan_for(int phys, int dp) {
  auto deepest = [&](int nx) {
    for (int s = kMaxBlocks; s >= 1; --s)
      if (make_layout<T>(phys, dp, s, nx).total <= kSmemLimit) return s;
    return 0;
  };
  Plan p = {deepest(0), 0, false};
  for (int nx = kMaxXSites; nx >= 1; nx /= 2)
    if (deepest(nx) >= 2) {
      p = {deepest(nx), nx, false};
      break;
    }
  p.whole = p.nx > 0 && p.blocks >= phys;
  if (p.whole) p.blocks = p.blocks / phys * phys;
  return p;
}

// kWhole: the ring holds whole sites (blocks >= d, rounded down to a multiple
// of d) and x is staged.  Then a ring unit is a site -- one TMA copy, one
// mbarrier, waited for before the k loop, whose loop has no branch, so ptxas
// interleaves two physical indices' MMA chains.  Otherwise a unit is one
// block, waited for (and its slot refilled) inside the loop.
// kOut: kClose writes amp (B,) fp32 to `out`; the carry modes write the
// carry (B, D) in fp32 or bf16 (`right` and close_thr are not read).
template <typename T, int DP, bool kWhole, int kOut>
__global__ void __launch_bounds__(kThreads)
mps_tc_kernel(const T* __restrict__ cores, const float* __restrict__ x,
              const float* __restrict__ left, const float* __restrict__ right,
              void* __restrict__ out, float* __restrict__ out_log, int n_sites, int phys,
              int bond, int batch, int blocks, int nx, float step_thr, float close_thr) {
  using Op = Tc<T>;
  constexpr int WPM = kWPM;
  constexpr int NT = DP / (8 * WPM);  // n8 tiles per warp and physical index
  constexpr int KS = Op::kK;
  constexpr int NKS = DP / KS;
  constexpr int CLD = core_ld(DP);
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr bool kCacheA = NKS * sizeof(typename Op::AFrag) <= 64 * 4;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout<T>(phys, DP, blocks, nx);
  T* core_s = reinterpret_cast<T*>(smem + L.core);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* x_s = reinterpret_cast<float*>(smem + L.x);
  float* red_s = reinterpret_cast<float*>(smem + L.red);  // (kRows, WPM)
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp / WPM, ng = warp % WPM;
  const int row0 = blockIdx.x * kRows;
  const int jbase = ng * (DP / WPM);
  const int per = kWhole ? phys : 1;  // blocks per ring unit
  const int slots = blocks / per;
  const int units = n_sites * phys / per;  // unit u: blocks u * per .. u * per + per - 1
  const int unit_elems = per * L.block_elems;

  zero_shared(reinterpret_cast<float*>(smem), L.total / 4);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&bar[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // unit u into ring slot u % slots: one TMA copy, started by one thread
  auto start_unit = [&](int u) {
    if (threadIdx.x == 0 && u < units) {
      const int slot = u % slots;
      const uint32_t bytes = unit_elems * sizeof(T);
      mbar_expect_tx(&bar[slot], bytes);
      bulk_copy(core_s + slot * unit_elems, cores + (size_t)u * unit_elems, bytes, &bar[slot]);
    }
  };
  // x[b, s:s+nx, :] of every row into buffer (s / nx) & 1 (cp.async, one group)
  auto fetch_x = [&](int s) {
    if (s < n_sites) {
      const int cnt = min(nx, n_sites - s) * phys;
      float* xd = x_s + ((s / nx) & 1) * kRows * L.x_ld;
      for (int e = threadIdx.x; e < kRows * cnt; e += kThreads) {
        const int r = e / cnt, i = e - r * cnt;
        if (row0 + r < batch)
          cp_async4(xd + r * L.x_ld + i, x + ((size_t)(row0 + r) * n_sites + s) * phys + i);
      }
    }
    cp_async_commit();
  };
  for (int u = 0; u < slots; ++u) start_unit(u);
  int next = slots;  // the next unit to start (the same count in every thread)
  if (nx) fetch_x(0);

  // carry: in registers at this thread's C positions (fp32, holding bf16
  // values under kCarryBf16), the operand copy (rounded to T) in v_s for
  // every row; the carry modes' wrapper passes left already in both types
  float vcar[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = jbase + 8 * c + 2 * t + (e & 1);
      vcar[c][e] = j < bond ? left[j] : 0.f;
    }
  for (int e = threadIdx.x; e < kRows * bond; e += kThreads) {
    const int r = e / bond, j = e - r * bond;
    v_s[r * L.v_ld + j] = as_operand<T>(left[j]);
  }
  float log_acc[2] = {0.f, 0.f};
  const int rloc[2] = {mt * 16 + g, mt * 16 + g + 8};

  for (int n = 0; n < n_sites; ++n) {
    if (nx && n % nx == 0) {
      fetch_x(n + nx);  // into the buffer sites n - nx .. n - 1 used
      cp_async_wait(1);
    }
    if constexpr (kWhole) mbar_wait(&bar[n % slots], (n / slots) & 1);
    __syncthreads();  // A: this site's x (and, if kWhole, its blocks) landed; v_s holds the carry
    // this thread's two rows of x at site n: offsets into x_s (staged) or x
    int xo[2];
    size_t xg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xo[h] = nx ? ((n / nx) & 1) * kRows * L.x_ld + rloc[h] * L.x_ld + (n % nx) * phys : 0;
      xg[h] = ((size_t)min(row0 + rloc[h], batch - 1) * n_sites + n) * phys;
    }

    // the carry's A fragments: loaded once a site and kept across the k loop
    // while they fit in 64 registers (D <= 64), else reloaded per k
    const float* va = v_s + (mt * 16) * L.v_ld;
    auto load_carry = [&](typename Op::AFrag& f, int ks) {
      Op::load_a(f, [&](int r, int c) { return va[r * L.v_ld + ks * KS + c]; }, g, t);
    };
    typename Op::AFrag afr[kCacheA ? NKS : 1];
    if constexpr (kCacheA) {
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) load_carry(afr[ks], ks);
    }

    float vn[NT][4];
#pragma unroll 2  // two physical indices' MMA chains interleave
    for (int k = 0; k < phys; ++k) {
      const T* bk;
      if constexpr (kWhole) {
        bk = core_s + (n % slots) * unit_elems + k * L.block_elems + jbase;
      } else {
        const int j = n * phys + k;
        mbar_wait(&bar[j % slots], (j / slots) & 1);
        bk = core_s + (j % slots) * unit_elems + jbase;
      }
      float big[2][NT][4] = {}, small[2][NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        typename Op::AFrag a_now;
        if constexpr (!kCacheA) load_carry(a_now, ks);
        const typename Op::AFrag& af = kCacheA ? afr[kCacheA ? ks : 0] : a_now;
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          typename Op::BFrag bfr;
          Op::load_b(bfr, [&](int r, int col) { return bk[(ks * KS + r) * CLD + 8 * c + col]; },
                     g, t);
          Op::mma(big[ks & 1][c], small[ks & 1][c], af, bfr);
        }
      }
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float u = big[0][c][e] + big[1][c][e];
          if (kSplit) u += small[0][c][e] + small[1][c][e];
          const float xv = kWhole || nx ? x_s[xo[e >> 1] + k] : x[xg[e >> 1] + k];
          const float p = in_carry<kOut>(__fmul_rn(in_carry<kOut>(u), in_carry<kOut>(xv)));
          vn[c][e] = k == 0 ? p : in_carry<kOut>(__fadd_rn(vn[c][e], p));
        }
      // a ring shorter than one site: refill block j's slot before this
      // site needs block j + slots
      if constexpr (!kWhole) {
        if (k + slots < phys) {
          __syncthreads();  // every read of block j done
          start_unit(next++);
        }
      }
    }

    // per-row L1 partials: quad shuffles, then one slot per (row, warp)
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[e >> 1] += fabsf(vn[c][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      if (t == 0) red_s[rloc[h] * WPM + ng] = part[h];
    }
    __syncthreads();  // B: partials written; every read of v_s and this site's blocks done
    // refill the slots this site freed
    for (; next < (n + 1) * phys / per + slots; ++next) start_unit(next);

    float safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* parts = red_s + rloc[h] * WPM;
      float total_h = parts[0];
#pragma unroll
      for (int w = 1; w < WPM; ++w) total_h += parts[w];
      // under a bf16 carry the whole row's fp32 sum is rounded once, as a
      // bf16 sum reduces; mean and step_thr are then both bf16 values
      const float mean = in_carry<kOut>(__fdiv_rn(in_carry<kOut>(total_h), (float)bond));
      safe[h] = mean > step_thr ? mean : 1.f;
      log_acc[h] += logf(safe[h]);
    }
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vcar[c][e] = in_carry<kOut>(__fdiv_rn(vn[c][e], safe[e >> 1]));
        v_s[rloc[e >> 1] * L.v_ld + jbase + 8 * c + 2 * t + (e & 1)] = as_operand<T>(vcar[c][e]);
      }
  }
  cp_async_wait(0);

  if constexpr (kOut != kClose) {
    // the carry (B, D) in its type from the C positions, rows past batch and
    // columns past D dropped; one thread a row writes the log
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = row0 + rloc[e >> 1], j = jbase + 8 * c + 2 * t + (e & 1);
        if (b >= batch || j >= bond) continue;
        const size_t o = (size_t)b * bond + j;
        if constexpr (kOut == kCarryBf16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(vcar[c][e]);
        else
          static_cast<float*>(out)[o] = vcar[c][e];
      }
    if (ng == 0 && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row0 + rloc[h] < batch) out_log[row0 + rloc[h]] = log_acc[h];
    }
  } else {
    // close: amp = v . r, then the |amp| rescale
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jbase + 8 * c + 2 * t + (e & 1);
        if (j < bond) part[e >> 1] = fmaf(vcar[c][e], right[j], part[e >> 1]);
      }
    __syncthreads();  // every read of the last site's partials is done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      if (t == 0) red_s[rloc[h] * WPM + ng] = part[h];
    }
    __syncthreads();
    if (ng == 0 && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = row0 + rloc[h];
        if (b >= batch) continue;
        const float* parts = red_s + rloc[h] * WPM;
        float s = parts[0];
#pragma unroll
        for (int w = 1; w < WPM; ++w) s += parts[w];
        const float mag = fabsf(s);
        const float sf = mag > close_thr ? mag : 1.f;
        static_cast<float*>(out)[b] = __fdiv_rn(s, sf);
        out_log[b] = log_acc[h] + logf(sf);
      }
    }
  }
}

// A launch's operands, as the C entry points receive them
struct Args {
  const void* cores;
  const float *x, *left, *right;
  void* out;
  float* log_out;
  void* work;  // the streamed path's workspace (streamed_layout)
  int n_sites, phys, bond, batch;
  float step_thr, close_thr;
};

template <typename T, int DP, bool kWhole, int kOut>
int launch_plan(const Args& a, const Plan& p, cudaStream_t stream) {
  const int smem = make_layout<T>(a.phys, DP, p.blocks, p.nx).total;
  auto kernel = mps_tc_kernel<T, DP, kWhole, kOut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.batch + kRows - 1) / kRows;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(a.cores), a.x, a.left, a.right,
                                           a.out, a.log_out, a.n_sites, a.phys, a.bond, a.batch,
                                           p.blocks, p.nx, a.step_thr, a.close_thr);
  return (int)cudaGetLastError();
}

template <typename T, int DP, int kOut>
int launch(const Args& a, cudaStream_t stream) {
  const Plan p = plan_for<T>(a.phys, DP);
  if (p.blocks == 0) return (int)cudaErrorInvalidValue;
  return p.whole ? launch_plan<T, DP, true, kOut>(a, p, stream)
                 : launch_plan<T, DP, false, kOut>(a, p, stream);
}

int padded_bond(int bond) { return bond <= 32 ? 32 : bond <= 64 ? 64 : 128; }

template <typename T, int kOut>
int launch_tensor_core(const Args& a, cudaStream_t stream) {
  switch (padded_bond(a.bond)) {
    case 32: return launch<T, 32, kOut>(a, stream);
    case 64: return launch<T, 64, kOut>(a, stream);
    default: if (a.bond <= 128) return launch<T, 128, kOut>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core path's CTA, or -1 where it has
// no plan (D > 128, or not even one ring slot fits)
int tc_smem(int cores_bf16, int phys, int bond) {
  if (bond < 1 || bond > 128 || phys < 1) return -1;
  const int dp = padded_bond(bond);
  const Plan p = cores_bf16 ? plan_for<__nv_bfloat16>(phys, dp) : plan_for<float>(phys, dp);
  if (p.blocks == 0) return -1;
  return cores_bf16 ? make_layout<__nv_bfloat16>(phys, dp, p.blocks, p.nx).total
                    : make_layout<float>(phys, dp, p.blocks, p.nx).total;
}

// ------------------------------------------------------------ streamed path

// 8 warps over a 64 x 64 tile, 4 along its rows (one m16 tile each) and 2
// along its columns (32 each): twice the warps of a 2 x 2 layout of
// 32 x 32, to hide more of each K step's load latency
template <typename T>
using SGemm = TileGemm<T, 4>;
constexpr int kSTileM = SGemm<float>::kM, kSTileN = SGemm<float>::kN;
constexpr int kSThreads = SGemm<float>::kThreads;
constexpr int kFinishRows = 4;  // rows (one a warp) of a finishing CTA

__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The workspace: two carries (B, D) fp32 and two sets of column-tile sums
// (B, ceil(D / 64)) fp32, each 256-byte aligned; site n writes set n & 1
// while the other column tiles of its rows still read set (n - 1) & 1
struct StreamedLayout {
  long long carry[2], part[2], total;  // byte offsets, total bytes
  int tiles_n;
};

StreamedLayout streamed_layout(int bond, int batch) {
  auto up = [](long long x) { return cdiv(x, 256) * 256; };
  StreamedLayout L;
  L.tiles_n = (int)cdiv(bond, kSTileN);
  const long long carry = up((long long)batch * bond * 4);
  const long long part = up((long long)batch * L.tiles_n * 4);
  L.carry[0] = 0;
  L.carry[1] = carry;
  L.part[0] = 2 * carry;
  L.part[1] = 2 * carry + part;
  L.total = 2 * carry + 2 * part;
  return L;
}

// The guarded mean of row b from its column-tile sums, added in tile order
// (no atomics: the same value in every CTA that reads it)
template <int kOut>
__device__ __forceinline__ float row_safe(const float* part, int tiles_n, long long b, int bond,
                                          float step_thr) {
  const float* p = part + b * tiles_n;
  float total = p[0];
  for (int i = 1; i < tiles_n; ++i) total += p[i];
  const float mean = in_carry<kOut>(__fdiv_rn(in_carry<kOut>(total), (float)bond));
  return mean > step_thr ? mean : 1.f;
}

struct SiteArgs {
  const void* cores;  // (N, d, D, D) of T, read in place
  const float* x;     // (B, N, d)
  const float* left;  // (D,), the A operand at site 0
  const float* prev;  // the carry after site n - 1 (unscaled), or null at site 0
  const float* part_prev;
  float* next;  // the carry after site n (unscaled)
  float* part_next;
  float* log_out;  // the running log, one slot a row
  int n_sites, phys, bond, batch, tiles_n;
  float step_thr;
};

// Site n for a 64-row x 64-column tile of the carry: per physical index k,
// u_k = A . A_n[k][:, cols] on mma.sync, A the previous carry divided by
// its row's safe (at site 0, left) and rounded to T as it is staged; then
// v' = sum_k x[b, n, k] u_k in registers, written unscaled with the tile's
// per-row sum |v'|.  Rows and columns past the batch and the bond load as
// zero and store nothing.
template <typename T, int kOut>
__global__ void __launch_bounds__(kSThreads)
mps_streamed_site_kernel(const __grid_constant__ SiteArgs a, int n) {
  using G = SGemm<T>;
  constexpr int kMI = G::kMI;
  __shared__ typename G::Smem sm;
  __shared__ float safe_s[kSTileM];
  __shared__ float red_s[kSTileM * 2];

  const int m0 = blockIdx.x * kSTileM, n0 = blockIdx.y * kSTileN;
  const int bond = a.bond, batch = a.batch, phys = a.phys;
  const int warp = threadIdx.x >> 5, tq = lane_id() & 3;

  // the previous site's rescale of this tile's rows; the first column tile
  // adds it to the log
  if (threadIdx.x < kSTileM) {
    const int b = m0 + threadIdx.x;
    float safe = 1.f;
    if (n > 0 && b < batch) {
      safe = row_safe<kOut>(a.part_prev, a.tiles_n, b, bond, a.step_thr);
      if (blockIdx.y == 0) a.log_out[b] = (n > 1 ? a.log_out[b] : 0.f) + logf(safe);
    }
    safe_s[threadIdx.x] = safe;
  }
  __syncthreads();

  // steps are (k, K step) pairs, k-major.  A is loaded raw and divided as
  // it is staged: a division that waits on its own load holds the next
  // loads back
  const T* core = static_cast<const T*>(a.cores) + (size_t)n * phys * bond * bond;
  const int nkt = (int)cdiv(bond, G::kK);
  auto fetch_a = [&](int s, int mi, int ki) {
    const int kk = (s % nkt) * G::kK + ki, b = m0 + mi;
    return b < batch && kk < bond ? (n ? a.prev[(size_t)b * bond + kk] : a.left[kk]) : 0.f;
  };
  auto put_a = [&](float v, int mi) {
    return from_float<T>(n ? in_carry<kOut>(__fdiv_rn(v, safe_s[mi])) : v);
  };
  auto fetch_b = [&](int s, int kb, int j) {
    const int k = s / nkt, kr = (s - k * nkt) * G::kK + kb, jc = n0 + j;
    return kr < bond && jc < bond ? core[((size_t)k * bond + kr) * bond + jc] : from_float<T>(0.f);
  };

  // rows of this thread's C positions: (mi, h) -> G::row(mi, 2h)
  long long xrow[kMI][2];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = min(m0 + G::row(mi, 2 * h), batch - 1);
      xrow[mi][h] = ((long long)b * a.n_sites + n) * phys;
    }

  // once u_k is complete, weight it by x[b, n, k] into v'
  float big[kMI][4][4] = {}, small[kMI][4][4] = {}, vn[kMI][4][4];
  auto weight = [&](int s) {
    if ((s + 1) % nkt) return;
    const int k = s / nkt;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const float xv[2] = {a.x[xrow[mi][0] + k], a.x[xrow[mi][1] + k]};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float u = big[mi][ni][c];
          if (sizeof(T) == 4) u += small[mi][ni][c];
          big[mi][ni][c] = small[mi][ni][c] = 0.f;
          const float p =
              in_carry<kOut>(__fmul_rn(in_carry<kOut>(u), in_carry<kOut>(xv[c >> 1])));
          vn[mi][ni][c] = k == 0 ? p : in_carry<kOut>(__fadd_rn(vn[mi][ni][c], p));
        }
    }
  };
  G::template run<false, sizeof(T) == 4, float>(sm, phys * nkt, fetch_a, put_a, fetch_b, big,
                                                small, weight);

  // v' unscaled, and the tile's per-row sum |v'|: over this thread's
  // columns, the 4 lanes of a quad, then the two warps of the rows in order
  float part[kMI][2] = {};
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + G::row(mi, c), col = n0 + G::col(ni, c);
        if (row < batch && col < bond) {
          a.next[(size_t)row * bond + col] = vn[mi][ni][c];
          part[mi][c >> 1] += fabsf(vn[mi][ni][c]);
        }
      }
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p = part[mi][h];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (tq == 0) red_s[G::row(mi, 2 * h) * 2 + (warp & 1)] = p;
    }
  __syncthreads();
  if (threadIdx.x < kSTileM && m0 + (int)threadIdx.x < batch)
    a.part_next[(size_t)(m0 + threadIdx.x) * a.tiles_n + blockIdx.y] =
        red_s[2 * threadIdx.x] + red_s[2 * threadIdx.x + 1];
}

// After the last site, one warp a row: the last rescale, then kClose's
// close against `right` (fmaf, lane-strided, a shuffle tree) and |amp|
// rescale, or the carry in its type.  v_ld 0 and part null: no site ran,
// the carry is `v` (left) unscaled.
template <int kOut>
__global__ void __launch_bounds__(32 * kFinishRows)
mps_streamed_finish_kernel(const float* __restrict__ v, int v_ld, const float* __restrict__ part,
                           const float* __restrict__ right, void* __restrict__ out,
                           float* __restrict__ log_out, int n_sites, int bond, int batch,
                           int tiles_n, float step_thr, float close_thr) {
  const long long b = (long long)blockIdx.x * kFinishRows + (threadIdx.x >> 5);
  const int lane = lane_id();
  if (b >= batch) return;
  const float safe = part ? row_safe<kOut>(part, tiles_n, b, bond, step_thr) : 1.f;
  const float* vb = v + b * v_ld;
  if constexpr (kOut == kClose) {
    float s = 0.f;
    for (int j = lane; j < bond; j += 32) s = fmaf(__fdiv_rn(vb[j], safe), right[j], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float lg = (n_sites > 1 ? log_out[b] : 0.f) + (part ? logf(safe) : 0.f);
      const float mag = fabsf(s);
      const float sf = mag > close_thr ? mag : 1.f;
      static_cast<float*>(out)[b] = __fdiv_rn(s, sf);
      log_out[b] = lg + logf(sf);
    }
  } else {
    for (int j = lane; j < bond; j += 32) {
      const float c = in_carry<kOut>(__fdiv_rn(vb[j], safe));
      if constexpr (kOut == kCarryBf16)
        static_cast<__nv_bfloat16*>(out)[b * bond + j] = __float2bfloat16_rn(c);
      else
        static_cast<float*>(out)[b * bond + j] = c;
    }
    if (lane == 0) log_out[b] = (n_sites > 1 ? log_out[b] : 0.f) + (part ? logf(safe) : 0.f);
  }
}

// Every site, one launch each, then the finishing kernel; the carries and
// tile sums in `work` (streamed_layout's bytes), the running log in log_out
template <typename T, int kOut>
int launch_streamed(const Args& a, cudaStream_t stream) {
  if (a.n_sites < 0 || a.phys < 1 || a.bond < 1 || a.batch < 0 || !a.work)
    return (int)cudaErrorInvalidValue;
  if (a.batch == 0) return 0;
  const StreamedLayout L = streamed_layout(a.bond, a.batch);
  if (L.tiles_n > 65535 || cdiv(a.batch, kSTileM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  char* ws = static_cast<char*>(a.work);
  float* carry[2] = {reinterpret_cast<float*>(ws + L.carry[0]),
                     reinterpret_cast<float*>(ws + L.carry[1])};
  float* part[2] = {reinterpret_cast<float*>(ws + L.part[0]),
                    reinterpret_cast<float*>(ws + L.part[1])};
  const dim3 grid((unsigned)cdiv(a.batch, kSTileM), (unsigned)L.tiles_n);
  SiteArgs s = {a.cores, a.x, a.left, nullptr, nullptr, nullptr, nullptr, a.log_out,
                a.n_sites, a.phys, a.bond, a.batch, L.tiles_n, a.step_thr};
  for (int n = 0; n < a.n_sites; ++n) {
    s.prev = n ? carry[(n - 1) & 1] : nullptr;
    s.part_prev = n ? part[(n - 1) & 1] : nullptr;
    s.next = carry[n & 1];
    s.part_next = part[n & 1];
    mps_streamed_site_kernel<T, kOut><<<grid, kSThreads, 0, stream>>>(s, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int last = a.n_sites - 1;
  mps_streamed_finish_kernel<kOut>
      <<<(unsigned)cdiv(a.batch, kFinishRows), 32 * kFinishRows, 0, stream>>>(
          a.n_sites ? carry[last & 1] : a.left, a.n_sites ? a.bond : 0,
          a.n_sites ? part[last & 1] : nullptr, a.right, a.out, a.log_out, a.n_sites, a.bond,
          a.batch, L.tiles_n, a.step_thr, a.close_thr);
  return (int)cudaGetLastError();
}

// The path for a shape: 1 the tensor-core kernel wherever one of its plans
// fits, 2 the streamed kernels for every other shape with d, D >= 1, 0 for
// a zero dimension
int path_for(int cores_bf16, int phys, int bond) {
  if (phys < 1 || bond < 1) return 0;
  return tc_smem(cores_bf16, phys, bond) >= 0 ? 1 : 2;
}

template <int kOut>
int launch_path(const Args& a, int cores_bf16, int path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return cores_bf16 ? launch_tensor_core<__nv_bfloat16, kOut>(a, s)
                      : launch_tensor_core<float, kOut>(a, s);
  if (path == 2)
    return cores_bf16 ? launch_streamed<__nv_bfloat16, kOut>(a, s)
                      : launch_streamed<float, kOut>(a, s);
  return (int)cudaErrorInvalidValue;
}

int launch_mode(const Args& a, int cores_bf16, int mode, int path, void* stream) {
  switch (mode) {
    case kClose: return launch_path<kClose>(a, cores_bf16, path, stream);
    case kCarryF32: return launch_path<kCarryF32>(a, cores_bf16, path, stream);
    case kCarryBf16: return launch_path<kCarryBf16>(a, cores_bf16, path, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel #1, on the path cn_mps_path picks.  x (B, N, d) fp32; left/right
// (D,) fp32; cores fp32 or bf16, on the tensor-core path laid out as
// (N, d, DP, LD), zero beyond (d, D, D), with DP = cn_mps_core_rows(D) and
// LD = cn_mps_core_ld(D), on the streamed path (N, d, D, D) as they are,
// with work of cn_mps_streamed_workspace bytes (unused on the tensor-core
// path).  Writes amp and log (B,) fp32.
int cn_mps_evaluate(const void* cores, int cores_bf16, const float* x, const float* left,
                    const float* right, float* amp, float* log_out, void* work, int n_sites,
                    int phys, int bond, int batch, float step_thr, float close_thr,
                    void* stream) {
  const Args a = {cores, x, left, right, amp, log_out, work, n_sites, phys, bond, batch,
                  step_thr, close_thr};
  return launch_mode(a, cores_bf16, kClose, path_for(cores_bf16, phys, bond), stream);
}

// Kernel #2, on the path cn_mps_path picks.  cores, x and work as for
// cn_mps_evaluate; left (D,) fp32, already cast to the core type and the
// carry type.  Writes the carry v_out (B, D) in fp32 (carry_bf16 = 0) or
// bf16 (carry_bf16 = 1) and log (B,) fp32.
int cn_mps_epilogue(const void* cores, int cores_bf16, const float* x, const float* left,
                    void* v_out, int carry_bf16, float* log_out, void* work, int n_sites,
                    int phys, int bond, int batch, float step_thr, void* stream) {
  const Args a = {cores, x, left, nullptr, v_out, log_out, work, n_sites, phys, bond, batch,
                  step_thr, 0.f};
  return launch_mode(a, cores_bf16, carry_bf16 ? kCarryBf16 : kCarryF32,
                     path_for(cores_bf16, phys, bond), stream);
}

// The streamed path at any d, D >= 1, also where cn_mps_path picks the
// tensor-core path: a yardstick to time the two side by side
// (ops/cuda_mps.py mps_chain_streamed); the entries above call it only for
// the shapes cn_mps_path assigns to it.  Operands as for the streamed path
// of cn_mps_evaluate (mode 0, out = amp) or cn_mps_epilogue (mode 1 fp32
// carry, 2 bf16 carry, out = v_out; right is not read).
int cn_mps_chain_streamed(const void* cores, int cores_bf16, const float* x, const float* left,
                          const float* right, void* out, int mode, float* log_out, void* work,
                          int n_sites, int phys, int bond, int batch, float step_thr,
                          float close_thr, void* stream) {
  const Args a = {cores, x, left, right, out, log_out, work, n_sites, phys, bond, batch,
                  step_thr, close_thr};
  return phys < 1 || bond < 1 ? (int)cudaErrorInvalidValue
                              : launch_mode(a, cores_bf16, mode, 2, stream);
}

// The path cn_mps_evaluate and cn_mps_epilogue take for these operands: 1
// the tensor-core kernel, 2 the streamed kernels, 0 for d or D < 1.
int cn_mps_path(int cores_bf16, int phys, int bond) { return path_for(cores_bf16, phys, bond); }

// Bytes of device workspace the streamed path needs for B rows at bond D.
int cn_mps_streamed_workspace(int bond, int batch, long long* bytes) {
  if (bond < 1 || batch < 0) return (int)cudaErrorInvalidValue;
  *bytes = streamed_layout(bond, batch).total;
  return 0;
}

// DP, the rows of each (DP, LD) block of the tensor-core path's core layout
// for bond D.
int cn_mps_core_rows(int bond) { return padded_bond(bond); }

// LD, the row length (elements) of each block of that layout for bond D.
int cn_mps_core_ld(int bond) { return core_ld(padded_bond(bond)); }

// Dynamic shared memory of the tensor-core path's CTA for these operands
// (bytes), the same for both entries, or -1 where that path has no plan:
// D > 128, or not even one ring slot fits the per-block limit.
int cn_mps_evaluate_smem(int cores_bf16, int phys, int bond) {
  return tc_smem(cores_bf16, phys, bond);
}

}  // extern "C"
