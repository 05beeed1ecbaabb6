// Batched MPO expectation environments on Hopper's tensor cores:
// <psi_b| H |psi_b> for per-sample MPS cores (B, N, d, D, D) and one uniform
// MPO core W[d, e, w, v].
//
// Replaces the Pallas TPU kernel contractn_tpu/ops/pallas_mpo.py:134
// (_kernel, launched by _mpo_pallas_run).  As there, the kernel returns the
// final environment (B, W*D, D) fp32 and the log register; the close with
// the boundary vectors runs outside.  Entry: cn_mpo_env.
//
// Bound (H100 SXM, fp32 cores, W = 3, D = 64, d = 2, B = 1000, N = 50): per
// sample and site 2*d*W*D^3 (ket) + 2*W*d*D^3 (bra) GEMM FLOPs, 3.15e11 in
// all, on 1.64 GB of cores.  fp32-accurate products run as 3xTF32 (three
// TF32 passes at 495 TFLOP/s): 1.91 ms, above the 0.49 ms the cores take to
// stream from HBM once.  bf16 cores take one bf16 pass (989 TFLOP/s).
//
// Design:
//   * One CTA of 16 warps per sample (8 warps with 255 registers each
//     measured slower) loops over all N sites, the fp32 environment E
//     (W*D, D) resident in shared memory.  At D = 64 one CTA fills an SM;
//     1000 samples on 132 SMs end in a 58%-full last wave.
//   * Per site, on mma.sync (3xTF32 m16n8k8 for fp32 cores, m16n8k16 bf16
//     for bf16; see tc_common.cuh):
//       1. ket GEMMs  t[e*W+w] = E_w A_e, (W*D x D)(D x d*D) = 192x64 . 64x128:
//          a warp takes strips of one (e, 16-row, 32-column) tile over NW
//          environment blocks w, so each split B fragment serves NW
//          products, one accumulator each (the 3 TF32 passes into it).
//          Where E and t do not fit side by side (W = 4, 5 at D = 64,
//          d = 2), E lives over the rooms of the last e's products, and
//          those strips (at most one a warp) stay in registers until every
//          warp has read E, behind one more barrier;
//       2. channel mix in place: t2[v*d+p] = sum_q M[v*d+p][q] t[q], one
//          thread per (i, l) holding all d*W blocks in registers; the result
//          is rounded to the core type (the Pallas kernel's cast before the
//          bra GEMM).  The nonzero W entries arrive as this dense matrix (a
//          zero entry adds an exact zero), zero-padded to 16 x 16 and
//          passed by value as a kernel parameter: its reads are constant-bank
//          operands of the FMAs, unrolled, and no shared-memory store can
//          alias them;
//       3. bra GEMMs  out[v] = A^T t2[v], (D x d*D)(d*D x D) per v, the A
//          operand read transposed straight from the core buffer: each warp
//          owns one fixed 16x16 (j, l) tile in every v it serves (NB of them
//          at most, one accumulator each), so one A fragment feeds all of
//          them, and keeps them in registers;
//       4. mean |out| over the whole environment: warp shuffles, one partial
//          a warp in shared memory, every thread adds the 16 in a fixed
//          order; guard mean > MIN_NORM, E = out * (1/safe) written from the
//          registers (to env_out at the last site), log += log(safe).
//     The environment is cast to the core type as the ket's A operand, as in
//     the Pallas kernel; every GEMM accumulates in fp32.
//     All K loops run the padded width DP (32 or 64) at compile time,
//     unrolled by 2 (fully unrolled they spill at the 128 registers a thread
//     has).  NW and NB are template parameters picked from W (config_for).
//   * Async copies: the next site's core (d, D, D), 32 KB at fp32, lands in
//     the second of two shared buffers by the TMA (cp.async.bulk, one row per
//     copy, spread over the threads, completion on an mbarrier) while this
//     site computes.  Where two buffers do not fit even with E over t
//     (large d*W), one buffer is refilled after the site's last read of it.
//     (The cores are (B, N, d, D, D), 1.6 GB at the bench shape: the padded
//     copy that lets kernel #1 fetch a block in one request would move
//     3.5 GB more through HBM a call.)
//   * Shared memory (fp32, W = 3, D = 64, d = 2): t 98,304 B (d*W blocks of
//     64 x 64 fp32, unpadded, XOR-swizzled for the B pattern, tc_common.cuh
//     swz) + E 52,224 B (rows padded to D + 4 floats for the A pattern) + 2
//     core buffers 73,728 B (rows padded to D + 8) + partials 64 B +
//     barriers 16 B = 224,336 B of the 232,448 B a block may opt in to.  E
//     over t saves all of E but W*D*4 floats of row padding (plan_for).
//     Rows and columns past D (D < 32 or 64, the tiles' sizes) stay zero.
//   * Reach of the tensor-core path: D <= 64, d*W <= 16, W <= 8 at D > 32,
//     and t, E's padding and one core buffer within the opt-in limit.  The
//     operand layout asks for D * sizeof(T) to be a multiple of 16 bytes;
//     the wrapper pads the bond with zeros otherwise (ops/cuda_mpo.py).
//
// Cluster path (mpo_env_cluster_kernel), for the shapes no one-CTA plan
// holds, up to D = 128 (D > 64, or many ket blocks at 33 <= D <= 64, such
// as d = 2 with W = 7, 8 or d = 1 with W = 9..16).
//
// Bound (H100 SXM, fp32 cores, Heisenberg W = 5, d = 2, D = 128, B = 1000,
// N = 50): 4*d*W*D^3 GEMM FLOPs per sample and site, 4.19e12 in all, run as
// 3xTF32 at 495 TFLOP/s: 25.4 ms, far above the 1.96 ms its 6.55 GB of
// cores take to stream from HBM once.  What bars the one-CTA design there
// is shared memory: E alone is 5*128*132*4 = 337,920 B.
//
// Design: a thread-block cluster of C CTAs (2 <= C <= 8, 512 threads each)
// walks one sample's sites; CTA c owns the columns l in [c*LC, (c+1)*LC) of
// the padded bond DP = C*LC (DP = D rounded up to 16, at least 32; LC 16,
// 32 or 64).  Splitting by columns keeps the channel mix and the bra
// local, and leaves two operands that cross CTAs, both read straight from
// the peers' shared memory (distributed shared memory, addresses from
// mapa) between cluster barriers:
//   * the ket's A operand E_w[i, k] over all k: t[e, w][:, c-slice] =
//     E_w A_e[:, c-slice], the sum over k taken peer by peer (each CTA
//     starts at its own slice, so the peers are not all read at once);
//   * the bra's A operand, the core's columns j:  out[v][:, c-slice] =
//     sum_p A_p^T t2[v, p][:, c-slice], a 16-row tile of j read from the
//     CTA that holds those columns, one fragment feeding a group of v's
//     (the core is the same for every v).
// The CTA's own panel of each is read through its own shared-memory
// address (plain shared loads), the peers' through the cluster's.
// So each CTA stages only its own column slice of the core (d, DP, LC) by
// the TMA (cp.async.bulk, one copy a row, mbarrier completion) into its one
// core buffer, the next site's as soon as every CTA of the cluster has read
// this one's (the cluster barrier before the rescale), so that the copy
// overlaps the rescale; the cores are read from HBM once in all, and no
// copy is multicast.  (A second buffer, which let the copy overlap the
// GEMMs as on the one-CTA path, is not kept: PERF.md, section 6, has the
// times with and without it.)  The mean
// |.| is a cluster reduction: one partial per CTA, every CTA adding the C
// partials over distributed shared memory in rank order, so all apply the
// same `safe` and the result does not depend on timing.
//
// Shared memory per CTA: d*W blocks of (DP, LC + pad) fp32, rows padded
// (pad 8) for the fragment patterns, and the core buffer.  The
// environment takes no room of its own: E_x lives in block slot
// x*d + d - 1 of the w-major slots x*d + y.  Two rules make that safe:
//   1. the ket runs in rounds of at most one item a warp, an item being
//      (w, 16-row tile mi, chunk of e) in w-major order with the chunk that
//      holds e = d - 1 last; a round's products stay in registers until a
//      cluster barrier says every CTA has read E_w's rows mi, then land in
//      their slots w*d + e;
//   2. the bra runs in rounds of v's (a warp a 16-row tile of j and a
//      group of v's); out[v] lands in slot v*d + d - 1 (t2[v, d-1]'s) once
//      the round's reads of t2 are done, unscaled, and is rescaled in place
//      after the cluster-wide mean.
// Host side, cluster_plan_for picks the smallest C (widest LC) whose layout
// fits, with padded rows, else unpadded; where no C fits, the shape is out
// of reach.  The launch checks the cluster with
// cudaOccupancyMaxActiveClusters and returns the CUDA error of anything
// refused; nothing falls back.  An item holds at
// most 8 m16n8 accumulator tiles (a ket item splits its e range into
// chunks to stay there).  The four steps, casts, mix and rescale are those
// of the one-CTA path; 3xTF32 for fp32 cores, one bf16 pass for bf16.
// Its times on the card, beside those of the FMA kernel it replaced, are
// in PERF.md (section 6, kernel #3's row).
//
// Streamed path (launch_streamed, exported as cn_mpo_env_streamed), for
// every valid shape neither on-chip path holds: d*W > 16 (the on-chip
// paths hold a position's whole channel mix in registers, from a 16 x 16
// kernel parameter), D > 128, and the shapes whose blocks do not fit a
// CTA's shared memory (fp32 d 15-16 with W 1 at D 113-128).  It exists
// because the Pallas kernel, which sizes only its VMEM tile, takes all of
// them (spin-1 AKLT: d 3, W 14; spinful fermions: d 4, W 6; DMRG bonds of
// 256 and more).
//
// Bound (H100 SXM, fp32 cores, 3xTF32 at 495 TFLOP/s): AKLT (d 3, W 14),
// D = 64, B = 1000, N = 50: 2.20e12 GEMM FLOPs, 13.3 ms, on 2.46 GB of
// cores (0.73 ms); Heisenberg (d 2, W 5), D = 256, B = 256, N = 50:
// 8.59e12, 52.1 ms, on 6.71 GB (2.0 ms).  At these shapes a site's work is
// large enough to pay for keeping the environment in device memory: at
// D 256, Heisenberg, the GEMMs do about 50 FLOPs a byte that E, the ket
// and mixed products and the output move through HBM in a site
// (4dWD^3 against 4D^2(2W + 4dW) bytes), about the card's 3xTF32 rate
// over its HBM bandwidth (49).
//
// Design: the environment E (B, W*D, D) fp32 lives in env_out, the
// intermediates in one device workspace the wrapper allocates (layout
// streamed_layout; the kernels allocate nothing).  The whole batch is one
// chunk: each launch covers every sample.  Per site, four launches:
//   1. ket: t[b, e] (W*D x D) = (E_b * inv_b) A_{b,e}, a batched tiled GEMM
//      (streamed_gemm_kernel on tc_common.cuh's TileGemm, 64 x 64 tiles,
//      K steps of 32, 4 warps of 32 x 32 on mma.sync, 3xTF32 for fp32
//      cores and one bf16 pass for bf16, fp32 accumulation) over
//      z = (b, e).  The previous site's
//      rescale is fused into its A-operand load: E * inv in fp32, then the
//      cast to the core type (the Pallas kernel's env * (1/safe), then
//      astype).  At site 0, A is env0 for every sample;
//   2. channel mix: t2[b, v*d + p] = sum_q M[v*d+p][q] t[b, q], q = e*W + w
//      ascending (entry order), from the dense (d*W)^2 matrix in device
//      memory, its zero entries skipped (a warp-uniform branch; the AKLT
//      chain has 42 nonzero of 1764), so it sums the entries alone; one
//      thread per 4 positions (i, l), 16 outputs at a time in registers;
//      rounded to the core type as it is stored;
//   3. bra: out[b, v] (D x D) = A_b^T t2[b, v], the same GEMM template over
//      z = (b, v) with A read transposed from the core; out is written
//      unscaled into E, and each CTA writes sum |out| over its tile to a
//      fixed slot (warp shuffles, then its 4 warps in order);
//   4. rescale: one thread a sample adds its slots in order (no atomics, so
//      the sum does not depend on timing), mean = sum / (W*D*D unpadded),
//      guard mean > MIN_NORM, inv = 1/safe, log += log(safe).
//   After the last site, E = E * inv in place.
// Any D: the GEMM tiles and the mix mask their ragged edges (zero loads,
// no stores), so the bond is not padded.  No TMA, wgmma or L2 residency
// yet: PERF.md (section 6, kernel #3's row) has its times.
//
// One C function (path_for, exported as cn_mpo_env_path) picks the path
// from the shape before the launch: the one-CTA tensor-core path wherever
// one of its plans fits, the cluster path where only it fits, the streamed
// path for every other shape with d, D, W >= 1.  A failed launch of one
// path is never retried on another.

#include "tc_common.cuh"

namespace {

using namespace cn;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBraN = 2;     // n8 fragments across a bra tile (16 columns)
constexpr int kMaxMix = 16;  // d * W
constexpr int kSmemLimit = 232448;

// Channel mix M[o][q], o = v*d + p, q = e*W + w, zero-padded to 16 x 16
struct Mix {
  float m[kMaxMix * kMaxMix];
};

struct Plan {
  int nbuf;    // core buffers: 2 (the next site's copy overlaps this one's compute) or 1
  bool alias;  // E over the last e's ket products, not beside t
};

struct Layout {
  int stage_elems;
  int env, core, red, bar, total;  // byte offsets (t at 0), total bytes
};

// t (d*W*dp, dp) fp32 at offset 0; E (W*dp, dp + 4) after it, or (alias)
// from the start of t's last W blocks, overhanging t by W*dp*4 floats; then
// nbuf core buffers (d*dp, core_ld(dp)), the partials and two mbarriers
template <typename T>
__host__ __device__ Layout make_layout(int phys, int dp, int wdim, Plan p) {
  Layout L;
  const int t_bytes = phys * wdim * dp * dp * 4, e_bytes = wdim * dp * (dp + 4) * 4;
  L.stage_elems = phys * dp * core_ld(dp);
  L.env = p.alias ? t_bytes - wdim * dp * dp * 4 : t_bytes;
  L.core = L.env + e_bytes;
  L.red = L.core + p.nbuf * L.stage_elems * (int)sizeof(T);
  L.bar = L.red + kWarps * 4;
  L.total = L.bar + 2 * 8;
  return L;
}

// The first layout that fits of: E beside t with two core buffers, E over
// t with two, E over t with one; nbuf = 0 when none fits
template <typename T>
Plan plan_for(int phys, int dp, int wdim) {
  const Plan order[] = {{2, false}, {2, true}, {1, true}};
  for (const Plan& p : order)
    if (make_layout<T>(phys, dp, wdim, p).total <= kSmemLimit) return p;
  return {0, false};
}

// Tiling for bond and W: the padded bond DP, the environment blocks a ket
// strip walks (NW) and the bra tiles a warp keeps (NB); false outside the
// kernel's reach.  At DP = 32 a v-step of 4 warps' tiles covers one v, so
// NB = ceil(W / 4) <= 4; at DP = 64 every warp serves every v, NB >= W.
// The last physical index's ket strips (kTiles * ceil(W / NW) of them) must
// not outnumber the warps: each warp holds at most one across a barrier.
struct Config {
  int dp, nw, nb;
};
bool config_for(int bond, int wdim, Config& c) {
  if (bond <= 32) {
    c = {32, 4, wdim <= 4 ? 1 : 4};
    return wdim <= 16;
  }
  if (bond > 64 || wdim > 8) return false;
  if (wdim <= 2)
    c = {64, 2, 2};
  else if (wdim <= 4)
    c = {64, wdim, wdim};
  else
    c = {64, wdim <= 6 ? 3 : 4, 8};
  return true;
}

// t2 = M t in place at every (i, l), MQ >= d*W
template <typename T, int MQ, int DP>
__device__ __forceinline__ void channel_mix(float* t_s, const Mix& mix, int nq) {
  for (int p = threadIdx.x; p < DP * DP; p += kThreads) {  // rows, columns past D hold 0
    const int i = p / DP, l = p % DP;
    float in[MQ];
#pragma unroll
    for (int q = 0; q < MQ; ++q) in[q] = q < nq ? t_s[swz<T>(q * DP + i, l, DP)] : 0.f;
#pragma unroll
    for (int o = 0; o < MQ; ++o) {
      if (o >= nq) break;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < MQ; ++q) s = fmaf(mix.m[o * kMaxMix + q], in[q], s);
      t_s[swz<T>(o * DP + i, l, DP)] = as_operand<T>(s);
    }
  }
}

template <typename T, int DP, int NW, int NB>
__global__ void __launch_bounds__(kThreads)
mpo_env_kernel(const T* __restrict__ cores, const float* __restrict__ env0,
               const __grid_constant__ Mix mix, float* __restrict__ env_out,
               float* __restrict__ log_out, int n_sites, int phys, int bond, int wdim,
               Plan plan, float count, float thr) {
  using Op = Tc<T>;
  constexpr int KS = Op::kK;
  constexpr int T16 = DP / 16, T32 = DP / 32;
  constexpr int kTiles = T16 * T32;  // (16-row, 32-column) tiles of a DP x DP block
  constexpr int TB = DP / (8 * kBraN);
  constexpr int kPerV = T16 * TB;  // bra tiles per v, divides kWarps
  constexpr int kVStep = kWarps / kPerV;
  constexpr int NKS = DP / KS;
  constexpr int CLD = core_ld(DP);

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout<T>(phys, DP, wdim, plan);
  const int nq = phys * wdim, nbuf = plan.nbuf;
  float* t_s = reinterpret_cast<float*>(smem);           // (nq*DP, DP), swizzled
  float* e_s = reinterpret_cast<float*>(smem + L.env);  // E (W*DP, ld)
  T* c_s = reinterpret_cast<T*>(smem + L.core);  // nbuf x (d*DP, CLD)
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  constexpr int ld = DP + 4;  // E's rows: 4 words mod 32 serve the A pattern

  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;
  const int dd = bond * bond;
  // ket strips, e-major: (e, chunk of NW blocks w, 16-row tile, 32-column tile)
  const int spg = kTiles * ((wdim + NW - 1) / NW);
  const int ns = phys * spg;
  const int nh = plan.alias ? ns - spg : ns;  // strips from nh on write over E
  // this warp's bra tile: fixed (j, l) block, v = v0 + r * kVStep
  const int mj = (warp % kPerV) / TB, nl = (warp % kPerV) % TB;
  const int v0 = warp / kPerV;

  zero_shared(reinterpret_cast<float*>(smem), L.total / 4);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_barrier_init();
  }
  for (int e = threadIdx.x; e < wdim * dd; e += kThreads) {
    const int r = e / bond, k = e - r * bond;  // r = w * bond + i
    e_s[((r / bond) * DP + r % bond) * ld + k] = env0[e];
  }
  __syncthreads();

  auto fetch = [&](int n) {
    if (n < n_sites)
      stage_core(c_s + (n % nbuf) * L.stage_elems, cores + ((size_t)b * n_sites + n) * phys * dd,
                 phys, bond, DP, CLD, &bar[n % nbuf]);
  };
  fetch(0);
  float log_acc = 0.f;
  float acc[NW][4][4];

  // ket strip s into acc: t[e*W + w] = E_w A_e for the strip's blocks w.
  // Blocks past W (W not a multiple of NW) repeat the last one, so the hot
  // loop has no branch; store() drops them.
  auto ket = [&](const T* cs, int s) {
    const int e = s / spg, r = s % spg;
    const int w0 = (r / kTiles) * NW, mi = (r % kTiles) / T32, ni = r % T32;
    const T* B = cs + e * DP * CLD + ni * 32;
    int ao[NW];  // E_w's row tile, as an offset into e_s
#pragma unroll
    for (int w = 0; w < NW; ++w) ao[w] = (min(w0 + w, wdim - 1) * DP + mi * 16) * ld;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[w][nt][c] = 0.f;
#pragma unroll 2  // full unrolling spills at 128 registers
    for (int ks = 0; ks < NKS; ++ks) {
      typename Op::BFrag bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        Op::load_b(bf[nt], [&](int rr, int c) { return B[(ks * KS + rr) * CLD + nt * 8 + c]; }, g,
                   t);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        typename Op::AFrag af;  // bf16: packing E rounds it, the Pallas cast
        Op::load_a(af, [&](int rr, int c) { return e_s[ao[w] + rr * ld + ks * KS + c]; }, g, t);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Op::mma(acc[w][nt], af, bf[nt]);
      }
    }
  };
  auto store = [&](int s) {
    const int e = s / spg, r = s % spg;
    const int w0 = (r / kTiles) * NW, mi = (r % kTiles) / T32, ni = r % T32;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w0 + w >= wdim) break;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = (e * wdim + w0 + w) * DP + mi * 16 + g + 8 * (c >> 1);
          const int col = ni * 32 + nt * 8 + 2 * t + (c & 1);
          t_s[swz<T>(row, col, DP)] = acc[w][nt][c];
        }
    }
  };

  for (int n = 0; n < n_sites; ++n) {
    if (nbuf == 2) fetch(n + 1);
    mbar_wait(&bar[n % nbuf], (n / nbuf) & 1);
    __syncthreads();  // this site's core landed; E holds the environment
    const T* cs = c_s + (n % nbuf) * L.stage_elems;

    // 1. ket GEMMs; with E over t, a warp's strip of the last e is held
    // until every warp has read E
    int held = -1;
    for (int s = warp; s < ns; s += kWarps) {
      ket(cs, s);
      if (s < nh)
        store(s);
      else
        held = s;  // at most one a warp, its last
    }
    if (plan.alias) {
      __syncthreads();  // every read of E done
      if (held >= 0) store(held);
    }
    __syncthreads();

    // 2. channel mix, in place
    if (nq <= 8)
      channel_mix<T, 8, DP>(t_s, mix, nq);
    else
      channel_mix<T, kMaxMix, DP>(t_s, mix, nq);
    __syncthreads();

    // 3. bra GEMMs: this warp's (j, l) tile in every v it serves (v past W
    // repeats the last one, without a branch in the hot loop, and is dropped)
    float keep[NB][kBraN][4] = {};
    for (int p = 0; p < phys; ++p) {
      const T* A = cs + p * DP * CLD + mj * 16;  // A^T: row (p, i), column j
      int bo[NB];  // t2[v], rows (p, i), as an offset into t_s
#pragma unroll
      for (int r = 0; r < NB; ++r) bo[r] = (min(v0 + r * kVStep, wdim - 1) * phys + p) * DP * DP;
#pragma unroll 2
      for (int ks = 0; ks < NKS; ++ks) {
        typename Op::AFrag af;
        Op::load_a(af, [&](int row, int c) { return A[(ks * KS + c) * CLD + row]; }, g, t);
#pragma unroll
        for (int r = 0; r < NB; ++r) {
#pragma unroll
          for (int nt = 0; nt < kBraN; ++nt) {
            typename Op::BFrag bf;
            Op::load_b(bf, [&](int row, int c) {
              return t_s[bo[r] + swz<T>(ks * KS + row, nl * 8 * kBraN + nt * 8 + c, DP)];
            }, g, t);
            Op::mma(keep[r][nt], af, bf);
          }
        }
      }
    }
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      if (v0 + r * kVStep >= wdim) break;
#pragma unroll
      for (int nt = 0; nt < kBraN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) part += fabsf(keep[r][nt][c]);
    }

    // 4. rescale the whole environment by its mean |.|
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();  // partials written; every read of t and this core done
    if (nbuf == 1) fetch(n + 1);
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red_s[w];
    const float norm = __fdiv_rn(total, count);
    const float safe = norm > thr ? norm : 1.f;
    const float inv = __fdiv_rn(1.f, safe);
    log_acc += logf(safe);
    const bool last = n == n_sites - 1;
    float* out = env_out + (size_t)b * wdim * dd;
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const int v = v0 + r * kVStep;
      if (v >= wdim) break;
#pragma unroll
      for (int nt = 0; nt < kBraN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = mj * 16 + g + 8 * (c >> 1);
          const int l = nl * 8 * kBraN + nt * 8 + 2 * t + (c & 1);
          const float val = keep[r][nt][c] * inv;
          if (!last)
            e_s[(v * DP + j) * ld + l] = val;
          else if (j < bond && l < bond)
            out[(v * bond + j) * bond + l] = val;
        }
    }
  }
  if (threadIdx.x == 0) log_out[b] = log_acc;
}

// ------------------------------------------------------------ cluster path

constexpr int kClusterMax = 8;      // CTAs a cluster may hold portably
constexpr int kClusterBond = 128;   // widest bond of the cluster path
constexpr int kItemTiles = 8;       // m16n8 accumulator tiles of one item

struct ClusterPlan {
  int csize;  // CTAs per sample (0: no plan fits)
  int lc;     // bond columns a CTA owns: 16, 32 or 64
  int dp;     // padded bond, csize * lc
  int pad;    // row padding of the blocks and the core rows: 8 or 0
};

struct ClusterLayout {
  int ld;           // row length of a block and of a core row
  int stage_elems;  // the core slice (d*dp, ld)
  int core, red, bar, total;  // byte offsets (blocks at 0), total bytes
};

// Cluster primitives (sm_90): this CTA's rank and its cluster's index, a
// barrier over every thread of the cluster (release, then acquire), and the
// generic address of the same shared-memory offset in CTA `rank`
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename P>
__device__ __forceinline__ P* map_rank(P* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<P*>(out);
}

template <typename T>
__host__ __device__ ClusterLayout cluster_layout(int phys, int wdim, ClusterPlan p) {
  ClusterLayout L;
  L.ld = p.lc + p.pad;
  L.stage_elems = phys * p.dp * L.ld;
  L.core = phys * wdim * p.dp * L.ld * 4;
  L.red = L.core + L.stage_elems * (int)sizeof(T);
  L.bar = L.red + 32 * 4;  // kWarps partials and the CTA's total
  L.total = L.bar + 8;
  return L;
}

// The padded bond, cluster size and row padding for a shape: the smallest
// cluster whose layout fits (fewer, wider CTAs measured faster even with
// unpadded rows: PERF.md), with padded rows, else unpadded; csize = 0 when
// none fits
template <typename T>
ClusterPlan cluster_plan_for(int phys, int bond, int wdim) {
  const ClusterPlan none = {0, 0, 0, 0};
  if (phys < 1 || wdim < 1 || bond < 1 || bond > kClusterBond || phys * wdim > kMaxMix)
    return none;
  const int dp = bond <= 32 ? 32 : (bond + 15) / 16 * 16;
  for (int lc = 64; lc >= 16; lc /= 2)
    for (const int pad : {8, 0}) {
      const int c = dp / lc;
      if (dp % lc != 0 || c < 2 || c > kClusterMax) continue;
      const ClusterPlan p = {c, lc, dp, pad};
      if (cluster_layout<T>(phys, wdim, p).total <= kSmemLimit) return p;
    }
  return none;
}

// t2 = M t at every (i, l) of this CTA's columns (lc = 1 << lsh).  t[e, w]
// sits in slot w*d + e, t2[v, p] lands in slot v*d + p; MQ >= d*W
template <typename T, int MQ>
__device__ __forceinline__ void cluster_mix(float* blk, const Mix& mix, int phys, int wdim,
                                            int dp, int lsh, int ld) {
  const int nq = phys * wdim, slot = dp * ld;
  int qoff[MQ];  // t[q]'s slot, q = e*W + w
#pragma unroll
  for (int q = 0; q < MQ; ++q) qoff[q] = q < nq ? ((q % wdim) * phys + q / wdim) * slot : 0;
  for (int p = threadIdx.x; p < dp << lsh; p += kThreads) {
    const int off = (p >> lsh) * ld + (p & ((1 << lsh) - 1));
    float in[MQ];
#pragma unroll
    for (int q = 0; q < MQ; ++q) in[q] = q < nq ? blk[qoff[q] + off] : 0.f;
#pragma unroll
    for (int o = 0; o < MQ; ++o) {
      if (o >= nq) break;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < MQ; ++q) s = fmaf(mix.m[o * kMaxMix + q], in[q], s);
      blk[o * slot + off] = as_operand<T>(s);
    }
  }
}

// Stage this CTA's column slice of a core (`rows` rows of dp elements, src
// at the slice's first column, lc columns) into rows of length ld, one
// cp.async.bulk per row; completion on `bar`, armed by thread 0 (see
// stage_core)
template <typename T>
__device__ __forceinline__ void stage_slice(T* dst, const T* src, int rows, int dp, int lc, int ld,
                                            uint64_t* bar) {
  const uint32_t row_bytes = lc * sizeof(T);
  if (threadIdx.x == 0) mbar_expect_tx(bar, row_bytes * rows);
  for (int r = threadIdx.x; r < rows; r += kThreads)
    bulk_copy(dst + r * ld, src + (size_t)r * dp, row_bytes, bar);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mpo_env_cluster_kernel(const T* __restrict__ cores, const float* __restrict__ env0,
                       const __grid_constant__ Mix mix, float* __restrict__ env_out,
                       float* __restrict__ log_out, int n_sites, int phys, int bond, int wdim,
                       ClusterPlan plan, float count, float thr) {
  using Op = Tc<T>;
  constexpr int KS = Op::kK;
  const int rank = cluster_rank(), csize = plan.csize;
  const int b = cluster_id();
  const int dp = plan.dp, lc = plan.lc;
  const ClusterLayout L = cluster_layout<T>(phys, wdim, plan);
  const int ld = L.ld;

  extern __shared__ __align__(16) unsigned char smem[];
  float* blk = reinterpret_cast<float*>(smem);  // d*W slots of (dp, ld)
  T* cs = reinterpret_cast<T*>(smem + L.core);  // core slice (d*dp, ld)
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int mt = dp / 16;                            // 16-row tiles of the bond
  const int nn = lc / 8;                             // n8 tiles of this CTA's columns
  const int ec = nn >= kItemTiles ? 1 : kItemTiles / nn;  // e's a ket item holds
  const int nec = (phys + ec - 1) / ec;
  const int n_ket = wdim * mt * nec;                 // ket items, w-major
  const int vg = max(1, kItemTiles / nn);            // v's a bra item holds
  const int lsh = __ffs(lc) - 1;                     // lc = 1 << lsh
  const int eslot = phys - 1;                        // E_x in slot x*d + eslot

  zero_shared(reinterpret_cast<float*>(smem), L.total / 4);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  for (int x = 0; x < wdim; ++x)
    for (int p = threadIdx.x; p < dp << lsh; p += kThreads) {
      const int i = p >> lsh, l = p & (lc - 1);
      blk[((x * phys + eslot) * dp + i) * ld + l] = env0[(x * dp + i) * dp + rank * lc + l];
    }
  __syncthreads();

  auto fetch = [&](int n) {
    if (n < n_sites)
      stage_slice(cs, cores + ((size_t)b * n_sites + n) * phys * dp * dp + rank * lc,
                  phys * dp, dp, lc, ld, bar);
  };
  fetch(0);
  float log_acc = 0.f;

  for (int n = 0; n < n_sites; ++n) {
    mbar_wait(bar, n & 1);
    cluster_sync();  // S1: every CTA's core slice landed, every E final

    // 1. ket GEMMs in rounds of one item a warp
    for (int base = 0; base < n_ket; base += kWarps) {
      const int item = base + warp;
      const bool active = item < n_ket;
      const int w = item / (mt * nec), rem = item - w * mt * nec;
      const int mi = rem / nec, e0 = (rem - mi * nec) * ec;
      const int ntile = active ? min(ec, phys - e0) * nn : 0;
      float acc[kItemTiles][4];
      int boff[kItemTiles];  // B tile j: core block e0 + j / nn, columns (j % nn) * 8
#pragma unroll
      for (int j = 0; j < kItemTiles; ++j) {
        boff[j] = (e0 + j / nn) * dp * ld + (j % nn) * 8;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      }
      // the k in peer r's columns: E_w's rows mi there (ep) times the core
      // slice's rows r*lc ..; a separate copy for the CTA's own columns
      // keeps its reads on plain shared loads
      auto panel = [&](const float* ep, int r) {
#pragma unroll 2
        for (int kk = 0; kk < lc; kk += KS) {
          typename Op::AFrag af;  // bf16: packing E rounds it, the Pallas cast
          Op::load_a(af, [&](int rr, int c) { return ep[rr * ld + kk + c]; }, g, t);
          const int k0 = (r * lc + kk) * ld;
#pragma unroll
          for (int j = 0; j < kItemTiles; ++j) {
            if (j < ntile) {
              typename Op::BFrag bf;
              Op::load_b(bf, [&](int rr, int c) { return cs[boff[j] + k0 + rr * ld + c]; }, g,
                         t);
              Op::mma(acc[j], af, bf);
            }
          }
        }
      };
      if (active) {
        const float* own = blk + ((w * phys + eslot) * dp + mi * 16) * ld;  // E_w, rows mi
        panel(own, rank);
        for (int s = 1; s < csize; ++s) {
          const int r = (rank + s) % csize;
          panel(map_rank(own, r), r);
        }
      }
      cluster_sync();  // every CTA has read the E rows this round writes over
#pragma unroll
      for (int j = 0; j < kItemTiles; ++j) {
        if (j < ntile) {
          const int slot = w * phys + e0 + j / nn, col = (j % nn) * 8 + 2 * t;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            blk[(slot * dp + mi * 16 + g + 8 * (c >> 1)) * ld + col + (c & 1)] = acc[j][c];
        }
      }
    }
    __syncthreads();

    // 2. channel mix, in place
    if (phys * wdim <= 8)
      cluster_mix<T, 8>(blk, mix, phys, wdim, dp, lsh, ld);
    else
      cluster_mix<T, kMaxMix>(blk, mix, phys, wdim, dp, lsh, ld);
    __syncthreads();

    // 3. bra GEMMs: warp -> (16-row tile mj of j, group of at most vg v's
    // from vb), one A fragment (the core's columns, the same for every v)
    // feeding the group's tiles; a round's v's split evenly over its
    // kWarps / mt groups
    float part = 0.f;
    const int groups = kWarps / mt;
    for (int v0 = 0, vr; v0 < wdim; v0 += vr) {
      vr = min(groups * vg, wdim - v0);  // v's of this round
      const int per = (vr + groups - 1) / groups;
      const int mj = warp % mt, vb = v0 + (warp / mt) * per;
      const int ntile = warp < groups * mt && vb < v0 + vr ? min(per, v0 + vr - vb) * nn : 0;
      float keep[kItemTiles][4];
      int toff[kItemTiles];  // B tile j: t2[vb + j / nn, p], columns (j % nn) * 8
#pragma unroll
      for (int j = 0; j < kItemTiles; ++j) {
        toff[j] = (vb + j / nn) * phys * dp * ld + (j % nn) * 8;
#pragma unroll
        for (int c = 0; c < 4; ++c) keep[j][c] = 0.f;
      }
      // A^T from ap, the core's columns mj*16 .. in the CTA rj that holds
      // them; a separate copy for the CTA's own columns (plain shared loads)
      auto bra = [&](const T* ap) {
        for (int p = 0; p < phys; ++p) {
          const float* tb = blk + p * dp * ld;  // t2[., p], rows i
          const T* A = ap + p * dp * ld;        // A^T: row j, column i
#pragma unroll 2
          for (int ks = 0; ks < dp; ks += KS) {
            typename Op::AFrag af;
            Op::load_a(af, [&](int row, int c) { return A[(ks + c) * ld + row]; }, g, t);
#pragma unroll
            for (int j = 0; j < kItemTiles; ++j) {
              if (j < ntile) {
                typename Op::BFrag bf;
                Op::load_b(bf, [&](int row, int c) { return tb[toff[j] + (ks + row) * ld + c]; },
                           g, t);
                Op::mma(keep[j], af, bf);
              }
            }
          }
        }
      };
      if (ntile > 0) {
        const int rj = (mj * 16) >> lsh;
        const T* own = cs + (mj * 16 - rj * lc);
        if (rj == rank)
          bra(own);
        else
          bra(map_rank(own, rj));
      }
      __syncthreads();  // every read of this round's t2 done
#pragma unroll
      for (int j = 0; j < kItemTiles; ++j) {
        if (j < ntile) {
          float* ob = blk + ((vb + j / nn) * phys + eslot) * dp * ld;
          const int col = (j % nn) * 8 + 2 * t;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ob[(mj * 16 + g + 8 * (c >> 1)) * ld + col + (c & 1)] = keep[j][c];
            part += fabsf(keep[j][c]);
          }
        }
      }
    }

    // 4. rescale the whole environment by its mean |.| over the cluster
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += red_s[i];
      red_s[kWarps] = s;
    }
    cluster_sync();  // S2: every partial written; every read of this site's cores and E done
    fetch(n + 1);
    float total = 0.f;
    for (int r = 0; r < csize; ++r)
      total += r == rank ? red_s[kWarps] : *map_rank(red_s + kWarps, r);
    const float norm = __fdiv_rn(total, count);
    const float safe = norm > thr ? norm : 1.f;
    const float inv = __fdiv_rn(1.f, safe);
    log_acc += logf(safe);
    const bool last = n == n_sites - 1;
    float* out = env_out + (size_t)b * wdim * bond * bond;
    for (int x = 0; x < wdim; ++x)
      for (int p = threadIdx.x; p < dp << lsh; p += kThreads) {
        const int i = p >> lsh, l = p & (lc - 1);
        float* slot = blk + ((x * phys + eslot) * dp + i) * ld + l;
        const float val = *slot * inv;
        if (!last)
          *slot = val;
        else if (i < bond && rank * lc + l < bond)
          out[(x * bond + i) * bond + rank * lc + l] = val;
      }
    __syncthreads();
  }
  if (threadIdx.x == 0 && rank == 0) log_out[b] = log_acc;
  cluster_sync();  // no CTA leaves while a peer may still read its shared memory
}

// ------------------------------------------------------------ streamed path

using Gemm = TileGemm<float, 2>;  // the tile's constants, the same for either T
constexpr int kGemmThreads = Gemm::kThreads;  // 4 warps, 2 x 2 over a tile, 32 x 32 each
constexpr int kTileM = Gemm::kM, kTileN = Gemm::kN;
constexpr int kMixThreads = 256;
constexpr int kMixOut = 16;  // outputs a thread keeps in registers
constexpr int kMixPos = 4;   // positions (i, l) a thread serves

template <typename T>
__host__ __device__ constexpr int gemm_smem() {
  return TileGemm<T, 2>::kSmemBytes + kGemmThreads / 32 * 4;
}

// One batched GEMM C[z] = A[z] B[z] (C fp32), z = zh * nlo + zl, each
// operand offset by zh and zl times its own strides (elements)
struct GemmArgs {
  const void* a;  // A(m, k) = a[m*lda + k], or a[k*lda + m] when read transposed
  const void* b;  // B(k, n) = b[k*ldb + n], of the core type
  float* c;       // C(m, n) = c[m*ldc + n]
  long long a_hi, a_lo, b_hi, b_lo, c_hi, c_lo;
  int nlo, m, n, k, lda, ldb, ldc, tiles_m, tiles_n;
  const float* scale;  // A's fp32 multiplier per zh before the cast (null: none)
  float* part;         // sum |C| over each tile at part[z * tiles + tile] (null: none)
};

// CTA (z, tile): a 64 x 64 tile of C[z] on TileGemm's loop (tc_common.cuh),
// A scaled and cast to T as it is loaded; out-of-range rows, columns and k
// load as zero and store nothing.
template <typename T, typename TA, bool kAT>
__global__ void __launch_bounds__(kGemmThreads)
streamed_gemm_kernel(const __grid_constant__ GemmArgs g) {
  using G = TileGemm<T, 2>;
  __shared__ typename G::Smem sm;
  __shared__ float red_s[kGemmThreads / 32];

  const int tiles = g.tiles_m * g.tiles_n;
  const long long z = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - z * tiles);
  const int m0 = (tile / g.tiles_n) * kTileM, n0 = (tile % g.tiles_n) * kTileN;
  const long long zh = z / g.nlo, zl = z - zh * g.nlo;
  const TA* A = static_cast<const TA*>(g.a) + zh * g.a_hi + zl * g.a_lo;
  const T* B = static_cast<const T*>(g.b) + zh * g.b_hi + zl * g.b_lo;
  const float sc = g.scale ? g.scale[zh] : 1.f;

  auto fetch_a = [&](int s, int mi, int ki) {
    const int m = m0 + mi, k = s * G::kK + ki;
    float v = 0.f;
    if (m < g.m && k < g.k)
      v = to_float(A[kAT ? (long long)k * g.lda + m : (long long)m * g.lda + k]);
    return from_float<T>(g.scale ? __fmul_rn(v, sc) : v);
  };
  auto put_a = [](T v, int) { return v; };
  auto fetch_b = [&](int s, int kb, int nb) {
    const int k = s * G::kK + kb, n = n0 + nb;
    return k < g.k && n < g.n ? B[(long long)k * g.ldb + n] : from_float<T>(0.f);
  };
  float acc[G::kMI][4][4] = {};
  G::template run<kAT, false, T>(sm, (g.k + G::kK - 1) / G::kK, fetch_a, put_a, fetch_b, acc, acc,
                                 [](int) {});

  float* C = g.c + zh * g.c_hi + zl * g.c_lo;
  float part = 0.f;
#pragma unroll
  for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + G::row(mi, c), col = n0 + G::col(ni, c);
        if (row < g.m && col < g.n) {
          C[(long long)row * g.ldc + col] = acc[mi][ni][c];
          part += fabsf(acc[mi][ni][c]);
        }
      }
  if (g.part) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane_id() == 0) red_s[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kGemmThreads / 32; ++w) s += red_s[w];
      g.part[z * tiles + tile] = s;
    }
  }
}

// t2[b, o] = sum_q M[o][q] t[b, q] at each position of a (dd)-element
// block, q ascending; nq = d*W blocks a sample in and out
template <typename T>
__global__ void __launch_bounds__(kMixThreads)
streamed_mix_kernel(const float* __restrict__ t, T* __restrict__ t2, const float* __restrict__ mix,
                    int nq, long long dd, int chunks) {
  const long long b = blockIdx.x / chunks;
  const long long p0 = (blockIdx.x - b * chunks) * (long long)(kMixThreads * kMixPos) + threadIdx.x;
  const float* tb = t + b * nq * dd;
  T* ob = t2 + b * nq * dd;
  for (int o0 = 0; o0 < nq; o0 += kMixOut) {
    float acc[kMixOut][kMixPos] = {};
    for (int q = 0; q < nq; ++q) {
      float x[kMixPos];
#pragma unroll
      for (int r = 0; r < kMixPos; ++r) {
        const long long p = p0 + r * kMixThreads;
        x[r] = p < dd ? tb[q * dd + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMixOut; ++j) {
        if (o0 + j < nq) {
          const float m = __ldg(mix + (long long)(o0 + j) * nq + q);
          if (m != 0.f) {  // the same for the whole warp; a zero entry adds nothing
#pragma unroll
            for (int r = 0; r < kMixPos; ++r) acc[j][r] = fmaf(m, x[r], acc[j][r]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMixOut; ++j) {
      if (o0 + j < nq) {
#pragma unroll
        for (int r = 0; r < kMixPos; ++r) {
          const long long p = p0 + r * kMixThreads;
          if (p < dd) ob[(o0 + j) * dd + p] = from_float<T>(acc[j][r]);
        }
      }
    }
  }
}

// Per sample: its np tile sums added in order, the guarded mean, 1/safe and
// the log
__global__ void streamed_norm_kernel(const float* __restrict__ part, int np, int batch,
                                     float count, float thr, float* __restrict__ inv,
                                     float* __restrict__ log_out, int first) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const float* p = part + (long long)b * np;
  float total = 0.f;
  for (int i = 0; i < np; ++i) total += p[i];
  const float norm = __fdiv_rn(total, count);
  const float safe = norm > thr ? norm : 1.f;
  inv[b] = __fdiv_rn(1.f, safe);
  log_out[b] = (first ? 0.f : log_out[b]) + logf(safe);
}

// env[b, :] *= inv[b] over `per` elements a sample
__global__ void streamed_scale_kernel(float* __restrict__ env, const float* __restrict__ inv,
                                      long long per, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    env[i] = __fmul_rn(env[i], inv[i / per]);
}

__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The workspace: t (B, d*W, D, D) fp32, t2 (B, W*d, D, D) of the core type,
// the bra's tile sums (B, W * tiles) and inv (B), each 256-byte aligned
struct StreamedLayout {
  long long t, t2, part, inv, total;  // byte offsets, total bytes
  int tiles;                          // bra tiles of one (b, v): ceil(D / 64)^2
};

template <typename T>
StreamedLayout streamed_layout(int phys, int bond, int wdim, int batch) {
  auto up = [](long long x) { return cdiv(x, 256) * 256; };
  const long long blocks = (long long)batch * phys * wdim * bond * bond;
  StreamedLayout L;
  L.tiles = (int)(cdiv(bond, kTileM) * cdiv(bond, kTileN));
  L.t = 0;
  L.t2 = up(blocks * 4);
  L.part = L.t2 + up(blocks * (long long)sizeof(T));
  L.inv = L.part + up((long long)batch * wdim * L.tiles * 4);
  L.total = L.inv + up((long long)batch * 4);
  return L;
}

template <typename T, typename TA, bool kAT>
cudaError_t launch_gemm(const GemmArgs& g, long long nz, cudaStream_t stream) {
  const long long blocks = nz * g.tiles_m * g.tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  streamed_gemm_kernel<T, TA, kAT><<<(unsigned)blocks, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// All sites of every sample; cores (B, N, d, D, D) at the unpadded bond,
// env0 (W*D, D), mix (d*W, d*W) fp32 on the device, work of
// streamed_layout's bytes
template <typename T>
int launch_streamed(const void* cores, const float* env0, const float* mix, void* work,
                    float* env_out, float* log_out, int batch, int n_sites, int phys, int bond,
                    int wdim, float count, float thr, cudaStream_t stream) {
  if (batch < 1 || n_sites < 1 || phys < 1 || bond < 1 || wdim < 1 || !mix || !work)
    return (int)cudaErrorInvalidValue;
  const StreamedLayout L = streamed_layout<T>(phys, bond, wdim, batch);
  char* ws = static_cast<char*>(work);
  float* t = reinterpret_cast<float*>(ws + L.t);
  T* t2 = reinterpret_cast<T*>(ws + L.t2);
  float* part = reinterpret_cast<float*>(ws + L.part);
  float* inv = reinterpret_cast<float*>(ws + L.inv);
  const long long dd = (long long)bond * bond, site = phys * dd, env = wdim * dd;
  const int nq = phys * wdim;
  const int tn = (int)cdiv(bond, kTileN);

  // ket: z = (b, e); M = W*D rows (w, i) of E, N = D, K = D
  GemmArgs ket = {};
  ket.a_lo = 0;
  ket.b_hi = n_sites * site;
  ket.b_lo = dd;
  ket.c = t;
  ket.c_hi = phys * env;
  ket.c_lo = env;
  ket.nlo = phys;
  ket.m = wdim * bond;
  ket.n = ket.k = ket.lda = ket.ldb = ket.ldc = bond;
  ket.tiles_m = (int)cdiv(ket.m, kTileM);
  ket.tiles_n = tn;
  // bra: z = (b, v); A^T the core (rows (p, i), column j), B = t2[b, v]
  GemmArgs bra = {};
  bra.a_hi = n_sites * site;
  bra.a_lo = 0;
  bra.b = t2;
  bra.b_hi = wdim * site;
  bra.b_lo = site;
  bra.c = env_out;
  bra.c_hi = env;
  bra.c_lo = dd;
  bra.nlo = wdim;
  bra.m = bra.n = bra.lda = bra.ldb = bra.ldc = bond;
  bra.k = phys * bond;
  bra.tiles_m = bra.tiles_n = tn;
  bra.part = part;

  const int chunks = (int)cdiv(dd, kMixThreads * kMixPos);
  const long long mix_blocks = (long long)batch * chunks;
  if (mix_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const T* c = static_cast<const T*>(cores);
  for (int n = 0; n < n_sites; ++n) {
    ket.a = n ? static_cast<const void*>(env_out) : env0;
    ket.a_hi = n ? env : 0;
    ket.scale = n ? inv : nullptr;
    ket.b = c + n * site;
    cudaError_t err = launch_gemm<T, float, false>(ket, (long long)batch * phys, stream);
    if (err != cudaSuccess) return (int)err;
    streamed_mix_kernel<T><<<(unsigned)mix_blocks, kMixThreads, 0, stream>>>(t, t2, mix, nq, dd,
                                                                              chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bra.a = c + n * site;
    if ((err = launch_gemm<T, T, true>(bra, (long long)batch * wdim, stream)) != cudaSuccess)
      return (int)err;
    streamed_norm_kernel<<<(unsigned)cdiv(batch, 128), 128, 0, stream>>>(
        part, wdim * L.tiles, batch, count, thr, inv, log_out, n == 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long total = batch * env;
  const long long scale_blocks = cdiv(total, 256);
  streamed_scale_kernel<<<(unsigned)(scale_blocks < 4096 ? scale_blocks : 4096), 256, 0, stream>>>(
      env_out, inv, env, total);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ launches

template <typename T, int DP, int NW, int NB>
int launch(const void* cores, const float* env0, const Mix& mix, float* env_out, float* log_out,
           int batch, int n_sites, int phys, int bond, int wdim, float count, float thr,
           cudaStream_t stream) {
  const Plan plan = plan_for<T>(phys, DP, wdim);
  if (plan.nbuf == 0) return (int)cudaErrorInvalidValue;
  const int smem = make_layout<T>(phys, DP, wdim, plan).total;
  auto kernel = mpo_env_kernel<T, DP, NW, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, stream>>>(static_cast<const T*>(cores), env0, mix, env_out,
                                            log_out, n_sites, phys, bond, wdim, plan, count, thr);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tc(const void* cores, const float* env0, const Mix& mix, float* env_out,
             float* log_out, int batch, int n_sites, int phys, int bond, int wdim, float count,
             float thr, cudaStream_t stream) {
  Config c;
  if (phys * wdim > kMaxMix || (bond * (int)sizeof(T)) % 16 != 0 || !config_for(bond, wdim, c))
    return (int)cudaErrorInvalidValue;
#define CN_LAUNCH(DP, NW, NB)                                                                 \
  if (c.dp == DP && c.nw == NW && c.nb == NB)                                                 \
  return launch<T, DP, NW, NB>(cores, env0, mix, env_out, log_out, batch, n_sites, phys, bond, \
                               wdim, count, thr, stream)
  CN_LAUNCH(32, 4, 1);
  CN_LAUNCH(32, 4, 4);
  CN_LAUNCH(64, 2, 2);
  CN_LAUNCH(64, 3, 3);
  CN_LAUNCH(64, 4, 4);
  CN_LAUNCH(64, 3, 8);
  CN_LAUNCH(64, 4, 8);
#undef CN_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_cluster(const void* cores, const float* env0, const Mix& mix, float* env_out,
                   float* log_out, int batch, int n_sites, int phys, int bond, int wdim,
                   float count, float thr, cudaStream_t stream) {
  const ClusterPlan plan = cluster_plan_for<T>(phys, bond, wdim);
  if (plan.csize == 0 || plan.dp != bond) return (int)cudaErrorInvalidValue;
  const int smem = cluster_layout<T>(phys, wdim, plan).total;
  auto kernel = mpo_env_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * plan.csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster the card cannot place is refused here, not at the launch
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(cores), env0, mix, env_out,
                           log_out, n_sites, phys, bond, wdim, plan, count, thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The path for a shape, decided before any launch: the one-CTA tensor-core
// path wherever one of its plans fits, else the cluster path where it
// fits, else the streamed path; out of reach only for d, D or W < 1
constexpr int kOutOfReach = 0, kTensorCore = 1, kCluster = 2, kStreamed = 3;

template <typename T>
int path_for(int phys, int bond, int wdim) {
  if (phys < 1 || wdim < 1 || bond < 1) return kOutOfReach;
  if (phys * wdim > kMaxMix) return kStreamed;
  Config c;
  if (bond <= 64 && config_for(bond, wdim, c) && plan_for<T>(phys, c.dp, wdim).nbuf > 0)
    return kTensorCore;
  return cluster_plan_for<T>(phys, bond, wdim).csize > 0 ? kCluster : kStreamed;
}

template <typename T>
int dispatch(const void* cores, const float* env0, const float* mix_host, const float* mix_dev,
             void* work, float* env_out, float* log_out, int batch, int n_sites, int phys,
             int bond, int wdim, float count, float thr, cudaStream_t stream) {
  const int path = path_for<T>(phys, bond, wdim);
  if (path == kStreamed)
    return launch_streamed<T>(cores, env0, mix_dev, work, env_out, log_out, batch, n_sites, phys,
                              bond, wdim, count, thr, stream);
  if (path == kOutOfReach) return (int)cudaErrorInvalidValue;
  // the on-chip paths take the mix by value, zero-padded to 16 x 16
  const int nq = phys * wdim;
  Mix mix = {};
  for (int o = 0; o < nq; ++o)
    for (int q = 0; q < nq; ++q) mix.m[o * kMaxMix + q] = mix_host[o * nq + q];
  if (path == kTensorCore)
    return dispatch_tc<T>(cores, env0, mix, env_out, log_out, batch, n_sites, phys, bond, wdim,
                          count, thr, stream);
  return launch_cluster<T>(cores, env0, mix, env_out, log_out, batch, n_sites, phys, bond, wdim,
                           count, thr, stream);
}

}  // namespace

extern "C" {

// cores (B, N, d, D, D) fp32 or bf16, zero-padded by the wrapper to the
// layout of the path cn_mpo_env_path names (padding keeps the path): on the
// tensor-core path D * sizeof(T) a multiple of 16, on the cluster path D
// the cluster's padded bond, on the streamed path D itself
// (cn_mpo_env_bond); env0 (W*D, D) fp32 on the device, padded alike;
// mix_host (d*W, d*W) fp32 in host memory, M[v*d+p][e*W+w]; on the
// streamed path also mix_dev, the same matrix on the device, and work, a
// device workspace of cn_mpo_env_workspace bytes (both may be null on the
// other paths); `count` the unpadded W*D*D (the divisor of the mean).
// Writes env_out (B, W*D, D) fp32 and log_out (B,) fp32.
int cn_mpo_env(const void* cores, int cores_bf16, const float* env0, const float* mix_host,
               const float* mix_dev, void* work, float* env_out, float* log_out, int batch,
               int n_sites, int phys, int bond, int wdim, float count, float thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cores_bf16)
    return dispatch<__nv_bfloat16>(cores, env0, mix_host, mix_dev, work, env_out, log_out, batch,
                                   n_sites, phys, bond, wdim, count, thr, s);
  return dispatch<float>(cores, env0, mix_host, mix_dev, work, env_out, log_out, batch, n_sites,
                         phys, bond, wdim, count, thr, s);
}

// The streamed path's launcher, which cn_mpo_env calls for the shapes it
// assigns there; exported so that the path can be timed at any valid shape
// (ops/cuda_mpo.py mpo_env_streamed).  Operands as for cn_mpo_env on the
// streamed path, at the unpadded bond.
int cn_mpo_env_streamed(const void* cores, int cores_bf16, const float* env0, const float* mix_dev,
                        void* work, float* env_out, float* log_out, int batch, int n_sites,
                        int phys, int bond, int wdim, float count, float thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cores_bf16)
    return launch_streamed<__nv_bfloat16>(cores, env0, mix_dev, work, env_out, log_out, batch,
                                          n_sites, phys, bond, wdim, count, thr, s);
  return launch_streamed<float>(cores, env0, mix_dev, work, env_out, log_out, batch, n_sites, phys,
                                bond, wdim, count, thr, s);
}

// Bytes of device workspace the streamed path needs for `batch` samples,
// written to *bytes (0 on the other paths); returns 0, or
// cudaErrorInvalidValue for d, D, W or B < 1.
int cn_mpo_env_workspace(int cores_bf16, int phys, int bond, int wdim, int batch,
                         long long* bytes) {
  *bytes = 0;
  if (phys < 1 || bond < 1 || wdim < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  *bytes = cores_bf16 ? streamed_layout<__nv_bfloat16>(phys, bond, wdim, batch).total
                      : streamed_layout<float>(phys, bond, wdim, batch).total;
  return 0;
}

// The path cn_mpo_env takes for these operands: 1 the one-CTA tensor-core
// kernel, 2 the cluster kernel, 3 the streamed kernels, 0 for d, D or W < 1.
int cn_mpo_env_path(int cores_bf16, int phys, int bond, int wdim) {
  return cores_bf16 ? path_for<__nv_bfloat16>(phys, bond, wdim) : path_for<float>(phys, bond, wdim);
}

// The bond the cores and env0 are laid out at: the cluster's padded bond
// (a multiple of 16, at least 32) on the cluster path, the bond itself on
// the streamed path, -1 on the tensor-core path (the wrapper rounds a row
// up to 16 bytes itself) and outside the kernel's reach.
int cn_mpo_env_bond(int cores_bf16, int phys, int bond, int wdim) {
  const int path = cn_mpo_env_path(cores_bf16, phys, bond, wdim);
  if (path == kStreamed) return bond;
  if (path != kCluster) return -1;
  return cores_bf16 ? cluster_plan_for<__nv_bfloat16>(phys, bond, wdim).dp
                    : cluster_plan_for<float>(phys, bond, wdim).dp;
}

// CTAs that work on one sample on that path: 1 on the tensor-core path,
// the cluster's size on the cluster path, on the streamed path the CTAs of
// one sample's ket GEMMs at a site (d * ceil(W*D/64) * ceil(D/64); its mix
// and bra launches split the sample otherwise), 0 outside the kernel's
// reach.
int cn_mpo_env_cluster(int cores_bf16, int phys, int bond, int wdim) {
  const int path = cn_mpo_env_path(cores_bf16, phys, bond, wdim);
  if (path == kTensorCore) return 1;
  if (path == kOutOfReach) return 0;
  if (path == kStreamed)
    return (int)(phys * cdiv((long long)wdim * bond, kTileM) * cdiv(bond, kTileN));
  return cores_bf16 ? cluster_plan_for<__nv_bfloat16>(phys, bond, wdim).csize
                    : cluster_plan_for<float>(phys, bond, wdim).csize;
}

// Shared memory of one CTA on that path (bytes: dynamic on the on-chip
// paths, the GEMM kernel's static tiles on the streamed path), or -1
// outside the kernel's reach.
int cn_mpo_env_smem(int cores_bf16, int phys, int bond, int wdim) {
  const int path = cn_mpo_env_path(cores_bf16, phys, bond, wdim);
  if (path == kOutOfReach) return -1;
  if (path == kStreamed) return cores_bf16 ? gemm_smem<__nv_bfloat16>() : gemm_smem<float>();
  if (path == kCluster)
    return cores_bf16 ? cluster_layout<__nv_bfloat16>(
                            phys, wdim, cluster_plan_for<__nv_bfloat16>(phys, bond, wdim)).total
                      : cluster_layout<float>(phys, wdim, cluster_plan_for<float>(phys, bond, wdim))
                            .total;
  Config c;
  config_for(bond, wdim, c);
  return cores_bf16 ? make_layout<__nv_bfloat16>(phys, c.dp, wdim,
                                                 plan_for<__nv_bfloat16>(phys, c.dp, wdim)).total
                    : make_layout<float>(phys, c.dp, wdim, plan_for<float>(phys, c.dp, wdim)).total;
}

}  // extern "C"
