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
// Exact-D path (mpo_env_exact_kernel), for the shapes the tensor-core tiers
// do not hold: 33 <= D <= 64 where d*W ket blocks padded to 64 rows do not
// fit beside E and a core buffer (for example d = 2 with W = 6..8, d = 1
// with W = 9..16), up to D = 62 or so.  It holds every operand at exactly D,
// fp32, on the FMA units (67 TFLOP/s, not the tensor cores): E (W*D, D+1),
// t (d*W, D, D), the core (d, D, D) read synchronously each site; a 16 x 16
// thread grid, each thread a 4 x 4 tile of every D x D product (D <= 64);
// the same four steps, casts, mix and rescale as above.  One C function
// (path_for, exported as cn_mpo_env_path) picks the path from the shape
// before the launch: the tensor-core path wherever a plan of it fits, the
// exact-D path where only it fits, neither beyond.  A failed launch of one
// path is never retried on the other.

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

// ------------------------------------------------------------ exact-D path

constexpr int kExactThreads = 256;
constexpr int kExactTX = 16;  // a 16 x 16 thread grid
constexpr int kExactCT = 4;   // each thread's 4 x 4 tile of a D x D product (D <= 64)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Shared memory of the exact-D path (bytes): E (W*D, D+1), t (d*W, D, D),
// the core (d, D, D) in fp32 and one partial a warp
int exact_smem(int phys, int bond, int wdim) {
  return 4 * (wdim * bond * (bond + 1) + (phys * wdim + phys) * bond * bond + kExactThreads / 32);
}

template <typename T>
__global__ void __launch_bounds__(kExactThreads)
mpo_env_exact_kernel(const T* __restrict__ cores, const float* __restrict__ env0,
                     const __grid_constant__ Mix mix, float* __restrict__ env_out,
                     float* __restrict__ log_out, int n_sites, int phys, int bond, int wdim,
                     float count, float thr) {
  constexpr int CT = kExactCT, TX = kExactTX;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dd = bond * bond, es = bond + 1, nq = phys * wdim;
  float* e_s = reinterpret_cast<float*>(smem);  // E (W*D, D+1)
  float* t_s = e_s + wdim * bond * es;           // t (d*W, D, D)
  float* a_s = t_s + nq * dd;                    // this site's core (d, D, D)
  float* red_s = a_s + phys * dd;                // one partial a warp

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T* sample = cores + (size_t)blockIdx.x * n_sites * phys * dd;
  for (int e = threadIdx.x; e < wdim * dd; e += kExactThreads)
    e_s[(e / bond) * es + e % bond] = env0[e];
  float log_acc = 0.f;

  for (int n = 0; n < n_sites; ++n) {
    const T* core = sample + (size_t)n * phys * dd;
    for (int e = threadIdx.x; e < phys * dd; e += kExactThreads) a_s[e] = load_f32(core + e);
    __syncthreads();  // the core landed; E holds the rescaled environment

    // 1. ket GEMMs  t[e*W + w] = E_w A_e, E cast to the core type
    for (int w = 0; w < wdim; ++w) {
      const float* ew = e_s + w * bond * es;
      for (int e = 0; e < phys; ++e) {
        const float* ae = a_s + e * dd;
        float acc[CT][CT] = {};
        for (int k = 0; k < bond; ++k) {
          float ev[CT], av[CT];
#pragma unroll
          for (int a = 0; a < CT; ++a) {
            const int i = ty + TX * a;
            ev[a] = i < bond ? as_operand<T>(ew[i * es + k]) : 0.f;
          }
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const int l = tx + TX * c;
            av[c] = l < bond ? ae[k * bond + l] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < CT; ++a)
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[a][c] = fmaf(ev[a], av[c], acc[a][c]);
        }
        float* tq = t_s + (e * wdim + w) * dd;
#pragma unroll
        for (int a = 0; a < CT; ++a)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const int i = ty + TX * a, l = tx + TX * c;
            if (i < bond && l < bond) tq[i * bond + l] = acc[a][c];
          }
      }
    }
    __syncthreads();

    // 2. channel mix in place, t2[v*d + p] = sum_q M[v*d + p][q] t[q] cast to
    // the core type (entries past d*W are zero and add exact zeros)
    for (int p = threadIdx.x; p < dd; p += kExactThreads) {
      float in[kMaxMix];
#pragma unroll
      for (int q = 0; q < kMaxMix; ++q) in[q] = q < nq ? t_s[q * dd + p] : 0.f;
      for (int o = 0; o < nq; ++o) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxMix; ++q) s = fmaf(mix.m[o * kMaxMix + q], in[q], s);
        t_s[o * dd + p] = as_operand<T>(s);
      }
    }
    __syncthreads();

    // 3. bra GEMMs  out[v] = A^T t2[v], unscaled over E (last read in step 1)
    float part = 0.f;
    for (int v = 0; v < wdim; ++v) {
      const float* t2 = t_s + v * phys * dd;  // rows (p, i)
      float acc[CT][CT] = {};
      for (int q = 0; q < phys * bond; ++q) {
        float av[CT], tv[CT];
#pragma unroll
        for (int a = 0; a < CT; ++a) {
          const int j = ty + TX * a;
          av[a] = j < bond ? a_s[q * bond + j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int l = tx + TX * c;
          tv[c] = l < bond ? t2[q * bond + l] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < CT; ++a)
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[a][c] = fmaf(av[a], tv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < CT; ++a)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int j = ty + TX * a, l = tx + TX * c;
          if (j < bond && l < bond) {
            e_s[(v * bond + j) * es + l] = acc[a][c];
            part += fabsf(acc[a][c]);
          }
        }
    }

    // 4. rescale the whole environment by its mean |.|; each thread scales
    // the entries it wrote
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (threadIdx.x % 32 == 0) red_s[threadIdx.x / 32] = part;
    __syncthreads();  // partials written; every read of t and this core done
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kExactThreads / 32; ++w) total += red_s[w];
    const float norm = __fdiv_rn(total, count);
    const float safe = norm > thr ? norm : 1.f;
    const float inv = __fdiv_rn(1.f, safe);
    log_acc += logf(safe);
    for (int v = 0; v < wdim; ++v)
#pragma unroll
      for (int a = 0; a < CT; ++a)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int j = ty + TX * a, l = tx + TX * c;
          if (j < bond && l < bond) e_s[(v * bond + j) * es + l] *= inv;
        }
  }
  __syncthreads();
  float* out = env_out + (size_t)blockIdx.x * wdim * dd;
  for (int e = threadIdx.x; e < wdim * dd; e += kExactThreads)
    out[e] = e_s[(e / bond) * es + e % bond];
  if (threadIdx.x == 0) log_out[blockIdx.x] = log_acc;
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
int launch_exact(const void* cores, const float* env0, const Mix& mix, float* env_out,
                 float* log_out, int batch, int n_sites, int phys, int bond, int wdim, float count,
                 float thr, cudaStream_t stream) {
  const int smem = exact_smem(phys, bond, wdim);
  auto kernel = mpo_env_exact_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kExactThreads, smem, stream>>>(static_cast<const T*>(cores), env0, mix, env_out,
                                                 log_out, n_sites, phys, bond, wdim, count, thr);
  return (int)cudaGetLastError();
}

// The path for a shape, decided before any launch: the tensor-core path
// wherever one of its plans fits, else the exact-D path where it fits
constexpr int kOutOfReach = 0, kTensorCore = 1, kExactD = 2;

template <typename T>
int path_for(int phys, int bond, int wdim) {
  if (phys < 1 || wdim < 1 || bond < 1 || bond > 64 || phys * wdim > kMaxMix) return kOutOfReach;
  Config c;
  if (config_for(bond, wdim, c) && plan_for<T>(phys, c.dp, wdim).nbuf > 0) return kTensorCore;
  return exact_smem(phys, bond, wdim) <= kSmemLimit ? kExactD : kOutOfReach;
}

template <typename T>
int dispatch(const void* cores, const float* env0, const Mix& mix, float* env_out,
             float* log_out, int batch, int n_sites, int phys, int bond, int wdim, float count,
             float thr, cudaStream_t stream) {
  switch (path_for<T>(phys, bond, wdim)) {
    case kTensorCore:
      return dispatch_tc<T>(cores, env0, mix, env_out, log_out, batch, n_sites, phys, bond, wdim,
                            count, thr, stream);
    case kExactD:
      return launch_exact<T>(cores, env0, mix, env_out, log_out, batch, n_sites, phys, bond, wdim,
                             count, thr, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// cores (B, N, d, D, D) fp32 or bf16, on the tensor-core path with
// D * sizeof(T) a multiple of 16 (zero-padded by the wrapper), on the
// exact-D path as they are; the path is cn_mpo_env_path's for this D.
// env0 (W*D, D) fp32 on the device; mix
// (16, 16) fp32 in host memory, M[v*d+p][e*W+w] zero-padded; `count` the
// unpadded W*D*D (the divisor of the mean).  Writes env_out (B, W*D, D) fp32
// and log_out (B,) fp32.
int cn_mpo_env(const void* cores, int cores_bf16, const float* env0, const float* mix_host,
               float* env_out, float* log_out, int batch, int n_sites, int phys, int bond,
               int wdim, float count, float thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Mix mix;
  for (int i = 0; i < kMaxMix * kMaxMix; ++i) mix.m[i] = mix_host[i];
  if (cores_bf16)
    return dispatch<__nv_bfloat16>(cores, env0, mix, env_out, log_out, batch, n_sites, phys, bond,
                                   wdim, count, thr, s);
  return dispatch<float>(cores, env0, mix, env_out, log_out, batch, n_sites, phys, bond, wdim,
                         count, thr, s);
}

// The path cn_mpo_env takes for these operands: 1 the tensor-core kernel,
// 2 the exact-D kernel, 0 neither (D > 64, d*W > 16, or no layout of either
// that fits the per-block limit).
int cn_mpo_env_path(int cores_bf16, int phys, int bond, int wdim) {
  return cores_bf16 ? path_for<__nv_bfloat16>(phys, bond, wdim) : path_for<float>(phys, bond, wdim);
}

// Dynamic shared memory of one CTA on that path (bytes), or -1 outside
// the kernel's reach.
int cn_mpo_env_smem(int cores_bf16, int phys, int bond, int wdim) {
  const int path = cn_mpo_env_path(cores_bf16, phys, bond, wdim);
  if (path == kExactD) return exact_smem(phys, bond, wdim);
  if (path == kOutOfReach) return -1;
  Config c;
  config_for(bond, wdim, c);
  return cores_bf16 ? make_layout<__nv_bfloat16>(phys, c.dp, wdim,
                                                 plan_for<__nv_bfloat16>(phys, c.dp, wdim)).total
                    : make_layout<float>(phys, c.dp, wdim, plan_for<float>(phys, c.dp, wdim)).total;
}

}  // extern "C"
