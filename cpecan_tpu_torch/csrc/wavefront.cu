// Banded pair-HMM wavefront kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of cpecan_tpu/ops/fb_wavefront.py at all
// eight of their launch sites:
//   wavefront_fwd <- _fwd_kernel (fb_wavefront.py:235): fresh, phase 0,
//                    on the batch path (_fb_wavefront_jit,
//                    fb_wavefront.py:1059); with carries for the exact
//                    segmented engine's windows (fb_segmented.py:189) and
//                    the burn-in-parallel engine's (fb_parallel.py:259)
//   wavefront_bwd <- _bwd_kernel (fb_wavefront.py:404): batch
//                    (fb_wavefront.py:1256); with carries, segmented
//                    (fb_segmented.py:301) and parallel (fb_parallel.py:313)
//   wavefront_exp <- _exp_kernel (fb_wavefront.py:592): batch
//                    (fb_wavefront.py:1195); with the F halo and carries,
//                    segmented (fb_segmented.py:422)
// and computes what those bodies compute; the plain PyTorch versions
// (cpecan_tpu_torch/ops/fb_wavefront.py fwd_reference / bwd_reference /
// exp_reference) follow the same arithmetic and are the kernels' oracle.
//
// Layout (batch-major, all contiguous): streams (B, R, W) with R
// diagonals and W band slots; the forward intermediate F (B, R, S, W);
// row-constant shift selects (B, R) int8; pm (B, R, W) int8; F0 and
// end_row (B, S, W); mf / mb / total (B, R). A window of a long pair is
// a "pair" of R rows whose first row is global diagonal k0; the
// row-max rescale applies on diagonals with (k0 + row) % 4 == 3 (k0 = 0
// on the batch path). Its carries arrive through nullable pointers, one
// region per block: forward (F_{k0-1}, F_{k0-2}) (B, S, W) each and 1/m
// (B,); backward (B_{k1}, B_{k1+1}) (B, S, W) each, 1/mb (B,), em_{k1}
// and bridgevec_{k1} (B, W) each; the carries out of the window's last
// (forward) or first (backward) row leave through the same layout; exp's
// F halo, rows k0-2 and k0-1, is (B, 2, S, W). Null carry-in pointers
// give the batch path's start: F0 forward, zeros past the last diagonal
// backward. Each kernel is instantiated twice (kWindow), so the batch
// path runs code without any of the window arguments.
//
// Design: one thread block per pair, threads over the W band slots (each
// thread owns up to 4 slots, so W <= 4096). The diagonal loop runs inside
// the block; the carries that persist across grid steps in VMEM on the
// TPU live here in shared memory (F_{k-1}, F_{k-2}; B_{k+1}, B_{k+2},
// bridgevec_{k+1}) and registers (1/m, 1/mb, em_{k+1}). The neighbour
// shifts in {-1, 0, +1} are shared-memory reads of slot j +- 1 with zero
// fill outside [0, W), like the Pallas _shift_l/_shift_r. The row max
// (every 4th diagonal) and the per-diagonal dots are block reductions
// (warp shuffles, then one value per warp through shared memory). The
// transition contraction is unrolled at compile time over the statically
// nonzero transitions of the 5-state (13) or 3-state (9) structure;
// transition values arrive as a kernel argument.
//
// What bounds it on the card: per cell the forward writes S floats of F
// and the backward reads them back (S * W * 4 bytes per diagonal each
// way), on top of ~7 emission/mask streams; and each block walks a
// serial chain of R diagonals, whose latency per diagonal (device-memory
// rounds, barriers) is the time wherever too few blocks share an SM to
// hide it: the exact segmented engine runs one block per window, the
// parallel engine a few windows per launch, and the batch path ~2 blocks
// per SM. Every carry stays on chip, so F and the streams are the only
// device-memory traffic.
//
// wavefront_bwd is built for that chain. Per diagonal it has at most one
// device-memory latency round and two barriers:
//   - its launch picks 1, 2 or 4 band slots per thread, the fewest that
//     cover W, so that a diagonal's loads fit in registers;
//   - every device-memory read of diagonal k is issued at the top of its
//     iteration, before the first barrier;
//   - one block reduction carries the row max, the bridge term and the
//     F . B dot together (one barrier). The dot is taken on the raw row
//     and scaled after: total = r * (sum F * raw + bridge * bvalid). The
//     rows it keeps are raw * r, so mb is exactly the applied scale;
//   - the second barrier rotates the carries in shared memory.
// Its ring variant takes the streams off the chain: a ring of D <= 4
// shared-memory stages, each one diagonal's efx, efy, efm, em, bv, F rows
// and pm (contiguous segments of their (B, R, ...) tensors), filled by
// TMA bulk copies D diagonals ahead, completion on one mbarrier per
// stage; the row-constant shift bytes come one diagonal ahead into
// registers. One extra warp issues the copies (eight instructions of one
// thread per diagonal, which on a compute thread would lengthen the
// chain): it meets the compute threads only at the
// block barrier that ends a diagonal and frees its stage, and the
// reduction uses a barrier of the compute threads alone. D is as many
// stages as fit beside the carries in 227 KB. The launch runs the direct
// variant (the same body reading device memory at the top of each
// iteration, no producer warp) where W % 16 != 0 (bulk copies move
// 16-byte multiples), a stream starts off the 16-byte grid, fewer than
// two stages fit, or W > 1920 (4 slots on the ring's 480 compute
// threads).
//
// wavefront_exp (EM's E-step) keeps the earlier backward body
// (backward_body): the same recursion with the dot taken on the rescaled
// rows and a barrier per reduction, plus, per cell, the posterior flow
// into Baum-Welch expected counts. Its mb is wavefront_bwd's bit for bit;
// its total_raw agrees to within the rounding of the dot's order. Its
// neighbour rows F_{k-1} and F_{k-2} are read straight from the forward
// intermediate (the TPU's 2-row halo block is tiling and has no
// counterpart). The per-transition accumulators (13 or 9) live in
// registers, summed over the thread's slots; the S x 16 emission
// accumulators, which the TPU body fills with 16 masked adds per state
// per cell, are a private column of shared memory per thread indexed by
// the cell's symbol pair (row-major (S*16, threads), so the threads of a
// warp hit 32 distinct banks). That column (S*16*4 bytes) bounds the
// block at 256 threads, each with up to 8 slots (W <= 2048). Wider bands
// (to W <= 4096, the other kernels' limit) run 512 threads of 8 slots
// with the columns in a device scratch buffer that the caller passes, one
// (S*16, 512) region per block: each thread still reads and writes only
// its own column until the block's final barrier. At the end
// the block reduces its accumulators in a fixed order and writes its
// pair's (S, S) and (S, 4, 4) counts; the batch sum is the caller's. No
// atomics, so the counts are the same from run to run. On top of
// wavefront_bwd's traffic it reads the two forward emission streams, the
// symbol streams and F rows k-1 and k-2 (from L2 or device memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxSlotsPerThread = 4;
constexpr int kMaxThreads = 1024;
constexpr int kExpSlotsPerThread = 8;
constexpr int kExpMaxThreads = 256;      // emission columns in shared memory
constexpr int kExpWideThreads = 512;     // columns in the caller's scratch
constexpr int kExpSharedWidth = kExpSlotsPerThread * kExpMaxThreads;
constexpr int kMaxStages = 4;          // wavefront_bwd's ring of streams
constexpr int kRingThreads = 480;      // its compute threads beside the producer warp
constexpr size_t kSmemPerBlock = 232448;  // Hopper: 227 KB per block
constexpr size_t kStaticSmem = 1024;      // room for the static shared arrays
constexpr int kNormEvery = 4;

constexpr int kPmMatch = 1;
constexpr int kPmGapX = 2;
constexpr int kPmGapY = 4;
constexpr int kPmAtEnd = 8;
constexpr int kPmBridge = 16;

// (3S, S) row-major transition probabilities [x; m; y], room for S = 5.
struct Trans {
  float v[3 * 5 * 5];
};

// Statically nonzero transitions (class, from, to) in the order the JAX
// engines sum them (nonzero_transitions). Class 0 consumes X (lower
// neighbour F_{k-1}), 1 consumes XY (middle neighbour F_{k-2}), 2
// consumes Y (upper neighbour F_{k-1}). Every class-1 entry lands in the
// match state, which the bridge vector relies on. The wrapper reads these
// two lists from this file (ops/_kernels.py kernel_structures) to check a
// model against them, so keep each on its #define and its continued lines.
#define CPECAN_NZ5(X) \
  X(0, 0, 1) X(0, 0, 3) X(0, 1, 1) X(0, 3, 3) \
  X(1, 0, 0) X(1, 1, 0) X(1, 2, 0) X(1, 3, 0) X(1, 4, 0) \
  X(2, 0, 2) X(2, 0, 4) X(2, 2, 2) X(2, 4, 4)
#define CPECAN_NZ3(X) \
  X(0, 0, 1) X(0, 1, 1) X(0, 2, 1) \
  X(1, 0, 0) X(1, 1, 0) X(1, 2, 0) \
  X(2, 0, 2) X(2, 1, 2) X(2, 2, 2)

// Forward: cur[to] += term_c[from] * T[c, from, to].
#define CPECAN_FWD_TERM(c, f, t) \
  cur[t] += ((c) == 0 ? lo[f] : (c) == 1 ? mid[f] : up[f]) * T[((c) * S + (f)) * S + (t)];
// Backward: raw[from] += term_c[to] * T[c, from, to].
#define CPECAN_BWD_TERM(c, f, t) \
  raw[f] += ((c) == 0 ? bx[t] : (c) == 1 ? bm[t] : by[t]) * T[((c) * S + (f)) * S + (t)];
// Bridge vector: sum over match transitions of F_{k-2}[from] * t_m[from, match].
#define CPECAN_BV_TERM(c, f, t) \
  if ((c) == 1) acc += own2[f] * T[((c) * S + (f)) * S + (t)];
// Expectations, transition k of the list: n = neighbour * emission;
// tacc[k] += n * B_k[to] / total; q[to] += n * T[c, from, to].
#define CPECAN_EXP_TERM(c, f, t)                                       \
  {                                                                    \
    const float n = (c) == 0 ? lo[f] : (c) == 1 ? mid[f] : up[f];      \
    tacc[k] += n * bw[t];                                              \
    q[t] += n * T[((c) * S + (f)) * S + (t)];                          \
    ++k;                                                               \
  }
// Per-pair transition counts: trans[from, to] += sum(tacc[k]) * T.
#define CPECAN_TRANS_TERM(c, f, t)                                     \
  {                                                                    \
    const float v = block_sum(tacc[k], red);                           \
    __syncthreads();                                                   \
    out[(f) * S + (t)] += v * T[((c) * S + (f)) * S + (t)];            \
    ++k;                                                               \
  }
#define CPECAN_COUNT(c, f, t) +1

template <int S> struct Model;

template <> struct Model<5> {
  static __device__ __forceinline__ void fwd(float* cur, const float* lo, const float* mid,
                                             const float* up, const float* T) {
    constexpr int S = 5;
    CPECAN_NZ5(CPECAN_FWD_TERM)
  }
  static __device__ __forceinline__ void bwd(float* raw, const float* bx, const float* bm,
                                             const float* by, const float* T) {
    constexpr int S = 5;
    CPECAN_NZ5(CPECAN_BWD_TERM)
  }
  static __device__ __forceinline__ float bridge(const float* own2, const float* T) {
    constexpr int S = 5;
    float acc = 0.f;
    CPECAN_NZ5(CPECAN_BV_TERM)
    return acc;
  }
  static constexpr int kNz = 0 CPECAN_NZ5(CPECAN_COUNT);
  static __device__ __forceinline__ void exp(float* tacc, float* q, const float* lo,
                                             const float* mid, const float* up, const float* bw,
                                             const float* T) {
    constexpr int S = 5;
    int k = 0;
    CPECAN_NZ5(CPECAN_EXP_TERM)
  }
  // Every thread of the block calls it; out (S*S) is the caller's.
  static __device__ __forceinline__ void trans(float* out, const float* tacc, float* red,
                                               const float* T);
};

template <> struct Model<3> {
  static __device__ __forceinline__ void fwd(float* cur, const float* lo, const float* mid,
                                             const float* up, const float* T) {
    constexpr int S = 3;
    CPECAN_NZ3(CPECAN_FWD_TERM)
  }
  static __device__ __forceinline__ void bwd(float* raw, const float* bx, const float* bm,
                                             const float* by, const float* T) {
    constexpr int S = 3;
    CPECAN_NZ3(CPECAN_BWD_TERM)
  }
  static __device__ __forceinline__ float bridge(const float* own2, const float* T) {
    constexpr int S = 3;
    float acc = 0.f;
    CPECAN_NZ3(CPECAN_BV_TERM)
    return acc;
  }
  static constexpr int kNz = 0 CPECAN_NZ3(CPECAN_COUNT);
  static __device__ __forceinline__ void exp(float* tacc, float* q, const float* lo,
                                             const float* mid, const float* up, const float* bw,
                                             const float* T) {
    constexpr int S = 3;
    int k = 0;
    CPECAN_NZ3(CPECAN_EXP_TERM)
  }
  // Every thread of the block calls it; out (S*S) is the caller's.
  static __device__ __forceinline__ void trans(float* out, const float* tacc, float* red,
                                               const float* T);
};

// row[j] inside [0, W), zero outside (the Pallas shifts' zero fill).
__device__ __forceinline__ float nb(const float* row, int j, int W) {
  return (j >= 0 && j < W) ? row[j] : 0.f;
}

// Block-wide max / sum; blockDim.x is a multiple of 32 and every thread
// of the block calls it. Every thread returns the same value (the
// per-warp partials are combined in one fixed order). `red` holds one
// float per warp and must not be reused before the next block barrier.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) m = fmaxf(m, red[k]);
  return m;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += red[k];
  return s;
}

// kWindow: a window of a long pair (carries in and out, phase k0); the
// batch path's instantiation (kWindow false) compiles none of that.
template <int S, bool kWindow>
__global__ void __launch_bounds__(kMaxThreads) wavefront_fwd(
    const Trans tr, const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ em, const int8_t* __restrict__ a, const int8_t* __restrict__ b1,
    const int8_t* __restrict__ b0, const float* __restrict__ F0, const float* __restrict__ ci1,
    const float* __restrict__ ci2, const float* __restrict__ cim, float* __restrict__ F,
    float* __restrict__ bv, float* __restrict__ mf, float* __restrict__ co1,
    float* __restrict__ co2, float* __restrict__ com, int R, int W, int k0) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* f1 = smem;          // F_{k-1} (S, W)
  float* f2 = smem + S * W;  // F_{k-2} (S, W)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* T = tr.v;

  float invm = 1.f;  // 1/m_{k-1}
  if constexpr (kWindow) {
    // a window: every row is computed from the carried F_{k0-1}, F_{k0-2}
    for (int j = tid; j < S * W; j += nt) {
      f1[j] = ci1[(size_t)b * S * W + j];
      f2[j] = ci2[(size_t)b * S * W + j];
    }
    invm = cim[b];
  } else {
    // Diagonal 0 is the start row F0; F_{-1} is zero.
    for (int j = tid; j < W; j += nt) {
      for (int s = 0; s < S; ++s) {
        const float v = F0[((size_t)b * S + s) * W + j];
        f1[s * W + j] = v;
        f2[s * W + j] = 0.f;
        F[(((size_t)b * R) * S + s) * W + j] = v;
      }
      bv[(size_t)b * R * W + j] = 0.f;
    }
    if (tid == 0) mf[(size_t)b * R] = 0.f;
  }
  __syncthreads();

  for (int i = kWindow ? 0 : 1; i < R; ++i) {
    const size_t row = (size_t)b * R + i;
    const bool norm = ((kWindow ? k0 : 0) + i) % kNormEvery == kNormEvery - 1;
    // lower neighbour (consumes X) at j-1+a, upper (consumes Y) at j+a,
    // middle (consumes XY, F_{k-2}) at j+dmid with dmid in {-1, 0, 1}
    const bool sa = a[row] != 0;
    const int dl = sa ? 0 : -1;
    const int du = sa ? 1 : 0;
    const int dm = b1[row] != 0 ? 1 : (b0[row] != 0 ? 0 : -1);

    float cur[kMaxSlotsPerThread][S];
    float lmax = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSlotsPerThread; ++q) {
      const int j = tid + q * nt;
#pragma unroll
      for (int s = 0; s < S; ++s) cur[q][s] = 0.f;
      if (j < W) {
        const size_t o = row * W + j;
        const float exj = ex[o];
        const float eyj = ey[o];
        const float emi = em[o] * invm;
        float lo[S], mid[S], up[S], own2[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          lo[s] = nb(f1 + s * W, j + dl, W) * exj;
          up[s] = nb(f1 + s * W, j + du, W) * eyj;
          mid[s] = nb(f2 + s * W, j + dm, W) * emi;
          own2[s] = f2[s * W + j];
        }
        Model<S>::fwd(cur[q], lo, mid, up, T);
        // bridgevec[k] = (sum_f F_{k-2}[f] * t_m[f, match]) / m_{k-1}
        bv[o] = Model<S>::bridge(own2, T) * invm;
        if (norm) {
#pragma unroll
          for (int s = 0; s < S; ++s) lmax = fmaxf(lmax, cur[q][s]);
        }
      }
    }

    float r = 1.f;
    if (norm) {
      float m = block_max(lmax, red);
      m = m > 0.f ? m : 1.f;
      r = 1.f / m;
      if (tid == 0) mf[row] = logf(m);
    } else if (tid == 0) {
      mf[row] = 0.f;
    }
    __syncthreads();  // every read of f1/f2 for this diagonal is done

    // F_k replaces F_{k-2} in shared memory; then the buffers swap roles.
#pragma unroll
    for (int q = 0; q < kMaxSlotsPerThread; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float v = cur[q][s] * r;
          f2[s * W + j] = v;
          F[(row * S + s) * W + j] = v;
        }
      }
    }
    __syncthreads();
    float* tmp = f1;
    f1 = f2;
    f2 = tmp;
    invm = r;
  }

  // carry out of the last row (the loop's final barrier precedes)
  if (kWindow && co1 != nullptr) {
    for (int j = tid; j < S * W; j += nt) {
      co1[(size_t)b * S * W + j] = f1[j];
      co2[(size_t)b * S * W + j] = f2[j];
    }
    if (tid == 0) com[b] = invm;
  }
}

__device__ __forceinline__ void Model<5>::trans(float* out, const float* tacc, float* red,
                                                const float* T) {
  constexpr int S = 5;
  int k = 0;
  CPECAN_NZ5(CPECAN_TRANS_TERM)
}

__device__ __forceinline__ void Model<3>::trans(float* out, const float* tacc, float* red,
                                                const float* T) {
  constexpr int S = 3;
  int k = 0;
  CPECAN_NZ3(CPECAN_TRANS_TERM)
}

// Arguments of the backward kernels; the second group is wavefront_bwd's
// output, the third wavefront_exp's inputs and outputs.
struct BwdArgs {
  const float* efx;
  const float* efy;
  const float* efm;
  const float* em;
  const float* F;
  const float* bv;
  const int8_t* abw;
  const int8_t* c1;
  const int8_t* c0;
  const int8_t* bm1;
  const int8_t* bm0;
  const int8_t* pm;
  const float* end_row;
  float* mb;
  float* tot;
  // wavefront_bwd: posteriors (post_x / post_y null in posterior_match)
  float* post_m;
  float* post_x;
  float* post_y;
  // wavefront_exp: forward emission streams and shift selects, the
  // neighbour scale adjustments, the cells' symbols, per-pair counts
  const float* ex;
  const float* ey;
  const int8_t* a;
  const int8_t* b1;
  const int8_t* b0;
  const float* adj1;
  const float* adj2;
  const int8_t* wx;
  const int8_t* wy;
  float* trans;
  float* emis;
  // wavefront_exp at W > kExpSharedWidth: (B, S*16, blockDim.x) emission
  // columns; null otherwise (the columns live in shared memory)
  float* eacc;
  // windows of a long pair (all null on the batch path): exp's F halo
  // (rows k0-2, k0-1), the backward carry in (B_{k1}, B_{k1+1}, 1/mb,
  // em_{k1}, bridgevec_{k1}) and the same carry out of the first row
  const float* fhc;
  const float* ci_b1;
  const float* ci_b2;
  const float* ci_invb;
  const float* ci_em;
  const float* ci_bv;
  float* co_b1;
  float* co_b2;
  float* co_invb;
  float* co_em;
  float* co_bv;
  int k0;  // global diagonal of row 0
};

// wavefront_exp's body: the backward wavefront of one pair (this
// block's), high to low, with the expected counts of each diagonal.
// Shared memory: B_{k+1}, B_{k+2} (S, W) each, bridgevec_{k+1} (W), and
// the emission accumulators (S * 16, blockDim.x) unless kScratch puts
// them in p.eacc.
template <int S, int kSlots, bool kScratch, bool kWindow>
__device__ __forceinline__ void backward_body(const Trans& tr, const BwdArgs& p, int R, int W,
                                              float* smem, float (*red)[32]) {
  float* b1s = smem;              // B_{k+1} (S, W)
  float* b2s = smem + S * W;      // B_{k+2} (S, W)
  float* bvn = smem + 2 * S * W;  // bridgevec_{k+1} (W)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // (S * 16, nt) emission accumulators; thread tid owns column tid
  float* eacc = kScratch ? p.eacc + (size_t)b * S * 16 * nt : bvn + W;
  const float* T = tr.v;
  constexpr int kNz = Model<S>::kNz;

  // The recursion starts from the carry of the row above a window, or
  // past the last diagonal from zero carries.
  constexpr bool carry = kWindow;
  for (int j = tid; j < S * W; j += nt) {
    b1s[j] = carry ? p.ci_b1[(size_t)b * S * W + j] : 0.f;
    b2s[j] = carry ? p.ci_b2[(size_t)b * S * W + j] : 0.f;
  }
  for (int j = tid; j < W; j += nt) bvn[j] = carry ? p.ci_bv[(size_t)b * W + j] : 0.f;
  for (int j = tid; j < S * 16 * nt; j += nt) eacc[j] = 0.f;
  float tacc[kNz];
#pragma unroll
  for (int k = 0; k < kNz; ++k) tacc[k] = 0.f;
  float emn[kSlots];  // em_{k+1} of the thread's own slots
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = tid + q * nt;
    emn[q] = (carry && j < W) ? p.ci_em[(size_t)b * W + j] : 0.f;
  }
  float invb = carry ? p.ci_invb[b] : 1.f;  // 1/mb_{k+1}
  __syncthreads();

  for (int ii = R - 1; ii >= 0; --ii) {
    const size_t row = (size_t)b * R + ii;
    const bool norm = ((kWindow ? p.k0 : 0) + ii) % kNormEvery == kNormEvery - 1;
    const int pm0 = p.pm[row * W];  // row-constant bits live in every slot
    const bool at_end = (pm0 & kPmAtEnd) != 0;
    const bool bvalid = (pm0 & kPmBridge) != 0;
    // receive from k+1: x-class at j+1-d1, y-class at j-d1; from k+2:
    // m-class at j+1-dsum2; bridge vector at j+dmid_{k+1}
    const bool sabw = p.abw[row] != 0;
    const int dx = sabw ? 0 : 1;
    const int dy = sabw ? -1 : 0;
    const int dm = p.c1[row] != 0 ? -1 : (p.c0[row] != 0 ? 0 : 1);
    const int db = p.bm1[row] != 0 ? 1 : (p.bm0[row] != 0 ? 0 : -1);

    float raw[kSlots][S];
    float lmax = 0.f;
    float lbr = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
#pragma unroll
      for (int s = 0; s < S; ++s) raw[q][s] = 0.f;
      if (j < W) {
        const size_t o = row * W + j;
        const float efxj = p.efx[o];
        const float efyj = p.efy[o];
        const float efmi = p.efm[o] * invb;
        float bx[S], bm[S], by[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          bx[s] = nb(b1s + s * W, j + dx, W) * efxj;
          by[s] = nb(b1s + s * W, j + dy, W) * efyj;
          bm[s] = nb(b2s + s * W, j + dm, W) * efmi;
        }
        Model<S>::bwd(raw[q], bx, bm, by, T);
        if (at_end) {
#pragma unroll
          for (int s = 0; s < S; ++s) raw[q][s] = p.end_row[((size_t)b * S + s) * W + j];
        }
        if (norm) {
#pragma unroll
          for (int s = 0; s < S; ++s) lmax = fmaxf(lmax, raw[q][s]);
        }
        lbr += nb(bvn, j + db, W) * emn[q] * b1s[j];
      }
    }

    float r = 1.f;
    float mbv = 0.f;
    if (norm) {
      float m = block_max(lmax, red[0]);
      if (!(m > 0.f) || at_end) m = 1.f;
      r = 1.f / m;
      mbv = logf(m);
    }
    const float bridge = block_sum(lbr, red[1]);

    float ldot = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          raw[q][s] *= r;
          ldot += p.F[(row * S + s) * W + j] * raw[q][s];
        }
      }
    }
    // This reduction's barrier also follows every read of the carries
    // for this diagonal, so they may be rotated in place below.
    const float dot = block_sum(ldot, red[2]);
    const float total = dot + bridge * r * (bvalid ? 1.f : 0.f);
    const bool ok = total > 0.f;
    const float invt = ok ? 1.f / total : 0.f;
    if (tid == 0) {
      p.mb[row] = mbv;
      p.tot[row] = ok ? logf(total) : 0.f;
    }

    // forward-side row constants of the expectations: F_{k-1} (lower
    // neighbour at j-1+a, upper at j+a) and F_{k-2} (middle at j+dmid);
    // below row 0 a window reads its halo, the batch path zero (adj1 /
    // adj2 are zero there too)
    const bool sa = p.a[row] != 0;
    const int dl = sa ? 0 : -1;
    const int du = sa ? 1 : 0;
    const int dmf = p.b1[row] != 0 ? 1 : (p.b0[row] != 0 ? 0 : -1);
    const float a1 = p.adj1[row];
    const float a2 = p.adj2[row];
    const float* halo = (kWindow && p.fhc) ? p.fhc + (size_t)b * 2 * S * W : nullptr;
    const float* F1 = nullptr;
    const float* F2 = nullptr;
    if (ii >= 1) F1 = p.F + (row - 1) * S * W;
    else if (halo) F1 = halo + S * W;
    if (ii >= 2) F2 = p.F + (row - 2) * S * W;
    else if (halo) F2 = halo + ii * S * W;

#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
        const size_t o = row * W + j;
        const float exa = p.ex[o] * a1;
        const float eya = p.ey[o] * a1;
        const float ema = p.em[o] * a2;
        float lo[S], mid[S], up[S], bw[S], qv[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          lo[s] = F1 ? nb(F1 + s * W, j + dl, W) * exa : 0.f;
          up[s] = F1 ? nb(F1 + s * W, j + du, W) * eya : 0.f;
          mid[s] = F2 ? nb(F2 + s * W, j + dmf, W) * ema : 0.f;
          bw[s] = raw[q][s] * invt;
          qv[s] = 0.f;
        }
        Model<S>::exp(tacc, qv, lo, mid, up, bw, T);
        const int sx = p.wx[o];
        const int sy = p.wy[o];
        if (sx < 4 && sy < 4) {
          float* col = eacc + (sx * 4 + sy) * nt + tid;
#pragma unroll
          for (int s = 0; s < S; ++s) col[s * 16 * nt] += qv[s] * bw[s];
        }
        // B_k replaces B_{k+2}; B_{k+1} becomes B_{k+2}, zeroed at k == L
#pragma unroll
        for (int s = 0; s < S; ++s) {
          b2s[s * W + j] = raw[q][s];
          if (at_end) b1s[s * W + j] = 0.f;
        }
        bvn[j] = p.bv[o];
        emn[q] = p.em[o];
      }
    }
    invb = at_end ? 1.f : r;
    __syncthreads();
    float* tmp = b1s;
    b1s = b2s;
    b2s = tmp;
  }

  // carry out of row 0 (the loop's final barrier precedes)
  if (kWindow && p.co_b1 != nullptr) {
    for (int j = tid; j < S * W; j += nt) {
      p.co_b1[(size_t)b * S * W + j] = b1s[j];
      p.co_b2[(size_t)b * S * W + j] = b2s[j];
    }
    for (int j = tid; j < W; j += nt) p.co_bv[(size_t)b * W + j] = bvn[j];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) p.co_em[(size_t)b * W + j] = emn[q];
    }
    if (tid == 0) p.co_invb[b] = invb;
  }

  // The pair's counts: transitions by block reductions, emissions by one
  // thread per (state, symbol pair) summing the threads' columns in
  // order. The loop's final barrier precedes these reads.
  float out[S * S];
#pragma unroll
  for (int k = 0; k < S * S; ++k) out[k] = 0.f;
  Model<S>::trans(out, tacc, red[0], T);
  if (tid == 0) {
    for (int k = 0; k < S * S; ++k) p.trans[(size_t)b * S * S + k] = out[k];
  }
  for (int k = tid; k < S * 16; k += nt) {
    const float* rowp = eacc + k * nt;
    float s = 0.f;
    for (int c = 0; c < nt; ++c) s += rowp[c];
    p.emis[(size_t)b * S * 16 + k] = s;
  }
}

template <int S, int kThreads, bool kWindow>
__global__ void __launch_bounds__(kThreads)
    wavefront_exp(const Trans tr, const BwdArgs p, int R, int W) {
  extern __shared__ float smem[];
  __shared__ float red[3][32];
  backward_body<S, kExpSlotsPerThread, (kThreads > kExpMaxThreads), kWindow>(tr, p, R, W, smem,
                                                                           red);
}

// ------------------------------------------------------------ wavefront_bwd
//
// The ring of streams: stage k holds one diagonal's efx, efy, efm, em, bv
// (W floats each), F (S, W) and pm (W bytes), each one contiguous segment
// of its (B, R, ...) tensor, filled by TMA bulk copies whose bytes land on
// the stage's mbarrier. The four functions below are the only ones that
// speak to the copy engine.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Arm `bar` (arrival count 1) for the copies of a fill.
__device__ __forceinline__ void ring_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on `bar` and expect `bytes` of copies in this phase.
__device__ __forceinline__ void ring_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Bulk copy (TMA) of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void ring_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of `bar` with this parity (its copies have landed).
// A fill that never lands traps instead of hanging the card.
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (n == (1u << 26)) __trap();
  }
}

// Bytes of one ring stage.
__host__ __device__ constexpr size_t stage_bytes(int S, int W) {
  return (5 + (size_t)S) * W * sizeof(float) + W;
}

// Fill `stage` with diagonal `row` (a row of the (B, R) grid): one thread.
template <int S>
__device__ __forceinline__ void ring_fill(char* stage, uint64_t* bar, const BwdArgs& p,
                                          size_t row, int W) {
  const uint32_t wb = (uint32_t)W * sizeof(float);
  float* d = reinterpret_cast<float*>(stage);
  ring_expect(bar, (uint32_t)stage_bytes(S, W));
  ring_copy(d, p.efx + row * W, wb, bar);
  ring_copy(d + W, p.efy + row * W, wb, bar);
  ring_copy(d + 2 * W, p.efm + row * W, wb, bar);
  ring_copy(d + 3 * W, p.em + row * W, wb, bar);
  ring_copy(d + 4 * W, p.bv + row * W, wb, bar);
  ring_copy(d + 5 * W, p.F + row * S * W, S * wb, bar);
  ring_copy(d + (5 + S) * W, p.pm + row * W, (uint32_t)W, bar);
}

// The five row-constant shift selects of one diagonal.
struct RowBits {
  int8_t abw, c1, c0, bm1, bm0;
};

__device__ __forceinline__ RowBits row_bits(const BwdArgs& p, size_t row) {
  return {p.abw[row], p.c1[row], p.c0[row], p.bm1[row], p.bm0[row]};
}

// The compute threads' own barrier (named barrier 1, n threads): the
// ring variant's producer warp takes no part in the block reduction.
__device__ __forceinline__ void sync_compute(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// Backward wavefront and posteriors of one pair (this block's), high to
// low. The first nt threads compute, each owning kSlots band slots
// j = tid + q * nt; kRing adds one producer warp after them, which fills
// the ring. Shared memory: B_{k+1}, B_{k+2} (S, W) each, bridgevec_{k+1}
// (W), then (kRing) D ring stages. Per diagonal: every device-memory read
// is issued at the top (kRing: the producer issued them D diagonals
// earlier into the ring, and the row-constant bytes come one diagonal
// earlier into registers), one block reduction of (row max, bridge,
// F.B dot) with the compute threads' barrier, then the outputs and the
// new carries, and the block barrier that rotates them and frees the
// diagonal's stage.
template <int S, int kSlots, bool kRing, bool kWindow>
__global__ void __launch_bounds__(kRing ? kRingThreads + 32 : kMaxThreads)
    wavefront_bwd(const Trans tr, const BwdArgs p, int R, int W, int D) {
  extern __shared__ __align__(16) float bwd_smem[];  // 16-byte aligned for the copies
  __shared__ float red[3][32];                       // per warp: row max, bridge, dot
  __shared__ uint64_t bars[kMaxStages];
  float* smem = bwd_smem;
  float* b1s = smem;              // B_{k+1} (S, W)
  float* b2s = smem + S * W;      // B_{k+2} (S, W)
  float* bvn = smem + 2 * S * W;  // bridgevec_{k+1} (W)
  char* ring = reinterpret_cast<char*>(smem + (2 * S + 1) * W);
  const size_t sbytes = stage_bytes(S, W);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x - (kRing ? 32 : 0);  // compute threads
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const float* T = tr.v;
  const bool all = p.post_x != nullptr;

  if (kRing && tid >= nt) {
    // The producer warp: stage s starts with diagonal R-1-s; once the
    // block barrier that ends diagonal ii has freed its stage, one thread
    // refills it with diagonal ii-D. It meets the compute threads only at
    // the block barriers (one before the loop, one per diagonal).
    if (tid == nt) {
      for (int s = 0; s < D; ++s) ring_init(&bars[s]);
      for (int s = 0; s < D && s < R; ++s)
        ring_fill<S>(ring + s * sbytes, &bars[s], p, (size_t)b * R + R - 1 - s, W);
    }
    __syncthreads();
    int st = 0;
    for (int ii = R - 1; ii >= 0; --ii) {
      __syncthreads();
      if (tid == nt && ii >= D)
        ring_fill<S>(ring + st * sbytes, &bars[st], p, (size_t)b * R + ii - D, W);
      if (++st == D) st = 0;
    }
    return;
  }

  // The recursion starts from the carry of the row above a window, or
  // past the last diagonal from zero carries.
  constexpr bool carry = kWindow;
  for (int j = tid; j < S * W; j += nt) {
    b1s[j] = carry ? p.ci_b1[(size_t)b * S * W + j] : 0.f;
    b2s[j] = carry ? p.ci_b2[(size_t)b * S * W + j] : 0.f;
  }
  for (int j = tid; j < W; j += nt) bvn[j] = carry ? p.ci_bv[(size_t)b * W + j] : 0.f;
  float emn[kSlots];  // em_{k+1} of the thread's own slots
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = tid + q * nt;
    emn[q] = (carry && j < W) ? p.ci_em[(size_t)b * W + j] : 0.f;
  }
  float invb = carry ? p.ci_invb[b] : 1.f;  // 1/mb_{k+1}
  RowBits next = {};
  if constexpr (kRing) next = row_bits(p, (size_t)b * R + R - 1);
  __syncthreads();

  int st = 0;           // the ring stage of diagonal ii
  uint32_t parity = 0;  // the phase of that stage's barrier
  for (int ii = R - 1; ii >= 0; --ii) {
    const size_t row = (size_t)b * R + ii;
    const bool norm = ((kWindow ? p.k0 : 0) + ii) % kNormEvery == kNormEvery - 1;

    // Every device-memory read of this diagonal, before its first barrier.
    RowBits rb;
    const float *gx, *gy, *gm, *ge, *gb, *gF;
    const int8_t* gp;
    if constexpr (kRing) {
      rb = next;
      if (ii >= 1) next = row_bits(p, row - 1);
      ring_wait(&bars[st], parity);
      gx = reinterpret_cast<const float*>(ring + st * sbytes);
      gy = gx + W, gm = gx + 2 * W, ge = gx + 3 * W, gb = gx + 4 * W, gF = gx + 5 * W;
      gp = reinterpret_cast<const int8_t*>(gx + (5 + S) * W);
    } else {
      rb = row_bits(p, row);
      gx = p.efx + row * W, gy = p.efy + row * W, gm = p.efm + row * W;
      ge = p.em + row * W, gb = p.bv + row * W, gF = p.F + row * S * W;
      gp = p.pm + row * W;
    }
    const int pm0 = gp[0];  // row-constant bits live in every slot
    float vx[kSlots], vy[kSlots], vm[kSlots], ve[kSlots], vb[kSlots], vF[kSlots][S];
    int vp[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      const bool in = j < W;
      vx[q] = in ? gx[j] : 0.f;
      vy[q] = in ? gy[j] : 0.f;
      vm[q] = in ? gm[j] : 0.f;
      ve[q] = in ? ge[j] : 0.f;
      vb[q] = in ? gb[j] : 0.f;
      vp[q] = in ? gp[j] : 0;
#pragma unroll
      for (int s = 0; s < S; ++s) vF[q][s] = in ? gF[s * W + j] : 0.f;
    }

    const bool at_end = (pm0 & kPmAtEnd) != 0;
    const bool bvalid = (pm0 & kPmBridge) != 0;
    // receive from k+1: x-class at j+1-d1, y-class at j-d1; from k+2:
    // m-class at j+1-dsum2; bridge vector at j+dmid_{k+1}
    const bool sabw = rb.abw != 0;
    const int dx = sabw ? 0 : 1;
    const int dy = sabw ? -1 : 0;
    const int dm = rb.c1 != 0 ? -1 : (rb.c0 != 0 ? 0 : 1);
    const int db = rb.bm1 != 0 ? 1 : (rb.bm0 != 0 ? 0 : -1);

    // raw B_k, and this thread's share of the row max, the bridge and the
    // dot F_k . raw (the rescale r applies to the dot after the reduction)
    float raw[kSlots][S];
    float lmax = 0.f;
    float lbr = 0.f;
    float ldot = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
#pragma unroll
      for (int s = 0; s < S; ++s) raw[q][s] = 0.f;
      if (j < W) {
        const float efmi = vm[q] * invb;
        float bx[S], bm[S], by[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          bx[s] = nb(b1s + s * W, j + dx, W) * vx[q];
          by[s] = nb(b1s + s * W, j + dy, W) * vy[q];
          bm[s] = nb(b2s + s * W, j + dm, W) * efmi;
        }
        Model<S>::bwd(raw[q], bx, bm, by, T);
        if (at_end) {
#pragma unroll
          for (int s = 0; s < S; ++s) raw[q][s] = p.end_row[((size_t)b * S + s) * W + j];
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (norm) lmax = fmaxf(lmax, raw[q][s]);
          ldot += vF[q][s] * raw[q][s];
        }
        lbr += nb(bvn, j + db, W) * emn[q] * b1s[j];
      }
    }

    // One block reduction of (row max, bridge, dot): warp shuffles, one
    // partial per warp, one barrier, every thread combines the partials
    // in the same fixed order. The barrier also follows every read of the
    // carries for this diagonal, so they may be rotated in place below.
    for (int o = 16; o > 0; o >>= 1) {
      if (norm) lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      lbr += __shfl_xor_sync(0xffffffffu, lbr, o);
      ldot += __shfl_xor_sync(0xffffffffu, ldot, o);
    }
    if (lane == 0) {
      red[0][warp] = lmax;
      red[1][warp] = lbr;
      red[2][warp] = ldot;
    }
    sync_compute(nt);
    float r = 1.f;
    float mbv = 0.f;
    if (norm) {
      float m = red[0][0];
      for (int k = 1; k < nw; ++k) m = fmaxf(m, red[0][k]);
      if (!(m > 0.f) || at_end) m = 1.f;
      r = 1.f / m;
      mbv = logf(m);
    }
    float bridge = 0.f, dot = 0.f;
    for (int k = 0; k < nw; ++k) {
      bridge += red[1][k];
      dot += red[2][k];
    }
    const float total = r * (dot + (bvalid ? bridge : 0.f));
    const bool ok = total > 0.f;
    const float invt = ok ? 1.f / total : 0.f;
    if (tid == 0) {
      p.mb[row] = mbv;
      p.tot[row] = ok ? logf(total) : 0.f;
    }

#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
        const size_t o = row * W + j;
        float bk[S];  // B_k, exactly the rescaled row mb records
#pragma unroll
        for (int s = 0; s < S; ++s) bk[s] = raw[q][s] * r;
        const int pb = vp[q];
        p.post_m[o] = (pb & kPmMatch) ? vF[q][0] * bk[0] * invt : 0.f;
        if (all) {
          p.post_x[o] = (pb & kPmGapX) ? vF[q][1] * bk[1] * invt : 0.f;
          p.post_y[o] = (pb & kPmGapY) ? vF[q][2] * bk[2] * invt : 0.f;
        }
        // B_k replaces B_{k+2}; B_{k+1} becomes B_{k+2}, zeroed at k == L
#pragma unroll
        for (int s = 0; s < S; ++s) {
          b2s[s * W + j] = bk[s];
          if (at_end) b1s[s * W + j] = 0.f;
        }
        bvn[j] = vb[q];
        emn[q] = ve[q];
      }
    }
    invb = at_end ? 1.f : r;
    __syncthreads();
    float* tmp = b1s;
    b1s = b2s;
    b2s = tmp;
    if constexpr (kRing) {
      if (++st == D) {
        st = 0;
        parity ^= 1u;
      }
    }
  }

  // carry out of row 0 (the loop's final barrier precedes)
  if (kWindow && p.co_b1 != nullptr) {
    for (int j = tid; j < S * W; j += nt) {
      p.co_b1[(size_t)b * S * W + j] = b1s[j];
      p.co_b2[(size_t)b * S * W + j] = b2s[j];
    }
    for (int j = tid; j < W; j += nt) p.co_bv[(size_t)b * W + j] = bvn[j];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) p.co_em[(size_t)b * W + j] = emn[q];
    }
    if (tid == 0) p.co_invb[b] = invb;
  }
}

int threads_for(int W) {
  const int nt = (W + 31) / 32 * 32;
  return nt < kMaxThreads ? nt : kMaxThreads;
}

Trans load_trans(int S, const float* t_host) {
  Trans tr = {};
  for (int k = 0; k < 3 * S * S; ++k) tr.v[k] = t_host[k];
  return tr;
}

template <int S>
int launch_fwd(const float* t_host, const float* ex, const float* ey, const float* em,
               const int8_t* a, const int8_t* b1, const int8_t* b0, const float* F0,
               const float* ci1, const float* ci2, const float* cim, float* F, float* bv,
               float* mf, float* co1, float* co2, float* com, int B, int R, int W, int k0,
               cudaStream_t stream) {
  const size_t smem = 2 * (size_t)S * W * sizeof(float);
  auto kernel = ci1 != nullptr ? wavefront_fwd<S, true> : wavefront_fwd<S, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, threads_for(W), smem, stream>>>(load_trans(S, t_host), ex, ey, em, a, b1, b0, F0,
                                              ci1, ci2, cim, F, bv, mf, co1, co2, com, R, W, k0);
  return (int)cudaGetLastError();
}

// wavefront_bwd's launch at (S, W): ring depth D (0: the direct-load
// variant), threads, kSlots band slots per compute thread and dynamic
// shared memory. D is as many stages as fit beside the carries, at most
// kMaxStages; the ring needs W % 16 == 0 (16-byte bulk copies), streams
// on the 16-byte grid (`aligned`), at least two stages, and
// W <= 4 * kRingThreads. Slots: 1, 2 or 4, the fewest that cover W with
// at most kRingThreads compute threads (ring: fewer, fuller threads make
// the block reduction and barriers cheaper, with the registers of a
// 512-thread launch) or kMaxThreads (direct loads).
struct BwdPlan {
  int threads, slots, depth;
  size_t smem;
};

BwdPlan bwd_plan(int S, int W, bool aligned) {
  const size_t carries = (2 * (size_t)S + 1) * W * sizeof(float);
  const size_t fit = (kSmemPerBlock - kStaticSmem - carries) / stage_bytes(S, W);
  int depth = (int)std::min<size_t>(kMaxStages, fit);
  if (!aligned || W % 16 != 0 || depth < 2 || W > 4 * kRingThreads) depth = 0;
  const int cap = depth ? kRingThreads : kMaxThreads;
  const int slots = W <= cap ? 1 : W <= 2 * cap ? 2 : 4;
  const int compute = ((W + slots - 1) / slots + 31) / 32 * 32;
  return {compute + (depth ? 32 : 0), slots, depth, carries + depth * stage_bytes(S, W)};
}

// The streams the ring copies start on 16-byte boundaries.
bool ring_aligned(const BwdArgs& p) {
  const void* ptrs[] = {p.efx, p.efy, p.efm, p.em, p.bv, p.F, p.pm};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  return true;
}

using BwdKernel = void (*)(Trans, BwdArgs, int, int, int);

template <int S, int kSlots, bool kRing>
BwdKernel bwd_kernel(bool window) {
  return window ? wavefront_bwd<S, kSlots, kRing, true> : wavefront_bwd<S, kSlots, kRing, false>;
}

template <int S>
int launch_bwd(const float* t_host, const BwdArgs& p, int B, int R, int W, cudaStream_t stream) {
  const BwdPlan pl = bwd_plan(S, W, ring_aligned(p));
  const bool window = p.ci_b1 != nullptr;
  const bool ring = pl.depth > 0;
  BwdKernel kernel = pl.slots == 1   ? (ring ? bwd_kernel<S, 1, true>(window)
                                             : bwd_kernel<S, 1, false>(window))
                     : pl.slots == 2 ? (ring ? bwd_kernel<S, 2, true>(window)
                                             : bwd_kernel<S, 2, false>(window))
                                     : (ring ? bwd_kernel<S, 4, true>(window)
                                             : bwd_kernel<S, 4, false>(window));
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, pl.threads, pl.smem, stream>>>(load_trans(S, t_host), p, R, W, pl.depth);
  return (int)cudaGetLastError();
}

// W <= kExpSharedWidth: up to 256 threads, emission columns in shared
// memory; wider: 512 threads, columns in p.eacc.
template <int S>
int launch_exp(const float* t_host, const BwdArgs& p, int B, int R, int W, cudaStream_t stream) {
  const bool wide = W > kExpSharedWidth;
  if (wide != (p.eacc != nullptr)) return (int)cudaErrorInvalidValue;
  const int nt = wide ? kExpWideThreads : std::min((W + 31) / 32 * 32, kExpMaxThreads);
  const size_t smem =
      ((2 * (size_t)S + 1) * W + (wide ? 0 : (size_t)S * 16 * nt)) * sizeof(float);
  const bool window = p.ci_b1 != nullptr;
  auto kernel = wide ? (window ? wavefront_exp<S, kExpWideThreads, true>
                               : wavefront_exp<S, kExpWideThreads, false>)
                     : (window ? wavefront_exp<S, kExpMaxThreads, true>
                               : wavefront_exp<S, kExpMaxThreads, false>);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, nt, smem, stream>>>(load_trans(S, t_host), p, R, W);
  return (int)cudaGetLastError();
}

bool bad_shape(int S, int B, int R, int W) {
  return (S != 3 && S != 5) || B < 0 || R < 1 || W < 1 ||
         W > kMaxSlotsPerThread * kMaxThreads;
}

// The window arguments shared by the backward entry points: the carry in
// and out (each five pointers, all null or all given) and k0.
bool set_window(BwdArgs& p, const float* const* ci, float* const* co, int k0) {
  const bool in = ci[0] != nullptr, out = co[0] != nullptr;
  for (int k = 1; k < 5; ++k)
    if ((ci[k] != nullptr) != in || (co[k] != nullptr) != out) return false;
  p.ci_b1 = ci[0], p.ci_b2 = ci[1], p.ci_invb = ci[2], p.ci_em = ci[3], p.ci_bv = ci[4];
  p.co_b1 = co[0], p.co_b2 = co[1], p.co_invb = co[2], p.co_em = co[3], p.co_bv = co[4];
  p.k0 = k0;
  return k0 >= 0;
}

}  // namespace

// C entry points (loaded with ctypes). Each returns the cudaError_t of
// the launch (0 on success); the wrapper raises on anything else.
extern "C" {

// F0 null: a window, started from the carry ci1/ci2/cim (all given);
// co1/co2/com: the carry out, all null or all given.
int cpecan_wavefront_fwd(int S, const float* t_host, const float* ex, const float* ey,
                         const float* em, const int8_t* a, const int8_t* b1, const int8_t* b0,
                         const float* F0, const float* ci1, const float* ci2, const float* cim,
                         float* F, float* bv, float* mf, float* co1, float* co2, float* com,
                         int B, int R, int W, int k0, void* stream) {
  if (bad_shape(S, B, R, W) || k0 < 0 || (F0 == nullptr) == (ci1 == nullptr) ||
      (ci1 != nullptr && (ci2 == nullptr || cim == nullptr)) ||
      (co1 != nullptr && (co2 == nullptr || com == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 5)
    return launch_fwd<5>(t_host, ex, ey, em, a, b1, b0, F0, ci1, ci2, cim, F, bv, mf, co1, co2,
                         com, B, R, W, k0, st);
  return launch_fwd<3>(t_host, ex, ey, em, a, b1, b0, F0, ci1, ci2, cim, F, bv, mf, co1, co2, com,
                       B, R, W, k0, st);
}

int cpecan_wavefront_bwd(int S, const float* t_host, const float* efx, const float* efy,
                         const float* efm, const float* em, const float* F, const float* bv,
                         const int8_t* abw, const int8_t* c1, const int8_t* c0,
                         const int8_t* bm1, const int8_t* bm0, const int8_t* pm,
                         const float* end_row, float* post_m, float* post_x, float* post_y,
                         float* mb, float* tot, const float* ci_b1, const float* ci_b2,
                         const float* ci_invb, const float* ci_em, const float* ci_bv,
                         float* co_b1, float* co_b2, float* co_invb, float* co_em, float* co_bv,
                         int B, int R, int W, int k0, void* stream) {
  BwdArgs p = {};
  const float* ci[5] = {ci_b1, ci_b2, ci_invb, ci_em, ci_bv};
  float* co[5] = {co_b1, co_b2, co_invb, co_em, co_bv};
  if (bad_shape(S, B, R, W) || !set_window(p, ci, co, k0)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  p.efx = efx, p.efy = efy, p.efm = efm, p.em = em, p.F = F, p.bv = bv;
  p.abw = abw, p.c1 = c1, p.c0 = c0, p.bm1 = bm1, p.bm0 = bm0, p.pm = pm;
  p.end_row = end_row, p.mb = mb, p.tot = tot;
  p.post_m = post_m, p.post_x = post_x, p.post_y = post_y;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 5) return launch_bwd<5>(t_host, p, B, R, W, st);
  return launch_bwd<3>(t_host, p, B, R, W, st);
}

int cpecan_wavefront_exp(int S, const float* t_host, const float* efx, const float* efy,
                         const float* efm, const float* em, const float* ex, const float* ey,
                         const float* F, const float* bv, const int8_t* abw, const int8_t* c1,
                         const int8_t* c0, const int8_t* bm1, const int8_t* bm0,
                         const int8_t* a, const int8_t* b1, const int8_t* b0,
                         const int8_t* pm, const float* end_row, const float* adj1,
                         const float* adj2, const int8_t* wx, const int8_t* wy, float* trans,
                         float* emis, float* eacc, float* mb, float* tot, const float* fhc,
                         const float* ci_b1, const float* ci_b2, const float* ci_invb,
                         const float* ci_em, const float* ci_bv, float* co_b1, float* co_b2,
                         float* co_invb, float* co_em, float* co_bv, int B, int R, int W, int k0,
                         void* stream) {
  BwdArgs p = {};
  const float* ci[5] = {ci_b1, ci_b2, ci_invb, ci_em, ci_bv};
  float* co[5] = {co_b1, co_b2, co_invb, co_em, co_bv};
  if (bad_shape(S, B, R, W) || W > kExpSlotsPerThread * kExpWideThreads ||
      !set_window(p, ci, co, k0) || (fhc != nullptr && ci_b1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  p.fhc = fhc;
  p.efx = efx, p.efy = efy, p.efm = efm, p.em = em, p.F = F, p.bv = bv;
  p.abw = abw, p.c1 = c1, p.c0 = c0, p.bm1 = bm1, p.bm0 = bm0, p.pm = pm;
  p.end_row = end_row, p.mb = mb, p.tot = tot;
  p.ex = ex, p.ey = ey, p.a = a, p.b1 = b1, p.b0 = b0;
  p.adj1 = adj1, p.adj2 = adj2, p.wx = wx, p.wy = wy, p.trans = trans, p.emis = emis;
  p.eacc = eacc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 5) return launch_exp<5>(t_host, p, B, R, W, st);
  return launch_exp<3>(t_host, p, B, R, W, st);
}

// wavefront_bwd's launch at (S, W) for streams on the 16-byte grid
// (aligned != 0) or off it: out = {threads, band slots per compute
// thread, ring depth (0: direct loads), dynamic shared memory bytes}.
int cpecan_wavefront_bwd_plan(int S, int W, int aligned, int* out) {
  if (bad_shape(S, 1, 1, W)) return (int)cudaErrorInvalidValue;
  const BwdPlan pl = bwd_plan(S, W, aligned != 0);
  out[0] = pl.threads, out[1] = pl.slots, out[2] = pl.depth, out[3] = (int)pl.smem;
  return 0;
}

const char* cpecan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
