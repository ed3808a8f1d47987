// Banded pair-HMM wavefront kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of cpecan_tpu/ops/fb_wavefront.py on the
// batch path:
//   wavefront_fwd <- _fwd_kernel (fb_wavefront.py:235), fresh, phase 0,
//                    launched by _fb_wavefront_jit (fb_wavefront.py:1059)
//   wavefront_bwd <- _bwd_kernel (fb_wavefront.py:404), batch, no carries,
//                    launched by _fb_wavefront_jit (fb_wavefront.py:1256)
//   wavefront_exp <- _exp_kernel (fb_wavefront.py:592), batch, no carries,
//                    launched by _fb_wavefront_jit (fb_wavefront.py:1195)
// and computes what those bodies compute; the plain PyTorch versions
// (cpecan_tpu_torch/ops/fb_wavefront.py fwd_reference / bwd_reference /
// exp_reference) follow the same arithmetic and are the kernels' oracle.
//
// Layout (batch-major, all contiguous): streams (B, R, W) with R = P+1
// diagonals and W band slots; the forward intermediate F (B, R, S, W);
// row-constant shift selects (B, R) int8; pm (B, R, W) int8; F0 and
// end_row (B, S, W); mf / mb / total (B, R).
//
// Design: one thread block per pair, threads over the W band slots (each
// thread owns up to kMaxSlotsPerThread slots, so W <= 4096). The diagonal
// loop runs inside the block; the carries that persist across grid steps
// in VMEM on the TPU live here in shared memory (F_{k-1}, F_{k-2}; B_{k+1},
// B_{k+2}, bridgevec_{k+1}) and registers (1/m, 1/mb, em_{k+1}). The
// neighbour shifts in {-1, 0, +1} are shared-memory reads of slot j +- 1
// with zero fill outside [0, W), like the Pallas _shift_l/_shift_r. The
// row max (every 4th diagonal) and the per-diagonal dots are block
// reductions (warp shuffles, then one value per warp through shared
// memory). The transition contraction is unrolled at compile time over
// the statically nonzero transitions of the 5-state (13) or 3-state (9)
// structure; transition values arrive as a kernel argument.
//
// What bounds it on the card: per cell the forward writes S floats of F
// and the backward reads them back (S * W * 4 bytes per diagonal each
// way), on top of ~7 emission/mask streams; and each block walks a
// serial chain of R diagonals with two to five barriers per diagonal.
// This simple design keeps every carry on chip, so F and the streams
// are the only device-memory traffic, and it relies on a batch of
// hundreds of pairs (blocks) to hide the serial chain's latency across
// the 132 SMs. Several pairs per block, asynchronous copies of the
// streams and fewer barriers per diagonal are later work.
//
// wavefront_exp (EM's E-step) runs wavefront_bwd's recursion (one
// templated body, backward_body, so mb and total come out the same) and,
// per cell, adds the posterior flow into Baum-Welch expected counts. Its
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

template <int S>
__global__ void __launch_bounds__(kMaxThreads) wavefront_fwd(
    const Trans tr, const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ em, const int8_t* __restrict__ a, const int8_t* __restrict__ b1,
    const int8_t* __restrict__ b0, const float* __restrict__ F0, float* __restrict__ F,
    float* __restrict__ bv, float* __restrict__ mf, int R, int W) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* f1 = smem;          // F_{k-1} (S, W)
  float* f2 = smem + S * W;  // F_{k-2} (S, W)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* T = tr.v;

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
  float invm = 1.f;  // 1/m_{k-1}
  __syncthreads();

  for (int i = 1; i < R; ++i) {
    const size_t row = (size_t)b * R + i;
    const bool norm = i % kNormEvery == kNormEvery - 1;
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
};

// The backward wavefront of one pair (this block's), high to low, with
// the posteriors (kExp false: wavefront_bwd) or the expected counts
// (kExp true: wavefront_exp) of each diagonal. Shared memory: B_{k+1},
// B_{k+2} (S, W) each, bridgevec_{k+1} (W), and for kExp the emission
// accumulators (S * 16, blockDim.x) unless kScratch puts them in p.eacc.
template <int S, int kSlots, bool kExp, bool kScratch = false>
__device__ __forceinline__ void backward_body(const Trans& tr, const BwdArgs& p, int R, int W,
                                              float* smem, float (*red)[32]) {
  float* b1s = smem;              // B_{k+1} (S, W)
  float* b2s = smem + S * W;      // B_{k+2} (S, W)
  float* bvn = smem + 2 * S * W;  // bridgevec_{k+1} (W)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // kExp: (S * 16, nt) emission accumulators; thread tid owns column tid
  float* eacc = kScratch ? p.eacc + (size_t)b * S * 16 * nt : bvn + W;
  const float* T = tr.v;
  const bool all = p.post_x != nullptr;
  constexpr int kNz = Model<S>::kNz;

  // The recursion starts past the last diagonal from zero carries.
  for (int j = tid; j < S * W; j += nt) {
    b1s[j] = 0.f;
    b2s[j] = 0.f;
  }
  for (int j = tid; j < W; j += nt) bvn[j] = 0.f;
  if constexpr (kExp) {
    for (int j = tid; j < S * 16 * nt; j += nt) eacc[j] = 0.f;
  }
  float tacc[kExp ? kNz : 1];
#pragma unroll
  for (int k = 0; k < (kExp ? kNz : 1); ++k) tacc[k] = 0.f;
  float emn[kSlots];  // em_{k+1} of the thread's own slots
#pragma unroll
  for (int q = 0; q < kSlots; ++q) emn[q] = 0.f;
  float invb = 1.f;  // 1/mb_{k+1}
  __syncthreads();

  for (int ii = R - 1; ii >= 0; --ii) {
    const size_t row = (size_t)b * R + ii;
    const bool norm = ii % kNormEvery == kNormEvery - 1;
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

    float Fv[kExp ? 1 : kSlots][S];  // F_k of the thread's slots (posteriors)
    float ldot = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          raw[q][s] *= r;
          const float fv = p.F[(row * S + s) * W + j];
          if constexpr (!kExp) Fv[q][s] = fv;
          ldot += fv * raw[q][s];
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
    // neighbour at j-1+a, upper at j+a) and F_{k-2} (middle at j+dmid),
    // zero below diagonals 1 and 2 (where adj1 / adj2 are zero too)
    const float* F1 = nullptr;
    const float* F2 = nullptr;
    int dl = 0, du = 0, dmf = 0;
    float a1 = 0.f, a2 = 0.f;
    if constexpr (kExp) {
      const bool sa = p.a[row] != 0;
      dl = sa ? 0 : -1;
      du = sa ? 1 : 0;
      dmf = p.b1[row] != 0 ? 1 : (p.b0[row] != 0 ? 0 : -1);
      a1 = p.adj1[row];
      a2 = p.adj2[row];
      if (ii >= 1) F1 = p.F + (row - 1) * S * W;
      if (ii >= 2) F2 = p.F + (row - 2) * S * W;
    }

#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
        const size_t o = row * W + j;
        if constexpr (kExp) {
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
        } else {
          const int pb = p.pm[o];
          p.post_m[o] = (pb & kPmMatch) ? Fv[q][0] * raw[q][0] * invt : 0.f;
          if (all) {
            p.post_x[o] = (pb & kPmGapX) ? Fv[q][1] * raw[q][1] * invt : 0.f;
            p.post_y[o] = (pb & kPmGapY) ? Fv[q][2] * raw[q][2] * invt : 0.f;
          }
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

  if constexpr (kExp) {
    // The pair's counts: transitions by block reductions, emissions by
    // one thread per (state, symbol pair) summing the threads' columns
    // in order. The loop's final barrier precedes these reads.
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
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads)
    wavefront_bwd(const Trans tr, const BwdArgs p, int R, int W) {
  extern __shared__ float smem[];
  __shared__ float red[3][32];
  backward_body<S, kMaxSlotsPerThread, false>(tr, p, R, W, smem, red);
}

template <int S, int kThreads>
__global__ void __launch_bounds__(kThreads)
    wavefront_exp(const Trans tr, const BwdArgs p, int R, int W) {
  extern __shared__ float smem[];
  __shared__ float red[3][32];
  backward_body<S, kExpSlotsPerThread, true, (kThreads > kExpMaxThreads)>(tr, p, R, W, smem,
                                                                        red);
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
               const int8_t* a, const int8_t* b1, const int8_t* b0, const float* F0, float* F,
               float* bv, float* mf, int B, int R, int W, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)S * W * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(wavefront_fwd<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wavefront_fwd<S><<<B, threads_for(W), smem, stream>>>(load_trans(S, t_host), ex, ey, em, a,
                                                        b1, b0, F0, F, bv, mf, R, W);
  return (int)cudaGetLastError();
}

template <int S>
int launch_bwd(const float* t_host, const BwdArgs& p, int B, int R, int W, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)S + 1) * W * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(wavefront_bwd<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wavefront_bwd<S><<<B, threads_for(W), smem, stream>>>(load_trans(S, t_host), p, R, W);
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
  auto kernel = wide ? wavefront_exp<S, kExpWideThreads> : wavefront_exp<S, kExpMaxThreads>;
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

}  // namespace

// C entry points (loaded with ctypes). Each returns the cudaError_t of
// the launch (0 on success); the wrapper raises on anything else.
extern "C" {

int cpecan_wavefront_fwd(int S, const float* t_host, const float* ex, const float* ey,
                         const float* em, const int8_t* a, const int8_t* b1, const int8_t* b0,
                         const float* F0, float* F, float* bv, float* mf, int B, int R, int W,
                         void* stream) {
  if (bad_shape(S, B, R, W)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 5) return launch_fwd<5>(t_host, ex, ey, em, a, b1, b0, F0, F, bv, mf, B, R, W, st);
  return launch_fwd<3>(t_host, ex, ey, em, a, b1, b0, F0, F, bv, mf, B, R, W, st);
}

int cpecan_wavefront_bwd(int S, const float* t_host, const float* efx, const float* efy,
                         const float* efm, const float* em, const float* F, const float* bv,
                         const int8_t* abw, const int8_t* c1, const int8_t* c0,
                         const int8_t* bm1, const int8_t* bm0, const int8_t* pm,
                         const float* end_row, float* post_m, float* post_x, float* post_y,
                         float* mb, float* tot, int B, int R, int W, void* stream) {
  if (bad_shape(S, B, R, W)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  BwdArgs p = {};
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
                         float* emis, float* eacc, float* mb, float* tot, int B, int R, int W,
                         void* stream) {
  if (bad_shape(S, B, R, W) || W > kExpSlotsPerThread * kExpWideThreads)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  BwdArgs p = {};
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

const char* cpecan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
