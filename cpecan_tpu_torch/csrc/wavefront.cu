// Banded pair-HMM wavefront kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of cpecan_tpu/ops/fb_wavefront.py on the
// batch path:
//   wavefront_fwd <- _fwd_kernel (fb_wavefront.py:235), fresh, phase 0,
//                    launched by _fb_wavefront_jit (fb_wavefront.py:1059)
//   wavefront_bwd <- _bwd_kernel (fb_wavefront.py:404), batch, no carries,
//                    launched by _fb_wavefront_jit (fb_wavefront.py:1256)
// and computes what those bodies compute; the plain PyTorch versions
// (cpecan_tpu_torch/ops/fb_wavefront.py fwd_reference / bwd_reference)
// follow the same arithmetic and are the kernels' oracle.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlotsPerThread = 4;
constexpr int kMaxThreads = 1024;
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

template <int S>
__global__ void __launch_bounds__(kMaxThreads) wavefront_bwd(
    const Trans tr, const float* __restrict__ efx, const float* __restrict__ efy,
    const float* __restrict__ efm, const float* __restrict__ em, const float* __restrict__ F,
    const float* __restrict__ bv, const int8_t* __restrict__ abw, const int8_t* __restrict__ c1,
    const int8_t* __restrict__ c0, const int8_t* __restrict__ bm1,
    const int8_t* __restrict__ bm0, const int8_t* __restrict__ pm,
    const float* __restrict__ end_row, float* __restrict__ post_m, float* __restrict__ post_x,
    float* __restrict__ post_y, float* __restrict__ mb, float* __restrict__ tot, int R, int W) {
  extern __shared__ float smem[];
  __shared__ float red[3][32];
  float* b1s = smem;              // B_{k+1} (S, W)
  float* b2s = smem + S * W;      // B_{k+2} (S, W)
  float* bvn = smem + 2 * S * W;  // bridgevec_{k+1} (W)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* T = tr.v;
  const bool all = post_x != nullptr;

  // The recursion starts past the last diagonal from zero carries.
  for (int j = tid; j < S * W; j += nt) {
    b1s[j] = 0.f;
    b2s[j] = 0.f;
  }
  for (int j = tid; j < W; j += nt) bvn[j] = 0.f;
  float emn[kMaxSlotsPerThread];  // em_{k+1} of the thread's own slots
#pragma unroll
  for (int q = 0; q < kMaxSlotsPerThread; ++q) emn[q] = 0.f;
  float invb = 1.f;  // 1/mb_{k+1}
  __syncthreads();

  for (int ii = R - 1; ii >= 0; --ii) {
    const size_t row = (size_t)b * R + ii;
    const bool norm = ii % kNormEvery == kNormEvery - 1;
    const int pm0 = pm[row * W];  // row-constant bits live in every slot
    const bool at_end = (pm0 & kPmAtEnd) != 0;
    const bool bvalid = (pm0 & kPmBridge) != 0;
    // receive from k+1: x-class at j+1-d1, y-class at j-d1; from k+2:
    // m-class at j+1-dsum2; bridge vector at j+dmid_{k+1}
    const bool sabw = abw[row] != 0;
    const int dx = sabw ? 0 : 1;
    const int dy = sabw ? -1 : 0;
    const int dm = c1[row] != 0 ? -1 : (c0[row] != 0 ? 0 : 1);
    const int db = bm1[row] != 0 ? 1 : (bm0[row] != 0 ? 0 : -1);

    float raw[kMaxSlotsPerThread][S];
    float lmax = 0.f;
    float lbr = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSlotsPerThread; ++q) {
      const int j = tid + q * nt;
#pragma unroll
      for (int s = 0; s < S; ++s) raw[q][s] = 0.f;
      if (j < W) {
        const size_t o = row * W + j;
        const float efxj = efx[o];
        const float efyj = efy[o];
        const float efmi = efm[o] * invb;
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
          for (int s = 0; s < S; ++s) raw[q][s] = end_row[((size_t)b * S + s) * W + j];
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

    float Fv[kMaxSlotsPerThread][S];
    float ldot = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSlotsPerThread; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          raw[q][s] *= r;
          Fv[q][s] = F[(row * S + s) * W + j];
          ldot += Fv[q][s] * raw[q][s];
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
      mb[row] = mbv;
      tot[row] = ok ? logf(total) : 0.f;
    }

#pragma unroll
    for (int q = 0; q < kMaxSlotsPerThread; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
        const size_t o = row * W + j;
        const int p = pm[o];
        post_m[o] = (p & kPmMatch) ? Fv[q][0] * raw[q][0] * invt : 0.f;
        if (all) {
          post_x[o] = (p & kPmGapX) ? Fv[q][1] * raw[q][1] * invt : 0.f;
          post_y[o] = (p & kPmGapY) ? Fv[q][2] * raw[q][2] * invt : 0.f;
        }
        // B_k replaces B_{k+2}; B_{k+1} becomes B_{k+2}, zeroed at k == L
#pragma unroll
        for (int s = 0; s < S; ++s) {
          b2s[s * W + j] = raw[q][s];
          if (at_end) b1s[s * W + j] = 0.f;
        }
        bvn[j] = bv[o];
        emn[q] = em[o];
      }
    }
    invb = at_end ? 1.f : r;
    __syncthreads();
    float* tmp = b1s;
    b1s = b2s;
    b2s = tmp;
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
int launch_bwd(const float* t_host, const float* efx, const float* efy, const float* efm,
               const float* em, const float* F, const float* bv, const int8_t* abw,
               const int8_t* c1, const int8_t* c0, const int8_t* bm1, const int8_t* bm0,
               const int8_t* pm, const float* end_row, float* post_m, float* post_x,
               float* post_y, float* mb, float* tot, int B, int R, int W, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)S + 1) * W * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(wavefront_bwd<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wavefront_bwd<S><<<B, threads_for(W), smem, stream>>>(
      load_trans(S, t_host), efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm, end_row,
      post_m, post_x, post_y, mb, tot, R, W);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 5)
    return launch_bwd<5>(t_host, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm, end_row,
                         post_m, post_x, post_y, mb, tot, B, R, W, st);
  return launch_bwd<3>(t_host, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm, end_row,
                       post_m, post_x, post_y, mb, tot, B, R, W, st);
}

const char* cpecan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
