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
// Two more kernels write the streams those three read:
//   wavefront_prep <- the slot part of _precompute_one
//                    (fb_wavefront.py:865; XLA on the TPU, not Pallas),
//                    for the batch and every window site; see there
//                    (oracle: streams_reference);
//   wavefront_rows <- the row part of _precompute_one (fb_wavefront.py:
//                    874-945) and of its window forms _prep_window
//                    (fb_segmented.py:72) and _prep_one
//                    (fb_parallel.py:96), which writes what
//                    wavefront_prep reads (oracles: rows_reference,
//                    rows_window_reference).
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
// thread owns a few slots: W <= 4096 in the shared-memory variants). The
// diagonal loop runs inside the block; the carries that persist across
// grid steps in VMEM on the TPU live here in shared memory (F_{k-1};
// B_{k+1}, B_{k+2}, bridgevec_{k+1}) and registers (F_{k-2}'s operands,
// 1/m, 1/mb, em_{k+1}). Bands wider than 4096 slots, whose carries do not
// fit in one block's shared memory, run the wide variants: a
// thread-block cluster per pair (wavefront_fwd_cluster, and for bwd and
// exp wavefront_back_cluster), or above its capacity the global-scratch
// kernels (wavefront_fwd_wide, wavefront_back_wide); see there. The neighbour
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
// wavefront_fwd is built for that chain. Per diagonal it has one block
// barrier and no device-memory read on the chain:
//   - two (S, W) rows in shared memory alternate by diagonal; F_{k-2}'s
//     operands (the middle neighbour, the bridge) are taken into registers
//     while F_{k-2} is read as diagonal k-1's neighbour row, so no row is
//     overwritten while another thread may read it;
//   - a rescaled row is stored raw and its scale is applied by the next
//     diagonal's reads (the partial maxima cross the one barrier);
//   - the shift bytes are read a diagonal ahead into registers, the
//     streams a diagonal ahead into a shared-memory stage by each thread's
//     asynchronous copies or (its ring variant, as wavefront_bwd's below,
//     stages of ex, ey, em) D diagonals ahead by TMA;
//   - in the ring variant the producer warp also stores each finished row
//     of F from shared memory with one bulk copy: a row's S * W floats
//     are most of the kernel's device-memory traffic, and as per-thread
//     stores they held the compute threads back at wide bands;
//   - 1, 2 or 4 band slots per thread, the fewest that cover W with at
//     most kFwdThreads threads (above 4 * kFwdThreads, 16 slots on at
//     most 256 threads, whose 255 registers a thread hold 16 slots'
//     operands: 8 slots on 512 threads, at 128 registers, spilled);
//   - it rounds as fwd_reference does, so F, bv and mf are bit-equal.
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
// wavefront_exp (EM's E-step) is wavefront_bwd's recursion plus, per
// cell, the posterior flow into Baum-Welch expected counts, built the same
// way: every device-memory read of a diagonal at the top of its iteration
// (the streams, F rows k, k-1 and k-2, the forward emissions, the symbol
// pair; the row-constant bytes and adj1/adj2 one diagonal ahead), one
// merged block reduction of (row max, bridge, raw dot) and a second
// barrier that rotates the carries. Its mb and total_raw are
// wavefront_bwd's arithmetic, bit for bit where the two launch plans give
// the same threads and slots. Its ring variant holds one diagonal's efx,
// efy, efm, em, bv, ex, ey, F row and wx/wy per stage, at least three
// stages deep: the F rows k-1 and k-2 that the counts read are the next
// two stages, so they cost no extra bytes (rows 0 and 1 of a window read
// the F halo below it directly). At 8 slots per thread (W > 1024) a
// diagonal's operands do not fit in registers: that variant reads the
// recursion's where it uses them and the counts' after the reduction, so
// only the raw row is held across it. The per-transition accumulators (13 or
// 9) live in registers, summed over the thread's slots; the S x 16
// emission accumulators, which the TPU body fills with 16 masked adds per
// state per cell, are a private column per thread indexed by the cell's
// symbol pair (row-major (S*16, threads), so the threads of a warp hit 32
// distinct banks): in shared memory for W <= 2048 (at most 256 compute
// threads of 1, 2, 4 or 8 slots, so the columns leave room for the
// ring), in a device scratch buffer that the caller passes above (at most
// 512 threads, one (S*16, 512) region per block). At the end the block
// reduces its accumulators in a fixed order and writes its pair's (S, S)
// and (S, 4, 4) counts; the batch sum is the caller's. No atomics, so the
// counts are the same from run to run. On top of wavefront_bwd's traffic
// it reads the two forward emission streams and the symbol streams.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <utility>

namespace {

constexpr int kMaxThreads = 1024;
// the shared-memory variants take W <= kMaxWidth, the wide ones any W
constexpr int kMaxWidth = 4096;
constexpr int kFwdThreads = 512;         // wavefront_fwd: 1, 2 or 4 slots up to this
constexpr int kWideThreads = 1024;       // wavefront_fwd_wide, the wide bwd
constexpr int kExpMaxThreads = 256;      // exp: emission columns in shared memory
constexpr int kExpWideThreads = 512;     // exp: columns in the caller's scratch
constexpr int kExpSharedWidth = 2048;    // exp's widest band with columns in shared memory
constexpr int kMaxStages = 4;          // the rings of streams
constexpr int kRingThreads = 480;      // its compute threads beside the producer warp
constexpr size_t kSmemPerBlock = 232448;  // Hopper: 227 KB per block
constexpr size_t kStaticSmem = 1024;      // room for the static shared arrays
constexpr int kNormEvery = 4;
// The cluster kernels (wavefront_fwd_cluster, wavefront_back_cluster):
// CTAs per cluster (the portable most), and the most threads per CTA with
// 2 (fwd and exp) and with 4 band slots per thread (so a slice holds at
// most 4 * kClusterThreads4 slots and the widest band they take is
// kClusterMax times that)
constexpr int kClusterMax = 8;
constexpr int kClusterThreads2 = 512;
constexpr int kClusterThreads4 = 384;

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
  cur[t] = madd<kExact>(cur[t], (c) == 0 ? lo[f] : (c) == 1 ? mid[f] : up[f], \
                        T[((c) * S + (f)) * S + (t)]);
// Backward: raw[from] += term_c[to] * T[c, from, to].
#define CPECAN_BWD_TERM(c, f, t) \
  raw[f] += ((c) == 0 ? bx[t] : (c) == 1 ? bm[t] : by[t]) * T[((c) * S + (f)) * S + (t)];
// Bridge vector: sum over match transitions of F_{k-2}[from] * t_m[from, match].
#define CPECAN_BV_TERM(c, f, t) \
  if ((c) == 1) acc = madd<kExact>(acc, own2[f], T[((c) * S + (f)) * S + (t)]);
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
    const float v = compute_sum(tacc[k], red, nt);                     \
    out[(f) * S + (t)] += v * T[((c) * S + (f)) * S + (t)];            \
    ++k;                                                               \
  }
#define CPECAN_COUNT(c, f, t) +1

// acc + a * b: fused into one rounding, or (kExact) the product and the
// sum each rounded, as the plain versions' separate tensor ops round them.
template <bool kExact>
__device__ __forceinline__ float madd(float acc, float a, float b) {
  if constexpr (kExact) return __fadd_rn(acc, __fmul_rn(a, b));
  return acc + a * b;
}

template <int S> struct Model;

template <> struct Model<5> {
  template <bool kExact>
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
  template <bool kExact>
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
  // Every compute thread (nt of them) calls it; out (S*S) is the caller's.
  static __device__ __forceinline__ void trans(float* out, const float* tacc, float* red,
                                               const float* T, int nt);
};

template <> struct Model<3> {
  template <bool kExact>
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
  template <bool kExact>
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
  // Every compute thread (nt of them) calls it; out (S*S) is the caller's.
  static __device__ __forceinline__ void trans(float* out, const float* tacc, float* red,
                                               const float* T, int nt);
};

// row[j] inside [0, W), zero outside (the Pallas shifts' zero fill).
__device__ __forceinline__ float nb(const float* row, int j, int W) {
  return (j >= 0 && j < W) ? row[j] : 0.f;
}

// row[j] of a row that may be absent (null: zero).
__device__ __forceinline__ float nbz(const float* row, int j, int W) {
  return row ? nb(row, j, W) : 0.f;
}

// 1/total and log(total) of a per-diagonal total, masked as the Pallas
// bodies mask them (cpecan_tpu/ops/fb_wavefront.py:522-533) and as
// _bwd_sweep does: with ok = [total > 0], invt = ok / (total + (1 - ok))
// and log = log(total + (1 - ok)) * ok. A total of 0 gives 0 and 0, inf
// gives 0 and inf, a positive total 1/total and log(total) exactly, and
// NaN gives NaN in both (a select on `total > 0` would write 0).
struct TotalTerms {
  float invt, log;
};

__device__ __forceinline__ TotalTerms total_terms(float total) {
  const float ok = total > 0.f ? 1.f : 0.f;
  return {ok / (total + (1.f - ok)), logf(total + (1.f - ok)) * ok};
}

// max(a, b) that propagates NaN (PTX max.NaN, sm_80+), unlike fmaxf,
// which drops it. Every row max of the kernels is taken with it, from 0:
// a row whose raw values hold a NaN has the max NaN, which `m > 0 ? m :
// 1` maps to the scale 1 (mf / mb 0, the row's values NaN times 1), as
// the JAX package's jnp.max and jnp.where do; a finite row's max is
// fmaxf's, bit for bit.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Block-wide max; blockDim.x is a multiple of 32 and every thread of
// the block calls it. Every thread returns the same value (the
// per-warp partials are combined in one fixed order). `red` holds one
// float per warp and must not be reused before the next block barrier.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) m = max_nan(m, red[k]);
  return m;
}

// The compute threads' own barrier (named barrier 1, n threads): the
// ring variants' producer warp takes no part in the block reductions.
__device__ __forceinline__ void sync_compute(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// Sum over the first nt threads of the block (all of them call it), in
// a fixed order; every caller returns the same value. Ends with a
// barrier, so `red` (one float per warp) may be reused at once.
__device__ __forceinline__ float compute_sum(float v, float* red, int nt) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  sync_compute(nt);
  float s = 0.f;
  for (int k = 0; k < (nt >> 5); ++k) s += red[k];
  sync_compute(nt);
  return s;
}

// ------------------------------------------------------------ the rings
//
// A ring of streams: each stage holds one diagonal's rows of the streams
// a kernel reads, each row one contiguous segment of its (B, R, ...)
// tensor, filled by TMA bulk copies whose bytes land on the stage's
// mbarrier. The four functions below and the three after them (bulk
// copies the other way, from shared to device memory) are the only ones
// that speak to the copy engine.

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

// Bulk copy (TMA) of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared memory into device memory, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory
// (`all`: until they have also been written).
__device__ __forceinline__ void bulk_wait(bool all) {
  if (all)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Asynchronous copy of one float from device into shared memory by this
// thread; cp_async_wait waits for all of this thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Make this thread's writes to shared memory visible to the copy engine.
__device__ __forceinline__ void fence_smem_for_copies() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ------------------------------------------------------------ wavefront_fwd

// Arguments of wavefront_fwd. F0 is the batch path's start row; a window
// of a long pair passes its carry in (F_{k0-1}, F_{k0-2}, 1/m) instead,
// and takes the carry out of its last row when co1 is given.
struct FwdArgs {
  const float* ex;
  const float* ey;
  const float* em;
  const int8_t* a;
  const int8_t* b1;
  const int8_t* b0;
  const float* F0;
  const float* ci1;
  const float* ci2;
  const float* cim;
  float* F;
  float* bv;
  float* mf;
  float* co1;
  float* co2;
  float* com;
  int k0;  // global diagonal of row 0
};

// Its ring stage holds one diagonal's ex, ey and em rows (W floats each).
__host__ __device__ constexpr size_t fwd_stage_bytes(int W) {
  return 3 * (size_t)W * sizeof(float);
}

// Fill `stage` with diagonal `row` (a row of the (B, R) grid): one thread.
__device__ __forceinline__ void fwd_fill(char* stage, uint64_t* bar, const FwdArgs& p,
                                         size_t row, int W) {
  const uint32_t wb = (uint32_t)W * sizeof(float);
  float* d = reinterpret_cast<float*>(stage);
  ring_expect(bar, (uint32_t)fwd_stage_bytes(W));
  ring_copy(d, p.ex + row * W, wb, bar);
  ring_copy(d + W, p.ey + row * W, wb, bar);
  ring_copy(d + 2 * W, p.em + row * W, wb, bar);
}

// The middle neighbour's shift in {-1, 0, 1} from a row's b1/b0 bytes.
__device__ __forceinline__ int mid_shift(int8_t b1, int8_t b0) {
  return b1 != 0 ? 1 : (b0 != 0 ? 0 : -1);
}

// Forward wavefront of one pair (this block's), low to high. The first
// nt threads compute, each owning kSlots band slots j = tid + q * nt;
// kRing adds one producer warp after them, which fills the ring (D
// stages of ex, ey, em) and stores each row F_k that needs no rescale
// from shared memory to F with one bulk copy, so the compute threads
// issue no stores of F but those of rescaled rows. Shared memory: two
// (S, W) rows that alternate by diagonal (diagonal k reads F_{k-1} from
// one and writes F_k into the other), then the ring (kRing) or, in the
// direct-load variant, one stage that each thread fills for its own
// slots with asynchronous copies, the next row as soon as it has read
// the current one.
//
// F_{k-2}, which the middle term and the bridge read, is never read from
// shared memory: when a thread reads its neighbours F_{k-1}[j-1..j+1] on
// diagonal k, it keeps in registers F_{k-1}[j + dm_{k+1}], the middle
// operand of diagonal k+1 (row k+1's shift bytes arrived a diagonal
// earlier), and the bridge of F_{k-1}[j]. No row is then written while
// another thread may still read it, and one block barrier ends each
// diagonal. A row that rescales (every kNormEvery-th) is stored raw, its
// warps' partial maxima go to `red`, and the next diagonal, after the
// barrier, forms the scale r, multiplies its reads of the row by r and
// writes the rescaled row to F (the next rescaled row is kNormEvery
// diagonals on, so one `red` serves). The arithmetic is fwd_reference's
// operation for operation (each product and sum rounded apart, no fused
// multiply-add), so F, bv and mf are its values bit for bit. Every
// device-memory read is issued a diagonal before its use: a (row k+1)
// and b1/b0 (row k+2) into registers, and the streams of row k+1 into
// the stage (direct) or D rows ahead into the ring (kRing).
template <int S, int kSlots, bool kRing, bool kWindow>
__global__ void __launch_bounds__(kRing ? kFwdThreads + 32 : kSlots == 16 ? kMaxWidth / 16
                                                                          : kFwdThreads)
    wavefront_fwd(const Trans tr, const FwdArgs p, int R, int W, int D) {
  extern __shared__ __align__(16) float fwd_smem[];  // 16-byte aligned for the copies
  __shared__ float red[32];                          // per warp: a rescaled row's max
  __shared__ uint64_t bars[kMaxStages];
  float* rd = fwd_smem;          // F_{k-1}, raw: its scale rs is applied on read
  float* wr = fwd_smem + S * W;  // F_k, raw
  char* ring = reinterpret_cast<char*>(fwd_smem + 2 * S * W);
  const size_t sbytes = fwd_stage_bytes(W);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x - (kRing ? 32 : 0);  // compute threads
  const int nw = nt >> 5;
  const float* T = tr.v;
  const int i0 = kWindow ? 0 : 1;  // the first computed row
  const int k0 = kWindow ? p.k0 : 0;
  const size_t base = (size_t)b * R;  // this pair's row 0

  if (kRing && tid >= nt) {
    // The producer warp: stage s starts with row i0 + s; once the block
    // barrier that ends row i has freed its stage, one thread refills it
    // with row i + D and stores row i (unless it awaits its rescale),
    // and waits for that store to have read its row before the next
    // barrier (row i + 2 overwrites it). It meets the compute threads
    // only at the block barriers (one before the loop, one per row).
    const bool lead = tid == nt;
    if (lead) {
      for (int s = 0; s < D; ++s) ring_init(&bars[s]);
      for (int s = 0; s < D && i0 + s < R; ++s)
        fwd_fill(ring + s * sbytes, &bars[s], p, base + i0 + s, W);
    }
    __syncthreads();
    int st = 0;
    for (int i = i0; i < R; ++i) {
      if (lead) bulk_wait(false);
      __syncthreads();
      if (lead) {
        if (i + D < R) fwd_fill(ring + st * sbytes, &bars[st], p, base + i + D, W);
        if ((k0 + i) % kNormEvery != kNormEvery - 1)
          bulk_store(p.F + (base + i) * S * W, fwd_smem + ((i - i0 + 1) & 1) * S * W,
                     (uint32_t)(S * W * sizeof(float)));
      }
      if (++st == D) st = 0;
    }
    if (lead) bulk_wait(true);
    return;
  }

  float mid[kSlots][S];  // F_{k-2}[j + dm_k], the middle operands of row k
  float brg[kSlots];     // sum over match transitions of F_{k-2}[j] * t_m
  if constexpr (kWindow) {
    // every row is computed from the carried F_{k0-1}, F_{k0-2}
    const float* c1 = p.ci1 + (size_t)b * S * W;
    const float* c2 = p.ci2 + (size_t)b * S * W;
    for (int j = tid; j < S * W; j += nt) rd[j] = c1[j];
    const int dm = mid_shift(p.b1[base], p.b0[base]);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      float own[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        mid[q][s] = j < W ? nb(c2 + s * W, j + dm, W) : 0.f;
        own[s] = j < W ? c2[s * W + j] : 0.f;
      }
      brg[q] = Model<S>::template bridge<true>(own, T);
    }
  } else {
    // Row 0 is the start row F0; F_{-1} is zero.
    for (int j = tid; j < W; j += nt) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float v = p.F0[((size_t)b * S + s) * W + j];
        rd[s * W + j] = v;
        p.F[(base * S + s) * W + j] = v;
      }
      p.bv[base * W + j] = 0.f;
    }
    if (tid == 0) p.mf[base] = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      brg[q] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) mid[q][s] = 0.f;
    }
  }
  // Read a diagonal ahead: a of row i, b1/b0 of row i+1, and (direct
  // loads) the thread's streams of row i into the stage.
  int8_t pa = 0, pb1 = 0, pb0 = 0;
  float* stage = reinterpret_cast<float*>(ring);  // direct loads: ex, ey, em (W each)
  if (i0 < R) {
    pa = p.a[base + i0];
    if (i0 + 1 < R) pb1 = p.b1[base + i0 + 1], pb0 = p.b0[base + i0 + 1];
    if constexpr (!kRing) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int j = tid + q * nt;
        const size_t o = (base + i0) * W + j;
        if (j < W) {
          cp_async4(stage + j, p.ex + o);
          cp_async4(stage + W + j, p.ey + o);
          cp_async4(stage + 2 * W + j, p.em + o);
        }
      }
    }
  }
  float invm = kWindow ? p.cim[b] : 1.f;  // 1/m_{k-1}
  float rs = 1.f;                         // the scale of rd's row
  __syncthreads();

  int st = 0;                            // the ring stage of row i
  uint32_t parity = 0;                   // the phase of that stage's barrier
  int phase = (k0 + i0) % kNormEvery;    // of row i in the rescale schedule
  for (int i = i0; i < R; ++i) {
    const size_t row = base + i;
    const bool norm = phase == kNormEvery - 1;
    const bool rescaled = i > i0 && phase == 0;  // row i-1 rescales
    // The reads of a diagonal ago, and those of the next diagonal.
    const bool sa = pa != 0;
    const int dmn = mid_shift(pb1, pb0);  // the middle shift of row i+1
    if (i + 1 < R) pa = p.a[row + 1];
    if (i + 2 < R) pb1 = p.b1[row + 2], pb0 = p.b0[row + 2];
    const float* gx = stage;  // this row's ex, ey, em
    if constexpr (kRing) {
      ring_wait(&bars[st], parity);
      gx = reinterpret_cast<const float*>(ring + st * sbytes);
    } else {
      cp_async_wait();
    }
    // row i-1's rescale, deferred to here
    if (i > i0) {
      rs = 1.f;
      if (rescaled) {
        float m = red[0];
        for (int k = 1; k < nw; ++k) m = max_nan(m, red[k]);
        m = m > 0.f ? m : 1.f;
        rs = 1.f / m;
        if (tid == 0) p.mf[row - 1] = logf(m);
      }
      invm = rs;
    }

    float lmax = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
        // F_{k-1} at j-1, j, j+1, each state: the lower (consumes X) and
        // upper (consumes Y) neighbours are j-1+a and j+a, the next
        // diagonal's middle one j+dm_{k+1}
        float fl[S], fc[S], fr[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          fl[s] = nb(rd + s * W, j - 1, W);
          fc[s] = rd[s * W + j];
          fr[s] = nb(rd + s * W, j + 1, W);
        }
        if (rescaled) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            fl[s] *= rs;
            fc[s] *= rs;
            fr[s] *= rs;
            p.F[((row - 1) * S + s) * W + j] = fc[s];
          }
        }
        const float exj = gx[j];
        const float eyj = gx[W + j];
        const float emi = gx[2 * W + j] * invm;
        float lo[S], mi[S], up[S], cur[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          lo[s] = (sa ? fc[s] : fl[s]) * exj;
          up[s] = (sa ? fr[s] : fc[s]) * eyj;
          mi[s] = mid[q][s] * emi;
          cur[s] = 0.f;
        }
        Model<S>::template fwd<true>(cur, lo, mi, up, T);
        // bridgevec[k] = (sum_f F_{k-2}[f] * t_m[f, match]) / m_{k-1}
        p.bv[row * W + j] = brg[q] * invm;
        if (!kRing && i + 1 < R) {  // this slot's streams of the next row
          const size_t o = (row + 1) * W + j;
          cp_async4(stage + j, p.ex + o);
          cp_async4(stage + W + j, p.ey + o);
          cp_async4(stage + 2 * W + j, p.em + o);
        }
#pragma unroll
        for (int s = 0; s < S; ++s) mid[q][s] = dmn > 0 ? fr[s] : dmn == 0 ? fc[s] : fl[s];
        brg[q] = Model<S>::template bridge<true>(fc, T);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          wr[s * W + j] = cur[s];
          if (norm)
            lmax = max_nan(lmax, cur[s]);
          else if (!kRing)
            p.F[(row * S + s) * W + j] = cur[s];
        }
      }
    }
    if constexpr (kRing) fence_smem_for_copies();  // the producer stores wr
    if (norm) {
      for (int o = 16; o > 0; o >>= 1) lmax = max_nan(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      if ((tid & 31) == 0) red[tid >> 5] = lmax;
    } else if (tid == 0) {
      p.mf[row] = 0.f;
    }
    __syncthreads();
    float* tmp = rd;
    rd = wr;
    wr = tmp;
    phase = norm ? 0 : phase + 1;
    if constexpr (kRing) {
      if (++st == D) {
        st = 0;
        parity ^= 1u;
      }
    }
  }

  // The last row's rescale and the carry out (the loop's final barrier
  // precedes): rd holds F_{R-1} raw, wr F_{R-2} raw with the scale rs.
  if (R - 1 < i0) return;
  float r = 1.f;
  if ((k0 + R - 1) % kNormEvery == kNormEvery - 1) {
    float m = red[0];
    for (int k = 1; k < nw; ++k) m = max_nan(m, red[k]);
    m = m > 0.f ? m : 1.f;
    r = 1.f / m;
    if (tid == 0) p.mf[base + R - 1] = logf(m);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
#pragma unroll
        for (int s = 0; s < S; ++s) p.F[((base + R - 1) * S + s) * W + j] = rd[s * W + j] * r;
      }
    }
  }
  if (kWindow && p.co1 != nullptr) {
    for (int j = tid; j < S * W; j += nt) {
      p.co1[(size_t)b * S * W + j] = rd[j] * r;
      p.co2[(size_t)b * S * W + j] = wr[j] * rs;
    }
    if (tid == 0) p.com[b] = r;
  }
}

__device__ __forceinline__ void Model<5>::trans(float* out, const float* tacc, float* red,
                                                const float* T, int nt) {
  constexpr int S = 5;
  int k = 0;
  CPECAN_NZ5(CPECAN_TRANS_TERM)
}

__device__ __forceinline__ void Model<3>::trans(float* out, const float* tacc, float* red,
                                                const float* T, int nt) {
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
  // wavefront_exp at W > kExpSharedWidth: (B, S*16, kExpWideThreads)
  // emission columns; null otherwise (the columns live in shared memory)
  float* eacc;
  // the wide variants: (B, 3, S, W), the rows B_{k+1}, B_{k+2}, B_k
  float* scratch;
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

// ------------------------------------------------------------ wavefront_bwd
//
// Its ring stage holds one diagonal's efx, efy, efm, em, bv (W floats
// each), F (S, W) and pm (W bytes).

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
          if (norm) lmax = max_nan(lmax, raw[q][s]);
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
      if (norm) lmax = max_nan(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
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
      for (int k = 1; k < nw; ++k) m = max_nan(m, red[0][k]);
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
    const TotalTerms tt = total_terms(total);
    const float invt = tt.invt;
    if (tid == 0) {
      p.mb[row] = mbv;
      p.tot[row] = tt.log;
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

// ------------------------------------------------------------ wavefront_exp
//
// Its ring stage holds one diagonal's efx, efy, efm, em, bv, ex, ey (W
// floats each), F (S, W), wx and wy (W bytes each), each one contiguous
// segment of its (B, R, ...) tensor.

__host__ __device__ constexpr size_t exp_stage_bytes(int S, int W) {
  return (7 + (size_t)S) * W * sizeof(float) + 2 * (size_t)W;
}

// Fill `stage` with diagonal `row` (a row of the (B, R) grid): one thread.
template <int S>
__device__ __forceinline__ void exp_fill(char* stage, uint64_t* bar, const BwdArgs& p,
                                         size_t row, int W) {
  const uint32_t wb = (uint32_t)W * sizeof(float);
  float* d = reinterpret_cast<float*>(stage);
  int8_t* w = reinterpret_cast<int8_t*>(d + (7 + S) * W);
  ring_expect(bar, (uint32_t)exp_stage_bytes(S, W));
  ring_copy(d, p.efx + row * W, wb, bar);
  ring_copy(d + W, p.efy + row * W, wb, bar);
  ring_copy(d + 2 * W, p.efm + row * W, wb, bar);
  ring_copy(d + 3 * W, p.em + row * W, wb, bar);
  ring_copy(d + 4 * W, p.bv + row * W, wb, bar);
  ring_copy(d + 5 * W, p.ex + row * W, wb, bar);
  ring_copy(d + 6 * W, p.ey + row * W, wb, bar);
  ring_copy(d + 7 * W, p.F + row * S * W, S * wb, bar);
  ring_copy(w, p.wx + row * W, (uint32_t)W, bar);
  ring_copy(w + W, p.wy + row * W, (uint32_t)W, bar);
}

// The row constants of one diagonal for wavefront_exp: the backward and
// forward shift selects, pm's row bits (at_end, bridge) and the scale
// adjustments of the neighbour F rows.
struct ExpRow {
  int8_t abw, c1, c0, bm1, bm0, a, b1, b0, pm0;
  float adj1, adj2;
};

__device__ __forceinline__ ExpRow exp_row(const BwdArgs& p, size_t row, int W) {
  return {p.abw[row], p.c1[row], p.c0[row], p.bm1[row], p.bm0[row], p.a[row],
          p.b1[row],  p.b0[row], p.pm[row * W], p.adj1[row], p.adj2[row]};
}

// Backward wavefront of one pair (this block's), high to low, with the
// expected counts of each diagonal. The first nt threads compute, each
// owning kSlots band slots j = tid + q * nt; kRing adds one producer warp
// after them, which fills the ring (D >= 3 stages). Shared memory:
// B_{k+1}, B_{k+2} (S, W) each, bridgevec_{k+1} (W), the D ring stages,
// then the (S * 16, nt) emission columns unless p.eacc holds them. Per
// diagonal: every device-memory read at the top (kRing: the producer
// issued the streams D diagonals earlier; the row constants come one
// diagonal earlier into registers), one block reduction of (row max,
// bridge, F.B dot) with the compute threads' barrier, then the counts
// and the new carries, and the block barrier that rotates them and frees
// the diagonal's stage.
template <int S, int kSlots, bool kRing, bool kWindow>
__global__ void __launch_bounds__(kRing ? kExpMaxThreads + 32
                                          : kSlots == 8 ? kExpWideThreads : kExpMaxThreads)
    wavefront_exp(const Trans tr, const BwdArgs p, int R, int W, int D) {
  extern __shared__ __align__(16) float exp_smem[];  // 16-byte aligned for the copies
  __shared__ float red[3][32];                       // per warp: row max, bridge, dot
  __shared__ uint64_t bars[kMaxStages];
  float* smem = exp_smem;
  float* b1s = smem;              // B_{k+1} (S, W)
  float* b2s = smem + S * W;      // B_{k+2} (S, W)
  float* bvn = smem + 2 * S * W;  // bridgevec_{k+1} (W)
  char* ring = reinterpret_cast<char*>(smem + (2 * S + 1) * W);
  const size_t sbytes = exp_stage_bytes(S, W);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x - (kRing ? 32 : 0);  // compute threads
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const float* T = tr.v;
  constexpr int kNz = Model<S>::kNz;
  // 8 slots: a diagonal's loads do not fit in registers. The recursion's
  // operands are read where they are used, the counts' after the reduction.
  constexpr bool kLate = kSlots > 4;
  // (S * 16, nt) emission accumulators; thread tid owns column tid
  float* eacc = p.eacc ? p.eacc + (size_t)b * S * 16 * nt
                       : reinterpret_cast<float*>(ring + (kRing ? D * sbytes : 0));

  if (kRing && tid >= nt) {
    // The producer warp: stage s starts with diagonal R-1-s; once the
    // block barrier that ends diagonal ii has freed its stage, one thread
    // refills it with diagonal ii-D. It meets the compute threads only at
    // the block barriers (one before the loop, one per diagonal).
    if (tid == nt) {
      for (int s = 0; s < D; ++s) ring_init(&bars[s]);
      for (int s = 0; s < D && s < R; ++s)
        exp_fill<S>(ring + s * sbytes, &bars[s], p, (size_t)b * R + R - 1 - s, W);
    }
    __syncthreads();
    int st = 0;
    for (int ii = R - 1; ii >= 0; --ii) {
      __syncthreads();
      if (tid == nt && ii >= D)
        exp_fill<S>(ring + st * sbytes, &bars[st], p, (size_t)b * R + ii - D, W);
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
  // F rows k0-2 and k0-1 below a window (the neighbours of its rows 0 and
  // 1); the batch path has none (adj1 / adj2 are zero there)
  const float* halo = (kWindow && p.fhc) ? p.fhc + (size_t)b * 2 * S * W : nullptr;
  ExpRow next = exp_row(p, (size_t)b * R + R - 1, W);
  __syncthreads();

  int st = 0;           // the ring stage of diagonal ii
  uint32_t parity = 0;  // the phase of that stage's barrier
  for (int ii = R - 1; ii >= 0; --ii) {
    const size_t row = (size_t)b * R + ii;
    const bool norm = ((kWindow ? p.k0 : 0) + ii) % kNormEvery == kNormEvery - 1;

    // Every device-memory read of this diagonal, before its first barrier.
    const ExpRow rb = next;
    if (ii >= 1) next = exp_row(p, row - 1, W);
    const float *gx, *gy, *gm, *ge, *gb, *gex, *gey, *gF;
    const float* gF1 = nullptr;  // F_{k-1}
    const float* gF2 = nullptr;  // F_{k-2}
    const int8_t *gwx, *gwy;
    if constexpr (kRing) {
      // diagonals ii-1 and ii-2 sit in the next two stages (D >= 3)
      const int st1 = st + 1 == D ? 0 : st + 1;
      const int st2 = st1 + 1 == D ? 0 : st1 + 1;
      const uint32_t par1 = st1 == 0 ? parity ^ 1u : parity;
      const uint32_t par2 = st2 == 0 ? par1 ^ 1u : par1;
      ring_wait(&bars[st], parity);
      gx = reinterpret_cast<const float*>(ring + st * sbytes);
      if (ii >= 1) {
        ring_wait(&bars[st1], par1);
        gF1 = reinterpret_cast<const float*>(ring + st1 * sbytes) + 7 * W;
      }
      if (ii >= 2) {
        ring_wait(&bars[st2], par2);
        gF2 = reinterpret_cast<const float*>(ring + st2 * sbytes) + 7 * W;
      }
      gy = gx + W, gm = gx + 2 * W, ge = gx + 3 * W, gb = gx + 4 * W;
      gex = gx + 5 * W, gey = gx + 6 * W, gF = gx + 7 * W;
      gwx = reinterpret_cast<const int8_t*>(gx + (7 + S) * W);
      gwy = gwx + W;
    } else {
      gx = p.efx + row * W, gy = p.efy + row * W, gm = p.efm + row * W;
      ge = p.em + row * W, gb = p.bv + row * W, gex = p.ex + row * W;
      gey = p.ey + row * W, gF = p.F + row * S * W;
      gwx = p.wx + row * W, gwy = p.wy + row * W;
      if (ii >= 1) gF1 = p.F + (row - 1) * S * W;
      if (ii >= 2) gF2 = p.F + (row - 2) * S * W;
    }
    if (ii < 2 && halo) {
      if (ii == 0) gF1 = halo + S * W;
      gF2 = halo + ii * S * W;
    }

    const bool at_end = (rb.pm0 & kPmAtEnd) != 0;
    const bool bvalid = (rb.pm0 & kPmBridge) != 0;
    // receive from k+1: x-class at j+1-d1, y-class at j-d1; from k+2:
    // m-class at j+1-dsum2; bridge vector at j+dmid_{k+1}
    const int dx = rb.abw != 0 ? 0 : 1;
    const int dy = rb.abw != 0 ? -1 : 0;
    const int dm = rb.c1 != 0 ? -1 : (rb.c0 != 0 ? 0 : 1);
    const int db = rb.bm1 != 0 ? 1 : (rb.bm0 != 0 ? 0 : -1);
    // the counts' forward neighbours: F_{k-1} lower at j-1+a, upper at
    // j+a; F_{k-2} middle at j+dmid
    const int dl = rb.a != 0 ? 0 : -1;
    const int du = rb.a != 0 ? 1 : 0;
    const int dmf = rb.b1 != 0 ? 1 : (rb.b0 != 0 ? 0 : -1);

    // the cell's symbol pair 4 * x + y, or -1 (N, sentinel)
    auto symbols = [&](int j) {
      const int sx = gwx[j], sy = gwy[j];
      return (sx < 4 && sy < 4) ? sx * 4 + sy : -1;
    };
    float vx[kSlots], vy[kSlots], vm[kSlots], ve[kSlots], vb[kSlots], vex[kSlots], vey[kSlots];
    float vF[kSlots][S], lo[kSlots][S], up[kSlots][S], mid[kSlots][S];
    int vw[kSlots];
    if constexpr (!kLate) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int j = tid + q * nt;
        const bool in = j < W;
        vx[q] = in ? gx[j] : 0.f;
        vy[q] = in ? gy[j] : 0.f;
        vm[q] = in ? gm[j] : 0.f;
        ve[q] = in ? ge[j] : 0.f;
        vb[q] = in ? gb[j] : 0.f;
        vex[q] = in ? gex[j] : 0.f;
        vey[q] = in ? gey[j] : 0.f;
        vw[q] = in ? symbols(j) : -1;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          vF[q][s] = in ? gF[s * W + j] : 0.f;
          lo[q][s] = (in && gF1) ? nb(gF1 + s * W, j + dl, W) : 0.f;
          up[q][s] = (in && gF1) ? nb(gF1 + s * W, j + du, W) : 0.f;
          mid[q][s] = (in && gF2) ? nb(gF2 + s * W, j + dmf, W) : 0.f;
        }
      }
    }

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
        const float efmi = (kLate ? gm[j] : vm[q]) * invb;
        const float fx = kLate ? gx[j] : vx[q];
        const float fy = kLate ? gy[j] : vy[q];
        float bx[S], bm[S], by[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          bx[s] = nb(b1s + s * W, j + dx, W) * fx;
          by[s] = nb(b1s + s * W, j + dy, W) * fy;
          bm[s] = nb(b2s + s * W, j + dm, W) * efmi;
        }
        Model<S>::bwd(raw[q], bx, bm, by, T);
        if (at_end) {
#pragma unroll
          for (int s = 0; s < S; ++s) raw[q][s] = p.end_row[((size_t)b * S + s) * W + j];
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (norm) lmax = max_nan(lmax, raw[q][s]);
          ldot += (kLate ? gF[s * W + j] : vF[q][s]) * raw[q][s];
        }
        lbr += nb(bvn, j + db, W) * emn[q] * b1s[j];
      }
    }

    // One block reduction of (row max, bridge, dot), as wavefront_bwd's.
    // Its barrier also follows every read of the carries for this
    // diagonal, so they may be rotated in place below.
    for (int o = 16; o > 0; o >>= 1) {
      if (norm) lmax = max_nan(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
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
      for (int k = 1; k < nw; ++k) m = max_nan(m, red[0][k]);
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
    const TotalTerms tt = total_terms(total);
    const float invt = tt.invt;
    if (tid == 0) {
      p.mb[row] = mbv;
      p.tot[row] = tt.log;
    }

#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = tid + q * nt;
      if (j < W) {
        const float emj = kLate ? ge[j] : ve[q];
        const float exa = (kLate ? gex[j] : vex[q]) * rb.adj1;
        const float eya = (kLate ? gey[j] : vey[q]) * rb.adj1;
        const float ema = emj * rb.adj2;
        float bk[S], l[S], m[S], u[S], bw[S], qv[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          bk[s] = raw[q][s] * r;  // B_k, exactly the rescaled row mb records
          l[s] = (kLate ? nbz(gF1 ? gF1 + s * W : nullptr, j + dl, W) : lo[q][s]) * exa;
          u[s] = (kLate ? nbz(gF1 ? gF1 + s * W : nullptr, j + du, W) : up[q][s]) * eya;
          m[s] = (kLate ? nbz(gF2 ? gF2 + s * W : nullptr, j + dmf, W) : mid[q][s]) * ema;
          bw[s] = bk[s] * invt;
          qv[s] = 0.f;
        }
        Model<S>::exp(tacc, qv, l, m, u, bw, T);
        const int w = kLate ? symbols(j) : vw[q];
        if (w >= 0) {
          float* col = eacc + w * nt + tid;
#pragma unroll
          for (int s = 0; s < S; ++s) col[s * 16 * nt] += qv[s] * bw[s];
        }
        // B_k replaces B_{k+2}; B_{k+1} becomes B_{k+2}, zeroed at k == L
#pragma unroll
        for (int s = 0; s < S; ++s) {
          b2s[s * W + j] = bk[s];
          if (at_end) b1s[s * W + j] = 0.f;
        }
        bvn[j] = kLate ? gb[j] : vb[q];
        emn[q] = emj;
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

  // The pair's counts: transitions by block reductions, emissions by one
  // thread per (state, symbol pair) summing the threads' columns in
  // order. The loop's final barrier precedes these reads.
  float out[S * S];
#pragma unroll
  for (int k = 0; k < S * S; ++k) out[k] = 0.f;
  Model<S>::trans(out, tacc, red[0], T, nt);
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

// ------------------------------------------------------------ wide bands
//
// Bands wider than kMaxWidth: their carries (2 S W floats and more) do not
// fit in shared memory beside anything else. The wide variants keep the
// block per pair and the diagonal loop, and move the carries to device
// memory, where they stay in L2 (a few hundred KB per block):
//   - wavefront_fwd_wide reads F_{k-1} and F_{k-2} back from its own F
//     output (a window's first two rows from the carry in);
//   - wavefront_back_wide (bwd, and exp with kExp) rotates B_{k+1},
//     B_{k+2} and the new row B_k through three (S, W) rows of a scratch
//     region per block that the caller passes, and reads bridgevec_{k+1}
//     and em_{k+1} from the streams of row k+1 (the window's top row from
//     the carry in).
// Threads loop over their slots at run time (j = tid, tid + nt, ...; no
// register array sized by W). A diagonal writes its raw row, the block
// reduction (row max; bwd and exp also bridge and dot) follows, then each
// thread rescales its own slots in place, and a block barrier ends the
// diagonal. The arithmetic is that of the shared-memory variants: the
// same rescale schedule, mf / mb exactly the applied scale, nb()'s zero
// fill; wavefront_fwd_wide rounds as fwd_reference does (F, bv, mf bit
// for bit). Simple kernels that are right: their speed is not worked on.
// Each is the declared route only above the capacity of its cluster
// kernel (below: wavefront_fwd_cluster, wavefront_back_cluster), which
// does its work on chip.

template <int S, bool kWindow>
__global__ void __launch_bounds__(kWideThreads) wavefront_fwd_wide(
    const Trans tr, const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ em, const int8_t* __restrict__ a, const int8_t* __restrict__ b1,
    const int8_t* __restrict__ b0, const float* __restrict__ F0, const float* __restrict__ ci1,
    const float* __restrict__ ci2, const float* __restrict__ cim, float* __restrict__ F,
    float* __restrict__ bv, float* __restrict__ mf, float* __restrict__ co1,
    float* __restrict__ co2, float* __restrict__ com, int R, int W, int k0) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* T = tr.v;
  const size_t SW = (size_t)S * W;
  float* Fb = F + (size_t)b * R * SW;  // this pair's F rows

  float invm = 1.f;  // 1/m_{k-1}
  if constexpr (kWindow) {
    invm = cim[b];
  } else {
    // Diagonal 0 is the start row F0; F_{-1} is zero.
    for (int j = tid; j < W; j += nt) {
      for (int s = 0; s < S; ++s) Fb[s * W + j] = F0[((size_t)b * S + s) * W + j];
      bv[(size_t)b * R * W + j] = 0.f;
    }
    if (tid == 0) mf[(size_t)b * R] = 0.f;
  }
  __syncthreads();

  for (int i = kWindow ? 0 : 1; i < R; ++i) {
    const size_t row = (size_t)b * R + i;
    const bool norm = ((kWindow ? k0 : 0) + i) % kNormEvery == kNormEvery - 1;
    const bool sa = a[row] != 0;
    const int dl = sa ? 0 : -1;
    const int du = sa ? 1 : 0;
    const int dm = b1[row] != 0 ? 1 : (b0[row] != 0 ? 0 : -1);
    // F_{k-1}, F_{k-2}: this pair's rows, below a window its carry in,
    // below the batch path's row 0 zero
    const float* f1 = i >= 1 ? Fb + (i - 1) * SW : ci1 + b * SW;
    const float* f2 = i >= 2 ? Fb + (i - 2) * SW
                      : kWindow ? (i == 1 ? ci1 : ci2) + b * SW : nullptr;
    float* out = Fb + i * SW;

    float lmax = 0.f;
    for (int j = tid; j < W; j += nt) {
      const size_t o = row * W + j;
      const float exj = ex[o];
      const float eyj = ey[o];
      const float emi = em[o] * invm;
      float lo[S], mid[S], up[S], own2[S], cur[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        lo[s] = nb(f1 + s * W, j + dl, W) * exj;
        up[s] = nb(f1 + s * W, j + du, W) * eyj;
        mid[s] = nbz(f2 ? f2 + s * W : nullptr, j + dm, W) * emi;
        own2[s] = f2 ? f2[s * W + j] : 0.f;
        cur[s] = 0.f;
      }
      Model<S>::template fwd<true>(cur, lo, mid, up, T);
      // bridgevec[k] = (sum_f F_{k-2}[f] * t_m[f, match]) / m_{k-1}
      bv[o] = Model<S>::template bridge<true>(own2, T) * invm;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        out[s * W + j] = cur[s];
        if (norm) lmax = max_nan(lmax, cur[s]);
      }
    }

    float r = 1.f;
    if (norm) {
      float m = block_max(lmax, red);
      m = m > 0.f ? m : 1.f;
      r = 1.f / m;
      if (tid == 0) mf[row] = logf(m);
      for (int j = tid; j < W; j += nt) {
#pragma unroll
        for (int s = 0; s < S; ++s) out[s * W + j] *= r;
      }
    } else if (tid == 0) {
      mf[row] = 0.f;
    }
    __syncthreads();  // row i is final; the next diagonal reads it
    invm = r;
  }

  // carry out of the last row (the loop's final barrier precedes)
  if (kWindow && co1 != nullptr) {
    const float* f1 = Fb + (R - 1) * SW;
    const float* f2 = R >= 2 ? Fb + (R - 2) * SW : ci1 + b * SW;
    for (int j = tid; j < S * W; j += nt) {
      co1[b * SW + j] = f1[j];
      co2[b * SW + j] = f2[j];
    }
    if (tid == 0) com[b] = invm;
  }
}

// The backward wavefront of one pair for bands of any width: bwd's
// posteriors, or (kExp) exp's expected counts with the emission columns
// in p.eacc (S * 16, nt) per block.
template <int S, bool kExp, bool kWindow>
__global__ void __launch_bounds__(kExp ? kExpWideThreads : kWideThreads)
    wavefront_back_wide(const Trans tr, const BwdArgs p, int R, int W) {
  __shared__ float red[3][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const float* T = tr.v;
  const size_t SW = (size_t)S * W;
  const bool all = p.post_x != nullptr;
  // B_{k+1}, B_{k+2} and the new row B_k rotate through three rows
  float* buf = p.scratch + (size_t)b * 3 * SW;
  int i1 = 0, i2 = 1, i0 = 2;
  constexpr int kNz = kExp ? Model<S>::kNz : 1;
  float* eacc = kExp ? p.eacc + (size_t)b * S * 16 * nt : nullptr;

  constexpr bool carry = kWindow;
  for (size_t j = tid; j < SW; j += nt) {
    buf[j] = carry ? p.ci_b1[b * SW + j] : 0.f;
    buf[SW + j] = carry ? p.ci_b2[b * SW + j] : 0.f;
  }
  if constexpr (kExp) {
    for (int j = tid; j < S * 16 * nt; j += nt) eacc[j] = 0.f;
  }
  float tacc[kNz];
#pragma unroll
  for (int k = 0; k < kNz; ++k) tacc[k] = 0.f;
  float invb = carry ? p.ci_invb[b] : 1.f;  // 1/mb_{k+1}
  const float* halo = (kExp && kWindow && p.fhc) ? p.fhc + (size_t)b * 2 * SW : nullptr;
  __syncthreads();

  for (int ii = R - 1; ii >= 0; --ii) {
    const size_t row = (size_t)b * R + ii;
    const bool norm = ((kWindow ? p.k0 : 0) + ii) % kNormEvery == kNormEvery - 1;
    const int pm0 = p.pm[row * W];  // row-constant bits live in every slot
    const bool at_end = (pm0 & kPmAtEnd) != 0;
    const bool bvalid = (pm0 & kPmBridge) != 0;
    const bool sabw = p.abw[row] != 0;
    const int dx = sabw ? 0 : 1;
    const int dy = sabw ? -1 : 0;
    const int dm = p.c1[row] != 0 ? -1 : (p.c0[row] != 0 ? 0 : 1);
    const int db = p.bm1[row] != 0 ? 1 : (p.bm0[row] != 0 ? 0 : -1);
    float* b1 = buf + i1 * SW;
    float* b2 = buf + i2 * SW;
    float* bn = buf + i0 * SW;
    // bridgevec_{k+1} and em_{k+1}: row k+1's streams, or the carry in
    // (zero past the batch path's last diagonal)
    const float* bvr = ii + 1 < R ? p.bv + (row + 1) * W : carry ? p.ci_bv + (size_t)b * W : nullptr;
    const float* emr = ii + 1 < R ? p.em + (row + 1) * W : carry ? p.ci_em + (size_t)b * W : nullptr;

    float lmax = 0.f, lbr = 0.f, ldot = 0.f;
    for (int j = tid; j < W; j += nt) {
      const size_t o = row * W + j;
      const float efmi = p.efm[o] * invb;
      float bx[S], bm[S], by[S], raw[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        bx[s] = nb(b1 + s * W, j + dx, W) * p.efx[o];
        by[s] = nb(b1 + s * W, j + dy, W) * p.efy[o];
        bm[s] = nb(b2 + s * W, j + dm, W) * efmi;
        raw[s] = 0.f;
      }
      Model<S>::bwd(raw, bx, bm, by, T);
      if (at_end) {
#pragma unroll
        for (int s = 0; s < S; ++s) raw[s] = p.end_row[((size_t)b * S + s) * W + j];
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (norm) lmax = max_nan(lmax, raw[s]);
        ldot += p.F[(row * S + s) * W + j] * raw[s];
        bn[s * W + j] = raw[s];
      }
      lbr += nbz(bvr, j + db, W) * (emr ? emr[j] : 0.f) * b1[j];
    }

    for (int o = 16; o > 0; o >>= 1) {
      if (norm) lmax = max_nan(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      lbr += __shfl_xor_sync(0xffffffffu, lbr, o);
      ldot += __shfl_xor_sync(0xffffffffu, ldot, o);
    }
    if (lane == 0) {
      red[0][warp] = lmax;
      red[1][warp] = lbr;
      red[2][warp] = ldot;
    }
    __syncthreads();  // also: every read of b1 / b2 for this diagonal is done
    float r = 1.f;
    float mbv = 0.f;
    if (norm) {
      float m = red[0][0];
      for (int k = 1; k < nw; ++k) m = max_nan(m, red[0][k]);
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
    const TotalTerms tt = total_terms(total);
    const float invt = tt.invt;
    if (tid == 0) {
      p.mb[row] = mbv;
      p.tot[row] = tt.log;
    }

    // exp: the forward neighbours of the counts (see wavefront_exp)
    const int dl = kExp && p.a[row] == 0 ? -1 : 0;
    const int du = dl + 1;
    const int dmf = !kExp ? 0 : p.b1[row] != 0 ? 1 : (p.b0[row] != 0 ? 0 : -1);
    const float a1 = kExp ? p.adj1[row] : 0.f;
    const float a2 = kExp ? p.adj2[row] : 0.f;
    const float* F1 = nullptr;
    const float* F2 = nullptr;
    if constexpr (kExp) {
      if (ii >= 1) F1 = p.F + (row - 1) * SW;
      else if (halo) F1 = halo + SW;
      if (ii >= 2) F2 = p.F + (row - 2) * SW;
      else if (halo) F2 = halo + ii * SW;
    }
    for (int j = tid; j < W; j += nt) {
      const size_t o = row * W + j;
      float bk[S];  // B_k, exactly the rescaled row mb records
#pragma unroll
      for (int s = 0; s < S; ++s) {
        bk[s] = bn[s * W + j] * r;
        bn[s * W + j] = bk[s];
      }
      if constexpr (kExp) {
        const float exa = p.ex[o] * a1;
        const float eya = p.ey[o] * a1;
        const float ema = p.em[o] * a2;
        float lo[S], mid[S], up[S], bw[S], qv[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          lo[s] = nbz(F1 ? F1 + s * W : nullptr, j + dl, W) * exa;
          up[s] = nbz(F1 ? F1 + s * W : nullptr, j + du, W) * eya;
          mid[s] = nbz(F2 ? F2 + s * W : nullptr, j + dmf, W) * ema;
          bw[s] = bk[s] * invt;
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
        const float* Fo = p.F + row * SW + j;
        p.post_m[o] = (pb & kPmMatch) ? Fo[0] * bk[0] * invt : 0.f;
        if (all) {
          p.post_x[o] = (pb & kPmGapX) ? Fo[W] * bk[1] * invt : 0.f;
          p.post_y[o] = (pb & kPmGapY) ? Fo[2 * W] * bk[2] * invt : 0.f;
        }
      }
      // B_{k+1} becomes B_{k+2}, zeroed at k == L
      if (at_end) {
#pragma unroll
        for (int s = 0; s < S; ++s) b1[s * W + j] = 0.f;
      }
    }
    invb = at_end ? 1.f : r;
    __syncthreads();
    const int t = i2;
    i2 = i1;
    i1 = i0;
    i0 = t;
  }

  // carry out of row 0 (the loop's final barrier precedes)
  if (kWindow && p.co_b1 != nullptr) {
    for (size_t j = tid; j < SW; j += nt) {
      p.co_b1[b * SW + j] = buf[i1 * SW + j];
      p.co_b2[b * SW + j] = buf[i2 * SW + j];
    }
    for (int j = tid; j < W; j += nt) {
      p.co_bv[(size_t)b * W + j] = p.bv[(size_t)b * R * W + j];
      p.co_em[(size_t)b * W + j] = p.em[(size_t)b * R * W + j];
    }
    if (tid == 0) p.co_invb[b] = invb;
  }

  if constexpr (kExp) {
    float out[S * S];
#pragma unroll
    for (int k = 0; k < S * S; ++k) out[k] = 0.f;
    Model<S>::trans(out, tacc, red[0], T, nt);
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

// ------------------------------------------------------------ clusters
//
// wavefront_back_cluster: wavefront_back_wide's work (bwd, and exp with
// kExp) for bands wider than kMaxWidth, on a thread-block cluster of C
// CTAs per pair that keeps B on chip. The global-scratch kernel above was
// bound by one SM per pair and an L2 round trip for every neighbour read
// of B (17 and 32 us per diagonal at W = 4352); here C SMs share a pair,
// and no row of B leaves shared memory but the window's carries.
//   - CTA r of a pair's cluster owns the slots [r * Wc, (r + 1) * Wc),
//     K (2 or 4) of them per thread (j = r * Wc + tid + q * nt). Its
//     shared memory holds three (S, Wc) rows of raw B, the rows of
//     diagonals k, k+1 and k+2 by k mod 3.
//   - The neighbour shifts are in {-1, 0, +1}: a slot at the slice's edge
//     reads the one slot past it from the peer's row through distributed
//     shared memory (mapa), zero outside [0, W) as nb() fills.
//   - Rows are stored raw; every reader multiplies by the row's scale
//     (raw * r, the same fp32 product the other kernels store, so B is
//     their B bit for bit). All CTAs hold every scale, so a peer scales
//     a halo value itself, and no barrier separates the rescale from the
//     next diagonal's reads. The at_end zeroing of B_{k+1} is a flag on
//     the row's reads (z2) for the same reason.
//   - The per-diagonal reduction (row max, bridge, F . B dot): each warp
//     reduces its slots by shuffles, and lanes 0..C-1 store the warp's
//     three partials into slot (r, warp) of every CTA's partial array,
//     double-buffered by diagonal parity. After the one cluster barrier of
//     the diagonal every thread sums the C * nw partials in (rank, warp)
//     order, so all CTAs hold the same total, r and 1/total bit for bit;
//     rank 0 writes mb and total_raw.
//   - One cluster barrier per diagonal (arrive.release, wait.acquire).
//     Three rows and two partial buffers make it the only one: a row or a
//     partial slot is written again only two or three diagonals on, after
//     every reader has arrived at a later barrier. exp issues the count
//     operands' loads (F_{k-1}, F_{k-2} neighbours, ex, ey, the symbols)
//     between arrive and wait.
//   - exp's counts stay on chip: per-transition accumulators in registers,
//     the S x 16 emission bins as a column per thread in shared memory.
//     At the end each CTA reduces its own in a fixed order, and rank 0
//     sums the C CTAs' counts in rank order through distributed shared
//     memory and writes trans / emis. No atomics.
// The streams are read from device memory, each CTA its own slice plus
// one edge slot: the row-constant bits and (but in exp at 4 slots, short
// of registers) efx, efy, efm a diagonal ahead, while the cluster meets,
// the rest at the top of the diagonal, every load issued before any is
// used, so that a diagonal waits for device memory once, not once per
// slot. The arithmetic is the other kernels': the same rescale
// schedule, mb exactly the applied scale, nb()'s zero fill, total_terms.
// The dot and bridge are summed over another partition of the slots than
// the global-scratch kernel's, so total_raw and the posteriors agree with
// it within fp32 rounding (mb, a max, is its value bit for bit).

// Generic address of the same shared-memory location in CTA `rank` of
// this CTA's cluster (distributed shared memory).
template <class T>
__device__ __forceinline__ T* cluster_map(T* ptr, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(ptr), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// The cluster barrier, split: every thread of every CTA of the cluster
// arrives (its earlier writes, shared and distributed, released) and
// later waits (the others' writes acquired).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// A CTA's (S, Wc) row `buf` of raw B and its two neighbours' (null at the
// cluster's ends): the value at local slot l (-1 .. Wc) and global slot
// jg = base + l, zero outside [0, W).
template <int S>
struct ClusterRows {
  const float* own;
  const float* left;
  const float* right;
  int Wc, W;
  __device__ __forceinline__ float at(int buf, int s, int l, int jg) const {
    if (jg < 0 || jg >= W) return 0.f;
    const int o = (buf * S + s) * Wc;
    if (l < 0) return left[o + Wc - 1];
    if (l >= Wc) return right[o];
    return own[o + l];
  }
};

// Dynamic shared memory of wavefront_back_cluster: the three raw rows,
// the partials [2][C * nw] (float4), and for exp the emission columns
// (S*16, nt), 32 floats for the block sums and the CTA's counts.
__host__ __device__ constexpr size_t cluster_smem_bytes(int S, bool exp, int C, int Wc,
                                                         int nt) {
  return (3 * (size_t)S * Wc) * sizeof(float) + 2 * (size_t)C * (nt / 32) * 16 +
         (exp ? ((size_t)S * 16 * nt + 32 + S * S + S * 16) * sizeof(float) : 0);
}

// wavefront_fwd_cluster's rows in shared memory: a slice of Wc slots
// starts kHalo floats into its row, after its left halo slot, so that it
// lies on the 16-byte grid for the bulk stores; its right halo follows
// it, and the row's stride keeps the next row on the grid.
constexpr int kHalo = 4;
__host__ __device__ constexpr int fwd_cluster_row(int Wc) { return Wc + 2 * kHalo; }

// Dynamic shared memory of wavefront_fwd_cluster: the three raw rows and
// the row-max partials [C * nw].
__host__ __device__ constexpr size_t fwd_cluster_smem_bytes(int S, int C, int Wc, int nt) {
  return (3 * (size_t)S * fwd_cluster_row(Wc) + (size_t)C * (nt / 32)) * sizeof(float);
}

// The row-constant selects and bits of one diagonal (exp also the forward
// selects and the scale adjustments), read a diagonal ahead.
struct ClusterBits {
  int8_t abw, c1, c0, bm1, bm0, a, b1, b0;
  int pm0;  // pm's row-constant bits live in every slot
  float adj1, adj2;
};

template <bool kExp>
__device__ __forceinline__ ClusterBits cluster_bits(const BwdArgs& p, size_t row, int W) {
  ClusterBits r = {p.abw[row], p.c1[row], p.c0[row], p.bm1[row], p.bm0[row], 0, 0, 0,
                   p.pm[row * W], 0.f, 0.f};
  if constexpr (kExp) {
    r.a = p.a[row], r.b1 = p.b1[row], r.b0 = p.b0[row];
    r.adj1 = p.adj1[row], r.adj2 = p.adj2[row];
  }
  return r;
}

template <int S, int K, bool kExp, bool kWindow>
__global__ void __launch_bounds__(K == 2 ? kClusterThreads2 : kClusterThreads4)
    wavefront_back_cluster(const Trans tr, const BwdArgs p, int R, int W, int C, int Wc) {
  extern __shared__ __align__(16) float cluster_smem[];
  const int rank = blockIdx.x % C;  // the cluster's CTAs are consecutive along x
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int base = rank * Wc;
  const float* T = tr.v;
  const size_t SW = (size_t)S * W;
  const bool all = p.post_x != nullptr;
  float* rows = cluster_smem;
  float4* part = reinterpret_cast<float4*>(rows + 3 * S * Wc);
  float* eacc = reinterpret_cast<float*>(part + 2 * C * nw);
  float* red = eacc + S * 16 * nt;
  float* cnt = red + 32;
  const ClusterRows<S> B = {rows, rank > 0 ? cluster_map(rows, rank - 1) : nullptr,
                            rank + 1 < C ? cluster_map(rows, rank + 1) : nullptr, Wc, W};
  // lane l < C stores its warp's partials into CTA l's array
  float4* peer_part = lane < C ? cluster_map(part, lane) : nullptr;
  constexpr int kNz = kExp ? Model<S>::kNz : 1;
  float tacc[kNz];
#pragma unroll
  for (int k = 0; k < kNz; ++k) tacc[k] = 0.f;

  // rows R and R+1: the carry in above a window, zero past the batch
  // path's last diagonal
  constexpr bool carry = kWindow;
  float emn[K];  // em_{k+1} of the thread's slots
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int l = tid + q * nt;
    const int j = base + l;
    const bool in = l < Wc && j < W;
    if (l < Wc) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t g = (size_t)b * SW + (size_t)s * W + j;
        rows[((R % 3) * S + s) * Wc + l] = carry && in ? p.ci_b1[g] : 0.f;
        rows[(((R + 1) % 3) * S + s) * Wc + l] = carry && in ? p.ci_b2[g] : 0.f;
      }
    }
    emn[q] = carry && in ? p.ci_em[(size_t)b * W + j] : 0.f;
  }
  if constexpr (kExp) {
    for (int k = tid; k < S * 16 * nt; k += nt) eacc[k] = 0.f;
  }
  float invb = carry ? p.ci_invb[b] : 1.f;  // 1/mb_{k+1}
  float s1 = 1.f, s2 = 1.f;  // the scales of rows k+1 and k+2
  bool z2 = false;           // row k+2 reads as zero (B_{k+1} zeroed at k == L)
  const float* halo = (kExp && kWindow && p.fhc) ? p.fhc + (size_t)b * 2 * SW : nullptr;
  cluster_sync();  // every CTA of the cluster runs and has its rows

  // the next diagonal's row-constant bits and (kAhead) recursion streams;
  // exp at 4 slots a thread has no registers to spare for the streams
  constexpr bool kAhead = !kExp || K == 2;
  ClusterBits next = cluster_bits<kExp>(p, (size_t)b * R + R - 1, W);
  float nx[K], ny[K], nm[K];
  auto next_streams = [&](size_t row) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int l = tid + q * nt;
      const int j = base + l;
      const bool in = l < Wc && j < W;
      const size_t o = row * W + j;
      nx[q] = in ? p.efx[o] : 0.f;
      ny[q] = in ? p.efy[o] : 0.f;
      nm[q] = in ? p.efm[o] : 0.f;
    }
  };
  if (kAhead) next_streams((size_t)b * R + R - 1);
  int par = 0;
  for (int ii = R - 1; ii >= 0; --ii) {
    const size_t row = (size_t)b * R + ii;
    const bool norm = ((kWindow ? p.k0 : 0) + ii) % kNormEvery == kNormEvery - 1;
    const ClusterBits rb = next;
    const bool at_end = (rb.pm0 & kPmAtEnd) != 0;
    const bool bvalid = (rb.pm0 & kPmBridge) != 0;
    const int dx = rb.abw != 0 ? 0 : 1;
    const int dy = rb.abw != 0 ? -1 : 0;
    const int dm = rb.c1 != 0 ? -1 : (rb.c0 != 0 ? 0 : 1);
    const int db = rb.bm1 != 0 ? 1 : (rb.bm0 != 0 ? 0 : -1);
    const int bk0 = ii % 3, bk1 = (ii + 1) % 3, bk2 = (ii + 2) % 3;
    // bridgevec_{k+1}: row k+1's stream, or the carry in (zero past the
    // batch path's last diagonal)
    const float* bvr = ii + 1 < R ? p.bv + (row + 1) * W : carry ? p.ci_bv + (size_t)b * W : nullptr;

    // every device-memory read of the diagonal (kAhead: but the
    // recursion's streams, which came a diagonal ahead) is issued before
    // any is used
    float vx[K], vy[K], vm[K], ve[K], vb[K], vF[K][S];
    int vp[K];
    if (!kAhead) next_streams(row);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int l = tid + q * nt;
      const int j = base + l;
      const bool in = l < Wc && j < W;
      const size_t o = row * W + j;
      vx[q] = nx[q];
      vy[q] = ny[q];
      vm[q] = nm[q];
      ve[q] = in ? p.em[o] : 0.f;
      vb[q] = in ? nbz(bvr, j + db, W) : 0.f;
      vp[q] = !kExp && in ? p.pm[o] : 0;
#pragma unroll
      for (int s = 0; s < S; ++s) vF[q][s] = in ? p.F[(row * S + s) * W + j] : 0.f;
    }

    float raw[K][S];
    float lmax = 0.f, lbr = 0.f, ldot = 0.f;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int l = tid + q * nt;
      const int j = base + l;
#pragma unroll
      for (int s = 0; s < S; ++s) raw[q][s] = 0.f;
      if (l < Wc && j < W) {
        // raw neighbours: a slot whose three neighbours lie in its own
        // slice and the band reads them from its own rows directly
        float x1[S], y1[S], m2[S];
        if (l >= 1 && l + 1 < Wc && j >= 1 && j + 1 < W) {
          const float* r1 = rows + bk1 * S * Wc + l;
          const float* r2 = rows + bk2 * S * Wc + l;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            x1[s] = r1[s * Wc + dx];
            y1[s] = r1[s * Wc + dy];
            m2[s] = r2[s * Wc + dm];
          }
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            x1[s] = B.at(bk1, s, l + dx, j + dx);
            y1[s] = B.at(bk1, s, l + dy, j + dy);
            m2[s] = B.at(bk2, s, l + dm, j + dm);
          }
        }
        const float efmi = vm[q] * invb;
        float bx[S], bm[S], by[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          bx[s] = x1[s] * s1 * vx[q];
          by[s] = y1[s] * s1 * vy[q];
          bm[s] = (z2 ? 0.f : m2[s] * s2) * efmi;
        }
        Model<S>::bwd(raw[q], bx, bm, by, T);
        if (at_end) {
#pragma unroll
          for (int s = 0; s < S; ++s) raw[q][s] = p.end_row[((size_t)b * S + s) * W + j];
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (norm) lmax = max_nan(lmax, raw[q][s]);
          ldot += vF[q][s] * raw[q][s];
          rows[(bk0 * S + s) * Wc + l] = raw[q][s];
        }
        lbr += vb[q] * emn[q] * (rows[bk1 * S * Wc + l] * s1);
      }
    }

    // the diagonal's partials: per warp, into slot (rank, warp) of every
    // CTA's array of this parity
    for (int o = 16; o > 0; o >>= 1) {
      if (norm) lmax = max_nan(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      lbr += __shfl_xor_sync(0xffffffffu, lbr, o);
      ldot += __shfl_xor_sync(0xffffffffu, ldot, o);
    }
    if (lane < C) peer_part[(par * C + rank) * nw + warp] = make_float4(lmax, lbr, ldot, 0.f);
    cluster_arrive();

    // while the cluster meets: the next diagonal's row-constant bits and
    // recursion streams, and exp's count operands of this one (see
    // wavefront_exp)
    if (ii >= 1) {
      next = cluster_bits<kExp>(p, row - 1, W);
      if (kAhead) next_streams(row - 1);
    }
    float lo[kExp ? K : 1][S], up[kExp ? K : 1][S], mid[kExp ? K : 1][S];
    float vex[kExp ? K : 1], vey[kExp ? K : 1];
    int vw[kExp ? K : 1];
    if constexpr (kExp) {
      const int dl = rb.a == 0 ? -1 : 0;
      const int du = dl + 1;
      const int dmf = rb.b1 != 0 ? 1 : (rb.b0 != 0 ? 0 : -1);
      const float* F1 = ii >= 1 ? p.F + (row - 1) * SW : halo ? halo + SW : nullptr;
      const float* F2 = ii >= 2 ? p.F + (row - 2) * SW : halo ? halo + ii * SW : nullptr;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int l = tid + q * nt;
        const int j = base + l;
        const bool in = l < Wc && j < W;
        const size_t o = row * W + j;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          lo[q][s] = in ? nbz(F1 ? F1 + s * W : nullptr, j + dl, W) : 0.f;
          up[q][s] = in ? nbz(F1 ? F1 + s * W : nullptr, j + du, W) : 0.f;
          mid[q][s] = in ? nbz(F2 ? F2 + s * W : nullptr, j + dmf, W) : 0.f;
        }
        vex[q] = in ? p.ex[o] : 0.f;
        vey[q] = in ? p.ey[o] : 0.f;
        const int sx = in ? p.wx[o] : 4;
        const int sy = in ? p.wy[o] : 4;
        vw[q] = sx < 4 && sy < 4 ? sx * 4 + sy : -1;
      }
    }
    cluster_wait();

    // every CTA sums the C * nw partials in the same order: four running
    // sums over k mod 4, then (0 + 1) + (2 + 3)
    const float4* pp = part + par * C * nw;
    float m = 0.f, bridge = 0.f, dot = 0.f;
    {
      float mq[4] = {0.f, 0.f, 0.f, 0.f}, bq[4] = {0.f, 0.f, 0.f, 0.f},
            dq[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < C * nw; k += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k + u < C * nw) {
            const float4 v = pp[k + u];
            mq[u] = max_nan(mq[u], v.x);
            bq[u] += v.y;
            dq[u] += v.z;
          }
        }
      }
      m = max_nan(max_nan(mq[0], mq[1]), max_nan(mq[2], mq[3]));
      bridge = (bq[0] + bq[1]) + (bq[2] + bq[3]);
      dot = (dq[0] + dq[1]) + (dq[2] + dq[3]);
    }
    float r = 1.f;
    float mbv = 0.f;
    if (norm) {
      if (!(m > 0.f) || at_end) m = 1.f;
      r = 1.f / m;
      mbv = logf(m);
    }
    const float total = r * (dot + (bvalid ? bridge : 0.f));
    const TotalTerms tt = total_terms(total);
    const float invt = tt.invt;
    if (rank == 0 && tid == 0) {
      p.mb[row] = mbv;
      p.tot[row] = tt.log;
    }

    const float a1 = rb.adj1, a2 = rb.adj2;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int l = tid + q * nt;
      const int j = base + l;
      if (l < Wc && j < W) {
        float bk[S];  // B_k, exactly the rescaled row mb records
#pragma unroll
        for (int s = 0; s < S; ++s) bk[s] = raw[q][s] * r;
        if constexpr (kExp) {
          const float exa = vex[q] * a1;
          const float eya = vey[q] * a1;
          const float ema = ve[q] * a2;
          float l_[S], m_[S], u_[S], bw[S], qv[S];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            l_[s] = lo[q][s] * exa;
            u_[s] = up[q][s] * eya;
            m_[s] = mid[q][s] * ema;
            bw[s] = bk[s] * invt;
            qv[s] = 0.f;
          }
          Model<S>::exp(tacc, qv, l_, m_, u_, bw, T);
          if (vw[q] >= 0) {
            float* col = eacc + vw[q] * nt + tid;
#pragma unroll
            for (int s = 0; s < S; ++s) col[s * 16 * nt] += qv[s] * bw[s];
          }
        } else {
          const size_t o = row * W + j;
          const int pb = vp[q];
          p.post_m[o] = (pb & kPmMatch) ? vF[q][0] * bk[0] * invt : 0.f;
          if (all) {
            p.post_x[o] = (pb & kPmGapX) ? vF[q][1] * bk[1] * invt : 0.f;
            p.post_y[o] = (pb & kPmGapY) ? vF[q][2] * bk[2] * invt : 0.f;
          }
        }
        emn[q] = ve[q];
      }
    }
    invb = at_end ? 1.f : r;
    s2 = s1;
    z2 = at_end;
    s1 = r;
    par ^= 1;
  }

  // carry out of row 0: rows 0 and 1 as the other kernels hold them (the
  // thread's own slots, which it wrote itself)
  if (kWindow && p.co_b1 != nullptr) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int l = tid + q * nt;
      const int j = base + l;
      if (l < Wc && j < W) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const size_t g = (size_t)b * SW + (size_t)s * W + j;
          p.co_b1[g] = rows[(0 * S + s) * Wc + l] * s1;
          p.co_b2[g] = z2 ? 0.f : rows[(1 * S + s) * Wc + l] * s2;
        }
        p.co_bv[(size_t)b * W + j] = p.bv[(size_t)b * R * W + j];
        p.co_em[(size_t)b * W + j] = emn[q];
      }
    }
    if (rank == 0 && tid == 0) p.co_invb[b] = invb;
  }

  if constexpr (kExp) {
    // this CTA's counts into cnt, then rank 0 sums the cluster's in rank
    // order (the trans sums end with a barrier, after which every
    // thread's emission column is complete)
    float out[S * S];
#pragma unroll
    for (int k = 0; k < S * S; ++k) out[k] = 0.f;
    Model<S>::trans(out, tacc, red, T, nt);
    if (tid == 0) {
      for (int k = 0; k < S * S; ++k) cnt[k] = out[k];
    }
    for (int k = tid; k < S * 16; k += nt) {
      const float* rowp = eacc + k * nt;
      float s = 0.f;
      for (int c = 0; c < nt; ++c) s += rowp[c];
      cnt[S * S + k] = s;
    }
    cluster_sync();
    if (rank == 0) {
      for (int k = tid; k < S * S + S * 16; k += nt) {
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += cluster_map(cnt, c)[k];
        if (k < S * S)
          p.trans[(size_t)b * S * S + k] = s;
        else
          p.emis[(size_t)b * S * 16 + k - S * S] = s;
      }
    }
    cluster_sync();  // no CTA leaves while rank 0 reads its counts
  }
}

// wavefront_fwd_cluster: wavefront_fwd_wide's work (the forward
// wavefront, batch and window) for bands wider than kMaxWidth, on a
// thread-block cluster of C CTAs per pair that keeps F_{k-1} and F_{k-2}
// on chip. The global-scratch kernel ran one SM per pair and read every
// neighbour of F back from device memory, one L2 round per slot-loop
// iteration (6.8 us per diagonal at W = 4352, 11.9 at 8200); it also
// rescaled a norm row in a second pass behind a second barrier. Here:
//   - CTA r of a pair's cluster owns the slots [r * Wc, (r + 1) * Wc), K
//     (2 or 4) of them per thread (j = r * Wc + tid + q * nt). Its
//     shared memory holds three rows of raw F, the rows of diagonals k,
//     k-1 and k-2 by k mod 3, each (S, Wc) with one halo slot on either
//     side of the slice; a window's carry in enters as rows -1 and -2
//     (scaled already: read with scale 1), the batch path's F0 as row 0
//     above a zero row -1.
//   - The neighbour shifts are in {-1, 0, +1}, so a slice needs one slot
//     past each edge. The CTA that owns that slot pushes it: the thread
//     of a slice's first (last) slot stores its new row's value into the
//     left (right) peer's halo slot through distributed shared memory
//     (mapa) as it writes its own, and the barrier releases the store.
//     No read waits on a peer's memory. A halo no peer fills, and the
//     slots of a slice past W, stay zero, as nb() fills.
//   - Rows are stored raw; every reader multiplies by the row's scale
//     (raw * r, the fp32 product fwd_reference stores as F), so no second
//     pass and no barrier separate a rescale from the next diagonal.
//     Only norm rows reduce (the row max): each warp's partial goes into
//     slot (rank, warp) of every CTA's partial array, and after the
//     barrier every warp of every CTA takes the max of the same C * nw
//     partials (a max is exact in any order), so all CTAs hold the same
//     m and r bit for bit; rank 0 writes mf. One array serves: the next
//     norm row writes it kNormEvery diagonals later, after every reader
//     has passed a later barrier.
//   - One cluster barrier per diagonal (arrive.release, wait.acquire) is
//     the only barrier. A row's buffer, halos included, is written again
//     three diagonals on, after every reader of it has arrived at a later
//     barrier.
//   - Every device-memory read of a diagonal (ex, ey, em of the CTA's
//     slots, the a / b1 / b0 bytes) is issued a diagonal ahead, between
//     arrive and wait, and none is used before the wait.
//   - F is the output: a row that needs no rescale is final raw, and
//     thread 0 of each CTA stores its slice of it after the barrier with
//     one bulk copy (TMA) per state from shared memory (where W % 4 == 0
//     and F lies on the 16-byte grid; per-thread stores otherwise), and
//     waits for the copies to have read the row before the next barrier.
//     A norm row is stored as raw * r by its threads on the next
//     diagonal, once r is known; bv by every thread for its own slots.
// The arithmetic is fwd_reference's operation for operation (fwd<true>,
// bridge<true>, the same scale products), so F, bv, mf and the carry out
// equal the plain version's, and the global-scratch kernel's, bit for bit.
template <int S, int K, bool kWindow>
__global__ void __launch_bounds__(K == 2 ? kClusterThreads2 : kClusterThreads4)
    wavefront_fwd_cluster(const Trans tr, const FwdArgs p, int R, int W, int C, int Wc,
                          int bulk) {
  extern __shared__ __align__(16) float cluster_smem[];
  const int rank = blockIdx.x % C;  // the cluster's CTAs are consecutive along x
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int base = rank * Wc;
  const int n = W - base >= Wc ? Wc : W - base > 0 ? W - base : 0;  // its slots in [0, W)
  const int P = fwd_cluster_row(Wc);
  const float* T = tr.v;
  const size_t SW = (size_t)S * W;
  const int i0 = kWindow ? 0 : 1;  // the first computed row
  const int k0 = kWindow ? p.k0 : 0;
  const size_t pr = (size_t)b * R;  // this pair's row 0
  float* rows = cluster_smem;       // (3, S, P): local slot l at kHalo + l
  float* part = rows + 3 * S * P;
  // the peers' rows: this slice's first slot is the left peer's right
  // halo, its last the right peer's left halo
  float* left = rank > 0 ? cluster_map(rows, rank - 1) + kHalo + Wc : nullptr;
  float* right = rank + 1 < C ? cluster_map(rows, rank + 1) + kHalo - 1 : nullptr;
  // lane l < C stores its warp's partial max into CTA l's array
  float* peer_part = lane < C ? cluster_map(part, lane) : nullptr;
  auto buf = [](int i) { return (i + 3) % 3; };  // row i's buffer, i >= -2
  // a new value of this CTA's slot l in row buffer bk, state s, with its
  // push into a peer's halo
  auto put = [&](int bk, int s, int l, float v) {
    const int o = (bk * S + s) * P;
    rows[o + kHalo + l] = v;
    if (l == 0 && left) left[o] = v;
    if (l == Wc - 1 && right) right[o] = v;
  };

  for (int k = tid; k < 3 * S * P; k += nt) rows[k] = 0.f;
  cluster_sync();  // every CTA of the cluster runs and has zeroed its rows
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int l = tid + q * nt;
    const int j = base + l;
    if (l < n) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t g = (size_t)b * SW + (size_t)s * W + j;
        if constexpr (kWindow) {
          put(buf(-1), s, l, p.ci1[g]);
          put(buf(-2), s, l, p.ci2[g]);
        } else {
          const float v = p.F0[g];
          put(buf(0), s, l, v);
          p.F[(pr * S + s) * W + j] = v;
        }
      }
      if (!kWindow) p.bv[pr * W + j] = 0.f;
    }
  }
  if (!kWindow && rank == 0 && tid == 0) p.mf[pr] = 0.f;

  // the next diagonal's streams and row-constant shift bytes
  float nx[K], ny[K], nm[K];
  int8_t na = 0, nb1 = 0, nb0 = 0;
  auto next_row = [&](size_t row) {
    na = p.a[row], nb1 = p.b1[row], nb0 = p.b0[row];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int l = tid + q * nt;
      const size_t o = row * W + base + l;
      nx[q] = l < n ? p.ex[o] : 0.f;
      ny[q] = l < n ? p.ey[o] : 0.f;
      nm[q] = l < n ? p.em[o] : 0.f;
    }
  };
  if (i0 < R) next_row(pr + i0);
  float invm = kWindow ? p.cim[b] : 1.f;  // 1/m_{k-1}
  float r1 = 1.f, r2 = 1.f;               // the scales of rows k-1 and k-2
  bool pending = false;                    // row k-1 awaits its scale
  // the max of a norm row's partials (every thread of the cluster calls
  // it after the barrier that follows the row); 1 for a row max <= 0 or
  // NaN, and rank 0 writes mf
  auto row_scale = [&](size_t row) {
    float m = 0.f;
    for (int k = lane; k < C * nw; k += 32) m = max_nan(m, part[k]);
    for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = m > 0.f ? m : 1.f;
    if (rank == 0 && tid == 0) p.mf[row] = logf(m);
    return 1.f / m;
  };
  cluster_sync();  // every CTA has its first rows and halos

  for (int i = i0; i < R; ++i) {
    const size_t row = pr + i;
    const bool norm = (k0 + i) % kNormEvery == kNormEvery - 1;
    const bool sa = na != 0;
    const int dm = mid_shift(nb1, nb0);
    float vx[K], vy[K], vm[K];
#pragma unroll
    for (int q = 0; q < K; ++q) vx[q] = nx[q], vy[q] = ny[q], vm[q] = nm[q];
    const bool rescaled = pending;  // row k-1 is a norm row: store it scaled
    if (i > i0) {
      r2 = r1;
      r1 = pending ? row_scale(row - 1) : 1.f;
      invm = r1;
    }
    const int bk0 = buf(i), bk1 = buf(i - 1), bk2 = buf(i - 2);

    float lmax = 0.f;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int l = tid + q * nt;
      const int j = base + l;
      if (l < n) {
        // F_{k-1} at j-1, j, j+1 and F_{k-2} at j + dm and j, raw, from
        // the slice and its halos
        const float* p1 = rows + bk1 * S * P + kHalo + l;
        const float* p2 = rows + bk2 * S * P + kHalo + l;
        float fl[S], fc[S], fr[S], m2[S], own2[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          fl[s] = p1[s * P - 1] * r1;
          fc[s] = p1[s * P] * r1;
          fr[s] = p1[s * P + 1] * r1;
          m2[s] = p2[s * P + dm] * r2;
          own2[s] = p2[s * P] * r2;
          if (rescaled) p.F[((row - 1) * S + s) * W + j] = fc[s];
        }
        const float exj = vx[q];
        const float eyj = vy[q];
        const float emi = vm[q] * invm;
        float lo[S], mi[S], up[S], cur[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          lo[s] = (sa ? fc[s] : fl[s]) * exj;
          up[s] = (sa ? fr[s] : fc[s]) * eyj;
          mi[s] = m2[s] * emi;
          cur[s] = 0.f;
        }
        Model<S>::template fwd<true>(cur, lo, mi, up, T);
        // bridgevec[k] = (sum_f F_{k-2}[f] * t_m[f, match]) / m_{k-1}
        p.bv[row * W + j] = Model<S>::template bridge<true>(own2, T) * invm;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          put(bk0, s, l, cur[s]);
          if (norm)
            lmax = max_nan(lmax, cur[s]);
          else if (!bulk)
            p.F[(row * S + s) * W + j] = cur[s];
        }
      }
    }
    if (norm) {
      for (int o = 16; o > 0; o >>= 1) lmax = max_nan(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      if (lane < C) peer_part[rank * nw + warp] = lmax;
    } else if (rank == 0 && tid == 0) {
      p.mf[row] = 0.f;
    }
    if (bulk) {
      if (!norm) fence_smem_for_copies();  // thread 0 stores the row by TMA
      if (tid == 0) bulk_wait(false);      // row k-1's copies have read it
    }
    cluster_arrive();
    if (i + 1 < R) next_row(row + 1);
    cluster_wait();
    if (bulk && !norm && tid == 0 && n > 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        bulk_store(p.F + (row * S + s) * W + base, rows + (bk0 * S + s) * P + kHalo,
                   (uint32_t)(n * sizeof(float)));
    }
    pending = norm;
  }
  if (bulk && tid == 0) bulk_wait(true);

  // The last row's rescale and the carry out (the loop's final barrier
  // precedes): the rows R-1 and R-2, the thread's own slots.
  if (R - 1 < i0) return;
  const float r = pending ? row_scale(pr + R - 1) : 1.f;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int l = tid + q * nt;
    const int j = base + l;
    if (l < n) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float f1 = rows[(buf(R - 1) * S + s) * P + kHalo + l] * r;
        if (pending) p.F[((pr + R - 1) * S + s) * W + j] = f1;
        if (kWindow && p.co1 != nullptr) {
          const size_t g = (size_t)b * SW + (size_t)s * W + j;
          p.co1[g] = f1;
          p.co2[g] = rows[(buf(R - 2) * S + s) * P + kHalo + l] * r1;
        }
      }
    }
  }
  if (kWindow && p.co1 != nullptr && rank == 0 && tid == 0) p.com[b] = r;
}

Trans load_trans(int S, const float* t_host) {
  Trans tr = {};
  for (int k = 0; k < 3 * S * S; ++k) tr.v[k] = t_host[k];
  return tr;
}

// A kernel's launch at (S, W): threads, band slots per compute thread,
// ring depth (0: the direct-load variant) and dynamic shared memory.
struct Plan {
  int threads, slots, depth;
  size_t smem;
};

// wavefront_fwd's launch at (S, W): 1, 2 or 4 slots per compute thread,
// the fewest that cover W with at most kFwdThreads threads (fewer, fuller
// threads make the barrier cheaper, up to the registers that a slot's
// operands take), else 16 on at most kMaxWidth / 16; a ring of D stages
// (the most that fit beside the two rows, at most kMaxStages) where at
// least two fit, the slots are at most 4, the streams and F start on the
// 16-byte grid (`aligned`) and W % 4 == 0 (bulk copies move 16-byte
// multiples); the direct-load variant otherwise.
Plan fwd_plan(int S, int W, bool aligned) {
  const size_t rows = 2 * (size_t)S * W * sizeof(float);
  const int slots = W <= kFwdThreads       ? 1
                    : W <= 2 * kFwdThreads ? 2
                    : W <= 4 * kFwdThreads ? 4
                                           : 16;
  const int compute = ((W + slots - 1) / slots + 31) / 32 * 32;
  const size_t fit = (kSmemPerBlock - kStaticSmem - rows) / fwd_stage_bytes(W);
  int depth = (int)std::min<size_t>(kMaxStages, fit);
  if (!aligned || W % 4 != 0 || depth < 2 || slots > 4) depth = 0;
  // the direct-load variant's one stage
  return {compute + (depth ? 32 : 0), slots, depth, rows + std::max(depth, 1) * fwd_stage_bytes(W)};
}

using FwdKernel = void (*)(Trans, FwdArgs, int, int, int);

template <int S, int kSlots, bool kRing>
FwdKernel fwd_kernel(bool window) {
  return window ? wavefront_fwd<S, kSlots, kRing, true> : wavefront_fwd<S, kSlots, kRing, false>;
}

template <int S>
int launch_fwd(const float* t_host, const FwdArgs& p, int B, int R, int W, cudaStream_t stream) {
  bool aligned = true;  // the ring's copies: the streams and F on the 16-byte grid
  for (const void* q : {(const void*)p.ex, (const void*)p.ey, (const void*)p.em, (const void*)p.F})
    aligned = aligned && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const Plan pl = fwd_plan(S, W, aligned);
  const bool window = p.ci1 != nullptr;
  FwdKernel kernel = pl.depth > 0 ? (pl.slots == 1   ? fwd_kernel<S, 1, true>(window)
                                     : pl.slots == 2 ? fwd_kernel<S, 2, true>(window)
                                                     : fwd_kernel<S, 4, true>(window))
                                  : (pl.slots == 1   ? fwd_kernel<S, 1, false>(window)
                                     : pl.slots == 2 ? fwd_kernel<S, 2, false>(window)
                                     : pl.slots == 4 ? fwd_kernel<S, 4, false>(window)
                                                     : fwd_kernel<S, 16, false>(window));
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, pl.threads, pl.smem, stream>>>(load_trans(S, t_host), p, R, W, pl.depth);
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

Plan bwd_plan(int S, int W, bool aligned) {
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
  const Plan pl = bwd_plan(S, W, ring_aligned(p));
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

// wavefront_exp's launch at (S, W), as wavefront_bwd's: the emission
// columns in shared memory (scratch false; at most kExpMaxThreads compute
// threads) or in p.eacc (at most kExpWideThreads); 1, 2, 4 or 8 slots,
// the fewest that cover W; a ring of D >= 3 stages (its F rows k-1 and k-2
// are the next two stages) where that many fit beside the carries and the
// columns, W % 16 == 0, the streams sit on the 16-byte grid and the slots
// are at most 4; the direct-load variant otherwise.
Plan exp_plan(int S, int W, bool aligned, bool scratch) {
  const size_t carries = (2 * (size_t)S + 1) * W * sizeof(float);
  const int cap = scratch ? kExpWideThreads : kExpMaxThreads;
  const int slots = W <= cap ? 1 : W <= 2 * cap ? 2 : W <= 4 * cap ? 4 : 8;
  const int compute = ((W + slots - 1) / slots + 31) / 32 * 32;
  const size_t cols = scratch ? 0 : (size_t)S * 16 * compute * sizeof(float);
  const size_t used = kStaticSmem + carries + cols;
  const size_t fit = used < kSmemPerBlock ? (kSmemPerBlock - used) / exp_stage_bytes(S, W) : 0;
  int depth = (int)std::min<size_t>(kMaxStages, fit);
  if (!aligned || W % 16 != 0 || depth < 3 || slots > 4) depth = 0;
  return {compute + (depth ? 32 : 0), slots, depth,
          carries + depth * exp_stage_bytes(S, W) + cols};
}

// The streams exp's ring copies start on 16-byte boundaries.
bool exp_aligned(const BwdArgs& p) {
  const void* ptrs[] = {p.efx, p.efy, p.efm, p.em, p.bv, p.ex, p.ey, p.F, p.wx, p.wy};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  return true;
}

template <int S, int kSlots, bool kRing>
BwdKernel exp_kernel(bool window) {
  return window ? wavefront_exp<S, kSlots, kRing, true> : wavefront_exp<S, kSlots, kRing, false>;
}

template <int S>
int launch_exp(const float* t_host, const BwdArgs& p, int B, int R, int W, cudaStream_t stream) {
  const Plan pl = exp_plan(S, W, exp_aligned(p), p.eacc != nullptr);
  const bool window = p.ci_b1 != nullptr;
  BwdKernel kernel = pl.depth > 0 ? (pl.slots == 1   ? exp_kernel<S, 1, true>(window)
                                     : pl.slots == 2 ? exp_kernel<S, 2, true>(window)
                                                     : exp_kernel<S, 4, true>(window))
                                  : (pl.slots == 1   ? exp_kernel<S, 1, false>(window)
                                     : pl.slots == 2 ? exp_kernel<S, 2, false>(window)
                                     : pl.slots == 4 ? exp_kernel<S, 4, false>(window)
                                                     : exp_kernel<S, 8, false>(window));
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, pl.threads, pl.smem, stream>>>(load_trans(S, t_host), p, R, W, pl.depth);
  return (int)cudaGetLastError();
}

// The cluster size the cluster kernels' plans use, at most kClusterMax;
// 0 turns the cluster variants off (cpecan_wavefront_set_cluster_limit:
// for measurements and tests).
int g_cluster_limit = kClusterMax;

// A wide kernel's launch at (S, W): cluster size (0: the global-scratch
// kernel), band slots per thread, slice (band slots per CTA), threads per
// CTA and dynamic shared memory.
struct ClusterPlan {
  int cluster, slots, slice, threads;
  size_t smem;
};

// The threads of a slice of Wc slots at K slots a thread (whole warps),
// and the most a cluster kernel takes at K.
int cluster_threads(int Wc, int K) { return ((Wc + K - 1) / K + 31) / 32 * 32; }
int cluster_thread_cap(int K) { return K == 2 ? kClusterThreads2 : kClusterThreads4; }

// A cluster of C CTAs holds a band of W slots in slices of Wc: W / C
// rounded up to 32.
int cluster_slice(int W, int C) { return ((W + C - 1) / C + 31) / 32 * 32; }

// wavefront_fwd_wide's launch at (S, W): the cluster variant
// (wavefront_fwd_cluster, cluster > 0) where a cluster of g_cluster_limit
// CTAs holds the band, at 2 slots per thread where that takes at most
// kClusterThreads2 threads, else 4 on at most kClusterThreads4 (on the
// card 2 slots ran faster than 4 and 8 wherever they fit, and 8 CTAs
// faster than 4); else the global-scratch
// kernel (cluster 0), the declared route above the cluster's capacity (W
// > 12288 at C = 8, as wavefront_back_cluster's).
ClusterPlan fwd_wide_plan(int S, int W) {
  const int C = g_cluster_limit;
  if (C < 2) return {0, 0, 0, 0, 0};
  const int Wc = cluster_slice(W, C);
  for (int K : {2, 4}) {
    const int nt = cluster_threads(Wc, K);
    const size_t smem = fwd_cluster_smem_bytes(S, C, Wc, nt);
    if (nt <= cluster_thread_cap(K) && smem <= kSmemPerBlock) return {C, K, Wc, nt, smem};
  }
  return {0, 0, 0, 0, 0};
}

// A cluster kernel's launch: B clusters of pl.cluster CTAs along x.
template <class... P, class... A>
int launch_cluster(void (*kernel)(P...), const ClusterPlan& pl, int B, cudaStream_t stream,
                   A&&... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * pl.cluster);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

using FwdClusterKernel = void (*)(Trans, FwdArgs, int, int, int, int, int);

template <int S, int K>
FwdClusterKernel fwd_cluster_kernel(bool window) {
  return window ? wavefront_fwd_cluster<S, K, true> : wavefront_fwd_cluster<S, K, false>;
}

template <int S>
int launch_fwd_wide(const float* t_host, const FwdArgs& p, int B, int R, int W,
                    cudaStream_t stream) {
  const bool window = p.ci1 != nullptr;
  const ClusterPlan pl = fwd_wide_plan(S, W);
  if (pl.cluster == 0) {
    auto kernel = window ? wavefront_fwd_wide<S, true> : wavefront_fwd_wide<S, false>;
    const int nt = std::min((W + 31) / 32 * 32, kWideThreads);
    kernel<<<B, nt, 0, stream>>>(load_trans(S, t_host), p.ex, p.ey, p.em, p.a, p.b1, p.b0,
                                 p.F0, p.ci1, p.ci2, p.cim, p.F, p.bv, p.mf, p.co1, p.co2,
                                 p.com, R, W, p.k0);
    return (int)cudaGetLastError();
  }
  // the cluster variant; a launch it cannot make is an error, never the
  // global-scratch kernel. Its rows leave by bulk copies where each
  // slice's segment of F lies on the 16-byte grid.
  const FwdClusterKernel kernel =
      pl.slots == 2 ? fwd_cluster_kernel<S, 2>(window) : fwd_cluster_kernel<S, 4>(window);
  const int bulk = W % 4 == 0 && reinterpret_cast<uintptr_t>(p.F) % 16 == 0;
  return launch_cluster(kernel, pl, B, stream, load_trans(S, t_host), p, R, W, pl.cluster,
                        pl.slice, bulk);
}

// wavefront_back_wide's launch at (S, W): the cluster variant
// (wavefront_back_cluster, cluster > 0) where a cluster of
// g_cluster_limit CTAs holds the band: slices of Wc slots; exp 2 slots
// per thread where that takes at most kClusterThreads2 threads and fits
// shared memory (the counts after the reduction are its longest serial
// work: half of it a thread), else 4, and bwd 4, on at most
// kClusterThreads4 (bwd ran slower on 2: more warps to reduce and meet,
// the same chain per diagonal); else the global-scratch kernel (cluster
// 0), the declared route above the cluster's capacity (W > 12288 at C =
// 8).
ClusterPlan back_wide_plan(int S, int W, bool exp) {
  const int C = g_cluster_limit;
  if (C < 2) return {0, 0, 0, 0, 0};
  const int Wc = cluster_slice(W, C);
  for (int K : {2, 4}) {
    if (K == 2 && !exp) continue;
    const int nt = cluster_threads(Wc, K);
    const size_t smem = cluster_smem_bytes(S, exp, C, Wc, nt);
    if (nt <= cluster_thread_cap(K) && smem <= kSmemPerBlock) return {C, K, Wc, nt, smem};
  }
  return {0, 0, 0, 0, 0};
}

using ClusterKernel = void (*)(Trans, BwdArgs, int, int, int, int);

template <int S, int K, bool kExp>
ClusterKernel cluster_kernel(bool window) {
  return window ? wavefront_back_cluster<S, K, kExp, true> : wavefront_back_cluster<S, K, kExp, false>;
}

template <int S, bool kExp>
int launch_back_wide(const float* t_host, const BwdArgs& p, int B, int R, int W,
                     cudaStream_t stream) {
  const bool window = p.ci_b1 != nullptr;
  const ClusterPlan pl = back_wide_plan(S, W, kExp);
  if (pl.cluster == 0) {
    auto kernel = window ? wavefront_back_wide<S, kExp, true> : wavefront_back_wide<S, kExp, false>;
    const int nt = std::min((W + 31) / 32 * 32, kExp ? kExpWideThreads : kWideThreads);
    kernel<<<B, nt, 0, stream>>>(load_trans(S, t_host), p, R, W);
    return (int)cudaGetLastError();
  }
  // the cluster variant; a launch it cannot make is an error, never the
  // global-scratch kernel
  ClusterKernel kernel = cluster_kernel<S, 4, kExp>(window);
  if constexpr (kExp) {
    if (pl.slots == 2) kernel = cluster_kernel<S, 2, kExp>(window);
  }
  return launch_cluster(kernel, pl, B, stream, load_trans(S, t_host), p, R, W, pl.cluster,
                        pl.slice);
}

// The shared-memory variants take W <= kMaxWidth, the wide ones any W.
bool bad_shape(int S, int B, int R, int W, bool wide = false) {
  return (S != 3 && S != 5) || B < 0 || R < 1 || W < 1 || (!wide && W > kMaxWidth);
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

int fwd_entry(bool wide, int S, const float* t_host, const float* ex, const float* ey,
              const float* em, const int8_t* a, const int8_t* b1, const int8_t* b0,
              const float* F0, const float* ci1, const float* ci2, const float* cim, float* F,
              float* bv, float* mf, float* co1, float* co2, float* com, int B, int R, int W,
              int k0, void* stream) {
  if (bad_shape(S, B, R, W, wide) || k0 < 0 || (F0 == nullptr) == (ci1 == nullptr) ||
      (ci1 != nullptr && (ci2 == nullptr || cim == nullptr)) ||
      (co1 != nullptr && (co2 == nullptr || com == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdArgs p = {ex, ey, em, a, b1, b0, F0, ci1, ci2, cim, F, bv, mf, co1, co2, com, k0};
  auto launch = wide ? (S == 5 ? launch_fwd_wide<5> : launch_fwd_wide<3>)
                     : (S == 5 ? launch_fwd<5> : launch_fwd<3>);
  return launch(t_host, p, B, R, W, st);
}

int bwd_entry(bool wide, int S, const float* t_host, const float* efx, const float* efy,
              const float* efm, const float* em, const float* F, const float* bv,
              const int8_t* abw, const int8_t* c1, const int8_t* c0, const int8_t* bm1,
              const int8_t* bm0, const int8_t* pm, const float* end_row, float* post_m,
              float* post_x, float* post_y, float* mb, float* tot, const float* const* ci,
              float* const* co, float* scratch, int B, int R, int W, int k0, void* stream) {
  BwdArgs p = {};
  if (bad_shape(S, B, R, W, wide) || !set_window(p, ci, co, k0) || wide != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  p.efx = efx, p.efy = efy, p.efm = efm, p.em = em, p.F = F, p.bv = bv;
  p.abw = abw, p.c1 = c1, p.c0 = c0, p.bm1 = bm1, p.bm0 = bm0, p.pm = pm;
  p.end_row = end_row, p.mb = mb, p.tot = tot;
  p.post_m = post_m, p.post_x = post_x, p.post_y = post_y;
  p.scratch = scratch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = wide ? (S == 5 ? launch_back_wide<5, false> : launch_back_wide<3, false>)
                     : (S == 5 ? launch_bwd<5> : launch_bwd<3>);
  return launch(t_host, p, B, R, W, st);
}

int exp_entry(bool wide, int S, const float* t_host, const float* efx, const float* efy,
              const float* efm, const float* em, const float* ex, const float* ey,
              const float* F, const float* bv, const int8_t* abw, const int8_t* c1,
              const int8_t* c0, const int8_t* bm1, const int8_t* bm0, const int8_t* a,
              const int8_t* b1, const int8_t* b0, const int8_t* pm, const float* end_row,
              const float* adj1, const float* adj2, const int8_t* wx, const int8_t* wy,
              float* trans, float* emis, float* eacc, float* mb, float* tot, const float* fhc,
              const float* const* ci, float* const* co, float* scratch, int B, int R, int W,
              int k0, void* stream) {
  BwdArgs p = {};
  // the emission columns: the caller's scratch above kExpSharedWidth (and
  // always in the wide variant), shared memory below
  const bool cols = wide || W > kExpSharedWidth;
  if (bad_shape(S, B, R, W, wide) || !set_window(p, ci, co, k0) ||
      (fhc != nullptr && ci[0] == nullptr) || cols != (eacc != nullptr) ||
      wide != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  p.fhc = fhc;
  p.efx = efx, p.efy = efy, p.efm = efm, p.em = em, p.F = F, p.bv = bv;
  p.abw = abw, p.c1 = c1, p.c0 = c0, p.bm1 = bm1, p.bm0 = bm0, p.pm = pm;
  p.end_row = end_row, p.mb = mb, p.tot = tot;
  p.ex = ex, p.ey = ey, p.a = a, p.b1 = b1, p.b0 = b0;
  p.adj1 = adj1, p.adj2 = adj2, p.wx = wx, p.wy = wy, p.trans = trans, p.emis = emis;
  p.eacc = eacc, p.scratch = scratch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = wide ? (S == 5 ? launch_back_wide<5, true> : launch_back_wide<3, true>)
                     : (S == 5 ? launch_exp<5> : launch_exp<3>);
  return launch(t_host, p, B, R, W, st);
}

// ---------------------------------------------------------------------------
// wavefront_prep: the stream prep's slot part
// ---------------------------------------------------------------------------
//
// Replaces _precompute_one (cpecan_tpu/ops/fb_wavefront.py:865), which the
// JAX package traces into _fb_wavefront_jit (vmapped at :1000) and XLA
// fuses into a few device passes (no Pallas kernel), with its window forms
// _prep_window (fb_segmented.py:72) and _prep_one (fb_parallel.py:96): its
// work over the (B, R, W) slots, which the plain version
// (ops/fb_wavefront.py streams_reference) does in ~80 tensor ops. Per
// (row, slot j):
//   - the symbol windows, gathered from the padded symbols at an origin
//     clamped to the sliding windows' range (the plain version's unfold
//     and gather clamp the origin, not the element):
//       wx[j] = sx[clamp(xoff - 1 + pad_off, 0, nx - W - 1) + j]
//       wy[j] = sy[clamp(LY - k + xoff - 1 + pad_off, 0, ny - W - 1) + j]
//     for j in [0, W]; a symbol outside 0..4 (the sentinel 5) reads
//     probability 0 from every table;
//   - the six emission streams: ex = gx[wx[j]], ey = gy[wy[j+1]], em =
//     gm[wx[j], wy[j+1]] and efx, efy, efm with j and j+1 swapped, each
//     times fm = 1.f on the band's slots (jlo <= j <= jhi) and 0.f off
//     them: a multiply, not a select, so a NaN or inf table entry gives
//     NaN off the band as in the plain version;
//   - pm: with xs = xoff + j and ys = k - xs, the match, gap x and gap y
//     bits on band slots of rows whose posteriors pass (kRowValid), ORed
//     with the row's at-end and bridge bits;
//   - the cells' symbol pairs wx[j] and wy[j+1].
// Outputs are bit-equal to the plain version's: table entries times 1 or
// 0, and integer logic. The row part (frame, shift selects, pm's row bits,
// the row tensor, start and end rows, the tables) is wavefront_rows, below.
//
// What bounds it on the card: the bytes it writes, 6 x 4 + 3 bytes per
// slot (1.83 GB at the headline batch: 0.55 ms at 3.35 TB/s); it reads
// 17 bytes per row and the padded symbols. So each thread takes 4
// consecutive slots of a row at a time (grid-stride): one 16-byte store
// per f32 stream and one 4-byte store per int8 stream, so a warp's stores
// of a stream are contiguous; the row's k, xoff, jlo, jhi are one 16-byte
// load; the three tables (with the sentinel's zero row and column) sit in
// shared memory. Widths off a multiple of 4 (or outputs off the 16-byte
// grid) run the same body with per-slot stores.

constexpr int kPrepThreads = 256;
constexpr int kPrepBlocks = 8192;  // the grid-stride loop's blocks at most
constexpr int kSentinel = 5;
constexpr int kRowValid = 32;  // row bit: the row's posteriors pass (not in pm)

struct PrepArgs {
  const int8_t* sx;
  const int8_t* sy;
  int sx_stride, sy_stride;  // between pairs' symbol rows: 0 when all read one
  int nx, ny, LY, pad_off;
  const int4* rows;      // (B * R): {k, xoff, jlo, jhi}
  const int8_t* bits;    // (B * R): kPmAtEnd | kPmBridge | kRowValid
  const float* gx;       // (5,) gap x emissions
  const float* gy;       // (5,)
  const float* gm;       // (5, 5) match emissions
  float *ex, *ey, *em, *efx, *efy, *efm;
  int8_t *pm, *wx, *wy;  // all (B, R, W)
};

// A symbol as a table index: 0..4, anything else the sentinel's 5.
__device__ __forceinline__ int sym_index(int s) {
  return (unsigned)s < (unsigned)kSentinel ? s : kSentinel;
}

template <bool kVec>
__global__ void __launch_bounds__(kPrepThreads) wavefront_prep(PrepArgs p, int B, int R, int W) {
  // gx and gy with the sentinel's 0 (6 each), then gm as 6 x 6 with row
  // and column 5 zero
  __shared__ float tab[6 + 6 + 36];
  for (int i = threadIdx.x; i < 48; i += blockDim.x) {
    float v = 0.f;
    if (i < 6) {
      if (i < 5) v = p.gx[i];
    } else if (i < 12) {
      if (i < 11) v = p.gy[i - 6];
    } else {
      const int a = (i - 12) / 6, c = (i - 12) % 6;
      if (a < 5 && c < 5) v = p.gm[a * 5 + c];
    }
    tab[i] = v;
  }
  __syncthreads();
  const float* gx = tab;
  const float* gy = tab + 6;
  const float* gm = tab + 12;

  const int groups = (W + 3) / 4;  // 4-slot groups per row
  const long long total = (long long)B * R * groups;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += (long long)gridDim.x * blockDim.x) {
    const long long row = g / groups;
    const int j0 = (int)(g - row * groups) * 4;
    const int b = (int)(row / R);
    const int4 rw = p.rows[row];  // k, xoff, jlo, jhi
    const int bits = p.bits[row];
    const int ox = min(max(rw.y - 1 + p.pad_off, 0), p.nx - W - 1);
    const int oy = min(max(p.LY - rw.x + rw.y - 1 + p.pad_off, 0), p.ny - W - 1);
    const int8_t* sx = p.sx + (size_t)b * p.sx_stride + ox + j0;
    const int8_t* sy = p.sy + (size_t)b * p.sy_stride + oy + j0;
    int wxs[5], wys[5];  // window symbols j0 .. j0 + 4 (the window has W + 1)
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const bool in = kVec || j0 + q <= W;
      wxs[q] = in ? sx[q] : kSentinel;
      wys[q] = in ? sy[q] : kSentinel;
    }
    float o[6][4];
    int8_t opm[4], owx[4], owy[4];
    const int row_pm = bits & (kPmAtEnd | kPmBridge);
    const bool row_ok = (bits & kRowValid) != 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      const bool slot_ok = j >= rw.z && j <= rw.w;
      const float fm = slot_ok ? 1.f : 0.f;
      const int a0 = sym_index(wxs[q]), a1 = sym_index(wxs[q + 1]);
      const int c0 = sym_index(wys[q]), c1 = sym_index(wys[q + 1]);
      o[0][q] = gx[a0] * fm;
      o[1][q] = gy[c1] * fm;
      o[2][q] = gm[a0 * 6 + c1] * fm;
      o[3][q] = gx[a1] * fm;
      o[4][q] = gy[c0] * fm;
      o[5][q] = gm[a1 * 6 + c0] * fm;
      const int xs = rw.y + j, ys = rw.x - xs;
      const bool ok = row_ok && slot_ok;
      opm[q] = (int8_t)((ok && xs > 0 && ys > 0 ? kPmMatch : 0) | (ok && xs > 0 ? kPmGapX : 0) |
                        (ok && ys > 0 ? kPmGapY : 0) | row_pm);
      owx[q] = (int8_t)wxs[q];
      owy[q] = (int8_t)wys[q + 1];
    }
    const size_t at = (size_t)row * W + j0;
    float* const outs[6] = {p.ex, p.ey, p.em, p.efx, p.efy, p.efm};
    if constexpr (kVec) {
#pragma unroll
      for (int s = 0; s < 6; ++s)
        *reinterpret_cast<float4*>(outs[s] + at) = make_float4(o[s][0], o[s][1], o[s][2], o[s][3]);
      *reinterpret_cast<char4*>(p.pm + at) = make_char4(opm[0], opm[1], opm[2], opm[3]);
      *reinterpret_cast<char4*>(p.wx + at) = make_char4(owx[0], owx[1], owx[2], owx[3]);
      *reinterpret_cast<char4*>(p.wy + at) = make_char4(owy[0], owy[1], owy[2], owy[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j0 + q >= W) break;
#pragma unroll
        for (int s = 0; s < 6; ++s) outs[s][at + q] = o[s][q];
        p.pm[at + q] = opm[q];
        p.wx[at + q] = owx[q];
        p.wy[at + q] = owy[q];
      }
    }
  }
}

int prep_entry(const PrepArgs& p, int B, int R, int W, void* stream) {
  if (B < 0 || R < 0 || W < 1 || p.nx < W + 1 || p.ny < W + 1 || p.sx_stride < 0 ||
      p.sy_stride < 0 || reinterpret_cast<uintptr_t>(p.rows) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = (long long)B * R * ((W + 3) / 4);
  if (groups == 0) return 0;
  // 16-byte stores of the f32 streams and 4-byte stores of the int8 ones
  bool vec = W % 4 == 0;
  for (const void* q : {(const void*)p.ex, (const void*)p.ey, (const void*)p.em,
                        (const void*)p.efx, (const void*)p.efy, (const void*)p.efm})
    vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (const void* q : {(const void*)p.pm, (const void*)p.wx, (const void*)p.wy})
    vec = vec && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const int blocks =
      (int)std::min<long long>((groups + kPrepThreads - 1) / kPrepThreads, kPrepBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    wavefront_prep<true><<<blocks, kPrepThreads, 0, st>>>(p, B, R, W);
  else
    wavefront_prep<false><<<blocks, kPrepThreads, 0, st>>>(p, B, R, W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wavefront_rows: the stream prep's row part
// ---------------------------------------------------------------------------
//
// Replaces the rest of _precompute_one (cpecan_tpu/ops/fb_wavefront.py:
// 874-945) and of its window forms _prep_window (fb_segmented.py:72) and
// _prep_one (fb_parallel.py:96): the work per row (diagonal) and per pair
// that feeds wavefront_prep and the three wavefront kernels, which the
// plain versions (ops/fb_wavefront.py rows_reference and
// rows_window_reference) do in ~70 tensor ops. One block per pair (batch
// form) or per window of one long pair (window form: offsets null). Per
// row k:
//   - the x-frame. Batch form: xlo = floor((k + offset) / 2) (a floor for
//     negative sums too), xoff = the running max of xlo over rows 0..k (a
//     block scan per tile of rows, its max carried to the next tile), jlo
//     = xlo - xoff, jhi = xlo + width - 1 - xoff, written as int64;
//     delta = xoff[k] - xoff[k-1] (0 at row 0 and past the last row),
//     read back from those outputs after a block barrier. Window form:
//     the long pair's frame at global diagonal k = start + r, read at k +
//     off clamped to [0, last], and shifted by the window's slot base;
//   - the eight shift selects from delta and its neighbours (d_{k-1},
//     d_{k+1}, d_{k+2} and dmid of row k+1; the batch form's dmid1 is 0
//     on the last row, the window form's d1 + delta - 1);
//   - pm's row bits (kPmAtEnd at k == L, kPmBridge for 1 <= k < L) and
//     kRowValid (1 <= k <= L, in the window form also inside the emitted
//     rows [lo, hi));
//   - the row tensor {k, xoff, jlo, jhi} int32 that wavefront_prep reads.
// Per pair (batch form): the padded symbols sx_pad and sy_pad (sy
// reversed, W + 1 sentinels on each side, the sentinel past each length),
// the start row F0 over its max m0 (a NaN-propagating max from 0, then m0
// := m0 > 0 ? m0 : 1), log m0, and the end row masked to the band slots of
// diagonal clamp(L, 0, P). Block 0 also writes the emission tables in
// probability space (gap x, gap y, match: 35 floats), which wavefront_prep
// reads in place of separate exp launches.
// Bit-equal to the plain version on the card: integer logic, and expf,
// logf, one IEEE division and multiplies by 1 or 0 on the same f32
// inputs as torch's exp, log and division there (the file is built
// without fast-math).
//
// What bounds it on the card: bytes, a few dozen a row (the int64 frame,
// the row tensor, the selects and bits) and 2 x S x W floats a pair: at
// the headline batch ~22 MB against the slot part's 1.8 GB. It exists to
// take the row part's ~95 launches, and their host time, off every prep;
// one block per pair is enough for that.

constexpr int kRowsThreads = 256;
constexpr int kEmissionTables = 5 + 5 + 25;  // gap x, gap y, match

struct RowsArgs {
  int S;
  // log-space model buffers (device f32)
  const float *em_gap_x, *em_gap_y, *em_match, *start, *ragged_start, *end, *ragged_end;
  // batch form: the (B, n) symbols, (B, R) band, (B,) lengths and ragged
  // flags, each with its element type (1 int8, -1 uint8 or bool, 2, 4, 8)
  const void *sx, *sy, *offsets, *widths, *lx, *ly, *rl, *rr;
  int sx_t, sy_t, off_t, wid_t, lx_t, ly_t, rl_t, rr_t;
  int LX, LY;
  // window form: the long pair's frame (nf rows each), the windows'
  // first diagonals, slot bases and emitted row ranges (both nullable)
  const int64_t *fxoff, *fdelta, *fjlo, *fjhi;
  int nf;
  const int64_t *starts, *base, *emit;
  int L;
  // outputs of both forms
  float* tables;  // (kEmissionTables,)
  int4* rows;     // (B * R): {k, xoff, jlo, jhi}
  int8_t* bits;   // (B * R)
  int8_t* sel;    // (8, B * R): a, b1, b0, abw, c1, c0, bm1, bm0
  // outputs of the batch form
  int8_t *sx_pad, *sy_pad;  // (B, LX + 2(W+1)), (B, LY + 2(W+1))
  int64_t *xoff, *jlo, *jhi, *Lout;
  float *F0, *m0log, *end_row;  // (B, S, W), (B,), (B, S, W)
};

__device__ __forceinline__ long long load_int(const void* p, size_t i, int type) {
  switch (type) {
    case 1: return static_cast<const int8_t*>(p)[i];
    case -1: return static_cast<const uint8_t*>(p)[i];
    case 2: return static_cast<const int16_t*>(p)[i];
    case 4: return static_cast<const int32_t*>(p)[i];
    default: return static_cast<const int64_t*>(p)[i];
  }
}

// floor(v / 2), also for negative v (C's / truncates toward zero)
__device__ __forceinline__ long long floor_half(long long v) {
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

__device__ __forceinline__ void write_row(const RowsArgs& p, size_t n, size_t at, long long k,
                                          long long xoff, long long jlo, long long jhi,
                                          long long delta, long long d_km1, long long d1,
                                          long long d2, long long dmid1, bool valid,
                                          bool at_end, bool bridge) {
  const long long dmid = delta + d_km1 - 1, dsum2 = d1 + d2;
  const bool sel[8] = {delta == 1, dmid == 1, dmid == 0,  d1 == 1,
                       dsum2 == 2, dsum2 == 1, dmid1 == 1, dmid1 == 0};
#pragma unroll
  for (int c = 0; c < 8; ++c) p.sel[c * n + at] = (int8_t)sel[c];
  p.bits[at] = (int8_t)((valid ? kRowValid : 0) | (at_end ? kPmAtEnd : 0) |
                        (bridge ? kPmBridge : 0));
  p.rows[at] = make_int4((int)k, (int)xoff, (int)jlo, (int)jhi);
}

template <bool kWindow>
__global__ void __launch_bounds__(kRowsThreads) wavefront_rows(RowsArgs p, int B, int R, int W) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (b == 0) {
    for (int i = tid; i < kEmissionTables; i += blockDim.x)
      p.tables[i] = expf(i < 5 ? p.em_gap_x[i] : i < 10 ? p.em_gap_y[i - 5] : p.em_match[i - 10]);
  }
  const size_t n = (size_t)B * R;
  const size_t row0 = (size_t)b * R;

  if constexpr (kWindow) {
    const long long s0 = p.starts[b];
    const long long bs = p.base != nullptr ? p.base[b] : 0;
    const long long lo = p.emit != nullptr ? p.emit[2 * b] : s0;
    const long long hi = p.emit != nullptr ? p.emit[2 * b + 1] : s0 + R;
    const long long last = p.nf - 1;
    for (int r = tid; r < R; r += blockDim.x) {
      const long long k = s0 + r;
      const auto at = [&](const int64_t* f, int off) {
        return f[min(max(k + off, 0LL), last)];
      };
      const long long delta = at(p.fdelta, 0), d1 = at(p.fdelta, 1);
      write_row(p, n, row0 + r, k, at(p.fxoff, 0) + bs, at(p.fjlo, 0) - bs, at(p.fjhi, 0) - bs,
                delta, at(p.fdelta, -1), d1, at(p.fdelta, 2), d1 + delta - 1,
                k >= lo && k < hi && k >= 1 && k <= p.L, k == p.L, k >= 1 && k < p.L);
    }
    return;
  }

  // ---- batch form: one pair
  const long long lxb = load_int(p.lx, b, p.lx_t), lyb = load_int(p.ly, b, p.ly_t);
  const long long L = lxb + lyb;
  if (tid == 0) p.Lout[b] = L;
  const int nxp = p.LX + 2 * (W + 1), nyp = p.LY + 2 * (W + 1);
  for (int i = tid; i < nxp; i += blockDim.x) {
    const int q = i - (W + 1);
    p.sx_pad[(size_t)b * nxp + i] =
        q >= 0 && q < p.LX && q < lxb ? (int8_t)load_int(p.sx, (size_t)b * p.LX + q, p.sx_t)
                                      : (int8_t)kSentinel;
  }
  for (int i = tid; i < nyp; i += blockDim.x) {
    const int q = p.LY - 1 - (i - (W + 1));  // sy reversed
    p.sy_pad[(size_t)b * nyp + i] =
        q >= 0 && q < p.LY && q < lyb ? (int8_t)load_int(p.sy, (size_t)b * p.LY + q, p.sy_t)
                                      : (int8_t)kSentinel;
  }

  // the start row over its max; every thread takes the same S values
  const int S = p.S;
  const float* sv = load_int(p.rl, b, p.rl_t) != 0 ? p.ragged_start : p.start;
  float m0 = 0.f;  // exp is >= 0 (or NaN), so a max from 0 is F0's at any W
  for (int s = 0; s < S; ++s) m0 = max_nan(m0, expf(sv[s]));
  m0 = m0 > 0.f ? m0 : 1.f;
  if (tid == 0) p.m0log[b] = logf(m0);
  for (int i = tid; i < S * W; i += blockDim.x)
    p.F0[(size_t)b * S * W + i] = (i % W == 0 ? expf(sv[i / W]) : 0.f) / m0;

  // the x-frame: a block max-scan of xlo per tile, carried across tiles
  __shared__ long long warp_max[kRowsThreads / 32];
  __shared__ long long carry;
  if (tid == 0) carry = LLONG_MIN;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int t0 = 0; t0 < R; t0 += blockDim.x) {
    const int k = t0 + tid;
    long long xlo = LLONG_MIN, wd = 0;
    if (k < R) {
      xlo = floor_half(k + load_int(p.offsets, row0 + k, p.off_t));
      wd = load_int(p.widths, row0 + k, p.wid_t);
    }
    long long v = xlo;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = max(v, u);
    }
    if (lane == 31) warp_max[warp] = v;
    __syncthreads();
    long long before = carry;
    for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
    v = max(v, before);
    if (k < R) {
      p.xoff[row0 + k] = v;
      p.jlo[row0 + k] = xlo - v;
      p.jhi[row0 + k] = xlo + wd - 1 - v;
    }
    __syncthreads();  // carry and warp_max read by every thread
    if (tid == blockDim.x - 1) carry = v;
    __syncthreads();
  }

  // per row, from the frame this block wrote (visible after the barrier)
  const int64_t* xo = p.xoff + row0;
  const auto d = [&](int i) -> long long { return i >= 1 && i < R ? xo[i] - xo[i - 1] : 0; };
  for (int k = tid; k < R; k += blockDim.x) {
    const long long delta = d(k), d1 = d(k + 1);
    write_row(p, n, row0 + k, k, xo[k], p.jlo[row0 + k], p.jhi[row0 + k], delta, d(k - 1), d1,
              d(k + 2), k < R - 1 ? d1 + delta - 1 : 0, k >= 1 && k <= L, k == L,
              k >= 1 && k < L);
  }

  // the end row: the end vector masked to the band slots of row clamp(L, 0, P)
  const long long rowL = min(max(L, 0LL), (long long)R - 1);
  const long long lo = p.jlo[row0 + rowL], hi = p.jhi[row0 + rowL];
  const float* ev = load_int(p.rr, b, p.rr_t) != 0 ? p.ragged_end : p.end;
  for (int i = tid; i < S * W; i += blockDim.x) {
    const int j = i % W;
    p.end_row[(size_t)b * S * W + i] = expf(ev[i / W]) * (j >= lo && j <= hi ? 1.f : 0.f);
  }
}

int rows_entry(const RowsArgs& p, int B, int R, int W, void* stream) {
  const bool window = p.offsets == nullptr;
  if (B < 0 || R < 0 || W < 1 || reinterpret_cast<uintptr_t>(p.rows) % 16 != 0 ||
      (window ? p.nf < 1 || p.starts == nullptr : p.S < 1 || p.LX < 0 || p.LY < 0 ||
                                                   (B > 0 && R < 1)))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (window)
    wavefront_rows<true><<<B, kRowsThreads, 0, st>>>(p, B, R, W);
  else
    wavefront_rows<false><<<B, kRowsThreads, 0, st>>>(p, B, R, W);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes). Each returns the cudaError_t of
// the launch (0 on success); the wrapper raises on anything else. The
// *_wide entry points take the wide variants at any W (the wrappers use
// them above kMaxWidth); bwd and exp's take the (B, 3, S, W) scratch.
extern "C" {

// F0 null: a window, started from the carry ci1/ci2/cim (all given);
// co1/co2/com: the carry out, all null or all given.
int cpecan_wavefront_fwd(int S, const float* t_host, const float* ex, const float* ey,
                         const float* em, const int8_t* a, const int8_t* b1, const int8_t* b0,
                         const float* F0, const float* ci1, const float* ci2, const float* cim,
                         float* F, float* bv, float* mf, float* co1, float* co2, float* com,
                         int B, int R, int W, int k0, void* stream) {
  return fwd_entry(false, S, t_host, ex, ey, em, a, b1, b0, F0, ci1, ci2, cim, F, bv, mf, co1,
                   co2, com, B, R, W, k0, stream);
}

int cpecan_wavefront_fwd_wide(int S, const float* t_host, const float* ex, const float* ey,
                              const float* em, const int8_t* a, const int8_t* b1,
                              const int8_t* b0, const float* F0, const float* ci1,
                              const float* ci2, const float* cim, float* F, float* bv, float* mf,
                              float* co1, float* co2, float* com, int B, int R, int W, int k0,
                              void* stream) {
  return fwd_entry(true, S, t_host, ex, ey, em, a, b1, b0, F0, ci1, ci2, cim, F, bv, mf, co1,
                   co2, com, B, R, W, k0, stream);
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
  const float* ci[5] = {ci_b1, ci_b2, ci_invb, ci_em, ci_bv};
  float* co[5] = {co_b1, co_b2, co_invb, co_em, co_bv};
  return bwd_entry(false, S, t_host, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm,
                   end_row, post_m, post_x, post_y, mb, tot, ci, co, nullptr, B, R, W, k0,
                   stream);
}

int cpecan_wavefront_bwd_wide(int S, const float* t_host, const float* efx, const float* efy,
                              const float* efm, const float* em, const float* F,
                              const float* bv, const int8_t* abw, const int8_t* c1,
                              const int8_t* c0, const int8_t* bm1, const int8_t* bm0,
                              const int8_t* pm, const float* end_row, float* post_m,
                              float* post_x, float* post_y, float* mb, float* tot,
                              const float* ci_b1, const float* ci_b2, const float* ci_invb,
                              const float* ci_em, const float* ci_bv, float* co_b1,
                              float* co_b2, float* co_invb, float* co_em, float* co_bv,
                              float* scratch, int B, int R, int W, int k0, void* stream) {
  const float* ci[5] = {ci_b1, ci_b2, ci_invb, ci_em, ci_bv};
  float* co[5] = {co_b1, co_b2, co_invb, co_em, co_bv};
  return bwd_entry(true, S, t_host, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm,
                   end_row, post_m, post_x, post_y, mb, tot, ci, co, scratch, B, R, W, k0,
                   stream);
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
  const float* ci[5] = {ci_b1, ci_b2, ci_invb, ci_em, ci_bv};
  float* co[5] = {co_b1, co_b2, co_invb, co_em, co_bv};
  return exp_entry(false, S, t_host, efx, efy, efm, em, ex, ey, F, bv, abw, c1, c0, bm1, bm0, a,
                   b1, b0, pm, end_row, adj1, adj2, wx, wy, trans, emis, eacc, mb, tot, fhc, ci,
                   co, nullptr, B, R, W, k0, stream);
}

int cpecan_wavefront_exp_wide(int S, const float* t_host, const float* efx, const float* efy,
                              const float* efm, const float* em, const float* ex,
                              const float* ey, const float* F, const float* bv,
                              const int8_t* abw, const int8_t* c1, const int8_t* c0,
                              const int8_t* bm1, const int8_t* bm0, const int8_t* a,
                              const int8_t* b1, const int8_t* b0, const int8_t* pm,
                              const float* end_row, const float* adj1, const float* adj2,
                              const int8_t* wx, const int8_t* wy, float* trans, float* emis,
                              float* eacc, float* mb, float* tot, const float* fhc,
                              const float* ci_b1, const float* ci_b2, const float* ci_invb,
                              const float* ci_em, const float* ci_bv, float* co_b1,
                              float* co_b2, float* co_invb, float* co_em, float* co_bv,
                              float* scratch, int B, int R, int W, int k0, void* stream) {
  const float* ci[5] = {ci_b1, ci_b2, ci_invb, ci_em, ci_bv};
  float* co[5] = {co_b1, co_b2, co_invb, co_em, co_bv};
  return exp_entry(true, S, t_host, efx, efy, efm, em, ex, ey, F, bv, abw, c1, c0, bm1, bm0, a,
                   b1, b0, pm, end_row, adj1, adj2, wx, wy, trans, emis, eacc, mb, tot, fhc, ci,
                   co, scratch, B, R, W, k0, stream);
}

// The launch plans of wavefront_fwd, wavefront_bwd and wavefront_exp at
// (S, W) for streams on the 16-byte grid (aligned != 0) or off it: out =
// {threads, band slots per compute thread, ring depth (0: direct loads),
// dynamic shared memory bytes}.
int cpecan_wavefront_fwd_plan(int S, int W, int aligned, int* out) {
  if (bad_shape(S, 1, 1, W)) return (int)cudaErrorInvalidValue;
  const Plan pl = fwd_plan(S, W, aligned != 0);
  out[0] = pl.threads, out[1] = pl.slots, out[2] = pl.depth, out[3] = (int)pl.smem;
  return 0;
}

int cpecan_wavefront_bwd_plan(int S, int W, int aligned, int* out) {
  if (bad_shape(S, 1, 1, W)) return (int)cudaErrorInvalidValue;
  const Plan pl = bwd_plan(S, W, aligned != 0);
  out[0] = pl.threads, out[1] = pl.slots, out[2] = pl.depth, out[3] = (int)pl.smem;
  return 0;
}

int cpecan_wavefront_exp_plan(int S, int W, int aligned, int* out) {
  if (bad_shape(S, 1, 1, W)) return (int)cudaErrorInvalidValue;
  const Plan pl = exp_plan(S, W, aligned != 0, W > kExpSharedWidth);
  out[0] = pl.threads, out[1] = pl.slots, out[2] = pl.depth, out[3] = (int)pl.smem;
  return 0;
}

// The wide kernels' launch at (S, W), bwd's (exp == 0) or exp's here and
// fwd's below: out = {cluster size (0: the global-scratch kernel), band
// slots per thread, slice, threads per CTA, dynamic shared memory bytes}.
int cpecan_wavefront_back_wide_plan(int S, int W, int exp, int* out) {
  if (bad_shape(S, 1, 1, W, true)) return (int)cudaErrorInvalidValue;
  const ClusterPlan pl = back_wide_plan(S, W, exp != 0);
  out[0] = pl.cluster, out[1] = pl.slots, out[2] = pl.slice, out[3] = pl.threads;
  out[4] = (int)pl.smem;
  return 0;
}

int cpecan_wavefront_fwd_wide_plan(int S, int W, int* out) {
  if (bad_shape(S, 1, 1, W, true)) return (int)cudaErrorInvalidValue;
  const ClusterPlan pl = fwd_wide_plan(S, W);
  out[0] = pl.cluster, out[1] = pl.slots, out[2] = pl.slice, out[3] = pl.threads;
  out[4] = (int)pl.smem;
  return 0;
}

// Sets the cluster size of the three wide kernels' cluster variants (2 ..
// kClusterMax; 0: the global-scratch kernels at every width) and returns
// the one before, or -1 for a size it cannot take.
int cpecan_wavefront_set_cluster_limit(int cluster) {
  if (cluster != 0 && (cluster < 2 || cluster > kClusterMax)) return -1;
  const int before = g_cluster_limit;
  g_cluster_limit = cluster;
  return before;
}

// The stream prep's slot part (wavefront_prep): sx, sy int8 padded
// symbols with their pair strides (0: one pair for every row) and
// lengths; rows (B, R, 4) int32 {k, xoff, jlo, jhi}; bits (B, R) int8;
// the gap x, gap y (5,) and match (5, 5) emission tables on the device;
// the outputs ex, ey, em, efx, efy, efm (B, R, W) f32 and pm, wx, wy (B, R,
// W) int8.
int cpecan_wavefront_prep(const int8_t* sx, const int8_t* sy, int sx_stride, int sy_stride,
                          int nx, int ny, int LY, int pad_off, const int32_t* rows,
                          const int8_t* bits, const float* gx, const float* gy, const float* gm,
                          float* ex, float* ey, float* em, float* efx, float* efy, float* efm,
                          int8_t* pm, int8_t* wx, int8_t* wy, int B, int R, int W,
                          void* stream) {
  const PrepArgs p = {sx, sy, sx_stride, sy_stride, nx, ny, LY, pad_off,
                      reinterpret_cast<const int4*>(rows), bits, gx, gy, gm,
                      ex, ey, em, efx, efy, efm, pm, wx, wy};
  return prep_entry(p, B, R, W, stream);
}

// The stream prep's row part (wavefront_rows). S and the model's seven
// log-space buffers; the batch form's sx, sy (B, LX), (B, LY), offsets,
// widths (B, R), lx, ly, ragged_left, ragged_right (B,) with their eight
// element types (1 int8, -1 uint8 or bool, 2 int16, 4 int32, 8 int64), or
// null offsets for the window form: the long pair's frame xoff, delta,
// jlo, jhi (nf,) int64, starts (B,) int64, base (B,) and emit (B, 2) int64
// (both nullable) and the pair's L. Outputs: tables (35,) f32, rows (B,
// R, 4) int32, bits (B, R) int8, selects (8, B, R) int8; the batch form's
// sx_pad (B, LX + 2(W+1)), sy_pad (B, LY + 2(W+1)) int8, xoff, jlo, jhi
// (B, R) and L (B,) int64, F0 (B, S, W), m0log (B,), end_row (B, S, W)
// f32 (all null in the window form).
int cpecan_wavefront_rows(int S, const float* em_gap_x, const float* em_gap_y,
                          const float* em_match, const float* start, const float* ragged_start,
                          const float* end, const float* ragged_end, const void* sx,
                          const void* sy, const void* offsets, const void* widths, const void* lx,
                          const void* ly, const void* ragged_left, const void* ragged_right,
                          int sx_t, int sy_t, int off_t, int wid_t, int lx_t, int ly_t, int rl_t,
                          int rr_t, int LX, int LY, const int64_t* fxoff, const int64_t* fdelta,
                          const int64_t* fjlo, const int64_t* fjhi, int nf,
                          const int64_t* starts, const int64_t* base, const int64_t* emit, int L,
                          float* tables, int32_t* rows, int8_t* bits, int8_t* selects,
                          int8_t* sx_pad, int8_t* sy_pad, int64_t* xoff, int64_t* jlo,
                          int64_t* jhi, int64_t* Lout, float* F0, float* m0log, float* end_row,
                          int B, int R, int W, void* stream) {
  const RowsArgs p = {S, em_gap_x, em_gap_y, em_match, start, ragged_start, end, ragged_end,
                      sx, sy, offsets, widths, lx, ly, ragged_left, ragged_right,
                      sx_t, sy_t, off_t, wid_t, lx_t, ly_t, rl_t, rr_t, LX, LY,
                      fxoff, fdelta, fjlo, fjhi, nf, starts, base, emit, L,
                      tables, reinterpret_cast<int4*>(rows), bits, selects,
                      sx_pad, sy_pad, xoff, jlo, jhi, Lout, F0, m0log, end_row};
  return rows_entry(p, B, R, W, stream);
}

const char* cpecan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
