// Hand-written Hopper (sm_90a) kernel of bf16 attention (repro_torch
// serving): TMA loads, wgmma on the tensor cores, mbarrier pipelines and
// warp specialisation.
//
// It replaces the JAX package's Pallas TPU kernel:
//   repro_flash_attention_hopper  <- src/repro/kernels/flash_attention.py
//                                    flash_attention_bhsd
// for bfloat16 operands. float32 operands take attention_hopper_f32.cu
// (3xTF32 products on the tensor cores).
//
// The function is the TPU kernel's: s = (q . k) * scale in f32; a masked
// score is the finite -1e30 (kpos < kv_len; causal qpos >= kpos; window
// qpos - kpos < window, OR-ed with kpos < prefix when a prefix is set;
// positions absolute, from 0); the running max starts
// at -1e30, so a row that no key sees ends as the mean of all Sk rows of V;
// keys past Sk score -inf; p stays f32 for the PV product (to about 16 bits
// here, see below); the result is acc / max(l, 1e-30), cast once to bf16.
// Query head h of batch row b reads kv head h / n_rep (GQA: K and V are
// never repeated). q, k and v are (B, S, heads, D) with any (batch, seq,
// head) strides that are multiples of 8 elements, a contiguous head dim and
// 16-byte aligned bases; the output is a contiguous (B, Sq, H, D) tensor.
//
// Bound: bytes at the serving prefill (B=8, S=512, H=16, KV=8, D=128,
// causal: 50.3 MB against 8.6 GFLOP, 0.015 ms at 3.35 TB/s), operations
// from S of a few thousand on (B=4, S=4096: 2.75e11 flops of the visible
// pairs, 0.278 ms at 989.4 TFLOP/s of dense bf16). Both ask for the tensor
// cores, fed from shared memory without the threads' help:
//
// * Grid: one CTA of 384 threads per (b h, tile of 128 queries); the last
//   query tiles, the heaviest under a causal mask, are scheduled first.
// * Warp specialisation: warpgroups 0 and 1 are consumers and own 64 query
//   rows each; warpgroup 2 is the producer, and one of its threads issues
//   every TMA load. setmaxnreg moves registers from the producer (24) to
//   the consumers (240).
// * TMA: one tensor map per operand over (D, heads, S, B) with the
//   caller's strides, encoded on the host per call and passed as a
//   __grid_constant__ parameter. A box is 64 head-dim values (128 bytes,
//   the 128-byte swizzle's span) by 128 rows (Q, K and V for D <= 128) or
//   64 rows (K and V for D = 256), so a tile of D = 128 or 256 is 2 or 4
//   boxes side by side. D = 80 and 112 take two boxes, the second one
//   zero-filled past D by TMA; those zero columns are never multiplied
//   (QK^T stops at D, and the PV product's last n-block is 16 or 48 wide).
//   Rows past S are zero-filled too. Q is loaded once; K and V tiles go
//   through a ring of 2 stages with a full barrier each for K and V (so
//   QK^T starts before V lands) and an empty barrier that all 256 consumer
//   threads arrive on once they are done with the stage.
// * QK^T: wgmma.m64n64k16 with Q and K both K-major (D contiguous) in
//   128-byte-swizzled shared memory, f32 accumulators, BK / 64 blocks of 64
//   keys; then scale, mask and the online max and sum in registers (a row
//   lives in the 4 threads of a quad: max by two xor shuffles, sums kept
//   per thread and added at the end), p = 2^((x - m) log2 e) on the
//   special-function unit. A tile that all 64 rows of a warpgroup see in
//   full skips the mask.
// * PV, the numeric crux: the reference keeps p in f32, and a bf16 A
//   operand would round it to 8 bits, which can exceed the one-bf16-ulp
//   limit the port is held to. So p = p_hi + p_lo, p_hi = bf16(p), p_lo =
//   bf16(p - p_hi), and two wgmma.m64nNk16 run with A from registers (the
//   S accumulator's layout is already the A fragment's, so the re-pack is
//   a cast of register pairs) and V from shared memory. V is (keys, D) with
//   D contiguous, an MN-major B operand: the transpose bit of 16-bit wgmma.
//   p is then carried to about 16 bits (relative error 2^-17), and the PV
//   tensor work doubles: 1.5x the useful flops in all.
// * Skipped tiles: a tile masked for every row of a block adds exactly 0
//   once a visible tile has set the row's max, or is wiped (alpha = 0)
//   after; so where every query row sees a key (the wrapper decides:
//   kv_len >= 1, and with a window and no prefix, Sq - 1 < kv_len - 1 +
//   window), a block visits only keys below its last row (causal), below
//   kv_len, and from its first row's window start on (no prefix);
//   otherwise every tile, so that a row no key sees keeps the mean of V. kernels/flash_attention.py::kv_tile_starts is
//   the same range in Python, held to the mask by a CPU test.
// * The epilogue divides by max(l, 1e-30) and stores bf16 pairs straight
//   from the accumulator registers, skipping rows past Sq and columns past
//   D.
//
// Later work: a persistent grid, and overlapping one warpgroup's softmax
// with its next QK^T.
//
// The tensor-map encoder (cuTensorMapEncodeTiled) is a driver function: it
// is looked up in the already loaded libcuda.so.1 with dlsym, so the
// library links no -lcuda. The exported function launches on the caller's
// stream and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take or
// tensor maps the driver refuses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;         // query rows of a CTA
constexpr int kConsumers = 256;  // two consumer warpgroups of 64 rows each
constexpr int kThreads = 384;    // and one producer warpgroup
constexpr int kStages = 2;       // the K/V ring
constexpr int kRowBytes = 128;   // one swizzled row: 64 bf16 of the head dim
constexpr float kNegInf = -1e30f;  // the TPU kernel's masked score
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  int64_t o_sb, o_ss, o_sh;
  int H, n_rep, Sq, Sk;
  int causal, window, prefix, kv_len, skip;
  float scale;
};

template <int D, int BK>
struct Tile {
  static constexpr int kChunks = (D + 63) / 64;  // 64-wide boxes of a row
  static constexpr int kSteps = D / 16;          // k16 steps of QK^T
  static constexpr int kBlocks = BK / 64;        // n64 blocks of S
  static constexpr int kQBytes = kChunks * kBQ * kRowBytes;
  static constexpr int kKVBytes = kChunks * BK * kRowBytes;  // K or V stage
  static constexpr int kBarBytes = 64;
  // + 1024: the base is rounded up to the swizzle atom
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + kBarBytes + 1024;
  static_assert(D % 16 == 0 && BK % 64 == 0, "tile");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving uses of a wgmma operand register across
// the asynchronous product's issue or wait
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// S[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x N] += A[64 x 16] B[16 x N], A from registers (the m64k16 bf16
// fragment), B MN-major in shared memory (transposed: imm-trans-b = 1)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}"
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the score of (qpos, kpos) after scale and mask, as the TPU kernel's
__device__ __forceinline__ float masked(const Params& p, float s, int qpos,
                                        int kpos) {
  bool vis = kpos < p.kv_len;
  if (p.causal) vis = vis && qpos >= kpos;
  if (p.window > 0) vis = vis && (qpos - kpos < p.window || kpos < p.prefix);
  const float x = vis ? __fmul_rn(s, p.scale) : kNegInf;
  return kpos < p.Sk ? x : -INFINITY;
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, as a masked score's exp(-1e30 - m) is 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// scale (and, with kMask, mask) the scores of one tile in place and take
// each of the thread's two rows' max: register 4 g + e of block j holds
// (row, key k0 + 64 j + 8 g + col + e), 4 g + 2 + e the same key of row + 8
template <bool kMask, int kBlocks>
__device__ __forceinline__ void scale_scores(float (&sc)[kBlocks][32],
                                             const Params& p, int k0,
                                             int col, int qpos0, int qpos1,
                                             float& mx0, float& mx1) {
#pragma unroll
  for (int j = 0; j < kBlocks; ++j)
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = sc[j][4 * g + e];
        float& x1 = sc[j][4 * g + 2 + e];
        if (kMask) {
          const int kpos = k0 + 64 * j + 8 * g + col + e;
          x0 = masked(p, x0, qpos0, kpos);
          x1 = masked(p, x1, qpos1, kpos);
        } else {
          x0 = __fmul_rn(x0, p.scale);
          x1 = __fmul_rn(x1, p.scale);
        }
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  using T = Tile<D, BK>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                          // [chunk][128 rows]
  const uint32_t sk = sq + T::kQBytes;               // [stage][chunk][BK]
  const uint32_t sv = sk + kStages * T::kKVBytes;    // [stage][chunk][BK]
  const uint32_t bars = sv + kStages * T::kKVBytes;  // 7 mbarriers
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                  // + 8 s
  const uint32_t v_full = bars + 8 * (1 + kStages);  // + 8 s
  const uint32_t empty = bars + 8 * (1 + 2 * kStages);

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int kvh = h / p.n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  // the kv range this block visits (kernels/flash_attention.py
  // kv_tile_starts)
  int k_lo = 0, k_hi = p.Sk;
  if (p.skip) {
    const int q_last = min(q0 + kBQ, p.Sq) - 1;
    if (p.causal) k_hi = min(k_hi, q_last + 1);
    k_hi = min(k_hi, p.kv_len);
    if (p.window > 0 && p.prefix == 0) k_lo = max(0, q0 - p.window + 1);
  }
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(sq + c * kBQ * kRowBytes, &tq, q_full, 64 * c, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const int k0 = k_lo + t * BK;
        mbar_wait(empty + 8 * s, parity);  // the first round passes
        const uint32_t kb = sk + s * T::kKVBytes, vb = sv + s * T::kKVBytes;
        mbar_expect_tx(k_full + 8 * s, T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(kb + c * BK * kRowBytes, &tk, k_full + 8 * s, 64 * c, kvh,
                   k0, b);
        mbar_expect_tx(v_full + 8 * s, T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(vb + c * BK * kRowBytes, &tv, v_full + 8 * s, 64 * c, kvh,
                   k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // this thread's rows of the accumulators: r and r + 8; its columns of
    // each 8-wide group: 2 (lane % 4) and + 1
    const int row = wg * 64 + warp * 16 + lane / 4;
    const int qpos0 = q0 + row, qpos1 = qpos0 + 8;
    const int col = 2 * (lane % 4);
    const uint32_t sq_wg = sq + wg * 64 * kRowBytes;

    float o[T::kChunks][32];
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int k0 = k_lo + t * BK;
      const uint32_t kb = sk + s * T::kKVBytes, vb = sv + s * T::kKVBytes;

      // S = Q K^T over the head dim's k16 steps
      float sc[T::kBlocks][32];
#pragma unroll
      for (int j = 0; j < T::kBlocks; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[j][i] = 0.0f;
#pragma unroll
      for (int j = 0; j < T::kBlocks; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(sc[j][i]);
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T::kBlocks; ++j) {
#pragma unroll
        for (int ks = 0; ks < T::kSteps; ++ks) {
          const uint32_t off = (ks % 4) * 32;  // 16 bf16 into the 128-byte row
          const uint64_t da =
              desc_sw128(sq_wg + (ks / 4) * kBQ * kRowBytes + off, 16, 1024);
          const uint64_t db = desc_sw128(
              kb + (ks / 4) * BK * kRowBytes + j * 64 * kRowBytes + off, 16,
              1024);
          wgmma_ss_n64(sc[j], da, db, ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < T::kBlocks; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(sc[j][i]);

      // scale and mask (a tile that all 64 rows of this warpgroup see in
      // full takes no mask), then the online softmax
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const int qw0 = q0 + wg * 64;
      const bool full = k0 + BK <= min(p.kv_len, p.Sk) &&
                        (!p.causal || k0 + BK - 1 <= qw0) &&
                        (p.window <= 0 || qw0 + 63 - k0 < p.window);
      if (full) {
        scale_scores<false>(sc, p, k0, col, qpos0, qpos1, mx0, mx1);
      } else {
        scale_scores<true>(sc, p, k0, col, qpos0, qpos1, mx0, mx1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // p = exp(x - m) as 2^((x - m) log2 e)
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2_approx(__fmul_rn(__fsub_rn(m0, mn0), kLog2e));
      const float alpha1 = exp2_approx(__fmul_rn(__fsub_rn(m1, mn1), kLog2e));
      m0 = mn0;
      m1 = mn1;
      float sum0[2] = {0.0f, 0.0f}, sum1[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < T::kBlocks; ++j)
#pragma unroll
        for (int g = 0; g < 8; ++g)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x0 = sc[j][4 * g + e];
            float& x1 = sc[j][4 * g + 2 + e];
            x0 = exp2_approx(__fmul_rn(__fsub_rn(x0, mn0), kLog2e));
            x1 = exp2_approx(__fmul_rn(__fsub_rn(x1, mn1), kLog2e));
            sum0[e] = __fadd_rn(sum0[e], x0);
            sum1[e] = __fadd_rn(sum1[e], x1);
          }
      l0 = __fadd_rn(__fmul_rn(l0, alpha0), __fadd_rn(sum0[0], sum0[1]));
      l1 = __fadd_rn(__fmul_rn(l1, alpha1), __fadd_rn(sum1[0], sum1[1]));
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          o[c][4 * g] = __fmul_rn(o[c][4 * g], alpha0);
          o[c][4 * g + 1] = __fmul_rn(o[c][4 * g + 1], alpha0);
          o[c][4 * g + 2] = __fmul_rn(o[c][4 * g + 2], alpha1);
          o[c][4 * g + 3] = __fmul_rn(o[c][4 * g + 3], alpha1);
        }

      // p = p_hi + p_lo in bf16: the A fragments of the k16 steps over the
      // tile's keys (registers 8 (kk % 4) .. + 7 of block kk / 4)
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sc[kk / 4][8 * (kk % 4) + 2 * r];
          const float c1 = sc[kk / 4][8 * (kk % 4) + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c1);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][r] = pack_bf16(__fsub_rn(a, hf.x), __fsub_rn(c1, hf.y));
        }

      // O += p_hi V + p_lo V, per 64-wide chunk of the head dim
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(o[c][i]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_reg(ph[kk][r]);
          fence_reg(pl[kk][r]);
        }
      mbar_wait(v_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          const uint64_t db =
              desc_sw128(vb + c * BK * kRowBytes + kk * 16 * kRowBytes,
                         BK * kRowBytes, 1024);
          constexpr int kRest = D - 64 * (T::kChunks - 1);  // last chunk
          if (c < T::kChunks - 1 || kRest == 64) {
            wgmma_rs<64>(o[c], ph[kk], db);
            wgmma_rs<64>(o[c], pl[kk], db);
          } else {
            wgmma_rs<kRest>(o[c], ph[kk], db);
            wgmma_rs<kRest>(o[c], pl[kk], db);
          }
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(o[c][i]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_reg(ph[kk][r]);
          fence_reg(pl[kk][r]);
        }
      mbar_arrive(empty + 8 * s);
    }

    // the row sums over the quad, then out = acc / max(l, 1e-30) in bf16
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int d = 64 * c + 8 * g + col;
        if (d >= D) continue;
        if (qpos0 < p.Sq)
          *reinterpret_cast<uint32_t*>(ob + qpos0 * p.o_ss + d) =
              pack_bf16(__fdiv_rn(o[c][4 * g], d0),
                        __fdiv_rn(o[c][4 * g + 1], d0));
        if (qpos1 < p.Sq)
          *reinterpret_cast<uint32_t*>(ob + qpos1 * p.o_ss + d) =
              pack_bf16(__fdiv_rn(o[c][4 * g + 2], d1),
                        __fdiv_rn(o[c][4 * g + 3], d1));
      }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a (D, heads, S, B) bf16 tensor map with boxes of 64 x 1 x rows x 1,
// 128-byte swizzle, zero fill out of bounds; strides in elements
bool encode(CUtensorMap* map, const void* ptr, int D, int heads, int S,
            int B, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Operand {
  const void* ptr;
  int64_t sb, ss, sh;
};

template <int D, int BK>
int launch(const Operand& q, const Operand& k, const Operand& v,
           const Params& p, int B, int KV, cudaStream_t stream) {
  using T = Tile<D, BK>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q.ptr, D, p.H, p.Sq, B, q.sb, q.ss, q.sh, kBQ) ||
      !encode(&tk, k.ptr, D, KV, p.Sk, B, k.sb, k.ss, k.sh, BK) ||
      !encode(&tv, v.ptr, D, KV, p.Sk, B, v.sb, v.ss, v.sh, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (p.Sq + kBQ - 1) / kBQ;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_hopper_kernel<D, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B * p.H, tiles), kThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0 && sb >= 0 && ss >= 0 && sh >= 0;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D): bf16, strides in
// elements with a contiguous head dim. D one of 64, 80, 112, 128, 256.
extern "C" int repro_flash_attention_hopper(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
    int window, int prefix, int kv_len, int skip, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      static_cast<int64_t>(B) * H > 0x7fffffffLL ||
      !aligned(q, q_sb, q_ss, q_sh) || !aligned(k, k_sb, k_ss, k_sh) ||
      !aligned(v, v_sb, v_ss, v_sh) || o_sh % 2 != 0 || o_ss % 2 != 0 ||
      o_sb % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operand qo{q, q_sb, q_ss, q_sh}, ko{k, k_sb, k_ss, k_sh},
      vo{v, v_sb, v_ss, v_sh};
  const Params p{static_cast<__nv_bfloat16*>(o), o_sb, o_ss, o_sh, H, H / KV,
                 Sq, Sk, causal, window, prefix, kv_len, skip, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 128>(qo, ko, vo, p, B, KV, s);
    case 80:
      return launch<80, 128>(qo, ko, vo, p, B, KV, s);
    case 112:
      return launch<112, 128>(qo, ko, vo, p, B, KV, s);
    case 128:
      return launch<128, 128>(qo, ko, vo, p, B, KV, s);
    case 256:
      return launch<256, 64>(qo, ko, vo, p, B, KV, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
