// Hand-written Hopper (sm_90a) kernel of float32 attention (repro_torch
// serving): 3xTF32 products on the tensor cores (wgmma .tf32), TMA loads,
// mbarrier pipelines and warp specialisation.
//
// It replaces the JAX package's Pallas TPU kernel:
//   repro_flash_attention_hopper_f32  <- src/repro/kernels/flash_attention.py
//                                        flash_attention_bhsd
// for float32 operands; bfloat16 operands take attention_hopper.cu.
//
// The function is the TPU kernel's: s = (q . k) * scale in f32; a masked
// score is the finite -1e30 (kpos < kv_len; causal qpos >= kpos; window
// qpos - kpos < window, OR-ed with kpos < prefix when a prefix is set;
// positions absolute, from 0); the running max starts at -1e30, so a row
// that no key sees ends as the mean of all Sk rows of V; keys past Sk score
// -inf; p stays f32 for the PV product; the result is acc / max(l, 1e-30).
// Query head h of batch row b reads kv head h / n_rep (GQA: K and V are
// never repeated). q, k and v are (B, S, heads, D) f32 with any (batch,
// seq, head) strides that are multiples of 4 elements, a contiguous head
// dim and 16-byte aligned bases; the output is a contiguous (B, Sq, H, D)
// tensor.
//
// Precision: the tensor cores multiply TF32 (10 explicit mantissa bits) and
// add in f32. Each f32 operand x is split as hi = rna_tf32(x), lo =
// rna_tf32(x - hi) (cvt.rna: to nearest, ties away), and a product takes
// three terms, hi.hi + hi.lo + lo.hi; the lo.lo term (about 2^-22 of the
// product) is the one dropped. That is CUTLASS's "3xTF32": a product keeps
// about 21 bits, against the 11 of one TF32 term, whose error would exceed
// the port's f32 limit |d| <= 1e-5 + 1e-4 |p| (tests/test_torch_attention_
// f32.py emulates both on the CPU). Every hi is written out rounded, so
// the result does not depend on whether the tensor core truncates or
// rounds the low 13 bits of an f32 word it reads. Both matmuls are split:
// Q K^T (Q, K) and P V (p, V), 6 tensor-core products for the 2 of the
// function. Against the plain version on the card (chip_smoke.py phase 3):
// max |diff| 7.6e-6 at B=4, S=4096, under a third of the limit; more than
// the CPU emulation, which sums the products in f64.
//
// Bound, on an H100 SXM at 700 W: at B=4, S=4096, H=16, KV=8, D=128,
// causal, the visible pairs' 2.75e11 flops take 1.67 ms as three TF32
// products at 494.7 TFLOP/s (4.10 ms at 67 TFLOP/s of f32 on the CUDA
// cores); at the serving prefill (B=8, S=512) 0.052 ms of TF32 work
// against 0.030 ms of bytes. It takes 3.1 ms and 0.16 ms there (phase 3:
// 54 % and 32 % of those bounds; the CUDA-core kernel it replaces took
// 11.5 ms at S=4096). Beside the six products, the CUDA cores convert
// every K and V tile (split, and V transposed), and the shared memory
// carries the products' operands as well as that conversion. The design:
//
// * Grid: one CTA per (b h, tile of 64 NC queries), the last query tiles,
//   the heaviest under a causal mask, first. NC = 2 consumer warpgroups of
//   64 rows each for D <= 128; NC = 1 for D = 256. Warpgroup NC is the
//   producer: its warp 0 issues every TMA load, its warps 1-3 (96
//   threads) convert the K/V tiles. setmaxnreg moves registers from the
//   producer (56) to the consumers (224) within the 168 x 384 the CTA is
//   launched with (NC = 2).
// * TMA: one tensor map per operand over (D, heads, S, B) with the
//   caller's strides. A box is 32 f32 (128 bytes, the 128-byte swizzle's
//   span) by 64 NC rows (Q) or 32 rows (K, V), so a row of D = 128 is 4
//   boxes side by side; D = 80 and 112 take 3 and 4, zero-filled past D
//   and never multiplied. Q is loaded once. K lands in its stage of a
//   2-stage ring (1 stage at D = 256) once the consumers are done with
//   it, V in a raw ring of as many slots once the converters are.
// * Q: each consumer thread reads its A-fragment elements of Q once, keeps
//   hi in registers (D / 2 of them) and writes lo back in place, so Q K^T
//   is hi.K_hi and hi.K_lo with A from registers and Q_lo.K_hi with A from
//   shared memory. At D = 256 the 128 registers of hi would not fit beside
//   the 128 of the output: there Q stays raw and each k8 step splits its
//   fragment anew (a slower path, for correctness).
// * Conversion, the step TMA cannot do: the converter warps round K's hi
//   in place and write K_lo beside it (the TMA's swizzled layout,
//   elementwise). V arrives (keys, D) with D contiguous, an MN-major B
//   operand for P V, and wgmma takes 32-bit operands K-major only, so the
//   converters write V^T_hi and V^T_lo as (D, keys) in the 128-byte
//   swizzle, each thread 8 keys by 4 head-dim values (8 float4 reads, 16
//   float4 writes). Then fence.proxy.async and an mbarrier tell the
//   consumers.
// * P V with P from registers: the k8 A fragment of a TF32 wgmma holds
//   (row, c) and (row, c + 4) for c = lane % 4, while the Q K^T
//   accumulator holds keys 2c and 2c + 1. The key order inside each group
//   of 8 is permuted instead of the registers: logical k index j is key
//   2 (j % 4) + j / 4, and the converters write V^T's columns in that
//   order, so p_hi and p_lo are the accumulator's own registers, split
//   in place (no shuffle).
// * Skipped tiles and masks: attention_hopper.cu's rule; a tile of 32
//   keys that every row of a warpgroup sees in full skips the mask.
//   kernels/flash_attention.py::kv_tile_starts is the same range in
//   Python, held to the mask by a CPU test.
//
// The shared memory at D = 128: Q 64 KB, per stage K, K_lo, V^T_hi and
// V^T_lo 16 KB each and a raw V slot of 16 KB: 224 KB of the 227 KB a
// block may have (D = 256: Q 64 KB, one stage of 128 KB, one raw V slot of
// 32 KB).
//
// The tensor-map encoder (cuTensorMapEncodeTiled) is looked up in the
// already loaded libcuda.so.1 with dlsym, so the library links no -lcuda.
// The exported function launches on the caller's stream and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take or tensor maps the driver refuses.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;          // keys of a K/V tile
constexpr int kRowBytes = 128;   // one swizzled row: 32 f32
constexpr int kConverters = 96;  // warps 1-3 of the producer warpgroup
constexpr float kNegInf = -1e30f;  // the TPU kernel's masked score
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  float* o;
  int64_t o_sb, o_ss, o_sh;
  int H, n_rep, Sq, Sk;
  int causal, window, prefix, kv_len, skip;
  float scale;
};

template <int D, int NC, int STAGES>
struct Tile {
  static constexpr int kRows = 64 * NC;           // query rows of a CTA
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr bool kQReg = NC == 2;          // Q_hi in registers
  static constexpr int kChunks = (D + 31) / 32;   // 32-wide boxes of a row
  static constexpr int kSteps = D / 8;            // k8 steps of Q K^T
  static constexpr int kOChunks = (D + 63) / 64;  // n64 blocks of O
  static constexpr int kRest = D - 64 * (kOChunks - 1);  // the last one's N
  static constexpr int kQBytes = kChunks * kRows * kRowBytes;
  static constexpr int kKBytes = kChunks * kBK * kRowBytes;  // a K or V tile
  static constexpr int kVTBytes = D * kRowBytes;  // V^T_hi or V^T_lo
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kVTBytes;
  static constexpr int kBarBytes = 128;
  // + 1024: the base is rounded up to the swizzle atom
  static constexpr int kSmem =
      kQBytes + STAGES * (kStageBytes + kKBytes) + kBarBytes + 1024;
  static_assert(D % 8 == 0 && 8 * (1 + 5 * STAGES) <= kBarBytes, "tile");
  static_assert(kSmem <= 232448, "shared memory");
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

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float lds(uint32_t a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(a) : "memory");
  return x;
}

__device__ __forceinline__ void sts(uint32_t a, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(x) : "memory");
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, float x, float y, float z,
                                     float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(x),
               "f"(y), "f"(z), "f"(w)
               : "memory");
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
// from zero; the low 13 bits of the result are 0
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo, both TF32, lo = rna(x - hi) (x - hi is exact in f32)
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, hi));
}

// byte offset of 16-byte unit `unit` of row `row` in a block of 128-byte
// rows with the 128-byte swizzle (the block 1024-byte aligned)
__device__ __forceinline__ uint32_t sw128(int row, int unit) {
  return row * kRowBytes + ((unit ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major operand:
// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint32_t lbo = 16, sbo = 1024;  // 8 rows of 128 bytes
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
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

// S[64 x 32] (+)= A[64 x 8] B[8 x 32], TF32, A and B K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] (+)= A[64 x 8] B[8 x N], TF32, A from registers (the m64k8
// fragment: rows r and r + 8, columns lane % 4 and + 4), B K-major in
// shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d,
                                             const uint32_t* a, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d,
                                             const uint32_t* a, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}"
      ", {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d,
                                             const uint32_t* a, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d,
                                             const uint32_t* a, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
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
// each of the thread's two rows' max: register 4 g + e holds (row, key k0 +
// 8 g + col + e), 4 g + 2 + e the same key of row + 8
template <bool kMask>
__device__ __forceinline__ void scale_scores(float (&sc)[kBK / 2],
                                             const Params& p,
                                             int k0, int col, int qpos0,
                                             int qpos1, float& mx0,
                                             float& mx1) {
#pragma unroll
  for (int g = 0; g < kBK / 8; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& x0 = sc[4 * g + e];
      float& x1 = sc[4 * g + 2 + e];
      if (kMask) {
        const int kpos = k0 + 8 * g + col + e;
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

template <int D, int NC, int STAGES>
__global__ void __launch_bounds__(Tile<D, NC, STAGES>::kThreads, 1)
    flash_hopper_f32_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params p) {
  using T = Tile<D, NC, STAGES>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // [chunk][rows][128 B]: Q, then per stage K (hi in place), K_lo,
  // V^T_hi, V^T_lo, then a raw V slot per stage, then the barriers
  const uint32_t sq = base;
  const uint32_t stages = sq + T::kQBytes;
  const uint32_t vraw = stages + STAGES * T::kStageBytes;
  const uint32_t bars = vraw + STAGES * T::kKBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;               // + 8 s, TMA: K landed
  const uint32_t v_full = k_full + 8 * STAGES;    // + 8 s, TMA: V landed
  const uint32_t v_free = v_full + 8 * STAGES;    // + 8 s, raw V read
  const uint32_t conv = v_free + 8 * STAGES;      // + 8 s, stage converted
  const uint32_t empty = conv + 8 * STAGES;       // + 8 s, stage consumed
  auto k_hi = [&](int s) { return stages + s * T::kStageBytes; };
  auto k_lo = [&](int s) { return k_hi(s) + T::kKBytes; };
  auto vt_hi = [&](int s) { return k_hi(s) + 2 * T::kKBytes; };
  auto vt_lo = [&](int s) { return vt_hi(s) + T::kVTBytes; };
  auto v_raw = [&](int s) { return vraw + s * T::kKBytes; };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int kvh = h / p.n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;

  // the kv range this block visits (kernels/flash_attention.py
  // kv_tile_starts)
  int k_begin = 0, k_end = p.Sk;
  if (p.skip) {
    const int q_last = min(q0 + T::kRows, p.Sq) - 1;
    if (p.causal) k_end = min(k_end, q_last + 1);
    k_end = min(k_end, p.kv_len);
    if (p.window > 0 && p.prefix == 0) k_begin = max(0, q0 - p.window + 1);
  }
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_free + 8 * s, kConverters);
      mbar_init(conv + 8 * s, kConverters);
      mbar_init(empty + 8 * s, 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {
    // ---- producer warpgroup: TMA (warp 0) and conversion (warps 1-3) ----
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    }
    const int ptid = threadIdx.x - 128 * NC;
    if (ptid == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(sq + c * T::kRows * kRowBytes, &tq, q_full, 32 * c, h, q0,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t parity = ((t / STAGES) & 1) ^ 1;  // round 0 passes
        const int k0 = k_begin + t * kBK;
        mbar_wait(v_free + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, T::kKBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(v_raw(s) + c * kBK * kRowBytes, &tv, v_full + 8 * s,
                   32 * c, kvh, k0, b);
        mbar_wait(empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, T::kKBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(k_hi(s) + c * kBK * kRowBytes, &tk, k_full + 8 * s, 32 * c,
                   kvh, k0, b);
      }
    } else if (ptid >= 32) {
      const int ci = ptid - 32;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t parity = (t / STAGES) & 1;
        // K: hi rounded in place, lo beside it, elementwise (the layout of
        // both is the TMA's)
        mbar_wait(k_full + 8 * s, parity);
        const uint32_t kh = k_hi(s), kl = k_lo(s);
        for (int i = ci; i < T::kKBytes / 16; i += kConverters) {
          const float4 x = lds4(kh + 16 * i);
          float h0, h1, h2, h3, l0, l1, l2, l3;
          split(x.x, h0, l0);
          split(x.y, h1, l1);
          split(x.z, h2, l2);
          split(x.w, h3, l3);
          sts4(kh + 16 * i, h0, h1, h2, h3);
          sts4(kl + 16 * i, l0, l1, l2, l3);
        }
        // V (keys, D) -> V^T_hi, V^T_lo (D, keys): a unit is 8 keys (one
        // k8 step) by 4 head-dim values; neighbouring threads take
        // neighbouring head-dim quads, so the 8 reads of a quarter warp
        // hit 8 distinct 16-byte units. Key m of a group of 8 goes to
        // column 4 (m % 2) + m / 2: the even keys fill the group's first
        // 16-byte unit, the odd ones its second.
        mbar_wait(v_full + 8 * s, parity);
        const uint32_t vr = v_raw(s), vh = vt_hi(s), vl = vt_lo(s);
        for (int u = ci; u < (kBK / 8) * (D / 4); u += kConverters) {
          const int g = u / (D / 4), dq = u - g * (D / 4);
          const uint32_t src = vr + (dq / 8) * kBK * kRowBytes;
          float4 x[8];
#pragma unroll
          for (int m = 0; m < 8; ++m)
            x[m] = lds4(src + sw128(8 * g + m, dq % 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * dq + e;
#pragma unroll
            for (int odd = 0; odd < 2; ++odd) {
              float hi[4], lo[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float4& y = x[2 * j + odd];
                split(e == 0 ? y.x : e == 1 ? y.y : e == 2 ? y.z : y.w,
                      hi[j], lo[j]);
              }
              const uint32_t at = sw128(d, 2 * g + odd);
              sts4(vh + at, hi[0], hi[1], hi[2], hi[3]);
              sts4(vl + at, lo[0], lo[1], lo[2], lo[3]);
            }
          }
        }
        mbar_arrive(v_free + 8 * s);
        fence_proxy_async();
        mbar_arrive(conv + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    }
    const int tid = threadIdx.x;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // this thread's rows of the accumulators: row and row + 8; its
    // columns of each 8-wide group: 2 (lane % 4) and + 1; its A-fragment
    // columns of a k8 step: lane % 4 and + 4
    const int row = wg * 64 + warp * 16 + lane / 4;
    const int qpos0 = q0 + row, qpos1 = qpos0 + 8;
    const int col = 2 * (lane % 4), fc = lane % 4;
    const uint32_t sq_wg = sq + wg * 64 * kRowBytes;
    // element (row + 8 (i % 2), 8 ks + fc + 4 (i / 2)) of Q: A register i
    auto q_elem = [&](int ks, int i) {
      const int r = row + 8 * (i & 1), kc = 8 * ks + fc + 4 * (i >> 1);
      return sq + (kc / 32) * T::kRows * kRowBytes +
             sw128(r, (kc % 32) / 4) + 4 * (kc % 4);
    };

    float o[T::kOChunks][32];
#pragma unroll
    for (int c = 0; c < T::kOChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(q_full, 0);
    uint32_t qh[T::kQReg ? T::kSteps : 1][4];
    if constexpr (T::kQReg) {
      // Q_hi into registers, Q_lo over the raw Q in shared memory
#pragma unroll
      for (int ks = 0; ks < T::kSteps; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t a = q_elem(ks, i);
          float hi, lo;
          split(lds(a), hi, lo);
          qh[ks][i] = __float_as_uint(hi);
          sts(a, lo);
        }
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = k_begin + t * kBK;

      // S = Q K^T over the head dim's k8 steps: Q_hi K_hi + Q_hi K_lo +
      // Q_lo K_hi
      float sc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) fence_reg(sc[i]);
      mbar_wait(conv + 8 * s, parity);
      const uint32_t kh = k_hi(s), kl = k_lo(s);
      if constexpr (T::kQReg) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < T::kSteps; ++ks) {
          const uint32_t off = (ks / 4) * kBK * kRowBytes + (ks % 4) * 32;
          const uint64_t dkh = desc_sw128(kh + off), dkl = desc_sw128(kl + off);
          const uint64_t dq = desc_sw128(
              sq_wg + (ks / 4) * T::kRows * kRowBytes + (ks % 4) * 32);
          wgmma_rs<32>(sc, qh[ks], dkh, ks > 0);
          wgmma_rs<32>(sc, qh[ks], dkl, 1);
          wgmma_ss_n32(sc, dq, dkh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
      } else {
#pragma unroll 1
        for (int ks = 0; ks < T::kSteps; ++ks) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float hi, lo;
            split(lds(q_elem(ks, i)), hi, lo);
            ah[i] = __float_as_uint(hi);
            al[i] = __float_as_uint(lo);
          }
          const uint32_t off = (ks / 4) * kBK * kRowBytes + (ks % 4) * 32;
          const uint64_t dkh = desc_sw128(kh + off), dkl = desc_sw128(kl + off);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fence_reg(ah[i]);
            fence_reg(al[i]);
          }
          wgmma_fence();
          wgmma_rs<32>(sc, ah, dkh, ks > 0);
          wgmma_rs<32>(sc, ah, dkl, 1);
          wgmma_rs<32>(sc, al, dkh, 1);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fence_reg(ah[i]);
            fence_reg(al[i]);
          }
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i) fence_reg(sc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) fence_reg(sc[i]);

      // scale and mask (a tile that all 64 rows of this warpgroup see in
      // full takes no mask), then the online softmax
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const int qw0 = q0 + wg * 64;
      const bool full = k0 + kBK <= min(p.kv_len, p.Sk) &&
                        (!p.causal || k0 + kBK - 1 <= qw0) &&
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
      for (int g = 0; g < kBK / 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x0 = sc[4 * g + e];
          float& x1 = sc[4 * g + 2 + e];
          x0 = exp2_approx(__fmul_rn(__fsub_rn(x0, mn0), kLog2e));
          x1 = exp2_approx(__fmul_rn(__fsub_rn(x1, mn1), kLog2e));
          sum0[e] = __fadd_rn(sum0[e], x0);
          sum1[e] = __fadd_rn(sum1[e], x1);
        }
      l0 = __fadd_rn(__fmul_rn(l0, alpha0), __fadd_rn(sum0[0], sum0[1]));
      l1 = __fadd_rn(__fmul_rn(l1, alpha1), __fadd_rn(sum1[0], sum1[1]));
#pragma unroll
      for (int c = 0; c < T::kOChunks; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          o[c][4 * g] = __fmul_rn(o[c][4 * g], alpha0);
          o[c][4 * g + 1] = __fmul_rn(o[c][4 * g + 1], alpha0);
          o[c][4 * g + 2] = __fmul_rn(o[c][4 * g + 2], alpha1);
          o[c][4 * g + 3] = __fmul_rn(o[c][4 * g + 3], alpha1);
        }

      // p = p_hi + p_lo in TF32, as the A fragments of the k8 steps over
      // the tile's keys: register i of step kk is (row + 8 (i % 2),
      // logical k fc + 4 (i / 2)), i.e. key 8 kk + col + i / 2, the
      // accumulator's register 4 kk + 2 (i % 2) + i / 2
      uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float hi, lo;
          split(sc[4 * kk + 2 * (i & 1) + (i >> 1)], hi, lo);
          ph[kk][i] = __float_as_uint(hi);
          pl[kk][i] = __float_as_uint(lo);
        }

      // O += p_hi V_hi + p_lo V_hi + p_hi V_lo, per 64-wide block of the
      // head dim
#pragma unroll
      for (int c = 0; c < T::kOChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(o[c][i]);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fence_reg(ph[kk][i]);
          fence_reg(pl[kk][i]);
        }
      const uint32_t vh = vt_hi(s), vl = vt_lo(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int c = 0; c < T::kOChunks; ++c) {
          const uint32_t off = 64 * c * kRowBytes + kk * 32;
          const uint64_t dvh = desc_sw128(vh + off), dvl = desc_sw128(vl + off);
          if (c < T::kOChunks - 1 || T::kRest == 64) {
            wgmma_rs<64>(o[c], ph[kk], dvh, 1);
            wgmma_rs<64>(o[c], pl[kk], dvh, 1);
            wgmma_rs<64>(o[c], ph[kk], dvl, 1);
          } else {
            wgmma_rs<T::kRest>(o[c], ph[kk], dvh, 1);
            wgmma_rs<T::kRest>(o[c], pl[kk], dvh, 1);
            wgmma_rs<T::kRest>(o[c], ph[kk], dvl, 1);
          }
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < T::kOChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(o[c][i]);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fence_reg(ph[kk][i]);
          fence_reg(pl[kk][i]);
        }
      mbar_arrive(empty + 8 * s);
    }

    // the row sums over the quad, then out = acc / max(l, 1e-30)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < T::kOChunks; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int d = 64 * c + 8 * g + col;
        if (d >= D) continue;
        if (qpos0 < p.Sq)
          *reinterpret_cast<float2*>(ob + qpos0 * p.o_ss + d) = make_float2(
              __fdiv_rn(o[c][4 * g], d0), __fdiv_rn(o[c][4 * g + 1], d0));
        if (qpos1 < p.Sq)
          *reinterpret_cast<float2*>(ob + qpos1 * p.o_ss + d) = make_float2(
              __fdiv_rn(o[c][4 * g + 2], d1), __fdiv_rn(o[c][4 * g + 3], d1));
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

// a (D, heads, S, B) f32 tensor map with boxes of 32 x 1 x rows x 1,
// 128-byte swizzle, zero fill out of bounds; strides in elements
bool encode(CUtensorMap* map, const void* ptr, int D, int heads, int S,
            int B, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(ss) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Operand {
  const void* ptr;
  int64_t sb, ss, sh;
};

template <int D, int NC, int STAGES>
int launch(const Operand& q, const Operand& k, const Operand& v,
           const Params& p, int B, int KV, cudaStream_t stream) {
  using T = Tile<D, NC, STAGES>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q.ptr, D, p.H, p.Sq, B, q.sb, q.ss, q.sh, T::kRows) ||
      !encode(&tk, k.ptr, D, KV, p.Sk, B, k.sb, k.ss, k.sh, kBK) ||
      !encode(&tv, v.ptr, D, KV, p.Sk, B, v.sb, v.ss, v.sh, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (p.Sq + T::kRows - 1) / T::kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_hopper_f32_kernel<D, NC, STAGES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B * p.H, tiles), T::kThreads, T::kSmem, stream>>>(tq, tk, tv,
                                                                   p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 &&
         ss % 4 == 0 && sh % 4 == 0 && sb >= 0 && ss >= 0 && sh >= 0;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D): f32, strides in
// elements with a contiguous head dim. D one of 64, 80, 112, 128, 256.
extern "C" int repro_flash_attention_hopper_f32(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
    int window, int prefix, int kv_len, int skip, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      static_cast<int64_t>(B) * H > 0x7fffffffLL ||
      !aligned(q, q_sb, q_ss, q_sh) || !aligned(k, k_sb, k_ss, k_sh) ||
      !aligned(v, v_sb, v_ss, v_sh) || o_sh % 2 != 0 || o_ss % 2 != 0 ||
      o_sb % 2 != 0 || reinterpret_cast<uintptr_t>(o) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operand qo{q, q_sb, q_ss, q_sh}, ko{k, k_sb, k_ss, k_sh},
      vo{v, v_sb, v_ss, v_sh};
  const Params p{static_cast<float*>(o), o_sb, o_ss, o_sh, H, H / KV,
                 Sq, Sk, causal, window, prefix, kv_len, skip, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 2, 2>(qo, ko, vo, p, B, KV, s);
    case 80:
      return launch<80, 2, 2>(qo, ko, vo, p, B, KV, s);
    case 112:
      return launch<112, 2, 2>(qo, ko, vo, p, B, KV, s);
    case 128:
      return launch<128, 2, 2>(qo, ko, vo, p, B, KV, s);
    case 256:
      return launch<256, 1, 1>(qo, ko, vo, p, B, KV, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
