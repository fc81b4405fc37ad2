// Hand-written Hopper (sm_90a) kernel of float32 attention (repro_torch
// serving).
//
// It replaces the JAX package's Pallas TPU kernel:
//   repro_flash_attention  <- src/repro/kernels/flash_attention.py
//                             flash_attention_bhsd
// for float32 operands; bfloat16 operands take the tensor-core kernel of
// attention_hopper.cu.
//
// Blocked online-softmax attention, forward only, on (B, Sq, H, D) queries
// and (B, Sk, KV, D) keys and values, H = KV * n_rep: query head h of batch
// row b reads kv head h / n_rep, so the row bh = b H + h of the TPU kernel's
// (B H, S, D) layout reads kv row bh / n_rep, and K and V are never repeated.
// Each operand comes with its own (batch, sequence, head) strides in
// elements and a contiguous head dim, so the kernel reads the model's
// (B, S, H, D) projections as they are and the (B H, S, D) layout of the
// plain version through a view. f32 in, f32 out.
//
// The function is the TPU kernel's: s = (q . k) * scale in f32; a masked
// score is the finite -1e30 (kpos < kv_len; causal qpos >= kpos; window
// qpos - kpos < window, OR-ed with kpos < prefix when a prefix is set; qpos
// and kpos absolute, from 0); the running max starts at -1e30, so a tile
// that hides every key of a row adds exp(0) = 1 junk that the first visible
// tile wipes out (alpha = exp(-1e30 - m) = 0), and a row that no key can see
// ends as the mean of all Sk rows of V; p stays f32 for the PV product; the
// result is acc / max(l, 1e-30), cast once. Keys past Sk (the ragged last
// tile) score -inf and add exactly nothing.
//
// Bound: arithmetic. 4 Sq Sk D flops per (b, h) against (Sq + 2 Sk) D
// elements read and Sq D written: hundreds of flops a byte at the prefill
// shapes, on the f32 CUDA cores (the tensor cores have no f32 product that
// keeps f32's precision; in f32 this kernel beats PyTorch's SDPA). One
// block of 128 threads per (bh, tile of BQ queries), the query tile and
// each K and V tile of BK keys staged in shared memory, the threads as 8
// row groups x 16 column groups. A thread holds RQ query rows: for them it
// computes BK / 16 scores of each kv tile (columns cg + 16 j) and owns
// D / 16 output columns (cg + 16 j), with
// explicit f32 FMAs (the library is built with --fmad=false, which keeps
// the compiler from contracting, not __fmaf_rn from fusing). The row max
// and sum are reduced over the 16 threads of a row group by an xor
// butterfly, which gives every one of them the same bits. P goes through
// shared memory to the PV product. Shared-memory rows of Q and K are
// padded by 4 floats, so the 16-byte loads of a quarter warp hit distinct
// banks.
//
// Work that cannot change the result is skipped: when every query row sees
// at least one key (the wrapper decides: kv_len >= 1, and with a window
// and no prefix, Sq - 1 < kv_len - 1 + window), a kv tile masked for every
// row of the block adds exactly 0 (p = exp(-1e30 - m) = 0, alpha = 1) or is
// wiped later (alpha = 0), so a block visits only keys below its last row
// (causal), below kv_len, and from its first row's window start on (no
// prefix). Blocks of the last query tiles, the heaviest under a causal
// mask, are scheduled first.
//
// Offsets are 64-bit. The exported function launches on the caller's stream
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments the kernel does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 8 row groups x 16 column groups
constexpr int kRowGroups = 8;
constexpr int kColGroups = 16;
constexpr float kNegInf = -1e30f;  // the TPU kernel's masked score

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int H, n_rep, Sq, Sk;
  int causal, window, prefix, kv_len, skip;
  float scale;
};


// rows x D elements of one head, from row `r0` on, into shared memory with
// row stride `ld`; zeros past row `rows_valid`
template <int D>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int64_t row_stride, int r0, int rows,
                                      int rows_valid) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int row = r0 + r;
    dst[r * ld + c] =
        row < rows_valid ? src[static_cast<int64_t>(row) * row_stride + c]
                         : 0.0f;
  }
}

template <int D, int RQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  constexpr int BQ = kRowGroups * RQ;
  constexpr int NK = BK / kColGroups;  // scores of a kv tile per thread row
  constexpr int ND = D / kColGroups;   // output columns per thread row
  constexpr int LQ = D + 4;            // row stride of sq and sk
  constexpr int LP = BK + 4;           // row stride of sp
  static_assert(D % kColGroups == 0 && D % 4 == 0, "head dim");
  static_assert(BK % kColGroups == 0 && BK % 4 == 0, "kv tile");

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * LQ;
  float* sv = sk + BK * LQ;
  float* sp = sv + BK * D;

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int kvh = h / p.n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage<D>(sq, LQ, qb, p.q_ss, q0, BQ, p.Sq);

  // the kv range this block visits
  int k_lo = 0, k_hi = p.Sk;
  if (p.skip) {
    const int q_last = min(q0 + BQ, p.Sq) - 1;
    if (p.causal) k_hi = min(k_hi, q_last + 1);
    k_hi = min(k_hi, p.kv_len);
    if (p.window > 0 && p.prefix == 0) k_lo = max(0, q0 - p.window + 1);
  }

  float m[RQ], l[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's PV product is done with sk/sv/sp
    stage<D>(sk, LQ, kb, p.k_ss, k0, BK, p.Sk);
    stage<D>(sv, D, vb, p.v_ss, k0, BK, p.Sk);
    __syncthreads();

    // s = q . k over the head dim, 4 lanes of it per step
    float s[RQ][NK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            sk + (cg + kColGroups * j) * LQ + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sq + (rg * RQ + i) * LQ + d);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          s[i][j] = __fmaf_rn(qv.x, kv[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(qv.y, kv[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(qv.z, kv[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // scale, mask, online softmax per row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + rg * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int kpos = k0 + cg + kColGroups * j;
        bool vis = kpos < p.kv_len;
        if (p.causal) vis = vis && qpos >= kpos;
        if (p.window > 0)
          vis = vis && (qpos - kpos < p.window || kpos < p.prefix);
        float x = vis ? __fmul_rn(s[i][j], p.scale) : kNegInf;
        if (kpos >= p.Sk) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float e = expf(s[i][j] - m_new);
        sp[(rg * RQ + i) * LP + cg + kColGroups * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    __syncthreads();

    // acc += p v over the tile's keys, 4 of them per step
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sp + (rg * RQ + i) * LP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = sv + (kk + t) * D + cg;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const float vv = vrow[kColGroups * j];
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float pp = t == 0 ? pv[i].x
                             : t == 1 ? pv[i].y
                             : t == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][j] = __fmaf_rn(pp, vv, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + rg * RQ + i;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + static_cast<int64_t>(qpos) * p.o_ss + cg;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      orow[kColGroups * j] = __fdiv_rn(acc[i][j], denom);
  }
}

template <int D, int RQ, int BK>
int launch(const Params& p, int BH, cudaStream_t stream) {
  constexpr int BQ = kRowGroups * RQ;
  constexpr size_t smem =
      sizeof(float) * (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 4));
  const int tiles = (p.Sq + BQ - 1) / BQ;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel<D, RQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int BH, int D, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, 8, 32>(p, BH, stream);
    case 80:
      return launch<80, 8, 32>(p, BH, stream);
    case 112:
      return launch<112, 8, 32>(p, BH, stream);
    case 128:
      return launch<128, 8, 32>(p, BH, stream);
    case 256:
      return launch<256, 4, 32>(p, BH, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
    int window, int prefix, int kv_len, int skip, float scale,
    void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      static_cast<int64_t>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,    k,    v,    o,    q_sb, q_ss,  q_sh,   k_sb,
           k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,  o_ss,   o_sh,
           H,    H / KV, Sq, Sk,   causal, window, prefix, kv_len,
           skip, scale};
  return dispatch(p, B * H, D, static_cast<cudaStream_t>(stream));
}
