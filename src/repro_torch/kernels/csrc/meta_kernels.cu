// Hand-written Hopper (sm_90a) kernels of the M-AVG meta phase.
//
// They replace the JAX package's Pallas TPU kernels:
//   repro_fused_momentum_broadcast  <- src/repro/kernels/fused_meta.py
//                                      fused_momentum_broadcast_2d
//   repro_block_momentum            <- src/repro/kernels/block_momentum.py
//                                      block_momentum_2d
//   repro_sgd_apply                 <- src/repro/kernels/local_sgd.py
//                                      sgd_apply_2d
//
// All three are elementwise passes over (rows, 128) planes with no reuse:
// they are bound by device-memory bytes (a few flops per 12+ bytes). The
// design therefore only streams: a grid-stride loop over the flat index,
// 16-byte loads and stores per thread, each input read once and each output
// written once. The Pallas kernels' (256, 128) VMEM blocking has no
// counterpart here; a block of threads holds nothing beyond registers.
//
// Numerics: every operation rounds where the plain PyTorch version rounds.
// The arithmetic is written with __fmul_rn / __fadd_rn / __fsub_rn, which
// the compiler never contracts into an FMA (and the library is built with
// --fmad=false besides), and bf16 stores round to nearest even through
// __float2bfloat16_rn. Outputs are therefore bitwise equal to the plain
// versions in the Python modules beside this file.
//
// Aliasing: outputs may alias inputs (w_out == w, v_out == v, out == w).
// Each thread loads all its inputs before it stores to the same elements,
// and no element is touched by two threads, so an in-place update is safe.
// That is how the meta step keeps the full-width model under 80 GB. No
// pointer is declared __restrict__ for that reason.
//
// Indices are 64-bit: one f32 plane of Qwen3-1.7B has 1.72e9 elements and
// the (L, rows, 128) learner plane 6.9e9.
//
// Each exported function launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

int grid_for(int64_t work_items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t want = (work_items + kThreads - 1) / kThreads;
  int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (want > cap) want = cap;
  return static_cast<int>(want < 1 ? 1 : want);
}

// v' = mu v + eta d;  w' = w + v'  (Nesterov: w' = w + mu v' + eta d),
// with d = a - w. Same operation order as the plain version.
template <bool kNesterov>
__device__ __forceinline__ void momentum(float w, float v, float a, float mu,
                                         float eta, float& w_new,
                                         float& v_new) {
  const float d = __fsub_rn(a, w);
  v_new = __fadd_rn(__fmul_rn(mu, v), __fmul_rn(eta, d));
  if (kNesterov) {
    w_new = __fadd_rn(__fadd_rn(w, __fmul_rn(mu, v_new)), __fmul_rn(eta, d));
  } else {
    w_new = __fadd_rn(w, v_new);
  }
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// One thread step covers 4 consecutive f32 elements (one float4). The
// learner broadcast writes the new w into each of the L planes of the
// (L, n) learner buffer; L == 0 is the plain block-momentum kernel.
template <bool kNesterov, typename LT>
__global__ void momentum_kernel(const float* w, const float* v, const float* a,
                                float* w_out, float* v_out, LT* learners,
                                int64_t n4, int64_t plane, int num_learners,
                                float mu, float eta) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < n4; q += stride) {
    const float4 wv = reinterpret_cast<const float4*>(w)[q];
    const float4 vv = reinterpret_cast<const float4*>(v)[q];
    const float4 av = reinterpret_cast<const float4*>(a)[q];
    float4 wn, vn;
    momentum<kNesterov>(wv.x, vv.x, av.x, mu, eta, wn.x, vn.x);
    momentum<kNesterov>(wv.y, vv.y, av.y, mu, eta, wn.y, vn.y);
    momentum<kNesterov>(wv.z, vv.z, av.z, mu, eta, wn.z, vn.z);
    momentum<kNesterov>(wv.w, vv.w, av.w, mu, eta, wn.w, vn.w);
    reinterpret_cast<float4*>(w_out)[q] = wn;
    reinterpret_cast<float4*>(v_out)[q] = vn;
    for (int j = 0; j < num_learners; ++j) {
      store4(learners + static_cast<int64_t>(j) * plane + 4 * q, wn);
    }
  }
}

template <typename LT>
int launch_momentum(const float* w, const float* v, const float* a,
                    float* w_out, float* v_out, LT* learners, int64_t n,
                    int num_learners, float mu, float eta, int nesterov,
                    cudaStream_t stream) {
  const int64_t n4 = n / 4;
  const int grid = grid_for(n4);
  if (nesterov) {
    momentum_kernel<true, LT><<<grid, kThreads, 0, stream>>>(
        w, v, a, w_out, v_out, learners, n4, n, num_learners, mu, eta);
  } else {
    momentum_kernel<false, LT><<<grid, kThreads, 0, stream>>>(
        w, v, a, w_out, v_out, learners, n4, n, num_learners, mu, eta);
  }
  return static_cast<int>(cudaGetLastError());
}

// (f32(w) - lr * f32(g)) rounded back to the storage type.
__global__ void sgd_kernel_f32(const float* w, const float* g, float* out,
                               int64_t n4, float lr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < n4; q += stride) {
    const float4 wv = reinterpret_cast<const float4*>(w)[q];
    const float4 gv = reinterpret_cast<const float4*>(g)[q];
    float4 o;
    o.x = __fsub_rn(wv.x, __fmul_rn(lr, gv.x));
    o.y = __fsub_rn(wv.y, __fmul_rn(lr, gv.y));
    o.z = __fsub_rn(wv.z, __fmul_rn(lr, gv.z));
    o.w = __fsub_rn(wv.w, __fmul_rn(lr, gv.w));
    reinterpret_cast<float4*>(out)[q] = o;
  }
}

// 8 bf16 elements (16 bytes) per thread step.
__global__ void sgd_kernel_bf16(const __nv_bfloat16* w, const __nv_bfloat16* g,
                                __nv_bfloat16* out, int64_t n8, float lr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < n8; q += stride) {
    const uint4 wr = reinterpret_cast<const uint4*>(w)[q];
    const uint4 gr = reinterpret_cast<const uint4*>(g)[q];
    const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&wr);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gr);
    uint4 res;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 wf = __bfloat1622float2(wp[k]);
      const float2 gf = __bfloat1622float2(gp[k]);
      op[k] = __floats2bfloat162_rn(__fsub_rn(wf.x, __fmul_rn(lr, gf.x)),
                                    __fsub_rn(wf.y, __fmul_rn(lr, gf.y)));
    }
    reinterpret_cast<uint4*>(out)[q] = res;
  }
}

}  // namespace

extern "C" {

// w, v, a, w_out, v_out: n f32 each; learners: num_learners * n elements of
// f32 (learner_bf16 == 0) or bf16 (learner_bf16 == 1). n % 4 == 0.
int repro_fused_momentum_broadcast(const void* w, const void* v, const void* a,
                                   void* w_out, void* v_out, void* learners,
                                   int64_t n, int num_learners,
                                   int learner_bf16, float mu, float eta,
                                   int nesterov, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* vf = static_cast<const float*>(v);
  const float* af = static_cast<const float*>(a);
  float* wo = static_cast<float*>(w_out);
  float* vo = static_cast<float*>(v_out);
  if (learner_bf16) {
    return launch_momentum(wf, vf, af, wo, vo,
                           static_cast<__nv_bfloat16*>(learners), n,
                           num_learners, mu, eta, nesterov, s);
  }
  return launch_momentum(wf, vf, af, wo, vo, static_cast<float*>(learners), n,
                         num_learners, mu, eta, nesterov, s);
}

// The same update without the learner broadcast. n % 4 == 0.
int repro_block_momentum(const void* w, const void* v, const void* a,
                         void* w_out, void* v_out, int64_t n, float mu,
                         float eta, int nesterov, void* stream) {
  return launch_momentum(static_cast<const float*>(w),
                         static_cast<const float*>(v),
                         static_cast<const float*>(a), static_cast<float*>(w_out),
                         static_cast<float*>(v_out),
                         static_cast<float*>(nullptr), n, 0, mu, eta, nesterov,
                         static_cast<cudaStream_t>(stream));
}

// w, g, out: n elements of f32 (bf16 == 0, n % 4 == 0) or bf16
// (bf16 == 1, n % 8 == 0).
int repro_sgd_apply(const void* w, const void* g, void* out, int64_t n,
                    int bf16, float lr, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int64_t n8 = n / 8;
    sgd_kernel_bf16<<<grid_for(n8), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(out), n8, lr);
  } else {
    const int64_t n4 = n / 4;
    sgd_kernel_f32<<<grid_for(n4), kThreads, 0, s>>>(
        static_cast<const float*>(w), static_cast<const float*>(g),
        static_cast<float*>(out), n4, lr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
