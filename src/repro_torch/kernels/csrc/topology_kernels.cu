// Hand-written Hopper (sm_90a) kernel of the gossip topology
// (repro_torch.topology.gossip).
//
// It replaces the JAX package's Pallas TPU kernels:
//   repro_neighbor_mix  <- src/repro/kernels/neighbor_mix.py  neighbor_mix_3d
//                          and neighbor_mix_3d_stepped (the wrapper selects
//                          the step's matrix on the host, then launches this)
//
// out_j = sum_k W_jk x_k over an (L, rows, 128) learner stack, 1 <= L <= 16,
// with an f32 (L, L) matrix W, for the output window j = j0 .. j0 + L_out - 1
// (the square call is the window (0, L)): out is (L_out, rows, 128), its
// entry jj the output row j0 + jj. One rank of a mesh that holds learners
// j0 .. j0 + L_out - 1 of the gossip stacks mixes only those, from the
// stack gathered over the learner axes (repro_torch.sharding.placed). The
// window's rows of W travel by value in the kernel's parameter space (1 KB
// at L = 16): the host selects and masks W each meta step, and nothing is
// copied to the device or read back for it.
//
// Bound: device-memory bytes. Every value of the stack is read once and
// every value of the window written once (4 (L + L_out) bytes per
// coordinate in f32, 2 (L + L_out) in bf16) against 2 L L_out flops: at
// L = 4 that is at most one flop per byte, far below the card's float32
// balance of 20 flops per byte.
//
// Design. One thread owns 4 consecutive coordinates (one 16-byte group of
// each f32 learner plane, 8 bytes of a bf16 one) per step of a grid-stride
// loop. It loads the L groups into registers, forms the L outputs, and
// stores them. Neighbouring threads touch neighbouring groups of each
// plane, so every load and store is coalesced. L is a template parameter,
// so the loops over learners unroll and the inputs stay in registers; the
// loop over the window's outputs unrolls to L and skips jj >= L_out.
//
// Numerics: acc = 0; for k = 0..L-1: acc = acc + W_jk * x_k, one rounded
// multiply (__fmul_rn) and one rounded add (__fadd_rn) per term, in that
// order, zero weights included (a NaN or Inf anywhere in the column spreads
// as in a dense product). The plain PyTorch version does the same, so the
// two agree bitwise, and a window is bitwise the matching rows of the
// square call. bf16 stacks are widened to f32, mixed in f32 and rounded
// back to nearest even.
//
// In place: out may be x (or, for a window, its rows j0 .. j0 + L_out - 1).
// A thread reads all L values of its coordinates before it writes any, and
// no coordinate belongs to two threads.
//
// Indices are 64-bit: the (4, rows, 128) stack of Qwen3-1.7B holds 6.9e9
// values. The exported function launches on the caller's stream and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// geometry the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLearners = 16;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct MixMatrix {
  // row-major (L_out, L): the window's rows of W, L_out * L used
  float w[kMaxLearners * kMaxLearners];
};

int grid_for(int64_t work_items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t want = (work_items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (want > cap) want = cap;
  return static_cast<int>(want < 1 ? 1 : want);
}

__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t i) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, int64_t i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i,
                                       float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = raw;
}

__device__ __forceinline__ void accumulate(float4& acc, float w, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
}

// groups: 4-value groups per learner plane (rows * 32)
template <int L, typename T>
__global__ void __launch_bounds__(kThreads)
    neighbor_mix_kernel(const T* x, T* out, const MixMatrix m, int l_out,
                        int64_t groups) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < groups; i += stride) {
    float4 v[L];
#pragma unroll
    for (int k = 0; k < L; ++k) v[k] = load4(x, k * groups + i);
#pragma unroll
    for (int jj = 0; jj < L; ++jj) {
      if (jj < l_out) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int k = 0; k < L; ++k) accumulate(acc, m.w[jj * L + k], v[k]);
        store4(out, jj * groups + i, acc);
      }
    }
  }
}

template <typename T>
int launch_mix(const T* x, T* out, const MixMatrix& m, int num_learners,
               int l_out, int64_t groups, cudaStream_t stream) {
  const int blocks = grid_for(groups);
  switch (num_learners) {
#define REPRO_MIX_CASE(n)                                                 \
  case n:                                                                 \
    neighbor_mix_kernel<n, T><<<blocks, kThreads, 0, stream>>>(x, out, m,   \
                                                              l_out,      \
                                                              groups);    \
    break;
    REPRO_MIX_CASE(1)
    REPRO_MIX_CASE(2)
    REPRO_MIX_CASE(3)
    REPRO_MIX_CASE(4)
    REPRO_MIX_CASE(5)
    REPRO_MIX_CASE(6)
    REPRO_MIX_CASE(7)
    REPRO_MIX_CASE(8)
    REPRO_MIX_CASE(9)
    REPRO_MIX_CASE(10)
    REPRO_MIX_CASE(11)
    REPRO_MIX_CASE(12)
    REPRO_MIX_CASE(13)
    REPRO_MIX_CASE(14)
    REPRO_MIX_CASE(15)
    REPRO_MIX_CASE(16)
#undef REPRO_MIX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (L, rows, 128) f32 (x_bf16 == 0) or bf16 (x_bf16 == 1); out: the
// (l_out, rows, 128) window j0 .. j0 + l_out - 1 of the outputs, in x's
// dtype (it may be x, or x's rows j0 ..); w: a HOST pointer to the
// row-major (L, L) f32 matrix, read here before the launch returns.
int repro_neighbor_mix(const void* x, void* out, const float* w,
                       int num_learners, int64_t rows, int x_bf16, int j0,
                       int l_out, void* stream) {
  if (num_learners < 1 || num_learners > kMaxLearners || rows < 1 ||
      rows % 8 != 0 || w == nullptr || j0 < 0 || l_out < 1 ||
      j0 + l_out > num_learners) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MixMatrix m = {};
  for (int jj = 0; jj < l_out; ++jj) {
    for (int k = 0; k < num_learners; ++k) {
      m.w[jj * num_learners + k] = w[(j0 + jj) * num_learners + k];
    }
  }
  const int64_t groups = rows * 32;  // 128 values = 32 groups of 4 a row
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_mix(static_cast<const __nv_bfloat16*>(x),
                      static_cast<__nv_bfloat16*>(out), m, num_learners,
                      l_out, groups, s);
  }
  return launch_mix(static_cast<const float*>(x), static_cast<float*>(out),
                    m, num_learners, l_out, groups, s);
}

}  // extern "C"
