// Hand-written Hopper (sm_90a) kernel of robust aggregation
// (repro_torch.robust).
//
// It replaces the JAX package's Pallas TPU kernel:
//   repro_robust_reduce  <- src/repro/kernels/robust_reduce.py
//                           robust_reduce_3d
//
// The coordinate-wise trimmed mean over the learner axis of an (L, n)
// stack, 1 <= L <= 16, n coordinates per learner (the packed (L, rows, 128)
// plane, or any per-leaf (L, ...) leaf flattened): sort the L values of a
// coordinate, drop `trim` at each end, sum the rest in ascending order and
// divide once by L - 2 trim. trim = 0 sums in learner order with no sort
// (the plain mean, sum / L); trim = (L - 1) / 2 is the median. The result
// is f32.
//
// Bound: device-memory bytes. Each value of the stack is read once and each
// result written once, (L + 1) * 4 bytes a coordinate in f32, against
// about L^2 / 2 compare-exchanges: at L = 4 a few operations a byte, far
// below what the card computes per byte read.
//
// Design. One thread owns VEC consecutive coordinates (4, through one
// 16-byte load from each f32 learner plane, 8 bytes from a bf16 one; or 1
// where n is not a multiple of 4, or L > 8 where 4 columns of keys and
// values would crowd the registers) per step of a grid-stride loop. It
// loads the L values of each coordinate into registers, sorts them there
// with an odd-even transposition network (L rounds of neighbour compare-
// exchanges, fully unrolled: L is a template parameter, so nothing is
// indexed at run time and the values never leave registers), sums the kept
// ones and stores one f32. Neighbouring threads touch neighbouring
// coordinates of each plane, so every access is coalesced. One read of the
// stack, one write of the result, as the TPU kernel.
//
// Order. The sort is the stable sort of jnp.sort and of the plain version
// (torch.sort(stable=True) over the same keys): each value carries the
// int32 key of a total order in which -0.0 and +0.0 are equal, every NaN
// is larger than +inf, and the rest is the float order. Neighbour
// exchanges that swap only on a strictly smaller key keep equal keys in
// their learner order, which is what makes the network stable; so the
// values kept, and the order they are summed in, are the plain version's.
//
// Numerics: acc = acc + v_k over the kept values in ascending order
// (__fadd_rn), then one __fdiv_rn by (L - 2 trim); the library is built
// with --fmad=false. acc starts at +0.0, the init value of the reductions
// of XLA and ATen (a column of -0.0 sums to +0.0), or at -0.0, the exact
// identity, where one value is kept (XLA returns a one-element sum as the
// element). The plain PyTorch version does the same, so the two agree
// bitwise, signed zeros included.
//
// Indices are 64-bit: the (4, rows, 128) stack of Qwen3-1.7B holds 6.9e9
// values. The exported function launches on the caller's stream and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLearners = 16;
constexpr int kMaxVecLearners = 8;  // VEC = 4 only up to here
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kNanKey = 0x7fffffff;

int grid_for(int64_t work_items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t want = (work_items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (want > cap) want = cap;
  return static_cast<int>(want < 1 ? 1 : want);
}

// The sort key: -0.0 and +0.0 -> 0, every NaN -> INT_MAX, else the float
// bits with the magnitude bits of negatives flipped (so the int order is the
// float order).
__device__ __forceinline__ int sort_key(float v) {
  if (v != v) return kNanKey;
  if (v == 0.0f) return 0;
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, int64_t i, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, int64_t i,
                                     float* v) {
  if constexpr (VEC == 4) {
    const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(p[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, int64_t i, const float* v) {
  if constexpr (VEC == 4) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[i] = v[0];
  }
}

// Stable compare-exchange of neighbours i, i + 1: swap on a strictly
// smaller key only.
__device__ __forceinline__ void exchange(int& ka, float& va, int& kb,
                                         float& vb) {
  const bool swap = kb < ka;
  const int k_lo = swap ? kb : ka;
  const int k_hi = swap ? ka : kb;
  const float v_lo = swap ? vb : va;
  const float v_hi = swap ? va : vb;
  ka = k_lo;
  kb = k_hi;
  va = v_lo;
  vb = v_hi;
}

// groups: VEC-value groups per learner plane (n / VEC); n: coordinates per
// learner plane.
template <int L, int VEC, typename T>
__global__ void __launch_bounds__(kThreads)
    robust_reduce_kernel(const T* x, float* out, int64_t groups, int trim) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const float kept = static_cast<float>(L - 2 * trim);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < groups; i += stride) {
    float v[VEC][L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      float col[VEC];
      load<VEC>(x, k * groups + i, col);
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[c][k] = col[c];
    }
    float res[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float acc = (L - 2 * trim == 1) ? -0.0f : 0.0f;
      if (trim == 0) {
#pragma unroll
        for (int k = 0; k < L; ++k) acc = __fadd_rn(acc, v[c][k]);
      } else {
        int key[L];
#pragma unroll
        for (int k = 0; k < L; ++k) key[k] = sort_key(v[c][k]);
#pragma unroll
        for (int r = 0; r < L; ++r) {
#pragma unroll
          for (int k = r & 1; k + 1 < L; k += 2) {
            exchange(key[k], v[c][k], key[k + 1], v[c][k + 1]);
          }
        }
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (k >= trim && k < L - trim) acc = __fadd_rn(acc, v[c][k]);
        }
      }
      res[c] = __fdiv_rn(acc, kept);
    }
    store<VEC>(out, i, res);
  }
}

template <int L, typename T>
int launch(const T* x, float* out, int64_t n, int trim, bool vec4,
           cudaStream_t stream) {
  if constexpr (L <= kMaxVecLearners) {
    if (vec4) {
      const int64_t groups = n / 4;
      robust_reduce_kernel<L, 4, T>
          <<<grid_for(groups), kThreads, 0, stream>>>(x, out, groups, trim);
      return static_cast<int>(cudaGetLastError());
    }
  }
  robust_reduce_kernel<L, 1, T>
      <<<grid_for(n), kThreads, 0, stream>>>(x, out, n, trim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* x, float* out, int num_learners, int64_t n, int trim,
             bool vec4, cudaStream_t stream) {
  switch (num_learners) {
#define REPRO_REDUCE_CASE(l) \
  case l:                    \
    return launch<l, T>(x, out, n, trim, vec4, stream);
    REPRO_REDUCE_CASE(1)
    REPRO_REDUCE_CASE(2)
    REPRO_REDUCE_CASE(3)
    REPRO_REDUCE_CASE(4)
    REPRO_REDUCE_CASE(5)
    REPRO_REDUCE_CASE(6)
    REPRO_REDUCE_CASE(7)
    REPRO_REDUCE_CASE(8)
    REPRO_REDUCE_CASE(9)
    REPRO_REDUCE_CASE(10)
    REPRO_REDUCE_CASE(11)
    REPRO_REDUCE_CASE(12)
    REPRO_REDUCE_CASE(13)
    REPRO_REDUCE_CASE(14)
    REPRO_REDUCE_CASE(15)
    REPRO_REDUCE_CASE(16)
#undef REPRO_REDUCE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x: (L, n) f32 (x_bf16 == 0) or bf16 (x_bf16 == 1), contiguous; out: (n,)
// f32. vec4 != 0 allows 4 coordinates a thread: then n % 4 == 0, x is
// 16-byte aligned (8 for bf16) and out 16-byte aligned.
int repro_robust_reduce(const void* x, float* out, int num_learners,
                        int64_t n, int trim, int x_bf16, int vec4,
                        void* stream) {
  if (num_learners < 1 || num_learners > kMaxLearners || n < 1 ||
      trim < 0 || 2 * trim >= num_learners || (vec4 && n % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return dispatch(static_cast<const __nv_bfloat16*>(x), out, num_learners,
                    n, trim, vec4 != 0, s);
  }
  return dispatch(static_cast<const float*>(x), out, num_learners, n, trim,
                  vec4 != 0, s);
}

}  // extern "C"
