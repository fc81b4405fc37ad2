// Hand-written Hopper (sm_90a) kernels of the compressed meta average
// (repro_torch.comm).
//
// They replace the JAX package's Pallas TPU kernels:
//   repro_quantize     <- src/repro/kernels/quantize.py     quantize_2d
//   repro_dequantize   <- src/repro/kernels/quantize.py     dequantize_2d
//   repro_pack_update  <- src/repro/kernels/pack_update.py  pack_update_3d
//
// All three walk a (rows, 128) layout in chunks of `block` rows
// (8 <= block <= 64, block % 8 == 0, block divides rows). A chunk of
// block * 128 values shares one f32 scale s = max(max|x|, 1e-12) / qmax,
// and each value is rounded stochastically onto the grid:
// q = clip(floor(x / s + u), -qmax, qmax) with a caller-supplied dither
// u in [0, 1).
//
// Bound: device-memory bytes. quantize moves 9 bytes per value (x, u in;
// int8 q out), dequantize 5, pack_update with error feedback 20 per value
// of the (L, rows, 128) stack plus one read of the meta plane; each does a
// handful of flops per value.
//
// Design. The Pallas kernels walk one chunk per grid step in order; here
// chunks are independent and run in parallel. One chunk is owned by
// 4 * block threads (one warp when block == 8), and a block of threads
// holds 256 / (4 * block) chunks (one chunk when 4 * block does not divide
// 256). Each thread loads 8 float4 groups (32 values) of its chunk, and of
// the dither, into registers; the chunk's max |x| is reduced by warp
// shuffles and, across the chunk's warps, through shared memory; then the
// thread quantizes from registers and stores. Nothing crosses blocks, no
// value is read twice, and no intermediate goes to device memory.
//
// Numerics: every operation rounds where the plain PyTorch version
// rounds. Divisions use __fdiv_rn (never a multiplication by a
// reciprocal), products and sums the _rn intrinsics, and the library is
// built with --fmad=false, so d - q * s is never contracted. The max
// propagates NaN as torch.amax does (fmaxf would drop it), and the clip
// passes NaN through as torch.clamp does. An int8 q of a NaN value is 0.
//
// Aliasing: outputs may alias inputs of the same type and shape (c over u
// or over an f32 w, err over e). Each thread stores only the elements it
// loaded itself, after loading them, so an in-place update is safe; no
// pointer is __restrict__.
//
// Indices are 64-bit: the (2, rows, 128) stack of Qwen3-1.7B holds 3.4e9
// values. Each exported function launches on the caller's stream and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// a geometry the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kVecs = 8;  // float4 groups per thread: 32 values
constexpr int kMaxWarps = kBlockThreads / 32;
constexpr float kEps = 1e-12f;

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// torch.clamp / jnp.clip: a NaN passes through
__device__ __forceinline__ float clip(float q, float qmax) {
  return q < -qmax ? -qmax : (q > qmax ? qmax : q);
}

__device__ __forceinline__ float quant(float x, float s, float u,
                                       float qmax) {
  return clip(floorf(__fadd_rn(__fdiv_rn(x, s), u)), qmax);
}

__device__ __forceinline__ float abs_max4(float4 x) {
  return nan_max(nan_max(fabsf(x.x), fabsf(x.y)),
                 nan_max(fabsf(x.z), fabsf(x.w)));
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

// Where a thread's data lies: its chunk, and its place in the chunk.
struct Slot {
  int64_t chunk;  // global chunk index
  int lane;       // thread index within the chunk's threads
  bool live;      // false for the idle tail of the last block
};

__device__ __forceinline__ Slot slot_of(int chunk_threads, int64_t nchunks) {
  const int per_block = blockDim.x / chunk_threads;
  Slot s;
  s.chunk = static_cast<int64_t>(blockIdx.x) * per_block +
            threadIdx.x / chunk_threads;
  s.lane = threadIdx.x % chunk_threads;
  s.live = s.chunk < nchunks;
  return s;
}

// Max over the threads of one chunk; every thread of the block calls it.
// chunk_threads is a multiple of 32, so no warp straddles two chunks.
__device__ __forceinline__ float chunk_max(float m, int chunk_threads) {
  __shared__ float warp_max[kMaxWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (chunk_threads == 32) return m;  // one warp owns the chunk
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
  __syncthreads();
  const int per_chunk = chunk_threads >> 5;
  const int first = (warp / per_chunk) * per_chunk;
  m = warp_max[first];
  for (int k = 1; k < per_chunk; ++k) m = nan_max(m, warp_max[first + k]);
  return m;
}

__device__ __forceinline__ float chunk_scale(float amax, float qmax) {
  return __fdiv_rn(nan_max(amax, kEps), qmax);
}

// quantize (kPack == false): x = w, int8 q out.
// pack_update (kPack == true): x = w - g (+ e) over the (L, rows, 128)
// stack, g indexed by chunk % g_chunks; c = q s and err = x - c out.
template <typename WT, bool kPack, bool kHasE>
__global__ void __launch_bounds__(kBlockThreads, 2)
    chunk_quant_kernel(const WT* w, const float* g, const float* e,
                       const float* u, int8_t* q_out, float* c_out,
                       float* err_out, float* scales, int64_t nchunks,
                       int64_t g_chunks, int chunk_threads, float qmax) {
  const Slot sl = slot_of(chunk_threads, nchunks);
  const int64_t vecs = static_cast<int64_t>(chunk_threads) * kVecs;
  const int64_t base = sl.chunk * vecs + sl.lane;
  const int64_t g_base = kPack ? (sl.chunk % g_chunks) * vecs + sl.lane : 0;
  float4 x[kVecs], uv[kVecs];
  float m = 0.0f;
  if (sl.live) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * chunk_threads;
      float4 v = load4(w, i);
      if (kPack) {
        const float4 gv =
            load4(g, g_base + static_cast<int64_t>(k) * chunk_threads);
        v.x = __fsub_rn(v.x, gv.x);
        v.y = __fsub_rn(v.y, gv.y);
        v.z = __fsub_rn(v.z, gv.z);
        v.w = __fsub_rn(v.w, gv.w);
        if (kHasE) {
          const float4 ev = load4(e, i);
          v.x = __fadd_rn(v.x, ev.x);
          v.y = __fadd_rn(v.y, ev.y);
          v.z = __fadd_rn(v.z, ev.z);
          v.w = __fadd_rn(v.w, ev.w);
        }
      }
      x[k] = v;
      uv[k] = load4(u, i);
      m = nan_max(m, abs_max4(v));
    }
  }
  const float s = chunk_scale(chunk_max(m, chunk_threads), qmax);
  if (!sl.live) return;
  if (sl.lane == 0) scales[sl.chunk] = s;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * chunk_threads;
    float4 q;
    q.x = quant(x[k].x, s, uv[k].x, qmax);
    q.y = quant(x[k].y, s, uv[k].y, qmax);
    q.z = quant(x[k].z, s, uv[k].z, qmax);
    q.w = quant(x[k].w, s, uv[k].w, qmax);
    if (kPack) {
      float4 c, err;
      c.x = __fmul_rn(q.x, s);
      c.y = __fmul_rn(q.y, s);
      c.z = __fmul_rn(q.z, s);
      c.w = __fmul_rn(q.w, s);
      err.x = __fsub_rn(x[k].x, c.x);
      err.y = __fsub_rn(x[k].y, c.y);
      err.z = __fsub_rn(x[k].z, c.z);
      err.w = __fsub_rn(x[k].w, c.w);
      reinterpret_cast<float4*>(c_out)[i] = c;
      reinterpret_cast<float4*>(err_out)[i] = err;
    } else {
      reinterpret_cast<char4*>(q_out)[i] = make_char4(
          static_cast<signed char>(__float2int_rz(q.x)),
          static_cast<signed char>(__float2int_rz(q.y)),
          static_cast<signed char>(__float2int_rz(q.z)),
          static_cast<signed char>(__float2int_rz(q.w)));
    }
  }
}

// out = f32(q) * s[chunk]
__global__ void __launch_bounds__(kBlockThreads)
    dequant_kernel(const int8_t* q, const float* scales, float* out,
                   int64_t nchunks, int chunk_threads) {
  const Slot sl = slot_of(chunk_threads, nchunks);
  if (!sl.live) return;
  const int64_t vecs = static_cast<int64_t>(chunk_threads) * kVecs;
  const int64_t base = sl.chunk * vecs + sl.lane;
  const float s = scales[sl.chunk];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * chunk_threads;
    const char4 qv = reinterpret_cast<const char4*>(q)[i];
    float4 o;
    o.x = __fmul_rn(static_cast<float>(qv.x), s);
    o.y = __fmul_rn(static_cast<float>(qv.y), s);
    o.z = __fmul_rn(static_cast<float>(qv.z), s);
    o.w = __fmul_rn(static_cast<float>(qv.w), s);
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

// Launch shape for nchunks chunks of `block` rows; false if not taken.
struct Geometry {
  unsigned blocks;
  int threads;
  int chunk_threads;
};

bool geometry(int64_t nchunks, int block, Geometry* g) {
  if (block < 8 || block > 64 || block % 8 != 0 || nchunks <= 0) {
    return false;
  }
  g->chunk_threads = 4 * block;  // 32 values per thread
  g->threads = kBlockThreads % g->chunk_threads == 0 ? kBlockThreads
                                                     : g->chunk_threads;
  const int per_block = g->threads / g->chunk_threads;
  const int64_t blocks = (nchunks + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return false;
  g->blocks = static_cast<unsigned>(blocks);
  return true;
}

template <typename WT>
int launch_pack_update(const WT* w, const float* g, const float* e,
                       const float* u, float* c, float* err, float* scales,
                       int64_t nchunks, int64_t g_chunks, const Geometry& geo,
                       float qmax, cudaStream_t stream) {
  if (e != nullptr) {
    chunk_quant_kernel<WT, true, true>
        <<<geo.blocks, geo.threads, 0, stream>>>(
            w, g, e, u, nullptr, c, err, scales, nchunks, g_chunks,
            geo.chunk_threads, qmax);
  } else {
    chunk_quant_kernel<WT, true, false>
        <<<geo.blocks, geo.threads, 0, stream>>>(
            w, g, nullptr, u, nullptr, c, err, scales, nchunks, g_chunks,
            geo.chunk_threads, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, u: (rows, 128) f32; q: (rows, 128) int8; scales: rows / block f32.
int repro_quantize(const void* x, const void* u, void* q, void* scales,
                   int64_t rows, int block, int qmax, void* stream) {
  Geometry geo;
  if (rows % block != 0 || !geometry(rows / block, block, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chunk_quant_kernel<float, false, false>
      <<<geo.blocks, geo.threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), nullptr, nullptr,
          static_cast<const float*>(u), static_cast<int8_t*>(q), nullptr,
          nullptr, static_cast<float*>(scales), rows / block, 1,
          geo.chunk_threads, static_cast<float>(qmax));
  return static_cast<int>(cudaGetLastError());
}

// q: (rows, 128) int8; scales: rows / block f32; out: (rows, 128) f32.
int repro_dequantize(const void* q, const void* scales, void* out,
                     int64_t rows, int block, void* stream) {
  Geometry geo;
  if (rows % block != 0 || !geometry(rows / block, block, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dequant_kernel<<<geo.blocks, geo.threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), rows / block, geo.chunk_threads);
  return static_cast<int>(cudaGetLastError());
}

// w: (L, rows, 128) f32 (w_bf16 == 0) or bf16 (w_bf16 == 1); g: (rows,
// 128) f32; e: (L, rows, 128) f32 or NULL; u, c, err: (L, rows, 128) f32;
// scales: L * rows / block f32, learner-major.
int repro_pack_update(const void* w, const void* g, const void* e,
                      const void* u, void* c, void* err, void* scales,
                      int64_t num_learners, int64_t rows, int block,
                      int w_bf16, int qmax, void* stream) {
  Geometry geo;
  if (num_learners < 1 || rows % block != 0 ||
      !geometry(num_learners * (rows / block), block, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t g_chunks = rows / block;
  const int64_t nchunks = num_learners * g_chunks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* ef = static_cast<const float*>(e);
  const float* uf = static_cast<const float*>(u);
  float* cf = static_cast<float*>(c);
  float* errf = static_cast<float*>(err);
  float* sf = static_cast<float*>(scales);
  const float qm = static_cast<float>(qmax);
  if (w_bf16) {
    return launch_pack_update(static_cast<const __nv_bfloat16*>(w), gf, ef,
                              uf, cf, errf, sf, nchunks, g_chunks, geo, qm,
                              s);
  }
  return launch_pack_update(static_cast<const float*>(w), gf, ef, uf, cf,
                            errf, sf, nchunks, g_chunks, geo, qm, s);
}

}  // extern "C"
