// Hand-written Hopper (sm_90a) kernels of the MoE layer's row movement
// (repro_torch.models.moe): the dispatch of token rows into the (E, C)
// expert-slot table and the combine of the table's rows back into tokens,
// each the other's backward.
//
// They replace no TPU kernel: the JAX package's dispatch is an XLA gather
// and its combine an XLA scatter-add (src/repro/models/moe.py). On the card
// ATen ran them as a gather from a copy of the tokens with a zero row
// appended, and as a (T, k, d) gather, a where and a sum; the backward of
// each gather was ATen's accumulating index_put, which sorts the indices
// and walks every run of equal indices serially. Every empty table cell
// points at the one zero row, and every dropped slot at the table's last
// row, so one run holds thousands of rows: 4.7 ms a call at DeepSeekMoE's
// widths, about 100 times its bytes. Both maps are known in the forward,
// and neither backward needs an accumulate:
//
//   repro_moe_rows_by_table  out[i] = src[table[i]], a zero row where
//                            table[i] == sentinel (src's row count): the
//                            dispatch's forward, and the combine's backward
//                            (table = the dispatch table, src = the
//                            cotangent of the combine's output).
//   repro_moe_sum_by_slots   out[t] = sum over j of src[slots[t, j]] where
//                            slots[t, j] < sentinel (src's row count), in
//                            ascending j, accumulated in f32 from +0.0 and
//                            rounded once: the combine's forward, and the
//                            dispatch's backward. slots holds each token's
//                            table cells in ascending order (expert order,
//                            the table's), dropped slots (== sentinel) last.
//
// Bound: device-memory bytes. Neither does arithmetic beyond k - 1 adds a
// value; each reads rows and writes rows. At DeepSeekMoE's training shapes
// (T = 4,096 tokens, k = 6, E = 64, C = 480, d = 2,048 in bf16) the table
// is 126 MB, the tokens 16.8 MB.
//
// Design. Pure gathers: each output row is written by one group of threads
// from the rows its index names, so there is no sort, no atomic and no
// order that changes from run to run. A block of 256 threads takes one
// group of rows a step of a grid-stride loop (as many blocks as groups,
// capped at the grid's limit): a row's threads each move one chunk of 16
// bytes (8 bf16 or 4 f32 values), neighbouring threads on neighbouring
// chunks, so a 4 KB bf16 row is one coalesced pass of 256 threads. Rows
// narrower than 256 chunks share a block: 256 / (the row's chunks, rounded
// up to a power of two) rows a block. The row's index is loaded by every
// thread of its group from one address, a broadcast. sum_by_slots loads
// its slots' rows for up to 8 slots into registers before it adds any, so
// the loads are in flight together, then adds them in ascending j (more
// than 8 slots are taken 8 at a time, in order).
//
// Numerics: __fadd_rn in f32 (the library is built with --fmad=false), one
// __float2bfloat16_rn at the end for bf16; the plain PyTorch version adds
// in the same order from the same +0.0 and rounds once, so the two agree
// bitwise. rows_by_table copies bits.
//
// Rows are whole 16-byte chunks and start 16-byte aligned (the wrapper
// checks). An index outside [0, sentinel] traps (the device-side assert of
// ATen's gathers): the tables come from the routing, never from outside.
// Each exported function launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsAhead = 8;  // slot rows loaded before they are summed
constexpr int64_t kMaxGrid = 0x7fffffffLL;

// 16 bytes of T, loaded and stored as one vector
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The threads of a block: 2^lg threads a row, 256 >> lg rows a block.
struct RowGroup {
  int lg;

  __device__ __forceinline__ int col() const {
    return threadIdx.x & ((1 << lg) - 1);
  }
  __device__ __forceinline__ int64_t first_row() const {
    return static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) +
           (threadIdx.x >> lg);
  }
  __device__ __forceinline__ int64_t row_step() const {
    return static_cast<int64_t>(gridDim.x) * (kThreads >> lg);
  }
};

// cpr: 16-byte chunks a row.
__global__ void __launch_bounds__(kThreads)
    rows_by_table_kernel(const uint4* __restrict__ src,
                         const int64_t* __restrict__ table,
                         uint4* __restrict__ out, int64_t n_rows,
                         int64_t sentinel, int cpr, RowGroup g) {
  for (int64_t row = g.first_row(); row < n_rows; row += g.row_step()) {
    const int64_t t = table[row];
    if (t < 0 || t > sentinel) __trap();
    uint4* o = out + row * cpr;
    if (t == sentinel) {
      for (int c = g.col(); c < cpr; c += 1 << g.lg) o[c] = uint4{};
    } else {
      const uint4* s = src + t * cpr;
      for (int c = g.col(); c < cpr; c += 1 << g.lg) o[c] = s[c];
    }
  }
}

// T: float or __nv_bfloat16; cpr: 16-byte chunks a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_by_slots_kernel(const Pack<T>* __restrict__ src,
                        const int64_t* __restrict__ slots,
                        Pack<T>* __restrict__ out, int64_t n_tokens, int k,
                        int64_t sentinel, int cpr, RowGroup g) {
  constexpr int N = Pack<T>::N;
  for (int64_t row = g.first_row(); row < n_tokens; row += g.row_step()) {
    const int64_t* s = slots + row * k;
    for (int c = g.col(); c < cpr; c += 1 << g.lg) {
      float acc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = 0.0f;
      for (int j0 = 0; j0 < k; j0 += kSlotsAhead) {
        Pack<T> rows[kSlotsAhead];
        bool kept[kSlotsAhead];
#pragma unroll
        for (int j = 0; j < kSlotsAhead; ++j) {
          const int64_t slot = j0 + j < k ? s[j0 + j] : sentinel;
          if (slot < 0 || slot > sentinel) __trap();
          kept[j] = slot < sentinel;
          if (kept[j]) rows[j] = src[slot * cpr + c];
        }
#pragma unroll
        for (int j = 0; j < kSlotsAhead; ++j) {
          if (kept[j]) {
#pragma unroll
            for (int i = 0; i < N; ++i)
              acc[i] = __fadd_rn(acc[i], to_f32(rows[j].v[i]));
          }
        }
      }
      Pack<T> o;
#pragma unroll
      for (int i = 0; i < N; ++i) o.v[i] = from_f32<T>(acc[i]);
      out[row * cpr + c] = o;
    }
  }
}

// The row group for rows of cpr chunks, and the grid for n_rows rows.
RowGroup group_for(int cpr) {
  RowGroup g{0};
  while ((1 << g.lg) < cpr && (1 << g.lg) < kThreads) ++g.lg;
  return g;
}

int grid_for(int64_t n_rows, RowGroup g) {
  const int64_t rpb = kThreads >> g.lg;
  const int64_t want = (n_rows + rpb - 1) / rpb;
  return static_cast<int>(want < kMaxGrid ? want : kMaxGrid);
}

template <typename T>
int launch_sums(const void* src, const int64_t* slots, void* out,
                int64_t n_tokens, int k, int64_t sentinel, int cpr,
                cudaStream_t stream) {
  const RowGroup g = group_for(cpr);
  sum_by_slots_kernel<T><<<grid_for(n_tokens, g), kThreads, 0, stream>>>(
      static_cast<const Pack<T>*>(src), slots, static_cast<Pack<T>*>(out),
      n_tokens, k, sentinel, cpr, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src: (sentinel, row_bytes) bytes; table: n_rows int64 in [0, sentinel];
// out: (n_rows, row_bytes) bytes. row_bytes is a multiple of 16.
int repro_moe_rows_by_table(const void* src, const void* table, void* out,
                            int64_t n_rows, int64_t sentinel,
                            int64_t row_bytes, void* stream) {
  const int64_t cpr = row_bytes / 16;
  if (n_rows < 0 || sentinel < 0 || row_bytes % 16 || cpr < 1 ||
      cpr > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const RowGroup g = group_for(static_cast<int>(cpr));
  rows_by_table_kernel<<<grid_for(n_rows, g), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const int64_t*>(table),
      static_cast<uint4*>(out), n_rows, sentinel, static_cast<int>(cpr), g);
  return static_cast<int>(cudaGetLastError());
}

// src: (sentinel, d) f32 (bf16 == 0) or bf16 (bf16 == 1); slots: (n_tokens,
// k) int64, each row ascending in [0, sentinel]; out: (n_tokens, d) of
// src's dtype. A row is a multiple of 16 bytes.
int repro_moe_sum_by_slots(const void* src, const void* slots, void* out,
                           int64_t n_tokens, int k, int64_t sentinel,
                           int64_t d, int bf16, void* stream) {
  const int64_t row_bytes = d * (bf16 ? 2 : 4);
  const int64_t cpr = row_bytes / 16;
  if (n_tokens < 0 || k < 1 || sentinel < 0 || row_bytes % 16 || cpr < 1 ||
      cpr > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tokens == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* sl = static_cast<const int64_t*>(slots);
  const int c = static_cast<int>(cpr);
  return bf16 ? launch_sums<__nv_bfloat16>(src, sl, out, n_tokens, k,
                                           sentinel, c, s)
              : launch_sums<float>(src, sl, out, n_tokens, k, sentinel, c, s);
}

}  // extern "C"
