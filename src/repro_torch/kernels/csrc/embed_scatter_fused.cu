// embed_scatter_add, one-pass route — the PS push (backward of the sparse
// embedding lookup) on Hopper (sm_90a): one launch writes the whole
// gradient, with no separate zero fill and no dump row.
//
// Replaces the TPU kernel src/repro/kernels/embed_scatter.py::
// embed_scatter_add (pallas_call body _scatter_kernel, whose output aliases
// a jnp.zeros (Vs + 1, E) buffer): out[ids[i]] = f32(rows[i]) for owned ids
// (0 <= id < Vs), zeros in every row that no id lands on; unowned ids are
// dropped.
//
// What bounds it on this card: bytes. The function's output is the whole
// (Vs, E) f32 gradient, so the least it must move is every output byte
// written once and the N rows and ids read once:
//   Vs * E * 4 + N * E * itemsize + 4 * N  bytes over 3.35e12 B/s.
// At the main path's Vs = 800,000, E = 512, N = 2,560 (bf16 rows) that is
// 1,641,031,680 B, 0.4899 ms: the zero rows are nearly all of it.
//
// Design:
//   * the wrapper (kernels/ops.py::scatter_partition) cuts [0, Vs) into G
//     ranges of R rows, the last one ragged: about 64 KB of output per
//     block, and more rows when N is large, so that no block reads more id
//     bytes than a quarter of the bytes it writes. Block b owns rows
//     [b * R, min((b + 1) * R, Vs)) and writes each of them once;
//   * blocks are short and run in launch order, so at any moment the
//     card's writes fall in one narrow window of the gradient that moves
//     through it as a fill's would (a first design, every block a 1.55 MB
//     range and all resident at once, wrote measurably slower);
//   * map: the block reads all N ids (coalesced; from L2 after the first
//     blocks) and, for each id inside its range, sets map[id - start] = i in
//     shared memory, -1 elsewhere. Ids unique among owned rows (the dedupe
//     buffer) give a row at most one source, in whatever order they come:
//     nothing assumes the ids are sorted;
//   * write: a warp per row, 16-byte stores (4 floats) a lane: zeros where
//     the row has no source, else its source row widened (bf16 -> f32 is
//     the exact bit shift);
//   * unowned ids store nothing, so no row is written twice and no row takes
//     the stores of every sentinel.
// Each pushed value gets + 0.0f, as the plain version's index_add_ into
// zeros does, so the result is bitwise equal to kernels/ref.py::
// embed_scatter_add_ref (a -0.0 gradient reads +0.0 in both). E % 4 == 0
// with a 16-byte aligned output and rows aligned to 4 elements take the
// 4-wide path, other shapes one element per lane.
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns a cudaError_t (the launch's,
// or cudaErrorInvalidValue for a partition that does not cover [0, Vs)).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxRowsPerBlock = 8192;   // the map: 32 KB at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

// four elements of a source row, widened: Src float (f32 rows) or
// uint16_t (bf16 rows' bits)
template <typename Src>
__device__ __forceinline__ float4 load4(const Src* s, int64_t c) {
  if constexpr (sizeof(Src) == 4) {
    return reinterpret_cast<const float4*>(s)[c];
  } else {
    const uint2 raw = reinterpret_cast<const uint2*>(s)[c];
    return make_float4(to_f32(static_cast<uint16_t>(raw.x & 0xffffu)),
                       to_f32(static_cast<uint16_t>(raw.x >> 16)),
                       to_f32(static_cast<uint16_t>(raw.y & 0xffffu)),
                       to_f32(static_cast<uint16_t>(raw.y >> 16)));
  }
}

// VEC: elements per store, 4 or 1
template <typename Src, int VEC>
__global__ void __launch_bounds__(kThreads)
    scatter_fused(const int32_t* __restrict__ ids,
                  const Src* __restrict__ rows, float* __restrict__ out,
                  int64_t n, int64_t vs, int64_t e, int64_t per_block) {
  extern __shared__ int32_t map[];
  const int64_t start = (int64_t)blockIdx.x * per_block;
  const int64_t count = vs - start < per_block ? vs - start : per_block;
  for (int64_t r = threadIdx.x; r < count; r += kThreads) map[r] = -1;
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const int64_t local = (int64_t)ids[i] - start;
    if (local >= 0 && local < count) map[local] = (int32_t)i;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t units = e / VEC;   // stores per row
  for (int64_t r = threadIdx.x >> 5; r < count; r += kThreads / 32) {
    const int32_t src = map[r];
    float* d = out + (start + r) * e;
    if (src < 0) {
#pragma unroll 4
      for (int64_t c = lane; c < units; c += 32) {
        if constexpr (VEC == 4)
          reinterpret_cast<float4*>(d)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          d[c] = 0.f;
      }
      continue;
    }
    const Src* s = rows + (int64_t)src * e;
    for (int64_t c = lane; c < units; c += 32) {
      if constexpr (VEC == 4) {
        const float4 f = load4(s, c);
        reinterpret_cast<float4*>(d)[c] =
            make_float4(f.x + 0.f, f.y + 0.f, f.z + 0.f, f.w + 0.f);
      } else {
        d[c] = to_f32(s[c]) + 0.f;
      }
    }
  }
}

template <typename Src, int VEC>
cudaError_t launch(const void* ids, const void* rows, void* out, int64_t n,
                   int64_t vs, int64_t e, int64_t per_block, int64_t grid,
                   cudaStream_t stream) {
  scatter_fused<Src, VEC><<<(unsigned)grid, kThreads,
                            (size_t)(4 * per_block), stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const Src*>(rows),
      static_cast<float*>(out), n, vs, e, per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_embed_scatter_fused(const void* ids, const void* rows,
                                         void* out, int64_t n, int64_t vs,
                                         int64_t e, int64_t itemsize,
                                         int64_t per_block, int64_t grid,
                                         void* stream) {
  if (vs <= 0 || e <= 0) return (int)cudaSuccess;
  // the partition must cover [0, Vs) exactly once, each range non-empty
  if (n < 0 || n > 2147483647LL || per_block < 1 ||
      per_block > kMaxRowsPerBlock || grid < 1 || grid > 2147483647LL ||
      (grid - 1) * per_block >= vs || grid * per_block < vs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = e % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % (4 * itemsize) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (itemsize == 4) {
    return (int)(vec ? launch<float, 4>(ids, rows, out, n, vs, e, per_block,
                                        grid, s)
                     : launch<float, 1>(ids, rows, out, n, vs, e, per_block,
                                        grid, s));
  }
  if (itemsize == 2) {
    return (int)(vec ? launch<uint16_t, 4>(ids, rows, out, n, vs, e,
                                           per_block, grid, s)
                     : launch<uint16_t, 1>(ids, rows, out, n, vs, e,
                                           per_block, grid, s));
  }
  return (int)cudaErrorInvalidValue;
}
