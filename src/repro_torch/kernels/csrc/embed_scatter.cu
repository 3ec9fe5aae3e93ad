// embed_scatter_add — the PS push (backward of the sparse embedding lookup)
// on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embed_scatter.py::
// embed_scatter_add (pallas_call body _scatter_kernel): out[ids[i]] =
// f32(rows[i]) for owned ids; unowned ids (negative, >= Vs, or the dedupe
// sentinel) go to a dump row Vs that the wrapper drops. The ids come from the
// dedupe buffer, so they are unique among owned rows: a scatter-add over
// unique ids is a plain store, and no atomics are needed.
//
// What bounds it on this card: bytes. The least it must move is the N rows
// it reads, the N ids and the owned rows it writes:
//   N * E * itemsize + 4 * N + owned * E * 4  bytes over 3.35e12 B/s.
// The output is a (Vs + 1, E) f32 zeros buffer that the wrapper
// (kernels/ops.py) allocates, the counterpart of the TPU kernel's aliased
// zeros input. That fill is the wrapper's, not this kernel's: at the main
// path's Vs = 800,000 and E = 512 it is about 1.64 GB, some 0.5 ms at
// 3.35 TB/s, far more than the kernel's own bytes.
//
// Design: a 2-D grid of (row block x E tile). Each thread converts four
// elements (one 16-byte f32 store) when E % 4 == 0 and the pointers allow
// it, otherwise one element. bf16 -> f32 is the exact bit shift, so the
// result is bitwise equal to the plain version
// (kernels/ref.py::embed_scatter_add_ref).
//
// Race, harmless by design: many sentinel ids store to the dump row at once.
// The row is sliced off by the wrapper, so whichever store lands last does
// not matter.
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;     // units along a row (blockDim.x)
constexpr int kRowsPerBlock = 8;  // rows per block (blockDim.y)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

// Src: float (f32 rows) or uint16_t (bf16 rows' bits). VEC: elements per
// thread, 4 or 1.
template <typename Src, int VEC>
__global__ void scatter_rows(const int32_t* __restrict__ ids,
                             const Src* __restrict__ rows,
                             float* __restrict__ out, int64_t n, int64_t vs,
                             int64_t e) {
  const int64_t i = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  const int64_t u = (int64_t)blockIdx.y * kThreadsX + threadIdx.x;
  if (i >= n || u * VEC >= e) return;
  const int64_t id = ids[i];
  const int64_t dst = (id >= 0 && id < vs) ? id : vs;  // dump row
  const Src* src = rows + i * e + u * VEC;
  float* d = out + dst * e + u * VEC;
  if constexpr (VEC == 4) {
    float4 f;
    if constexpr (sizeof(Src) == 4) {
      f = *reinterpret_cast<const float4*>(src);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      f.x = to_f32(static_cast<uint16_t>(raw.x & 0xffffu));
      f.y = to_f32(static_cast<uint16_t>(raw.x >> 16));
      f.z = to_f32(static_cast<uint16_t>(raw.y & 0xffffu));
      f.w = to_f32(static_cast<uint16_t>(raw.y >> 16));
    }
    *reinterpret_cast<float4*>(d) = f;
  } else {
    *d = to_f32(*src);
  }
}

template <typename Src, int VEC>
cudaError_t launch(const void* ids, const void* rows, void* out, int64_t n,
                   int64_t vs, int64_t e, cudaStream_t stream) {
  const int64_t units = e / VEC;
  const int64_t tiles = (units + kThreadsX - 1) / kThreadsX;
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (tiles > 65535 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)tiles);
  dim3 block(kThreadsX, kRowsPerBlock);
  scatter_rows<Src, VEC><<<grid, block, 0, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const Src*>(rows),
      static_cast<float*>(out), n, vs, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_embed_scatter_add(const void* ids, const void* rows,
                                       void* out, int64_t n, int64_t vs,
                                       int64_t e, int64_t itemsize,
                                       void* stream) {
  if (n <= 0 || e <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = e % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % (4 * itemsize) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (itemsize == 4) {
    return (int)(vec ? launch<float, 4>(ids, rows, out, n, vs, e, s)
                     : launch<float, 1>(ids, rows, out, n, vs, e, s));
  }
  if (itemsize == 2) {
    return (int)(vec ? launch<uint16_t, 4>(ids, rows, out, n, vs, e, s)
                     : launch<uint16_t, 1>(ids, rows, out, n, vs, e, s));
  }
  return (int)cudaErrorInvalidValue;
}
