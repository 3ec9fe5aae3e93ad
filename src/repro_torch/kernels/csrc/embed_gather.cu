// embed_gather — the PS pull (forward of the sparse embedding lookup) on
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embed_gather.py::embed_gather
// (pallas_call body _gather_kernel): out[i] = table[ids[i] - row_offset]
// when 0 <= ids[i] - row_offset < Vs, else a row of zeros.
//
// What bounds it on this card: bytes. It does no arithmetic; the least it
// must move is the owned rows it reads, the N rows it writes and the N ids:
//   (owned + N) * E * itemsize + 4 * N  bytes over 3.35e12 B/s.
// On the main path (Vs = 800,000, E = 512, N = 2,560 dedupe slots, most of
// them sentinels past the unique count) that is a few MB: the launch costs
// more than the bytes.
//
// Design: a pure copy, so it is dtype-agnostic and bitwise equal to its
// plain version (kernels/ref.py::embed_gather_ref). A 2-D grid of
// (row block x E tile); each thread moves one 16-byte vector when a row is a
// whole number of 16-byte vectors and both base pointers are 16-byte
// aligned, otherwise one element (the scalar path, e.g. E = 100 in bf16).
// Unowned ids write zero bits (+0.0). Offsets are int64: Vs * E is close to
// 2^31 elements at the main path's shape.
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;     // units along a row (blockDim.x)
constexpr int kRowsPerBlock = 8;  // rows per block (blockDim.y)

// Unit: uint4 (16 B) on the vector path, or one element's bits (uint16_t for
// bf16, uint32_t for f32) on the scalar path.
template <typename Unit>
__global__ void gather_rows(const Unit* __restrict__ table,
                            const int32_t* __restrict__ ids,
                            Unit* __restrict__ out, int64_t n, int64_t vs,
                            int64_t units_per_row, int64_t row_offset) {
  const int64_t i = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  const int64_t u = (int64_t)blockIdx.y * kThreadsX + threadIdx.x;
  if (i >= n || u >= units_per_row) return;
  const int64_t local = (int64_t)ids[i] - row_offset;
  Unit v{};
  if (local >= 0 && local < vs) v = table[local * units_per_row + u];
  out[i * units_per_row + u] = v;
}

template <typename Unit>
cudaError_t launch(const void* table, const void* ids, void* out, int64_t n,
                   int64_t vs, int64_t units, int64_t row_offset,
                   cudaStream_t stream) {
  const int64_t tiles = (units + kThreadsX - 1) / kThreadsX;
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (tiles > 65535 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)tiles);
  dim3 block(kThreadsX, kRowsPerBlock);
  gather_rows<Unit><<<grid, block, 0, stream>>>(
      static_cast<const Unit*>(table), static_cast<const int32_t*>(ids),
      static_cast<Unit*>(out), n, vs, units, row_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_embed_gather(const void* table, const void* ids,
                                  void* out, int64_t n, int64_t vs, int64_t e,
                                  int64_t itemsize, int64_t row_offset,
                                  void* stream) {
  if (n <= 0 || e <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = e * itemsize;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return (int)launch<uint4>(table, ids, out, n, vs, row_bytes / 16,
                                     row_offset, s);
  if (itemsize == 2) return (int)launch<uint16_t>(table, ids, out, n, vs, e,
                                                  row_offset, s);
  if (itemsize == 4) return (int)launch<uint32_t>(table, ids, out, n, vs, e,
                                                  row_offset, s);
  return (int)cudaErrorInvalidValue;
}
