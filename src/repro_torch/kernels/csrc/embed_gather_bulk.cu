// embed_gather, bulk route — the PS pull (forward of the sparse embedding
// lookup) on Hopper (sm_90a), each row moved whole by the TMA unit.
//
// Replaces the TPU kernel src/repro/kernels/embed_gather.py::embed_gather
// (pallas_call body _gather_kernel): out[i] = table[ids[i] - row_offset]
// when 0 <= ids[i] - row_offset < Vs, else a row of zeros.
//
// What bounds it on this card: bytes. It does no arithmetic; the least it
// must move is the owned rows it reads, the N rows it writes and the N ids:
//   (owned + N) * row_bytes + 4 * N  bytes over 3.35e12 B/s.
// At a 2,048-token phi3-medium-14b prefill (10,240 B rows, 1,546 owned)
// that is 36.8 MB, 11 us. On the main path (1,024 B rows, 566 of 2,560 ids
// owned) it is 3.2 MB, under 1 us: there the launch and three dependent
// memory latencies (id, row, store) cost more than the bytes.
//
// Design. A row is one copy of row_bytes, so no thread touches its data,
// and every lane of a warp is an independent copier:
//   * blocks of one warp; lane l of block b is copier q = b * L + l
//     (L <= 32 active lanes, as many as shared memory and N / SMs allow)
//     and copies ids q, q + Q, q + 2Q, ... (Q = G * L copiers in all);
//   * each copier owns one row slot and one mbarrier. Per id: one
//     cp.async.bulk of the whole row into its slot, completing on the
//     mbarrier (expect_tx row_bytes); then one bulk store of the slot to
//     out[i]; before the slot takes the next id, wait_group.read until
//     that store has read it;
//   * an unowned id reads no table bytes: its row is a bulk store of a
//     zeroed tile shared by the block's lanes (+0.0 bits);
//   * a warp issues its lanes' copies in one instruction each, so at the
//     paths' shapes (one id per copier) every row of the call is requested
//     at once; the id load is issued before the block sets up its tile and
//     barriers, and a block waits only until its stores have read shared
//     memory, not until their writes land (a round trip saved per block).
// Rows must be 16..32,768 bytes, a multiple of 16, with a 16-byte aligned
// table and output; kernels/ops.py::gather_route sends every other shape
// to csrc/embed_gather.cu. A pure copy, so dtype-agnostic and bitwise equal
// to its plain version (kernels/ref.py::embed_gather_ref).
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns a cudaError_t (the launch's,
// or cudaErrorInvalidValue for a shape this route does not take).
#include "sm90.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int64_t kMaxRowBytes = 32768;
constexpr int64_t kSmemBytes = 232448;     // an SM's shared memory (227 KB)
constexpr int64_t kBlockReserve = 1024;    // the runtime's share per block
constexpr int64_t kBarBytes = 8 * kLanes;

// shared memory: [kLanes mbarriers][zero tile row_bytes][lanes x row_bytes]
__global__ void __launch_bounds__(kLanes)
    gather_bulk(const uint8_t* __restrict__ table,
                const int32_t* __restrict__ ids, uint8_t* __restrict__ out,
                int64_t n, int64_t vs, uint32_t row_bytes, int64_t row_offset,
                int lanes) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int l = threadIdx.x;
  const int64_t nq = (int64_t)gridDim.x * lanes;
  const int64_t q = (int64_t)blockIdx.x * lanes + l;
  const bool active = l < lanes && q < n;
  int32_t id = active ? ids[q] : 0;            // in flight during the set-up
  const uint32_t bar = sm90::smem_u32(smem) + 8 * l;
  if (active) sm90::mbar_init(bar, 1);
  sm90::mbar_fence_init();
  uint8_t* zero = smem + kBarBytes;
  for (uint32_t k = l; k < row_bytes / 16; k += kLanes)
    reinterpret_cast<uint4*>(zero)[k] = make_uint4(0, 0, 0, 0);
  sm90::fence_proxy_async();                   // bulk stores read the tile
  __syncwarp();
  if (!active) return;

  const uint32_t zero0 = sm90::smem_u32(zero);
  const uint32_t slot = zero0 + row_bytes * (1 + l);
  uint32_t phase = 0;
  for (int64_t j = q; j < n; j += nq) {
    const int64_t next = j + nq;
    const int32_t id_next = next < n ? ids[next] : 0;
    const int64_t local = (int64_t)id - row_offset;
    uint32_t src = zero0;
    if (local >= 0 && local < vs) {
      sm90::mbar_expect_tx(bar, row_bytes);
      sm90::bulk_load(slot, table + local * row_bytes, row_bytes, bar);
      sm90::mbar_wait(bar, phase);
      phase ^= 1u;
      src = slot;
    }
    sm90::bulk_store(out + j * (int64_t)row_bytes, src, row_bytes);
    sm90::bulk_commit();
    if (next < n) sm90::bulk_wait_read<0>();   // the slot is free again
    id = id_next;
  }
  // the tile and slot must outlive their last reads; the writes themselves
  // are complete when the kernel is
  sm90::bulk_wait_read<0>();
}

}  // namespace

extern "C" int repro_embed_gather_bulk(const void* table, const void* ids,
                                       void* out, int64_t n, int64_t vs,
                                       int64_t row_bytes, int64_t row_offset,
                                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (row_bytes < 16 || row_bytes % 16 != 0 || row_bytes > kMaxRowBytes ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || vs < 0 ||
      n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // copiers per block: enough to spread N over the SMs, as many as fit
  int64_t lanes = (n + sms - 1) / sms;
  const int64_t fit =
      (kSmemBytes - kBlockReserve - kBarBytes - row_bytes) / row_bytes;
  if (lanes > fit) lanes = fit;
  if (lanes > kLanes) lanes = kLanes;
  const int64_t smem = kBarBytes + row_bytes * (1 + lanes);
  int64_t per_sm = kSmemBytes / (smem + kBlockReserve);
  if (per_sm > 32) per_sm = 32;                // an SM's most blocks
  int64_t grid = (n + lanes - 1) / lanes;
  if (grid > sms * per_sm) grid = sms * per_sm;
  static bool opted_in = false;   // the >48 KB dynamic shared memory opt-in
  if (!opted_in) {
    err = cudaFuncSetAttribute(gather_bulk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kSmemBytes - kBlockReserve));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  gather_bulk<<<(unsigned)grid, kLanes, (size_t)smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const int32_t*>(ids),
      static_cast<uint8_t*>(out), n, vs, (uint32_t)row_bytes, row_offset,
      (int)lanes);
  return (int)cudaGetLastError();
}
