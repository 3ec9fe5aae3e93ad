// flash_attention_tc — the bf16 forward of flash attention on Hopper's
// tensor cores (sm_90a): wgmma, TMA and an mbarrier ring, warp-specialised.
//
// Replaces, for bf16 with D in {64, 128, 160}, the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (pallas_call body
// _flash_kernel): for q (B, Sq, H, D) and k, v (B, Sk, H, D), KV already
// expanded to H heads,
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h],  s_ij = D^-0.5 q_i . k_j,
// masked where kpos >= Sk and, when causal, where kpos > qpos (positions
// counted from 0 on both sides), masked scores -1e30, the output
// acc / max(l, 1e-30) in bf16. f32 and the narrow heads stay on the scalar
// kernel (flash_attention.cu); kernels/ops.py picks the route by dtype and D.
//
// What bounds it on this card: operations. At a 2,048-token phi3-medium-14b
// prefill (B 1, H 40, D 128, causal) the unmasked pairs need ~43 GFLOP, 0.043
// ms at the 989 TFLOP/s bf16 tensor-core peak, against 84 MB of q, k, v and o
// (0.025 ms at 3.35 TB/s). So the products run on the tensor cores, and the
// copies run asynchronously beside them.
//
// Design (the shape of FlashAttention-3's forward, written out by hand):
//  * One CTA per (b*h, 128-row q tile), the last q tile issued first so that
//    under a causal mask the longest rows start first. 384 threads: two
//    consumer warpgroups of 64 q rows each and a producer warpgroup, of which
//    one thread issues every copy; setmaxnreg moves the producer's registers
//    to the consumers (24 and 240 a thread).
//  * Copies by TMA over 4-D tensor maps (D, H, S, B) built on the host from
//    the caller's strides, with the 128-byte swizzle: Q once, K and V tiles
//    of 128 rows into a 2-stage ring, each stage with a full barrier per
//    tensor and one empty barrier. A box is 64 bf16 wide, so a D = 128 tile
//    is two boxes. A D = 160 tile (stablelm-12b) is two such boxes and a
//    third of 32 columns, 64 B wide, copied through its own tensor maps with
//    the 64-byte swizzle (a third 64-wide box would need 245,760 B of shared
//    memory at kBN 128; the 32-wide one keeps it at 204,800 B). TMA fills
//    rows past Sq or Sk with zeros.
//  * S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory,
//    f32 accumulate, D/16 steps (at D = 160 the last two read the 32-wide
//    box through 64-byte-swizzle descriptors). D^-0.5 (with log2 e folded in) scales the
//    f32 scores after the product, not q in bf16 before it.
//  * Only a tile crossing the causal diagonal or the Sk edge is masked, and a
//    causal CTA stops at its diagonal tile.
//  * Online softmax on the accumulator fragment: a row lives on the 4 lanes
//    of a quad, so its max takes two shuffles; m and l stay f32 in registers;
//    exp2f on the log2-scaled scores.
//  * O += P V: P is rounded to bf16 in registers, where the S accumulator
//    layout is already wgmma's register-A layout; V is the MN-major B operand
//    straight from its TMA tile; at D = 160 an m64n128k16 covers columns
//    0-127 and an m64n32k16 columns 128-159. O stays f32 in registers. l sums the
//    bf16-rounded P, the weights the product really applies, so the output
//    is their exact weighted mean.
//  * A consumer releases a stage once the P.V that read it has completed.
//  * Resources (-Xptxas -v): 168 registers at launch, no spills; 164,920 B
//    of dynamic shared memory at D = 128 (83,000 at D = 64, 205,880 at
//    D = 160), one CTA per SM.
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns a cudaError_t (or 1000 + the
// CUresult of a tensor map that could not be encoded).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;              // q rows per CTA (two warpgroups of 64)
constexpr int kBN = 128;              // kv rows per tile
constexpr int kBox = 64;              // bf16 columns per TMA box (128 B)
constexpr int kBoxBytes = kBN * kBox * 2;   // one box of 128 rows: 16 KB
constexpr int kTailBox = 32;          // the last 32 columns of D = 160 (64 B)
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, in bytes from a 1,024-byte aligned base: Q at 0, K[2],
// V[2] (128 rows each), then q_full, k_full[2], v_full[2], empty[2]
#define HD __host__ __device__ static constexpr int
struct Smem {
  HD tile(int d) { return kBM * d * 2; }
  HD k(int d, int s) { return tile(d) * (1 + s); }
  HD v(int d, int s) { return tile(d) * (1 + kStages + s); }
  HD bars(int d) { return tile(d) * (1 + 2 * kStages); }
  HD bytes(int d) { return bars(d) + 8 * 7 + 1024; }  // + alignment slack
};
#undef HD

// a tile's 64-wide boxes and its 32-wide tail (0 or 32 columns)
template <int D>
struct Cols {
  static constexpr int kWide = D / kBox, kTail = D % kBox;
  static constexpr int kMain = D - kTail;
  static_assert(kTail == 0 || kTail == kTailBox, "D must be 64 k or 64 k + 32");
};

struct OutArgs {
  __nv_bfloat16* o;
  int64_t sb, ss, sh;    // strides of o in elements (d contiguous)
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tq32,
             const __grid_constant__ CUtensorMap tk32,
             const __grid_constant__ CUtensorMap tv32, OutArgs out, int sq,
             int sk, int h, int causal, float scale_log2) {
  constexpr int kBoxes = Cols<D>::kWide, kTail = Cols<D>::kTail;
  constexpr int kMain = Cols<D>::kMain;
  constexpr int kTailOff = kBoxes * kBoxBytes;   // the tail box in a tile
  constexpr int kTileBytes = Smem::tile(D);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bar = base + Smem::bars(D);
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (3 + s); };
  auto empty = [&](int s) { return bar + 8u * (5 + s); };

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  int n_tiles = (sk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBM - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(empty(s), 2);         // one arrival per consumer group
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer: one thread keeps the ring full ------------
    sm90::regs_release<kProducerRegs>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tq);
      sm90::tma_prefetch_desc(&tk);
      sm90::tma_prefetch_desc(&tv);
      sm90::mbar_expect_tx(q_full, kTileBytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        sm90::tma_load_4d(sQ + x * kBoxBytes, &tq, q_full, x * kBox, hh, q0,
                          b);
      if constexpr (kTail != 0)
        sm90::tma_load_4d(sQ + kTailOff, &tq32, q_full, kMain, hh, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        sm90::mbar_wait(empty(s), phase ^ 1);
        const uint32_t sK = base + Smem::k(D, s), sV = base + Smem::v(D, s);
        sm90::mbar_expect_tx(k_full(s), kTileBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          sm90::tma_load_4d(sK + x * kBoxBytes, &tk, k_full(s), x * kBox, hh,
                            it * kBN, b);
        if constexpr (kTail != 0)
          sm90::tma_load_4d(sK + kTailOff, &tk32, k_full(s), kMain, hh,
                            it * kBN, b);
        sm90::mbar_expect_tx(v_full(s), kTileBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          sm90::tma_load_4d(sV + x * kBoxBytes, &tv, v_full(s), x * kBox, hh,
                            it * kBN, b);
        if constexpr (kTail != 0)
          sm90::tma_load_4d(sV + kTailOff, &tv32, v_full(s), kMain, hh,
                            it * kBN, b);
      }
    }
  } else {
    // ---------------- consumers: 64 q rows per warpgroup -----------------
    sm90::regs_claim<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // this thread's two rows of the 128-row tile, and its column pair
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
    const int c0 = 2 * (lane % 4);
    const int wg_first_row = q0 + wg * 64;

    // O's columns 0 .. kMain-1, and the 32-wide tail's (unused below 160)
    float o[kMain / 2];
    float ot[kTail ? kTail / 2 : 1];
#pragma unroll
    for (int i = 0; i < kMain / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kTail ? kTail / 2 : 1); ++i) ot[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float sacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.f;

    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const uint32_t sK = base + Smem::k(D, s), sV = base + Smem::v(D, s);

      // ---- S = Q K^T (f32) ----
      sm90::mbar_wait(k_full(s), phase);
      sm90::fence_regs(sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMain / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        const uint64_t da =
            sm90::desc_sw128(sQ + wg * 64 * 128 + off, 16, 1024);
        const uint64_t db = sm90::desc_sw128(sK + off, 16, 1024);
        sm90::wgmma_m64n128k16_ss(sacc, da, db, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kTail / 16; ++kk) {   // the 64-byte-swizzled box
        const uint32_t off = kTailOff + kk * 32;
        const uint64_t da = sm90::desc_sw64(sQ + wg * 64 * 64 + off, 16, 512);
        const uint64_t db = sm90::desc_sw64(sK + off, 16, 512);
        sm90::wgmma_m64n128k16_ss(sacc, da, db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);

      // ---- mask, scale, online softmax on the fragment ----
      const int k0 = it * kBN;
      const bool masked =
          k0 + kBN > sk || (causal && k0 + kBN - 1 > wg_first_row);
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kpos = k0 + 8 * j + c0 + (c & 1);
            const int qpos = c < 2 ? qpos0 : qpos1;
            const bool ok = kpos < sk && (!causal || kpos <= qpos);
            sacc[4 * j + c] = ok ? sacc[4 * j + c] * scale_log2 : kNegInf;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sacc[i] *= scale_log2;
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      uint32_t p[32];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        // i even: row 0's pair, i odd: row 1's (accumulator order)
        const float mn = (i & 1) ? mn1 : mn0;
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            exp2f(sacc[2 * i] - mn), exp2f(sacc[2 * i + 1] - mn));
        p[i] = *reinterpret_cast<const uint32_t*>(&pr);
        const float sum = __low2float(pr) + __high2float(pr);
        if (i & 1) ps1 += sum; else ps0 += sum;
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int i = 0; i < kMain / 2; ++i) o[i] *= (i & 2) ? corr1 : corr0;
#pragma unroll
      for (int i = 0; i < kTail / 2; ++i) ot[i] *= (i & 2) ? corr1 : corr0;

      // ---- O += P V ----
      sm90::mbar_wait(v_full(s), phase);
      sm90::fence_regs(o);
      sm90::fence_regs(ot);
      sm90::fence_regs(p);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        const uint64_t db = sm90::desc_sw128(sV + kk * 16 * 128, kBoxBytes,
                                             1024);
        if constexpr (kMain == 128)
          sm90::wgmma_m64n128k16_rs(o, a, db);
        else
          sm90::wgmma_m64n64k16_rs(o, a, db);
        if constexpr (kTail != 0)
          sm90::wgmma_m64n32k16_rs(
              ot, a, sm90::desc_sw64(sV + kTailOff + kk * 16 * 64, 512, 512));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(ot);
      if (t == 0) sm90::mbar_arrive(empty(s));
    }

    // ---- epilogue: o / max(l, 1e-30), rows past Sq dropped ----
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* op = out.o + b * out.sb + hh * out.sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + c0;
      const float* oj = j < kMain / 8 ? o + 4 * j : ot + 4 * (j - kMain / 8);
      if (qpos0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(op + qpos0 * out.ss + col) =
            __floats2bfloat162_rn(oj[0] * inv0, oj[1] * inv0);
      if (qpos1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(op + qpos1 * out.ss + col) =
            __floats2bfloat162_rn(oj[2] * inv1, oj[3] * inv1);
    }
  }
}

// ---- host side ---------------------------------------------------------------

// (B, S, H, D) bf16 seen as the 4-D map (D, H, S, B), boxes of 64 x 1 x 128
// x 1 with the 128-byte swizzle (``box`` 64), or of 32 x 1 x 128 x 1 with
// the 64-byte swizzle (``box`` 32); strides in elements, d contiguous.
CUresult make_map(CUtensorMap* map, const void* ptr, int64_t b, int64_t s,
                  int64_t h, int64_t d, int64_t sb, int64_t ss, int64_t sh,
                  int box_cols = kBox) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)kBN, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return sm90::encode_fn()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == kBox ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The kernel's registers at launch must be the 168 that setmaxnreg's 24 +
// 2 x 240 per thread-triple redistribute (384 x 168 of the SM's 65,536):
// with fewer, a consumer's claim would wait for registers that never free.
template <int D>
cudaError_t prepare() {
  static const cudaError_t ready = [] {
    const int bytes = Smem::bytes(D);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_fwd_tc<D>);
    if (err != cudaSuccess) return err;
    const int need = (kProducerRegs + 2 * kConsumerRegs) * 128;
    if (attr.numRegs * kThreads < need) return cudaErrorInvalidConfiguration;
    return cudaSuccess;
  }();
  return ready;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t sq, int64_t sk, int64_t h, const int64_t* st, int causal,
           float scale, cudaStream_t stream) {
  if (sm90::encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  const cudaError_t ready = prepare<D>();
  if (ready != cudaSuccess) return (int)ready;
  CUtensorMap mq, mk, mv;
  CUresult r = make_map(&mq, q, b, sq, h, D, st[0], st[1], st[2]);
  if (r == CUDA_SUCCESS) r = make_map(&mk, k, b, sk, h, D, st[3], st[4], st[5]);
  if (r == CUDA_SUCCESS) r = make_map(&mv, v, b, sk, h, D, st[6], st[7], st[8]);
  // the 32-wide tail's maps; below D = 160 the kernel never reads them
  CUtensorMap mq32 = mq, mk32 = mk, mv32 = mv;
  if (Cols<D>::kTail != 0) {
    if (r == CUDA_SUCCESS)
      r = make_map(&mq32, q, b, sq, h, D, st[0], st[1], st[2], kTailBox);
    if (r == CUDA_SUCCESS)
      r = make_map(&mk32, k, b, sk, h, D, st[3], st[4], st[5], kTailBox);
    if (r == CUDA_SUCCESS)
      r = make_map(&mv32, v, b, sk, h, D, st[6], st[7], st[8], kTailBox);
  }
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const OutArgs out{static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11]};
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + kBM - 1) / kBM));
  flash_fwd_tc<D><<<grid, kThreads, Smem::bytes(D), stream>>>(
      mq, mk, mv, mq32, mk32, mv32, out, (int)sq, (int)sk, (int)h, causal,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o; D in {64, 128, 160}. Strides are in elements, for the b, s and
// h dimensions of each tensor (d contiguous), and must be multiples of 8
// elements (16 bytes), as must the base pointers: the wrapper checks both.
// ``scale`` is D^-0.5 rounded to f32 by the caller.
extern "C" int repro_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int64_t b,
    int64_t sq, int64_t sk, int64_t h, int64_t d, int64_t causal,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
    int64_t oss, int64_t osh, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return (int)cudaSuccess;
  if (sk <= 0 || b * h > 2147483647LL || (sq + kBM - 1) / kBM > 65535 ||
      sq > 2147483647LL - kBM || sk > 2147483647LL - kBN)
    return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                          vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal ? 1 : 0;
  if (d == 160) return launch<160>(q, k, v, o, b, sq, sk, h, st, c, scale, s);
  if (d == 128) return launch<128>(q, k, v, o, b, sq, sk, h, st, c, scale, s);
  if (d == 64) return launch<64>(q, k, v, o, b, sq, sk, h, st, c, scale, s);
  return (int)cudaErrorInvalidValue;
}
