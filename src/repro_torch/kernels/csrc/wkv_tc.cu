// wkv_tc — the RWKV6 chunked WKV recurrence on Hopper's tensor cores
// (sm_90a), for bf16 r, k, v with E = 64: mma.sync behind a TMA prefetch
// ring, warp-specialised.
//
// Replaces, for bf16 r/k/v with E = 64 and S > 1 (every full-width prefill),
// the TPU kernel src/repro/kernels/wkv.py::wkv (pallas_call body
// _wkv_kernel). For r, k, v, lw (B, S, H, E), bonus u (H, E) and an f32 state
// (B, H, E, E) [key x value], each (b, h) walks chunks of C = min(chunk, S)
// tokens in order, carrying the state from chunk to chunk. Inside a chunk:
//   cum = cumsum(lw), cin = cum - lw, tot = cum of the chunk's last token,
//   qf = r exp(clip(cin, -80, 0)),  kf = k exp(clip(-cum, 0, 80)),
//   kdec = k exp(clip(tot - cum, -80, 80)),
//   out = (strictly lower qf kf^T) v + (sum_e r u k) v + qf state,
//   state <- state exp(clip(tot, -80, 0)) + kdec^T v,
// the reference's clamps applied before each exp, the ragged last chunk as
// if padded with zero r, k, v and lw 0. out is written in bf16, the final
// state in f32. f32 inputs and E 16/32 take wkv.cu; a one-token call takes
// wkv_step.cu (kernels/ops.py::wkv_route).
//
// What bounds it on this card: bytes and the serial chain of chunks. At a
// 2,048-token rwkv6-7b prompt (B 1, H 64, chunk 32; f32 lw) the call moves
// ~103 MB (0.031 ms at 3.35 TB/s) for ~2.7 GFLOP of products (0.003 ms at the
// 989 TFLOP/s bf16 peak): once the products run on the tensor cores, what is
// left is moving the rows and walking 64 chunks one after another. The
// products are C x C x 64, C x 32 x C, C x 32 x 64 and 64 x 32 x C with
// C = 32: too small for wgmma's 64-row tiles, so each warp issues
// mma.sync.m16n8k16 (bf16 operands, f32 accumulation) on its own 16-row
// tiles.
//
// Design:
//  * Grid: one CTA per (b, h, half of the 64 value columns): 128 CTAs at one
//    prompt on 132 SMs, one wave. The halves share nothing but the intra-
//    chunk factors, which each recomputes (cheap on the tensor cores).
//  * 416 threads in four roles, a pipeline over chunks (each role one
//    chunk ahead of the next):
//    - a producer warp, of which one thread keeps up to 3 chunks ahead (2 at
//      C > 32, where three stages would not fit beside the slots) in a ring
//      of shared-memory stages: per chunk four TMA boxes of C rows over 4-D
//      tensor maps (E, H, S, B) built on the host from the caller's strides:
//      r, k, lw (all 64 key columns) and v (the CTA's 32 columns),
//      completing on the stage's mbarrier. TMA fills rows past S with zeros,
//      and the rows of a stage past C (the chunk padded to 16) are zeroed
//      once, so a ragged chunk needs no masking. Per-row bulk copies
//      (cp.async.bulk, no tensor map: 4 x C small copies a chunk) were
//      tried first and could not keep up with the compute; four boxes a
//      chunk can, near the memory rate. The wrapper checks the 16-byte
//      alignment TMA needs and raises where it does not hold;
//    - the factor warpgroup (warps 0-3): the cumsum of lw (each thread sums
//      its own C/4 tokens for two columns, one shared-memory pass adds the
//      earlier warps' sums), the three factors as bf16 hi/lo operand tiles,
//      the decay of the state, and the bonus diagonal (warp-shuffle sums);
//    - the product warpgroup (warps 4-7): A = strictly-lower(qf kf^T) and
//      out_intra = A v + diag v on the tensor cores, one 16-row tile of A
//      per warp (recomputed by the warps that share it, each doing a part
//      of A v's columns). A goes from the f32 accumulator to the A operand
//      of A v in registers (the accumulator pairs of two 8-column tiles are
//      the operand of one 16-deep step);
//    - the state warpgroup (warps 8-11) holds the CTA's 64 x 32 f32 state as
//      mma accumulators (warp w: key rows 16w..16w+15). Per chunk it writes
//      the state to shared memory as the B operand, computes out = out_intra
//      + qf S and stores it, then S <- S exp(clip(tot, -80, 0)) (row scale)
//      + kdec^T v, accumulated in f32.
//    Each chunk's factors, out_intra and decay live in one of 3 slots (2 at
//    C > 48). Handshakes are mbarriers: full/empty per stage; factored,
//    intra and freed per slot; a wait that never completes traps
//    (sm90::mbar_wait). With the factors and the products in one warpgroup
//    that warpgroup alone set the kernel's time: one warp per SM
//    sub-partition leaves each phase's latency exposed, and the split puts
//    the two phases side by side. The factor warpgroup is now the longest
//    stage (its exps and hi/lo splits, latency-bound).
//  * Templated on the padded chunk (16, 32, 48, 64), so every loop over a
//    chunk's tokens and tiles unrolls: a warpgroup has one warp per SM
//    sub-partition, and only independent work in flight hides latency.
//  * Precision. bf16 operands alone leave the output near or past the 5e-2
//    bar where the decay is slow and the state large (|lw| ~ e^-5 over a
//    2,048-token prompt), as a plain emulation of the arithmetic shows. So
//    every f32 operand is split into a bf16 hi and lo part
//    (lo = bf16(x - hi)) and each product takes the three (or, with v exact
//    in bf16, two) mma of hi hi + lo hi + hi lo, the lo terms in their own
//    accumulators: ~2^-16 relative, which leaves the output's own bf16
//    rounding as the error (tests/test_torch_wkv_tc.py emulates it).
//  * Factors use __expf (ex2.approx; their bf16 split carries ~2^-16 of
//    the exact value); the state's decay exp(clip(tot)) uses expf.
//  * Resources (-Xptxas -v): 80-126 registers over the eight
//    instantiations (padded chunk 16..64 x f32/bf16 lw), no spills; dynamic
//    shared memory 168,568 B at the prefill's chunk 32 with f32 lw (three
//    stages, three slots), 219,216 B at chunk 64; one CTA per SM.
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

using bf16 = __nv_bfloat16;

constexpr int kE = 64;           // key columns (head size)
constexpr int kNV = 32;          // value columns per CTA
constexpr int kThreads = 416;    // three warpgroups and a producer warp
constexpr int kMaxChunk = 64;
constexpr float kClamp = 80.0f;
// row pitches in shared memory, in bytes: the TMA stages are dense (r, k:
// 128; v: 64; lw: 64 x its size), the operand tiles padded for ldmatrix
constexpr int kPK = 144;         // 64 bf16 (+ 8): qf, kf, kdec
constexpr int kPS = 80;          // 32 bf16 (+ 8): the state's B operand
constexpr int kPO = 160;         // 32 f32 (+ 8): out_intra

// byte offsets of everything in shared memory, from a 1,024-byte aligned
// base, for the padded chunk CP and lw of LSZ bytes: NS ring stages of the
// chunk's rows, NSLOT slots of what one chunk hands from warpgroup to
// warpgroup, as many as fit in the 227 KB a block may use
template <int CP, int LSZ>
struct Layout {
  static constexpr int NS = CP <= 32 ? 3 : 2;
  static constexpr int NSLOT = CP <= 48 ? 3 : 2;
  static constexpr int r = 0, k = CP * 128, l = 2 * CP * 128,
                       v = l + CP * 64 * LSZ, stage = v + CP * 64;
  static constexpr int slot0 = NS * stage;
  static constexpr int qfh = 0, qfl = CP * kPK, kfh = 2 * CP * kPK,
                       kfl = 3 * CP * kPK, kdh = 4 * CP * kPK,
                       kdl = 5 * CP * kPK, oi = 6 * CP * kPK,
                       dec = oi + CP * kPO, diag = dec + kE * 4,
                       slot = diag + kMaxChunk * 4;
  static constexpr int wsum = slot0 + NSLOT * slot,
                       sbh = wsum + 2 * 4 * kE * 4, sbl = sbh + kE * kPS,
                       bars = sbl + kE * kPS;
  static constexpr int total = bars + 8 * (2 * NS + 3 * NSLOT) + 1024;
};

struct OutArgs {
  bf16* o;
  int64_t sb, ss, sh;    // strides of out in elements (e contiguous)
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}
// hi = bf16(x), lo = bf16(x - hi), for a pair
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - __low2float(h), b - __high2float(h));
}
__device__ __forceinline__ void st_split(uint8_t* smem, int hi_off,
                                         int lo_off, int byte, float a,
                                         float b) {
  uint32_t h, l;
  split2(a, b, h, l);
  *reinterpret_cast<uint32_t*>(smem + hi_off + byte) = h;
  *reinterpret_cast<uint32_t*>(smem + lo_off + byte) = l;
}

// address a lane gives ldmatrix for the A fragment of the 16 x 16 tile at
// (row m0, col k0) of a row-major tile of ``pitch`` bytes (ldsm_x4)
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int pitch, int m0,
                                           int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  return base + (m0 + r + 8 * (i & 1)) * pitch + (k0 + 8 * (i >> 1)) * 2;
}
// the same for A = Y^T, Y row-major (rows k, cols m), with ldsm_x4_t
__device__ __forceinline__ uint32_t at_addr(uint32_t base, int pitch, int m0,
                                            int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  return base + (k0 + r + 8 * (i >> 1)) * pitch + (m0 + 8 * (i & 1)) * 2;
}
// B fragments of two 8-column tiles (n0, n0 + 8) at depth k0 from Z = B^T
// row-major (rows n, cols k), with ldsm_x4: {d0, d1} and {d2, d3}
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int pitch, int n0,
                                            int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  return base + (n0 + r + 8 * (i >> 1)) * pitch + (k0 + 8 * (i & 1)) * 2;
}
// B fragments from B row-major (rows k, cols n) with ldsm_x4_t (two tiles,
// as above) or ldsm_x2_t (lanes 0-15: the tile at n0)
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int pitch, int n0,
                                           int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  return base + (k0 + r + 8 * (i & 1)) * pitch + (n0 + 8 * (i >> 1)) * 2;
}

template <typename TL, int CP>
__global__ void __launch_bounds__(kThreads, 1)
wkv_tc(const __grid_constant__ CUtensorMap tr,
       const __grid_constant__ CUtensorMap tk,
       const __grid_constant__ CUtensorMap tl,
       const __grid_constant__ CUtensorMap tv,
       const float* __restrict__ bonus, const float* __restrict__ s0,
       float* __restrict__ s_out, OutArgs out, int seq, int h, int c) {
  using L = Layout<CP, (int)sizeof(TL)>;
  constexpr int NS = L::NS, NSLOT = L::NSLOT;
  constexpr int LP = kE * (int)sizeof(TL);   // lw row pitch
  constexpr int MT = CP / 16;                // 16-row tiles of a chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t bar = base + L::bars;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (NS + s); };
  auto factored = [&](int j) { return bar + 8u * (2 * NS + j); };
  auto intra = [&](int j) { return bar + 8u * (2 * NS + NSLOT + j); };
  auto freed = [&](int j) { return bar + 8u * (2 * NS + 2 * NSLOT + j); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int v0 = blockIdx.y * kNV;
  const int n_chunks = (seq + c - 1) / c;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 128);
    }
    for (int j = 0; j < NSLOT; ++j) {
      sm90::mbar_init(factored(j), 128);
      sm90::mbar_init(intra(j), 128);
      sm90::mbar_init(freed(j), 128);
    }
    sm90::mbar_fence_init();
  }
  // rows C..CP-1 of a stage are never copied: zero the ring once
  for (int i = tid; i < NS * L::stage / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  sm90::fence_proxy_async();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  if (warp == 12) {
    // ---------------- producer: four TMA boxes per chunk -------------------
    if (lane == 0) {
      sm90::tma_prefetch_desc(&tr);
      sm90::tma_prefetch_desc(&tk);
      sm90::tma_prefetch_desc(&tl);
      sm90::tma_prefetch_desc(&tv);
      const uint32_t bytes = c * (2 * 128 + LP + kNV * 2);
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % NS;
        sm90::mbar_wait(empty(s), ((i / NS) & 1) ^ 1);
        const uint32_t st = base + s * L::stage;
        sm90::mbar_expect_tx(full(s), bytes);
        sm90::tma_load_4d(st + L::r, &tr, full(s), 0, hi, i * c, bi);
        sm90::tma_load_4d(st + L::k, &tk, full(s), 0, hi, i * c, bi);
        sm90::tma_load_4d(st + L::l, &tl, full(s), 0, hi, i * c, bi);
        sm90::tma_load_4d(st + L::v, &tv, full(s), v0, hi, i * c, bi);
      }
    }
  } else if (warp < 4) {
    // ---------------- factors: cumsum, qf, kf, kdec, the bonus diagonal --
    constexpr int TPW = CP / 4;              // tokens per warp in the scan
    const int e0 = 2 * lane;                 // this thread's two key columns
    const float u0 = bonus[hi * kE + e0], u1 = bonus[hi * kE + e0 + 1];
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % NS, j = i % NSLOT;
      const uint8_t* st = smem + s * L::stage;
      const int sl = L::slot0 + j * L::slot;
      float* wsum = reinterpret_cast<float*>(smem + L::wsum) + (i & 1) * 4 * kE;
      sm90::mbar_wait(full(s), (i / NS) & 1);

      // cumsum, pass 1: this warp's sum of lw over its tokens
      float2 lwv[TPW];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int x = 0; x < TPW; ++x) {
        lwv[x] = load2(reinterpret_cast<const TL*>(
                           st + L::l + (warp * TPW + x) * LP) + e0);
        a0 += lwv[x].x;
        a1 += lwv[x].y;
      }
      *reinterpret_cast<float2*>(wsum + warp * kE + e0) = make_float2(a0, a1);
      sm90::named_barrier(1, 128);      // wsum alternates, so one suffices
      float c0 = 0.f, c1 = 0.f, tot0 = 0.f, tot1 = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 x = *reinterpret_cast<const float2*>(wsum + w * kE + e0);
        if (w < warp) {
          c0 += x.x;
          c1 += x.y;
        }
        tot0 += x.x;
        tot1 += x.y;
      }
      // the slot is free once the state warpgroup is done with its chunk
      sm90::mbar_wait(freed(j), ((i / NSLOT) & 1) ^ 1);
      if (warp == 0) {
        float* dec = reinterpret_cast<float*>(smem + sl + L::dec);
        dec[e0] = expf(clip(tot0, -kClamp, 0.f));
        dec[e0 + 1] = expf(clip(tot1, -kClamp, 0.f));
      }
      // pass 2: the running cumsum, the factors, the bonus diagonal
      float p[TPW];
#pragma unroll
      for (int x = 0; x < TPW; ++x) {
        const int t = warp * TPW + x;
        const float2 r2 = load2(reinterpret_cast<const bf16*>(
                                    st + L::r + t * 128) + e0);
        const float2 k2 = load2(reinterpret_cast<const bf16*>(
                                    st + L::k + t * 128) + e0);
        c0 += lwv[x].x;
        c1 += lwv[x].y;
        const float qf0 = r2.x * __expf(clip(c0 - lwv[x].x, -kClamp, 0.f));
        const float qf1 = r2.y * __expf(clip(c1 - lwv[x].y, -kClamp, 0.f));
        const float kf0 = k2.x * __expf(clip(-c0, 0.f, kClamp));
        const float kf1 = k2.y * __expf(clip(-c1, 0.f, kClamp));
        const float kd0 = k2.x * __expf(clip(tot0 - c0, -kClamp, kClamp));
        const float kd1 = k2.y * __expf(clip(tot1 - c1, -kClamp, kClamp));
        const int byte = t * kPK + e0 * 2;
        st_split(smem, sl + L::qfh, sl + L::qfl, byte, qf0, qf1);
        st_split(smem, sl + L::kfh, sl + L::kfl, byte, kf0, kf1);
        st_split(smem, sl + L::kdh, sl + L::kdl, byte, kd0, kd1);
        p[x] = r2.x * u0 * k2.x + r2.y * u1 * k2.y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int x = 0; x < TPW; ++x)
          p[x] += __shfl_xor_sync(0xffffffffu, p[x], off);
      if (lane == 0) {
        float* diag = reinterpret_cast<float*>(smem + sl + L::diag);
#pragma unroll
        for (int x = 0; x < TPW; ++x) diag[warp * TPW + x] = p[x];
      }
      sm90::mbar_arrive(factored(j));
    }
  } else if (warp < 8) {
    // ---------------- A = strictly lower qf kf^T; out_intra = A v + diag v
    // work units: (row tile, group of 8-column value tiles)
    constexpr int NSPLIT = MT == 1 ? 4 : (MT == 2 ? 2 : 1);
    constexpr int NTPER = 4 / NSPLIT;
    const int aw = warp - 4;
    const int mt = aw / NSPLIT, nt0 = (aw % NSPLIT) * NTPER;
    const int row0 = 16 * mt + g, row1 = row0 + 8;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % NS, j = i % NSLOT;
      const uint8_t* st = smem + s * L::stage;
      const uint32_t st_u = base + s * L::stage;
      const int sl = L::slot0 + j * L::slot;
      sm90::mbar_wait(factored(j), (i / NSLOT) & 1);
      sm90::mbar_wait(full(s), (i / NS) & 1);
      if (aw < MT * NSPLIT) {
        float acc[8][4], cor[8][4];
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = cor[x][y] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t ah[4], al[4];
          sm90::ldsm_x4(ah, a_addr(base + sl + L::qfh, kPK, 16 * mt, 16 * kk,
                                   lane));
          sm90::ldsm_x4(al, a_addr(base + sl + L::qfl, kPK, 16 * mt, 16 * kk,
                                   lane));
#pragma unroll
          for (int np = 0; np < MT; ++np) {
            if (np > mt) break;
            uint32_t bh[4], bl[4];
            sm90::ldsm_x4(bh, bt_addr(base + sl + L::kfh, kPK, 16 * np,
                                      16 * kk, lane));
            sm90::ldsm_x4(bl, bt_addr(base + sl + L::kfl, kPK, 16 * np,
                                      16 * kk, lane));
            sm90::mma_bf16(acc[2 * np], ah, bh[0], bh[1]);
            sm90::mma_bf16(cor[2 * np], al, bh[0], bh[1]);
            sm90::mma_bf16(cor[2 * np], ah, bl[0], bl[1]);
            sm90::mma_bf16(acc[2 * np + 1], ah, bh[2], bh[3]);
            sm90::mma_bf16(cor[2 * np + 1], al, bh[2], bh[3]);
            sm90::mma_bf16(cor[2 * np + 1], ah, bl[2], bl[3]);
          }
        }
        // mask to the strictly lower part, split into A operands
        uint32_t Ah[MT][4], Al[MT][4];
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int jn = 2 * kk + half;
            const int col = 8 * jn + 2 * q;
            const float x0 = col < row0 ? acc[jn][0] + cor[jn][0] : 0.f;
            const float x1 = col + 1 < row0 ? acc[jn][1] + cor[jn][1] : 0.f;
            const float x2 = col < row1 ? acc[jn][2] + cor[jn][2] : 0.f;
            const float x3 = col + 1 < row1 ? acc[jn][3] + cor[jn][3] : 0.f;
            split2(x0, x1, Ah[kk][2 * half], Al[kk][2 * half]);
            split2(x2, x3, Ah[kk][2 * half + 1], Al[kk][2 * half + 1]);
          }
        }
        float* oi = reinterpret_cast<float*>(smem + sl + L::oi);
        const float* diag = reinterpret_cast<const float*>(smem + sl + L::diag);
        const float d0 = diag[row0], d1 = diag[row1];
#pragma unroll
        for (int x = 0; x < NTPER; ++x) {
          const int nt = nt0 + x;
          float o[4] = {0.f, 0.f, 0.f, 0.f}, oc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < MT; ++kk) {
            if (kk > mt) break;
            uint32_t b[2];
            sm90::ldsm_x2_t(b, b_addr(st_u + L::v, 64, 8 * nt, 16 * kk, lane));
            sm90::mma_bf16(o, Ah[kk], b[0], b[1]);
            sm90::mma_bf16(oc, Al[kk], b[0], b[1]);
          }
          const int col = 8 * nt + 2 * q;
          const float2 va = load2(
              reinterpret_cast<const bf16*>(st + L::v + row0 * 64) + col);
          const float2 vb = load2(
              reinterpret_cast<const bf16*>(st + L::v + row1 * 64) + col);
          *reinterpret_cast<float2*>(oi + row0 * (kPO / 4) + col) =
              make_float2(o[0] + oc[0] + d0 * va.x, o[1] + oc[1] + d0 * va.y);
          *reinterpret_cast<float2*>(oi + row1 * (kPO / 4) + col) =
              make_float2(o[2] + oc[2] + d1 * vb.x, o[3] + oc[3] + d1 * vb.y);
        }
      }
      sm90::mbar_arrive(intra(j));
    }
  } else {
    // ---------------- state warpgroup -------------------------------------
    const int w = warp - 8;
    const int e_a = 16 * w + g, e_b = e_a + 8;   // this thread's key rows
    const float* s_in = s0 + (int64_t)bh * kE * kE + v0;
    float S[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = 8 * x + 2 * q;
      const float2 a = load2(s_in + e_a * kE + col);
      const float2 b = load2(s_in + e_b * kE + col);
      S[x][0] = a.x;
      S[x][1] = a.y;
      S[x][2] = b.x;
      S[x][3] = b.y;
    }
    bf16* ob = out.o + bi * out.sb + hi * out.sh + v0;
    const int col = 8 * w + 2 * q;     // this warp's value columns of out
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % NS, j = i % NSLOT;
      const int t0 = i * c;
      const int n = seq - t0 < c ? seq - t0 : c;
      const uint32_t st_u = base + s * L::stage;
      const int sl = L::slot0 + j * L::slot;

      // the state before this chunk as the B operand (hi and lo)
      sm90::named_barrier(2, 128);      // the last chunk's reads are done
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int cx = 8 * x + 2 * q;
        st_split(smem, L::sbh, L::sbl, e_a * kPS + cx * 2, S[x][0], S[x][1]);
        st_split(smem, L::sbh, L::sbl, e_b * kPS + cx * 2, S[x][2], S[x][3]);
      }
      sm90::named_barrier(2, 128);
      sm90::mbar_wait(intra(j), (i / NSLOT) & 1);
      sm90::mbar_wait(full(s), (i / NS) & 1);
      // out = out_intra + qf S: this warp's 8 value columns, every row tile
      float o[MT][4], oc[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int y = 0; y < 4; ++y) o[mt][y] = oc[mt][y] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bh[2], bl[2];
        sm90::ldsm_x2_t(bh, b_addr(base + L::sbh, kPS, 8 * w, 16 * kk, lane));
        sm90::ldsm_x2_t(bl, b_addr(base + L::sbl, kPS, 8 * w, 16 * kk, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t ah[4], al[4];
          sm90::ldsm_x4(ah, a_addr(base + sl + L::qfh, kPK, 16 * mt, 16 * kk,
                                   lane));
          sm90::ldsm_x4(al, a_addr(base + sl + L::qfl, kPK, 16 * mt, 16 * kk,
                                   lane));
          sm90::mma_bf16(o[mt], ah, bh[0], bh[1]);
          sm90::mma_bf16(oc[mt], al, bh[0], bh[1]);
          sm90::mma_bf16(oc[mt], ah, bl[0], bl[1]);
        }
      }
      const float* oi = reinterpret_cast<const float*>(smem + sl + L::oi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ta = 16 * mt + g, tb = ta + 8;
        const float2 ia = load2(oi + ta * (kPO / 4) + col);
        const float2 ib = load2(oi + tb * (kPO / 4) + col);
        if (ta < n)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + (int64_t)(t0 + ta) * out.ss + col) =
              __floats2bfloat162_rn(o[mt][0] + oc[mt][0] + ia.x,
                                    o[mt][1] + oc[mt][1] + ia.y);
        if (tb < n)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + (int64_t)(t0 + tb) * out.ss + col) =
              __floats2bfloat162_rn(o[mt][2] + oc[mt][2] + ib.x,
                                    o[mt][3] + oc[mt][3] + ib.y);
      }

      // S <- S exp(clip(tot, -80, 0)) + kdec^T v
      const float* dec = reinterpret_cast<const float*>(smem + sl + L::dec);
      const float da = dec[e_a], db = dec[e_b];
      float cS[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        S[x][0] *= da;
        S[x][1] *= da;
        S[x][2] *= db;
        S[x][3] *= db;
#pragma unroll
        for (int y = 0; y < 4; ++y) cS[x][y] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t ah[4], al[4];
        sm90::ldsm_x4_t(ah, at_addr(base + sl + L::kdh, kPK, 16 * w, 16 * kk,
                                    lane));
        sm90::ldsm_x4_t(al, at_addr(base + sl + L::kdl, kPK, 16 * w, 16 * kk,
                                    lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          sm90::ldsm_x4_t(b, b_addr(st_u + L::v, 64, 16 * jp, 16 * kk, lane));
          sm90::mma_bf16(S[2 * jp], ah, b[0], b[1]);
          sm90::mma_bf16(cS[2 * jp], al, b[0], b[1]);
          sm90::mma_bf16(S[2 * jp + 1], ah, b[2], b[3]);
          sm90::mma_bf16(cS[2 * jp + 1], al, b[2], b[3]);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) S[x][y] += cS[x][y];
      sm90::mbar_arrive(freed(j));
      sm90::mbar_arrive(empty(s));
    }
    float* so = s_out + (int64_t)bh * kE * kE + v0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int cx = 8 * x + 2 * q;
      *reinterpret_cast<float2*>(so + e_a * kE + cx) =
          make_float2(S[x][0], S[x][1]);
      *reinterpret_cast<float2*>(so + e_b * kE + cx) =
          make_float2(S[x][2], S[x][3]);
    }
  }
}

// ---- host side ---------------------------------------------------------------

// (B, S, H, E) seen as the 4-D map (E, H, S, B), boxes of box_e x 1 x c x 1,
// no swizzle; strides in elements (e contiguous); rows past S read as zeros
CUresult make_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
                  const void* ptr, int64_t b, int64_t s, int64_t h,
                  const int64_t* st, int box_e, int c) {
  const cuuint64_t dims[4] = {(cuuint64_t)kE, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(st[2] * esize),
                                 (cuuint64_t)(st[1] * esize),
                                 (cuuint64_t)(st[0] * esize)};
  const cuuint32_t box[4] = {(cuuint32_t)box_e, 1, (cuuint32_t)c, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return sm90::encode_fn()(
      map, type, 4, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename TL, int CP>
cudaError_t run(const CUtensorMap* maps, const float* u, const float* s0,
                float* sT, OutArgs out, int64_t b, int64_t s, int64_t h,
                int c, cudaStream_t stream) {
  constexpr int bytes = Layout<CP, (int)sizeof(TL)>::total;
  // above 48 KB a block's shared memory must be asked for (once per
  // instantiation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_tc<TL, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)(b * h), kE / kNV);
  wkv_tc<TL, CP><<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], u, s0, sT, out, (int)s, (int)h, c);
  return cudaGetLastError();
}

template <typename TL>
cudaError_t by_chunk(const CUtensorMap* maps, const float* u,
                     const float* s0, float* sT, OutArgs out, int64_t b,
                     int64_t s, int64_t h, int c, cudaStream_t st) {
  switch ((c + 15) / 16) {
    case 1: return run<TL, 16>(maps, u, s0, sT, out, b, s, h, c, st);
    case 2: return run<TL, 32>(maps, u, s0, sT, out, b, s, h, c, st);
    case 3: return run<TL, 48>(maps, u, s0, sT, out, b, s, h, c, st);
    case 4: return run<TL, 64>(maps, u, s0, sT, out, b, s, h, c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 r, k, v (and out), lw f32 (lw_itemsize 4) or bf16 (2); E = 64; bonus
// (H, E) and both states (B, H, E, E) contiguous f32. Strides are in
// elements, for the b, s and h dimensions of r, k, v, lw and out (e
// contiguous); those of r, k, v and lw, and their base pointers, must be
// multiples of 16 bytes (a dimension of size 1 given the packed stride: the
// wrapper does both). 1 <= chunk <= 64.
extern "C" int repro_wkv_tc(
    const void* r, const void* k, const void* v, const void* lw,
    const void* bonus, const void* s0, void* out, void* s_out, int64_t b,
    int64_t s, int64_t h, int64_t e, int64_t chunk, int64_t lw_itemsize,
    int64_t rsb, int64_t rss, int64_t rsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t lsb,
    int64_t lss, int64_t lsh, int64_t osb, int64_t oss, int64_t osh,
    void* stream) {
  if (b <= 0 || h <= 0) return (int)cudaSuccess;
  if (e != kE || s <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      b * h > 2147483647LL || s > 2147483647LL - kMaxChunk ||
      (lw_itemsize != 2 && lw_itemsize != 4))
    return (int)cudaErrorInvalidValue;
  if (sm90::encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  const int c = (int)(chunk < s ? chunk : s);
  const int64_t rst[3] = {rsb, rss, rsh}, kst[3] = {ksb, kss, ksh},
                vst[3] = {vsb, vss, vsh}, lst[3] = {lsb, lss, lsh};
  const CUtensorMapDataType lt = lw_itemsize == 4
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[4];
  CUresult res = make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, r,
                          b, s, h, rst, kE, c);
  if (res == CUDA_SUCCESS)
    res = make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, b, s, h,
                   kst, kE, c);
  if (res == CUDA_SUCCESS)
    res = make_map(&maps[2], lt, (int)lw_itemsize, lw, b, s, h, lst, kE, c);
  if (res == CUDA_SUCCESS)
    res = make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, b, s, h,
                   vst, kNV, c);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  const OutArgs o{static_cast<bf16*>(out), osb, oss, osh};
  const float* u = static_cast<const float*>(bonus);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lw_itemsize == 4)
    return (int)by_chunk<float>(maps, u, s0f, sTf, o, b, s, h, c, st);
  return (int)by_chunk<bf16>(maps, u, s0f, sTf, o, b, s, h, c, st);
}
