// flash_attention — forward online-softmax attention on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pallas_call body _flash_kernel): for q (B, Sq, H, D) and
// k, v (B, Sk, H, D) with KV already expanded to H heads,
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h],
//   s_ij = (q_i * D^-0.5) . k_j   (q scaled in f32 before the product),
// masked where kpos >= Sk and, when causal, where qpos < kpos (positions
// counted from 0 on both sides, as the reference does). Masked scores are
// -1e30, not -inf, so a fully masked tile averages and never makes NaN; the
// running max m, sum l and accumulator acc are f32, P stays f32 for the P.V
// product, and the output is acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it on this card: operations. At the main path's shape
// (B = 1, Sq = Sk = 2048, H = 40, D = 128, causal, bf16) the unmasked pairs
// need ~43 GFLOP (QK^T and P.V), 0.043 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 84 MB of q, k, v and o, 0.025 ms at 3.35 TB/s. This first
// kernel does its products with scalar f32 FMAs on the CUDA cores (67 TFLOP/s
// peak, so >= 0.64 ms at that shape) and does not reach the tensor cores:
// that is what wgmma (or mma.sync), TMA and warp specialisation are for, in a
// later change.
//
// Design. The TPU grid's sequential KV axis, with its VMEM scratch, becomes a
// loop over KV tiles inside one block. Each block owns one (batch*head,
// q-tile of 64 rows) pair; grid.x walks batch*head and grid.y the q tiles,
// issued last tile first, so that under a causal mask the longest rows start
// first. 128 threads: thread (ty = tid / 8, tx = tid % 8) owns rows
// ty*4 .. ty*4+3 of the tile. For S = Q K^T it holds the 4 x 4 scores of
// columns tx*4 .. tx*4+3, read as one float4 of Q^T and one of K^T per d from
// shared memory; each row's max and sum are reduced over the 8 lanes of its
// tx group with shuffles, so m and l are registers, as is the thread's
// 4 x D/8 slice of acc (columns tx + 8j). P goes through shared memory
// (transposed) to the P.V loop. K and V tiles of 32 rows are staged through
// shared memory as f32, read from (B, S, H, D) through strides (the head
// dimension must be contiguous): the reference's transpose to (B*H, S, D)
// is never made. Ragged Sq and Sk are masked, not padded; a causal block
// stops at the last KV tile that reaches its diagonal. Templated on D in
// {16, 32, 64, 128, 160} and on the element type (f32, bf16); at D = 160
// (stablelm-12b) a thread holds 4 x 20 accumulators and the block 93 KB of
// shared memory.
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 32;            // kv rows per tile
constexpr int kThreads = 128;
constexpr int kQLD = kBQ + 4;      // row pitch of Q^T (floats), float4-aligned
constexpr int kKLD = kBK + 4;      // row pitch of K^T
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return D * kQLD + D * kKLD + kBK * D + kBK * kBQ;
}

struct Strides {
  int64_t b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int64_t sq, int64_t sk,
          int64_t h, Strides qs, Strides ks, Strides vs, Strides os,
          int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kQLD], q pre-scaled
  float* Kt = Qt + D * kQLD;                     // [D][kKLD]
  float* Vs = Kt + D * kKLD;                     // [kBK][D]
  float* Pt = Vs + kBK * D;                      // [kBK][kBQ]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / h, hh = bh % h;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* qp = q + b * qs.b + hh * qs.h;
  const T* kp = k + b * ks.b + hh * ks.h;
  const T* vp = v + b * vs.b + hh * vs.h;
  T* op = o + b * os.b + hh * os.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int64_t row = q0 + r;
    Qt[c * kQLD + r] = row < sq ? to_f(qp[row * qs.s + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.f;
  }

  int64_t kend = sk;
  if (causal && q0 + kBQ < kend) kend = q0 + kBQ;   // tiles past the diagonal

  for (int64_t k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();          // the last tile's readers are done (and Q^T in)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int64_t row = k0 + r;
      const bool in = row < sk;
      Kt[c * kKLD + r] = in ? to_f(kp[row * ks.s + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vp[row * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kQLD + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * kKLD + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx * 4 + j;
        const bool ok = kpos < sk && (!causal || qpos >= kpos);
        if (!ok) s[i][j] = kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rsum += p[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kBQ + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[kk * kBQ + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float vv = Vs[kk * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      from_f(&op[row * os.s + tx + 8 * j], acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t b, int64_t sq, int64_t sk, int64_t h, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal,
                   float scale, cudaStream_t stream) {
  const int64_t q_tiles = (sq + kBQ - 1) / kBQ;
  if (b * h > 2147483647LL || q_tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats<D>();
  // above 48 KB a block's shared memory must be asked for (once per type)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((unsigned)(b * h), (unsigned)q_tiles);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, qs, ks, vs, os,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int64_t d, const void* q, const void* k, const void* v,
                   void* o, int64_t b, int64_t sq, int64_t sk, int64_t h,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, sk, h, qs, ks, vs, os, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, sk, h, qs, ks, vs, os, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, sk, h, qs, ks, vs, os, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, sk, h, qs, ks, vs, os, causal, scale, st);
    case 160: return launch<T, 160>(q, k, v, o, b, sq, sk, h, qs, ks, vs, os, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements, for the b, s and h dimensions of each tensor (the
// d dimension is contiguous). itemsize 4 = f32, 2 = bf16. ``scale`` is
// D^-0.5 rounded to f32 by the caller, as the reference rounds it.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t b,
    int64_t sq, int64_t sk, int64_t h, int64_t d, int64_t itemsize,
    int64_t causal, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t oss, int64_t osh, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return (int)cudaSuccess;
  if (sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const int c = causal ? 1 : 0;
  if (itemsize == 4)
    return (int)by_dim<float>(d, q, k, v, o, b, sq, sk, h, qs, ks, vs, os, c, scale, st);
  if (itemsize == 2)
    return (int)by_dim<__nv_bfloat16>(d, q, k, v, o, b, sq, sk, h, qs, ks, vs,
                                      os, c, scale, st);
  return (int)cudaErrorInvalidValue;
}
