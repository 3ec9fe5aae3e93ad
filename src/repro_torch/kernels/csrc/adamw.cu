// adamw — the AdamW update of one leaf in one pass, and the clip's partial
// ||g||^2 of one leaf, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's update (src/repro/optim/
// optimizer.py::adamw) is an elementwise chain that XLA fuses on its own.
// PyTorch runs the same chain eagerly, one kernel per operation with a
// temporary each (optim/optimizer.py before this kernel: ~15 passes a leaf
// and the clip's scaled copy of every gradient), so the update moved about
// 188 bytes a parameter and held four f32 temporaries of its largest leaf.
//
// What bounds it on this card: bytes. Per parameter the update reads p, g
// (bf16 on the main paths), m and v (f32) and writes p, m and v:
//   2 + 2 + 4 + 4 + 2 + 4 + 4 = 22 B  (f32 p or g: 2 B more each way)
// and the norm reads g once: 2 B. Over 3.35e12 B/s that is 5.4 ms for
// parallax-lm's 820M parameters and 20 ms for phi3-medium-14b at 8 layers.
//
// adamw_step repeats the eager chain (kernels/ref.py::adamw_update_ref on
// a CUDA tensor) element for element, each operation rounded as PyTorch's
// CUDA kernel rounds it, and nothing contracted into an FMA:
//   x = f32(g)                          rounded to bf16 when the chain holds
//                                       the gradient in bf16 (the fused
//                                       path's wire -> parameter cast)
//   x = f32(round(x * scale))           with clipping (_clipped), scale read
//                                       from the device: no host sync
//   m = m*b1 + x*(1-b1)
//   v = v*b2 + (x*x)*(1-b2)
//   u = (m * (1/bc1)) / (sqrt(v * (1/bc2)) + eps)
//                                       PyTorch divides by a Python scalar
//                                       as a product with its f32 reciprocal
//   u = u + wd*p                        when the optimizer decays at all
//   p = round(p - lr*u)                 round to nearest even into p's dtype
// so on the card its p, m and v equal the eager chain's bit for bit. The
// scalars arrive as f32, each as PyTorch casts a Python float.
//
// Design: a streaming pass. Each thread takes one run of 8 elements (one
// 16-byte vector of bf16, two of f32), so the grid is n / 2,048 blocks and
// the block scheduler balances the SMs (a grid-stride loop over 8 blocks an
// SM reached 85 % of the bound at the cells' leaves, this 91 %; streaming
// cache hints and a register cap for more blocks an SM were slower). Each
// array is loaded and stored with 16-byte vectors when its base is 16-byte
// aligned, else element by element: a bucket segment (update_fused) starts
// at any offset of its flat buffers while the parameter is a leaf of its
// own, so the choice is made per array from the pointers alone. The last
// run of a ragged n is bounded element by element. Dtype pairs (p, g) in
// {bf16, f32}^2 by template.
//
// grad_sq_norm_partial / grad_sq_norm_final: sum(x * x) in f32 over g in
// its own dtype, with no f32 copy of g. Deterministic: thread t of block b
// owns the runs r = b*256 + t (mod the grid's threads) and keeps one
// accumulator per element of a run; a fixed tree combines them, then the
// block (warp butterflies, then the warps in order), then a second launch
// sums the block partials in index order. The grid depends on n alone and
// the loads only fetch, so a leaf and a misaligned view of the same values
// give the same bits, run after run. No float atomics.
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing (the norm's partials are the caller's
// buffer of kNormBlocks floats), returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 8;            // elements a thread takes at a time
constexpr int kThreads = 256;
constexpr int kNormBlocks = 1056;  // 132 SMs x 8: one wave; ops.py's too

// bf16 is carried as its bits (uint16_t), as in the other kernels
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_bf16(float x) {
  return widen(bf16_bits(x));
}
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, uint16_t* out) {
  *out = bf16_bits(x);
}

// one run of 8 elements at ptr (in bounds), 16-byte vectors when `vec`
__device__ __forceinline__ void load_run(const float* __restrict__ ptr,
                                         bool vec, float (&x)[kRun]) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(ptr)[0];
    const float4 b = reinterpret_cast<const float4*>(ptr)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) x[k] = ptr[k];
  }
}

__device__ __forceinline__ void load_run(const uint16_t* __restrict__ ptr,
                                         bool vec, float (&x)[kRun]) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(ptr);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) x[k] = widen(ptr[k]);
  }
}

__device__ __forceinline__ void store_run(float* __restrict__ ptr, bool vec,
                                          const float (&x)[kRun]) {
  if (vec) {
    reinterpret_cast<float4*>(ptr)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(ptr)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) ptr[k] = x[k];
  }
}

__device__ __forceinline__ void store_run(uint16_t* __restrict__ ptr,
                                          bool vec, const float (&x)[kRun]) {
  if (vec) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<uint32_t>(bf16_bits(x[2 * k])) |
             (static_cast<uint32_t>(bf16_bits(x[2 * k + 1])) << 16);
    *reinterpret_cast<uint4*>(ptr) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) narrow(x[k], ptr + k);
  }
}

// the last, ragged run: `cnt` < 8 elements
template <typename T>
__device__ __forceinline__ void load_tail(const T* __restrict__ ptr, int cnt,
                                          float (&x)[kRun]) {
#pragma unroll
  for (int k = 0; k < kRun; ++k) x[k] = k < cnt ? widen(ptr[k]) : 0.0f;
}

template <typename T>
__device__ __forceinline__ void store_tail(T* __restrict__ ptr, int cnt,
                                           const float (&x)[kRun]) {
#pragma unroll
  for (int k = 0; k < kRun; ++k)
    if (k < cnt) narrow(x[k], ptr + k);
}

struct Hyper {
  float b1, c1, b2, c2;   // b1, f32(1 - b1), b2, f32(1 - b2)
  float inv1, inv2;       // f32 reciprocals of the bias corrections
  float eps, lr, wd;
  int round_bf16;         // the chain holds the gradient in bf16
  int decay;              // the chain adds wd * p
};

// the eager chain on one run, in place on p, m, v (module comment)
__device__ __forceinline__ void adamw_run(float (&p)[kRun],
                                          const float (&g)[kRun],
                                          float (&m)[kRun], float (&v)[kRun],
                                          const Hyper& h, bool clip,
                                          float s) {
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    float x = g[k];
    if (h.round_bf16) x = round_bf16(x);
    if (clip) {
      x = __fmul_rn(x, s);
      if (h.round_bf16) x = round_bf16(x);
    }
    const float mk = __fadd_rn(__fmul_rn(m[k], h.b1), __fmul_rn(x, h.c1));
    const float vk = __fadd_rn(__fmul_rn(v[k], h.b2),
                               __fmul_rn(__fmul_rn(x, x), h.c2));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(vk, h.inv2)), h.eps);
    float u = __fdiv_rn(__fmul_rn(mk, h.inv1), den);
    if (h.decay) u = __fadd_rn(u, __fmul_rn(h.wd, p[k]));
    p[k] = __fsub_rn(p[k], __fmul_rn(h.lr, u));
    m[k] = mk;
    v[k] = vk;
  }
}

// vec: bit 0 p, bit 1 g, bit 2 m, bit 3 v 16-byte aligned
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_step(P* __restrict__ p, const G* __restrict__ g,
               float* __restrict__ m, float* __restrict__ v,
               const float* __restrict__ scale, int64_t n, Hyper h,
               unsigned vec) {
  const bool clip = scale != nullptr;
  const float s = clip ? *scale : 1.0f;
  const bool vp = vec & 1u, vg = vec & 2u, vm = vec & 4u, vv = vec & 8u;
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kRun;
  if (i >= n) return;
  float pr[kRun], gr[kRun], mr[kRun], vr[kRun];
  if (i + kRun <= n) {
    load_run(p + i, vp, pr);
    load_run(g + i, vg, gr);
    load_run(m + i, vm, mr);
    load_run(v + i, vv, vr);
    adamw_run(pr, gr, mr, vr, h, clip, s);
    store_run(p + i, vp, pr);
    store_run(m + i, vm, mr);
    store_run(v + i, vv, vr);
  } else {
    const int cnt = (int)(n - i);
    load_tail(p + i, cnt, pr);
    load_tail(g + i, cnt, gr);
    load_tail(m + i, cnt, mr);
    load_tail(v + i, cnt, vr);
    adamw_run(pr, gr, mr, vr, h, clip, s);
    store_tail(p + i, cnt, pr);
    store_tail(m + i, cnt, mr);
    store_tail(v + i, cnt, vr);
  }
}

// the block's sum in thread 0: warp butterflies, then the warps in order
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, warp_sums[w]);
  }
  return t;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
    grad_sq_norm_partial(const G* __restrict__ g, int64_t n, bool vec,
                         float* __restrict__ partial) {
  float acc[kRun] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float x[kRun];
  const int64_t full = n / kRun;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < full;
       r += stride) {
    load_run(g + r * kRun, vec, x);
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(x[k], x[k]));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && full * kRun < n) {
    load_tail(g + full * kRun, (int)(n - full * kRun), x);
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(x[k], x[k]));
  }
  const float t = __fadd_rn(
      __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
      __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
  const float b = block_sum(t);
  if (threadIdx.x == 0) partial[blockIdx.x] = b;
}

__global__ void __launch_bounds__(kThreads)
    grad_sq_norm_final(const float* __restrict__ partial, int blocks,
                       float* __restrict__ out) {
  float t = 0.0f;
  for (int i = threadIdx.x; i < blocks; i += kThreads)
    t = __fadd_rn(t, partial[i]);
  const float b = block_sum(t);
  if (threadIdx.x == 0) out[0] = b;
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename P, typename G>
cudaError_t launch_update(void* p, const void* g, void* m, void* v,
                          const float* scale, int64_t n, const Hyper& h,
                          cudaStream_t stream) {
  const int64_t runs = (n + kRun - 1) / kRun;
  const int64_t blocks = (runs + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const unsigned vec = (aligned(p) ? 1u : 0u) | (aligned(g) ? 2u : 0u) |
                       (aligned(m) ? 4u : 0u) | (aligned(v) ? 8u : 0u);
  adamw_step<P, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(m),
      static_cast<float*>(v), scale, n, h, vec);
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_norm(const void* g, int64_t n, float* partial, float* out,
                        cudaStream_t stream) {
  const int64_t full = n / kRun;
  int64_t blocks = (full + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kNormBlocks) blocks = kNormBlocks;
  grad_sq_norm_partial<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const G*>(g), n, aligned(g), partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_sq_norm_final<<<1, kThreads, 0, stream>>>(partial, (int)blocks, out);
  return cudaGetLastError();
}

}  // namespace

// p, g, m, v: n elements each (p in place, itemsize 2 = bf16, 4 = f32; m, v
// f32 in place); scale: a device f32 scalar, or null without clipping.
extern "C" int repro_adamw_update(void* p, const void* g, void* m, void* v,
                                  const void* scale, int64_t n,
                                  int64_t p_itemsize, int64_t g_itemsize,
                                  int64_t round_bf16, int64_t decay, float b1,
                                  float c1, float b2, float c2, float inv1,
                                  float inv2, float eps, float lr, float wd,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Hyper h{b1, c1, b2, c2, inv1, inv2, eps, lr, wd,
                (int)(round_bf16 != 0), (int)(decay != 0)};
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_itemsize == 2 && g_itemsize == 2)
    return (int)launch_update<uint16_t, uint16_t>(p, g, m, v, s, n, h, st);
  if (p_itemsize == 2 && g_itemsize == 4)
    return (int)launch_update<uint16_t, float>(p, g, m, v, s, n, h, st);
  if (p_itemsize == 4 && g_itemsize == 2)
    return (int)launch_update<float, uint16_t>(p, g, m, v, s, n, h, st);
  if (p_itemsize == 4 && g_itemsize == 4)
    return (int)launch_update<float, float>(p, g, m, v, s, n, h, st);
  return (int)cudaErrorInvalidValue;
}

// g: n elements (itemsize 2 = bf16, 4 = f32); partial: kNormBlocks floats of
// scratch; out: the f32 scalar ||g||^2.
extern "C" int repro_grad_sq_norm(const void* g, int64_t n, int64_t itemsize,
                                  void* partial, void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  float* pa = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 2) return (int)launch_norm<uint16_t>(g, n, pa, o, st);
  if (itemsize == 4) return (int)launch_norm<float>(g, n, pa, o, st);
  return (int)cudaErrorInvalidValue;
}
