// wkv_step — one token of the RWKV6 WKV recurrence on Hopper (sm_90a): the
// decode step's state update in a single pass over the state.
//
// Replaces, for S = 1 (every decode and teacher-forced step of the serving
// loop), the TPU kernel src/repro/kernels/wkv.py::wkv (pallas_call body
// _wkv_kernel). With one token the chunk form has C = 1, so qf = r, the
// strictly lower product is empty and kdec = k: for each (b, h), with r, k,
// v, lw (E,), bonus u (E,) and the f32 state S (E x E) [key x value],
//   out_c  = sum_e r_e S_ec + (sum_e r_e u_e k_e) v_c,
//   S_ec  <- S_ec exp(clip(lw_e, -80, 0)) + k_e v_c,
// the reference's clamp applied before the exp. out is written in r's dtype,
// the new state in f32. Chunks of more than one token take wkv_tc.cu (bf16,
// E = 64) or wkv.cu (kernels/ops.py::wkv_route).
//
// What bounds it on this card: bytes. The state is read once and written
// once (at B 4, H 64, E 64: 8.4 MB, 0.0026 ms at 3.35 TB/s); r, k, v and lw
// are a few KB, and the update is 2 FMAs per state element.
//
// Design: one CTA of 256 threads per (b, h). Each thread loads its float4s of
// the state (16-byte loads, issued before anything else so that they are in
// flight while the token's vectors are staged), with E/4 column groups: at
// E = 64 a thread holds rows t/16 + 16j (j < 4) of column group t % 16. The
// token's r, k, v, the decay exp(clip(lw, -80, 0)) (accurate expf) and the
// bonus diagonal (a warp-shuffle sum) go through shared memory. Then each
// thread forms its rows' part of out and writes the new state in the same
// pass; the sum of out over e runs by shuffles inside a warp and one
// shared-memory pass across the 8 warps. f32 throughout. Templated on
// E in {16, 32, 64} and on the element types of r/k/v and of lw.
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kClamp = 80.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  int64_t b, h;
};

template <typename T, typename TL, int E>
__global__ void __launch_bounds__(kThreads)
wkv_step(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const TL* __restrict__ lw,
         const float* __restrict__ bonus, const float* __restrict__ s0,
         T* __restrict__ out, float* __restrict__ s_out, int h, Strides rs,
         Strides ks, Strides vs, Strides ls, Strides os) {
  constexpr int G = E / 4;                       // float4 column groups
  constexpr int NF = E * G;                      // float4s of the state
  constexpr int PER = (NF + kThreads - 1) / kThreads;
  __shared__ float sr[E], sk[E], sv[E], sdec[E];
  __shared__ __align__(16) float red[kWarps][E];
  __shared__ float dsum[kWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / h, hi = bh % h;
  const float4* st = reinterpret_cast<const float4*>(s0 + bh * E * E);
  float4* so = reinterpret_cast<float4*>(s_out + bh * E * E);

  float4 x[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = tid + p * kThreads;
    if (i < NF) x[p] = st[i];
  }

  float prod = 0.f;
  if (tid < E) {
    const float rr = to_f(r[bi * rs.b + hi * rs.h + tid]);
    const float kk = to_f(k[bi * ks.b + hi * ks.h + tid]);
    sr[tid] = rr;
    sk[tid] = kk;
    sv[tid] = to_f(v[bi * vs.b + hi * vs.h + tid]);
    sdec[tid] = expf(fminf(fmaxf(to_f(lw[bi * ls.b + hi * ls.h + tid]),
                                 -kClamp), 0.f));
    prod = rr * bonus[hi * E + tid] * kk;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    prod += __shfl_xor_sync(0xffffffffu, prod, off);
  if (lane == 0) dsum[warp] = prod;
  __syncthreads();

  // this thread's column group (the same for each of its float4s, since
  // kThreads is a multiple of G) and its rows' part of out
  const int cg = tid % G;
  const float v0 = sv[4 * cg], v1 = sv[4 * cg + 1], v2 = sv[4 * cg + 2],
              v3 = sv[4 * cg + 3];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = tid + p * kThreads;
    if (i < NF) {
      const int e = i / G;
      const float re = sr[e], ke = sk[e], de = sdec[e];
      const float4 s = x[p];
      a0 = fmaf(re, s.x, a0);
      a1 = fmaf(re, s.y, a1);
      a2 = fmaf(re, s.z, a2);
      a3 = fmaf(re, s.w, a3);
      so[i] = make_float4(fmaf(s.x, de, ke * v0), fmaf(s.y, de, ke * v1),
                          fmaf(s.z, de, ke * v2), fmaf(s.w, de, ke * v3));
    }
  }
  // sum over the lanes of one column group, then across warps
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    a3 += __shfl_xor_sync(0xffffffffu, a3, off);
  }
  if (lane < G)
    *reinterpret_cast<float4*>(&red[warp][4 * cg]) =
        make_float4(a0, a1, a2, a3);
  __syncthreads();
  if (tid < E) {
    float o = 0.f, d = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o += red[w][tid];
      d += dsum[w];
    }
    from_f(&out[bi * os.b + hi * os.h + tid], o + d * sv[tid]);
  }
}

template <typename T, typename TL>
cudaError_t by_dim(int64_t e, const void* r, const void* k, const void* v,
                   const void* lw, const float* u, const float* s0, void* o,
                   float* sT, int64_t b, int64_t h, Strides rs, Strides ks,
                   Strides vs, Strides ls, Strides os, cudaStream_t st) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const TL* lp = static_cast<const TL*>(lw);
  T* op = static_cast<T*>(o);
  const unsigned grid = (unsigned)(b * h);
  switch (e) {
    case 16:
      wkv_step<T, TL, 16><<<grid, kThreads, 0, st>>>(
          rp, kp, vp, lp, u, s0, op, sT, (int)h, rs, ks, vs, ls, os);
      break;
    case 32:
      wkv_step<T, TL, 32><<<grid, kThreads, 0, st>>>(
          rp, kp, vp, lp, u, s0, op, sT, (int)h, rs, ks, vs, ls, os);
      break;
    case 64:
      wkv_step<T, TL, 64><<<grid, kThreads, 0, st>>>(
          rp, kp, vp, lp, u, s0, op, sT, (int)h, rs, ks, vs, ls, os);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One token: strides are in elements, for the b and h dimensions of r, k, v,
// lw and out (the e dimension is contiguous); bonus (H, E) and both states
// (B, H, E, E) are contiguous f32, the states 16-byte aligned. itemsize 4 =
// f32, 2 = bf16, for r/k/v (and out) and for lw separately.
extern "C" int repro_wkv_step(
    const void* r, const void* k, const void* v, const void* lw,
    const void* bonus, const void* s0, void* out, void* s_out, int64_t b,
    int64_t h, int64_t e, int64_t itemsize, int64_t lw_itemsize, int64_t rsb,
    int64_t rsh, int64_t ksb, int64_t ksh, int64_t vsb, int64_t vsh,
    int64_t lsb, int64_t lsh, int64_t osb, int64_t osh, void* stream) {
  if (b <= 0 || h <= 0) return (int)cudaSuccess;
  if (b * h > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides rs{rsb, rsh}, ks{ksb, ksh}, vs{vsb, vsh}, ls{lsb, lsh},
      os{osb, osh};
  const float* u = static_cast<const float*>(bonus);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(s_out);
  using bf16 = __nv_bfloat16;
  if (itemsize == 4 && lw_itemsize == 4)
    return (int)by_dim<float, float>(e, r, k, v, lw, u, s0f, out, sTf, b, h, rs, ks, vs, ls, os, st);
  if (itemsize == 4 && lw_itemsize == 2)
    return (int)by_dim<float, bf16>(e, r, k, v, lw, u, s0f, out, sTf, b, h, rs, ks, vs, ls, os, st);
  if (itemsize == 2 && lw_itemsize == 4)
    return (int)by_dim<bf16, float>(e, r, k, v, lw, u, s0f, out, sTf, b, h, rs, ks, vs, ls, os, st);
  if (itemsize == 2 && lw_itemsize == 2)
    return (int)by_dim<bf16, bf16>(e, r, k, v, lw, u, s0f, out, sTf, b, h, rs, ks, vs, ls, os, st);
  return (int)cudaErrorInvalidValue;
}
