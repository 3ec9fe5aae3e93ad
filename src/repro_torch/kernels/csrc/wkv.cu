// wkv — the RWKV6 chunked WKV recurrence on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv.py::wkv (pallas_call body
// _wkv_kernel). For r, k, v, lw (B, S, H, E), bonus u (H, E) and an f32
// state (B, H, E, E) [key x value], each (b, h) walks chunks of C = min(chunk,
// S) tokens in order, carrying the state from chunk to chunk. Inside a chunk,
// in f32:
//   cum = cumsum(lw), cin = cum - lw,
//   qf = r exp(clip(cin, -80, 0)),  kf = k exp(clip(-cum, 0, 80)),
//   out = (strictly lower qf kf^T) v + (sum_e r u k) v + qf state,
//   state <- state exp(clip(tot, -80, 0)) + (k exp(clip(tot - cum, -80, 80)))^T v
// with tot = cum of the chunk's last token; out is written in r's dtype and
// the final state in f32. The clamps are the reference's: where chunk * |lw|
// > 80 this is not the sequential recurrence, and the kernel computes what
// the reference computes.
//
// What bounds it on this card: at the serve path's prefill shape (B = 1,
// S = 2,048, H = 64, E = 64, chunk 32; bf16 r/k/v, f32 lw) the four products
// of a chunk need ~3.2 GFLOP in all, 0.048 ms at the 67 TFLOP/s the CUDA cores
// give f32, against ~103 MB of inputs and outputs, 0.031 ms at 3.35 TB/s:
// operations. At a decode step (S = 1) only the state moves, and bytes bound
// it. This first kernel does its products with scalar f32 FMAs from shared
// memory; the tensor cores (mma.sync on the chunk's C x E tiles) are a later
// change.
//
// Design. The TPU grid's sequential chunk axis, with the state in VMEM
// scratch, becomes a loop over chunks inside one block, with the state in
// shared memory. A block owns one (b, h) and a slice of EV = E / NV of the
// state's value columns (grid.y walks the slices): out and the state update
// of one value column read only that column of v and of the state, so the
// slices are independent; each block recomputes the chunk's qf, kf and
// qf kf^T for its slice. NV is the least of 1, 2, 4 (EV >= 16) that puts at
// least two blocks on every SM: at one 2,048-token prompt (b, h) alone gives
// 64 blocks for 132 SMs. Per chunk, 256 threads:
//   1. stage r, k, lw (all E columns) and v (the block's EV columns) of the
//      chunk's n <= C tokens as f32, read from (B, S, H, E) through strides
//      (a row of one head is E contiguous elements): the reference's
//      transposes to (B, H, S, E) are never made, and the ragged last chunk
//      is masked (only its n rows are read and used) instead of padded —
//      the padded rows of the reference have zero r, k, v and lw 0, so they
//      add nothing and leave tot as it is;
//   2. one thread per column scans lw into cum (in token order) while other
//      warps form the bonus term of each token;
//   3. qf, kf and the decayed k of the state update, elementwise (accurate
//      expf);
//   4. A = strictly lower qf kf^T (C x C);
//   5. out = A v + bonus v + qf state, for the block's value columns;
//   6. state = state * exp(clip(tot)) + kdec^T v.
// Row pitches of E + 1 floats keep column reads across rows free of bank
// conflicts. Shared memory is ~44 KB at C = 32, E = 64, EV = 16, and 117 KB
// at the largest case (C = 64, E = EV = 64), so the kernel opts in above
// 48 KB. S = 1 (a decode step) is the same code with C = 1. Templated on E in
// {16, 32, 64} and on the element types of r/k/v and of lw (f32, bf16).
//
// C interface (loaded with ctypes by kernels/ops.py); launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kMinEV = 16;          // fewest value columns a block owns
constexpr float kClamp = 80.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Strides {
  int64_t b, s, h;
};

// floats of shared memory for a chunk of c tokens, head size e, ev value
// columns: R, K, L, CUM [c][e + 1]; V [c][ev]; A [c][c]; S [e][ev]; diag [c];
// u, tot, decay [e]
__host__ __device__ constexpr size_t smem_floats(int c, int e, int ev) {
  return 4 * (size_t)c * (e + 1) + (size_t)c * ev + (size_t)c * c +
         (size_t)e * ev + c + 3 * (size_t)e;
}

template <typename T, typename TL, int E>
__global__ void __launch_bounds__(kThreads)
wkv_fwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const TL* __restrict__ lw,
        const float* __restrict__ bonus, const float* __restrict__ s0,
        T* __restrict__ out, float* __restrict__ s_out, int64_t seq,
        int64_t h, int chunk, int ev, Strides rs, Strides ks, Strides vs,
        Strides ls, Strides os) {
  constexpr int P = E + 1;
  extern __shared__ float smem[];
  float* R = smem;                    // r, then qf
  float* K = R + chunk * P;           // k, then kf
  float* L = K + chunk * P;           // lw, then k exp(clip(tot - cum))
  float* CUM = L + chunk * P;         // inclusive cumsum of lw
  float* V = CUM + chunk * P;         // [chunk][ev]
  float* A = V + chunk * ev;          // [chunk][chunk]
  float* S = A + chunk * chunk;       // [E][ev]
  float* diag = S + E * ev;           // [chunk]
  float* U = diag + chunk;            // [E]
  float* tot = U + E;                 // [E]
  float* decay = tot + E;             // [E]

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / h, hi = bh % h;
  const int v0 = blockIdx.y * ev;
  const T* rb = r + bi * rs.b + hi * rs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h + v0;
  const TL* lb = lw + bi * ls.b + hi * ls.h;
  T* ob = out + bi * os.b + hi * os.h + v0;
  const float* st_in = s0 + bh * E * E + v0;
  float* st_out = s_out + bh * E * E + v0;

  for (int i = tid; i < E * ev; i += kThreads)
    S[i] = st_in[(i / ev) * E + i % ev];
  for (int e = tid; e < E; e += kThreads) U[e] = bonus[hi * E + e];

  for (int64_t c0 = 0; c0 < seq; c0 += chunk) {
    const int n = (int)(seq - c0 < chunk ? seq - c0 : chunk);
    // 1. stage the chunk's rows as f32
    for (int i = tid; i < n * E; i += kThreads) {
      const int t = i / E, e = i % E;
      const int64_t row = c0 + t;
      R[t * P + e] = to_f(rb[row * rs.s + e]);
      K[t * P + e] = to_f(kb[row * ks.s + e]);
      L[t * P + e] = to_f(lb[row * ls.s + e]);
    }
    for (int i = tid; i < n * ev; i += kThreads) {
      const int t = i / ev, c = i % ev;
      V[i] = to_f(vb[(c0 + t) * vs.s + c]);
    }
    __syncthreads();

    // 2. cum per column (warps 0-1), the bonus term per token (warps 4-5)
    if (tid < E) {
      float c = 0.f;
      for (int t = 0; t < n; ++t) {
        c += L[t * P + tid];
        CUM[t * P + tid] = c;
      }
      tot[tid] = c;
      decay[tid] = expf(clip(c, -kClamp, 0.f));
    } else if (tid >= 128 && tid - 128 < n) {
      const int t = tid - 128;
      float acc = 0.f;
      for (int e = 0; e < E; ++e) acc += R[t * P + e] * U[e] * K[t * P + e];
      diag[t] = acc;
    }
    __syncthreads();

    // 3. the factored pieces
    for (int i = tid; i < n * E; i += kThreads) {
      const int t = i / E, e = i % E;
      const float cum = CUM[t * P + e];
      const float kv = K[t * P + e];
      const float cin = cum - L[t * P + e];
      R[t * P + e] *= expf(clip(cin, -kClamp, 0.f));
      K[t * P + e] = kv * expf(clip(-cum, 0.f, kClamp));
      L[t * P + e] = kv * expf(clip(tot[e] - cum, -kClamp, kClamp));
    }
    __syncthreads();

    // 4. A = strictly lower qf kf^T
    for (int i = tid; i < n * n; i += kThreads) {
      const int t = i / n, j = i % n;
      float acc = 0.f;
      if (j < t) {
#pragma unroll 8
        for (int e = 0; e < E; ++e) acc = fmaf(R[t * P + e], K[j * P + e], acc);
      }
      A[t * chunk + j] = acc;
    }
    __syncthreads();

    // 5. out = A v + bonus v + qf state, for this block's value columns
    for (int i = tid; i < n * ev; i += kThreads) {
      const int t = i / ev, c = i % ev;
      float acc = 0.f;
      for (int j = 0; j < t; ++j) acc = fmaf(A[t * chunk + j], V[j * ev + c], acc);
      acc += diag[t] * V[t * ev + c];
      float inter = 0.f;
#pragma unroll 8
      for (int e = 0; e < E; ++e) inter = fmaf(R[t * P + e], S[e * ev + c], inter);
      from_f(&ob[(c0 + t) * os.s + c], acc + inter);
    }
    __syncthreads();

    // 6. state = state * exp(clip(tot)) + kdec^T v
    for (int i = tid; i < E * ev; i += kThreads) {
      const int e = i / ev, c = i % ev;
      float acc = 0.f;
      for (int t = 0; t < n; ++t) acc = fmaf(L[t * P + e], V[t * ev + c], acc);
      S[i] = S[i] * decay[e] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < E * ev; i += kThreads)
    st_out[(i / ev) * E + i % ev] = S[i];
}

int sm_count() {
  static int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 132;
    return n;
  }();
  return sms;
}

template <typename T, typename TL, int E>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const float* bonus, const float* s0,
                   void* out, float* s_out, int64_t b, int64_t s, int64_t h,
                   int chunk, Strides rs, Strides ks, Strides vs, Strides ls,
                   Strides os, cudaStream_t stream) {
  if (b * h > 2147483647LL) return cudaErrorInvalidValue;
  // above 48 KB a block's shared memory must be asked for (once per type,
  // for the largest chunk and slice)
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_fwd<T, TL, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats(kMaxChunk, E, E)));
  if (attr != cudaSuccess) return attr;
  int nv = 1;
  while (nv < 4 && E / (2 * nv) >= kMinEV && b * h * nv < 2 * sm_count())
    nv *= 2;
  const int ev = E / nv;
  const size_t smem = sizeof(float) * smem_floats(chunk, E, ev);
  dim3 grid((unsigned)(b * h), (unsigned)nv);
  wkv_fwd<T, TL, E><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TL*>(lw), bonus, s0,
      static_cast<T*>(out), s_out, s, h, chunk, ev, rs, ks, vs, ls, os);
  return cudaGetLastError();
}

template <typename T, typename TL>
cudaError_t by_dim(int64_t e, const void* r, const void* k, const void* v,
                   const void* lw, const float* u, const float* s0, void* o,
                   float* sT, int64_t b, int64_t s, int64_t h, int chunk,
                   Strides rs, Strides ks, Strides vs, Strides ls, Strides os,
                   cudaStream_t st) {
  switch (e) {
    case 16: return launch<T, TL, 16>(r, k, v, lw, u, s0, o, sT, b, s, h, chunk, rs, ks, vs, ls, os, st);
    case 32: return launch<T, TL, 32>(r, k, v, lw, u, s0, o, sT, b, s, h, chunk, rs, ks, vs, ls, os, st);
    case 64: return launch<T, TL, 64>(r, k, v, lw, u, s0, o, sT, b, s, h, chunk, rs, ks, vs, ls, os, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements, for the b, s and h dimensions of r, k, v, lw and
// out (the e dimension is contiguous); bonus (H, E) and both states
// (B, H, E, E) are contiguous f32. itemsize 4 = f32, 2 = bf16, for r/k/v
// (and out) and for lw separately. 1 <= chunk <= 64.
extern "C" int repro_wkv(
    const void* r, const void* k, const void* v, const void* lw,
    const void* bonus, const void* s0, void* out, void* s_out, int64_t b,
    int64_t s, int64_t h, int64_t e, int64_t chunk, int64_t itemsize,
    int64_t lw_itemsize, int64_t rsb, int64_t rss, int64_t rsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t lsb, int64_t lss, int64_t lsh, int64_t osb, int64_t oss,
    int64_t osh, void* stream) {
  if (b <= 0 || h <= 0) return (int)cudaSuccess;
  if (s <= 0 || chunk <= 0 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides rs{rsb, rss, rsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ls{lsb, lss, lsh}, os{osb, oss, osh};
  const int c = (int)(chunk < s ? chunk : s);
  const float* u = static_cast<const float*>(bonus);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(s_out);
  using bf16 = __nv_bfloat16;
  if (itemsize == 4 && lw_itemsize == 4)
    return (int)by_dim<float, float>(e, r, k, v, lw, u, s0f, out, sTf, b, s, h, c, rs, ks, vs, ls, os, st);
  if (itemsize == 4 && lw_itemsize == 2)
    return (int)by_dim<float, bf16>(e, r, k, v, lw, u, s0f, out, sTf, b, s, h, c, rs, ks, vs, ls, os, st);
  if (itemsize == 2 && lw_itemsize == 4)
    return (int)by_dim<bf16, float>(e, r, k, v, lw, u, s0f, out, sTf, b, s, h, c, rs, ks, vs, ls, os, st);
  if (itemsize == 2 && lw_itemsize == 2)
    return (int)by_dim<bf16, bf16>(e, r, k, v, lw, u, s0f, out, sTf, b, s, h, c, rs, ks, vs, ls, os, st);
  return (int)cudaErrorInvalidValue;
}
