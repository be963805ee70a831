// Flash attention (forward): causal or bidirectional GQA attention with an
// online softmax and an optional sliding window,
//
//   o[b, s, h, :] = sum_t softmax_t(scale * <q[b, s, h], k[b, t, h/g]>) v[b, t, h/g]
//
// over the keys t that the mask keeps (t < S; t <= s when causal;
// t > s - window when window > 0), g = Hq / Hkv, scale = 1/sqrt(D).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (wrapper
// flash_attention_bhsd).  Its plain PyTorch version is
// repro_torch.kernels.ref.flash_attention_ref.  Forward only: the TPU
// kernel has no gradient either.
//
// Layout: q (B, S, Hq, D), k and v (B, S, Hkv, D), read through their
// batch, sequence and head strides (the head dim is contiguous), so the
// model's (B, S, H, D) projections go in without a transposed copy; o is a
// fresh contiguous (B, S, Hq, D) in q's type.  q, k, v are all f32 or all
// bf16; everything inside is f32.  Nothing is padded in global memory: S
// and D take any value (D <= 160, the configs' largest head dim), rows
// past S load as zeros and are never stored.
//
// Work split (FlashAttention-1 on CUDA cores): one block of 128 threads
// per (64-row query tile, b * Hq + h).  The block stages its Q tile once
// and each 64-row K/V tile in turn in shared memory as f32 (Q and K
// transposed, so a warp reads neighbouring columns), walking the K/V
// tiles left to right.  Thread t owns the 4 query rows 4 * (t / 8) + i and
// the 8 key columns (t % 8) + 8 j of the score tile, and the same rows
// times the head-dim columns (t % 8) + 8 j of the output accumulator, all
// in registers; the 8 threads of a row group sit side by side in one warp,
// so the row max and row sum are three xor shuffles.  The softmax weights
// go through shared memory (P, f32) between the two products.
//
// Semantics copied from the TPU kernel: the dot product is taken in f32
// and then multiplied by scale; masked logits are -1e30, not -inf; the
// running max starts at -1e30; a K/V tile is skipped when it lies wholly
// above the causal diagonal or left of the window; the row sum is clamped
// at 1e-30 before the division; P stays f32 for P.V.  With -1e30 masking
// a row whose first processed tile holds none of its keys accumulates
// exp(0) weights; because tiles are processed left to right, the first
// tile that holds one of its keys raises its max from -1e30 and rescales
// that garbage by exp(-1e30 - m) = 0, as on the TPU (every row keeps its
// own diagonal key, so such a tile always comes).
//
// Every (b, h, query tile) is computed by the same instructions in the
// same order whatever B or its place in the grid, so a row of a B = 2
// launch is bitwise the B = 1 launch of that row.
//
// What bounds it on this card: 4 * D operations per unmasked (query, key)
// pair against a few bytes per row.  On the tensor cores that is ~0.07 ms
// at granite's eval shape; this first version runs both products on the
// f32 CUDA cores (67 TFLOP/s at most, and each FMA here needs ~0.4 shared
// loads), so it is tens of times slower than that bound (PERF.md).  The
// tensor-core redesign (mma.sync / wgmma on bf16 tiles, K/V double
// buffered with cp.async or TMA, P kept in registers) is a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRows = 4;        // query rows a thread owns
constexpr int kCols = 8;        // key columns a thread owns
constexpr int kPad = kBlockK + 1;   // row stride of the transposed tiles and P
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, Hq, Hkv, D;
  long long qsb, qss, qsh;   // strides in elements
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int causal, window;
  float scale;
};

size_t smem_bytes(int D) {
  // Q^T [D][kPad], K^T [D][kPad], V [kBlockK][D], P [kBlockQ][kPad]
  return sizeof(float) *
         (2 * static_cast<size_t>(D) * kPad +
          static_cast<size_t>(kBlockK) * D + kBlockQ * kPad);
}

// kMaxD: the head dims this instantiation takes (D <= kMaxD); a thread keeps
// kMaxD / 8 output columns of each of its rows in registers.
template <typename T, int kMaxD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int kOut = kMaxD / kCols;
  extern __shared__ float4 smem4[];
  const int D = p.D;
  float* sQt = reinterpret_cast<float*>(smem4);   // [D][kPad]
  float* sKt = sQt + D * kPad;                     // [D][kPad]
  float* sV = sKt + D * kPad;                      // [kBlockK][D]
  float* sP = sV + kBlockK * D;                    // [kBlockQ][kPad]

  const int tid = threadIdx.x;
  const int rg = tid / kCols;           // row group: rows 4*rg .. 4*rg+3
  const int cg = tid % kCols;           // column group
  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * kBlockQ;
  const int S = p.S;

  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  // stage Q^T once; rows past S are zeros
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = q0 + r;
    sQt[d * kPad + r] = s < S ? to_f32(q[s * p.qss + d]) : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;
  }

  // the K/V tiles that hold a key of this query tile, left to right
  const int q_last = min(S, q0 + kBlockQ);          // one past the last row
  const int kv_end = p.causal ? q_last : S;         // one past the last key
  int kv_begin = 0;
  if (p.window > 0) {
    // the first key any row of the tile keeps is q0 - window + 1
    kv_begin = max(0, q0 + 1 - p.window) / kBlockK * kBlockK;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();   // the previous tile's K^T, V and P are read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int t = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (t < S) {
        kv = to_f32(k[t * p.kss + d]);
        vv = to_f32(v[t * p.vss + d]);
      }
      sKt[d * kPad + r] = kv;
      sV[r * D + d] = vv;
    }
    __syncthreads();

    // scores s[i][j] for rows 4*rg+i, columns cg+8*j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQt[d * kPad + rg * kRows + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = sKt[d * kPad + cg + kCols * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + rg * kRows + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + cg + kCols * j;
        bool ok = kpos < S;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kCols; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = expf(s[i][j] - m_new);
        sum += pj;
        sP[(rg * kRows + i) * kPad + cg + kCols * j] = pj;
      }
#pragma unroll
      for (int off = 1; off < kCols; off <<= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[i][j] += sum_t P[4*rg+i][t] * V[t][cg+8*j]
#pragma unroll 2
    for (int t = 0; t < kBlockK; ++t) {
      float pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = sP[(rg * kRows + i) * kPad + t];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int d = cg + kCols * j;
        if (d < D) {
          const float vb = sV[t * D + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o) + (static_cast<long long>(b) * S * p.Hq + h) * D;
  const long long os = static_cast<long long>(p.Hq) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + rg * kRows + i;
    if (s >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int d = cg + kCols * j;
      if (d < D) store(o + s * os + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int kMaxD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kMaxD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.B * p.Hq);
  flash_fwd_kernel<T, kMaxD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  return launch<T, 160>(p, stream);
}

}  // namespace

// is_bf16: 1 when q, k, v and o hold bf16, 0 when f32.  Strides are in
// elements.  Returns a cudaError_t: cudaErrorInvalidValue for shapes the
// kernel does not take (the wrapper checks them first), else the launch's
// own error.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
    int Hkv, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    int causal, int window, float scale, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 1 ||
      D > 160 || static_cast<long long>(B) * Hq > 65535 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{q,   k,   v,   o,   B,   S,   Hq,     Hkv,    D,    qsb, qss,
                 qsh, ksb, kss, ksh, vsb, vss, vsh, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, s)
                                  : dispatch<float>(p, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
