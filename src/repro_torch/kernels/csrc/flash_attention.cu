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
// bf16.  Nothing is padded in global memory: S and D take any value
// (D <= 160, the configs' largest head dim), rows past S load as zeros and
// are never stored.
//
// Semantics copied from the TPU kernel, in both versions below: the dot
// product is taken in f32 and then multiplied by scale (by scale * log2 e
// on the tensor cores, whose softmax is in base 2); masked logits are
// -1e30, not -inf; the running max starts at -1e30; a K/V tile is skipped
// when it lies wholly above the causal diagonal or left of the window; the
// row sum is clamped at 1e-30 before the division; P.V takes P in f32 (or,
// on the tensor cores, to 2^-17 of it, see below).  With -1e30 masking a
// row whose first processed tile holds none of its keys accumulates exp(0)
// weights; because tiles are processed left to right, the first tile that
// holds one of its keys raises its max from -1e30 and rescales that
// garbage by exp(-1e30 - m) = 0, as on the TPU (every row keeps its own
// diagonal key, so such a tile always comes).  Every (b, h, query tile) is
// computed by the same instructions in the same order whatever B or its
// place in the grid, so a row of a B = 2 launch is bitwise the B = 1 launch
// of that row (no split over keys, no atomics).
//
// What bounds it on this card: 4 * D operations per unmasked (query, key)
// pair against a few bytes per row, so the tensor cores' bf16 rate (989
// TFLOP/s dense): ~0.07 ms at granite's eval shape, ~0.39 ms at danube's.
//
// bf16 (evaluation): FlashAttention-2 on the tensor cores, in inline PTX.
// One block of 4 warps per (64-row query tile, b * Hq + h); each warp owns
// 16 query rows against the whole 64-key tile, so a row's max and sum are
// two xor shuffles inside a lane quad.  Both products are
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (bf16 products are exact in f32):
// Q's A fragments are loaded once by ldmatrix and kept in registers, K's B
// fragments come from shared memory by ldmatrix, V's by ldmatrix.trans from
// the row-major V tile.  D is padded in shared memory to the k16 step of
// its class (32, 64, 128, 160: 20 -> 32, 120 -> 128) with zeros, and every
// shared row is skewed by 8 elements so that ldmatrix is free of bank
// conflicts.  K/V tiles arrive in a two-stage ring by cp.async (16 bytes,
// zero-filled past D and past S), so tile j + 1 loads while tile j
// computes; a tile wholly below S takes a lean path whose only per-row work
// is one pointer add (the per-element index arithmetic of a general tile
// cost about a third of the kernel's time), and rows that are not 16-byte
// aligned in global memory (q's head stride at D = 20 is 40 bytes) take a
// scalar path.  Q's tile is the second V stage until the loop starts, so a
// block holds 4 tiles of shared memory (70 KB at D = 128: 3 blocks an SM).
// The softmax runs in registers in the log2 domain (log2 e folded into the
// scale, ex2.approx), masking only the tiles that cut a warp's rows, and
// the score accumulator is reused as the A fragment of P.V without leaving
// registers.  P is not rounded to bf16 whole: that misses the limit of one
// bf16 output step by up to 34x.  It is split into hi = bf16(p) and
// lo = bf16(p - hi), and two mma's take hi.V and lo.V into the same f32
// accumulator, so P.V sees p to ~2^-17 relative.  That costs 1.5x the
// tensor-core work of a single-bf16 P.V, so this version does 2 D_pad +
// 3 D_pad operations per pair of a 64 x 64 tile against the bound's 4 D:
// 1.25x at D = 64, 1.33x at D = 120, plus whole tiles at the diagonal and
// the window's edge.  Causal launches start the query tiles with the most
// key tiles first.  Left for later versions: wgmma and TMA, warp
// specialisation, and one K/V load serving a GQA group's query heads.
//
// f32 (the checks and the 4-layer f32 route comparison): FlashAttention-1
// on the CUDA cores, so its 2e-5 limit is not lost to TF32.  One block of
// 128 threads per (64-row query tile, b * Hq + h) stages its Q tile once
// and each 64-row K/V tile in turn in shared memory as f32 (Q and K
// transposed, so a warp reads neighbouring columns), walking the K/V tiles
// left to right.  Thread t owns the 4 query rows 4 * (t / 8) + i and the 8
// key columns (t % 8) + 8 j of the score tile, and the same rows times the
// head-dim columns (t % 8) + 8 j of the output accumulator, all in
// registers; the row max and row sum are three xor shuffles.  The softmax
// weights go through shared memory (P, f32) between the two products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---- f32 on the CUDA cores ------------------------------------------------

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

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsQ = 16 * kWarps;   // query rows per block, 16 per warp
constexpr int kKeys = 64;             // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Params plus whether each of q, k, v may be read by 16-byte cp.async
// (base 16-byte aligned and every stride a multiple of 8 elements).
struct MmaParams {
  Params p;
  int vec_q, vec_k, vec_v;
};

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; bytes past src_bytes are written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(const void* ptr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* ptr,
                                                  unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> hi = bf16x2(x, y), lo = bf16x2(x - hi.x, y - hi.y); x in the
// low half, as an A fragment wants the lower column there
__device__ __forceinline__ void split_bf16x2(float x, float y, unsigned& hi,
                                             unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// 2^x on the SFU (inputs are <= 0 here; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows row0 .. row0 + kRows - 1 of one head of q, k or v into a shared
// tile of kDk columns and row stride kDk + 8; columns past D and rows past
// S are zeros.  16-byte pieces go by cp.async where the rows are aligned
// (the caller commits the group), element by element otherwise.  A tile
// that lies wholly below S with aligned rows takes the lean path: each
// thread owns one 16-byte column piece (its byte count fixed by D) of
// every 128 / (kDk / 8)-th row, so a row step is one pointer add.
template <int kDk, int kRows>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int S, int D, bool vec) {
  constexpr int kChunks = kDk / 8;
  constexpr int kStride = kDk + 8;
  constexpr int kBlockThreads = kWarps * 32;
  if constexpr (kBlockThreads % kChunks == 0) {
    if (vec && row0 + kRows <= S) {
      constexpr int kRowStep = kBlockThreads / kChunks;
      const int r = threadIdx.x / kChunks;
      const int d0 = (threadIdx.x % kChunks) * 8;
      const int n = 2 * min(8, max(0, D - d0));
      const char* in = reinterpret_cast<const char*>(
          src + (row0 + r) * row_stride + d0);
      const long long step = 2 * kRowStep * row_stride;
      bf16* out = dst + r * kStride + d0;
#pragma unroll
      for (int j = 0; j < kRows / kRowStep; ++j) {
        cp_async16(out + j * kRowStep * kStride, in, n);
        in += step;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < kRows * kChunks; i += kBlockThreads) {
    const int r = i / kChunks;
    const int d0 = (i - r * kChunks) * 8;
    const int t = row0 + r;
    const int n = t < S ? min(8, max(0, D - d0)) : 0;
    bf16* out = dst + r * kStride + d0;
    const bf16* in = src + t * row_stride + d0;
    if (n == 0) {
      *reinterpret_cast<uint4*>(out) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(out, in, 2 * n);
    } else {
      alignas(16) unsigned short piece[8];
      const unsigned short* bits = reinterpret_cast<const unsigned short*>(in);
#pragma unroll
      for (int e = 0; e < 8; ++e) piece[e] = e < n ? bits[e] : 0;
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(piece);
    }
  }
}

// kDk: the head dims this instantiation takes (D <= kDk), padded in shared
// memory to kDk, a multiple of 16.
template <int kDk>
constexpr size_t mma_smem_bytes() {
  // K and V [2 stages][kKeys] rows of kDk + 8 bf16; Q's tile is the second
  // V stage until the loop starts
  return sizeof(bf16) * 4 * kKeys * (kDk + 8);
}

template <int kDk>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_mma_kernel(const MmaParams mp) {
  constexpr int kStride = kDk + 8;   // bf16 per shared row
  constexpr int kSteps = kDk / 16;   // k16 steps of QK^T; n8 pairs of P.V
  constexpr int kN = kDk / 8;        // n8 tiles of the output
  extern __shared__ uint4 smem_mma[];
  bf16* sK = reinterpret_cast<bf16*>(smem_mma);   // [2][kKeys][kStride]
  bf16* sV = sK + 2 * kKeys * kStride;             // [2][kKeys][kStride]
  bf16* sQ = sV + kKeys * kStride;                 // [kRowsQ][kStride]

  const Params& p = mp.p;
  const int S = p.S, D = p.D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane / 4;   // the fragment row of this lane
  const int pair = lane % 4;   // its column pair
  const int bh = blockIdx.x;
  const int b = bh / p.Hq;
  const int h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  // causal: the query tiles with the most key tiles start first
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRowsQ;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;

  // the K/V tiles that hold a key of this query tile, left to right
  const int q_last = min(S, q0 + kRowsQ);   // one past the last row
  const int kv_end = p.causal ? q_last : S;
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q0 + 1 - p.window) / kKeys * kKeys;
  const int n_tiles = (kv_end - kv_begin + kKeys - 1) / kKeys;

  load_tile<kDk, kRowsQ>(sQ, q, p.qss, q0, S, D, mp.vec_q);
  load_tile<kDk, kKeys>(sK, k, p.kss, kv_begin, S, D, mp.vec_k);
  load_tile<kDk, kKeys>(sV, v, p.vss, kv_begin, S, D, mp.vec_v);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q's A fragments, kept in registers for the whole block
  unsigned qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ldmatrix_x4(sQ + (warp * 16 + lane % 16) * kStride + kk * 16 +
                    (lane / 16) * 8,
                qf[kk]);
  }
  __syncthreads();   // Q is read: its tile is the second V stage from here

  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // running max (log2 domain) and this lane's part of the row sums of the
  // fragment rows r = 0, 1: quad and quad + 8
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  const float scale2 = p.scale * kLog2e;
  const int qw = q0 + warp * 16;   // the warp's first row

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kKeys;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = (stage ^ 1) * kKeys * kStride;
      load_tile<kDk, kKeys>(sK + nxt, k, p.kss, k0 + kKeys, S, D, mp.vec_k);
      load_tile<kDk, kKeys>(sV + nxt, v, p.vss, k0 + kKeys, S, D, mp.vec_v);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + stage * kKeys * kStride;
    const bf16* cV = sV + stage * kKeys * kStride;

    // s = Q K^T: 8 n8 tiles of keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 >= D) break;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned kb[4];
        ldmatrix_x4(cK + (jp * 16 + lane % 8 + (lane / 16) * 8) * kStride +
                        kk * 16 + ((lane / 8) % 2) * 8,
                    kb);
        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale (log2 domain), then mask unless every key of the tile is kept
    // for every row of the warp
    const bool whole = k0 + kKeys <= S &&
                       (!p.causal || k0 + kKeys - 1 <= qw) &&
                       (p.window == 0 || k0 > qw + 15 - p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (!whole) {
          const int kpos = k0 + 8 * j + 2 * pair + (e & 1);
          const int qpos = qw + quad + (e / 2) * 8;
          bool ok = kpos < S;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          x = ok ? x : kNeg;
        }
        s[j][e] = x;
      }
    }

    // online softmax in registers
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      alpha[r] = exp2_approx(m[r] - mx);
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * r] = exp2_approx(s[j][2 * r] - mx);
        s[j][2 * r + 1] = exp2_approx(s[j][2 * r + 1] - mx);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P V, P as hi + lo bf16 A fragments straight from the registers
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned hi[4], lo[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* f = s[2 * ks + x / 2] + 2 * (x % 2);
        split_bf16x2(f[0], f[1], hi[x], lo[x]);
      }
#pragma unroll
      for (int np = 0; np < kSteps; ++np) {
        if (np * 16 >= D) break;
        unsigned vb[4];
        ldmatrix_x4_trans(cV + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                   kStride +
                              np * 16 + (lane / 16) * 8,
                          vb);
        mma_bf16(o[2 * np], hi, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], hi, vb[2], vb[3]);
        mma_bf16(o[2 * np], lo, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is read before the next fill
  }

  bf16* out = static_cast<bf16*>(p.o) +
              static_cast<long long>(b) * S * p.Hq * D +
              static_cast<long long>(h) * D;
  const long long os = static_cast<long long>(p.Hq) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const int row = qw + quad + 8 * r;
    if (row >= S) continue;
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    bf16* orow = out + row * os;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int d = 8 * n + 2 * pair;
      if (d < D) orow[d] = __float2bfloat16(o[n][2 * r] * inv);
      if (d + 1 < D) orow[d + 1] = __float2bfloat16(o[n][2 * r + 1] * inv);
    }
  }
}

bool aligned16(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

template <int kDk>
cudaError_t launch_mma(const MmaParams& mp, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<kDk>();
  const int n_q = (mp.p.S + kRowsQ - 1) / kRowsQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<kDk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(mp.p.B * mp.p.Hq, n_q);
  flash_fwd_mma_kernel<kDk><<<grid, kWarps * 32, smem, stream>>>(mp);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  const MmaParams mp{p, aligned16(p.q, p.qsb, p.qss, p.qsh),
                     aligned16(p.k, p.ksb, p.kss, p.ksh),
                     aligned16(p.v, p.vsb, p.vss, p.vsh)};
  if (p.D <= 32) return launch_mma<32>(mp, stream);
  if (p.D <= 64) return launch_mma<64>(mp, stream);
  if (p.D <= 128) return launch_mma<128>(mp, stream);
  return launch_mma<160>(mp, stream);
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
  const cudaError_t err = is_bf16 ? dispatch_bf16(p, s)
                                  : dispatch<float>(p, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
