// Selective scan (Mamba-1 / Mamba-2): the diagonal-A state-space recurrence
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t,   h_{-1} = 0
//   y_t = <h_t, C_t>
//
// for every (batch row b, channel d), with N states per channel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::_ssm_kernel
// (wrapper ssm_scan_pallas).  Its plain PyTorch version is
// repro_torch.models.mamba.selective_scan.
//
// Layout (row-major, contiguous; checked by the wrapper):
//   x  (Bt, L, D)  f32 or bf16       dt (Bt, L, D) f32
//   A  (D, N)      f32, already negated (A = -exp(A_log))
//   B, C (Bt, L, N) f32 or bf16
//   y  (Bt, L, D)  f32               h  (Bt, D, N) f32, the final state
//
// What bounds it on this card: per (b, t, d, n) one exponential and four
// other instructions (dt * A, the state FMA and its u * B, the FMA of h *
// C into y), against few bytes (x, dt and y once per (b, t, d), B and C
// once per (b, t, n)).  On the SFU (16 a clock per SM) the exponentials
// would be the bound; as the accurate expf (below) they are ~10 FMA-pipe
// instructions each, and the instruction issue (4 warp instructions a
// clock per SM) is.  The first version of this kernel ran at ~8x the SFU
// bound: its per-step y shuffles and one-lane store, and its synchronous
// staging, sat on every step's path (measured by
// repro_torch.kernels.ssm_variants, PERF.md).  This version:
//
// - Work split: a channel's N states are spread over LANES neighbouring
//   threads of one warp, SPL states each (SPL = 2 up to N = 32, else 4;
//   LANES = the power of two that holds N, both template parameters, so
//   that all index arithmetic is shifts and masks), held in f32 registers
//   for the whole sequence.  A block of 128 threads owns 128 / LANES
//   channels of one batch row: at falcon-mamba's shape (D = 8192, N = 16)
//   8 lanes, 512 blocks; at zamba2's (D = 4096, N = 64) 16 lanes, 512
//   blocks.  kMinBlocks = 6 caps registers at 80, so that more warps hide
//   the phases of a chunk.
// - The decay is expf(dt * A), CUDA's accurate expf (a polynomial on the
//   FMA pipe, <= 2 ulp).  ex2.approx.ftz(dt * (A * log2 e)), one FMUL and
//   one SFU op, is 20-26% faster (ssm_variants' ex2_decay build), but its
//   error per step compounds over the recurrence: y's largest error
//   against a float64 scan grows ~3x, past the plain float32 version's
//   and the first version's (PERF.md).
// - Staging: time runs in chunks of kChunk = 32 steps.  A chunk's B and C
//   (one contiguous span each), and its channels' x and dt, are copied by
//   cp.async into a two-slot ring, two chunks ahead of the walk, with zero
//   fill past L and past D; rows whose addresses do not allow 16- (or 4-)
//   byte copies are loaded by plain loads into the same ring.  Once a
//   chunk has landed, one pass widens it to f32 with vector stores: per
//   lane its B and C of each step side by side (one vector load per step
//   gives a lane both), per step the channels' (dt, u = dt * x).  Every
//   chunk is walked whole: past L, dt = x = B = C = 0, so h stays put.
// - y off the chain: each lane stores its per-step partial sum of h * C
//   into shared memory; after the walk of a chunk the block sums them
//   over each channel's lanes (four interleaved partial sums, each
//   thread starting at another lane so that a warp's loads fall in 32
//   banks) and stores y[t, d0 : d0 + chans] with neighbouring threads on
//   neighbouring channels.  No shuffle runs inside the step loop.
//
// Numerics: f32 throughout; expf for the decay; FMAs for the state update
// and the y sum.  Against the plain version the FMA contraction and the
// order of the N-way sum differ.  Every
// (b, d) is computed by the same instructions in the same order whatever
// Bt, D or its place in the grid (no split over L, nothing shared across
// blocks), so a row of a Bt = 2 launch is bitwise the Bt = 1 launch of
// that row.  Padding states (n >= N) see A = B = C = 0 and stay 0;
// padding channels (d >= D) see dt = x = 0 and are never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStatesPerLane = 4;
constexpr int kMaxState = 32 * kMaxStatesPerLane;
constexpr int kChunk = 32;
// blocks an SM that the register budget must allow: 80 registers, no
// spills (4 blocks, 128 registers, were faster at falcon-mamba's shape
// but spilled in other instantiations; PERF.md)
constexpr int kMinBlocks = 6;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// cp.async of U bytes, of which the first `valid` come from src and the
// rest are zero-filled (src is not read when valid is 0)
template <int U>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (U == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The widest copy unit (16 or 4 bytes, 0: plain loads) that every row of
// a strided copy allows: its start, the stride between rows and the row's
// length must all be multiples of it.
__device__ __forceinline__ int copy_unit(const void* start, size_t stride,
                                         size_t row) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(start);
  if (a % 16 == 0 && stride % 16 == 0 && row % 16 == 0) return 16;
  if (a % 4 == 0 && stride % 4 == 0 && row % 4 == 0) return 4;
  return 0;
}

// One span of `total` bytes (a multiple of U) from src to dst, of which
// the first `valid` are copied and the rest zero-filled.
template <int U>
__device__ __forceinline__ void copy_span(char* dst, const char* src,
                                          int total, int valid) {
  for (int off = threadIdx.x * U; off < total; off += kThreads * U) {
    const int v = min(max(valid - off, 0), U);
    cp_async<U>(dst + off, v > 0 ? src + off : src, v);
  }
}

// rows of 2^lg_units units of U bytes from src (rows `stride` bytes
// apart) to dst (packed); of row r the first valid_bytes(r) are copied,
// the rest zero-filled
template <int U, typename Valid>
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          size_t stride, int rows,
                                          int lg_units, Valid valid_bytes) {
  for (int i = threadIdx.x; i < (rows << lg_units); i += kThreads) {
    const int r = i >> lg_units;
    const int off = (i - (r << lg_units)) * U;
    const int v = min(max(valid_bytes(r) - off, 0), U);
    const char* s = src + r * stride + off;
    cp_async<U>(dst + (i * U), v > 0 ? s : src, v);
  }
}

// the same copies by plain loads, for rows that allow no 4-byte copies
template <typename T, typename Valid>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          size_t stride, int rows, int lg_n,
                                          Valid valid) {
  for (int i = threadIdx.x; i < (rows << lg_n); i += kThreads) {
    const int r = i >> lg_n;
    const int c = i - (r << lg_n);
    dst[i] = c < valid(r) ? src[r * stride + c] : zero<T>();
  }
}

// rows of 2^lg_n values of T; `unit` is copy_unit's answer for them
template <typename T, typename Valid>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           size_t stride, int rows, int lg_n,
                                           int unit, Valid valid) {
  const auto bytes = [&](int r) { return valid(r) * int(sizeof(T)); };
  constexpr int lg_size = sizeof(T) == 4 ? 2 : 1;
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  const size_t sb = stride * sizeof(T);
  if (unit == 16) {
    copy_rows<16>(d, s, sb, rows, lg_n + lg_size - 4, bytes);
  } else if (unit == 4) {
    copy_rows<4>(d, s, sb, rows, lg_n + lg_size - 2, bytes);
  } else {
    load_rows(dst, src, stride, rows, lg_n, valid);
  }
}

// one span of `total` bytes, `valid` of them from src
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int total,
                                           int valid, int unit) {
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  if (unit == 16) {
    copy_span<16>(d, s, total, valid);
  } else if (unit == 4) {
    copy_span<4>(d, s, total, valid);
  } else {
    for (int i = threadIdx.x; i < total / int(sizeof(T)); i += kThreads) {
      dst[i] = i * int(sizeof(T)) < valid ? src[i] : zero<T>();
    }
  }
}

template <int SPL>
__device__ __forceinline__ void store_bc(float* p, const float (&v)[2 * SPL]) {
  if constexpr (SPL == 1) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < SPL / 2; ++j) {
      reinterpret_cast<float4*>(p)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  }
}

template <int SPL>
__device__ __forceinline__ void load_bc(const float* p, float (&bc)[2 * SPL]) {
  if constexpr (SPL == 1) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    bc[0] = v.x; bc[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < SPL / 2; ++j) {
      const float4 v = reinterpret_cast<const float4*>(p)[j];
      bc[4 * j] = v.x; bc[4 * j + 1] = v.y;
      bc[4 * j + 2] = v.z; bc[4 * j + 3] = v.w;
    }
  }
}

// bytes of one ring slot's (B or C) span, rounded up to 16
__host__ __device__ constexpr int span_bytes(int N, int es) {
  return (kChunk * N * es + 15) / 16 * 16;
}

// floats of a lane's row of the widened B and C: kChunk steps of SPL B
// then SPL C values, padded by 16 bytes so that the lanes' rows start in
// other banks
__host__ __device__ constexpr int lane_stride(int spl) {
  return kChunk * 2 * spl + 4;
}

// bytes of shared memory a block uses, and of one ring slot
__host__ __device__ constexpr int slot_bytes(int N, int bc_size, int chans,
                                            int x_size) {
  return 2 * span_bytes(N, bc_size)
         + (kChunk * chans * x_size + 15) / 16 * 16 + kChunk * chans * 4;
}
__host__ __device__ constexpr int smem_bytes(int lanes, int spl, int N,
                                             int bc_size, int x_size) {
  return 4 * lanes * lane_stride(spl)                        // fBC
         + 8 * (kThreads / lanes) * kChunk                   // fDU
         + 4 * kChunk * kThreads                             // sP
         + 2 * slot_bytes(N, bc_size, kThreads / lanes, x_size);
}

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

template <typename TX, typename TBC, int SPL, int LANES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const TBC* __restrict__ Bm,
                const TBC* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ h_out, int L, int D, int N) {
  extern __shared__ float4 smem4[];
  constexpr int lanes = LANES;
  constexpr int lg_lanes = log2i(LANES);
  constexpr int lg_chans = log2i(kThreads) - lg_lanes;
  constexpr int chans = 1 << lg_chans;      // channels of this block
  // f32 buffers the walk reads (per lane its B and C, its row padded to
  // start in another bank; per step the channels' (dt, u)), then the
  // per-step partial sums of y
  constexpr int kStride = lane_stride(SPL);
  float* fBC = reinterpret_cast<float*>(smem4);    // [lanes][kStride]
  float2* fDU = reinterpret_cast<float2*>(fBC + lanes * kStride);  // [t][c]
  float* sP = reinterpret_cast<float*>(fDU + chans * kChunk);
  // the ring: two slots of raw B, C, x and dt as they are in memory
  const int sbc = span_bytes(N, sizeof(TBC));
  const int sx = (kChunk * chans * int(sizeof(TX)) + 15) / 16 * 16;
  const int slot = slot_bytes(N, sizeof(TBC), chans, sizeof(TX));
  char* ring = reinterpret_cast<char*>(sP + kChunk * kThreads);  // [t][tid]

  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);
  const int ch = tid / lanes;
  const int d0 = blockIdx.x * chans;
  const int d = d0 + ch;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * L;

  float a[SPL], h[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int n = lane * SPL + k;
    a[k] = (d < D && n < N) ? A[static_cast<size_t>(d) * N + n] : 0.0f;
    h[k] = 0.0f;
  }

  const TBC* bsrc = Bm + row0 * N;
  const TBC* csrc = Cm + row0 * N;
  const TX* xsrc = x + row0 * D + d0;
  const float* dsrc = dt + row0 * D + d0;
  const int span = kChunk * N * int(sizeof(TBC));
  const int ubc = min(copy_unit(bsrc, span, span), copy_unit(csrc, span,
                                                            span));
  const int ux = copy_unit(xsrc, size_t(D) * sizeof(TX), chans * sizeof(TX));
  const int udt = copy_unit(dsrc, size_t(D) * 4, chans * 4);
  const int dvalid = min(max(D - d0, 0), chans);

  // chunk t0 into ring slot (t0 / kChunk) & 1
  const auto issue_chunk = [&](int t0) {
    if (t0 >= L) return;
    const int steps = min(kChunk, L - t0);
    char* s = ring + ((t0 / kChunk) & 1) * slot;
    const auto row_ok = [&](int r) { return r < steps ? dvalid : 0; };
    // B and C: one contiguous span of steps * N values each
    const int valid = steps * N * int(sizeof(TBC));
    stage_span(reinterpret_cast<TBC*>(s), bsrc + size_t(t0) * N, sbc, valid,
               ubc);
    stage_span(reinterpret_cast<TBC*>(s + sbc), csrc + size_t(t0) * N, sbc,
               valid, ubc);
    stage_rows(reinterpret_cast<TX*>(s + 2 * sbc), xsrc + size_t(t0) * D, D,
               kChunk, lg_chans, ux, row_ok);
    stage_rows(reinterpret_cast<float*>(s + 2 * sbc + sx),
               dsrc + size_t(t0) * D, D, kChunk, lg_chans, udt, row_ok);
  };
  // the block's y for steps t0 .. t0 + min(kChunk, count) from sP: the
  // sum over a channel's lanes in four interleaved parts; each thread
  // starts at another lane (rot), so that a warp's loads hit 32 banks
  const int rot = ((tid & 31) * lanes) >> 5;
  const auto reduce_chunk = [&](int t0, int count) {
    const int steps = min(kChunk, count);
    constexpr int kOutputs = kChunk * chans;
#pragma unroll 4
    for (int j = 0; j < (kOutputs + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i >> lg_chans;
      const int c = i & (chans - 1);
      if (t >= steps) continue;
      const float* p = sP + t * kThreads + (c << lg_lanes);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < lanes; ++k) {
        part[k & 3] += p[(k + rot) & (lanes - 1)];
      }
      if (c < dvalid) {
        y[(row0 + t0 + t) * D + d0 + c] = (part[0] + part[1])
                                          + (part[2] + part[3]);
      }
    }
  };

  issue_chunk(0);
  cp_async_commit();
  issue_chunk(kChunk);
  cp_async_commit();
  const int nchunks = (L + kChunk - 1) / kChunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * kChunk;
    const int steps = min(kChunk, L - t0);
    const char* s = ring + (ci & 1) * slot;
    cp_async_wait_one();   // chunk ci has landed (ci + 1 may be in flight)
    __syncthreads();       // ... for every thread; the last walk is done
    if (ci > 0) reduce_chunk(t0 - kChunk, kChunk);
    {
      // B and C: per (step, lane) its SPL values of each, one vector store
      const TBC* rb = reinterpret_cast<const TBC*>(s);
      const TBC* rc = reinterpret_cast<const TBC*>(s + sbc);
#pragma unroll
      for (int j = 0; j < (kChunk * lanes + kThreads - 1) / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int t = i >> lg_lanes;
        const int l = i & (lanes - 1);
        float v[2 * SPL];
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const int n = l * SPL + k;
          const bool live = t < steps && n < N;
          v[k] = live ? to_f32(rb[t * N + n]) : 0.0f;
          v[SPL + k] = live ? to_f32(rc[t * N + n]) : 0.0f;
        }
        if (i < kChunk * lanes) {
          store_bc<SPL>(fBC + l * kStride + t * 2 * SPL, v);
        }
      }
      // x and dt: per (step, pair of channels) one vector store of
      // (dt, u = dt * x) twice
      const TX* rx = reinterpret_cast<const TX*>(s + 2 * sbc);
      const float* rd = reinterpret_cast<const float*>(s + 2 * sbc + sx);
      constexpr int kPairs = kChunk * chans / 2;
#pragma unroll 4
      for (int j = 0; j < (kPairs + kThreads - 1) / kThreads; ++j) {
        const int q = tid + j * kThreads;
        if (q < kPairs) {
          const float d0v = rd[2 * q], d1v = rd[2 * q + 1];
          reinterpret_cast<float4*>(fDU)[q] = make_float4(
              d0v, d0v * to_f32(rx[2 * q]), d1v, d1v * to_f32(rx[2 * q + 1]));
        }
      }
    }
    __syncthreads();       // the f32 chunk is ready; slot ci & 1 is free
    issue_chunk(t0 + 2 * kChunk);
    cp_async_commit();

    // every chunk is walked whole: past L, dt = x = B = C = 0, so the
    // decay is 1 and h does not change
    const float* bcp = fBC + lane * kStride;
    const float2* dup = fDU + ch;
#pragma unroll 8
    for (int t = 0; t < kChunk; ++t) {
      const float2 du = dup[t * chans];
      const float dtv = du.x, u = du.y;
      float bc[2 * SPL];
      load_bc<SPL>(bcp + t * 2 * SPL, bc);
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const float decay = expf(dtv * a[k]);
        h[k] = fmaf(decay, h[k], u * bc[k]);
        part = fmaf(h[k], bc[SPL + k], part);
      }
      sP[t * kThreads + tid] = part;
    }
  }
  __syncthreads();
  reduce_chunk((nchunks - 1) * kChunk, L - (nchunks - 1) * kChunk);

  if (d < D) {
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int n = lane * SPL + k;
      if (n < N) {
        h_out[(static_cast<size_t>(blockIdx.y) * D + d) * N + n] = h[k];
      }
    }
  }
}

template <typename TX, typename TBC, int SPL, int LANES>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* h, int Bt,
                   int L, int D, int N, cudaStream_t stream) {
  constexpr int chans = kThreads / LANES;
  const size_t smem = smem_bytes(LANES, SPL, N, sizeof(TBC), sizeof(TX));
  const auto kernel = ssm_scan_kernel<TX, TBC, SPL, LANES>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((D + chans - 1) / chans, Bt);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TBC*>(B),
      static_cast<const TBC*>(C), static_cast<float*>(y),
      static_cast<float*>(h), L, D, N);
  return cudaGetLastError();
}

// 2 states a lane up to N = 32, 4 past it; lanes = the power of two that
// holds N
template <typename TX, typename TBC>
cudaError_t launch_shape(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* h,
                         int Bt, int L, int D, int N, cudaStream_t stream) {
#define SSM_LAUNCH(spl, lanes) \
  launch<TX, TBC, spl, lanes>(x, dt, A, B, C, y, h, Bt, L, D, N, stream)
  if (N <= 2) return SSM_LAUNCH(2, 1);
  if (N <= 4) return SSM_LAUNCH(2, 2);
  if (N <= 8) return SSM_LAUNCH(2, 4);
  if (N <= 16) return SSM_LAUNCH(2, 8);
  if (N <= 32) return SSM_LAUNCH(2, 16);
  if (N <= 64) return SSM_LAUNCH(4, 16);
  return SSM_LAUNCH(4, 32);
#undef SSM_LAUNCH
}

}  // namespace

// x_bf16 / bc_bf16: 1 when x / (B, C) hold bf16, 0 when f32.  Returns a
// cudaError_t: cudaErrorInvalidValue for shapes the kernel does not take
// (the wrapper checks them first), else the launch's own error.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y, void* h,
                               int Bt, int L, int D, int N, int x_bf16,
                               int bc_bf16, void* stream) {
  if (Bt < 1 || Bt > 65535 || L < 1 || D < 1 || N < 1 || N > kMaxState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && bc_bf16) {
    err = launch_shape<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, y, h, Bt,
                                                   L, D, N, s);
  } else if (x_bf16) {
    err = launch_shape<__nv_bfloat16, float>(x, dt, A, B, C, y, h, Bt, L, D,
                                           N, s);
  } else if (bc_bf16) {
    err = launch_shape<float, __nv_bfloat16>(x, dt, A, B, C, y, h, Bt, L, D,
                                           N, s);
  } else {
    err = launch_shape<float, float>(x, dt, A, B, C, y, h, Bt, L, D, N, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
