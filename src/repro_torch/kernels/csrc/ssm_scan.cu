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
// Work split: a channel's N states are spread over `lanes` neighbouring
// threads of one warp, kStatesPerLane = 4 states each, held in registers in
// f32 for the whole sequence (lanes = the power of two >= ceil(N / 4), so
// N <= 128).  A block of 128 threads owns 128 / lanes consecutive channels
// of one batch row: at falcon-mamba's N = 16 that is 4 lanes and 32
// channels a block, 256 blocks for D = 8192; at zamba2's N = 64, 16 lanes
// and 8 channels a block, 512 blocks for D = 4096.  Splitting N, rather than
// one thread per channel, is what fills the 132 SMs at batch 1.
//
// Time runs in chunks of kChunk steps.  For each chunk the block stages
// B_t, C_t (read by all of its channels) and its channels' x_t, dt_t in
// shared memory with coalesced loads, converting bf16 with
// __bfloat162float, then walks the chunk: each lane updates its 4 states,
// forms its part of y_t, and the group sums the parts with an xor
// butterfly of shuffles; the group's first lane stores y_t to global
// memory (the first lanes of a warp store neighbouring channels).  Padding
// states (n >= N) see A = B = C = 0 and stay 0; padding channels (d >= D)
// are never stored.
//
// Numerics: f32 throughout, expf (no fast math), FMAs as nvcc contracts
// them.  Against the plain version only the order of the N-way sum of y
// and the FMA contraction differ.  Every (b, d) is computed by the same
// instructions in the same order whatever Bt, D or its place in the grid,
// so a row of a Bt = 2 launch is bitwise the Bt = 1 launch of that row.
//
// What bounds it on this card: per (b, t, d, n) one expf and about 7 f32
// operations, against few bytes (x, dt, y once, A, B, C and h).  At the
// serving shapes the expf count on the SFU (16 a clock per SM) is the
// bound, above the bytes.  This first version is several times slower
// than that bound at batch 1 (PERF.md): each warp walks its steps one
// after another, and with 8 (N = 16) or 16 (N = 64) warps per SM the
// chain of a step (shared loads, expf, the state FMA, the shuffle sum)
// is not hidden.  Unrolling the walk and larger chunks changed little.
// Left for a later version: keeping a chunk's y parts in registers and
// summing them after the walk (shuffles off the chain), double-buffered
// staging, fewer states per lane for more warps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStatesPerLane = 4;
constexpr int kMaxState = 32 * kStatesPerLane;
constexpr int kChunk = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const TBC* __restrict__ Bm,
                const TBC* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ h_out, int L, int D, int N, int lanes) {
  extern __shared__ float4 smem4[];
  const int chans = kThreads / lanes;     // channels of this block
  const int np = lanes * kStatesPerLane;  // states padded to the lanes
  float* sB = reinterpret_cast<float*>(smem4);  // [kChunk][np]
  float* sC = sB + kChunk * np;                 // [kChunk][np]
  float* sX = sC + kChunk * np;                 // [kChunk][chans]
  float* sDt = sX + kChunk * chans;             // [kChunk][chans]

  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);
  const int ch = tid / lanes;
  const int d0 = blockIdx.x * chans;
  const int d = d0 + ch;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * L;

  float a[kStatesPerLane], h[kStatesPerLane];
#pragma unroll
  for (int k = 0; k < kStatesPerLane; ++k) {
    const int n = lane * kStatesPerLane + k;
    a[k] = (d < D && n < N) ? A[static_cast<size_t>(d) * N + n] : 0.0f;
    h[k] = 0.0f;
  }

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int steps = min(kChunk, L - t0);
    // unrolled so that a thread's global loads are in flight together
#pragma unroll 8
    for (int i = tid; i < kChunk * np; i += kThreads) {
      const int t = i / np;
      const int n = i - t * np;
      float bv = 0.0f, cv = 0.0f;
      if (t < steps && n < N) {
        const size_t off = (row0 + t0 + t) * N + n;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      sB[i] = bv;
      sC[i] = cv;
    }
#pragma unroll 8
    for (int i = tid; i < kChunk * chans; i += kThreads) {
      const int t = i / chans;
      const int c = i - t * chans;
      float xv = 0.0f, dv = 0.0f;
      if (t < steps && d0 + c < D) {
        const size_t off = (row0 + t0 + t) * D + d0 + c;
        xv = to_f32(x[off]);
        dv = dt[off];
      }
      sX[i] = xv;
      sDt[i] = dv;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = sDt[t * chans + ch];
      const float u = dtv * sX[t * chans + ch];
      const float4 b4 = reinterpret_cast<const float4*>(sB + t * np)[lane];
      const float4 c4 = reinterpret_cast<const float4*>(sC + t * np)[lane];
      const float bk[kStatesPerLane] = {b4.x, b4.y, b4.z, b4.w};
      const float ck[kStatesPerLane] = {c4.x, c4.y, c4.z, c4.w};
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < kStatesPerLane; ++k) {
        const float decay = expf(dtv * a[k]);
        h[k] = decay * h[k] + u * bk[k];
        part += h[k] * ck[k];
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        part += __shfl_xor_sync(kFull, part, off);
      }
      if (lane == 0 && d < D) y[(row0 + t0 + t) * D + d] = part;
    }
    __syncthreads();  // the next chunk's staging overwrites this one
  }

  if (d < D) {
#pragma unroll
    for (int k = 0; k < kStatesPerLane; ++k) {
      const int n = lane * kStatesPerLane + k;
      if (n < N) {
        h_out[(static_cast<size_t>(blockIdx.y) * D + d) * N + n] = h[k];
      }
    }
  }
}

template <typename TX, typename TBC>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* h, int Bt,
                   int L, int D, int N, int lanes, cudaStream_t stream) {
  const int chans = kThreads / lanes;
  const int np = lanes * kStatesPerLane;
  const dim3 grid((D + chans - 1) / chans, Bt);
  const size_t smem = sizeof(float) * (2 * kChunk * np + 2 * kChunk * chans);
  ssm_scan_kernel<TX, TBC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TBC*>(B),
      static_cast<const TBC*>(C), static_cast<float*>(y),
      static_cast<float*>(h), L, D, N, lanes);
  return cudaGetLastError();
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
  int lanes = 1;
  while (lanes * kStatesPerLane < N) lanes <<= 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && bc_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, y, h, Bt, L, D,
                                               N, lanes, s);
  } else if (x_bf16) {
    err = launch<__nv_bfloat16, float>(x, dt, A, B, C, y, h, Bt, L, D, N,
                                       lanes, s);
  } else if (bc_bf16) {
    err = launch<float, __nv_bfloat16>(x, dt, A, B, C, y, h, Bt, L, D, N,
                                       lanes, s);
  } else {
    err = launch<float, float>(x, dt, A, B, C, y, h, Bt, L, D, N, lanes, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
