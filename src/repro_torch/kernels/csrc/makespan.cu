// Population makespan: the BW-allocator event simulation (Algorithm 1 of
// the MAGMA paper) for every individual of a population, one warp each.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/makespan.py::_makespan_kernel (wrapper makespan_pallas).
// Its plain PyTorch version is repro_torch.core.bw_allocator.simulate_tables.
//
// Layout: qlat, qbw are (P, A, G) f32 per-queue-slot tables (row-major),
// count is (P, A) i32, bw_sys is one f32 in device memory (so that a
// caller holding it on the card never syncs), out is (P,) f32.  Warp p
// simulates individual p; lane a holds sub-accelerator a's remaining bytes,
// queue pointer and count (A <= 32, checked by the wrapper).  Each of the
// G events:
//   1. sums the live BW requests over the lanes (xor-butterfly shuffle);
//   2. throttles them by min(1, bw_sys / total);
//   3. takes dt = min(rem / alloc) with an argmin over the lanes whose ties
//      go to the lower lane (jnp.argmin's first-index rule);
//   4. drains rem by dt * alloc and advances the finishing lane's queue.
// Lanes >= A, and queues past their count, are inactive: they request 0 BW
// and report runtime _INF.  When no lane is active dt is 0 and no queue
// advances, as in the Pallas kernel.
//
// Every lane of a butterfly ends with the same bits (IEEE add is
// commutative), and an individual reads only its own rows, so its makespan
// does not depend on P or on where it sits in the launch.  The products
// and differences use __fmul_rn / __fsub_rn so that nvcc does not contract
// them into FMAs: the elementwise arithmetic then rounds exactly as the
// plain PyTorch version does; only the order of the A-way sum differs.
//
// What bounds it on this card: a chain of G dependent steps, each with two
// warp reductions (5 shuffles each) and a dependent load from global memory
// at the queue pointer.  That makes it latency-bound, far above its bytes
// bound (the 2*P*G*4 bytes of the queue slots it reads, an individual's
// counts summing to G, plus the counts).  Nothing faster is attempted yet: no
// staging of the tables in shared memory, no several individuals per warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTiny = 1e-30f;   // _TINY in makespan.py
constexpr float kInf = 3e38f;     // _INF in makespan.py
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// (value, lane) minimum; equal values keep the lower lane.
__device__ __forceinline__ void warp_argmin(float& v, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov < v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

__global__ void makespan_kernel(const float* __restrict__ qlat,
                                const float* __restrict__ qbw,
                                const int32_t* __restrict__ count,
                                const float* __restrict__ bw_sys_ptr,
                                float* __restrict__ out,
                                int P, int A, int G) {
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;  // uniform across the warp
  const float bw_sys = *bw_sys_ptr;

  const bool lane_ok = lane < A;
  const size_t row = (static_cast<size_t>(p) * A + (lane_ok ? lane : 0)) * G;
  const float* lat = qlat + row;
  const float* bw = qbw + row;
  const int cnt = lane_ok ? count[static_cast<size_t>(p) * A + lane] : 0;

  int ptr = 0;
  float rem = (ptr < cnt) ? __fmul_rn(lat[0], bw[0]) : 0.0f;
  float t = 0.0f;

  for (int step = 0; step < G; ++step) {
    const bool active = ptr < cnt;
    const float req = active ? bw[ptr] : 0.0f;
    const float total = warp_sum(req);
    const float scale = fminf(1.0f, __fdiv_rn(bw_sys, fmaxf(total, kTiny)));
    const float alloc = __fmul_rn(req, scale);
    float low = active ? __fdiv_rn(rem, fmaxf(alloc, kTiny)) : kInf;
    int fin = lane;
    warp_argmin(low, fin);
    const bool any_active = __any_sync(kFull, active);
    const float dt = any_active ? low : 0.0f;
    rem = fmaxf(__fsub_rn(rem, __fmul_rn(dt, alloc)), 0.0f);
    if (any_active && lane == fin) {
      ++ptr;
      rem = (ptr < cnt) ? __fmul_rn(lat[ptr], bw[ptr]) : 0.0f;
    }
    t = __fadd_rn(t, dt);
  }
  if (lane == 0) out[p] = t;
}

}  // namespace

extern "C" int makespan_launch(const float* qlat, const float* qbw,
                               const int32_t* count, const float* bw_sys,
                               float* out,
                               int P, int A, int G, void* stream) {
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  makespan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qlat, qbw, count, bw_sys, out, P, A, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* makespan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
