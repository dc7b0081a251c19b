// Blocked top-kp selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `block_topk` (_topk_kernel) of
// src/repro/kernels/topk/kernel.py.  For each (query, block_n-wide score
// block) it emits the block's top-kp (value, index) pairs in the TPU
// kernel's order: kp rounds of "max value, lowest index among the maxima,
// knock it out".  Once only -inf remains (the ragged last block is -inf
// padded, and knocked-out entries are -inf), every further round of the
// TPU kernel yields (-inf, block base): this kernel writes exactly that.
//
// Design: one thread block per (query, score block).  Each thread keeps
// 32 scores of the block in registers (element j of thread t is local
// index j*T + t, so loads are coalesced) and caches its own best pair.
// A round is one block-wide argmax over the cached pairs (warp shuffles,
// then one warp over the per-warp winners); only the thread that owned
// the winner knocks it out and rescans its 32 registers.
//
// Bound on the H100: the function needs one read of the (Q, N) scores
// (25.6 MB at the serving shape, ~7.6 us at 3.35 TB/s) and a few hundred
// KB of output, so its floor is bytes.  This kernel is not at that floor:
// kp rounds of a dependent block reduction (two barriers each) make it
// latency- and instruction-bound at kp = 100.  A radix select or a
// bitonic sort of packed (score, -index) keys would cut the rounds; that
// is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int EPT = 32;  // scores held per thread

struct Pair {
  float v;
  int i;
};

__device__ __forceinline__ bool better(const Pair& a, const Pair& b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ Pair warp_best(Pair p) {
  for (int off = 16; off > 0; off >>= 1) {
    Pair o;
    o.v = __shfl_down_sync(0xffffffffu, p.v, off);
    o.i = __shfl_down_sync(0xffffffffu, p.i, off);
    if (better(o, p)) p = o;
  }
  return p;
}

__global__ void block_topk_kernel(const float* __restrict__ scores,
                                  float* __restrict__ vals,
                                  int* __restrict__ idxs, int N, int bn,
                                  int n_b, int kp) {
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ float res_v;
  __shared__ int res_i;

  const int q = blockIdx.x / n_b;
  const int b = blockIdx.x % n_b;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = T >> 5;
  const int base = b * bn;
  int width = N - base;  // real scores in this block; the rest is -inf
  if (width > bn) width = bn;
  const float* row = scores + (long long)q * N + base;

  float v[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int li = j * T + t;
    v[j] = li < width ? row[li] : -CUDART_INF_F;
  }
  Pair mine = {-CUDART_INF_F, 0x7fffffff};
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const Pair c = {v[j], j * T + t};
    if (better(c, mine)) mine = c;
  }

  float* out_v = vals + ((long long)q * n_b + b) * kp;
  int* out_i = idxs + ((long long)q * n_b + b) * kp;
  for (int r = 0; r < kp; ++r) {
    Pair w = warp_best(mine);
    if (lane == 0) {
      wv[warp] = w.v;
      wi[warp] = w.i;
    }
    __syncthreads();
    if (warp == 0) {
      Pair p = {-CUDART_INF_F, 0x7fffffff};
      if (lane < n_warps) {
        p.v = wv[lane];
        p.i = wi[lane];
      }
      p = warp_best(p);
      if (lane == 0) {
        res_v = p.v;
        res_i = p.i;
      }
    }
    __syncthreads();
    const float rv = res_v;
    const int ri = res_i;
    if (rv == -CUDART_INF_F) {
      // only -inf left: the TPU kernel's argmax is then local index 0
      for (int j = r + t; j < kp; j += T) {
        out_v[j] = -CUDART_INF_F;
        out_i[j] = base;
      }
      break;
    }
    if (t == 0) {
      out_v[r] = rv;
      out_i[r] = base + ri;
    }
    if (ri % T == t) {
      const int jw = ri / T;
      mine.v = -CUDART_INF_F;
      mine.i = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        if (j == jw) v[j] = -CUDART_INF_F;
        const Pair c = {v[j], j * T + t};
        if (better(c, mine)) mine = c;
      }
    }
  }
}

}  // namespace

extern "C" int block_topk_launch(void* scores, void* vals, void* idxs, int Q,
                                 int N, int bn, int n_b, int kp,
                                 void* stream) {
  int threads = 32;
  while (threads * EPT < bn && threads < 1024) threads <<= 1;
  if (threads * EPT < bn) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)Q * n_b;
  if (blocks > 0) {
    block_topk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)scores, (float*)vals, (int*)idxs, N, bn, n_b, kp);
  }
  return (int)cudaGetLastError();
}
