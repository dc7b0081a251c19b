// Blocked top-kp selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `block_topk` (_topk_kernel) of
// src/repro/kernels/topk/kernel.py.  For each (query, block_n-wide score
// block) it emits the block's top-kp (value, index) pairs in the TPU
// kernel's order: value descending, ties to the lower index.  Once only
// -inf remains (the ragged last block, a block narrower than kp, or a
// real -inf score), the TPU kernel's argmax lands on local index 0, so
// every such slot is (-inf, block base): this kernel writes exactly that.
//
// The TPU kernel runs kp rounds of "vector max, knock it out", which is
// cheap on its (8, 128) vector unit.  On Hopper the same rounds are kp
// dependent block-wide reductions, two barriers each.  This kernel does
// instead a radix select whose barrier count does not depend on kp:
//
//   1. Load the block's scores once, coalesced as 16-byte loads (thread t
//      holds local indices 4 (jv T + t) + s), and turn each into an
//      order-preserving uint32 key: -0.0 becomes +0.0 (the two compare
//      equal in the plain stable sort and in the TPU kernel), negatives
//      have all bits flipped, non-negatives the sign bit set.  Slots past
//      the block's width get key 0, below every real score (-inf's key is
//      0x007fffff; NaN is out of contract).
//   2. Find the kp-th largest key by MSD radix passes of 8 bits: a
//      256-bin histogram of the keys that share the prefix found so far,
//      then one warp scans it from the top.  At most 4 passes, 2 barriers
//      each; the loop stops once the prefix's bin holds exactly the keys
//      still needed.  On the serving path the scores are stage-1
//      accumulators, integer-valued and mostly 0.0, so one bin can hold
//      thousands of equal keys: every warp counts with __match_any_sync,
//      one shared-memory atomic per distinct digit, so a hot bin does not
//      serialise the block.
//   3. Keep every key above the threshold prefix, and of the keys equal
//      to it the ones of lowest index: a block-wide prefix sum (warp
//      scans, then one warp over the per-warp counts) ranks them in
//      index order.
//   4. Sort the <= kp survivors by the packed (key << 32 | ~index),
//      descending, by rank counting in shared memory, and write them.
//      Values are re-read from the row, so a -0.0 comes out as -0.0.
//
// About 12 barriers a block, whatever kp is.
//
// Bound on the H100: bytes.  The function reads the (Q, N) scores once
// (25.6 MB at the serving shape, ~7.6 us at 3.35 TB/s) and writes a few
// hundred KB.  What keeps this kernel above that floor is instructions
// per key (up to 4 histogram passes of a match, a ballot and an atomic),
// each pass closed by one warp's scan between two barriers; at
// block_n 4096, 4 blocks of 256 threads share an SM (64 registers a
// thread) to hide that latency.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int KP_MAX = 128;
constexpr int RADIX = 256;
constexpr int PASSES = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NEG_INF_KEY = 0x007fffffu;  // to_key(-inf)

__device__ __forceinline__ unsigned to_key(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;  // -0.0 ties with +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// VPT float4 vectors (4 VPT scores) per thread.
template <int VPT>
__global__ void __launch_bounds__(1024)
block_topk_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                  int* __restrict__ idxs, int N, int bn, int n_b, int kp) {
  constexpr int EPT = 4 * VPT;
  __shared__ int hist[PASSES][RADIX];
  __shared__ int wcount[VPT * 32];  // per (vector step, warp): keys equal
  __shared__ unsigned long long picked[KP_MAX];
  __shared__ unsigned s_prefix;
  __shared__ int s_need, s_done, s_above;

  const int q = blockIdx.x / n_b;
  const int b = blockIdx.x % n_b;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = T >> 5;
  const int base = b * bn;
  const int width = min(bn, N - base);  // real scores in this block
  const int k_sel = min(kp, width);     // pairs that are not past the width
  const float* row = scores + (long long)q * N + base;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;

  unsigned key[EPT];
#pragma unroll
  for (int jv = 0; jv < VPT; ++jv) {
    const int li = (jv * T + t) * 4;
    float x[4];
    if (vec && li + 3 < width) {
      const float4 f = *reinterpret_cast<const float4*>(row + li);
      x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) x[s] = li + s < width ? row[li + s] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      key[4 * jv + s] = li + s < width ? to_key(x[s]) : 0u;
  }
  for (int i = t; i < PASSES * RADIX; i += T) (&hist[0][0])[i] = 0;
  __syncthreads();

  // ---- radix select: the k_sel-th largest key ----
  unsigned prefix = 0;  // key >> shift of the threshold
  int need = k_sel;     // keys still to take from the prefix's bin
  int shift = 32;
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int s = 24 - 8 * pass;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const bool cand = pass == 0 || (key[e] >> shift) == prefix;
      if (__ballot_sync(FULL, cand) == 0u) continue;
      const unsigned digit = cand ? (key[e] >> s) & 0xffu : RADIX;
      const unsigned peers = __match_any_sync(FULL, digit);
      if (cand && lane == __ffs(peers) - 1)
        atomicAdd(&hist[pass][digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l scans bins 255 - 8l - i, i = 0..7: from the top down
      int c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[pass][RADIX - 1 - 8 * lane - i];
        sum += c[i];
      }
      const int incl = warp_inclusive_sum(sum, lane);
      int run = incl - sum;  // keys in the bins above this lane's
      if (run < need && need <= incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (run + c[i] >= need) {
            s_prefix = (prefix << 8) | (RADIX - 1 - 8 * lane - i);
            s_need = need - run;
            s_done = run + c[i] == need;
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    shift = s;
    if (s_done) break;
  }

  // ---- keep the keys above the prefix and the lowest-index equal ones ----
  int before[VPT];  // equal keys of this warp's lower lanes, per step
#pragma unroll
  for (int jv = 0; jv < VPT; ++jv) {
    int c = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) c += (key[4 * jv + s] >> shift) == prefix;
    const int incl = warp_inclusive_sum(c, lane);
    before[jv] = incl - c;
    if (lane == 31) wcount[jv * n_warps + warp] = incl;
  }
  if (t == 0) s_above = 0;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of wcount, in index order
    const int m = VPT * n_warps;
    const int per = (m + 31) / 32;
    const int lo = min(lane * per, m), hi = min(lo + per, m);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += wcount[i];
    int run = warp_inclusive_sum(sum, lane) - sum;
    for (int i = lo; i < hi; ++i) {
      const int c = wcount[i];
      wcount[i] = run;
      run += c;
    }
  }
  __syncthreads();
  const int n_above = k_sel - need;
#pragma unroll
  for (int jv = 0; jv < VPT; ++jv) {
    int rank = wcount[jv * n_warps + warp] + before[jv];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned k = key[4 * jv + s];
      const unsigned hi = k >> shift;
      int pos = -1;
      if (hi > prefix) {
        pos = atomicAdd(&s_above, 1);
      } else if (hi == prefix) {
        if (rank < need) pos = n_above + rank;
        ++rank;
      }
      if (pos >= 0) {
        const unsigned li = (unsigned)((jv * T + t) * 4 + s);
        picked[pos] = ((unsigned long long)k << 32) | (~li);
      }
    }
  }
  __syncthreads();

  // ---- sort the survivors (key descending, index ascending) and write ----
  float* out_v = vals + ((long long)q * n_b + b) * kp;
  int* out_i = idxs + ((long long)q * n_b + b) * kp;
  for (int i = t; i < k_sel; i += T) {
    const unsigned long long mine = picked[i];
    int rank = 0;
    for (int j = 0; j < k_sel; ++j) rank += picked[j] > mine;
    const int li = (int)(~(unsigned)mine);
    if ((unsigned)(mine >> 32) == NEG_INF_KEY) {
      out_v[rank] = -CUDART_INF_F;
      out_i[rank] = base;
    } else {
      out_v[rank] = row[li];
      out_i[rank] = base + li;
    }
  }
  for (int i = k_sel + t; i < kp; i += T) {  // rounds past the width
    out_v[i] = -CUDART_INF_F;
    out_i[i] = base;
  }
}

}  // namespace

extern "C" int block_topk_launch(void* scores, void* vals, void* idxs, int Q,
                                 int N, int bn, int n_b, int kp,
                                 void* stream) {
  if (kp < 1 || kp > KP_MAX || bn < 1 || bn > 32 * 1024)
    return (int)cudaErrorInvalidValue;
  const int ept = bn <= 16 * 1024 ? 16 : 32;
  int threads = 32;
  while (threads * ept < bn) threads <<= 1;
  const long long blocks = (long long)Q * n_b;
  if (blocks > 0) {
    if (ept == 16)
      block_topk_kernel<4><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
          (const float*)scores, (float*)vals, (int*)idxs, N, bn, n_b, kp);
    else
      block_topk_kernel<8><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
          (const float*)scores, (float*)vals, (int*)idxs, N, bn, n_b, kp);
  }
  return (int)cudaGetLastError();
}
