// EmbeddingBag (gather + bag reduce) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `embedding_bag_kernel` (_bag_kernel) of
// src/repro/kernels/embedding_bag/kernel.py.  For each bag b of a
// (B, L) int32 id matrix, -1 padded, it writes the sum of table[id] over
// the bag's non-padding slots, added left to right as the TPU kernel's
// grid does, or with `mean` that sum divided by max(count, 1).  A bag
// of padding only gives zeros.
//
// Design.  The TPU kernel rides the ids in SMEM by scalar prefetch and
// lets a BlockSpec fetch one (1, D) row per (bag, slot) grid step.  Here
// a group of `lpb` lanes of a warp owns one bag (several bags a warp when
// D is narrow); each lane owns VEC = 4 consecutive columns and reads
// them as one 16-byte float4 (VEC = 1 when D % 4 != 0 or the table is
// not 16-byte aligned), so a D = 32 row is one 128-byte transaction from
// 8 lanes.  Each lane reads the bag's ids itself (one broadcast load per
// slot for the group) and keeps its running sums in registers; nothing
// goes through shared memory.  ids must lie in [-1, V): the kernel does
// not check them.
//
// Bound on the H100: bytes, the gathered rows (count x D x 4 B) plus the
// ids (B x L x 4 B) plus the output (B x D x 4 B); at 262 144 full bags
// of 8 over a D = 32 table about 310 MB, 93 us at 3.35 TB/s.  Rows hit at
// random in a 128 MB table come from HBM in 128-byte pieces, so this
// kernel is latency-bound on its dependent id -> row loads.

#include <cuda_runtime.h>

namespace {

template <int VEC>
__global__ void bag_kernel(const float* __restrict__ table,
                           const int* __restrict__ ids,
                           float* __restrict__ out, long long B, int L,
                           int D, int lpb, int mean) {
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bag = gt / lpb;
  const int lane = (int)(gt % lpb);
  if (bag >= B) return;
  const int* bid = ids + bag * L;
  for (int c0 = lane * VEC; c0 < D; c0 += lpb * VEC) {
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
    int count = 0;
    for (int l = 0; l < L; ++l) {
      const int id = bid[l];
      if (id < 0) continue;
      ++count;
      const float* row = table + (long long)id * D + c0;
      if constexpr (VEC == 4) {
        const float4 x = *reinterpret_cast<const float4*>(row);
        acc[0] += x.x;
        acc[1] += x.y;
        acc[2] += x.z;
        acc[3] += x.w;
      } else {
        acc[0] += row[0];
      }
    }
    if (mean) {
      const float n = (float)max(count, 1);
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] = acc[c] / n;
    }
    float* dst = out + bag * D + c0;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      dst[0] = acc[0];
    }
  }
}

}  // namespace

// vec: 4 (D % 4 == 0 and 16-byte aligned table and output) or 1.
extern "C" int embedding_bag_launch(void* table, void* ids, void* out,
                                    long long B, int L, int D, int vec,
                                    int mean, void* stream) {
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (vec == 4 && D % 4 != 0) return (int)cudaErrorInvalidValue;
  int lpb = 1;  // lanes per bag: a power of two covering D / vec, <= 32
  while (lpb < 32 && lpb * vec < D) lpb <<= 1;
  const int threads = 256;
  const long long blocks = (B * lpb + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0 && D > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (vec == 4)
      bag_kernel<4><<<(unsigned)blocks, threads, 0, st>>>(
          (const float*)table, (const int*)ids, (float*)out, B, L, D, lpb,
          mean);
    else
      bag_kernel<1><<<(unsigned)blocks, threads, 0, st>>>(
          (const float*)table, (const int*)ids, (float*)out, B, L, D, lpb,
          mean);
  }
  return (int)cudaGetLastError();
}
