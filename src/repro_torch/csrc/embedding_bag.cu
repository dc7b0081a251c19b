// EmbeddingBag (gather + bag reduce) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `embedding_bag_kernel` (_bag_kernel) of
// src/repro/kernels/embedding_bag/kernel.py.  For each bag b of a
// (B, L) int32 id matrix, -1 padded, it writes the sum of table[id] over
// the bag's non-padding slots, added left to right as the TPU kernel's
// grid does, or with `mean` that sum divided by max(count, 1).  A bag
// of padding only gives zeros.  The table is float32 or bfloat16, and
// the output takes its type.  As the Pallas kernel accumulates in the
// output's type, a bfloat16 sum is rounded to bfloat16 after every
// slot's add (the add itself in float32), and `mean` divides by the
// count rounded to bfloat16, rounding the quotient: the plain version's
// bfloat16 arithmetic, step for step.
//
// Design.  The TPU kernel rides the ids in SMEM by scalar prefetch and
// lets a BlockSpec fetch one (1, D) row per (bag, slot) grid step.  Here
// a group of `lpb` lanes of a warp owns one bag (several bags a warp when
// D is narrow); each lane owns VEC consecutive columns and reads them
// as one 16-byte load (VEC = 4 float32 or 8 bfloat16 values; VEC = 1
// when D % VEC != 0 or the table is not 16-byte aligned), so a float32
// D = 32 row is one 128-byte transaction from 8 lanes.  Each lane reads the bag's ids itself (one broadcast load per
// slot for the group) and keeps its running sums in registers; nothing
// goes through shared memory.  ids must lie in [-1, V): the kernel does
// not check them.
//
// Bound on the H100: bytes, the gathered rows (count x D x element size)
// plus the ids (B x L x 4 B) plus the output (B x D x element size); at
// 262 144 full float32 bags
// of 8 over a D = 32 table about 310 MB, 93 us at 3.35 TB/s.  Rows hit at
// random in a 128 MB table come from HBM in 128-byte pieces, so this
// kernel is latency-bound on its dependent id -> row loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the accumulator holds only values of type T
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int VEC>
__global__ void bag_kernel(const T* __restrict__ table,
                           const int* __restrict__ ids,
                           T* __restrict__ out, long long B, int L, int D,
                           int lpb, int mean) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte or scalar");
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
      const T* row = table + (long long)id * D + c0;
      if constexpr (VEC == 1) {
        acc[0] = rnd<T>(acc[0] + to_f(row[0]));
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(row);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] = rnd<T>(acc[c] + to_f(x[c]));
      }
    }
    if (mean) {
      const float n = rnd<T>((float)max(count, 1));
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] = rnd<T>(acc[c] / n);
    }
    T* dst = out + bag * D + c0;
    if constexpr (VEC == 1) {
      dst[0] = from_f<T>(acc[0]);
    } else {
      uint4 raw;
      T* y = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int c = 0; c < VEC; ++c) y[c] = from_f<T>(acc[c]);
      *reinterpret_cast<uint4*>(dst) = raw;
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, void* out, long long B,
           int L, int D, int wide, int mean, cudaStream_t st) {
  constexpr int kWide = 16 / sizeof(T);
  const int vec = wide ? kWide : 1;
  if (wide && D % kWide != 0) return (int)cudaErrorInvalidValue;
  int lpb = 1;  // lanes per bag: a power of two covering D / vec, <= 32
  while (lpb < 32 && lpb * vec < D) lpb <<= 1;
  const int threads = 256;
  const long long blocks = (B * lpb + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0 && D > 0) {
    if (wide)
      bag_kernel<T, kWide><<<(unsigned)blocks, threads, 0, st>>>(
          (const T*)table, (const int*)ids, (T*)out, B, L, D, lpb, mean);
    else
      bag_kernel<T, 1><<<(unsigned)blocks, threads, 0, st>>>(
          (const T*)table, (const int*)ids, (T*)out, B, L, D, lpb, mean);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: 0 for a float32 table and output, 1 for bfloat16.  wide: 1 for
// 16-byte row reads (D a multiple of 16 / element size, table and
// output 16-byte aligned), else 0.
extern "C" int embedding_bag_launch(void* table, void* ids, void* out,
                                    long long B, int L, int D, int wide,
                                    int bf16, int mean, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(table, ids, out, B, L, D, wide, mean, st);
  return launch<float>(table, ids, out, B, L, D, wide, mean, st);
}
