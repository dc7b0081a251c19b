// JASS score-at-a-time impact accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `impact_scan` (_impact_kernel) of
// src/repro/kernels/impact_scan/kernel.py.  For each query q it adds the
// first rho[q] postings of the impact-ordered stream into a dense
// (Q, n_docs) float32 accumulator; padding postings (doc -1) are dropped.
//
// The TPU kernel is a blocked one-hot matmul because that is what feeds
// the MXU.  Here a scatter is natural: one thread block owns one
// (query, doc tile) cell of the output.  It zeroes a shared-memory tile,
// walks the query's live posting blocks -- those with pb*bp < rho[q]
// whose [seg_lo, seg_hi] doc range meets the tile, the same predicate the
// TPU grid evaluates -- and atomicAdds the in-tile impacts into shared
// memory.  It then writes the tile once, coalesced, and (optionally) the
// count of live posting blocks it ran, which is the TPU kernel's stats.
//
// Bound on the H100: bytes.  At the serving shape (128 x 4096 postings,
// 50 000 docs) the kernel reads ~4.2 MB of streams and writes the 25.6 MB
// accumulator; the dense write is the floor.  Each block re-reads its
// query's live postings (every doc tile rereads the stream), but the
// streams total 4.2 MB and stay in the 50 MB L2, so the rereads cost L2
// bandwidth, not HBM.  Design choices for that: one write of each output
// element (no memset + global atomics), atomics only in shared memory.
//
// Exactness: impacts are 8-bit integers held in float32 and a stream has
// at most 4096 postings, so every partial sum is below 2^24 and exact in
// any order -- the result is bit-identical to the sequential scatter.

#include <cuda_runtime.h>

namespace {

__global__ void impact_scan_kernel(const int* __restrict__ docs,
                                   const float* __restrict__ imps,
                                   const int* __restrict__ rho,
                                   const int* __restrict__ seg_lo,
                                   const int* __restrict__ seg_hi,
                                   float* __restrict__ out,
                                   int* __restrict__ stats,
                                   int P, int n_docs, int bp, int n_p,
                                   int bd, int n_d) {
  extern __shared__ float tile[];
  const int q = blockIdx.x / n_d;
  const int db = blockIdx.x % n_d;
  const int base = db * bd;
  for (int i = threadIdx.x; i < bd; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();

  const int r = rho[q];
  const int* qdocs = docs + (long long)q * P;
  const float* qimps = imps + (long long)q * P;
  int live_blocks = 0;
  for (int pb = 0; pb < n_p; ++pb) {
    const int start = pb * bp;
    // the TPU grid's live predicate, uniform across the block
    const bool live = start < r && seg_lo[q * n_p + pb] < base + bd &&
                      seg_hi[q * n_p + pb] >= base;
    if (!live) continue;
    ++live_blocks;
    int stop = start + bp;
    if (stop > P) stop = P;
    if (stop > r) stop = r;
    for (int i = start + threadIdx.x; i < stop; i += blockDim.x) {
      const int d = qdocs[i] - base;
      if (qdocs[i] >= 0 && d >= 0 && d < bd) atomicAdd(&tile[d], qimps[i]);
    }
  }
  __syncthreads();

  float* qout = out + (long long)q * n_docs;
  int width = n_docs - base;
  if (width > bd) width = bd;
  for (int i = threadIdx.x; i < width; i += blockDim.x) qout[base + i] = tile[i];
  if (stats != nullptr && threadIdx.x == 0) stats[q * n_d + db] = live_blocks;
}

}  // namespace

extern "C" int impact_scan_launch(void* docs, void* imps, void* rho,
                                  void* seg_lo, void* seg_hi, void* out,
                                  void* stats, int Q, int P, int n_docs,
                                  int bp, int n_p, int bd, int n_d,
                                  void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)bd * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        impact_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)Q * n_d;
  if (blocks > 0) {
    impact_scan_kernel<<<(unsigned)blocks, threads, smem,
                         (cudaStream_t)stream>>>(
        (const int*)docs, (const float*)imps, (const int*)rho,
        (const int*)seg_lo, (const int*)seg_hi, (float*)out, (int*)stats, P,
        n_docs, bp, n_p, bd, n_d);
  }
  return (int)cudaGetLastError();
}
