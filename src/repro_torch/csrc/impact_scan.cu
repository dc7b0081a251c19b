// JASS score-at-a-time impact accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `impact_scan` (_impact_kernel) of
// src/repro/kernels/impact_scan/kernel.py.  For each query q it adds the
// first rho[q] postings of the impact-ordered stream into a dense
// (Q, n_docs) float32 accumulator; padding postings (doc -1) are dropped.
//
// The TPU kernel is a blocked one-hot matmul over a (query, doc tile,
// posting block) grid, because that is what feeds the MXU and its VMEM
// carries the tile across the sequential posting axis.  Here a scatter
// is natural, and one block's shared memory (227 KB) holds a whole
// query's accumulator at the serving shape (50 000 docs, 200 KB):
//
//   * one thread block of 1024 threads owns one query's doc range, as
//     wide as MAX_TILE floats (224 KB of dynamic shared memory); a wider
//     range is split into near-equal tiles, each a block that reads the
//     query's stream again (the paper's 50 M docs, not the serving shape);
//   * the block zeroes its tile with 16-byte stores, reads the first
//     rho[q] postings once, coalesced, and atomicAdds the live ones into
//     shared memory;
//   * it then writes the tile once to the output as coalesced 16-byte
//     stores (every element, so rows with rho 0 or only padding get their
//     zeros).
//
// The TPU grid's doc tile (block_d) no longer shapes the work.  It stays
// the unit of the optional stats: per (query, block_d tile), the number
// of posting blocks that start below rho[q] and whose [seg_lo, seg_hi]
// doc range meets the tile, the predicate by which the TPU grid skips
// cells.  Each block counts them for the block_d tiles that start in its
// range.  The accumulation reads every posting below rho[q] and needs no
// segment bounds: skipping by them changes no sum.
//
// Bound on the H100: bytes.  At the serving shape (128 x 4096 postings,
// 50 000 docs) the function reads up to 4.2 MB of streams and writes the
// 25.6 MB accumulator, ~7.9 us at 3.35 TB/s; the dense write is the
// floor.  Each output element is written once and each posting read
// once; the atomics stay in shared memory.
//
// Exactness: impacts are 8-bit integers held in float32 and a stream has
// at most 4096 postings, so every partial sum is below 2^24 and exact in
// any order -- the result is bit-identical to the sequential scatter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_TILE = 56 * 1024;  // floats of one block's accumulator
constexpr int MAX_DEVICES = 64;      // devices whose opt-in is remembered

__global__ void __launch_bounds__(THREADS)
impact_scan_kernel(const int* __restrict__ docs,
                   const float* __restrict__ imps,
                   const int* __restrict__ rho,
                   const int* __restrict__ seg_lo,
                   const int* __restrict__ seg_hi, float* __restrict__ out,
                   int* __restrict__ stats, int P, int n_docs, int tile,
                   int n_t, int bp, int n_p, int bd, int n_d) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int q = blockIdx.x / n_t;
  const int lo = (blockIdx.x % n_t) * tile;  // a multiple of 4
  const int width = min(tile, n_docs - lo);
  const int t = threadIdx.x;

  for (int i = t; i < (width + 3) / 4; i += THREADS)
    acc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const int r = rho[q];
  const int stop = min(max(r, 0), P);
  const int* qdocs = docs + (long long)q * P;
  const float* qimps = imps + (long long)q * P;
  for (int i = t; i < stop; i += THREADS) {
    const int d = qdocs[i];
    if (d >= lo && d < lo + width) atomicAdd(&acc[d - lo], qimps[i]);
  }
  __syncthreads();

  float* qout = out + (long long)q * n_docs + lo;
  int head = 0;  // elements written as float4
  if ((reinterpret_cast<uintptr_t>(qout) & 15) == 0) {
    head = width / 4;
    float4* qout4 = reinterpret_cast<float4*>(qout);
    for (int i = t; i < head; i += THREADS) qout4[i] = acc4[i];
    head *= 4;
  }
  for (int i = head + t; i < width; i += THREADS) qout[i] = acc[i];

  if (stats != nullptr) {
    // the block_d tiles that start in [lo, lo + width).  n_docs + bd may
    // pass 2^31 but not 2^32, so the tile bounds divide as unsigned; the
    // doc bounds and the stats offset (Q * n_d may pass 2^31) are 64-bit
    const unsigned ubd = bd;
    const unsigned first = ((unsigned)lo + ubd - 1) / ubd;
    const unsigned last =
        min((unsigned)n_d, ((unsigned)lo + width + ubd - 1) / ubd);
    const int* qlo = seg_lo + (long long)q * n_p;
    const int* qhi = seg_hi + (long long)q * n_p;
    for (unsigned db = first + t; db < last; db += THREADS) {
      const long long base = (long long)db * bd;
      int live = 0;
      for (int pb = 0; pb < n_p; ++pb)
        live += pb * bp < r && qlo[pb] < base + bd && qhi[pb] >= base;
      stats[(long long)q * n_d + db] = live;
    }
  }
}

}  // namespace

extern "C" int impact_scan_launch(void* docs, void* imps, void* rho,
                                  void* seg_lo, void* seg_hi, void* out,
                                  void* stats, int Q, int P, int n_docs,
                                  int bp, int n_p, int bd, int n_d,
                                  void* stream) {
  if (n_docs < 1 || bd < 1) return (int)cudaErrorInvalidValue;
  // near-equal tiles, each a multiple of 4 floats and at most MAX_TILE
  // (a multiple of 4), none empty; in 64 bits, as n_docs nears 2^31
  const long long nd = n_docs;
  const long long n_t0 = (nd + MAX_TILE - 1) / MAX_TILE;
  const int tile = (int)(((nd + n_t0 - 1) / n_t0 + 3) / 4 * 4);
  const int n_t = (int)((nd + tile - 1) / tile);
  const size_t smem = (size_t)tile * sizeof(float);
  // opt in to MAX_TILE floats of shared memory once per device, not on
  // every launch (a driver call of host time before each kernel)
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || !opted_in[dev])) {
    e = cudaFuncSetAttribute(impact_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_TILE * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const long long blocks = (long long)Q * n_t;
  if (blocks > 0) {
    impact_scan_kernel<<<(unsigned)blocks, THREADS, smem,
                         (cudaStream_t)stream>>>(
        (const int*)docs, (const float*)imps, (const int*)rho,
        (const int*)seg_lo, (const int*)seg_hi, (float*)out, (int*)stats, P,
        n_docs, tile, n_t, bp, n_p, bd, n_d);
  }
  return (int)cudaGetLastError();
}
