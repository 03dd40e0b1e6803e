// Sketch bin-match counts for all (query, reference, k-mer length) triples.
//
// Replaces the Pallas TPU kernel poppunk_tpu/ops/pallas_jaccard.py::
// match_counts_pallas (body _match_kernel). For planes [n, K, P, Wp] of
// 32-bit words (P = b-bit planes, the first w32 words of each plane row
// useful, the rest zero padding) it writes int32 out[nq, nr, K]:
//
//     out[q, r, k] = 32 * w32 - sum_w popcount( OR_p (Q[q,k,p,w] ^ R[r,k,p,w]) )
//
// i.e. the number of sketch bins whose P-bit signatures agree. Pad words
// are zero in both operands, so they add no diff bits and the loop stops
// at the useful words (rounded up to a 16-byte chunk, which the caller
// guarantees lies inside Wp).
//
// What bounds it on an H100: not HBM. Once a tile of pairs is staged, each
// operand word is reused across the whole tile, and per (pair, word) the
// card executes P fused XOR-OR logic ops (LOP3), one popc and one add: it
// is bound by integer-ALU instruction throughput (popc runs at a quarter
// of the logic rate, but there is one per P logic ops). There is no
// tensor-core form: exact per-bin equality of P-bit signatures is not a
// low-rank product.
//
// What the design does about it:
//  - a block owns a 64 x 64 tile of (query, reference) pairs and loops over
//    k inside the block, so the tile's operands stay on chip for all of its
//    work and each pair's count for a k sits in a register until it is
//    written (the order a later fused correction + curve-fit epilogue
//    needs: the fit's normal-equation sums accumulate over k);
//  - the word axis is the reduction axis and is staged through shared
//    memory in 4-word (16-byte) chunks of all P plane rows of the 64 query
//    and 64 reference genomes, the way a GEMM stages its depth dimension;
//  - each of the 256 threads accumulates a 4 x 4 micro-tile of pairs over
//    4 words at a time (uint4 shared loads: 8 vector loads feed 64 x P
//    logic ops), so shared-memory traffic stays well under ALU work;
//  - ragged nq / nr edges are masked in the kernel (zero staging, no
//    store), so callers never pad.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;                          // queries per block tile
constexpr int TR = 64;                          // references per block tile
constexpr int MQ = 4;                           // queries per thread
constexpr int MR = 4;                           // references per thread
constexpr int GQ = TQ / MQ;                     // thread rows (16)
constexpr int GR = TR / MR;                     // thread columns (16)
constexpr int THREADS = GQ * GR;                // 256
constexpr int WC = 4;                           // words per staged chunk

__global__ void __launch_bounds__(THREADS)
match_counts_kernel(const uint4* __restrict__ q, const uint4* __restrict__ r,
                    int* __restrict__ out, int nq, int nr, int K, int P,
                    int wp4, int nchunks, int total_bits) {
  extern __shared__ uint4 smem[];
  uint4* sq = smem;             // [P][TQ]: one chunk of every plane row
  uint4* sr = smem + P * TQ;    // [P][TR]

  const int tid = threadIdx.x;
  const int tx = tid % GR;
  const int ty = tid / GR;
  const int q0 = blockIdx.y * TQ;
  const int r0 = blockIdx.x * TR;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int k = 0; k < K; ++k) {
    int cnt[MQ][MR];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MR; ++j) cnt[i][j] = 0;

    for (int c = 0; c < nchunks; ++c) {
      for (int idx = tid; idx < P * TQ; idx += THREADS) {
        const int p = idx / TQ;
        const int g = q0 + idx % TQ;
        sq[idx] = g < nq ? q[((size_t(g) * K + k) * P + p) * wp4 + c] : zero;
      }
      for (int idx = tid; idx < P * TR; idx += THREADS) {
        const int p = idx / TR;
        const int g = r0 + idx % TR;
        sr[idx] = g < nr ? r[((size_t(g) * K + k) * P + p) * wp4 + c] : zero;
      }
      __syncthreads();

      uint4 d[MQ][MR];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) d[i][j] = zero;

#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        uint4 rv[MR];
#pragma unroll
        for (int j = 0; j < MR; ++j) rv[j] = sr[p * TR + tx + j * GR];
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const uint4 qv = sq[p * TQ + ty + i * GQ];
#pragma unroll
          for (int j = 0; j < MR; ++j) {
            d[i][j].x |= qv.x ^ rv[j].x;
            d[i][j].y |= qv.y ^ rv[j].y;
            d[i][j].z |= qv.z ^ rv[j].z;
            d[i][j].w |= qv.w ^ rv[j].w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j)
          cnt[i][j] += __popc(d[i][j].x) + __popc(d[i][j].y) +
                       __popc(d[i][j].z) + __popc(d[i][j].w);
      __syncthreads();  // the next chunk overwrites sq / sr
    }

#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int gq = q0 + ty + i * GQ;
      if (gq >= nq) continue;
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        const int gr = r0 + tx + j * GR;
        if (gr < nr) out[(size_t(gq) * nr + gr) * K + k] = total_bits - cnt[i][j];
      }
    }
  }
}

}  // namespace

// planes_q int32/uint32 [nq, K, P, Wp], planes_r [nr, K, P, Wp], out int32
// [nq, nr, K], all contiguous on one device, 16-byte aligned. The caller
// guarantees Wp % 4 == 0, round_up(w32, 4) <= Wp, nq, nr > 0 and
// nq <= 65535 * 64. Returns cudaGetLastError() after the launch.
extern "C" int match_counts_launch(const void* planes_q, const void* planes_r,
                                   void* out, int nq, int nr, int K, int P,
                                   int Wp, int w32, void* stream) {
  const int nchunks = (w32 + WC - 1) / WC;
  const size_t smem = size_t(P) * (TQ + TR) * sizeof(uint4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        match_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((nr + TR - 1) / TR, (nq + TQ - 1) / TQ);
  match_counts_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(planes_q), static_cast<const uint4*>(planes_r),
      static_cast<int*>(out), nq, nr, K, P, Wp / 4, nchunks, 32 * w32);
  return int(cudaGetLastError());
}
