// Sketch bin-match counts from packed-lane planes.
//
// Replaces the Pallas TPU kernel poppunk_tpu/ops/pallas_jaccard.py::
// match_counts_pallas_packed (body _match_kernel_packed). The operands are
// plane-major packed rows [KG, P, n, L] of 32-bit words
// (ops/match_counts.py::pack_lane_groups): group kg holds the k-mer lengths
// kg * G .. kg * G + G - 1, each as w32 useful words back to back, so k slot
// s of a row spans words [s * w32, (s + 1) * w32). It writes int32
// out[nq, nr, K]:
//
//     out[q, r, kg * G + s] = 32 * w32
//         - sum_{w in slot s} popcount( OR_p (Q[kg,p,q,w] ^ R[kg,p,r,w]) )
//
// the same counts as match_counts.cu; slots past K (the zero remainder of
// the last group) are not written.
//
// What bounds it on an H100: the same integer-ALU work as the standard
// kernel, per (pair, word) P fused XOR-OR ops (LOP3), one popc and one add.
// Packing saves no work here: the standard kernel already reads only the
// useful words of each k, so the TPU's reason for packing (128-lane
// padding, 312 -> 384 words) does not exist on this card.
//
// What the design does about the TPU kernel's devices:
//  - the per-k segment sums came from an f32 [TR, L] @ [L, G] matmul on the
//    MXU. Here the word loop is block-uniform and a slot's words are
//    contiguous, so each thread keeps ONE running count per pair and stores
//    it when the word index crosses the slot boundary: the same sums as G
//    accumulators per pair, with 16 registers at any G instead of 16 * G,
//    no float conversion and no matmul. The boundary test is per word, so a
//    16-byte chunk that straddles two slots (w32 = 2 * sketchsize64 is not a
//    multiple of 4 when sketchsize64 is odd) splits exactly;
//  - the balanced OR tree broke the TPU's serial plane chain. Here
//    `d |= q ^ r` is one LOP3, and a 4 x 4 pair micro-tile over a 4-word
//    chunk already gives each thread 64 independent chains, so the chain
//    stays;
//  - the loop covers the useful words of a row, rounded up to a 16-byte
//    chunk: G * w32, not the 128-lane padded L, and in a remainder group
//    only its (K mod G) * w32 words, not the zero slots past K;
//  - tiling as in match_counts.cu: a block owns 64 x 64 pairs and loops over
//    the KG groups; each 4-word chunk of all P plane rows of its 64 query and
//    64 reference genomes is staged in shared memory; ragged edges are
//    masked in the kernel.
// The kernel reads rows through the strides it is given, so a row slice of
// one packed reference tensor needs no copy. It allocates nothing and
// launches on the caller's stream.

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

__device__ __forceinline__ uint32_t word_of(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// strides are in uint4 (4-word) units: group, plane, genome row
__global__ void __launch_bounds__(THREADS)
match_counts_packed_kernel(const uint4* __restrict__ q,
                           const uint4* __restrict__ r, int* __restrict__ out,
                           int nq, int nr, int K, int KG, int P, int G,
                           int w32, long long qsg, long long qsp,
                           long long qsn, long long rsg, long long rsp,
                           long long rsn) {
  extern __shared__ uint4 smem[];
  uint4* sq = smem;             // [P][TQ]: one chunk of every plane row
  uint4* sr = smem + P * TQ;    // [P][TR]

  const int tid = threadIdx.x;
  const int tx = tid % GR;
  const int ty = tid / GR;
  const int q0 = blockIdx.y * TQ;
  const int r0 = blockIdx.x * TR;
  const int total_bits = 32 * w32;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int kg = 0; kg < KG; ++kg) {
    const uint4* qg = q + kg * qsg;
    const uint4* rg = r + kg * rsg;
    const int slots = min(G, K - kg * G);  // k slots of this group below K
    const int nchunks = (slots * w32 + WC - 1) / WC;
    int cnt[MQ][MR];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MR; ++j) cnt[i][j] = 0;
    int slot = 0;          // k slot of the running counts
    int slot_end = w32;    // first word of the next slot

    // store the running counts as slot `slot` of group kg, then reset
    auto flush = [&]() {
      const int k = kg * G + slot;
      if (slot < G && k < K) {
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const int gq = q0 + ty + i * GQ;
#pragma unroll
          for (int j = 0; j < MR; ++j) {
            const int gr = r0 + tx + j * GR;
            if (gq < nq && gr < nr)
              out[(size_t(gq) * nr + gr) * K + k] = total_bits - cnt[i][j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) cnt[i][j] = 0;
    };

    for (int c = 0; c < nchunks; ++c) {
      for (int idx = tid; idx < P * TQ; idx += THREADS) {
        const int p = idx / TQ;
        const int g = q0 + idx % TQ;
        sq[idx] = g < nq ? qg[p * qsp + g * qsn + c] : zero;
      }
      for (int idx = tid; idx < P * TR; idx += THREADS) {
        const int p = idx / TR;
        const int g = r0 + idx % TR;
        sr[idx] = g < nr ? rg[p * rsp + g * rsn + c] : zero;
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
      for (int e = 0; e < WC; ++e) {
        if (c * WC + e == slot_end) {  // the same word for every thread
          flush();
          ++slot;
          slot_end += w32;
        }
#pragma unroll
        for (int i = 0; i < MQ; ++i)
#pragma unroll
          for (int j = 0; j < MR; ++j) cnt[i][j] += __popc(word_of(d[i][j], e));
      }
      __syncthreads();  // the next chunk overwrites sq / sr
    }
    flush();  // the last slot (a no-op once the loop ran past K)
  }
}

}  // namespace

// q int32/uint32 [KG, P, nq, L] and r [KG, P, nr, L] with the given strides
// in 32-bit words (all multiples of 4, unit stride along L), out int32
// [nq, nr, K] contiguous, all on one device, 16-byte aligned. The caller
// guarantees round_up(G * w32, 4) <= L, KG = ceil(K / G), nq, nr > 0 and
// nq <= 65535 * 64. Returns cudaGetLastError() after the launch.
extern "C" int match_counts_packed_launch(
    const void* q, const void* r, void* out, int nq, int nr, int K, int KG,
    int P, int G, int w32, long long qsg, long long qsp, long long qsn,
    long long rsg, long long rsp, long long rsn, void* stream) {
  const size_t smem = size_t(P) * (TQ + TR) * sizeof(uint4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        match_counts_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((nr + TR - 1) / TR, (nq + TQ - 1) / TQ);
  match_counts_packed_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(r),
      static_cast<int*>(out), nq, nr, K, KG, P, G, w32, qsg / 4, qsp / 4,
      qsn / 4, rsg / 4, rsp / 4, rsn / 4);
  return int(cudaGetLastError());
}
