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
// are zero in both operands and add no diff bits, so only the w32 useful
// words are read.
//
// What bounds it on an H100, and the design: match_counts_mainloop.cuh.
// This file describes the operand layout to it. Each k-mer length is one
// segment of one k slot, and the TMA walks the planes as the 4-D view
// {w32 words, n genomes, P planes, K} with the caller's strides:
// {K*P*Wp, Wp, P*Wp} words for the standard [n, K, P, Wp] layout, and
// {Wp, n*Wp, P*n*Wp} for the plane-major [K, P, n, Wp] layout a resident
// reference keeps (the reference's match_counts_pallas(plane_major=True)),
// so a row slice planes[:, :, s:s+c] of a resident tensor is read in place,
// with no copy. Putting genomes before planes in the view (their strides
// need not grow with the dimension) makes a stage land plane-major,
// [P][64][8 words], the same shared-memory layout as the packed kernel's,
// whatever the operand layout. The tensor map takes byte strides below
// 2^40: at 65,536 genomes and Wp 384 the plane-major plane stride is
// 100.7 MB and the k stride 1.41 GB, far inside it.

#include "match_counts_mainloop.cuh"

namespace {

__global__ void __launch_bounds__(mc::THREADS, 1)
match_counts_kernel(__grid_constant__ const CUtensorMap map_q,
                    __grid_constant__ const CUtensorMap map_r,
                    int* __restrict__ out, int nq, int nr, int K, int P,
                    int w32) {
  mc::mainloop<false>(&map_q, &map_r, out, nq, nr, K, K, 1, w32, P);
}

}  // namespace

// planes_q int32/uint32 with nq genomes and planes_r with nr genomes, each
// seen through its (genome, plane, k) strides in 32-bit words (multiples of
// 4, unit stride along the words), out int32 [nq, nr, K] contiguous, all on
// the current device, 16-byte aligned. The caller guarantees w32 <= Wp,
// nq, nr > 0, nq <= 65535 * 64 and P small enough for a 3-stage ring.
// Returns 0, the first CUDA error (cudaGetLastError() after the launch), or
// mc::ENCODE_ERROR + CUresult if the driver refused a tensor map.
extern "C" int match_counts_launch(const void* planes_q, const void* planes_r,
                                   void* out, int nq, int nr, int K, int P,
                                   int w32, long long qsn, long long qsp,
                                   long long qsk, long long rsn,
                                   long long rsp, long long rsk,
                                   void* stream) {
  CUtensorMap map_q, map_r;
  int err = mc::encode(&map_q, planes_q, w32, nq, P, K, qsn, qsp, qsk);
  if (!err) err = mc::encode(&map_r, planes_r, w32, nr, P, K, rsn, rsp, rsk);
  size_t smem = 0;
  if (!err) err = mc::ring_smem(match_counts_kernel, P, &smem);
  if (err) return err;
  const dim3 grid((nr + mc::TR - 1) / mc::TR, (nq + mc::TQ - 1) / mc::TQ);
  match_counts_kernel<<<grid, mc::THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      map_q, map_r, static_cast<int*>(out), nq, nr, K, P, w32);
  return int(cudaGetLastError());
}
