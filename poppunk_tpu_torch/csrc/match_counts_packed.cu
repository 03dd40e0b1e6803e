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
// kernel, per (pair, word) P fused XOR-OR ops (LOP3), one popc and half an
// add. Packing saves no work here: the standard kernel already reads only
// the useful words of each k, so the TPU's reason for packing (128-lane
// padding, 312 -> 384 words) does not exist on this card.
//
// The design (match_counts_mainloop.cuh) is the standard kernel's; this
// file describes the packed layout to it. A group is one segment, seen by
// the TMA as the 4-D view {G * w32 words, n rows, P planes, KG} with the
// caller's strides, so a row slice of one packed reference tensor needs no
// copy. What the TPU kernel did with devices of its own:
//  - the per-k segment sums came from an f32 [TR, L] @ [L, G] matmul on the
//    MXU. Here the word loop is block-uniform and a slot's words are
//    contiguous, so each thread keeps ONE running count per pair and stores
//    it when the word index crosses the slot boundary: 16 counters at any
//    G, no float and no matmul. The test is per word, so a stage that
//    straddles two slots (w32 = 2 * sketchsize64 is not a multiple of 8 in
//    general) splits exactly;
//  - only the useful words are read: the view ends at G * w32 (the TMA
//    returns zeros past it, in place of the 128-lane pad), and a remainder
//    group stops at its (K mod G) * w32 words, not at the zero slots past K.

#include "match_counts_mainloop.cuh"

namespace {

__global__ void __launch_bounds__(mc::THREADS, 1)
match_counts_packed_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_r,
                           int* __restrict__ out, int nq, int nr, int K,
                           int KG, int P, int G, int w32) {
  mc::mainloop<true>(&map_q, &map_r, out, nq, nr, K, KG, G, w32, P);
}

}  // namespace

// q int32/uint32 [KG, P, nq, L] and r [KG, P, nr, L] with the given strides
// in 32-bit words (all multiples of 4, unit stride along L), out int32
// [nq, nr, K] contiguous, all on the current device, 16-byte aligned. The
// caller guarantees G * w32 <= L, KG = ceil(K / G), nq, nr > 0,
// nq <= 65535 * 64 and P small enough for a 3-stage ring. Returns 0, the
// first CUDA error (cudaGetLastError() after the launch), or
// mc::ENCODE_ERROR + CUresult if the driver refused a tensor map.
extern "C" int match_counts_packed_launch(
    const void* q, const void* r, void* out, int nq, int nr, int K, int KG,
    int P, int G, int w32, long long qsg, long long qsp, long long qsn,
    long long rsg, long long rsp, long long rsn, void* stream) {
  const long long words = (long long)G * w32;
  CUtensorMap map_q, map_r;
  int err = mc::encode(&map_q, q, words, nq, P, KG, qsn, qsp, qsg);
  if (!err) err = mc::encode(&map_r, r, words, nr, P, KG, rsn, rsp, rsg);
  size_t smem = 0;
  if (!err) err = mc::ring_smem(match_counts_packed_kernel, P, &smem);
  if (err) return err;
  const dim3 grid((nr + mc::TR - 1) / mc::TR, (nq + mc::TQ - 1) / mc::TQ);
  match_counts_packed_kernel<<<grid, mc::THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      map_q, map_r, static_cast<int*>(out), nq, nr, K, KG, P, G, w32);
  return int(cudaGetLastError());
}
