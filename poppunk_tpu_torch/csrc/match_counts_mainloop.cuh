// The main loop of both sketch bin-match count kernels (match_counts.cu and
// match_counts_packed.cu): an asynchronous staging ring fed by the Tensor
// Memory Accelerator (TMA), and per-thread XOR-OR-popcount over a 4 x 4
// pair micro-tile.
//
// Both kernels see their operands through one 4-D view, innermost first:
//
//     {words of a segment row, genome rows, planes, segments}
//
// A segment is one k-mer length (standard layout [n, K, P, Wp]; G = 1) or
// one group of G k-mer lengths packed back to back (packed layout
// [KG, P, n, L]). Each launch function describes its layout to the TMA with
// a tensor map over that view, so the two kernels differ only in the map and
// in where a k slot ends.
//
// What bounds it on an H100: integer issue, not HBM. Per (pair, word) the
// card runs P fused XOR-OR logic ops (LOP3, 64 a clock per SM), one popc
// and half an add; device memory moves each operand about once per wave of
// blocks, ~1 GB per call at 2048 x 4096 x K 6, a fraction of a millisecond.
//
// What the design does about it:
//  - a ring of STAGES (3) buffers in shared memory, each holding one
//    32-byte sector (8 words) of every plane row of the block's 64 query and
//    64 reference genomes. Thread 0 keeps the ring full with one TMA copy
//    per operand per stage, completion counted on a "full" mbarrier; the 8
//    warps wait on it once per stage, compute, and release the buffer
//    through an "empty" mbarrier, one arrive per warp, after which thread 0
//    refills it with the stage STAGES ahead. Copies of the next stages
//    overlap the logic ops on this one, and no thread spends integer
//    instructions on staging addresses: the TMA computes them, and fills
//    rows past n and words past the segment with zeros (the ragged edges
//    need no masking). There is no separate producer warp: a 9th warp
//    would put 3 warps on one of the SM's 4 register banks and cap every
//    thread at 168 registers, where the micro-tile spills;
//  - the TMA box is {8 words, 64 rows, P planes, 1}, so a stage lands as
//    [P][64 rows][8 words], written with the 32-byte swizzle: the 16-byte
//    half h of row g sits at half h ^ (bit 2 of g). Eight neighbouring rows'
//    uint4 reads then hit eight distinct bank groups;
//  - each of the 256 consumer threads owns a 4 x 4 micro-tile of pairs and
//    walks a stage in two 4-word halves: per plane 8 uint4 shared loads
//    feed 64 LOP3 (2 per word loaded), and each pair's count for the current
//    k slot stays in a register until it is written;
//  - the packed kernel's k slots end inside a stage (w32 = 2 * sketchsize64
//    need not be a multiple of 8); the word loop is block-uniform, so a
//    half that holds a slot boundary is counted word by word and the running
//    counts are flushed exactly there. The standard kernel's slots end with
//    their segment.
// The kernels allocate nothing and launch on the caller's stream.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace mc {

constexpr int TQ = 64;                   // queries per block tile
constexpr int TR = 64;                   // references per block tile
constexpr int MQ = 4;                    // queries per thread
constexpr int MR = 4;                    // references per thread
constexpr int GQ = TQ / MQ;              // consumer thread rows (16)
constexpr int GR = TR / MR;              // consumer thread columns (16)
constexpr int THREADS = GQ * GR;         // 256: 8 warps
constexpr int WORDS = 8;                 // words per stage: one sector per row
constexpr int STAGES = 3;                // ring depth
constexpr int ALIGN = 1024;              // stage buffers' alignment (swizzle)
constexpr int ENCODE_ERROR = 10000;      // + CUresult of a refused tensor map

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// one TMA box {WORDS, 64, P, 1} at (word, row, 0, segment) into shared `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int word, int row,
                                         int seg) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(word), "r"(row),
      "r"(0), "r"(seg) : "memory");
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Counts for the block's 64 x 64 pairs over `nseg` segments. Segment `seg`
// holds min(G, K - seg * G) k slots of w32 words each; slot s of segment seg
// is k-mer length seg * G + s. kSlotFlush: slots may end inside a stage
// (packed); otherwise a segment is one slot (standard, G = 1).
template <bool kSlotFlush>
__device__ __forceinline__ void mainloop(const CUtensorMap* map_q,
                                         const CUtensorMap* map_r,
                                         int* __restrict__ out, int nq, int nr,
                                         int K, int nseg, int G, int w32,
                                         int P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + ALIGN - 1) & ~uint32_t(ALIGN - 1)) - raw);
  const uint32_t q_bytes = uint32_t(P) * TQ * WORDS * 4;
  const uint32_t stage_bytes = uint32_t(P) * (TQ + TR) * WORDS * 4;
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + STAGES * stage_bytes;  // mbarriers, 8 B each
  const uint32_t empty = full + STAGES * 8;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * TQ;
  const int r0 = blockIdx.x * TR;

  // thread 0 loads stages in order; (pseg, pc) is the next one's segment
  // and 8-word chunk
  int pseg = 0, pc = 0;
  auto load_next = [&](int stage) {
    const uint32_t bar = full + 8 * stage;
    const uint32_t dst = ring + stage * stage_bytes;
    mbar_expect_tx(bar, stage_bytes);
    tma_load(dst, map_q, bar, pc * WORDS, q0, pseg);
    tma_load(dst + q_bytes, map_r, bar, pc * WORDS, r0, pseg);
    if (++pc * WORDS >= min(G, K - pseg * G) * w32) {
      pc = 0;
      ++pseg;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(map_q)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(map_r)) : "memory");
    for (int s = 0; s < STAGES && pseg < nseg; ++s) load_next(s);
  }
  __syncthreads();

  const int tx = tid % GR;
  const int ty = tid / GR;
  // the 32-byte swizzle moves half h of row g to h ^ (bit 2 of g); a
  // thread's rows ty + i * GQ (tx + j * GR) all share bit 2
  const int swq = (ty >> 2) & 1;
  const int swr = (tx >> 2) & 1;
  const int total_bits = 32 * w32;
  int s = 0;
  uint32_t phase = 0;

  for (int seg = 0; seg < nseg; ++seg) {
    const int words = min(G, K - seg * G) * w32;
    int cnt[MQ][MR];  // each pair's diff bits in the current k slot
    auto reset = [&]() {
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) cnt[i][j] = 0;
    };
    reset();
    int slot = 0;         // k slot of the running counts
    int slot_end = w32;   // first word of the next slot

    // store the running counts as slot `slot` of this segment, then reset
    auto flush = [&]() {
      const int k = seg * G + slot;
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
      reset();
    };

    for (int c = 0; c * WORDS < words; ++c) {
      mbar_wait(full + 8 * s, phase);
      const uint4* sq = reinterpret_cast<const uint4*>(smem + s * stage_bytes);
      const uint4* sr =
          reinterpret_cast<const uint4*>(smem + s * stage_bytes + q_bytes);
#pragma unroll 1  // unrolled, the standard kernel needs 255 registers
      for (int h = 0; h < 2; ++h) {
        // uint4 index of (plane p, row g, half h): (p * T + g) * 2 + h'
        const uint4* q_half = sq + ty * 2 + (h ^ swq);
        const uint4* r_half = sr + tx * 2 + (h ^ swr);
        uint4 d[MQ][MR];
        {
          uint4 rv[MR];
#pragma unroll
          for (int j = 0; j < MR; ++j) rv[j] = r_half[j * GR * 2];
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            const uint4 qv = q_half[i * GQ * 2];
#pragma unroll
            for (int j = 0; j < MR; ++j) {
              d[i][j].x = qv.x ^ rv[j].x;
              d[i][j].y = qv.y ^ rv[j].y;
              d[i][j].z = qv.z ^ rv[j].z;
              d[i][j].w = qv.w ^ rv[j].w;
            }
          }
        }
#pragma unroll 2
        for (int p = 1; p < P; ++p) {
          uint4 rv[MR];
#pragma unroll
          for (int j = 0; j < MR; ++j) rv[j] = r_half[(p * TR + j * GR) * 2];
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            const uint4 qv = q_half[(p * TQ + i * GQ) * 2];
#pragma unroll
            for (int j = 0; j < MR; ++j) {
              d[i][j].x |= qv.x ^ rv[j].x;
              d[i][j].y |= qv.y ^ rv[j].y;
              d[i][j].z |= qv.z ^ rv[j].z;
              d[i][j].w |= qv.w ^ rv[j].w;
            }
          }
        }
        const int word0 = c * WORDS + h * 4;
        if (kSlotFlush && slot_end - word0 < 4) {
          // a slot ends inside these 4 words (the same for every thread):
          // count word by word, flushing at the boundary
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (word0 + e == slot_end) {  // the same word for every thread
              flush();
              ++slot;
              slot_end += w32;
            }
#pragma unroll
            for (int i = 0; i < MQ; ++i)
#pragma unroll
              for (int j = 0; j < MR; ++j)
                cnt[i][j] += __popc(word_of(d[i][j], e));
          }
        } else {
#pragma unroll
          for (int i = 0; i < MQ; ++i)
#pragma unroll
            for (int j = 0; j < MR; ++j)
              cnt[i][j] += __popc(d[i][j].x) + __popc(d[i][j].y) +
                           __popc(d[i][j].z) + __popc(d[i][j].w);
        }
      }
      __syncwarp();  // every lane's reads of this buffer are done
      if ((tid & 31) == 0) mbar_arrive(empty + 8 * s);
      if (tid == 0 && pseg < nseg) {  // refill it once all 8 warps are done
        mbar_wait(empty + 8 * s, phase);
        load_next(s);
      }
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    flush();  // the segment's last slot (a no-op once it ran past K)
  }
}

// ---------------------------------------------------------------------------
// Host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of one operand: a 4-D uint32 view {words, rows, planes,
// segments} at `base`, strides in 32-bit words (multiples of 4), box
// {WORDS, 64, planes, 1}. Returns 0, a cudaError_t, or ENCODE_ERROR + the
// CUresult the driver gave.
inline int encode(CUtensorMap* map, const void* base, long long words,
                  long long rows, long long planes, long long segs,
                  long long row_stride, long long plane_stride,
                  long long seg_stride) {
  static EncodeTiled encode_tiled = nullptr;
  if (encode_tiled == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return int(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return int(cudaErrorSymbolNotFound);
    encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {cuuint64_t(words), cuuint64_t(rows),
                              cuuint64_t(planes), cuuint64_t(segs)};
  const cuuint64_t strides[3] = {cuuint64_t(row_stride) * 4,
                                 cuuint64_t(plane_stride) * 4,
                                 cuuint64_t(seg_stride) * 4};
  const cuuint32_t box[4] = {WORDS, TQ, cuuint32_t(planes), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode_tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_ERROR + int(res);
}

// The dynamic shared memory of a STAGES-deep ring for P planes, after
// raising `kernel`'s limit to it. Returns 0 or an error: P too large for the
// card's opt-in shared memory is cudaErrorInvalidValue.
template <typename Kernel>
inline int ring_smem(Kernel kernel, int P, size_t* smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return int(err);
  // the alignment slack, the stages and their two mbarriers each
  *smem = ALIGN + size_t(STAGES) * (size_t(P) * (TQ + TR) * WORDS * 4 + 16);
  if (*smem > size_t(optin)) return int(cudaErrorInvalidValue);
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*smem)));
}

}  // namespace mc
