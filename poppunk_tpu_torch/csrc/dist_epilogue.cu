// The distance epilogue: sketch bin-match counts -> corrected Jaccards ->
// (core, accessory), in one pass, one thread per pair.
//
// Replaces the epilogue that XLA fuses after the match-count kernel inside
// the reference's jitted chunk, poppunk_tpu/ops/distances.py:192-214
// (_dist_chunk): corrected_jaccards (:169, with _random_jaccard_jnp :148)
// and core_accessory -> poppunk_tpu/ops/kmer_fit.py::_fit_math (:28-91).
// The Pallas kernels leave it to XLA; in the port it was ~40 separate torch
// kernels, each writing a full float32 [rows, n, K] tensor. Its plain
// version is ops/distances.py::dist_epilogue_torch, which is exactly that
// torch composition.
//
// For int32 counts m[nq, nr, K] of either match-count kernel, int32 genome
// lengths len_q[nq] / len_r[nr] and float32 base frequencies f_q[nq, 4] /
// f_r[nr, 4], it writes, per pair (q, r), either the K corrected Jaccards
// (float32 [nq, nr, K]) or the fitted (core, accessory) (float32
// [nq, nr, 2]):
//
//     j   = clamp((m / nbins - e) / (1 - e), 0, 1),       e = 2^-bbits
//     and with the random-match correction, per k:
//     p   = dot^k (+ dot_rc^k),  dot = f_q . f_r,  dot_rc = f_q . rev(f_r)
//     n1  = max(len_q - k + 1, 1),  n2 = max(len_r - k + 1, 1)
//     rnd = clamp(n1 n2 p / max(n1 + n2 - n1 n2 p, 1e-30), 0, 1 - 1e-6)
//           (1 where the union is <= 0)
//     j   = clamp((j - rnd) / (1 - rnd), 0, 1)
//     then the box-constrained least squares of log j on k over the k with
//     j > 0 (six weighted sums, the 2 x 2 normal equations, three boundary
//     candidates by SSE): core = 1 - exp(b1), accessory = 1 - exp(b0), or
//     (1, 1) with fewer than two usable k.
//
// Numerical contract (held on the card by chip_smoke.py phase C2, its route
// holds, and the cuda tests of tests/test_torch_dist_epilogue.py):
//  (a) the Jaccards equal the plain version's on the card bit for bit. Every
//      add, multiply and divide is an explicit round-to-nearest intrinsic
//      (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), so nothing is
//      contracted into an FMA, in the plain version's order of operations
//      ((n1 * n2) * p, (n1 + n2) - inter, (len - k) + 1, _dot4's products
//      and sums left to right). The transcendental calls are the ones
//      torch's CUDA kernels make: logf, expf, compiled without fast-math.
//      Where torch takes a shortcut so does this kernel:
//        - division by a host scalar is a multiply by its float reciprocal
//          (aten BinaryDivTrueKernel.cu: m / nbins and (obs - e) / (1 - e)
//          run as a * (1.0f / b)), so the kernel takes 1.0f / b in float
//          and multiplies;
//        - clamp keeps a NaN and is min(max(v, lo), hi) otherwise.
//      dot^k is no torch pow: the plain version's pow_f64 widens the dot to
//      float64 once, squares and multiplies over the bits of k from the
//      lowest (the running square times the result where a bit is set),
//      and rounds once to float32; this kernel runs the same chain with
//      __dmul_rn and __double2float_rn (random_match_p below), correctly
//      rounded but for ~1e-15 relative.
//      Against the JAX package's Jaccards on the CPU (other pow and
//      division roundings) they hold at rtol 1e-6, or within the rounding
//      bound of two float32 evaluations where the random-match correction
//      divides by a 1 - r near 1e-6 and float32 cannot do better;
//  (b) (core, accessory) agree with the plain version within DIST_TOL (rtol
//      1e-5, atol 2e-5). The float32 normal equations cancel at pairs near
//      chance (two or three usable k, the intercept extrapolated from k 25
//      to 0), where any two float32 summation orders can differ by some
//      1e-4: the JAX package's fit and the port's CPU fit do. So sy, sky
//      and syy are summed in torch's CUDA reduction order
//      (torch_order_sums; sw, sk and skk are exact integers in any order),
//      checked under torch 2.11, where the distances then equal the plain
//      version's bit for bit. Independently of torch, every pair is held
//      to the float64 oracle (ops/kmer_fit.py::fit_kmer_curve_np) on the
//      kernel's own Jaccards within DIST_TOL or, where that is more, the
//      pair's float32 rounding bound (kmer_fit.fit_rounding_bound), and to
//      the JAX package within DIST_TOL or the bound of both evaluations;
//  (c) a pair's result depends on its own inputs only, never on the tile's
//      shape, so a column shard's, a mesh shard's or a chunk's tile holds
//      the single device's values bit for bit.
//
// What bounds it on an H100: instruction issue, then bytes. A pair reads
// 4K bytes of counts and writes 8 (32 B at K 6: 0.080 ms for 2048 x 4096
// pairs at 3.35 TB/s). The function needs 2K pow, K log, 2 exp and 2K + 4
// divisions: at K 6, in their cheapest forms, 48 special-function
// operations a pair (0.096 ms at 16 an SM a clock) and 378 float32 ones
// besides, 426 instructions a pair at 128 an SM a clock: 0.107 ms at 1980
// MHz (bench.epilogue_bound, from the shapes). The kernel takes about
// three times that (PERF.md): the contract asks for IEEE divisions (a
// reciprocal, five FMAs, a check and a branch each), the accurate logf
// (some 30 instructions) and, in place of the two special-function
// operations of each pow, the float64 chains (predicated multiplies at 64
// an SM a clock).
//
// The design:
//  - one thread per pair, r the fastest index; a block is 256 references
//    of one query row (gridDim.y rows, then the rows gridDim.y further on).
//    The reference's terms (its frequencies, length and n2 at every k)
//    are read once for all the rows a thread takes. A thread reads its K
//    counts from global memory; staging a row's counts in shared memory
//    (cp.async, double-buffered, a block walking 4 rows) measured slower,
//    0.3359 against 0.3295 ms at 2048 x 4096 x K 6 on an H100 (PERF.md).
//  - the largest K is a template parameter, KMAX 8 (PopPUNK's default
//    13..29 step 4, the bench's K 6) or 32 (parse_kmers' widest, 3..31),
//    chosen at launch from K. Every loop over k is unrolled over KMAX with
//    i < K as a predicate, and so are torch_order_sums' rounds, so the log
//    j and the partial sums live in registers, not on the stack.
//  - dot^k: the dot's squares x, x^2, ..., x^16 once a pair, then per k the
//    product of those its bits select, lowest first, which is the chain of
//    pow_f64 multiply for multiply.
//  - outputs: one float2 a pair, or its K Jaccards. The k values, the
//    scalar constants and the flags reach the kernel as its parameters.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int MAX_K = 32;
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;
// the dot's squares a pair holds: x^(2^b) for b < SQ_BITS, k up to 31
constexpr int SQ_BITS = 5;

struct Params {
  float k[MAX_K];
  int ki[MAX_K];          // the same k-mer lengths as integers
  int K;
  int B;                  // the largest power of two <= K
  float inv_nbins;        // 1.0f / float(nbins)
  float expected;         // float(2^-bbits)
  float inv_one_minus_e;  // 1.0f / float(1 - 2^-bbits)
  float r_max;            // float(1 - 1e-6)
};

struct Operands {
  const int* matches;
  const int* len_q;
  const int* len_r;
  const float* freq_q;
  const float* freq_r;
  float* out;
  int nq, nr;
};

// torch.clamp / clamp(min=) / clamp(max=) on CUDA: a NaN stays NaN
__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// dot^k (+ dot_rc^k) from sq[b] = dot^(2^b) (float64, each the square of
// the one before): the product of the squares k's bits select, lowest bit
// first, then, for k >= 2^SQ_BITS, the chain squaring on; one walk of the
// bits serves both dots. 1.0 times the first is that square itself, so
// each is ops/distances.py::pow_f64's chain, rounded once to float32, and
// the two are added in float32 as the plain version adds them.
template <bool RC>
__device__ __forceinline__ float random_match_p(
    const double (&sq)[SQ_BITS], const double (&sq_rc)[SQ_BITS], int k) {
  double r = 1.0, r_rc = 1.0;
#pragma unroll
  for (int b = 0; b < SQ_BITS; ++b) {
    if ((k >> b) & 1) {
      r = __dmul_rn(r, sq[b]);
      if (RC) r_rc = __dmul_rn(r_rc, sq_rc[b]);
    }
  }
  if (k >> SQ_BITS) {
    double s = sq[SQ_BITS - 1], s_rc = sq_rc[SQ_BITS - 1];
    for (int e = k >> SQ_BITS; e; e >>= 1) {
      s = __dmul_rn(s, s);
      if (RC) s_rc = __dmul_rn(s_rc, s_rc);
      if (e & 1) {
        r = __dmul_rn(r, s);
        if (RC) r_rc = __dmul_rn(r_rc, s_rc);
      }
    }
  }
  const float p = __double2float_rn(r);
  return RC ? __fadd_rn(p, __double2float_rn(r_rc)) : p;
}

__device__ __forceinline__ void squares(float x, double (&sq)[SQ_BITS]) {
  sq[0] = static_cast<double>(x);
#pragma unroll
  for (int b = 1; b < SQ_BITS; ++b) sq[b] = __dmul_rn(sq[b - 1], sq[b - 1]);
}

// The sums sy = sum y, sky = sum k y and syy = sum y y over k, in the order
// torch's CUDA sum takes them over a contiguous last dimension of K <= 32
// (aten/src/ATen/native/cuda/Reduce.cuh): B, the largest power of two
// <= K, threads share a pair; thread x adds element x + B (where there is
// one) to element x, then shuffle-down rounds at offsets B / 2, ..., 2, 1
// add thread x + offset's sum into thread x's, and thread 0 holds the sum.
// (Held on an H100 under torch 2.11 against torch.sum over [4096, K] for
// every K from 1 to 32, bit for bit.) ys[i] is log j at k[i], or 0 where
// j = 0 (the plain version's w * y). B is the same for every thread, so
// each round is a branch on it; every loop runs KMAX or log2 KMAX times,
// so unrolled, every index is a constant.
__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

template <int KMAX>
__device__ __forceinline__ void torch_order_sums(const float (&ys)[KMAX],
                                                 const Params& p, float& sy,
                                                 float& sky, float& syy) {
  constexpr int LOG2_KMAX = log2_of(KMAX);
  float a[KMAX], b[KMAX], c[KMAX];
#pragma unroll
  for (int x = 0; x < KMAX; ++x) a[x] = b[x] = c[x] = 0.0f;
#pragma unroll
  for (int e = LOG2_KMAX; e >= 0; --e) {
    const int bs = 1 << e;
    if (p.B == bs) {
#pragma unroll
      for (int x = 0; x < KMAX; ++x) {
        if (x < bs) {
          a[x] = ys[x];
          b[x] = __fmul_rn(p.k[x], ys[x]);
          c[x] = __fmul_rn(ys[x], ys[x]);
        }
        if (x + bs < KMAX) {
          if (x < bs && x + bs < p.K) {
            const float y = ys[x + bs];
            a[x] = __fadd_rn(a[x], y);
            b[x] = __fadd_rn(b[x], __fmul_rn(p.k[x + bs], y));
            c[x] = __fadd_rn(c[x], __fmul_rn(y, y));
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = LOG2_KMAX - 1; e >= 0; --e) {
    const int off = 1 << e;
    if (off < p.B) {
#pragma unroll
      for (int x = 0; x < KMAX / 2; ++x) {
        if (x < off) {
          a[x] = __fadd_rn(a[x], a[x + off]);
          b[x] = __fadd_rn(b[x], b[x + off]);
          c[x] = __fadd_rn(c[x], c[x + off]);
        }
      }
    }
  }
  sy = a[0];
  sky = b[0];
  syy = c[0];
}

// _fit_math's SSE of a candidate, in its order of operations
__device__ __forceinline__ float sse(float b0, float b1, float sw, float sk,
                                     float skk, float sy, float sky,
                                     float syy) {
  float s = __fsub_rn(syy, __fmul_rn(__fmul_rn(2.0f, b0), sy));
  s = __fsub_rn(s, __fmul_rn(__fmul_rn(2.0f, b1), sky));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(b0, b0), sw));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b0), b1), sk));
  return __fadd_rn(s, __fmul_rn(__fmul_rn(b1, b1), skk));
}

// _fit_math on the six sums: (core, accessory), or (1, 1) with fewer than
// two usable k
__device__ __forceinline__ float2 fit(float sw, float sk, float skk,
                                      float sy, float sky, float syy) {
  const float tiny_det = static_cast<float>(1e-12);
  const float det = __fsub_rn(__fmul_rn(sw, skk), __fmul_rn(sk, sk));
  const bool det_ok = fabsf(det) > tiny_det;
  const float safe_det = det_ok ? det : 1.0f;
  const float b1_u = __fdiv_rn(
      __fsub_rn(__fmul_rn(sw, sky), __fmul_rn(sk, sy)), safe_det);
  const float b0_u =
      sw > 0.0f ? __fdiv_rn(__fsub_rn(sy, __fmul_rn(b1_u, sk)),
                            clamp_min_(sw, 1.0f))
                : 0.0f;
  // the candidates (b0 = 0; b1 = 0; both 0), the first kept on ties
  float best_b0 = 0.0f;
  float best_b1 =
      skk > 0.0f
          ? clamp_max_(__fdiv_rn(sky, clamp_min_(skk, tiny_det)), 0.0f)
          : 0.0f;
  float best = sse(best_b0, best_b1, sw, sk, skk, sy, sky, syy);
  const float c1_b0 =
      sw > 0.0f ? clamp_max_(__fdiv_rn(sy, clamp_min_(sw, 1.0f)), 0.0f)
                : 0.0f;
  const float s1 = sse(c1_b0, 0.0f, sw, sk, skk, sy, sky, syy);
  if (s1 < best) {
    best_b0 = c1_b0;
    best_b1 = 0.0f;
    best = s1;
  }
  const float s2 = sse(0.0f, 0.0f, sw, sk, skk, sy, sky, syy);
  if (s2 < best) {
    best_b0 = 0.0f;
    best_b1 = 0.0f;
  }
  const bool feasible = (b0_u <= 0.0f) & (b1_u <= 0.0f) & det_ok;
  const float b0 = feasible ? b0_u : best_b0;
  const float b1 = feasible ? b1_u : best_b1;
  return sw < 2.0f ? make_float2(1.0f, 1.0f)
                   : make_float2(__fsub_rn(1.0f, expf(b1)),
                                 __fsub_rn(1.0f, expf(b0)));
}

template <int KMAX, bool RANDOM, bool RC, bool JACCARD>
__global__ void __launch_bounds__(THREADS)
dist_epilogue_kernel(const Operands o, const Params p) {
  const int K = p.K;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= o.nr) return;
  const float tiny_union = static_cast<float>(1e-30);

  // the reference's terms, for every query row the thread takes
  float fr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, n2[KMAX];
  if (RANDOM) {
#pragma unroll
    for (int c = 0; c < 4; ++c) fr[c] = o.freq_r[4 * r + c];
    const float lr = static_cast<float>(o.len_r[r]);
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      n2[i] = clamp_min_(__fadd_rn(__fsub_rn(lr, p.k[i]), 1.0f), 1.0f);
  }

  for (int q = blockIdx.y; q < o.nq; q += gridDim.y) {
    const long long pair = static_cast<long long>(q) * o.nr + r;
    const int* m = o.matches + pair * K;
    float lq = 0.0f;
    double sq[SQ_BITS], sq_rc[SQ_BITS];
    if (RANDOM) {
      const float* fq = o.freq_q + 4 * static_cast<long long>(q);
      float dot = __fmul_rn(fq[0], fr[0]);
#pragma unroll
      for (int c = 1; c < 4; ++c)
        dot = __fadd_rn(dot, __fmul_rn(fq[c], fr[c]));
      squares(dot, sq);
      if (RC) {
        float dot_rc = __fmul_rn(fq[0], fr[3]);
#pragma unroll
        for (int c = 1; c < 4; ++c)
          dot_rc = __fadd_rn(dot_rc, __fmul_rn(fq[c], fr[3 - c]));
        squares(dot_rc, sq_rc);
      }
      lq = static_cast<float>(o.len_q[q]);
    }
    // sw, sk and skk are sums of small integers: exact in any order
    float sw = 0.0f, sk = 0.0f, skk = 0.0f, ys[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      ys[i] = 0.0f;
      if (i < K) {
        const float k = p.k[i];
        const float obs = __fmul_rn(static_cast<float>(m[i]), p.inv_nbins);
        float j = clamp_(
            __fmul_rn(__fsub_rn(obs, p.expected), p.inv_one_minus_e), 0.0f,
            1.0f);
        if (RANDOM) {
          const float pk = random_match_p<RC>(sq, sq_rc, p.ki[i]);
          const float n1 =
              clamp_min_(__fadd_rn(__fsub_rn(lq, k), 1.0f), 1.0f);
          const float inter = __fmul_rn(__fmul_rn(n1, n2[i]), pk);
          const float uni = __fsub_rn(__fadd_rn(n1, n2[i]), inter);
          const float rnd = clamp_(
              uni <= 0.0f ? 1.0f
                          : __fdiv_rn(inter, clamp_min_(uni, tiny_union)),
              0.0f, p.r_max);
          j = clamp_(__fdiv_rn(__fsub_rn(j, rnd), __fsub_rn(1.0f, rnd)),
                     0.0f, 1.0f);
        }
        if (JACCARD) {
          o.out[pair * K + i] = j;
        } else {
          const bool pos = j > 0.0f;
          const float w = pos ? 1.0f : 0.0f;
          const float wk = __fmul_rn(w, k);
          ys[i] = logf(pos ? j : 1.0f);  // log 1 = 0: w * y either way
          sw = __fadd_rn(sw, w);
          sk = __fadd_rn(sk, wk);
          skk = __fadd_rn(skk, __fmul_rn(wk, k));
        }
      }
    }
    if (!JACCARD) {
      float sy, sky, syy;
      torch_order_sums<KMAX>(ys, p, sy, sky, syy);
      reinterpret_cast<float2*>(o.out)[pair] = fit(sw, sk, skk, sy, sky, syy);
    }
  }
}

template <int KMAX, bool RANDOM, bool RC, bool JACCARD>
int launch(const Operands& o, const Params& p, cudaStream_t stream) {
  const dim3 grid((o.nr + THREADS - 1) / THREADS,
                  o.nq < MAX_GRID_Y ? o.nq : MAX_GRID_Y);
  dist_epilogue_kernel<KMAX, RANDOM, RC, JACCARD>
      <<<grid, THREADS, 0, stream>>>(o, p);
  return int(cudaGetLastError());
}

template <int KMAX>
int dispatch(const Operands& o, const Params& p, bool rnd, bool rc, bool jac,
             cudaStream_t s) {
  if (!rnd)
    return jac ? launch<KMAX, false, false, true>(o, p, s)
               : launch<KMAX, false, false, false>(o, p, s);
  if (!rc)
    return jac ? launch<KMAX, true, false, true>(o, p, s)
               : launch<KMAX, true, false, false>(o, p, s);
  return jac ? launch<KMAX, true, true, true>(o, p, s)
             : launch<KMAX, true, true, false>(o, p, s);
}

}  // namespace

// matches int32 [nq, nr, K], len_q / len_r int32 [nq] / [nr], freq_q /
// freq_r float32 [nq, 4] / [nr, 4], out float32 [nq, nr, K] (jaccard) or
// [nq, nr, 2] (otherwise, 8-byte aligned), all contiguous on the current
// device; kvals a host array of K positive integer k-mer lengths as
// floats, 1 <= K <= 32; nq, nr > 0. The scalar constants are the plain
// version's Python values cast to float32: nbins, 2^-bbits, 1 - 2^-bbits
// and 1 - 1e-6. Returns 0, 1 for a K out of range, or the CUDA error of
// the launch (cudaGetLastError()).
extern "C" int dist_epilogue_launch(const void* matches, const void* len_q,
                                    const void* len_r, const void* freq_q,
                                    const void* freq_r, void* out, int nq,
                                    int nr, int K, const void* kvals,
                                    float nbins, float expected,
                                    float one_minus_expected, float r_max,
                                    int random_correct, int use_rc,
                                    int jaccard, void* stream) {
  if (K < 1 || K > MAX_K) return 1;
  Params p;
  for (int i = 0; i < MAX_K; ++i) {
    p.k[i] = i < K ? static_cast<const float*>(kvals)[i] : 0.0f;
    p.ki[i] = static_cast<int>(p.k[i]);
  }
  p.K = K;
  p.B = 1;
  while (2 * p.B <= K) p.B *= 2;
  // division by a host scalar, as torch's CUDA kernel runs it
  p.inv_nbins = 1.0f / nbins;
  p.expected = expected;
  p.inv_one_minus_e = 1.0f / one_minus_expected;
  p.r_max = r_max;
  const Operands o{static_cast<const int*>(matches),
                   static_cast<const int*>(len_q),
                   static_cast<const int*>(len_r),
                   static_cast<const float*>(freq_q),
                   static_cast<const float*>(freq_r),
                   static_cast<float*>(out),
                   nq,
                   nr};
  auto s = static_cast<cudaStream_t>(stream);
  const bool rnd = random_correct != 0, rc = use_rc != 0, jac = jaccard != 0;
  return K <= 8 ? dispatch<8>(o, p, rnd, rc, jac, s)
                : dispatch<32>(o, p, rnd, rc, jac, s);
}
