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
//      torch's CUDA kernels make: powf, logf, expf, compiled without
//      fast-math. Where torch takes a shortcut so does this kernel:
//        - division by a host scalar is a multiply by its float reciprocal
//          (aten BinaryDivTrueKernel.cu: m / nbins and (obs - e) / (1 - e)
//          run as a * (1.0f / b)), so the kernel takes 1.0f / b in float
//          and multiplies;
//        - pow with a scalar exponent (aten Pow.cpp, PowKernel.cu): 0 is 1,
//          1 the base, 2 x * x, 3 (x * x) * x, any other k powf(x, k);
//        - clamp keeps a NaN and is min(max(v, lo), hi) otherwise.
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
// MHz (bench.epilogue_bound, from the shapes). The kernel's accurate
// powf / logf and IEEE divisions spend several times that.
//
// The design: one thread per pair, r the fastest index, so a warp's count
// loads and output stores fall on neighbouring addresses; a block is 256
// references of one query row (the row's length and frequencies are
// block-uniform). The K counts are read and corrected one k at a time and
// written (Jaccards) or kept as log j in a per-thread array for the fit's
// sums; nothing reaches device memory between the counts and the output.
// K is a run-time value (1..32); the k loop is not unrolled (each powf
// inlines some dozens of instructions). The k values, the scalar constants
// and the flags reach the kernel as its parameters.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_K = 32;
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

struct Params {
  float k[MAX_K];
  int K;
  float inv_nbins;        // 1.0f / float(nbins)
  float expected;         // float(2^-bbits)
  float inv_one_minus_e;  // 1.0f / float(1 - 2^-bbits)
  float r_max;            // float(1 - 1e-6)
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

// torch.pow(x, k) for a float scalar exponent k on CUDA, as selects: powf
// runs at every k. On an H100 this form is the fastest measured: 0.488 ms
// at 2048 x 4096 x K 6 against 0.609 ms with a branch on k (the same
// across a warp) before each pow (chip_smoke.py phase C2).
__device__ __forceinline__ float pow_scalar(float x, float k) {
  const float general = powf(x, k);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  return k == 3.0f   ? x3
         : k == 2.0f ? x2
         : k == 1.0f ? x
         : k == 0.0f ? 1.0f
                     : general;
}

// The sums sy = sum y, sky = sum k y and syy = sum y y over k, in the order
// torch's CUDA sum takes them over a contiguous last dimension of K <= 32
// (aten/src/ATen/native/cuda/Reduce.cuh): B, the largest power of two
// <= K, threads share a pair; thread x adds element x + B (where there is
// one) to element x, then shuffle-down rounds at offsets B / 2, ..., 2, 1
// add thread x + offset's sum into thread x's, and thread 0 holds the sum.
// (Held on an H100 under torch 2.11 against torch.sum over [4096, K] for
// every K from 1 to 32, bit for bit.) ys[i] is log j at k[i], or 0 where
// j = 0 (the plain version's w * y).
__device__ __forceinline__ void torch_order_sums(const float* ys,
                                                 const float* ks, int K,
                                                 float& sy, float& sky,
                                                 float& syy) {
  int B = 1;
  while (2 * B <= K) B *= 2;
  float a[MAX_K], b[MAX_K], c[MAX_K];
  for (int x = 0; x < B; ++x) {
    a[x] = ys[x];
    b[x] = __fmul_rn(ks[x], ys[x]);
    c[x] = __fmul_rn(ys[x], ys[x]);
    if (x + B < K) {
      const float y = ys[x + B];
      a[x] = __fadd_rn(a[x], y);
      b[x] = __fadd_rn(b[x], __fmul_rn(ks[x + B], y));
      c[x] = __fadd_rn(c[x], __fmul_rn(y, y));
    }
  }
  for (int off = B / 2; off > 0; off /= 2) {
    for (int x = 0; x < off; ++x) {
      a[x] = __fadd_rn(a[x], a[x + off]);
      b[x] = __fadd_rn(b[x], b[x + off]);
      c[x] = __fadd_rn(c[x], c[x + off]);
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

template <bool RANDOM, bool RC, bool JACCARD>
__global__ void __launch_bounds__(THREADS)
dist_epilogue_kernel(const int* __restrict__ matches,
                     const int* __restrict__ len_q,
                     const int* __restrict__ len_r,
                     const float* __restrict__ freq_q,
                     const float* __restrict__ freq_r,
                     float* __restrict__ out, int nq, int nr, Params p) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= nr) return;
  const float tiny_det = static_cast<float>(1e-12);
  const float tiny_union = static_cast<float>(1e-30);
  float fr[4], lr = 0.0f;
  if (RANDOM) {
    for (int c = 0; c < 4; ++c) fr[c] = freq_r[4 * r + c];
    lr = static_cast<float>(len_r[r]);
  }
  for (int q = blockIdx.y; q < nq; q += gridDim.y) {
    const long long pair = static_cast<long long>(q) * nr + r;
    const int* m = matches + pair * p.K;
    float dot = 0.0f, dot_rc = 0.0f, lq = 0.0f;
    if (RANDOM) {
      const float* fq = freq_q + 4 * static_cast<long long>(q);
      dot = __fmul_rn(fq[0], fr[0]);
      for (int c = 1; c < 4; ++c)
        dot = __fadd_rn(dot, __fmul_rn(fq[c], fr[c]));
      if (RC) {
        dot_rc = __fmul_rn(fq[0], fr[3]);
        for (int c = 1; c < 4; ++c)
          dot_rc = __fadd_rn(dot_rc, __fmul_rn(fq[c], fr[3 - c]));
      }
      lq = static_cast<float>(len_q[q]);
    }
    // sw, sk and skk are sums of small integers: exact in any order
    float sw = 0.0f, sk = 0.0f, skk = 0.0f, ys[MAX_K];
#pragma unroll 1
    for (int i = 0; i < p.K; ++i) {
      const float k = p.k[i];
      const float obs = __fmul_rn(static_cast<float>(m[i]), p.inv_nbins);
      float j = clamp_(
          __fmul_rn(__fsub_rn(obs, p.expected), p.inv_one_minus_e), 0.0f,
          1.0f);
      if (RANDOM) {
        float pk = pow_scalar(dot, k);
        if (RC) pk = __fadd_rn(pk, pow_scalar(dot_rc, k));
        const float n1 = clamp_min_(__fadd_rn(__fsub_rn(lq, k), 1.0f), 1.0f);
        const float n2 = clamp_min_(__fadd_rn(__fsub_rn(lr, k), 1.0f), 1.0f);
        const float inter = __fmul_rn(__fmul_rn(n1, n2), pk);
        const float uni = __fsub_rn(__fadd_rn(n1, n2), inter);
        const float rnd = clamp_(
            uni <= 0.0f ? 1.0f
                        : __fdiv_rn(inter, clamp_min_(uni, tiny_union)),
            0.0f, p.r_max);
        j = clamp_(__fdiv_rn(__fsub_rn(j, rnd), __fsub_rn(1.0f, rnd)), 0.0f,
                   1.0f);
      }
      if (JACCARD) {
        out[pair * p.K + i] = j;
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
    if (JACCARD) continue;

    float sy, sky, syy;
    torch_order_sums(ys, p.k, p.K, sy, sky, syy);

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
    const bool degenerate = sw < 2.0f;
    const float2 d = degenerate
                         ? make_float2(1.0f, 1.0f)
                         : make_float2(__fsub_rn(1.0f, expf(b1)),
                                       __fsub_rn(1.0f, expf(b0)));
    reinterpret_cast<float2*>(out)[pair] = d;
  }
}

template <bool RANDOM, bool RC, bool JACCARD>
int launch(const void* matches, const void* len_q, const void* len_r,
           const void* freq_q, const void* freq_r, void* out, int nq, int nr,
           const Params& p, cudaStream_t stream) {
  const dim3 grid((nr + THREADS - 1) / THREADS,
                  nq < MAX_GRID_Y ? nq : MAX_GRID_Y);
  dist_epilogue_kernel<RANDOM, RC, JACCARD><<<grid, THREADS, 0, stream>>>(
      static_cast<const int*>(matches), static_cast<const int*>(len_q),
      static_cast<const int*>(len_r), static_cast<const float*>(freq_q),
      static_cast<const float*>(freq_r), static_cast<float*>(out), nq, nr, p);
  return int(cudaGetLastError());
}

}  // namespace

// matches int32 [nq, nr, K], len_q / len_r int32 [nq] / [nr], freq_q /
// freq_r float32 [nq, 4] / [nr, 4], out float32 [nq, nr, K] (jaccard) or
// [nq, nr, 2] (otherwise, 8-byte aligned), all contiguous on the current
// device; kvals a host array of K floats, 1 <= K <= 32; nq, nr > 0. The
// scalar constants are the plain version's Python values cast to float32:
// nbins, 2^-bbits, 1 - 2^-bbits and 1 - 1e-6. Returns 0, 1 for a K out of
// range, or the CUDA error of the launch (cudaGetLastError()).
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
  for (int i = 0; i < MAX_K; ++i)
    p.k[i] = i < K ? static_cast<const float*>(kvals)[i] : 0.0f;
  p.K = K;
  // division by a host scalar, as torch's CUDA kernel runs it
  p.inv_nbins = 1.0f / nbins;
  p.expected = expected;
  p.inv_one_minus_e = 1.0f / one_minus_expected;
  p.r_max = r_max;
  auto s = static_cast<cudaStream_t>(stream);
  const bool rnd = random_correct != 0, rc = use_rc != 0, jac = jaccard != 0;
  if (!rnd)
    return jac ? launch<false, false, true>(matches, len_q, len_r, freq_q,
                                            freq_r, out, nq, nr, p, s)
               : launch<false, false, false>(matches, len_q, len_r, freq_q,
                                             freq_r, out, nq, nr, p, s);
  if (!rc)
    return jac ? launch<true, false, true>(matches, len_q, len_r, freq_q,
                                           freq_r, out, nq, nr, p, s)
               : launch<true, false, false>(matches, len_q, len_r, freq_q,
                                            freq_r, out, nq, nr, p, s);
  return jac ? launch<true, true, true>(matches, len_q, len_r, freq_q, freq_r,
                                        out, nq, nr, p, s)
             : launch<true, true, false>(matches, len_q, len_r, freq_q,
                                         freq_r, out, nq, nr, p, s);
}
