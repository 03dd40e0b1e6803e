"""The yardstick's peaks and work counts, frozen.

Copied from ``poppunk_tpu_torch/bench.py`` (``bound``, ``epilogue_ops``,
``epilogue_bound``) and frozen here, so that a change to the program
cannot change what its kernels are measured against. Two changes from the
copy: the work is given as pairs and genomes rather than a dense
``nq x nr`` block, so that a condensed pass and a padded request count
only the pairs these inputs need; and the clock is fixed at the H100 SXM's
largest SM clock, 1,980 MHz, never a sampled one.

Peaks of one H100 (NVIDIA's data sheet and CUDA programming guide,
compute capability 9.0): 64 32-bit logic operations (LOP3) an SM a clock,
128 float32 add, multiply, compare or select instructions an SM a clock,
16 special-function results (rcp, lg2, ex2) an SM a clock, HBM3 at
3.35 TB/s.
"""

PEAK_SM_MHZ = 1980.0
LOP3_PER_SM_CLOCK = 64
F32_PER_SM_CLOCK = 128
SFU_PER_SM_CLOCK = 16
HBM_BYTES_PER_S = 3.35e12


def match_counts_bound_s(pairs, K, P, w32, in_bytes, sms,
                         sm_mhz=PEAK_SM_MHZ):
    """(seconds, bound_by): the least time the match-count kernels need for
    ``pairs`` (query, reference) pairs of K k-mer lengths, P planes and
    ``w32`` bin words a plane: the larger of one LOP3 per (pair, k, plane,
    word) on ``sms`` SMs at ``sm_mhz`` and the bytes (``in_bytes`` of
    planes read once, the int32 counts written once) at HBM rate."""
    ops_s = pairs * K * w32 * P / (LOP3_PER_SM_CLOCK * sms * sm_mhz * 1e6)
    bytes_s = (in_bytes + pairs * K * 4) / HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def epilogue_ops(K, random_correct=True, use_rc=True, jaccard=False):
    """(float32 operations, special-function operations) a pair of the
    distance epilogue needs, counted from the published formula. Each add,
    multiply, compare, min / max, select and int-to-float is one float32
    operation; pow is ex2(k lg2 x), log lg2(x) ln 2, exp ex2(x log2 e) and
    a division a rcp(b): their cheapest forms, one float32 multiply and one
    (two for pow) special-function operation each."""
    f32, sfu = 6 * K, 0  # b-bit: cvt, * 1/nbins, - e, * 1/(1 - e), clamp
    if random_correct:
        # per pair: dot4 (and the flipped one); per k: pow (and pow + add),
        # n1, n2, inter, union, the where, max(union, 1e-30), a divide,
        # the clamp, (j - r) / (1 - r) and its clamp
        f32 += 7 * (1 + use_rc) + K * (22 + 2 * use_rc)
        sfu += K * (4 + 2 * use_rc)
    if not jaccard:
        # per k: the mask, the log and its where, w k, w k k, w y, w k y,
        # w y y and the six sums; per pair: det, the unconstrained solution
        # (two divides), the two clamped candidates (a divide each), three
        # SSEs of 16, the selects, the feasibility test, two exps, (1, 1)
        f32 += K * 15 + 94
        sfu += K + 6
    return f32, sfu


def epilogue_bound_s(pairs, genomes, K, sms, sm_mhz=PEAK_SM_MHZ,
                     random_correct=True, use_rc=True, jaccard=False):
    """(seconds, bound_by) of the epilogue on ``pairs`` pairs among
    ``genomes`` genomes: the largest of the bytes (the int32 counts read
    once, each genome's length and frequencies once, the float32 output
    written once) at HBM rate, the epilogue_ops instructions at
    F32_PER_SM_CLOCK issue and the special-function ones at
    SFU_PER_SM_CLOCK."""
    f32, sfu = epilogue_ops(K, random_correct, use_rc, jaccard)
    moved = pairs * K * 4 + genomes * (4 + 16) + pairs * (K if jaccard
                                                          else 2) * 4
    bytes_s = moved / HBM_BYTES_PER_S
    clock = sms * sm_mhz * 1e6
    ops_s = max(pairs * (f32 + sfu) / (F32_PER_SM_CLOCK * clock),
                pairs * sfu / (SFU_PER_SM_CLOCK * clock))
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
