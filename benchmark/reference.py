"""The plain reference: sketch distances, from the benchmark's own
inputs.

Plain PyTorch, written from PopPUNK's published definitions and not from
the program; it imports nothing of the program. The inputs are the
generator's planes, lengths and base frequencies, never what the program
derived from them.

    bin matches       a bin matches when its b-bit signature agrees in
                      every plane: count = 64 w64 - popcount(OR_p q_p ^ r_p)
    b-bit Jaccard     (matches / bins - 2^-b) / (1 - 2^-b), clipped to [0, 1]
    random matches    r(k) = E[Jaccard] of two random sequences of these
                      lengths and base compositions (both strands), and
                      j = (J - r) / (1 - r), clipped to [0, 1]
    k-mer fit         log j(k) = b0 + b1 k by least squares over the k with
                      j > 0, b0 <= 0 and b1 <= 0; core = 1 - exp(b1),
                      accessory = 1 - exp(b0); (1, 1) with fewer than two

``precision`` picks the arithmetic: "float64" is the reference; the
controls are "tf32" (float32 whose contractions, the base-composition dot
and the fit's sums over k, take TF32 operands, as a matmul with TF32 on
does) and "bfloat16" (every operation in bfloat16).
"""

import numpy as np
import torch

PRECISIONS = ("float64", "tf32", "bfloat16")


def popcount64(x):
    """Set bits of each int64 word (two's complement wraps as uint64)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56 & 0xFF


def words64(planes, w32):
    """int32 planes [n, K, P, Wp] -> the int64 words [n, K, P, w32 / 2]
    that hold bins (the first ``w32`` int32 words of a row)."""
    return planes[..., :w32].contiguous().view(torch.int64)


def match_counts(q64, r64, block=8):
    """int32 [nq, nr, K] bins whose signature agrees in every plane, from
    the ``words64`` of the queries and the references (one device)."""
    nq, K, P, w64 = q64.shape
    nr = r64.shape[0]
    out = torch.empty((nq, nr, K), dtype=torch.int32, device=q64.device)
    for start in range(0, nq, block):
        q = q64[start:start + block]
        for k in range(K):
            diff = q[:, None, k, 0] ^ r64[None, :, k, 0]
            for p in range(1, P):
                diff |= q[:, None, k, p] ^ r64[None, :, k, p]
            out[start:start + block, :, k] = (
                64 * w64 - popcount64(diff).sum(-1)).to(torch.int32)
    return out


def _tf32(x):
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _dtype(precision):
    return {"float64": torch.float64, "tf32": torch.float32,
            "bfloat16": torch.bfloat16}[precision]


def _contract(a, b, precision):
    """sum over the last axis of a * b, TF32 operands under "tf32"."""
    if precision == "tf32":
        a, b = _tf32(a), _tf32(b)
    return (a * b).sum(-1)


def distances(counts, klist, len_q, len_r, freq_q, freq_r, sketchsize64,
              bbits, precision="float64", random_correct=True, use_rc=True):
    """(core, accessory) [nq, nr, 2] in the working dtype of
    ``precision``, from int counts [nq, nr, K] and the genomes' lengths
    [n] and ACGT frequencies [n, 4] (on the counts' device)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    dt = _dtype(precision)
    dev = counts.device
    nbins = 64 * sketchsize64
    chance = 2.0 ** -bbits
    jac = ((counts.to(dt) / nbins - chance) / (1 - chance)).clamp(0, 1)
    if random_correct:
        fq = torch.as_tensor(freq_q, device=dev).to(dt)
        fr = torch.as_tensor(freq_r, device=dev).to(dt)
        same = _contract(fq[:, None, :], fr[None, :, :], precision)
        other = _contract(fq[:, None, :], fr.flip(-1)[None, :, :], precision)
        lq = torch.as_tensor(len_q, device=dev).to(dt)
        lr = torch.as_tensor(len_r, device=dev).to(dt)
        cols = []
        for i, k in enumerate(klist):
            p = same ** k + (other ** k if use_rc else 0)
            n1 = (lq - k + 1).clamp(min=1)[:, None]
            n2 = (lr - k + 1).clamp(min=1)[None, :]
            inter = n1 * n2 * p
            union = n1 + n2 - inter
            r = torch.where(union > 0, inter / union.clamp(min=1e-30),
                            torch.ones_like(union))
            r = r.clamp(0, 1 - 1e-6)
            cols.append(((jac[..., i] - r) / (1 - r)).clamp(0, 1))
        jac = torch.stack(cols, -1)
    return kmer_fit(jac, klist, precision)


def kmer_fit(jac, klist, precision="float64"):
    """[..., K] Jaccards -> [..., 2] (core, accessory): the box-constrained
    least squares of log j on k, whose optimum lies inside the box or on
    one of its faces b0 = 0, b1 = 0 or at the corner."""
    dt = jac.dtype
    k = torch.as_tensor(np.asarray(klist, np.float64), device=jac.device).to(dt)
    use = jac > 0
    w = use.to(dt)
    y = torch.log(torch.where(use, jac, torch.ones_like(jac)))
    ones = torch.ones_like(w)
    sw = _contract(w, ones, precision)
    sk = _contract(w, k.expand_as(w), precision)
    skk = _contract(w, (k * k).expand_as(w), precision)
    sy = _contract(w, y, precision)
    sky = _contract(w * y, k.expand_as(w), precision)
    det = sw * skk - sk * sk
    ok = det > 0
    b1 = torch.where(ok, (sw * sky - sk * sy) / torch.where(ok, det, 1), 0)
    b0 = torch.where(ok, (sy - b1 * sk) / sw.clamp(min=1), 0)

    def sse(c0, c1):
        resid = y - c0[..., None] - c1[..., None] * k
        return (w * resid * resid).sum(-1)

    zero = torch.zeros_like(b0)
    faces = [(zero, (sky / skk.clamp(min=1e-12)).clamp(max=0)),
             ((sy / sw.clamp(min=1)).clamp(max=0), zero),
             (zero, zero)]
    best0, best1 = faces[0]
    best = sse(best0, best1)
    for c0, c1 in faces[1:]:
        s = sse(c0, c1)
        take = s < best
        best0 = torch.where(take, c0, best0)
        best1 = torch.where(take, c1, best1)
        best = torch.where(take, s, best)
    inside = ok & (b0 <= 0) & (b1 <= 0)
    b0 = torch.where(inside, b0, best0)
    b1 = torch.where(inside, b1, best1)
    few = sw < 2
    core = torch.where(few, torch.ones_like(b1), 1 - torch.exp(b1))
    acc = torch.where(few, torch.ones_like(b0), 1 - torch.exp(b0))
    return torch.stack([core, acc], -1)


def block_distances(planes_q, planes_r, len_q, len_r, freq_q, freq_r, cfg,
                    precision="float64", block=8):
    """The reference's (core, accessory) of every query against every
    reference, float64 numpy [nq, nr, 2], in query blocks of ``block``."""
    w32 = 2 * cfg["sketchsize64"]
    q64, r64 = words64(planes_q, w32), words64(planes_r, w32)
    out = np.empty((planes_q.shape[0], planes_r.shape[0], 2), np.float64)
    for start in range(0, planes_q.shape[0], block):
        sl = slice(start, start + block)
        counts = match_counts(q64[sl], r64, block)
        out[sl] = distances(
            counts, cfg["kmers"], len_q[sl], len_r, freq_q[sl], freq_r,
            cfg["sketchsize64"], cfg["bbits"], precision,
            cfg["random_correct"], cfg["use_rc"]).double().cpu().numpy()
    return out


def widest(a, b):
    """The widest |a - b|; infinite where either holds a NaN."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float("inf") if np.isnan(d).any() else float(d.max(initial=0.0))

