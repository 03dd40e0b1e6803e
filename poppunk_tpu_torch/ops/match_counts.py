"""Sketch bin-match counts: the CUDA kernel's wrapper and its plain twin.

Counterpart of poppunk_tpu/ops/pallas_jaccard.py::match_counts_pallas and
its dispatcher match_counts_device. Contract, as in the reference:

    [nq, K, P, Wp] x [nr, K, P, Wp] planes -> int32 [nq, nr, K]
    matches = 32 * Wp - pad_bits - sum_w popcount(OR_p (Xq ^ Xr))

Planes are ``torch.int32`` tensors holding the reference's uint32 words bit
for bit (``ops.distances.planes_to_tensor``); pad words are zero in both
operands and contribute nothing, so both versions sum over the useful
``w32 = Wp - pad_bits // 32`` words only. With ``plane_major=True`` both
operands are ``[K, P, n, Wp]`` instead (the reference's
``match_counts_pallas(plane_major=True)``): the layout the streaming scale
tier keeps resident, read through its strides, so a row slice
``planes[:, :, s:s+c]`` of the resident tensor is an operand without a copy.

``match_counts`` launches ``csrc/match_counts.cu`` on CUDA tensors and runs
``match_counts_torch`` on CPU tensors, and nothing else: a CUDA input that
the kernel cannot take raises.

The packed-lane formulation (pallas_jaccard.py::match_counts_pallas_packed)
computes the same counts from a relayout: ``pack_lane_groups`` puts G k-mer
lengths' useful words back to back in one row of L = round_up(G * w32, 128)
words, plane-major ``[KG, P, n, L]``. ``match_counts_packed`` launches
``csrc/match_counts_packed.cu`` on it (``match_counts_packed_torch`` on
CPU tensors). ``match_counts_device`` picks one of the two formulations by
``KERNEL_CHOICE``, as the reference's dispatcher does.
"""

import os
import sys
from typing import NamedTuple

import torch

from .. import _build

# Read once at import, with the reference's validation
# (pallas_jaccard.py:36-40): POPPUNK_TPU_KERNEL=packed routes every
# distance pass through the packed-lane formulation.
KERNEL_CHOICE = os.environ.get("POPPUNK_TPU_KERNEL", "standard").lower()
if KERNEL_CHOICE not in ("standard", "packed"):
    raise ValueError(
        f"POPPUNK_TPU_KERNEL={KERNEL_CHOICE!r}: expected 'standard' or "
        "'packed'")

LAUNCHES = 0  # standard kernel launches in this process (chip_smoke.py)
PACKED_LAUNCHES = 0  # packed kernel launches in this process

# the reference's group-width search parameters (pallas_jaccard.py:46-48),
# kept so both packages pick the same G and lay out the same bits
PACKED_TQ = 32
PACKED_TR = 128
_LANES = 128

# plain-version working set per step: an int32 [cq, cr, K, w32] diff tile
_PLAIN_TILE_BYTES = 1 << 27
# csrc/match_counts_mainloop.cuh: mc::ENCODE_ERROR
_ENCODE_ERROR = 10000


def _genome_major(planes, plane_major):
    """A [n, K, P, Wp] view of ``planes`` (a permuted view when they are
    plane-major [K, P, n, Wp]; nothing is copied)."""
    return planes.permute(2, 0, 1, 3) if plane_major else planes


def _geometry(planes_q, planes_r, pad_bits, plane_major=False):
    """Validate shapes / dtype; return (nq, nr, K, P, Wp, w32)."""
    layout = "[K, P, n, Wp]" if plane_major else "[n, K, P, Wp]"
    for t in (planes_q, planes_r):
        if t.dtype != torch.int32:
            raise TypeError(f"planes must be torch.int32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"planes must be {layout}, got "
                             f"{tuple(t.shape)}")
    q = _genome_major(planes_q, plane_major)
    r = _genome_major(planes_r, plane_major)
    nq, K, P, Wp = q.shape
    if tuple(r.shape[1:]) != (K, P, Wp):
        raise ValueError(f"query planes {tuple(planes_q.shape)} and "
                         f"reference planes {tuple(planes_r.shape)} differ "
                         "in K, P or Wp")
    if pad_bits % 32 or not 0 <= pad_bits < 32 * Wp:
        raise ValueError(f"pad_bits={pad_bits} must be a multiple of 32 "
                         f"below 32 * Wp = {32 * Wp}")
    return nq, r.shape[0], K, P, Wp, Wp - pad_bits // 32


def popcount32(x):
    """Per-element popcount of int32 words (SWAR). The sign bit is counted
    apart, so every step works on non-negative values: no shift drags the
    sign in and no sum overflows int32."""
    sign = (x >> 31) & 1
    x = x & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + sign


def match_counts_torch(planes_q, planes_r, pad_bits, plane_major=False):
    """Plain PyTorch version, on any device, in either layout. Chunked over
    queries and references so the [cq, cr, K, w32] diff tile stays near
    128 MB."""
    nq, nr, K, P, Wp, w32 = _geometry(planes_q, planes_r, pad_bits,
                                      plane_major)
    out = torch.empty((nq, nr, K), dtype=torch.int32, device=planes_q.device)
    cr = max(1, min(nr, 1024))
    cq = max(1, _PLAIN_TILE_BYTES // (cr * K * w32 * 4))
    q_use = _genome_major(planes_q, plane_major)[..., :w32]
    r_use = _genome_major(planes_r, plane_major)[..., :w32]
    for qs in range(0, nq, cq):
        q = q_use[qs:qs + cq, None]  # [cq, 1, K, P, w32]
        for rs in range(0, nr, cr):
            r = r_use[None, rs:rs + cr]  # [1, cr, K, P, w32]
            diff = q[:, :, :, 0] ^ r[:, :, :, 0]
            for p in range(1, P):
                diff |= q[:, :, :, p] ^ r[:, :, :, p]
            counts = popcount32(diff).sum(dim=-1, dtype=torch.int32)
            out[qs:qs + cq, rs:rs + cr] = 32 * w32 - counts
    return out


def _check_launch(name, err):
    """Raise on a launch function's non-zero return: a CUDA error, or
    _ENCODE_ERROR + the CUresult of a tensor map the driver refused."""
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused the "
                           f"operand layout (CUresult {err - _ENCODE_ERROR})")
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def match_counts(planes_q, planes_r, pad_bits, plane_major=False):
    """int32 [nq, nr, K] bin-match counts: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Operands are [n, K, P, Wp],
    or [K, P, n, Wp] with ``plane_major``; on the card either may be a
    strided view (a row slice of a resident tensor) with unit word stride,
    the other strides whole 16-byte chunks and a 16-byte aligned start."""
    global LAUNCHES
    nq, nr, K, P, Wp, w32 = _geometry(planes_q, planes_r, pad_bits,
                                      plane_major)
    devices = {planes_q.device, planes_r.device}
    if devices == {torch.device("cpu")}:
        return match_counts_torch(planes_q, planes_r, pad_bits, plane_major)
    if len(devices) != 1 or planes_q.device.type != "cuda":
        raise ValueError(f"planes must both be on the CPU or on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    strides = []
    for t in (planes_q, planes_r):
        g = _genome_major(t, plane_major)  # strides (genome, k, plane, word)
        if g.stride(3) != 1 or any(x % 4 for x in g.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError("CUDA planes need unit word stride, strides of "
                             "whole 16-byte chunks and a 16-byte aligned "
                             f"start; got strides {t.stride()}")
        strides += [g.stride(0), g.stride(2), g.stride(1)]
    if nq > 65535 * 64:
        raise ValueError(f"nq={nq} exceeds the kernel grid; chunk queries")
    out = torch.empty((nq, nr, K), dtype=torch.int32, device=planes_q.device)
    if nq == 0 or nr == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(planes_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.match_counts_launch(
            planes_q.data_ptr(), planes_r.data_ptr(), out.data_ptr(),
            nq, nr, K, P, w32, *strides, stream)
    _check_launch("match_counts", err)
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Packed-lane formulation


def _lane_groups(w32, k, vmem_budget=12 * 2**20, bbits=14, tq=PACKED_TQ,
                 tr=PACKED_TR):
    """(G, L, KG) as the reference picks them (pallas_jaccard.py:149-172):
    the group width with the least lane padding whose double-buffered TPU
    tiles fit its VMEM budget. The budget is the TPU's; it is kept so both
    packages lay out the same bits."""
    best = None
    for g in range(1, k + 1):
        lanes = ((g * w32 + _LANES - 1) // _LANES) * _LANES
        kg = -(-k // g)  # groups incl. a zero-padded remainder group
        occupancy = (k * w32) / (kg * lanes)
        vmem = 2 * (bbits * (tq + tr) * lanes * 4)
        if vmem > vmem_budget:
            continue
        key = (round(occupancy, 4), g)
        if best is None or key > best[0]:
            best = (key, g, lanes, kg)
    if best is None:
        raise ValueError(
            f"packed kernel: even g=1 (lanes="
            f"{((w32 + _LANES - 1) // _LANES) * _LANES}) exceeds the "
            f"{vmem_budget >> 20} MiB VMEM budget at tq={tq}, tr={tr} — "
            "pass smaller tiles or use the standard kernel")
    _, g, lanes, kg = best
    return g, lanes, kg


def pack_lane_groups(planes, w32, g, lanes, kg, plane_major=False):
    """int32 [n, K, P, Wp] (or [K, P, n, Wp]) -> plane-major packed
    [KG, P, n, L] with the reference's bits (pallas_jaccard.py:208-224):
    k-mer length ki sits in group ki // G at words (ki % G) * w32 onward;
    the rest of each row and the remainder group's spare slots are zero."""
    if not plane_major:
        planes = planes.permute(1, 2, 0, 3)  # [K, P, n, Wp]
    K, P, n, _ = planes.shape
    packed = planes.new_zeros((kg, P, n, lanes))
    for ki in range(K):
        grp, slot = divmod(ki, g)
        packed[grp, :, :, slot * w32:(slot + 1) * w32] = planes[ki, :, :, :w32]
    return packed


class PackedPlanes(NamedTuple):
    """Packed planes and the geometry needed to read them."""

    bits: torch.Tensor  # int32 [KG, P, n, L]; may be a row slice (a view)
    w32: int  # useful words per k-mer length
    g: int  # k-mer lengths per row
    k: int  # k-mer lengths, without the remainder group's spare slots

    def rows(self, start, stop):
        """Genomes start:stop, as a view: no copy of the packed tensor."""
        return self._replace(bits=self.bits[:, :, start:stop])


def pack(planes, pad_bits):
    """[n, K, P, Wp] planes -> PackedPlanes with the reference's G."""
    _, _, K, P, _, w32 = _geometry(planes, planes, pad_bits)
    g, lanes, kg = _lane_groups(w32, K, bbits=P)
    return PackedPlanes(pack_lane_groups(planes, w32, g, lanes, kg), w32, g,
                        K)


def _packed_geometry(q, r):
    """Validate two PackedPlanes; return (nq, nr, KG, P, L)."""
    for t in (q.bits, r.bits):
        if t.dtype != torch.int32:
            raise TypeError(f"packed planes must be torch.int32, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"packed planes must be [KG, P, n, L], got "
                             f"{tuple(t.shape)}")
    kg, P, nq, L = q.bits.shape
    if (q.w32, q.g, q.k) != (r.w32, r.g, r.k) or \
            (r.bits.shape[0], r.bits.shape[1], r.bits.shape[3]) != (kg, P, L):
        raise ValueError(f"packed operands differ: {tuple(q.bits.shape)} "
                         f"(w32, G, K) {(q.w32, q.g, q.k)} against "
                         f"{tuple(r.bits.shape)} {(r.w32, r.g, r.k)}")
    if kg != -(-q.k // q.g) or q.g * q.w32 > L:
        raise ValueError(f"packed geometry KG={kg}, L={L} does not hold "
                         f"K={q.k} in groups of G={q.g} x w32={q.w32}")
    return nq, r.bits.shape[2], kg, P, L


def match_counts_packed_torch(q, r):
    """Plain PyTorch version on PackedPlanes, on any device: per-word
    popcounts of the OR of plane diffs over the packed row, summed per k
    slot; the remainder group's spare slots are dropped. Chunked like
    match_counts_torch."""
    nq, nr, kg, P, _ = _packed_geometry(q, r)
    gw = q.g * q.w32  # words past gw are zero in both operands
    out = torch.empty((nq, nr, q.k), dtype=torch.int32, device=q.bits.device)
    cr = max(1, min(nr, 1024))
    cq = max(1, _PLAIN_TILE_BYTES // (cr * kg * gw * 4))
    for qs in range(0, nq, cq):
        a = q.bits[:, :, qs:qs + cq, None, :gw]  # [KG, P, cq, 1, gw]
        for rs in range(0, nr, cr):
            b = r.bits[:, :, None, rs:rs + cr, :gw]  # [KG, P, 1, cr, gw]
            diff = a[:, 0] ^ b[:, 0]
            for p in range(1, P):
                diff |= a[:, p] ^ b[:, p]
            words = popcount32(diff)  # [KG, cq, cr, gw]
            seg = words.reshape(*words.shape[:3], q.g, q.w32).sum(
                dim=-1, dtype=torch.int32)  # [KG, cq, cr, G]
            counts = seg.permute(1, 2, 0, 3).reshape(
                seg.shape[1], seg.shape[2], kg * q.g)
            out[qs:qs + cq, rs:rs + cr] = 32 * q.w32 - counts[..., :q.k]
    return out


def match_counts_packed(q, r):
    """int32 [nq, nr, K] bin-match counts from PackedPlanes: the packed
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    global PACKED_LAUNCHES
    nq, nr, kg, P, L = _packed_geometry(q, r)
    devices = {q.bits.device, r.bits.device}
    if devices == {torch.device("cpu")}:
        return match_counts_packed_torch(q, r)
    if len(devices) != 1 or q.bits.device.type != "cuda":
        raise ValueError(f"packed planes must both be on the CPU or on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    for t in (q.bits, r.bits):
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError("CUDA packed planes need unit word stride, "
                             "strides of whole 16-byte chunks and a 16-byte "
                             f"aligned start; got strides {t.stride()}")
    if nq > 65535 * 64:
        raise ValueError(f"nq={nq} exceeds the kernel grid; chunk queries")
    out = torch.empty((nq, nr, q.k), dtype=torch.int32, device=q.bits.device)
    if nq == 0 or nr == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(q.bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.match_counts_packed_launch(
            q.bits.data_ptr(), r.bits.data_ptr(), out.data_ptr(), nq, nr,
            q.k, kg, P, q.g, q.w32, *q.bits.stride()[:3],
            *r.bits.stride()[:3], stream)
    _check_launch("match_counts_packed", err)
    PACKED_LAUNCHES += 1
    return out


_PLANE_MAJOR_NOTE = [False]


def match_counts_device(planes_q, planes_r, pad_bits, plane_major=False):
    """int32 [nq, nr, K] counts by the formulation KERNEL_CHOICE names
    (pallas_jaccard.py:283-309). Under ``packed`` an operand may come packed
    already: a caller that runs many passes over one reference set packs it
    once. Plane-major callers (the scale tier's resident reference) stay on
    the standard kernel under either choice, as in the reference: packing
    would relayout the whole resident tensor on every call."""
    if KERNEL_CHOICE == "packed":
        if not plane_major:
            return match_counts_packed(*(
                p if isinstance(p, PackedPlanes) else pack(p, pad_bits)
                for p in (planes_q, planes_r)))
        if not _PLANE_MAJOR_NOTE[0]:
            _PLANE_MAJOR_NOTE[0] = True
            sys.stderr.write(
                "POPPUNK_TPU_KERNEL=packed: plane-major (resident "
                "reference) passes stay on the standard kernel — "
                "packing would relayout the full reference tensor "
                "per dispatch\n")
    return match_counts(planes_q, planes_r, pad_bits, plane_major)
