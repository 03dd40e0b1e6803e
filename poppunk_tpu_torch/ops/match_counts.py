"""Sketch bin-match counts: the CUDA kernel's wrapper and its plain twin.

Counterpart of poppunk_tpu/ops/pallas_jaccard.py::match_counts_pallas and
its dispatcher match_counts_device. Contract, as in the reference:

    [nq, K, P, Wp] x [nr, K, P, Wp] planes -> int32 [nq, nr, K]
    matches = 32 * Wp - pad_bits - sum_w popcount(OR_p (Xq ^ Xr))

Planes are ``torch.int32`` tensors holding the reference's uint32 words bit
for bit (``ops.distances.planes_to_tensor``); pad words are zero in both
operands and contribute nothing, so both versions sum over the useful
``w32 = Wp - pad_bits // 32`` words only.

``match_counts`` launches ``csrc/match_counts.cu`` on CUDA tensors and runs
``match_counts_torch`` on CPU tensors, and nothing else: a CUDA input that
the kernel cannot take raises.
"""

import torch

from .. import _build

LAUNCHES = 0  # kernel launches in this process (see chip_smoke.py)

# plain-version working set per step: an int32 [cq, cr, K, w32] diff tile
_PLAIN_TILE_BYTES = 1 << 27


def _geometry(planes_q, planes_r, pad_bits):
    """Validate shapes / dtype; return (nq, nr, K, P, Wp, w32)."""
    for t in (planes_q, planes_r):
        if t.dtype != torch.int32:
            raise TypeError(f"planes must be torch.int32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"planes must be [n, K, P, Wp], got "
                             f"{tuple(t.shape)}")
    nq, K, P, Wp = planes_q.shape
    if tuple(planes_r.shape[1:]) != (K, P, Wp):
        raise ValueError(f"query planes {tuple(planes_q.shape)} and "
                         f"reference planes {tuple(planes_r.shape)} differ "
                         "in [K, P, Wp]")
    if pad_bits % 32 or not 0 <= pad_bits < 32 * Wp:
        raise ValueError(f"pad_bits={pad_bits} must be a multiple of 32 "
                         f"below 32 * Wp = {32 * Wp}")
    return nq, planes_r.shape[0], K, P, Wp, Wp - pad_bits // 32


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


def match_counts_torch(planes_q, planes_r, pad_bits):
    """Plain PyTorch version, on any device. Chunked over queries and
    references so the [cq, cr, K, w32] diff tile stays near 128 MB."""
    nq, nr, K, P, Wp, w32 = _geometry(planes_q, planes_r, pad_bits)
    out = torch.empty((nq, nr, K), dtype=torch.int32, device=planes_q.device)
    cr = max(1, min(nr, 1024))
    cq = max(1, _PLAIN_TILE_BYTES // (cr * K * w32 * 4))
    q_use = planes_q[..., :w32]
    r_use = planes_r[..., :w32]
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


def match_counts(planes_q, planes_r, pad_bits):
    """int32 [nq, nr, K] bin-match counts: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global LAUNCHES
    nq, nr, K, P, Wp, w32 = _geometry(planes_q, planes_r, pad_bits)
    devices = {planes_q.device, planes_r.device}
    if devices == {torch.device("cpu")}:
        return match_counts_torch(planes_q, planes_r, pad_bits)
    if len(devices) != 1 or planes_q.device.type != "cuda":
        raise ValueError(f"planes must both be on the CPU or on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    for t in (planes_q, planes_r):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("CUDA planes must be contiguous and 16-byte "
                             "aligned")
    if Wp % 4 or -(-w32 // 4) * 4 > Wp:
        raise ValueError(f"kernel reads 4-word chunks: Wp={Wp} must be a "
                         f"multiple of 4 holding w32={w32} rounded up to 4")
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
            nq, nr, K, P, Wp, w32, stream)
    if err:
        raise RuntimeError(f"match_counts kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
