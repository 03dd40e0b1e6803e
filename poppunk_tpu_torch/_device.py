"""Resolve the compute device of each pipeline stage once, from the CLI.

PopPUNK's own meaning of its GPU flags (PopPUNK/__main__.py:216-220):
``--gpu-dist`` moves the distance engine to the card, ``--gpu-model`` the
model fit and assignment, ``--deviceid`` picks the card. Without a flag the
stage runs on the CPU. A flag given where CUDA is absent is an error, never
a silent CPU run.
"""

import torch


def set_full_precision():
    """Keep float32 products in full float32 on the card: the random-match
    dots and the BGMM algebra would lose ~3 digits under TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(use_gpu, deviceid=0):
    """``cuda:<deviceid>`` if ``use_gpu`` else the CPU."""
    if not use_gpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a --gpu-* flag was given but torch.cuda.is_available() is "
            "False; drop the flag to run this stage on the CPU")
    if not 0 <= deviceid < torch.cuda.device_count():
        raise RuntimeError(
            f"--deviceid {deviceid}: only {torch.cuda.device_count()} CUDA "
            "device(s) visible")
    set_full_precision()
    return torch.device("cuda", deviceid)


def stage_devices(args):
    """(distance device, model device) for parsed CLI ``args``."""
    deviceid = getattr(args, "deviceid", 0)
    return (resolve(getattr(args, "gpu_dist", False), deviceid),
            resolve(getattr(args, "gpu_model", False), deviceid))
