"""Where compute runs: the card, unless the caller asks for the CPU.

``resolve`` is the one place a device is chosen. A ``device`` given by the
caller is used as it is: passing ``torch.device("cpu")`` is how a library
caller asks for the CPU. Without one, the stage runs on ``cuda:<deviceid>``
unless the environment variable ``POPPUNK_TPU_TORCH_DEVICE`` is ``cpu``,
which is how the CLIs (whose flags are the JAX package's) and the CPU
tests ask for the CPU; any other value is refused. Without CUDA and
without that request, ``resolve``
raises: nothing falls back to the CPU silently.

The CLIs keep PopPUNK's GPU flags (PopPUNK/__main__.py:216-220):
``--gpu-dist`` and ``--gpu-model`` ask for the card for the distance
engine and the model fit, whatever the environment says, and
``--deviceid`` picks the card.
"""

import os

import torch

ENV = "POPPUNK_TPU_TORCH_DEVICE"


def set_full_precision():
    """Keep float32 products in full float32 on the card: the random-match
    dots and the BGMM algebra would lose ~3 digits under TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _card(deviceid):
    if not torch.cuda.is_available():
        raise RuntimeError(
            "poppunk_tpu_torch runs on a CUDA card, but "
            "torch.cuda.is_available() is False; set "
            f"{ENV}=cpu (or pass device=torch.device('cpu')) to run on the "
            "CPU")
    if not 0 <= deviceid < torch.cuda.device_count():
        raise RuntimeError(
            f"--deviceid {deviceid}: only {torch.cuda.device_count()} CUDA "
            "device(s) visible")
    set_full_precision()
    return torch.device("cuda", deviceid)


def resolve(device=None, deviceid=0):
    """The device to compute on: ``device`` if given, else the CPU when
    ``POPPUNK_TPU_TORCH_DEVICE=cpu``, else ``cuda:<deviceid>``."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            set_full_precision()
        return device
    choice = os.environ.get(ENV, "").strip().lower()
    if choice == "cpu":
        return torch.device("cpu")
    if choice:
        raise ValueError(f"{ENV}={choice!r}: expected 'cpu' or unset")
    return _card(deviceid)


def flagged(flag, deviceid=0):
    """The card when a CLI's ``--gpu-*`` flag is set, else ``resolve``'s
    choice."""
    return _card(deviceid) if flag else resolve(None, deviceid)


def stage_devices(args):
    """(distance device, model device) for parsed CLI ``args``: the card
    for a stage whose ``--gpu-*`` flag is set, else ``resolve``'s
    choice."""
    deviceid = getattr(args, "deviceid", 0)
    return tuple(flagged(getattr(args, flag, False), deviceid)
                 for flag in ("gpu_dist", "gpu_model"))
