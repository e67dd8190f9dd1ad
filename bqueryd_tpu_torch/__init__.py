"""bqueryd_tpu_torch — the PyTorch/CUDA port of bqueryd_tpu.

The port runs the per-shard groupby query path on an NVIDIA H100: host
factorize and filter masks, the one-hot limb contraction on two CUDA
kernels written for Hopper (``csrc/onehot_groupby.cu``), and the
value-keyed host merge.  Module names follow ``bqueryd_tpu`` so each
counterpart sits at the same path.

The package imports torch and numpy, never jax and nothing of
``bqueryd_tpu``: storage, caches and the host merge are its own copies.
Importing it is light (torch loads only when a device is resolved or an
``ops`` module is imported).

Entry points run on ``cuda``.  They run on the CPU only when the caller
passes ``device="cpu"`` (the tests do); without a card and without that
request they raise instead of quietly falling back.
"""

import logging

from bqueryd_tpu_torch.version import __version__

logger = logging.getLogger("bqueryd_tpu_torch")
logger.addHandler(logging.NullHandler())


def resolve_device(device=None):
    """The torch device an entry point runs on.

    ``None`` or ``"cuda"`` give the current CUDA device and raise
    ``RuntimeError`` when torch sees no card; ``"cpu"`` is honoured only
    when asked for explicitly.  A ``torch.device`` passes through the same
    rules."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["resolve_device", "logger", "__version__"]
