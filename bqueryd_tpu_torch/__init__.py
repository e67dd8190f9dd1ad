"""bqueryd_tpu_torch — the PyTorch/CUDA port of bqueryd_tpu.

The port runs the groupby query path on an NVIDIA H100 behind the
system's own entry points: an RPC client, a controller and calc workers
talking ZMQ, found through the coordination store (``rpc``,
``controller``, ``worker``, ``node``).  A worker runs each query on the
executor (one key alignment, one one-hot contraction over every shard's
rows on two CUDA kernels written for Hopper, ``csrc/onehot_groupby.cu``)
or per shard on the engine, and the client merges by key value.  Module
names follow ``bqueryd_tpu`` so each counterpart sits at the same path.

The package imports torch, numpy and zmq, never jax and nothing of
``bqueryd_tpu``: storage, caches, the host merge, the wire protocol, the
coordination store, the logical plan, the serving layer (``serve``), the
metrics registry and flight recorder (``obs``), the distribution pipeline
(``blob``, ``download``) and the bcolz v1 reader are its own copies.  Importing it
is light (torch loads only when a device is resolved or an ``ops``
module is imported).

Entry points run on ``cuda``.  They run on the CPU only when the caller
passes ``device="cpu"`` (the tests do); without a card and without that
request they raise instead of quietly falling back.
"""

import logging
import os

from bqueryd_tpu_torch.version import __version__

logger = logging.getLogger("bqueryd_tpu_torch")
logger.addHandler(logging.NullHandler())


def configure_logging(loglevel=logging.INFO):
    """Attach a stream handler to the package logger and set its level.

    Called by the node constructors, the RPC client and the CLI, never at
    import time, so embedding applications keep their logging config."""
    if not any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.NullHandler)
        for h in logger.handlers
    ):
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
    logger.setLevel(loglevel)


# The store key and environment names are the reference package's, so
# clients of either package find controllers of either package in one
# store.

#: root of served shard directories
DEFAULT_DATA_DIR = os.environ.get("BQUERYD_TPU_DATA_DIR", "/srv/bcolz/")
#: staging area of in-flight downloads
INCOMING = os.path.join(DEFAULT_DATA_DIR, "incoming")

#: coordination-store set that holds the live controllers' addresses
REDIS_SET_KEY = "bqueryd_controllers"
#: download tickets (one hash each) and the TTL locks that claim their
#: slots: the reference's key names, so that a node of either package
#: claims and activates the other's tickets
REDIS_TICKET_KEY_PREFIX = "bqueryd_download_ticket_"
REDIS_DOWNLOAD_LOCK_PREFIX = "bqueryd_download_lock_"
#: TTL of a download claim, seconds
REDIS_DOWNLOAD_LOCK_DURATION = 60 * 30

DEFAULT_COORDINATION_URL = os.environ.get(
    "BQUERYD_TPU_COORDINATION_URL", "redis://127.0.0.1:6379/0"
)


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


__all__ = [
    "resolve_device", "configure_logging", "logger", "DEFAULT_DATA_DIR",
    "INCOMING", "REDIS_SET_KEY", "REDIS_TICKET_KEY_PREFIX",
    "REDIS_DOWNLOAD_LOCK_PREFIX", "REDIS_DOWNLOAD_LOCK_DURATION",
    "DEFAULT_COORDINATION_URL", "__version__",
]
