"""CLI entry point: ``bqueryd-tpu-torch {controller,worker}``.

    bqueryd-tpu-torch controller --coordination=file:///var/run/bq
    bqueryd-tpu-torch worker --coordination=file:///var/run/bq \\
        --data_dir=/srv/bcolz --device=cuda

(or ``python -m bqueryd_tpu_torch.node ...``).  A worker runs on ``cuda``
unless ``--device=cpu`` is given, and fails at start without a card.  The
coordination URL falls back to ``BQUERYD_TPU_COORDINATION_URL``, the data
directory to ``BQUERYD_TPU_DATA_DIR``.  SIGTERM stops either role.
"""

import argparse
import logging
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="bqueryd-tpu-torch")
    parser.add_argument("role", choices=["controller", "worker"])
    parser.add_argument(
        "--coordination",
        default=None,
        help="coordination store url (redis:// | mem:// | file://)",
    )
    parser.add_argument("--data_dir", default=None)
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="the worker's torch device",
    )
    parser.add_argument("-v", action="count", default=0, help="debug logging")
    args = parser.parse_args(argv)
    kwargs = {
        "coordination_url": args.coordination,
        "loglevel": logging.DEBUG if args.v else logging.INFO,
    }
    if args.role == "controller":
        from bqueryd_tpu_torch.controller import ControllerNode

        ControllerNode(**kwargs).go()
    else:
        from bqueryd_tpu_torch.worker import WorkerNode

        WorkerNode(data_dir=args.data_dir, device=args.device, **kwargs).go()
    return 0


if __name__ == "__main__":
    sys.exit(main())
