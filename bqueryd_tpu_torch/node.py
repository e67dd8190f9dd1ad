"""CLI entry point: ``bqueryd-tpu-torch [controller|worker|downloader|movebcolz|import]``.

    bqueryd-tpu-torch controller --coordination=file:///var/run/bq
    bqueryd-tpu-torch worker --coordination=file:///var/run/bq \\
        --data_dir=/srv/bcolz --device=cuda
    bqueryd-tpu-torch downloader --coordination=... --data_dir=/srv/bcolz
    bqueryd-tpu-torch movebcolz --coordination=... --data_dir=/srv/bcolz
    bqueryd-tpu-torch import /old/taxi.bcolz /srv/bcolz/taxi.bcolz
    bqueryd-tpu-torch [tcp://ip:port]        # an RPC shell

(or ``python -m bqueryd_tpu_torch.node ...``).  A worker runs on ``cuda``
unless ``--device=cpu`` is given, and fails at start without a card; the
downloader and movebcolz roles and ``import`` are host work and touch no
device.  With no role an interactive shell opens with an ``rpc`` client
(IPython when it is installed, else ``code.interact``).

The coordination URL comes from ``--coordination``, else
``BQUERYD_TPU_COORDINATION_URL``, else ``coordination_url`` (or
``redis_url``) in the config file (``BQUERYD_TPU_CFG``, default
``/etc/bqueryd_tpu.cfg``, ``key = value`` lines), whose
``azure_conn_string`` also seeds ``AZURE_STORAGE_CONNECTION_STRING``.  The
data directory falls back to ``BQUERYD_TPU_DATA_DIR``.  SIGTERM stops
every daemon role.
"""

import argparse
import logging
import os
import sys

CONFIG_FILE = os.environ.get("BQUERYD_TPU_CFG", "/etc/bqueryd_tpu.cfg")


def read_config(path=CONFIG_FILE):
    """The ``key = value`` lines of the config file (``#`` comments and
    blank lines skipped, quotes stripped); empty when it does not exist."""
    config = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                config[key.strip()] = value.strip().strip("'\"")
    return config


def main(argv=None):
    parser = argparse.ArgumentParser(prog="bqueryd-tpu-torch")
    parser.add_argument(
        "role",
        nargs="?",
        choices=["controller", "worker", "downloader", "movebcolz", "import"],
        help=(
            "daemon role, or 'import <src> <dst>' to convert a legacy "
            "bcolz v1 rootdir; omit for an interactive RPC shell"
        ),
    )
    parser.add_argument(
        "address",
        nargs="?",
        help=(
            "controller address for the RPC shell (tcp://ip:port); "
            "source rootdir for 'import'"
        ),
    )
    parser.add_argument("dest", nargs="?",
                        help="destination rootdir for 'import'")
    parser.add_argument(
        "--coordination",
        default=None,
        help="coordination store url (redis:// | mem:// | file://)",
    )
    parser.add_argument("--data_dir", default=None)
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="the calc worker's torch device",
    )
    parser.add_argument("-v", action="count", default=0, help="debug logging")
    args = parser.parse_args(argv)

    config = read_config()
    coordination_url = (
        args.coordination
        or os.environ.get("BQUERYD_TPU_COORDINATION_URL")
        or config.get("coordination_url")
        or config.get("redis_url")
    )
    if config.get("azure_conn_string"):
        os.environ.setdefault(
            "AZURE_STORAGE_CONNECTION_STRING", config["azure_conn_string"]
        )
    loglevel = logging.DEBUG if args.v else logging.INFO
    kwargs = {"coordination_url": coordination_url, "loglevel": loglevel}

    if args.role == "import":
        if not args.address or not args.dest:
            parser.error("import needs <src.bcolz> <dst.bcolz>")
        from bqueryd_tpu_torch.storage.bcolz_v1 import (
            import_ctable,
            is_ctable_dir,
        )

        if not is_ctable_dir(args.address):
            parser.error(
                f"{args.address} is not a bcolz v1 ctable rootdir "
                "(no carray column subdirectories found)"
            )
        rows = import_ctable(args.address, args.dest)
        print(f"imported {rows} rows: {args.address} -> {args.dest}")
    elif args.role == "controller":
        from bqueryd_tpu_torch.controller import ControllerNode

        ControllerNode(**kwargs).go()
    elif args.role == "worker":
        from bqueryd_tpu_torch.worker import WorkerNode

        WorkerNode(data_dir=args.data_dir, device=args.device, **kwargs).go()
    elif args.role in ("downloader", "movebcolz"):
        from bqueryd_tpu_torch.worker import DownloaderNode, MoveBcolzNode

        cls = DownloaderNode if args.role == "downloader" else MoveBcolzNode
        cls(data_dir=args.data_dir, **kwargs).go()
    else:
        shell(args.address, coordination_url, loglevel)
    return 0


def shell(address, coordination_url, loglevel):
    """An interactive session with ``rpc``, a client of the cluster."""
    from bqueryd_tpu_torch.rpc import RPC

    rpc = RPC(address=address, coordination_url=coordination_url,
              loglevel=loglevel)
    banner = (
        f"bqueryd-tpu-torch shell connected to {rpc.address}\n"
        "use rpc.<verb>(...): info, groupby, download, sleep, killworkers, ..."
    )
    try:
        import IPython

        IPython.embed(banner1=banner, user_ns={"rpc": rpc})
    except ImportError:
        import code

        code.interact(banner=banner, local={"rpc": rpc})


if __name__ == "__main__":
    sys.exit(main())
