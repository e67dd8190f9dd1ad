"""Network helpers of the nodes: the host's address and random-port
binds; the shard zipper and checksums of the distribution pipeline, and
a worker listing for the shell."""

import binascii
import os
import random
import socket
import tempfile
import time
import zipfile


def get_my_ip():
    """Best-effort primary IPv4 of this host.  ``BQUERYD_TPU_IP`` overrides
    it; otherwise a connected UDP socket reveals the address the kernel
    would send from (connecting a UDP socket sends no packet)."""
    override = os.environ.get("BQUERYD_TPU_IP")
    if override:
        return override
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def bind_to_random_port(sock, addr, min_port=49152, max_port=65536,
                        max_tries=100):
    """Bind a ZeroMQ socket to a random tcp port, setting its identity to
    ``<addr>:<port>`` before the bind (a ROUTER's identity must be fixed
    before peers connect, so that peers can address it by that name).
    Returns the identity."""
    import zmq

    for _ in range(max_tries):
        port = random.randrange(min_port, max_port)
        sock.identity = f"{addr}:{port}".encode()
        try:
            sock.bind(f"tcp://*:{port}")
        except zmq.ZMQError as exc:
            if exc.errno == zmq.EADDRINUSE:
                continue
            raise
        return sock.identity.decode()
    raise zmq.ZMQBindError("Could not bind socket to random port.")


def zip_to_file(file_path, destination):
    """Zip a file or directory tree into a temp file under ``destination``;
    returns ``(zip_filename, checksum)`` where the checksum is a CRC over the
    member CRCs (same contract as reference bqueryd/util.py:44-59, used to
    verify shard uploads)."""
    fd, zip_filename = tempfile.mkstemp(suffix=".zip", dir=destination)
    os.close(fd)
    with zipfile.ZipFile(zip_filename, "w", zipfile.ZIP_DEFLATED, allowZip64=True) as zf:
        if os.path.isdir(file_path):
            abs_src = os.path.abspath(file_path)
            for root, _dirs, files in os.walk(file_path):
                for name in files:
                    absname = os.path.abspath(os.path.join(root, name))
                    zf.write(absname, absname[len(abs_src) + 1:])
        else:
            zf.write(file_path, os.path.basename(file_path))
        crc_cat = "".join(str(i.CRC) for i in zf.infolist())
        checksum = hex(binascii.crc32(crc_cat.encode()) & 0xFFFFFFFF)
    return zip_filename, checksum


def tree_checksum(path):
    """CRC over the sorted set of file paths below ``path`` (structure, not
    contents — matches the reference's cheap placement check, reference
    bqueryd/util.py:76-82)."""
    names = set()
    for root, _dirs, files in os.walk(path):
        for name in files:
            names.add(os.path.join(root, name))
    return hex(binascii.crc32("".join(sorted(names)).encode()) & 0xFFFFFFFF)


def show_workers(info_data, only_busy=False):
    """Human-friendly per-node worker listing from an ``rpc.info()`` blob."""
    nodes = {}
    for w in info_data.get("workers", {}).values():
        nodes.setdefault(w.get("node"), []).append(w)
    for node, workers in sorted(nodes.items()):
        print(node)
        for w in workers:
            if only_busy and not w.get("busy"):
                continue
            print("   ", time.ctime(w.get("last_seen", 0)), w.get("workertype"), w.get("busy"))
