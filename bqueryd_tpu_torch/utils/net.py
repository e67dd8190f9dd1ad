"""Network helpers of the nodes: the host's address and random-port binds."""

import os
import random
import socket


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
