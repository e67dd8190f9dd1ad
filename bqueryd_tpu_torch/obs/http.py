"""The opt-in ``/metrics`` endpoint for Prometheus scrapes.

The port's copy of ``bqueryd_tpu/obs/http.py``.  ``maybe_start(registry)``
reads ``BQUERYD_TPU_METRICS_PORT``: unset or empty means no server (the
default: ``rpc.metrics()`` works without it); an integer binds a
ThreadingHTTPServer on that port (0 picks a free one) serving:

* ``GET /metrics``  — the registry's Prometheus text;
* ``GET /healthz``  — ``ok``.

One port serves ONE node's registry: each role of a deployment is its own
process with its own port (``--metrics_port`` of the CLI sets the
variable per process).

Standard library only.
"""

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MetricsServer:
    """A running /metrics endpoint; ``close()`` releases the port."""

    def __init__(self, registry, port, host="0.0.0.0"):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] == "/metrics":
                    body = server.registry.render().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/healthz":
                    body, ctype = b"ok\n", "text/plain; charset=utf-8"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrape noise never reaches the node's logger

        self.registry = registry
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics-http-{self.port}",
            daemon=True,
        )
        self._thread.start()

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


def maybe_start(registry, logger=None, port=None):
    """Start a MetricsServer when configured; None otherwise.

    ``port=None`` reads BQUERYD_TPU_METRICS_PORT (unset/empty -> off).  A
    bind failure (port taken — e.g. two nodes in one test process sharing
    the env) is logged and swallowed: metrics export must never stop a node
    from serving queries."""
    if port is None:
        raw = os.environ.get("BQUERYD_TPU_METRICS_PORT", "").strip()
        if not raw:
            return None
        try:
            port = int(raw)
        except ValueError:
            if logger is not None:
                logger.warning(
                    "unparseable BQUERYD_TPU_METRICS_PORT=%r; /metrics off", raw
                )
            return None
    try:
        server = MetricsServer(registry, port)
    except OSError as exc:
        if logger is not None:
            logger.warning("could not bind /metrics on port %s: %s", port, exc)
        return None
    if logger is not None:
        logger.info("serving /metrics on port %d", server.port)
    return server
