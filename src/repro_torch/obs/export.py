"""Prometheus text-format exposition for :mod:`repro_torch.obs.metrics`.

``render_prometheus`` turns a :class:`~repro_torch.obs.metrics.Registry` into
exposition text (version 0.0.4); ``MetricsServer`` serves it at
``/metrics`` from a background thread using only the standard library.
The server is off by default everywhere -- it is opted into via
``CliqueService(metrics_port=...)`` or the ``--metrics-port`` CLI flags.

The port's copy of the reference's ``repro/obs/export.py``, unchanged.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.request import urlopen

from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry

__all__ = ["render_prometheus", "MetricsServer", "scrape"]


def _fmt_labels(labels, extra=()) -> str:
    items = list(labels) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def render_prometheus(registry: Optional[Registry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    reg = registry or REGISTRY
    lines = []
    seen_family = set()

    def _family(name: str, kind: str) -> None:
        if name in seen_family:
            return
        seen_family.add(name)
        help_text = reg.help_text(name)
        if help_text:
            lines.append(f"# HELP {name} {_escape(help_text)}")
        lines.append(f"# TYPE {name} {kind}")

    for m in reg.collect():
        if isinstance(m, Counter):
            _family(m.name, "counter")
            lines.append(
                f"{m.name}{_fmt_labels(m.labels)} {_fmt_value(m.value)}"
            )
        elif isinstance(m, Gauge):
            _family(m.name, "gauge")
            lines.append(
                f"{m.name}{_fmt_labels(m.labels)} {_fmt_value(m.value)}"
            )
        elif isinstance(m, Histogram):
            _family(m.name, "histogram")
            counts, total, n = m.snapshot()
            cum = 0
            for edge, c in zip(m.edges + [float("inf")], counts):
                cum += c
                le = _fmt_labels(m.labels, [("le", _fmt_value(edge))])
                lines.append(f"{m.name}_bucket{le} {cum}")
            lab = _fmt_labels(m.labels)
            lines.append(f"{m.name}_sum{lab} {_fmt_value(total)}")
            lines.append(f"{m.name}_count{lab} {n}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    registry: Registry = REGISTRY

    def do_GET(self):  # noqa: N802 (http.server API)
        """Serve /metrics (exposition text); 404 elsewhere."""
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = render_prometheus(self.registry).encode()
        except Exception as exc:  # defensive: a collector may throw
            self.send_error(500, str(exc))
            return
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # noqa: D102 (silence per-request stderr)
        pass


class MetricsServer:
    """Background /metrics HTTP server (stdlib ``ThreadingHTTPServer``).

    ``port=0`` binds an ephemeral port; read it back via :attr:`port` /
    :attr:`address`.  ``close()`` shuts the listener down and joins the
    serving thread.
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[Registry] = None,
    ):
        handler = type("Handler", (_Handler,), {"registry": registry or REGISTRY})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-metrics",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        """The bound TCP port."""
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        """``http://host:port`` for the running server."""
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        """Stop serving and release the socket."""
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()


def scrape(address: str, timeout: float = 5.0) -> str:
    """Fetch ``/metrics`` from a running server and return the text."""
    url = address.rstrip("/") + "/metrics"
    with urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()
