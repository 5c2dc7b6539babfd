"""The standard library's ``ThreadingHTTPServer`` around an application
object with ``handle(method, path, headers, body) -> Response`` and
``close()``: the model server's front and the fleet router's. No web
framework, and no import of the engine (the router's process never
touches the card)."""

from __future__ import annotations

import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, NamedTuple

logger = logging.getLogger(__name__)


class Response(NamedTuple):
    status: int
    body: bytes
    content_type: str
    headers: Dict[str, str]


class AppHandler(BaseHTTPRequestHandler):
    server_version = "gordo-torch"
    protocol_version = "HTTP/1.1"

    def _route(self, method: str) -> None:
        app = self.server.app  # type: ignore[attr-defined]
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        response = app.handle(method, self.path, self.headers, body)
        self.send_response(response.status)
        self.send_header("Content-Type", response.content_type)
        self.send_header("Content-Length", str(len(response.body)))
        for key, value in response.headers.items():
            self.send_header(key, value)
        # the head and the body in one write (what end_headers() and a
        # second write would send apart): written apart on a kept-alive
        # connection, Nagle holds the body back until the peer ACKs the
        # head, which it delays (up to 40 ms on Linux) — a router's pooled
        # connection to a worker would wait that long per answer
        self._headers_buffer.append(b"\r\n")
        self._headers_buffer.append(response.body)
        self.flush_headers()

    def do_GET(self) -> None:  # noqa: N802 - http.server's naming
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s %s", self.address_string(), fmt % args)


class AppHTTPServer(ThreadingHTTPServer):
    """``server_close()`` also closes the application."""

    daemon_threads = True
    handler_class = AppHandler
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients, which retry after 1 s and then 3 s
    request_queue_size = 128

    def __init__(self, address, app: Any):
        super().__init__(address, self.handler_class)
        self.app = app

    def server_close(self) -> None:
        super().server_close()
        self.app.close()
