"""A small HTTP client on ``http.client`` for the fleet tier: the router's
forwards and fan-outs, the control plane's probes, the rollout's reloads
and the watchman's checks (where the reference uses a pooled
``requests.Session``).

:class:`Session` pools kept-alive connections per (host, port): a call
takes an idle one (or opens one) and gives it back after a complete
exchange, so a forward reuses a warm socket to its worker instead of
paying a TCP handshake per request, whichever thread makes it. A failed
exchange closes its connection and every idle one to that peer (they are
likely as stale); whether to replay is the caller's decision (a stale
kept-alive connection resets exactly as a dead peer does), and
``fresh=True`` replays on a new connection. Every transport failure, a
timeout included, raises :class:`TransportError`.
"""

from __future__ import annotations

import http.client
import json
import urllib.parse
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..analysis import lockcheck


class TransportError(OSError):
    """No HTTP answer: refused, reset, timed out, or an unparseable
    status line. An answer with any status code is not one."""


class Reply:
    """One answer: ``status_code``, case-insensitive ``headers``, the body
    as ``content`` / ``text`` / ``json()``."""

    __slots__ = ("status_code", "headers", "content")

    def __init__(self, status_code: int, headers: http.client.HTTPMessage, content: bytes):
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self) -> Any:
        """The body parsed as JSON; ``ValueError`` when it is not."""
        return json.loads(self.content.decode("utf-8"))

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise TransportError(f"HTTP {self.status_code}")


def _split(url: str) -> Tuple[str, int, str]:
    parts = urllib.parse.urlsplit(url)
    if parts.scheme != "http" or not parts.hostname:
        raise ValueError(f"not an http:// URL: {url!r}")
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    return parts.hostname, parts.port or 80, target


class Session:
    """Kept-alive connections per (host, port), shared by every thread."""

    # idle connections kept per peer; more are closed on return
    MAX_IDLE = 32

    def __init__(self):
        self._lock = lockcheck.named_lock("utils.http")
        self._idle: Dict[Tuple[str, int], List[http.client.HTTPConnection]] = {}

    def _checkout(self, key: Tuple[str, int], timeout: float,
                  fresh: bool) -> http.client.HTTPConnection:
        if not fresh:
            with self._lock:
                idle = self._idle.get(key)
                if idle:
                    conn = idle.pop()
                    conn.timeout = timeout
                    if conn.sock is not None:
                        conn.sock.settimeout(timeout)
                    return conn
        return http.client.HTTPConnection(key[0], key[1], timeout=timeout)

    def _checkin(self, key: Tuple[str, int], conn: http.client.HTTPConnection) -> None:
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if len(idle) < self.MAX_IDLE:
                idle.append(conn)
                return
        conn.close()

    def _forget(self, key: Tuple[str, int]) -> None:
        with self._lock:
            stale = self._idle.pop(key, [])
        for conn in stale:
            conn.close()

    def request(
        self,
        method: str,
        url: str,
        body: Optional[bytes] = None,
        headers: Optional[Mapping[str, str]] = None,
        timeout: float = 60.0,
        params: Optional[Mapping[str, Any]] = None,
        fresh: bool = False,
    ) -> Reply:
        if params:
            url += ("&" if "?" in url else "?") + urllib.parse.urlencode(params)
        host, port, target = _split(url)
        key = (host, port)
        conn = self._checkout(key, timeout, fresh)
        if body is None and method in ("POST", "PUT"):
            body = b""
        try:
            conn.request(method, target, body=body, headers=dict(headers or {}))
            response = conn.getresponse()
            content = response.read()
        except (OSError, http.client.HTTPException) as exc:
            conn.close()
            self._forget(key)
            raise TransportError(f"{method} {url}: {type(exc).__name__}: {exc}") from exc
        if response.will_close:
            conn.close()
        else:
            self._checkin(key, conn)
        return Reply(response.status, response.headers, content)

    def get(self, url: str, timeout: float = 60.0,
            params: Optional[Mapping[str, Any]] = None) -> Reply:
        return self.request("GET", url, timeout=timeout, params=params)

    def post(self, url: str, body: bytes = b"", timeout: float = 60.0,
             headers: Optional[Mapping[str, str]] = None) -> Reply:
        return self.request("POST", url, body=body, headers=headers, timeout=timeout)

    def close(self) -> None:
        """Close every idle connection; later calls reconnect."""
        with self._lock:
            idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()


def get(url: str, timeout: float = 5.0) -> Reply:
    """One GET on a connection of its own."""
    session = Session()
    try:
        return session.get(url, timeout=timeout)
    finally:
        session.close()
