"""Host-RAM spill tier (port of ``gordo_components_tpu/server/host_cache.py``).

The memory level between the card and the model store. A lazily booted
fleet (``ModelServer(lazy_boot=True)``) materialises nothing of a machine
until its first request, which pays the store path: read, manifest
verification, deserialisation and the engine's lift into a host tree. This
cache holds the end product of that trip, the machine's spill bundle, so a
machine that is not stacked on the card pays one host-to-device copy
instead of the store path.

Bounded by bytes (``GORDO_HOST_CACHE_MB``), not entries: bundle sizes
follow the fleet's widths, and an operator reasons in RAM. ``0`` disables
the tier cleanly: every spill request pays the store path.

One ``threading.Lock`` guards the LRU dict and the byte ledger. Loads,
device copies and program work run outside it, since it is on the request
path. The prefetch worker is a daemon thread fed by a bounded queue:
placement hints are advisory, so a full queue drops a hint rather than
blocking the hinter. :meth:`HostTierCache.close` stops the worker.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from ..analysis import lockcheck
from ..observability import spans
from ..observability.registry import REGISTRY

logger = logging.getLogger(__name__)

_M_EVENTS = REGISTRY.counter(
    "gordo_engine_host_cache_events_total",
    "Host-RAM spill tier lifecycle: hit (entry served from host RAM), "
    "miss (store path paid), store (a load completed and was cached), "
    "evict (LRU eviction under the byte cap), oversize (entry larger "
    "than the whole cap — served but never cached), prefetch (a "
    "placement-hint load completed), prefetch_skip (hint already "
    "cached/in flight), prefetch_drop (hint queue full), "
    "prefetch_error (hint load failed)",
    labels=("event",),
)
_M_BYTES = REGISTRY.gauge(
    "gordo_engine_host_cache_bytes",
    "Bytes of deserialized pre-stacked host arrays held by the spill "
    "tier (bounded by GORDO_HOST_CACHE_MB)",
)
_M_ENTRIES = REGISTRY.gauge(
    "gordo_engine_host_cache_entries",
    "Machines whose host entry is resident in the spill tier",
)
_M_LOAD_SECONDS = REGISTRY.histogram(
    "gordo_engine_host_cache_load_seconds",
    "Store-path duration on a spill-tier miss (disk read + manifest "
    "verify + deserialize + entry build) — the cost a hit's memcpy "
    "replaces",
)

# prefetch is advisory: a burst of hints beyond this is dropped (counted),
# never a blocked hinter or an unbounded backlog
_PREFETCH_QUEUE_MAX = 1024


class _Stop:
    """close() sentinel, addressed to ONE worker thread: a worker spawned
    after the close discards a stale sentinel and keeps loading."""

    __slots__ = ("thread",)

    def __init__(self, thread: threading.Thread):
        self.thread = thread


class HostTierCache:
    """Byte-bounded LRU of per-machine host entries, with async prefetch.

    ``cap_bytes <= 0`` disables the tier: ``get`` always misses, ``put``
    is a no-op and prefetch hints are dropped, so callers pay the store
    path every time.
    """

    def __init__(self, cap_bytes: int):
        self.cap_bytes = max(0, int(cap_bytes))
        self._lock = lockcheck.named_lock("engine.host_cache")
        self._entries: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        # names whose prefetch is queued or loading (claimed under the
        # lock), so a hint storm for one machine loads it once
        self._inflight: set = set()
        self._queue: "queue.Queue" = queue.Queue(maxsize=_PREFETCH_QUEUE_MAX)
        self._worker: Optional[threading.Thread] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.loads = 0
        self.prefetches = 0
        # the cost ledger's smoothed hit-path and store-path latencies
        # (seconds), written outside the lock: a lost race drops one sample
        self.hit_latency_ewma: Optional[float] = None
        self.load_latency_ewma: Optional[float] = None
        self._latency_alpha = 0.05

    @property
    def enabled(self) -> bool:
        return self.cap_bytes > 0

    # -- core --------------------------------------------------------------------
    def get(self, name: str) -> Optional[Any]:
        """The cached entry (moved to the LRU's young end) or None; counts
        a hit or a miss."""
        started = time.perf_counter()
        with self._lock:
            lockcheck.assert_guard("engine.host_cache")
            cached = self._entries.get(name)
            if cached is not None:
                self._entries.move_to_end(name)
                self.hits += 1
            else:
                self.misses += 1
        if cached is None:
            _M_EVENTS.labels("miss").inc()
            return None
        _M_EVENTS.labels("hit").inc()
        self.hit_latency_ewma = self._fold_latency(
            self.hit_latency_ewma, time.perf_counter() - started)
        return cached[0]

    def _fold_latency(self, prev: Optional[float], sample: float) -> float:
        return sample if prev is None else prev + self._latency_alpha * (sample - prev)

    def peek(self, name: str) -> Optional[Any]:
        """The cached entry without touching the LRU order or the counters:
        probes (``/healthz``) must not move what they report on."""
        with self._lock:
            lockcheck.assert_guard("engine.host_cache")
            cached = self._entries.get(name)
        return None if cached is None else cached[0]

    def put(self, name: str, entry: Any, nbytes: int) -> bool:
        """Cache ``entry`` (``nbytes``: its host footprint), evicting from
        the LRU's old end to stay under the cap. False when the tier is off
        or the entry alone exceeds the whole cap (served uncached: one huge
        machine must not flush the tier)."""
        nbytes = max(0, int(nbytes))
        if not self.enabled:
            return False
        if nbytes > self.cap_bytes:
            _M_EVENTS.labels("oversize").inc()
            return False
        evicted = []
        with self._lock:
            lockcheck.assert_guard("engine.host_cache")
            old = self._entries.pop(name, None)
            if old is not None:
                self._bytes -= old[1]
            while self._bytes + nbytes > self.cap_bytes and self._entries:
                victim, (_, vbytes) = self._entries.popitem(last=False)
                self._bytes -= vbytes
                self.evictions += 1
                evicted.append(victim)
            self._entries[name] = (entry, nbytes)
            self._bytes += nbytes
            total, count = self._bytes, len(self._entries)
        for victim in evicted:
            _M_EVENTS.labels("evict").inc()
            spans.event("megabatch_residency", action="host_evict", machine=victim)
        _M_BYTES.set(total)
        _M_ENTRIES.set(count)
        return True

    def get_or_load(self, name: str, loader: Callable[[], Tuple[Any, int]]):
        """A hit, or the store path: ``loader() -> (entry, nbytes)`` runs
        outside the lock. Two racing loaders both load and the last put
        wins: wasteful, but rarer than a lock held across disk reads would
        be costly."""
        cached = self.get(name)
        if cached is not None:
            return cached
        started = time.perf_counter()
        entry, nbytes = loader()
        load_seconds = time.perf_counter() - started
        _M_LOAD_SECONDS.observe(load_seconds)
        self.load_latency_ewma = self._fold_latency(self.load_latency_ewma, load_seconds)
        with self._lock:
            self.loads += 1
        _M_EVENTS.labels("store").inc()
        self.put(name, entry, nbytes)
        return entry

    def drop(self, name: str) -> bool:
        """Remove one entry (a machine whose artifact changed generation
        must not serve its old host arrays)."""
        with self._lock:
            lockcheck.assert_guard("engine.host_cache")
            old = self._entries.pop(name, None)
            if old is not None:
                self._bytes -= old[1]
            total, count = self._bytes, len(self._entries)
        _M_BYTES.set(total)
        _M_ENTRIES.set(count)
        return old is not None

    def clear(self) -> None:
        with self._lock:
            lockcheck.assert_guard("engine.host_cache")
            self._entries.clear()
            self._bytes = 0
        _M_BYTES.set(0)
        _M_ENTRIES.set(0)

    # -- async prefetch (placement hints) ------------------------------------------
    def prefetch(self, name: str, loader: Callable[[], Tuple[Any, int]]) -> bool:
        """Queue a background load of ``name``. True when queued; a name
        already cached or in flight, a full queue and a disabled tier are
        skipped (counted): hints are advisory."""
        if not self.enabled:
            return False
        with self._lock:
            lockcheck.assert_guard("engine.host_cache")
            skip = name in self._entries or name in self._inflight
            if not skip:
                self._inflight.add(name)
        if skip:
            _M_EVENTS.labels("prefetch_skip").inc()
            return False
        # the hinting request's context: the background load's events and
        # log records carry its trace id
        ctx = spans.capture()
        try:
            self._queue.put_nowait((name, loader, ctx))
        except queue.Full:
            with self._lock:
                self._inflight.discard(name)
            _M_EVENTS.labels("prefetch_drop").inc()
            return False
        self._ensure_worker()
        return True

    def _ensure_worker(self) -> None:
        # the whole check under the lock: the worker retires under it too,
        # so a spawn decision never interleaves with a half-done retirement
        with self._lock:
            worker = self._worker
            if worker is not None and worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._prefetch_loop, name="gordo-host-prefetch", daemon=True)
            self._worker.start()

    def _prefetch_loop(self) -> None:
        while True:
            try:
                job = self._queue.get(timeout=30.0)
            except queue.Empty:
                # an idle worker retires only with a provably empty queue,
                # under the lock: a hint queued meanwhile either re-enters
                # the loop here or sees no worker and spawns one
                with self._lock:
                    if not self._queue.empty():
                        continue
                    self._worker = None
                return
            if isinstance(job, _Stop):
                self._queue.task_done()
                if job.thread is threading.current_thread():
                    return
                continue
            name, loader, ctx = job
            try:
                with spans.bind(ctx):
                    # a drop() landing between this load and its put
                    # re-caches fresh bytes; a put racing a get_or_load is
                    # last-write-wins: both end consistent
                    entry, nbytes = loader()
                    if self.put(name, entry, nbytes):
                        with self._lock:
                            self.prefetches += 1
                        _M_EVENTS.labels("prefetch").inc()
            except Exception:  # noqa: BLE001 - a hint's failure is logged, never raised
                _M_EVENTS.labels("prefetch_error").inc()
                logger.warning("Host-cache prefetch of %r failed", name, exc_info=True)
            finally:
                with self._lock:
                    self._inflight.discard(name)
                self._queue.task_done()

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Wait until queued prefetches are done; False after ``timeout``."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._lock:
                busy = bool(self._inflight) or not self._queue.empty()
            if not busy:
                return True
            time.sleep(0.01)
        return False

    def close(self, timeout: float = 30.0) -> None:
        """Stop the prefetch worker after the hints queued before it.
        Idempotent; a later hint starts a new worker."""
        with self._lock:
            worker, self._worker = self._worker, None
        if worker is None or not worker.is_alive():
            return
        self._queue.put(_Stop(worker))
        worker.join(timeout=timeout)

    # -- views --------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "cap_bytes": self.cap_bytes,
                "bytes": self._bytes,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "loads": self.loads,
                "prefetches": self.prefetches,
                "hit_latency_s": self.hit_latency_ewma,
                "load_latency_s": self.load_latency_ewma,
            }

    def resident(self) -> Tuple[str, ...]:
        """Resident names in LRU order, oldest first."""
        with self._lock:
            return tuple(self._entries)
