"""A checksummed store of built kernel libraries beside the models (the
counterpart of ``gordo_components_tpu/compile_cache/store.py``).

Every process of the port needs its CUDA kernels as shared libraries, and
``nvcc`` takes seconds to minutes to build them. This store keeps the
built libraries, so that a boot, a respawned worker or a new node loads
them instead of building them, and needs no CUDA toolkit to do so.

Layout, one entry per library, committed through the model store's
atomic machinery (a torn write is invisible; a damaged entry fails
verification instead of loading)::

    <root>/
      cc-<sha256(key)[:32]>/
        KEY.json        # full key: program identity + backend fingerprint
        META.json       # build seconds, nvcc version, created (not in the key)
        library.so      # the library's bytes
        MANIFEST.json   # per-file SHA-256 + size (store/atomic.py)

The load path is never fatal for a reason of the cache:

- entry absent → **miss** (the caller builds and writes back);
- the manifest fails, or the library fails its probe → **invalid** (the
  caller builds, and the write-back replaces the bad entry: the store
  heals itself);
- the stored ``KEY.json`` disagrees with the expected key → **stale**
  (the caller builds, as for a miss);
- a crash mid-write leaves only ``.staging-*`` debris that the next
  ``purge`` sweeps.

The manifest's SHA-256 pass runs before anything is loaded, and the bytes
that are loaded are hashed again as they are copied to a private file,
which is what ``dlopen`` sees: a file that never changes while it is
loaded, whatever later happens to the entry. The entry holds no pickle.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import logging
import os
import shutil
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis import lockcheck
from ..observability.registry import REGISTRY
from ..store.atomic import atomic_commit, sweep_leftovers
from ..store.errors import StoreError
from ..store.manifest import verify_artifact
from . import fingerprint as fp

logger = logging.getLogger(__name__)

KEY_FILE = "KEY.json"
LIBRARY_FILE = "library.so"
# measurements beside the key (not part of it): the build seconds this
# entry saves, read back by the telemetry's compile block, and the
# compiler's version
META_FILE = "META.json"

# a path, or "off" to turn the store off where a models root would
# default one on
STORE_ENV = "GORDO_COMPILE_CACHE_STORE"
# the port's entries live in a subdirectory of the reference's default
# root: either package's entries() and purge() walk only the cc-*
# directories directly under their own root, so neither can touch the
# other's entries
DEFAULT_DIRNAME = ".compile-cache"
PORT_SUBDIR = "torch-cuda"

_CHUNK = 1 << 20

_M_LOOKUPS = REGISTRY.counter(
    "gordo_compile_cache_lookups_total",
    "Kernel-library store lookups by kind and outcome: hit (library loaded, "
    "no nvcc), miss (no entry), stale (the entry's stored key disagrees), "
    "invalid (a damaged entry, or one whose probe failed). Everything but "
    "'hit' builds the library and is never fatal",
    labels=("kind", "outcome"),
)
_M_WRITES = REGISTRY.counter(
    "gordo_compile_cache_writes_total",
    "Kernel-library store write-backs, by outcome (ok / error)",
    labels=("outcome",),
)
_M_LOAD_SECONDS = REGISTRY.histogram(
    "gordo_compile_cache_load_seconds",
    "Duration of a successful entry load (verify, copy, load, probe): the "
    "cost that replaces a build",
)

_PRIVATE_LOCK = lockcheck.named_lock("compile_cache.private")
_PRIVATE_DIR: Optional[str] = None


def private_dir() -> str:
    """This process's directory of loaded libraries (removed at exit).
    Each file in it is written once and never replaced while loaded."""
    global _PRIVATE_DIR
    with _PRIVATE_LOCK:
        if _PRIVATE_DIR is None:
            _PRIVATE_DIR = tempfile.mkdtemp(prefix="gordo-kernels-")
            atexit.register(shutil.rmtree, _PRIVATE_DIR, True)
        return _PRIVATE_DIR


def private_path(stem: str) -> str:
    """A fresh, never reused path in :func:`private_dir`."""
    return os.path.join(private_dir(), f"{stem}-{uuid.uuid4().hex[:8]}.so")


def _copy_hashed(src: str, dst: str) -> str:
    """Copy ``src`` to ``dst`` and return the SHA-256 of the bytes copied."""
    digest = hashlib.sha256()
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        for chunk in iter(lambda: fin.read(_CHUNK), b""):
            digest.update(chunk)
            fout.write(chunk)
    return digest.hexdigest()


class CompileCacheStore:
    """One store root; thread-safe (entries are immutable once committed,
    commits are atomic renames, concurrent writers of one key last-win).

    ``counters`` count this store object's lookups and writes."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.counters: Dict[str, int] = {
            "hit": 0, "miss": 0, "stale": 0, "invalid": 0,
            "write": 0, "write_error": 0,
        }
        self._lock = lockcheck.named_lock("compile_cache.store")

    def _entry(self, program_key: Dict[str, Any]) -> Tuple[Dict[str, Any], str]:
        """The full key of ``program_key`` and its entry's directory."""
        key = fp.full_key(program_key)
        return key, os.path.join(self.root, fp.entry_name(key))

    def path_of(self, program_key: Dict[str, Any]) -> str:
        return self._entry(program_key)[1]

    # -- lookup --------------------------------------------------------------
    def get(
        self,
        program_key: Dict[str, Any],
        load: Callable[[str], Any],
        probe: Optional[Callable[[Any], None]] = None,
    ) -> Optional[Any]:
        """The loaded library for ``program_key``, or ``None`` (miss, stale
        or invalid: the caller builds either way). See :meth:`lookup`."""
        return self.lookup(program_key, load, probe)[1]

    def lookup(
        self,
        program_key: Dict[str, Any],
        load: Callable[[str], Any],
        probe: Optional[Callable[[Any], None]] = None,
    ) -> Tuple[str, Optional[Any]]:
        """``(outcome, loaded)``: ``("hit", loaded library)``, or ``("miss"
        | "stale" | "invalid", None)``.

        ``load(path)`` loads the library from ``path``, a private copy of
        the verified bytes; ``probe(loaded)`` runs before it is adopted and
        raises if the library does not compute what it should here."""
        kind = str(program_key.get("kind", "unknown"))
        key, path = self._entry(program_key)
        if not os.path.isdir(path):
            return self._count(kind, "miss"), None
        started = time.perf_counter()
        try:
            manifest = verify_artifact(path, deep=True)
        except StoreError as exc:
            logger.warning("Compile-cache entry %s fails verification (%s); building", path, exc)
            return self._count(kind, "invalid"), None
        try:
            with open(os.path.join(path, KEY_FILE)) as fh:
                stored = fh.read()
            if stored.strip() != fp.canonical(key):
                logger.warning("Compile-cache entry %s key mismatch; building", path)
                return self._count(kind, "stale"), None
            expected = manifest["files"][LIBRARY_FILE]["sha256"]
            private = private_path(os.path.basename(path))
            if _copy_hashed(os.path.join(path, LIBRARY_FILE), private) != expected:
                raise StoreError(f"{path}: {LIBRARY_FILE} changed after verification")
            loaded = load(private)
            if probe is not None:
                probe(loaded)
        except Exception as exc:  # noqa: BLE001 - every failure to load is a rebuild
            logger.warning("Compile-cache entry %s unloadable (%s: %s); building",
                           path, type(exc).__name__, exc)
            return self._count(kind, "invalid"), None
        _M_LOAD_SECONDS.observe(time.perf_counter() - started)
        return self._count(kind, "hit"), loaded

    # -- write-back ----------------------------------------------------------
    def put(
        self,
        program_key: Dict[str, Any],
        library: str,
        compile_seconds: Optional[float] = None,
        compiler: Optional[str] = None,
    ) -> bool:
        """Commit the library file at ``library`` under ``program_key``
        (atomic; an existing entry, e.g. one that just read invalid, is
        replaced whole). Never raises: a store that cannot be written
        degrades to a build at every boot. ``compile_seconds`` and
        ``compiler`` (the ``nvcc`` version) go into ``META.json``."""
        key, path = self._entry(program_key)
        try:
            os.makedirs(self.root, exist_ok=True)
            with atomic_commit(path, name=os.path.basename(path)) as staging:
                with open(os.path.join(staging, KEY_FILE), "w") as fh:
                    fh.write(fp.canonical(key) + "\n")
                shutil.copyfile(library, os.path.join(staging, LIBRARY_FILE))
                with open(os.path.join(staging, META_FILE), "w") as fh:
                    json.dump({"compile_seconds": compile_seconds, "nvcc": compiler,
                               "created": time.time()}, fh)
        except Exception as exc:  # noqa: BLE001 - a write-back is best effort
            logger.warning("Compile-cache write-back failed for %s (%s: %s)",
                           program_key, type(exc).__name__, exc)
            self._bump("write_error")
            _M_WRITES.labels("error").inc()
            return False
        self._bump("write")
        _M_WRITES.labels("ok").inc()
        return True

    def holds(self, program_key: Dict[str, Any], deep: bool = False) -> bool:
        """Whether a whole entry with this exact key exists, without
        counting a lookup: size checks, and with ``deep`` the hashes (the
        check before a write-back of a library already loaded or built)."""
        key, path = self._entry(program_key)
        try:
            verify_artifact(path, deep=deep)
            with open(os.path.join(path, KEY_FILE)) as fh:
                return fh.read().strip() == fp.canonical(key)
        except (OSError, StoreError):
            return False

    # -- maintenance (the `cache` verbs) -------------------------------------
    def entries(self) -> List[Dict[str, Any]]:
        """One record per entry: its stored key, byte size, whether it
        verifies (deep) and whether its backend fingerprint matches this
        process (``current`` False: what ``purge --stale`` removes)."""
        out: List[Dict[str, Any]] = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        current_backend = fp.backend_fingerprint()
        for name in names:
            path = os.path.join(self.root, name)
            if not name.startswith(fp.ENTRY_PREFIX) or not os.path.isdir(path):
                continue
            record: Dict[str, Any] = {"name": name, "bytes": _dir_bytes(path)}
            try:
                verify_artifact(path, deep=True)
                record["verified"] = True
            except StoreError as exc:
                record["verified"] = False
                record["error"] = f"{type(exc).__name__}: {exc}"
            try:
                with open(os.path.join(path, KEY_FILE)) as fh:
                    key = json.load(fh)
                record["program"] = key.get("program")
                record["backend"] = key.get("backend")
                record["current"] = key.get("backend") == current_backend
                # the rung the library serves, top-level so that `cache
                # list` shows a mixed-precision store at a glance
                record["precision"] = (key.get("program") or {}).get("precision", "f32")
            except Exception:  # noqa: BLE001 - an unreadable key is reported, not raised
                record.setdefault("error", "KEY.json unreadable")
                record["current"] = False
            try:
                with open(os.path.join(path, META_FILE)) as fh:
                    meta = json.load(fh)
                record["compile_seconds"] = meta.get("compile_seconds")
                record["created"] = meta.get("created")
            except Exception:  # noqa: BLE001  # lint: allow-swallow(an entry without a readable META.json sidecar lists compile_seconds None: absence is the signal, and the entry's verified load is the loud path)
                record["compile_seconds"] = None
            out.append(record)
        return out

    def purge(self, stale_only: bool = False) -> List[str]:
        """Delete entries (all, or with ``stale_only`` those whose backend
        fingerprint no longer matches or that fail verification) and sweep
        crash debris (``.staging-*``). Returns the removed names."""
        removed: List[str] = []
        for record in self.entries():
            if stale_only and record.get("current") and record.get("verified"):
                continue
            shutil.rmtree(os.path.join(self.root, record["name"]), ignore_errors=True)
            removed.append(record["name"])
        removed.extend(sweep_leftovers(self.root))
        return removed

    def _count(self, kind: str, outcome: str) -> str:
        self._bump(outcome)
        _M_LOOKUPS.labels(kind, outcome).inc()
        return outcome

    def _bump(self, name: str) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + 1


def _dir_bytes(path: str) -> int:
    total = 0
    try:
        for entry in os.scandir(path):
            if entry.is_file():
                total += entry.stat().st_size
    except OSError:
        pass
    return total


def default_root(models_root: str) -> str:
    """The store a models root defaults to: ``<models_root>/.compile-cache/
    torch-cuda`` (hidden, so the model scan never takes it for a machine)."""
    return os.path.join(models_root, DEFAULT_DIRNAME, PORT_SUBDIR)


def resolve_store(
    explicit: Optional[str] = None, models_root: Optional[str] = None
) -> Optional[CompileCacheStore]:
    """The one rule for where the store lives, shared by the server, the
    CLI and the builder's export: an explicit path beats
    ``GORDO_COMPILE_CACHE_STORE``, which beats the models-root default
    (:func:`default_root`). ``"off"`` at any level turns the store off;
    no path resolvable → ``None`` (the package's own build directory)."""
    root = explicit
    if root is None:
        root = os.environ.get(STORE_ENV) or None
    if root is None and models_root:
        root = default_root(models_root)
    if not root or root == "off":
        return None
    return CompileCacheStore(root)
