"""Azure Data Lake credentials and the filesystem the lake readers read
through (the port's copy of
``gordo_components_tpu/dataset/data_provider/azure_utils.py:28-176``).

Everything up to the network runs offline: the service principal is
parsed from ``dl_service_auth_str`` (``"<tenant>:<client_id>:<secret>"``)
or the ``DL_SERVICE_AUTH_STR`` environment variable, or the device-code
flow is chosen with ``interactive``. :class:`LocalFileSystem` reads a
mounted lake; :class:`ADLFileSystem` adapts any client shaped like
``AzureDLFileSystem`` (``exists``, ``ls``, ``info``, ``open``). Only
:func:`_default_client_factory` imports the Azure SDK, and it refuses with
a ``RuntimeError`` naming the package where the SDK is missing.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, NamedTuple, Optional

ENV_AUTH_VAR = "DL_SERVICE_AUTH_STR"


class ServicePrincipal(NamedTuple):
    tenant: str
    client_id: str
    client_secret: str


def parse_dl_service_auth_str(auth_str: str) -> ServicePrincipal:
    """``"<tenant>:<client_id>:<client_secret>"`` -> its parts, checked at
    config time. Splits at most twice: a secret may hold ':'."""
    parts = auth_str.split(":", 2)
    if len(parts) != 3:
        raise ValueError(
            "dl_service_auth_str must be '<tenant>:<client_id>:"
            f"<client_secret>' (got {len(parts)} ':'-separated parts)"
        )
    blank = [name for name, part in zip(("tenant", "client_id", "client_secret"), parts)
             if not part.strip()]
    if blank:
        raise ValueError(f"dl_service_auth_str has blank component(s): {blank}")
    return ServicePrincipal(*(p.strip() for p in parts))


class LocalFileSystem:
    """A mounted lake: plain ``os`` semantics."""

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def mtime(self, path: str) -> float:
        return os.path.getmtime(path)

    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)


class ADLFileSystem:
    """The reader-facing surface over an ``AzureDLFileSystem``-shaped
    client (the SDK's, or a test's)."""

    def __init__(self, client: Any):
        self._client = client

    def isdir(self, path: str) -> bool:
        try:
            info = self._client.info(path)
        except FileNotFoundError:
            # only not-found is False: an ACL denial surfaces as itself
            return False
        return str(info.get("type", "")).upper() == "DIRECTORY"

    def exists(self, path: str) -> bool:
        return bool(self._client.exists(path))

    def listdir(self, path: str) -> List[str]:
        # ls gives full lake paths; the readers join against the directory
        return sorted(entry.rstrip("/").rsplit("/", 1)[-1] for entry in self._client.ls(path))

    def mtime(self, path: str) -> float:
        # ADL Gen1 reports epoch milliseconds
        return float(self._client.info(path).get("modificationTime", 0)) / 1000.0

    def open(self, path: str, mode: str = "rb"):
        return self._client.open(path, mode)


def _default_client_factory(
    storename: str, principal: Optional[ServicePrincipal], interactive: bool
) -> Any:
    """The one place that needs the Azure SDK and the network."""
    try:
        from azure.datalake.store import core, lib  # type: ignore
    except ImportError as exc:
        raise RuntimeError(
            "Azure Data Lake access needs the 'azure-datalake-store' "
            "package (plus network), which this environment lacks. Mount "
            "the lake and pass base_dir=<mount point>, or inject "
            "client_factory=..."
        ) from exc
    if principal is not None:
        token = lib.auth(tenant_id=principal.tenant, client_id=principal.client_id,
                         client_secret=principal.client_secret)
    else:  # resolve_adl_credentials checked: no principal means interactive
        token = lib.auth()
    return core.AzureDLFileSystem(token, store_name=storename)


def resolve_adl_credentials(
    dl_service_auth_str: Optional[str] = None, interactive: bool = False
) -> Optional[ServicePrincipal]:
    """The explicit auth string, else ``DL_SERVICE_AUTH_STR``, else the
    interactive flow (``None``); with none of them, ``ValueError``."""
    auth_str = dl_service_auth_str or os.environ.get(ENV_AUTH_VAR)
    principal = parse_dl_service_auth_str(auth_str) if auth_str else None
    if principal is None and not interactive:
        raise ValueError(
            "DataLakeProvider without base_dir needs credentials: pass "
            f"dl_service_auth_str, set {ENV_AUTH_VAR}, or interactive=True"
        )
    return principal


def create_adl_filesystem(
    storename: str,
    dl_service_auth_str: Optional[str] = None,
    interactive: bool = False,
    client_factory: Optional[Callable[..., Any]] = None,
) -> ADLFileSystem:
    """Credentials, then ``client_factory(storename, principal,
    interactive)`` (the SDK's by default) behind :class:`ADLFileSystem`."""
    principal = resolve_adl_credentials(dl_service_auth_str, interactive)
    factory = client_factory or _default_client_factory
    return ADLFileSystem(factory(storename, principal, interactive))
