"""Request-scoped correlation: the request installed on a thread, and its
tenant (port of ``video_features_tpu/telemetry/context.py``).

A serving front end installs each request's id on the thread that runs it
(:func:`use_request`); every emitter of a per-video artifact reads it back
(:func:`current_request_id`): the ``request_id`` field of a
``_telemetry.jsonl`` span and of a ``_health.jsonl`` digest, the
``request_id`` of a ``_failures.jsonl`` record (only when a request is in
scope), and the ``request`` arg of a trace's ``video_attempt`` span.
``cache_scope=tenant`` salts the cache key with the tenant of that id
(:func:`current_tenant`), with no plumbing through the extractors.
Gateway-minted ids are ``{tenant}-{rid}``; an id with no dash (a
spool-direct client's ``uuid4().hex``) has no tenant. Outside serving
nothing is installed and the reads are one thread-local ``getattr``."""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

_tls = threading.local()


def current_request_id() -> Optional[str]:
    """The request id installed on this thread, if any."""
    return getattr(_tls, "request_id", None)


def tenant_of(request_id: Optional[str]) -> Optional[str]:
    """The tenant part of a ``{tenant}-{rid}`` request id, else None."""
    if not request_id:
        return None
    head, sep, rest = str(request_id).partition("-")
    return head if sep and head and rest else None


def current_tenant() -> Optional[str]:
    """The tenant of the request installed on this thread, if any."""
    return tenant_of(current_request_id())


@contextmanager
def use_request(request_id: Optional[str]) -> Iterator[None]:
    """Install ``request_id`` on this thread for a block."""
    prev = getattr(_tls, "request_id", None)
    _tls.request_id = None if request_id is None else str(request_id)
    try:
        yield
    finally:
        _tls.request_id = prev
