"""Signatures, cache keys, and id helpers.

- :func:`verify_webhook_signature` re-implements the Outline webhook HMAC
  check (reference ``app/outline_client.py:130-140``): HMAC-SHA256 over the
  raw body, tolerant of ``sha256=`` / ``Bearer `` prefixes, constant-time
  comparison.
- :func:`embedding_cache_key` mirrors the reference embedding-cache key
  scheme ``emb:{model}:{sha256(text)}`` (reference
  ``app/llm_services.py:118-126``).
"""

from __future__ import annotations

import hashlib
import hmac
import uuid


def verify_webhook_signature(secret: str, body: bytes, signature: str | None) -> bool:
    if not secret or not signature:
        return False
    sig = signature.strip()
    for prefix in ("sha256=", "Bearer "):
        if sig.startswith(prefix):
            sig = sig[len(prefix):]
    expected = hmac.new(secret.encode("utf-8"), body, hashlib.sha256).hexdigest()
    return hmac.compare_digest(expected, sig.lower())


def sign_webhook_body(secret: str, body: bytes) -> str:
    return hmac.new(secret.encode("utf-8"), body, hashlib.sha256).hexdigest()


def embedding_cache_key(model: str, text: str) -> str:
    digest = hashlib.sha256(text.encode("utf-8")).hexdigest()
    return f"emb:{model}:{digest}"


def stable_chunk_id(source_id: str, seq: int, text: str) -> str:
    """Deterministic UUID for a chunk: stable across re-ingestions of
    identical content, distinct when text or position changes."""
    digest = hashlib.sha256(f"{source_id}:{seq}:{text}".encode("utf-8")).digest()
    return str(uuid.UUID(bytes=digest[:16], version=4))


def new_id() -> str:
    return str(uuid.uuid4())
