"""Outline wiki API client.

Behavior parity with the reference client (``app/outline_client.py``):
- POST JSON to ``/api/documents.list`` with pagination (100/page), per
  configured collection, deduplicating documents by id
  (reference ``outline_client.py:73-114``);
- ``documents.info`` and ``documents.export`` for content fetch
  (reference ``outline_client.py:117-127``);
- retrying transport: 3 retries with exponential backoff on 429/5xx and
  transport errors (reference ``outline_client.py:19-37``).

Tests inject ``httpx.MockTransport`` — the fake-Outline-server seam of
SURVEY.md section 4.
"""

from __future__ import annotations

import asyncio
import logging

log = logging.getLogger(__name__)

PAGE_SIZE = 100
RETRIES = 3
BACKOFF_S = 0.5
RETRY_STATUSES = {429, 500, 502, 503, 504}


class OutlineClient:
    def __init__(
        self,
        api_url: str,
        token: str,
        collections: tuple[str, ...] = (),
        transport: httpx.AsyncBaseTransport | None = None,
        timeout: float = 30.0,
    ):
        import httpx  # here, not at import: the app imports without httpx

        self.api_url = api_url.rstrip("/")
        self.collections = collections
        # HTTP/2 parity with the reference's retry transport
        # (app/outline_client.py:27-28 wraps AsyncHTTPTransport with
        # http2=True): enabled when the optional h2 package is present,
        # falling back to HTTP/1.1 otherwise — httpx hard-errors on
        # http2=True without h2, and this environment has no pip.
        try:
            import h2  # noqa: F401

            http2 = True
        except ImportError:
            http2 = False
        self._client = httpx.AsyncClient(
            transport=transport,
            http2=http2,
            timeout=timeout,
            headers={"Authorization": f"Bearer {token}"},
        )
        self.http2 = http2

    async def aclose(self) -> None:
        await self._client.aclose()

    async def _post(self, endpoint: str, payload: dict) -> dict:
        import httpx

        url = f"{self.api_url}/api/{endpoint}"
        delay = BACKOFF_S
        for attempt in range(RETRIES + 1):
            try:
                resp = await self._client.post(url, json=payload)
                if resp.status_code in RETRY_STATUSES and attempt < RETRIES:
                    raise httpx.HTTPStatusError(
                        "retryable", request=resp.request, response=resp
                    )
                resp.raise_for_status()
                return resp.json()
            except (httpx.TransportError, httpx.HTTPStatusError) as exc:
                retryable = isinstance(exc, httpx.TransportError) or (
                    isinstance(exc, httpx.HTTPStatusError)
                    and exc.response.status_code in RETRY_STATUSES
                )
                if attempt >= RETRIES or not retryable:
                    raise
                log.warning("outline %s failed (%s); retrying", endpoint, exc)
                await asyncio.sleep(delay)
                delay *= 2

    async def list_collections(self) -> list[dict]:
        """All collections visible to the token (reference
        ``outline_client.py:65-71``)."""
        data = await self._post("collections.list", {"limit": PAGE_SIZE})
        return data.get("data", []) or []

    async def list_docs(self) -> dict[str, dict]:
        """All documents across the configured collections, deduped by id.
        Returns {doc_id: {"id", "title", "updatedAt", "url"}}.

        When no collections are configured, they are discovered via
        ``collections.list`` and each is walked — the reference's
        visibility semantics (``outline_client.py:73-88``): an unfiltered
        ``documents.list`` can differ from the union of per-collection
        listings on a real Outline server. No collections visible ->
        empty result (warn), matching the reference.
        """
        out: dict[str, dict] = {}
        collections: tuple = self.collections
        if not collections:
            discovered = await self.list_collections()
            collections = tuple(
                c["id"] for c in discovered if isinstance(c, dict) and c.get("id")
            )
            if not collections:
                log.warning(
                    "no collections visible via collections.list; "
                    "returning no documents"
                )
                return out
        for coll in collections:
            offset = 0
            while True:
                payload: dict = {"offset": offset, "limit": PAGE_SIZE}
                if coll:
                    payload["collectionId"] = coll
                data = await self._post("documents.list", payload)
                docs = data.get("data", [])
                for d in docs:
                    out[d["id"]] = {
                        "id": d["id"],
                        "title": d.get("title", ""),
                        "updatedAt": d.get("updatedAt", ""),
                        "url": d.get("url", ""),
                    }
                if len(docs) < PAGE_SIZE:
                    break
                offset += PAGE_SIZE
        return out

    async def get_doc_info(self, doc_id: str) -> dict:
        data = await self._post("documents.info", {"id": doc_id})
        return data.get("data", {})

    async def export_doc(self, doc_id: str) -> str:
        data = await self._post("documents.export", {"id": doc_id})
        return data.get("data", "")
