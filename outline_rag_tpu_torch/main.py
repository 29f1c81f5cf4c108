"""Process entrypoint + admin CLI.

Startup semantics of the reference lifespan (reference
``app/main.py:92-127``): config validation (SECRET_KEY required outside
dev, webhook secret required when signing is on — reference
``main.py:99-104``), data dir creation, store init, background worker
spawn; then the asyncio HTTP server (replacing uvicorn).

The app runs on the CUDA card (``device="cuda"``): without one, building
it raises (no CPU fallback). ``main(device="cpu")`` is for tests.

Commands (``python -m outline_rag_tpu_torch <cmd>``):
  serve (default)      run the HTTP service
  refresh              one-shot Outline delta sync into the index
  rebuild              rebuild the device index from the document store
  save-index PATH      snapshot the index to PATH(.npz + .meta.json)
  status               print index/doc counts
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys

from outline_rag_tpu_torch.config import load_settings
from outline_rag_tpu_torch.serve.app import build_app
from outline_rag_tpu_torch.serve.http import run
from outline_rag_tpu_torch.utils.logging import setup_logging

log = logging.getLogger(__name__)


def _admin(settings, command: str, arg: str | None, device: str) -> None:
    app = build_app(settings, device=device, start_workers=False)
    ing = app.state["ingestor"]
    index = app.state["index"]
    meta = app.state["meta"]
    if command == "refresh":
        if ing is None:
            log.error("OUTLINE_API_URL not configured")
            sys.exit(1)

        async def go():
            from outline_rag_tpu_torch.sync.refresh import TASK_QUEUE

            bus = app.state["bus"]
            await ing.refresh_all()
            while True:
                item = await bus.pop(TASK_QUEUE, timeout=0.1)
                if item is None:
                    break
                if item["task"] == "process_doc_batch":
                    await ing.process_doc_batch(item["ids"])
            from outline_rag_tpu_torch.sync.refresh import refresh_status

            print(await refresh_status(bus))

        asyncio.run(go())
    elif command == "rebuild":
        if ing is None:
            # rebuild reads the LOCAL document store, but the Ingestor is
            # only wired when the Outline API is configured — exit loudly
            # instead of printing a truthy-looking "rebuilt 0 documents"
            raise SystemExit(
                "rebuild needs the ingestion wiring (set OUTLINE_API_URL; "
                "the rebuild itself reads only the local document store)"
            )
        n = ing.rebuild_from_store()
        print(f"rebuilt {n} documents; index size {index.size}")
    elif command == "save-index":
        path = arg or os.path.join(settings.data_dir, "index_snapshot")
        index.save(path)
        print(f"saved index ({index.size} rows) to {path}")
    elif command == "status":
        print(
            {
                "documents": meta.doc_count(),
                "chunks": meta.chunk_count(),
                "index_size": index.size,
                "index_capacity": index._shard.capacity,
                "dtype": index.dtype,
                "fused": app.state["retrieval"].fused,
            }
        )
    else:
        log.error("unknown command %r", command)
        sys.exit(2)


def main(device: str = "cuda") -> None:
    settings = load_settings()
    setup_logging(settings.log_level)
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    command = args[0] if args else "serve"
    if command != "serve":
        os.makedirs(settings.data_dir or ".", exist_ok=True)
        _admin(settings, command, args[1] if len(args) > 1 else None, device)
        return
    if not settings.secret_key:
        if os.environ.get("ALLOW_INSECURE_DEV") == "1":
            log.warning("SECRET_KEY unset; using insecure dev secret")
        else:
            log.error("SECRET_KEY must be set (or ALLOW_INSECURE_DEV=1)")
            sys.exit(1)
    if settings.outline_webhook_sign and settings.outline_api_url and not settings.outline_webhook_secret:
        log.error(
            "OUTLINE_WEBHOOK_SECRET must be set when OUTLINE_WEBHOOK_SIGN=true"
        )
        sys.exit(1)
    os.makedirs(settings.data_dir, exist_ok=True)
    os.makedirs(settings.attachments_dir, exist_ok=True)
    app = build_app(settings, device=device)
    log.info(
        "starting %s on %s:%d (index dtype=%s capacity=%d, fused=%s)",
        settings.app_name,
        settings.host,
        settings.port,
        settings.index_dtype,
        settings.shard_capacity,
        app.state["retrieval"].fused,
    )
    run(app, settings.host, settings.port,
        drain_timeout=settings.drain_timeout)


if __name__ == "__main__":
    main()
