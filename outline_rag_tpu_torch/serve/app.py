"""Application wiring: the full ``/chat`` HTTP surface.

Route-for-route parity with the reference API (reference
``app/blueprints/api.py``, ``views.py``, ``auth.py``; mounted at ``/chat``
like reference ``app/main.py:167-173``):

==========================  =========================================
GET  /healthz               liveness (reference ``main.py:177-180``)
GET  /chat/                 SPA shell (``views.py:43-68``)
GET  /chat/{guid}           deep link w/ ownership check + notice cookie
GET  /chat/api/me           identity + beta-gated model catalog
GET  /chat/api/conversations         list (paged <=100)
POST /chat/api/conversations         create (user upsert first)
PUT  /chat/api/conversations/{id}    rename (403 on rowcount 0)
DELETE /chat/api/conversations/{id}  delete + message-cache invalidation
GET  /chat/api/conversations/{id}/messages   ownership before cache read
POST /chat/api/ask          the RAG serve path (SSE)
POST /chat/api/upload       attachment upload (ext allowlist)
POST /chat/update/all       refresh trigger (NX lock, 429 when held)
GET  /chat/api/refresh/status        progress aggregation
POST /chat/update/webhook   HMAC verify + debounce timer
GET  /chat/login|logout, /chat/oidc/callback  (serve.auth)
==========================  =========================================

Port of ``outline_rag_tpu/serve/app.py`` onto this package's engine, index
and local decoder. What differs from the JAX app:

- ``device``: the index, and the models of ``ENCODER_WEIGHTS_PATH``,
  ``RERANKER_WEIGHTS_PATH`` and ``DECODER_WEIGHTS_PATH``, are created there
  (``"cuda"`` by default; tests pass ``"cpu"``).
- ``devices``: the devices a mesh may take, in order (by default the
  visible devices of ``device``'s kind: every CUDA device, or the one
  CPU). As in the JAX app, ``MESH_DATA_AXIS`` (0: all of them) row-shards
  the index over the first ``ndev`` when ``ndev > 1`` and
  ``SHARD_CAPACITY`` divides by it; more than there are raises
  ``ValueError``. ``DECODER_TP`` takes its tensor-parallel mesh from the
  same list. The mesh's first device is ``device``'s place for the models.
- The snapshot restore loads onto the index's own device or mesh.
- The warm-up builds the CUDA library and launches the first scans before
  the first user arrives (nothing is compiled per shape).
"""

from __future__ import annotations

import json
import logging
import re
import time

from outline_rag_tpu_torch.config import Settings
from outline_rag_tpu_torch.device import resolve_device
from outline_rag_tpu_torch.engine.embedder import get_embedder
from outline_rag_tpu_torch.engine.service import RetrievalService
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.serve.auth import current_user, register_auth_routes
from outline_rag_tpu_torch.serve.chat import ChatPipeline
from outline_rag_tpu_torch.serve.http import App, Request, Response
from outline_rag_tpu_torch.serve.llm import FakeChatProvider, OpenAICompatProvider
from outline_rag_tpu_torch.storage import SqliteMetaStore, make_bus
from outline_rag_tpu_torch.sync.outline import OutlineClient
from outline_rag_tpu_torch.sync.refresh import (
    REFRESH_LOCK,
    TASK_QUEUE,
    WEBHOOK_TIMER,
    Ingestor,
    refresh_status,
)
from outline_rag_tpu_torch.utils.hashing import new_id, verify_webhook_signature
from outline_rag_tpu_torch.utils.profiling import request

log = logging.getLogger(__name__)

UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$"
)

_INDEX_HTML_CACHE: dict[str, str] = {}


class _InRequest:
    """An SSE body whose frames are each produced under the request id
    ``rid``: the provider's stream, started by the first frame, carries it
    to the decode batcher."""

    def __init__(self, rid: int, frames):
        self.rid, self.frames = rid, frames

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        with request(self.rid):
            return await self.frames.__anext__()

    async def aclose(self) -> None:
        await self.frames.aclose()


def _index_html(settings: Settings) -> str:
    import os

    key = settings.app_name
    if key not in _INDEX_HTML_CACHE:
        path = os.path.join(os.path.dirname(__file__), "static", "index.html")
        with open(path) as f:
            html = f.read()
        _INDEX_HTML_CACHE[key] = html.replace("{{app_name}}", settings.app_name)
    return _INDEX_HTML_CACHE[key]


def build_app(
    settings: Settings,
    *,
    device: str = "cuda",
    devices=None,
    provider=None,
    embedder=None,
    reranker=None,
    index: VectorIndex | None = None,
    meta: SqliteMetaStore | None = None,
    outline_transport=None,
    oidc_transport=None,
    start_workers: bool = True,
) -> App:
    import os

    app = App(
        secret_key=settings.secret_key or "dev-insecure-secret",
        session_max_age=settings.session_max_age,
    )
    prefix = settings.url_prefix

    bus = make_bus(settings.redis_url)
    if meta is None:
        from outline_rag_tpu_torch.storage.postgres import make_meta_store

        meta = make_meta_store(settings)
    if embedder is None:
        embedder = get_embedder(settings, device=device)
    if reranker is None and settings.reranker_weights_path:
        # the cross-encoder on the card (reference seam: remote /v1/rerank,
        # app/llm_services.py:235-344)
        from outline_rag_tpu_torch.engine.rerank import CrossEncoderReranker
        from outline_rag_tpu_torch.models.convert import load_pretrained
        from outline_rag_tpu_torch.models.reranker import Reranker
        from outline_rag_tpu_torch.models.tokenizer import HFTokenizer

        path = settings.reranker_weights_path
        try:
            model = load_pretrained(path, device)
            if not isinstance(model, Reranker):
                raise ValueError(f"{path} holds no classifier.* head")
            reranker = CrossEncoderReranker(
                model, HFTokenizer(path), max_tokens=settings.encoder_max_tokens,
                int8=settings.encoder_int8,
            )
        except Exception as exc:
            # a configured cross-encoder that cannot load is a deployment
            # error: never serve without the reranker it asked for
            raise RuntimeError(
                f"RERANKER_WEIGHTS_PATH is set but the checkpoint failed to load from {path!r}"
            ) from exc
    # a real encoder + device token cache enable the fused one-program
    # query path (engine/fused.py); the ingestor fills the cache below
    encoder_tokenizer = getattr(embedder, "tokenizer", None)
    if devices is None:
        from outline_rag_tpu_torch.parallel.mesh import visible_devices

        devices = visible_devices(device)
    if index is None:
        # Row-shard the index over the device mesh when more than one
        # device is asked for (MESH_DATA_AXIS=0 -> all of them, N -> the
        # first N, 1 -> one device). Queries then run each shard's scan and
        # one merge of the [B, K] lists (parallel/query.py).
        sharding = None
        ndev = settings.mesh_data_axis or len(devices)
        if ndev > len(devices):
            raise ValueError(
                f"MESH_DATA_AXIS={ndev} asks for more devices than the {len(devices)} visible"
            )
        if ndev > 1 and settings.shard_capacity % ndev == 0:
            from outline_rag_tpu_torch.parallel.mesh import data_mesh, row_sharding

            sharding = row_sharding(data_mesh(ndev, devices))
            if sharding.mesh.devices[0] != resolve_device(device):
                raise ValueError(
                    f"the mesh starts at {sharding.mesh.devices[0]}, the models live on {device}"
                )
        index = VectorIndex(
            dim=getattr(embedder, "dim", settings.vector_dim),
            capacity=settings.shard_capacity,
            dtype=settings.index_dtype,
            device=None if sharding is not None else device,
            sharding=sharding,
            token_width=(
                settings.token_width if encoder_tokenizer is not None else None
            ),
            colbert_rank=(
                settings.colbert_cache_rank
                if settings.colbert_weight > 0.0
                and encoder_tokenizer is not None
                else 0
            ),
        )
    retrieval = RetrievalService(
        index,
        embedder,
        reranker,
        top_k=settings.top_k,
        rerank_k=settings.rerank_k,
        chunk_text_lookup=lambda cid: (meta.get_chunk(cid) or {}).get("body"),
        lex_weight=settings.lex_weight,
        colbert_weight=settings.colbert_weight,
    )
    # concurrent asks coalesce into one device program per window; device
    # work runs off the event loop (engine/batcher.py)
    from outline_rag_tpu_torch.engine.batcher import QueryBatcher

    batcher = QueryBatcher(
        retrieval.retrieve_batch,
        window_ms=settings.query_batch_window_ms,
        max_batch=settings.query_batch_max,
    )

    class _BatchedRetrieval:
        fused = retrieval.fused

        async def retrieve(self, query: str):
            return await batcher.retrieve(query)
    if provider is None:
        if settings.decoder_weights_path:
            # fully local generation: a Llama/Qwen-family decoder on the card
            path = settings.decoder_weights_path
            try:
                from transformers import AutoTokenizer

                from outline_rag_tpu_torch.models.convert import load_pretrained_decoder
                from outline_rag_tpu_torch.serve.llm import LocalChatProvider

                dec_cfg, dec_params = load_pretrained_decoder(path, device)
                provider = LocalChatProvider(
                    dec_params,
                    dec_cfg,
                    AutoTokenizer.from_pretrained(path),
                    max_new_tokens=settings.decoder_max_new_tokens,
                    batch_slots=settings.decoder_batch_slots,
                    int8_weights=settings.decoder_int8,
                    int4_weights=settings.decoder_int4,
                    spec_k=settings.decoder_spec_k,
                    spec_gram=settings.decoder_spec_gram,
                    kv_pages=settings.decoder_kv_pages,
                    page_size=settings.decoder_page_size,
                    prefix_cache=settings.decoder_prefix_cache,
                    kv_int8=settings.decoder_kv_int8,
                    tp_devices=settings.decoder_tp,
                    devices=devices,
                    device=device,
                )
            except ValueError:
                # an invalid DECODER_* combination (a DECODER_TP the heads or
                # the visible devices cannot take): the configuration's error
                # as it is, not the checkpoint's
                raise
            except Exception as exc:
                # a configured local decoder that cannot load is a deployment
                # error (reference startup asserts exit, app/main.py:99-104):
                # never serve with a different provider
                raise RuntimeError(
                    f"DECODER_WEIGHTS_PATH is set but the checkpoint failed to load from {path!r}"
                ) from exc
        if provider is None and settings.llm_api_base:
            provider = OpenAICompatProvider(
                settings.llm_api_base, settings.llm_api_key, bus=bus
            )
        if provider is None:
            provider = FakeChatProvider()
    outline = (
        OutlineClient(
            settings.outline_api_url or "http://outline.internal",
            settings.outline_api_token,
            settings.outline_collections,
            transport=outline_transport,
        )
        if settings.outline_api_url or outline_transport
        else None
    )
    ingestor = (
        Ingestor(
            outline, meta, index, embedder, bus, settings,
            tokenizer=encoder_tokenizer if index.tokens is not None else None,
        )
        if outline is not None
        else None
    )
    pipeline = ChatPipeline(settings, provider, _BatchedRetrieval(), meta, bus)

    app.state.update(
        settings=settings,
        bus=bus,
        meta=meta,
        index=index,
        embedder=embedder,
        retrieval=retrieval,
        batcher=batcher,
        provider=provider,
        ingestor=ingestor,
        pipeline=pipeline,
    )

    async def _stop_batcher():
        await batcher.stop()

    app.on_shutdown.append(_stop_batcher)

    if start_workers and ingestor is not None:

        async def _start():
            app.spawn(ingestor.task_worker())
            app.spawn(ingestor.webhook_watcher())

        app.on_startup.append(_start)

    snapshot_path = os.path.join(settings.data_dir or ".", "index_snapshot")

    async def _restore_snapshot():
        # instant restart: adopt the on-disk snapshot when present (the
        # updatedAt delta-sync reconciles any staleness on the next
        # refresh — same consistency model as the reference's re-diff)
        import asyncio as _aio

        if index.size == 0 and os.path.exists(snapshot_path + ".npz"):
            try:
                loaded = await _aio.to_thread(
                    VectorIndex.load, snapshot_path, device=index.device,
                    sharding=index._sharding,
                )
                index.adopt(loaded)
                log.info(
                    "restored index snapshot: %d rows from %s",
                    index.size, snapshot_path,
                )
            except Exception:
                log.exception(
                    "snapshot restore failed (continuing to rebuild)"
                )

    app.on_startup.append(_restore_snapshot)

    if ingestor is not None:

        async def _rebuild():
            # restore the derived device index from the document store
            # after a restart (embedding cache -> cheap)
            import asyncio as _aio

            if index.size == 0 and meta.doc_count() > 0:
                n = await _aio.to_thread(ingestor.rebuild_from_store)
                log.info("rebuilt index from store: %d documents", n)

        app.on_startup.append(_rebuild)

    if settings.index_autosave_s > 0:
        _last_saved_gen = [-1]

        def _save_if_changed():
            gen = index._shard.generation
            if gen != _last_saved_gen[0] and index.size > 0:
                index.save(snapshot_path)
                _last_saved_gen[0] = gen
                log.info(
                    "index snapshot saved (gen %d, %d rows)", gen, index.size
                )

        async def _autosave_loop():
            import asyncio as _aio

            async def loop():
                while True:
                    await _aio.sleep(settings.index_autosave_s)
                    try:
                        await _aio.to_thread(_save_if_changed)
                    except _aio.CancelledError:
                        raise
                    except Exception:
                        log.exception("index autosave failed (non-fatal)")

            app.spawn(loop())

        app.on_startup.append(_autosave_loop)

        async def _save_on_shutdown():
            import asyncio as _aio

            try:
                await _aio.to_thread(_save_if_changed)
            except Exception:
                log.exception("shutdown snapshot save failed")

        app.on_shutdown.append(_save_on_shutdown)

    async def _warmup():
        # before the first user request: build the CUDA kernel library (at
        # its first use; tens of seconds on a machine that has not built
        # this source yet) and launch the first scans, with a lone query
        # and with the largest batch the micro-batcher can emit (cuBLAS
        # handles and the allocator's blocks for that width).
        import asyncio as _aio

        async def go():
            try:
                await _aio.to_thread(retrieval.retrieve_batch, ["warmup"])
                top = 1
                while top < settings.query_batch_max:
                    top *= 2
                if top > 1:
                    await _aio.to_thread(
                        retrieval.retrieve_batch,
                        [f"warmup {i}" for i in range(top)],
                    )
                log.info("query path warmed (batches of 1 and %d)", top)
            except Exception:
                log.exception("warmup failed (non-fatal)")

        app.spawn(go())

    app.on_startup.append(_warmup)

    register_auth_routes(app, settings, bus, meta, prefix, oidc_transport)
    static_dir = os.path.join(os.path.dirname(__file__), "static")
    app.mount_static(prefix + "/static", static_dir)

    # -- health ---------------------------------------------------------

    @app.get("/healthz")
    async def healthz(req: Request) -> Response:
        return Response.json({"status": "ok", "index_size": index.size})

    @app.get(prefix + "/api/metrics")
    async def get_metrics(req: Request) -> Response:
        from outline_rag_tpu_torch.utils.profiling import metrics as m

        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        body = {
            "stages": m.snapshot(),
            "index": {
                "size": index.size,
                "capacity": index._shard.capacity,
                "generation": index.generation,
                "dtype": index.dtype,
                "fused": retrieval.fused,
            },
        }
        if hasattr(provider, "stats"):
            body["decoder"] = provider.stats()
        return Response.json(body)

    # -- views ----------------------------------------------------------

    def _no_cache(resp: Response) -> Response:
        resp.headers["cache-control"] = "no-store, no-cache, must-revalidate"
        return resp

    @app.get(prefix + "/")
    async def home(req: Request) -> Response:
        if current_user(req) is None:
            return Response.redirect(prefix + "/login")
        return _no_cache(
            Response(_index_html(settings), content_type="text/html; charset=utf-8")
        )

    @app.get(prefix + "/{guid}")
    async def deep_link(req: Request) -> Response:
        guid = req.path_params["guid"]
        user = current_user(req)
        if user is None:
            return Response.redirect(prefix + "/login")
        if not UUID_RE.match(guid):
            resp = Response.redirect(prefix + "/")
            resp.set_cookie("chat_notice", "invalid-conversation", http_only=False)
            return resp
        conv = meta.get_conversation(guid)
        if conv is None or conv["user_id"] != user["id"]:
            resp = Response.redirect(prefix + "/")
            resp.set_cookie("chat_notice", "not-found", http_only=False)
            return resp
        return _no_cache(
            Response(_index_html(settings), content_type="text/html; charset=utf-8")
        )

    # -- identity / models ----------------------------------------------

    @app.get(prefix + "/api/me")
    async def me(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        models = [
            {
                "id": m.id,
                "label": m.label,
                "temperature": m.temperature,
                "top_p": m.top_p,
                "supports_thinking": m.supports_thinking,
                "icon": m.icon,
            }
            for m in settings.visible_models(user["id"])
        ]
        return Response.json({"user": user, "models": models})

    # -- conversations ---------------------------------------------------

    @app.get(prefix + "/api/conversations")
    async def list_convs(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        try:
            # clamp: SQLite treats LIMIT -1 as unbounded — a negative
            # limit would bypass the 100-row page cap
            limit = max(0, min(int(req.query.get("limit", 100)), 100))
            offset = max(0, int(req.query.get("offset", 0)))
        except ValueError:
            return Response.json({"error": "invalid limit/offset"}, 400)
        return Response.json(
            {"conversations": meta.list_conversations(user["id"], limit, offset)}
        )

    @app.post(prefix + "/api/conversations")
    async def create_conv(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        body = req.json() or {}
        title = (body.get("title") or "New conversation").strip()[:200]
        # upsert user first (reference api.py:240-255)
        meta.upsert_user(user["id"], user.get("name", ""), user.get("email", ""))
        conv = meta.create_conversation(new_id(), user["id"], title)
        return Response.json(conv, 201)

    @app.put(prefix + "/api/conversations/{conv_id}")
    async def rename_conv(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        body = req.json() or {}
        title = (body.get("title") or "").strip()[:200]
        if not title:
            return Response.json({"error": "title required"}, 400)
        ok = meta.rename_conversation(req.path_params["conv_id"], user["id"], title)
        if not ok:
            return Response.json({"error": "forbidden"}, 403)
        return Response.json({"ok": True})

    @app.delete(prefix + "/api/conversations/{conv_id}")
    async def delete_conv(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        conv_id = req.path_params["conv_id"]
        ok = meta.delete_conversation(conv_id, user["id"])
        if not ok:
            return Response.json({"error": "forbidden"}, 403)
        await bus.delete(f"messages:{conv_id}")  # cache invalidation
        return Response.json({"ok": True})

    # reference-shaped aliases (reference api.py:266,288 use POST verbs)
    @app.post(prefix + "/api/conversations/{conv_id}/rename")
    async def rename_conv_alias(req: Request) -> Response:
        return await rename_conv(req)

    @app.post(prefix + "/api/conversations/{conv_id}/delete")
    async def delete_conv_alias(req: Request) -> Response:
        return await delete_conv(req)

    # -- messages (cache read-through) -----------------------------------

    @app.get(prefix + "/api/messages")
    async def get_messages_alias(req: Request) -> Response:
        # reference-shaped: GET /api/messages?conversation_id=...
        # (reference api.py:308)
        conv_id = req.query.get("conversation_id", "")
        req.path_params["conv_id"] = conv_id
        return await get_messages(req)

    @app.get(prefix + "/api/conversations/{conv_id}/messages")
    async def get_messages(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        conv_id = req.path_params["conv_id"]
        # ownership check BEFORE cache read (reference api.py:317-323)
        conv = meta.get_conversation(conv_id)
        if conv is None or conv["user_id"] != user["id"]:
            return Response.json({"error": "forbidden"}, 403)
        cached = await bus.get(f"messages:{conv_id}")
        if cached is not None:
            return Response.json({"messages": cached, "cached": True})
        messages = meta.list_messages(conv_id)
        await bus.set(f"messages:{conv_id}", messages, ex=600)
        return Response.json({"messages": messages, "cached": False})

    # -- ask (the RAG serve path) ----------------------------------------

    @app.post(prefix + "/api/ask")
    async def ask(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        body = req.json() or {}
        question = (body.get("question") or "").strip()
        conv_id = body.get("conversation_id") or ""
        if not question:
            return Response.json({"error": "question required"}, 400)
        conv = meta.get_conversation(conv_id)
        if conv is None or conv["user_id"] != user["id"]:
            return Response.json({"error": "forbidden"}, 403)
        model_id = body.get("model") or settings.base_chat_model
        model_spec = settings.model_by_id(model_id)
        if model_spec is None or (
            model_spec.beta and user["id"] not in settings.beta_user_ids
        ):
            return Response.json({"error": "unknown model"}, 400)
        from outline_rag_tpu_torch.utils.logging import redact_chat_input

        log.info(
            "ask conv=%s model=%s question=%s",
            conv_id,
            model_id,
            redact_chat_input(
                question, settings.safe_log_chat_input, settings.max_log_input_chars
            ),
        )

        edit_id = body.get("edit_message_id")
        if edit_id is not None:
            try:
                edit_id = int(edit_id)
            except (TypeError, ValueError):
                return Response.json({"error": "invalid edit_message_id"}, 400)
            # edit-resume: drop the edited user turn and everything after
            # (reference api.py:613-644)
            meta.delete_messages_after(conv_id, edit_id - 1)
        history = meta.list_messages(conv_id)
        meta.add_message(conv_id, "user", question)
        await bus.delete(f"messages:{conv_id}")

        # one request id for the turn's spans: its retrieval here, its
        # generation when the response's first frame starts the stream
        with request() as rid:
            gen = await pipeline.run(
                user,
                conv_id,
                question,
                model_spec,
                history,
                temperature=body.get("temperature"),
                top_p=body.get("top_p"),
            )
        return Response.streaming(_InRequest(rid, gen))

    # -- upload -----------------------------------------------------------

    @app.post(prefix + "/api/upload")
    async def upload(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        parts = req.multipart()
        files = [p for p in parts if p.get("filename")]
        if not files:
            return Response.json({"error": "no file"}, 400)
        f = files[0]
        name = re.sub(r"[^A-Za-z0-9._-]", "_", f["filename"] or "upload")
        ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
        if ext not in settings.upload_allowed_exts:
            return Response.json({"error": f"extension .{ext} not allowed"}, 400)
        if len(f["data"]) > settings.upload_max_bytes:
            return Response.json({"error": "file too large"}, 413)
        att_id = new_id()
        content = f["data"].decode("utf-8", errors="replace")
        meta.add_attachment(att_id, user["id"], name, content)
        return Response.json({"id": att_id, "filename": name}, 201)

    # -- refresh trigger / status -----------------------------------------

    @app.post(prefix + "/update/all")
    async def update_all(req: Request) -> Response:
        user = current_user(req)
        if user is None:
            return Response.json({"error": "unauthorized"}, 401)
        if ingestor is None:
            return Response.json({"error": "outline not configured"}, 400)
        if not await bus.set_nx(REFRESH_LOCK, 1, ex=3600):
            return Response.json({"error": "refresh already running"}, 429)
        await bus.push(TASK_QUEUE, {"task": "refresh_all"})
        return Response.json({"status": "queued"}, 202)

    @app.get(prefix + "/api/refresh/status")
    async def get_refresh_status(req: Request) -> Response:
        return Response.json(await refresh_status(bus))

    # -- webhook -----------------------------------------------------------

    @app.post(prefix + "/update/webhook")
    async def webhook(req: Request) -> Response:
        if settings.outline_webhook_sign:
            sig = req.headers.get("x-outline-signature") or req.headers.get(
                "outline-signature"
            )
            if not verify_webhook_signature(
                settings.outline_webhook_secret, req.body, sig
            ):
                return Response.json({"error": "bad signature"}, 401)
        # each event pushes the debounce timer back
        # (reference api.py:1025-1026)
        await bus.set(
            WEBHOOK_TIMER, time.time() + settings.webhook_debounce_s, ex=3600
        )
        return Response.json({"status": "accepted"}, 202)

    return app
