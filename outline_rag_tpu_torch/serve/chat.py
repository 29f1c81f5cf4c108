"""The ask pipeline: classify -> rewrite -> retrieve -> prompt -> stream.

Re-implements the reference's ``/chat/api/ask`` orchestration (reference
``app/blueprints/api.py:363-925``; call stack in SURVEY.md section 3.1)
without LangChain: the per-request LCEL graph becomes three plain async
stages with the same routing, fallback and persistence semantics:

- JSON-mode classifier routes to Query/Creative/Roleplay/General; any
  failure falls back to General (reference ``api.py:709-724``);
- retrieval personas rewrite the question (temp-0), call the TPU retrieval
  engine, dedupe parent docs order-preserving, and build the numbered
  context + ``sources_map`` (reference ``api.py:58-109,112-149``);
- the answer streams as OpenAI-delta SSE frames with ``: ping`` keepalives
  (reference ``api.py:734-828``), thinking-token passthrough (reference
  ``api.py:780-798``), and the assistant message is persisted in
  ``finally`` with the hidden ``[SourcesMap]`` line and thinking markers
  (reference ``api.py:847-905``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import AsyncIterator

log = logging.getLogger(__name__)

THINKING_OPEN = "\n<!--thinking-->\n"
THINKING_CLOSE = "\n<!--/thinking-->\n"
SOURCES_MARKER = "[SourcesMap]:"


def strip_assistant_markup(content: str) -> str:
    """Remove the hidden SourcesMap line and thinking block before feeding
    stored assistant turns back into prompts."""
    out = content
    if THINKING_OPEN in out and THINKING_CLOSE in out:
        pre, rest = out.split(THINKING_OPEN, 1)
        _, post = rest.split(THINKING_CLOSE, 1)
        out = pre + post
    lines = [
        line for line in out.splitlines() if not line.startswith(SOURCES_MARKER)
    ]
    return "\n".join(lines).strip()


def format_context(docs: list[dict]) -> tuple[str, dict[str, dict]]:
    """Numbered context excerpts + sources map (reference api.py:58-109).

    ``docs``: [{"source_id", "title", "url", "text"}] in ranked order.
    Returns (context_string, {str(n): {"title", "url"}}).
    """
    parts = []
    sources: dict[str, dict] = {}
    for n, d in enumerate(docs, start=1):
        parts.append(f"[source {n}] {d['title']}\n{d['text']}")
        sources[str(n)] = {"title": d["title"], "url": d["url"]}
    return "\n\n---\n\n".join(parts), sources


class ChatPipeline:
    def __init__(self, settings, provider, retrieval, meta, bus):
        self.s = settings
        self.provider = provider
        self.retrieval = retrieval  # RetrievalService (or batcher facade)
        self.meta = meta
        self.bus = bus

    # -- stages ---------------------------------------------------------

    async def classify(self, question: str, history_text: str) -> str:
        from outline_rag_tpu_torch.utils.profiling import metrics

        try:
            with metrics.timeit("llm.classify"):
                raw = await self._classify_call(question, history_text)
            category = json.loads(raw).get("category", "General")
            if category not in ("Query", "Creative", "Roleplay", "General"):
                return "General"
            return category
        except Exception:
            log.warning("classifier failed; routing to General", exc_info=True)
            return "General"

    async def _classify_call(self, question: str, history_text: str) -> str:
        return await self.provider.complete(
            self.s.base_chat_model,
            [
                {
                    "role": "user",
                    "content": self.s.classifier_prompt.format(
                        history=history_text, question=question
                    ),
                }
            ],
            temperature=0.0,
            json_mode=True,
        )

    async def rewrite(self, question: str, history_text: str) -> str:
        from outline_rag_tpu_torch.utils.profiling import metrics

        if not history_text.strip():
            return question
        try:
            with metrics.timeit("llm.rewrite"):
                out = await self.provider.complete(
                    self.s.base_chat_model,
                    [
                        {
                            "role": "user",
                            "content": self.s.rewrite_prompt.format(
                                history=history_text, question=question
                            ),
                        }
                    ],
                    temperature=0.0,
                )
            return out.strip() or question
        except Exception:
            log.warning("rewrite failed; using raw question", exc_info=True)
            return question

    async def retrieve_docs(self, query: str) -> list[dict]:
        """Retrieve chunks, dedupe parents order-preserving, return parent
        docs (reference api.py:112-149: chunk hits -> unique parent ids ->
        parent store fetch)."""
        try:
            chunks = await self._retrieve(query)
        except Exception:
            log.exception("retrieval failed; proceeding without context")
            return []
        seen: list[str] = []
        for c in chunks:
            chunk_row = self.meta.get_chunk(c.chunk_id)
            if not chunk_row:
                continue
            sid = chunk_row["source_id"]
            if sid not in seen:
                seen.append(sid)
        docs = []
        for sid in seen:
            doc = self.meta.get_document(sid)
            if doc:
                docs.append(
                    {
                        "source_id": sid,
                        "title": doc["title"],
                        "url": doc["url"],
                        "text": doc["text"][: self.s.chunk_size * 4],
                    }
                )
        return docs

    async def _retrieve(self, query: str):
        res = self.retrieval.retrieve(query)
        if asyncio.iscoroutine(res):
            res = await res
        return res

    # -- the SSE generator ----------------------------------------------

    async def run(
        self,
        user: dict,
        conversation_id: str,
        question: str,
        model_spec,
        history: list[dict],
        temperature: float | None = None,
        top_p: float | None = None,
    ) -> AsyncIterator[bytes]:
        """Yields SSE byte frames. Persists the assistant turn on exit."""
        # NB: history[-0:] is the FULL list — a cap of 0 means no history
        hist = (
            history[-self.s.max_history_messages:]
            if self.s.max_history_messages > 0 else []
        )
        history_text = "\n".join(
            f"{m['role']}: {strip_assistant_markup(m['content'] or '')}"
            for m in hist
        )
        category = await self.classify(question, history_text)

        sources: dict[str, dict] = {}
        context = ""
        if category in ("Query", "Creative", "Roleplay"):
            search_q = await self.rewrite(question, history_text)
            docs = await self.retrieve_docs(search_q)
            if docs:
                context, sources = format_context(docs)
        persona = category if context else "General"
        system = self.s.persona_prompts[persona].format(
            worldview=self.s.worldview, context=context
        )
        messages = [{"role": "system", "content": system}]
        for m in hist:
            messages.append(
                {
                    "role": m["role"],
                    "content": strip_assistant_markup(m["content"] or ""),
                }
            )
        messages.append(
            {"role": "user", "content": self.s.answer_template.format(question=question)}
        )

        answer_parts: list[str] = []
        thinking_parts: list[str] = []

        def frame(content=None, thinking=None, model=model_spec.id) -> bytes:
            delta = {}
            if content is not None:
                delta["content"] = content
            if thinking is not None:
                delta["thinking"] = thinking
            return (
                "data: "
                + json.dumps(
                    {"choices": [{"delta": delta}], "model": model},
                    ensure_ascii=False,
                )
                + "\n\n"
            ).encode()

        async def generator() -> AsyncIterator[bytes]:
            stream = self.provider.stream(
                model_spec.provider_model,
                messages,
                temperature=temperature
                if temperature is not None
                else model_spec.temperature,
                top_p=top_p if top_p is not None else model_spec.top_p,
            )
            agen = stream.__aiter__()
            try:
                # multiplex token stream with keepalive pings
                # (reference api.py:734-745: `: ping` every 20 s)
                next_task = asyncio.ensure_future(agen.__anext__())
                while True:
                    done, _ = await asyncio.wait(
                        {next_task}, timeout=self.s.sse_ping_interval_s
                    )
                    if not done:
                        yield b": ping\n\n"
                        continue
                    try:
                        delta = next_task.result()
                    except StopAsyncIteration:
                        break
                    except Exception:
                        log.exception("provider stream error")
                        yield frame(content="\n[generation interrupted]")
                        break
                    if delta.get("thinking"):
                        thinking_parts.append(delta["thinking"])
                        yield frame(thinking=delta["thinking"])
                    if delta.get("content"):
                        answer_parts.append(delta["content"])
                        yield frame(content=delta["content"])
                    next_task = asyncio.ensure_future(agen.__anext__())
                if sources:
                    tail = "\n\n" + SOURCES_MARKER + " " + json.dumps(
                        sources, ensure_ascii=False
                    )
                    answer_parts.append(tail)
                    yield frame(content=tail)
                yield b"data: [DONE]\n\n"
            finally:
                # cancel AND AWAIT the in-flight __anext__ before
                # aclose(): while a fetch is pending the generator is
                # marked running and aclose() raises "already running" —
                # the immediate close (whose finally frees an abandoned
                # decode slot) would silently never happen on mid-token
                # disconnects
                try:
                    next_task.cancel()
                    try:
                        await next_task
                    except (asyncio.CancelledError, StopAsyncIteration):
                        pass
                    except Exception:
                        pass  # provider error already surfaced upstream
                except Exception:
                    pass
                # close the provider stream NOW (cancelling a done
                # __anext__ task is a no-op): its finally is what frees
                # an abandoned decode slot — don't leave it to GC
                try:
                    await agen.aclose()
                except Exception:
                    log.exception("provider stream close failed")
                await self._persist(
                    user, conversation_id, answer_parts, thinking_parts, model_spec
                )

        return generator()

    async def _persist(
        self, user, conversation_id, answer_parts, thinking_parts, model_spec
    ) -> None:
        """Persist the assistant turn even on abort; re-verify ownership
        first (reference api.py:850-905)."""
        answer = "".join(answer_parts).strip()
        if not answer:
            return
        conv = self.meta.get_conversation(conversation_id)
        if conv is None or conv["user_id"] != user["id"]:
            log.warning("ownership changed mid-stream; dropping persistence")
            return
        content = answer
        if thinking_parts:
            content = (
                THINKING_OPEN + "".join(thinking_parts).strip() + THINKING_CLOSE + content
            )
        self.meta.add_message(conversation_id, "assistant", content, model_spec.id)
        self.meta.touch_conversation(conversation_id)
        await self.bus.delete(f"messages:{conversation_id}")
