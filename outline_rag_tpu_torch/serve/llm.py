"""Chat providers: the seam between the ask pipeline and a language model.

``OpenAICompatProvider`` (the remote OpenAI-compatible API, with its
answer cache) and ``FakeChatProvider`` (the deterministic offline seam)
are copies of the JAX package's, with ``httpx`` imported where the remote
client is built, so that this module imports on a machine without it.

``LocalChatProvider`` is the port of the JAX package's local provider: a
decoder LM on the card behind the same contract. ``complete`` returns the
answer's text, ``stream`` yields ``{"content", "thinking", "model"}``
deltas. Generation runs in token chunks (``models/decoder.py``), and each
chunk's new text streams out as a delta. With ``batch_slots > 1`` requests
share a :class:`~outline_rag_tpu_torch.serve.decode_batcher.DecodeBatcher`.

``int8_weights`` / ``int4_weights`` quantize the projections at start-up
(``DECODER_INT8_MODE`` / ``DECODER_INT4_MODE`` pick the product), and
``spec_k > 0`` turns on prompt-lookup speculative decoding, in the batcher
or, single-stream, in :meth:`LocalChatProvider._generate_spec`.

``tp_devices > 1`` serves the decoder Megatron-style over the first
``tp_devices`` of ``devices`` (``parallel/tp.py``), with the JAX package's
refusals: heads or KV heads not divisible by ``tp_devices``, int8 weights
in any mode but w8a8, and prequantized trees raise ``ValueError``.

A DeepSeek-V2 decoder (latent attention and routed experts, ``cfg.mla`` /
``cfg.moe``) serves through the batcher's paged latent pool, in the model
dtype: without ``batch_slots > 1`` and ``kv_pages > 0``, or with
``kv_int8``, quantized weights, ``spec_k`` or ``tp_devices > 1``, it raises
``ValueError`` naming the option.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import queue
import threading
from typing import AsyncIterator

import torch

from outline_rag_tpu_torch.device import resolve_device
from outline_rag_tpu_torch.models.decoder import (
    cast_decoder_params,
    check_latent_options,
    decoder_forward,
    fold_in,
    fuse_decoder_params,
    generate_chunk,
    generate_chunk_spec,
    init_cache,
    key_at,
    make_key,
    quantize_decoder_params,
    quantize_decoder_params_int4,
    sample_token,
)
from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher
from outline_rag_tpu_torch.utils.profiling import current_request, new_request_id


log = logging.getLogger(__name__)


class OpenAICompatProvider:
    def __init__(
        self,
        api_base: str,
        api_key: str,
        bus=None,
        cache_ttl: float = 3600.0,
        transport: httpx.AsyncBaseTransport | None = None,
        timeout: float = 120.0,
    ):
        import httpx  # here, not at import: LocalChatProvider needs no httpx

        self.api_base = api_base.rstrip("/")
        self.bus = bus
        self.cache_ttl = cache_ttl
        self._client = httpx.AsyncClient(
            transport=transport,
            timeout=timeout,
            headers={"Authorization": f"Bearer {api_key}"},
        )

    async def aclose(self):
        await self._client.aclose()

    def _cache_key(self, payload: dict) -> str:
        digest = hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()
        ).hexdigest()
        return f"llm_cache:{digest}"

    async def complete(
        self,
        model: str,
        messages: list[dict],
        temperature: float = 0.0,
        top_p: float | None = None,
        json_mode: bool = False,
        max_tokens: int | None = None,
    ) -> str:
        payload: dict = {
            "model": model,
            "messages": messages,
            "temperature": temperature,
            "stream": False,
        }
        if top_p is not None:
            payload["top_p"] = top_p
        if max_tokens:
            payload["max_tokens"] = max_tokens
        if json_mode:
            payload["response_format"] = {"type": "json_object"}
        key = self._cache_key(payload)
        if self.bus is not None:
            cached = await self.bus.get(key)
            if cached is not None:
                return cached
        resp = await self._client.post(
            f"{self.api_base}/chat/completions", json=payload
        )
        resp.raise_for_status()
        content = resp.json()["choices"][0]["message"]["content"] or ""
        if self.bus is not None:
            await self.bus.set(key, content, ex=self.cache_ttl)
        return content

    async def stream(
        self,
        model: str,
        messages: list[dict],
        temperature: float = 0.7,
        top_p: float = 0.9,
        extra_body: dict | None = None,
    ) -> AsyncIterator[dict]:
        """Yields {"content": str|None, "thinking": str|None, "model": str}
        deltas until the upstream closes."""
        payload = {
            "model": model,
            "messages": messages,
            "temperature": temperature,
            "top_p": top_p,
            "stream": True,
            "stream_options": {"include_usage": False},
        }
        if extra_body:
            payload.update(extra_body)
        async with self._client.stream(
            "POST", f"{self.api_base}/chat/completions", json=payload
        ) as resp:
            resp.raise_for_status()
            async for line in resp.aiter_lines():
                line = line.strip()
                if not line.startswith("data:"):
                    continue
                data = line[5:].strip()
                if data == "[DONE]":
                    return
                try:
                    obj = json.loads(data)
                except json.JSONDecodeError:
                    continue
                choices = obj.get("choices") or []
                if not choices:
                    continue
                delta = choices[0].get("delta") or {}
                yield {
                    "content": delta.get("content"),
                    "thinking": delta.get("reasoning_content")
                    or delta.get("thinking"),
                    "model": obj.get("model", model),
                }


class FakeChatProvider:
    """Deterministic offline provider: the classifier routes by keyword,
    the rewriter echoes, the answer streams a canned summary of its context
    word by word (with a thinking prelude for thinking-capable models)."""

    def __init__(self, thinking: bool = False, answer_words: int = 24,
                 cite: bool = False):
        self.thinking = thinking
        self.answer_words = answer_words
        self.cite = cite  # end the answer with "[source 1]" when context has one
        self.calls: list[dict] = []

    async def complete(
        self, model, messages, temperature=0.0, top_p=None,
        json_mode=False, max_tokens=None,
    ) -> str:
        self.calls.append({"kind": "complete", "model": model, "messages": messages})
        text = messages[-1]["content"] if messages else ""
        if json_mode:
            lower = text.lower()
            if any(w in lower for w in ("story", "poem", "write me")):
                cat = "Creative"
            elif any(w in lower for w in ("act as", "roleplay", "pretend")):
                cat = "Roleplay"
            elif any(w in lower for w in ("hello", "hi!", "thanks", "who are you")):
                cat = "General"
            else:
                cat = "Query"
            return json.dumps({"category": cat})
        # rewriter: echo the last question line
        for line in reversed(text.splitlines()):
            if line.strip():
                return line.strip().removeprefix("Message:").strip()
        return text

    async def stream(
        self, model, messages, temperature=0.7, top_p=0.9, extra_body=None
    ):
        self.calls.append({"kind": "stream", "model": model, "messages": messages})
        if self.thinking:
            for w in ["considering", "the", "context..."]:
                yield {"content": None, "thinking": w + " ", "model": model}
        ctx = ""
        for m in messages:
            if m["role"] == "system":
                ctx = m["content"]
        words = (
            f"Answer based on: {ctx[:160]}" if ctx else "I have no context"
        ).split()
        for w in words[: self.answer_words]:
            yield {"content": w + " ", "thinking": None, "model": model}
        if self.cite and "[source 1]" in ctx:
            yield {"content": "[source 1]", "thinking": None, "model": model}


def _to_device(params, device):
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, list):
            return [move(v) for v in x]
        return x.to(device)

    return move(params)


class LocalChatProvider:
    """A Llama/Qwen-family decoder (``models/decoder.py``) on ``device``
    behind the provider seam, so embed -> retrieve -> rerank -> generate can
    all run on one card."""

    def __init__(
        self,
        params,
        cfg,
        tokenizer,  # needs .encode(str) -> list[int], .decode(list[int]) -> str
        eos_id: int | None = None,
        chunk_tokens: int = 16,
        max_new_tokens: int = 512,
        model_name: str = "local-gpu",
        prompt_buckets: tuple = (64, 128, 256, 512, 1024, 2048),
        batch_slots: int = 0,  # >1 -> continuous batching across requests
        int8_weights: bool = False,  # int8 projections (DECODER_INT8_MODE picks the product)
        int4_weights: bool = False,  # int4 projections (DECODER_INT4_MODE picks the product)
        spec_k: int = 0,  # >0 -> prompt-lookup speculative decoding
        spec_gram: int = 3,
        kv_pages: int = 0,  # >0 -> paged KV pool for the batcher
        page_size: int = 128,
        prefix_cache: bool = True,  # paged mode: share repeated prompt prefixes
        kv_int8: bool = False,  # paged mode: int8 KV pool
        tp_devices: int = 0,  # >1 -> Megatron TP over the first tp_devices of devices
        prequantized: bool = False,  # params already cast, fused and quantized
        device: str | torch.device = "cuda",
        devices=None,  # the devices a TP mesh takes (default: the visible ones of device's kind)
    ):
        if int8_weights and int4_weights:
            raise ValueError(
                "int8_weights and int4_weights are mutually exclusive "
                "(pick one weight quantization)"
            )
        check_latent_options(
            cfg, paged=bool(batch_slots and batch_slots > 1 and kv_pages > 0), kv_int8=kv_int8,
            int8_weights=int8_weights, int4_weights=int4_weights, prequantized=prequantized,
            spec_k=spec_k, tp_devices=tp_devices if tp_devices and int(tp_devices) > 1 else 0,
        )
        self.cfg = cfg
        self.mesh = None
        if tp_devices and int(tp_devices) > 1:
            from outline_rag_tpu_torch.models import decoder as decoder_mod  # noqa: PLC0415
            from outline_rag_tpu_torch.parallel.mesh import visible_devices  # noqa: PLC0415
            from outline_rag_tpu_torch.parallel.tp import check_tp_config, model_mesh  # noqa: PLC0415

            check_tp_config(cfg, int(tp_devices))
            if int8_weights and decoder_mod._INT8_MODE != "w8a8":
                raise ValueError(
                    "DECODER_TP with DECODER_INT8 requires DECODER_INT8_MODE=w8a8 (the w8a16 "
                    "kernel is a single-device route)"
                )
            if prequantized:
                raise ValueError(
                    "prequantized trees are not laid out for DECODER_TP: quantize under TP instead"
                )
            self.mesh = model_mesh(
                int(tp_devices), devices if devices is not None else visible_devices(device)
            )
            device = self.mesh.devices[0]
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        if prequantized:
            if not (int8_weights or int4_weights):
                raise ValueError(
                    "prequantized=True needs int8_weights or int4_weights "
                    "to say which layout the tree carries"
                )
            self.params = params  # casting or re-quantizing would clobber the integer leaves
        else:
            self.params = fuse_decoder_params(cast_decoder_params(params, cfg.dtype))
            if int8_weights:
                self.params = quantize_decoder_params(self.params)
            elif int4_weights:
                self.params = quantize_decoder_params_int4(self.params)
        if self.mesh is not None:
            from outline_rag_tpu_torch.parallel.tp import shard_decoder_params  # noqa: PLC0415

            self.params = shard_decoder_params(self.params, self.mesh, cfg)
        self.tokenizer = tokenizer
        self.eos_id = eos_id if eos_id is not None else getattr(tokenizer, "eos_token_id", 2)
        self.chunk_tokens = chunk_tokens
        self.max_new_tokens = max_new_tokens
        self.model_name = model_name
        kept = tuple(b for b in prompt_buckets if b <= cfg.max_cache)
        if not kept or kept[-1] < cfg.max_cache:  # the ladder reaches max_cache
            kept = kept + (cfg.max_cache,)
        self.prompt_buckets = kept
        # speculative decoding: with batch_slots > 1 the batcher runs its own
        # speculative step (per-row counts); single-stream requests go
        # through _generate_spec
        self.spec_k = int(spec_k)
        self.spec_gram = int(spec_gram)
        self._batcher = None
        if batch_slots and batch_slots > 1:
            self._batcher = DecodeBatcher(
                self.params,
                cfg,
                slots=batch_slots,
                chunk_tokens=chunk_tokens,
                eos_id=self.eos_id,
                prompt_buckets=self.prompt_buckets,
                spec_k=self.spec_k,
                spec_gram=self.spec_gram,
                kv_pages=int(kv_pages),
                page_size=int(page_size),
                prefix_cache=bool(prefix_cache),
                kv_int8=bool(kv_int8),
                mesh=self.mesh,
                device=self.device,
            )

    def _init_cache(self):
        """A fresh one-row KV ring, sharded on KvH under TP."""
        ring = init_cache(self.cfg, 1, self.device)
        if self.mesh is None:
            return ring
        from outline_rag_tpu_torch.parallel.tp import shard_decoder_cache  # noqa: PLC0415

        return shard_decoder_cache(ring, self.mesh)

    def stats(self) -> dict:
        """Decode-path operational stats."""
        out = {"model": self.model_name}
        if self.mesh is not None:
            out["tp"] = self.mesh.size
        if self._batcher is not None:
            out.update(self._batcher.stats())
        else:
            out["mode"] = "single-stream"
        return out

    def close(self) -> None:
        """Stop the batcher's worker, if there is one."""
        if self._batcher is not None:
            self._batcher.close()

    # -- prompt rendering -------------------------------------------------

    def _render(self, messages: list[dict]) -> str:
        tok = self.tokenizer
        if hasattr(tok, "apply_chat_template"):
            try:
                return tok.apply_chat_template(
                    messages, tokenize=False, add_generation_prompt=True
                )
            except Exception:  # noqa: BLE001 — no template in the checkpoint
                pass
        parts = [f"{m['role']}: {m['content']}" for m in messages]
        return "\n".join(parts) + "\nassistant:"

    def _encode_prompt(self, text: str) -> list[int]:
        ids = self.tokenizer.encode(text)
        if hasattr(ids, "ids"):  # raw tokenizers.Encoding
            ids = ids.ids
        limit = self.cfg.max_cache - self.max_new_tokens - 1
        return list(ids)[-max(limit, 8):]

    def _flusher(self, out_ids: list[int]):
        """A function returning the text decoded since its last call, or
        None while the tail is an incomplete UTF-8 sequence."""
        emitted = ""

        def flush():
            nonlocal emitted
            text = self.tokenizer.decode(out_ids) if out_ids else ""
            if text and not text.endswith("�") and len(text) > len(emitted):
                piece = text[len(emitted):]
                emitted = text
                return piece
            return None

        return flush

    # -- blocking generators (run on a thread of their own) ---------------

    def _generate_blocking(self, messages, temperature, top_p, max_new):
        """Single-stream text-piece generator over a fresh KV ring."""
        with torch.inference_mode():
            yield from self._generate_ring(messages, temperature, top_p, max_new)

    def _generate_ring(self, messages, temperature, top_p, max_new):
        dev = self.device
        ids = self._encode_prompt(self._render(messages))
        t = len(ids)
        # never generate past the cache capacity
        max_new = min(max_new, self.cfg.max_cache - t - 1)
        bucket = next((b for b in self.prompt_buckets if b >= t), self.prompt_buckets[-1])
        padded = torch.tensor([ids + [0] * (bucket - t)], dtype=torch.int32, device=dev)
        cache = self._init_cache()
        logits, cache = decoder_forward(
            self.params, padded, cache, torch.zeros((1,), dtype=torch.int32, device=dev), self.cfg
        )
        temp = float(temperature or 0.0)
        tp = float(top_p if top_p is not None else 1.0)
        key = make_key(abs(hash(tuple(ids))) % (2**31), dev)
        if self.spec_k > 0:
            yield from self._generate_spec(ids, t, cache, logits, key, temp, tp, max_new)
            return
        tok = sample_token(logits[:, t - 1, :], key, temp, tp)
        out_ids: list[int] = []
        flush = self._flusher(out_ids)
        if int(tok[0]) == self.eos_id:
            return
        out_ids.append(int(tok[0]))
        piece = flush()
        if piece:
            yield piece

        # One chunk of lookahead: the next chunk is enqueued BEFORE this
        # chunk's tokens are fetched, so the fetch's synchronisation
        # overlaps the next chunk's compute. Only the dispatch order
        # changes; the chain on the device (cache, token, key) is the
        # serial loop's, so streams are identical to it. A stop (eos or
        # budget) discards one in-flight chunk: its tokens are never
        # emitted, and its cache writes lie past the positions anyone reads.
        pos = t
        chunk_no = 0

        def dispatch():
            nonlocal pos, cache, tok, chunk_no
            chunk_no += 1
            toks, cache, tok, _ = generate_chunk(
                self.params, cache, tok,
                torch.full((1,), pos, dtype=torch.int32, device=dev),
                fold_in(key, chunk_no), self.cfg,
                n_steps=self.chunk_tokens, temperature=temp, top_p=tp, eos_id=self.eos_id,
            )
            pos += self.chunk_tokens
            return toks

        # every chunk that does not stop comes back with exactly
        # chunk_tokens tokens, so len(out_ids) + pending * chunk_tokens is
        # what len(out_ids) will be when the in-flight work lands
        pending = 0
        inflight = None
        if len(out_ids) < max_new:
            inflight = dispatch()
            pending = 1
        while inflight is not None:
            nxt = None
            if len(out_ids) + pending * self.chunk_tokens < max_new:
                nxt = dispatch()
                pending += 1
            chunk = inflight[0].tolist()
            pending -= 1
            stop = self.eos_id in chunk
            if stop:
                chunk = chunk[: chunk.index(self.eos_id)]
            room = max_new - len(out_ids)
            if len(chunk) >= room:
                chunk = chunk[:room]
                stop = True
            out_ids.extend(chunk)
            piece = flush()
            if piece:
                yield piece
            inflight = None if stop else nxt

    def _generate_spec(self, ids, t, cache, logits, key, temp, tp, max_new):
        """Single-stream speculative (prompt-lookup) generation. The
        streaming contract is the plain loop's; each dispatch runs
        ``chunk_tokens`` verify steps that return 1 to ``spec_k + 1`` tokens
        each. The token at position q is drawn with ``key_at(key, q)``, so
        the stream is a function of (seed, prompt) alone: chunk boundaries,
        and the one chunk that may be dispatched and then discarded, cannot
        change the text. Greedy streams equal the plain loop's."""
        dev = self.device
        row_buf = torch.zeros((1, self.cfg.max_cache), dtype=torch.int32)
        row_buf[0, :t] = torch.tensor(ids, dtype=torch.int32)  # the bucket's padding stays out
        tok_buf = row_buf.to(dev)
        tok = sample_token(logits[:, t - 1, :], key_at(key, t).reshape(1), temp, tp)
        if int(tok[0]) == self.eos_id:
            return
        out_ids = [int(tok[0])]
        flush = self._flusher(out_ids)
        piece = flush()
        if piece:
            yield piece
        pos = torch.full((1,), t, dtype=torch.int32, device=dev)

        # one chunk of lookahead, as in the plain loop. Each dispatch advances
        # at least chunk_tokens tokens (one a verify step) unless the
        # capacity guard froze the row, so gating on that minimum keeps the
        # lookahead bounded.
        def dispatch():
            nonlocal cache, tok_buf, tok, pos
            chunk_out, cnt, cache, tok_buf, tok, pos = generate_chunk_spec(
                self.params, cache, tok_buf, tok, pos, key, self.cfg,
                n_steps=self.chunk_tokens, draft_k=self.spec_k, gram=self.spec_gram,
                temperature=temp, top_p=tp, eos_id=self.eos_id,
            )
            return torch.cat([cnt[:, None], chunk_out], dim=1)  # one fetch a chunk

        pending = 0
        inflight = None
        if len(out_ids) < max_new:
            inflight = dispatch()
            pending = 1
        while inflight is not None:
            nxt = None
            if len(out_ids) + pending * self.chunk_tokens < max_new:
                nxt = dispatch()
                pending += 1
            n, *chunk = inflight[0].tolist()
            pending -= 1
            if n == 0:  # the cache is full (the capacity guard froze the row)
                break
            chunk = chunk[:n]
            stop = self.eos_id in chunk
            if stop:
                chunk = chunk[: chunk.index(self.eos_id)]
            room = max_new - len(out_ids)
            if len(chunk) >= room:
                chunk = chunk[:room]
                stop = True
            out_ids.extend(chunk)
            piece = flush()
            if piece:
                yield piece
            inflight = None if stop else nxt

    def _batched_blocking(self, messages, temperature, top_p, max_new, rid=None):
        """Text-piece generator over the continuous batcher; ``rid`` is the
        request id of the batcher's spans."""
        ids = self._encode_prompt(self._render(messages))
        out_q = self._batcher.submit(
            ids,
            float(temperature or 0.0),
            float(top_p if top_p is not None else 1.0),
            max_new,
            rid=rid,
        )
        out_ids: list[int] = []
        flush = self._flusher(out_ids)
        finished = False
        try:
            while True:
                try:
                    item = out_q.get(timeout=30.0)
                except queue.Empty:
                    # no progress: the worker died (surface it) or the
                    # queue is congested (wait on)
                    if self._batcher.dead is not None:
                        raise RuntimeError(
                            "decode batcher worker died mid-stream"
                        ) from self._batcher.dead
                    continue
                if item is DONE:
                    finished = True
                    break
                if isinstance(item, Exception):
                    raise item
                out_ids.extend(item)
                piece = flush()
                if piece:
                    yield piece
        finally:
            if not finished:
                # generator closed early (the client went away): reclaim
                # the slot instead of decoding for nobody
                self._batcher.cancel(out_q)

    def _pieces(self, messages, temperature, top_p, max_new, rid=None):
        if self._batcher is not None:
            return self._batched_blocking(messages, temperature, top_p, max_new, rid)
        return self._generate_blocking(messages, temperature, top_p, max_new)

    async def complete(
        self, model, messages, temperature=0.0, top_p=None, json_mode=False, max_tokens=None,
    ) -> str:
        if json_mode:
            # no grammar enforcement on a raw decoder: steer with an
            # explicit instruction instead of silently dropping the flag
            messages = list(messages) + [
                {
                    "role": "user",
                    "content": (
                        "Respond with ONLY a single valid JSON object, "
                        "no prose, no code fences."
                    ),
                }
            ]

        rid = current_request() or new_request_id()

        def run():
            return "".join(
                self._pieces(messages, temperature, top_p, max_tokens or self.max_new_tokens, rid)
            )

        return await asyncio.to_thread(run)

    async def stream(self, model, messages, temperature=0.7, top_p=0.9, extra_body=None):
        """Yields ``{"content": str, "thinking": None, "model": str}`` deltas
        until generation ends. One feeding thread per stream hands pieces to
        the event loop, so any number of streams run at once; closing the
        stream early stops the thread and cancels the batcher's row. The
        caller's request id (else a new one) goes to the batcher with the
        prompt: the feeding thread does not inherit it."""
        rid = current_request() or new_request_id()
        loop = asyncio.get_running_loop()
        pieces: asyncio.Queue = asyncio.Queue()
        end = object()
        stop = threading.Event()

        def put(item):
            try:
                loop.call_soon_threadsafe(pieces.put_nowait, item)
            except RuntimeError:  # the loop closed under an abandoned stream
                pass

        def feed():
            try:
                gen = self._pieces(messages, temperature, top_p, self.max_new_tokens, rid)
                for piece in gen:
                    if stop.is_set():
                        gen.close()  # fires the cancel path of the generator
                        break
                    put(piece)
            except Exception as exc:  # noqa: BLE001 — handed to the consumer
                put(exc)
            finally:
                put(end)

        thread = threading.Thread(target=feed, daemon=True)
        thread.start()
        try:
            while True:
                piece = await pieces.get()
                if piece is end:
                    break
                if isinstance(piece, Exception):
                    raise piece
                yield {"content": piece, "thinking": None, "model": self.model_name}
        finally:
            stop.set()  # closed mid-stream: stop the feeding thread
