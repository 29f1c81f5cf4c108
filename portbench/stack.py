"""The system under test, built from a configuration file and the seed.

Everything here is the port (``outline_rag_tpu_torch``) as a deployment runs
it: the weights drawn by ``portbench/weights.py`` go in through the port's
own loaders for the published layout, the index is filled through
``VectorIndex.add_chunks`` in blocks, queries go through ``QueryBatcher`` and
``RetrievalService``, chats through ``LocalChatProvider.stream``.

The benchmark's spans are recorded here, around calls into the port's
layers: always the host clock around each retrieval batch, and in a traced
run also the reranker's forward (CUDA events from module hooks) and the
decode batcher's chunks (host clock around a chunk that ends synchronised).
"""

from __future__ import annotations

import asyncio
import copy
import math
import threading
import time
import types

import torch

from portbench import weights
from portbench.words import WordTokenizer, draw_words

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Recorder:
    """Spans ``name -> [(t0, t1, fields)]`` on the host's clock
    (``time.perf_counter``), appended from any thread."""

    def __init__(self):
        self.spans: dict[str, list] = {}

    def add(self, name: str, t0: float, t1: float, **fields) -> None:
        self.spans.setdefault(name, []).append((t0, t1, fields))

    def within(self, name: str, w0: float, w1: float) -> list:
        """Spans of ``name`` that started in ``[w0, w1)``."""
        return [s for s in self.spans.get(name, []) if w0 <= s[0] < w1]


class Retrieval:
    """The retrieval stack: encoder, int8r index with its token cache,
    cross-encoder, the fused service."""

    def __init__(self, cfg: dict, seed: int, device, rec: Recorder, trace: bool):
        from outline_rag_tpu_torch.engine import (
            CrossEncoderReranker,
            EncoderEmbedder,
            RetrievalService,
        )
        from outline_rag_tpu_torch.index import VectorIndex
        from outline_rag_tpu_torch.models.convert import (
            _copy_encoder_state,
            _copy_linear,
            config_from_hf,
        )
        from outline_rag_tpu_torch.models.encoder import Encoder
        from outline_rag_tpu_torch.models.reranker import Reranker
        from outline_rag_tpu_torch.models.tokenizer import HashTokenizer

        self.cfg, self.seed, self.device, self.rec = cfg, seed, device, rec
        enc_cfg, rr_cfg = cfg["encoder"], cfg["reranker"]
        dtype = DTYPES[cfg["serve_dtype"]]
        ecfg = config_from_hf(types.SimpleNamespace(**enc_cfg), dtype)
        encoder = Encoder(ecfg, device)
        sd = weights.draw(weights.xlmr_layout(enc_cfg, False), device, dtype, seed, "encoder")
        _copy_encoder_state(encoder, sd)
        away = weights.common_direction(sd, enc_cfg, seed, device, cfg["retrieval"]["query_width"])
        reranker = Reranker(config_from_hf(types.SimpleNamespace(**rr_cfg), dtype), device)
        sd = weights.draw(weights.xlmr_layout(rr_cfg, True), device, dtype, seed, "reranker")
        _copy_encoder_state(reranker.encoder, sd)
        with torch.no_grad():
            _copy_linear(reranker.dense, sd["classifier.dense.weight"], sd["classifier.dense.bias"])
            _copy_linear(reranker.out, sd["classifier.out_proj.weight"],
                         sd["classifier.out_proj.bias"])
        del sd
        self.tokenizer = HashTokenizer(vocab_size=enc_cfg["vocab_size"])
        self.embedder = EncoderEmbedder(encoder.eval(), self.tokenizer)
        self.cross = CrossEncoderReranker(reranker.eval(), self.tokenizer)

        ix = cfg["index"]
        self.index = VectorIndex(
            dim=ix["dim"], capacity=ix["rows"], dtype=ix["dtype"], device=device,
            token_width=ix["token_width"], rescore_m=ix["rescore_m"],
        )
        for b in range(math.ceil(ix["live_rows"] / ix["block"])):
            first = b * ix["block"]
            n = min(ix["block"], ix["live_rows"] - first)
            vecs, ids, mask = weights.block_rows(device, seed, b, n, ix["dim"], ix["token_width"],
                                                 enc_cfg["vocab_size"], away)
            self.index.add_chunks([f"c{first + i}" for i in range(n)], vecs, f"s{b}",
                                  token_ids=ids, token_mask=mask)
        r = cfg["retrieval"]
        self.service = RetrievalService(self.index, self.embedder, self.cross,
                                        top_k=r["top_k"], rerank_k=r["rerank_k"])
        if not self.service.fused:
            raise RuntimeError("the retrieval service did not take the fused path")
        self.rerank_events: list = []
        if trace and torch.device(device).type == "cuda":
            self._hook_reranker()

    def retrieve_batch(self, queries: list[str]):
        """``RetrievalService.retrieve_batch`` under the benchmark's span."""
        t0 = time.perf_counter()
        out = self.service.retrieve_batch(queries)
        self.rec.add("retrieve_batch", t0, time.perf_counter(), n=len(queries))
        return out

    async def warm(self, rng) -> None:
        """Every batch size the query batcher can form, once, largest
        first, at the traffic's question lengths."""
        for b in range(self.cfg["retrieval"]["batch_max"], 0, -1):
            qs = [draw_words(rng, int(rng.integers(6, 31)), 0, 250_000) for _ in range(b)]
            await asyncio.to_thread(self.service.retrieve_batch, qs)

    def batcher(self):
        """A ``QueryBatcher`` with the configuration's window, size and
        batches in flight (start it inside the event loop)."""
        from outline_rag_tpu_torch.engine import QueryBatcher

        r = self.cfg["retrieval"]
        return QueryBatcher(self.retrieve_batch, window_ms=r["batch_window_ms"],
                            max_batch=r["batch_max"], max_in_flight=r["batch_in_flight"])

    def _hook_reranker(self) -> None:
        model = self.cross.model
        starts = {}  # by thread: two batches may be in flight

        def pre(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts[threading.get_ident()] = ev

        def post(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.rerank_events.append((time.perf_counter(), starts[threading.get_ident()], ev))

        model.register_forward_pre_hook(pre)
        model.register_forward_hook(post)

    def close(self) -> None:
        for name in ("service", "index", "embedder", "cross"):
            setattr(self, name, None)


class Decoder:
    """The local chat decoder: ``LocalChatProvider`` with its continuous
    batcher over a paged pool."""

    def __init__(self, cfg: dict, arch, seed: int, device, rec: Recorder, trace: bool):
        from outline_rag_tpu_torch.serve.llm import LocalChatProvider

        self.cfg, self.device, self.rec = cfg, device, rec
        s = cfg["serving"]
        dtype = DTYPES[cfg["serve_dtype"]]
        params, self.model_cfg = arch.build(
            cfg, weights.draw(arch.layout(cfg), device, dtype, seed, "decoder"), device, dtype)
        self.tokenizer = CountingTokenizer(cfg["vocab_size"], s["eos_token_id"])
        self.provider = LocalChatProvider(
            params, self.model_cfg, self.tokenizer, eos_id=s["eos_token_id"],
            chunk_tokens=s["chunk_tokens"], max_new_tokens=s["max_new_tokens"],
            batch_slots=s["batch_slots"], kv_pages=s["kv_pages"], page_size=s["page_size"],
            prefix_cache=s["prefix_cache"], kv_int8=s["kv_int8"], device=device,
        )
        del params
        self.batcher = self.provider._batcher
        self.tracer = None  # the traced run, whose profiler the worker starts and stops
        if trace:
            self._time_chunks()

    def answering(self, max_new: int):
        """The provider as it serves a chat that ends after ``max_new``
        tokens, as an end-of-sequence token would end it: a shallow copy
        sharing the batcher, with its own ``max_new_tokens``."""
        view = copy.copy(self.provider)
        view.max_new_tokens = max_new
        return view

    def _time_chunks(self) -> None:
        b, rec, dev = self.batcher, self.rec, torch.device(self.device)
        step, prefill = b._step_chunk, b._prefill_paged

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def poll():
            if self.tracer is not None:
                self.tracer.poll()

        def timed_step(*state):
            poll()
            lengths = [int(b.pos[i]) for i, r in enumerate(b.active) if r is not None]
            t0 = time.perf_counter()
            out = step(*state)
            sync()
            rec.add("decode_chunk", t0, time.perf_counter(), lengths=lengths,
                    steps=b.chunk_tokens)
            return out

        def timed_prefill(row_table, toks, start):
            poll()
            t0 = time.perf_counter()
            out = prefill(row_table, toks, start)
            sync()
            rec.add("prefill_chunk", t0, time.perf_counter(), start=int(start),
                    tokens=int(toks.shape[1]))
            return out

        b._step_chunk, b._prefill_paged = timed_step, timed_prefill

    def close(self) -> None:
        self.provider.close()
        self.provider = self.batcher = None


class CountingTokenizer(WordTokenizer):
    """The decoder's tokenizer, counting the prompt tokens it encodes (the
    provider encodes prompts only) with the time of each call."""

    def __init__(self, vocab_size: int, eos_token_id: int):
        super().__init__(vocab_size, eos_token_id)
        self.encoded: list[tuple[float, int]] = []

    def encode(self, text: str) -> list[int]:
        ids = super().encode(text)
        self.encoded.append((time.perf_counter(), len(ids)))
        return ids


class Stack:
    """What a cell runs: the parts its traffic needs."""

    def __init__(self, config: dict, needs, seed: int, device, trace: bool, arch):
        """``arch``: the decoder's architecture module (``portbench/arch/``),
        None without a decoder."""
        self.rec = Recorder()
        self.retrieval = self.decoder = None
        if "retrieval" in needs:
            self.retrieval = Retrieval(config["retrieval_stack"], seed, device, self.rec, trace)
        if "decoder" in needs:
            self.decoder = Decoder(config, arch, seed, device, self.rec, trace)

    def close(self) -> None:
        for part in (self.retrieval, self.decoder):
            if part is not None:
                part.close()
