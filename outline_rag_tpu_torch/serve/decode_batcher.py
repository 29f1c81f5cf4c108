"""Continuous batching for the local chat decoder.

Port of ``outline_rag_tpu/serve/decode_batcher.py``. One worker thread owns
the device state and serves N concurrent conversations: each slot owns a
row of the batch, and requests join and leave at chunk boundaries. Per-row
state (position, temperature, top_p, done) is data, so admission changes no
shape: the step's tensors keep their shapes and addresses for the life of
the batcher.

Row isolation is structural: attention runs within each batch row's own
cache slots, so a finished or inactive row decoding garbage cannot reach
its neighbours; its position is clamped below capacity.

The worker:
  admit:  prefill the prompt (ring mode: into a fresh 1-row ring at a
          bucketed width, copied into the slot's row),
  step:   run one chunk of decode steps over the whole batch, sampling
          on the device, and fetch the chunk's tokens once,
  emit:   push each active row's new token ids to its request queue.

Paged mode (``kv_pages > 0``) replaces the per-slot rings with a shared
page pool (``ops/paged_attention.py``): admission allocates pages by actual
prompt + generation need, prefills the prompt *through the pages* in
fixed-width chunks interleaved with decode steps, and reclaims pages at
finish. Full prompt pages are content-addressed (cumulative block hashes)
and shared between requests with refcounts. Sharing is exact: per-position
math is independent of chunk boundaries, so a warm admission is
bit-identical to a cold one. Cached pages with no live user stay resident
and are evicted least-recently-used under pool pressure.

The pool is one set of tensors updated in place (there is nothing to
donate); a prefill that fails may leave it half written, so it fails the
whole batcher (``_die``).

Sampler contract: the token landing at absolute position q of a request is
drawn with ``key_at(make_key(row_seed), q)`` — per-request randomness,
reproducible given (seed, prompt), independent of the batch, the chunk
boundary and the slot.

Speculative mode (``spec_k > 0``): each of a chunk's steps is a verify step
of ``models/decoder.py::generate_chunk_spec`` that advances a row by 1 to
``spec_k + 1`` tokens (prompt-lookup drafts); by the sampler contract the
streams are those of ``spec_k = 0``. Rows diverge freely: positions, cursors
and counts are per row.

Tensor parallelism (``mesh=``, ``parallel/tp.py``): the parameters are laid
out over the mesh by ``shard_decoder_params``; the ring or the pool shards
on KvH over the same devices and the page tables replicate (one copy, on
the mesh's first device). The chunk, paged and speculative modes run as
they do on one device.

Spans (``utils/profiling.py``). A request's: ``decode.queue`` from
``submit`` until its admission is staged (held and backpressured time
included; ``prompt_tokens``), ``decode.admit`` from staging to its first
token sampled (``chunks``, ``shared_pages``) and ``decode.prefill`` around
each paged prefill chunk (``start``; ``tokens``, the prompt's, padding left
out; its parent the ``decode.admit``), each with the request's id. The worker's passes are tiled
by ``decode.stage`` (admissions and their prefill chunks), ``decode.idle``
(the wait for work), ``decode.launch`` (the state's upload and the chunk's
launch; ``rows`` live, ``steps``), ``decode.fetch`` (the chunk's tokens to
the host) and ``decode.emit`` (the host state, each row's tokens, finishes
and cancels), so no time of the loop lies outside a span.

An expert model (``cfg.moe``, DeepSeek-V2) adds one ``moe.route`` record a
decode chunk and a paged prefill chunk, with the ends of its
``decode.launch`` or ``decode.prefill``: ``kind`` ("decode" or "prefill"),
``rows`` (live) and ``steps``; ``pairs`` (routed token-expert pairs, padding
and idle rows included, as the expert product computes them),
``experts_hit`` (distinct experts touched) summed over expert layers and
steps, and ``expert_tokens_max`` (the most pairs one expert took in one
layer-step). They are reduced on the device from the per-expert counts the
grouping makes and fetched with the next decode chunk's tokens, so a record
may close after later spans.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import logging
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from outline_rag_tpu_torch.device import resolve_device
from outline_rag_tpu_torch.models.decoder import (
    _sample_one,
    check_latent_options,
    decoder_forward,
    generate_chunk_spec,
    init_cache,
    init_paged_cache,
    key_at,
    make_key,
    sample_token,
)
from outline_rag_tpu_torch.utils.profiling import current_request, metrics, new_request_id

DONE = object()  # sentinel on request queues


@dataclasses.dataclass
class _Request:
    prompt_ids: list[int]
    temperature: float
    top_p: float
    max_new: int
    out: "queue.Queue[Any]"
    seed: int
    token: int = 0  # cancellation handle (see DecodeBatcher.cancel)
    rid: int | None = None  # request id of its spans
    submitted: float = 0.0  # perf_counter at submit()


class DecodeBatcher:
    def __init__(
        self,
        params,
        cfg,
        slots: int = 4,
        chunk_tokens: int = 8,
        eos_id: int = 2,
        prompt_buckets: tuple = (64, 128, 256, 512, 1024, 2048),
        spec_k: int = 0,  # >0 -> prompt-lookup speculative steps
        spec_gram: int = 3,
        kv_pages: int = 0,  # >0 -> paged KV pool of this many pages
        page_size: int = 128,
        prefix_cache: bool = True,  # paged mode: share full prompt pages
        prefill_chunk: int = 256,  # paged-prefill width (tokens)
        kv_int8: bool = False,  # paged mode: int8 pool (half the KV bytes)
        mesh=None,  # TP mesh (parallel/tp.py): pools shard on KvH, tables replicate
        device: str | torch.device = "cuda",
    ):
        check_latent_options(cfg, paged=int(kv_pages) > 0, spec_k=spec_k, kv_int8=kv_int8,
                             mesh=mesh)
        if mesh is not None:
            if params.get("mesh") != mesh:
                raise ValueError(
                    "DecodeBatcher(mesh=...) takes parameters laid out over that mesh "
                    "(parallel/tp.py::shard_decoder_params)"
                )
            device = mesh.devices[0]  # where the host-side state and the head live
        self.mesh = mesh
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the batcher was given {self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.chunk_tokens = chunk_tokens
        self.eos_id = eos_id
        kept = tuple(b for b in prompt_buckets if b <= cfg.max_cache)
        # the ladder reaches max_cache, so no prompt prefills at a width of
        # its own
        if not kept or kept[-1] < cfg.max_cache:
            kept = kept + (cfg.max_cache,)
        self.prompt_buckets = kept

        # paged-KV mode: slots share a pool of kv_pages fixed-size pages,
        # allocated per request by actual prompt + max_new need and
        # reclaimed at finish. Page 0 is the reserved scratch target of
        # inactive rows. A request that cannot get its pages waits (in
        # order) until a finishing request frees them.
        self.page_size = page_size
        self.kv_pages = int(kv_pages)
        self._held: _Request | None = None
        self._adm: dict | None = None  # staged paged admission in flight
        self.prefix_hits = 0  # prompt pages served from cache (stats)
        self.prefix_lookups = 0
        self.backpressure_waits = 0  # admissions deferred for lack of pages
        # speculative acceptance (stats): tokens emitted per verify step
        self.spec_emitted = 0
        self.spec_steps = 0
        if kv_int8 and self.kv_pages <= 0:
            raise ValueError(
                "kv_int8 requires the paged pool (set kv_pages > 0); refusing to "
                "silently run the full-precision ring"
            )
        self.kv_int8 = bool(kv_int8)
        if self.kv_pages > 0:
            self.cache = init_paged_cache(
                cfg, slots, self.kv_pages, page_size,
                kv_dtype="int8" if self.kv_int8 else None, device=self.device, mesh=mesh,
            )
            self._maxp = cfg.max_cache // page_size
            if self.kv_pages < self._maxp + 1:
                # page 0 is scratch; a max-length request needs maxp pages
                # or admission could wait forever on an empty batcher
                raise ValueError(
                    f"kv_pages={kv_pages} < max_cache/page_size+1 "
                    f"({self._maxp + 1}): one full-length request must fit"
                )
            self._free_pages = list(range(self.kv_pages - 1, 0, -1))
            self._row_pages: list[list[int]] = [[] for _ in range(slots)]
            self._page_ref = [0] * self.kv_pages
            self.prefix_cache = bool(prefix_cache)
            # hash -> page, insertion-ordered (LRU: touched entries are
            # re-inserted at the end); page -> hash for reverse lookup
            self._prefix_map: dict[bytes, int] = {}
            self._page_hash: dict[int, bytes] = {}
            self._pfc = max(page_size, min(int(prefill_chunk), cfg.max_cache))
        else:
            self.prefix_cache = False
            self.cache = self._ring(slots)
        self.tok = np.zeros((slots,), np.int32)
        self.pos = np.zeros((slots,), np.int32)
        self.temp = np.zeros((slots,), np.float32)
        self.tp = np.ones((slots,), np.float32)
        self.seed = np.zeros((slots,), np.int32)
        self.active: list[_Request | None] = [None] * slots
        self.produced = [0] * slots

        self.pending: "queue.Queue[_Request]" = queue.Queue()
        # itertools.count().__next__ is atomic: submit() runs on caller
        # threads, and duplicate tokens would let a cancel() kill the
        # wrong stream
        self._next_token = itertools.count(1).__next__
        self._cancelled: set[int] = set()  # tokens; set ops are atomic
        self._live: set[int] = set()  # tokens of unfinished requests
        self._wake = threading.Event()
        self._stop = False
        self.dead: Exception | None = None  # set when the worker crashes
        # every row's base key is fold_in(_key0, row seed) == make_key(seed),
        # in the plain and in the speculative step alike
        self._key0 = torch.zeros((), dtype=torch.int64, device=self.device)
        self.spec_k = int(spec_k)
        self.spec_gram = int(spec_gram)
        # speculative mode keeps every row's tokens so far (prompt + emitted)
        self.tok_buf = (
            torch.zeros((slots, cfg.max_cache), dtype=torch.int32, device=self.device)
            if self.spec_k > 0 else None
        )
        # expert models: each forward's per-expert pair counts, reduced to a
        # chunk's moe.route fields on the device (None otherwise); records
        # (kind, t0, t1, rows, steps, fields [3] int32) await the next fetch
        self._chunk_route: torch.Tensor | None = None
        self._routes: list[tuple] = []

        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- device programs (worker thread, under inference_mode) --------------

    def _ring(self, batch: int):
        """A zeroed KV ring of ``batch`` rows, sharded on KvH under TP."""
        ring = init_cache(self.cfg, batch, self.device)
        if self.mesh is None:
            return ring
        from outline_rag_tpu_torch.parallel.tp import shard_decoder_cache  # noqa: PLC0415

        return shard_decoder_cache(ring, self.mesh)

    def _prefill(self, toks: torch.Tensor):
        """Ring mode: one prompt row through a fresh 1-row ring."""
        row_cache = self._ring(1)
        start = torch.zeros((1,), dtype=torch.int32, device=self.device)
        return decoder_forward(self.params, toks, row_cache, start, self.cfg)

    def _prefill_paged(self, row_table: torch.Tensor, toks: torch.Tensor, start: int):
        """One-row paged prefill chunk: writes land in the row's own pages
        via its table; attention walks shared prefix pages read-only
        (``start`` lies past their span). The pools are the batcher's own,
        updated in place."""
        row_view = dataclasses.replace(self.cache, table=row_table[None])
        if row_view.latent is not None:
            row_view.span = self._span(start + toks.shape[1])
        pos = torch.full((1,), start, dtype=torch.int32, device=self.device)
        route = self._route_counts(1)
        logits, _ = decoder_forward(self.params, toks, row_view, pos, self.cfg,
                                    route=None if route is None else route[0])
        self._chunk_route = self._route_fields(route)
        return logits

    def _span(self, end: int) -> int:
        """Table columns holding every position below ``end``."""
        return min(self._maxp, -(-end // self.page_size))

    def _route_counts(self, steps: int) -> torch.Tensor | None:
        """Zeroed per-expert pair counts ``[steps, expert layers, experts]``
        of an expert model, else None."""
        moe = self.cfg.moe
        if moe is None:
            return None
        return torch.zeros((steps, self.cfg.moe_layers, moe.experts), dtype=torch.int64,
                           device=self.device)

    @staticmethod
    def _route_fields(counts: torch.Tensor | None) -> torch.Tensor | None:
        """``pairs``, ``experts_hit``, ``expert_tokens_max`` of a chunk's
        counts, int32 [3] on the device."""
        if counts is None:
            return None
        return torch.stack([counts.sum(), (counts > 0).sum(), counts.amax()]).to(torch.int32)

    def _fetch(self, parts: list[torch.Tensor]) -> np.ndarray:
        """The chunk's ``parts`` side by side on the host, with every
        pending ``moe.route`` record's fields in the same copy; records
        them."""
        block = torch.cat(parts, dim=1)
        if not self._routes:
            return block.cpu().numpy()
        flat = torch.cat([block.flatten()] + [r[-1] for r in self._routes]).cpu().numpy()
        fields = flat[block.numel():].reshape(-1, 3)
        for (kind, t0, t1, rows, steps, _), (pairs, hit, most) in zip(self._routes, fields):
            metrics.add("moe.route", t0, t1, kind=kind, rows=rows, steps=steps, pairs=int(pairs),
                        experts_hit=int(hit), expert_tokens_max=int(most))
        self._routes = []
        return flat[: block.numel()].reshape(block.shape)

    def _step_chunk(self, tok, pos, seeds, temp, tp, active):
        """``chunk_tokens`` decode steps over every slot with no host
        synchronisation: sampling, the eos freeze and the position clamp
        stay on the device. Returns (tokens [slots, chunk], next token,
        next position)."""
        cap = self.cfg.max_cache - 2
        base = make_key(seeds, self.device)
        done = ~active
        out = []
        cache = self.cache
        if self.cfg.mla is not None:  # the latent pool's pages the chunk reaches
            ends = [int(self.pos[i]) + self.chunk_tokens
                    for i, r in enumerate(self.active) if r is not None]
            cache = dataclasses.replace(cache, span=self._span(max(ends, default=1)))
        route = self._route_counts(self.chunk_tokens)
        for i in range(self.chunk_tokens):
            logits, _ = decoder_forward(
                self.params, tok[:, None], cache, pos, self.cfg,
                route=None if route is None else route[i],
            )
            nxt = sample_token(logits[:, -1, :], key_at(base, pos + 1), temp, tp)
            nxt = torch.where(done, torch.full_like(nxt, self.eos_id), nxt)
            done = done | (nxt == self.eos_id)
            pos = (pos + 1).clamp(max=cap)
            tok = nxt
            out.append(nxt)
        self._chunk_route = self._route_fields(route)
        return torch.stack(out, dim=1), tok, pos

    def _step_spec(self, tok, pos, seeds, temp, tp, active):
        """``chunk_tokens`` verify steps over every slot, each advancing a
        row by 1 to ``spec_k + 1`` tokens, with no host synchronisation.
        Returns (tokens [slots, chunk * (spec_k + 1)], count [slots], next
        token, next position)."""
        emitted, cnt, self.cache, self.tok_buf, tok, pos = generate_chunk_spec(
            self.params, self.cache, self.tok_buf, tok, pos, self._key0, self.cfg,
            n_steps=self.chunk_tokens, draft_k=self.spec_k, gram=self.spec_gram,
            temperature=temp, top_p=tp, eos_id=self.eos_id, done0=~active, seeds=seeds,
        )
        return emitted, cnt, tok, pos

    # -- public API (thread-safe) -----------------------------------------

    def submit(
        self,
        prompt_ids: list[int],
        temperature: float,
        top_p: float,
        max_new: int,
        seed: int = 0,
        rid: int | None = None,
    ) -> "queue.Queue[Any]":
        """Enqueue a request; returns a queue yielding lists of token ids
        and finally the DONE sentinel. ``rid`` is the request id of its
        spans (by default the caller's, else a new one)."""
        submitted = time.perf_counter()
        if rid is None:
            rid = current_request() or new_request_id()
        if self.dead is not None:
            raise RuntimeError("decode batcher worker is dead") from self.dead
        if self._stop:
            # a submit racing a clean close() would enqueue a request no
            # one will ever drain
            raise RuntimeError("decode batcher is closed")
        out: "queue.Queue[Any]" = queue.Queue()
        limit = self.cfg.max_cache - max_new - 2
        prompt_ids = list(prompt_ids)[-max(limit, 4):]
        # cap generation so positions never reach the cache capacity
        max_new = min(max_new, self.cfg.max_cache - len(prompt_ids) - 2)
        tok = self._next_token()
        out.cancel_token = tok  # handle for cancel(out)
        self._live.add(tok)
        self.pending.put(
            _Request(prompt_ids, float(temperature), float(top_p), max_new, out, seed, token=tok,
                     rid=rid, submitted=submitted)
        )
        self._wake.set()
        if self.dead is not None:  # worker died between the check and the put
            self._die(self.dead)
        return out

    def _retire(self, req: "_Request | None") -> None:
        """Mark a request finished: its token leaves the live set and any
        pending cancel mark is dropped."""
        if req is not None:
            self._live.discard(req.token)
            self._cancelled.discard(req.token)

    def cancel(self, out: "queue.Queue[Any]") -> None:
        """Abandon the stream bound to ``out`` (thread-safe; e.g. the
        client disconnected). The worker reclaims the slot, and in paged
        mode the pages, at its next scheduling point. The stream still
        ends with DONE."""
        token = getattr(out, "cancel_token", None)
        if token is not None and token in self._live:
            self._cancelled.add(token)
            self._wake.set()

    def stats(self) -> dict:
        """Operational snapshot (reads are racy but harmless: ints)."""
        out = {
            "slots": self.slots,
            "active": sum(1 for r in self.active if r is not None),
            "queued": self.pending.qsize()
            + (1 if self._held else 0)
            + (1 if self._adm is not None else 0),
            "admitting": self._adm is not None,
            "mode": "paged" if self.kv_pages > 0 else "ring",
        }
        if self.kv_pages > 0:
            out.update(
                pages_total=self.kv_pages - 1,  # page 0 is scratch
                kv_dtype="int8" if self.kv_int8 else str(self.cfg.dtype).removeprefix("torch."),
                kv_bytes_per_token=self.cache.bytes_per_token,
                pages_free=len(self._free_pages),
                pages_cached=len(self._prefix_map),
                prefix_hits=self.prefix_hits,
                prefix_lookups=self.prefix_lookups,
                backpressure_waits=self.backpressure_waits,
            )
        if self.spec_k > 0:
            out["spec_tokens_per_step"] = (
                round(self.spec_emitted / self.spec_steps, 3) if self.spec_steps else None
            )
        return out

    def flush_prefix_cache(self) -> None:
        """Drop every cached prefix page with no live user (frees them for
        reallocation). Only safe while no admission is in flight (the
        worker owns these structures); for tests, benchmarks and operator
        resets."""
        if self.kv_pages <= 0:
            return
        for h, pg in list(self._prefix_map.items()):
            if self._page_ref[pg] == 0:
                del self._prefix_map[h]
                del self._page_hash[pg]
                self._free_pages.append(pg)

    def close(self) -> None:
        """Stop the worker; active and pending requests get DONE so no
        caller blocks forever. The worker is the only writer of batcher
        state, so the teardown waits until the thread is dead; if it is
        wedged, the state is left to it (the worker drains on its way
        out)."""
        self._stop = True
        self._wake.set()
        deadline = 18  # x 10 s
        for _ in range(deadline):
            self._thread.join(timeout=10)
            if not self._thread.is_alive():
                break
        if self._thread.is_alive():
            logging.getLogger(__name__).error(
                "decode batcher worker did not exit within %ss; "
                "skipping teardown of worker-owned state", deadline * 10,
            )
            return
        # one more sweep catches a request that raced past submit()'s
        # closed check before _stop was visible
        self._drain_done()

    # -- worker ------------------------------------------------------------

    def _free_slot(self) -> int | None:
        reserved = self._adm["row"] if self._adm is not None else -1
        for i, r in enumerate(self.active):
            if r is None and i != reserved:
                return i
        return None

    def _row_seed(self, req: _Request) -> int:
        return req.seed or (abs(hash(tuple(req.prompt_ids))) % (2**31))

    def _sample_first(self, req: _Request, logits: torch.Tensor, offset: int) -> int:
        # the first token lands at position t = len(prompt): the same
        # positional-key convention as the step program, so the whole
        # stream of a (seed, prompt) pair is one deterministic sequence
        t = len(req.prompt_ids)
        base = make_key(self._row_seed(req), self.device)
        first = _sample_one(
            logits[0, offset, :].float(), key_at(base, t), req.temperature, req.top_p
        )
        return int(first)  # one int per admission crosses to the host

    def _set_row_state(self, req: _Request, row: int, first_id: int) -> None:
        t = len(req.prompt_ids)
        if self.tok_buf is not None:
            row_buf = np.zeros((self.cfg.max_cache,), np.int32)
            row_buf[:t] = req.prompt_ids
            self.tok_buf[row] = torch.from_numpy(row_buf).to(self.device)
        self.tok[row] = first_id
        self.pos[row] = t
        self.seed[row] = self._row_seed(req)
        self.temp[row] = req.temperature
        self.tp[row] = req.top_p
        self.active[row] = req
        self.produced[row] = 1
        req.out.put([first_id])

    def _tokens(self, ids: list[int]) -> torch.Tensor:
        return torch.tensor([ids], dtype=torch.int32, device=self.device)

    def _admit(self, req: _Request, row: int) -> bool:
        """Admit ``req`` into slot ``row``. Returns False when the paged
        pool cannot supply the request's pages yet (the caller holds the
        request until a finish frees pages). Paged mode only *stages* the
        admission here; prefill advances chunk by chunk in the worker
        loop."""
        if self.kv_pages > 0:
            return self._start_admission(req, row)
        t = len(req.prompt_ids)
        staged = self._dequeued(req)
        bucket = next((b for b in self.prompt_buckets if b >= t), self.prompt_buckets[-1])
        logits, row_cache = self._prefill(self._tokens(req.prompt_ids + [0] * (bucket - t)))
        first_id = self._sample_first(req, logits, t - 1)
        metrics.add("decode.admit", staged, time.perf_counter(), rid=req.rid, chunks=1,
                    shared_pages=0)
        if first_id == self.eos_id or req.max_new < 1:
            self._retire(req)
            req.out.put(DONE)
            return True
        for dst, src in zip(self.cache, row_cache):
            if self.mesh is None:
                dst[:, row] = src[:, 0]
            else:  # one KvH shard a device
                for d, s in zip(dst, src):
                    d[:, row] = s[:, 0]
        self._set_row_state(req, row, first_id)
        return True

    def _dequeued(self, req: _Request) -> float:
        """Close the request's ``decode.queue`` span; returns its end."""
        now = time.perf_counter()
        metrics.add("decode.queue", req.submitted, now, rid=req.rid,
                    prompt_tokens=len(req.prompt_ids))
        return now

    # -- paged-pool bookkeeping (worker thread only) -----------------------

    def _block_hashes(self, ids: list[int]) -> list[bytes]:
        """Cumulative content hash per full page-size block: block i's key
        commits to every token in [0, (i+1)*page_size)."""
        s = self.page_size
        hs: list[bytes] = []
        prev = b""
        for i in range(len(ids) // s):
            m = hashlib.blake2b(prev, digest_size=16)
            m.update(np.asarray(ids[i * s:(i + 1) * s], np.int32).tobytes())
            prev = m.digest()
            hs.append(prev)
        return hs

    def _evict_one(self) -> bool:
        """Free the least-recently-used cached page with no live user."""
        for h, pg in self._prefix_map.items():
            if self._page_ref[pg] == 0:
                del self._prefix_map[h]
                del self._page_hash[pg]
                self._free_pages.append(pg)
                return True
        return False

    def _release_pages(self, pages: list[int]) -> None:
        for pg in reversed(pages):
            self._page_ref[pg] -= 1
            if self._page_ref[pg] <= 0 and pg not in self._page_hash:
                self._free_pages.append(pg)

    def _register_prompt_pages(self, hashes: list[bytes], pages: list[int], n_full: int) -> None:
        """Content-address the request's full prompt pages so later
        requests with the same prefix can share them. Generated tokens are
        never cached (their pages change until finish)."""
        if not self.prefix_cache:
            return
        for i in range(n_full):
            h = hashes[i]
            if h in self._prefix_map or pages[i] in self._page_hash:
                continue
            self._prefix_map[h] = pages[i]
            self._page_hash[pages[i]] = h

    def _start_admission(self, req: _Request, row: int) -> bool:
        """Allocate pages for ``req`` and stage an incremental admission
        (host side only). Returns False under backpressure. Prefill then
        advances one chunk per ``_advance_admission`` call, interleaved
        with decode steps, so a long prompt never stalls active streams
        for more than a chunk."""
        s = self.page_size
        t = len(req.prompt_ids)
        hashes = self._block_hashes(req.prompt_ids) if self.prefix_cache else []

        # longest cached chain of full prompt pages, capped so at least one
        # suffix token remains to forward (its logits seed sampling)
        shared: list[int] = []
        for i in range(min(len(hashes), (t - 1) // s)):
            pg = self._prefix_map.get(hashes[i])
            if pg is None:
                break
            shared.append(pg)
        # take refs up front: a ref-0 cached page about to be shared must
        # not double as an eviction candidate below
        for pg in shared:
            self._page_ref[pg] += 1
            h = self._page_hash[pg]  # LRU touch
            self._prefix_map.pop(h)
            self._prefix_map[h] = pg
        self.prefix_lookups += 1
        self.prefix_hits += len(shared)

        # worst-case pages for prompt + generation (+ the speculative
        # window), so the row can never starve mid-flight
        span = t + req.max_new + 1 + self.spec_k
        need = min(-(-span // s), self._maxp)
        fresh_needed = need - len(shared)
        while len(self._free_pages) < fresh_needed:
            if not self._evict_one():
                for pg in shared:  # roll back; hold for backpressure
                    self._page_ref[pg] -= 1
                self.backpressure_waits += 1
                return False
        fresh = [self._free_pages.pop() for _ in range(fresh_needed)]
        for pg in fresh:
            self._page_ref[pg] = 1
        pages = shared + fresh

        row_table = np.zeros((self._maxp,), np.int32)
        row_table[: len(pages)] = pages
        self._adm = {
            "req": req, "row": row, "pages": pages, "hashes": hashes,
            "table": torch.from_numpy(row_table).to(self.device), "t": t,
            "c0": len(shared) * s, "staged": self._dequeued(req),
            "span": metrics.new_span_id(), "chunks": 0, "shared": len(shared),
        }
        return True

    def _admitted(self, adm: dict) -> None:
        """Close the staged admission's ``decode.admit`` span."""
        metrics.add("decode.admit", adm["staged"], time.perf_counter(), rid=adm["req"].rid,
                    sid=adm["span"], chunks=adm["chunks"], shared_pages=adm["shared"])

    def _advance_admission(self) -> None:
        """One prefill chunk of the staged admission; finalizes (first
        token, prefix registration, row activation) after the last. Chunk
        sequence and per-position math are those of a monolithic prefill,
        so interleaving never changes output."""
        adm = self._adm
        req, t, c0 = adm["req"], adm["t"], adm["c0"]
        if req.token in self._cancelled:
            self._retire(req)
            self._release_pages(adm["pages"])
            self._adm = None
            self._admitted(adm)
            req.out.put(DONE)
            return
        pfc = self._pfc
        try:
            chunk = req.prompt_ids[c0:c0 + pfc]
            with metrics.span("decode.prefill", rid=req.rid, parent=adm["span"], start=c0,
                              tokens=len(chunk)) as span:
                logits = self._prefill_paged(
                    adm["table"], self._tokens(chunk + [0] * (pfc - len(chunk))), c0
                )
            self._route_record("prefill", span, 1, 1)
            adm["c0"] = c0 + pfc
            adm["chunks"] += 1
            if adm["c0"] < t:
                return  # more chunks to go; let decode steps interleave
            first_id = self._sample_first(req, logits, (t - 1) - c0)
            self._admitted(adm)
        except Exception:
            # keep the pool accounting coherent (refs dropped, fresh pages
            # freed) before the caller's fail-fast policy runs
            self._release_pages(adm["pages"])
            self._adm = None
            raise
        self._adm = None
        self._register_prompt_pages(adm["hashes"], adm["pages"], t // self.page_size)
        if first_id == self.eos_id or req.max_new < 1:
            self._retire(req)
            self._release_pages(adm["pages"])
            req.out.put(DONE)
            return
        row = adm["row"]
        self._row_pages[row] = adm["pages"]
        self.cache.table[row] = adm["table"]
        self._set_row_state(req, row, first_id)

    def _finish(self, row: int) -> None:
        req = self.active[row]
        self.active[row] = None
        self._retire(req)
        if self.kv_pages > 0 and self._row_pages[row]:
            # drop the row's refs (cached prefix pages stay resident until
            # evicted); point its table at the scratch page 0 so the row's
            # garbage writes can never land in a reallocated page
            self._release_pages(self._row_pages[row])
            self._row_pages[row] = []
            self.cache.table[row] = 0
        if req is not None:
            req.out.put(DONE)

    def _stage_admissions(self) -> None:
        """Admit pending requests into free slots (in order; a request the
        paged pool cannot serve yet is held, blocking later ones, until a
        finishing request frees pages). Paged mode stages at most one
        admission at a time; ring mode admits fully inline."""
        while not (self.kv_pages > 0 and self._adm is not None):
            row = self._free_slot()
            if row is None:
                break
            if self._held is not None:
                req, self._held = self._held, None
            else:
                try:
                    req = self.pending.get_nowait()
                except queue.Empty:
                    break
            if req.token in self._cancelled:
                self._dequeued(req)
                self._retire(req)
                req.out.put(DONE)
                continue
            try:
                if not self._admit(req, row):
                    self._held = req
                    break
            except Exception as e:  # surface failures to the caller
                self._retire(req)
                req.out.put(e)
                req.out.put(DONE)

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._loop()

    def _loop(self) -> None:
        while not self._stop:
            with metrics.span("decode.stage"):
                if not self._schedule():
                    return
            if self._adm is None and not any(r is not None for r in self.active):
                with metrics.span("decode.idle"):
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                continue
            if not any(r is not None for r in self.active):
                continue  # only the staged admission is in flight

            try:
                active_mask = np.asarray([r is not None for r in self.active], bool)
                rows = int(active_mask.sum())
                with metrics.span("decode.launch", rows=rows, steps=self.chunk_tokens) as span:
                    dev = self.device
                    state = (
                        torch.from_numpy(self.tok).to(dev),
                        torch.from_numpy(self.pos).to(dev),
                        torch.from_numpy(self.seed).to(dev),
                        torch.from_numpy(self.temp).to(dev),
                        torch.from_numpy(self.tp).to(dev),
                        torch.from_numpy(active_mask).to(dev),
                    )
                    if self.tok_buf is not None:
                        toks, cnt, tok_dev, pos_dev = self._step_spec(*state)
                        # one fetch a chunk: [slots, chunk * (spec_k + 1) + 3]
                        parts = [toks, cnt[:, None], tok_dev[:, None], pos_dev[:, None]]
                    else:
                        toks, tok_dev, pos_dev = self._step_chunk(*state)
                        # one fetch a chunk: [slots, chunk + 2]
                        parts = [toks, tok_dev[:, None], pos_dev[:, None]]
                self._route_record("decode", span, rows, self.chunk_tokens)
                with metrics.span("decode.fetch"):
                    fetched = self._fetch(parts)
                with metrics.span("decode.emit"):
                    self._emit(fetched, active_mask)
            except Exception as e:  # device/runtime failure: fail every
                self._die(e)  # waiter, mark dead so submit() fails fast
                return
        # normal stop: the worker owns the final drain (see _drain_done)
        self._drain_done()

    def _route_record(self, kind: str, span, rows: int, steps: int) -> None:
        """Queue the chunk just run's ``moe.route`` record (expert models)
        with the ends of its ``span``."""
        if self._chunk_route is not None:
            self._routes.append((kind, span.t0, span.t1, rows, steps, self._chunk_route))
            self._chunk_route = None

    def _schedule(self) -> bool:
        """Stage admissions and advance the staged one; False when a failed
        prefill killed the batcher."""
        self._stage_admissions()
        if self._cancelled:
            # cancel() raced a completion: drop tokens no longer live
            self._cancelled &= self._live
        # Advance the staged paged admission. At full load: one prefill
        # chunk per decode chunk (fairness for the active streams).
        # With idle slots: up to min(8, idle) chunks, staging follow-up
        # admissions as each completes, so a burst of arrivals ramps to
        # full concurrency instead of one admission per decode chunk
        # while every step pays full-slot-count compute.
        idle = sum(1 for r in self.active if r is None)
        budget = min(8, max(1, idle))
        while budget > 0 and self._adm is not None:
            adm_req = self._adm["req"]
            try:
                self._advance_admission()
            except Exception as e:
                # a failed paged prefill may have died half way through
                # in-place pool updates: fail the whole batcher rather
                # than decode from a corrupt pool
                self._retire(adm_req)
                adm_req.out.put(e)
                adm_req.out.put(DONE)
                self._die(e)
                return False
            budget -= 1
            if self._adm is None:
                self._stage_admissions()
        return True

    def _emit(self, fetched: np.ndarray, active_mask: np.ndarray) -> None:
        """Hand each live row its chunk's tokens; finish and cancel rows."""
        if self.tok_buf is not None:
            toks_np, counts = fetched[:, :-3], fetched[:, -3]
            self.spec_emitted += int(counts[active_mask].sum())
            self.spec_steps += int(active_mask.sum()) * self.chunk_tokens
        else:
            toks_np, counts = fetched[:, :-2], None
        self.tok = fetched[:, -2].astype(np.int32)
        self.pos = fetched[:, -1].astype(np.int32)
        for row, req in enumerate(self.active):
            if req is None:
                continue
            if req.token in self._cancelled:
                self._finish(row)  # reclaims slot and pages; DONE
                continue
            ids = toks_np[row].tolist()
            if counts is not None:
                ids = ids[: int(counts[row])]
                if not ids:  # a row the capacity guard froze: end the stream
                    self._finish(row)
                    continue
            stop = self.eos_id in ids
            if stop:
                ids = ids[: ids.index(self.eos_id)]
            room = req.max_new - self.produced[row]
            if len(ids) >= room:
                ids = ids[:room]
                stop = True
            self.produced[row] += len(ids)
            if ids:
                req.out.put(ids)
            if stop:
                self._finish(row)

    def _waiting(self) -> list[_Request]:
        """Take every staged, held, active and pending request off the
        batcher's state (teardown)."""
        reqs = []
        if self._adm is not None:
            reqs.append(self._adm["req"])
            self._adm = None
        if self._held is not None:
            reqs.append(self._held)
            self._held = None
        for row, req in enumerate(self.active):
            if req is not None:
                self.active[row] = None
                reqs.append(req)
        while True:
            try:
                reqs.append(self.pending.get_nowait())
            except queue.Empty:
                return reqs

    def _drain_done(self) -> None:
        """Final drain: every staged, held, active and pending request gets
        DONE and the state is cleared. Runs when the worker loop exits on
        ``_stop``, so streams end even if ``close()`` gave up joining."""
        for req in self._waiting():
            self._retire(req)
            req.out.put(DONE)

    def _die(self, exc: Exception) -> None:
        self.dead = exc
        for req in self._waiting():
            self._retire(req)
            req.out.put(exc)
            req.out.put(DONE)
