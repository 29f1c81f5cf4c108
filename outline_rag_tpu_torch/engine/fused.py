"""The fused query: embed -> scan -> gather -> hybrid terms -> rerank, over
device-resident state.

Port of ``outline_rag_tpu/engine/fused.py``. Stages:

1. query encoder forward -> [B, Tq, H] hidden states, CLS pooling -> [B, H]
   unit vectors;
2. the retrieval top ``top_k``: for an int8 index, int8 quantization of
   the queries and the int8 scan for the top ``rescore_m`` candidates
   (``topk_int8``: the CUDA kernel on a GPU), rescored exactly in f32
   from the q1 (and q2) planes; for a float index (f32, bf16, f32x2
   pairs), ``cosine_topk`` directly (``topk_float``: the CUDA kernel);
3. on-device gather of the candidates' chunk tokens from the token cache;
3b. with ``lex_weight`` > 0 and a sparse head: the BGE-m3 lexical-overlap
   term added to the retrieval scores;
3c. with ``colbert_weight`` > 0 and a ColBERT head: the late-interaction
   term, from the cache's int8 codes gathered by row (given
   ``tok_cvecs``), else from the candidates re-encoded;
4. cross-encoder over the B*K (query, chunk) pairs;
5. top ``rerank_k`` by cross-encoder score, dead candidates masked.

:func:`fused_query_mesh` is the same query over a row-sharded index: the
encoder and the reranker run once, on the mesh's first device, and stages
2-3 run on each shard (``parallel/query.py::sharded_retrieve_tokens``), its
scan and its candidates' token gather local, before one merge of the
``[B, K]`` lists; stages 3b-5 are then those of :func:`fused_query`.
:class:`FusedEngine` takes it when the index has a mesh.

The terms change the retrieval scores reported beside the cross-encoder's,
not which candidates are reranked. With both weights 0 (the default) the
path launches what it launched without them. The terms are stock PyTorch
ops (einsums, a max, a masked mean), true fp32 while TF32 is off. Only the
final rows and scores return to the host.

Spans (``utils/profiling.py``), one of each a batch: ``fused.tokenize`` (the
tokenizer and the copy to the device), ``fused.encode`` (stage 1),
``fused.scan`` (stage 2 and the token gather of stage 3; on a mesh, the
shards' retrieval and its merge), ``fused.rerank`` (stages 3b-5) and
``fused.fetch`` (the copies to the host and the row ids). They time the
host: a device stage's span is the time its kernels took to launch, and the
fetch's holds the wait for them.
"""

from __future__ import annotations

import functools

import torch

from outline_rag_tpu_torch.index.store import VectorIndex
from outline_rag_tpu_torch.models.encoder import (
    Encoder,
    cls_pooled,
    colbert_vectors_from_hidden,
    late_interaction_scores,
    lexical_overlap_scores,
    sparse_weights_from_hidden,
)
from outline_rag_tpu_torch.models.reranker import Reranker
from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8
from outline_rag_tpu_torch.ops.topk import NEG, cosine_topk
from outline_rag_tpu_torch.utils.profiling import metrics

Q_WIDTH = 64  # query tokens: the default width every query is run at


def encode_queries(
    encoder: Encoder, q_ids: torch.Tensor, q_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One encoder forward feeds the three heads: ``(hidden [B, Tq, H],
    CLS-pooled unit vectors [B, H] f32)``."""
    hidden = encoder(q_ids, q_mask)
    return hidden, cls_pooled(hidden)


def add_hybrid_terms(
    vals: torch.Tensor,  # [B, K] retrieval scores
    encoder: Encoder,
    q_hidden: torch.Tensor,  # [B, Tq, H]
    q_ids: torch.Tensor,  # [B, Tq]
    q_mask: torch.Tensor,  # [B, Tq]
    cand_ids: torch.Tensor,  # [B, K, Tc] CLS-first chunk tokens
    cand_mask: torch.Tensor,  # [B, K, Tc]
    cand_w: torch.Tensor | None,  # [B, K, Tc] f32 lexical weights
    cand_cvecs: torch.Tensor | None = None,  # [B, K, Tc, r] int8 cached codes
    cand_cscale: torch.Tensor | None = None,  # [B, K, Tc] f32
    colbert_proj: torch.Tensor | None = None,  # [Hc, r] f32
    *,
    lex_weight: float,
    colbert_weight: float,
) -> torch.Tensor:
    """Stages 3b-3c: ``vals + lex_weight * lexical + colbert_weight *
    MaxSim`` (added in that order), each term only where its weight is
    positive and the encoder has its head. The ColBERT term reads the
    cached codes when ``cand_cvecs`` is given (query vectors projected by
    ``colbert_proj``), else it re-encodes the K candidates."""
    if lex_weight > 0.0 and encoder.sparse is not None:
        q_w = sparse_weights_from_hidden(encoder, q_hidden, q_ids, q_mask)
        if cand_w is None:
            cand_w = torch.zeros(cand_ids.shape, dtype=torch.float32, device=cand_ids.device)
        vals = vals + lex_weight * lexical_overlap_scores(q_ids, q_w, cand_ids, cand_w)
    if colbert_weight > 0.0 and encoder.colbert is not None:
        q_cb = colbert_vectors_from_hidden(encoder, q_hidden, q_mask)
        if cand_cvecs is not None:
            q_cb = q_cb @ colbert_proj.to(q_cb.device, torch.float32)
            c_cb = cand_cvecs.float() * cand_cscale[..., None]
        else:
            b, k, tc = cand_ids.shape
            flat_mask = cand_mask.reshape(b * k, tc)
            c_hidden = encoder(cand_ids.reshape(b * k, tc), flat_mask)
            c_cb = colbert_vectors_from_hidden(encoder, c_hidden, flat_mask).reshape(b, k, tc, -1)
        vals = vals + colbert_weight * late_interaction_scores(q_cb, q_mask, c_cb)
    return vals


def fused_query(
    encoder: Encoder,
    reranker: Reranker,
    q_ids: torch.Tensor,  # [B, Tq] int
    q_mask: torch.Tensor,  # [B, Tq] int
    vectors: torch.Tensor,  # [N, D] int8 (q1 plane), f32 or bf16; [N, 2D] bf16 pairs
    scales: torch.Tensor,  # [N] f32 (int8 modes; unused otherwise)
    penalty: torch.Tensor,  # [N] f32
    tok_ids: torch.Tensor,  # [N, Tc] int32
    tok_mask: torch.Tensor,  # [N, Tc] int32
    residual: torch.Tensor | None = None,  # [N, D] int8 (int8r q2 plane)
    *,
    top_k: int,
    rerank_k: int,
    eos_id: int = 2,
    tok_weights: torch.Tensor | None = None,  # [N, Tc] f32 lexical weights
    tok_cvecs: torch.Tensor | None = None,  # [N, Tc, r] int8 ColBERT codes
    tok_cscale: torch.Tensor | None = None,  # [N, Tc] f32
    colbert_proj: torch.Tensor | None = None,  # [Hc, r] f32
    lex_weight: float = 0.0,
    colbert_weight: float = 0.0,
):
    """Stages 1-5. Returns ``(r_rows [B, rerank_k], r_vals (cross-encoder
    scores), retr_vals (their retrieval scores, terms included), idx
    [B, top_k], vals [B, top_k])``; dead slots carry values <= NEG/2."""
    # 1. encode queries
    with metrics.span("fused.encode"):
        q_hidden, q_emb = encode_queries(encoder, q_ids, q_mask)

    with metrics.span("fused.scan"):
        # 2. retrieval top_k
        if vectors.dtype == torch.int8:
            # int8 scan for candidates + exact f32 rescore
            qq, qs = quantize_rows_int8(q_emb)
            vals, idx = int8_topk(
                qq, qs, vectors, scales, top_k, penalty, rescore_queries=q_emb,
                rescore_residual=residual,
            )
        else:
            vals, idx = cosine_topk(q_emb, vectors, top_k, penalty)

        # 3. gather the candidates' chunk tokens on the device
        rows = idx.long()
        cand_ids = tok_ids[rows]  # [B, K, Tc] (a new tensor: safe to edit)
        cand_mask = tok_mask[rows]
    hybrid = lex_weight > 0.0 or colbert_weight > 0.0
    cached = hybrid and tok_cvecs is not None
    return _rescore_and_rerank(
        encoder, reranker, q_hidden, q_ids, q_mask, vals, idx, cand_ids, cand_mask,
        tok_weights[rows] if hybrid and tok_weights is not None else None,
        tok_cvecs[rows] if cached else None,
        tok_cscale[rows] if cached else None,
        colbert_proj, rerank_k=rerank_k, eos_id=eos_id,
        lex_weight=lex_weight, colbert_weight=colbert_weight,
    )


def _rescore_and_rerank(
    encoder, reranker, q_hidden, q_ids, q_mask, vals, idx, cand_ids, cand_mask, cand_w,
    cand_cvecs, cand_cscale, colbert_proj, *, rerank_k: int, eos_id: int,
    lex_weight: float, colbert_weight: float,
):
    """Stages 3b-5 over the gathered candidates (``cand_ids`` is edited in
    place): the outputs of :func:`fused_query`."""
    with metrics.span("fused.rerank"):
        # 3b-3c. the hybrid terms, on the CLS-first rows (before slot 0 becomes
        # the pair separator)
        if lex_weight > 0.0 or colbert_weight > 0.0:
            vals = add_hybrid_terms(
                vals, encoder, q_hidden, q_ids, q_mask, cand_ids, cand_mask, cand_w,
                cand_cvecs, cand_cscale, colbert_proj,
                lex_weight=lex_weight, colbert_weight=colbert_weight,
            )

        # chunk rows are stored CLS-first; slot 0 becomes the pair separator
        # (the EOS EOS p EOS layout of XLM-R second segments)
        cand_ids[:, :, 0] = eos_id

        # 4. cross-encode (query ++ chunk) pairs: the full query row, padding
        # included, then the chunk row (padding sits mid-sequence and the
        # cumsum positions skip it, as in the JAX package)
        b, tq = q_ids.shape
        k, tc = idx.shape[1], cand_ids.shape[2]
        pair_ids = torch.cat(
            [q_ids[:, None, :].expand(b, k, tq).to(cand_ids.dtype), cand_ids], dim=2
        ).reshape(b * k, tq + tc)
        pair_mask = torch.cat(
            [q_mask[:, None, :].expand(b, k, tq).to(cand_mask.dtype), cand_mask], dim=2
        ).reshape(b * k, tq + tc)
        rr_scores = reranker(pair_ids, pair_mask).reshape(b, k)

        # 5. final top rerank_k by cross-encoder score; dead candidates masked
        rr_scores = rr_scores.masked_fill(vals <= NEG / 2, NEG)
        r_sorted, r_pos = torch.sort(rr_scores, dim=1, descending=True, stable=True)
        r_vals, r_pos = r_sorted[:, :rerank_k], r_pos[:, :rerank_k]
        r_rows = torch.gather(idx, 1, r_pos)
        retr_vals = torch.gather(vals, 1, r_pos)
        return r_rows, r_vals, retr_vals, idx, vals


def fused_query_mesh(
    encoder: Encoder,
    reranker: Reranker,
    q_ids: torch.Tensor,  # [B, Tq] int, on the mesh's first device
    q_mask: torch.Tensor,
    vectors,  # [N, D] (or [N, 2D] pairs), row-sharded over the mesh
    scales,  # [N] f32, row-sharded
    penalty,  # [N] f32, row-sharded
    tok_ids,  # [N, Tc] int32, row-sharded
    tok_mask,  # [N, Tc] int32, row-sharded
    residual=None,  # [N, D] int8 (int8r q2 plane), row-sharded
    *,
    top_k: int,
    rerank_k: int,
    mesh,
    eos_id: int = 2,
    tok_weights=None,  # [N, Tc] f32, row-sharded
    tok_cvecs=None,  # [N, Tc, r] int8, row-sharded
    tok_cscale=None,  # [N, Tc] f32, row-sharded
    colbert_proj: torch.Tensor | None = None,  # [Hc, r] f32
    lex_weight: float = 0.0,
    colbert_weight: float = 0.0,
):
    """:func:`fused_query` over a row-sharded index: the models run once,
    retrieval runs on every shard with one merge of the ``[B, top_k]``
    lists and their candidates' cached tokens (each shard's exact top-k and
    the shard-major merge keep the candidates and their ties those of the
    single-device query). ``top_k`` is at most ``N / mesh.size``. Same
    outputs."""
    from outline_rag_tpu_torch.parallel.query import sharded_retrieve_tokens  # noqa: PLC0415

    with metrics.span("fused.encode"):
        q_hidden, q_emb = encode_queries(encoder, q_ids, q_mask)
    with metrics.span("fused.scan"):
        vals, idx, cand_ids, cand_mask, cand_w, cand_cvecs, cand_cscale = (
            sharded_retrieve_tokens(
                q_emb, vectors, scales, penalty, tok_ids, tok_mask, tok_weights, top_k,
                tok_cvecs=tok_cvecs, tok_cscale=tok_cscale, residual=residual, mesh=mesh,
            )
        )
    return _rescore_and_rerank(
        encoder, reranker, q_hidden, q_ids, q_mask, vals, idx, cand_ids, cand_mask, cand_w,
        cand_cvecs, cand_cscale, colbert_proj, rerank_k=rerank_k, eos_id=eos_id,
        lex_weight=lex_weight, colbert_weight=colbert_weight,
    )


class FusedEngine:
    """Host wrapper: tokenization, the index snapshot, row-id translation.

    ``lex_weight`` / ``colbert_weight`` > 0 turn on the hybrid terms. With
    a ColBERT cache on the index, the query side projects with the index's
    pinned matrix, re-read whenever the index holds another one (an
    ``adopt`` of a snapshot brings its own)."""

    def __init__(
        self,
        embedder,  # EncoderEmbedder
        reranker,  # CrossEncoderReranker
        index: VectorIndex,
        top_k: int = 12,
        rerank_k: int = 3,
        q_width: int = Q_WIDTH,
        lex_weight: float = 0.0,
        colbert_weight: float = 0.0,
    ):
        if index.tokens is None:
            raise ValueError("FusedEngine needs an index with a token cache")
        self.embedder = embedder
        self.reranker = reranker
        self.index = index
        self.top_k = top_k
        self.rerank_k = rerank_k
        self.q_width = q_width
        self.lex_weight = lex_weight
        self.colbert_weight = colbert_weight
        # (the index's matrix, its copy on the device), replaced as one
        # tuple so concurrent queries never pair a matrix with another's copy
        self._pinned: tuple | None = None
        self._pin_projection()

    def _pin_projection(self) -> torch.Tensor | None:
        """The query-side ColBERT projection on the index's device, or None
        when the cached form is off (no weight, no head or no cache)."""
        colbert = self.embedder.encoder.colbert
        if (
            self.colbert_weight <= 0.0
            or colbert is None
            or self.index.tokens is None
            or self.index.tokens.colbert is None
        ):
            return None
        src = self.index.colbert_projection_for(colbert.out_features)
        pinned = self._pinned
        if pinned is None or pinned[0] is not src:
            pinned = (src, torch.tensor(src, dtype=torch.float32, device=self.index.device))
            self._pinned = pinned
        return pinned[1]

    @torch.inference_mode()
    def query(self, texts: list[str]) -> list[list[tuple[str, float, float]]]:
        """Per query: ``(chunk_id, cross-encoder score, retrieval score)``
        for the top ``rerank_k`` live candidates."""
        if not texts:
            return []
        tok = self.embedder.tokenizer
        with metrics.span("fused.tokenize"):
            tb = tok.batch(texts, self.q_width, buckets=(self.q_width,))
            dev = self.index.device
            q_ids = torch.as_tensor(tb.input_ids, device=dev)
            q_mask = torch.as_tensor(tb.attention_mask, device=dev)
        with self.index.read_section():
            # snapshot, run, fetch and translate inside the read section:
            # mutations write the shard in place once readers drain
            state, row_ids = self.index.snapshot()
            tokens = self.index.tokens
            proj = self._pin_projection()
            colbert = tokens.colbert if proj is not None else None
            mesh = self.index.mesh
            run = fused_query if mesh is None else functools.partial(fused_query_mesh, mesh=mesh)
            r_rows, r_vals, retr_vals, _, _ = run(
                self.embedder.encoder,
                self.reranker.model,
                q_ids,
                q_mask,
                state.vectors,
                state.scales,
                state.penalty,
                tokens.state.ids,
                tokens.state.mask,
                state.residual if state.residual.shape[1] else None,
                top_k=min(self.top_k, state.capacity // (mesh.size if mesh else 1)),
                rerank_k=min(self.rerank_k, self.top_k),
                eos_id=getattr(tok, "eos_id", 2),  # HFTokenizer has none: XLM-R's </s>
                tok_weights=tokens.state.weights,
                tok_cvecs=colbert.codes if colbert is not None else None,
                tok_cscale=colbert.scales if colbert is not None else None,
                colbert_proj=proj,
                lex_weight=self.lex_weight,
                colbert_weight=self.colbert_weight,
            )
            with metrics.span("fused.fetch"):
                r_rows = r_rows.cpu().numpy()
                r_vals = r_vals.cpu().numpy()
                retr_vals = retr_vals.cpu().numpy()
                return [
                    [
                        (str(row_ids[r]), float(rv), float(dv))
                        for r, rv, dv in zip(rows, rvals, dvals)
                        if rv > NEG / 2
                    ]
                    for rows, rvals, dvals in zip(r_rows, r_vals, retr_vals)
                ]
