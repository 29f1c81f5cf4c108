"""The fused query: embed -> scan -> gather -> rerank, over device-resident
state.

Port of ``outline_rag_tpu/engine/fused.py`` without the lexical and ColBERT
terms. Stages:

1. query encoder forward + CLS pooling -> [B, H] unit vectors;
2. the retrieval top ``top_k``: for an int8 index, int8 quantization of
   the queries and the int8 scan for the top ``rescore_m`` candidates
   (``topk_int8``: the CUDA kernel on a GPU), rescored exactly in f32
   from the q1 (and q2) planes; for a float index (f32, bf16, f32x2
   pairs), ``cosine_topk`` directly (``topk_float``: the CUDA kernel);
3. on-device gather of the candidates' chunk tokens from the token cache;
4. cross-encoder over the B*K (query, chunk) pairs;
5. top ``rerank_k`` by cross-encoder score, dead candidates masked.

Only the final rows and scores return to the host.
"""

from __future__ import annotations

import torch

from outline_rag_tpu_torch.index.store import VectorIndex
from outline_rag_tpu_torch.models.encoder import Encoder, pooled_embeddings
from outline_rag_tpu_torch.models.reranker import Reranker
from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8
from outline_rag_tpu_torch.ops.topk import NEG, cosine_topk

Q_WIDTH = 64  # query tokens: the encoder runs every query at this width


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
):
    """Stages 1-5. Returns ``(r_rows [B, rerank_k], r_vals (cross-encoder
    scores), retr_vals (their retrieval scores), idx [B, top_k],
    vals [B, top_k])``; dead slots carry values <= NEG/2."""
    # 1. encode queries
    q_emb = pooled_embeddings(encoder, q_ids, q_mask)

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


class FusedEngine:
    """Host wrapper: tokenization, the index snapshot, row-id translation."""

    def __init__(
        self,
        embedder,  # EncoderEmbedder
        reranker,  # CrossEncoderReranker
        index: VectorIndex,
        top_k: int = 12,
        rerank_k: int = 3,
    ):
        if index.tokens is None:
            raise ValueError("FusedEngine needs an index with a token cache")
        self.embedder = embedder
        self.reranker = reranker
        self.index = index
        self.top_k = top_k
        self.rerank_k = rerank_k

    @torch.inference_mode()
    def query(self, texts: list[str]) -> list[list[tuple[str, float, float]]]:
        """Per query: ``(chunk_id, cross-encoder score, retrieval score)``
        for the top ``rerank_k`` live candidates."""
        if not texts:
            return []
        tok = self.embedder.tokenizer
        tb = tok.batch(texts, Q_WIDTH, buckets=(Q_WIDTH,))
        dev = self.index.device
        q_ids = torch.as_tensor(tb.input_ids, device=dev)
        q_mask = torch.as_tensor(tb.attention_mask, device=dev)
        with self.index.read_section():
            # snapshot, run, fetch and translate inside the read section:
            # mutations write the shard in place once readers drain
            state, row_ids = self.index.snapshot()
            tokens = self.index.tokens.state
            r_rows, r_vals, retr_vals, _, _ = fused_query(
                self.embedder.encoder,
                self.reranker.model,
                q_ids,
                q_mask,
                state.vectors,
                state.scales,
                state.penalty,
                tokens.ids,
                tokens.mask,
                state.residual if state.residual.shape[1] else None,
                top_k=min(self.top_k, state.capacity),
                rerank_k=min(self.rerank_k, self.top_k),
                eos_id=tok.eos_id,
            )
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
