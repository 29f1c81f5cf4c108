#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``outline_rag_tpu_torch``) once on an NVIDIA
GPU and check it.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout, on a machine with one CUDA card and
``nvcc``. It imports no jax and nothing of the JAX package. Phases, each
printing one JSON line; any failure raises and the exit code is non-zero:

1. env     torch / CUDA versions, the card, its power limit, TF32 flags.
2. build   compile ``outline_rag_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernel  ``topk_int8`` (the CUDA kernel) against ``topk_int8_plain`` on
           the card over a seeded 1,048,576 x 1024 int8 corpus (1% rows
           tombstoned, duplicated rows to force ties) at B in {1, 32, 128}
           and K in {12, 64}, plus a case with fewer live rows than K.
           Values and indices must be bit-equal (the scan's contract).
           Median of 10 CUDA-event timings of both at B = 32 and 128,
           K = 64 (the kernel also over many launches, ``device_ms``), of
           the kernel at B = 32, K = 12, and at B = 32, K = 64 of
           a library pair as a yardstick: ``torch._int_mm`` of the codes
           against the corpus's transpose, then the scales, the penalty and
           ``torch.topk`` (no order among ties: not the same function).
4. slice   the serving path at bge-m3 width: seeded random bge-m3 encoder
           and bge-reranker-v2-m3 cross-encoder in bf16, the hash
           tokenizer, an int8r VectorIndex of capacity 1,048,576 x 1024
           with a 64-wide token cache; 4,096 text chunks embedded by the
           port's encoder, seeded unit vectors up to 1,000,000 live rows,
           then one source deleted. 64 concurrent requests go through
           ``QueryBatcher(RetrievalService(...).retrieve_batch)``: every
           answer has 3 distinct live chunks, the fused path served them,
           and the kernel's launch count grew. For one batch, the fused
           query's retrieval top-12 equals the plain path's on the same
           query embeddings, and its recall@12 against an exact fp32 top-12
           over the f32 corpus (kept on the card) is at least 0.99; and
           ``fused_query``'s stages for that batch (encode, scan: quantize,
           ``topk_int8`` at K = 64 and the rescore, gather + rerank).
4a. mesh   the ``parallel/`` slice on the card, on the slice's index
           before ``lifecycle`` changes it. Retrieval: the 1,048,576-row
           int8r index split over a mesh naming the card four times (four
           blocks of 262,144 rows, q1 and q2): ``sharded_topk_int8`` with
           and without the rescore against ``int8_topk`` at B = 32, K = 64;
           ``sharded_topk`` and the 2 x 2 ``sharded_topk_2d`` over bf16 and
           f32x2 copies of 262,144 rows against ``cosine_topk``;
           ``fused_query_mesh`` against ``fused_query`` for the 64 queries
           with the hybrid weights off and on (seeded sparse and ColBERT
           heads, removed after): all bit-equal. The index saved and loaded
           row-sharded, 64 concurrent asks through it (answers checked,
           ``topk_int8`` launched), recall@12 >= 0.99 against the fp32
           oracle. TP: TinyLlama-1.1B width at 8 layers over two entries:
           ``paged_attention_sharded`` bit-equal to the unsharded kernel's
           head slices (bf16 and int8 pools, B = 64); the f32 model (the
           bf16 weights cast up, ring route) 2-way TP within JAX's atol 2e-4
           + rtol 2e-4 of its unsharded forward over two 512-token prompts;
           for bf16 weights on a bf16 and an int8 pool and for w8a8 weights,
           the same prompts' logits against the unsharded forward (w8a8:
           bit-equal; bf16: the difference printed beside JAX's bounds, and
           the TP forward's relative RMS error against the f32 model within
           1.5 times the unsharded bf16 forward's) and 8 greedy streams of
           64 tokens through ``DecodeBatcher(mesh=...)``, equal to the
           unsharded batcher's (w8a8: all of them), or parting only where
           the f32 model's logits of the two chosen tokens lie within twice
           the unsharded bf16 forward's own error there; the paged kernels
           launched. Processes (``tools/dryrun_multichip.py`` rank groups, run
           during the TP checks): two ``gloo`` ranks of
           ``build_and_query_demo``, 262,144 rows each on the card, equal to
           one process's scan of the union bit for bit; the data-parallel
           contrastive step at bge-m3 width in two ``gloo`` ranks, loss within
           rtol 1e-5 of one device's step on the same batch, and the gradient
           it applied (AdamW's first moment) within 1e-5 relative L2 of one
           device's gradient; an ``nccl`` world of one. Times print as n shards on one card beside the unsharded
           call (the cost of the extra launches and the merge).
4b. lifecycle  continues on the slice's index, service and models. Delta
           updates: whole seeded sources re-added under the same chunk ids
           (``replace=True``, 4,096 rows each) until an add finds no free row
           and the index compacts at 1,048,576 (generation higher, cursor ==
           live rows). Growth: new sources until an add does not fit; the
           index grows to 2,097,152, and the peak of
           ``torch.cuda.max_memory_allocated`` over that add must stay below
           what was allocated before it plus the new index's bytes (the old
           planes are freed first). Snapshot: ``save`` to a temporary
           directory, ``VectorIndex.load``, ``adopt`` into the served index,
           files deleted. After each step a burst of 64 concurrent requests
           through the same service: answers checked against the deleted
           chunks, ``topk_int8`` launched, one batch's fused top-12 equal to
           the plain path's (values within 1e-6) with every row its chunk's
           current row, and recall@12 >= 0.99 against an fp32 oracle keyed by
           chunk id. Seconds of each step, live rows, capacity, generation,
           the snapshot's bytes, and the scan's ``scan_ms`` / ``kernel_ms`` at
           2,097,152 rows.
4c. http   a whole local RAG turn through the port's HTTP app over a
           socket, after ``lifecycle``, with the slice's bge-m3 encoder and
           cross-encoder: a fresh int8r index of capacity 1,048,576 x 1024
           (64-wide token cache) holding 996,352 seeded rows in documents of
           1,024 chunks, every row resolving to a chunk and a document in a
           sqlite meta store on disk (written through ``upsert_document`` /
           ``replace_chunks``); ``build_app`` with the JAX defaults
           (``TOP_K`` 12, ``RERANK_K`` 3, ``QUERY_BATCH_MAX`` 32,
           ``CHUNK_SIZE`` 1024) and ``LocalChatProvider`` at TinyLlama-1.1B
           width (bf16, 64 slots, 1,025 pages of 128, chunks of 16, 64 new
           tokens, ``ByteTokenizer``) behind a stand-in that classifies every
           ask as Query (a random-weight decoder writes no JSON; the stand-in
           is the one part that is not the port's code); ``serve()`` on
           127.0.0.1 on a thread with its own event loop. 24 documents of
           1,100-8,000 words come in through Outline sync (a stdlib fake wiki
           on 127.0.0.1 that also lists the seeded documents; ``POST
           /chat/update/all``, the task worker): their chunks are indexed and
           stored, and /healthz's ``index_size`` grows by exactly their count.
           Then 64 clients on threads (stdlib ``http.client``) each log in,
           open a conversation, ``POST /chat/api/ask`` at once and read the
           SSE stream to ``[DONE]``; half the questions come from the new
           documents. Every stream parses and has a content frame; each
           answer's sources equal the app's own ``RetrievalService`` called
           directly on the batches the batcher formed, mapped to documents as
           ``retrieve_docs`` maps them; ``topk_int8`` launched at least once a
           batch, ``paged_attention`` and ``paged_kv_write`` launched;
           ``/chat/api/metrics`` has the stage timings and the decoder's
           stats. Printed: time to the first content frame and to ``[DONE]``
           (p50 / p95), asks/s, streamed tokens/s, batches and their mean
           size, each kernel's launches, prefix hits, backpressure waits, the
           index and meta-store fill times, peak device memory, and the slice
           phase's in-process burst p50.
5. kernel_float  ``topk_float`` (the CUDA kernel) against
           ``topk_float_plain`` for each of its modes (fp32, bf16, f32x2),
           each over a seeded 1,048,576 x 1024 corpus of unit rows in that
           mode's storage (4 GiB, 2 GiB, 4 GiB; one at a time), 1% rows
           tombstoned and 12 copies of one row, at B in {1, 32, 128} and K
           in {12, 64}, plus a case with fewer live rows than K. Values
           within 1e-5 and rows equal wherever the twin's neighbouring
           values are further apart (the sums run in another order); the
           copies tie exactly and come lowest row first. Median of 10
           CUDA-event timings of both at B = 32 and 128, K = 64, TF32 off,
           and at B = 32 (fp32, bf16) of a library pair as a yardstick:
           ``q @ corpus.T + penalty`` then ``torch.topk`` (two calls, and no
           order among ties: not the same function).
           Then a 65,536-row ``VectorIndex`` of the dtype that scans in the
           mode (float32, bfloat16, f32x2) answers a query through the
           kernel.
6. flash   ``flash_attention`` (the CUDA kernel) against
           ``flash_attention_plain`` in bf16 at H = 16, D = 64: S in
           {2048, 4096, 8192} at B = 1, and a B = 2 batch at S = 4096
           holding a 3,000-token document and an all-padding row (exactly
           zero). Every element within 2e-3 + 2 bf16 ulps of the twin's
           (P is rounded against a running max over key tiles in the
           kernel, the row max in the twin) and the error's norm within
           1e-2 of the output's; a dropped key tile or a missing rescale
           fails both. Also S = 2048 + 37 (no multiple of a tile), a bias
           that is no prefix (live keys 0-999 and 3,000-3,499 of 4,096) and a
           B = 3 batch with a row of no live key; two runs of every case are
           bit-equal. Median of 5 timings of both at each S, B = 1, beside
           one ``scaled_dot_product_attention`` call. The f32 instantiation at
           S = 2048, B = 1 within 1e-5.
7. long    whole-document ingest and f32x2 serving at bge-m3 width. The
           seeded encoder embeds one 8,192-token document with the kernel
           and with the twin for attention (pooled-vector cosine >= 0.999:
           a check that the kernel runs inside the encoder, not a test of
           attention, since random weights pull whole-document embeddings
           together; the flash phase tests the kernel).
           ``ingest_long``: 24 documents, one per
           ``EncoderEmbedder(max_tokens=8192).embed`` call, 8 in each of the
           2048, 4096 and 8192 buckets, with lengths away from the bucket
           edges (fully padded key tiles occur); every layer of every
           forward goes through the flash kernel (24 x 24 launches). They,
           and seeded unit vectors up to 1,000,000 live rows, fill an f32x2
           ``VectorIndex`` of capacity 1,048,576 x 1024 (bf16 pairs, 4 GiB,
           64-wide token cache); one document is deleted. ``serve_f32x2``:
           64 concurrent requests through ``QueryBatcher(max_batch=32)``,
           each answered with 3 distinct live chunks, with ``topk_float``
           f32x2 launches on the way (counted over the measured burst,
           after a warm-up one); one batch's fused top-12 equals the plain
           path's (tie-aware, 1e-5) and has recall@12 >= 0.99 against an
           exact fp32 top-12, also when rows within 1e-5 of the exact 12th
           score count as ties (random weights put whole-document
           embeddings within ~1e-6 of one another); 32 seeded unit queries
           through ``VectorIndex.query`` have recall@12 >= 0.99. The batch's
           ``fused_query`` is then timed by stage (median of 5): the encoder,
           the scan, and the rest (token gather, cross-encoder, final sort).

8. kernel_paged  ``paged_attention`` (the CUDA kernel) against
           ``paged_attention_plain`` at TinyLlama-1.1B's shape (H 32, KvH 4,
           Dh 64, page 128, MAXP 16, a pool of 1,025 pages): B in {1, 8, 64}
           at T = 1 with seeded row lengths from 1 to 2,047, scattered page
           ids and inactive rows (table all 0), and T = 256 prefill chunks at
           B = 1 from ``pos`` 0 and 512; bf16 and int8 pools. bf16: every
           element within 2e-3 + 2 bf16 ulps of the twin's and the error's
           norm within 1e-2 of the output's (the kernel rounds p against a
           running max over key tiles, the twin against the row max). int8
           pool (f32 products): 1e-4 + 1 bf16 ulp of the bf16 output, error
           norm within 1e-3. Two runs on the same inputs are bit-equal, and
           positions at the kernel's 256-slot split boundaries (255, 256,
           257, 511, 512, 2,047) are bit-equal inside a 64-token chunk, alone
           and beside other rows. Timed (``ms``, ``device_ms``, bound) at
           the three shapes the decoder launches: B = 64, T = 1 (the twin
           too); B = 8, T = 4 (a speculative window); B = 1, T = 256 from 512.
9. kernel_kv_write  ``paged_kv_write`` (the JAX signature: entries already
           rotated and quantized) against ``paged_kv_write_plain``: every page
           but the scratch page 0 byte-equal, bf16 and int8, T = 1 at B = 64,
           a speculative window (B = 8, T = 4), T = 256 at B = 1 straddling
           pages, and a chunk whose tail passes the row's capacity (it must
           land in page 0). Then the decoder's entry, ``paged_kv_write_rope``
           (rotate q and k, quantize k and v for an int8 pool, write: one
           launch), against ``paged_kv_write_rope_plain`` at TinyLlama-1.1B's
           heads on the same four shapes, q, k and v as views of a fused qkv
           product or as tensors of their own: the rotated q bit-equal, every
           page but page 0 byte-equal, the scale bits equal (a v head with .5
           ties at scale 1 and one with a maximum of 3.25 in every case).
           Timed (``ms``, ``device_ms``, bound, the twin) at B = 64, T = 1 and
           at B = 1, T = 256.
10. kernel_int8_linear  ``int8_linear`` against ``int8_linear_plain`` at the
           decoder's projections, (M, K, N) = (64, 2048, 2560),
           (64, 2048, 2048), (64, 2048, 11264), (64, 5632, 2048),
           (64, 2048, 32000), at M = 8, and at the M = 256 of a prefill chunk
           on all five widths: bf16 outputs within 1e-5 of the output's scale
           + 1 bf16 ulp (exact products in both, f32 sums in another order);
           at M = 256 the first 8 rows alone are bit-equal to the same rows of
           the whole. Times, the weight bytes a second, and one ``F.linear``
           on a weight dequantized beforehand (it reads twice the bytes) as
           the library yardstick; both summed over a decode step's 89
           projections (22 each of q/k/v, o, gate/up and down, and the
           ``lm_head``) at M = 64 and over a prefill chunk's at M = 256.
11. decoder  the local chat decoder at TinyLlama-1.1B width (22 layers, 32
           heads, 4 KV heads, vocab 32,000; seeded random bf16 weights)
           served by ``LocalChatProvider(batch_slots=64, kv_pages=1025,
           page_size=128, chunk_tokens=16, max_new_tokens=64)`` with the
           ``ByteTokenizer``: 64 concurrent chats through ``provider.stream``
           (asyncio), 48 of 600-1,500 tokens sharing a 512-token system
           prefix and 16 of 200-500 tokens without it, every third one
           sampled (temperature 0.8, top_p 0.9), the rest greedy. Every
           stream ends and yields text; ``paged_attention`` and the page
           write (``paged_kv_write_rope``, counted in
           ``paged_kv_write.launches``) launch 22 times a forward; prefix
           hits > 0; a
           repeat of one greedy chat after the burst (warm prefix pages, other
           neighbours) equals its first answer, and a prompt submitted twice
           to the batcher gives the same tokens cold and warm; every page
           returns to the free list or the prefix cache. One prefill and one
           decode forward with the kernels against the same forwards with
           the page write's twin alone patched in (``paged_kv_write_rope_plain``:
           the logits bit-equal, on the bf16 and the int8 pool) and with
           every plain twin patched in: the error's norm within 3e-2 of the
           logits' (22 bf16 layers). The burst's wall time, tokens a second
           and time to first token come from that burst as served; a second
           burst of new chats, read for nothing end to end, has the worker's
           step and prefill programs wrapped in synchronized timers for the
           ms a step and the prefill tokens a second. ``decode_profile``: decode steps with all
           64 rows live at lengths of 256-1,900 through ``generate_chunk``:
           ms a step, and under ``torch.profiler`` the device's busy share
           and its top kernels. Then the same with ``kv_int8=True``, and
           a shorter burst (16 chats, 32 new tokens) with ``int8_weights=True``
           in ``DECODER_INT8_MODE=kernel`` (``int8_linear`` launches
           4 x 22 + 1 times a forward). Then four more configurations:
           ``int4_weights`` (``int4_weights=True``, ``DECODER_INT4_MODE=w4a8``,
           32 slots so that a decode step has 32 rows and takes the kernel
           under the JAX package's rule, 32 chats of the same mix, 64 new
           tokens: ``w4a8_matmul`` and ``quantize_rows`` each launch
           4 x 22 + 1 times a decode forward (a projection is two launches)
           and never in a prefill chunk; the logits of one 32-row step with
           the int4 kernels equal to the same step with their twins bit for
           bit, and with every twin within 5e-2 of the logits' norm: both
           sides quantize the activations alike, and a flipped int8 rounding
           carries the paged kernel's bf16 noise); ``int4_kernel`` (the first 8
           of those chats in mode ``kernel``: ``w4a16_matmul`` counted alike,
           one launch a projection, its epilogue writing bf16,
           its logits within 3e-2 of its twin's like the other bf16 kernels');
           ``spec`` (bf16 weights, ``spec_k=3``, 8 slots, 8 chats, 64 new
           tokens: ``paged_attention`` and ``paged_kv_write`` run on windows of
           T = 4, ``spec_tokens_per_step >= 1``; printed without a gate: the
           share of greedy chats whose text equals the ``spec_k=0`` run's,
           since the dense products may take another algorithm at 32 rows
           than at 8, and one ``force_accept=True`` chunk as the all-accepted
           ceiling) and ``spec_int4`` (the same with int4 weights: the 8 x 4
           window rows take the w4a8 kernel).
12. kernel_int4  ``quantize_rows`` (the row quantizer of w4a8) against its
           twin, codes and scale bits byte-equal, for bf16 and f32 rows at
           every M and K below, with a row of zeros, a row whose maximum is
           negative and values at exact .5 ties. ``w4a8_matmul`` and
           ``w4a16_matmul`` (bf16 and f32) against
           their twins at TinyLlama's five (K, N), at (4096, 22016) and
           (11008, 4096), groups of 128, and at (2048, 2560) with groups of
           256 and 512; M in {1, 8, 32, 64, 256}: w4a8 bit-equal (exact
           integer group sums, one f32 order), also through its bf16 epilogue;
           w4a16 within 1e-5 of the output's scale + 1e-5 relative (the same
           decoded weights; f32 sums in another order), its bf16 epilogue
           the f32 result rounded once; two runs bit-equal, a
           row at M = 1 bit-equal to the same row inside M = 32. Times at
           M = 32 through the calls the decoder makes (bf16 out), each read
           twice: ``ms``, one launch through the wrapper
           between two events (the host's time to launch a kernel this
           short), and ``device_ms``, events around 100 back-to-back launches
           or a CUDA-graph replay of them, each launch on the next of a ring
           of weights that spans three times the L2 cache; ``F.linear`` on a
           weight dequantized to bf16 beforehand (four times the bytes) as
           the library yardstick, read the same two ways, and the grouped
           product of ``_mm_int4`` at M = 32, 64 and 128 beside them.
13. kernel_int4_floor  ``int4_stream_floor`` against its twin (exact), then
           the package's ``tools/bench_int4_kernel.py`` at those shapes:
           floor / w4a16 / w4a8 / int8 side by side at M = 32.
14. kernel_topk_floor  inside phase 5, on each mode's corpus: ``topk_floor``
           against its twin (1e-5), ``nomerge`` bit-equal to the first column
           of ``topk_float``'s values, then the package's
           ``tools/bench_topk_kernel.py``: full / nomerge / matmul at B = 32.
15. hybrid  BGE-m3's lexical and ColBERT terms at bge-m3 width: a seeded
           bge-m3 encoder with the sparse and ColBERT (1024 -> 1024) heads, an
           int8r index of capacity 131,072 with a 64-wide token cache and
           rank-128 ColBERT codes (the JAX package's defaults once
           COLBERT_WEIGHT > 0); 4,096 text chunks through ``embed``,
           ``token_weights`` and ``colbert_cache``, seeded rows up to 120,000
           live. 64 concurrent requests through ``RetrievalService(lex_weight=
           0.3, colbert_weight=0.2)`` and ``QueryBatcher``: valid answers and
           ``topk_int8`` launches; for one batch the cached form's retrieval
           rows and values equal a plain composition (``topk_int8_plain``,
           ``rescore_candidates``, ``lexical_overlap_scores``,
           ``late_interaction_scores``) within 1e-5, both terms non-zero for
           most live candidates, and the rerank top-3 equal. ``fused_query``
           timed with the terms off, cached and recomputed, and by stage.

16. entry   ``python -m outline_rag_tpu_torch`` in a subprocess with
           ``SECRET_KEY``, a temporary ``DATA_DIR`` and a free ``PORT``, all
           else the defaults (hash embedder, int8r index on the card,
           ``FakeChatProvider``): /healthz answers 200, a dev-login ask
           streams to ``[DONE]``, SIGTERM ends it with exit 0 within the
           drain timeout; then ``python -m outline_rag_tpu_torch status``
           prints dtype ``int8r``.
17. checkpoint  real HF checkpoint layouts at their published widths, with
           seeded weights, synthesized on the card with ``transformers`` into a
           temporary folder (~6.7 GB; deleted at the end): BGE-m3
           (``XLMRobertaModel``, vocab 250,002, 24 layers of 1,024, f32
           ``pytorch_model.bin`` with ``sparse_linear.pt`` and
           ``colbert_linear.pt``), bge-reranker-v2-m3 (the same trunk with a
           one-label classifier, f32 ``model.safetensors``) and
           TinyLlama-1.1B-Chat (bf16, two safetensors shards and their index,
           its chat template), each with a word-level fast tokenizer of the full
           vocabulary in XLM-R's or Llama's special-token layout. The port's
           ``load_pretrained`` / ``load_pretrained_decoder`` load them (seconds
           each); in bf16 they are held to the HF models (f32, eager attention)
           on the same token batches: CLS cosine > 0.999, the sparse head within
           1e-2 (relative error norm) and ColBERT vectors at cosine > 0.999 of
           ``nn.Linear`` on HF's hidden states, decoder logits at cosine >
           0.999 per position; the cross-encoder's scores of 64 pairs correlated
           > 0.999 when the port loads it in f32, and in bf16 an error norm at
           most twice that of the HF model itself run in bf16 (seeded weights
           spread the scores about as far as bf16 rounding moves them).
           The ``http`` phase's seeded 996,352-row int8r index is written as the
           snapshot the entry point adopts, with its meta store; then, in
           process, ``ENCODER_INT8``'s A/B on that index with 4,096 text chunks
           added: ``fused_query`` by stage at B = 32 with the float and the int8
           trunks in turns, the top-3 agreement of the two over 64 asks, peak
           memory; and the QKV fusion at the encoder forward's query (32 x 64),
           rerank (384 x 128) and ingest (64 x 256) shapes. Last, ``python -m
           outline_rag_tpu_torch``'s module run in a subprocess with the three
           ``*_WEIGHTS_PATH`` and the decoder cell's ``DECODER_*`` settings (64
           slots, 1,025 pages of 128, 64 new tokens), behind the ``http``
           phase's classifier stand-in: boot to /healthz (the three loads and
           the snapshot's adoption), the 24-document Outline sync, 32 asks at
           once over the socket (every answer has sources, every ask drawn from
           a new document cites one; ``topk_int8``, ``paged_attention`` and
           ``paged_kv_write`` launched), SIGTERM to exit 0.
18. train   fine-tuning through ``models/train.py`` at the published widths
           and depths in f32, seeded weights, 4 AdamW steps each on one seeded
           batch: the contrastive step on bge-m3 (16 pairs, queries of up to
           64 tokens, passages of up to 512, lr 1e-5, ``remat=True``; step 1's
           loss and gradient norm also without remat, equal within 1e-5
           relative), the cross-encoder step on bge-reranker-v2-m3 (8 queries
           x groups of 8 pairs of up to 256 tokens, lr 1e-5) and the causal-LM
           step on TinyLlama-1.1B, fused (4 sequences of 512 tokens, lr 3e-4).
           Every loss finite and the last below the first; every gradient
           finite and the attention projections' not all zero; no flash
           launch (every sequence is under 2,048 tokens, and the flash route
           refuses autograd: a forward through ``attn_impl="flash"`` under
           grad must raise, and runs through the kernel under ``no_grad``);
           TF32 off. At tiny width a step of each on the card is held to the
           CPU's (``testing.card_step_errors``: loss within 1e-5 relative,
           gradients as close to a float64 run as the CPU's, the update from
           the same gradients within 1e-6). Printed: ms a step (CUDA
           events, median of steps 2-4), tokens a second, peak memory, with
           remat and without for the two encoders, and the model FLOPs a
           step (6 x non-embedding parameters x tokens, plus attention) with
           their share of the card's f32 peak.
19. hostmem the int8r host-residual tier at the JAX package's 10M-row rung
           and bge-m3's width: 10,000,000 seeded unit rows of 1,024, drawn on
           the card in 40 segments of 250,000 (a generator each, so the oracle
           draws them again) and quantized to int8r. q1, the scales and a 1%
           tombstone penalty stay on the card (10 GB); q2 goes (a) into a
           second 10 GB tensor on the card and (b) through
           ``make_host_append`` (the ``host_scatter_rows`` kernel) into a
           10 GB page-locked plane made by ``to_pinned_host``, which must be
           byte-equal to (a). MemTotal of the host is printed. At B = 32 and
           128, K = 12, ``rescore_m`` = 64: ``int8_topk`` with the pinned q2
           (its rows gathered by ``host_gather_rows``) bit-equal to
           ``int8_topk`` with the q2 on the card; the host tier
           (``int8_topk_candidates`` on the card, ``host_residual_topk`` on
           the pinned plane's numpy view) within 1e-6 and on the same rows
           wherever no neighbour is as close; recall@12 >= 0.99 against an
           exact fp32 top-12 (each segment drawn again, TF32 off, merged
           stably). Each kernel byte-equal to its twin, with indices out of
           range (a zero row; a dropped write). Times: the PCIe rates of a
           256 MiB pinned ``copy_`` each way, the gather at B = 32, M = 64
           (2 MiB) against its bound (those bytes over PCIe Gen5 x16, 64 GB/s;
           also over the copy's H2D rate), its
           twin and ``plane[idx.cpu()].to(card)``, over a ring of index sets
           (128 MiB of rows, past the L2); the gather on a 1,250,000-row
           prefix of the plane and on all of it at the same bytes (the
           plane-size ratio); the append of a 250,000-row segment and of
           4,096 rows; queries a second at B = 32 with q2 on the card, q2
           pinned and the host tier.

The last lines are the kernel summary (each kernel's time beside its bound:
the larger of its bytes over 3.35 TB/s and its operations over the card's
peak for their type), the card's name and power limit as ``nvidia-smi``
prints them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import statistics
import sys
import time

N_ROWS, DIM, CAPACITY = 1_048_576, 1024, 1_048_576
LIVE_ROWS, TEXT_CHUNKS, BLOCK = 1_000_000, 4096, 4096
TOKEN_WIDTH, TOP_K, RERANK_K, CANDIDATES = 64, 12, 3, 64
REQUESTS, MAX_BATCH = 64, 32
# lifecycle: oracle slots for the chunks added past the slice's rows
LIFE_EXTRA_SLOTS = 16 * 4096
# hybrid: the JAX package's default capacity (1 << 17), its ColBERT rank once
# COLBERT_WEIGHT > 0, the live rows, the weights of tests/test_mesh_serving.py
HYB_CAPACITY, HYB_RANK, HYB_LIVE = 1 << 17, 128, 120_000
HYB_LEX, HYB_COLBERT, HYB_TOL, HYB_VOCAB = 0.3, 0.2, 1e-5, 64
VALUE_TOL, RECALL_MIN = 1e-6, 0.99
FLOAT_TOL = 1e-5  # float scan: sums in another order than the twin's
N_DUPS = 12
FLASH_HEADS, COSINE_MIN = 16, 0.999
# flash kernel vs twin, per dtype: (atol, bf16 ulps, error norm / output norm)
FLASH_BOUNDS = {"bf16": (2e-3, 2.0, 1e-2), "f32": (1e-5, 0.0, 1e-5)}
LONG_DOCS_PER_BUCKET, LONG_MAX_TOKENS = 8, 8192
# the card's published peaks (NVIDIA H100 SXM, dense): bytes/s, and ops/s by type
HBM_RATE = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# TinyLlama-1.1B's attention shape and the pool the decoder phase serves from
DEC_HEADS, DEC_KV_HEADS, DEC_HD, PAGE, MAXP, KV_PAGES = 32, 4, 64, 128, 16, 1025
DEC_SLOTS, DEC_CHUNK, DEC_NEW = 64, 16, 64
# paged attention vs twin, per pool: (atol, bf16 ulps, error norm / output norm)
PAGED_BOUNDS = {"bf16": (2e-3, 2.0, 1e-2), "int8": (1e-4, 1.0, 1e-3)}
LOGITS_REL_RMS = 3e-2  # one forward, kernels vs twins, 22 bf16 layers
# the same with int4 weights: w4a8 rounds the activations to int8 on both
# sides, and a rounding flipped by the paged kernel's bf16 noise moves a logit
# by a quantization step
INT4_LOGITS_REL_RMS = 5e-2


def bound(bytes_moved: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    by_bytes, by_ops = 1e3 * bytes_moved / HBM_RATE, 1e3 * ops / PEAK[kind]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, runs: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings,
    after one warm-up call (the package's timer, shared with its tools)."""
    from outline_rag_tpu_torch.tools.timing import cuda_ms as timed

    return timed(fn, runs)


def cuda_ms_many(torch, fn, launches: int = 100, runs: int = 5) -> dict:
    """Milliseconds a call on the device for kernels of a few microseconds,
    where one launch between two events reads the host: events around
    ``launches`` back-to-back calls (``queued_ms``) and around a CUDA-graph
    replay of the same run (``graph_ms``), median of ``runs``;
    ``device_ms`` is the smaller (the package's timer, shared with its
    tools)."""
    from outline_rag_tpu_torch.tools.timing import cuda_ms_many as timed

    return timed(fn, launches, runs)


def both_ms(torch, fn, many=None, runs: int = 10) -> dict:
    """``ms``: one launch through the wrapper between two events, what an
    eager caller pays; ``device_ms`` and its two readings: many launches
    (``many``, by default ``fn`` itself; a caller passes one that walks a
    ring of cold operands)."""
    readings = cuda_ms_many(torch, many or fn)
    return {"ms": cuda_ms(torch, fn, runs), "device_ms": readings["device_ms"],
            "queued_ms": readings["queued_ms"], "graph_ms": readings["graph_ms"]}


def kernel_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.topk import NEG, topk_int8, topk_int8_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randint(-127, 128, (N_ROWS, DIM), generator=g, device=dev, dtype=torch.int8)
    cscale = (torch.rand(N_ROWS, generator=g, device=dev) + 0.5) / 127
    penalty = torch.where(torch.rand(N_ROWS, generator=g, device=dev) < 0.01, NEG, 0.0).float()
    # 12 copies of one row: query 0 is that row, so 13 rows tie at its top
    src = int(torch.randint(0, N_ROWS, (1,), generator=g, device=dev))
    dups = torch.randperm(N_ROWS, generator=g, device=dev)[:12]
    dups = dups[dups != src]
    corpus[dups] = corpus[src].clone()
    cscale[dups] = cscale[src].clone()
    penalty[dups] = 0.0
    penalty[src] = 0.0
    tied = sorted({src, *dups.tolist()})
    few_live = torch.full((N_ROWS,), NEG, device=dev)
    few_live[torch.randperm(N_ROWS, generator=g, device=dev)[:10]] = 0.0

    cases = [(b, k, penalty) for b in (1, 32, 128) for k in (12, 64)]
    cases.append((32, 64, few_live))
    results, max_err = [], 0.0
    for b, k, pen in cases:
        q = torch.randint(-127, 128, (b, DIM), generator=g, device=dev, dtype=torch.int8)
        q[0] = corpus[src].clone()
        qscale = (torch.rand(b, generator=g, device=dev) + 0.5) / 127
        args = (q, qscale, corpus, cscale, k, pen)
        vals, idx = topk_int8(*args)
        torch.cuda.synchronize()
        pv, pi = topk_int8_plain(*args)
        err = float((vals - pv).abs().max())
        max_err = max(max_err, err)
        row = {
            "B": b, "K": k, "live": int((pen == 0).sum()),
            "idx_equal": bool(torch.equal(idx, pi)),
            "bit_equal": bool(torch.equal(vals, pv) and torch.equal(idx, pi)), "max_abs_err": err,
        }
        require(row["bit_equal"], f"kernel values and indices bit-equal to the plain version's at {row}")
        if pen is penalty:
            head = min(k, len(tied))
            require(idx[0, :head].tolist() == tied[:head], "tied rows come lowest first")
        else:
            require(bool((idx[:, 10:] == 0).all() and (vals[:, 10:] == NEG).all()),
                    "slots past the 10 live rows are (NEG, 0)")
        if b == 32 and k == 12 and pen is penalty:
            row["ms"] = cuda_ms(torch, lambda: topk_int8(*args))
        if k == 64 and b in (32, 128) and pen is penalty:
            # ms: one launch through the wrapper; device_ms: many back to back
            row.update(both_ms(torch, lambda: topk_int8(*args)))
            row["plain_ms"] = cuda_ms(torch, lambda: topk_int8_plain(*args))
            if b == 32:
                row.update(int8_library_pair(torch, *args))
        results.append(row)
        emit("kernel", **row)
    timed = {(r["B"], r["K"]): r for r in results if "ms" in r}
    # the corpus, its scales and the penalty read once; the queries, their
    # scales and the lists; 2*B*N*D int8 ops
    def moved(b):
        return N_ROWS * (DIM + 8) + b * (DIM + 4) + b * 64 * 8
    return {"max_abs_err": max_err, "ms": timed[32, 64]["ms"], "plain_ms": timed[32, 64]["plain_ms"],
            "device_ms": timed[32, 64]["device_ms"], "ms_b128": timed[128, 64]["ms"],
            "device_ms_b128": timed[128, 64]["device_ms"],
            "plain_ms_b128": timed[128, 64]["plain_ms"],
            "ms_k12": timed[32, 12]["ms"], "library_pair_ms": timed[32, 64]["library_pair_ms"],
            **({"library_error": timed[32, 64]["library_error"]}
               if "library_error" in timed[32, 64] else {}),
            **bound(moved(32), 2 * 32 * N_ROWS * DIM, "int8"),
            **{key + "_b128": value
               for key, value in bound(moved(128), 2 * 128 * N_ROWS * DIM, "int8").items()}}


def int8_library_pair(torch, q, qscale, corpus, cscale, k, penalty) -> dict:
    """The int8 scan's yardstick of two library calls: ``torch._int_mm`` of
    the codes against the corpus's transpose (int32), then the scales and
    the penalty in the Pallas order and ``torch.topk`` (which keeps no order
    among ties). ``library_pair_ms`` is None and ``library_error`` says why
    where ``_int_mm`` refuses the layout or the shape."""
    def pair():
        raw = torch._int_mm(q, corpus.T)
        return torch.topk(raw.float() * cscale * qscale[:, None] + penalty, k, dim=1)

    try:
        pair()
    except RuntimeError as err:
        return {"library_pair_ms": None, "library_error": str(err).splitlines()[0][:300]}
    return {"library_pair_ms": cuda_ms(torch, pair)}


def serve_burst(service, queries: list[str]):
    """All ``queries`` at once through a ``QueryBatcher(max_batch=32)`` over
    ``service.retrieve_batch``: ([(answer, seconds)], wall seconds)."""
    from outline_rag_tpu_torch.engine import QueryBatcher

    async def serve():
        batcher = QueryBatcher(service.retrieve_batch, max_batch=MAX_BATCH)

        async def one(q):
            t = time.perf_counter()
            res = await batcher.retrieve(q)
            return res, time.perf_counter() - t

        try:
            t = time.perf_counter()
            out = await asyncio.gather(*(one(q) for q in queries))
            return out, time.perf_counter() - t
        finally:
            await batcher.stop()

    return asyncio.run(serve())


def check_answers(np, answers, deleted: set[str]) -> None:
    for res, _ in answers:
        ids = [c.chunk_id for c in res]
        require(len(ids) == RERANK_K, f"{RERANK_K} chunks per answer, got {ids}")
        require(len(set(ids)) == len(ids), f"no duplicate ids in {ids}")
        require(not deleted & set(ids), f"no deleted ids in {ids}")
        require(all(np.isfinite([c.score, c.rerank_score]).all() for c in res), "finite scores")


def latency_fields(answers, wall_s: float) -> dict:
    lat = sorted(t for _, t in answers)
    return {"requests": len(lat), "max_batch": MAX_BATCH, "p50_ms": 1e3 * lat[len(lat) // 2],
            "p95_ms": 1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "answers_per_s": len(lat) / wall_s, "wall_s": wall_s}


def make_texts(rng, n: int, vocab: list[str]) -> list[str]:
    return [" ".join(rng.choice(vocab, size=int(rng.integers(20, 60)))) for _ in range(n)]


def random_chunks(torch, n: int, gen, dev, tok, vocab_size: int):
    """n seeded chunks: Gaussian vectors, and token rows of 8-64 random ids
    (CLS first, padded)."""
    v = torch.randn((n, DIM), generator=gen, device=dev)
    lengths = torch.randint(8, TOKEN_WIDTH + 1, (n, 1), generator=gen, device=dev)
    mask = (torch.arange(TOKEN_WIDTH, device=dev)[None, :] < lengths).to(torch.int32)
    ids = torch.randint(3, vocab_size, (n, TOKEN_WIDTH), generator=gen, device=dev,
                        dtype=torch.int32)
    ids = torch.where(mask.bool(), ids, tok.pad_id)
    ids[:, 0] = tok.cls_id
    return v, ids, mask


def slice_phase(torch, dev, seed: int) -> tuple[int, dict]:
    """Returns the kernel's launch count over the burst, and what the
    ``lifecycle`` phase continues on: the index, its service, the models,
    the oracle rows and the requests."""
    import numpy as np

    from outline_rag_tpu_torch.engine import (
        CrossEncoderReranker,
        EncoderEmbedder,
        RetrievalService,
        fused_query,
    )
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.index.store import normalize_rows
    from outline_rag_tpu_torch.models import (
        EncoderConfig,
        init_encoder,
        init_reranker,
        pooled_embeddings,
    )
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8, rescore_candidates
    from outline_rag_tpu_torch.ops.topk import topk_int8, topk_int8_plain, topk_plain

    t0 = time.perf_counter()
    cfg = EncoderConfig.bge_m3()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    encoder = init_encoder(cfg, gen, dev)
    reranker = init_reranker(cfg, gen, dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    embedder = EncoderEmbedder(encoder, tok)
    cross = CrossEncoderReranker(reranker, tok)
    index = VectorIndex(
        dim=DIM, capacity=CAPACITY, dtype="int8r", device=dev, token_width=TOKEN_WIDTH
    )
    oracle = torch.zeros((CAPACITY, DIM), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ingest 1: text chunks through the port's encoder, 64 per source
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:5000]]
    texts = make_texts(rng, TEXT_CHUNKS, vocab)
    t0 = time.perf_counter()
    vecs = embedder.embed(texts)
    embed_s = time.perf_counter() - t0
    require(vecs.shape == (TEXT_CHUNKS, DIM) and bool(np.isfinite(vecs).all()), "finite embeddings")
    t0 = time.perf_counter()
    for s in range(0, TEXT_CHUNKS, 64):
        tb = tok.batch(texts[s : s + 64], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
        rows = index.add_chunks(
            [f"text{s // 64}:{i}" for i in range(64)], vecs[s : s + 64], f"text{s // 64}",
            token_ids=tb.input_ids, token_mask=tb.attention_mask,
        )
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(
            torch.as_tensor(vecs[s : s + 64], device=dev)
        )
    # ingest 2: seeded unit vectors with random token rows, in blocks
    n_src = 0
    while index.size < LIVE_ROWS:
        n = min(BLOCK, LIVE_ROWS - index.size)
        v, ids, mask = random_chunks(torch, n, gen, dev, tok, cfg.vocab_size)
        rows = index.add_chunks(
            [f"rand{n_src}:{i}" for i in range(n)], v, f"rand{n_src}",
            token_ids=ids, token_mask=mask,
        )
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(v)
        n_src += 1
    deleted_text = index.delete_source("text7")
    gone = n_src // 2  # a full block from the middle of the index
    deleted_rand = index.delete_source(f"rand{gone}")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    require(deleted_text == 64 and deleted_rand == BLOCK, "delete_source removed whole sources")
    require(index.size == LIVE_ROWS - 64 - BLOCK, f"live rows {index.size}")
    emit("ingest", setup_s=setup_s, embed_s=embed_s, ingest_s=ingest_s, live_rows=index.size,
         capacity=CAPACITY, text_chunks=TEXT_CHUNKS, sources=n_src + TEXT_CHUNKS // 64,
         device_mem_gb=torch.cuda.memory_allocated(dev) / 1e9)

    # requests: phrases cut from text chunks (the deleted source's too)
    picks = rng.integers(0, TEXT_CHUNKS, REQUESTS)
    queries = [" ".join(texts[j].split()[3:15]) for j in picks]
    service = RetrievalService(index, embedder, cross, top_k=TOP_K, rerank_k=RERANK_K)
    require(service.fused, "the service runs the fused path")

    serve_burst(service, queries[:MAX_BATCH])  # warm-up: cuBLAS handles, allocator
    topk_int8.launches = 0
    answers, wall_s = serve_burst(service, queries)
    launches = topk_int8.launches
    require(launches > 0, "the main path launched the topk_int8 kernel")
    deleted = {f"text7:{i}" for i in range(64)} | {f"rand{gone}:{i}" for i in range(BLOCK)}
    check_answers(np, answers, deleted)
    served = latency_fields(answers, wall_s)
    emit("serve", **served, topk_int8_launches=launches)

    # the retrieval stage of one batch, against the plain path and fp32
    tb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode():
        state, _ = index.snapshot()
        tokens = index.tokens.state
        _, _, _, idx, vals = fused_query(
            encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
            tokens.ids, tokens.mask, state.residual, top_k=TOP_K, rerank_k=RERANK_K,
        )
        q_emb = pooled_embeddings(encoder, q_ids, q_mask)
        qq, qs = quantize_rows_int8(q_emb)
        cand = topk_int8_plain(qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty)
        pv, pi = rescore_candidates(
            q_emb, *cand, state.vectors, state.scales, TOP_K, state.penalty, state.residual
        )
        # exact fp32 top-13: the top-12 and how far the 13th trails it
        ov, oi = topk_plain(q_emb, oracle, TOP_K + 1, state.penalty)
        # fused_query's stages for this batch, median of 5 each: the encoder,
        # the scan (quantize, the kernel at K = 64, the rescore), the kernel
        # alone, and the whole call (the rest is the token gather, the
        # cross-encoder and the final sort)
        stages = {
            "encode_ms": cuda_ms(torch, lambda: pooled_embeddings(encoder, q_ids, q_mask), runs=5),
            "scan_ms": cuda_ms(torch, lambda: int8_topk(
                *quantize_rows_int8(q_emb), state.vectors, state.scales, TOP_K, state.penalty,
                rescore_queries=q_emb, rescore_residual=state.residual), runs=5),
            "kernel_ms": cuda_ms(torch, lambda: topk_int8(
                qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty), runs=5),
            "fused_ms": cuda_ms(torch, lambda: fused_query(
                encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                tokens.ids, tokens.mask, state.residual, top_k=TOP_K, rerank_k=RERANK_K), runs=5),
        }
        stages["gather_rerank_ms"] = stages["fused_ms"] - stages["encode_ms"] - stages["scan_ms"]
    require(torch.equal(idx, pi), "fused top-12 equals the plain path's")
    err = float((vals - pv).abs().max())
    require(err <= VALUE_TOL, f"fused top-12 values within {VALUE_TOL} of the plain path's")
    hits = [len(set(a) & set(b[:TOP_K])) for a, b in zip(idx.tolist(), oi.tolist())]
    recall = sum(hits) / (TOP_K * len(hits))
    emit("retrieval", batch=len(hits), recall_at_12=recall, max_abs_err_vs_plain=err,
         min_oracle_gap_12_13=float((ov[:, TOP_K - 1] - ov[:, TOP_K]).min()),
         min_oracle_gap_1_12=float((ov[:, :TOP_K - 1] - ov[:, 1:TOP_K]).min()), stages=stages)
    require(recall >= RECALL_MIN, f"recall@12 {recall} >= {RECALL_MIN}")
    handover = dict(index=index, service=service, encoder=encoder, reranker=reranker, tok=tok,
                    oracle=oracle, queries=queries, deleted=deleted, n_src=n_src, gone=gone,
                    serve_p50_ms=served["p50_ms"])
    return launches, handover


class ChunkOracle:
    """Exact fp32 copies of the index's vectors keyed by chunk id, so the
    recall check follows chunks through re-adds, compaction, growth and a
    snapshot whatever rows they land on. ``vec`` [slots, DIM] unit rows,
    ``pen`` [slots] 0 for a live chunk and NEG for a dead slot, ``ids``
    the chunk id of each slot."""

    def __init__(self, torch, rows, index, slots: int):
        import numpy as np

        from outline_rag_tpu_torch.ops.topk import NEG

        dev = rows.device
        n = rows.shape[0]
        self.vec = torch.zeros((slots, DIM), dtype=torch.float32, device=dev)
        self.vec[:n] = rows  # the slice phase's oracle, indexed by its rows
        self.pen = torch.full((slots,), NEG, dtype=torch.float32, device=dev)
        self.ids = np.full(slots, "", dtype=object)
        self.slot = {}
        for cid, row in index._by_chunk.items():
            self.slot[cid] = row
            self.ids[row] = cid
        live = torch.as_tensor(list(self.slot.values()), device=dev)
        self.pen[live] = 0.0
        self.used = n

    def put(self, torch, cids: list[str], unit):
        """Chunks ``cids`` now have the unit vectors ``unit`` [n, DIM]."""
        at = []
        for cid in cids:
            if cid not in self.slot:
                self.slot[cid] = self.used
                self.ids[self.used] = cid
                self.used += 1
            at.append(self.slot[cid])
        at = torch.as_tensor(at, device=self.vec.device)
        self.vec[at] = unit
        self.pen[at] = 0.0

    def top_ids(self, torch, q_emb, k: int) -> list[list[str]]:
        from outline_rag_tpu_torch.ops.topk import topk_plain

        _, slots = topk_plain(q_emb, self.vec[: self.used], k, self.pen[: self.used])
        return [[self.ids[j] for j in row] for row in slots.tolist()]


def lifecycle_phase(torch, dev, seed: int, handover: dict) -> dict:
    """The slice phase's 1,048,576-row int8r index through delta updates
    until it compacts at its capacity, a growth to 2,097,152 rows and a
    snapshot round trip (save, load, adopt), each step followed by a burst
    through the same service and the checks of ``lifecycle_checks``."""
    import shutil
    import tempfile

    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.index.store import normalize_rows

    t_phase = time.perf_counter()
    index, service, tok = handover["index"], handover["service"], handover["tok"]
    oracle = ChunkOracle(torch, handover["oracle"], index, CAPACITY + LIFE_EXTRA_SLOTS)
    del handover["oracle"]
    deleted = handover["deleted"]
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    vocab_size = handover["encoder"].cfg.vocab_size
    from outline_rag_tpu_torch.tools.timing import card

    smi = card()
    out = {"card": smi, "launches": {}}

    def add(source: str, n: int) -> float:
        v, ids, mask = random_chunks(torch, n, gen, dev, tok, vocab_size)
        cids = [f"{source}:{i}" for i in range(n)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        index.add_chunks(cids, v, source, token_ids=ids, token_mask=mask)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        oracle.put(torch, cids, normalize_rows(v))
        return seconds

    def step(name: str, **fields):
        checks = lifecycle_checks(torch, dev, handover, oracle, deleted)
        out["launches"][name] = checks.pop("topk_int8_launches")
        out[name] = {**fields, **checks, "live_rows": index.size, "capacity": index.capacity,
                     "generation": index.generation, "card": smi}
        emit("lifecycle", step=name, **out[name], topk_int8_launches=out["launches"][name])

    # 1. delta updates: whole rand sources re-added under the same ids
    # (replace=True) until an add finds no free row and compacts
    cap0, gen0 = index.capacity, index.generation
    rounds, add_s = 0, []
    while True:
        src = rounds if rounds < handover["gone"] else rounds + 1  # the deleted one stays so
        free_before = index._shard.free
        add_s.append(add(f"rand{src}", BLOCK))
        rounds += 1
        if free_before < BLOCK:
            break
        require(rounds <= 16, "delta updates reach a compaction within 16 rounds")
    require(index.capacity == cap0, "the churn compacted at the same capacity")
    require(index.generation > gen0, "the generation moved on")
    require(index._shard.cursor == index.size, "no tombstone left after compaction")
    step("compaction", rounds=rounds, compaction_s=add_s[-1],
         delta_add_s_median=statistics.median(add_s[:-1]))

    # 2. growth: new sources until an add does not fit
    grow_adds = 0
    while index._shard.free >= BLOCK:
        add(f"grow{grow_adds}", BLOCK)
        grow_adds += 1
    old_bytes = index._index_bytes(index.capacity)
    new_bytes = index._index_bytes(2 * index.capacity)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    growth_s = add(f"grow{grow_adds}", BLOCK)
    peak = torch.cuda.max_memory_allocated(dev)
    require(index.capacity == 2 * cap0, f"grew to {2 * cap0} rows, not {index.capacity}")
    require(peak < before + new_bytes,
            f"growth peak {peak} below allocated-before {before} + new index {new_bytes}")
    step("growth", adds_before=grow_adds, growth_s=growth_s, allocated_before_bytes=before,
         peak_allocated_bytes=peak, reserved_bytes=torch.cuda.memory_reserved(dev),
         old_index_bytes=old_bytes, new_index_bytes=new_bytes,
         stages_at_2m=scan_stages(torch, dev, handover))
    out["growth"]["peak_minus_before_bytes"] = peak - before

    # 3. snapshot round trip into the served index
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snapshot_")
    try:
        path = os.path.join(tmp, "index")
        t = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t
        disk = {name: os.path.getsize(os.path.join(tmp, name)) for name in os.listdir(tmp)}
        t = time.perf_counter()
        loaded = VectorIndex.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp)
    require(loaded.size == index.size and loaded.capacity == index.capacity,
            "the snapshot holds every live row at the same capacity")
    t = time.perf_counter()
    index.adopt(loaded)
    adopt_s = time.perf_counter() - t
    del loaded
    step("snapshot", save_s=save_s, load_s=load_s, adopt_s=adopt_s, bytes_on_disk=disk,
         snapshot_bytes=sum(disk.values()))
    out["seconds"] = time.perf_counter() - t_phase
    emit("lifecycle_done", seconds=out["seconds"], card=smi)
    return out


def lifecycle_checks(torch, dev, handover: dict, oracle: ChunkOracle, deleted: set) -> dict:
    """A burst of REQUESTS through the service (answers checked, the
    kernel's launches counted), then one batch: the fused top-12 against
    the plain path (``topk_int8_plain`` + ``rescore_candidates``), every row
    the current row of its chunk, and recall@12 against the oracle."""
    import numpy as np

    from outline_rag_tpu_torch.engine import fused_query
    from outline_rag_tpu_torch.models import pooled_embeddings
    from outline_rag_tpu_torch.ops.quant import quantize_rows_int8, rescore_candidates
    from outline_rag_tpu_torch.ops.topk import topk_int8, topk_int8_plain

    index, service, tok = handover["index"], handover["service"], handover["tok"]
    encoder, reranker, queries = handover["encoder"], handover["reranker"], handover["queries"]
    topk_int8.launches = 0
    answers, wall_s = serve_burst(service, queries)
    launches = topk_int8.launches
    require(launches > 0, "the burst launched the topk_int8 kernel")
    check_answers(np, answers, deleted)
    tb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode(), index.read_section():
        state, row_ids = index.snapshot()
        tokens = index.tokens.state
        _, _, _, idx, vals = fused_query(
            encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
            tokens.ids, tokens.mask, state.residual, top_k=TOP_K, rerank_k=RERANK_K,
        )
        q_emb = pooled_embeddings(encoder, q_ids, q_mask)
        qq, qs = quantize_rows_int8(q_emb)
        cand = topk_int8_plain(qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty)
        pv, pi = rescore_candidates(
            q_emb, *cand, state.vectors, state.scales, TOP_K, state.penalty, state.residual
        )
        fused_ids = [[str(row_ids[r]) for r in row] for row in idx.tolist()]
        current = all(index._by_chunk.get(row_ids[r]) == r for row in idx.tolist() for r in row)
        del state, tokens
    require(torch.equal(idx, pi), "fused top-12 equals the plain path's")
    err = float((vals - pv).abs().max())
    require(err <= VALUE_TOL, f"fused top-12 values within {VALUE_TOL} of the plain path's")
    require(current, "every returned row is its chunk's current row (no replaced row)")
    want = oracle.top_ids(torch, q_emb, TOP_K)
    hits = [len(set(a) & set(b)) for a, b in zip(fused_ids, want)]
    recall = sum(hits) / (TOP_K * len(hits))
    require(recall >= RECALL_MIN, f"recall@12 {recall} >= {RECALL_MIN}")
    return {"recall_at_12": recall, "max_abs_err_vs_plain": err, "topk_int8_launches": launches,
            **latency_fields(answers, wall_s)}


def scan_stages(torch, dev, handover: dict) -> dict:
    """``fused_query``'s scan (quantize, the kernel at K = 64, the rescore)
    and the kernel alone for the first batch of requests, median of 5."""
    from outline_rag_tpu_torch.models import pooled_embeddings
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8
    from outline_rag_tpu_torch.ops.topk import topk_int8

    index, tok, encoder = handover["index"], handover["tok"], handover["encoder"]
    tb = tok.batch(handover["queries"][:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode(), index.read_section():
        state, _ = index.snapshot()
        q_emb = pooled_embeddings(encoder, q_ids, q_mask)
        qq, qs = quantize_rows_int8(q_emb)
        out = {
            "rows": state.capacity,
            "scan_ms": cuda_ms(torch, lambda: int8_topk(
                *quantize_rows_int8(q_emb), state.vectors, state.scales, TOP_K, state.penalty,
                rescore_queries=q_emb, rescore_residual=state.residual), runs=5),
            "kernel_ms": cuda_ms(torch, lambda: topk_int8(
                qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty), runs=5),
        }
        del state
    return out


# -- the HTTP app: a whole local RAG turn over a socket ------------------------

HTTP_SOURCE_ROWS = 1024  # seeded rows per seeded document
HTTP_LIVE = LIVE_ROWS - 64 - BLOCK  # 995,840: the slice index's live rows
HTTP_DOCS = 24  # documents ingested through Outline sync during the phase
HTTP_CLIENTS = 64


class FakeWiki:
    """An Outline API on 127.0.0.1 (stdlib ``http.server`` on a thread of its
    own): ``collections.list``, paginated ``documents.list``,
    ``documents.info`` and ``documents.export`` over ``docs``
    ({id: {"id", "title", "text", "updatedAt", "url"}}), the replay the JAX
    package's tests serve through ``tests/fake_outline.py``."""

    def __init__(self, docs: dict):
        import http.server
        import threading

        wiki = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("content-length") or 0))
                status, out = wiki.answer(self.path.split("/api/")[-1], json.loads(body or b"{}"))
                data = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.docs = docs
        self.calls: dict[str, int] = {}
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def answer(self, endpoint: str, payload: dict):
        self.calls[endpoint] = self.calls.get(endpoint, 0) + 1
        if endpoint == "collections.list":
            return 200, {"data": [{"id": "col", "name": "col"}]}
        if endpoint == "documents.list":
            offset, limit = payload.get("offset", 0), payload.get("limit", 100)
            page = sorted(self.docs)[offset : offset + limit]
            return 200, {"data": [{k: self.docs[i][k] for k in ("id", "title", "updatedAt", "url")}
                                  for i in page]}
        doc = self.docs.get(payload.get("id"))
        if doc is None:
            return 404, {"error": "not found"}
        if endpoint == "documents.info":
            return 200, {"data": {k: doc[k] for k in ("id", "title", "updatedAt", "url")}}
        if endpoint == "documents.export":
            return 200, {"data": doc["text"]}
        return 404, {"error": "unknown endpoint"}

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def http_call(port: int, method: str, path: str, body=None, cookie: str | None = None,
              form: bool = False):
    """One request to the app over a fresh connection: (status, headers
    (case-insensitive), body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Cookie": cookie} if cookie else {}
    if form:
        headers["Content-Type"] = "application/x-www-form-urlencoded"
    elif body is not None:
        body = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    try:
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


def http_login(port: int, name: str) -> str:
    status, headers, _ = http_call(port, "POST", "/chat/login", f"name={name}".encode(), form=True)
    require(status == 302, f"dev login answered {status}")
    return headers["Set-Cookie"].split(";", 1)[0]


def sse_ask(port: int, cookie: str, conv_id: str, question: str) -> dict:
    """POST /chat/api/ask and read its SSE stream to the end: the parsed
    frames, the seconds to the first content frame and to ``[DONE]``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/chat/api/ask",
                     body=json.dumps({"question": question, "conversation_id": conv_id}).encode(),
                     headers={"Cookie": cookie, "Content-Type": "application/json"})
        resp = conn.getresponse()
        require(resp.status == 200, f"ask answered {resp.status}")
        frames, first, done = [], None, None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().strip()
            if not line.startswith("data:"):
                continue
            payload = line[5:].strip()
            if payload == "[DONE]":
                done = time.perf_counter() - t0
                frames.append(payload)
                continue
            frame = json.loads(payload)  # every frame must parse
            if first is None and frame["choices"][0]["delta"].get("content"):
                first = time.perf_counter() - t0
            frames.append(frame)
        return {"frames": frames, "first_s": first, "done_s": done}
    finally:
        conn.close()


def sources_of(frames) -> list[tuple[str, str]]:
    """The (title, url) pairs of an answer's SourcesMap, in citation order."""
    text = "".join(f["choices"][0]["delta"].get("content", "") for f in frames if f != "[DONE]")
    lines = [ln for ln in text.splitlines() if ln.startswith("[SourcesMap]:")]
    if not lines:
        return []
    smap = json.loads(lines[0][len("[SourcesMap]:"):])
    return [(smap[k]["title"], smap[k]["url"]) for k in sorted(smap, key=int)]


def percentiles(xs: list[float]) -> dict:
    xs = sorted(xs)
    return {"p50_ms": 1e3 * xs[len(xs) // 2], "p95_ms": 1e3 * xs[min(len(xs) - 1, int(0.95 * len(xs)))]}


def wait_for_healthz(proc, port: int, limit_s: float) -> tuple[float, int, bytes]:
    """Poll /healthz of a server process just started: (seconds until it
    answered, status, body); fails if the process ends or ``limit_s`` passes."""
    t0 = time.perf_counter()
    while True:
        require(proc.poll() is None, "the server process is running")
        try:
            status, _, body = http_call(port, "GET", "/healthz")
            return time.perf_counter() - t0, status, body
        except OSError:
            require(time.perf_counter() - t0 < limit_s, f"the server answered within {limit_s} s")
            time.sleep(0.2)


def sync_wiki(port: int, admin: str, n_docs: int) -> float:
    """``POST /chat/update/all``, then poll the refresh status until done:
    the seconds it took; fails unless exactly ``n_docs`` documents came in."""
    t0 = time.perf_counter()
    status, _, _ = http_call(port, "POST", "/chat/update/all", cookie=admin)
    require(status == 202, f"update/all answered {status}")
    while True:
        _, _, body = http_call(port, "GET", "/chat/api/refresh/status", cookie=admin)
        state = json.loads(body)
        if state.get("state") == "done":
            break
        require(time.perf_counter() - t0 < 300, f"the refresh finished: {state}")
        time.sleep(0.1)
    require(state.get("success") == n_docs, f"refresh ingested {n_docs}: {state}")
    return time.perf_counter() - t0


def wiki_questions(rng, wiki_docs: dict, new_docs: list[str], seeded: list[str], n: int) -> list[str]:
    """``n`` distinct 12-word phrases: the first half from the newly synced
    documents' text, the rest from the seeded documents'."""
    questions = []

    def phrase(sid):
        words = wiki_docs[sid]["text"].split()
        at = int(rng.integers(0, len(words) - 12))
        questions.append(" ".join(words[at : at + 12]))

    for p in rng.permutation(len(new_docs) * 4)[: n // 2]:
        phrase(new_docs[p % len(new_docs)])
    while len(questions) < n:
        phrase(seeded[int(rng.integers(0, len(seeded)))])
    require(len(set(questions)) == n, "distinct questions")
    return questions


def ask_at_once(port: int, questions: list[str], just_before=None) -> tuple[list[dict], float]:
    """One client a question (stdlib ``http.client`` on a thread each): each
    logs in and opens a conversation, then all ask at once and read their SSE
    streams to the end. ``just_before()`` runs once every thread waits at the
    barrier. Returns (each ask's ``sse_ask`` result, wall seconds); fails if
    an ask did not stream."""
    import threading

    clients = []
    for i in range(len(questions)):
        cookie = http_login(port, f"user{i}")
        _, _, body = http_call(port, "POST", "/chat/api/conversations", {"title": f"c{i}"},
                               cookie=cookie)
        clients.append((cookie, json.loads(body)["id"]))
    results = [None] * len(questions)
    start = threading.Barrier(len(questions) + 1)

    def client(i):
        start.wait()
        try:
            results[i] = sse_ask(port, *clients[i], questions[i])
        except Exception as exc:  # noqa: BLE001 — checked below
            results[i] = exc

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(questions))]
    for t in threads:
        t.start()
    if just_before is not None:
        just_before()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall_s = time.perf_counter() - t0
    errors = [r for r in results if not isinstance(r, dict)]
    require(not errors, f"every ask streamed: {errors[:3]}")
    for r in results:
        require(r["frames"] and r["frames"][-1] == "[DONE]" and r["done_s"] is not None,
                "every stream ends with [DONE]")
        require(r["first_s"] is not None, "every stream has a content frame")
    return results, wall_s


def http_phase(torch, dev, seed: int, embedder, reranker, slice_p50_ms: float) -> dict:
    """A fully local RAG turn through the port's app, over a socket: Outline
    sync into a 1M-row int8r index whose every row resolves in an on-disk
    sqlite meta store, then 64 concurrent clients asking through
    ``POST /chat/api/ask`` and reading the SSE stream, answered by the local
    decoder at TinyLlama-1.1B width."""
    import asyncio as aio
    import shutil
    import tempfile
    import threading

    import numpy as np

    import outline_rag_tpu_torch.models.decoder as decoder
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_kv_write
    from outline_rag_tpu_torch.ops.topk import topk_int8
    from outline_rag_tpu_torch.serve import LocalChatProvider, build_app
    from outline_rag_tpu_torch.serve.http import serve
    from outline_rag_tpu_torch.storage import SqliteMetaStore
    from outline_rag_tpu_torch.testing import ByteTokenizer
    from outline_rag_tpu_torch.tools.timing import card
    from outline_rag_tpu_torch.utils.profiling import metrics

    t_phase = time.perf_counter()
    out = {"card": card()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    rng = np.random.default_rng(seed + 14)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:5000]]

    def words(n: int) -> str:
        return " ".join(rng.choice(vocab, n))

    # the index: seeded rows in documents of HTTP_SOURCE_ROWS chunks
    tok = embedder.tokenizer
    index = VectorIndex(dim=DIM, capacity=CAPACITY, dtype="int8r", device=dev,
                        token_width=TOKEN_WIDTH)
    seeded, t0 = [], time.perf_counter()
    while index.size < HTTP_LIVE:
        sid = f"seed{len(seeded):04d}"
        v, ids, mask = random_chunks(torch, HTTP_SOURCE_ROWS, gen, dev, tok,
                                     embedder.cfg.vocab_size)
        index.add_chunks([f"{sid}:{i}" for i in range(HTTP_SOURCE_ROWS)], v, sid,
                         token_ids=ids, token_mask=mask)
        seeded.append(sid)
    torch.cuda.synchronize()
    out["index_fill_s"] = time.perf_counter() - t0
    # every one of those rows resolves in the meta store, written through its own API
    meta = SqliteMetaStore(os.path.join(tmp, "meta.sqlite3"))
    wiki_docs, t0 = {}, time.perf_counter()
    for n, sid in enumerate(seeded):
        title, text = f"Seeded document {n}", words(600)
        meta.upsert_document(sid, title, f"/doc/{sid}", "t0", text)
        meta.replace_chunks(sid, [(f"{sid}:{i}", i, f"{title}, part {i}", 0)
                                  for i in range(HTTP_SOURCE_ROWS)])
        wiki_docs[sid] = {"id": sid, "title": title, "text": text, "updatedAt": "t0",
                          "url": f"/doc/{sid}"}
    out["meta_fill_s"] = time.perf_counter() - t0
    require(meta.chunk_count() == index.size, "every live row has a chunk row")
    # the documents Outline sync brings in: 1,100-8,000 words in paragraphs
    new_docs = []
    for n in range(HTTP_DOCS):
        n_words = int(rng.integers(1100, 8001))
        paras = [words(int(rng.integers(40, 120))) for _ in range(n_words // 80 + 1)]
        text = "\n\n".join(paras)
        new_docs.append(f"doc{n:02d}")
        wiki_docs[new_docs[-1]] = {"id": new_docs[-1], "title": f"Wiki page {n}", "text": text,
                                   "updatedAt": "t1", "url": f"/doc/{new_docs[-1]}"}

    # the local decoder, behind the classifier stand-in
    cfg = decoder.DecoderConfig.tinyllama_1b()
    params = decoder.init_decoder(cfg, torch.Generator(device=dev).manual_seed(seed + 15), dev)

    class KeptTokenizer(ByteTokenizer):
        """Keeps each stream's id list, to count the tokens it decoded."""

        def __init__(self):
            self.lists = {}

        def decode(self, ids):
            self.lists[id(ids)] = ids
            return super().decode(ids)

    dtok = KeptTokenizer()
    local = LocalChatProvider(params, cfg, dtok, batch_slots=DEC_SLOTS, kv_pages=KV_PAGES,
                              page_size=PAGE, chunk_tokens=DEC_CHUNK, max_new_tokens=DEC_NEW,
                              device=dev)

    class ClassifiedAsQuery:
        """Stands in for a trained model's classification, the one part of
        this phase that is not the port's code: a random-weight decoder
        never writes the classifier's JSON, and the pipeline would route
        every ask to General and skip retrieval. Answers stream from the
        local decoder."""

        async def complete(self, model, messages, temperature=0.0, top_p=None,
                           json_mode=False, max_tokens=None):
            if json_mode:
                return json.dumps({"category": "Query"})
            return await local.complete(model, messages, temperature, top_p, json_mode, max_tokens)

        def stream(self, *args, **kwargs):
            return local.stream(*args, **kwargs)

        def stats(self):
            return local.stats()

    wiki = FakeWiki(wiki_docs)
    env = {"SECRET_KEY": "chip-smoke", "DATA_DIR": tmp, "VECTOR_DIM": str(DIM),
           "OUTLINE_API_TOKEN": "chip-smoke", "OUTLINE_WEBHOOK_SECRET": "whsec",
           "OUTLINE_API_URL": wiki.url}
    settings = load_settings(env)
    require((settings.top_k, settings.rerank_k, settings.query_batch_max, settings.chunk_size,
             settings.token_width) == (TOP_K, RERANK_K, MAX_BATCH, 1024, TOKEN_WIDTH),
            "the JAX defaults: TOP_K 12, RERANK_K 3, QUERY_BATCH_MAX 32, CHUNK_SIZE 1024")
    app = build_app(settings, device=str(dev), provider=ClassifiedAsQuery(), embedder=embedder,
                    reranker=reranker, index=index, meta=meta, start_workers=True)
    retrieval = app.state["retrieval"]
    require(retrieval.fused, "the app's retrieval runs the fused path")

    # the server on a thread with its own event loop (signal handlers are the
    # main thread's; serve() installs none)
    loop = aio.new_event_loop()
    booted, holder = threading.Event(), {}

    def run_server():
        aio.set_event_loop(loop)

        async def boot():
            holder["server"] = await serve(app, "127.0.0.1", 0)
            booted.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    def fused_count():
        return metrics.snapshot().get("retrieve.fused", {}).get("count", 0)

    warm_before = fused_count()
    server_thread = threading.Thread(target=run_server, daemon=True)
    t0 = time.perf_counter()
    server_thread.start()
    require(booted.wait(120), "the server started")
    port = holder["server"].sockets[0].getsockname()[1]
    while fused_count() < warm_before + 2:  # the app's warm-up: a lone query, then 32
        require(time.perf_counter() - t0 < 120, "the app's warm-up finished")
        time.sleep(0.05)
    out["startup_and_warmup_s"] = time.perf_counter() - t0
    try:
        status, _, body = http_call(port, "GET", "/healthz")
        require(status == 200, "healthz answered 200")
        size_before = json.loads(body)["index_size"]
        require(size_before == index.size >= HTTP_LIVE, f"healthz index_size {size_before}")

        # ingest through Outline sync: the refresh route, then the task worker
        admin = http_login(port, "admin")
        out["ingest_s"] = sync_wiki(port, admin, HTTP_DOCS)
        require(wiki.calls.get("documents.export") == HTTP_DOCS,
                f"only the new documents were fetched: {wiki.calls}")
        new_chunks = [c["chunk_id"] for sid in new_docs for c in meta.chunks_of(sid)]
        require(all(meta.get_document(sid) for sid in new_docs), "the new documents are stored")
        require(all(cid in index._by_chunk for cid in new_chunks), "their chunks are indexed")
        _, _, body = http_call(port, "GET", "/healthz")
        grew = json.loads(body)["index_size"] - size_before
        require(grew == len(new_chunks) > 0,
                f"healthz index_size grew by their {len(new_chunks)} chunks, not {grew}")
        require(meta.chunk_count() == index.size, "every live row still resolves")
        out.update(ingested_docs=HTTP_DOCS, ingested_chunks=len(new_chunks),
                   index_size=index.size)

        # 64 clients: login and a conversation each, then the asks at once
        questions = wiki_questions(rng, wiki_docs, new_docs, seeded, HTTP_CLIENTS)
        batches = []  # (queries, seconds) of each batch the batcher formed
        batcher = app.state["batcher"]
        inner = batcher.retrieve_batch

        def recorded(queries):
            t = time.perf_counter()
            res = inner(queries)
            batches.append((list(queries), time.perf_counter() - t))
            return res

        batcher.retrieve_batch = recorded

        def just_before():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            dtok.lists.clear()
            topk_int8.launches = paged_attention.launches = paged_kv_write.launches = 0
            with metrics._lock:  # the stage timings below are the burst's alone
                metrics._samples.clear()
                metrics._counts.clear()

        try:
            results, wall_s = ask_at_once(port, questions, just_before)
        finally:
            batcher.retrieve_batch = inner
        burst_stages = metrics.snapshot()
        launches = {"topk_int8": topk_int8.launches, "paged_attention": paged_attention.launches,
                    "paged_kv_write": paged_kv_write.launches}
        generated = sum(len(ids) for ids in dtok.lists.values())
        peak = torch.cuda.max_memory_allocated(dev)
        require(sum(len(q) for q, _ in batches) == HTTP_CLIENTS, "each ask retrieved once")
        require(launches["topk_int8"] >= len(batches) > 0,
                f"topk_int8 launched at least once a batch: {launches}, {len(batches)} batches")
        require(launches["paged_attention"] > 0 and launches["paged_kv_write"] > 0,
                f"the local decoder's kernels launched: {launches}")

        # the sources of every answer against the app's own retrieval, called
        # directly on the batches the batcher formed
        def doc_sources(chunks):
            seen = []
            for c in chunks:
                row = meta.get_chunk(c.chunk_id)
                if row and row["source_id"] not in seen:
                    seen.append(row["source_id"])
            return [(meta.get_document(s)["title"], meta.get_document(s)["url"]) for s in seen]

        want = {}
        for queries, _ in batches:
            for q, chunks in zip(queries, retrieval.retrieve_batch(queries)):
                want[q] = doc_sources(chunks)
        for q, r in zip(questions, results):
            got = sources_of(r["frames"])
            require(got and got == want[q], f"the sources of {q!r}: {got} vs {want[q]}")
        from_new = sum(any(url.removeprefix("/doc/") in new_docs for _, url in want[q])
                       for q in questions[: HTTP_CLIENTS // 2])

        status, _, body = http_call(port, "GET", "/chat/api/metrics", cookie=admin)
        require(status == 200, f"metrics answered {status}")
        m = json.loads(body)
        require({"retrieve.fused", "llm.classify", "http.POST"} <= set(m["stages"]),
                f"the metrics carry the stage timings: {sorted(m['stages'])}")
        require({"prefix_hits", "backpressure_waits", "pages_total"} <= set(m.get("decoder", {})),
                f"the metrics carry the decoder's stats: {m.get('decoder')}")
        sizes = [len(q) for q, _ in batches]
        out.update(
            card=card(), asks=HTTP_CLIENTS, wall_s=wall_s, asks_per_s=HTTP_CLIENTS / wall_s,
            first_content=percentiles([r["first_s"] for r in results]),
            done=percentiles([r["done_s"] for r in results]),
            streamed_tokens=generated, streamed_tokens_per_s=generated / wall_s,
            batches=len(batches), mean_batch=sum(sizes) / len(sizes), batch_sizes=sizes,
            retrieval_batch=percentiles([s for _, s in batches]),
            launches=launches, decoder=m["decoder"],
            prefix_hits=m["decoder"]["prefix_hits"],
            backpressure_waits=m["decoder"]["backpressure_waits"],
            questions_from_new_docs_citing_one=from_new,
            peak_device_gb=peak / 1e9, slice_burst_p50_ms=slice_p50_ms,
            stages={k: burst_stages[k] for k in ("retrieve.fused", "llm.classify", "http.POST")},
        )
    finally:
        async def stop():
            holder["server"].close()
            await holder["server"].wait_closed()
            await app.shutdown()

        if "server" in holder:
            aio.run_coroutine_threadsafe(stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        server_thread.join(30)
        local.close()
        wiki.close()
        meta.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("http", **out)
    return out


def entry_phase() -> dict:
    """``python -m outline_rag_tpu_torch`` on the card with the defaults (hash
    embedder, int8r index, fake provider): /healthz, one dev-login ask to
    ``[DONE]``, SIGTERM to exit 0 within the drain timeout; then the
    ``status`` command."""
    import shutil
    import signal
    import socket
    import subprocess
    import tempfile

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "SECRET_KEY": "chip-smoke", "DATA_DIR": tmp, "PORT": str(port)}
    log_path = os.path.join(tmp, "server.log")
    out = {}
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen([sys.executable, "-m", "outline_rag_tpu_torch"], cwd=root, env=env,
                                stdout=log_file, stderr=subprocess.STDOUT)
    try:
        out["boot_s"], status, body = wait_for_healthz(proc, port, 180)
        require(status == 200, f"healthz answered {status}")
        out["healthz"] = json.loads(body)
        cookie = http_login(port, "entry")
        _, _, body = http_call(port, "POST", "/chat/api/conversations", {"title": "e"},
                               cookie=cookie)
        ask = sse_ask(port, cookie, json.loads(body)["id"], "what does the wiki say?")
        require(ask["frames"][-1] == "[DONE]" and ask["first_s"] is not None,
                "the ask streamed content to [DONE]")
        out["ask_ms"] = 1e3 * ask["done_s"]
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=10.0 + 20)  # DRAIN_TIMEOUT's default, and shutdown
        out.update(exit_code=rc, stop_s=time.perf_counter() - t0)
        require(rc == 0, f"SIGTERM ended the server with exit 0, not {rc}")
        require(out["stop_s"] <= 10.0, f"it stopped within the drain timeout: {out['stop_s']} s")
        status_run = subprocess.run([sys.executable, "-m", "outline_rag_tpu_torch", "status"],
                                    cwd=root, env=env, capture_output=True, text=True,
                                    timeout=300)
        require(status_run.returncode == 0, f"status exited {status_run.returncode}: "
                f"{status_run.stderr[-2000:]}")
        printed = status_run.stdout.strip().splitlines()[-1]
        require("'dtype': 'int8r'" in printed, f"status printed dtype int8r: {printed}")
        out["status"] = printed
    except Exception:
        with open(log_path) as f:
            print(f.read()[-4000:], file=sys.stderr)
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("entry", **out)
    return out


def hybrid_phase(torch, dev, seed: int) -> dict:
    """BGE-m3's lexical and ColBERT terms in the fused query at bge-m3 width:
    a seeded encoder with both heads over an int8r index of 131,072 rows
    with a 64-wide token cache and rank-128 ColBERT codes, 120,000 live."""
    import numpy as np

    from outline_rag_tpu_torch.engine import (
        CrossEncoderReranker,
        EncoderEmbedder,
        RetrievalService,
        add_hybrid_terms,
        encode_queries,
        fused_query,
    )
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.models import (
        EncoderConfig,
        colbert_vectors_from_hidden,
        init_colbert_head,
        init_encoder,
        init_reranker,
        init_sparse_head,
        late_interaction_scores,
        lexical_overlap_scores,
        sparse_weights_from_hidden,
    )
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8, rescore_candidates
    from outline_rag_tpu_torch.ops.topk import NEG, topk_int8, topk_int8_plain
    from outline_rag_tpu_torch.tools.timing import card

    t_phase = time.perf_counter()
    cfg = EncoderConfig.bge_m3()
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    encoder = init_colbert_head(init_sparse_head(init_encoder(cfg, gen, dev), gen), gen)
    reranker = init_reranker(cfg, gen, dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    embedder = EncoderEmbedder(encoder, tok)
    index = VectorIndex(dim=DIM, capacity=HYB_CAPACITY, dtype="int8r", device=dev,
                        token_width=TOKEN_WIDTH, colbert_rank=HYB_RANK)
    proj = index.colbert_projection_for(encoder.colbert.out_features)

    # 4,096 text chunks through the three heads, 64 per source; a small
    # vocabulary, so queries share tokens with the chunks they retrieve
    rng = np.random.default_rng(seed + 13)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:HYB_VOCAB]]
    texts = make_texts(rng, TEXT_CHUNKS, vocab)
    tb = tok.batch(texts, TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    torch.cuda.synchronize()
    t = time.perf_counter()
    vecs = embedder.embed(texts)
    weights = embedder.token_weights(tb.input_ids, tb.attention_mask)
    codes, scales = embedder.colbert_cache(tb.input_ids, tb.attention_mask, HYB_RANK, proj)
    heads_s = time.perf_counter() - t
    require(np.isfinite(vecs).all() and np.isfinite(weights).all() and np.isfinite(scales).all(),
            "finite embeddings, weights and scales")
    for s in range(0, TEXT_CHUNKS, 64):
        part = slice(s, s + 64)
        index.add_chunks([f"text{s // 64}:{i}" for i in range(64)], vecs[part], f"text{s // 64}",
                         token_ids=tb.input_ids[part], token_mask=tb.attention_mask[part],
                         token_weights=weights[part], colbert_codes=codes[part],
                         colbert_scales=scales[part])
    # seeded rows up to HYB_LIVE: unit vectors, random token rows, non-negative
    # weights, codes and scales (0 at CLS and padding)
    n_src = 0
    while index.size < HYB_LIVE:
        n = min(BLOCK, HYB_LIVE - index.size)
        v, ids, mask = random_chunks(torch, n, gen, dev, tok, cfg.vocab_size)
        real = mask.float()
        real[:, 0] = 0.0
        w = torch.rand((n, TOKEN_WIDTH), generator=gen, device=dev) * real
        c = torch.randint(-127, 128, (n, TOKEN_WIDTH, HYB_RANK), generator=gen, device=dev,
                          dtype=torch.int8)
        sc = torch.rand((n, TOKEN_WIDTH), generator=gen, device=dev) * (0.02 / 127) * real
        index.add_chunks([f"rand{n_src}:{i}" for i in range(n)], v, f"rand{n_src}",
                         token_ids=ids, token_mask=mask, token_weights=w,
                         colbert_codes=c * real[..., None].to(torch.int8), colbert_scales=sc)
        n_src += 1
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t
    require(index.size == HYB_LIVE, f"live rows {index.size}")
    smi = card()
    emit("hybrid_ingest", heads_s=heads_s, ingest_s=ingest_s, live_rows=index.size,
         capacity=HYB_CAPACITY, colbert_rank=HYB_RANK,
         colbert_bytes=index.tokens.colbert.codes.numel() + 4 * index.tokens.colbert.scales.numel(),
         card=smi)

    picks = rng.integers(0, TEXT_CHUNKS, REQUESTS)
    queries = [" ".join(texts[j].split()[3:15]) for j in picks]
    service = RetrievalService(index, embedder, CrossEncoderReranker(reranker, tok), top_k=TOP_K,
                               rerank_k=RERANK_K, lex_weight=HYB_LEX, colbert_weight=HYB_COLBERT)
    require(service.fused, "the service runs the fused path")
    serve_burst(service, queries[:MAX_BATCH])  # warm-up
    topk_int8.launches = 0
    answers, wall_s = serve_burst(service, queries)
    launches = topk_int8.launches
    require(launches > 0, "the hybrid burst launched the topk_int8 kernel")
    check_answers(np, answers, set())

    # one batch: the cached form against its plain composition
    qb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(qb.input_ids, device=dev)
    q_mask = torch.as_tensor(qb.attention_mask, device=dev)
    proj_t = torch.as_tensor(proj, device=dev)
    with torch.inference_mode():
        state, _ = index.snapshot()
        t_, cb = index.tokens.state, index.tokens.colbert
        common = (encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                  t_.ids, t_.mask, state.residual)
        cached = dict(top_k=TOP_K, rerank_k=RERANK_K, tok_weights=t_.weights,
                      tok_cvecs=cb.codes, tok_cscale=cb.scales, colbert_proj=proj_t,
                      lex_weight=HYB_LEX, colbert_weight=HYB_COLBERT)
        recompute = {**cached, "tok_cvecs": None, "tok_cscale": None, "colbert_proj": None}
        off = dict(top_k=TOP_K, rerank_k=RERANK_K)
        r_rows, _, _, idx, vals = fused_query(*common, **cached)
        # the composition, from the port's parts
        q_hidden, q_emb = encode_queries(encoder, q_ids, q_mask)
        qq, qs = quantize_rows_int8(q_emb)
        cand = topk_int8_plain(qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty)
        pv, pi = rescore_candidates(q_emb, *cand, state.vectors, state.scales, TOP_K,
                                    state.penalty, state.residual)
        rows = pi.long()
        lex = lexical_overlap_scores(
            q_ids, sparse_weights_from_hidden(encoder, q_hidden, q_ids, q_mask), t_.ids[rows],
            t_.weights[rows])
        q_cb = colbert_vectors_from_hidden(encoder, q_hidden, q_mask) @ proj_t
        late = late_interaction_scores(q_cb, q_mask, cb.codes[rows].float() * cb.scales[rows][..., None])
        composed = pv + HYB_LEX * lex + HYB_COLBERT * late
        pairs = t_.ids[rows]
        pairs[:, :, 0] = tok.eos_id
        b, k = rows.shape
        rr = reranker(
            torch.cat([q_ids[:, None, :].expand(b, k, -1).to(pairs.dtype), pairs], 2).reshape(b * k, -1),
            torch.cat([q_mask[:, None, :].expand(b, k, -1).to(pairs.dtype), t_.mask[rows]], 2)
            .reshape(b * k, -1),
        ).reshape(b, k).masked_fill(composed <= NEG / 2, NEG)
        want_top3 = torch.gather(pi, 1, torch.sort(rr, dim=1, descending=True, stable=True)[1][:, :RERANK_K])
        live = pv > NEG / 2
        lex_share = float(((lex != 0) & live).sum() / live.sum())
        late_share = float(((late != 0) & live).sum() / live.sum())

        # timings of the batch, median of 5: the path with the terms off, the
        # cached and the recompute forms, and the cached form's stages
        timing = {
            "off_ms": cuda_ms(torch, lambda: fused_query(*common, **off), runs=5),
            "cached_ms": cuda_ms(torch, lambda: fused_query(*common, **cached), runs=5),
            "recompute_ms": cuda_ms(torch, lambda: fused_query(*common, **recompute), runs=5),
            "encode_ms": cuda_ms(torch, lambda: encode_queries(encoder, q_ids, q_mask), runs=5),
            "terms_ms": cuda_ms(torch, lambda: add_hybrid_terms(
                pv, encoder, q_hidden, q_ids, q_mask, t_.ids[rows], t_.mask[rows],
                t_.weights[rows], cb.codes[rows], cb.scales[rows], proj_t,
                lex_weight=HYB_LEX, colbert_weight=HYB_COLBERT), runs=5),
        }
        timing["scan_ms"] = cuda_ms(torch, lambda: int8_topk(
            *quantize_rows_int8(q_emb), state.vectors, state.scales, TOP_K, state.penalty,
            rescore_queries=q_emb, rescore_residual=state.residual), runs=5)
        timing["gather_rerank_ms"] = (timing["cached_ms"] - timing["encode_ms"]
                                      - timing["scan_ms"] - timing["terms_ms"])
        del state, t_, cb, common, cached, recompute
    require(torch.equal(idx, pi), "the hybrid retrieval rows equal the composition's")
    err = float((vals - composed)[live].abs().max())
    require(err <= HYB_TOL, f"hybrid retrieval values within {HYB_TOL} of the composition's: {err}")
    require(lex_share > 0.5 and late_share > 0.5,
            f"both terms non-zero for most live candidates ({lex_share}, {late_share})")
    require(torch.equal(r_rows, want_top3), "the rerank top-3 equals the composition's")
    out = {"topk_int8_launches": launches, "max_abs_err_vs_composition": err,
           "lexical_nonzero_share": lex_share, "late_nonzero_share": late_share,
           "stages": timing, "seconds": time.perf_counter() - t_phase, "card": smi,
           **latency_fields(answers, wall_s)}
    emit("hybrid", **out)
    del service, index, encoder, reranker, embedder
    return out


def unit_rows(torch, n: int, gen, dev):
    x = torch.randn((n, DIM), generator=gen, device=dev)
    return x.div_(x.norm(dim=1, keepdim=True))


def float_storage(torch, x, mode: str):
    """f32 rows ``x`` as ``mode`` stores them (and takes its queries)."""
    from outline_rag_tpu_torch.ops.topk import split_f32_bf16x2

    if mode == "fp32":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16)
    return split_f32_bf16x2(x)


def kernel_float_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.ops.topk import (
        FLOAT_MODES,
        NEG,
        topk_float,
        topk_float_plain,
    )
    from outline_rag_tpu_torch.testing import tie_aware_mismatches

    from outline_rag_tpu_torch.ops.topk import topk_floor, topk_floor_plain
    from outline_rag_tpu_torch.tools.bench_topk_kernel import bench_mode

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    out = {}
    floor_launches = 0  # counted over the tool's runs only
    for mode in FLOAT_MODES:
        # the corpus: seeded unit rows, N_DUPS copies of row src, 1% tombstones
        corpus = unit_rows(torch, N_ROWS, g, dev)
        src = int(torch.randint(0, N_ROWS, (1,), generator=g, device=dev))
        dups = torch.randperm(N_ROWS, generator=g, device=dev)[: N_DUPS + 1]
        dups = dups[dups != src][:N_DUPS]
        corpus[dups] = corpus[src].clone()
        anchor = corpus[src].clone()
        corpus = float_storage(torch, corpus, mode)
        torch.cuda.empty_cache()
        penalty = torch.where(torch.rand(N_ROWS, generator=g, device=dev) < 0.01, NEG, 0.0).float()
        penalty[dups] = 0.0
        penalty[src] = 0.0
        tied = sorted({src, *dups.tolist()})
        few_live = torch.full((N_ROWS,), NEG, device=dev)
        few_live[torch.randperm(N_ROWS, generator=g, device=dev)[:10]] = 0.0

        cases = [(b, k, penalty) for b in (1, 32, 128) for k in (12, 64)]
        cases.append((32, 64, few_live))
        max_err, timed = 0.0, {}
        for b, k, pen in cases:
            qf = unit_rows(torch, b, g, dev)
            qf[0] = anchor  # query 0 is row src: its copies tie at the top
            q = float_storage(torch, qf, mode)
            args = (q, corpus, k, pen, mode)
            vals, idx = topk_float(*args)
            torch.cuda.synchronize()
            # K + 1 columns: the tie-aware check knows the K-th slot's neighbour
            pv, pi = topk_float_plain(q, corpus, k + 1, pen, mode)
            err = float((vals - pv[:, :k]).abs().max())
            max_err = max(max_err, err)
            row = {
                "mode": mode, "B": b, "K": k, "live": int((pen == 0).sum()),
                "mismatches": tie_aware_mismatches(vals, idx, pv, pi, FLOAT_TOL),
                "idx_equal": bool(torch.equal(idx, pi[:, :k])), "max_abs_err": err,
            }
            require(row["mismatches"] == 0 and err <= FLOAT_TOL,
                    f"float kernel agrees with the plain version within {FLOAT_TOL} at {row}")
            if pen is penalty:
                head = min(k, len(tied))
                require(idx[0, :head].tolist() == tied[:head]
                        and bool((vals[0, :head] == vals[0, 0]).all()),
                        f"{mode}: the copies tie exactly and come lowest row first")
            else:
                require(bool((idx[:, 10:] == 0).all() and (vals[:, 10:] == NEG).all()),
                        f"{mode}: slots past the 10 live rows are (NEG, 0)")
            if k == 64 and b in (32, 128) and pen is penalty:
                row["ms"] = cuda_ms(torch, lambda: topk_float(*args))
                row["plain_ms"] = cuda_ms(torch, lambda: topk_float_plain(*args))
                if b == 32 and mode != "f32x2":
                    # a yardstick of two library calls, not the same function:
                    # torch.topk keeps no order among ties
                    row["library_pair_ms"] = cuda_ms(
                        torch, lambda: torch.topk(q @ corpus.T + pen, k, dim=1))
                timed[b] = row
            emit("kernel_float", **row)
        # the floors on the same corpus: against their twins, nomerge against
        # the full scan's best score, then the tool's timings (its launches
        # are the ones counted)
        q = float_storage(torch, unit_rows(torch, 32, g, dev), mode)
        floor_err = 0.0
        for variant in ("nomerge",) if mode == "f32x2" else ("nomerge", "matmul"):
            got = topk_floor(q, corpus, mode, variant)
            torch.cuda.synchronize()
            floor_err = max(floor_err, float(
                (got - topk_floor_plain(q, corpus, mode, variant)).abs().max()))
        best, _ = topk_float(q, corpus, TOP_K, None, mode)
        nomerge = topk_floor(q, corpus, mode)
        floor_row = {"max_abs_err": floor_err,
                     "nomerge_equals_scan_top": bool(torch.equal(nomerge, best[:, 0])),
                     "plain_ms": cuda_ms(torch, lambda: topk_floor_plain(q, corpus, mode), runs=3)}
        require(floor_err <= FLOAT_TOL, f"{mode}: topk_floor within {FLOAT_TOL} of its twin")
        require(floor_row["nomerge_equals_scan_top"],
                f"{mode}: the nomerge floor is bit-equal to the scan's best score")
        topk_floor.launches = 0
        floor_row.update(bench_mode(q, corpus, mode))
        floor_launches += topk_floor.launches
        emit("kernel_topk_floor", **floor_row)
        del corpus, penalty, few_live
        torch.cuda.empty_cache()

        # the index dtype that scans in this mode, through VectorIndex.query
        dtype = {"fp32": "float32", "bf16": "bfloat16", "f32x2": "f32x2"}[mode]
        index = VectorIndex(dim=DIM, capacity=1 << 16, dtype=dtype, device=dev)
        vecs = unit_rows(torch, 1 << 16, g, dev)
        index.add_chunks([f"v{i}" for i in range(1 << 16)], vecs, "s")
        before = topk_float.launches[mode]
        ids, _ = index.query(vecs[:8], TOP_K)
        require(topk_float.launches[mode] == before + 1, f"{dtype} index query launched the kernel")
        require([r[0] for r in ids] == [f"v{i}" for i in range(8)],
                f"{dtype} index: each stored row is its own top match")
        del index, vecs
        torch.cuda.empty_cache()
        # B = 32: the stored rows and the penalty read once; the operands are
        # f32 in fp32 mode and bf16 (hi/lo pairs, three products a pair, in
        # f32x2) otherwise, so each mode is held to its own type's peak
        row_bytes = {"fp32": 4, "bf16": 2, "f32x2": 4}[mode] * DIM
        products = 3 if mode == "f32x2" else 1
        out[mode] = {"max_abs_err": max_err, "ms": timed[32]["ms"],
                     "plain_ms": timed[32]["plain_ms"], "ms_b128": timed[128]["ms"],
                     "library_pair_ms": timed[32].get("library_pair_ms"),
                     "plain_ms_b128": timed[128]["plain_ms"],
                     **bound(N_ROWS * (row_bytes + 4) + 32 * row_bytes + 32 * 64 * 8,
                             2 * products * 32 * N_ROWS * DIM,
                             "f32" if mode == "fp32" else "bf16"),
                     **{key + "_b128": value for key, value in bound(
                         N_ROWS * (row_bytes + 4) + 128 * row_bytes + 128 * 64 * 8,
                         2 * products * 128 * N_ROWS * DIM,
                         "f32" if mode == "fp32" else "bf16").items()},
                     # the floor reads the rows and the queries and writes B maxima
                     "floor": {**floor_row, **bound(N_ROWS * row_bytes + 32 * row_bytes + 32 * 4,
                                                    2 * products * 32 * N_ROWS * DIM,
                                                    "f32" if mode == "fp32" else "bf16")}}
    require(floor_launches > 0, "the scan tool launched the topk_floor kernel")
    return out, floor_launches


def flash_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.attention import (
        NEG_BIAS,
        flash_attention,
        flash_attention_plain,
    )
    from outline_rag_tpu_torch.testing import flash_errors

    g = torch.Generator(device=dev).manual_seed(seed + 4)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def case(b, s, lengths, dtype):
        """A row's live keys: the first n for an int, else a list of (from, to)
        spans (a bias that is no prefix mask)."""
        q, k, v = (torch.randn((b, s, FLASH_HEADS, 64), generator=g, device=dev)
                   .to(dtypes[dtype]) for _ in range(3))
        bias = torch.full((b, s), NEG_BIAS, device=dev)
        for i, live in enumerate(lengths):
            for lo, hi in ([(0, live)] if isinstance(live, int) else live):
                bias[i, lo:hi] = 0.0
        return q, k, v, bias

    cases = [(1, s, [s], "bf16") for s in (2048, 4096, 8192)]
    cases += [(2, 4096, [3000, 0], "bf16"), (1, 2048, [2048], "f32"),
              (1, 2048 + 37, [2048 + 37], "bf16"),  # S no multiple of a tile
              (1, 4096, [[(0, 1000), (3000, 3500)]], "bf16"),  # all-padding tiles in between
              (3, 2048, [2048, 0, [(5, 700)]], "bf16")]
    max_err, times = 0.0, {}
    for b, s, lengths, dtype in cases:
        args = case(b, s, lengths, dtype)
        out = flash_attention(*args)
        torch.cuda.synchronize()
        require(bool(torch.equal(out, flash_attention(*args))),
                f"flash: two runs are bit-equal at B={b} S={s} {dtype}")
        plain = flash_attention_plain(*args)
        atol, ulps, rel_rms = FLASH_BOUNDS[dtype]
        row = {"dtype": dtype, "B": b, "S": s, "H": FLASH_HEADS, "lengths": lengths,
               **flash_errors(out, plain, atol, ulps), "max_abs_plain": float(plain.abs().max())}
        if dtype == "bf16":
            max_err = max(max_err, row["max_abs_err"])
        require(row["worst_vs_bound"] <= 1.0 and row["rel_rms_err"] <= rel_rms,
                f"flash kernel within {atol} + {ulps} ulps, error norm within {rel_rms}, at {row}")
        for i, n in enumerate(lengths):
            if n == 0:
                require(bool((out[i] == 0).all()), "a row with no live key is exactly zero")
        if b == 1 and lengths == [s]:
            # ms: one launch through the wrapper; device_ms: many launches (at
            # S = 2,048 the kernel is shorter than the host's way to it). The
            # operands (12-50 MB) are as warm as the projections leave them.
            row.update(both_ms(torch, lambda: flash_attention(*args), runs=5))
            row["plain_ms"] = cuda_ms(torch, lambda: flash_attention_plain(*args), runs=5)
            row["kernel_tflops"] = 4 * s * s * 64 * FLASH_HEADS / row["device_ms"] / 1e9
            if dtype == "bf16":
                # the library yardstick, used nowhere in the port: one fused
                # attention call with the bias as an additive mask
                qh, kh, vh = (x.transpose(1, 2) for x in args[:3])
                mask = args[3].to(torch.bfloat16)[:, None, None, :]
                library = both_ms(
                    torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask), runs=5)
                row["library_ms"] = library["ms"]
                row["library_device_ms"] = library["device_ms"]
                if s in (2048, 4096, 8192):
                    times[s] = row
        emit("flash", **row)
        del args, out, plain
    top = 8192  # q, k, v read and the output written once; 4*S*S*D*H flops
    return {"max_abs_err": max_err, "ms": times[top]["ms"], "plain_ms": times[top]["plain_ms"],
            "library_ms": times[top]["library_ms"], "device_ms": times[top]["device_ms"],
            "library_device_ms": times[top]["library_device_ms"],
            **bound(4 * top * FLASH_HEADS * 64 * 2 + top * 4, 4 * top * top * 64 * FLASH_HEADS,
                    "bf16"),
            "by_S": {s: {key: r[key] for key in (
                "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms")}
                for s, r in times.items()}}


def long_lengths(rng) -> list[int]:
    """Words per document, LONG_DOCS_PER_BUCKET in each of the 2048, 4096
    and 8192 buckets, at least one 64-key tile clear of either bucket edge
    (so fully padded key tiles occur); the tokenizer adds CLS and EOS."""
    lengths = []
    for lo, hi in ((1024, 2048), (2048, 4096), (4096, 8192)):
        lengths += [int(n) for n in rng.integers(lo + 64, hi - 66, LONG_DOCS_PER_BUCKET)]
    return lengths


def long_phase(torch, dev, seed: int) -> dict:
    """Whole-document ingest through the flash kernel, then f32x2 serving."""
    import numpy as np

    import outline_rag_tpu_torch.models.encoder as encoder_module
    from outline_rag_tpu_torch.engine import (
        CrossEncoderReranker,
        EncoderEmbedder,
        RetrievalService,
        fused_query,
    )
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.index.store import normalize_rows
    from outline_rag_tpu_torch.models import (
        EncoderConfig,
        init_encoder,
        init_reranker,
        pooled_embeddings,
    )
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
    from outline_rag_tpu_torch.ops.attention import flash_attention, flash_attention_plain
    from outline_rag_tpu_torch.ops.topk import (
        cosine_topk,
        split_f32_bf16x2,
        topk_float,
        topk_float_plain,
        topk_plain,
    )
    from outline_rag_tpu_torch.testing import tie_aware_mismatches

    cfg = EncoderConfig.bge_m3()
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    encoder = init_encoder(cfg, gen, dev)
    reranker = init_reranker(cfg, gen, dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    embedder = EncoderEmbedder(encoder, tok, max_tokens=LONG_MAX_TOKENS)
    require(embedder.seq_buckets[-3:] == (2048, 4096, 8192), "whole-document bucket ladder")
    cross = CrossEncoderReranker(reranker, tok)
    rng = np.random.default_rng(seed + 5)
    vocab = [f"w{i}" for i in rng.permutation(50_000)[:20_000]]

    # one 8,192-token document through the encoder, kernel against twin: a
    # check that the kernel runs inside the encoder, not a test of attention
    # (random weights pull whole-document embeddings together; the flash
    # phase holds the kernel to the twin)
    doc = " ".join(rng.choice(vocab, LONG_MAX_TOKENS - 2))
    tb = tok.batch([doc], LONG_MAX_TOKENS, embedder.seq_buckets)
    require(tb.input_ids.shape == (1, LONG_MAX_TOKENS), "an 8,192-token document")
    ids = torch.as_tensor(tb.input_ids, device=dev)
    mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode():
        got = pooled_embeddings(encoder, ids, mask)
        encoder_module.flash_attention = flash_attention_plain
        try:
            want = pooled_embeddings(encoder, ids, mask)
        finally:
            encoder_module.flash_attention = flash_attention
        forward_ms = cuda_ms(torch, lambda: pooled_embeddings(encoder, ids, mask), runs=3)
    cosine = float((got * want).sum())
    emit("encoder_8192", cosine_kernel_vs_plain=cosine, forward_ms=forward_ms)
    require(cosine >= COSINE_MIN, f"pooled cosine {cosine} >= {COSINE_MIN}")

    index = VectorIndex(dim=DIM, capacity=CAPACITY, dtype="f32x2", device=dev,
                        token_width=TOKEN_WIDTH)
    oracle = torch.zeros((CAPACITY, DIM), dtype=torch.float32, device=dev)
    lengths = long_lengths(rng)
    docs = [" ".join(rng.choice(vocab, n)) for n in lengths]

    # the main path, counted from here: ingest, one document per embed call
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embed_s, tokens, padded = 0.0, 0, 0
    for i, text in enumerate(docs):
        t1 = time.perf_counter()
        vec = embedder.embed([text])
        embed_s += time.perf_counter() - t1
        width = tok.batch([text], LONG_MAX_TOKENS, embedder.seq_buckets).input_ids.shape[1]
        tokens += lengths[i] + 2
        padded += width
        tb = tok.batch([text], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
        rows = index.add_chunks([f"long{i}:0"], vec, f"long{i}",
                                token_ids=tb.input_ids, token_mask=tb.attention_mask)
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(torch.as_tensor(vec, device=dev))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    flash_launches = flash_attention.launches
    require(flash_launches == len(docs) * cfg.layers,
            f"every layer of every document ran the flash kernel: {flash_launches}")
    emit("ingest_long", docs=len(docs), buckets=sorted(set(embedder.seq_buckets[-3:])),
         tokens=tokens, padded_tokens=padded, embed_s=embed_s, ingest_s=ingest_s,
         docs_per_s=len(docs) / ingest_s, tokens_per_s=tokens / embed_s,
         flash_launches=flash_launches)

    # seeded unit vectors with random token rows up to LIVE_ROWS
    positions = torch.arange(TOKEN_WIDTH, device=dev)
    n_src = 0
    t0 = time.perf_counter()
    while index.size < LIVE_ROWS:
        n = min(BLOCK, LIVE_ROWS - index.size)
        v = torch.randn((n, DIM), generator=gen, device=dev)
        lens = torch.randint(8, TOKEN_WIDTH + 1, (n, 1), generator=gen, device=dev)
        tmask = (positions[None, :] < lens).to(torch.int32)
        tids = torch.randint(3, cfg.vocab_size, (n, TOKEN_WIDTH), generator=gen, device=dev,
                             dtype=torch.int32)
        tids = torch.where(tmask.bool(), tids, tok.pad_id)
        tids[:, 0] = tok.cls_id
        rows = index.add_chunks([f"rand{n_src}:{i}" for i in range(n)], v, f"rand{n_src}",
                                token_ids=tids, token_mask=tmask)
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(v)
        n_src += 1
    gone = len(docs) // 2
    require(index.delete_source(f"long{gone}") == 1, "delete_source removed the document")
    torch.cuda.synchronize()
    require(index.size == LIVE_ROWS - 1, f"live rows {index.size}")
    emit("ingest_vectors", seconds=time.perf_counter() - t0, live_rows=index.size,
         capacity=CAPACITY, dtype=index.dtype,
         device_mem_gb=torch.cuda.memory_allocated(dev) / 1e9)

    # serve_f32x2: phrases cut from the documents (the deleted one's too)
    picks = rng.integers(0, len(docs), REQUESTS)
    queries = []
    for j in picks:
        words = docs[j].split()
        at = int(rng.integers(0, len(words) - 12))
        queries.append(" ".join(words[at : at + 12]))
    service = RetrievalService(index, embedder, cross, top_k=TOP_K, rerank_k=RERANK_K)
    require(service.fused, "the service runs the fused path")
    serve_burst(service, queries[:MAX_BATCH])  # warm-up: cuBLAS handles, allocator
    topk_float.launches = dict.fromkeys(topk_float.launches, 0)
    answers, wall_s = serve_burst(service, queries)
    scan_launches = topk_float.launches["f32x2"]
    require(scan_launches > 0, "the main path launched the f32x2 topk_float kernel")
    require(flash_attention.launches == flash_launches, "queries (64 tokens) ran einsum attention")
    check_answers(np, answers, {f"long{gone}:0"})
    emit("serve_f32x2", **latency_fields(answers, wall_s), topk_float_f32x2_launches=scan_launches)

    # the retrieval stage of one batch, against the plain path and fp32
    tb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode():
        state, _ = index.snapshot()
        tokens_state = index.tokens.state
        _, _, _, idx, vals = fused_query(
            encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
            tokens_state.ids, tokens_state.mask, top_k=TOP_K, rerank_k=RERANK_K,
        )
        q_emb = pooled_embeddings(encoder, q_ids, q_mask)
        pv, pi = topk_float_plain(split_f32_bf16x2(q_emb), state.vectors, TOP_K + 1,
                                  state.penalty, "f32x2")
        ov, oi = topk_plain(q_emb, oracle, TOP_K + 1, state.penalty)
        exact = torch.einsum("bkd,bd->bk", oracle[idx.long()], q_emb)  # fp32 scores of idx
        # the scan through VectorIndex.query for seeded unit queries, whose
        # exact top-12 is well separated, against fp32
        probe = unit_rows(torch, MAX_BATCH, gen, dev)
        probe_ids, _ = index.query(probe, TOP_K)
        _, probe_oi = topk_plain(probe, oracle, TOP_K, state.penalty)
        # fused_query's stages for this batch, median of 5 each: the encoder,
        # the scan, and the whole call (the rest is the token gather, the
        # cross-encoder and the final sort)
        stages = {
            "encode_ms": cuda_ms(torch, lambda: pooled_embeddings(encoder, q_ids, q_mask), runs=5),
            "scan_ms": cuda_ms(torch, lambda: cosine_topk(q_emb, state.vectors, TOP_K,
                                                          state.penalty), runs=5),
            "fused_ms": cuda_ms(torch, lambda: fused_query(
                encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                tokens_state.ids, tokens_state.mask, top_k=TOP_K, rerank_k=RERANK_K), runs=5),
        }
        stages["gather_rerank_ms"] = stages["fused_ms"] - stages["encode_ms"] - stages["scan_ms"]
    mismatches = tie_aware_mismatches(vals, idx, pv, pi, FLOAT_TOL)
    err = float((vals - pv[:, :TOP_K]).abs().max())
    hits = [len(set(a) & set(b[:TOP_K])) for a, b in zip(idx.tolist(), oi.tolist())]
    recall = sum(hits) / (TOP_K * len(hits))
    # random weights pull whole-document embeddings to within ~1e-6 of one
    # another, below f32x2's rounding: a row within FLOAT_TOL of the exact
    # 12th score is a tie there, and counts as a hit
    tie_recall = float((exact >= ov[:, TOP_K - 1 : TOP_K] - FLOAT_TOL).float().mean())
    row_of = index.snapshot()[1]
    probe_hits = [len(set(a) & {str(row_of[r]) for r in b})
                  for a, b in zip(probe_ids, probe_oi.tolist())]
    probe_recall = sum(probe_hits) / (TOP_K * len(probe_hits))
    emit("retrieval_f32x2", batch=len(hits), recall_at_12=recall,
         tie_aware_recall_at_12=tie_recall, vector_query_recall_at_12=probe_recall,
         mismatches_vs_plain=mismatches, max_abs_err_vs_plain=err,
         min_oracle_gap_12_13=float((ov[:, TOP_K - 1] - ov[:, TOP_K]).min()),
         stages=stages)
    require(mismatches == 0, "fused top-12 equals the plain path's (tie-aware)")
    require(recall >= RECALL_MIN, f"recall@12 {recall} >= {RECALL_MIN}")
    require(tie_recall >= RECALL_MIN, f"tie-aware recall@12 {tie_recall} >= {RECALL_MIN}")
    require(probe_recall >= RECALL_MIN, f"vector-query recall@12 {probe_recall} >= {RECALL_MIN}")
    return {"flash_launches": flash_attention.launches, "scan_launches": scan_launches}


def paged_case(torch, dev, g, b: int, t: int, kv: str, pos=None):
    """Seeded inputs of ``paged_attention`` at the decoder's shape: scattered
    page ids from a pool of KV_PAGES pages, row lengths from 1 to 2,047, and
    (at b > 2) inactive rows whose table is all 0."""
    from outline_rag_tpu_torch.testing import paged_attention_case

    return paged_attention_case(
        dev, g, b, t, kv, heads=DEC_HEADS, kv_heads=DEC_KV_HEADS, hd=DEC_HD, page=PAGE,
        maxp=MAXP, pages=KV_PAGES, pos=pos, inactive_every=7 if b > 2 else 0)


def paged_bound(b, t, kv, pos) -> dict:
    """What this run's rows need: each live K and V slot (and its scales)
    read once, q read and the output written once; 4 * H * Dh flops a slot
    a query position (slots past a position are masked but computed only up
    to the horizon: count the causal triangle)."""
    slots = [min(int(p) + t, MAXP * PAGE) for p in pos.tolist()]
    elem = 1 if kv == "int8" else 2
    moved = sum(slots) * DEC_KV_HEADS * 2 * (DEC_HD * elem + (4 if kv == "int8" else 0))
    moved += 2 * b * t * DEC_HEADS * DEC_HD * 2 + b * (MAXP + 1) * 4
    seen = sum(sum(min(int(p) + i + 1, MAXP * PAGE) for i in range(t)) for p in pos.tolist())
    return bound(moved, 4 * DEC_HEADS * DEC_HD * seen, "bf16")


def kernel_paged_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    from outline_rag_tpu_torch.testing import (
        SPLIT_BOUNDARY_POSITIONS,
        flash_errors,
        split_boundary_mismatches,
    )

    g = torch.Generator(device=dev).manual_seed(seed + 6)
    out = {}
    for kv in ("bf16", "int8"):
        atol, ulps, rel_rms = PAGED_BOUNDS[kv]
        # (8, 4): the verify window of speculative decoding at spec_k = 3
        cases = [(1, 1, None), (8, 1, None), (64, 1, None), (8, 4, None), (1, 256, [0]),
                 (1, 256, [512])]
        max_err = 0.0
        for b, t, pos in cases:
            args = paged_case(torch, dev, g, b, t, kv, pos)
            got = paged_attention(*args)
            torch.cuda.synchronize()
            again = paged_attention(*args)
            plain = paged_attention_plain(*args)
            row = {"pool": kv, "B": b, "T": t, "mean_len": float(args[4].float().mean()) + t,
                   **flash_errors(got, plain, atol, ulps),
                   "bit_equal_rerun": bool(torch.equal(got, again))}
            max_err = max(max_err, row["max_abs_err"])
            require(row["worst_vs_bound"] <= 1.0 and row["rel_rms_err"] <= rel_rms,
                    f"paged kernel within {atol} + {ulps} ulps, error norm within {rel_rms}: {row}")
            require(row["bit_equal_rerun"], f"two runs on the same inputs are bit-equal: {row}")
            require(bool(torch.isfinite(got.float()).all()), "inactive rows give finite numbers")
            emit("kernel_paged", **row)
        mismatches = split_boundary_mismatches(paged_attention, dev, g, kv)
        emit("kernel_paged", pool=kv, split_boundary_positions=list(SPLIT_BOUNDARY_POSITIONS),
             split_boundary_mismatches=mismatches)
        require(not mismatches, f"split-boundary positions are bit-equal across T and batch: "
                                f"{mismatches}")
        # timed at the shapes the main path launches: a decode step of B = 64
        # rows of lengths 1-2,047, a speculative window (B = 8, T = 4) and a
        # prefill chunk (B = 1, T = 256 from 512)
        lens = torch.randint(1, MAXP * PAGE, (DEC_SLOTS,), generator=g, device=dev)
        args = paged_case(torch, dev, g, DEC_SLOTS, 1, kv, lens - 1)
        spec = paged_case(torch, dev, g, 8, 4, kv)
        pre = paged_case(torch, dev, g, 1, 256, kv, [512])
        for a in (args, spec):  # every row active
            rows = a[3].shape[0]
            a[3][:] = (torch.randperm(KV_PAGES - 1, generator=g, device=dev)[: rows * MAXP]
                       + 1).reshape(rows, MAXP)
        # the pool is 268 MB and a step's live slots some 65 MB: past the L2 cache as it is
        row = {"pool": kv, "B": DEC_SLOTS, "T": 1, "mean_len": float(lens.float().mean()),
               **both_ms(torch, lambda: paged_attention(*args)),
               "plain_ms": cuda_ms(torch, lambda: paged_attention_plain(*args)),
               **paged_bound(DEC_SLOTS, 1, kv, args[4])}
        for label, (b, t, a) in (("spec_window", (8, 4, spec)), ("prefill_256", (1, 256, pre))):
            timed = both_ms(torch, lambda: paged_attention(*a))
            bnd = paged_bound(b, t, kv, a[4])
            row.update({f"{label}_ms": timed["ms"], f"{label}_device_ms": timed["device_ms"],
                        f"{label}_bound_ms": bnd["bound_ms"], f"{label}_bound_by": bnd["bound_by"]})
        emit("kernel_paged", **row)
        out[kv] = {"max_abs_err": max_err, **row}
        del args, spec, pre
        torch.cuda.empty_cache()
    return out


def kv_prologue_bound(b: int, t: int, kv: str) -> dict:
    """What one launch of ``paged_kv_write_rope`` must move at the decoder's
    shape in bf16: q read and written, k and v read, their pool rows (and an
    int8 pool's scales) written, the cos and sin tables, the page table and
    the positions read once; its operations: six f32 flops a rotated pair,
    three a quantized element."""
    rows, pool = b * t, 1 if kv == "int8" else 2
    moved = rows * (2 * DEC_HEADS * DEC_HD * 2 + 2 * DEC_KV_HEADS * DEC_HD * (2 + pool)
                    + (2 * DEC_KV_HEADS * 4 if kv == "int8" else 0) + 2 * DEC_HD // 2 * 4)
    ops = rows * ((DEC_HEADS + DEC_KV_HEADS) * DEC_HD // 2 * 6
                  + (2 * DEC_KV_HEADS * DEC_HD * 3 if kv == "int8" else 0))
    return bound(moved + b * (MAXP + 1) * 4, ops, "f32")


def kernel_kv_write_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.paged_attention import (
        paged_kv_write,
        paged_kv_write_plain,
        paged_kv_write_rope,
        paged_kv_write_rope_plain,
    )
    from outline_rag_tpu_torch.testing import kv_prologue_case, kv_prologue_mismatches

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    out = {}
    for kv in ("bf16", "int8"):
        dt = torch.int8 if kv == "int8" else torch.bfloat16
        shape = (KV_PAGES, DEC_KV_HEADS, PAGE, DEC_HD)

        def draw(*sh):
            return torch.randint(-127, 128, sh, generator=g, device=dev).to(dt)

        # the JAX package's signature (entries already rotated and quantized):
        # (B, T, start): decode at 64 rows; a prefill chunk straddling pages; a
        # chunk whose tail passes the row's capacity (2,048) by 100 tokens
        for b, t, start in ((DEC_SLOTS, 1, None), (8, 4, None), (1, 256, 100),
                            (2, 256, MAXP * PAGE - 156)):
            pools = [draw(*shape), draw(*shape)]
            new = [draw(b, t, DEC_KV_HEADS, DEC_HD), draw(b, t, DEC_KV_HEADS, DEC_HD)]
            table = (torch.randperm(KV_PAGES - 1, generator=g, device=dev)[: b * MAXP] + 1)
            table = table.reshape(b, MAXP).to(torch.int32)
            pos = (torch.randint(0, MAXP * PAGE - t, (b,), generator=g, device=dev)
                   if start is None else torch.full((b,), start, device=dev)).to(torch.int32)
            scales = []
            if kv == "int8":
                scales = [torch.rand(sh, generator=g, device=dev) for sh in
                          (shape[:3], shape[:3], (b, t, DEC_KV_HEADS), (b, t, DEC_KV_HEADS))]
            want = paged_kv_write_plain(*(x.clone() for x in pools), table, pos, *new,
                                        *(x.clone() for x in scales))
            untouched = [x.clone() for x in pools]
            got = paged_kv_write(*pools, table, pos, *new, *scales)
            torch.cuda.synchronize()
            equal = all(torch.equal(a[1:], w[1:]) for a, w in zip(got, want))
            written = int((pools[0][1:] != untouched[0][1:]).any(dim=-1).sum())
            in_range = int(((pos.long()[:, None] + torch.arange(t, device=dev)) < MAXP * PAGE).sum())
            row = {"entry": "paged_kv_write", "pool": kv, "B": b, "T": t, "start": start,
                   "equal_but_page0": equal, "max_abs_err": 0.0 if equal else 1.0,
                   "rows_written": written, "rows_in_range": in_range * DEC_KV_HEADS}
            require(equal, f"every page but page 0 byte-equal to the twin's: {row}")
            # a new row can equal the old one by chance (1 in 255^64): allow none
            require(written == in_range * DEC_KV_HEADS,
                    f"exactly the in-range tokens landed outside page 0: {row}")
            if (b, t) == (DEC_SLOTS, 1):
                args = (*pools, table, pos, *new, *scales)
                elem = 1 if kv == "int8" else 2
                moved = 2 * 2 * b * t * DEC_KV_HEADS * (DEC_HD * elem + (4 if scales else 0))
                row.update(**both_ms(torch, lambda: paged_kv_write(*args)),
                           plain_ms=cuda_ms(torch, lambda: paged_kv_write_plain(*args)),
                           **bound(moved + b * (MAXP + 1) * 4, 0, "bf16"))
                out[kv] = row
            emit("kernel_kv_write", **row)
        del pools, new, want, untouched, got, args
        # the decoder's entry: q and k rotated, k and v quantized for an int8
        # pool and written, in one launch; q, k and v as views of a fused qkv
        # product or as tensors of their own
        rope, rope_err = {}, 0.0
        for b, t, start, fused in ((DEC_SLOTS, 1, None, True), (8, 4, None, False),
                                   (1, 256, 100, True), (2, 256, MAXP * PAGE - 156, False)):
            case = kv_prologue_case(
                dev, g, b, t, "int8" if kv == "int8" else "model", torch.bfloat16,
                heads=DEC_HEADS, kv_heads=DEC_KV_HEADS, hd=DEC_HD, page=PAGE, maxp=MAXP,
                pages=KV_PAGES, start=start, fused=fused)
            inputs = case[2:9]
            want = [x.clone() for x in case[:2] + case[9:]]
            want_q = paged_kv_write_rope_plain(*want[:2], *inputs, *want[2:])
            pools = [x.clone() for x in case[:2] + case[9:]]
            q_rot = paged_kv_write_rope(*pools[:2], *inputs, *pools[2:])
            torch.cuda.synchronize()
            differs = kv_prologue_mismatches(q_rot, pools, want_q, want)
            row = {"entry": "paged_kv_write_rope", "pool": kv, "B": b, "T": t, "start": start,
                   "fused_qkv": fused, "differs": differs,
                   "max_abs_err": float((q_rot.float() - want_q.float()).abs().max())}
            require(not differs, f"the prologue bit-equal to its twin: the rotated q, every page "
                                 f"but page 0, the scale bits: {row}")
            rope_err = max(rope_err, row["max_abs_err"])
            if t in (1, 256) and start != MAXP * PAGE - 156:
                # the twin is the eager prologue the kernel replaced: its
                # device time is what the card no longer spends
                def twin():
                    return paged_kv_write_rope_plain(*want[:2], *inputs, *want[2:])

                row.update(**both_ms(torch, lambda: paged_kv_write_rope(*pools[:2], *inputs,
                                                                        *pools[2:])),
                           plain_ms=cuda_ms(torch, twin),
                           plain_device_ms=cuda_ms_many(torch, twin)["device_ms"],
                           **kv_prologue_bound(b, t, kv))
                rope["decode" if t == 1 else "chunk"] = row
            emit("kernel_kv_write", **row)
        out[kv]["rope"] = rope
        out[kv]["rope_max_abs_err"] = rope_err
        del case, inputs, want, pools, q_rot
        torch.cuda.empty_cache()
    return out


def kernel_int8_linear_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_plain,
        quantize_linear_weight,
    )
    from outline_rag_tpu_torch.testing import flash_errors
    from outline_rag_tpu_torch.tools.timing import cold_ring

    g = torch.Generator(device=dev).manual_seed(seed + 8)
    shapes = [(64, 2048, 2560), (64, 2048, 2048), (64, 2048, 11264), (64, 5632, 2048),
              (64, 2048, 32000), (8, 2048, 2560), (8, 2048, 32000),
              # a 256-token prefill chunk at one row: M = 256 on all five widths
              (256, 2048, 2560), (256, 2048, 2048), (256, 2048, 11264), (256, 5632, 2048),
              (256, 2048, 32000)]
    out, max_err = {}, 0.0
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        q, s = quantize_linear_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
        got = int8_linear(x, q, s)
        torch.cuda.synchronize()
        plain = int8_linear_plain(x, q, s)
        errs = flash_errors(got, plain, 1e-5 * float(plain.abs().max()), 1.0)
        max_err = max(max_err, errs["max_abs_err"])
        w_deq = (q.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None])  # the yardstick's weight
        # device_ms: many launches over a ring of weights, each found cold as in a decode step
        ring, lib_ring = cold_ring(q, s), cold_ring(w_deq)
        library = both_ms(torch, lambda: torch.nn.functional.linear(x, w_deq),
                          lambda: torch.nn.functional.linear(x, next(lib_ring)[0]))
        row = {"M": m, "K": k, "N": n, **errs,
               **both_ms(torch, lambda: int8_linear(x, q, s),
                         lambda: int8_linear(x, *next(ring))),
               "plain_ms": cuda_ms(torch, lambda: int8_linear_plain(x, q, s)),
               "library_ms": library["ms"], "library_device_ms": library["device_ms"],
               **bound(n * k + n * 4 + m * k * 2 + m * n * 2, 2 * m * n * k, "bf16")}
        del ring, lib_ring
        row["weight_gb_per_s"] = n * k / row["ms"] / 1e6
        require(errs["worst_vs_bound"] <= 1.0,
                f"int8_linear within 1e-5 of the output's scale + 1 bf16 ulp of the twin: {row}")
        if m == 256:
            require(bool(torch.equal(int8_linear(x[:8], q, s), got[:8])),
                    f"int8_linear: 8 rows alone are bit-equal to the same rows at M = 256: {row}")
        emit("kernel_int8_linear", **row)
        out[(m, k, n)] = row

    def step(m: int, key: str) -> float:
        """A forward's 89 projections: 22 layers of q/k/v, o, gate/up and
        down, and the lm_head."""
        layer = ((2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048))
        return 22 * sum(out[(m, k, n)][key] for k, n in layer) + out[(m, 2048, 32000)][key]

    steps = {f"{name}_m{m}": step(m, key) for m in (64, 256)
             for name, key in (("step_device_ms", "device_ms"),
                               ("step_library_device_ms", "library_device_ms"))}
    emit("kernel_int8_linear", **steps)
    return {"max_abs_err": max_err, **out[(64, 2048, 11264)], **steps, "by_shape": {
        f"{m}x{k}x{n}": {key: out[(m, k, n)][key] for key in (
            "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")}
        for m, k, n in shapes}}


INT4_SHAPES = [  # (K, N, group size): TinyLlama's projections, two 7B ones, wider groups
    (2048, 2560, 128), (2048, 2048, 128), (2048, 11264, 128), (5632, 2048, 128),
    (2048, 32000, 128), (4096, 22016, 128), (11008, 4096, 128),
    (2048, 2560, 256), (2048, 2560, 512),
]
INT4_MS, INT4_TIMED_M = (1, 8, 32, 64, 256), 32
INT4_TOL = 1e-5  # of the output's scale, plus as much relative


def kernel_int4_phase(torch, dev, seed: int) -> dict:
    import outline_rag_tpu_torch.models.decoder as decoder
    import outline_rag_tpu_torch.ops.int4_linear as int4
    from outline_rag_tpu_torch.testing import QUANTIZER_TIE_CODES, quantizer_rows, scaled_errors
    from outline_rag_tpu_torch.tools.timing import cold_ring

    g = torch.Generator(device=dev).manual_seed(seed + 12)
    # the row quantizer against its twin: codes and scale bits, byte for byte
    quant_cases, quant_err, quant_scale_bits = 0, 0, 0
    for k in sorted({k for k, _, _ in INT4_SHAPES}):
        for dtype in (torch.bfloat16, torch.float32):
            for m in INT4_MS:
                x = quantizer_rows(dev, g, m, k, dtype)
                xq, xs = int4.quantize_rows(x)
                torch.cuda.synchronize()
                want_q, want_s = int4._quantize_activations(x)
                quant_err = max(quant_err, int((xq.int() - want_q.int()).abs().max()))
                quant_scale_bits += int((xs.view(torch.int32) != want_s.view(torch.int32)).sum())
                require(bool(torch.equal(xq, want_q)
                             and torch.equal(xs.view(torch.int32), want_s.view(torch.int32))),
                        f"quantize_rows is byte-equal to its twin at M={m} K={k} {dtype}: "
                        f"{int((xq != want_q).sum())} codes differ")
                floor = torch.tensor(1e-12, dtype=torch.float32, device=dev)
                require(bool(xs[0, 0] == floor) and not bool(xq[0].any()),
                        "a row of zeros has the scale's floor and codes 0")
                if m > 3:
                    require(float(xs[2, 0]) == 1.0 and xq[2, :8].tolist() == QUANTIZER_TIE_CODES,
                            f"exact .5 ties round to even: {xq[2, :8].tolist()}")
                    require(int(xq[1].min()) == -127 and int(xq[1].max()) <= 0,
                            "a row with a negative maximum reaches -127")
                quant_cases += 1
    emit("kernel_int4", quantize_rows_cases=quant_cases, max_abs_code_err=quant_err,
         scales_with_other_bits=quant_scale_bits)
    kernels = {
        "w4a8": (lambda x, q4, s4: int4.w4a8_matmul(x.to(torch.bfloat16), q4, s4),
                 lambda x, q4, s4: int4.w4a8_matmul_plain(x.to(torch.bfloat16), q4, s4)),
        "w4a16_bf16": (lambda x, q4, s4: int4.w4a16_matmul(x.to(torch.bfloat16), q4, s4),
                       lambda x, q4, s4: int4.w4a16_matmul_plain(x.to(torch.bfloat16), q4, s4)),
        "w4a16_f32": (lambda x, q4, s4: int4.w4a16_matmul(x, q4, s4),
                      lambda x, q4, s4: int4.w4a16_matmul_plain(x, q4, s4)),
    }
    out, max_err = {}, dict.fromkeys(kernels, 0.0)
    for k, n, gsz in INT4_SHAPES:
        w = torch.randn((k, n), generator=g, device=dev) * 0.02
        q4, s4 = int4.quantize_int4_weight(w, gsz)
        w_deq = int4._dequant(q4, s4, torch.bfloat16)  # the yardstick's weight, [N, K] bf16
        del w
        x = torch.randn((max(INT4_MS), k), generator=g, device=dev)
        row = {"K": k, "N": n, "group_size": gsz}
        for name, (kernel, twin) in kernels.items():
            worst, at_32 = 0.0, None
            for m in INT4_MS:
                got = kernel(x[:m], q4, s4)
                torch.cuda.synchronize()
                errs = scaled_errors(got, twin(x[:m], q4, s4), INT4_TOL)
                worst = max(worst, errs["worst_vs_bound"])
                max_err[name] = max(max_err[name], errs["max_abs_err"])
                require(errs["worst_vs_bound"] <= 1.0,
                        f"{name} within {INT4_TOL} of scale + {INT4_TOL} relative of its twin at "
                        f"M={m} {row}: {errs}")
                require(bool(torch.equal(got, kernel(x[:m], q4, s4))),
                        f"{name}: two runs are bit-equal at M={m} {row}")
                if name == "w4a8":
                    require(errs["max_abs_err"] == 0.0,
                            f"w4a8 is bit-equal to its twin at M={m} {row}: {errs}")
                    xb = x[:m].to(torch.bfloat16)
                    require(bool(torch.equal(int4._w4a8_matmul_as(xb, q4, s4, torch.bfloat16),
                                             got.to(torch.bfloat16))),
                            f"w4a8: the bf16 epilogue equals the f32 result rounded once at "
                            f"M={m} {row}")
                if name == "w4a16_bf16":
                    xb = x[:m].to(torch.bfloat16)
                    require(bool(torch.equal(int4._w4a16_matmul_as(xb, q4, s4, torch.bfloat16),
                                             got.to(torch.bfloat16))),
                            f"w4a16: the bf16 epilogue equals the f32 result rounded once at "
                            f"M={m} {row}")
                at_32 = got if m == 32 else at_32
            for r in (0, 31):
                require(bool(torch.equal(kernel(x[r : r + 1], q4, s4)[0], at_32[r])),
                        f"{name}: row {r} at M = 1 is bit-equal to itself inside M = 32 {row}")
            row[f"{name}_worst_vs_bound"] = worst
        # times at M = 32 (the wrappers as the decoder calls them), the plain
        # twins, the library yardstick and the grouped product beside them
        xb = x[:INT4_TIMED_M].to(torch.bfloat16)
        m = INT4_TIMED_M
        xq, xs = (t.contiguous() for t in int4._quantize_activations(xb))
        raw = torch.empty((m, n), dtype=torch.float32, device=dev)
        launch = int4._launcher("w4a8")

        def kernel_only(wq, ws):  # rows quantized beforehand (no count: not the wrapper)
            launch(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(), raw.data_ptr(), 0,
                   m, n, k, gsz, torch.cuda.current_stream(dev).cuda_stream)

        # ms: one launch through the wrapper between two events, what the decoder
        # pays today; device_ms: many launches over a ring of weights, each found
        # cold as in a decode step (the ring spans three times the L2 cache)
        ring, lib_ring = cold_ring(q4, s4), cold_ring(w_deq)
        as_decoder = both_ms(torch, lambda: int4._w4a8_matmul_as(xb, q4, s4, torch.bfloat16),
                             lambda: int4._w4a8_matmul_as(xb, *next(ring), torch.bfloat16))
        alone = both_ms(torch, lambda: kernel_only(q4, s4), lambda: kernel_only(*next(ring)))
        quantizer = both_ms(torch, lambda: int4.quantize_rows(xb))
        a16 = both_ms(torch, lambda: int4._w4a16_matmul_as(xb, q4, s4, torch.bfloat16),
                      lambda: int4._w4a16_matmul_as(xb, *next(ring), torch.bfloat16))
        library = both_ms(torch, lambda: torch.nn.functional.linear(xb, w_deq),
                          lambda: torch.nn.functional.linear(xb, next(lib_ring)[0]))
        del ring, lib_ring
        row.update(
            # quantize + product, two launches, bf16 out: a projection of the decoder
            w4a8_ms=as_decoder["ms"], w4a8_device_ms=as_decoder["device_ms"],
            w4a8_queued_ms=as_decoder["queued_ms"],
            w4a8_kernel_only_ms=alone["ms"], w4a8_kernel_only_device_ms=alone["device_ms"],
            quantize_rows_ms=quantizer["ms"], quantize_rows_device_ms=quantizer["device_ms"],
            quantize_rows_plain_ms=cuda_ms(torch, lambda: int4._quantize_activations(xb)),
            w4a8_plain_ms=cuda_ms(torch, lambda: int4.w4a8_matmul_plain(xb, q4, s4)),
            w4a16_ms=a16["ms"], w4a16_device_ms=a16["device_ms"],
            w4a16_plain_ms=cuda_ms(
                torch, lambda: int4._w4a16_matmul_as_plain(xb, q4, s4, torch.bfloat16)),
            library_ms=library["ms"], library_device_ms=library["device_ms"],
        )
        read = n * k // 2 + s4.numel() * 4 + m * k * 2  # q4, s4 and the bf16 rows
        # the calls timed above write bf16, the decoder's epilogue
        row["w4a8_bound"] = bound(read + m * n * 2, 2 * m * n * k, "int8")
        row["w4a16_bound"] = bound(read + m * n * 2, 2 * m * n * k, "bf16")
        row["quantize_rows_bound"] = bound(m * k * 2 + m * k + m * 4, 4 * m * k, "f32")
        row["w4a8_weight_gb_per_s"] = n * k / 2 / row["w4a8_kernel_only_device_ms"] / 1e6
        mode = decoder._INT4_MODE
        decoder._INT4_MODE = "xla"  # the grouped product at every M
        try:
            for gm in (32, 64, 128):
                xg = x[:gm].to(torch.bfloat16)
                row[f"grouped_ms_m{gm}"] = cuda_ms(
                    torch, lambda: decoder._mm_int4(xg, q4, s4, torch.bfloat16), runs=5)
        finally:
            decoder._INT4_MODE = mode
        for gm in (64, 128):
            xg = x[:gm].to(torch.bfloat16)
            row[f"w4a8_ms_m{gm}"] = cuda_ms(torch, lambda: int4.w4a8_matmul(xg, q4, s4), runs=5)
        emit("kernel_int4", **row)
        out[(k, n, gsz)] = row
        del q4, s4, w_deq, x
        torch.cuda.empty_cache()
    top = out[(2048, 11264, 128)]  # the gate/up projection, as for int8_linear
    max_err["quantize_rows"] = float(quant_err)
    return {"max_abs_err": max_err, "quantize_rows_scales_with_other_bits": quant_scale_bits,
            "top": top, "by_shape": {
        f"{k}x{n}g{gsz}": {key: r[key] for key in (
            "w4a8_ms", "w4a8_device_ms", "w4a8_kernel_only_device_ms", "quantize_rows_device_ms",
            "w4a16_ms", "w4a16_device_ms", "library_ms", "library_device_ms", "grouped_ms_m32")}
        for (k, n, gsz), r in out.items()}}


def kernel_int4_floor_phase(torch, dev, seed: int) -> dict:
    import outline_rag_tpu_torch.ops.int4_linear as int4
    from outline_rag_tpu_torch.tools.bench_int4_kernel import bench_shape

    g = torch.Generator(device=dev).manual_seed(seed + 13)
    shapes = [(k, n) for k, n, gsz in INT4_SHAPES if gsz == 128]
    plain_ms, value_err, folds_differ = {}, 0.0, 0
    for k, n in shapes:
        q4 = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
        x = torch.randn((INT4_TIMED_M, k), generator=g, device=dev).to(torch.bfloat16)
        value, fold = int4.int4_stream_floor(x, q4)
        torch.cuda.synchronize()
        want_value, want_fold = int4.int4_stream_floor_plain(x, q4)
        value_err = max(value_err, float((value - want_value).abs().max()))
        folds_differ += int((fold != want_fold).sum())
        require(bool(torch.equal(value, want_value) and torch.equal(fold, want_fold)),
                f"int4_stream_floor equals its twin exactly at K={k} N={n}")
        plain_ms[(k, n)] = cuda_ms(torch, lambda: int4.int4_stream_floor_plain(x, q4), runs=5)
    # the tool's run is the floor's main path: counted from here
    int4.int4_stream_floor.launches = 0
    out = {}
    for k, n in shapes:
        row = bench_shape(f"{k}x{n}", k, n, INT4_TIMED_M, dev)
        row.update(floor_plain_ms=plain_ms[(k, n)],
                   **bound(n * k // 2 + 2 + n * 8, 0, "int8"))  # q4, x[0, 0]; value and fold out
        row["floor_share_of_memory_rate"] = row["bound_ms"] / row["floor_device_ms"]
        emit("kernel_int4_floor", **row)
        out[(k, n)] = row
    launches = int4.int4_stream_floor.launches
    require(launches > 0, "the int4 tool launched the int4_stream_floor kernel")
    return {"launches": launches, "max_abs_err": value_err, "folds_that_differ": folds_differ,
            **out[(2048, 11264)], "by_shape": {
        f"{k}x{n}": {v: (r[f"{v}_ms"], r[f"{v}_device_ms"]) for v in
                     ("floor", "w4a16", "w4a8", "int8")}
        for (k, n), r in out.items()}}


def chat_messages(rng, system: str, vocab: list[str], n_tokens: int) -> list[dict]:
    """A chat whose rendered prompt is about ``n_tokens`` bytes long."""
    words, size = [], 0
    while size < n_tokens:
        words.append(str(rng.choice(vocab)))
        size += len(words[-1]) + 1
    user = " ".join(words)[: max(8, n_tokens)]
    head = [{"role": "system", "content": system}] if system else []
    return head + [{"role": "user", "content": user}]


def stream_burst(provider, chats: list[tuple[list[dict], float]]):
    """Every chat at once through ``provider.stream``:
    ([(text, seconds to the first delta, seconds)], wall seconds)."""

    async def one(messages, temperature):
        t0 = time.perf_counter()
        first, parts = None, []
        async for delta in provider.stream("local", messages, temperature=temperature, top_p=0.9):
            if first is None:
                first = time.perf_counter() - t0
            parts.append(delta["content"])
        return "".join(parts), first, time.perf_counter() - t0

    async def burst():
        t0 = time.perf_counter()
        got = await asyncio.wait_for(asyncio.gather(*(one(m, t) for m, t in chats)), 600)
        return got, time.perf_counter() - t0

    return asyncio.run(burst())


def logits_kernels_vs_twins(torch, dev, decoder, params, cfg, kv_dtype, seed: int) -> dict:
    """One prefill (4 rows x 64 tokens) and one decode forward through a
    small pool at the model's full depth three ways: with the kernels; with
    the page write's plain twin alone patched in (the prologue is bit-equal
    to it, so the logits must be too); with every plain twin patched in (the
    error's norm over the logits' norm, the larger of the two forwards)."""
    import outline_rag_tpu_torch.ops.paged_attention as pa
    from outline_rag_tpu_torch.ops.int8_linear import int8_linear_plain
    from outline_rag_tpu_torch.ops.paged_attention import (
        paged_attention_plain,
        paged_kv_write_rope_plain,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(3, cfg.vocab_size, (4, 64), generator=g, device=dev)
    step = torch.randint(3, cfg.vocab_size, (4, 1), generator=g, device=dev)

    def run(patches: dict):
        # patches: (module, name) -> twin; the decoder walks its pages through
        # ops/paged_attention.py's sharded wrappers (one shard here), which
        # call that module's kernels
        n = 4 * (cfg.max_cache // PAGE)  # every row's pages, scattered (7 and n are coprime)
        cache = decoder.init_paged_cache(cfg, 4, n + 1, PAGE, kv_dtype=kv_dtype, device=dev)
        cache.table[:] = (torch.arange(n, device=dev) * 7 % n + 1).reshape(4, -1)
        kept = {key: getattr(*key) for key in patches}
        for (module, name), fn in patches.items():
            setattr(module, name, fn)
        try:
            with torch.inference_mode():
                a, _ = decoder.decoder_forward(
                    params, toks, cache, torch.zeros(4, dtype=torch.int32, device=dev), cfg)
                b, _ = decoder.decoder_forward(
                    params, step, cache, torch.full((4,), 64, dtype=torch.int32, device=dev), cfg)
            return a, b
        finally:
            for (module, name), fn in kept.items():
                setattr(module, name, fn)

    prologue_twin = {(pa, "paged_kv_write_rope"): paged_kv_write_rope_plain}
    got = run({})
    prologue = run(prologue_twin)
    want = run({**prologue_twin, (pa, "paged_attention"): paged_attention_plain,
                (decoder, "int8_linear"): int8_linear_plain})
    rel = max(float((a - w).norm() / w.norm()) for a, w in zip(got, want))
    worst = max(float((a - w).abs().max()) for a, w in zip(got, want))
    require(all(bool(torch.isfinite(a).all()) and a.shape[-1] == cfg.vocab_size for a in got),
            "finite logits over the vocabulary")
    bit_equal = all(torch.equal(a, w) for a, w in zip(got, prologue))
    require(bit_equal, f"the prefill and decode logits with the page-write kernel are bit-equal "
                       f"to those with its twin ({kv_dtype or cfg.dtype} pool)")
    return {"logits_rel_rms_vs_twins": rel, "logits_max_abs_err_vs_twins": worst,
            "logits_max_abs": float(want[0].abs().max()),
            "logits_bit_equal_vs_prologue_twin": bit_equal}


def int4_logits_check(torch, dev, decoder, params, cfg, seed: int) -> dict:
    """One 32-row decode step at the model's full depth, after a short
    prefill, three ways: as served; with the int4 kernels' plain twins
    patched into the decoder module (the paged kernels kept); with every
    twin patched in. The error's norm over the logits' norm."""
    import outline_rag_tpu_torch.ops.int4_linear as int4
    import outline_rag_tpu_torch.ops.paged_attention as pa
    from outline_rag_tpu_torch.ops.paged_attention import (
        paged_attention_plain,
        paged_kv_write_rope_plain,
    )

    rows = 32
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(3, cfg.vocab_size, (rows, 8), generator=g, device=dev)
    step = torch.randint(3, cfg.vocab_size, (rows, 1), generator=g, device=dev)
    n = rows * (cfg.max_cache // PAGE)

    def run(patches: dict):
        # patches: (module, name) -> twin; the paged kernels are patched in
        # ops/paged_attention.py, whose sharded wrappers the decoder calls
        cache = decoder.init_paged_cache(cfg, rows, n + 1, PAGE, device=dev)
        cache.table[:] = (torch.arange(n, device=dev) * 7 % n + 1).reshape(rows, -1)
        kept = {key: getattr(*key) for key in patches}
        for (module, name), fn in patches.items():
            setattr(module, name, fn)
        try:
            with torch.inference_mode():
                decoder.decoder_forward(
                    params, toks, cache, torch.zeros(rows, dtype=torch.int32, device=dev), cfg)
                out, _ = decoder.decoder_forward(
                    params, step, cache, torch.full((rows,), 8, dtype=torch.int32, device=dev), cfg)
            return out
        finally:
            for (module, name), fn in kept.items():
                setattr(module, name, fn)

    int4_twins = {(decoder, "_w4a8_matmul_as"): int4._w4a8_matmul_as_plain,
                  (decoder, "_w4a16_matmul_as"): int4._w4a16_matmul_as_plain}
    got = run({})
    want = run(int4_twins)
    every = run({**int4_twins, (pa, "paged_attention"): paged_attention_plain,
                 (pa, "paged_kv_write_rope"): paged_kv_write_rope_plain})
    require(bool(torch.isfinite(got).all()) and got.shape[-1] == cfg.vocab_size,
            "finite logits over the vocabulary")
    return {"logits_rel_rms_vs_int4_twins": float((got - want).norm() / want.norm()),
            "logits_rel_rms_vs_twins": float((got - every).norm() / every.norm()),
            "logits_bit_equal_vs_int4_twins": bool(torch.equal(got, want)),
            "logits_max_abs": float(want.abs().max())}


def spec_ceiling(torch, dev, decoder, params, cfg, seed: int) -> dict:
    """The all-accepted ceiling of speculative decoding: one chunk of
    ``generate_chunk_spec(force_accept=True)`` over 8 live rows at seeded
    lengths, every verify step emitting 1 + spec_k tokens whatever the model
    says. It changes the text and never serves; it says what a verify step
    would yield if every draft were right."""
    slots, spec_k = 8, 3
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = decoder.init_paged_cache(cfg, slots, slots * MAXP + 1, PAGE, device=dev)
    cache.table[:] = (torch.randperm(slots * MAXP, generator=g, device=dev) + 1).reshape(slots, MAXP)
    pos = torch.randint(256, 1500, (slots,), generator=g, device=dev).to(torch.int32)
    tok = torch.randint(3, cfg.vocab_size, (slots,), generator=g, device=dev).to(torch.int32)
    buf = torch.randint(3, cfg.vocab_size, (slots, cfg.max_cache), generator=g, device=dev).to(
        torch.int32)

    def chunk():
        return decoder.generate_chunk_spec(
            params, cache, buf, tok, pos, decoder.make_key(seed, dev), cfg, n_steps=DEC_CHUNK,
            draft_k=spec_k, temperature=0.0, top_p=1.0, eos_id=-1, force_accept=True)

    with torch.inference_mode():
        ms = cuda_ms(torch, chunk, runs=3)
        counts = chunk()[1]
    per_step = float(counts.float().mean()) / DEC_CHUNK
    require(per_step == spec_k + 1, f"force_accept emits {spec_k + 1} tokens a step: {per_step}")
    return {"label": "force_accept ceiling, not served", "slots": slots, "spec_k": spec_k,
            "verify_step_ms": ms / DEC_CHUNK, "tokens_per_step": per_step,
            "ceiling_tokens_per_s": slots * per_step / (ms / DEC_CHUNK) * 1e3}


def decode_profile(torch, dev, decoder, params, cfg, kv_dtype, seed: int,
                   slots: int = DEC_SLOTS) -> dict:
    """Decode steps with all ``slots`` rows live at seeded lengths of
    256-1,900 tokens (every row its own 16 pages), through
    ``generate_chunk``: milliseconds a step from CUDA events over one chunk,
    then one chunk under ``torch.profiler`` for the device's busy share, the
    launches a step and the kernels that take the device's time."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(seed)
    cache = decoder.init_paged_cache(cfg, slots, KV_PAGES, PAGE, kv_dtype=kv_dtype, device=dev)
    cache.table[:] = (torch.randperm(KV_PAGES - 1, generator=g, device=dev)[: slots * MAXP]
                      + 1).reshape(slots, MAXP)
    pos = torch.randint(256, 1900, (slots,), generator=g, device=dev).to(torch.int32)
    tok = torch.randint(3, cfg.vocab_size, (slots,), generator=g, device=dev).to(torch.int32)
    temp = torch.where(torch.arange(slots, device=dev) % 3 == 2, 0.8, 0.0)
    key = decoder.make_key(seed, dev)

    def chunk():
        return decoder.generate_chunk(params, cache, tok, pos, key, cfg, n_steps=DEC_CHUNK,
                                      temperature=temp, top_p=0.9, eos_id=-1)

    with torch.inference_mode():
        step_ms = cuda_ms(torch, chunk, runs=3) / DEC_CHUNK
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            kernels[e.key] = (us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    # the busy share is the kernels' time over the step's time without the
    # profiler (tracing slows the host, not the kernels); None: the profiler
    # saw no device activity here (not measured)
    return {"decode_step_ms": step_ms, "mean_len": float(pos.float().mean()),
            "profiled_wall_ms_per_step": wall_ms / DEC_CHUNK,
            "device_busy_share": busy_ms / DEC_CHUNK / step_ms if busy_ms else None,
            "device_ms_per_step": busy_ms / DEC_CHUNK if busy_ms else None,
            "launches_per_step": sum(n for _, n in kernels.values()) / DEC_CHUNK,
            "top_kernels_ms_per_step": {k[:60]: ms / DEC_CHUNK for k, (ms, _) in top}}


def decoder_phase(torch, dev, seed: int) -> dict:
    """The slice: concurrent chats at TinyLlama-1.1B width through the paged
    pool, in seven configurations: bf16, an int8 pool and int8 weights at 64
    slots; int4 weights through the w4a8 and the w4a16 kernel at 32 slots;
    speculative decoding with bf16 and with int4 weights at 8 slots."""
    import numpy as np

    import outline_rag_tpu_torch.models.decoder as decoder
    import outline_rag_tpu_torch.serve.decode_batcher as batcher_module
    from outline_rag_tpu_torch.ops.int4_linear import quantize_rows, w4a8_matmul, w4a16_matmul
    from outline_rag_tpu_torch.ops.int8_linear import int8_linear
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_kv_write
    from outline_rag_tpu_torch.serve import DONE, LocalChatProvider
    from outline_rag_tpu_torch.testing import ByteTokenizer

    require(decoder._INT8_MODE == "kernel", "DECODER_INT8_MODE=kernel was read at import")
    require(decoder._INT4_MODE == "w4a8", "DECODER_INT4_MODE=w4a8 was read at import")
    cfg = decoder.DecoderConfig.tinyllama_1b()
    t0 = time.perf_counter()
    params = decoder.init_decoder(cfg, torch.Generator(device=dev).manual_seed(seed + 9), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in [params["embed"], params["lm_head"]]
                   + [v for layer in params["layers"] for v in layer.values()])
    emit("decoder_init", params=n_params, seconds=time.perf_counter() - t0,
         device_mem_gb=torch.cuda.memory_allocated(dev) / 1e9)
    class CountingTokenizer(ByteTokenizer):
        """Remembers how many ids each stream has decoded so far (a stream
        decodes its one growing list), so a burst's tokens can be counted."""

        def __init__(self):
            self.lengths = {}

        def decode(self, ids):
            self.lengths[id(ids)] = len(ids)
            return super().decode(ids)

    tok = CountingTokenizer()
    rng = np.random.default_rng(seed + 9)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:5000]]
    system = " ".join(rng.choice(vocab, 200))[:504]  # "system: " + 504 bytes = 4 full pages

    # forwards by rows fed (B * T), and the int8 kernel's launches inside
    # them: the batcher's name serves prefill chunks and plain steps, the
    # decoder module's the speculative verify windows
    forwards: dict[int, int] = {}
    int8_by_rows: dict[int, int] = {}
    real_forward = batcher_module.decoder_forward

    def counted_forward(p, tokens, *args, **kwargs):
        rows, before = tokens.numel(), int8_linear.launches
        forwards[rows] = forwards.get(rows, 0) + 1
        try:
            return real_forward(p, tokens, *args, **kwargs)
        finally:
            int8_by_rows[rows] = int8_by_rows.get(rows, 0) + int8_linear.launches - before

    def patch_forward(fn):
        batcher_module.decoder_forward = decoder.decoder_forward = fn

    # (name, provider options, slots, chats, new tokens, DECODER_INT4_MODE)
    configs = [("bf16", {}, DEC_SLOTS, DEC_SLOTS, DEC_NEW, "w4a8"),
               ("kv_int8", {"kv_int8": True}, DEC_SLOTS, DEC_SLOTS, DEC_NEW, "w4a8"),
               ("int8_weights", {"int8_weights": True}, DEC_SLOTS, 16, 32, "w4a8"),
               ("int4_weights", {"int4_weights": True}, 32, 32, DEC_NEW, "w4a8"),
               ("int4_kernel", {"int4_weights": True}, 32, 8, DEC_NEW, "kernel"),
               ("spec", {"spec_k": 3}, 8, 8, DEC_NEW, "w4a8"),
               ("spec_int4", {"spec_k": 3, "int4_weights": True}, 8, 8, DEC_NEW, "w4a8")]
    out = {}
    shared_rng = rng  # the first three configurations draw their chats from one stream
    # each later pair serves the same chats (a burst of 8 is the first 8 of 32)
    pair_seed = {"int4_weights": 20, "int4_kernel": 20, "spec": 21, "spec_int4": 21}
    for name, kw, slots, n_chats, max_new, int4_mode in configs:
        # the mode is a module attribute read at import; switching it here is
        # what the CPU tests do (monkeypatch), undone at the end of the config
        decoder._INT4_MODE = int4_mode
        int4, spec_k = "int4_weights" in kw, kw.get("spec_k", 0)
        rows_fed = slots * (1 + spec_k)  # what one decode forward feeds
        rng = (np.random.default_rng(seed + pair_seed[name]) if name in pair_seed
               else shared_rng)
        provider = LocalChatProvider(
            params, cfg, tok, batch_slots=slots, kv_pages=KV_PAGES, page_size=PAGE,
            chunk_tokens=DEC_CHUNK, max_new_tokens=max_new, device=dev, **kw)
        b = provider._batcher
        if int4:
            check = int4_logits_check(torch, dev, decoder, provider.params, cfg, seed + 10)
            # w4a8 is bit-equal to its twin (exact integers, one f32 order); the
            # w4a16 kernel's f32 sums run in another order, which flips bf16
            # roundings through 22 layers like the other bf16 kernels'
            int4_bound = 0.0 if int4_mode == "w4a8" else LOGITS_REL_RMS
            require(check["logits_rel_rms_vs_int4_twins"] <= int4_bound
                    and check["logits_rel_rms_vs_twins"] <= INT4_LOGITS_REL_RMS,
                    f"{name}: logits with the int4 kernels within {int4_bound} of their twins', "
                    f"within {INT4_LOGITS_REL_RMS} with every twin: {check}")
        else:
            check = logits_kernels_vs_twins(
                torch, dev, decoder, provider.params, cfg, "int8" if kw.get("kv_int8") else None,
                seed + 10)
            require(check["logits_rel_rms_vs_twins"] <= LOGITS_REL_RMS,
                    f"{name}: logits with the kernels within {LOGITS_REL_RMS} of the twins': {check}")

        def make_chats():
            chats = []
            for i in range(n_chats):
                shared = i % 4 != 3  # 3 in 4 carry the system prefix
                n = int(rng.integers(600, 1500)) if shared else int(rng.integers(200, 500))
                messages = chat_messages(
                    rng, system if shared else "", vocab, n - (520 if shared else 20))
                chats.append((messages, 0.8 if i % 3 == 2 else 0.0))
            return chats, [len(provider._encode_prompt(provider._render(m))) for m, _ in chats]

        chats, prompt_tokens = make_chats()
        same_as_plain = None
        if spec_k:
            # the same chats without speculation, for the share of greedy
            # texts that come out equal (printed, not gated)
            plain = LocalChatProvider(
                params, cfg, tok, batch_slots=slots, kv_pages=KV_PAGES, page_size=PAGE,
                chunk_tokens=DEC_CHUNK, max_new_tokens=max_new, device=dev,
                **{k: v for k, v in kw.items() if k != "spec_k"})
            try:
                plain_answers, _ = stream_burst(plain, chats)
            finally:
                plain.close()
            del plain
            torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats(dev)
        patch_forward(counted_forward)
        forwards.clear()
        int8_by_rows.clear()
        paged_attention.launches = paged_kv_write.launches = int8_linear.launches = 0
        w4a8_matmul.launches = w4a16_matmul.launches = quantize_rows.launches = 0
        tok.lengths.clear()
        try:
            answers, wall_s = stream_burst(provider, chats)
            generated = sum(tok.lengths.values())
            launches = (paged_attention.launches, paged_kv_write.launches, int8_linear.launches,
                        w4a8_matmul.launches, w4a16_matmul.launches)
            quantizer_launches = quantize_rows.launches
            by_rows, int8_launches_by_rows = dict(forwards), dict(int8_by_rows)
            n_forwards = sum(by_rows.values())
            decode_forwards = by_rows.get(rows_fed, 0)
            stats = provider.stats()
            # after the burst: the first greedy chat again (its prefix pages are
            # cached now, its neighbours gone), and one prompt twice over
            # the batcher's own interface, cold then warm
            repeat, _ = stream_burst(provider, [chats[0]])
            fresh = [int(x) for x in rng.integers(3, 259, 700)]
            pair = []
            for _ in range(2):
                q, ids = b.submit(fresh, 0.0, 1.0, 32), []
                while (item := q.get(timeout=300)) is not DONE:
                    require(not isinstance(item, Exception), f"{name}: the batcher failed: {item!r}")
                    ids.extend(item)
                pair.append(ids)
            end = provider.stats()
            patch_forward(real_forward)

            # a second burst of new chats, outside the counts and the end-to-end
            # numbers, with the worker's two device programs timed where it
            # runs them; the synchronize calls take away the overlap of host
            # and device, so nothing end to end is read from this burst
            steps, prefills = [], []
            step_name = "_step_spec" if spec_k else "_step_chunk"
            real_step, real_prefill = getattr(b, step_name), b._prefill_paged

            def timed_step(*a, _real=real_step, _b=b):
                active = sum(r is not None for r in _b.active)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = _real(*a)
                torch.cuda.synchronize()
                steps.append((active, (time.perf_counter() - t) / DEC_CHUNK))
                return res

            def timed_prefill(table, toks, start, _real=real_prefill):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = _real(table, toks, start)
                torch.cuda.synchronize()
                prefills.append(time.perf_counter() - t)
                return res

            setattr(b, step_name, timed_step)
            b._prefill_paged = timed_prefill
            timed_chats, timed_prompt_tokens = make_chats()
            timed_answers, timed_wall_s = stream_burst(provider, timed_chats)
            timed_hits = provider.stats()["prefix_hits"] - end["prefix_hits"]
        finally:
            patch_forward(real_forward)
            decoder._INT4_MODE = "w4a8"
            provider.close()
        require(len(timed_answers) == n_chats and all(text for text, _, _ in timed_answers),
                f"{name}: every stream of the timed burst ended and yielded text")
        require(len(answers) == n_chats and all(text and first is not None
                                                for text, first, _ in answers),
                f"{name}: every stream ended and yielded text")
        require(launches[0] == launches[1] == cfg.layers * n_forwards and n_forwards > 0,
                f"{name}: paged_attention and paged_kv_write ran {cfg.layers} times in each of "
                f"{n_forwards} forwards: {launches}")
        per_forward = 4 * cfg.layers + 1
        require(launches[2] == (per_forward * n_forwards if "int8_weights" in kw else 0)
                and sum(int8_launches_by_rows.values()) == launches[2],
                f"{name}: int8_linear ran {per_forward} times a forward, each launch inside "
                f"one: {launches[2]}, {int8_launches_by_rows}")
        # int4: the kernel in every projection of every decode forward (32 rows
        # fed), never in a prefill chunk (256 rows: the grouped product)
        want_int4 = per_forward * decode_forwards if int4 else 0
        want = (want_int4, 0) if int4_mode == "w4a8" else (0, want_int4)
        require(launches[3:] == want and (decode_forwards > 0 or not (int4 or spec_k)),
                f"{name}: the int4 kernels ran {per_forward} times in each of {decode_forwards} "
                f"decode forwards and in no prefill chunk: {launches[3:]}, forwards {by_rows}")
        # a w4a8 projection is two launches: the row quantizer and the product
        require(quantizer_launches == launches[3],
                f"{name}: the row quantizer ran once a w4a8 product: {quantizer_launches} "
                f"and {launches[3]}")
        if spec_k:
            require(set(by_rows) <= {rows_fed, 256} and decode_forwards > 0,
                    f"{name}: every decode forward was a verify window of T = {1 + spec_k}: "
                    f"{by_rows}")
            require(end["spec_tokens_per_step"] is not None and end["spec_tokens_per_step"] >= 1.0,
                    f"{name}: spec_tokens_per_step >= 1: {end}")
            greedy = [i for i, (_, temperature) in enumerate(chats) if temperature == 0.0]
            same_as_plain = sum(answers[i][0] == plain_answers[i][0] for i in greedy) / len(greedy)
        require(stats["prefix_hits"] > 0, f"{name}: the shared system prefix hit the cache")
        require(repeat[0][0] == answers[0][0], f"{name}: a warm repeat equals the cold answer")
        require(pair[0] == pair[1] and len(pair[0]) > 0,
                f"{name}: cold and warm token streams are equal: {pair}")
        require(end["prefix_hits"] >= stats["prefix_hits"] + 4 + 5,
                f"{name}: the repeats found their prompt pages in the cache: {end}")
        require(end["active"] == 0 and end["queued"] == 0
                and end["pages_free"] + end["pages_cached"] == end["pages_total"],
                f"{name}: every page is free or cached at the end: {end}")
        firsts = sorted(first for _, first, _ in answers)
        full = [ms for active, ms in steps if active == max(a for a, _ in steps)]
        out_chars = sum(len(text) for text, _, _ in answers)
        row = {"config": name, "chats": n_chats, "slots": slots, "max_new_tokens": max_new,
               "int4_mode": int4_mode if int4 else None, "spec_k": spec_k,
               "prompt_tokens": sum(prompt_tokens), "wall_s": wall_s,
               "ttft_p50_ms": 1e3 * firsts[len(firsts) // 2],
               "ttft_p95_ms": 1e3 * firsts[min(len(firsts) - 1, int(0.95 * len(firsts)))],
               "generated_tokens": generated, "output_chars": out_chars,
               "tokens_per_s": generated / wall_s,
               "decode_step_ms": 1e3 * statistics.median(full),
               "decode_step_rows": max(a for a, _ in steps), "decode_chunks": len(steps),
               "prefill_chunks": len(prefills),
               "prefill_tokens_per_s": (sum(timed_prompt_tokens) - PAGE * timed_hits)
               / sum(prefills),
               "timed_burst_wall_s": timed_wall_s,
               "forwards": n_forwards, "paged_attention_launches": launches[0],
               "paged_kv_write_launches": launches[1], "int8_linear_launches": launches[2],
               # the int8 kernel's launches counted inside the decode forwards
               # (64 rows fed); the rest were inside prefill chunks
               "int8_linear_decode_launches": int8_launches_by_rows.get(rows_fed, 0),
               "w4a8_launches": launches[3], "w4a16_launches": launches[4],
               "quantize_rows_launches": quantizer_launches,
               "decode_forwards": decode_forwards, "forwards_by_rows_fed": by_rows,
               "spec_tokens_per_step": end.get("spec_tokens_per_step"),
               "greedy_texts_equal_to_plain_share": same_as_plain,
               "prefix_hits": stats["prefix_hits"], "prefix_lookups": stats["prefix_lookups"],
               "backpressure_waits": stats["backpressure_waits"],
               "pages_cached_at_end": end["pages_cached"], "kv_dtype": stats["kv_dtype"],
               "peak_device_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, **check}
        emit("decoder", **row)
        out[name] = row
        run_params = provider.params
        del provider, b, real_step, real_prefill, timed_step, timed_prefill  # frees the pool
        torch.cuda.empty_cache()
        decoder._INT4_MODE = int4_mode
        try:
            if spec_k:
                if not int4:
                    emit("spec_ceiling", config=name,
                         **spec_ceiling(torch, dev, decoder, run_params, cfg, seed + 11))
            else:
                emit("decode_profile", config=name, slots=slots, **decode_profile(
                    torch, dev, decoder, run_params, cfg, "int8" if kw.get("kv_int8") else None,
                    seed + 11, slots))
        finally:
            decoder._INT4_MODE = "w4a8"
        del run_params
        torch.cuda.empty_cache()
    return out


# --- checkpoint: real HF layouts on disk, loaded and served by the port ------

# BAAI/bge-m3's config.json (bge-reranker-v2-m3 shares the trunk)
CKPT_XLMR = dict(vocab_size=250_002, hidden_size=1024, num_hidden_layers=24,
                 num_attention_heads=16, intermediate_size=4096, max_position_embeddings=8194,
                 type_vocab_size=1, pad_token_id=1, bos_token_id=0, eos_token_id=2,
                 layer_norm_eps=1e-5)
# TinyLlama/TinyLlama-1.1B-Chat-v1.0's config.json and chat template
CKPT_LLAMA = dict(vocab_size=32_000, hidden_size=2048, num_hidden_layers=22,
                  num_attention_heads=32, num_key_value_heads=4, intermediate_size=5632,
                  max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
                  tie_word_embeddings=False, bos_token_id=1, eos_token_id=2)
TINYLLAMA_TEMPLATE = (
    "{% for message in messages %}\n"
    "{% if message['role'] == 'user' %}\n{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\n'  + message['content'] + eos_token }}\n{% endif %}\n"
    "{% if loop.last and add_generation_prompt %}\n{{ '<|assistant|>' }}\n{% endif %}\n"
    "{% endfor %}"
)
CKPT_ASKS, CKPT_AB_ASKS = 32, 64
# the encoder forward's shapes: a query batch, the rerank pairs of 32 queries
# x 12 candidates (query row ++ chunk row), an ingest batch
CKPT_FUSE_SHAPES = {"query": (MAX_BATCH, TOKEN_WIDTH), "rerank": (MAX_BATCH * TOP_K, 2 * TOKEN_WIDTH),
                    "ingest": (64, 256)}
CKPT_COS_MIN, CKPT_CORR_MIN = 0.999, 0.999
# the port's bf16 cross-encoder against HF's f32 scores: its error norm at most
# this many times that of the HF model itself run in bf16 on the same pairs
CKPT_BF16_ERR_RATIO = 2.0
CKPT_HEAD_REL = 1e-2  # the heads' bf16 weights against HF's f32 Linear, relative error norm
CKPT_DISK_GB = 12.0  # three checkpoints (~6.7 GB) and the index snapshot (~3 GB)

# Runs the package as ``python -m outline_rag_tpu_torch`` does, with two
# additions: the classifier stand-in of the ``http`` phase (a random-weight
# decoder writes no JSON, so every ask would route to General and skip
# retrieval) and, on SIGUSR1, the launch counts of the path's kernels appended
# to $CHIP_SMOKE_COUNTS and reset to 0.
ENTRY_RUNNER = r'''
import json, os, runpy, signal, sys
from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_kv_write
from outline_rag_tpu_torch.ops.topk import topk_int8
from outline_rag_tpu_torch.serve.llm import LocalChatProvider

complete = LocalChatProvider.complete


async def classified_as_query(self, model, messages, temperature=0.0, top_p=None,
                              json_mode=False, max_tokens=None):
    if json_mode:
        return json.dumps({"category": "Query"})
    return await complete(self, model, messages, temperature, top_p, json_mode, max_tokens)


LocalChatProvider.complete = classified_as_query
kernels = {"topk_int8": topk_int8, "paged_attention": paged_attention,
           "paged_kv_write": paged_kv_write}


def dump(signum, frame):
    with open(os.environ["CHIP_SMOKE_COUNTS"], "a") as f:
        f.write(json.dumps({name: fn.launches for name, fn in kernels.items()}) + "\n")
    for fn in kernels.values():
        fn.launches = 0


signal.signal(signal.SIGUSR1, dump)
sys.argv = ["outline_rag_tpu_torch"]
runpy.run_module("outline_rag_tpu_torch", run_name="__main__", alter_sys=True)
'''


def word_tokenizer(path: str, vocab_size: int, specials: list[str], single: str, pair: str,
                   chat_template: str | None = None, **names) -> None:
    """A fast tokenizer of ``vocab_size`` entries written to ``path``:
    ``specials`` first, then the words ``w0``, ``w1``, ... (the phase's texts
    are made of them), whitespace pre-tokenization, ``single`` / ``pair`` as
    its post-processor."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.processors import TemplateProcessing
    from transformers import PreTrainedTokenizerFast

    vocab = {tok: i for i, tok in enumerate(specials)}
    vocab.update({f"w{i}": len(specials) + i for i in range(vocab_size - len(specials))})
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.add_special_tokens(specials)
    tok.post_processor = TemplateProcessing(
        single=single, pair=pair, special_tokens=[(s, vocab[s]) for s in ("<s>", "</s>")])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, **names)
    if chat_template:
        fast.chat_template = chat_template
    fast.save_pretrained(path)


def synthesize_checkpoints(torch, dev, seed: int, root: str) -> tuple[dict, dict, dict]:
    """BGE-m3 (``XLMRobertaModel``, f32 ``pytorch_model.bin`` and its sparse
    and ColBERT sidecars), bge-reranker-v2-m3 (``XLMRobertaForSequenceClassification``,
    one label, f32 ``model.safetensors``) and TinyLlama-1.1B-Chat (bf16, two
    safetensors shards and their index) under ``root``, seeded, built on the
    card. Returns (folders, the HF models in f32 eager attention, each
    holding what its files hold, seconds and bytes per folder)."""
    from safetensors.torch import save_file
    from transformers import (
        LlamaConfig,
        LlamaForCausalLM,
        XLMRobertaConfig,
        XLMRobertaForSequenceClassification,
        XLMRobertaModel,
    )

    def cpu(model, dtype=None):
        return {k: v.detach().to("cpu", dtype).contiguous() for k, v in model.state_dict().items()}

    dirs = {name: os.path.join(root, name)
            for name in ("bge-m3", "bge-reranker-v2-m3", "tinyllama-1.1b-chat")}
    xlmr_tok = dict(specials=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
                    single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
                    bos_token="<s>", eos_token="</s>", unk_token="<unk>", pad_token="<pad>",
                    cls_token="<s>", sep_token="</s>", mask_token="<mask>")
    models, stats = {}, {}
    with torch.device(dev):
        # bge-m3
        t0 = time.perf_counter()
        torch.manual_seed(seed + 30)
        cfg = XLMRobertaConfig(**CKPT_XLMR, attn_implementation="eager")
        enc = XLMRobertaModel(cfg, add_pooling_layer=False).eval()
        h = CKPT_XLMR["hidden_size"]
        heads = {"sparse": torch.nn.Linear(h, 1), "colbert": torch.nn.Linear(h, h)}
        path = dirs["bge-m3"]
        os.makedirs(path)
        torch.save(cpu(enc), os.path.join(path, "pytorch_model.bin"))
        for name, head in heads.items():
            torch.save(cpu(head), os.path.join(path, f"{name}_linear.pt"))
        cfg.save_pretrained(path)
        word_tokenizer(path, CKPT_XLMR["vocab_size"], **xlmr_tok)
        models["bge-m3"] = (enc, heads)
        stats["bge-m3"] = time.perf_counter() - t0
        # bge-reranker-v2-m3
        t0 = time.perf_counter()
        torch.manual_seed(seed + 31)
        cfg = XLMRobertaConfig(**CKPT_XLMR, num_labels=1, attn_implementation="eager")
        rr = XLMRobertaForSequenceClassification(cfg).eval()
        path = dirs["bge-reranker-v2-m3"]
        os.makedirs(path)
        save_file(cpu(rr), os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
        cfg.save_pretrained(path)
        word_tokenizer(path, CKPT_XLMR["vocab_size"], **xlmr_tok)
        models["bge-reranker-v2-m3"] = rr
        stats["bge-reranker-v2-m3"] = time.perf_counter() - t0
        # TinyLlama: the f32 model holds the bf16 values the shards hold
        t0 = time.perf_counter()
        torch.manual_seed(seed + 32)
        cfg = LlamaConfig(**CKPT_LLAMA, attn_implementation="eager")
        dec = LlamaForCausalLM(cfg).eval()
        with torch.no_grad():
            for p in dec.parameters():
                p.copy_(p.to(torch.bfloat16))
        path = dirs["tinyllama-1.1b-chat"]
        os.makedirs(path)
        sd = cpu(dec, torch.bfloat16)
        keys = sorted(sd)
        weight_map = {}
        for n, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
            fname = f"model-0000{n + 1}-of-00002.safetensors"
            save_file({k: sd[k] for k in part}, os.path.join(path, fname),
                      metadata={"format": "pt"})
            weight_map.update(dict.fromkeys(part, fname))
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
        del sd
        cfg.save_pretrained(path)
        word_tokenizer(path, CKPT_LLAMA["vocab_size"],
                       ["<unk>", "<s>", "</s>", "<|system|>", "<|user|>", "<|assistant|>"],
                       "<s> $A", "<s> $A $B", chat_template=TINYLLAMA_TEMPLATE,
                       bos_token="<s>", eos_token="</s>", unk_token="<unk>")
        models["tinyllama-1.1b-chat"] = dec
        stats["tinyllama-1.1b-chat"] = time.perf_counter() - t0
    sizes = {name: sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e9
             for name, d in dirs.items()}
    attn = {name: (m[0] if isinstance(m, tuple) else m).config._attn_implementation
            for name, m in models.items()}
    return dirs, models, {"write_s": stats, "disk_gb": sizes, "hf_attention": attn}


def checkpoint_parity(torch, dev, seed: int, dirs: dict, hf: dict, enc, rr, dec_cfg, dec_params,
                      vocab: list[str]) -> dict:
    """The port's loaded models (bf16) against the HF models that wrote the
    files (f32, eager attention), on the same token batches; the
    cross-encoder also loaded in f32, and the HF cross-encoder also run in
    bf16."""
    import copy

    import numpy as np
    from transformers import AutoTokenizer

    from outline_rag_tpu_torch.models import (
        colbert_vectors_from_hidden,
        decoder_forward,
        init_cache,
        load_pretrained,
        pooled_embeddings,
        sparse_weights_from_hidden,
    )

    def corr(a, b) -> float:
        return float(np.corrcoef(a.float().cpu().numpy(), b.float().cpu().numpy())[0, 1])

    rng = np.random.default_rng(seed + 33)
    out = {}
    hf_enc, heads = hf["bge-m3"]
    tok = AutoTokenizer.from_pretrained(dirs["bge-m3"])
    texts = make_texts(rng, MAX_BATCH, vocab)
    with torch.inference_mode():
        b = tok(texts, padding=True, truncation=True, max_length=512, return_tensors="pt").to(dev)
        ids, mask = b["input_ids"], b["attention_mask"]
        hidden = hf_enc(input_ids=ids, attention_mask=mask).last_hidden_state
        ref = torch.nn.functional.normalize(hidden[:, 0], dim=-1)
        cos = (pooled_embeddings(enc, ids, mask) * ref).sum(-1)
        out["encoder_cls_cos_min"] = float(cos.min())
        # the heads, on HF's hidden states, against nn.Linear in f32
        live = (mask > 0) & (ids >= 3)
        want = torch.relu(heads["sparse"](hidden)[..., 0]) * live
        got = sparse_weights_from_hidden(enc, hidden, ids, mask)
        out["sparse_rel_err"] = float((got - want).norm() / want.norm())
        want = torch.nn.functional.normalize(heads["colbert"](hidden), dim=-1)
        got = colbert_vectors_from_hidden(enc, hidden, mask)
        keep = (mask > 0).clone()
        keep[:, 0] = False
        out["colbert_cos_min"] = float((got * want).sum(-1)[keep].min())
        # the cross-encoder: 64 pairs, 8 queries x 8 passages
        queries = [" ".join(rng.choice(vocab, 12)) for _ in range(8)]
        passages = make_texts(rng, 64, vocab)
        b = AutoTokenizer.from_pretrained(dirs["bge-reranker-v2-m3"])(
            [q for q in queries for _ in range(8)], passages, padding=True, truncation=True,
            max_length=512, return_tensors="pt").to(dev)
        want = hf["bge-reranker-v2-m3"](**b).logits[:, 0]
        got = rr(b["input_ids"], b["attention_mask"])
        out["reranker_corr"] = corr(got, want)
        out["reranker_max_abs_err"] = float((got - want).abs().max())
        out["reranker_score_std"] = float(want.std())
        # seeded weights spread the 64 scores by ~0.05, as far as bf16 rounding
        # moves them: the port's loader in f32 is held to the bar, and its bf16
        # model to the HF model's own bf16 error on the same pairs
        rr32 = load_pretrained(dirs["bge-reranker-v2-m3"], dev, dtype=torch.float32)
        got32 = rr32(b["input_ids"], b["attention_mask"])
        out["reranker_f32_corr"] = corr(got32, want)
        out["reranker_f32_max_abs_err"] = float((got32 - want).abs().max())
        del rr32
        hf16 = copy.deepcopy(hf["bge-reranker-v2-m3"]).to(torch.bfloat16)
        ref16 = hf16(**b).logits[:, 0].float()
        del hf16
        out["hf_bf16_reranker_corr"] = corr(ref16, want)
        out["reranker_err_over_hf_bf16_err"] = float((got - want).norm() / (ref16 - want).norm())
        # the decoder: 4 rows of 128 seeded tokens, logits at every position
        toks = torch.as_tensor(rng.integers(3, dec_cfg.vocab_size, (4, 128)), device=dev)
        want = hf["tinyllama-1.1b-chat"](toks).logits.float()
        got, _ = decoder_forward(dec_params, toks.to(torch.int32), init_cache(dec_cfg, 4, dev),
                                 torch.zeros((4,), dtype=torch.int32, device=dev), dec_cfg)
        cos = torch.nn.functional.cosine_similarity(got.float(), want, dim=-1)
        out["decoder_logits_cos_min"] = float(cos.min())
        out["decoder_logits_rel_err"] = float((got - want).norm() / want.norm())
    require(out["encoder_cls_cos_min"] > CKPT_COS_MIN, f"encoder CLS cosine {out}")
    require(out["sparse_rel_err"] < CKPT_HEAD_REL and out["colbert_cos_min"] > CKPT_COS_MIN,
            f"the sparse and ColBERT heads against nn.Linear: {out}")
    require(out["reranker_f32_corr"] > CKPT_CORR_MIN, f"reranker score correlation {out}")
    require(out["reranker_err_over_hf_bf16_err"] <= CKPT_BF16_ERR_RATIO,
            f"the bf16 cross-encoder within {CKPT_BF16_ERR_RATIO}x HF's own bf16 error: {out}")
    require(out["decoder_logits_cos_min"] > CKPT_COS_MIN, f"decoder logits cosine {out}")
    return out


def trunk_ab(torch, dev, seed: int, dirs: dict, emb, rr, index, vocab: list[str]) -> dict:
    """ENCODER_INT8 in process: ``fused_query`` per stage at B = 32 (median of
    5, float and int8 trunks in turns), the top-3 agreement of the two over
    64 asks, peak device memory; then the QKV fusion at the encoder
    forward's three shapes (bf16, unfused and fused in turns)."""
    import numpy as np

    from outline_rag_tpu_torch.engine import CrossEncoderReranker, EncoderEmbedder, FusedEngine
    from outline_rag_tpu_torch.engine.fused import fused_query
    from outline_rag_tpu_torch.models import fuse_qkv_, load_pretrained, pooled_embeddings
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8

    rng = np.random.default_rng(seed + 34)
    enc8 = EncoderEmbedder(load_pretrained(dirs["bge-m3"], dev), emb.tokenizer, int8=True)
    rr8 = CrossEncoderReranker(load_pretrained(dirs["bge-reranker-v2-m3"], dev), rr.tokenizer,
                               int8=True)
    trunks = {"float": (emb, rr), "int8": (enc8, rr8)}

    def weight_gb(module):
        return sum(t.numel() * t.element_size()
                   for t in list(module.parameters()) + list(module.buffers())) / 1e9

    asks = [" ".join(rng.choice(vocab, 12)) for _ in range(CKPT_AB_ASKS)]
    tb = emb.tokenizer.batch(asks[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    state, _ = index.snapshot()
    tokens = index.tokens.state
    out = {name: {"weights_gb": weight_gb(e.encoder) + weight_gb(r.model), "rounds": []}
           for name, (e, r) in trunks.items()}

    def stages(e, r):
        enc, rer = e.encoder, r.model
        q_emb = pooled_embeddings(enc, q_ids, q_mask)
        st = {
            "encode_ms": cuda_ms(torch, lambda: pooled_embeddings(enc, q_ids, q_mask), runs=5),
            "scan_ms": cuda_ms(torch, lambda: int8_topk(
                *quantize_rows_int8(q_emb), state.vectors, state.scales, TOP_K, state.penalty,
                rescore_queries=q_emb, rescore_residual=state.residual), runs=5),
            "fused_ms": cuda_ms(torch, lambda: fused_query(
                enc, rer, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                tokens.ids, tokens.mask, state.residual, top_k=TOP_K, rerank_k=RERANK_K), runs=5),
        }
        st["gather_rerank_ms"] = st["fused_ms"] - st["encode_ms"] - st["scan_ms"]
        return st

    with torch.inference_mode():
        for name in ("float", "int8", "int8", "float"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            st = stages(*trunks[name])
            st["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            out[name]["rounds"].append(st)
    answers = {name: FusedEngine(e, r, index, top_k=TOP_K, rerank_k=RERANK_K).query(asks)
               for name, (e, r) in trunks.items()}
    top3 = [(set(c for c, _, _ in a), [c for c, _, _ in a], [c for c, _, _ in b])
            for a, b in zip(answers["float"], answers["int8"])]
    out["top3_overlap"] = sum(len(s & set(b)) for s, _, b in top3) / (RERANK_K * len(top3))
    out["top3_same_order"] = sum(a == b for _, a, b in top3) / len(top3)
    require(all(len(a) == RERANK_K for a in answers["int8"]), "the int8 trunks answer every ask")
    del trunks, enc8, rr8
    torch.cuda.empty_cache()

    # QKV fusion: the same checkpoint twice, one copy fused
    fused = fuse_qkv_(load_pretrained(dirs["bge-m3"], dev))
    plain = emb.encoder
    fusion = {}
    with torch.inference_mode():
        for shape, (b, s) in CKPT_FUSE_SHAPES.items():
            ids = torch.randint(3, CKPT_XLMR["vocab_size"], (b, s), device=dev)
            mask = torch.ones_like(ids)
            times = {"unfused": [], "fused": []}
            for name, enc in (("unfused", plain), ("fused", fused), ("fused", fused),
                              ("unfused", plain)):
                times[name].append(cuda_ms(torch, lambda: enc(ids, mask), runs=5))
            fusion[shape] = {"batch": b, "seq": s, "unfused_ms": times["unfused"],
                             "fused_ms": times["fused"],
                             "fused_over_unfused": sum(times["fused"]) / sum(times["unfused"])}
    out["fusion"] = fusion
    del fused
    torch.cuda.empty_cache()
    return out


def checkpoint_phase(torch, dev, seed: int) -> dict:
    """Serve real HF checkpoint layouts on the card: synthesize BGE-m3,
    bge-reranker-v2-m3 and TinyLlama-1.1B-Chat folders at their published
    widths, load them with the port's loaders and hold them to the HF models,
    A/B the int8 trunk and the QKV fusion, then run ``python -m
    outline_rag_tpu_torch`` on all three through ``*_WEIGHTS_PATH``."""
    import shutil
    import signal
    import socket
    import subprocess
    import tempfile

    import numpy as np

    from outline_rag_tpu_torch.engine import CrossEncoderReranker, EncoderEmbedder
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.models import load_pretrained, load_pretrained_decoder
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer, HFTokenizer
    from outline_rag_tpu_torch.storage import SqliteMetaStore
    from outline_rag_tpu_torch.tools.timing import card

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free_gb = shutil.disk_usage(tmp).free / 1e9
    out = {"card": card(), "disk_free_gb": free_gb}
    require(free_gb > CKPT_DISK_GB, f"{CKPT_DISK_GB} GB free for the checkpoints: {free_gb:.1f}")
    rng = np.random.default_rng(seed + 35)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:5000]]
    proc = wiki = None
    try:
        t0 = time.perf_counter()
        dirs, hf, written = synthesize_checkpoints(torch, dev, seed, os.path.join(tmp, "models"))
        out.update(written, synthesize_s=time.perf_counter() - t0)

        load_s = {}
        t0 = time.perf_counter()
        enc = load_pretrained(dirs["bge-m3"], dev)
        torch.cuda.synchronize()
        load_s["bge-m3"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rr = load_pretrained(dirs["bge-reranker-v2-m3"], dev)
        torch.cuda.synchronize()
        load_s["bge-reranker-v2-m3"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec_cfg, dec_params = load_pretrained_decoder(dirs["tinyllama-1.1b-chat"], dev)
        torch.cuda.synchronize()
        load_s["tinyllama-1.1b-chat"] = time.perf_counter() - t0
        out["load_s"] = load_s  # files still in the page cache: written just before
        require(enc.sparse is not None and enc.colbert.out_features == CKPT_XLMR["hidden_size"],
                "bge-m3's sidecar heads loaded")
        require((dec_cfg.kv_heads, dec_cfg.layers, dec_cfg.tie_embeddings)
                == (CKPT_LLAMA["num_key_value_heads"], CKPT_LLAMA["num_hidden_layers"], False)
                and "lm_head" in dec_params, "TinyLlama's GQA and untied head")
        out["parity"] = checkpoint_parity(torch, dev, seed, dirs, hf, enc, rr, dec_cfg,
                                          dec_params, vocab)
        emit("checkpoint_parity", **out["parity"])
        del hf, dec_params
        torch.cuda.empty_cache()

        # the served index: seeded rows in documents of HTTP_SOURCE_ROWS chunks,
        # every row a chunk of a document in the meta store, as a snapshot the
        # entry point adopts at boot (random_chunks' ids: XLM-R's CLS 0, pad 1,
        # which HashTokenizer shares)
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        gen = torch.Generator(device=dev).manual_seed(seed + 36)
        index = VectorIndex(dim=DIM, capacity=CAPACITY, dtype="int8r", device=dev,
                            token_width=TOKEN_WIDTH)
        seeded, t0 = [], time.perf_counter()
        while index.size < HTTP_LIVE:
            sid = f"seed{len(seeded):04d}"
            v, ids, mask = random_chunks(torch, HTTP_SOURCE_ROWS, gen, dev, HashTokenizer,
                                         CKPT_XLMR["vocab_size"])
            index.add_chunks([f"{sid}:{i}" for i in range(HTTP_SOURCE_ROWS)], v, sid,
                             token_ids=ids, token_mask=mask)
            seeded.append(sid)
        torch.cuda.synchronize()
        out["index_fill_s"] = time.perf_counter() - t0
        meta = SqliteMetaStore(os.path.join(data, "meta.sqlite3"))
        wiki_docs, t0 = {}, time.perf_counter()
        for n, sid in enumerate(seeded):
            title, text = f"Seeded document {n}", " ".join(rng.choice(vocab, 600))
            meta.upsert_document(sid, title, f"/doc/{sid}", "t0", text)
            meta.replace_chunks(sid, [(f"{sid}:{i}", i, f"{title}, part {i}", 0)
                                      for i in range(HTTP_SOURCE_ROWS)])
            wiki_docs[sid] = {"id": sid, "title": title, "text": text, "updatedAt": "t0",
                              "url": f"/doc/{sid}"}
        require(meta.chunk_count() == index.size, "every live row has a chunk row")
        meta.close()
        out["meta_fill_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        index.save(os.path.join(data, "index_snapshot"))
        out["snapshot_save_s"] = time.perf_counter() - t0
        live_rows = index.size

        # the trunks' A/B on that index, with 4,096 text chunks added to it
        emb = EncoderEmbedder(enc, HFTokenizer(dirs["bge-m3"]))
        cross = CrossEncoderReranker(rr, HFTokenizer(dirs["bge-reranker-v2-m3"]))
        texts = make_texts(rng, TEXT_CHUNKS, vocab)
        tb = emb.tokenizer.batch(texts, TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
        for start in range(0, TEXT_CHUNKS, BLOCK // 4):
            part = slice(start, start + BLOCK // 4)
            index.add_chunks([f"text:{i}" for i in range(start, part.stop)],
                             emb.embed(texts[part]), "text", token_ids=tb.input_ids[part],
                             token_mask=tb.attention_mask[part])
        out["int8_ab"] = trunk_ab(torch, dev, seed, dirs, emb, cross, index, vocab)
        emit("checkpoint_ab", **out["int8_ab"])
        del index, emb, cross, enc, rr
        torch.cuda.empty_cache()

        # the entry point, with the three checkpoints
        new_docs = []
        for n in range(HTTP_DOCS):
            n_words = int(rng.integers(1100, 8001))
            text = "\n\n".join(" ".join(rng.choice(vocab, int(rng.integers(40, 120))))
                               for _ in range(n_words // 80 + 1))
            new_docs.append(f"doc{n:02d}")
            wiki_docs[new_docs[-1]] = {"id": new_docs[-1], "title": f"Wiki page {n}",
                                       "text": text, "updatedAt": "t1",
                                       "url": f"/doc/{new_docs[-1]}"}
        wiki = FakeWiki(wiki_docs)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        counts = os.path.join(tmp, "counts.jsonl")
        env = {**os.environ, "SECRET_KEY": "chip-smoke", "DATA_DIR": data, "PORT": str(port),
               "VECTOR_DIM": str(DIM), "SHARD_CAPACITY": str(CAPACITY), "INDEX_DTYPE": "int8r",
               "TOKEN_WIDTH": str(TOKEN_WIDTH), "OUTLINE_API_URL": wiki.url,
               "OUTLINE_API_TOKEN": "chip-smoke", "OUTLINE_WEBHOOK_SECRET": "whsec",
               "ENCODER_WEIGHTS_PATH": dirs["bge-m3"],
               "RERANKER_WEIGHTS_PATH": dirs["bge-reranker-v2-m3"],
               "DECODER_WEIGHTS_PATH": dirs["tinyllama-1.1b-chat"],
               "DECODER_BATCH_SLOTS": str(DEC_SLOTS), "DECODER_KV_PAGES": str(KV_PAGES),
               "DECODER_PAGE_SIZE": str(PAGE), "DECODER_MAX_NEW_TOKENS": str(DEC_NEW),
               "CHIP_SMOKE_COUNTS": counts}
        log_path = os.path.join(tmp, "server.log")
        root = os.path.dirname(os.path.abspath(__file__))
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen([sys.executable, "-c", ENTRY_RUNNER], cwd=root, env=env,
                                    stdout=log_file, stderr=subprocess.STDOUT)
        out["boot_to_healthz_s"], status, body = wait_for_healthz(proc, port, 300)
        require(status == 200, f"healthz answered {status}")
        size_before = json.loads(body)["index_size"]
        require(size_before == live_rows, f"the snapshot was adopted: {size_before} rows")

        admin = http_login(port, "admin")
        out["sync_s"] = sync_wiki(port, admin, HTTP_DOCS)
        _, _, body = http_call(port, "GET", "/healthz")
        out["ingested_chunks"] = json.loads(body)["index_size"] - size_before
        require(out["ingested_chunks"] > 0, "the sync added chunks")

        questions = wiki_questions(rng, wiki_docs, new_docs, seeded, CKPT_ASKS)

        def read_counts(n_lines):
            t = time.perf_counter()
            while time.perf_counter() - t < 30:
                if os.path.exists(counts):
                    with open(counts) as f:
                        lines = f.read().splitlines()
                    if len(lines) >= n_lines:
                        return json.loads(lines[n_lines - 1])
                time.sleep(0.05)
            raise RuntimeError("check failed: the server wrote its launch counts")

        def zero_counts():  # the counts to 0 just before the asks
            proc.send_signal(signal.SIGUSR1)
            read_counts(1)

        results, wall_s = ask_at_once(port, questions, zero_counts)
        proc.send_signal(signal.SIGUSR1)
        launches = read_counts(2)
        cites_new = []
        for q, r in zip(questions, results):
            got = sources_of(r["frames"])
            require(got, f"the answer to {q!r} has sources")
            cites_new.append(any(url.removeprefix("/doc/") in new_docs for _, url in got))
        require(all(cites_new[: CKPT_ASKS // 2]),
                f"every ask from a new document cites one: {cites_new}")
        require(all(v > 0 for v in launches.values()), f"the path's kernels launched: {launches}")
        _, _, body = http_call(port, "GET", "/chat/api/metrics", cookie=admin)
        m = json.loads(body)
        out.update(
            asks=CKPT_ASKS, wall_s=wall_s, asks_per_s=CKPT_ASKS / wall_s,
            first_content=percentiles([r["first_s"] for r in results]),
            done=percentiles([r["done_s"] for r in results]),
            asks_citing_a_new_document=sum(cites_new), launches=launches,
            decoder=m.get("decoder"),
        )
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=10.0 + 20)
        out.update(exit_code=rc, stop_s=time.perf_counter() - t0)
        require(rc == 0, f"SIGTERM ended the server with exit 0, not {rc}")
    except Exception:
        if proc is not None:
            with open(os.path.join(tmp, "server.log")) as f:
                print(f.read()[-6000:], file=sys.stderr)
        raise
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(30)
        if wiki is not None:
            wiki.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("checkpoint", **out)
    return out


# train: the three models at their published widths in f32, TRAIN_STEPS steps
# each on one seeded batch; sequences stay under the 2,048 tokens at which
# "auto" attention would take the flash kernel, which has no backward
TRAIN_STEPS = 4
TRAIN_PAIRS, TRAIN_Q_LEN, TRAIN_P_LEN = 16, 64, 512  # contrastive, bge-m3
TRAIN_QUERIES, TRAIN_GROUP, TRAIN_PAIR_LEN = 8, 8, 256  # cross-encoder, bge-reranker-v2-m3
TRAIN_SEQS, TRAIN_SEQ_LEN = 4, 512  # causal LM, TinyLlama-1.1B
# the encoders at the JAX package's default lr (``make_optimizer``): at 1e-4
# the seeded bge-m3 trunk's contrastive loss fell for two steps and returned
# to ln 16 (pooled embeddings collapsed to one point) at the fourth
TRAIN_LR = {"contrastive": 1e-5, "reranker": 1e-5, "lm": 3e-4}
TRAIN_REL = 1e-5  # losses and gradient norms: remat against none, the card against the CPU


def train_lengths(torch, gen, dev, n: int, hi: int, vocab: int):
    """Seeded token ids and masks [n, hi]: CLS (0) first, a length drawn in
    [hi / 4, hi], pad (1) after it."""
    ids = torch.randint(3, vocab, (n, hi), generator=gen, device=dev)
    lengths = torch.randint(hi // 4, hi + 1, (n,), generator=gen, device=dev)
    mask = (torch.arange(hi, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
    ids = torch.where(mask.bool(), ids, torch.ones_like(ids))
    ids[:, 0] = 0
    return ids, mask


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check_grads(torch, grads: dict, attention: list[str]) -> dict:
    """Every gradient finite; the attention projections' not all zero."""
    finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
    require(finite, "every trained parameter has a finite gradient")
    zero = [n for n in attention if not bool(grads[n].ne(0).any())]
    require(not zero, f"the attention projections get gradients: {zero[:4]} are all zero")
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
    return {"leaves": len(grads), "attention_leaves": len(attention), "grad_norm": float(norm)}


def model_flops(n_params: int, tokens: int, attention: float) -> float:
    """6 x non-embedding parameters x tokens (forward and backward), plus
    the attention products (QK^T and PV: 4 FLOPs a query-key pair and
    hidden unit forward, three times that with the backward)."""
    return 6.0 * n_params * tokens + 12.0 * attention


def timed_steps(torch, step, state, batch, tokens: int, flops: float) -> dict:
    """TRAIN_STEPS steps queued back to back, each between two CUDA events;
    ``ms``: the median of steps 2 on, and the tokens (positions, padding
    included), model TFLOP/s and share of the f32 peak it makes;
    ``peak_gb``: the most memory allocated over the run; ``start_gb``: what
    was allocated as it began."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9  # weights and AdamW moments
    events, losses = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        events.append((start, end))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(x) for x in losses]
    require(all(map(math.isfinite, losses)), f"finite losses: {losses}")
    sec = statistics.median(ms[1:]) / 1e3
    return {"losses": losses, "step_ms": ms, "ms": sec * 1e3, "tokens_per_s": tokens / sec,
            "model_tflop_s": flops / sec / 1e12, "f32_peak_share": flops / sec / PEAK["f32"],
            "start_gb": start_gb, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def train_tiny_parity(torch, dev, seed: int) -> dict:
    """A training step of each model at tiny width on the card against the
    CPU from the same weights and batch (``testing.card_step_errors``):
    losses within 1e-5 relative, gradients as close to a float64 run as the
    CPU's, one AdamW update from the same gradients within 1e-6. A TF32
    product or a route only the card takes would show here."""
    import dataclasses

    from outline_rag_tpu_torch.models import train as tt
    from outline_rag_tpu_torch.models.convert import init_encoder, init_reranker
    from outline_rag_tpu_torch.models.decoder import DecoderConfig, init_decoder
    from outline_rag_tpu_torch.models.encoder import EncoderConfig
    from outline_rag_tpu_torch.testing import card_step_errors

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed + 40)
    ecfg, dcfg = EncoderConfig.tiny(), DecoderConfig.tiny()
    q_ids, q_mask = train_lengths(torch, gen, cpu, 8, 16, ecfg.vocab_size)
    p_ids, p_mask = train_lengths(torch, gen, cpu, 8, 32, ecfg.vocab_size)
    pair_ids, pair_mask = train_lengths(torch, gen, cpu, 4 * 4, 24, ecfg.vocab_size)
    toks = torch.randint(0, dcfg.vocab_size, (4, 32), generator=gen)

    def on(m, *ts):
        device = next(iter(tt.named_params(m).values())).device
        return [t.to(device) for t in ts]

    cases = {
        "contrastive": (init_encoder(ecfg, gen, cpu), lambda m, dt: tt.contrastive_loss(
            m, *on(m, q_ids, q_mask, p_ids, p_mask))),
        "reranker": (init_reranker(ecfg, gen, cpu), lambda m, dt: tt.reranker_loss(
            m, *on(m, pair_ids, pair_mask), 4)),
        "lm": (init_decoder(dcfg, gen, cpu), lambda m, dt: tt.lm_loss(
            m, *on(m, toks, torch.ones_like(toks)), dataclasses.replace(dcfg, dtype=dt))),
    }
    out = {}
    for name, (params, loss_on) in cases.items():
        out[name] = card_step_errors(params, loss_on, dev, TRAIN_LR["contrastive"])
        require(out[name]["ok"], f"{name}: a tiny step on the card == the CPU: {out[name]}")
    return out


def flash_refuses_grad(torch, dev, seed: int) -> dict:
    """The flash route under autograd raises (it has no backward), and runs
    forward-only under no_grad, through the kernel."""
    from outline_rag_tpu_torch.models.convert import init_encoder
    from outline_rag_tpu_torch.models.encoder import EncoderConfig, pooled_embeddings
    from outline_rag_tpu_torch.ops.attention import flash_attention

    cfg = EncoderConfig(vocab_size=1024, hidden=128, layers=1, heads=2, intermediate=256,
                        max_positions=258, dtype=torch.float32, attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    enc = init_encoder(cfg, gen, dev)
    ids, mask = train_lengths(torch, gen, dev, 2, 256, cfg.vocab_size)
    message = None
    try:
        pooled_embeddings(enc, ids, mask)
    except RuntimeError as exc:  # the check: this call must raise
        message = str(exc)
    require(message is not None and "no backward" in message, "flash under autograd raises")
    before = flash_attention.launches
    with torch.no_grad():
        emb = pooled_embeddings(enc, ids, mask)
    require(flash_attention.launches == before + 1 and bool(torch.isfinite(emb).all()),
            "flash forward-only under no_grad, through the kernel")
    return {"raised": message}


def train_phase(torch, dev, seed: int) -> dict:
    """Fine-tune the three models at their published widths in f32 on the
    card (``models/train.py``): the contrastive step (bge-m3, remat), the
    cross-encoder step (bge-reranker-v2-m3) and the causal-LM step
    (TinyLlama-1.1B, fused), TRAIN_STEPS steps each on one seeded batch."""
    from outline_rag_tpu_torch.models import train as tt
    from outline_rag_tpu_torch.models.convert import init_encoder, init_reranker
    from outline_rag_tpu_torch.models.decoder import DecoderConfig, fuse_decoder_params, init_decoder
    from outline_rag_tpu_torch.models.encoder import EncoderConfig
    from outline_rag_tpu_torch.ops.attention import flash_attention
    from outline_rag_tpu_torch.tools.timing import card

    t_phase = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest", "true fp32 products (no TF32)")
    out = {"card": card(), "steps": TRAIN_STEPS}
    out["tiny_cuda_vs_cpu"] = train_tiny_parity(torch, dev, seed)
    out["flash_under_grad"] = flash_refuses_grad(torch, dev, seed)
    flash_before = flash_attention.launches
    gen = torch.Generator(device=dev).manual_seed(seed + 42)

    # the dual encoder: symmetric InfoNCE over 16 pairs, remat (step 1 also without)
    ecfg = EncoderConfig.bge_m3(dtype=torch.float32)
    enc = init_encoder(ecfg, gen, dev)
    q_ids, q_mask = train_lengths(torch, gen, dev, TRAIN_PAIRS, TRAIN_Q_LEN, ecfg.vocab_size)
    p_ids, p_mask = train_lengths(torch, gen, dev, TRAIN_PAIRS, TRAIN_P_LEN, ecfg.vocab_size)
    batch = {"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask}
    embeddings = {"word", "position", "token_type"}
    runs = {}
    for remat in (True, False):
        loss, grads = tt.value_and_grad(lambda m, remat=remat: tt.contrastive_loss(
            m, q_ids, q_mask, p_ids, p_mask, remat=remat), enc)
        qkv = [f"layers.{i}.{w}.weight" for i in range(ecfg.layers) for w in "qkv"]
        runs[remat] = {"loss": float(loss), **check_grads(torch, grads, qkv)}
        del grads
    require(rel(runs[False]["loss"], runs[True]["loss"]) <= TRAIN_REL
            and rel(runs[False]["grad_norm"], runs[True]["grad_norm"]) <= TRAIN_REL,
            f"step 1 with remat == without: {runs}")
    opt = tt.make_optimizer(lr=TRAIN_LR["contrastive"])
    state = tt.init_train_state(enc, opt)
    n_params = sum(p.numel() for n, p in tt.named_params(enc).items() if n not in embeddings)
    tokens = TRAIN_PAIRS * (TRAIN_Q_LEN + TRAIN_P_LEN)
    flops = model_flops(n_params, tokens, ecfg.layers * ecfg.hidden * TRAIN_PAIRS
                        * (TRAIN_Q_LEN ** 2 + TRAIN_P_LEN ** 2))
    remat_run = timed_steps(torch, tt.make_train_step(ecfg, opt, remat=True), state, batch,
                            tokens, flops)
    plain_run = timed_steps(torch, tt.make_train_step(ecfg, opt, remat=False), state, batch,
                            tokens, flops)
    require(remat_run["losses"][-1] < remat_run["losses"][0], f"contrastive loss falls: {remat_run}")
    out["contrastive"] = {
        "params": sum(p.numel() for p in tt.named_params(enc).values()),
        "non_embedding_params": n_params, "tokens_per_step": tokens, "model_flop_per_step": flops,
        "step1_remat_vs_none": runs, "remat": remat_run, "no_remat": plain_run,
    }
    emit("train_contrastive", **out["contrastive"])
    del enc, state, batch
    torch.cuda.empty_cache()

    # the cross-encoder: 8 queries x a group of 8 pairs of 256 tokens
    rr = init_reranker(ecfg, gen, dev)
    pair_ids, pair_mask = train_lengths(torch, gen, dev, TRAIN_QUERIES * TRAIN_GROUP,
                                        TRAIN_PAIR_LEN, ecfg.vocab_size)
    batch = {"pair_ids": pair_ids, "pair_mask": pair_mask}
    _, grads = tt.value_and_grad(
        lambda m: tt.reranker_loss(m, pair_ids, pair_mask, TRAIN_GROUP), rr)
    grad_check = check_grads(torch, grads, [f"encoder.layers.{i}.{w}.weight"
                                            for i in range(ecfg.layers) for w in "qkv"])
    del grads
    opt = tt.make_optimizer(lr=TRAIN_LR["reranker"])
    state = tt.init_train_state(rr, opt)
    n_params = sum(p.numel() for n, p in tt.named_params(rr).items()
                   if n.removeprefix("encoder.") not in embeddings)
    tokens = TRAIN_QUERIES * TRAIN_GROUP * TRAIN_PAIR_LEN
    flops = model_flops(n_params, tokens, ecfg.layers * ecfg.hidden * TRAIN_QUERIES * TRAIN_GROUP
                        * TRAIN_PAIR_LEN ** 2)
    plain_run = timed_steps(torch, tt.make_reranker_train_step(ecfg, opt, TRAIN_GROUP), state,
                            batch, tokens, flops)
    remat_run = timed_steps(torch, tt.make_reranker_train_step(ecfg, opt, TRAIN_GROUP, remat=True),
                            state, batch, tokens, flops)
    require(plain_run["losses"][-1] < plain_run["losses"][0], f"reranker loss falls: {plain_run}")
    out["reranker"] = {
        "params": sum(p.numel() for p in tt.named_params(rr).values()),
        "non_embedding_params": n_params, "tokens_per_step": tokens, "model_flop_per_step": flops,
        "grads": grad_check, "no_remat": plain_run, "remat": remat_run,
    }
    emit("train_reranker", **out["reranker"])
    del rr, state, batch
    torch.cuda.empty_cache()

    # the local decoder: next-token loss over 4 sequences of 512 tokens, fused
    dcfg = DecoderConfig.tinyllama_1b(dtype=torch.float32)
    params = fuse_decoder_params(init_decoder(dcfg, gen, dev))
    toks = torch.randint(0, dcfg.vocab_size, (TRAIN_SEQS, TRAIN_SEQ_LEN), generator=gen, device=dev)
    mask = torch.ones_like(toks, dtype=torch.int32)
    mask[-1, TRAIN_SEQ_LEN * 3 // 4:] = 0  # one sequence ends early
    batch = {"tokens": toks, "mask": mask}
    opt = tt.make_optimizer(lr=TRAIN_LR["lm"])
    state = tt.init_train_state(params, opt)
    _, grads = tt.value_and_grad(lambda p: tt.lm_loss(p, toks, mask, dcfg), params)
    grad_check = check_grads(torch, grads, [f"layers.{i}.wqkv" for i in range(dcfg.layers)])
    del grads
    n_params = sum(p.numel() for n, p in tt.named_params(params).items() if n != "embed")
    tokens = TRAIN_SEQS * TRAIN_SEQ_LEN
    flops = model_flops(n_params, tokens, dcfg.layers * dcfg.hidden * TRAIN_SEQS
                        * TRAIN_SEQ_LEN * (TRAIN_SEQ_LEN + 1) / 2)
    run = timed_steps(torch, tt.make_lm_train_step(dcfg, opt), state, batch, tokens, flops)
    require(run["losses"][-1] < run["losses"][0], f"LM loss falls: {run}")
    out["lm"] = {
        "params": sum(p.numel() for p in tt.named_params(params).values()),
        "non_embedding_params": n_params, "tokens_per_step": tokens, "model_flop_per_step": flops,
        "grads": grad_check, "no_remat": run,
    }
    emit("train_lm", **out["lm"])
    del params, state, batch
    torch.cuda.empty_cache()

    require(flash_attention.launches == flash_before, "the training steps launched no flash kernel")
    out["seconds"] = time.perf_counter() - t_phase
    emit("train", card=out["card"], seconds=out["seconds"], tiny_cuda_vs_cpu=out["tiny_cuda_vs_cpu"],
         flash_under_grad=out["flash_under_grad"])
    return out


# --- mesh: the parallel/ slice on one card ------------------------------------

# four mesh entries naming the card (four row blocks of the slice's index)
MESH_N = 4
MESH_FLOAT_ROWS = 262_144  # the float scans' bf16 and f32x2 copies
# TP decoding: TinyLlama-1.1B width at this depth, 2-way over two entries
TP_N, TP_LAYERS, TP_PROMPT, TP_CHATS, TP_NEW, TP_PAGES = 2, 8, 512, 8, 64, 129
TP_ATOL = TP_RTOL = 2e-4  # tests/test_tp.py's logits bounds
# bf16 TP logits against the f32 model: at most this many times the error the
# unsharded bf16 forward has against the same f32 logits
TP_BF16_VS_F32 = 1.5
# processes: the rows of each rank's slice, and the data-parallel step
RANK_ROWS, DP_PAIRS, DP_LEN = 262_144, 8, 128
RANK_TIMEOUT_S = 600


def mesh_retrieval(torch, dev, seed: int, handover: dict, mesh) -> dict:
    """The slice's index row-sharded over the mesh: the sharded scans bit
    for bit against the unsharded ones, ``fused_query_mesh`` against
    ``fused_query``, and 64 concurrent asks through a sharded VectorIndex."""
    import tempfile

    import numpy as np

    from outline_rag_tpu_torch.engine import RetrievalService, fused_query, fused_query_mesh
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.models import init_colbert_head, init_sparse_head, pooled_embeddings
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8
    from outline_rag_tpu_torch.ops.topk import (
        cosine_topk,
        split_f32_bf16x2,
        topk_float,
        topk_int8,
        topk_plain,
    )
    from outline_rag_tpu_torch.parallel import Mesh, RowShards, row_sharding
    from outline_rag_tpu_torch.parallel import query as pq

    index, encoder, reranker, tok = (handover[k] for k in ("index", "encoder", "reranker", "tok"))
    queries, oracle = handover["queries"], handover["oracle"]
    out = {}
    tb = tok.batch(queries, TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode(), index.read_section():
        state, row_ids = index.snapshot()
        tokens = index.tokens.state
        shards = {name: RowShards.split(x, mesh) for name, x in (
            ("vectors", state.vectors), ("scales", state.scales), ("penalty", state.penalty),
            ("residual", state.residual), ("ids", tokens.ids), ("mask", tokens.mask),
            ("weights", tokens.weights))}
        per = CAPACITY // MESH_N
        require(all(b.shape[0] == per for name in ("vectors", "residual")
                    for b in shards[name].blocks), "four blocks of 262,144 rows, q1 and q2")
        q_emb = pooled_embeddings(encoder, q_ids[:MAX_BATCH], q_mask[:MAX_BATCH])
        qq, qs = quantize_rows_int8(q_emb)

        # the int8r scan: the kernel on each block, each block's rescore, the merge
        scans = {}
        for label, kw_s, kw_u in (
            ("int8r_rescored", dict(rescore_queries=q_emb, rescore_residual=shards["residual"]),
             dict(rescore_queries=q_emb, rescore_residual=state.residual)),
            ("int8_scan", {}, {}),
        ):
            args_s = (qq, qs, shards["vectors"], shards["scales"], CANDIDATES, shards["penalty"])
            args_u = (qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty)
            before = topk_int8.launches
            sv, si = pq.sharded_topk_int8(*args_s, mesh=mesh, **kw_s)
            launched = topk_int8.launches - before
            uv, ui = int8_topk(*args_u, **kw_u)
            require(torch.equal(si, ui) and torch.equal(sv, uv),
                    f"sharded {label} scan bit-equal to the unsharded one")
            scans[label] = {
                "bit_equal": True, "kernel_launches": launched,
                "ms_4_shards_one_card": cuda_ms(torch, lambda a=args_s, k=kw_s: pq.sharded_topk_int8(
                    *a, mesh=mesh, **k), runs=5),
                "ms_unsharded": cuda_ms(torch, lambda a=args_u, k=kw_u: int8_topk(*a, **k), runs=5),
            }
        out["int8"] = {"B": MAX_BATCH, "K": CANDIDATES, "rows": CAPACITY, **scans}

        # the float scans over bf16 and f32x2 copies of the first 262,144 rows
        corpus = oracle[:MESH_FLOAT_ROWS]
        pen = state.penalty[:MESH_FLOAT_ROWS].contiguous()
        mesh2 = Mesh([dev] * MESH_N, ("dcn", "ici"), (2, 2))
        floats = {}
        for mode, stored in (("bf16", corpus.to(torch.bfloat16)), ("f32x2", split_f32_bf16x2(corpus))):
            before = topk_float.launches[mode]
            sv, si = pq.sharded_topk(q_emb, stored, CANDIDATES, pen, mesh=mesh)
            require(topk_float.launches[mode] - before == MESH_N, f"one {mode} launch a shard")
            uv, ui = cosine_topk(q_emb, stored, CANDIDATES, pen)
            require(torch.equal(si, ui) and torch.equal(sv, uv),
                    f"sharded {mode} scan bit-equal to the unsharded one")
            dv, di = pq.sharded_topk_2d(q_emb, stored, CANDIDATES, pen, mesh=mesh2)
            require(torch.equal(di, ui) and torch.equal(dv, uv),
                    f"2 x 2 {mode} merge bit-equal to the unsharded scan")
            floats[mode] = {
                "bit_equal": True, "two_level_bit_equal": True,
                "ms_4_shards_one_card": cuda_ms(torch, lambda s=stored: pq.sharded_topk(
                    q_emb, s, CANDIDATES, pen, mesh=mesh), runs=5),
                "ms_unsharded": cuda_ms(torch, lambda s=stored: cosine_topk(
                    q_emb, s, CANDIDATES, pen), runs=5),
            }
            del stored
        out["float"] = {"rows": MESH_FLOAT_ROWS, "B": MAX_BATCH, "K": CANDIDATES, **floats}

        # fused_query_mesh against fused_query for the 64 queries, the hybrid
        # weights off and then on (seeded sparse and ColBERT heads for the
        # second, taken off again after: the lifecycle phase serves without)
        gen = torch.Generator(device=dev).manual_seed(seed + 31)
        fused = {}
        for label, weights in (("off", {}), ("on", dict(lex_weight=HYB_LEX,
                                                         colbert_weight=HYB_COLBERT))):
            if weights:
                init_colbert_head(init_sparse_head(encoder, gen), gen)
            try:
                common = dict(top_k=TOP_K, rerank_k=RERANK_K, **weights)
                got = fused_query_mesh(
                    encoder, reranker, q_ids, q_mask, shards["vectors"], shards["scales"],
                    shards["penalty"], shards["ids"], shards["mask"], shards["residual"],
                    mesh=mesh, tok_weights=shards["weights"], **common)
                want = fused_query(
                    encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                    tokens.ids, tokens.mask, state.residual, tok_weights=tokens.weights, **common)
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"fused_query_mesh (hybrid {label}) gives fused_query's hits and scores")
                fused[label] = {"bit_equal": True, "queries": len(queries)}
            finally:
                encoder.sparse = encoder.colbert = None
        out["fused"] = fused
        del shards, corpus, pen

    # 64 concurrent asks through a VectorIndex loaded row-sharded from the
    # slice index's snapshot
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        path = os.path.join(tmp, "index")
        t0 = time.perf_counter()
        index.save(path)
        sharded = VectorIndex.load(path, sharding=row_sharding(mesh))
        load_s = time.perf_counter() - t0
    finally:
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    sstate, srow_ids = sharded.snapshot()
    require(sharded.mesh == mesh and sharded.size == index.size
            and all(b.shape[0] == sharded.capacity // MESH_N for b in sstate.residual.blocks),
            "the loaded index is row-sharded over the mesh, q2 plane included")
    service = RetrievalService(sharded, handover["service"].embedder,
                               handover["service"].reranker, top_k=TOP_K, rerank_k=RERANK_K)
    require(service.fused, "the sharded service runs the fused path")
    serve_burst(service, queries[:MAX_BATCH])  # warm-up
    topk_int8.launches = 0
    answers, wall_s = serve_burst(service, queries)
    launches = topk_int8.launches
    require(launches > 0, "the sharded asks launched the topk_int8 kernel")
    check_answers(np, answers, handover["deleted"])
    with torch.inference_mode():
        _, _, _, idx, _ = fused_query_mesh(
            encoder, reranker, q_ids[:MAX_BATCH], q_mask[:MAX_BATCH], sstate.vectors,
            sstate.scales, sstate.penalty, sharded.tokens.state.ids, sharded.tokens.state.mask,
            sstate.residual, mesh=mesh, top_k=TOP_K, rerank_k=RERANK_K)
        _, oi = topk_plain(q_emb, oracle, TOP_K, state.penalty)
    got = [{str(srow_ids[r]) for r in row} for row in idx.tolist()]
    want = [{str(row_ids[r]) for r in row} for row in oi.tolist()]
    recall = sum(len(a & b) for a, b in zip(got, want)) / (TOP_K * len(got))
    require(recall >= RECALL_MIN, f"sharded recall@12 {recall} >= {RECALL_MIN}")
    out["asks"] = {"save_and_sharded_load_s": load_s, "recall_at_12": recall,
                   "topk_int8_launches": launches,
                   "unsharded_p50_ms": handover["serve_p50_ms"],
                   **{f"{key}_4_shards_one_card" if key.endswith("ms") else key: value
                      for key, value in latency_fields(answers, wall_s).items()}}
    del sharded, service, sstate
    return out


def ring_logits(torch, decoder, p, cfg, toks, mesh=None):
    """The logits of ``toks`` prefilled in chunks of 256 on the ring route
    (no kernel), the ring sharded on ``mesh`` for TP parameters."""
    from outline_rag_tpu_torch.parallel.tp import shard_decoder_cache

    cache = decoder.init_cache(cfg, toks.shape[0], toks.device)
    if mesh is not None:
        cache = shard_decoder_cache(cache, mesh)
    out = []
    with torch.inference_mode():
        for start in range(0, toks.shape[1], 256):
            pos = torch.full((toks.shape[0],), start, dtype=torch.int32, device=toks.device)
            out.append(decoder.decoder_forward(p, toks[:, start:start + 256], cache, pos, cfg)[0])
    return torch.cat(out, dim=1)


def rel_rms(a, ref) -> float:
    return float((a - ref).norm() / ref.norm())


def tp_logits(torch, dev, decoder, params, tp_params, cfg, mesh, kv_int8: bool, toks,
              ref32=None) -> dict:
    """The prompts ``toks`` prefilled in chunks of 256 through a paged pool,
    unsharded and 2-way TP: the logits' largest difference against JAX's
    bounds and its relative RMS; with ``ref32`` (the f32 model's logits),
    each forward's relative RMS error against it."""
    pages = toks.shape[1] // PAGE
    kv = "int8" if kv_int8 else None
    pools = [decoder.init_paged_cache(cfg, 2, 1 + 2 * pages, PAGE, kv_dtype=kv, device=dev),
             decoder.init_paged_cache(cfg, 2, 1 + 2 * pages, PAGE, kv_dtype=kv, mesh=mesh)]
    logits = [[], []]
    with torch.inference_mode():
        for pool, p, out in zip(pools, (params, tp_params), logits):
            pool.table[:, :pages] = torch.arange(1, 1 + 2 * pages, device=dev).reshape(2, pages)
            for start in range(0, toks.shape[1], 256):
                pos = torch.full((2,), start, dtype=torch.int32, device=dev)
                lg, _ = decoder.decoder_forward(p, toks[:, start:start + 256], pool, pos, cfg)
                out.append(lg)
    ref, got = torch.cat(logits[0], dim=1), torch.cat(logits[1], dim=1)
    diff = (got - ref).abs()
    out = {"max_abs_err": float(diff.max()),
           "within_tp_bounds": bool((diff <= TP_ATOL + TP_RTOL * ref.abs()).all()),
           "rel_rms_err": rel_rms(got, ref),
           "argmax_agree": float((got.argmax(-1) == ref.argmax(-1)).float().mean())}
    if ref32 is not None:
        out["unsharded_rel_rms_vs_f32"] = rel_rms(ref, ref32)
        out["tp_rel_rms_vs_f32"] = rel_rms(got, ref32)
        out["tp_over_unsharded_vs_f32"] = out["tp_rel_rms_vs_f32"] / out["unsharded_rel_rms_vs_f32"]
    return out


def tp_streams(torch, dev, decoder, params, tp_params, cfg, mesh, kv_int8: bool,
               prompts, f32=None) -> dict:
    """Greedy streams of TP_NEW tokens for the chats through
    ``DecodeBatcher(mesh=...)`` and the unsharded batcher. Where a stream
    parts from the unsharded one, the step is a near-tie in the model: at
    that step (the prompt and the common prefix prefilled) the f32 model's
    logits of the two tokens chosen lie within twice the largest error the
    unsharded bf16 forward has against those f32 logits there, so that
    forward itself cannot tell them apart. ``f32`` is the f32 model
    ``(params, cfg)``; without it (w8a8 weights, whose TP logits are
    bit-equal) every stream must be equal."""
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_kv_write
    from outline_rag_tpu_torch.serve import DONE, DecodeBatcher

    kv = "int8" if kv_int8 else None

    def run(p, m):
        b = DecodeBatcher(p, cfg, slots=TP_CHATS, chunk_tokens=DEC_CHUNK, eos_id=-1,
                          kv_pages=TP_PAGES, page_size=PAGE, kv_int8=kv_int8, mesh=m, device=dev)
        try:
            qs = [b.submit(pr, 0.0, 1.0, TP_NEW) for pr in prompts]
            streams = []
            for q in qs:
                toks = []
                while True:
                    item = q.get(timeout=600)
                    if item is DONE:
                        break
                    if isinstance(item, Exception):
                        raise item
                    toks.extend(item)
                streams.append(toks)
            return streams
        finally:
            b.close()

    def last_logits(p, m, seq):
        pages = -(-len(seq) // PAGE)
        pool = decoder.init_paged_cache(cfg, 1, 1 + pages, PAGE, kv_dtype=kv, device=dev, mesh=m)
        pool.table[0, :pages] = torch.arange(1, 1 + pages, device=dev)
        ids = torch.tensor([seq], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            for start in range(0, len(seq), 256):
                pos = torch.full((1,), start, dtype=torch.int32, device=dev)
                lg, _ = decoder.decoder_forward(p, ids[:, start:start + 256], pool, pos, cfg)
        return lg[0, -1]

    want = run(params, None)
    paged_attention.launches = paged_kv_write.launches = 0
    got = run(tp_params, mesh)
    launches = {"paged_attention": paged_attention.launches,
                "paged_kv_write": paged_kv_write.launches}
    require(all(n > 0 for n in launches.values()),
            f"the TP streams launched the paged kernels: {launches}")
    partings = []
    for prompt, a, b in zip(prompts, got, want):
        require(len(a) == len(b) == TP_NEW, "every stream ran its full length")
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if step is None:
            continue
        require(f32 is not None, f"a w8a8 TP stream parted at step {step}")
        seq = prompt + b[:step]
        ref = last_logits(params, None, seq)
        tp = last_logits(tp_params, mesh, seq)
        ids = torch.tensor([seq], dtype=torch.int32, device=dev)
        ref32 = ring_logits(torch, decoder, *f32, ids)[0, -1]
        err = float((ref - ref32).abs().max())
        gap32 = abs(float(ref32[b[step]] - ref32[a[step]]))
        top2 = ref.topk(2).values
        partings.append({"step": step, "top2_gap": float(top2[0] - top2[1]),
                         "f32_gap_of_the_two_tokens": gap32,
                         "unsharded_max_abs_err_vs_f32_there": err,
                         "max_abs_logit_diff_there": float((tp - ref).abs().max()),
                         "argmax_differs_there": int(tp.argmax()) != int(ref.argmax())})
        require(gap32 <= 2 * err, f"a parting stream is a near-tie: the two tokens' f32 gap "
                f"{gap32} at step {step}, the unsharded bf16 forward's error there {err}")
    return {"equal_streams": len(prompts) - len(partings), "chats": len(prompts),
            "partings": partings, "launches": launches}


def mesh_tp(torch, dev, seed: int) -> dict:
    """TinyLlama-1.1B width (TP_LAYERS layers), 2-way TP over two entries of
    the card: the sharded paged kernels against the unsharded kernel's head
    slices, the f32 model's TP logits against its unsharded logits, then
    logits and greedy streams against the unsharded decoder for bf16
    weights on a bf16 pool and an int8 pool, and for w8a8 weights."""
    import dataclasses

    import numpy as np

    import outline_rag_tpu_torch.models.decoder as decoder
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_attention_sharded
    from outline_rag_tpu_torch.parallel.tp import model_mesh, shard_decoder_params

    mesh = model_mesh(TP_N, [dev] * TP_N)
    out = {"layers": TP_LAYERS, "tp": TP_N, "heads": DEC_HEADS, "kv_heads": DEC_KV_HEADS}
    g = torch.Generator(device=dev).manual_seed(seed + 41)
    kernels = {}
    for kv in ("bf16", "int8"):
        q, pk, pv, table, pos, *scales = paged_case(torch, dev, g, DEC_SLOTS, 1, kv)
        ks, vs = scales if scales else (None, None)
        whole = paged_attention(q, pk, pv, table, pos, ks, vs)
        parts = paged_attention_sharded(q, pk, pv, table, pos, ks, vs, mesh=mesh)
        require(torch.equal(torch.cat(parts, dim=2), whole),
                f"paged_attention_sharded ({kv} pool) equals the head slices bit for bit")
        kernels[kv] = {"bit_equal": True, "B": DEC_SLOTS,
                       "ms_2_shards_one_card": cuda_ms(torch, lambda a=(q, pk, pv, table, pos, ks,
                                                                          vs): paged_attention_sharded(
                           *a, mesh=mesh)),
                       "ms_unsharded": cuda_ms(torch, lambda a=(q, pk, pv, table, pos, ks, vs):
                                               paged_attention(*a))}
        del q, pk, pv, scales
    out["paged_attention_sharded"] = kernels

    cfg = dataclasses.replace(decoder.DecoderConfig.tinyllama_1b(), layers=TP_LAYERS)
    params = decoder.fuse_decoder_params(
        decoder.init_decoder(cfg, torch.Generator(device=dev).manual_seed(seed + 43), dev))
    rng = np.random.default_rng(seed + 43)
    prompts = [rng.integers(3, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, TP_PROMPT + 1, TP_CHATS)]
    toks = torch.randint(0, cfg.vocab_size, (2, TP_PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(seed + 47), device=dev)
    # the f32 model (the bf16 weights cast up, the ring route): its 2-way TP
    # logits held to JAX's bounds, and the reference of the bf16 checks
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = decoder.cast_decoder_params(params, torch.float32)
    ref32 = ring_logits(torch, decoder, params32, cfg32, toks)
    got32 = ring_logits(torch, decoder, shard_decoder_params(params32, mesh, cfg32), cfg32, toks,
                        mesh)
    diff = (got32 - ref32).abs()
    out["f32"] = {"max_abs_err": float(diff.max()), "rel_rms_err": rel_rms(got32, ref32),
                  "within_tp_bounds": bool((diff <= TP_ATOL + TP_RTOL * ref32.abs()).all())}
    require(out["f32"]["within_tp_bounds"],
            f"f32 TP logits within atol {TP_ATOL} + rtol {TP_RTOL} of the unsharded: {out['f32']}")
    emit("mesh_tp", config="f32_ring", **out["f32"])
    del got32, diff
    read_mode = decoder._INT8_MODE
    configs = {}
    try:
        for name, kv_int8, int8_weights in (("bf16", False, False), ("kv_int8", True, False),
                                            ("w8a8_weights", False, True)):
            p = params
            if int8_weights:
                # int8 weights under TP are served by w8a8 alone (the JAX
                # package's rule); switched here as the CPU tests switch it
                decoder._INT8_MODE = "w8a8"
                p = decoder.quantize_decoder_params(params)
            tp_p = shard_decoder_params(p, mesh, cfg)
            logits = tp_logits(torch, dev, decoder, p, tp_p, cfg, mesh, kv_int8, toks,
                               None if int8_weights else ref32)
            streams = tp_streams(torch, dev, decoder, p, tp_p, cfg, mesh, kv_int8, prompts,
                                 None if int8_weights else (params32, cfg32))
            with torch.inference_mode():
                step_ms = {}
                for label, pp, m in (("unsharded", p, None), ("2_shards_one_card", tp_p, mesh)):
                    pool = decoder.init_paged_cache(cfg, TP_CHATS, 1 + TP_CHATS * 4, PAGE,
                                                    kv_dtype="int8" if kv_int8 else None,
                                                    device=dev, mesh=m)
                    pool.table[:, :4] = torch.arange(1, 1 + TP_CHATS * 4, device=dev).reshape(
                        TP_CHATS, 4)
                    tok = torch.ones((TP_CHATS, 1), dtype=torch.int32, device=dev)
                    at = torch.full((TP_CHATS,), 300, dtype=torch.int32, device=dev)
                    step_ms[f"decode_step_ms_{label}"] = cuda_ms(
                        torch, lambda pp=pp, pool=pool: decoder.decoder_forward(
                            pp, tok, pool, at, cfg), runs=5)
            configs[name] = {"logits": logits, "streams": streams, **step_ms}
            if name == "w8a8_weights":
                require(logits["max_abs_err"] == 0.0, "w8a8 TP logits bit-equal to unsharded")
            else:
                # a bf16 forward rounds its activations between layers, so one
                # rounding moved by the row-parallel sum's order moves bf16
                # logits past JAX's 2e-4 (printed above, and met in f32): the
                # TP forward is held to the f32 model at TP_BF16_VS_F32 times
                # the error the unsharded bf16 forward has there
                require(logits["tp_over_unsharded_vs_f32"] <= TP_BF16_VS_F32,
                        f"{name} TP logits' error against the f32 model within "
                        f"{TP_BF16_VS_F32}x the unsharded forward's: {logits}")
            emit("mesh_tp", config=name, **configs[name])
            del tp_p, p
            decoder._INT8_MODE = read_mode
    finally:
        decoder._INT8_MODE = read_mode
    out["configs"] = configs
    del params32, ref32
    return out


def mesh_phase(torch, dev, seed: int, handover: dict) -> dict:
    """The parallel/ slice: the slice's index row-sharded over four entries
    of the card, 2-way TP decoding over two, and the multi-process index
    build, data-parallel step and NCCL start as process groups."""
    import numpy as np

    from outline_rag_tpu_torch.models import train as tt
    from outline_rag_tpu_torch.ops.topk import cosine_topk
    from outline_rag_tpu_torch.parallel import data_mesh
    from outline_rag_tpu_torch.tools import dryrun_multichip as ranks
    from outline_rag_tpu_torch.tools.timing import card

    t_phase = time.perf_counter()
    mesh = data_mesh(devices=[dev] * MESH_N)
    out = {"card": card(), "shards": MESH_N}
    out["retrieval"] = mesh_retrieval(torch, dev, seed, handover, mesh)
    emit("mesh_retrieval", **out["retrieval"])
    torch.cuda.empty_cache()

    # the process groups run while the TP checks do (their timings are
    # taken above and inside mesh_tp before any group starts its work)
    demo_args = dict(rows=RANK_ROWS, dim=DIM, queries=MAX_BATCH, k=CANDIDATES, seed=seed,
                     device=str(dev))
    dp_args = dict(cfg="bge_m3", batch=DP_PAIRS, seq=DP_LEN, seed=seed + 51, device=str(dev))
    groups = {}
    try:
        groups["demo"] = ranks.start_ranks("demo", 2, "gloo", demo_args)
        groups["dp"] = ranks.start_ranks("dp", 2, "gloo", dp_args)
        groups["nccl"] = ranks.start_ranks("allreduce", 1, "nccl", dict(device=str(dev)))
        out["tp"] = mesh_tp(torch, dev, seed)
        t0 = time.perf_counter()
        results = {name: group.wait(RANK_TIMEOUT_S) for name, group in groups.items()}
        out["ranks_wait_s"] = time.perf_counter() - t0
    finally:
        for group in groups.values():
            group.kill()

    # two ranks' build and query against one process scanning the union
    r0, r1 = results["demo"]
    require(r0 == r1, "both ranks return the same global top-k")
    union = np.concatenate([np.random.default_rng(seed + h).standard_normal(
        (RANK_ROWS, DIM)).astype(np.float32) for h in range(2)])
    union /= np.linalg.norm(union, axis=1, keepdims=True)
    q = torch.as_tensor(ranks.demo_queries(MAX_BATCH, DIM, seed + 99), device=dev)
    with torch.inference_mode():
        uv, ui = cosine_topk(q, torch.as_tensor(union, device=dev), CANDIDATES)
    require(ui.tolist() == r0["idx"] and uv.tolist() == r0["vals"],
            "two gloo ranks' sharded query equals one process's scan of the union")
    del union
    # the data-parallel step against one device's step on the same global batch
    cfg, state, opt, batch = ranks.contrastive_setup("bge_m3", DP_PAIRS, DP_LEN, seed + 51, dev)
    _, single = tt.make_train_step(cfg, opt)(state, batch)
    single_loss = float(single["loss"])
    d0, d1 = results["dp"]
    require(d0 == d1, "both ranks applied the same update")
    dp_rel = abs(d0["loss"] - single_loss) / abs(single_loss)
    require(dp_rel <= 1e-5, f"data-parallel loss within rtol 1e-5 of one device's: {dp_rel}")
    # the gradient the step applied (AdamW's first moment) against one
    # device's gradient of the global batch: counted once, not per rank
    require(d0["grad_rel_err"] <= 1e-5,
            f"data-parallel gradient within 1e-5 (relative L2) of one device's: {d0}")
    del state, batch, opt
    torch.cuda.empty_cache()
    (nccl,) = results["nccl"]
    require(nccl["backend"] == "nccl" and nccl["sum"] == [1.0] * 4, f"nccl world of 1: {nccl}")
    out["processes"] = {
        "demo": {"ranks": 2, "backend": "gloo", "rows_per_rank": RANK_ROWS, "dim": DIM,
                 "B": MAX_BATCH, "K": CANDIDATES, "equals_union_scan": True},
        "dp": {"ranks": 2, "backend": "gloo", "config": "bge-m3 f32", "pairs": DP_PAIRS,
               "tokens": DP_LEN, "loss": d0["loss"], "single_device_loss": single_loss,
               "loss_rel_err": dp_rel, "grad_rel_err": d0["grad_rel_err"],
               **{k: d0[k] for k in ("grad_leaf_rel_err_max", "grad_leaf_worst",
                                     "grad_null_leaves")}},
        "nccl_world_1": nccl,
    }
    out["seconds"] = time.perf_counter() - t_phase
    emit("mesh", card=out["card"], seconds=out["seconds"], ranks_wait_s=out["ranks_wait_s"],
         processes=out["processes"])
    return out


# --- hostmem: the int8r host-residual tier at 10M rows ------------------------

# the JAX package's 10M-row rung at bge-m3's width, built in segments that are
# drawn again for the oracle; the prefix of the plane-size ratio (1/8 of it)
HOST_ROWS, HOST_SEG, HOST_PREFIX = 10_000_000, 250_000, 1_250_000
HOST_M, HOST_B = 64, (32, 128)  # rescore_m; query batches
HOST_COPY_BYTES = 256 << 20  # the pinned copy_ that gives the PCIe rates
HOST_RING = 64  # index sets the timed gathers walk (128 MiB of rows: past the L2)
HOST_BLOCK = 4096  # rows of one append timed alone (an ingest block)
# the card's host link, published: PCIe Gen5 x16, bytes/s each way (a 256 MiB
# pinned copy_ reads less, and the append's writes beat that copy's rate)
PCIE_RATE = 64e9


def host_segment(torch, dev, seed: int, s: int):
    """Segment ``s`` of the seeded corpus: unit rows (f32, on the card) from a
    generator of its own, so the oracle draws the same rows again."""
    g = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + 500 + s)
    rows = min(HOST_SEG, HOST_ROWS - s * HOST_SEG)
    return torch.nn.functional.normalize(torch.randn((rows, DIM), generator=g, device=dev), dim=1)


def host_oracle(torch, dev, seed: int, queries, penalty):
    """The exact fp32 top-``TOP_K`` over every segment drawn again: each
    segment's scores (TF32 off) with the penalty, sorted stably, merged with
    the running list, lower rows first among ties."""
    best_v = torch.full((queries.shape[0], TOP_K), -math.inf, device=dev)
    best_i = torch.zeros((queries.shape[0], TOP_K), dtype=torch.long, device=dev)
    for s in range(-(-HOST_ROWS // HOST_SEG)):
        lo = s * HOST_SEG
        x = host_segment(torch, dev, seed, s)
        scores = queries @ x.T + penalty[lo:lo + x.shape[0]][None, :]
        v, i = torch.sort(scores, dim=1, descending=True, stable=True)
        cat_v = torch.cat([best_v, v[:, :TOP_K]], dim=1)
        cat_i = torch.cat([best_i, i[:, :TOP_K] + lo], dim=1)
        order = torch.sort(cat_v, dim=1, descending=True, stable=True).indices[:, :TOP_K]
        best_v, best_i = torch.gather(cat_v, 1, order), torch.gather(cat_i, 1, order)
        del x, scores, v, i
    return best_v, best_i


def recall_at_k(got, want) -> float:
    """Mean share of each query's reference rows found in its list."""
    hits = [len(set(a) & set(b)) / len(b) for a, b in zip(got.tolist(), want.tolist())]
    return sum(hits) / len(hits)


def mem_total() -> str:
    with open("/proc/meminfo") as f:
        return next(line for line in f if line.startswith("MemTotal")).split(":", 1)[1].strip()


def hostmem_phase(torch, dev, seed: int) -> dict:
    """The int8r index at the JAX package's 10M-row rung with its q2 plane in
    page-locked host memory (``ops/hostmem.py``), its rows gathered by the
    card over PCIe (``host_gather_rows``)."""
    import itertools

    import numpy as np

    from outline_rag_tpu_torch.ops.hostmem import (
        gather_rows_plain,
        host_gather_rows,
        host_scatter_rows,
        make_host_append,
        scatter_rows_plain,
        to_pinned_host,
    )
    from outline_rag_tpu_torch.ops.hostres import host_residual_topk
    from outline_rag_tpu_torch.ops.quant import (
        int8_topk,
        int8_topk_candidates,
        quantize_rows_int8,
        quantize_rows_int8_residual,
    )
    from outline_rag_tpu_torch.ops.topk import NEG
    from outline_rag_tpu_torch.testing import tie_aware_mismatches
    from outline_rag_tpu_torch.tools.timing import card

    t_phase = time.perf_counter()
    n, segs = HOST_ROWS, -(-HOST_ROWS // HOST_SEG)
    out = {"card": card(), "rows": n, "dim": DIM, "segment_rows": HOST_SEG, "segments": segs,
           "mem_total": mem_total(), "k": TOP_K, "rescore_m": HOST_M}
    emit("hostmem_start", **out)
    pin = None if dev.type == "cuda" else "cpu"  # the card's placement, or a CPU rehearsal's
    host_gather_rows.launches = host_scatter_rows.launches = 0

    # build: q1, the scales and the penalty on the card; q2 on the card (a)
    # and, through the append, in a page-locked plane (b)
    t0 = time.perf_counter()
    plane = to_pinned_host(np.zeros((n, DIM), np.int8), pin)
    out["pin_s"] = time.perf_counter() - t0
    require(plane.is_pinned() or pin == "cpu", "the q2 plane is page-locked")
    emit("hostmem_pinned", pin_s=out["pin_s"], bytes=plane.numel())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # device_gb: this phase's own peak
    q1 = torch.empty((n, DIM), dtype=torch.int8, device=dev)
    q2 = torch.empty_like(q1)
    scale = torch.empty(n, device=dev)
    append = make_host_append()
    t0 = time.perf_counter()
    for s in range(segs):
        lo = s * HOST_SEG
        a, sc, r = quantize_rows_int8_residual(host_segment(torch, dev, seed, s))
        hi = lo + a.shape[0]
        q1[lo:hi], scale[lo:hi], q2[lo:hi] = a, sc, r
        append(plane, r, torch.arange(lo, hi, device=dev, dtype=torch.int32))
        del a, sc, r
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    equal = all(torch.equal(plane[lo:lo + HOST_SEG].to(dev), q2[lo:lo + HOST_SEG])
                for lo in range(0, n, HOST_SEG))
    require(equal, "the pinned q2 plane is byte-equal to the q2 plane on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    penalty = torch.where(torch.rand(n, generator=g, device=dev) < 0.01, NEG, 0.0).float()
    queries = torch.nn.functional.normalize(
        torch.randn((max(HOST_B), DIM), generator=g, device=dev), dim=1)
    qq, qs = quantize_rows_int8(queries)
    out.update(pinned_equal_device=equal, live_rows=int((penalty == 0).sum()),
               device_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None)
    emit("hostmem_build", pin_s=out["pin_s"], build_s=out["build_s"],
         pinned_equal_device=equal, device_gb=out["device_gb"])

    def host_tier(b):
        sc, ci, cs = int8_topk_candidates(qq[:b], qs[:b], q1, scale, HOST_M, queries[:b], penalty)
        return host_residual_topk(sc.cpu().numpy(), ci.cpu().numpy(), cs.cpu().numpy(),
                                  queries[:b].cpu().numpy(), plane.numpy(), TOP_K)

    def ranked(b, residual):
        return int8_topk(qq[:b], qs[:b], q1, scale, TOP_K, penalty, rescore_queries=queries[:b],
                         rescore_m=HOST_M, rescore_residual=residual)

    # the checks: pinned q2 == device q2 bit for bit; the host tier; recall
    t0 = time.perf_counter()
    _, oracle_i = host_oracle(torch, dev, seed, queries, penalty)
    out["oracle_s"] = time.perf_counter() - t0
    checks = {}
    for b in HOST_B:
        dv, di = ranked(b, q2)
        hv, hi = ranked(b, plane)
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(hi, di) and torch.equal(hv, dv))
        require(bit_equal, f"B={b}: int8_topk with pinned q2 bit-equal to device q2")
        tv, ti = host_tier(b)
        tier_bad = tie_aware_mismatches(torch.from_numpy(tv), torch.from_numpy(ti), dv.cpu(),
                                        di.cpu(), VALUE_TOL)
        tier_err = float(np.abs(tv - dv.cpu().numpy()).max())
        require(tier_bad == 0 and tier_err <= VALUE_TOL,
                f"B={b}: the host tier's rows equal the device rescore's (values within "
                f"{VALUE_TOL}, rows where no neighbour is as close): {tier_bad} slots, {tier_err}")
        recall = recall_at_k(hi.cpu(), oracle_i[:b].cpu())
        require(recall >= RECALL_MIN, f"B={b}: recall@{TOP_K} {recall} >= {RECALL_MIN}")
        checks[b] = {"bit_equal": bit_equal, "host_tier_idx_equal": bool(np.array_equal(ti, di.cpu().numpy())),
                     "host_tier_mismatches": tier_bad, "host_tier_max_abs_err": tier_err,
                     f"recall_at_{TOP_K}": recall}
        emit("hostmem_check", B=b, **checks[b])
    out["checks"] = checks
    launches = {"host_gather_rows": host_gather_rows.launches,
                "host_scatter_rows": host_scatter_rows.launches}
    require(launches["host_gather_rows"] > 0 and launches["host_scatter_rows"] > 0,
            f"the phase ran both host kernels: {launches}")
    out["launches"] = launches

    # each kernel against its twin, out-of-range indices included
    idx = torch.randint(0, n, (32, HOST_M), generator=g, device=dev, dtype=torch.int32)
    idx[0, :4] = torch.tensor([-1, n, n + 12345, -(2**31)], device=dev, dtype=torch.int32)
    idx[1, :2] = torch.tensor([0, n - 1], device=dev, dtype=torch.int32)
    got, want = host_gather_rows(plane, idx), gather_rows_plain(q2, idx)
    gather_equal = bool(torch.equal(got, want))
    gather_err = float((got.int() - want.int()).abs().max())
    require(gather_equal and not got[0, :4].any(),
            "host_gather_rows byte-equal to its twin, zero rows for indices out of range")
    small = to_pinned_host(torch.randint(-127, 128, (65_536, DIM), generator=g, device=dev,
                                         dtype=torch.int8), pin)
    small_on_card = small.to(dev)
    rows = torch.randint(-127, 128, (HOST_BLOCK, DIM), generator=g, device=dev, dtype=torch.int8)
    at = torch.randperm(65_535, generator=g, device=dev)[:HOST_BLOCK].to(torch.int32)
    at[:3] = torch.tensor([-1, 65_536, 70_000], device=dev, dtype=torch.int32)
    at[3] = 65_535
    host_scatter_rows(small, rows, at)
    torch.cuda.synchronize()
    written, want = small.to(dev), scatter_rows_plain(small_on_card, rows, at)
    scatter_equal = bool(torch.equal(written, want))
    scatter_err = float((written.int() - want.int()).abs().max())
    require(scatter_equal, "host_scatter_rows byte-equal to its twin, rows out of range dropped")
    del small, small_on_card
    out["kernels_vs_twins"] = {"gather_equal": gather_equal, "gather_max_abs_err": gather_err,
                               "scatter_equal": scatter_equal, "scatter_max_abs_err": scatter_err}

    # times: the PCIe rates of a pinned copy_, each kernel, its twin, the yardstick
    src = torch.empty(HOST_COPY_BYTES, dtype=torch.uint8, pin_memory=pin is None)
    dst = torch.empty(HOST_COPY_BYTES, dtype=torch.uint8, device=dev)
    h2d_ms = cuda_ms(torch, lambda: dst.copy_(src, non_blocking=True))
    d2h_ms = cuda_ms(torch, lambda: src.copy_(dst, non_blocking=True))
    del src, dst
    rates = {"h2d_gbs": HOST_COPY_BYTES / h2d_ms / 1e6, "d2h_gbs": HOST_COPY_BYTES / d2h_ms / 1e6,
             "h2d_ms": h2d_ms, "d2h_ms": d2h_ms, "copy_bytes": HOST_COPY_BYTES}
    gathered = 32 * HOST_M * DIM

    def ring_of(rows_max):
        return itertools.cycle([torch.randint(0, rows_max, (32, HOST_M), generator=g, device=dev,
                                              dtype=torch.int32) for _ in range(HOST_RING)])

    whole, part = ring_of(n), ring_of(HOST_PREFIX)
    prefix = plane[:HOST_PREFIX]
    gather = both_ms(torch, lambda: host_gather_rows(plane, next(whole)))
    prefix_ms = cuda_ms_many(torch, lambda: host_gather_rows(prefix, next(part)))["device_ms"]
    whole_ms = cuda_ms_many(torch, lambda: host_gather_rows(plane, next(whole)))["device_ms"]
    idx_cpu = idx.clamp(0, n - 1).cpu()
    gather.update(
        shape={"B": 32, "M": HOST_M, "D": DIM, "bytes": gathered},
        plain_ms=cuda_ms(torch, lambda: gather_rows_plain(plane, idx_cpu)),
        plain_on_card_device_ms=cuda_ms_many(torch, lambda: gather_rows_plain(q2, next(whole)))["device_ms"],
        library_ms=cuda_ms(torch, lambda: plane[next(whole).cpu().long()].to(dev, non_blocking=True)),
        bound_ms=1e3 * gathered / PCIE_RATE, bound_by="bytes",
        copy_bound_ms=1e3 * gathered / (rates["h2d_gbs"] * 1e9),
        prefix_rows=HOST_PREFIX, prefix_device_ms=prefix_ms, whole_device_ms=whole_ms,
        plane_size_ratio=whole_ms / prefix_ms, gbs=gathered / gather["device_ms"] / 1e6)
    seg_rows, seg_idx = q2[:HOST_SEG], torch.arange(HOST_SEG, device=dev, dtype=torch.int32)
    seg_rows_cpu, seg_idx_cpu = seg_rows.cpu(), seg_idx.cpu()
    blocks = itertools.cycle([(q2[lo:lo + HOST_BLOCK], torch.arange(
        lo, lo + HOST_BLOCK, device=dev, dtype=torch.int32)) for lo in range(0, 64 * HOST_BLOCK, HOST_BLOCK)])
    block = both_ms(torch, lambda: host_scatter_rows(plane, *next(blocks)))
    scatter = {  # each write puts back the bytes the plane holds
        "shape": {"rows": HOST_SEG, "D": DIM, "bytes": HOST_SEG * DIM},
        "ms": cuda_ms(torch, lambda: host_scatter_rows(plane, seg_rows, seg_idx)),
        "plain_ms": cuda_ms(torch, lambda: scatter_rows_plain(plane, seg_rows_cpu, seg_idx_cpu), runs=3),
        # the timed rows are one run, so one pinned copy_ of the slice writes the same
        "library_ms": cuda_ms(torch, lambda: plane[:HOST_SEG].copy_(seg_rows, non_blocking=True)),
        "bound_ms": 1e3 * HOST_SEG * DIM / PCIE_RATE, "bound_by": "bytes",
        "copy_bound_ms": 1e3 * HOST_SEG * DIM / (rates["d2h_gbs"] * 1e9),
        "block": {"rows": HOST_BLOCK, **block, "bound_ms": 1e3 * HOST_BLOCK * DIM / PCIE_RATE}}
    scatter["gbs"] = HOST_SEG * DIM / scatter["ms"] / 1e6
    require(all(torch.equal(plane[lo:lo + HOST_SEG].to(dev), q2[lo:lo + HOST_SEG])
                for lo in range(0, n, HOST_SEG)), "the timed appends left the plane as it was")

    # queries a second through the three routes, B = 32
    qps = {}
    for route, fn in (("device_q2", lambda: ranked(32, q2)), ("pinned_q2", lambda: ranked(32, plane)),
                      ("host_tier", lambda: host_tier(32))):
        ms = cuda_ms(torch, fn)
        qps[route] = {"ms": ms, "qps": 32e3 / ms}
    qps["pinned_over_device"] = qps["pinned_q2"]["ms"] / qps["device_q2"]["ms"]
    out.update(rates=rates, gather=gather, scatter=scatter, qps_b32=qps)
    del plane, q1, q2, scale
    out["seconds"] = time.perf_counter() - t_phase
    emit("hostmem", card=out["card"], seconds=out["seconds"], launches=launches, rates=rates,
         gather=gather, scatter=scatter, qps_b32=qps, oracle_s=out["oracle_s"])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # the decoder reads its int8 strategy once, at import: the w8a16 kernel
    os.environ["DECODER_INT8_MODE"] = "kernel"
    os.environ["DECODER_INT4_MODE"] = "w4a8"  # and its int4 strategy (the default)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from outline_rag_tpu_torch.device import resolve_device
    from outline_rag_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    from outline_rag_tpu_torch.tools.timing import card

    smi = card()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(dev),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    built = _build.build_library()
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=built.seconds, library=built.path.name, ptxas=ptxas)

    kernel = kernel_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    launches, handover = slice_phase(torch, dev, args.seed)
    mesh = mesh_phase(torch, dev, args.seed, handover)
    torch.cuda.empty_cache()
    life = lifecycle_phase(torch, dev, args.seed, handover)
    models = (handover["service"].embedder, handover["service"].reranker)
    slice_p50_ms = handover["serve_p50_ms"]
    del handover  # the index, service and oracle of both phases
    torch.cuda.empty_cache()
    web = http_phase(torch, dev, args.seed, *models, slice_p50_ms)
    del models
    torch.cuda.empty_cache()
    floats, scan_floor_launches = kernel_float_phase(torch, dev, args.seed)
    flash = flash_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    long = long_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    paged = kernel_paged_phase(torch, dev, args.seed)
    kv_write = kernel_kv_write_phase(torch, dev, args.seed)
    linear = kernel_int8_linear_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    int4 = kernel_int4_phase(torch, dev, args.seed)
    int4_floor = kernel_int4_floor_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    chat = decoder_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    hybrid = hybrid_phase(torch, dev, args.seed)
    entry_phase()
    torch.cuda.empty_cache()
    ckpt = checkpoint_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    train_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    host = hostmem_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()

    # ms / plain_ms / bound_ms: topk_* at B = 32, K = 64 (topk_int8's B = 128
    # and K = 12 beside them, its shared headers under "headers"; topk_float in the
    # f32x2 mode the path runs; every mode under "modes"); flash_attention at
    # S = 8192; paged_attention at B = 64, T = 1 on a bf16 pool; paged_kv_write
    # as the decoder launches it (paged_kv_write_rope: rotate, write) at B = 64,
    # T = 1 on a bf16 pool, with the B = 1, T = 256 chunk (chunk_*), the int8
    # pool (int8_pool) and the JAX signature's entries already rotated
    # (unrotated) beside it; int8_linear at the gate/up projection, M = 64; w4a8_matmul (the
    # row quantizer and the product, as the decoder runs a projection),
    # quantize_rows, w4a16_matmul (bf16) and int4_stream_floor at the gate/up
    # projection, M = 32 (launches: the int4_weights and int4_kernel bursts,
    # and the int4 tool's run). device_ms / library_device_ms, for the kernels
    # of under 0.3 ms: many launches over a ring of cold weights, where ms is
    # one launch through the wrapper; topk_floor in its f32x2 nomerge variant at B = 32
    # (launches: the scan tool's runs over the three modes). library_ms: one
    # PyTorch call computing the same function, where there is one (no single
    # call scans with a penalty and selects, walks a page table, or scatters
    # by one); for topk_int8 the yardstick of two calls, torch._int_mm then
    # torch.topk (null, with library_error, where _int_mm refuses the shape);
    # launches: the count over that kernel's main-path run; topk_int8's
    # launches_lifecycle, launches_hybrid and launches_mesh: its counts over the
    # bursts of those phases (the mesh phase's through the index sharded over
    # four entries of the card); paged_attention's and paged_kv_write's
    # launches_tp: their counts over the mesh phase's TP streams, by config;
    # *_N_shards_one_card: the sharded call beside the unsharded one in this
    # run, n shards on one card (the cost of the extra launches and the merge,
    # not a scaling number); launches_http and launches_checkpoint (topk_int8,
    # paged_attention, paged_kv_write): the counts over the http phase's burst
    # of asks and over the checkpoint phase's asks to the entry point.
    # host_gather_rows at B = 32, M = 64 over the 10M-row q2 plane in host
    # memory, host_scatter_rows at a 250,000-row segment of its build (and an
    # ingest block of 4,096 rows): bound_ms is their bytes over the published
    # PCIe Gen5 x16 rate (64 GB/s each way), copy_bound_ms over the rate a 256 MiB
    # pinned copy_ showed in this run; library_ms of the gather is
    # plane[idx.cpu()].to(card), a CPU gather and a copy, and of the scatter
    # the pinned copy_ of the same rows into the plane's slice (the timed
    # indices are one run of rows); launches over the hostmem phase's build
    # and queries.
    print(json.dumps({"kernels": [{
        "name": "topk_int8", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/topk_int8.cu",
        "headers": ["outline_rag_tpu_torch/csrc/topk_float_tile.cuh",
                    "outline_rag_tpu_torch/csrc/topk_common.cuh"],
        "replaces": "outline_rag_tpu/ops/topk.py:346",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_pair_ms"],
        **{key: kernel[key] for key in ("device_ms", "ms_b128", "device_ms_b128", "plain_ms_b128",
                                        "bound_ms_b128", "bound_by_b128", "ms_k12",
                                        "library_error")
           if key in kernel},
        "launches_lifecycle": life["launches"],
        "launches_mesh": mesh["retrieval"]["asks"]["topk_int8_launches"],
        "mesh_4_shards_one_card": mesh["retrieval"]["int8"],
        "launches_hybrid": hybrid["topk_int8_launches"],
        "launches_http": web["launches"]["topk_int8"],
        "launches_checkpoint": ckpt["launches"]["topk_int8"],
    }, {
        "name": "topk_float", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/topk_float.cu",
        "replaces": "outline_rag_tpu/ops/topk.py:346",
        "launches": long["scan_launches"],
        "max_abs_err": max(m["max_abs_err"] for m in floats.values()),
        "ms": floats["f32x2"]["ms"], "plain_ms": floats["f32x2"]["plain_ms"],
        "bound_ms": floats["f32x2"]["bound_ms"], "bound_by": floats["f32x2"]["bound_by"],
        "library_ms": None, "modes": floats,
        "mesh_4_shards_one_card": mesh["retrieval"]["float"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/flash_attention.cu",
        "replaces": "outline_rag_tpu/ops/attention.py:43",
        "launches": long["flash_launches"], "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"], "device_ms": flash["device_ms"],
        "library_device_ms": flash["library_device_ms"], "by_S": flash["by_S"],
    }, {
        "name": "paged_attention", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/paged_attention.cu",
        "replaces": "outline_rag_tpu/ops/paged_attention.py:679",
        "launches": chat["bf16"]["paged_attention_launches"],
        "max_abs_err": max(p["max_abs_err"] for p in paged.values()),
        "ms": paged["bf16"]["ms"], "plain_ms": paged["bf16"]["plain_ms"],
        "bound_ms": paged["bf16"]["bound_ms"], "bound_by": paged["bf16"]["bound_by"],
        "library_ms": None, "device_ms": paged["bf16"]["device_ms"], "library_device_ms": None,
        "int8_pool": {k: paged["int8"][k] for k in
                      ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        **{f"{label}_{key}": paged["bf16"][f"{label}_{key}"]
           for label in ("spec_window", "prefill_256")
           for key in ("ms", "device_ms", "bound_ms", "bound_by")},
        "launches_http": web["launches"]["paged_attention"],
        "launches_checkpoint": ckpt["launches"]["paged_attention"],
        "launches_tp": {name: c["streams"]["launches"]["paged_attention"]
                        for name, c in mesh["tp"]["configs"].items()},
        "tp_2_shards_one_card": mesh["tp"]["paged_attention_sharded"],
    }, {
        "name": "paged_kv_write", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/paged_kv_write.cu",
        "replaces": "outline_rag_tpu/ops/paged_attention.py:892 and the rotation and "
                    "quantization around it, outline_rag_tpu/models/decoder.py:570-571, 742-749",
        "launches": chat["bf16"]["paged_kv_write_launches"],
        "max_abs_err": max(max(w["max_abs_err"], w["rope_max_abs_err"])
                           for w in kv_write.values()),
        **{key: kv_write["bf16"]["rope"]["decode"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "plain_device_ms")},
        "library_ms": None, "library_device_ms": None,
        **{f"chunk_{key}": kv_write["bf16"]["rope"]["chunk"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "plain_device_ms")},
        "int8_pool": {f"{label}_{key}" if label == "chunk" else key:
                      kv_write["int8"]["rope"][label][key]
                      for label in ("decode", "chunk")
                      for key in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                  "plain_device_ms")},
        "unrotated": {kv: {key: kv_write[kv][key] for key in
                           ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms")}
                      for kv in ("bf16", "int8")},
        "launches_http": web["launches"]["paged_kv_write"],
        "launches_checkpoint": ckpt["launches"]["paged_kv_write"],
        "launches_tp": {name: c["streams"]["launches"]["paged_kv_write"]
                        for name, c in mesh["tp"]["configs"].items()},
    }, {
        "name": "int8_linear", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int8_linear.cu",
        "replaces": "outline_rag_tpu/ops/int8_linear.py:94",
        "launches": chat["int8_weights"]["int8_linear_launches"],
        "max_abs_err": linear["max_abs_err"],
        "ms": linear["ms"], "plain_ms": linear["plain_ms"],
        "bound_ms": linear["bound_ms"], "bound_by": linear["bound_by"],
        "library_ms": linear["library_ms"], "device_ms": linear["device_ms"],
        "library_device_ms": linear["library_device_ms"], "by_shape": linear["by_shape"],
        **{key: linear[key] for key in linear if key.startswith("step_")},
        "decode_launches": chat["int8_weights"]["int8_linear_decode_launches"],
    }, {
        "name": "w4a8_matmul", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "outline_rag_tpu/ops/int4_linear.py:203",
        "launches": chat["int4_weights"]["w4a8_launches"],
        "max_abs_err": int4["max_abs_err"]["w4a8"],
        "ms": int4["top"]["w4a8_ms"], "plain_ms": int4["top"]["w4a8_plain_ms"],
        **int4["top"]["w4a8_bound"], "library_ms": int4["top"]["library_ms"],
        "device_ms": int4["top"]["w4a8_device_ms"],
        "library_device_ms": int4["top"]["library_device_ms"],
        "kernel_only_ms": int4["top"]["w4a8_kernel_only_ms"],
        "kernel_only_device_ms": int4["top"]["w4a8_kernel_only_device_ms"],
        "by_shape": int4["by_shape"],
        "launches_with_speculation": chat["spec_int4"]["w4a8_launches"],
    }, {
        "name": "quantize_rows", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "outline_rag_tpu/ops/int4_linear.py:190",
        "launches": chat["int4_weights"]["quantize_rows_launches"],
        "max_abs_err": int4["max_abs_err"]["quantize_rows"],  # the largest code difference
        "scales_with_other_bits": int4["quantize_rows_scales_with_other_bits"],
        "ms": int4["top"]["quantize_rows_ms"], "plain_ms": int4["top"]["quantize_rows_plain_ms"],
        **int4["top"]["quantize_rows_bound"], "library_ms": None,
        "device_ms": int4["top"]["quantize_rows_device_ms"], "library_device_ms": None,
    }, {
        "name": "w4a16_matmul", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "outline_rag_tpu/ops/int4_linear.py:409",
        "launches": chat["int4_kernel"]["w4a16_launches"],
        "max_abs_err": max(int4["max_abs_err"]["w4a16_bf16"], int4["max_abs_err"]["w4a16_f32"]),
        "ms": int4["top"]["w4a16_ms"], "plain_ms": int4["top"]["w4a16_plain_ms"],
        **int4["top"]["w4a16_bound"], "library_ms": int4["top"]["library_ms"],
        "device_ms": int4["top"]["w4a16_device_ms"],
        "library_device_ms": int4["top"]["library_device_ms"],
    }, {
        "name": "int4_stream_floor", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "tools/bench_int4_kernel.py:85",
        "launches": int4_floor["launches"], "max_abs_err": int4_floor["max_abs_err"],
        "folds_that_differ": int4_floor["folds_that_differ"],
        "ms": int4_floor["floor_ms"], "plain_ms": int4_floor["floor_plain_ms"],
        "bound_ms": int4_floor["bound_ms"], "bound_by": int4_floor["bound_by"],
        "library_ms": None, "device_ms": int4_floor["floor_device_ms"],
        "library_device_ms": None, "by_shape": int4_floor["by_shape"],
    }, {
        "name": "topk_floor", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/topk_floor.cu",
        "replaces": "tools/bench_topk_kernel.py:117",
        "launches": scan_floor_launches,
        "max_abs_err": max(m["floor"]["max_abs_err"] for m in floats.values()),
        "ms": floats["f32x2"]["floor"]["nomerge_ms"], "plain_ms": floats["f32x2"]["floor"]["plain_ms"],
        "bound_ms": floats["f32x2"]["floor"]["bound_ms"],
        "bound_by": floats["f32x2"]["floor"]["bound_by"], "library_ms": None,
        "modes": {mode: m["floor"] for mode, m in floats.items()},
    }, {
        "name": "host_gather_rows", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/hostmem.cu",
        "replaces": "outline_rag_tpu/ops/hostmem.py:72",
        "launches": host["launches"]["host_gather_rows"],
        "max_abs_err": host["kernels_vs_twins"]["gather_max_abs_err"],
        **{key: host["gather"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "copy_bound_ms",
            "plain_on_card_device_ms", "prefix_device_ms", "whole_device_ms", "plane_size_ratio",
            "gbs", "shape")},
        "h2d_gbs": host["rates"]["h2d_gbs"],
    }, {
        "name": "host_scatter_rows", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/hostmem.cu",
        "replaces": "outline_rag_tpu/ops/hostmem.py:101",
        "launches": host["launches"]["host_scatter_rows"],
        "max_abs_err": host["kernels_vs_twins"]["scatter_max_abs_err"],
        **{key: host["scatter"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "copy_bound_ms", "gbs",
            "shape", "block")},
        "d2h_gbs": host["rates"]["d2h_gbs"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
