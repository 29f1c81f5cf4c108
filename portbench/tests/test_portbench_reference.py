"""At a tiny size on the CPU, in float32, the plain references agree with
the port's own path on the same seeded weights and inputs."""

import types

import torch

from portbench import harness, weights
from portbench.reference import qwen2, scan, xlmr
from portbench.tests.tiny import QWEN, REPO, RETRIEVAL

CPU = torch.device("cpu")
BENCH = harness.Bench(REPO)


def _port_encoder(cfg, classifier: bool, seed: int):
    from outline_rag_tpu_torch.models.convert import _copy_encoder_state, _copy_linear, config_from_hf
    from outline_rag_tpu_torch.models.encoder import Encoder
    from outline_rag_tpu_torch.models.reranker import Reranker

    ecfg = config_from_hf(types.SimpleNamespace(**cfg), torch.float32)
    sd = weights.draw(weights.xlmr_layout(cfg, classifier), CPU, torch.float32, seed,
                      "reranker" if classifier else "encoder")
    if not classifier:
        enc = Encoder(ecfg, CPU)
        _copy_encoder_state(enc, sd)
        return enc, sd
    rr = Reranker(ecfg, CPU)
    _copy_encoder_state(rr.encoder, sd)
    with torch.no_grad():
        _copy_linear(rr.dense, sd["classifier.dense.weight"], sd["classifier.dense.bias"])
        _copy_linear(rr.out, sd["classifier.out_proj.weight"], sd["classifier.out_proj.bias"])
    return rr, sd


def test_query_tokens_are_the_hash_tokenizers():
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer

    texts = ["a b c", " ".join(f"w{i}" for i in range(90))]
    tb = HashTokenizer(1024).batch(texts, 64, buckets=(64,))
    assert torch.equal(xlmr.query_rows(texts, 1024, 64, CPU), torch.tensor(tb.input_ids).long())


def test_xlmr_embedding_and_rerank_match_the_port():
    from outline_rag_tpu_torch.models.encoder import pooled_embeddings

    enc, sd = _port_encoder(RETRIEVAL, False, 3)
    ids = xlmr.query_rows(["w1 w2 w3", "w4 w5 w6 w7 w8 w9"], 1024, 64, CPU)
    mask = (ids != xlmr.PAD).int()
    with torch.no_grad():
        assert torch.allclose(pooled_embeddings(enc, ids, mask), xlmr.embed(sd, RETRIEVAL, ids),
                              atol=1e-5)
        rr, sd = _port_encoder(RETRIEVAL, True, 3)
        pair = torch.cat([ids, torch.tensor([[2, 40, 41, 1], [2, 50, 1, 1]])], dim=1)
        got = rr(pair, (pair != xlmr.PAD).int())
        assert torch.allclose(got, xlmr.rerank(sd, RETRIEVAL, pair), atol=1e-5)


def test_exact_scan_is_a_stable_topk_over_blocks():
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(1000, 16, generator=g)
    rows[700] = rows[3]  # a tie goes to the lower row
    q = scan.unit(torch.randn(4, 16, generator=g))
    q[0] = scan.unit(rows[3:4])[0]
    v, i = scan.exact_topk(q, ((s, rows[s : s + 256]) for s in range(0, 1000, 256)), 5)
    want = q @ scan.unit(rows).T
    wv, wi = torch.sort(want, dim=1, descending=True, stable=True)
    assert torch.equal(i, wi[:, :5]) and torch.allclose(v, wv[:, :5])
    assert i[0, 0] == 3 and i[0, 1] == 700


def test_qwen2_logits_match_the_port_decoder():
    from outline_rag_tpu_torch.models.decoder import decoder_forward, init_cache

    cfg = QWEN
    arch = BENCH.arch(cfg)
    params, dcfg = arch.build(cfg, weights.draw(arch.layout(cfg), CPU, torch.float32, 5,
                                                "decoder"), CPU, torch.float32)
    sd = weights.draw(arch.layout(cfg), CPU, torch.float32, 5, "decoder")
    ids = torch.randint(0, cfg["vocab_size"], (40,), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = decoder_forward(params, ids[None], init_cache(dcfg, 1, CPU),
                                 torch.zeros(1, dtype=torch.int32), dcfg)
    assert dcfg.hd == 16 and dcfg.attn_bias and dcfg.tie_embeddings
    want = qwen2.logits(sd, cfg, ids, block=16)  # the head in three blocks of positions
    assert torch.allclose(got[0], want, atol=1e-4)
    assert torch.allclose(arch.logits(sd, cfg, ids), want, atol=1e-5)


def test_qwen2_layout_of_the_published_config():
    """The leaves the seeded draw cuts, in its order: the embedding and the
    final norm, then 12 a layer, and no separate head (it is tied)."""
    cfg = BENCH.config("qwen2.5-1.5b.local-rag")
    leaves = BENCH.arch(cfg).layout(cfg)
    assert len(leaves) == 2 + 28 * 12 == 338
    assert leaves[0] == ("model.embed_tokens.weight", (151936, 1536), False)
    assert leaves[1] == ("model.norm.weight", (1536,), True)
    assert leaves[2] == ("model.layers.0.input_layernorm.weight", (1536,), True)
    assert leaves[4:6] == [("model.layers.0.self_attn.q_proj.weight", (1536, 1536), False),
                           ("model.layers.0.self_attn.q_proj.bias", (1536,), False)]
    assert leaves[6] == ("model.layers.0.self_attn.k_proj.weight", (256, 1536), False)
    assert leaves[-1] == ("model.layers.27.mlp.down_proj.weight", (1536, 8960), False)
    assert not any(name == "lm_head.weight" for name, _, _ in leaves)
