"""Tensor-parallel decoding in the port (``outline_rag_tpu_torch/parallel/tp.py``,
the TP forward of ``models/decoder.py``, ``DecodeBatcher(mesh=...)``,
``LocalChatProvider(tp_devices=...)``) against the JAX package's on
conftest's CPU mesh (mirrors ``tests/test_tp.py``), on the tiny f32 decoder
(heads 4, KV heads 2: 2-way TP), the port's mesh being two CPU entries.

Tolerances: logits within atol 2e-4 and rtol 2e-4 of the unsharded forward
and of JAX's TP forward (the bounds of ``tests/test_tp.py``; the
row-parallel sums run in another order); greedy token streams equal, token
for token; w8a8 int8 weights under TP bit-equal to the unsharded forward
(global activation scales and exact int32 partial sums); the sharded paged
kernels' outputs bit-equal to the unsharded kernel's head slices.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.models import decoder as jdec
from outline_rag_tpu.parallel import tp as jtp
from outline_rag_tpu.serve import decode_batcher as jbatcher
from outline_rag_tpu.serve import llm as jllm
from outline_rag_tpu_torch.models import decoder as tdec
from outline_rag_tpu_torch.models.convert import (
    decoder_config_from_jax,
    decoder_from_jax,
    paged_kv_from_jax,
)
from outline_rag_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_sharded,
    paged_kv_write,
    paged_kv_write_sharded,
)
from outline_rag_tpu_torch.parallel.tp import (
    model_mesh,
    shard_decoder_cache,
    shard_decoder_params,
)
from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher
from outline_rag_tpu_torch.serve.llm import LocalChatProvider

torch.set_num_threads(1)

WAIT = 120
ATOL = RTOL = 2e-4
MESH = model_mesh(2, ["cpu", "cpu"])


class Tok:
    eos_token_id = 0

    def encode(self, text):
        return [1 + (b % 250) for b in text.encode()][:40]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _model(key: int):
    jcfg = jdec.DecoderConfig.tiny()
    jparams = jdec.init_decoder_params(jax.random.key(key), jcfg)
    cfg = decoder_config_from_jax(jcfg)
    params = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _zeros(b):
    return torch.zeros((b,), dtype=torch.int32)


def gather_decoder_cache(cache):
    """A ring sharded on KvH put back together."""
    return tuple(torch.cat(x, dim=2) for x in cache)


@pytest.mark.parametrize("layout", ["unfused", "fused", "w8a8"])
def test_tp_forward_matches_single_device_and_jax(layout):
    jcfg, jparams, cfg, params = _model(0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    if layout != "unfused":
        params = tdec.fuse_decoder_params(params)
    if layout == "w8a8":
        params = tdec.quantize_decoder_params(params)
    ref, ref_cache = tdec.decoder_forward(params, torch.from_numpy(toks),
                                          tdec.init_cache(cfg, 2, "cpu"), _zeros(2), cfg)
    p_tp = shard_decoder_params(params, MESH, cfg)
    assert p_tp["layers"][0]["shards"][1]["wo"] is not None
    got, cache = tdec.decoder_forward(p_tp, torch.from_numpy(toks),
                                      shard_decoder_cache(tdec.init_cache(cfg, 2, "cpu"), MESH),
                                      _zeros(2), cfg)
    assert [c.shape[2] for c in cache[0]] == [1, 1]  # one KV head a shard
    if layout == "w8a8":
        assert torch.equal(got, ref)
        assert torch.equal(gather_decoder_cache(cache)[0], ref_cache[0])
        return
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gather_decoder_cache(cache)[0].numpy(), ref_cache[0].numpy(),
                               atol=ATOL, rtol=RTOL)
    jmesh = jtp.model_mesh(2)
    stacked = jdec.stack_decoder_params(jparams)
    jl, _ = jax.jit(lambda p, t, c, s: jdec.decoder_forward(p, t, c, s, jcfg))(
        jtp.shard_decoder_params(stacked, jmesh), jnp.asarray(toks),
        jtp.shard_decoder_cache(jdec.init_cache(jcfg, 2), jmesh), jnp.zeros((2,), jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)


def test_tp_generation_matches_jax():
    """Greedy chunked generation under TP equals the JAX package's TP
    generation and the port's unsharded generation."""
    jcfg, jparams, cfg, params = _model(0)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)

    def run_port(p, cache):
        lg, cache = tdec.decoder_forward(p, torch.from_numpy(prompt), cache, _zeros(1), cfg)
        first = torch.argmax(lg[:, 4], dim=-1).to(torch.int32)
        toks, *_ = tdec.generate_chunk(p, cache, first, torch.full((1,), 5, dtype=torch.int32),
                                       tdec.make_key(0, "cpu"), cfg, n_steps=8, temperature=0.0,
                                       top_p=1.0, eos_id=-1)
        return [int(first[0])] + toks[0].tolist()

    def run_jax(p, cache):
        lg, cache = jdec.decoder_forward(p, jnp.asarray(prompt), cache,
                                         jnp.zeros((1,), jnp.int32), jcfg)
        first = jnp.argmax(lg[:, 4], axis=-1).astype(jnp.int32)
        toks, *_ = jdec.generate_chunk(p, cache, first, jnp.full((1,), 5, jnp.int32),
                                       jax.random.key(0), jcfg, n_steps=8, temperature=0.0,
                                       top_p=1.0, eos_id=-1)
        return [int(first[0])] + [int(x) for x in np.asarray(toks)[0]]

    jmesh = jtp.model_mesh(2)
    stacked = jdec.stack_decoder_params(jparams)
    want = run_jax(jtp.shard_decoder_params(stacked, jmesh),
                   jtp.shard_decoder_cache(jdec.init_cache(jcfg, 1), jmesh))
    got = run_port(shard_decoder_params(params, MESH, cfg),
                   shard_decoder_cache(tdec.init_cache(cfg, 1, "cpu"), MESH))
    assert got == want
    assert got == run_port(params, tdec.init_cache(cfg, 1, "cpu"))


def _complete(prov, text):
    return asyncio.run(asyncio.wait_for(
        prov.complete("m", [{"role": "user", "content": text}], temperature=0.0), WAIT))


@pytest.mark.parametrize("kw", [
    dict(batch_slots=2),
    dict(),
    dict(int8_weights=True),
    dict(batch_slots=2, int8_weights=True, kv_pages=12, page_size=16),
], ids=["batched", "single_stream", "int8_weights", "paged_int8_weights"])
def test_tp_provider_matches_jax(kw):
    """LocalChatProvider(tp_devices=2) answers as the JAX package's TP
    provider and as the port's unsharded provider, token for token."""
    jcfg, jparams, cfg, params = _model(5)
    common = dict(chunk_tokens=4, max_new_tokens=10, **kw)
    tp = LocalChatProvider(params, cfg, Tok(), tp_devices=2, device="cpu",
                           devices=["cpu", "cpu"], **common)
    plain = LocalChatProvider(params, cfg, Tok(), device="cpu", **common)
    jax_tp = jllm.LocalChatProvider(jparams, jcfg, Tok(), tp_devices=2, **common)
    try:
        assert tp.stats()["tp"] == 2
        wqkv = tp.params["layers"][0]["shards"][1]["wqkv"]
        if kw.get("int8_weights"):  # half of each of the q, k and v heads' rows
            assert tuple(wqkv["q"].shape) == ((cfg.heads + 2 * cfg.kv_heads) * cfg.hd // 2,
                                              cfg.hidden)
        for text in ("hello tensor parallel", "second stream"):
            got = _complete(tp, text)
            assert got == _complete(plain, text)
            assert got == _complete(jax_tp, text)
    finally:
        for prov in (tp, plain, jax_tp):
            if prov._batcher is not None:
                prov._batcher.close()


def test_tp_provider_rejects_bad_configs(monkeypatch):
    _, _, cfg, params = _model(1)
    with pytest.raises(ValueError, match="divisible"):
        LocalChatProvider(params, cfg, Tok(), tp_devices=3, device="cpu", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="only 1 device"):
        LocalChatProvider(params, cfg, Tok(), tp_devices=2, device="cpu")
    monkeypatch.setattr(tdec, "_INT8_MODE", "kernel")
    with pytest.raises(ValueError, match="w8a8"):
        LocalChatProvider(params, cfg, Tok(), tp_devices=2, int8_weights=True, device="cpu",
                          devices=["cpu", "cpu"])
    monkeypatch.setattr(tdec, "_INT8_MODE", "w8a8")
    with pytest.raises(ValueError, match="prequantized"):
        LocalChatProvider(params, cfg, Tok(), tp_devices=2, int8_weights=True, prequantized=True,
                          device="cpu", devices=["cpu", "cpu"])


def _collect(q, done):
    out = []
    while True:
        item = q.get(timeout=WAIT)
        if item is done:
            return out
        if isinstance(item, Exception):
            raise item
        out.extend(item)


def _port_batcher(params, cfg, mesh, prompts, **kw):
    b = DecodeBatcher(params, cfg, slots=2, chunk_tokens=4, eos_id=0, mesh=mesh, device="cpu",
                      **kw)
    try:
        qs = [b.submit(p, 0.0, 1.0, 8, seed=7 + i) for i, p in enumerate(prompts)]
        return [_collect(q, DONE) for q in qs]
    finally:
        b.close()


def _jax_batcher(params, cfg, mesh, prompts, **kw):
    b = jbatcher.DecodeBatcher(params, cfg, slots=2, chunk_tokens=4, eos_id=0, mesh=mesh, **kw)
    try:
        qs = [b.submit(p, 0.0, 1.0, 8, seed=7 + i) for i, p in enumerate(prompts)]
        return [_collect(q, jbatcher.DONE) for q in qs]
    finally:
        b.close()


@pytest.mark.parametrize("key, prompts, kw", [
    (3, [[5, 9, 13, 5, 9, 13]], dict(spec_k=2, spec_gram=2)),
    (3, [[5, 9, 13, 5, 9, 13], [7, 11, 7, 11]], dict(kv_pages=12, page_size=16)),
    (4, [[5, 9, 13, 5, 9, 13]], dict(kv_pages=12, page_size=16, kv_int8=True)),
    (6, [[5, 9, 13, 5, 9, 13, 5, 9]], dict(kv_pages=12, page_size=16, spec_k=2, spec_gram=2)),
], ids=["spec", "paged", "paged_int8kv", "spec_paged"])
def test_tp_batcher_matches_unsharded_and_jax(key, prompts, kw):
    """The batcher's modes under TP: the pools shard on KvH with their scale
    pools, the page tables replicate; greedy tokens equal the unsharded
    batcher's and the JAX package's TP batcher's."""
    jcfg, jparams, cfg, params = _model(key)
    want = _port_batcher(params, cfg, None, prompts, **kw)
    p_tp = shard_decoder_params(params, MESH, cfg)
    got = _port_batcher(p_tp, cfg, MESH, prompts, **kw)
    assert got == want
    jmesh = jtp.model_mesh(2)
    stacked = jdec.stack_decoder_params(jparams)
    assert got == _jax_batcher(jtp.shard_decoder_params(stacked, jmesh), jcfg, jmesh, prompts,
                               **kw)


def test_tp_paged_pool_shards_on_kv_heads():
    cfg = decoder_config_from_jax(jdec.DecoderConfig.tiny())
    pool = tdec.init_paged_cache(cfg, 2, 12, 16, kv_dtype="int8", mesh=MESH)
    assert pool.mesh == MESH and pool.page == 16
    assert [tuple(k.shape) for k in pool.k] == [(2, 12, 1, 16, 16)] * 2
    assert [tuple(s.shape) for s in pool.k_scale] == [(2, 12, 1, 16)] * 2
    three = model_mesh(3, ["cpu"] * 3)
    with pytest.raises(ValueError, match="kv_heads=2 not divisible"):
        tdec.init_paged_cache(cfg, 2, 12, 16, mesh=three)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_attention_sharded_equals_head_slices(kv):
    """Each shard's kernel run over its KV heads gives the unsharded run's
    head slice, bit for bit; the sharded write fills each shard's pool as
    the unsharded write fills the whole one."""
    g = torch.Generator().manual_seed(0)
    b, t, h, kvh, page, dh, pages, maxp = 3, 2, 8, 4, 16, 64, 10, 4
    dt = torch.bfloat16
    q = torch.randn((b, t, h, dh), generator=g).to(dt)
    table = torch.randint(1, pages, (b, maxp), generator=g, dtype=torch.int32)
    pos = torch.tensor([5, 17, 40], dtype=torch.int32)
    mesh = model_mesh(2, ["cpu", "cpu"])
    if kv == "int8":
        pk = torch.randint(-127, 128, (pages, kvh, page, dh), generator=g, dtype=torch.int8)
        pv = torch.randint(-127, 128, (pages, kvh, page, dh), generator=g, dtype=torch.int8)
        ks = torch.rand((pages, kvh, page), generator=g) / 127
        vs = torch.rand((pages, kvh, page), generator=g) / 127
    else:
        pk = torch.randn((pages, kvh, page, dh), generator=g).to(dt)
        pv = torch.randn((pages, kvh, page, dh), generator=g).to(dt)
        ks = vs = None
    whole = paged_attention(q, pk, pv, table, pos, ks, vs)
    parts = paged_attention_sharded(q, pk, pv, table, pos, ks, vs, mesh=mesh)
    assert torch.equal(torch.cat(parts, dim=2), whole)

    k_new = torch.randn((b, t, kvh, dh), generator=g).to(dt)
    v_new = torch.randn((b, t, kvh, dh), generator=g).to(dt)
    if kv == "int8":
        k_new, v_new = k_new.to(torch.int8), v_new.to(torch.int8)
        ks_new = torch.rand((b, t, kvh), generator=g)
        vs_new = torch.rand((b, t, kvh), generator=g)
    else:
        ks_new = vs_new = None
    shards = [list(torch.split(x.clone(), kvh // 2, dim=1)) if x is not None else None
              for x in (pk, pv, ks, vs)]
    shards = [[c.contiguous() for c in s] if s is not None else None for s in shards]
    paged_kv_write(pk, pv, table, pos, k_new, v_new, ks, vs, ks_new, vs_new)
    paged_kv_write_sharded(shards[0], shards[1], table, pos, k_new, v_new, shards[2], shards[3],
                           ks_new, vs_new, mesh=mesh)
    for whole_pool, parts in zip((pk, pv, ks, vs), shards):
        if parts is not None:
            assert torch.equal(torch.cat(parts, dim=1), whole_pool)


def test_paged_kv_from_jax_takes_a_tp_pool():
    jcfg = jdec.DecoderConfig.tiny()
    jmesh = jtp.model_mesh(2)
    cache = jdec.init_paged_cache(jcfg, 2, 5, 16, kv_dtype="int8", mesh=jmesh)
    rng = np.random.default_rng(0)
    k = rng.integers(-127, 128, cache.k.shape).astype(np.int8)
    cache = dataclasses.replace(cache, k=jnp.asarray(k))
    np_cache = jax.tree_util.tree_map(np.asarray, cache)
    got = paged_kv_from_jax(np_cache, mesh=MESH)
    assert got.mesh == MESH and len(got.k) == 2
    np.testing.assert_array_equal(torch.cat(got.k, dim=2).numpy(), k.transpose(0, 1, 2, 4, 3))
    assert [tuple(s.shape) for s in got.k_scale] == [(2, 5, 1, 16)] * 2
    with pytest.raises(ValueError, match="tensor-parallel pool"):
        paged_kv_from_jax(np_cache, device="cpu")


@pytest.mark.parametrize("hidden, inter, heads, hd", [(64, 128, 4, 16), (512, 1024, 4, 128)],
                         ids=["gathered", "split"])
def test_tp_int4_forward_matches_unsharded(hidden, inter, heads, hd):
    """int4 weights under TP: row-parallel weights split on whole pair
    blocks and scale groups where K allows it (K/2 = 256, 512 here), else
    kept whole on the first shard with the activations gathered there (K/2
    = 32: the groups do not divide, as GSPMD all-gathers); logits within
    the TP bounds of the unsharded int4 forward."""
    cfg = tdec.DecoderConfig(vocab_size=256, hidden=hidden, layers=2, heads=heads, kv_heads=2,
                             intermediate=inter, head_dim=hd, max_cache=64, dtype=torch.float32)
    params = tdec.quantize_decoder_params_int4(
        tdec.fuse_decoder_params(tdec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu")))
    p_tp = shard_decoder_params(params, MESH, cfg)
    split = p_tp["layers"][0]["shards"][1]["wo"] is not None
    assert split == (hidden > 64)
    toks = torch.randint(0, 256, (2, 7), generator=torch.Generator().manual_seed(1))
    ref, _ = tdec.decoder_forward(params, toks, tdec.init_cache(cfg, 2, "cpu"), _zeros(2), cfg)
    got, _ = tdec.decoder_forward(p_tp, toks, shard_decoder_cache(tdec.init_cache(cfg, 2, "cpu"),
                                                                  MESH), _zeros(2), cfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_row_parallel_rounds_the_sum_once(kind):
    """A bf16 row-parallel product (``wo``, ``wd``) sums the shards' f32
    partials and rounds once: equal to the unsharded product rounded once
    from f32 but for a rare rounding moved by the f32 order (at most 0.1% of
    the outputs here; a sum of partials each rounded to bf16 first differs
    in about 38%)."""
    from outline_rag_tpu_torch.ops.int4_linear import quantize_int4_weight
    from outline_rag_tpu_torch.parallel.tp import _row

    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((16, 1024), generator=g).to(bf)
    w = (torch.randn((1024, 256), generator=g) * 0.02).to(bf)
    if kind == "dense":
        once = (x.float() @ w.float()).to(bf)
    else:
        q4, s4 = quantize_int4_weight(w.float())
        w = {"q4": q4, "s4": s4}
        once = tdec._mm_int4(x, q4, s4, bf, out=torch.float32).to(bf)
    parts = _row(w, 2)
    assert parts[1] is not None  # split over the shards, not kept whole
    got = tdec._row_parallel(list(torch.split(x, 512, dim=-1)), parts, bf)
    assert float((got != once).float().mean()) <= 1e-3


def test_tp_forward_needs_a_sharded_cache():
    _, _, cfg, params = _model(0)
    p_tp = shard_decoder_params(params, MESH, cfg)
    with pytest.raises(ValueError, match="shard_decoder_cache"):
        tdec.decoder_forward(p_tp, torch.zeros((1, 3), dtype=torch.int32),
                             tdec.init_cache(cfg, 1, "cpu"), _zeros(1), cfg)
    with pytest.raises(ValueError, match="laid out over that mesh"):
        DecodeBatcher(params, cfg, slots=2, mesh=MESH, device="cpu")


def test_ask_sse_with_tp_paged_int8_provider():
    """The whole serve path over the composed decoder: TP x paged KV x w8a8
    int8 through the continuous batcher behind /chat/api/ask."""
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from outline_rag_tpu_torch.serve.app import build_app
    from outline_rag_tpu_torch.serve.http import TestClient
    from outline_rag_tpu_torch.storage import SqliteMetaStore

    _, _, cfg, params = _model(8)
    provider = LocalChatProvider(
        params, cfg, Tok(), chunk_tokens=4, max_new_tokens=8, tp_devices=2, batch_slots=2,
        int8_weights=True, kv_pages=12, page_size=16, device="cpu", devices=["cpu", "cpu"],
    )
    settings = load_settings({"SECRET_KEY": "k", "VECTOR_DIM": "64", "DATA_DIR": ""})
    app = build_app(settings, device="cpu", provider=provider, embedder=HashEmbedder(dim=64),
                    meta=SqliteMetaStore(":memory:"), start_workers=False)

    async def run():
        client = TestClient(app)
        await client.post("/chat/login", body=b"name=tp",
                          headers={"content-type": "application/x-www-form-urlencoded"})
        conv = json.loads((await client.post("/chat/api/conversations",
                                             json_body={"title": "tp"})).body)
        events = await client.sse("POST", "/chat/api/ask",
                                  json_body={"conversation_id": conv["id"], "question": "compose"})
        assert "[DONE]" in events
        msgs = json.loads((await client.get(
            f"/chat/api/conversations/{conv['id']}/messages")).body)["messages"]
        assert [m["role"] for m in msgs] == ["user", "assistant"]
        assert msgs[1]["content"]

    try:
        asyncio.run(asyncio.wait_for(run(), WAIT))
    finally:
        provider.close()
