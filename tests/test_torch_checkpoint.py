"""HF checkpoints on disk through the port's loaders, held to the JAX
package's loaders and to the ``transformers`` models that wrote them.

The checkpoints are synthesized here as the JAX package's tests synthesize
them (``tests/test_real_checkpoint.py``, ``tests/test_real_checkpoint_decoder.py``):
config files, weights and real tokenizer files, in the published layouts.

- State: JAX ``load_pretrained`` -> ``encoder_from_jax`` / ``reranker_from_jax``
  equals the port's ``load_pretrained(dir, device="cpu")`` bit for bit in
  f32, BGE-m3's sidecar heads included; the same for
  ``load_pretrained_decoder`` (Llama sharded with GQA and an untied head,
  Qwen2 with q/k/v biases and a tied head, bf16 on disk).
- Forwards against the HF models, to the JAX package's bars.
- ``HFTokenizer`` against the JAX one.
- The app: ``build_app(device="cpu")`` from the disk checkpoints serves the
  JAX app's SSE frames; ``DECODER_WEIGHTS_PATH`` alone serves a stream.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.models import convert as jconvert
from outline_rag_tpu.models import tokenizer as jtok
from outline_rag_tpu_torch.models import convert
from outline_rag_tpu_torch.models import decoder as tdec
from outline_rag_tpu_torch.models import tokenizer as ptok
from outline_rag_tpu_torch.models.encoder import (
    Encoder,
    pooled_embeddings,
    sparse_weights_from_hidden,
)
from outline_rag_tpu_torch.models.reranker import Reranker
from tests import test_real_checkpoint as trc
from tests import test_torch_app_parity as tap
from tests.test_real_checkpoint import _make_tokenizer_files, _xlmr_config
from tests.test_real_checkpoint_decoder import _tiny_llama_config

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

TEXTS = ["wolves hunt in packs", "rivers carve canyons over millennia",
         "geiger counters measure gamma radiation across the tundra"]


def _save_shards(sd: dict, path) -> None:
    """A state dict as two safetensors shards and their index, the layout of
    every large HF checkpoint."""
    from safetensors.torch import save_file

    sd = {k: v.contiguous() for k, v in sd.items()}
    keys = sorted(sd)
    half = len(keys) // 2
    weight_map = {}
    for n, part in enumerate((keys[:half], keys[half:])):
        fname = f"model-0000{n + 1}-of-00002.safetensors"
        save_file({k: sd[k] for k in part}, str(path / fname), metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(part, fname))
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


@pytest.fixture(scope="module")
def encoder_dir(tmp_path_factory):
    """BGE-m3's layout: ``pytorch_model.bin`` of an ``XLMRobertaModel`` and
    the two sidecar heads; returns (dir, the HF model, the heads)."""
    from transformers import XLMRobertaModel

    path = tmp_path_factory.mktemp("bge-m3-tiny")
    vocab = _make_tokenizer_files(path)
    torch.manual_seed(0)
    model = XLMRobertaModel(_xlmr_config(vocab), add_pooling_layer=False).eval()
    torch.save(model.state_dict(), path / "pytorch_model.bin")
    model.config.save_pretrained(str(path))
    heads = {"sparse": {"weight": torch.randn(1, 64) * 0.1, "bias": torch.randn(1) * 0.1},
             "colbert": {"weight": torch.randn(32, 64) * 0.1, "bias": torch.randn(32) * 0.1}}
    for name, head in heads.items():
        torch.save(head, path / f"{name}_linear.pt")
    return path, model, heads


@pytest.fixture(scope="module")
def reranker_dir(tmp_path_factory):
    """bge-reranker-v2-m3's layout: ``model.safetensors`` of an
    ``XLMRobertaForSequenceClassification`` with one label."""
    from transformers import XLMRobertaForSequenceClassification

    path = tmp_path_factory.mktemp("bge-reranker-tiny")
    vocab = _make_tokenizer_files(path)
    cfg = _xlmr_config(vocab)
    cfg.num_labels = 1
    torch.manual_seed(1)
    model = XLMRobertaForSequenceClassification(cfg).eval()
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              str(path / "model.safetensors"), metadata={"format": "pt"})
    model.config.save_pretrained(str(path))
    return path, model


def _qwen2_config(vocab_size):
    from transformers import Qwen2Config

    return Qwen2Config(
        vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=96, max_position_embeddings=128,
        rope_theta=1_000_000.0, tie_word_embeddings=True,
    )


DECODERS = {
    # name: (config, on-disk dtype, sharded)
    "llama_sharded_gqa_untied": (_tiny_llama_config, torch.float32, True),
    "qwen2_bias_tied": (_qwen2_config, torch.float32, False),
    "llama_bf16_on_disk": (_tiny_llama_config, torch.bfloat16, True),
}


@pytest.fixture(scope="module")
def decoder_dirs(tmp_path_factory):
    """Each of ``DECODERS`` on disk: {name: (dir, the HF model in f32 holding
    the values on disk)}."""
    from safetensors.torch import save_file
    from transformers import LlamaForCausalLM, Qwen2ForCausalLM

    out = {}
    for seed, (name, (make_cfg, dtype, sharded)) in enumerate(DECODERS.items()):
        path = tmp_path_factory.mktemp(name)
        vocab = _make_tokenizer_files(path)
        torch.manual_seed(7 + seed)
        hf_cfg = make_cfg(vocab)
        model = {"llama": LlamaForCausalLM, "qwen2": Qwen2ForCausalLM}[hf_cfg.model_type](hf_cfg)
        model = model.eval()
        with torch.no_grad():  # the f32 model holds exactly what the file holds
            for p in model.parameters():
                p.copy_(p.to(dtype).float())
        sd = {k: v.to(dtype) for k, v in model.state_dict().items()}
        if model.config.tie_word_embeddings:
            sd.pop("lm_head.weight")  # as save_pretrained drops a tied head
        if sharded:
            _save_shards(sd, path)
        else:
            save_file({k: v.contiguous() for k, v in sd.items()},
                      str(path / "model.safetensors"), metadata={"format": "pt"})
        model.config.save_pretrained(str(path))
        out[name] = (path, model)
    return out


def _state_equal(got: torch.nn.Module, want: torch.nn.Module) -> None:
    g, w = got.state_dict(), want.state_dict()
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


def _f32_jax_cfg(jcfg):
    return convert.config_from_jax(dataclasses.replace(jcfg, dtype=jnp.float32))


def test_encoder_state_bit_equal_to_the_jax_loader(encoder_dir):
    path, _, _ = encoder_dir
    jcfg, jparams = jconvert.load_pretrained(str(path))
    want = convert.encoder_from_jax(jparams, _f32_jax_cfg(jcfg), device="cpu")
    got = convert.load_pretrained(str(path), device="cpu", dtype=torch.float32)
    assert isinstance(got, Encoder)
    assert got.sparse is not None and got.colbert.out_features == 32
    assert got.cfg == want.cfg
    _state_equal(got, want)


def test_reranker_state_bit_equal_to_the_jax_loader(reranker_dir):
    path, _ = reranker_dir
    jcfg, jparams = jconvert.load_pretrained(str(path))
    want = convert.reranker_from_jax(jparams, _f32_jax_cfg(jcfg), device="cpu")
    got = convert.load_pretrained(str(path), device="cpu", dtype=torch.float32)
    assert isinstance(got, Reranker)
    _state_equal(got, want)


def test_bf16_load_casts_like_the_jax_package(encoder_dir):
    """The default dtype: every weight the JAX package's ``cast_params``
    value (round to nearest even), layernorms f32."""
    path, _, _ = encoder_dir
    got = convert.load_pretrained(str(path), device="cpu")
    assert got.cfg.dtype == torch.bfloat16
    f32 = convert.load_pretrained(str(path), device="cpu", dtype=torch.float32)
    for (name, g), (_, w) in zip(got.state_dict().items(), f32.state_dict().items()):
        if "_ln." in name:
            assert g.dtype == torch.float32 and torch.equal(g, w), name
        else:
            assert g.dtype == torch.bfloat16 and torch.equal(g, w.to(torch.bfloat16)), name


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_state_bit_equal_to_the_jax_loader(decoder_dirs, name):
    path, model = decoder_dirs[name]
    jcfg, jparams = jconvert.load_pretrained_decoder(str(path))
    cfg, params = convert.load_pretrained_decoder(str(path), device="cpu", dtype=torch.float32)
    want_cfg = convert.decoder_config_from_jax(dataclasses.replace(jcfg, dtype=jnp.float32))
    assert cfg == want_cfg
    assert cfg.attn_bias == (name == "qwen2_bias_tied")
    assert cfg.tie_embeddings == ("lm_head" not in params) == (name == "qwen2_bias_tied")
    assert cfg.rope_theta == (1e6 if name == "qwen2_bias_tied" else 1e4)
    want = convert.decoder_from_jax(jparams, want_cfg, device="cpu")
    assert params.keys() == want.keys()
    for k in ("embed", "final_norm", "lm_head"):
        if k in want:
            assert torch.equal(params[k], want[k]), k
    for got_layer, want_layer in zip(params["layers"], want["layers"]):
        assert got_layer.keys() == want_layer.keys()
        for k in want_layer:
            assert torch.equal(got_layer[k], want_layer[k]), k


def test_bf16_decoder_load_keeps_norms_f32(decoder_dirs):
    path, _ = decoder_dirs["qwen2_bias_tied"]
    cfg, params = convert.load_pretrained_decoder(str(path), device="cpu")
    assert cfg.dtype == torch.bfloat16
    assert params["embed"].dtype == params["layers"][0]["wq"].dtype == torch.bfloat16
    assert params["final_norm"].dtype == params["layers"][0]["bq"].dtype == torch.float32
    cast = tdec.cast_decoder_params(params, cfg.dtype)
    assert all(cast["layers"][0][k] is params["layers"][0][k] for k in params["layers"][0])


def _hf_batch(path, texts):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(path))(texts, padding=True, return_tensors="pt")


def test_encoder_forward_matches_hf(encoder_dir):
    path, model, heads = encoder_dir
    enc = convert.load_pretrained(str(path), device="cpu", dtype=torch.float32)
    batch = _hf_batch(path, TEXTS)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = enc(ids, mask)
        live = mask.bool()
        np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), atol=1e-4)
        pooled = pooled_embeddings(enc, ids, mask)
        ref = torch.nn.functional.normalize(want[:, 0], dim=-1)
        assert (pooled * ref).sum(-1).min() > 0.999
        # the sidecar heads against nn.Linear on HF's hidden states
        lin = torch.nn.Linear(64, 1)
        lin.load_state_dict(heads["sparse"])
        sparse = sparse_weights_from_hidden(enc, want, ids, mask)
        ref_sparse = torch.relu(lin(want)[..., 0]) * (live & (ids >= 3))
        np.testing.assert_allclose(sparse.numpy(), ref_sparse.numpy(), atol=1e-5)
        lin = torch.nn.Linear(64, 32)
        lin.load_state_dict(heads["colbert"])
        np.testing.assert_allclose(
            (want @ enc.colbert.weight.T + enc.colbert.bias).numpy(), lin(want).numpy(), atol=1e-5)


def test_reranker_forward_matches_hf(reranker_dir):
    path, model = reranker_dir
    rr = convert.load_pretrained(str(path), device="cpu", dtype=torch.float32)
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(str(path))
    batch = tok(["how do wolves hunt"] * 3, TEXTS, padding=True, return_tensors="pt")
    with torch.no_grad():
        want = model(**batch).logits[:, 0]
        got = rr(batch["input_ids"], batch["attention_mask"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_logits_match_hf(decoder_dirs, name):
    path, model = decoder_dirs[name]
    cfg, params = convert.load_pretrained_decoder(str(path), device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(cfg, max_cache=32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 10))
    with torch.no_grad():
        want = model(torch.from_numpy(toks)).logits.numpy()
        got, _ = tdec.decoder_forward(params, torch.from_numpy(toks).to(torch.int32),
                                      tdec.init_cache(cfg, 2, "cpu"),
                                      torch.zeros((2,), dtype=torch.int32), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=3e-4)


# -- HFTokenizer --------------------------------------------------------------

LONG = " ".join(["wolves hunt in packs across the tundra"] * 100)  # 700 words


@pytest.mark.parametrize("max_len, buckets", [
    (512, jtok.DEFAULT_BUCKETS),
    (32, (32,)),
    (600, jtok.DEFAULT_BUCKETS),  # ENCODER_MAX_TOKENS=600 over a ladder topped at 512
])
def test_hf_tokenizer_matches_jax(encoder_dir, max_len, buckets):
    path, _, _ = encoder_dir
    j, p = jtok.HFTokenizer(str(path)), ptok.HFTokenizer(str(path))
    assert p.pad_id == j.pad_id == 1
    texts = TEXTS + [LONG, ""]
    for jb, pb in ((j.batch(texts, max_len, buckets), p.batch(texts, max_len, buckets)),
                   (j.batch_pairs(["how do wolves hunt"] * 5, texts, max_len, buckets),
                    p.batch_pairs(["how do wolves hunt"] * 5, texts, max_len, buckets))):
        assert pb.input_ids.dtype == jb.input_ids.dtype == np.int32
        np.testing.assert_array_equal(pb.input_ids, jb.input_ids)
        np.testing.assert_array_equal(pb.attention_mask, jb.attention_mask)
    assert p.batch(texts, max_len, buckets).input_ids.shape[1] == min(512, max_len)


# -- the entry points -----------------------------------------------------------


def test_get_embedder_loads_the_checkpoint_with_hf_parity(encoder_dir):
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.engine import EncoderEmbedder
    from outline_rag_tpu_torch.engine.embedder import get_embedder

    path, model, _ = encoder_dir
    emb = get_embedder(load_settings({"ENCODER_WEIGHTS_PATH": str(path)}), device="cpu")
    assert isinstance(emb, EncoderEmbedder) and isinstance(emb.tokenizer, ptok.HFTokenizer)
    assert emb.has_sparse_head and emb.has_colbert_head
    assert emb.cfg.dtype == torch.bfloat16 and emb.device == torch.device("cpu")
    batch = _hf_batch(path, TEXTS)
    with torch.no_grad():
        ref = torch.nn.functional.normalize(model(**batch).last_hidden_state[:, 0], dim=-1)
    cos = (emb.embed(TEXTS) * ref.numpy()).sum(axis=1)
    assert cos.min() > 0.999, cos


def test_get_embedder_fails_fast_on_a_bad_path(tmp_path):
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.engine.embedder import get_embedder

    bad = str(tmp_path / "nope")
    with pytest.raises(RuntimeError, match="ENCODER_WEIGHTS_PATH .*nope"):
        get_embedder(load_settings({"ENCODER_WEIGHTS_PATH": bad}), device="cpu")


def test_reranker_path_without_a_classifier_fails_fast(encoder_dir):
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.serve.app import build_app
    from outline_rag_tpu_torch.storage import SqliteMetaStore

    path, _, _ = encoder_dir
    settings = load_settings({"SECRET_KEY": "s", "DATA_DIR": "",
                              "RERANKER_WEIGHTS_PATH": str(path)})
    with pytest.raises(RuntimeError, match="RERANKER_WEIGHTS_PATH") as err:
        build_app(settings, device="cpu", meta=SqliteMetaStore(":memory:"), start_workers=False)
    assert "classifier" in str(err.value.__cause__)


# -- the app from disk checkpoints, against the JAX app -------------------------

APP_WORDS = sorted({w for text in [d[2] for d in tap.DOCS] + tap.ASKS
                    for w in text.replace("?", " ").replace("!", " ").replace(".", " ")
                    .replace(",", " ").replace("'", " ").split()})


@pytest.fixture(scope="module")
def app_dirs(tmp_path_factory):
    """An encoder and a cross-encoder whose tokenizer knows every word of the
    parity wiki, their weights scaled from the init's std 0.02 to 0.1 (at
    0.02 the tiny models map every text to nearly one vector; far above 0.1
    the attention saturates and bf16 rounding reorders the cross-encoder's
    scores)."""
    from safetensors.torch import save_file
    from transformers import XLMRobertaForSequenceClassification, XLMRobertaModel

    dirs = []
    for seed, cls in enumerate((XLMRobertaModel, XLMRobertaForSequenceClassification)):
        path = tmp_path_factory.mktemp(cls.__name__)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trc, "VOCAB_WORDS", APP_WORDS)
            vocab = _make_tokenizer_files(path)
        cfg = _xlmr_config(vocab)
        cfg.num_labels = 1
        torch.manual_seed(seed)
        model = cls(cfg).eval()
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() == 2:
                    p.mul_(5.0)
        save_file({k: v.contiguous() for k, v in model.state_dict().items()},
                  str(path / "model.safetensors"), metadata={"format": "pt"})
        cfg.save_pretrained(str(path))
        dirs.append(path)
    return dirs


def test_app_from_disk_checkpoints_matches_the_jax_app(app_dirs):
    """Both apps load the same folders through ``ENCODER_WEIGHTS_PATH`` and
    ``RERANKER_WEIGHTS_PATH`` (bf16, the loaders' default), ingest the same
    wiki into the fused path and answer the same asks with the same frames.
    Every chunk is a candidate (``TOP_K`` above the chunk count), so the
    cross-encoder alone picks the one cited chunk (``RERANK_K`` 1): the two
    packages' bf16 cross-encoders differ by a few 1e-3, which is as far as
    the tiny models' scores lie apart below the top, so the test first
    checks that each ask's best score leads the next by more than twice the
    packages' largest difference."""
    from outline_rag_tpu.config import load_settings as jax_load_settings
    from outline_rag_tpu.serve.app import build_app as jax_build_app
    from outline_rag_tpu.serve.http import TestClient as JaxClient
    from outline_rag_tpu.serve.llm import FakeChatProvider as JaxFake
    from outline_rag_tpu.storage import SqliteMetaStore as JaxStore
    from outline_rag_tpu.sync.refresh import TASK_QUEUE as JAX_QUEUE
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.serve.app import build_app
    from outline_rag_tpu_torch.serve.http import TestClient
    from outline_rag_tpu_torch.serve.llm import FakeChatProvider
    from outline_rag_tpu_torch.storage import SqliteMetaStore
    from outline_rag_tpu_torch.sync.refresh import TASK_QUEUE

    enc_dir, rr_dir = app_dirs
    env = {**tap.ENV, "ENCODER_WEIGHTS_PATH": str(enc_dir), "RERANKER_WEIGHTS_PATH": str(rr_dir),
           "TOP_K": "32", "RERANK_K": "1"}
    japp = jax_build_app(jax_load_settings(env), provider=JaxFake(thinking=True, cite=True),
                         meta=JaxStore(":memory:"), outline_transport=tap._wiki().transport(),
                         start_workers=False)
    papp = build_app(load_settings(env), device="cpu",
                     provider=FakeChatProvider(thinking=True, cite=True),
                     meta=SqliteMetaStore(":memory:"), outline_transport=tap._wiki().transport(),
                     start_workers=False)
    assert papp.state["retrieval"].fused and japp.state["retrieval"].fused
    want = asyncio.run(tap._drive(JaxClient(japp), japp, JAX_QUEUE))
    got = asyncio.run(tap._drive(TestClient(papp), papp, TASK_QUEUE))
    assert papp.state["index"].size == japp.state["index"].size < 32
    # the precondition, for each ask that retrieved, alone (as the app asked
    # it): the fused path's cross-encoder scores of every chunk
    jeng, peng = japp.state["retrieval"]._fused, papp.state["retrieval"]._fused
    jeng.rerank_k = peng.rerank_k = 32
    retrieved = [ask for ask, s in zip(tap.ASKS, tap._sources(want[0])) if s]
    assert len(retrieved) >= 3
    for ask in retrieved:
        j = {c: rr for c, rr, _ in jeng.query([ask])[0]}
        p = {c: rr for c, rr, _ in peng.query([ask])[0]}
        assert j.keys() == p.keys()
        diff = max(abs(j[c] - p[c]) for c in p)
        best, second = sorted(p.values(), reverse=True)[:2]
        assert best - second > 2 * diff, (ask, best, second, diff)
    sources = tap._assert_same(want, got)
    assert all(len(s) == 1 for s in sources if s)


def test_app_serves_a_stream_from_the_decoder_path_alone(decoder_dirs):
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.serve.app import build_app
    from outline_rag_tpu_torch.serve.http import TestClient
    from outline_rag_tpu_torch.serve.llm import LocalChatProvider
    from outline_rag_tpu_torch.storage import SqliteMetaStore
    from outline_rag_tpu_torch.sync.refresh import TASK_QUEUE
    from tests.fake_outline import FakeOutline

    path, _ = decoder_dirs["llama_sharded_gqa_untied"]
    settings = load_settings({"SECRET_KEY": "s", "DATA_DIR": "", "OUTLINE_WEBHOOK_SECRET": "w",
                              "DECODER_WEIGHTS_PATH": str(path), "DECODER_MAX_NEW_TOKENS": "8",
                              "SHARD_CAPACITY": "4096", "TOP_K": "4", "RERANK_K": "2",
                              # greedy answers: the stream is a function of the weights
                              "BASE_CHAT_MODEL": "local", "CHAT_MODELS_JSON": json.dumps(
                                  [{"id": "local", "provider_model": "local",
                                    "temperature": 0.0}])})
    fake = FakeOutline()
    fake.put_doc("d1", "Wolves", "wolves hunt in packs across the tundra", "t1")
    app = build_app(settings, device="cpu", meta=SqliteMetaStore(":memory:"),
                    outline_transport=fake.transport(), start_workers=False)
    provider = app.state["provider"]
    assert isinstance(provider, LocalChatProvider) and provider.device == torch.device("cpu")
    assert provider.eos_id == 2
    client = TestClient(app)

    async def run():
        await client.post("/chat/login", body=b"name=t",
                          headers={"content-type": "application/x-www-form-urlencoded"})
        await client.post("/chat/update/all")
        ing, bus = app.state["ingestor"], app.state["bus"]
        for _ in range(20):
            item = await bus.pop(TASK_QUEUE, timeout=0.01)
            if item is None:
                break
            if item["task"] == "refresh_all":
                await ing.refresh_all()
            else:
                await ing.process_doc_batch(item["ids"])
        assert app.state["index"].size > 0
        conv = json.loads((await client.post("/chat/api/conversations",
                                             json_body={"title": "t"})).body)
        events = await client.sse("POST", "/chat/api/ask", json_body={
            "question": "how do wolves hunt", "conversation_id": conv["id"]})
        assert events[-1] == "[DONE]"
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events if isinstance(e, dict) and e.get("choices"))
        assert text.strip()  # random weights: arbitrary, decodable, non-empty
        await app.shutdown()

    asyncio.run(run())


def test_an_invalid_decoder_combination_is_not_blamed_on_the_checkpoint(decoder_dirs):
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.serve.app import build_app
    from outline_rag_tpu_torch.storage import SqliteMetaStore

    path, _ = decoder_dirs["llama_sharded_gqa_untied"]
    settings = load_settings({"SECRET_KEY": "s", "DATA_DIR": "", "DECODER_WEIGHTS_PATH": str(path),
                              "DECODER_INT8": "1", "DECODER_INT4": "1"})
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_app(settings, device="cpu", meta=SqliteMetaStore(":memory:"), start_workers=False)


CHAT_TEMPLATE = ("{% for m in messages %}<s> {{ m['role'] }} {{ m['content'] }} </s> {% endfor %}"
                 "{% if add_generation_prompt %}<s> assistant {% endif %}")


def test_local_provider_runs_an_hf_tokenizer_as_the_jax_package_does(decoder_dirs):
    """The chat template, ``encode`` with its BOS, ``eos_token_id`` and
    ``decode``: the port's provider renders and encodes a conversation as
    the JAX package's does."""
    from transformers import AutoTokenizer

    from outline_rag_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from outline_rag_tpu.serve.llm import LocalChatProvider as JaxProvider
    from outline_rag_tpu_torch.serve.llm import LocalChatProvider

    path, _ = decoder_dirs["llama_sharded_gqa_untied"]
    jcfg, jparams = jconvert.load_pretrained_decoder(str(path))
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, max_cache=64)
    cfg, params = convert.load_pretrained_decoder(str(path), device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(cfg, max_cache=64)
    assert isinstance(jcfg, JaxDecoderConfig)
    messages = [{"role": "system", "content": "tell me about the tundra"},
                {"role": "user", "content": "how do wolves hunt"}]
    for template in (None, CHAT_TEMPLATE):
        tok = AutoTokenizer.from_pretrained(str(path))
        tok.chat_template = template
        j = JaxProvider(jax.tree_util.tree_map(jnp.asarray, jparams), jcfg, tok, max_new_tokens=8)
        p = LocalChatProvider(params, cfg, tok, max_new_tokens=8, device="cpu")
        assert p.eos_id == j.eos_id == tok.eos_token_id == 2
        rendered = p._render(messages)
        assert rendered == j._render(messages)
        ids = p._encode_prompt(rendered)
        assert ids == j._encode_prompt(rendered) and ids[0] == tok.bos_token_id
        assert p._flusher(ids)() == tok.decode(ids)
