"""The slice as a whole: the JAX package's app and the port's app, built
from the same inputs (the same fake Outline wiki, the same fake chat
provider, the same embedder weights), serve the same asks with the same
SSE frames (content, thinking, model, and the sources in the same order)
and store the same message history.

Two configurations: the hash embedder on the staged path, then a tiny
encoder and cross-encoder whose weights are the JAX package's params
carried across (``encoder_from_jax`` / ``reranker_from_jax``), on the fused
path over an int8r index. The bar is exact: equal frames and equal source
ids. The wiki's documents are chosen so that every ranking the asks depend
on is decided by a gap of more than ``GAP`` (the port's scores agree with
JAX's to ~1e-6 on the hash embedder and to 1e-4 on the tiny models,
``tests/test_torch_engine.py``); the tests check the gaps first. The JAX
app runs with ``MESH_DATA_AXIS=1`` (one device; the test session shows JAX
eight CPU devices)."""

import asyncio
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from outline_rag_tpu.config import load_settings as jax_load_settings
from outline_rag_tpu.engine.embedder import EncoderEmbedder as JaxEmbedder
from outline_rag_tpu.engine.rerank import CrossEncoderReranker as JaxReranker
from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models.hash_embedder import HashEmbedder as JaxHashEmbedder
from outline_rag_tpu.models.reranker import init_reranker_params
from outline_rag_tpu.serve.app import build_app as jax_build_app
from outline_rag_tpu.serve.http import TestClient as JaxClient
from outline_rag_tpu.serve.llm import FakeChatProvider as JaxFake
from outline_rag_tpu.storage import SqliteMetaStore as JaxStore
from outline_rag_tpu_torch.config import load_settings
from outline_rag_tpu_torch.engine import CrossEncoderReranker, EncoderEmbedder
from outline_rag_tpu_torch.models.convert import encoder_from_jax, reranker_from_jax
from outline_rag_tpu_torch.models.encoder import EncoderConfig
from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder
from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
from outline_rag_tpu_torch.serve.app import build_app
from outline_rag_tpu_torch.serve.http import TestClient
from outline_rag_tpu_torch.serve.llm import FakeChatProvider
from outline_rag_tpu_torch.storage import SqliteMetaStore
from tests.fake_outline import FakeOutline

torch.set_num_threads(1)

GAP = 1e-3  # least gap between neighbouring rerank (and hash-embedder) scores
DENSE_GAP = 1e-4  # least gap between neighbouring dense scores of the tiny encoder
ENV = {
    "SECRET_KEY": "parity",
    "DATA_DIR": "",
    "MESH_DATA_AXIS": "1",
    "REFRESH_BATCH_SIZE": "3",
    "CHUNK_SIZE": "120",
    "CHUNK_OVERLAP": "20",
    "TOP_K": "6",  # fewer candidates than chunks: the scan decides which are reranked
    "SHARD_CAPACITY": "1024",
    "TOKEN_WIDTH": "32",
}
DOCS = [
    ("d1", "Wolves", "Wolves hunt in coordinated packs across the frozen tundra. The alpha "
     "pair leads the pack during long winter migrations after caribou herds. Pups stay "
     "near the den while older wolves hunt at night."),
    ("d2", "Rivers", "Rivers carve deep canyons over millennia through sedimentary rock. "
     "A delta forms where the flow slows and drops its silt into the sea."),
    ("d3", "Stars", "Stars fuse hydrogen into helium deep in their cores. Heavier "
     "elements form in supernova explosions at the end of a massive star's life."),
    ("d4", "Release process", "Every release is tested on Monday. The release manager "
     "tags the build, runs the regression suite and signs the changelog."),
    ("d5", "Geiger counters", "A geiger counter measures ionizing radiation by counting "
     "pulses in a gas tube. Calibrate the counter every spring."),
]
ASKS = [
    "how do wolves hunt in the tundra?",
    "hello there!",
    "when is the release tested and who signs the changelog?",
    "how does a river delta form?",
]


def _wiki():
    fake = FakeOutline()
    for doc_id, title, text in DOCS:
        fake.put_doc(doc_id, title, text, "t1")
    return fake


async def _drive(client, app, task_queue):
    """Login, refresh, one conversation with every ask; returns the parsed
    frames of each ask and the stored history."""
    r = await client.post("/chat/login", body=b"name=parity",
                          headers={"content-type": "application/x-www-form-urlencoded"})
    assert r.status == 302
    assert (await client.post("/chat/update/all")).status == 202
    ing, bus = app.state["ingestor"], app.state["bus"]
    for _ in range(50):
        item = await bus.pop(task_queue, timeout=0.01)
        if item is None:
            break
        if item["task"] == "refresh_all":
            await ing.refresh_all()
        else:
            await ing.process_doc_batch(item["ids"])
    status = json.loads((await client.get("/chat/api/refresh/status")).body)
    assert status["state"] == "done" and status["success"] == len(DOCS)
    cid = json.loads((await client.post("/chat/api/conversations",
                                        json_body={"title": "p"})).body)["id"]
    frames = []
    for question in ASKS:
        events = await client.sse("POST", "/chat/api/ask",
                                  json_body={"question": question, "conversation_id": cid})
        frames.append([e for e in events if e != "ping"])
    msgs = json.loads((await client.get(f"/chat/api/conversations/{cid}/messages")).body)
    history = [(m["role"], m["content"], m["model"]) for m in msgs["messages"]]
    await app.shutdown()
    return frames, history


def _sources(frames):
    """The SourcesMap of each ask (None where the ask had no context)."""
    out = []
    for events in frames:
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events if isinstance(e, dict))
        line = [ln for ln in text.splitlines() if ln.startswith("[SourcesMap]:")]
        out.append(json.loads(line[0][len("[SourcesMap]:"):]) if line else None)
    return out


def _gaps_ok(scores, gap=GAP):
    """Neighbouring scores of each ranked row are more than ``gap`` apart."""
    for row in scores:
        row = sorted(row, reverse=True)
        assert all(a - b > gap for a, b in zip(row, row[1:])), row


def _dense_gaps_ok(retrieval):
    """The scan's ranking of every ask: the top TOP_K + 1 dense scores apart
    by more than ``DENSE_GAP``, so the same candidates reach the rerank."""
    index = retrieval.index
    assert index.size > retrieval.top_k
    _, scores = index.query(retrieval.embedder.embed(ASKS), retrieval.top_k + 1)
    _gaps_ok(scores, DENSE_GAP)


def _serve_both(jax_parts, port_parts):
    from outline_rag_tpu.sync.refresh import TASK_QUEUE as JAX_QUEUE
    from outline_rag_tpu_torch.sync.refresh import TASK_QUEUE

    japp = jax_build_app(jax_load_settings(ENV), provider=JaxFake(thinking=True, cite=True),
                         meta=JaxStore(":memory:"), outline_transport=_wiki().transport(),
                         start_workers=False, **jax_parts)
    papp = build_app(load_settings(ENV), device="cpu",
                     provider=FakeChatProvider(thinking=True, cite=True),
                     meta=SqliteMetaStore(":memory:"), outline_transport=_wiki().transport(),
                     start_workers=False, **port_parts)
    want = asyncio.run(_drive(JaxClient(japp), japp, JAX_QUEUE))
    got = asyncio.run(_drive(TestClient(papp), papp, TASK_QUEUE))
    return japp, papp, want, got


def _assert_same(want, got):
    (jframes, jhist), (pframes, phist) = want, got
    for question, j, p in zip(ASKS, jframes, pframes):
        assert p[-1] == "[DONE]" and j[-1] == "[DONE]"
        assert p == j, question
    assert phist == jhist
    sources = _sources(pframes)
    assert sources == _sources(jframes)
    assert all(sources)  # the fake classifier routes every ask to a retrieving persona
    return sources


def test_hash_embedder_app_matches_jax():
    japp, papp, want, got = _serve_both({"embedder": JaxHashEmbedder(dim=128)},
                                        {"embedder": HashEmbedder(dim=128)})
    assert papp.state["retrieval"].fused is False and japp.state["retrieval"].fused is False
    assert papp.state["index"].size == japp.state["index"].size >= len(DOCS)
    retrieval = papp.state["retrieval"]
    qvecs = retrieval.embedder.embed(ASKS)
    _, scores = retrieval.index.query(qvecs, retrieval.rerank_k + 1)
    _gaps_ok(scores)
    sources = _assert_same(want, got)
    assert sources[0]["1"]["title"] == "Wolves"
    assert sources[2]["1"]["title"] == "Release process"


@pytest.fixture(scope="module")
def tiny_models():
    jcfg = je.EncoderConfig.tiny()
    # encoder weights scaled from the init's std 0.02 to 0.5, as
    # test_torch_engine.py does: at 0.02 the tiny encoder maps every text to
    # nearly one vector
    enc_p = jax.tree_util.tree_map(lambda x: x * 25 if x.ndim == 2 else x,
                                   je.init_encoder_params(jax.random.key(0), jcfg))
    # and the cross-encoder's likewise: at 0.02 its scores for any two
    # chunks lie within ~3e-5 of one another
    rr_p = jax.tree_util.tree_map(lambda x: x * 25 if x.ndim == 2 else x,
                                  init_reranker_params(jax.random.key(1), jcfg))
    tok = HashTokenizer(vocab_size=jcfg.vocab_size)
    np_tree = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    pcfg = EncoderConfig.tiny()
    jax_parts = {
        "embedder": JaxEmbedder(enc_p, jcfg, tok, max_tokens=64, seq_buckets=(32, 64),
                                name="tiny"),
        "reranker": JaxReranker(rr_p, jcfg, tok, max_tokens=128),
    }
    port_parts = {
        "embedder": EncoderEmbedder(encoder_from_jax(np_tree(enc_p), pcfg, device="cpu"), tok,
                                    max_tokens=64, seq_buckets=(32, 64)),
        "reranker": CrossEncoderReranker(reranker_from_jax(np_tree(rr_p), pcfg, device="cpu"),
                                         tok, max_tokens=128),
    }
    return jax_parts, port_parts


def test_carried_encoder_and_reranker_fused_app_matches_jax(tiny_models):
    japp, papp, want, got = _serve_both(*tiny_models)
    for app in (japp, papp):
        assert app.state["retrieval"].fused and app.state["index"].dtype == "int8r"
        assert app.state["index"].tokens is not None
    retrieval = papp.state["retrieval"]
    _dense_gaps_ok(retrieval)
    rows = retrieval.retrieve_batch(ASKS)
    _gaps_ok([[c.rerank_score for c in row] for row in rows])
    _assert_same(want, got)


@pytest.mark.parametrize("name", ["script.min.js", "style.min.css"])
def test_minified_bundle_is_served_as_the_jax_app_serves_it(name, tmp_path):
    """Both apps serve their whole static directory: the port's answers the
    minified bundle with 200 and the bytes the JAX app answers with. The JAX
    package's bundle is a git-ignored output of ``tools/build_assets.py``;
    where it was not built, the JAX app's static mount is pointed at a copy
    of its static directory with the bundle built from its sources."""
    from tests.test_torch_copies import JAX, built_bundle

    static = JAX / "serve" / "static"
    japp = jax_build_app(jax_load_settings(ENV), provider=JaxFake(), meta=JaxStore(":memory:"),
                         outline_transport=_wiki().transport(), start_workers=False,
                         embedder=JaxHashEmbedder(dim=128))
    papp = build_app(load_settings(ENV), device="cpu", provider=FakeChatProvider(),
                     meta=SqliteMetaStore(":memory:"), outline_transport=_wiki().transport(),
                     start_workers=False, embedder=HashEmbedder(dim=128))
    if not (static / name).exists():
        served = tmp_path / "static"
        shutil.copytree(static, served)
        built_bundle(served)
        japp.static_mounts = [(prefix, str(served) if Path(d) == static else d)
                              for prefix, d in japp.static_mounts]

    async def fetch(client, app):
        response = await client.get(f"/chat/static/{name}")
        await app.shutdown()
        return response

    want = asyncio.run(fetch(JaxClient(japp), japp))
    got = asyncio.run(fetch(TestClient(papp), papp))
    assert want.status == 200 and got.status == 200
    assert got.body == want.body and len(got.body) > 1000
