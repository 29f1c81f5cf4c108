"""The port's HTTP app (``outline_rag_tpu_torch.serve.app.build_app``) on
the CPU, through the in-process TestClient: the scenarios of the JAX
package's ``tests/test_serve.py`` that cover code the port changes or
wires (health and auth gates, conversations and ownership, asks over SSE
with thinking and citations, uploads, the refresh lock, the webhook,
refresh status and metrics, snapshot restore and autosave), the process
entry point and its admin commands, the app without ``httpx``, and the
app over a real socket."""

import asyncio
import http.client
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from outline_rag_tpu_torch.config import load_settings
from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder
from outline_rag_tpu_torch.serve.app import build_app
from outline_rag_tpu_torch.serve.http import TestClient
from outline_rag_tpu_torch.serve.llm import FakeChatProvider
from outline_rag_tpu_torch.storage import SqliteMetaStore
from outline_rag_tpu_torch.sync.refresh import TASK_QUEUE
from outline_rag_tpu_torch.utils.hashing import sign_webhook_body
from tests.fake_outline import FakeOutline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIM = 128
BASE_ENV = {
    "SECRET_KEY": "test-secret",
    "VECTOR_DIM": str(DIM),
    "DATA_DIR": "",
    "OUTLINE_WEBHOOK_SECRET": "whsec",
    "REFRESH_BATCH_SIZE": "2",
    "CHUNK_SIZE": "256",
    "CHUNK_OVERLAP": "32",
    "SHARD_CAPACITY": "4096",
}


def make_app(thinking=False, cite=False, **env):
    settings = load_settings({**BASE_ENV, **env})
    fake = FakeOutline()
    fake.put_doc("d1", "Wolves", "wolves hunt in packs across the tundra", "t1")
    fake.put_doc("d2", "Rivers", "rivers carve canyons over millennia", "t1")
    app = build_app(
        settings,
        device="cpu",
        provider=FakeChatProvider(thinking=thinking, cite=cite),
        embedder=HashEmbedder(dim=DIM),
        meta=SqliteMetaStore(":memory:"),
        outline_transport=fake.transport(),
        start_workers=False,
    )
    return app, fake


async def login(client, name="tester"):
    resp = await client.post(
        "/chat/login",
        body=f"name={name}".encode(),
        headers={"content-type": "application/x-www-form-urlencoded"},
    )
    assert resp.status == 302


async def drain_tasks(app):
    ing = app.state["ingestor"]
    bus = app.state["bus"]
    for _ in range(50):
        item = await bus.pop(TASK_QUEUE, timeout=0.01)
        if item is None:
            return
        if item["task"] == "refresh_all":
            await ing.refresh_all()
        elif item["task"] == "process_doc_batch":
            await ing.process_doc_batch(item["ids"])


async def new_conv(client, title="t"):
    resp = await client.post("/chat/api/conversations", json_body={"title": title})
    assert resp.status == 201
    return json.loads(resp.body)["id"]


def joined(events, key):
    return "".join(
        e["choices"][0]["delta"].get(key, "")
        for e in events
        if isinstance(e, dict) and e.get("choices")
    )


def test_app_builds_its_index_on_the_device_it_is_given():
    app, _ = make_app()
    index = app.state["index"]
    assert index.device == torch.device("cpu") and index.dtype == "int8r"
    assert index.capacity == 4096 and index.dim == DIM


def test_healthz_and_auth_gates():
    app, _ = make_app()
    client = TestClient(app)

    async def run():
        ok = await client.get("/healthz")
        assert ok.status == 200 and json.loads(ok.body) == {"status": "ok", "index_size": 0}
        for path in ("/chat/api/me", "/chat/api/conversations", "/chat/api/metrics"):
            assert (await client.get(path)).status == 401
        assert (await client.post("/chat/api/ask", json_body={"question": "q"})).status == 401
        assert (await client.post("/chat/update/all")).status == 401
        assert (await client.get("/chat/")).status == 302  # redirect to login
        await login(client)
        me = json.loads((await client.get("/chat/api/me")).body)
        assert me["user"]["name"] == "tester"
        assert "qwen-72b" not in [m["id"] for m in me["models"]]  # beta-gated

    asyncio.run(run())


def test_conversation_create_rename_delete_and_ownership():
    app, _ = make_app()
    client, intruder = TestClient(app), TestClient(app)

    async def run():
        await login(client)
        cid = await new_conv(client, "t1")
        convs = json.loads((await client.get("/chat/api/conversations")).body)
        assert [c["id"] for c in convs["conversations"]] == [cid]
        ok = await client.put(f"/chat/api/conversations/{cid}", json_body={"title": "renamed"})
        assert ok.status == 200
        convs = json.loads((await client.get("/chat/api/conversations")).body)
        assert convs["conversations"][0]["title"] == "renamed"
        assert (await client.put(f"/chat/api/conversations/{cid}", json_body={})).status == 400

        await login(intruder, "other")
        path = f"/chat/api/conversations/{cid}"
        assert (await intruder.put(path, json_body={"title": "x"})).status == 403
        assert (await intruder.delete(path)).status == 403
        assert (await intruder.get(path + "/messages")).status == 403
        bad = await intruder.post(
            "/chat/api/ask", json_body={"question": "q", "conversation_id": cid})
        assert bad.status == 403

        assert (await client.delete(path)).status == 200
        assert json.loads((await client.get("/chat/api/conversations")).body)["conversations"] == []

    asyncio.run(run())


def test_refresh_lock_status_then_ask_with_citations():
    app, _ = make_app(cite=True)
    client = TestClient(app)

    async def run():
        await login(client)
        assert (await client.post("/chat/update/all")).status == 202
        assert (await client.post("/chat/update/all")).status == 429  # lock held
        running = json.loads((await client.get("/chat/api/refresh/status")).body)
        assert running["state"] == "idle"  # queued, not started
        await drain_tasks(app)
        status = json.loads((await client.get("/chat/api/refresh/status")).body)
        assert status["state"] == "done" and status["success"] == 2
        assert (await client.post("/chat/update/all")).status == 202  # lock released
        await drain_tasks(app)
        health = json.loads((await client.get("/healthz")).body)
        assert health["index_size"] == app.state["meta"].chunk_count() == 2

        cid = await new_conv(client)
        events = await client.sse(
            "POST", "/chat/api/ask",
            json_body={"question": "how do wolves hunt in the tundra?", "conversation_id": cid},
        )
        assert events[-1] == "[DONE]"
        text = joined(events, "content")
        assert "[source 1]" in text and "[SourcesMap]:" in text
        msgs = json.loads((await client.get(f"/chat/api/conversations/{cid}/messages")).body)
        assert [m["role"] for m in msgs["messages"]] == ["user", "assistant"]
        assert msgs["cached"] is False
        again = json.loads((await client.get(f"/chat/api/conversations/{cid}/messages")).body)
        assert again["cached"] is True and again["messages"] == msgs["messages"]
        line = [ln for ln in msgs["messages"][1]["content"].splitlines()
                if ln.startswith("[SourcesMap]:")][0]
        assert json.loads(line[len("[SourcesMap]:"):])["1"] == {"title": "Wolves", "url": "/doc/d1"}

    asyncio.run(run())


def test_ask_thinking_passthrough_and_general_route():
    app, _ = make_app(thinking=True)
    client = TestClient(app)

    async def run():
        await login(client)
        cid = await new_conv(client)
        events = await client.sse(
            "POST", "/chat/api/ask", json_body={"question": "hello there!", "conversation_id": cid})
        assert events[-1] == "[DONE]"
        assert "considering" in joined(events, "thinking")
        msgs = json.loads((await client.get(f"/chat/api/conversations/{cid}/messages")).body)
        assert "<!--thinking-->" in msgs["messages"][1]["content"]
        assert "[SourcesMap]:" not in msgs["messages"][1]["content"]  # General: no context
        assert (await client.post(
            "/chat/api/ask", json_body={"question": "  ", "conversation_id": cid})).status == 400
        assert (await client.post(
            "/chat/api/ask",
            json_body={"question": "q", "conversation_id": cid, "model": "nope"})).status == 400
        assert (await client.post(
            "/chat/api/ask",
            json_body={"question": "q", "conversation_id": cid, "edit_message_id": "x"})).status == 400

    asyncio.run(run())


def test_edit_resume_truncation():
    app, _ = make_app()
    client = TestClient(app)

    async def run():
        await login(client)
        cid = await new_conv(client)
        for q in ("hello!", "thanks!"):
            await client.sse("POST", "/chat/api/ask", json_body={"question": q, "conversation_id": cid})
        msgs = json.loads((await client.get(f"/chat/api/conversations/{cid}/messages")).body)
        assert len(msgs["messages"]) == 4
        await client.sse("POST", "/chat/api/ask", json_body={
            "question": "hello edited!", "conversation_id": cid,
            "edit_message_id": msgs["messages"][0]["id"]})
        msgs = json.loads((await client.get(f"/chat/api/conversations/{cid}/messages")).body)
        assert [m["content"] for m in msgs["messages"]][:1] == ["hello edited!"]
        assert len(msgs["messages"]) == 2

    asyncio.run(run())


@pytest.mark.parametrize("filename, status", [("notes.md", 201), ("a.txt", 201), ("evil.exe", 400),
                                              ("noext", 400)])
def test_upload_allowlist(filename, status):
    app, _ = make_app()
    client = TestClient(app)
    body = (b"--BOUND\r\n" + (
        f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
        "Content-Type: text/plain\r\n\r\n").encode() + b"hello upload\r\n--BOUND--\r\n")

    async def run():
        await login(client)
        resp = await client.post(
            "/chat/api/upload", body=body,
            headers={"content-type": "multipart/form-data; boundary=BOUND"})
        assert resp.status == status

    asyncio.run(run())


def test_webhook_signature_and_debounce():
    app, _ = make_app()
    client = TestClient(app)

    async def run():
        body = b'{"event":"documents.update"}'
        bad = await client.post("/chat/update/webhook", body=body, headers={
            "x-outline-signature": "nope", "content-type": "application/json"})
        assert bad.status == 401
        assert await app.state["bus"].get("webhook:refresh_timer_due") is None
        sig = sign_webhook_body("whsec", body)
        ok = await client.post("/chat/update/webhook", body=body, headers={
            "x-outline-signature": sig, "content-type": "application/json"})
        assert ok.status == 202
        first = float(await app.state["bus"].get("webhook:refresh_timer_due"))
        await asyncio.sleep(0.01)
        await client.post("/chat/update/webhook", body=body, headers={
            "x-outline-signature": sig, "content-type": "application/json"})
        assert float(await app.state["bus"].get("webhook:refresh_timer_due")) > first  # pushed back

    asyncio.run(run())


def test_metrics_endpoint_has_stage_timings():
    app, _ = make_app()
    client = TestClient(app)

    async def run():
        await login(client)
        await client.post("/chat/update/all")
        await drain_tasks(app)
        cid = await new_conv(client)
        await client.sse("POST", "/chat/api/ask",
                         json_body={"question": "what are wolves?", "conversation_id": cid})
        data = json.loads((await client.get("/chat/api/metrics")).body)
        assert data["index"]["dtype"] == "int8r" and data["index"]["fused"] is False
        assert data["index"]["size"] == 2 and data["index"]["capacity"] == 4096
        for stage in ("http.POST", "llm.classify", "retrieve.staged", "retrieve.embed",
                      "retrieve.index"):
            assert stage in data["stages"], stage

    asyncio.run(run())


def test_concurrent_asks_coalesce_into_batches():
    app, _ = make_app()
    client = TestClient(app)
    calls = []

    async def run():
        await login(client)
        await client.post("/chat/update/all")
        await drain_tasks(app)
        cid = await new_conv(client)
        orig = app.state["batcher"].retrieve_batch
        app.state["batcher"].retrieve_batch = lambda qs: calls.append(len(qs)) or orig(qs)
        results = await asyncio.gather(*[
            client.sse("POST", "/chat/api/ask",
                       json_body={"question": f"wolves number {i}?", "conversation_id": cid})
            for i in range(40)])
        await app.shutdown()
        return results

    results = asyncio.run(run())
    assert all(r[-1] == "[DONE]" for r in results)
    assert sum(calls) == 40 and len(calls) < 30


def test_snapshot_restore_autosave_and_paired_concurrent_saves(tmp_path):
    from outline_rag_tpu_torch.index import VectorIndex

    data_dir = str(tmp_path)
    snap = os.path.join(data_dir, "index_snapshot")
    app, _ = make_app(DATA_DIR=data_dir, INDEX_AUTOSAVE_S="0.05")
    client = TestClient(app)

    async def first_life():
        await app.startup()
        await login(client)
        await client.post("/chat/update/all")
        await drain_tasks(app)
        assert app.state["index"].size == 2
        for _ in range(400):
            await asyncio.sleep(0.05)
            if os.path.exists(snap + ".npz"):
                break
        await app.shutdown()

    asyncio.run(first_life())
    assert os.path.exists(snap + ".npz") and os.path.exists(snap + ".meta.json")

    # two saves at once (the autosave loop and a shutdown save can overlap):
    # whichever lands last, the npz and the meta.json come from one save
    index = app.state["index"]
    threads = [threading.Thread(target=index.save, args=(snap,)) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert VectorIndex.load(snap, device="cpu").size == 2
    assert sorted(os.listdir(data_dir)) == ["index_snapshot.meta.json", "index_snapshot.npz"]

    # second life: an empty meta store, so only the snapshot can fill the index
    app2, _ = make_app(DATA_DIR=data_dir)
    client2 = TestClient(app2)

    async def second_life():
        await app2.startup()
        assert app2.state["index"].size == 2, "snapshot was not adopted at startup"
        assert app2.state["index"].device == torch.device("cpu")
        await login(client2)
        cid = await new_conv(client2)
        events = await client2.sse("POST", "/chat/api/ask", json_body={
            "question": "wolves in the tundra", "conversation_id": cid})
        assert events[-1] == "[DONE]"
        await app2.shutdown()

    asyncio.run(second_life())


def test_snapshot_config_mismatch_falls_through(tmp_path):
    import numpy as np

    from outline_rag_tpu_torch.index import VectorIndex

    other = VectorIndex(dim=64, capacity=1024, dtype="int8r", device="cpu")
    other.add_chunks(["c0"], np.ones((1, 64), np.float32), source_id="s")
    other.save(str(tmp_path / "index_snapshot"))
    app, _ = make_app(DATA_DIR=str(tmp_path))  # DIM=128 != 64

    async def run():
        await app.startup()
        assert app.state["index"].size == 0  # mismatch skipped, no crash
        await app.shutdown()

    asyncio.run(run())


@pytest.mark.parametrize("env, error, what", [
    # a row-sharded index over more devices than are visible (one CPU)
    ({"MESH_DATA_AXIS": "2"}, ValueError, "MESH_DATA_AXIS=2 asks for more devices"),
    # a configured checkpoint that does not load fails fast, naming its path
    ({"RERANKER_WEIGHTS_PATH": "/nonexistent"}, RuntimeError,
     "RERANKER_WEIGHTS_PATH .* from '/nonexistent'"),
    ({"DECODER_WEIGHTS_PATH": "/nonexistent"}, RuntimeError,
     "DECODER_WEIGHTS_PATH .* from '/nonexistent'"),
    ({"ENCODER_WEIGHTS_PATH": "/nonexistent"}, RuntimeError,
     "ENCODER_WEIGHTS_PATH .* from '/nonexistent'"),
])
def test_unported_settings_raise_instead_of_serving_something_else(env, error, what):
    settings = load_settings({**BASE_ENV, **env})
    with pytest.raises(error, match=what):
        build_app(settings, device="cpu", meta=SqliteMetaStore(":memory:"), start_workers=False)


def test_mesh_axis_of_two_shards_the_index():
    """MESH_DATA_AXIS=2 is served: over two CPU entries the index is
    row-sharded, the snapshot restore keeps the mesh."""
    settings = load_settings({**BASE_ENV, "MESH_DATA_AXIS": "2"})
    app = build_app(settings, device="cpu", devices=["cpu", "cpu"],
                    meta=SqliteMetaStore(":memory:"), start_workers=False)
    index = app.state["index"]
    assert index.mesh is not None and index.mesh.size == 2
    assert index.device == torch.device("cpu")


def test_mesh_axis_of_one_is_one_device():
    settings = load_settings({**BASE_ENV, "MESH_DATA_AXIS": "1"})
    app = build_app(settings, device="cpu", meta=SqliteMetaStore(":memory:"), start_workers=False)
    assert app.state["index"].device == torch.device("cpu")
    assert app.state["ingestor"] is None  # no Outline URL configured


def test_default_app_asks_for_the_card():
    """No CPU fallback: the app's default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    settings = load_settings(BASE_ENV)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_app(settings, meta=SqliteMetaStore(":memory:"), start_workers=False)


# -- the process entry point --------------------------------------------------


def _run_main(monkeypatch, capsys, argv, env, device="cpu"):
    from outline_rag_tpu_torch import main as entry

    monkeypatch.setattr(sys, "argv", ["outline_rag_tpu_torch", *argv])
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    entry.main(device=device)
    return capsys.readouterr().out


def test_main_admin_commands_on_the_cpu(tmp_path, monkeypatch, capsys):
    env = {"DATA_DIR": str(tmp_path), "VECTOR_DIM": str(DIM), "SHARD_CAPACITY": "4096",
           "DATABASE_URL": "", "REDIS_URL": "", "ENCODER_WEIGHTS_PATH": "",
           "OUTLINE_API_URL": "", "LOG_LEVEL": "WARNING"}
    out = _run_main(monkeypatch, capsys, ["status"], env)
    status = eval(out.strip().splitlines()[-1])  # the command prints a dict literal
    assert status == {"documents": 0, "chunks": 0, "index_size": 0, "index_capacity": 4096,
                      "dtype": "int8r", "fused": False}

    # a document store with one document: rebuild re-indexes it (the
    # ingestion wiring needs an Outline URL, never contacted here)
    from outline_rag_tpu_torch.storage import SqliteMetaStore as Store

    store = Store(os.path.join(str(tmp_path), "meta.sqlite3"))
    store.upsert_document("d1", "Wolves", "/doc/d1", "t1", "wolves hunt in packs across the tundra")
    store.close()
    with pytest.raises(SystemExit, match="rebuild needs"):
        _run_main(monkeypatch, capsys, ["rebuild"], env)
    env["OUTLINE_API_URL"] = "http://outline.invalid"
    out = _run_main(monkeypatch, capsys, ["rebuild"], env)
    assert "rebuilt 1 documents; index size 1" in out

    path = str(tmp_path / "snap")
    out = _run_main(monkeypatch, capsys, ["save-index", path], env)
    assert "saved index (0 rows)" in out  # each command builds a fresh app
    assert os.path.exists(path + ".npz")


def test_main_serve_without_a_card_raises(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {"DATA_DIR": str(tmp_path), "SECRET_KEY": "s", "OUTLINE_API_URL": "",
           "DATABASE_URL": "", "ENCODER_WEIGHTS_PATH": ""}
    from outline_rag_tpu_torch import main as entry

    monkeypatch.setattr(sys, "argv", ["outline_rag_tpu_torch"])
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main()


def test_process_entry_point_refuses_to_run_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {**os.environ, "DATA_DIR": str(tmp_path), "SECRET_KEY": "s", "PORT": "0",
           "OUTLINE_API_URL": "", "DATABASE_URL": "", "ENCODER_WEIGHTS_PATH": ""}
    proc = subprocess.run([sys.executable, "-m", "outline_rag_tpu_torch", "status"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_dev_server_asks_for_the_card_unless_given_cpu():
    """The dev server's index goes on the card by default and it raises
    without one; ``--cpu`` is the caller's request for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from outline_rag_tpu_torch.tools import dev_server

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(dev_server.main([]))

    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "outline_rag_tpu_torch.tools.dev_server", "--cpu"], cwd=ROOT,
        env={**os.environ, "PORT": str(port)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        ready = ""
        while "dev server on" not in ready:  # blocks until it serves, or ends
            line = proc.stdout.readline()
            assert line, ready
            ready += line
        assert "index size: 3 on cpu" in ready and f"127.0.0.1:{port}" in ready, ready
        resp, data = _request(port, "GET", "/healthz")
        assert resp.status == 200 and json.loads(data)["index_size"] == 3
    finally:
        proc.terminate()
        proc.wait(30)


# -- without httpx -------------------------------------------------------------

NO_HTTPX = r"""
import asyncio, json, sys
sys.modules["httpx"] = None  # import httpx now raises ImportError
import torch
torch.set_num_threads(1)
from outline_rag_tpu_torch.serve.llm import LocalChatProvider, FakeChatProvider
from outline_rag_tpu_torch.serve.app import build_app
from outline_rag_tpu_torch.serve.http import TestClient
from outline_rag_tpu_torch.config import load_settings
from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder
from outline_rag_tpu_torch.storage import SqliteMetaStore
from outline_rag_tpu_torch.sync.refresh import Ingestor
settings = load_settings({"SECRET_KEY": "k", "VECTOR_DIM": "64", "DATA_DIR": "",
                          "SHARD_CAPACITY": "1024", "CHUNK_SIZE": "256"})
app = build_app(settings, device="cpu", provider=FakeChatProvider(cite=True),
                embedder=HashEmbedder(dim=64), meta=SqliteMetaStore(":memory:"),
                start_workers=False)
assert app.state["ingestor"] is None
s = app.state
Ingestor(None, s["meta"], s["index"], s["embedder"], s["bus"], settings).ingest_document(
    "d1", "Wolves", "/doc/d1", "t1", "wolves hunt in packs across the tundra")
client = TestClient(app)

async def run():
    r = await client.post("/chat/login", body=b"name=x",
                          headers={"content-type": "application/x-www-form-urlencoded"})
    assert r.status == 302
    cid = json.loads((await client.post("/chat/api/conversations", json_body={})).body)["id"]
    return await client.sse("POST", "/chat/api/ask",
                            json_body={"question": "how do wolves hunt?", "conversation_id": cid})

events = asyncio.run(run())
assert events[-1] == "[DONE]", events
text = "".join(e["choices"][0]["delta"].get("content", "") for e in events if isinstance(e, dict))
assert "[SourcesMap]:" in text and "Wolves" in text
try:
    import httpx  # noqa: F401
except ImportError:
    print("NO_HTTPX_OK")
"""


def test_app_and_local_provider_import_and_answer_without_httpx():
    proc = subprocess.run([sys.executable, "-c", NO_HTTPX], cwd=ROOT, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_HTTPX_OK" in proc.stdout


# -- over a real socket ----------------------------------------------------------


def _request(port, method, path, body=None, headers=None, cookie=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    h = dict(headers or {})
    if cookie:
        h["Cookie"] = cookie
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        h["Content-Type"] = "application/json"
    conn.request(method, path, body=body, headers=h)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def test_full_stack_over_a_socket():
    """The port's ``serve()`` on 127.0.0.1 on a thread with its own event
    loop, driven by stdlib ``http.client``: login, refresh, an ask to
    ``[DONE]``, the stored messages."""
    from outline_rag_tpu_torch.serve.http import serve

    app, _ = make_app()
    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    def run_server():
        asyncio.set_event_loop(loop)

        async def boot():
            holder["server"] = await serve(app, "127.0.0.1", 0)
            started.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    assert started.wait(30)
    port = holder["server"].sockets[0].getsockname()[1]
    try:
        resp, _ = _request(port, "GET", "/healthz")
        assert resp.status == 200
        resp, _ = _request(port, "POST", "/chat/login", b"name=sock",
                           {"Content-Type": "application/x-www-form-urlencoded"})
        assert resp.status == 302
        cookie = resp.getheader("Set-Cookie").split(";", 1)[0]
        resp, _ = _request(port, "POST", "/chat/update/all", cookie=cookie)
        assert resp.status == 202
        asyncio.run_coroutine_threadsafe(drain_tasks(app), loop).result(60)
        resp, data = _request(port, "GET", "/chat/api/refresh/status", cookie=cookie)
        assert json.loads(data)["state"] == "done"
        resp, data = _request(port, "POST", "/chat/api/conversations", {"title": "sock"},
                              cookie=cookie)
        cid = json.loads(data)["id"]
        resp, data = _request(port, "POST", "/chat/api/ask",
                              {"question": "how do wolves hunt?", "conversation_id": cid},
                              cookie=cookie)
        assert resp.status == 200 and "text/event-stream" in resp.getheader("Content-Type")
        frames = [ln[5:].strip() for ln in data.decode().splitlines() if ln.startswith("data:")]
        assert frames[-1] == "[DONE]"
        text = "".join(json.loads(f)["choices"][0]["delta"].get("content", "")
                       for f in frames[:-1])
        assert "[SourcesMap]:" in text
        resp, data = _request(port, "GET", f"/chat/api/conversations/{cid}/messages",
                              cookie=cookie)
        assert [m["role"] for m in json.loads(data)["messages"]] == ["user", "assistant"]
    finally:
        async def stop():
            holder["server"].close()
            await holder["server"].wait_closed()
            await app.shutdown()

        asyncio.run_coroutine_threadsafe(stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
