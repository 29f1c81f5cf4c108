"""Run the port's app fully offline with fixture data (dev/demo/browser
testing).

    python -m outline_rag_tpu_torch.tools.dev_server         # on the card
    python -m outline_rag_tpu_torch.tools.dev_server --cpu   # on the CPU

``PORT`` sets the port (default 8011). Starts the server with: hash
embedder, fake chat provider, in-memory sqlite, an int8r index on the card
(or, with ``--cpu``, on the CPU), and a fake Outline wiki
(``tests/fake_outline.py``) pre-loaded with a few documents already
ingested. Dev login is enabled (no OIDC configured). Without ``--cpu`` and
without a card it raises, as ``build_app`` does. Adapted from the JAX
package's ``tools/dev_server.py``: the same wiki and wiring, with the
device chosen by the caller.
"""

from __future__ import annotations

import asyncio
import os
import sys

from outline_rag_tpu_torch.config import load_settings
from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder
from outline_rag_tpu_torch.serve.app import build_app
from outline_rag_tpu_torch.serve.http import serve
from outline_rag_tpu_torch.serve.llm import FakeChatProvider
from outline_rag_tpu_torch.storage import SqliteMetaStore

DOCS = [
    ("d1", "Wolf Pack Dynamics", "Wolves hunt in coordinated packs across the tundra.\n\nThe alpha pair leads seasonal migrations following caribou herds."),
    ("d2", "River Geology", "Rivers carve canyons over millennia through sedimentary rock.\n\nDelta formation occurs where flow velocity drops."),
    ("d3", "Stellar Fusion", "Stars fuse hydrogen into helium in their cores.\n\nHeavier elements form during supernova events."),
]


async def start(device: str, port: int):
    """The app on ``device`` with the fixture wiki ingested, and its server
    listening on 127.0.0.1:``port``."""
    # the fixture wiki of the tests (an httpx mock transport), found from here
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "tests"))
    from fake_outline import FakeOutline

    settings = load_settings(
        {
            "SECRET_KEY": "dev-demo-secret",
            "VECTOR_DIM": "256",
            "DATA_DIR": "",
            "OUTLINE_WEBHOOK_SECRET": "whsec",
            "CHUNK_SIZE": "256",
            "CHUNK_OVERLAP": "32",
            "PORT": str(port),
        }
    )
    fake = FakeOutline()
    for doc_id, title, text in DOCS:
        fake.put_doc(doc_id, title, text, "t1")
    app = build_app(
        settings,
        device=device,
        provider=FakeChatProvider(thinking=True),
        embedder=HashEmbedder(dim=256),
        meta=SqliteMetaStore(":memory:"),
        outline_transport=fake.transport(),
        start_workers=True,
    )
    ing = app.state["ingestor"]
    await ing.refresh_all()
    # drain ingestion inline so the index is warm before serving
    bus = app.state["bus"]
    while True:
        item = await bus.pop("task_queue", timeout=0.05)
        if item is None:
            break
        if item["task"] == "process_doc_batch":
            await ing.process_doc_batch(item["ids"])
    return app, await serve(app, "127.0.0.1", port)


async def main(argv: list[str]) -> None:
    device = "cpu" if "--cpu" in argv else "cuda"
    port = int(os.environ.get("PORT", 8011))
    app, server = await start(device, port)
    print(f"index size: {app.state['index'].size} on {app.state['index'].device}")
    print(f"dev server on http://127.0.0.1:{port}/chat/", flush=True)
    async with server:
        await server.serve_forever()


if __name__ == "__main__":
    asyncio.run(main(sys.argv[1:]))
