"""HTTP serving layer, chat providers and the local decoder's batcher.

The asyncio HTTP/1.1 framework (``serve.http``), the ``/chat`` API surface
(``serve.app``), the ask pipeline (``serve.chat``), OIDC and dev login
(``serve.auth``), the chat providers (``serve.llm``) and the continuous
decode batcher (``serve.decode_batcher``). Nothing here imports the JAX
package.
"""

from outline_rag_tpu_torch.serve.app import build_app
from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher
from outline_rag_tpu_torch.serve.http import App, Request, Response
from outline_rag_tpu_torch.serve.llm import LocalChatProvider

__all__ = ["App", "DONE", "DecodeBatcher", "LocalChatProvider", "Request", "Response", "build_app"]
