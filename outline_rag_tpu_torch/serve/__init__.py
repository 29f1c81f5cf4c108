"""Serving: the continuous decode batcher and the local chat provider.

Unlike ``outline_rag_tpu/serve/__init__.py`` this package imports nothing
of the JAX package: the HTTP app and the remote provider stay there.
"""

from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher
from outline_rag_tpu_torch.serve.llm import LocalChatProvider

__all__ = ["DONE", "DecodeBatcher", "LocalChatProvider"]
