"""Outline wiki synchronization: API client, delta refresh, webhook debounce.

Preserves the reference's sync behavior (SURVEY.md sections 3.3/3.4):
updatedAt-diff protocol, batch ingestion through the task queue, 60-second
webhook debounce — with ingestion landing as delta-append + tombstones on
device shards instead of SQL delete/insert.
"""

from outline_rag_tpu_torch.sync.outline import OutlineClient
from outline_rag_tpu_torch.sync.refresh import Ingestor, refresh_status

__all__ = ["OutlineClient", "Ingestor", "refresh_status"]
