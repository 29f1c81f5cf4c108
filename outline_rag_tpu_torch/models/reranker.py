"""Cross-encoder reranker (the bge-reranker-v2-m3 architecture).

Port of ``outline_rag_tpu/models/reranker.py``: the (query, chunk) pair
runs through the XLM-R trunk and a classification head on the CLS token
(dense -> tanh -> out_proj(1)). The head's parameters are held in the
compute dtype (the JAX package's cast rule rounds them there too) and the
head computes in true f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from outline_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, zero_linear


class Reranker(nn.Module):
    def __init__(self, cfg: EncoderConfig, device: str | torch.device):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        dev = self.encoder.word.device
        self.dense = zero_linear(cfg.hidden, cfg.hidden, cfg, dev)
        self.out = zero_linear(cfg.hidden, 1, cfg, dev)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Relevance scores [B] (raw logits, monotonic in relevance)."""
        cls = self.encoder(input_ids, attention_mask)[:, 0, :].float()
        h = torch.tanh(F.linear(cls, self.dense.weight.float(), self.dense.bias.float()))
        return F.linear(h, self.out.weight.float(), self.out.bias.float())[:, 0]
