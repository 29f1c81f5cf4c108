"""Data-parallel batched encoding for index builds.

Port of ``outline_rag_tpu/parallel/encode.py``. Building a large index
means running the encoder over every chunk, which is data-parallel with no
communication at all: every device holds the parameters, the token batch
is split into equal row blocks over the mesh, each device embeds its
block, and the embeddings come back in row order on the mesh's first
device.
"""

from __future__ import annotations

import copy

import torch

from outline_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, pooled_embeddings
from outline_rag_tpu_torch.parallel.mesh import Mesh


def make_sharded_encoder(cfg: EncoderConfig, mesh: Mesh):
    """Returns ``encode(encoder, ids, mask) -> [B, H]`` with the batch rows
    split over the mesh; ``B`` must be divisible by the mesh size. A device
    the encoder does not live on gets its own copy, made once."""
    copies: dict[tuple[int, torch.device], Encoder] = {}

    def on(encoder: Encoder, dev: torch.device) -> Encoder:
        if next(encoder.parameters()).device == dev:
            return encoder
        key = (id(encoder), dev)
        if key not in copies:
            copies[key] = copy.deepcopy(encoder).to(dev)
        return copies[key]

    @torch.inference_mode()
    def encode(encoder: Encoder, ids, mask) -> torch.Tensor:
        if encoder.cfg != cfg:
            raise ValueError(f"the encoder has config {encoder.cfg}, the sharded encoder {cfg}")
        ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
        b = ids.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch of {b} rows does not split over {mesh.size} devices")
        per = b // mesh.size
        out = []
        for r, dev in enumerate(mesh.devices):
            rows = slice(r * per, (r + 1) * per)
            out.append(pooled_embeddings(on(encoder, dev), ids[rows].to(dev), mask[rows].to(dev)))
        first = mesh.devices[0]
        return torch.cat([e.to(first) for e in out], dim=0)

    return encode
