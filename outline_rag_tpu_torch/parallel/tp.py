"""Tensor parallelism for the decoder LM (Megatron layout).

Port of ``outline_rag_tpu/parallel/tp.py``. The JAX package annotates the
parameters with shardings and lets GSPMD insert the collectives; the port
states the same layout outright. Over a mesh of n devices (axis ``model``):

- column-parallel: ``wq`` / ``wk`` / ``wv`` (attention heads split, device
  r holding heads ``[r*H/n, (r+1)*H/n)`` and KV heads ``[r*KvH/n, ...)``),
  ``wg`` / ``wu`` (the MLP's intermediate split) and their biases. A fused
  ``wqkv`` is split by blocks of q, k and v heads (device r's local
  ``wqkv`` is ``[wq_r | wk_r | wv_r]``), a fused ``wgu`` as ``[wg_r |
  wu_r]``, never as one contiguous column split;
- row-parallel: ``wo`` / ``wd``, each device holding a slice of the
  contraction; the forward sums the n partial products on the first device
  in shard order (``models/decoder.py``), the one communication a
  projection (JAX's ``psum``);
- replicated: norms, embeddings and ``lm_head``, kept once on the first
  device, where the forward computes them once.

Quantized leaves keep their layouts: w8a8 ``{"q": [N, K], "s": [N]}``
splits N (column) or K with ``s`` copied (row); int4 ``{"q4": [N, K/2],
"s4": [N, G]}`` splits N, or whole 256-element pair blocks of K with their
scale groups (row; an int4 K that does not split so stays whole on the first
device, which then takes the gathered activations). ``heads % n`` and
``kv_heads % n`` must be 0.

The KV ring and the paged pool shard on their KvH axis: the ring becomes
``(k_shards, v_shards)``, a pair of per-device lists, and a
:class:`~outline_rag_tpu_torch.models.decoder.PagedKV` carries its mesh, its
pools as per-device lists and its table once, on the first device.
"""

from __future__ import annotations

import dataclasses

import torch

from outline_rag_tpu_torch.parallel.mesh import Mesh, pick_devices, visible_devices

MODEL_AXIS = "model"

_COLUMN = ("wq", "wk", "wv", "wg", "wu", "bq", "bk", "bv")
_ROW = ("wo", "wd")


def model_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """One ``model`` axis over the first ``n_devices`` of ``devices`` (the
    visible CUDA devices by default); more than there are is a
    ``ValueError``."""
    if devices is None:
        devices = visible_devices("cuda")
    return Mesh(pick_devices(n_devices, devices, "TP mesh"), (MODEL_AXIS,))


def check_tp_config(cfg, n: int) -> None:
    if cfg.heads % n or cfg.kv_heads % n:
        raise ValueError(
            f"heads={cfg.heads}/kv_heads={cfg.kv_heads} not divisible by tp_devices={n}"
        )


def local_config(cfg, n: int):
    """The config one shard's attention and MLP run with: its heads, KV
    heads and intermediate width (the head width stays the model's)."""
    check_tp_config(cfg, n)
    if cfg.intermediate % n:
        raise ValueError(f"intermediate={cfg.intermediate} not divisible by tp_devices={n}")
    return dataclasses.replace(
        cfg, heads=cfg.heads // n, kv_heads=cfg.kv_heads // n, head_dim=cfg.hd,
        intermediate=cfg.intermediate // n,
    )


def _chunks(x: torch.Tensor, n: int, dim: int) -> list[torch.Tensor]:
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"a dimension of {size} does not split {n} ways")
    return list(torch.split(x, size // n, dim=dim))


def _column(w, n: int, parts=None) -> list:
    """Column-parallel split of a weight or bias: dense ``[K, N]`` (or
    ``[N]``) on its last axis, quantized leaves on their N axis. ``parts``
    (output widths that sum to N, the fused q, k and v or gate and up) are
    split each and put back together a shard at a time."""

    def split(x, dim):
        if parts is None:
            return _chunks(x, n, dim)
        blocks = [_chunks(p, n, dim) for p in torch.split(x, parts, dim=dim)]
        return [torch.cat([b[r] for b in blocks], dim=dim) for r in range(n)]

    if not isinstance(w, dict):
        return split(w, w.dim() - 1)
    return [dict(zip(w, leaves)) for leaves in zip(*(split(v, 0) for v in w.values()))]


def _row(w, n: int) -> list:
    """Row-parallel split: dense ``[K, N]`` on K; w8a8 ``q`` on K with the
    per-output scales copied; int4 ``q4`` on whole pair blocks of K with
    their scale groups. An int4 weight whose K does not split into those
    stays whole on the first shard (None on the others): the forward then
    gathers the activations there, as GSPMD all-gathers when the groups do
    not divide over the mesh."""
    if not isinstance(w, dict):
        return _chunks(w, n, 0)
    if "q" in w:
        return [{"q": q, "s": w["s"]} for q in _chunks(w["q"], n, 1)]
    q4, s4 = w["q4"], w["s4"]
    k = q4.shape[1] * 2
    gsz = k // s4.shape[1]
    if k % n or (k // n) % 256 or (k // n) % gsz:
        return [w] + [None] * (n - 1)
    return [{"q4": q, "s4": s} for q, s in zip(_chunks(q4, n, 1), _chunks(s4, n, 1))]


def _split_layer(layer: dict, cfg, n: int) -> list[dict]:
    """A layer's per-shard dictionaries (norm scales stay on the layer)."""
    hd = cfg.hd
    qkv = [cfg.heads * hd, cfg.kv_heads * hd, cfg.kv_heads * hd]
    shards = [{} for _ in range(n)]
    for name, w in layer.items():
        if name in ("ln1", "ln2"):
            continue
        if name in _COLUMN:
            parts = _column(w, n)
        elif name in ("wqkv", "bqkv"):
            parts = _column(w, n, qkv)
        elif name == "wgu":
            parts = _column(w, n, [cfg.intermediate, cfg.intermediate])
        elif name in _ROW:
            parts = _row(w, n)
        else:
            raise ValueError(f"no tensor-parallel layout for the leaf {name!r}")
        for shard, part in zip(shards, parts):
            shard[name] = part
    return shards


def _to(x, dev: torch.device):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x.to(dev).contiguous()


def shard_decoder_params(params: dict, mesh: Mesh, cfg) -> dict:
    """A decoder parameter dictionary (unfused or fused, float, w8a8 or
    int4) laid out over the TP mesh: ``{"embed", "final_norm", "lm_head"}``
    on the first device, ``"mesh"``, and ``"layers"``, each
    ``{"ln1", "ln2", "shards": [one dictionary a device]}``."""
    n = mesh.size
    check_tp_config(cfg, n)
    first = mesh.devices[0]
    out = {k: _to(v, first) for k, v in params.items() if k != "layers"}
    out["mesh"] = mesh
    layers = []
    for layer in params["layers"]:
        shards = _split_layer(layer, cfg, n)
        layers.append({
            "ln1": _to(layer["ln1"], first),
            "ln2": _to(layer["ln2"], first),
            "shards": [_to(s, dev) for s, dev in zip(shards, mesh.devices)],
        })
    out["layers"] = layers
    return out


def shard_decoder_cache(cache, mesh: Mesh):
    """The KV ring ``(k, v)``, each ``[L, B, KvH, C, Dh]``, split on KvH:
    ``(k_shards, v_shards)``, shard r on ``mesh.devices[r]``."""
    k, v = cache
    return tuple(
        [c.to(dev).contiguous() for c, dev in zip(_chunks(x, mesh.size, 2), mesh.devices)]
        for x in (k, v)
    )
