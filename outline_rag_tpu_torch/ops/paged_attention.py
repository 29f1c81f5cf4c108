"""Paged decode attention and the KV page write.

Port of ``outline_rag_tpu/ops/paged_attention.py``. The decoder's KV lives
in a shared pool of fixed-size pages; each sequence owns an ordered list of
page ids (its row of the page table), so device memory follows the actual
sequence lengths. Page 0 is the scratch page: inactive rows and writes past
a row's capacity land there, and its content is garbage by contract.

- :func:`paged_attention`       — on CUDA tensors it launches the
                                  hand-written kernel in
                                  ``csrc/paged_attention.cu`` (or raises);
                                  on CPU tensors it runs the plain twin.
- :func:`paged_attention_plain` — the same function in plain PyTorch.
- :func:`paged_kv_write`        — the scatter of new K/V rows into their
                                  pages, in place: ``csrc/paged_kv_write.cu``
                                  on CUDA tensors, the plain twin on CPU.
- :func:`paged_kv_write_plain`  — the same scatter in plain PyTorch.

**Pool layout.** One layer's pool is ``[P, KvH, page, Dh]``: a token's
``Dh`` values are contiguous (128-byte rows in bf16 at ``Dh = 64``), which
is what coalesced 16-byte loads want. The JAX package stores
``[P, KvH, Dh, page]`` (position minor) for the TPU's 128-lane tile;
``models/convert.py::paged_kv_from_jax`` converts. Scales of an int8 pool
are ``[P, KvH, page]`` f32 in both packages.

One kernel replaces the JAX package's three page walks (``head``, ``page``,
``dma``), which differ only in how they amortise the TPU's per-grid-step
cost; there is no ``variant`` here.
"""

from __future__ import annotations

import ctypes
import math

import torch

MASKED = -1e9  # logit of a slot a query may not see

_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
KERNEL_HEAD_DIMS = (64, 128)
# The kernel cuts a row's slots at multiples of SPLIT and folds the splits'
# softmax states in a cluster of SPLIT_CLUSTER blocks (``SPLIT`` and
# ``CLUSTER`` in ``csrc/paged_attention.cu``; a CPU test holds the two equal).
SPLIT = 256
SPLIT_CLUSTER = 8


def paged_attention_plain(
    q: torch.Tensor,  # [B, T, H, Dh] (already rotary-embedded)
    pool_k: torch.Tensor,  # [P, KvH, page, Dh]
    pool_v: torch.Tensor,  # [P, KvH, page, Dh]
    table: torch.Tensor,  # [B, MAXP] int32 page ids (position order)
    pos: torch.Tensor,  # [B] int32 — absolute position of q[:, 0]
    k_scale: torch.Tensor | None = None,  # [P, KvH, page] f32 (int8 pools)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``[B, T, H, Dh]`` in q's
    dtype. It gathers every page of every row (``[B, KvH, MAXP*page, Dh]``)
    and repeats the kernel's rounding: f32 logits scaled by ``1/sqrt(Dh)``
    (then by the k-scales of an int8 pool), ``-1e9`` for slots past
    ``pos + t``, the unnormalised ``p`` cast to the pool's dtype before
    ``p.v`` while the row sum adds the f32 ``p`` (int8 pool: ``p`` times the
    v-scales, f32 products), one division at the end (a sum <= 0 divides by
    1). The max is the whole row's (the kernel keeps a running max over the
    key tiles of each ``SPLIT``-slot split and folds the splits), so the two
    differ by a few ulps of ``p``'s dtype. Callers keep TF32 off."""
    b, t, h, dh = q.shape
    _, kvh, page, _ = pool_k.shape
    maxp = table.shape[1]
    c = maxp * page
    group = h // kvh
    quant = k_scale is not None
    tbl = table.long()

    def gather(pool, scale):  # -> [B, KvH, C, Dh] f32, [B, KvH, C] or None
        g = pool[tbl].permute(0, 2, 1, 3, 4).reshape(b, kvh, c, dh).float()
        if scale is None:
            return g, None
        return g, scale[tbl].permute(0, 2, 1, 3).reshape(b, kvh, c).float()

    kc, ks = gather(pool_k, k_scale)
    vc, vs = gather(pool_v, v_scale)
    positions = pos.long()[:, None] + torch.arange(t, device=q.device)[None, :]  # [B, T]
    slot = torch.arange(c, device=q.device)
    allowed = slot[None, None, :] <= positions[:, :, None]  # [B, T, C]
    qg = q.float().reshape(b, t, kvh, group, dh)
    s = torch.einsum("btngd,bncd->btngc", qg, kc) * (1.0 / math.sqrt(dh))
    if quant:
        s = s * ks[:, None, :, None, :]
    s = torch.where(allowed[:, :, None, None, :], s, torch.full_like(s, MASKED))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom <= 0, torch.ones_like(denom), denom)
    if quant:
        pw = p * vs[:, None, :, None, :]
    else:
        pw = p.to(pool_v.dtype).float()
    ctx = torch.einsum("btngc,bncd->btngd", pw, vc) / denom
    return ctx.reshape(b, t, h, dh).to(q.dtype)


def paged_kv_write_plain(
    pool_k, pool_v, table, pos, k_new, v_new,
    k_scale=None, v_scale=None, ks_new=None, vs_new=None,
):
    """The scatter in plain PyTorch, in place (same arguments and return as
    :func:`paged_kv_write`). Positions at or past ``MAXP * page`` go to the
    scratch page 0, never to the row's last table entry."""
    b, t = k_new.shape[:2]
    page = pool_k.shape[2]
    maxp = table.shape[1]
    positions = pos.long()[:, None] + torch.arange(t, device=pos.device)[None, :]  # [B, T]
    page_idx = positions // page
    looked_up = torch.gather(table.long(), 1, page_idx.clamp(max=maxp - 1))
    w_pages = torch.where(page_idx < maxp, looked_up, torch.zeros_like(looked_up))
    w_offs = positions % page
    pool_k[w_pages, :, w_offs] = k_new
    pool_v[w_pages, :, w_offs] = v_new
    if k_scale is None:
        return pool_k, pool_v
    k_scale[w_pages, :, w_offs] = ks_new
    v_scale[w_pages, :, w_offs] = vs_new
    return pool_k, pool_v, k_scale, v_scale


_launch_fns: dict[str, object] = {}


def _launcher(name: str):
    if name not in _launch_fns:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        lib = load_library()
        p, i32 = ctypes.c_void_p, ctypes.c_int
        attn = lib.paged_attention_launch
        attn.argtypes = [p] * 8 + [i32] * 9 + [ctypes.c_float, p]
        attn.restype = ctypes.c_int
        write = lib.paged_kv_write_launch
        write.argtypes = [p] * 10 + [i32] * 6 + [p]
        write.restype = ctypes.c_int
        _launch_fns.update(attention=attn, write=write)
    return _launch_fns[name]


def _check_on(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, want {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_pool(pool_k, pool_v, k_scale, v_scale, table, pos, batch):
    """Shapes and dtypes both kernels share; returns (P, KvH, page, Dh, MAXP)."""
    if pool_k.dim() != 4 or pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError("pool_k and pool_v must be [P, KvH, page, Dh] of one dtype")
    p_, kvh, page, dh = pool_k.shape
    if table.dim() != 2 or table.shape[0] != batch or table.dtype != torch.int32:
        raise ValueError(f"table must be int32 [{batch}, MAXP], got {table.dtype} {tuple(table.shape)}")
    if tuple(pos.shape) != (batch,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be int32 [{batch}], got {pos.dtype} {tuple(pos.shape)}")
    quant = pool_k.dtype == torch.int8
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("int8 pools, and only they, take k_scale and v_scale")
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (p_, kvh, page) or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be f32 {(p_, kvh, page)}")
    return p_, kvh, page, dh, table.shape[1]


def paged_attention(
    q: torch.Tensor,  # [B, T, H, Dh] (already rotary-embedded)
    pool_k: torch.Tensor,  # [P, KvH, page, Dh]
    pool_v: torch.Tensor,  # [P, KvH, page, Dh]
    table: torch.Tensor,  # [B, MAXP] int32
    pos: torch.Tensor,  # [B] int32
    k_scale: torch.Tensor | None = None,  # [P, KvH, page] f32 -> int8 pool
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grouped-query attention of ``q`` over the pages ``table`` names,
    causal to ``pos[b] + t``: ``[B, T, H, Dh]`` in q's dtype. Pages past a
    row's live length are neither read nor computed; a row whose table is
    all 0 reads the scratch page and yields finite garbage. The pool is
    ``[P, KvH, page, Dh]`` (see the module docstring), of q's dtype or int8
    with per-token per-head f32 scales that are applied inside.

    On CUDA tensors this launches ``csrc/paged_attention.cu`` (bf16 or f32
    q, ``Dh`` 64 or 128) and counts the launch in
    ``paged_attention.launches``; on CPU tensors it runs
    :func:`paged_attention_plain`."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, Dh], got {tuple(q.shape)}")
    b, t, h, dh = q.shape
    p_, kvh, page, pdh, maxp = _check_pool(pool_k, pool_v, k_scale, v_scale, table, pos, b)
    if pdh != dh or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not fit a pool {tuple(pool_k.shape)}")
    if pool_k.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"pool dtype {pool_k.dtype} must be q's ({q.dtype}) or int8")
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, table, pos, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or dh not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged_attention kernel takes bf16 or f32 q with Dh in {KERNEL_HEAD_DIMS}; "
            f"got {q.dtype}, Dh={dh}"
        )
    if b > 65535 or kvh > 65535:
        raise ValueError(f"paged_attention kernel takes B, KvH <= 65535; got {b}, {kvh}")
    scales = {} if k_scale is None else {"k_scale": k_scale, "v_scale": v_scale}
    _check_on(q.device, q=q, pool_k=pool_k, pool_v=pool_v, table=table, pos=pos, **scales)
    out = torch.empty_like(q)
    launch = _launcher("attention")
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(), pos.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            out.data_ptr(), b, t, h, kvh, dh, page, maxp,
            _KINDS[q.dtype], _KINDS[pool_k.dtype], 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed with CUDA error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_kv_write(
    pool_k: torch.Tensor,  # [P, KvH, page, Dh]
    pool_v: torch.Tensor,
    table: torch.Tensor,  # [B, MAXP] int32
    pos: torch.Tensor,  # [B] int32 — absolute position of token 0
    k_new: torch.Tensor,  # [B, T, KvH, Dh] in the pool dtype
    v_new: torch.Tensor,
    k_scale: torch.Tensor | None = None,  # [P, KvH, page] f32 (int8 pools)
    v_scale: torch.Tensor | None = None,
    ks_new: torch.Tensor | None = None,  # [B, T, KvH] f32
    vs_new: torch.Tensor | None = None,
):
    """Write T new KV entries per row into the page pool **in place**:
    token ``t`` of row ``b`` goes to
    ``pool[table[b, (pos[b]+t) // page], :, (pos[b]+t) % page, :]``.
    Positions at or past ``MAXP * page`` (padded prefill tails) go to the
    scratch page 0. int8 pools take values and scales that are already
    quantized. The pools are the caller's tensors, modified and returned:
    ``(pool_k, pool_v)`` or ``(pool_k, pool_v, k_scale, v_scale)``.

    On CUDA tensors this launches ``csrc/paged_kv_write.cu`` (a row of
    ``Dh`` values must be a multiple of 16 bytes) and counts the launch in
    ``paged_kv_write.launches``; on CPU tensors it runs
    :func:`paged_kv_write_plain`."""
    if k_new.dim() != 4 or v_new.shape != k_new.shape:
        raise ValueError("k_new and v_new must be [B, T, KvH, Dh]")
    b, t, nkv, ndh = k_new.shape
    p_, kvh, page, dh, maxp = _check_pool(pool_k, pool_v, k_scale, v_scale, table, pos, b)
    if (nkv, ndh) != (kvh, dh) or k_new.dtype != pool_k.dtype or v_new.dtype != pool_k.dtype:
        raise ValueError(
            f"new entries {k_new.dtype} {tuple(k_new.shape)} do not fit a pool "
            f"{pool_k.dtype} {tuple(pool_k.shape)}"
        )
    quant = k_scale is not None
    if quant:
        for name, sc in (("ks_new", ks_new), ("vs_new", vs_new)):
            if sc is None or tuple(sc.shape) != (b, t, kvh) or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be f32 {(b, t, kvh)}")
    if pool_k.device.type == "cpu":
        return paged_kv_write_plain(
            pool_k, pool_v, table, pos, k_new, v_new, k_scale, v_scale, ks_new, vs_new
        )
    if pool_k.device.type != "cuda":
        raise ValueError(f"paged_kv_write runs on cpu or cuda tensors, not {pool_k.device}")
    row_bytes = dh * pool_k.element_size()
    if row_bytes % 16 or b > 65535:
        raise ValueError(
            f"paged_kv_write kernel takes rows of a multiple of 16 bytes and B <= 65535; "
            f"got {row_bytes} bytes, B={b}"
        )
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    scales = {}
    if quant:
        ks_new, vs_new = ks_new.contiguous(), vs_new.contiguous()
        scales = {"k_scale": k_scale, "v_scale": v_scale, "ks_new": ks_new, "vs_new": vs_new}
    _check_on(pool_k.device, pool_k=pool_k, pool_v=pool_v, table=table, pos=pos,
              k_new=k_new, v_new=v_new, **scales)
    launch = _launcher("write")
    with torch.cuda.device(pool_k.device):
        rc = launch(
            pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(), pos.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(),
            *(sc.data_ptr() if quant else None for sc in (k_scale, v_scale, ks_new, vs_new)),
            b, t, kvh, row_bytes, page, maxp,
            torch.cuda.current_stream(pool_k.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_kv_write kernel launch failed with CUDA error {rc}")
    paged_kv_write.launches += 1
    if quant:
        return pool_k, pool_v, k_scale, v_scale
    return pool_k, pool_v


paged_kv_write.launches = 0
