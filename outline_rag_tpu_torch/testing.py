"""Comparisons that hold a kernel to its plain version, and a tokenizer
that needs no files, shared by the tests and ``chip_smoke.py``. Nothing on
the serving or ingest path imports this."""

from __future__ import annotations

import torch

from outline_rag_tpu_torch.ops.topk import NEG


def tie_aware_mismatches(
    vals: torch.Tensor,  # [B, K]
    idx: torch.Tensor,  # [B, K]
    ref_vals: torch.Tensor,  # [B, K] or [B, K + 1]
    ref_idx: torch.Tensor,  # [B, K] or [B, K + 1]
    tol: float,
) -> int:
    """How many of the [B, K] slots disagree with a reference top list whose
    sums ran in another order: a value more than ``tol`` off, or a row that
    differs where rounding cannot have swapped it — a live reference value
    more than ``tol`` from both neighbours (the one past K is known when
    the reference has K + 1 columns, else the last slot is not held to its
    row) — or a dead slot that is not ``(NEG, 0)`` in both."""
    vals, idx = torch.as_tensor(vals).float(), torch.as_tensor(idx).long()
    ref_vals = torch.as_tensor(ref_vals).float().to(vals.device)
    ref_idx = torch.as_tensor(ref_idx).long().to(vals.device)
    k = vals.shape[1]
    bad = (vals - ref_vals[:, :k]).abs() > tol
    gap = ref_vals[:, :-1] - ref_vals[:, 1:]  # >= 0: sorted descending
    inf = torch.full_like(ref_vals[:, :1], float("inf"))
    left = torch.cat([inf, gap], dim=1)[:, :k] > tol
    right = torch.cat([gap, -inf], dim=1)[:, :k] > tol
    dead = ref_vals[:, :k] <= NEG / 2
    differs = idx != ref_idx[:, :k]
    bad |= differs & left & right & ~dead
    bad |= dead & (differs | (vals != NEG))
    return int(bad.sum())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at ``|x|`` (f32): 2^(e - 8) for
    ``|x| = m * 2^e`` with m in [0.5, 1); 0 at 0."""
    mag = x.float().abs()
    _, e = torch.frexp(mag)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8), torch.zeros_like(mag))


def flash_errors(out: torch.Tensor, plain: torch.Tensor, atol: float, ulps: float) -> dict:
    """``out`` (the kernel) against ``plain`` (its plain version):
    ``max_abs_err``; ``worst_vs_bound``, the largest ``|out - plain|``
    over its bound ``atol + ulps * _bf16_ulp(plain)`` (the check passes
    at <= 1); and ``rel_rms_err``, ``||out - plain|| / ||plain||``."""
    plain = plain.float()
    diff = (out.float() - plain).abs()
    bound = atol + ulps * _bf16_ulp(plain)
    return {
        "max_abs_err": float(diff.max()),
        "worst_vs_bound": float((diff / bound).max()),
        "rel_rms_err": float(diff.norm() / plain.norm().clamp_min(1e-30)),
    }


def scaled_errors(out: torch.Tensor, plain: torch.Tensor, tol: float = 1e-5) -> dict:
    """``out`` (a kernel) against ``plain`` (its plain version) where only
    the order of f32 sums may differ: ``max_abs_err``, and
    ``worst_vs_bound``, the largest ``|out - plain|`` over its bound
    ``tol * max|plain| + tol * |plain|`` (the check passes at <= 1)."""
    plain = plain.float()
    diff = (out.float() - plain).abs()
    bound = tol * plain.abs().max().clamp_min(1e-30) + tol * plain.abs()
    return {"max_abs_err": float(diff.max()), "worst_vs_bound": float((diff / bound).max())}


def quantizer_rows(dev, g: torch.Generator, m: int, k: int, dtype) -> torch.Tensor:
    """Seeded ``[m, k]`` rows for the row quantizer with the cases that break
    a careless one: row 0 all zero (the scale's floor), row 1 with a negative
    maximum, row 2 with a maximum of exactly 127 (scale 1) and values at
    exact .5 ties (``QUANTIZER_TIES`` must become ``QUANTIZER_TIE_CODES``:
    ties go to even), row 3 with a maximum of 3.25, where
    ``f32(3.25 / 127)`` is not ``f32(3.25 * f32(1 / 127))``."""
    x = torch.randn((m, k), generator=g, device=dev) * 3
    x[0] = 0
    if m > 3:
        x[1] = -x[1].abs()
        x[2] = x[2].clamp(-100, 100)
        x[2, :8] = torch.tensor(QUANTIZER_TIES, device=dev)
        x[3] = x[3].clamp(-3, 3)
        x[3, 0] = 3.25
    return x.to(dtype)


QUANTIZER_TIES = [127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -126.5]
QUANTIZER_TIE_CODES = [127, 2, 4, -2, 0, 0, 2, -126]


class ByteTokenizer:
    """A reversible tokenizer over UTF-8 bytes for driving the chat decoder
    where no tokenizer files exist: id ``b + 3`` for byte ``b``, ids 0-2
    reserved (pad, bos, eos). ``decode`` drops the reserved ids and maps
    ids past 258 onto printable ASCII, so the output of a model with a
    larger vocabulary (random weights included) decodes to text that never
    ends in a broken UTF-8 sequence."""

    pad_token_id, bos_token_id, eos_token_id = 0, 1, 2
    vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        data = bytes(i - 3 if i < 259 else 32 + (i - 259) % 95 for i in ids if i >= 3)
        return data.decode("utf-8", errors="replace")


def paged_attention_case(
    dev, g: torch.Generator, b: int, t: int, kv: str, *, heads: int = 32, kv_heads: int = 4,
    hd: int = 64, page: int = 128, maxp: int = 16, pages: int = 1025, pos=None,
    inactive_every: int = 0,
):
    """Seeded arguments of ``paged_attention`` (TinyLlama-1.1B's shape by
    default): bf16 q, a pool of ``pages`` pages that is bf16 (``kv="bf16"``)
    or int8 with f32 scales (``kv="int8"``), distinct scattered page ids per
    row (``b * maxp <= pages - 1``), ``pos`` given or drawn so that row
    lengths run from ``t`` to ``maxp * page - 1``. ``inactive_every=n`` makes
    rows 1, 1 + n, ... inactive (table all 0: they read the scratch page)."""
    q = torch.randn((b, t, heads, hd), generator=g, device=dev).to(torch.bfloat16)
    shape = (pages, kv_heads, page, hd)
    if kv == "int8":
        pools = [torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [(torch.rand(shape[:3], generator=g, device=dev) + 0.5) / 127 for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
        scales = []
    ids = torch.randperm(pages - 1, generator=g, device=dev)[: b * maxp] + 1
    table = ids.reshape(b, maxp).to(torch.int32)
    if pos is None:
        pos = torch.randint(0, maxp * page - t, (b,), generator=g, device=dev)
    pos = torch.as_tensor(pos, device=dev).to(torch.int32)
    if inactive_every:
        table[1::inactive_every] = 0
    return (q, *pools, table, pos, *scales)


# positions on either side of the paged kernel's 256-slot split boundaries,
# and the last slot of TinyLlama's 2,048-slot capacity
SPLIT_BOUNDARY_POSITIONS = (255, 256, 257, 511, 512, 2047)


def split_boundary_mismatches(fn, dev, g: torch.Generator, kv: str,
                              positions=SPLIT_BOUNDARY_POSITIONS) -> list[str]:
    """``fn`` (``paged_attention``) computes each of ``positions`` three
    ways on one seeded pool: row 0 of a B = 4, T = 64 chunk, alone (B = 1,
    T = 1), and beside three rows at other positions (B = 4, T = 1).
    Returns ``"<position> <way>"`` for each way whose output is not
    bit-equal to the chunk's: warm == cold prefix-cache admission rests on
    there being none."""
    q, pk, pv, table, pos, *scales = paged_attention_case(dev, g, 4, 64, kv)
    bad = []
    for p in positions:
        t0 = max(17 + p % 32, p - 1984)  # inside the chunk, whose end stays within 2,048
        start = pos.clone()
        start[0] = p - t0
        chunk = fn(q, pk, pv, table, start, *scales)[0, t0]
        q1 = q[:, t0 : t0 + 1].contiguous()
        alone = fn(q1[:1].contiguous(), pk, pv, table[:1].contiguous(), start[:1] + t0, *scales)
        beside = fn(q1, pk, pv, table, start + t0, *scales)
        for way, got in (("alone", alone[0, 0]), ("beside other rows", beside[0, 0])):
            if not torch.equal(got, chunk):
                bad.append(f"{p} {way}")
    return bad


def paged_order_case(dev, kv: str):
    """A row of 768 slots (three splits) whose fold is exact only in split
    order: q = 0, so every visible key has p = 1, and v is 2^30 in each
    element of split 0, -2^30 in split 1 and 1 in split 2 (int8 pool: codes
    64, -64, 1 with v-scales 2^24, 2^24, 1). In order the f32 sums are
    exact, 2^38 - 2^38 + 256, and every output element is bf16(256 / 768);
    folded in another order the 256 is lost against 2^38. Returns the
    arguments of ``paged_attention`` and that value."""
    g = torch.Generator(device=dev).manual_seed(3)
    args = list(paged_attention_case(dev, g, 1, 1, kv, pos=[767]))
    args[0].zero_()
    for i, value in enumerate((2.0**30, -(2.0**30), 1.0)):
        for page in args[3][0, 2 * i : 2 * i + 2].tolist():
            if kv == "int8":
                args[2][page] = (64, -64, 1)[i]
                args[6][page] = 2.0**24 if i < 2 else 1.0
            else:
                args[2][page] = value
    return tuple(args), float(torch.tensor(256.0 / 768.0).to(torch.bfloat16))
