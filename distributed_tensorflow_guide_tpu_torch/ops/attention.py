"""Blockwise (online-softmax) attention — the algebra under the flash
kernels, in plain PyTorch.

Process KV in blocks, carrying a running row-max ``m``, normaliser ``l``
and *unnormalised* output accumulator ``o``:

    m' = max(m, rowmax(s))        s = q k^T * scale  (+ mask)
    a  = exp(m - m')
    l' = l * a + rowsum(exp(s - m'))
    o' = o * a + exp(s - m') @ v

Normalising by ``l`` only at the end makes the update associative over
KV blocks. :func:`blockwise_attention` is what ``flash_attention`` falls
back to on shapes its block rule does not take, and :func:`dense_attention`
is the oracle of the parity tests. All shapes are (B, S, H, D).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-but-finite: keeps exp() exact zeros without NaNs


def block_update(q, k, v, m, l, o, *, scale: float, mask=None):
    """One online-softmax accumulation step over a KV block.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D); m, l: (B, H, Sq);
    o: (B, Sq, H, D) unnormalised. ``mask`` broadcasts to
    (B, H, Sq, Skv); True = attend.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    # a fully masked row has m_new == NEG_INF and s - m_new == 0 there:
    # force masked entries to 0 so the row's l stays 0
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def init_carry(q_shape, dtype=torch.float32, device=None):
    """(m, l, o) identities for the streaming softmax."""
    b, sq, h, d = q_shape
    m = torch.full((b, h, sq), NEG_INF, dtype=dtype, device=device)
    l = torch.zeros((b, h, sq), dtype=dtype, device=device)
    o = torch.zeros((b, sq, h, d), dtype=dtype, device=device)
    return m, l, o


def finalize(m, l, o):
    """Normalise the accumulator. Rows that attended nothing return 0."""
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return o / safe_l.transpose(1, 2)[..., None]


def blockwise_attention(q, k, v, *, causal: bool = False,
                        block_size: int = 512):
    """Full attention computed KV block by KV block (single device);
    numerically the dense softmax."""
    b, s, hn, d = q.shape
    scale = 1.0 / (d ** 0.5)
    if s % block_size:
        # equal blocks: the largest divisor of s that fits; only a
        # near-prime s (no divisor >= 16) degrades to one full block
        block_size = next(
            (n for n in range(min(block_size, s), 15, -1) if s % n == 0), s)
    qf, kf, vf = (x.float() for x in (q, k, v))
    m, l, o = init_carry(q.shape, device=q.device)
    q_pos = torch.arange(s, device=q.device)
    for j in range(-(-s // block_size)):
        sl = slice(j * block_size, (j + 1) * block_size)
        mask = None
        if causal:
            kv_pos = q_pos[sl]
            mask = (q_pos[:, None] >= kv_pos[None, :])[None, None]
        m, l, o = block_update(qf, kf[:, sl], vf[:, sl], m, l, o,
                               scale=scale, mask=mask)
    return finalize(m, l, o).to(q.dtype)


def dense_attention(q, k, v, *, causal: bool = False):
    """Plain softmax attention (the oracle of the parity tests)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
