"""Operations and bytes of the hand-written attention kernels at the
shapes and lengths served, in closed form: each input byte read once and
each output byte written once, whatever a kernel reads again; operations
only for the (query, key) pairs the mask keeps. The same counts as the
kernel table of ``PERF.md`` (bound = max(bytes / 3.35 TB/s, operations /
989 TFLOP/s)).

K1 forward: reads Q, K, V; writes O and the f32 log-sum-exp. QK^T and PV:
4 hd FLOPs a kept pair.
K2 (dQ): reads Q, K, V, dO, the f32 LSE and delta; writes dQ. S = QK^T
recomputed, dP = dO V^T, dQ = dS K: 6 hd a pair.
K3 (dK, dV): reads the same; writes dK and dV. S, dP, dV = P^T dO,
dK = dS^T Q: 8 hd a pair.
K6 (paged decode attention): a row attends ``keys`` cached keys; reads
the K and V rows of its keys and the query, writes the output: 4 hd a
(row, key) pair.
"""

from __future__ import annotations

from portbench.cost.models import causal_pairs

F32 = 4


def _pairs(batch, heads, seq, causal=True) -> int:
    per = causal_pairs(seq) if causal else seq * seq
    return batch * heads * per


def flash_fwd(*, batch, heads, seq, head_dim, elem=2, causal=True) -> dict:
    act = batch * seq * heads * head_dim * elem
    return {"flops": 4 * head_dim * _pairs(batch, heads, seq, causal),
            "bytes": 4 * act + batch * heads * seq * F32}


def flash_dq(*, batch, heads, seq, head_dim, elem=2, causal=True) -> dict:
    act = batch * seq * heads * head_dim * elem
    rows = batch * heads * seq * F32
    return {"flops": 6 * head_dim * _pairs(batch, heads, seq, causal),
            "bytes": 5 * act + 2 * rows}


def flash_dkv(*, batch, heads, seq, head_dim, elem=2, causal=True) -> dict:
    act = batch * seq * heads * head_dim * elem
    rows = batch * heads * seq * F32
    return {"flops": 8 * head_dim * _pairs(batch, heads, seq, causal),
            "bytes": 6 * act + 2 * rows}


def paged_decode(*, heads, head_dim, keys: list, elem=2) -> dict:
    """One decode launch: one row a request, ``keys[i]`` keys for the
    i-th request served in it."""
    total = sum(keys)
    row = heads * head_dim * elem
    return {"flops": 4 * head_dim * heads * total,
            "bytes": 2 * total * row + 2 * len(keys) * row}


def paged_prefill(*, heads, head_dim, start: int, rows: int,
                  elem=2) -> dict:
    """One prefill chunk of ``rows`` valid rows at positions start ..
    start + rows - 1; each attends its position + 1 keys, and the chunk
    reads the start + rows keys once."""
    row = heads * head_dim * elem
    pairs = rows * start + causal_pairs(rows)
    return {"flops": 4 * head_dim * heads * pairs,
            "bytes": 2 * (start + rows) * row + 2 * rows * row}
