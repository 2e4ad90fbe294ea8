"""Kernels K6, split and chunk regimes (``ops/csrc/decode_attention.cu``):
their least time over their summed device time in the traced slice, %.
Each decode tick launches K6 once a layer over the tokens it serves (one
row a request, its prompt and tokens so far as keys), each prefill chunk
once a layer over its valid rows; least time a launch: max(bytes / 3.35
TB/s, operations / 989 TFLOP/s) (``cost/kernels.py``). Moves
``serve_tokens_per_s``."""

from portbench.cost import kernels, peaks

NAMES = ("decode_split", "decode_combine", "decode_chunk")


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    spent = sum(sec for name, (_, sec) in tr["kernels"].items()
                if any(k in name for k in NAMES))
    cfg = run["model"]
    heads, hd = cfg["n_head"], cfg["n_embd"] // cfg["n_head"]
    least = 0.0
    for keys in run["trace_decode_keys"]:
        c = kernels.paged_decode(heads=heads, head_dim=hd, keys=keys)
        least += peaks.least_seconds(c["flops"], c["bytes"])
    for start, rows in run["trace_prefill"]:
        c = kernels.paged_prefill(heads=heads, head_dim=hd, start=start,
                                  rows=rows)
        least += peaks.least_seconds(c["flops"], c["bytes"])
    least *= cfg["n_layer"]
    return 100.0 * least / spent if spent > 0 and least > 0 else None
