"""The whole step on the device: model FLOPs of the tokens the window
processed (each prefill chunk's valid rows, the LM head once a prompt,
and each decode-produced token, closed form over the lengths served, ``cost/models.py``) over the
window and the card's 989 TFLOP/s bf16 peak, %. Moves
``serve_tokens_per_s``."""

from portbench.cost import models, peaks


def read(run):
    if "window_decode_keys" not in run:
        return None
    cfg = run["model"]
    dims = {"layers": cfg["n_layer"], "d_model": cfg["n_embd"],
            "d_ff": cfg["d_ff"], "vocab": cfg["vocab_padded"]}
    flops = sum(models.gpt2_forward_token_flops(keys=k, **dims)
                for tick in run["window_decode_keys"] for k in tick)
    flops += sum(models.gpt2_prefill_chunk_flops(start=s, rows=r,
                                                 ends_prompt=last, **dims)
                 for s, r, last in run["window_prefill"])
    if flops <= 0:
        return None
    return 100.0 * flops / run["window_s"] / peaks.H100_BF16_FLOPS
