"""Host scheduler: the mean number of slots in a decode launch of the
window (the engine's ``decode.launch`` events) over the slots, %. Moves
``serve_tokens_per_s``."""


def read(run):
    fill = run.get("decode_fill")
    if not fill:
        return None
    return 100.0 * sum(fill) / len(fill) / run["slots"]
