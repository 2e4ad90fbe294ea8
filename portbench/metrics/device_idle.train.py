"""Device (H100): the share of the traced slice in which no operation
ran on the card, %. Moves ``train_step_ms``."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
