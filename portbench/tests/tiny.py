"""Tiny versions of the cells for the CPU tests: the same runners, mixes
and comparisons at widths a test run can hold, with limits set for these
sizes (a tiny model's rounding is not the full one's)."""

from __future__ import annotations

import time

import torch

from portbench import harness

CONFIGS = {
    "gpt2-124m": dict(n_layer=2, n_embd=64, n_head=2, d_ff=256,
                      n_positions=128, n_ctx=128, vocab_size=4000,
                      vocab_padded=4032),
    "resnet50": dict(stage_sizes=[1, 1, 1, 1], num_filters=8,
                     num_classes=10),
}
SERVE = dict(clients=4, slots=4, num_blocks=33, block_size=16,
             prefill_chunk=16, block=16, pool=256, warm_completions=4,
             sample_min_tokens=64, trace_seconds=0.2)
MIXES = {
    "imagenet_records_b256": dict(batch=8, records=16, stored=[40, 40, 3],
                                  crop=[32, 32], classes=10,
                                  loader_threads=2,
                                  optimizer={"name": "sgd", "lr": 0.01,
                                             "momentum": 0.9}),
    "lm_tokens_b12s1024": dict(batch=2, seq=64),
    "chat_closed64": dict(SERVE, prompt=dict(dist="lognormal", median=24,
                                             sigma=0.6, min=8, max=64),
                          output=dict(dist="uniform", min=8, max=16)),
    "rag_closed64": dict(SERVE, prompt=dict(dist="uniform", min=24, max=60),
                         output=dict(dist="uniform", min=2, max=8)),
}
# limits for these sizes, from their own sound runs and faults
LIMITS = {
    "resnet50_train_b256": {"loss_gap": 0.06, "grad_gap_median": 0.018,
                            "change_gap_median": 0.05, "change_gap": 0.5},
    "gpt2_train_b12s1024": {"loss_gap": 1e-3, "grad_gap": 4e-3,
                            "change_gap": 0.05},
    "gpt2_serve_chat64": {"logit_gap": 0.004},
    "gpt2_serve_rag64": {"logit_gap": 0.004},
}
CPU = torch.device("cpu")


def spec(cell: str) -> dict:
    s = harness.cell_spec(cell)
    s["config"].update(CONFIGS[s["cell"]["config"]])
    s["mix"].update(MIXES[s["cell"]["traffic"]])
    s["limits"] = dict(LIMITS[cell])
    return s


def seconds_for(cell: str) -> float:
    """A window long enough for the sample a serving check needs, also on
    a loaded CPU; training reads its numbers in set-up."""
    return 8.0 if "serve" in cell else 1.0


def run(cell: str, seed: int = 3, trace: bool = False) -> dict:
    """One run of the tiny cell on the CPU, past the look for a card."""
    harness.fix_environment()
    s = spec(cell)
    seconds = seconds_for(cell)
    return harness.runner(s["mix"]).run(
        s, seed=seed, seconds=seconds, trace=trace, dev=CPU,
        t_start=time.perf_counter())
