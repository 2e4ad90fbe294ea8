"""GPT-2 served by the port's ``ServeEngine`` to a closed loop of clients.

Each of the mix's ``clients`` sends its next request the moment its last
one completes, so the load is fixed by the client count and the queue
never outgrows it (chat and completion APIs under a concurrency cap).
Requests come from the generator in sending order: prompt tokens drawn
uniformly from the vocabulary, lengths from the mix's distributions,
greedy decoding. The engine runs its captured decode and prefill-chunk
steps with the prefix cache off and the tuning table's defaults.

Set-up runs the loop until ``warm_completions`` requests have completed
(every captured step is built then, and the loop is in its steady state);
the window follows for ``--seconds``. Times are the host clock after the
tick that produced a token: each tick reads its tokens back, so the
device's work is done by then.

Once the window has closed and the program is freed, a sample drawn from
the seed of the requests completed in the window, the longest among them,
is run through the float32 reference: ``logit_gap`` is the widest gap by
which a served token's logit lies below the best at its position.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import numpy as np

from portbench import generator, harness
from portbench.runners import train_lm
from portbench.reference import compare, gpt2 as ref_gpt2, precision

RECORDER_CAPACITY = 1 << 22


class Clients:
    """The closed loop's bookkeeping: what each request was sent with,
    when, and when its tokens came."""

    def __init__(self, pool: list, submit):
        self.pool, self.submit = pool, submit
        self.next = 0
        self.sent: dict = {}      # rid -> send time
        self.prompt_len: dict = {}
        self.first: dict = {}     # rid -> first token time
        self.last: dict = {}      # rid -> last token time
        self.tokens: dict = {}    # rid -> tokens so far
        self.done: dict = {}      # rid -> completion time
        self.failed: set = set()

    def send(self, now: float) -> None:
        rid = self.next
        self.next += 1
        prompt, n_out = self.pool[rid % len(self.pool)]
        self.sent[rid] = now
        self.prompt_len[rid] = len(prompt)
        self.tokens[rid] = []
        self.submit(rid, prompt, n_out, now)

    def take(self, events, t: float, on_decode) -> int:
        """Record a tick's events at host time ``t``; completed requests
        are replaced by new ones; ``on_decode`` gets the keys attended by
        each token a decode step produced. Returns the tokens emitted."""
        n = 0
        for e in events:
            if e.status != "ok":
                self.failed.add(e.rid)
                self.done[e.rid] = t
                self.send(t)
                continue
            toks = self.tokens[e.rid]
            if toks:  # a decode step over the prompt and the tokens so far
                on_decode(self.prompt_len[e.rid] + len(toks))
            toks.append(e.token)
            n += 1
            if e.first:
                self.first[e.rid] = t
            self.last[e.rid] = t
            if e.done:
                self.done[e.rid] = t
                self.send(t)
        return n


def sample(clients: Clients, rids: list, seed: int, min_tokens: int) -> list:
    """Requests completed in the window, drawn from the seed: the longest
    first, then others until ``min_tokens`` served tokens are covered."""
    ok = [r for r in rids if r not in clients.failed]
    if not ok:
        return []
    longest = max(ok, key=lambda r: (clients.prompt_len[r]
                                     + len(clients.tokens[r]), -r))
    rest = [r for r in ok if r != longest]
    order = generator.rng(seed, 5).permutation(len(rest))
    picked, served = [longest], len(clients.tokens[longest])
    for i in order:
        if served >= min_tokens:
            break
        picked.append(rest[i])
        served += len(clients.tokens[rest[i]])
    return picked


def run(spec, *, seed, seconds, trace, dev, t_start, control=False):
    """One run of the cell. ``control``: also read the fp8 control on the
    same sampled requests (``portbench/control.py``)."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.obs.events import (
        FlightRecorder,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.scheduler import (
        Request,
    )

    cfg, mix = spec["config"], spec["mix"]
    t_load = time.perf_counter()
    model, specs = train_lm.load_model(cfg, seed, dev)
    rec = FlightRecorder(capacity=RECORDER_CAPACITY) if trace else None
    eng = ServeEngine(train_lm.transformer_config(cfg), model,
                      slots=int(mix["slots"]),
                      num_blocks=int(mix["num_blocks"]),
                      block_size=int(mix["block_size"]),
                      prefill_chunk=int(mix["prefill_chunk"]),
                      temperature=0.0, recorder=rec, device=dev)
    pool = generator.request_pool(mix, seed, cfg["vocab_size"])

    def submit(rid, prompt, n_out, now):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_out,
                           rng=np.zeros(2, np.uint32), arrival=now))

    clients = Clients(pool, submit)
    t0 = time.perf_counter()
    print("setup: " + json.dumps({
        "to_runner_s": t_load - t_start, "weights_engine_pool_s": t0 - t_load}),
        file=sys.stderr)
    ticks = 0

    def tick(launches=None):
        """One engine tick. ``launches`` gets each decode tick's list of
        the keys its served tokens attended."""
        nonlocal ticks
        events, kind = eng.step(now=time.perf_counter() - t0)
        ticks += 1
        t = time.perf_counter() - t0
        keys: list = []
        n = clients.take(events, t, keys.append)
        if launches is not None and kind == "decode":
            launches.append(keys)
        return kind, t, n

    for _ in range(int(mix["clients"])):
        clients.send(0.0)
    # set-up: the loop's first requests build every captured step
    while len(clients.done) < int(mix["warm_completions"]):
        tick()

    w0 = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    first_tick = ticks
    in_flight = clients.next - len(clients.done)
    emitted, tick_s = 0, {"decode": [], "prefill": [], "idle": []}
    win_keys: list = []
    t = w0
    while t - w0 < seconds:
        kind, t, n = tick(win_keys if trace else None)
        tick_s[kind].append(eng.last_tick_s)
        emitted += n
    w1 = t
    last_tick = ticks
    window_s = w1 - w0
    print("window: " + json.dumps({
        "s": window_s, "tokens": emitted, "ticks": {
            k: [len(v), 1e3 * sum(v) / max(len(v), 1)]
            for k, v in tick_s.items()},
        "outside_ms_a_tick": 1e3 * (window_s - sum(map(sum, tick_s.values())))
        / max(last_tick - first_tick, 1),
        "warm_s": w0, "sent": clients.next}), file=sys.stderr)

    run_data = {"window_s": window_s, "ticks": last_tick - first_tick,
                "tick_s": {k: sum(v) for k, v in tick_s.items()},
                "tick_n": {k: len(v) for k, v in tick_s.items()},
                "slots": int(mix["slots"]), "model": cfg}
    breakdown = None
    if trace:
        keys: list = []
        slice_first = ticks
        with harness.TraceSlice(dev) as sl:
            ts = time.perf_counter()
            while time.perf_counter() - ts < float(mix["trace_seconds"]):
                tick(keys)
        run_data["trace"] = sl.reduce()
        chunk = int(mix["prefill_chunk"])
        prefill, fill = [], []
        for e in rec.events():
            if e.kind == "prefill.launch":
                start = e.payload["chunk"] * chunk
                left = clients.prompt_len[e.payload["rid"]] - start
                prefill.append((e.payload["tick"], start, min(chunk, left),
                                left <= chunk))
            elif (e.kind == "decode.launch"
                  and first_tick <= e.payload["tick"] < last_tick):
                fill.append(len(e.payload["slots"]))
        run_data["decode_fill"] = fill
        run_data["window_prefill"] = [
            (s, r, last) for tk, s, r, last in prefill
            if first_tick <= tk < last_tick]
        run_data["window_decode_keys"] = win_keys
        run_data["trace_prefill"] = [
            (s, r) for tk, s, r, _ in prefill if tk >= slice_first]
        run_data["trace_decode_keys"] = keys
        if run_data["trace"]:
            breakdown = {"device_ops": run_data["trace"]["device_ops"],
                         "idle_gaps": run_data["trace"]["idle_gaps"]}

    # the window's numbers, from the clients' side
    ttft = [clients.first[r] - clients.sent[r] for r in clients.first
            if w0 <= clients.first[r] <= w1]
    done_in = [r for r, t in clients.done.items() if w0 <= t <= w1]
    tpot = [(clients.last[r] - clients.first[r])
            / (len(clients.tokens[r]) - 1)
            for r in done_in if r not in clients.failed
            and len(clients.tokens[r]) > 1]
    attempted = in_flight + sum(1 for r, s in clients.sent.items()
                                if w0 <= s <= w1)
    failed = sum(1 for r in clients.failed if w0 <= clients.done[r] <= w1)

    device = harness.device_info(dev, 1)
    if trace and run_data.get("trace"):
        device["busy_s"] = run_data["trace"]["busy_s"]
        device["window_s"] = run_data["trace"]["window_s"]
    picked = sample(clients, done_in, seed, int(mix["sample_min_tokens"]))
    seqs = [(clients.pool[r % len(clients.pool)][0], clients.tokens[r])
            for r in picked]
    eng.close()
    eng = model = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gap = reference_gap(cfg, specs, seed, dev, seqs)
    checks = [{"name": "logit_gap", "value": gap,
               "limit": spec["limits"]["logit_gap"]},
              {"name": "served_tokens_compared",
               "value": sum(len(s[1]) for s in seqs),
               "limit": int(mix["sample_min_tokens"])}]
    correct = (bool(seqs) and math.isfinite(gap)
               and gap <= checks[0]["limit"]
               and checks[1]["value"] >= checks[1]["limit"])
    e2e = {"setup_s": {"value": setup_s, "unit": "s"},
           "serve_tokens_per_s": {"value": emitted / window_s,
                                  "unit": "tokens/s"}}
    if ttft:
        e2e["ttft_p95_ms"] = {"value": 1e3 * harness.percentile(ttft, 95),
                              "unit": "ms"}
    if tpot:
        e2e["tpot_p95_ms"] = {"value": 1e3 * harness.percentile(tpot, 95),
                              "unit": "ms"}
    run_data["emitted"] = emitted
    if control:
        run_data["control_logit_gap"] = reference_gap(
            cfg, specs, seed, dev, seqs, fp8_control=True)
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "end_to_end": e2e, "run": run_data, "device": device,
            "breakdown": breakdown, "checks": checks}


def reference_gap(cfg, specs, seed, dev, seqs, fp8_control=False) -> float:
    """The widest gap of a served token below the reference's best, over
    ``seqs`` (prompt, served tokens); with ``fp8_control`` the control's
    reading instead: the gap of the token the fp8 reference puts first."""
    import torch

    gap = -math.inf
    with precision.float32_exact(), torch.no_grad():
        w = harness.seeded_weights(specs, seed, dev)
        for prompt, toks in seqs:
            seq = torch.as_tensor(np.concatenate([prompt, np.asarray(
                toks, np.int64)]), device=dev)[None]
            logits = ref_gpt2.forward(w, seq, layers=cfg["n_layer"],
                                      heads=cfg["n_head"])[0]
            if fp8_control:
                low = ref_gpt2.forward(w, seq, layers=cfg["n_layer"],
                                       heads=cfg["n_head"], fp8=True)[0]
                g = compare.control_gap(logits, low, len(prompt), len(toks))
            else:
                g = compare.served_gap(logits, len(prompt), toks)
            gap = max(gap, g)
    return gap
