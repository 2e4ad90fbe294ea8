"""The port's elastic world supervision (``train/elastic_world.py``) held to
the JAX package's ``tests/test_multislice.py`` supervisor pins on the CPU.

The same seeded world storm (slice 1 lost after round 3, back at round 6;
two slices of one process, ``sync_period=2``, outer Nesterov momentum)
runs through the JAX package's ``ElasticSupervisor`` and the port's,
generation by generation: the same timeline (a slice loss, a clean
reduced-world generation that regrows, a clean full generation), the same
final executions of every round (generation, slice, rows) and
exactly-once accounting, and final weights within 1e-6 (f32; the
products of the 4-wide regression sum in another order). A generation
that fails without a scheduled loss raises.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.testing import chaos as jchaos
from distributed_tensorflow_guide_tpu.train import elastic_world as jew
from distributed_tensorflow_guide_tpu_torch.testing import chaos as tchaos
from distributed_tensorflow_guide_tpu_torch.train import elastic_world as tew

TOTAL, BATCH = 8, 8
SPEC = dict(total_steps=TOTAL, ckpt_every=2, sync_period=2,
            global_batch=BATCH, dim=4, seed=3, outer_momentum=0.9,
            outer_lr=0.7)


def _storm(chaos):
    return chaos.FaultSchedule([chaos.Fault("slice_loss", 3, 1.0),
                                chaos.Fault("slice_return", 6, 1.0)])


def _final(records):
    """The executions that made the final state: for each round, its last
    generation's record of each slice (what the accounting verifies). A
    survivor's gloo collective fails fast on a dead peer, where the JAX
    package's blocks, so the port's survivor may retry the round once or
    twice inside the dying generation first: superseded records."""
    last = {}
    for r in records:
        key = (r["round"], r["slice"])
        if key not in last or r["gen"] >= last[key]["gen"]:
            last[key] = r
    top = {}
    for (rnd, _), r in last.items():
        top[rnd] = max(top.get(rnd, 0), r["gen"])
    return sorted((r["round"], r["slice"], r["gen"], r["lo"], r["hi"])
                  for r in last.values() if r["gen"] == top[r["round"]])


def test_slice_loss_and_return_equal_the_references(tmp_path):
    assert jax.default_backend() == "cpu"

    def run(name, ew, chaos):
        sched = _storm(chaos)
        # the port's supervisor goes to the card unless told otherwise
        on_cpu = {"device": "cpu"} if ew is tew else {}
        sup = ew.ElasticSupervisor(
            sched, n_slices=2, procs_per_slice=1,
            base_spec=ew.toy_spec(**SPEC),
            ckpt_dir=tmp_path / name / "ckpt",
            workdir=tmp_path / name / "work", timeout=150,
            failure_grace=2.0, **on_cpu)
        return sup.run(), sched

    # the two supervisors' process trees run side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(run, name, ew, chaos)
                   for name, ew, chaos in (("jax", jew, jchaos),
                                           ("port", tew, tchaos))}
        reports = {name: f.result() for name, f in futures.items()}
    for _, sched in reports.values():
        assert sched.world_events() == []
        assert {f.kind for f in sched.fired} == {"slice_loss",
                                                 "slice_return"}
    reports = {name: rep for name, (rep, _) in reports.items()}
    want, got = reports["jax"], reports["port"]
    assert [e["outcome"] for e in got.timeline] == [
        "slice_loss", "clean", "clean"]
    assert got.timeline == want.timeline
    assert got.timeline[1]["live"] == [0]
    assert got.timeline[1].get("returned") == [1]
    ok, problems = got.accounting(TOTAL, BATCH)
    assert ok, problems
    assert want.accounting(TOTAL, BATCH) == (ok, problems)
    assert _final(got.records) == _final(want.records)
    assert len(got.mttr_s) == 1 and got.mttr_s[0] > 0
    ws = [r.result["w"] for r in got.results]
    assert all(w == ws[0] for w in ws)  # every final worker agrees
    np.testing.assert_allclose(got.final_params, want.final_params,
                               rtol=0, atol=1e-6)


def test_supervisor_raises_on_unscheduled_failure(tmp_path):
    """A generation that dies without a scheduled slice loss is a real
    failure: the supervisor surfaces it instead of shrinking the world
    (a batch of 3 cannot split over two ranks, so every worker raises)."""
    sup = tew.ElasticSupervisor(
        tchaos.FaultSchedule([]), n_slices=2, procs_per_slice=1,
        base_spec=tew.toy_spec(total_steps=4, ckpt_every=2,
                               global_batch=3),
        ckpt_dir=tmp_path / "ckpt", workdir=tmp_path / "work",
        timeout=120, failure_grace=3.0, device="cpu")
    with pytest.raises(tew.ElasticWorldError, match="without a scheduled"):
        sup.run()


def test_workers_go_to_the_card_unless_asked_for_the_cpu(tmp_path,
                                                         monkeypatch):
    """The port's supervisor hands its workers no device by default, and a
    worker with none resolves this host's card: with no card it raises
    before it trains, where ``device="cpu"`` must be asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sup = tew.ElasticSupervisor(
        tchaos.FaultSchedule([]), n_slices=1,
        base_spec=tew.toy_spec(total_steps=4, ckpt_every=2),
        ckpt_dir=tmp_path / "ckpt", workdir=tmp_path / "work")
    assert sup.base_spec["device"] is None
    spec = dict(sup.base_spec, live_slices=[0], procs_per_slice=1,
                generation=0, stop_at=4, loss_events=[],
                ckpt_dir=str(tmp_path / "ckpt"),
                workdir=str(tmp_path / "work"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tew.elastic_toy_worker(spec)
