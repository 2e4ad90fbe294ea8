"""The auditor's rules on a world of 8 gloo ranks (distributed_tensorflow_
guide_tpu_torch/analysis/world.py): the collectives rule's stray,
miscounted, ranged and census-only cases, a raw ``dist.all_reduce``
inside a step failing only the collectives rule as a bypass, the ring
model's collective bytes, and a rank that raises ending the world with
its traceback. The planted programs are ``tests/torch_mesh_planted.py``;
one world runs them all. Also the in-place update the train-step
contracts declare (``DonationSpec(mode="update")``) and the census's
frees on a communication thread, which need no world."""

import threading

import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.analysis import (
    cost,
    lint,
    walker,
    world,
)
from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
    DonationSpec,
    ProgramContract,
)
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from tests import torch_mesh_planted as planted

N = 8


@pytest.fixture(scope="module")
def reports():
    got = world.run_world(planted.lint_contracts(), N, "cpu",
                          providers=(planted.__name__,))
    return {r.name: r for r in got}


def _rule(report, name):
    return next(r for r in report.rules if r.rule == name)


def _failing(report) -> set:
    assert report.error is None, report.error
    return {r.rule for r in report.rules if not r.ok}


def test_stray_and_miscounted_collectives_fail_on_every_rank(reports):
    rep = reports["viol_stray_psum"]
    assert not rep.ok and len(rep.ranks) == N
    for rank in rep.ranks:
        assert _failing(rank) == {"collectives"}
        coll = _rule(rank, "collectives")
        assert coll.observed["census"] == {"psum[data]": 2, "pmax[data]": 1}
        msgs = [f.message for f in coll.findings]
        assert any("psum[data]: expected 1, traced 2" in m for m in msgs)
        assert any("undeclared collective pmax[data]" in m for m in msgs)


@pytest.mark.parametrize("name", ["ok_range", "ok_census"])
def test_range_and_census_only_modes_pass(reports, name):
    rep = reports[name]
    assert rep.ok, lint.render_text(lint.LintReport([rep]))
    assert [r.counts()["collectives"] for r in rep.ranks] == [
        {"psum[data]": 1}] * N


def test_a_raw_all_reduce_in_a_step_is_a_bypass_and_nothing_else(reports):
    rep = reports["viol_raw_all_reduce"]
    assert not rep.ok
    for rank in rep.ranks:
        assert _failing(rank) == {"collectives"}
        coll = _rule(rank, "collectives")
        assert coll.observed["bypassing_ops"] == 1
        # the trace never saw it: the census holds the psum alone
        assert coll.observed["census"] == {"psum[data]": 1}
        assert any("issued around collectives.py" in f.message
                   for f in coll.findings)


def test_collective_bytes_ring_model(reports):
    """One psum of a (64/N,) f32 shard prices at 2·P·(N−1)/N on every
    rank and as the world mean, keyed ``psum[data]``; an absent key
    (``psum[dcn]``) reads 0.0."""
    rep = reports["ring_model"]
    assert rep.ok, lint.render_text(lint.LintReport([rep]))
    want = 2.0 * (64 // N * 4) * (N - 1) / N
    assert want == 56.0
    for rank in rep.ranks:
        assert _rule(rank, "cost").observed["collective_bytes"] == {
            "psum[data]": want}
    world_rule = _rule(rep, "cost")
    assert world_rule.observed["collective_bytes_world_mean"] == {
        "psum[data]": want}
    vec = cost.CostVector(
        collective_bytes=world_rule.observed["collective_bytes_world_mean"])
    assert vec.quantity("collective_bytes[psum[data]]") == want
    assert vec.quantity("collective_bytes[psum[dcn]]") == 0.0


def test_a_rank_that_raises_fails_its_program_and_ends_the_world(reports):
    rep = reports["viol_rank_raises"]
    assert not rep.ok
    assert f"rank {planted.FAILING_RANK}:" in rep.error
    assert f"planted failure on rank {planted.FAILING_RANK}" in rep.error
    after = reports["after_the_failure"]
    assert not after.ok and after.ranks is None
    assert after.error == "not run: the world ended at viol_rank_raises"


def test_world_cost_rule_holds_pins_to_the_world_mean():
    from distributed_tensorflow_guide_tpu_torch.analysis import rules

    pin = {"quantity": "collective_bytes[ppermute[dcn]]", "expect": 4.0,
           "rel_tol": 0.0, "note": ""}
    sender = cost.CostVector(collective_bytes={"ppermute[dcn]": 8.0})
    receiver = cost.CostVector()
    mean = cost.world_mean([sender, receiver])
    assert mean.collective_bytes == {"ppermute[dcn]": 4.0}
    assert rules.rule_world_cost(mean, [[pin], [pin]]).ok
    bad = rules.rule_world_cost(cost.world_mean([sender, sender]),
                                [[pin], [pin]])
    assert [f.observed for f in bad.findings] == [8.0]
    split = rules.rule_world_cost(mean, [[pin], [{**pin, "expect": 5.0}]])
    assert "different numbers" in split.findings[0].message


# ---- no world: the update donation and frees on another thread -------------


def _sgd_state():
    torch.manual_seed(0)
    module = torch.nn.Linear(4, 3)
    return TrainState(module, torch.optim.SGD(module.parameters(), lr=0.1,
                                              momentum=0.9))


def _update_contract(name, step):
    return ProgramContract(
        name=name, collectives={},
        donation=DonationSpec(argnums=(0,), mode="update"),
        build=lambda device: (step, (_sgd_state(), torch.ones(2, 4))))


def test_update_donation_an_in_place_train_step_passes():
    def step(state, x):
        loss = state.model(x).sum()  # the bias add is no copy of the bias
        grads = dict(zip(["weight", "bias"], torch.autograd.grad(
            loss, list(state.model.parameters()))))
        return state.apply_gradients(grads)

    rep = lint.run_contracts([_update_contract("ok_update", step)])
    assert rep.ok, lint.render_text(rep)
    don = _rule(rep.programs[0], "donation")
    assert don.observed["donated_leaves"] == 2
    assert don.observed["moved_leaves"] == 0


def test_update_donation_a_replaced_or_unwritten_leaf_fails():
    def replaces(state, x):
        with torch.no_grad():
            state.model.weight.data = state.model.weight * 0.5
        return state

    def reads_only(state, x):
        return state.model(x).sum()

    moved = lint.run_contracts([_update_contract("viol_moved", replaces)])
    msgs = [f.message for f in _rule(moved.programs[0],
                                     "donation").findings]
    assert any("hold another buffer after the call" in m for m in msgs)
    ro = lint.run_contracts([_update_contract("viol_ro", reads_only)])
    assert _failing(ro.programs[0]) == {"donation"}
    assert any("never updated in place" in f.message
               for f in _rule(ro.programs[0], "donation").findings)


def test_a_train_state_argument_holds_its_parameters_and_moments():
    state = _sgd_state()
    assert len(walker.arg_leaves(state)) == 2
    loss = state.model(torch.ones(2, 4)).sum()
    loss.backward()
    state.optimizer.step()  # makes the momentum buffers
    leaves = walker.arg_leaves(state)
    assert len(leaves) == 4
    assert leaves[2] is state.optimizer.state[state.model.weight][
        "momentum_buffer"]


def test_a_buffer_freed_on_another_thread_dies_after_its_last_use():
    """A storage whose last reference a communication thread drops is
    freed at a moment of that thread's; the census puts its free after
    its last use, so the peak does not depend on the timing."""
    held = []

    def fn(x):
        y = x * 2.0  # allocated here, last used by the sum
        held.append(y)
        s = y.sum()
        del y
        t = threading.Thread(target=held.clear)
        t.start()
        t.join()
        return s + torch.ones(16).sum()

    _, census = walker.record(fn, (torch.ones(16),))
    [mul] = [n for n in census.nodes if n.name == "mul"]
    sid = mul.outputs[0].sid
    assert census.storages[sid].free == census.last_use()[sid] + 1
