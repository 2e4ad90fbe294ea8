"""The port's cost auditor (analysis/cost.py + fingerprint.py): the
arithmetic on known programs, the kernel nodes' prices, liveness from the
census's allocation and free order, and every failure mode seen to FAIL:
a peak-live budget blown by a second cache copy, a closed form drifted
beyond its tolerance, a fingerprint changed without a bless, a stale
golden.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.analysis import (
    cost,
    fingerprint,
    lint,
    rules,
    walker,
)
from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
    CostPin,
    CostSpec,
    DonationSpec,
    ProgramContract,
)
from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(shape, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _lint_one(contract):
    report = lint.run_contracts([contract], "cpu")
    assert len(report.programs) == 1
    return report.programs[0]


def _cost_rule(program_report):
    return next(r for r in program_report.rules if r.rule == "cost")


def _vec(fn, *args, donated=frozenset()):
    _, census = walker.record(fn, args)
    return cost.census_cost(census, donated=donated), census


# ---- arithmetic on known programs ----------------------------------------------


def test_matmul_flops_and_fusion_boundary_bytes():
    """(8,16)@(16,4) f32: flops 2·m·k·n; HBM: factors read once, the
    output written once; peak: both inputs and the output together."""
    vec, _ = _vec(lambda x, w: x @ w, _t((8, 16)), _t((16, 4)))
    assert vec.flops == 2 * 8 * 16 * 4
    assert vec.hbm_bytes_read == (8 * 16 + 16 * 4) * 4
    assert vec.hbm_bytes_written == 8 * 4 * 4
    assert vec.peak_live_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4


def test_elementwise_chain_is_fusion_free():
    vec, _ = _vec(lambda x: torch.tanh(x * 2.0) + 1.0, _t((128,)))
    assert vec.flops == 0 and vec.hbm_bytes == 0


def test_a_loop_multiplies_its_body_cost():
    def fn(c):
        for _ in range(5):
            c = torch.tanh(c @ c)
        return c

    vec, _ = _vec(fn, _t((4, 4)))
    assert vec.flops == 5 * (2 * 4 * 4 * 4)


def test_a_widened_factor_is_read_at_its_narrow_origin():
    q = torch.from_numpy(
        np.random.RandomState(0).randint(-127, 128, (16, 8)).astype(np.int8))
    vec, census = _vec(lambda x, q: x @ q.float(), _t((4, 16)), q)
    assert vec.hbm_bytes_read == 4 * 16 * 4 + 16 * 8 * 1
    assert torch.int8 in census.origin.values()


def test_collective_bytes_come_from_the_comm_trace():
    mesh = single_device_mesh()
    vec, census = _vec(lambda x: cc.psum(x, "data", mesh=mesh), _t((8,)))
    assert walker.collective_census(census) == {"psum[data]": 1}
    # one rank: the ring moves nothing
    assert vec.quantity("collective_bytes[psum[data]]") == 0.0
    assert vec.quantity("collective_bytes[psum[dcn]]") == 0.0
    with pytest.raises(KeyError):
        vec.quantity("no_such_quantity")


# ---- the kernel nodes' prices ---------------------------------------------------


@pytest.mark.parametrize("dtype,C", [(torch.float32, 1),
                                     (torch.bfloat16, 1),
                                     (torch.bfloat16, 16)])
def test_k5_and_k6_nodes_price_at_decode_kernel_hbm_bytes(dtype, C):
    """Exactly the closed form: K5's (1,) int32 index and K6's block
    tables and lengths are metadata the closed form does not count."""
    B, H, S, hd, N, bs, n_blk = 2, 2, 64, 16, 10, 8, 4
    q = _t((B, C, H, hd), dtype)
    k, v = _t((B, H, S, hd), dtype, 1), _t((B, H, S, hd), dtype, 2)
    idx = torch.tensor([S - C], dtype=torch.int32)
    vec, census = _vec(DA.decode_attention, q, k, v, idx)
    want = DA.decode_kernel_hbm_bytes(b=B, h=H, s=S, d=hd, dtype=dtype,
                                      chunk=C, q_dtype=dtype)
    assert [n.kind for n in census.nodes] == ["kernel"]
    assert vec.hbm_bytes == want
    assert vec.flops == 4.0 * B * H * S * C * hd
    kp, vp = _t((N, H, bs, hd), dtype, 3), _t((N, H, bs, hd), dtype, 4)
    tables = torch.from_numpy(np.random.RandomState(5).randint(
        0, N, (B, n_blk)).astype(np.int32))
    lengths = torch.tensor([9, n_blk * bs], dtype=torch.int32)
    vec, census = _vec(
        lambda *a: DA.paged_decode_attention(*a, block_size=bs),
        q, kp, vp, tables, lengths)
    assert vec.hbm_bytes == DA.decode_kernel_hbm_bytes(
        b=B, h=H, s=n_blk * bs, d=hd, dtype=dtype, chunk=C, q_dtype=dtype)
    assert vec.flops == 4.0 * B * H * n_blk * bs * C * hd


def test_flash_nodes_take_the_fallback_byte_rule():
    from distributed_tensorflow_guide_tpu_torch.ops import flash_attention

    q, k, v = (_t((1, 128, 2, 16), seed=s) for s in range(3))
    vec, census = _vec(
        lambda q, k, v: flash_attention.flash_fwd(q, k, v, scale=0.25,
                                                  causal=True), q, k, v)
    [node] = census.nodes
    assert node.name == "flash_fwd"
    out, lse = (m.nbytes for m in node.outputs)
    assert vec.hbm_bytes_read == 3 * q.numel() * 4
    assert vec.hbm_bytes_written == out + lse
    assert vec.flops == 0.5 * 4 * 1 * 2 * 128 * 128 * 16


# ---- liveness ---------------------------------------------------------------------


def test_donated_and_used_input_dies_at_last_use():
    def fn(big, x):
        h = big.sum() + x  # big's last use
        return torch.cat([x] * 512) * h[:1]

    _, census = walker.record(fn, (_t((1024,)), _t((8,))))
    big = census.arg_sids[0][0]
    donated = cost.peak_live_bytes(census, donated_sids=frozenset({big}))
    undonated = cost.peak_live_bytes(census)
    assert undonated - donated == 1024 * 4


def test_dead_donation_stays_live():
    _, census = walker.record(lambda big, x: x * 2.0,
                              (_t((1024,)), _t((8,))))
    big = census.arg_sids[0][0]
    dead = cost.peak_live_bytes(census, donated_sids=frozenset({big}))
    assert dead == cost.peak_live_bytes(census) >= 1024 * 4


def test_a_temporary_dies_where_its_finalizer_runs():
    def fn(x):
        y = x * 2.0  # 4 KiB, dead after the sum
        s = y.sum()
        del y
        return torch.cat([s.expand(8)] * 4)

    vec, census = _vec(fn, _t((1024,)))
    assert vec.peak_live_bytes == 2 * 1024 * 4 + 4


# ---- failure modes: each with its finding ---------------------------------------


def _matmul_contract(name, cost_spec):
    def _build(device):
        return (lambda x, w: x @ w), (_t((8, 16)), _t((16, 4)))

    return ProgramContract(name=name, build=_build, collectives={},
                           cost=cost_spec)


def test_peak_live_over_budget_fails():
    rep = _lint_one(_matmul_contract(
        "viol_peak", CostSpec(max_peak_live_bytes=100)))
    assert not rep.ok
    [finding] = _cost_rule(rep).findings
    assert "peak live bytes" in finding.message
    assert finding.observed == (8 * 16 + 16 * 4 + 8 * 4) * 4


def test_a_second_cache_copy_fails_decode_steps_budget():
    [contract] = lint._registered(("decode_step",))
    assert _lint_one(contract).ok

    def build(device):
        fn, args = contract.build(device)
        cache = args[2]

        def hoarding(*a):
            extra = [t.clone() for layer in cache for t in layer.values()]
            out = fn(*a)
            del extra
            return out

        return hoarding, args

    import dataclasses

    rep = _lint_one(dataclasses.replace(contract, build=build))
    c = _cost_rule(rep)
    assert any("over the declared budget" in f.message for f in c.findings)
    assert c.observed["peak_live_bytes"] > contract.cost.max_peak_live_bytes


def test_byte_model_mismatch_beyond_tolerance_fails():
    rep = _lint_one(_matmul_contract(
        "viol_bytes", CostSpec(pins=(
            CostPin("hbm_bytes", 999_999.0, rel_tol=0.01,
                    note="deliberately wrong closed form"),))))
    [finding] = _cost_rule(rep).findings
    assert "hbm_bytes drifted from the closed-form model" in finding.message
    assert "deliberately wrong closed form" in finding.message
    assert finding.observed == (8 * 16 + 16 * 4 + 8 * 4) * 4


def test_exact_and_tolerant_pins_pass():
    rep = _lint_one(_matmul_contract(
        "ok_pins", CostSpec(pins=(
            CostPin("flops", 2 * 8 * 16 * 4),
            CostPin("hbm_bytes_written", lambda: 8 * 4 * 4),
            CostPin("flops", 2 * 8 * 16 * 4 * 1.05, rel_tol=0.1),),
            max_peak_live_bytes=4096)))
    assert rep.ok, [f.message for r in rep.rules for f in r.findings]


def test_shipped_pins_hold_their_closed_forms():
    """fused CE: 4 passes of the logit product, and the port's chunk
    traffic model (the JAX package's terms plus the one-hot scatter)."""
    [c] = lint._registered(("fused_ce_loss_grad",))
    pins = {p.quantity: p for p in c.cost.pins}
    assert pins["flops"].expect == 4 * 2.0 * 64 * 32 * 128
    terms = cost.closed_forms().fused_ce_trace_terms(64, 32, 128, 32)
    assert pins["hbm_bytes"].expect() == sum(terms.values())
    assert terms["onehot_scatter"] == 4 * 2 * 64 * (8 + 4)


def test_uninterpretable_census_with_pins_fails_without_pins_observes():
    class _Boom:
        def __getattr__(self, name):
            raise RuntimeError("not a census")

    traced = rules.TracedProgram(name="x", census=_Boom())
    observe = rules.rule_cost(traced, ProgramContract(
        name="x", build=lambda d: None))
    assert observe.ok and "error" in observe.observed
    pinned = rules.rule_cost(traced, ProgramContract(
        name="x", build=lambda d: None,
        cost=CostSpec(pins=(CostPin("flops", 1.0),))))
    assert not pinned.ok
    assert "cost interpreter failed" in pinned.findings[0].message


def test_donation_spec_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="alias"):
        DonationSpec(argnums=(0,), mode="steal")


# ---- fingerprints: the drift gate and the bless path -----------------------------


def _scaled(scale):
    return ProgramContract(
        name="fp_prog", collectives={},
        build=lambda d: ((lambda x: x * scale if scale != 3.0
                          else (x * 2.0) + x), (_t((4,)),)))


def test_fingerprint_drift_without_bless_then_bless(tmp_path):
    golden = tmp_path / "goldens.json"
    rep1 = lint.run_contracts([_scaled(2.0)])
    lint.bless_fingerprints(rep1, "initial", golden_path=golden)
    lint.check_fingerprints(rep1, full_registry=False, golden_path=golden)
    assert rep1.fingerprint_drift == [] and rep1.ok
    # another program under the same name: the structure hash moves
    rep2 = lint.run_contracts([_scaled(3.0)])
    lint.check_fingerprints(rep2, full_registry=False, golden_path=golden)
    assert not rep2.ok
    assert any("fp_prog" in line and "structure" in line
               for line in rep2.fingerprint_drift)
    lint.bless_fingerprints(rep2, "intentional change", golden_path=golden)
    assert fingerprint.load_goldens(golden)["fp_prog"]["reason"] == (
        "intentional change")
    rep3 = lint.run_contracts([_scaled(3.0)])
    lint.check_fingerprints(rep3, full_registry=False, golden_path=golden)
    assert rep3.fingerprint_drift == [] and rep3.ok


def test_cost_only_drift_is_caught(tmp_path):
    golden = tmp_path / "goldens.json"
    rep = lint.run_contracts([_matmul_contract("cv_prog", None)])
    lint.bless_fingerprints(rep, "initial", golden_path=golden)
    fp = rep.programs[0].fingerprint
    mutated = fingerprint.Fingerprint(
        program=fp.program, structure=fp.structure,
        cost=dict(fp.cost, flops=fp.cost["flops"] + 1))
    lines = fingerprint.diff_fingerprint(
        mutated, fingerprint.load_goldens(golden))
    assert lines and any("flops" in line for line in lines)


def test_bless_refuses_failing_registry(tmp_path):
    rep = lint.run_contracts([_matmul_contract(
        "viol_refuse", CostSpec(max_peak_live_bytes=1))])
    with pytest.raises(RuntimeError, match="refusing to bless"):
        lint.bless_fingerprints(rep, "nope", golden_path=tmp_path / "g.json")


def test_stale_golden_flagged_on_full_registry(tmp_path):
    golden = tmp_path / "goldens.json"
    live = _matmul_contract("live_prog", None)
    rep = lint.run_contracts([live])
    ghost = fingerprint.Fingerprint(program="ghost_prog",
                                    structure="0" * 64, cost={})
    fingerprint.save_goldens([rep.programs[0].fingerprint, ghost],
                             "adds ghost", path=golden)
    lint.check_fingerprints(rep, full_registry=True, golden_path=golden)
    assert any("ghost_prog" in line for line in rep.fingerprint_drift)
    rep2 = lint.run_contracts([live])
    lint.check_fingerprints(rep2, full_registry=False, golden_path=golden)
    assert rep2.fingerprint_drift == []


def test_shipped_goldens_match_registry_names():
    goldens = fingerprint.load_goldens()
    assert set(goldens) == {c.name for c in lint._registered(None)}
    assert all(g["reason"] for g in goldens.values())


def test_census_diff_names_the_ops_that_differ():
    _, a = walker.record(lambda x: x * 2.0, (_t((4,)),))
    _, b = walker.record(lambda x: (x * 2.0).sum(), (_t((4,)),))
    diff = fingerprint.census_diff(a, b)
    assert any(d.startswith("+ sum(") for d in diff)
    assert not any(d.startswith("-") for d in diff)
