"""The port's 10 mesh programs (ROADMAP item 16c) on a world of 8 gloo
ranks: one ``lint --world 8 --device cpu --json`` run of the whole
registry (22 programs), every mesh program clean on every rank with no
bypass, its censuses derived from the port's code, its
``collective_bytes`` pins equal to the closed forms as world means, and
those bytes held to the JAX package's auditor on the same fixtures (8
fake devices, in this process), each gap stated term by term.

The census counts executed calls, one a tree; the JAX census counts
sites, one a leaf: the counts below are the port's own, never the JAX
contract's numbers. Bytes are the invariant the two share.
"""

import contextlib
import io
import json

import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.analysis import cost, lint

N = 8
MESH_PROGRAMS = (
    "dp_train_step", "dp_overlap_train_step", "dp_overlap_int8_round",
    "fsdp_prefetch_train_step", "pipeline_fused_ce_train_step",
    "multislice_outer_on_round", "multislice_outer_off_round",
    "serve_kv_block_transfer_dcn", "moe_train_step",
    "moe_dropless_train_step",
)
#: every rank's collective census, derived from the port's code (the
#: contracts' comments say which call is which)
CENSUS = {
    "dp_train_step": {"psum[data]": 2},
    "dp_overlap_train_step": {"psum[data]": 5},
    "dp_overlap_int8_round": {"psum[data]": 5, "pmax[data]": 4},
    "fsdp_prefetch_train_step": {"all_gather[data]": 2,
                                 "reduce_scatter[data]": 2,
                                 "psum[data]": 4},
    "pipeline_fused_ce_train_step": {"ppermute[pipe]": 4, "psum[pipe]": 2,
                                     "psum[data]": 2},
    "multislice_outer_on_round": {"psum[data]": 2, "psum[dcn]": 2,
                                  "psum[dcn,data]": 1},
    "multislice_outer_off_round": {"psum[data]": 3},
    "serve_kv_block_transfer_dcn": {"ppermute[dcn]": 1},
    "moe_train_step": {"all_to_all[expert]": 8, "psum[data,expert]": 9,
                       "psum[data]": 1},
    "moe_dropless_train_step": {"all_to_all[expert]": 8,
                                "psum[data,expert]": 9, "psum[data]": 1},
}


def _closed_form_bytes() -> dict:
    """Each pinned key's bytes at the 8-rank fixtures, from the closed
    forms (``analysis/cost.closed_forms``)."""
    cf = cost.closed_forms()
    ar = cf.dp_allreduce_bytes
    G = 4288  # the tiny MLP's gradient bytes
    dp = ar(G, N) + 2 * ar(4, N)
    a2a = cf.moe_all_to_all_bytes  # B = E · C · d · 4, C = 4 (Switch) / 8
    return {
        "dp_train_step": {"psum[data]": dp},
        "dp_overlap_train_step": {"psum[data]": dp},
        "dp_overlap_int8_round": {"psum[data]": ar(G, N, "int8")
                                  + 2 * ar(4, N),
                                  "pmax[data]": 4 * ar(4, N)},
        "fsdp_prefetch_train_step": {
            "all_gather[data]": cf.fsdp_comm_terms(4096, N, 192)[
                "param_all_gather"],
            "reduce_scatter[data]": cf.fsdp_comm_terms(4096, N, 192)[
                "grad_reduce_scatter"],
            "psum[data]": cf.fsdp_comm_terms(4096, N, 192)[
                "replicated_grad_allreduce"] + 2 * ar(4, N)},
        "pipeline_fused_ce_train_step": {
            "ppermute[pipe]": cf.pipeline_ppermute_bytes(1 * 32 * 16 * 4,
                                                         2, 2)},
        "multislice_outer_on_round": {
            "psum[dcn]": cf.outer_sync_bytes(2 * G, 2),
            "psum[data]": 2 * ar(G, N // 2),
            "psum[dcn,data]": ar(4, N)},
        "multislice_outer_off_round": {
            "psum[dcn]": 0.0,
            "psum[data]": 2 * ar(G, N // 2) + ar(4, N // 2)},
        "serve_kv_block_transfer_dcn": {
            "ppermute[dcn]": cf.kv_migration_bytes(
                4, 2, 2, 8, 8, activation_dtype_bytes=4) / 2},
        "moe_train_step": {"all_to_all[expert]": a2a(4 * 4 * 16 * 4, 4,
                                                     n_layers=2)},
        "moe_dropless_train_step": {"all_to_all[expert]": a2a(
            4 * 8 * 16 * 4, 4, n_layers=2)},
    }


@pytest.fixture(scope="module")
def cli():
    """One world: ``lint --device cpu --world 8 --json`` over the whole
    registry. Returns (exit code, the JSON report by program)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lint.main(["--device", "cpu", "--world", str(N), "--json"])
    report = json.loads(out.getvalue().splitlines()[-1])
    return rc, report, {p["name"]: p for p in report["programs"]}


def _rule(d, name):
    return next(r for r in d["rules"] if r["rule"] == name)


def test_cli_world_8_exits_0_with_no_finding_and_no_drift(cli):
    rc, report, _ = cli
    assert rc == 0
    assert report["ok"] and report["n_programs"] == 22
    assert report["n_findings"] == 0 and report["fingerprint_drift"] == []


def test_registry_holds_22_distinct_programs():
    names = [c.name for c in lint._registered(None)]
    assert len(names) == len(set(names)) == 22
    mesh = [c.name for c in lint._registered(None) if c.world is not None]
    assert mesh == list(MESH_PROGRAMS)
    assert {c.world for c in lint._registered(MESH_PROGRAMS)} == {N}


@pytest.mark.parametrize("name", MESH_PROGRAMS)
def test_mesh_program_is_clean_on_every_rank(cli, name):
    p = cli[2][name]
    assert p["ok"] and p["error"] is None
    assert len(p["ranks"]) == N
    for rank in p["ranks"]:
        assert rank["ok"], rank
        coll = _rule(rank, "collectives")
        assert coll["observed"]["bypassing_ops"] == 0
        assert coll["observed"]["census"] == CENSUS[name]
        assert rank["counts"]["collectives"] == CENSUS[name]


@pytest.mark.parametrize("name", MESH_PROGRAMS)
def test_byte_pins_equal_the_closed_forms_as_world_means(cli, name):
    p = cli[2][name]
    mean = _rule(p, "cost")["observed"]["collective_bytes_world_mean"]
    want = _closed_form_bytes()[name]
    [contract] = lint._registered((name,))
    pinned = {q.quantity[len("collective_bytes["):-1]
              for q in contract.cost.pins
              if q.quantity.startswith("collective_bytes[")}
    assert pinned == set(want)
    assert {k: mean.get(k, 0.0) for k in want} == want
    # every rank evaluated each pin's closed form to the number above
    for rank in p["ranks"]:
        for pin in _rule(rank, "cost")["observed"]["world_pins"]:
            key = pin["quantity"][len("collective_bytes["):-1]
            assert pin["expect"] == want[key]


def test_outer_off_moves_nothing_over_dcn(cli):
    p = cli[2]["multislice_outer_off_round"]
    for rank in p["ranks"]:
        assert not any("dcn" in k for k in rank["counts"]["collectives"])
        assert "psum[dcn]" not in _rule(rank, "cost")["observed"][
            "collective_bytes"]
    assert "psum[dcn]" not in _rule(p, "cost")["observed"][
        "collective_bytes_world_mean"]


def test_kv_transfer_is_one_hop_from_the_sending_slice(cli):
    """Slices are contiguous blocks of 4 ranks: the first sends P, the
    second receives and records 0, so the world mean is P / 2."""
    p = cli[2]["serve_kv_block_transfer_dcn"]
    per_rank = [_rule(r, "cost")["observed"]["collective_bytes"].get(
        "ppermute[dcn]", 0.0) for r in p["ranks"]]
    P = 4 * 2 * 2 * 2 * 8 * 8 * 4
    assert per_rank == [P] * 4 + [0.0] * 4


def test_pipeline_stages_and_the_first_stage_role(cli):
    """The pin is ``pipe_wire_bytes_per_step / P``, equal at v = 1 to the
    closed form; the first stage runs no head, so its contract admits no
    f32 tensor with a vocab last dim at any row count."""
    [c] = lint._registered(("pipeline_fused_ce_train_step",))
    assert c.for_rank(0).vocab_rows == 1 and c.for_rank(1).vocab_rows == 17
    ranks = cli[2]["pipeline_fused_ce_train_step"]["ranks"]
    first, last = ranks[0]["counts"]["ops"], ranks[1]["counts"]["ops"]
    assert first < last  # the last stage runs the head and the loss
    assert [r["counts"]["ops"] for r in ranks] == [first, last] * 4
    for r in ranks:
        assert _rule(r, "memory")["observed"]["vocab_materialized_elems"] \
            == 0


def test_flops_pin_is_a_ranks_products():
    [c] = lint._registered(("dp_train_step",))
    [pin] = [p for p in c.cost.pins if p.quantity == "flops"]
    assert pin.expect() == 5 * 2.0 * 8 * 16 * 32  # one process: 8 rows


# ---- against the JAX package's auditor ------------------------------------------


@pytest.fixture(scope="module")
def reference_bytes():
    """The JAX package's observed collective bytes a device, on the 8 fake
    CPU devices of tests/conftest.py."""
    from distributed_tensorflow_guide_tpu.analysis import lint as ref_lint

    out = {}
    for c in ref_lint._registered(MESH_PROGRAMS):
        rep = ref_lint.lint_contract(c)
        out[c.name] = next(r.observed for r in rep.rules
                           if r.rule == "cost")["collective_bytes"]
    return out


def test_bytes_against_the_jax_package_auditor(cli, reference_bytes):
    """Equal key for key, except where the two programs move other bytes,
    stated term by term:

    * pipeline: the JAX schedule rotates its ring on every tick, the
      P − 1 bubble ticks included, (M + P − 1)/M times the useful
      hand-offs the port sends;
    * MoE: under ``shard_map(check_vma=False)`` JAX transposes each
      forward ``psum`` the loss depends on into a backward ``psum``
      (ROADMAP Queue 3): per layer the router-probability fraction
      (E scalars) and the z loss (1), and the NLL sum (1), L·(E + 1) + 1 =
      11 f32 scalars at 2·4·(n−1)/n each; the port's ``tp_allreduce``
      passes the cotangent through.

    ``dp_train_step``'s traced ``psum[data]`` ×6 against the contract's 3
    is a count of sites; its bytes equal the port's (and the closed
    form's) exactly.
    """
    ar = cost.dp_allreduce_bytes
    M, P, L, E = 2, 2, 2, 4
    for name in MESH_PROGRAMS:
        port = _rule(cli[2][name], "cost")["observed"][
            "collective_bytes_world_mean"]
        ref = dict(reference_bytes[name])
        if name == "pipeline_fused_ce_train_step":
            assert ref.pop("ppermute[pipe]") == (
                port.pop("ppermute[pipe]") * (M + P - 1) / M)
        if name.startswith("moe_"):
            assert ref.pop("psum[data,expert]") == (
                port.pop("psum[data,expert]") + (L * (E + 1) + 1)
                * ar(4, N))
        assert port == ref, name
    assert reference_bytes["dp_train_step"]["psum[data]"] == \
        _closed_form_bytes()["dp_train_step"]["psum[data]"]


def test_kv_migration_closed_form_is_the_pools_bytes():
    """``closed_forms().kv_migration_bytes`` reads the geometry;
    ``serve/paged_cache.kv_migration_bytes`` reads it off a config: the
    same bytes, the int8 scale rows (one a position and head) included."""
    from distributed_tensorflow_guide_tpu_torch.analysis.fixtures import (
        tiny_lm_cfg,
    )
    from distributed_tensorflow_guide_tpu_torch.serve import paged_cache

    cf = cost.closed_forms()
    for kv_dtype, dtype in ((None, torch.float32), (None, torch.bfloat16),
                            ("int8", torch.bfloat16)):
        cfg = tiny_lm_cfg(dtype=dtype, kv_dtype=kv_dtype)
        item = torch.empty((), dtype=dtype).element_size()
        assert cf.kv_migration_bytes(
            4, cfg.num_layers, cfg.num_heads, 8, cfg.head_dim, kv_dtype,
            activation_dtype_bytes=item) == paged_cache.kv_migration_bytes(
                4, cfg, 8)
