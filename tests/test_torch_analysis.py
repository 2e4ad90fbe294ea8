"""The port's program auditor (distributed_tensorflow_guide_tpu_torch/
analysis/): the census, the five rule families each with a planted
violation that fails exactly its own rule and passes once allowed, the
registry and the CLI, and the 12 registered programs held against the
JAX package's auditor on the same fixtures.

A linter that has never been seen to FAIL is not evidence of anything:
each planted program breaks one rule, and the assertion is on that rule's
finding, with every other rule clean.
"""

import json

import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.analysis import (
    fixtures,
    lint,
    walker,
)
from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
    DonationSpec,
    ProgramContract,
    registered_contracts,
)
from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA

PROGRAMS = (
    "serve_decode_step", "serve_decode_step_lora", "serve_decode_step_moe",
    "serve_decode_step_wq8", "serve_decode_step_wqfp8",
    "serve_decode_step_moe_wq8", "serve_prefill_chunk_step",
    "serve_prefill_chunk_step_moe", "decode_step", "decode_spec_step",
    "fused_ce_loss_grad", "fp8_ste_matmul_grad",
)


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


def _rule(program_report, name):
    return next(r for r in program_report.rules if r.rule == name)


def _failing(program_report) -> set:
    assert program_report.error is None, program_report.error
    return {r.rule for r in program_report.rules if not r.ok}


# ---- the census ---------------------------------------------------------------


def test_an_op_in_a_loop_counts_each_time_it_runs():
    w = _t((4, 4))

    def f(x, w):
        for _ in range(3):
            x = x @ w
        return x

    _, census = walker.record(f, (_t((2, 4), seed=1), w))
    assert walker.primitive_census(census)["mm"] == 3


def test_a_backward_inside_the_program_is_recorded():
    x = _t((3, 8)).requires_grad_()
    w = _t((8, 5), seed=1).requires_grad_()

    def f(x, w):
        return torch.autograd.grad((x @ w).sum(), (x, w))

    _, census = walker.record(f, (x, w))
    # one forward product, and dx and dW in the backward
    assert walker.primitive_census(census)["mm"] == 3


def _k5_operands(C=4):
    B, H, S, hd = 2, 2, 32, 8
    q = _t((B, C, H, hd))
    k, v = _t((B, H, S, hd), seed=1), _t((B, H, S, hd), seed=2)
    return q, k, v, torch.tensor([S - C], dtype=torch.int32)


def _k6_operands(C=1):
    B, H, N, bs, hd, n_blk = 3, 2, 6, 8, 8, 4
    q = _t((B, C, H, hd))
    kp, vp = _t((N, H, bs, hd), seed=1), _t((N, H, bs, hd), seed=2)
    tables = torch.from_numpy(
        np.random.RandomState(3).randint(0, N, (B, n_blk)).astype(np.int32))
    lengths = torch.tensor([5, 17, 30], dtype=torch.int32)
    return (q, kp, vp, tables, lengths), bs


def test_a_kernel_node_hides_its_plain_version():
    q, k, v, idx = _k5_operands()
    _, plain = walker.record(DA.decode_attention_plain, (q, k, v, idx))
    _, kernel = walker.record(DA.decode_attention, (q, k, v, idx))
    # the plain version is dozens of ops; through the wrapper it is one
    # kernel node, with the wrapper's operands and output
    assert len(plain.nodes) > 10
    [node] = kernel.nodes
    assert (node.kind, node.name, node.regime) == (
        "kernel", "decode_attention", "split")
    assert [m.shape for m in node.inputs] == [
        tuple(t.shape) for t in (q, k, v, idx)]
    assert node.outputs[0].shape == tuple(q.shape)
    ops, tables = _k6_operands()
    _, paged = walker.record(
        lambda *a: DA.paged_decode_attention(*a, block_size=tables), ops)
    assert [(n.kind, n.name) for n in paged.nodes] == [
        ("kernel", "paged_decode_attention")]
    assert paged.nodes[0].attrs["s"] == 4 * tables


def test_traced_text_normalizes_and_is_stable():
    def f(x):
        return x + 1.0

    a = walker.traced_text(f, _t((2,)))
    assert "add" in a and a == walker.traced_text(f, _t((2,), seed=5))
    assert "0x" not in a.replace("0x•", "")


# ---- the planted violations: one rule each ------------------------------------


def _naive_ce(allow: bool):
    N, D, V = 32, 16, 128

    def _build(device):
        t = torch.from_numpy(np.random.RandomState(0).randint(0, V, N))

        def naive_ce(x, w):
            logits = x @ w  # the (N, V) f32 tensor fused CE never holds
            lse = torch.logsumexp(logits, dim=-1)
            return (lse - logits[torch.arange(N), t]).mean()

        return naive_ce, (_t((N, D)), _t((D, V), seed=1))

    return ProgramContract(
        name="viol_naive_ce", build=_build, vocab_dim=V, vocab_rows=2,
        max_vocab_f32_elems=N * V if allow else 0, collectives={})


def test_violation_memory_naive_full_logits_ce():
    rep = _lint_one(_naive_ce(allow=False))
    assert _failing(rep) == {"memory"}
    mem = _rule(rep, "memory")
    assert mem.observed["vocab_materialized_elems"] >= 32 * 128
    assert any("logits-shaped" in f.message for f in mem.findings)
    assert _lint_one(_naive_ce(allow=True)).ok


def test_violation_precision_f32_product_under_bf16():
    def _build(device):
        return (lambda x, w: (x @ w).sum()), (_t((64, 64)),
                                              _t((64, 64), seed=1))

    bad = _lint_one(ProgramContract(name="viol_f32_matmul", build=_build,
                                    policy="bf16", collectives={}))
    assert _failing(bad) == {"precision"}
    prec = _rule(bad, "precision")
    assert prec.observed["bad_operand_matmuls"] == 1
    assert any("compute dtype" in f.message for f in prec.findings)
    assert _lint_one(ProgramContract(name="ok_f32_matmul", build=_build,
                                     policy="f32", collectives={})).ok


def test_precision_widened_bf16_factors_are_a_bf16_product():
    """The CPU's spelling of a bf16 product with f32 sums (both factors
    widened from bf16) passes under bf16; one widened factor against an
    f32 one is an f32 product and does not."""
    def build(both):
        def _build(device):
            a, b = _t((8, 64), torch.bfloat16), _t((64, 8), torch.bfloat16)
            if both:
                return (lambda a, b: a.float() @ b.float()), (a, b)
            return (lambda a, b: a.float() @ b), (a, b.float())
        return _build

    assert _lint_one(ProgramContract(name="ok_widened", build=build(True),
                                     policy="bf16", collectives={})).ok
    mixed = _lint_one(ProgramContract(name="viol_mixed", build=build(False),
                                      policy="bf16", collectives={}))
    assert _failing(mixed) == {"precision"}


def _sum(accum_f32: bool):
    def _build(device):
        x = _t((128,), torch.bfloat16)
        if accum_f32:
            return (lambda x: x.sum(dtype=torch.float32)), (x,)
        return (lambda x: x.sum()), (x,)
    return _build


def test_violation_precision_bf16_sum_over_64_elements():
    bad = _lint_one(ProgramContract(name="viol_bf16_sum", build=_sum(False),
                                    policy="bf16", collectives={}))
    assert _failing(bad) == {"precision"}
    prec = _rule(bad, "precision")
    assert prec.observed["bad_accum_ops"] == 1
    assert any("sum over 128 elements accumulates in bfloat16" in f.message
               for f in prec.findings)
    assert _lint_one(ProgramContract(name="ok_f32_sum", build=_sum(True),
                                     policy="bf16", collectives={})).ok


def test_violation_collectives_stray_psum_on_a_one_rank_mesh():
    def _build(device):
        mesh = single_device_mesh()
        return (lambda x: cc.psum(x, "data", mesh=mesh) * 2.0), (_t((8,)),)

    bad = _lint_one(ProgramContract(name="viol_stray_psum", build=_build,
                                    collectives={}))
    assert _failing(bad) == {"collectives"}
    coll = _rule(bad, "collectives")
    assert coll.observed["census"] == {"psum[data]": 1}
    assert any("undeclared collective psum[data]" in f.message
               for f in coll.findings)
    miscount = _lint_one(ProgramContract(
        name="viol_miscount", build=_build, collectives={"psum[data]": 2}))
    assert any("psum[data]: expected 2, traced 1" in f.message
               for f in _rule(miscount, "collectives").findings)
    for want in (1, (1, 2)):
        assert _lint_one(ProgramContract(
            name="ok_psum", build=_build,
            collectives={"psum[data]": want})).ok
    assert _lint_one(ProgramContract(name="ok_census_only", build=_build,
                                     collectives=None)).ok


def test_violation_donation_dead_leaf():
    def _build(device):
        # x is never read; y is read by a reduction
        return (lambda x, y: y.sum() * 2.0), (_t((8,)), _t((8,), seed=1))

    def contract(argnum):
        return ProgramContract(
            name="donation", build=_build, collectives={},
            donation=DonationSpec(argnums=(argnum,), mode="scratch"))

    bad = _lint_one(contract(0))
    assert _failing(bad) == {"donation"}
    assert any("dead donation" in f.message
               for f in _rule(bad, "donation").findings)
    assert _lint_one(contract(1)).ok


def _pool_step(copy: bool):
    def _build(device):
        pool = [{"k": _t((5, 2, 8, 8)), "v": _t((5, 2, 8, 8), seed=1)}]

        def step(x, pool):
            for layer in pool:
                for t in layer.values():
                    if copy:
                        t.copy_(t + x)  # a pool-sized temporary
                    else:
                        t.add_(x)
            return pool[0]["k"][0, 0, 0, 0] * 1.0

        return step, (_t(()), pool)
    return _build


def test_violation_donation_whole_copy_of_the_pool():
    spec = DonationSpec(argnums=(1,), mode="alias")
    bad = _lint_one(ProgramContract(name="viol_pool_copy",
                                    build=_pool_step(True), collectives={},
                                    donation=spec))
    assert _failing(bad) == {"donation"}
    don = _rule(bad, "donation")
    assert don.observed["whole_copies"] == 2
    assert any("copied whole" in f.message for f in don.findings)
    assert _lint_one(ProgramContract(name="ok_pool", build=_pool_step(False),
                                     collectives={}, donation=spec)).ok


def test_donation_alias_needs_an_in_place_update_and_the_same_buffer():
    spec = DonationSpec(argnums=(0,), mode="alias")

    def read_only(device):
        return (lambda s: s.sum()), (_t((16,)),)

    def replaced(device):
        state = {"w": _t((16,))}

        def step(state):
            state["w"] = state["w"] * 0.5 + 1.0  # a new buffer, not in place
            return state["w"].sum()

        return step, (state,)

    msgs = [f.message for f in _rule(_lint_one(ProgramContract(
        name="viol_ro", build=read_only, collectives={}, donation=spec)),
        "donation").findings]
    assert any("never updated in place" in m for m in msgs)
    rep = _lint_one(ProgramContract(name="viol_replaced", build=replaced,
                                    collectives={}, donation=spec))
    assert _rule(rep, "donation").observed["moved_leaves"] == 1


def _step_with(extra: str):
    def _build(device):
        def step(x):
            y = x * 2.0
            if extra == "item":
                y = y + float(y[0].item())
            else:
                y = y + torch.rand(y.shape)
            return y

        return step, (_t((4,)),)
    return _build


@pytest.mark.parametrize("extra,spelling", [("item", "_local_scalar_dense"),
                                            ("rand", "rand")])
def test_violation_determinism_host_sync_and_global_draw(extra, spelling):
    bad = _lint_one(ProgramContract(name="viol_det", build=_step_with(extra),
                                    collectives={}))
    assert _failing(bad) == {"determinism"}
    det = _rule(bad, "determinism")
    assert det.observed["hits"] == {spelling: 1}
    assert _lint_one(ProgramContract(
        name="ok_det", build=_step_with(extra), collectives={},
        allowed_callbacks={spelling: 1})).ok
    over = _lint_one(ProgramContract(
        name="viol_count", build=_step_with(extra), collectives={},
        allowed_callbacks={spelling: 2}))
    assert _failing(over) == {"determinism"}


def test_a_draw_from_an_explicit_generator_is_not_a_finding():
    def _build(device):
        gen = torch.Generator().manual_seed(0)
        return (lambda x: x + torch.rand(x.shape, generator=gen)), (_t((4,)),)

    assert _lint_one(ProgramContract(name="ok_gen", build=_build,
                                     collectives={})).ok


def test_precision_int8_and_fp8_products_need_their_opt_in():
    from distributed_tensorflow_guide_tpu_torch.ops import quant

    def build(fn):
        def _build(device):
            return fn, (_t((8, 16)), _t((16, 32), seed=1))
        return _build

    for fn, flag in ((quant.int8_ste_dot, "quantized_matmuls"),
                     (quant.fp8_ste_dot, "fp8_matmuls")):
        bad = _lint_one(ProgramContract(name="viol_q", build=build(fn),
                                        collectives={}))
        assert _failing(bad) == {"precision"}
        assert _lint_one(ProgramContract(name="ok_q", build=build(fn),
                                         collectives={}, **{flag: True})).ok

    def unscaled(x, w):  # an int8 product whose sums are never rescaled
        return quant.int8_mm(x.to(torch.int8), w.to(torch.int8)).float()

    rep = _lint_one(ProgramContract(name="viol_unscaled",
                                    build=build(unscaled), collectives={},
                                    quantized_matmuls=True))
    assert any("never rescaled" in f.message
               for f in _rule(rep, "precision").findings)


# ---- linter mechanics -----------------------------------------------------------


def test_broken_build_fails_lint_not_crashes():
    def _build(device):
        raise RuntimeError("fixture exploded")

    rep = _lint_one(ProgramContract(name="viol_broken", build=_build))
    assert not rep.ok and "fixture exploded" in rep.error


def test_unknown_program_name_is_an_error():
    lint._registered(None)
    with pytest.raises(KeyError, match="no_such_program"):
        registered_contracts(("no_such_program",))


def test_report_json_roundtrip_and_render():
    rep = lint.run_contracts([ProgramContract(
        name="ok_tiny", collectives={},
        build=lambda device: ((lambda x: x * 2.0), (_t((4,)),)))])
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["ok"] and d["n_programs"] == 1 and d["n_findings"] == 0
    text = lint.render_text(rep)
    assert "PASS" in text and "ok_tiny" in text


def test_changed_only_selection(monkeypatch):
    a = ProgramContract(
        name="sel_a", build=lambda d: None,
        sources=("distributed_tensorflow_guide_tpu_torch.ops.quant",))
    b = ProgramContract(
        name="sel_b", build=lambda d: None,
        sources=("distributed_tensorflow_guide_tpu_torch.ops.fused_ce",))
    monkeypatch.setattr(
        lint, "_changed_files",
        lambda base: ["distributed_tensorflow_guide_tpu_torch/ops/quant.py"])
    picked, why = lint.select_changed([a, b], "HEAD")
    assert [c.name for c in picked] == ["sel_a"] and "1 changed" in why
    # the auditor and its closed forms live in analysis/: full lint
    monkeypatch.setattr(
        lint, "_changed_files",
        lambda base: ["distributed_tensorflow_guide_tpu_torch/analysis/"
                      "cost.py"])
    assert len(lint.select_changed([a, b], "HEAD")[0]) == 2
    monkeypatch.setattr(lint, "_changed_files", lambda base: None)
    picked, why = lint.select_changed([a, b], "HEAD")
    assert len(picked) == 2 and "full lint" in why


def test_cli_json_list_cost_changed_only_and_regress(capsys):
    assert lint.main(["--device", "cpu", "--json", "--programs",
                      "fp8_ste_matmul_grad,fused_ce_loss_grad"]) == 0
    d = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert d["ok"] and [p["name"] for p in d["programs"]] == [
        "fp8_ste_matmul_grad", "fused_ce_loss_grad"]
    assert d["programs"][0]["counts"]["ops"] > 0
    assert lint.main(["--device", "cpu", "--list"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert sorted(listed) == sorted(PROGRAMS)
    assert lint.main(["--device", "cpu", "--cost", "--programs",
                      "fp8_ste_matmul_grad"]) == 0
    assert "peak live" in capsys.readouterr().out
    assert lint.main(["--device", "cpu", "--changed-only", "--json",
                      "--regress", "--programs", "fp8_ste_matmul_grad"]) == 0
    d = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert d["ok"] and d["regress"]["selftest_ok"]


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda:0 is valid here")
    with pytest.raises(Exception):
        lint.main(["--list"])


# ---- the registry: the 12 programs, against the JAX package's auditor -----------


@pytest.fixture(scope="module")
def port_report():
    return lint.run_lint(device="cpu")


def test_registry_is_the_12_programs_and_every_one_passes(port_report):
    names = [p.name for p in port_report.programs]
    assert sorted(names) == sorted(PROGRAMS)
    assert port_report.ok, lint.render_text(port_report)


def _flops(report) -> dict:
    return {p.name: next(r.observed["flops"] for r in p.rules
                         if r.rule == "cost") for p in report.programs}


@pytest.fixture(scope="module")
def reference_flops():
    from distributed_tensorflow_guide_tpu.analysis import lint as ref_lint

    contracts = ref_lint._registered(PROGRAMS)
    out = {}
    for c in contracts:
        rep = ref_lint.lint_contract(c)
        out[c.name] = next(r.observed["flops"] for r in rep.rules
                           if r.rule == "cost")
    return out


def test_flops_against_the_jax_package_auditor(port_report, reference_flops):
    """Equal where the two programs run the same products at the same
    shapes; elsewhere the difference is stated, term by term:

    * K6 decode nodes: the JAX package prices its Pallas kernel's query
      chunk padded to the TPU's 8-row tile; the port prices the C = 1 row
      the card's kernel reads: + 4·S·H·span·(8 - 1)·hd a layer;
    * MoE: the JAX package dispatches and combines with one-hot products
      (2·T·E·C·d each) and takes the router as a product (2·T·d·E); the
      port dispatches by index and sums the router's f32 products with
      ``row_sum`` (row-invariant on the card), neither a product;
    * LoRA: the port's down site takes its first product (2·S·d_ff·r) as
      f32 products + ``row_sum`` for the same reason;
    * speculative decoding: the JAX package computes the draft's logits
      for the prompt (2·B·P·d·V) and in the round's final draft step
      (2·B·d·V) and discards them; the port's draft calls skip the head.
    """
    port = _flops(port_report)
    ref = reference_flops
    L, S, H, hd, span, d, dff, V = 2, 4, 2, 8, 256, 16, 32, 32
    E, C, T, r = 4, 2, 8, 2
    k6_pad = L * 4 * S * H * span * (8 - 1) * hd
    moe_decode = L * (2 * 2 * S * E * C * d + 2 * S * d * E)
    moe_prefill = L * (2 * 2 * T * E * T * d + 2 * T * d * E)
    lora_down = L * 2 * S * dff * r
    B, P, Vg = 2, 8, 64
    spec_heads = 2 * B * P * d * Vg + 2 * B * d * Vg
    want_gap = {
        "fused_ce_loss_grad": 0, "fp8_ste_matmul_grad": 0,
        "decode_step": 0, "serve_prefill_chunk_step": 0,
        "serve_decode_step": k6_pad, "serve_decode_step_wq8": k6_pad,
        "serve_decode_step_wqfp8": k6_pad,
        "serve_decode_step_lora": k6_pad + lora_down,
        "serve_decode_step_moe": k6_pad + moe_decode,
        "serve_decode_step_moe_wq8": k6_pad + moe_decode,
        "serve_prefill_chunk_step_moe": moe_prefill,
        "decode_spec_step": spec_heads,
    }
    assert V == 32
    assert {n: ref[n] - port[n] for n in PROGRAMS} == want_gap
    assert port["fused_ce_loss_grad"] == 4 * 2 * 64 * 32 * 128


def test_fixtures_are_the_reference_geometry():
    cfg = fixtures.tiny_lm_cfg()
    assert (cfg.vocab_size, cfg.num_layers, cfg.num_heads, cfg.d_model,
            cfg.d_ff, cfg.max_len) == (64, 2, 2, 16, 32, 8)
    loss_fn, state, batch = fixtures.tiny_mlp()
    assert [tuple(p.shape) for p in state.model.parameters()] == [
        (16, 32), (32,), (32, 16), (16,)]
    loss, _ = loss_fn(state.model, batch)
    assert torch.isfinite(loss)
