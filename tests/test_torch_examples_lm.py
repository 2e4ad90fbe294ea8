"""The port's example family, scripts 7-12 (BERT tensor parallelism,
FSDP, the GPT-2 pipeline, long-context SP, generation and serving): each
runs at the argv of the JAX package's ``tests/test_examples.py``, scaled
to 2-4 gloo ranks on the CPU, and prints its JAX twin's success lines.
The generator's and the engine's greedy tokens are held to the JAX
package's on weights carried across by ``bridge.params_from_flax``.

Tolerances: tokens identical (float32 logits agree to ~1e-5 here, far
inside the argmax margins of these weights); the SP example's own bound,
2e-4 against dense attention, on every rank.
"""

import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_guide_tpu.data.tokenizer import (
    ByteBPETokenizer as JTokenizer,
)
from distributed_tensorflow_guide_tpu.data.tokenizer import padded_vocab
from distributed_tensorflow_guide_tpu.models import generation as jgen
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.serve import Request as JRequest
from distributed_tensorflow_guide_tpu.serve import ServeEngine as JServeEngine
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.examples import (
    gpt2_generate,
    gpt2_serve,
)
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf

REPO = Path(__file__).resolve().parents[1]
PKG = "distributed_tensorflow_guide_tpu_torch.examples"
# the scripts' demo LM at the JAX test's widths
LM_ARGS = ["--layers", "1", "--d-model", "64", "--heads", "2",
           "--seq-len", "32"]


@pytest.fixture(autouse=True)
def _isolated_table(isolated_autotune_table):
    yield


def _cli(name: str, argv: list, capsys) -> tuple[dict, str]:
    """A script's ``main(argv)`` in this process (its ``--fake-devices``
    ranks are processes of their own): (rank 0's summary, its stdout)."""
    summary = importlib.import_module(f"{PKG}.{name}").main(argv)
    return summary, capsys.readouterr().out


# ---- 7. bert_tensor_parallel ------------------------------------------------


def test_bert_trains_from_labeled_text(tmp_path, capsys):
    """Config 3 through the real input path: demo TSV -> BPE tokenizer ->
    labeled records -> native loader -> TP training -> held-out eval; the
    second run reuses the vocabulary the first saved."""
    tsv = tmp_path / "demo.tsv"
    argv = ["--fake-devices", "4", "--model-parallel", "2",
            "--make-demo-data", "400", "--data", str(tsv), "--steps", "12",
            "--layers", "2", "--d-model", "128", "--heads", "4",
            "--seq-len", "32", "--global-batch", "16", "--bpe-vocab", "300"]
    summary, out = _cli("bert_tensor_parallel", argv, capsys)
    assert "trained BPE vocab" in out, out
    assert "held-out: " in out and "done: " in out
    assert ("mesh={'data': 2, 'model': 2, 'pipe': 1, 'context': 1, "
            "'expert': 1}") in out
    assert "local shard=(256, 128) of (512, 128)" in out
    assert summary["eval"]["eval_batches"] == 2.0
    assert summary["losses"][-1] < summary["losses"][0]
    argv[argv.index("12")] = "4"
    _, out = _cli("bert_tensor_parallel", argv, capsys)
    assert "loaded BPE vocab" in out, out


# ---- 8. fsdp_zero3 ----------------------------------------------------------


def test_fsdp_zero3(capsys):
    summary, out = _cli("fsdp_zero3", [
        "--fake-devices", "4", "--steps", "12", "--global-batch", "8",
        "--fsdp-prefetch", "on"], capsys)
    assert "local shard = 0.250" in out, out
    assert "prefetch=on" in out
    assert summary["losses"][-1] < summary["losses"][0]


# ---- 9. gpt2_pipeline -------------------------------------------------------


def test_gpt2_pipeline_trains_from_text_corpus(tmp_path, capsys):
    """``--data`` trains through the tokenizer -> record -> native-loader
    path (BPE trained and saved on the first run, loaded on the second),
    and ``--generate`` decodes from the pipeline's weights."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(
        "The quick brown fox jumps over the lazy dog. " * 120
        + "It was the best of times, it was the worst of times. " * 120)
    argv = ["--fake-devices", "2", "--pipe", "2", "--layers", "4",
            "--d-model", "64", "--heads", "2", "--seq-len", "64",
            "--steps", "6", "--microbatches", "2", "--microbatch-size", "1",
            "--data", str(corpus), "--generate", "The quick",
            "--max-new", "6"]
    summary, out = _cli("gpt2_pipeline", argv, capsys)
    assert "trained BPE vocab" in out, out
    assert "native loader: " in out and "NativeRecordLoader" in out
    assert "done: " in out and "gpipe bubble fraction 0.33" in out
    assert "generated: The quick" in out
    assert corpus.with_suffix(".vocab.json").exists()
    assert len(summary["losses"]) == 6
    argv[argv.index("6")] = "2"  # --steps 6 -> 2
    _, out = _cli("gpt2_pipeline", argv, capsys)
    assert "loaded BPE vocab" in out, out


def test_gpt2_pipeline_interleaved_1f1b(capsys):
    summary, out = _cli("gpt2_pipeline", [
        "--fake-devices", "2", "--pipe", "2", "--layers", "4",
        "--d-model", "64", "--heads", "2", "--seq-len", "32", "--steps", "3",
        "--microbatches", "2", "--microbatch-size", "1", "--schedule",
        "1f1b", "--virtual-chunks", "2"], capsys)
    assert "interleaved (v=2) bubble fraction" in out, out
    assert all(np.isfinite(summary["losses"]))


# ---- 10. long_context_sp ----------------------------------------------------


def test_long_context_sp(capsys):
    summary, out = _cli("long_context_sp", [
        "--fake-devices", "4", "--seq-len", "512", "--batch", "1"], capsys)
    assert "ring attention: " in out and "ulysses: " in out, out
    assert "long-context SP ok" in out
    for name in ("ring attention", "ulysses"):
        assert summary["results"][name]["max_err"] < 2e-4


# ---- 11. gpt2_generate ------------------------------------------------------


def test_gpt2_generate_example(capsys):
    """Train then generate: corpus -> tokenizer -> records -> DP training
    -> KV-cache generation -> decoded text."""
    summary, out = _cli("gpt2_generate", [
        "--fake-devices", "2", "--steps", "120", "--max-new", "8",
        *LM_ARGS], capsys)
    assert "generate ok" in out, out
    out_line = next(ln for ln in out.splitlines()
                    if ln.startswith("output :"))
    assert "the quick brown" in out_line, out
    assert summary["world"] == 2


def _demo_lm(seed: int = 0):
    """The JAX package's demo LM at ``LM_ARGS`` (its tokenizer's padded
    vocab) and its twin in the port, on the JAX weights."""
    tok = JTokenizer.train(gpt2_generate.DEMO_CORPUS.encode(),
                           vocab_size=384)
    jcfg = jtf.TransformerConfig(
        vocab_size=padded_vocab(tok.vocab_size), num_layers=1, num_heads=2,
        d_model=64, d_ff=256, max_len=32, causal=True, dtype=jnp.float32)
    params = jtf.Transformer(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    args = gpt2_generate.parser().parse_args(LM_ARGS)
    tcfg = gpt2_generate.lm_config(args, tok.vocab_size)
    assert tcfg.vocab_size == jcfg.vocab_size
    model = ttf.Transformer(tcfg)
    model.load_state_dict(bridge.params_from_flax(tree, tcfg))
    return tok, jcfg, params, model


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_gpt2_generate_tokens_match_the_jax_generator(kv_dtype):
    """(c) ``--steps 0``: the script's greedy stream on the JAX weights is
    the JAX package's ``make_generate_fn``'s, token for token."""
    tok, jcfg, params, model = _demo_lm()
    args = gpt2_generate.parser().parse_args(
        ["--steps", "0", "--max-new", "8", "--kv-dtype", kv_dtype,
         "--device", "cpu", *LM_ARGS])
    got = gpt2_generate.run(args, model=model)
    prompt = np.asarray([tok.encode(b"the quick brown")], np.int32)
    gen = jgen.make_generate_fn(
        dataclasses.replace(jcfg, kv_dtype=None if kv_dtype == "model"
                            else "int8"),
        max_new_tokens=8, temperature=0.0)
    want = np.asarray(gen(params, prompt, jax.random.PRNGKey(0)))[0]
    assert got["tokens"] == want.tolist()
    assert got["losses"] == []


# ---- 12. gpt2_serve ---------------------------------------------------------


def test_gpt2_serve_example(capsys):
    summary, out = _cli("gpt2_serve", [
        "--fake-devices", "2", "--steps", "60", "--max-new", "8",
        "--prefix-cache"], capsys)
    assert "engine == one-shot for req 0: ok" in out, out
    assert "pool.check_leaks(): clean" in out and "serve ok" in out
    assert sorted(summary["completions"]) == ["0", "1", "2", "3"]
    assert all(len(v) == 8 for v in summary["completions"].values())


def _jax_serve(jcfg, params, prompts, max_new):
    """The JAX example's engine loop on ``prompts``: its completions."""
    eng = JServeEngine(dataclasses.replace(jcfg, decode_impl="auto"),
                       params, slots=2, num_blocks=17, block_size=8,
                       prefill_chunk=8, temperature=0.0, top_k=None)
    for rid, toks in enumerate(prompts):
        eng.submit(JRequest(rid=rid, prompt=toks, max_new_tokens=max_new,
                            rng=jax.random.PRNGKey(rid), arrival=0.1 * rid))
    now = 0.0
    while eng.sched.has_queued or eng.sched.has_resident:
        _, kind = eng.step(now)
        if kind == "idle":
            nxt = eng.sched.next_arrival()
            if nxt is None:
                break
            now = max(now, nxt)
            continue
        now += 0.01
    return eng.completions()


def test_gpt2_serve_streams_match_the_jax_engine():
    """(d) ``--steps 0``: the script's engine on the JAX weights streams
    the JAX engine's greedy tokens for the same prompts and arrivals."""
    tok, jcfg, params, model = _demo_lm()
    text = "the quick brown|pack my box|how vexingly|the lazy"
    args = gpt2_serve.parser().parse_args(
        ["--steps", "0", "--max-new", "8", "--prompts", text,
         "--device", "cpu", *LM_ARGS])
    got = gpt2_serve.run(args, model=model)["completions"]
    prompts = [np.asarray(tok.encode(p.encode()), np.int32)
               for p in text.split("|")]
    want = _jax_serve(jcfg, params, prompts, 8)
    assert got == {str(k): list(map(int, v)) for k, v in want.items()}


def test_gpt2_serve_runs_as_a_file_under_the_launcher():
    r = subprocess.run([
        sys.executable, "-m", "distributed_tensorflow_guide_tpu_torch.launch",
        "-n", "2", "--device", "cpu",
        str(REPO / "distributed_tensorflow_guide_tpu_torch" / "examples"
            / "gpt2_serve.py"), "--steps", "4", "--max-new", "4",
        "--device", "cpu", *LM_ARGS], capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "[p0] serve ok" in r.stdout and "[p1] serve ok" in r.stdout
