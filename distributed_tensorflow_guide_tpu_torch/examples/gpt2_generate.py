"""End-to-end LM story: corpus -> BPE tokenizer -> token records -> sync-DP
training -> KV-cache generation -> decoded text.

The serving-side companion of ``gpt2_pipeline.py``. Generation is
``models/generation.make_generate_fn``: the prompt prefilled in one
chunk, then one token a step through the decode-attention kernel K5 (on
a card each step is a CUDA graph replay)::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.gpt2_generate --fake-devices 8 --steps 300 \\
        --prompt "the quick brown"

``--fake-devices N``: N gloo ranks on the CPU, each training on its share
of the global batch; every rank decodes the same greedy stream.
``--decode-impl``: ``auto`` and ``pallas`` both mean the hand-written
kernel K5 (its plain version on the CPU); ``dense`` is the CPU's plain
version only, and raises on a card, where the port decodes through its
kernels. Training at ``--seq-len`` 1024 or more runs the flash kernels
K1-K3 (f32 unless ``--precision`` says otherwise).
"""

import argparse
import dataclasses
import shutil
import sys
import tempfile
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_tensorflow_guide_tpu_torch.core.mesh import (  # noqa: E402
    world_and_rank,
)
from distributed_tensorflow_guide_tpu_torch.examples import (  # noqa: E402
    _common,
)

# A tiny deterministic corpus the model can memorise in a few hundred
# steps: the point is the whole loop, not language modelling.
DEMO_CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
    "how vexingly quick daft zebras jump. "
) * 120


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", default=None, metavar="CORPUS",
                    help="text file (default: built-in demo corpus)")
    ap.add_argument("--bpe-vocab", type=int, default=384)
    ap.add_argument("--prompt", default="the quick brown")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--fused-ce", choices=["auto", "on", "off"],
                    default="auto",
                    help="chunked fused cross-entropy for the training "
                         "loss (ops/fused_ce.py): no (B, S, V) logits "
                         "live; 'auto' = on for a card and a chunkable "
                         "vocab")
    ap.add_argument("--precision", default="auto",
                    choices=["auto", "f32", "bf16", "bf16_remat",
                             "bf16_remat_attn"],
                    help="mixed-precision policy (core/precision.py); "
                         "'auto' keeps this demo's f32")
    ap.add_argument("--kv-dtype", choices=["model", "int8"],
                    default="model",
                    help="serving KV-cache dtype; 'int8' quantises the "
                         "cache (K5 reads it natively)")
    ap.add_argument("--decode-impl", choices=["auto", "dense", "pallas"],
                    default="auto",
                    help="decode attention: 'auto' and 'pallas' are the "
                         "hand-written kernel K5; 'dense' only on the CPU")
    ap.add_argument("--spec-draft-layers", type=int, default=0,
                    help="self-speculative decoding with this many draft "
                         "prefix layers (0 = off; the output is the same "
                         "either way: the knob changes the schedule)")
    _common.add_device_args(ap)
    return ap


def prepare_corpus(args, workdir: Path):
    """The corpus, its BPE tokenizer and its ``seq_len`` records in
    ``workdir``, and a native loader over them: (tokenizer, loader, line)."""
    from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
        open_record_loader,
    )
    from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
        ByteBPETokenizer,
        import_text,
        text_fields,
    )

    if args.data:
        corpus = Path(args.data)
    else:
        corpus = workdir / "demo.txt"
        corpus.write_text(DEMO_CORPUS)
    corpus_bytes = corpus.read_bytes()
    tokenizer = ByteBPETokenizer.train(corpus_bytes,
                                       vocab_size=args.bpe_vocab)
    rec = workdir / "corpus.records"
    n = import_text(corpus, rec, tokenizer, args.seq_len)
    loader = open_record_loader(rec, text_fields(args.seq_len),
                                args.global_batch, seed=0)
    line = (f"corpus: {len(corpus_bytes)} bytes -> {n} records, "
            f"vocab {tokenizer.vocab_size}")
    return tokenizer, loader, line


def lm_config(args, vocab: int):
    """The demo LM: f32 at the flags' widths, the tokenizer's padded
    vocabulary, ``--precision`` applied where the flag exists."""
    from distributed_tensorflow_guide_tpu_torch.core import precision
    from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
        padded_vocab,
    )
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    cfg = TransformerConfig(
        vocab_size=padded_vocab(vocab), num_layers=args.layers,
        num_heads=args.heads, d_model=args.d_model, d_ff=4 * args.d_model,
        max_len=args.seq_len, causal=True, dtype=torch.float32)
    if getattr(args, "precision", "auto") != "auto":
        cfg = precision.resolve(args.precision).apply_to_transformer(cfg)
    return cfg


def train_lm(args, dev, cfg, loader, *, model=None, fused_ce="auto",
             every: int = 50) -> tuple:
    """``args.steps`` data-parallel Adam steps of the LM on each rank's
    share of the loader's batches: (model, losses, wall seconds)."""
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
        make_lm_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    mesh = build_mesh(MeshSpec(data=-1))
    ax = mesh.axis("data")
    dp = DataParallel(mesh, device=dev)
    if model is None:
        model = Transformer(cfg).init_weights(0).to(dev)
    state = TrainState(model, torch.optim.Adam(model.parameters(),
                                               lr=args.lr))
    step = dp.make_train_step(make_lm_loss_fn(model, fused_ce=fused_ce))
    losses = []
    clock = _common.Clock(dev)
    for i in range(args.steps):
        batch = _common.data_share(loader.next_batch(), ax.index, ax.size)
        state, m = step(state, {"tokens": batch["tokens"].astype(np.int64)})
        losses.append(float(m["loss"]))
        if i % every == 0 or i == args.steps - 1:
            ppl = (f" ppl={float(m['perplexity']):.1f}"
                   if "perplexity" in m else "")
            print(f"step {i}: loss={losses[-1]:.4f}{ppl}", flush=True)
    return model, losses, clock.stop()


def serving_config(cfg, args, dev):
    """The training config with the serving levers: the KV cache's dtype,
    and ``--decode-impl`` checked against the device."""
    _common.check_decode_impl(args.decode_impl, dev)
    return dataclasses.replace(
        cfg, kv_dtype="int8" if args.kv_dtype == "int8" else None)


def run(args, *, model=None) -> dict:
    """``model``: a Transformer of :func:`lm_config`'s widths on the
    device holding the starting weights (default ``init_weights(0)``)."""
    from distributed_tensorflow_guide_tpu_torch.models.generation import (
        make_generate_fn,
    )

    dev = _common.device_of(args)
    workdir = Path(tempfile.mkdtemp(prefix="gpt2_generate_"))
    before = _common.kernel_counts()
    try:
        tokenizer, loader, line = prepare_corpus(args, workdir)
        print(line, flush=True)
        cfg = lm_config(args, tokenizer.vocab_size)
        model, losses, wall = train_lm(args, dev, cfg, loader, model=model,
                                       fused_ce=args.fused_ce)
        loader.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    train_launches = _common.launches_since(before)
    # generate: the serving config differs from the training config by the
    # decode levers only (the cache's dtype is serving-side state)
    gen_cfg = serving_config(cfg, args, dev)
    gen = make_generate_fn(gen_cfg, max_new_tokens=args.max_new,
                           temperature=args.temperature, top_k=args.top_k,
                           spec_draft_layers=args.spec_draft_layers,
                           device=dev)
    prompt_ids = np.asarray([tokenizer.encode(args.prompt.encode())],
                            np.int32)
    clock = _common.Clock(dev)
    out = gen(model, prompt_ids, np.zeros(2, np.uint32))
    gen_s = clock.stop()
    tokens = out[0].tolist()
    text = tokenizer.decode(tokens)
    print(f"prompt : {args.prompt!r}")
    print(f"output : {text!r}")
    stats = None
    if gen.last_stats is not None:
        stats = {k: int(v) for k, v in gen.last_stats.items()}
        print(f"speculative: {stats}")
    print("generate ok", flush=True)
    return {"done": "generate ok", "device": str(dev),
            "world": world_and_rank()[0], "losses": losses,
            "tokens": tokens, "text": text, "speculative": stats,
            "train_s": wall,
            "train_tokens_per_s": (args.steps * args.global_batch
                                   * args.seq_len / wall),
            "generate_s": gen_s,
            "generated_tokens_per_s": args.max_new / gen_s,
            "train_launches": train_launches,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
