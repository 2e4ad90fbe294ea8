"""Judged config 5: GPT-2 pipeline-parallel LM training (GPipe, 1F1B or
interleaved microbatch schedules over the ``pipe`` mesh axis, composed
with data and tensor parallelism; ``parallel/pipeline.py``).

No reference equivalent exists (the guide's only composition mechanism
is PS / worker processes)::

    # 4 stages x 2-way data parallelism over 8 gloo ranks on the CPU
    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.gpt2_pipeline --fake-devices 8 --pipe 4 --layers 12
    # GPT-2 124M over 4 ranks sharing one card
    D=distributed_tensorflow_guide_tpu_torch
    python -m $D.launch -n 4 --device cuda $D/examples/gpt2_pipeline.py \\
        --full-gpt2 --pipe 4

``--fake-devices N``: N gloo ranks on the CPU (data = N / (pipe x
model-parallel)). ``--full-gpt2`` trains GPT-2 124M at S = 1024 in bf16,
where attention is the flash kernels K1-K3 on a card; ``--generate``
decodes through K5 after converting the stages to the serving layout.
With ``--data``, rank 0 trains (or loads) the tokenizer and packs the
records; the others read them.
"""

import argparse
import dataclasses
import functools
import itertools
import sys
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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pipe", type=int, default=4)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--microbatch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-gpt2", action="store_true",
                    help="use the real GPT-2 124M geometry")
    ap.add_argument("--schedule", choices=["gpipe", "1f1b"], default="gpipe")
    ap.add_argument("--virtual-chunks", type=int, default=1,
                    help="interleaved pipelining: layer chunks per rank "
                         "(the bubble shrinks ~v-fold; with --schedule 1f1b "
                         "this is Megatron's combined schedule)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="TP degree inside each stage (Megatron f/g; the "
                         "LM head goes vocab-parallel): dp x tp x pp")
    ap.add_argument("--fused-ce", choices=["auto", "on", "off"],
                    default="auto",
                    help="chunked fused cross-entropy (ops/fused_ce.py): "
                         "loss and logits' gradient per vocab chunk, no "
                         "(B, S, V) logits live. 'auto' resolves on for a "
                         "card and a chunkable vocab, off on the CPU (the "
                         "resolved setting is printed)")
    ap.add_argument("--precision", default="auto",
                    choices=["auto", "f32", "bf16", "bf16_remat",
                             "bf16_remat_attn"],
                    help="mixed-precision policy (core/precision.py): "
                         "params f32, activations per policy, loss f32, "
                         "incl. the selective-remat knob. 'auto' keeps "
                         "this script's per-config dtypes")
    ap.add_argument("--data", default=None, metavar="CORPUS",
                    help="text file to train on: byte-level BPE is trained "
                         "(or loaded from CORPUS.vocab.json), the corpus is "
                         "packed into fixed-length token records, and the "
                         "native loader streams batches. Default: random "
                         "tokens.")
    ap.add_argument("--bpe-vocab", type=int, default=1024,
                    help="target BPE vocab size when training a tokenizer")
    ap.add_argument("--generate", default=None, metavar="PROMPT",
                    help="after training, convert the pipeline params to "
                         "the serving layout and greedily decode from "
                         "PROMPT (needs --data)")
    ap.add_argument("--max-new", type=int, default=24)
    _common.add_device_args(ap)
    return ap


def _tokenizer(args):
    """Rank 0 trains the BPE vocabulary (or loads a saved one); the others
    load what it saved."""
    from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
        ByteBPETokenizer,
    )

    vocab_file = Path(args.data).with_suffix(".vocab.json")
    if vocab_file.exists():
        tokenizer = ByteBPETokenizer.load(vocab_file)
        print(f"loaded BPE vocab: {vocab_file} "
              f"({tokenizer.vocab_size} tokens)")
    else:
        tokenizer = ByteBPETokenizer.train(Path(args.data).read_bytes(),
                                           vocab_size=args.bpe_vocab)
        tokenizer.save(vocab_file)
        print(f"trained BPE vocab: {len(tokenizer.merges)} merges -> "
              f"{vocab_file}")
    return tokenizer


def _records(args, tokenizer, seq_len: int):
    """Rank 0 packs the corpus into ``seq_len`` records unless the file
    is newer than the corpus and the vocabulary; returns (path, count)."""
    from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
        import_text,
    )

    data = Path(args.data)
    rec = data.with_suffix(f".s{seq_len}.records")
    src_mtime = max(data.stat().st_mtime,
                    data.with_suffix(".vocab.json").stat().st_mtime)
    if rec.exists() and rec.stat().st_mtime >= src_mtime:
        return rec, rec.stat().st_size // (seq_len * 4)
    return rec, import_text(data, rec, tokenizer, seq_len)


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        axis_sizes,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        gpt2_124m,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.pipeline import (
        PipelinedLM,
        _make_interleaved_schedule,
    )

    dev = _common.device_of(args)
    mesh = build_mesh(MeshSpec(data=-1, pipe=args.pipe,
                               model=args.model_parallel))
    sizes = axis_sizes(mesh)
    tokenizer = None
    if args.data:
        from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
            padded_vocab,
        )

        tokenizer = _common.chief_first(lambda: _tokenizer(args))
        # the model's vocab: the tokenizer's, padded to a multiple of 128
        # (tensor-core tiles, vocab-parallel division); an explicit larger
        # --vocab is kept
        padded = padded_vocab(tokenizer.vocab_size)
        if args.vocab > padded:
            print(f"vocab: keeping --vocab {args.vocab} "
                  f"(tokenizer needs {padded})")
        else:
            if args.vocab != parser().get_default("vocab"):
                print(f"vocab: --vocab {args.vocab} too small for the "
                      f"tokenizer; using {padded}")
            args.vocab = padded

    if args.full_gpt2:
        cfg = gpt2_124m(remat_mode="block")
        if tokenizer is not None and tokenizer.vocab_size > cfg.vocab_size:
            raise SystemExit(
                f"--full-gpt2 pins vocab {cfg.vocab_size}; the trained "
                f"tokenizer needs {tokenizer.vocab_size}: lower --bpe-vocab")
    else:
        cfg = TransformerConfig(
            vocab_size=args.vocab, num_layers=args.layers,
            num_heads=args.heads, d_model=args.d_model,
            d_ff=4 * args.d_model, max_len=args.seq_len, causal=True,
            dtype=torch.float32)
    pp = PipelinedLM(mesh, cfg, args.microbatches, schedule=args.schedule,
                     virtual_chunks=args.virtual_chunks,
                     fused_ce=args.fused_ce,
                     precision=None if args.precision == "auto"
                     else args.precision, device=dev)
    cfg = pp.cfg  # a precision policy may have rewritten dtype / remat
    print(f"fused_ce={pp.fused_ce} (requested {args.fused_ce!r}), "
          f"precision={args.precision}", flush=True)
    module = pp.init_params(0)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in Transformer(cfg).parameters())
    opt = pp.init_opt_state(functools.partial(torch.optim.Adam, lr=args.lr),
                            module)
    step = pp.make_train_step(opt)

    ax = mesh.axis("data")
    per_shard = args.microbatches * args.microbatch_size
    global_batch = per_shard * sizes["data"]
    if args.data:
        from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
            open_record_loader,
        )
        from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
            text_fields,
        )

        rec, n_rec = _common.chief_first(
            lambda: _records(args, tokenizer, cfg.max_len))
        loader = open_record_loader(rec, text_fields(cfg.max_len),
                                    global_batch)
        print(f"native loader: {n_rec} records x {cfg.max_len} tokens "
              f"from {rec} ({type(loader).__name__})", flush=True)
        batches = (b["tokens"] for b in loader)
    else:
        rng = np.random.RandomState(0)
        batches = itertools.repeat(rng.randint(
            0, cfg.vocab_size, (global_batch, cfg.max_len)).astype(np.int32))
    if args.virtual_chunks > 1:
        # interleaved: the bubble of the actual schedule, in full-stage
        # units (each tick costs 1/v of a stage)
        T = _make_interleaved_schedule(
            args.microbatches, sizes["pipe"], args.virtual_chunks)["T"]
        bubble = (T - args.microbatches * args.virtual_chunks) / T
        kind = f"interleaved (v={args.virtual_chunks})"
    else:
        bubble = (sizes["pipe"] - 1) / (args.microbatches + sizes["pipe"] - 1)
        kind = args.schedule
    losses = []
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    for i in range(args.steps):
        tokens = _common.data_share({"tokens": next(batches)}, ax.index,
                                    ax.size)["tokens"]
        module, m = step(module, {"tokens": torch.as_tensor(
            tokens, device=dev).long()})
        losses.append(float(m["loss"]))
        if i % 5 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}", flush=True)
    wall = clock.stop()
    done = (f"done: {n_params / 1e6:.1f}M params over {sizes['pipe']} "
            f"stages x {sizes['data']} data shards; {kind} bubble fraction "
            f"{bubble:.2f} ({args.microbatches} microbatches)")
    print(done, flush=True)
    out = {"done": done, "device": str(dev), "world": world_and_rank()[0],
           "losses": losses, "wall_s": wall,
           "tokens_per_s": args.steps * global_batch * cfg.max_len / wall,
           "train_launches": _common.launches_since(before)}

    if args.generate is not None:
        if tokenizer is None:
            raise SystemExit("--generate needs --data (a trained tokenizer)")
        # train with PP, serve with a KV cache: the stages back to the flat
        # Transformer layout (every rank joins the gather), decoded on
        # rank 0
        from distributed_tensorflow_guide_tpu_torch.models.generation import (
            make_generate_fn,
        )

        serving = pp.to_serving_params(module)
        if world_and_rank()[1] == 0:
            serve_cfg = dataclasses.replace(cfg, remat_mode="none")
            model = Transformer(serve_cfg).to(dev)
            model.load_state_dict(serving)
            gen = make_generate_fn(serve_cfg, max_new_tokens=args.max_new,
                                   temperature=0.0, device=dev)
            ids = np.asarray([tokenizer.encode(args.generate.encode())],
                             np.int32)
            toks = gen(model, ids, np.zeros(2, np.uint32))
            text = tokenizer.decode(toks[0].tolist())
            print("generated:", text, flush=True)
            out["generated"] = text
    out["launches"] = _common.launches_since(before)
    return out


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
