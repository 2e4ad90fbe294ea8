"""Judged config 3: BERT-base GLUE-style classification, tensor-parallel
over the ``model`` mesh axis (Megatron's column / row split,
``parallel/tensor.py``) and data-parallel over ``data``.

Reference equivalent: ParameterServerStrategy sharding whole variables
across PS tasks over gRPC; here tensors are cut inside each layer and
never leave their rank's memory::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.bert_tensor_parallel --fake-devices 8 --model-parallel 4
    D=distributed_tensorflow_guide_tpu_torch
    python -m $D.launch -n 4 --device cuda \\
        $D/examples/bert_tensor_parallel.py \\
        --model-parallel 4

Real data (a GLUE-style ``label<TAB>text`` file through the byte-level
BPE tokenizer, fixed-length labeled records and the native loader, with
a held-out split)::

    python -m $E.bert_tensor_parallel --data sst.tsv --fake-devices 8
    python -m $E.bert_tensor_parallel --make-demo-data 2048 \\
        --data demo.tsv --fake-devices 8

``--fake-devices N``: N gloo ranks on the CPU (data = N / model-parallel).
Rank 0 writes the demo file, the vocabulary and the records; the others
read them. At S = 128 attention is dense (``attn_impl="auto"``): no
kernel of K1-K6 runs.
"""

import argparse
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

# A deterministic demo corpus: the label is which lexicon dominates the
# line (bag-of-evidence sentiment), made locally to exercise the real
# input path (tokenizer, records, native loader, held-out split).
_POS = ("good great fine superb solid delightful crisp warm bright "
        "honest generous").split()
_NEG = ("bad awful dull broken sour bleak cold murky shallow brittle "
        "hollow").split()
_NEUTRAL = ("the a this that movie film plot scene actor scene pacing "
            "script camera ending dialogue soundtrack").split()


def make_demo_tsv(path: Path, n: int, seed: int = 0) -> None:
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for _ in range(n):
            label = int(rng.randint(2))
            lex = _POS if label else _NEG
            words = []
            for _ in range(int(rng.randint(6, 14))):
                pick = lex if rng.rand() < 0.45 else _NEUTRAL
                words.append(pick[rng.randint(len(pick))])
            fh.write(f"{label}\t{' '.join(words)}\n")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=4)
    ap.add_argument("--layers", type=int, default=4,
                    help="12 = full BERT-base; small default for CPU demo")
    ap.add_argument("--d-model", type=int, default=768,
                    help="width (heads must divide it AND be divisible "
                         "by --model-parallel); d_ff scales with it")
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--data", default=None, metavar="TSV",
                    help="label<TAB>text file: byte-level BPE is trained "
                         "(or loaded from TSV.vocab.json), lines are packed "
                         "into fixed-length labeled records, the native "
                         "loader streams batches, and a held-out split is "
                         "evaluated. Default: synthetic tokens.")
    ap.add_argument("--make-demo-data", type=int, default=0, metavar="N",
                    help="first write N deterministic demo lines to --data")
    ap.add_argument("--eval-every-n", type=int, default=10,
                    help="line index i % n == 0 goes to the held-out split")
    ap.add_argument("--bpe-vocab", type=int, default=512)
    _common.add_device_args(ap)
    return ap


def _prepare_text(args):
    """The input path: on rank 0 the demo file, the split, the vocabulary
    and the records; on the others the vocabulary rank 0 saved. Returns
    (tokenizer, record paths)."""
    from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
        ByteBPETokenizer,
        import_labeled_text,
    )

    tsv = Path(args.data)
    train_tsv = tsv.with_suffix(".train.tsv")
    eval_tsv = tsv.with_suffix(".eval.tsv")
    vocab_file = tsv.with_suffix(".vocab.json")
    recs = {s: tsv.with_suffix(f".{s}.records") for s in ("train", "eval")}
    if world_and_rank()[1] != 0:
        return ByteBPETokenizer.load(vocab_file), recs
    if args.make_demo_data:
        make_demo_tsv(tsv, args.make_demo_data)
        print(f"wrote {args.make_demo_data} demo lines -> {tsv}")
    # a deterministic split by line index: i % n == 0 is held out
    lines = [ln for ln in tsv.read_bytes().splitlines() if ln.strip()]
    train_tsv.write_bytes(b"\n".join(
        ln for i, ln in enumerate(lines) if i % args.eval_every_n) + b"\n")
    eval_tsv.write_bytes(b"\n".join(
        ln for i, ln in enumerate(lines)
        if not i % args.eval_every_n) + b"\n")
    if vocab_file.exists():
        tokenizer = ByteBPETokenizer.load(vocab_file)
        print(f"loaded BPE vocab: {vocab_file} "
              f"({tokenizer.vocab_size} tokens)")
    else:
        # learned from the train split only: held-out text must not shape
        # the representation it is scored with
        tokenizer = ByteBPETokenizer.train(train_tsv.read_bytes(),
                                           vocab_size=args.bpe_vocab)
        tokenizer.save(vocab_file)
        print(f"trained BPE vocab on train split -> {vocab_file}")
    for split, src in (("train", train_tsv), ("eval", eval_tsv)):
        n = import_labeled_text(src, recs[split], tokenizer, args.seq_len)
        print(f"{split}: {n} records -> {recs[split]}", flush=True)
    return tokenizer, recs


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        axis_sizes,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
        bert_base,
        make_cls_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
        TensorParallel,
        split_dim,
    )
    from distributed_tensorflow_guide_tpu_torch.train import (
        Evaluator,
        TrainState,
    )

    dev = _common.device_of(args)
    vocab_size = None
    train_loader = eval_loader = None
    if args.data:
        from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
            open_record_loader,
        )
        from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
            labeled_text_fields,
            padded_vocab,
        )

        tokenizer, recs = _common.chief_first(lambda: _prepare_text(args))
        fields = labeled_text_fields(args.seq_len)
        train_loader = open_record_loader(recs["train"], fields,
                                          args.global_batch, seed=0)
        # eval batch = global batch (it must divide the eval set for an
        # exact mean of means; the loader drops the remainder)
        eval_loader = open_record_loader(recs["eval"], fields,
                                         args.global_batch, seed=0)
        vocab_size = padded_vocab(tokenizer.vocab_size)

    mesh = build_mesh(MeshSpec(data=-1, model=args.model_parallel))
    ax = mesh.axis("data")
    cfg = bert_base(num_classes=2, dtype=torch.float32)
    cfg = type(cfg)(**{**cfg.__dict__, "num_layers": args.layers,
                       "max_len": args.seq_len, "d_model": args.d_model,
                       "num_heads": args.heads, "d_ff": 4 * args.d_model,
                       **({"vocab_size": vocab_size} if vocab_size else {})})
    full = Transformer(cfg).init_weights(0)
    n_params = sum(p.numel() for p in full.parameters())
    up_name = "blocks.0.mlp.up.weight"
    up_shape = tuple(full.state_dict()[up_name].shape)
    tp = TensorParallel(mesh, device=dev)
    model = tp.shard(full)
    del full
    state = TrainState(model, torch.optim.AdamW(
        model.parameters(), lr=args.lr, weight_decay=1e-4))
    cls_loss = make_cls_loss_fn(model)
    step = tp.make_train_step(cls_loss)

    def share(b):
        return _common.data_share(b, ax.index, ax.size)

    evaluator = None
    if eval_loader is not None:
        def metric_fn(module, batch):
            loss, mets = cls_loss(module, batch)
            return {"loss": loss, **mets}

        def make_eval_data():
            return (share(eval_loader.next_batch())
                    for _ in range(eval_loader.batches_per_epoch))

        evaluator = Evaluator(tp.make_eval_step(metric_fn), make_eval_data)

    rng = np.random.RandomState(0)
    losses = []
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    for i in range(args.steps):
        if train_loader is not None:
            b = train_loader.next_batch()
            batch = {"tokens": b["tokens"], "label": b["label"]}
        else:
            tokens = rng.randint(
                0, cfg.vocab_size,
                (args.global_batch, cfg.max_len)).astype(np.int32)
            # a learnable synthetic task: [CLS] from 50 ids, label parity
            tokens[:, 0] = rng.randint(0, 50, args.global_batch)
            batch = {"tokens": tokens,
                     "label": (tokens[:, 0] % 2).astype(np.int32)}
        state, m = step(state, share(batch))
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i}: loss={losses[-1]:.4f} "
                  f"acc={float(m['accuracy']):.3f}", flush=True)
    wall = clock.stop()
    ev = None
    if evaluator is not None:
        ev = evaluator.run(state)
        print(f"held-out: loss={ev['loss']:.4f} acc={ev['accuracy']:.3f} "
              f"({ev['eval_batches']:.0f} batches)", flush=True)
    local = tuple(model.state_dict()[up_name].shape)
    spec = tuple("model" if d == split_dim(up_name) else None
                 for d in range(len(up_shape)))
    done = (f"done: {n_params / 1e6:.1f}M params, mesh={axis_sizes(mesh)}, "
            f"mlp kernel sharding={spec}, "
            f"local shard={local} of {up_shape}")
    print(done, flush=True)
    return {"done": done, "device": str(dev),
            "world": world_and_rank()[0], "losses": losses, "eval": ev,
            "wall_s": wall,
            "sequences_per_s": args.steps * args.global_batch / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
