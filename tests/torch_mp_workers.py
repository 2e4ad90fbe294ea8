"""Rank functions of the port's multi-rank CPU tests (gloo), started by
``runtime/multiprocess.py``; never collected by pytest (no ``test_``
prefix). Imports torch, numpy and the port only: the test files compare
what these return with the JAX package in the parent process.

Run as a script it is the target of the launcher test:
``python -m distributed_tensorflow_guide_tpu_torch.launch -n 2 --device cpu
tests/torch_mp_workers.py [--fail-rank K]``.
"""

from __future__ import annotations

import sys

import numpy as np

# inputs the tests and the ranks both make -------------------------------


def rank_input(rank: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + rank).randn(*shape).astype(
        np.float32)


def qkv(seed: int, shape) -> list[np.ndarray]:
    """Three global (B, S, H, D) f32 arrays, as ``tests/test_attention.py``
    makes them."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


# (name, impl, causal, n, shape, seed, dtype, grads): the cases of
# tests/test_attention.py:78-269 and their geometries
RING_CASES = (
    [(f"blockwise-n{n}-{'c' if c else 'f'}", "blockwise", c, n,
      (2, 64, 4, 16), 0, "f32") for n in (2, 4, 8) for c in (False, True)]
    + [(f"kernel-n{n}-{'c' if c else 'f'}", "kernel", c, n,
        (1, 128 * n, 2, 16), 1, "f32") for n in (2, 4) for c in (False, True)]
    + [("kernel-bf16", "kernel", True, 2, (2, 256, 2, 16), 3, "bf16"),
       ("blockwise-bf16", "blockwise", True, 2, (2, 256, 2, 16), 3, "bf16")]
)
ULYSSES_CASES = (
    [(f"ulysses-dense-{'c' if c else 'f'}", "dense", c, 4, (2, 64, 4, 16),
      0, "f32") for c in (False, True)]
    + [("ulysses-flash-c", "flash", True, 4, (2, 256, 4, 16), 4, "f32"),
       ("ulysses-dense-256-c", "dense", True, 4, (2, 256, 4, 16), 4, "f32")]
)

# the DP test's model: tiny, dense attention, f32
DP_GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=16, d_ff=32,
               max_len=16, causal=True)
DP_LR = 0.1


def dp_tokens() -> np.ndarray:
    """The union batch of the DP test: 4 rows of 16 tokens."""
    return np.random.RandomState(5).randint(0, 64, (4, 16)).astype(np.int64)


# the stats step's model: a small ResNet, 16x16 images, f32
STATS_GEOM = dict(stage_sizes=(1, 1), num_classes=10, num_filters=8,
                  small_inputs=True)
STATS_LR = 0.05


def stats_batch() -> dict:
    """The union batch of the stats step: 8 images, 4 a rank."""
    rng = np.random.RandomState(6)
    return {"image": rng.randn(8, 16, 16, 3).astype(np.float32),
            "label": rng.randint(0, 10, 8).astype(np.int32)}


def stats_model():
    import torch

    from distributed_tensorflow_guide_tpu_torch.models import resnet

    return resnet.ResNet(**STATS_GEOM, dtype=torch.float32).init_weights(0)


def _trace(rec) -> dict:
    return {k: {"calls": rec.calls[k], "bytes": rec.bytes[k],
                "wire": rec.wire[k]} for k in rec.calls}


# ---- the 4-rank job of tests/test_torch_collectives.py ---------------------


def collectives_job() -> dict:
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )

    rank = dist.get_rank()
    out: dict = {"rank": rank}

    # the mesh: 2 x 2 over (data, context), and data=-1
    m22 = build_mesh(MeshSpec(data=2, context=2))
    out["mesh22"] = {a: {"ranks": list(m22.axis(a).ranks),
                         "index": m22.axis(a).index,
                         "size": m22.axis(a).size}
                     for a in ("data", "model", "context")}
    full = build_mesh(MeshSpec(data=-1))

    # every collective on the data axis of 4
    x = torch.from_numpy(rank_input(rank, (4, 6)))
    with full, cc.trace_comm() as rec:
        out["psum"] = cc.psum(x, "data")
        out["pmean"] = cc.pmean(x, "data")
        out["pmax"] = cc.pmax(x, "data")
        tree = cc.psum({"a": x, "b": [2 * x[:2]]}, "data")
        out["tree_a"], out["tree_b"] = tree["a"], tree["b"][0]
        out["all_gather"] = cc.all_gather(x, "data")
        out["all_gather_tiled"] = cc.all_gather(x, "data", tiled=True,
                                                gather_axis=1)
        out["reduce_scatter"] = cc.reduce_scatter(x, "data")
        out["ring_shift"] = cc.ring_shift(x, "data", shift=1)
        out["ppermute_partial"] = cc.ppermute(x, "data",
                                              [(0, 2), (2, 0), (1, 1)])
        out["all_to_all"] = cc.all_to_all(x, "data", split_axis=0,
                                          concat_axis=1)
        # the gradients of the two differentiable ops
        xg = x.clone().requires_grad_()
        w = torch.from_numpy(rank_input(rank, (4, 6), seed=100))
        (cc.ring_shift(xg, "data") * w).sum().backward()
        out["ring_shift_grad"] = xg.grad
        xg = x.clone().requires_grad_()
        (cc.all_to_all(xg, "data", split_axis=0, concat_axis=1)
         * torch.from_numpy(rank_input(rank, (1, 24), seed=200))).sum(
        ).backward()
        out["all_to_all_grad"] = xg.grad
    out["trace_collectives"] = _trace(rec)

    out.update(_sp_comm_traces())
    out.update(_dp_steps())
    out.update(_stats_step())

    # the group formed again, in the same processes
    from distributed_tensorflow_guide_tpu_torch.core import dist as ddist

    out["reinitialized"] = ddist.reinitialize()
    out["after_reinit"] = cc.psum(torch.tensor([float(rank)]), "data",
                                  mesh=build_mesh())
    return out


def fail_on_rank(bad: int) -> str:
    """Rank ``bad`` raises; the others then wait for it in a barrier that
    never completes."""
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    dist.barrier()
    return "unreachable"


def sleep_long() -> None:
    import time

    time.sleep(600)


def _sp_comm_traces() -> dict:
    """Comm traces of the ring and Ulysses at tests/test_sp_comm.py's
    geometry: global (2, 512, 8, 32) f32 over a context axis of 4."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel import sequence

    rank = dist.get_rank()
    mesh = build_mesh(MeshSpec(data=1, context=4))
    local = [torch.from_numpy(rank_input(rank, (2, 128, 8, 32), seed=s))
             for s in (10, 20, 30)]
    traces = {}
    with mesh:
        with torch.no_grad(), cc.trace_comm() as rec:
            sequence.ring_attention(*local, causal=True, impl="blockwise")
        traces["ring_fwd"] = _trace(rec)
        with torch.no_grad(), cc.trace_comm() as rec:
            sequence.ulysses_attention(*local, causal=True, impl="dense")
        traces["ulysses_fwd"] = _trace(rec)
        for impl in ("kernel", "blockwise", "auto"):
            leaves = [t.clone().requires_grad_() for t in local]
            with cc.trace_comm() as rec:
                sequence.ring_attention(*leaves, causal=True,
                                        impl=impl).sum().backward()
            traces[f"ring_{impl}_fwd_bwd"] = _trace(rec)
    return {"sp_traces": traces}


def _dp_steps() -> dict:
    """One DP step at 4 ranks (data=4) and at 2 (data=2 x model=2, each
    model slice a DP group of 2), each rank on its rows of the union
    batch; the second also with accum_steps=2."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models import transformer
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
        value_and_grad,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    cfg = transformer.TransformerConfig(**DP_GEOM, dtype=torch.float32,
                                        attn_impl="dense")
    tokens = dp_tokens()
    out: dict = {}
    for tag, spec, accum in (("dp4", MeshSpec(data=4), 1),
                             ("dp2", MeshSpec(data=2, model=2), 1),
                             ("dp2acc", MeshSpec(data=2, model=2), 2)):
        mesh = build_mesh(spec)
        ax = mesh.axis("data")
        per = len(tokens) // ax.size
        batch = {"tokens": tokens[ax.index * per:(ax.index + 1) * per]}
        model = transformer.Transformer(cfg).init_weights(0)
        loss_fn = transformer.make_lm_loss_fn(model, fused_ce=False)
        _, grads = value_and_grad(loss_fn, model,
                                  {"tokens": torch.as_tensor(batch["tokens"])})
        grads = cc.pmean(grads, "data", mesh=mesh)
        state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                  lr=DP_LR))
        step = DataParallel(mesh, device="cpu").make_train_step(
            loss_fn, accum_steps=accum)
        with cc.trace_comm() as rec:
            _, mets = step(state, batch)
        out[f"{tag}/loss"] = mets["loss"]
        out[f"{tag}_trace"] = _trace(rec)
        for name, g in grads.items():
            out[f"{tag}/grad/{name}"] = g
        for name, p in model.state_dict().items():
            out[f"{tag}/param/{name}"] = p
    return out


def _stats_step() -> dict:
    """One ``make_train_step_with_stats`` step of the small ResNet over a
    data axis of 2 (data=2 x model=2), each rank on its half of the union
    batch: the running statistics and parameters it ends with."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models import resnet
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    mesh = build_mesh(MeshSpec(data=2, model=2))
    i = mesh.axis("data").index
    share = {k: v[4 * i:4 * (i + 1)] for k, v in stats_batch().items()}
    model = stats_model()
    state = TrainState(model, torch.optim.SGD(model.parameters(),
                                              lr=STATS_LR, momentum=0.9))
    step = DataParallel(mesh, device="cpu").make_train_step_with_stats(
        resnet.make_loss_fn(model))
    with cc.trace_comm() as rec:
        step(state, share)
    out = {f"stats/{n}": t for n, t in model.state_dict().items()}
    out["stats_trace"] = _trace(rec)
    return out


# ---- the 8-rank job of tests/test_torch_sequence.py -------------------------


def sequence_job() -> dict:
    """Every case of ``RING_CASES`` and ``ULYSSES_CASES`` on the context
    axis of a (data=8/n, context=n) mesh; the ranks of data index 0 run
    it and return their shards of the output and of dq, dk, dv for the
    loss sum(out ** 2) over the global output."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel import sequence

    from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as F

    rank = dist.get_rank()
    meshes = {n: build_mesh(MeshSpec(data=8 // n, context=n))
              for n in (2, 4, 8)}
    out: dict = {"rank": rank}
    # count the kernel wrappers' calls per case (CPU calls run the plain
    # versions and leave F.LAUNCHES alone): the ring's visit pattern
    calls = {}
    for fn in ("flash_carry_step", "flash_bwd_dq", "flash_bwd_dkv"):
        def counted(*a, _fn=getattr(F, fn), _name=fn, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(F, fn, counted)
    cases = [("ring",) + c for c in RING_CASES] + [
        ("ulysses",) + c for c in ULYSSES_CASES]
    for kind, name, impl, causal, n, shape, seed, dt in cases:
        mesh = meshes[n]
        if mesh.axis("data").index:
            continue
        i, s_loc = mesh.axis("context").index, shape[1] // n
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v = (torch.from_numpy(np.ascontiguousarray(
            x[:, i * s_loc:(i + 1) * s_loc])).to(dtype).requires_grad_()
            for x in qkv(seed, shape))
        fn = (sequence.ring_attention if kind == "ring"
              else sequence.ulysses_attention)
        calls.clear()
        o = fn(q, k, v, causal=causal, impl=impl, mesh=mesh)
        (o.float() ** 2).sum().backward()
        out[f"{name}/calls"] = dict(calls)
        out[f"{name}/out"] = o.detach().float()
        for t, g in zip("qkv", (q, k, v)):
            out[f"{name}/d{t}"] = g.grad.float()
    return out


# ---- the 4-rank job of tests/test_torch_pipeline.py -------------------------

# tests/test_pipeline.py's CFG (f32) and the cases held to the JAX
# PipelinedLM: (name, data, pipe, model, schedule, v, fused_ce)
PP_GEOM = dict(vocab_size=64, num_layers=4, num_heads=2, d_model=32,
               d_ff=64, max_len=16, causal=True)
PP_M, PP_MB, PP_LR, PP_CE_CHUNK = 4, 2, 0.1, 16
PP_SHORT_S = 8  # a batch of sequences shorter than max_len
PP_CASES = (
    ("pipe4-gpipe", 1, 4, 1, "gpipe", 1, False),
    ("pipe4-1f1b", 1, 4, 1, "1f1b", 1, False),
    ("pipe2-data2-1f1b", 2, 2, 1, "1f1b", 1, False),
    ("pipe2-v2-gpipe", 2, 2, 1, "gpipe", 2, False),
    ("pipe2-v2-1f1b", 2, 2, 1, "1f1b", 2, False),
    ("pipe2-model2-1f1b-fused", 1, 2, 2, "1f1b", 1, True),
    ("pipe2-model2-gpipe-naive", 1, 2, 2, "gpipe", 1, False),
)
# the fused case again with the naive vocab-parallel CE: the fused-CE ==
# naive-CE gradient identity
PP_NAIVE_TWIN = ("pipe2-model2-1f1b-naive", 1, 2, 2, "1f1b", 1, False)


def pp_tokens(n_data: int) -> np.ndarray:
    """The union batch of a case: M * mb rows a data shard."""
    return np.random.RandomState(0).randint(
        0, PP_GEOM["vocab_size"],
        (PP_M * PP_MB * n_data, PP_GEOM["max_len"])).astype(np.int64)


def flatten(tree, prefix="") -> dict:
    """A nested dict of arrays -> {"a/b/c": array}, for an .npz."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def pipeline_job(weights_dir: str) -> dict:
    """Every case of ``PP_CASES`` (and ``PP_NAIVE_TWIN``) on 4 ranks:
    the port's PipelinedLM from the JAX host tree the test wrote for the
    case's layout (``weights_dir/<name>.npz``), one eval step and one SGD
    step on the rank's share of ``pp_tokens``, then one more forward and
    backward on its first ``PP_SHORT_S`` positions. Returns, per case,
    the losses, the ``ppermute[pipe]`` wire bytes of both, the parameters
    after the step (this rank's, and the full state dict that
    ``to_serving_params`` gathers, on rank 0), and the serving model's
    logits and loss."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch import bridge
    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models import transformer
    from distributed_tensorflow_guide_tpu_torch.parallel.pipeline import (
        PipelinedLM,
    )

    rank = dist.get_rank()
    cfg = transformer.TransformerConfig(**PP_GEOM, dtype=torch.float32)
    out: dict = {"rank": rank}
    for name, n_data, P, tp, schedule, v, fused in PP_CASES + (
            PP_NAIVE_TWIN,):
        mesh = build_mesh(MeshSpec(data=n_data, pipe=P, model=tp))
        pp = PipelinedLM(mesh, cfg, PP_M, schedule=schedule,
                         virtual_chunks=v, fused_ce=fused,
                         ce_chunk=PP_CE_CHUNK, device="cpu")
        file = name if name != PP_NAIVE_TWIN[0] else PP_CASES[5][0]
        with np.load(f"{weights_dir}/{file}.npz") as z:
            tree = unflatten(dict(z))
        module = pp.load_stage(bridge.pipeline_stage_from_flax(tree, cfg,
                                                               pp))
        tokens = pp_tokens(n_data)
        i, per = mesh.axis("data").index, PP_M * PP_MB
        share = {"tokens": tokens[i * per:(i + 1) * per]}
        ev = pp.make_eval_step()
        out[f"{name}/eval_loss"] = ev(module, share)["loss"]
        opt = pp.init_opt_state(
            lambda ps: torch.optim.SGD(ps, lr=PP_LR), module)
        step = pp.make_train_step(opt)
        with cc.trace_comm() as rec:
            _, mets = step(module, share)
        out[f"{name}/loss"] = mets["loss"]
        out[f"{name}/wire"] = rec.wire.get("ppermute[pipe]", 0.0)
        out[f"{name}/want_wire"] = pp.pipe_wire_bytes_per_step(
            PP_MB, PP_GEOM["max_len"])
        out[f"{name}/coords"] = [mesh.axis(a).index
                                 for a in ("data", "pipe", "model")]
        for n, t in module.state_dict().items():
            out[f"{name}/local/{n}"] = t
        serving = pp.to_serving_params(module)
        out[f"{name}/eval_loss_after"] = ev(module, share)["loss"]
        if rank == 0:
            for n, t in serving.items():
                out[f"{name}/serving/{n}"] = t
            model = transformer.Transformer(cfg)
            model.load_state_dict(serving)
            with torch.no_grad():
                out[f"{name}/serving_logits"] = model(
                    torch.as_tensor(tokens[:2]))
                out[f"{name}/serving_loss"] = transformer.make_lm_loss_fn(
                    model, fused_ce=False)(
                    model, {"tokens": torch.as_tensor(tokens)})[0]
        with cc.trace_comm() as rec:
            pp.loss_and_grads(module,
                              {"tokens": share["tokens"][:, :PP_SHORT_S]})
        out[f"{name}/short_wire"] = rec.wire.get("ppermute[pipe]", 0.0)
        out[f"{name}/short_want_wire"] = pp.pipe_wire_bytes_per_step(
            PP_MB, PP_SHORT_S)
    return out


# ---- the 4-rank job of tests/test_torch_tensor_parallel.py ------------------

# tests/test_tensor_parallel.py's BERT-like CFG and its LM-head variant,
# f32; the LM twice more at S=128 (flash against dense)
TP_BERT = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64,
               d_ff=128, max_len=32, causal=False, num_classes=2)
TP_LM = dict(vocab_size=128, num_layers=1, num_heads=4, d_model=32, d_ff=64,
             max_len=16, causal=True)
TP_LM_LONG = dict(TP_LM, num_layers=2, max_len=128)
TP_LR, TP_CE_CHUNK = 0.1, 16


def tp_batch(geom: dict, n: int, seed: int = 0) -> dict:
    """The union batch of a TP case: ``n`` rows (labels for BERT)."""
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, geom["vocab_size"],
                               (n, geom["max_len"])).astype(np.int64)}
    if geom.get("num_classes"):
        b["label"] = rng.randint(0, 2, n).astype(np.int64)
    return b


def tp_ce_inputs() -> tuple:
    """x (N, D), the head kernel (D, V) and targets (N,) of the
    vocab-parallel fused CE case."""
    rng = np.random.RandomState(7)
    return (rng.randn(24, 16).astype(np.float32),
            (0.5 * rng.randn(16, 64)).astype(np.float32),
            rng.randint(0, 64, 24).astype(np.int64))


def tensor_parallel_job() -> dict:
    """On a (data=2, model=2) mesh: the f/g pair, the sharded model's
    logits and gradients, the vocab-parallel fused CE, and one
    ``TensorParallel`` SGD step of each case of ``tp_cases``."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models import transformer
    from distributed_tensorflow_guide_tpu_torch.ops.fused_ce import (
        fused_cross_entropy,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
        value_and_grad,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
        TensorParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    rank = dist.get_rank()
    mesh = build_mesh(MeshSpec(data=2, model=2))
    d, i = mesh.axis("data").index, mesh.axis("model").index
    out: dict = {"rank": rank, "coords": [d, i]}

    # the f/g pair
    x = torch.from_numpy(rank_input(rank, (4, 6)))
    w = torch.from_numpy(rank_input(rank, (4, 6), seed=100))
    with mesh, cc.trace_comm() as rec:
        for name, fn in (("g", cc.tp_allreduce), ("f", cc.tp_identity)):
            xg = x.clone().requires_grad_()
            y = fn(xg, "model")
            (y * w).sum().backward()
            out[f"{name}/value"], out[f"{name}/grad"] = y.detach(), xg.grad
    out["fg_trace"] = _trace(rec)

    # the vocab-parallel fused CE against its shard of the kernel
    cx, ck, ct = (torch.from_numpy(a) for a in tp_ce_inputs())
    cx.requires_grad_()
    kshard = ck.chunk(2, dim=1)[i].clone().requires_grad_()
    with mesh:
        loss = fused_cross_entropy(cx, kshard, ct, chunk=TP_CE_CHUNK,
                                   axis="model")
        loss.backward()
    out["ce/loss"], out["ce/dx"], out["ce/dw"] = loss, cx.grad, kshard.grad

    tp = TensorParallel(mesh, device="cpu")
    for case, geom, extra, n in tp_cases():
        cfg = transformer.TransformerConfig(**geom, dtype=torch.float32,
                                            **extra)
        full = transformer.Transformer(cfg).init_weights(0)
        local = tp.shard(full)
        batch = tp_batch(geom, n)
        per = n // 2
        share = {k: torch.as_tensor(v[d * per:(d + 1) * per])
                 for k, v in batch.items()}
        if cfg.num_classes:
            loss_fn = transformer.make_cls_loss_fn(local)
        else:
            loss_fn = transformer.make_lm_loss_fn(
                local, fused_ce=case.endswith("fused"),
                ce_chunk=TP_CE_CHUNK)
        with mesh:
            (l0, _), grads = value_and_grad(loss_fn, local, share)
            out[f"{case}/logits"] = local(share["tokens"]).detach()
        out[f"{case}/loss0"] = l0
        for n_, g in grads.items():
            out[f"{case}/grad/{n_}"] = g
        state = TrainState(local, torch.optim.SGD(local.parameters(),
                                                  lr=TP_LR))
        _, mets = tp.make_train_step(loss_fn)(state, share)
        out[f"{case}/loss"] = mets["loss"]
        for n_, t in tp.gather(local.state_dict()).items():
            out[f"{case}/param/{n_}"] = t
    out.update(_sequence_parallel_cases(mesh, share_of=lambda b, n: {
        k: torch.as_tensor(v[d * n // 2:(d + 1) * n // 2])
        for k, v in b.items()}))
    return out


def _sequence_parallel_cases(mesh, share_of) -> dict:
    """The LM cases of ``tp_sp_cases`` under ``MEGATRON_SP_RULES``: the
    first step's loss and gradients (before and after the replicated
    parameters' psum over ``model``), one SGD step's gathered parameters,
    and each rules' comm trace of one forward and backward."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.models import transformer
    from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
        value_and_grad,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
        MEGATRON_SP_RULES,
        TensorParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    out: dict = {}
    tps = {"default": TensorParallel(mesh, device="cpu"),
           "sp": TensorParallel(mesh, rules=MEGATRON_SP_RULES,
                                device="cpu")}
    sp = tps["sp"]
    for case, geom, extra, n in tp_sp_cases():
        cfg = transformer.TransformerConfig(**geom, dtype=torch.float32,
                                            **extra)
        full = transformer.Transformer(cfg).init_weights(0)
        share = share_of(tp_batch(geom, n), n)
        local = sp.shard(full)
        loss_fn = transformer.make_lm_loss_fn(
            local, fused_ce=case.endswith("fused"), ce_chunk=TP_CE_CHUNK)
        with mesh:
            _, raw = value_and_grad(loss_fn, local, share)
        (l0, _), grads = sp.value_and_grad(loss_fn, local, share)
        out[f"sp-{case}/loss0"] = l0
        for n_, g in grads.items():
            out[f"sp-{case}/grad/{n_}"] = g
            out[f"sp-{case}/rawgrad/{n_}"] = raw[n_]
        for rules, tp in tps.items():
            m = tp.shard(full)
            with cc.trace_comm() as rec:
                tp.value_and_grad(transformer.make_lm_loss_fn(
                    m, fused_ce=case.endswith("fused"),
                    ce_chunk=TP_CE_CHUNK), m, share)
            out[f"sp-{case}/trace/{rules}"] = _trace(rec)
        for accum in (1, 2) if case == "lm" else (1,):
            m = local if accum == 1 else sp.shard(full)
            state = TrainState(m, torch.optim.SGD(m.parameters(), lr=TP_LR))
            _, mets = sp.make_train_step(loss_fn, accum_steps=accum)(state,
                                                                     share)
            tag = f"sp-{case}" + ("" if accum == 1 else "-accum2")
            out[f"{tag}/loss"] = mets["loss"]
            for n_, t in sp.gather(m.state_dict()).items():
                out[f"{tag}/param/{n_}"] = t
    return out


def tp_sp_cases():
    """(name, geometry, config extras, union rows) of the sequence-parallel
    cases: the LM with both losses, and at S=128 through flash."""
    return (("lm", TP_LM, {}, 8),
            ("lm-fused", TP_LM, {}, 8),
            ("lm-long-flash", TP_LM_LONG, {"attn_impl": "flash"}, 8))


def tp_cases():
    """(name, geometry, config extras, union rows) of the TP step cases."""
    return (("bert", TP_BERT, {}, 16),
            ("lm", TP_LM, {}, 8),
            ("lm-fused", TP_LM, {}, 8),
            ("lm-long-flash", TP_LM_LONG, {"attn_impl": "flash"}, 8),
            ("lm-long-dense", TP_LM_LONG, {"attn_impl": "dense"}, 8))


# ---- the 2-rank jobs of tests/test_torch_fsdp.py and test_torch_overlap.py --

# FSDP: tests/test_fsdp.py's MNIST CNN run, SGD 0.1 momentum 0.9, leaves of
# 1024 elements and more sharded, 5 batches of 32 (16 a rank)
FSDP_LR, FSDP_MIN_SHARD, FSDP_STEPS, FSDP_B = 0.1, 2 ** 10, 5, 32
# the bucketed DP case: a transformer of 14.4 MB of f32 parameters, so
# that every bucket budget from 1 to 8 MiB gives another partition
OV_GEOM = dict(vocab_size=4096, num_layers=2, num_heads=4, d_model=256,
               d_ff=1024, max_len=32, causal=True)
OV_LR = 0.1
OV_BUCKETS = (4 << 10, 64 << 10, 1 << 20, 2 << 20, 4 << 20, 8 << 20,
              16 << 20, 32 << 20)
OV_RAISE_BUCKET = 1 << 20  # the raise case's budget: several buckets


def ov_tokens() -> np.ndarray:
    return np.random.RandomState(11).randint(
        0, OV_GEOM["vocab_size"], (4, OV_GEOM["max_len"])).astype(np.int64)


def fsdp_batches() -> list:
    from distributed_tensorflow_guide_tpu_torch.data.synthetic import (
        synthetic_mnist,
    )

    return synthetic_mnist(FSDP_B, seed=7).take(FSDP_STEPS)


def _fsdp_runs(mesh) -> dict:
    """The MNIST CNN over FSDP (both ``prefetch`` values) and over
    DataParallel, on this rank's half of each batch: every loss, an eval
    step's metrics, the full parameters after the run, the first step's
    comm trace and the rank's state bytes."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.models import mnist_cnn
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.fsdp import FSDP
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    i = mesh.axis("data").index
    per = FSDP_B // 2
    out: dict = {}
    for tag in ("fsdp-off", "fsdp-on", "dp"):
        model = mnist_cnn.MNISTCNN().init_weights(0)
        if tag == "dp":
            strategy = DataParallel(mesh, device="cpu")
        else:
            strategy = FSDP(mesh, min_shard_size=FSDP_MIN_SHARD,
                            prefetch=tag == "fsdp-on", device="cpu")
            model = strategy.shard(model)
            out["fsdp/specs"] = {n: list(sp) for n, sp in
                                 strategy.specs.items()}
        state = TrainState(model, torch.optim.SGD(
            model.parameters(), lr=FSDP_LR, momentum=0.9))
        step = strategy.make_train_step(mnist_cnn.make_loss_fn(model))
        for t, b in enumerate(fsdp_batches()):
            share = {k: v[i * per:(i + 1) * per] for k, v in b.items()}
            with cc.trace_comm() as rec:
                state, mets = step(state, share)
            if t == 0:
                out[f"{tag}/trace"] = _trace(rec)
            out[f"{tag}/loss{t}"] = mets["loss"]
        b0 = fsdp_batches()[0]
        for k, v in strategy.make_eval_step(mnist_cnn.make_metric_fn(
                model))(state, {k: v[i * per:(i + 1) * per]
                                for k, v in b0.items()}).items():
            out[f"{tag}/eval/{k}"] = v
        full = (strategy.gather_state_dict(model) if tag != "dp"
                else model.state_dict())
        for n, p in full.items():
            out[f"{tag}/param/{n}"] = p
        if tag != "dp":
            out[f"{tag}/bytes"] = strategy.state_bytes(model,
                                                       state.optimizer)
            out[f"{tag}/local_shapes"] = {
                n: list(p.shape) for n, p in model.named_parameters()}
            for n, p in model.named_parameters():
                out[f"{tag}/shard/{n}"] = p
    return out


def _overlap_runs(mesh) -> dict:
    """One SGD step of the OV transformer with the monolithic all-reduce
    and with every bucket budget of ``OV_BUCKETS``: the loss, whether the
    parameters are bitwise the monolithic step's, the comm trace and the
    bucket count ``bucket_assignment`` gives; then the ResNet stats step
    with 1 KiB buckets against the monolithic one."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.models import resnet
    from distributed_tensorflow_guide_tpu_torch.models import transformer
    from distributed_tensorflow_guide_tpu_torch.parallel import overlap
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    i = mesh.axis("data").index
    cfg = transformer.TransformerConfig(**OV_GEOM, dtype=torch.float32)
    share = {"tokens": ov_tokens()[2 * i:2 * (i + 1)]}

    def run(dp):
        model = transformer.Transformer(cfg).init_weights(0)
        state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                  lr=OV_LR))
        step = dp.make_train_step(transformer.make_lm_loss_fn(model))
        with cc.trace_comm() as rec:
            _, mets = step(state, share)
        return model, mets["loss"].item(), _trace(rec)

    ref, ref_loss, ref_trace = run(DataParallel(mesh, device="cpu"))
    out: dict = {"ov/ref_loss": ref_loss, "ov/ref_trace": ref_trace,
                 "ov/param_bytes": sum(p.numel() * 4
                                       for p in ref.parameters())}
    for bb in OV_BUCKETS:
        model, loss, trace = run(DataParallel(mesh, overlap=True,
                                              bucket_bytes=bb, device="cpu"))
        out[f"ov/{bb}"] = {
            "loss": loss, "trace": trace,
            "buckets": len(overlap.bucket_assignment(
                list(model.parameters()), bb)),
            "bitwise": all(torch.equal(a, b) for a, b in zip(
                model.parameters(), ref.parameters()))}

    out["ov/raised"] = _overlap_after_a_raise(mesh, cfg, share, ref)

    share = {k: v[4 * i:4 * (i + 1)] for k, v in stats_batch().items()}
    states = []
    for dp in (DataParallel(mesh, device="cpu"),
               DataParallel(mesh, overlap=True, bucket_bytes=1 << 10,
                            device="cpu")):
        model = stats_model()
        state = TrainState(model, torch.optim.SGD(
            model.parameters(), lr=STATS_LR, momentum=0.9))
        dp.make_train_step_with_stats(resnet.make_loss_fn(model))(state,
                                                                  share)
        states.append(model.state_dict())
    out["ov/stats_bitwise"] = all(torch.equal(states[0][n], states[1][n])
                                  for n in states[0])
    return out


def _overlap_after_a_raise(mesh, cfg, share, ref) -> dict:
    """A bucketed step whose backward raises in the first block, after the
    buckets of the later leaves were issued, then the same step again: the
    failed step must leave the parameters as they were, and the next one
    must be bitwise the monolithic step with one all-reduce a bucket."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.models import transformer
    from distributed_tensorflow_guide_tpu_torch.parallel import overlap
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    class Boom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("boom in the backward")

    bb = OV_RAISE_BUCKET
    model = transformer.Transformer(cfg).init_weights(0)
    before = [p.detach().clone() for p in model.parameters()]
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=OV_LR))
    step = DataParallel(mesh, overlap=True, bucket_bytes=bb,
                        device="cpu").make_train_step(
        transformer.make_lm_loss_fn(model))
    hook = model.blocks[0].register_forward_hook(
        lambda m, args, y: Boom.apply(y))
    raised = False
    with cc.trace_comm() as failed:
        try:
            step(state, share)
        except RuntimeError as e:
            raised = "boom" in str(e)
    hook.remove()
    out = {"raised": raised,
           "hooks_left": sum(len(p._backward_hooks or {})
                             for p in model.parameters()),
           "issued": _trace(failed).get("pmean[data]", {}).get("calls", 0),
           "unchanged": all(torch.equal(a, b) for a, b in zip(
               model.parameters(), before))}
    with cc.trace_comm() as rec:
        step(state, share)
    out["calls"] = _trace(rec)["pmean[data]"]["calls"]
    out["buckets"] = len(overlap.bucket_assignment(list(model.parameters()),
                                                   bb))
    out["bitwise"] = all(torch.equal(a, b) for a, b in zip(
        model.parameters(), ref.parameters()))
    return out


def _data2(runs) -> dict:
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )

    return {"rank": dist.get_rank(), **runs(build_mesh(MeshSpec(data=2)))}


def fsdp_job() -> dict:
    """FSDP against DataParallel on a data axis of 2."""
    return _data2(_fsdp_runs)


def overlap_job() -> dict:
    """The bucketed all-reduce against the monolithic one on a data axis
    of 2."""
    return _data2(_overlap_runs)


# ---- the 2-rank job of tests/test_torch_quant.py ------------------------------

# tests/test_quant.py's int8_pmean tree (8 devices there, 2 ranks here)
# and its DP least-squares problem
QP_DIM = 8
QP_LR = 0.05
QP_STEPS = 10


def qp_tree(rank: int) -> dict:
    rng = np.random.RandomState(5 + rank)
    return {"w": rng.randn(1, 16, 4).astype(np.float32),
            "b": rng.randn(1, 4).astype(np.float32),
            "count": np.array([rank], np.int32)}


def qp_problem():
    xs = np.random.RandomState(7).randn(64, QP_DIM).astype(np.float32)
    return xs, (xs @ np.ones((QP_DIM, 1)) * 0.3).astype(np.float32)


def qp_w0() -> np.ndarray:
    return (np.random.RandomState(5).randn(QP_DIM, 1).astype(np.float32)
            * 0.1)


def _quant_runs(mesh) -> dict:
    """``int8_pmean`` of one tree; ``compress="int8"`` against the plain
    bucketed step over ``QP_STEPS`` SGD steps; a k-step DP call over
    gloo (eager) against single steps."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.ops import quant
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    i = mesh.axis("data").index
    tree = {k: torch.from_numpy(v) for k, v in qp_tree(i).items()}
    with cc.trace_comm() as rec:
        got = quant.int8_pmean(tree, "data", mesh=mesh)
    out: dict = {"pmean": {k: v.tolist() for k, v in got.items()},
                 "pmean_trace": _trace(rec)}
    with cc.trace_comm() as rec:
        quant.int8_pmean({"count": tree["count"]}, "data", mesh=mesh)
    out["ints_trace"] = _trace(rec)

    xs, ys = qp_problem()
    share = {"x": xs[32 * i:32 * (i + 1)], "y": ys[32 * i:32 * (i + 1)]}

    def loss_fn(module, batch):
        err = module(batch["x"]) - batch["y"]
        return (err ** 2).mean(), {}

    def run(dp, steps=QP_STEPS, k=None):
        model = torch.nn.Linear(QP_DIM, 1, bias=False)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(qp_w0().T))
        state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                  lr=QP_LR))
        step = dp.make_train_step(loss_fn, steps_per_call=k,
                                  per_step_metrics=k is not None)
        losses, traces = [], []
        for _ in range(steps if k is None else steps // k):
            with cc.trace_comm() as rec:
                _, m = step(state, share)
            losses.append(m["loss"].reshape(-1).tolist())
            traces.append(_trace(rec))
        return (model.weight.detach().T.tolist(), losses, traces[0],
                getattr(step, "captured", None))

    for name, dp in (("plain", DataParallel(mesh, overlap=True,
                                            bucket_bytes=64, device="cpu")),
                     ("int8", DataParallel(mesh, overlap=True,
                                           bucket_bytes=64, compress="int8",
                                           device="cpu"))):
        w, losses, trace, _ = run(dp)
        out[f"dp/{name}"] = {"w": w, "losses": losses, "trace": trace}
    dp = DataParallel(mesh, device="cpu")
    w1, l1, _, _ = run(dp, steps=4)
    wk, lk, _, captured = run(dp, steps=4, k=4)
    out["kstep"] = {"w_single": w1, "w_k": wk, "l_single": l1, "l_k": lk,
                    "captured": captured}
    return out


def quant_job() -> dict:
    """The int8-compressed collectives on a data axis of 2."""
    return _data2(_quant_runs)


# ---- the 4-rank job of tests/test_torch_async_ps.py --------------------------

# tests/test_async_ps.py's least-squares problem
PS_DIM = 6


def ps_problem(seed: int = 0, n: int = 128):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, PS_DIM).astype(np.float32)
    w_true = rng.randn(PS_DIM, 1).astype(np.float32)
    return x, x @ w_true


def ps_w0(seed: int = 0) -> np.ndarray:
    return (np.random.RandomState(100 + seed).randn(PS_DIM, 1)
            .astype(np.float32) * 0.1)


def ps_superbatch(x, y, k: int, world_batch: int) -> dict:
    """Leaves (k, world_batch, ...): k sub-batches a sync round."""
    idx = np.random.RandomState(7).randint(0, len(x), k * world_batch)
    return {"x": x[idx].reshape(k, world_batch, PS_DIM),
            "y": y[idx].reshape(k, world_batch, 1)}


def ps_model(w0=None):
    """The least-squares model: one parameter ``w`` (PS_DIM, 1)."""
    import torch

    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.as_tensor(
        ps_w0() if w0 is None else w0).clone())
    return m


def ps_loss(module, batch):
    import torch

    pred = torch.as_tensor(batch["x"]) @ module.w
    return ((pred - torch.as_tensor(batch["y"])) ** 2).mean(), {}


def _rows(batch: dict, ax, *, time_axis: bool = False) -> dict:
    """This rank's share of a global batch (along dim 1 of a super-batch
    that leads with its time axis)."""
    n = next(iter(batch.values())).shape[1 if time_axis else 0] // ax.size
    sl = slice(ax.index * n, (ax.index + 1) * n)
    return {k: v[:, sl] if time_axis else v[sl] for k, v in batch.items()}


def async_ps_job() -> dict:
    """LocalSGD, GossipSGD and AccumulatedAdaptive over a data axis of 4,
    then LocalSGD (K=2) and AccumulatedAdaptive (K=4) with Adam over a
    data axis of 2 (the two pairs of a data=2 x model=2 mesh)."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.async_ps import (
        AccumulatedAdaptive,
        GossipSGD,
        LocalSGD,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    rank = dist.get_rank()
    mesh = build_mesh(MeshSpec(data=4))
    ax = mesh.axis("data")
    x, y = ps_problem()
    out: dict = {"rank": rank}

    def state(opt, lr, w0=None):
        m = ps_model(w0)
        return TrainState(m, opt(m.parameters(), lr=lr))

    # LocalSGD(K=1) against DataParallel, 5 steps of SGD 0.05
    ls = LocalSGD(mesh, sync_period=1, device="cpu")
    dp = DataParallel(mesh, device="cpu")
    s_ls, s_dp = state(torch.optim.SGD, 0.05), state(torch.optim.SGD, 0.05)
    step_ls = ls.make_train_step(ps_loss)
    step_dp = dp.make_train_step(ps_loss)
    for _ in range(5):
        sb = ps_superbatch(x, y, 1, 64)
        s_ls, _ = step_ls(s_ls, _rows(sb, ax, time_axis=True))
        s_dp, _ = step_dp(s_dp, _rows({k: v[0] for k, v in sb.items()}, ax))
    out["ls1/w"], out["dp/w"] = s_ls.model.w, s_dp.model.w

    # LocalSGD(K=4): learns, counts local steps, one sync a call
    ls = LocalSGD(mesh, sync_period=4, device="cpu")
    for opt, tag in ((torch.optim.SGD, "sgd"), (torch.optim.Adam, "adam")):
        st = state(opt, 0.05)
        step = ls.make_train_step(ps_loss)
        losses = []
        for t in range(10):
            with cc.trace_comm() as rec:
                st, m = step(st, _rows(ps_superbatch(x, y, 4, 64), ax,
                                       time_axis=True))
            losses.append(m["loss"].item())
        out[f"ls4-{tag}"] = {"losses": losses, "step": st.step,
                             "trace": _trace(rec)}

    # GossipSGD at lr 0: the replicas' disagreement contracts
    gs = GossipSGD(mesh, device="cpu")
    noise = np.random.RandomState(0).randn(4, PS_DIM, 1).astype(np.float32)
    st = gs.distribute(state(torch.optim.SGD, 0.0, ps_w0() + noise[rank]))
    step = gs.make_train_step(ps_loss)
    out["gossip0/w_before"] = st.model.w.detach().clone()
    with cc.trace_comm() as rec:
        st, _ = step(st, _rows({"x": x[:64], "y": y[:64]}, ax))
    out["gossip0/trace"] = _trace(rec)
    for _ in range(14):
        st, _ = step(st, _rows({"x": x[:64], "y": y[:64]}, ax))
    out["gossip0/w_after"] = st.model.w

    # GossipSGD learns; the consensus is the replicas' mean
    st = gs.distribute(state(torch.optim.SGD, 0.05))
    rng = np.random.RandomState(3)
    losses = []
    for _ in range(30):
        idx = rng.permutation(len(x))[:64]
        st, m = step(st, _rows({"x": x[idx], "y": y[idx]}, ax))
        losses.append(m["loss"].item())
    out["gossip/losses"] = losses
    out["gossip/w"] = st.model.w
    out["gossip/consensus"] = gs.consensus(st)["w"]

    # AccumulatedAdaptive(K=4), Adam 0.01: one step
    aa = AccumulatedAdaptive(mesh, accum_steps=4, device="cpu")
    st = state(torch.optim.Adam, 0.01)
    with cc.trace_comm() as rec:
        aa.make_train_step(ps_loss)(st, _rows(ps_superbatch(x, y, 4, 64),
                                              ax, time_axis=True))
    out["adag/w"], out["adag/trace"] = st.model.w, _trace(rec)

    # parity at 2 ranks: LocalSGD(K=2) with Adam, 3 calls; AA(K=4), 2
    mesh2 = build_mesh(MeshSpec(data=2, model=2))
    ax2 = mesh2.axis("data")
    out["coords2"] = [ax2.index, mesh2.axis("model").index]
    for tag, strat, k, calls in (
            ("ls2", LocalSGD(mesh2, 2, device="cpu"), 2, 3),
            ("aa2", AccumulatedAdaptive(mesh2, 4, device="cpu"), 4, 2)):
        st = state(torch.optim.Adam, 0.01)
        step = strat.make_train_step(ps_loss)
        losses = []
        for c in range(calls):
            sb = ps_superbatch(*ps_problem(seed=c), k, 32)
            st, m = step(st, _rows(sb, ax2, time_axis=True))
            losses.append(m["loss"].item())
        out[f"{tag}/losses"], out[f"{tag}/w"] = losses, st.model.w
    return out


# ---- the 2-rank card job of tests/test_torch_kernels_gpu.py -----------------

# small widths at a head dim the kernels take (64), bf16; one layer a stage
PP_GPU_GEOM = dict(vocab_size=512, num_layers=2, num_heads=2, d_model=128,
                   d_ff=256, max_len=256, causal=True, attn_impl="flash")
PP_GPU_M, PP_GPU_MB = 4, 2


def pp_gpu_tokens() -> np.ndarray:
    return np.random.RandomState(3).randint(
        0, 512, (PP_GPU_M * PP_GPU_MB, 256)).astype(np.int64)


def pipeline_gpu_rank() -> dict:
    """One 1F1B step at pipe = 2 on the card (ranks share ``cuda:0`` over
    gloo): the loss, the K1-K3 launches and fallbacks of this rank, and
    the gathered gradients (``to_serving_params``) on rank 0."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models import transformer
    from distributed_tensorflow_guide_tpu_torch.ops import (
        flash_attention as FA,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.pipeline import (
        PipelinedLM,
    )

    cfg = transformer.TransformerConfig(**PP_GPU_GEOM, dtype=torch.bfloat16)
    pp = PipelinedLM(build_mesh(MeshSpec(data=1, pipe=2)), cfg, PP_GPU_M,
                     schedule="1f1b")
    module = pp.init_params(0)
    FA.reset_launch_counts()
    loss, grads = pp.loss_and_grads(module, {"tokens": pp_gpu_tokens()})
    torch.cuda.synchronize()
    out = {"rank": dist.get_rank(), "loss": loss.item(),
           "launches": dict(FA.LAUNCHES),
           "fallbacks": len(FA.fallback_stats()),
           "layers": sum(len(c) for c in module.chunks),
           "last_stage": pp.stage == pp.n_stages - 1}
    full = pp.to_serving_params(grads)
    if out["rank"] == 0:
        out.update({f"grad/{n}": g.float() for n, g in full.items()})
    return out


# ---- the 4-rank job of tests/test_torch_expert_parallel.py --------------------

# one MoE layer (tests/test_expert_parallel.py's widths) on two meshes:
# data 1 x expert 2 (the model axis holds a second, identical copy) and
# data 2 x expert 2; capacity factor 1.0, so that Switch drops tokens
EP_CASES = (("data1-expert2", dict(data=1, model=2, expert=2)),
            ("data2-expert2", dict(data=2, expert=2)))
EP_DIM, EP_FF, EP_E, EP_T, EP_CF, EP_LR = 8, 16, 4, 64, 1.0, 0.05


def ep_problem():
    """Full params (router, w_in, w_out), the global tokens and targets."""
    rs = np.random.RandomState(11)
    params = {"router": rs.randn(EP_DIM, EP_E) / np.sqrt(EP_DIM),
              "w_in": rs.randn(EP_E, EP_DIM, EP_FF) / np.sqrt(EP_DIM),
              "w_out": rs.randn(EP_E, EP_FF, EP_DIM) / np.sqrt(EP_FF)}
    x = rs.randn(EP_T, EP_DIM)
    y = np.tanh(rs.randn(EP_T, EP_DIM))
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32), y.astype(np.float32))


def ep_job() -> dict:
    """``ExpertParallel.apply`` and one ``make_train_step`` step at top-1
    and top-2 on both meshes: each rank's outputs, aux and new params."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.expert import (
        ExpertParallel,
        MoEConfig,
    )

    params, x, y = ep_problem()
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    out: dict = {"rank": dist.get_rank()}
    for name, spec in EP_CASES:
        mesh = build_mesh(MeshSpec(**spec))
        out[f"{name}/token_index"] = mesh.axis(("data", "expert")).index
        out[f"{name}/expert_index"] = mesh.axis("expert").index
        for top_k in (1, 2):
            cfg = MoEConfig(EP_DIM, EP_FF, EP_E, top_k=top_k,
                            capacity_factor=EP_CF)
            ep = ExpertParallel(mesh, cfg, device="cpu")
            local = ep.shard_params(full)
            xs, ys = ep.token_shard(x), ep.token_shard(y)
            with cc.trace_comm() as rec:
                got, aux = ep.apply(local, xs)
            new, mets = ep.make_train_step(EP_LR)(local, xs, ys)
            pre = f"{name}/k{top_k}"
            out[f"{pre}/y"] = got
            out[f"{pre}/trace"] = _trace(rec)
            for k in ("load_balance", "z_loss"):
                out[f"{pre}/{k}"] = aux[k].item()
            out[f"{pre}/loss"] = mets["loss"].item()
            for k, v in new.items():
                out[f"{pre}/new/{k}"] = v
    return out


# ---- the 4-rank job of tests/test_torch_moe_lm.py ----------------------------

# tests/test_moe_lm.py's CFG; Switch top-2 (capacity factor 2.0) and
# dropless top-1, 8 experts, at data 2 x expert 2
ML_GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
               d_ff=64, max_len=16, causal=True)
ML_CASES = (("switch", 2), ("dropless", 1))
ML_E, ML_B = 8, 16


def ml_tokens() -> np.ndarray:
    return np.random.RandomState(1).randint(
        0, ML_GEOM["vocab_size"], (ML_B, ML_GEOM["max_len"])).astype(
            np.int64)


def moe_lm_job(weights: str) -> dict:
    """SwitchLM at data 2 x expert 2 from the JAX tree in ``weights``
    (``flatten``ed .npz): each case's loss, this rank's gradients and,
    after one Adam step, the shapes of its moments."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch import bridge
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models.moe_lm import SwitchLM
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    cfg = TransformerConfig(**ML_GEOM, dtype=torch.float32)
    with np.load(weights) as z:
        full = bridge.switch_lm_from_flax(unflatten(dict(z)), cfg)
    mesh = build_mesh(MeshSpec(data=2, expert=2))
    out: dict = {"rank": dist.get_rank(),
                 "expert_index": mesh.axis("expert").index,
                 "data_index": mesh.axis("data").index}
    for router, top_k in ML_CASES:
        lm = SwitchLM(mesh, cfg, ML_E, top_k=top_k, router=router,
                      fused_ce=False, device="cpu")
        module = lm.shard_params(full)
        share = lm.token_shard(ml_tokens())
        loss, mets, grads = lm.loss_and_grads(module, share)
        out[f"{router}/loss"] = loss.item()
        out[f"{router}/lm_loss"] = mets["lm_loss"].item()
        for n, g in grads.items():
            out[f"{router}/grad/{n}"] = g
        opt = torch.optim.Adam(module.parameters(), lr=1e-3)
        lm.make_train_step(opt)(module, share)
        for n, p in module.named_parameters():
            out[f"{router}/moment/{n}"] = [list(opt.state[p]["exp_avg"]
                                                .shape), list(p.shape)]
    return out


# ---- the launcher test's script ----------------------------------------------


# ---- checkpoint, recovery and chaos jobs ---------------------------------------
# (tests/test_torch_checkpoint.py, test_torch_elastic.py, test_torch_chaos.py)

# the supervised runs' tiny LM: 2 layers, d = 64, Adam; a batch is one
# stream position's tokens and a float ``scale`` of 1.0 that multiplies
# the loss, so a poisoned (NaN) batch NaNs the loss
RL_GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=64,
               d_ff=128, max_len=16, causal=True)


def rl_state(seed: int = 0):
    import torch

    from distributed_tensorflow_guide_tpu_torch.models import (
        transformer as ttf,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    model = ttf.Transformer(ttf.TransformerConfig(
        **RL_GEOM, dtype=torch.float32)).init_weights(seed)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))


def rl_step(state):
    """The DP step of ``state``'s model over the scaled LM loss."""
    from distributed_tensorflow_guide_tpu_torch.models import (
        transformer as ttf,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )

    base = ttf.make_lm_loss_fn(state.model, fused_ce=False)

    def loss_fn(module, batch):
        loss, mets = base(module, batch)
        return loss * batch["scale"].mean(), mets

    return DataParallel(device="cpu").make_train_step(loss_fn)


def rl_batch(pos: int, poison: bool = False) -> dict:
    toks = np.random.RandomState(pos).randint(0, 64, (2, 16))
    return {"tokens": toks.astype(np.int64),
            "scale": np.full((1,), np.nan if poison else 1.0, np.float32)}


def rl_data(start: int):
    return (rl_batch(p) for p in range(start, 10_000))


def rl_oracle(positions):
    """The uninterrupted run over the stream ``positions``."""
    import torch

    state = rl_state()
    step = rl_step(state)
    for p in positions:
        state, _ = step(state, {k: torch.as_tensor(v)
                                for k, v in rl_batch(p).items()})
    return state


def rl_equal(a, b) -> bool:
    """Parameters, Adam moments and step bitwise equal."""
    import torch

    if a.step != b.step:
        return False
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        if not torch.equal(x, y):
            return False
    for sa, sb in zip(a.optimizer.state.values(),
                      b.optimizer.state.values()):
        if sa.keys() != sb.keys() or not all(
                torch.equal(sa[k], sb[k]) for k in sa):
            return False
    return True


CK_STEPS = 3  # the FSDP job: steps before the save


def ckpt_fsdp_job(ckpt_dir: str) -> dict:
    """FSDP shards saved by every rank (``sharded=True``) and a replicated
    DP state saved by rank 0, each restored in place into a fresh model of
    another seed: the restored tensors equal the saved ones bitwise, and
    one more step from the restore equals one more step from the
    original."""
    import os

    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models import mnist_cnn
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.fsdp import FSDP
    from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
        Checkpointer,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    mesh = build_mesh(MeshSpec(data=2))
    rank = dist.get_rank()
    per = FSDP_B // 2
    batches = [{k: v[rank * per:(rank + 1) * per] for k, v in b.items()}
               for b in fsdp_batches()]
    out: dict = {"rank": rank}
    for tag in ("fsdp", "dp"):
        strategy = (FSDP(mesh, min_shard_size=FSDP_MIN_SHARD, device="cpu")
                    if tag == "fsdp" else DataParallel(mesh, device="cpu"))

        def build(seed):
            model = mnist_cnn.MNISTCNN().init_weights(seed)
            if tag == "fsdp":
                model = strategy.shard(model)
            return TrainState(model, torch.optim.Adam(model.parameters(),
                                                      lr=1e-3))

        state = build(0)
        step = strategy.make_train_step(mnist_cnn.make_loss_fn(state.model))
        for b in batches[:CK_STEPS]:
            state, _ = step(state, b)
        ckpt = Checkpointer(os.path.join(ckpt_dir, tag),
                            sharded=tag == "fsdp")
        ckpt.save(CK_STEPS, state)
        saved = {n: t.clone() for n, t in state.model.state_dict().items()}
        moments = [t.clone() for st in state.optimizer.state.values()
                   for t in st.values()]
        state, _ = step(state, batches[CK_STEPS])
        after = {n: t.clone() for n, t in state.model.state_dict().items()}

        fresh = build(1)
        # one step first, so the restore writes into live Adam state
        fresh_step = strategy.make_train_step(
            mnist_cnn.make_loss_fn(fresh.model))
        fresh, _ = fresh_step(fresh, batches[0])
        ptrs = [t.data_ptr() for t in fresh.model.state_dict().values()]
        restored, at = ckpt.restore_latest_valid(fresh)
        out[f"{tag}/restored_step"] = at
        out[f"{tag}/same_object"] = restored is fresh
        out[f"{tag}/in_place"] = ptrs == [
            t.data_ptr() for t in fresh.model.state_dict().values()]
        out[f"{tag}/params_equal"] = all(
            torch.equal(saved[n], t)
            for n, t in fresh.model.state_dict().items())
        out[f"{tag}/moments_equal"] = all(
            torch.equal(a, b) for a, b in zip(
                moments, [t for st in fresh.optimizer.state.values()
                          for t in st.values()]))
        fresh, _ = fresh_step(fresh, batches[CK_STEPS])
        out[f"{tag}/continued_equal"] = all(
            torch.equal(after[n], t)
            for n, t in fresh.model.state_dict().items())
        out[f"{tag}/files"] = sorted(os.listdir(
            os.path.join(ckpt_dir, tag, str(CK_STEPS))))
        ckpt.close()
    return out


# the multiprocess crash-and-resume job: tests/test_elastic.py's problem
MP_TOTAL = 12
MP_CKPT_EVERY = 4
MP_CRASH_AFTER = 7  # after the first checkpoint (4), before the next (8)
MP_LR = 0.05


def mp_elastic_problem():
    rng = np.random.RandomState(3)
    gx = rng.randn(8, 4).astype(np.float32)
    gw = np.arange(4, dtype=np.float32)
    return gx, gx @ gw


def elastic_dp_job(ckpt_dir: str, crash_after: int) -> dict:
    """2-rank DP least squares under ``CheckpointHook``: with
    ``crash_after >= 0`` the ranks exit abruptly after that step (the
    step-4 checkpoint durable); otherwise they resume from the newest
    checkpoint and finish."""
    import os

    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
        Checkpointer,
        CheckpointHook,
    )
    from distributed_tensorflow_guide_tpu_torch.train.hooks import (
        BaseHook,
        StopAtStepHook,
    )
    from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    mesh = build_mesh(MeshSpec(data=2))
    dp = DataParallel(mesh, device="cpu")
    gx, gy = mp_elastic_problem()
    per = len(gx) // dist.get_world_size()
    lo = dist.get_rank() * per

    def make_batch(s):
        f = 1.0 + s / 10.0
        return {"x": gx[lo:lo + per] * f, "y": gy[lo:lo + per] * f}

    def loss_fn(module, batch):
        pred = batch["x"] @ module.weight[0]
        return ((pred - batch["y"]) ** 2).mean(), {}

    model = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=MP_LR))
    ckpt = Checkpointer(ckpt_dir, max_to_keep=2)
    start = ckpt.latest_step() or 0
    if start:
        state = ckpt.restore(state)

    class CrashHook(BaseHook):
        def after_step(self, step, metrics):
            if crash_after >= 0 and step + 1 == crash_after:
                ckpt.wait()
                print("CRASHING", flush=True)
                os._exit(1)  # abrupt, like a kill: no atexit barriers

    loop = TrainLoop(
        dp.make_train_step(loss_fn), state,
        (make_batch(s) for s in range(start, 10_000)),
        hooks=[CheckpointHook(ckpt, MP_CKPT_EVERY), CrashHook(),
               StopAtStepHook(MP_TOTAL)],
        start_step=start, device="cpu")
    final = loop.run()
    ckpt.close()
    return {"resumed_from": start, "steps_done": loop.step,
            "w": final.model.weight[0].detach().numpy().tolist()}


def kill_mid_save_job(ckpt_dir: str, spin_after_save: bool) -> dict:
    """A big state that async-saves at step 4; with ``spin_after_save``
    the process then holds still, so the parent's SIGKILL can land
    mid-write; otherwise it resumes from the newest valid checkpoint and
    finishes 8 steps."""
    import pathlib
    import time

    import torch

    from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
        Checkpointer,
        CheckpointHook,
    )
    from distributed_tensorflow_guide_tpu_torch.train.hooks import (
        BaseHook,
        StopAtStepHook,
    )
    from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop

    big = np.zeros((2 << 20,), np.float32)  # 8 MiB: a save that takes time

    def step_fn(state, batch):
        return {"w": state["w"] + 1.0, "pad": big}, {}

    ckpt = Checkpointer(ckpt_dir, max_to_keep=3)
    cleaned = list(ckpt.cleaned_on_start)
    init = {"w": torch.zeros(()), "pad": big}
    restored = ckpt.restore_latest_valid(init)
    state, start = restored if restored else (init, 0)

    class SpinAfterSave(BaseHook):
        def after_step(self, step, metrics):
            if spin_after_save and step + 1 == 4:
                pathlib.Path(ckpt_dir, "saved_marker").touch()
                time.sleep(600)  # hold still; the parent kills us here

    loop = TrainLoop(
        step_fn, state, iter(lambda: {"x": 0.0}, 1),
        hooks=[CheckpointHook(ckpt, 4, async_save=True), SpinAfterSave(),
               StopAtStepHook(8)],
        start_step=start, device="cpu")
    final = loop.run()
    ckpt.close()
    return {"resumed_from": start, "w": float(final["w"]),
            "cleaned": cleaned}


# ---- the 4-rank job of tests/test_torch_multislice.py --------------------------

MS_DIM = 6
MS_K, MS_BATCH, MS_MU, MS_OLR, MS_ILR, MS_ROUNDS = 3, 64, 0.9, 0.7, 0.05, 3


def ms_problem(seed: int = 0, n: int = 128):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, MS_DIM).astype(np.float32)
    w_true = rng.randn(MS_DIM, 1).astype(np.float32)
    return x, x @ w_true


def ms_w0(seed: int = 0) -> np.ndarray:
    """tests/test_multislice.py's initial (DIM, 1) weights."""
    rng = np.random.RandomState(100 + seed)
    return rng.randn(MS_DIM, 1).astype(np.float32) * 0.1


def ms_superbatch(x, y, k: int, world_batch: int, seed: int = 7) -> dict:
    idx = np.random.RandomState(seed).randint(0, len(x), k * world_batch)
    return {"x": x[idx].reshape(k, world_batch, MS_DIM),
            "y": y[idx].reshape(k, world_batch, 1)}


def _ms_state(momentum: float = 0.0):
    import torch

    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    from distributed_tensorflow_guide_tpu_torch import bridge

    model = torch.nn.Linear(MS_DIM, 1, bias=False)
    model.load_state_dict(bridge.regression_from_flax({"w": ms_w0()}))
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=MS_ILR,
                                             momentum=momentum))


def _ms_loss(module, batch):
    pred = batch["x"] @ module.weight.t()
    return ((pred - batch["y"]) ** 2).mean(), {}


def multislice_job() -> dict:
    """Two slices of two ranks: the two-tier mesh's layout, sync_period=1
    against DataParallel over the four ranks, ``MS_ROUNDS`` outer rounds
    at sync_period ``MS_K`` with Nesterov momentum, the collectives a
    round, ``outer_float_bytes``."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.multislice import (
        MultiSliceLocalSGD,
        two_tier_mesh,
    )

    rank = dist.get_rank()
    out: dict = {"rank": rank}
    mesh = two_tier_mesh(MeshSpec(), n_slices=2)
    out["names"] = list(mesh.names)
    out["shape"] = list(mesh.shape)
    out["dcn_index"] = mesh.axis("dcn").index
    out["data_index"] = mesh.axis("data").index
    out["slice_ranks"] = list(mesh.axis("data").ranks)
    try:
        two_tier_mesh(MeshSpec(), n_slices=3)
    except ValueError as e:
        out["three_slices_error"] = str(e)
    flat = build_mesh(MeshSpec(data=4))
    try:
        MultiSliceLocalSGD(flat, 1, device="cpu")
    except ValueError as e:
        out["flat_mesh_error"] = str(e)

    x, y = ms_problem()
    # sync_period 1, outer_lr 1, no momentum: sync DP over four ranks
    ms = MultiSliceLocalSGD(mesh, 1, device="cpu")
    dp = DataParallel(flat, device="cpu")
    tt = ms.replicate(ms.init(_ms_state()))
    sd = _ms_state()
    step_ms, step_dp = ms.make_train_step(_ms_loss), dp.make_train_step(
        _ms_loss)
    losses = []
    for i in range(5):
        sb = ms_superbatch(x, y, 1, 64, seed=7 + i)
        tt, m_ms = step_ms(tt, ms.shard_batch(sb))
        rows = ms.shard_batch(sb, leading_time_axis=True)
        sd, m_dp = step_dp(sd, {k: v[0] for k, v in rows.items()})
        losses.append([float(m_ms["loss"]), float(m_dp["loss"])])
    out["p1_losses"] = np.asarray(losses)
    out["p1_w_ms"] = tt.inner.model.weight.detach().numpy()
    out["p1_w_dp"] = sd.model.weight.detach().numpy()

    # the outer rounds the parent holds to the reference's two-tier step
    ms = MultiSliceLocalSGD(mesh, MS_K, outer_lr=MS_OLR,
                            outer_momentum=MS_MU, device="cpu")
    tt = ms.replicate(ms.init(_ms_state(momentum=0.9)))
    step = ms.make_train_step(_ms_loss)
    round_losses = []
    for r in range(MS_ROUNDS):
        tt, m = step(tt, ms.shard_batch(
            ms_superbatch(x, y, MS_K, MS_BATCH, seed=11 + r)))
        round_losses.append(float(m["loss"]))
    out["rounds_w"] = tt.inner.model.weight.detach().numpy()
    out["rounds_momentum"] = tt.outer_momentum["weight"].numpy()
    out["rounds_losses"] = np.asarray(round_losses)
    out["rounds_step"] = tt.inner.step
    out["float_bytes_momentum"] = ms.outer_float_bytes(tt)
    out["float_bytes_plain"] = MultiSliceLocalSGD(
        mesh, 1, device="cpu").outer_float_bytes(
            ms.init(_ms_state()))

    def calls(k, outer="on"):
        strat = MultiSliceLocalSGD(mesh, k, outer=outer, device="cpu")
        st = strat.replicate(strat.init(_ms_state()))
        with cc.trace_comm() as rec:
            strat.make_train_step(_ms_loss)(st, strat.shard_batch(
                ms_superbatch(x, y, k, 64)))
        return dict(rec.calls)

    out["calls_k1"], out["calls_k4"] = calls(1), calls(4)
    out["calls_off"] = calls(4, outer="off")
    return out


def _launch_main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--fail-rank", type=int, default=-1)
    ns = ap.parse_args()
    import torch

    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core import dist
    from distributed_tensorflow_guide_tpu_torch.core.mesh import build_mesh

    dist.initialize()
    import torch.distributed as tdist

    rank = tdist.get_rank()
    if rank == ns.fail_rank:
        print(f"rank {rank} failing on purpose", flush=True)
        return 3
    mesh = build_mesh()
    total = cc.psum(torch.tensor([float(rank)]), "data", mesh=mesh)
    print(f"rank {rank} of {tdist.get_world_size()} "
          f"backend {tdist.get_backend()} psum {total.item():g} "
          f"cuda {torch.cuda.is_available()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_launch_main())
