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


# ---- the launcher test's script ----------------------------------------------


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
