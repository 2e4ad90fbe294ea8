"""Mesh programs planted for the auditor's rule tests
(``tests/test_torch_analysis_mesh_rules.py``): each breaks one rule on
every rank of an 8-rank world, or none. The world's ranks find them here
through ``analysis/world.run_world(..., providers=(__name__,))``; they
never enter the registry."""

import torch
import torch.distributed as dist

from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
    CostPin,
    CostSpec,
    ProgramContract,
)
from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)

N_ELEMS = 64  # the ring model's global vector
FAILING_RANK = 3


def _mesh():
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )

    return build_mesh(MeshSpec(data=-1))


def _shard(mesh, device):
    ax = mesh.axis("data")
    full = torch.arange(N_ELEMS, dtype=torch.float32, device=device)
    return full.chunk(ax.size)[ax.index].clone()


def _build_stray(device):
    mesh = _mesh()

    def body(x):
        x = cc.psum(x, "data", mesh=mesh)
        x = cc.psum(x, "data", mesh=mesh)  # one too many
        return cc.pmax(x, "data", mesh=mesh)  # never declared

    return body, (_shard(mesh, device),)


def _build_one_psum(device):
    mesh = _mesh()
    return (lambda x: cc.psum(x, "data", mesh=mesh)), (_shard(mesh, device),)


def _build_raw_all_reduce(device):
    mesh = _mesh()

    def body(x):
        y = cc.psum(x, "data", mesh=mesh)
        dist.all_reduce(y)  # around collectives.py: a bypass
        return y

    return body, (_shard(mesh, device),)


def _build_raises(device):
    mesh = _mesh()

    def body(x):
        if dist.get_rank() == FAILING_RANK:
            raise RuntimeError(f"planted failure on rank {FAILING_RANK}")
        return cc.psum(x, "data", mesh=mesh)

    return body, (_shard(mesh, device),)


def _ring_expect():
    n = dist.get_world_size()
    return 2.0 * (N_ELEMS // n * 4) * (n - 1) / n


def lint_contracts():
    return [
        ProgramContract(name="viol_stray_psum", build=_build_stray,
                        collectives={"psum[data]": 1}, world=8),
        ProgramContract(name="ok_range", build=_build_one_psum,
                        collectives={"psum[data]": (1, 2)}, world=8),
        ProgramContract(name="ok_census", build=_build_one_psum,
                        collectives=None, world=8),
        ProgramContract(name="viol_raw_all_reduce",
                        build=_build_raw_all_reduce,
                        collectives={"psum[data]": 1}, world=8),
        ProgramContract(
            name="ring_model", build=_build_one_psum,
            collectives={"psum[data]": 1}, world=8,
            cost=CostSpec(pins=(
                CostPin("collective_bytes[psum[data]]", _ring_expect),
                # an absent key reads 0.0: the exact-zero pin
                CostPin("collective_bytes[psum[dcn]]", 0.0),
            ))),
        # the last two: a rank that raises ends the world
        ProgramContract(name="viol_rank_raises", build=_build_raises,
                        collectives={"psum[data]": 1}, world=8),
        ProgramContract(name="after_the_failure", build=_build_one_psum,
                        collectives={"psum[data]": 1}, world=8),
    ]
