"""Unified run configuration — one dataclass + CLI, identical on every rank.

The JAX package's ``core/config.py``, on the port's ``MeshSpec`` (the same
five axes). The whole topology is ordinary config and every rank runs the
same command line; what a rank needs to join its group (address, rank,
world size) stays in the environment, where launchers put it
(``core/dist.py``).

The fields are the JAX package's, all of them, so that a ``RunConfig``
JSON written by either package loads in the other (``from_dict`` refuses
unknown keys). Two of them mean something else here, and
:meth:`RunConfig.apply_platform` says what: ``fake_devices`` selects the
CPU, and ``xla_overlap`` (XLA's async-collective flag set) has no PyTorch
meaning and is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Any, Sequence

from distributed_tensorflow_guide_tpu_torch.core.mesh import MeshSpec


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything a training run needs, serializable, mesh included."""

    mesh: MeshSpec = MeshSpec()
    steps: int = 1000
    global_batch: int = 256
    lr: float = 1e-3
    seed: int = 0
    log_every: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 500
    metrics_path: str | None = None
    tb_logdir: str | None = None
    profile_dir: str | None = None
    fake_devices: int = 0  # >0: run on the CPU (apply_platform)
    xla_overlap: int = 0   # the JAX package's XLA flag set: refused here

    # -- CLI --------------------------------------------------------------

    @classmethod
    def parser(cls, parser: argparse.ArgumentParser | None = None
               ) -> argparse.ArgumentParser:
        p = parser or argparse.ArgumentParser(
            description="dtg run config (SPMD: same flags on every rank)")
        for f in dataclasses.fields(cls):
            if f.name == "mesh":
                continue
            # `from __future__ import annotations` makes f.type a string
            typ = {"int": int, "float": float}.get(str(f.type), str)
            p.add_argument(f"--{f.name.replace('_', '-')}", type=typ,
                           default=f.default, dest=f.name)
        for ax in dataclasses.fields(MeshSpec):
            p.add_argument(f"--mesh-{ax.name}", type=int, default=ax.default,
                           dest=f"mesh_{ax.name}",
                           help=f"mesh axis {ax.name!r} size (-1 = fill)")
        return p

    @classmethod
    def from_argv(cls, argv: Sequence[str] | None = None) -> "RunConfig":
        ns = cls.parser().parse_args(argv)
        mesh = MeshSpec(**{ax.name: getattr(ns, f"mesh_{ax.name}")
                           for ax in dataclasses.fields(MeshSpec)})
        kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)
              if f.name != "mesh"}
        # optional paths parse as str; treat explicit ""/"None" as unset
        for k in ("ckpt_dir", "metrics_path", "tb_logdir", "profile_dir"):
            if kw[k] in (None, "", "None"):
                kw[k] = None
        return cls(mesh=mesh, **kw)

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RunConfig":
        d = dict(d)
        mesh = MeshSpec(**d.pop("mesh", {}))
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown RunConfig keys: {sorted(unknown)}")
        return cls(mesh=mesh, **d)

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "RunConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    # -- environment application ------------------------------------------

    def apply_platform(self) -> str | None:
        """The ``device`` to hand the entry points: ``"cpu"`` where
        ``fake_devices > 0``, else None (this rank's card; the entry
        points raise without one). The JAX package makes N virtual CPU
        devices there; here a process is a rank, and N CPU ranks come from
        ``runtime/multiprocess.run_multiprocess`` (or ``launch.py -n N
        --device cpu``), not from this config.

        ``xla_overlap`` is a set of XLA compiler flags with no PyTorch
        meaning: a config that asks for it raises ``ValueError`` (the
        port's overlap is ``DataParallel(overlap=True)``, a choice of the
        step, not of the platform)."""
        if self.xla_overlap:
            raise ValueError(
                "xla_overlap=1 sets XLA's async-collective flags, which "
                "have no PyTorch meaning; use DataParallel(overlap=True) "
                "for the bucketed backward all-reduce")
        return "cpu" if self.fake_devices else None
