"""The port's counterpart of the repository root's ``__graft_entry__.py``.

* :func:`entry` — the flagship forward: GPT-2 124M at bf16 compute (its
  f32 masters cast at each product, as the port's models hold them),
  causal LM logits, with example tokens. On the card, at S = 1024 the
  attention takes K1 once a layer.
* :func:`dryrun_multichip` — one real step of each sharding mode of the
  JAX package's dryrun, at its tiny shapes (vocab 128, 4 layers, 4 heads,
  d_model 32, d_ff 64, max_len 32, f32), in ONE world of ``n`` processes
  over gloo: the port has no virtual devices, so a device of the JAX
  mesh is a rank here. Rank 0 prints each mode's line in its twin's
  format and, once every rank has finished every mode, the twin's last
  line.

Each mode is a function of its own (:data:`MODES`, in the reference's
order) on a :class:`World`: the world size, the device, the numpy inputs
(:func:`draw_inputs`: the reference's draws from one
``np.random.RandomState(0)``, in its order, so the inputs equal its
own), and the meshes built so far. A mode that starts from weights takes
them as a full state dict in the port's layout (a test passes the JAX
package's, bridged) and otherwise draws them from a seed, the number of
the reference's ``PRNGKey`` for that mode. A mode returns its line and
its loss, or None where the world's size skips it (the reference's
``n % 2`` and ``n % 8`` conditions).

Where the port differs: the ring attention of mode 8 (S_local = 8) runs
K4 on the card, which masks the ragged tile, so the reference's warning
line about falling back to its XLA path is not printed; the MoE steps
(modes 6 and 7) apply the global loss's gradient, where the reference's
apply n times it (its ``shard_map(check_vma=False)`` transposes each
forward ``psum`` into another ``psum``, n the token shards), so only
their first loss, the one printed, agrees with the reference's on equal
weights.

Import discipline: torch only; nothing here imports the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import sys
import traceback

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    gpt2_124m,
)

#: the world's deadline, seconds: process start, every mode, exit
WORLD_TIMEOUT_S = 900.0
LAST_LINE = "dryrun_multichip({n}): all sharding modes compiled and ran"
#: what each rank of a started world runs (``runtime/multiprocess``)
RANK_TARGET = f"{__name__}:rank_main"
_RESULT_PREFIX = "DTG_MP_RESULT "


def entry(device=None):
    """``(forward, (model, tokens))``: GPT-2 124M (``gpt2_124m`` at bf16,
    weights from seed 0) on ``device`` (default this rank's card; raises
    without one unless ``device="cpu"``), ``tokens = ones((4, 1024))``
    int64, and ``forward(model, tokens)`` -> the (B, S, V) f32 LM
    logits."""
    dev = resolve_device(device)
    cfg = gpt2_124m(dtype=torch.bfloat16)
    model = Transformer(cfg).init_weights(0).to(dev)
    tokens = torch.ones((4, cfg.max_len), dtype=torch.int64, device=dev)

    def forward(model, tokens):
        return model(tokens)

    return forward, (model, tokens)


def tiny_cfg(**kw) -> TransformerConfig:
    """The reference's ``_tiny_cfg`` (``__graft_entry__.py:43``)."""
    defaults = dict(vocab_size=128, num_layers=4, num_heads=4, d_model=32,
                    d_ff=64, max_len=32, causal=True, dtype=torch.float32)
    return TransformerConfig(**{**defaults, **kw})


def _four_two_one(n: int) -> int:
    """The reference's axis rule: 4 where n divides by 4, else 2 where it
    divides by 2, else 1."""
    return 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1


def draw_inputs(n: int) -> dict[str, np.ndarray]:
    """Every mode's numpy inputs for a world of ``n``, drawn from one
    ``np.random.RandomState(0)`` in the reference's order (its casts
    included: int32 tokens, f32 floats)."""
    rng = np.random.RandomState(0)
    V, S = tiny_cfg().vocab_size, tiny_cfg().max_len
    n_pipe = _four_two_one(n)
    out = {"tokens": rng.randint(0, V, (4 * (n // n_pipe), S)).astype(
        np.int32)}
    if n % 2 == 0:
        out["tokens_il"] = rng.randint(0, V, (4 * (n // 2), S)).astype(
            np.int32)
    if n % 8 == 0:
        out["tokens_3d"] = rng.randint(0, V, (4 * (n // 4), S)).astype(
            np.int32)
    out["tp_tokens"] = rng.randint(0, 128, (8, S)).astype(np.int32)
    out["tp_label"] = rng.randint(0, 2, 8).astype(np.int32)
    out["ep_x"] = rng.randn(16 * n, 16).astype(np.float32)
    out["slm_tokens"] = rng.randint(0, V, (2 * n, 16)).astype(np.int32)
    out["sp_q"] = rng.randn(2, 8 * n_pipe, 4, 16).astype(np.float32)
    out["x_all"] = rng.randn(2, 4 * n, 8).astype(np.float32)
    out["y_all"] = np.tanh(out["x_all"][..., :1]).astype(np.float32)
    out["flash_q"] = rng.randn(2 * n, 128, 2, 8).astype(np.float32)
    out["prompts"] = rng.randint(0, V, (2 * n, 4)).astype(np.int32)
    return out


class MLP(nn.Module):
    """The reference's ``_MLP``: Dense(16) -> relu -> Dense(1) on 8
    features (``bridge.mlp_from_flax`` maps its weights)."""

    def __init__(self):
        super().__init__()
        self.dense0 = nn.Linear(8, 16)
        self.dense1 = nn.Linear(16, 1)

    def forward(self, x):
        return self.dense1(torch.relu(self.dense0(x)))

    def init_weights(self, seed: int) -> "MLP":
        """flax's Dense default: lecun-normal kernels, zero biases."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in (self.dense0, self.dense1):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                                 / lin.in_features ** 0.5)
                lin.bias.zero_()
        return self


def mlp_loss(module, batch):
    """The reference's ``mlp_loss``: mean squared error, no metrics."""
    pred = module(batch["x"])
    return torch.mean((pred - batch["y"]) ** 2), {}


@dataclasses.dataclass
class World:
    """What the modes of one rank share: the world size, the device, the
    numpy inputs, the meshes built so far (each built once, every rank in
    the same order), and mode 1's pipeline, which modes 14-16 continue."""

    n: int
    device: torch.device
    inputs: dict
    meshes: dict = dataclasses.field(default_factory=dict)
    pipeline: tuple | None = None

    def mesh(self, **axes):
        """The mesh of ``MeshSpec(data=-1, **axes)``, built on first use."""
        from distributed_tensorflow_guide_tpu_torch.core.mesh import (
            MeshSpec,
            build_mesh,
        )

        key = tuple(sorted(axes.items()))
        if key not in self.meshes:
            self.meshes[key] = build_mesh(MeshSpec(data=-1, **axes))
        return self.meshes[key]

    def rows(self, x: np.ndarray, mesh, axis="data", dim: int = 0):
        """This rank's rows (along ``dim``) of a global array sharded over
        ``axis`` of ``mesh``, as a tensor on the device."""
        ax = mesh.axis(axis)
        per = x.shape[dim] // ax.size
        part = np.take(x, range(ax.index * per, (ax.index + 1) * per),
                       axis=dim)
        t = torch.from_numpy(np.ascontiguousarray(part))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(self.device)


def _loss(x) -> float:
    value = float(x)
    if not np.isfinite(value):
        raise FloatingPointError(f"loss {value} is not finite")
    return value


def _finite(t: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"{what}: non-finite values")


def _adam(lr: float):
    return functools.partial(torch.optim.Adam, lr=lr)


# ---- 1-4: the pipeline family -----------------------------------------------


def _pipeline_step(w: World, mesh, tokens, seed, weights, **kw):
    from distributed_tensorflow_guide_tpu_torch.parallel.pipeline import (
        PipelinedLM,
    )

    pp = PipelinedLM(mesh, tiny_cfg(), 2, device=w.device, **kw)
    module = (pp.init_params(seed) if weights is None
              else pp.shard_params(weights))
    opt = pp.init_opt_state(_adam(1e-3), module)
    share = {"tokens": w.rows(tokens, mesh)}
    _, m = pp.make_train_step(opt)(module, share)
    return pp, module, opt, share, _loss(m["loss"])


def gpipe(w: World, weights=None) -> dict:
    """Mode 1: dp x pp GPipe (``__graft_entry__.py:101``), 2
    microbatches, Adam 1e-3, seed 0. Modes 14-16 continue from it."""
    n_pipe = _four_two_one(w.n)
    mesh = w.mesh(pipe=n_pipe)
    pp, module, opt, share, loss = _pipeline_step(
        w, mesh, w.inputs["tokens"], 0, weights)
    w.pipeline = (pp, module, opt, share)
    return {"line": f"dp({pp.n_data})xpp({n_pipe}) pipeline step: "
                    f"loss={loss:.3f}", "loss": loss}


def interleaved_gpipe(w: World, weights=None) -> dict | None:
    """Mode 2: interleaved GPipe at pipe 2, v 2 (``:118``), seed 4."""
    if w.n % 2:
        return None
    *_, loss = _pipeline_step(w, w.mesh(pipe=2), w.inputs["tokens_il"], 4,
                              weights, virtual_chunks=2)
    return {"line": f"interleaved pp(2, v=2) pipeline step: "
                    f"loss={loss:.3f}", "loss": loss}


def interleaved_1f1b(w: World, weights=None) -> dict | None:
    """Mode 3: interleaved 1F1B at pipe 2, v 2 (``:134``), seed 6, on
    mode 2's tokens."""
    if w.n % 2:
        return None
    *_, loss = _pipeline_step(w, w.mesh(pipe=2), w.inputs["tokens_il"], 6,
                              weights, schedule="1f1b", virtual_chunks=2)
    return {"line": f"interleaved-1f1b pp(2, v=2) pipeline step: "
                    f"loss={loss:.3f}", "loss": loss}


def three_d(w: World, weights=None) -> dict | None:
    """Mode 4: dp x tp x pp with interleaved 1F1B (``:145``), TP-sharded
    stages at model 2, pipe 2, v 2, seed 7."""
    if w.n % 8:
        return None
    mesh = w.mesh(pipe=2, model=2)
    pp, *_, loss = _pipeline_step(w, mesh, w.inputs["tokens_3d"], 7,
                                  weights, schedule="1f1b",
                                  virtual_chunks=2)
    return {"line": f"3d dp({pp.n_data})xtp(2)xpp(2) interleaved-1f1b "
                    f"step: loss={loss:.3f}", "loss": loss}


# ---- 5-7: tensor and expert parallelism -------------------------------------


def tensor_parallel(w: World, weights=None) -> dict:
    """Mode 5: the TP step of a 2-class classifier over ``model`` x
    ``data`` (``:162``), Adam 1e-3, seed 1."""
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        make_cls_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
        TensorParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import (
        TrainState,
    )

    n_model = _four_two_one(w.n)
    mesh = w.mesh(model=n_model)
    tp = TensorParallel(mesh, device=w.device)
    full = Transformer(tiny_cfg(causal=False, num_classes=2))
    if weights is None:
        full.init_weights(1)
    else:
        full.load_state_dict(weights)
    local = tp.shard(full)
    state = TrainState(local, torch.optim.Adam(local.parameters(), lr=1e-3))
    batch = {"tokens": w.rows(w.inputs["tp_tokens"], mesh),
             "label": w.rows(w.inputs["tp_label"], mesh)}
    _, m = tp.make_train_step(make_cls_loss_fn(local))(state, batch)
    loss = _loss(m["loss"])
    return {"line": f"tp({n_model}) pjit step: loss={loss:.3f}",
            "loss": loss}


def expert_parallel(w: World, weights=None) -> dict:
    """Mode 6: one MoE layer's SGD step over ``data`` x ``expert``
    (``:189``): 2 experts a rank, top 2, capacity factor 2, lr 0.05,
    target tanh(x); weights ({router, w_in, w_out}) from seed 2."""
    from distributed_tensorflow_guide_tpu_torch.parallel.expert import (
        ExpertParallel,
        MoEConfig,
        init_moe_params,
    )

    n_exp = _four_two_one(w.n)
    mesh = w.mesh(expert=n_exp)
    cfg = MoEConfig(d_model=16, d_ff=32, num_experts=2 * n_exp, top_k=2,
                    capacity_factor=2.0)
    ep = ExpertParallel(mesh, cfg, device=w.device)
    params = ep.shard_params(
        init_moe_params(cfg, torch.Generator().manual_seed(2))
        if weights is None else weights)
    x = torch.from_numpy(w.inputs["ep_x"])
    _, m = ep.make_train_step(lr=0.05)(params, ep.token_shard(x),
                                       ep.token_shard(torch.tanh(x)))
    loss = _loss(m["loss"])
    return {"line": f"ep({n_exp}) MoE all_to_all step: loss={loss:.3f}",
            "loss": loss}


def switch_lm(w: World, weights=None) -> dict:
    """Mode 7: the Switch-MoE LM step on ``data`` x ``expert``
    (``:209``): 2 heads, max_len 16, one expert a rank of the expert
    axis, top 1, Adam 1e-3, seed 5."""
    from distributed_tensorflow_guide_tpu_torch.models.moe_lm import SwitchLM

    n_exp = _four_two_one(w.n)
    mesh = w.mesh(expert=n_exp)
    slm = SwitchLM(mesh, tiny_cfg(num_heads=2, max_len=16),
                   num_experts=n_exp, top_k=1, device=w.device)
    module = (slm.init_params(5) if weights is None
              else slm.shard_params(weights))
    opt = slm.init_opt_state(_adam(1e-3), module)
    _, m = slm.make_train_step(opt)(
        module, slm.token_shard(w.inputs["slm_tokens"].astype(np.int64)))
    loss = _loss(m["loss"])
    return {"line": f"switch-moe-lm(data x expert={n_exp}) step: "
                    f"loss={loss:.3f}", "loss": loss}


# ---- 8: sequence parallelism ------------------------------------------------


def ring_sp(w: World, weights=None) -> dict:
    """Mode 8: causal ring attention forward and backward over
    ``context`` (``:228``), q = k = v, the gradient of sum(out ** 2)."""
    from distributed_tensorflow_guide_tpu_torch.parallel.sequence import (
        ring_attention,
    )

    n_ctx = _four_two_one(w.n)
    mesh = w.mesh(context=n_ctx)
    q = w.rows(w.inputs["sp_q"], mesh, "context", dim=1).requires_grad_()
    with mesh:
        out = ring_attention(q, q, q, causal=True)
        (out ** 2).sum().backward()
    _finite(q.grad, "ring attention gradient")
    return {"line": f"sp({n_ctx}) ring attention fwd+bwd: ok", "loss": None}


# ---- 9-12: the async family and FSDP on the MLP -----------------------------


def _mlp_state(w: World, seed: int, weights):
    from distributed_tensorflow_guide_tpu_torch.train.state import (
        TrainState,
    )

    model = MLP()
    if weights is None:
        model.init_weights(seed)
    else:
        model.load_state_dict(weights)
    model = model.to(w.device)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-2))


def _mlp_batches(w: World, mesh, time_axis: bool) -> dict:
    """This rank's rows of (x_all, y_all): both sub-batches (K, B / n, F)
    with ``time_axis``, else the first's (B / n, F)."""
    x, y = w.inputs["x_all"], w.inputs["y_all"]
    if time_axis:
        return {"x": w.rows(x, mesh, dim=1), "y": w.rows(y, mesh, dim=1)}
    return {"x": w.rows(x[0], mesh), "y": w.rows(y[0], mesh)}


def local_sgd(w: World, weights=None) -> dict:
    """Mode 9: LocalSGD, 2 local Adam 1e-2 steps, then the parameter and
    moment average (``:275``), the MLP from seed 3."""
    from distributed_tensorflow_guide_tpu_torch.parallel.async_ps import (
        LocalSGD,
    )

    mesh = w.mesh()
    step = LocalSGD(mesh, 2, device=w.device).make_train_step(mlp_loss)
    _, m = step(_mlp_state(w, 3, weights), _mlp_batches(w, mesh, True))
    loss = _loss(m["loss"])
    return {"line": f"async LocalSGD({w.n} replicas, sync_period=2) step: "
                    f"loss={loss:.3f}", "loss": loss}


def gossip_sgd(w: World, weights=None) -> dict:
    """Mode 10: GossipSGD, one local step, then ring mixing (``:284``)."""
    from distributed_tensorflow_guide_tpu_torch.parallel.async_ps import (
        GossipSGD,
    )

    mesh = w.mesh()
    gossip = GossipSGD(mesh, device=w.device)
    state = gossip.distribute(_mlp_state(w, 3, weights))
    _, m = gossip.make_train_step(mlp_loss)(
        state, _mlp_batches(w, mesh, False))
    loss = _loss(m["loss"])
    return {"line": f"async GossipSGD({w.n} replicas, ring mixing) step: "
                    f"loss={loss:.3f}", "loss": loss}


def accumulated_adaptive(w: World, weights=None) -> dict:
    """Mode 11: AccumulatedAdaptive over 2 sub-batches (``:293``)."""
    from distributed_tensorflow_guide_tpu_torch.parallel.async_ps import (
        AccumulatedAdaptive,
    )

    mesh = w.mesh()
    step = AccumulatedAdaptive(mesh, 2, device=w.device).make_train_step(
        mlp_loss)
    _, m = step(_mlp_state(w, 3, weights), _mlp_batches(w, mesh, True))
    loss = _loss(m["loss"])
    return {"line": f"async AccumulatedAdaptive({w.n} replicas, accum=2) "
                    f"step: loss={loss:.3f}", "loss": loss}


def fsdp(w: World, weights=None) -> dict:
    """Mode 12: ZeRO-3 over ``data`` with shards from 64 elements
    (``:302``), Adam 1e-2, the MLP from seed 4."""
    from distributed_tensorflow_guide_tpu_torch.parallel.fsdp import FSDP
    from distributed_tensorflow_guide_tpu_torch.train.state import (
        TrainState,
    )

    mesh = w.mesh()
    f = FSDP(mesh, min_shard_size=2 ** 6, device=w.device)
    model = MLP()
    if weights is None:
        model.init_weights(4)
    else:
        model.load_state_dict(weights)
    local = f.shard(model)
    state = TrainState(local, torch.optim.Adam(local.parameters(), lr=1e-2))
    _, m = f.make_train_step(mlp_loss)(state, _mlp_batches(w, mesh, False))
    loss = _loss(m["loss"])
    return {"line": f"fsdp({w.n}) ZeRO-3 sharded step: loss={loss:.3f}",
            "loss": loss}


# ---- 13: flash attention under data parallelism -----------------------------


def flash_dp(w: World, weights=None) -> dict:
    """Mode 13: causal flash attention forward and backward on this
    rank's rows (``:321``): hd 8, S 128, f32 (K1-K3 on the card)."""
    from distributed_tensorflow_guide_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    q = w.rows(w.inputs["flash_q"], w.mesh()).requires_grad_()
    (flash_attention(q, q, q, causal=True) ** 2).sum().backward()
    _finite(q.grad, "flash attention gradient")
    return {"line": f"flash under shard_map (data={w.n}) fwd+bwd: ok",
            "loss": None}


# ---- 14-16: continuing from mode 1 ------------------------------------------


def pipeline_eval_and_steps_per_call(w: World, weights=None) -> dict:
    """Modes 14 and 15 (``:338``): mode 1's eval step on its weights, then
    two optimizer steps in one call on a copy of its module and optimizer
    (mode 16 generates from the weights of mode 1's one step, as the
    reference's functional step leaves them)."""
    pp, module, opt, share = w.pipeline
    _loss(pp.make_eval_step()(module, share)["loss"])
    twin = copy.deepcopy(module)
    opt2 = torch.optim.Adam(twin.parameters(), lr=1e-3,
                            capturable=w.device.type == "cuda")
    opt2.load_state_dict(copy.deepcopy(opt.state_dict()))
    _, m = pp.make_train_step(opt2, steps_per_call=2)(twin, share)
    loss = _loss(m["loss"])
    return {"line": f"pipeline eval + steps_per_call(2): loss={loss:.3f}",
            "loss": loss}


def sharded_generation(w: World, weights=None) -> dict:
    """Mode 16 (``:348``): the one-shot generator, greedy, 3 new tokens,
    on mode 1's weights gathered whole, each rank its share of the
    prompts already on the device; the rows gathered back over
    ``data``."""
    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.models.generation import (
        make_generate_fn,
    )

    pp, module, _, _ = w.pipeline
    cfg = tiny_cfg()
    serving = pp.to_serving_params(module)
    model = Transformer(cfg)
    model.load_state_dict(serving)
    model = model.to(w.device)
    mesh = w.mesh()
    prompts = w.rows(w.inputs["prompts"], mesh)
    gen = make_generate_fn(cfg, max_new_tokens=3, temperature=0.0,
                           device=w.device)
    out = gen(model, prompts, torch.zeros(2, dtype=torch.int64,
                                          device=w.device))
    rows = cc.all_gather(out, "data", tiled=True, mesh=mesh)
    want = (2 * w.n, prompts.shape[1] + 3)
    if tuple(rows.shape) != want or not bool(
            ((rows >= 0) & (rows < cfg.vocab_size)).all()):
        raise ValueError(f"generation gave {tuple(rows.shape)} rows, want "
                         f"{want} tokens in the vocabulary")
    return {"line": f"dp({w.n})-sharded KV-cache generation from "
                    "pipeline-trained params: ok", "loss": None}


#: the modes in the reference's order
MODES = (gpipe, interleaved_gpipe, interleaved_1f1b, three_d,
         tensor_parallel, expert_parallel, switch_lm, ring_sp, local_sgd,
         gossip_sgd, accumulated_adaptive, fsdp, flash_dp,
         pipeline_eval_and_steps_per_call, sharded_generation)


def rank_main(n: int, device) -> None:
    """One rank of the dryrun's world of ``n`` (the process group joined;
    the ``runtime/multiprocess`` target): every mode of :data:`MODES` in
    order, rank 0 printing each line as its mode ends, then, after a
    barrier that only a world whose every rank finished passes, the last
    line. A mode that raises prints its traceback and ends this process
    at once, so its peers, blocked on it in a collective, fail fast
    instead of waiting out the deadline."""
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.ops import autotune

    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    autotune.set_online_tune(False)  # a tuning sweep is not a mode's step
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        w = World(n, dev, draw_inputs(n))
        for mode in MODES:
            res = mode(w)
            if res is not None and rank == 0:
                print(res["line"], flush=True)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
    except Exception:  # the world's boundary: report, then leave
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    if rank == 0:
        print(LAST_LINE.format(n=n), flush=True)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One real step of each sharding mode in one world of ``n_devices``
    gloo ranks, on ``device`` (default each rank's card, which the ranks
    of a one-card machine share; raises without one unless
    ``device="cpu"``). Inside a world of ``n_devices`` ranks (``launch.py``,
    ``runtime/multiprocess``) the ranks are the world; elsewhere it starts
    the world through ``runtime/multiprocess`` and prints rank 0's lines.
    Raises with the failing ranks' tracebacks where a rank fails; the last
    line is then never printed."""
    import torch.distributed as tdist

    from distributed_tensorflow_guide_tpu_torch.core import dist
    from distributed_tensorflow_guide_tpu_torch.runtime.multiprocess import (
        MultiProcessRunner,
    )

    resolve_device(device)  # no card and no device="cpu": raise here
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks > 1 or tdist.is_initialized():
        if ranks != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a "
                             f"world of {ranks} ranks")
        dist.initialize()
        rank_main(n_devices, device)
        return
    runner = MultiProcessRunner(
        RANK_TARGET, n_devices,
        [n_devices, None if device is None else str(device)],
        timeout=WORLD_TIMEOUT_S)
    # a failed world: its peers get a moment to report, then are killed
    results = runner.start().join(raise_on_error=False, failure_grace=3.0)
    sys.stdout.write("".join(
        ln for ln in results[0].stdout.splitlines(keepends=True)
        if not ln.startswith(_RESULT_PREFIX)))
    sys.stdout.flush()
    bad = [r for r in results if not r.ok]
    if bad:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): {len(bad)} of {n_devices} "
            "ranks failed:\n" + "\n".join(
                f"--- rank {r.rank} (exit {r.returncode}) ---\n"
                f"{r.stderr[-3000:]}" for r in bad))
