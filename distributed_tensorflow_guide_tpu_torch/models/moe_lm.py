"""The Switch-Transformer LM: the JAX package's ``models/moe_lm.py`` in
PyTorch, the model that uses ``parallel/expert.py``.

A causal LM whose every block's FFN is the routed MoE FFN (Switch
Transformer, Fedus et al. 2021), trained over a ``data x expert`` mesh:
batch rows are sharded jointly over both axes, each rank holds its
``E / expert`` experts of every layer's stacks, and everything else (the
embeddings, the attention half-blocks, the LayerNorms, the router, the
head) is replicated. The attention half-block is the port's
``MultiHeadAttention``, so ``cfg.attn_impl`` takes the flash kernels
K1-K3. The loss is the global mean next-token NLL (fused
cross-entropy where ``fused_ce`` resolves on) plus ``aux_weight`` x
(load balance + router z loss), each averaged over the layers.

Gradients are the global loss's (see ``parallel/expert.py``): the
replicated leaves' are summed over both token axes, the expert stacks'
over ``data``; the optimizer (a ``torch.optim`` one over this rank's
module) keeps its moments beside each parameter, shaped like it, so an
expert stack's moments are this rank's shard.

Initialisation: the embeddings, attention, LayerNorms and head as the
port's ``Transformer.init_weights`` draws them; the router and stacks as
``parallel/expert.init_moe_params`` (normal at 1/√fan-in, stored at
``cfg.dtype`` as the reference stores them). A seed gives the same
weights on every rank and device.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core import (
    precision as precision_mod,
)
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    LayerNorm,
    MultiHeadAttention,
    TransformerConfig,
    _linear,
)
from distributed_tensorflow_guide_tpu_torch.ops.fused_ce import (
    fused_next_token_loss,
    resolve_fused_ce,
)
from distributed_tensorflow_guide_tpu_torch.parallel.expert import (
    MoEConfig,
    init_moe_params,
    moe_ffn,
)

__all__ = ["SwitchLM", "SwitchLMParams"]


class _SwitchBlock(nn.Module):
    """The attention half-block, x + attn(LN1(x)), and the LayerNorm in
    front of the routed FFN."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = MultiHeadAttention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype)


class _Embed(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)


class _Head(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)


class _Experts(nn.Module):
    """Every layer's router (L, d, E) and this rank's expert stacks (L,
    E_local, d, ff) / (L, E_local, ff, d)."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig,
                 e_local: int):
        super().__init__()
        L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(
            torch.zeros(L, d, moe.num_experts, dtype=moe.dtype))
        self.w_in = nn.Parameter(
            torch.zeros(L, e_local, d, ff, dtype=moe.dtype))
        self.w_out = nn.Parameter(
            torch.zeros(L, e_local, ff, d, dtype=moe.dtype))


class SwitchLMParams(nn.Module):
    """What one rank holds: ``embed``, ``blocks`` (ln1, attn, ln2 a
    layer), ``moe`` (the stacked router and this rank's experts),
    ``head`` (ln_f, an f32 ``lm_head`` without bias)."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig,
                 e_local: int):
        super().__init__()
        self.embed = _Embed(cfg)
        self.blocks = nn.ModuleList(_SwitchBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.moe = _Experts(cfg, moe, e_local)
        self.head = _Head(cfg)


class SwitchLM:
    """Causal Switch-MoE LM over the ``data x expert`` mesh axes.

    ``top_k``, ``capacity_factor`` and ``router`` ("switch" or
    "dropless") are ``parallel/expert.MoEConfig``'s; ``dispatch="onehot"``
    routes through the reference's one-hot algebra (the plain version).
    ``fused_ce`` resolves against the device (``ops/fused_ce.py``);
    ``precision`` is a ``core/precision.py`` policy applied to ``cfg``.
    ``device=None`` is the CUDA card (raises without one).

    Every rank builds the object with the same arguments and calls each
    step together with its share of the batch (:meth:`token_shard`: B
    divisible by data x expert).
    """

    def __init__(self, mesh: Mesh, cfg: TransformerConfig,
                 num_experts: int, *, top_k: int = 1,
                 capacity_factor: float = 2.0, router: str = "switch",
                 aux_weight: float = 1e-2, fused_ce="auto",
                 ce_chunk: int | None = None, precision=None,
                 dispatch: str = "index", device=None):
        if precision is not None:
            cfg = precision_mod.resolve(precision).apply_to_transformer(cfg)
        n_expert = mesh.axis("expert").size
        if num_experts % n_expert:
            raise ValueError(
                f"num_experts {num_experts} not divisible by expert axis "
                f"size {n_expert}")
        self.mesh = mesh
        self.cfg = cfg
        self.n_expert = n_expert
        self.aux_weight = aux_weight
        self.moe_cfg = MoEConfig(
            d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=num_experts,
            top_k=top_k, capacity_factor=capacity_factor, router=router,
            dtype=cfg.dtype, dispatch=dispatch)
        self.device = resolve_device(device)
        self.fused_ce = resolve_fused_ce(fused_ce, vocab_size=cfg.vocab_size,
                                         platform=self.device.type)
        self.ce_chunk = ce_chunk

    # -- parameters -----------------------------------------------------------
    def _module(self) -> SwitchLMParams:
        return SwitchLMParams(self.cfg, self.moe_cfg,
                              self.moe_cfg.num_experts // self.n_expert)

    def expert_slice(self) -> slice:
        per = self.moe_cfg.num_experts // self.n_expert
        i = self.mesh.axis("expert").index
        return slice(i * per, (i + 1) * per)

    def shard_params(self, full: Mapping[str, torch.Tensor]
                     ) -> SwitchLMParams:
        """This rank's module on the device from a state dict with every
        expert (``bridge.switch_lm_from_flax``, :meth:`init_state_dict`):
        its experts' rows of the stacks, the rest whole."""
        sl = self.expert_slice()
        local = {k: (t[:, sl] if k in ("moe.w_in", "moe.w_out") else t)
                 for k, t in full.items()}
        with torch.device("meta"):
            module = self._module()
        module.load_state_dict(
            {k: t.detach().clone() for k, t in local.items()}, assign=True)
        return module.to(self.device)

    def init_state_dict(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """The whole model's weights from ``seed``, on the CPU, with every
        expert."""
        gen = torch.Generator().manual_seed(seed)
        cfg, moe = self.cfg, self.moe_cfg
        with torch.device("meta"):
            full = SwitchLMParams(cfg, moe, moe.num_experts)
        sd = {}
        for name, p in full.named_parameters():
            if name.startswith("moe."):
                continue
            if name.endswith("bias"):
                sd[name] = torch.zeros(p.shape)
            elif ".ln" in name:
                sd[name] = torch.ones(p.shape)
            else:
                sd[name] = torch.randn(p.shape, generator=gen) * 0.02
        layers = [init_moe_params(moe, gen) for _ in range(cfg.num_layers)]
        for name in ("router", "w_in", "w_out"):
            sd[f"moe.{name}"] = torch.stack([lp[name] for lp in layers])
        return sd

    def init_params(self, seed: int = 0) -> SwitchLMParams:
        """This rank's module of :meth:`init_state_dict`'s weights."""
        return self.shard_params(self.init_state_dict(seed))

    def init_opt_state(self, tx, module: SwitchLMParams
                       ) -> torch.optim.Optimizer:
        """The optimizer over this rank's parameters: ``tx`` takes the
        parameters, e.g. ``functools.partial(torch.optim.Adam, lr=1e-3)``."""
        return tx(module.parameters())

    def token_shard(self, tokens) -> torch.Tensor:
        """This rank's rows of a global (B, S) batch."""
        ax = self.mesh.axis(self.moe_cfg.token_axes)
        tokens = torch.as_tensor(tokens)
        per = tokens.shape[0] // ax.size
        return tokens[ax.index * per:(ax.index + 1) * per].to(self.device)

    # -- forward --------------------------------------------------------------
    def _forward(self, module: SwitchLMParams, tokens):
        """(B_local, S) ids -> the final hidden states before ``ln_f``
        and the aux terms (load balance and z loss averaged over layers;
        ``expert_load`` (E,) and ``dropped`` summed, this rank's)."""
        cfg, dt = self.cfg, self.cfg.dtype
        e = module.embed
        b, s = tokens.shape
        x = e.tok_emb(tokens).to(dt) + e.pos_emb.weight[:s].to(dt)
        moe = module.moe
        auxs = []
        for i, blk in enumerate(module.blocks):
            x = x + blk.attn(blk.ln1(x))
            pre = blk.ln2(x).reshape(b * s, cfg.d_model)
            y, aux = moe_ffn({"router": moe.router[i], "w_in": moe.w_in[i],
                              "w_out": moe.w_out[i]}, pre, self.moe_cfg)
            x = x + y.reshape(b, s, cfg.d_model)
            auxs.append(aux)
        aux = {k: torch.stack([a[k] for a in auxs]).mean()
               for k in ("load_balance", "z_loss")}
        aux |= {k: torch.stack([a[k] for a in auxs]).sum(dim=0)
                for k in ("expert_load", "dropped")}
        return x, aux

    def _local_loss(self, module: SwitchLMParams, tokens):
        """The global-mean LM loss plus aux from this rank's shard: its
        NLL sum over the token axes (its gradient this rank's part)
        divided by the global target count."""
        h = module.head
        x, aux = self._forward(module, tokens)
        xh = h.ln_f(x)
        if self.fused_ce:
            se = fused_next_token_loss(xh, h.lm_head.weight.t(), tokens,
                                       chunk=self.ce_chunk, reduction="sum")
        else:
            logits = _linear(xh[:, :-1], h.lm_head.weight,
                             dtype=torch.float32)
            logp = torch.log_softmax(logits, dim=-1)
            se = -logp.gather(-1, tokens[:, 1:].long()[..., None]).sum()
        axes = self.moe_cfg.token_axes
        n = torch.tensor(float(tokens.shape[0] * (tokens.shape[1] - 1)),
                         device=se.device)
        lm = cc.tp_allreduce(se, axes) / cc.psum(n, axes)
        loss = lm + self.aux_weight * (aux["load_balance"] + aux["z_loss"])
        return loss, {"lm_loss": lm.detach(),
                      **{k: v.detach() for k, v in aux.items()}}

    def loss_and_grads(self, module: SwitchLMParams, tokens):
        """One forward and backward on this rank's ``tokens``: the loss,
        the metrics and this rank's gradients ({parameter name: tensor}),
        reduced as the mesh requires, without an update."""
        tokens = torch.as_tensor(tokens).to(self.device)
        module.zero_grad(set_to_none=True)
        with self.mesh:
            loss, mets = self._local_loss(module, tokens)
            loss.backward()
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for n, p in module.named_parameters()}
            module.zero_grad(set_to_none=True)
            stacks = ("moe.w_in", "moe.w_out")
            grads.update(cc.psum({n: g for n, g in grads.items()
                                  if n not in stacks},
                                 self.moe_cfg.token_axes))
            grads.update(cc.psum({n: grads[n] for n in stacks}, "data"))
        return loss.detach(), mets, grads

    def make_train_step(self, optimizer: torch.optim.Optimizer):
        """``(module, tokens (B_local, S)) -> (module, metrics)``: one
        forward and backward of this rank's share of the batch, the
        gradient reductions, then one ``optimizer`` step over ``module``'s
        parameters (in place). Metrics: ``loss``, ``lm_loss``,
        ``load_balance``, ``z_loss``, and this rank's ``expert_load``
        (E,) and ``dropped`` summed over layers."""

        def step(module, tokens):
            loss, mets, grads = self.loss_and_grads(module, tokens)
            for n, p in module.named_parameters():
                p.grad = grads[n]
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return module, {"loss": loss, **mets}

        return step


# ---- program contracts (analysis/) ------------------------------------------


def lint_contracts():
    """Contracts of the Switch train step over the (data=2, expert=4) mesh
    at the auditor's fixture (E=4, top-1, capacity factor 2, the tiny
    LM's 2 layers): the Switch router and the dropless one. The defining
    expectation is the ``all_to_all[expert]`` census, and the byte pin
    holds its other side: 4·L·B·(e−1)/e with B the dispatch buffer.

    The census counts executed calls: each layer's forward makes 2
    all-to-alls (dispatch and return) and the backward their 2
    transposes, 4·L = 8, where the JAX census counts the 4 sites of one
    scan body. Over the token axes ``(data, expert)`` a layer makes 3
    reductions (the load and router-probability fractions and the z
    loss), the loss 2 (its numerator and the target count) and the
    replicated gradients one tree: 3·L + 3 = 9 (the JAX contract counts
    13 leaf sites); the expert stacks' gradients are one tree over
    ``data`` only (the JAX contract: 2 leaves), their expert
    contributions having come back through the backward all-to-all.
    Dropless changes the capacity, not the calls: C = t_local, twice the
    Switch buffer at this fixture."""
    import numpy as np

    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        CostPin,
        CostSpec,
        DonationSpec,
        ProgramContract,
    )
    from distributed_tensorflow_guide_tpu_torch.analysis.cost import (
        closed_forms,
    )

    n_data, n_expert, top_k, cap_factor = 2, 4, 1, 2.0
    n_layers, B, S, d_model = 2, 8, 8, 16

    def _make_build(router):
        def _build(device):
            from distributed_tensorflow_guide_tpu_torch.analysis.fixtures \
                import tiny_lm_cfg
            from distributed_tensorflow_guide_tpu_torch.core.mesh import (
                MeshSpec,
                build_mesh,
            )

            mesh = build_mesh(MeshSpec(data=n_data, expert=n_expert))
            lm = SwitchLM(mesh, tiny_lm_cfg(), num_experts=n_expert,
                          top_k=top_k, capacity_factor=cap_factor,
                          router=router, fused_ce=False, device=device)
            # the token axes' joint group is made collectively: here, not
            # inside the recorded step
            mesh.axis(lm.moe_cfg.token_axes)
            module = lm.init_params(0)
            step = lm.make_train_step(torch.optim.SGD(module.parameters(),
                                                      lr=0.1))
            tokens = torch.from_numpy(np.random.RandomState(0).randint(
                0, lm.cfg.vocab_size, (B, S)))
            return step, (module, lm.token_shard(tokens))

        return _build

    def _a2a_expect(router):
        def expect():
            t_local = B // (n_data * n_expert) * S
            capacity = (t_local if router == "dropless"
                        else max(1, -(-top_k * t_local * int(cap_factor)
                                      // n_expert)))
            dispatch_bytes = n_expert * capacity * d_model * 4
            return closed_forms().moe_all_to_all_bytes(
                dispatch_bytes, n_expert, n_layers=n_layers)

        return expect

    census = {
        "all_to_all[expert]": 4 * n_layers,
        "psum[data,expert]": 3 * n_layers + 3,
        "psum[data]": 1,
    }
    sources = ("distributed_tensorflow_guide_tpu_torch.models.moe_lm",
               "distributed_tensorflow_guide_tpu_torch.parallel.expert",
               "distributed_tensorflow_guide_tpu_torch.collectives."
               "collectives")
    return [
        ProgramContract(
            name=name,
            build=_make_build(router),
            policy="f32",
            collectives=dict(census),
            donation=DonationSpec(argnums=(0,), mode="update"),
            sources=sources,
            cost=CostSpec(
                pins=(
                    CostPin("collective_bytes[all_to_all[expert]]",
                            _a2a_expect(router), note=note),
                ),
                # 71,096 (Switch) and 75,628 (dropless) observed
                max_peak_live_bytes=81920),
            world=8,
            notes=notes)
        for name, router, note, notes in (
            ("moe_train_step", "switch",
             "4·L·B·(e−1)/e at the fixed-capacity dispatch buffer",
             "Switch-MoE step: tokens travel, expert params stay"),
            ("moe_dropless_train_step", "dropless",
             "the same 4·L crossings at C = t_local: the byte price of "
             "dropless routing",
             "dropless Switch step: capacity = t_local, no drops"))
    ]
