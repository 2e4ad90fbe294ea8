"""Weights between the JAX package's flax param trees and this package's
state dicts: the Transformer (LM or classifier), ResNet, the MNIST CNN
and Wide&Deep.

The bridge takes and gives plain numpy arrays in nested dicts, so it never
needs jax: a caller on the JAX side hands over
``jax.tree.map(np.asarray, flax.linen.meta.unbox(params))``. Both
directions are exact (transposes and reshapes only).

Layouts (flax -> torch):

* ``qkv/kernel`` (D, 3, H, hd) -> ``attn.qkv.weight`` (3*H*hd, D);
* ``proj/kernel`` (H, hd, D) -> ``attn.proj.weight`` (D, H*hd);
* Dense kernels (in, out) -> ``nn.Linear`` weights (out, in); the MLP's
  ``up`` has a bias, ``down`` has none;
* ``lm_head/kernel`` (D, V) -> ``lm_head.weight`` (V, D), or, with
  ``cfg.num_classes``, ``classifier/kernel`` (D, C) and ``bias`` ->
  ``classifier.weight`` (C, D) and ``classifier.bias``;
* ``tok_emb``/``pos_emb`` ``embedding`` -> ``nn.Embedding`` weights;
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
* conv kernels (kh, kw, in, out) -> conv weights (out, in, kh, kw);
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and its
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

Quantised weights (``cfg.weight_dtype``): the reference's
``ops/quant.quantize_params`` tree holds ``{qkernel, scale}`` (and ``up``'s
bias) where the f32 tree holds ``kernel``; ``qkernel`` is already the 2-D
(d_in[/2], d_out) layout of the port's ``WeightQuantLinear``, so
:func:`params_from_flax` carries it and ``scale`` over as they are (int8,
packed uint8, or e4m3 bytes, which numpy holds as ``ml_dtypes``
``float8_e4m3fn``).

Mixture of experts (``cfg.moe_experts``): ``mlp/router/kernel`` (D, E)
-> ``mlp.router.weight`` (E, D); the banks ``mlp/w_in/kernel`` (E, D, F)
and ``mlp/w_out/kernel`` (E, F, D) keep their layout as
``mlp.w_in.weight`` / ``mlp.w_out.weight``, and their quantised
``{qkernel, scale}`` pass over as they are. :func:`switch_lm_from_flax`
and :func:`switch_lm_to_flax` carry the JAX ``SwitchLM``'s stacked tree
(``{"embed", "attn", "ln2", "moe", "head"}``, block leaves (L, ...)).

The two-tier strategy and the elastic world: the toy linear regression's
``{"w": (d, 1)}`` is a bias-free ``nn.Linear(d, 1)``'s ``weight`` (1, d)
(:func:`regression_from_flax`), and the reference's ``TwoTierState``
carries its inner parameters and its outer momentum, a tree of the
parameters' structure, across through one such pair of functions
(:func:`two_tier_from_flax`, :func:`two_tier_to_flax`).

Multi-LoRA banks: :func:`adapters_from_flax` reads the JAX "adapters"
collection (``block_{i}/attn/{qkv,proj}_{A,B}``,
``block_{i}/mlp/{up,down}_{A,B}``, the same (n, d_in, r) and (n, r,
d_out) arrays) into the port's bank (``blocks.{i}.attn.qkv_A`` ...), and
:func:`adapters_to_flax` is the way back.

Model parallelism: :func:`tp_params_from_flax` gives one ``model`` rank's
shards of a Transformer (``parallel/tensor.py``);
:func:`pipeline_params_from_flax` reads the JAX ``PipelinedLM``'s host tree
(``{"embed", "stages", "head"}``, the block leaves stacked as (P·v rows,
layers a chunk, ...), row s·v + j holding chunk-stage j·P + s) into the
flat Transformer state dict, :func:`pipeline_stage_from_flax` gives one
rank its stage of it, and :func:`pipeline_params_to_flax` is the way
back.

Data-parallel families: :func:`fsdp_params_from_flax` gives one ``data``
rank its FSDP shards (through the full state dict and ``shard_spec_for``)
and :func:`fsdp_params_to_flax` merges every rank's back;
:func:`gossip_replicas_from_flax` splits the JAX ``GossipSGD``'s
per-replica tree (leaves (world, ...)) into one state dict a rank, and
:func:`gossip_replicas_to_flax` stacks them again. Each takes the
model's own converter pair (``params_from_flax`` with its config,
``mnist_cnn_from_flax``, ...).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":  # ml_dtypes: reinterpret the bytes
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _quantized_from(node: Mapping, pre: str) -> dict[str, torch.Tensor]:
    """A quantised projection's entries (``qkernel``, ``scale``, a bias)
    under the port name ``pre``."""
    return {f"{pre}.{k}": _t(v) for k, v in node.items()}


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_flax(tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """flax param tree of ``Transformer`` (numpy leaves) -> state dict."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    sd = {"tok_emb.weight": _t(tree["tok_emb"]["embedding"]),
          "pos_emb.weight": _t(tree["pos_emb"]["embedding"])}
    for i in range(cfg.num_layers):
        blk = tree[f"block_{i}"]
        pre = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".weight"] = _t(blk[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(blk[ln]["bias"])
        mlp = blk["mlp"]
        if cfg.moe:
            sd[pre + "mlp.router.weight"] = _t(
                np.asarray(mlp["router"]["kernel"]).T)
            for name in ("w_in", "w_out"):
                if cfg.weight_dtype:
                    sd.update(_quantized_from(mlp[name], f"{pre}mlp.{name}"))
                else:
                    sd[f"{pre}mlp.{name}.weight"] = _t(mlp[name]["kernel"])
        if cfg.weight_dtype:
            sites = (("attn", "qkv"), ("attn", "proj"))
            if not cfg.moe:
                sites += (("mlp", "up"), ("mlp", "down"))
            for sub, name in sites:
                sd.update(_quantized_from(blk[sub][name],
                                          f"{pre}{sub}.{name}"))
            continue
        qkv = np.asarray(blk["attn"]["qkv"]["kernel"])
        sd[pre + "attn.qkv.weight"] = _t(qkv.reshape(D, 3 * H * hd).T)
        proj = np.asarray(blk["attn"]["proj"]["kernel"])
        sd[pre + "attn.proj.weight"] = _t(proj.reshape(H * hd, D).T)
        if cfg.moe:
            continue
        sd[pre + "mlp.up.weight"] = _t(np.asarray(mlp["up"]["kernel"]).T)
        sd[pre + "mlp.up.bias"] = _t(mlp["up"]["bias"])
        sd[pre + "mlp.down.weight"] = _t(
            np.asarray(mlp["down"]["kernel"]).T)
    sd["ln_f.weight"] = _t(tree["ln_f"]["scale"])
    sd["ln_f.bias"] = _t(tree["ln_f"]["bias"])
    if cfg.num_classes is None and cfg.weight_dtype:
        sd.update(_quantized_from(tree["lm_head"], "lm_head"))
    elif cfg.num_classes is None:
        sd["lm_head.weight"] = _t(np.asarray(tree["lm_head"]["kernel"]).T)
    else:
        sd.update(_dense_from(tree["classifier"], "classifier"))
    return sd


def params_to_flax(state_dict: Mapping, cfg) -> dict:
    """The inverse of :func:`params_from_flax`: state dict -> flax param
    tree with numpy leaves."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim

    def a(key):
        return state_dict[key].detach().cpu().numpy()

    tree = {"tok_emb": {"embedding": a("tok_emb.weight")},
            "pos_emb": {"embedding": a("pos_emb.weight")}}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        tree[f"block_{i}"] = {
            "ln1": {"scale": a(pre + "ln1.weight"),
                    "bias": a(pre + "ln1.bias")},
            "attn": {
                "qkv": {"kernel": np.ascontiguousarray(
                    a(pre + "attn.qkv.weight").T).reshape(D, 3, H, hd)},
                "proj": {"kernel": np.ascontiguousarray(
                    a(pre + "attn.proj.weight").T).reshape(H, hd, D)},
            },
            "ln2": {"scale": a(pre + "ln2.weight"),
                    "bias": a(pre + "ln2.bias")},
            "mlp": ({
                "router": {"kernel": np.ascontiguousarray(
                    a(pre + "mlp.router.weight").T)},
                "w_in": {"kernel": a(pre + "mlp.w_in.weight")},
                "w_out": {"kernel": a(pre + "mlp.w_out.weight")},
            } if cfg.moe else {
                "up": {"kernel": np.ascontiguousarray(
                    a(pre + "mlp.up.weight").T),
                    "bias": a(pre + "mlp.up.bias")},
                "down": {"kernel": np.ascontiguousarray(
                    a(pre + "mlp.down.weight").T)},
            }),
        }
    tree["ln_f"] = {"scale": a("ln_f.weight"), "bias": a("ln_f.bias")}
    if cfg.num_classes is None:
        tree["lm_head"] = {"kernel": np.ascontiguousarray(
            a("lm_head.weight").T)}
    else:
        tree["classifier"] = _dense_to(state_dict, "classifier")
    return tree


def switch_lm_from_flax(tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """The JAX ``SwitchLM``'s param tree (numpy leaves, all E experts) ->
    the state dict of ``models/moe_lm.SwitchLMParams`` with every expert
    (``SwitchLM.shard_params`` cuts a rank's share)."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    emb, attn, head = tree["embed"], tree["attn"], tree["head"]
    sd = {"embed.tok_emb.weight": _t(emb["tok_emb"]["embedding"]),
          "embed.pos_emb.weight": _t(emb["pos_emb"]["embedding"]),
          "head.ln_f.weight": _t(head["ln_f"]["scale"]),
          "head.ln_f.bias": _t(head["ln_f"]["bias"]),
          "head.lm_head.weight": _t(
              np.asarray(head["lm_head"]["kernel"]).T)}
    qkv = np.asarray(attn["attn"]["qkv"]["kernel"])
    proj = np.asarray(attn["attn"]["proj"]["kernel"])
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        sd[pre + "ln1.weight"] = _t(attn["ln1"]["scale"][i])
        sd[pre + "ln1.bias"] = _t(attn["ln1"]["bias"][i])
        sd[pre + "attn.qkv.weight"] = _t(qkv[i].reshape(D, 3 * H * hd).T)
        sd[pre + "attn.proj.weight"] = _t(proj[i].reshape(H * hd, D).T)
        sd[pre + "ln2.weight"] = _t(tree["ln2"]["scale"][i])
        sd[pre + "ln2.bias"] = _t(tree["ln2"]["bias"][i])
    for name in ("router", "w_in", "w_out"):
        sd[f"moe.{name}"] = _t(tree["moe"][name])
    return sd


def switch_lm_to_flax(state_dict: Mapping, cfg) -> dict:
    """The inverse of :func:`switch_lm_from_flax` (a state dict with every
    expert, or gradients keyed the same way)."""
    D, H, hd, L = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_layers

    def a(key):
        return state_dict[key].detach().cpu().numpy()

    def stack(fmt, fn=lambda x: x):
        return np.stack([fn(a(fmt.format(i))) for i in range(L)])

    return {
        "embed": {"tok_emb": {"embedding": a("embed.tok_emb.weight")},
                  "pos_emb": {"embedding": a("embed.pos_emb.weight")}},
        "attn": {
            "ln1": {"scale": stack("blocks.{}.ln1.weight"),
                    "bias": stack("blocks.{}.ln1.bias")},
            "attn": {
                "qkv": {"kernel": stack(
                    "blocks.{}.attn.qkv.weight",
                    lambda w: w.T.reshape(D, 3, H, hd))},
                "proj": {"kernel": stack(
                    "blocks.{}.attn.proj.weight",
                    lambda w: w.T.reshape(H, hd, D))}}},
        "ln2": {"scale": stack("blocks.{}.ln2.weight"),
                "bias": stack("blocks.{}.ln2.bias")},
        "moe": {name: a(f"moe.{name}") for name in ("router", "w_in",
                                                      "w_out")},
        "head": {"ln_f": {"scale": a("head.ln_f.weight"),
                          "bias": a("head.ln_f.bias")},
                 "lm_head": {"kernel": np.ascontiguousarray(
                     a("head.lm_head.weight").T)}},
    }


def _adapter_names(cfg):
    """(flax path, bank name) of every delta bank, site by site and layer
    by layer."""
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        LORA_SITES,
    )

    return [((f"block_{i}", mod, f"{site}_{ab}"),
             f"blocks.{i}.{mod}.{site}_{ab}")
            for i in range(cfg.num_layers)
            for mod, sites in LORA_SITES.items()
            for site in sites for ab in "AB"]


def adapters_from_flax(tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """The JAX "adapters" collection (numpy leaves) -> the port's bank,
    name -> tensor, for ``ServeEngine(adapters=)``,
    ``make_generate_fn(adapters=)`` or ``Transformer.set_adapter_bank``."""
    return {name: _t(_at(tree, path)) for path, name in _adapter_names(cfg)}


def adapters_to_flax(bank: Mapping, cfg) -> dict:
    """The inverse of :func:`adapters_from_flax`: bank -> the JAX
    "adapters" tree with numpy leaves."""
    tree: dict = {}
    for path, name in _adapter_names(cfg):
        _put(tree, path, _np(torch.as_tensor(bank[name])))
    return tree


def tp_params_from_flax(tree: Mapping, cfg, tp: int, index: int
                        ) -> dict[str, torch.Tensor]:
    """The shards of ``model`` rank ``index`` of ``tp``: the state dict of
    ``TensorParallel.shard``'s local module (``cfg`` is the full
    config)."""
    from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
        shard_state_dict,
    )

    return shard_state_dict(params_from_flax(tree, cfg), tp, index)


def fsdp_params_from_flax(tree: Mapping, from_flax, world: int,
                          index: int, min_shard_size: int = 2 ** 14
                          ) -> dict[str, torch.Tensor]:
    """The FSDP shards of ``data`` rank ``index`` of ``world``:
    ``from_flax(tree)`` (the full state dict) cut by ``shard_spec_for``,
    as ``FSDP.shard`` cuts it."""
    from distributed_tensorflow_guide_tpu_torch.parallel import fsdp

    full = from_flax(tree)
    specs = fsdp.param_specs(full, world, min_shard_size)
    return fsdp.shard_state_dict(full, specs, world, index)


def fsdp_params_to_flax(parts: list[Mapping], to_flax, specs: Mapping
                        ) -> dict:
    """Every ``data`` rank's FSDP shards (in rank order, the layout
    ``specs``, ``FSDP.specs``) -> the full flax tree."""
    from distributed_tensorflow_guide_tpu_torch.parallel import fsdp

    return to_flax(fsdp.merge_shards(parts, specs))


def gossip_replicas_from_flax(tree: Mapping, from_flax
                              ) -> list[dict[str, torch.Tensor]]:
    """The JAX ``GossipSGD`` parameters (every leaf (world, ...), one row
    a replica) -> one state dict a rank."""
    world = len(next(iter(_leaves(tree))))
    return [from_flax(_tree_map(lambda a, r=r: np.asarray(a)[r], tree))
            for r in range(world)]


def gossip_replicas_to_flax(replicas: list[Mapping], to_flax) -> dict:
    """One state dict a rank -> the JAX ``GossipSGD``'s tree, the
    replicas stacked on a leading axis."""
    trees = [to_flax(sd) for sd in replicas]

    def stack(path):
        nodes = [_at(t, path) for t in trees]
        if isinstance(nodes[0], Mapping):
            return {k: stack(path + (k,)) for k in nodes[0]}
        return np.stack(nodes)

    return stack(())


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _chunk_order(n_stages: int, virtual_chunks: int, layers_per_chunk: int
                 ) -> np.ndarray:
    """The global layer of each flattened stacked row of the JAX
    ``PipelinedLM``: row r = s·v + j holds chunk-stage k = j·P + s."""
    order = []
    for r in range(n_stages * virtual_chunks):
        s, j = divmod(r, virtual_chunks)
        k = j * n_stages + s
        order.extend(range(k * layers_per_chunk, (k + 1) * layers_per_chunk))
    return np.asarray(order)


def pipeline_params_from_flax(tree: Mapping, cfg, n_stages: int,
                              virtual_chunks: int = 1
                              ) -> dict[str, torch.Tensor]:
    """The JAX ``PipelinedLM``'s host tree (numpy leaves) -> the flat
    ``Transformer`` state dict (its ``to_serving_params`` and then
    :func:`params_from_flax`)."""
    L = cfg.num_layers
    inv = np.argsort(_chunk_order(n_stages, virtual_chunks,
                                  L // (n_stages * virtual_chunks)))
    flat = {"tok_emb": tree["embed"]["tok_emb"],
            "pos_emb": tree["embed"]["pos_emb"],
            "ln_f": tree["head"]["ln_f"], "lm_head": tree["head"]["lm_head"]}
    stages = _tree_map(
        lambda x: np.asarray(x).reshape(L, *np.shape(x)[2:])[inv],
        tree["stages"])
    for i in range(L):
        flat[f"block_{i}"] = _tree_map(lambda x, i=i: x[i], stages)
    return params_from_flax(flat, cfg)


def pipeline_stage_from_flax(tree: Mapping, cfg, pp
                             ) -> dict[str, torch.Tensor]:
    """The state dict of the ``PipelineStage`` that rank ``pp`` (a
    ``parallel.pipeline.PipelinedLM`` over the same layout as the tree's)
    holds: its stage's layers, TP-sharded by its ``model`` index, and its
    shards of the embedding and head."""
    return pp.stage_state_dict(pipeline_params_from_flax(
        tree, cfg, pp.n_stages, pp.virtual_chunks))


def pipeline_params_to_flax(state_dict: Mapping, cfg, n_stages: int,
                            virtual_chunks: int = 1) -> dict:
    """The inverse of :func:`pipeline_params_from_flax`: a flat
    ``Transformer`` state dict (``PipelinedLM.to_serving_params``) -> the
    JAX ``PipelinedLM``'s host tree for a (``n_stages``,
    ``virtual_chunks``) layout."""
    L = cfg.num_layers
    rows = n_stages * virtual_chunks
    order = _chunk_order(n_stages, virtual_chunks, L // rows)
    flat = params_to_flax(state_dict, dataclasses.replace(
        cfg, num_classes=None))
    blocks = [flat[f"block_{g}"] for g in order]

    def stack(*leaves):
        a = np.stack(leaves)
        return a.reshape(rows, L // rows, *a.shape[1:])

    def zip_map(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: zip_map([n[k] for n in nodes]) for k in nodes[0]}
        return stack(*nodes)

    return {"embed": {"tok_emb": flat["tok_emb"], "pos_emb": flat["pos_emb"]},
            "stages": zip_map(blocks),
            "head": {"ln_f": flat["ln_f"], "lm_head": flat["lm_head"]}}


# ---- the non-LM models: the module names map one to one -------------------


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _dense_from(node: Mapping, name: str) -> dict:
    """flax Dense (kernel (in, out), bias) -> ``name.weight`` (out, in),
    ``name.bias``."""
    return {f"{name}.weight": _t(np.asarray(node["kernel"]).T),
            f"{name}.bias": _t(node["bias"])}


def _dense_to(sd: Mapping, name: str) -> dict:
    return {"kernel": _np(sd[f"{name}.weight"].T),
            "bias": _np(sd[f"{name}.bias"])}


def _conv_from(node: Mapping, name: str) -> dict:
    """flax Conv kernel (kh, kw, in, out) -> (out, in, kh, kw), and its
    bias where it has one."""
    sd = {f"{name}.weight": _t(np.asarray(node["kernel"]).transpose(
        3, 2, 0, 1))}
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])
    return sd


def _conv_to(sd: Mapping, name: str) -> dict:
    node = {"kernel": _np(sd[f"{name}.weight"].permute(2, 3, 1, 0))}
    if f"{name}.bias" in sd:
        node["bias"] = _np(sd[f"{name}.bias"])
    return node


def _embed_from(node: Mapping, name: str) -> dict:
    return {f"{name}.weight": _t(node["embedding"])}


def _embed_to(sd: Mapping, name: str) -> dict:
    return {"embedding": _np(sd[f"{name}.weight"])}


# ResNet: a block's modules, (flax name, port name, kind); the projection
# pair exists only where a block changes the shape
_BLOCK = (("Conv_0", "conv0", "conv"), ("BatchNorm_0", "bn0", "norm"),
          ("Conv_1", "conv1", "conv"), ("BatchNorm_1", "bn1", "norm"),
          ("Conv_2", "conv2", "conv"), ("BatchNorm_2", "bn2", "norm"))
_PROJ = (("conv_proj", "conv_proj", "conv"),
         ("norm_proj", "norm_proj", "norm"))


def _resnet_names(projected: list[bool]):
    """(flax path, port name, kind) of every ResNet module, for blocks
    that have a projection where ``projected`` says so."""
    yield ("conv_init",), "conv_init", "conv"
    yield ("bn_init",), "bn_init", "norm"
    for k, proj in enumerate(projected):
        for flax_name, name, kind in _BLOCK + (_PROJ if proj else ()):
            yield (f"BottleneckBlock_{k}", flax_name), f"blocks.{k}.{name}", \
                kind
    yield ("head",), "head", "dense"


def _at(tree: Mapping, path) -> Mapping:
    for key in path:
        tree = tree[key]
    return tree


def resnet_from_flax(params: Mapping, batch_stats: Mapping
                     ) -> dict[str, torch.Tensor]:
    """flax ResNet ``params`` and ``batch_stats`` -> the port's state
    dict."""
    n = sum(k.startswith("BottleneckBlock_") for k in params)
    projected = [("conv_proj" in params[f"BottleneckBlock_{k}"])
                 for k in range(n)]
    sd = {}
    for path, name, kind in _resnet_names(projected):
        node = _at(params, path)
        if kind == "conv":
            sd.update(_conv_from(node, name))
        elif kind == "dense":
            sd.update(_dense_from(node, name))
        else:
            stats = _at(batch_stats, path)
            sd.update({f"{name}.weight": _t(node["scale"]),
                       f"{name}.bias": _t(node["bias"]),
                       f"{name}.running_mean": _t(stats["mean"]),
                       f"{name}.running_var": _t(stats["var"])})
    return sd


def resnet_to_flax(state_dict: Mapping) -> tuple[dict, dict]:
    """The inverse of :func:`resnet_from_flax`: ``(params,
    batch_stats)``. Gradients (a dict without the buffers) give an empty
    ``batch_stats``."""
    projected = [f"blocks.{k}.conv_proj.weight" in state_dict
                 for k in range(_count(state_dict, "blocks."))]
    params, stats = {}, {}
    for path, name, kind in _resnet_names(projected):
        if kind == "conv":
            node = _conv_to(state_dict, name)
        elif kind == "dense":
            node = _dense_to(state_dict, name)
        else:
            node = {"scale": _np(state_dict[f"{name}.weight"]),
                    "bias": _np(state_dict[f"{name}.bias"])}
            if f"{name}.running_mean" in state_dict:
                _put(stats, path, {
                    "mean": _np(state_dict[f"{name}.running_mean"]),
                    "var": _np(state_dict[f"{name}.running_var"])})
        _put(params, path, node)
    return params, stats


def _put(tree: dict, path, node) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = node


def mnist_cnn_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``MNISTCNN`` params -> the port's state dict. ``Dense_0``'s
    rows are in NHWC flatten order, which the port's model keeps."""
    return {**_conv_from(params["Conv_0"], "conv0"),
            **_conv_from(params["Conv_1"], "conv1"),
            **_dense_from(params["Dense_0"], "dense0"),
            **_dense_from(params["Dense_1"], "dense1")}


def mnist_cnn_to_flax(state_dict: Mapping) -> dict:
    return {"Conv_0": _conv_to(state_dict, "conv0"),
            "Conv_1": _conv_to(state_dict, "conv1"),
            "Dense_0": _dense_to(state_dict, "dense0"),
            "Dense_1": _dense_to(state_dict, "dense1")}


def _wide_deep_names(n_fields: int, n_mlp: int):
    for i in range(n_fields):
        yield f"wide_{i}", f"wide.{i}", "embed"
        yield f"emb_{i}", f"emb.{i}", "embed"
    yield "wide_dense", "wide_dense", "dense"
    for j in range(n_mlp):
        yield f"mlp_{j}", f"mlp.{j}", "dense"
    yield "deep_out", "deep_out", "dense"


def _count(keys, prefix: str) -> int:
    return len({k.split(".")[1] for k in keys if k.startswith(prefix)})


def wide_deep_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``WideDeep`` params -> the port's state dict."""
    n_fields = sum(k.startswith("emb_") for k in params)
    n_mlp = sum(k.startswith("mlp_") for k in params)
    sd = {}
    for flax_name, name, kind in _wide_deep_names(n_fields, n_mlp):
        conv = _embed_from if kind == "embed" else _dense_from
        sd.update(conv(params[flax_name], name))
    return sd


def wide_deep_to_flax(state_dict: Mapping) -> dict:
    names = _wide_deep_names(_count(state_dict, "emb."),
                             _count(state_dict, "mlp."))
    return {flax_name: (_embed_to if kind == "embed" else _dense_to)(
        state_dict, name) for flax_name, name, kind in names}


# ---- the two-tier strategy and the elastic world ---------------------------


def regression_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """``{"w": (d, 1)}`` -> ``{"weight": (1, d)}``."""
    return {"weight": _t(np.asarray(params["w"]).T)}


def regression_to_flax(state_dict: Mapping) -> dict:
    """The inverse of :func:`regression_from_flax` (tensors or numpy
    arrays in)."""
    w = state_dict["weight"]
    return {"w": (_np(w) if torch.is_tensor(w) else np.asarray(w)).T.copy()}


def two_tier_from_flax(params: Mapping, outer_momentum: Mapping, from_flax
                       ) -> tuple[dict, dict]:
    """A reference ``TwoTierState``'s inner parameters and outer momentum
    (numpy trees of one structure) -> (state dict, momentum by parameter
    name), each through ``from_flax``."""
    return from_flax(params), from_flax(outer_momentum)


def two_tier_to_flax(state_dict: Mapping, momentum: Mapping, to_flax
                     ) -> tuple[dict, dict]:
    """The inverse of :func:`two_tier_from_flax`."""
    return to_flax(state_dict), to_flax(momentum)
