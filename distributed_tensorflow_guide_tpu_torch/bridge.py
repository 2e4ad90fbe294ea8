"""Weights between the JAX package's flax param tree and this package's
state dict.

The bridge takes and gives plain numpy arrays in nested dicts, so it never
needs jax: a caller on the JAX side hands over
``jax.tree.map(np.asarray, flax.linen.meta.unbox(params))``. Both
directions are exact (transposes and reshapes only).

Layouts (flax -> torch):

* ``qkv/kernel`` (D, 3, H, hd) -> ``attn.qkv.weight`` (3*H*hd, D);
* ``proj/kernel`` (H, hd, D) -> ``attn.proj.weight`` (D, H*hd);
* Dense kernels (in, out) -> ``nn.Linear`` weights (out, in); the MLP's
  ``up`` has a bias, ``down`` has none;
* ``lm_head/kernel`` (D, V) -> ``lm_head.weight`` (V, D);
* ``tok_emb``/``pos_emb`` ``embedding`` -> ``nn.Embedding`` weights;
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


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
        qkv = np.asarray(blk["attn"]["qkv"]["kernel"])
        sd[pre + "attn.qkv.weight"] = _t(qkv.reshape(D, 3 * H * hd).T)
        proj = np.asarray(blk["attn"]["proj"]["kernel"])
        sd[pre + "attn.proj.weight"] = _t(proj.reshape(H * hd, D).T)
        mlp = blk["mlp"]
        sd[pre + "mlp.up.weight"] = _t(np.asarray(mlp["up"]["kernel"]).T)
        sd[pre + "mlp.up.bias"] = _t(mlp["up"]["bias"])
        sd[pre + "mlp.down.weight"] = _t(
            np.asarray(mlp["down"]["kernel"]).T)
    sd["ln_f.weight"] = _t(tree["ln_f"]["scale"])
    sd["ln_f.bias"] = _t(tree["ln_f"]["bias"])
    sd["lm_head.weight"] = _t(np.asarray(tree["lm_head"]["kernel"]).T)
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
            "mlp": {
                "up": {"kernel": np.ascontiguousarray(
                    a(pre + "mlp.up.weight").T),
                    "bias": a(pre + "mlp.up.bias")},
                "down": {"kernel": np.ascontiguousarray(
                    a(pre + "mlp.down.weight").T)},
            },
        }
    tree["ln_f"] = {"scale": a("ln_f.weight"), "bias": a("ln_f.bias")}
    tree["lm_head"] = {"kernel": np.ascontiguousarray(
        a("lm_head.weight").T)}
    return tree
