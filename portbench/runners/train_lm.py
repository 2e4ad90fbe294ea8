"""Language-model training through the port: GPT-2 on token batches.

Token batches are drawn from the seed on the host and fed through
``DataParallel.prefetch(steps_per_call=k)``; the step is
``make_train_step(loss_fn, steps_per_call=k, stacked_batch=True)``, one
CUDA graph of k optimizer steps a call on the card, with Adam
(``capturable=True``), flash attention (K1-K3) and the fused
cross-entropy head: the port's defaults for a CUDA model.
"""

from __future__ import annotations

from portbench import generator, harness
from portbench.cost import models as cost_models
from portbench.runners import training
from portbench.reference import gpt2 as ref_gpt2


def transformer_config(cfg: dict):
    """The port's config for the configuration file."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    return TransformerConfig(
        vocab_size=cfg["vocab_padded"], num_layers=cfg["n_layer"],
        num_heads=cfg["n_head"], d_model=cfg["n_embd"], d_ff=cfg["d_ff"],
        max_len=cfg["n_positions"], causal=True,
        dtype=getattr(torch, cfg["dtype"]))


def weight_specs(model) -> dict:
    """(shape, std, mean): kernels and embeddings normal(0.02) as GPT-2
    draws them; LayerNorm scales about 1 and biases about 0 (std 0.02),
    so that no leaf starts at a value its gradient cannot tell apart."""
    specs = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        is_ln = ".ln" in name or name.startswith("ln_")
        mean = 1.0 if is_ln and name.endswith("weight") else 0.0
        specs[name] = (shape, 0.02, mean)
    return specs


def load_model(cfg: dict, seed: int, dev):
    """The port's GPT-2 with the weights drawn from the seed on ``dev``
    (f32 masters, the type the port trains and serves them in)."""
    import torch

    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
    )

    with torch.device(dev):
        model = Transformer(transformer_config(cfg))
    specs = weight_specs(model)
    w = harness.seeded_weights(specs, seed, dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return model, specs


def _tapped(source, taps: list, n: int):
    for batch in source:
        if len(taps) < n:
            taps.append({k: v.copy() for k, v in batch.items()})
        yield batch


def build(spec: dict, seed: int, dev) -> training.Built:
    import torch

    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        make_lm_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel \
        import DataParallel
    from distributed_tensorflow_guide_tpu_torch.train.state import (
        TrainState,
    )

    cfg, mix = spec["config"], spec["mix"]
    model, specs = load_model(cfg, seed, dev)
    opt = mix["optimizer"]
    state = TrainState(model, torch.optim.Adam(
        model.parameters(), lr=opt["lr"], betas=tuple(opt["betas"]),
        eps=opt["eps"], capturable=dev.type == "cuda"))
    k = int(mix["steps_per_call"])
    dp = DataParallel(device=dev)
    step = dp.make_train_step(make_lm_loss_fn(model), steps_per_call=k,
                              stacked_batch=True, per_step_metrics=True)
    taps: list = []
    host = _tapped(generator.token_batches(mix, seed, cfg["vocab_size"]),
                   taps, int(mix["ref_steps"]))
    feed = dp.prefetch(host, steps_per_call=k,
                       depth=int(mix["prefetch_depth"]))
    B, S = int(mix["batch"]), int(mix["seq"])
    layers, heads = cfg["n_layer"], cfg["n_head"]

    def ref_loss(weights, batch, *, fp8=False, half=False):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        if half:  # the fault: half of the batch, the mean over the rest
            tokens = tokens[: len(tokens) // 2]
        return ref_gpt2.lm_loss(weights, tokens, layers=layers, heads=heads,
                                fp8=fp8)

    return training.Built(
        model=model, state=state, step=step, feed=feed,
        prefetch_stats=feed.stats, taps=taps, steps_per_call=k,
        ref_steps=int(mix["ref_steps"]), warm_steps=int(mix["warm_steps"]),
        trace_steps=int(mix["trace_steps"]),
        flops_per_step=cost_models.gpt2_train_step_flops(
            layers=layers, d_model=cfg["n_embd"], d_ff=cfg["d_ff"],
            vocab=cfg["vocab_padded"], batch=B, seq=S),
        attn_shapes={"batch": B, "heads": heads, "seq": S,
                     "head_dim": cfg["n_embd"] // heads,
                     "launches_per_step": layers},
        weight_specs=specs, ref_loss=ref_loss)


def run(spec, *, seed, seconds, trace, dev, t_start):
    return training.run(spec, build, seed=seed, seconds=seconds,
                        trace=trace, dev=dev, t_start=t_start)
