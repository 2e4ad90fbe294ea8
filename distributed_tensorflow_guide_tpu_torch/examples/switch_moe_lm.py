"""Switch-MoE causal LM over the ``data x expert`` mesh: the EP machinery
(``moe_expert_parallel.py`` shows the bare layer) wired into a model
family (``models/moe_lm.py``).

No reference equivalent (the guide predates MoE). Tokens are sharded over
both mesh axes; the expert FFN stacks live sharded over ``expert`` and
the tokens travel to them by ``all_to_all``::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.switch_moe_lm --fake-devices 8
    python -m $E.switch_moe_lm --fake-devices 8 --expert 2

``--fake-devices N``: N gloo ranks on the CPU (``--expert`` must divide
N). At ``--seq-len`` 32 attention is dense: no kernel of K1-K6 runs.
"""

import argparse
import functools
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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--num-experts", type=int, default=8)
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--expert", type=int, default=4,
                    help="expert-axis size (data absorbs the rest)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    _common.add_device_args(ap)
    return ap


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        axis_sizes,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models.moe_lm import SwitchLM
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    dev = _common.device_of(args)
    mesh = build_mesh(MeshSpec(data=-1, expert=args.expert))
    sizes = axis_sizes(mesh)
    cfg = TransformerConfig(
        vocab_size=256, num_layers=args.layers, num_heads=4,
        d_model=args.d_model, d_ff=args.d_model * 4, max_len=args.seq_len,
        causal=True, dtype=torch.float32)
    lm = SwitchLM(mesh, cfg, num_experts=args.num_experts, top_k=args.top_k,
                  device=dev)
    module = lm.init_params(0)
    opt = lm.init_opt_state(functools.partial(torch.optim.Adam,
                                              lr=args.lr), module)
    step = lm.make_train_step(opt)
    r = np.random.RandomState(0)
    tokens = lm.token_shard(r.randint(
        0, cfg.vocab_size, (args.global_batch, cfg.max_len)).astype(
            np.int64))
    losses = []
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    for i in range(args.steps):
        module, m = step(module, tokens)
        losses.append(float(m["lm_loss"]))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: lm_loss={losses[-1]:.4f} "
                  f"load_balance={float(m['load_balance']):.3f}",
                  flush=True)
    wall = clock.stop()
    done = (f"switch-moe ok: {args.num_experts} experts over "
            f"expert={sizes['expert']} x data={sizes['data']}, final "
            f"lm_loss={losses[-1]:.4f}")
    print(done, flush=True)
    return {"done": done, "device": str(dev), "world": world_and_rank()[0],
            "losses": losses, "wall_s": wall,
            "tokens_per_s": args.steps * args.global_batch * args.seq_len
            / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
