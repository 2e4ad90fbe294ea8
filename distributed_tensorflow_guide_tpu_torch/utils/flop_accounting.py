"""Matmul and convolution FLOPs of a call, as it runs.

The JAX package walks a traced jaxpr and counts ``dot_general`` and
``conv_general_dilated``. Here ``torch.utils.flop_counter.FlopCounterMode``
intercepts the ops a call dispatches and counts matrix products
(``mm``, ``addmm``, ``bmm``, ...), convolutions (forward and backward) and
attention with the same formulas: 2 * M * N * K for a product, 2 * batch
* output pixels * out channels * in channels per group * kernel pixels
for a convolution; a bias or an elementwise op counts nothing. The call
runs for real (on whatever device its tensors are on); a loop counts as
many times as it runs.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def traced_matmul_flops(fn, *args, **kwargs) -> float:
    """The matmul and convolution FLOPs of ``fn(*args, **kwargs)``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
