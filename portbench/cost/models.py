"""Model FLOPs in closed form over the shapes, never traced from the
program: a change to how the port computes a layer leaves them as they
are. They count the products of the model (matmuls, convolutions,
attention) that the result needs, as MFU does by convention: no
recomputation, no elementwise work.
"""

from __future__ import annotations


def gpt2_matmul_params(*, layers: int, d_model: int, d_ff: int,
                       vocab: int) -> int:
    """N, the weights every token multiplies: per layer the fused QKV
    (d x 3d), the output projection (d x d) and the MLP (2 d d_ff), plus
    the LM head (d x vocab). Embedding lookups multiply nothing."""
    return layers * (4 * d_model * d_model + 2 * d_model * d_ff) \
        + d_model * vocab


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal sequence of ``seq`` tokens attends:
    seq (seq + 1) / 2."""
    return seq * (seq + 1) // 2


def gpt2_train_step_flops(*, layers: int, d_model: int, d_ff: int,
                          vocab: int, batch: int, seq: int) -> int:
    """One optimizer step: 6 N T (forward 2 N a token, backward twice
    that; Kaplan et al., arXiv:2001.08361, section 2.1) plus causal
    attention, 2 d FLOPs a (query, key) pair for QK^T and 2 d for PV in
    the forward, three times that with the backward: 12 d a pair a layer
    (PaLM's 6 L d S a token, arXiv:2204.02311 appendix B, with the causal
    half counted once)."""
    n = gpt2_matmul_params(layers=layers, d_model=d_model, d_ff=d_ff,
                           vocab=vocab)
    return (6 * n * batch * seq
            + 12 * d_model * layers * batch * causal_pairs(seq))


def gpt2_forward_token_flops(*, layers: int, d_model: int, d_ff: int,
                             vocab: int, keys: int) -> int:
    """The forward of one token that attends ``keys`` keys (its own
    included): 2 N + 4 d keys a layer."""
    n = gpt2_matmul_params(layers=layers, d_model=d_model, d_ff=d_ff,
                           vocab=vocab)
    return 2 * n + 4 * d_model * keys * layers


def gpt2_prefill_chunk_flops(*, layers, d_model, d_ff, vocab, start: int,
                             rows: int, ends_prompt: bool) -> int:
    """A prefill chunk of ``rows`` prompt tokens at positions start ..
    start + rows - 1: each attends its position + 1 keys and multiplies
    the layers' weights, 2 (N - d vocab) a row; the LM head (2 d vocab)
    only at the prompt's last token, whose logits give the first served
    token: once, in the chunk that ends the prompt."""
    n = gpt2_matmul_params(layers=layers, d_model=d_model, d_ff=d_ff,
                           vocab=vocab)
    head = d_model * vocab
    keys = rows * start + causal_pairs(rows)
    return (2 * (n - head) * rows + (2 * head if ends_prompt else 0)
            + 4 * d_model * layers * keys)


# ---- ResNet-50 -------------------------------------------------------------


def resnet_conv_shapes(*, stage_sizes, num_filters: int, image: int,
                       in_channels: int = 3) -> list:
    """(name, c_in, c_out, k, h_out, w_out) of every convolution of the
    v1.5 bottleneck ResNet (He et al., arXiv:1512.03385, table 1; the
    stride on the 3x3 conv): a 7x7 stride-2 stem, a 3x3 stride-2
    max-pool, then per stage ``count`` blocks of 1x1, 3x3 (stride 2 in
    the first block of stages after the first), 1x1 to 4x the filters,
    with a strided 1x1 projection where the shape changes. SAME padding:
    a stride-s layer's output side is ceil(side / s)."""
    def down(side, s):
        return -(-side // s)

    side = down(image, 2)
    shapes = [("stem", in_channels, num_filters, 7, side, side)]
    side = down(side, 2)  # the max-pool
    cin = num_filters
    for i, count in enumerate(stage_sizes):
        filters = num_filters * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            out = down(side, stride)
            tag = f"stage{i}.block{j}"
            shapes.append((tag + ".conv0", cin, filters, 1, side, side))
            shapes.append((tag + ".conv1", filters, filters, 3, out, out))
            shapes.append((tag + ".conv2", filters, 4 * filters, 1, out,
                           out))
            if cin != 4 * filters or stride != 1:
                shapes.append((tag + ".proj", cin, 4 * filters, 1, out,
                               out))
            cin, side = 4 * filters, out
    return shapes


def resnet_forward_macs(*, stage_sizes, num_filters: int, image: int,
                        num_classes: int) -> dict:
    """Multiply-accumulates of one image's forward: each convolution's
    c_in c_out k^2 h_out w_out, and the head's c_in x classes. Returns
    {"total", "stem"} (the stem apart: its input gradient is never
    needed)."""
    shapes = resnet_conv_shapes(stage_sizes=stage_sizes,
                                num_filters=num_filters, image=image)
    convs = {s[0]: s[1] * s[2] * s[3] ** 2 * s[4] * s[5] for s in shapes}
    features = shapes[-1][2]
    return {"total": sum(convs.values()) + features * num_classes,
            "stem": convs["stem"]}


def resnet_train_step_flops(*, stage_sizes, num_filters: int, image: int,
                            num_classes: int, batch: int) -> int:
    """One optimizer step: 2 FLOPs a MAC; the backward's weight and
    input gradients each cost a forward, except the stem's input
    gradient, which the image does not need: 2 B (3 M - M_stem)."""
    m = resnet_forward_macs(stage_sizes=stage_sizes, num_filters=num_filters,
                            image=image, num_classes=num_classes)
    return 2 * batch * (3 * m["total"] - m["stem"])
