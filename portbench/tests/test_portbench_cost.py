"""The closed forms of ``portbench/cost`` against hand-worked values."""

import pytest

from portbench.cost import kernels, models, peaks


def test_gpt2_weights_and_step_flops():
    # 12 x (4 x 768^2 + 2 x 768 x 3072) + 768 x 50304
    n = 12 * (4 * 589_824 + 2 * 2_359_296) + 38_633_472
    assert n == 123_568_128
    assert models.gpt2_matmul_params(layers=12, d_model=768, d_ff=3072,
                                     vocab=50304) == n
    # 6 N T with T = 12 x 1024, and 12 d L B S(S+1)/2 for attention
    want = 6 * n * 12_288 + 12 * 768 * 12 * 12 * 524_800
    assert want == 9_806_895_120_384
    assert models.gpt2_train_step_flops(layers=12, d_model=768, d_ff=3072,
                                        vocab=50304, batch=12,
                                        seq=1024) == want


def test_gpt2_serving_flops_add_up():
    dims = dict(layers=2, d_model=8, d_ff=32, vocab=16)
    n = models.gpt2_matmul_params(**dims)
    assert n == 2 * (4 * 64 + 2 * 256) + 128
    head = 8 * 16
    # a chunk of 3 rows at positions 5, 6, 7 attends 6 + 7 + 8 keys; the
    # head multiplies only the prompt's last row
    chunk = models.gpt2_prefill_chunk_flops(start=5, rows=3,
                                            ends_prompt=False, **dims)
    assert chunk == 3 * 2 * (n - head) + 4 * 8 * 2 * 21
    last = models.gpt2_prefill_chunk_flops(start=5, rows=3,
                                           ends_prompt=True, **dims)
    assert last == chunk + 2 * head
    # a whole prompt in one chunk costs its rows' forwards, less the head
    # of every row but the last
    assert last == sum(models.gpt2_forward_token_flops(keys=k, **dims)
                       for k in (6, 7, 8)) - 2 * 2 * head


def test_gpt2_prefill_chunk_at_full_size():
    dims = dict(layers=12, d_model=768, d_ff=3072, vocab=50304)
    # N = 123,568,128, of which the head d x vocab is 38,633,472: a row
    # that is not a prompt's last multiplies 84,934,656 weights
    # (169,869,312 FLOPs); 128 rows from position 0 attend 128 x 129 / 2
    # = 8,256 pairs, 4 x 768 x 12 = 36,864 FLOPs each
    mid = models.gpt2_prefill_chunk_flops(start=0, rows=128,
                                          ends_prompt=False, **dims)
    assert mid == 21_743_271_936 + 304_349_184 == 22_047_621_120
    end = models.gpt2_prefill_chunk_flops(start=0, rows=128,
                                          ends_prompt=True, **dims)
    assert end - mid == 77_266_944


def test_resnet50_forward_macs():
    m = models.resnet_forward_macs(stage_sizes=(3, 4, 6, 3), num_filters=64,
                                   image=224, num_classes=1000)
    # the stem: 112 x 112 outputs, 64 filters of 3 x 7 x 7
    assert m["stem"] == 112 * 112 * 64 * 3 * 49 == 118_013_952
    # torchvision's ResNet-50 (v1.5) counts 4.09 GMACs at 224
    assert m["total"] == 4_089_184_256
    step = models.resnet_train_step_flops(
        stage_sizes=(3, 4, 6, 3), num_filters=64, image=224,
        num_classes=1000, batch=256)
    assert step == 2 * 256 * (3 * 4_089_184_256 - 118_013_952)


def test_resnet_shapes_first_stage_and_projection():
    shapes = models.resnet_conv_shapes(stage_sizes=(1, 1), num_filters=64,
                                       image=224)
    names = [s[0] for s in shapes]
    assert names == ["stem", "stage0.block0.conv0", "stage0.block0.conv1",
                     "stage0.block0.conv2", "stage0.block0.proj",
                     "stage1.block0.conv0", "stage1.block0.conv1",
                     "stage1.block0.conv2", "stage1.block0.proj"]
    # the stride sits on the 3x3 conv (v1.5): 56 -> 28 there
    assert shapes[5][4:] == (56, 56) and shapes[6][4:] == (28, 28)


@pytest.mark.parametrize("fn,flops,nbytes,ms", [
    # PERF.md's kernel table at B=8, H=12, S=1024, hd=64, bf16, causal
    (kernels.flash_fwd, 4 * 64 * 8 * 12 * 524_800,
     4 * 12_582_912 + 393_216, 0.01514),
    (kernels.flash_dq, 6 * 64 * 8 * 12 * 524_800,
     5 * 12_582_912 + 2 * 393_216, 0.01956),
    (kernels.flash_dkv, 8 * 64 * 8 * 12 * 524_800,
     6 * 12_582_912 + 2 * 393_216, 0.02608),
])
def test_flash_counts_match_the_kernel_table(fn, flops, nbytes, ms):
    c = fn(batch=8, heads=12, seq=1024, head_dim=64)
    assert c == {"flops": flops, "bytes": nbytes}
    assert peaks.least_seconds(c["flops"], c["bytes"]) * 1e3 == \
        pytest.approx(ms, abs=5e-6)


def test_paged_decode_and_prefill_counts():
    # two requests at 10 and 20 keys, 12 heads of 64 in bf16
    row = 12 * 64 * 2
    c = kernels.paged_decode(heads=12, head_dim=64, keys=[10, 20])
    assert c == {"flops": 4 * 64 * 12 * 30, "bytes": 2 * 30 * row
                 + 2 * 2 * row}
    # a chunk of 4 rows at 100..103 reads 104 keys and attends 101..104
    p = kernels.paged_prefill(heads=12, head_dim=64, start=100, rows=4)
    assert p == {"flops": 4 * 64 * 12 * (101 + 102 + 103 + 104),
                 "bytes": 2 * 104 * row + 2 * 4 * row}


def test_least_time_is_the_larger_bound():
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(989e9, 3.35e12) == pytest.approx(1.0)
