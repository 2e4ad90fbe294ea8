"""The port's record loader and importers (``data/native_loader.py``,
``data/native/dataloader.cpp``, ``data/importers.py``), held to the JAX
package's on the same files, and the JAX package's own loader and
importer tests as the port's cases.

Tolerances: every batch, record file and IDX file is compared bitwise
(the two packages share the file format, the RNG and the augmentation
draws). The slice as a whole (records -> the native loader ->
``DevicePrefetchIterator`` -> a small GPT's train step) holds its three
losses to the JAX step's on the same records and bridged weights at 1e-4
absolute, the five-step tolerance of ``tests/test_torch_training.py``
(float32; both sides sum the same products in other orders, and Adam
normalises each step).
"""

import gzip
import logging
import struct

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from distributed_tensorflow_guide_tpu.core.mesh import single_device_mesh
from distributed_tensorflow_guide_tpu.data import importers as jimp
from distributed_tensorflow_guide_tpu.data import native_loader as jnl
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.parallel.data_parallel import (
    DataParallel as JDataParallel,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.data import importers as imp
from distributed_tensorflow_guide_tpu_torch.data import native_loader as nl
from distributed_tensorflow_guide_tpu_torch.data.importers import (
    MNIST_FIELDS,
    decode_mnist_batch,
    import_idx_pair,
    import_mnist,
    read_idx,
    write_idx,
)
from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
    ImageAugment,
    NativeRecordLoader,
    PyRecordLoader,
    epoch_permutation,
    load_native_lib,
    make_fields,
    open_record_loader,
    write_records,
)
from distributed_tensorflow_guide_tpu_torch.data.prefetch import (
    DevicePrefetchIterator,
)
from distributed_tensorflow_guide_tpu_torch.models import mnist_cnn
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.train import hooks
from distributed_tensorflow_guide_tpu_torch.train.evaluation import Evaluator
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

FIELDS = make_fields({
    "image": (np.float32, (4, 4, 1)),
    "label": (np.int32, ()),
})


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny ops: one intra-op thread keeps them from spinning against the
    other test workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def record_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "train.records"
    rng = np.random.RandomState(0)
    n = 256
    cols = {
        "image": rng.randn(n, 4, 4, 1).astype(np.float32),
        "label": np.arange(n, dtype=np.int32),
    }
    write_records(path, cols, FIELDS)
    return path, cols


needs_native = pytest.mark.skipif(load_native_lib() is None,
                                  reason="no g++ toolchain")


# -- the JAX package's loader tests, as the port's cases --------------------


def test_append_validates_record_size(tmp_path):
    """Headerless fixed-size records: appending another field layout
    refuses instead of silently corrupting the stream."""
    path = tmp_path / "x.records"
    cols = {"image": np.zeros((4, 4, 4, 1), np.float32),
            "label": np.arange(4, dtype=np.int32)}
    write_records(path, cols, FIELDS)
    write_records(path, cols, FIELDS, append=True)
    other = make_fields({"vec": (np.float32, (5,))})
    with pytest.raises(ValueError, match="record_bytes"):
        write_records(path, {"vec": np.zeros((4, 5), np.float32)}, other,
                      append=True)
    fresh = tmp_path / "y.records"
    write_records(fresh, {"vec": np.zeros((4, 5), np.float32)}, other,
                  append=True)
    assert fresh.stat().st_size == 4 * 20


def test_permutation_is_deterministic_and_complete():
    p1 = epoch_permutation(100, seed=7, epoch=3)
    p2 = epoch_permutation(100, seed=7, epoch=3)
    assert np.array_equal(p1, p2)
    assert sorted(p1) == list(range(100))
    assert not np.array_equal(p1, epoch_permutation(100, seed=7, epoch=4))
    assert not np.array_equal(p1, epoch_permutation(100, seed=8, epoch=3))


def test_python_loader_decodes_fields(record_file):
    path, cols = record_file
    dl = PyRecordLoader(path, FIELDS, batch_size=32, shuffle=False)
    b = dl.next_batch()
    assert b["image"].shape == (32, 4, 4, 1)
    assert b["label"].shape == (32,)
    np.testing.assert_array_equal(b["label"], np.arange(32))
    np.testing.assert_array_equal(b["image"], cols["image"][:32])


@needs_native
def test_native_matches_python_twin(record_file):
    path, _ = record_file
    kw = dict(batch_size=16, shuffle=True, seed=11)
    native = NativeRecordLoader(path, FIELDS, **kw)
    twin = PyRecordLoader(path, FIELDS, **kw)
    assert native.batches_per_epoch == twin.batches_per_epoch == 16
    for _ in range(2 * native.batches_per_epoch):
        nb, pb = native.next_batch(), twin.next_batch()
        np.testing.assert_array_equal(nb["label"], pb["label"])
        np.testing.assert_array_equal(nb["image"], pb["image"])
    native.close()


@needs_native
def test_native_shards_are_disjoint_and_cover(record_file):
    path, _ = record_file
    seen = []
    for shard in range(4):
        dl = NativeRecordLoader(path, FIELDS, batch_size=16, shard_id=shard,
                                num_shards=4, shuffle=True, seed=5)
        labels = np.concatenate([dl.next_batch()["label"]
                                 for _ in range(dl.batches_per_epoch)])
        seen.append(labels)
        dl.close()
    allseen = np.concatenate(seen)
    assert len(allseen) == 256
    assert len(set(allseen.tolist())) == 256


@needs_native
def test_native_epoch_order_differs(record_file):
    path, _ = record_file
    dl = NativeRecordLoader(path, FIELDS, batch_size=64, shuffle=True, seed=1)
    e0 = np.concatenate([dl.next_batch()["label"] for _ in range(4)])
    e1 = np.concatenate([dl.next_batch()["label"] for _ in range(4)])
    dl.close()
    assert sorted(e0.tolist()) == sorted(e1.tolist()) == list(range(256))
    assert not np.array_equal(e0, e1)


@needs_native
def test_native_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.records"
    bad.write_bytes(b"\x00" * 37)
    with pytest.raises(ValueError):
        NativeRecordLoader(bad, FIELDS, batch_size=4)


def test_open_record_loader_falls_back(record_file, monkeypatch, caplog):
    path, _ = record_file
    monkeypatch.setattr(nl, "load_native_lib", lambda: None)
    with caplog.at_level(logging.WARNING, logger="dtg.data"):
        dl = open_record_loader(path, FIELDS, 16, shuffle=False, prefetch=2)
    assert isinstance(dl, PyRecordLoader)
    assert dl.next_batch()["label"].shape == (16,)
    assert "native loader unavailable" in caplog.text


@needs_native
def test_native_pooled_gather_large_records(tmp_path):
    # batch*record > 64KB exercises the persistent worker pool
    fields = make_fields({"x": (np.float32, (1024,))})
    rng = np.random.RandomState(1)
    cols = {"x": rng.randn(128, 1024).astype(np.float32)}
    path = tmp_path / "big.records"
    write_records(path, cols, fields)
    kw = dict(batch_size=32, shuffle=True, seed=9)
    native = NativeRecordLoader(path, fields, n_threads=4, **kw)
    twin = PyRecordLoader(path, fields, **kw)
    for _ in range(3 * native.batches_per_epoch):
        np.testing.assert_array_equal(native.next_batch()["x"],
                                      twin.next_batch()["x"])
    native.close()


@needs_native
def test_native_prefetch_throughput_smoke(record_file):
    # not a benchmark: the ring survives rapid consumption over ~6 epochs
    path, _ = record_file
    dl = NativeRecordLoader(path, FIELDS, batch_size=8, prefetch=8,
                            n_threads=2, shuffle=True, seed=3)
    for _ in range(200):
        dl.next_batch()
    dl.close()


AUG_FIELDS = make_fields({
    "image": (np.uint8, (40, 40, 3)),
    "label": (np.int32, ()),
})
AUG = ImageAugment(in_shape=(40, 40, 3), crop=(32, 32), hflip=True)


@pytest.fixture(scope="module")
def aug_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("aug") / "imgs.records"
    rng = np.random.RandomState(3)
    n = 64
    cols = {"image": rng.randint(0, 256, (n, 40, 40, 3)).astype(np.uint8),
            "label": np.arange(n, dtype=np.int32)}
    write_records(path, cols, AUG_FIELDS)
    return path, cols


@needs_native
def test_augmented_native_matches_python_twin(aug_file):
    path, _ = aug_file
    kw = dict(batch_size=8, shuffle=True, seed=5, augment=AUG)
    nat = NativeRecordLoader(path, AUG_FIELDS, **kw)
    py = PyRecordLoader(path, AUG_FIELDS, **kw)
    assert nat.batches_per_epoch == py.batches_per_epoch == 8
    for i in range(20):  # 2.5 epochs
        a, b = nat.next_batch(), py.next_batch()
        assert a["image"].shape == (8, 32, 32, 3)
        np.testing.assert_array_equal(a["image"], b["image"], err_msg=str(i))
        np.testing.assert_array_equal(a["label"], b["label"])
    nat.close()


def test_augmentation_pinned_to_seed_epoch_index(aug_file):
    """Draws are a pure function of (seed, epoch, record index)."""
    path, cols = aug_file
    py = PyRecordLoader(path, AUG_FIELDS, batch_size=64, shuffle=False,
                        seed=5, augment=AUG)
    plain = py.next_batch()
    sh = PyRecordLoader(path, AUG_FIELDS, batch_size=64, shuffle=True,
                        seed=5, augment=AUG)
    shuffled = sh.next_batch()
    order = np.argsort(shuffled["label"])
    np.testing.assert_array_equal(shuffled["image"][order], plain["image"])
    e1 = py.next_batch()
    assert py._epoch == 1
    assert not np.array_equal(e1["image"], plain["image"])
    other = PyRecordLoader(path, AUG_FIELDS, batch_size=64, shuffle=False,
                           seed=6, augment=AUG)
    assert not np.array_equal(other.next_batch()["image"], plain["image"])
    src = cols["image"][0]
    out = plain["image"][0]
    assert any(
        np.array_equal(src[y:y + 32, x:x + 32], cand)
        for cand in (out, out[:, ::-1])
        for y in range(9) for x in range(9))


def test_augment_spec_validation(aug_file):
    path, _ = aug_file
    with pytest.raises(ValueError, match="must fit"):
        ImageAugment(in_shape=(40, 40, 3), crop=(41, 32))
    bad = make_fields({"label": (np.int32, ()),
                       "image": (np.uint8, (40, 40, 3))})
    with pytest.raises(ValueError, match="leading uint8 image"):
        PyRecordLoader(path, bad, batch_size=8, augment=AUG)


# -- the port's build ----------------------------------------------------------


def test_build_is_keyed_on_the_source_hash_under_build_dir(tmp_path,
                                                          monkeypatch):
    """The library goes to ``$DTG_TORCH_BUILD_DIR/native`` (``build/native``
    by default), named by the hash of the port's own source and flags —
    never the JAX package's ``~/.cache/dtg_native/dataloader_<mtime>.so``;
    a second build reuses it."""
    monkeypatch.setenv("DTG_TORCH_BUILD_DIR", str(tmp_path))
    so = nl.build_native_lib()
    assert so.parent == tmp_path / "native"
    assert so.name == f"libdataloader_{nl.source_digest()[:16]}.so"
    mtime = so.stat().st_mtime_ns
    assert nl.build_native_lib() == so and so.stat().st_mtime_ns == mtime
    assert list(so.parent.iterdir()) == [so]  # no temporary left behind
    assert nl._SRC != jnl._SRC and "_torch" in str(nl._SRC)
    monkeypatch.delenv("DTG_TORCH_BUILD_DIR")
    assert nl.native_build_dir().parts[-2:] == ("build", "native")


def test_a_failed_build_says_why(tmp_path, monkeypatch, caplog):
    """Without g++ the loader raises with the reason, and
    ``open_record_loader`` falls back to the twin with a warning saying
    it."""
    monkeypatch.setenv("DTG_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    path = tmp_path / "r.records"
    write_records(path, {"image": np.zeros((4, 4, 4, 1), np.float32),
                         "label": np.arange(4, dtype=np.int32)}, FIELDS)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        NativeRecordLoader(path, FIELDS, batch_size=2)
    with caplog.at_level(logging.WARNING, logger="dtg.data"):
        dl = open_record_loader(path, FIELDS, 2)
    assert isinstance(dl, PyRecordLoader)
    assert "g++" in caplog.text


# -- parity with the JAX package: files and streams bitwise ----------------

CASES = {
    "plain": dict(shuffle=True, seed=11),
    "shard0of2": dict(shuffle=True, seed=4, shard_id=0, num_shards=2),
    "shard1of2": dict(shuffle=True, seed=4, shard_id=1, num_shards=2),
    "unshuffled": dict(shuffle=False),
    "augment": dict(shuffle=True, seed=5, augment=True),
}


def _stream(loader, n):
    out = [loader.next_batch() for _ in range(n)]
    loader.close()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_streams_equal_the_jax_packages(case, record_file, aug_file):
    """The same (path, fields, seed, shard, augment) give byte-equal
    batches over two epochs from the port's native loader and twin and
    the JAX package's twin and native loader."""
    kw = dict(CASES[case])
    if kw.pop("augment", False):
        (path, _), fields, bs = aug_file, AUG_FIELDS, 8
        pkw, jkw = dict(augment=AUG), dict(augment=jnl.ImageAugment(
            in_shape=AUG.in_shape, crop=AUG.crop, hflip=AUG.hflip))
    else:
        (path, _), fields, bs = record_file, FIELDS, 16
        pkw, jkw = {}, {}
    jfields = jnl.make_fields({f.name: (f.dtype, f.shape) for f in fields})
    twin = PyRecordLoader(path, fields, bs, **kw, **pkw)
    n = 2 * twin.batches_per_epoch
    streams = {"port/py": _stream(twin, n),
               "jax/py": _stream(jnl.PyRecordLoader(path, jfields, bs, **kw,
                                                    **jkw), n)}
    if load_native_lib() is not None:
        streams["port/native"] = _stream(
            NativeRecordLoader(path, fields, bs, **kw, **pkw), n)
    if jnl.load_native_lib() is not None:
        streams["jax/native"] = _stream(
            jnl.NativeRecordLoader(path, jfields, bs, **kw, **jkw), n)
    assert "port/native" in streams or load_native_lib() is None
    ref = streams.pop("port/py")
    for name, got in streams.items():
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"{name} batch {i}")


@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (100, 7, 3),
                                          (4097, 2 ** 40 + 3, 11)])
def test_epoch_permutation_equals_the_jax_packages(n, seed, epoch):
    np.testing.assert_array_equal(epoch_permutation(n, seed, epoch),
                                  jnl.epoch_permutation(n, seed, epoch))


def test_record_files_are_byte_equal_and_cross_read(tmp_path, aug_file):
    """``write_records`` of either package writes the same bytes (fresh
    and appended), and each package's twin reads the other's file."""
    _, cols = aug_file
    jfields = jnl.make_fields({f.name: (f.dtype, f.shape)
                               for f in AUG_FIELDS})
    mine, theirs = tmp_path / "port.records", tmp_path / "jax.records"
    for i, lo in enumerate(range(0, 64, 24)):
        part = {k: v[lo:lo + 24] for k, v in cols.items()}
        write_records(mine, part, AUG_FIELDS, append=i > 0)
        jnl.write_records(theirs, part, jfields, append=i > 0)
    assert mine.read_bytes() == theirs.read_bytes()
    a = PyRecordLoader(theirs, AUG_FIELDS, 64, shuffle=False).next_batch()
    b = jnl.PyRecordLoader(mine, jfields, 64, shuffle=False).next_batch()
    for k in cols:
        np.testing.assert_array_equal(a[k], cols[k])
        np.testing.assert_array_equal(b[k], cols[k])


@needs_native
def test_no_batch_is_overwritten_by_a_later_one(record_file):
    """Every batch owns its memory: after three draws, the first two still
    equal the twin's (a view of the reused ctypes buffer would hold the
    third's bytes)."""
    path, _ = record_file
    nat = NativeRecordLoader(path, FIELDS, 16, seed=2, prefetch=2)
    twin = PyRecordLoader(path, FIELDS, 16, seed=2)
    got = [nat.next_batch() for _ in range(3)]
    want = [twin.next_batch() for _ in range(2)]
    nat.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
    assert not np.shares_memory(got[0]["label"], got[1]["label"])


# -- the slice as a whole ------------------------------------------------------

GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_len=16, causal=True)


@needs_native
def test_native_loader_feeds_the_train_step_as_in_jax(tmp_path):
    """The counterpart of the JAX package's
    ``test_native_loader_feeds_pipelined_lm``: token records -> the port's
    native loader -> ``DevicePrefetchIterator(device="cpu")`` -> int32
    widened to int64 after the copy -> ``TrainLoop`` over the port's
    ``DataParallel`` step, three Adam steps, against the JAX step fed by
    the JAX package's loader from the same file with bridged weights."""
    jcfg = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
    fields = make_fields({"tokens": (np.int32, (GEOM["max_len"],))})
    path = tmp_path / "tokens.records"
    rng = np.random.RandomState(0)
    write_records(path, {"tokens": rng.randint(
        0, GEOM["vocab_size"], (64, GEOM["max_len"])).astype(np.int32)},
        fields)
    B, lr = 8, 1e-2

    jparams = jtf.Transformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jmodel = jtf.Transformer(jcfg)
    jdp = JDataParallel(single_device_mesh())
    jstep = jdp.make_train_step(jtf.make_lm_loss_fn(jmodel, fused_ce=False),
                                donate=False)
    jstate = jdp.replicate(train_state.TrainState.create(
        apply_fn=jmodel.apply, params=jparams, tx=optax.adam(lr)))
    jloader = jnl.open_record_loader(
        path, jnl.make_fields({"tokens": (np.int32, (GEOM["max_len"],))}),
        B, seed=3)
    j_losses = []
    for _ in range(3):
        jstate, m = jstep(jstate, jdp.shard_batch(jloader.next_batch()))
        j_losses.append(float(m["loss"]))
    jloader.close()

    model = ttf.Transformer(tcfg)
    model.load_state_dict(bridge.params_from_flax(
        jax.tree.map(np.asarray, fnn.meta.unbox(jparams)), tcfg))
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=lr))
    step = DataParallel(device="cpu").make_train_step(
        ttf.make_lm_loss_fn(model, fused_ce=False))
    loader = NativeRecordLoader(path, fields, B, seed=3)
    feed = DevicePrefetchIterator(loader, device="cpu", depth=2)
    seen, dtypes = [], []

    def widened():
        for b in feed:
            dtypes.append(b["tokens"].dtype)
            yield {"tokens": b["tokens"].long()}

    class Record(hooks.BaseHook):
        def after_step(self, step, metrics):
            seen.append(metrics["loss"].item())

    TrainLoop(step, state, widened(), hooks=[hooks.StopAtStepHook(3),
                                             Record()], device="cpu").run()
    loader.close()
    assert dtypes == [torch.int32] * 3  # the records' dtype crosses
    assert feed.stats.batches == 3 and feed.stats.peak_ahead == 2
    np.testing.assert_allclose(seen, j_losses, atol=1e-4)


# -- the JAX package's importer tests, as the port's cases ------------------


def _pack_idx_by_hand(arr: np.ndarray, code: int) -> bytes:
    """Independent IDX packer (big-endian, straight from the spec)."""
    out = bytes([0, 0, code, arr.ndim])
    out += struct.pack(f">{arr.ndim}I", *arr.shape)
    return out + arr.astype(arr.dtype.newbyteorder(">")).tobytes()


IDX_CODES = [(np.uint8, 0x08), (np.int8, 0x09), (np.int16, 0x0B),
             (np.int32, 0x0C), (np.float32, 0x0D), (np.float64, 0x0E)]


@pytest.mark.parametrize("dtype,code", IDX_CODES)
def test_read_idx_all_dtypes_vs_hand_packed(tmp_path, dtype, code):
    rng = np.random.RandomState(0)
    arr = (rng.randn(5, 3, 4) * 50).astype(dtype)
    p = tmp_path / "x.idx"
    p.write_bytes(_pack_idx_by_hand(arr, code))
    got = read_idx(p)
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == np.dtype(dtype)


def test_write_read_roundtrip_and_gzip(tmp_path):
    rng = np.random.RandomState(1)
    arr = rng.randint(0, 256, (7, 28, 28)).astype(np.uint8)
    plain = tmp_path / "r.idx"
    write_idx(plain, arr)
    assert plain.read_bytes() == _pack_idx_by_hand(arr, 0x08)
    gz = tmp_path / "r.idx.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    np.testing.assert_array_equal(read_idx(plain), arr)
    np.testing.assert_array_equal(read_idx(gz), arr)


def test_read_idx_rejects_garbage(tmp_path):
    p = tmp_path / "bad.idx"
    p.write_bytes(b"\x01\x02\x03\x04more")
    with pytest.raises(ValueError, match="magic"):
        read_idx(p)
    p.write_bytes(bytes([0, 0, 0x08, 1]) + struct.pack(">I", 10) + b"short")
    with pytest.raises(ValueError, match="payload"):
        read_idx(p)


def _write_mnist_dir(d, with_test: bool = True):
    """A synthetic MNIST-shaped IDX directory, gzipped like the real
    distribution: 64 images of 28x28. Returns the train arrays."""
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (64, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (64,)).astype(np.uint8)
    arrays = [("train-images-idx3-ubyte", images),
              ("train-labels-idx1-ubyte", labels)]
    if with_test:
        arrays += [("t10k-images-idx3-ubyte",
                    rng.randint(0, 256, (64, 28, 28)).astype(np.uint8)),
                   ("t10k-labels-idx1-ubyte",
                    rng.randint(0, 10, (64,)).astype(np.uint8))]
    d.mkdir()
    for stem, arr in arrays:
        tmp = d / stem
        write_idx(tmp, arr)
        (d / f"{stem}.gz").write_bytes(gzip.compress(tmp.read_bytes()))
        tmp.unlink()  # only the .gz form, as downloaded
    return images, labels


@pytest.fixture()
def mnist_dir(tmp_path):
    d = tmp_path / "mnist"
    images, labels = _write_mnist_dir(d)
    return d, images, labels


def test_import_mnist_to_records_and_loader_parity(mnist_dir, tmp_path):
    d, images, labels = mnist_dir
    rec = import_mnist(d, tmp_path / "out")
    py = PyRecordLoader(rec, MNIST_FIELDS, batch_size=16, shuffle=False)
    got_img, got_lbl = [], []
    for _ in range(py.batches_per_epoch):
        b = py.next_batch()
        got_img.append(b["image"])
        got_lbl.append(b["label"])
    np.testing.assert_array_equal(np.concatenate(got_img), images[..., None])
    np.testing.assert_array_equal(np.concatenate(got_lbl),
                                  labels.astype(np.int32))
    dec = decode_mnist_batch({"image": images[..., None], "label": labels})
    assert dec["image"].dtype == np.float32
    assert dec["image"].max() <= 1.0 and dec["image"].min() >= 0.0
    if load_native_lib() is None:
        pytest.skip("no C++ toolchain")
    nat = NativeRecordLoader(rec, MNIST_FIELDS, batch_size=16, seed=3)
    pyt = PyRecordLoader(rec, MNIST_FIELDS, batch_size=16, seed=3)
    for _ in range(2 * nat.batches_per_epoch):
        bn, bp = nat.next_batch(), pyt.next_batch()
        np.testing.assert_array_equal(bn["image"], bp["image"])
        np.testing.assert_array_equal(bn["label"], bp["label"])
    nat.close()


def test_import_mnist_idempotent(mnist_dir, tmp_path):
    d, _, _ = mnist_dir
    rec1 = import_mnist(d, tmp_path / "out")
    mtime = rec1.stat().st_mtime_ns
    rec2 = import_mnist(d, tmp_path / "out")
    assert rec1 == rec2 and rec2.stat().st_mtime_ns == mtime  # no rewrite


def test_import_idx_pair_validates(tmp_path):
    imgs = tmp_path / "i.idx"
    lbls = tmp_path / "l.idx"
    write_idx(imgs, np.zeros((4, 5, 5), np.uint8))
    write_idx(lbls, np.zeros((3,), np.uint8))  # wrong count
    with pytest.raises(ValueError, match="pair"):
        import_idx_pair(imgs, lbls, tmp_path / "o.records")


@needs_native
def test_mnist_trains_from_imported_records(mnist_dir, tmp_path):
    """The JAX package's ``mnist_sync_dp.py --data <dir>`` check, in the
    port: imported records -> the native loader -> the device prefetch ->
    normalised after the copy -> the MNIST CNN's step, 4 steps, then a
    held-out evaluation on the imported t10k split."""
    d, _, _ = mnist_dir
    train = import_mnist(d, tmp_path / "out")
    test = import_mnist(d, tmp_path / "out", split="test")
    loader = NativeRecordLoader(train, MNIST_FIELDS, 32, seed=0)
    assert loader.num_records == 64

    def decoded(src):
        for b in DevicePrefetchIterator(src, device="cpu"):
            yield {"image": b["image"].float() / 255.0, "label": b["label"]}

    model = mnist_cnn.MNISTCNN().init_weights(0)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.05,
                                              momentum=0.9))
    dp = DataParallel(device="cpu")
    losses = []

    class Record(hooks.BaseHook):
        def after_step(self, step, metrics):
            losses.append(metrics["loss"].item())

    TrainLoop(dp.make_train_step(mnist_cnn.make_loss_fn(model)), state,
              decoded(loader), hooks=[hooks.StopAtStepHook(4), Record()],
              device="cpu").run()
    loader.close()
    assert len(losses) == 4 and all(np.isfinite(losses))
    held_out = PyRecordLoader(test, MNIST_FIELDS, 32, shuffle=False)
    ev = Evaluator(dp.make_eval_step(mnist_cnn.make_metric_fn(model)),
                   lambda: decoded(iter([held_out.next_batch()
                                         for _ in range(2)])))
    metrics = ev.run(state)
    acc = metrics["accuracy"]
    assert metrics["eval_batches"] == 2 and 0.0 <= acc <= 1.0


def test_mnist_without_a_test_split_raises_naming_it(tmp_path):
    """A train-only download imports its train split; asking for the
    missing test split names the files it looked for."""
    d = tmp_path / "mnist"
    _write_mnist_dir(d, with_test=False)
    assert import_mnist(d, tmp_path / "out").exists()
    with pytest.raises(FileNotFoundError, match="t10k-images-idx3-ubyte"):
        import_mnist(d, tmp_path / "out", split="test")


# -- importers: parity with the JAX package ----------------------------------


@pytest.mark.parametrize("dtype,code", IDX_CODES)
def test_idx_files_equal_the_jax_packages(tmp_path, dtype, code):
    """``write_idx`` writes the JAX package's bytes, and ``read_idx`` of
    either package reads the other's file (raw and gzipped) to the same
    array, for every IDX dtype code."""
    arr = (np.random.RandomState(code).randn(3, 5, 2) * 50).astype(dtype)
    mine, theirs = tmp_path / "port.idx", tmp_path / "jax.idx"
    write_idx(mine, arr)
    jimp.write_idx(theirs, arr)
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_bytes()[2] == code
    for p in (mine, theirs):
        gz = p.with_suffix(".idx.gz")
        gz.write_bytes(gzip.compress(p.read_bytes(), mtime=0))
        for reader in (read_idx, jimp.read_idx):
            for src in (p, gz):
                got = reader(src)
                assert got.dtype == np.dtype(dtype)
                np.testing.assert_array_equal(got, arr)


def test_mnist_record_files_equal_the_jax_packages(mnist_dir, tmp_path):
    d, _, _ = mnist_dir
    for split in ("train", "test"):
        mine = import_mnist(d, tmp_path / "port", split=split)
        theirs = jimp.import_mnist(d, tmp_path / "jax", split=split)
        assert mine.name == theirs.name
        assert mine.read_bytes() == theirs.read_bytes()
    assert [(f.name, f.dtype, f.shape) for f in MNIST_FIELDS] == [
        (f.name, f.dtype, f.shape) for f in jimp.MNIST_FIELDS]
    assert imp.decode_mnist_batch({"image": np.full((1, 2), 255, np.uint8),
                                   "label": np.zeros(1, np.int32)})[
        "image"].tolist() == [[1.0, 1.0]]
