"""The port's HDF5 codec (asr_using_robust_nn_tpu_torch/utils/hdf5.py) and
the .h5 interop on it (train/checkpoints.py::export_h5, import_keras_h5),
held against h5py and the JAX package's interop, which reads and writes
through h5py: the same arrays and attributes, bit for bit.

Files come from the JAX package's `export_h5`, from h5py at its defaults
and with `libver="latest"`, from Keras (the committed fixtures under
tests/data/, written by tests/data/make_keras_fixtures.py) and from the
port's own writer. Small widths throughout.
"""

import ast
import os
import sys

import h5py
import jax
import numpy as np
import pytest

from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.train import checkpoints as jck
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import params_from_numpy
from asr_using_robust_nn_tpu_torch.train import checkpoints as ck
from asr_using_robust_nn_tpu_torch.utils.hdf5 import (lookup3, read_h5,
                                                      write_h5)

DATA = os.path.join(os.path.dirname(__file__), "data")
KW = dict(in_dim=16, n_classes=4, hidden=(32, 16), dropout=(0.0, 0.0))


def _h5py_read(path):
    """(datasets, attrs) as h5py reads them, in `visititems` order."""
    datasets, attrs = {}, {}
    with h5py.File(path, "r") as f:
        attrs[""] = dict(f.attrs)

        def visit(name, obj):
            attrs[name] = dict(obj.attrs)
            if isinstance(obj, h5py.Dataset):
                datasets[name] = obj[()]

        f.visititems(visit)
    return datasets, attrs


def _same_value(got, want, where):
    if isinstance(want, h5py.Empty):
        assert got is None, where
        return
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where
    else:
        assert got == want or (got != got and want != want), where


def _same_as_h5py(path):
    """The port's reading of `path` is h5py's, array for array, attribute
    for attribute, in the same order."""
    got_d, got_a = read_h5(path)
    want_d, want_a = _h5py_read(path)
    assert list(got_d) == list(want_d)
    assert list(got_a) == list(want_a)
    for k, v in want_d.items():
        _same_value(got_d[k], v, k)
    for k, v in want_a.items():
        assert sorted(got_a[k]) == sorted(v), k
        for name, value in v.items():
            _same_value(got_a[k][name], value, f"{k}@{name}")
    return got_d, got_a


def _jax_trees(seed=0, **kw):
    jcfg = jmlp.MLPConfig(**dict(KW, **kw))
    p, s = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, mlp.MLPConfig(**dict(KW, **kw)), p, s


def _equal_trees(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


# -- the reader against h5py ------------------------------------------------

@pytest.mark.parametrize("batch_norm", [True, False])
def test_reads_the_jax_export(tmp_path, batch_norm):
    jcfg, cfg, p, s = _jax_trees(seed=1, batch_norm=batch_norm)
    jck.export_h5(tmp_path / "j.h5", p, s)
    _same_as_h5py(tmp_path / "j.h5")
    _equal_trees(ck.import_keras_h5(tmp_path / "j.h5", cfg),
                 jck.import_keras_h5(tmp_path / "j.h5", jcfg))


@pytest.mark.parametrize("n", [9, 15, 40, 300])
def test_reads_h5py_groups_of_many_entries(tmp_path, n):
    """More than 8 entries in a group spread over several SNODs; 300 need a
    group B-tree of more than one node."""
    rng = np.random.default_rng(n)
    with h5py.File(tmp_path / "g.h5", "w") as f:
        g = f.create_group("g")
        for i in rng.permutation(n):
            g.create_dataset(f"d{i}", data=rng.standard_normal(3))
        g.attrs["n"] = n
    d, _ = _same_as_h5py(tmp_path / "g.h5")
    assert len(d) == n


def test_reads_h5py_latest(tmp_path):
    """libver="latest": superblock v3, OHDR headers (lookup3 checksums),
    compact link storage, attribute messages v3, layout v4, an object
    header continuation (OCHK) grown after the datasets."""
    with h5py.File(tmp_path / "l.h5", "w", libver="latest") as f:
        g = f.create_group("a")
        for i in range(8):
            g.create_dataset(f"x{i}", data=np.arange(i + 1, dtype="<i4"))
        f.create_dataset("b/y", data=np.ones((2, 3), ">f8"))
        for i in range(8):
            g.attrs[f"note{i}"] = "a longer text " * 20
        f.attrs["scalar"] = np.float32(1.5)
    with open(tmp_path / "l.h5", "rb") as fh:
        raw = fh.read()
    assert raw[8] == 3 and b"OHDR" in raw and b"OCHK" in raw
    _same_as_h5py(tmp_path / "l.h5")


def test_reads_datatypes_and_shapes(tmp_path):
    """float64, int32, big-endian, unsigned and half datasets; scalar,
    zero-size, unallocated (fill value) and compact datasets; fixed and
    variable-length string attributes and datasets; a null attribute; a
    second hard link and a soft link (h5py's walk visits an object once and
    follows no soft link)."""
    rng = np.random.default_rng(3)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        f.create_dataset("f64", data=rng.standard_normal((4, 3)))
        f.create_dataset("i32", data=rng.integers(-9, 9, 7).astype("<i4"))
        f.create_dataset("be_f4", data=rng.standard_normal(5).astype(">f4"))
        f.create_dataset("be_i8", data=np.arange(6, dtype=">i8"))
        f.create_dataset("u8", data=np.arange(9, dtype=np.uint8))
        f.create_dataset("f16", data=rng.standard_normal(4).astype("<f2"))
        f.create_dataset("scalar", data=np.float32(2.25))
        f.create_dataset("empty", data=np.zeros((0, 3), np.float32))
        f.create_dataset("fill", shape=(5,), dtype="f4", fillvalue=3.5)
        f.create_dataset("unset", shape=(2, 2), dtype="i2")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((6,))
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32, space,
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                         np.arange(6, dtype=np.int32))
        f.create_dataset("vlen", data=np.array([b"ab", b"", b"xyz" * 30],
                                               object),
                         dtype=h5py.string_dtype("ascii"))
        f.create_dataset("fixed", data=np.array([b"one", b"three"], "S5"))
        f["alias"] = f["f64"]
        f["soft"] = h5py.SoftLink("/i32")
        a = f["f64"].attrs
        a["fixed_arr"] = np.asarray([b"dense/kernel:0", b"b"], "S64")
        a["fixed_scalar"] = np.bytes_(b"tensorflow")
        a["vlen_scalar"] = "keras 3"
        a["vlen_utf8"] = "grüße"
        a["vlen_arr"] = np.array(["a", "bc", ""], dtype=h5py.string_dtype())
        a["num"] = np.arange(3, dtype=">f8")
        a["num_scalar"] = np.int64(-4)
        a["none"] = h5py.Empty("f4")
        f.attrs["root"] = 1
    d, _ = _same_as_h5py(tmp_path / "t.h5")
    assert "alias" in d and "f64" not in d and "soft" not in d
    assert np.array_equal(d["fill"], np.full(5, 3.5, np.float32))


def test_reads_the_keras_fixtures_bit_for_bit():
    """The committed Keras files: h5py's reading, and through
    `import_keras_h5` the arrays Keras held, bit for bit, as the JAX
    package's `import_keras_h5` reads them."""
    held = np.load(os.path.join(DATA, "keras_small_weights.npz"))
    cfg = mlp.MLPConfig(**dict(KW, dropout=(0.4, 0.4)))
    jcfg = jmlp.MLPConfig(**dict(KW, dropout=(0.4, 0.4)))
    for name in ("keras3_small.weights.h5", "keras_legacy_small.h5"):
        path = os.path.join(DATA, name)
        _same_as_h5py(path)
        p, s = ck.import_keras_h5(path, cfg)
        for i, dense in enumerate(("dense", "dense_1", "dense_2")):
            assert np.array_equal(p["layers"][i]["w"], held[f"{dense}/kernel"])
            assert np.array_equal(p["layers"][i]["b"], held[f"{dense}/bias"])
        for i, bn in enumerate(("batch_normalization",
                                "batch_normalization_1")):
            for key, var in (("gamma", "gamma"), ("beta", "beta")):
                assert np.array_equal(p["layers"][i][key],
                                      held[f"{bn}/{var}"])
            for key, var in (("mean", "moving_mean"),
                             ("var", "moving_variance")):
                assert np.array_equal(s["layers"][i][key],
                                      held[f"{bn}/{var}"])
        _equal_trees((p, s), jck.import_keras_h5(path, jcfg))


def test_import_of_a_group_of_many_layers_matches_jax(tmp_path):
    """A 6-Dense / 5-BN model: 11 entries in `model_weights/`, written by
    h5py (the JAX export), read by both packages' importers alike."""
    hidden = (8,) * 5
    jcfg, cfg, p, s = _jax_trees(seed=5, hidden=hidden,
                                 dropout=(0.0,) * len(hidden))
    jck.export_h5(tmp_path / "deep.h5", p, s)
    _same_as_h5py(tmp_path / "deep.h5")
    _equal_trees(ck.import_keras_h5(tmp_path / "deep.h5", cfg),
                 jck.import_keras_h5(tmp_path / "deep.h5", jcfg))


# -- the writer --------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 9, 300])
def test_writer_files_read_in_h5py(tmp_path, n):
    """h5py reads what write_h5 wrote: groups of 1..300 entries (300 need a
    two-level group B-tree), numeric dtypes, scalars, zero-size arrays and
    fixed-length string attributes on groups, datasets and the root."""
    rng = np.random.default_rng(n)
    datasets = {f"g/sub/d{i:03d}": rng.standard_normal(i % 5 + 1)
                .astype("<f4") for i in rng.permutation(n)}
    datasets.update({"a/f64": rng.standard_normal((3, 2)),
                     "a/i32": np.arange(5, dtype=np.int32),
                     "a/be": np.arange(4, dtype=">f4"),
                     "a/scalar": np.float32(7.0),
                     "a/empty": np.zeros((0,), np.float32)})
    attrs = {"": {"backend": np.bytes_(b"tensorflow")},
             "g": {"names": np.asarray([b"x", b"yy"], "S64")},
             "a/f64": {"scale": np.float64(0.5)}}
    write_h5(tmp_path / "w.h5", datasets, attrs)
    got_d, got_a = _same_as_h5py(tmp_path / "w.h5")
    for k, v in datasets.items():
        want = np.asarray(v).astype(np.asarray(v).dtype.newbyteorder("<"))
        assert got_d[k].dtype == want.dtype and np.array_equal(got_d[k], want)
    assert got_a["g"]["names"].tolist() == [b"x", b"yy"]
    assert got_a[""]["backend"] == b"tensorflow"
    assert os.path.getsize(tmp_path / "w.h5") == int.from_bytes(
        open(tmp_path / "w.h5", "rb").read()[40:48], "little")  # EOF address


@pytest.mark.parametrize("batch_norm", [True, False])
def test_port_export_reads_in_h5py_and_jax(tmp_path, batch_norm):
    """The port's export_h5: h5py sees the JAX export's arrays and
    attributes, and the JAX `import_keras_h5` returns what was written, bit
    for bit."""
    jcfg, cfg, p, s = _jax_trees(seed=6, batch_norm=batch_norm)
    ck.export_h5(tmp_path / "port.h5", *params_from_numpy(p, s, "cpu"))
    jck.export_h5(tmp_path / "jax.h5", p, s)
    got_d, got_a = _same_as_h5py(tmp_path / "port.h5")
    want_d, want_a = _h5py_read(tmp_path / "jax.h5")
    assert list(got_d) == list(want_d) and list(got_a) == list(want_a)
    for k in want_d:
        _same_value(got_d[k], want_d[k], k)
    for k in want_a:
        for name, value in want_a[k].items():
            _same_value(got_a[k][name], value, f"{k}@{name}")
    _equal_trees(jck.import_keras_h5(tmp_path / "port.h5", jcfg), (p, s))


@pytest.mark.filterwarnings("ignore")
def test_keras_loads_the_port_export(tmp_path):
    """Keras `load_weights` takes the port's export and gives the JAX
    forward within 1e-5, as tests/test_models_train.py holds the JAX
    export."""
    pytest.importorskip("tensorflow")
    from tensorflow.keras.layers import (BatchNormalization, Dense, Dropout,
                                         Input)
    from tensorflow.keras.models import Model

    jcfg, cfg, p, s = _jax_trees(seed=7, dropout=(0.4, 0.4))
    path = str(tmp_path / "port.h5")
    ck.export_h5(path, *params_from_numpy(p, s, "cpu"))
    inp = Input((16,))
    h = Dense(32, activation="relu")(inp)
    h = BatchNormalization()(h)
    h = Dropout(0.4)(h)
    h = Dense(16, activation="relu")(h)
    h = BatchNormalization()(h)
    h = Dropout(0.4)(h)
    km = Model(inp, Dense(4, activation="softmax")(h))
    km.load_weights(path)
    x = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    want = np.asarray(jmlp.predict_probs(jcfg, p, s, x))
    np.testing.assert_allclose(km(x, training=False).numpy(), want,
                               atol=1e-5)


# -- what the codec refuses --------------------------------------------------

def _gzip(f):
    f.create_dataset("w/z", data=np.ones((64, 4), np.float32),
                     compression="gzip")


def _dense_links(f):
    g = f.create_group("many")
    for i in range(12):
        g.create_dataset(f"x{i}", data=np.float32(i))


def _dense_attrs(f):
    for i in range(12):
        f.attrs[f"a{i}"] = i


def _enum(f):
    f.create_dataset("flags", data=np.array([True, False]))


@pytest.mark.parametrize("write, libver, obj, what", [
    (_gzip, None, "/w/z", "chunked"),
    (_dense_links, "latest", "/many", "dense link storage"),
    (_dense_attrs, "latest", "/", "dense attribute storage"),
    (_enum, None, "/flags", "datatype class 8"),
])
def test_refusals_name_file_object_and_structure(tmp_path, write, libver,
                                                 obj, what):
    path = tmp_path / "r.h5"
    with h5py.File(path, "w", **({"libver": libver} if libver else {})) as f:
        write(f)
    with pytest.raises(ValueError) as e:
        read_h5(path)
    msg = str(e.value)
    assert str(path) in msg and repr(obj) in msg and what in msg, msg


def test_a_corrupt_checksum_is_refused(tmp_path):
    path = tmp_path / "c.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4, dtype=np.float32))
    raw = bytearray(path.read_bytes())
    at = raw.index(b"OHDR", 64)
    raw[at + 8] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum mismatch"):
        read_h5(path)


def test_lookup3_known_values():
    """Bob Jenkins' published hashlittle values."""
    assert lookup3(b"") == 0xDEADBEEF
    assert lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert lookup3(b"Four score and seven years ago") == 0x17770551
    assert lookup3(b"Four score and seven years ago", 1) == 0xCD628161


# -- no h5py -----------------------------------------------------------------

def test_interop_without_h5py(tmp_path, monkeypatch):
    """With h5py blocked: the fixtures read, export and import round-trip,
    `load_checkpoint` takes the .h5."""
    from asr_using_robust_nn_tpu_torch.serve.engine import load_checkpoint

    _, cfg, p, s = _jax_trees(seed=9)
    want = ck.import_keras_h5(os.path.join(DATA, "keras_legacy_small.h5"),
                              mlp.MLPConfig(**dict(KW, dropout=(0.4, 0.4))))
    monkeypatch.setitem(sys.modules, "h5py", None)
    _equal_trees(ck.import_keras_h5(
        os.path.join(DATA, "keras3_small.weights.h5"),
        mlp.MLPConfig(**dict(KW, dropout=(0.4, 0.4)))), want)
    ck.export_h5(tmp_path / "x.h5", p, s)
    _equal_trees(ck.import_keras_h5(tmp_path / "x.h5", cfg), (p, s))
    _equal_trees(load_checkpoint(str(tmp_path / "x.h5"), cfg), (p, s))


def test_no_port_module_imports_h5py():
    root = os.path.join(os.path.dirname(__file__), os.pardir,
                        "asr_using_robust_nn_tpu_torch")
    found = []
    for base, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                found += [(path, n) for n in names
                          if n.split(".")[0] == "h5py"]
    assert not found, found
