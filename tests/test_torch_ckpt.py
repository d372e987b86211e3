"""Port parity: ``repro_torch.checkpoint.ckpt`` against the JAX package's
``repro.checkpoint.ckpt``. Trees flatten in JAX's order with JAX's
``treedef`` string; a checkpoint saved by either package is the same
bytes on disk (bfloat16 leaves included) and restores in the other."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_exchange_pkgs import PORT, REF
from repro_torch.checkpoint import ckpt


def _tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            fp = os.path.join(dirpath, name)
            with open(fp, "rb") as f:
                out[os.path.relpath(fp, root)] = f.read()
    return out


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return dict(w=rng.standard_normal((3, 5)).astype(np.float32),
                ids=rng.integers(-2**40, 2**40, 7, dtype=np.int64),
                h=rng.standard_normal((4, 2)).astype(np.float32),
                s=np.float32(rng.standard_normal()))


def _ref_tree(v):
    """The JAX package's tree: numpy leaves, a bfloat16 JAX array."""
    return {"layer": [v["w"], (v["ids"], None)],
            "act": np.asarray(jnp.asarray(v["h"], jnp.bfloat16)),
            "scalar": v["s"]}


def _port_tree(v):
    return {"layer": [torch.from_numpy(v["w"]),
                      (torch.from_numpy(v["ids"]), None)],
            "act": torch.from_numpy(v["h"]).to(torch.bfloat16),
            "scalar": torch.tensor(v["s"])}


TREES = [
    {"b": 1, "a": 2},
    {"a": 1, "b": [2, (3, None)]},
    [1, 2], (1,), (), [], {}, None, 5, [None],
    {"x": {"y": None}}, {3: 1, 1: 2}, ((), []),
    {"z": [np.zeros(2), (np.ones(1),)], "a": {"c": 1.5, "b": None}},
]


@pytest.mark.parametrize("tree", TREES, ids=[repr(t)[:40] for t in TREES])
def test_flatten_matches_jax(tree):
    leaves, treedef = ckpt._flatten(tree)
    want_leaves, want_def = jax.tree.flatten(tree)
    assert str(treedef) == str(want_def)
    assert len(leaves) == len(want_leaves)
    assert all(a is b for a, b in zip(leaves, want_leaves))
    back = treedef.unflatten(leaves)
    assert str(ckpt._flatten(back)[1]) == str(want_def)
    assert repr(back) == repr(jax.tree.unflatten(want_def, want_leaves))


@pytest.mark.parametrize("tree", [{1, 2}, {"a": object()}, "text",
                                  {"a": ([1], {"b": b"x"})}])
def test_flatten_refuses_other_nodes(tree):
    with pytest.raises(TypeError):
        ckpt._flatten(tree)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_checkpoints_cross_packages(tmp_path, writer, reader):
    """One tree of float32, int64 and bfloat16 leaves: each package's
    save is the same bytes (leaves, CRCs, manifest), and restores in the
    other package to equal values."""
    v = _values()
    trees = {REF.name: _ref_tree(v), PORT.name: _port_tree(v)}
    for pkg in (REF, PORT):
        pkg.ckpt.save(str(tmp_path / pkg.name), 3, trees[pkg.name])
    a = _tree_bytes(tmp_path / REF.name)
    b = _tree_bytes(tmp_path / PORT.name)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k
    manifest = reader.ckpt.read_manifest_meta(
        str(tmp_path / writer.name / "step_000000003"))
    assert manifest["treedef"] == str(jax.tree.structure(_ref_tree(v)))
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "bfloat16", "float32", "int64", "float32"]

    got, step = reader.ckpt.restore(str(tmp_path / writer.name),
                                    trees[reader.name])
    assert step == 3
    if reader is PORT:
        assert got["act"].dtype == torch.bfloat16
        assert torch.equal(got["act"], trees[PORT.name]["act"])
        assert got["layer"][1][1] is None
        assert torch.equal(got["layer"][1][0], torch.from_numpy(v["ids"]))
        assert torch.equal(got["layer"][0], torch.from_numpy(v["w"]))
        assert got["scalar"].item() == v["s"]
    else:
        # The reference hands a bfloat16 leaf back as its raw 2-byte words.
        assert got["act"].tobytes() == trees[REF.name]["act"].tobytes()
        assert np.array_equal(got["layer"][1][0], v["ids"])
        assert np.array_equal(got["layer"][0], v["w"])
        assert got["layer"][1][1] is None


def test_restore_numpy_example_and_device(tmp_path):
    """A numpy example leaf restores as numpy; a tensor example as a
    tensor on the example's device and in the saved dtype."""
    v = _values(1)
    ckpt.save(str(tmp_path), 1, _port_tree(v))
    np_example = {"layer": [v["w"], (v["ids"], None)], "act": v["h"],
                  "scalar": v["s"]}
    got, _ = ckpt.restore(str(tmp_path), np_example)
    assert isinstance(got["layer"][0], np.ndarray)
    assert got["act"].dtype.kind == "V"       # bf16 words, as the reference
    got, _ = ckpt.restore(str(tmp_path), _port_tree(v))
    assert got["layer"][0].device == torch.device("cpu")
    bad = _port_tree(v)
    bad["act"] = bad["act"].float()
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore(str(tmp_path), bad)


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_restore_refuses_structure_and_shape_changes(tmp_path, pkg):
    tree = {"a": np.zeros((2, 3), np.float32), "b": [np.ones(4)]}
    pkg.ckpt.save(str(tmp_path), 0, tree)
    with pytest.raises(ValueError, match="leaves"):
        pkg.ckpt.restore(str(tmp_path), {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        pkg.ckpt.restore(str(tmp_path), {"a": np.zeros((3, 2)),
                                         "b": [np.ones(4)]})
    with pytest.raises(pkg.faults.MissingArtifactError):
        pkg.ckpt.restore(str(tmp_path / "none"), tree)


def test_corrupt_leaf_raises_the_same_typed_errors(tmp_path):
    """A flipped bit is a CorruptShardError and a truncated leaf a
    TornWriteError in both packages, on either package's checkpoint."""
    tree = {"a": np.arange(64, dtype=np.float64), "b": np.ones(3)}
    for writer in (REF, PORT):
        root = tmp_path / writer.name
        writer.ckpt.save(str(root), 2, tree)
        leaf = root / "step_000000002" / "arr_00000.npy"
        orig = leaf.read_bytes()
        for data, err in ((orig[:60] + bytes([orig[60] ^ 4]) + orig[61:],
                           "CorruptShardError"),
                          (orig[:10], "TornWriteError")):
            leaf.write_bytes(data)
            for reader in (REF, PORT):
                with pytest.raises(getattr(reader.faults, err)):
                    reader.ckpt.restore(str(root), tree)
        leaf.write_bytes(orig)


def test_async_checkpointer_matches_reference(tmp_path):
    """Write-behind saves land the same bytes and keep the same steps."""
    v = _values(2)
    for pkg, tree in ((REF, _ref_tree(v)), (PORT, _port_tree(v))):
        ac = pkg.ckpt.AsyncCheckpointer(str(tmp_path / pkg.name), keep=2)
        for step in (1, 2, 3):
            ac.save_async(step, tree)
        ac.wait()
    a = _tree_bytes(tmp_path / REF.name)
    assert a == _tree_bytes(tmp_path / PORT.name)
    assert sorted({k.split(os.sep)[0] for k in a}) == [
        "LATEST", "step_000000002", "step_000000003"]
    assert ckpt.latest_step(str(tmp_path / PORT.name)) == 3


def test_manifest_dir_protocol_matches_reference(tmp_path):
    """``write_manifest_dir`` / ``read_manifest_dir`` (the spill protocol)
    write the same bytes in both packages and read each other's."""
    arrays = [np.arange(5, dtype=np.int64), np.linspace(0, 1, 6),
              np.zeros((2, 0))]
    meta = {"kind": "region", "epoch": 4}
    for pkg in (REF, PORT):
        pkg.ckpt.write_manifest_dir(str(tmp_path / pkg.name / "e"), arrays,
                                    meta=meta)
    assert (_tree_bytes(tmp_path / REF.name)
            == _tree_bytes(tmp_path / PORT.name))
    for writer in (REF, PORT):
        for reader in (REF, PORT):
            got, m = reader.ckpt.read_manifest_dir(
                str(tmp_path / writer.name / "e"))
            assert m["epoch"] == 4
            assert all(np.array_equal(x, y) and x.dtype == y.dtype
                       for x, y in zip(got, arrays))
