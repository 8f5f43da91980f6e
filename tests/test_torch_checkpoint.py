"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), after ``tests/test_checkpoint_runtime.py``.

The on-disk layout is the reference's: for the same tree both packages
write the same ``step_<n:08d>/`` directory, the same manifest ``leaves``
(keys, files, shapes and dtype strings, in the same order) and the same
``.npy`` bytes, and a step written by either package loads in the other.
Within the port: trees of tensors round-trip onto the requested device
with their structure, ``latest_step`` sees only published steps, and a
stale ``.tmp`` directory is replaced.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.checkpoint as J  # noqa: E402
import repro_torch.checkpoint as T  # noqa: E402
from repro_torch.checkpoint.ckpt import _flatten  # noqa: E402


def _trees():
    rng = np.random.default_rng(0)
    return {
        "flat": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                 "b": np.arange(3, dtype=np.int32)},
        "nested": {"zeta": {"a": rng.normal(size=5),
                            "m": [np.ones(2, np.float32),
                                  (np.int64(7), np.zeros((2, 2), np.int8))]},
                   "alpha": [rng.normal(size=(2, 3)).astype(np.float32)],
                   "empty": None},
        "service_like": {f"{i:06d}": dict(
            x=rng.normal(size=(6, 2)).astype(np.float32),
            iters=np.array([3, 4], np.int64),
            norms=rng.normal(size=(5, 2)),
            statuses=np.array(["converged", "max_iters"], "<U24"))
            for i in (0, 2, 11)},
        "list_root": [np.float32(1.5), {"k": np.arange(4.0)}],
    }


TREES = sorted(_trees())


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", TREES)
def test_same_layout_as_the_reference(tmp_path, name):
    tree = _trees()[name]
    extra = dict(kind="test", n=3)
    pj = J.save_checkpoint(str(tmp_path / "ref"), 5, tree, extra=extra)
    pt = T.save_checkpoint(str(tmp_path / "port"), 5, tree, extra=extra)
    assert os.path.basename(pt) == os.path.basename(pj) == "step_00000005"
    mj, mt = _manifest(pj), _manifest(pt)
    assert list(mt["leaves"].items()) == list(mj["leaves"].items())
    assert (mt["step"], mt["extra"]) == (mj["step"], mj["extra"])
    assert sorted(os.listdir(pt)) == sorted(os.listdir(pj))
    for info in mj["leaves"].values():
        with open(os.path.join(pj, info["file"]), "rb") as a, \
                open(os.path.join(pt, info["file"]), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("name", TREES)
def test_reference_step_loads_in_the_port(tmp_path, name):
    tree = _trees()[name]
    J.save_checkpoint(str(tmp_path), 2, tree)
    assert T.latest_step(str(tmp_path)) == 2
    flat, manifest = T.load_checkpoint_flat(str(tmp_path), 2)
    want = _flatten(tree)
    assert list(flat) == list(want)
    for key, arr in flat.items():
        np.testing.assert_array_equal(arr, np.asarray(want[key]))
        assert arr.dtype == np.asarray(want[key]).dtype
    assert manifest["step"] == 2


@pytest.mark.parametrize("name", ["flat", "nested", "list_root"])
def test_port_step_restores_in_the_reference(tmp_path, name):
    tree = _trees()[name]
    T.save_checkpoint(str(tmp_path), 1, tree)
    assert J.latest_step(str(tmp_path)) == 1
    got, _ = J.restore_checkpoint(str(tmp_path), 1, tree)
    want = _flatten(tree)
    got_flat = _flatten(got)
    assert list(got_flat) == list(want)
    for key in want:
        # the reference restores into jax arrays: 64-bit leaves come back
        # 32-bit unless JAX runs in 64-bit mode
        got_arr = np.asarray(got_flat[key])
        np.testing.assert_array_equal(
            got_arr, np.asarray(want[key]).astype(got_arr.dtype))


def test_restore_is_tensors_in_the_tree_structure(tmp_path):
    """``restore_checkpoint`` gives tensors on the requested device, with
    the tree's dicts, lists and tuples as they were."""
    tree = {"params": [torch.arange(6.0).reshape(2, 3),
                       (torch.ones(2, dtype=torch.int32), None)],
            "step": torch.tensor(7)}
    T.save_checkpoint(str(tmp_path), 0, tree)
    got, manifest = T.restore_checkpoint(str(tmp_path), 0, tree,
                                         device="cpu")
    assert isinstance(got["params"], list)
    assert isinstance(got["params"][1], tuple) and got["params"][1][1] is None
    for a, b in ((got["params"][0], tree["params"][0]),
                 (got["params"][1][0], tree["params"][1][0]),
                 (got["step"], tree["step"])):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert manifest["leaves"]["params/0"]["dtype"] == "float32"
    # the reference restores the same step from its own tree of arrays
    like = {"params": [np.zeros((2, 3), np.float32),
                       (np.zeros(2, np.int32), None)], "step": np.int64(0)}
    jgot, _ = J.restore_checkpoint(str(tmp_path), 0, like)
    np.testing.assert_array_equal(np.asarray(jgot["params"][0]),
                                  tree["params"][0].numpy())


def test_restore_defaults_to_the_card(tmp_path):
    T.save_checkpoint(str(tmp_path), 0, {"a": np.ones(2)})
    if torch.cuda.is_available():
        got, _ = T.restore_checkpoint(str(tmp_path), 0, {"a": 0})
        assert got["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.restore_checkpoint(str(tmp_path), 0, {"a": 0})


def test_latest_step_and_atomic_publish(tmp_path):
    d = str(tmp_path / "ck")
    assert T.latest_step(d) is None
    T.save_checkpoint(d, 3, {"a": np.zeros(1)})
    # a half-written later step: never seen, and replaced when written
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    with open(os.path.join(d, "step_00000009.tmp", "junk"), "w") as f:
        f.write("partial")
    assert T.latest_step(d) == J.latest_step(d) == 3
    T.save_checkpoint(d, 9, {"a": np.ones(1)})
    assert T.latest_step(d) == 9
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))
    assert sorted(os.listdir(os.path.join(d, "step_00000009"))) == [
        "a.npy", "manifest.json"]
    # re-saving a step overwrites it
    T.save_checkpoint(d, 9, {"a": np.full(1, 2.0)})
    np.testing.assert_array_equal(T.load_checkpoint_flat(d, 9)[0]["a"], [2.0])
