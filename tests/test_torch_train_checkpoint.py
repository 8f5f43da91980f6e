"""The port's checkpoints on the training path, against the reference's.

* The reference's ``TestCheckpoint`` cases (``tests/
  test_checkpoint_runtime.py``) on the port, with ``shardings=`` as a tree
  of torch devices.
* bfloat16 leaves: the port writes the bytes the reference writes (the
  raw values under a ``<V2`` header, ``"bfloat16"`` in the manifest) and
  restores the reference's file; the reference's own restore of that file
  raises (ROADMAP C7, asserted here).
* Resume across packages, both ways, with f32 and int8 moments: DeepFM
  ``SMOKE`` trained 4 steps in one package and saved, restored by the
  other (the state bit for bit what was saved) and trained 3 more steps
  there; held against 7 steps in that package alone.

Tolerances: restored leaves bit for bit; after the resume, parameters atol
1e-6 with f32 moments (the two packages' float32 gradients differ in the
last places, and Adam's normalisation passes that on at most one
lr-sized step, lr 1e-4 here), and with int8 moments, whose per-tensor
quantisation can move a value by one level from such noise (and a
second moment one level apart changes that step's update by up to about
one lr), the dequantised moments within one level and the parameters
atol 5·lr over the 7 steps.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as J  # noqa: E402
import repro_torch.checkpoint as T  # noqa: E402
from repro.configs import deepfm as jcfg  # noqa: E402
from repro.data.synthetic import recsys_batch_stream as j_stream  # noqa: E402
from repro.models.recsys import deepfm as jd  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch.configs import deepfm as tcfg  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 deepfm_params_from_numpy)
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

CPU = torch.device("cpu")


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# -- the reference's TestCheckpoint cases ----------------------------------

def test_roundtrip(tmp_path):
    tree = dict(w=torch.arange(12.0).reshape(3, 4),
                opt=dict(mu=torch.ones(5), step=torch.tensor(7)))
    T.save_checkpoint(str(tmp_path), 3, tree)
    assert T.latest_step(str(tmp_path)) == 3
    restored, manifest = T.restore_checkpoint(str(tmp_path), 3, tree,
                                              device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(tree),
                                                 leaves(restored)))
    assert manifest["step"] == 3


def test_atomic_no_partial_steps(tmp_path):
    T.save_checkpoint(str(tmp_path), 1, dict(w=torch.ones(4)))
    os.makedirs(tmp_path / "step_00000002.tmp")     # a crash mid-save
    assert T.latest_step(str(tmp_path)) == 1


def test_restore_with_shardings(tmp_path):
    """``shardings`` is a tree of devices shaped like (part of) the tree:
    its leaves go there, every other leaf to ``device``; with every leaf
    named, no default device is needed (none is on this host)."""
    tree = dict(w=torch.arange(16.0), opt=dict(mu=torch.ones(3),
                                               step=torch.tensor(2)))
    T.save_checkpoint(str(tmp_path), 1, tree)
    sh = dict(w=CPU, opt=dict(mu=CPU, step=CPU))
    restored, _ = T.restore_checkpoint(str(tmp_path), 1, tree, shardings=sh)
    for a, b in zip(leaves(tree), leaves(restored)):
        assert b.device == CPU and torch.equal(a, b)
    part, _ = T.restore_checkpoint(str(tmp_path), 1, tree,
                                   shardings=dict(w=CPU), device="cpu")
    assert torch.equal(part["w"], tree["w"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.restore_checkpoint(str(tmp_path), 1, tree,
                                 shardings=dict(w=CPU))


# -- bfloat16 leaves -------------------------------------------------------

def _bf16_tree():
    vals = np.array([1.5, -2.0, 3.140625, 0.0, -0.0078125, 65280.0],
                    np.float32)
    return vals, dict(m=vals.reshape(2, 3), s=vals[:1].reshape(()))


def test_bf16_leaf_bytes_equal_the_reference(tmp_path):
    vals, tree = _bf16_tree()
    pj = J.save_checkpoint(str(tmp_path / "ref"), 1, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree))
    pt = T.save_checkpoint(str(tmp_path / "port"), 1, {
        k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
        for k, v in tree.items()})
    mj, mt = _manifest(pj), _manifest(pt)
    assert mt["leaves"] == mj["leaves"]
    assert mt["leaves"]["m"]["dtype"] == "bfloat16"
    for info in mj["leaves"].values():
        with open(os.path.join(pj, info["file"]), "rb") as a, \
                open(os.path.join(pt, info["file"]), "rb") as b:
            want = a.read()
            assert b.read() == want and b"'descr': '<V2'" in want


def test_port_restores_the_reference_bf16_file(tmp_path):
    vals, tree = _bf16_tree()
    J.save_checkpoint(str(tmp_path), 4, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree))
    like = {k: torch.zeros(()) for k in tree}
    got, _ = T.restore_checkpoint(str(tmp_path), 4, like, device="cpu")
    for k, v in tree.items():
        assert got[k].dtype == torch.bfloat16 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].float().numpy(), v)


def test_reference_cannot_restore_bf16_c7(tmp_path):
    """ROADMAP C7: the reference writes a bf16 leaf that ``np.load`` reads
    back as ``|V2``, which ``jnp.asarray`` refuses. Not repaired (that
    would edit the reference); the port restores the same file."""
    _, tree = _bf16_tree()
    J.save_checkpoint(str(tmp_path), 1, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree))
    with pytest.raises(TypeError, match="V2"):
        J.restore_checkpoint(str(tmp_path), 1, tree)


# -- resume across packages ------------------------------------------------

def _batch(s):
    _, idx, lab = next(j_stream(jcfg.SMOKE.vocab_per_field, 64, 2, seed=3,
                                start_step=s))
    return idx, lab


def _jax_steps(jp, jo, joc, steps):
    for s in steps:
        idx, lab = _batch(s)
        _, g = jax.value_and_grad(lambda p: jd.deepfm_loss(
            jcfg.SMOKE, p, jnp.asarray(idx), jnp.asarray(lab)))(jp)
        jp, jo, _ = ja.adamw_update(joc, jp, g, jo)
    return jp, jo


def _port_steps(tp, to, toc, steps):
    step = tcfg.make_train_step(tcfg.SMOKE, toc)
    for s in steps:
        idx, lab = _batch(s)
        tp, to, _ = step(tp, to, torch.from_numpy(idx), torch.from_numpy(lab))
    return tp, to


def _q8(tree):
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return [tree]
    if isinstance(tree, dict):
        return [m for k in sorted(tree) for m in _q8(tree[k])]
    return [m for sub in tree for m in _q8(sub)]


@pytest.mark.parametrize("moments_dtype", ["f32", "int8"])
@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_across_packages(tmp_path, moments_dtype, first):
    kw = dict(lr=1e-4, warmup_steps=2, total_steps=7,
              moments_dtype=moments_dtype)
    joc, toc = ja.AdamWConfig(**kw), ta.AdamWConfig(**kw)
    jp0 = jd.init_deepfm(jax.random.PRNGKey(0), jcfg.SMOKE)
    jo0 = ja.adamw_init(jp0, joc)
    tp0 = deepfm_params_from_numpy(jax.tree.map(np.asarray, jp0), "cpu")
    to0 = adamw_state_from_numpy(jax.tree.map(np.asarray, jo0), "cpu")
    d = str(tmp_path)
    if first == "reference":
        saved = dict(zip(("params", "opt"),
                         _jax_steps(jp0, jo0, joc, range(4))))
        J.save_checkpoint(d, 4, saved)
        state, _ = T.restore_checkpoint(d, 4, dict(params=tp0, opt=to0),
                                        device="cpu")
        for a, b in zip(leaves(state), jax.tree.leaves(saved)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        got = _port_steps(state["params"], state["opt"], toc, range(4, 7))
        want = _port_steps(tp0, to0, toc, range(7))
    else:
        saved = dict(zip(("params", "opt"),
                         _port_steps(tp0, to0, toc, range(4))))
        T.save_checkpoint(d, 4, saved)
        state, _ = J.restore_checkpoint(d, 4, dict(params=jp0, opt=jo0))
        for a, b in zip(jax.tree.leaves(state), leaves(saved)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jp, jo = _jax_steps(state["params"], state["opt"], joc, range(4, 7))
        got = (deepfm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
               adamw_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu"))
        jp, jo = _jax_steps(jp0, jo0, joc, range(7))
        want = (deepfm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                adamw_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu"))
    atol = 1e-6 if moments_dtype == "f32" else 5 * kw["lr"]
    for a, b in zip(leaves(got[0]), leaves(want[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)
    assert got[1]["step"].item() == want[1]["step"].item() == 7
    if moments_dtype == "int8":
        for a, b in zip(_q8(got[1]["mu"]) + _q8(got[1]["nu"]),
                        _q8(want[1]["mu"]) + _q8(want[1]["nu"])):
            level = b["scale"].item()
            diff = (a["q"].float() * a["scale"] - b["q"].float() * level)
            assert diff.abs().max().item() <= level * (1 + 1e-4)
