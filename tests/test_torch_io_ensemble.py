"""PyTorch port: checkpoint archives (``io/``) and the ensemble runner against JAX.

Mirrors ``tests/test_shooting_ensemble_io.py``'s checkpoint and ensemble
tests, and holds the two packages to one on-disk format: an archive written
by either loads in the other with equal leaves, and both write the same
sidecar ``paths``.  The 8-lane Lotka-Volterra ensemble equals JAX's in
float64 (states to 1e-10 relative, the same success mask); ``sharded=True``
on one rank equals the unsharded run.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.ensemble import ensemble_run, noise_schedule
from universal_differential_equations_torch.flatten_util import tree_flatten
from universal_differential_equations_torch.io import (
    BestCheckpoint,
    KeyedArchive,
    load_pytree,
    save_pytree,
)
from universal_differential_equations_tpu import io as jio
from universal_differential_equations_tpu.ensemble import ensemble_run as jensemble_run

torch.set_num_threads(1)

F64 = torch.float64


def test_pytree_save_load_roundtrip(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3),
            "nested": [torch.zeros(2), torch.full((2, 2), 7.0)]}
    save_pytree(tmp_path / "ckpt", tree)
    loaded = load_pytree(tmp_path / "ckpt", like=tree, device="cpu")
    for a, b in zip(tree_flatten(tree)[0], tree_flatten(loaded)[0]):
        assert b.device.type == "cpu" and b.dtype == a.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(tmp_path / "ckpt", like={"w": torch.zeros(1)})


def test_keyed_archive_group_append(tmp_path):
    arch = KeyedArchive(tmp_path / "results")
    for i in range(3):
        arch.save(f"run_{i}", loss=torch.tensor(float(i)), coeffs=torch.arange(4.0),
                  tree={"a": torch.ones(2), "b": [torch.zeros(1)]})
    assert arch.groups() == ["run_0", "run_1", "run_2"]
    assert "run_1" in arch and "run_3" not in arch
    got = arch.load("run_2")
    assert float(got["loss"]) == 2.0
    assert sorted(got) == ["coeffs", "loss", "tree__0", "tree__1"]


def test_best_checkpoint(tmp_path):
    ckpt = BestCheckpoint(tmp_path / "best")
    ckpt(0, 1.0, torch.tensor([1.0]))
    ckpt(1, 0.5, torch.tensor([2.0]))
    ckpt(2, 0.9, torch.tensor([3.0]))  # worse: not saved
    best = load_pytree(tmp_path / "best", like=torch.tensor([0.0]))
    assert float(best[0]) == 2.0


def _tree(rng):
    """A parameter-like tree with float64, float32 and int leaves, as numpy."""
    return {"rx": [{"w": rng.standard_normal((3, 1)), "b": rng.standard_normal(3)},
                   {"w": rng.standard_normal((1, 3)).astype(np.float32)}],
            "w": rng.standard_normal(3), "D0": np.float64(6.5),
            "steps": np.arange(4, dtype=np.int32)}


def _as_torch(tree):
    return jax.tree.map(torch.from_numpy, jax.tree.map(np.atleast_1d, tree))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_archives_load_across_packages(tmp_path, writer):
    tree = _tree(np.random.default_rng(0))
    tree["D0"] = np.atleast_1d(tree["D0"])
    j_tree, t_tree = jax.tree.map(jnp.asarray, tree), _as_torch(tree)
    jio.save_pytree(tmp_path / "j" / "ckpt", j_tree)
    save_pytree(tmp_path / "t" / "ckpt", t_tree)
    paths = {pkg: json.loads((tmp_path / pkg / "ckpt.tree.json").read_text())["paths"]
             for pkg in ("j", "t")}
    assert paths["j"] == paths["t"]
    assert paths["t"][:3] == ["['D0']", "['rx'][0]['b']", "['rx'][0]['w']"]

    src = tmp_path / ("j" if writer == "jax" else "t") / "ckpt"
    if writer == "jax":
        loaded = load_pytree(src, like=t_tree)
        pairs = zip(tree_flatten(t_tree)[0], tree_flatten(loaded)[0])
    else:
        loaded = jio.load_pytree(src, like=j_tree)
        pairs = zip(jax.tree.leaves(j_tree), jax.tree.leaves(loaded))
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    # keyed groups, the study's resume store
    values = dict(loss=np.float64(0.25), coeffs=np.arange(4.0), tree={"a": np.ones(2)})
    if writer == "jax":
        jio.KeyedArchive(tmp_path / "arch").save("lane_7", **values)
        got = {k: v.numpy() for k, v in KeyedArchive(tmp_path / "arch").load("lane_7").items()}
    else:
        KeyedArchive(tmp_path / "arch").save("lane_7", **jax.tree.map(torch.tensor, values))
        got = jio.KeyedArchive(tmp_path / "arch").load("lane_7")
    assert sorted(got) == ["coeffs", "loss", "tree__0"]
    assert got["loss"].shape == () and got["coeffs"].shape == (4,)
    np.testing.assert_array_equal(got["coeffs"], values["coeffs"])
    assert float(got["loss"]) == 0.25


def _blowup_run(pkg, as_array):
    def rhs(t, y, k):
        return k * y * y  # blows up for k > 0

    def run(k):
        sol = pkg.solve(pkg.ODEProblem(rhs, as_array([1.0]), (0.0, 2.0), k), pkg.Tsit5(),
                        rtol=1e-6, atol=1e-8, adjoint=pkg.NoAdjoint(), max_steps=200)
        return sol.y_final, sol.success

    return run


def test_ensemble_run_masks_failures():
    # one member diverges (finite-time blowup): masked, the others fine
    run = _blowup_run(tude, lambda x: torch.tensor(x, dtype=F64))
    res = ensemble_run(run, torch.tensor([-1.0, -0.5, 0.0, 5.0], dtype=F64))
    assert res.success.tolist() == [True, True, True, False]
    assert res.num_success == 3
    assert res.successful(res.outputs).shape == (3, 1)
    # sharded=True without a process group: a one-rank gloo mesh of its own,
    # the same lanes and mask (several ranks: tests/test_torch_parallel.py)
    try:
        sharded = ensemble_run(run, torch.tensor([-1.0, -0.5, 0.0, 5.0], dtype=F64),
                               sharded=True)
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(sharded.success, res.success)
    assert torch.equal(sharded.outputs[res.success], res.outputs[res.success])


def test_noise_schedule_matches_reference():
    # run_loops.jl:40-46: the level changes every 100 runs
    assert float(noise_schedule(0)) == 1e-3
    assert float(noise_schedule(99)) == 1e-3
    assert float(noise_schedule(100)) == 5e-3
    assert float(noise_schedule(499)) == 5e-2
    i = torch.arange(0, 600, 50)
    expect = [1e-3, 1e-3, 5e-3, 5e-3, 1e-2, 1e-2, 2.5e-2, 2.5e-2, 5e-2, 5e-2, 5e-2, 5e-2]
    assert noise_schedule(i).tolist() == expect
    assert torch.func.vmap(noise_schedule)(i).tolist() == expect


def test_eight_lane_ensemble_matches_jax():
    rng = np.random.default_rng(3)
    u0s = np.array([0.44249296, 4.6280594]) * (1.0 + 0.05 * rng.standard_normal((8, 2)))
    ks = np.array([-1.0, -0.5, 0.0, 5.0, -2.0, 0.3, 1.0, -0.1])
    p = np.array([1.3, 0.9, 0.8, 1.8])
    ts = np.linspace(0.0, 1.0, 6)

    def lv(stack):
        def rhs(t, u, a):
            x, y = u[0], u[1]
            return stack([a[0] * x - a[1] * x * y, -a[2] * y + a[3] * x * y])
        return rhs

    def make_run(pkg, stack, as_array):
        blowup = _blowup_run(pkg, as_array)

        def run(args):
            u0, k = args
            sol = pkg.solve(pkg.ODEProblem(lv(stack), u0, (0.0, 1.0), as_array(p)), pkg.Tsit5(),
                            saveat=as_array(ts), rtol=1e-8, atol=1e-8,
                            adjoint=pkg.NoAdjoint(), max_steps=256)
            y_blow, ok_blow = blowup(k)
            return {"ys": sol.ys, "blowup": y_blow}, sol.success & ok_blow

        return run

    res_j = jensemble_run(make_run(jude, jnp.stack, jnp.asarray),
                          (jnp.asarray(u0s), jnp.asarray(ks)))
    res_t = ensemble_run(make_run(tude, torch.stack, lambda x: torch.tensor(x, dtype=F64)),
                         (torch.tensor(u0s), torch.tensor(ks)))
    assert res_t.success.tolist() == np.asarray(res_j.success).tolist()
    assert res_t.num_success == 6
    ok = res_t.success.numpy()
    for key in ("ys", "blowup"):
        np.testing.assert_allclose(res_t.outputs[key].numpy()[ok],
                                   np.asarray(res_j.outputs[key])[ok], rtol=1e-10, atol=1e-12)
