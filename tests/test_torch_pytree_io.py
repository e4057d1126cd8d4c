"""The port's ``.npz`` checkpoint I/O (``viforsdes_tpu_torch/utils/pytree_io.py``)
and posterior save/load, against the JAX package's format.

- A tree the port saves loads back bit for bit.
- A posterior the port saves loads in the JAX package, and one the JAX
  package saves loads in the port, with every leaf equal bit for bit.
- A learned observation variance survives the port's save and load (the JAX
  package's load drops it; the port's keeps the ``obs`` leaf).
- An archive without the required metadata is refused by name.
"""

import jax
import numpy as np
import pytest
import torch

import viforsdes_tpu as jvt
import viforsdes_tpu_torch as tvt
from viforsdes_tpu_torch.utils.pytree_io import load_checkpoint, save_checkpoint
from viforsdes_tpu_torch.utils.tree import tree_items, tree_map_with_path

from test_torch_elbo import HORIZON, OBS_TIMES, OBS_VALUES, flat_paths, make_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _prior(vt):
    return vt.Prior(type=vt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3)


def _perturbed(tree, seed):
    """The tree with seeded noise on every leaf, so no leaf is its init."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in tree_items(tree):
        out[path] = leaf + torch.from_numpy(rng.standard_normal(tuple(leaf.shape)).astype(np.float32))
    return out


def _port_posterior(tt, seed=0):
    """A port posterior on ``tt``'s model whose params and EMA differ."""
    params = tt.layout.unpack(tt.layout.pack(_rebuild(tt, _perturbed(tt.params, seed)), "cpu"))
    ema = tt.layout.unpack(tt.layout.pack(_rebuild(tt, _perturbed(tt.params, seed + 1)), "cpu"))
    return tvt.VariationalPosterior(
        model=tt.model, params=params, ema_params=ema, prior=_prior(tvt),
        observations=tvt.Observations(times=OBS_TIMES, values=OBS_VALUES),
        time_horizon=HORIZON, time_step=tt.config.time_step,
        state_space=tvt.StateSpace(1, []), evidence_lower_bound_history=[-3.5, -2.25],
    )


def _rebuild(tt, flat):
    """A params tree of ``tt``'s structure from ``{path: leaf}``."""
    return tree_map_with_path(lambda path, _: flat[path], tt.params)


def test_port_save_then_load_is_bitwise(tmp_path):
    _, tt = make_pair(learn_obs_variance=True)
    params = _rebuild(tt, _perturbed(tt.params, 3))
    opt = {"count": torch.tensor(7, dtype=torch.int32), "mu": _rebuild(tt, _perturbed(tt.params, 4))}
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, {"params": params, "opt": opt}, {"next_step": 7, "history": [-1.5, 0.25]})
    trees, meta = load_checkpoint(path, {"params": tt.params, "opt": opt}, required_metadata=("next_step",))
    assert meta["next_step"] == 7 and meta["history"] == [-1.5, 0.25] and meta["format_version"] == 2
    for name, ref in (("params", params), ("opt", opt)):
        got = dict(tree_items(trees[name]))
        for p, want in tree_items(ref):
            assert torch.equal(got[p], want), p
            assert got[p].dtype == want.dtype, p


def test_port_posterior_loads_in_jax_bitwise(tmp_path):
    jt, tt = make_pair()
    post = _port_posterior(tt, seed=5)
    path = tmp_path / "port.npz"
    post.save(path)
    loaded = jvt.VariationalPosterior.load(
        path, jt.model, _prior(jvt), jvt.Observations(times=OBS_TIMES, values=OBS_VALUES))
    for ours, theirs in ((post.params, loaded.params), (post.ema_params, loaded.ema_params)):
        j_flat = flat_paths(jax.tree.map(np.asarray, theirs))
        t_flat = {p: v.numpy() for p, v in tree_items(ours)}
        assert set(j_flat) == set(t_flat)
        for p, ref in t_flat.items():
            np.testing.assert_array_equal(j_flat[p], ref, err_msg=p)
    assert loaded.evidence_lower_bound_history == [-3.5, -2.25]
    assert loaded.time_step == post.time_step


def test_jax_posterior_loads_in_the_port_bitwise(tmp_path):
    jt, tt = make_pair()
    obs = jvt.Observations(times=OBS_TIMES, values=OBS_VALUES)
    ema = jax.tree.map(lambda a: a + 0.25, jt.params)
    j_post = jvt.VariationalPosterior(
        model=jt.model, params=jt.params, ema_params=ema, prior=_prior(jvt), observations=obs,
        time_horizon=HORIZON, time_step=jt.config.time_step, state_space=jvt.StateSpace(1, []),
        evidence_lower_bound_history=[-4.0],
    )
    path = tmp_path / "jax.npz"
    j_post.save(path)
    loaded = tvt.VariationalPosterior.load(
        path, tt.model, _prior(tvt), tvt.Observations(times=OBS_TIMES, values=OBS_VALUES))
    for theirs, ours in ((jt.params, loaded.params), (ema, loaded.ema_params)):
        j_flat = flat_paths(jax.tree.map(np.asarray, theirs))
        t_flat = {p: v.numpy() for p, v in tree_items(ours)}
        assert set(j_flat) == set(t_flat)
        for p, ref in j_flat.items():
            np.testing.assert_array_equal(t_flat[p], ref, err_msg=p)
    assert loaded.diagnostics().final_evidence_lower_bound == -4.0
    assert loaded.observation_variance() is None


def test_learned_observation_variance_survives_save_and_load(tmp_path):
    _, tt = make_pair(learn_obs_variance=True)
    post = _port_posterior(tt, seed=8)
    want = post.observation_variance()
    assert want is not None and want > 0
    path = tmp_path / "obs.npz"
    post.save(path)
    loaded = tvt.VariationalPosterior.load(
        path, tt.model, _prior(tvt), tvt.Observations(times=OBS_TIMES, values=OBS_VALUES))
    np.testing.assert_allclose(loaded.observation_variance(), want, rtol=1e-7)
    assert torch.equal(loaded.ema_params["obs"]["log_variance"], post.ema_params["obs"]["log_variance"])


def test_missing_metadata_is_not_a_posterior_checkpoint(tmp_path):
    _, tt = make_pair()
    path = tmp_path / "bare.npz"
    save_checkpoint(path, {"model_state": tt.params, "ema_state": tt.params},
                    {"time_horizon": HORIZON, "state_positive_dims": []})
    with pytest.raises(ValueError, match="not a VariationalPosterior checkpoint"):
        tvt.VariationalPosterior.load(
            path, tt.model, _prior(tvt), tvt.Observations(times=OBS_TIMES, values=OBS_VALUES))


def test_a_leaf_of_another_structure_is_refused(tmp_path):
    _, tt = make_pair()
    path = tmp_path / "extra.npz"
    save_checkpoint(path, {"params": {**tt.params, "stray": torch.zeros(2)}}, {})
    with pytest.raises(ValueError, match="structure mismatch.*stray"):
        load_checkpoint(path, {"params": tt.params})
