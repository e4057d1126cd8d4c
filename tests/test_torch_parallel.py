"""Data-parallel training of the port (``parallel/``), twin of
``tests/test_parallel.py``.

Ranks are processes: the multi-rank cases run in children started with the
spawn method, on gloo over a ``FileStore`` in ``tmp_path`` (no port), one
thread each, on the CPU. The children import only torch, numpy and the port,
so this module's top level imports neither JAX nor the JAX package; the
cases that compare with them import them in their bodies. One spawn serves
several checks: each child job stores its results (or its traceback) per
rank, and the tests read them.

What is held:

- a 2-rank run against the mesh-less run from the same seed: the ELBO at
  rtol 1e-5 and the params and EMA by ``_assert_params_close``'s scheme of
  ``tests/test_torch_train.py`` (the ranks reduce in another order); the
  ranks bitwise equal to each other; a world-1 mesh bitwise equal to
  ``mesh=None``;
- a 2-rank ``_step_math`` on the draws of the JAX trainer on a 2-device mesh
  against that trainer, by the bars of ``test_step_math_matches_jax``;
- the layouts whose microbatch does not split evenly over the mesh, which
  the JAX mesh trains too (``UNEVEN``: importance groups over more ranks
  than there are groups, so some ranks hold none; a microbatch of 6 over 4
  ranks; 3 groups over 2 ranks): against the mesh-less run by the same bars,
  ranks bitwise equal, one step per call and chunks of 3 bitwise equal, no
  model run on a rank without groups, and the first against the JAX trainer
  on a 4-device mesh;
- the mesh utils, the errors, ``infer()`` with a mesh, and checkpoints (rank
  0 alone writes; a 2-rank resume equals the unbroken 2-rank run bitwise).
"""

from __future__ import annotations

import datetime
import os
import shutil
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import viforsdes_tpu_torch as tvt
from viforsdes_tpu_torch.inference import trainer as trainer_mod
from viforsdes_tpu_torch.inference.optimizer import GROUPS
from viforsdes_tpu_torch.parallel import DATA_AXIS, local_batch_size, make_data_mesh


class OU:
    state_dim = 1
    sde_param_dim = 3

    def drift(self, x, p):
        return p[..., 0:1] * (p[..., 1:2] - x)

    def diffusion(self, x, p):
        return p[..., 2:3][..., None]


# the tiny problem of tests/test_parallel.py, fp32 on both sides
SPEC = {
    "obs": {"times": [0.0, 1.0, 2.0], "values": [[2.0], [1.5], [0.8]]},
    "horizon": 2.0,
    "enc": {"hidden_dim": 16, "cond_dim": 16, "num_heads": 2, "depth": 1},
    "head": {"hidden_dim": 8, "num_layers": 2},
    "training": {"time_step": 0.25, "batch_size": 16, "n_iterations": 3, "compute_dtype": "float32"},
}
# BASELINE.md config 5's feature stack, at the tiny size
LADDER = {"iw_samples": 2, "grad_accum_steps": 2, "theta_full_covariance": True,
          "obs_variance_final": 0.01, "obs_variance_anneal_steps": 2, "theta_warmup_steps": 1}
CASES = {"plain": {}, "ladder5": LADDER}
# name -> (ranks, training): microbatches that do not split evenly over the
# mesh, as the JAX mesh trains them
UNEVEN = {
    "iw_groups_on_4": (4, {"batch_size": 8, "iw_samples": 4}),       # 2 groups: ranks 2, 3 hold none
    "micro_6_on_4": (4, {"batch_size": 12, "grad_accum_steps": 2}),  # 6 groups a microbatch: 2, 2, 1, 1
    "groups_3_on_2": (2, {"batch_size": 12, "iw_samples": 2, "grad_accum_steps": 2}),  # 2, 1
}
TIMEOUT_S = 120


def _trainer(mesh=None, spec=SPEC, seed=0, **training):
    return tvt.VariationalInferenceTrainer(
        OU(),
        tvt.Observations(**spec["obs"]),
        tvt.GaussianObservationLikelihood(variance=0.1),
        tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
        spec["horizon"],
        tvt.TrainingConfig(**{**spec["training"], **training}),
        tvt.EncoderConfig(**spec["enc"]),
        tvt.HeadConfig(**spec["head"]),
        state_positive_dims=[],
        sde_param_positive_dims=[0, 2],
        console=tvt.Console(enabled=False),
        seed=seed,
        mesh=mesh,
        device="cpu",
    )


def _state(trainer) -> dict:
    """The trainer's history and flat state, cloned."""
    s = trainer.opt_state
    out = {"history": torch.tensor(trainer.evidence_lower_bound_history, dtype=torch.float64),
           "count": s["count"].clone()}
    for g in GROUPS:
        out[f"params/{g}"] = trainer.flat_params[g].clone()
        out[f"ema/{g}"] = trainer.flat_ema[g].clone()
        out[f"mu/{g}"] = s["mu"][g].clone()
        out[f"nu/{g}"] = s["nu"][g].clone()
    return out


def _assert_same(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), f"{what}: {key}"


# ------------------------------------------------------------------- spawning


def _child(rank, world, store_path, out_dir, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        for name, args in jobs:
            try:
                result = {"ok": True, **globals()[name.split(":")[0]](rank, *args)}
            except Exception:  # noqa: BLE001 - reported to the test that reads this job
                result = {"ok": False, "error": traceback.format_exc()}
            torch.save(result, os.path.join(out_dir, f"{name}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world: int, jobs: list) -> dict:
    """Run ``jobs`` ((name, args) pairs; a name is a job function's, with
    ``:label`` after it where one function runs more than once) on ``world``
    spawned ranks; returns {name: [result of rank 0, rank 1, ...]}."""
    out_dir = tmp_path / f"out{world}"
    out_dir.mkdir()
    mp.start_processes(_child, args=(world, str(tmp_path / f"store{world}"), str(out_dir), jobs),
                       nprocs=world, start_method="spawn")
    return {name: [torch.load(out_dir / f"{name}.{r}.pt") for r in range(world)] for name, _ in jobs}


def _ok(results: list) -> list:
    """Each rank's results, without the flag; a job that raised fails here."""
    for r, result in enumerate(results):
        assert result["ok"], f"rank {r}:\n{result['error']}"
    return [{k: v for k, v in result.items() if k != "ok"} for result in results]


# --------------------------------------------------------------- child jobs


def job_mesh_utils(rank):
    """4 ranks: the full mesh, the subset mesh of 2, the errors."""
    out = {}
    full = make_data_mesh(device_type="cpu")
    out["full_size"] = full.size()
    sub = make_data_mesh(2, device_type="cpu")  # collective: every rank calls it
    out["sub_size"] = sub.size()
    out["local_batch"] = local_batch_size(16, full)
    for key, call in (("too_many", lambda: make_data_mesh(100, device_type="cpu")),
                      ("not_divisible", lambda: local_batch_size(10, full)),
                      ("batch_divide", lambda: _trainer(full, batch_size=18)),
                      # a microbatch of 2 and 2 groups of 8 over 4 ranks train, as in JAX
                      ("micro_divide", lambda: _trainer(full, batch_size=16, grad_accum_steps=8).train()),
                      ("iw_per_rank", lambda: _trainer(full, batch_size=16, iw_samples=8).train()),
                      ("outside", lambda: _trainer(sub))):
        try:
            call()
            out[key] = ""
        except ValueError as err:
            out[key] = str(err)
    return out


def _train_case(case):
    trainer = _trainer(make_data_mesh(device_type="cpu"), **CASES[case])
    trainer.train()
    return _state(trainer)


def job_train_plain(rank):
    return _train_case("plain")


def job_train_ladder5(rank):
    return _train_case("ladder5")


def job_train_uneven(rank, case):
    """One of ``UNEVEN`` one step per call and in chunks of 3 (the chunk
    path's all-reduces), counting the ELBO evaluations of this rank."""
    out, calls = {}, []
    for spc in (1, 3):
        trainer = _trainer(make_data_mesh(device_type="cpu"), **UNEVEN[case][1], steps_per_call=spc)
        saved = trainer._elbo_from_params

        def counted(*args, **kwargs):
            calls.append(1)
            return saved(*args, **kwargs)

        trainer._elbo_from_params = counted
        trainer.train()
        out[f"spc{spc}"] = _state(trainer)
    return {**out, "groups": torch.tensor(trainer._groups), "elbo_calls": len(calls)}


def job_infer(rank):
    posterior = tvt.infer(
        OU(),
        tvt.Observations(times=[0.0, 1.0], values=[[2.0], [1.5]]),
        tvt.GaussianObservationLikelihood(variance=0.1),
        tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3),
        1.0,
        tvt.InferenceConfig(
            training=tvt.TrainingConfig(time_step=0.5, batch_size=8, n_iterations=2),
            encoder=tvt.EncoderConfig(hidden_dim=16, cond_dim=16, num_heads=2, depth=1),
            head=tvt.HeadConfig(hidden_dim=8, num_layers=1),
            sde_param_positive_dims=[0, 2],
            console=tvt.Console(enabled=False),
            mesh=make_data_mesh(device_type="cpu"),
            device="cpu",
        ),
    )
    summary = posterior.summary(n_samples=16)
    return {"paths_shape": torch.tensor(posterior.sample(4).diffusion_paths.shape),
            "theta_mean": summary.sde_parameter_mean, "theta_std": summary.sde_parameter_std,
            "path_mean": summary.diffusion_path_mean,
            "history": torch.tensor(posterior.evidence_lower_bound_history, dtype=torch.float64)}


def job_checkpoint(rank, ckpt_dir):
    """A 4-step run with a checkpoint every 2 steps, then a resume from the
    step-2 checkpoint to step 4, counting each rank's writes and callbacks."""
    path, path2 = os.path.join(ckpt_dir, "run.npz"), os.path.join(ckpt_dir, "step2.npz")
    writes, calls = [], []
    saved = trainer_mod.save_checkpoint

    def counted(*args, **kwargs):
        writes.append(1)
        return saved(*args, **kwargs)

    def callback(step, elbo):
        calls.append(step)
        if step == 2:  # read after the step-2 write and before the step-4 one
            shutil.copyfile(path, path2)

    trainer_mod.save_checkpoint = counted
    try:
        mesh = make_data_mesh(device_type="cpu")
        full = _trainer(mesh, n_iterations=4)
        full.train(callback, checkpoint_every=2, checkpoint_path=path)
        resumed = _trainer(mesh, n_iterations=4)
        resumed.restore_checkpoint(path2)
        resumed.train()
    finally:
        trainer_mod.save_checkpoint = saved
    return {"full": _state(full), "resumed": _state(resumed), "writes": len(writes), "calls": calls}


def job_jax_draws(rank, spec, npz_path):
    """``_step_math`` on this rank's share of the JAX trainer's draws, from
    the JAX trainer's initial weights."""
    data = np.load(npz_path)
    trainer = _trainer(make_data_mesh(device_type="cpu"), spec=spec)
    (lo, hi), iw = trainer._groups, trainer.config.iw_samples
    with torch.no_grad():
        for g in GROUPS:
            trainer.flat_params[g].copy_(torch.from_numpy(data[f"init/{g}"]))
            trainer.flat_ema[g].copy_(trainer.flat_params[g])
    metrics = []
    for step in range(int(data["n_steps"])):
        eps, noise = torch.from_numpy(data[f"eps/{step}"]), torch.from_numpy(data[f"noise/{step}"])
        draws = [(eps[lo:hi], noise[:, lo * iw:hi * iw].contiguous())]
        *_, t_m = trainer._step_math(trainer.flat_params, trainer.opt_state, trainer.flat_ema, draws)
        metrics.append(t_m)
    last = metrics[-1]
    return {**_state(trainer), "metrics": torch.stack([v.float() for v in last[:7]]),
            "param_means": last.param_means, "notfinite": last.notfinite_count}


# ------------------------------------------------------------------ fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def world1():
    """A world of one process (``make_data_mesh``'s own in-process group),
    destroyed afterwards."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_reference(tmp, world: int, **training) -> tuple[dict, tuple]:
    """The JAX trainer on a ``world``-device mesh of conftest's virtual CPU
    devices runs 3 steps (beside the mesh-less port trainer, for the
    tiny-gradient masks); its draws and initial weights go to the children
    in an ``.npz``. Returns the reference and ``job_jax_draws``'s args."""
    import jax

    from viforsdes_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
    from test_torch_elbo import BATCH, DT, ENC, HEAD, HORIZON, OBS_TIMES, OBS_VALUES, jax_draws, make_pair
    from test_torch_train import _run_steps

    n_steps = 3
    jt, tt = make_pair(mesh=jax_data_mesh(world), **training)
    arrays = {"n_steps": np.asarray(n_steps)}
    for g in GROUPS:
        arrays[f"init/{g}"] = tt.flat_params[g].numpy().copy()
    for step in range(n_steps):
        eps, noise = jax_draws(jax.random.fold_in(jt._train_key, step), BATCH, tt.config.iw_samples, tt.n_steps)
        arrays[f"eps/{step}"], arrays[f"noise/{step}"] = eps.numpy(), noise.numpy()
    np.savez(tmp / "jax_draws.npz", **arrays)
    spec = {"obs": {"times": OBS_TIMES, "values": OBS_VALUES}, "horizon": HORIZON, "enc": ENC, "head": HEAD,
            "training": {"time_step": DT, "batch_size": BATCH, "n_iterations": n_steps,
                         "compute_dtype": "float32", **training}}
    j_m, _, small = _run_steps(jt, tt, n_steps)
    return ({"trainer": jt, "port": tt, "metrics": j_m, "small": small, "n_steps": n_steps},
            (spec, str(tmp / "jax_draws.npz")))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank job in one spawn, and the JAX trainer on a 2-device mesh."""
    tmp = tmp_path_factory.mktemp("dp")
    jax_ref, jax_args = _jax_reference(tmp, 2)
    (tmp / "ckpt").mkdir()
    results = _spawn(tmp, 2, [
        ("job_train_plain", ()), ("job_train_ladder5", ()), ("job_infer", ()),
        ("job_checkpoint", (str(tmp / "ckpt"),)), ("job_jax_draws", jax_args), *_uneven_jobs(2),
    ])
    results["jax"] = jax_ref
    return results


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every 4-rank job in one spawn, and the JAX trainer on a 4-device mesh
    at the first ``UNEVEN`` layout (2 importance groups of 4 over 4 ranks)."""
    tmp = tmp_path_factory.mktemp("dp4")
    jax_ref, jax_args = _jax_reference(tmp, 4, iw_samples=UNEVEN["iw_groups_on_4"][1]["iw_samples"])
    results = _spawn(tmp, 4, [("job_mesh_utils", ()), ("job_jax_draws", jax_args), *_uneven_jobs(4)])
    results["jax"] = jax_ref
    return results


def _uneven_jobs(world: int) -> list:
    return [(f"job_train_uneven:{case}", (case,)) for case, (w, _) in UNEVEN.items() if w == world]


def _tree(trainer, state: dict, prefix: str) -> dict:
    return trainer.layout.unpack({g: state[f"{prefix}/{g}"] for g in GROUPS})


# --------------------------------------------------------------------- tests


def test_make_data_mesh_world_of_one(world1):
    mesh = make_data_mesh(device_type="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == (DATA_AXIS,)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert local_batch_size(16, mesh) == 16
    assert make_data_mesh(1, device_type="cpu").size() == 1  # reuses the group
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        make_data_mesh(2, device_type="cpu")


def test_make_data_mesh_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_mesh()
    assert not dist.is_initialized()


def test_a_device_other_than_the_mesh_device_raises(world1):
    mesh = make_data_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="mesh device"):
        tvt.infer(OU(), tvt.Observations(**SPEC["obs"]), tvt.GaussianObservationLikelihood(variance=0.1),
                  tvt.Prior(type=tvt.PriorType.NORMAL, mean=0.0, std=1.0, dim=3), SPEC["horizon"],
                  tvt.InferenceConfig(training=tvt.TrainingConfig(**SPEC["training"]), mesh=mesh))


@pytest.mark.parametrize("case", list(CASES))
def test_world_of_one_equals_no_mesh_bitwise(world1, case):
    chunked = {**CASES[case], "steps_per_call": 3}  # eager chunks on the CPU, all-reduces inside
    for training in (CASES[case], chunked):
        with_mesh = _trainer(make_data_mesh(device_type="cpu"), **training)
        with_mesh.train()
        without = _trainer(None, **training)
        without.train()
        _assert_same(_state(with_mesh), _state(without), f"{case} {training}")


def test_mesh_utils_and_errors_on_four_ranks(four_ranks):
    out, *others = _ok(four_ranks["job_mesh_utils"])
    assert out["full_size"] == 4 and out["sub_size"] == 2 and out["local_batch"] == 4
    assert out["too_many"] == "requested 100 devices but only 4 available"
    assert out["not_divisible"] == "batch_size 10 must be divisible by mesh size 4"
    assert out["batch_divide"] == "batch_size 18 must divide over the 4-way data mesh"
    # a microbatch that does not divide over the mesh, and importance groups
    # that do not, train (the JAX mesh trains both)
    assert out["micro_divide"] == "" and out["iw_per_rank"] == ""
    for rank, result in enumerate([out, *others]):
        # ranks 0 and 1 are in the subset mesh of 2; a trainer elsewhere raises
        assert ("not in the data mesh" in result["outside"]) == (rank >= 2), result["outside"]


@pytest.mark.parametrize("world,groups", [(1, 1), (1, 7), (2, 3), (4, 2), (4, 6), (4, 9), (3, 16)])
def test_rank_groups_split_each_microbatch(world, groups):
    """Every importance group of a microbatch on exactly one rank, in order,
    the ranks' counts at most one apart, the larger ones first."""
    config = tvt.TrainingConfig(time_step=0.25, batch_size=2 * groups * 3, iw_samples=3, grad_accum_steps=2)
    spans = [trainer_mod.rank_groups(config, r, world) for r in range(world)]
    assert spans[0][0] == 0 and spans[-1][1] == groups
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [hi - lo for lo, hi in spans]
    assert sizes == sorted(sizes, reverse=True) and sizes[0] - sizes[-1] <= 1


def _assert_matches_run_without_mesh(state: dict, training: dict) -> None:
    """A mesh run's state against the mesh-less run from the same seed: the
    ELBO history at rtol 1e-5, params and EMA by ``_assert_params_close``."""
    from test_torch_train import _assert_params_close, _lr_of, _tiny_grads

    ref = _trainer(None, **training)
    small, history = {}, []
    for step in range(ref.config.n_iterations):
        for path, tiny in _tiny_grads(ref, ref.draws(step), step).items():
            small[path] = small.get(path, False) | tiny
        history.append(float(ref.train_step(step).elbo))
    np.testing.assert_allclose(state["history"].numpy(), history, rtol=1e-5)
    n, lr_of = ref.config.n_iterations, _lr_of(ref)
    _assert_params_close(_tree(ref, state, "params"), ref.params, small, lr_of, n)
    _assert_params_close(_tree(ref, state, "ema"), ref.ema_params, small, lr_of, n)


@pytest.mark.parametrize("case", list(UNEVEN))
def test_uneven_layouts_match_the_run_without_mesh(two_ranks, four_ranks, case):
    world, training = UNEVEN[case]
    ranks = _ok((two_ranks if world == 2 else four_ranks)[f"job_train_uneven:{case}"])
    config = tvt.TrainingConfig(**{**SPEC["training"], **training})
    for rank, result in enumerate(ranks):
        assert tuple(result["groups"].tolist()) == trainer_mod.rank_groups(config, rank, world)
        _assert_same(result["spc3"], result["spc1"], f"rank {rank}: chunks of 3 against one step a call")
        _assert_same(result["spc1"], ranks[0]["spc1"], f"rank {rank} against rank 0")
        # a rank without importance groups runs no model; the others one ELBO
        # a microbatch and step, in both runs
        lo, hi = result["groups"].tolist()
        want = 0 if lo == hi else 2 * config.grad_accum_steps * config.n_iterations
        assert result["elbo_calls"] == want, (rank, result["elbo_calls"])
    if case == "iw_groups_on_4":
        assert [r["groups"].tolist() for r in ranks] == [[0, 1], [1, 2], [2, 2], [2, 2]]
    _assert_matches_run_without_mesh(ranks[0]["spc1"], training)


def _assert_matches_jax_mesh(results: dict) -> None:
    from test_torch_train import _assert_params_close, _lr_of

    ranks = _ok(results["job_jax_draws"])
    for rank, result in enumerate(ranks[1:], 1):
        _assert_same(result, ranks[0], f"rank {rank} against rank 0")
    rank0, ref = ranks[0], results["jax"]
    jt, tt, j_m = ref["trainer"], ref["port"], ref["metrics"]
    lr_of, n = _lr_of(tt), ref["n_steps"]
    _assert_params_close(_tree(tt, rank0, "params"), jt.params, ref["small"], lr_of, n)
    _assert_params_close(_tree(tt, rank0, "ema"), jt.ema_params, ref["small"], lr_of, n)
    names = ("elbo", "observation_log_prob", "sde_log_prob", "generative_log_prob",
             "prior_log_prob", "posterior_log_prob", "grad_norm")
    for value, name in zip(rank0["metrics"].tolist(), names):
        np.testing.assert_allclose(value, float(getattr(j_m, name)), rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(rank0["param_means"].numpy(), np.asarray(j_m.param_means), rtol=1e-4)
    assert int(rank0["notfinite"]) == int(j_m.notfinite_count) == 0


def test_uneven_layout_matches_the_jax_mesh(four_ranks):
    """2 importance groups of 4 over 4 ranks (two hold none) against the JAX
    trainer on a 4-device mesh, from its draws and initial weights."""
    _assert_matches_jax_mesh(four_ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_run_without_mesh(two_ranks, case):
    rank0, rank1 = _ok(two_ranks[f"job_train_{case}"])
    _assert_same(rank0, rank1, "rank 0 against rank 1")
    _assert_matches_run_without_mesh(rank0, CASES[case])


def test_two_ranks_match_the_jax_mesh(two_ranks):
    _assert_matches_jax_mesh(two_ranks)


def test_infer_with_a_mesh_on_two_ranks(two_ranks):
    rank0, rank1 = _ok(two_ranks["job_infer"])
    for result in (rank0, rank1):
        assert tuple(result["paths_shape"].tolist()) == (4, 3, 1)
        assert bool(torch.isfinite(result["history"]).all())
    _assert_same(rank0, rank1, "rank 0 against rank 1")  # the same posterior and summary


def test_checkpoints_with_a_mesh(two_ranks):
    rank0, rank1 = _ok(two_ranks["job_checkpoint"])
    assert (rank0["writes"], rank1["writes"]) == (2, 0)  # rank 0 alone writes
    assert (rank0["calls"], rank1["calls"]) == ([0, 1, 2, 3], [])
    for result in (rank0, rank1):
        _assert_same(result["resumed"], result["full"], "resume from step 2 against the unbroken run")
    _assert_same(rank0["full"], rank1["full"], "rank 0 against rank 1")
