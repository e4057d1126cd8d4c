"""The port's examples and quality ladder (``examples_torch/``) against the
JAX package's (``examples/``, ``benchmarks/quality_eval.py``), on the CPU:
the SDE classes, the carried-across observations, every rung's arguments to
``infer``, the two harnesses' summaries, the two JAX-harness defects the
port repairs, and ``tools/ladder_parity.py``'s pass rule."""

import dataclasses
import importlib.util
import inspect
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import viforsdes_tpu as vt
import viforsdes_tpu_torch as vtt
from examples_torch import DATA_DIR, load_observations
from examples_torch import quality_eval as port_harness
from viforsdes_tpu_torch.utils.pytree_io import save_checkpoint

REPO = Path(__file__).resolve().parent.parent


def load_file(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ladder_data = load_file("ladder_data", REPO / "tools" / "ladder_data.py")
ladder_parity = load_file("ladder_parity", REPO / "tools" / "ladder_parity.py")


@pytest.fixture(scope="module")
def jax_harness():
    return ladder_data.jax_harness()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------- SDE classes

# example module -> (class, state dim, param dim, state range, param range)
SDES = {
    "ornstein_uhlenbeck": ("OrnsteinUhlenbeck", (-3.0, 3.0), (0.1, 2.0)),
    "lotka_volterra": ("LotkaVolterra", (1.0, 400.0), (0.001, 1.0)),
    "lorenz63": ("StochasticLorenz63", (-20.0, 40.0), (1.0, 30.0)),
    "sir_epidemic": ("SIR", (0.0, 1000.0), (0.01, 1.0)),
    "highdim_ou_dp": ("HighDimOU", (-3.0, 3.0), (0.1, 2.0)),
}


@pytest.mark.parametrize("module", sorted(SDES))
def test_sde_matches_its_jax_twin(module):
    import jax.numpy as jnp

    cls_name, (x_lo, x_hi), (p_lo, p_hi) = SDES[module]
    jax_sde = getattr(load_file(f"jax_example_{module}", REPO / "examples" / f"{module}.py"), cls_name)()
    port_sde = getattr(importlib.import_module(f"examples_torch.{module}"), cls_name)()
    assert (port_sde.state_dim, port_sde.sde_param_dim) == (jax_sde.state_dim, jax_sde.sde_param_dim)
    rng = np.random.default_rng(7)
    x = rng.uniform(x_lo, x_hi, (2, 5, jax_sde.state_dim)).astype(np.float32)
    p = rng.uniform(p_lo, p_hi, (2, 5, jax_sde.sde_param_dim)).astype(np.float32)
    for method in ("drift", "diffusion"):
        ref = np.asarray(getattr(jax_sde, method)(jnp.asarray(x), jnp.asarray(p)))
        got = getattr(port_sde, method)(torch.from_numpy(x), torch.from_numpy(p)).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=f"{module}.{method}")


def test_examples_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|viforsdes_tpu)(\.|\s|$)", re.MULTILINE)
    files = sorted((REPO / "examples_torch").glob("*.py"))
    assert len(files) == 7  # the package, five examples and the harness
    for path in files:
        assert not pattern.search(path.read_text()), path.name


# ----------------------------------------------------- carried-across data


def test_data_files_are_what_the_jax_code_gives_now():
    regenerated = ladder_data.datasets()
    assert sorted(p.stem for p in DATA_DIR.glob("*.json")) == sorted(regenerated)
    for name, record in regenerated.items():
        assert (DATA_DIR / f"{name}.json").read_text() == ladder_data.dumps(record), name


def test_lorenz_example_data_is_a_stride_of_the_round3_data():
    """One simulated path, observed at two strides: the harness's
    subsampling gives the example's observations to the bit."""
    sub, _ = port_harness.lorenz_observations(0.5, 17)
    example = load_observations("lorenz63_example")
    assert np.array_equal(sub.times, example.times)
    assert torch.equal(sub.values, example.values)


# ---------------------------------------------- the rungs' calls to infer

RUN_ARGS = {  # rung -> (function name, arguments of both harnesses)
    "ou": ("run_ou", {}),
    **{name: (fn.__name__, kw) for name, (fn, kw, _, _) in port_harness.RUNGS.items()},
    "lorenz_default": ("run_lorenz", {}),
    "highdim_default_noisy": ("run_highdim", dict(obs_noise=0.1)),
}


def _same_config_field(name, a, b):
    if hasattr(a, "model_dump"):
        assert a.model_dump(mode="json") == b.model_dump(mode="json"), name
    elif name == "console":
        assert a.enabled is False and b.enabled is False
    elif name == "x0" and a is not None:
        assert np.array_equal(np.asarray(a), b.numpy()), name
    else:
        assert a == b, name


@pytest.mark.parametrize("rung", sorted(RUN_ARGS))
def test_rung_calls_infer_as_the_jax_harness_does(rung, jax_harness):
    fn_name, kw = RUN_ARGS[rung]
    jax_call = ladder_data.capture_infer(vt, getattr(jax_harness, fn_name), 3, **kw)
    port_call = ladder_data.capture_infer(vtt, getattr(port_harness, fn_name), 3, **kw)

    assert type(port_call["sde"]).__name__ == type(jax_call["sde"]).__name__
    obs_j, obs_p = jax_call["observations"], port_call["observations"]
    assert np.array_equal(np.asarray(obs_j.times), obs_p.times)
    assert np.array_equal(np.asarray(obs_j.values), obs_p.values.numpy())
    lik_j, lik_p = jax_call["observation_likelihood"], port_call["observation_likelihood"]
    assert lik_j.variance == lik_p.variance
    assert (lik_j.obs_matrix is None) == (lik_p.obs_matrix is None)
    if lik_j.obs_matrix is not None:
        assert np.array_equal(np.asarray(lik_j.obs_matrix), lik_p.obs_matrix.numpy())
    pri_j, pri_p = jax_call["prior"], port_call["prior"]
    assert (pri_j.type.name, pri_j.mean, pri_j.std, pri_j.dim) == (pri_p.type.name, pri_p.mean, pri_p.std, pri_p.dim)
    assert jax_call["time_horizon"] == port_call["time_horizon"]

    cfg_j, cfg_p = jax_call["config"], port_call["config"]
    fields_j = {f.name for f in dataclasses.fields(cfg_j)}
    fields_p = {f.name for f in dataclasses.fields(cfg_p)}
    assert fields_p - fields_j == {"device"}  # the one field only the port has
    assert fields_j <= fields_p
    assert cfg_p.device == "cuda"
    for name in sorted(fields_j):
        _same_config_field(name, getattr(cfg_j, name), getattr(cfg_p, name))


# ------------------------------------------------------------- summaries


def _fake_posterior(to):
    mean = np.asarray([1.3, 0.9, 0.45], np.float32)
    std = np.asarray([0.2, 0.05, 0.03], np.float32)
    summary = types.SimpleNamespace(
        sde_parameter_mean=to(mean), sde_parameter_std=to(std),
        sde_parameter_quantiles=types.SimpleNamespace(q05=to(mean - 1.6 * std), q95=to(mean + 1.7 * std)))
    history = [float(v) for v in np.linspace(-40.0, -1.5, 450, dtype=np.float32)]
    return types.SimpleNamespace(summary=lambda n_samples: summary, evidence_lower_bound_history=history)


@pytest.mark.parametrize("truth", [None, (1.5, 1.0, 0.4)])
def test_summaries_give_the_same_json(truth, jax_harness, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jax_harness, "__file__", str(tmp_path / "jax" / "quality_eval.py"))
    (tmp_path / "jax").mkdir()
    names = ["kappa", "mu", "sigma"]
    j = jax_harness._summarize("rung", _fake_posterior(np.asarray), names, 450, 12.34, true_params=truth)
    p = port_harness._summarize("rung", _fake_posterior(torch.from_numpy), names, 450, 12.34, true_params=truth,
                                out_dir=tmp_path / "port")
    assert j == p
    assert (tmp_path / "jax" / "results_rung.json").read_text() == (tmp_path / "port" / "results_rung.json").read_text()


# ---------------------------------------------------- the repaired defects


def test_highdim_obs_noise_defaults_to_the_correctly_specified_claim(jax_harness):
    """JAX's default is noiseless data under a claimed variance: unpassable;
    the port defaults to noise of the claim's size."""
    assert inspect.signature(jax_harness.run_highdim).parameters["obs_noise"].default == 0.0
    assert inspect.signature(port_harness.run_highdim).parameters["obs_noise"].default == 0.1
    call = ladder_data.capture_infer(vtt, port_harness.run_highdim, 3)
    assert torch.equal(call["observations"].values, load_observations("highdim_r5").values)


def test_wall_clock_continues_from_the_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt_x.npz"
    save_checkpoint(ckpt, trees={}, metadata={"next_step": 20})
    port_harness.time_record(ckpt).write_text(json.dumps({
        "10": {"seconds": 50.0, "segments": 1}, "20": {"seconds": 100.0, "segments": 2}}))
    clock = port_harness.WallClock(tmp_path / "next.npz", ckpt)
    assert clock.segments == 3
    assert 100.0 <= clock.seconds() < 110.0
    clock.mark(30)
    marks = json.loads(port_harness.time_record(tmp_path / "next.npz").read_text())
    assert marks["30"]["segments"] == 3 and marks["30"]["seconds"] >= 100.0


def test_resumed_rung_sums_its_segments(tmp_path, monkeypatch):
    """A run resumed from its step-10 checkpoint reports the wall time of
    both segments (JAX's harness reports the last one only)."""
    from test_torch_ladder_examples import tiny_infer

    monkeypatch.setattr(vtt, "infer", tiny_infer(vtt.infer))
    ck = tmp_path / "ck"
    first = port_harness.run_ou_synthetic(10, opts=port_harness.RunOptions(
        out_dir=tmp_path / "a", checkpoint_every=10, checkpoint_dir=ck))
    marks = json.loads((ck / "ckpt_ou_synthetic.time.json").read_text())
    assert list(marks) == ["10"] and marks["10"]["segments"] == 1
    assert first["port"]["segments"] == 1 and first["port"]["resumed_from"] is None
    resumed = port_harness.run_ou_synthetic(20, opts=port_harness.RunOptions(
        out_dir=tmp_path / "b", resume_from=ck / "ckpt_ou_synthetic.npz",
        checkpoint_every=10, checkpoint_dir=tmp_path / "ck2"))
    assert resumed["port"]["segments"] == 2
    assert resumed["n_iterations"] == 20
    assert resumed["train_seconds"] >= round(marks["10"]["seconds"], 1)
    assert json.loads((tmp_path / "ck2" / "ckpt_ou_synthetic.time.json").read_text())["20"]["segments"] == 2


def test_lv_fp32_diagnostic_is_the_lv_rung_in_fp32():
    """``tools/lv_fp32.py`` runs the LV rung's recipe with the training
    step's dtype the one change."""
    lv_fp32 = load_file("lv_fp32", REPO / "tools" / "lv_fp32.py")
    real = vtt.infer
    rung = ladder_data.capture_infer(vtt, port_harness.run_lv, 3, port_harness.RunOptions())
    diag = ladder_data.capture_infer(vtt, lv_fp32.run_lv_fp32, 3, port_harness.RunOptions())
    assert vtt.infer is real
    cfg, cfg32 = rung["config"], diag["config"]
    assert cfg.training.compute_dtype != vtt.ComputeDtype.FLOAT32
    assert cfg32.training.compute_dtype == vtt.ComputeDtype.FLOAT32
    assert cfg32.training.model_copy(update={"compute_dtype": cfg.training.compute_dtype}) == cfg.training
    for f in dataclasses.fields(cfg):
        if f.name != "training":
            _same_config_field(f.name, getattr(cfg, f.name), getattr(cfg32, f.name))
    assert torch.equal(rung["observations"].values, diag["observations"].values)
    assert rung["time_horizon"] == diag["time_horizon"]


# ------------------------------------------------------------ ladder_parity


def _result(n, means, stds, truth=None):
    r = {"n_iterations": n, "posterior_mean": dict(means), "posterior_std": dict(stds)}
    if truth:
        r["true_params"] = dict(truth)
    return r


@pytest.mark.parametrize("m_port, s_port, m_jax, s_jax, want", [
    (1.0, 0.3, 1.0 + 2 * 0.5, 0.4, True),      # exactly at the bar: 2 sqrt(0.09 + 0.16) = 1.0
    (1.0, 0.3, 1.0 + 1.0001, 0.4, False),
    (5.0, 0.0, 5.0, 0.0, True),
    (-2.0, 0.1, 2.0, 0.1, False),
])
def test_parity_rule(m_port, s_port, m_jax, s_jax, want):
    assert ladder_parity.agrees(m_port, s_port, m_jax, s_jax) is want


def test_parity_of_hand_made_ladders(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    jax = {
        "a": _result(100, {"k": 1.0, "s": 0.5}, {"k": 0.1, "s": 0.05}, truth={"k": 1.1, "s": 0.5}),
        "b": _result(100, {"k": 2.0}, {"k": 0.1}),
        "c": _result(100, {"k": 3.0}, {"k": 0.1}),
        "d": _result(100, {"k": 4.0}, {"k": 0.1}),
    }
    port = {
        "a": _result(100, {"k": 1.2, "s": 0.5}, {"k": 0.1, "s": 0.05}),   # both within 2 joint sigma
        "b": _result(100, {"k": 2.5}, {"k": 0.1}),                        # off by 3.5 joint sigma
        "c": _result(60, {"k": 3.0}, {"k": 0.1}),                         # stopped early
    }
    for name, r in jax.items():
        (jax_dir / f"results_{name}.json").write_text(json.dumps(r))
    for name, r in port.items():
        (port_dir / f"results_{name}.json").write_text(json.dumps(r))
    v = ladder_parity.ladder(port_dir, jax_dir, rungs=("a", "b", "c", "d"))
    assert v["a"]["agrees"] and v["a"]["full_length"]
    assert v["a"]["params"]["k"]["port_within_2sigma_of_truth"]
    assert v["a"]["params"]["k"]["jax_within_2sigma_of_truth"]
    assert not v["b"]["agrees"] and not v["b"]["params"]["k"]["agrees"]
    assert v["c"]["params"]["k"]["agrees"] and not v["c"]["full_length"] and not v["c"]["agrees"]
    assert v["d"] is None
    text = ladder_parity.report(v)
    assert "a: AGREES" in text and "b: MISSES" in text and "not a pass" in text and "d: no port result" in text


def test_parity_rungs_are_the_harness_rungs():
    assert set(ladder_parity.RUNGS) == set(port_harness.RUNGS)
    for name, (fn, kw, n, ref) in port_harness.RUNGS.items():
        jax = json.loads((REPO / ref).read_text())
        assert ref == f"benchmarks/results_{name}.json"
        assert jax["n_iterations"] == n, name
        assert kw.get("name", fn.__name__.removeprefix("run_")) == name


def test_chip_smoke_checks_the_rungs_sampler_shapes():
    """``chip_smoke.py``'s ladder shapes are the ones the rungs' recipes
    give the sampler (batch, path steps, state, head), and its flash rungs
    are the ones past the dense path's 512 tokens."""
    chip_smoke = load_file("chip_smoke_for_ladder", REPO / "chip_smoke.py")
    label = {"lorenz": "lorenz r3", "highdim_r5_noisy": "highdim r5", "sir": "sir", "lv": "lv"}
    flash = set()
    for name, (fn, kw, _, _) in port_harness.RUNGS.items():
        call = ladder_data.capture_infer(vtt, fn, 3, **kw)
        cfg = call["config"]
        dt = cfg.training.time_step
        steps = round(call["time_horizon"] / dt)
        shape = (cfg.training.batch_size, steps, call["sde"].state_dim, cfg.head.hidden_dim, cfg.head.num_layers, dt)
        if name in label:
            assert chip_smoke.LADDER_SHAPES[label[name]] == shape, name
        else:  # OU-synthetic: the OU bench shape of SHAPES
            assert shape == (128, 100, 1, 64, 2, 0.05) and chip_smoke.SHAPES[0][:5] == (128, 100, 1, 64, 2)
        if steps + 1 > 512:
            flash.add(name)
    assert flash == set(chip_smoke.LADDER_FLASH_RUNGS)
