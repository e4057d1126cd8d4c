"""The port's config schema equals the JAX package's: field names, defaults
and validators (``viforsdes_tpu_torch/config.py`` is a copy that maps
``ComputeDtype`` to torch dtypes)."""

import dataclasses
import importlib

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import pytest
import torch

import viforsdes_tpu.config as jcfg
import viforsdes_tpu_torch.config as tcfg

# both packages re-export a function named like the module
jinfer = importlib.import_module("viforsdes_tpu.infer")
tinfer = importlib.import_module("viforsdes_tpu_torch.infer")

MODELS = ["TrainingConfig", "EncoderConfig", "HeadConfig", "PretrainConfig"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", MODELS)
def test_fields_and_defaults_match(name):
    j = getattr(jcfg, name).model_fields
    t = getattr(tcfg, name).model_fields
    assert list(t) == list(j)
    for field in j:
        jd, td = j[field].default, t[field].default
        if isinstance(jd, jcfg.ComputeDtype):  # two Enum classes: compare values
            jd, td = jd.value, td.value
        assert td == jd, field
        assert str(t[field].annotation) == str(j[field].annotation), field


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("TrainingConfig", {"batch_size": 10, "iw_samples": 3}),
        ("TrainingConfig", {"theta_warmup_steps": -1}),
        ("TrainingConfig", {"obs_variance_anneal_steps": 5}),
        ("TrainingConfig", {"batch_size": 12, "grad_accum_steps": 4, "iw_samples": 2}),
        ("TrainingConfig", {"time_step": 0.0}),
        ("EncoderConfig", {"hidden_dim": 30, "num_heads": 4}),
        ("HeadConfig", {"sampler": "triton"}),
        ("HeadConfig", {"cholesky": "banded"}),
        ("PretrainConfig", {"elite_fraction": 1.5}),
    ],
)
def test_validators_reject_alike(name, kwargs):
    with pytest.raises(ValueError):
        getattr(jcfg, name)(**kwargs)
    with pytest.raises(ValueError):
        getattr(tcfg, name)(**kwargs)


def test_compute_dtype():
    assert [e.value for e in tcfg.ComputeDtype] == [e.value for e in jcfg.ComputeDtype]
    assert tcfg.ComputeDtype.BFLOAT16.value_dtype is torch.bfloat16
    assert tcfg.ComputeDtype.FLOAT32.value_dtype is torch.float32
    assert tcfg.TrainingConfig().compute_dtype is tcfg.ComputeDtype.BFLOAT16


def test_inference_config_replaces_mesh_with_device():
    j = {f.name: f for f in dataclasses.fields(jinfer.InferenceConfig)}
    t = {f.name: f for f in dataclasses.fields(tinfer.InferenceConfig)}
    # the port adds an explicit device beside the mesh; every other field is
    # the JAX one's
    assert set(t) == set(j) | {"device"}
    for name in set(t) & set(j):
        assert t[name].default == j[name].default, name
    assert tinfer.InferenceConfig().device == "cuda"
