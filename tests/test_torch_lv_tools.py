"""``tools/lv_seeds.py`` and ``tools/lv_step.py`` on the CPU: each seed and arm
runs the LV rung's recipe with the seed and the dtype its name says, the
ELBO curve and N* follow their definitions, the table gives
``tools/ladder_parity.py``'s verdicts, and every probe of the one-step
comparison runs (at a tiny width) with its patch in effect and undone after.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import viforsdes_tpu_torch as vtt
from examples_torch import quality_eval as qe
from test_torch_ladder import REPO, _same_config_field, ladder_data, ladder_parity, load_file

lv_seeds = load_file("lv_seeds", REPO / "tools" / "lv_seeds.py")
lv_step = load_file("lv_step", REPO / "tools" / "lv_step.py")

TINY = dict(encoder=dict(hidden_dim=16, cond_dim=16, num_heads=2, depth=2),
            head=dict(hidden_dim=8, num_layers=2), batch=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _module_state():
    """Every attribute a probe may patch, by identity."""
    encoder, attention, cond, mlp, sit = lv_step._modules()
    return [attention.dense_sdpa] + [m.linear for m in (encoder, attention, cond, mlp, sit)]


# ------------------------------------------------------------------ lv_seeds


@pytest.mark.parametrize("arm", list(lv_seeds.ARMS))
def test_seed_arm_is_the_lv_rung_with_its_seed_and_change(arm, tmp_path):
    before, real = _module_state(), vtt.infer
    rung = ladder_data.capture_infer(vtt, qe.run_lv, 3, qe.RunOptions(out_dir=tmp_path))
    got = ladder_data.capture_infer(vtt, lv_seeds.run, arm, 2, 3, tmp_path)
    # the arm wraps ``infer`` for the run and patches nothing in the package
    assert _module_state() == before and vtt.infer is real
    cfg, cfg_arm = rung["config"], got["config"]
    assert cfg.seed == 0 and cfg_arm.seed == 2
    dtype = vtt.ComputeDtype.FLOAT32 if arm == "fp32" else cfg.training.compute_dtype
    assert cfg_arm.training.compute_dtype == dtype
    assert cfg_arm.training.model_copy(update={"compute_dtype": cfg.training.compute_dtype}) == cfg.training
    for f in dataclasses.fields(cfg):
        if f.name not in ("training", "seed"):
            _same_config_field(f.name, getattr(cfg, f.name), getattr(cfg_arm, f.name))
    assert torch.equal(rung["observations"].values, got["observations"].values)
    assert rung["time_horizon"] == got["time_horizon"]


def test_curve_decimates_by_blocks():
    history = [float(i) for i in range(250)]
    c = lv_seeds.curve(history)
    assert c["every"] == 100 and c["n_steps"] == 250
    assert c["block_mean"] == [49.5, 149.5] and c["value_at"] == [99.0, 199.0]
    assert lv_seeds.mean200(c["block_mean"]) == [99.5]  # the mean of steps 0-199


def _blocks(values):
    return {"every": 100, "block_mean": list(values)}


@pytest.mark.parametrize("gaps, expected", [
    # fp32 - bf16 per block of 100 steps -> N*
    ([0, 0, 0, 150, 150, 150, 150], 500),   # from the block ending at step 500 on
    ([0, 150, 150, 0, 0, 150, 150, 150], 700),  # a gap that closes does not count
    ([0, 150, 150, 150, 0, 0], None),        # ends within the gap
])
def test_n_star_is_the_first_step_after_which_the_gap_stays(gaps, expected):
    fp32 = [-100.0] * len(gaps)
    bf16 = [f - g for f, g in zip(fp32, gaps)]
    assert lv_seeds.n_star(_blocks(bf16), _blocks(fp32)) == expected


def test_table_gives_the_parity_verdicts_and_n_star(tmp_path):
    jax = json.loads(lv_seeds.JAX_RESULT.read_text())
    far = {k: 0.8 * m for k, m in jax["posterior_mean"].items()}
    runs = (("bf16_seed0", far, -600.0), ("fp32_seed0", jax["posterior_mean"], -100.0),
            ("bf16_seed1", jax["posterior_mean"], -100.0), ("bf16_seed0_50000", jax["posterior_mean"], -100.0))
    assert [lv_seeds.run_dir(tmp_path, "bf16", 0, n).name for n in (30000, 50000)] == ["bf16_seed0", runs[3][0]]
    for name, means, block in runs:
        d = tmp_path / name
        d.mkdir()
        result = {"n_iterations": 30000, "elbo_final_mean200": block, "posterior_mean": means,
                  "posterior_std": jax["posterior_std"], "port": {"card": "a card, 700 W"}}
        (d / "results_lv.json").write_text(json.dumps(result))
        (d / "elbo.json").write_text(json.dumps(_blocks([block] * 300)))
    t = lv_seeds.table(tmp_path)
    for name, run in t["runs"].items():
        r = json.loads((tmp_path / name / "results_lv.json").read_text())
        assert run["agrees"] == ladder_parity.compare(r, jax)["agrees"]
    assert [t["runs"][n[0]]["agrees"] for n in runs] == [False, True, True, True]
    assert t["runs"]["bf16_seed0_50000"]["seed"] == 0
    # the longer run is not paired with fp32's run of the recipe's length
    assert t["n_star"] == {"0": 200}
    md = (tmp_path / "table.md").read_text()
    assert "bf16_seed0" in md and "seed 0: 200" in md and "a card, 700 W" in md


# ------------------------------------------------------------------- lv_step


@pytest.fixture(scope="module")
def probed():
    return lv_step.run(list(lv_step.PROBES), card="cpu", log=lambda msg: None, **TINY)


def test_one_step_sides_agree_on_the_cpu(probed):
    # with the CPU as the card both sides run the same plain path
    assert probed["cuda"] == probed["cpu"]
    assert probed["fp32_card_vs_cpu"]["all"] == 0.0
    assert 0.0 < probed["cpu"]["encoder"] < 2e-2 and probed["cpu"]["elbo_rel"] < 2e-2


@pytest.mark.parametrize("probe", list(lv_step.PROBES))
def test_probe_runs_with_its_patch_in_effect(probed, probe):
    before = _module_state()
    with lv_step.PROBES[probe][0]():
        inside = _module_state()
    assert _module_state() == before
    r = probed[probe]
    assert np.isfinite([r["elbo_rel"], r["all"], r["encoder"]]).all()
    assert r["encoder"] < 2e-2 and r["elbo_rel"] < 2e-2
    # the flag is cuBLAS's and the sampler choice the card's: the CPU step
    # is the plain bf16 one; every other probe changes the bf16 step
    same = probe in ("full_precision_reduction", "plain_sampler")
    assert (r["leaf"] == probed["cuda"]["leaf"]) == same
    assert (inside == before) == same


# ------------------------------------------------ chip_smoke's [lv bf16] bars

chip_smoke = load_file("chip_smoke", REPO / "chip_smoke.py")
READING = REPO / "examples_torch" / "results" / "lv_seeds" / "lv_step.json"


def test_recorded_card_reading_passes_the_bars(probed):
    assert chip_smoke.lv_bf16_failures(json.loads(READING.read_text())) == []
    assert chip_smoke.lv_bf16_failures(probed) == []


@pytest.mark.parametrize("leaf, error, flagged", [
    ("encoder/sit/blocks/0/attn/qkv_proj/b", 0.49, True),   # a bias gradient summed in bf16
    ("encoder/sit/blocks/3/attn/v_residual_lambda", 1.05, True),  # the JAX CPU step's lambda
    ("encoder/sit/blocks/3/attn/v_residual_lambda", 0.05, False),  # under its floor
    ("head/out_proj/b", 9e-4, False),                        # under the leaf floor
    ("head/out_proj/b", 2e-3, True),                         # above it, 50x the CPU's
])
def test_leaf_bar_with_its_floors(leaf, error, flagged):
    out = json.loads(READING.read_text())
    out["cuda"]["leaf"][leaf] = error
    bad = chip_smoke.lv_bf16_failures(out)
    assert bool(bad) == flagged
    assert all(leaf in b for b in bad)


class _BiasSumBf16(torch.autograd.Function):
    """``y + b`` whose bias gradient is summed row by row in bf16."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        acc = torch.zeros(g.shape[-1], dtype=g.dtype)
        for row in g.reshape(-1, g.shape[-1]):
            acc = acc + row
        return g, acc.float()


def test_leaf_bar_catches_a_bias_gradient_summed_in_bf16_that_the_totals_miss(monkeypatch):
    """The card's bf16 step with every qkv projection's bias gradient summed
    in bf16 (the mutation), the CPU's as it is: the totals stay within
    ``LV_BF16_BAR``, the qkv bias leaves do not."""
    from viforsdes_tpu_torch.ops import attention

    real = attention.linear

    def mutated(params, x):
        w = params["w"]
        if "b" in params and w.shape[1] == 3 * w.shape[0]:
            return _BiasSumBf16.apply(x @ w.to(x.dtype), params["b"])
        return real(params, x)

    flat, theta_eps, noise = lv_step.reference(**TINY)
    res = {}
    for side in ("cuda", "cpu"):
        for dtype in ("float32", "bfloat16"):
            with monkeypatch.context() as m:
                if (side, dtype) == ("cuda", "bfloat16"):
                    m.setattr(attention, "linear", mutated)
                res[side, dtype] = lv_step.step(lv_step.lv_trainer("cpu", dtype, **TINY), flat, theta_eps, noise)
    out = {side: {"elbo_rel": 0.0, **lv_step.errors(res[side, "bfloat16"][1], res[side, "float32"][1])}
           for side in ("cuda", "cpu")}
    out["fp32_card_vs_cpu"] = {"elbo_rel": 0.0, **lv_step.errors(res["cuda", "float32"][1], res["cpu", "float32"][1])}
    for w in ("all", "encoder"):
        assert out["cuda"][w] < chip_smoke.LV_BF16_BAR * out["cpu"][w]
    bad = chip_smoke.lv_bf16_failures(out)
    qkv = [p for p in out["cuda"]["leaf"] if p.endswith("qkv_proj/b")]
    assert len(bad) == len(qkv) == TINY["encoder"]["depth"]
    assert all(any(p in b for b in bad) for p in qkv)
