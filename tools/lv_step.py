"""One training step of the Lotka-Volterra rung at its full width, bf16 against
fp32, on the card (the kernel path) and on the CPU (the plain path).

    python3 tools/lv_step.py [--probe NAME ...] [--json PATH]

The problem is ``examples_torch/quality_eval.py``'s ``run_lv`` (its
observations, likelihood, prior, 401 grid tokens, positive state and
parameters) at the rung's widths: SiT 256 x 4 heads x 8 deep, GRU 64 x 2,
batch 24. One set of weights (the trainer's init from seed 0, with the SiT
modulators and the head's output projection drawn from a seeded generator,
as ``tests/test_torch_lv_bf16.py`` perturbs them, and theta's mean at
log(0.5, 0.0025, 0.3)), one theta draw and one path-noise draw feed four
steps: bf16 and fp32 on the card and on the CPU. For each side it prints the
relative error of the bf16 ELBO and gradient against that side's fp32 step:
in total (every leaf, and the encoder's leaves) and per leaf, worst first;
and the card's fp32 step against the CPU's. ``--probe`` adds the card's bf16
step under one change each, against the card's fp32 step (``PROBES``):
cuBLAS's full-precision reduction for bf16 GEMMs, the weight-gradient GEMMs
on fp32 inputs, the dense SDPA's P.V product in fp32, or the plain sampler
loop in place of K1/K2. ``chip_smoke.py``'s ``[lv bf16]`` runs the four steps. Needs a
CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# the rung's widths
ENCODER = dict(hidden_dim=256, num_heads=4, depth=8)
HEAD = dict(hidden_dim=64, num_layers=2)
BATCH, DT, HORIZON = 24, 0.1, 40.0
THETA_MEAN = (0.5, 0.0025, 0.3)
WEIGHT_SEED = 5


def lv_trainer(device: str, dtype: str, *, sampler: str = "auto", **sizes):
    """A trainer of the LV rung's problem at the rung's widths (or ``sizes``:
    ``encoder``, ``head``, ``batch``)."""
    import viforsdes_tpu_torch as vtt
    from examples_torch import quality_eval as qe
    from examples_torch.lotka_volterra import LotkaVolterra
    from viforsdes_tpu_torch.inference.trainer import VariationalInferenceTrainer

    return VariationalInferenceTrainer(
        LotkaVolterra(),
        vtt.Observations(**qe.LV_OBSERVATIONS),
        vtt.GaussianObservationLikelihood(variance=1.0),
        vtt.Prior(type=vtt.PriorType.LOG_NORMAL, mean=0.0, std=1.5, dim=3),
        HORIZON,
        vtt.TrainingConfig(time_step=DT, batch_size=sizes.get("batch", BATCH), n_iterations=1,
                           compute_dtype=dtype),
        vtt.EncoderConfig(**sizes.get("encoder", ENCODER)),
        vtt.HeadConfig(**sizes.get("head", HEAD), sampler=sampler),
        state_positive_dims=[0, 1],
        sde_param_positive_dims=[0, 1, 2],
        device=device,
    )


def reference(**sizes):
    """The weights (a tree of CPU fp32 tensors) and the draws of the probe."""
    trainer = lv_trainer("cpu", "float32", **sizes)
    params = trainer.params
    gen = torch.Generator().manual_seed(WEIGHT_SEED)
    with torch.no_grad():
        for block in params["encoder"]["sit"]["blocks"]:
            w = block["cond"]["net"]["w"]
            w.copy_(0.3 * torch.randn(w.shape, generator=gen))
        w = params["head"]["out_proj"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=gen))
        params["theta"]["mean"].copy_(torch.log(torch.tensor(THETA_MEAN)))
    theta_eps, noise = trainer.draws(0)[0]
    return {g: p.detach().clone() for g, p in trainer.flat_params.items()}, theta_eps, noise


def step(trainer, flat: dict, theta_eps, noise) -> tuple[float, dict]:
    """ELBO and per-leaf gradient (float64, on the CPU) of one step on
    ``flat`` weights and the given draws."""
    from viforsdes_tpu_torch.inference.optimizer import GROUPS
    from viforsdes_tpu_torch.utils.tree import tree_items

    dev = trainer.device
    leaves = {g: flat[g].to(dev).requires_grad_() for g in GROUPS}
    res = trainer._elbo_from_params(trainer.layout.unpack(leaves), theta_eps.to(dev), noise.to(dev))
    grads = torch.autograd.grad(res.evidence_lower_bound, [leaves[g] for g in GROUPS])
    tree = trainer.layout.unpack(dict(zip(GROUPS, grads)))
    return float(res.evidence_lower_bound.detach()), {p: g.detach().double().cpu() for p, g in tree_items(tree)}


def errors(low: dict, ref: dict) -> dict:
    """Relative error of one gradient against another: in total over every
    leaf and over the encoder's leaves, and per leaf."""
    def total(paths):
        num = sum(float(((low[p] - ref[p]) ** 2).sum()) for p in paths)
        return (num / max(sum(float((ref[p] ** 2).sum()) for p in paths), 1e-300)) ** 0.5

    per = {p: float((low[p] - ref[p]).norm()) / max(float(ref[p].norm()), 1e-30) for p in ref}
    return {"all": total(list(ref)), "encoder": total([p for p in ref if p.startswith("encoder/")]),
            "leaf": per}


# ------------------------------------------------------------- probes

@contextlib.contextmanager
def patched(*triples):
    """Set ``(module, name, value)`` attributes for the block, then restore."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in triples]
    for m, n, v in triples:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _modules():
    from viforsdes_tpu_torch.models import encoder
    from viforsdes_tpu_torch.ops import attention, cond, mlp, sit

    return encoder, attention, cond, mlp, sit


class _WgradFp32(torch.autograd.Function):
    """``x @ w`` in x's dtype whose weight gradient is one GEMM on fp32
    inputs (the bf16 values, products and sums in fp32)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gw = x.reshape(-1, x.shape[-1]).float().T @ g.reshape(-1, g.shape[-1]).float()
        return g @ w.to(x.dtype).T, gw


def wgrad_fp32():
    """Every linear layer's weight-gradient GEMM on fp32 inputs."""
    def linear(params, x):
        y = _WgradFp32.apply(x, params["w"])
        return y + params["b"].to(x.dtype) if "b" in params else y

    return patched(*((m, "linear", linear) for m in _modules()))


@contextlib.contextmanager
def full_precision_reduction():
    """cuBLAS's reduced-precision reductions off for bf16 GEMMs."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def fp32_sdpa():
    """The dense SDPA's P.V product in fp32 (its logits already are)."""
    _, attention, _, _, _ = _modules()
    real = attention.dense_sdpa
    return patched((attention, "dense_sdpa",
                    lambda q, k, v, real_len=None: real(q.float(), k.float(), v.float(), real_len).to(v.dtype)))


# probe -> (context manager, the card trainer's sampler)
PROBES = {
    "full_precision_reduction": (full_precision_reduction, "auto"),
    "wgrad_fp32": (wgrad_fp32, "auto"),
    "fp32_sdpa": (fp32_sdpa, "auto"),
    "plain_sampler": (contextlib.nullcontext, "scan"),
}


def run(probes=(), *, log=print, after_card=None, card: str = "cuda", **sizes) -> dict:
    """The four steps (and the probes): errors of each side's bf16 step
    against its own fp32 step, and of the card's fp32 step against the
    CPU's. ``after_card`` is called after the card's two steps (the launch
    counters' reader) and its value kept as ``launches``. ``card="cpu"``
    rehearses the whole on the CPU."""
    flat, theta_eps, noise = reference(**sizes)
    out = {"reduced_precision_reduction": torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}
    res = {}
    for side, device in (("cuda", card), ("cpu", "cpu")):
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            res[side, dtype] = step(lv_trainer(device, dtype, **sizes), flat, theta_eps, noise)
            if device == "cuda":
                torch.cuda.synchronize()
            log(f"[lv bf16] {side} {dtype}: ELBO {res[side, dtype][0]:.6f} ({time.perf_counter() - t0:.1f} s)")
        if side == "cuda" and after_card is not None:
            out["launches"] = after_card()
    for side in ("cuda", "cpu"):
        e32, e16 = res[side, "float32"][0], res[side, "bfloat16"][0]
        out[side] = {"elbo_rel": abs(e16 - e32) / abs(e32),
                     **errors(res[side, "bfloat16"][1], res[side, "float32"][1])}
    cross = errors(res["cuda", "float32"][1], res["cpu", "float32"][1])
    e_card, e_cpu = res["cuda", "float32"][0], res["cpu", "float32"][0]
    out["fp32_card_vs_cpu"] = {"elbo_rel": abs(e_card - e_cpu) / abs(e_cpu), **cross}
    for name in probes:
        cm, sampler = PROBES[name]
        with cm():
            e, g = step(lv_trainer(card, "bfloat16", sampler=sampler, **sizes), flat, theta_eps, noise)
        out[name] = {"elbo_rel": abs(e - e_card) / abs(e_card), **errors(g, res["cuda", "float32"][1])}
    report(out, probes, log)
    return out


def report(out: dict, probes, log=print) -> None:
    log(f"[lv bf16] torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "
        f"{out['reduced_precision_reduction']}")
    for name in ("cuda", "cpu", "fp32_card_vs_cpu", *probes):
        r = out[name]
        what = {"cuda": "card bf16 vs card fp32", "cpu": "CPU bf16 vs CPU fp32",
                "fp32_card_vs_cpu": "card fp32 vs CPU fp32"}.get(name, f"probe {name}: card bf16 vs card fp32")
        log(f"[lv bf16] {what}: ELBO rel {r['elbo_rel']:.3e}, gradient total {r['all']:.4e}, "
            f"encoder {r['encoder']:.4e}")
    card, cpu = out["cuda"]["leaf"], out["cpu"]["leaf"]
    for p in sorted(card, key=card.get, reverse=True)[:12]:
        probe_errs = " ".join(f"{n} {out[n]['leaf'][p]:.3e}" for n in probes)
        log(f"[lv bf16] leaf {p}: card {card[p]:.3e} CPU {cpu[p]:.3e} {probe_errs}".rstrip())


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("lv_step: no CUDA device", file=sys.stderr)
        return 2
    probes = [argv[i + 1] for i, a in enumerate(argv) if a == "--probe"]
    for name in probes:
        if name not in PROBES:
            raise SystemExit(f"unknown probe {name!r}; probes: {', '.join(PROBES)}")
    from examples_torch.quality_eval import card

    out = {"card": card(), **run(probes)}
    if "--json" in argv:
        Path(argv[argv.index("--json") + 1]).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
