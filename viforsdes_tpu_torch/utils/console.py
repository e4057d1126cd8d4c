"""Rich-based live training UI and summary tables (twin of
``viforsdes_tpu/utils/console.py``).

A live panel with progress bar, elapsed/ETA/it/s (EW-smoothed rate),
smoothed loss, raw/best ELBO, grad norm, the five ELBO components,
per-parameter posterior means and device memory; a completion panel with the
average it/s; a pretrain progress panel; a config panel; and a final
parameter summary table with mean/std/95% CI. ``enabled=False`` silences
everything. ``rich`` is imported only by an enabled console, so the port
imports where rich is absent.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _device_memory_gb(device: torch.device | None) -> float | None:
    """Memory held by tensors on a CUDA ``device``; None elsewhere."""
    if device is None or device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1e9


class _NullProgress:
    def update(self, *args, **kwargs) -> None:
        pass

    def __enter__(self) -> "_NullProgress":
        return self

    def __exit__(self, *exc) -> None:
        pass


class TrainingProgress:
    """Live panel updated every ``update_interval`` steps."""

    def __init__(
        self,
        console,
        n_iterations: int,
        update_interval: int,
        param_names: list[str] | None,
        device: torch.device | None = None,
    ) -> None:
        from rich.progress import (
            BarColumn,
            Progress,
            TaskProgressColumn,
            TextColumn,
            TimeElapsedColumn,
            TimeRemainingColumn,
        )

        self.console = console
        self.n_iterations = n_iterations
        self.update_interval = update_interval
        self.param_names = param_names
        self.device = device
        self.progress = Progress(
            TextColumn("[bold blue]training"),
            BarColumn(bar_width=30),
            TaskProgressColumn(),
            TimeElapsedColumn(),
            TimeRemainingColumn(),
            TextColumn("{task.fields[rate]:.1f} it/s"),
            console=console,
        )
        self.task = self.progress.add_task("train", total=n_iterations, rate=0.0)
        self.live = None
        self._start = time.perf_counter()
        self._last_time = self._start
        self._last_step = 0
        self._rate = 0.0
        self._stats: dict = {}

    def __enter__(self) -> "TrainingProgress":
        from rich.live import Live

        self.live = Live(self._render(), console=self.console, refresh_per_second=4)
        self.live.__enter__()
        self._start = time.perf_counter()
        self._last_time = self._start
        return self

    def __exit__(self, *exc) -> None:
        from rich.panel import Panel

        if self.live is not None:
            self.live.__exit__(*exc)
        elapsed = time.perf_counter() - self._start
        avg_rate = self._last_step / elapsed if elapsed > 0 else 0.0
        self.console.print(
            Panel(
                f"training complete — {self._last_step + 1} steps in {elapsed:.1f}s "
                f"({avg_rate:.2f} it/s avg)",
                title="done",
                border_style="green",
            )
        )

    def _render(self):
        from rich.console import Group
        from rich.table import Table

        rows = [self.progress]
        if self._stats:
            table = Table.grid(padding=(0, 2))
            table.add_column(justify="right", style="bold")
            table.add_column()
            for k, v in self._stats.items():
                table.add_row(k, v)
            rows.append(table)
        return Group(*rows)

    def update(
        self,
        *,
        step: int,
        loss: float,
        elbo: float,
        best_elbo: float,
        components: dict,
        grad_norm: float,
        param_means: np.ndarray,
    ) -> None:
        now = time.perf_counter()
        d_steps = step - self._last_step
        dt = now - self._last_time
        if d_steps > 0 and dt > 0:
            inst = d_steps / dt
            self._rate = inst if self._rate == 0.0 else 0.9 * self._rate + 0.1 * inst
        self._last_step = step
        self._last_time = now

        names = self.param_names or [f"param_{i}" for i in range(len(param_means))]
        param_str = "  ".join(f"{n}={v:.4g}" for n, v in zip(names, np.asarray(param_means)))
        self._stats = {
            "loss (smoothed)": f"{loss:.4f}",
            "ELBO": f"{elbo:.2f}",
            "best ELBO": f"{best_elbo:.2f}",
            "grad norm": f"{grad_norm:.3f}",
            "posterior means": param_str,
            "components": "  ".join(
                f"{k.split('_log_prob')[0]}={v:.1f}" for k, v in components.items()
            ),
        }
        mem = _device_memory_gb(self.device)
        if mem is not None:
            self._stats["device memory"] = f"{mem:.2f} GB"

        self.progress.update(self.task, completed=step + 1, rate=self._rate)
        if self.live is not None:
            self.live.update(self._render())


class PretrainProgress:
    """Pretrain score panel."""

    def __init__(self, console, n_iterations: int) -> None:
        from rich.progress import BarColumn, Progress, TaskProgressColumn, TextColumn, TimeElapsedColumn

        self.console = console
        self.progress = Progress(
            TextColumn("[bold cyan]pretrain"),
            BarColumn(bar_width=30),
            TaskProgressColumn(),
            TimeElapsedColumn(),
            TextColumn("mse={task.fields[mse]:.4g} best={task.fields[best]:.4g} "
                       "σ̃={task.fields[sigma]:.3g}"),
            console=console,
        )
        self.task = self.progress.add_task(
            "pretrain", total=n_iterations, mse=float("nan"), best=float("nan"), sigma=float("nan")
        )

    def __enter__(self) -> "PretrainProgress":
        self.progress.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.progress.__exit__(*exc)

    def update(self, step: int, mse: float, best_mse: float, sigma_median: float) -> None:
        self.progress.update(
            self.task, completed=step + 1, mse=mse, best=best_mse, sigma=sigma_median
        )


class Console:
    """Facade over rich with an ``enabled`` kill switch."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._rich = None
        if enabled:
            from rich.console import Console as RichConsole

            self._rich = RichConsole()

    def print(self, *args, **kwargs) -> None:
        if self.enabled:
            self._rich.print(*args, **kwargs)

    def config_panel(self, config) -> None:
        if not self.enabled:
            return
        from rich.panel import Panel
        from rich.table import Table

        table = Table.grid(padding=(0, 2))
        table.add_column(justify="right", style="bold")
        table.add_column()
        for name, value in dict(config).items():
            table.add_row(str(name), str(getattr(value, "value", value)))
        self._rich.print(Panel(table, title="training config", border_style="blue"))

    def training_progress(
        self,
        n_iterations: int,
        update_interval: int = 10,
        param_names: list[str] | None = None,
        device: torch.device | None = None,
    ) -> "TrainingProgress | _NullProgress":
        """Context manager for the live panel; ``device`` is the one whose
        memory the panel shows (CUDA only)."""
        if not self.enabled:
            return _NullProgress()
        return TrainingProgress(self._rich, n_iterations, update_interval, param_names, device)

    def pretrain_progress(self, n_iterations: int) -> "PretrainProgress | _NullProgress":
        if not self.enabled:
            return _NullProgress()
        return PretrainProgress(self._rich, n_iterations)

    def summary_table(self, summary, diagnostics, param_names: list[str] | None = None) -> None:
        """Mean/std/95% CI per theta dim, and the final ELBO."""
        if not self.enabled:
            return
        from rich.table import Table

        def host(x) -> np.ndarray:
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        mean = host(summary.sde_parameter_mean)
        std = host(summary.sde_parameter_std)
        q05 = host(summary.sde_parameter_quantiles.q05)
        q50 = host(summary.sde_parameter_quantiles.q50)
        q95 = host(summary.sde_parameter_quantiles.q95)
        names = param_names or [f"param_{i}" for i in range(len(mean))]

        table = Table(title="posterior summary")
        for col in ("parameter", "mean", "std", "median", "95% CI"):
            table.add_column(col, justify="right")
        for i, name in enumerate(names):
            table.add_row(
                name,
                f"{mean[i]:.4f}",
                f"{std[i]:.4f}",
                f"{q50[i]:.4f}",
                f"[{q05[i]:.4f}, {q95[i]:.4f}]",
            )
        self._rich.print(table)
        if diagnostics is not None:
            self._rich.print(
                f"final ELBO: {diagnostics.final_evidence_lower_bound:.2f} "
                f"({diagnostics.n_iterations} iterations)"
            )
