"""``mfu`` (%): the step's model FLOP (``work.step_flop``: the forward's
matrix products times 3, from the configuration's shapes) over ``step_ms``
of the same run's untraced window, against the card's highest dense rate
(bf16, 989 TFLOP/s) whatever the cell's precision. Layer: the whole step."""


def read(run):
    s, t = run.shapes, run.traffic
    if not run.step_ms > 0:
        return None
    flop = run.work.step_flop(
        batch=t["batch_size"], n_grid=s.n_grid, hidden=s.hidden, cond=s.cond, heads=s.heads, depth=s.depth,
        mlp_hidden=s.mlp_hidden, param_dim=s.param_dim, obs_dim=s.obs_dim,
        n_obs=int(round(run.config["time_horizon"] / run.config["obs_every"])) + 1,
        state_dim=s.state_dim, head_hidden=s.head_hidden, head_layers=s.head_layers, n_out=s.n_out,
    )
    return 100.0 * flop / (run.step_ms * 1e-3) / run.work.PEAK_FLOPS["bf16"]
