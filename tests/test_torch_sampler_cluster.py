"""The host side of K1's cluster path (``ops/sde_sampler.py``): the plan that
picks a path, a cluster and rows by shape, the per-CTA column layout, and the
packed weight slices, checked by a model of the kernel that reads the packed
buffer as ``fwd_cluster_kernel`` does (the same offsets, the same index
rules, the L eps of each state entry summed along its own tril row) against
the plain loop. The kernel itself runs only on the card (``chip_smoke.py``,
which also holds the card's plan against ``plan_forward``).

Bars: the model and the plain loop sum in other orders, fp32: rtol 1e-5 and
atol 1e-5 times the largest value.
"""

import numpy as np
import pytest
import torch

from viforsdes_tpu_torch.ops import sde_sampler as ss

N_SMS, OPTIN = 132, 232448  # an H100: multiprocessors, opt-in shared memory a block
# the clusters an H100 SXM runs at once at one CTA a multiprocessor
# (cudaOccupancyMaxActiveClusters), by cluster size
CARD_SLOTS = {2: 66, 4: 30, 8: 15, 16: 7}


def _case(d, h, n_layers, cholesky, batch, steps, seed):
    rng = np.random.default_rng(seed)
    spec = ss.SamplerSpec(d, h, n_layers, 0.05, 1e-3, cholesky)
    g = 3 * h

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    w = ss.SamplerWeights(
        w_x=t(d, g, scale=d ** -0.5), w_hh0=t(h, g, scale=h ** -0.5), b_hh0=t(g, scale=0.1),
        w_ih_st=t(n_layers - 1, h, g, scale=h ** -0.5), w_hh_st=t(n_layers - 1, h, g, scale=h ** -0.5),
        b_ih_st=t(n_layers - 1, g, scale=0.1), b_hh_st=t(n_layers - 1, g, scale=0.1),
        w_out=t(h, spec.n_out, scale=0.2), b_out=t(spec.n_out, scale=0.1),
    )
    return spec, w, t(batch, d), t(steps, batch, g), t(steps, batch, d)


def _cluster_plan(spec, cluster, rows=1):
    """The cluster path's plan at ``cluster`` CTAs (as ``make_fwd_plan``
    gives it when asked for that cluster)."""
    smem, floats, uc, nop, slots = ss._cluster_forward_smem(spec, cluster, rows)
    rw = ss._cluster_forward_rw(uc, rows)
    return ss.ForwardPlan(ss.PATH_CLUSTER, cluster, rows, 32 * (uc // 8) * (rows // rw), smem, floats,
                          0, 0, uc, nop, slots, rw)


def model_cluster_forward(spec, plan, packed, layout, x0, gc, eps):
    """K1's cluster kernel step for step, reading each CTA's slice of
    ``packed`` and its row of ``layout`` at the kernel's offsets."""
    d, h, n_layers, cluster, uc, nop, slots = (spec.state_dim, spec.hidden_dim, spec.num_layers, plan.cluster,
                                               plan.uc, plan.nop, plan.slots)
    batch = x0.shape[0]
    lh = n_layers * h
    layer_rows = [(d if l == 0 else h) + h + 2 for l in range(n_layers)]
    ctas = []
    for c in range(cluster):
        buf = packed[c * plan.packed_floats : (c + 1) * plan.packed_floats]
        blocks, off = [], 0
        for rows in layer_rows:  # [rows, uc, 4]: the float4 {r, z, n, 0} of each unit
            blocks.append(buf[off : off + rows * uc * 4].reshape(rows, uc, 4))
            off += rows * uc * 4
        w_oT = buf[off : off + h * nop].reshape(h, nop)
        b_out = buf[off + h * nop : off + h * nop + nop]
        lay = layout[c]
        ctas.append((blocks, w_oT, b_out, lay[:nop], lay[nop : nop + slots], lay[nop + slots : nop + 2 * slots]))
    x = x0.clone()
    hs = torch.zeros(batch, lh)
    paths, raws = [], torch.zeros(gc.shape[0], batch, spec.n_out)
    for t in range(gc.shape[0]):
        new = torch.zeros(batch, lh)
        for l in range(n_layers):
            for c, (blocks, *_) in enumerate(ctas):
                blk = blocks[l]
                n_in = d if l == 0 else h
                inp = x if l == 0 else new[:, (l - 1) * h : l * h]
                gi = torch.einsum("bi,iug->bug", inp, blk[:n_in, :, :3])
                gh = torch.einsum("bi,iug->bug", hs[:, l * h : (l + 1) * h], blk[n_in : n_in + h, :, :3])
                gh = gh + blk[n_in + h + 1, :, :3]
                if l == 0:
                    gi = gi + torch.stack([gc[t][:, g * h + c * uc : g * h + (c + 1) * uc] for g in range(3)], -1)
                else:
                    gi = gi + blk[n_in + h, :, :3]
                r = torch.sigmoid(gi[..., 0] + gh[..., 0])
                z = torch.sigmoid(gi[..., 1] + gh[..., 1])
                n = torch.tanh(gi[..., 2] + r * gh[..., 2])
                cols = slice(l * h + c * uc, l * h + (c + 1) * uc)
                new[:, cols] = (1 - z) * n + z * hs[:, cols]
        h_top = new[:, (n_layers - 1) * h :]
        x_next = x.clone()
        for blocks, w_oT, b_out, ocol, erow, eseg in ctas:
            out = h_top @ w_oT + b_out  # [batch, nop], a column per lane
            for m, o in enumerate(ocol.tolist()):
                if o >= 0:
                    raws[t, :, o] = out[:, m]
            for e, seg in zip(erow.tolist(), eseg.tolist()):
                if e < 0:
                    continue
                if spec.cholesky == "diag":
                    l_eps = torch.clamp(out[:, seg + 1], min=spec.diag_min) * eps[t][:, e]
                else:
                    vals = out[:, seg + 1 : seg + 2 + e].clone()
                    vals[:, e] = torch.clamp(vals[:, e], min=spec.diag_min)
                    l_eps = (vals * eps[t][:, : e + 1]).sum(-1)
                x_next[:, e] = x[:, e] + out[:, seg] * spec.time_step + l_eps * spec.time_step ** 0.5
        x, hs = x_next, new
        paths.append(x)
    return torch.stack(paths), raws


@pytest.mark.parametrize("d,h,n_layers,cholesky,cluster", [
    (32, 64, 2, "full", 4), (32, 64, 2, "full", 2), (5, 16, 3, "full", 2),
    (3, 64, 2, "full", 1), (6, 32, 1, "diag", 4), (2, 96, 2, "full", 4),
    # clusters of 8 and 16, where D < C leaves CTAs without a state entry
    (3, 128, 3, "full", 8), (1, 128, 2, "full", 16), (3, 64, 2, "full", 8), (3, 128, 3, "full", 16),
    (32, 128, 2, "full", 8), (32, 128, 2, "full", 16), (5, 128, 1, "diag", 16),
])
def test_packed_cluster_slices_give_the_plain_forward(d, h, n_layers, cholesky, cluster):
    """Every CTA's slice of the packed weights and its row of the layout,
    read as the kernel reads them, give the plain loop's paths and raw
    outputs: each hidden unit and output column is computed once, in the
    CTA that owns it, also in the CTAs that own no state entry."""
    spec, w, x0, gc, eps = _case(d, h, n_layers, cholesky, 5, 6, d + h + cluster)
    plan = _cluster_plan(spec, cluster)
    packed = ss.pack_forward_weights(spec, w, plan)
    layout = torch.as_tensor(ss.cluster_layout(d, cholesky, cluster))
    paths, raw = model_cluster_forward(spec, plan, packed, layout, x0, gc, eps)
    ref = ss._forward_plain(spec, w, x0, gc, eps, save_h=False)
    for name, got, want in (("paths", paths, ref.paths), ("raw", raw, ref.raw)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()), msg=name)


@pytest.mark.parametrize("d,cholesky,cluster", [(32, "full", 4), (32, "full", 2), (7, "full", 4), (3, "full", 1),
                                                (6, "diag", 4), (1, "full", 1), (3, "full", 8), (1, "full", 16),
                                                (32, "full", 8), (32, "full", 16), (12, "diag", 16),
                                                (20, "full", 8)])
def test_layout_gives_every_output_column_to_one_cta(d, cholesky, cluster):
    """The CTAs' columns cover mu and every tril value once; each entry's
    segment is mu_i then row i of the tril values in order; the entries are
    dealt out in a snake, and the widest CTA sets ``nop`` (a multiple of 32).
    A CTA that owns no entry (D < C) holds only padding: every column, entry
    slot and tril index -1."""
    nop, slots = ss.cluster_columns(d, cholesky, cluster)
    layout = ss.cluster_layout(d, cholesky, cluster)
    n_out = d + (d if cholesky == "diag" else d * (d + 1) // 2)
    cols = layout[:, :nop]
    assert sorted(cols[cols >= 0].tolist()) == list(range(n_out))
    assert nop % 32 == 0 and nop - 32 < max(int((row >= 0).sum()) for row in cols)
    rows, tril_cols = ss.tril_indices(d, cholesky)
    for c in range(cluster):
        entries = [e for e in layout[c, nop : nop + slots] if e >= 0]
        assert entries == [i for i in range(d) if ss.entry_owner(i, cluster) == c]
        mslot = layout[c, nop + 2 * slots : 2 * nop + 2 * slots]
        mj = layout[c, 2 * nop + 2 * slots : 3 * nop + 2 * slots]
        jslot = layout[c, 3 * nop + 2 * slots :]
        for s, (e, seg) in enumerate(zip(entries, layout[c, nop + slots : nop + 2 * slots])):
            assert layout[c, seg] == e and jslot[e] == s and mslot[seg] == s and mj[seg] == -1
            k = [j for j in range(len(rows)) if rows[j] == e]  # row e of the tril table, in order
            assert layout[c, seg + 1 : seg + 1 + len(k)].tolist() == [d + j for j in k]
            assert [int(tril_cols[j]) for j in k] == ([e] if cholesky == "diag" else list(range(e + 1)))
            assert mj[seg + 1 : seg + 1 + len(k)].tolist() == [int(tril_cols[j]) for j in k]
            assert (mslot[seg : seg + 1 + len(k)] == s).all()
        assert (mslot[(cols[c] < 0)] == -1).all() and (mj[(cols[c] < 0)] == -1).all()
        if not entries:
            assert (cols[c] == -1).all() and (layout[c, nop : nop + 2 * slots] == -1).all()
    assert sum(1 for c in range(cluster) if (cols[c] >= 0).any()) == min(d, cluster)


@pytest.mark.parametrize("cholesky", ["full", "diag"])
def test_row_indexed_l_eps_gives_the_tril_table_result(cholesky):
    """L eps summed along each state entry's own tril row (entry i: values
    i(i+1)/2 .. i(i+1)/2 + i times eps[0..i]; diag: value i times eps[i])
    equals the tril-table scatter of the plain loop (``index_add`` over the
    row and column tables)."""
    d, batch = 32, 7
    rng = np.random.default_rng(3)
    rows, cols = ss.tril_indices(d, cholesky)
    vals = torch.from_numpy(rng.standard_normal((batch, len(rows))).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((batch, d)).astype(np.float32))
    table = torch.zeros(batch, d).index_add(1, torch.as_tensor(rows), vals * eps[:, torch.as_tensor(cols)])
    by_row = torch.zeros(batch, d)
    for i in range(d):
        if cholesky == "diag":
            by_row[:, i] = vals[:, i] * eps[:, i]
        else:
            start = i * (i + 1) // 2
            by_row[:, i] = (vals[:, start : start + i + 1] * eps[:, : i + 1]).sum(-1)
    torch.testing.assert_close(by_row, table, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 3, 32])
@pytest.mark.parametrize("h", [16, 64, 128, 256])
@pytest.mark.parametrize("batch", [32, 128, 1024, 4096])
def test_plan_mirror(d, h, batch):
    """``plan_forward`` on an H100: the one-block kernel stages its weights
    wherever they fit a block; else the cluster kernel at the cluster of 2,
    4, 8 or 16 that takes the fewest waves (the smaller on a tie), holding
    every slice within the block's shared memory and at most 768 threads,
    its rows by ``cluster_rows`` and the fewest rows a warp whose warps fit;
    else the one-block kernel streams them (H=256 at L=2), where its work
    buffers fit (not at D=32, H=256 past one row a block, which has no
    plan)."""
    spec = ss.SamplerSpec(d, h, 2, 0.05, 1e-3, "full")
    block_rows = ss.cluster_rows(batch, N_SMS, 4)
    _, staged, streaming, _, _ = ss._block_forward_smem(spec, block_rows)
    if (d, h) == (32, 256) and batch > 132:  # 4 rows of 560 outputs' partials fill no block
        assert streaming > OPTIN
        with pytest.raises(ValueError, match="no plan"):
            ss.plan_forward(spec, batch, N_SMS, OPTIN)
        return
    plan = ss.plan_forward(spec, batch, N_SMS, OPTIN)
    assert plan.smem_bytes <= OPTIN and plan.threads <= 1024
    if staged <= OPTIN:
        assert (plan.path, plan.cluster, plan.rows) == (ss.PATH_STAGED, 1, block_rows)
    elif plan.path == ss.PATH_CLUSTER:
        assert plan.cluster in ss.CLUSTER_SIZES and h % (8 * plan.cluster) == 0
        max_rows = ss._cluster_forward_max_rows(spec, plan.cluster, OPTIN)
        assert plan.rows == ss.cluster_rows(batch, N_SMS // plan.cluster, max_rows)
        groups = h // plan.cluster // 8
        assert plan.uc == h // plan.cluster and plan.rw in (1, 2, 4) and plan.rw <= max(plan.rows, 1)
        assert plan.threads == 32 * groups * (plan.rows // plan.rw) <= ss.CLUSTER_THREADS
        assert plan.rw == 1 or 32 * groups * (2 * plan.rows // plan.rw) > ss.CLUSTER_THREADS
        waves = ss.cluster_waves(batch, N_SMS // plan.cluster, max_rows)
        for other in ss.CLUSTER_SIZES:
            if other != plan.cluster and h % (8 * other) == 0:
                m = ss._cluster_forward_max_rows(spec, other, OPTIN)
                other_waves = ss.cluster_waves(batch, N_SMS // other, m) if m else None
                assert m == 0 or other_waves > waves or (other_waves == waves and other > plan.cluster)
    else:
        assert plan.path == ss.PATH_STREAMING and plan.rows == block_rows
        assert all(ss._cluster_forward_max_rows(spec, c, OPTIN) == 0 for c in ss.CLUSTER_SIZES if h % (8 * c) == 0)


def test_plan_at_the_examples_shapes():
    """The OU and Lorenz shapes stage their weights in one block; the d=32
    microbatch (B=1024) takes clusters of 4 at 32 rows in one wave of 132
    SMs, and B=4096 the same clusters at 44 rows in three waves."""
    def plan(d, batch):
        return ss.plan_forward(ss.SamplerSpec(d, 64, 2, 0.05, 1e-3, "full"), batch, N_SMS, OPTIN)

    assert plan(1, 128).path == ss.PATH_STAGED and plan(3, 32).path == ss.PATH_STAGED
    p = plan(32, 1024)
    assert (p.path, p.cluster, p.rows, p.threads) == (ss.PATH_CLUSTER, 4, 32, 512)
    assert p.cluster * -(-1024 // p.rows) <= N_SMS
    p = plan(32, 4096)
    assert (p.path, p.cluster, p.rows) == (ss.PATH_CLUSTER, 4, 44)
    assert ss.cluster_waves(4096, N_SMS // 4, ss._cluster_forward_max_rows(ss.SamplerSpec(32, 64, 2, 0.05, 1e-3), 4,
                                                                            OPTIN)) == 3
    # an H100 SXM runs 30 clusters of 4 at once (cudaOccupancyMaxActiveClusters),
    # not 33: the rule then takes 36 rows, so that the 29 clusters of B=1024 fit a wave
    p = ss.plan_forward(ss.SamplerSpec(32, 64, 2, 0.05, 1e-3, "full"), 1024, N_SMS, OPTIN, {2: 66, 4: 30})
    assert (p.cluster, p.rows) == (4, 36) and -(-1024 // p.rows) <= 30
    # with the card's slots at every size (15 clusters of 8, 7 of 16), the
    # examples' and the ladder's H=64 shapes keep their plans: path, cluster,
    # rows, threads, shared memory, rows a warp
    def card(d, h, n_layers, batch):
        return ss.plan_forward(ss.SamplerSpec(d, h, n_layers, 0.05, 1e-3, "full"), batch, N_SMS, OPTIN, CARD_SLOTS)

    kept = {(1, 64, 2, 128): (ss.PATH_STAGED, 1, 1, 288, 204976, 0),     # OU
            (3, 64, 2, 32): (ss.PATH_STAGED, 1, 1, 288, 209408, 0),      # Lorenz-63
            (2, 64, 2, 64): (ss.PATH_STAGED, 1, 1, 288, 207024, 0),      # SIR
            (2, 64, 2, 24): (ss.PATH_STAGED, 1, 1, 288, 207024, 0),      # LV
            (32, 64, 2, 1024): (ss.PATH_CLUSTER, 4, 36, 576, 189504, 4),  # the [dp] microbatch
            (32, 64, 2, 4096): (ss.PATH_CLUSTER, 4, 48, 768, 218688, 4)}  # highdim_ou_dp on one card
    for shape, want in kept.items():
        p = card(*shape)
        assert (p.path, p.cluster, p.rows, p.threads, p.smem_bytes, p.rw) == want, shape


def test_plan_at_the_ladder_h128_rungs():
    """The ladder's 128-wide heads take clusters of 8 (the fewest waves; 16
    ties and loses to the smaller): Lorenz r3 (128 x 3, B=32) 4 rows a
    cluster, its 8 clusters one wave of the card's 15, a warp a row (256
    threads); highdim r5 (128 x 2, D=32, B=512) 20 rows, two waves, 2 rows a
    warp (640 threads)."""
    r3 = ss.plan_forward(ss.SamplerSpec(3, 128, 3, 0.01, 1e-3, "full"), 32, N_SMS, OPTIN, CARD_SLOTS)
    assert (r3.path, r3.cluster, r3.rows, r3.threads, r3.rw, r3.uc) == (ss.PATH_CLUSTER, 8, 4, 256, 1, 16)
    assert r3.slots == 1 and ss.cluster_columns(3, "full", 8) == (32, 1)  # five CTAs own no entry
    h5 = ss.plan_forward(ss.SamplerSpec(32, 128, 2, 0.05, 1e-3, "full"), 512, N_SMS, OPTIN, CARD_SLOTS)
    assert (h5.path, h5.cluster, h5.rows, h5.threads, h5.rw) == (ss.PATH_CLUSTER, 8, 20, 640, 2)
    assert ss.cluster_waves(512, CARD_SLOTS[8], ss._cluster_forward_max_rows(
        ss.SamplerSpec(32, 128, 2, 0.05, 1e-3, "full"), 8, OPTIN)) == 2


@pytest.mark.parametrize("batch,per_wave,max_rows,want", [
    (1024, 33, 52, 32), (4096, 33, 52, 44), (1024, 66, 8, 8), (32, 66, 8, 1), (66, 66, 8, 1), (67, 66, 8, 2),
    (133, 132, 4, 2), (5000, 132, 4, 4), (34, 33, 52, 2), (200, 33, 52, 8), (1024, 30, 52, 36),
    (4096, 30, 48, 48),
])
def test_cluster_rows(batch, per_wave, max_rows, want):
    """The fewest rows (1, 2, 4, then multiples of 4) that keep the clusters
    in one wave of the ``per_wave`` the card runs at once; past
    ``max_rows``, the fewest waves with the rows spread evenly."""
    rows = ss.cluster_rows(batch, per_wave, max_rows)
    assert rows == want
    waves = ss.cluster_waves(batch, per_wave, max_rows)
    assert -(-batch // rows) <= waves * per_wave


def _cluster_bwd_plan(spec, cluster, rows=1):
    smem, floats, uc, nop, slots = ss._cluster_backward_smem(spec, cluster, rows)
    return ss.BackwardPlan(ss.PATH_CLUSTER, cluster, rows, 128, smem, floats, 0, 0, uc, nop, slots, min(rows, 4))


def model_cluster_backward(spec, plan, packed, layout, w, x0, gc, eps, fwd, d_paths, d_means, d_cholv):
    """K2's cluster BPTT step for step: each CTA's parts of every transposed
    product from its slice of ``packed`` (its units' gate columns, its
    output columns), added by the owners in CTA order, as
    ``bptt_cluster_kernel`` adds them (the gates recomputed from ``w`` and
    the stash, as the gate pass does); returns d_gc, d_eps, d_x0."""
    d, h, n_layers, cluster, uc, nop, slots = (spec.state_dim, spec.hidden_dim, spec.num_layers, plan.cluster,
                                               plan.uc, plan.nop, plan.slots)
    dt, sqrt_dt, diag = spec.time_step, spec.time_step ** 0.5, spec.cholesky == "diag"
    steps, batch = gc.shape[:2]
    n_in = [h + (d if l == 0 else h) for l in range(n_layers)]
    ctas = []
    for c in range(cluster):
        buf = packed[c * plan.packed_floats : (c + 1) * plan.packed_floats]
        blocks, off = [], 0
        for cols in n_in:  # [uc, H + in, 4]
            blocks.append(buf[off : off + uc * cols * 4].reshape(uc, cols, 4))
            off += uc * cols * 4
        lay = layout[c]
        ctas.append(dict(blocks=blocks, w_o=buf[off : off + nop * h].reshape(nop, h), ocol=lay[:nop],
                         erow=lay[nop : nop + slots], eseg=lay[nop + slots : nop + 2 * slots],
                         mslot=lay[nop + 2 * slots : 2 * nop + 2 * slots],
                         mj=lay[2 * nop + 2 * slots : 3 * nop + 2 * slots]))
    # the gate pass: r, z, n, n_hh of every step and layer from the stash
    h_all = fwd.h_all
    x_in = torch.cat([x0[None], fwd.paths[:-1]])
    h_prev = torch.cat([torch.zeros_like(h_all[:1]), h_all[:-1]])
    w_hh, b_hh = [w.w_hh0, *w.w_hh_st], [w.b_hh0, *w.b_hh_st]
    dx = torch.zeros(batch, d)
    dh = torch.zeros(n_layers, batch, h)
    d_gc, d_eps = torch.zeros_like(gc), torch.zeros_like(eps)
    for t in range(steps - 1, -1, -1):
        dxn = d_paths[t] + dx
        raw = fwd.raw[t]
        # output phase: d_out of each CTA's columns, its parts of d_eps and of dL/dh_top
        p_eps = torch.zeros(cluster, batch, d)
        p_fa = torch.zeros(cluster, batch, h)
        for c, k in enumerate(ctas):
            dout = torch.zeros(batch, nop)
            for m, o in enumerate(k["ocol"].tolist()):
                if o < 0:
                    continue
                e = int(k["erow"][k["mslot"][m]])
                if o < d:
                    dout[:, m] = d_means[t][:, o] + dxn[:, e] * dt
                else:
                    j = int(k["mj"][m])
                    dv = d_cholv[t][:, o - d] + dxn[:, e] * eps[t][:, j] * sqrt_dt
                    if e == j:
                        dv = torch.where((raw[:, o] >= spec.diag_min) | (dv < 0), dv, torch.zeros_like(dv))
                    dout[:, m] = dv
            for j in range(d):
                for s, e in enumerate(k["erow"].tolist()):
                    if e < 0 or (e != j if diag else e < j):
                        continue
                    v = raw[:, k["ocol"][k["eseg"][s] + 1 + (0 if diag else j)]]
                    if e == j:
                        v = torch.clamp(v, min=spec.diag_min)
                    p_eps[c, :, j] += dxn[:, e] * v
            p_fa[c] = dout @ k["w_o"]
        d_eps[t] = p_eps.sum(0) * sqrt_dt
        dfa = p_fa.sum(0)
        for l in range(n_layers - 1, -1, -1):
            if l == 0:
                gi = gc[t] + x_in[t] @ w.w_x
            else:
                gi = h_all[t][:, (l - 1) * h : l * h] @ w.w_ih_st[l - 1] + w.b_ih_st[l - 1]
            gh = h_prev[t][:, l * h : (l + 1) * h] @ w_hh[l] + b_hh[l]
            r = torch.sigmoid(gi[:, :h] + gh[:, :h])
            z = torch.sigmoid(gi[:, h : 2 * h] + gh[:, h : 2 * h])
            n = torch.tanh(gi[:, 2 * h :] + r * gh[:, 2 * h :])
            d_h = dh[l] + dfa
            da_n = d_h * (1 - z) * (1 - n * n)
            da_r = da_n * gh[:, 2 * h :] * r * (1 - r)
            da_z = d_h * (h_prev[t][:, l * h : (l + 1) * h] - n) * z * (1 - z)
            if l == 0:
                d_gc[t] = torch.cat([da_r, da_z, da_n], -1)
            p_dh = torch.zeros(cluster, batch, h)
            p_down = torch.zeros(cluster, batch, n_in[l] - h)
            for c, k in enumerate(ctas):
                us = slice(c * uc, (c + 1) * uc)
                blk = k["blocks"][l]  # [uc, H + in, 4]
                g_h = torch.stack([da_r[:, us], da_z[:, us], da_n[:, us] * r[:, us]], -1)  # d_gh of its units
                g_i = torch.stack([da_r[:, us], da_z[:, us], da_n[:, us]], -1)
                p_dh[c] = torch.einsum("bug,uig->bi", g_h, blk[:, :h, :3])
                p_down[c] = torch.einsum("bug,uig->bi", g_i, blk[:, h:, :3])
            dh[l] = d_h * z + p_dh.sum(0)
            if l == 0:
                dx = dxn + p_down.sum(0)
            else:
                dfa = p_down.sum(0)
    return d_gc, d_eps, dx


@pytest.mark.parametrize("d,h,n_layers,cholesky,cluster", [
    (32, 64, 2, "full", 4), (5, 16, 3, "full", 2), (3, 64, 2, "full", 1), (6, 32, 1, "diag", 4),
    # clusters of 8 and 16, where D < C leaves CTAs without a state entry
    (3, 128, 3, "full", 8), (1, 128, 2, "full", 16), (3, 64, 2, "full", 8), (32, 128, 2, "full", 16),
    (3, 128, 3, "full", 16), (5, 128, 1, "diag", 16),
])
def test_packed_cluster_bptt_slices_give_the_plain_backward(d, h, n_layers, cholesky, cluster):
    """Every CTA's packed slice of the transposed products (its units' rows
    of W_hh and W_x / W_ih, its columns of W_out) and its row of the layout,
    read as ``bptt_cluster_kernel`` reads them, with each product summed as
    the C CTAs' parts (a CTA without a state entry adds zero parts of
    d_eps and d_x), give the plain backward's d_gates_const, d_eps and
    d_x0."""
    spec, w, x0, gc, eps = _case(d, h, n_layers, cholesky, 4, 5, 7 * d + h + cluster)
    rng = np.random.default_rng(11)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((5, 4, d), (5, 4, d), (5, 4, spec.n_tril))]
    fwd = ss._forward_plain(spec, w, x0, gc, eps, save_h=True)
    plan = _cluster_bwd_plan(spec, cluster)
    packed = ss.pack_bptt_weights(spec, w, plan)
    layout = torch.as_tensor(ss.cluster_layout(d, cholesky, cluster))
    got = model_cluster_backward(spec, plan, packed, layout, w, x0, gc, eps, fwd, *cot)
    ref = ss._backward_plain(spec, w, x0, gc, eps, fwd, *cot)
    for name, g, want in zip(("d_gc", "d_eps", "d_x0"), got, (ref.d_gc, ref.d_eps, ref.d_x0)):
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()), msg=name)


@pytest.mark.parametrize("d", [1, 3, 32])
@pytest.mark.parametrize("h", [16, 64, 128, 256])
@pytest.mark.parametrize("batch", [32, 1024, 4096])
def test_backward_plan_mirror(d, h, batch):
    """``plan_backward`` on an H100, by K1's rule: staged in one block where
    the matrices fit, else clusters of 2, 4, 8 or 16 in the fewest waves
    (the smaller on a tie) within the shared memory, each task of a layer's
    products a warp of its own where the threads allow, else streaming."""
    spec = ss.SamplerSpec(d, h, 2, 0.05, 1e-3, "full")
    block_rows = ss.cluster_rows(batch, N_SMS, 4)
    _, staged, streaming, _, _, _ = ss._block_backward_smem(spec, block_rows)
    if staged > OPTIN and streaming > OPTIN and all(
            ss._cluster_backward_max_rows(spec, c, OPTIN) == 0 for c in ss.CLUSTER_SIZES if h % (8 * c) == 0):
        with pytest.raises(ValueError, match="no plan"):
            ss.plan_backward(spec, batch, N_SMS, OPTIN)
        return
    plan = ss.plan_backward(spec, batch, N_SMS, OPTIN)
    assert plan.smem_bytes <= OPTIN and plan.threads <= 1024
    if staged <= OPTIN:
        assert (plan.path, plan.rows) == (ss.PATH_STAGED, block_rows)
    elif plan.path == ss.PATH_CLUSTER:
        assert plan.cluster in ss.CLUSTER_SIZES
        max_rows = ss._cluster_backward_max_rows(spec, plan.cluster, OPTIN)
        assert plan.rows == ss.cluster_rows(batch, N_SMS // plan.cluster, max_rows)
        assert plan.threads <= ss.CLUSTER_THREADS and plan.uc * plan.cluster == h
        assert plan.threads >= ss._cluster_backward_threads(plan.rows, plan.uc)
        tasks = -(-(h + max(d, h)) // 32) * (plan.rows // plan.rw)  # a layer's product tasks, at most
        assert 32 * tasks <= plan.threads or plan.rw == min(plan.rows, 4)
        assert plan.threads >= min(ss.CLUSTER_THREADS, 32 * -(-tasks // ss.BPTT_TASKS_PER_WARP))
        waves = ss.cluster_waves(batch, N_SMS // plan.cluster, max_rows)
        for other in ss.CLUSTER_SIZES:
            m = ss._cluster_backward_max_rows(spec, other, OPTIN) if h % (8 * other) == 0 else 0
            if other != plan.cluster and m:
                other_waves = ss.cluster_waves(batch, N_SMS // other, m)
                assert other_waves > waves or (other_waves == waves and other > plan.cluster)
    else:
        assert plan.path == ss.PATH_STREAMING


def test_backward_plan_at_the_examples_shapes():
    """OU and Lorenz keep the staged one-block BPTT; the d=32 shapes take
    clusters of 4 at 32 rows (one wave at B=1024)."""
    def plan(d, batch):
        return ss.plan_backward(ss.SamplerSpec(d, 64, 2, 0.05, 1e-3, "full"), batch, N_SMS, OPTIN)

    assert plan(1, 128).path == ss.PATH_STAGED and plan(3, 32).path == ss.PATH_STAGED
    assert (plan(32, 1024).path, plan(32, 1024).cluster, plan(32, 1024).rows) == (ss.PATH_CLUSTER, 4, 32)
    assert (plan(32, 4096).cluster, plan(32, 4096).rows) == (4, 32)

    def card(d, h, n_layers, batch):
        return ss.plan_backward(ss.SamplerSpec(d, h, n_layers, 0.05, 1e-3, "full"), batch, N_SMS, OPTIN, CARD_SLOTS)

    kept = {(1, 64, 2, 128): (ss.PATH_STAGED, 1, 1, 512, 168004, 0),     # OU
            (3, 64, 2, 32): (ss.PATH_STAGED, 1, 1, 512, 170016, 0),      # Lorenz-63
            (2, 64, 2, 64): (ss.PATH_STAGED, 1, 1, 512, 168868, 0),      # SIR
            (2, 64, 2, 24): (ss.PATH_STAGED, 1, 1, 512, 168868, 0),      # LV
            (32, 64, 2, 1024): (ss.PATH_CLUSTER, 4, 36, 576, 216768, 4),  # the [dp] microbatch
            (32, 64, 2, 4096): (ss.PATH_CLUSTER, 4, 36, 576, 216768, 4)}  # highdim_ou_dp on one card
    for shape, want in kept.items():
        p = card(*shape)
        assert (p.path, p.cluster, p.rows, p.threads, p.smem_bytes, p.rw) == want, shape


def test_backward_plan_at_the_ladder_h128_rungs():
    """K2's BPTT at the ladder's 128-wide heads: Lorenz r3 on clusters of 8
    at 4 rows, 2 rows a warp so that each of a layer's 16 product tasks has
    a warp (512 threads); highdim r5 on clusters of 16 at 40 rows (two
    waves of the card's 7, where clusters of 8 take three), 4 rows a warp
    and 768 threads: its 80 product tasks a layer outnumber any CTA's warps,
    so as many warps as two tasks each would take, at most 768 threads."""
    r3 = ss.plan_backward(ss.SamplerSpec(3, 128, 3, 0.01, 1e-3, "full"), 32, N_SMS, OPTIN, CARD_SLOTS)
    assert (r3.path, r3.cluster, r3.rows, r3.threads, r3.rw) == (ss.PATH_CLUSTER, 8, 4, 512, 2)
    spec = ss.SamplerSpec(32, 128, 2, 0.05, 1e-3, "full")
    h5 = ss.plan_backward(spec, 512, N_SMS, OPTIN, CARD_SLOTS)
    assert (h5.path, h5.cluster, h5.rows, h5.threads, h5.rw) == (ss.PATH_CLUSTER, 16, 40, 768, 4)
    assert [ss.cluster_waves(512, CARD_SLOTS[c], ss._cluster_backward_max_rows(spec, c, OPTIN))
            for c in (8, 16)] == [3, 2]


@pytest.mark.parametrize("uc,rows,want", [(16, 4, 1), (8, 4, 1), (16, 20, 2), (8, 48, 2), (16, 36, 4), (16, 48, 4),
                                          (16, 1, 1), (16, 2, 1), (32, 24, 4), (64, 4, 2)])
def test_rows_a_warp(uc, rows, want):
    """K1's cluster path carries the fewest rows a warp (1, 2 or 4) whose
    warps fit 768 threads: a step's rows over as many warps as a CTA holds."""
    assert ss._cluster_forward_rw(uc, rows) == want
    assert 32 * (uc // 8) * (rows // want) <= ss.CLUSTER_THREADS or want == 4
