"""Resource dynamics: global, spatial, gradient and deme pools.

Counterpart of avida_tpu/ops/resources.py (cResourceCount,
cSpatialResCount, cGradientCount, the cDeme resource slice;
cEnvironment::DoProcesses cc:1610 for consumption):

  step_global    level' = max(level + inflow - outflow * level, 0)
  step_spatial   the inflow box, the outflow, then ceil(max(xd + yd))
                 explicit 3x3 stencil sub-steps, wrapped on a torus and
                 zero-flux on a grid
  step_gradient  the moving-peak cone, its draws in the reference's order
  step_deme      (level + inflow) * (1 - outflow), not clamped at 0
  consume        a cycle's draw-down of global and spatial pools, demands
                 scaled proportionally when they exceed the level
  consume_deme   the same contention rule inside each deme band

Float arithmetic follows the reference's compiled program on XLA's CPU
backend: its float32 totals in the tree-reduction order
(prng.xla_f32_sum), its sums over reactions in reaction order, and a
fused multiply-add where that backend contracts one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from avida_tpu_torch.ops.cycles import params_cached
from avida_tpu_torch.utils import prng

_F32 = torch.float32


def has_pools(params) -> bool:
    """Does the world hold any resource pool (global, spatial, gradient
    or deme)?"""
    return bool(params.num_global_res or params.num_spatial_res
                or params.num_deme_res or any(params.sres_grad_height))


def binds_pools(params) -> bool:
    """Does a reaction draw on a pool or produce into one (so the
    micro-step engine's IO block carries the pools)?"""
    return bool(any(r >= 0 for r in params.proc_res_idx)
                or any(pi >= 0 for pi in params.proc_product_idx)
                or params.num_deme_res)


def _t(vals, device, dtype=_F32):
    return torch.tensor(vals, dtype=dtype, device=device)


def step_global(params, resources):
    """One update of inflow and outflow for the global pools (the closed
    form of cResourceCount::DoUpdates)."""
    if params.num_global_res == 0:
        return resources
    dev = resources.device
    inflow = _t(params.res_inflow, dev)
    outflow = _t(params.res_outflow, dev)
    # XLA's CPU backend contracts the outflow product into the subtract
    level = prng.fma_f32(-outflow, resources, resources + inflow)
    return level.clamp(min=0.0)


def step_deme(params, deme_resources):
    """Per-deme pool inflow and outflow (no clamp at 0, as the
    reference)."""
    if params.num_deme_res == 0:
        return deme_resources
    dev = deme_resources.device
    inflow = _t(params.dres_inflow, dev)[None, :]
    keep = 1.0 - _t(params.dres_outflow, dev)[None, :]
    return (deme_resources + inflow) * keep


def _spatial_tables(params, device):
    """step_spatial's static tables: the inflow box's per-cell inflow
    [R, Y, X], the keep factor 1 - outflow, the stencil coefficients and
    the torus flags, and the number of sub-steps."""
    R = params.num_spatial_res
    X, Y = params.world_x, params.world_y
    box = np.asarray(params.sres_inflow_box, np.int64).reshape(R, 4)
    xs = np.arange(X)[None, None, :]
    ys = np.arange(Y)[None, :, None]
    x1 = np.where(box[:, 0] < 0, 0, box[:, 0])
    x2 = np.where(box[:, 1] < 0, X - 1, box[:, 1])
    y1 = np.where(box[:, 2] < 0, 0, box[:, 2])
    y2 = np.where(box[:, 3] < 0, Y - 1, box[:, 3])
    in_box = ((xs >= x1[:, None, None]) & (xs <= x2[:, None, None])
              & (ys >= y1[:, None, None]) & (ys <= y2[:, None, None]))
    box_cells = np.maximum(in_box.sum(axis=(1, 2)), 1)
    inflow = _t(params.sres_inflow, device)
    per_cell = inflow / _t(box_cells.tolist(), device)
    add = torch.where(torch.from_numpy(in_box).to(device),
                      per_cell[:, None, None], 0.0)
    max_rate = max(float(x) + float(y) for x, y in
                   zip(params.sres_xdiffuse, params.sres_ydiffuse))
    nsub = max(int(math.ceil(max_rate)), 1)
    cx = (0.5 * _t(params.sres_xdiffuse, device) / nsub).clamp(min=0.0)
    cy = (0.5 * _t(params.sres_ydiffuse, device) / nsub).clamp(min=0.0)
    return {
        "add": add,
        "keep": (1.0 - _t(params.sres_outflow, device))[:, None, None],
        "cx": cx[:, None, None], "cy": cy[:, None, None],
        "torus": _t(params.sres_torus, device, torch.bool)[:, None, None],
        "nsub": nsub,
    }


_SPATIAL = {}          # params_cached store


def _neighbors(g, wrap: bool):
    """(left, right, up, down) of every cell of g [R, Y, X]: wrapped, or
    with the edge cell repeated (zero flux)."""
    if wrap:
        return (torch.roll(g, 1, 2), torch.roll(g, -1, 2),
                torch.roll(g, 1, 1), torch.roll(g, -1, 1))
    return (torch.cat([g[:, :, :1], g[:, :, :-1]], 2),
            torch.cat([g[:, :, 1:], g[:, :, -1:]], 2),
            torch.cat([g[:, :1, :], g[:, :-1, :]], 1),
            torch.cat([g[:, 1:, :], g[:, -1:, :]], 1))


def step_spatial(params, res_grid):
    """One update of the spatial pools res_grid [R, N]: inflow box,
    outflow, diffusion (ref cSpatialResCount::FlowAll cc:316)."""
    if params.num_spatial_res == 0:
        return res_grid
    T = params_cached(_SPATIAL, params, res_grid.device, _spatial_tables)
    R, X, Y = params.num_spatial_res, params.world_x, params.world_y
    x = res_grid.reshape(R, Y, X) + T["add"]
    g = x * T["keep"]
    w = T["torus"]
    # g + cx (l + r - 2g) + cy (u + d - 2g) as XLA's CPU backend compiles
    # it in the update (read off its LLVM IR; 2g is exact, so its
    # subtract rounds once either way): both products contracted into
    # the adds.  The first sub-step differs in two cases.  With one
    # spatial pool the outflow factor is a scalar constant, XLA folds
    # (x * keep) * 2 into x * (2 keep), and x * keep becomes the product
    # contracted into the center term, unrounded.  With one sub-step and
    # one geometry for every pool the neighbors' products sit in the
    # stencil's fusion, and one of each pair is contracted into the
    # neighbor sum: the right one, and the lower one -- the upper one on
    # a torus with one pool.
    single = R == 1
    for s in range(T["nsub"]):
        lt, rt, ut, dt = _neighbors(g, True)
        lb, rb, ub, db = _neighbors(g, False)
        left, right = torch.where(w, lt, lb), torch.where(w, rt, rb)
        up, down = torch.where(w, ut, ub), torch.where(w, dt, db)
        if s == 0 and T["nsub"] == 1 and len(set(params.sres_torus)) == 1:
            torus = bool(params.sres_torus[0])
            _, xr, xu, xd = _neighbors(x, torus)
            lr = prng.fma_f32(xr, T["keep"], left)
            ud = (prng.fma_f32(xu, T["keep"], down) if torus and single
                  else prng.fma_f32(xd, T["keep"], up))
        else:
            lr, ud = left + right, up + down
        a = lr - 2.0 * g
        if s == 0 and single:
            t = prng.fma_f32(x, T["keep"], T["cx"] * a)
        else:
            t = prng.fma_f32(T["cx"], a, g)
        g = prng.fma_f32(T["cy"], ud - 2.0 * g, t)
    return g.clamp(min=0.0).reshape(R, Y * X)


def step_gradient(params, st, key, update_no):
    """Moving-peak gradient pools (cGradientCount::UpdateCount): each
    row's cone height / (dist + 1) within `spread` of the peak (the
    plateau value where the cone reaches 1, when set), the peak placed
    on first use and moved by a random step every `updatestep`
    updates."""
    if not any(params.sres_grad_height):
        return st
    X, Y = params.world_x, params.world_y
    dev = st.res_grid.device
    cells = torch.arange(params.num_cells, device=dev)
    cx, cy = cells % X, cells // X
    res_grid = st.res_grid.clone()
    grad_peak = st.grad_peak.clone()
    for r, h in enumerate(params.sres_grad_height):
        if not h:
            continue
        spread = params.sres_grad_spread[r]
        plateau = params.sres_grad_plateau[r]
        ks = prng.split(prng.fold_in(key, r))
        k_init, k_move = ks[0], ks[1]
        px, py = grad_peak[r, 0], grad_peak[r, 1]
        unset = px < 0
        cfg_px, cfg_py = params.sres_grad_peakx[r], params.sres_grad_peaky[r]
        init_px = (torch.tensor(cfg_px, dtype=torch.int32, device=dev)
                   if cfg_px >= 0 else prng.randint(
                       k_init, (), min(spread, X // 2),
                       max(X - spread, X // 2 + 1)))
        init_py = (torch.tensor(cfg_py, dtype=torch.int32, device=dev)
                   if cfg_py >= 0 else prng.randint(
                       prng.fold_in(k_init, 1), (), min(spread, Y // 2),
                       max(Y - spread, Y // 2 + 1)))
        px = torch.where(unset, init_px, px)
        py = torch.where(unset, init_py, py)
        if params.sres_grad_move[r]:
            ustep = max(params.sres_grad_updatestep[r], 1)
            step_due = int(update_no) % ustep == 0
            dx = prng.randint(k_move, (), -1, 2)
            dy = prng.randint(prng.fold_in(k_move, 1), (), -1, 2)
            if step_due:
                px = (px + dx).clamp(0, X - 1)
                py = (py + dy).clamp(0, Y - 1)
            else:
                px, py = px.clamp(0, X - 1), py.clamp(0, Y - 1)
        d2 = (cx - px) ** 2 + (cy - py) ** 2
        dist = prng.sqrt_f32(d2.to(_F32))
        # a tensor numerator: torch computes `number / tensor` as a
        # reciprocal times the number, rounding twice
        cone = torch.full_like(dist, prng.round_f32(h)) / (dist + 1.0)
        if plateau >= 0:
            cone = torch.where(cone >= 1.0, prng.round_f32(plateau), cone)
        cone = torch.where(dist <= spread, cone, 0.0)
        res_grid[r] = cone
        grad_peak[r, 0] = px
        grad_peak[r, 1] = py
    return st.replace(res_grid=res_grid, grad_peak=grad_peak)


def _onehot(n_pools: int, res_idx, extra=None):
    """bool[n_pools, NR]: reaction r's index is g (and `extra[r]`)."""
    oh = np.arange(n_pools)[:, None] == np.asarray(res_idx)[None, :]
    if extra is not None:
        oh = oh & np.asarray(extra, bool)[None, :]
    return oh


def _by_pool(cols, onehot, form=0):
    """[..., G]: for each pool g, the sum of the columns cols[..., r] of
    its reactions (the reference's einsum over the reaction axis, whose
    other terms are exact zeros): 0 + each in reaction order, or with a
    `form` of tasks.vector_fold (TREE, one_acc) in the compiled IO
    block's order, the form it takes with pools beside processes bound
    to none."""
    from avida_tpu_torch.ops.tasks import vector_fold
    out = []
    for row in onehot:
        if form == DOT4:
            out.append(_dot4_sum([cols[..., r] if row[r] else None
                                  for r in range(cols.shape[-1])]))
            continue
        if form:
            zero = torch.zeros(cols.shape[:-1], dtype=_F32,
                               device=cols.device)
            out.append(vector_fold(
                [cols[..., r] if row[r] else zero
                 for r in range(cols.shape[-1])], torch.add, 0.0, form))
            continue
        acc = torch.zeros(cols.shape[:-1], dtype=_F32, device=cols.device)
        for r in np.nonzero(row)[0]:
            acc = acc + cols[..., int(r)]
        out.append(acc)
    return torch.stack(out, dim=-1)


# _by_pool's form for the CPU backend's dot: from 24 reactions, with pools
# beside processes bound to none, the compiled IO block takes the spatial
# sums out of its fused loop into a dot (the reference's einsum over the
# reaction axis), which sums each output's reactions in 4-lane vectors
# through one accumulator, adds the 4 lanes pairwise ((l0 + l1) + (l2 +
# l3)), then the reactions past the last full vector in order
DOT4 = "dot4"


def _dot4_sum(cols):
    """The dot's sum over `cols` (None = a reaction of another pool, an
    exact zero)."""
    lanes = [None] * 4
    full = len(cols) // 4 * 4
    for r in range(full):
        c = cols[r]
        if c is not None:
            j = r % 4
            lanes[j] = c if lanes[j] is None else lanes[j] + c
    like = next(c for c in cols if c is not None)
    lanes = [torch.zeros_like(like) if v is None else v for v in lanes]
    acc = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    for c in cols[full:]:
        if c is not None:
            acc = acc + c
    return acc


def _to_reactions(per_pool, onehot):
    """[..., NR]: each reaction's pool value (0 where no pool binds
    it), the reference's einsum with a one-hot (every term but one is
    0)."""
    sel = [np.nonzero(onehot[:, r])[0] for r in range(onehot.shape[1])]
    cols = []
    for s in sel:
        if len(s):
            cols.append(per_pool[..., int(s[0])])
        else:
            cols.append(torch.zeros(per_pool.shape[:-1], dtype=_F32,
                                    device=per_pool.device))
    return torch.stack(cols, dim=-1)


def _consume_tables(params, device):
    """consume's and consume_deme's static tables."""
    res_idx = np.asarray(params.proc_res_idx, np.int64)
    spatial = np.asarray(params.proc_res_spatial, bool)
    depl = np.asarray(params.proc_depletable, bool)
    NR = res_idx.shape[0]
    is_deme = (np.asarray(params.proc_res_deme, bool)
               if params.num_deme_res else np.zeros(NR, bool))
    infinite = res_idx < 0
    return {
        "infinite": _t(infinite, device, torch.bool),
        "spatial": _t(spatial, device, torch.bool),
        "depletable": _t(depl, device, torch.bool),
        "is_deme": _t(is_deme, device, torch.bool),
        "gidx": _t(np.clip(res_idx, 0, max(params.num_global_res - 1, 0)),
                   device, torch.int64),
        "sidx": _t(np.clip(res_idx, 0, max(params.num_spatial_res - 1, 0)),
                   device, torch.int64),
        "didx": _t(np.clip(res_idx, 0, max(params.num_deme_res - 1, 0)),
                   device, torch.int64),
        "max": _t(params.proc_max, device),
        "frac": _t(params.proc_frac, device),
        "oh_g": _onehot(params.num_global_res, res_idx),
        "oh_s": _onehot(params.num_spatial_res, res_idx),
        "oh_d": _onehot(params.num_deme_res, res_idx, is_deme),
        # the order of the spatial demands' and draws' sums (pools
        # beside processes bound to none: the IO block's tree, the dot)
        "form": _spatial_sum_form(params),
        # the reactions each one-hot maps back to their pool's value
        "g_unscaled": _t(infinite | spatial | ~depl, device, torch.bool),
        "s_unscaled": _t(infinite | ~spatial | ~depl, device, torch.bool),
    }


def _spatial_sum_form(params) -> int | str:
    """The order of the spatial demand and draw sums over the reactions
    where pools sit beside processes bound to none: the IO block's tree
    (TREE) up to 23 reactions, the dot's (DOT4) from 24; else in order
    (0)."""
    from avida_tpu_torch.ops.tasks import TREE, vector_chunks
    form = vector_chunks(params)["add"]
    if form < TREE:
        return DOT4
    return form if form < 0 else 0


_CONSUME = {}          # params_cached store


def consume_tables(params, device) -> dict:
    return params_cached(_CONSUME, params, device, _consume_tables)


def _scale(demand, level):
    """Per-pool scale of the demands: level / demand where the demand
    exceeds the level, else 1."""
    return torch.where(demand > level, level / demand.clamp(min=1e-30), 1.0)


def consume(params, rewarded, task_quality, resources, res_grid):
    """This cycle's draw-down of global and spatial pools by the rewarded
    reactions rewarded [N, NR].  Returns (amount [N, NR], resources',
    res_grid').  Each process takes min(level * frac, max) of its pool
    (max outright when infinite); demands on one pool that exceed its
    level are scaled proportionally (per cell for spatial pools); only
    depletable processes draw down and contend."""
    T = consume_tables(params, rewarded.device)
    inf, spatial, depl = T["infinite"], T["spatial"], T["depletable"]
    rw = rewarded.to(_F32) * task_quality
    if params.num_deme_res:
        rw = torch.where(T["is_deme"][None, :], 0.0, rw)
    NR = rewarded.shape[1]
    dev = rewarded.device
    if params.num_global_res:
        avail_g = resources[T["gidx"]][None, :]
    else:
        avail_g = torch.zeros((1, NR), dtype=_F32, device=dev)
    if params.num_spatial_res:
        avail_s = res_grid[T["sidx"], :].T
    else:
        avail_s = torch.zeros((1, NR), dtype=_F32, device=dev)
    avail = torch.where(inf[None, :], float("inf"),
                        torch.where(spatial[None, :], avail_s, avail_g))
    wanted = torch.minimum(avail * T["frac"][None, :],
                           T["max"][None, :]) * rw
    wanted = torch.where(inf[None, :], T["max"][None, :] * rw, wanted)

    if params.num_global_res:
        oh = T["oh_g"]
        is_g = (~inf & ~spatial)[None, :]
        want_g = torch.where(is_g, wanted, 0.0)
        want_depl = torch.where(depl[None, :], want_g, 0.0)
        demand = _by_pool(prng.xla_f32_sum(want_depl), oh)
        scale_rxn = _to_reactions(_scale(demand, resources), oh)
        scale_rxn = torch.where(T["g_unscaled"], 1.0, scale_rxn)
        got_g = want_g * scale_rxn[None, :]
        drawn = _by_pool(prng.xla_f32_sum(
            torch.where(is_g & depl[None, :], got_g, 0.0)), oh)
        resources = (resources - drawn).clamp(min=0.0)
    else:
        got_g = torch.zeros_like(wanted)

    if params.num_spatial_res:
        oh = T["oh_s"]
        is_s = (~inf & spatial)[None, :]
        want_s = torch.where(is_s, wanted, 0.0)
        want_depl = torch.where(depl[None, :], want_s, 0.0)
        demand_s = _by_pool(want_depl, oh, T["form"]).T           # [Rs, N]
        scale_nr = _to_reactions(_scale(demand_s, res_grid).T, oh)
        scale_nr = torch.where(T["s_unscaled"][None, :], 1.0, scale_nr)
        got_s = want_s * scale_nr
        drawn_s = _by_pool(torch.where(is_s & depl[None, :], got_s, 0.0),
                           oh, T["form"]).T
        res_grid = (res_grid - drawn_s).clamp(min=0.0)
    else:
        got_s = torch.zeros_like(wanted)

    amount = torch.where(inf[None, :], wanted,
                         torch.where(spatial[None, :], got_s, got_g))
    return amount, resources, res_grid


def consume_deme(params, rewarded, deme_resources):
    """Draw-down of deme-bound reactions' pools: consume's contention
    rule applied inside each deme band (deme d = cells [d*cpd,
    (d+1)*cpd)).  Returns (amount [N, NR], 0 outside deme-bound
    reactions; deme_resources' [D, Rd])."""
    T = consume_tables(params, rewarded.device)
    n, NR = rewarded.shape
    D = max(params.num_demes, 1)
    cpd = n // D
    is_deme, depl = T["is_deme"], T["depletable"]
    oh = T["oh_d"]
    rw = rewarded.to(_F32)
    avail = deme_resources[:, T["didx"]].repeat_interleave(cpd, dim=0)
    wanted = torch.minimum(avail * T["frac"][None, :],
                           T["max"][None, :]) * rw
    wanted = torch.where(is_deme[None, :], wanted, 0.0)
    want_depl = torch.where(depl[None, :], wanted, 0.0)

    def band_sum(x):
        # [N, NR] -> [D, NR]: each band's total in XLA's order
        return prng.xla_f32_sum(x.reshape(D, cpd, NR).transpose(0, 1))

    demand = _by_pool(band_sum(want_depl), oh)                  # [D, Rd]
    scale_rxn = _to_reactions(_scale(demand, deme_resources), oh)
    scale_rxn = torch.where((depl & is_deme)[None, :], scale_rxn, 1.0)
    got = wanted * scale_rxn.repeat_interleave(cpd, dim=0)
    drawn = torch.where(depl[None, :], got, 0.0)
    drawn_d = _by_pool(band_sum(drawn), oh)
    return got, (deme_resources - drawn_d).clamp(min=0.0)
