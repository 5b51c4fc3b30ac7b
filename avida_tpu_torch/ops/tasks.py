"""Task evaluation for the micro-step engine: logic ids, math-family
tasks and reaction rewards.

Counterpart of avida_tpu/ops/tasks.py (cOrganism::DoOutput ->
cEnvironment::TestOutput, cEnvironment.cc:1314; cTaskLib::SetupTests,
cTaskLib.cc:369; DoProcesses, cc:1610).  Every organism performing IO in a
cycle is evaluated at once: its logic id from the truth-table scan, the
math-family candidates over its stored inputs, the requisite windows, the
draw-down of the pools the rewarded reactions bind (ops/resources.py:
global, spatial and deme pools; an infinite process consumes its max),
the by-products, and the pow / mult / add bonus of value x amount.

Integer arithmetic keeps the reference's int32 wraparound; division and
remainder truncate toward zero as C does (XLA's div / rem, with
INT32_MIN / -1 wrapping).  Float results repeat XLA's CPU arithmetic:
`prng.xla_exp2` for the pow bonus, a fused multiply-add where
XLA fuses one, `prng.xla_log` and a correctly rounded
square root for the math tasks, and XLA's saturating float-to-int
conversion (NaN -> 0).
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from avida_tpu_torch.ops.cycles import _logic_id, params_cached
from avida_tpu_torch.utils import prng

PROCTYPE_ADD, PROCTYPE_MULT, PROCTYPE_POW, PROCTYPE_LIN = 0, 1, 2, 3
_SENTINEL = -(2**30)


def _i32(x):
    """int64 -> int32 with the same low 32 bits."""
    return (x & 0xFFFFFFFF).to(torch.int32)


def _f2i(x):
    """XLA's float32 -> int32 conversion: truncation toward zero,
    saturating at the int32 range, NaN -> 0."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return x.clamp(-2**31, 2**31 - 1).to(torch.int64).to(torch.int32)


def _isqrt(x):
    """(int) sqrt(|x|) on float32 (|INT32_MIN| stays negative: NaN -> 0)."""
    return _f2i(prng.sqrt_f32(x.abs().to(torch.float32)))


def _ilog(x):
    """(int) log(x) on float32; a non-positive x never matches."""
    safe = _f2i(prng.xla_log(x.clamp(min=1).to(torch.float32)))
    return torch.where(x > 0, safe, _SENTINEL)


def _cdiv(a, b):
    """C division (toward zero); the sentinel where b == 0.  `b` is an
    int32 tensor or a nonzero Python int."""
    if isinstance(b, int):
        return _i32(torch.div(a.long(), b, rounding_mode="trunc"))
    q = torch.div(a.long(), torch.where(b == 0, 1, b).long(),
                  rounding_mode="trunc")
    return torch.where(b != 0, _i32(q), _SENTINEL)


def _crem(a, b):
    """C remainder (sign of a); the sentinel where b == 0."""
    r = torch.fmod(a.long(), torch.where(b == 0, 1, b).long())
    return torch.where(b != 0, _i32(r), _SENTINEL)


MATH_TASKS = {
    # arity 1 (cTaskLib.cc:191-207)
    "math_1AA": (1, lambda x: 2 * x),
    "math_1AB": (1, lambda x: _cdiv(2 * x, 3)),
    "math_1AC": (1, lambda x: _cdiv(5 * x, 4)),
    "math_1AD": (1, lambda x: x * x),
    "math_1AE": (1, lambda x: x * x * x),
    "math_1AF": (1, _isqrt),
    "math_1AG": (1, _ilog),
    "math_1AH": (1, lambda x: x * x + x * x * x),
    "math_1AI": (1, lambda x: x * x + _isqrt(x)),
    "math_1AJ": (1, lambda x: x.abs()),
    "math_1AK": (1, lambda x: x - 5),
    "math_1AL": (1, lambda x: -x),
    "math_1AM": (1, lambda x: 5 * x),
    "math_1AN": (1, lambda x: _cdiv(x, 4)),
    "math_1AO": (1, lambda x: x - 6),
    "math_1AP": (1, lambda x: x - 7),
    "math_1AS": (1, lambda x: 3 * x),
    # arity 2 (cTaskLib.cc:210-236)
    "math_2AA": (2, lambda x, y: _isqrt(x + y)),
    "math_2AB": (2, lambda x, y: (x + y) * (x + y)),
    "math_2AC": (2, _crem),
    "math_2AD": (2, lambda x, y: _cdiv(3 * x, 2) + _cdiv(5 * y, 4)),
    "math_2AE": (2, lambda x, y: (x - 5).abs() + (y - 6).abs()),
    "math_2AF": (2, lambda x, y: x * y - _cdiv(x, y)),
    "math_2AG": (2, lambda x, y: (x - y) * (x - y)),
    "math_2AH": (2, lambda x, y: x * x + y * y),
    "math_2AI": (2, lambda x, y: x * x + y * y * y),
    "math_2AJ": (2, lambda x, y: _cdiv(_isqrt(x) + y, x - 7)),
    "math_2AK": (2, lambda x, y: _ilog(_cdiv(x, y).abs())),
    "math_2AL": (2, lambda x, y: _cdiv(_ilog(x.abs()), y)),
    "math_2AM": (2, lambda x, y: _cdiv(x, _ilog(y.abs()))),
    "math_2AN": (2, lambda x, y: x + y),
    "math_2AO": (2, lambda x, y: x - y),
    "math_2AP": (2, _cdiv),
    "math_2AQ": (2, lambda x, y: x * y),
    "math_2AR": (2, lambda x, y: _isqrt(x) + _isqrt(y)),
    "math_2AS": (2, lambda x, y: x + 2 * y),
    "math_2AT": (2, lambda x, y: x + 3 * y),
    "math_2AU": (2, lambda x, y: 2 * x + 3 * y),
    "math_2AV": (2, lambda x, y: x * y * y),
    # 2AX repeats 2AT and there is no 2AW, as in the reference
    # (cTaskLib.cc:232)
    "math_2AX": (2, lambda x, y: x + 3 * y),
    "math_2AY": (2, lambda x, y: 2 * x + y),
    "math_2AZ": (2, lambda x, y: 4 * x + 6 * y),
    "math_2AAA": (2, lambda x, y: 3 * x - 2 * y),
    # arity 3 (cTaskLib.cc:239-260)
    "math_3AA": (3, lambda x, y, z: x * x + y * y + z * z),
    "math_3AB": (3, lambda x, y, z: _isqrt(x) + _isqrt(y) + _isqrt(z)),
    "math_3AC": (3, lambda x, y, z: x + 2 * y + 3 * z),
    "math_3AD": (3, lambda x, y, z: x * y * y + z * z * z),
    "math_3AE": (3, lambda x, y, z: _crem(x, y) * z),
    "math_3AF": (3, lambda x, y, z: (x + y) * (x + y) + _isqrt(y + z)),
    "math_3AG": (3, lambda x, y, z: _crem(x * y, y * z)),
    "math_3AH": (3, lambda x, y, z: x + y + z),
    "math_3AI": (3, lambda x, y, z: -x - y - z),
    "math_3AJ": (3, lambda x, y, z: (x - y) * (x - y) + (y - z) * (y - z)
                 + (z - x) * (z - x)),
    "math_3AK": (3, lambda x, y, z: (x + y) * (x + y) + (y + z) * (y + z)
                 + (z + x) * (z + x)),
    "math_3AL": (3, lambda x, y, z: (x - y) * (x - y) + (x - z) * (x - z)),
    "math_3AM": (3, lambda x, y, z: (x + y) * (x + y) + (x + z) * (x + z)),
}


def math_performed(task_name, input_buf, input_buf_n, output):
    """bool[N]: does `output` equal math task `task_name` over any stored
    input (arity 1), ordered pair (2) or ordered triple (3) of distinct
    buffer slots?  int32 operands, int32 wraparound."""
    arity, fn = MATH_TASKS[task_name]
    ins = [input_buf[:, k] for k in range(3)]
    have = [input_buf_n > k for k in range(3)]
    hit = torch.zeros(output.shape, dtype=torch.bool, device=output.device)
    for idx in itertools.permutations(range(3), arity):
        ok = output == fn(*(ins[i] for i in idx))
        for i in idx:
            ok = ok & have[i]
        hit = hit | ok
    return hit


def compute_logic_id(input_buf, input_buf_n, output):
    """cTaskLib::SetupTests: int32[N] logic id in [0, 255], or -1 when the
    output is not a consistent function of the stored inputs."""
    b = input_buf.long()
    n = input_buf_n.long()
    i0 = torch.where(n > 0, b[:, 0], 0)
    i1 = torch.where(n > 1, b[:, 1], 0)
    i2 = torch.where(n > 2, b[:, 2], 0)
    return _logic_id(i0, i1, i2, n, output.long()).to(torch.int32)


_TABLES = {}           # (id(params), device) -> (params, tables)


def env_tables_to_device(params, device) -> dict:
    """The environment's reaction tables as tensors on `device`
    (cycles.params_cached)."""
    return params_cached(_TABLES, params, device, _build_env_tables)


def _build_env_tables(params, device) -> dict:
    R = params.num_reactions

    def t(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=device)

    return {
        "task_logic_mask": t(params.task_logic_mask, torch.bool).reshape(
            R, 256),
        "proc_value": t(params.proc_value, torch.float32),
        "proc_type": t(params.proc_type, torch.int32),
        "max_task_count": t(params.max_task_count, torch.int32),
        "min_task_count": t(params.min_task_count, torch.int32),
        "req_reaction_mask": t(params.req_reaction_mask, torch.bool).reshape(
            R, R),
        "noreq_reaction_mask": t(params.noreq_reaction_mask,
                                 torch.bool).reshape(R, R),
        "proc_max": t(params.proc_max, torch.float32),
        "is_deme": t(params.proc_res_deme if params.num_deme_res
                     else [False] * R, torch.bool),
        "chunks": vector_chunks(params),
        "tail_chunks": tail_forms(params),
    }


# the reaction count from which the compiled engine vectorizes each
# reduction (below it: in order), with a requisite window (max_count) on
# every logic reaction, and with none on any
_VECTOR_FROM = {"pow": 17, "mult": 17, "add": 19}
_VECTOR_FROM_OPEN = {"pow": 20, "mult": 20, "add": 23}
# a window on some logic reactions only (R = 16 excepted: ROADMAP.md
# Queue 3)
_VECTOR_FROM_SOME = {"pow": 17, "mult": 17, "add": 22}
_NO_WINDOW = 2**30          # max_task_count of a reaction with no window
# vector_chunks' value for a tree over the first 16 reactions padded to a
# power of two, the rest in order; the largest reaction count at which
# that form was read (11-17, and 18-23 with the reactions past the first
# ten alternating pool-bound and unbound)
TREE = -1
_TREE_LANES = 16
_TREE_UP_TO = 23


def one_acc(k: int) -> int:
    """vector_chunks' value for k chunks of 8 lanes folded lane-wise into
    ONE accumulator (then the lane tree, the rest in order)."""
    return TREE - k


def vector_chunks(params) -> dict:
    """How the reference's compiled micro-step engine combines the pow
    and mult products and the add sum over the R reactions (XLA marks
    these reductions reassociable and LLVM vectorizes them): for each of
    "pow", "mult", "add", 0 = in order, k > 0 = k chunks of 8 lanes in
    two accumulators, TREE, or one_acc(k) (vector_fold).

    Read off the reference's engine (the while_loop of interpret_phase,
    solo, and of _mw_fold_cycles_xla, folded: both the same) on an
    x86-64 CPU with AVX-512, by probing which two of every three
    fractional rewards of one type combine first: with logic-task
    reactions (logic-9's requisite max_count=1) and math-task reactions
    of all three process types, the products vectorize from 17 reactions
    and the sum from 19; with no requisite window on any logic reaction,
    the products from 20 and the sum from 23 (read at 17-32 reactions);
    the same with logic reactions only or math reactions only; with a
    window on some logic reactions only, the products from 17 and the
    sum from 22 (at 16 the compiled loop's last parallel partition of
    organisms takes another form: ROADMAP.md Queue 3).
    With processes bound to pools beside processes
    bound to none, all three reduce as a tree over the first 16
    reactions padded to a power of two, then the rest in order (TREE;
    read from 11 to 23 reactions, wherever the unbound ones sit); from 24
    on as 8-lane chunks folded into one accumulator (one_acc), read off
    the IO block's LLVM IR.  Without all three process types the
    reductions stay in order."""
    R = params.num_reactions
    off = {k: 0 for k in _VECTOR_FROM}
    bound = [r >= 0 for r in params.proc_res_idx]
    if any(bound) and not all(bound):
        form = TREE if R <= _TREE_UP_TO else one_acc(R // 8)
        return {k: form for k in off}
    if R < min(_VECTOR_FROM.values()):
        return off
    comp = _composition(params)
    if comp is None:
        return off
    start = {"open": _VECTOR_FROM_OPEN, "all": _VECTOR_FROM,
             "some": _VECTOR_FROM_SOME}[comp]
    return {k: (R // 8 if R >= v else 0) for k, v in start.items()}


def _composition(params) -> str | None:
    """Which of vector_chunks' read compositions the environment is:
    "open" (one task family, or no requisite window), "all" (a window on
    every logic reaction), "some" (a window on some logic reactions
    only); None without all three process types."""
    R = params.num_reactions
    names = params.task_math_name
    logic = np.asarray(params.task_logic_mask, bool).reshape(R, -1)
    logic_rows = [r for r, nm in enumerate(names)
                  if not nm and logic[r].any()]
    if not {PROCTYPE_ADD, PROCTYPE_MULT, PROCTYPE_POW} \
            <= set(params.proc_type):
        return None
    windows = [params.max_task_count[r] < _NO_WINDOW for r in logic_rows]
    if not (any(names) and logic_rows) or not any(windows):
        return "open"
    return "all" if all(windows) else "some"


# XLA's CPU backend runs a fused block in parallel tasks when its cost
# says so (ParallelTaskAssignment's DefaultCostModel): p = min(schedulable
# CPUs, cost / 100,000) partitions of ceil(N / p) organisms, cost = flops
# + 2 x transcendentals + 10 x bytes of the fused computation
# (HloCostAnalysis), where flops > bytes.  The last partition, when it is
# shorter than the others, compiles to a loop of its own, with its own
# reduction forms.
_MIN_TASK_COST = 100_000          # 100 us of work on a 2 GHz core
# the last partition's forms, by reaction count, where they were read
# (a window on some logic reactions; ROADMAP.md Queue 3)
_TAIL_FORMS = {16: {"pow": TREE, "mult": 2, "add": 0}}


def io_block_cost(params, n) -> tuple:
    """(flops, transcendentals, bytes) of the IO block's fused reward
    reduction over n organisms (the `reduce_add_fusion` computing the new
    bonus), as HloCostAnalysis counts them on its after-optimizations
    HLO: per organism and reaction 14 elementwise ops (the window, the
    rewarded and typed masks, the selects, the exp2 scaling) and 3
    reduction steps less one per organism, plus 3 ops per organism (17 n
    R flops in all); one exp per organism and reaction; the inputs read
    once (the reward mask 1 byte and the task counts 4 bytes per
    organism and reaction, the bonus 4 bytes per organism, 11 bytes of
    tables per reaction) and the new bonus written (4 bytes per
    organism)."""
    R = int(params.num_reactions)
    return 17 * n * R, n * R, 8 * n + 5 * n * R + 11 * R


def io_block_tail(params, n, cpus=None) -> int:
    """First organism of the IO block's last parallel partition when that
    partition compiles a loop of its own (it is shorter than the
    others), else n.  `cpus`: the schedulable CPUs XLA sees
    (os.sched_getaffinity)."""
    flops, trans, nbytes = io_block_cost(params, n)
    if flops <= nbytes:           # I/O bound: no partition at these sizes
        return n
    if cpus is None:
        cpus = len(os.sched_getaffinity(0))
    p = min(cpus, n, max(1, (flops + 2 * trans + 10 * nbytes)
                         // _MIN_TASK_COST))
    size = -(-n // p)
    return n if p <= 1 or n - size * (p - 1) == size else size * (p - 1)


def tail_forms(params) -> dict | None:
    """The last partition's reduction forms (io_block_tail), where the
    composition and reaction count were read: a window on some logic
    reactions, in-order forms for the rest (vector_chunks), R = 16."""
    R = params.num_reactions
    if vector_chunks(params) != {k: 0 for k in _VECTOR_FROM} \
            or _composition(params) != "some":
        return None
    return _TAIL_FORMS.get(R)


def vector_fold(cols, op, init, chunks):
    """Reduce R [N] columns as the compiled loop does: with chunks == 0
    in order from `init`; with chunks == TREE as a tree over the first 16
    columns padded with `init` to a power of two lanes (lane j with lane
    j + half, halving), the rest in order; else chunk k (columns
    8k..8k+7) folds lane-wise into accumulator k % 2 (into the one
    accumulator under one_acc), the two accumulators combine lane-wise,
    the 8 lanes reduce as a tree (lane j with lane j+4, then j+2, then
    j+1), and the columns past the chunks follow in order."""
    if chunks == TREE:
        head = cols[:_TREE_LANES]
        width = 1 << max(len(head) - 1, 0).bit_length()
        lanes = list(head) + [torch.full_like(cols[0], init)] * (
            width - len(head))
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [op(lanes[j], lanes[j + h]) for j in range(h)]
        acc = lanes[0]
        for c in cols[_TREE_LANES:]:
            acc = op(acc, c)
        return acc
    if not chunks:
        acc = torch.full_like(cols[0], init)
        for c in cols:
            acc = op(acc, c)
        return acc
    n_acc = 1 if chunks < TREE else 2
    if n_acc == 1:
        chunks = TREE - chunks
    accs = [None, None]
    for k in range(chunks):
        part = cols[8 * k:8 * k + 8]
        a = accs[k % n_acc]
        accs[k % n_acc] = part if a is None else [op(x, y)
                                                  for x, y in zip(a, part)]
    lanes = accs[0] if n_acc == 1 else [op(x, y)
                                        for x, y in zip(accs[0], accs[1])]
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [op(lanes[j], lanes[j + h]) for j in range(h)]
    acc = lanes[0]
    for c in cols[8 * chunks:]:
        acc = op(acc, c)
    return acc


def apply_reactions(params, tables, io_mask, logic_id, cur_bonus,
                    cur_task_count, cur_reaction_count, input_buf,
                    input_buf_n, output, resources=None, res_grid=None,
                    deme_resources=None):
    """Trigger reactions for the organisms performing IO this cycle.
    Returns (new_bonus, new_task_count, new_reaction_count, any_reward,
    resources', res_grid', deme_resources').  Lanes outside io_mask come
    back unchanged; the pools are drawn down only when a reaction binds
    one or produces into one (resources.binds_pools)."""
    from avida_tpu_torch.ops import resources as res_ops
    R = params.num_reactions
    lid = logic_id.clamp(0, 255).long()
    valid = (logic_id >= 0) & io_mask
    performed = tables["task_logic_mask"][:, lid].T & valid[:, None]
    names = params.task_math_name
    if any(names):
        performed = performed.clone()
        hits = {nm: math_performed(nm, input_buf, input_buf_n, output)
                & io_mask for nm in set(names) if nm}
        for r, nm in enumerate(names):
            if nm:
                performed[:, r] = hits[nm]
    in_window = ((cur_task_count >= tables["min_task_count"][None])
                 & (cur_task_count < tables["max_task_count"][None]))
    rc_zero = cur_reaction_count == 0
    req_ok = ~(tables["req_reaction_mask"][None] & rc_zero[:, None]).any(2)
    noreq_ok = ~(tables["noreq_reaction_mask"][None]
                 & ~rc_zero[:, None]).any(2)
    rewarded = performed & in_window & req_ok & noreq_ok

    if res_ops.binds_pools(params):
        amount, resources, res_grid = res_ops.consume(
            params, rewarded, 1.0, resources, res_grid)
        if params.num_deme_res:
            amt_d, deme_resources = res_ops.consume_deme(
                params, rewarded, deme_resources)
            amount = torch.where(tables["is_deme"][None], amt_d, amount)
        resources, res_grid = _by_products(params, rewarded, amount,
                                           resources, res_grid)
    else:
        # infinite-resource processes consume their max outright
        amount = tables["proc_max"][None] * rewarded.to(torch.float32)
    va = tables["proc_value"][None] * amount
    ptype = tables["proc_type"][None]
    one = torch.ones((), dtype=torch.float32, device=va.device)
    zero = torch.zeros((), dtype=torch.float32, device=va.device)
    pow_f = torch.where(rewarded & (ptype == PROCTYPE_POW),
                        prng.xla_exp2(va), one)
    mult_f = torch.where(rewarded & (ptype == PROCTYPE_MULT) & (va != 0),
                         va, one)
    add_f = torch.where(rewarded & (ptype == PROCTYPE_ADD), va, zero)
    pow_mult, mult_mult, add_sum = _fold_rewards(params, tables, pow_f,
                                                 mult_f, add_f)
    # XLA's CPU code generator fuses the last multiply and the add; with
    # no mult process the product over them folds to 1 and drops out, so
    # the pow product is the last multiply
    if PROCTYPE_MULT in params.proc_type:
        new_bonus = prng.fma_f32(cur_bonus * pow_mult, mult_mult, add_sum)
    else:
        new_bonus = prng.fma_f32(cur_bonus, pow_mult, add_sum)
    return (new_bonus, cur_task_count + performed.to(torch.int32),
            cur_reaction_count + rewarded.to(torch.int32),
            rewarded.any(dim=1), resources, res_grid, deme_resources)


def _fold_rewards(params, tables, pow_f, mult_f, add_f):
    """The pow and mult products and the add sum over the reactions, each
    organism in its compiled loop's form: vector_chunks', or from
    io_block_tail on, the last parallel partition's (tail_forms)."""
    R = params.num_reactions
    n = pow_f.shape[0]
    parts = [(slice(0, n), tables["chunks"])]
    if tables["tail_chunks"] is not None:
        t = io_block_tail(params, n)
        if t < n:
            parts = [(slice(0, t), tables["chunks"]),
                     (slice(t, n), tables["tail_chunks"])]
    out = []
    for f, op, init, kind in ((pow_f, torch.mul, 1.0, "pow"),
                              (mult_f, torch.mul, 1.0, "mult"),
                              (add_f, torch.add, 0.0, "add")):
        folds = [vector_fold([f[rows, r] for r in range(R)], op, init,
                             forms[kind]) for rows, forms in parts]
        out.append(folds[0] if len(folds) == 1 else torch.cat(folds))
    return out


def _by_products(params, rewarded, amount, resources, res_grid):
    """By-products (DoProcesses cc:1824-1830): each rewarded reaction
    with a product adds consumed x conversion to the product's pool --
    a global pool the float32 total over organisms, a spatial pool cell
    by cell -- in reaction order."""
    prod_idx = params.proc_product_idx
    if not any(pi >= 0 for pi in prod_idx):
        return resources, res_grid
    conv = torch.tensor(params.proc_conversion, dtype=torch.float32,
                        device=amount.device)
    produced = torch.where(rewarded, amount, 0.0) * conv[None, :]
    resources, res_grid = resources.clone(), res_grid.clone()
    for r, pi in enumerate(prod_idx):
        if pi < 0:
            continue
        if params.proc_product_spatial[r]:
            # XLA's CPU backend contracts the conversion product into
            # the add
            res_grid[pi] = prng.fma_f32(
                torch.where(rewarded[:, r], amount[:, r], 0.0), conv[r],
                res_grid[pi])
        else:
            resources[pi] = resources[pi] + prng.xla_f32_sum(produced[:, r])
    return resources, res_grid
