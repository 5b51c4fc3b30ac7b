"""Task evaluation for the micro-step engine: logic ids, math-family
tasks and reaction rewards.

Counterpart of avida_tpu/ops/tasks.py (cOrganism::DoOutput ->
cEnvironment::TestOutput, cEnvironment.cc:1314; cTaskLib::SetupTests,
cTaskLib.cc:369; DoProcesses, cc:1610).  Every organism performing IO in a
cycle is evaluated at once: its logic id from the truth-table scan, the
math-family candidates over its stored inputs, the requisite windows, and
the pow / mult / add bonus.  Only infinite-resource processes run here
(the amount consumed is the process's max); resource pools and
by-products are refused by name.

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

import torch

from avida_tpu_torch.ops.cycles import _logic_id, params_cached
from avida_tpu_torch.utils import prng

PROCTYPE_ADD, PROCTYPE_MULT, PROCTYPE_POW, PROCTYPE_LIN = 0, 1, 2, 3
_SENTINEL = -(2**30)
_POOLS_UNPORTED = ("resource-bound reactions, by-products and deme "
                   "resources (ROADMAP.md Queue 1 item 12a)")


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


def unported_reason(params) -> str | None:
    """Why apply_reactions cannot run `params` (None = it can)."""
    if any(r >= 0 for r in params.proc_res_idx) \
            or any(pi >= 0 for pi in params.proc_product_idx) \
            or params.num_deme_res:
        return _POOLS_UNPORTED
    return None


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
    }


def _fold(cols, op, init):
    """Reduce a list of [N] columns in order, from `init` (the order of
    XLA's CPU row reduction over a short minor axis)."""
    acc = torch.full_like(cols[0], init)
    for c in cols:
        acc = op(acc, c)
    return acc


def apply_reactions(params, tables, io_mask, logic_id, cur_bonus,
                    cur_task_count, cur_reaction_count, input_buf,
                    input_buf_n, output):
    """Trigger reactions for the organisms performing IO this cycle.
    Returns (new_bonus, new_task_count, new_reaction_count, any_reward).
    Lanes outside io_mask come back unchanged."""
    reason = unported_reason(params)
    if reason is not None:
        raise NotImplementedError(
            f"apply_reactions: {reason} are not ported to avida_tpu_torch")
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
    pow_mult = _fold([pow_f[:, r] for r in range(R)], torch.mul, 1.0)
    mult_mult = _fold([mult_f[:, r] for r in range(R)], torch.mul, 1.0)
    add_sum = _fold([add_f[:, r] for r in range(R)], torch.add, 0.0)
    # XLA's CPU code generator fuses the last multiply and the add
    new_bonus = prng.fma_f32(cur_bonus * pow_mult, mult_mult, add_sum)
    return (new_bonus, cur_task_count + performed.to(torch.int32),
            cur_reaction_count + rewarded.to(torch.int32),
            rewarded.any(dim=1))
