"""The reaction reductions' compiled order in the compositions ROADMAP
Queue 3 listed as unprobed: a requisite window on some logic reactions
only, logic reactions only, and math reactions only.  Each runs
tests/test_torch_tasks.py's _order_case (one engine cycle of each
package on the same populated 8x8 state, TPU_USE_PALLAS=2) with its own
environment: every organism outputs a copy of its positive input and
collects every reward of its window at once.

The orders were read off the reference's dumped update program (the IO
block's fused loop, `XLA_FLAGS=--xla_dump_to=DIR` and its
`*ir-with-opt.ll`) and by probing each reduction's form: logic only and
math only vectorize the products from 20 reactions and the sum from 23;
a window on some logic reactions, the products from 17 and the sum from
22 (ops/tasks.vector_chunks).  The forms were read on an x86-64 CPU;
each failure message carries this CPU's flags, since another ISA
compiles another order.

A window on some logic reactions at 16 reactions runs on 8x8 states,
where the reference compiles the IO block as one loop, and on 16x16,
17x17 and 20x20 ones, where XLA's CPU backend splits the block's
organisms into parallel partitions (outer_dimension_partitions 3, 3 and
4 on 8 schedulable CPUs) and compiles a last partition shorter than the
others (from organism 172 of 256, 194 of 289) to a loop of its own, with
the pow product as a 16-lane tree and the mult product as two 8-lane
chunks (ops/tasks.io_block_tail, from the fused block's HloCostAnalysis
counts; ROADMAP.md Queue 3).

Tolerance: exact -- every state field byte for byte.
"""

import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu_torch.ops import tasks as ttasks  # noqa: E402

import test_torch_tasks  # noqa: E402
from test_torch_tasks import _order_case, cpu_flags  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(r, rng):
    t = ("mult", "pow", "add")[r % 3]
    v = {"mult": 1 + rng.uniform(0.001, 0.9), "pow": rng.uniform(0.05, 0.95),
         "add": rng.uniform(0.5, 3.0)}[t]
    return t, f"{float(np.float32(v))!r}"


def _env(comp):
    """_order_env's replacement for composition `comp`: "logic" (echo
    rewards, which a copy of the input performs, logic-9's window on
    each), "math" (math_1AJ rewards only), "some" (_order_env with the
    window on the first logic reaction only)."""
    def env(R, rng):
        if comp == "some":
            text, ptypes = test_torch_tasks._order_env_windows(R, rng)
            first = text.index(" requisite:max_count=1") + 1
            return (text[:first] + text[first:].replace(
                " requisite:max_count=1", ""), ptypes)
        lines, ptypes = [], []
        for r in range(R):
            t, v = _values(r, rng)
            if comp == "logic":
                lines.append(f"REACTION L{r} echo process:value={v}:type={t} "
                             f"requisite:max_count=1")
            else:
                lines.append(f"REACTION R{r} math_1AJ "
                             f"process:value={v}:type={t}")
            ptypes.append(t)
        return "\n".join(lines) + "\n", ptypes
    return env


_FROM = {"logic": (20, 23), "math": (20, 23), "some": (17, 22)}


@pytest.mark.parametrize("comp,R,side", [
    pytest.param(c, r, 8, id=f"{c}-{r}")
    for c, r in (("some", 12), ("some", 16), ("some", 17), ("some", 21),
                 ("some", 24), ("logic", 24), ("logic", 32), ("math", 19),
                 ("math", 24))] + [
    # partitioned IO blocks: 3 tasks of 86, 86, 84 organisms (16x16), 3
    # of 97, 97, 95 (17x17), 4 of 100 (20x20)
    pytest.param("some", 16, 16, id="some-16-16x16"),
    pytest.param("some", 16, 17, id="some-16-17x17"),
    pytest.param("some", 16, 20, id="some-16-20x20")])
def test_engine_reaction_order_by_composition(tmp_path, monkeypatch, comp,
                                              R, side):
    """Every field, cur_bonus included, equal to the reference's engine
    after one cycle in which organisms collect several fractional rewards
    of each process type; vector_chunks names the form, and on a
    partitioned IO block io_block_tail the last partition's first
    organism."""
    from avida_tpu.core.state import state_field_names

    from avida_tpu_torch import convert
    monkeypatch.setattr(sys.modules["test_torch_tasks"], "_order_env",
                        _env(comp))
    r_out, t_out, per_type, params = _order_case(tmp_path, R, side=side)
    got = convert.state_to_arrays(t_out)
    for k in state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), \
            (k, cpu_flags())
    assert sum(int(v.sum()) for v in per_type.values()) > 3 * len(
        per_type["add"])
    p_from, s_from = _FROM[comp]
    assert ttasks.vector_chunks(params) == {
        "pow": R // 8 if R >= p_from else 0,
        "mult": R // 8 if R >= p_from else 0,
        "add": R // 8 if R >= s_from else 0}
    if side > 8:
        tail = {16: 172, 17: 194, 20: 400}[side]
        assert ttasks.io_block_tail(params, side * side, cpus=8) == tail
