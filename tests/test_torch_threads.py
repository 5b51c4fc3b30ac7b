"""Threads in the port (MAX_CPU_THREADS > 1): micro_step_threads
against the reference's, cycle by cycle on random states with thread
slots -- forks below and at the cap, kill-th from the primary and from
an extra slot, id-th, divides from either, under both thread slicing
methods -- and the engine's dispatch to it.  The threaded world is
tests/test_torch_threads_world.py.

Tolerance: exact -- every state field byte for byte after every cycle
and update, the .dat files equal apart from the header's date line.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.ops import interpreter as rinterp  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402
from avida_tpu_torch.ops import update as tupd  # noqa: E402

from test_torch_cycles_semantics import (_both_params,  # noqa: E402
                                         _instset_file)
from test_torch_micro_step import (N, VALS, _assert_states_equal,  # noqa
                                   _random_arrays, _ref_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


THREADS = ["fork-th", "kill-th", "id-th"]
NAMES = list(default_instset().inst_names) + THREADS


def _thread_arrays(tp, seed):
    """A random population with random extra thread slots (some organisms
    with every slot live, so their forks fail at the cap) and the thread
    instructions under many IPs."""
    T = tp.max_cpu_threads
    Te = T - 1
    base = _random_arrays(tp, NAMES, seed)
    z = convert.state_to_arrays(tstate.zeros_population(
        N, base["tape"].shape[1], tp.num_reactions, max_threads=T))
    rng = np.random.default_rng(seed)
    for name in z:
        if name.startswith("t_") or name in ("main_tid", "cur_thread"):
            base[name] = z[name]
    base["t_alive"] = rng.random((N, Te)) < 0.5
    base["t_alive"][40:48] = True
    base["t_ids"] = rng.integers(1, T, (N, Te)).astype(np.int32)
    base["main_tid"] = np.where(rng.random(N) < 0.3,
                                rng.integers(0, T, N), 0).astype(np.int32)
    base["cur_thread"] = rng.integers(0, T, N).astype(np.int32)
    base["t_regs"] = rng.integers(-50, 50, base["t_regs"].shape).astype(
        np.int32)
    base["t_heads"] = rng.integers(0, 60, base["t_heads"].shape).astype(
        np.int32)
    base["t_stack"] = rng.integers(-9, 9, base["t_stack"].shape).astype(
        np.int32)
    base["t_sp"] = rng.integers(0, 10, (N, Te)).astype(np.int32)
    base["t_active_stack"] = rng.integers(0, 2, (N, Te)).astype(np.int32)
    base["t_rlabel"] = rng.integers(0, 3, base["t_rlabel"].shape).astype(
        np.int8)
    base["t_rlabel_len"] = rng.integers(0, 10, (N, Te)).astype(np.int32)
    ops = [NAMES.index(t) for t in THREADS]
    for c in range(40, 64):
        k = ops[c % 3]
        base["tape"][c, :] = np.where(rng.random(base["tape"].shape[1])
                                      < 0.3, k, base["tape"][c, :])
    return base


@pytest.mark.parametrize("T,slicing", [(2, 0), (4, 0), (4, 1)])
def test_micro_step_threads_equals_reference(tmp_path, T, slicing):
    """Six cycles of micro_step_threads on a random threaded state:
    every field equal after every cycle; forks, kills and divides
    happen."""
    path = _instset_file(tmp_path / "i.cfg", NAMES, {})
    rp, tp = _both_params(path, dict(
        VALS, MAX_CPU_THREADS=T, THREAD_SLICING_METHOD=slicing,
        COPY_MUT_PROB=0.03))
    arrays = _thread_arrays(tp, 40 + T + slicing)
    st_r, st_t = _ref_state(arrays), convert.state_from_arrays(arrays)
    step = jax.jit(functools.partial(rinterp.micro_step_threads, rp))
    rng = np.random.default_rng(T)
    alive0 = arrays["t_alive"].sum()
    forks = kills = 0
    for c in range(6):
        mask = rng.random(N) < 0.9
        k = jax.random.fold_in(jax.random.key(8), c)
        before = st_t.t_alive.clone()
        st_r = step(st_r, k, jnp.asarray(mask))
        st_t = tinterp.micro_step_threads(
            tp, st_t, convert.key_from_data(jax.random.key_data(k)),
            torch.from_numpy(mask))
        _assert_states_equal(st_r, st_t, (T, slicing, c))
        forks += int((st_t.t_alive & ~before).sum())
        kills += int((before & ~st_t.t_alive).sum())
    assert forks > 0 and kills > 0
    assert int(st_t.num_divides.sum()) > 0
    assert alive0 > 0


def test_thread_dispatch_shared_by_solo_and_batch():
    """cycle_step_fn routes MAX_CPU_THREADS > 1 to micro_step_threads for
    the solo loop and the folded batch alike, with its draw keys."""
    _, tp = _both_params_plain(MAX_CPU_THREADS=3)
    fn, keys = tupd.cycle_step_fn(tp)
    assert fn is tinterp.micro_step_threads
    assert keys is tinterp.draw_keys_threads
    _, tp1 = _both_params_plain(MAX_CPU_THREADS=1)
    assert tupd.cycle_step_fn(tp1)[0] is tinterp.micro_step


def _both_params_plain(**kw):
    from test_torch_placement import both_params
    return both_params(dict(WORLD_X=4, WORLD_Y=4, **kw))
