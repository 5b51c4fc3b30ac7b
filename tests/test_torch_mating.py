"""Mating types in the port: the five mating-type instructions in
micro_step, MATING_TYPES pairing in the birth chamber (a stored male,
same-type waiters, juvenile parents), and a 10x10 world of male and
female ancestors against the reference -- run alongside it, and resumed
from a generation the reference wrote.

`feature_world` (also used by the energy and thread tests) writes a
config dir with the instruction set, seeds the world in the port,
carries that state into the reference, runs both, writes the
reference's generation at `resume_at` and resumes a second port world
from it.

Tolerance: exact -- every state field byte for byte after every cycle,
flush and update, the .dat files equal apart from the header's date
line.
"""

import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.ops import birth as rbirth  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import heads_sex_instset  # noqa: E402
from avida_tpu_torch.core.state import seed_organism  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402

from test_torch_cycles_semantics import (_both_params,  # noqa: E402
                                         _instset_file)
from test_torch_micro_step import (N, VALS, _assert_states_equal,  # noqa
                                   _random_arrays, _ref_state, _ref_step)
from test_torch_placement import (assert_states_equal,  # noqa: E402
                                  both_params, pending_arrays, ref_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MATING = ["set-mating-type-male", "set-mating-type-female",
          "set-mating-type-juvenile", "if-mating-type-male",
          "if-mating-type-female"]
SEX_NAMES = list(heads_sex_instset().inst_names)
DATS = ("average", "count", "tasks", "time")


def test_mating_instructions_equal_reference(tmp_path):
    """Six cycles on a random state whose organisms hold every mating
    type and run the mating instructions (transitions, the male <->
    female refusal, the conditionals' skips): every field equal."""
    names = SEX_NAMES + MATING
    rp, tp = _both_params(_instset_file(tmp_path / "i.cfg", names, {}),
                          dict(VALS, MATING_TYPES=1, COPY_MUT_PROB=0.02))
    arrays = _random_arrays(tp, names, 21)
    rng = np.random.default_rng(21)
    arrays["mating_type"] = rng.integers(-1, 2, N).astype(np.int32)
    ops = [names.index(m) for m in MATING]
    for c in range(40, 64):            # a mating instruction under IP
        ip = int(arrays["heads"][c, 0]) % max(int(arrays["mem_len"][c]), 1)
        arrays["heads"][c, 0] = ip
        arrays["tape"][c, ip] = ops[c % 5]
    st_r, st_t = _ref_state(arrays), convert.state_from_arrays(arrays)
    step = _ref_step(rp)
    for c in range(6):
        mask = rng.random(N) < 0.9
        k = jax.random.fold_in(jax.random.key(4), c)
        st_r = step(st_r, k, jnp.asarray(mask))
        st_t = tinterp.micro_step(
            tp, st_t, convert.key_from_data(jax.random.key_data(k)),
            torch.from_numpy(mask))
        _assert_states_equal(st_r, st_t, c)
    assert (st_t.mating_type.numpy() != arrays["mating_type"]).any()


@pytest.mark.parametrize("case", ["stored_male", "same_type", "juveniles"])
def test_mating_pairing_flush_equals_reference(case):
    """The MATING_TYPES flush: males and females pair by random rank
    within their type, a stored male pairs first, waiters of one type
    past the store are dropped, juvenile parents lose their offspring;
    every field equal, the store's type included."""
    vals = dict(WORLD_X=7, WORLD_Y=5, RANDOM_SEED=4, TPU_MAX_MEMORY=64,
                MATING_TYPES=1, WORLD_GEOMETRY=1, BIRTH_METHOD=0)
    rp, tp = both_params(vals, sexual=True)
    arrays = pending_arrays(tp, seed=90 + len(case), sexual=True,
                            store=case == "stored_male", pending_p=0.7)
    rng = np.random.default_rng(len(case))
    n = tp.num_cells
    if case == "same_type":
        arrays["mating_type"] = np.ones(n, np.int32)
    else:
        arrays["mating_type"] = rng.integers(
            -1 if case == "juveniles" else 0, 2, n).astype(np.int32)
    if case == "stored_male":
        arrays["bc_type"] = np.int32(1)
    kr = jax.random.fold_in(jax.random.key(len(case)), 13)
    nbr = jnp.asarray(rbirth.neighbor_table(rp.world_x, rp.world_y,
                                            rp.geometry))
    # jitted, as in the reference's update program: the merit mix's
    # multiply-adds fuse
    out_r = jax.jit(lambda s, k: rbirth.flush_births(
        rp, s, k, nbr, 13, use_off_tape=True))(ref_state(arrays), kr)
    out_t = tbirth.flush_births(tp, convert.state_from_arrays(arrays),
                                convert.key_from_data(
                                    jax.random.key_data(kr)), 13)
    assert_states_equal(out_r, out_t, case)
    pend = arrays["divide_pending"] & arrays["alive"]
    resumed = pend & ~out_t.divide_pending.numpy()
    assert resumed.any()
    if case == "same_type":
        assert int(out_t.bc_type) == 1 and bool(out_t.bc_valid)


# ---- worlds, shared by the energy and thread tests ----

def _instset_text(names, energy_cost=None, hw_type=0):
    lines = [f"INSTSET heads_case:hw_type={hw_type}"]
    for name in names:
        ec = (energy_cost or {}).get(name, 0.0)
        lines.append(f"INST {name}:energy_cost={ec!r}")
    return "\n".join(lines) + "\n"


def feature_world(tmp_path, names, vals, seed_fn, stop, resume_at,
                  energy_cost=None, hw_type=0, events=(), dats=DATS):
    """A 10x10 world of instruction set `names` in both packages, seeded
    by seed_fn(port) after InjectAll: the port runs alongside the
    reference to `resume_at`, the reference writes a generation there,
    and a second port world resumes it and runs on to `stop`; the state
    is compared after every update, and the .dat files at the end.
    `hw_type` is the instruction set's hardware; `events` are more
    event lines and `dats` the .dat files compared (names without the
    suffix).  Returns (ref, port, resumed port)."""
    from avida_tpu.world import World as RefWorld
    from avida_tpu_torch.world import World
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "instset-case.cfg").write_text(_instset_text(names, energy_cost,
                                                         hw_type))
    (cdir / "avida.cfg").write_text("INST_SET instset-case.cfg\n")
    events = ["u begin InjectAll"] + [
        f"u 0:1:end Print{d.capitalize()}Data" for d in DATS] + list(events)
    (cdir / "events.cfg").write_text("\n".join(events) + "\n")
    base = dict(WORLD_X=10, WORLD_Y=10, AVE_TIME_SLICE=100,
                TPU_MAX_STEPS_PER_UPDATE=120,
                TPU_SYSTEMATICS=0, TPU_USE_PALLAS=2, TPU_CKPT_FINAL=0)
    vals = dict(base, **vals)
    ck = tmp_path / "ck"
    ref = RefWorld(config_dir=str(cdir), data_dir=str(tmp_path / "ref"),
                   overrides=list(dict(vals, TPU_CKPT_DIR=str(ck)).items()))
    port = World(config_dir=str(cdir), data_dir=str(tmp_path / "port"),
                 overrides=list(vals.items()), device="cpu")
    assert [e.action for e in ref.events] == [e.action for e in port.events]
    ref.process_events()
    port.process_events()
    port.state = seed_fn(port)
    ref.state = ref_state(convert.state_to_arrays(port.state))
    for u in range(1, resume_at + 1):
        assert port.run(max_updates=u) == ref.run(max_updates=u)
        assert_states_equal(ref.state, port.state, u)
    ref.save_checkpoint()
    shutil.copytree(tmp_path / "ref", tmp_path / "res")
    shutil.copytree(ck, tmp_path / "rck")
    resumed = World(config_dir=str(cdir), data_dir=str(tmp_path / "res"),
                    overrides=list(dict(
                        vals, TPU_CKPT_DIR=str(tmp_path / "rck")).items()),
                    device="cpu")
    assert resumed.resume() == resume_at
    assert_states_equal(ref.state, resumed.state, "resume")
    for u in range(resume_at + 1, stop + 1):
        assert resumed.run(max_updates=u) == ref.run(max_updates=u)
        assert_states_equal(ref.state, resumed.state, ("resumed", u))
    for name in dats:
        a = open(os.path.join(tmp_path, "ref", f"{name}.dat")).read()
        a_l = a.splitlines()
        for other in ("port", "res"):
            b = open(os.path.join(tmp_path, other, f"{name}.dat")).read()
            b_l = b.splitlines()
            # the port's rows stop at resume_at, the resumed world's run on
            assert resume_at < len(b_l) <= len(a_l), (other, name)
            assert (len(b_l) == len(a_l)) == (other == "res"), (other, name)
            assert a_l[:1] + a_l[2:len(b_l)] == b_l[:1] + b_l[2:], \
                (other, name)
    return ref, port, resumed


def reseed(port, genomes):
    """The port world's state with cell c reseeded with genomes[c % k]."""
    st = port.state
    for c in range(port.params.num_cells):
        st = seed_organism(port.params, st, genomes[c % len(genomes)],
                           prng.key(c), c)
    return st


def mating_ancestor(names, mating_type):
    """The sexual ancestor with set-mating-type-<type> run once a
    gestation: placed after h-alloc, one filler nop dropped (the filler
    itself never runs -- the first h-search jumps over it)."""
    from avida_tpu_torch.world import default_ancestor
    anc = list(default_ancestor(heads_sex_instset()))
    anc.insert(1, names.index(f"set-mating-type-{mating_type}"))
    del anc[6]
    return np.asarray(anc, np.int8)


def test_mating_world_equals_reference(tmp_path):
    """Male ancestors in even cells and female ones in odd cells, MATING_
    TYPES 1: pairings happen, and the state after each of 6 updates and
    the .dat files equal the reference's, in the world run alongside it
    to update 4 and in the one resumed from its generation there."""
    names = SEX_NAMES + MATING
    male, female = (mating_ancestor(names, t) for t in ("male", "female"))
    ref, port, res = feature_world(
        tmp_path, names, dict(RANDOM_SEED=12, MATING_TYPES=1),
        lambda w: reseed(w, [male, female]), stop=6, resume_at=4)
    mt = port.state.mating_type.numpy()
    assert (mt == 1).any() and (mt == 0).any()
    assert int(port._total_births) > 0
