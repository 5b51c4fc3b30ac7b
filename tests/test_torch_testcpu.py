"""analyze/testcpu.py (the batched Test CPU), analyze/trace.py and
systematics/test_metrics.py against the reference's avida_tpu/analyze/
and avida_tpu/systematics/test_metrics.py, on the same genomes and seeds.

The genomes: the default ancestor, a 10-site nop ball, a mutant that
performs NAND, the ancestor with its h-divide knocked out, a point
mutant in the filler it never runs, and point mutants that breed untrue
(so the second and third generations run).  The parameters are a 12x12
world's: the sandbox takes no width from the world.  TEST_CPU_TIME_MOD 5
keeps the gestations short (the ancestor divides at 389 cycles of its
500).

Tolerance: exact -- every TestResult field, snapshot and trace byte
equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.analyze import testcpu as rtc  # noqa: E402
from avida_tpu.analyze import trace as rtrace  # noqa: E402
from avida_tpu.config.environment import \
    default_logic9_environment as r_env  # noqa: E402
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.systematics.test_metrics import \
    GenomeTestMetrics as RMetrics  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.analyze import testcpu as ttc  # noqa: E402
from avida_tpu_torch.analyze import trace as ttrace  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.config.environment import \
    default_logic9_environment as t_env  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402
from avida_tpu_torch.systematics.test_metrics import \
    GenomeTestMetrics as TMetrics  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import (_DEFAULT_ANCESTOR_NAMES,  # noqa: E402
                                   default_ancestor)

L = 256
VALS = dict(WORLD_X=12, WORLD_Y=12, TPU_MAX_MEMORY=L, RANDOM_SEED=3)
TIME_MOD = 5
INSTSET = default_instset()
OP = {n: i for i, n in enumerate(INSTSET.inst_names)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small batches' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_params(**extra):
    vals = dict(VALS, **extra)
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  default_instset(), t_env())
    return rp, tp


def _mutant(changes):
    m = default_ancestor(INSTSET).copy()
    for site, name in changes:
        m[site] = OP[name]
    return m


def genomes():
    """name -> genome (int8 opcodes)."""
    anc = default_ancestor(INSTSET)
    n = list(_DEFAULT_ANCESTOR_NAMES)
    nand = n[:1] + ["IO", "swap", "IO", "nand", "IO"] + n[1:5] + n[10:]
    return {
        "ancestor": anc,
        "nop_ball": np.full(10, OP["nop-C"], np.int8),
        "nand": np.asarray([OP[x] for x in nand], np.int8),
        "knockout": _mutant([(96, "nop-C")]),
        "filler": _mutant([(30, "nop-A")]),
        "untrue_viable": _mutant([(14, "mov-head"), (42, "jmp-head")]),
        "untrue_dead": _mutant([(62, "h-search"), (94, "sub")]),
        "untrue_long": _mutant([(54, "jmp-head"), (74, "jmp-head")]),
    }


def padded(gs):
    buf = np.zeros((len(gs), L), np.int8)
    lens = np.zeros(len(gs), np.int32)
    for i, g in enumerate(gs):
        buf[i, :len(g)] = g
        lens[i] = len(g)
    return buf, lens


def assert_results_equal(a, b, rows=None):
    for f in rtc.TestResult.__dataclass_fields__:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if rows is not None:
            y = y[rows]
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module")
def batch():
    rp, tp = both_params()
    names = list(genomes())
    buf, lens = padded(list(genomes().values()))
    stats = {}
    t = ttc.evaluate_genomes(tp, buf, lens, seed=4, time_mod=TIME_MOD,
                             device="cpu", stats=stats)
    r = rtc.evaluate_genomes(rp, buf, lens, seed=4, time_mod=TIME_MOD)
    return names, buf, lens, t, r, stats, tp


def test_evaluate_genomes_equals_reference(batch):
    """Every TestResult field of an 8-genome batch equal to the
    reference's; the ancestor's record is the golden one, and the untrue
    breeders ran the second and third generations."""
    names, _, _, t, r, stats, _ = batch
    assert_results_equal(t, r)
    assert stats["width"] == 8
    i = names.index("ancestor")
    assert int(t.gestation_time[i]) == 389 and float(t.merit[i]) == 97.0
    assert t.fitness[i] == 97.0 / 389.0 and bool(t.viable[i])
    assert int(t.task_counts[names.index("nand")][1]) == 1
    assert int(t.generations.max()) == 2
    assert not t.viable[names.index("knockout")]
    assert not t.viable[names.index("nop_ball")]


def test_bucket_padding_keeps_rows(batch):
    """A batch of 5 (padded to 8 lanes) scores its genomes exactly as
    the first 5 rows of the 8-genome batch; the bucket widths are the
    reference's."""
    _, buf, lens, t8, _, _, tp = batch
    stats = {}
    t5 = ttc.evaluate_genomes(tp, buf[:5], lens[:5], seed=4,
                              time_mod=TIME_MOD, device="cpu", stats=stats)
    assert stats["width"] == 8
    assert_results_equal(t5, t8, rows=slice(0, 5))
    for n in (1, 2, 3, 5, 8, 9, 100, 4096, 6000):
        assert ttc._bucket(n) == rtc._bucket(n)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_sandbox_inputs_equal_reference(seed):
    """Lane i's inputs from fold_in(key, i), for several widths; the
    port's key(seed) holds jax.random.key(seed)'s data."""
    jk = jax.random.key(seed)
    tk = prng.key(seed)
    assert np.asarray(jax.random.key_data(jk)).astype(np.int64).tolist() \
        == tk.tolist()
    for g in (1, 5, 64):
        r = np.asarray(rtc._sandbox_inputs(jk, g))
        t = ttc._sandbox_inputs(tk, g).numpy()
        assert r.dtype == t.dtype and r.tobytes() == t.tobytes()


def test_all_false_mask_step_is_identity(batch):
    """The cycles run in blocks of STOP_EVERY and the stop test is read
    once a block: a micro-step under an all-false mask -- on a
    mid-gestation state and on one with divided lanes -- changes no
    field, so the cycles of a block past the stop or past the largest
    budget change nothing; a 50-cycle budget runs 4 blocks."""
    _, buf, lens, _, _, _, tp = batch
    tp = tp.replace(copy_mut_prob=0.0, divide_mut_prob=0.0,
                    divide_ins_prob=0.0, divide_del_prob=0.0,
                    point_mut_prob=0.0)
    key = prng.key(9)
    g = torch.from_numpy(buf)
    ln = torch.from_numpy(lens)
    st = ttc._sandbox_state(tp, g, ln, key)
    for t in range(40):
        st = tinterp.micro_step(tp, st, prng.fold_in(key, t),
                                st.alive & ~st.divide_pending)
    st_div, *_ = ttc._run_gestation(tp, g, ln, TIME_MOD, key)
    assert bool(st_div.divide_pending.any())
    none = torch.zeros(g.shape[0], dtype=torch.bool)
    for s in (st, st_div):
        before = convert.state_to_arrays(s)
        after = convert.state_to_arrays(
            tinterp.micro_step(tp, s, prng.fold_in(key, 1000), none))
        for k, v in before.items():
            assert (v is None and after[k] is None) or \
                v.tobytes() == after[k].tobytes(), k
    stats = {}
    ttc._run_gestation(tp, g[1:2], torch.tensor([10], dtype=torch.int32),
                       TIME_MOD, key, stats)
    assert stats["cycles"] == 64 == 4 * ttc.STOP_EVERY


def test_trace_equals_reference(tmp_path):
    """trace_genome's snapshots (collect_trace's) and its file, byte for
    byte."""
    rp, tp = both_params()
    g = genomes()["nand"]
    snaps = ttrace.trace_genome(tp, INSTSET, g, str(tmp_path / "t.trace"),
                                max_cycles=100, seed=2, device="cpu")
    rsnaps = rtrace.trace_genome(rp, rconfig.default_instset(), g,
                                 str(tmp_path / "r.trace"), max_cycles=100,
                                 seed=2)
    assert snaps == rsnaps and len(snaps) == 100
    assert (tmp_path / "t.trace").read_bytes() == \
        (tmp_path / "r.trace").read_bytes()


def test_genome_test_metrics_equals_reference(batch):
    """get_records with repeats and cache hits: one lane per uncached
    row, duplicates included, records equal the reference's."""
    rp, tp = both_params()
    gs = genomes()
    rows = [gs["nop_ball"], gs["nand"], gs["nand"], gs["ancestor"],
            gs["nop_ball"], gs["ancestor"], gs["filler"]]
    buf, lens = padded(rows)
    tm, rm = TMetrics(tp, device="cpu"), RMetrics(rp)
    for sl in (slice(0, 3), slice(3, 7)):
        t = tm.get_records(buf[sl], lens[sl])
        r = rm.get_records(buf[sl], lens[sl])
        assert len(t) == len(r)
        for a, b in zip(t, r):
            assert a.keys() == b.keys()
            for k in a:
                assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
        assert tm.evaluations == rm.evaluations and len(tm) == len(rm)
    assert tm.evaluations == 6
    f = tm.get_fitness(buf, lens)
    assert f.dtype == np.float64
    assert f.tobytes() == rm.get_fitness(buf, lens).tobytes()
