"""Systematics and the default World.run: the port's GenotypeArbiter
against the reference's on the same feed, and the port's World with
TPU_SYSTEMATICS=1 (the per-update engine, the newborn ring and the
deferred host drain) against the reference's.  The reference runs its
per-update engine with the Pallas kernel in interpret mode on one shard.

Tolerance: exact -- arbiter records equal field by field, PopulationState
equal byte for byte at every chunk boundary, and the .dat files
(dominant.dat and the genotype columns of count.dat / average.dat
included) byte-identical apart from the header's date line.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu.ops import packed_chunk as rpk  # noqa: E402
from avida_tpu.systematics import GenotypeArbiter as RefArbiter  # noqa: E402
from avida_tpu.systematics import Genotype as RefGenotype  # noqa: E402

from avida_tpu_torch.systematics import GenotypeArbiter  # noqa: E402

from test_torch_world import _pair, _assert_same_state  # noqa: E402

DATS = ("average", "count", "tasks", "time", "dominant")

VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=3, AVE_TIME_SLICE=30,
            TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1, TPU_COMPILE_CACHE=0)


# ---- the arbiter on a synthetic feed ----

def _feed(seed, n_cells=24, updates=40, L=16):
    """Seeded (update, alive, cells, genomes, lens, parents) groups: a few
    genome families with point changes, deaths and reuse of cells."""
    rng = np.random.default_rng(seed)
    fams = rng.integers(0, 6, (4, L)).astype(np.int8)
    alive = np.zeros(n_cells, bool)
    alive[:3] = True
    out = []
    for u in range(updates):
        k = int(rng.integers(0, 6))
        cells = np.sort(rng.choice(n_cells, k, replace=False)).astype(np.int64)
        parents = rng.integers(0, n_cells, k).astype(np.int32)
        genomes = fams[rng.integers(0, 4, k)].copy()
        mut = rng.random(k) < 0.3
        genomes[mut, rng.integers(0, L, k)[mut]] = rng.integers(0, 6, mut.sum())
        lens = rng.integers(L - 3, L + 1, k).astype(np.int32)
        alive[cells] = True
        alive[rng.random(n_cells) < 0.08] = False
        out.append((u, alive.copy(), cells, genomes, lens, parents))
    return out


def _records(arb):
    names = [f.name for f in dataclasses.fields(RefGenotype)
             if f.name != "sequence"]
    return (sorted(tuple(getattr(g, k) for k in names)
                   + (g.sequence.tobytes(),)
                   for g in arb.genotypes.values()),
            arb.cell_gid.tolist(), arb.num_births_total, arb._next_id)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arbiter_equals_reference(seed):
    """The same seeding and birth feed through both arbiters, with a
    prune every ten groups: every genotype record, the cell map and the
    summaries agree."""
    ref, port = RefArbiter(24), GenotypeArbiter(24)
    g0 = np.arange(16, dtype=np.int8) % 6
    for arb in (ref, port):
        arb.classify_seed_all(g0, update=0)
        arb.classify_seed(5, g0[::-1].copy(), update=0)
    for i, (u, alive, cells, genomes, lens, parents) in enumerate(
            _feed(seed)):
        for arb in (ref, port):
            arb.process(u, alive, cells, genomes, lens, parents)
            if i % 10 == 9:
                arb.prune_extinct(keep_ancestry=i % 20 == 9)
        assert _records(ref) == _records(port), u
        assert ref.num_genotypes == port.num_genotypes
        assert ref.num_threshold == port.num_threshold
        assert ref.average_depth() == port.average_depth()
        a, b = ref.dominant(), port.dominant()
        assert (a is None) == (b is None)
        if a is not None:
            assert a.gid == b.gid


# ---- the default World.run ----

def _assert_same_dats(tmp_path, names=DATS):
    for name in names:
        with open(tmp_path / "ref" / f"{name}.dat") as f:
            a = f.read().splitlines()
        with open(tmp_path / "port" / f"{name}.dat") as f:
            b = f.read().splitlines()
        assert len(a) == len(b) > 0, name
        assert a[1].startswith("# ") and b[1].startswith("# ")   # dates
        assert a[:1] + a[2:] == b[:1] + b[2:], name


def _run_ladder(tmp_path, vals, every, stops):
    events = ["u begin InjectAll"] + [
        f"u 0:{every}:end Print{d.capitalize()}Data" for d in DATS]
    ref, port = _pair(tmp_path, vals, events)
    assert rpk.ineligible_reason(ref.params, True) is not None
    report = port.engine_report()
    assert report["engine"] == "per-update"
    assert report["fallback_reason"] == rpk.ineligible_reason(ref.params,
                                                              True)
    for u in stops:
        n_ref = ref.run(max_updates=u)
        n_port = port.run(max_updates=u)
        assert n_ref == n_port, u
        assert ref.update == port.update == u
        _assert_same_state(ref, port, u)
        assert ref.systematics.num_genotypes \
            == port.systematics.num_genotypes, u
    _assert_same_dats(tmp_path)
    assert int(port._total_births) == int(ref._total_births)
    return int(port._total_births), port


def test_world_run_systematics_equals_reference(tmp_path):
    """The reference's default experiment at 6x6: stretches of 8 (the
    systematics cap), the state compared at every chunk boundary, the five
    .dat files byte for byte."""
    births, port = _run_ladder(tmp_path, VALS, 8, (8, 16))
    assert births > 0
    assert port.systematics.num_genotypes >= 1


def test_world_run_point_mutations_equals_reference(tmp_path):
    """The per-update engine's point-mutation sweep (POINT_MUT_PROB > 0,
    taken only there) under systematics, with events every 3 updates:
    stretches of 2 (the deferred drain) alternate with single updates
    (the pending snapshot flushed, then the synchronous drain)."""
    vals = dict(VALS, POINT_MUT_PROB=0.01, RANDOM_SEED=5)
    births, port = _run_ladder(tmp_path, vals, 3, (9, 18))
    assert births > 0
    assert port.systematics.num_genotypes > 1     # mutants were classified


@pytest.mark.slow
def test_world_run_systematics_long(tmp_path):
    """8x8 for 200 updates: several generations, the 100-update prune and
    births across every chunk boundary."""
    vals = dict(VALS, WORLD_X=8, WORLD_Y=8, RANDOM_SEED=21)
    births, port = _run_ladder(tmp_path, vals, 16,
                               tuple(range(40, 201, 40)))
    assert births > 3 * 64


def test_init_population_allocates_the_ring():
    """With TPU_SYSTEMATICS on (the default) the newborn ring holds
    2 x WORLD_X x WORLD_Y rows, field for field as in the reference."""
    import jax
    from avida_tpu import config as rconfig
    from avida_tpu.config.environment import default_logic9_environment
    from avida_tpu.core import state as rstate
    from avida_tpu_torch import convert
    from avida_tpu_torch.config import default_instset
    from avida_tpu_torch.config.environment import (
        default_logic9_environment as t_env)
    from avida_tpu_torch.core import state as tstate
    from avida_tpu_torch.utils import prng
    vals = dict(WORLD_X=5, WORLD_Y=4, RANDOM_SEED=2)
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(),
                                  default_logic9_environment())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  default_instset(), t_env())
    assert rp.nb_cap == tp.nb_cap == 40
    g = np.arange(50, dtype=np.int8) % 26
    rs = rstate.init_population(rp, g, jax.random.key(1))
    ts = tstate.init_population(tp, g, prng.key(1))
    got = convert.state_to_arrays(ts)
    for k in rstate.state_field_names():
        a = getattr(rs, k)
        if a is None:
            assert got[k] is None, k
            continue
        a = np.asarray(a)
        assert a.shape == got[k].shape and a.dtype == got[k].dtype, k
        assert a.tobytes() == got[k].tobytes(), k
    assert got["nb_genome"].shape == (40, tp.max_memory)


def test_cli_default_equals_reference(tmp_path):
    """`python -m avida_tpu_torch` with no TPU_SYSTEMATICS override runs
    the reference's default (systematics on) and writes the same .dat
    files as `python -m avida_tpu -set TPU_USE_PALLAS 1` with the same
    seed and config directory."""
    import contextlib
    import io
    import json
    from avida_tpu.__main__ import main as ref_main
    from avida_tpu_torch.__main__ import main as port_main
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "avida.cfg").write_text("INST_SET -\nWORLD_X 6\nWORLD_Y 6\n"
                                    "AVE_TIME_SLICE 30\n")
    (cdir / "events.cfg").write_text(
        "u begin InjectAll\n" + "".join(
            f"u 0:4:end Print{d.capitalize()}Data\n" for d in DATS))
    common = ["-c", str(cdir), "-s", "9", "-u", "16",
              "-set", "TPU_KERNEL_SHARDS", "1",
              "-set", "TPU_COMPILE_CACHE", "0"]
    assert ref_main(common + ["-d", str(tmp_path / "ref"),
                              "-set", "TPU_USE_PALLAS", "1"]) in (0, None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(common + ["-d", str(tmp_path / "port"),
                                   "--device", "cpu"]) == 0
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rep["engine"]["engine"] == "per-update"
    assert rep["updates"] == 16
    _assert_same_dats(tmp_path)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_avida_time_sum_order(k):
    """The per-stretch avida-time increment sums its float32 vector in
    the reference's order (time.dat's column), not exactly rounded."""
    import jax.numpy as jnp
    from avida_tpu_torch.utils.prng import xla_f32_sum
    rng = np.random.default_rng(k)
    for _ in range(50):
        x = (rng.random(k) * 0.02).astype(np.float32)
        want = np.asarray(jnp.asarray(x).sum())
        got = xla_f32_sum(torch.from_numpy(x)).numpy()
        assert want.tobytes() == got.tobytes()
