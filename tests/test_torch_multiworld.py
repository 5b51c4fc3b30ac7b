"""Multi-world batching: the port's stacked launch (cycles.run_packed_stacked)
and batched scan (ops/update.update_scan_batched) against the reference's
(pallas_cycles.run_packed_stacked in interpret mode, multiworld_scan with
TPU_USE_PALLAS 1 on one shard), and the port's MultiWorld against its own
solo World.run, member by member, on both engines.

Tolerance: exact -- planes, states and output vectors byte for byte,
accumulators equal, .dat files byte-identical apart from the header's
date line.

The plain cycle version issues many small tensor operations; these tests
run them on one intra-op thread (restored afterwards), which is several
times faster on small worlds and computes the same values.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.environment import (  # noqa: E402
    default_logic9_environment as r_env)
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.ops import birth as rbirth  # noqa: E402
from avida_tpu.ops import pallas_cycles as rpc  # noqa: E402
from avida_tpu.parallel.multiworld import multiworld_scan  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.ops import packed_chunk as tpk  # noqa: E402
from avida_tpu_torch.ops import update as tupd  # noqa: E402
from avida_tpu_torch.parallel.multiworld import MultiWorld  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

CAP = 2**31 - 1
VALS = dict(WORLD_X=6, WORLD_Y=6, AVE_TIME_SLICE=30, TPU_KERNEL_SHARDS=1,
            TPU_USE_PALLAS=1, TPU_COMPILE_CACHE=0)
DATS = ("average", "count", "tasks", "time", "dominant")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(vals):
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  default_instset(), t_env())
    return rp, tp


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _world(vals, seed, data_dir=None, events=("u begin InjectAll",)):
    w = World(cfg=convert.config_from_dict(dict(vals, RANDOM_SEED=seed)),
              data_dir=data_dir, device="cpu")
    w.events = []
    for e in events:
        w.add_event(e)
    return w


def _ref_batched(bst):
    return rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v))
        for k, v in convert.state_to_arrays(bst).items()})


def _assert_batched_equal(ref_bst, bst, where=""):
    got = convert.state_to_arrays(bst)
    for k in rstate.state_field_names():
        a = getattr(ref_bst, k)
        assert (a is None and got[k] is None) or _eq(a, got[k]), (where, k)


def _assert_states_equal(a, b, where=""):
    sa, sb = convert.state_to_arrays(a), convert.state_to_arrays(b)
    for k in sa:
        assert (sa[k] is None and sb[k] is None) or _eq(sa[k], sb[k]), \
            (where, k)


# ---- K3b: one stacked launch ----

def test_stacked_launch_equals_reference():
    """W = 2 worlds' planes stacked world-major (two 128-lane blocks), each
    world with its own grant row and k_steps key: the port's stacked launch
    (plain version) equals pallas_cycles.run_packed_stacked in interpret
    mode plane for plane, and each world's slice equals its own solo
    launch.  A high copy-mutation rate makes every world's stream visible
    in its tapes."""
    vals = dict(VALS, COPY_MUT_PROB=0.2, TPU_SYSTEMATICS=0)
    rp, tp = _params(vals)
    rng = np.random.default_rng(4)
    quads, keys_r = [], []
    for w, seed in enumerate((3, 8)):
        st = _world(vals, seed)
        st.process_events()
        g = torch.from_numpy(rng.integers(20, 90, tp.num_cells).astype(
            np.int32))
        quads.append(tpc.pack_state(tp, st.state, g))
        keys_r.append(jax.random.fold_in(jax.random.key(seed), 5 + w))
    n = tp.num_cells
    B, n_pad, _ = tpc.dims(tp, n, tp.max_memory)
    flat = tuple(torch.cat([q[j] for q in quads], dim=1) for j in range(4))
    rk = jnp.stack(keys_r)
    keys_t = convert.keys_from_data(jax.random.key_data(rk))
    out_r = rpc.run_packed_stacked(rp, tuple(jnp.asarray(p.numpy())
                                             for p in flat),
                                   rpc.world_seed_bases(rk), CAP, B)
    seeds = tpc.world_seed_bases(keys_t)
    assert _eq(rpc.world_seed_bases(rk), seeds)
    assert int(seeds[0]) != int(seeds[1])
    tpc.run_packed_stacked(tp, flat, seeds, CAP, B)
    for a, b in zip(out_r, flat):
        assert _eq(a, b)
    for w, q in enumerate(quads):
        tpc.launch(tp, q, keys_t[w], CAP, n)
        for a, b in zip(q, flat):
            assert torch.equal(a, b[:, w * n_pad:(w + 1) * n_pad]), w
    # both worlds ran, each on its own stream
    for q in quads:
        assert int((q[2][tpc.IV_INSTS_EXEC, :n] > 0).sum()) > n // 2


def test_stacked_launch_refusals():
    _, tp = _params(dict(VALS, TPU_SYSTEMATICS=0))
    planes = tuple(torch.zeros((r, 384), dtype=dt) for r, dt in (
        (96, torch.int32), (96, torch.int32),
        (tpc.layout(tp, 384)[0], torch.int32), (8, torch.float32)))
    with pytest.raises(ValueError, match="whole 128-lane blocks"):
        tpc.run_packed_stacked(tp, planes, torch.zeros(2, dtype=torch.int32),
                               CAP, 128)
    with pytest.raises(NotImplementedError, match="TPU_KERNEL_SHARDS=2"):
        tpc.run_packed_stacked(tp.replace(kernel_shards=2), planes,
                               torch.zeros(3, dtype=torch.int32), CAP, 128)


# ---- the batched scan against the reference ----

@pytest.fixture(scope="module")
def evolved_batch(tmp_path_factory):
    """Two 6x6 worlds (seeds 3, 8) with systematics on, run 12 updates as a
    port batch: parents mid-gestation and dividing, newborn rings live."""
    vals = dict(VALS, TPU_SYSTEMATICS=1)
    td = tmp_path_factory.mktemp("evolved")
    mw = MultiWorld([_world(vals, s, str(td / f"w{s}")) for s in (3, 8)])
    mw.run(max_updates=12)
    assert mw.engine == "per-update"
    return tstate.stack_states([w.state for w in mw.worlds]), \
        torch.stack([w._run_key for w in mw.worlds])


def _without_ring(bst, tp):
    """The batched state with the empty newborn ring of TPU_SYSTEMATICS=0
    (the packed engine's precondition), nothing else changed."""
    empty = tstate.init_population(tp, np.zeros(8, np.int8),
                                   torch.zeros(2, dtype=torch.int64))
    W = bst.alive.shape[0]
    return bst.replace(**{
        k: torch.stack([getattr(empty, k)] * W)
        for k in ("nb_genome", "nb_len", "nb_cell", "nb_parent",
                  "nb_update", "nb_count")})


@pytest.mark.parametrize("engine", ["per-update", "packed"])
def test_update_scan_batched_equals_reference(evolved_batch, engine):
    """W = 2, 6x6, 4 updates from update 12 (births in the window): the
    port's update_scan_batched equals the reference's multiworld_scan on
    the same batched state and run keys -- every state field and all seven
    [W, 4] output vectors, trips included."""
    sysm = 1 if engine == "per-update" else 0
    rp, tp = _params(dict(VALS, TPU_SYSTEMATICS=sysm))
    bst, keys = evolved_batch
    if not sysm:
        bst = _without_ring(bst, tp)
    assert tpk.batch_active(tp, bst) == (engine == "packed")
    rb = _ref_batched(bst)
    rkeys = jax.random.wrap_key_data(jnp.asarray(keys.numpy().astype(
        np.uint32)))
    nb = jnp.asarray(rbirth.neighbor_table(6, 6, 2))
    rb2, routs = multiworld_scan(rp, rb, 4, rkeys, nb, jnp.int32(12))
    tpc.reset_launches()
    tb2, touts = tupd.update_scan_batched(tp, bst, 4, keys, 12)
    _assert_batched_equal(rb2, tb2, engine)
    assert len(touts) == len(routs) == 7
    for a, b in zip(routs, touts):
        assert _eq(a, b)
        assert b.shape == (2, 4)
    births = np.asarray(routs[1])
    assert births.sum() > 0
    assert tpc.LAUNCHES == 0          # the plain version on the CPU


def test_batched_state_round_trip(evolved_batch):
    bst, keys = evolved_batch
    arrays = convert.state_to_arrays(bst)
    back = convert.batched_state_from_arrays(arrays)
    _assert_states_equal(bst, back)
    bad = dict(arrays, alive=arrays["alive"][:1])
    with pytest.raises(ValueError, match="leading world axes"):
        convert.batched_state_from_arrays(bad)
    assert torch.equal(convert.keys_from_data(keys.numpy()), keys)


# ---- MultiWorld against the port's solo World.run ----

W3_SEEDS = (3, 11, 29)
W3_VALS = dict(WORLD_X=8, WORLD_Y=8, AVE_TIME_SLICE=30)
U = 17            # chunk grid 8 + 8 + 1: the single-update drain stamp


def _w3_events(sysm):
    return ["u begin InjectAll"] + [
        f"u 0:4:end Print{d.capitalize()}Data"
        for d in DATS if sysm or d != "dominant"]


def _dat_bodies(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f)) as fh:
            lines = fh.read().splitlines()
        assert lines[1].startswith("# ")           # the date line
        out[f] = lines[:1] + lines[2:]
    return out


def _assert_member_equals_solo(solo, mem, where):
    _assert_states_equal(solo.state, mem.state, where)
    for attr in ("_avida_time", "_last_ave_gen", "_deaths_this",
                 "_total_births"):
        a, b = getattr(solo, attr), getattr(mem, attr)
        assert float(a) == float(b), (where, attr)
    assert solo._flush_exec() == mem._flush_exec(), where
    assert solo.update == mem.update
    assert _dat_bodies(solo.data_dir) == _dat_bodies(mem.data_dir), where
    if solo.systematics is not None:
        assert solo.systematics.num_genotypes \
            == mem.systematics.num_genotypes, where
        assert sorted(g.sequence.tobytes()
                      for g in solo.systematics.live_genotypes()) \
            == sorted(g.sequence.tobytes()
                      for g in mem.systematics.live_genotypes()), where


@pytest.mark.parametrize("engine", ["per-update", "packed"])
def test_multiworld_members_equal_solo_runs(tmp_path, engine):
    """W = 3 on 8x8 for 17 updates: each member equals its solo World.run
    -- state, the four accumulators, instructions, .dat bytes (dominant.dat
    with systematics) and the live genotypes -- with exactly one kernel
    launch per update for the batch."""
    sysm = 1 if engine == "per-update" else 0
    vals = dict(W3_VALS, TPU_SYSTEMATICS=sysm)
    ev = _w3_events(sysm)
    solo = []
    for s in W3_SEEDS:
        w = _world(vals, s, str(tmp_path / f"solo{s}"), ev)
        w.run(max_updates=U)
        solo.append(w)
    mw = MultiWorld([_world(vals, s, str(tmp_path / f"mw{s}"), ev)
                     for s in W3_SEEDS])
    n = mw.run(max_updates=U)
    assert mw.engine == ("packed-stacked" if engine == "packed"
                         else "per-update")
    assert mw.update == U and mw._trips_updates == U
    assert 0.0 < mw.trip_efficiency() <= 1.0
    assert n == sum(w._flush_exec() for w in solo)
    for i, (a, b) in enumerate(zip(solo, mw.worlds)):
        _assert_member_equals_solo(a, b, (engine, i))
        assert int(b._total_births) > 0
    assert int(mw.worlds[0].state.alive.sum()) == mw.worlds[0].num_organisms


def test_multiworld_single_world_equals_solo(tmp_path):
    """W = 1 is the solo run (systematics on, 9 updates: 8 + 1)."""
    vals = dict(VALS, TPU_SYSTEMATICS=1)
    ev = _w3_events(1)
    solo = _world(vals, 5, str(tmp_path / "solo"), ev)
    solo.run(max_updates=9)
    mw = MultiWorld([_world(vals, 5, str(tmp_path / "mw"), ev)])
    mw.run(max_updates=9)
    _assert_member_equals_solo(solo, mw.worlds[0], "W=1")


def test_last_lane_birth_no_cross_talk():
    """On the stacked packed planes, a parent in the LAST lane of world 0
    (its torus neighbours wrap to the world's first row and column, beside
    world 1's first lanes in the stacked layout) gets 12x merit and
    divides in the window: the batch equals the two solo scans bit for
    bit, so the birth stayed inside world 0 and world 1 was untouched.
    (The per-update engine flushes each world's own state object.)  The
    worlds run at their own update numbers (u0 = [0, 2]): keys and birth
    stamps follow each world's own counter."""
    vals = dict(VALS, TPU_SYSTEMATICS=0)
    _, tp = _params(vals)
    n = tp.num_cells

    def start(seed):
        w = _world(vals, seed)
        w.process_events()
        m = w.state.merit.clone()
        m[n - 1] = m[n - 1] * 12.0
        return w, w.state.replace(merit=m)

    K, u0 = 3, (0, 2)
    solo, sts, keys = [], [], []
    for s, u in zip((3, 8), u0):
        w, st = start(s)
        solo.append(tupd.update_scan(tp, st, K, w._run_key, u)[0])
        sts.append(st)
        keys.append(w._run_key)
    assert tpk.batch_active(tp, tstate.stack_states(sts))
    bst, outs = tupd.update_scan_batched(
        tp, tstate.stack_states(sts), K, torch.stack(keys),
        torch.tensor(u0))
    for i in range(2):
        _assert_states_equal(solo[i], tstate.world_state(bst, i), i)
    w0, w1 = tstate.world_state(bst, 0), tstate.world_state(bst, 1)
    assert bool(((w0.parent_id == n - 1) & (w0.birth_update >= 0)).any())
    born1 = w1.birth_update[w1.birth_update >= 0]
    assert born1.numel() > 0 and int(born1.min()) >= 2   # its own stamps
    assert outs[-1].shape == (2, K)


# ---- refusals ----

def test_multiworld_refusals(tmp_path):
    vals = dict(VALS, TPU_SYSTEMATICS=0)
    a = _world(vals, 1, str(tmp_path / "a"))
    with pytest.raises(ValueError, match="at least one"):
        MultiWorld([])
    with pytest.raises(ValueError, match="identical static"):
        MultiWorld([a, _world(dict(vals, WORLD_X=10), 2,
                              str(tmp_path / "b"))])
    b = _world(vals, 2, str(tmp_path / "c"), ("u 5 Exit",))
    with pytest.raises(ValueError, match="shared event schedule"):
        MultiWorld([a, b])
    c = _world(vals, 1, str(tmp_path / "e"), ("g 0:10 PrintAverageData",))
    d = _world(vals, 2, str(tmp_path / "f"), ("g 0:10 PrintAverageData",))
    with pytest.raises(ValueError, match="chunkable"):
        MultiWorld([c, d])
    with pytest.raises(ValueError, match="own config"):
        MultiWorld([a, a])
    with pytest.raises(ValueError, match="share a data_dir"):
        MultiWorld([a, _world(vals, 2, str(tmp_path / "a"))])
    late = _world(vals, 3, str(tmp_path / "g"))
    late.update = 4
    with pytest.raises(ValueError, match="disagree on the current update"):
        MultiWorld([a, late])
    # unported: checkpoints, K2 with S > 1; the stacked launch refuses a
    # configuration routed to the micro-step engine
    with pytest.raises(NotImplementedError, match="checkpoints"):
        MultiWorld.from_seeds([1, 2], overrides=list(vals.items()),
                              data_dir=str(tmp_path / "s"),
                              ckpt_dir=str(tmp_path / "ck"), device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoints"):
        MultiWorld.from_seeds(
            [1, 2], overrides=list(vals.items())
            + [("TPU_CKPT_DIR", str(tmp_path / "ck"))],
            data_dir=str(tmp_path / "s"), device="cpu")
    mw = MultiWorld([a, _world(vals, 2, str(tmp_path / "h"))])
    with pytest.raises(NotImplementedError, match="item 11"):
        mw.resume()
    with pytest.raises(NotImplementedError, match="item 11"):
        mw.save_checkpoints()
    a.process_events()
    with pytest.raises(ValueError, match="micro-step engine"):
        tupd.mw_stack_kernel_cycles(
            a.params.replace(use_pallas=2), [a.state],
            [torch.zeros(2, dtype=torch.int64)],
            [torch.zeros(a.params.num_cells, dtype=torch.int32)], CAP)
    x, y = (_world(vals, s, str(tmp_path / f"k{s}")) for s in (1, 2))
    for w in (x, y):          # World itself refuses the knob; set it after
        w.params = w.params.replace(kernel_shards=2)
    with pytest.raises(NotImplementedError, match="TPU_KERNEL_SHARDS=2"):
        MultiWorld([x, y])
    mp = tmp_path / "ck.json"
    mp.write_text(json.dumps([{"seed": 1, "data_dir": str(tmp_path / "m"),
                               "ckpt_dir": str(tmp_path / "mck")}]))
    with pytest.raises(NotImplementedError, match="checkpoints"):
        MultiWorld.from_manifest(str(mp), overrides=list(vals.items()),
                                 device="cpu")


# ---- the --worlds CLI ----

def _cli(argv):
    from avida_tpu_torch.__main__ import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_worlds_cli_seed_list_and_manifest(tmp_path):
    """`--worlds 5,6` writes DATA_DIR/w000 and w001, and w000's .dat files
    equal the solo CLI run with seed 5; a manifest names its own dirs; a
    refused batch, --resume and --serve-worlds exit 2."""
    common = ["-u", "4", "-set", "WORLD_X", "6", "-set", "WORLD_Y", "6",
              "-set", "TPU_SYSTEMATICS", "0", "--device", "cpu"]
    rc, rep = _cli(["--worlds", "5,6", "-d", str(tmp_path / "b")] + common)
    assert rc == 0
    assert rep["worlds"] == 2 and rep["updates"] == 4
    assert rep["engine"] == "packed-stacked"
    assert rep["names"] == ["w000", "w001"]
    assert len(rep["organisms"]) == len(rep["insts"]) == 2
    rc, solo = _cli(["-s", "5", "-d", str(tmp_path / "solo")] + common)
    assert rc == 0 and solo["insts"] == rep["insts"][0]
    assert _dat_bodies(tmp_path / "solo") == _dat_bodies(tmp_path / "b"
                                                         / "w000")
    assert os.listdir(tmp_path / "b" / "w001")

    man = tmp_path / "worlds.json"
    man.write_text(json.dumps([
        {"name": "left", "seed": 5, "data_dir": str(tmp_path / "left")},
        {"name": "right", "seed": 7, "data_dir": str(tmp_path / "right")}]))
    rc, rep = _cli(["--worlds", str(man)] + common)
    assert rc == 0 and rep["names"] == ["left", "right"]
    assert _dat_bodies(tmp_path / "left") == _dat_bodies(tmp_path / "b"
                                                         / "w000")

    assert _cli(["--worlds", str(tmp_path / "nope.json")] + common)[0] == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"seed": "x", "data_dir": "d"}]))
    assert _cli(["--worlds", str(bad)] + common)[0] == 2
    assert _cli(["--worlds", "1,2", "-set", "TPU_CKPT_DIR",
                 str(tmp_path / "ck")] + common)[0] == 2
    assert _cli(["--resume"] + common)[0] == 2
    assert _cli(["--worlds", "1,2", "--resume"] + common)[0] == 2
    assert _cli(["--serve-worlds", str(man)] + common)[0] == 2


# ---- longer ladders against the reference's MultiWorld.run ----

@pytest.mark.slow
@pytest.mark.parametrize("engine", ["per-update", "packed"])
def test_multiworld_run_equals_reference_long(tmp_path, engine):
    """W = 2 on 6x6 for 120 updates against the reference's MultiWorld.run
    (interpret-mode kernel): member states at every 40-update boundary and
    the .dat files; past update 100 for the phylogeny prune."""
    from avida_tpu.config import AvidaConfig
    from avida_tpu.config.events import parse_event_line
    from avida_tpu.parallel.multiworld import MultiWorld as RefMultiWorld
    from avida_tpu.world import World as RefWorld
    sysm = 1 if engine == "per-update" else 0
    vals = dict(VALS, TPU_SYSTEMATICS=sysm)
    ev = ["u begin InjectAll"] + [
        f"u 0:20:end Print{d.capitalize()}Data"
        for d in DATS if sysm or d != "dominant"]
    refs = []
    for s in (3, 8):
        cfg = AvidaConfig()
        for k, v in dict(vals, RANDOM_SEED=s).items():
            cfg.set(k, v)
        rw = RefWorld(cfg=cfg, data_dir=str(tmp_path / f"ref{s}"))
        rw.events = [parse_event_line(e) for e in ev]
        refs.append(rw)
    ref = RefMultiWorld(refs, data_dir=str(tmp_path / "refroot"))
    port = MultiWorld([_world(vals, s, str(tmp_path / f"port{s}"), ev)
                       for s in (3, 8)])
    for u in (40, 80, 120):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        for i in range(2):
            got = convert.state_to_arrays(port.worlds[i].state)
            for k in rstate.state_field_names():
                a = getattr(ref.worlds[i].state, k)
                assert (a is None and got[k] is None) or _eq(a, got[k]), \
                    (u, i, k)
            if sysm:
                assert ref.worlds[i].systematics.num_genotypes \
                    == port.worlds[i].systematics.num_genotypes, (u, i)
    for s in (3, 8):
        assert _dat_bodies(tmp_path / f"ref{s}") \
            == _dat_bodies(tmp_path / f"port{s}")
