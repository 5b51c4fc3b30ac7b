"""The port's serving batch (parallel/multiworld.ServeBatch, the
`--serve-worlds` CLI, observability/exporter.ServeExporter) against
avida_tpu's, on the CPU.

  * the churn of the reference's test_serve_batch_ghost_rider_demotion
    through both packages' ServeBatch on the micro-step engine
    (TPU_USE_PALLAS 2): a W = 4 class padded from 3 live tenants, a rider
    queued at boundary 1 and promoted into the slot of a tenant demoted
    at boundary 2, every tenant at its own update;
  * the serve SDC demotion of the reference's tests/test_integrity.py:
    one tenant's live chunk corrupted, that tenant demoted alone with its
    suspect generations quarantined, its classmate serving on;
  * `--serve-worlds` with a missing and a zero-width control (exit 2);
  * the port alone: a demoted tenant and the ghost template own their
    tensors (no view of the batch), every ghost slot equals the template
    after every chunk, on the kernel route (TPU_USE_PALLAS 1: the plain
    version of the stacked launch, K3b) a class with a rider whose
    tenants equal the port's own solo runs on that route, and the
    classes MultiWorld refuses (demes, experimental hardware, K2 with
    S > 1) refused by name.

Tolerance: exact -- each tenant's state field by field, its host
counters (avida time included: both packages cut the same chunks), its
.dat files byte for byte apart from the header's date line, every
generation byte for byte (manifest.json apart from saved_at), serve.json
apart from `time`, `compiles` and `cache_loads` (the reference counts
its XLA traces and cache loads, the port its nvcc builds), and
metrics.prom / multiworld.prom values apart from the heartbeat
timestamps and the program-cache families (avida_compile_cache_*,
avida_serve_compiles_total).  Against solo runs, a rider's host avida
time is held with np.isclose: its chunk grid differs from its solo
run's (the reference's own caveat).
"""

import json
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.events import \
    parse_event_line as r_parse  # noqa: E402
from avida_tpu.observability.exporter import \
    read_metrics as rread_metrics  # noqa: E402
from avida_tpu.parallel import multiworld as rmw  # noqa: E402
from avida_tpu.utils import integrity as rinteg  # noqa: E402
from avida_tpu.world import World as RWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config.events import \
    parse_event_line as t_parse  # noqa: E402
from avida_tpu_torch.core.state import state_field_names  # noqa: E402
from avida_tpu_torch.observability.exporter import \
    read_metrics as tread_metrics  # noqa: E402
from avida_tpu_torch.parallel import multiworld as tmw  # noqa: E402
from avida_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from avida_tpu_torch.utils import integrity as tinteg  # noqa: E402
from avida_tpu_torch.world import World as TWorld  # noqa: E402

U = 5
SEEDS = {"m0": 3, "m1": 11, "m2": 29, "m3": 41}
EVENTS = ("u begin InjectAll", "u 0:4:end PrintAverageData",
          "u 0:4:end PrintCountData")
# one chunk length (TPU_MAX_STRETCH 1) and one world shape for every
# reference run here, so the reference compiles its batched scan once
VALS = dict(WORLD_X=8, WORLD_Y=8, TPU_MAX_MEMORY=256, AVE_TIME_SLICE=70,
            TPU_CKPT_AUDIT=0, TPU_CKPT_EVERY=2, TPU_MAX_STRETCH=1,
            TPU_CKPT_FINAL=1,
            TPU_METRICS=1, TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0,
            TPU_USE_PALLAS=2)
# the program-cache families: the reference counts XLA traces and loads
UNCOMPARED = ("avida_serve_compiles_total",
              "avida_heartbeat_timestamp_seconds")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_world(vals, seed, data_dir, ck=None):
    cfg = rconfig.AvidaConfig()
    for k, v in dict(vals, RANDOM_SEED=seed).items():
        cfg.set(k, v)
    if ck:
        cfg.set("TPU_CKPT_DIR", str(ck))
    w = RWorld(cfg=cfg, data_dir=str(data_dir))
    w.events = [r_parse(e) for e in EVENTS]
    return w


def _port_world(vals, seed, data_dir, ck=None):
    v = dict(vals, RANDOM_SEED=seed)
    if ck:
        v["TPU_CKPT_DIR"] = str(ck)
    w = TWorld(cfg=convert.config_from_dict(v), data_dir=str(data_dir),
               device="cpu")
    w.events = [t_parse(e) for e in EVENTS]
    return w


PKG = {"ref": (_ref_world, rmw.ServeBatch, rread_metrics, rinteg),
       "port": (_port_world, tmw.ServeBatch, tread_metrics, tinteg)}


def _arrays(w):
    if isinstance(w, TWorld):
        return convert.state_to_arrays(w.state)
    return {k: (None if getattr(w.state, k) is None
                else np.asarray(getattr(w.state, k)))
            for k in state_field_names()}


def _dat_bodies(d):
    out = {}
    for f in sorted(os.listdir(d)):
        if not f.endswith(".dat"):
            continue
        with open(os.path.join(d, f)) as fh:
            lines = fh.read().splitlines()
        assert lines[1].startswith("# ")           # the date line
        out[f] = lines[:1] + lines[2:]
    return out


def _generations(ck):
    """Every generation under a checkpoint dir: {name: {file: bytes}},
    manifest.json parsed without saved_at."""
    out = {}
    for g in tckpt.list_generations(str(ck)):
        files = {}
        for fn in sorted(os.listdir(g)):
            with open(os.path.join(g, fn), "rb") as f:
                b = f.read()
            if fn == tckpt.MANIFEST:
                m = json.loads(b)
                m.pop("saved_at")
                files[fn] = m
            else:
                files[fn] = b
        out[os.path.basename(g)] = files
    return out


def _metrics(read, path):
    return {k: v for k, v in read(str(path)).items()
            if not k.startswith(UNCOMPARED)
            and not k.startswith("avida_compile_cache_")}


def _tenant(w):
    a = _arrays(w)
    return {"state": {k: (None if v is None else (v.dtype.str, v.shape,
                                                  v.tobytes()))
                      for k, v in a.items()},
            "update": int(w.update),
            "births": int(np.asarray(w._total_births)),
            "avida_time": float(np.asarray(w._avida_time)),
            "ave_gen": float(np.asarray(w._last_ave_gen)),
            "insts": w._flush_exec(),
            "genotypes": (None if w.systematics is None else sorted(
                g.sequence.tobytes()
                for g in w.systematics.live_genotypes())),
            "dats": _dat_bodies(w.data_dir)}


def _write_control(path, members, width=4, shutdown=False):
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"width": width, "shutdown": shutdown,
                   "members": members}, f)
    os.replace(tmp, str(path))


def _entry(root, name, seeds=SEEDS, u=U, ckpt=True):
    return {"name": name, "seed": seeds[name],
            "data_dir": str(root / name / "d"),
            "ckpt_dir": str(root / name / "ck") if ckpt else None,
            "max_updates": u}


def serve_churn(pkg, root, vals=VALS, seeds=SEEDS, u=U,
                first=("m0", "m1", "m2"), then=("m0", "m2", "m3"),
                ckpt=True, after_chunk=None):
    """The reference test's churn through one package's ServeBatch:
    W = 4 from `first` (m0, m1, m2); at boundary 1 the control becomes
    `then` (m1 dropped, m3 added), so the boundary-2 reconcile demotes
    m1 and promotes m3 into its slot at m3's update 0; shutdown once
    every tenant of `then` is done.  `after_chunk(sb, k)` runs after
    every chunk."""
    make, Serve, read, integ = PKG[pkg]
    integ.reset_for_tests()
    built = {}

    def factory(entry):
        name = entry["name"]
        if name == "__ghost__":
            return make(vals, 0, entry["data_dir"])
        w = make(vals, seeds[name], entry["data_dir"], entry["ckpt_dir"])
        built[name] = w
        return w

    os.makedirs(root, exist_ok=True)
    ctl = root / "control.json"
    _write_control(ctl, [_entry(root, n, seeds, u, ckpt) for n in first])
    sb = Serve(4, str(ctl), str(root / "root"), world_factory=factory)
    later = [_entry(root, n, seeds, u, ckpt) for n in then]

    def hook(s):
        if s.boundaries == 1:
            _write_control(ctl, later)

    def idle_sleep(sec):
        if not sb._live() and all(
                sb.finished.get(n, {}).get("state") == "done"
                for n in then):
            _write_control(ctl, later, shutdown=True)
        time.sleep(0.001)

    sb._boundary_hook = hook
    sb._sleep = idle_sleep
    if after_chunk is not None:
        scan = sb._scan

        def traced(k):
            scan(k)
            after_chunk(sb, k)
        sb._scan = traced
    sb.serve()
    status = json.load(open(root / "root" / "serve.json"))
    for k in ("time", "compiles", "cache_loads"):
        status.pop(k)
    return sb, built, {
        "tenants": {n: _tenant(w) for n, w in sorted(built.items())},
        "generations": {n: _generations(root / n / "ck") for n in seeds},
        "status": json.loads(json.dumps(status).replace(str(root), "<r>")),
        "metrics": _metrics(read, root / "root" / "metrics.prom"),
        "multiworld": _metrics(read, root / "root" / "multiworld.prom"),
        "counters": [sb.admissions, sb.retirements, sb.boundaries,
                     sb.num_ghosts, [float(x) for x in np.asarray(
                         sb._trips.cpu() if hasattr(sb._trips, "cpu")
                         else sb._trips)]]}


def _ghosts_unchanged(checked):
    """after_chunk: every ghost slot of the port's batch equals the
    template, leaf for leaf, byte for byte."""
    def check(sb, k):
        tpl = convert.state_to_arrays(sb._ghost_state)
        got = convert.state_to_arrays(sb.bstate)
        for i, w in enumerate(sb.slots):
            if w is None:
                for f, a in tpl.items():
                    assert a is None or got[f][i].tobytes() == a.tobytes(), \
                        (k, i, f)
                checked.append(i)
    return check


def _owns(st, where):
    for f in state_field_names():
        t = getattr(st, f)
        if t is not None:
            assert t.untyped_storage().nbytes() \
                == t.numel() * t.element_size(), (where, f)


def test_serve_churn_equals_reference(tmp_path):
    """The churn through both packages' ServeBatch: the same tenants
    (state, counters, phylogeny, .dat files), the same generations in
    every tenant's checkpoint dir, the same serve.json, metrics.prom and
    multiworld.prom; the port's ghost slots equal the template after
    every chunk, its demoted tenant and its template own their
    tensors."""
    checked = []
    ref = serve_churn("ref", tmp_path / "ref")[2]
    sb, built, port = serve_churn("port", tmp_path / "port",
                                  after_chunk=_ghosts_unchanged(checked))
    assert port["counters"][:4] == [4, 4, 4, 4]
    assert 3 in checked and port["generations"]["m1"]
    for key in ("status", "metrics", "multiworld", "counters"):
        assert port[key] == ref[key], key
    for n in SEEDS:
        assert port["generations"][n] == ref["generations"][n], n
        assert port["tenants"][n] == ref["tenants"][n], n
    _owns(built["m1"].state, "demoted m1")
    _owns(built["m0"].state, "retired m0")
    _owns(sb._ghost_state, "ghost template")


def test_serve_cli_rejects_bad_control(tmp_path):
    """`--serve-worlds` with a missing control and with a width of 0:
    exit 2 in both packages."""
    from avida_tpu.__main__ import main as rmain

    from avida_tpu_torch.__main__ import main as tmain
    bad = tmp_path / "ctl.json"
    bad.write_text('{"width": 0, "members": []}')
    for argv in (["--serve-worlds", str(tmp_path / "nope.json")],
                 ["--serve-worlds", str(bad)]):
        assert tmain(argv + ["--device", "cpu"]) == rmain(argv) == 2


@pytest.mark.parametrize("name,value,needle", [
    ("NUM_DEMES", "4", "pools or demes"),
    ("INST_SET", "experimental", "experimental spatial hardware"),
    ("TPU_KERNEL_SHARDS", "2", "TPU_KERNEL_SHARDS")])
def test_serve_batch_refuses_what_the_batch_refuses(tmp_path, capsys, name,
                                                    value, needle):
    """A class whose worlds hold demes, run experimental hardware or ask
    for K2 with S > 1 is refused by name, as MultiWorld refuses it:
    ServeBatch raises and `--serve-worlds` exits 2 with the reason."""
    from avida_tpu_torch.__main__ import main
    ctl = tmp_path / "ctl.json"
    _write_control(ctl, [], width=2)
    over = [(name, value), ("PRED_PREY_SWITCH", "0")]
    with pytest.raises(NotImplementedError, match=needle):
        tmw.ServeBatch(2, str(ctl), str(tmp_path / "root"), overrides=over,
                       device="cpu")
    capsys.readouterr()
    argv = ["--serve-worlds", str(ctl), "--device", "cpu"]
    for n, v in over:
        argv += ["-set", n, v]
    assert main(argv) == 2
    assert needle in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the serve SDC demotion (the reference's tests/test_integrity.py)
# ---------------------------------------------------------------------------

# the churn's configuration (its compiled programs serve here too) with
# every chunk digested and replayed
SDC_VALS = dict(VALS, TPU_STATE_DIGEST=1, TPU_SCRUB_EVERY=1)
SDC_SEEDS = {"t0": 7, "t1": 8}


def _flip_ref(bst):
    word = jax.lax.bitcast_convert_type(
        bst.merit[0, 3], jax.numpy.uint32) ^ jax.numpy.uint32(1)
    return bst.replace(merit=bst.merit.at[0, 3].set(
        jax.lax.bitcast_convert_type(word, bst.merit.dtype)))


def _flip_port(bst):
    merit = bst.merit.clone()
    merit.view(torch.int32)[0, 3] ^= 1
    return bst.replace(merit=merit)


def serve_sdc(pkg, root, monkeypatch):
    """Two tenants at W = 4, every chunk of one update scrubbed: a clean
    chunk with a generation after it, then tenant t0's live result of
    the second corrupted (one bit of one merit) while its shadow replay
    runs clean; then one more chunk for t1."""
    make, Serve, read, integ = PKG[pkg]
    integ.reset_for_tests()
    os.makedirs(root)
    ctl = root / "control.json"
    _write_control(ctl, [_entry(root, n, SDC_SEEDS, U) for n in SDC_SEEDS])
    built = {}

    def factory(entry):
        if entry["name"] == "__ghost__":
            return make(SDC_VALS, 0, entry["data_dir"])
        w = make(SDC_VALS, SDC_SEEDS[entry["name"]], entry["data_dir"],
                 entry["ckpt_dir"])
        built[entry["name"]] = w
        return w

    sb = Serve(4, str(ctl), str(root / "serve"), world_factory=factory)
    assert sb._scrub_every == 1
    sb._reconcile()
    assert sb.num_live == 2
    sb._stack()
    sb._scan(1)
    sb._sync_worlds()
    for i, w in sb._live():
        w.save_checkpoint()
    sb._stack()
    assert sb._verified[:2] == [1, 1]
    armed = {"n": 1}
    if pkg == "ref":
        from avida_tpu.utils import compilecache
        real = compilecache.call

        def corrupting(fn, tag, args, **kw):
            out = real(fn, tag, args, **kw)
            if tag == "multiworld_scan" and armed["n"]:
                armed["n"] -= 1
                return _flip_ref(out[0]), out[1]
            return out
        monkeypatch.setattr(compilecache, "call", corrupting)
    else:
        real = tmw.multiworld_scan

        def corrupting(*args):
            out = real(*args)
            if armed["n"]:
                armed["n"] -= 1
                return _flip_port(out[0]), out[1]
            return out
        monkeypatch.setattr(tmw, "multiworld_scan", corrupting)
    sb._scan(1)
    monkeypatch.undo()
    counters = integ.counters()
    assert counters["mismatches"] == 1
    assert sb.finished["t0"]["state"] == "sdc"
    assert sb.finished["t0"]["last_verified_update"] == 1
    assert sb.num_live == 1 and sb.names.count("t1") == 1
    sb._scan(1)
    sb._sync_worlds()
    (_, w1), = sb._live()
    assert w1.update == 3
    with open(root / "serve" / "integrity.jsonl") as f:
        records = [json.loads(line) for line in f]
    return built, {
        "finished": sb.finished, "t1": _tenant(w1),
        "generations": {n: _generations(root / n / "ck") for n in SDC_SEEDS},
        "counters": {k: v for k, v in counters.items() if k != "digest_ms"},
        "records": records}


def test_serve_sdc_demotes_corrupt_tenant_alone(tmp_path, monkeypatch):
    """The serving guarantee through both packages: a silent corruption
    in ONE tenant's live chunk demotes that tenant alone (outcome "sdc",
    its generations past its verified update quarantined: the one at 1
    stays) while its classmate serves on; the same outcome, the same
    scrub and digest records, the same generations and the same
    classmate to the bit."""
    ref = serve_sdc("ref", tmp_path / "ref", monkeypatch)[1]
    built, port = serve_sdc("port", tmp_path / "port", monkeypatch)
    assert [tckpt.generation_update(g) for g in tckpt.list_generations(
        built["t0"]._ckpt_base())] == [1]
    _owns(built["t0"].state, "demoted t0")
    assert port == ref


# ---------------------------------------------------------------------------
# the port's kernel route: a rider on the stacked launch's plain version
# ---------------------------------------------------------------------------

KU = 4
K_SEEDS = {"p0": 5, "p1": 9, "p2": 23}
K_VALS = dict(VALS, TPU_USE_PALLAS=1, AVE_TIME_SLICE=30, TPU_CKPT_EVERY=1,
              TPU_MAX_STRETCH=0)


def test_kernel_route_rider_equals_solo_runs(tmp_path):
    """TPU_USE_PALLAS 1 (the stacked launch, K3b, in its plain version on
    the CPU; systematics on, the batched per-update engine): two tenants
    and a rider queued at boundary 1 and admitted at boundary 2, at its
    update 0 beside classmates at 2, in a W = 4 class; every tenant
    equals its solo run on the same route (state field by field, births,
    instructions, phylogeny; avida time with np.isclose, its chunk grid
    being the serve loop's), and every ghost slot equals the template
    after every chunk."""
    from avida_tpu_torch.ops import cycles
    checked = []
    cycles.reset_launches()
    sb, built, snap = serve_churn(
        "port", tmp_path / "serve", vals=K_VALS, seeds=K_SEEDS, u=KU,
        first=("p0", "p1"), then=("p0", "p1", "p2"), ckpt=False,
        after_chunk=_ghosts_unchanged(checked))
    assert cycles.use_kernel(sb.params)
    assert cycles.LAUNCHES == 0             # the plain version: no launch
    assert snap["counters"][:2] == [3, 3] and 3 in checked
    for name, seed in K_SEEDS.items():
        solo = _port_world(K_VALS, seed, tmp_path / "solo" / name)
        solo.run(max_updates=KU)
        a, b = _tenant(solo), snap["tenants"][name]
        assert np.isclose(a.pop("avida_time"), b.pop("avida_time")), name
        assert a == b, name
