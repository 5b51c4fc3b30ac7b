"""Deterministic fault injection (TPU_FAULT, utils/faultinject.py) against
avida_tpu's: the spec grammar over a list of specs (and its refusals),
the two device phases on the same state, the three checkpoint
corruptions on one port generation -- detected, and fallen back from,
by the port's resume as by the reference's -- and the process faults
(crash, sigkill, hang:sec=1) in a child process.

Inputs: random states from a seeded generator; a 4x4 port world
(RANDOM_SEED 2) checkpointing every 2 updates.

Tolerance: exact -- parsed faults, seeded draws, state fields, file
bytes and restored updates equal.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.config import AvidaConfig as RefConfig  # noqa: E402
from avida_tpu.utils import faultinject as rfi  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.utils import faultinject as tfi  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", [
    "crash", "crash@update=120", "sigkill@chunk=3", "hang", "hang:sec=5",
    "hang:5@update=2", "corrupt-ckpt", "corrupt-ckpt:leaf=fitness",
    "corrupt-ckpt:genome@update=8", "torn-manifest", "corrupt-digest",
    "nan@update=3", "nan:fitness,cell=4@update=7",
    "bitflip:merit,cell=5,bit=3@update=40", "bitflip:fitness,bit=31@update=1",
    "crash@update=9; torn-manifest ;nan:merit@update=2",
    # refused, with the reference's message
    "", "explode", "nan:merit", "nan:genome@update=3", "bitflip:merit",
    "bitflip:merit,bit=32@update=1", "crash:now", "torn-manifest@chunk=2",
    "hang:sec=soon", "crash@minute=3",
])
def test_parse_spec_equals_reference(spec):
    """parse_spec: each fault's kind, args, trigger and text and the
    first draws of its seeded stream, or the same error message."""
    def parse(mod):
        try:
            return [(f.kind, f.args, f.trigger, f.text,
                     [f.rng.random() for _ in range(3)])
                    for f in mod.parse_spec(spec, seed=7)]
        except ValueError as e:
            return ("error", str(e))
    assert parse(tfi) == parse(rfi)


@pytest.mark.parametrize("spec,cells", [
    ("nan:merit@update=3", 16), ("nan:fitness,cell=2@update=3", 16),
    ("bitflip:merit,cell=5,bit=3@update=3", 16),
    ("bitflip:fitness,bit=31@update=3", 9),
    ("bitflip:merit,cell=0@update=3", 9),
])
def test_device_phases_equal_reference(spec, cells):
    """nan_param / bitflip_param from a config, and nan_phase /
    bitflip_phase at the trigger update (and the identity one update
    off) on random merit and fitness leaves, word for word."""
    side = int(np.sqrt(cells))
    rc, tc = RefConfig(), convert.config_from_dict({})
    for c in (rc, tc):
        c.set("WORLD_X", side)
        c.set("WORLD_Y", side)
        c.set("TPU_FAULT", spec)
    kind = "nan" if spec.startswith("nan") else "bitflip"
    param = getattr(tfi, f"{kind}_param")(tc)
    assert param == getattr(rfi, f"{kind}_param")(rc) != ()
    rng = np.random.default_rng(cells)
    leaves = {n: rng.random(cells).astype(np.float32) * 100
              for n in ("merit", "fitness")}

    class St:
        def __init__(self, **kw):
            self.__dict__.update(kw)

        def replace(self, **kw):
            return St(**dict(self.__dict__, **kw))

    for update_no in (3, 4):
        ref = St(**{k: jnp.asarray(v) for k, v in leaves.items()})
        port = St(**{k: torch.from_numpy(v.copy()) for k, v in leaves.items()})
        params = type("P", (), {f"fault_{kind}": param})
        ref = getattr(rfi, f"{kind}_phase")(params, ref, jnp.int32(update_no))
        port = getattr(tfi, f"{kind}_phase")(params, port, update_no)
        for k in leaves:
            a, b = np.asarray(getattr(ref, k)), getattr(port, k).numpy()
            assert a.tobytes() == b.tobytes(), (update_no, k)
            if update_no == 4:
                assert b.tobytes() == leaves[k].tobytes()


@pytest.fixture(scope="module")
def saved_generations(tmp_path_factory):
    """A 4x4 port run to update 4 with a generation every 2 updates and
    the state digest in its manifests; the directory is copied per
    test."""
    base = tmp_path_factory.mktemp("faultck")
    vals = dict(WORLD_X=4, WORLD_Y=4, RANDOM_SEED=2, TPU_SYSTEMATICS=0,
                TPU_CKPT_DIR=str(base / "ck"), TPU_CKPT_EVERY=2,
                TPU_STATE_DIGEST=1, TPU_MAX_STRETCH=2)
    w = World(cfg=convert.config_from_dict(vals), device="cpu",
              data_dir=str(base / "run"))
    w.run(max_updates=4)
    return base / "ck", vals


@pytest.mark.parametrize("kind", ["corrupt-ckpt", "torn-manifest",
                                  "corrupt-digest"])
def test_checkpoint_corruptions_detected_as_reference(tmp_path,
                                                      saved_generations,
                                                      kind):
    """The port's corruption of the newest generation is the reference's
    byte for byte (one copy each, the same seeded stream), and on the
    damaged directory the port's resume and the reference's both reject
    it and fall back to update 2; through the World's save hook
    (`TPU_FAULT kind@update=4`) a run damages its own update-4 save the
    same way."""
    ck, vals = saved_generations
    gens = sorted(os.listdir(ck))
    assert len(gens) == 2
    copies = {}
    for side, mod in (("ref", rfi), ("port", tfi)):
        d = tmp_path / side
        shutil.copytree(ck, d)
        f = mod.parse_spec(kind, seed=3)[0]
        gen = str(d / gens[-1])
        if kind == "corrupt-ckpt":
            mod.corrupt_leaf(gen, "merit", f.rng)
        elif kind == "torn-manifest":
            mod.tear_manifest(gen, f.rng)
        else:
            mod.corrupt_digest(gen, f.rng)
        copies[side] = {p: (d / gens[-1] / p).read_bytes()
                        for p in os.listdir(d / gens[-1])}
    assert copies["ref"] == copies["port"]
    cfg = RefConfig()
    for k, v in vals.items():
        cfg.set(k, v)
    ref = RefWorld(cfg=cfg, data_dir=str(tmp_path / "rr"))
    assert ref.resume(str(tmp_path / "port")) == 2
    port = World(cfg=convert.config_from_dict(vals), device="cpu",
                 data_dir=str(tmp_path / "pr"))
    assert port.resume(str(tmp_path / "port")) == 2
    # the World's save hook
    hooked = dict(vals, TPU_CKPT_DIR=str(tmp_path / "hook"),
                  TPU_FAULT=f"{kind}@update=4")
    w = World(cfg=convert.config_from_dict(hooked), device="cpu",
              data_dir=str(tmp_path / "hrun"))
    w.run(max_updates=4)
    fresh = World(cfg=convert.config_from_dict(hooked), device="cpu",
                  data_dir=str(tmp_path / "hres"))
    assert fresh.resume() == 2


_CHILD = ["-u", "6", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
          "-set", "TPU_SYSTEMATICS", "0", "-set", "TPU_MAX_STRETCH", "2",
          "--device", "cpu"]


@pytest.mark.parametrize("spec,rc,needle", [
    ("crash@update=2", 1, "FaultInjected: injected crash at update 2"),
    ("sigkill@chunk=2", -9, ""),
    ("hang:sec=1@update=2", 0, "fault_injected: kind=hang"),
])
def test_process_faults_in_a_child(tmp_path, spec, rc, needle):
    """The boundary kinds act on the process that asked for them: a
    crash raises FaultInjected out of the run (exit 1), sigkill kills it
    (no output of the run's end), hang:sec=1 stalls a second and the run
    finishes."""
    env = dict(os.environ, TPU_FAULT=spec, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "avida_tpu_torch"] + _CHILD
                         + ["-d", str(tmp_path / "d")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == rc, res.stderr[-2000:]
    assert needle in res.stderr
    finished = '"updates": 6' in res.stdout
    assert finished == (rc == 0)
    if spec.startswith("hang"):
        assert time.perf_counter() - t0 > 1.0
