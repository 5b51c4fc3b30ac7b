"""The integrity plane and the invariant audit in the port: ops/digest.py
(torch, on the state's device), utils/integrity.py (the numpy mirror),
utils/audit.py, and World's digest, scrub and audit hooks -- against the
reference's ops/digest.state_digest / state_digest_batched,
utils/integrity.digest_arrays and utils/audit.audit_state.

Tolerance: exact -- the same u32 digests and the same per-invariant
violation counts.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.core.state import PopulationState as RefState  # noqa: E402
from avida_tpu.ops import digest as rdigest  # noqa: E402
from avida_tpu.utils import audit as raudit  # noqa: E402
from avida_tpu.utils import integrity as rintegrity  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import digest as tdigest  # noqa: E402
from avida_tpu_torch.utils import audit as taudit  # noqa: E402
from avida_tpu_torch.utils import integrity  # noqa: E402
from avida_tpu_torch.utils import checkpoint as ckpt_mod  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=7, AVE_TIME_SLICE=30,
            TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0, TPU_USE_PALLAS=1,
            TPU_SYSTEMATICS=0)
_EVOLVED = {}


def _evolved():
    """A 6x6 world, every cell seeded, run 6 updates on the port's packed
    engine (plain version): dividing organisms, negative int8 genome
    bytes after mutation and float phenotypes."""
    if not _EVOLVED:
        w = World(cfg=convert.config_from_dict(VALS), device="cpu")
        w.events = []
        w.add_event("u begin InjectAll")
        w.run(max_updates=6)
        _EVOLVED["w"] = w
        _EVOLVED["arrays"] = convert.state_to_arrays(w.state)
    return _EVOLVED["w"], _EVOLVED["arrays"]


def _ref_state(arrays):
    return RefState(**{k: (None if v is None else jnp.asarray(v))
                       for k, v in arrays.items()})


def _special(arrays):
    """The evolved arrays with NaN payloads, infinities, -0.0 and negative
    int8 bytes planted."""
    a = {k: (None if v is None else v.copy()) for k, v in arrays.items()}
    bits = np.array([0x7FC00001, 0xFFBFFFFF, 0x7F800000, 0x80000000],
                    np.uint32)
    a["merit"][:4] = bits.view(np.float32)
    a["genome"][0, :5] = [-1, -128, 127, 5, -7]
    a["read_label"][1, :3] = [-3, -4, 2]
    return a


@pytest.mark.parametrize("special", [False, True])
def test_digest_equals_reference_and_mirror(special):
    """The torch digest of a state equals the reference's jitted
    state_digest and the numpy mirror, with NaN payloads, infinities,
    -0.0 and negative int8 bytes among the leaves."""
    _, arrays = _evolved()
    if special:
        arrays = _special(arrays)
    want = int(rdigest.state_digest(_ref_state(arrays)))
    got = int(tdigest.state_digest(convert.state_from_arrays(arrays)))
    assert got == want
    assert integrity.digest_arrays(arrays) == want
    assert rintegrity.digest_arrays(
        {k: v for k, v in arrays.items() if v is not None}) == want


def test_digest_order_stable():
    """Swapping two elements of a leaf, or moving a value between leaves,
    changes the digest."""
    _, arrays = _evolved()
    d0 = int(tdigest.state_digest(convert.state_from_arrays(arrays)))
    a = {k: (None if v is None else v.copy()) for k, v in arrays.items()}
    a["merit"][[0, 1]] = a["merit"][[1, 0]] + np.float32(1)
    d1 = int(tdigest.state_digest(convert.state_from_arrays(a)))
    b = {k: (None if v is None else v.copy()) for k, v in arrays.items()}
    b["mem_len"][3] += 1
    d2 = int(tdigest.state_digest(convert.state_from_arrays(b)))
    assert len({d0, d1, d2}) == 3


def test_digest_batched_equals_reference():
    """A W = 3 batch: [W] digests equal to the reference's vmapped digest
    and to each member's solo digest."""
    _, arrays = _evolved()
    members = [arrays, _special(arrays),
               {k: (None if v is None else np.roll(v, 1, axis=0)
                    if v.ndim else v) for k, v in arrays.items()}]
    stacked = {k: (None if arrays[k] is None
                   else np.stack([m[k] for m in members]))
               for k in arrays}
    want = [int(x) for x in np.asarray(
        rdigest.state_digest_batched(_ref_state(stacked)))]
    bst = convert.batched_state_from_arrays(stacked)
    got = tdigest.state_digest_batched(bst).tolist()
    assert got == want
    assert got == [int(tdigest.state_digest(tstate.world_state(bst, i)))
                   for i in range(3)]
    assert len(set(got)) == 3


def _ref_params():
    from avida_tpu import config as rconfig
    from avida_tpu.world import World as RefWorld
    cfg = rconfig.AvidaConfig()
    for k, v in VALS.items():
        cfg.set(k, v)
    return RefWorld(cfg=cfg, data_dir=None).params


_BREAK = {
    "merit_finite": lambda a: a["merit"].__setitem__(0, np.nan),
    "fitness_finite": lambda a: a["fitness"].__setitem__(1, -1.0),
    "bonus_finite": lambda a: a["cur_bonus"].__setitem__(2, np.inf),
    "ip_in_bounds": lambda a: a["heads"].__setitem__((3, 0), 10_000),
    "heads_in_bounds": lambda a: a["heads"].__setitem__((4, 2), -1),
    "genome_len_range": lambda a: a["genome_len"].__setitem__(5, 2),
    "mem_len_range": lambda a: a["mem_len"].__setitem__(6, 0),
    "genome_ops_valid": lambda a: a["genome"].__setitem__((7, 0), 63),
    "input_ptr_nonneg": lambda a: a["input_ptr"].__setitem__(8, -1),
    "stack_ptr_range": lambda a: a["sp"].__setitem__((9, 1), 10),
    "generation_nonneg": lambda a: a["generation"].__setitem__(10, -2),
    "time_nonneg": lambda a: a["cpu_cycles"].__setitem__(11, -1),
    "budget_carry_range": lambda a: a["budget_carry"].__setitem__(12, -5),
    "dead_lane_granted": lambda a: (a["alive"].__setitem__(13, False),
                                    a["budget_carry"].__setitem__(13, 5)),
    "lane_perm_bijective": lambda a: a["lane_perm"].__setitem__(0, 1),
    "lane_inv_inverse": lambda a: a["lane_inv"].__setitem__(2, 5),
    "off_window_valid": lambda a: (a["divide_pending"].__setitem__(14, True),
                                   a["off_len"].__setitem__(14, -3)),
    "nb_count_nonneg": lambda a: a["nb_count"].__setitem__((), -1),
}


@pytest.mark.parametrize("broken", [None] + sorted(_BREAK))
def test_audit_counts_equal_reference(broken):
    """audit_state's per-invariant counts equal the reference's on the
    evolved state (all zero) and on a state broken for each invariant
    in turn."""
    w, arrays = _evolved()
    a = {k: (None if v is None else v.copy()) for k, v in arrays.items()}
    if broken is not None:
        _BREAK[broken](a)
    want = {k: int(v) for k, v in
            raudit.audit_state(_ref_params(), _ref_state(a)).items()}
    got = {k: int(v) for k, v in
           taudit.audit_state(w.params, convert.state_from_arrays(a)).items()}
    assert got == want
    if broken is None:
        assert not any(got.values())
        taudit.check_invariants(w.params, convert.state_from_arrays(a))
    else:
        assert got[broken] > 0
        with pytest.raises(taudit.StateInvariantError, match=broken):
            taudit.check_invariants(w.params, convert.state_from_arrays(a))


def _world(tmp_path, **extra):
    w = World(cfg=convert.config_from_dict(dict(VALS, **extra)),
              data_dir=str(tmp_path / "d"), device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    return w


def test_digest_in_manifest_and_integrity_log(tmp_path):
    """TPU_STATE_DIGEST=1: each boundary's digest reaches integrity.jsonl,
    the checkpoint manifest carries the state digest, equal to the device
    digest of the live state and to the numpy recomputation."""
    w = _world(tmp_path, TPU_STATE_DIGEST=1, TPU_MAX_STRETCH=2,
               TPU_CKPT_DIR=str(tmp_path / "ck"), TPU_CKPT_FINAL=1)
    w.run(max_updates=4)
    gen = ckpt_mod.list_generations(str(tmp_path / "ck"))[-1]
    stored, recomputed = integrity.generation_digest(gen)
    live = int(tdigest.state_digest(w.state))
    assert stored == recomputed == live
    assert w.state_digest == (4, live)
    recs = [json.loads(ln) for ln in open(tmp_path / "d" /
                                          integrity.INTEGRITY_LOG)]
    assert [r["update"] for r in recs if r["event"] == "digest"] == [2, 4]
    assert recs[-1]["digest"] == f"{live:#010x}"


def test_scrub_replay_equals_live_and_catches_divergence(tmp_path,
                                                         monkeypatch):
    """TPU_SCRUB_EVERY=1: every chunk is replayed from its pre-chunk state
    and the digests agree; a live chunk that differs from its replay
    raises StateDivergenceError naming the updates."""
    w = _world(tmp_path / "a", TPU_SCRUB_EVERY=1, TPU_MAX_STRETCH=2)
    n0 = integrity.counters()["scrubs"]
    w.run(max_updates=4)
    assert integrity.counters()["scrubs"] - n0 == 2
    assert w._last_verified_update == 4
    recs = [json.loads(ln) for ln in open(tmp_path / "a" / "d" /
                                          integrity.INTEGRITY_LOG)]
    assert [r["ok"] for r in recs if r["event"] == "scrub"] == [True, True]

    from avida_tpu_torch import world as world_mod
    real = world_mod.update_scan
    calls = []

    def flaky(params, st, k, key, u0, *rest):
        st, outs = real(params, st, k, key, u0, *rest)
        calls.append(u0)
        if len(calls) == 3:          # the second chunk's live run
            st = st.replace(merit=st.merit + 1.0)
        return st, outs

    monkeypatch.setattr(world_mod, "update_scan", flaky)
    v = _world(tmp_path / "b", TPU_SCRUB_EVERY=1, TPU_MAX_STRETCH=2)
    with pytest.raises(integrity.StateDivergenceError,
                       match=r"updates \[2, 4\)"):
        v.run(max_updates=4)
    assert v._last_verified_update == 2


def test_audit_every_trips_on_corruption(tmp_path, monkeypatch):
    """TPU_AUDIT_EVERY audits at chunk boundaries; a save audits first
    (TPU_CKPT_AUDIT, default 1) and refuses a broken state."""
    w = _world(tmp_path, TPU_AUDIT_EVERY=2, TPU_MAX_STRETCH=2)
    w.run(max_updates=4)
    w.state = w.state.replace(merit=torch.where(
        torch.arange(36) == 3, torch.tensor(float("nan")), w.state.merit))
    with pytest.raises(taudit.StateInvariantError, match="merit_finite"):
        w.run(max_updates=6)
    with pytest.raises(taudit.StateInvariantError, match="merit_finite"):
        w.save_checkpoint(str(tmp_path / "ck"))
    assert not os.path.exists(tmp_path / "ck")
