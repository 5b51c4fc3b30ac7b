"""The 5-bit genome shadow plane (TPU_PACKED_BITS=1) on the packed
chunk: the codec's pack and unpack, the flush's bridge from the
offspring plane and its prefix mask against the reference's helpers;
the routing and engine report (more than 32 instructions fall back by
name); and a tiny world on the kernel route against the reference's
interpret mode and against the same run with the 8-bit plane.

Tolerance: exact -- planes and state fields byte for byte, the .dat
files equal apart from the header's date line.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.ops import birth as rbirth  # noqa: E402
from avida_tpu.ops import packed_chunk as rpk  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402
from avida_tpu_torch.ops import packed_chunk as tpk  # noqa: E402

from test_torch_world import (DATS, VALS, _assert_same_dats,  # noqa: E402
                              _assert_same_state, _pair)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("L", [100, 301])
def test_plane5_bridge_and_mask_equal_reference(L):
    """_pk_to_plane5 on a byte word plane of opcodes < 32, and
    _pk5_prefix_mask at every prefix length."""
    rng = np.random.default_rng(L)
    n, LP = 24, -(-L // 4)
    ops = rng.integers(0, 32, (LP * 4, n)).astype(np.uint8)
    words = ops.reshape(LP, 4, n).astype(np.uint32)
    plane = (words[:, 0] | words[:, 1] << 8 | words[:, 2] << 16
             | words[:, 3] << 24)
    L5 = -(-LP * 4 // 6)
    want = rbirth._pk_to_plane5(jnp.asarray(plane.view(np.int32)), L5)
    got = tbirth._pk_to_plane5(torch.from_numpy(plane.astype(np.int64)), L5)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()
    hi = rng.integers(0, L + 1, n).astype(np.int32)
    want = rbirth._pk5_prefix_mask(L5, jnp.asarray(hi))
    got = tbirth._pk5_prefix_mask(L5, torch.from_numpy(hi))
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_routing_and_engine_report_equal_reference(tmp_path):
    """bits_ineligible_reason and engine_report word for word: off, on,
    and on but refused past 32 instructions (the 8-bit plane runs)."""
    from test_torch_cycles_semantics import _both_params, _instset_file
    from test_torch_cycles_semantics import HEADS
    names = HEADS + HEADS[:10]             # 36 opcodes
    for bits, nm in ((0, HEADS), (1, HEADS), (1, names)):
        path = _instset_file(tmp_path / f"i{bits}{len(nm)}.cfg", nm, {})
        rp, tp = _both_params(path, dict(
            VALS, TPU_PACKED_BITS=bits, TPU_COMPILE_CACHE=0))
        assert tpk.bits_ineligible_reason(tp) == \
            rpk.bits_ineligible_reason(rp)
        want = rpk.engine_report(rp)
        assert tpk.engine_report(tp) == want
        assert tpk.unported_reason(tp) is None
        assert want["packed_bits"] == int(bits == 1 and nm is HEADS)


def test_pack_unpack_round_trip(tmp_path):
    """pack_chunk keeps ceil(L/6) words a lane, and unpack_chunk gives
    back the genome bytes."""
    from avida_tpu_torch.world import World
    w = World(cfg=convert.config_from_dict(dict(VALS, TPU_PACKED_BITS=1)),
              device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    w.process_events()
    rng = np.random.default_rng(3)
    g = w.state.genome.clone()
    g[:, :90] = torch.from_numpy(rng.integers(0, 26, (g.shape[0], 90)).astype(
        np.int8))
    st = w.state.replace(genome=g)
    pc = tpk.pack_chunk(w.params, st)
    assert pc.gen_t.shape[0] == -(-pc.tape_t.shape[0] * 4 // 6)
    assert torch.equal(tpk.unpack_chunk(w.params, pc).genome, g)


def test_packed_bits_world_equals_reference_and_8_bit_plane(tmp_path):
    """A 6x6 world on the kernel route with TPU_PACKED_BITS=1 (the
    reference in interpret mode): every field and the .dat files equal
    the reference's at each chunk boundary, births included, and the
    state at the first boundary equals the 8-bit plane's run."""
    from avida_tpu_torch.world import World
    events = ["u begin InjectAll"] + [
        f"u 0:8:end Print{d.capitalize()}Data" for d in DATS]
    ref, port = _pair(tmp_path, dict(VALS, TPU_PACKED_BITS=1), events)
    port8 = World(cfg=convert.config_from_dict(VALS), device="cpu",
                  data_dir=str(tmp_path / "b8"))
    port8.events = port.events
    for u in (8, 16):
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        _assert_same_state(ref, port, u)
        if u == 8:
            port8.run(max_updates=8)
            _assert_same_state(port8, port, "8-bit")
    _assert_same_dats(tmp_path)
    assert int(port._total_births) == int(ref._total_births) > 0
    assert port.engine_report()["packed_bits"] == 1
    assert port8.engine_report()["packed_bits"] == 0
