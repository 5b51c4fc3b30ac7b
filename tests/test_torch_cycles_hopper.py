"""The Hopper cycle kernel's host side (avida_tpu_torch/csrc/cycles.cu via
ops/cycles.py): its launch geometry, a numpy mirror of its shift-and
h-search held to the plain version's scan of start positions, the parser
of ptxas's resource report, and the build digest.  These run without a
card or nvcc; the kernel itself is held to the plain version on the card
(tests/test_torch_cycles.py's cuda test, chip_smoke.py).

Tolerance: exact (integers).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from avida_tpu_torch.models.heads import MAX_LABEL_SIZE
from avida_tpu_torch.ops import cycles as tpc

TAPE_HEIGHTS = tuple(range(tpc.CHUNK, 4097, tpc.CHUNK))
REACTIONS = (0, 1, 9, 16, 32, 33, 77)


@pytest.mark.parametrize("B", [128, 256, 512])
def test_cta_geometry_fits_the_card(B):
    """For every tape height dims can give up to 4096 sites and up to 77
    reactions: C divides B into at most 8 CTAs (one portable cluster),
    the CTA's shared memory fits 232,448 bytes, two CTAs fit one SM's
    228 KB wherever the whole tile of L <= 512 is staged, and every shape
    past 1024 sites or 32 reactions takes two CTAs an SM."""
    for L in TAPE_HEIGHTS:
        assert tpc.dims(None, 1, L)[2] == L
        for R in REACTIONS:
            plan = tpc.cta_plan(L, R, B)
            C, smem = plan.C, plan.smem_bytes
            assert C % 32 == 0 and C <= 128 and B % C == 0, (L, R, C)
            assert B // C <= 8, (L, R, C)
            assert smem <= 232_448, (L, R, C, smem)
            if L <= 512 and R <= 32:
                assert plan.stage == 0, (L, R, plan)
                assert 2 * (smem + 1024) <= 233_472, (L, R, C, smem)
            if L > 1024 or R > 32:
                assert plan.per_sm == 2, (L, R, plan)
                assert 2 * (smem + 1024) <= 233_472, (L, R, C, smem)


def test_cta_geometry_of_the_paths():
    """The launches chip_smoke.py drives: 320x320 and 60x60 worlds (B =
    512, L = 384, logic-9's 9 reactions) take C = 128 in clusters of 4,
    about 97 KB a CTA; the largest tile before tape heights past 1024
    (L = 1024) takes C = 64 in a cluster of 8; small worlds keep one
    reference block a CTA -- all with the whole tile staged.  Past it,
    at the least level that lets two CTAs share an SM: 320x320 at L =
    2048 with logic-77 keeps its counters and tape in device memory (C =
    128), as does L = 4096 (C = 64); the small logic-77 worlds keep only
    their counters there (C = 32), and 1088 sites with 33 reactions at B
    = 128 stage everything."""
    assert tpc.dims(None, 320 * 320, 384)[0] == 512
    assert tpc.cta_plan(384, 9, 512)[:2] == (128, 0)
    assert 95_000 < tpc.cta_plan(384, 9, 512).smem_bytes < 101_000
    assert tpc.cta_plan(1024, 9, 512)[:2] == (64, 0)
    assert tpc.cta_plan(1024, 32, 512)[:2] == (64, 0)
    assert tpc.cta_plan(384, 9, 128)[:2] == (128, 0)
    assert tpc.cta_plan(384, 9, 256)[:2] == (128, 0)
    # rows: tape words, read label + stacks, two bitplanes, 4R counters
    assert tpc.staged_rows(384, 9, 0) == 96 + 30 + 24 + 36
    assert tpc.cta_plan(2048, 77, 512)[:2] == (128, 2)
    assert tpc.cta_plan(2048, 77, 512).per_sm == 2
    assert tpc.cta_plan(2048, 77, 512).staged() == (
        "label_stacks", "site_flags", "reaction_table")
    assert tpc.cta_plan(4096, 9, 512)[:2] == (64, 2)
    assert tpc.cta_plan(4096, 9, 512).per_sm == 2
    assert tpc.cta_plan(1088, 33, 128)[:2] == (32, 0)
    assert tpc.cta_plan(2048, 77, 256)[:2] == (32, 1)
    assert tpc.cta_plan(2048, 77, 128)[:2] == (32, 1)
    # a forced level (chip_smoke.py's checks): the widest C that fits
    # it, two CTAs an SM where they fit, else one; none for a level too
    # small
    forced = tpc.cta_plan(2048, 77, 512, _force_stage=1)
    assert (forced.C, forced.stage, forced.per_sm) == (64, 1, 1)
    with pytest.raises(ValueError, match="staging level 0"):
        tpc.cta_plan(2048, 77, 512, _force_stage=0)
    # level 3 stages 30 rows: any tape, any reaction count has a plan
    assert tpc.cta_plan(65536, 9, 512).stage == 3
    assert tpc.cta_plan(64, 4000, 512).stage == 3


def _codes(tape, cls_of_byte, L):
    """The plain version's code array: a byte's class, 3 past the tape."""
    codes = np.full(L + MAX_LABEL_SIZE, 3, np.int64)
    codes[:L] = cls_of_byte[tape]
    return codes


def shift_and(tape, cls_of_byte, label, mlen):
    """numpy mirror of csrc/cycles.cu's h-search: the first position p <
    mlen that ends a match of `label` (codes 0-2), or None.  D's bit k is
    set at p where label[:k + 1] spells the codes ending at p; the tape is
    read one 32-bit word (four positions) at a time, as the kernel does."""
    masks = [0, 0, 0, 0]
    for k, c in enumerate(label):
        masks[c] |= 1 << k
    hit = 1 << (len(label) - 1)
    words = tape.view(np.uint32)
    D = 0
    for w in range(-(-mlen // 4)):
        word = int(words[w])
        for b in range(4):
            p = 4 * w + b
            D = ((D << 1) | 1) & masks[cls_of_byte[(word >> (8 * b)) & 0xFF]]
            if p < mlen and D & hit:
                return p
    return None


def _check_search(tape, is_nop, nop_mod, label, mlen):
    L = tape.shape[0]
    # the plain version's code table: a nop's register, 3 otherwise
    # (opcodes at or past the table, and every byte >= 64, included)
    cls = np.full(256, 3, np.int64)
    ni = len(is_nop)
    cls[:ni] = np.where(is_nop, nop_mod, 3)
    n = len(label)
    lbl = [torch.full((1,), label[k] if k < n else 0, dtype=torch.int64)
           for k in range(MAX_LABEL_SIZE)]
    q = int(tpc.label_search(
        torch.from_numpy(_codes(tape, cls, L))[:, None], lbl,
        torch.tensor([n]), torch.tensor([mlen]))[0])
    p = shift_and(tape, cls, label, mlen)
    assert (p is None) == (q == L), (p, q)
    if p is not None:
        assert p == q + n - 1, (p, q)
    return p


@hst.composite
def search_cases(draw):
    """A tape of L bytes (some past the opcode table and past 64), a nop
    table, a label of 1-10 codes, often planted in the tape, and mlen."""
    L = draw(hst.sampled_from((64, 128, 192)))
    ni = draw(hst.integers(3, 64))
    is_nop = draw(hst.lists(hst.booleans(), min_size=ni, max_size=ni))
    nop_mod = draw(hst.lists(hst.integers(0, 2), min_size=ni, max_size=ni))
    tape = np.array(draw(hst.lists(hst.integers(0, 70), min_size=L,
                                   max_size=L)), np.uint8)
    n = draw(hst.integers(1, MAX_LABEL_SIZE))
    label = draw(hst.lists(hst.integers(0, 2), min_size=n, max_size=n))
    if draw(hst.booleans()):
        at = draw(hst.integers(0, L - n))
        for k, c in enumerate(label):
            ops = [op for op in range(ni) if is_nop[op] and nop_mod[op] == c]
            if ops:
                tape[at + k] = draw(hst.sampled_from(ops))
    mlen = draw(hst.integers(1, L))
    return tape, is_nop, nop_mod, label, mlen


@settings(max_examples=300, deadline=None, database=None)
@given(search_cases())
def test_shift_and_equals_start_position_scan(case):
    _check_search(*case)


# the heads set's nop table: opcodes 0-2 are nop-A/B/C (registers 0-2)
NOPS = ([True] * 3 + [False] * 23, [0, 1, 2] + [0] * 23)


def _tape(L, at=None, codes=(), fill=10):
    tape = np.full(L, fill, np.uint8)
    if at is not None:
        tape[at:at + len(codes)] = codes
    return tape


@pytest.mark.parametrize("tape,label,mlen,want", [
    (_tape(64, 0, (1, 2)), [1, 2], 64, 1),             # match at 0
    (_tape(64, 61, (0, 2, 1)), [0, 2, 1], 64, 63),     # at the tape's end
    (_tape(64, 61, (0, 2, 1)), [0, 2, 1], 63, None),   # cut off by mlen
    (_tape(64, 20, (1, 1, 1, 2)), [1, 1, 2], 64, 23),  # overlapping prefix
    (_tape(64), [2], 64, None),                        # none
    (_tape(64, 5, (200, 1)), [1, 1], 64, None),        # byte >= 64 is 3
    (_tape(128, 100, (2,) * 10), [2] * 10, 128, 109),  # the longest label
])
def test_shift_and_edges(tape, label, mlen, want):
    assert _check_search(tape, *NOPS, label, mlen) == want


# `nvcc -Xptxas -v` on the two sources (an H100 machine's CUDA 12.8), as
# build() keeps it beside the library: the Hopper kernel once per CTA
# width, then the first port, whose spill counts are edited in to
# exercise their parse
PTXAS_TEXT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__04b3ed76_9_cycles\
_cu_f5ff2cd713cycles_kernelILi128EEEvPiS1_S1_PfPKiS4_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__04b3ed76_9_cycles\
_cu_f5ff2cd713cycles_kernelILi128EEEvPiS1_S1_PfPKiS4_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 111 registers, used 1 barriers
ptxas info    : Compile time = 571.625 ms
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__04b3ed76_9_cycles\
_cu_f5ff2cd713cycles_kernelILi32EEEvPiS1_S1_PfPKiS4_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__04b3ed76_9_cycles\
_cu_f5ff2cd713cycles_kernelILi32EEEvPiS1_S1_PfPKiS4_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 111 registers, used 1 barriers
ptxas info    : Compile time = 565.930 ms
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__134134b7_16_cycles\
_simple_cu_5d9e031e20cycles_simple_kernelEPiS0_S0_PfPKiS3_NS_6ParamsE' for \
'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__134134b7_16_cycles\
_simple_cu_5d9e031e20cycles_simple_kernelEPiS0_S0_PfPKiS3_NS_6ParamsE
    448 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 448 bytes cumulative \
stack size, 384 bytes smem
ptxas info    : Compile time = 574.076 ms
"""


def test_parse_ptxas_report():
    """Every kernel's registers, stack frame, spills and static shared
    memory from a canned `nvcc -Xptxas -v` report of the two sources, the
    Hopper kernel under its CTA width."""
    got = tpc.parse_ptxas(PTXAS_TEXT)
    hopper = dict(stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
                  static_smem_bytes=0)
    assert got == {
        "cycles_kernel<128>": dict(hopper, registers=111),
        "cycles_kernel<32>": dict(hopper, registers=111),
        "cycles_simple_kernel": dict(registers=128, stack_bytes=448,
                                     spill_store_bytes=8,
                                     spill_load_bytes=12,
                                     static_smem_bytes=384)}


def test_build_digest_covers_both_sources(tmp_path, monkeypatch):
    """The library's name changes with either source (and the flags), so
    an edit to the first port rebuilds the library as well."""
    assert [p.rsplit("/", 1)[-1] for p in tpc.SOURCES] == [
        "cycles.cu", "cycles_simple.cu"]
    srcs = []
    for name in ("cycles.cu", "cycles_simple.cu"):
        path = tmp_path / name
        path.write_text(f"// {name}\n")
        srcs.append(path)
    monkeypatch.setattr(tpc, "SOURCES", tuple(str(p) for p in srcs))
    seen = {tpc.source_digest()}
    for path in srcs:
        path.write_text(path.read_text() + "// edited\n")
        seen.add(tpc.source_digest())
    monkeypatch.setattr(tpc, "NVCC_FLAGS", tpc.NVCC_FLAGS + ("-lineinfo",))
    seen.add(tpc.source_digest())
    assert len(seen) == 4


def test_simple_kernel_is_cuda_only():
    """The first port has no plain fallback: on CPU planes it raises."""
    planes = tuple(torch.zeros((1, 128), dtype=torch.int32)
                   for _ in range(4))
    with pytest.raises(ValueError, match="CUDA"):
        tpc.cycles_simple(None, planes, None, 1, 128)


def test_launch_table_nop_decode():
    """The launch table ends in the nop decode the Hopper kernel stages
    with it (a nop's register, -1 for any other opcode slot), after the
    reaction block sized by R (logic-9: 9 entries of 16 ints, no further
    mask words): 720 ints, one bulk copy of 2,880 bytes."""
    from avida_tpu_torch import convert
    from avida_tpu_torch.world import World
    p = World(cfg=convert.config_from_dict(dict(WORLD_X=4, WORLD_Y=4)),
              data_dir=None, device="cpu").params
    tab = tpc._build_tables(p)
    at = tpc.nop_decode_at(p.num_reactions)
    assert at == 8 * 64 + 16 * 9
    assert tab.numel() == at + tpc.TAB_INSTS == 720
    assert (4 * tab.numel()) % 16 == 0
    decode = tab[at:].tolist()
    for k in range(tpc.TAB_INSTS):
        want = (int(p.nop_mod[k]) if k < p.num_insts and p.is_nop[k]
                else -1)
        assert decode[k] == want, k
    assert sorted(v for v in decode if v >= 0) == [0, 1, 2]
    # the first port's part of the table keeps its layout
    assert int(tab[tpc.T_IS_NOP * tpc.TAB_INSTS]) == int(p.is_nop[0])
