"""analyze/analyzer.py (the analyze VM) against the reference's
avida_tpu/analyze/analyzer.py: the same analyze program runs through
each package's Analyzer, and every file each writes must be equal byte
for byte (the header's date line pinned: time.asctime is patched for
both).

One program (LOAD_SEQUENCE, RECALCULATE, DETAIL) runs the true Test CPU
of each package.  The others run every command of the VM with both
packages' Test CPU replaced by one shared numpy stand-in
(`stand_in`, patched into each package's module attributes), so the
costly sweeps (LANDSCAPE, MAP_MUTATIONS, ANALYZE_KNOCKOUTS,
ANALYZE_MODULARITY, CENSUS, LINEAGE) hold the VM's own host code to the
reference's without thousands of sandbox gestations.  TRACE runs the
true trace.

Tolerance: exact -- file bytes and batch attributes equal.
"""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import avida_tpu.analyze.analyzer as ranalyzer  # noqa: E402
import avida_tpu.analyze.testcpu as rtestcpu  # noqa: E402

import avida_tpu_torch.analyze.analyzer as tanalyzer  # noqa: E402
import avida_tpu_torch.analyze.testcpu as ttestcpu  # noqa: E402
from avida_tpu_torch.utils.spop import _seq_to_string  # noqa: E402

from test_torch_testcpu import (INSTSET, OP, both_params,  # noqa: E402
                                genomes)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small batches' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    """The .dat header's date line, the same in both packages' files."""
    monkeypatch.setattr(time, "asctime", lambda *a: "Thu Jan  1 00:00:00 1970")


def stand_in(params, genomes, lens=None, seed=0, time_mod=20, **kw):
    """A deterministic numpy Test CPU: each record a function of the
    genome's content (about one genome in seven inviable, task bits from
    a weighted opcode sum), with the reference's dtypes."""
    g = np.asarray(genomes).astype(np.int64)
    G, L = g.shape
    lens = np.asarray(lens, np.int32)
    cols = np.arange(L)[None, :]
    s = (g * (cols % 31 + 1) * (cols < lens[:, None])).sum(axis=1)
    viable = (s % 7) != 0
    gest = np.where(viable, 300 + s % 97, 0).astype(np.int32)
    merit = (lens + s % 13).astype(np.float32)
    R = params.num_reactions
    tasks = (((s[:, None] >> np.arange(R)[None, :]) & 1)
             * viable[:, None]).astype(np.int32)
    return SimpleNamespace(
        viable=viable, gestation_time=gest, merit=merit,
        fitness=np.where(gest > 0, merit / np.maximum(gest, 1), 0.0),
        task_counts=tasks, copied_size=lens.copy(),
        executed_size=lens.copy(), offspring_genome=g.astype(np.int8),
        offspring_len=lens.copy(), generations=np.zeros(G, np.int32))


def _spop(path):
    """A .spop of four genotypes, each the previous one's child."""
    gs = genomes()
    rows = [gs["ancestor"], gs["nand"], gs["filler"], gs["untrue_viable"]]
    with open(path, "w") as f:
        f.write("#filetype genotype_data\n# Structured Population Save\n\n")
        cell = 0
        for gid, (g, n) in enumerate(zip(rows, (1, 1, 2, 3)), 1):
            cells = ",".join(str(cell + i) for i in range(n))
            cell += n
            parents = "(none)" if gid == 1 else str(gid - 1)
            f.write(" ".join(map(str, [
                gid, "div:int", "(none)", parents, n, n, len(g), 97.0,
                389, 0.25, gid - 1, 0, -1, gid - 1, 0, "heads_default",
                _seq_to_string(g), cells, ",".join(["0"] * n), 0])) + "\n")


def _tree(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _batch_view(az):
    return {k: [(g.id, g.sequence.tobytes(), g.num_cpus, g.viable,
                 g.fitness, g.merit, g.gestation_time,
                 getattr(g, "alignment", None)) for g in b]
            for k, b in az.batches.items()}


def run_both(lines, tmp_path, monkeypatch, real=False):
    """Run one analyze program through both VMs; returns (ref, port)
    analyzers after asserting every written file and batch equal."""
    rp, tp = both_params()
    if not real:
        for mod in (ranalyzer, rtestcpu, tanalyzer, ttestcpu):
            monkeypatch.setattr(mod, "evaluate_genomes", stand_in)
    _spop(tmp_path / "pop.spop")
    lines = [ln.replace("POP", str(tmp_path / "pop.spop")) for ln in lines]
    from avida_tpu import config as rconfig
    r = ranalyzer.Analyzer(rp, rconfig.default_instset(),
                           data_dir=str(tmp_path / "ref"))
    t = tanalyzer.Analyzer(tp, INSTSET, data_dir=str(tmp_path / "port"),
                           device="cpu")
    r.run_lines(lines)
    t.run_lines(lines)
    rt, tt = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert sorted(rt) == sorted(tt)
    for name in rt:
        assert rt[name] == tt[name], name
    assert _batch_view(r) == _batch_view(t)
    return r, t, rt


def test_recalculate_detail_true_testcpu(tmp_path, monkeypatch):
    """RECALCULATE and DETAIL through each package's real Test CPU: the
    ancestor reads 389 / 97 / 97/389."""
    seqs = [_seq_to_string(genomes()[k]) for k in ("ancestor", "nand")]
    _, t, files = run_both(
        [f"LOAD_SEQUENCE {s}" for s in seqs]
        + ["RECALCULATE",
           "DETAIL detail.dat id viable fitness merit gestation_time "
           "copied_size executed_size length sequence"],
        tmp_path, monkeypatch, real=True)
    g = t.batch[0]
    assert (g.gestation_time, g.merit, g.fitness) == (389, 97.0, 97 / 389)
    assert b"389" in files["detail.dat"]


PROGRAMS = {
    "load_filter_find": ["LOAD POP", "RECALCULATE", "FILTER fitness > 0",
                         "DETAIL kept.dat", "FIND_GENOTYPE num_cpus",
                         "DETAIL best.dat id num_cpus total_cpus sequence"],
    "batches": ["LOAD POP", "SET_BATCH 2", "DUPLICATE 0", "DUPLICATE 0 3",
                "PURGE_BATCH 0", "SET_BATCH 3", "RECALCULATE",
                "DETAIL b3.dat id fitness viable", "PURGE_BATCH",
                "VERBOSE 0", "SYSTEM true"],
    "landscape": ["LOAD POP", "SET_BATCH 1", "DUPLICATE 0", "PURGE_BATCH 0",
                  "LANDSCAPE"],
    "knockouts": ["LOAD POP", "ANALYZE_KNOCKOUTS ko.dat"],
    "census_lineage": ["LOAD POP", "CENSUS", "LINEAGE lin.dat num_cpus",
                       "DETAIL lineage_detail.dat id fitness"],
    "find_lineage": ["LOAD POP", "FIND_LINEAGE total_cpus", "RECALCULATE",
                     "DETAIL fl.dat id fitness gestation_time"],
    "modularity": ["LOAD POP", "ANALYZE_MODULARITY"],
    "align_map": ["LOAD POP", "ALIGN", "DETAIL al.dat id alignment",
                  "PURGE_BATCH", "LOAD_SEQUENCE abcdefghijklmnopqrst",
                  "MAP_MUTATIONS mm"],
    "recombine": ["LOAD POP", "RECOMBINE 2", "RECOMBINE", "RECALCULATE",
                  "DETAIL rec.dat id length fitness sequence"],
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_analyze_commands_equal_reference(name, tmp_path, monkeypatch):
    """Every command of the VM on the shared stand-in: the files and the
    batches equal the reference's."""
    _, t, files = run_both(PROGRAMS[name], tmp_path, monkeypatch)
    assert files, name
    if name == "modularity":
        rows = [ln for ln in files["modularity.dat"].decode().splitlines()
                if ln and not ln.startswith("#")]
        assert any(r.split()[1] != "0" for r in rows)


def test_trace_command_equals_reference(tmp_path, monkeypatch):
    """TRACE through each package's real trace: one file per genotype,
    byte for byte, up to the divide."""
    _, _, files = run_both(
        [f"LOAD_SEQUENCE {_seq_to_string(genomes()['nand'])}", "TRACE tr"],
        tmp_path, monkeypatch)
    (text,) = files.values()
    assert b"U:389 " in text and b"DIVIDE" in text
    assert OP["IO"] in genomes()["nand"]
