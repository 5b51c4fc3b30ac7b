"""The port's churn traces (utils/churntrace.py) and the fleet spool CLI's
trace and admission commands (tools/fleet_tool.py: gen-trace, submit
--shard / --backpressure) against avida_tpu's utils/churntrace.py and
scripts/fleet_tool.py: the churn-trace scenarios of the reference's
tests/test_serve.py on the same inputs through both packages.

Inputs: seeds and trace lines chosen here; the same fake clock for a
replay.

Tolerance: exact -- generated traces and formatted files byte for byte,
parsed events field for field, every parse error's message, the spool a
replay or a submit leaves (file names and spec contents), CLI exit codes
and output.
"""

import json
import os
import sys
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import fleet_tool as rtool  # noqa: E402
from avida_tpu.utils import churntrace as rchurn  # noqa: E402

from avida_tpu_torch.tools import fleet_tool as ttool  # noqa: E402
from avida_tpu_torch.utils import churntrace as tchurn  # noqa: E402

import test_supervisor as ts  # noqa: E402

PKGS = {"ref": SimpleNamespace(churn=rchurn, tool=rtool),
        "port": SimpleNamespace(churn=tchurn, tool=ttool)}
ARGS = ["-u", "40", "-set", "WORLD_X", "8", "-set", "WORLD_Y", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn):
    return {name: fn(P) for name, P in PKGS.items()}


def _spool_contents(spool):
    out = {}
    for d, _, fs in os.walk(spool):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, spool)] = open(p).read()
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=7, jobs=6, classes=2, cancel_frac=0.34, span=20, updates=30),
    dict(seed=0),
    dict(seed=123, jobs=40, classes=3, cancel_frac=0.5, span=90.0,
         updates=200, tenants=4),
    dict(seed=5, jobs=1, cancel_frac=1.0, span=1.0, updates=1),
    dict(seed=99, jobs=0),
])
def test_generate_and_format_equal_reference(kw):
    """`generate` and `format_trace` byte for byte the reference's for the
    same seed and knobs, stable across two draws; the text parses back
    to the same events, sorted, cancels after their submits."""
    seed = kw["seed"]
    got = _both(lambda P: [P.churn.format_trace(
        P.churn.generate(**kw), seed=seed, note=f"knobs {kw}"),
        P.churn.format_trace(P.churn.generate(**kw))])
    assert got["port"] == got["ref"]
    text = got["port"][0]
    assert text == tchurn.format_trace(tchurn.generate(**kw), seed=seed,
                                       note=f"knobs {kw}")
    if kw.get("jobs", 12):
        parsed = tchurn.parse_trace(text.splitlines(True))
        assert [e.text for e in parsed] \
            == [e.text for e in tchurn.generate(**kw)]
        assert [e.t for e in parsed] == sorted(e.t for e in parsed)
        first = {}
        for e in parsed:
            first.setdefault(e.job, e.kind)
        assert set(first.values()) == {"submit"}


@pytest.mark.parametrize("line", [
    "submit:job=a,seed=1,u=5@t=0", "submit:job=b,seed=2,u=5,tenant=o@t=1.5",
    " cancel:job=a@t=2 ", "submit: job = c , seed=3, u=9, class=1 @t=0.25",
    "submit:job=a,seed=1,u=5", "nope:job=a@t=1", "submit:seed=1,u=5@t=1",
    "submit:job=a,bare@t=1", "submit:job=a,seed=x,u=5@t=1",
    "submit:job=a,seed=1@t=1", "cancel:job=a@x=1", "cancel:job=a@t=soon",
    "cancel@t=1", "submit:job=a@b,seed=1,u=2@t=3",
])
def test_parse_event_equals_reference(line):
    """One trace line through both parsers: the same event (time, kind,
    arguments, text) or the same error."""
    def parse(P):
        try:
            e = P.churn.parse_event(line)
        except ValueError as err:
            return ["error", str(err)]
        return [e.t, e.kind, e.args, e.text, e.job, repr(e)]
    got = _both(parse)
    assert got["port"] == got["ref"]


def test_parse_trace_equals_reference(tmp_path):
    """A trace file with comments and blank lines, and an empty one."""
    path = tmp_path / "t.trace"
    path.write_text("# head\n\ncancel:job=b@t=3\nsubmit:job=b,seed=2,u=5@t=3"
                    "  # same time: the submit first\n"
                    "submit:job=a,seed=1,u=5@t=0.5\n")
    got = _both(lambda P: [(e.t, e.kind, e.job)
                           for e in P.churn.parse_trace(str(path))])
    assert got["port"] == got["ref"] == [(0.5, "submit", "a"),
                                         (3.0, "submit", "b"),
                                         (3.0, "cancel", "b")]
    for P in PKGS.values():
        with pytest.raises(ValueError, match="empty churn trace"):
            P.churn.parse_trace(["# nothing\n", "\n"])


def test_replay_drives_spool_as_reference(tmp_path):
    """`replay` of the same trace on the same fake clock: submits through
    each package's fleet_tool, cancels as marker files; the spools
    equal file for file, the submit times and the events seen equal."""
    lines = ["submit:job=a,seed=1,u=5@t=0",
             "submit:job=b,seed=2,u=5,tenant=org1@t=1",
             "cancel:job=a@t=2", "submit:job=c,seed=3,u=7,class=1@t=2.5"]

    def run(P):
        spool = str(tmp_path / P.churn.__name__.split(".")[0] / "spool")
        clk = ts.FakeClock()
        seen = []
        when = P.churn.replay(
            spool, P.churn.parse_trace(lines),
            lambda e: ARGS + ["-s", e.args["seed"]], clock=clk,
            sleep=clk.sleep, on_event=lambda e: seen.append(e.kind))
        return [when, seen, _spool_contents(spool)]

    got = _both(run)
    assert got["port"] == got["ref"]
    when, seen, files = got["port"]
    assert seen == ["submit", "submit", "cancel", "submit"]
    assert when == {"a": 1000.0, "b": 1001.0, "c": 1002.5}
    assert set(files) == {"a.json", "b.json", "c.json", "a.cancel"}
    spec_b = json.loads(files["b.json"])
    assert spec_b["tenant"] == "org1" and spec_b["batch"] is True


def test_gen_trace_cli_equals_reference(tmp_path, capsys):
    """`fleet_tool gen-trace` writes the reference's file byte for byte;
    a missing --seed or an unknown flag exits 2 as the reference's."""
    def run(P, argv):
        out = str(tmp_path / f"{P.tool.__name__}.trace")
        rc = P.tool.main(["gen-trace", out] + argv)
        text = open(out).read() if os.path.exists(out) else None
        said = capsys.readouterr().out.replace(out, "<out>")
        if os.path.exists(out):
            os.remove(out)
        return [rc, text, said]

    for argv in (["--seed", "5", "--jobs", "4", "--classes", "2"],
                 ["--seed", "9", "--cancel", "0.5", "--span", "12.5",
                  "--updates", "7", "--tenants", "3"],
                 [], ["--seed", "1", "--bogus", "2"]):
        got = _both(lambda P: run(P, argv))
        assert got["port"] == got["ref"], argv
    assert got["port"][0] == 2
    rc, text, _ = run(PKGS["port"], ["--seed", "5", "--jobs", "4",
                                     "--classes", "2"])
    assert rc == 0
    evs = tchurn.parse_trace(text.splitlines(True))
    assert sum(1 for e in evs if e.kind == "submit") == 4


def test_fleet_tool_shard_and_backpressure_equal_reference(tmp_path,
                                                           capsys):
    """submit --shard spreads specs over shard-<k>/ by the reference's
    hash; the duplicate check reaches across shards; --backpressure MAX
    raises QueueFullError (exit 3 from the CLI) while MAX specs wait."""
    def run(P):
        spool = str(tmp_path / P.tool.__name__ / "spool")
        out = [os.path.relpath(P.tool.submit(spool, n, ARGS, shard=4),
                               spool) for n in ("s1", "s2", "s10")]
        with pytest.raises(ValueError, match="already exists") as e:
            P.tool.submit(spool, "s1", ARGS, shard=4)
        out.append(str(e.value).replace(spool, "<spool>"))
        with pytest.raises(P.tool.QueueFullError) as e:
            P.tool.submit(spool, "s3", ARGS, backpressure=2)
        out.append(str(e.value).replace(spool, "<spool>"))
        capsys.readouterr()
        out.append(P.tool.main(["submit", spool, "s3", "--backpressure",
                                "2", "--", "-u", "1"]))
        out.append(P.tool.main(["submit", spool, "s4", "--shard", "x",
                                "--", "-u", "1"]))
        out.append(capsys.readouterr().out.replace(spool, "<spool>"))
        out.append(os.path.relpath(
            P.tool.submit(spool, "s3", ARGS, backpressure=5), spool))
        out.append(_spool_contents(spool))
        return out

    got = _both(run)
    assert got["port"] == got["ref"]
    assert all(p.startswith("shard-") for p in got["port"][:3])
    assert got["port"][5:7] == [3, 2]
