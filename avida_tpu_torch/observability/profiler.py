"""Device performance attribution plane (TPU_PROFILE).

Counterpart of avida_tpu/observability/profiler.py.  It answers:

  which PHASE?   opt-in (TPU_PROFILE=1) per-chunk attribution: every
                 chunk's boundary-to-boundary wall is accumulated
                 unfenced, and every TPU_PROFILE_EVERY-th chunk (the
                 first always) is FENCED -- its device time read off two
                 CUDA events around it -- and followed by a phase probe:
                 a staged update on a COPY of the live state, so the
                 trajectory stays bit-identical with profiling on or off;
  which BYTES?   resident-state footprint per PopulationState leaf --
                 padded vs live bytes (scaled by occupancy and mean genome
                 length), the packed engine's resident planes, and the
                 card's allocator counters (torch.cuda.memory_stats).

Where the reference reads XLA's cost and memory analysis of each
compiled program (program_perf, note_program, the avida_perf_program_*
families, the perf record's "programs" key), this package compiles no
programs: those keys are left out, and the CUDA events' chunk times
("chunk_device_ms", avida_perf_chunk_device_ms) and the allocator's
counters ("device_memory", avida_perf_device_*_bytes) take their place.
The readers of what it writes (perf.jsonl, metrics.prom) and of bench
artifacts are in perfread.py, which tools/perf_tool.py loads without
torch; the bench provenance writer waits for the port's bench (ROADMAP
item 8).

Everything lands in the observability grammars: `avida_perf_*`
families on the metrics exporter (empty when off), {"record": "perf"}
lines in DATA_DIR/perf.jsonl and a perf line in `--status`.  Arming:
config nonzero OR environment nonzero.  Host-importable without torch:
every torch touch is inside a function (`--status` imports this module).
"""

from __future__ import annotations

import os
import time

from avida_tpu_torch.observability.perfread import (  # noqa: F401
    PERF_FILE, read_perf_records)

PROFILES_DIR = "profiles"
_PERF_MAX_BYTES = 16 << 20

# ---------------------------------------------------------------------------
# arming (the integrity.digest_enabled pattern: config OR env)
# ---------------------------------------------------------------------------


def enabled(cfg=None) -> bool:
    """TPU_PROFILE nonzero in the config OR the environment arms the
    attribution plane.  Off (default) builds nothing, fences nothing
    and writes nothing -- exporter files stay byte-identical."""
    if cfg is not None and int(cfg.get("TPU_PROFILE", 0) or 0):
        return True
    return bool(int(os.environ.get("TPU_PROFILE", "0") or 0))


def trace_enabled(cfg=None) -> bool:
    """TPU_PROFILE_TRACE=1: the first fenced probe also captures a
    torch.profiler trace of its staged phases into DATA_DIR/profiles/."""
    if cfg is not None and int(cfg.get("TPU_PROFILE_TRACE", 0) or 0):
        return True
    return bool(int(os.environ.get("TPU_PROFILE_TRACE", "0") or 0))


def probe_every(cfg=None) -> int:
    """Fenced-probe cadence in chunks (first chunk always probes;
    0 = first chunk only).  Env wins over config here -- cadence is an
    operator knob, like the history sampling knobs."""
    v = os.environ.get("TPU_PROFILE_EVERY", "")
    if v not in ("", None):
        try:
            return int(v)
        except ValueError:
            pass
    if cfg is not None:
        return int(cfg.get("TPU_PROFILE_EVERY", 16) or 0)
    return 16


# ---------------------------------------------------------------------------
# module state (one process = one attribution report, like compilecache)
# ---------------------------------------------------------------------------

_chunk = {
    "chunks": 0,                # chunks dispatched under profiling
    "updates": 0,               # updates those chunks covered
    "wall_ms": 0.0,             # boundary-to-boundary wall (unfenced)
    "wall_chunks": 0,           # intervals accumulated into wall_ms
    "fenced_ms": 0.0,           # dispatch->ready wall of probed chunks
    "fenced_chunks": 0,
    "device_ms": 0.0,           # CUDA-event device time of probed chunks
    "device_chunks": 0,
    "probes": 0,                # fenced probes taken
    "probe_ms": 0.0,            # host+device wall spent inside probes
}
_phases: dict = {}              # phase name -> ms (last probe)
_cycle_share = None             # cycle-loop share of the last probe
_footprint = None               # last state_footprint() result
_memory = None                  # last device_memory() result


def counters() -> dict:
    return dict(_chunk)


def reset_for_tests():
    global _cycle_share, _footprint, _memory
    _phases.clear()
    _cycle_share = None
    _footprint = None
    _memory = None
    for k in _chunk:
        _chunk[k] = 0 if isinstance(_chunk[k], int) else 0.0


# ---------------------------------------------------------------------------
# resident-state footprint (per PopulationState leaf)
# ---------------------------------------------------------------------------


def packed_planes_footprint(params, N: int, W: int = 1) -> dict:
    """Resident-plane byte accounting of the packed chunk engine
    (ops/packed_chunk.py) for an N-cell world (x W batched worlds):
    per-plane rows/bytes from the kernel layout, the bit-packed vs
    unpacked genome-shadow comparison (the TPU_PACKED_BITS HBM-savings
    number), and bytes-per-organism totals.  Pure shape math -- no
    device transfer, callable without a live packed state."""
    from avida_tpu_torch.ops import cycles, packed_chunk

    _, _, L = cycles.dims(params, N, int(params.max_memory))
    NI, _, _, _ = cycles.layout(params, L)
    LP = L // 4
    L5 = cycles.words5(L)
    bits = packed_chunk.bits_active(params)
    gen_rows = L5 if bits else LP
    lanes = int(N) * int(W)
    planes = {
        "tape_t": {"rows": LP, "bytes": 4 * LP * lanes},
        "off_t": {"rows": LP, "bytes": 4 * LP * lanes},
        "gen_t": {"rows": gen_rows, "bytes": 4 * gen_rows * lanes,
                  "unpacked_bytes": 4 * LP * lanes},
        "ivec": {"rows": int(NI), "bytes": 4 * int(NI) * lanes},
        "fvec": {"rows": int(cycles.NF),
                 "bytes": 4 * int(cycles.NF) * lanes},
    }
    total = sum(p["bytes"] for p in planes.values())
    unpacked_total = total - planes["gen_t"]["bytes"] \
        + planes["gen_t"]["unpacked_bytes"]
    out = {
        "packed_bits": int(bits),
        "planes": planes,
        "total_bytes": total,
        "bytes_per_org": round(total / lanes, 2) if lanes else 0.0,
        # the bits=0 comparator (equals total when the codec is off)
        "unpacked_total_bytes": unpacked_total,
        "saved_bytes": unpacked_total - total,
    }
    reason = packed_chunk.bits_ineligible_reason(params)
    if reason and int(params.packed_bits):
        out["bits_fallback_reason"] = reason
    return out


def state_footprint(st, names=None, num_ghosts: int = 0,
                    params=None) -> dict:
    """Padded vs live byte accounting of one PopulationState (or a
    [W]-stacked batch of them).

    Padded bytes per leaf are `nbytes` ground truth (shape x itemsize,
    no device transfer).  Live bytes scale every cell-axis leaf by the
    alive fraction, and genome-shaped [.., N, L] leaves additionally by
    the mean live genome length / L -- the bit-packing headroom number
    ROADMAP item 4 needs.  Exactly two scalar readbacks (alive count,
    mean genome length); None leaves (tracer rings off, unused
    subsystems) are skipped like core/state.state_array_specs.

    Batched states ([W, N, ...]; `names`/`num_ghosts` from the caller)
    additionally report per-world bytes and the ghost-slot overhead.

    With `params` given and the packed chunk engine active, a
    `packed_planes` block (packed_planes_footprint) reports what is
    ACTUALLY resident mid-chunk -- the kernel planes, per world on
    batched paths -- including the bit-packed vs unpacked genome-shadow
    bytes under TPU_PACKED_BITS."""
    from avida_tpu_torch.core.state import state_field_names

    alive = st.alive.cpu().numpy()
    batched = alive.ndim == 2
    W = alive.shape[0] if batched else 1
    N = alive.shape[-1]
    L = int(st.genome.shape[-1])
    n_alive = int(alive.sum())
    alive_frac = n_alive / float(alive.size) if alive.size else 0.0
    glen = st.genome_len.cpu().numpy()
    mean_len = (float((glen * alive).sum()) / n_alive) if n_alive else 0.0
    len_frac = mean_len / L if L else 0.0

    cell_axis = 1 if batched else 0
    leaves, total, live_total = {}, 0, 0.0
    for name in state_field_names():
        x = getattr(st, name, None)
        if x is None:
            continue
        b = int(x.numel() * x.element_size())
        frac = 1.0
        shape = tuple(x.shape)
        if len(shape) > cell_axis and shape[cell_axis] == N:
            frac = alive_frac
            if shape[-1:] == (L,) and len(shape) == cell_axis + 2:
                frac *= len_frac
        lb = b * frac
        leaves[name] = {"bytes": b, "live_bytes": int(round(lb)),
                        "shape": list(shape),
                        "dtype": str(x.dtype).replace("torch.", "")}
        total += b
        live_total += lb

    out = {
        "total_bytes": total,
        "live_bytes": int(round(live_total)),
        "alive_frac": round(alive_frac, 4),
        "genome_len_frac": round(len_frac, 4),
        "leaves": leaves,
    }
    if batched:
        out["worlds"] = W
        out["per_world_bytes"] = total // W if W else 0
        out["ghost_slots"] = int(num_ghosts)
        out["ghost_bytes"] = (total // W) * int(num_ghosts) if W else 0
        if names:
            out["world_names"] = list(names)
    if params is not None:
        from avida_tpu_torch.ops import packed_chunk
        if packed_chunk.active(params):
            pp = packed_planes_footprint(params, N, W)
            if batched and W:
                pp["per_world_bytes"] = pp["total_bytes"] // W
            out["packed_planes"] = pp
    return out


def device_memory(device=None) -> dict | None:
    """The card's caching-allocator counters (torch.cuda.memory_stats):
    current and peak allocated and reserved bytes.  None off the card."""
    import torch
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return None
    s = torch.cuda.memory_stats(device)
    return {k: int(s.get(f"{name}.all.{when}", 0))
            for k, name, when in (
                ("allocated_bytes", "allocated_bytes", "current"),
                ("peak_allocated_bytes", "allocated_bytes", "peak"),
                ("reserved_bytes", "reserved_bytes", "current"),
                ("peak_reserved_bytes", "reserved_bytes", "peak"))}


# ---------------------------------------------------------------------------
# the chunk hook of a run loop (World / MultiWorld)
# ---------------------------------------------------------------------------


def _cuda_on(device) -> bool:
    import torch
    return torch.cuda.is_available() and torch.device(device).type == "cuda"


class ChunkProfiler:
    """A run loop's attribution hooks around the chunk dispatch.

    chunk_begin(k) stamps the dispatch (and, on probe chunks, records a
    CUDA event); chunk_end_solo/_batched accumulates the unfenced
    boundary-to-boundary wall and, on probe chunks (first chunk, then
    every TPU_PROFILE_EVERY-th), fences the freshly run chunk, reads its
    device time off the CUDA events, runs a staged phase probe on COPIES
    of the state (discarded: trajectory bit-identity), refreshes the
    footprint and allocator accounting and appends a {"record":"perf"}
    line.  The unfenced path costs two perf_counter() calls and a few
    dict adds per chunk."""

    def __init__(self, data_dir: str, cfg=None, kind: str = "solo",
                 device="cpu"):
        self.data_dir = data_dir
        self.kind = kind
        self.device = device
        self.every = probe_every(cfg)
        self.trace = trace_enabled(cfg)
        self._chunk_no = 0
        self._probe = False
        self._t0 = None
        self._ev0 = None
        self._last_end = None
        self._staged = None             # solo probe runner, built lazily
        self._traced = False            # one-shot torch.profiler capture

    # ---- the hot path ----

    def chunk_begin(self, k: int):
        self._chunk_no += 1
        self._probe = (self._chunk_no == 1
                       or (self.every > 0
                           and self._chunk_no % self.every == 0))
        self._ev0 = None
        if self._probe and _cuda_on(self.device):
            import torch
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        self._t0 = time.perf_counter()

    def _chunk_end(self, k: int) -> bool:
        now = time.perf_counter()
        _chunk["chunks"] += 1
        _chunk["updates"] += int(k)
        if self._last_end is not None:
            _chunk["wall_ms"] += (now - self._last_end) * 1e3
            _chunk["wall_chunks"] += 1
        probe = self._probe
        if probe:
            if self._ev0 is not None:
                import torch
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
                ev1.synchronize()
                _chunk["device_ms"] += self._ev0.elapsed_time(ev1)
                _chunk["device_chunks"] += 1
            _chunk["fenced_ms"] += (time.perf_counter() - self._t0) * 1e3
            _chunk["fenced_chunks"] += 1
        self._last_end = time.perf_counter()
        return probe

    def chunk_end_solo(self, world, k: int):
        """Boundary hook for World._scan_updates (state is world.state,
        update counter still pre-chunk)."""
        if not self._chunk_end(k):
            return
        t0 = time.perf_counter()
        phases = self._run_traced(self._probe_solo, world)
        fp = state_footprint(world.state, params=world.params)
        self._finish_probe(phases, fp, int(world.update) + int(k), k)
        _chunk["probe_ms"] += (time.perf_counter() - t0) * 1e3

    def chunk_end_batched(self, owner, k: int, names=None,
                          num_ghosts: int = 0, update: int | None = None):
        """Boundary hook for MultiWorld._scan (owner.bstate is the
        stacked batch, update counters already advanced)."""
        if not self._chunk_end(k):
            return
        t0 = time.perf_counter()
        phases = self._run_traced(self._probe_batched, owner)
        fp = state_footprint(owner.bstate, names=names,
                             num_ghosts=num_ghosts,
                             params=getattr(owner, "params", None))
        if update is None:
            update = int(getattr(owner, "update", 0))
        self._finish_probe(phases, fp, int(update), k)
        _chunk["probe_ms"] += (time.perf_counter() - t0) * 1e3

    def final(self, state, update: int, names=None, num_ghosts: int = 0,
              params=None):
        """Exit-path refresh: the closing footprint and perf record."""
        if state is None:
            return
        try:
            fp = state_footprint(state, names=names, num_ghosts=num_ghosts,
                                 params=params)
        except Exception:
            return
        self._finish_probe({}, fp, int(update), 0, final=True)

    # ---- probes (on copies; discarded -- bit-identity) ----

    def _run_traced(self, probe_fn, owner) -> dict:
        """Run one phase probe, the FIRST one inside a torch.profiler
        capture into DATA_DIR/profiles/ when TPU_PROFILE_TRACE is armed.
        A probe failure degrades to whole-chunk attribution only --
        profiling must never take down the run."""
        tl = None
        if self.trace and not self._traced:
            from avida_tpu_torch.observability.timeline import Timeline
            self._traced = True
            tl = Timeline(self.device)
            if not tl.start_trace(os.path.join(self.data_dir,
                                               PROFILES_DIR)):
                tl = None
        try:
            return probe_fn(owner)
        except Exception:
            return {}
        finally:
            if tl is not None:
                tl.stop_trace()

    def _probe_solo(self, world) -> dict:
        from avida_tpu_torch.core.state import clone_state
        from avida_tpu_torch.ops import packed_chunk
        from avida_tpu_torch.utils import prng

        if packed_chunk.active(world.params, world.state):
            # the packed engine has its own phase structure (boundary
            # pack/unpack + in-chunk row-space phases): stage those
            from avida_tpu_torch.observability.harness import \
                measure_packed_phases
            t = measure_packed_phases(
                world.params, clone_state(world.state), world.neighbors,
                world._run_key, reps=1, warmup=self._staged is None)
            self._staged = "packed"
            return {k[:-3]: v for k, v in t.items() if k.endswith("_ms")}

        from avida_tpu_torch.observability.staged import StagedUpdate
        from avida_tpu_torch.observability.timeline import Timeline

        if self._staged is None or self._staged == "packed":
            self._staged = StagedUpdate(world.params, world.neighbors,
                                        collect_dispatch=False)
        u = int(world.update)
        tl = Timeline(world.device)
        self._staged.run(clone_state(world.state),
                         prng.fold_in(world._run_key, u), u, tl)
        return tl.drain()

    def _probe_batched(self, owner) -> dict:
        from avida_tpu_torch.core.state import clone_state
        from avida_tpu_torch.observability.harness import (
            measure_batched_phases, measure_packed_worlds_phases)
        from avida_tpu_torch.ops import cycles, packed_chunk

        bst = clone_state(owner.bstate)
        if cycles.use_kernel(owner.params):
            if packed_chunk.batch_active(owner.params, owner.bstate):
                warm = self._staged is None
                self._staged = "packed-worlds"
                t = measure_packed_worlds_phases(
                    owner.params, bst, owner.neighbors, owner._run_keys,
                    reps=1, warmup=warm)
                return {k[:-3]: v for k, v in t.items()
                        if k.endswith("_ms")}
            # the staged pre/cycles/post split is the folded micro-step
            # engine's; kernel batches keep whole-chunk attribution
            return {}
        t = measure_batched_phases(owner.params, bst, owner.neighbors,
                                   owner._run_keys, reps=1)
        global _cycle_share
        _cycle_share = t.pop("cycle_loop_share", None)
        return {k[:-3]: v for k, v in t.items() if k.endswith("_ms")}

    # ---- publication ----

    def _finish_probe(self, phases: dict, fp: dict, update: int, k: int,
                      final: bool = False):
        global _footprint, _memory
        if phases:
            _phases.clear()
            _phases.update({n: round(float(ms), 4)
                            for n, ms in phases.items()})
        _footprint = fp
        _memory = device_memory(self.device)
        if not final:
            _chunk["probes"] += 1
        rec = {
            "record": "perf",
            "time": round(time.time(), 3),
            "kind": self.kind,
            "update": int(update),
            "chunk_updates": int(k),
            "final": bool(final),
            "chunks": _chunk["chunks"],
            "chunk_wall_ms": _mean(_chunk["wall_ms"],
                                   _chunk["wall_chunks"]),
            "chunk_fenced_ms": _mean(_chunk["fenced_ms"],
                                     _chunk["fenced_chunks"]),
            "chunk_device_ms": _mean(_chunk["device_ms"],
                                     _chunk["device_chunks"]),
            "phases": dict(_phases),
            "state_bytes": fp.get("total_bytes", 0),
            "state_live_bytes": fp.get("live_bytes", 0),
            "alive_frac": fp.get("alive_frac", 0.0),
            "genome_len_frac": fp.get("genome_len_frac", 0.0),
            "leaves": {n: lf["bytes"]
                       for n, lf in fp.get("leaves", {}).items()},
        }
        if _memory is not None:
            rec["device_memory"] = dict(_memory)
        if _cycle_share is not None:
            rec["cycle_loop_share"] = round(float(_cycle_share), 4)
        for extra in ("per_world_bytes", "ghost_slots", "ghost_bytes"):
            if extra in fp:
                rec[extra] = fp[extra]
        if "packed_planes" in fp:
            rec["packed_planes"] = fp["packed_planes"]
        append_perf_record(self.data_dir, rec)


def _mean(total: float, n: int) -> float:
    return round(total / n, 3) if n else 0.0


def append_perf_record(data_dir: str, rec: dict):
    """One {"record":"perf"} JSONL line into DATA_DIR/perf.jsonl (the
    runlog rotation pair, non-durable appends)."""
    from avida_tpu_torch.observability.records import append_record

    try:
        append_record(os.path.join(data_dir, PERF_FILE), rec,
                      max_bytes=_PERF_MAX_BYTES, durable=False)
    except Exception:
        pass                    # attribution must never kill the run


# ---------------------------------------------------------------------------
# exposition families (the exporter's _render hook)
# ---------------------------------------------------------------------------


def prom_families() -> list:
    """The avida_perf_* families, render_families shaped.  Empty when
    the plane never armed -- profiling-off processes publish
    byte-identical metrics files."""
    if not _chunk["chunks"]:
        return []
    fams = [
        ("avida_perf_chunks_total", "counter",
         "update chunks dispatched under the attribution plane",
         _chunk["chunks"]),
        ("avida_perf_updates_total", "counter",
         "updates covered by profiled chunks", _chunk["updates"]),
        ("avida_perf_probes_total", "counter",
         "fenced phase/footprint probes taken", _chunk["probes"]),
        ("avida_perf_chunk_wall_ms", "gauge",
         "mean boundary-to-boundary chunk wall, unfenced (pipeline "
         "throughput view)", _mean(_chunk["wall_ms"],
                                   _chunk["wall_chunks"])),
        ("avida_perf_chunk_fenced_ms", "gauge",
         "mean dispatch-to-ready wall of probed chunks (device view)",
         _mean(_chunk["fenced_ms"], _chunk["fenced_chunks"])),
        ("avida_perf_probe_ms", "gauge",
         "mean host+device wall of one fenced probe (the plane's "
         "amortized cost)", _mean(_chunk["probe_ms"], _chunk["probes"])),
    ]
    if _chunk["device_chunks"]:
        fams.append(
            ("avida_perf_chunk_device_ms", "gauge",
             "mean CUDA-event device time of probed chunks",
             _mean(_chunk["device_ms"], _chunk["device_chunks"])))
    if _phases:
        fams.append(
            ("avida_perf_phase_ms", "gauge",
             "per-phase ms of the last staged probe (pre/cycles/post "
             "on batches; the staged solo phases otherwise)",
             {f'phase="{n}"': v for n, v in _phases.items()}))
    if _cycle_share is not None:
        fams.append(
            ("avida_perf_cycle_loop_share", "gauge",
             "cycle loop share of the last probed batched update",
             round(float(_cycle_share), 4)))
    if _memory is not None:
        fams += [
            ("avida_perf_device_allocated_bytes", "gauge",
             "bytes the card's caching allocator holds for tensors",
             _memory["allocated_bytes"]),
            ("avida_perf_device_peak_allocated_bytes", "gauge",
             "peak of avida_perf_device_allocated_bytes",
             _memory["peak_allocated_bytes"]),
            ("avida_perf_device_reserved_bytes", "gauge",
             "bytes the card's caching allocator reserved",
             _memory["reserved_bytes"]),
        ]
    fp = _footprint
    if fp is not None:
        fams += [
            ("avida_perf_state_bytes", "gauge",
             "resident PopulationState bytes, padded (nbytes ground "
             "truth)", fp["total_bytes"]),
            ("avida_perf_state_live_bytes", "gauge",
             "occupancy- and genome-length-scaled live bytes (the "
             "bit-packing headroom bound)", fp["live_bytes"]),
            ("avida_perf_state_leaf_bytes", "gauge",
             "padded bytes per PopulationState leaf",
             {f'leaf="{n}"': rec["bytes"]
              for n, rec in fp["leaves"].items()}),
        ]
        if "packed_planes" in fp:
            pp = fp["packed_planes"]
            fams.append(
                ("avida_perf_packed_plane_bytes", "gauge",
                 "resident packed-engine plane bytes (the mid-chunk HBM "
                 "truth; gen_t narrows under TPU_PACKED_BITS)",
                 {f'plane="{n}"': p["bytes"]
                  for n, p in pp["planes"].items()}))
            fams.append(
                ("avida_perf_packed_bytes_per_org", "gauge",
                 "resident packed-plane bytes per organism slot",
                 pp["bytes_per_org"]))
            if pp.get("saved_bytes"):
                fams.append(
                    ("avida_perf_packed_saved_bytes", "gauge",
                     "plane bytes saved by the 5-bit genome codec vs "
                     "the byte layout", pp["saved_bytes"]))
        if "per_world_bytes" in fp:
            fams.append(("avida_perf_world_state_bytes", "gauge",
                         "resident bytes per batched world slot",
                         fp["per_world_bytes"]))
        if fp.get("ghost_bytes"):
            fams.append(("avida_perf_ghost_state_bytes", "gauge",
                         "resident bytes held by inert ghost slots",
                         fp["ghost_bytes"]))
    return fams


def format_status_block(metrics: dict) -> str | None:
    """The `--status` perf line from a metrics.prom dict -- None when the
    plane never published."""
    if "avida_perf_chunks_total" not in metrics:
        return None
    parts = [
        f"chunk {metrics.get('avida_perf_chunk_wall_ms', 0.0):.1f}ms "
        f"wall / {metrics.get('avida_perf_chunk_fenced_ms', 0.0):.1f}ms "
        f"fenced",
        f"{int(metrics.get('avida_perf_probes_total', 0))} probes",
    ]
    if "avida_perf_chunk_device_ms" in metrics:
        parts[0] += (f" / {metrics['avida_perf_chunk_device_ms']:.1f}ms "
                     f"device")
    phases = {k.split('phase="', 1)[1].rstrip('"}'): v
              for k, v in metrics.items()
              if k.startswith('avida_perf_phase_ms{')}
    if phases:
        parts.append("phases " + " ".join(
            f"{n}={v:.1f}" for n, v in phases.items()))
    if "avida_perf_state_bytes" in metrics:
        tb = metrics["avida_perf_state_bytes"]
        lb = metrics.get("avida_perf_state_live_bytes", 0.0)
        live_pct = (lb / tb * 100.0) if tb else 0.0
        parts.append(f"state {tb / 2**20:.1f}MiB "
                     f"({live_pct:.0f}% live)")
    if "avida_perf_device_peak_allocated_bytes" in metrics:
        parts.append(
            f"device peak "
            f"{metrics['avida_perf_device_peak_allocated_bytes'] / 2**20:.1f}"
            f"MiB")
    return "perf        " + ", ".join(parts)
