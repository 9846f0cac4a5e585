"""One run of one cell: set-up, the measured window, the reference's
verdict, the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration, whose
file gives the ACIR program (``programs/<program>.py``), its proof
parameters and the sizes of its inputs, and a traffic mix
(``traffic/<traffic>.json``: the environment the program runs in, the
warm-up proofs, the proofs the reference checks).  The client is one
closed loop: each proof calls ``tpu_acir_prover_torch.api.prove_file``
on a witness file that no earlier proof of the run used, and the next
starts when its compressed proof file is written.  The harness leaves the
collector's policy as the program ships it.
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import shutil
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from . import metrics, programs, reference, trace
from .frozen.acir import codec
from .frozen.acir import ir

# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_acir_prover")
# the proofs checked always include the last and the slowest; the rest of
# the sample is drawn with this salt on the run's seed
CHECK_SALT = 0x5EED_C4EC
# the window's witness pool holds this many times the proofs that the
# warm-up's fastest warm proof would fit into the window (traced runs and
# a slower host need fewer; window proofs read down to ~0.8 of it)
POOL_MARGIN = 2
# seconds between the traced window's last proof, with the card idle, and
# the profiler's stop: CUPTI writes a kernel's record (its timestamps) on
# its own thread after the kernel ends, and the pause lets it complete and
# hand over every record of the window before the stop flushes, so that
# none is missing from the launch check or lies outside the window.  The
# window's metrics end at its last proof, so the pause is in none of them.
TRACE_SETTLE_S = 2.0


class Proof(NamedTuple):
    witness: int
    start: float
    end: float
    phases: Dict[str, float]
    error: str
    cpu_s: float = 0.0              # the process's CPU time in the proof

    @property
    def latency_s(self) -> float:
        return self.end - self.start


class Run(NamedTuple):
    """What a metric reader reads (``metrics/``)."""
    proofs: List[Proof]
    window_s: float
    setup_s: float
    peak_bytes: int
    vk: object                      # the reference's verifying key
    trace: Optional[trace.Summary]


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {', '.join(sorted(cells))}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "prover_bench" / "traffic" / f"{w['traffic']}.json")
        .read_text())

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(workload, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _phase_timer(traced: bool):
    """A ``PhaseTimer`` that also marks each phase for the profiler, inside
    the program's own span: the record that ``timing.finished()`` keeps of
    the proof holds its spans, and the mark stays the innermost
    annotation, the one whose shadow on the card carries its name (a
    torch whose events give no activity type tells the shadow by it)."""
    from torch.profiler import record_function
    from tpu_acir_prover_torch.utils.timing import PhaseTimer

    class Spans(PhaseTimer):
        @contextmanager
        def phase(self, name: str):
            mark = record_function(trace.PHASE_SPAN + name) if traced \
                else nullcontext()
            with super().phase(name), mark:
                yield

    return Spans()


def _warm_profiler():
    """One short profiler session before the graph is captured: CUPTI then
    records the kernels of the graph's replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _sample(proofs: List[Proof], k: int, seed: int) -> List[int]:
    """Indices into ``proofs``: the last, the slowest, and others drawn from
    the seed, ``k`` in all (or every proof)."""
    n = len(proofs)
    if n <= k:
        return list(range(n))
    pick = {n - 1, max(range(n), key=lambda i: proofs[i].latency_s)}
    rest = [i for i in range(n) if i not in pick]
    pick.update(random.Random(seed ^ CHECK_SALT).sample(rest, k - len(pick)))
    return sorted(pick)


def _describe(proofs: List[Proof]) -> None:
    """The window's latencies and each phase's median on standard error."""
    def q(vals):
        vals = sorted(vals)
        return " ".join(f"{vals[round(f * (len(vals) - 1))] * 1e3:.1f}"
                        for f in (0, 0.25, 0.5, 0.75, 1))

    print(f"window: {len(proofs)} proofs; latency ms min q1 med q3 max "
          f"{q([p.latency_s for p in proofs])}; CPU ms "
          f"{q([p.cpu_s for p in proofs])}", file=sys.stderr)
    print("  latency ms in order " + " ".join(f"{p.latency_s * 1e3:.0f}"
                                             for p in proofs), file=sys.stderr)
    for name in sorted({n for p in proofs for n in p.phases}):
        print(f"  {name} ms {q([p.phases[name] for p in proofs if name in p.phases])}",
              file=sys.stderr)


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", control: bool = False,
        t_start: Optional[float] = None) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``control`` proves with one bit of proof of work fewer than the
    configuration states (the control of ``correct``: never in a run of
    the benchmark)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(root, workload)
    cfg, traffic = cell.config, cell.traffic
    os.environ.update(traffic.get("env", {}))

    import torch
    if device == "cuda" and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"{workload} needs {cell.chips} CUDA device(s); "
                         f"this machine has "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from tpu_acir_prover_torch import api
    from tpu_acir_prover_torch.prover.config import ProofConfig
    from tpu_acir_prover_torch.prover.fused import all_launches

    stated = reference.proof_config(cfg)
    pcfg = ProofConfig(**cfg["proof_config"])
    if control:
        pcfg = ProofConfig(**{**cfg["proof_config"],
                              "pow_bits": stated.pow_bits - 1})
    prog = programs.load(cfg["program"])
    families = trace.load_families(root)
    work = Path(tempfile.mkdtemp(prefix="prover_bench_"))
    try:
        # ---- set-up: inputs, the cold CLI path, warm-up proofs ------------
        art = str(work / "program.json")
        codec.save_program_artifact(art, prog.build(cfg))
        rng = random.Random(seed)
        wits: List[str] = []
        pool_s = 0.0

        def make_witness_files(upto: int) -> None:
            """Witness files ``len(wits)`` .. ``upto - 1``, the next inputs
            drawn from the seed; the generator's outputs are held to the
            plain reference first (a fault of the benchmark's inputs ends
            the run).  Their seconds go to ``pool_s``, not to ``setup_s``:
            the files are the benchmark's inputs (a user's ``nargo
            execute``), not the program's set-up."""
            nonlocal pool_s
            t0 = time.perf_counter()
            while len(wits) < upto:
                inputs = prog.draw(cfg, rng)
                wm = prog.witness(cfg, inputs)
                if prog.check(cfg, inputs, wm):
                    raise SystemExit(f"the {cfg['program']} generator's "
                                     f"witness {len(wits)} returns other "
                                     f"outputs than its plain reference")
                wits.append(str(work / f"w{len(wits)}.gz"))
                codec.save_witness_stack(wits[-1], ir.WitnessStack(
                    [ir.StackItem(0, wm)]))
            pool_s += time.perf_counter() - t0

        warm = traffic["warmup_proofs"]
        make_witness_files(warm)
        if traced and device == "cuda":
            _warm_profiler()
        warm_s = []
        for i in range(warm):
            t0 = time.perf_counter()
            api.prove_file(art, wits[i], str(work / f"proof{i}.bin"), pcfg,
                           device)
            warm_s.append(time.perf_counter() - t0)
        fastest = min(warm_s[1:] or warm_s)
        make_witness_files(
            warm + math.ceil(POOL_MARGIN * seconds / fastest) + 4)
        pool = len(wits)
        outs = [str(work / f"proof{i}.bin") for i in range(pool)]
        vk_path = str(work / "vk.bin")
        api.write_vk_file(art, vk_path, pcfg, device)
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start - pool_s

        # ---- the window ----------------------------------------------------
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if device == "cuda" else [])
            prof = profile(activities=acts)
        before = all_launches()
        proofs: List[Proof] = []
        nxt = warm
        if prof is not None:
            prof.start()
        w0 = time.perf_counter()
        while not proofs or time.perf_counter() - w0 < seconds:
            if nxt >= pool:
                # POOL_MARGIN times faster than the warm-up: the window
                # closes early, over the proofs it completed
                print(f"the window's {pool - warm} witness files ran out "
                      f"after {time.perf_counter() - w0:.3f} s",
                      file=sys.stderr)
                break
            timer = _phase_timer(traced)
            mark = record_function(trace.PROOF_SPAN) if traced \
                else nullcontext()
            err = ""
            c0 = time.process_time()
            t0 = time.perf_counter()
            with mark:
                try:
                    api.prove_file(art, wits[nxt], outs[nxt], pcfg, device,
                                   timer=timer)
                except Exception:  # a failed proof is counted, not fatal
                    err = traceback.format_exc(limit=3)
                    print(err, file=sys.stderr)
            t1 = time.perf_counter()
            c1 = time.process_time()
            phases: Dict[str, float] = {}
            for name, s in timer.phases:
                phases[name] = phases.get(name, 0.0) + s
            proofs.append(Proof(nxt, t0, t1, phases, err, c1 - c0))
            nxt += 1
        window_s = proofs[-1].end - w0
        print(f"set-up: {setup_s:.3f} s; witness pool: {pool} files in "
              f"{pool_s:.6f} s, outside setup_s", file=sys.stderr)
        _describe(proofs)
        if prof is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            time.sleep(TRACE_SETTLE_S)
            prof.stop()
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules of JAX or the JAX package loaded: "
                             f"{', '.join(found)}")
        peak = torch.cuda.max_memory_reserved() if device == "cuda" else 0

        # ---- the trace -----------------------------------------------------
        summary = None
        if prof is not None:
            summary = trace.summarize(prof, families)
            del prof
            if device == "cuda":
                after = all_launches()
                _, pk = api.load_and_compile(art, pcfg, device)
                per_replay = pk._captured.launches if pk._captured else {}
                replays = sum("fused_device" in p.phases for p in proofs)
                counters = {c for fam in families.values()
                            for c in fam.values()}
                trace.check_launches(summary, {
                    c: after.get(c, 0) - before.get(c, 0) +
                    replays * per_replay.get(c, 0) for c in counters})
                del pk

        # ---- the reference, with the program's state freed -----------------
        api._CACHE.clear()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        circuit = reference.load_circuit(art)
        vk = reference.derive_vk(circuit, stated, device)
        with open(vk_path, "rb") as f:
            vk_differs = int(f.read() != reference.vk_bytes(vk))
        t_vk = time.perf_counter()
        checked = [proofs[i] for i in
                   _sample(proofs, traffic["checked_proofs"], seed)
                   if not proofs[i].error]
        committed = []
        for p in checked:
            with open(outs[p.witness], "rb") as f:
                committed.append(reference.proof_wires_cap(f.read()))

        def own_wires():
            """Checked proofs whose wire commitment is not the one their
            own witness file gives, worked out while the verifier runs."""
            return sum(got != reference.wires_cap(circuit, wits[p.witness],
                                                  stated, device)
                       for p, got in zip(checked, committed))

        verdicts, not_own = reference.judge_files(
            vk, [outs[p.witness] for p in checked], own_wires)
        rejected = 0
        for p, why in zip(checked, verdicts):
            if why:
                rejected += 1
                print(f"proof of witness {p.witness} rejected: {why}",
                      file=sys.stderr)
        print(f"reference: key {t_vk - t_ref:.1f} s, {len(checked)} proofs "
              f"judged and their wires committed "
              f"{time.perf_counter() - t_vk:.1f} s", file=sys.stderr)
        failed = sum(bool(p.error) for p in proofs)
        # a proof whose wire commitment repeats an earlier one's (set-up's
        # included) was not made from its own witness
        seen, repeated = set(), 0
        for i in list(range(warm)) + [p.witness for p in proofs
                                      if not p.error]:
            with open(outs[i], "rb") as f:
                cap = reference.proof_wires_cap(f.read())
            cap = cap and tuple(cap)
            repeated += cap is not None and cap in seen
            seen.add(cap)
        compared = {
            "vk_bytes_differ": {"value": vk_differs, "limit": 0},
            "proofs_rejected": {"value": rejected, "limit": 0,
                                "checked": len(checked)},
            "wires_not_own": {"value": not_own, "limit": 0,
                              "checked": len(checked)},
            "proofs_failed": {"value": failed, "limit": 0},
            "proofs_repeated": {"value": repeated, "limit": 0},
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result_run = Run(proofs, window_s, setup_s, peak, vk, summary)
    wanted = cell.per_layer if traced else cell.end_to_end
    out_metrics = {}
    for m in wanted:
        v = metrics.load(m["name"]).read(result_run)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": cell.chips if device == "cuda" else 0,
           "memory_peak_bytes": peak}
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in compared.values()),
            "attempted": len(proofs), "failed": failed,
            "metrics": out_metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.device_ops,
                             "idle_gaps": summary.idle_gaps}
    line["compared"] = compared
    return line


def report(line: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, c in line["compared"].items():
        extra = "".join(f" {k} {v}" for k, v in c.items()
                        if k not in ("value", "limit"))
        print(f"compared {name} {c['value']} limit {c['limit']}{extra}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
