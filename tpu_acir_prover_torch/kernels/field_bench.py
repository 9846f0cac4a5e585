"""Times the field kernels on the card by their device time, and the proofs
that launch them, for one checkout of the package.

    python -m tpu_acir_prover_torch.kernels.field_bench [--out FILE]

Run it by path with another checkout first on ``PYTHONPATH`` to measure
that checkout's kernels (it uses only the wrappers that checkout has:
``add``, ``sub``, ``mul``, ``pow_const``, ``ext_mul``, ``ext_inv``, and
``ext_prod`` where there is one, else its fold of ``ext_mul`` launches):

    PYTHONPATH=<checkout> python tpu_acir_prover_torch/kernels/field_bench.py

Prints one JSON object per line, each with the package it measured and the
card's name and power limit, and writes them all to ``--out`` (default
``chiprun_out/field_bench.json``):

- ``kernel``: each field op at the main path's shapes and at the largest
  recorded layout of the classes that were furthest below their bound, by
  ``device_ms``: the kernels' device time per call;
- ``host``: each wrapper's host time per call, back to back without a
  synchronisation, at small shapes (the median of HOST_BATCHES rounds);
- ``proof``: the 2^17-row ECDSA circuit's warm per-phase proof (median of
  3) and warm fused proof (median of 3), the 2^20-row ``mul_chain``
  circuit's warm fused proof (mean of 2), all at ``STANDARD_CONFIG``;
- ``replay``: one fused replay of each of the two under
  ``torch.profiler``: device operations and time, and each field kernel's
  launches and device time.

Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the field kernels' profiler names
FIELD_KERNELS = ("gl_binary_kernel", "gl_pow_kernel", "ext_mul_kernel",
                 "ext_prod_kernel", "ext_inv_kernel")
PATHS = ("flat", "rows", "tiled", "general")   # csrc/field.cu's Path
GRAPH_REPS = 5
FLUSH_BYTES = 256 << 20       # evicts the card's 50 MB L2 cache
SPIN_CYCLES = 2_000_000      # about 1 ms of the card's clock
# device_ms's methods, as the records name them
METHODS = ("device time of a launch in a replayed graph under "
           "torch.profiler, the L2 evicted before each",
           "CUDA events around each eager launch queued behind a spin, the "
           "L2 evicted before each (the profiler saw no launch)")
HOST_CALLS = 200
HOST_BATCHES = 9


def device_ms(call, kernels=FIELD_KERNELS, reps=GRAPH_REPS):
    """(ms, method): the device time of one ``call`` spent in ``kernels``
    (profiler names), in ms, and the method that measured it, one of
    METHODS.  First by ``torch.profiler``: ``reps`` calls in a CUDA graph,
    each after a sum over FLUSH_BYTES that evicts the L2 cache (so that the
    operands come from device memory, as a bound counts them; a read leaves
    no dirty lines for the call to write back), one replay profiled.  Where
    the profiler sees fewer than ``reps`` launches of them in three
    replays, by ``event_ms`` instead."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            flush.sum()
            call()
    graph.replay()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        ours = device_totals(prof, kernels)[2].values()
        if sum(c for c, _ in ours) >= reps:
            return sum(t for _, t in ours) / reps / 1e3, METHODS[0]
    del graph
    return event_ms(call, flush, reps), METHODS[1]


def event_ms(call, flush, reps=GRAPH_REPS):
    """The mean device time of ``reps`` eager calls, in ms, each after
    ``flush.sum()`` (which evicts the L2 cache) and bracketed by CUDA
    events queued behind a spin of SPIN_CYCLES: the host enqueues the
    call while the card spins, so the events time the card and not the
    host's pace.  A call whose first event had already completed when its
    last was enqueued (the host fell behind the spin) is timed again, up to
    ``4 * reps`` tries in all."""
    ts = []
    for _ in range(4 * reps):
        if len(ts) == reps:
            break
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        call()
        end.record()
        behind = start.query()
        end.synchronize()
        if not behind:
            ts.append(start.elapsed_time(end))
    if len(ts) < reps:
        raise RuntimeError(f"the host fell behind a spin of {SPIN_CYCLES} "
                           f"cycles in {4 * reps - len(ts)} of {4 * reps} "
                           "calls: device time not measured")
    return sum(ts) / reps


def device_totals(prof, kernels=FIELD_KERNELS):
    """The device activity of a ``torch.profiler`` run: (device us, device
    operations, {each of ``kernels`` (profiler names): [launches, us]},
    {gl_binary or ext_mul kernel/path: [launches, us]})."""
    from torch.autograd import DeviceType
    total_us = total_n = 0
    ours = {k: [0, 0.0] for k in kernels}
    paths = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        # the name changed between torch versions
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        total_us += us
        total_n += e.count
        for k in ours:
            if k in e.key:
                ours[k][0] += e.count
                ours[k][1] += us
        m = re.search(r"(gl_binary|ext_mul)_kernel<(?:\d+, )?(\d+)>", e.key)
        if m:
            k = f"{m.group(1)}/{PATHS[int(m.group(2))]}"
            paths[k][0] += e.count
            paths[k][1] += us
    return total_us, total_n, ours, dict(paths)


def replay_profile(run):
    """One ``run()`` (a replay) under torch.profiler: (device operations,
    device ms, {field kernel: [launches, device ms]})."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us, ops, ours, _ = device_totals(prof)
    return ops, us / 1e3, {k: [n, t / 1e3] for k, (n, t) in ours.items()}


def _cases(rng, dev):
    """(name, call) of the field ops at the main path's shapes and at the
    recorded layouts furthest below their bound."""
    from tpu_acir_prover_torch.field import ext_plain, gl_plain
    from tpu_acir_prover_torch.kernels import field as kf
    from tpu_acir_prover_torch.kernels.bench import field_input

    def col(n, c):
        return field_input(rng, (n, c), dev)

    def pool(shape):
        return field_input(rng, (int(np.prod(shape)),), dev)

    def view(sizes, strides, base):
        return torch.as_strided(base, sizes, strides)

    def group(t, cols):
        if hasattr(kf, "ext_prod"):
            return kf.ext_prod(t, cols)
        items = [(t[0][:, c], t[1][:, c]) for c in cols]
        while len(items) > 1:
            items = [kf.ext_mul(items[i], items[i + 1]) if i + 1 < len(items)
                     else items[i] for i in range(0, len(items), 2)]
        return items[0]

    def checked(call, twin):
        got, want = call(), twin()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError("kernel differs from the plain twin")
        return call

    big = col(1 << 20, 43)
    coset = col(1 << 20, 1)
    v = col(1 << 23, 8).reshape(-1, 2, 2, 1 << 10, 8)
    tw = field_input(rng, (1 << 10,), dev).reshape(1, 1 << 10, 1)
    flat_a, flat_b = pool((1 << 26,)), pool((1 << 26,))
    tr_a, tr_b = pool((1 << 21, 32)), pool((1 << 21, 32))
    m42 = pool((1 << 21, 42))
    c42 = pool((1 << 21,))
    m43 = col(1 << 18, 43)
    c16 = col(1 << 18, 16)
    o1, o2 = pool((1 << 20,)), pool((16,))
    e16 = [col(1 << 17, 16) for _ in range(4)]
    lk = (col(1 << 17, 16), field_input(rng, (), dev).expand(1 << 17, 16))
    inv18 = pool((1 << 18,))
    cases = [
        ("gl_binary mul (2^20, 43) x (2^20, 1) [rows]",
         lambda: kf.mul(big, coset), lambda: gl_plain.mul(big, coset)),
        ("gl_binary mul NTT view v[:, 0, 1] at 2^23 x 8 x (1, 2^10, 1) "
         "twiddles [rows]", lambda: kf.mul(v[:, 0, 1], tw),
         lambda: gl_plain.mul(v[:, 0, 1], tw)),
        ("gl_binary add (2^26,) contiguous [flat]",
         lambda: kf.add(flat_a, flat_b), lambda: gl_plain.add(flat_a,
                                                              flat_b)),
        ("gl_binary add sizes [16, 2^21] strides [[1, 32], [1, 32]] [tiled]",
         lambda: kf.add(view((16, 1 << 21), (1, 32), tr_a),
                        view((16, 1 << 21), (1, 32), tr_b)),
         lambda: gl_plain.add(view((16, 1 << 21), (1, 32), tr_a),
                              view((16, 1 << 21), (1, 32), tr_b))),
        ("gl_binary mul sizes [2^21, 42] strides [[42, 1], [1, 0]] [rows]",
         lambda: kf.mul(m42.view(1 << 21, 42), c42.view(-1, 1)),
         lambda: gl_plain.mul(m42.view(1 << 21, 42), c42.view(-1, 1))),
        ("gl_binary mul sizes [2^18, 16] strides [[43, 1], [16, 1]] [rows]",
         lambda: kf.mul(m43[:, :16], c16),
         lambda: gl_plain.mul(m43[:, :16], c16)),
        ("gl_binary sub sizes [2^18] strides [[0], [43]] [flat]",
         lambda: kf.sub(m43[0, 0], m43[:, 5]),
         lambda: gl_plain.sub(m43[0, 0], m43[:, 5])),
        ("gl_binary mul sizes [2^20, 16] strides [[1, 0], [0, 1]] [rows]",
         lambda: kf.mul(o1.view(-1, 1), o2.view(1, -1)),
         lambda: gl_plain.mul(o1.view(-1, 1), o2.view(1, -1))),
        ("gl_pow inv (2^18,)", lambda: kf.pow_const(inv18, gl_plain.P - 2),
         lambda: gl_plain.inv(inv18)),
        ("ext_mul (2^17,) columns of (2^17, 16) pairs [flat]",
         lambda: kf.ext_mul((e16[0][:, 3], e16[1][:, 3]),
                            (e16[2][:, 5], e16[3][:, 5])),
         lambda: ext_plain.mul((e16[0][:, 3], e16[1][:, 3]),
                               (e16[2][:, 5], e16[3][:, 5]))),
        ("ext group product, (2^17, 16) pair, columns 0-5 (ext_prod, or a "
         "fold of ext_mul)", lambda: group((e16[0], e16[1]), range(6)),
         lambda: ext_plain.mul(ext_plain.mul(
             ext_plain.mul((e16[0][:, 0], e16[1][:, 0]),
                           (e16[0][:, 1], e16[1][:, 1])),
             ext_plain.mul((e16[0][:, 2], e16[1][:, 2]),
                           (e16[0][:, 3], e16[1][:, 3]))),
             ext_plain.mul((e16[0][:, 4], e16[1][:, 4]),
                           (e16[0][:, 5], e16[1][:, 5])))),
        ("ext group product, (2^17, 16) pair, lam1 broadcast, columns 0-2",
         lambda: group(lk, range(3)),
         lambda: ext_plain.mul(ext_plain.mul(
             (lk[0][:, 0], lk[1][:, 0]), (lk[0][:, 1], lk[1][:, 1])),
             (lk[0][:, 2], lk[1][:, 2]))),
        ("ext_inv (2^17, 16), im broadcast", lambda: kf.ext_inv(lk),
         lambda: ext_plain.inv(lk)),
    ]
    return [(name, checked(call, twin)) for name, call, twin in cases]


def host_us(rng, dev):
    """Each field wrapper's host time per call, in us: the median over
    HOST_BATCHES rounds of HOST_CALLS calls back to back at small shapes
    (their kernels shorter than the calls, so that the launch queue never
    fills), timed on the host; each round times every wrapper in turn."""
    from tpu_acir_prover_torch.field import gl_plain
    from tpu_acir_prover_torch.kernels import field as kf
    from tpu_acir_prover_torch.kernels.bench import field_input
    a = field_input(rng, (1 << 12,), dev)
    b = field_input(rng, (1 << 12,), dev)
    m = field_input(rng, (1 << 12, 16), dev)
    column, scalar = m[:, 3], a[0]
    calls = {"add": lambda: kf.add(a, b),
             "mul column x scalar": lambda: kf.mul(column, scalar),
             "pow_const inv": lambda: kf.pow_const(a, gl_plain.P - 2),
             "ext_mul": lambda: kf.ext_mul((a, b), (b, a)),
             "ext_inv": lambda: kf.ext_inv((a, b))}
    if hasattr(kf, "ext_prod"):
        calls["ext_prod 6 columns"] = lambda: kf.ext_prod((m, m), range(6))
    rounds = {name: [] for name in calls}
    for call in calls.values():
        call()
    for _ in range(HOST_BATCHES):
        for name, call in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                call()
            rounds[name].append((time.perf_counter() - t0) / HOST_CALLS)
    torch.cuda.synchronize()
    return {name: sorted(ts)[HOST_BATCHES // 2] * 1e6
            for name, ts in rounds.items()}


def _timed(fn, n):
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return ts


def _replay(pk, ext):
    cc = pk.compiled
    vals = cc.generate_witness(ext)
    pub = np.array(cc.public_values(vals), dtype=np.uint64)
    mcol = cc.multiplicities(cc.wire_values(vals)) if pk.has_lookups \
        else None
    ops, ms, ours = replay_profile(lambda: pk._captured.run(vals, pub, mcol))
    return {"device_operations": ops, "device_ms": ms, "field": ours,
            "capture_launches": pk._captured.launches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/field_bench.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("field_bench: torch.cuda.is_available() is false")
    import tpu_acir_prover_torch as pkg
    from tpu_acir_prover_torch.acir.translator import translate_program
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.utils import circuits
    from tpu_acir_prover_torch.utils.bench_circuits import mul_chain_circuit

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    rows = []

    def emit(rec):
        rec.update(package=pkg.__path__[0], card=card)
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    for name, call in _cases(rng, dev):
        ms, method = device_ms(call)
        emit({"kernel": name, "device_ms": ms, "ms_method": method})
    torch.cuda.empty_cache()
    emit({"host": host_us(rng, dev),
          "unit": "us per call"})

    prog, wm = circuits.ecdsa_secp256k1()
    tr = translate_program(prog)
    pk = ProvingKey(compile_circuit(tr.builder), STANDARD_CONFIG,
                    device="cuda")
    ext = tr.external_values(wm)
    prove(pk, ext)
    prove_fused(pk, ext)
    per_phase = _timed(lambda: prove(pk, ext), 3)
    fused = _timed(lambda: prove_fused(pk, ext), 3)
    emit({"proof": "ecdsa_secp256k1 2^17 warm", "per_phase_s": per_phase,
          "per_phase_median_s": sorted(per_phase)[1], "fused_s": fused,
          "fused_median_s": sorted(fused)[1]})
    emit({"replay": "ecdsa_secp256k1 2^17 fused", **_replay(pk, ext)})
    del pk
    torch.cuda.empty_cache()

    cc = mul_chain_circuit(20)
    ext = np.array([], dtype=np.uint64)
    pk = ProvingKey(cc, STANDARD_CONFIG, device="cuda")
    prove_fused(pk, ext)
    fused = _timed(lambda: prove_fused(pk, ext), 2)
    emit({"proof": "mul_chain 2^20 warm fused", "fused_s": fused,
          "fused_mean_s": sum(fused) / len(fused)})
    emit({"replay": "mul_chain 2^20 fused", **_replay(pk, ext)})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    sys.exit(main())
