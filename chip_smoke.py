#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the build seconds;
2. capture the inputs the serving path hands each kernel for one batch
   of the full-size model, and hold each kernel against its plain
   PyTorch version on those inputs and on ragged edge cases
   (``nbr_sample`` and ``gather_seg_aggr`` max bitwise, mean/sum at
   rtol=atol=1e-5), then time kernel, plain version and, where one
   exists, a one-call PyTorch yardstick;
3. serve the full-size RGCN node-classification config
   (``examples/configs/nc_mag_device.yaml`` widths on a 20 000-paper /
   10 000-author graph, serving batch 64) through the port's entry
   points: a cold phase without cache, then a warm phase; every served
   row must equal single-seed ``infer_device`` bitwise, and both kernel
   launch counters must have moved during these phases;
4. check outputs against references: finite values of the expected
   shapes, and the card's rows against the CPU path (plain PyTorch
   versions) at a small and at the full size.

The last lines are the card's name and power limit, one JSON object of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REQUESTS, REQUEST_SIZE, HOT_FRACTION = 256, 4, 0.8
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
PEAK_FP32_S = 67e12         # H100 SXM float32 outside the tensor cores

FULL = {
    "task": "node_classification", "device_features": True,
    "gnn": {"model": "rgcn", "hidden": 64, "num_layers": 2,
            "fanout": [5, 5], "sparse_embed_dim": 16},
    "hyperparam": {"batch_size": 64, "seed": 0, "sample_on_device": True},
    "input": {"dataset": "mag",
              "dataset_conf": {"n_paper": 20000, "n_author": 10000}},
    "node_classification": {},
    "serve": {"batch_size": 64},
}
SMALL = {
    "task": "node_classification", "device_features": True,
    "gnn": {"hidden": 16, "fanout": [2, 2]},
    "hyperparam": {"batch_size": 16, "seed": 0},
    "input": {"dataset": "mag",
              "dataset_conf": {"n_paper": 80, "n_author": 40}},
    "node_classification": {},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int = 50) -> float:
    """Mean milliseconds between CUDA events around ``reps`` back-to-back
    calls of ``fn()``, after a warm-up.  For launches this small the host
    issues slower than the card runs, so this is the per-call time of the
    whole call (checks, allocation, launch), not the kernel's."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(torch, prof):
    """The trace's device-side entries (kernels, copies, fills); the
    host-side ops that launched them carry the same time and are left
    out so nothing counts twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]


def device_ms(torch, fn, label: str, reps: int = 50, traces: int = 3):
    """Mean device milliseconds of the work ``fn()`` puts on the card:
    the summed durations of its kernels and copies as the profiler's
    CUDA trace records them.  A trace that comes back without device
    time is taken again, at most ``traces`` times in all; then the run
    fails."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total
                 for e in _device_events(torch, prof))
        if us > 0:
            return us / 1e3 / reps
    fail(f"{traces} profiler traces of {label} held no device time")


def profile_batches(torch, fn, reps: int = 10):
    """Wall time, device busy time and the kernels of ``reps`` calls of
    ``fn()``, each ended by a synchronize: per call, wall ms, device
    busy ms, device launches and the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    dev = _device_events(torch, prof)
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    launches = sum(e.count for e in dev) / reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return wall, busy, launches, [
        (e.key[:60], e.self_device_time_total / 1e3 / reps, e.count / reps)
        for e in top]


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def capture_kernel_inputs(torch, inferer, seeds):
    """Run one batch of the serving path with recorders around both
    kernel wrappers; returns the argument tuples each was called with."""
    from repro_torch.kernels.nbr_sample import ops as ns_ops
    from repro_torch.kernels.seg_aggr import ops as sa_ops
    calls = {"nbr_sample": [], "gather_seg_aggr": []}
    orig = (ns_ops.nbr_sample_cuda, sa_ops.gather_seg_aggr_cuda)

    def rec_ns(*args):
        calls["nbr_sample"].append(tuple(a.clone() for a in args))
        return orig[0](*args)

    def rec_sa(table, idx, mask, reduce="mean"):
        calls["gather_seg_aggr"].append(
            (table.clone(), idx.clone(), mask.clone(), reduce))
        return orig[1](table, idx, mask, reduce)

    ns_ops.nbr_sample_cuda, sa_ops.gather_seg_aggr_cuda = rec_ns, rec_sa
    inferer.infer_device(seeds, batch_size=len(seeds))
    ns_ops.nbr_sample_cuda, sa_ops.gather_seg_aggr_cuda = orig
    torch.cuda.synchronize()
    return calls


def nbr_sample_edge_cases(torch, dev):
    g = torch.Generator().manual_seed(1)
    cases = []
    for n, f, e in ((1, 1, 128), (257, 5, 128), (1000, 7, 256)):
        bits = torch.randint(-2 ** 31, 2 ** 31, (n, f), generator=g,
                             dtype=torch.int64).to(torch.int32)
        bits[0, 0] = -1                        # 0xFFFFFFFF
        degs = torch.randint(0, 9, (n,), generator=g, dtype=torch.int32)
        degs[::3] = 0                          # zero-degree rows
        starts = torch.randint(0, e, (n,), generator=g, dtype=torch.int32)
        starts[-1] = e - 1                     # segment past the table end
        degs[-1] = 6
        col = torch.randint(0, 10 ** 6, (e,), generator=g, dtype=torch.int32)
        eid = torch.randint(0, 10 ** 6, (e,), generator=g, dtype=torch.int32)
        cases.append(tuple(t.to(dev) for t in (bits, starts, degs, col, eid)))
    return cases


def gather_seg_aggr_edge_cases(torch, dev):
    g = torch.Generator().manual_seed(2)
    cases = []
    for big_n, n, f, d in ((50, 1, 1, 64), (300, 257, 5, 64),
                           (40, 33, 7, 3), (500, 100, 5, 130),
                           (64, 70, 2, 16)):
        table = torch.randn((big_n, d), generator=g)
        idx = torch.randint(0, big_n, (n, f), generator=g, dtype=torch.int32)
        mask = torch.rand((n, f), generator=g) < 0.7
        mask[::4] = False                      # fully-masked rows
        cases.append(tuple(t.to(dev) for t in (table, idx, mask)))
    return cases


def check_kernels(torch, calls, dev):
    """Kernel == plain version on the captured and edge-case inputs.
    Returns each kernel's largest absolute difference from its plain
    version over all of them (for ``gather_seg_aggr`` over every
    reduce)."""
    from repro_torch.kernels.nbr_sample import nbr_sample_cuda, nbr_sample_ref
    from repro_torch.kernels.seg_aggr import (gather_seg_aggr_cuda,
                                              gather_seg_aggr_ref)
    ns_err = 0.0
    for args in calls["nbr_sample"] + nbr_sample_edge_cases(torch, dev):
        got = nbr_sample_cuda(*args)
        want = nbr_sample_ref(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("nbr", "eid", "mask"), got, want):
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"nbr_sample {name} has shape {tuple(a.shape)} "
                     f"{a.dtype}, the plain version {tuple(b.shape)} "
                     f"{b.dtype}")
            if a.numel():
                ns_err = max(ns_err, float(
                    (a.long() - b.long()).abs().max()))
            if not torch.equal(a, b):
                fail(f"nbr_sample {name} differs from the plain version "
                     f"at shape {tuple(args[0].shape)}")
    err = {"mean": 0.0, "sum": 0.0, "max": 0.0}
    sa_cases = [c[:3] for c in calls["gather_seg_aggr"]] + \
        gather_seg_aggr_edge_cases(torch, dev)
    for table, idx, mask in sa_cases:
        for reduce in ("mean", "sum", "max"):
            got = gather_seg_aggr_cuda(table, idx, mask, reduce)
            want = gather_seg_aggr_ref(table, idx, mask, reduce)
            torch.cuda.synchronize()
            shape = (tuple(table.shape), tuple(idx.shape))
            if reduce == "max":
                if not torch.equal(got, want):
                    fail(f"gather_seg_aggr max differs at {shape}")
            else:
                torch.testing.assert_close(
                    got, want, rtol=1e-5, atol=1e-5,
                    msg=lambda m: f"gather_seg_aggr {reduce} at {shape}: {m}")
            err[reduce] = max(err[reduce],
                              float((got - want).abs().max()) if got.numel()
                              else 0.0)
    log(f"kernels hold against their plain versions: nbr_sample bitwise on "
        f"{len(calls['nbr_sample'])} path + 3 edge cases; gather_seg_aggr on "
        f"{len(calls['gather_seg_aggr'])} path + 5 edge cases, max abs err "
        f"{err}; nbr_sample max abs difference {ns_err}")
    return {"nbr_sample": ns_err, "gather_seg_aggr": max(err.values())}


def measure_kernels(torch, calls, launches, err):
    """Per served batch: every launch the path made, timed back to back
    (kernel, plain version, yardstick) and bounded from its inputs."""
    import torch.nn.functional as F
    from repro_torch.core.prng import MASK
    from repro_torch.kernels.nbr_sample import nbr_sample_cuda, nbr_sample_ref
    from repro_torch.kernels.seg_aggr import (gather_seg_aggr_cuda,
                                              gather_seg_aggr_ref)
    # profiler warm-up: the first trace of a process may come back empty
    device_ms(torch, lambda: torch.zeros(1, device="cuda"), "warm-up")

    ns = {"ms": 0.0, "plain_ms": 0.0, "call_ms": 0.0, "bytes": 0.0,
          "ops": 0.0}
    for bits, starts, degs, col, eid in calls["nbr_sample"]:
        ns["ms"] += device_ms(torch, lambda: nbr_sample_cuda(
            bits, starts, degs, col, eid), "nbr_sample")
        ns["call_ms"] += time_ms(torch, lambda: nbr_sample_cuda(
            bits, starts, degs, col, eid))
        ns["plain_ms"] += device_ms(torch, lambda: nbr_sample_ref(
            bits, starts, degs, col, eid), "nbr_sample plain")
        n, f = bits.shape
        pos = (starts.long()[:, None] + (bits.long() & MASK)
               % degs.clamp(min=1).long()[:, None]).clamp(0, col.numel() - 1)
        nbytes = n * f * 4 + n * 8 + pos.unique().numel() * 8 + n * f * 9
        ns["bytes"] += nbytes
        ns["ops"] += n * f
    sa = {"ms": 0.0, "plain_ms": 0.0, "call_ms": 0.0, "library_ms": 0.0,
          "bytes": 0.0, "ops": 0.0}
    for table, idx, mask, reduce in calls["gather_seg_aggr"]:
        sa["ms"] += device_ms(torch, lambda: gather_seg_aggr_cuda(
            table, idx, mask, reduce), "gather_seg_aggr")
        sa["call_ms"] += time_ms(torch, lambda: gather_seg_aggr_cuda(
            table, idx, mask, reduce))
        sa["plain_ms"] += device_ms(torch, lambda: gather_seg_aggr_ref(
            table, idx, mask, reduce), "gather_seg_aggr plain")
        w = mask.float()
        if reduce == "mean":
            w = w / w.sum(1, keepdim=True).clamp(min=1.0)
        sa["library_ms"] += device_ms(torch, lambda: F.embedding_bag(
            idx, table, mode="sum", per_sample_weights=w), "embedding_bag")
        n, f = idx.shape
        d = table.shape[1]
        rows = idx[mask].unique().numel()
        sa["bytes"] += n * f * 5 + rows * d * 4 + n * d * 4
        sa["ops"] += int(mask.sum()) * d + n * d
    out = []
    for name, st, src, replaces, lib in (
            ("nbr_sample", ns, "src/repro_torch/csrc/nbr_sample.cu",
             "src/repro/kernels/nbr_sample/kernel.py:38", None),
            ("gather_seg_aggr", sa, "src/repro_torch/csrc/gather_seg_aggr.cu",
             "src/repro/kernels/seg_aggr/kernel.py:71",
             sa.get("library_ms"))):
        b, by = bound_ms(st["bytes"], st["ops"])
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err[name], "ms": st["ms"],
                    "plain_ms": st["plain_ms"], "bound_ms": b,
                    "bound_by": by, "library_ms": lib,
                    "call_ms": st["call_ms"]})
    return out


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------
def serve_phase(torch, inferer, num_nodes, cache_slots: int, seed: int):
    from repro_torch.serve import GSgnnInferenceService, request_stream
    svc = GSgnnInferenceService(inferer, batch_size=64,
                                cache_slots=cache_slots,
                                max_staleness_steps=1 << 30)
    reqs = request_stream(num_nodes, num_requests=REQUESTS,
                          request_size=REQUEST_SIZE,
                          hot_fraction=HOT_FRACTION, hot_set=64, seed=seed)
    responses = svc.serve(reqs)
    torch.cuda.synchronize()
    return responses, svc.stats()


def check_served_rows(inferer, responses, label):
    """Every served row == single-seed infer_device, bit for bit."""
    ref = {}
    for resp in responses:
        if resp["status"] != "done":
            fail(f"{label}: request {resp['rid']} ended {resp['status']}")
        for i, s in enumerate(resp["seeds"]):
            s = int(s)
            if s not in ref:
                ref[s] = inferer.infer_device([s], batch_size=64)
            if not (np.array_equal(resp["emb"][i], ref[s]["emb"][0]) and
                    np.array_equal(resp["out"][i], ref[s]["out"][0])):
                fail(f"{label}: served row of seed {s} differs from "
                     f"infer_device([{s}], batch_size=64)")
    return len(ref)


def check_against_cpu(torch, cfg_raw, seeds, tol: float, label: str):
    """The card's rows against the CPU path (plain PyTorch versions of
    the kernels, CPU matmuls) for the same seeded weights."""
    from repro_torch.config import GSConfig
    from repro_torch.runner import build_graph, build_inferer
    cfg = GSConfig.from_dict(cfg_raw).resolved()
    graph = build_graph(cfg)
    rows = {}
    for dev in ("cuda", "cpu"):
        inf = build_inferer(cfg, graph, torch.device(dev))
        rows[dev] = inf.infer_device(seeds, batch_size=len(seeds))
    for key in ("emb", "out"):
        a, b = rows["cuda"][key], rows["cpu"][key]
        if a.shape != b.shape or not np.isfinite(a).all():
            fail(f"{label}: {key} has shape {a.shape} or non-finite values")
        if not np.allclose(a, b, rtol=tol, atol=tol):
            fail(f"{label}: {key} differs from the CPU path by "
                 f"{np.abs(a - b).max()} (tolerance {tol})")
    log(f"{label}: card rows match the CPU path within {tol} "
        f"(max abs diff emb {np.abs(rows['cuda']['emb'] - rows['cpu']['emb']).max():.3g}, "
        f"out {np.abs(rows['cuda']['out'] - rows['cpu']['out']).max():.3g})")


# ---------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.config import GSConfig
    from repro_torch.kernels.build import build
    from repro_torch.kernels.nbr_sample import ops as ns_ops
    from repro_torch.kernels.seg_aggr import ops as sa_ops
    from repro_torch.runner import build_graph, build_inferer
    kernels = {"nbr_sample": ns_ops.KERNEL, "gather_seg_aggr": sa_ops.KERNEL}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # phase 1 ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build(["nbr_sample.cu", "gather_seg_aggr.cu"])
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(" + ", ".join(f"{s}: {b['seconds']:.1f} s"
                         for s, b in built.items()) + ")")
    for s, b in built.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {s}: {line.strip()}")

    # full-size model -------------------------------------------------------
    t0 = time.perf_counter()
    cfg = GSConfig.from_dict(FULL).resolved()
    graph = build_graph(cfg)
    inferer = build_inferer(cfg, graph, dev)
    num_nodes = graph.num_nodes[inferer.target_ntype]
    log(f"full-size model on the card in {time.perf_counter() - t0:.1f} s: "
        f"{graph.num_nodes} nodes, {graph.num_edges()} edges, hidden "
        f"{cfg.gnn.hidden}, fanout {cfg.gnn.fanout}, batch 64")

    # phase 2 ---------------------------------------------------------------
    probe = np.random.default_rng(5).choice(num_nodes, 64, replace=False)
    calls = capture_kernel_inputs(torch, inferer, probe)
    if not calls["nbr_sample"] or not calls["gather_seg_aggr"]:
        fail("the serving path launched no kernel while capturing inputs")
    err = check_kernels(torch, calls, dev)

    # phase 3 ---------------------------------------------------------------
    for k in kernels.values():
        k.launches = 0
    cold, cold_stats = serve_phase(torch, inferer, num_nodes, 0, seed=1)
    warm, warm_stats = serve_phase(torch, inferer, num_nodes, 4096, seed=2)
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched while serving")
    batches = cold_stats["compute_batches"] + warm_stats["compute_batches"]
    log(f"phase 3: launches while serving {launches} over {batches} "
        f"compute batches")
    for label, st in (("cold", cold_stats), ("warm", warm_stats)):
        log(f"serve {label} (cache_slots {0 if label == 'cold' else 4096}, "
            f"{REQUESTS} requests x {REQUEST_SIZE} seeds, hot fraction "
            f"{HOT_FRACTION}): p50 {st['p50_ms']:.3f} ms, p99 "
            f"{st['p99_ms']:.3f} ms, {st['req_per_s']:.1f} req/s, "
            f"compute batches {st['compute_batches']}, hit rate "
            f"{st['hit_rate']:.3f} | {smi}")
    if warm_stats["warm_rows"] <= 0:
        fail("the warm phase served no row from the cache")
    n_ref = check_served_rows(inferer, cold, "cold") + \
        check_served_rows(inferer, warm, "warm")
    log(f"served rows equal single-seed infer_device bitwise "
        f"({n_ref} seeds checked)")

    # where the time of one cold batch goes ------------------------------
    prog = inferer.device_infer_program(64)
    sampler = inferer.device_sampler
    ids = torch.from_numpy(probe.astype(np.int32)).to(dev)
    for label, fn in (
            ("program (sample + gather + GNN + head)", lambda: prog(probe)),
            ("sampling alone (threefry + nbr_sample)",
             lambda: sampler.sample(prog.plan, {inferer.target_ntype: ids},
                                    seed_keyed=True))):
        wall, busy, n_launch, top = profile_batches(torch, fn)
        log(f"one cold batch of 64, {label}: wall {wall:.3f} ms, device "
            f"busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}), "
            f"{n_launch:.0f} device ops | {smi}")
        for name, ms, count in top:
            log(f"    {ms:.4f} ms in {count:.0f} x {name}")

    # phase 4 ---------------------------------------------------------------
    check_against_cpu(torch, SMALL, np.arange(16), 1e-5, "small model")
    check_against_cpu(torch, FULL, probe[:16], 1e-4, "full-size model")

    table = measure_kernels(torch, calls, launches, err)
    for row in table:
        log(f"{row['name']}: device {row['ms']:.4f} ms per batch "
            f"(profiler; whole calls {row['call_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.6f} by "
            f"{row['bound_by']}, library {row['library_ms']} | {smi}")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
