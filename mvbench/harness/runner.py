"""One run of one cell: set-up, warm-up, the measured window through
`models.stream.stream`, the correctness check, and the result line.

    python3 mvbench/run.py --workload <config>.<mix> --seed N --seconds S
        --trace 0|1

With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a profiled stretch of the same
window.  Every run compares sampled frames with the plain reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_to_multiview_tpu")
WARMUP_FRAMES = 2     # the warm-up stream's frames, of the cell's own shape
PREFETCH = 0          # the stream pulls the source in its loop
TRACE_FROM_FRAME = 4  # the traced stretch starts at this frame


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc does not say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - process_age_s()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class Profiled:
    """The traced stretch: the profiler runs from the stream's request of
    frame `first` to its request of frame `first + frames`; the program's
    launch counters are read at both ends."""

    def __init__(self, first: int, frames: int, cuda: bool):
        import torch
        from stereo_to_multiview_tpu_torch import kernels
        self.torch, self.kernels = torch, kernels
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.first, self.frames = first, frames
        self.running = False
        self.counts0 = self.counts = None
        self.requested = None

    def warm_up(self):
        """One short profile during set-up: the profiler's first start
        initialises its device tracing, which must not fall inside the
        window."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            with torch.profiler.record_function("mvbench.warm_up"):
                torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def incomplete(self) -> bool:
        """True until the stretch has stopped."""
        return self.counts is None

    def _counts(self):
        return {n: fn.launches for n, fn in self.kernels.wrappers().items()}

    def marks(self, window_taken):
        self.taken = window_taken
        return {self.first: self.start, self.first + self.frames: self.stop}

    def start(self):
        self.prof.start()
        self.running = True
        self.counts0 = self._counts()
        with self.torch.profiler.record_function("mvbench.stretch_start"):
            pass

    def stop(self):
        if not self.running:
            return
        with self.torch.profiler.record_function("mvbench.stretch_end"):
            pass
        c = self._counts()
        self.counts = {n: c[n] - self.counts0.get(n, 0) for n in c}
        self.prof.stop()
        self.running = False
        self.requested = sum(1 for i in self.taken
                             if self.first <= i < self.first + self.frames)

    def export(self) -> dict:
        path = os.path.join(tempfile.gettempdir(), "mvbench_trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def e2e_metrics(stats: dict, setup_s: float, peak_bytes: int) -> dict:
    from mvbench.harness.window import percentile
    lat_ms = [x * 1e3 for x in stats["latency_s"]]
    return {
        "fps": {"value": stats["fps"], "unit": "frames/s"},
        "frame_ms_p95": {"value": percentile(lat_ms, 95), "unit": "ms"},
        "peak_mem_gib": {"value": peak_bytes / 2 ** 30, "unit": "GiB"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             pipeline_override=None, program_override=None,
             t_process: float = T_PROCESS) -> dict:
    """Run `cell` once on `device`; returns the result line's object and
    the lines for standard error (`"log"`).  `pipeline_override` changes
    the configuration of program and reference alike (the tests' small
    frames), `program_override` the program's alone (a control's
    dial)."""
    import torch
    from mvbench.harness import check, smi, trace as tr
    from mvbench.harness.window import Window
    from stereo_to_multiview_tpu_torch.config import config_from_dict
    from stereo_to_multiview_tpu_torch.models.stream import stream
    from stereo_to_multiview_tpu_torch.utils.device import (
        enable_compilation_cache)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases = [("imports", time.perf_counter())]
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
    phases.append(("CUDA context", time.perf_counter()))
    lines = []
    enable_compilation_cache(dev)
    phases.append(("kernel libraries", time.perf_counter()))
    pipeline = dict(cell.config["pipeline"], **(pipeline_override or {}))
    cfg = config_from_dict(dict(pipeline, **(program_override or {})))
    mix = cell.traffic
    frames = cell.source.make(seed, cfg, mix, dev)
    src = frames.items
    run = dict(cfg=cfg, depth=mix["depth"], readback=mix["readback"],
               prefetch=PREFETCH, verbose=False, device=dev)
    phases.append(("frames", time.perf_counter()))
    shapes = []
    stream(iter(src[:WARMUP_FRAMES]), on_frame=lambda i, *outs:
           shapes.append([(o.shape, o.dtype) for o in outs]), **run)
    if cuda:
        torch.cuda.synchronize(dev)
    phases.append(("warm-up", time.perf_counter()))

    # sample slots shaped as the warm-up's outputs, allocated before the
    # window: their bytes are taken off the window's peak
    slots = [tuple(torch.empty(shape, dtype=dtype, device=dev)
                   for shape, dtype in shapes[0])
             for _ in range(int(cell.config["check_frames"]))]
    slot_bytes = sum(t.numel() * t.element_size() for s in slots for t in s)
    prof = (Profiled(TRACE_FROM_FRAME, cell.config["trace_frames"], cuda)
            if trace else None)
    win = Window(src, seconds, seed, slots)
    if prof:
        if cuda:
            prof.warm_up()
        win.marks = prof.marks(win.taken)
        win.hold = prof.incomplete
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gpu = smi.gpu_id(dev.index or 0) if cuda else None
    sampler = smi.Sampler(gpu).start() if cuda else None
    error = None
    try:
        stream(win.source(), on_frame=win.on_frame, **run)
    except Exception as e:  # noqa: BLE001 -- the stream gave up: report it
        error = f"{type(e).__name__}: {e}"
    if prof and prof.running:
        prof.stop()
    if cuda:
        torch.cuda.synchronize(dev)
        raw_peak = torch.cuda.max_memory_allocated(dev)
    else:
        raw_peak = slot_bytes
    clocks = sampler.stop() if sampler else None
    stats = win.stats()
    attempted, completed = len(win.taken), stats["frames"]
    failed = attempted - completed
    setup_s = win.taken[0] - t_process if win.taken else float("nan")
    if win.taken:
        phases.append(("slots and the first frame's hand-over", win.taken[0]))
    stamps = [("process start", t_process)] + phases
    lines.append("set-up, s: " + ", ".join(
        f"{name} {t - stamps[k][1]:.3f}" for k, (name, t) in
        enumerate(stamps[1:])))
    lines.append(f"window: {completed} of {attempted} frames completed in "
                 f"{stats['seconds']:.6f} s; frame_ms_p95 over "
                 f"{len(stats['latency_s'])} frame latencies")
    if error:
        lines.append(f"the stream stopped: {error}")
    if clocks:
        lines.append("nvidia-smi beside the window [min, median, max]: "
                     + json.dumps(clocks))

    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(raw_peak)}
    if cuda:
        device_info["power_limit_w"] = smi.power_limit_w(gpu)
    if not trace:
        if completed:
            e2e = e2e_metrics(stats, setup_s, raw_peak - slot_bytes)
            result["metrics"] = {n: e2e[n] for n in cell.end_to_end}
    else:
        st = None
        if prof.requested:
            st = tr.reduce_trace(prof.export(), prof.requested,
                                 prof.counts, pipeline)
        if st is not None and cuda:
            device_info["busy_s"] = st.busy_us() * 1e-6
            device_info["window_s"] = st.window_us * 1e-6
            unattributed = sum(1 for e in st.events if e.stage is None)
            lines.append(f"traced stretch: {st.frames} frames, "
                         f"{len(st.events)} device events "
                         f"({unattributed} with no launching stage)")
        for name, mod in cell.per_layer.items():
            v = mod.read(st, lines) if st is not None else None
            if v is not None:
                result["metrics"][name] = {"value": v, "unit": mod.UNIT}
        if any(n.endswith("_roofline") for n in result["metrics"]):
            lines.append("roofline shares are of the published peaks of one "
                         "H100 SXM at 700 W (3.35 TB/s, 67 T/s); this card's "
                         f"power limit: {device_info.get('power_limit_w')} W")
        if st is not None and st.events:
            result["breakdown"] = tr.breakdown(st)
    result["device"] = device_info

    # the check, after the window: the program's state is gone
    samples = [(win.sampled[j], slots[j]) for j in sorted(win.sampled)]
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    values = check.check_samples(samples, frames.frame_of, pipeline,
                                 cell.reference)
    ok, checks = check.verdict(values)
    lines.append(f"check: {len(samples)} sampled frames "
                 f"{sorted(win.sampled.values())} against the reference in "
                 f"{time.perf_counter() - t0:.3f} s")
    result["correct"] = bool(ok and samples and not failed and not error)
    result["checks"] = checks
    for name, c in checks.items():
        lines.append(f"{name} {c['value']} limit {c['limit']}")
    result["log"] = lines
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from mvbench.harness.cells import load_cell, load_json, ROOT
    cell = load_cell(args.workload)
    entry = next((w for w in load_json(ROOT / "BENCHMARK.json")["workloads"]
                  if w["name"] == args.workload), None)
    chips = entry["chips"] if entry else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    lines = result.pop("log")
    checks = result.pop("checks")
    result["checks"] = checks          # the key that comes last
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0
