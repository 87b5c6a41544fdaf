"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result."""

import gc
import json
import os
import tempfile
import time

import numpy as np
import torch

from . import manifest, program as prog, yardstick

SLICE_SPAN = "benchmark.slice"


class Run:
    """What a client and a metric reader see of the run."""

    def __init__(self, cell, seed, device, rank=0, world=1):
        self.cell = cell
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rng = np.random.default_rng([self.seed % 2**63, 2])
        self.rank, self.world = rank, world
        self.on_card = self.device.type == 'cuda'
        # filled by run_cell for the metric readers
        self.busy = None            # device_busy of this rank's slice
        self.events = None          # this rank's exported slice events
        self.busy_s = self.window_s = None   # averaged over the ranks
        self.slice_counters = {}
        self.slice_requests = 0
        self.key_prep_s = None
        self.latencies = []
        self.client = None

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    @staticmethod
    def clock():
        return time.perf_counter()

    def agree(self, stop):
        """Rank 0's decision, on every rank."""
        if self.world == 1:
            return stop
        import torch.distributed as dist
        flag = torch.tensor([int(stop)], device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def barrier(self):
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()


def _export_events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _gather_objects(run, obj):
    if run.world == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * run.world
    dist.all_gather_object(out, obj)
    return out


def end_to_end_value(name, run, window_s, requests):
    client = run.client
    if name == "ms_per_bit":
        return yardstick.window_ms_per_bit(
            window_s, requests * client.bits_per_request)
    if name == "circuit_ms_p50":
        return yardstick.percentile(run.latencies, 50) * 1e3
    if name == "circuit_ms_p95":
        return yardstick.percentile(run.latencies, 95) * 1e3
    raise KeyError("no rule for the end-to-end metric %r" % name)


def run_cell(cell, seed, seconds, trace, device, t_start, control=False,
             rank=0, world=1, log=print):
    """One run; returns the result (rank 0) or None (other ranks)."""
    run = Run(cell, seed, device, rank, world)
    cfg, tr = cell.cfg, cell.traffic
    client = run.client = cell.client_class()(run)
    phases = {"start": run.clock() - t_start}
    client.make_keys()
    run.sync()
    phases["keygen"] = run.clock() - t_start - sum(phases.values())
    if run.on_card:
        # the peak read is the program's: keys, inputs and their work,
        # not the benchmark's own keygen temporaries
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)
    program = prog.Program(cfg, client.raw, device,
                           cfg.get('control') if control else None,
                           counters=cell.counters())
    client.attach(program)
    run.sync()
    t0 = run.clock()
    client.prepare_keys(program)
    run.sync()
    run.key_prep_s = run.clock() - t0
    client.setup(program)
    run.sync()
    phases["program_and_inputs"] = (run.clock() - t_start
                                    - sum(phases.values()))
    warmup = int(tr['warmup_requests'])
    for _ in range(warmup):
        client.request()
        run.sync()
    run.barrier()
    setup_s = run.clock() - t_start
    phases["warmup"] = setup_s - sum(phases.values())

    slice_n = int(tr['trace_requests']) if trace else 0
    prof = span = None
    requests = 0
    t_w0 = run.clock()
    while True:
        if trace and requests == 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if run.on_card:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            program.reset_counters()
            span = torch.profiler.record_function(SLICE_SPAN)
            span.__enter__()
        ts = run.clock()
        client.request()
        run.sync()
        te = run.clock()
        run.latencies.append(te - ts)
        requests += 1
        if span is not None and requests == 1 + slice_n:
            span.__exit__(None, None, None)
            span = None
            prof.stop()
            run.slice_counters = program.read_counters()
            run.slice_requests = slice_n
        stop = te - t_w0 >= seconds and requests > slice_n
        if run.agree(stop):
            break
    run.barrier()
    window_s = run.clock() - t_w0
    peak = torch.cuda.max_memory_allocated(run.device) if run.on_card else 0
    peaks = _gather_objects(run, peak)

    if trace:
        run.events = _export_events(prof)
        run.busy = yardstick.device_busy(run.events, SLICE_SPAN)
        figs = _gather_objects(run, (run.busy["busy_us"],
                                     run.busy["window_us"]))
        run.busy_s = sum(f[0] for f in figs) / len(figs) / 1e6
        run.window_s = sum(f[1] for f in figs) / len(figs) / 1e6
    client.release()
    del program
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    if rank != 0:
        return None
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {
            "value": setup_s if m["name"] == "setup_s" else
            end_to_end_value(m["name"], run, window_s, requests),
            "unit": m["unit"]} for m in cell.end_to_end}
    log("setup: %s s" % json.dumps({k: round(v, 4)
                                     for k, v in phases.items()}))
    log("window: %d requests in %.6f s (%d warm-up before it); latency "
        "p50 %.6f s, p95 %.6f s over %d samples; key_prep_s %.6f"
        % (requests, window_s, warmup,
           yardstick.percentile(run.latencies, 50),
           yardstick.percentile(run.latencies, 95), len(run.latencies),
           run.key_prep_s))
    gather_s = getattr(client, "gather_s", None)
    if gather_s:
        log("gather: %d spans, mean %.6f s" % (len(gather_s),
                                               sum(gather_s) / len(gather_s)))

    t0 = run.clock()
    checks, failed, info = client.check(warmup)
    log("check: %s in %.3f s" % (json.dumps(info), run.clock() - t0))
    dev = {"platform": "gpu" if run.on_card else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if run.on_card
           else "cpu",
           "count": world, "memory_peak_bytes": int(max(peaks))}
    if trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
    result = {"correct": checks.correct, "attempted": requests,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = yardstick.breakdown(run.busy)
    result["checks"] = checks.items
    return result
