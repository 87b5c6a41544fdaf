"""The benchmark's fixed arithmetic: peaks, roofline bounds, window rates,
percentiles and the reading of a ``torch.profiler`` trace.

Kept here, beside the harness, so that a change to the program cannot
change how its work is counted.  The roofline bounds are computed from a
cell's parameters alone: batch, steps, N, k, l and the engine mode.
"""

import math

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at 700 W.
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BYTES_PER_S = 3.35e12

# the profiler's device-side categories that make the card busy
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime", "cuda_driver")


def window_ms_per_bit(window_s, bits):
    """The window's milliseconds over the bits it completed."""
    return window_s * 1e3 / bits


def percentile(values, q):
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q% of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def cmux_mac_ops(cfg, samples, steps):
    """Operations of ``steps`` CMUX steps on ``samples`` accumulators,
    counted as the int8 MAC that carries them: per sample and step,
    L slots x ((k+1) l 2R) digit limbs x (groups (k+1) R) key columns, two
    operations each; groups 5 for the exact engine ('NTT'), 4 for the
    rounded key ('FFT').  R = 32 and L = 2 N / R, the Nussbaumer transform's
    length at degree N (``tlwe_polynomial_degree``): 64 at N = 1024, 32 at
    N = 512."""
    k1 = cfg['tlwe_mask_size'] + 1
    r = 32
    slots = 2 * cfg['tlwe_polynomial_degree'] // r
    contraction = k1 * cfg['bs_decomp_length'] * 2 * r
    groups = 4 if cfg['transform_type'] == 'FFT' else 5
    return 2.0 * slots * contraction * groups * k1 * r * samples * steps


def cmux_min_bytes(cfg, samples, steps):
    """Bytes a blind rotation of ``steps`` steps must move at least: the
    accumulators in and out once, one int32 rotation amount a sample and
    step, and the coefficient-domain key rows of those steps once."""
    k1 = cfg['tlwe_mask_size'] + 1
    n_poly = cfg['tlwe_polynomial_degree']
    acc = 2 * samples * k1 * n_poly * 4
    key = steps * k1 * cfg['bs_decomp_length'] * k1 * n_poly * 4
    return acc + samples * steps * 4 + key


def cmux_bound_s(cfg, samples, steps):
    """The least time of that rotation on the card: the larger of its
    operations at the int8 peak and its bytes at the memory peak."""
    return max(cmux_mac_ops(cfg, samples, steps) / PEAK_INT8_OPS_PER_S,
               cmux_min_bytes(cfg, samples, steps) / PEAK_BYTES_PER_S)


def kernel_function(name):
    """The CUDA function of a profiler kernel name, without its return
    type, anonymous namespace, template and parameter lists:
    ``void (anonymous namespace)::f<2, 2>(int*)`` -> ``f``."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<", 1)[0].split("(", 1)[0].strip()


def _merge(intervals):
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def device_busy(events, span):
    """The card's work inside the host span named ``span`` of a Chrome
    trace's ``traceEvents``: the union of the kernel, memcpy and memset
    intervals, clipped to the span.  Returns ``{"window_us", "busy_us",
    "functions": {CUDA function: {"launches", "us"}}, "gaps": [(us,
    what the host was doing)]}``, the gaps longest first."""
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == span]
    if len(spans) != 1:
        raise ValueError("the trace holds %d spans named %r, not one"
                         % (len(spans), span))
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    intervals, functions = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        t0 = max(float(e["ts"]), w0)
        t1 = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if t1 <= t0:
            continue
        intervals.append((t0, t1))
        if e["cat"] == "kernel":
            f = functions.setdefault(kernel_function(e["name"]),
                                     {"launches": 0, "us": 0.0})
            f["launches"] += 1
            f["us"] += t1 - t0
    merged = _merge(intervals)
    busy = sum(t1 - t0 for t0, t1 in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES
            and e.get("name") != span]
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (g0 + g1) / 2
        inside = [e for e in host if float(e["ts"]) <= mid
                  <= float(e["ts"]) + float(e.get("dur", 0))]
        # the innermost host event is the shortest that covers the gap
        what = min(inside, key=lambda e: float(e.get("dur", 0)))["name"] \
            if inside else "no host event"
        labelled.append((g1 - g0, what))
    return {"window_us": w1 - w0, "busy_us": busy, "functions": functions,
            "gaps": labelled}


def breakdown(busy):
    """The ``--trace 1`` line's ``breakdown``: the ten device functions
    that took most time and the ten longest idle gaps, in seconds."""
    ops = sorted(busy["functions"].items(), key=lambda kv: -kv[1]["us"])
    return {"device_ops": [[name, fig["us"] / 1e6] for name, fig in ops[:10]],
            "idle_gaps": [[what, us / 1e6] for us, what in busy["gaps"]]}
