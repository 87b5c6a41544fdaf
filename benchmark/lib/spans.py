"""The program's spans in a ``torch.profiler`` trace: where the card's idle
time falls among the host spans that ``nufhe_tpu_torch`` records
(``nufhe.vm.<op>``, ``nufhe.gate``, ``nufhe.bootstrap`` and the others of
its README), the synchronising runtime calls inside them, and the device
time of the work launched from inside them.

Every reading is confined to the slice span of ``yardstick.device_busy``,
and the idle time is computed as it computes it: the slice less the union
of the kernel, memcpy and memset intervals.  Idle time is put down to the
spans over it by measure, not by a midpoint: the slice is cut at every
span and idle edge, and each idle piece goes to the chain of spans that
covers it, outermost first.
"""

from . import yardstick

PREFIX = "nufhe."
GATE = "nufhe.gate"
VM = "nufhe.vm."
# runtime calls that block the host until the card has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def window(events, span):
    """(start, end) of the one host span named ``span``, in us."""
    found = [e for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == span]
    if len(found) != 1:
        raise ValueError("the trace holds %d spans named %r, not one"
                         % (len(found), span))
    t0 = float(found[0]["ts"])
    return t0, t0 + float(found[0]["dur"])


def _interval(e):
    t0 = float(e["ts"])
    return t0, t0 + float(e.get("dur", 0))


def program_spans(events, w):
    """The program's spans that overlap the window ``w``: (start, end,
    name), clipped to it, in the order of their starts (outer first)."""
    out = []
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e.get("name", "").startswith(PREFIX):
            t0, t1 = _interval(e)
            t0, t1 = max(t0, w[0]), min(t1, w[1])
            if t1 > t0:
                out.append((t0, t1, e["name"]))
    return sorted(out, key=lambda s: (s[0], -s[1]))


def idle_intervals(events, w):
    """The window less the union of the card's work, as disjoint
    intervals."""
    busy = []
    for e in events:
        if e.get("cat") in yardstick.DEVICE_CATEGORIES:
            t0, t1 = _interval(e)
            t0, t1 = max(t0, w[0]), min(t1, w[1])
            if t1 > t0:
                busy.append((t0, t1))
    edges = [w[0]] + [x for iv in yardstick._merge(busy) for x in iv] + [w[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_chain(events, span):
    """Idle us of the slice ``span`` by the chain of program spans over it:
    ``{(outermost, ..., innermost): us}``, ``()`` where no program span is
    open.  The values add up to the slice's idle time exactly."""
    w = window(events, span)
    idle = idle_intervals(events, w)
    spans = program_spans(events, w)
    edges = sorted({w[0], w[1]} | {x for s in spans for x in s[:2]}
                   | {x for iv in idle for x in iv})
    out, active, nxt, j = {}, [], 0, 0
    for a, b in zip(edges, edges[1:]):
        active = [s for s in active if s[1] > a]
        while nxt < len(spans) and spans[nxt][0] <= a:
            if spans[nxt][1] > a:
                active.append(spans[nxt])
            nxt += 1
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a:
            chain = tuple(s[2] for s in active)
            out[chain] = out.get(chain, 0.0) + (b - a)
    return out


def idle_parts(by_chain):
    """The slice's idle us in four parts that add up to it: inside a gate
    span (``gates``), inside an API span but no gate (``vm_outside_gates``:
    the integer circuit's own host code), inside other program spans only
    (``other_spans``), and under no program span (``no_span``)."""
    parts = dict(gates=0.0, vm_outside_gates=0.0, other_spans=0.0,
                 no_span=0.0)
    for chain, us in by_chain.items():
        if GATE in chain:
            parts["gates"] += us
        elif any(name.startswith(VM) for name in chain):
            parts["vm_outside_gates"] += us
        elif chain:
            parts["other_spans"] += us
        else:
            parts["no_span"] += us
    return parts


def by_innermost(by_chain):
    """``{innermost span name, or "no span": us}``."""
    out = {}
    for chain, us in by_chain.items():
        key = chain[-1] if chain else "no span"
        out[key] = out.get(key, 0.0) + us
    return out


def count(events, span, name):
    """The spans named ``name`` that start inside the slice ``span``."""
    w0, w1 = window(events, span)
    return sum(1 for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == name and w0 <= float(e["ts"]) < w1)


def _inside(events, span, name, pick):
    """Host events that ``pick`` accepts lying inside a span named
    ``name`` that starts inside the slice ``span``."""
    w0, w1 = window(events, span)
    outer = [_interval(e) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name
             and w0 <= float(e["ts"]) < w1]
    found = []
    for e in events:
        if e.get("cat") in yardstick.HOST_CATEGORIES and pick(e):
            t0, t1 = _interval(e)
            if any(s0 <= t0 and t1 <= s1 for s0, s1 in outer):
                found.append(e)
    return found


def syncs_inside(events, span, name):
    """The synchronising runtime calls inside the spans named ``name``."""
    return len(_inside(events, span, name,
                       lambda e: e.get("name") in SYNC_CALLS))


def device_us_launched_inside(events, span, name):
    """Device us of the kernels, memcpys and memsets launched by runtime
    calls inside the spans named ``name``, matched by the trace's
    ``correlation`` ids; their whole duration, in or out of the slice."""
    ids = {e["args"]["correlation"] for e in _inside(
        events, span, name, lambda e: "correlation" in e.get("args", {}))}
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("cat") in yardstick.DEVICE_CATEGORIES
               and e.get("args", {}).get("correlation") in ids)


def syncs_by_innermost(events, span):
    """``{innermost program span over it, or "no span": n}`` of the
    synchronising runtime calls inside the slice ``span``."""
    w = window(events, span)
    spans = program_spans(events, w)
    out = {}
    for e in events:
        if e.get("cat") in yardstick.HOST_CATEGORIES and \
                e.get("name") in SYNC_CALLS:
            t0, t1 = _interval(e)
            if not (w[0] <= t0 and t1 <= w[1]):
                continue
            over = [s for s in spans if s[0] <= t0 and t1 <= s[1]]
            key = over[-1][2] if over else "no span"
            out[key] = out.get(key, 0) + 1
    return out


def readings(events, span, requests):
    """What the program's spans give of one traced slice of ``requests``
    requests: the idle split, the synchronising calls, and per call,
    bootstrap and request the readings that per-layer metrics could take
    from them (None where the slice has no such span)."""
    by_chain = idle_by_chain(events, span)
    parts = idle_parts(by_chain)
    names = {s[2] for s in program_spans(events, window(events, span))}
    gates = count(events, span, "nufhe.gate.linear")
    boots = count(events, span, "nufhe.bootstrap")
    return {
        "idle_us": sum(by_chain.values()),
        "idle_parts_us": parts,
        "idle_by_innermost_us": by_innermost(by_chain),
        "syncs_by_innermost": syncs_by_innermost(events, span),
        "bootstrapped_gates": gates,
        "bootstraps": boots,
        "idle_in_gates_ms_per_call":
            parts["gates"] / 1e3 / gates if gates else None,
        "idle_in_circuit_ms_per_request":
            parts["vm_outside_gates"] / 1e3 / requests
            if any(n.startswith(VM) for n in names) else None,
        "syncs_per_bootstrap":
            syncs_inside(events, span, "nufhe.bootstrap") / boots
            if boots else None,
        "gather_device_ms_per_request":
            device_us_launched_inside(events, span, "nufhe.mesh.gather")
            / 1e3 / requests if "nufhe.mesh.gather" in names else None,
    }
