"""K3's share of its roofline in the traced slice of a gate chain, in %:
the least time of the slice's blind rotations (``yardstick.cmux_bound_s``:
batch samples a gate call, n steps, the int8 MAC count by engine mode)
over K3's device time.  Nothing to read without K3 in the trace, or where
K1 shares its CUDA function there."""

from benchmark.lib import yardstick


def read(run):
    k3 = run.busy["functions"].get("blind_rotate_kernel")
    calls = run.slice_counters.get("k2", 0)
    if not k3 or not calls or run.slice_counters.get("k1"):
        return None
    tr = run.traffic
    samples = tr["batch"] * (2 if tr["gate"] == "mux" else 1) // run.world
    bound = calls * yardstick.cmux_bound_s(run.cfg, samples,
                                           run.cfg["lwe_size"])
    return 100.0 * bound / (k3["us"] / 1e6)
