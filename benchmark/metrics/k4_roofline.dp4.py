"""K4's share of its roofline on rank 0 in the traced slice of a
data-parallel gate chain, in %: the least time of rank 0's blind rotations
(``yardstick.cmux_bound_s`` on its shard of the batch, n steps a gate
call) over the device time of K4's three grids."""

from benchmark.lib import yardstick

K4 = ("lanes_forward_kernel", "lanes_mac_kernel", "lanes_inverse_kernel")


def read(run):
    us = sum(run.busy["functions"].get(f, {}).get("us", 0.0) for f in K4)
    calls = run.slice_counters.get("k2", 0)
    if not us or not calls:
        return None
    samples = run.traffic["batch"] // run.world
    bound = calls * yardstick.cmux_bound_s(run.cfg, samples,
                                           run.cfg["lwe_size"])
    return 100.0 * bound / (us / 1e6)
