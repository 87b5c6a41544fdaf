"""K3's device time a CMUX step in the traced slice of a circuit loop, in
us: its time over the steps of the slice's gate calls (n a call, one
keyswitch launch a call), at the circuit's small batches."""


def read(run):
    k3 = run.busy["functions"].get("blind_rotate_kernel")
    calls = run.slice_counters.get("k2", 0)
    if not k3 or not calls or run.slice_counters.get("k1"):
        return None
    return k3["us"] / (calls * run.cfg["lwe_size"])
