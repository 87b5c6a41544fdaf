"""K2's device time a gate call in the traced slice, in ms: the keyswitch
kernel's time over its launches (one a gate call)."""


def read(run):
    k2 = run.busy["functions"].get("keyswitch_kernel")
    calls = run.slice_counters.get("k2", 0)
    if not k2 or not calls:
        return None
    return k2["us"] / 1e3 / calls
