"""Bootstrapped gate calls a request in the traced slice of a circuit
loop: the keyswitch kernel's launch counter (one a gate call, a MUX
included) over the slice's requests."""


def read(run):
    calls = run.slice_counters.get("k2", 0)
    if not calls or not run.slice_requests:
        return None
    return calls / run.slice_requests
