"""The device time of every kernel that is not one of the port's own
(PyTorch's: the gates' linear part, the modulus switch, the test vector,
extraction, the keyswitch's digits and sums) a gate call in the traced
slice, in ms.  The harness's own gather of the checked rows, two small
index kernels a request, is among them."""

from benchmark.lib import program


def read(run):
    calls = run.slice_counters.get("k2", 0)
    if not calls:
        return None
    us = sum(fig["us"] for name, fig in run.busy["functions"].items()
             if name not in program.PORT_FUNCTIONS)
    return us / 1e3 / calls
