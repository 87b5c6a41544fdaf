"""The share of the traced slice of a circuit loop in which the card ran no
kernel, memcpy or memset, in %, averaged over the cards."""


def read(run):
    if not run.window_s or not run.busy_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
