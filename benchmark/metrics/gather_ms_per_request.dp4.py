"""The gather of the whole batch at the end of each request on rank 0, in
ms: the host clock around ``gather_ciphertext``, the card synchronised
before and after and every card past a barrier first, so it holds the
exchange and not the wait for the slowest card; averaged over the
window's requests (the warm-up's, which set up the collective, are left
out)."""


def read(run):
    spans = getattr(run.client, "gather_s", None) or []
    spans = spans[int(run.traffic["warmup_requests"]):]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
