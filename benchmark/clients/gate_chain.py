"""``gate_chain`` on one card, through ``VirtualMachine``: each request is
``gates_per_request`` dependent calls of one bootstrapped gate (``gate``)
on a batch of ``batch`` bits, each output feeding the next call
(``mux``: x ? y : state)."""

import torch

from ..lib import data
from ..lib.client import Checks, Client as BaseClient, random_bits
from ..reference import tfhe

PLAIN = {'nand': lambda p, q: ~(p & q), 'and': lambda p, q: p & q,
         'or': lambda p, q: p | q, 'nor': lambda p, q: ~(p | q),
         'xor': lambda p, q: p ^ q, 'xnor': lambda p, q: ~(p ^ q),
         'andny': lambda p, q: ~p & q, 'andyn': lambda p, q: p & ~q,
         'orny': lambda p, q: ~p | q, 'oryn': lambda p, q: p | ~q}


def plain_gate(name, x, y, state):
    """A chain's gate on plaintext bits: gate(x, state), or for ``mux``
    x ? y : state."""
    if name == 'mux':
        return torch.where(x, y, state)
    return PLAIN[name](x, state)


def ref_gate(keys, name, x, y, state):
    if name == 'mux':
        return tfhe.gate_mux(keys, x, y, state)
    return tfhe.gate2(keys, name, x, state)


class Client(BaseClient):

    bits_per_request = property(lambda self: self.traffic['batch']
                                * self.traffic['gates_per_request'])

    def setup(self, program):
        tr = self.traffic
        batch, self.gate = tr['batch'], tr['gate']
        g = self.inputs
        self.plain = [random_bits(g, (batch,)) for _ in range(3)]
        self.enc = [data.encrypt(self.secret, p, g) for p in self.plain]
        rows = torch.randperm(batch, generator=g, device=g.device)
        self.rows = rows[:tr['check']['rows']].sort().values
        self.vm = program.virtual_machine()
        self.cx, self.cy, state = (program.ciphertext(*e) for e in self.enc)
        self.state = state if self.gate == 'mux' else self.cy
        start = self.enc[2] if self.gate == 'mux' else self.enc[1]
        self.kept.append(tuple(v[self.rows] for v in start))
        self.call = getattr(self.vm, 'gate_' + self.gate)

    def request(self):
        self.prev = self.state
        for _ in range(self.traffic['gates_per_request']):
            if self.gate == 'mux':
                self.state = self.call(self.cx, self.cy, self.state)
            else:
                self.state = self.call(self.cx, self.state)
        self.kept.append((self.state.a[self.rows], self.state.b[self.rows]))

    def last_request(self):
        """The whole input and output of the last request."""
        return ((self.prev.a, self.prev.b), (self.state.a, self.state.b))

    def release(self):
        self.last = self.last_request()
        self.vm = self.cx = self.cy = self.state = self.prev = None
        self.call = None

    def _answer(self, bits, rows):
        """What a request should give for an input of plaintext ``bits``,
        of the kept rows or of every row."""
        x, y = self.plain[0], self.plain[1]
        if rows:
            x, y = x[self.rows], y[self.rows]
        for _ in range(self.traffic['gates_per_request']):
            bits = plain_gate(self.gate, x, y, bits)
        return bits

    def check(self, warmup):
        """Each request's answer decrypted against the gate applied to its
        decrypted input: every request on the kept rows, the last one on
        every row; a sample of requests drawn from the seed recomputed by
        the reference from the program's state before each, word for
        word."""
        checks = Checks()
        dec = [data.decrypt(self.secret, a, b) for a, b in self.kept]
        start = self.plain[2] if self.gate == 'mux' else self.plain[1]
        bad = [(dec[0] != start[self.rows]).sum()] + [
            (dec[i + 1] != self._answer(dec[i], True)).sum()
            for i in range(len(dec) - 1)]
        (pa, pb), (fa, fb) = self.last
        last = data.decrypt(self.secret, fa, fb) != self._answer(
            data.decrypt(self.secret, pa, pb), False)
        wrong = int(sum(bad)) + int(last.sum())
        failed = sum(int(b > 0) for b in bad[warmup + 1:]) + int(
            bool(last.any()) and bad[-1] == 0)
        window = list(range(warmup, len(self.kept) - 1))
        picked = [0] + self.sample(window,
                                   self.traffic['check']['requests'] - 1)
        keys = self.reference_keys()

        # the picked requests side by side, each from the program's state
        def tile(v):
            v = v[self.rows].long()
            return v.repeat((len(picked),) + (1,) * (v.dim() - 1))
        xr = tuple(tile(v) for v in self.enc[0])
        yr = tuple(tile(v) for v in self.enc[1])
        state = tuple(torch.cat([self.kept[i][j].long() for i in picked])
                      for j in (0, 1))
        for _ in range(self.traffic['gates_per_request']):
            state = ref_gate(keys, self.gate, xr, yr, state)
        got = tuple(torch.cat([self.kept[i + 1][j].long() for i in picked])
                    for j in (0, 1))
        mismatch = int((state[0] != got[0]).sum()
                       + (state[1] != got[1]).sum())
        checks.add("mismatch_words", mismatch, 0)
        checks.add("wrong_bits", wrong, 0)
        return checks, failed, {"requests_recomputed": len(picked),
                                "rows": int(self.rows.numel())}
