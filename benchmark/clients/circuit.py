"""``circuit``: encrypted-integer operations through ``VirtualMachine``.
Each request is one call of ``op`` (with ``op_kwargs``) on ``integers``
integers of ``bits`` bits: the state plus one of ``operands`` fixed
operands in turn.  The reference is the circuit named ``reference``,
``benchmark/reference/ops/<reference>.py``, which defines ``circuit(keys,
x, y)`` and the operation on plaintext, ``plain(x, y, bits)``."""

import torch

from ..lib import data, manifest
from ..lib.client import Checks, Client as BaseClient


class Client(BaseClient):

    bits_per_request = property(lambda self: self.traffic['integers']
                                * self.traffic['bits'])

    def _encrypt_ints(self, values):
        w = self.traffic['bits']
        shifts = torch.arange(w - 1, -1, -1, device=values.device)
        bits = ((values[..., None] >> shifts) & 1).to(torch.bool)
        return data.encrypt(self.secret, bits, self.inputs)

    def setup(self, program):
        tr = self.traffic
        self.ref = manifest.load_module("reference/ops", tr['reference'])
        g, w = self.inputs, tr['bits']
        shape = (tr['integers'],)
        self.start = torch.randint(0, 2**w, shape, generator=g,
                                   device=g.device)
        self.operands = torch.randint(0, 2**w, (tr['operands'],) + shape,
                                      generator=g, device=g.device)
        self.enc_start = self._encrypt_ints(self.start)
        self.enc_ops = [self._encrypt_ints(v) for v in self.operands]
        self.vm = program.virtual_machine()
        self.ops = [program.ciphertext(*e) for e in self.enc_ops]
        self.state = program.ciphertext(*self.enc_start)
        self.call = getattr(self.vm, tr['op'])
        self.kwargs = dict(tr.get('op_kwargs', {}))
        self.kept.append(self.enc_start)

    def request(self):
        k = len(self.kept) - 1
        self.state = self.call(self.state, self.ops[k % len(self.ops)],
                               **self.kwargs)
        self.kept.append((self.state.a, self.state.b))

    def release(self):
        self.vm = self.ops = self.state = self.call = None

    def _value(self, a, b):
        w = self.traffic['bits']
        bits = data.decrypt(self.secret, a, b).long()
        return (bits << torch.arange(w - 1, -1, -1, device=bits.device)) \
            .sum(-1)

    def check(self, warmup):
        """Each request's answer decrypted against the operation applied
        to its decrypted input, every request whole; a sample of requests
        drawn from the seed recomputed by the reference circuit from the
        program's state before each, word for word."""
        checks = Checks()
        tr = self.traffic
        n_ops = len(self.enc_ops)
        values = [self._value(a, b) for a, b in self.kept]
        bad = [(values[0] != self.start).sum()] + [
            (values[i + 1] != self.ref.plain(
                values[i], self.operands[i % n_ops], tr['bits'])).sum()
            for i in range(len(values) - 1)]
        wrong = int(sum(bad))
        failed = sum(int(b > 0) for b in bad[warmup + 1:])
        window = list(range(warmup, len(self.kept) - 1))
        picked = [0] + self.sample(window, tr['check']['requests'] - 1)
        keys = self.reference_keys()

        def cat(parts):
            return torch.cat([p.long() for p in parts])
        x = (cat([self.kept[i][0] for i in picked]),
             cat([self.kept[i][1] for i in picked]))
        y = (cat([self.enc_ops[i % n_ops][0] for i in picked]),
             cat([self.enc_ops[i % n_ops][1] for i in picked]))
        ra, rb = self.ref.circuit(keys, x, y)
        ga = cat([self.kept[i + 1][0] for i in picked])
        gb = cat([self.kept[i + 1][1] for i in picked])
        mismatch = int((ra != ga).sum() + (rb != gb).sum())
        checks.add("mismatch_words", mismatch, 0)
        checks.add("wrong_integers", wrong, 0)
        return checks, failed, {"requests_recomputed": len(picked)}
