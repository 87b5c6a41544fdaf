"""``gate_chain`` data-parallel over the ranks of the process group: each
rank holds its slice of the batch and runs the gate's linear part and the
sharded bootstrap on it, and each request ends with the gather of the
whole batch, timed on its own (``gather_s``) once every card has reached
it."""

import torch

from ..lib import data
from ..lib.client import random_bits
from ..lib.program import Mesh
from ..reference import tfhe
from .gate_chain import Client as GateChain


class Client(GateChain):

    def attach(self, program):
        if self.traffic['gate'] not in tfhe.GATES2:
            raise ValueError("a data-parallel chain runs two-input gates")
        self.mesh = Mesh(program, self.run.world)

    def prepare_keys(self, program):
        self.mesh.prepare_keys()

    def setup(self, program):
        tr = self.traffic
        self.gate = tr['gate']
        num, den, cx, cy = tfhe.GATES2[self.gate]
        self.const, self.coeffs = tfhe.t32(num, den), (cx, cy)
        batch = tr['batch']
        world, rank = self.run.world, self.run.rank
        if batch % world:
            raise ValueError("a batch of %d does not split over %d cards"
                             % (batch, world))
        g = self.inputs
        self.plain = [random_bits(g, (batch,)) for _ in range(2)]
        self.enc = [data.encrypt(self.secret, p, g) for p in self.plain]
        rows = torch.randperm(batch, generator=g, device=g.device)
        self.rows = rows[:tr['check']['rows']].sort().values
        per = batch // world
        mine = slice(rank * per, (rank + 1) * per)
        self.x = tuple(v[mine].to(torch.int32).contiguous()
                       for v in self.enc[0])
        self.state = tuple(v[mine].to(torch.int32).contiguous()
                           for v in self.enc[1])
        self.kept.append(tuple(v[self.rows] for v in self.enc[1]))
        self.gather_s = []
        self.full = None

    def request(self):
        for _ in range(self.traffic['gates_per_request']):
            self.state = self.mesh.gate(self.const, self.coeffs, self.x,
                                        self.state)
        # every card done with its chain, so the span holds the exchange
        # and not the wait for the slowest card
        self.run.sync()
        self.run.barrier()
        t0 = self.run.clock()
        self.prev_full = self.full
        full = self.mesh.gather(*self.state)
        self.run.sync()
        self.gather_s.append(self.run.clock() - t0)
        self.full = full
        self.kept.append((full[0][self.rows], full[1][self.rows]))

    def last_request(self):
        prev = self.prev_full
        if prev is None:            # a single request: its input is known
            prev = tuple(v.to(torch.int32) for v in self.enc[1])
        return prev, self.full

    def release(self):
        self.last = self.last_request()
        self.mesh = self.x = self.state = self.full = self.prev_full = None
