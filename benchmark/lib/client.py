"""What every client of the benchmark shares.

A client drives the program with one traffic mix.  Its kind (the mix's
``kind``) names its file, ``benchmark/clients/<kind>.py``, or on a
configuration of several cards ``benchmark/clients/<kind>.<parallel>.py``
(the configuration's ``parallel``); each file defines ``Client``.  A
client runs a closed loop of one sender that sends its next request when
the last one has completed, keeps what the check needs of each request
(sampled rows, or whole small outputs) and, once the window has closed and
the program's state is freed, holds a sample of requests drawn from the
seed against the reference (``check``).
"""

import torch

from ..reference import tfhe
from . import data


def random_bits(g, shape):
    return torch.randint(0, 2, shape, generator=g, device=g.device) \
        .to(torch.bool)


class Checks:
    """The numbers compared and their limits; ``correct`` holds when every
    number is at most its limit."""

    def __init__(self):
        self.items = {}

    def add(self, name, value, limit):
        self.items[name] = {"value": value, "limit": limit}

    @property
    def correct(self):
        return all(v["value"] <= v["limit"] for v in self.items.values())


class Client:
    """Keys and inputs from the seed, and the hooks a run calls:
    ``attach``, ``prepare_keys``, ``setup``, ``request`` (one request,
    not synchronised), ``release`` and ``check``."""

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.device = run.device
        self.kept = []

    def attach(self, program):
        """Bind what the program needs beyond its key (a mesh)."""

    def prepare_keys(self, program):
        """The port's preparation of the cloud key, timed as key_prep_s."""
        program.prepare_keys()

    def make_keys(self):
        g = data.generator(self.run.seed, self.device, 0)
        self.secret = data.Secret(self.cfg, g)
        self.raw = data.make_raw_cloud_key(self.cfg, self.secret, g)
        self.inputs = data.generator(self.run.seed, self.device, 1)

    def reference_keys(self):
        return tfhe.Keys(self.cfg, self.raw['bk_coeff'], self.raw['ks_a'],
                         self.raw['ks_b'])

    def sample(self, population, count):
        """``count`` of ``population`` (a list), drawn from the seed."""
        count = min(count, len(population))
        pick = self.run.rng.choice(len(population), size=count,
                                   replace=False)
        return [population[i] for i in sorted(pick)]
