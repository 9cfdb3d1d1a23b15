"""Seed-randomized simulation topology.

Ref: SimulatedCluster.actor.cpp:673 — SimulationConfig randomizes the
replication mode, machine/process counts, and datacenter layout per seed so
every simulation run exercises a different cluster shape.

The port's own copy of the reference package's ``workloads/config.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..flow.rng import DeterministicRandom


@dataclass
class SimulationConfig:
    n_workers: int = 5
    n_coordinators: int = 3
    n_controllers: int = 2
    n_tlogs: int = 1
    n_storages: int = 1
    n_proxies: int = 1

    @classmethod
    def random(cls, seed: int) -> "SimulationConfig":
        rng = DeterministicRandom(seed ^ 0x5EED)
        n_tlogs = int(rng.random_int(1, 3))
        n_storages = int(rng.random_int(1, 3))
        n_proxies = int(rng.random_int(1, 3))
        # Enough workers that stateful disks, proxies, and the resolver/
        # sequencer can spread out (plus headroom for attrition).
        n_workers = max(n_tlogs + n_storages + 2, int(rng.random_int(5, 9)))
        return cls(
            n_workers=n_workers,
            n_coordinators=int(rng.random_int(0, 2)) * 2 + 1,  # 1 or 3
            n_controllers=int(rng.random_int(1, 3)),
            n_tlogs=n_tlogs,
            n_storages=n_storages,
            n_proxies=n_proxies,
        )

    def build(self, seed: int):
        from ..server.dynamic_cluster import DynamicCluster

        return DynamicCluster(
            seed=seed,
            n_coordinators=self.n_coordinators,
            n_workers=self.n_workers,
            n_controllers=self.n_controllers,
            n_tlogs=self.n_tlogs,
            n_storages=self.n_storages,
            n_proxies=self.n_proxies,
        )
