"""RandomMoveKeys: random shard splits + moves racing live transactions.

The port's own copy of the reference package's ``workloads/random_move_keys.py``.

Ref: fdbserver/workloads/RandomMoveKeys.actor.cpp — while load workloads
run, repeatedly pick a random key range and a random destination team and
drive the MoveKeys protocol; the invariant is that reads/writes never
break (clients chase wrong_shard_server through the location cache) and
the keyServers map stays well-formed.  check() verifies the final shard
map: contiguous coverage of the keyspace, no dangling in-flight
destinations, every owner a live storage.
"""

from __future__ import annotations

from .base import TestWorkload


class RandomMoveKeysWorkload(TestWorkload):
    name = "random_move_keys"

    def __init__(self, moves: int = 4, split_chance: float = 0.5,
                 prefix: bytes = b"cycle/", nodes: int = 8):
        self.moves = moves
        self.split_chance = split_chance
        self.prefix = prefix
        self.nodes = nodes  # split candidates drawn from the load's keyspace
        self.dd = None
        self.performed = 0

    async def setup(self, db, cluster):
        self.dd = cluster.data_distributor()
        await self.dd.register_storages(self.dd.storages)
        await self.dd.seed(["ss0"])
        # The system keyspace must stay on the seed team: split it off so
        # random moves only relocate user shards (the reference's moves are
        # clamped to normalKeys, RandomMoveKeys.actor.cpp).
        await self.dd.split(b"\xff")

    async def start(self, db, cluster):
        rng = cluster.loop.rng
        sids = sorted(self.dd.storages)
        for _ in range(self.moves):
            await cluster.loop.delay(0.2 + rng.random01() * 0.5)
            if rng.random01() < self.split_chance:
                at = self.prefix + b"%04d" % int(rng.random_int(0, self.nodes))
                await self.dd.split(at)
            shards = [
                (b, e)
                for b, e, _t, _d in await self.dd.read_shard_map()
                if b < b"\xff"
            ]
            if not shards:
                continue
            b, _e = shards[int(rng.random_int(0, len(shards)))]
            team_size = 1 + int(rng.random_int(0, min(2, len(sids))))
            dest = sorted(
                {
                    sids[int(rng.random_int(0, len(sids)))]
                    for _ in range(team_size)
                }
            )
            await self.dd.move(b, dest)
            self.performed += 1

    async def check(self, db, cluster) -> bool:
        shard_map = await self.dd.read_shard_map()
        if not shard_map:
            return False
        # Contiguous cover, settled moves, live owners.
        expect_begin = b""
        for b, e, team, dest in shard_map:
            if b != expect_begin:
                return False
            expect_begin = e
            if dest:  # an in-flight move left dangling
                return False
            if not team or not all(t in self.dd.storages for t in team):
                return False
        return self.performed > 0
