"""Storefront: order/inventory invariant under concurrent purchases.

The port's own copy of the reference package's ``workloads/storefront.py``.

Ref: fdbserver/workloads/Storefront.actor.cpp — customers buy items in
transactions that decrement per-item stock and append an order record;
the check re-derives stock from the order log and asserts no item was
oversold (stock never below zero) and accounting balances exactly.
"""

from __future__ import annotations

from .base import TestWorkload

INITIAL_STOCK = 20


class StorefrontWorkload(TestWorkload):
    name = "storefront"

    def __init__(self, items: int = 4, actors: int = 3, purchases: int = 8,
                 prefix: bytes = b"store/"):
        self.items = items
        self.actors = actors
        self.purchases = purchases
        self.prefix = prefix

    def _stock_key(self, i: int) -> bytes:
        return self.prefix + b"stock/%02d" % i

    def _order_key(self, aid: int, seq: int) -> bytes:
        return self.prefix + b"order/%02d_%04d" % (aid, seq)

    async def setup(self, db, cluster):
        async def txn(tr):
            for i in range(self.items):
                tr.set(self._stock_key(i), b"%d" % INITIAL_STOCK)

        await db.run(txn)

    async def start(self, db, cluster):
        from ..flow.eventloop import all_of

        rng = cluster.loop.rng

        async def customer(aid: int):
            for seq in range(self.purchases):
                item = int(rng.random_int(0, self.items))
                qty = 1 + int(rng.random_int(0, 3))

                async def buy(tr, item=item, qty=qty, aid=aid, seq=seq):
                    ok = self._order_key(aid, seq)
                    if await tr.get(ok) is not None:
                        return  # unknown-result retry: order already landed
                    stock = int(await tr.get(self._stock_key(item)) or b"0")
                    if stock < qty:
                        tr.set(ok, b"rejected/%02d/0" % item)
                        return
                    tr.set(self._stock_key(item), b"%d" % (stock - qty))
                    tr.set(ok, b"filled/%02d/%d" % (item, qty))

                await db.run(buy)

        await all_of(
            [
                db.process.spawn(customer(a), f"store{a}")
                for a in range(self.actors)
            ]
        )

    async def check(self, db, cluster) -> bool:
        out = {}

        async def read(tr):
            out["stock"] = await tr.get_range(
                self.prefix + b"stock/", self.prefix + b"stock0"
            )
            out["orders"] = await tr.get_range(
                self.prefix + b"order/", self.prefix + b"order0"
            )

        await db.run(read)
        if len(out["orders"]) != self.actors * self.purchases:
            return False
        sold = {i: 0 for i in range(self.items)}
        for _k, v in out["orders"]:
            state, item, qty = v.split(b"/")
            if state == b"filled":
                sold[int(item)] += int(qty)
        for k, v in out["stock"]:
            item = int(k.rsplit(b"/", 1)[-1])
            stock = int(v)
            # Serializability forbids overselling AND the ledger must
            # balance exactly.
            if stock < 0 or stock + sold[item] != INITIAL_STOCK:
                return False
        return True
