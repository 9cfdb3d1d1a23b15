"""HOT001 corpus for torch's ways to sync: each sink fires on a ticket's
device fields inside the dispatch->sync window (the finding names the
drive -> <callee> chain), torch.cuda.synchronize() fires anywhere in the
window, tainted or not, and the non-sinks stay silent."""

import numpy as np
import torch
from torch import cuda as tc


class Engine:
    def dispatch_txns(self, txns, now, new_oldest_version):
        return txns

    def sync_ticket(self, ticket):
        # Sanctioned sync point: blocking reads are its whole job.
        ticket.ready.synchronize()
        torch.cuda.synchronize()
        return ticket.host.numpy()


def _peek_cpu(ticket):
    return ticket.out.cpu()  # EXPECT: HOT001


def _peek_numpy(ticket):
    return ticket.host.numpy()  # EXPECT: HOT001


def _peek_to(ticket):
    a = ticket.out.to("cpu")  # EXPECT: HOT001
    b = ticket.out.to(device="cpu")  # EXPECT: HOT001
    c = ticket.out.to(torch.device("cpu"))  # EXPECT: HOT001
    return a, b, c


def _wait(ticket):
    ticket.ready.synchronize()  # EXPECT: HOT001


def _peek_asarray(ticket):
    return np.asarray(ticket.host)  # EXPECT: HOT001


def _drain():
    torch.cuda.synchronize()  # EXPECT: HOT001


def _drain_aliased():
    tc.synchronize()  # EXPECT: HOT001


def _not_syncs(ticket, dev):
    done = ticket.ready.query()  # Event.query() does not block: clean
    a = ticket.out.to(dev)  # a copy to another device: clean
    b = ticket.out.to("cpu", non_blocking=True)  # a non-blocking copy: clean
    c = ticket.out.to(device="cuda")  # clean
    return done, a, b, c


def _host_fields(ticket):
    # The ticket's host values carry no taint.
    return int(ticket.now) + len(ticket.pb.txns) + int(ticket.new_oldest_version)


def drive(engine, txns):
    ticket = engine.dispatch_txns(txns, 0, 0)
    _peek_cpu(ticket)
    _peek_numpy(ticket)
    _peek_to(ticket)
    _wait(ticket)
    _peek_asarray(ticket)
    _drain()
    _drain_aliased()
    _not_syncs(ticket, "cuda:0")
    _host_fields(ticket)
    return engine.sync_ticket(ticket)


def outside():
    # No dispatch reaches this function: a device-wide sync here is
    # outside every window.
    torch.cuda.synchronize()
