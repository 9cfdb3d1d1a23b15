"""HOT001 corpus for torch's ways to sync: each sink fires on a ticket's
device fields inside the dispatch->sync window (the finding names the
drive -> <callee> chain) — a truth test of a tainted tensor and a copy_
from one among them — torch.cuda.synchronize() and a stream's or an
event's .synchronize() fire anywhere in the window, tainted or not, and
the non-sinks stay silent."""

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


def _truth_if(ticket):
    if ticket.out[0]:  # EXPECT: HOT001
        return 1
    return 0


def _truth_while(ticket):
    while (ticket.out > 0).any():  # EXPECT: HOT001
        break


def _truth_assert(ticket):
    assert torch.all(ticket.out >= 0)  # EXPECT: HOT001


def _truth_operators(ticket, flag):
    a = not ticket.out  # EXPECT: HOT001
    b = ticket.out[1] and flag  # EXPECT: HOT001
    c = 1 if ticket.out.sum() else 0  # EXPECT: HOT001
    d = [i for i in flag if ticket.out[i] == 0]  # EXPECT: HOT001
    return a, b, c, d


def _copy_back(ticket, dst):
    dst.copy_(ticket.out)  # EXPECT: HOT001


def _stream_syncs(stream, ev):
    torch.cuda.current_stream().synchronize()  # EXPECT: HOT001
    torch.cuda.default_stream().synchronize()  # EXPECT: HOT001
    stream.synchronize()  # EXPECT: HOT001
    ev.synchronize()  # EXPECT: HOT001


def _not_syncs(ticket, dev):
    done = ticket.ready.query()  # Event.query() does not block: clean
    a = ticket.out.to(dev)  # a copy to another device: clean
    b = ticket.out.to("cpu", non_blocking=True)  # a non-blocking copy: clean
    c = ticket.out.to(device="cuda")  # clean
    return done, a, b, c


def _not_truth_tests(ticket, flags, dst_dev, host_buf, stream, ev):
    if ticket.ready is not None:  # an identity test reads no value: clean
        pass
    if flags[0] and len(flags) > 1:  # untainted values: clean
        pass
    last = flags or ticket.out  # the last operand is not tested: clean
    dst_dev.copy_(host_buf)  # copy_ from an untainted source: clean
    host_buf.copy_(ticket.out, non_blocking=True)  # the pinned readback: clean
    ev.wait(stream)  # a stream waits on the device, the host does not: clean
    stream.wait_event(ev)  # clean
    return last


def _sanctioned_stream_sync(engine):
    with engine._sanctioned_sync("stream"):
        torch.cuda.current_stream().synchronize()  # a sanctioned scope: clean


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
    _truth_if(ticket)
    _truth_while(ticket)
    _truth_assert(ticket)
    _truth_operators(ticket, [0])
    _copy_back(ticket, torch.empty(3))
    _stream_syncs(torch.cuda.Stream(), torch.cuda.Event())
    _not_syncs(ticket, "cuda:0")
    _not_truth_tests(ticket, [0], None, None, None, None)
    _sanctioned_stream_sync(engine)
    _host_fields(ticket)
    return engine.sync_ticket(ticket)


def outside():
    # No dispatch reaches this function: a device-wide sync here is
    # outside every window.
    torch.cuda.synchronize()
    torch.cuda.current_stream().synchronize()
