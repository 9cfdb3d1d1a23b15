"""HOT001 corpus for the sanctioned scopes: a block under
``with self._sanctioned_sync(...)`` or ``with on_sync()`` sanctions its
body, a call from inside one does not extend the window, and the same
reads outside the block fire."""

import contextlib

import numpy as np
import torch


class Engine:
    def dispatch_packed(self, pb, now, new_oldest_version):
        return pb

    def _sanctioned_sync(self, op):
        return contextlib.nullcontext()

    def _flush(self):
        # Called only from a sanctioned scope: outside the window.
        torch.cuda.synchronize()

    def _flush_unsanctioned(self):
        torch.cuda.synchronize()  # EXPECT: HOT001

    def submit(self, pb):
        ticket = self.dispatch_packed(pb, 0, 0)
        with self._sanctioned_sync("ticket readback"):
            ticket.ready.synchronize()
            arr = np.asarray(ticket.host)
            self._flush()
        self._flush_unsanctioned()
        n = int(ticket.out)  # EXPECT: HOT001
        return arr, n


def check(ticket, on_sync):
    with on_sync():
        n = ticket.out.item()
    m = ticket.out.item()  # EXPECT: HOT001
    return n, m


def check_optional(ticket, on_sync=None):
    with on_sync() if on_sync is not None else contextlib.nullcontext():
        n = int(ticket.out)
    return n
