"""The port's RPC layer: the deterministic simulated network (``network``)
and typed request/reply endpoints over it (``stream``)."""

from .network import Endpoint, SimMachine, SimNetwork, SimProcess
from .stream import BrokenPromise, RequestStream, RequestStreamRef

__all__ = ["BrokenPromise", "Endpoint", "RequestStream", "RequestStreamRef", "SimMachine",
           "SimNetwork", "SimProcess"]
