"""The port's server roles: the Resolver (``resolver``), its request and
reply types (``interfaces``) and its shard balancer
(``resolver_balancer``)."""

from .resolver import Resolver

__all__ = ["Resolver"]
