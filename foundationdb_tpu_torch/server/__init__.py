"""The port's server roles: the commit path's ``Sequencer``, ``Proxy``,
``Resolver``, ``TLog`` and ``StorageServer``, wired together by
``cluster.SimCluster``; their request and reply types (``interfaces``),
the system keyspace (``system_keys``), tag placement (``log_system``),
the resolver's shard balancer (``resolver_balancer``), admission control
(``ratekeeper``) and data distribution (``data_distribution``,
``dd_role``); and the control plane: coordinators and leader election
(``coordination``), the ``ClusterController``, ``WorkerServer``, the
failure monitor, the ``LogRouter``, the status document (``status``) and
``dynamic_cluster.DynamicCluster``."""

from .cluster import SimCluster
from .cluster_controller import ClusterController
from .dynamic_cluster import DynamicCluster
from .proxy import Proxy
from .resolver import Resolver
from .sequencer import Sequencer
from .storage import StorageServer
from .tlog import TLog

__all__ = [
    "ClusterController",
    "DynamicCluster",
    "Proxy",
    "Resolver",
    "Sequencer",
    "SimCluster",
    "StorageServer",
    "TLog",
]
