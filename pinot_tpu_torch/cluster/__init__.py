"""Cluster layer: controller / broker / server roles over a shared
property store, the Helix-over-ZooKeeper analogue.

The port of pinot_tpu/cluster/'s single-stage serving path. Reference
analogue: Apache Helix + ZooKeeper control plane, PinotHelixResourceManager
(pinot-controller/.../helix/core/PinotHelixResourceManager.java), broker
routing (pinot-broker/.../routing/BrokerRoutingManager.java), and the
server state model (pinot-server/.../helix/
SegmentOnlineOfflineStateModelFactory.java:44).

The control plane is host-side and lightweight (an in-process store with
watches); the data plane is a socket scatter/gather whose per-server
execution path is the port's device engine on the card. Ideal state (what
should be) vs external view (what is), with servers converging one to the
other. The multi-stage engine runs across the servers (stage workers on
each server's card, mse/distributed.py), and a role in another OS process
joins through remote_store.py. The broker keeps the flight recorder (its
TraceStore and QueryLogger) and feeds the perf ledger, which the
regression sentinel (PerfRegressionSentinel) judges. The broker admits
queries through a per-table quota and an admission gate, accounts their
cost, spools cursors, streams selections and hedges stragglers on request
(quota.py, workload.py); the servers keep segments in a byte-budgeted
local tier with cold registration, repair and prefetch (storage/).
Operations: the controller's periodic tasks (periodic.py: status,
integrity repair nudges, the rebalance checker, tier relocation, lineage
cleanup, the fleet health scrape, the prefetcher and the sentinel, on a
leader-gated scheduler), segment lineage for atomic replacement (the
broker routes around it), the durable rebalance engine and its actuator
(rebalance.py), the REST servers of the three roles with access control
(rest.py, auth.py) and the config recommender (recommender.py). Realtime
consumption runs beside the servers (realtime/), as in the JAX package.
"""

from .auth import AccessControl, AllowAllAccessControl, \
    BasicAuthAccessControl, Principal
from .broker import Broker
from .controller import ClusterController
from .periodic import (ClusterHealthChecker, ControllerPeriodicTaskScheduler,
                       RebalanceChecker, SegmentIntegrityChecker,
                       SegmentLineageManager, SegmentRelocator,
                       SegmentStatusChecker, build_default_scheduler)
from .querylog import QueryLogger
from .rebalance import RebalanceActuator, SegmentRebalancer
from .recommender import recommend
from .rest import BrokerRestServer, ControllerRestServer, ServerRestServer
from .sentinel import PerfRegressionSentinel
from .server import ServerInstance
from .store import PropertyStore
from .tracestore import TraceStore

__all__ = ["PropertyStore", "ClusterController", "ServerInstance", "Broker",
           "TraceStore", "QueryLogger", "PerfRegressionSentinel",
           "Principal", "AccessControl", "AllowAllAccessControl",
           "BasicAuthAccessControl", "ControllerPeriodicTaskScheduler",
           "SegmentStatusChecker", "RebalanceChecker",
           "SegmentLineageManager", "SegmentIntegrityChecker",
           "SegmentRelocator", "ClusterHealthChecker",
           "build_default_scheduler", "SegmentRebalancer",
           "RebalanceActuator", "recommend", "BrokerRestServer",
           "ControllerRestServer", "ServerRestServer"]
