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
local tier with cold registration, repair and prefetch (storage/). Not
ported yet: rebalance, REST, periodic tasks (the sentinel and the
prefetcher are called directly) and realtime consumption.
"""

from .broker import Broker
from .controller import ClusterController
from .querylog import QueryLogger
from .sentinel import PerfRegressionSentinel
from .server import ServerInstance
from .store import PropertyStore
from .tracestore import TraceStore

__all__ = ["PropertyStore", "ClusterController", "ServerInstance", "Broker",
           "TraceStore", "QueryLogger", "PerfRegressionSentinel"]
