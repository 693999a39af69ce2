"""Monitor — the cluster's map authority and command endpoint
(src/mon/: Monitor.cc, Paxos.cc, OSDMonitor.cc, MonClient.cc).

The reference replicates every map mutation through single-decree
Paxos over a mon quorum and stores the transaction log in
MonitorDBStore.  This framework models the same *service contract*
on a single authority node (documented deviation: no multi-mon
quorum/elections yet — the commit log and subscription protocol are
shaped so a quorum layer can wrap ``commit`` later):

- every OSDMap mutation is an ``Incremental`` committed to a
  versioned log (the PaxosService::propose_pending shape);
- clients subscribe and receive exactly the incremental run they
  are missing, or a full map when too far behind (MonClient /
  MOSDMap semantics);
- failure reports gate on distinct reporters before committing a
  mark-down incremental (OSDMonitor::prepare_failure);
- a JSON command surface (`osd pool create`, `osd out`, ...) plays
  the MonCommands.h role for the CLI.
"""

from .monitor import MonClient, Monitor, MonitorStore

__all__ = ["MonClient", "Monitor", "MonitorStore"]
