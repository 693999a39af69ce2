"""Multi-process cluster runtime — the process model the reference
deploys (one OS process per daemon, `src/ceph_osd.cc` global_init;
respawn by ceph-run / systemd `Restart=on-failure`).

Everything in one process stays GIL-bound: its daemons share one
interpreter, so they serve about as much as one core does.  This
package escapes that ceiling:

- ``spec``       the cluster-spec grammar: which daemons, where their
                 stores live, which ports the mon trio binds — one
                 JSON document shared by the supervisor and every
                 child (the ceph.conf seat).
- ``daemon``     the per-daemon entrypoint
                 (``python -m ceph_tpu_torch.proc.daemon --role osd.3``):
                 boots exactly ONE mon/osd/mgr daemon (mgr and OSD
                 on the spec's ``device``) on the shared-event-loop
                 stack, publishes a readiness file,
                 and parks until SIGTERM.  All inter-daemon traffic
                 rides the messenger's real sockets.
- ``supervisor`` the ceph-run/systemd role: spawns the fleet as
                 setsid children with per-child log capture, monitors
                 them, respawns crashes with exponential backoff and
                 a crash-loop cap, and feeds every real process death
                 into the crash-report plane so RECENT_CRASH raises.
"""

from .spec import ClusterSpec
from .supervisor import Supervisor, build_proc_perf

__all__ = ["ClusterSpec", "Supervisor", "build_proc_perf"]
