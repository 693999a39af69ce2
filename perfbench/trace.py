"""The traced run's readings: device intervals from ``torch.profiler``
(CUPTI through kineto) and a host sampler that says what the program's
threads were doing while the device sat idle."""

from __future__ import annotations

import collections
import sys
import threading
import time

from . import stats

# frames that mean a thread is parked, not working
_WAITS = ("threading.py", "queue.py", "selectors.py", "concurrent/futures/", "socket.py",
          "ssl.py", "subprocess.py")


class HostSampler:
    """Every ``interval`` s, the innermost program frame of each thread
    that is not parked in a wait, stamped with ``time.time_ns()``."""

    def __init__(self, package: str, interval: float = 0.01):
        self.package = package
        self.interval = interval
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="perfbench.sampler", daemon=True)

    def _label(self, frame):
        inner = frame.f_code.co_filename
        if any(w in inner for w in _WAITS) or "perfbench" in inner:
            return None
        while frame is not None:
            path = frame.f_code.co_filename
            at = path.rfind(self.package + "/")
            if at >= 0:
                mod = path[at:-3] if path.endswith(".py") else path[at:]
                return f"{mod}:{frame.f_code.co_name}"
            frame = frame.f_back
        return None

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            now = time.time_ns()
            labels = []
            for tid, frame in sys._current_frames().items():
                if tid != me:
                    lab = self._label(frame)
                    if lab:
                        labels.append(lab)
            self.samples.append((now, labels))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        return False

    def label(self, lo_ns: int, hi_ns: int) -> str:
        """The host work seen most often in [lo_ns, hi_ns]."""
        count = collections.Counter(
            lab for t, labs in self.samples if lo_ns <= t <= hi_ns for lab in labs)
        return count.most_common(1)[0][0] if count else "host idle or outside the program"


class DeviceTrace:
    """``torch.profiler`` over the CUDA activity of the window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.events: list = []  # (name, start_ns, end_ns, is_copy)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        from torch.autograd import DeviceType

        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            start = e.start_ns()
            self.events.append((name, start, start + e.duration_ns(),
                                name.startswith(("Memcpy", "Memset"))))
        return False


def reduce(events: list, lo_ns: int, hi_ns: int, sampler: HostSampler | None) -> dict:
    """busy seconds (union of every device interval), the summed device
    time by op name, and the longest idle gaps with their host label."""
    spans = stats.clip([(s, e) for _n, s, e, _c in events], lo_ns, hi_ns)
    busy = stats.covered(spans) / 1e9
    by_name: dict = collections.defaultdict(float)
    for name, s, e, _c in events:
        s, e = max(s, lo_ns), min(e, hi_ns)
        if e > s:
            by_name[name] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(stats.gaps(spans, lo_ns, hi_ns), key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy,
        "window_s": (hi_ns - lo_ns) / 1e9,
        "device_ops": [[n, v] for n, v in ops],
        "idle_gaps": [[sampler.label(a, b) if sampler else "not sampled", (b - a) / 1e9]
                      for a, b in idle],
    }
