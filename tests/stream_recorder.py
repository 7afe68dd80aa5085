"""A recording stand-in for a card's copy streams, shared by the tests of
the streamed train step and of the LMB tier's streamed page moves.

``Recorder`` keeps a vector clock per stream, as CUDA orders work: program
order on a stream, an event carries everything its stream had issued, a
wait merges it in.  Every copy, and every compute operation a test hooks
in (``op``), is logged with its stream and a snapshot of that stream's
clock, so one run yields the happens-before relation the tests read the
schedule's guarantees off (``before``).  The host is one more stream:
``synchronize`` merges an event into it, and ``host_op`` logs what the
host does after.  Copies run at once on the CPU, so the values the code
computes are real.
"""

import contextlib

from repro_torch.core import offload

STREAMS = ("compute", "h2d", "d2h", "host")


class Recorder(offload.HostStreams):
    """Host streams that record the schedule.  ``paged``, a predicate,
    tells which tensors are paged (pinned host memory on a card, what
    ``moves`` answers): every one by default, as the train step's tests
    want; a test of the LMB tier names a buffer's LMB pools."""

    def __init__(self, device="cpu", paged=None):
        super().__init__(device)
        self.clock = {s: dict.fromkeys(STREAMS, 0) for s in STREAMS}
        self.stream = "compute"
        self.log = []
        #: (tensor, stream) of every ``keep``
        self.kept = []
        self.paged = paged

    @contextlib.contextmanager
    def on(self, stream):
        prev, self.stream = self.stream, stream
        try:
            yield
        finally:
            self.stream = prev

    def record(self, stream):
        return dict(self.clock[stream])

    def wait(self, stream, event):
        for s, n in event.items():
            self.clock[stream][s] = max(self.clock[stream][s], n)

    def synchronize(self, event):
        self.wait("host", event)

    def _log(self, s, kind, what):
        self.clock[s][s] += 1
        self.log.append(dict(kind=kind, stream=s, clock=dict(self.clock[s]),
                             **what))
        return self.log[-1]

    def op(self, kind, **what):
        """Log an operation on the stream in use (compute, unless inside
        ``on``)."""
        return self._log(self.stream, kind, what)

    def host_op(self, kind, **what):
        """Log something the host does (read a pinned pool, drop it)."""
        return self._log("host", kind, what)

    def copy_(self, dst, src):
        self.op("copy", dst=dst, src=src)
        super().copy_(dst, src)

    def keep(self, tensor, stream):
        self.kept.append((tensor, stream))

    def moves(self, leaf):
        return True if self.paged is None else bool(self.paged(leaf))

    def stamp(self, stream):
        """A timing event on ``stream``, logged there like an operation
        (kind ``stamp``): see :class:`Stamp`."""
        return Stamp(self, self._log(stream, "stamp", {}))


class Stamp:
    """A recorded timing event.  It reads as landed only once the host
    has waited for it (``synchronize``, logged as the host's
    ``stamp_wait``), and its ``elapsed_time`` to a later stamp on its
    stream is the number of operations between them, in milliseconds."""

    def __init__(self, rec, entry):
        self.rec, self.entry, self.landed = rec, entry, False

    def query(self):
        return self.landed

    def synchronize(self):
        self.rec.wait("host", self.entry["clock"])
        self.rec.host_op("stamp_wait", stamp=self.entry)
        self.landed = True

    def elapsed_time(self, end):
        s = self.entry["stream"]
        return float(end.entry["clock"][s] - self.entry["clock"][s] - 1)


def before(a, b) -> bool:
    """``a`` happens before ``b`` on the device."""
    return a["clock"][a["stream"]] <= b["clock"][a["stream"]] and a is not b
