"""One stand-in for ``render.graphs.capture``, shared by the CPU tests of
the port's three captured device programs (the wavefront round, the
lockstep units and the train step, each a ``graphs.KeptProgram``).

Without a card nothing can be captured: the stand-in records nothing,
keeps each unit it is given (``bodies``, in capture order) and a weak
reference to its graph (``graphs``), and each replay runs the unit, so a
value the unit baked in at its key's first run reaches every later run as
a real graph carries it.  ``stamps`` gives a replay's timing events (None:
none).  ``fail("capture")`` or ``fail("replay")`` makes the next capture
or replay (after ``skip`` more) raise ``Planted``; ``fail("read")`` lets
the next replay run and makes the first read or copy of a tensor after it
raise, where a card's replay fault surfaces, in a call made inside
``reads()``.

The fixture ``stand_in`` puts it in the one place the mechanism reads its
capture (``graphs.capture``), takes the graph route on the CPU
(``graphs.graph_route`` true unless eager, no stream capturing) and starts
and ends with no module-level program kept.
"""

import weakref

import pytest
import torch
from torch.overrides import TorchFunctionMode

from mort_tpu_torch.render import graphs, renderer
from mort_tpu_torch.render import wavefront as twf


class Planted(RuntimeError):
    """The failure ``StandIn.fail`` plants."""


class Graph:
    """A stand-in CUDA graph: counts its resets."""

    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


# what reads a tensor on the host or copies it: where a card's device
# fault of an earlier replay surfaces
_READS = {torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.item,
          torch.Tensor.clone}


class _Reads(TorchFunctionMode):
    """Raises ``Planted`` at the first read or copy (``_READS``) once
    ``armed``."""

    def __init__(self):
        super().__init__()
        self.armed = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.armed and func in _READS:
            self.armed = False
            raise Planted("a planted device fault of the replay before")
        return func(*args, **(kwargs or {}))


class StandIn:
    def __init__(self):
        self.bodies = []
        self.graphs = []
        self.stamps = lambda: None
        self._read = _Reads()
        self._fail = None

    def fail(self, phase: str, skip: int = 0) -> None:
        self._fail = [phase, skip]

    def reads(self) -> _Reads:
        """The mode in which a call's reads may raise (``fail("read")``)."""
        return self._read

    def _planted(self, phase):
        if self._fail is None or self._fail[0] != phase:
            return
        if self._fail[1]:
            self._fail[1] -= 1
            return
        self._fail = None
        raise Planted(f"a planted failure of a {phase}")

    def __call__(self, fn, dev, counts):
        self._planted("capture")
        counts["captures"] += 1
        self.bodies.append(fn)
        graph = Graph()
        self.graphs.append(weakref.ref(graph))

        def replay():
            self._planted("replay")
            fn()
            counts["replays"] += 1
            if self._fail is not None and self._fail[0] == "read":
                self._fail = None
                self._read.armed = True
            return self.stamps()
        return graph, replay


def drop_kept() -> None:
    """Drop the module-level kept programs: the wavefront's and the
    lockstep's (a train step's lives with its step function)."""
    twf.drop_graph()
    renderer._program.drop()


@pytest.fixture
def stand_in(monkeypatch):
    capture = StandIn()
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "graph_route", lambda dev, eager: not eager)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    drop_kept()
    yield capture
    drop_kept()
