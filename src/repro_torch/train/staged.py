"""The train step staged once and replayed as a CUDA graph.

Counterpart of ``repro/launch/train.py:61``, where the reference stages
its train step with ``jax.jit(make_train_step(...))`` and dispatches the
whole step as one program each call; with the optimizer state offloaded
in its in-jit mode, XLA streams the state between HBM and host memory
around the update inside that program (``repro/train/loop.py:9-12``).
Here the step is ``make_train_step_`` (``repro_torch.train.loop``), which
reads its batch from static buffers, updates params and state in place
and pages the parked state in and out itself; :class:`StagedTrainStep`
captures it as one CUDA graph, page moves included, and replays it.  In
the streamed schedule the graph holds three branches: the H2D copies,
the step's compute and the D2H copies, joined by one event per leaf and
direction (the copy streams, ``core.offload.copy_streams``, are the
device's, shared by every streamed step on it); in the serial schedule
the copies run in series with the compute on the capture stream.

It counts calls as the engine's staged functions do
(``repro_torch.serve.staged``, whose capture and replay it shares): the
first step runs eagerly on the static buffers, the second captures the
step, with nothing run, and replays the graph for its own result, and
every later step replays.  A run's batch never changes shape, so there is
one graph.  It reads params and state at the addresses it was captured
with; a call with other tensors raises.  A capture that fails raises:
there is no eager fallback on the card, and no fallback from the
streamed schedule to the serial one.

The eager first step runs on the side stream the capture uses (the
device's, shared with the engine's staged functions), forking the same
copy streams, so the capture finds that stream's lazily made state (the
cuBLAS workspace) in place.  After that step the allocator's cache still
holds about the step's peak, while the capture allocates from the
graph's own pool; the cache is released before capturing, or the two
together could outgrow the card.  With the state parked in pinned host
memory, its device copy lives in the graph's pool, only while a replay
runs: between steps that memory is reserved, not allocated.

On the CPU (the caller asked for it, as the tests do) the same static
step is called directly; no graph exists.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.serve.staged import _Graph, _Staged

#: the static outputs of a step, 0-d float32
OUTPUTS = ("loss", "lr", "grad_norm")


class StagedTrainStep(_Staged):
    """``step_`` (``make_train_step_``) behind static batch buffers and
    static 0-d outputs, captured once on a CUDA device.  Called as
    ``(params, opt_state, batch, clock=None) -> (outputs, mode)``:
    ``batch`` is copied into the static buffers (shaped as ``template``'s
    tensors), ``outputs`` maps ``loss``, ``lr`` and ``grad_norm`` to the
    static outputs, valid until the next call, and ``mode`` is
    ``"eager"``, ``"capture"`` or ``"replay"``.  A :class:`StepClock`
    times an eager step's stages (the serial schedule's five, or the
    streamed step whole), and a capture or a replay whole (``capture``,
    ``replay``): inside a graph no stage can be timed apart."""

    FN = "train"

    def __init__(self, step_: Callable, template: Dict[str, torch.Tensor],
                 *, device):
        super().__init__(step_, device)
        self.batch = {k: torch.zeros(v.shape, dtype=v.dtype,
                                     device=self.device)
                      for k, v in template.items()}
        self.outputs = {k: torch.zeros((), dtype=torch.float32,
                                       device=self.device) for k in OUTPUTS}
        self.graph: Optional[_Graph] = None
        #: steps run (eager, captured or replayed)
        self.steps = 0
        self.eager_steps = 0

    @staticmethod
    def _output(result):
        return result

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps, "steps": self.steps,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes()}

    def _capture(self, args) -> _Graph:
        torch.cuda.empty_cache()
        return super()._capture(args)

    def __call__(self, params, opt_state, batch,
                 clock=None) -> Tuple[Dict[str, torch.Tensor], str]:
        self._check_params({"params": params, "opt_state": opt_state})
        if batch.keys() != self.batch.keys():
            raise ValueError(f"a batch of {sorted(batch)}, the static "
                             f"buffers hold {sorted(self.batch)}")
        for key, buf in self.batch.items():
            if batch[key].shape != buf.shape:
                raise ValueError(f"batch[{key!r}] {tuple(batch[key].shape)}"
                                 f", the static buffer {tuple(buf.shape)}")
            buf.copy_(batch[key])
        self.steps += 1
        args = (params, opt_state, self.batch, self.outputs)
        if self.device.type != "cuda":
            self.eager_steps += 1
            with self._span("eager"):
                return self.step(*args, clock), "eager"
        if self.steps > 1:
            mode = "replay" if self.graph is not None else "capture"
            if clock is not None:
                clock.start()
            if self.graph is None:
                with self._span("capture"):
                    self.graph = self._capture(args)
                    out = self._replay(self.graph)
            else:
                out = self._replay(self.graph)
            if clock is not None:
                clock.lap(mode)
            return out, mode
        self.eager_steps += 1
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with self._span("eager"), torch.cuda.stream(self._stream):
            self.step(*args, clock)
        current.wait_stream(self._stream)
        return self.outputs, "eager"
