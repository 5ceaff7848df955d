"""The recorder's frame on the port, as the benchmark drives it.

A frame is what ``spatialsim_tpu_torch/tools/record.py`` ``record`` does
for one frame, without the file write and the compression:
``sim.step_raw(dt_per_frame / substeps)``, then the capture of
``FrameOverlap.capture`` -- ``sim.device_frame()``, the velocity colours,
``.T.contiguous()``, ``non_blocking`` copies into the next of two
alternating pinned host buffers, and an event -- then a wait on the
previous frame's event, so that one frame is in flight (a closed loop).
The benchmark marks each frame with an event before its capture and one
after it; a frame's time runs from the previous frame's end mark to its
own, so a host stall that leaves the card idle lands in the frame that
waited.  ``record_function`` ranges name the three parts for the trace.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import record_function

from portbench.reference import Frame


class Mark:
    """A point in the device's stream: a CUDA event, or the host clock on
    the CPU (where every copy is synchronous)."""

    def __init__(self, cuda: bool):
        self.event = None
        self.t = None
        if cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def ms_since(self, other: "Mark") -> float:
        if self.event is not None:
            return other.event.elapsed_time(self.event)
        return (self.t - other.t) * 1e3


@dataclass
class FrameRecord:
    index: int
    capture_start: Mark
    end: Mark
    rebuilt: bool
    steps_since: int            # the lists' age after the frame
    far_n: Optional[torch.Tensor] = None   # the lists' far_n after a rebuild


class FrameLoop:
    """Drives frames of ``sim`` as the recorder does (see the module)."""

    def __init__(self, sim, dt_per_frame: float, substeps: int,
                 max_speed_color: float, keep_far_n: bool = False):
        from spatialsim_tpu_torch.ops.colors import colors_by_velocity
        self.sim = sim
        self.colors = colors_by_velocity
        self.dt = dt_per_frame / max(substeps, 1)
        self.substeps = substeps
        self.max_speed = max_speed_color
        self.cuda = sim.device.type == "cuda"
        self.buffers = [None, None]
        self.last: Optional[FrameRecord] = None
        self.count = 0
        self.keep_far_n = keep_far_n

    def _buffers(self, k, shape):
        if self.buffers[k % 2] is None:
            self.buffers[k % 2] = tuple(
                torch.empty(shape, dtype=torch.float32, pin_memory=self.cuda)
                for _ in range(2))
        return self.buffers[k % 2]

    def capture(self, k: int) -> None:
        pos_o, vel_o = self.sim.device_frame()
        pos_d = pos_o.T.contiguous()
        col_d = self.colors(vel_o, self.max_speed).T.contiguous()
        pos_h, col_h = self._buffers(k, tuple(pos_d.shape))
        pos_h.copy_(pos_d, non_blocking=self.cuda)
        col_h.copy_(col_d, non_blocking=self.cuda)

    def frame(self) -> FrameRecord:
        k = self.count
        rebuilds = self.sim.rebuilds
        with record_function("frame.step"):
            self.sim.step_raw(self.dt)
        with record_function("frame.capture"):
            start = Mark(self.cuda)
            self.capture(k)
            end = Mark(self.cuda)
        with record_function("frame.wait"):
            if self.last is not None:
                self.last.end.wait()
        lists = self.sim.state.lists
        rebuilt = self.sim.rebuilds > rebuilds
        rec = FrameRecord(k, start, end, rebuilt, lists.steps_since,
                          lists.far_n if (rebuilt and self.keep_far_n)
                          else None)
        self.last = rec
        self.count += 1
        return rec

    def drain(self) -> None:
        if self.last is not None:
            self.last.end.wait()

    def captured(self, k: int):
        """Copies of frame ``k``'s captured positions and colours (after
        :meth:`drain`, for the last frame or the one before it)."""
        pos_h, col_h = self.buffers[k % 2]
        return pos_h.clone(), col_h.clone()

    def state_velocities(self):
        """The state's velocities in original order, ``(n, 3)`` on the
        host."""
        return self.sim.device_frame()[1].T.contiguous().cpu()

    def state_acc(self):
        """The last substep's accelerations (the window engine's
        ``state.acc``), mapped to original order, ``(n, 3)`` on the
        host."""
        acc = getattr(self.sim.state, "acc", None)
        if acc is None:
            raise RuntimeError("the check reads the window engine's "
                               "state.acc (advance order 2)")
        inv = self.sim.state.lists.inv_order.long()
        return acc[:, inv].T.contiguous().cpu()

    # -- the list cycle ----------------------------------------------------
    def next_is_check(self) -> bool:
        """Whether the next frame is the last of its list cycle without a
        rebuild: its substeps use the stalest lists of the cycle."""
        s = self.sim.state.lists.steps_build
        interval = self.sim.config.rebuild_interval
        return s + self.substeps <= interval < s + 2 * self.substeps

    def check_frame(self, x_p=None, v_p=None, col_p=None) -> Frame:
        """Run the next frame and return it with the state before it for
        the reference.  Without ``x_p``, the state before is the last
        frame run (its capture and the state's velocities)."""
        self.drain()
        if x_p is None:
            x_p, col_p = self.captured(self.last.index)
            v_p = self.state_velocities()
        rec = self.frame()
        self.drain()
        if rec.rebuilt:
            raise RuntimeError("a check frame held a rebuild")
        x_c, col_c = self.captured(rec.index)
        return Frame(x_p=x_p, v_p=v_p, x_c=x_c, v_c=self.state_velocities(),
                     col_c=col_c, acc=self.state_acc(),
                     substeps=self.substeps, dt=self.dt,
                     damping=float(self.sim.config.damping), col_p=col_p,
                     tau=rec.steps_since - 1)

    def cycle_frames(self) -> int:
        """More frames than any list cycle takes: a guard against a step
        that never rebuilds."""
        return 4 * (self.sim.config.rebuild_interval // self.substeps + 1)

    def to_check_frame(self) -> Frame:
        """Step on to the stalest frame of the current or next cycle and
        return it judged from the frame before."""
        for _ in range(self.cycle_frames()):
            if self.next_is_check():
                return self.check_frame()
            self.frame()
        raise RuntimeError("no stalest frame within a cycle's frames")

    def to_rebuild(self) -> None:
        """Run frames up to and including the next one with a rebuild."""
        for _ in range(self.cycle_frames()):
            if self.frame().rebuilt:
                return
        raise RuntimeError("no rebuild within a cycle's frames")
