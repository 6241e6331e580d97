"""Cross-session batched dispatch: N live sessions, ONE device step.

The daemon hosts one plugin instance per connection (bridge.py), and
without batching each instance costs its own device round trip per
frame — N DAW sessions = N dispatches per block period.  This broker is
the serving-side fix (round-3 verdict #2): same-geometry sessions share
a K-slot, vmapped stream engine, so every dispatch advances EVERY
session with a frame pending — the inference-server dynamic-batching
pattern applied to the reference's hot path (src/phaserotate.c:538-772
served N-way).

Mechanics:

* Engine state is one pytree with a leading (capacity, channels) axis
  (stream/engine.init_state); a per-slot ``active`` mask freezes the
  state of slots with nothing to process, and a ``reset`` mask zeroes a
  slot in-graph when a session (re)opens it — activate() semantics
  (src/phaserotate.c:511-520) with no extra compiled program.
* Dispatch is opportunistic: the first submitter becomes the
  dispatcher and drains the pending set; frames arriving while a
  dispatch is in flight coalesce into the next one.  No artificial
  batching delay — under load, batching emerges from queueing.
* Output pipelining lives in the broker (depth ``D`` per slot): a
  submit returns the slot's output from ``D`` dispatches ago
  (zeros while filling), so no dispatch ever blocks on a device
  readback that hasn't had ``D`` block periods to land — the same
  contract as stream/host.OutputPipeline, shared across sessions.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.sizes import StreamGeometry
from .engine import init_state, stream_step

__all__ = ["StreamBroker"]


@functools.partial(jax.jit, static_argnames=("geom",))
def _slot_step(state, frames, targets, active, reset, geom):
    """One masked step over (capacity, channels) slots.

    state: pytree with (K, C, ...) leaves; frames (K, C, parsiz);
    targets (K, C); active (K,) bool; reset (K,) bool.
    """
    def mask(leaf_new, leaf_old, m):
        mm = m.reshape((-1,) + (1,) * (leaf_new.ndim - 1))
        return jnp.where(mm, leaf_new, leaf_old)

    # in-graph slot reset (activate() for a freshly opened slot)
    state = jax.tree.map(
        lambda leaf: mask(jnp.zeros_like(leaf), leaf, reset), state)
    step = jax.vmap(jax.vmap(
        lambda s, f, t: stream_step(s, f, t, geom)))
    new_state, y = step(state, frames,
                        jnp.asarray(targets, jnp.float32))
    out_state = jax.tree.map(
        lambda n, o: mask(n, o, active), new_state, state)
    y = jnp.where(active.reshape(-1, 1, 1), y, 0.0)
    return out_state, y


class StreamBroker:
    """K-slot dynamic batcher for same-geometry streaming sessions.

    Thread-safe; every public method may be called from any session
    thread.  ``submit`` blocks until the (pipelined) output for the
    submitted frame's slot is available — one device dispatch serves
    every slot with a frame pending at dispatch time.
    """

    def __init__(self, geom: StreamGeometry, channels: int,
                 capacity: int = 8, depth: int = 16,
                 hold_frac: float = 0.25):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.geom = geom
        self.channels = channels
        self.capacity = capacity
        self.depth = int(depth)
        # coalescing hold: free-running sessions do NOT align on their
        # own — without a hold the dispatcher drains singleton batches
        # in strict alternation (measured: 2 sessions = 2 serialized
        # dispatches per block period each).  Waiting up to this
        # fraction of one frame budget for the other open slots turns
        # N near-simultaneous submits into one dispatch; the cost is a
        # bounded sub-frame latency only when some open slot is idle.
        self.hold_s = float(hold_frac) * geom.parsiz / float(geom.rate)
        # a slot only counts toward the coalescing target while it is
        # actively submitting (last submit within ~2 frame periods):
        # an open-but-idle slot (host transport stopped, session
        # warming up serially) must not make every dispatch pay the
        # full hold waiting for a frame that is not coming
        self._active_window_s = 2.5 * geom.parsiz / float(geom.rate)
        self._last_seen = np.zeros(capacity, np.float64)
        self._state = init_state(geom, (capacity, channels))
        self._mu = threading.Lock()
        self._free: List[int] = list(range(capacity))
        self._reset_pending = np.zeros(capacity, bool)
        self._pending: Dict[int, Tuple[np.ndarray, np.ndarray, object]] \
            = {}
        self._dispatching = False
        self._cv = threading.Condition(self._mu)
        # per-slot in-flight outputs: deque of (device_batch, row)
        self._pipes: List[collections.deque] = [
            collections.deque() for _ in range(capacity)]
        # per-slot generation, bumped on open/reset/close: a dispatch
        # snapshot carries the generation it was taken under, so an
        # in-flight dispatch for a since-closed (possibly reopened)
        # slot cannot deposit a stale output into the NEW session's
        # pipe — without this, close+reopen during the device step
        # shifts the next session's whole stream by one frame
        self._slot_gen = [0] * capacity
        self._zeros = np.zeros((channels, geom.parsiz), np.float32)
        # reusable staging (first-touch cost paid once)
        self._frames = np.zeros((capacity, channels, geom.parsiz),
                                np.float32)
        self._targets = np.zeros((capacity, channels), np.float32)
        # device-resident cache for the small per-dispatch operands
        # (active/reset masks, target angles): every host->device
        # transfer op has a fixed cost regardless of size, and these
        # arrays rarely change between dispatches — transferring them
        # fresh each block multiplies the dispatch cadence
        self._operand_cache: Dict[tuple, object] = {}
        self.dispatches = 0       # total device dispatches (telemetry)
        self.frames_served = 0    # total slot-frames served

    @property
    def extra_latency(self) -> int:
        """Samples of added latency from broker pipelining."""
        return self.depth * self.geom.parsiz

    def open(self) -> int:
        """Claim a slot (its state resets in the next dispatch)."""
        with self._mu:
            if not self._free:
                raise RuntimeError("stream broker full")
            slot = self._free.pop()
            self._reset_pending[slot] = True
            self._pipes[slot].clear()
            self._slot_gen[slot] += 1
            return slot

    def close(self, slot: int) -> None:
        with self._mu:
            dropped = self._pending.pop(slot, None)
            if dropped is not None:  # never leave a submitter hanging
                done, box = dropped[2]
                box[0] = self._zeros
                done.set()
            self._pipes[slot].clear()
            self._slot_gen[slot] += 1
            if slot not in self._free:
                self._free.append(slot)

    def reset(self, slot: int) -> None:
        """activate() for one slot: zero its engine state in the next
        dispatch and drop its in-flight outputs.  Call only from the
        slot's own session thread (no concurrent submit)."""
        with self._mu:
            self._reset_pending[slot] = True
            self._pipes[slot].clear()
            self._slot_gen[slot] += 1

    def in_use(self) -> int:
        with self._mu:
            return self.capacity - len(self._free)

    def submit(self, slot: int, frame: np.ndarray,
               degrees: np.ndarray) -> np.ndarray:
        """Advance ``slot`` by one (channels, parsiz) frame; returns the
        slot's output from ``depth`` dispatches ago (zeros until the
        pipeline fills).  Blocks until this frame's dispatch ran."""
        import time

        done = threading.Event()
        box: list = [None]
        self._last_seen[slot] = time.perf_counter()
        with self._mu:
            if slot in self._free:
                # a released slot may already belong to the NEXT
                # session: failing loudly here beats silently feeding
                # frames into someone else's stream
                raise RuntimeError(f"submit to unopened slot {slot}")
            if slot in self._pending:
                # a second frame before the first dispatched: wait our
                # turn (keeps per-slot ordering without queue growth)
                while slot in self._pending:
                    self._cv.wait()
            # np.array COPIES: the caller's staging buffer mutates while
            # this frame waits for (or rides) a dispatch
            self._pending[slot] = (np.array(frame, np.float32),
                                   np.array(degrees, np.float32),
                                   (done, box))
            self._cv.notify_all()  # a holding dispatcher may be waiting
            if self._dispatching:
                dispatcher = False
            else:
                self._dispatching = True
                dispatcher = True
        if dispatcher:
            self._drain()
        done.wait()
        return box[0]

    def _cached_operand(self, arr: np.ndarray):
        """Device copy of a small operand, reused while its contents
        repeat (the steady-state hit rate is ~100%: masks and angles
        only change on open/close/automation)."""
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        dev = self._operand_cache.get(key)
        if dev is None:
            if len(self._operand_cache) > 256:
                self._operand_cache.clear()
            # .copy(): jax's CPU backend zero-copy-aliases numpy buffers
            # it considers safely aligned, so a device array built from
            # a REUSED staging buffer (self._targets) would silently
            # change contents when the staging mutates for the next
            # dispatch.  The snapshot is never written again.
            dev = jnp.asarray(arr.copy())
            self._operand_cache[key] = dev
        return dev

    def _drain(self) -> None:
        import time

        while True:
            with self._mu:
                if not self._pending:
                    self._dispatching = False
                    self._cv.notify_all()
                    return
                # coalescing hold: give the other RECENTLY ACTIVE slots
                # a bounded chance to land in THIS dispatch
                if self.hold_s > 0.0:
                    deadline = time.perf_counter() + self.hold_s

                    def want() -> int:
                        cutoff = (time.perf_counter()
                                  - self._active_window_s)
                        return int((self._last_seen > cutoff).sum())

                    while len(self._pending) < want():
                        left = deadline - time.perf_counter()
                        if left <= 0 or not self._cv.wait(timeout=left):
                            break
                batch = self._pending
                self._pending = {}
                gens = {slot: self._slot_gen[slot] for slot in batch}
                reset = self._reset_pending.copy()
                self._reset_pending[:] = False
                self._cv.notify_all()

            try:
                self._frames[:] = 0.0
                active = np.zeros(self.capacity, bool)
                for slot, (frame, degs, _w) in batch.items():
                    self._frames[slot] = frame
                    self._targets[slot] = degs
                    active[slot] = True
                # frames.copy() is load-bearing, not defensive style:
                # jit on the CPU backend zero-copy-aliases suitably
                # aligned numpy args, and execution is ASYNC — passing
                # the reused staging buffer directly let the next
                # iteration's `self._frames[:] = 0.0` overwrite an
                # in-flight dispatch's input (one corrupted frame then
                # poisons that slot's carried OLA state for good).
                self._state, y = _slot_step(
                    self._state, self._frames.copy(),
                    self._cached_operand(self._targets),
                    self._cached_operand(active),
                    self._cached_operand(reset), self.geom)
                if hasattr(y, "copy_to_host_async"):
                    y.copy_to_host_async()
                self.dispatches += 1
                self.frames_served += len(batch)
                # delivery runs under the lock: the generation check and
                # the pipe append must be atomic against close()/reset(),
                # or a reopen landing between them still receives this
                # dead dispatch's output (the slot-churn race, narrower
                # window).  The device work is already queued; the only
                # thing inside the critical section that can block is the
                # pipeline-full readback, which had `depth` block periods
                # to land.
                with self._mu:
                    for slot, (_f, _d, (done, box)) in batch.items():
                        if self._slot_gen[slot] != gens[slot]:
                            # slot closed/reset (maybe reopened) while
                            # this dispatch was in flight: its output
                            # belongs to the dead session — do not touch
                            # the pipe
                            box[0] = self._zeros
                            done.set()
                            continue
                        pipe = self._pipes[slot]
                        pipe.append((y, slot))
                        if len(pipe) > self.depth:
                            y_old, row = pipe.popleft()
                            # np.asarray is cached on the array after the
                            # first conversion, so N slots popping the
                            # same dispatch pay one readback
                            box[0] = np.asarray(y_old)[row]
                        else:
                            box[0] = self._zeros
                        done.set()
            except BaseException:
                # a failed dispatch must not leave waiters blocked or
                # the broker claimed forever: release everyone — BOTH
                # this batch's waiters AND any frames that queued into
                # self._pending while the dispatch was in flight (those
                # submitters would otherwise block in done.wait() until
                # some unrelated future submit became dispatcher) —
                # clear the claim, and surface the error.
                for _slot, (_f, _d, (done, box)) in batch.items():
                    if box[0] is None:
                        box[0] = self._zeros
                    done.set()
                with self._mu:
                    stranded = self._pending
                    self._pending = {}
                    for _slot, (_f, _d, (done, box)) in stranded.items():
                        if box[0] is None:
                            box[0] = self._zeros
                        done.set()
                    self._dispatching = False
                    self._cv.notify_all()
                raise


def advance_stream_brokered(broker: StreamBroker, slot: int, cur_in,
                            cur_out, offset: int, x: np.ndarray,
                            degs: np.ndarray):
    """The host staging loop of stream/host.advance_stream with the
    frame step routed through a shared :class:`StreamBroker`.

    Same offset bookkeeping contract (src/phaserotate.c:615-725); the
    emitted output lags by ``broker.depth`` frames (broker pipelining).
    Returns ``(offset, out)`` — engine state lives in the broker.
    """
    parsiz = broker.geom.parsiz
    channels, n = x.shape
    out = np.empty_like(x)
    pos = 0
    while pos < n:
        ns = min(parsiz - offset, n - pos)
        cur_in[:, offset : offset + ns] = x[:, pos : pos + ns]
        out[:, pos : pos + ns] = cur_out[:, offset : offset + ns]
        offset += ns
        pos += ns
        if offset == parsiz:
            offset = 0
            # submit hands the broker its own snapshot (cur_in mutates
            # while the dispatch may still be in flight)
            cur_out[:] = broker.submit(slot, cur_in, degs)
    return offset, out
