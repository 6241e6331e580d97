"""Plugin lifecycle: the host-facing runtime shell.

Re-creates the LV2 plugin ABI surface (src/phaserotate.c:860-893 —
instantiate / connect_port / activate / run / cleanup) as a Python class
driving the GPU engine, so an audio host (our standalone hostapp, tests,
or an external bridge) gets exactly the reference's contract:

* URI-based mono/stereo dispatch (src/phaserotate.c:233-240);
* option-driven UI scale, clamped 1..2 (:261-276);
* port connect demux into (angle, in, out) triplets (:430-448);
* allocation-free steady-state run(): all device state pre-built at
  instantiate, run() only stages samples and dispatches jitted steps;
* latency reporting, in-place buffer handling (:780-788);
* control/notify message queues carrying the protocol of protocol.py;
* per-channel metering with UI level notifications (:741-771).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import numpy as np

from ..core.angles import degrees_to_turns_np
from ..core.sizes import stream_geometry_for_rate
from ..meter import (
    MeterConfig,
    init_meter_state,
    meter_block,
    meter_falloff,
    reset_peaks,
)
from ..stream.engine import host_angle_step, init_state
from ..stream.host import OutputPipeline, advance_stream
from .protocol import LevelsMsg, Message, ResetPeaks, StateMsg, UiOff, UiOn
from .uris import (
    MAX_CHANNELS,
    PLUGIN_URI,
    PLUGIN_URI_STEREO,
    PortIndex,
    port_channel,
    port_role,
)

__all__ = ["PhaseRotatePlugin", "descriptors"]


def descriptors() -> tuple:
    """The two plugin URIs, in descriptor order
    (src/phaserotate.c:879-893)."""
    return (PLUGIN_URI, PLUGIN_URI_STEREO)


class PhaseRotatePlugin:
    """One plugin instance (the reference's ``FFTiProc``)."""

    def __init__(self, uri: str, rate: float,
                 options: Optional[Dict[str, float]] = None):
        if uri == PLUGIN_URI:
            self.n_chn = 1
        elif uri == PLUGIN_URI_STEREO:
            self.n_chn = 2
        else:
            raise ValueError(f"unknown plugin URI {uri!r}")

        self.rate = float(rate)
        self.geom = stream_geometry_for_rate(rate)

        # dispatch pipelining (stream/host.py module docstring): trade
        # `pipeline` frames of extra latency for per-block readbacks
        # that always have pipeline-depth slack — the soft-real-time
        # mode for devices with a slow dispatch round trip
        self.pipeline_depth = 0
        if options and "pipeline" in options:
            self.pipeline_depth = max(0, int(options["pipeline"]))
        # cross-session batched dispatch (stream/broker.py): a shared
        # StreamBroker advances MANY plugin instances in one device step
        # — the daemon's serving mode.  The broker's pipelining replaces
        # the per-instance pipeline (latency accounting identical).
        self._broker = None
        self._slot: Optional[int] = None
        if options and "broker" in options:
            self._broker = options["broker"]
            if (self._broker.geom != self.geom
                    or self._broker.channels != self.n_chn):
                raise ValueError(
                    "broker geometry/channels do not match this instance")
            self.pipeline_depth = self._broker.depth
        # accelerator placement: committing the engine carry to device k
        # makes every dispatch of this instance run there (placement-
        # aware jit) — the daemon schedules sessions round-robin over a
        # chip pool this way (multi-chip serving without sharding)
        self.device_index = 0
        if options and "device" in options:
            self.device_index = int(options["device"])
            if not 0 <= self.device_index < len(jax.devices()):
                raise ValueError(
                    f"device {self.device_index} out of range "
                    f"({len(jax.devices())} available)")
        self.latency = (self.geom.latency
                        + self.pipeline_depth * self.geom.parsiz)

        # ui:scaleFactor option, clamped 1..2 (src/phaserotate.c:
        # 261-276).  Intent deviation: the reference then resets
        # ui_scale to 1.0 a few lines later (:299-300), so the option
        # is dead in its DSP instance; we apply the clamped value —
        # pinned both ways by tests/test_ref_plugin_binary.py.
        self.ui_scale = 1.0
        if options and "ui_scale" in options:
            self.ui_scale = float(np.clip(options["ui_scale"], 1.0, 2.0))
        self.link = False
        self.ui_active = False
        self._send_state = False

        self._mtr_cfg = MeterConfig(rate=self.rate, latency=self.latency)
        self._falloff = None
        self._fpp = 0

        # ports
        self._control: Optional[List[Message]] = None
        self._notify: Optional[List[Message]] = None
        self._latency_port: Optional[np.ndarray] = None
        self._angle = [None] * MAX_CHANNELS
        self._in = [None] * MAX_CHANNELS
        self._out = [None] * MAX_CHANNELS

        self._init_dsp()

    # -- lifecycle ---------------------------------------------------------

    def _init_dsp(self) -> None:
        parsiz = self.geom.parsiz
        if self._broker is not None:
            # engine state lives in the broker's slot axis; (re)opening
            # resets it in-graph at the next shared dispatch
            if self._slot is None:
                self._slot = self._broker.open()
            else:
                self._broker.reset(self._slot)
            self._state = None
        else:
            # channels ride a vmapped batch axis: one dispatch per frame
            # for mono AND stereo (the reference spawns a thread per
            # channel, cli/phase-rotate.cc:437-444; here batching is
            # the fan-out)
            self._state = init_state(self.geom, (self.n_chn,))
            if self.device_index:
                self._state = jax.device_put(
                    self._state, jax.devices()[self.device_index])
        # meter state lives on the host CPU backend: ballistics are a
        # few scalars per block, and per-block readbacks of the level
        # fields must not cost a remote-device round trip (the engine
        # carry stays on the accelerator; placement-aware jit compiles
        # meter_block for CPU because its state is committed there)
        cpu = jax.devices("cpu")[0]
        self._mtr = [jax.device_put(init_meter_state(self._mtr_cfg), cpu)
                     for _ in range(self.n_chn)]
        self._offset = 0
        self._cur_in = np.zeros((self.n_chn, parsiz), np.float32)
        self._cur_out = np.zeros((self.n_chn, parsiz), np.float32)
        self._pipe = (OutputPipeline(self.pipeline_depth, self.n_chn,
                                     parsiz)
                      if self.pipeline_depth > 0 else None)
        # host-side shadow of the device angle carry (negated turns) —
        # the pipelined path must not read device state synchronously
        self._angle_shadow = np.zeros(self.n_chn, np.float32)

    def connect_port(self, port: int, data) -> None:
        """src/phaserotate.c:409-448."""
        if port == PortIndex.ATOM_CONTROL:
            self._control = data
            return
        if port == PortIndex.ATOM_NOTIFY:
            self._notify = data
            return
        if port == PortIndex.LATENCY:
            self._latency_port = data
            return
        chn = port_channel(port)
        if chn < 0 or chn >= MAX_CHANNELS:
            return
        role = port_role(port)
        if role == "angle":
            self._angle[chn] = data
        elif role == "input":
            self._in[chn] = data
        else:
            self._out[chn] = data

    def activate(self) -> None:
        """Reset all streaming/meter state (src/phaserotate.c:511-520)."""
        self._init_dsp()

    def cleanup(self) -> None:
        """Release the broker slot (if any); other state is GC'd —
        ABI parity with src/phaserotate.c:179-223."""
        if self._broker is not None and self._slot is not None:
            self._broker.close(self._slot)
            self._slot = None

    # -- run ---------------------------------------------------------------

    def _handle_control(self) -> None:
        """src/phaserotate.c:800-830."""
        assert self._control is not None
        for msg in self._control:
            if isinstance(msg, UiOff):
                self.ui_active = False
            elif isinstance(msg, UiOn):
                self.ui_active = True
                self._send_state = True
            elif isinstance(msg, ResetPeaks):
                self._mtr = [reset_peaks(m) for m in self._mtr]
            elif isinstance(msg, StateMsg):
                self.ui_scale = msg.uiscale
                self.link = msg.link
        self._control.clear()

    def run(self, n_samples: int) -> None:
        """Process one host block (src/phaserotate.c:774-852)."""
        # forward no-inplace buffers
        for c in range(self.n_chn):
            if self._in[c] is not self._out[c]:
                self._out[c][:n_samples] = self._in[c][:n_samples]

        if self._latency_port is not None:
            self._latency_port[0] = self.latency

        if self._control is None or self._notify is None:
            # latency measurement callback (src/phaserotate.c:790-793)
            return

        self._handle_control()

        if self._fpp != n_samples:
            self._falloff = jax.device_put(
                meter_falloff(self.rate, n_samples),
                jax.devices("cpu")[0])
            self._fpp = n_samples

        self._process_block(n_samples)

        if self.ui_active and self._send_state:
            self._send_state = False
            self._notify.append(
                StateMsg(uiscale=self.ui_scale, link=self.link))

    def _process_block(self, n: int) -> None:
        """src/phaserotate.c:538-772 with the DSP on device.

        All channels advance through one batched ``stream_step`` dispatch
        per completed ``parsiz`` frame (the reference runs a serial
        per-channel loop; here the channel axis batches the FFTs).
        """
        geom = self.geom
        parsiz = geom.parsiz
        n_chn = self.n_chn

        target_deg = np.array(
            [float(self._angle[c][0]) if self._angle[c] is not None else 0.0
             for c in range(n_chn)], np.float32)
        in_copies = [np.array(self._out[c][:n], np.float32)
                     for c in range(n_chn)]  # raw input (pre-process)

        target_turns = degrees_to_turns_np(target_deg)
        if self._broker is not None or self._pipe is not None:
            angle_now = self._angle_shadow  # no synchronous device read
        else:
            angle_now = np.asarray(self._state.angle)  # one readback
        angle_changed = target_turns != angle_now

        # block staging identical to the reference's offset bookkeeping,
        # shared with StreamingRotator (stream/host.advance_stream)
        offset_before = self._offset
        x_in = np.stack([self._out[c][:n] for c in range(n_chn)])
        if self._broker is not None:
            from ..stream.broker import advance_stream_brokered

            self._offset, y_out = advance_stream_brokered(
                self._broker, self._slot, self._cur_in, self._cur_out,
                self._offset, x_in, target_deg)
        else:
            self._state, self._offset, y_out = advance_stream(
                self._state, self._cur_in, self._cur_out, self._offset,
                x_in, target_deg, geom, pipe=self._pipe)
        if self._broker is not None or self._pipe is not None:
            a = self._angle_shadow
            for _ in range((offset_before + n) // geom.parsiz):
                a = host_angle_step(a, target_turns, geom)
            self._angle_shadow = a
        for c in range(n_chn):
            self._out[c][:n] = y_out[c]

        # metering (src/phaserotate.c:573-611, 728-771)
        for c in range(n_chn):
            # np.array (copy), never a view: the meter dispatch is
            # async and the port buffer is rewritten next run() — a
            # view would hand the queued computation mutating memory
            # (same hazard as the pipelined staging buffer,
            # stream/host.py advance_stream)
            self._mtr[c], lv = meter_block(
                self._mtr[c], in_copies[c],
                np.array(self._out[c][:n], np.float32),
                self._falloff, self._mtr_cfg.hold_samples,
                bool(angle_changed[c]))

            if self.ui_active:
                self._notify.append(LevelsMsg(
                    channel=c,
                    in_cur=float(lv.in_cur), in_mom=float(lv.in_mom),
                    in_peak=float(lv.in_peak),
                    out_cur=float(lv.out_cur), out_mom=float(lv.out_mom),
                    out_peak=float(lv.out_peak),
                    diff_cur=float(lv.diff_cur), diff_min=float(lv.diff_min),
                    diff_max=float(lv.diff_max),
                ))
