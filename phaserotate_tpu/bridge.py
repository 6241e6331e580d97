"""Engine daemon: stream audio through the GPU plugin from any process.

The reference's product forms are a loadable LV2 plugin and a JACK
standalone (src/phaserotate.c:860-893, Makefile:250-257) — native binaries
an audio host dlopens or spawns.  A GPU engine cannot live inside a DAW's
process, so the framework splits the plugin across a process boundary:

* this daemon owns the plugin instance (lifecycle, metering, GPU engine)
  and serves a Unix-domain socket;
* native clients — the ``prt_bridge`` file streamer and the
  ``phaserotate_tpu.so`` LV2 shim (native/) — speak a tiny length-prefixed
  binary protocol, so **no client ever imports Python**.

Protocol (all little-endian, fixed 8-byte header ``u32 type, u32 len``):

    client -> server
      INIT  (1): u32 rate, u32 channels            (first message)
      PROC  (2): u32 n_frames, f32 angle_deg[channels],
                 f32 samples[n_frames*channels]     (interleaved)
      BYE   (3): empty
      ANALYZE_BEGIN (4): u32 rate, u32 channels, u32 link,
                 u32 stride, u32 blksiz (0 = derive from rate) —
                 offline min-peak search, no INIT required
      ANALYZE_DATA  (5): u32 n_frames, f32 samples[n*ch]
      ANALYZE_END   (6): empty -> ANALYZE_OK reply
      CTRL  (7): u32 event — a GUI control message for this session's
                 plugin, the wire form of the reference's control-port
                 atoms (src/phaserotate.c:800-830).  Fire-and-forget
                 (no reply; effects land at the next PROC).  Events:
                   1 ui_on   — enable metering: LEVELS stream + a STATE
                              echo (src/phaserotate.c:808-810, 845-848)
                   2 ui_off  — stop the LEVELS stream (:806-807)
                   3 reset_peaks — clear peak-hold/diff accums (:811-814)
                   4 state   — + f32 uiscale, u32 link: persist UI state
                              in the DSP instance (:815-826)
    server -> client
      INIT_OK (101): u32 latency_frames, u32 parsiz, u32 channels
      PROC_OK (102): u32 n_frames, f32 samples[n_frames*channels]
      ANALYZE_OK (201): u32 channels, then per channel
                 f32 angle_deg, f32 peak_zero, f32 peak_min, u32 found
      LEVELS  (103): sent BEFORE the PROC_OK it belongs to when metering
                 is on (so a client reading until PROC_OK consumes it in
                 stride): u32 count, then per entry u32 channel +
                 9 x f32 (the level fields of the reference's 'levels'
                 atom, src/phaserotate.c:741-771)
      STATE   (104): f32 uiscale, u32 link — the 'state' atom the DSP
                 echoes after ui_on (src/phaserotate.c:522-536);
                 informational, precedes its PROC_OK like LEVELS
      ERR     (199): utf-8 message (connection closes after)

    Clients must skip informational messages (anything in 103..198)
    while waiting for a reply — the protocol stays extensible.

Run:  python -m phaserotate_tpu.bridge --socket /tmp/phaserotate_tpu.sock
"""

from __future__ import annotations

import argparse
import collections
import os
import socket
import struct
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0x50525431  # "PRT1"
T_INIT, T_PROC, T_BYE = 1, 2, 3
T_ANALYZE_BEGIN, T_ANALYZE_DATA, T_ANALYZE_END = 4, 5, 6
T_CTRL = 7
T_INIT_OK, T_PROC_OK, T_LEVELS, T_ERR = 101, 102, 103, 199
T_STATE = 104  # informational, like T_LEVELS
T_ANALYZE_OK = 201  # NOT in the 103..198 informational range
# CTRL event codes (the reference's four control atoms,
# src/phaserotate.c:800-830)
CTRL_UI_ON, CTRL_UI_OFF, CTRL_RESET_PEAKS, CTRL_STATE = 1, 2, 3, 4
MAX_FRAMES = 1 << 20
# bound daemon memory by accumulated SAMPLES (frames x channels), not
# frames — 2^26 frames of 8-channel audio would otherwise buffer ~2 GiB
# per connection; 2^26 samples is 256 MiB float32 (~23 min mono @48 kHz)
MAX_ANALYZE_SAMPLES = 1 << 26
# concurrent in-flight analyses are bounded too, so N clients cannot
# multiply that cap into daemon OOM (excess connections get T_ERR)
MAX_CONCURRENT_ANALYSES = 4
_analyze_slots = threading.BoundedSemaphore(MAX_CONCURRENT_ANALYSES)
DEFAULT_SOCKET = "/tmp/phaserotate_tpu.sock"

__all__ = ["serve", "BridgeClient", "DEFAULT_SOCKET", "main"]


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(conn: socket.socket) -> Tuple[int, bytes]:
    hdr = _recv_exact(conn, 8)
    mtype, mlen = struct.unpack("<II", hdr)
    if mlen > 16 * MAX_FRAMES:
        raise ConnectionError(f"oversized message ({mlen} bytes)")
    return mtype, _recv_exact(conn, mlen) if mlen else b""


def _send_msg(conn: socket.socket, mtype: int, payload: bytes = b"") -> None:
    conn.sendall(struct.pack("<II", mtype, len(payload)) + payload)


class _Analysis:
    """Accumulates ANALYZE_DATA chunks and runs the offline min-peak
    search (the CLI workflow, cli/phase-rotate.cc:779-948) on the
    pool-assigned accelerator."""

    def __init__(self, payload: bytes, pool: "DevicePool"):
        rate, channels, link, stride, blksiz = struct.unpack(
            "<IIIII", payload)
        if not (8000 <= rate <= 768000):
            raise ValueError(f"implausible sample rate {rate}")
        if not 1 <= channels <= 8:
            raise ValueError(f"channels must be 1..8, got {channels}")
        if not _analyze_slots.acquire(blocking=False):
            raise ValueError(
                f"daemon busy: {MAX_CONCURRENT_ANALYSES} analyses "
                "already in flight")
        self._slot_held = True
        self.rate, self.channels = rate, channels
        self.link, self.stride, self.blksiz = bool(link), stride, blksiz
        self.device, self.lock = pool.assign()
        self.chunks: List[np.ndarray] = []
        self.frames = 0

    def release(self) -> None:
        if getattr(self, "_slot_held", False):
            self._slot_held = False
            _analyze_slots.release()

    def feed(self, payload: bytes) -> None:
        (n,) = struct.unpack_from("<I", payload, 0)
        want = 4 + 4 * n * self.channels
        if len(payload) != want:
            raise ValueError("bad ANALYZE_DATA payload")
        if (self.frames + n) * self.channels > MAX_ANALYZE_SAMPLES:
            raise ValueError(
                f"analysis exceeds {MAX_ANALYZE_SAMPLES} samples")
        self.chunks.append(
            np.frombuffer(payload, np.float32, n * self.channels, 4))
        self.frames += n

    def finish(self) -> bytes:
        import jax

        from .search import find_min_peak_angle

        flat = (np.concatenate(self.chunks) if self.chunks
                else np.zeros(0, np.float32))
        x = flat.reshape(self.frames, self.channels).T
        with self.lock:  # the assigned accelerator is single-owner
            with jax.default_device(jax.devices()[self.device]):
                res = find_min_peak_angle(
                    x, rate=self.rate, stride=self.stride,
                    link_channels=self.link, blksiz=self.blksiz)
        out = struct.pack("<I", self.channels)
        for c in range(self.channels):
            out += struct.pack(
                "<fffI", res.angles_deg[c], res.peak_zero[c],
                res.peak_min[c], int(res.found[c]))
        return out


class _SessionSurface:
    """gui/web.py surface over one daemon client session (the contract
    documented on gui.web.HostSurface)."""

    def __init__(self, session: "_Session", sid: int):
        self._s = session
        self.label = (f"client #{sid}")
        self.channels = session.channels

    def snapshot(self) -> dict:
        s = self._s
        ui = s.host.ui
        return {
            "label": self.label,
            "channels": s.channels,
            "rate": s.rate,
            "device": s.device,
            "link": ui.link.active,
            "ui_scale": ui.ui_scale,
            "angles": [d.value for d in ui.dials],
            "meters": [vars(m).copy() for m in ui.meters],
        }

    def _arm_override(self) -> None:
        s = self._s
        # swap the (override, base) pair atomically: process() reads
        # them together under the same lock, so a dial write from a web
        # thread can't be torn against a stale base for a block
        with s._ovr_mu:
            s.ui_override = [float(s.host.angles[c][0])
                             for c in range(s.channels)]
            s._override_base = None  # adopt next PROC's angles as base

    def set_dial(self, chn: int, degrees: float) -> None:
        self._s.host.ui.dials[chn].set_value(float(degrees))
        self._arm_override()

    def scroll_dial(self, chn: int, steps: int) -> None:
        self._s.host.ui.dials[chn].scroll(int(steps))
        self._arm_override()

    def set_link(self, active: bool) -> None:
        self._s.host.ui.set_link(bool(active))
        if active:
            self._arm_override()

    def reset_peaks(self) -> None:
        self._s.host.ui.click_meter()

    def set_scale(self, scale: float) -> None:
        self._s.host.ui.set_scale(float(scale))


class _Session:
    """One connection = one fully-wired plugin host (reuses
    hostapp.StandaloneHost for the port wiring and run staging; this
    layer only adds validation, interleaving, and meter extraction).

    Like an LV2 host instantiating the reference plugin freely
    (src/phaserotate.c:860-893), the daemon hosts one independent
    plugin instance per connection; ``engine_lock`` serializes the
    actual device dispatch (each device is single-owner) while the socket
    layer itself accepts any number of clients concurrently."""

    def __init__(self, rate: int, channels: int, meters: bool,
                 engine_lock: threading.Lock, pipeline: int = 0,
                 web_ui: bool = False, device: int = 0,
                 rtt_stats: Optional[Tuple[float, float]] = None,
                 brokers: Optional["BrokerPool"] = None):
        from .hostapp import StandaloneHost

        if channels not in (1, 2):
            raise ValueError(f"channels must be 1 or 2, got {channels}")
        if not (8000 <= rate <= 768000):
            raise ValueError(f"implausible sample rate {rate}")
        if pipeline < 0:  # auto: size the depth from the measured RTT
            from .core.sizes import stream_geometry_for_rate

            med, p99 = rtt_stats or (0.0, 0.0)
            pipeline = auto_pipeline_depth(
                med, rate, stream_geometry_for_rate(rate).parsiz,
                rtt_p99_s=p99)
        self.channels = channels
        self.rate = rate
        self.device = device
        self.pipeline = pipeline
        self.lock = engine_lock
        broker = (brokers.get(rate, channels, device, pipeline)
                  if brokers is not None else None)
        self.batched = broker is not None
        with engine_lock:  # plugin instantiate compiles on-device code
            try:
                self.host = StandaloneHost(
                    rate, channels, block=MAX_FRAMES,
                    pipeline=pipeline, device=device, broker=broker)
            except RuntimeError:
                # broker slots exhausted: serve unbatched rather than
                # refusing the connection
                self.batched = False
                self.host = StandaloneHost(
                    rate, channels, block=MAX_FRAMES,
                    pipeline=pipeline, device=device)
        self.plugin = self.host.plugin
        self.meters = meters
        self.web_ui = web_ui
        # browser-dial override (gui/web.py): the reference UI writes
        # the host's angle port (gui/phaserotate.c:856); across the
        # daemon split the web dial instead overrides the client's PROC
        # angles until the client itself moves them (latest writer wins)
        self.ui_override = None
        self._override_base = None
        self._ovr_mu = threading.Lock()  # guards the pair above
        if meters or web_ui:
            from .plugin.protocol import UiOn

            self.host.control.append(UiOn())

    def close(self) -> None:
        self.plugin.cleanup()  # releases the broker slot, if any

    def ctrl(self, payload: bytes) -> None:
        """Queue one GUI control event for the plugin — the wire form
        of a control-port atom (src/phaserotate.c:800-830).  Takes
        effect at the next PROC's run()."""
        from .plugin.protocol import ResetPeaks, StateMsg, UiOff, UiOn

        (event,) = struct.unpack_from("<I", payload, 0)
        if event == CTRL_UI_ON:
            self.host.control.append(UiOn())
            self.meters = True  # per-session enable, no --meters needed
        elif event == CTRL_UI_OFF:
            self.host.control.append(UiOff())
            self.meters = False
        elif event == CTRL_RESET_PEAKS:
            self.host.control.append(ResetPeaks())
        elif event == CTRL_STATE:
            uiscale, link = struct.unpack_from("<fI", payload, 4)
            self.host.control.append(
                StateMsg(uiscale=uiscale, link=bool(link)))
        else:
            raise ValueError(f"unknown CTRL event {event}")

    def process(
        self, n: int, angles: np.ndarray, samples: np.ndarray,
    ) -> Tuple[np.ndarray, Optional[list], Optional[list]]:
        x = samples.reshape(n, self.channels).T
        with self._ovr_mu:
            if self.ui_override is not None:
                if self._override_base is None:
                    self._override_base = angles.copy()
                if np.array_equal(angles, self._override_base):
                    angles = np.asarray(self.ui_override, np.float32)
                else:  # client moved its own dial/automation: it wins
                    self.ui_override = None
                    self._override_base = None
        for c in range(self.channels):
            self.host.angles[c][0] = angles[c]
        if self.batched:
            # the shared broker IS the serialization point — holding
            # the engine lock here would defeat cross-session batching
            # (concurrent submits are what coalesce into one dispatch)
            out = self.host.process(x)
        else:
            with self.lock:  # serialize device dispatch across clients
                out = self.host.process(x)
        levels = states = None
        if self.meters:
            from .plugin.protocol import LevelsMsg, StateMsg

            levels = [m for m in self.host.notify
                      if isinstance(m, LevelsMsg)]
            states = [m for m in self.host.notify
                      if isinstance(m, StateMsg)]
            if not self.web_ui:  # else ui.poll() consumes + clears
                self.host.notify.clear()
        if self.web_ui:
            # mirror into the browser surface: dial display follows the
            # effective angles; levels land in ui.meters (poll clears
            # the notify queue AFTER the socket meters were extracted)
            self.host.ui.sync_dials()
            self.host.ui.poll()
        return out.T.reshape(-1).astype(np.float32), levels, states


def _handle(conn: socket.socket, meters: bool,
            pool: "DevicePool", pipeline: int = 0,
            registry: Optional[dict] = None,
            sid_out: Optional[list] = None,
            rtt_stats: Optional[Tuple[float, float]] = None,
            brokers: Optional["BrokerPool"] = None) -> None:
    if struct.unpack("<I", _recv_exact(conn, 4))[0] != MAGIC:
        _send_msg(conn, T_ERR, b"bad magic")
        return
    session: Optional[_Session] = None
    analysis: Optional[_Analysis] = None
    try:
        while True:
            mtype, payload = _recv_msg(conn)
            if mtype == T_BYE:
                return
            if mtype == T_ANALYZE_BEGIN:
                try:
                    analysis = _Analysis(payload, pool)
                except Exception as e:
                    _send_msg(conn, T_ERR, str(e).encode())
                    return
                continue
            if mtype == T_ANALYZE_DATA:
                if analysis is None:
                    _send_msg(conn, T_ERR, b"ANALYZE_DATA before BEGIN")
                    return
                try:
                    analysis.feed(payload)
                except Exception as e:
                    _send_msg(conn, T_ERR, str(e).encode())
                    return
                continue
            if mtype == T_ANALYZE_END:
                if analysis is None:
                    _send_msg(conn, T_ERR, b"ANALYZE_END before BEGIN")
                    return
                try:
                    result = analysis.finish()
                except Exception as e:
                    _send_msg(conn, T_ERR, str(e).encode()[:512])
                    return
                finally:
                    analysis.release()
                    analysis = None
                _send_msg(conn, T_ANALYZE_OK, result)
                continue
            if mtype == T_INIT:
                try:
                    rate, channels = struct.unpack("<II", payload)
                    device, lock = pool.assign()
                    session = _Session(rate, channels, meters, lock,
                                       pipeline=pipeline,
                                       web_ui=registry is not None,
                                       device=device,
                                       rtt_stats=rtt_stats,
                                       brokers=brokers)
                    if registry is not None:
                        sid = _register_session(registry, session)
                        if sid_out is not None:
                            sid_out.append(str(sid))
                except Exception as e:  # validation error -> report, drop
                    _send_msg(conn, T_ERR, str(e).encode())
                    return
                _send_msg(conn, T_INIT_OK, struct.pack(
                    "<III", session.plugin.latency,
                    session.plugin.geom.parsiz, channels))
            elif mtype == T_CTRL:
                if session is None:
                    _send_msg(conn, T_ERR, b"CTRL before INIT")
                    return
                try:  # fire-and-forget: effects land at the next PROC
                    session.ctrl(payload)
                except Exception as e:
                    _send_msg(conn, T_ERR, str(e).encode())
                    return
            elif mtype == T_PROC:
                if session is None:
                    _send_msg(conn, T_ERR, b"PROC before INIT")
                    return
                if len(payload) < 4:
                    _send_msg(conn, T_ERR, b"short PROC payload")
                    return
                (n,) = struct.unpack_from("<I", payload, 0)
                ch = session.channels
                want = 4 + 4 * ch + 4 * n * ch
                if n > MAX_FRAMES or len(payload) != want:
                    _send_msg(conn, T_ERR, b"bad PROC payload")
                    return
                angles = np.frombuffer(payload, np.float32, ch, 4)
                samples = np.frombuffer(payload, np.float32, n * ch,
                                        4 + 4 * ch)
                out, levels, states = session.process(n, angles, samples)
                for st in states or ():
                    _send_msg(conn, T_STATE, struct.pack(
                        "<fI", st.uiscale, int(st.link)))
                if levels is not None:
                    # info messages precede the reply they belong to, so
                    # a client reading until PROC_OK consumes them in
                    # stride
                    blob = struct.pack("<I", len(levels))
                    for lv in levels:
                        blob += struct.pack(
                            "<I9f", lv.channel, lv.in_cur, lv.in_mom,
                            lv.in_peak, lv.out_cur, lv.out_mom,
                            lv.out_peak, lv.diff_cur, lv.diff_min,
                            lv.diff_max)
                    _send_msg(conn, T_LEVELS, blob)
                _send_msg(conn, T_PROC_OK,
                          struct.pack("<I", n) + out.tobytes())
            else:
                _send_msg(conn, T_ERR, f"unknown type {mtype}".encode())
                return
    finally:
        # connection dropped mid-analysis: return the concurrency slot
        if analysis is not None:
            analysis.release()
        if session is not None:
            session.close()  # releases the broker slot, if any


def measure_dispatch_rtt(reps: int = 5) -> float:
    """Median seconds for a trivial dispatch + scalar readback — the
    device round trip that bounds synchronous streaming (and sizes the
    automatic pipeline depth)."""
    return measure_dispatch_rtt_stats(reps)[0]


def measure_dispatch_rtt_stats(reps: int = 40) -> Tuple[float, float]:
    """(median, p99) seconds for a trivial dispatch + scalar readback.

    The p99 matters as much as the median on a jittery link: where RTT
    spikes reach several times the median, a pipeline depth sized to
    the median alone drops blocks exactly at those spikes."""
    import time

    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    float(f(x)[0])  # compile
    times = []
    for _ in range(max(reps, 3)):
        t0 = time.perf_counter()
        float(f(x)[0])
        times.append(time.perf_counter() - t0)
    times.sort()
    p99 = times[min(len(times) - 1, int(0.99 * len(times)))]
    return times[len(times) // 2], p99


def auto_pipeline_depth(rtt_s: float, rate: int, parsiz: int,
                        slack_frames: int = 2, max_depth: int = 64,
                        rtt_p99_s: Optional[float] = None) -> int:
    """Frames of lookahead: ``ceil(max(RTT, p99 RTT) / frame) + slack``.

    A readback issued at frame j is needed at frame j+depth, so depth
    frames of budget must cover one round trip INCLUDING its jitter
    tail: a depth sized to the median alone underruns at every p99
    spike.  The p99 contribution is capped at 2x the median — typical
    spikes are absorbed, while a single pathological outlier in the p99
    sample cannot inflate the whole session's latency (no finite depth
    covers a link's worst case, and beyond ~2xRTT the latency cost
    outweighs the shrinking dropout margin).  ``slack_frames`` then covers what
    the capped sample missed.  When no p99 figure is supplied the
    median is used alone — callers with a real-time contract should
    pass one (serve() does).

    With a sub-millisecond round trip this is 2-3 frames of lookahead;
    a slow or jittery round trip grows it toward ``max_depth``."""
    frame_s = parsiz / float(rate)
    cover = max(rtt_s, min(rtt_p99_s or 0.0, 2.0 * rtt_s))
    depth = int(np.ceil(cover / frame_s)) + int(slack_frames)
    return max(1, min(depth, max_depth))


class BrokerPool:
    """Lazily built shared StreamBrokers, one per (rate, channels,
    device, depth) geometry group — sessions landing in the same group
    ride one batched dispatch (round-3 verdict #2)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._mu = threading.Lock()
        self._brokers: dict = {}

    def get(self, rate: int, channels: int, device: int, depth: int):
        import jax

        from .core.sizes import stream_geometry_for_rate
        from .stream.broker import StreamBroker

        geom = stream_geometry_for_rate(rate)
        key = (geom, channels, device, depth)
        with self._mu:
            br = self._brokers.get(key)
            if br is None:
                with jax.default_device(jax.devices()[device]):
                    br = StreamBroker(geom, channels,
                                      capacity=self.capacity,
                                      depth=max(depth, 1))
                self._brokers[key] = br
            return br


class DevicePool:
    """Round-robin accelerator assignment for daemon sessions.

    Each device is single-owner (its own engine lock serializes the
    dispatches landing on it); sessions on different devices stream
    concurrently — multi-chip serving without sharding, the daemon's
    analogue of an LV2 host instantiating plugins freely
    (src/phaserotate.c:860-893) across a pod's chips."""

    def __init__(self, n_devices: int = 1):
        import jax

        avail = len(jax.devices())
        self.n = max(1, min(n_devices if n_devices > 0 else avail,
                            avail))
        self.locks = [threading.Lock() for _ in range(self.n)]
        self._next = 0
        self._mu = threading.Lock()

    def assign(self):
        with self._mu:
            idx = self._next % self.n
            self._next += 1
        return idx, self.locks[idx]


_SID_LOCK = threading.Lock()
_SID_NEXT = [1]


def _register_session(registry: dict, session: "_Session") -> int:
    with _SID_LOCK:
        sid = _SID_NEXT[0]
        _SID_NEXT[0] += 1
    registry[str(sid)] = _SessionSurface(session, sid)
    return sid


def _client_loop(conn: socket.socket, meters: bool,
                 pool: "DevicePool", pipeline: int = 0,
                 registry: Optional[dict] = None,
                 rtt_stats: Optional[Tuple[float, float]] = None,
                 brokers: Optional["BrokerPool"] = None) -> None:
    """Run one connection to completion with the per-client error
    containment the daemon guarantees: a bad or dead client is reported
    (when possible), dropped, and never takes the daemon down."""
    my_sids: list = []
    try:
        _handle(conn, meters, pool, pipeline, registry, my_sids,
                rtt_stats, brokers)
    except (ConnectionError, socket.timeout):
        pass  # dead/silent client: drop quietly, keep serving others
    except Exception as e:  # a bad client must never kill the daemon
        try:
            _send_msg(conn, T_ERR, str(e).encode()[:512])
        except OSError:
            pass
        print(f"bridge: dropped client: {e!r}", file=sys.stderr)
    finally:
        conn.close()
        if registry is not None:  # unregister this connection's session
            for sid in my_sids:
                registry.pop(sid, None)


def serve(path: str, once: bool = False, meters: bool = False,
          ready_fd: Optional[int] = None,
          timeout: Optional[float] = 600.0,
          pipeline: int = 0,
          ui_port: Optional[int] = None,
          devices: int = 1,
          batch_sessions: int = 0) -> None:
    """Serve plugin sessions on a Unix socket at ``path``.

    Accepts any number of concurrent clients — one plugin instance per
    connection, mirroring an LV2 host instantiating the reference plugin
    freely (src/phaserotate.c:860-893) — with device dispatch serialized
    behind one engine lock (each device is single-owner; the socket needn't
    be).  ``once`` exits after the first connection closes (test
    harness); ``ready_fd`` gets a byte written once listening (race-free
    subprocess startup); ``timeout`` (seconds) drops a connected client
    that goes silent so its thread doesn't linger forever; ``pipeline``
    enables depth-N dispatch pipelining in every hosted plugin (extra
    N*parsiz frames of reported latency, real-time margin independent of
    the device round-trip — stream/host.py module docstring);
    ``ui_port`` serves the browser GUI (gui/web.py) for every live
    session on http://127.0.0.1:<ui_port>/ (0 = ephemeral port);
    ``devices`` spreads sessions round-robin over that many
    accelerators (0 = all available), each with its own engine lock.
    ``pipeline=-1`` measures the dispatch round trip once at startup
    and sizes each session's depth to cover it (a sub-millisecond round
    trip -> 2-3 frames).
    """
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    pool = DevicePool(devices)
    brokers = BrokerPool(batch_sessions) if batch_sessions > 0 else None
    rtt_stats: Optional[Tuple[float, float]] = None
    if pipeline < 0:  # auto depth: measure the dispatch round trip once
        rtt_stats = measure_dispatch_rtt_stats()
        print(f"bridge: dispatch round trip {rtt_stats[0] * 1e3:.1f} ms "
              f"(p99 {rtt_stats[1] * 1e3:.1f} ms) -> auto pipeline "
              "depth per session", file=sys.stderr)
    registry: Optional[dict] = None
    webui = None
    if ui_port is not None:
        from .gui.web import WebUI

        registry = {}
        webui = WebUI(lambda: dict(registry), port=ui_port).start()
        print(f"bridge: web UI on {webui.url}", file=sys.stderr)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(16)
        if ready_fd is not None:
            os.write(ready_fd, b"R")
            os.close(ready_fd)
        while True:
            conn, _ = srv.accept()
            if timeout is not None:
                conn.settimeout(timeout)
            if once:
                _client_loop(conn, meters, pool, pipeline, registry,
                             rtt_stats, brokers)
                return
            threading.Thread(
                target=_client_loop,
                args=(conn, meters, pool, pipeline, registry,
                      rtt_stats, brokers),
                daemon=True).start()
    finally:
        if webui is not None:
            webui.stop()
        srv.close()
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


class BridgeClient:
    """Python-side protocol client (tests + in-process tooling; the
    production clients are the native ones in native/)."""

    def __init__(self, path: str, rate: int, channels: int,
                 init: bool = True, slack: int = 0):
        """``init=False`` skips the INIT handshake (no plugin session is
        instantiated) — for analyze-only clients.

        ``slack`` keeps that many PROC requests in flight: process()
        ships block j and returns the daemon's reply for block
        j - slack (zeros while filling), so a reply has ``slack`` extra
        block periods to land before the client needs it — the
        spike-absorption a synchronous client needs on a link whose
        round trip occasionally spikes to several times its median.
        Costs ``slack`` blocks of added latency (far under the plugin's
        own parsiz + firlen/2); the stream itself is identical, just
        delayed (tested).
        """
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)
        self.rate = rate
        self.channels = channels
        self.slack = int(slack)
        self._inflight: collections.deque = collections.deque()
        self.sock.sendall(struct.pack("<I", MAGIC))
        self.latency = self.parsiz = None
        if init:
            _send_msg(self.sock, T_INIT,
                      struct.pack("<II", rate, channels))
            mtype, payload = _recv_msg(self.sock)
            if mtype != T_INIT_OK:
                raise RuntimeError(payload.decode(errors="replace"))
            self.latency, self.parsiz, _ = struct.unpack("<III", payload)
        self.levels: list = []
        self.states: list = []  # (uiscale, link) STATE echoes

    def ctrl(self, event: int, uiscale: float = 1.0,
             link: bool = False) -> None:
        """Send one GUI control event (CTRL, fire-and-forget)."""
        payload = struct.pack("<I", event)
        if event == CTRL_STATE:
            payload += struct.pack("<fI", uiscale, int(link))
        _send_msg(self.sock, T_CTRL, payload)

    def ui_on(self) -> None:
        self.ctrl(CTRL_UI_ON)

    def ui_off(self) -> None:
        self.ctrl(CTRL_UI_OFF)

    def reset_peaks(self) -> None:
        self.ctrl(CTRL_RESET_PEAKS)

    def set_state(self, uiscale: float, link: bool) -> None:
        self.ctrl(CTRL_STATE, uiscale=uiscale, link=link)

    def process(self, block: np.ndarray, angles) -> np.ndarray:
        """block: (channels, n) float32 -> same shape, delayed output.

        Meter levels (daemon --meters) arriving before the reply are
        collected into :attr:`levels` (list of per-block tuples).
        With ``slack`` > 0 the returned output lags by ``slack``
        process() calls (zeros until the window fills)."""
        x = np.asarray(block, np.float32).reshape(self.channels, -1)
        n = x.shape[1]
        degs = np.broadcast_to(
            np.asarray(angles, np.float32), (self.channels,))
        payload = (struct.pack("<I", n) + degs.tobytes()
                   + x.T.reshape(-1).astype(np.float32).tobytes())
        _send_msg(self.sock, T_PROC, payload)
        if self.slack > 0:
            self._inflight.append(n)
            if len(self._inflight) <= self.slack:
                return np.zeros((self.channels, n), np.float32)
            self._inflight.popleft()
        return self._read_proc_reply()

    def _read_proc_reply(self) -> np.ndarray:
        while True:
            mtype, reply = _recv_msg(self.sock)
            if mtype == T_PROC_OK:
                break
            if mtype == T_LEVELS:
                (cnt,) = struct.unpack_from("<I", reply, 0)
                for i in range(cnt):
                    self.levels.append(
                        struct.unpack_from("<I9f", reply, 4 + 40 * i))
            elif mtype == T_STATE:
                uiscale, link = struct.unpack("<fI", reply)
                self.states.append((uiscale, bool(link)))
            elif 103 <= mtype <= 198:
                continue  # unknown informational message: skip
            else:
                raise RuntimeError(reply.decode(errors="replace"))
        (rn,) = struct.unpack_from("<I", reply, 0)
        out = np.frombuffer(reply, np.float32, rn * self.channels, 4)
        return out.reshape(rn, self.channels).T.copy()

    def analyze(self, audio: np.ndarray, stride: int = 24,
                link_channels: bool = False, blksiz: int = 0,
                chunk: int = 1 << 18):
        """Offline min-peak search on the daemon (the CLI workflow over
        the socket).  audio: (channels, n).  Returns a list of
        per-channel dicts {angle_deg, peak_zero, peak_min, found}."""
        x = np.atleast_2d(np.asarray(audio, np.float32))
        ch, n = x.shape
        _send_msg(self.sock, T_ANALYZE_BEGIN, struct.pack(
            "<IIIII", self.rate, ch, int(link_channels), stride, blksiz))
        inter = np.ascontiguousarray(x.T)
        for pos in range(0, max(n, 1), chunk):
            seg = inter[pos : pos + chunk]
            _send_msg(self.sock, T_ANALYZE_DATA, struct.pack(
                "<I", seg.shape[0]) + seg.tobytes())
        _send_msg(self.sock, T_ANALYZE_END)
        while True:
            mtype, reply = _recv_msg(self.sock)
            if mtype == T_ANALYZE_OK:
                break
            if 103 <= mtype <= 198:
                continue
            raise RuntimeError(reply.decode(errors="replace"))
        (rc,) = struct.unpack_from("<I", reply, 0)
        out = []
        for c in range(rc):
            a, pz, pm, found = struct.unpack_from("<fffI", reply,
                                                  4 + 16 * c)
            out.append({"angle_deg": a, "peak_zero": pz,
                        "peak_min": pm, "found": bool(found)})
        return out

    def drain(self) -> List[np.ndarray]:
        """Collect the replies still in flight under ``slack`` (the
        stream's last blocks).  Returns them oldest-first."""
        outs = []
        while self._inflight:
            self._inflight.popleft()
            outs.append(self._read_proc_reply())
        return outs

    def close(self) -> None:
        try:
            self.drain()  # daemon replies to every PROC: consume them
            _send_msg(self.sock, T_BYE)
        except (OSError, RuntimeError):
            # a daemon that died mid-slack surfaces here as a protocol
            # error on the drain — closing must still succeed
            pass
        self.sock.close()


def main(argv=None) -> int:
    from .core.plancache import enable_compile_cache
    from .utils.platform import apply_platform_env

    apply_platform_env()
    enable_compile_cache()
    ap = argparse.ArgumentParser(
        prog="phaserotate-bridge",
        description="GPU phase-rotation engine daemon (Unix socket).")
    ap.add_argument("--socket", default=DEFAULT_SOCKET)
    ap.add_argument("--once", action="store_true",
                    help="exit after the first connection closes")
    ap.add_argument("--meters", action="store_true",
                    help="stream meter levels after every block")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="drop a client silent for this many seconds "
                         "(0 = never)")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="dispatch-pipeline depth in frames (adds "
                         "N*parsiz reported latency; makes per-block "
                         "cost independent of device round-trip); "
                         "-1 = auto-size from the measured round trip")
    ap.add_argument("--ui-port", type=int, default=None,
                    help="serve the browser GUI for live sessions on "
                         "this port (0 = pick a free port)")
    ap.add_argument("--batch-sessions", type=int, default=0,
                    help="serve same-geometry sessions through ONE "
                         "batched device dispatch (N slots per group; "
                         "0 = one dispatch per session)")
    ap.add_argument("--devices", type=int, default=1,
                    help="spread sessions round-robin over this many "
                         "accelerators (0 = all available)")
    ap.add_argument("--ready-fd", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    print(f"phaserotate_tpu bridge: listening on {args.socket}",
          file=sys.stderr)
    serve(args.socket, once=args.once, meters=args.meters,
          ready_fd=args.ready_fd,
          timeout=args.timeout if args.timeout > 0 else None,
          pipeline=args.pipeline, ui_port=args.ui_port,
          devices=args.devices, batch_sessions=args.batch_sessions)
    return 0


if __name__ == "__main__":
    sys.exit(main())
