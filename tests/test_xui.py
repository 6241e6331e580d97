"""Embedded X11 LV2UI (native/prt_xui.cc), driven headless.

The UI's framebuffer + input pipeline is identical with and without a
display; these tests force headless mode (PHASEROTATE_TPU_XUI=headless),
inject pointer events through the exported test hooks, and assert on the
rendered pixels and on the LV2 port writes the widgets emit — the same
observable surface a DAW user sees (gui/phaserotate.c:833-890,
1236-1309).
"""

import ctypes
import os
import struct

import numpy as np
import pytest

from test_bridge import (  # the shared LV2 host helpers
    ATOM_NS,
    PROT_NS,
    _LV2Feature,
    _UridMap,
    native_built,  # noqa: F401  (fixture re-export)
)

_HANDLE = ctypes.c_void_p
_WRITE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint32,
                             ctypes.c_uint32, ctypes.c_uint32,
                             ctypes.c_void_p)


class _LV2UIDescriptor(ctypes.Structure):
    pass


_LV2UIDescriptor._fields_ = [
    ("URI", ctypes.c_char_p),
    ("instantiate", ctypes.CFUNCTYPE(
        _HANDLE, ctypes.POINTER(_LV2UIDescriptor), ctypes.c_char_p,
        ctypes.c_char_p, _WRITE_FN, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p)),
    ("cleanup", ctypes.CFUNCTYPE(None, _HANDLE)),
    ("port_event", ctypes.CFUNCTYPE(
        None, _HANDLE, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p)),
    ("extension_data", ctypes.CFUNCTYPE(ctypes.c_void_p,
                                        ctypes.c_char_p)),
]

# layout constants mirrored from prt_xui.cc
ROW_H, LINK_ROW_H, WIN_W = 132, 26, 448
DIAL_CX, DIAL_CY, DIAL_R = 62, 58, 42
METER_X, METER_W, METER_H = 140, 288, 14
METER_Y_IN, METER_Y_OUT, METER_Y_DELTA = 18, 50, 82
GREEN, RED, DELTA_BLUE = 0xFF22AA22, 0xFFEE3333, 0xFF2288CC
LINK_ON = 0xFF2288CC


def _parse_atom_object(urid, raw):
    """(otype_uri, {key_uri: (type_uri, bytes)}) from one Object atom."""
    size, typ = struct.unpack_from("<II", raw, 0)
    assert urid.by_id[typ] == ATOM_NS + "Object"
    _oid, otype = struct.unpack_from("<II", raw, 8)
    props = {}
    off, end = 16, 8 + size
    while off + 16 <= end:
        key, _ctx, vsize, vtype = struct.unpack_from("<IIII", raw, off)
        props[urid.by_id[key]] = (urid.by_id.get(vtype),
                                  raw[off + 16 : off + 16 + vsize])
        off += (16 + vsize + 7) & ~7
    return urid.by_id[otype], props


class _XuiHost:
    """Hosts one prt_xui instance headless; captures port writes."""

    def __init__(self, native_dir, stereo=False):
        os.environ["PHASEROTATE_TPU_XUI"] = "headless"
        self.lib = ctypes.CDLL(os.path.join(native_dir, "prt_xui.so"))
        self.lib.lv2ui_descriptor.restype = ctypes.POINTER(
            _LV2UIDescriptor)
        self.lib.lv2ui_descriptor.argtypes = [ctypes.c_uint32]
        self.lib.prt_xui_test_framebuffer.restype = ctypes.POINTER(
            ctypes.c_uint32)
        self.lib.prt_xui_test_framebuffer.argtypes = [
            _HANDLE, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        self.lib.prt_xui_test_pointer.argtypes = [
            _HANDLE, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        self.lib.prt_xui_test_headless.restype = ctypes.c_int
        self.lib.prt_xui_test_headless.argtypes = [_HANDLE]
        self.lib.prt_xui_test_dial.restype = ctypes.c_float
        self.lib.prt_xui_test_dial.argtypes = [_HANDLE, ctypes.c_int]
        self.desc = self.lib.lv2ui_descriptor(0).contents
        assert self.desc.URI == b"urn:phaserotate-tpu:plugin#x11_ui"

        self.urid = _UridMap()
        self.writes = []  # (port, protocol, bytes)

        def _write(_ctrl, port, size, protocol, buf):
            self.writes.append(
                (port, protocol,
                 ctypes.string_at(buf, size) if size else b""))

        self._write_cb = _WRITE_FN(_write)
        self._feat = _LV2Feature(
            b"http://lv2plug.in/ns/ext/urid#map",
            ctypes.cast(ctypes.byref(self.urid.struct), ctypes.c_void_p))
        self._feats = (ctypes.POINTER(_LV2Feature) * 2)(
            ctypes.pointer(self._feat), None)
        uri = (b"urn:phaserotate-tpu:plugin#stereo" if stereo
               else b"urn:phaserotate-tpu:plugin")
        widget = ctypes.c_void_p()
        self.h = self.desc.instantiate(
            ctypes.byref(self.desc), uri, b"/tmp", self._write_cb, None,
            ctypes.byref(widget), ctypes.cast(self._feats,
                                              ctypes.c_void_p))
        assert self.h
        self.idle = lambda: self._ext_idle(self.h)

    def _ext_idle(self, h):
        ptr = self.desc.extension_data(
            b"http://lv2plug.in/ns/extensions/ui#idleInterface")
        fn = ctypes.cast(ptr, ctypes.POINTER(
            ctypes.CFUNCTYPE(ctypes.c_int, _HANDLE)))
        return fn.contents(h)

    def framebuffer(self):
        w, h = ctypes.c_int(), ctypes.c_int()
        ptr = self.lib.prt_xui_test_framebuffer(
            self.h, ctypes.byref(w), ctypes.byref(h))
        arr = np.ctypeslib.as_array(ptr, shape=(h.value, w.value))
        return arr.astype(np.uint32)

    def pointer(self, kind, x, y, data=0):
        self.lib.prt_xui_test_pointer(self.h, kind, x, y, data)

    def press(self, x, y, button=1):
        self.pointer(0, x, y, button)

    def release(self, x, y):
        self.pointer(1, x, y)

    def motion(self, x, y):
        self.pointer(2, x, y)

    def wheel(self, x, y, direction):
        self.pointer(3, x, y, direction)

    def dial(self, chn=0):
        return self.lib.prt_xui_test_dial(self.h, chn)

    def port_event(self, port, fmt, raw):
        buf = ctypes.create_string_buffer(raw, len(raw))
        self.desc.port_event(self.h, port, len(raw), fmt,
                             ctypes.cast(buf, ctypes.c_void_p))

    def send_levels(self, chn, **fields):
        """Deliver a 'levels' notify atom like a host port_event."""
        body = struct.pack("<II", 0, self.urid.map(PROT_NS + "levels"))
        body += _prop(self.urid, PROT_NS + "l_channel",
                      ATOM_NS + "Int", struct.pack("<i", chn))
        for name in ("in_cur", "in_mom", "in_peak", "out_cur", "out_mom",
                     "out_peak", "diff_cur", "diff_min", "diff_max"):
            val = fields.get(name, 0.0)
            body += _prop(self.urid, PROT_NS + "l_" + name,
                          ATOM_NS + "Float", struct.pack("<f", val))
        atom = struct.pack("<II", len(body),
                           self.urid.map(ATOM_NS + "Object")) + body
        self.port_event(1, self.urid.map(ATOM_NS + "eventTransfer"),
                        atom)

    def close(self):
        self.desc.cleanup(self.h)
        self.h = None


def _prop(urid, key_uri, type_uri, val):
    pb = struct.pack("<IIII", urid.map(key_uri), 0, len(val),
                     urid.map(type_uri)) + val
    return pb + b"\x00" * ((8 - len(pb) % 8) % 8)


@pytest.fixture
def xui(native_built):
    host = _XuiHost(native_built)
    yield host
    if host.h:
        host.close()


@pytest.fixture
def xui2(native_built):
    host = _XuiHost(native_built, stereo=True)
    yield host
    if host.h:
        host.close()


def test_headless_and_framebuffer_geometry(xui):
    assert xui.lib.prt_xui_test_headless(xui.h) == 1
    fb = xui.framebuffer()
    assert fb.shape == (ROW_H, WIN_W)
    # the dial face was rendered at instantiate (panel-gray disc)
    assert fb[DIAL_CY, DIAL_CX] == 0xFF1C1C1C


def test_ui_on_off_handshake(xui):
    """ui_on at instantiate, ui_off at cleanup — the reference UI's
    enable/disable handshake (gui/phaserotate.c:1099-1127)."""
    assert len(xui.writes) == 1
    port, proto, raw = xui.writes[0]
    assert port == 0
    assert proto == xui.urid.map(ATOM_NS + "eventTransfer")
    otype, _ = _parse_atom_object(xui.urid, raw)
    assert otype == PROT_NS + "ui_on"
    xui.close()
    otype, _ = _parse_atom_object(xui.urid, xui.writes[-1][2])
    assert otype == PROT_NS + "ui_off"


def test_wheel_scroll_steps_by_five_degrees(xui):
    """Scroll = step 0.5 x multiplier 10 (gui/widgets.py DialModel;
    robtk dial scroll, gui/phaserotate.c:924-947)."""
    xui.writes.clear()
    xui.wheel(DIAL_CX, DIAL_CY, +1)
    assert xui.dial(0) == 5.0
    port, proto, raw = xui.writes[-1]
    assert (port, proto) == (3, 0)
    assert struct.unpack("<f", raw)[0] == 5.0
    xui.wheel(DIAL_CX, DIAL_CY, -1)
    xui.wheel(DIAL_CX, DIAL_CY, -1)
    assert xui.dial(0) == -5.0


def test_drag_sets_angle_with_detent(xui):
    """Vertical drag moves 0.5 degree/px; values within one step of 0
    snap to the detent (gui/widgets.py DialModel.set_value)."""
    xui.writes.clear()
    xui.press(DIAL_CX, DIAL_CY)
    xui.motion(DIAL_CX, DIAL_CY - 40)  # 40 px up -> +20 deg
    assert xui.dial(0) == 20.0
    xui.motion(DIAL_CX, DIAL_CY - 40)  # back to +20
    xui.motion(DIAL_CX, DIAL_CY)  # back to 0
    assert xui.dial(0) == 0.0
    xui.release(DIAL_CX, DIAL_CY)
    # detent: a fractional value within one step of 0 snaps to it,
    # larger fractions quantize to the 0.5-degree grid
    xui.port_event(3, 0, struct.pack("<f", 0.3))
    assert xui.dial(0) == 0.0
    xui.port_event(3, 0, struct.pack("<f", 0.6))
    assert xui.dial(0) == 0.5
    # motion after release must not drag
    xui.motion(DIAL_CX, DIAL_CY - 100)
    assert xui.dial(0) == 0.5


def test_dial_wraps_360(xui):
    """Past +180 wraps to negative (threesixty mode)."""
    xui.press(DIAL_CX, DIAL_CY)
    xui.motion(DIAL_CX, DIAL_CY - 370)  # +185 -> wraps to -175
    assert xui.dial(0) == -175.0
    xui.release(DIAL_CX, DIAL_CY)


def test_levels_atom_lights_meter_pixels(xui):
    """A 'levels' notify atom renders into the gradient bar: lit pixels
    up to the deflection point, peak-hold marker, delta bar."""
    xui.send_levels(0, in_cur=1.0, in_mom=1.0, in_peak=1.9,
                    out_cur=0.5, out_mom=0.5, out_peak=0.5,
                    diff_cur=2.0, diff_min=0.5, diff_max=2.0)
    xui.idle()
    fb = xui.framebuffer()
    in_row = fb[METER_Y_IN + METER_H // 2]
    # 1.0 = 0 dBFS deflects to 80/86 of the bar; green zone near start,
    # red zone near the lit end
    lit_end = int(METER_W * 80 / 86)
    assert in_row[METER_X + 4] == GREEN
    assert in_row[METER_X + lit_end - 4] == RED
    assert in_row[METER_X + lit_end + 20] == 0xFF222222  # unlit
    # peak-hold marker at 1.9 (~+5.6 dBFS)
    hold_x = METER_X + int(METER_W * (20 * np.log10(1.9) + 80) / 86)
    assert 0xFFFF4444 in fb[METER_Y_IN, hold_x - 1 : hold_x + 2]
    # delta bar: +6 dB fills from center to 3/4
    d_row = fb[METER_Y_DELTA + METER_H // 2]
    assert d_row[METER_X + METER_W // 2 + 10] == DELTA_BLUE
    assert d_row[METER_X + 10] == 0xFF222222


def test_meter_click_sends_reset_peaks(xui):
    """Click on a meter -> reset_peaks atom (gui/phaserotate.c:876-890)."""
    xui.writes.clear()
    xui.press(METER_X + 50, METER_Y_IN + 5)
    assert len(xui.writes) == 1
    port, proto, raw = xui.writes[0]
    assert port == 0 and proto == xui.urid.map(ATOM_NS + "eventTransfer")
    otype, _ = _parse_atom_object(xui.urid, raw)
    assert otype == PROT_NS + "reset_peaks"


def test_angle_port_event_moves_dial_display(xui):
    """Host echoes the angle port -> dial display follows, and the UI
    does NOT write the port back (no feedback loop)."""
    xui.writes.clear()
    xui.port_event(3, 0, struct.pack("<f", 42.5))
    assert xui.dial(0) == 42.5
    assert xui.writes == []
    xui.idle()
    fb = xui.framebuffer()
    # pointer line rotated off vertical: a pointer pixel right of center
    ang = np.deg2rad(42.5 - 90.0)
    px = DIAL_CX + int(30 * np.cos(ang))
    py = DIAL_CY + int(30 * np.sin(ang))
    assert fb[py, px] == 0xFFE0E0E0


def test_link_mirrors_and_freezes_dial1(xui2):
    """LINK: dial 1 follows dial 0 and goes insensitive
    (gui/widgets.py LinkGroup; gui/phaserotate.c:846-874)."""
    link_y = 2 * ROW_H + 5 + 8
    xui2.wheel(DIAL_CX, DIAL_CY, +1)  # dial0 = 5
    xui2.writes.clear()
    xui2.press(DIAL_CX, link_y)  # toggle LINK on
    assert xui2.dial(1) == 5.0
    ports = [w[0] for w in xui2.writes]
    assert 6 in ports  # angle_R write (port 3+3*1)
    # the state atom persisted link=1 (gui/phaserotate.c:1129-1134)
    atom_writes = [w for w in xui2.writes if w[0] == 0]
    otype, props = _parse_atom_object(xui2.urid, atom_writes[-1][2])
    assert otype == PROT_NS + "state"
    assert struct.unpack("<i", props[PROT_NS + "link"][1])[0] == 1
    # dial1 is insensitive while linked
    xui2.wheel(DIAL_CX, ROW_H + DIAL_CY, +1)
    assert xui2.dial(1) == 5.0
    # dial0 moves -> dial1 mirrors
    xui2.wheel(DIAL_CX, DIAL_CY, +1)
    assert xui2.dial(0) == 10.0 and xui2.dial(1) == 10.0
    # link indicator rendered active
    xui2.idle()
    fb = xui2.framebuffer()
    assert fb[2 * ROW_H + 5 + 8, DIAL_CX] == LINK_ON
    # toggle off -> dial1 sensitive again
    xui2.press(DIAL_CX, link_y)
    xui2.wheel(DIAL_CX, ROW_H + DIAL_CY, -1)
    assert xui2.dial(1) == 5.0


def test_state_atom_updates_link_display(xui2):
    """A 'state' notify atom (DSP echo) updates the LINK display
    without writing back (gui/phaserotate.c:1259-1271 role)."""
    body = struct.pack("<II", 0, xui2.urid.map(PROT_NS + "state"))
    body += _prop(xui2.urid, PROT_NS + "uiscale", ATOM_NS + "Float",
                  struct.pack("<f", 1.5))
    body += _prop(xui2.urid, PROT_NS + "link", ATOM_NS + "Bool",
                  struct.pack("<i", 1))
    atom = struct.pack("<II", len(body),
                       xui2.urid.map(ATOM_NS + "Object")) + body
    xui2.writes.clear()
    xui2.port_event(1, xui2.urid.map(ATOM_NS + "eventTransfer"), atom)
    assert xui2.writes == []  # display-only: no echo loop
    xui2.idle()
    fb = xui2.framebuffer()
    assert fb[2 * ROW_H + 5 + 8, DIAL_CX] == LINK_ON
    # linked display freezes dial 1 input
    xui2.wheel(DIAL_CX, ROW_H + DIAL_CY, +1)
    assert xui2.dial(1) == 0.0


# ---------------------------------------------------------------------------
# Full stack: plugin shim + X11 UI wired together, like a DAW session
# ---------------------------------------------------------------------------


def test_full_stack_ui_plugin_daemon(native_built, monkeypatch, rng):
    """One host process wires prt_xui.so to phaserotate_tpu.so over the
    real atom ports and streams audio through the daemon — the complete
    reference workflow (DSP src/phaserotate.c + GUI gui/phaserotate.c)
    re-assembled across the engine's process split.  The UI's dial drives the
    rotation; the DSP's levels stream lights the UI's meters."""
    import subprocess
    import sys as _sys

    from test_bridge import REPO, _Lv2Host

    sock = os.path.join(str(_tmp := __import__("tempfile").mkdtemp(
        prefix="prtxuistack")), "engine.sock")
    r, w = os.pipe()
    proc = subprocess.Popen(
        [_sys.executable, "-m", "phaserotate_tpu.bridge", "--socket",
         sock, "--ready-fd", str(w)],
        pass_fds=(w,), cwd=REPO, stderr=subprocess.DEVNULL)
    os.close(w)
    assert os.read(r, 1) == b"R"
    os.close(r)
    monkeypatch.setenv("PHASEROTATE_TPU_SOCKET", sock)
    try:
        plug = _Lv2Host(native_built, 0, 48000, 512, atoms=True)
        ui = _XuiHost(native_built)
        # the host routes UI writes into the plugin's ports
        pending_atoms = []

        def pump_ui_writes():
            for port, proto, raw in ui.writes:
                if port == 0 and proto == ui.urid.map(
                        ATOM_NS + "eventTransfer"):
                    pending_atoms.append(raw)
                elif port >= 3 and proto == 0:
                    chn = (port - 3) // 3
                    plug.angle[chn][0] = struct.unpack("<f", raw)[0]
            ui.writes.clear()

        def host_run(x):
            pump_ui_writes()
            # wrap pending UI atoms into the control sequence; both
            # sides were built against the host's shared urid map, so
            # the ids line up only if they share one map — use the
            # plugin host's map for the UI-originated object bodies
            objs = []
            for raw in pending_atoms:
                _size, typ = struct.unpack_from("<II", raw, 0)
                assert ui.urid.by_id[typ] == ATOM_NS + "Object"
                objs.append(_remap_object(ui.urid, plug.urid, raw))
            pending_atoms.clear()
            plug.set_control(objs)
            y = plug.run(x, float(plug.angle[0][0]))
            # forward the whole notify sequence to the UI (remapped)
            seq = _remap_sequence(plug.urid, ui.urid,
                                  bytes(plug.notify_buf.tobytes()))
            ui.port_event(1, ui.urid.map(ATOM_NS + "eventTransfer"),
                          seq)
            return y

        # the ui_on sent at UI instantiate reaches the DSP via the host;
        # the input meter is latency-aligned (delay line of 1792 frames
        # @48k, src/phaserotate.c:575-609), so stream past the latency
        # before expecting deflection
        x = (0.5 * rng.standard_normal((1, 512))).astype(np.float32)
        for _ in range(8):
            host_run(x)
        ui.idle()
        fb = ui.framebuffer()
        in_row = fb[METER_Y_IN + METER_H // 2]
        lit = int((in_row[METER_X : METER_X + METER_W]
                   != 0xFF222222).sum())
        assert lit > 20  # real audio lit the input meter

        # turn the dial in the UI -> plugin rotates
        ui.wheel(DIAL_CX, DIAL_CY, +1)  # +5 deg... scroll to 90
        for _ in range(17):
            ui.wheel(DIAL_CX, DIAL_CY, +1)
        assert ui.dial(0) == 90.0
        n = 8192
        sig = (0.5 * rng.standard_normal(n)).astype(np.float32)
        total = np.concatenate([sig, np.zeros(2048, np.float32)])
        outs = [host_run(total[None, i : i + 512])
                for i in range(0, len(total), 512)]
        lat = int(plug.latency[0])
        y = np.concatenate(outs, axis=1)[0]
        from phaserotate_tpu.ops import rotate_fir

        want = np.asarray(rotate_fir(sig, 90.0, rate=48000))
        sl = slice(4096, n - 1)
        np.testing.assert_allclose(y[lat:][sl], want[sl], atol=1e-4)
        ui.close()
        plug.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _remap_object(src_map, dst_map, raw):
    """Re-intern one Object atom's ids from one urid map into another
    (what a real host does implicitly by sharing a single map)."""
    size, _typ = struct.unpack_from("<II", raw, 0)
    _oid, otype = struct.unpack_from("<II", raw, 8)
    body = struct.pack("<II", 0, dst_map.map(src_map.by_id[otype]))
    off, end = 16, 8 + size
    while off + 16 <= end:
        key, _ctx, vsize, vtype = struct.unpack_from("<IIII", raw, off)
        body += _prop(dst_map, src_map.by_id[key],
                      src_map.by_id[vtype],
                      raw[off + 16 : off + 16 + vsize])
        off += (16 + vsize + 7) & ~7
    return body


def _remap_sequence(src_map, dst_map, raw):
    """Re-intern a notify Sequence's atoms into the UI's urid map."""
    size, typ = struct.unpack_from("<II", raw, 0)
    assert src_map.by_id[typ] == ATOM_NS + "Sequence"
    out_events = []
    off, end = 16, 8 + size
    while off + 16 <= end:
        _frames, bsize, btype = struct.unpack_from("<qII", raw, off)
        if src_map.by_id.get(btype) == ATOM_NS + "Object":
            body = _remap_object(
                src_map, dst_map,
                struct.pack("<II", bsize, btype)
                + raw[off + 16 : off + 16 + bsize])
            ev = struct.pack("<qII", 0, len(body),
                             dst_map.map(ATOM_NS + "Object")) + body
            out_events.append(ev + b"\x00" * ((8 - len(ev) % 8) % 8))
        off += (16 + bsize + 7) & ~7
    seq_body = struct.pack("<II", 0, 0) + b"".join(out_events)
    return struct.pack("<II", len(seq_body),
                       dst_map.map(ATOM_NS + "Sequence")) + seq_body


def test_ui_resize_feature_reports_size(native_built):
    """A host providing ui:resize learns the UI's surface size at
    instantiate (the embedding contract DAWs rely on)."""
    os.environ["PHASEROTATE_TPU_XUI"] = "headless"
    lib = ctypes.CDLL(os.path.join(native_built, "prt_xui.so"))
    lib.lv2ui_descriptor.restype = ctypes.POINTER(_LV2UIDescriptor)
    lib.lv2ui_descriptor.argtypes = [ctypes.c_uint32]
    desc = lib.lv2ui_descriptor(0).contents
    urid = _UridMap()
    got = []
    RESIZE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int)

    def _resize(_h, w, h):
        got.append((w, h))
        return 0

    resize_cb = RESIZE_FN(_resize)

    class _Resize(ctypes.Structure):
        _fields_ = [("handle", ctypes.c_void_p), ("ui_resize", RESIZE_FN)]

    rz = _Resize(None, resize_cb)
    feats = [
        _LV2Feature(b"http://lv2plug.in/ns/ext/urid#map",
                    ctypes.cast(ctypes.byref(urid.struct),
                                ctypes.c_void_p)),
        _LV2Feature(b"http://lv2plug.in/ns/extensions/ui#resize",
                    ctypes.cast(ctypes.byref(rz), ctypes.c_void_p)),
    ]
    arr = (ctypes.POINTER(_LV2Feature) * 3)(
        ctypes.pointer(feats[0]), ctypes.pointer(feats[1]), None)
    write_cb = _WRITE_FN(lambda *_: None)
    widget = ctypes.c_void_p()
    h = desc.instantiate(
        ctypes.byref(desc), b"urn:phaserotate-tpu:plugin#stereo",
        b"/tmp", write_cb, None, ctypes.byref(widget),
        ctypes.cast(arr, ctypes.c_void_p))
    assert h
    assert got == [(WIN_W, 2 * ROW_H + LINK_ROW_H)]
    desc.cleanup(h)


def test_port_event_fuzz_no_crash(native_built):
    """Random garbage on the notify port must never crash the UI —
    a malformed atom crashing an embedded LV2UI takes the DAW with it.
    Runs in a subprocess so a segfault fails the test, not pytest."""
    import subprocess
    import sys as _sys
    import textwrap

    code = textwrap.dedent("""
        import ctypes, os, sys
        sys.path.insert(0, %r)
        sys.path.insert(0, os.path.dirname(%r))  # repo root
        os.environ["PHASEROTATE_TPU_XUI"] = "headless"
        from test_xui import _XuiHost, ATOM_NS
        import numpy as np
        host = _XuiHost(%r, stereo=True)
        rng = np.random.default_rng(0)
        ev = host.urid.map(ATOM_NS + "eventTransfer")
        seq_id = host.urid.map(ATOM_NS + "Sequence")
        obj_id = host.urid.map(ATOM_NS + "Object")
        import struct
        for trial in range(400):
            n = int(rng.integers(0, 96))
            raw = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            if n >= 8 and trial %% 3 == 0:
                # plausible header, garbage body: the dangerous case
                typ = (seq_id, obj_id)[trial %% 2]
                raw = struct.pack("<II", int(rng.integers(0, 2**16)),
                                  typ) + raw[8:]
            host.port_event(1, ev, raw)
            host.port_event(3, 0, raw[:4] if n >= 4 else raw)
        # deterministic hostile control values: non-finite must be
        # ignored, huge finite must wrap in O(1) (not spin ~1e35 loop
        # iterations), boundary wrap must stay on the iterative grid
        for v in (float("nan"), float("inf"), float("-inf"),
                  3.4e38, -3.4e38, 1e18, 540.0, -540.0):
            host.port_event(3, 0, struct.pack("<f", v))
            host.port_event(6, 0, struct.pack("<f", v))
        host.idle()
        host.close()
        print("FUZZ-OK")
    """) % (os.path.dirname(os.path.abspath(__file__)),
            os.path.dirname(os.path.abspath(__file__)), native_built)
    res = subprocess.run([_sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "FUZZ-OK" in res.stdout
