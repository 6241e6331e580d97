"""Browser GUI: live state, dial writes, link/reset semantics, the
daemon-served surface, and the LV2UI launcher binary.

The web page is the framework's peer of the reference's embedded GUI
(gui/phaserotate.c:833-890, 1236-1309); these tests drive it through
real HTTP against a live plugin host and against the engine daemon."""

import ctypes
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from phaserotate_tpu.bridge import BridgeClient
from phaserotate_tpu.gui.web import HostSurface, WebUI
from phaserotate_tpu.hostapp import StandaloneHost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _post(url, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


@pytest.fixture()
def webhost():
    host = StandaloneHost(48000, 2, block=512)
    surface = HostSurface(host)
    ui = WebUI(lambda: {"0": surface}, port=0).start()
    yield host, ui
    ui.stop()


def test_page_and_state(webhost, rng):
    host, ui = webhost
    page = _get(ui.url).decode()
    assert "Phase Rotate (GPU)" in page and "/state" in page

    x = (0.5 * rng.standard_normal((2, 512))).astype(np.float32)
    for _ in range(12):
        host.process(x)
    state = json.loads(_get(ui.url + "state"))
    s = state["sessions"]["0"]
    assert s["channels"] == 2 and s["rate"] == 48000
    # live meters: the input peak must reflect the signal we pushed
    assert s["meters"][0]["in_peak"] == pytest.approx(
        float(np.abs(x[0]).max()), abs=1e-5)
    # rendered SVG widgets ride along for the page
    assert all(svg.startswith("<svg") for svg in s["dial_svg"])
    assert all("<svg" in svg for svg in s["meter_svg"])


def test_dial_write_reaches_plugin(webhost, rng):
    host, ui = webhost
    _post(ui.url + "control",
          {"action": "dial", "session": "0", "channel": 0, "value": 35.2})
    # dial quantizes to 0.5-degree steps (gui/widgets.py DialModel)
    assert float(host.angles[0][0]) == 35.0
    state = json.loads(_get(ui.url + "state"))
    assert state["sessions"]["0"]["angles"][0] == 35.0
    # and the engine actually rotates with it
    x = (0.5 * rng.standard_normal((2, 512))).astype(np.float32)
    outs = [host.process(x) for _ in range(16)]
    assert not np.allclose(np.concatenate(outs, axis=1)[0, 2048:], 0.0)


def test_scroll_and_double_click(webhost):
    host, ui = webhost
    _post(ui.url + "control",
          {"action": "scroll", "session": "0", "channel": 1, "steps": 2})
    # wheel: step 0.5 * scroll_mult 10 per notch (gui/phaserotate.c dial)
    assert float(host.angles[1][0]) == 10.0
    _post(ui.url + "control",
          {"action": "dial", "session": "0", "channel": 1, "value": 0})
    assert float(host.angles[1][0]) == 0.0


def test_link_mirrors_dials(webhost):
    host, ui = webhost
    _post(ui.url + "control",
          {"action": "link", "session": "0", "active": True})
    _post(ui.url + "control",
          {"action": "dial", "session": "0", "channel": 0, "value": -42.0})
    assert float(host.angles[0][0]) == -42.0
    assert float(host.angles[1][0]) == -42.0  # mirrored while linked
    state = json.loads(_get(ui.url + "state"))
    assert state["sessions"]["0"]["link"] is True


def test_meter_click_resets_peaks(webhost, rng):
    host, ui = webhost
    x = (0.5 * rng.standard_normal((2, 512))).astype(np.float32)
    for _ in range(8):
        host.process(x)
    state = json.loads(_get(ui.url + "state"))
    assert state["sessions"]["0"]["meters"][0]["in_peak"] > 0.1
    _post(ui.url + "control", {"action": "reset", "session": "0"})
    # the input meter reads a latency-aligned delay line
    # (src/phaserotate.c:575-609): flush past it before checking, then
    # reset again so the rebuilt peak of the residual signal clears too
    for _ in range(8):
        host.process(np.zeros((2, 512), np.float32))
    _post(ui.url + "control", {"action": "reset", "session": "0"})
    host.process(np.zeros((2, 512), np.float32))
    state = json.loads(_get(ui.url + "state"))
    assert state["sessions"]["0"]["meters"][0]["in_peak"] < 0.1


def test_bad_requests_rejected(webhost):
    _, ui = webhost
    for body in ({"action": "dial", "session": "9", "channel": 0,
                  "value": 1},
                 {"action": "nope", "session": "0"},
                 {"action": "dial", "session": "0"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(ui.url + "control", body)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(ui.url + "nothere")
    assert e.value.code == 404


# ---- daemon-served surface ------------------------------------------------


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ui_daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("bridgeui") / "engine.sock")
    port = _free_port()
    r, w = os.pipe()
    proc = subprocess.Popen(
        [sys.executable, "-m", "phaserotate_tpu.bridge",
         "--socket", sock, "--ready-fd", str(w),
         "--ui-port", str(port)],
        pass_fds=(w,), cwd=REPO, stderr=subprocess.DEVNULL)
    os.close(w)
    assert os.read(r, 1) == b"R", "daemon failed to start"
    os.close(r)
    yield sock, f"http://127.0.0.1:{port}/"
    proc.terminate()
    proc.wait(timeout=10)


def test_daemon_ui_lists_live_sessions(ui_daemon, rng):
    sock, url = ui_daemon
    assert json.loads(_get(url + "state"))["sessions"] == {}

    cl = BridgeClient(sock, 48000, 1)
    x = (0.5 * rng.standard_normal((1, 2048))).astype(np.float32)
    for _ in range(4):
        cl.process(x, 12.0)
    state = json.loads(_get(url + "state"))
    (sid, s), = state["sessions"].items()
    assert s["channels"] == 1 and s["rate"] == 48000
    assert s["angles"][0] == 12.0  # dial mirrors the client's angle
    assert s["meters"][0]["in_peak"] > 0.1  # live levels
    cl.close()
    import time

    for _ in range(50):  # session unregisters when the client leaves
        if not json.loads(_get(url + "state"))["sessions"]:
            break
        time.sleep(0.1)
    assert json.loads(_get(url + "state"))["sessions"] == {}


def test_daemon_ui_dial_overrides_until_client_moves(ui_daemon, rng):
    sock, url = ui_daemon
    cl = BridgeClient(sock, 48000, 1)
    x = (0.5 * rng.standard_normal((1, 2048))).astype(np.float32)
    cl.process(x, 0.0)
    (sid,) = json.loads(_get(url + "state"))["sessions"].keys()

    # browser dial write: subsequent blocks rotate at 90 even though the
    # client keeps sending 0 (ui->write equivalent across the daemon)
    _post(url + "control",
          {"action": "dial", "session": sid, "channel": 0, "value": 90.0})
    for _ in range(8):  # ramp to the override target
        out_over = cl.process(x, 0.0)
    assert not np.allclose(out_over, cl.process(np.zeros_like(x), 0.0)[0, 0])
    state = json.loads(_get(url + "state"))
    assert state["sessions"][sid]["angles"][0] == 90.0

    # the client moving its own angle takes the dial back
    for _ in range(8):
        cl.process(x, 30.0)
    state = json.loads(_get(url + "state"))
    assert state["sessions"][sid]["angles"][0] == 30.0
    cl.close()


# ---- LV2UI launcher binary ------------------------------------------------


@pytest.fixture(scope="module")
def ui_so():
    subprocess.run(["make", "-C", NATIVE, "prt_ui.so"], check=True,
                   capture_output=True, timeout=120)
    return os.path.join(NATIVE, "prt_ui.so")


def test_prt_ui_descriptor_and_show(ui_so, monkeypatch):
    monkeypatch.setenv("PHASEROTATE_TPU_UI_NO_OPEN", "1")

    class Desc(ctypes.Structure):
        _fields_ = [
            ("URI", ctypes.c_char_p),
            ("instantiate", ctypes.c_void_p),
            ("cleanup", ctypes.c_void_p),
            ("port_event", ctypes.c_void_p),
            ("extension_data", ctypes.c_void_p),
        ]

    lib = ctypes.CDLL(ui_so)
    lib.lv2ui_descriptor.restype = ctypes.POINTER(Desc)
    assert not lib.lv2ui_descriptor(1)
    d = lib.lv2ui_descriptor(0).contents
    assert d.URI == b"urn:phaserotate-tpu:plugin#web_ui"

    inst = ctypes.CFUNCTYPE(
        ctypes.c_void_p, ctypes.POINTER(Desc), ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p)(d.instantiate)
    widget = ctypes.c_void_p(0xdead)
    h = inst(lib.lv2ui_descriptor(0), b"urn:phaserotate-tpu:plugin",
             b"/tmp", None, None, ctypes.byref(widget), None)
    assert h and widget.value is None  # no embedded widget: browser UI

    ext = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p)(
        d.extension_data)
    show_iface = ext(b"http://lv2plug.in/ns/extensions/ui#showInterface")
    assert show_iface
    assert ext(b"http://lv2plug.in/ns/extensions/ui#idleInterface")
    assert not ext(b"urn:unknown")

    class ShowIface(ctypes.Structure):
        _fields_ = [("show", ctypes.c_void_p), ("hide", ctypes.c_void_p)]

    si = ctypes.cast(show_iface, ctypes.POINTER(ShowIface)).contents
    show = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)(si.show)
    hide = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)(si.hide)
    assert show(h) == 0 and hide(h) == 0 and show(h) == 0

    cleanup = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(d.cleanup)
    cleanup(h)


def test_bundle_ships_ui(tmp_path):
    from phaserotate_tpu.plugin.ttl import manifest_ttl, write_bundle

    man = manifest_ttl()
    # both UIs declared, embedded X11 one first so hosts prefer it
    assert ("ui:ui <urn:phaserotate-tpu:plugin#x11_ui> , "
            "<urn:phaserotate-tpu:plugin#web_ui>") in man
    assert "ui:binary <prt_ui.so>" in man
    assert "ui:binary <prt_xui.so>" in man
    assert "a ui:X11UI" in man
    d = tmp_path / "bundle.lv2"
    write_bundle(str(d))
    assert (d / "prt_ui.so").exists()
    assert (d / "prt_xui.so").exists()
    assert (d / "phaserotate_tpu.so").exists()
    assert "web_ui" in (d / "manifest.ttl").read_text()


def test_out_of_range_channel_rejected(webhost):
    """A channel index past the session's dials must return 400, not
    drop the connection."""
    _, ui = webhost
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(ui.url + "control",
              {"action": "dial", "session": "0", "channel": 5,
               "value": 1.0})
    assert e.value.code == 400


@pytest.fixture(scope="module")
def daemon_meters_ui(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("bridgemui") / "engine.sock")
    port = _free_port()
    r, w = os.pipe()
    proc = subprocess.Popen(
        [sys.executable, "-m", "phaserotate_tpu.bridge",
         "--socket", sock, "--ready-fd", str(w), "--meters",
         "--ui-port", str(port)],
        pass_fds=(w,), cwd=REPO, stderr=subprocess.DEVNULL)
    os.close(w)
    assert os.read(r, 1) == b"R", "daemon failed to start"
    os.close(r)
    yield sock, f"http://127.0.0.1:{port}/"
    proc.terminate()
    proc.wait(timeout=10)


def test_meters_and_ui_both_receive_levels(daemon_meters_ui, rng):
    """--meters and --ui-port together: the socket client gets T_LEVELS
    AND the browser state shows live meters (the notify queue must feed
    both consumers)."""
    sock, url = daemon_meters_ui
    cl = BridgeClient(sock, 48000, 1)
    x = (0.5 * rng.standard_normal((1, 2048))).astype(np.float32)
    for _ in range(4):
        cl.process(x, 10.0)
    assert cl.levels, "socket client lost its meter stream"
    state = json.loads(_get(url + "state"))
    (_, s), = state["sessions"].items()
    assert s["meters"][0]["in_peak"] > 0.1, "web UI lost the meters"
    cl.close()


@pytest.fixture(scope="module")
def pool_daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("bridgepool") / "engine.sock")
    port = _free_port()
    r, w = os.pipe()
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-m", "phaserotate_tpu.bridge",
         "--socket", sock, "--ready-fd", str(w),
         "--devices", "2", "--ui-port", str(port)],
        pass_fds=(w,), cwd=REPO, env=env, stderr=subprocess.DEVNULL)
    os.close(w)
    assert os.read(r, 1) == b"R", "daemon failed to start"
    os.close(r)
    yield sock, f"http://127.0.0.1:{port}/"
    proc.terminate()
    proc.wait(timeout=10)


def test_device_pool_spreads_sessions(pool_daemon, rng):
    """--devices 2: concurrent sessions land on different accelerators
    (round-robin; each device single-owner behind its own lock) and
    both stream correct audio."""
    sock, url = pool_daemon
    cls = [BridgeClient(sock, 48000, 1) for _ in range(2)]
    x = (0.5 * rng.standard_normal((1, 2048))).astype(np.float32)
    outs = [[], []]
    for _ in range(4):
        for i, cl in enumerate(cls):
            outs[i].append(cl.process(x, [20.0, -50.0][i]))
    state = json.loads(_get(url + "state"))
    devices = sorted(s["device"] for s in state["sessions"].values())
    assert devices == [0, 1]
    # both outputs are real (post-latency signal present) and distinct
    y0 = np.concatenate(outs[0], axis=1)[0]
    y1 = np.concatenate(outs[1], axis=1)[0]
    assert np.abs(y0[4096:]).max() > 0.01
    assert np.abs(y1[4096:]).max() > 0.01
    assert not np.allclose(y0[4096:], y1[4096:])
    for cl in cls:
        cl.close()


def test_hostapp_web_flag_end_to_end(tmp_path, rng):
    """phase-rotate-host --web PORT: the CLI mount serves the live
    surface while the file processes."""
    import re
    import time as _time

    from phaserotate_tpu.io import write_wav

    rate = 48000
    # long enough that --realtime pacing keeps serving while the test
    # polls (startup costs several seconds before the server binds)
    x = (0.3 * rng.standard_normal(30 * rate)).astype(np.float32)
    src = str(tmp_path / "in.wav")
    write_wav(src, x, rate)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "phaserotate_tpu.hostapp", src,
         str(tmp_path / "out.wav"), "-a", "25", "--web", str(port),
         "--realtime"],
        cwd=REPO, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    url = f"http://127.0.0.1:{port}/"
    try:
        state = None
        deadline = _time.time() + 60
        while _time.time() < deadline:
            try:
                state = json.loads(_get(url + "state"))
                break
            except OSError:
                _time.sleep(0.1)
        assert state is not None, "web UI never came up"
        s = state["sessions"]["0"]
        assert s["rate"] == rate
        assert s["angles"][0] == 25.0  # dial mirrors the -a port value
        # live dial write reaches the in-flight processing loop
        _post(url + "control", {"action": "dial", "session": "0",
                                "channel": 0, "value": 90.0})
        state = json.loads(_get(url + "state"))
        assert state["sessions"]["0"]["angles"][0] == 90.0
    finally:
        out, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err
    assert re.search(r"web UI: http://127\.0\.0\.1:\d+/", err)
    assert (tmp_path / "out.wav").exists()


def test_control_endpoint_hostile_inputs(webhost):
    """The /control endpoint is an HTTP surface: hostile JSON must get
    4xx (or be safely ignored), never crash the server thread, hang,
    or poison the dial/scale state."""
    import urllib.error

    host, ui = webhost

    def post_raw(body: bytes, headers=None):
        req = urllib.request.Request(ui.url + "control", data=body,
                                     method="POST",
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    # malformed/hostile messages -> 400, server stays up
    bad = [
        b"not json at all",
        b"{}",
        b'{"action": "dial"}',
        b'{"action": "nope", "session": "0"}',
        b'{"action": "dial", "session": "missing", "channel": 0, '
        b'"value": 1}',
        b'{"action": "dial", "session": "0", "channel": 99, "value": 1}',
        b'{"action": "dial", "session": "0", "channel": "x", "value": 1}',
        b'{"action": "scroll", "session": "0", "channel": 0, '
        b'"steps": "y"}',
        b'{"action": "scale", "session": "0", "value": "z"}',
    ]
    for body in bad:
        assert post_raw(body) == 400, body

    # hostile but parseable values: ignored or wrapped, state stays sane
    _post(ui.url + "control", {"action": "dial", "session": "0",
                               "channel": 0, "value": 35.0})
    for v in ("NaN", "Infinity", "-Infinity", "1e308"):
        code = post_raw(
            f'{{"action": "dial", "session": "0", "channel": 0, '
            f'"value": {v}}}'.encode())
        assert code == 200
    s = json.loads(_get(ui.url + "state"))["sessions"]["0"]
    assert -180.0 <= s["angles"][0] <= 180.0
    for v in ("NaN", "1e308"):
        post_raw(f'{{"action": "scale", "session": "0", '
                 f'"value": {v}}}'.encode())
    assert 1.0 <= host.plugin.ui_scale <= 2.0

    # hostile Content-Length must be rejected without a giant read
    assert post_raw(b'{"action": "reset", "session": "0"}',
                    {"Content-Length": str(1 << 31)}) == 400
    # server still serves after everything above
    assert _post(ui.url + "control",
                 {"action": "reset", "session": "0"})["ok"] is True
