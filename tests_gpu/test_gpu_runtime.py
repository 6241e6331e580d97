"""On-card runtime coverage: every plugin geometry through the compiled
stream path, pipelined parity, a daemon session over the socket,
cross-session batching, the sharded-API path, raw-PCM ingest,
checkpoint/resume, the angle ramp, Ogg ingest and metering — all on the
GPU backend.

One process owns the card (a JAX process reserves most of its memory),
so the daemon here runs in-process on a thread rather than as a
subprocess.
"""

import os
import threading

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the sweep as compiled for the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,lead,angles", [
    (30001, (3,), slice(None)), (4096, (2, 2), slice(90, 180))])
def test_sweep_kernel_compiled_matches_reference(rng, n, lead, angles):
    """The compiled Triton kernel (no interpret mode) against the plain
    reference, within 2 ulp (fused vs separate multiply-add)."""
    from phaserotate_tpu.core.angles import all_angle_cos_sin
    from phaserotate_tpu.kernels import rotate_peak_sweep_kernel
    from phaserotate_tpu.ops.peak import rotated_peak_sweep

    b0 = rng.standard_normal((*lead, n)).astype(np.float32)
    b1 = rng.standard_normal((*lead, n)).astype(np.float32)
    cs = np.asarray(all_angle_cos_sin())[:, angles]
    got = np.asarray(rotate_peak_sweep_kernel(b0, b1, cs))
    want = np.stack([np.asarray(rotated_peak_sweep(a, b, cs))
                     for a, b in zip(b0.reshape(-1, n), b1.reshape(-1, n))])
    want = want.reshape(*lead, cs.shape[-1])
    np.testing.assert_array_less(np.abs(got - want),
                                 2.5 * np.spacing(want))


# ---------------------------------------------------------------------------
# every plugin geometry through the compiled stream engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [44100, 96000, 192000])
def test_stream_geometry_parity_on_gpu(rng, rate):
    """Each of the three rate-adaptive geometries
    (src/phaserotate.c:278-297) streams on the card and matches the offline
    FIR path after latency trim."""
    from phaserotate_tpu.ops import rotate_fir
    from phaserotate_tpu.stream import StreamingRotator

    rot = StreamingRotator(rate=rate, channels=1)
    n = 6 * rot.geom.parsiz
    x = (0.5 * rng.standard_normal(n)).astype(np.float32)
    total = np.concatenate([x, np.zeros(rot.latency, np.float32)])
    out = np.concatenate(
        [rot.process(total[i : i + 1000], 90.0)
         for i in range(0, len(total), 1000)])
    want = np.asarray(rotate_fir(x, 90.0, rate=rate))
    lat = rot.latency
    sl = slice(4 * rot.geom.parsiz, n)  # skip the interpolation ramp
    np.testing.assert_allclose(out[lat:][sl], want[sl], atol=2e-4)


def test_pipelined_parity_on_gpu(rng):
    """Depth-D pipelining emits the same stream delayed by exactly
    D*parsiz — on the compiled path, not the CPU simulation."""
    from phaserotate_tpu.stream import StreamingRotator

    depth = 4
    sync = StreamingRotator(rate=48000, channels=1)
    pipe = StreamingRotator(rate=48000, channels=1,
                            pipeline_depth=depth)
    parsiz = sync.geom.parsiz
    n_blocks = depth + 6
    x = rng.standard_normal(n_blocks * parsiz).astype(np.float32)
    y_sync = np.concatenate(
        [sync.process(x[i * parsiz : (i + 1) * parsiz], 35.0)
         for i in range(n_blocks)])
    y_pipe = np.concatenate(
        [pipe.process(x[i * parsiz : (i + 1) * parsiz], 35.0)
         for i in range(n_blocks)])
    d = depth * parsiz
    np.testing.assert_array_equal(y_pipe[d:], y_sync[: len(y_sync) - d])


# ---------------------------------------------------------------------------
# serving: in-process daemon session + cross-session broker
# ---------------------------------------------------------------------------


def test_daemon_session_on_gpu(rng, tmp_path):
    """A real socket session against the serving stack with the engine
    on the card (daemon on a thread: one process owns the card)."""
    from phaserotate_tpu.bridge import BridgeClient, serve

    sock = str(tmp_path / "engine.sock")
    t = threading.Thread(
        target=serve, kwargs=dict(path=sock, once=True, timeout=120.0),
        daemon=True)
    t.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        import time

        time.sleep(0.05)
    cl = BridgeClient(sock, 48000, 1)
    assert cl.latency == 1792
    x = (0.5 * rng.standard_normal((1, 512))).astype(np.float32)
    outs = [cl.process(x, 0.0) for _ in range(12)]
    cl.close()
    t.join(timeout=30)
    y = np.concatenate(outs, axis=1)[0]
    total = np.tile(x[0], 12)
    # angle 0 is identity after latency
    np.testing.assert_allclose(y[cl.latency or 1792 :],
                               total[: len(y) - 1792], atol=1e-5)


def test_broker_batches_sessions_on_gpu(rng):
    """Two concurrent sessions through one StreamBroker: fewer device
    dispatches than frames served, outputs equal solo runs."""
    from phaserotate_tpu.core.sizes import stream_geometry_for_rate
    from phaserotate_tpu.stream.broker import StreamBroker

    geom = stream_geometry_for_rate(48000)
    depth = 2
    n_frames = depth + 4
    xs = [rng.standard_normal((1, n_frames * geom.parsiz)).astype(
        np.float32) for _ in range(2)]

    refs = []
    for s in range(2):
        b = StreamBroker(geom, 1, capacity=1, depth=depth)
        k = b.open()
        out = np.empty_like(xs[s])
        for j in range(n_frames):
            out[:, j * geom.parsiz : (j + 1) * geom.parsiz] = b.submit(
                k, xs[s][:, j * geom.parsiz : (j + 1) * geom.parsiz],
                np.array([20.0 * (s + 1)], np.float32))
        refs.append(out)

    broker = StreamBroker(geom, 1, capacity=2, depth=depth)
    slots = [broker.open(), broker.open()]
    outs = [np.empty_like(xs[0]), np.empty_like(xs[1])]
    errs = []

    def worker(s):
        try:
            for j in range(n_frames):
                frame = xs[s][:, j * geom.parsiz : (j + 1) * geom.parsiz]
                outs[s][:, j * geom.parsiz : (j + 1) * geom.parsiz] = \
                    broker.submit(slots[s], frame,
                                  np.array([20.0 * (s + 1)], np.float32))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(s,)) for s in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    for s in (0, 1):
        np.testing.assert_array_equal(outs[s], refs[s])
    assert broker.dispatches < broker.frames_served


# ---------------------------------------------------------------------------
# sharded-API path, raw-PCM ingest, checkpoint/resume
# ---------------------------------------------------------------------------


def test_parallel_api_on_gpu(rng):
    """The multi-device fleet API (parallel/) executes on the card with
    a one-device mesh — the dryrun_multichip surface, compiled for the
    GPU."""
    import jax.numpy as jnp

    from phaserotate_tpu.core.sizes import OfflineGeometry
    from phaserotate_tpu.parallel import (
        batch_rotate,
        batch_sweep_peaks,
        file_mesh,
    )

    mesh = file_mesh(1)
    geom = OfflineGeometry(blksiz=1024)
    x = jnp.asarray(
        rng.standard_normal((2, 1, 4096)).astype(np.float32))
    degs = jnp.asarray(
        rng.uniform(-180, 180, (2, 1)).astype(np.float32))
    tables, rot0 = batch_sweep_peaks(x, geom, mesh)
    y = batch_rotate(x, degs, mesh)
    assert np.asarray(tables).shape == (2, 1, 360)
    assert np.isfinite(np.asarray(tables)).all()
    assert np.asarray(y).shape == x.shape


def test_pcm16_ingest_on_gpu(rng):
    """int16 device ingest + in-graph dequantize equals the float
    sweep bit-for-bit on the compiled path."""
    from phaserotate_tpu.core.sizes import OfflineGeometry
    from phaserotate_tpu.search.sweep import (
        sweep_peaks_aux,
        sweep_peaks_aux_pcm16,
    )

    geom = OfflineGeometry(blksiz=1024)
    x = (0.5 * rng.standard_normal((1, 4000))).astype(np.float32)
    q = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)
    t_f, r_f = sweep_peaks_aux(q.astype(np.float32) / 32768.0, geom)
    t_q, r_q = sweep_peaks_aux_pcm16(q, geom)
    np.testing.assert_array_equal(np.asarray(t_q), np.asarray(t_f))
    np.testing.assert_array_equal(np.asarray(r_q), np.asarray(r_f))


def test_checkpoint_resume_on_gpu(rng, tmp_path):
    """Mid-stream checkpoint -> resume continues bit-identically with
    the engine carry living on the card."""
    from phaserotate_tpu.core.sizes import stream_geometry_for_rate
    from phaserotate_tpu.stream.checkpoint import (
        load_stream_state,
        save_stream_state,
    )
    from phaserotate_tpu.stream.engine import (
        init_state,
        stream_step_batched,
    )

    geom = stream_geometry_for_rate(48000)
    degs = np.array([40.0], np.float32)
    frames = [rng.standard_normal((1, geom.parsiz)).astype(np.float32)
              for _ in range(6)]
    st = init_state(geom, (1,))
    for f in frames[:3]:
        st, _ = stream_step_batched(st, f, degs, geom)
    p = str(tmp_path / "ck.npz")
    save_stream_state(p, st, geom=geom)
    st2, g2, _ = load_stream_state(p)
    outs_a, outs_b = [], []
    for f in frames[3:]:
        st, ya = stream_step_batched(st, f, degs, geom)
        st2, yb = stream_step_batched(st2, f, degs, geom)
        outs_a.append(np.asarray(ya))
        outs_b.append(np.asarray(yb))
    np.testing.assert_array_equal(np.concatenate(outs_a),
                                  np.concatenate(outs_b))


def test_angle_ramp_click_free_on_gpu(rng):
    """The per-sample interpolation ramp (rate clamp parsiz*1e-6,
    src/phaserotate.c:295, 673-709) runs on the compiled path: no
    sample-to-sample jump exceeds the input's own slew ceiling."""
    from phaserotate_tpu.stream import StreamingRotator

    rot = StreamingRotator(rate=48000, channels=1)
    parsiz = rot.geom.parsiz
    t = np.arange(parsiz * 10) / 48000.0
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    out = []
    # hard angle jump mid-stream: 0 -> 180 degrees
    for i in range(10):
        ang = 0.0 if i < 5 else 180.0
        out.append(rot.process(x[i * parsiz : (i + 1) * parsiz], ang))
    y = np.concatenate(out)
    step = np.abs(np.diff(y[rot.latency :]))
    # a hard polarity flip WITHOUT interpolation would jump ~2x the
    # signal amplitude; the ramp keeps steps near the tone's own slew
    assert step.max() < 0.2


def test_ogg_to_sweep_on_gpu(rng, tmp_path):
    """Host Vorbis decode feeding the on-card sweep: the full lossy
    ingest pipeline (decode -> device tables) end to end."""
    from phaserotate_tpu.core.sizes import OfflineGeometry
    from phaserotate_tpu.io import vorbisenc
    from phaserotate_tpu.search.sweep import sweep_peaks_aux

    if not vorbisenc.available():
        pytest.skip("system libvorbis not present")
    from phaserotate_tpu.io import read_ogg, write_ogg

    t = np.arange(24000) / 48000.0
    x = (0.5 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)[None]
    p = str(tmp_path / "s.ogg")
    write_ogg(p, x, 48000, quality=0.4)
    y, rate, _ = read_ogg(p)
    tables, rot0 = sweep_peaks_aux(y, OfflineGeometry(blksiz=1024))
    tb = np.asarray(tables)
    assert tb.shape == (1, 360) and np.isfinite(tb).all()
    # a steady tone's min-peak rotation gains headroom vs angle 0
    assert tb.min() <= tb[0, 0] + 1e-6


def test_ctrl_metering_on_gpu(rng, tmp_path):
    """The CTRL wire path with the engine on the card: ui_on enables the
    per-session LEVELS stream + STATE echo, reset_peaks clears the peak
    hold — the GUI protocol against the GPU backend."""
    from phaserotate_tpu.bridge import BridgeClient, serve

    sock = str(tmp_path / "engine.sock")
    t = threading.Thread(
        target=serve, kwargs=dict(path=sock, once=True, timeout=120.0),
        daemon=True)
    t.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        import time

        time.sleep(0.05)
    cl = BridgeClient(sock, 48000, 1)
    loud = (0.9 * np.sign(rng.standard_normal((1, 512)))).astype(
        np.float32)
    quiet = (1e-3 * rng.standard_normal((1, 512))).astype(np.float32)
    cl.process(loud, 0.0)
    assert not cl.levels  # UI closed: no stream
    cl.ui_on()
    cl.process(loud, 0.0)
    assert cl.states == [(1.0, False)]
    for _ in range(6):
        cl.process(quiet, 0.0)
    assert cl.levels[-1][3] > 0.5  # in_peak holds the loud block
    cl.reset_peaks()
    cl.levels.clear()
    for _ in range(12):
        cl.process(quiet, 0.0)
    assert cl.levels[-1][3] < 0.1
    cl.close()
    t.join(timeout=30)
