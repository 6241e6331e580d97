#!/usr/bin/env python3
"""End-to-end check of the system on an NVIDIA GPU, through the entry
points its users call, against plain references.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the multi-device paths only

One card, in one process (the process owns the card):

1. device   -- refuse anything but a GPU backend; print the card, its
               power limit, its memory and the sweep implementation chosen
2. build    -- ``make -C native`` (decoders, wire packer, native clients)
3. catalog  -- stereo 44.1 kHz tracks of 3-5 minutes (a quarter FLAC)
               through ``phase-rotate-fleet``; every 360-entry table
               within 2 ulp of the plain reference (``partitioned_convolve``
               + ``ops.peak.rotated_peak_sweep``), selected angles identical
               to it and, for two files, to the CLI oracle
               (tests/ref_cli_sim.py, a literal re-derivation of the
               reference CLI's serial loop)
4. apply    -- ``phase-rotate-fleet --apply`` on the same catalog; every
               output within 1e-5 of a float64 numpy rendering of the CLI
               apply rule (16-bit FLAC outputs: plus their half-LSB
               rounding), one file within 3e-5 of the CLI oracle
5. stems    -- 96 kHz stereo stems of 60 s, each at its own angle, through
               ``rotate(method="fir")`` and ``rotate(method="spectral")``;
               both within 1e-5 of float64 numpy renderings
6. sessions -- live stereo 48 kHz sessions at block 256 against the engine
               daemon (``bridge.serve`` on a thread, socket clients), each
               with an angle change mid-stream; every session within 1e-5
               (SESSION_TOL) of the plugin oracle (tests/ref_cli_sim.py
               RefPlugin) under the same angle schedule, and within 2e-4
               (SESSION_RAMP_TOL) while the change ramps in
7. suite    -- ``pytest tests_gpu/ -x`` in this process

``--four`` runs only what exists across cards: the daemon spreading sessions
over every card (``serve(devices=0)``) against the same sessions on one
card (bit-equal outputs, and every card must have served), and the file-mesh
search (``parallel.batch_find_min_peak_angles``, ``batch_sweep_peaks``,
``sharded_sweep_peaks``) against the one-card mesh.

Every phase prints one line with its seconds and its numbers.  Any failure
exits non-zero; only a full pass prints the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Data is synthesized from ``--seed`` on the device: multitone partials with
slow envelopes plus noise, quantized to 16 bits.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

TABLE_ULP = 2           # peak tables vs the plain reference
APPLY_TOL = 1e-5        # offline apply and stem rotation vs float64 numpy
CLI_APPLY_TOL = 3e-5    # apply vs the CLI oracle (the README's budget)
SESSION_TOL = 1e-5      # live sessions vs the plugin oracle
# ...except while an angle change ramps in: the plugin accumulates the
# angle sample by sample in float32 (src/phaserotate.c:673-709), the
# engine evaluates the ramp in closed form, and the two roundings drift
# apart by up to ~1e-4 over a ramp (the bound tests/test_stream_oracle.py
# holds the engine to)
SESSION_RAMP_TOL = 2e-4
SESSION_BLOCK = 256
RAMP_BLOCKS = 20  # output blocks after a change: latency + longest ramp


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    dt = time.perf_counter() - t0
    print(f"[{name}] {dt:.1f} s {json.dumps(out, default=float)}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def synth_pcm16(seed: int, index: int, channels: int, n: int, rate: int):
    """Music-like test signal on the device: 8 partials per channel with
    slow amplitude envelopes, plus noise, peak at -1 dBFS, as int16."""
    import jax
    import numpy as np

    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    return np.asarray(_synth_jit()(key, channels, n, float(rate)))


def _synth_impl(key, channels, n, rate):
    import jax
    import jax.numpy as jnp
    import numpy as np

    kf, ka, kp, ke, kq, kn = jax.random.split(key, 6)
    shape = (channels, 8, 1)
    freq = jnp.exp(jax.random.uniform(
        kf, shape, minval=np.log(55.0), maxval=np.log(6000.0)))
    amp = jax.random.uniform(ka, shape, minval=0.2, maxval=1.0) \
        / jnp.arange(1, 9, dtype=jnp.float32)[:, None]
    phase = jax.random.uniform(kp, shape, maxval=2 * np.pi)
    env_f = jax.random.uniform(ke, shape, minval=0.05, maxval=1.5)
    env_p = jax.random.uniform(kq, shape, maxval=2 * np.pi)
    t = jnp.arange(n, dtype=jnp.float32) / rate

    def partial(i, acc):
        f, a, p = freq[:, i], amp[:, i], phase[:, i]
        env = 0.6 + 0.4 * jnp.sin(2 * np.pi * env_f[:, i] * t + env_p[:, i])
        return acc + a * env * jnp.sin(2 * np.pi * f * t + p)

    x = jax.lax.fori_loop(0, 8, partial, jnp.zeros((channels, n)))
    x = x + 0.03 * jax.random.normal(kn, (channels, n))
    x = x * (0.891 / jnp.max(jnp.abs(x), axis=-1, keepdims=True))
    return jnp.round(x * 32767.0).astype(jnp.int16)


@functools.lru_cache(maxsize=1)
def _synth_jit():
    import jax

    return jax.jit(_synth_impl, static_argnums=(1, 2, 3))


def _encode_flac(path, pcm, rate):
    """Worker: FLAC-encode one int16 track (a process of its own, so the
    catalog's FLAC quarter encodes in parallel; it never touches JAX)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np

    from phaserotate_tpu.io import write_flac

    write_flac(path, pcm.astype(np.float32) / 32768.0, rate, bits=16)
    return path


# ---------------------------------------------------------------------------
# float64 references
# ---------------------------------------------------------------------------


def conv64(x, fir):
    """Full linear convolution of one float64 channel via numpy's FFT."""
    import numpy as np

    m = len(x) + len(fir) - 1
    nfft = 1 << (m - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(fir, nfft), nfft)
    return y[:m]


def threads():
    return ThreadPoolExecutor(max(2, min(16, (os.cpu_count() or 2))))


def ulps(got, want):
    import numpy as np

    want = np.asarray(want, np.float32)
    d = np.abs(np.asarray(got, np.float32).astype(np.float64) - want)
    return float(np.max(d / np.spacing(np.abs(want)).astype(np.float64)))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(platform, need):
    import jax

    from phaserotate_tpu.kernels.choice import sweep_implementation

    devs = jax.devices()
    check(devs[0].platform == platform,
          f"backend is {devs[0].platform!r}, not {platform!r}")
    check(len(devs) >= need, f"{len(devs)} device(s), need {need}")
    impl = sweep_implementation()
    check(impl in ("triton", "xla"), f"sweep implementation {impl!r}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except FileNotFoundError:
        smi = "nvidia-smi not found"
    print(smi, flush=True)
    stats = devs[0].memory_stats() or {}
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.splitlines(),
            "bytes_limit": stats.get("bytes_limit"),
            "sweep_implementation": impl}


def phase_build():
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"make -C native failed: {r.stderr[-2000:]}")
    from phaserotate_tpu.io import native

    check(native.available(), "native host library did not load")
    return {"native": "built", "cli_oracle": "tests/ref_cli_sim.py"}


def make_catalog(root, args):
    import numpy as np

    from phaserotate_tpu.io import write_wav

    rate = 44100
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    lo, hi = args.track_seconds
    lengths = rng.integers(int(lo * rate), int(hi * rate) + 1, args.tracks)
    n_max = int(hi * rate)
    paths = []
    with ProcessPoolExecutor(min(16, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as pool:
        jobs = []
        for i, n in enumerate(lengths):
            pcm = synth_pcm16(args.seed, i, 2, n_max, rate)[:, :n]
            ext = "flac" if i % 4 == 3 else "wav"
            p = os.path.join(root, f"track{i:03d}.{ext}")
            if ext == "flac":
                jobs.append(pool.submit(_encode_flac, p, pcm, rate))
            else:
                write_wav(p, pcm.astype(np.float32) / 32768.0, rate,
                          bits=16, float_format=False)
            paths.append(p)
        for j in jobs:
            j.result()
    return paths, [int(n) for n in lengths]


def run_fleet(argv):
    from phaserotate_tpu import fleet

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fleet.main(argv)
    check(rc == 0, f"fleet exited {rc}")
    return buf.getvalue()


def parse_fleet_angles(text):
    """{path: [units per channel]} from phase-rotate-fleet's output."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"(.+)  ch (\d+): (?:([+-]\d+\.\d+) deg|no improvement)",
                     line)
        if m:
            units = 0 if m.group(3) is None else round(float(m.group(3)) * 2)
            out.setdefault(m.group(1), []).append(units)
    return out


def fleet_batch(n_pad, channels=2):
    """Files per device pass: a working set of ~24 float32 copies of each
    file's padded signal inside the card's memory limit."""
    import jax

    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    if not limit:
        return 4
    return int(max(1, min(32, limit // (24 * 4 * channels * n_pad))))


def reference_tables(pcm16, geom):
    """Plain-reference peak table and rot0 of one file: the aligned pair
    through ``partitioned_convolve``, then ``rotated_peak_sweep`` per
    channel.  Padded with silence to a multiple of 128 blocks (pairs of
    zeros never exceed a peak) so few shapes compile."""
    import numpy as np

    step = 128 * geom.parsiz
    n = pcm16.shape[-1]
    x = np.zeros((pcm16.shape[0], -(-n // step) * step), np.float32)
    x[:, :n] = pcm16.astype(np.float32) / 32768.0
    t, r = _reference_jit(geom)(x)
    return np.asarray(t), np.asarray(r)


@functools.lru_cache(maxsize=None)
def _reference_jit(geom):
    import jax
    import jax.numpy as jnp

    from phaserotate_tpu.core.angles import all_angle_cos_sin
    from phaserotate_tpu.ops.peak import rotated_peak_sweep
    from phaserotate_tpu.search.sweep import aligned_pair

    def ref(x):
        b0, b1, h_start, x_peak = aligned_pair(x, geom)
        cs = all_angle_cos_sin()
        peaks = jax.vmap(lambda a, b: rotated_peak_sweep(a, b, cs))(b0, b1)
        peaks = jnp.maximum(peaks, jnp.abs(cs[1]) * h_start[:, None])
        # slot 0 is the raw input peak; rot0 the aligned one
        # (search/sweep.py alignment map)
        return peaks.at[:, 0].set(x_peak), peaks[:, 0]

    return jax.jit(ref)


def phase_catalog(state, args):
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from ref_cli_sim import MAXSAMPLE, RefRotate

    from phaserotate_tpu.core.sizes import offline_geometry
    from phaserotate_tpu.fleet import _bucket_key
    from phaserotate_tpu.io import read_audio_pcm16
    from phaserotate_tpu.search.minimize import (
        select_min_peak_angles,
        select_min_peak_angles_batch,
    )
    from phaserotate_tpu.utils.checkpoint import SweepCheckpoint

    root = state["root"]
    t0 = time.perf_counter()
    paths, lengths = make_catalog(os.path.join(root, "catalog"), args)
    t_make = time.perf_counter() - t0
    geom = offline_geometry(44100)
    n_pad = max(_bucket_key(44100, 2, n, geom.parsiz)[2] for n in lengths)
    batch = fleet_batch(n_pad)
    ckpt = os.path.join(root, "sweeps.npz")
    t0 = time.perf_counter()
    text = run_fleet(["--batch", str(batch), "--checkpoint", ckpt, *paths])
    t_fleet = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    printed = parse_fleet_angles(text)
    check(sorted(printed) == sorted(paths), "fleet did not report every file")

    store = SweepCheckpoint(ckpt)
    worst = 0.0
    units = {}
    for p in paths:
        table, rot0 = store.get(p)
        pcm = read_audio_pcm16(p)[0]
        want_t, want_r = reference_tables(pcm, geom)
        worst = max(worst, ulps(table, want_t), ulps(rot0, want_r))
        want = select_min_peak_angles_batch(want_t[None], rot0=want_r[None])
        got = select_min_peak_angles_batch(table[None], rot0=rot0[None])
        check(list(got[0].angles_units) == list(want[0].angles_units),
              f"{p}: angles {got[0].angles_units} vs reference "
              f"{want[0].angles_units}")
        check(printed[p] == [int(u) for u in got[0].angles_units],
              f"{p}: printed {printed[p]} vs stored {got[0].angles_units}")
        units[p] = [int(u) for u in got[0].angles_units]
    check(worst <= TABLE_ULP, f"tables {worst} ulp from the reference")

    # the CLI oracle on the two shortest files
    t0 = time.perf_counter()
    oracle = []
    for i in np.argsort(lengths)[:2]:
        p = paths[i]
        x = read_audio_pcm16(p)[0].astype(np.float32) / 32768.0
        sim = RefRotate(geom.blksiz, x.shape[0])
        sim.analyze_file(x, 0, MAXSAMPLE, 1)
        rot0 = []
        for c in range(x.shape[0]):
            s1 = RefRotate(geom.blksiz, 1)
            s1.analyze_file(x[c : c + 1], 336, 361, 1)
            rot0.append(s1.peak[0][0])
        res = select_min_peak_angles(sim.peak, rot0=np.asarray(rot0))
        check([int(u) for u in res.angles_units] == units[p],
              f"{p}: CLI oracle {res.angles_units} vs fleet {units[p]}")
        oracle.append(os.path.basename(p))
    state.update(paths=paths, lengths=lengths, units=units, geom=geom,
                 batch=batch, ckpt=ckpt)
    return {"tracks": len(paths), "flac": sum(p.endswith(".flac")
                                              for p in paths),
            "audio_minutes": round(sum(lengths) / 44100 / 60, 1),
            "make_s": round(t_make, 1), "fleet_s": round(t_fleet, 1),
            "batch": batch, "peak_bytes_in_use": stats.get(
                "peak_bytes_in_use"),
            "max_table_ulp": worst, "angles_equal_reference": True,
            "cli_oracle_files": oracle,
            "cli_oracle_s": round(time.perf_counter() - t0, 1)}


def phase_apply(state):
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from ref_cli_sim import RefRotate

    from phaserotate_tpu.core.angles import _sincos_lut_np
    from phaserotate_tpu.core.fir import _design_hilbert_fir_np
    from phaserotate_tpu.io import read_audio, read_audio_pcm16

    paths, units, geom = state["paths"], state["units"], state["geom"]
    outdir = os.path.join(state["root"], "applied")
    t0 = time.perf_counter()
    run_fleet(["--apply", "--outdir", outdir, "--batch",
               str(state["batch"]), "--checkpoint", state["ckpt"], *paths])
    t_apply = time.perf_counter() - t0

    fir = _design_hilbert_fir_np(geom.parsiz).astype(np.float64)
    sin_t, cos_t = _sincos_lut_np()
    lat = geom.firlen

    def one(p):
        x = read_audio_pcm16(p)[0].astype(np.float64) / 32768.0
        y, _, _ = read_audio(os.path.join(outdir, os.path.basename(p)))
        n = x.shape[-1]
        err = 0.0
        for c in range(x.shape[0]):
            a = (units[p][c] + 360) % 360
            h = conv64(x[c], fir)
            want = (float(cos_t[a]) * x[c]
                    + float(sin_t[a]) * h[lat : lat + n])
            err = max(err, float(np.max(np.abs(y[c] - want))))
        return p, err

    with threads() as ex:
        errs = dict(ex.map(one, paths))
    half_lsb = 0.5 / 32768.0
    wav = max(e for p, e in errs.items() if p.endswith(".wav"))
    flac = max((e for p, e in errs.items() if p.endswith(".flac")),
               default=0.0)
    check(wav < APPLY_TOL, f"apply {wav} from float64 (WAV outputs)")
    check(flac < APPLY_TOL + half_lsb,
          f"apply {flac} from float64 (16-bit FLAC outputs)")

    # the CLI oracle's apply on the shortest WAV track; the last
    # blksiz/2 samples are the documented partial-tail deviation
    # (tests/test_search.py::test_apply_partial_tail_is_gapless)
    p = min((p for p in paths if p.endswith(".wav")),
            key=lambda q: state["lengths"][paths.index(q)])
    x = read_audio_pcm16(p)[0].astype(np.float32) / 32768.0
    y = read_audio(os.path.join(outdir, os.path.basename(p)))[0]
    want = RefRotate(geom.blksiz, x.shape[0]).apply_file(x, units[p])
    keep = x.shape[-1] - geom.latency
    cli = float(np.max(np.abs(y[:, :keep] - want[:, :keep])))
    check(cli < CLI_APPLY_TOL, f"apply {cli} from the CLI oracle")
    shutil.rmtree(outdir, ignore_errors=True)
    return {"apply_s": round(t_apply, 1), "max_err_wav": wav,
            "max_err_flac_beyond_half_lsb": max(0.0, flac - half_lsb),
            "max_err_cli_oracle": cli,
            "cli_oracle_file": os.path.basename(p)}


def phase_stems(args):
    import jax
    import numpy as np

    import phaserotate_tpu as pr
    from phaserotate_tpu.core.fir import _design_hilbert_fir_np
    from phaserotate_tpu.core.sizes import stream_geometry_for_rate

    rate = 96000
    n = int(args.stem_seconds * rate)
    x16 = np.stack([synth_pcm16(args.seed, 10000 + i, 2, n, rate)
                    for i in range(args.stems)])
    degs = np.random.default_rng(args.seed + 1).uniform(
        -180.0, 180.0, (args.stems, 1)).astype(np.float32)
    x = jax.device_put(x16.astype(np.float32) / np.float32(32768.0))
    out = {}
    for method in ("fir", "spectral"):
        y = pr.rotate(x, degs, method=method, rate=rate)
        jax.block_until_ready(y)
        t0 = time.perf_counter()
        y = pr.rotate(x, degs, method=method, rate=rate)
        jax.block_until_ready(y)
        out[f"{method}_s"] = round(time.perf_counter() - t0, 4)
        out[f"{method}_x_realtime"] = round(
            args.stems * args.stem_seconds / (time.perf_counter() - t0), 1)
        y = np.asarray(y)
        firlen = stream_geometry_for_rate(rate).firlen
        fir = _design_hilbert_fir_np(firlen).astype(np.float64)

        def one(idx):
            s, c = idx
            xs = x16[s, c].astype(np.float64) / 32768.0
            th = 2 * np.pi * float(degs[s, 0]) / 360.0
            if method == "fir":
                h = conv64(xs, fir)[firlen // 2 : firlen // 2 + n]
                # the engine's angle: negated turns, sin/cos of 2*pi*turns
                want = np.cos(th) * xs + np.sin(-th) * h
            else:
                X = np.fft.rfft(xs)
                coef = np.full(X.shape, np.exp(-1j * th))
                coef[0] = np.cos(th)
                if n % 2 == 0:
                    coef[-1] = np.cos(th)
                want = np.fft.irfft(X * coef, n)
            return float(np.max(np.abs(y[s, c] - want)))

        with threads() as ex:
            err = max(ex.map(one, [(s, c) for s in range(args.stems)
                                   for c in range(2)]))
        check(err < APPLY_TOL, f"{method} rotation {err} from float64")
        out[f"{method}_max_err"] = err
    out.update(stems=args.stems, seconds=args.stem_seconds)
    return out


def start_daemon(sock, **kwargs):
    from phaserotate_tpu.bridge import serve

    t = threading.Thread(target=serve, kwargs=dict(path=sock, **kwargs),
                         daemon=True)
    t.start()
    for _ in range(600):
        if os.path.exists(sock):
            return t
        time.sleep(0.05)
    raise SmokeFailure("daemon did not start listening")


def session_inputs(args, count):
    import numpy as np

    rate = 48000
    n = int(args.session_seconds * rate) // SESSION_BLOCK * SESSION_BLOCK
    rng = np.random.default_rng(args.seed + 2)
    inputs = []
    for i in range(count):
        x = synth_pcm16(args.seed, 20000 + i, 2, n, rate)
        a, b = rng.uniform(-170.0, 170.0, 2)
        inputs.append((x.astype(np.float32) / 32768.0,
                       float(np.float32(a)), float(np.float32(b))))
    return inputs


def run_sessions(sock, inputs, probe=None):
    """One socket client per input on its own thread; returns the
    outputs, every block's round trip and what ``probe()`` returned while
    every session was still open."""
    import numpy as np

    from phaserotate_tpu.bridge import BridgeClient

    outs = [None] * len(inputs)
    times = [None] * len(inputs)
    errors = []
    held = threading.Barrier(len(inputs) + 1)

    def client(i):
        try:
            x, a, b = inputs[i]
            cl = BridgeClient(sock, 48000, 2)
            n_blocks = x.shape[1] // SESSION_BLOCK
            ys, ts = [], []
            for j in range(n_blocks):
                blk = x[:, j * SESSION_BLOCK : (j + 1) * SESSION_BLOCK]
                t0 = time.perf_counter()
                ys.append(cl.process(blk, a if j < n_blocks // 2 else b))
                ts.append(time.perf_counter() - t0)
            held.wait(timeout=600)  # every session open: probe
            held.wait(timeout=600)
            cl.close()
            outs[i] = np.concatenate(ys, axis=1)
            times[i] = ts
        except Exception as e:  # surfaced below, never passed over
            held.abort()
            errors.append(repr(e))

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(len(inputs))]
    for t in ths:
        t.start()
    seen = None
    try:
        held.wait(timeout=600)
        seen = probe() if probe else None
        held.wait(timeout=600)
    except threading.BrokenBarrierError:
        pass
    for t in ths:
        t.join()
    check(not errors, f"session clients failed: {errors}")
    return outs, times, seen


def phase_sessions(state, args):
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from ref_cli_sim import RefPlugin

    inputs = session_inputs(args, args.sessions)
    sock = os.path.join(state["root"], "engine.sock")
    start_daemon(sock, timeout=300.0)
    outs, times, _ = run_sessions(sock, inputs)

    def oracle(i):
        x, a, b = inputs[i]
        n_blocks = x.shape[1] // SESSION_BLOCK
        ramp = np.zeros(x.shape[1], bool)
        ramp[(n_blocks // 2) * SESSION_BLOCK :
             (n_blocks // 2 + RAMP_BLOCKS) * SESSION_BLOCK] = True
        steady = ramped = 0.0
        for c in range(2):
            ref = RefPlugin(48000)
            ys = [ref.run(x[c, j * SESSION_BLOCK : (j + 1) * SESSION_BLOCK],
                          a if j < n_blocks // 2 else b)[0]
                  for j in range(n_blocks)]
            d = np.abs(outs[i][c] - np.concatenate(ys))
            steady = max(steady, float(np.max(d[~ramp])))
            ramped = max(ramped, float(np.max(d[ramp], initial=0.0)))
        return steady, ramped

    with threads() as ex:
        errs = list(ex.map(oracle, range(len(inputs))))
    steady = max(e[0] for e in errs)
    ramped = max(e[1] for e in errs)
    check(steady < SESSION_TOL, f"sessions {steady} from the plugin oracle")
    check(ramped < SESSION_RAMP_TOL,
          f"sessions {ramped} from the plugin oracle during a ramp")
    flat = sorted(t for ts in times for t in ts)
    return {"sessions": len(inputs), "seconds": args.session_seconds,
            "block": SESSION_BLOCK, "max_err": steady,
            "max_err_in_ramp": ramped,
            "rtt_p50_ms": round(1e3 * statistics.median(flat), 3),
            "rtt_p99_ms": round(1e3 * flat[int(0.99 * (len(flat) - 1))], 3)}


def phase_suite():
    import pytest

    rc = pytest.main(["-x", "-q", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests_gpu")])
    check(rc == 0, f"tests_gpu exited {rc}")
    return {"pytest_rc": int(rc)}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four_sessions(state, args):
    import jax
    import numpy as np

    inputs = session_inputs(args, args.sessions)

    def cards_in_use():
        return sorted({d.id for a in jax.live_arrays() for d in a.devices()})

    one = os.path.join(state["root"], "one.sock")
    start_daemon(one, timeout=300.0, devices=1)
    want, _, _ = run_sessions(one, inputs)
    spread = os.path.join(state["root"], "all.sock")
    start_daemon(spread, timeout=300.0, devices=0)
    got, times, used = run_sessions(spread, inputs, probe=cards_in_use)
    for i in range(len(inputs)):
        check(np.array_equal(got[i], want[i]),
              f"session {i} differs between one card and all cards")
    everyone = sorted(d.id for d in jax.devices())
    check(used == everyone, f"open sessions hold arrays on cards {used}")
    flat = sorted(t for ts in times for t in ts)
    return {"sessions": len(inputs), "bit_equal": True,
            "cards_holding_sessions": used,
            "rtt_p50_ms": round(1e3 * statistics.median(flat), 3)}


def phase_four_mesh(args):
    import jax
    import numpy as np

    from phaserotate_tpu.core.sizes import offline_geometry
    from phaserotate_tpu.parallel import (
        batch_find_min_peak_angles,
        batch_sweep_peaks,
        file_mesh,
        sharded_sweep_peaks,
    )
    from phaserotate_tpu.search import sweep_peaks_aux

    rate = 44100
    geom = offline_geometry(rate)
    n = int(args.mesh_seconds * rate)
    x = np.stack([synth_pcm16(args.seed, 30000 + i, 2, n, rate)
                  for i in range(args.mesh_files)]).astype(np.float32) \
        / np.float32(32768.0)
    one, four = file_mesh(1), file_mesh(4)
    t1, r1 = batch_sweep_peaks(x, geom, one)
    t4, r4 = batch_sweep_peaks(x, geom, four)
    cards = {s.device for s in t4.addressable_shards}
    check(len(cards) == 4, f"file-mesh tables live on {len(cards)} card(s)")
    table_ulp = max(ulps(t4, t1), ulps(r4, r1))
    check(table_ulp <= TABLE_ULP, f"file-mesh tables {table_ulp} ulp apart")
    a1 = batch_find_min_peak_angles(x, geom, one)
    a4 = batch_find_min_peak_angles(x, geom, four)
    check([r.angles_units for r in a1] == [r.angles_units for r in a4],
          "file-mesh angles differ from one card")
    # one long file, its samples sharded over the cards
    long = x[:, 0].reshape(-1)
    s4, q4 = sharded_sweep_peaks(long, geom, four, axis="files")
    s1, q1 = sweep_peaks_aux(long, geom)
    seq_ulp = max(ulps(s4, s1), ulps(q4, q1))
    check(seq_ulp <= TABLE_ULP, f"sample-sharded table {seq_ulp} ulp apart")
    return {"files": args.mesh_files, "seconds": args.mesh_seconds,
            "cards_holding_tables": len(cards),
            "tables_identical": bool(np.array_equal(np.asarray(t4),
                                                    np.asarray(t1))),
            "max_table_ulp": table_ulp, "angles_identical": True,
            "sample_sharded_ulp": seq_ulp,
            "sample_sharded_identical": bool(
                np.array_equal(np.asarray(s4), np.asarray(s1)))}


# ---------------------------------------------------------------------------


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tracks", type=int, default=64)
    ap.add_argument("--track-seconds", type=float, nargs=2,
                    default=(180.0, 300.0))
    ap.add_argument("--stems", type=int, default=64)
    ap.add_argument("--stem-seconds", type=float, default=60.0)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--session-seconds", type=float, default=10.0)
    ap.add_argument("--mesh-files", type=int, default=16)
    ap.add_argument("--mesh-seconds", type=float, default=60.0)
    return ap.parse_args(argv)


def main(argv=None, platform="gpu"):
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    from phaserotate_tpu.core.plancache import enable_compile_cache

    enable_compile_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    state = {"root": root}
    try:
        dev = phase("device", phase_device, platform, 4 if args.four else 1)
        if args.four:
            phase("four_sessions", phase_four_sessions, state, args)
            phase("four_mesh", phase_four_mesh, args)
        else:
            phase("build", phase_build)
            phase("catalog", phase_catalog, state, args)
            phase("apply", phase_apply, state)
            phase("stems", phase_stems, args)
            phase("sessions", phase_sessions, state, args)
            phase("suite", phase_suite)
    except Exception:  # report, then fail: nothing is passed over
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        return 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
