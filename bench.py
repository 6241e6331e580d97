#!/usr/bin/env python
"""Headline benchmarks on one NVIDIA GPU.

Two targets (BASELINE.json):
  1. rotate path  >= 1000x realtime, mono 48 kHz, per card
  2. batched min-peak angle search >= 100 files/s (10 s files)

Prints ONE JSON line; `value` is the rotate realtime multiple and
`vs_baseline` is the *minimum* of the two target ratios, so it only reads
>= 1 when both targets are met.  Extra keys record the search numbers,
the serving numbers, and the device the run landed on.

Methodology:
  * Refuses to run unless JAX's default backend is a GPU: a number taken
    on the CPU backend is not a number about the card.
  * One process holds the card at a time.  The daemon cells run first,
    with the engine daemon (``python -m phaserotate_tpu.bridge``) owning
    the card while this process, the socket client, has not initialized
    its JAX backend; each daemon exits before the next cell.  The
    in-process cells follow.
  * Each iteration ends in a scalar readback, so a time covers the
    device work, not the enqueue.
  * Each metric is the median of REPS timed runs of ITERS iterations
    (distinct angle inputs defeat caching).
"""

import json
import os
import statistics
import sys
import time


def _stage(msg):
    """Progress to stderr (the JSON contract owns stdout): long
    server-side compiles otherwise look like hangs."""
    print(f"bench: {msg} [t+{time.perf_counter() - _T0:.0f}s]",
          file=sys.stderr, flush=True)


_T0 = time.perf_counter()

import jax
import jax.numpy as jnp
import numpy as np

ITERS = 4
REPS = 3


def _medtime(fn, inputs):
    """Median seconds/iteration over REPS runs of ITERS calls each."""
    float(fn(*inputs(0)))  # compile + warm
    float(fn(*inputs(1)))  # warm a second input (cache both shapes/paths)
    runs = []
    for r in range(REPS):
        t0 = time.perf_counter()
        for i in range(ITERS):
            float(fn(*inputs(2 + r * ITERS + i)))
        runs.append((time.perf_counter() - t0) / ITERS)
    return statistics.median(runs)


def device_memory_bytes(device=None):
    """The card's memory limit as JAX reports it (``bytes_limit``)."""
    device = device or jax.devices()[0]
    return float((device.memory_stats() or {})["bytes_limit"])


def auto_rotate_batch(rate=48000, seconds=60):
    """Largest power-of-two rotate batch whose working set (8 float32
    copies of each file: input, framed signal, its spectrum as a complex
    pair, product, output) fits 80% of the card's memory."""
    per_file = 8 * 4 * rate * seconds
    batch = 1
    while 2 * batch * per_file <= 0.8 * device_memory_bytes():
        batch *= 2
    return batch


def bench_rotate(rate=48000, seconds=60, batch=None):
    """Batched offline rotate throughput; batch sized from device
    memory (auto_rotate_batch) unless given.  If the first warm run
    runs out of memory, halves the batch instead of failing the whole
    bench."""
    from phaserotate_tpu.ops import rotate_fir

    if batch is None:
        batch = auto_rotate_batch(rate, seconds)
    n = rate * seconds
    rng = np.random.default_rng(0)
    run = jax.jit(lambda x, d: jnp.sum(rotate_fir(x, d, rate=rate)))
    while True:
        try:
            x = jnp.asarray(
                rng.standard_normal((batch, n)).astype(np.float32))
            degs = jnp.asarray(
                rng.uniform(-180, 180, batch).astype(np.float32))
            dt = _medtime(run, lambda i: (x, degs + float(i)))
            return batch * n / dt / rate, batch  # x realtime
        except Exception as e:
            msg = str(e)
            oom = "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg
            if not oom or batch == 1:
                raise
            x = degs = None
            batch //= 2
            _stage(f"rotate OOM, stepping down to batch {batch}")


_sweep_jit = {}


def _shared_sweep(geom, n):
    """ONE jitted sweep per (geometry, length), shared by the
    device-only, in-memory, and on-disk search benches — identical
    input shapes and dtype, so the XLA compile happens once, not per
    bench.

    Takes RAW int16 PCM bit-packed as int32 (pack_pcm16) and dequantizes
    on device — the fleet ingest path of search.sweep_peaks_aux_pcm16:
    half the host->device bytes of float32, with the cast fused into the
    sweep's first convolution.  ``s`` is a float shift applied post-dequantize
    so every iteration sees distinct values without re-staging host
    data."""
    key = (geom.blksiz, n)
    if key not in _sweep_jit:
        from phaserotate_tpu.search.sweep import _sweep_impl, _unpack_pcm16

        _sweep_jit[key] = jax.jit(
            lambda p, s: _sweep_impl(
                _unpack_pcm16(p, n) + s, geom))
    return _sweep_jit[key]


def _quantize16(x):
    return np.clip(np.rint(np.asarray(x) * 32768.0), -32768,
                   32767).astype(np.int16)


def bench_search(rate=48000, seconds=10, batch=512):
    from phaserotate_tpu.core.sizes import OfflineGeometry

    from phaserotate_tpu.search.sweep import pack_pcm16

    geom = OfflineGeometry(blksiz=8192)
    n = rate * seconds
    rng = np.random.default_rng(1)
    x = jnp.asarray(pack_pcm16(_quantize16(
        0.5 * rng.standard_normal((batch, 1, n)).astype(np.float32))))
    sweep = _shared_sweep(geom, n)
    f = lambda x, s: jnp.sum(sweep(x, s)[0])  # noqa: E731
    dt = _medtime(f, lambda i: (x, 0.01 * i))
    return batch / dt  # files per second


def bench_search_e2e(rate=48000, seconds=10, batch=512):
    """Full search pipeline: device sweep -> table readback -> CLI-parity
    selection on host.  The number a fleet user actually gets
    (cli/phase-rotate.cc:779-948 end to end).

    Batches stream with ONE batch of readback slack — exactly the
    fleet front end's structure (fleet.analyze_paths): batch k's
    tables are read back and selected only after batch k+1's sweep
    was dispatched, so the readback and the host selection hide under
    the next batch's device pass instead of serializing after it."""
    from phaserotate_tpu.core.sizes import OfflineGeometry
    from phaserotate_tpu.search.minimize import select_min_peak_angles_batch

    from phaserotate_tpu.search.sweep import pack_pcm16

    geom = OfflineGeometry(blksiz=8192)
    n = rate * seconds
    rng = np.random.default_rng(2)
    x = jnp.asarray(pack_pcm16(_quantize16(
        0.5 * rng.standard_normal((batch, 1, n)).astype(np.float32))))
    sweep = _shared_sweep(geom, n)

    def finish(handles):
        tables, rot0 = handles
        res = select_min_peak_angles_batch(
            np.asarray(tables), rot0=np.asarray(rot0))
        return len(res)

    def run_stream(n_batches, base):
        pending = None
        done = 0
        for i in range(n_batches):
            handles = sweep(x, base + 0.01 * i)
            if pending is not None:
                done += finish(pending)
            pending = handles
        return done + finish(pending)

    run_stream(2, 0.0)  # compile + warm both pipeline positions
    runs = []
    for r in range(REPS):
        t0 = time.perf_counter()
        done = run_stream(ITERS, 1.0 + r)
        runs.append((time.perf_counter() - t0) / (done // batch))
    return batch / statistics.median(runs)


def _make_disk_corpus(root, n_files=512, rate=48000, seconds=10,
                      n_unique=16):
    """BASELINE config 5 literally: an on-disk dataset of WAV + FLAC
    files (10 s mono each).  ``n_unique`` distinct signals are
    synthesized and encoded once; the rest are byte copies (decode cost
    is content-independent, so copies measure the same work while
    keeping corpus generation off the bench's critical path).

    Two content tiers: the original tier carries -26 dBFS white noise
    (nearly incompressible — FLAC needs ~13 bits/sample on it), kept
    byte-identical to earlier rounds for comparability; the ``wavq``
    tier carries a clean-master -54 dBFS noise floor, where lossless
    residual packing engages (~11 bits/sample) — the content class the
    packed wire transport exists for.  The ``ogg``/``opus``/``mp3``
    tiers encode the original signals lossily (Vorbis decoded by
    native/vorbis_decode.cc, Opus/MP3 by the libopus/libmpg123
    bindings); each is made only where its system codec library is
    installed.  Returns {fmt: [paths]}."""
    import shutil

    from phaserotate_tpu.io import mp3, opus, vorbisenc, write_flac, write_wav

    os.makedirs(root, exist_ok=True)
    n = rate * seconds
    rng = np.random.default_rng(7)
    t = np.arange(n) / rate

    def synth(u, noise):
        f0 = 55.0 * (u + 2)
        return (0.4 * np.sin(2 * np.pi * f0 * t)
                + 0.2 * np.sin(2 * np.pi * 2.7 * f0 * t + 0.3 * u)
                + noise * rng.standard_normal(n)).astype(np.float32)[None]

    uniq = [synth(u, 0.05) for u in range(n_unique)]
    quiet = [synth(u, 0.002) for u in range(n_unique)]

    def write_wav16(p, x):
        write_wav(p, x, rate, bits=16, float_format=False)

    tiers = [("wav", write_wav16, uniq),
             ("flac", lambda p, x: write_flac(p, x, rate, bits=16), uniq),
             ("wavq", write_wav16, quiet)]
    for fmt, codec in (("ogg", vorbisenc), ("opus", opus), ("mp3", mp3)):
        if codec.available():
            write = getattr(codec, {"ogg": "write_ogg"}.get(
                fmt, f"write_{fmt}"))
            tiers.append((fmt, lambda p, x, w=write: w(p, x, rate), uniq))
    corpus = {}
    for fmt, write, signals in tiers:
        ext = "wav" if fmt == "wavq" else fmt
        bucket = []
        for u in range(n_unique):
            p = os.path.join(root, f"{fmt}_u{u:02d}.{ext}")
            write(p, signals[u])
            bucket.append(p)
        i = 0
        while len(bucket) < n_files:
            p = os.path.join(root, f"{fmt}_c{i:04d}.{ext}")
            shutil.copyfile(bucket[i % n_unique], p)
            bucket.append(p)
            i += 1
        corpus[fmt] = bucket
    return corpus


def measure_wire_bw(mb=64):
    """Sustained host->device MB/s of one transfer, ended by a scalar
    readback."""
    n = mb * 262144
    rng = np.random.default_rng(9)
    f = jax.jit(lambda x: x.sum())
    warm = jnp.asarray(rng.integers(-9, 9, (n,), dtype=np.int32))
    float(f(warm))  # compile on this shape (pays one untimed transfer)
    a = rng.integers(-1000, 1000, (n,), dtype=np.int32)
    t0 = time.perf_counter()
    float(f(jnp.asarray(a)))
    return mb / (time.perf_counter() - t0)


def bench_search_disk(rate=48000, seconds=10, batch=512, chunk=64):
    """THE fleet number: read -> decode -> device sweep -> CLI-parity
    selection, from real files on disk (the reference's whole search
    workflow, cli/phase-rotate.cc:573-587 + 779-948).

    Ingest is the adaptive-transport path: 16-bit WAV/FLAC decode
    straight to an int16 staging slot (native FLAC decoder, no host
    floats), then the native residual packer (wire_pack.cc, GIL
    released) tries to beat the 16-bit bitcast — compressible content
    ships packed residuals unpacked in-graph, incompressible content
    ships raw pcm16.  The batch streams through the device in
    ``chunk``-file sub-batches; ``sustained`` keeps TWO decode+pack
    stages in flight ahead of the dispatch loop.

    Wire probes interleave with the format rows, serial/sustained
    passes alternate, every row gets >= 2 rounds, and the per-format
    figure is the better mode's median.  A parity check asserts both
    modes select identical angles.

    Returns ({fmt: {serial, sustained, fps, bits_per_sample}},
             wire_probes_mb_s, lossless_floor_bits_per_sample) — the
    floor is measured from the corpus's own FLAC encodings (Rice
    coding, the tightest practical lossless bound for this content).
    """
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from phaserotate_tpu.core.sizes import OfflineGeometry
    from phaserotate_tpu.io import read_audio_pcm16
    from phaserotate_tpu.search.minimize import select_min_peak_angles_batch
    from phaserotate_tpu.search.packed import (
        PackedChunk,
        pack_adaptive,
        sweep_peaks_aux_packed,
    )

    geom = OfflineGeometry(blksiz=8192)
    n = rate * seconds
    n_chunks = -(-batch // chunk)
    root = tempfile.mkdtemp(prefix="prtcorpus")
    corpus = _make_disk_corpus(root, n_files=batch, rate=rate,
                               seconds=seconds)
    sweep = _shared_sweep(geom, n)  # jitted per (geom, n): chunk shape
    # preallocated, pre-touched staging slots, ONE per chunk: device_put
    # may read the host buffer asynchronously, so no slot is rewritten
    # while its transfer can still be in flight — each pass ends with a
    # full force (select_all) before any slot is reused; the pack
    # scratch rides the same per-slot discipline
    ring = [np.zeros((chunk, 1, n), np.int16) for _ in range(n_chunks)]
    scratch = [np.zeros(chunk * n * 16 // 32, np.int32)
               for _ in range(n_chunks)]
    io = ThreadPoolExecutor(2)  # two decode+pack stages in flight
    shipped = [0]  # wire bytes accumulator (per timed row)

    def stage_chunk(k, paths):
        buf = ring[k]
        for i, p in enumerate(paths):
            buf[i, 0, :] = read_audio_pcm16(p)[0][0, :n]
        if len(paths) < chunk:
            buf[len(paths):] = 0
        pk = pack_adaptive(buf, scratch[k])
        if pk is not None:
            shipped[0] += pk.wire_bytes
            return pk
        shipped[0] += buf.nbytes
        return buf

    def dispatch(obj):
        if isinstance(obj, PackedChunk):
            return sweep_peaks_aux_packed(obj, geom)
        # int16 shipped as bitcast int32 (pack_pcm16); enqueue only,
        # forced later
        return sweep(jnp.asarray(obj.view(np.int32)), 0.0)

    def select_all(handles):
        tables = np.concatenate([np.asarray(t) for t, _ in handles])
        rot0 = np.concatenate([np.asarray(r) for _, r in handles])
        return select_min_peak_angles_batch(tables[:batch],
                                            rot0=rot0[:batch])

    def chunks_of(paths):
        return [paths[k * chunk : (k + 1) * chunk]
                for k in range(n_chunks)]

    def pass_serial(paths):
        handles = []
        for k, part in enumerate(chunks_of(paths)):
            h = dispatch(stage_chunk(k, part))
            np.asarray(h[0])  # force: no overlap in serial mode
            handles.append(h)
        return select_all(handles)

    def pass_sustained(paths):
        parts = chunks_of(paths)
        futs = {k: io.submit(stage_chunk, k, parts[k])
                for k in range(min(2, len(parts)))}
        handles = []
        for k in range(len(parts)):
            obj = futs.pop(k).result()
            if k + 2 < len(parts):
                futs[k + 2] = io.submit(stage_chunk, k + 2,
                                        parts[k + 2])
            handles.append(dispatch(obj))
        return select_all(handles)  # forces every queued sweep

    wavs, flacs, quiets = corpus["wav"], corpus["flac"], corpus["wavq"]
    mixed = wavs[: batch // 2] + flacs[: batch - batch // 2]
    floor_bps = 8.0 * sum(os.path.getsize(p) for p in flacs) \
        / (len(flacs) * n)
    results = {}
    probes = []
    try:
        # warm: pages + pools + BOTH transport programs (the quiet tier
        # compiles the packed-unpack variants)
        pass_serial(mixed)
        pass_serial(quiets)
        # parity: the overlapped pipeline must select what serial does
        r_serial = pass_serial(mixed)
        r_sust = pass_sustained(mixed)
        assert [r.angles_deg[0] for r in r_serial] == \
            [r.angles_deg[0] for r in r_sust], "pipeline parity broke"

        def timed(fn, paths):
            t0 = time.perf_counter()
            fn(paths)
            return batch / (time.perf_counter() - t0)

        # wire-only replay: the row's exact staged objects re-shipped
        # with no decode/pack/sweep/selection — the link's speed of
        # light for THIS row's transfer pattern; row/replay isolates
        # the pipeline from the link.  Sum programs are AOT-compiled
        # from ShapeDtypeStructs so the timed pass pays transfers only
        # (a scalar readback ends it).
        _sum_cache = {}

        def _compiled_sum(a):
            key = (a.shape, a.dtype.name)
            if key not in _sum_cache:
                _sum_cache[key] = jax.jit(lambda v: v.sum()).lower(
                    jax.ShapeDtypeStruct(a.shape, a.dtype)).compile()
            return _sum_cache[key]

        def _wire_arrays(obj):
            if isinstance(obj, PackedChunk):
                return (obj.words, obj.widths, obj.woffs, obj.order)
            return (obj.view(np.int32),)

        def replay_fps(paths):
            objs = [stage_chunk(k, part)
                    for k, part in enumerate(chunks_of(paths))]
            for obj in objs:
                for a in _wire_arrays(obj):
                    _compiled_sum(a)  # compile untimed, no transfer
            t0 = time.perf_counter()
            handles = [_compiled_sum(a)(a)
                       for obj in objs for a in _wire_arrays(obj)]
            for h in handles:
                float(h)
            return batch / (time.perf_counter() - t0)

        rows = [("mixed", mixed, REPS), ("wav", wavs, 2),
                ("flac", flacs, 2), ("wavq", quiets, 2)]
        rows += [(fmt, corpus[fmt], 2 if fmt == "ogg" else 1)
                 for fmt in ("ogg", "opus", "mp3") if fmt in corpus]
        for name, paths, rounds in rows:
            probes.append(measure_wire_bw(16))
            shipped[0] = 0
            ser, sus = [], []
            for _ in range(rounds):
                ser.append(timed(pass_serial, paths))
                sus.append(timed(pass_sustained, paths))
            med_ser = statistics.median(ser)
            med_sus = statistics.median(sus)
            results[name] = {
                "serial": med_ser,
                "sustained": med_sus,
                "fps": max(med_ser, med_sus),
                "bits_per_sample": shipped[0] * 8.0
                / (2 * rounds * batch * n),
            }
            rep = replay_fps(paths)
            results[name]["replay"] = rep
            results[name]["pct_of_wire"] = max(med_ser, med_sus) / rep
    finally:
        io.shutdown()
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return results, probes, floor_bps


def bench_stream(rate=48000, blocks=(64, 256, 1024), n_iters=24):
    """Single-stream real-time margin of the synchronous host shell:
    one device round trip per completed frame — the per-block latency an
    LV2 host would see from StreamingRotator/the plugin directly.
    Returns {block: (median_ms_per_block, x_realtime)}."""
    from phaserotate_tpu.stream import StreamingRotator

    rng = np.random.default_rng(3)
    out = {}
    for block in blocks:
        rot = StreamingRotator(rate=rate, channels=1)
        x = rng.standard_normal(block).astype(np.float32)
        for _ in range(6):
            rot.process(x, 30.0)  # compile + warm
        # amortized: small blocks complete a frame only every
        # parsiz/block calls, so time the whole run, not per-call
        t0 = time.perf_counter()
        for _ in range(n_iters):
            rot.process(x, 30.0)
        dt = (time.perf_counter() - t0) / n_iters
        out[block] = (dt * 1e3, (block / rate) / dt)
    return out


def bench_stream_pipelined(rate=48000, block=256, depth=None,
                           n_iters=400):
    """Real-time margin of the dispatch pipeline (stream/host.py):
    readbacks always have ``depth`` frames of slack, so the per-block
    cost is enqueue + an already-landed host copy.  Depth is sized from
    the measured dispatch RTT (bridge.auto_pipeline_depth: extra
    latency ~RTT + 2 frames).
    Returns (x_realtime, extra_latency_ms, p99_ms, depth, rtt_ms)."""
    from phaserotate_tpu.bridge import (
        auto_pipeline_depth,
        measure_dispatch_rtt_stats,
    )
    from phaserotate_tpu.stream import StreamingRotator

    rtt_s, rtt_p99_s = measure_dispatch_rtt_stats()
    if depth is None:
        geom_parsiz = StreamingRotator(rate=rate, channels=1).geom.parsiz
        depth = auto_pipeline_depth(rtt_s, rate, geom_parsiz,
                                    rtt_p99_s=rtt_p99_s)
    rot = StreamingRotator(rate=rate, channels=1, pipeline_depth=depth)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(block).astype(np.float32)
    for _ in range(depth + 8):
        rot.process(x, 30.0)  # compile, warm, fill the pipeline
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        rot.process(x, 30.0)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    p99 = sorted(times)[min(len(times) - 1, int(0.99 * len(times)))]
    extra_ms = (rot.latency - rot.geom.latency) / rate * 1e3
    return ((block / rate) / med, extra_ms, p99 * 1e3, depth,
            rtt_s * 1e3)


def _spawn_daemon(sock, *extra_args):
    import subprocess
    import sys

    r, w = os.pipe()
    proc = subprocess.Popen(
        [sys.executable, "-m", "phaserotate_tpu.bridge", "--socket",
         sock, "--ready-fd", str(w), *extra_args],
        pass_fds=(w,), stderr=subprocess.DEVNULL,
        # the package must be importable regardless of the CALLER's
        # cwd (a bench driven from outside the repo otherwise kills
        # the daemon at -m resolution time)
        cwd=os.path.dirname(os.path.abspath(__file__)))
    os.close(w)
    if os.read(r, 1) != b"R":
        raise RuntimeError("bridge daemon failed to start")
    os.close(r)
    return proc


def bench_daemon(rate=48000, block=256, n_iters=300):
    """Round-trip latency through the engine daemon (socket protocol),
    auto-sized pipelining (--pipeline -1): what the LV2 shim /
    prt_bridge experiences per block.
    Returns (median_rtt_ms, x_realtime, p99_ms)."""
    import tempfile

    from phaserotate_tpu.bridge import BridgeClient

    sock = os.path.join(tempfile.mkdtemp(prefix="prtbench"), "engine.sock")
    proc = _spawn_daemon(sock, "--pipeline", "-1")
    try:
        cl = BridgeClient(sock, rate, 1)
        rng = np.random.default_rng(5)
        x = rng.standard_normal((1, block)).astype(np.float32)
        for _ in range(72):  # compile, warm, fill any auto-sized depth
            cl.process(x, 30.0)
        times = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            cl.process(x, 30.0)
            times.append(time.perf_counter() - t0)
        cl.close()
        med = statistics.median(times)
        p99 = sorted(times)[min(len(times) - 1, int(0.99 * len(times)))]
        return med * 1e3, (block / rate) / med, p99 * 1e3
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def bench_daemon_sessions(rate=48000, block=256, counts=(1, 2, 4, 8),
                          n_iters=200, slack=0):
    """Serving capacity: how many concurrent
    block-``block`` sessions one daemon serves, with cross-session
    batched dispatch (--batch-sessions) and auto-sized pipelining.

    Two criteria per count:
      * sustained — every session streams at >= 1x realtime over the
        whole run (sum of block times <= n x budget).  This is the
        serving-capacity question: the dispatch pipeline absorbs
        individual call stalls, so an occasional slow block does not
        underrun a stream that stays ahead overall.
      * p99 — every session meets its per-block DEADLINE at the 99th
        percentile when called at the real-time cadence.  A host's
        audio callback fires on the block grid (t0 + j*period) and the
        shim must return before the next grid point; the measurement
        paces each session on that grid and records completion
        lateness vs the deadline.  Pacing is what lets ``slack`` act:
        a reply requested ``slack`` calls ago has had slack whole
        block periods of wall time to land, not slack median-RTTs —
        an unpaced back-to-back loop (kept in the detail tuple as
        percall_p99) compresses those periods.  A round trip whose
        spikes exceed (slack+1) x period fails the paced bar.

    ``slack`` enables the client-side spike absorber: each client
    keeps that many PROC replies in flight, so a
    reply has ``slack`` extra block periods to land — the stream is
    identical, delayed by slack blocks (tests/test_bridge.py parity).

    Returns (max_sustained_sessions, max_p99_sessions,
             {n: (worst_sustained_xrt, worst_percall_p99_xrt,
                  worst_paced_p99_xrt)}) where paced_p99_xrt =
    budget / p99(deadline lateness) — >= 1 means 99% of blocks were
    delivered within one period of their grid deadline."""
    import tempfile
    import threading

    from phaserotate_tpu.bridge import BridgeClient

    sock = os.path.join(tempfile.mkdtemp(prefix="prtsess"), "engine.sock")
    proc = _spawn_daemon(sock, "--pipeline", "-1",
                         "--batch-sessions", str(max(counts)))
    budget = block / rate
    results = {}
    best_sustained = best_p99 = 0
    try:
        for n_sessions in counts:
            clients = [BridgeClient(sock, rate, 1, slack=slack)
                       for _ in range(n_sessions)]
            rng = np.random.default_rng(6)
            x = rng.standard_normal((1, block)).astype(np.float32)
            for cl in clients:
                for _ in range(72):
                    cl.process(x, 30.0)  # warm + fill pipelines
            stats = [None] * n_sessions

            def run(idx, cl):
                times = []
                for _ in range(n_iters):
                    t0 = time.perf_counter()
                    cl.process(x, 30.0)
                    times.append(time.perf_counter() - t0)
                total = sum(times)
                times.sort()
                p99 = times[min(len(times) - 1,
                                int(0.99 * len(times)))]
                stats[idx] = (n_iters * budget / total, budget / p99)

            threads = [threading.Thread(target=run, args=(i, cl))
                       for i, cl in enumerate(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

            # paced pass: the strict real-time criterion.  Each session
            # calls process() on its own block grid (t0 + j*budget) and
            # records completion lateness vs that grid — exactly what a
            # host callback experiences.  Lateness accumulates when a
            # session falls behind, so a stall that the slack window
            # cannot absorb shows up in p99 even if later calls are fast.
            paced = [None] * n_sessions

            def run_paced(idx, cl):
                late = []
                t0 = time.perf_counter() + budget
                for j in range(n_iters):
                    deadline = t0 + j * budget
                    now = time.perf_counter()
                    if now < deadline:
                        time.sleep(deadline - now)
                    cl.process(x, 30.0)
                    late.append(time.perf_counter() - deadline)
                late.sort()
                p99 = late[min(len(late) - 1, int(0.99 * len(late)))]
                paced[idx] = budget / max(p99, 1e-9)

            threads = [threading.Thread(target=run_paced, args=(i, cl))
                       for i, cl in enumerate(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for cl in clients:
                cl.close()
            worst_sus = min(s[0] for s in stats)
            worst_call = min(s[1] for s in stats)
            worst_paced = min(paced)
            results[n_sessions] = (round(worst_sus, 2),
                                   round(worst_call, 2),
                                   round(worst_paced, 2))
            # evaluate EVERY count: brokered sessions share dispatches,
            # so larger counts can pass where a smaller one failed
            if worst_paced >= 1.0:
                best_p99 = n_sessions
            if worst_sus >= 1.0:
                best_sustained = n_sessions
        return best_sustained, best_p99, results
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _device_of_a_fresh_process():
    """(platform, device_kind) as a short-lived JAX process sees them —
    asked in a child so this process has not initialized its backend
    when the daemon cells start."""
    import subprocess

    out = subprocess.run(
        [sys.executable, "-c", "import jax; d = jax.devices()[0]; "
         "print(d.platform); print(d.device_kind)"],
        capture_output=True, text=True, timeout=300, check=True)
    platform, kind = out.stdout.strip().splitlines()[-2:]
    return platform, kind


def _nvidia_smi():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()


def main():
    from phaserotate_tpu.core.plancache import enable_compile_cache

    enable_compile_cache()
    platform, kind = _device_of_a_fresh_process()
    if platform != "gpu":
        print(f"bench: needs an NVIDIA GPU; JAX's backend is {platform!r}",
              file=sys.stderr)
        sys.exit(2)
    smi = _nvidia_smi()
    _stage(f"start on {kind} ({smi})")
    # daemon cells first: the daemon subprocess owns the card
    rtt_ms, rtt_xrt, rtt_p99 = bench_daemon()
    _stage("daemon done")
    sess_rt, sess_rt_p99, sess_detail = bench_daemon_sessions()
    _stage(f"sessions done: {sess_rt} sustained / {sess_rt_p99} p99")
    # a typical mastering host runs 1024+ sample periods; slack=2 arms
    # the client-side spike absorber (two blocks of reply lookahead,
    # +42.7 ms latency — the budget the pipelined stream mode accepts)
    sess_rt_1k, sess_rt_1k_p99, sess_detail_1k = bench_daemon_sessions(
        block=1024, slack=2)
    _stage(f"sessions@1024 done: {sess_rt_1k} sustained / "
           f"{sess_rt_1k_p99} p99 (slack 2)")
    # in-process cells: this process holds the card from here on
    devices = jax.devices()
    rt, rot_batch = bench_rotate()
    _stage(f"rotate done: {rt:.0f}x @ batch {rot_batch}")
    fps = bench_search()
    _stage(f"search done: {fps:.0f} files/s")
    fps_e2e = bench_search_e2e()
    _stage(f"search inmem done: {fps_e2e:.0f} files/s")
    disk, wire_probes, floor_bps = bench_search_disk()
    wire_bw = statistics.median(wire_probes)
    _stage(f"search disk done: "
           f"{ {k: round(v['fps'], 1) for k, v in disk.items()} } "
           f"(wire probes {[round(p, 1) for p in wire_probes]} MB/s)")
    sync = bench_stream()
    _stage("stream sync done")
    (pipe_xrt, pipe_extra_ms, pipe_p99, pipe_depth,
     pipe_rtt_ms) = bench_stream_pipelined()
    _stage(f"stream pipelined done: depth {pipe_depth}")
    print(
        json.dumps(
            {
                "metric": "rotate_x_realtime_mono48k",
                "value": round(rt, 1),
                "unit": "x_realtime_per_card",
                # the binding fleet ratio is the ON-DISK number: read ->
                # decode -> sweep -> select from real files, best mode
                # per row; the in-memory figures show device headroom
                "vs_baseline": round(
                    min(rt / 1000.0, disk["mixed"]["fps"] / 100.0), 3),
                "search_files_per_s": round(fps, 1),
                "search_files_per_s_inmem": round(fps_e2e, 1),
                "search_files_per_s_disk": round(
                    disk["mixed"]["fps"], 1),
                "search_disk_fps": {
                    k: round(v["fps"], 1) for k, v in disk.items()},
                "search_disk_serial_fps": {
                    k: round(v["serial"], 1) for k, v in disk.items()},
                "search_disk_sustained_fps": {
                    k: round(v["sustained"], 1)
                    for k, v in disk.items()},
                # achieved wire bits/sample per row under the adaptive
                # transport (pcm16 = 16; packed engages when content
                # compresses below 0.9 x that)
                "search_disk_bits_per_sample": {
                    k: round(v["bits_per_sample"], 2)
                    for k, v in disk.items()},
                # host->device MB/s probes, interleaved with the rows
                "wire_bw_mb_s": round(wire_bw, 1),
                "wire_bw_probes_mb_s": [round(p, 1)
                                        for p in wire_probes],
                # each row's wire-only replay (same staged bytes,
                # transfer + readback only): row fps / replay fps is
                # the pipeline's share of its own transfer bound
                "search_disk_replay_fps": {
                    k: round(v["replay"], 1) for k, v in disk.items()},
                "search_disk_pct_of_wire": {
                    k: round(v["pct_of_wire"], 2)
                    for k, v in disk.items()},
                "search_disk_lossless_floor_bits_per_sample": round(
                    floor_bps, 2),
                # single-stream real-time margin: sync = one device
                # round trip per frame; pipelined = auto-sized dispatch
                # pipeline
                "stream_sync_ms_per_block": {
                    str(b): round(v[0], 2) for b, v in sync.items()},
                "stream_sync_xrt": {
                    str(b): round(v[1], 3) for b, v in sync.items()},
                "stream_pipelined_xrt_block256": round(pipe_xrt, 2),
                "stream_pipelined_p99_ms": round(pipe_p99, 2),
                "stream_pipeline_extra_latency_ms": round(
                    pipe_extra_ms, 1),
                "stream_pipeline_depth": pipe_depth,
                "stream_dispatch_rtt_ms": round(pipe_rtt_ms, 1),
                "daemon_rtt_ms_block256": round(rtt_ms, 2),
                "daemon_xrt_block256": round(rtt_xrt, 2),
                "daemon_rtt_p99_ms": round(rtt_p99, 2),
                # serving capacity: sustained = sessions streaming
                # >= 1x realtime end to end; p99 = every block within
                # its real-time deadline (paced clients — see
                # bench_daemon_sessions).  The xrt detail is
                # (sustained, unpaced percall_p99, paced deadline p99)
                # per count
                "daemon_sessions_at_rt": sess_rt,
                "daemon_sessions_at_rt_p99": sess_rt_p99,
                "daemon_sessions_xrt": sess_detail,
                "daemon_sessions_at_rt_block1024": sess_rt_1k,
                "daemon_sessions_at_rt_block1024_p99": sess_rt_1k_p99,
                "daemon_sessions_xrt_block1024": sess_detail_1k,
                "daemon_sessions_block1024_slack": 2,
                "rotate_batch": rot_batch,
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "device_count": len(devices),
                "nvidia_smi": smi,
                "reps": REPS,
                "iters": ITERS,
            }
        )
    )


if __name__ == "__main__":
    main()
