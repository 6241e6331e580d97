"""Standalone streaming host.

The framework's counterpart of the x42 JACK wrapper (Makefile:250-257 +
lv2ttl/phaserotate_mono.h descriptors): hosts a plugin instance outside
any DAW, wiring its ports per plugin/descriptors.py, streaming a WAV file
through it in real-time-sized blocks, driving the UI protocol and showing
live terminal meters (gui/render.py).

    phase-rotate-host in.wav [out.wav] --angle 35 --block 256 --meters
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from .gui.client import UIClient
from .gui.render import render_channel
from .io import read_audio, write_audio
from .plugin.descriptors import descriptor_for_channels
from .plugin.lifecycle import PhaseRotatePlugin
from .plugin.uris import PortIndex

__all__ = ["main", "StandaloneHost"]


class StandaloneHost:
    """Owns one plugin instance with fully wired ports."""

    def __init__(self, rate: int, channels: int, block: int = 256,
                 pipeline: int = 0, device: int = 0, broker=None):
        if channels > 2:
            raise ValueError("standalone host supports mono or stereo")
        self.desc = descriptor_for_channels(channels)
        self.block = block
        options = {}
        if pipeline:
            options["pipeline"] = pipeline
        if device:
            options["device"] = device
        if broker is not None:  # cross-session batching (stream/broker)
            options["broker"] = broker
        self.plugin = PhaseRotatePlugin(
            self.desc.uri, rate, options=options or None)
        self.control: List = []
        self.notify: List = []
        self.latency = np.zeros(1, np.float32)
        self.angles = [np.zeros(1, np.float32) for _ in range(channels)]
        self.bufs = [np.zeros(block, np.float32) for _ in range(channels)]

        p = self.plugin
        p.connect_port(PortIndex.ATOM_CONTROL, self.control)
        p.connect_port(PortIndex.ATOM_NOTIFY, self.notify)
        p.connect_port(PortIndex.LATENCY, self.latency)
        for c in range(channels):
            base = 3 + 3 * c
            p.connect_port(base, self.angles[c])
            p.connect_port(base + 1, self.bufs[c])  # in-place pair
            p.connect_port(base + 2, self.bufs[c])
        p.activate()
        self.ui = UIClient(p)

    def set_angles(self, degrees) -> None:
        for c, a in enumerate(np.broadcast_to(degrees, (len(self.angles),))):
            self.angles[c][0] = float(a)

    def process(self, x: np.ndarray) -> np.ndarray:
        """Push one (channels, block) chunk through the plugin."""
        n = x.shape[-1]
        for c in range(len(self.bufs)):
            self.bufs[c][:n] = x[c]
        self.plugin.run(n)
        return np.stack([b[:n].copy() for b in self.bufs])


def main(argv: Optional[List[str]] = None) -> int:
    from .core.plancache import enable_compile_cache
    from .utils.platform import apply_platform_env

    apply_platform_env()
    enable_compile_cache()
    ap = argparse.ArgumentParser(
        prog="phase-rotate-host",
        description="Standalone streaming host for the GPU phase rotator.")
    ap.add_argument("infile")
    ap.add_argument("outfile", nargs="?")
    ap.add_argument("--angle", "-a", type=float, default=0.0,
                    help="rotation angle in degrees")
    ap.add_argument("--block", "-b", type=int, default=256,
                    help="host block size (any value, like a JACK period)")
    ap.add_argument("--meters", action="store_true",
                    help="live terminal meters while processing")
    ap.add_argument("--realtime", action="store_true",
                    help="pace processing at 1x realtime")
    ap.add_argument("--play", action="store_true",
                    help="monitor through ALSA if available (implies "
                         "--realtime pacing; falls back to silent "
                         "pacing without a sound stack)")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="dispatch-pipeline depth in frames (adds "
                         "N*parsiz latency, hides device round-trip)")
    ap.add_argument("--web", type=int, default=None, metavar="PORT",
                    help="serve the browser GUI (gui/web.py) on this "
                         "port while processing (0 = pick a free port)")
    ap.add_argument("--ui", action="store_true",
                    help="interactive terminal UI: turn the dial while "
                         "the audio streams (loops the file; q quits)")
    args = ap.parse_args(argv)

    audio, rate, meta = read_audio(args.infile)
    channels = min(audio.shape[0], 2)
    audio = audio[:channels]
    host = StandaloneHost(rate, channels, args.block,
                          pipeline=args.pipeline)
    host.set_angles(args.angle)

    webui = None
    if args.web is not None:
        from .gui.web import HostSurface, WebUI

        surface = HostSurface(host)
        webui = WebUI(lambda: {"0": surface}, port=args.web).start()
        print(f"web UI: {webui.url}", file=sys.stderr)

    if args.ui:
        from .tui import run_tui

        for c in range(channels):
            host.ui.dials[c].set_value(args.angle)
        ui_outs, played = run_tui(host, audio, rate, args.block,
                                  loop=args.outfile is None)
        if args.outfile:
            lat = int(host.latency[0])
            block = args.block
            for _ in range(-(-lat // block)):
                ui_outs.append(
                    host.process(np.zeros((channels, block), np.float32)))
            stream = np.concatenate(ui_outs, axis=1)
            # the user may quit mid-file: write (and report) exactly the
            # frames that were played — neither a silently-truncated
            # "full" file nor trailing flush silence counted as audio
            n = min(played, max(0, stream.shape[1] - lat))
            write_audio(args.outfile, stream[:, lat : lat + n], rate,
                        meta, like=args.infile)
            suffix = "" if n == audio.shape[1] else \
                f" — stopped early, {audio.shape[1] - n} frames not played"
            print(f"wrote {args.outfile} ({n} frames, latency {lat} "
                  f"compensated){suffix}")
        return 0
    if args.meters:
        host.ui.open()

    playback = None
    if args.play:
        from .io.playback import open_output

        playback = open_output(rate, channels)
        if playback is None:
            print("no ALSA sound stack: pacing without audio output",
                  file=sys.stderr)
            args.realtime = True

    n = audio.shape[1]
    outs = []
    block = args.block
    t_start = time.perf_counter()
    for pos in range(0, n, block):
        chunk = np.zeros((channels, block), np.float32)
        m = min(block, n - pos)
        chunk[:, :m] = audio[:, pos : pos + m]
        outs.append(host.process(chunk))
        if playback is not None:
            playback.write(outs[-1])  # blocking write paces the loop
        if args.meters:
            host.ui.poll()
            if (pos // block) % 16 == 0:
                rows = [
                    render_channel(host.ui.meters[c], f"ch{c}")
                    for c in range(channels)
                ]
                sys.stdout.write("\x1b[H\x1b[2J" + "\n".join(rows) + "\n")
                sys.stdout.flush()
        if args.realtime:
            elapsed = time.perf_counter() - t_start
            due = (pos + block) / rate
            if due > elapsed:
                time.sleep(due - elapsed)

    if args.meters:
        host.ui.close()
        # drain the ui_off handshake with one more (captured!) block — the
        # plugin state advances, so the output must stay in the stream or
        # the written file is spliced (round-1 advisor finding).
        outs.append(host.process(np.zeros((channels, block), np.float32)))

    if args.outfile:
        # compensate plugin latency like the offline CLI write path: flush
        # enough zero blocks, keep the continuous output stream, trim
        lat = int(host.latency[0])
        for _ in range(-(-lat // block)):
            outs.append(host.process(np.zeros((channels, block), np.float32)))
        stream = np.concatenate(outs, axis=1)
        full = stream[:, lat : lat + n]
        write_audio(args.outfile, full, rate, meta, like=args.infile)
        print(f"wrote {args.outfile} ({n} frames, latency {lat} compensated)")
    if playback is not None:
        playback.close()
    if webui is not None:
        webui.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
