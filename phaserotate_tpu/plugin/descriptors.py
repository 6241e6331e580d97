"""Standalone-host port descriptors.

The framework's version of the generated JACK-wrapper tables
(lv2ttl/phaserotate_mono.h:7-35, phaserotate_stereo.h:7-38): static port
descriptions the standalone streaming host (hostapp.py) uses to wire a
plugin instance — mono 6 ports / stereo 9 ports, 8192-byte atom buffers,
latency at index 2.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .uris import PLUGIN_URI, PLUGIN_URI_STEREO

__all__ = ["PortDesc", "HostDescriptor", "PLUGIN_MONO", "PLUGIN_STEREO",
           "descriptor_for_channels"]

ATOM_BUFSIZ = 8192  # lv2ttl/phaserotate.h:4


@dataclasses.dataclass(frozen=True)
class PortDesc:
    index: int
    symbol: str
    kind: str  # "atom_in" | "atom_out" | "control_out" | "control_in" | "audio_in" | "audio_out"
    default: float = 0.0
    minimum: float = 0.0
    maximum: float = 0.0


def _ports(n_chn: int) -> Tuple[PortDesc, ...]:
    ports = [
        PortDesc(0, "control", "atom_in"),
        PortDesc(1, "notify", "atom_out"),
        PortDesc(2, "latency", "control_out", 0, 0, 8192),
    ]
    for c in range(n_chn):
        sfx = "" if n_chn == 1 else ("_L" if c == 0 else "_R")
        base = 3 + 3 * c
        ports += [
            PortDesc(base, f"angle{sfx}", "control_in", 0.0, -180.0, 180.0),
            PortDesc(base + 1, f"in{sfx}", "audio_in"),
            PortDesc(base + 2, f"out{sfx}", "audio_out"),
        ]
    return tuple(ports)


@dataclasses.dataclass(frozen=True)
class HostDescriptor:
    uri: str
    name: str
    n_channels: int
    atom_bufsiz: int
    latency_port: int
    ports: Tuple[PortDesc, ...]


PLUGIN_MONO = HostDescriptor(
    uri=PLUGIN_URI,
    name="Phase Rotate (GPU) Mono",
    n_channels=1,
    atom_bufsiz=ATOM_BUFSIZ,
    latency_port=2,
    ports=_ports(1),
)

PLUGIN_STEREO = HostDescriptor(
    uri=PLUGIN_URI_STEREO,
    name="Phase Rotate (GPU) Stereo",
    n_channels=2,
    atom_bufsiz=ATOM_BUFSIZ,
    latency_port=2,
    ports=_ports(2),
)


def descriptor_for_channels(n: int) -> HostDescriptor:
    if n == 1:
        return PLUGIN_MONO
    if n == 2:
        return PLUGIN_STEREO
    raise ValueError(f"unsupported channel count {n}")
