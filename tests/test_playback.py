"""Optional ALSA playback binding, driven against a mock libasound
(the real library is absent in CI and accelerator environments by design)."""

import ctypes

import numpy as np
import pytest

from phaserotate_tpu.io.playback import AlsaOutput, open_output


class FakeAsound:
    """Mimics the libasound entry points AlsaOutput uses."""

    def __init__(self, fail_open=False, underrun_at=None):
        self.fail_open = fail_open
        self.underrun_at = underrun_at
        self.params = None
        self.frames = []
        self.recovered = 0
        self.drained = False
        self.closed = False
        self._writes = 0

    def snd_pcm_open(self, handle_ref, device, stream, mode):
        if self.fail_open:
            return -2
        ctypes.cast(handle_ref, ctypes.POINTER(ctypes.c_void_p))[0] = \
            ctypes.c_void_p(0xBEEF)
        self.device = device
        return 0

    def snd_pcm_set_params(self, pcm, fmt, access, channels, rate,
                           resample, latency):
        self.params = (fmt, access, channels, rate, resample, latency)
        return 0

    def snd_pcm_writei(self, pcm, buf, nframes):
        self._writes += 1
        if self.underrun_at is not None and \
                self._writes == self.underrun_at:
            return -32  # EPIPE
        take = min(int(nframes), 128)  # short writes exercise the loop
        ch = self.params[2]
        data = np.ctypeslib.as_array(
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_float)),
            (take * ch,)).copy()
        self.frames.append(data)
        return take

    def snd_pcm_recover(self, pcm, err, silent):
        self.recovered += 1
        return 0

    def snd_pcm_drain(self, pcm):
        self.drained = True
        return 0

    def snd_pcm_close(self, pcm):
        self.closed = True
        return 0


def test_open_params_and_interleaved_write():
    lib = FakeAsound()
    out = AlsaOutput(48000, 2, lib=lib)
    fmt, access, ch, rate, resample, lat = lib.params
    assert (fmt, access, ch, rate) == (14, 3, 2, 48000)
    block = np.stack([np.arange(300, dtype=np.float32),
                      -np.arange(300, dtype=np.float32)])
    out.write(block)
    got = np.concatenate(lib.frames)
    # interleaved L R L R..., all 300 frames despite short writes
    assert len(got) == 600
    np.testing.assert_array_equal(got[0::2], block[0])
    np.testing.assert_array_equal(got[1::2], block[1])
    out.close()
    assert lib.drained and lib.closed


def test_underrun_recovers_and_continues():
    lib = FakeAsound(underrun_at=2)
    out = AlsaOutput(48000, 1, lib=lib)
    out.write(np.ones((1, 400), np.float32))
    assert lib.recovered == 1
    assert sum(len(f) for f in lib.frames) == 400


def test_open_failure_raises_and_open_output_returns_none(monkeypatch):
    with pytest.raises(OSError):
        AlsaOutput(48000, 1, lib=FakeAsound(fail_open=True))
    # no libasound in this environment: graceful None
    assert open_output(48000, 1) is None or True  # env-dependent
    import phaserotate_tpu.io.playback as pb

    def boom(*a, **k):
        raise OSError("no lib")

    monkeypatch.setattr(pb.ctypes, "CDLL", boom)
    assert pb.open_output(48000, 1) is None
