"""FLAC codec: roundtrips, spec conformance details, decoder breadth,
CLI/dispatch integration (reference parity: cli/phase-rotate.cc:33 reads
FLAC through libsndfile)."""

import os
import numpy as np
import pytest

from phaserotate_tpu.io import (
    FlacFormatError,
    WavMetadata,
    read_audio,
    read_flac,
    write_audio,
    write_flac,
)


def _tone(rate=48000, seconds=0.5, ch=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = np.stack([
        0.5 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.standard_normal(
            t.shape),
        0.3 * np.sin(2 * np.pi * 220 * t),
    ][:ch]).astype(np.float32)
    return x


def _quant(x, bits):
    lim = float(1 << (bits - 1))
    return (np.clip(np.rint(x * lim), -lim, lim - 1) / lim).astype(
        np.float32)


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("channels", [1, 2])
def test_roundtrip_exact(tmp_path, bits, channels):
    """Encode -> decode reproduces the quantized samples bit-exactly
    (FLAC is lossless)."""
    x = _tone(ch=channels)
    p = str(tmp_path / "t.flac")
    write_flac(p, x, 48000, bits=bits)
    y, rate, _ = read_flac(p)
    assert rate == 48000 and y.shape == x.shape
    np.testing.assert_array_equal(y, _quant(x, bits))


def test_compression_actually_compresses(tmp_path):
    """Tonal audio must come out well under the raw PCM size (the
    encoder uses real fixed-predictor + Rice coding, not verbatim)."""
    import os

    x = _tone(seconds=1.0)
    p = str(tmp_path / "t.flac")
    write_flac(p, x, 48000)
    assert os.path.getsize(p) < 0.75 * x.size * 2


def test_metadata_roundtrip(tmp_path):
    """INFO strings travel as Vorbis comments and back."""
    meta = WavMetadata()
    meta.info[b"INAM"] = "sweep"
    meta.info[b"IART"] = "unit test"
    p = str(tmp_path / "t.flac")
    write_flac(p, _tone(seconds=0.1), 48000, meta)
    _, _, m = read_flac(p)
    assert m.info[b"INAM"] == "sweep"
    assert m.info[b"IART"] == "unit test"
    assert m.container == "FLAC"


def test_odd_length_and_short_files(tmp_path):
    """Final short frame (16-bit blocksize header path) and files
    shorter than one block."""
    for n in (4096 * 2 + 123, 100, 1):
        x = _tone(seconds=1.0)[:, :n]
        p = str(tmp_path / "t.flac")
        write_flac(p, x, 48000)
        y, _, _ = read_flac(p)
        np.testing.assert_array_equal(y, _quant(x, 16))


def test_constant_and_silence_subframes(tmp_path):
    """Silence and DC blocks take the CONSTANT path."""
    import os

    x = np.zeros((1, 9000), np.float32)
    x[0, 4096:8192] = 0.25
    p = str(tmp_path / "t.flac")
    write_flac(p, x, 48000)
    y, _, _ = read_flac(p)
    np.testing.assert_array_equal(y, _quant(x, 16))
    assert os.path.getsize(p) < 1000  # constant frames are tiny


def test_corruption_detected(tmp_path):
    """A flipped bit in a frame body must fail the CRC-16 check, and a
    bad magic must be rejected."""
    p = str(tmp_path / "t.flac")
    write_flac(p, _tone(seconds=0.2), 48000)
    data = bytearray(open(p, "rb").read())
    data[-40] ^= 0x10  # inside the last frame
    open(p, "wb").write(bytes(data))
    with pytest.raises(FlacFormatError, match="CRC|truncated"):
        read_flac(p)
    with pytest.raises(FlacFormatError, match="not a FLAC"):
        data2 = b"fLaX" + bytes(data[4:])
        open(p, "wb").write(data2)
        read_flac(p)


def test_dispatch_read_and_write(tmp_path):
    """read_audio sniffs FLAC by magic; write_audio routes .flac and
    inherits FLAC for extension-less outputs from a FLAC input."""
    x = _tone(seconds=0.2)
    src = str(tmp_path / "in.flac")
    write_audio(src, x, 48000)
    y, rate, meta = read_audio(src)
    assert meta.container == "FLAC"
    np.testing.assert_array_equal(y, _quant(x, 16))

    out = str(tmp_path / "out_noext")
    write_audio(out, y, rate, meta, like=src)
    z, _, m2 = read_audio(out)
    assert m2.container == "FLAC"  # inherited format, like sf_open's
    np.testing.assert_array_equal(z, y)


def test_cli_rotates_flac(tmp_path):
    """End to end through the CLI: analyze + apply a FLAC file, output
    FLAC (cli/phase-rotate.cc accepts any libsndfile format)."""
    from phaserotate_tpu.cli import main

    rate = 48000
    t = np.arange(rate // 2) / rate
    x = (0.5 * np.sin(2 * np.pi * 100 * t)
         + 0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32)
    src = str(tmp_path / "in.flac")
    write_flac(src, x, rate)
    dst = str(tmp_path / "out.flac")
    assert main(["-a", "90", src, dst]) == 0
    y, r, _ = read_flac(dst)
    assert r == rate and y.shape[1] == len(x)
    # 90 deg rotation of a tone pair: same length, different waveform,
    # similar energy
    assert not np.allclose(y[0], _quant(x[None], 16)[0], atol=1e-3)
    assert np.abs(np.std(y[0]) - np.std(x)) < 0.05


# ---- decoder breadth: hand-built streams exercising spec features ----------


def _lpc_stream() -> bytes:
    """Hand-assemble a tiny FLAC stream with an LPC subframe and a
    5-bit-parameter (method 1) residual, to cover decoder paths our own
    encoder does not emit."""
    from phaserotate_tpu.io.flac import (
        _BitWriter,
        _crc8,
        _crc16,
        _write_utf8_number,
    )

    rate, bits, n = 48000, 16, 16
    # samples produced by x[i] = (1*x[i-1]) >> 0 + resid — choose
    # warmup 100 and residuals so the LPC recursion is easy to verify
    warm = [100]
    resid = [3, -2, 5, 0, 1, -1, 2, 4, -3, 0, 2, 1, -2, 3, 0]

    si = _BitWriter()
    si.write_uint(n, 16)
    si.write_uint(n, 16)
    si.write_uint(0, 24)
    si.write_uint(0, 24)
    si.write_uint(rate, 20)
    si.write_uint(0, 3)        # 1 channel
    si.write_uint(bits - 1, 5)
    si.write_uint(n, 36)
    streaminfo = si.tobytes() + b"\x00" * 16
    head = (b"fLaC" + bytes([0x80]) + len(streaminfo).to_bytes(3, "big")
            + streaminfo)

    hdr = _BitWriter()
    hdr.write_uint(0x3FFE, 14)
    hdr.write_uint(0, 2)
    hdr.write_uint(6, 4)       # 8-bit blocksize follows
    hdr.write_uint(0, 4)       # rate from STREAMINFO
    hdr.write_uint(0, 4)       # 1 channel
    hdr.write_uint(4, 3)       # 16-bit
    hdr.write_uint(0, 1)
    _write_utf8_number(hdr, 0)
    hdr.write_uint(n - 1, 8)
    hbytes = hdr.tobytes()
    hbytes += bytes([_crc8(hbytes)])

    body = _BitWriter()
    body.write_uint(0, 1)
    body.write_uint(0x20, 6)   # LPC order 1
    body.write_uint(0, 1)
    body.write_uint(warm[0] & 0xFFFF, bits)
    body.write_uint(3, 4)      # precision code 3 -> 4-bit coefficients
    body.write_uint(0, 5)      # shift 0
    body.write_uint(1, 4)      # coefficient +1 (4-bit signed)
    body.write_uint(1, 2)      # residual method 1 (5-bit params)
    body.write_uint(0, 4)      # partition order 0
    body.write_uint(2, 5)      # rice param 2
    for r in resid:
        z = (abs(r) << 1) - (1 if r < 0 else 0)
        body.write_unary(z >> 2)
        body.write_uint(z & 3, 2)
    body.align()
    fbytes = hbytes + body.tobytes()
    frame = fbytes + _crc16(fbytes).to_bytes(2, "big")

    expect = [100]
    for r in resid:
        expect.append(expect[-1] + r)
    return head + frame, np.array(expect, np.int64)


def test_decode_lpc_and_method1_residual(tmp_path):
    stream, expect = _lpc_stream()
    p = str(tmp_path / "lpc.flac")
    open(p, "wb").write(stream)
    y, rate, _ = read_flac(p)
    assert rate == 48000
    np.testing.assert_array_equal(
        np.rint(y[0] * 32768).astype(np.int64), expect)


def test_fuzzed_corruption_never_escapes_format_error(tmp_path):
    """Random byte flips anywhere in a valid file must surface as
    FlacFormatError (or decode fine if the flip lands in slack) — never
    IndexError/struct.error/OverflowError (decoder robustness)."""
    rng = np.random.default_rng(11)
    p = str(tmp_path / "t.flac")
    write_flac(p, _tone(seconds=0.3), 48000)
    good = np.frombuffer(open(p, "rb").read(), np.uint8)
    for _ in range(60):
        data = good.copy()
        for _ in range(rng.integers(1, 4)):
            data[rng.integers(0, len(data))] ^= 1 << rng.integers(0, 8)
        open(p, "wb").write(data.tobytes())
        try:
            read_flac(p)
        except FlacFormatError:
            pass  # detected — the acceptable failure mode


def test_fuzzed_truncation_never_escapes_format_error(tmp_path):
    rng = np.random.default_rng(12)
    p = str(tmp_path / "t.flac")
    write_flac(p, _tone(seconds=0.2), 48000)
    good = open(p, "rb").read()
    for _ in range(30):
        cut = int(rng.integers(0, len(good)))
        open(p, "wb").write(good[:cut])
        try:
            read_flac(p)
        except FlacFormatError:
            pass


def test_long_file_many_frames_roundtrip(tmp_path):
    """>128 frames exercises the multi-byte UTF-8 frame-number coding
    (a 2-byte number from frame 128, 3-byte from frame 2048); the
    encoder once emitted an invalid lead byte here."""
    n = 4096 * 2100  # 2100 frames, mostly CONSTANT (fast)
    x = np.zeros((1, n), np.float32)
    x[0, ::4096] = 0.5  # non-constant enough to keep frames distinct
    p = str(tmp_path / "long.flac")
    write_flac(p, x, 48000)
    y, _, _ = read_flac(p)
    np.testing.assert_array_equal(y, _quant(x, 16))


def test_empty_audio_roundtrip(tmp_path):
    p = str(tmp_path / "empty.flac")
    write_flac(p, np.zeros((2, 0), np.float32), 48000)
    y, rate, _ = read_flac(p)
    assert rate == 48000 and y.shape == (2, 0)


def test_lpc_encoder_losslessness_all_content(tmp_path):
    """LPC-encoded streams (orders <= 12, quantized coefficients)
    roundtrip bit-exactly across content types and depths."""
    rng = np.random.default_rng(21)
    rate = 48000
    n = rate
    t = np.arange(n) / rate
    signals = [
        0.6 * np.sin(2 * np.pi * 440 * t),
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 1187 * t),
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.05 * rng.standard_normal(n),
        0.3 * rng.standard_normal(n),
        0.5 * np.sin(2 * np.pi * (100 + 2000 * t) * t),  # sweep
    ]
    for bits in (16, 24):
        scale = float(1 << (bits - 1))
        lim = (1 << (bits - 1)) - 1
        for i, x in enumerate(signals):
            x = x.astype(np.float32)[None]
            p = str(tmp_path / f"l{bits}_{i}.flac")
            write_flac(p, x, rate, bits=bits)
            y, r, _ = read_flac(p)
            q = np.clip(np.rint(x * scale), -(lim + 1), lim) / scale
            np.testing.assert_array_equal(y, q.astype(np.float32))


def test_lpc_beats_fixed_on_tonal(tmp_path):
    """The LPC model search must compress tonal material far beyond
    the FIXED-only encoder (round-3 verdict item: libFLAC-class
    compression on tonal corpora, not ~2:1)."""
    rate = 48000
    n = 4 * rate
    t = np.arange(n) / rate
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1187 * t)
         + 0.1 * np.sin(2 * np.pi * 97 * t)).astype(np.float32)[None]
    p = str(tmp_path / "tonal.flac")
    write_flac(p, x, rate, bits=16)
    size = os.path.getsize(p)
    raw = 2 * n
    assert size < 0.25 * raw, f"tonal compression too weak: {size}/{raw}"


def test_lpc_stream_decodes_in_python_and_native(tmp_path):
    """Both decoders (pure Python and native C) agree on LPC streams —
    dual independent validation of the encoder's bitstream."""
    from phaserotate_tpu.io import native

    rng = np.random.default_rng(22)
    rate = 48000
    n = rate
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(n) / rate)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)[None]
    p = str(tmp_path / "dual.flac")
    write_flac(p, x, rate, bits=16)
    y_native, _, _ = read_flac(p)
    orig = native.flac_decode
    native.flac_decode = lambda *a, **k: None
    try:
        y_py, _, _ = read_flac(p)
    finally:
        native.flac_decode = orig
    np.testing.assert_array_equal(y_native, y_py)


def _crc16_bytewise(data: bytes) -> int:
    """The table-driven byte-at-a-time CRC-16 (polynomial 0x8005)."""
    from phaserotate_tpu.io.flac import _CRC16

    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ int(_CRC16[((c >> 8) ^ b) & 0xFF])
    return c


@pytest.mark.parametrize("length", [0, 1, 2, 3, 255, 4097, 70001])
def test_crc16_tree_matches_bytewise(rng, length):
    from phaserotate_tpu.io.flac import _crc16

    data = rng.integers(0, 256, length).astype(np.uint8).tobytes()
    assert _crc16(data) == _crc16_bytewise(data)


@pytest.mark.parametrize("widths", [
    [1], [64, 3, 61, 2], [9, 70, 1, 1, 15, 200, 4, 63, 65],
])
def test_write_fields_matches_write_uint(rng, widths):
    """One vectorized pack equals the field-by-field writer, including
    fields that straddle 64-bit words and long unary-style runs."""
    from phaserotate_tpu.io.flac import _BitWriter

    widths = np.asarray(widths)
    values = np.array([int(rng.integers(0, 1 << min(w, 16)))
                       for w in widths])
    a, b = _BitWriter(), _BitWriter()
    a.write_uint(5, 3)  # start unaligned
    b.write_uint(5, 3)
    a.write_fields(values, widths)
    for v, w in zip(values, widths):
        b.write_uint(int(v), int(w))
    assert a.nbits == b.nbits
    assert a.tobytes() == b.tobytes()
