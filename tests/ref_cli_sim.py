"""Independent numpy simulator of the reference CLI's analysis/apply loop.

A deliberately *literal* float32 re-derivation of the serial block-by-block
algorithm (PhaseRotateProc / PhaseRotate, cli/phase-rotate.cc:125-485),
used as the parity oracle for the batched device sweep.  Slow by construction;
tests keep inputs small.
"""

from __future__ import annotations

import numpy as np

SUBSAMPLE = 2
MAXSAMPLE = 180 * SUBSAMPLE


def sincos_lut():
    mp = 2.0 * np.pi / SUBSAMPLE / -360.0
    idx = np.arange(MAXSAMPLE)
    return (
        np.sin(mp * idx).astype(np.float32),
        np.cos(mp * idx).astype(np.float32),
    )


class RefProc:
    """PhaseRotateProc (cli/phase-rotate.cc:125-245) in numpy float32."""

    def __init__(self, blksiz: int):
        self.parsiz = blksiz
        self.fftlen = 2 * blksiz
        self.firlen = blksiz // 2
        # FIR design (cli/phase-rotate.cc:144-164): spec j*(-1)^k over
        # firlen+1 bins, c2r of size parsiz, Hann windowed; all FFTW
        # normalizations reduce to irfft * hann (see core/fir.py).
        k = np.arange(self.firlen + 1)
        spec = 1j * np.where(k & 1, -1.0, 1.0)
        fir = np.fft.irfft(spec, n=self.parsiz)
        n = np.arange(self.parsiz)
        hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / self.parsiz))
        fir = (fir * hann).astype(np.float32)
        self.ffir = np.fft.rfft(
            np.concatenate([fir, np.zeros(self.parsiz, np.float32)])
        )

    def hilbert(self, tdc: np.ndarray, out: np.ndarray, o_out: np.ndarray):
        """cli/phase-rotate.cc:181-212. tdc: (fftlen,) [prev, cur]."""
        parsiz = self.parsiz
        out[:] = o_out  # copy end/overlap of prev iFFT
        time_data = np.concatenate(
            [tdc[parsiz:], np.zeros(parsiz, np.float32)]
        )
        freq = np.fft.rfft(time_data) * self.ffir
        y = np.fft.irfft(freq, n=self.fftlen).astype(np.float32)
        out += y[:parsiz]
        o_out[:] = y[parsiz:]

    def rotate(self, tdc, out, a, sin_t, cos_t):
        """cli/phase-rotate.cc:214-225."""
        sa, ca = sin_t[a], cos_t[a]
        fin = tdc[self.firlen : self.firlen + self.parsiz]
        out[:] = (ca * fin + sa * out).astype(np.float32)


class RefRotate:
    """PhaseRotate analysis/apply (cli/phase-rotate.cc:251-485)."""

    def __init__(self, blksiz: int, n_chn: int):
        self.proc = [RefProc(blksiz) for _ in range(n_chn)]
        self.n_chn = n_chn
        self.parsiz = blksiz
        self.sin_t, self.cos_t = sincos_lut()
        self.reset()

    def reset(self):
        p = self.parsiz
        self.buf_old = [np.zeros(p, np.float32) for _ in range(self.n_chn)]
        self.buf_olp = [np.zeros(p, np.float32) for _ in range(self.n_chn)]
        self.peak = np.zeros((self.n_chn, MAXSAMPLE), np.float32)

    def analyze_block(self, block, ang_start, ang_end, ang_stride,
                      chn=-1, start=False):
        """thr_process per channel (cli/phase-rotate.cc:389-429).
        block: (n_chn, parsiz) deinterleaved float32."""
        parsiz = self.parsiz
        firlen = parsiz // 2
        chans = range(self.n_chn) if chn < 0 else [chn]
        for c in chans:
            tdc = np.concatenate([self.buf_old[c], block[c]])
            self.buf_old[c] = tdc[parsiz:].copy()
            hil = np.empty(parsiz, np.float32)
            self.proc[c].hilbert(tdc, hil, self.buf_olp[c])
            angle = ang_start
            while angle <= ang_end:
                a = (angle + MAXSAMPLE) % MAXSAMPLE
                if angle == 0:
                    pk = np.abs(self.buf_old[c]).max()
                else:
                    if start:
                        b0 = tdc[firlen : firlen + firlen]
                        b1 = hil[firlen : firlen + firlen]
                    else:
                        b0 = tdc[firlen : firlen + parsiz]
                        b1 = hil
                    sa, ca = self.sin_t[a], self.cos_t[a]
                    x = (ca * b0 + sa * b1).astype(np.float32)
                    pk = np.abs(x).max()
                self.peak[c][a] = max(self.peak[c][a], np.float32(pk))
                angle += ang_stride
                if angle >= ang_end:
                    break

    def analyze_file(self, audio, ang_start, ang_end, ang_stride, chn=-1):
        """analyze_file (cli/phase-rotate.cc:565-587): silence-pad short
        reads, one trailing zero block.  audio: (n_chn, n)."""
        parsiz = self.parsiz
        n = audio.shape[1]
        start = True
        pos = 0
        while pos < n:
            blk = np.zeros((self.n_chn, parsiz), np.float32)
            m = min(parsiz, n - pos)
            blk[:, :m] = audio[:, pos : pos + m]
            self.analyze_block(blk, ang_start, ang_end, ang_stride, chn, start)
            start = False
            pos += parsiz
        self.analyze_block(
            np.zeros((self.n_chn, parsiz), np.float32),
            ang_start, ang_end, ang_stride, chn, False,
        )

    def apply_file(self, audio, angle_units):
        """apply path incl. latency skip and tail flush
        (cli/phase-rotate.cc:447-485, 963-1001). audio: (n_chn, n)."""
        parsiz = self.parsiz
        latency = parsiz // 2
        n = audio.shape[1]
        outs = []
        written = 0
        off = latency
        pad = 0
        pos = 0
        while pos < n:
            m = min(parsiz, n - pos)
            blk = np.zeros((self.n_chn, parsiz), np.float32)
            blk[:, :m] = audio[:, pos : pos + m]
            nn = m
            if m < latency:
                pad = latency - m
                nn = m + pad
            out = self._apply_block(blk, angle_units)
            nn -= off
            outs.append(out[:, off : off + nn])
            off = 0
            pos += parsiz
        nrem = latency - pad
        if nrem > 0:
            out = self._apply_block(
                np.zeros((self.n_chn, parsiz), np.float32), angle_units
            )
            outs.append(out[:, :nrem])
        return np.concatenate(outs, axis=1)

    def _apply_block(self, blk, angle_units):
        parsiz = self.parsiz
        out = np.empty((self.n_chn, parsiz), np.float32)
        for c in range(self.n_chn):
            tdc = np.concatenate([self.buf_old[c], blk[c]])
            self.buf_old[c] = tdc[parsiz:].copy()
            a = (angle_units[c] + MAXSAMPLE) % MAXSAMPLE
            self.proc[c].hilbert(tdc, out[c], self.buf_olp[c])
            self.proc[c].rotate(tdc, out[c], a, self.sin_t, self.cos_t)
        return out


class RefPlugin:
    """The PLUGIN's streaming run loop (src/phaserotate.c:538-772) in
    numpy float32 — the independent oracle for the streaming engine
    (round-4 verdict #7): host-block-size-independent offset/overlap
    bookkeeping, the per-sample angle interpolation ramp with the
    ``parsiz * 1e-6`` rate clamp and +/-180 wrap (:673-709), and the
    full meter chain including the blocks < latency delay-line memmove
    edge (:576-591).  One channel; audio out + per-run meter levels.
    """

    def __init__(self, rate: int, delay_shift: str = "memmove"):
        # delay_shift selects the blocks < latency/2 delay-line shift
        # semantics (src/phaserotate.c:576-591): "memmove" = the
        # reference's documented #if 0 intent (what the framework
        # implements); "as_shipped" = the shipped ov > n fallback loop
        # with its index typo (:585-588 writes buf_dly[n_samples], not
        # [n_samples + i]) — used by test_ref_plugin_binary.py to pin
        # the compiled reference binary bit-for-bit.
        assert delay_shift in ("memmove", "as_shipped")
        self.delay_shift = delay_shift
        # sizing (src/phaserotate.c:278-297)
        if rate < 64000:
            self.fftlen, self.firlen = 512, 3072
        elif rate < 128000:
            self.fftlen, self.firlen = 1024, 4096
        else:
            self.fftlen, self.firlen = 2048, 8192
        self.rate = rate
        self.parsiz = self.fftlen // 2
        self.firlat = self.firlen // 2
        self.n_segm = self.firlen // self.parsiz
        self.interp_th = np.float32(self.parsiz * 1e-6)
        self.interp_nm = np.float32(1.0 / self.parsiz)
        self.latency = self.parsiz + self.firlat

        # FIR design (src/phaserotate.c:374-401): c2r of j*(-1)^i over
        # firlat+1 bins (FFTW unnormalized = irfft * firlen), scaled
        # 0.5/firlen, Hann'd, then each parsiz segment scaled
        # 0.5/parsiz and forward-transformed zero-padded to fftlen
        k = np.arange(self.firlat + 1)
        spec = 1j * np.where(k & 1, -1.0, 1.0)
        fir = np.fft.irfft(spec, n=self.firlen) * self.firlen
        i = np.arange(self.firlen)
        fir = (fir * (0.5 / self.firlen)
               * (1.0 - np.cos(2.0 * np.pi * i / self.firlen))
               ).astype(np.float32)
        norm = np.float32(0.5 / self.parsiz)
        self.freq_fir = [
            np.fft.rfft(np.concatenate([
                norm * fir[s * self.parsiz : (s + 1) * self.parsiz],
                np.zeros(self.parsiz, np.float32)]))
            for s in range(self.n_segm)]

        # channel state (channel_init/channel_reset, :137-167)
        self.buf_dly = np.zeros(self.latency, np.float32)
        self.buf_src = np.zeros(self.firlen, np.float32)
        self.buf_out = np.zeros(self.parsiz, np.float32)
        self.tail = np.zeros(self.parsiz, np.float32)  # time_data[parsiz:]
        self.offset = 0
        self.overlap = 0
        self.angle = np.float32(0.0)
        self.sa = np.float32(np.sin(0.0))
        self.ca = np.float32(np.cos(0.0))
        # meters (activate(): reset_delay starts at latency, :511-520)
        self.mtr_peak = [np.float32(0), np.float32(0)]
        self.mtr_momentary = [np.float32(0), np.float32(0)]
        self.mtr_holdcnt = [np.float32(0), np.float32(0)]
        self.mtr_diff = [np.float32(1), np.float32(1)]
        self.mtr_reset_delay = self.latency
        self.mtr_holdtme = np.float32(0.5 * rate + 0.5)
        self.mtr_falloff = np.float32(0)
        self.mtr_fpp = 0

    def _sin_cos(self, angle):
        two_pi = np.float32(2 * np.pi)
        return (np.float32(np.sin(np.float32(angle * two_pi))),
                np.float32(np.cos(np.float32(angle * two_pi))))

    def _meter_proc(self, peak, m):
        """src/phaserotate.c:451-471."""
        if not np.isfinite(peak):
            peak = np.float32(0)
        if peak > self.mtr_peak[m]:
            self.mtr_peak[m] = peak
        if peak > self.mtr_momentary[m]:
            self.mtr_momentary[m] = peak
            self.mtr_holdcnt[m] = self.mtr_holdtme
        elif self.mtr_holdcnt[m] > 0:
            self.mtr_holdcnt[m] = np.float32(
                self.mtr_holdcnt[m] - self.mtr_fpp)
        else:
            self.mtr_momentary[m] = np.float32(
                self.mtr_momentary[m] * self.mtr_falloff + 1e-20)
        return np.float32(peak)

    def run(self, block: np.ndarray, angle_deg: float):
        """One run() call: (n,) float32 in -> (n,) float32 out, plus the
        levels tuple (lvl_in, in_mom, in_peak, lvl_out, out_mom,
        out_peak, diff, diff_min, diff_max) the atom forge would carry
        (src/phaserotate.c:741-771)."""
        iobuf = np.array(block, np.float32)
        n = len(iobuf)
        parsiz, firlen, firlat = self.parsiz, self.firlen, self.firlat
        latency = self.latency

        # meter falloff constants (run(), :832-838)
        if self.mtr_fpp != n:
            tme = np.float32(n / self.rate)
            self.mtr_falloff = np.float32(
                10.0 ** np.float32(-0.05 * 15.0 * tme))
            self.mtr_fpp = n

        target = np.float32(angle_deg / -360.0)
        target = np.float32(min(max(target, -0.5), 0.5))

        # delayed input meter (:575-609) incl. the n < latency edge
        if n < latency:
            lvl_in = self._meter_proc(
                np.float32(np.max(np.abs(self.buf_dly[:n]))
                           if n else 0.0), 0)
            ov = latency - n
            # intended semantics: shift the delay line left by n (the
            # reference's #if 0 memmove, src/phaserotate.c:580).  The
            # shipped ov > n fallback loop has a typo (:585-588 writes
            # buf_dly[n_samples], not [n_samples + i], leaving
            # (n, ov) unshifted) — meter-display-only; the oracle and
            # the framework implement the documented intent by default,
            # and delay_shift="as_shipped" replicates the typo so the
            # compiled binary can be pinned exactly.
            if self.delay_shift == "memmove" or ov <= n:
                self.buf_dly[:ov] = self.buf_dly[n:].copy()
            else:
                self.buf_dly[:n] = self.buf_dly[n : 2 * n].copy()
                # the shipped loop's net effect: every iteration
                # rewrites index n; the last leaves buf_dly[ov-1]'s
                # old value there, and (n, ov) keeps stale data
                self.buf_dly[n] = self.buf_dly[ov - 1]
            self.buf_dly[ov:] = iobuf
        else:
            peak = np.float32(max(
                np.max(np.abs(self.buf_dly)) if latency else 0.0,
                np.max(np.abs(iobuf[: n - latency]))
                if n > latency else 0.0))
            self.buf_dly[:] = iobuf[n - latency :]
            lvl_in = self._meter_proc(peak, 0)

        # meter_delayed_reset (:497-509, 611)
        if self.mtr_reset_delay > 0:
            self.mtr_diff = [np.float32(1), np.float32(1)]
            self.mtr_momentary[1] = np.float32(0)
            self.mtr_reset_delay -= n
        if target != self.angle:
            self.mtr_reset_delay = latency + n

        # block loop (:615-725)
        out = np.empty(n, np.float32)
        pos = 0
        remain = n
        offset, overlap, angle = self.offset, self.overlap, self.angle
        while remain > 0:
            ns = min(parsiz - offset, remain)
            self.buf_src[offset + overlap : offset + overlap + ns] = \
                iobuf[pos : pos + ns]
            out[pos : pos + ns] = self.buf_out[offset : offset + ns]
            pos += ns
            offset += ns
            remain -= ns
            if offset == parsiz:
                offset = 0
                self.buf_out[:] = self.tail
                freq_sum = np.zeros(parsiz + 1, np.complex128)
                olp = overlap
                for s in range(self.n_segm):
                    seg = self.buf_src[olp : olp + parsiz]
                    olp -= parsiz
                    if olp < 0:
                        olp += firlen
                    freq_sum += np.fft.rfft(np.concatenate(
                        [seg, np.zeros(parsiz, np.float32)])) \
                        * self.freq_fir[s]
                y = np.fft.irfft(freq_sum, n=self.fftlen) * self.fftlen
                y = y.astype(np.float32)
                self.buf_out += y[:parsiz]
                self.tail = y[parsiz:].copy()

                off = overlap - firlat
                if off < 0:
                    off += firlen
                fin = self.buf_src[off : off + parsiz]
                if target != angle:
                    da = np.float32(target - angle)
                    if abs(da) > 0.5:
                        da = np.float32(da + 1.0 if da < 0 else da - 1.0)
                    da = np.float32(da * self.interp_nm)
                    final = 0
                    if da > self.interp_th:
                        da = self.interp_th
                    elif da < -self.interp_th:
                        da = np.float32(-self.interp_th)
                    else:
                        final = 1
                    for i in range(parsiz):
                        sa, ca = self._sin_cos(angle)
                        self.buf_out[i] = np.float32(
                            ca * fin[i] + sa * self.buf_out[i])
                        angle = np.float32(angle + da)
                    if final:
                        angle = target
                    if angle == target:
                        self.sa, self.ca = self._sin_cos(angle)
                else:
                    self.buf_out[:] = (self.ca * fin
                                       + self.sa * self.buf_out
                                       ).astype(np.float32)
                overlap = (overlap + parsiz) % firlen
        self.offset, self.overlap, self.angle = offset, overlap, angle

        # output meter + diff ratio (:728-739)
        lvl_out = self._meter_proc(
            np.float32(np.max(np.abs(out)) if n else 0.0), 1)
        lvl_diff = np.float32(1.0)
        if self.mtr_momentary[0] > 0.001 and self.mtr_momentary[1] > 0.001:
            lvl_diff = np.float32(
                self.mtr_momentary[1] / self.mtr_momentary[0])
            if lvl_diff < self.mtr_diff[0]:
                self.mtr_diff[0] = lvl_diff
            if lvl_diff > self.mtr_diff[1]:
                self.mtr_diff[1] = lvl_diff
        levels = (lvl_in, self.mtr_momentary[0], self.mtr_peak[0],
                  lvl_out, self.mtr_momentary[1], self.mtr_peak[1],
                  lvl_diff, self.mtr_diff[0], self.mtr_diff[1])
        return out, levels
