"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--report PATH]

1. Builds the port's CUDA kernels (dss_tpu_torch/csrc) with nvcc.
2. Holds each kernel against its plain PyTorch version on the card:
   log power (K1) at the packet shapes and at [20000, 64], atol 1e-5;
   the packet front-end kernel (``filter_log_power``: 16-section IIR
   cascade + warm-start framing + log power in one launch) with the
   deployed filters at 64 channels, for a 40-sample packet with its
   40-row carry, 2 / 4 / 8 coalesced packets, a 10-sample packet, a short
   first packet with a 20-row zero carry and a 20000-sample trial with
   none (section states and carried rows bit for bit, features atol 1e-5),
   then over a 16 s, 129 -> 64-channel session packet by packet through
   ``HighGammaExtractor.packet_step`` against the same through the plain
   version; it is timed at T = 40 and 320 by ``torch.profiler`` kernel
   records and by events over back-to-back wrapper calls, beside the same
   kernel with the whole cascade on one warp (the design it is measured
   against, which must give the same bits) and an empty kernel launched
   through the same ctypes path (the launch floor), with the SM clock
   sampled by nvidia-smi;
   the LPCNet sampler kernel at bunch 1 (K2: ``sampler_frames``) greedy
   over two full-width frames (identical excitations, atol 1e-5), and
   stochastic over one 50-frame block on the same noise (first divergence
   after the first frame, RMS within 1 dB); the same kernel at bunch 2, 4
   and 8 (K3: ``sampler_frames_bunched``) greedy over two full-width
   frames of the shipped b2/b4/b8 checkpoints at one stream and of b4 at
   eight (identical excitations, atol 1e-5), and stochastic over one
   50-frame block of each of those four cases (K2's rule), timed per block.
   Through the kernel a 100-frame call must equal two 50-frame calls bit
   for bit, at bunch 1 and bunch 8.  A sampler's bound counts the gathered
   tables at the distinct rows the block's data reads.
   The DSP vocoder's sample loop (D1: ``dsp_synthesis``, no TPU kernel
   behind it) on seeded features with voiced and unvoiced frames and
   periods 32-256, at one stream x 260 frames (a word), eight x 50 and one
   x 1, against its plain version run on the CPU: pcm and carried state bit
   for bit; through the vocoder 100 frames must equal 50 + 50 bit for bit;
   timed per 260-frame word by torch.profiler and events beside an empty
   launch, with its bound and the serial chain's estimate.
3. Drives the port's online word path twice, with the shipped
   weights/vocoder_speech.npz (bunch 1, K2) and with
   weights/vocoder_speech_b8.npz (bunch 8, K3): a 16 s, 129-channel
   synthetic session (three loud bursts) replayed in 40-sample packets at
   real time through FusedFrontendVad -> FusedDecoderVocoder in the
   port's graph, with a threshold-VAD checkpoint and a seeded 2 x 100
   decoder; every burst must close a segment and each word's int16 PCM
   must hold frames x 160 finite samples.  The kernels' launch counts are
   zeroed just before each run and read just after it: the front-end
   kernel must launch once per packet call (and once per warmed call
   size), and the eager cascade must not run on a CUDA tensor.  After each
   run the packet step is split (host clock, synchronized): copy +
   pre-transforms, the front-end kernel, post-transform + nVAD + read-back.
   The shipped configuration, config/debug_settings.ini (vocoder_backend
   = dsp, fused_* = auto), twice on the same session in real time: as it
   resolves on cuda (FusedFrontendVad -> RecurrentNeuralDecodingModel ->
   DelayedLPCNetVocoder(dsp); asserted), then with both fused_* switches
   false (HighGammaActivity -> FilterSpeechSegments -> the same word
   path), each through the app's own Neuroprosthesis with a PacketReplay
   source and its real loggers and stdout sink: three segments, each
   word's wav and the stdout PCM frames x 160 int16 samples, the
   front-end kernel launched once per packet call plus its warm-up calls,
   D1 once per word, and neither the eager cascade nor D1's plain loop on
   a CUDA tensor.
   Then the offline entries: dss_tpu_torch.apps.synthesize on a seeded
   [300, 20] feature file with the b4 checkpoint and with its default
   dsp backend (wavs of 48000 int16 samples), and BatchedLPCNet(batch=8).
   Then the training path: three synthetic keyword days of 12 three-second
   trials (129 channels at 1 kHz, 16 kHz audio) with their
   SyllableRepetition normalization recordings (tests/torch_days.py; the
   first day flags bad and contaminated channels), prepared on the card by
   dss_tpu_torch.apps.prepare_corpus (the front-end kernel launched once
   per trial extraction at 128 channels, the eager cascade never on a CUDA
   tensor, BadChannelCorrection on a CUDA tensor once per extraction of
   the flagged day; written as HDF files when h5py imports, else kept in
   memory),
   one whole trial [3040, 128] held against the plain version (state bit
   for bit, features atol 1e-5) and timed; the nVAD (2 x 150, TBPTT 50)
   and the decoder (2 x 100 bidirectional) trained by their apps at
   dropout 0.5 for two epochs each (finite losses; the decoder app's
   synthesis queue launches D1 once per job, each wav frames x 160
   samples); 30 passes over one trial, whose loss must fall, with the
   TBPTT chunk step and the decoder step timed by events (the step with
   host lengths and with the mask on the card); a queue job timed; the
   card-trained checkpoints read by the online loader and the decoder's
   prediction vocoded; then the audio scored on
   tools/make_speech_corpus.py --seconds 4 --seed 777 with the JAX
   package's gates: the DSP vocoder CD < 22 dB, vocoder_speech.npz and
   vocoder_speech_b8.npz each CD < 6 dB, STOI >= 0.70 and keyword ID
   >= 0.75.
4. Prints the kernels' line, latencies, the card's name and power limit,
   and last `{"ok": true, "device": {...}}`.  Any failure exits non-zero
   without that line.  ``--report PATH`` also writes every measurement
   as JSON.

Imports torch, numpy and scipy only (no jax, nothing of dss_tpu).
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, data sheet
H100_BOOST_HZ = 1.98e9       # SM boost clock, H100 SXM data sheet


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, reps: int, key: str):
    """(device ms per kernel record whose name holds ``key``, records) over
    ``reps`` calls of ``fn`` under torch.profiler; (None, 0) when the
    profiler shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if key in e.key:
            t = getattr(e, "device_time_total", None)
            total += t if t is not None else getattr(e, "cuda_time_total", 0)
            count += e.count
    return (total / count / 1e3 if count and total > 0 else None), count


def session(seconds=16.0, bursts=((2.0, 3.5), (7.0, 8.5), (12.0, 13.5)),
            seed=7):
    """The synthetic session of tools/make_verify_fixtures.py (6 s, one
    loud burst at 2.0-3.5 s), continued with two more bursts so that a run
    also shows word heads after the first: its first 6 s are that
    fixture's samples."""
    fs = 1000
    rng = np.random.default_rng(seed)
    T = int(seconds * fs)
    envelope = np.full(T, 0.05)
    for start, stop in bursts:
        envelope[int(start * fs):int(stop * fs)] = 2.0
    return rng.normal(size=(T, 129)) * envelope[:, None]


def threshold_vad():
    """tools/make_verify_fixtures.py's threshold VAD as a 2 x 150 LSTM
    state_dict: speech iff mean(feature) > -2.5."""
    H, IN, s, theta = 150, 64, 10.0, -2.5
    sd = {}
    for layer, in_size in ((0, IN), (1, H)):
        w_ih = np.zeros((4 * H, in_size), np.float32)
        b_ih = np.zeros(4 * H, np.float32)
        b_ih[0:H], b_ih[H:2 * H], b_ih[3 * H:] = 10.0, -10.0, 10.0
        if layer == 0:
            w_ih[2 * H, :] = s / IN
            b_ih[2 * H] = -s * theta
        else:
            w_ih[2 * H, 0] = s
        sd[f"lstm.weight_ih_l{layer}"] = w_ih
        sd[f"lstm.weight_hh_l{layer}"] = np.zeros((4 * H, H), np.float32)
        sd[f"lstm.bias_ih_l{layer}"] = b_ih
        sd[f"lstm.bias_hh_l{layer}"] = np.zeros(4 * H, np.float32)
    cls_w = np.zeros((2, H), np.float32)
    cls_w[0, 0], cls_w[1, 0] = -5.0, 5.0
    sd["classifier.weight"] = cls_w
    sd["classifier.bias"] = np.zeros(2, np.float32)
    return sd


def gathered_rows(S, carry, lpc, sig):
    """(rows of the fused GRU-A tables, rows of the correction tables) that
    one sampler call gathers, counted once each over all streams:
    recomputed from the call's initial carry, its LPC taps [T, B, P] and
    its output samples [B, T*F].  The prediction is re-summed here and the
    excitation is taken as encode(sample - prediction), so a sample that
    was clipped, or a prediction that rounds onto a level's edge, may name
    a neighbouring row; the count of distinct rows is what is used."""
    from dss_tpu_torch.vocoder.mulaw import mulaw_encode
    _, _, sig_mem0, exc0 = carry
    B, N = sig.shape
    P = sig_mem0.shape[1]
    F = N // lpc.shape[0]
    full = torch.cat([sig_mem0.flip(1), sig], dim=1)        # oldest first
    taps = lpc.transpose(0, 1).repeat_interleave(F, dim=1)  # [B, N, P]
    # pred[n] = -sum_k lpc[k] * sample[n - 1 - k]
    pred = -(full.unfold(1, P, 1)[:, :N].flip(2) * taps).sum(-1)
    s_idx = mulaw_encode(full)                              # sample n at P + n
    p_idx = mulaw_encode(pred)
    e_idx = torch.cat([exc0.long().reshape(B, -1).flip(1),
                       mulaw_encode(sig - pred)], dim=1)    # exc n at S + n
    n0 = torch.arange(0, N, S, device=sig.device)           # step starts

    def distinct(x):
        return int(torch.unique(x).numel())

    emb = distinct(p_idx[:, n0])
    corr = 0
    for j in range(S):
        emb += distinct(s_idx[:, P + n0 - 1 - j])
        emb += distinct(e_idx[:, S + n0 - 1 - j])
    for j in range(1, S):
        corr += distinct(e_idx[:, S + n0 + j - 1])
        corr += distinct(p_idx[:, n0 + j])
    return emb, corr


def device_split(fn):
    """One call of ``fn`` under torch.profiler after a warm call: (host
    wall ms with a synchronize, device ms summed over its kernel records,
    kernel count, the three kernels with the most device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    busy = sum(sum(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:3]
    return dict(wall_ms=wall, device_ms=busy,
                kernels=sum(len(v) for v in by_name.values()),
                top=[(name[:60], len(v), sum(v)) for name, v in top])


def pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


class Phases:
    """Runs each phase, records failures, and lets later phases run."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            print(f"[phase] {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            return out
        except Exception:  # a failed phase is reported, then exit non-zero
            traceback.print_exc()
            print(f"[phase] {name}: FAILED", flush=True)
            self.failed.append(name)
            return None


def main(report_path=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from dss_tpu_torch.device import resolve_device
    from dss_tpu_torch.ops import _cuda
    from dss_tpu_torch.ops import filter_log_power as flp_mod
    from dss_tpu_torch.ops import filters as filters_mod
    from dss_tpu_torch.ops import hga as hga_mod
    from dss_tpu_torch.ops.filter_log_power import filter_log_power, \
        filter_log_power_plain
    from dss_tpu_torch.ops.filters import sosfilt_scan
    from dss_tpu_torch.ops.log_power import log_power, log_power_plain
    from dss_tpu_torch.ops.sampler import kernel_plan, \
        prepare_sampler_weights, sampler_frames, sampler_frames_bunched, \
        sampler_frames_bunched_plain, sampler_frames_plain, \
        tile_sparse_pattern
    from dss_tpu_torch.vocoder import net as tnet
    from dss_tpu_torch.vocoder.lpc import bands_from_cepstrum, lpc_from_bands
    from dss_tpu_torch.vocoder.lpcnet import _load_params
    from dss_tpu_torch.vocoder.mulaw import MULAW_LEVELS

    dev = resolve_device("cuda")
    ph = Phases()
    report = {"kernels": {}, "main_path": {}}

    def build():
        t0 = time.perf_counter()
        path = _cuda.build()
        _cuda.library()
        report["build_s"] = time.perf_counter() - t0
        log = (path.parent / "build.log").read_text()
        print("\n".join(l for l in log.splitlines()
                        if "Used" in l or "==" in l or "error" in l))
    ph.run("build kernels", build)

    # ---- K1: log power ------------------------------------------------------
    def k1():
        g = torch.Generator().manual_seed(0)
        worst = 0.0
        for rows in (80, 120, 200, 360, 20000):
            x = torch.randn((rows, 64), generator=g).to(dev)
            W = (rows - 50) // 10 + 1
            starts = np.arange(W) * 10
            got = log_power(x, starts, 50)
            want = log_power_plain(x, 10, 50, W)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not err <= 1e-5:
                raise AssertionError(f"K1 [{rows},64]: max err {err}")
        x = torch.randn((80, 64), generator=g).to(dev)   # one packet
        starts = np.arange(4) * 10
        ms = cuda_ms(lambda: log_power(x, starts, 50), 200)
        plain = cuda_ms(lambda: log_power_plain(x, 10, 50, 4), 200)
        nbytes = (80 * 64 + 4 * 64) * 4
        flops = 4 * 64 * (2 * 50 + 2)
        bound = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
        xb = torch.randn((20000, 64), generator=g).to(dev)
        sb = np.arange(1996) * 10
        ms_big = cuda_ms(lambda: log_power(xb, sb, 50), 50)
        report["kernels"]["log_power"] = dict(
            max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S
            > flops / H100_F32_FLOPS else "operations",
            ms_20000x64=ms_big,
            bound_ms_20000x64=(20000 + 1996) * 64 * 4 / H100_BYTES_PER_S * 1e3)
    ph.run("K1 log power vs plain", k1)

    # ---- the packet front-end kernel (K1 fused with the cascade) -------------
    from dss_tpu_torch.apps.decode_online import feature_transforms
    from dss_tpu_torch.ops.hga import HighGammaExtractor
    fe_ex = HighGammaExtractor(fs=1000, nb_electrodes=64, device=dev)
    fe = report["kernels"]["filter_log_power"] = {"cases": {}}

    def fe_inputs(T, R, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((T, 64), generator=g).to(dev)
        carry = torch.randn((R, 64), generator=g).to(dev) if R != 20 \
            else torch.zeros((R, 64), device=dev)  # a short first packet
        return fe_ex.sos, x, fe_ex.zi, carry

    def one_warp(sos, x, zi, carry):
        """The kernel with the whole cascade on one warp (no pipeline): the
        design it is measured against, through its own entry point."""
        T, C = x.shape
        n = carry.shape[0] + T
        out = (torch.empty(((n - 50) // 10 + 1 if n >= 50 else 0, C),
                           device=dev), torch.empty_like(zi),
               torch.empty((40, C), device=dev))
        _cuda.check(_cuda.library().dss_filter_log_power_one_warp(
            x.data_ptr(), sos.data_ptr(), zi.data_ptr(), carry.data_ptr(),
            *(t.data_ptr() for t in out), T, C, sos.shape[0], carry.shape[0],
            10, 50, 0.01, torch.cuda.current_stream().cuda_stream),
            "one warp")
        return out

    def fe_check():
        worst = 0.0
        for T, R in ((40, 40), (80, 40), (160, 40), (320, 40), (10, 40),
                     (30, 20), (20000, 0)):
            sos, x, zi, carry = fe_inputs(T, R, T + R)
            got = filter_log_power(sos, x, zi, carry, 10, 50)
            want = filter_log_power_plain(sos, x, zi, carry, 10, 50)
            ow = one_warp(sos, x, zi, carry)
            torch.cuda.synchronize()
            err = float((got[0] - want[0]).abs().max()) if got[0].numel() \
                else 0.0
            exact = torch.equal(got[1], want[1]) and \
                torch.equal(got[2], want[2])
            if not (torch.equal(ow[1], want[1]) and torch.equal(ow[2], want[2])
                    and torch.equal(ow[0], got[0])):
                raise AssertionError(f"one-warp design T={T} R={R}")
            fe["cases"][f"T{T}_R{R}"] = dict(
                windows=got[0].shape[0], max_abs_err=err,
                state_and_carry_bit_equal=exact)
            print(f"front-end kernel T={T} R={R}: {got[0].shape[0]} windows, "
                  f"max err {err:.3g}, zf/carry bit-equal {exact}")
            if got[0].shape != want[0].shape or not exact or not err <= 1e-5:
                raise AssertionError(f"front-end kernel T={T} R={R}")
            worst = max(worst, err)
        # A 16 s session packet by packet through packet_step, the kernel
        # against the plain version, both on the card.
        raw = torch.as_tensor(session().astype(np.float32))
        runs = []
        for fn in (filter_log_power, filter_log_power_plain):
            hga_mod.filter_log_power = fn
            try:
                pre, post, nb = feature_transforms(None)
                ex = HighGammaExtractor(fs=1000, nb_electrodes=nb,
                                        pre_transforms=pre,
                                        post_transforms=post, device=dev)
                st, frames = ex.init_state(), []
                for k in range(0, raw.shape[0], 40):
                    f, st = ex.packet_step(st, raw[k:k + 40].to(dev))
                    frames.append(f)
                runs.append((torch.cat(frames), st))
            finally:
                hga_mod.filter_log_power = filter_log_power
        (fk, sk), (fp, sp) = runs
        torch.cuda.synchronize()
        err = float((fk - fp).abs().max())
        exact = torch.equal(sk.zi, sp.zi) and \
            torch.equal(sk.remainder, sp.remainder)
        fe["session_16s"] = dict(frames=fk.shape[0], max_abs_err=err,
                                 final_state_bit_equal=exact)
        print(f"front-end session, 16 s in 40-sample packets: {fk.shape[0]} "
              f"frames, max err {err:.3g}, final zi/remainder bit-equal "
              f"{exact}")
        if fk.shape != fp.shape or not exact or not err <= 1e-5:
            raise AssertionError("front-end session: kernel != plain")
        fe["max_abs_err"] = max(worst, err)
    ph.run("front-end kernel vs plain (cascade + framing + log power)",
           fe_check)

    def fe_timing():
        lib = _cuda.library()
        stream = torch.cuda.current_stream().cuda_stream
        x0 = torch.zeros((40, 64), device=dev)
        empty = lambda: _cuda.check(  # noqa: E731
            lib.dss_empty_launch(64, stream), "empty")
        floor_prof, _ = profiled_ms(empty, 200, "empty_kernel")
        floor_ev = cuda_ms(empty, 200)
        fe["launch_floor_ms"] = dict(profiler=floor_prof, events=floor_ev)
        print(f"launch floor (empty kernel, {x0.shape[1] // 32} blocks of 32, "
              f"ctypes): profiler {floor_prof} ms, events {floor_ev:.4f} ms")
        clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        for T in (40, 320):
            sos, x, zi, carry = fe_inputs(T, 40, 1)
            run = lambda: filter_log_power(  # noqa: E731
                sos, x, zi, carry, 10, 50)
            plain = lambda: filter_log_power_plain(  # noqa: E731
                sos, x, zi, carry, 10, 50)
            dev_ms, records = profiled_ms(run, 200, "filter_log_power_kernel")
            ev_ms = cuda_ms(run, 200)
            ow_ms, _ = profiled_ms(lambda: one_warp(sos, x, zi, carry), 200,
                                   "filter_log_power_kernel")
            ow_ev = cuda_ms(lambda: one_warp(sos, x, zi, carry), 200)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                run()
            host_ms = (time.perf_counter() - t0) * 1e3 / 200
            torch.cuda.synchronize()
            plain_ev = cuda_ms(plain, 10)
            t0 = time.perf_counter()
            for _ in range(10):
                plain()
            torch.cuda.synchronize()
            plain_host = (time.perf_counter() - t0) * 1e3 / 10
            S, W, N = sos.shape[0], (40 + T - 50) // 10 + 1, 40 + T
            nbytes = 4 * (T * 64 + sos.numel() + 2 * zi.numel() + 40 * 64
                          + W * 64 + 40 * 64)
            flops = 64 * (9 * S * T + 2 * N + W * (5 + 3))
            t_b, t_f = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
            chain_ms = 9 * S * T / H100_BOOST_HZ * 1e3
            fe[f"T{T}"] = dict(
                profiler_ms=dev_ms, profiler_records=records, events_ms=ev_ms,
                one_warp_profiler_ms=ow_ms, one_warp_events_ms=ow_ev,
                host_enqueue_ms=host_ms, plain_events_ms=plain_ev,
                plain_host_ms=plain_host, bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b > t_f else "operations",
                bytes=nbytes, flops=flops, chain_estimate_ms=chain_ms)
            print(f"front-end kernel [{T}, 64] + 40 carried rows: profiler "
                  f"{dev_ms} ms over {records} records, events {ev_ms:.4f} "
                  f"ms, host enqueue {host_ms:.4f} ms per call; plain "
                  f"{plain_ev:.3f} ms (events) / {plain_host:.3f} ms (host); "
                  f"bound {max(t_b, t_f) * 1e3:.2e} ms "
                  f"({'bytes' if t_b > t_f else 'operations'}), chain "
                  f"estimate {chain_ms:.4f} ms; one-warp design: profiler "
                  f"{ow_ms} ms, events {ow_ev:.4f} ms")
        clocks.terminate()
        mhz = [int(v) for v in clocks.communicate()[0].split()
               if v.strip().isdigit()]
        fe["sm_clock_mhz"] = dict(min=min(mhz, default=None),
                                  median=pct(mhz, 50),
                                  max=max(mhz, default=None))
        print(f"SM clock during the timing (nvidia-smi every 50 ms): "
              f"{fe['sm_clock_mhz']} MHz")
        t40 = fe["T40"]
        fe.update(ms=t40["profiler_ms"] if t40["profiler_ms"] is not None
                  else t40["events_ms"],
                  ms_from="profiler" if t40["profiler_ms"] is not None
                  else "events",
                  plain_ms=t40["plain_events_ms"], bound_ms=t40["bound_ms"],
                  bound_by=t40["bound_by"])
    ph.run("front-end kernel timing (profiler, events, launch floor)",
           fe_timing)

    # ---- K2: sampler -------------------------------------------------------
    params = _load_params(ROOT / "weights" / "vocoder_speech.npz", dev)
    model = tnet.LPCNetModel.from_params(params)
    w = prepare_sampler_weights(params)

    def inputs(frames, seed, model=model, params=params, batch=1):
        g = torch.Generator().manual_seed(seed)
        feats = torch.randn((batch, frames, 20), generator=g) * 0.3
        feats[..., 0] -= 4.0
        feats = feats.to(dev)
        cond = model.condition(params, feats)
        lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :18]))
        temp = 1.0 + 1.5 * torch.clamp(feats[..., 19] + 0.5, 0.0, 1.0)
        st = tnet.net_vocoder_init(model, batch, device=dev)
        return ((st.h_a, st.h_b, st.sig_mem, st.exc_idx),
                cond.transpose(0, 1).contiguous(),
                lpc.transpose(0, 1).contiguous(),
                temp.transpose(0, 1).contiguous())

    def sampler_bound(model, params, w, S, carry, cond, lpc, temp, noise,
                      sig):
        """(bound ms, what bounds it, kept tile fraction, gathered rows) of
        one sampler call.  Bytes: every dense weight, input and output byte
        once, and of the gathered tables (the fused GRU-A tables and the
        correction tables) only the distinct rows that this call's data
        reads (``gathered_rows`` on its output ``sig``).  Operations: T*F/S
        recurrences plus S heads each.  GRU-A's recurrent product counts
        only the mask's kept [16 x 128] tiles, which is what the kernel
        reads."""
        GA, GB, CD = model.gru_a_units, model.gru_b_units, model.cond_dim
        T = cond.shape[0]
        n = T * 160 * cond.shape[1]
        _, kept = tile_sparse_pattern(params["gru_a_mask"].cpu().numpy())
        emb_rows, corr_rows = gathered_rows(S, carry, lpc, sig)
        dense = sum(w[k].numel() for k in (
            "wx_a_cond", "bx_a", "wh_a", "bh_a", "wx_b", "bx_b", "wh_b",
            "bh_b", "w_out", "g_out", "ib_out", "b_out"))
        wbytes = (dense - (1.0 - kept) * w["wh_a"].numel()
                  + emb_rows * w["emb"].shape[-1]
                  + corr_rows * MULAW_LEVELS) * 4
        nbytes = (wbytes + noise.numel() * 4 + (cond.numel() + lpc.numel()
                  + temp.numel()) * 4 + n * 4)
        per_step = (kept * 2 * GA * 3 * GA + (2 * S + 1) * 3 * GA
                    + 2 * GA * 3 * GB + 2 * GB * 3 * GB + 12 * (GA + GB)
                    + S * (2 * GB * 512 + 3 * 256 + 2 * 16)
                    + (S - 1) * 2 * 256)
        flops = n / S * per_step + T * cond.shape[1] * 2 * CD * 3 * (GA + GB)
        t_bytes = nbytes / H100_BYTES_PER_S
        t_flops = flops / H100_F32_FLOPS
        return (max(t_bytes, t_flops) * 1e3,
                "bytes" if t_bytes > t_flops else "operations", kept,
                dict(emb=emb_rows, corr=corr_rows,
                     bytes_ms=t_bytes * 1e3, operations_ms=t_flops * 1e3))

    def k2_greedy():
        carry, cond, lpc, temp = inputs(2, 0)
        temp = -torch.ones_like(temp)
        kc, ks = sampler_frames(w, carry, cond, lpc, temp, None)
        pc, ps = sampler_frames_plain(w, carry, cond, lpc, temp, None)
        torch.cuda.synchronize()
        err = float((ks - ps).abs().max())
        if not torch.equal(kc[3], pc[3]) or not err <= 1e-5:
            raise AssertionError(f"K2 greedy: exc {kc[3]} vs {pc[3]}, "
                                 f"max err {err}")
        report["kernels"]["lpcnet_sampler_b1"] = dict(max_abs_err=err)
    ph.run("K2 sampler greedy vs plain (2 frames)", k2_greedy)

    def k2_stochastic():
        carry, cond, lpc, temp = inputs(50, 1)
        noise = tnet.gumbel_noise(0, 0, 50, 1, dev)
        _, ks = sampler_frames(w, carry, cond, lpc, temp, noise)
        t0 = time.perf_counter()
        _, ps = sampler_frames_plain(w, carry, cond, lpc, temp, noise)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = (ks - ps).abs()[0] > 1e-5
        first = int(torch.nonzero(diff)[0]) if bool(diff.any()) \
            else ks.shape[1]
        rms_k = float(ks.pow(2).mean().sqrt())
        rms_p = float(ps.pow(2).mean().sqrt())
        db = 20 * np.log10(rms_k / rms_p)
        ms = cuda_ms(lambda: sampler_frames(w, carry, cond, lpc, temp, noise),
                     5, warmup=1)
        n = 50 * 160
        bound, bound_by, kept, rows = sampler_bound(
            model, params, w, 1, carry, cond, lpc, temp, noise, ks)
        plan = kernel_plan(w, 1, cond.shape[2], lpc.shape[2])
        report["kernels"]["lpcnet_sampler_b1"].update(
            plan=plan, first_divergence=first, rms_db=db, ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound, gru_a_tiles_kept=kept, bound_by=bound_by,
            bound_terms=rows,
            us_per_sample=ms * 1e3 / n, real_time_factor=ms / 500.0)
        print(f"K2 stochastic: first divergence at sample {first}, RMS "
              f"{rms_k:.4f} vs {rms_p:.4f} ({db:+.3f} dB), {ms:.1f} ms per "
              f"8000-sample block, real-time factor {ms / 500.0:.3f} (plain "
              f"{plain_ms:.0f} ms); bound {bound:.4f} ms ({bound_by}) with "
              f"{kept:.1%} of GRU-A's tiles kept; {rows}; {plan}")
        if first < 160 or not abs(db) < 1.0:
            raise AssertionError("K2 stochastic out of tolerance")
    ph.run("K2 sampler stochastic vs plain (50 frames)", k2_stochastic)

    # ---- K3: bunched sampler ------------------------------------------------
    bunched = {}
    for S in (2, 4, 8):
        p = _load_params(ROOT / "weights" / f"vocoder_speech_b{S}.npz", dev)
        m = tnet.LPCNetModel.from_params(p)
        bunched[S] = (m, p, tnet.sampler_weights_for(m, p))
    report["kernels"]["lpcnet_sampler_bunched"] = k3 = dict(
        max_abs_err=0.0, by_bunch={})

    def k3_greedy():
        for S, B in ((2, 1), (4, 1), (8, 1), (4, 8)):
            m, p, wS = bunched[S]
            carry, cond, lpc, temp = inputs(2, S, m, p, B)
            temp = -torch.ones_like(temp)
            kc, ks = sampler_frames_bunched(wS, carry, cond, lpc, temp, None)
            pc, ps = sampler_frames_bunched_plain(wS, carry, cond, lpc, temp,
                                                  None)
            torch.cuda.synchronize()
            err = float((ks - ps).abs().max())
            print(f"K3 greedy b{S} B={B}: max err {err:.3g}")
            if not torch.equal(kc[3], pc[3]) or not err <= 1e-5 \
                    or tuple(kc[3].shape) != (B, S):
                raise AssertionError(f"K3 greedy b{S} B={B}: exc {kc[3]} vs "
                                     f"{pc[3]}, max err {err}")
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
    ph.run("K3 bunched sampler greedy vs plain (b2/b4/b8, b4 at B=8)",
           k3_greedy)

    def k3_block():
        for S, B in ((2, 1), (4, 1), (8, 1), (4, 8)):
            m, p, wS = bunched[S]
            noise = tnet.gumbel_noise(0, 0, 50, B, dev)
            carry, cond, lpc, temp = inputs(50, 1, m, p, B)
            run = lambda: sampler_frames_bunched(  # noqa: E731
                wS, carry, cond, lpc, temp, noise)
            ms = cuda_ms(run, 5, warmup=1)
            _, ks = run()
            t0 = time.perf_counter()
            _, ps = sampler_frames_bunched_plain(wS, carry, cond, lpc, temp,
                                                 noise)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            bound, bound_by, kept, rows = sampler_bound(
                m, p, wS, S, carry, cond, lpc, temp, noise, ks)
            diff = ((ks - ps).abs() > 1e-5).any(dim=0)
            first = int(torch.nonzero(diff)[0]) if bool(diff.any()) \
                else ks.shape[1]
            rms_k = float(ks.pow(2).mean().sqrt())
            rms_p = float(ps.pow(2).mean().sqrt())
            db = 20 * np.log10(rms_k / rms_p)
            n = 8000 * B
            cell = dict(
                plan=kernel_plan(wS, S, cond.shape[2], lpc.shape[2]),
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                bound_terms=rows, gru_a_tiles_kept=kept,
                us_per_sample=ms * 1e3 / n, real_time_factor=ms / 500.0,
                first_divergence=first, rms_db=db)
            if B == 1:
                k3["by_bunch"][S] = cell
            else:
                k3[f"b{S}_streams_{B}"] = cell
            print(f"K3 b{S} B={B}: {ms:.1f} ms per 50-frame block "
                  f"({ms * 1e3 / n:.2f} us per sample, real-time factor "
                  f"{ms / 500.0:.3f}); bound {bound:.4f} ms ({bound_by}) "
                  f"with {kept:.1%} of GRU-A's tiles kept; {rows}; "
                  f"{cell['plan']}")
            print(f"K3 b{S} B={B} stochastic: first divergence at sample "
                  f"{first}, RMS {rms_k:.4f} vs {rms_p:.4f} ({db:+.3f} dB); "
                  f"plain {plain_ms:.0f} ms")
            if first < 160 or not abs(db) < 1.0:
                raise AssertionError(f"K3 b{S} B={B} stochastic out of "
                                     f"tolerance")
        # The kernels' line carries b8 at one stream, the word path's shape.
        k3.update(k3["by_bunch"][8])
    ph.run("K3 bunched sampler per 50-frame block, stochastic vs plain "
           "(b2/b4/b8 at one stream, b4 at eight)", k3_block)

    def chunk_invariance():
        """Through the kernel, one 100-frame call equals two 50-frame calls
        bit for bit (audio and carried state), at bunch 1 and bunch 8."""
        for name, (m, p, wS) in (("b1", (model, params, w)),
                                 ("b8", bunched[8])):
            feats = torch.randn((1, 100, 20), generator=torch.Generator()
                                .manual_seed(2)).to(dev) * 0.3
            st = tnet.net_vocoder_init(m, 1, seed=3, device=dev)
            whole, s_whole = tnet.net_synthesize_frames(
                m, p, st, feats, sampler_weights=wS)
            p1, s1 = tnet.net_synthesize_frames(m, p, st, feats[:, :50],
                                                sampler_weights=wS)
            p2, s2 = tnet.net_synthesize_frames(m, p, s1, feats[:, 50:],
                                                sampler_weights=wS)
            torch.cuda.synchronize()
            same = torch.equal(torch.cat([p1, p2], dim=1), whole) and \
                torch.equal(s2.h_a, s_whole.h_a) and \
                torch.equal(s2.exc_idx, s_whole.exc_idx)
            report.setdefault("chunk_invariance", {})[name] = same
            if not same or not bool(whole.abs().max() > 0):
                raise AssertionError(f"chunked != single-shot at {name}")
    ph.run("chunk invariance on the card (100 frames == 2 x 50, b1 and b8)",
           chunk_invariance)

    # ---- sosfilt_scan per packet (eager torch) --------------------------------
    def iir():
        from dss_tpu_torch.ops.hga import HighGammaExtractor
        ex = HighGammaExtractor(fs=1000, nb_electrodes=64, device=dev)
        x = torch.randn((40, 64), device=dev)
        ms = cuda_ms(lambda: sosfilt_scan(ex.sos, x, ex.zi), 20)
        t0 = time.perf_counter()
        for _ in range(20):
            sosfilt_scan(ex.sos, x, ex.zi)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        report["sosfilt_scan_packet"] = dict(device_ms=ms, host_ms=host_ms)
        print(f"sosfilt_scan [40,64] x 16 sections: {host_ms:.2f} ms per "
              f"packet (host clock), {ms:.2f} ms (events)")
    ph.run("IIR cascade per packet", iir)

    # ---- D1: the DSP vocoder's sample loop -----------------------------------
    from dss_tpu_torch.ops import dsp_synthesis as d1_mod
    from dss_tpu_torch.ops.dsp_synthesis import DspCarry, dsp_synthesis, \
        dsp_synthesis_plain
    from dss_tpu_torch.vocoder import dsp as tdsp
    d1 = report["kernels"]["dsp_synthesis"] = {"cases": {}}

    def d1_inputs(batch, frames, seed):
        """Seeded sample-loop inputs on the CPU: features with voiced and
        unvoiced frames and periods 32-256 through the frame-rate part,
        Gaussian noise and a nonzero carried state."""
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(batch, frames, 20)).astype(np.float32) * .3
        feats[..., 0] -= 2.0
        feats[..., 18] = rng.uniform(-1.36, 3.12, size=(batch, frames))
        feats[..., 19] = np.where(rng.random((batch, frames)) < 0.6,
                                  rng.uniform(0.0, 0.5, (batch, frames)),
                                  rng.uniform(-0.5, -0.2, (batch, frames)))
        params = tdsp.frame_parameters(torch.as_tensor(feats))
        noise = torch.as_tensor(rng.normal(size=(batch, frames, 160))
                                .astype(np.float32))
        carry = DspCarry(
            torch.as_tensor(rng.normal(size=(batch, 16)).astype(np.float32))
            * 0.1,
            torch.as_tensor(rng.integers(-3, 200, batch).astype(np.int32)),
            torch.as_tensor(rng.normal(size=batch).astype(np.float32)) * 0.1)
        return (*params, noise), carry

    def d1_check():
        for batch, frames in ((1, 260), (8, 50), (1, 1)):
            inputs, carry = d1_inputs(batch, frames, frames)
            pcm, out = dsp_synthesis(*(t.to(dev) for t in inputs),
                                     DspCarry(*(t.to(dev) for t in carry)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, want_out = dsp_synthesis_plain(*inputs, carry)
            plain_s = time.perf_counter() - t0
            exact = torch.equal(pcm.cpu(), want) and all(
                torch.equal(a.cpu(), b) for a, b in zip(out, want_out))
            voiced = float(inputs[3].float().mean())
            d1["cases"][f"B{batch}_T{frames}"] = dict(
                bit_equal=exact, plain_cpu_s=plain_s, voiced_share=voiced,
                periods=[int(inputs[4].min()), int(inputs[4].max())])
            print(f"D1 B={batch} T={frames}: pcm and state bit-equal to the "
                  f"plain version {exact} (plain loop on the CPU {plain_s:.2f}"
                  f" s; voiced share {voiced:.2f})")
            if not exact or pcm.shape != (batch, frames * 160):
                raise AssertionError(f"D1 B={batch} T={frames}: kernel != "
                                     f"plain")
        d1["plain_ms"] = d1["cases"]["B1_T260"]["plain_cpu_s"] * 1e3
        d1["max_abs_err"] = 0.0
        # 100 frames in one call equal 50 + 50, through the vocoder.
        g = np.random.default_rng(4)
        feats = torch.as_tensor(g.normal(size=(2, 100, 20)).astype(
            np.float32) * 0.3, device=dev)
        st = tdsp.dsp_vocoder_init(4, 2, dev)
        whole, s_whole = tdsp.dsp_synthesize_frames(st, feats)
        p1, s1 = tdsp.dsp_synthesize_frames(st, feats[:, :50])
        p2, s2 = tdsp.dsp_synthesize_frames(s1, feats[:, 50:])
        torch.cuda.synchronize()
        same = torch.equal(torch.cat([p1, p2], dim=1), whole) and all(
            torch.equal(a, b) for a, b in zip(s2[:3], s_whole[:3]))
        d1["chunk_invariance_100_eq_50_50"] = same
        print(f"D1 through the vocoder, 100 frames == 50 + 50 bit for bit: "
              f"{same}")
        if not same or not bool(whole.abs().max() > 0):
            raise AssertionError("D1: chunked != single-shot")
    ph.run("D1 DSP sample loop vs plain (B=1 T=260, B=8 T=50, T=1; "
           "100 == 50 + 50)", d1_check)

    def d1_timing():
        inputs, carry = d1_inputs(1, 260, 260)
        inputs = tuple(t.to(dev) for t in inputs)
        carry = DspCarry(*(t.to(dev) for t in carry))
        run = lambda: dsp_synthesis(*inputs, carry)  # noqa: E731
        clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        dev_ms, records = profiled_ms(run, 20, "dsp_synthesis_kernel")
        ev_ms = cuda_ms(run, 20)
        lib = _cuda.library()
        stream = torch.cuda.current_stream().cuda_stream
        empty = lambda: _cuda.check(  # noqa: E731
            lib.dss_empty_launch(1, stream), "empty")
        floor_prof, _ = profiled_ms(empty, 200, "empty_kernel")
        clocks.terminate()
        # The rest of a word's vocoder call, host clock with a synchronize:
        # the frame-rate part (pitch, cepstrum -> LPC, gain) and the noise.
        g = np.random.default_rng(9)
        feats = torch.as_tensor(g.normal(size=(1, 260, 20)).astype(
            np.float32) * 0.3, device=dev)
        parts = {"frame_rate_ms": lambda: tdsp.frame_parameters(feats),
                 "noise_ms": lambda: tdsp.gaussian_noise(0, 1, 0, 260, dev)}
        for name, fn in parts.items():
            fn()
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            d1[name] = pct(times, 50)
        mhz = [int(v) for v in clocks.communicate()[0].split()
               if v.strip().isdigit()]
        n = 260 * 160
        # Bytes: each input read once (lpc 64, gain, v_mix, period 4 each,
        # voiced 1, noise 640 per frame), state in and out, pcm out.
        nbytes = 260 * (64 + 4 + 4 + 1 + 4 + 640 + 640) + 2 * (64 + 4 + 4)
        # Operations a sample: 16 products, 15 sums, the excitation's 3
        # products and 2 sums and the gain, the subtraction, de-emphasis's
        # product and sum, the clip's two comparisons.
        flops = n * (16 + 15 + 6 + 1 + 2 + 2)
        t_b, t_f = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
        clock = (pct(mhz, 50) or H100_BOOST_HZ / 1e6) * 1e6
        # The serial chain: s depends on the previous s through one product,
        # four sums of the tree and the subtraction, ~4 clocks each.
        chain_ms = n * 6 * 4 / clock * 1e3
        d1.update(
            profiler_ms=dev_ms, profiler_records=records, events_ms=ev_ms,
            launch_floor_profiler_ms=floor_prof,
            ms=dev_ms if dev_ms is not None else ev_ms,
            ms_from="profiler" if dev_ms is not None else "events",
            us_per_sample=(dev_ms or ev_ms) * 1e3 / n,
            bound_ms=max(t_b, t_f) * 1e3,
            bound_by="bytes" if t_b > t_f else "operations", bytes=nbytes,
            flops=flops, chain_estimate_ms=chain_ms,
            sm_clock_mhz=dict(min=min(mhz, default=None), median=pct(mhz, 50),
                              max=max(mhz, default=None)))
        print(f"D1 per 260-frame word (41,600 samples, one stream): profiler "
              f"{dev_ms} ms over {records} records, events {ev_ms:.4f} ms "
              f"({d1['us_per_sample'] * 1e3:.1f} ns a sample); empty launch "
              f"{floor_prof} ms; plain loop (CPU) {d1['plain_ms']:.0f} ms; "
              f"bound {d1['bound_ms']:.2e} ms ({d1['bound_by']}); chain "
              f"estimate {chain_ms:.3f} ms at {clock / 1e6:.0f} MHz; SM clock "
              f"{d1['sm_clock_mhz']}; the rest of the word's call (host "
              f"clock, p50 of 5): frame-rate part {d1['frame_rate_ms']:.2f} "
              f"ms, noise {d1['noise_ms']:.2f} ms")
    ph.run("D1 timing per 260-frame word (profiler, events, launch floor)",
           d1_timing)

    # ---- the main path -----------------------------------------------------
    counters = {"log_power": log_power,
                "filter_log_power": filter_log_power,
                "dsp_synthesis": dsp_synthesis,
                "lpcnet_sampler_b1": sampler_frames,
                "lpcnet_sampler_bunched": sampler_frames_bunched}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    def main_path(key, weights_name, expect):
        from dss_tpu_torch import runtime as ez
        from dss_tpu_torch.apps.decode_online import feature_transforms
        from dss_tpu_torch.models.decoder import \
            BidirectionalSpeechSynthesisModel
        from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
        from dss_tpu_torch.runtime.units import FusedDecoderVocoder, \
            FusedDecoderVocoderSettings, FusedFrontendVad, \
            FusedFrontendVadSettings, PacketReplay, PacketReplaySettings

        class Sink(ez.Unit):
            AUDIO = ez.InputStream(ez.ClosedLoopMessage)
            WORD = ez.InputStream(ez.TimeSeriesMessage)
            LPC = ez.InputStream(ez.TimeSeriesMessage)

            def initialize(self):
                self.first_audio_ms, self.words, self.lpc = [], [], []

            @ez.subscriber(AUDIO)
            async def on_audio(self, msg):
                stamps = dict(getattr(msg, "stamps", ()))
                if msg.received_at is not None and \
                        "dv_word_complete" not in stamps:
                    self.first_audio_ms.append(
                        (time.time() - msg.received_at) * 1e3)

            @ez.subscriber(WORD)
            async def on_word(self, msg):
                self.words.append(np.asarray(msg.data))

            @ez.subscriber(LPC)
            async def on_lpc(self, msg):
                self.lpc.append(np.asarray(msg.data))

        with tempfile.TemporaryDirectory() as tmp:
            vad_path = Path(tmp) / "vad_threshold.npz"
            np.savez(vad_path, **threshold_vad())
            pre, post, nb = feature_transforms(None)

            class System(ez.System):
                SOURCE = PacketReplay()
                FRONTEND = FusedFrontendVad()
                WORDS = FusedDecoderVocoder()
                SINK = Sink()

                def configure(self):
                    self.SOURCE.apply_settings(PacketReplaySettings(
                        data=session(), fs=1000, period=0.04))
                    self.FRONTEND.apply_settings(FusedFrontendVadSettings(
                        nb_features=nb, fs=1000, buffer_size=2000,
                        context_frames=50, pre_transforms=pre,
                        post_transforms=post,
                        vad_architecture=UnidirectionalVoiceActivityDetector,
                        vad_weights_path=vad_path,
                        vad_parameters=dict(nb_layer=2, nb_hidden_units=150,
                                            nb_electrodes=nb)))
                    self.WORDS.apply_settings(FusedDecoderVocoderSettings(
                        path_to_model_weights=None,
                        model=BidirectionalSpeechSynthesisModel,
                        params=dict(nb_layer=2, nb_hidden_units=100,
                                    nb_electrodes=nb),
                        vocoder_weights=str(ROOT / "weights"
                                            / weights_name)))

                def network(self):
                    return ((self.SOURCE.OUTPUT, self.FRONTEND.INPUT),
                            (self.FRONTEND.OUTPUT, self.WORDS.INPUT),
                            (self.WORDS.OUTPUT, self.SINK.AUDIO),
                            (self.WORDS.WORD, self.SINK.WORD),
                            (self.WORDS.LPC, self.SINK.LPC))

            system = System()
            eager_on_card = []

            def guard(sos, x, zi):
                if x.is_cuda:
                    eager_on_card.append(tuple(x.shape))
                    raise AssertionError("eager cascade on the card")
                return sosfilt_scan(sos, x, zi)
            mods = (hga_mod, filters_mod, flp_mod)
            for m in mods:
                m.sosfilt_scan = guard
            try:
                zero_counts()
                t0 = time.perf_counter()
                ez.run_system(system)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
            finally:
                for m in mods:
                    m.sosfilt_scan = sosfilt_scan
        sink = system.SINK
        mp = report["main_path"][key] = {"vocoder_weights": weights_name}
        mp.update(
            wall_s=wall, launches=launches, words=len(sink.words),
            word_frames=[len(x) for x in sink.lpc],
            packet_ms_p50=pct(system.FRONTEND.step_ms, 50),
            packet_ms_p95=pct(system.FRONTEND.step_ms, 95),
            packet_calls=len(system.FRONTEND.step_ms),
            word_head_ms=system.WORDS.word_ms,
            ingest_to_first_audio_ms=sink.first_audio_ms)
        print(f"main path ({weights_name}): {len(sink.words)} word(s) of "
              f"{mp['word_frames']} frames, {wall:.1f} s wall, launches "
              f"{launches}; packet step p50 {mp['packet_ms_p50']:.2f} ms / "
              f"p95 {mp['packet_ms_p95']:.2f} ms over "
              f"{mp['packet_calls']} calls; word head "
              f"{[round(x, 1) for x in system.WORDS.word_ms]} ms; "
              f"ingest->first audio "
              f"{[round(x, 1) for x in sink.first_audio_ms]} ms")
        if len(sink.words) != 3:
            raise AssertionError(f"{len(sink.words)} segments closed for 3 "
                                 f"bursts")
        for lpc, word in zip(sink.lpc, sink.words):
            if word.dtype != np.int16 or len(word) != len(lpc) * 160:
                raise AssertionError(f"PCM {word.dtype} {len(word)} for "
                                     f"{len(lpc)} frames")
            if not np.all(np.isfinite(lpc)):
                raise AssertionError("non-finite decoded features")
        # Steady-state split of one word head (254 frames, after the run):
        # decode alone, then the first 50-frame vocoder chunk alone.
        seg = np.random.default_rng(1).normal(size=(254, nb)).astype(
            np.float32)
        words = system.WORDS
        split = {"decode_ms": [], "vocode_chunk_ms": []}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _pred, feats = words._padded_features(seg, len(seg))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            words._vocode(words._voc_state, feats[:, :50])[0].cpu()
            t2 = time.perf_counter()
            split["decode_ms"].append((t1 - t0) * 1e3)
            split["vocode_chunk_ms"].append((t2 - t1) * 1e3)
        mp["word_head_split"] = split
        print(f"word head split (steady state, ms): {split}")
        # Steady-state split of the packet step (its own stream-less copy of
        # FusedFrontendVad._packet_path, synchronized after each part).
        fe_unit = system.FRONTEND
        ex, vad = fe_unit._extractor, fe_unit._model
        raw = session().astype(np.float32)
        st, vs = ex.init_state(), vad.create_new_initial_state(1)
        parts = {"copy_pre_ms": [], "front_end_kernel_ms": [],
                 "post_vad_readback_ms": []}
        with torch.no_grad():
            for i in range(110):
                packet = raw[i * 40:(i + 1) * 40]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                data = ex.pre_transform(torch.as_tensor(packet).to(dev))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                feats, zi, rem = filter_log_power(ex.sos, data, st.zi,
                                                  st.remainder, 10, 50)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                feats = ex.post_transform(feats)
                logits, vs = vad(feats[None], vs)
                labels = torch.argmax(logits, dim=-1)[0]
                torch.cat([feats, labels[:, None].to(feats.dtype)],
                          dim=1).cpu()
                t3 = time.perf_counter()
                st = type(st)(zi=zi, remainder=rem)
                if i >= 10:
                    parts["copy_pre_ms"].append((t1 - t0) * 1e3)
                    parts["front_end_kernel_ms"].append((t2 - t1) * 1e3)
                    parts["post_vad_readback_ms"].append((t3 - t2) * 1e3)
        mp["packet_step_split_p50"] = {k: pct(v, 50) for k, v in parts.items()}
        mp["packet_step_split_p95"] = {k: pct(v, 95) for k, v in parts.items()}
        print(f"packet step split (steady state, 100 packets, host clock "
              f"with a synchronize after each part): p50 "
              f"{mp['packet_step_split_p50']}, p95 "
              f"{mp['packet_step_split_p95']}")
        warm = len(fe_unit._sizes)
        mp["front_end_expected_launches"] = mp["packet_calls"] + warm
        if eager_on_card:
            raise AssertionError(f"the eager cascade ran on the card "
                                 f"{len(eager_on_card)} time(s)")
        if launches["filter_log_power"] != mp["packet_calls"] + warm:
            raise AssertionError(
                f"front-end kernel: {launches['filter_log_power']} launches "
                f"for {mp['packet_calls']} packet calls + {warm} warm-up "
                f"calls")
        for name in expect:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"main path with {weights_name}")
    ph.run("main path, bunch 1 (frontend+nVAD -> decoder+vocoder)",
           lambda: main_path("b1", "vocoder_speech.npz",
                             ("filter_log_power", "lpcnet_sampler_b1")))
    ph.run("main path, bunch 8 (frontend+nVAD -> decoder+vocoder)",
           lambda: main_path("b8", "vocoder_speech_b8.npz",
                             ("filter_log_power",
                              "lpcnet_sampler_bunched")))

    # ---- the shipped configuration (config/debug_settings.ini) ---------------
    def shipped(key, resolved):
        """The shipped INI's system, replayed in real time: as the INI
        resolves on the card (``resolved``: fused front end, separate
        decoder, dsp vocoder), or with both fused_* switches false (the
        fully separate chain)."""
        from contextlib import redirect_stdout
        from dataclasses import replace

        from scipy.io.wavfile import read as wavread

        from dss_tpu_torch import runtime as ez
        from dss_tpu_torch.apps.decode_online import Neuroprosthesis, \
            build_settings
        from dss_tpu_torch.runtime.units import PacketReplay, \
            PacketReplaySettings

        s = build_settings(str(ROOT / "config" / "debug_settings.ini"), "run",
                           device="cuda")
        if not (s.fused_frontend and not s.fused_decoder
                and s.vocoder_backend == "dsp"):
            raise AssertionError(f"the shipped INI resolves on cuda to "
                                 f"fused_frontend={s.fused_frontend} "
                                 f"fused_decoder={s.fused_decoder} "
                                 f"backend={s.vocoder_backend}")
        if not resolved:
            s = replace(s, fused_frontend=False, fused_decoder=False)
        mp = report["main_path"][key] = dict(
            fused_frontend=s.fused_frontend, fused_decoder=s.fused_decoder,
            vocoder_backend=s.vocoder_backend)
        with tempfile.TemporaryDirectory() as tmp:
            vad_path = Path(tmp) / "vad_threshold.npz"
            np.savez(vad_path, **threshold_vad())
            s = replace(s, destination_dir=str(Path(tmp) / "run"),
                        vad_model_weights=vad_path)

            class Replayed(Neuroprosthesis):
                CONNECTOR = PacketReplay()

                def configure_source(self):
                    self.CONNECTOR.apply_settings(PacketReplaySettings(
                        data=session(), fs=1000, period=0.04))

            system = Replayed(s)
            on_card = []

            def cascade_guard(sos, x, zi):
                if x.is_cuda:
                    on_card.append("eager cascade")
                    raise AssertionError("eager cascade on the card")
                return sosfilt_scan(sos, x, zi)

            def plain_guard(*args):
                if args[1].is_cuda:
                    on_card.append("D1 plain loop")
                    raise AssertionError("D1's plain loop on the card")
                return dsp_synthesis_plain(*args)
            mods = (hga_mod, filters_mod, flp_mod)
            for m in mods:
                m.sosfilt_scan = cascade_guard
            d1_mod.dsp_synthesis_plain = plain_guard
            try:
                zero_counts()
                t0 = time.perf_counter()
                with open(Path(tmp) / "audio.pcm", "w") as fd, \
                        redirect_stdout(fd):
                    ez.run_system(system)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
            finally:
                for m in mods:
                    m.sosfilt_scan = sosfilt_scan
                d1_mod.dsp_synthesis_plain = dsp_synthesis_plain
            run = Path(tmp) / "run"
            rows = (run / "log.vad.lab").read_text().splitlines()
            frames = [int(r.split("\t")[2].split()[0]) for r in rows]
            words = [wavread(run / "reco" / f"reco_{k:05d}.wav")
                     for k in range(1, len(rows) + 1)]
            pcm = np.fromfile(Path(tmp) / "audio.pcm", np.int16)
            lpc = np.fromfile(run / "log.lpc.f32", np.float32).reshape(-1, 20)
        sink = system.LOUDSPEAKER
        if s.fused_frontend:
            packet_ms = {"front_end_vad": system.FUSED_FRONTEND.step_ms}
            warm = len(system.FUSED_FRONTEND._sizes)
        else:
            packet_ms = {"high_gamma": system.FEATURE_EXTRACTOR.step_ms,
                         "vad": system.SPEECH_FILTER.step_ms}
            warm = 1
        calls = len(next(iter(packet_ms.values())))
        mp.update(
            wall_s=wall, launches=launches, words=len(words),
            word_frames=frames, packet_calls=calls,
            packet_ms={k: dict(p50=pct(v, 50), p95=pct(v, 95))
                       for k, v in packet_ms.items()},
            decode_ms=system.DECODING_MODEL.decode_ms,
            vocode_ms=system.WAVEFORM_GENERATOR.vocode_ms,
            ingest_to_audio_ms=sink.latencies_ms, budget=sink.budget,
            front_end_expected_launches=calls + warm,
            dsp_expected_launches=len(words))
        print(f"shipped config ({key}): fused_frontend={s.fused_frontend} "
              f"fused_decoder={s.fused_decoder} backend={s.vocoder_backend}; "
              f"{len(words)} word(s) of {frames} frames, {wall:.1f} s wall, "
              f"launches {launches}; packet step "
              + ", ".join(f"{k} p50 {v['p50']:.2f} / p95 {v['p95']:.2f} ms"
                          for k, v in mp["packet_ms"].items())
              + f" over {calls} calls; decode "
              f"{[round(x, 1) for x in mp['decode_ms']]} ms; vocode "
              f"{[round(x, 1) for x in mp['vocode_ms']]} ms; ingest->audio "
              f"{[round(x, 1) for x in sink.latencies_ms]} ms")
        if sink.budget:
            print("latency budget (p50 ms): " + ", ".join(
                f"{k} {v['p50']:.1f}" for k, v in sink.budget["stages"].items()))
        if on_card:
            raise AssertionError(f"plain versions on the card: {on_card}")
        if len(words) != 3:
            raise AssertionError(f"{len(words)} segments closed for 3 bursts")
        for (fs, word), n in zip(words, frames):
            if fs != 16000 or word.dtype != np.int16 or len(word) != n * 160 \
                    or not word.any():
                raise AssertionError(f"word PCM {word.dtype} {len(word)} at "
                                     f"{fs} Hz for {n} frames")
        if len(pcm) != sum(frames) * 160 or len(lpc) != sum(frames) \
                or not np.all(np.isfinite(lpc)):
            raise AssertionError(f"stdout PCM {len(pcm)} samples, {len(lpc)} "
                                 f"feature frames for {frames}")
        if launches["filter_log_power"] != calls + warm:
            raise AssertionError(
                f"front-end kernel: {launches['filter_log_power']} launches "
                f"for {calls} packet calls + {warm} warm-up calls")
        if launches["dsp_synthesis"] != len(words):
            raise AssertionError(f"D1: {launches['dsp_synthesis']} launches "
                                 f"for {len(words)} words")
    ph.run("shipped config, run 1 (INI on cuda: FusedFrontendVad -> "
           "RecurrentNeuralDecodingModel -> DelayedLPCNetVocoder(dsp))",
           lambda: shipped("ship_resolved", True))
    ph.run("shipped config, run 2 (fused_* false: HighGammaActivity -> "
           "FilterSpeechSegments -> decoder -> DelayedLPCNetVocoder(dsp))",
           lambda: shipped("ship_separate", False))

    # ---- the offline entries ------------------------------------------------
    def offline():
        from scipy.io.wavfile import read as wavread

        from dss_tpu_torch.apps import synthesize
        from dss_tpu_torch.vocoder import BatchedLPCNet, \
            packaged_weights_bunched

        feats = np.random.default_rng(3).normal(size=(300, 20)).astype(
            np.float32) * 0.3
        feats[:, 0] -= 4.0
        off = report["offline"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            np.save(Path(tmp) / "feats.npy", feats)
            zero_counts()
            t0 = time.perf_counter()
            synthesize.main([str(Path(tmp) / "feats.npy"),
                             str(Path(tmp) / "out.wav"), "--backend", "net",
                             "--bunch", "4"])
            off["synthesize_s"] = time.perf_counter() - t0
            off["synthesize_launches"] = read_counts()
            fs, pcm = wavread(Path(tmp) / "out.wav")
            # The CLI's default backend, dsp: one D1 launch for the file.
            zero_counts()
            t0 = time.perf_counter()
            synthesize.main([str(Path(tmp) / "feats.npy"),
                             str(Path(tmp) / "dsp.wav")])
            off["synthesize_dsp_s"] = time.perf_counter() - t0
            off["synthesize_dsp_launches"] = read_counts()
            fs_d, pcm_d = wavread(Path(tmp) / "dsp.wav")
        if fs_d != 16000 or pcm_d.dtype != np.int16 \
                or pcm_d.shape != (300 * 160,) or not pcm_d.any() \
                or off["synthesize_dsp_launches"]["dsp_synthesis"] != 1:
            raise AssertionError(f"synthesize (dsp): fs {fs_d}, {pcm_d.dtype} "
                                 f"{pcm_d.shape}, launches "
                                 f"{off['synthesize_dsp_launches']}")
        if fs != 16000 or pcm.dtype != np.int16 or pcm.shape != (300 * 160,) \
                or not np.all(np.isfinite(pcm.astype(np.float64))) \
                or not pcm.any():
            raise AssertionError(f"synthesize: fs {fs}, {pcm.dtype} "
                                 f"{pcm.shape}")
        voc = BatchedLPCNet(batch=8, weights=packaged_weights_bunched(4))
        zero_counts()
        t0 = time.perf_counter()
        out = voc.synthesize_frames(np.repeat(feats[None, :50], 8, axis=0))
        off["batched_8x50_s"] = time.perf_counter() - t0
        off["batched_launches"] = read_counts()
        if out.dtype != np.int16 or out.shape != (8, 50 * 160) \
                or not out.any():
            raise AssertionError(f"BatchedLPCNet: {out.dtype} {out.shape}")
        # The eight streams see the same features and their own noise:
        # different samples at the same scale.
        rms = np.sqrt((out.astype(np.float64) ** 2).mean(axis=1))
        if rms.max() > 4.0 * max(rms.min(), 1.0):
            raise AssertionError(f"BatchedLPCNet: stream RMS {rms}")
        print(f"offline: synthesize 300 frames (b4) in "
              f"{off['synthesize_s']:.2f} s, launches "
              f"{off['synthesize_launches']}; with the dsp default in "
              f"{off['synthesize_dsp_s']:.2f} s; BatchedLPCNet 8 x 50 frames "
              f"in {off['batched_8x50_s']:.2f} s, launches "
              f"{off['batched_launches']}")
        for which in ("synthesize_launches", "batched_launches"):
            if off[which]["lpcnet_sampler_bunched"] <= 0:
                raise AssertionError(f"offline: K3 never launched "
                                     f"({which})")
    ph.run("offline entries (apps.synthesize b4 and dsp, BatchedLPCNet 8 "
           "streams)",
           offline)

    # ---- the training path ---------------------------------------------------
    def training_path():
        """Corpus preparation -> nVAD and decoder training -> checkpoints the
        online loader reads -> the synthesis queue (D1) -> quality scores."""
        from scipy.io.wavfile import read as wavread

        from dss_tpu_torch.apps import prepare_corpus as pc
        from dss_tpu_torch.apps import train_bidirectional_model as dec_app
        from dss_tpu_torch.apps import train_unidirectional_vad as vad_app
        from dss_tpu_torch.eval import quality
        from dss_tpu_torch.models.decoder import \
            BidirectionalSpeechSynthesisModel
        from dss_tpu_torch.models.lstm import seeded_init
        from dss_tpu_torch.models.torch_port import load_checkpoint
        from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
        from dss_tpu_torch.ops.car import BadChannelCorrection
        from dss_tpu_torch.train.dataset import padded_batches, \
            run_boundaries
        from dss_tpu_torch.train.synth_queue import AsynchronousSynthesisQueue
        from dss_tpu_torch.train.trainer_decoder import DecoderTrainer
        from dss_tpu_torch.train.trainer_vad import VadTrainer
        from dss_tpu_torch.utils.bci2000 import BCI2000MatFile
        from dss_tpu_torch.utils.channels import \
            SelectElectrodesOverSpeechAreas
        from dss_tpu_torch.utils.hdf import save_data_to_hdf
        from dss_tpu_torch.vocoder.features import LPCFeatureEncoder
        from dss_tpu_torch.vocoder.lpcnet import LPCNet

        tp = report["training_path"] = {}
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            base = Path(tmp)
            sys.path.insert(0, str(ROOT / "tests"))
            from torch_days import DAYS, make_corpus_days
            data_dir, norm_dir = make_corpus_days(
                base, n_trials=12, contaminated_day=DAYS[0])
            kw_mats = sorted(data_dir.rglob("*.mat"))
            kw_recs = [BCI2000MatFile(str(m)) for m in kw_mats]
            norm_recs = [BCI2000MatFile(str(m))
                         for m in sorted(norm_dir.rglob("*.mat"))]
            counts = [(len(r.trial_indices(2.5)), r) for r in kw_recs] + \
                [(len(r.trial_indices()), r) for r in norm_recs]
            extractions = sum(n for n, _ in counts)
            patched_expected = sum(n for n, r in counts
                                   if r.contaminated_channels() is not None)

            # -- corpus preparation, the front-end kernel once a trial and
            # the bad-channel patching on the card for the flagged day
            eager_on_card, patched = [], []

            def guard(sos, x, zi):
                if x.is_cuda:
                    eager_on_card.append(tuple(x.shape))
                    raise AssertionError("eager cascade on the card")
                return sosfilt_scan(sos, x, zi)

            def counted_patch(self, data):
                patched.append(data.is_cuda)
                return patch_call(self, data)
            mods = (hga_mod, filters_mod, flp_mod)
            for m in mods:
                m.sosfilt_scan = guard
            patch_call = BadChannelCorrection.__call__
            BadChannelCorrection.__call__ = counted_patch
            try:
                zero_counts()
                t0 = time.perf_counter()
                corpus = pc.prepare(base / "corpus", norm_dir, [data_dir],
                                    device=dev)
                torch.cuda.synchronize()
                prep_s = time.perf_counter() - t0
                launches = read_counts()
            finally:
                for m in mods:
                    m.sosfilt_scan = sosfilt_scan
                BadChannelCorrection.__call__ = patch_call
            frames = sum(len(r["trial_ids"]) for r in corpus.values())
            tp["corpus"] = dict(
                wall_s=prep_s, trial_extractions=extractions,
                ms_per_extraction=prep_s * 1e3 / extractions,
                launches=launches, recordings=len(corpus), frames=frames,
                bad_channel_patching_on_card=sum(patched))
            print(f"training path: corpus of {len(corpus)} recordings, "
                  f"{frames} frames, in {prep_s:.2f} s ({extractions} trial "
                  f"extractions, {tp['corpus']['ms_per_extraction']:.1f} ms "
                  f"each with its LPC targets and labels); launches "
                  f"{launches}; bad channels patched on the card in "
                  f"{sum(patched)} of {patched_expected} flagged "
                  f"extractions")
            if eager_on_card:
                raise AssertionError(f"the eager cascade ran on the card "
                                     f"{len(eager_on_card)} time(s)")
            if not patched_expected or len(patched) != patched_expected \
                    or not all(patched):
                raise AssertionError(
                    f"BadChannelCorrection: {sum(patched)} of {len(patched)} "
                    f"calls on the card, {patched_expected} extractions of "
                    f"the flagged day")
            if launches["filter_log_power"] != extractions:
                raise AssertionError(
                    f"front-end kernel: {launches['filter_log_power']} "
                    f"launches for {extractions} trial extractions")
            for r in corpus.values():
                if r["hga_activity"].shape[1] != 128 or not all(
                        np.all(np.isfinite(a)) for a in r.values()):
                    raise AssertionError("corpus: bad shape or non-finite")
            try:
                import h5py  # noqa: F401
            except ImportError:
                recordings = corpus
                tp["corpus"]["source"] = "in-memory dicts (no h5py)"
            else:
                for f, d in corpus.items():
                    Path(f).parent.mkdir(parents=True, exist_ok=True)
                    save_data_to_hdf(f, d, overwrite=True)
                recordings = None
                tp["corpus"]["source"] = "hdf files"
            print(f"training path: the trainers read the corpus from "
                  f"{tp['corpus']['source']}")

            # -- one whole trial at 128 channels: the kernel vs plain
            rec = BCI2000MatFile(str(kw_mats[0]))
            _, start, stop = rec.trial_indices(2.5)[0]
            raw = rec.signals()[start:int(stop + 40)].astype(np.float32)
            ex = pc.get_feature_extractor(rec, dev)
            x = ex.pre_transform(torch.as_tensor(raw, device=dev))
            carry = ex.framebuffer.carry(x.shape[0], x)
            args = (ex.sos, x, ex.zi, carry, 10, 50)
            got = filter_log_power(*args)
            want = filter_log_power_plain(*args)
            torch.cuda.synchronize()
            err = float((got[0] - want[0]).abs().max())
            exact = torch.equal(got[1], want[1]) and \
                torch.equal(got[2], want[2])
            dev_ms, records = profiled_ms(lambda: filter_log_power(*args), 50,
                                          "filter_log_power_kernel")
            ev_ms = cuda_ms(lambda: filter_log_power(*args), 50)
            plain_ms = cuda_ms(lambda: filter_log_power_plain(*args), 1,
                               warmup=0)
            T, C = x.shape
            S, W = ex.sos.shape[0], got[0].shape[0]
            nbytes = 4 * (T * C + ex.sos.numel() + 2 * ex.zi.numel()
                          + W * C + 40 * C)
            flops = C * (9 * S * T + 2 * T + W * (5 + 3))
            t_b, t_f = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
            tp["front_end_trial"] = fe["T3040_C128"] = dict(
                shape=[T, C], carry_rows=carry.shape[0], windows=W,
                max_abs_err=err, state_and_carry_bit_equal=exact,
                profiler_ms=dev_ms, profiler_records=records, events_ms=ev_ms,
                plain_events_ms=plain_ms, bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b > t_f else "operations",
                chain_estimate_ms=9 * S * T / H100_BOOST_HZ * 1e3)
            print(f"front-end kernel, one trial [{T}, {C}] with "
                  f"{carry.shape[0]} carried rows: {W} windows, max err "
                  f"{err:.3g}, zf/carry bit-equal {exact}; profiler {dev_ms} "
                  f"ms over {records} records, events {ev_ms:.4f} ms, plain "
                  f"{plain_ms:.1f} ms; bound {max(t_b, t_f) * 1e3:.2e} ms "
                  f"({'bytes' if t_b > t_f else 'operations'})")
            if got[0].shape != want[0].shape or not exact or not err <= 1e-5:
                raise AssertionError("front-end kernel at [3040, 128] != plain")

            # -- the two apps at deployed width, dropout 0.5, two epochs each
            days = dict(test_day=DAYS[2], valid_day=DAYS[1],
                        speech_corpus_root=base / "corpus", device="cuda")
            (base / "vad").mkdir()
            zero_counts()
            t0 = time.perf_counter()
            vad_hist = vad_app.main(vad_app.TrainingConfiguration(
                nb_hidden_units=150, nb_layer=2, nb_epochs=2, batch_size=1,
                num_workers=0, truncated_sequence_length=50,
                out_dir=base / "vad", **days), recordings)
            torch.cuda.synchronize()
            vad_s = time.perf_counter() - t0
            zero_counts()
            t0 = time.perf_counter()
            dec_hist = dec_app.main(dec_app.TrainingConfiguration(
                nb_hidden_units=100, nb_layer=2, nb_epochs=2, batch_size=1,
                num_workers=0, out_dir=base / "dec", **days), recordings)
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t0
            dec_launches = read_counts()
            jobs = sorted((base / "dec").rglob("*.npy"))
            tp["apps"] = dict(vad_s=vad_s, vad_history=vad_hist,
                              decoder_s=dec_s, decoder_history=dec_hist,
                              decoder_launches=dec_launches,
                              synthesis_jobs=len(jobs))
            print(f"training path: nVAD 2 x 150, 2 epochs in {vad_s:.1f} s: "
                  f"{vad_hist}; decoder 2 x 100 bidirectional, 2 epochs in "
                  f"{dec_s:.1f} s: {dec_hist}; launches {dec_launches} for "
                  f"{len(jobs)} synthesis jobs")
            for h in vad_hist + dec_hist:
                if not all(np.isfinite(v) for v in h.values()):
                    raise AssertionError(f"non-finite training record {h}")
            if len(jobs) != 6 or dec_launches["dsp_synthesis"] != len(jobs):
                raise AssertionError(
                    f"synthesis queue: {len(jobs)} jobs, "
                    f"{dec_launches['dsp_synthesis']} D1 launches")
            for npy in jobs:
                fs, pcm = wavread(npy.with_suffix(".wav"))
                n = len(np.load(npy))
                if fs != 16000 or pcm.dtype != np.int16 or len(pcm) != n * 160 \
                        or not pcm.any():
                    raise AssertionError(f"{npy.name}: {len(pcm)} samples for "
                                         f"{n} frames")

            # -- repeated passes over one trial: the loss falls; step times
            sel = SelectElectrodesOverSpeechAreas()
            r0 = next(iter(corpus.values()))
            a, b = run_boundaries(r0["trial_ids"])[0]
            xt = sel(r0["hga_activity"][a:b])
            vt = VadTrainer(seeded_init(UnidirectionalVoiceActivityDetector(
                2, 150, 64, dropout=0.5), 1), device=dev)
            xv, yv, mv = vt.pad_trial(xt, r0["vad_labels"][a:b])
            vad_losses = [float(vt.tbptt_trial(xv, yv, mv)) for _ in range(30)]
            dt = DecoderTrainer(seeded_init(BidirectionalSpeechSynthesisModel(
                2, 100, 64, dropout=0.5), 1), device=dev)
            xd, yd, md = dt.pad_trial(xt, r0["lpc_coefficients"][a:b])
            dec_losses = [float(dt.train_step(xd, yd, md)) for _ in range(30)]
            chunks = xv.shape[1] // 50
            # The decoder step on a padded batch of three trials in no
            # order of length, as padded_batches makes them: the packed
            # path, with the lengths from the host-side mask ("after") and
            # with the mask on the card, read back inside the step
            # ("before"), in turns.
            lengths = (263, b - a, 287)
            xb, yb, mb = next(padded_batches(
                [(xt[:n], r0["lpc_coefficients"][a:a + n]) for n in lengths],
                3))
            xb, yb, mb = xb[[1, 2, 0]], yb[[1, 2, 0]], mb[[1, 2, 0]]
            mb_card = torch.as_tensor(mb, device=dev)
            steps = {}
            for name, mask in (("after", mb), ("before", mb_card),
                               ("before", mb_card), ("after", mb)):
                steps.setdefault(name, []).append(
                    cuda_ms(lambda: dt.train_step(xb, yb, mask), 10))
            tbptt_ms = cuda_ms(lambda: vt.tbptt_trial(xv, yv, mv), 5)
            unpadded_ms = cuda_ms(lambda: dt.train_step(xd, yd, md), 10)
            split = {
                "tbptt_trial": device_split(
                    lambda: vt.tbptt_trial(xv, yv, mv)),
                "decoder_step_padded_batch": device_split(
                    lambda: dt.train_step(xb, yb, mb)),
                "decoder_step_one_trial": device_split(
                    lambda: dt.train_step(xd, yd, md))}
            tp["steps"] = dict(
                decoder_step_ms_one_unpadded_trial=unpadded_ms,
                device_split=split,
                trial_frames=b - a, padded_to=xv.shape[1],
                decoder_batch_lengths=mb.sum(1).tolist(),
                vad_losses=vad_losses, decoder_losses=dec_losses,
                tbptt_chunk_ms=tbptt_ms / chunks, tbptt_trial_ms=tbptt_ms,
                decoder_step_ms_host_lengths=steps["after"],
                decoder_step_ms_mask_on_card=steps["before"])
            print(f"training path: one {b - a}-frame trial (padded to "
                  f"{xv.shape[1]}), 30 passes: nVAD TBPTT loss "
                  f"{np.mean(vad_losses[:5]):.4f} -> "
                  f"{np.mean(vad_losses[-5:]):.4f}, decoder loss "
                  f"{np.mean(dec_losses[:5]):.4f} -> "
                  f"{np.mean(dec_losses[-5:]):.4f}; TBPTT chunk step "
                  f"{tbptt_ms / chunks:.3f} ms (events, {chunks} a trial); "
                  f"decoder step on a padded batch {mb.sum(1).tolist()} "
                  f"{steps['after']} ms with host lengths, "
                  f"{steps['before']} ms with the mask on the card (events "
                  f"over 10 steps), one unpadded trial {unpadded_ms:.2f} ms; "
                  f"device split (profiler) {split}")
            if not (np.mean(vad_losses[-5:]) < np.mean(vad_losses[:5])
                    and np.mean(dec_losses[-5:]) < np.mean(dec_losses[:5])
                    and np.all(np.isfinite(vad_losses + dec_losses))):
                raise AssertionError("the training loss did not fall")

            # -- the synthesis queue alone: time a job
            zero_counts()
            t0 = time.perf_counter()
            queue = AsynchronousSynthesisQueue(device=dev)
            for npy in jobs[:3]:
                queue.add_job(str(npy))
            queue.wait()
            job_ms = (time.perf_counter() - t0) * 1e3 / 3
            q_launches = read_counts()["dsp_synthesis"]
            tp["synthesis_job_ms"] = job_ms
            tp["synthesis_job_frames"] = [len(np.load(p)) for p in jobs[:3]]
            print(f"synthesis queue: {job_ms:.1f} ms a job "
                  f"({tp['synthesis_job_frames']} frames), D1 launches "
                  f"{q_launches}")
            if q_launches != 3:
                raise AssertionError(f"synthesis queue: {q_launches} D1 "
                                     f"launches for 3 jobs")

            # -- the card-trained checkpoints through the online loader
            vad = UnidirectionalVoiceActivityDetector(2, 150, 64).to(dev)
            vad.load_state_dict(load_checkpoint(
                str(base / "vad" / "best_model.pth"), 2, False, "classifier"))
            dec = BidirectionalSpeechSynthesisModel(2, 100, 64).to(dev)
            dec.load_state_dict(load_checkpoint(
                str(base / "dec" / "best_model.pth"), 2, True, "regressor"))
            with torch.no_grad():
                xin = torch.as_tensor(xt[None], device=dev)
                speech = torch.softmax(vad.eval()(xin)[0], -1)[0, :, 1]
                feats = dec.eval()(xin)[0][0].cpu().numpy()
            zero_counts()
            pcm = LPCNet(backend="dsp", device=dev).synthesize_frames(feats)
            online = read_counts()["dsp_synthesis"]
            if online != 1 or len(pcm) != len(feats) * 160 or \
                    not np.all(np.isfinite(feats)) or \
                    not bool(torch.isfinite(speech).all()):
                raise AssertionError(f"online load: {len(pcm)} samples for "
                                     f"{len(feats)} frames, D1 {online}")
            print(f"card-trained checkpoints through load_checkpoint: VAD "
                  f"speech share {float((speech > 0.5).float().mean()):.2f}, "
                  f"decoder -> DSP vocoder {len(pcm)} samples")

            # -- the card's audio scored on the in-repo speech corpus
            subprocess.run([sys.executable, str(ROOT / "tools" /
                                                "make_speech_corpus.py"),
                            str(base / "speech"), "--seconds", "4", "--seed",
                            "777"], check=True, capture_output=True,
                           timeout=300)
            val = base / "speech" / "val"
            _, audio = wavread(val / "val_00.wav")
            words = {w.name.split("_")[1]: wavread(w)[1]
                     for w in sorted(val.glob("kw_*_0.wav"))}
            scores = tp["scores"] = {}
            zero_counts()
            rt = quality.score_roundtrip(
                audio[:16000], LPCNet(backend="dsp", device=dev), device=dev)
            scores["dsp"] = dict(cepstral_distance_db=rt.cepstral_distance_db,
                                 band_level_snr_db=rt.band_level_snr_db,
                                 launches=read_counts())
            for name, weights in (("b1", "vocoder_speech.npz"),
                                  ("b8", "vocoder_speech_b8.npz")):
                zero_counts()
                voc = LPCNet(backend="net", weights=str(ROOT / "weights" /
                                                         weights), device=dev)
                rt = quality.score_roundtrip(audio[:16000], voc, device=dev)
                voc.reset_decoder()
                f = LPCFeatureEncoder(device=dev).compute_LPC_features(
                    audio[:32000])
                syn = voc.synthesize_frames(f)
                n = min(len(syn), 32000)
                st = quality.stoi(audio[:n], syn[:n])
                originals, resyn = {}, {}
                for word, w_audio in words.items():
                    f = LPCFeatureEncoder(device=dev).compute_LPC_features(
                        w_audio)
                    voc.reset_decoder()
                    originals[word] = [w_audio[:len(f) * 160]]
                    resyn[word] = [voc.synthesize_frames(f)[:len(f) * 160]]
                acc = quality.keyword_id_accuracy(originals, resyn, device=dev)
                scores[name] = dict(
                    weights=weights, cepstral_distance_db=rt.cepstral_distance_db,
                    band_level_snr_db=rt.band_level_snr_db, stoi=st,
                    keyword_id_accuracy=acc, keywords=len(words),
                    launches=read_counts())
            print(f"scores on tools/make_speech_corpus.py --seconds 4 --seed "
                  f"777: {scores}")
            gates = [("dsp CD < 22 dB", scores["dsp"]["cepstral_distance_db"]
                      < 22.0)]
            for name in ("b1", "b8"):
                sc = scores[name]
                gates += [(f"{name} CD < 6 dB", sc["cepstral_distance_db"] < 6.0),
                          (f"{name} STOI >= 0.70", sc["stoi"] >= 0.70),
                          (f"{name} keyword ID >= 0.75",
                           sc["keyword_id_accuracy"] >= 0.75)]
            failed = [g for g, ok in gates if not ok]
            if len(words) != 6 or failed:
                raise AssertionError(f"quality gates failed: {failed} "
                                     f"({len(words)} keywords)")
        tp["wall_s"] = time.perf_counter() - t_phase
        print(f"training path phase: {tp['wall_s']:.1f} s wall")
    ph.run("training path (corpus -> nVAD and decoder training -> synthesis "
           "queue -> scores)", training_path)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    report["nvidia_smi"] = card
    report["failed_phases"] = ph.failed
    if report_path:
        Path(report_path).parent.mkdir(parents=True, exist_ok=True)
        Path(report_path).write_text(json.dumps(report, indent=1))
    if ph.failed:
        print(f"chip_smoke: failed phases {ph.failed}", file=sys.stderr)
        return 1

    meta = {
        "log_power": ("cuda", "dss_tpu_torch/csrc/log_power.cu",
                      "dss_tpu/ops/pallas/log_power.py:32"),
        "filter_log_power": ("cuda", "dss_tpu_torch/csrc/filter_log_power.cu",
                             "dss_tpu/ops/pallas/log_power.py:32"),
        "lpcnet_sampler_b1": (
            "cuda", "dss_tpu_torch/csrc/lpcnet_sampler_bunched.cu",
            "dss_tpu/ops/pallas/sampler.py:292"),
        "lpcnet_sampler_bunched": (
            "cuda", "dss_tpu_torch/csrc/lpcnet_sampler_bunched.cu",
            "dss_tpu/ops/pallas/sampler.py:827"),
        # No TPU kernel: the JAX package runs this loop as lax.scan.
        "dsp_synthesis": ("cuda", "dss_tpu_torch/csrc/dsp_synthesis.cu",
                          "dss_tpu/vocoder/dsp.py:67"),
    }
    # Each kernel's launches on the main path that runs it: the front-end
    # kernel and the sampler at bunch 1 (K2) on the bunch-1 word path, the
    # sampler at bunch 8 (K3) on the bunch-8 word path.  The standalone
    # log-power kernel is on neither path since the front-end kernel took
    # its place; its count is read on the bunch-8 path (0).  D1 on the
    # shipped configuration as the INI resolves on the card.
    path_of = {"log_power": "b8", "filter_log_power": "b1",
               "lpcnet_sampler_b1": "b1", "lpcnet_sampler_bunched": "b8",
               "dsp_synthesis": "ship_resolved"}
    # Every run whose counts were zeroed before it and read after it: the
    # word paths and the shipped configuration, and on the training path
    # corpus preparation (the front-end kernel once a trial), the decoder
    # app (D1 once a synthesis job) and the scoring (K2, K3, D1).
    tp = report["training_path"]
    runs = {p: mp["launches"] for p, mp in report["main_path"].items()}
    runs.update({"training_corpus": tp["corpus"]["launches"],
                 "training_decoder_app": tp["apps"]["decoder_launches"]})
    runs.update({f"scoring_{k}": v["launches"]
                 for k, v in tp["scores"].items()})
    kernels = []
    for name, (route, src, replaces) in meta.items():
        k = report["kernels"][name]
        kernels.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces,
            "launches": report["main_path"][path_of[name]]["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "launches_by_path": {p: c[name] for p, c in runs.items()}})
        if "plan" in k:  # the sampler: blocks per stream, weights on chip
            kernels[-1].update(
                cluster=k["plan"]["cluster"],
                resident_bytes_per_block=k["plan"]["resident_bytes"])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", default=None,
                        help="Also write every measurement to this JSON file.")
    sys.exit(main(parser.parse_args().report))
