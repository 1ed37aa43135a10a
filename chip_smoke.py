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
   The net path's LPC (D4, ``lpc_frames``) and de-emphasis (D5,
   ``deemphasis``), no TPU kernel behind either, at 1, 15 and 16 streams x
   50 frames: one launch a call, bit for bit with ``lpc_frames_plain`` and
   ``deemphasis_plain``; timed by torch.profiler, events and a
   synchronized call, beside their bounds and the routes they replaced
   (the eager LPC, the blocked de-emphasis) as the library yardstick.
   Every word-path, scale-out and serving run below asserts D4 and D5
   once a synthesis block (as often as the sampler).
   The DSP vocoder's whole call (D1, no TPU kernel behind it: frame
   parameters, noise and the frame-parallel sample loop in one launch) on
   seeded features with voiced and unvoiced frames and periods 32-256, at
   one stream x 260 frames (a word), eight x 50, one x 1 and one x 3600
   (a synthesis-queue job): ``dsp_synthesis`` (given parameters) bit for
   bit with its plain version ``dsp_synthesis_blocked_plain`` run on the
   CPU, pcm and carried state, and within the JAX parity tolerance (PCM
   atol 1e-5, int16 1 LSB, phase exact, state atol 1e-5) of the serial
   loop compiled for the host (``dsp_synthesis_host``); ``dsp_vocode``
   (features) one launch a call, its prologue's parameters and noise bit
   for bit with the eager ``frame_parameters`` and ``gaussian_noise`` on
   the card and its pcm with the blocked plain version on them; through
   the vocoder 100 frames must equal 50 + 50 bit for bit; timed at the
   three shapes by torch.profiler and events beside an empty launch, with
   its bound and the new design's chain estimate.
   The word decoder's inference forward (D3, no TPU kernel behind it: the
   deployed 2 x 100 bidirectional LSTM and its Linear(200 -> 20) regressor
   in one launch), seeded, on one row at T = 137 and 250 and on three
   ragged rows from a random state, features to the next multiple of 50:
   ``bilstm_decode`` one launch a call, features and final (h, c) bit for
   bit with ``bilstm_decode_plain`` on the same CUDA tensors; timed at one
   row, T = 137 and 250, by torch.profiler and events, with the word path's
   decode call (copy in, launch, read back), its bound and chain estimate,
   beside cuDNN's packed run as the word head called it before D3 (the
   library yardstick: padded input and mask, TF32 off; device time and
   operations a call).
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
   size), D3 once a word and once in the word unit's warm-up, and the
   eager cascade must not run on a CUDA tensor.  After each
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
   D3 once per word plus the decoder's warm-up call, D1 once per word
   through ``dsp_vocode``, and neither the eager cascade,
   the eager Levinson nor D1's plain versions on a CUDA tensor.
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
   Then vocoder training (dss_tpu_torch.apps.train_vocoder, the full-width
   model: GRU-A 384, GRU-B 32, cond 128): D2 (``lpc_recursion``, the
   trainer's teacher-forced LPC recursion; no TPU kernel behind it) against
   its plain version at B = 32 x 2400 samples in both modes (all four
   outputs bit for bit), timed by the profiler and events beside its bound
   and chain estimate; one full-width teacher-forced step on the card
   against the CPU (B = 4, on the card's recursion: loss rtol 1e-5, every
   gradient rtol 1e-4 + 1e-4 of its tensor's largest element); the app on
   tools/make_speech_corpus.py --seconds 30 --seed 778 at bunch 1 (four
   epochs: teacher-forced, scheduled sampling twice, free-running; pruning
   0.6 -> 0.2; validation on two val wavs of the seed-777 corpus through K2,
   the first scoring refused by the density gate, the second saved) and at
   bunch 8 (one teacher-forced epoch, K3 in its scoring), with D2 launched
   as predicted (once a teacher-forced or free-running step, twice a
   sampled one); the
   card-trained checkpoint keeping 43 of 216 GRU-A tiles, greedy through K2
   over 50 frames equal to the plain version, and loaded by LPCNet; each
   stage's ms a step (events) and device split (profiler); 30
   teacher-forced steps on one batch whose loss must fall; --resume of the
   bunch-8 run to a second epoch; one epoch's fine-tune of weights/vocoder_speech.npz at lr
   1e-5 (its mask inherited) scored with the gates above.
   Then the single-card remainder: an LPCNet checkpoint in the xiph Keras
   layout at the released widths (dense GRU-A 384, GRU-B 16, embedding and
   conditioning 128, pitch embedding 64, the MDense inner biases), built
   in memory from a seed (tests/torch_xiph.py) and mapped by
   ``vocoder.interop.params_from_datasets``, greedy through K2 over 50
   frames and over one whole-call 300-frame block (the pitch net's
   same-padded conditioning) against the float32 plain version on the
   host (samples atol 1e-6; the runs may part only after their encoded
   inputs straddle a mu-law level edge), timed, with the kernel's plan
   (GRU-A streamed, not resident) and LPCNet on it;
   weights/vocoder_speech_b8.npz exported to the Keras datasets and
   re-imported (every array bit for bit), greedy through K3 equal to the
   direct load.  The contamination permutation test on a synthetic
   10-minute, 128-channel day: 10,000 surrogates on the card, the first 16
   against the numpy plain version (rtol 1e-4, on a pool of host
   processes), with the criterion P.  And the bunch-1 word path's session
   once more over a real socket (the port's amplifier as a process of its
   own, the graph's ZMQConnector) under ``utils.profiling.device_trace``:
   every packet ingested and the words equal to the in-process replay's
   bit for bit; the device's busy share, the top kernels, the kernels a
   packet call and a word (by launching thread); it fails without CUDA
   kernel events or without the front-end kernel and the sampler in the
   trace.
   Then the scale-out slice at world 1 (phase "scale-out"): make_mesh(1)
   on a world-1 NCCL group (one all-reduce); ShardedFusedDecoderVocoder at
   8 streams (the deployed decoder, 64 electrodes; the live slot plus 7
   segments of other lengths cut from the session's bursts) in the word
   path's graph on the session replayed as fast as the graph takes it,
   with vocoder_speech.npz (K2 at B = 8) and vocoder_speech_b8.npz (K3 at
   B = 8), counts zeroed before each run and read after it; then the three
   words again through a chunked and a single-shot unit: every slot's
   audio equal bit for bit, T_i x 160 samples, the head (decode + 8 first
   chunks + one read) and each tail chunk timed, the sampler's launches
   and device time and the card's busy share from ``device_trace``; K2 on
   one 50-frame block at B = 1,
   8, 16, the card's cluster limit (kernel_plan's max_active_clusters) and
   one past it, with the real-time streams B x 0.5 s / block time; K2
   greedy at the largest B and K3 b8 at B = 8 against the plain version
   (2 frames, atol 1e-5 up to any parting, which must follow a straddled
   mu-law edge); dss_tpu_torch.apps.serve_multichip at 8 and 16 streams
   (its JSON line); the data-parallel decoder, nVAD and vocoder steps at
   world 1 (deployed and shipped widths) against the plain single-card
   steps' losses (rtol 1e-6).
   Then the replication pipeline (phase "replicate"):
   dss_tpu_torch.apps.replicate, replicate.sh's eight stages at the
   reference's epochs (nVAD 8, decoder 20), on
   tools/make_replicate_dataset.py --speech --vocoder net --seed 0 (four
   days of twice the six keywords, a 33 s online session of six words)
   with its INI on vocoder_speech.npz (K2 on the live path), a free port
   and a 6 s idle timeout: the contamination analysis, corpus
   preparation (in memory where h5py is missing), both trainings, the
   normalization statistics, supplementary figure 2 (arrays; drawn where
   matplotlib imports), the replay amplifier as its own process held back
   until the decoder logs "starting sources", and the live decoder over
   ZMQ.  Then stages 4-8 once more with the decoder trained 100 epochs
   (RETRAINED_DECODER_EPOCHS: at 20 it has not converged and every word
   renders as one).  Each run is scored by eval/score_closed_loop.py
   (online against offline resynthesis through K2, the online squelch)
   and eval/score_speech_run.py (keyword ID and STOI against the session's
   own templates and the speaker-shifted ones of
   tools/make_speech_corpus.py --shifted-val --seed 777).  It fails unless
   in each run every stage completes, 80% of the segments map to words,
   the reco wavs and the stdout PCM hold the logged LPC frames x 160
   samples, the mean |online - offline| is at most 1 dB and the front-end
   kernel and K2 launched, and unless keyword ID against the shifted
   templates is above 1/6 in the second run.
   Then the ports of the JAX package's last tools (phase "tools"), the
   kernels' counts zeroed before the phase and read after it:
   dss_tpu_torch.eval.score_exteval on tools/make_hnm_corpus.py's corpus
   at seed 515151 (2 variants x 2 registers, 24 utterances) through
   vocoder_speech.npz at temperatures 1.0 and 1.3, held to the JAX
   package's gates (tests/test_exteval_hnm.py: keyword ID >= 0.75, CD <
   12.4 dB, margin median >= 0.08); tools/torch_make_import_fixture.py's
   released-width xiph datasets (GRU-A 384 dense, GRU-B 16, pitch
   embedding, inner biases) and its 3 s .f32 through
   tools/torch_vocoder_ab.py with --rtf, against the DSP rendering of the
   same file (K2 must launch, D1 once); tools/torch_sampler_microbench.py
   (sparse-f32 and bunch8-sparse, 100 frames, chains of 8, the shipped
   checkpoint's tile pattern), whose us/sample must lie within 20% of
   PERF.md's K2 and b8 block times; tools/torch_bucket_sweep.py --synthetic
   200 --measure --multiples 25 50 100 on the deployed decoder; and
   dss_tpu_torch.graft_entry: entry()'s forward, then dryrun_multichip(1)
   on a world-1 NCCL group, all seven steps.  K2 and K3 must launch.
4. Prints the kernels' line, latencies, the card's name and power limit,
   and last `{"ok": true, "device": {...}}`.  Any failure exits non-zero
   without that line.  ``--report PATH`` also writes every measurement
   as JSON.

Imports torch, numpy and scipy only (no jax, nothing of dss_tpu).
"""

import argparse
import json
import logging
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager
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


def device_ms(fn, n, name=None):
    """(device ms a call, device operations a call) over n calls of ``fn``
    under torch.profiler: the kernels whose name holds ``name``, or every
    operation on the card."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and (name is None or name in e.key)]
    total = sum(getattr(e, "self_device_time_total", None)
                or e.self_cuda_time_total for e in ev)
    return (total / n / 1e3 if total > 0 else None), \
        sum(e.count for e in ev) / n


def host_ms(fn, n):
    """Median host ms of a call of ``fn`` (which synchronizes itself, or
    is timed for its launches alone)."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return pct(times, 50)


def session(seconds=16.0, bursts=((2.0, 3.5), (7.0, 8.5), (12.0, 13.5)),
            seed=7):
    """The synthetic session of tools/make_verify_fixtures.py (6 s, one
    loud burst at 2.0-3.5 s), continued with two more bursts so that a run
    also shows word heads after the first: its first 6 s are that
    fixture's samples, rounded to float32 as the amplifier's packets carry
    them, so a replay in-process and one over ZMQ feed the graph the same
    values."""
    fs = 1000
    rng = np.random.default_rng(seed)
    T = int(seconds * fs)
    envelope = np.full(T, 0.05)
    for start, stop in bursts:
        envelope[int(start * fs):int(stop * fs)] = 2.0
    return (rng.normal(size=(T, 129)) * envelope[:, None]).astype(
        np.float32).astype(np.float64)


def rolled_measures(a_path, b_path, max_lag, shifts):
    """The contamination test's plain version on one pool worker:
    ``lagged_correlation_measure`` of the audio spectrogram (``a_path``,
    .npy) rolled by each of ``shifts`` against the channels' (``b_path``)
    -> [(measure, seconds it took)]."""
    from dss_tpu_torch.eval import contamination as tc
    a, b = np.load(a_path), np.load(b_path, mmap_mode="r")
    out = []
    for shift in shifts:
        t0 = time.perf_counter()
        m, _ = tc.lagged_correlation_measure(np.roll(a, int(shift), axis=0),
                                             b, max_lag)
        out.append((m, time.perf_counter() - t0))
    return out


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextmanager
def amplifier(mat, port, timeout=60.0):
    """The port's replay amplifier (``dss_tpu_torch.apps.
    development_amplifier``) as a process of its own, streaming ``mat`` on
    ``port`` in 40-sample packets.  It is imported first (this waits for
    that) and starts streaming when the graph logs that its sources start,
    so that neither its start-up nor the units' warm-ups eat into the
    connector's idle window.  On exit it is waited for (killed after
    ``timeout`` s) and must have exited cleanly."""
    err_path = Path(mat).with_suffix(".amplifier.log")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from dss_tpu_torch.apps import "
             "development_amplifier as a; print('imported', flush=True); "
             "sys.stdin.readline(); a.main(sys.argv[1:])",
             str(mat), "--package_size", "40", "--port", str(port)],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, text=True)
    if proc.stdout.readline().strip() != "imported":
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the amplifier did not start: "
                             f"{err_path.read_text()[-2000:]}")
    started = []

    class Go(logging.Handler):
        def emit(self, record):
            if "starting sources" in record.getMessage() and not started:
                proc.stdin.write("go\n")
                proc.stdin.flush()
                started.append(time.perf_counter())

    graph_log = logging.getLogger("dss_tpu_torch.runtime")
    handler, level = Go(), graph_log.level
    graph_log.addHandler(handler)
    graph_log.setLevel(logging.INFO)
    try:
        yield
    finally:
        graph_log.removeHandler(handler)
        graph_log.setLevel(level)
        if not started:
            proc.kill()
        try:
            proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"the amplifier exited {proc.returncode}: "
                             f"{err_path.read_text()[-2000:]}")


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


def mulaw_index(x):
    """The mu-law level of each value, in float64 on the host."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log1p(255.0)
    return np.rint((y + 1.0) * 127.5).astype(np.int64)


def parting(ks, ps, sig0, lpc, tol, frame=160):
    """Where a greedy kernel run ``ks`` parts from its plain version ``ps``
    (float64 [N] each): ``first``, the first sample more than ``tol`` apart
    (None if none is); ``max_before``, the largest difference before it;
    ``straddle``, the first step at or before it whose mu-law-encoded
    inputs (the newest sample, and the LPC prediction recomputed in
    float64 from each run's own history) fall on two levels in the two
    runs, or None.  ``sig0`` is the carried history (newest first),
    ``lpc`` [T, P] the frames' taps."""
    d = np.abs(ks - ps)
    over = np.flatnonzero(d > tol)
    first = int(over[0]) if len(over) else None
    end = len(ks) if first is None else first + 1
    P = len(sig0)

    def encoded(s):
        hist = np.concatenate([sig0[::-1], s[:end]])  # oldest first
        win = np.lib.stride_tricks.sliding_window_view(hist, P)[:end, ::-1]
        pred = -(win * lpc[np.arange(end) // frame]).sum(1)
        return mulaw_index(win[:, 0]), mulaw_index(pred)
    (sk, pk), (sp, pp) = encoded(ks), encoded(ps)
    straddle = np.flatnonzero((sk != sp) | (pk != pp))
    return dict(first=first, max_before=float(d[:end - (first is not None)]
                                              .max(initial=0.0)),
                straddle=int(straddle[0]) if len(straddle) else None)


def device_split(fn, warm=True):
    """One call of ``fn`` under torch.profiler, after a warm call unless
    ``warm`` is false (the caller ran it already): (host wall ms with a
    synchronize, device ms summed over its kernel records, kernel count, the
    three kernels with the most device time)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
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


def speech_corpus(out, seconds, seed):
    """tools/make_speech_corpus.py into ``out`` (train/utt_*.wav, val/)."""
    subprocess.run([sys.executable, str(ROOT / "tools" /
                                        "make_speech_corpus.py"),
                    str(out), "--seconds", str(seconds), "--seed", str(seed)],
                   check=True, capture_output=True, timeout=300)


def net_scores(voc, audio, words, dev):
    """The JAX package's quality measures of a neural vocoder: cepstral
    distance and band SNR of a 1 s round trip, STOI over 2 s, keyword ID
    over the keyword recordings ``words`` ({word: int16 audio})."""
    from dss_tpu_torch.eval import quality
    from dss_tpu_torch.vocoder.features import LPCFeatureEncoder
    rt = quality.score_roundtrip(audio[:16000], voc, device=dev)
    voc.reset_decoder()
    f = LPCFeatureEncoder(device=dev).compute_LPC_features(audio[:32000])
    syn = voc.synthesize_frames(f)
    n = min(len(syn), 32000)
    st = quality.stoi(audio[:n], syn[:n])
    originals, resyn = {}, {}
    for word, w_audio in words.items():
        f = LPCFeatureEncoder(device=dev).compute_LPC_features(w_audio)
        voc.reset_decoder()
        originals[word] = [w_audio[:len(f) * 160]]
        resyn[word] = [voc.synthesize_frames(f)[:len(f) * 160]]
    acc = quality.keyword_id_accuracy(originals, resyn, device=dev)
    return dict(cepstral_distance_db=rt.cepstral_distance_db,
                band_level_snr_db=rt.band_level_snr_db, stoi=st,
                keyword_id_accuracy=acc, keywords=len(words))


def net_gates(name, sc):
    """The JAX package's gates for a neural vocoder's ``net_scores``."""
    return [(f"{name} CD < 6 dB", sc["cepstral_distance_db"] < 6.0),
            (f"{name} STOI >= 0.70", sc["stoi"] >= 0.70),
            (f"{name} keyword ID >= 0.75", sc["keyword_id_accuracy"] >= 0.75)]


@contextmanager
def eager_cascade_forbidden():
    """While the block runs, the eager IIR cascade raises on a CUDA tensor
    (the front-end kernel must run in its place); yields the shapes it was
    tried on, which a unit's thread may otherwise swallow."""
    from dss_tpu_torch.ops import filter_log_power as flp_mod
    from dss_tpu_torch.ops import filters as filters_mod
    from dss_tpu_torch.ops import hga as hga_mod
    from dss_tpu_torch.ops.filters import sosfilt_scan
    on_card = []

    def guard(sos, x, zi):
        if x.is_cuda:
            on_card.append(tuple(x.shape))
            raise AssertionError("eager cascade on the card")
        return sosfilt_scan(sos, x, zi)
    mods = (hga_mod, filters_mod, flp_mod)
    for m in mods:
        m.sosfilt_scan = guard
    try:
        yield on_card
    finally:
        for m in mods:
            m.sosfilt_scan = sosfilt_scan


def correct_fraction(confusion):
    """Keyword ID from a confusion table ({word: {predicted: count}}),
    unrounded: the reports round it to 4 decimals, and 1/6 rounds above
    1/6."""
    total = sum(sum(row.values()) for row in confusion.values())
    return sum(row.get(word, 0) for word, row in confusion.items()) / total


# replicate.sh trains the decoder 20 epochs.  On the --speech tree that
# leaves it far from converged (validation MSE 1.54 against 0.19 at 100
# epochs, where JAX's headline run ended: 0.188) and every word renders as
# the same one, keyword ID at the 1-in-6 chance level (PERF.md).
# The phase therefore runs the pipeline at the reference's epochs, and
# then stages 4-8 again with the decoder trained this many epochs: the
# keyword gate reads that second run.
RETRAINED_DECODER_EPOCHS = 100


def score_replication(run_dir, base, shifted_dir, weights, pcm_bytes):
    """A replication's closed-loop run scored: the segments and samples
    logged, online against offline resynthesis (eval/score_closed_loop.py
    with the online squelch), keyword ID and STOI against the session's
    own and the speaker-shifted templates (eval/score_speech_run.py)."""
    from dss_tpu_torch.eval import score_closed_loop, score_speech_run
    try:
        feats, recos = score_closed_loop.read_segments(run_dir)
        closed = score_closed_loop.score_run(
            run_dir, str(weights), quiet_sharpen=True, device="cuda")
        speech = score_speech_run.score_run(run_dir, str(base),
                                            str(shifted_dir), device="cuda")
    except SystemExit as e:  # the scorers' refusals, as failures
        raise AssertionError(f"scoring the run: {e}") from None
    own, shifted = speech["vs_own_templates"], speech["vs_shifted_templates"]
    mapped = speech["n_segments_scored"]
    return dict(
        segments=len(feats), lpc_frames=sum(len(f) for f in feats),
        reco_samples=sum(len(r) for r in recos), pcm_bytes=pcm_bytes,
        segments_mapped=mapped,
        segments_emitted=mapped + speech["n_segments_unmapped"],
        words_covered=speech["words_covered"],
        closed_loop={k: v for k, v in closed.items() if k != "segments"},
        closed_loop_abs_delta_db_mean=float(np.mean(
            [abs(r["delta_db"]) for r in closed["segments"]])),
        keyword_id={"own": correct_fraction(own["confusion"]),
                    "shifted": correct_fraction(shifted["confusion"])},
        stoi={"own": own.get("stoi_mean"), "shifted": shifted.get("stoi_mean")},
        confusion={"own": own["confusion"], "shifted": shifted["confusion"]})


def replication_gates(sc, launches):
    """The gates every replication run holds to (the keyword gate is
    added by the caller)."""
    return [
        ("80% of the segments map to a word",
         sc["segments_mapped"] >= 0.8 * sc["segments_emitted"]),
        ("reco samples == LPC frames x 160",
         sc["reco_samples"] == sc["lpc_frames"] * 160),
        ("stdout PCM == reco samples x 2 bytes",
         sc["pcm_bytes"] == sc["reco_samples"] * 2),
        ("mean |online - offline| <= 1.0 dB",
         sc["closed_loop_abs_delta_db_mean"] <= 1.0),
        ("the front-end kernel launched", launches["filter_log_power"] > 0),
        ("K2 launched", launches["lpcnet_sampler_b1"] > 0),
    ]


def print_replication(name, sc):
    cl = sc["closed_loop"]
    print(f"  [{name}] segments emitted {sc['segments_emitted']}, mapped to "
          f"words {sc['segments_mapped']} ({sc['words_covered']}); "
          f"{sc['lpc_frames']} LPC frames, {sc['reco_samples']} reco "
          f"samples, {sc['pcm_bytes']} PCM bytes")
    print(f"  [{name}] keyword ID own {sc['keyword_id']['own']:.4f} (STOI "
          f"{sc['stoi']['own']}), shifted {sc['keyword_id']['shifted']:.4f} "
          f"(STOI {sc['stoi']['shifted']}); JAX on a TPU over 109 words "
          f"(SPEECHRUN_r05.json): own 0.33, shifted 0.67; confusion "
          f"{sc['confusion']}")
    print(f"  [{name}] online vs offline over {cl['n_segments']} segments: "
          f"mean |delta| {sc['closed_loop_abs_delta_db_mean']:.3f} dB, mean "
          f"{cl['delta_db_mean']} dB, max |delta| {cl['delta_db_max']} dB "
          f"(online {cl['online_db_mean']}, offline {cl['offline_db_mean']} "
          f"dB)")


def replicate_phase(zero_counts, read_counts):
    """replicate.sh's eight stages on the port (``apps.replicate``), with
    the reference's epochs (8 and 20), on tools/make_replicate_dataset.py
    --speech --vocoder net --seed 0 (two repetitions of the six keywords a
    day); its INI copied with the shipped bunch-1 checkpoint on the live
    path, a free port and a 6 s idle timeout.  Then stages 4-8 once more
    with the decoder trained RETRAINED_DECODER_EPOCHS.  Each closed-loop
    run is scored against the session's own templates and speaker-shifted
    ones (tools/make_speech_corpus.py --shifted-val --seed 777).  The
    kernels' counts are zeroed just before each run and read just after
    it."""
    from dss_tpu_torch.apps import replicate

    weights = ROOT / "weights" / "vocoder_speech.npz"
    out = {"retrained_decoder_epochs": RETRAINED_DECODER_EPOCHS}
    with tempfile.TemporaryDirectory() as tmp:
        base, temp = Path(tmp) / "data", Path(tmp) / "temp"
        shifted = Path(tmp) / "shifted" / "val_shifted"
        t0 = time.perf_counter()
        makers = [subprocess.Popen(
            [sys.executable, str(ROOT / "tools" / tool), str(out_dir), *args],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for tool, out_dir, args in (
                ("make_replicate_dataset.py", base,
                 ["--speech", "--vocoder", "net", "--seed", "0", "--reps",
                  "2", "--temp-dir", str(temp)]),
                ("make_speech_corpus.py", shifted.parent,
                 ["--seconds", "4", "--seed", "777", "--shifted-val"]))]
        for maker in makers:
            _, err = maker.communicate(timeout=300)
            if maker.returncode != 0:
                raise AssertionError(f"{maker.args[1]}: {err[-2000:]}")
        out["dataset_s"] = time.perf_counter() - t0
        ini = Path(tmp) / "replicate.ini"
        lines = []
        for line in (base / "replicate_settings.ini").read_text() \
                .splitlines():
            key = line.split("=")[0].strip()
            if key == "vocoder_weights":
                line = f"vocoder_weights = {weights}"
            elif key == "port":
                line = f"port = {free_port()}"
            elif key == "idle_timeout":
                line = "idle_timeout = 6"
            lines.append(line)
        ini.write_text("\n".join(lines) + "\n")
        cfg = replicate.ReplicateConfig.from_env(dict(
            DATA_DIR=str(base / "KeywordReading"),
            NORM_DIR=str(base / "SyllableRepetition"),
            LIVE_DIR=str(base / "KeywordReading" / "online_sessions"),
            TEMP_DIR=str(temp), SETTINGS=str(ini)), device="cuda")
        rep = replicate.Replication(cfg)
        epochs = replicate.DECODER_EPOCHS
        for name, first in (("reference", 1), ("retrained", 4)):
            cfg.stage = first
            replicate.DECODER_EPOCHS = epochs if first == 1 \
                else RETRAINED_DECODER_EPOCHS
            try:
                with eager_cascade_forbidden() as on_card:
                    zero_counts()
                    t0 = time.perf_counter()
                    stages = rep.run()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = read_counts()
            finally:
                replicate.DECODER_EPOCHS = epochs
            if on_card:
                raise AssertionError(f"the eager cascade ran on the card "
                                     f"{len(on_card)} times")
            if sorted(stages) != list(range(first, 9)):
                raise AssertionError(f"{name}: stages run {sorted(stages)}")
            sc = score_replication(stages[8]["run_dir"], base, shifted,
                                   weights, stages[8]["pcm_bytes"])
            sc.update(wall_s=wall, launches=launches,
                      stage_s={n: r["seconds"] for n, r in stages.items()},
                      decoder_history=stages[4]["history"])
            if first == 1:
                sc.update(
                    vad_history=stages[3]["history"],
                    corpus_in_memory=stages[2]["in_memory"],
                    figures={"contamination_report": stages[1]["figure"],
                             "suppl_fig_2": stages[6]["figure"]},
                    suppl_fig_2_trials=stages[6]["trials_used"])
            out[name] = sc
    ref, re_ = out["reference"], out["retrained"]
    out["launches"] = ref["launches"]
    print(f"replicate: dataset {out['dataset_s']:.1f} s; at the reference's "
          f"epochs, stages 1-8 in {ref['wall_s']:.1f} s: "
          f"{ref['stage_s']}; corpus kept in memory: "
          f"{ref['corpus_in_memory']}")
    print("  nVAD losses by epoch (train, valid, valid acc): "
          + str([(round(h["train_loss"], 4), round(h["valid_loss"], 4),
                  round(h["valid_acc"], 4)) for h in ref["vad_history"]]))
    print("  decoder losses by epoch (train, valid): "
          + str([(round(h["train_loss"], 4), round(h["valid_loss"], 4))
                 for h in ref["decoder_history"]]))
    print(f"  figures drawn: {ref['figures']} (None: matplotlib is not "
          f"installed; the arrays are saved); suppl. fig. 2 over "
          f"{ref['suppl_fig_2_trials']} trials")
    print_replication("reference epochs", ref)
    print(f"  launches {ref['launches']}")
    h = re_["decoder_history"]
    print(f"  stages 4-8 again, the decoder trained "
          f"{RETRAINED_DECODER_EPOCHS} epochs, in {re_['wall_s']:.1f} s: "
          f"{re_['stage_s']}; decoder losses (train, valid) at epochs 20, "
          f"50, {len(h)}: " + str([(round(h[k - 1]['train_loss'], 4),
                                     round(h[k - 1]['valid_loss'], 4))
                                    for k in (20, 50, len(h))]))
    print_replication(f"decoder {RETRAINED_DECODER_EPOCHS} epochs", re_)
    print(f"  launches {re_['launches']}")
    gates = [(f"reference epochs: {g}", ok)
             for g, ok in replication_gates(ref, ref["launches"])]
    gates += [(f"decoder {RETRAINED_DECODER_EPOCHS} epochs: {g}", ok)
              for g, ok in replication_gates(re_, re_["launches"])]
    gates.append((f"decoder {RETRAINED_DECODER_EPOCHS} epochs: keyword ID "
                  f"vs shifted templates > 1/6",
                  re_["keyword_id"]["shifted"] > 1.0 / 6.0))
    out["gates"] = {name: bool(ok) for name, ok in gates}
    failed = [name for name, ok in gates if not ok]
    if failed:
        raise AssertionError(f"replicate gates failed: {failed}")
    return out


# The sampler's time a sample at the shipped widths and sparsity, PERF.md's
# kernel table (PR 3 review round): K2 23.9 ms and K3 at bunch 8 8.7 ms a
# 50-frame block of 8,000 samples.  The microbench must land within 20%.
MICROBENCH_US_PER_SAMPLE = {"sparse-f32": 23.9e3 / 8000,
                            "bunch8-sparse": 8.7e3 / 8000}
# The JAX package's gates of the out-of-family eval
# (tests/test_exteval_hnm.py:106-108).
EXTEVAL_GATES = dict(keyword_id=0.75, cd_db=12.4, margin_median=0.08)


def tools_phase(zero_counts, read_counts):
    """The last JAX tools' ports at full width on the card, the kernels'
    counts zeroed before and read after: the two-register HNM eval through
    vocoder_speech.npz (the JAX gates), the xiph import fixture at the
    released widths through the A/B harness against the DSP rendering of
    its features (K2, D1), the sampler microbench (K2, K3 at bunch 8), the
    bucket sweep measured on the deployed decoder, and the graft entry's
    forward and its seven-step dry run on a world-1 NCCL group (K3 at bunch
    2)."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_bucket_sweep
    import torch_make_import_fixture as fixture
    import torch_sampler_microbench
    import torch_vocoder_ab

    from dss_tpu_torch import graft_entry
    from dss_tpu_torch.eval import score_exteval
    from dss_tpu_torch.vocoder.lpcnet import LPCNet

    out = {}
    t_phase = time.perf_counter()
    zero_counts()
    seen = read_counts()

    def count(name):
        """The launches since the last item, by kernel."""
        nonlocal seen
        now = read_counts()
        out[name]["launches"] = {k: now[k] - seen[k] for k in now}
        seen = now

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- the two-register harmonic-plus-noise eval (EXTEVAL)
        t0 = time.perf_counter()
        art = score_exteval.main([
            "--corpus-dir", str(tmp / "hnm"), "--out", str(tmp / "ext.json"),
            "--weights", str(ROOT / "weights" / "vocoder_speech.npz"),
            "--seed", "515151", "--variants", "2", "--temps", "1.0,1.3",
            "--headline-temp", "1.0", "--device", "cuda"])
        out["exteval"] = dict(
            seconds=time.perf_counter() - t0,
            utterances=art["num_utterances"],
            keyword_id=art["keyword_id_accuracy"],
            cd_db=art["cepstral_distance_db_mean"],
            stoi=art.get("stoi_mean"), margin_min=art.get("margin_min"),
            margin_median=art.get("margin_median"),
            per_register=art["per_register"],
            sweep=art["temperature_sweep"], confusion=art["confusion"])
        count("exteval")
        ex = out["exteval"]
        registers = {r: v["accuracy"] for r, v in ex["per_register"].items()}
        sweep = [(q["temperature_scale"], q["keyword_id_accuracy"],
                  q["cepstral_distance_db_mean"]) for q in ex["sweep"]]
        print(f"exteval (HNM seed 515151, 2 variants x 2 registers, "
              f"{ex['utterances']} utterances, vocoder_speech.npz, temps 1.0 "
              f"and 1.3) in {ex['seconds']:.1f} s: keyword ID "
              f"{ex['keyword_id']} (JAX on a TPU: 20/24), CD {ex['cd_db']} "
              f"dB, STOI {ex['stoi']}, margin min {ex['margin_min']} median "
              f"{ex['margin_median']}; accuracy by register {registers}; "
              f"(temperature, keyword ID, CD) {sweep}; launches "
              f"{ex['launches']}")

        # -- the import fixture through the A/B harness
        t0 = time.perf_counter()
        datasets = fixture.foreign_datasets()
        f32 = tmp / "feats.f32"
        feats = fixture.write_feature_file(str(f32), 3.0, device="cuda")
        ref = LPCNet(backend="dsp", device="cuda").synthesize_frames(feats)
        ref.astype(np.int16).tofile(tmp / "ref.pcm")
        ab = torch_vocoder_ab.main(
            [str(f32), "--rtf", "--ref-pcm", str(tmp / "ref.pcm"), "--out",
             str(tmp / "ours.wav"), "--device", "cuda"], datasets=datasets)
        out["vocoder_ab"] = dict(seconds=time.perf_counter() - t0,
                                 frames=ab["frames"], rtf=ab["rtf"],
                                 ab=ab["ab"], rms=ab["rms"], peak=ab["peak"])
        count("vocoder_ab")
        va = out["vocoder_ab"]
        print(f"import fixture (released widths: GRU-A 384 dense, GRU-B 16, "
              f"pitch embedding, inner biases) through torch_vocoder_ab on "
              f"{va['frames']} frames: {va['rtf']}; A/B against the DSP "
              f"rendering: {va['ab']}; launches {va['launches']}")

    # -- the sampler microbench at the shipped checkpoint's tile pattern
    t0 = time.perf_counter()
    mb = torch_sampler_microbench.main(
        ["--frames", "100", "--chain", "8", "--reps", "2", "--variants",
         "sparse-f32,bunch8-sparse", "--weights",
         str(ROOT / "weights" / "vocoder_speech.npz"), "--device", "cuda"])
    out["microbench"] = dict(seconds=time.perf_counter() - t0, variants=mb,
                             perf_md_us_per_sample=MICROBENCH_US_PER_SAMPLE)
    count("microbench")

    # -- the bucket sweep, measured on the deployed decoder
    t0 = time.perf_counter()
    lines = torch_bucket_sweep.main(
        ["--synthetic", "200", "--measure", "--multiples", "25", "50", "100",
         "--device", "cuda"])
    out["bucket_sweep"] = dict(seconds=time.perf_counter() - t0, lines=lines)
    count("bucket_sweep")

    # -- the graft entry: the forward step, then the dry run at world 1
    t0 = time.perf_counter()
    forward, (model, segment) = graft_entry.entry("cuda")
    pred = forward(model, segment)
    torch.cuda.synchronize()
    try:
        dry = graft_entry.dryrun_multichip(1, device="cuda")
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out["graft_entry"] = dict(seconds=time.perf_counter() - t0,
                              forward_shape=tuple(pred.shape),
                              forward_finite=bool(torch.isfinite(pred).all()),
                              backend=backend, dryrun=dry)
    count("graft_entry")
    print(f"graft entry: forward {tuple(pred.shape)}; dry run on {backend}: "
          f"{sorted(dry)}; launches {out['graft_entry']['launches']}")

    out["launches"] = read_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"tools phase: {out['phase_s']:.1f} s; launches {out['launches']}")
    gates = [
        ("exteval keyword ID >= 0.75",
         ex["keyword_id"] >= EXTEVAL_GATES["keyword_id"]),
        ("exteval CD < 12.4 dB", ex["cd_db"] < EXTEVAL_GATES["cd_db"]),
        ("exteval margin median >= 0.08",
         (ex["margin_median"] or 0) >= EXTEVAL_GATES["margin_median"]),
        ("exteval 24 utterances", ex["utterances"] == 24),
        ("A/B: K2 launched", va["launches"]["lpcnet_sampler_b1"] > 0),
        ("A/B: finite CD",
         bool(np.isfinite(va["ab"]["cepstral_distance_db"]))),
        ("A/B: 300 frames", va["frames"] == 300),
        ("graft entry forward [1, 100, 20], finite",
         out["graft_entry"]["forward_shape"] == (1, 100, 20)
         and out["graft_entry"]["forward_finite"]),
        ("dry run: all seven steps on NCCL",
         backend == "nccl" and {"decoder_loss", "vad_loss", "vocoder_loss",
                                "serving_pcm_shape", "word_path_shapes",
                                "graph_shapes", "chunked"} <= set(dry)),
        ("bucket sweep: a recommendation",
         "recommended_length_multiple" in lines[-1]),
        ("phase: K2 launched", out["launches"]["lpcnet_sampler_b1"] > 0),
        ("phase: K3 launched", out["launches"]["lpcnet_sampler_bunched"] > 0),
        ("phase: D1 once, the one DSP rendering",
         out["launches"]["dsp_synthesis"] == 1),
    ]
    for name, want in MICROBENCH_US_PER_SAMPLE.items():
        got = mb[name]["us_per_sample"]
        gates.append((f"microbench {name}: {got:.3f} us/sample within 20% of "
                      f"{want:.3f}", abs(got - want) <= 0.2 * want))
    out["gates"] = {name: bool(ok) for name, ok in gates}
    failed = [name for name, ok in gates if not ok]
    if failed:
        raise AssertionError(f"tools gates failed: {failed}")
    return out


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
    from dss_tpu_torch.models.decoder import \
        BidirectionalSpeechSynthesisModel, hold_last_frame
    from dss_tpu_torch.models.lstm import run_lstm, seeded_init
    from dss_tpu_torch.ops.bilstm import bilstm_decode, \
        bilstm_decode_plain, decoder_weights, kernel_plan as bilstm_plan
    from dss_tpu_torch.ops.cepstrum_lpc import lpc_frames, lpc_frames_plain
    from dss_tpu_torch.ops.deemphasis import deemphasis, deemphasis_plain
    from dss_tpu_torch.ops.log_power import log_power, log_power_plain
    from dss_tpu_torch.ops.lpc_recursion import lpc_recursion, \
        lpc_recursion_plain
    from dss_tpu_torch.ops.sampler import kernel_plan, \
        prepare_sampler_weights, sampler_frames, sampler_frames_bunched, \
        sampler_frames_bunched_plain, sampler_frames_plain, \
        tile_sparse_pattern
    from dss_tpu_torch.vocoder import net as tnet
    from dss_tpu_torch.vocoder import lpc as lpc_mod
    from dss_tpu_torch.vocoder.lpc import bands_from_cepstrum, lpc_from_bands
    from dss_tpu_torch.vocoder.lpcnet import _load_params
    from dss_tpu_torch.utils.profiling import device_trace, trace_files, \
        trace_summary
    from dss_tpu_torch.vocoder.mulaw import MULAW_LEVELS

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_make_verify_fixtures import threshold_vad

    dev = resolve_device("cuda")
    ph = Phases()
    report = {"kernels": {}, "main_path": {}}
    outputs = {}  # main path run -> (the words' PCM, their decoded features)

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
        block_kernels()

    def blocked_deemphasis(sig, y0, consts):
        """The de-emphasis the port ran before D5 (the library yardstick,
        never called by the port): a [160 x 160] in-frame product, an
        [L x L] product over the frame ends, the carries, the clip."""
        M_t, a_k, Q_t, a_j = consts
        B, N = sig.shape
        z = sig.reshape(B, N // 160, 160) @ M_t
        c = z[..., -1] @ Q_t + a_j * y0[:, None]
        c_prev = torch.cat([y0[:, None], c[:, :-1]], dim=1)
        y = (z + c_prev[..., None] * a_k).reshape(B, N)
        return torch.clamp(y, -1.0, 1.0), y[:, -1]

    def block_kernels():
        """D4 (the LPC) and D5 (the de-emphasis) at the net path's block
        shapes, 1, 15 and 16 streams x 50 frames: bit for bit with their
        plain versions on the same tensors, one launch a call; each timed
        by the profiler (its kernel) and the host clock (a synchronized
        call), beside its bound (bytes and operations; D5 also its
        dependent chain) and the route it replaced as ``library_ms`` (the
        eager LPC lpc_from_bands(bands_from_cepstrum(.)) with the copy to
        [L, B, 16]; the blocked de-emphasis)."""
        k = np.arange(160)
        d = k[:, None] - k[None, :]
        A = lpc_mod.PREEMPH ** 160
        j = np.arange(50)
        dj = j[:, None] - j[None, :]
        consts = tuple(torch.tensor(np.asarray(x), dtype=torch.float32,
                                    device=dev) for x in (
            np.where(d >= 0, lpc_mod.PREEMPH ** np.maximum(d, 0), 0.0).T,
            lpc_mod.PREEMPH ** (k + 1.0),
            np.where(dj >= 0, A ** np.maximum(dj, 0), 0.0).T,
            A ** (j + 1.0)))
        d4 = report["kernels"]["cepstrum_lpc"] = {"shapes": {}}
        d5 = report["kernels"]["deemphasis"] = {"shapes": {}}
        # Per frame: 18 x 18, 18 x 161 and 161 x 17 multiply-adds, 18
        # powers, the lag window and Levinson (~576); 18 floats in, 16 out,
        # and the tables once.
        d4_flops = 2 * (18 * 18 + 18 * 161 + 161 * 17) + 18 + 17 + 576
        tab_bytes = 4 * (17 * 256 + 18 * 32 + 18 * 161 + 17)
        for B in (1, 15, 16):
            g = torch.Generator().manual_seed(40 + B)
            feats = torch.randn((B, 52, 20), generator=g) * 0.3
            feats[..., 0] -= 4.0
            view = feats.to(dev)[:, 2:]
            n0 = lpc_frames.launches
            taps = lpc_frames(view)
            torch.cuda.synchronize()
            launches4 = lpc_frames.launches - n0
            equal4 = torch.equal(taps, lpc_frames_plain(view))
            lib_taps = lpc_from_bands(bands_from_cepstrum(
                view[..., :18]))[0].transpose(0, 1)
            lib_err = float((taps - lib_taps).abs().max())
            sig = torch.randn((B, 8000), generator=g) * 0.3
            y0 = torch.randn((B,), generator=g)
            sig_d, y0_d = sig.to(dev), y0.to(dev)
            out = torch.empty_like(sig_d)
            n0 = deemphasis.launches
            last = deemphasis(sig_d, y0_d, out)
            torch.cuda.synchronize()
            launches5 = deemphasis.launches - n0
            want = deemphasis_plain(sig.numpy(), y0.numpy())
            equal5 = np.array_equal(out.cpu().numpy(), want) and \
                np.array_equal(last.cpu().numpy(), want[:, -1])
            old_pcm, _ = blocked_deemphasis(sig_d, y0_d, consts)
            old_err = float((old_pcm - out.clamp(-1.0, 1.0)).abs().max())

            def lib4():
                return lpc_from_bands(bands_from_cepstrum(
                    view[..., :18]))[0].transpose(0, 1).contiguous()

            def synced(fn):
                def run():
                    fn()
                    torch.cuda.synchronize()
                return run

            run4 = lambda: lpc_frames(view)  # noqa: E731
            run5 = lambda: deemphasis(sig_d, y0_d, out)  # noqa: E731
            lib5 = lambda: blocked_deemphasis(sig_d, y0_d, consts)  # noqa
            ms4, _ = device_ms(run4, 50, "cepstrum_lpc_kernel")
            ms5, _ = device_ms(run5, 50, "deemphasis_kernel")
            lib4_ms, lib4_ops = device_ms(lib4, 10)
            lib5_ms, lib5_ops = device_ms(lib5, 20)
            frames = B * 50
            b4, f4 = frames * 34 * 4 + tab_bytes, frames * d4_flops
            b5, f5 = B * 8000 * 8 + B * 8, B * 8000 * 2
            t4b, t4f = b4 / H100_BYTES_PER_S, f4 / H100_F32_FLOPS
            t5b, t5f = b5 / H100_BYTES_PER_S, f5 / H100_F32_FLOPS
            d4["shapes"][f"B{B}"] = dict(
                launches=launches4, bit_equal=equal4,
                library_max_abs_diff=lib_err, profiler_ms=ms4,
                events_ms=cuda_ms(run4, 50), call_ms=host_ms(synced(run4),
                                                             50),
                library_ms=lib4_ms, library_ops=lib4_ops,
                library_call_ms=host_ms(synced(lib4), 20),
                bound_ms=max(t4b, t4f) * 1e3,
                bound_by="bytes" if t4b > t4f else "operations",
                bytes=b4, flops=f4)
            d5["shapes"][f"B{B}"] = dict(
                launches=launches5, bit_equal=equal5,
                library_max_abs_diff=old_err, profiler_ms=ms5,
                events_ms=cuda_ms(run5, 50), call_ms=host_ms(synced(run5),
                                                             50),
                library_ms=lib5_ms, library_ops=lib5_ops,
                library_call_ms=host_ms(synced(lib5), 20),
                bound_ms=max(t5b, t5f) * 1e3,
                bound_by="bytes" if t5b > t5f else "operations",
                bytes=b5, flops=f5,
                # 8000 dependent multiply-add pairs of ~8 clocks.
                chain_estimate_ms=8000 * 8 / H100_BOOST_HZ * 1e3)
            print(f"D4 at {B} x 50: bit for bit {equal4}, {launches4} "
                  f"launch(es), {ms4} ms (profiler), call "
                  f"{d4['shapes'][f'B{B}']['call_ms']:.3f} ms; library "
                  f"route {lib4_ms} ms in {lib4_ops:.0f} operations, call "
                  f"{d4['shapes'][f'B{B}']['library_call_ms']:.3f} ms, max "
                  f"diff {lib_err:.3g}; bound "
                  f"{d4['shapes'][f'B{B}']['bound_ms']:.2g} ms")
            print(f"D5 at {B} x 8000 samples: bit for bit {equal5}, "
                  f"{launches5} launch(es), {ms5} ms (profiler), call "
                  f"{d5['shapes'][f'B{B}']['call_ms']:.3f} ms; blocked "
                  f"route {lib5_ms} ms in {lib5_ops:.0f} operations, call "
                  f"{d5['shapes'][f'B{B}']['library_call_ms']:.3f} ms, max "
                  f"diff {old_err:.3g}; bound "
                  f"{d5['shapes'][f'B{B}']['bound_ms']:.2g} ms, chain "
                  f"{d5['shapes'][f'B{B}']['chain_estimate_ms']:.3f} ms")
            if launches4 != 1 or not equal4 or launches5 != 1 or not equal5 \
                    or not old_err <= 1e-5:
                raise AssertionError(f"D4 / D5 at {B} x 50: "
                                     f"{d4['shapes'][f'B{B}']} "
                                     f"{d5['shapes'][f'B{B}']}")
        for kern in (d4, d5):
            one = kern["shapes"]["B1"]
            kern.update(max_abs_err=0.0, plain_ms=None,
                        ms=one["profiler_ms"] if one["profiler_ms"]
                        is not None else one["events_ms"],
                        ms_from="profiler" if one["profiler_ms"] is not None
                        else "events",
                        library_ms=one["library_ms"],
                        bound_ms=one["bound_ms"], bound_by=one["bound_by"])
    ph.run("chunk invariance on the card (100 frames == 2 x 50, b1 and b8); "
           "D4 and D5 at 1, 15 and 16 x 50 frames vs plain, timed",
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

    # ---- D1: the DSP vocoder's whole call ------------------------------------
    from dss_tpu_torch.ops import dsp_synthesis as d1_mod
    from dss_tpu_torch.ops.dsp_synthesis import DspCarry, dsp_synthesis, \
        dsp_synthesis_blocked_plain, dsp_synthesis_host, dsp_vocode
    from dss_tpu_torch.vocoder import dsp as tdsp
    d1 = report["kernels"]["dsp_synthesis"] = {"cases": {}}

    def d1_inputs(batch, frames, seed):
        """Seeded inputs on the CPU: features with voiced and unvoiced frames
        and periods 32-256, their frame-rate part, Gaussian noise and a
        nonzero carried state."""
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(batch, frames, 20)).astype(np.float32) * .3
        feats[..., 0] -= 2.0
        feats[..., 18] = rng.uniform(-1.36, 3.12, size=(batch, frames))
        feats[..., 19] = np.where(rng.random((batch, frames)) < 0.6,
                                  rng.uniform(0.0, 0.5, (batch, frames)),
                                  rng.uniform(-0.5, -0.2, (batch, frames)))
        feats = torch.as_tensor(feats)
        params = tdsp.frame_parameters(feats)
        noise = torch.as_tensor(rng.normal(size=(batch, frames, 160))
                                .astype(np.float32))
        carry = DspCarry(
            torch.as_tensor(rng.normal(size=(batch, 16)).astype(np.float32))
            * 0.1,
            torch.as_tensor(rng.integers(-3, 200, batch).astype(np.int32)),
            torch.as_tensor(rng.normal(size=batch).astype(np.float32)) * 0.1)
        return feats, (*params, noise), carry

    def serial_gap(pcm, out, ref, ref_out):
        """The kernel against the serial loop, in the terms of the JAX
        parity tolerance (tests/test_torch_dsp.py)."""
        def to16(x):
            return np.clip(x.cpu().numpy() * 32767.0, -32768, 32767).astype(
                np.int16).astype(np.int32)
        gap = dict(
            pcm=float((pcm.cpu() - ref).abs().max()),
            int16=int(np.abs(to16(pcm) - to16(ref)).max()),
            phase_equal=torch.equal(out.pitch_phase.cpu(),
                                    ref_out.pitch_phase),
            sig_mem=float((out.sig_mem.cpu() - ref_out.sig_mem).abs().max()),
            deemph=float((out.deemph_mem.cpu()
                          - ref_out.deemph_mem).abs().max()))
        gap["within"] = bool(gap["pcm"] <= 1e-5 and gap["int16"] <= 1
                             and gap["phase_equal"] and gap["sig_mem"] <= 1e-5
                             and gap["deemph"] <= 1e-5)
        return gap

    def d1_check():
        names = ("lpc", "gain", "v_mix", "voiced", "period", "noise")
        for batch, frames in ((1, 260), (8, 50), (1, 1), (1, 3600)):
            feats, inputs, carry = d1_inputs(batch, frames, frames)
            on_card = DspCarry(*(t.to(dev) for t in carry))
            n0 = dsp_synthesis.launches
            pcm, out = dsp_synthesis(*(t.to(dev) for t in inputs), on_card)
            torch.cuda.synchronize()
            launches = dsp_synthesis.launches - n0
            # The serial reference: the loop compiled for the host (bit for
            # bit with the numpy loop, tests/test_torch_dsp_host.py); the
            # first call builds and loads it.
            dsp_synthesis_host(*inputs, carry)
            t0 = time.perf_counter()
            host, host_out = dsp_synthesis_host(*inputs, carry)
            host_s = time.perf_counter() - t0
            case = d1["cases"][f"B{batch}_T{frames}"] = dict(
                launches=launches, host_loop_cpu_s=host_s,
                serial_gap=serial_gap(pcm, out, host, host_out),
                voiced_share=float(inputs[3].float().mean()),
                periods=[int(inputs[4].min()), int(inputs[4].max())])
            if frames <= 260:
                t0 = time.perf_counter()
                want, want_out = dsp_synthesis_blocked_plain(*inputs, carry)
                case["plain_cpu_s"] = time.perf_counter() - t0
                case["bit_equal"] = torch.equal(pcm.cpu(), want) and all(
                    torch.equal(a.cpu(), b) for a, b in zip(out, want_out))
                # The prologue: the eager frame-rate part and noise on the
                # card, then the blocked plain version on what it computed.
                fd = feats.to(dev)
                n1 = dsp_vocode.launches
                pcm2, out2, prm = dsp_vocode(fd, on_card, 7, 1000,
                                             return_params=True)
                torch.cuda.synchronize()
                case["vocode_launches"] = dsp_vocode.launches - n1
                eager = (*tdsp.frame_parameters(fd),
                         tdsp.gaussian_noise(7, batch, 1000, frames, dev))
                case["prologue_max_abs_err"] = {
                    n: float((a.float() - b.float()).abs().max())
                    for n, a, b in zip(names, prm, eager)}
                case["prologue_bit_equal"] = all(
                    torch.equal(a, b) for a, b in zip(prm, eager))
                want2, want2_out = dsp_synthesis_blocked_plain(
                    *(t.cpu() for t in prm), carry)
                case["vocode_bit_equal"] = torch.equal(
                    pcm2.cpu(), want2) and all(
                    torch.equal(a.cpu(), b) for a, b in zip(out2, want2_out))
            print(f"D1 B={batch} T={frames}: {launches} launch; "
                  + (f"bit-equal to the blocked plain version "
                     f"{case['bit_equal']} ({case['plain_cpu_s']:.2f} s on "
                     f"the CPU); dsp_vocode {case['vocode_launches']} launch, "
                     f"prologue bit-equal to the eager frame-rate part and "
                     f"noise {case['prologue_bit_equal']} "
                     f"{case['prologue_max_abs_err']}, pcm and state "
                     f"bit-equal to the blocked plain version on them "
                     f"{case['vocode_bit_equal']}; " if frames <= 260 else "")
                  + f"against the serial host loop ({host_s * 1e3:.1f} ms): "
                  f"{case['serial_gap']}")
            ok = launches == 1 and case["serial_gap"]["within"] \
                and pcm.shape == (batch, frames * 160)
            if frames <= 260:
                ok = ok and case["bit_equal"] and case["vocode_bit_equal"] \
                    and case["prologue_bit_equal"] \
                    and case["vocode_launches"] == 1
            if not ok:
                raise AssertionError(f"D1 B={batch} T={frames}: {case}")
        d1["plain_ms"] = d1["cases"]["B1_T260"]["plain_cpu_s"] * 1e3
        d1["host_loop_ms"] = d1["cases"]["B1_T260"]["host_loop_cpu_s"] * 1e3
        d1["max_abs_err"] = 0.0  # bit for bit with its plain version
        d1["serial_max_abs_err"] = max(
            c["serial_gap"]["pcm"] for c in d1["cases"].values())
        # 100 frames in one call equal 50 + 50, through the vocoder.
        g = np.random.default_rng(4)
        feats = torch.as_tensor(g.normal(size=(2, 100, 20)).astype(
            np.float32) * 0.3, device=dev)
        st = tdsp.dsp_vocoder_init(4, 2, dev)
        n0 = dsp_vocode.launches
        whole, s_whole = tdsp.dsp_synthesize_frames(st, feats)
        p1, s1 = tdsp.dsp_synthesize_frames(st, feats[:, :50])
        p2, s2 = tdsp.dsp_synthesize_frames(s1, feats[:, 50:])
        torch.cuda.synchronize()
        same = torch.equal(torch.cat([p1, p2], dim=1), whole) and all(
            torch.equal(a, b) for a, b in zip(s2[:3], s_whole[:3]))
        d1["chunk_invariance_100_eq_50_50"] = same
        print(f"D1 through the vocoder, 100 frames == 50 + 50 bit for bit: "
              f"{same} ({dsp_vocode.launches - n0} dsp_vocode launches)")
        if not same or not bool(whole.abs().max() > 0) \
                or dsp_vocode.launches - n0 != 3:
            raise AssertionError("D1: chunked != single-shot")
    ph.run("D1 DSP vocoder vs its plain versions (B=1 T=260, B=8 T=50, "
           "T=1, T=3600 against the serial loop; 100 == 50 + 50)", d1_check)

    def d1_timing():
        clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        shapes = {}
        for batch, frames in ((1, 260), (8, 50), (1, 3600)):
            feats, inputs, carry = d1_inputs(batch, frames, 1)
            fd = feats.to(dev)
            cc = DspCarry(*(t.to(dev) for t in carry))
            run = lambda: dsp_vocode(fd, cc, 0, 0)  # noqa: E731
            dev_ms, records = profiled_ms(run, 20, "dsp_synthesis_kernel")
            ev_ms = cuda_ms(run, 20)
            times = []  # the host's part of a call: enqueue to synchronize
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            shapes[f"B{batch}_T{frames}"] = dict(
                profiler_ms=dev_ms, profiler_records=records, events_ms=ev_ms,
                call_ms_p50=pct(times, 50))
        lib = _cuda.library()
        stream = torch.cuda.current_stream().cuda_stream
        empty = lambda: _cuda.check(  # noqa: E731
            lib.dss_empty_launch(1, stream), "empty")
        floor_prof, _ = profiled_ms(empty, 200, "empty_kernel")
        clocks.terminate()
        # What the kernel's prologue took off the path: the eager
        # frame-rate part and noise of a word on the card (host clock, a
        # synchronize after each).
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
            d1["eager_" + name] = pct(times, 50)
        mhz = [int(v) for v in clocks.communicate()[0].split()
               if v.strip().isdigit()]
        clock = (pct(mhz, 50) or H100_BOOST_HZ / 1e6) * 1e6
        T = 260
        # Bytes of a word's call: features in (80 a frame), pcm out (640 a
        # frame), the state in and out.
        nbytes = T * (80 + 640) + 2 * (64 + 4 + 4)
        # Operations a frame: the sample loop's ~42 a sample (16 products,
        # 15 sums, the excitation, the subtraction, de-emphasis, clip); the
        # frame-rate part's products (DCT 18 x 18, bands 18 x 161, lags 161
        # x 17, each a product and a sum), Levinson (~2 x 136 + 3 x 16) and
        # the noise's Box-Muller (~6 a sample).
        flops = T * (160 * 42 + 2 * (18 * 18 + 18 * 161 + 161 * 17)
                     + 2 * 136 + 48 + 160 * 6)
        t_b, t_f = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
        # The new design's chain: phases C and E each run a frame's 160
        # samples (6 dependent operations a sample), phase D T steps of a
        # product, a 4-level tree and a sum (6); ~4 clocks an operation.
        chain_ms = (2 * 160 * 6 + T * 6) * 4 / clock * 1e3
        word = shapes["B1_T260"]
        dev_ms = word["profiler_ms"]
        d1.update(
            shapes=shapes, launch_floor_profiler_ms=floor_prof,
            ms=dev_ms if dev_ms is not None else word["events_ms"],
            ms_from="profiler" if dev_ms is not None else "events",
            us_per_sample=(dev_ms or word["events_ms"]) * 1e3 / (T * 160),
            bound_ms=max(t_b, t_f) * 1e3,
            bound_by="bytes" if t_b > t_f else "operations", bytes=nbytes,
            flops=flops, chain_estimate_ms=chain_ms,
            sm_clock_mhz=dict(min=min(mhz, default=None), median=pct(mhz, 50),
                              max=max(mhz, default=None)))
        print("D1 (dsp_vocode, one launch a call): " + "; ".join(
            f"{k}: profiler {v['profiler_ms']} ms over "
            f"{v['profiler_records']} records, events {v['events_ms']:.4f} "
            f"ms, a synchronized call {v['call_ms_p50']:.3f} ms"
            for k, v in shapes.items())
            + f"; empty launch {floor_prof} ms; blocked plain version (CPU) "
            f"{d1['plain_ms']:.0f} ms a word; bound {d1['bound_ms']:.2e} ms "
            f"({d1['bound_by']}); chain estimate {chain_ms:.4f} ms at "
            f"{clock / 1e6:.0f} MHz; SM clock {d1['sm_clock_mhz']}; what the "
            f"prologue replaced (eager, host clock, p50 of 5): frame-rate "
            f"part {d1['eager_frame_rate_ms']:.2f} ms, noise "
            f"{d1['eager_noise_ms']:.2f} ms")
    ph.run("D1 timing (profiler, events; B=1 T=260, B=8 T=50, B=1 T=3600)",
           d1_timing)

    # ---- D3: the word decoder ---------------------------------------------
    # The deployed decoder (2 x 100 bidirectional, 64 inputs, 20 outputs),
    # seeded, at the word path's shapes: features to the next multiple of 50.
    d3 = report["kernels"]["bilstm_decoder"] = {"cases": {}}
    D3_E, D3_H, D3_L, D3_F = 64, 100, 2, 20

    def d3_decoder():
        model = seeded_init(BidirectionalSpeechSynthesisModel(
            D3_L, D3_H, D3_E, nb_outputs=D3_F), 0).to(dev).eval()
        return model, decoder_weights(model.lstm, model.regressor)

    def d3_check():
        _model, w = d3_decoder()
        g = torch.Generator().manual_seed(3)
        # One row at T = 137 and 250 from zeros; three ragged rows (the
        # sharded unit's) from a random state; garbage in the padding.
        for lengths, state in (([137], False), ([250], False),
                               ([250, 137, 49], True)):
            B, T = len(lengths), max(lengths)
            x = torch.randn((B, T, D3_E), generator=g)
            for b, n in enumerate(lengths):
                x[b, n:] = 5.0
            st = tuple((0.3 * torch.randn((2 * D3_L, B, D3_H), generator=g)
                        ).to(dev) for _ in "hc") if state else None
            x = x.to(dev)
            Tp = -(-T // 50) * 50
            n0 = bilstm_decode.launches
            with torch.no_grad():
                feats, (h, c) = bilstm_decode(x, lengths, w, st, Tp)
            torch.cuda.synchronize()
            launches = bilstm_decode.launches - n0
            t0 = time.perf_counter()
            want, (wh, wc) = bilstm_decode_plain(x, lengths, w, st, Tp)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            pairs = ((feats, want), (h, wh), (c, wc))
            case = d3["cases"][f"B{B}_T{T}"] = dict(
                lengths=lengths, launches=launches, plain_ms=plain_ms,
                bit_equal=all(torch.equal(a, b) for a, b in pairs),
                max_abs_err=max(float((a - b).abs().max()) for a, b in pairs))
            print(f"D3 lengths {lengths}: {launches} launch; features and "
                  f"final state bit-equal to the plain version on the card "
                  f"{case['bit_equal']} (max error {case['max_abs_err']}; "
                  f"plain {plain_ms:.0f} ms)")
            if launches != 1 or not case["bit_equal"] \
                    or feats.shape != (B, Tp, D3_F):
                raise AssertionError(f"D3 {lengths}: {case}")
        d3["max_abs_err"] = 0.0  # bit for bit with its plain version
        d3["plain_ms"] = d3["cases"]["B1_T250"]["plain_ms"]
    ph.run("D3 word decoder vs its plain version (B=1 T=137 and 250, B=3 "
           "ragged)", d3_check)

    def d3_timing():
        from dss_tpu_torch.runtime.units import _decode_padded

        model, w = d3_decoder()

        def packed(data, T, Tp):
            """The word head's decode before D3 (the library yardstick,
            never called by the port): the input padded to Tp with a mask,
            cuDNN's packed run, the regressor, the repeat-pad."""
            x = torch.zeros((1, Tp, D3_E))
            x[0, :T] = torch.as_tensor(data)
            mask = torch.zeros((1, Tp))
            mask[0, :T] = 1.0
            y, _ = run_lstm(model.lstm, x.to(dev), None, mask=mask)
            return hold_last_frame(model.regressor(y), [T])

        weights = sum(p.numel() for p in model.parameters())
        rng = np.random.default_rng(0)
        shapes = {}
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                for T in (137, 250):
                    Tp = -(-T // 50) * 50
                    data = rng.normal(size=(T, D3_E)).astype(np.float32)
                    x = torch.as_tensor(data)[None].to(dev)
                    run = lambda: bilstm_decode(x, [T], w, None, Tp)  # noqa
                    dev_ms, _ = device_ms(run, 20, "bilstm_decoder_kernel")
                    lib_ms, lib_ops = device_ms(
                        lambda: packed(data, T, Tp), 10)
                    # Multiply-adds (x2): per layer and direction the input
                    # and recurrent products, then the regressor.
                    flops, width = 0.0, D3_E
                    for _ in range(D3_L):
                        flops += 2 * 2 * 4 * D3_H * (width + D3_H) * T
                        width = 2 * D3_H
                    flops += 2 * width * D3_F * T
                    # Bytes: the weights, the input, the features and the
                    # final state once.
                    nbytes = 4.0 * (weights + T * D3_E + Tp * D3_F
                                    + 2 * 2 * D3_L * D3_H)
                    t_b, t_f = nbytes / H100_BYTES_PER_S, \
                        flops / H100_F32_FLOPS
                    shapes[f"T{T}"] = dict(
                        profiler_ms=dev_ms, events_ms=cuda_ms(run, 100),
                        word_call_ms=host_ms(lambda: _decode_padded(
                            model, data, T, 50, dev)[1].cpu(), 20),
                        library_ms=lib_ms, library_ops=lib_ops,
                        library_call_ms=host_ms(
                            lambda: packed(data, T, Tp).cpu(), 20),
                        plain_ms=d3["cases"].get(f"B1_T{T}", {}).get(
                            "plain_ms"),
                        bound_ms=max(t_b, t_f) * 1e3,
                        bound_by="bytes" if t_b > t_f else "operations",
                        gflop=flops / 1e9, bytes=nbytes,
                        # L x T dependent steps (the directions run side by
                        # side) of ~700 clocks at the boost clock.
                        chain_estimate_ms=D3_L * T * 700 / H100_BOOST_HZ
                        * 1e3)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        word = shapes["T250"]
        d3.update(shapes=shapes,
                  kernel_plan=bilstm_plan(D3_E, D3_H, D3_L, D3_F),
                  ms=word["profiler_ms"] if word["profiler_ms"] is not None
                  else word["events_ms"],
                  ms_from="profiler" if word["profiler_ms"] is not None
                  else "events",
                  library_ms=word["library_ms"], bound_ms=word["bound_ms"],
                  bound_by=word["bound_by"],
                  chain_estimate_ms=word["chain_estimate_ms"])
        print("D3 (bilstm_decode, one launch a word; library: cuDNN's packed "
              "run as the word head called it, TF32 off): " + "; ".join(
                  f"{k}: " + ", ".join(f"{n} {v:.4g}" if isinstance(v, float)
                                       else f"{n} {v}" for n, v in r.items())
                  for k, r in shapes.items())
              + f"; plan {d3['kernel_plan']}")
    ph.run("D3 timing (profiler, events, the word call; cuDNN's packed run "
           "beside it; T=137 and 250)", d3_timing)

    # ---- the main path -----------------------------------------------------
    counters = {"log_power": log_power,
                "filter_log_power": filter_log_power,
                "dsp_synthesis": dsp_synthesis,
                "lpcnet_sampler_b1": sampler_frames,
                "lpcnet_sampler_bunched": sampler_frames_bunched,
                "lpc_recursion": lpc_recursion,
                "bilstm_decoder": bilstm_decode,
                "cepstrum_lpc": lpc_frames,
                "deemphasis": deemphasis}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    def once_a_block(launches, where):
        """D4 and D5 launch once a synthesis block: as often as the sampler
        (K2 or K3), which only net_synthesize_frames calls."""
        blocks = launches["lpcnet_sampler_b1"] + \
            launches["lpcnet_sampler_bunched"]
        if launches["cepstrum_lpc"] != blocks \
                or launches["deemphasis"] != blocks:
            raise AssertionError(
                f"{where}: D4 {launches['cepstrum_lpc']} and D5 "
                f"{launches['deemphasis']} launches for {blocks} sampler "
                f"launches (one each a synthesis block)")

    def main_path(key, weights_name, expect, trace_dir=None, zmq=False,
                  splits=True):
        """The word path through the graph, once; with ``trace_dir`` the
        run is recorded by ``device_trace`` into that directory.  With
        ``zmq`` the session comes over a real socket: the port's replay
        amplifier runs as a process of its own, publishing on a free local
        port from the moment the graph is up, and the graph's
        ``ZMQConnector`` ingests it, as a deployment does; otherwise
        ``PacketReplay`` replays it in-process.  ``splits`` also times a
        word head and a packet step part by part after the run."""
        from contextlib import nullcontext

        from scipy.io import savemat

        from dss_tpu_torch import runtime as ez
        from dss_tpu_torch.apps.decode_online import feature_transforms
        from dss_tpu_torch.models.decoder import \
            BidirectionalSpeechSynthesisModel
        from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
        from dss_tpu_torch.runtime.units import FusedDecoderVocoder, \
            FusedDecoderVocoderSettings, FusedFrontendVad, \
            FusedFrontendVadSettings, PacketReplay, PacketReplaySettings, \
            ZMQConnector, ZMQConnectorSettings

        class Sink(ez.Unit):
            RAW = ez.InputStream(ez.ClosedLoopMessage)
            AUDIO = ez.InputStream(ez.ClosedLoopMessage)
            WORD = ez.InputStream(ez.TimeSeriesMessage)
            LPC = ez.InputStream(ez.TimeSeriesMessage)

            def initialize(self):
                self.first_audio_ms, self.words, self.lpc = [], [], []
                self.packets = 0

            @ez.subscriber(RAW)
            async def on_raw(self, msg):
                self.packets += 1

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
            if zmq:
                mat, port = Path(tmp) / "session.mat", free_port()
                savemat(str(mat), {
                    "signal": session(), "states": {
                        "StimulusCode": np.zeros(16000, np.int16)},
                    "parameters": {
                        "SamplingRate": {"NumericValue": 1000},
                        "SourceChGain": {"NumericValue": np.ones(129)},
                        "Stimuli": {"Value": np.array([["Enter"]])}}})

            class System(ez.System):
                SOURCE = ZMQConnector() if zmq else PacketReplay()
                FRONTEND = FusedFrontendVad()
                WORDS = FusedDecoderVocoder()
                SINK = Sink()

                def configure(self):
                    self.SOURCE.apply_settings(
                        ZMQConnectorSettings(fs=1000, port=port,
                                             address="127.0.0.1",
                                             idle_timeout=3.0) if zmq else
                        PacketReplaySettings(data=session(), fs=1000,
                                             period=0.04))
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
                            (self.SOURCE.OUTPUT, self.SINK.RAW),
                            (self.FRONTEND.OUTPUT, self.WORDS.INPUT),
                            (self.WORDS.OUTPUT, self.SINK.AUDIO),
                            (self.WORDS.WORD, self.SINK.WORD),
                            (self.WORDS.LPC, self.SINK.LPC))

            system = System()
            amp = amplifier(mat, port) if zmq else nullcontext()
            with eager_cascade_forbidden() as eager_on_card, amp:
                zero_counts()
                t0 = time.perf_counter()
                with device_trace(trace_dir) if trace_dir else \
                        nullcontext():
                    ez.run_system(system)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
        sink = system.SINK
        outputs[key] = (sink.words, sink.lpc)
        mp = report["main_path"][key] = {"vocoder_weights": weights_name,
                                          "source": "zmq" if zmq else
                                          "replay"}
        mp.update(
            wall_s=wall, launches=launches, words=len(sink.words),
            word_frames=[len(x) for x in sink.lpc],
            packet_ms_p50=pct(system.FRONTEND.step_ms, 50),
            packet_ms_p95=pct(system.FRONTEND.step_ms, 95),
            packet_calls=len(system.FRONTEND.step_ms),
            packets_ingested=sink.packets,
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
        warm = len(system.FRONTEND._sizes)
        mp["front_end_expected_launches"] = mp["packet_calls"] + warm
        # D3 once a word and once in the word unit's warm-up.
        mp["decoder_expected_launches"] = len(sink.words) + 1
        if eager_on_card:
            raise AssertionError(f"the eager cascade ran on the card "
                                 f"{len(eager_on_card)} time(s)")
        if launches["filter_log_power"] != mp["packet_calls"] + warm:
            raise AssertionError(
                f"front-end kernel: {launches['filter_log_power']} launches "
                f"for {mp['packet_calls']} packet calls + {warm} warm-up "
                f"calls")
        if launches["bilstm_decoder"] != len(sink.words) + 1:
            raise AssertionError(
                f"D3: {launches['bilstm_decoder']} launches for "
                f"{len(sink.words)} words + 1 warm-up call")
        once_a_block(launches, f"main path {key}")
        for name in expect:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"main path with {weights_name}")
        if not splits:
            return
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
            words._voc.vocode(feats[:, :50]).cpu()
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

            # D1's plain versions and the eager Levinson must not run on a
            # CUDA tensor: the word's vocode call is one dsp_vocode launch.
            eager = {(d1_mod, "dsp_synthesis_plain"): 1,
                     (d1_mod, "dsp_synthesis_blocked_plain"): 1,
                     (lpc_mod, "levinson"): 0}
            saved = {k: getattr(*k) for k in eager}

            def guarded(target, arg):
                def guard(*args, **kw):
                    if args[arg].is_cuda:
                        on_card.append(target[1])
                        raise AssertionError(f"{target[1]} on the card")
                    return saved[target](*args, **kw)
                return guard
            mods = (hga_mod, filters_mod, flp_mod)
            for m in mods:
                m.sosfilt_scan = cascade_guard
            for target, arg in eager.items():
                setattr(*target, guarded(target, arg))
            try:
                zero_counts()
                dsp_vocode.launches = 0
                t0 = time.perf_counter()
                with open(Path(tmp) / "audio.pcm", "w") as fd, \
                        redirect_stdout(fd):
                    ez.run_system(system)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
                vocode_launches = dsp_vocode.launches
            finally:
                for m in mods:
                    m.sosfilt_scan = sosfilt_scan
                for target, fn in saved.items():
                    setattr(*target, fn)
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
            decoder_expected_launches=len(words) + 1,
            dsp_expected_launches=len(words), dsp_vocode_launches=vocode_launches)
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
        # D3 once a word and once in RecurrentNeuralDecodingModel's warm-up.
        if launches["bilstm_decoder"] != len(words) + 1:
            raise AssertionError(f"D3: {launches['bilstm_decoder']} launches "
                                 f"for {len(words)} words + 1 warm-up call")
        if launches["dsp_synthesis"] != len(words) \
                or vocode_launches != len(words):
            raise AssertionError(f"D1: {launches['dsp_synthesis']} launches, "
                                 f"{vocode_launches} through dsp_vocode, for "
                                 f"{len(words)} words")
        once_a_block(launches, f"shipped config {key}")
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
            patched = []

            def counted_patch(self, data):
                patched.append(data.is_cuda)
                return patch_call(self, data)
            patch_call = BadChannelCorrection.__call__
            BadChannelCorrection.__call__ = counted_patch
            try:
                with eager_cascade_forbidden() as eager_on_card:
                    zero_counts()
                    t0 = time.perf_counter()
                    corpus = pc.prepare(base / "corpus", norm_dir,
                                        [data_dir], device=dev)
                    torch.cuda.synchronize()
                    prep_s = time.perf_counter() - t0
                    launches = read_counts()
            finally:
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
            speech_corpus(base / "speech", 4, 777)
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
                scores[name] = dict(weights=weights,
                                    **net_scores(voc, audio, words, dev),
                                    launches=read_counts())
            print(f"scores on tools/make_speech_corpus.py --seconds 4 --seed "
                  f"777: {scores}")
            gates = [("dsp CD < 22 dB", scores["dsp"]["cepstral_distance_db"]
                      < 22.0)]
            for name in ("b1", "b8"):
                gates += net_gates(name, scores[name])
            failed = [g for g, ok in gates if not ok]
            if len(words) != 6 or failed:
                raise AssertionError(f"quality gates failed: {failed} "
                                     f"({len(words)} keywords)")
        tp["wall_s"] = time.perf_counter() - t_phase
        print(f"training path phase: {tp['wall_s']:.1f} s wall")
    ph.run("training path (corpus -> nVAD and decoder training -> synthesis "
           "queue -> scores)", training_path)

    # ---- vocoder training ----------------------------------------------------
    def vocoder_training():
        """D2 against its plain version; a full-width teacher-forced step on
        the card against the CPU; the training app at bunch 1 (all three
        loss stages, the prune ramp, best-by-validation scored through K2)
        and at bunch 8 (K3); the card-trained checkpoint on the sampler
        kernel's sparse path; each stage's step time; a falling loss;
        --resume; a fine-tune of the shipped checkpoint, scored with the
        JAX package's gates."""
        import shutil

        from scipy.io.wavfile import read as wavread

        from dss_tpu_torch.apps import train_vocoder as voc_app
        from dss_tpu_torch.ops.sampler import compact_gru_a_tiles
        from dss_tpu_torch.train.trainer_vocoder import VocoderTrainer
        from dss_tpu_torch.vocoder.lpcnet import LPCNet

        vt = report["vocoder_training"] = {}
        t_phase = time.perf_counter()

        # -- D2 against its plain version at the trainer's shape (B = 32
        # chunks of 15 frames), both modes: all four outputs bit for bit
        g = torch.Generator().manual_seed(21)
        B, T = 32, 15
        S = T * 160
        f = torch.randn((B, T, 20), generator=g) * 0.3
        f[..., 0] -= 4.0
        lpc, _ = lpc_from_bands(bands_from_cepstrum(f[..., :18]))
        period = 40 + 80 * torch.rand((B, 1), generator=g)
        sig = (0.3 * torch.sin(2 * np.pi * torch.arange(S)[None] / period)
               + 0.02 * torch.randn((B, S), generator=g)).float()
        d2 = report["kernels"]["lpc_recursion"] = {"modes": {}}
        runs = {}
        for mode in ("noise", "feedback"):
            inj = torch.randint(-2, 3, (B, S), generator=g) if mode == "noise" \
                else torch.randint(0, 256, (B, S), generator=g)
            args = (sig.to(dev), lpc.to(dev), inj.to(dev), mode == "feedback",
                    24)
            got = lpc_recursion(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = lpc_recursion_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            equal = {n: torch.equal(a, b)
                     for n, a, b in zip(got._fields, got, want)}
            err = max(float((got.pred - want.pred).abs().max()),
                      float((got.sig_rec - want.sig_rec).abs().max()))
            d2["modes"][mode] = dict(bit_equal=equal, plain_ms=plain_ms,
                                     max_abs_err=err)
            runs[mode] = lambda args=args: lpc_recursion(*args)
            print(f"D2 {mode} mode, B={B} x {S} samples: bit-equal {equal}, "
                  f"plain version {plain_ms:.0f} ms")
            if not all(equal.values()):
                raise AssertionError(f"D2 {mode} mode != plain: {equal}")
        dev_ms, records = profiled_ms(runs["noise"], 20, "lpc_recursion_kernel")
        ev_ms = cuda_ms(runs["noise"], 20)
        # The SM clock, sampled over ~1 s of back-to-back launches.
        clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        time.sleep(0.2)
        cuda_ms(runs["noise"], 3000, warmup=0)
        clocks.terminate()
        mhz = [int(v) for v in clocks.communicate()[0].split()
               if v.strip().isdigit()]
        clock = (pct(mhz, 50) or H100_BOOST_HZ / 1e6) * 1e6
        # Bytes: signal (4) and the injected index (8) in, pred, rec (4 each)
        # and two int64 indices out a sample; the taps (64 a frame), the
        # decode table.  Operations a sample: 16 products and 15 sums of the
        # taps, the subtraction, two clips, mu-law's 4 products, 1 sum, the
        # rounding and its clip, the jitter's sum and clip, the sum with the
        # decoded level and its clip: ~47.
        nbytes = B * S * (4 + 8 + 4 + 4 + 8 + 8) + B * T * 64 + 256 * 4
        flops = B * S * 47
        t_b, t_f = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
        # The chain from one reconstruction to the next: the tap tree (a
        # product and four sums), negation, subtraction, clip, |x| and the
        # product by 255 (~10 operations at ~4 clocks), libdevice's log1pf
        # (~40 clocks), mu-law's scaling, rounding and clips (~8 at ~4),
        # the jitter (~3 at ~4), the shared-memory table read (~30), the sum
        # and clip (~3 at ~4): ~190 clocks a sample.
        chain_ms = S * 190 / clock * 1e3
        d2.update(
            max_abs_err=max(m["max_abs_err"] for m in d2["modes"].values()),
            profiler_ms=dev_ms, profiler_records=records, events_ms=ev_ms,
            ms=dev_ms if dev_ms is not None else ev_ms,
            ms_from="profiler" if dev_ms is not None else "events",
            plain_ms=d2["modes"]["noise"]["plain_ms"],
            bound_ms=max(t_b, t_f) * 1e3,
            bound_by="bytes" if t_b > t_f else "operations", bytes=nbytes,
            flops=flops, chain_estimate_ms=chain_ms,
            ns_per_sample=(dev_ms or ev_ms) * 1e6 / S,
            sm_clock_mhz=dict(min=min(mhz, default=None), median=pct(mhz, 50),
                              max=max(mhz, default=None)))
        print(f"D2 per batch (B={B}, {S} samples a stream): profiler {dev_ms} "
              f"ms over {records} records, events {ev_ms:.4f} ms "
              f"({d2['ns_per_sample']:.1f} ns a sample); plain version "
              f"{d2['plain_ms']:.0f} ms; bound {d2['bound_ms']:.2e} ms "
              f"({d2['bound_by']}); chain estimate {chain_ms:.3f} ms at "
              f"{clock / 1e6:.0f} MHz; SM clock {d2['sm_clock_mhz']}")

        # -- one full-width teacher-forced step, card against CPU (B = 4):
        # same parameters, the card's recursion (D2) on the same noise for
        # both (the two devices' taps differ by rounding, which can move a
        # prediction across a mu-law level's edge); loss rtol 1e-5, every
        # gradient rtol 1e-4 + atol 1e-4 of its tensor's largest element
        params0 = tnet.LPCNetModel().init(torch.Generator().manual_seed(1),
                                          "cpu")
        noise = torch.randint(-2, 3, (4, S), generator=g)
        step = {}
        rec = None
        for d in (dev, torch.device("cpu")):
            tr = VocoderTrainer(tnet.LPCNetModel(), device=d)
            p = tr.init(params0)
            fd, sd = f[:4].to(d), sig[:4].to(d)
            if rec is None:
                full = tr._loss(p, fd, sd, noise.to(d))
                _, lpc_d, _ = tr._prepare_cond(p, fd)
                rec = tr._recursion(sd, lpc_d, noise=noise.to(d))
            cond, _, _ = tr._prepare_cond(p, fd)
            loss = tr._forward_ce(p, cond.repeat_interleave(160, 1),
                                  *(r.to(d) for r in rec))
            gs = torch.autograd.grad(loss, [p[k] for k in tr.trainable])
            step[d.type] = (float(loss), {k: v.cpu() for k, v in
                                          zip(tr.trainable, gs)})
        worst = max((float(((step["cuda"][1][k] - w_).abs()
                             - 1e-4 * w_.abs()).max())
                     / max(float(w_.abs().max()), 1e-30), k)
                    for k, w_ in step["cpu"][1].items())
        vt["card_vs_cpu_step"] = dict(
            loss_card=step["cuda"][0], loss_cpu=step["cpu"][0],
            loss_through_loss=float(full),
            worst_grad_excess_over_rtol_rel_to_max=worst)
        print(f"full-width teacher-forced step, card vs CPU (B=4): loss "
              f"{step['cuda'][0]:.7f} vs {step['cpu'][0]:.7f}; worst gradient "
              f"|d| - 1e-4|g| relative to its tensor's max: {worst}")
        if not (abs(step["cuda"][0] - step["cpu"][0])
                <= 1e-5 * abs(step["cpu"][0]) and worst[0] <= 1e-4
                and float(full) == step["cuda"][0]):
            raise AssertionError("the teacher-forced step on the card != CPU")

        with tempfile.TemporaryDirectory() as tmp:
            base = Path(tmp)
            speech_corpus(base / "train_corpus", 30, 778)
            speech_corpus(base / "speech", 4, 777)
            wav_dir, val_dir = base / "utt", base / "val"
            wav_dir.mkdir()
            val_dir.mkdir()
            for w_ in sorted((base / "train_corpus" / "train").glob("*.wav")):
                shutil.copy(w_, wav_dir)
            for w_ in sorted((base / "speech" / "val").glob("val_*.wav"))[:2]:
                shutil.copy(w_, val_dir)
            feats, sigs = voc_app.load_corpus(wav_dir, 15, dev)
            steps = len(feats) // 32
            vt["corpus"] = dict(chunks=len(feats), steps_per_epoch=steps)
            print(f"vocoder training corpus: {len(feats)} chunks of 15 "
                  f"frames, {steps} steps an epoch at B = 32")

            def run_app(key, argv, predicted_d2):
                zero_counts()
                t0 = time.perf_counter()
                hist = voc_app.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
                log_text = (Path(argv[1]) / "training.log").read_text()
                report["main_path"][key] = dict(
                    wall_s=wall, epoch_losses=hist, launches=launches,
                    d2_predicted=predicted_d2,
                    log=[l.split("]: ")[-1] for l in log_text.splitlines()])
                print(f"{key}: {len(hist)} epochs in {wall:.1f} s, losses "
                      f"{hist}; launches {launches} (D2 predicted "
                      f"{predicted_d2})")
                if not np.all(np.isfinite(hist)):
                    raise AssertionError(f"{key}: a non-finite loss {hist}")
                if launches["lpc_recursion"] != predicted_d2:
                    raise AssertionError(f"{key}: D2 launched "
                                         f"{launches['lpc_recursion']} times")
                return log_text

            # -- the app at bunch 1: teacher-forced (epoch 1), scheduled
            # sampling (2-3), free-running (4); pruning 0.6 -> 0.2; scoring
            # at epochs 2 (density 0.6: rejected) and 4 (saved)
            out1 = base / "b1"
            b1_flags = [str(wav_dir), str(out1), "--batch", "32",
                        "--chunk-frames", "15", "--sampled-noise-after", "1",
                        "--freerun-after", "3", "--grad-clip", "1.0",
                        "--rollout-detach", "160", "--density", "0.2",
                        "--lr-decay", "5e-5", "--val-wav", str(val_dir),
                        "--score-every", "2", "--val-max-wavs", "2",
                        "--device", "cuda"]
            log1 = run_app("train_vocoder_b1", b1_flags + ["--epochs", "4"],
                           steps * (1 + 2 + 2 + 1))
            k2 = report["main_path"]["train_vocoder_b1"]["launches"][
                "lpcnet_sampler_b1"]
            if k2 == 0 or "Epoch 002: new best" in log1 or \
                    "Epoch 004: new best" not in log1 or \
                    not (out1 / "vocoder_best.npz").exists():
                raise AssertionError(f"bunch 1: K2 {k2} launches; the best "
                                     f"gate:\n{log1}")

            # -- the card-trained checkpoint on the kernel's sparse path
            with np.load(out1 / "vocoder_best.npz") as z:
                ck = {k: z[k] for k in z.files}
            pattern, kept = tile_sparse_pattern(ck["gru_a_mask"])
            n_kept = sum(len(p_) for p_ in pattern)
            cparams = _load_params(ck, dev)
            cmodel = tnet.LPCNetModel.from_params(cparams)
            cw = prepare_sampler_weights(cparams)
            wh = cw["wh_a"].cpu().numpy()
            compacted = compact_gru_a_tiles(wh, wh != 0)[1].shape[0]
            carry, cond, lpc_c, temp = inputs(50, 3, model=cmodel,
                                              params=cparams)
            temp = -torch.ones_like(temp)
            kc, ks = sampler_frames(cw, carry, cond, lpc_c, temp, None)
            pc, ps = sampler_frames_plain(cw, carry, cond, lpc_c, temp, None)
            torch.cuda.synchronize()
            err = float((ks - ps).abs().max())
            zero_counts()
            pcm = LPCNet(backend="net", weights=str(out1 / "vocoder_best.npz"),
                         device=dev).synthesize_frames(
                             f[0, :10].numpy())
            loaded = read_counts()["lpcnet_sampler_b1"]
            vt["card_checkpoint"] = dict(
                tiles_kept=n_kept, kept_fraction=kept,
                tiles_compacted_for_kernel=compacted,
                mask_density=float(ck["gru_a_mask"].mean()),
                greedy_50_frames_max_abs_err=err,
                greedy_exc_equal=bool(torch.equal(kc[3], pc[3])),
                lpcnet_launches=loaded)
            print(f"card-trained checkpoint: {n_kept} of 216 GRU-A tiles kept "
                  f"({kept:.3f}), {compacted} compacted for the kernel; 50 "
                  f"frames greedy through K2 vs plain: max err {err:.3g}, "
                  f"excitations equal {torch.equal(kc[3], pc[3])}; LPCNet "
                  f"launched K2 {loaded} time(s)")
            if n_kept != 43 or compacted != 43 or not err <= 1e-5 or \
                    not torch.equal(kc[3], pc[3]) or loaded != 1 or \
                    len(pcm) != 1600:
                raise AssertionError("the card-trained checkpoint is not on "
                                     "the kernel's sparse path")

            # -- the app at bunch 8: one teacher-forced epoch, in which the
            # ramp reaches 0.2; one scoring (K3).  Its free-running step is
            # timed below (stage b8_freerun).
            out8 = base / "b8"
            b8_flags = [str(wav_dir), str(out8), "--bunch", "8", "--density",
                        "0.2", "--val-wav", str(val_dir), "--score-every",
                        "1", "--val-max-wavs", "2", "--device", "cuda"]
            log8 = run_app("train_vocoder_b8", b8_flags + ["--epochs", "1"],
                           steps)
            k3 = report["main_path"]["train_vocoder_b8"]["launches"][
                "lpcnet_sampler_bunched"]
            if k3 == 0 or "Epoch 001: new best" not in log8 or \
                    not (out8 / "vocoder_best.npz").exists():
                raise AssertionError(f"bunch 8: K3 {k3} launches:\n{log8}")

            # -- a falling loss: 30 teacher-forced steps on one batch; then
            # each stage's step time (events over back-to-back steps) and
            # device split (profiler; the free-running stages over a
            # 5-frame chunk: the same per-sample step, fewer of them)
            fb, sb = feats[:32], sigs[:32]
            tr1 = VocoderTrainer(tnet.LPCNetModel(), device=dev, seed=1,
                                 grad_clip=1.0, rollout_detach=160,
                                 lr_decay=5e-5)
            tr1.init()
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = [tr1.train_step(fb, sb) for _ in range(30)]
            end.record()
            end.synchronize()
            tf_d2 = read_counts()["lpc_recursion"] / 30
            losses = [float(v) for v in losses]
            tr8 = VocoderTrainer(tnet.LPCNetModel(bunch=8), device=dev, seed=1)
            tr8.init()
            short = (fb[:, :5], sb[:, :800])
            stages = {
                "b1_teacher_forced": (tr1.train_step, 1),
                "b1_sampled": (tr1.train_step_sampled, 2),
                "b1_freerun": (tr1.train_step_freerun, 1),
                "b8_teacher_forced": (tr8.train_step, 1),
                "b8_freerun": (tr8.train_step_freerun, 1)}
            st_rep = vt["stages"] = {}
            for name, (fn, d2_per_step) in stages.items():
                free = "freerun" in name
                if name == "b1_teacher_forced":
                    ms, n_d2 = start.elapsed_time(end) / 30, tf_d2
                else:
                    reps = 1 if free else 5
                    zero_counts()
                    torch.cuda.reset_peak_memory_stats()
                    ms = cuda_ms(lambda: fn(fb, sb), reps, warmup=0)
                    n_d2 = read_counts()["lpc_recursion"] / reps
                split = device_split(lambda: fn(*short) if free
                                     else fn(fb, sb), warm=not free)
                st_rep[name] = dict(ms=ms, d2_launches_a_step=n_d2,
                                    peak_gb=torch.cuda.max_memory_allocated()
                                    / 1e9, device_split=split,
                                    split_chunk_frames=5 if free else 15)
                print(f"stage {name}: {ms:.1f} ms a step (events), D2 "
                      f"{n_d2} a step, peak {st_rep[name]['peak_gb']:.2f} GB "
                      f"allocated; device split over a "
                      f"{5 if free else 15}-frame chunk: {split['kernels']} "
                      f"kernels, {split['device_ms']:.1f} ms busy in "
                      f"{split['wall_ms']:.1f} ms "
                      f"({100 * split['device_ms'] / split['wall_ms']:.0f}%)")
                if n_d2 != d2_per_step:
                    raise AssertionError(f"{name}: D2 {n_d2} a step")
            vt["falling_loss"] = losses
            print(f"30 teacher-forced steps on one batch: loss "
                  f"{np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}")
            if not (np.all(np.isfinite(losses))
                    and np.mean(losses[-5:]) < np.mean(losses[:5])):
                raise AssertionError(f"the CE did not fall: {losses}")

            # -- --resume of the bunch-8 run for one more (teacher-forced)
            # epoch; a resumed free-running epoch of the bunch-1 run cost
            # ~50 s of the script's time limit
            zero_counts()
            hist = voc_app.main(b8_flags + ["--epochs", "2", "--resume"])
            blob = torch.load(out8 / "train_state.pth", map_location="cpu")
            vt["resume"] = dict(epoch_losses=hist, epoch=blob["extra"]["epoch"],
                                launches=read_counts())
            print(f"--resume: {len(hist)} epoch, losses {hist}, epoch counter "
                  f"{blob['extra']['epoch']}")
            if len(hist) != 1 or blob["extra"]["epoch"] != 2 or \
                    not np.all(np.isfinite(hist)):
                raise AssertionError("--resume did not continue the run")

            # -- a fine-tune of the shipped checkpoint (mask inherited at
            # 0.199: pruning off), scored with the JAX package's gates
            out_ft = base / "ft"
            shipped = ROOT / "weights" / "vocoder_speech.npz"
            hist = voc_app.main([str(wav_dir), str(out_ft), "--epochs", "1",
                                 "--lr", "1e-5", "--init-weights",
                                 str(shipped), "--device", "cuda"])
            log_ft = (out_ft / "training.log").read_text()
            with np.load(shipped) as a, np.load(out_ft / "vocoder.npz") as b:
                same_mask = bool(np.array_equal(a["gru_a_mask"],
                                                b["gru_a_mask"]))
            val = base / "speech" / "val"
            _, audio = wavread(val / "val_00.wav")
            words = {w_.name.split("_")[1]: wavread(w_)[1]
                     for w_ in sorted(val.glob("kw_*_0.wav"))}
            zero_counts()
            sc = net_scores(LPCNet(backend="net",
                                   weights=str(out_ft / "vocoder.npz"),
                                   device=dev), audio, words, dev)
            vt["fine_tune"] = dict(epoch_losses=hist, mask_inherited=same_mask,
                                   scores=sc, launches=read_counts())
            print(f"fine-tune of vocoder_speech.npz (1 epoch, lr 1e-5): "
                  f"losses {hist}, mask inherited {same_mask}; scores {sc}")
            failed = [n for n, ok in net_gates("fine-tuned", sc) if not ok]
            if failed or not same_mask or len(words) != 6 or \
                    "pruning disabled, mask inherited" not in log_ft:
                raise AssertionError(f"fine-tune: gates failed {failed}, mask "
                                     f"inherited {same_mask}")
        vt["wall_s"] = time.perf_counter() - t_phase
        print(f"vocoder training phase: {vt['wall_s']:.1f} s wall")
    ph.run("vocoder training (D2, card vs CPU step, the app at bunch 1 and 8, "
           "the card-trained checkpoint on K2, resume, fine-tune scores)",
           vocoder_training)

    # ---- imported xiph checkpoints through the sampler kernel ---------------
    def interop():
        """A released-width checkpoint in the xiph Keras layout (built in
        memory from a seed) mapped by ``params_from_datasets`` and run
        greedy through K2 against the plain version; the b8 checkpoint
        exported and re-imported, bit for bit, through K3."""
        sys.path.insert(0, str(ROOT / "tests"))
        from torch_xiph import RELEASED, xiph_datasets

        from dss_tpu_torch.vocoder import LPCNet
        from dss_tpu_torch.vocoder.interop import datasets_from_params, \
            native_params_from_datasets, params_from_datasets
        io = report["interop"] = {"b1": {}, "b8": {}}
        ip, im = params_from_datasets(xiph_datasets(0))
        widths = dict(gru_a=im.gru_a_units, gru_b=im.gru_b_units,
                      cond=im.cond_dim, embed=im.embed_dim,
                      pitch=ip["emb_pitch"].shape[1])
        if widths != RELEASED or not ip["fc_out1_b"].any() or \
                not np.all(ip["gru_a_mask"] == 1.0):
            raise AssertionError(f"imported model {widths}")
        tp_ = _load_params(ip, dev)
        iw = tnet.sampler_weights_for(im, tp_)
        plan = kernel_plan(iw, 1, im.cond_dim, 16)
        io["b1"].update(widths=widths, plan=plan)
        print(f"imported checkpoint {widths}, dense GRU-A (216 tiles), inner "
              f"biases, pitch net; kernel plan {plan}")
        if plan["gru_a_tiles_resident"]:
            raise AssertionError("a dense GRU-A 384 cannot stay resident")
        # Both runs are held against the plain version in float32 (on the
        # host: the same inputs, copied) to 1e-6 a sample.  Over a long
        # greedy call the two may part where a sample or a prediction falls
        # within their last-bit difference of a mu-law level's edge and
        # encodes to the neighbouring level; such a parting is accepted only
        # where the two runs' encodings visibly straddle an edge at or
        # before it.
        tol = 1e-6
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for frames in (50, 300):
                # The pitch net conditions on the whole call: one block.
                carry, cond, lpc, temp = inputs(frames, frames, im, tp_)
                temp = -torch.ones_like(temp)
                kc, ks = sampler_frames(iw, carry, cond, lpc, temp, None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pc, ps = sampler_frames_plain(
                    {k: v.cpu() for k, v in iw.items() if torch.is_tensor(v)},
                    tuple(x.cpu() for x in carry), cond.cpu(), lpc.cpu(),
                    temp.cpu(), None)
                plain_ms = (time.perf_counter() - t0) * 1e3
                part = parting(ks[0].double().cpu().numpy(),
                               ps[0].double().numpy(),
                               carry[2][0].double().cpu().numpy(),
                               lpc[:, 0].double().cpu().numpy(), tol)
                same_exc = torch.equal(kc[3].cpu(), pc[3])
                ms = cuda_ms(lambda: sampler_frames(iw, carry, cond, lpc,
                                                    temp, None), 3, warmup=1)
                bound, bound_by, _, rows = sampler_bound(
                    im, tp_, iw, 1, carry, cond, lpc, temp,
                    torch.empty(0, device=dev), ks)
                io["b1"][f"T{frames}"] = dict(
                    tolerance=tol, max_abs_err=part["max_before"],
                    parted_at=part["first"], straddle_at=part["straddle"],
                    final_exc_equal=same_exc, ms=ms, plain_ms=plain_ms,
                    plain_device="cpu", bound_ms=bound, bound_by=bound_by,
                    bound_terms=rows,
                    us_per_sample=ms * 1e3 / (frames * 160),
                    rms=float(ks.pow(2).mean().sqrt()))
                print(f"imported, greedy {frames} frames through K2: max err "
                      f"{part['max_before']:.3g} against the float32 plain "
                      f"version (host, {plain_ms:.0f} ms)"
                      + (f" up to sample {part['first']}, where the runs "
                         f"part after straddling a mu-law edge at step "
                         f"{part['straddle']}" if part["first"] is not None
                         else ", every sample; final excitation equal "
                              f"{same_exc}")
                      + f"; {ms:.1f} ms a call ({ms * 1e3 / (frames * 160):.2f}"
                      f" us a sample); bound {bound:.4f} ms ({bound_by})")
                if not part["max_before"] <= tol or \
                        not bool(ks.abs().max() > 0) or \
                        (part["first"] is None and not same_exc) or \
                        (part["first"] is not None
                         and part["straddle"] is None):
                    raise AssertionError(f"imported K2 greedy {frames} "
                                         f"frames: {part}")
        finally:
            torch.set_num_threads(threads)
        feats = np.random.default_rng(11).normal(size=(300, 20)).astype(
            np.float32) * 0.3
        feats[:, 0] -= 4.0
        voc = LPCNet(backend="net", model=im, weights=ip, device=dev)
        zero_counts()
        pcm = voc.synthesize_frames(feats)
        io["b1"]["launches"] = read_counts()
        if pcm.dtype != np.int16 or pcm.shape != (300 * 160,) or \
                not pcm.any() or io["b1"]["launches"]["lpcnet_sampler_b1"] \
                != 1:
            raise AssertionError(f"LPCNet on the imported checkpoint: "
                                 f"{pcm.dtype} {pcm.shape}, launches "
                                 f"{io['b1']['launches']}")
        # The b8 checkpoint: export to the Keras layout and back.
        with np.load(ROOT / "weights" / "vocoder_speech_b8.npz") as z:
            direct = {k: z[k] for k in z.files}
        back, bm = native_params_from_datasets(datasets_from_params(direct))
        exact = set(back) == set(direct) and all(
            back[k].dtype == direct[k].dtype
            and np.array_equal(back[k], direct[k]) for k in direct)
        m8, p8, w8 = bunched[8]
        wb = tnet.sampler_weights_for(bm, _load_params(back, dev))
        carry, cond, lpc, temp = inputs(50, 8, m8, p8)
        temp = -torch.ones_like(temp)
        dc, ds = sampler_frames_bunched(w8, carry, cond, lpc, temp, None)
        bc, bs = sampler_frames_bunched(wb, carry, cond, lpc, temp, None)
        torch.cuda.synchronize()
        same = torch.equal(bs, ds) and torch.equal(bc[3], dc[3])
        zero_counts()
        pcm8 = LPCNet(backend="net", weights=back, device=dev)\
            .synthesize_frames(feats[:50])
        io["b8"].update(params_bit_equal=exact, greedy_50_equal=same,
                        keys=len(back), launches=read_counts())
        print(f"b8 export -> re-import: {len(back)} arrays bit for bit "
              f"{exact}; greedy 50 frames through K3 equal to the direct "
              f"load {same}; LPCNet launches {io['b8']['launches']}")
        if not exact or not same or pcm8.shape != (50 * 160,) or \
                io["b8"]["launches"]["lpcnet_sampler_bunched"] != 1:
            raise AssertionError("b8 re-import")
    ph.run("interop (imported xiph checkpoint greedy through K2, 50 and "
           "300 frames; b8 export -> re-import through K3)", interop)

    # ---- the contamination permutation test -----------------------------
    def contamination():
        """A synthetic 10-minute day at 1 kHz and 128 channels (as
        tests/test_eval.py builds its days): 10,000 surrogates on the card,
        the first 16 against the numpy plain version."""
        from dss_tpu_torch.eval import contamination as tc
        T = 600 * 1000
        rng = np.random.default_rng(13)
        env = (np.sin(2 * np.pi * np.arange(T) / 4000) > 0).astype(float)
        audio = rng.normal(size=T) * (0.1 + env)
        ecog = rng.normal(size=(T, 128))
        t0 = time.perf_counter()
        a, b = tc.day_spectrograms(ecog, audio, 1000)
        spec_s = time.perf_counter() - t0
        L = int(tc.MAX_TIME_LAG * tc.SPG_FS)
        t0 = time.perf_counter()
        measure, _ = tc.lagged_correlation_measure(a, b, L)
        measure_s = time.perf_counter() - t0
        tc.surrogate_measures(a, b, L, 16, device=dev)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sur = tc.surrogate_measures(a, b, L, tc.NB_SURROGATES, device=dev)
        card_s = time.perf_counter() - t0
        # The plain version takes seconds a surrogate on one host core:
        # the 16 run on a pool of processes, one core each.
        shifts = tc.surrogate_shifts(len(a), L, 16)
        workers = min(8, os.cpu_count() or 1)
        with tempfile.TemporaryDirectory() as tmp:
            np.save(Path(tmp) / "a.npy", a)
            np.save(Path(tmp) / "b.npy", b)
            t0 = time.perf_counter()
            with ProcessPoolExecutor(
                    workers,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                done = list(pool.map(
                    rolled_measures, [Path(tmp) / "a.npy"] * workers,
                    [Path(tmp) / "b.npy"] * workers, [L] * workers,
                    np.array_split(shifts, workers)))
            plain_wall_s = time.perf_counter() - t0
        plain = np.array([m for part in done for m, _ in part])
        plain_s = float(np.mean([t for part in done for _, t in part]))
        rel = float(np.max(np.abs(sur[:16] - plain) / np.abs(plain)))
        n, F, C = len(a), a.shape[1], b.shape[1]
        flops = tc.NB_SURROGATES * sum(
            n - abs(lag) for lag in range(-L, L + 1)) * C * F * 2
        nbytes = (a.size + b.size + tc.NB_SURROGATES) * 4
        t_f, t_b = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
        criterion = float((sur >= measure).mean())
        report["contamination"] = dict(
            frames=n, channels=C, freqs=F, surrogates=len(sur),
            brain_spec_gb=b.size * 4 / 1e9, spectrogram_s=spec_s,
            dataset_measure_s=measure_s, surrogates_s=card_s,
            plain_s_per_surrogate=plain_s, plain_wall_s_16=plain_wall_s,
            plain_workers=workers, max_rel_err_first_16=rel,
            bound_s=max(t_f, t_b), bound_by="operations" if t_f > t_b
            else "bytes", flops=flops, dataset_measure=measure,
            criterion_p=criterion)
        print(f"contamination, 10 min x 128 channels ({n} frames x {F} "
              f"freqs, brain spectrogram {b.size * 4 / 1e9:.2f} GB f32 on "
              f"the card): {len(sur)} surrogates in {card_s:.2f} s on the "
              f"card, bound {max(t_f, t_b):.2f} s ({flops:.3g} flop); the "
              f"first 16 within rtol {rel:.2g} of the numpy plain version "
              f"({plain_s:.1f} s a surrogate on a host core, {plain_wall_s:.1f}"
              f" s for the 16 on {workers} processes); spectrograms "
              f"{spec_s:.1f} s, dataset measure {measure:.5f} "
              f"({measure_s:.1f} s), criterion P {criterion:.4f}")
        if sur.shape != (tc.NB_SURROGATES,) or not rel <= 1e-4 or \
                not np.all(np.isfinite(sur)):
            raise AssertionError("contamination surrogates")
    ph.run("contamination (10,000 surrogates of a 10-minute, 128-channel "
           "day on the card; the first 16 vs numpy)", contamination)

    # ---- a whole word-path session under the profiler ------------------------
    def session_trace():
        """The bunch-1 word path's session once more, over a real socket:
        the port's amplifier publishes it and the graph's ``ZMQConnector``
        ingests it, recorded by ``device_trace``.  Every packet must arrive,
        and the words must equal the in-process replay's (the bunch-1 main
        path) bit for bit.  From the trace: the device's busy share, the top
        kernels, and the kernels launched per packet call and per word by
        the two units' executor threads."""
        if "b1" not in outputs:
            raise AssertionError("the bunch-1 main path did not run")
        with tempfile.TemporaryDirectory() as tmp:
            main_path("session_trace", "vocoder_speech.npz",
                      ("filter_log_power", "lpcnet_sampler_b1"),
                      trace_dir=tmp, zmq=True, splits=False)
            (path,) = trace_files(tmp)
            size = Path(path).stat().st_size
            s = trace_summary(path, top=8)
        mp = report["main_path"]["session_trace"]
        (words, lpc), (ref_words, ref_lpc) = outputs["session_trace"], \
            outputs["b1"]
        sent = len(session()) // 40
        same = len(words) == len(ref_words) and all(
            np.array_equal(a, b) for a, b in zip(words, ref_words)) and all(
            np.array_equal(a, b) for a, b in zip(lpc, ref_lpc))
        mp.update(packets_sent=sent, equal_to_replay=same)

        # The units warm up in initialize, on this (the main) thread; their
        # live calls run on their one-worker executors.
        main_tid = threading.get_native_id()

        def executor_of(key):
            return [t for tid, t in s["threads"].items() if tid != main_tid
                    and any(key in n for n in t["kernel_names"])]
        fe, word_threads = executor_of("filter_log_power"), \
            executor_of("lpcnet_sampler")
        mp["trace"] = dict(
            bytes=size, kernels=s["kernels"], span_s=s["span_us"] / 1e6,
            busy_share=s["busy_share"], kernel_s=s["kernel_us"] / 1e6,
            top=[(n[:60], c, us / 1e3) for n, (c, us) in s["by_name"].items()],
            threads_with_ops=sum(t["cpu_ops"] > 0
                                 for t in s["threads"].values()),
            warm_up_kernels=s["threads"].get(main_tid, {}).get("kernels", 0),
            kernels_per_packet_call=(fe[0]["kernels"] / mp["packet_calls"]
                                     if len(fe) == 1 else None),
            kernels_per_word=(word_threads[0]["kernels"] / mp["words"]
                              if len(word_threads) == 1 else None))
        t = mp["trace"]
        print(f"session over ZMQ: {mp['packets_ingested']} of {sent} packets "
              f"ingested, words equal to the in-process replay's {same}; "
              f"trace ({size / 1e6:.0f} MB): {s['kernels']} kernels "
              f"over {t['span_s']:.1f} s, device busy {t['busy_share']:.2%} "
              f"({t['kernel_s']:.2f} s of kernels); {t['threads_with_ops']} "
              f"threads with CPU ops; kernels per packet call "
              f"{t['kernels_per_packet_call']}, per word "
              f"{t['kernels_per_word']}, {t['warm_up_kernels']} in the "
              f"units' warm-ups; top by device time (name, count, ms): "
              f"{t['top']}")
        if s["kernels"] == 0 or len(fe) != 1 or len(word_threads) != 1:
            raise AssertionError(f"the trace holds {s['kernels']} kernels, "
                                 f"the front-end kernel on {len(fe)} "
                                 f"executor thread(s), the sampler on "
                                 f"{len(word_threads)}")
        # Packets, not device calls: under a backlog the front end runs
        # queued packets as one call (its coalescing), so a session of 400
        # packets may take 399 calls.
        if mp["packets_ingested"] != sent or not same:
            raise AssertionError(f"over ZMQ: {mp['packets_ingested']} of "
                                 f"{sent} "
                                 f"packets, words equal to the replay's "
                                 f"{same}")
    ph.run("session trace (the bunch-1 word path over ZMQ, the port's "
           "amplifier publishing, under device_trace)",
           session_trace)

    # ---- scale-out: many streams a card ----------------------------------------
    def scale_out():
        """The scale-out slice at world 1 on the card: (a) the mesh over a
        world-1 NCCL group; (b) ShardedFusedDecoderVocoder at 8 streams in
        the word-path graph on the session (the live slot plus 7 segments
        cut from the session's words), then the three words again through
        a chunked and a single-shot unit, every slot bit for bit, timed and
        traced; (c) K2 on one 50-frame block at B = 1, 8, 16 and the
        card's cluster limit and one past it, K2 at the largest B and K3 b8
        at B = 8 greedy against the plain version; (d) serve_multichip at 8
        and 16 streams; (e) the data-parallel training steps against the
        plain single-card steps."""
        import torch.distributed as dist

        from dss_tpu_torch import runtime as ez
        from dss_tpu_torch.apps import serve_multichip
        from dss_tpu_torch.apps.decode_online import feature_transforms
        from dss_tpu_torch.models.decoder import \
            BidirectionalSpeechSynthesisModel
        from dss_tpu_torch.models.lstm import seeded_init
        from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
        from dss_tpu_torch.ops.hga import HighGammaExtractor
        from dss_tpu_torch.parallel import make_mesh, \
            sharded_decoder_train_step, sharded_vad_train_step, \
            sharded_vocoder_train_step
        from dss_tpu_torch.parallel.mesh import axis
        from dss_tpu_torch.parallel.shard import decoder_trainer, \
            vad_trainer
        from dss_tpu_torch.runtime.units import FusedFrontendVad, \
            FusedFrontendVadSettings, PacketReplay, PacketReplaySettings, \
            ShardedFusedDecoderVocoder, ShardedFusedDecoderVocoderSettings
        from dss_tpu_torch.train.trainer_decoder import DecoderTrainer
        from dss_tpu_torch.train.trainer_vad import VadTrainer
        from dss_tpu_torch.train.trainer_vocoder import VocoderTrainer

        so = report["scale_out"] = {}
        t_phase = time.perf_counter()
        try:
            # (a) the mesh: a world-1 NCCL group started by make_mesh.
            mesh = make_mesh(1)
            size, _, group = axis(mesh, "data")
            one = torch.ones(4, device=dev)
            dist.all_reduce(one, group=group)
            torch.cuda.synchronize()
            so["mesh"] = dict(shape=list(mesh.shape),
                              backend=dist.get_backend(),
                              all_reduce_ok=bool((one == 1).all()))
            print(f"scale-out mesh: {so['mesh']}")
            if mesh.shape != (1, 1) or so["mesh"]["backend"] != "nccl" \
                    or not so["mesh"]["all_reduce_ok"]:
                raise AssertionError(f"mesh {so['mesh']}")

            # (b) the sharded unit.  Background slots: 7 segments of other
            # lengths cut from the session's three bursts (features at
            # 100 Hz; the bursts span frames 200-350, 700-850, 1200-1350).
            pre, post, nb = feature_transforms(None)
            ex = HighGammaExtractor(fs=1000, nb_electrodes=nb,
                                    pre_transforms=pre, post_transforms=post,
                                    device=dev)
            feats = ex.extract_features(session())
            cuts = [(180, 120), (690, 170), (1190, 150), (195, 200),
                    (705, 140), (1210, 230), (185, 160)]
            background = [np.ascontiguousarray(feats[a:a + n])
                          for a, n in cuts]

            def unit(weights, chunked):
                u = ShardedFusedDecoderVocoder()
                u.apply_settings(ShardedFusedDecoderVocoderSettings(
                    path_to_model_weights=None,
                    model=BidirectionalSpeechSynthesisModel,
                    params=dict(nb_layer=2, nb_hidden_units=100,
                                nb_electrodes=nb),
                    vocoder_weights=str(ROOT / "weights" / weights),
                    streams=8, slot_feeder=lambda n, t: background,
                    chunk_emission=chunked))
                return u

            class Sink(ez.Unit):
                SEGMENT = ez.InputStream(ez.TimeSeriesMessage)
                WORD = ez.InputStream(ez.TimeSeriesMessage)

                def initialize(self):
                    self.segments, self.words = [], []

                @ez.subscriber(SEGMENT)
                async def on_segment(self, msg):
                    self.segments.append(np.asarray(msg.data, np.float32))

                @ez.subscriber(WORD)
                async def on_word(self, msg):
                    self.words.append(np.asarray(msg.data))

            with tempfile.TemporaryDirectory() as tmp:
                vad_path = Path(tmp) / "vad_threshold.npz"
                np.savez(vad_path, **threshold_vad())
                for key, weights, kernel in (
                        ("scaleout_b1", "vocoder_speech.npz",
                         "lpcnet_sampler_b1"),
                        ("scaleout_b8", "vocoder_speech_b8.npz",
                         "lpcnet_sampler_bunched")):
                    class System(ez.System):
                        SOURCE = PacketReplay()
                        FRONTEND = FusedFrontendVad()
                        WORDS = ShardedFusedDecoderVocoder()
                        SINK = Sink()

                        def configure(self):
                            self.SOURCE.apply_settings(PacketReplaySettings(
                                data=session(), fs=1000))
                            self.FRONTEND.apply_settings(
                                FusedFrontendVadSettings(
                                    nb_features=nb, fs=1000,
                                    buffer_size=2000, context_frames=50,
                                    pre_transforms=pre,
                                    post_transforms=post,
                                    vad_architecture=(
                                        UnidirectionalVoiceActivityDetector),
                                    vad_weights_path=vad_path,
                                    vad_parameters=dict(
                                        nb_layer=2, nb_hidden_units=150,
                                        nb_electrodes=nb)))
                            self.WORDS.apply_settings(
                                unit(weights, True).SETTINGS)

                        def network(self):
                            return ((self.SOURCE.OUTPUT, self.FRONTEND.INPUT),
                                    (self.FRONTEND.OUTPUT, self.WORDS.INPUT),
                                    (self.FRONTEND.OUTPUT, self.SINK.SEGMENT),
                                    (self.WORDS.WORD, self.SINK.WORD))

                    system = System()
                    zero_counts()
                    t0 = time.perf_counter()
                    ez.run_system(system)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = read_counts()
                    sink = system.SINK
                    rec = so[key] = dict(
                        vocoder_weights=weights, launches=launches,
                        graph_wall_s=wall, words=len(sink.words),
                        live_frames=[len(x) for x in sink.segments],
                        graph_word_head_ms=system.WORDS.word_ms)
                    print(f"scale-out graph ({weights}, 8 streams): "
                          f"{len(sink.words)} words of "
                          f"{rec['live_frames']} frames in {wall:.1f} s, "
                          f"launches {launches}")
                    if len(sink.words) != 3 or launches[kernel] <= 0 or \
                            launches["filter_log_power"] <= 0:
                        raise AssertionError(f"{key}: {rec}")
                    once_a_block(launches, key)
                    if any(len(w) != len(x) * 160 for w, x in
                           zip(sink.words, sink.segments)):
                        raise AssertionError(f"{key}: word lengths")

                    # The three words again, chunked and single-shot on
                    # fresh units: every slot bit for bit; the chunked
                    # words timed and traced.
                    chunked, single = unit(weights, True), \
                        unit(weights, False)
                    chunked.initialize()
                    single.initialize()
                    per_word = []
                    for seg in sink.segments:
                        before = read_counts()[kernel]
                        with tempfile.TemporaryDirectory() as tdir:
                            with device_trace(tdir):
                                t0 = time.perf_counter()
                                lpc_c, a0, n_chunks, word = \
                                    chunked._head(seg)
                                head_ms = (time.perf_counter() - t0) * 1e3
                                parts, tail_ms = [a0], []
                                for k in range(1, n_chunks):
                                    t0 = time.perf_counter()
                                    parts.append(chunked._tail(word, k))
                                    tail_ms.append(
                                        (time.perf_counter() - t0) * 1e3)
                            (path,) = trace_files(tdir)
                            traced = trace_summary(path, top=10 ** 6)
                        launched = read_counts()[kernel] - before
                        sampler = [v for n, v in traced["by_name"].items()
                                   if "lpcnet_sampler" in n]
                        Ts = word[0]
                        lpc_s, a0_s, _, _ = single._head(seg)
                        bg = chunked.slot_audio
                        same = np.array_equal(lpc_c, lpc_s) and \
                            np.array_equal(np.concatenate(parts), a0_s) \
                            and all(np.array_equal(bg[i],
                                                   single.slot_audio[i])
                                    for i in range(1, 8))
                        sized = len(a0_s) == Ts[0] * 160 and all(
                            len(bg[i]) == Ts[i] * 160 for i in range(1, 8))
                        per_word.append(dict(
                            slot_frames=Ts, head_ms=head_ms,
                            tail_chunk_ms=tail_ms,
                            sampler_launches=launched,
                            sampler_trace_kernels=sum(c for c, _ in sampler),
                            sampler_device_ms=sum(us for _, us in sampler)
                            / 1e3, busy_share=traced["busy_share"],
                            chunked_equals_single=same,
                            slot_lengths_ok=sized))
                        print(f"  word of {Ts[0]} frames, slots {Ts}: head "
                              f"{head_ms:.1f} ms (decode + 8 first chunks "
                              f"+ one read), tail chunks "
                              f"{[round(t, 1) for t in tail_ms]} ms; "
                              f"sampler {per_word[-1]['sampler_launches']} "
                              f"launches, "
                              f"{per_word[-1]['sampler_device_ms']:.1f} ms "
                              f"device time (device_trace; the card busy "
                              f"{traced['busy_share']:.1%} of the word); "
                              f"chunked == single-shot for "
                              f"all 8 slots: {same}; T_i x 160: {sized}")
                        if not same or not sized:
                            raise AssertionError(f"{key}: word {Ts}")
                    rec["words_detail"] = per_word
                    for u in (chunked, single):
                        u.shutdown()

            # (c) streams a card: K2 at B = 1, 8, 16, the cluster limit
            # and one past it; the sampler runs a cluster of 8 blocks a
            # stream, so past the limit a block runs as two waves.
            plan = kernel_plan(w, 1, 128, 16)
            edge = plan["max_active_clusters"]
            sweep = {}
            for B in sorted({1, 8, 16, edge, edge + 1}):
                carry, cond, lpc, temp = inputs(50, 7, batch=B)
                noise = tnet.gumbel_noise(0, 0, 50, B, dev)
                ms = cuda_ms(lambda: sampler_frames(w, carry, cond, lpc,
                                                    temp, noise), 3,
                             warmup=1)
                _, sig = sampler_frames(w, carry, cond, lpc, temp, noise)
                bound, bound_by, _, _ = sampler_bound(
                    model, params, w, 1, carry, cond, lpc, temp, noise, sig)
                sweep[B] = dict(ms=ms, realtime_streams=B * 500.0 / ms,
                                bound_ms=bound, bound_by=bound_by)
                print(f"  K2 at B = {B}: {ms:.2f} ms a 50-frame block, "
                      f"{B * 500.0 / ms:.1f} real-time streams; bound "
                      f"{bound:.4f} ms ({bound_by})")
            so["k2_sweep"] = dict(max_active_clusters=edge, plan=plan,
                                  by_batch=sweep)

            def greedy(name, run, plain, wS, model_, params_, S, B):
                carry, cond, lpc, temp = inputs(2, 9, model_, params_, B)
                temp = -torch.ones_like(temp)
                kc, ks = run(wS, carry, cond, lpc, temp, None)
                pc, ps = plain(wS, carry, cond, lpc, temp, None)
                torch.cuda.synchronize()
                worst, ok = 0.0, True
                for b in range(B):
                    part = parting(ks[b].double().cpu().numpy(),
                                   ps[b].double().cpu().numpy(),
                                   carry[2][b].double().cpu().numpy(),
                                   lpc[:, b].double().cpu().numpy(), 1e-5)
                    worst = max(worst, part["max_before"])
                    ok &= part["max_before"] <= 1e-5 and (
                        part["straddle"] is not None
                        if part["first"] is not None
                        else bool(torch.equal(kc[3][b], pc[3][b])))
                so[f"{name}_greedy"] = dict(batch=B, max_abs_err=worst,
                                            ok=ok)
                print(f"  {name} greedy at B = {B}, 2 frames: max err "
                      f"{worst:.3g} before any parting; held: {ok}")
                if not ok:
                    raise AssertionError(f"{name} greedy at B = {B}")
            greedy("k2", sampler_frames, sampler_frames_plain, w, model,
                   params, 1, edge + 1)
            m8, p8, w8 = bunched[8]
            greedy("k3_b8", sampler_frames_bunched,
                   sampler_frames_bunched_plain, w8, m8, p8, 8, 8)

            # (d) the serving app at world 1, also at the cluster limit.
            for spd in sorted({8, 16, edge}):
                zero_counts()
                line = serve_multichip.main([
                    "--streams-per-device", str(spd), "--frames", "50",
                    "--steps", "3", "--weights",
                    str(ROOT / "weights" / "vocoder_speech.npz")])
                launches = read_counts()
                so[f"serve_multichip_{spd}"] = dict(line=line,
                                                    launches=launches)
                print(f"  serve_multichip --streams-per-device {spd}: "
                      f"{json.dumps(line)}; launches {launches}")
                if line["pcm_shape"] != [spd, 8000] or \
                        launches["lpcnet_sampler_b1"] <= 0:
                    raise AssertionError(f"serve_multichip {spd}: {line}")
                once_a_block(launches, f"serve_multichip {spd}")

            # (e) the data-parallel steps at world 1 against the plain
            # single-card steps on the same data.
            rng = np.random.default_rng(21)
            lengths = np.array([300, 212, 257, 181])
            x = rng.normal(size=(4, 300, nb)).astype(np.float32)
            y = rng.normal(size=(4, 300, 20)).astype(np.float32)
            mask = (np.arange(300)[None] < lengths[:, None]).astype(
                np.float32)
            labels = (rng.random((4, 300)) > 0.5).astype(np.float32)
            dp = {}

            def timed(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = float(fn())
                return out, (time.perf_counter() - t0) * 1e3

            model_d = BidirectionalSpeechSynthesisModel(2, 100, nb)
            seeded_init(model_d, 0)
            plain_d, ms_p = timed(lambda: DecoderTrainer(
                model_d, device=dev).train_step(x, y, mask))
            sharded_d, ms_s = timed(lambda: sharded_decoder_train_step(
                mesh, x, y, mask, 100, trainer=decoder_trainer(mesh, nb)))
            dp["decoder"] = dict(loss=sharded_d, plain_loss=plain_d,
                                 ms=ms_s, plain_ms=ms_p)
            model_v = UnidirectionalVoiceActivityDetector(2, 150, nb)
            seeded_init(model_v, 0)
            plain_v, ms_p = timed(lambda: VadTrainer(
                model_v, device=dev).tbptt_trial(x, labels, mask))
            sharded_v, ms_s = timed(lambda: sharded_vad_train_step(
                mesh, x, labels, mask, 150, trainer=vad_trainer(mesh, nb)))
            dp["vad"] = dict(loss=sharded_v, plain_loss=plain_v, ms=ms_s,
                             plain_ms=ms_p)
            vf = (rng.normal(size=(8, 15, 20)) * 0.3).astype(np.float32)
            vs = (rng.normal(size=(8, 2400)) * 0.05).astype(np.float32)
            vts = []
            for _ in range(2):
                vt = VocoderTrainer(tnet.LPCNetModel(), device=dev, seed=3)
                vt.init()
                vts.append(vt)
            plain_c, ms_p = timed(lambda: vts[0].train_step(vf, vs))
            sharded_c, ms_s = timed(lambda: sharded_vocoder_train_step(
                mesh, vts[1], vf, vs))
            dp["vocoder"] = dict(loss=sharded_c, plain_loss=plain_c,
                                 ms=ms_s, plain_ms=ms_p)
            so["dp_training"] = dp
            print(f"  data-parallel steps at world 1 (loss, plain loss, ms, "
                  f"plain ms): {dp}")
            for k, v in dp.items():
                if not np.isfinite(v["loss"]) or \
                        abs(v["loss"] - v["plain_loss"]) > \
                        1e-6 * abs(v["plain_loss"]):
                    raise AssertionError(f"DP {k} step: {v}")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            so["phase_s"] = time.perf_counter() - t_phase
            print(f"scale-out phase: {so['phase_s']:.1f} s")
    ph.run("scale-out (mesh, the sharded word unit at 8 streams, K2's "
           "streams a card, serve_multichip, data-parallel steps)",
           scale_out)

    # ---- replicate.sh's eight stages on the port, scored ---------------------
    def replicate():
        report["replicate"] = replicate_phase(zero_counts, read_counts)
    ph.run("replicate (the eight stages of replicate.sh on a keyword-speech "
           "dataset at the reference's epochs; closed-loop and keyword "
           "scoring)", replicate)

    # ---- the last JAX tools' ports ------------------------------------------
    def tools():
        report["tools"] = tools_phase(zero_counts, read_counts)
    ph.run("tools (exteval, import fixture + A/B, sampler microbench, "
           "bucket sweep, graft entry and its dry run)", tools)

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

    print(json.dumps({"kernels": kernel_summary(report)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_summary(report):
    """The kernels' line: each kernel's source, the TPU code it replaces,
    its launches on the main path that runs it and on every counted run,
    its error against its plain version, its time, bound and plain and
    library times, from a complete report of ``main``."""
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
        # No TPU kernel: the JAX package runs these loops as lax.scan.
        "dsp_synthesis": ("cuda", "dss_tpu_torch/csrc/dsp_synthesis.cu",
                          "dss_tpu/vocoder/dsp.py:67"),
        "lpc_recursion": ("cuda", "dss_tpu_torch/csrc/lpc_recursion.cu",
                          "dss_tpu/train/trainer_vocoder.py:142"),
        "bilstm_decoder": ("cuda", "dss_tpu_torch/csrc/bilstm_decoder.cu",
                           "dss_tpu/models/decoder.py:51"),
        # No TPU kernel: the JAX package leaves these to XLA.
        "cepstrum_lpc": ("cuda", "dss_tpu_torch/csrc/cepstrum_lpc.cu",
                         "dss_tpu/vocoder/net.py:410"),
        "deemphasis": ("cuda", "dss_tpu_torch/csrc/deemphasis.cu",
                       "dss_tpu/vocoder/net.py:527"),
    }
    # Each kernel's launches on the main path that runs it: the front-end
    # kernel and the sampler at bunch 1 (K2) on the bunch-1 word path, the
    # sampler at bunch 8 (K3) on the bunch-8 word path.  The standalone
    # log-power kernel is on neither path since the front-end kernel took
    # its place; its count is read on the bunch-8 path (0).  D1 and D3 on
    # the shipped configuration as the INI resolves on the card.  D2 on the
    # vocoder training app's bunch-1 run.
    path_of = {"log_power": "b8", "filter_log_power": "b1",
               "lpcnet_sampler_b1": "b1", "lpcnet_sampler_bunched": "b8",
               "dsp_synthesis": "ship_resolved",
               "lpc_recursion": "train_vocoder_b1",
               "bilstm_decoder": "ship_resolved",
               "cepstrum_lpc": "b1", "deemphasis": "b1"}
    # Every run whose counts were zeroed before it and read after it: the
    # word paths and the shipped configuration, and on the training path
    # corpus preparation (the front-end kernel once a trial), the decoder
    # app (D1 once a synthesis job) and the scoring (K2, K3, D1); the vocoder
    # training app's runs at bunch 1 and 8 (D2 each step, K2 / K3 in their
    # validation scoring); the replication's eight stages (the front-end
    # kernel in corpus preparation, the statistics and the live loop, D1 in
    # the decoder app's queue, K2 in the live loop).
    tp = report["training_path"]
    runs = {p: mp["launches"] for p, mp in report["main_path"].items()}
    runs.update({"training_corpus": tp["corpus"]["launches"],
                 "training_decoder_app": tp["apps"]["decoder_launches"]})
    runs.update({f"scoring_{k}": v["launches"]
                 for k, v in tp["scores"].items()})
    runs.update({f"interop_{k}": v["launches"]
                 for k, v in report["interop"].items()})
    so = report["scale_out"]
    runs.update({k: v["launches"] for k, v in so.items()
                 if k.startswith(("scaleout_", "serve_multichip_"))})
    runs["replicate"] = report["replicate"]["launches"]
    runs["tools"] = report["tools"]["launches"]
    runs["replicate_retrained"] = report["replicate"]["retrained"]["launches"]
    kernels = []
    for name, (route, src, replaces) in meta.items():
        k = report["kernels"][name]
        kernels.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces,
            "launches": report["main_path"][path_of[name]]["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
            "launches_by_path": {p: c[name] for p, c in runs.items()}})
        if "plan" in k:  # the sampler: blocks per stream, weights on chip
            kernels[-1].update(
                cluster=k["plan"]["cluster"],
                resident_bytes_per_block=k["plan"]["resident_bytes"])
        if name == "bilstm_decoder":  # one row at T = 137 and 250
            kernels[-1].update(
                ms_by_frames={t: v["profiler_ms"] or v["events_ms"]
                              for t, v in k["shapes"].items()},
                library_ms_by_frames={t: v["library_ms"]
                                      for t, v in k["shapes"].items()},
                chain_estimate_ms=k["chain_estimate_ms"])
        if name in ("cepstrum_lpc", "deemphasis"):  # 1, 15, 16 x 50 frames
            kernels[-1].update(
                ms_by_streams={b: v["profiler_ms"] or v["events_ms"]
                               for b, v in k["shapes"].items()},
                library_ms_by_streams={b: v["library_ms"]
                                       for b, v in k["shapes"].items()},
                call_ms_by_streams={b: v["call_ms"]
                                    for b, v in k["shapes"].items()})
        if name == "lpcnet_sampler_b1":  # ms a 50-frame block by streams
            sweep = so["k2_sweep"]
            kernels[-1].update(
                max_active_clusters=sweep["max_active_clusters"],
                ms_by_streams={b: v["ms"] for b, v in
                               sweep["by_batch"].items()})
    return kernels


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", default=None,
                        help="Also write every measurement to this JSON file.")
    sys.exit(main(parser.parse_args().report))
