"""Runner of a one-user session: the app's graph (``decode_online``'s
``Neuroprosthesis`` as the configuration's INI resolves on the card) fed by
the benchmark's replay source in real time, open loop, one packet every
``package_size / fs`` seconds, each stamped with the time it was due.

The benchmark's sink takes the app's audio (and writes no PCM); a tap on
the feature stream times each packet's frames; the app's loggers write
under the run's directory.  Probes around four of the program's calls keep
what the check needs (segments in, the vocoder's state or samples: the
sampler entry point that the configuration's bunch selects) and the shapes
the rooflines count.  After the window the source stops; the graph
drains, so words closed in the window finish and no new one starts."""

from __future__ import annotations

import asyncio
import configparser
import os
import shutil
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from benchmarks import checks, inputs
from benchmarks.common import ROOT, Probes


def write_ini(config: dict, path: Path) -> None:
    parser = configparser.ConfigParser()
    for section, values in config["ini"].items():
        parser[section] = {k: str(v) for k, v in values.items()}
    with open(path, "w") as fd:
        parser.write(fd)


def build(config, traffic, args, run_dir: Path, device: str):
    """The app's system as the INI resolves on the card, with the
    benchmark's source, sink and feature tap; and the replay's record."""
    from dss_tpu_torch.apps.decode_online import Neuroprosthesis, \
        build_settings
    from dss_tpu_torch.runtime.graph import OutputStream, Unit, publisher, \
        subscriber
    from dss_tpu_torch.runtime.messages import ClosedLoopMessage
    from dss_tpu_torch.runtime.units import BinaryLogger, \
        DelayedStdoutForSoX

    ini = run_dir / "settings.ini"
    write_ini(config, ini)
    # ``auto`` resolves from the device string: the card's resolution.
    s = build_settings(str(ini), "run", device="cuda")
    want = config["resolves_to"]
    got = dict(fused_frontend=s.fused_frontend, fused_decoder=s.fused_decoder,
               vocoder_backend=s.vocoder_backend)
    if got != want:
        raise RuntimeError(f"the INI resolves to {got}, the configuration "
                           f"states {want}")
    vad = run_dir / "vad.npz"
    dec = run_dir / "decoder.npz"
    np.savez(vad, **inputs.threshold_vad())
    np.savez(dec, **inputs.decoder_weights(args.seed,
                                           **config["decoder_weights"]))
    voc = config["ini"]["Decoding"].get("vocoder_weights") or None
    s = replace(s, destination_dir=str(run_dir / "run"),
                vad_model_weights=vad, decoding_model_weights=dec,
                vocoder_weights=str(ROOT / voc) if voc else None,
                device=device)
    os.makedirs(s.destination_dir, exist_ok=True)

    raw = inputs.session(args.seed, traffic, args.seconds)
    period = traffic["package_size"] / traffic["fs"]
    rec = dict(raw=raw, period=period, late_ms=[], due=[], trace=None)

    class Replay(Unit):
        OUTPUT = OutputStream(ClosedLoopMessage)

        @publisher(OUTPUT)
        async def process(self):
            rec["on_start"]()
            P = traffic["package_size"]
            t0 = time.perf_counter() + 0.02
            offset = time.time() - time.perf_counter()
            rec["t0"], rec["offset"] = t0, offset
            for n in range(len(raw) // P):
                due = t0 + n * period
                await asyncio.sleep(max(0.0, due - time.perf_counter()))
                rec["late_ms"].append((time.perf_counter() - due) * 1e3)
                rec["due"].append(due + offset)
                yield self.OUTPUT, ClosedLoopMessage(
                    data=raw[n * P:(n + 1) * P].astype(np.float64),
                    fs=traffic["fs"], received_at=due + offset)
            rec["t_end"] = t0 + len(raw) // P * period
            rec["on_end"]()

    class Sink(DelayedStdoutForSoX):
        @subscriber(DelayedStdoutForSoX.INPUT)
        async def print(self, msg):
            stamps = dict(getattr(msg, "stamps", ()) or ())
            self.messages.append((time.time(), msg.received_at,
                                  np.asarray(msg.data), stamps))

        def initialize(self):
            self.messages = []

        def shutdown(self):
            pass

    class FeatureTap(BinaryLogger):
        @subscriber(BinaryLogger.INPUT)
        async def write(self, message):
            self._fd.write(np.asarray(message.data).tobytes())
            self.arrivals.append((time.time(), len(message.data)))

        def initialize(self):
            super().initialize()
            self.arrivals = []

    class Bench(Neuroprosthesis):
        CONNECTOR = Replay()
        LOUDSPEAKER = Sink()
        HGA_LOGGER = FeatureTap()

        def configure_source(self):
            pass

    return Bench(s), s, rec


def run(ctx) -> dict:
    """Set up, run the window and the drain, check; -> the run's record."""
    import torch

    from dss_tpu_torch import runtime as ez
    from dss_tpu_torch.ops import hga, sampler
    from dss_tpu_torch.runtime import units
    from dss_tpu_torch.vocoder import lpcnet

    config, traffic, args = ctx["config"], ctx["traffic"], ctx["args"]
    run_dir = Path(ctx["run_dir"])
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    system, settings, rec = build(config, traffic, args, run_dir,
                                  ctx["device"])
    net = settings.vocoder_backend == "net"
    probes = Probes()
    probes.wrap(hga, "filter_log_power",
                lambda a, k, out: (time.perf_counter(), a[1].shape[0]))
    probes.wrap(units, "_decode_padded",
                lambda a, k, out: (np.asarray(a[1][:a[2]], np.float32),))
    voc_entry = vocoder_entry(config) if net else "dsp_synthesize_frames"
    if net:
        probes.wrap(sampler, voc_entry,
                    lambda a, k, out: (out[1], a[2].shape[0]))
    else:
        probes.wrap(lpcnet, "dsp_synthesize_frames",
                    lambda a, k, out: (
                        a[0].sig_mem[0].clone(), a[0].pitch_phase[0].clone(),
                        a[0].deemph_mem[0].clone(), a[0].frame_ctr,
                        a[1].shape[-2]))
    trace = ctx["trace"]

    def on_start():
        rec["setup_end"] = time.perf_counter()
        if trace is not None:
            trace.start()
        for name in probes.calls:
            rec.setdefault("warm_calls", {})[name] = len(probes.calls[name])

    def on_end():
        if trace is not None:
            trace.stop()

    rec["on_start"], rec["on_end"] = on_start, on_end
    try:
        ez.run_system(system)
    finally:
        probes.restore()
    # The word path's vocoder as loaded must be the one the probe and the
    # judge were chosen for.
    loaded = system.DECODE_VOCODE._voc_model.bunch if net else None
    if net and loaded != config["vocoder"]["bunch"]:
        raise RuntimeError(f"the word path loaded a bunch-{loaded} "
                           f"vocoder; the configuration states bunch "
                           f"{config['vocoder']['bunch']}")
    rec["drain_end"] = time.perf_counter()
    if trace is not None:
        rec["trace"] = trace.finish(rec["t_end"] - rec["t0"])
    if ctx["device"] == "cuda":
        torch.cuda.synchronize()
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return collect(ctx, system, settings, rec, probes, net, voc_entry)


def vocoder_entry(config) -> str:
    """The sampler entry point the configuration's bunch selects."""
    return "sampler_frames" if config["vocoder"]["bunch"] == 1 \
        else "sampler_frames_bunched"


def collect(ctx, system, settings, rec, probes, net, voc_entry) -> dict:
    """The run's numbers, from the records of the source, tap and sink, the
    units' own lists and the probes; then the check."""
    traffic = ctx["traffic"]
    P = traffic["package_size"]
    n_packets = len(rec["due"])
    # Packet p's frames are out once the feature stream holds 4 p + 1.
    per = P // 10
    lat, frames, p = [], 0, 0
    for t, n in system.HGA_LOGGER.arrivals:
        frames += n
        while p < n_packets and per * p + 1 <= frames:
            lat.append((t - rec["due"][p]) * 1e3)
            p += 1
    words = split_words(system.LOUDSPEAKER.messages)
    warm = rec.get("warm_calls", {})
    segs = [c[0] for c in probes.calls["_decode_padded"][
        warm.get("_decode_padded", 0):]]
    out = dict(
        kind="session", vocoder="net" if net else "dsp",
        setup_s=rec["setup_end"] - ctx["t_start"],
        window_s=rec["t_end"] - rec["t0"],
        packets=n_packets, packet_lat_ms=lat, replay_late_ms=rec["late_ms"],
        first_audio_ms=[(w["first"] - w["received_at"]) * 1e3
                        for w in words],
        word_frames=[len(s) for s in segs],
        word_span_s=[w["last"] - w["stamps"]["seg_close"] for w in words
                     if "seg_close" in w["stamps"]],
        trace=rec["trace"], memory_peak_bytes=rec.get("memory_peak_bytes"))
    fe_calls = [T for t, T in probes.calls["filter_log_power"]
                if rec["t0"] <= t <= rec["t_end"]]
    out["fe_call_samples"] = fe_calls
    if settings.fused_frontend:
        out["fe_step_ms"] = list(system.FUSED_FRONTEND.step_ms)
    if settings.fused_decoder:
        out["word_head_ms"] = list(system.DECODE_VOCODE.word_ms)
    else:
        out["decode_ms"] = list(system.DECODING_MODEL.decode_ms)
        out["vocode_ms"] = list(system.WAVEFORM_GENERATOR.vocode_ms)
        out["word_head_ms"] = [a + b for a, b in zip(out["decode_ms"],
                                                     out["vocode_ms"])]
    voc = probes.calls[voc_entry][warm.get(voc_entry, 0):]
    out["vocoder_calls"] = [c[-1] for c in voc]
    out["attempted"] = len(segs)
    out["failed"] = sum(1 for k in range(len(segs))
                        if k >= len(words) or len(words[k]["audio"]) == 0)
    dest = Path(settings.destination_dir)
    program = dict(
        features=np.fromfile(dest / "log.hga.f64").reshape(-1, 64),
        segments=segs,
        lpc=np.fromfile(dest / "log.lpc.f32", np.float32).reshape(-1, 20),
        audio=[w["audio"] for w in words],
        vocoder=voc)
    t = time.perf_counter()
    ref = checks.reference_session(ctx, rec["raw"], "float32")
    out["checks"] = checks.session(ctx, rec["raw"], program, net, ref)
    out["check_s"] = time.perf_counter() - t
    if ctx["args"].control:
        out["control"] = checks.session_control(ctx, rec["raw"], program,
                                                net, ref)
    return out


def split_words(messages):
    """The sink's messages grouped by word: a message with a latency stamp
    and no completion stamp starts one; the rest are its later chunks."""
    words = []
    for t, received_at, data, stamps in messages:
        if received_at is not None and "dv_word_complete" not in stamps:
            words.append(dict(first=t, last=t, received_at=received_at,
                              stamps=stamps, audio=[data]))
        elif words:
            words[-1]["last"] = t
            words[-1]["audio"].append(data)
    for w in words:
        w["audio"] = np.concatenate(w["audio"]).astype(np.int16)
    return words
