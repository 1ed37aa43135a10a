"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--report PATH]

1. Builds the port's CUDA kernels (dss_tpu_torch/csrc) with nvcc.
2. Holds each kernel against its plain PyTorch version on the card:
   log power (K1) at the packet shapes and at [20000, 64], atol 1e-5;
   the LPCNet sampler (K2) greedy over two full-width frames (identical
   excitations, atol 1e-5), and stochastic over one 50-frame block on the
   same noise (first divergence after the first frame, RMS within 1 dB).
3. Drives the port's online word path once: a 6 s, 129-channel synthetic
   session (one loud burst) replayed in 40-sample packets at real time
   through FusedFrontendVad -> FusedDecoderVocoder in the port's graph,
   with a threshold-VAD checkpoint, a seeded 2 x 100 decoder and the
   shipped weights/vocoder_speech.npz; at least one segment must close
   and each word's int16 PCM must hold frames x 160 finite samples.  The
   kernels' launch counts are zeroed just before and read just after.
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


def session(seconds=6.0, burst=(2.0, 3.5), seed=7):
    """The synthetic session of tools/make_verify_fixtures.py."""
    fs = 1000
    rng = np.random.default_rng(seed)
    T = int(seconds * fs)
    envelope = np.full(T, 0.05)
    envelope[int(burst[0] * fs):int(burst[1] * fs)] = 2.0
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
    from dss_tpu_torch.ops.filters import sosfilt_scan
    from dss_tpu_torch.ops.log_power import log_power, log_power_plain
    from dss_tpu_torch.ops.sampler import prepare_sampler_weights, \
        sampler_frames, sampler_frames_plain, tile_sparse_pattern
    from dss_tpu_torch.vocoder import net as tnet
    from dss_tpu_torch.vocoder.lpc import bands_from_cepstrum, lpc_from_bands
    from dss_tpu_torch.vocoder.lpcnet import _load_params

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

    # ---- K2: sampler -------------------------------------------------------
    params = _load_params(ROOT / "weights" / "vocoder_speech.npz", dev)
    model = tnet.LPCNetModel.from_params(params)
    w = prepare_sampler_weights(params)

    def inputs(frames, seed):
        g = torch.Generator().manual_seed(seed)
        feats = torch.randn((1, frames, 20), generator=g) * 0.3
        feats[..., 0] -= 4.0
        feats = feats.to(dev)
        cond = model.condition(params, feats)
        lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :18]))
        temp = 1.0 + 1.5 * torch.clamp(feats[..., 19] + 0.5, 0.0, 1.0)
        st = tnet.net_vocoder_init(model, 1, device=dev)
        return ((st.h_a, st.h_b, st.sig_mem, st.exc_idx),
                cond.transpose(0, 1).contiguous(),
                lpc.transpose(0, 1).contiguous(),
                temp.transpose(0, 1).contiguous())

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
        GA, GB, CD = model.gru_a_units, model.gru_b_units, model.cond_dim
        n = 50 * 160
        # GRU-A's recurrent product needs only the mask's kept [16 x 128]
        # tiles (what the TPU kernel reads), though this kernel runs it dense.
        _, kept = tile_sparse_pattern(params["gru_a_mask"].cpu().numpy())
        wbytes = (sum(t.numel() for t in w.values())
                  - (1.0 - kept) * w["wh_a"].numel()) * 4
        nbytes = (wbytes + noise.numel() * 4 + (cond.numel() + lpc.numel()
                  + temp.numel()) * 4 + n * 4)
        per_sample = (kept * 2 * GA * 3 * GA + 3 * 3 * GA + 2 * GA * 3 * GB
                      + 2 * GB * 3 * GB + 2 * GB * 512 + 3 * 256
                      + 12 * (GA + GB) + 2 * 16)
        flops = n * per_sample + 50 * 2 * CD * 3 * (GA + GB)
        bound = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
        report["kernels"]["lpcnet_sampler_b1"].update(
            first_divergence=first, rms_db=db, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, gru_a_tiles_kept=kept,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S
            > flops / H100_F32_FLOPS else "operations",
            us_per_sample=ms * 1e3 / n, real_time_factor=ms / 500.0)
        print(f"K2 stochastic: first divergence at sample {first}, RMS "
              f"{rms_k:.4f} vs {rms_p:.4f} ({db:+.3f} dB), {ms:.1f} ms per "
              f"8000-sample block, real-time factor {ms / 500.0:.3f} (plain "
              f"{plain_ms:.0f} ms); bound {bound:.4f} ms with {kept:.1%} of "
              f"GRU-A's tiles kept")
        if first < 160 or not abs(db) < 1.0:
            raise AssertionError("K2 stochastic out of tolerance")
    ph.run("K2 sampler stochastic vs plain (50 frames)", k2_stochastic)

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

    # ---- the main path -----------------------------------------------------
    def main_path():
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
                                            / "vocoder_speech.npz")))

                def network(self):
                    return ((self.SOURCE.OUTPUT, self.FRONTEND.INPUT),
                            (self.FRONTEND.OUTPUT, self.WORDS.INPUT),
                            (self.WORDS.OUTPUT, self.SINK.AUDIO),
                            (self.WORDS.WORD, self.SINK.WORD),
                            (self.WORDS.LPC, self.SINK.LPC))

            system = System()
            log_power.launches = 0
            sampler_frames.launches = 0
            t0 = time.perf_counter()
            ez.run_system(system)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"log_power": log_power.launches,
                        "lpcnet_sampler_b1": sampler_frames.launches}
        sink = system.SINK
        mp = report["main_path"]
        mp.update(
            wall_s=wall, launches=launches, words=len(sink.words),
            word_frames=[len(x) for x in sink.lpc],
            packet_ms_p50=pct(system.FRONTEND.step_ms, 50),
            packet_ms_p95=pct(system.FRONTEND.step_ms, 95),
            packet_calls=len(system.FRONTEND.step_ms),
            word_head_ms=system.WORDS.word_ms,
            ingest_to_first_audio_ms=sink.first_audio_ms)
        print(f"main path: {len(sink.words)} word(s) of "
              f"{mp['word_frames']} frames, {wall:.1f} s wall, launches "
              f"{launches}; packet step p50 {mp['packet_ms_p50']:.2f} ms / "
              f"p95 {mp['packet_ms_p95']:.2f} ms over "
              f"{mp['packet_calls']} calls; word head "
              f"{[round(x, 1) for x in system.WORDS.word_ms]} ms; "
              f"ingest->first audio "
              f"{[round(x, 1) for x in sink.first_audio_ms]} ms")
        if not sink.words:
            raise AssertionError("no segment closed")
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
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"main path")
    ph.run("main path (frontend+nVAD -> decoder+vocoder)", main_path)

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
        "lpcnet_sampler_b1": ("cuda", "dss_tpu_torch/csrc/lpcnet_sampler.cu",
                              "dss_tpu/ops/pallas/sampler.py:292"),
    }
    kernels = []
    for name, (route, src, replaces) in meta.items():
        k = report["kernels"][name]
        kernels.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces,
            "launches": report["main_path"]["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
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
