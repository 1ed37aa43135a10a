"""A/B harness on the port (counterpart of tools/vocoder_ab.py): synthesize
an LPCNet ``.f32`` feature file and quantify parity against a reference
rendering.

The 36-column ``.f32`` format is what ``lpcnet_demo -features in.pcm
out.f32`` writes; ``lpcnet_demo -synthesis out.f32 out.pcm`` is the C
rendering to compare against::

    python tools/torch_vocoder_ab.py feats.f32 --weights model.npz \\
        --out ours.wav [--h5 lpcnet.h5] [--ref-pcm theirs.pcm] [--rtf] \\
        [--device cpu]

Without ``--weights`` or ``--h5`` the DSP vocoder renders (kernel D1 on
the card); with either, the neural vocoder (the sampler kernel, K2 at bunch
1).  ``--h5`` reads a Keras checkpoint in the xiph layout through
``vocoder/interop.py`` and needs h5py; ``main(argv, datasets=...)`` takes
the file's datasets in memory instead (``interop.read_datasets``'s dict,
e.g. tools/torch_make_import_fixture.py's ``foreign_datasets()``).

Parity metrics: Bark-cepstral distortion and per-band level SNR between
the two renderings (frame-aligned: both vocoders are frame-synchronous,
``eval/quality.py::score``).  Autoregressive samplers never match sample
for sample (different noise), so the spectral-envelope distance is the
meaningful number; < ~4 dB is "same voice, same intelligibility".

``--rtf`` times the synthesis after a warm-up call: the best of three
wall-clock calls, each ending in the int16 read-back with the card
synchronized, and on the card a device figure from CUDA events around
four chained calls (each call's state feeding the next) behind one
synchronize, printed with the card's name.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dss_tpu_torch.device import resolve_device  # noqa: E402
from dss_tpu_torch.eval.quality import score  # noqa: E402
from dss_tpu_torch.utils.audio import read_wav, write_wav  # noqa: E402
from dss_tpu_torch.vocoder import interop  # noqa: E402
from dss_tpu_torch.vocoder.lpcnet import LPCFeatureFile, LPCNet  # noqa: E402

CHAIN = 4  # chained calls behind one synchronize for the device figure


def _rtf(voc, feats: np.ndarray, device: torch.device) -> dict:
    """Wall-clock and (on the card) device real-time factors of one
    synthesis of ``feats``."""
    audio_s = feats.shape[0] * 0.01
    voc.warm(feats.shape[0])
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        voc.synthesize_frames(feats)  # ends in the int16 read-back
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    out = {"audio_s": audio_s, "wall_ms": wall * 1e3,
           "rtf_wall": audio_s / wall, "rtf_device": None,
           "device_ms": None, "device_name": None}
    print(f"rtf: {audio_s / wall:.1f}x realtime wall ({audio_s:.2f} s audio "
          f"in {wall * 1e3:.1f} ms incl. the read-back, {device})")
    if device.type == "cuda":
        fx = feats[None]
        best = np.inf
        for _ in range(3):
            st = voc._fresh_state()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(CHAIN):
                _, st = voc._run(st, fx)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / CHAIN)
        name = torch.cuda.get_device_name(device)
        out.update(rtf_device=audio_s / (best / 1e3), device_ms=best,
                   device_name=name)
        print(f"rtf: {audio_s / (best / 1e3):.1f}x realtime device "
              f"({best:.2f} ms a call by CUDA events over {CHAIN} chained "
              f"calls, best of 3; {name})")
    return out


def main(argv=None, datasets: interop.Datasets = None) -> dict:
    """Renders the features, writes ``--out`` and returns what it printed:
    frames, the rendering's rms and peak, ``rtf`` (with ``--rtf``) and
    ``ab`` (with ``--ref-pcm``)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("features", help="36-column .f32 LPCNet feature file")
    parser.add_argument("--weights", default=None,
                        help=".npz checkpoint (native trainer format)")
    parser.add_argument("--h5", default=None,
                        help="Keras LPCNet checkpoint (xiph layout; needs "
                             "h5py)")
    parser.add_argument("--out", default="ab_ours.wav")
    parser.add_argument("--ref-pcm", default=None,
                        help="Reference rendering: raw int16 @ 16 kHz "
                             "(lpcnet_demo -synthesis output) or a .wav")
    parser.add_argument("--rtf", action="store_true",
                        help="Time the synthesis after a warm-up call and "
                             "report the real-time factor")
    parser.add_argument("--device", default=None,
                        help="Torch device (default: cuda).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.h5 and datasets is None:
        datasets = interop.read_datasets(args.h5)
    if datasets is not None:
        params, model = interop.params_from_datasets(datasets)
        voc = LPCNet(backend="net", model=model, weights=params,
                     device=device)
    else:
        voc = LPCNet(backend="net" if args.weights else "dsp",
                     weights=args.weights, device=device)

    feats = np.stack(list(LPCFeatureFile(args.features)))
    print(f"features: {feats.shape[0]} frames "
          f"({feats.shape[0] * 0.01:.2f} s)")
    result = {"frames": int(feats.shape[0]), "backend": voc.backend}
    if args.rtf:
        result["rtf"] = _rtf(voc, feats, device)
    voc.reset_decoder()
    pcm = voc.synthesize_frames(feats)
    write_wav(args.out, pcm.astype(np.int16))
    result.update(rms=float(np.sqrt(np.mean(pcm.astype(float) ** 2))),
                  peak=int(np.abs(pcm).max()))
    print(f"ours: {args.out} rms={result['rms']:.1f} peak={result['peak']}")

    if args.ref_pcm:
        if args.ref_pcm.endswith(".wav"):
            _, ref = read_wav(args.ref_pcm)
        else:
            ref = np.fromfile(args.ref_pcm, dtype=np.int16)
        n = min(len(ref), len(pcm))
        print(f"ref:  {args.ref_pcm} rms="
              f"{np.sqrt(np.mean(ref[:n].astype(float) ** 2)):.1f} "
              f"({len(ref)} samples; comparing {n})")
        report = score(ref[:n], pcm[:n], device=device)
        result["ab"] = {"samples": int(n),
                        "cepstral_distance_db": report.cepstral_distance_db,
                        "band_level_snr_db": report.band_level_snr_db}
        print(f"A/B Bark-cepstral distortion: "
              f"{report.cepstral_distance_db:.2f} dB")
        print(f"A/B band-level SNR:           "
              f"{report.band_level_snr_db:.2f} dB")
    return result


if __name__ == "__main__":
    main()
