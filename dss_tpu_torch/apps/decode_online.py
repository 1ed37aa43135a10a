"""Closed-loop speech neuroprosthesis on the port: the online entry point.

    python -m dss_tpu_torch.apps.decode_online CFG.ini [--run NAME]
        [--overwrite] [--device cuda|cpu] [--profile-dir DIR]

Reads the INI schema of apps/decode_online.py (e.g.
config/debug_settings.ini, which ships ``vocoder_backend = dsp`` and
``fused_* = auto``) and builds the same graph: ZMQ ingest -> packet path
-> segments -> word path -> int16 PCM on stdout, with the raw / HGA / VAD /
LPC / wav log taps and ``latency_budget.json``.

* Packet path: ``FusedFrontendVad`` (front end + nVAD in one device call)
  when ``fused_frontend`` is true, else ``HighGammaActivity`` ->
  ``FilterSpeechSegments``.
* Word path: ``FusedDecoderVocoder`` when ``fused_decoder`` is true, else
  ``RecurrentNeuralDecodingModel`` -> ``DelayedLPCNetVocoder``.
* ``auto`` (the default of both) resolves as the JAX app resolves it on an
  accelerator: a fused packet path when the device is ``cuda``; a fused
  word path only on ``cuda`` with ``vocoder_backend = net``.  So the
  shipped INI runs ``FusedFrontendVad -> RecurrentNeuralDecodingModel ->
  DelayedLPCNetVocoder(dsp)`` on the card and the fully separate chain on
  the CPU.
* ``vocoder_backend``: ``dsp`` (the default, weight-free; kernel D1 on the
  card) or ``net`` (``vocoder_weights``, default the packaged flagship;
  bunched checkpoints carry their bunch).
* ``segment_policy_labs``: prior runs' ``log.vad.lab`` files pick the
  padding bucket and the warmed lengths (runtime/bucket_policy.py).

``Neuroprosthesis.configure_source`` is the one place that names the
ingest, so a caller can replay a session in-process (``PacketReplay``)
through the same units.  ``--profile-dir`` records the whole run as a
``torch.profiler`` trace (utils/profiling.py: every thread's CPU ops and,
on the card, every CUDA kernel) into that directory, with the units' host
spans (utils/tracing.py, switched on for the run) beside them on the
trace's clock.
"""

from __future__ import annotations

import argparse
import configparser
import contextlib
import glob
import json
import logging
import os
import sys
from pathlib import Path
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .. import runtime as ez
from ..models.decoder import BidirectionalSpeechSynthesisModel
from ..models.vad import UnidirectionalVoiceActivityDetector
from ..ops.car import CommonAverageReferencing, ZScoreNormalization
from ..runtime.bucket_policy import choose_policy, load_lab_lengths
from ..runtime.units import (
    BinaryLogger,
    DelayedLPCNetVocoder,
    DelayedLPCNetVocoderSettings,
    DelayedStdoutForSoX,
    DelayedWavLogger,
    DelayedWavLoggerSettings,
    FilterSpeechSegments,
    FilterSpeechSegmentsSettings,
    FusedDecoderVocoder,
    FusedDecoderVocoderSettings,
    FusedFrontendVad,
    FusedFrontendVadSettings,
    HighGammaActivity,
    HighGammaActivitySettings,
    LoggerSettings,
    RecurrentNeuralDecodingModel,
    RecurrentNeuralDecodingModelSettings,
    SoXOutputSettings,
    VoiceActivityDetectionLogger,
    ZMQConnector,
    ZMQConnectorSettings,
)
from ..utils.channels import (
    SelectElectrodesFromBothGrids,
    SelectElectrodesOverSpeechAreas,
    default_layout,
    motor_grid,
    speech_grid,
)
from ..utils.profiling import device_trace

logger = logging.getLogger("dss_tpu_torch.decode_online")

PACKAGED_VOCODER = Path(__file__).resolve().parents[2] / "weights" / \
    "vocoder_speech.npz"


class NeuroprosthesisSettings(ez.Settings):
    destination_dir: str
    address: str
    fs: int
    package_size: int
    port: int = 5556
    bad_channels: Optional[Iterable] = None
    decoding_model_weights: Optional[Path] = None
    vad_model_weights: Optional[Path] = None
    normalization_statistics: Optional[Path] = None
    vocoder_backend: str = "dsp"
    vocoder_weights: Optional[str] = None
    idle_timeout: Optional[float] = None
    # Front end + nVAD in one device call per packet (else two units).
    fused_frontend: bool = False
    # Decode + vocode in one unit per word (else two units).
    fused_decoder: bool = False
    # Ship a word's audio in 50-frame chunks (fused word path, net only).
    chunked_emission: bool = True
    segment_length_multiple: int = 50
    segment_prewarm_frames: Tuple[int, ...] = (50, 150, 200, 250, 300)
    device: Optional[str] = None  # None = cuda


def feature_transforms(normalization_statistics: Optional[Path]):
    """(pre_transforms, post_transforms, nb_features): grid order, CAR,
    speech-area selection, then z-scoring with the day's statistics
    (zero-mean / unit-variance when none are given)."""
    channel_selection = SelectElectrodesOverSpeechAreas()
    pre = [SelectElectrodesFromBothGrids(),
           CommonAverageReferencing(exclude_channels=[19, 38, 48, 52],
                                    grids=[speech_grid(), motor_grid()],
                                    layout=default_layout()),
           channel_selection]
    if normalization_statistics is None:
        logger.info("Found no normalization data. Going to use zero-mean "
                    "and unit-variance.")
        means = np.zeros(128, dtype=np.float32)
        stds = np.ones(128, dtype=np.float32)
    else:
        statistics = np.load(Path(normalization_statistics).as_posix())
        if statistics.shape[1] == len(channel_selection):
            return pre, [ZScoreNormalization(statistics[0], statistics[1])], \
                len(channel_selection)
        means, stds = statistics[0, :], statistics[1, :]
    post = ZScoreNormalization(
        channel_means=channel_selection(means.reshape((1, -1))),
        channel_stds=channel_selection(stds.reshape((1, -1))))
    return pre, [post], len(channel_selection)


class Neuroprosthesis(ez.System):
    """Ingest -> packet path -> word path -> stdout PCM, plus the log taps;
    ``configure`` removes the units that the ``fused_*`` switches leave
    out."""

    CONNECTOR = ZMQConnector()
    FEATURE_EXTRACTOR = HighGammaActivity()
    SPEECH_FILTER = FilterSpeechSegments()
    FUSED_FRONTEND = FusedFrontendVad()
    DECODING_MODEL = RecurrentNeuralDecodingModel()
    WAVEFORM_GENERATOR = DelayedLPCNetVocoder()
    DECODE_VOCODE = FusedDecoderVocoder()
    LOUDSPEAKER = DelayedStdoutForSoX()
    RAW_LOGGER = BinaryLogger()
    HGA_LOGGER = BinaryLogger()
    VAD_LOGGER = VoiceActivityDetectionLogger()
    LPC_LOGGER = BinaryLogger()
    WAV_LOGGER = DelayedWavLogger()

    SETTINGS: NeuroprosthesisSettings

    def configure_source(self) -> None:
        s = self.SETTINGS
        self.CONNECTOR.apply_settings(ZMQConnectorSettings(
            fs=s.fs, address=s.address, port=s.port,
            idle_timeout=s.idle_timeout))

    def configure(self) -> None:
        s = self.SETTINGS
        self.configure_source()
        pre, post, nb_features = feature_transforms(s.normalization_statistics)
        vad = dict(vad_architecture=UnidirectionalVoiceActivityDetector,
                   vad_weights_path=s.vad_model_weights,
                   vad_parameters=dict(nb_layer=2, nb_hidden_units=150,
                                       nb_electrodes=nb_features))
        if s.fused_frontend:
            delattr(self, "FEATURE_EXTRACTOR")
            delattr(self, "SPEECH_FILTER")
            self.FUSED_FRONTEND.apply_settings(FusedFrontendVadSettings(
                nb_features=nb_features, fs=s.fs, buffer_size=2000,
                context_frames=50, pre_transforms=pre, post_transforms=post,
                package_size=s.package_size, raw_channels=129,
                device=s.device, **vad))
        else:
            delattr(self, "FUSED_FRONTEND")
            self.FEATURE_EXTRACTOR.apply_settings(HighGammaActivitySettings(
                fs=s.fs, nb_electrodes=nb_features, pre_transforms=pre,
                post_transforms=post, package_size=s.package_size,
                raw_channels=129,  # BCI2000 exports: 128 ECoG + 1 audio
                device=s.device))
            self.SPEECH_FILTER.apply_settings(FilterSpeechSegmentsSettings(
                nb_features=nb_features, fs=s.fs, buffer_size=2000,
                context_frames=50, device=s.device, **vad))
        logger.info(
            f"VAD model weights: {s.vad_model_weights}; decoding model "
            f"weights: {s.decoding_model_weights}; vocoder: "
            f"backend={s.vocoder_backend} weights={s.vocoder_weights}; "
            f"fused_frontend={s.fused_frontend} "
            f"fused_decoder={s.fused_decoder} "
            f"chunked_emission={s.chunked_emission}; segment buckets: "
            f"length_multiple={s.segment_length_multiple} prewarm="
            f"{list(s.segment_prewarm_frames)}")
        decoder = dict(
            path_to_model_weights=(str(s.decoding_model_weights)
                                   if s.decoding_model_weights else None),
            model=BidirectionalSpeechSynthesisModel,
            params=dict(nb_layer=2, nb_hidden_units=100,
                        nb_electrodes=nb_features),
            length_multiple=s.segment_length_multiple,
            prewarm_frames=tuple(s.segment_prewarm_frames), device=s.device)
        if s.fused_decoder:
            delattr(self, "DECODING_MODEL")
            delattr(self, "WAVEFORM_GENERATOR")
            self.DECODE_VOCODE.apply_settings(FusedDecoderVocoderSettings(
                vocoder_backend=s.vocoder_backend,
                vocoder_weights=s.vocoder_weights,
                chunk_emission=s.chunked_emission, **decoder))
        else:
            delattr(self, "DECODE_VOCODE")
            self.DECODING_MODEL.apply_settings(
                RecurrentNeuralDecodingModelSettings(**decoder))
            self.WAVEFORM_GENERATOR.apply_settings(
                DelayedLPCNetVocoderSettings(backend=s.vocoder_backend,
                                             weights=s.vocoder_weights,
                                             device=s.device))
        dest = s.destination_dir
        self.LOUDSPEAKER.apply_settings(SoXOutputSettings(
            budget_path=os.path.join(dest, "latency_budget.json")))
        self.RAW_LOGGER.apply_settings(LoggerSettings(
            filename=os.path.join(dest, "log.raw.f64"), overwrite=True))
        self.HGA_LOGGER.apply_settings(LoggerSettings(
            filename=os.path.join(dest, "log.hga.f64"), overwrite=True))
        self.VAD_LOGGER.apply_settings(LoggerSettings(
            filename=os.path.join(dest, "log.vad.lab"), overwrite=True))
        self.LPC_LOGGER.apply_settings(LoggerSettings(
            filename=os.path.join(dest, "log.lpc.f32"), overwrite=True))
        self.WAV_LOGGER.apply_settings(DelayedWavLoggerSettings(
            base_path=Path(os.path.join(dest, "reco")), prefix="reco",
            overwrite=True))

    def network(self) -> ez.NetworkDefinition:
        # Packet path: ingest -> features -> VAD-gated segments (+ taps).
        if self.SETTINGS.fused_frontend:
            edges = [
                (self.CONNECTOR.OUTPUT, self.FUSED_FRONTEND.INPUT),
                (self.CONNECTOR.OUTPUT, self.RAW_LOGGER.INPUT),
                (self.FUSED_FRONTEND.FEATURES, self.HGA_LOGGER.INPUT),
                (self.FUSED_FRONTEND.OUTPUT, self.VAD_LOGGER.INPUT),
            ]
            segments = self.FUSED_FRONTEND.OUTPUT
        else:
            edges = [
                (self.CONNECTOR.OUTPUT, self.FEATURE_EXTRACTOR.INPUT),
                (self.FEATURE_EXTRACTOR.OUTPUT, self.SPEECH_FILTER.INPUT),
                (self.CONNECTOR.OUTPUT, self.RAW_LOGGER.INPUT),
                (self.FEATURE_EXTRACTOR.OUTPUT, self.HGA_LOGGER.INPUT),
                (self.SPEECH_FILTER.OUTPUT, self.VAD_LOGGER.INPUT),
            ]
            segments = self.SPEECH_FILTER.OUTPUT
        # Word path: segments -> acoustic features -> audio (+ taps).
        if self.SETTINGS.fused_decoder:
            edges += [
                (segments, self.DECODE_VOCODE.INPUT),
                (self.DECODE_VOCODE.LPC, self.LPC_LOGGER.INPUT),
                # OUTPUT: audio chunks in order; WORD: the whole word.
                (self.DECODE_VOCODE.OUTPUT, self.LOUDSPEAKER.INPUT),
                (self.DECODE_VOCODE.WORD, self.WAV_LOGGER.INPUT),
            ]
        else:
            edges += [
                (segments, self.DECODING_MODEL.INPUT),
                (self.DECODING_MODEL.OUTPUT, self.WAVEFORM_GENERATOR.INPUT),
                (self.WAVEFORM_GENERATOR.OUTPUT, self.LOUDSPEAKER.INPUT),
                (self.DECODING_MODEL.OUTPUT, self.LPC_LOGGER.INPUT),
                (self.WAVEFORM_GENERATOR.OUTPUT, self.WAV_LOGGER.INPUT),
            ]
        return tuple(edges)


def build_settings(settings_filename: str, run_name: str,
                   device: Optional[str] = None) -> NeuroprosthesisSettings:
    config = configparser.ConfigParser()
    if not config.read(settings_filename):
        raise FileNotFoundError(settings_filename)

    def optional(key, conv=lambda v: v):
        try:
            value = config.get("Decoding", key)
        except (configparser.NoOptionError, configparser.NoSectionError):
            return None
        return None if value == "" else conv(value)

    def switch(key, auto):
        raw = (optional(key) or "auto").lower()
        return auto if raw == "auto" else raw in ("1", "true", "yes")

    backend = optional("vocoder_backend") or "dsp"
    weights = optional("vocoder_weights")
    if backend == "net" and not weights:
        weights = str(PACKAGED_VOCODER)  # random weights would be noise
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    prewarm = optional("segment_prewarm_frames",
                       lambda v: tuple(json.loads(v)))
    multiple = optional("segment_length_multiple", int) or 50
    prewarm = (50, 150, 200, 250, 300) if prewarm is None else prewarm
    labs = optional("segment_policy_labs")
    if labs:
        paths = [p for pat in labs.split() for p in sorted(glob.glob(pat))]
        lengths = load_lab_lengths(paths) if paths \
            else np.zeros(0, np.int64)
        if len(lengths) >= 5:
            multiple, prewarm = choose_policy(lengths)
            logger.info(f"Bucket policy from {len(paths)} lab file(s), "
                        f"{len(lengths)} segments: length_multiple="
                        f"{multiple}, prewarm={list(prewarm)}")
        else:
            logger.warning(f"segment_policy_labs matched {len(lengths)} "
                           f"segment(s) (< 5): keeping the configured "
                           f"buckets")
    return NeuroprosthesisSettings(
        destination_dir=os.path.join(config.get("Decoding", "base_out_dir"),
                                     run_name),
        address=config.get("Decoding", "address"),
        port=config.getint("Decoding", "port", fallback=5556),
        fs=config.getint("Decoding", "fs"),
        package_size=config.getint("Decoding", "package_size"),
        bad_channels=optional("bad_channels", json.loads),
        decoding_model_weights=optional("decoding_model_weights", Path),
        vad_model_weights=optional("vad_model_weights", Path),
        normalization_statistics=optional("initial_normalization_statistics",
                                          Path),
        vocoder_backend=backend,
        vocoder_weights=weights,
        idle_timeout=optional("idle_timeout", float),
        # auto: fuse the packet path on the card; fuse the word path only
        # on the card with the neural vocoder (apps/decode_online.py).
        fused_frontend=switch("fused_frontend", on_card),
        fused_decoder=switch("fused_decoder", on_card and backend == "net"),
        chunked_emission=(optional("chunked_emission") or "true").lower()
        in ("1", "true", "yes", "auto"),
        segment_length_multiple=multiple,
        segment_prewarm_frames=prewarm,
        device=device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Real-time speech synthesis from neural signals with "
                    "delayed acoustic feedback (PyTorch/CUDA port).")
    parser.add_argument("config", help="INI file describing the system.")
    parser.add_argument("--run", default="test_run",
                        help="Name of the run folder for logs and results.")
    parser.add_argument("--overwrite", action="store_true",
                        help="Overwrite the run folder if it exists.")
    parser.add_argument("--device", default=None,
                        help="Torch device (default: cuda).")
    parser.add_argument("--profile-dir", default=None,
                        help="Record a torch.profiler trace of the run, "
                             "with the units' host spans, into this "
                             "directory (Chrome/TensorBoard trace).")
    args = parser.parse_args(argv)
    settings = build_settings(args.config, args.run, args.device)
    try:
        os.makedirs(settings.destination_dir, exist_ok=args.overwrite)
    except FileExistsError:
        logger.error("The destination directory exists and --overwrite is "
                     "not set.")
        sys.exit(1)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        handlers=[logging.FileHandler(
            os.path.join(settings.destination_dir, "log.run.txt"), "w+"),
            logging.StreamHandler(sys.stderr)])
    with device_trace(args.profile_dir, settings.device) \
            if args.profile_dir else contextlib.nullcontext():
        ez.run_system(Neuroprosthesis(settings))


if __name__ == "__main__":
    main()
