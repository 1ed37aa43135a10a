"""Closed-loop speech neuroprosthesis on the port: the online entry point.

    python -m dss_tpu_torch.apps.decode_online CFG.ini [--run NAME]
        [--overwrite] [--device cuda|cpu]

Reads the INI schema of apps/decode_online.py (e.g.
config/debug_settings.ini) and builds the fused graph: ZMQ ingest ->
FusedFrontendVad (front end + nVAD + segmenting) -> FusedDecoderVocoder
(decoder + neural vocoder) -> int16 PCM on stdout, with the raw / HGA / VAD
/ LPC / wav log taps.  Only ``vocoder_backend = net`` is ported; the
separate-chain units, the DSP vocoder and ``segment_policy_labs`` are not.
"""

from __future__ import annotations

import argparse
import configparser
import json
import logging
import os
import sys
from pathlib import Path
from typing import Iterable, Optional, Tuple

import numpy as np

from .. import runtime as ez
from ..models.decoder import BidirectionalSpeechSynthesisModel
from ..models.vad import UnidirectionalVoiceActivityDetector
from ..ops.car import CommonAverageReferencing, ZScoreNormalization
from ..runtime.units import (
    BinaryLogger,
    DelayedStdoutForSoX,
    DelayedWavLogger,
    DelayedWavLoggerSettings,
    FusedDecoderVocoder,
    FusedDecoderVocoderSettings,
    FusedFrontendVad,
    FusedFrontendVadSettings,
    LoggerSettings,
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
    vocoder_weights: Optional[str] = None
    idle_timeout: Optional[float] = None
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
    """ZMQ ingest -> fused packet path -> fused word path -> stdout PCM."""

    CONNECTOR = ZMQConnector()
    FUSED_FRONTEND = FusedFrontendVad()
    DECODE_VOCODE = FusedDecoderVocoder()
    LOUDSPEAKER = DelayedStdoutForSoX()
    RAW_LOGGER = BinaryLogger()
    HGA_LOGGER = BinaryLogger()
    VAD_LOGGER = VoiceActivityDetectionLogger()
    LPC_LOGGER = BinaryLogger()
    WAV_LOGGER = DelayedWavLogger()

    SETTINGS: NeuroprosthesisSettings

    def configure(self) -> None:
        s = self.SETTINGS
        self.CONNECTOR.apply_settings(ZMQConnectorSettings(
            fs=s.fs, address=s.address, port=s.port,
            idle_timeout=s.idle_timeout))
        pre, post, nb_features = feature_transforms(s.normalization_statistics)
        self.FUSED_FRONTEND.apply_settings(FusedFrontendVadSettings(
            nb_features=nb_features, fs=s.fs, buffer_size=2000,
            context_frames=50, pre_transforms=pre, post_transforms=post,
            package_size=s.package_size, raw_channels=129,
            vad_architecture=UnidirectionalVoiceActivityDetector,
            vad_weights_path=s.vad_model_weights,
            vad_parameters=dict(nb_layer=2, nb_hidden_units=150,
                                nb_electrodes=nb_features),
            device=s.device))
        logger.info(f"VAD model weights: {s.vad_model_weights}; decoding "
                    f"model weights: {s.decoding_model_weights}; vocoder "
                    f"weights: {s.vocoder_weights}")
        self.DECODE_VOCODE.apply_settings(FusedDecoderVocoderSettings(
            path_to_model_weights=(str(s.decoding_model_weights)
                                   if s.decoding_model_weights else None),
            model=BidirectionalSpeechSynthesisModel,
            params=dict(nb_layer=2, nb_hidden_units=100,
                        nb_electrodes=nb_features),
            vocoder_weights=s.vocoder_weights,
            chunk_emission=s.chunked_emission,
            length_multiple=s.segment_length_multiple,
            prewarm_frames=tuple(s.segment_prewarm_frames),
            device=s.device))
        dest = s.destination_dir
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
        return (
            (self.CONNECTOR.OUTPUT, self.FUSED_FRONTEND.INPUT),
            (self.CONNECTOR.OUTPUT, self.RAW_LOGGER.INPUT),
            (self.FUSED_FRONTEND.FEATURES, self.HGA_LOGGER.INPUT),
            (self.FUSED_FRONTEND.OUTPUT, self.VAD_LOGGER.INPUT),
            (self.FUSED_FRONTEND.OUTPUT, self.DECODE_VOCODE.INPUT),
            (self.DECODE_VOCODE.LPC, self.LPC_LOGGER.INPUT),
            (self.DECODE_VOCODE.OUTPUT, self.LOUDSPEAKER.INPUT),
            (self.DECODE_VOCODE.WORD, self.WAV_LOGGER.INPUT),
        )


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

    backend = optional("vocoder_backend") or "dsp"
    if backend != "net":
        raise ValueError(f"vocoder_backend = {backend}: the port runs the "
                         f"neural vocoder only; set vocoder_backend = net")
    if optional("segment_policy_labs"):
        logger.warning("segment_policy_labs is not ported; using the "
                       "configured buckets")
    prewarm = optional("segment_prewarm_frames",
                       lambda v: tuple(json.loads(v)))
    chunked = (optional("chunked_emission") or "true").lower()
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
        vocoder_weights=(optional("vocoder_weights")
                         or str(PACKAGED_VOCODER)),
        idle_timeout=optional("idle_timeout", float),
        chunked_emission=chunked in ("1", "true", "yes", "auto"),
        segment_length_multiple=optional("segment_length_multiple", int) or 50,
        segment_prewarm_frames=((50, 150, 200, 250, 300) if prewarm is None
                                else prewarm),
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
    ez.run_system(Neuroprosthesis(settings))


if __name__ == "__main__":
    main()
