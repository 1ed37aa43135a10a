"""Streaming graph units of the online closed loop (counterpart of
dss_tpu/runtime/units.py).

* ``ZMQConnector``        — BCI2000 GenericSignal ZMQ SUB ingest (its
  packets: ``interpret_bci2000_packet``; ``pack_packet`` writes them);
* ``PacketReplay``        — in-process replay of a recorded session;
* ``FusedFrontendVad``    — packet -> front end -> nVAD -> segments, one
  device->host read per packet;
* ``HighGammaActivity`` and ``FilterSpeechSegments`` — the same as two
  units (the separate chain): packet -> features, features -> segments;
* ``FusedDecoderVocoder`` — segment -> decoder -> vocoder -> int16 PCM,
  one device->host read per word (plus one per later audio chunk on the
  neural backend);
* ``ShardedFusedDecoderVocoder`` — the word path for many streams: the
  live segment is slot 0 of a serve batch split over the ranks of a
  process group (one slot a rank, or many on one card);
* ``RecurrentNeuralDecodingModel`` and ``DelayedLPCNetVocoder`` — the same
  as two units: segment -> features, features -> int16 PCM;
* ``BinaryLogger``, ``VoiceActivityDetectionLogger``, ``DelayedWavLogger``
  and ``DelayedStdoutForSoX`` — the log taps and the audio sink with its
  latency budget.

Device work runs eagerly on the unit's device (``cuda`` unless the
settings say otherwise) inside a single-worker executor, so a slow device
call never freezes packet ingest and carried state stays ordered.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path
from typing import Any, AsyncGenerator, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from scipy.io.wavfile import write as _wavwrite

from ..device import resolve_device
from ..models.lstm import seeded_init
from ..models.torch_port import load_checkpoint
from ..ops.hga import HighGammaExtractor
from ..ops.ringbuffer import SpeechSegmentHistory, VoiceActivityDetectionSmoothing
from ..utils import tracing
from ..vocoder.dsp import dsp_synthesize_frames, dsp_vocoder_init
from ..vocoder.lpcnet import LPCNet, _load_params, _sparse_pattern_of
from ..vocoder.net import COND_BLOCK, FRAME_SIZE, LPCNetModel, \
    net_synthesize_frames, net_vocoder_init, sampler_weights_for
from .graph import InputStream, OutputStream, Settings, Unit, coalescing, \
    publisher, subscriber
from .messages import ClosedLoopMessage, TimeSeriesMessage

logger = logging.getLogger("dss_tpu_torch.runtime.units")

Transforms = Optional[List[Callable]]

BCI2000_HEADER = struct.Struct("=BBB HH")
BCI2000_TOPIC = struct.Struct("=BBB").pack(4, 1, 2)


def _with_stamps(msg, extra, **kw):
    """``replace(msg, **kw)`` plus appended (stage, wall time) stamps."""
    if isinstance(msg, ClosedLoopMessage):
        kw["stamps"] = getattr(msg, "stamps", ()) + tuple(extra)
    return replace(msg, **kw)


def _anonymize(msg, **kw):
    """``replace(msg, **kw)`` with latency bookkeeping stripped (later audio
    chunks of a word are not fresh word latencies)."""
    if isinstance(msg, ClosedLoopMessage):
        kw.setdefault("received_at", None)
        kw.setdefault("stamps", ())
    return replace(msg, **kw)


def interpret_bci2000_packet(data: bytes) -> np.ndarray:
    """GenericSignal packet -> float64 [samples, channels]: header
    ``=BBB HH`` (descriptor, type, topic, channels, samples), then float32
    values channel-major."""
    _d, _s, _t, ch, sa = BCI2000_HEADER.unpack(data[:BCI2000_HEADER.size])
    payload = np.frombuffer(data[BCI2000_HEADER.size:], np.float32)
    return payload.reshape(ch, sa).T.astype(np.float64, order="C")


def pack_packet(data: np.ndarray) -> bytes:
    """float32 [samples, channels] -> GenericSignal packet, the layout
    ``interpret_bci2000_packet`` reads: header ``=BBB HH`` (4, 1, 2,
    channels, samples), then the values as float32, channel-major."""
    data = np.asarray(data, np.float32)
    n_samples, n_channels = data.shape
    return BCI2000_HEADER.pack(4, 1, 2, n_channels, n_samples) + \
        np.ascontiguousarray(data.T).tobytes()


# region Sources
class ZMQConnectorSettings(Settings):
    fs: int
    port: int = 5556
    address: str = "localhost"
    idle_timeout: Optional[float] = None  # end after this many idle seconds


class ZMQConnector(Unit):
    """SUB socket on the BCI2000 GenericSignal topic with drop-old
    semantics (RCVHWM=1), stamping the ingest time on each message.
    ``zmq`` is imported only here, when the unit starts."""

    SETTINGS: ZMQConnectorSettings
    OUTPUT = OutputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        import zmq
        import zmq.asyncio

        self._context = zmq.asyncio.Context()
        self._socket = self._context.socket(zmq.SUB)
        self._socket.setsockopt(zmq.RCVHWM, 1)
        self._socket.connect(f"tcp://{self.SETTINGS.address}:"
                             f"{self.SETTINGS.port}")
        self._socket.subscribe(BCI2000_TOPIC)

    def shutdown(self) -> None:
        self._socket.close()
        self._context.destroy()

    @publisher(OUTPUT)
    async def process(self) -> AsyncGenerator:
        while not self._socket.closed:
            if self.SETTINGS.idle_timeout is not None:
                try:
                    data = await asyncio.wait_for(
                        self._socket.recv(),
                        timeout=self.SETTINGS.idle_timeout)
                except asyncio.TimeoutError:
                    logger.info("ZMQConnector idle timeout — ending stream.")
                    return
            else:
                data = await self._socket.recv()
            yield self.OUTPUT, ClosedLoopMessage(
                data=interpret_bci2000_packet(data), fs=self.SETTINGS.fs,
                received_at=time.time())


class PacketReplaySettings(Settings):
    data: np.ndarray            # [T, raw_channels] session
    fs: int
    package_size: int = 40
    # Seconds between packets (the amplifier's period); None publishes as
    # fast as the graph's bounded edges accept.
    period: Optional[float] = None


class PacketReplay(Unit):
    """In-process packet source: replays a session in ``package_size``
    packets, stamped at publication like the ZMQ ingest."""

    SETTINGS: PacketReplaySettings
    OUTPUT = OutputStream(ClosedLoopMessage)

    @publisher(OUTPUT)
    async def process(self) -> AsyncGenerator:
        s = self.SETTINGS
        t0 = time.perf_counter()
        for n, k in enumerate(range(0, len(s.data) - s.package_size + 1,
                                    s.package_size)):
            if s.period is not None:
                await asyncio.sleep(max(0.0, t0 + n * s.period
                                        - time.perf_counter()))
            yield self.OUTPUT, ClosedLoopMessage(
                data=np.asarray(s.data[k:k + s.package_size], np.float64),
                fs=s.fs, received_at=time.time())
# endregion


# region Logging units
class LoggerSettings(Settings):
    filename: str
    overwrite: bool
    config_filename: Optional[str] = None


class BinaryLogger(Unit):
    """Append each message's raw ``data.tobytes()`` to a binary log."""

    SETTINGS: LoggerSettings
    INPUT = InputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        filename = os.path.abspath(self.SETTINGS.filename)
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        if os.path.isfile(filename) and not self.SETTINGS.overwrite:
            raise PermissionError(f"{filename} exists and overwrite is "
                                  f"disabled.")
        self._fd = open(filename, mode="wb")

    def shutdown(self) -> None:
        self._fd.flush()
        self._fd.close()

    @subscriber(INPUT)
    async def write(self, message: TimeSeriesMessage) -> None:
        self._fd.write(np.asarray(message.data).tobytes())


class VoiceActivityDetectionLogger(Unit):
    """``.lab`` rows ``start<TAB>stop<TAB>"N frames"`` per segment."""

    SETTINGS: LoggerSettings
    INPUT = InputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        filename = os.path.abspath(self.SETTINGS.filename)
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        if os.path.isfile(filename) and not self.SETTINGS.overwrite:
            raise PermissionError(f"{filename} exists and overwrite is "
                                  f"disabled.")
        self._fd = open(filename, mode="w")

    def shutdown(self) -> None:
        self._fd.flush()
        self._fd.close()

    @subscriber(INPUT)
    async def write(self, message: ClosedLoopMessage) -> None:
        start = message.previous_frames * 0.01
        stop = (message.previous_frames + len(message.data)) * 0.01
        self._fd.write(f"{start:.02f}\t{stop:.02f}\t"
                       f"{len(message.data)} frames\n")


class DelayedWavLoggerSettings(Settings):
    base_path: Path
    overwrite: bool
    prefix: Optional[str] = None


class DelayedWavLogger(Unit):
    """Save each synthesized segment as ``{prefix}_{counter:05d}.wav``."""

    SETTINGS: DelayedWavLoggerSettings
    INPUT = InputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        os.makedirs(self.SETTINGS.base_path, exist_ok=True)
        self._counter = 1

    @subscriber(INPUT)
    async def write(self, message: TimeSeriesMessage) -> None:
        prefix = self.SETTINGS.prefix or ""
        filename = os.path.join(Path(self.SETTINGS.base_path).as_posix(),
                                f"{prefix}_{self._counter:05d}.wav")
        self._counter += 1
        if not (os.path.isfile(filename) and not self.SETTINGS.overwrite):
            _wavwrite(filename, 16000, np.asarray(message.data))
# endregion


def _load_lstm(arch, params: Optional[dict], weights: Optional[Path],
               bidirectional: bool, head_name: str, device) -> torch.nn.Module:
    model = arch(**(params or {}))
    if weights is not None:
        model.load_state_dict(load_checkpoint(
            Path(weights).as_posix(), model.nb_layer,
            bidirectional=bidirectional, head_name=head_name))
    else:
        seeded_init(model, 0)
    return model.to(device).eval()


@torch.no_grad()
def _decode_padded(model, data: np.ndarray, T: int, mult: int, device):
    """Decode the first T frames of ``data`` [>= T, E] in one model call on
    those frames alone.  Returns (pred [1, T, F] of the valid frames, feats
    [1, Tp, F], Tp the next multiple of ``mult``, whose tail repeats the
    last valid frame, so that a vocoder never consumes padding).  The span
    counts ``kernel`` = 1 where the call is one launch of kernel D3."""
    Tp = -(-T // mult) * mult
    with tracing.span("models.decode", frames=T, padded_frames=Tp,
                      kernel=int(model.takes_kernel(device))):
        x = torch.as_tensor(np.asarray(data[:T], np.float32))[None]
        feats, _ = model(x.to(device), lengths=[T], frames=Tp)
        return feats[:, :T], feats


# region Fused packet path
class FusedFrontendVadSettings(Settings):
    """Front end + nVAD in one device call per packet."""

    nb_features: int
    fs: int
    buffer_size: int
    context_frames: int = 0
    window_length: float = 0.05
    window_shift: float = 0.01
    pre_transforms: Transforms = None
    post_transforms: Transforms = None
    package_size: int = 40
    raw_channels: int = 129
    vad_architecture: Any = None
    vad_weights_path: Optional[Path] = None
    vad_parameters: Optional[dict] = None
    # Backlog-drain batch sizes (in packets), warmed at startup.
    coalesce_packets: Tuple[int, ...] = (2, 4, 8)
    device: Optional[str] = None  # None = cuda


class FusedFrontendVad(Unit):
    """Packet -> features -> VAD labels in one device call with one packed
    device->host read.  Publishes the feature stream on FEATURES (log.hga
    tap) and completed speech segments on OUTPUT.

    Backlog coalescing: the subscriber drains the packets already queued
    (graph.coalescing) and runs them as one call of 2, 4 or 8 packets —
    the filter, framer and VAD recurrences are streaming-equivalent over
    concatenation — so a slow call never builds an unbounded backlog."""

    SETTINGS: FusedFrontendVadSettings
    INPUT = InputStream(ClosedLoopMessage, maxsize=8)
    FEATURES = OutputStream(ClosedLoopMessage)
    OUTPUT = OutputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        s = self.SETTINGS
        self._device = resolve_device(s.device)
        self._extractor = HighGammaExtractor(
            fs=s.fs, nb_electrodes=s.nb_features,
            window_length=s.window_length, window_shift=s.window_shift,
            pre_transforms=s.pre_transforms, post_transforms=s.post_transforms,
            device=self._device)
        self._model = _load_lstm(s.vad_architecture, s.vad_parameters,
                                 s.vad_weights_path, False, "classifier",
                                 self._device)
        self._history = SpeechSegmentHistory(
            nb_features=s.nb_features, buffer_size=s.buffer_size,
            context=s.context_frames)
        self._smoothing = VoiceActivityDetectionSmoothing(
            nb_features=s.nb_features, context_frames=5)
        self._frame_counter = 0
        self._first = True
        self._fe_state = self._extractor.init_state()
        self._vad_state = self._model.create_new_initial_state(1)
        self.step_ms: List[float] = []  # wall time of each device call
        # Its own stream: packets must not queue behind a word's vocoder
        # chunks on the default stream (hundreds of ms per word).
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        # Warm every call size against throwaway states: torch runs
        # eagerly (nothing compiles), but the first call at a shape pays
        # cuDNN plan selection, allocator growth and the kernels' build.
        self._sizes = sorted({1, *(s.coalesce_packets or ())}, reverse=True)
        for n in self._sizes:
            dummy = torch.zeros((n * s.package_size, s.raw_channels),
                                device=self._device)
            self._packet_path(self._extractor.init_state(),
                              self._model.create_new_initial_state(1),
                              dummy)[2].cpu()
        self._executor = ThreadPoolExecutor(max_workers=1)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    @torch.no_grad()
    def _packet_path(self, fe_state, vad_state, packet: torch.Tensor):
        feats, fe_state = self._extractor.packet_step(fe_state, packet)
        logits, vad_state = self._model(feats[None], vad_state)
        labels = torch.argmax(logits, dim=-1)[0]
        # Features and labels leave the device in ONE read.
        packed = torch.cat([feats, labels[:, None].to(feats.dtype)], dim=1)
        return fe_state, vad_state, packed

    def _step(self, data: np.ndarray, key: Optional[float] = None,
              packets: int = 1):
        """One packet call over ``packets`` packets (``key``: the earliest
        one's ``received_at``)."""
        t0 = time.perf_counter()
        with tracing.span("units.fe_call", key=key, packets=packets), \
                torch.cuda.stream(self._stream):
            with tracing.span("units.fe_h2d"):
                packet = torch.as_tensor(np.asarray(data, np.float32)).to(
                    self._device)
            with tracing.span("units.fe_launch"):
                self._fe_state, self._vad_state, packed = self._packet_path(
                    self._fe_state, self._vad_state, packet)
            with tracing.span("units.fe_read"):
                packed = packed.cpu().numpy()  # the one device->host read
            self._t_device_done = time.time()
        self.step_ms.append((time.perf_counter() - t0) * 1000.0)
        return packed[:, :-1].astype(np.float64), packed[:, -1].astype(np.int32)

    @subscriber(INPUT)
    @publisher(FEATURES)
    @publisher(OUTPUT)
    @coalescing(8)
    async def process(self, msgs) -> AsyncGenerator:
        loop = asyncio.get_running_loop()
        i = 0
        while i < len(msgs):
            take = next(n for n in self._sizes if n <= len(msgs) - i)
            chunk = msgs[i:i + take]
            i += take
            # Stamps ride the EARLIEST packet of the chunk.
            msg = chunk[0]
            data = (msg.data if take == 1
                    else np.concatenate([m.data for m in chunk], axis=0))
            t_dispatch = time.time()
            feats, labels = await loop.run_in_executor(
                self._executor, self._step, data, msg.received_at, take)
            t_segment = tracing.now()
            if self._first:
                k = self._extractor.warmup_frames(data.shape[0])
                feats, labels = feats[k:], labels[k:]
                self._first = False

            yield self.FEATURES, replace(
                msg, data=feats, fs=1 / self.SETTINGS.window_shift)

            data, predictions = self._smoothing.insert(
                data=feats.astype(np.float32), speech_labels=labels)
            segments = self._history.insert(data=data,
                                            speech_labels=predictions)
            self._frame_counter += len(feats)
            for segment in segments:
                previous_frames = (
                    self._frame_counter - len(segment)
                    - (len(feats) - int(np.count_nonzero(predictions))))
                yield self.OUTPUT, _with_stamps(
                    msg, (("fe_dispatch", t_dispatch),
                          ("fe_device_done", self._t_device_done),
                          ("seg_close", time.time())),
                    data=segment, fs=100, previous_frames=previous_frames)
            tracing.record("units.fe_segment", t_segment, key=msg.received_at,
                           packets=take)
# endregion


# region Separate packet path
class HighGammaActivitySettings(Settings):
    fs: int
    nb_electrodes: int
    window_length: float = 0.05
    window_shift: float = 0.01
    l_freq: int = 70
    h_freq: int = 170
    pre_transforms: Transforms = None
    post_transforms: Transforms = None
    # Packets of exactly this many samples take the explicit-state packet
    # step (one front-end kernel launch each); others go through
    # ``extract_features``.
    package_size: Optional[int] = None
    # Channel count of incoming packets (128 ECoG + 1 audio in BCI2000
    # exports): with package_size it lets initialize() warm the packet step.
    raw_channels: Optional[int] = None
    device: Optional[str] = None  # None = cuda


class HighGammaActivity(Unit):
    """Packet -> high-gamma features (the front end of the separate chain).
    Features leave as float64: ``log.hga.f64`` is f64 by contract."""

    SETTINGS: HighGammaActivitySettings
    # Bounded: when this unit falls behind, backpressure reaches the ingest,
    # whose drop-old socket sheds stale packets.
    INPUT = InputStream(TimeSeriesMessage, maxsize=8)
    OUTPUT = OutputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        s = self.SETTINGS
        self._device = resolve_device(s.device)
        self._extractor = HighGammaExtractor(
            fs=s.fs, nb_electrodes=s.nb_electrodes,
            window_length=s.window_length, window_shift=s.window_shift,
            l_freq=s.l_freq, h_freq=s.h_freq, pre_transforms=s.pre_transforms,
            post_transforms=s.post_transforms, device=self._device)
        self._state = self._extractor.init_state()
        self._first = True
        self.step_ms: List[float] = []  # wall time of each packet step
        # Its own stream, as FusedFrontendVad: packets must not queue
        # behind a word's vocoder work on the default stream.
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        if s.package_size is not None and s.raw_channels is not None:
            # Nothing compiles, but the first call pays the kernels' build
            # and the allocator's growth: pay them now, on a throwaway state.
            with torch.no_grad(), torch.cuda.stream(self._stream):
                feats, _ = self._extractor.packet_step(
                    self._extractor.init_state(),
                    torch.zeros((s.package_size, s.raw_channels),
                                device=self._device))
                feats.cpu()
        self._executor = ThreadPoolExecutor(max_workers=1)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    def _packet_features(self, data: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.stream(self._stream):
            packet = torch.as_tensor(np.asarray(data, np.float32)).to(
                self._device)
            feats, self._state = self._extractor.packet_step(self._state,
                                                             packet)
            feats = feats.cpu().numpy()
        self.step_ms.append((time.perf_counter() - t0) * 1000.0)
        return feats

    def _block_features(self, data: np.ndarray) -> np.ndarray:
        with torch.no_grad(), torch.cuda.stream(self._stream):
            return self._extractor.extract_features(data)

    @subscriber(INPUT)
    @publisher(OUTPUT)
    async def process(self, msg: TimeSeriesMessage) -> AsyncGenerator:
        s = self.SETTINGS
        loop = asyncio.get_running_loop()
        # Device work off the event loop; one worker keeps the carried
        # filter state in order.
        if s.package_size is not None and msg.data.shape[0] == s.package_size:
            feats = await loop.run_in_executor(
                self._executor, self._packet_features, msg.data)
            if self._first:
                feats = feats[self._extractor.warmup_frames(s.package_size):]
                self._first = False
        else:
            feats = await loop.run_in_executor(
                self._executor, self._block_features, msg.data)
        yield self.OUTPUT, replace(msg, data=np.asarray(feats, np.float64),
                                   fs=1 / s.window_shift)


class FilterSpeechSegmentsSettings(Settings):
    nb_features: int
    fs: int
    vad_architecture: Any
    buffer_size: int
    context_frames: int = 0
    vad_weights_path: Optional[Path] = None
    vad_parameters: Optional[dict] = None
    device: Optional[str] = None  # None = cuda


class FilterSpeechSegments(Unit):
    """nVAD gate of the separate chain: LSTM inference per packet of
    features with carried (h, c) and the argmax on the device, label
    smoothing and segment assembly on the host; emits completed speech
    segments with ``previous_frames`` set for the .lab log."""

    SETTINGS: FilterSpeechSegmentsSettings
    INPUT = InputStream(ClosedLoopMessage, maxsize=8)
    OUTPUT = OutputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        s = self.SETTINGS
        self._device = resolve_device(s.device)
        self._history = SpeechSegmentHistory(
            nb_features=s.nb_features, buffer_size=s.buffer_size,
            context=s.context_frames)
        self._smoothing = VoiceActivityDetectionSmoothing(
            nb_features=s.nb_features, context_frames=5)
        self._model = _load_lstm(s.vad_architecture, s.vad_parameters,
                                 s.vad_weights_path, False, "classifier",
                                 self._device)
        self._state = self._model.create_new_initial_state(1)
        self._frame_counter = 0
        self.step_ms: List[float] = []  # wall time of each device call
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        # Warm both per-packet shapes (the warm-start first packet emits
        # fewer frames than the steady state) on throwaway states.
        with torch.no_grad(), torch.cuda.stream(self._stream):
            for frames in (1, 4):
                logits, _ = self._model(
                    torch.zeros((1, frames, s.nb_features),
                                device=self._device),
                    self._model.create_new_initial_state(1))
                torch.argmax(logits, dim=2).cpu()
        self._executor = ThreadPoolExecutor(max_workers=1)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    def _vad_labels(self, data: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.stream(self._stream):
            x = torch.as_tensor(np.asarray(data, np.float32)[None]).to(
                self._device)
            logits, self._state = self._model(x, self._state)
            labels = torch.argmax(logits, dim=2).cpu().numpy().ravel()
        self._t_device_done = time.time()
        self.step_ms.append((time.perf_counter() - t0) * 1000.0)
        return labels

    @subscriber(INPUT)
    @publisher(OUTPUT)
    async def process(self, msg: ClosedLoopMessage) -> AsyncGenerator:
        t_dispatch = time.time()
        predictions = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._vad_labels, msg.data)
        data, predictions = self._smoothing.insert(
            data=np.asarray(msg.data), speech_labels=predictions)
        segments = self._history.insert(data=data, speech_labels=predictions)
        self._frame_counter += len(msg.data)
        for segment in segments:
            previous_frames = (
                self._frame_counter - len(segment)
                - (len(msg.data) - int(np.count_nonzero(predictions))))
            yield self.OUTPUT, _with_stamps(
                msg, (("vad_dispatch", t_dispatch),
                      ("vad_device_done", self._t_device_done),
                      ("seg_close", time.time())),
                data=segment, fs=100, previous_frames=previous_frames)
# endregion


# region Fused word path
class FusedDecoderVocoderSettings(Settings):
    """Bidirectional decode + vocoder per word."""

    path_to_model_weights: Optional[str]
    model: Any
    params: Optional[dict]
    # "net": the neural vocoder (needs vocoder_weights), chunked emission;
    # "dsp": the source-filter vocoder (kernel D1), the whole word at once.
    vocoder_backend: str = "net"
    vocoder_weights: Optional[str] = None
    length_multiple: int = 50  # segment padding bucket (masked; exact)
    # Decoder segment lengths warmed at startup (2 * length_multiple too).
    prewarm_frames: Tuple[int, ...] = (50, 150, 200, 250, 300)
    # Ship the first 50-frame chunk of a word as soon as it is vocoded;
    # later chunks follow as each lands.  Needs length_multiple % 50 == 0
    # and the net backend.
    chunk_emission: bool = True
    # Online anti-crackle squelch (vocoder/net.py QUIET_C0).
    quiet_sharpen: bool = True
    device: Optional[str] = None  # None = cuda


class FusedDecoderVocoder(Unit):
    """Decode one completed speech segment and vocode it.  The decoder's
    state is fresh per segment; the vocoder's carries across segments,
    through the repeat-padded tail of each bucket as well.  Publishes
    decoded features on LPC (log.lpc tap), int16 audio chunks in order on
    OUTPUT, and the whole word on WORD (wav tap).

    Equivalent to RecurrentNeuralDecodingModel + DelayedLPCNetVocoder in
    series at the same padding bucket.  With the dsp backend the word's
    features and audio leave the device in one read (the JAX unit reads
    the features back and vocodes from the host: two)."""

    SETTINGS: FusedDecoderVocoderSettings
    INPUT = InputStream(TimeSeriesMessage)
    LPC = OutputStream(TimeSeriesMessage)
    OUTPUT = OutputStream(TimeSeriesMessage)
    WORD = OutputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        s = self.SETTINGS
        if s.vocoder_backend not in ("dsp", "net"):
            raise ValueError(f"Unknown vocoder backend: {s.vocoder_backend}")
        self._dsp = s.vocoder_backend == "dsp"
        if not self._dsp and s.vocoder_weights is None:
            raise ValueError("FusedDecoderVocoder needs vocoder_weights")
        self._device = resolve_device(s.device)
        self._model = _load_lstm(s.model, s.params, s.path_to_model_weights,
                                 True, "regressor", self._device)
        if not self._dsp:
            self._voc_params = _load_params(s.vocoder_weights, self._device)
            self._voc_model = LPCNetModel.from_params(self._voc_params)
            self._sampler_w = sampler_weights_for(self._voc_model,
                                                  self._voc_params)
            _pattern, kept = _sparse_pattern_of(self._voc_params)
            logger.info(f"vocoder bunch {self._voc_model.bunch}; GRU-A mask "
                        f"keeps {kept:.1%} of [16 x 128] tiles (the sampler "
                        f"kernel reads only those)")
        self._voc_state = self._fresh_vocoder_state()
        self._chunk = COND_BLOCK
        self._chunked = not self._dsp and bool(s.chunk_emission) \
            and s.length_multiple % COND_BLOCK == 0
        self.word_ms: List[float] = []  # segment in -> first audio read
        # Warm the decoder once, at the largest bucket (on the card: the
        # kernel's first launch and its scratch at the largest size), on
        # throwaway state.
        electrodes = self._model.nb_electrodes
        buckets = sorted({2 * s.length_multiple, *(s.prewarm_frames or ())})
        self._padded_features(np.zeros((buckets[-1], electrodes), np.float32),
                              buckets[-1] - 1)
        # The vocoder: net on one block (every chunk has the same 50-frame
        # shape); dsp at every bucket (the frame-rate part's inverse FFT
        # has a cuFFT plan per frame count), as the JAX unit warms it.
        for n in (buckets if self._dsp else (self._chunk,)):
            self._vocode(self._fresh_vocoder_state(),
                         torch.zeros((1, n, 20), device=self._device)
                         )[0].cpu()
        self._executor = ThreadPoolExecutor(max_workers=1)

    def _fresh_vocoder_state(self):
        if self._dsp:  # LPCNet(backend="dsp", seed=0)'s stream
            return dsp_vocoder_init(0, 1, self._device)
        return net_vocoder_init(self._voc_model, batch=1, device=self._device)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    def _padded_features(self, data: np.ndarray, T: int):
        return _decode_padded(self._model, data, T,
                              self.SETTINGS.length_multiple, self._device)

    def _vocode(self, state, feats):
        """Vocoder on feats [1, n, 20] -> (int16 PCM as packed f32 pairs,
        new state); the clip -> truncate conversion of the reference's
        int16 sink."""
        if self._dsp:
            pcm, state = dsp_synthesize_frames(state, feats)
        else:
            pcm, state = net_synthesize_frames(
                self._voc_model, self._voc_params, state, feats,
                quiet_sharpen=self.SETTINGS.quiet_sharpen,
                sampler_weights=self._sampler_w)
        pcm16 = torch.clamp(pcm.reshape(-1) * 32767.0, -32768, 32767
                            ).to(torch.int16)
        return pcm16.view(torch.float32), state

    def _split(self, packed: np.ndarray, T: int):
        n = T * self._model.nb_outputs
        return (packed[:n].reshape(T, self._model.nb_outputs),
                packed[n:].view(np.int16))

    def _decode_and_vocode(self, data: np.ndarray,
                           key: Optional[float] = None):
        """Single shot: decode and vocode the whole word, one read
        (``key``: the word's id)."""
        t0 = time.perf_counter()
        T = len(data)
        with tracing.span("units.word_head", key=key, frames=T):
            pred, feats = self._padded_features(data, T)
            bits, self._voc_state = self._vocode(self._voc_state, feats)
            with tracing.span("units.word_read"):
                packed = torch.cat([pred.reshape(-1), bits]).cpu().numpy()
            self._t_device_done = time.time()
        self.word_ms.append((time.perf_counter() - t0) * 1000.0)
        lpc, audio = self._split(packed, T)
        return lpc, audio[: T * FRAME_SIZE]

    def _decode_head(self, data: np.ndarray, key: Optional[float] = None):
        """Chunked word start: decode, vocode the first chunk, and read
        back features + that chunk's audio — the one read on the
        first-audio critical path.  Returns the padded features for the
        tail chunks (``key``: the word's id)."""
        t0 = time.perf_counter()
        T = len(data)
        with tracing.span("units.word_head", key=key, frames=T):
            pred, feats = self._padded_features(data, T)
            bits, self._voc_state = self._vocode(self._voc_state,
                                                 feats[:, :self._chunk])
            with tracing.span("units.word_read"):
                packed = torch.cat([pred.reshape(-1), bits]).cpu().numpy()
            self._t_device_done = time.time()
        self.word_ms.append((time.perf_counter() - t0) * 1000.0)
        lpc, audio0 = self._split(packed, T)
        return lpc, audio0[: min(T, self._chunk) * FRAME_SIZE], feats, T

    def _tail_chunk(self, feats: torch.Tensor, k: int, T: int,
                    key: Optional[float] = None) -> np.ndarray:
        """Vocode and read tail chunk ``k``, trimmed to the word's valid
        frames and clamped at zero: a chunk wholly inside the repeat-pad
        is synthesized for state continuity but ships nothing.

        Tails run when they are read, not all queued behind the head: a
        chunk is some 120 small launches, and queueing a word's tails
        fills the CUDA launch queue, which blocks the host — and the head's
        read — until the card has drained most of them."""
        c = self._chunk
        with tracing.span("units.word_tail", key=key, chunk=k):
            bits, self._voc_state = self._vocode(
                self._voc_state, feats[:, k * c:(k + 1) * c])
            valid = max(0, min(T - k * c, c))
            return bits.cpu().numpy().view(np.int16)[: valid * FRAME_SIZE]

    @subscriber(INPUT)
    @publisher(LPC)
    @publisher(OUTPUT)
    @publisher(WORD)
    async def decode(self, msg: TimeSeriesMessage) -> AsyncGenerator:
        loop = asyncio.get_running_loop()
        data = np.asarray(msg.data, np.float32)
        word = getattr(msg, "previous_frames", None)
        t_dispatch = time.time()
        if not self._chunked:
            lpc, audio = await loop.run_in_executor(
                self._executor, self._decode_and_vocode, data, word)
            stamps = (("dv_dispatch", t_dispatch),
                      ("dv_device_done", self._t_device_done))
            yield self.LPC, replace(msg, data=lpc, fs=100)
            yield self.OUTPUT, _with_stamps(msg, stamps, data=audio,
                                            fs=16000)
            yield self.WORD, _anonymize(msg, data=audio, fs=16000)
            return

        lpc, audio0, feats, T = await loop.run_in_executor(
            self._executor, self._decode_head, data, word)
        n_chunks = feats.shape[1] // self._chunk
        stamps = (("dv_dispatch", t_dispatch),
                  ("dv_device_done", self._t_device_done))
        yield self.LPC, replace(msg, data=lpc, fs=100)
        # The first chunk carries the word's latency stamps.
        yield self.OUTPUT, _with_stamps(msg, stamps, data=audio0, fs=16000)
        parts = [audio0]
        for i in range(1, n_chunks):
            audio_k = await loop.run_in_executor(
                self._executor, self._tail_chunk, feats, i, T, word)
            parts.append(audio_k)
            if len(audio_k) == 0 and i != n_chunks - 1:
                continue  # all-pad chunk: nothing to ship
            if i == n_chunks - 1:
                out = _with_stamps(msg, (("dv_dispatch", t_dispatch),
                                         ("dv_word_complete", time.time())),
                                   data=audio_k, fs=16000)
            else:
                out = _anonymize(msg, data=audio_k, fs=16000)
            yield self.OUTPUT, out
        audio = np.concatenate(parts) if len(parts) > 1 else audio0
        yield self.WORD, _anonymize(msg, data=audio, fs=16000)
# endregion


# region Sharded word path
_STOP, _WORD, _TAIL = 0, 1, 2  # the messages rank 0 sends its workers


class ShardedFusedDecoderVocoderSettings(Settings):
    """The word path for many streams (see the unit)."""

    path_to_model_weights: Optional[str]
    model: Any
    params: Optional[dict]
    vocoder_weights: Optional[str] = None  # None: a vocoder seeded with 0
    length_multiple: int = 50  # segment padding bucket (masked; exact)
    # Decoder segment lengths warmed at startup (2 * length_multiple too).
    prewarm_frames: Tuple[int, ...] = ()
    # Ranks of the process group to serve on (0 = all of them) and the
    # serve batch (0 = one slot a rank; a multiple of the ranks).
    n_devices: int = 0
    streams: int = 0
    # Segments for the slots other than the live one: a callable
    # ``(n_background_slots, live_frames) -> iterable of [T_i, ch]``
    # float32 arrays, each slot with its own length.  None replays the live
    # segment into every slot.
    slot_feeder: Optional[Any] = None
    # 50-frame head and tail chunks, as FusedDecoderVocoder (single-shot
    # when length_multiple is no multiple of 50).
    chunk_emission: bool = True
    quiet_sharpen: bool = True
    device: Optional[str] = None  # None = cuda


class ShardedFusedDecoderVocoder(Unit):
    """The word path for many streams: each segment decodes and vocodes as
    slot 0 of a serve batch, the live closed-loop stream (its LPC is
    logged, its audio published); ``slot_feeder`` gives the other slots
    segments of their own, and their audio of the last word is in
    ``slot_audio``.  The surface is FusedDecoderVocoder's (INPUT, LPC,
    OUTPUT, WORD), so the app's wiring takes it unchanged.

    The slots split over the ranks of the process group, a contiguous block
    a rank (parallel/shard.py's layout, on a mesh of "data" = the ranks):
    a rank decodes its slots in one batched decoder call with their host
    lengths (kernel D3 on the card), each slot's last valid frame held over
    its padding, and vocodes them through the sampler kernel at B = its
    slots, with the vocoder state of its streams (noise keyed by global
    slot).  At world 1 every slot runs here, with no collective.  At
    world > 1 rank 0 runs the graph and the other ranks ``run_worker``:
    rank 0 broadcasts each padded batch and each tail chunk's frames and
    gathers the ranks' packed int16 audio; a stop message ends their loop
    at ``shutdown``.  On rank 0 the
    unit's one-worker executor is the only thread that issues collectives.
    """

    SETTINGS: ShardedFusedDecoderVocoderSettings
    INPUT = InputStream(TimeSeriesMessage)
    LPC = OutputStream(TimeSeriesMessage)
    OUTPUT = OutputStream(TimeSeriesMessage)
    WORD = OutputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        from ..parallel import make_mesh
        from ..parallel.mesh import axis, mesh_device

        s = self.SETTINGS
        mesh = make_mesh(s.n_devices or None, model_parallel=1,
                         device=resolve_device(s.device))
        self._device = mesh_device(mesh)  # this rank's card, by index
        self._world, coord, self._group = axis(mesh, "data")
        self._rank = coord
        self._root = dist.get_global_rank(self._group, 0)
        streams = s.streams or self._world
        if streams % self._world:
            raise ValueError(f"streams={streams} must be a multiple of the "
                             f"{self._world} ranks")
        self._streams = streams
        n = streams // self._world
        self._slots = slice(coord * n, (coord + 1) * n)
        self._model = _load_lstm(s.model, s.params, s.path_to_model_weights,
                                 True, "regressor", self._device)
        if s.vocoder_weights is not None:
            self._voc_params = _load_params(s.vocoder_weights, self._device)
            self._voc_model = LPCNetModel.from_params(self._voc_params)
        else:
            self._voc_model = LPCNetModel()
            self._voc_params = self._voc_model.init(
                torch.Generator().manual_seed(0), self._device)
        self._sampler_w = sampler_weights_for(self._voc_model,
                                              self._voc_params)
        self._voc_state = self._fresh_vocoder_state()
        self._chunk = COND_BLOCK
        self._chunked = bool(s.chunk_emission) \
            and s.length_multiple % COND_BLOCK == 0
        self._header = torch.zeros(3 + streams, dtype=torch.long,
                                   device=self._device)
        self.slot_audio: dict = {}  # slot 1.. -> int16 audio of the last word
        self.word_ms: List[float] = []  # segment in -> first audio read
        if self._device.type == "cuda":
            # Warm the decoder once at the largest bucket (the kernel's first
            # launch and its scratch at the largest size) and the vocoder on
            # one chunk (the sampler's weight layout), on throwaway state.
            E = self._model.nb_electrodes
            T = max((2 * s.length_multiple, *(s.prewarm_frames or ())))
            self._decode(torch.zeros((n, T, E), device=self._device),
                         np.full(n, max(T - 1, 1)))
            with torch.no_grad():
                net_synthesize_frames(
                    self._voc_model, self._voc_params,
                    self._fresh_vocoder_state(),
                    torch.zeros((n, self._chunk, 20), device=self._device),
                    sampler_weights=self._sampler_w)[0].cpu()
        self._executor = ThreadPoolExecutor(
            max_workers=1, **(dict(initializer=torch.cuda.set_device,
                                   initargs=(self._device,))
                              if self._device.type == "cuda" else {}))

    def _fresh_vocoder_state(self):
        n = self._slots.stop - self._slots.start
        return net_vocoder_init(self._voc_model, batch=n,
                                device=self._device)._replace(
            slot_lo=self._slots.start, slots=self._streams)

    def shutdown(self) -> None:
        if self._world > 1 and self._rank == 0:
            self._executor.submit(self._tell, _STOP, 0, 0,
                                  [0] * self._streams).result()
        self._executor.shutdown(wait=True)

    # -- every rank's part --------------------------------------------------
    @torch.no_grad()
    def _decode(self, x: torch.Tensor, lengths: np.ndarray) -> torch.Tensor:
        """Features [n, T, F] of x [n, T, E], each slot's frames past its
        length holding its last valid frame."""
        pred, _ = self._model(x, lengths=lengths, frames=x.shape[1])
        return pred

    @torch.no_grad()
    def _vocode(self, feats: torch.Tensor) -> torch.Tensor:
        """This rank's slots of feats [n, L, 20] -> their int16 PCM as
        packed f32 pairs [n, L * 80]; the vocoder state advances."""
        pcm, self._voc_state = net_synthesize_frames(
            self._voc_model, self._voc_params, self._voc_state, feats,
            quiet_sharpen=self.SETTINGS.quiet_sharpen,
            sampler_weights=self._sampler_w)
        return torch.clamp(pcm * 32767.0, -32768, 32767).to(
            torch.int16).view(torch.float32)

    def _local(self, cmd: int, arg: int, flag: int, lengths: np.ndarray,
               x: Optional[torch.Tensor]):
        """(this rank's decoded features or None, its slots' packed audio)
        for one message: a word (x [streams, Tp, E], ``flag``: the head
        chunk only) or the tail chunk of frames ``arg ..``."""
        if cmd == _WORD:
            pred = self._feats = self._decode(x[self._slots],
                                              lengths[self._slots])
            n = self._chunk if flag else arg
            return pred, self._vocode(self._feats[:, :n])
        return None, self._vocode(self._feats[:, arg:arg + self._chunk])

    def _tell(self, cmd: int, arg: int, flag: int, lengths) -> None:
        if self._world > 1:
            self._header.copy_(torch.as_tensor([cmd, arg, flag, *lengths]))
            dist.broadcast(self._header, self._root, group=self._group)

    def _gather(self, bits: torch.Tensor) -> Optional[torch.Tensor]:
        if self._world == 1:
            return bits
        parts = ([torch.empty_like(bits) for _ in range(self._world)]
                 if self._rank == 0 else None)
        dist.gather(bits, parts, dst=self._root, group=self._group)
        return torch.cat(parts) if parts is not None else None

    def run_worker(self) -> None:
        """A rank > 0's loop: run its slots of each word and tail chunk
        rank 0 sends, until the stop message."""
        if self._rank == 0:
            raise RuntimeError("rank 0 runs the graph, not a worker loop")
        E = self._model.nb_electrodes
        while True:
            dist.broadcast(self._header, self._root, group=self._group)
            cmd, arg, flag, *lengths = self._header.tolist()
            if cmd == _STOP:
                return
            x = None
            if cmd == _WORD:
                x = torch.empty((self._streams, arg, E), device=self._device)
                dist.broadcast(x, self._root, group=self._group)
            self._gather(self._local(cmd, arg, flag, np.asarray(lengths),
                                     x)[1])

    # -- rank 0 -------------------------------------------------------------
    def _run(self, cmd: int, arg: int, flag: int, Ts: List[int],
             x: Optional[np.ndarray] = None):
        """Rank 0: send the message, run its own slots, gather every slot's
        audio -> (rank 0's decoded features or None, audio [streams, n])."""
        self._tell(cmd, arg, flag, Ts)
        xd = None
        if x is not None:
            xd = torch.as_tensor(x).to(self._device)
            if self._world > 1:
                dist.broadcast(xd, self._root, group=self._group)
        pred, bits = self._local(cmd, arg, flag, np.asarray(Ts), xd)
        return pred, self._gather(bits)

    def _read(self, pred: Optional[torch.Tensor], bits: torch.Tensor,
              T0: int):
        """One device->host read: (slot 0's valid features or None, every
        slot's packed audio)."""
        F = self._model.nb_outputs
        parts = [bits.reshape(-1)] if pred is None else \
            [pred[0, :T0].reshape(-1), bits.reshape(-1)]
        packed = torch.cat(parts).cpu().numpy()
        if pred is None:
            return None, packed
        return packed[:T0 * F].reshape(T0, F), packed[T0 * F:]

    def _batch_slots(self, data: np.ndarray):
        """Per-slot segments -> (lengths, padded length, x [streams, Tp, E],
        mask [streams, Tp]).  Slot 0 carries the live stream; the others
        come from ``slot_feeder`` (distinct streams with their own lengths)
        or replay the live segment."""
        feeder = self.SETTINGS.slot_feeder
        if feeder is None:
            segs = [data] * self._streams
        else:
            segs = [data] + [np.asarray(b, np.float32)
                             for b in feeder(self._streams - 1, len(data))]
            if len(segs) != self._streams:
                raise ValueError(
                    f"slot_feeder yielded {len(segs) - 1} segments for "
                    f"{self._streams - 1} background slots")
        Ts = [len(seg) for seg in segs]
        mult = self.SETTINGS.length_multiple
        Tp = -(-max(Ts) // mult) * mult
        x = np.zeros((self._streams, Tp, data.shape[1]), np.float32)
        mask = np.zeros((self._streams, Tp), np.float32)
        for i, seg in enumerate(segs):
            x[i, :Ts[i]] = seg
            mask[i, :Ts[i]] = 1.0
        return Ts, Tp, x, mask

    @staticmethod
    def _unpack_slots(bits, Ts, lo_frame: int, chunk_frames: int):
        """int16 audio per slot from the packed readback, each trimmed to
        its own word length (clamped: an all-pad chunk ships nothing)."""
        pcm = np.asarray(bits).view(np.int16).reshape(len(Ts), -1)
        out = []
        for i, T in enumerate(Ts):
            valid = max(0, min(T - lo_frame, chunk_frames))
            out.append(pcm[i, : valid * FRAME_SIZE])
        return out

    def _decode_and_vocode(self, data: np.ndarray):
        """Single shot: every slot's whole word, one read."""
        t0 = time.perf_counter()
        Ts, Tp, x, _mask = self._batch_slots(data)
        lpc, bits = self._read(*self._run(_WORD, Tp, 0, Ts, x), Ts[0])
        slots = self._unpack_slots(bits, Ts, 0, Tp)
        self.slot_audio = {i: a for i, a in enumerate(slots) if i > 0}
        self._t_device_done = time.time()
        self.word_ms.append((time.perf_counter() - t0) * 1000.0)
        return lpc, slots[0]

    def _decode_head(self, data: np.ndarray):
        """Chunked word start: decode every slot and vocode its first
        chunk, one read.  Returns (slot 0's features, its first chunk, the
        tail chunks' frames still to vocode, the slots' lengths)."""
        t0 = time.perf_counter()
        Ts, Tp, x, _mask = self._batch_slots(data)
        lpc, bits = self._read(*self._run(_WORD, Tp, 1, Ts, x), Ts[0])
        slots = self._unpack_slots(bits, Ts, 0, self._chunk)
        self._bg_parts = {i: [a] for i, a in enumerate(slots) if i > 0}
        c = self._chunk
        pending = [slice(k * c, (k + 1) * c) for k in range(1, Tp // c)]
        self._t_device_done = time.time()
        self.word_ms.append((time.perf_counter() - t0) * 1000.0)
        return lpc, slots[0], pending, Ts

    def _read_chunk(self, frames: slice, k: int, Ts) -> np.ndarray:
        """Vocode and read tail chunk ``k`` (``frames``, an entry of the
        head's pending list) of every slot; returns slot 0's.  Tails run
        when they are read, as in FusedDecoderVocoder."""
        _, bits = self._read(*self._run(_TAIL, frames.start, 0, Ts), 0)
        slots = self._unpack_slots(bits, Ts, k * self._chunk, self._chunk)
        for i, a in enumerate(slots):
            if i > 0 and len(a):
                self._bg_parts[i].append(a)
        return slots[0]

    @subscriber(INPUT)
    @publisher(LPC)
    @publisher(OUTPUT)
    @publisher(WORD)
    async def decode(self, msg: TimeSeriesMessage) -> AsyncGenerator:
        loop = asyncio.get_running_loop()
        data = np.asarray(msg.data, np.float32)
        t_dispatch = time.time()
        if not self._chunked:
            lpc, audio = await loop.run_in_executor(
                self._executor, self._decode_and_vocode, data)
            stamps = (("dv_dispatch", t_dispatch),
                      ("dv_device_done", self._t_device_done))
            yield self.LPC, replace(msg, data=lpc, fs=100)
            yield self.OUTPUT, _with_stamps(msg, stamps, data=audio,
                                            fs=16000)
            yield self.WORD, _anonymize(msg, data=audio, fs=16000)
            return

        lpc, audio0, pending, Ts = await loop.run_in_executor(
            self._executor, self._decode_head, data)
        stamps = (("dv_dispatch", t_dispatch),
                  ("dv_device_done", self._t_device_done))
        yield self.LPC, replace(msg, data=lpc, fs=100)
        yield self.OUTPUT, _with_stamps(msg, stamps, data=audio0, fs=16000)
        parts = [audio0]
        for k, frames in enumerate(pending, start=1):
            audio_k = await loop.run_in_executor(
                self._executor, self._read_chunk, frames, k, Ts)
            parts.append(audio_k)
            if len(audio_k) == 0 and k != len(pending):
                continue  # all-pad chunk: nothing to ship
            if k == len(pending):
                out = _with_stamps(msg, (("dv_dispatch", t_dispatch),
                                         ("dv_word_complete", time.time())),
                                   data=audio_k, fs=16000)
            else:
                out = _anonymize(msg, data=audio_k, fs=16000)
            yield self.OUTPUT, out
        word = np.concatenate(parts) if len(parts) > 1 else audio0
        self.slot_audio = {i: np.concatenate(p) for i, p in
                           self._bg_parts.items()}
        yield self.WORD, _anonymize(msg, data=word, fs=16000)
# endregion


# region Separate word path
class RecurrentNeuralDecodingModelSettings(Settings):
    path_to_model_weights: Optional[str]
    model: Any
    params: Optional[dict]
    length_multiple: int = 50  # segment padding bucket (masked; exact)
    # Segment lengths warmed at startup (2 * length_multiple too).
    prewarm_frames: Tuple[int, ...] = (50, 150, 200, 250, 300)
    device: Optional[str] = None  # None = cuda


class RecurrentNeuralDecodingModel(Unit):
    """Decode one complete speech segment per message into float32
    acoustic features; the state is fresh per segment (reference
    local/units.py:507)."""

    SETTINGS: RecurrentNeuralDecodingModelSettings
    INPUT = InputStream(TimeSeriesMessage)
    OUTPUT = OutputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        s = self.SETTINGS
        self._device = resolve_device(s.device)
        self._model = _load_lstm(s.model, s.params, s.path_to_model_weights,
                                 True, "regressor", self._device)
        self.decode_ms: List[float] = []  # wall time of each segment
        # Warm once, at the largest bucket (on the card: the kernel's first
        # launch and its scratch at the largest size).
        electrodes = self._model.nb_electrodes
        n = max((2 * s.length_multiple, *(s.prewarm_frames or ())))
        _decode_padded(self._model, np.zeros((n, electrodes), np.float32),
                       n - 1, s.length_multiple, self._device)
        self._executor = ThreadPoolExecutor(max_workers=1)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    def _decode(self, data: np.ndarray,
                key: Optional[float] = None) -> np.ndarray:
        t0 = time.perf_counter()
        with tracing.span("units.decode", key=key, frames=len(data)):
            pred, _ = _decode_padded(self._model, data, len(data),
                                     self.SETTINGS.length_multiple,
                                     self._device)
            out = pred[0].cpu().numpy()
        self.decode_ms.append((time.perf_counter() - t0) * 1000.0)
        return out

    @subscriber(INPUT)
    @publisher(OUTPUT)
    async def decode(self, msg: TimeSeriesMessage) -> AsyncGenerator:
        t_dispatch = time.time()
        # Off the event loop; one worker keeps segments in order.
        predictions = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._decode, np.asarray(msg.data, np.float32),
            getattr(msg, "previous_frames", None))
        yield self.OUTPUT, _with_stamps(
            msg, (("dec_dispatch", t_dispatch),
                  ("dec_device_done", time.time())),
            data=predictions, fs=100)


class DelayedLPCNetVocoderSettings(Settings):
    backend: str = "dsp"
    weights: Optional[str] = None
    length_multiple: int = 10  # frame-count bucket, repeat-padded
    # Frame counts synthesized at startup on a throwaway state (net only,
    # as the JAX unit).
    prewarm_frames: Tuple[int, ...] = (100, 200, 300)
    device: Optional[str] = None  # None = cuda


class DelayedLPCNetVocoder(Unit):
    """Synthesize a whole decoded segment in one vocoder call.  The frames
    are repeat-padded to the bucket and the audio trimmed; the vocoder
    state carries across words, padded frames included, as in JAX."""

    SETTINGS: Optional[DelayedLPCNetVocoderSettings]
    INPUT = InputStream(TimeSeriesMessage)
    OUTPUT = OutputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        s = self.SETTINGS or DelayedLPCNetVocoderSettings()
        self._length_multiple = s.length_multiple
        self._lpcnet = LPCNet(backend=s.backend, weights=s.weights,
                              device=s.device)
        self.vocode_ms: List[float] = []  # wall time of each word
        if s.backend != "dsp":
            for n in s.prewarm_frames or ():
                self._lpcnet.warm(n)
        self._executor = ThreadPoolExecutor(max_workers=1)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)
        del self._lpcnet

    def _synthesize(self, features: np.ndarray, T: int,
                    key: Optional[float] = None) -> np.ndarray:
        t0 = time.perf_counter()
        with tracing.span("units.vocode", key=key, frames=T):
            pcm = self._lpcnet.synthesize_frames(features)[: T * FRAME_SIZE]
        self.vocode_ms.append((time.perf_counter() - t0) * 1000.0)
        return pcm

    @subscriber(INPUT)
    @publisher(OUTPUT)
    async def synthesize(self, msg: TimeSeriesMessage) -> AsyncGenerator:
        features = np.asarray(msg.data, np.float32)
        T = len(features)
        mult = self._length_multiple
        Tp = -(-T // mult) * mult
        if Tp != T:
            features = np.concatenate(
                [features, np.repeat(features[-1:], Tp - T, axis=0)], axis=0)
        t_dispatch = time.time()
        acoustic = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._synthesize, features, T,
            getattr(msg, "previous_frames", None))
        yield self.OUTPUT, _with_stamps(
            msg, (("voc_dispatch", t_dispatch),
                  ("voc_device_done", time.time())),
            data=acoustic, fs=16000)
# endregion


# region Output unit
class SoXOutputSettings(Settings):
    """Latency-budget reporting of the audio sink.

    ``budget_path``: where the per-stage p50/p95 budget is written as JSON
    at shutdown.  ``stall_threshold_ms``: a word whose total exceeds it is
    counted as a stall.  (The JAX sink also attributes a tunneled device's
    round-trip floor, ``rpc_floor_ms``; a locally attached card has no
    tunnel, and the port leaves it out.)"""

    budget_path: Optional[str] = None
    stall_threshold_ms: float = 1000.0


class DelayedStdoutForSoX(Unit):
    """Write int16 PCM to stdout for ``play -t raw -r 16000 ...``.

    Also the closed loop's latency probe: each word's ``received_at``
    (set at ingest) gives its ingest->audio time, and the stages' stamps
    along the path split it into a budget, aggregated as p50/p95 at
    shutdown (logged, ``self.budget``, and ``budget_path``)."""

    SETTINGS: Optional[SoXOutputSettings]
    INPUT = InputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        self.latencies_ms: List[float] = []
        self.completions_ms: List[float] = []
        self.budget: Optional[dict] = None
        self._budget_rows: List[dict] = []

    @subscriber(INPUT)
    async def print(self, msg: ClosedLoopMessage) -> None:
        sys.stdout.buffer.write(np.asarray(msg.data).tobytes())
        sys.stdout.flush()
        if getattr(msg, "received_at", None) is None:
            return  # interior audio chunk of a word
        now = time.time()
        latency_ms = (now - msg.received_at) * 1000.0
        stamps = tuple(getattr(msg, "stamps", ()) or ())
        if any(name == "dv_word_complete" for name, _ in stamps):
            # Last chunk of a chunked word: a completion, not a new word.
            self.completions_ms.append(latency_ms)
            logger.info(f"word complete: ingest->last_audio "
                        f"{latency_ms:.1f} ms")
            return
        self.latencies_ms.append(latency_ms)
        logger.info(f"segment audio out: {len(msg.data)} samples, "
                    f"ingest->audio {latency_ms:.1f} ms")
        if stamps:
            row, prev_name, prev_t = {}, "ingest", msg.received_at
            for name, t in stamps + (("audio_out", now),):
                row[f"{prev_name}->{name}"] = (t - prev_t) * 1000.0
                prev_name, prev_t = name, t
            row["total"] = latency_ms
            self._budget_rows.append(row)

    def shutdown(self) -> None:
        if self.latencies_ms:
            logger.info(f"ingest->audio latency over {len(self.latencies_ms)}"
                        f" segments: p50 "
                        f"{float(np.percentile(self.latencies_ms, 50)):.1f} ms")
        if not self._budget_rows:
            return
        s = self.SETTINGS or SoXOutputSettings()
        rows = self._budget_rows
        stall_ms = float(s.stall_threshold_ms)
        stalls = [r for r in rows if r["total"] > stall_ms]
        # Stage keys in path order from the first row (a run's wiring is
        # the same for every word).
        keys = [k for k in rows[0] if k != "total"]
        table = {}
        for k in keys + ["total"]:
            vals = [r[k] for r in rows if k in r]
            table[k] = {"p50": float(np.percentile(vals, 50)),
                        "p95": float(np.percentile(vals, 95)),
                        "n": len(vals)}
        lines = [f"latency budget over {len(rows)} words (ms, p50/p95):"]
        lines += [f"  {k:<32s} {table[k]['p50']:7.1f} / "
                  f"{table[k]['p95']:7.1f}" for k in keys + ["total"]]
        n_rpc = sum(1 for k in keys if k.endswith("_device_done"))
        report = {"n_words": len(rows), "stages": table,
                  "device_round_trips_per_word": n_rpc,
                  "stall_threshold_ms": stall_ms,
                  "stall_count": len(stalls)}
        if self.completions_ms:
            report["word_complete"] = {
                "p50": float(np.percentile(self.completions_ms, 50)),
                "p95": float(np.percentile(self.completions_ms, 95)),
                "n": len(self.completions_ms)}
            lines.append(
                f"  word complete (last chunk)      "
                f"{report['word_complete']['p50']:7.1f} / "
                f"{report['word_complete']['p95']:7.1f}   "
                f"(n={len(self.completions_ms)}; multi-chunk words only)")
        lines.append(f"  {len(stalls)} stall(s) > {stall_ms:.0f} ms")
        logger.info("\n".join(lines))
        self.budget = report
        if s.budget_path:
            with open(s.budget_path, "w") as fd:
                json.dump(report, fd, indent=1)
# endregion
